"""Conditional negatives (ops/conditional.py, ``.where()``) and the
categorical u2i slice against the JAX package.

Torch cannot reproduce JAX's random bits, so the sampler is held exactly
on JAX's own draws: JAX's ``conditional_negative_sample`` runs with its
base draws recorded, its run draws' uniform numbers are drawn again from
the same keys, and the port's ``conditional_negative_sample_draw`` must
answer the same ids.  The value index (``ConditionTable.build``) is held
bit for bit.  Then the whole slice: one batch of the categorical u2i
query (negatives by category) on JAX's ids and draws, both towers with
embedding encoders, the loss, every gradient and one Adam step against
flax + optax, f32, within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graph_learn_tpu_torch as glt
from graph_learn_tpu.config import conf as jconf
from graph_learn_tpu.errors import InvalidArgumentError as JaxError
from graph_learn_tpu.gsl import compile as jcompile
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.feature_column import FeatureEncoder as JaxEncoder
from graph_learn_tpu.nn.layers.ego import EgoLayer as JaxEgoLayer
from graph_learn_tpu.nn.layers.ego import EgoSAGEConv as JaxSAGEConv
from graph_learn_tpu.nn.loss import \
    unsupervised_softmax_cross_entropy_loss as jax_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGNN as JaxEgoGNN
from graph_learn_tpu.ops import conditional as jcond
from graph_learn_tpu.ops import negative as jneg
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples import bipartite_sage as bs
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.ops import conditional as tcond
from graph_learn_tpu_torch.ops import sampling
from torch_parity import (assert_trees_close, both_confs, cat_u2i_arrays,
                          grad_tree, jax_u2i_graph, torch_u2i_graph)

# f32, the same products in other orders: embeddings and losses within
# 1e-5 relative, gradients within 1e-5 relative plus 1e-6 absolute, one
# Adam step of 1e-3 within 1e-5
RTOL, GRAD_ATOL = 1e-5, 1e-6
# the item whose category no other item holds, and that category
LONE_ITEM, LONE_CAT = 0, 4


def _arrays(seed=3):
    """``cat_u2i_arrays`` with float columns that repeat values: item
    column 0 takes small integers (exact in bf16), item column 1 and user
    column 0 take tenths (not exact in bf16); item 0 alone holds category
    4."""
    a = cat_u2i_arrays(seed=seed)
    rng = np.random.default_rng(seed + 5)
    n_i, n_u = a["i_feat"].shape[0], a["u_feat"].shape[0]
    a["i_feat"][:, 0] = rng.integers(0, 3, n_i)
    a["i_feat"][:, 1] = rng.choice([0.1, 0.3, 0.7], n_i)
    a["u_feat"][:, 0] = rng.choice([0.1, 0.3], n_u)
    a["i_int"][LONE_ITEM, 0] = LONE_CAT
    return a


def _graphs(a):
    return jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("weights", [None, "in_degree", "node_weight"])
def test_condition_table_is_bit_equal(weights):
    a = _arrays()
    # a run whose weights are all 0 falls back to uniform inside it
    a["i_weights"][a["i_int"][:, 0] == 2] = 0.0
    jg, tg = _graphs(a)
    jnt, tnt = jg.store.node_table("i"), tg.store.node_table("i")
    w = {None: None,
         "in_degree": jg.store.edge_table("u-i").in_degrees.astype(
             np.float64),
         "node_weight": jnt.weights}[weights]
    want = jcond.ConditionTable.build(jnt, [0, 1], [0, 1], w)
    got = tcond.ConditionTable.build(tnt, [0, 1], [0, 1], w, "cpu")
    for kind in ("int_cols", "float_cols"):
        for c in (0, 1):
            j, t = getattr(want, kind)[c], getattr(got, kind)[c]
            for f in ("vals_sorted", "perm", "run_cdf"):
                x, y = np.asarray(getattr(j, f)), getattr(t, f).numpy()
                assert x.dtype == y.dtype, (kind, c, f, x.dtype, y.dtype)
                np.testing.assert_array_equal(y, x, err_msg=f)


def _base(kind, jet, jnt, reverse=False):
    """A JAX base draw and the port's, over the same pool."""
    pool = jet.unique_src if reverse else jet.unique_dst
    cdf = jet.unique_src_outdeg_cdf if reverse else jet.unique_dst_indeg_cdf
    if kind == "in_degree":
        return lambda k_, s: jneg._draw_cdf_ids(pool, cdf, k_, s)
    if kind == "node_weight":
        ids = jnp.arange(jnt.num_nodes, dtype=jnp.int32)
        return lambda k_, s: jneg._draw_cdf_ids(ids, jnt.cum_weights, k_, s)
    return lambda k_, s: jneg._draw_uniform_ids(pool, k_, s)


def run_on_jax_draws(jet, tet, jct, tct, seeds, pos_dst, pia, pfa, k,
                     cond, base, key=0, **opts):
    """(JAX's negatives, the port's on JAX's draws): JAX's base draws are
    recorded, its run draws' uniform numbers drawn again from the same
    keys (``fold_in(keys[i], 1)`` of ``split(key, parts + 1)``)."""
    ic, ip = cond.get("int_cols", []), cond.get("int_props", [])
    fc, fp = cond.get("float_cols", []), cond.get("float_props", [])
    recorded = []

    def jbase(kk, shape):
        out = base(kk, shape)
        recorded.append(np.array(out))
        return out

    jopt = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    want = np.asarray(jcond.conditional_negative_sample(
        jet, jct, jnp.asarray(seeds), jnp.asarray(pos_dst), jopt(pia),
        jopt(pfa), k, jax.random.key(key), ic, ip, fc, fp, jbase, **opts))
    parts, _ = tcond.quotas(k, ic, ip, fc, fp)
    keys = jax.random.split(jax.random.key(key), len(parts) + 1)
    R = jconf.sampling_retry_times + 1
    draws, it = [], iter(recorded)
    for (_, _, q), kk in zip(parts, keys[:-1]):
        if q <= 0:
            continue
        u = np.array(jax.random.uniform(jax.random.fold_in(kk, 1),
                                        (len(seeds), q * R)))
        draws.append((torch.from_numpy(next(it)), torch.from_numpy(u)))
    free = next(it, None)
    assert next(it, None) is None
    topt = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.asarray(x))
    got = tcond.conditional_negative_sample_draw(
        tet, tct, torch.from_numpy(seeds), torch.from_numpy(pos_dst),
        topt(pia), topt(pfa), k, ic, ip, fc, fp, draws,
        None if free is None else torch.from_numpy(free), **opts)
    return want, got.numpy()


# (condition, k, base strategy, options): int and float columns, the
# banker's rounding of the quotas (round(2.5) = 2, round(0.5) = 0, round
# (1.5) = 2), batch_share, unique
CASES = [
    ({"int_cols": [0], "int_props": [0.5]}, 4, "random", {}),
    ({"int_cols": [0, 1], "int_props": [0.5, 0.25]}, 4, "in_degree", {}),
    ({"float_cols": [0], "float_props": [0.5]}, 5, "node_weight", {}),
    ({"int_cols": [0], "int_props": [0.5],
      "float_cols": [1], "float_props": [0.5]}, 1, "random", {}),
    ({"int_cols": [0], "int_props": [0.5]}, 3, "in_degree",
     {"batch_share": True}),
    ({"int_cols": [0], "int_props": [0.5], "float_cols": [0],
      "float_props": [0.25]}, 4, "random", {"unique": True}),
    ({"int_cols": [0], "int_props": [1.0]}, 2, "random",
     {"unique": True, "batch_share": True}),
]


@pytest.mark.parametrize("retries", [0, 2])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_conditional_negatives_equal_jax_on_its_draws(case, retries):
    cond, k, base, opts = CASES[case]
    a = _arrays()
    jg, tg = _graphs(a)
    jet, tet = jg.store.edge_table("u-i").device(), \
        tg.store.edge_table("u-i").device("cpu")
    jnt = jg.store.node_table("i").device()
    w = {"random": None,
         "in_degree": jg.store.edge_table("u-i").in_degrees.astype(
             np.float64),
         "node_weight": jg.store.node_table("i").weights}[base]
    ic, fc = cond.get("int_cols", []), cond.get("float_cols", [])
    jct = jcond.ConditionTable.build(jg.store.node_table("i"), ic, fc, w)
    tct = tcond.ConditionTable.build(tg.store.node_table("i"), ic, fc, w,
                                     "cpu")
    rng = np.random.default_rng(case)
    b = 24
    e = rng.integers(0, a["ui_src"].size, b)
    seeds = a["ui_src"][e].astype(np.int32)
    pos_dst = a["ui_dst"][e].astype(np.int32)
    pos_dst[:3] = LONE_ITEM  # a run of one: these rows relax
    pia, pfa = a["i_int"][pos_dst], a["i_feat"][pos_dst]
    with both_confs(sampling_retry_times=retries):
        want, got = run_on_jax_draws(
            jet, tet, jct, tct, seeds, pos_dst, pia, pfa, k, cond,
            _base(base, jet, jnt), key=case, **opts)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (b, k) and got.dtype == np.int32
    parts, _ = tcond.quotas(k, ic, cond.get("int_props", []), fc,
                            cond.get("float_props", []))
    if ic and parts[0][2] > 0 and not opts:
        # the lone item's rows draw it, the positive, for its category
        # quota: every candidate rejected, the row relaxes
        assert (got[:3, 0] == LONE_ITEM).all()


def test_banker_rounding_of_quotas():
    assert tcond.quotas(5, [0], [0.5], [], [])[0] == [("int", 0, 2)]
    assert tcond.quotas(1, [0], [0.5], [1], [0.5]) == (
        [("int", 0, 0), ("float", 1, 0)], 1)
    assert tcond.quotas(3, [0], [0.5], [], []) == ([("int", 0, 2)], 1)


def test_inneg_draws_from_the_reverse_side():
    """``inNeg``: negatives are users, conditioned on a user float column,
    rejected against the reverse CSR."""
    a = _arrays(seed=4)
    jg, tg = _graphs(a)
    jet, tet = jg.store.edge_table("u-i").device(), \
        tg.store.edge_table("u-i").device("cpu")
    cond = {"float_cols": [0], "float_props": [0.5]}
    w = jg.store.edge_table("u-i").out_degrees.astype(np.float64)
    jct = jcond.ConditionTable.build(jg.store.node_table("u"), [], [0], w)
    tct = tcond.ConditionTable.build(tg.store.node_table("u"), [], [0], w,
                                     "cpu")
    rng = np.random.default_rng(9)
    e = rng.integers(0, a["ui_src"].size, 20)
    seeds = a["ui_dst"][e].astype(np.int32)  # items
    pos = a["ui_src"][e].astype(np.int32)  # their users
    with both_confs(sampling_retry_times=1):
        want, got = run_on_jax_draws(
            jet, tet, jct, tct, seeds, pos, None, a["u_feat"][pos], 4, cond,
            _base("in_degree", jet, None, reverse=True), reverse=True)
    np.testing.assert_array_equal(got, want)
    half = got[:, :2]
    assert (a["u_feat"][half, 0] == a["u_feat"][pos, 0][:, None]).mean() > 0.8


def test_a_bf16_table_hides_float_runs_as_in_jax():
    """Under bf16 features the positive's value is read from the bf16
    table and the index holds the f32 values: tenths find no run and fall
    back, as in the JAX package; small integers still match."""
    a = _arrays(seed=5)
    with both_confs(feature_dtype="bfloat16"):
        jg, tg = _graphs(a)
        jet, tet = jg.store.edge_table("u-i").device(), \
            tg.store.edge_table("u-i").device("cpu")
        jnt = jg.store.node_table("i").device()
        tnt = tg.store.node_table("i").device("cpu")
        assert tnt.float_attrs.dtype == torch.bfloat16
        jct = jcond.ConditionTable.build(jg.store.node_table("i"), [],
                                         [0, 1], None)
        tct = tcond.ConditionTable.build(tg.store.node_table("i"), [],
                                         [0, 1], None, "cpu")
        rng = np.random.default_rng(1)
        e = rng.integers(0, a["ui_src"].size, 32)
        seeds, pos = (a["ui_src"][e].astype(np.int32),
                      a["ui_dst"][e].astype(np.int32))
        pfa_j = jnt.float_attrs[jnp.asarray(pos)]
        pfa_t = tnt.float_attrs[torch.from_numpy(pos).long()]
        np.testing.assert_array_equal(pfa_t.float().numpy(),
                                      np.asarray(pfa_j, np.float32))
        cond = {"float_cols": [0], "float_props": [1.0]}
        for col in (0, 1):
            # column ``col`` alone, as column 0 of its own table
            ji = jcond.ConditionTable(int_cols={},
                                      float_cols={0: jct.float_cols[col]})
            ti = tcond.ConditionTable(int_cols={},
                                      float_cols={0: tct.float_cols[col]})
            want, got = run_on_jax_draws(
                jet, tet, ji, ti, seeds, pos, None,
                np.asarray(pfa_j[:, col:col + 1], np.float32), 2, cond,
                _base("random", jet, jnt), key=col)
            np.testing.assert_array_equal(got, want)
            # the same draws on the port's bf16 rows
            tpv = pfa_t[:, col:col + 1]
            lo = torch.searchsorted(ti.float_cols[0].vals_sorted,
                                    tpv[:, 0].float().contiguous())
            hi = torch.searchsorted(ti.float_cols[0].vals_sorted,
                                    tpv[:, 0].float().contiguous(),
                                    side="right")
            found = (hi > lo).float().mean().item()
            if col == 0:
                assert found == 1.0
                assert (a["i_feat"][got, 0]
                        == a["i_feat"][pos, 0][:, None]).mean() > 0.8
            else:
                assert found == 0.0


def test_where_validates_keys_and_minimal_refuses_with_jax_messages():
    a = _arrays()
    jg, tg = _graphs(a)
    msgs = []
    for g, err in ((jg, JaxError), (tg, InvalidArgumentError)):
        seed = g.E("u-i").batch(4).alias("seed")
        src = seed.outV().alias("src")
        seed.inV().alias("dst")
        with pytest.raises(err) as e:
            src.outNeg("u-i").sample(2).by("random").where(
                "dst", {"int_colz": [0]})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "condition 'int_colz' is not supported."
    msgs = []
    with both_confs(storage_profile="minimal"):
        jg, tg = _graphs(a)
        for g in (jg, tg):
            seed = g.E("u-i").batch(4).alias("seed")
            src = seed.outV().alias("src")
            seed.inV().alias("dst")
            src.outNeg("u-i").sample(2).by("random").where(
                "dst", {"int_cols": [0], "int_props": [0.5]}).alias("neg")
            q = seed.values()
            seeds = np.arange(4, dtype=np.int32)
            if g is jg:
                with pytest.raises(JaxError) as e:
                    jcompile._execute(q, q.device_tables(),
                                      jnp.asarray(seeds),
                                      jax.random.key(0))
            else:
                with pytest.raises(InvalidArgumentError) as e:
                    q.run(torch.from_numpy(seeds), torch.Generator())
            msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "minimal" in msgs[1]


# --- the slice as a whole ----------------------------------------------

NBRS, N_NEG, OUT = 4, 3, 12
COND = {"int_cols": [0], "int_props": [0.5], "str_cols": [1],
        "str_props": [0.25]}


def _query(g, b=16):
    """The categorical u2i query: edge seeds, the two towers' hops and
    negatives by category (half) and brand (a quarter), base in_degree."""
    seed = g.E("u-i").batch(b).alias("seed")
    src = seed.outV().alias("src")
    dst = seed.inV().alias("dst")
    neg = src.outNeg("u-i").sample(N_NEG).by("in_degree").where(
        "dst", COND).alias("neg")
    src.outV("u-i").sample(NBRS).by("random").alias("src_h1")
    dst.outV("i-i").sample(NBRS).by("random").alias("dst_h1")
    neg.outV("i-i").sample(NBRS).by("random").alias("neg_h1")
    return seed.values()


def _jax_towers(udec, idec):
    wu, wi = (JaxEncoder.out_dim(udec), JaxEncoder.out_dim(idec))

    def tower(decs, in_dim):
        return JaxEgoGNN(
            layers=[JaxEgoLayer(convs=[JaxSAGEConv(
                in_dim=in_dim, out_dim=OUT, agg_type="mean")])],
            hop_encoders=[JaxEncoder(d) for d in decs])
    return tower([udec, idec], (wu, wi)), tower([idec, idec], (wi, wi))


def _jax_egos(batch):
    src = jdata.EgoGraph.from_query_result(batch, "src", ["src_h1"])
    dst = jdata.EgoGraph.from_query_result(batch, "dst", ["dst_h1"])
    neg = batch["neg"].flat()
    neg_h1 = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                          batch["neg_h1"])
    return src, dst, jdata.EgoGraph(src=neg, hops=[neg_h1],
                                    nbr_nums=(NBRS,))


def test_the_categorical_slice_matches_jax_ids_loss_and_one_step(
        monkeypatch):
    a = cat_u2i_arrays(seed=6, n_i=60, e_ui=500)
    jg, judec, jidec = jax_u2i_graph(a)
    tg, tudec, tidec = torch_u2i_graph(a)
    jq, tq = _query(jg), _query(tg)
    # JAX's plan, unjitted, with its conditional draws recorded
    rec = {}
    jfn = jcond.conditional_negative_sample

    def jrecord(et, ct, seeds, pos_dst, pia, pfa, k, key, *args, **kw):
        draws = []
        base = args[4]

        def jbase(kk, shape):
            out = base(kk, shape)
            draws.append(np.array(out))
            return out
        args = args[:4] + (jbase,) + args[5:]
        out = jfn(et, ct, seeds, pos_dst, pia, pfa, k, key, *args, **kw)
        rec.update(key=key, draws=draws, pia=np.asarray(pia))
        return out

    monkeypatch.setattr(jcond, "conditional_negative_sample", jrecord)
    seeds = np.random.default_rng(0).integers(
        0, a["ui_src"].size, 16).astype(np.int32)
    jb = jcompile._execute(jq, jq.device_tables(), jnp.asarray(seeds),
                           jax.random.key(2))
    # the port's plan on the same seeds: its hops answer JAX's ids, its
    # conditional sampler JAX's draws
    hops = iter([np.asarray(jb[x].ids).reshape(-1, NBRS)
                 for x in ("src_h1", "dst_h1", "neg_h1")])

    def sampler(csr, s, k, generator, flt=None):
        ids = torch.from_numpy(next(hops))
        assert ids.shape == (s.shape[0], k)
        return ids, torch.zeros_like(ids)

    def tdraw(et, ct, s, pos_dst, pia, pfa, k, generator, ic, ip, fc, fp,
              base_draw, **kw):
        np.testing.assert_array_equal(pia.numpy(), rec["pia"])
        parts, _ = tcond.quotas(k, ic, ip, fc, fp)
        keys = jax.random.split(rec["key"], len(parts) + 1)
        R = jconf.sampling_retry_times + 1
        draws, it = [], iter(rec["draws"])
        for (_, _, q), kk in zip(parts, keys[:-1]):
            if q > 0:
                u = np.array(jax.random.uniform(
                    jax.random.fold_in(kk, 1), (s.shape[0], q * R)))
                draws.append((torch.from_numpy(next(it)),
                               torch.from_numpy(u)))
        free = next(it, None)
        return tcond.conditional_negative_sample_draw(
            et, ct, s, pos_dst, pia, pfa, k, ic, ip, fc, fp, draws,
            None if free is None else torch.from_numpy(free), **kw)

    monkeypatch.setitem(sampling.STRATEGY_FNS, "random", sampler)
    monkeypatch.setattr(tcond, "conditional_negative_sample", tdraw)
    tb = tcompile._execute(tq, tq.device_tables("cpu"),
                           torch.from_numpy(seeds), torch.Generator())
    for x in ("src", "dst", "neg", "src_h1", "dst_h1", "neg_h1"):
        np.testing.assert_array_equal(tb[x].ids.numpy(),
                                      np.asarray(jb[x].ids), x)
        for f in ("int_attrs", "multival_attrs", "multival_lens"):
            if getattr(jb[x], f) is not None:
                np.testing.assert_array_equal(
                    getattr(tb[x], f).numpy(), np.asarray(getattr(jb[x], f)),
                    x + "." + f)
    # the category quota shares the positive's category
    neg_cat = a["i_int"][tb["neg"].ids.numpy()][..., 0]
    pos_cat = a["i_int"][tb["dst"].ids.numpy()][:, 0]
    assert (neg_cat[:, 0] == pos_cat).mean() > 0.9

    u_tower, i_tower = _jax_towers(judec, jidec)
    s0, d0, n0 = _jax_egos(jb)
    params = {"u": u_tower.init(jax.random.key(0), s0),
              "i": i_tower.init(jax.random.key(1), d0)}
    assert "embedding_mv_%d" % (8 + 2) in params["i"]["params"][
        "hop_encoders_1"]
    model = bs.towers(tudec, tidec, OUT, "cpu")
    load_flax_params(model, _np(params))
    assert_trees_close(to_flax_params(model), _np(params), rtol=0, atol=0)

    def jax_lf(p):
        return jax_loss(u_tower.apply(p["u"], s0), i_tower.apply(p["i"], d0),
                        i_tower.apply(p["i"], n0))

    loss = bs.loss_fn(model, tb, None, True)
    jloss, jgrads = jax.value_and_grad(jax_lf)(params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    # the K-step form's deferred hops: the encoders do not commute, so the
    # hops are gathered, and the loss is the same
    np.testing.assert_allclose(
        bs.tower_loss(model, tb, tg.store.node_table("i").device("cpu")
                      .float_attrs).item(), float(jloss), rtol=RTOL)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    opt.zero_grad()
    loss.backward()
    assert_trees_close(grad_tree(model), _np(jgrads), rtol=RTOL,
                       atol=GRAD_ATOL)
    opt.step()
    tx = optax.adam(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    assert_trees_close(to_flax_params(model), _np(new), rtol=1e-5,
                       atol=1e-5)


def test_the_where_query_runs_through_dataset_and_trainer():
    """On the port's own draws: the category quota shares the positive's
    category, the plan holds no host read, and LocalTrainer trains the
    categorical towers (the embedding tables move)."""
    a = cat_u2i_arrays(seed=7)
    tg, udec, idec = torch_u2i_graph(a)
    q = _query(tg)
    batch = glt.Dataset(q, window=1, device="cpu").next()
    neg_cat = batch["neg"].int_attrs[..., 0]
    assert bool((neg_cat[:, 0] == batch["dst"].int_attrs[:, 0]).all())
    model = bs.towers(udec, idec, OUT, "cpu")
    enc = model["i"].hop_encoders[1]
    assert isinstance(enc, FeatureEncoder)
    before = {n: t.detach().clone() for n, t in enc.embedding_tables()}
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    _, hist = bs.LocalTrainer(device="cpu").train(
        q, model, bs.loss_fn, opt, epochs=1, steps_per_epoch=3,
        verbose=False)
    assert np.isfinite(hist).all()
    moved = [n for n, t in enc.embedding_tables()
             if not torch.equal(t.detach(), before[n])]
    assert sorted(moved) == sorted(before)


def test_a_replaced_item_table_brings_its_own_condition_index():
    """The condition tables are kept per device across batches, and
    rebuilt when ``add_node_table`` replaces the negatives' node type: with
    the categories reversed, the category quota still matches the
    positive's new category."""
    a = cat_u2i_arrays(seed=7)
    tg, _, idec = torch_u2i_graph(a)
    q = _query(tg)
    seeds = torch.arange(16, dtype=torch.int32)
    first = q.run(seeds, torch.Generator().manual_seed(0))
    kept = q.device_tables()["cond"]
    assert q.device_tables()["cond"] is kept
    old = tg.store.node_table("i")
    flipped = a["i_int"].copy()
    flipped[:, 0] = flipped[:, 0].max() - flipped[:, 0]
    tg.add_node_table(glt.NodeTable(
        "i", idec, old.raw_ids, float_attrs=old.float_attrs,
        weights=old.weights, int_attrs=flipped,
        multival_attrs=old.multival_attrs, multival_lens=old.multival_lens))
    assert q.device_tables()["cond"] is not kept
    for batch, cat in ((first, a["i_int"][:, 0]), (
            q.run(seeds, torch.Generator().manual_seed(0)), flipped[:, 0])):
        dst = batch["dst"].ids.numpy()
        neg = batch["neg"].ids.numpy()
        np.testing.assert_array_equal(cat[neg[:, 0]], cat[dst])
        np.testing.assert_array_equal(batch["neg"].int_attrs[:, 0, 0].numpy(),
                                      cat[dst])


def test_by_conditional_without_where_fails_on_the_missing_alias():
    """``.by("conditional")`` alone names no positive: both plans fail on
    the missing alias, with the same message."""
    a = _arrays()
    jg, tg = _graphs(a)
    msgs = []
    for g in (jg, tg):
        seed = g.E("u-i").batch(4).alias("seed")
        seed.outV().alias("src").outNeg("u-i").sample(2).by(
            "conditional").alias("neg")
        q = seed.values()
        seeds = np.arange(4, dtype=np.int32)
        if g is jg:
            with pytest.raises(JaxError) as e:
                jcompile._execute(q, q.device_tables(), jnp.asarray(seeds),
                                  jax.random.key(0))
        else:
            with pytest.raises(InvalidArgumentError) as e:
                q.run(torch.from_numpy(seeds), torch.Generator())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "unknown alias None"
