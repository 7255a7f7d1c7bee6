"""EgoGIN and EgoRGCN of the port against the JAX package's, with the flax
weights carried over by ``nn/convert.py``: the convs (GIN with equal and
unequal dims, RGCN plain / bases / blocks for every reduction), the models
on materialised, ``DeferredRows`` and ``PreAggregatedRows`` hops in both
``conf.sorted_gather`` settings, the op-mismatch error, the weight tree;
then the rgcn family of ``examples/family_scale.py`` as a whole on one
small two-relation store and one batch of ids taken from the JAX plan (so
the sampling streams do not matter): the loss and one Adam step on both
routes; its store's draws, its K-step function, its command line and the
``LocalTrainer`` example on the CPU."""

import ast
import contextlib
import copy
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graph_learn_tpu as gl
from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.core.store import EdgeTable as JaxEdgeTable
from graph_learn_tpu.core.store import NodeTable as JaxNodeTable
from graph_learn_tpu.core.values import Nodes as JaxNodes
from graph_learn_tpu.graph import Graph as JaxGraph
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.layers.ego import EgoGINConv as JaxGINConv
from graph_learn_tpu.nn.layers.ego import EgoRGCNConv as JaxRGCNConv
from graph_learn_tpu.nn.loss import supervised_softmax_loss as jax_sup_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGIN as JaxEgoGIN
from graph_learn_tpu.nn.models.ego_gnn import EgoRGCN as JaxEgoRGCN
from graph_learn_tpu.ops.aggregate import gather_group_agg as jax_group_agg
from graph_learn_tpu_torch import bench as tbench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples import ego_rgcn as er
from graph_learn_tpu_torch.examples import family_scale as fs
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.layers.ego import EgoGINConv, EgoRGCNConv
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGIN, EgoRGCN
from graph_learn_tpu_torch.ops import sampling
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
from graph_learn_tpu_torch.ops.kernels import gather, spmm
from torch_parity import assert_trees_close, both_confs, ego_pair

REPO = Path(__file__).resolve().parents[1]
# the JAX package's own limits for these models
# (tests/test_deferred_agg.py): outputs 2e-5, gradients 2e-4
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
RGCN_MODES = {"plain": {}, "bases": {"num_bases": 2},
              "blocks": {"num_blocks": 2}}
ALIASES = ["r0_h1", "r1_h1", "r0_r0_h2", "r0_r1_h2", "r1_r0_h2",
           "r1_r1_h2"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_tree(params, seed=0):
    """``params`` with every leaf redrawn (biases too, which flax zeroes)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def _load_conv(conv, tree):
    """A conv's flax params into the port's conv: each Dense into the
    Linear child of its name (kernel transposed), raw arrays as they are."""
    with torch.no_grad():
        for name, child in conv.named_children():
            child.weight.copy_(torch.from_numpy(tree[name]["kernel"].T.copy()))
            if child.bias is not None:
                child.bias.copy_(torch.from_numpy(tree[name]["bias"]))
        for name, p in conv.named_parameters(recurse=False):
            p.copy_(torch.from_numpy(tree[name]))
    assert sum(p.numel() for p in conv.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))


def _conv_grads(conv):
    """The port conv's gradients as its flax tree."""
    tree = {}
    for name, child in conv.named_children():
        tree[name] = {"kernel": child.weight.grad.numpy().T}
        if child.bias is not None:
            tree[name]["bias"] = child.bias.grad.numpy()
    for name, p in conv.named_parameters(recurse=False):
        tree[name] = p.grad.numpy()
    return tree


def _grad_tree(model):
    """The port model's gradients as its flax tree (``to_flax_params`` of
    a copy whose parameters are the gradients)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return to_flax_params(g)


def _reduce(a, agg, axis):
    return {"mean": a.mean(axis), "sum": a.sum(axis),
            "max": a.max(axis)}[agg]


# --- the convs ---------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("dims", ["equal", "unequal"])
def test_gin_conv_matches_jax(dims, eps):
    """Output and every gradient (parameters, x, neighbours), from the
    neighbour rows and from their pre-reduced sum."""
    din = (8, 8) if dims == "equal" else (10, 8)
    b, e, out_dim = 5, 3, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, din[0])).astype(np.float32)
    nbr = rng.standard_normal((b * e, din[1])).astype(np.float32)
    cot = rng.standard_normal((b, out_dim)).astype(np.float32)
    jconv = JaxGINConv(in_dim=din, out_dim=out_dim, eps=eps, use_bias=True)
    params = _random_tree(_np(jconv.init(jax.random.key(0), x, nbr, e)))
    names = sorted(params["params"])
    assert names == (["output"] if dims == "equal"
                     else ["output", "trans_nbrs", "trans_x"])
    conv = EgoGINConv(din, out_dim, eps=eps, use_bias=True)
    _load_conv(conv, params["params"])
    agg = nbr.reshape(b, e, din[1]).sum(1)
    for form in ("rows", "agg"):
        def jf(p, x_, n_):
            out = (jconv.apply(p, x_, n_, e) if form == "rows" else
                   jconv.apply(p, x_, None, e, neighbor_agg=n_))
            return jnp.sum(out * cot), out
        n_in = nbr if form == "rows" else agg
        (_, jout), (jg, jgx, jgn) = jax.value_and_grad(
            jf, argnums=(0, 1, 2), has_aux=True)(params, x, n_in)
        conv.zero_grad()
        tx = torch.from_numpy(x).requires_grad_()
        tn = torch.from_numpy(n_in).requires_grad_()
        out = (conv(tx, tn, e) if form == "rows"
               else conv(tx, None, e, neighbor_agg=tn))
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   err_msg=form, **OUT_TOL)
        assert_trees_close(_conv_grads(conv), _np(jg["params"]), **GRAD_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                                   **GRAD_TOL)
        np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jgn),
                                   **GRAD_TOL)
    assert conv.deferred_op == "sum"


@pytest.mark.parametrize("agg", ["mean", "sum", "max"])
@pytest.mark.parametrize("mode", sorted(RGCN_MODES))
def test_rgcn_conv_matches_jax(mode, agg):
    """Output and every gradient, from the per-relation neighbour rows and
    from their pre-reduced ``neighbors_agg``; the weights of the JAX
    layer's shapes, a bias and a root weight from a wider x."""
    R, b, e, din, out_dim = 2, 5, 3, (10, 8), 6
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, din[0])).astype(np.float32)
    nbrs = [rng.standard_normal((b * e, din[1])).astype(np.float32)
            for _ in range(R)]
    aggs = [_reduce(n.reshape(b, e, din[1]), agg, 1) for n in nbrs]
    cot = rng.standard_normal((b, out_dim)).astype(np.float32)
    kw = RGCN_MODES[mode]
    jconv = JaxRGCNConv(in_dim=din, out_dim=out_dim, num_relations=R,
                        agg_type=agg, use_bias=True, **kw)
    params = _random_tree(_np(jconv.init(jax.random.key(0), x, nbrs, e)))
    conv = EgoRGCNConv(din, out_dim, R, agg_type=agg, use_bias=True, **kw)
    for name, p in conv.named_parameters(recurse=False):
        assert tuple(p.shape) == params["params"][name].shape, name
    _load_conv(conv, params["params"])
    for form in ("rows", "agg"):
        def jf(p, x_, ns):
            out = (jconv.apply(p, x_, ns, e) if form == "rows" else
                   jconv.apply(p, x_, None, e, neighbors_agg=ns))
            return jnp.sum(out * cot), out
        n_in = nbrs if form == "rows" else aggs
        (_, jout), (jg, jgx, jgn) = jax.value_and_grad(
            jf, argnums=(0, 1, 2), has_aux=True)(params, x, n_in)
        conv.zero_grad()
        tx = torch.from_numpy(x).requires_grad_()
        tn = [torch.from_numpy(n).requires_grad_() for n in n_in]
        out = (conv(tx, tn, e) if form == "rows"
               else conv(tx, None, e, neighbors_agg=tn))
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   err_msg=form, **OUT_TOL)
        assert_trees_close(_conv_grads(conv), _np(jg["params"]), **GRAD_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                                   **GRAD_TOL)
        for got, want in zip(tn, jgn):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                       **GRAD_TOL)
    assert conv.deferred_op == agg


def test_rgcn_init_draws_lecun_normal_with_flax_fan_in():
    """Each raw array's spread is fan_in^-1/2 with flax's fan-in
    (``shape[-2]`` times the leading axes)."""
    gen = torch.Generator().manual_seed(0)
    conv = EgoRGCNConv(64, 48, 8, num_bases=16)
    conv.reset_parameters(gen)
    for p, fan_in in ((conv.weight, 64 * 16), (conv.coefficient, 8),
                      (conv.root_weight.weight, 64)):
        std = float(p.detach().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.1, (p.shape, std)
    blocks = EgoRGCNConv(64, 48, 4, num_blocks=4)
    blocks.reset_parameters(gen)
    std = float(blocks.weight.detach().std())
    assert abs(std * (16 * 4 * 4) ** 0.5 - 1.0) < 0.1
    with pytest.raises(ValueError):
        EgoRGCNConv(64, 48, 4, num_blocks=5)


# --- the models ----------------------------------------------------------

def rgcn_pair(mode, op="mean", d=8, b=6, k1=3, k2=4, R=2, seed=5):
    """The same 2-relation 2-level batch as a JAX EgoGraph and a port
    EgoGraph, plus its labels; hops [r0_h1, r1_h1, r0_r0_h2, r0_r1_h2,
    r1_r0_h2, r1_r1_h2], the deepest R^2 ``materialised``, ``deferred``
    (DeferredRows) or ``preagg`` (PreAggregatedRows reduced with ``op``)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((200, d)).astype(np.float32)
    shapes = [(b,)] + [(b, k1)] * R + [(b, k1, k2)] * (R * R)
    ids = [rng.integers(0, 200, s).astype(np.int32) for s in shapes]
    labels = rng.integers(0, 4, b).astype(np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jn = [JaxNodes(ids=jnp.asarray(i), float_attrs=jt[i], type_name="item")
          for i in ids]
    tn = [Nodes(ids=torch.from_numpy(i),
                float_attrs=tt[torch.from_numpy(i).long()],
                type_name="item") for i in ids]
    for j in range(1 + R, len(ids)):
        if mode == "deferred":
            jn[j] = jn[j].replace(float_attrs=jdata.DeferredRows(
                jt, jn[j].ids))
            tn[j] = tn[j].replace(float_attrs=tdata.DeferredRows(
                tt, tn[j].ids))
        elif mode == "preagg":
            jn[j] = jn[j].replace(float_attrs=jdata.PreAggregatedRows(
                jax_group_agg(jt, jn[j].ids, op=op), op))
            tn[j] = tn[j].replace(float_attrs=tdata.PreAggregatedRows(
                gather_group_agg(tt, tn[j].ids, op=op), op))
        else:
            assert mode == "materialised", mode
    return (jdata.EgoGraph(src=jn[0], hops=jn[1:], nbr_nums=(k1, k2)),
            tdata.EgoGraph(src=tn[0], hops=tn[1:], nbr_nums=(k1, k2)),
            labels)


def _models(which, d=8, dims_tail=(16, 4), agg="mean"):
    """(flax model, port model, the function making its batches) for ``which``:
    ``gin`` or ``rgcn-<mode>``."""
    jdec = JaxDecoder(attr_types=["float"] * d)
    tdec = Decoder(attr_types=["float"] * d)
    dims = [d, *dims_tail]
    if which == "gin":
        return (JaxEgoGIN(dims, jdec, eps=0.1),
                EgoGIN(dims, tdec, eps=0.1, device="cpu"),
                lambda mode, op="sum": ego_pair(d, mode, op))
    kw = RGCN_MODES[which.split("-")[1]]
    return (JaxEgoRGCN(dims=dims, decoder=jdec, num_relations=2,
                       agg_type=agg, **kw),
            EgoRGCN(dims, tdec, num_relations=2, agg_type=agg,
                    device="cpu", **kw),
            lambda mode, op=agg: rgcn_pair(mode, op, d=d))


MODELS = ["gin", "rgcn-plain", "rgcn-bases", "rgcn-blocks"]


@pytest.mark.parametrize("sorted_gather", [False, True])
@pytest.mark.parametrize("mode", ["materialised", "deferred", "preagg"])
@pytest.mark.parametrize("which", MODELS)
def test_models_match_jax(which, mode, sorted_gather):
    """Logits and every gradient of the softmax cross-entropy, the deepest
    hops materialised, deferred or pre-aggregated."""
    jmodel, tmodel, pair = _models(which)
    plain, _, labels = pair("materialised")
    jego, tego, _ = pair(mode)
    params = jmodel.init(jax.random.key(0), plain, training=False)
    load_flax_params(tmodel, _np(params))
    with both_confs(sorted_gather=sorted_gather, sorted_gather_min_bytes=0):
        def jf(p):
            logits = jmodel.apply(p, jego, training=False)
            return jax_sup_loss(logits, jnp.asarray(labels)), logits
        (jloss, jlogits), jgrads = jax.value_and_grad(jf, has_aux=True)(
            params)
        logits = tmodel(tego)
        loss = supervised_softmax_loss(logits, torch.from_numpy(labels))
        loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **OUT_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **OUT_TOL)
    assert_trees_close(_grad_tree(tmodel), _np(jgrads), **GRAD_TOL)


@pytest.mark.parametrize("which", MODELS)
def test_deferred_deepest_hops_run_through_the_segment_spmm_wrapper(
        which, monkeypatch):
    """On hops as a port lookup leaves them (every row deferred): deferred,
    each deepest hop is one group reduction with the conv's op (GIN: a sum
    over [b * k1, k2] ids; RGCN: R^2 means) and every other hop one gather;
    materialised, every hop is one gather."""
    _, tmodel, pair = _models(which)
    _, tego, _ = pair("materialised")
    table = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (200, 8)).astype(np.float32))
    values = [tego.src] + list(tego.hops)
    names = (["src", "hop1", "hop2"] if which == "gin"
             else ["src"] + ALIASES)
    raw = {a: v.replace(float_attrs=tdata.DeferredRows(table, v.ids))
           for a, v in zip(names, values)}
    calls = []
    plain_spmm = spmm.segment_spmm_plain
    plain_gather = gather.gather_rows_plain

    def spy_spmm(feats, ids, degrees, agg, *args, **kw):
        calls.append(("spmm", tuple(ids.shape), agg))
        return plain_spmm(feats, ids, degrees, agg, *args, **kw)

    def spy_gather(table_, idx):
        calls.append(("gather", tuple(idx.shape)))
        return plain_gather(table_, idx)

    monkeypatch.setattr(spmm, "segment_spmm_plain", spy_spmm)
    monkeypatch.setattr(gather, "gather_rows_plain", spy_gather)
    for mode in ("deferred", "materialised"):
        del calls[:]
        if which == "gin":
            ego = tdata.EgoGraph.from_query_result(
                raw, "src", names[1:],
                defer_last_table=table if mode == "deferred" else None)
        elif mode == "deferred":
            ego = tdata.EgoGraph(src=raw["src"],
                                 hops=[raw[a] for a in names[1:]],
                                 nbr_nums=tego.nbr_nums)
        else:
            ego = er.make_ego(raw, names[1:], tego.nbr_nums)
        with torch.no_grad():
            tmodel(ego)
        spmms = [c for c in calls if c[0] == "spmm"]
        gathers = [c for c in calls if c[0] == "gather"]
        n_deep, op = (1, "sum") if which == "gin" else (4, "mean")
        if mode == "deferred":
            assert spmms == [("spmm", (18, 4), op)] * n_deep, calls
            assert len(gathers) == len(names) - n_deep, calls
        else:
            assert spmms == [] and len(gathers) == len(names), calls


@pytest.mark.parametrize("which", ["gin", "rgcn-plain"])
def test_preaggregated_hops_of_another_op_raise(which):
    """A mean-reduced deepest level cannot feed a sum (GIN's, or an RGCN
    of agg_type "sum"): InvalidArgumentError in both packages."""
    jmodel, tmodel, pair = _models(which, agg="sum")
    plain, _, _ = pair("materialised")
    jego, tego, _ = pair("preagg", "mean")
    params = jmodel.init(jax.random.key(0), plain, training=False)
    with pytest.raises(gl.InvalidArgumentError):
        jmodel.apply(params, jego, training=False)
    with pytest.raises(InvalidArgumentError, match="PreAggregatedRows"):
        tmodel(tego)


@pytest.mark.parametrize("which", MODELS)
def test_the_flax_tree_round_trips_every_leaf(which):
    """The names and shapes of the JAX ``model.init`` tree are the port's:
    ``to_flax_params(load_flax_params(...))`` gives every leaf back as it
    was; a leftover or a missing leaf raises."""
    jmodel, tmodel, pair = _models(which)
    plain, _, _ = pair("materialised")
    params = _random_tree(_np(jmodel.init(jax.random.key(0), plain,
                                          training=False)), seed=4)
    back = to_flax_params(load_flax_params(tmodel, params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    first = "layers_0" if which == "gin" else "rgcn_0"
    extra = copy.deepcopy(params)
    extra["params"][first]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(InvalidArgumentError, match="not carried over"):
        load_flax_params(tmodel, extra)
    short = copy.deepcopy(params)
    del short["params"][first]
    with pytest.raises(InvalidArgumentError, match="lack"):
        load_flax_params(tmodel, short)


# --- the rgcn family as a whole ------------------------------------------

SMALL = dict(tbench.CFG_SMALL, n_nodes=600, avg_degree=6, feat_dim=8,
             hidden=16, classes=5, batch=16, steps=2, scan_steps=1)
NBRS = (4, 2)


def _jax_example():
    """``rgcn_query`` and ``make_ego`` of examples/ego_rgcn_supervised.py,
    run as written, with the family's relation names (the module itself
    loads files and sets the platform when it is imported, so only these
    two functions are taken from it)."""
    path = REPO / "examples" / "ego_rgcn_supervised.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("rgcn_query", "make_ego")]
    ns = {"EgoGraph": jdata.EgoGraph, "RELS": list(er.RELS)}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _jax_store(g):
    """The JAX package's Graph over the port store's arrays."""
    nt = g.store.node_table("item")
    n, d = nt.float_attrs.shape
    dec = JaxDecoder(labeled=True, attr_types=["float"] * d)
    jg = JaxGraph()
    jg.store.add_node_table(JaxNodeTable(
        "item", dec, np.arange(n, dtype=np.int64),
        float_attrs=nt.float_attrs, labels=nt.labels))
    for rel in er.RELS:
        et = g.store.edge_table(rel)
        jg.store.add_edge_table(JaxEdgeTable(
            rel, "item", "item", JaxDecoder(weighted=True), src=et.src,
            dst=et.dst, num_src_nodes=n, num_dst_nodes=n,
            weights=et.weights))
    jg._node_decoders["item"] = dec
    jg._initialized = True
    return jg, dec


def _port_batch_from_jax(tq, aliases, jb, monkeypatch):
    """The port's plan on JAX's seeds, its sampler answering JAX's ids in
    alias order (each call's seeds are checked to be its parent's ids)."""
    hops = iter(aliases)

    def sampler(csr, seeds, k, generator, flt=None):
        a = next(hops)
        level = int(a[-1])
        parent = "src" if level == 1 else a[:-5] + "h%d" % (level - 1)
        np.testing.assert_array_equal(seeds.numpy(),
                                      np.asarray(jb[parent].ids).reshape(-1))
        ids = torch.from_numpy(np.array(jb[a].ids).reshape(-1, k))
        return ids, torch.zeros_like(ids)

    monkeypatch.setitem(sampling.STRATEGY_FNS, "random", sampler)
    seeds = torch.from_numpy(np.array(jb["src"].ids))
    return seeds, tcompile._execute(tq, tq.device_tables("cpu"), seeds,
                                    torch.Generator())


@pytest.fixture
def rgcn_store():
    with both_confs(storage_profile="minimal"):
        yield er.build_rgcn_graph(SMALL, "cpu")


@pytest.mark.parametrize("defer", [False, True])
def test_the_slice_matches_jax_loss_and_one_adam_step(defer, rgcn_store,
                                                       monkeypatch):
    """One ``RGCNSteps`` step on the JAX plan's sampled ids: the loss and
    the parameters after one Adam step of 1e-3 equal the JAX family's
    step (``run_rgcn:120-140``) on the same batch, without and with the
    deepest level pre-reduced."""
    ex = _jax_example()
    g, dec = rgcn_store
    jg, jdec = _jax_store(g)
    jq, jaliases = ex["rgcn_query"](jg, gl.Mask.NONE, SMALL["batch"], NBRS)
    jb = gl.Dataset(jq, window=1).next()
    tq, aliases = er.rgcn_query(g, er.Mask.NONE, SMALL["batch"], NBRS)
    assert aliases == jaliases == ALIASES
    seeds, tb = _port_batch_from_jax(tq, aliases, jb, monkeypatch)
    for a in ["src"] + aliases:
        np.testing.assert_array_equal(tb[a].ids.numpy(), np.asarray(jb[a].ids))

    dims = [SMALL["feat_dim"], SMALL["hidden"], SMALL["classes"]]
    jmodel = JaxEgoRGCN(dims=dims, decoder=jdec, num_relations=2,
                        num_bases=1)
    params = jmodel.init(jax.random.key(0), ex["make_ego"](jb, jaliases,
                                                           NBRS))
    jbatch = jb
    if defer:
        ft = jq.device_tables()["nodes"]["item"].float_attrs
        for a in jaliases[-4:]:
            jbatch = jdata.pre_aggregate_hop(jbatch, a, ft, op="mean")

    def lf(p):
        logits = jmodel.apply(p, ex["make_ego"](jbatch, jaliases, NBRS),
                              training=True)
        return jax_sup_loss(logits, jbatch["src"].labels)

    jloss, jgrads = jax.value_and_grad(lf)(params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    new = optax.apply_updates(params, upd)

    model = EgoRGCN(dims, dec, num_relations=2, num_bases=1, device="cpu")
    load_flax_params(model, _np(params))
    tables = tq.device_tables("cpu")
    monkeypatch.setattr(tbench, "sample_one",
                        lambda q_, t_, n, gen: (seeds, tb))
    step = fs.RGCNSteps(tq, tables, model,
                        tbench.make_optimizer(model, torch.device("cpu")),
                        SMALL, aliases, NBRS, defer,
                        torch.Generator().manual_seed(0), False)
    loss = step()
    # the step's own tolerances (tests/test_torch_bench.py): 1e-5 on the
    # loss, one Adam step of 1e-3 within 2e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-6)
    assert_trees_close(to_flax_params(model), _np(new), rtol=1e-4,
                       atol=2e-5)


def test_the_routes_give_the_same_loss_on_the_same_batch(rgcn_store):
    """The deferred and the materialised route of one sampled batch."""
    g, dec = rgcn_store
    q, aliases = er.rgcn_query(g, er.Mask.NONE, SMALL["batch"], NBRS)
    tables = q.device_tables("cpu")
    _, batch = tbench.sample_one(q, tables, SMALL["n_nodes"],
                                 torch.Generator().manual_seed(3))
    model = EgoRGCN([8, 16, 5], dec, num_relations=2, num_bases=1,
                    device="cpu")
    table = tables["nodes"]["item"].float_attrs
    with torch.no_grad():
        off = er.rgcn_loss(model, batch, aliases, NBRS)
        on = er.rgcn_loss(model, er.pre_aggregate_deepest(
            batch, aliases, table, 4), aliases, NBRS)
    np.testing.assert_allclose(on.item(), off.item(), rtol=1e-6)


def test_the_store_draws_the_jax_numbers():
    """``build_rgcn_graph`` at a small cfg: the arrays of run_rgcn's numpy
    draws (np.random.default_rng(0): features, labels, then src, dst and
    weights per relation)."""
    cfg = dict(n_nodes=300, avg_degree=5, feat_dim=6, classes=7)
    g, dec = er.build_rgcn_graph(cfg, "cpu")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((300, 6), np.float32)
    labels = rng.integers(0, 7, 300).astype(np.int32)
    nt = g.store.node_table("item")
    np.testing.assert_array_equal(nt.float_attrs, feats)
    np.testing.assert_array_equal(nt.labels, labels)
    assert dec.labeled and dec.float_attr_num == 6
    for rel in ("rel0", "rel1"):
        src, dst = rng.integers(0, 300, 750), rng.integers(0, 300, 750)
        w = rng.random(750).astype(np.float32)
        et = g.store.edge_table(rel)
        np.testing.assert_array_equal(et.src, src)
        np.testing.assert_array_equal(et.dst, dst)
        np.testing.assert_array_equal(et.weights, w)


@pytest.mark.parametrize("defer", ["0", "1"])
def test_family_scale_rgcn_small_runs_eagerly_and_prints_its_line(
        defer, monkeypatch):
    monkeypatch.setenv("GLT_RGCN_DEFER", defer)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fs.main(["--small", "--cpu", "--families", "rgcn"]) == 0
    assert re.fullmatch(r"rgcn +[0-9.]+M edges/s  [0-9.]+ ms/step  "
                        r"\(warm [0-9.]+s\)\n", out.getvalue())


@pytest.mark.parametrize("defer", [False, True])
def test_k_steps_a_call_count_their_edges_and_their_launches(defer,
                                                             monkeypatch):
    """``run_rgcn`` on the CPU: finite losses, 1024-style edge count, and
    per step 7 gathers, or 3 gathers and 4 group means under deferral."""
    calls = {"gather": 0, "spmm": 0}
    plain_spmm = spmm.segment_spmm_plain
    plain_gather = gather.gather_rows_plain

    def spy_spmm(*args, **kw):
        calls["spmm"] += 1
        return plain_spmm(*args, **kw)

    def spy_gather(*args):
        calls["gather"] += 1
        return plain_gather(*args)

    monkeypatch.setattr(spmm, "segment_spmm_plain", spy_spmm)
    monkeypatch.setattr(gather, "gather_rows_plain", spy_gather)
    cfg = dict(SMALL, batch=32, steps=4, scan_steps=2)
    with both_confs(storage_profile="minimal"):
        r = fs.run_rgcn(cfg, small=True, device="cpu", defer=defer)
    assert r["capture"] is False and r["capture_s"] is None
    assert r["defer"] is defer
    assert r["edges_per_step"] == 32 * (2 * 4 + 4 * 4 * 2)
    n_steps = (1 + r["rounds"]) * 2
    assert len(r["losses"]) == n_steps and np.isfinite(r["losses"]).all()
    assert r["csr_build_s"] > 0 and r["tables_bytes"] > 0
    # the first batch's loss, then every step
    want = {"gather": 3, "spmm": 4} if defer else {"gather": 7, "spmm": 0}
    assert calls == {k: v * (n_steps + 1) for k, v in want.items()}
    assert all(s.dtype == torch.int32 and int(s.max()) < 600
               for s in r["step"].seeds)


def test_the_local_trainer_example_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc = er.main(["--cpu", "--n_nodes", "800", "--epochs", "2",
                       "--steps_per_epoch", "3", "--batch_size", "32",
                       "--hidden", "16", "--features_num", "8"])
    text = out.getvalue()
    assert re.search(r"^test accuracy: [01]\.\d{4}$", text, re.M)
    assert len(re.findall(r"^epoch \d loss [0-9.]+", text, re.M)) == 2
    assert 0.0 <= acc <= 1.0
