"""The port's edge sources, endpoint views, edge hops, masks and node_from
seed sets, and ``.each()`` against the JAX package's on the same two-type
graph: ``E()`` batches epoch for epoch, ``outV()`` / ``inV()`` of an edge,
``outE`` / ``inE`` on JAX's own uniform numbers, ``V(t, mask=...)`` and
``V(e, node_from=...)``.  Ids, weights and labels are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.core.store import NodeSet as JaxNodeSet
from graph_learn_tpu.gsl import plan as jplan
from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu_torch.core.values import Edges, Nodes, SparseNodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.gsl import plan as tplan
from graph_learn_tpu_torch.ops import sampling
from torch_parity import jax_u2i_graph, torch_u2i_graph, u2i_arrays


@pytest.fixture(scope="module")
def graphs():
    a = u2i_arrays()
    return a, jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]


def _np(x):
    return None if x is None else np.asarray(x)


def _same_nodes(t, j, what):
    for f in ("ids", "raw_ids", "weights", "labels"):
        tv, jv = getattr(t, f), _np(getattr(j, f))
        if jv is None:
            assert tv is None, (what, f)
            continue
        np.testing.assert_array_equal(tv.numpy(), jv, "%s.%s" % (what, f))
    assert t.type_name == j.type_name, what


def _same_edges(t, j, what):
    assert isinstance(t, Edges), what
    np.testing.assert_array_equal(t.edge_ids.numpy(), _np(j.edge_ids), what)
    for f in ("weights", "labels"):
        tv, jv = getattr(t, f), _np(getattr(j, f))
        assert (tv is None) == (jv is None), (what, f)
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), jv, what + "." + f)
    _same_nodes(t.src_nodes, j.src_nodes, what + ".src")
    _same_nodes(t.dst_nodes, j.dst_nodes, what + ".dst")
    assert t.type_name == j.type_name


def _epoch(ds, n, next_fn):
    out = []
    for _ in range(n):
        try:
            out.append(next_fn(ds))
        except (gl.OutOfRangeError, glt.OutOfRangeError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("batch", [64, 100])
def test_edge_batches_equal_the_jax_dataset_epoch_for_epoch(graphs, batch):
    """by_order over 400 edges: full batches, the padded tail with its
    true count, OutOfRangeError, then the next epoch from the start."""
    a, jg, tg = graphs

    def query(g):
        seed = g.E("u-i").batch(batch).alias("seed")
        seed.outV().alias("src")
        seed.inV().alias("dst")
        return seed.values()

    n = -(-a["ui_src"].size // batch) + 2
    jds = gl.Dataset(query(jg), window=2)
    tds = glt.Dataset(query(tg), window=2, device="cpu")
    jout = _epoch(jds, n, lambda d: d.next_with_count())
    tout = _epoch(tds, n, lambda d: d.next_with_count())
    assert [isinstance(x, str) for x in jout] == \
        [isinstance(x, str) for x in tout]
    assert "OutOfRangeError" in tout
    for jx, tx in zip(jout, tout):
        if isinstance(jx, str):
            continue
        (jb, jc), (tb, tc) = jx, tx
        assert jc == tc
        _same_edges(tb["seed"], jb["seed"], "seed")
        # the endpoint views are the edge's src / dst nodes
        _same_nodes(tb["src"], jb["src"], "src")
        _same_nodes(tb["dst"], jb["dst"], "dst")
        assert torch.equal(tb["src"].ids, tb["seed"].src_ids)
        assert torch.equal(tb["dst"].ids, tb["seed"].dst_ids)
        eids = tb["seed"].edge_ids.numpy()
        np.testing.assert_array_equal(tb["src"].ids.numpy(),
                                      a["ui_src"][eids])
        np.testing.assert_array_equal(tb["dst"].ids.numpy(),
                                      a["ui_dst"][eids])


def _jax_u(key, n_nodes, nid, shape):
    """The uniform numbers JAX's plan draws at node ``nid``: one key per
    node, split from the plan's key (gsl/compile.py _execute)."""
    return np.array(jax.random.uniform(jax.random.split(key, n_nodes)[nid],
                                       shape))


@pytest.mark.parametrize("kind", ["outE", "inE"])
def test_edge_hops_equal_jax_on_its_own_draws(graphs, kind, monkeypatch):
    """tests/test_gsl.py test_out_e_hop, held against the JAX plan: the
    port's uniform sampler is fed the numbers JAX drew for the hop."""
    a, jg, tg = graphs
    b, k = 12, 3

    def query(g):
        src = g.V("i").batch(b).alias("src")
        getattr(src, kind)("i-i").sample(k).by("random").alias("e1")
        return src.values()

    jq, tq = query(jg), query(tg)
    seeds = np.random.default_rng(1).integers(0, 50, b).astype(np.int32)
    key = jax.random.key(3)
    jout = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds), key)
    u = _jax_u(key, len(jq.dag.nodes), 1, (b, k))
    monkeypatch.setitem(
        sampling.STRATEGY_FNS, "random",
        lambda csr, s, k_, g_, flt=None: sampling.uniform_draw(
            csr, s, torch.from_numpy(u), flt))
    tout = tcompile._execute(tq, tq.device_tables("cpu"),
                             torch.from_numpy(seeds), torch.Generator())
    e = tout["e1"]
    _same_edges(e, jout["e1"], kind)
    assert e.edge_ids.shape == (b, k) and e.src_nodes.ids.shape == (b, k)
    np.testing.assert_array_equal(
        e.src_nodes.ids.numpy(), np.broadcast_to(seeds[:, None], (b, k)))
    # every edge joins its seed and its sampled node
    live = e.edge_ids.numpy() >= 0
    assert live.all()
    ends = (a["ii_src"], a["ii_dst"]) if kind == "outE" else \
        (a["ii_dst"], a["ii_src"])
    np.testing.assert_array_equal(ends[0][e.edge_ids.numpy()],
                                  e.src_nodes.ids.numpy())
    np.testing.assert_array_equal(ends[1][e.edge_ids.numpy()],
                                  e.dst_nodes.ids.numpy())


def test_edge_payload_zeroes_the_weight_of_a_missing_edge(graphs):
    from graph_learn_tpu.ops.lookup import edge_payload as jax_edge_payload
    from graph_learn_tpu_torch.ops.lookup import edge_payload
    _, jg, tg = graphs
    eids = np.array([[0, -1, 5], [-1, 399, 7]], np.int32)
    jp = jax_edge_payload(jg.store.edge_table("u-i").device(),
                          jnp.asarray(eids))
    tp = edge_payload(tg.store.edge_table("u-i").device("cpu"),
                      torch.from_numpy(eids))
    for f in ("weights", "labels"):
        np.testing.assert_array_equal(tp[f].numpy(), np.asarray(jp[f]), f)
    assert (tp["weights"].numpy()[eids < 0] == 0).all()


def test_a_full_edge_hop_answers_sparse_nodes_as_jax_does(graphs):
    """The JAX plan checks "full" before it builds Edges, so a full outE
    hop returns SparseNodes of the neighbours: copied as it is."""
    _, jg, tg = graphs

    def query(g):
        return (g.V("u").batch(8).alias("src").outE("u-i").sample(20)
                .by("full").alias("e").values())

    seeds = np.arange(52, 60, dtype=np.int32)  # the isolated user among them
    jq, tq = query(jg), query(tg)
    j = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds),
                    jax.random.key(0))["e"]
    t = tcompile._execute(tq, tq.device_tables("cpu"),
                          torch.from_numpy(seeds), torch.Generator())["e"]
    assert isinstance(t, SparseNodes) and type(j).__name__ == "SparseNodes"
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.degrees.numpy(), np.asarray(j.degrees))
    assert t.degrees[-1] == 0


def test_each_branches_the_query(graphs):
    _, jg, tg = graphs

    def query(g):
        seed = g.E("u-i").batch(16).alias("seed")
        seed.each(lambda e: (e.outV().alias("src"), e.inV().alias("dst")))
        return seed.values()

    jb = gl.Dataset(query(jg), window=1).next()
    tb = glt.Dataset(query(tg), window=1, device="cpu").next()
    assert sorted(tb) == sorted(jb) == ["dst", "seed", "src"]
    _same_nodes(tb["src"], jb["src"], "src")
    _same_nodes(tb["dst"], jb["dst"], "dst")


@pytest.mark.parametrize("mask", [gl.Mask.TRAIN, "test"])
def test_masked_v_walks_the_registered_split(graphs, mask):
    a, jg, tg = graphs
    raw = np.array([3, 17, 11, 40, 2, 29, 7], np.int64)
    tmask = mask if isinstance(mask, str) else glt.Mask[mask.name]
    jmask = gl.Mask[mask.upper()] if isinstance(mask, str) else mask
    w = np.linspace(0.5, 2.0, raw.size).astype(np.float32)
    jg.store.add_node_set(JaxNodeSet(
        type_name=jmask.decorate("i"), base_type="i",
        indices=jg.store.node_table("i").index.lookup(raw), weights=w))
    tg.add_node_set("i", raw, tmask, weights=w)
    ns = tg.store.node_set(glt.Mask[jmask.name].decorate("i"))
    np.testing.assert_array_equal(ns.indices, jg.store.node_set(
        jmask.decorate("i")).indices)
    np.testing.assert_array_equal(ns.weights, w)
    jq = jg.V("i", mask=mask).batch(3).alias("t").values()
    tq = tg.V("i", mask=tmask).batch(3).alias("t").values()
    jout = _epoch(gl.Dataset(jq, window=1), 4, lambda d: d.next_with_count())
    tout = _epoch(glt.Dataset(tq, window=1, device="cpu"), 4,
                  lambda d: d.next_with_count())
    for jx, tx in zip(jout, tout):
        if isinstance(jx, str):
            assert tx == "OutOfRangeError"
            continue
        assert jx[1] == tx[1]
        _same_nodes(tx[0]["t"], jx[0]["t"], "t")
    # the split's nodes are the base table's: the features are the rows
    np.testing.assert_array_equal(
        tout[0][0]["t"].raw_ids.numpy(), raw[:3])


@pytest.mark.parametrize("node_from", ["EDGE_SRC", "EDGE_DST"])
def test_node_from_seed_sets_equal_jax(graphs, node_from):
    a, jg, tg = graphs
    jq = jg.V("u-i", node_from=gl.NodeFrom[node_from]).batch(7) \
        .alias("s").values()
    tq = tg.V("u-i", node_from=node_from.lower()).batch(7).alias("s") \
        .values()
    typed = ("ESRC*" if node_from == "EDGE_SRC" else "EDST*") + "u-i"
    jns, tns = jg.store.node_set(typed), tg.store.node_set(typed)
    assert tns.base_type == jns.base_type
    np.testing.assert_array_equal(tns.indices, jns.indices)
    col = a["ui_src"] if node_from == "EDGE_SRC" else a["ui_dst"]
    np.testing.assert_array_equal(tns.indices, np.unique(col))
    jb = gl.Dataset(jq, window=1).next()
    tb = glt.Dataset(tq, window=1, device="cpu").next()
    _same_nodes(tb["s"], jb["s"], "s")
    with pytest.raises(InvalidArgumentError, match="only valid"):
        tg.V("u-i", node_from="edge_src", mask="train")
    # a new edge table of the same type drops the snapshot
    tg.add_edge_table(tg.store.edge_table("u-i"))
    assert typed not in tg.store.node_sets


def _subgraph_plan(g, plan_mod):
    seed = g.E("u-i").batch(4).alias("seed")
    seed.outV().alias("src").SubGraph("u-i", nbr_cap=7, need_dist=True)
    return plan_mod.query_to_plan(seed.values())


def test_unported_kinds_raise_when_the_query_is_built(graphs):
    _, jg, tg = graphs
    seed = tg.E("u-i").batch(4).alias("seed")
    src = seed.outV().alias("src")
    # SubGraph builds since the SubGraph slice, with the JAX package's
    # settings and plan records
    sub = src.SubGraph("u-i", nbr_cap=7, need_dist=True)
    assert (sub.kind, sub.edge_type, sub.nbr_cap, sub.need_dist) == (
        "subgraph", "u-i", 7, True)
    assert _subgraph_plan(tg, tplan) == _subgraph_plan(jg, jplan)
    # conditional negatives build (tests/test_torch_conditional.py runs
    # them): .where makes the set strategy the base draw
    dst = seed.inV().alias("dst")
    neg = src.outNeg("u-i").sample(2).by("in_degree").where(
        "dst", {"int_cols": [0], "int_props": [0.5]})
    assert (neg.strategy, neg.base_strategy, neg.filter_alias) == (
        "conditional", "in_degree", "dst")
    assert neg.condition == {"int_cols": [0], "int_props": [0.5]}
    bare = src.outNeg("u-i").sample(2).by("conditional")
    assert (bare.strategy, bare.base_strategy, bare.condition) == (
        "conditional", "random", None)
    assert dst.kind == "endpoint_dst"
    with pytest.raises(InvalidArgumentError, match="not in"):
        src.outNeg("u-i").sample(2).by("topk")
    with pytest.raises(InvalidArgumentError, match="edge_type required"):
        src.outV()
    with pytest.raises(glt.NotFoundError):
        tg.E("nope")


def test_flat_and_map_reach_every_nested_tensor(graphs):
    _, _, tg = graphs
    q = tg.E("u-i").batch(8).alias("seed").outV().alias("src") \
        .outNeg("u-i").sample(3).by("random").alias("neg") \
        .outV("i-i").sample(2).by("random").alias("h").values()
    out = glt.Dataset(q, window=1, device="cpu").next()
    flat = out["h"].flat()
    assert isinstance(flat, Nodes) and flat.ids.shape == (48,)
    assert flat.float_attrs.idx.shape == (48,)
    assert torch.equal(flat.float_attrs.materialize(),
                       out["h"].float_attrs.materialize().reshape(48, -1))
    seen = []
    out["seed"].map(lambda x: seen.append(tuple(x.shape)) or x)
    # edge ids, weights, labels; each view's ids, raw ids and deferred
    # rows; the items' weights
    assert set(seen) == {(8,)} and len(seen) == 3 + 2 * 3 + 1
