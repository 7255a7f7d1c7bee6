"""The port's SubGraph slice against the JAX package: induction
(``ops/subgraph.py``) bit for bit on duplicates, padding, zero-degree seeds,
rows cut at the cap and BFS distances; the ``SubGraph`` plan node through
``Dataset``, its plan records and serving; ``BatchGraph`` and
``HeteroBatchGraph`` exactly; and the readouts, the convs, the stacks and
``LinkPredictor`` within 1e-5, with the flax parameters carried across by
``nn/convert.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.core.values import Nodes as JNodes
from graph_learn_tpu.gsl import plan as jplan
from graph_learn_tpu.nn import subgraph_data as jdata
from graph_learn_tpu.nn.layers import sub as jsub
from graph_learn_tpu.nn.models import sub_models as jmodels
from graph_learn_tpu.online.serving import QueryService as JaxQueryService
from graph_learn_tpu.ops import subgraph as jops
from graph_learn_tpu_torch.core.values import Nodes, SparseNodes
from graph_learn_tpu_torch.gsl import plan as tplan
from graph_learn_tpu_torch.nn import subgraph_data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.data import DeferredRows
from graph_learn_tpu_torch.nn.layers import sub as tsub
from graph_learn_tpu_torch.nn.models import sub_models as tmodels
from graph_learn_tpu_torch.ops import segment as tseg
from graph_learn_tpu_torch.ops import subgraph as tops
from torch_parity import (assert_trees_close, grad_tree, jax_graph,
                          numpy_graph, torch_graph)

# f32 sums of the same terms in other orders (segment sums, matmuls):
# outputs within 1e-5 relative plus 1e-6 absolute
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.fixture(scope="module")
def stores():
    # the last 6 nodes have no out-edges: zero-degree seeds
    a = numpy_graph(n=60, avg_degree=5, d=6, isolated=6, seed=11)
    jg, _ = jax_graph(a)
    tg, _ = torch_graph(a)
    return (a, jg, tg, jg.store.edge_table("rel").device().out,
            tg.store.edge_table("rel").device("cpu").out)


def _same_subgraph(t, j, what=""):
    for f in ("node_ids", "num_nodes", "edge_index", "num_edges",
              "edge_ids", "dist_to_src", "dist_to_dst"):
        tv, jv = getattr(t, f), _np(getattr(j, f))
        assert (tv is None) == (jv is None), (what, f)
        if jv is not None:
            assert tv.dtype == torch.int32, (what, f, tv.dtype)
            np.testing.assert_array_equal(tv.numpy(), jv, "%s.%s"
                                          % (what, f))


def _seed_sets(case, rng, B=5, S=9):
    if case == "duplicates":
        return rng.integers(0, 20, (B, S))
    if case == "all_equal":
        return np.repeat(rng.integers(0, 60, (B, 1)), S, axis=1)
    if case == "zero_degree":
        return rng.integers(50, 60, (B, S))  # mostly isolated nodes
    return rng.integers(0, 60, (B, S))


@pytest.mark.parametrize("case", ["distinct", "duplicates", "all_equal",
                                  "zero_degree"])
@pytest.mark.parametrize("cap,dist", [(None, False), (3, True), (40, True)])
def test_induce_batched_is_bit_equal_to_jax(stores, case, cap, dist):
    _, _, _, jcsr, tcsr = stores
    seeds = _seed_sets(case, np.random.default_rng(len(case)))
    want = jops.induce_batched(jcsr, jnp.asarray(seeds, jnp.int32),
                               nbr_cap=cap, need_dist=dist,
                               num_bfs_steps=2)
    got = tops.induce_batched(tcsr, torch.from_numpy(seeds), nbr_cap=cap,
                              need_dist=dist, num_bfs_steps=2)
    _same_subgraph(got, want, case)
    if cap == 3:  # some rows were cut at the cap
        assert int(tcsr.degrees().max()) > 3


@pytest.mark.parametrize("steps", [1, 3])
def test_induce_subgraph_is_bit_equal_to_jax(stores, steps):
    _, _, _, jcsr, tcsr = stores
    seeds = np.random.default_rng(steps).integers(0, 60, 25)
    seeds[3] = seeds[7]  # a duplicate
    want = jops.induce_subgraph(jcsr, jnp.asarray(seeds, jnp.int32),
                                nbr_cap=8, need_dist=True,
                                num_bfs_steps=steps)
    got = tops.induce_subgraph(tcsr, torch.from_numpy(seeds), nbr_cap=8,
                               need_dist=True, num_bfs_steps=steps)
    _same_subgraph(got, want)
    assert got.node_ids.shape == (25,) and got.num_nodes.dim() == 0


@pytest.mark.parametrize("rows", [
    [[5, 3, 3, 9, 5, 1]], [[7, 7, 7, 7]], [[0, 2 ** 31 - 1, 4, 0]],
    [[9, 8, 7, 6], [1, 1, 2, 2], [3, 3, 3, 3]]])
def test_unique_rows_equals_jnp_unique_with_a_static_size(rows):
    r = np.asarray(rows, np.int32)
    got = tops.unique_rows(torch.from_numpy(r)).numpy()
    for row, g in zip(r, got):
        want = jnp.unique(jnp.asarray(row), size=row.size,
                          fill_value=jnp.int32(2 ** 31 - 1))
        np.testing.assert_array_equal(g, np.asarray(want))


def test_unique_rows_reads_nothing_back(monkeypatch):
    """No ``torch.unique`` and no ``.item()``: a captured step can induce."""
    def refuse(*a, **k):
        raise AssertionError("a host read in the induction")
    monkeypatch.setattr(torch, "unique", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    a = numpy_graph(n=20, avg_degree=3, d=2, seed=1)
    tg, _ = torch_graph(a)
    csr = tg.store.edge_table("rel").device("cpu").out
    sg = tops.induce_batched(csr, torch.randint(0, 20, (4, 6)), nbr_cap=4,
                             need_dist=True)
    assert sg.edge_index.shape == (4, 2, 24)


def _subgraph_query(g, cap, dist):
    return (g.V("item").batch(12).alias("s")
            .SubGraph("rel", nbr_cap=cap, need_dist=dist).alias("sg")
            .values())


@pytest.mark.parametrize("cap,dist", [(None, False), (4, True)])
def test_the_plan_node_through_dataset_equals_jax(stores, cap, dist):
    a, jg, tg, _, _ = stores
    jb = gl.Dataset(_subgraph_query(jg, cap, dist), window=1).next()
    tb = glt.Dataset(_subgraph_query(tg, cap, dist), window=1,
                     device="cpu").next()
    _same_subgraph(tb["sg"], jb["sg"])
    assert tb["sg"].type_name == jb["sg"].type_name == "rel"
    tn, jn = tb["sg"].nodes, jb["sg"].nodes
    np.testing.assert_array_equal(tn.ids.numpy(), np.asarray(jn.ids))
    np.testing.assert_array_equal(tn.raw_ids.numpy(), np.asarray(jn.raw_ids))
    # the node rows stay deferred; gathered, they are the JAX payload
    assert isinstance(tn.float_attrs, DeferredRows)
    np.testing.assert_array_equal(tn.float_attrs.materialize().numpy(),
                                  np.asarray(jn.float_attrs))


def test_a_subgraph_plan_installs_in_either_package(stores):
    _, jg, tg, _, _ = stores
    jp = jplan.query_to_plan(_subgraph_query(jg, 5, True))
    tp = tplan.query_to_plan(_subgraph_query(tg, 5, True))
    assert json.loads(json.dumps(tp)) == tp
    assert tp == jp
    sub = [r for r in tp["nodes"] if r["kind"] == "subgraph"]
    assert [(r["nbr_cap"], r["need_dist"]) for r in sub] == [(5, True)]
    assert tplan.query_to_plan(tplan.plan_to_query(tg, jp)) == tp
    assert jplan.query_to_plan(jplan.plan_to_query(jg, tp)) == jp
    tb = glt.Dataset(tplan.plan_to_query(tg, jp), window=1,
                     device="cpu").next()
    jb = gl.Dataset(jplan.plan_to_query(jg, tp), window=1).next()
    _same_subgraph(tb["sg"], jb["sg"])


def test_serving_a_subgraph_query_answers_each_request_unsliced(stores):
    a, jg, tg, _, _ = stores
    ids = a["raw_ids"][[3, 9, 9, 41]]
    svc = glt.QueryService(tg, device="cpu")
    jsvc = JaxQueryService(jg)
    try:
        got = svc.run(svc.install(_subgraph_query(tg, 6, True),
                                  micro_batch=8), ids)
        want = jsvc.run(jsvc.install(_subgraph_query(jg, 6, True),
                                     micro_batch=8), ids)
        with pytest.raises(glt.InvalidArgumentError, match="micro_batch"):
            svc.run(0, a["raw_ids"][:9])
    finally:
        svc.close()
        jsvc.close()
    # the seeds are cut to the request; the subgraph keeps the launch's
    # (padded) shapes
    np.testing.assert_array_equal(got["s"].raw_ids.numpy(), ids)
    assert got["sg"].node_ids.shape == (8,)
    _same_subgraph(got["sg"], want["sg"])
    assert int(got["sg"].num_nodes) == 3


def test_segment_sum_equals_jax_and_drops_out_of_range_ids():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((40, 3, 2)).astype(np.float32)
    s = rng.integers(-2, 9, 40).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(s),
                               num_segments=7)
    tv = torch.from_numpy(v).requires_grad_()
    got = tseg.segment_sum(tv, torch.from_numpy(s), 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    g = rng.standard_normal((7, 3, 2)).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jgrad = jax.grad(lambda x: jnp.sum(jax.ops.segment_sum(
        x, jnp.asarray(s), num_segments=7) * g))(jnp.asarray(v))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jgrad))
    rows = tseg.take_rows(got, torch.tensor([6, 0, 6]))
    assert torch.equal(rows, got[[6, 0, 6]])


# ---------------------------------------------------------------------------
# BatchGraph, HeteroBatchGraph
# ---------------------------------------------------------------------------

def _same_batch_graph(t, j):
    for f in ("edge_index", "node_ids", "node_mask", "edge_mask",
              "graph_ids", "dist_to_src", "dist_to_dst"):
        tv, jv = getattr(t, f), _np(getattr(j, f))
        assert (tv is None) == (jv is None), f
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), jv, f)
    assert (t.num_samples, t.node_cap) == (j.num_samples, j.node_cap)


def test_batch_graph_from_subgraphs_is_bit_equal_to_jax(stores):
    _, jg, tg, jcsr, tcsr = stores
    seeds = np.random.default_rng(5).integers(0, 60, (6, 7))
    jsg = jops.induce_batched(jcsr, jnp.asarray(seeds, jnp.int32),
                              nbr_cap=5, need_dist=True, num_bfs_steps=2)
    tsg = tops.induce_batched(tcsr, torch.from_numpy(seeds), nbr_cap=5,
                              need_dist=True, num_bfs_steps=2)
    _same_batch_graph(tdata.BatchGraph.from_subgraphs(tsg),
                      jdata.BatchGraph.from_subgraphs(jsg))


def _star_values(a, b=5, ks=4, kd=3, seed=2, deferred=True):
    """The same four payloads (src, dst [b, 1], src and dst neighbours as
    SparseNodes) for both packages."""
    from graph_learn_tpu.core.values import SparseNodes as JSparse
    rng = np.random.default_rng(seed)
    n, d = a["feats"].shape
    table = torch.from_numpy(a["feats"])
    ids = [rng.integers(0, n, s) for s in ((b,), (b, 1), (b, ks), (b, kd))]
    degs = [rng.integers(0, ks + 1, b), rng.integers(0, kd + 1, b)]
    iattr = [rng.integers(0, 9, i.shape + (2,)) for i in ids]

    def rows(i):
        t = torch.from_numpy(i.astype(np.int32))
        return DeferredRows(table, t) if deferred else table[t.long()]

    tv = [Nodes(ids=torch.from_numpy(ids[0].astype(np.int32)),
                int_attrs=torch.from_numpy(iattr[0]), float_attrs=rows(ids[0]),
                type_name="item"),
          Nodes(ids=torch.from_numpy(ids[1].astype(np.int32)),
                int_attrs=torch.from_numpy(iattr[1]),
                float_attrs=rows(ids[1]), type_name="item")]
    jv = [JNodes(ids=jnp.asarray(ids[0], jnp.int32),
                 int_attrs=jnp.asarray(iattr[0]),
                 float_attrs=jnp.asarray(a["feats"][ids[0]]),
                 type_name="item"),
          JNodes(ids=jnp.asarray(ids[1], jnp.int32),
                 int_attrs=jnp.asarray(iattr[1]),
                 float_attrs=jnp.asarray(a["feats"][ids[1]]),
                 type_name="item")]
    for i, dg in ((2, degs[0]), (3, degs[1])):
        tv.append(SparseNodes(ids=torch.from_numpy(ids[i].astype(np.int32)),
                              degrees=torch.from_numpy(dg.astype(np.int32)),
                              int_attrs=torch.from_numpy(iattr[i]),
                              float_attrs=rows(ids[i]), type_name="item"))
        jv.append(JSparse(ids=jnp.asarray(ids[i], jnp.int32),
                          degrees=jnp.asarray(dg, jnp.int32),
                          int_attrs=jnp.asarray(iattr[i]),
                          float_attrs=jnp.asarray(a["feats"][ids[i]]),
                          type_name="item"))
    return tv, jv


@pytest.mark.parametrize("deferred", [True, False])
def test_batch_graph_from_edge_star_is_bit_equal_to_jax(stores, deferred):
    a = stores[0]
    tv, jv = _star_values(a, deferred=deferred)
    t = tdata.BatchGraph.from_edge_star(*tv)
    j = jdata.BatchGraph.from_edge_star(*jv)
    _same_batch_graph(t, j)
    np.testing.assert_array_equal(t.nodes.ids.numpy(),
                                  np.asarray(j.nodes.ids))
    np.testing.assert_array_equal(t.nodes.int_attrs.numpy(),
                                  np.asarray(j.nodes.int_attrs))
    fa = t.nodes.float_attrs
    if deferred:
        # the four id blocks concatenated: one gather for every slot
        assert isinstance(fa, DeferredRows) and fa.idx.shape == (5 * 9,)
        fa = fa.materialize()
    np.testing.assert_array_equal(fa.numpy(), np.asarray(j.nodes.float_attrs))


def _hetero_inputs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    caps = {"u": 4, "v": 3}
    topo = {"u-v": ("u", "v"), "v-u": ("v", "u"), "u-u": ("u", "u")}
    feats = {"u": rng.standard_normal((b, 4, 5)).astype(np.float32),
             "v": rng.standard_normal((b, 3, 6)).astype(np.float32)}
    masks = {t: rng.random((b, c)) < 0.8 for t, c in caps.items()}
    ei, em = {}, {}
    for et, (s, d) in topo.items():
        ei[et] = np.stack([rng.integers(0, caps[s], (b, 7)),
                           rng.integers(0, caps[d], (b, 7))],
                          axis=1).astype(np.int32)
        em[et] = rng.random((b, 7)) < 0.7
    return caps, topo, feats, masks, ei, em


def _hetero_graphs(seed=0):
    caps, topo, feats, masks, ei, em = _hetero_inputs(seed)
    tnodes = {t: Nodes(ids=torch.zeros(f.shape[:2], dtype=torch.int32),
                       float_attrs=torch.from_numpy(f))
              for t, f in feats.items()}
    jnodes = {t: JNodes(ids=jnp.zeros(f.shape[:2], jnp.int32),
                        float_attrs=jnp.asarray(f))
              for t, f in feats.items()}
    t = tdata.HeteroBatchGraph.from_samples(
        tnodes, {k: torch.from_numpy(v) for k, v in masks.items()},
        {k: torch.from_numpy(v) for k, v in ei.items()},
        {k: torch.from_numpy(v) for k, v in em.items()}, topo)
    j = jdata.HeteroBatchGraph.from_samples(
        jnodes, {k: jnp.asarray(v) for k, v in masks.items()},
        {k: jnp.asarray(v) for k, v in ei.items()},
        {k: jnp.asarray(v) for k, v in em.items()}, topo)
    return t, j


def test_hetero_batch_graph_from_samples_is_bit_equal_to_jax():
    t, j = _hetero_graphs()
    for f in ("edge_index", "edge_mask", "node_mask", "graph_ids"):
        tv, jv = getattr(t, f), getattr(j, f)
        assert sorted(tv) == sorted(jv), f
        for k in jv:
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]),
                                          "%s[%s]" % (f, k))
    for k in j.nodes:
        np.testing.assert_array_equal(t.nodes[k].float_attrs.numpy(),
                                      np.asarray(j.nodes[k].float_attrs))
    assert (t.num_samples, t.node_cap, t.topology) == (
        j.num_samples, j.node_cap, j.topology)
    h = np.random.default_rng(1).standard_normal((12, 4)).astype(np.float32)
    for op in ("sum", "mean", "max"):
        np.testing.assert_allclose(
            t.readout(torch.from_numpy(h), "u", op).numpy(),
            np.asarray(j.readout(jnp.asarray(h), "u", op)),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        t.anchor(torch.from_numpy(h), "u", 2).numpy(),
        np.asarray(j.anchor(jnp.asarray(h), "u", 2)))


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_readout_and_anchor_equal_jax(stores, op):
    _, _, _, jcsr, tcsr = stores
    seeds = np.random.default_rng(9).integers(0, 60, (4, 6))
    seeds[2] = 55  # one sample of a single isolated node
    jbg = jdata.BatchGraph.from_subgraphs(jops.induce_batched(
        jcsr, jnp.asarray(seeds, jnp.int32), nbr_cap=4))
    tbg = tdata.BatchGraph.from_subgraphs(tops.induce_batched(
        tcsr, torch.from_numpy(seeds), nbr_cap=4))
    h = np.random.default_rng(3).standard_normal((24, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tbg.readout(torch.from_numpy(h), op).numpy(),
        np.asarray(jbg.readout(jnp.asarray(h), op)), rtol=RTOL, atol=ATOL)
    for slot in (0, 1):
        np.testing.assert_array_equal(
            tbg.anchor(torch.from_numpy(h), slot).numpy(),
            np.asarray(jbg.anchor(jnp.asarray(h), slot)))


# ---------------------------------------------------------------------------
# convs, stacks, LinkPredictor against flax
# ---------------------------------------------------------------------------

def _graph_inputs(n=11, e=30, d=5, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    mask = rng.random(e) < 0.7
    return ei, x, mask


def _conv_pair(kind, d, out=4):
    """(flax conv, port conv) of one configuration."""
    if kind.startswith("sage"):
        agg = kind.split("_")[1]
        kw = dict(agg_type=agg, normalize=agg == "sum", use_bias=agg == "mean")
        return (jsub.SAGEConv(in_dim=d, out_dim=out, **kw),
                tsub.SAGEConv(d, out, **kw))
    if kind == "gcn":
        return (jsub.GCNConv(in_dim=d, out_dim=out, use_bias=True),
                tsub.GCNConv(d, out, use_bias=True))
    heads, concat = {"gat1": (1, False), "gat2_concat": (2, True),
                     "gat2_mean": (2, False)}[kind]
    kw = dict(num_heads=heads, concat=concat, use_bias=concat)
    return (jsub.GATConv(in_dim=d, out_dim=out, **kw),
            tsub.GATConv(d, out, **kw))


def _assert_grads(tmodel, jgrads):
    assert_trees_close(grad_tree(tmodel), jgrads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["sage_mean", "sage_sum", "sage_gcn", "gcn",
                                  "gat1", "gat2_concat", "gat2_mean"])
def test_each_conv_equals_flax(kind, masked):
    ei, x, mask = _graph_inputs(seed=len(kind))
    jconv, tconv = _conv_pair(kind, x.shape[1])
    m = jnp.asarray(mask) if masked else None
    params = jconv.init(jax.random.key(1), jnp.asarray(ei), jnp.asarray(x),
                        edge_mask=m)
    # make the zero-initialised biases count
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 if "bias" in jax.tree_util.keystr(p) else v,
        params)
    load_flax_params(tconv, params)
    g = np.random.default_rng(2).standard_normal(
        jconv.apply(params, jnp.asarray(ei), jnp.asarray(x),
                    edge_mask=m).shape).astype(np.float32)
    want, jgrads = jax.value_and_grad(lambda p: jnp.sum(jconv.apply(
        p, jnp.asarray(ei), jnp.asarray(x), edge_mask=m) * g))(params)
    tm = torch.from_numpy(mask) if masked else None
    out = tconv(torch.from_numpy(ei), torch.from_numpy(x), edge_mask=tm)
    loss = (out * torch.from_numpy(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL,
                               atol=1e-5)
    _assert_grads(tconv, jgrads)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jconv.apply(params, jnp.asarray(ei), jnp.asarray(x),
                               edge_mask=m)), rtol=RTOL, atol=ATOL)
    wrapped = tmodels.SubGraphStack([tconv], device="cpu")
    load_flax_params(wrapped, {"params": {"convs_0": params["params"]}})
    assert_trees_close(to_flax_params(wrapped)["params"]["convs_0"],
                       params["params"])


def test_hetero_conv_over_two_edge_types_equals_flax():
    rng = np.random.default_rng(4)
    xs = {"u": rng.standard_normal((5, 3)).astype(np.float32),
          "v": rng.standard_normal((4, 6)).astype(np.float32)}
    topo = {"u-v": ("u", "v"), "v-u": ("v", "u"), "u-u": ("u", "u")}
    eis = {et: np.stack([rng.integers(0, xs[s].shape[0], 9),
                         rng.integers(0, xs[d].shape[0], 9)]).astype(
                             np.int32) for et, (s, d) in topo.items()}
    masks = {et: rng.random(9) < 0.7 for et in topo}
    jconv = jsub.HeteroConv(convs={
        "u-v": jsub.SAGEConv(in_dim=(3, 6), out_dim=4),
        "v-u": jsub.SAGEConv(in_dim=(6, 3), out_dim=4, agg_type="sum"),
        "u-u": jsub.GCNConv(in_dim=3, out_dim=4)})
    tconv = tsub.HeteroConv({
        "u-v": tsub.SAGEConv((3, 6), 4), "v-u": tsub.SAGEConv((6, 3), 4,
                                                              agg_type="sum"),
        "u-u": tsub.GCNConv(3, 4)})
    jargs = ({k: jnp.asarray(v) for k, v in eis.items()},
             {k: jnp.asarray(v) for k, v in xs.items()}, topo,
             {k: jnp.asarray(v) for k, v in masks.items()})
    params = jconv.init(jax.random.key(0), *jargs)
    load_flax_params(tconv, params)
    want = jconv.apply(params, *jargs)
    got = tconv({k: torch.from_numpy(v) for k, v in eis.items()},
                {k: torch.from_numpy(v) for k, v in xs.items()}, topo,
                {k: torch.from_numpy(v) for k, v in masks.items()})
    assert sorted(got) == sorted(want) == ["u", "v"]
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=RTOL, atol=ATOL)
    assert_trees_close(to_flax_params(tconv), params)


@pytest.mark.parametrize("stack", ["sage", "gcn", "gat"])
def test_stacks_equal_flax_outputs_and_gradients(stack):
    ei, x, mask = _graph_inputs(n=13, e=40, d=6, seed=7)
    dims = [6, 8, 3]
    if stack == "sage":
        jm, tm = (jmodels.GraphSAGE(dims, agg_type="mean"),
                  tmodels.GraphSAGE(dims, agg_type="mean", device="cpu"))
    elif stack == "gcn":
        jm, tm = jmodels.GCN(dims), tmodels.GCN(dims, device="cpu")
    else:
        jm, tm = (jmodels.GAT(dims, num_heads=2),
                  tmodels.GAT(dims, num_heads=2, device="cpu"))
    jargs = (jnp.asarray(ei), jnp.asarray(x))
    params = jm.init(jax.random.key(3), *jargs, edge_mask=jnp.asarray(mask))
    load_flax_params(tm, params)
    want, jgrads = jax.value_and_grad(lambda p: jnp.sum(jnp.tanh(jm.apply(
        p, *jargs, edge_mask=jnp.asarray(mask)))))(params)
    loss = torch.tanh(tm(torch.from_numpy(ei), torch.from_numpy(x),
                         edge_mask=torch.from_numpy(mask))).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    _assert_grads(tm, jgrads)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_link_predictor_equals_flax(layers):
    rng = np.random.default_rng(layers)
    s, d = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2))
    jm = jmodels.LinkPredictor(hidden_dim=5, num_layers=layers)
    tm = tmodels.LinkPredictor(5, num_layers=layers, device="cpu")
    params = jm.init(jax.random.key(0), jnp.asarray(s), jnp.asarray(d))
    load_flax_params(tm, params)
    np.testing.assert_allclose(
        tm(torch.from_numpy(s), torch.from_numpy(d)).detach().numpy(),
        np.asarray(jm.apply(params, jnp.asarray(s), jnp.asarray(d))),
        rtol=RTOL, atol=ATOL)
    assert_trees_close(to_flax_params(tm), params)


def test_a_gat_stack_passes_no_training_to_its_convs():
    """As in the JAX stack: attention dropout never acts inside a stack."""
    ei, x, mask = _graph_inputs(seed=3)
    m = tmodels.GAT([5, 4], num_heads=2, attn_dropout=0.9, device="cpu")
    args = (torch.from_numpy(ei), torch.from_numpy(x))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(m(*args, training=True, generator=gen), m(*args))
    conv = m.convs[0]
    assert not torch.equal(conv(*args, training=True, generator=gen),
                           conv(*args))
