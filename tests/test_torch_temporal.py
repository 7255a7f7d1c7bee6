"""The port's timestamps and temporal samplers against the JAX package's.

Both stores are built in memory from the same numpy arrays
(``torch_parity.temporal_arrays``: epoch-style int64 timestamps in a
narrow range, so that rows hold ties).  Exact where the work is
deterministic (CSR order, ``nbr_ts``, prefix CDFs, ``topk`` / ``full``);
the random strategies are exact on JAX's own uniform numbers, fed to the
port's ``*_draw`` functions; the port's own generator is held to the
prefix oracle by a chi-square test.  The temporal family's step is held
to the JAX family's on the JAX plan's draws.
"""

import contextlib
import io
import re
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from graph_learn_tpu.core import schema as jschema
from graph_learn_tpu.core import store as jstore
from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.loss import supervised_softmax_loss as jax_sup_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGraphSAGE as JaxSAGE
from graph_learn_tpu.ops import temporal as jtemporal
from graph_learn_tpu_torch import bench as tbench
from graph_learn_tpu_torch.core import store as tstore
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples import family_scale as fs
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.data import TemporalGraph
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.ops import sampling, temporal
from graph_learn_tpu_torch.ops.kernels import gather, spmm
from torch_parity import (assert_trees_close, both_confs, jax_temporal_graph,
                          temporal_arrays, temporal_table,
                          torch_temporal_graph)

JMOD = types.SimpleNamespace(Decoder=jschema.Decoder,
                             EdgeTable=jstore.EdgeTable)
TMOD = types.SimpleNamespace(Decoder=Decoder, EdgeTable=tstore.EdgeTable)
B = 48


def _tables(a, profile="full"):
    with both_confs(storage_profile=profile):
        jt, tt = temporal_table(JMOD, a), temporal_table(TMOD, a)
        return jt, tt, jt.device(), tt.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- the store ------------------------------------------------------------

@pytest.mark.parametrize("profile", ["full", "minimal"])
def test_the_csr_is_ts_ascending_and_bit_equal_to_jax(profile):
    """Both directions' CSR (ids, edge ids, ``nbr_ts``, the id-sorted copy
    and both prefix CDFs) equal the JAX package's flat views; rows are
    ts-ascending with ties in insertion order."""
    a = temporal_arrays(seed=1)
    jt, tt, jdev, tdev = _tables(a, profile)
    assert tt.ts_base == jt.ts_base == int(a["ts"].min())
    np.testing.assert_array_equal(tt.timestamps, jt.timestamps)
    np.testing.assert_array_equal(tdev.timestamps.numpy(),
                                  np.asarray(jdev.timestamps))
    np.testing.assert_array_equal(tdev.float_attrs.numpy(),
                                  np.asarray(jdev.float_attrs))
    pairs = [(tdev.out, jdev.out)]
    if profile == "full":
        pairs.append((tdev.inc, jdev.inc))
    else:
        assert tdev.inc is None and jdev.inc is None
    for tc, jc in pairs:
        for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "nbr_ts",
                  "nbr_ids_sorted", "nbr_edge_ids_sorted", "cum_weights",
                  "cum_in_degrees"):
            want = getattr(jc, f)
            got = getattr(tc, f)
            if want is None:
                assert got is None, f
                continue
            assert got.dtype in (torch.int32, torch.float32), f
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), f)
        ro, ts, eid = (tc.row_offsets.numpy(), tc.nbr_ts.numpy(),
                       tc.nbr_edge_ids.numpy())
        for r in range(ro.size - 1):
            seg, e = ts[ro[r]:ro[r + 1]], eid[ro[r]:ro[r + 1]]
            assert np.all(np.diff(seg) >= 0)
            tie = np.diff(seg) == 0
            assert np.all(np.diff(e)[tie] > 0)  # stable: insertion order


@pytest.mark.parametrize("key", ["ts", "ids", "negative", "fractional",
                                 "wide"])
def test_the_fast_stable_order_is_lexsort(key):
    """``_stable_order`` gives ``np.lexsort((key, rows))``'s order, on its
    one-argsort path (integral keys in [0, 2**32)) and off it."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, 5000)
    keys = {"ts": rng.integers(0, 300, 5000).astype(np.float64),
            "ids": rng.integers(0, 40, 5000).astype(np.int32),
            "negative": -rng.random(5000).astype(np.float64),
            "fractional": rng.integers(0, 9, 5000) + 0.5 * (
                rng.random(5000) < 0.5),
            "wide": rng.integers(0, 4, 5000) * 2.0 ** 40}[key]
    np.testing.assert_array_equal(tstore._stable_order(rows, keys),
                                  np.lexsort((keys, rows)))


def test_the_weight_cdf_is_cumulative_over_the_ts_ascending_row():
    a = temporal_arrays(seed=2)
    _, _, _, tdev = _tables(a)
    csr = tdev.out
    ro, cum = csr.row_offsets.numpy(), csr.cum_weights.numpy()
    w = a["weights"][csr.nbr_edge_ids.numpy()]
    for r in range(ro.size - 1):
        row = w[ro[r]:ro[r + 1]].astype(np.float64)
        if row.size:
            np.testing.assert_allclose(cum[ro[r]:ro[r + 1]],
                                       np.cumsum(row) / row.sum(),
                                       rtol=1e-6)


def test_unify_ts_bases_moves_every_table_to_one_base():
    """Two tables with their own minima end on the global one, as the JAX
    package's; the port's Graph does it on every add_edge_table."""
    a = temporal_arrays(seed=3)
    jg, _ = jax_temporal_graph(a, events=slice(100, 160))
    tg, _ = torch_temporal_graph(a, events=slice(100, 160))
    for t in ("rel", "ev"):
        je, te = jg.store.edge_table(t), tg.store.edge_table(t)
        assert te.ts_base == je.ts_base == int(a["ts"].min())
        assert te.ts_scale == je.ts_scale == 1
        np.testing.assert_array_equal(te.timestamps, je.timestamps)
    ev = tg.store.edge_table("ev")
    np.testing.assert_array_equal(ev.timestamps * ev.ts_scale + ev.ts_base,
                                  a["ts"][100:160])


def test_unify_ts_bases_coarsens_a_span_beyond_int32_with_a_warning():
    a = temporal_arrays(n=20, seed=4)
    a["ts"] = (1_600_000_000_000
               + np.arange(a["ts"].size, dtype=np.int64) * 37_000_001)
    a["ts"][::7] = a["ts"][::7][::-1]  # not in insertion order
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jg, _ = jax_temporal_graph(a, events=slice(0, 30))
        jmsg = [str(x.message) for x in w if "coarsening" in str(x.message)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tg, _ = torch_temporal_graph(a, events=slice(0, 30))
        tmsg = [str(x.message) for x in w if "coarsening" in str(x.message)]
    assert tmsg and tmsg[-1] == jmsg[-1]
    for t in ("rel", "ev"):
        je, te = jg.store.edge_table(t), tg.store.edge_table(t)
        assert te.ts_scale == je.ts_scale > 1 and te.ts_base == je.ts_base
        np.testing.assert_array_equal(te.timestamps, je.timestamps)
        assert int(te.timestamps.max()) < 2 ** 31
    # the CSR order is the JAX package's (the fine order under ties)
    jc = jg.store.edge_table("rel").device().out
    tc = tg.store.edge_table("rel").device("cpu").out
    np.testing.assert_array_equal(tc.nbr_edge_ids.numpy(),
                                  np.asarray(jc.nbr_edge_ids))
    np.testing.assert_array_equal(tc.nbr_ts.numpy(), np.asarray(jc.nbr_ts))


def test_the_reverse_table_of_an_undirected_bipartite_type():
    """``add_reverse_edge_table`` as ``Graph.edge(directed=False)``:
    ``<edge>_reverse`` from dst to src with the same payload; an edge type
    within one node type is refused."""
    from graph_learn_tpu_torch.core.store import NodeTable
    from graph_learn_tpu_torch.graph import Graph
    a = temporal_arrays(n=12, seed=5)
    g = Graph(device="cpu")
    dec = Decoder(attr_types=["float"] * 8)
    g.add_node_table(NodeTable("u", dec, np.arange(12), float_attrs=a[
        "feats"][:12]))
    g.add_node_table(NodeTable("i", dec, np.arange(12), float_attrs=a[
        "feats"][:12]))
    rows = a["dst"] < 12
    edec = Decoder(timestamped=True, attr_types=["float"] * 3)
    g.add_edge_table(tstore.EdgeTable(
        "x", "u", "i", edec, src=a["src"][rows], dst=a["dst"][rows],
        num_src_nodes=12, num_dst_nodes=12, timestamps=a["ts"][rows],
        float_attrs=a["edge_feats"][rows]))
    g.add_reverse_edge_table("x")
    fwd, rev = g.store.edge_table("x"), g.store.edge_table("x_reverse")
    assert (rev.src_type, rev.dst_type) == ("i", "u")
    np.testing.assert_array_equal(rev.src, fwd.dst)
    np.testing.assert_array_equal(rev.dst, fwd.src)
    np.testing.assert_array_equal(rev.timestamps, fwd.timestamps)
    np.testing.assert_array_equal(rev.float_attrs, fwd.float_attrs)
    assert rev.ts_base == fwd.ts_base
    g2, _ = torch_temporal_graph(a)
    with pytest.raises(InvalidArgumentError, match="within one node type"):
        g2.add_reverse_edge_table("rel")


def test_edge_payload_carries_timestamps_and_deferred_features():
    a = temporal_arrays(seed=6)
    _, _, jdev, tdev = _tables(a)
    eids = np.array([[3, -1, 7], [0, 11, -1]], np.int32)
    from graph_learn_tpu.ops.lookup import edge_payload as jax_payload
    from graph_learn_tpu_torch.ops.lookup import edge_payload
    want = jax_payload(jdev, jnp.asarray(eids))
    got = edge_payload(tdev, torch.from_numpy(eids))
    for f in ("weights", "timestamps"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    np.testing.assert_array_equal(got["float_attrs"].materialize().numpy(),
                                  np.asarray(want["float_attrs"]))


# --- the samplers on JAX's draws -------------------------------------------

def _seeds_and_bounds(a, seed, b=B):
    rng = np.random.default_rng(seed)
    n = a["feats"].shape[0]
    seeds = rng.integers(0, n, b).astype(np.int32)
    seeds[:2] = [n - 1, n - 2]  # zero-degree rows
    bound = rng.integers(-5, 420, b).astype(np.int32)
    bound[2] = 0  # before every edge
    # exclude a neighbour of the prefix where there is one
    excl = np.zeros(b, np.int32)
    for i, s in enumerate(seeds):
        row = a["dst"][(a["src"] == s)
                       & (a["ts"] - a["ts"].min() < bound[i])]
        excl[i] = row[rng.integers(0, row.size)] if row.size else 1
    return seeds, bound, excl


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("strategy", ["random", "edge_weight", "in_degree",
                                      "random_without_replacement", "topk",
                                      "full"])
def test_each_temporal_strategy_is_exact_on_jax_draws(strategy, filtered):
    a = temporal_arrays(seed=7)
    _, _, jdev, tdev = _tables(a)
    seeds, bound, excl = _seeds_and_bounds(a, 11)
    js, jt = jnp.asarray(seeds), jnp.asarray(bound)
    ts_, tt_ = torch.from_numpy(seeds), torch.from_numpy(bound)
    jflt = tflt = None
    if filtered:
        from graph_learn_tpu.ops.sampling import SampleFilter as JFlt
        jflt = JFlt(exclude_dst=jnp.asarray(excl))
        tflt = sampling.SampleFilter(exclude_dst=torch.from_numpy(excl))
    key, k = jax.random.key(3), 7
    jc, tc = jdev.out, tdev.out
    if strategy == "random":
        want = jtemporal.temporal_uniform_sample(jc, js, k, key, jt,
                                                 flt=jflt)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B, k))))
        got = temporal.temporal_uniform_draw(tc, ts_, u, tt_, flt=tflt)
    elif strategy in ("edge_weight", "in_degree"):
        want = jtemporal.temporal_weighted_sample(jc, js, k, key, jt,
                                                  by=strategy, flt=jflt)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B, k))))
        got = temporal.temporal_weighted_draw(tc, ts_, u, tt_, strategy,
                                              flt=tflt)
    elif strategy == "random_without_replacement":
        want = jtemporal.temporal_without_replacement_sample(
            jc, js, k, key, jt, flt=jflt)
        r = np.stack([np.array(jax.random.uniform(kj, (B,)))
                      for kj in jax.random.split(key, k)])
        got = temporal.temporal_wor_draw(tc, ts_, torch.from_numpy(r), tt_,
                                         flt=tflt)
    elif strategy == "topk":
        want = jtemporal.temporal_topk_sample(jc, js, k, jt, flt=jflt)
        got = temporal.temporal_topk_sample(tc, ts_, k, tt_, flt=tflt)
    else:
        want = jtemporal.temporal_full_sample(jc, js, k, jt, flt=jflt)
        got = temporal.temporal_full_sample(tc, ts_, k, tt_, flt=tflt)
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    # every sampled edge is strictly earlier than its seed's bound
    eids = got[1].numpy()
    ts = tdev.timestamps.numpy()
    assert np.all(ts[eids[eids >= 0]] < np.broadcast_to(
        bound[:, None], eids.shape)[eids >= 0])


@pytest.mark.parametrize("fill", [0, 77])
@pytest.mark.parametrize("strategy", ["random", "edge_weight", "in_degree",
                                      "random_without_replacement", "topk",
                                      "full"])
def test_zero_admissible_edges_give_the_default_id_and_minus_one(strategy,
                                                                  fill):
    a = temporal_arrays(seed=8)
    _, _, _, tdev = _tables(a)
    n = a["feats"].shape[0]
    seeds = torch.tensor([0, 1, 2, n - 1], dtype=torch.int32)
    bound = torch.tensor([0, -3, 0, 1000], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    args = {"random": (temporal.temporal_uniform_sample, (gen,)),
            "edge_weight": (temporal.temporal_weighted_sample, (gen,)),
            "in_degree": (temporal.temporal_weighted_sample, (gen,)),
            "random_without_replacement": (
                temporal.temporal_without_replacement_sample, (gen,)),
            "topk": (temporal.temporal_topk_sample, ()),
            "full": (temporal.temporal_full_sample, ())}[strategy]
    kw = {"by": strategy} if strategy == "in_degree" else {}
    with both_confs(default_neighbor_id=fill):
        out = args[0](tdev.out, seeds, 5, *args[1], bound, **kw)
    assert (out[0] == fill).all() and (out[1] == -1).all()
    if strategy == "full":
        assert (out[2] == 0).all()
    start, hi, deg = temporal.cutoffs(tdev.out, seeds, bound)
    assert (deg == 0).all() and (hi == start).all()


def test_a_table_without_timestamps_is_refused():
    a = temporal_arrays(seed=9)
    from torch_parity import torch_graph
    csr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    assert csr.nbr_ts is None
    with pytest.raises(ValueError, match="not timestamped"):
        temporal.cutoffs(csr, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))


def _weighted_row_table(weights_of, n=6, deg=8):
    """node i -> (i+j) % n at ts 10 i + j, weight ``weights_of(i, j)``."""
    src = np.repeat(np.arange(n), deg)
    j = np.tile(np.arange(deg), n)
    dst = (src + j) % n
    dst[::2] = 0  # node 0 a popular dst (in_degree differs by slot)
    return tstore.EdgeTable(
        "e", "v", "v", Decoder(weighted=True, timestamped=True), src=src,
        dst=dst, num_src_nodes=n, num_dst_nodes=n,
        weights=np.array([weights_of(i, jj) for i, jj in zip(src, j)],
                         np.float32), timestamps=10 * src + j)


@pytest.mark.parametrize("by", ["edge_weight", "in_degree"])
def test_weighted_draws_follow_the_prefix_oracle(by):
    """The port's own generator: draws over the before-t prefix in
    proportion to w_j / W_prefix, by a chi-square test at 1e-3."""
    et = _weighted_row_table(lambda i, j: float(j + 1))
    csr = et.device("cpu").out
    seed, cut, b = 2, 5, 4000
    seeds = torch.full((b,), seed, dtype=torch.int32)
    t = torch.full((b,), 10 * seed + cut - et.ts_base, dtype=torch.int32)
    ids, eids = temporal.temporal_weighted_sample(
        csr, seeds, 2, torch.Generator().manual_seed(0), t, by=by)
    eids = eids.numpy().ravel()
    assert np.all(eids >= 0)
    j_of = et.timestamps[eids] + et.ts_base - 10 * seed
    assert np.all(j_of < cut)
    if by == "edge_weight":
        w = np.arange(1, cut + 1, dtype=np.float64)
    else:
        indeg = np.bincount(et.dst, minlength=6).astype(np.float64)
        w = indeg[et.dst[seed * 8:seed * 8 + cut]]
    counts = np.bincount(j_of, minlength=cut)
    assert stats.chisquare(counts, w / w.sum() * counts.sum()).pvalue > 1e-3


def test_without_replacement_is_distinct_and_a_short_prefix_returns_all():
    et = _weighted_row_table(lambda i, j: 1.0)
    csr = et.device("cpu").out
    gen = torch.Generator().manual_seed(1)
    seeds = torch.full((500,), 1, dtype=torch.int32)
    t = torch.full((500,), 16 - et.ts_base, dtype=torch.int32)  # 6 edges
    _, eids = temporal.temporal_without_replacement_sample(csr, seeds, 3,
                                                           gen, t)
    assert all(len(set(r)) == 3 for r in eids.tolist())
    j_of = et.timestamps[eids.numpy()] + et.ts_base - 10
    assert np.all(j_of < 6)
    counts = np.bincount(j_of.ravel(), minlength=6)
    assert stats.chisquare(counts).pvalue > 1e-3
    t2 = torch.full((8,), 42 - et.ts_base, dtype=torch.int32)  # 2 edges
    _, eids = temporal.temporal_without_replacement_sample(
        csr, torch.full((8,), 4, dtype=torch.int32), 4, gen, t2)
    got = et.timestamps[eids.numpy()] + et.ts_base - 40
    assert set(got.ravel().tolist()) == {0, 1}


def test_topk_takes_the_most_recent_first():
    et = _weighted_row_table(lambda i, j: 1.0)
    csr = et.device("cpu").out
    ids, eids = temporal.temporal_topk_sample(
        csr, torch.tensor([5], dtype=torch.int32), 2,
        torch.tensor([54 - et.ts_base], dtype=torch.int32))
    got = et.timestamps[eids.numpy()[0]] + et.ts_base
    np.testing.assert_array_equal(got, [53, 52])
    _, _, deg = temporal.temporal_full_sample(
        csr, torch.tensor([5], dtype=torch.int32), 10,
        torch.tensor([53 - et.ts_base], dtype=torch.int32))
    assert int(deg[0]) == 3  # ts 50, 51, 52


# --- the GSL --------------------------------------------------------------

@pytest.fixture
def u2i_temporal():
    """A small timestamped bipartite event graph in both packages: users
    "u" and items "i", undirected ``inter`` (with ``inter_reverse``) and a
    later event table ``ev``, as tests/test_temporal.py writes it."""
    from graph_learn_tpu.graph import Graph as JGraph
    from graph_learn_tpu_torch.core.store import NodeTable
    from graph_learn_tpu_torch.graph import Graph
    uf = np.array([[i + k for k in range(3)] for i in range(8)], np.float32)
    itf = np.array([[i * 2 + k for k in range(3)] for i in range(6)],
                   np.float32)
    isrc = np.repeat(np.arange(8), 3)
    idst = (isrc + np.tile(np.arange(3), 8)) % 6
    its = 5000 + 10 * isrc + np.tile(np.arange(3), 8)
    ifeat = np.full((24, 2), 0.5, np.float32)
    esrc, edst = np.arange(8), np.arange(8) % 6
    ets, efeat = 6000 + np.arange(8), np.ones((8, 2), np.float32)
    out = []
    for mod, G in ((jstore, JGraph), (tstore, Graph)):
        Dec = jschema.Decoder if mod is jstore else Decoder
        edec = Dec(attr_types=["float"] * 2, timestamped=True)
        g = G() if G is JGraph else G(device="cpu")
        nodes = [mod.NodeTable("u", Dec(attr_types=["float"] * 3),
                               np.arange(8), float_attrs=uf),
                 mod.NodeTable("i", Dec(attr_types=["float"] * 3),
                               np.arange(6), float_attrs=itf)]
        edges = [mod.EdgeTable("inter", "u", "i", edec, src=isrc, dst=idst,
                               num_src_nodes=8, num_dst_nodes=6,
                               timestamps=its, float_attrs=ifeat),
                 mod.EdgeTable("inter_reverse", "i", "u", edec, src=idst,
                               dst=isrc, num_src_nodes=6, num_dst_nodes=8,
                               timestamps=its, float_attrs=ifeat),
                 mod.EdgeTable("ev", "u", "i", edec, src=esrc, dst=edst,
                               num_src_nodes=8, num_dst_nodes=6,
                               timestamps=ets, float_attrs=efeat)]
        if G is JGraph:
            for t in nodes:
                g.store.add_node_table(t)
                g._node_decoders[t.type_name] = t.decoder
            for t in edges:
                g.store.add_edge_table(t)
            jstore.unify_ts_bases(g.store)
            g._initialized = True
        else:
            for t in nodes:
                g.add_node_table(t)
            g.add_edge_table(edges[0]).add_reverse_edge_table("inter")
            g.add_edge_table(edges[2])
            rev = g.store.edge_table("inter_reverse")
            np.testing.assert_array_equal(rev.src, idst)
        out.append(g)
    return out


def _both(gs, build, seeds, monkeypatch=None):
    """The query ``build(g)`` of both packages on the same seeds."""
    jg, tg = gs
    jq, tq = build(jg), build(tg)
    jout = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds),
                       jax.random.key(0))
    tout = tcompile._execute(tq, tq.device_tables("cpu"),
                             torch.from_numpy(seeds),
                             torch.Generator().manual_seed(0))
    return jout, tout


def test_edge_hops_thread_the_event_time_and_match_jax(u2i_temporal):
    """``E(ev).outV().outE(inter).topk.inV().outE(inter_reverse).topk``:
    the same ids, edge ids and timestamps as the JAX plan (topk is
    deterministic), the endpoint view equal to the edges' dst, and every
    edge strictly earlier than the event (hop 1) or its parent edge (hop
    2)."""
    def build(g):
        e1 = (g.E("ev").batch(8).alias("event").outV().alias("src")
              .outE("inter").sample(2).by("topk").alias("e1"))
        n1 = e1.inV().alias("n1")
        n1.outE("inter_reverse").sample(2).by("topk").alias("e2")
        return e1.values()
    seeds = np.arange(8, dtype=np.int32)
    jout, tout = _both(u2i_temporal, build, seeds)
    for alias in ("e1", "e2"):
        for f in ("edge_ids", "timestamps", "weights"):
            jv, tv = getattr(jout[alias], f), getattr(tout[alias], f)
            if jv is None:
                assert tv is None
                continue
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tout[alias].dst_ids.numpy(),
                                      np.asarray(jout[alias].dst_ids))
        np.testing.assert_array_equal(
            tout[alias].float_attrs.materialize().numpy(),
            np.asarray(jout[alias].float_attrs))
    np.testing.assert_array_equal(tout["n1"].ids.numpy(),
                                  tout["e1"].dst_ids.numpy())
    ev = tout["event"].timestamps.numpy()
    e1, e2 = tout["e1"], tout["e2"]
    m1 = e1.edge_ids.numpy() >= 0
    assert m1.any()
    assert np.all(e1.timestamps.numpy()[m1]
                  < np.broadcast_to(ev[:, None], m1.shape)[m1])
    m2 = e2.edge_ids.numpy() >= 0
    assert np.all(e2.timestamps.numpy()[m2] < np.broadcast_to(
        e1.timestamps.numpy()[..., None], m2.shape)[m2])


@pytest.mark.parametrize("strategy", ["random", "edge_weight",
                                      "random_without_replacement", "full"])
def test_vertex_hops_are_bounded_by_the_propagated_time(u2i_temporal,
                                                        strategy):
    tg = u2i_temporal[1]
    with both_confs(default_neighbor_id=0):
        q = (tg.E("ev").batch(8).alias("event").outV().alias("src")
             .outE("inter").sample(3).by(strategy).alias("e1").values())
        if strategy == "edge_weight":
            with pytest.raises(ValueError, match="CDF"):
                tcompile._execute(q, q.device_tables("cpu"),
                                  torch.arange(8, dtype=torch.int32),
                                  torch.Generator().manual_seed(0))
            return
        out = tcompile._execute(q, q.device_tables("cpu"),
                                torch.arange(8, dtype=torch.int32),
                                torch.Generator().manual_seed(0))
    ev = out["event"].timestamps.numpy()
    et = tg.store.edge_table("inter")
    if strategy == "full":
        ids, deg = out["e1"].ids.numpy(), out["e1"].degrees.numpy()
        src = out["src"].ids.numpy()
        for i in range(8):
            admissible = et.dst[(et.src == src[i])
                                & (et.timestamps < ev[i])]
            assert deg[i] == min(3, admissible.size)
            assert set(ids[i, :deg[i]]) <= set(admissible.tolist())
        return
    eids = out["e1"].edge_ids.numpy()
    m = eids >= 0
    assert m.any()
    assert np.all(et.timestamps[eids[m]]
                  < np.broadcast_to(ev[:, None], m.shape)[m])


def test_a_negative_tower_inherits_the_event_time(u2i_temporal):
    tg = u2i_temporal[1]
    q = (tg.E("ev").batch(8).alias("event").outV().alias("src")
         .outNeg("inter").sample(1).by("random").alias("neg")
         .outE("inter_reverse").sample(2).by("topk").alias("nege")
         .values())
    out = tcompile._execute(q, q.device_tables("cpu"),
                            torch.arange(8, dtype=torch.int32),
                            torch.Generator().manual_seed(0))
    ev = out["event"].timestamps.numpy()
    nege = out["nege"].timestamps.numpy()  # [b, 1, 2]
    m = out["nege"].edge_ids.numpy() >= 0
    assert m.any()
    bound = np.broadcast_to(ev[:, None, None], nege.shape)
    assert np.all(nege[m] < bound[m])


def test_a_registered_strategy_must_take_t_upper_on_a_temporal_path(
        u2i_temporal, monkeypatch):
    tg = u2i_temporal[1]

    def no_t(csr, seeds, k, generator):
        raise AssertionError("called on a temporal path")

    def with_t(csr, seeds, k, generator, t_upper=None):
        return temporal.temporal_topk_sample(csr, seeds, k, t_upper)

    monkeypatch.setitem(sampling.STRATEGY_FNS, "no_t", no_t)
    monkeypatch.setitem(sampling.STRATEGY_FNS, "with_t", with_t)

    def run(name):
        q = (tg.E("ev").batch(4).alias("event").outV().alias("src")
             .outE("inter").sample(2).by(name).alias("e1").values())
        return tcompile._execute(q, q.device_tables("cpu"),
                                 torch.arange(4, dtype=torch.int32),
                                 torch.Generator())
    with pytest.raises(InvalidArgumentError, match="t_upper"):
        run("no_t")
    out = run("with_t")
    assert out["e1"].edge_ids.shape == (4, 2)


def test_temporal_graph_spans_equal_jax(u2i_temporal):
    def build(g):
        ev = g.E("ev").batch(8).alias("event")
        e1 = (ev.outV().alias("src").outE("inter").sample(2).by("topk")
              .alias("src_nbr_1"))
        (e1.inV().alias("src_nbr_node_1").outE("inter_reverse").sample(2)
         .by("topk").alias("src_nbr_2").inV().alias("src_nbr_node_2"))
        return ev.values()
    seeds = np.arange(8, dtype=np.int32)
    jout, tout = _both(u2i_temporal, build, seeds)
    args = ("src", ["src_nbr_1", "src_nbr_2"],
            ["src_nbr_node_1", "src_nbr_node_2"], "event")
    jtg = jdata.TemporalGraph.from_query_result(jout, *args)
    ttg = TemporalGraph.from_query_result(tout, *args)
    assert ttg.nbr_nums == jtg.nbr_nums == (2, 2)
    np.testing.assert_array_equal(ttg.src_t.numpy(), np.asarray(jtg.src_t))
    for got, want in zip(ttg.nbr_t, jtg.nbr_t):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(ttg.nbr_nodes, jtg.nbr_nodes):
        np.testing.assert_array_equal(got.float_attrs.numpy(),
                                      np.asarray(want.float_attrs))
    eids = tout["src_nbr_1"].edge_ids.numpy()
    assert np.all(ttg.nbr_t[0].numpy()[eids >= 0] > 0)
    with pytest.raises(ValueError, match="timestamped event root"):
        TemporalGraph.from_query_result(
            {**tout, "event": tout["event"].replace(timestamps=None)}, *args)


# --- the temporal family ---------------------------------------------------

SMALL = dict(tbench.CFG_SMALL, n_nodes=500, avg_degree=8, feat_dim=8,
             hidden=16, classes=5, batch=16, steps=2, scan_steps=1)
NBRS = (4, 2)


def _jax_family_store(g):
    """The JAX package's Graph over the port family store's arrays."""
    nt, et = g.store.node_table("item"), g.store.edge_table("rel")
    n, d = nt.float_attrs.shape
    dec = jschema.Decoder(labeled=True, attr_types=["float"] * d)
    from graph_learn_tpu.graph import Graph as JGraph
    jg = JGraph()
    jg.store.add_node_table(jstore.NodeTable(
        "item", dec, np.arange(n, dtype=np.int64),
        float_attrs=nt.float_attrs, labels=nt.labels))
    jg.store.add_edge_table(jstore.EdgeTable(
        "rel", "item", "item", jschema.Decoder(weighted=True,
                                               timestamped=True),
        src=et.src, dst=et.dst, num_src_nodes=n, num_dst_nodes=n,
        weights=et.weights, timestamps=et.timestamps + et.ts_base))
    jg._node_decoders["item"] = dec
    jg._initialized = True
    return jg, dec


def test_the_family_store_draws_the_jax_numbers():
    """``build_temporal_graph``: run_temporal's numpy draws
    (np.random.default_rng(2): features, labels, src, dst, weights,
    timestamps)."""
    cfg = dict(n_nodes=300, avg_degree=5, feat_dim=6, classes=7)
    g, dec = fs.build_temporal_graph(cfg, "cpu")
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((300, 6), np.float32)
    labels = rng.integers(0, 7, 300).astype(np.int32)
    src, dst = rng.integers(0, 300, 1500), rng.integers(0, 300, 1500)
    w = rng.random(1500).astype(np.float32)
    ts = rng.integers(0, 1_000_000, 1500)
    nt, et = g.store.node_table("item"), g.store.edge_table("rel")
    np.testing.assert_array_equal(nt.float_attrs, feats)
    np.testing.assert_array_equal(nt.labels, labels)
    for got, want in ((et.src, src), (et.dst, dst), (et.weights, w),
                      (et.timestamps + et.ts_base, ts)):
        np.testing.assert_array_equal(got, want)
    assert dec.labeled and et.decoder.timestamped and et.decoder.weighted


def test_the_slice_matches_jax_loss_and_one_adam_step(monkeypatch):
    """One ``TemporalSteps`` step against the JAX family's step
    (``run_temporal:335-352``) on the same batch: the port's plan samples
    with the uniform numbers the JAX plan drew for each hop (its own
    temporal draw, bounds and time threading), gives JAX's ids, and the
    loss and the parameters after one Adam step of 1e-3 equal flax +
    optax's."""
    with both_confs(storage_profile="full"):
        g, dec = fs.build_temporal_graph(SMALL, "cpu")
        jg, jdec = _jax_family_store(g)
        b = SMALL["batch"]
        jq, tq = fs.temporal_query(jg, b, NBRS), fs.temporal_query(g, b, NBRS)
        jtables, ttables = jq.device_tables(), tq.device_tables("cpu")
    seeds = np.random.default_rng(0).integers(
        0, g.store.edge_table("rel").num_edges, b).astype(np.int32)
    key = jax.random.key(7)
    jb = jax_execute(jq, jtables, jnp.asarray(seeds), key)
    # the uniform numbers of each hop, as _execute splits its key
    keys = jax.random.split(key, len(jq.dag.nodes))
    us = iter([np.array(jax.random.uniform(
        keys[jq.dag.get_node(a).nid % len(keys)], shape))
        for a, shape in (("h1", (b, NBRS[0])),
                         ("h2", (b * NBRS[0], NBRS[1])))])

    def sampler(csr, seeds_, k, generator, t_upper, by="edge_weight",
                flt=None):
        return temporal.temporal_weighted_draw(
            csr, seeds_, torch.from_numpy(next(us)), t_upper, by, flt)

    monkeypatch.setattr(temporal, "temporal_weighted_sample", sampler)
    tb = tcompile._execute(tq, ttables, torch.from_numpy(seeds),
                           torch.Generator())
    for a in ("src", "h1", "h2"):
        np.testing.assert_array_equal(tb[a].ids.numpy(), np.asarray(jb[a].ids))
    np.testing.assert_array_equal(tb["ev"].timestamps.numpy(),
                                  np.asarray(jb["ev"].timestamps))

    dims = [SMALL["feat_dim"], SMALL["hidden"], SMALL["classes"]]
    jmodel = JaxSAGE(dims, jdec, agg_type="gcn")
    ego = jdata.EgoGraph.from_query_result(jb, "src", ["h1", "h2"])
    params = jmodel.init(jax.random.key(0), ego)

    def lf(p):
        logits = jmodel.apply(p, ego, training=True)
        return jax_sup_loss(logits, jb["src"].labels)

    jloss, jgrads = jax.value_and_grad(lf)(params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    new = optax.apply_updates(params, upd)

    model = EgoGraphSAGE(dims, dec, agg_type="gcn", device="cpu")
    load_flax_params(model, _np(params))
    monkeypatch.setattr(tbench, "sample_one",
                        lambda q_, t_, n, gen: (torch.from_numpy(seeds), tb))
    step = fs.TemporalSteps(tq, ttables, model,
                            tbench.make_optimizer(model, torch.device("cpu")),
                            SMALL, torch.Generator().manual_seed(0), False)
    loss = step()
    # the step's own tolerances (tests/test_torch_bench.py): 1e-5 on the
    # loss, one Adam step of 1e-3 within 2e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-6)
    assert_trees_close(to_flax_params(model), _np(new), rtol=1e-4, atol=2e-5)


def test_k_steps_a_call_count_their_edges_and_their_launches(monkeypatch):
    """``run_temporal`` on the CPU: finite losses, the edge count, 2
    gathers and 1 group mean a step, seeds among the edge ids."""
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
    with both_confs(storage_profile="full"):
        r = fs.run_temporal(cfg, small=True, device="cpu")
    assert r["capture"] is False and r["capture_s"] is None
    assert r["edges_per_step"] == 32 * (4 + 4 * 2)
    n_steps = (1 + r["rounds"]) * 2
    assert len(r["losses"]) == n_steps and np.isfinite(r["losses"]).all()
    assert r["csr_build_s"] > 0 and r["tables_bytes"] > 0
    # the first batch's loss, then every step
    assert calls == {"gather": 2 * (n_steps + 1), "spmm": n_steps + 1}
    n_e = r["graph"][0].store.edge_table("rel").num_edges
    assert all(s.dtype == torch.int32 and int(s.max()) < n_e
               for s in r["step"].seeds)


def test_family_scale_temporal_small_runs_eagerly_and_prints_its_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fs.main(["--small", "--cpu", "--families", "temporal"]) == 0
    assert re.fullmatch(r"temporal +[0-9.]+M edges/s  [0-9.]+ ms/step  "
                        r"\(warm [0-9.]+s\)\n", out.getvalue())


@pytest.mark.parametrize("strategy", ["topk", "full", "edge_weight",
                                      "random_without_replacement"])
def test_hub_rows_are_filtered_where_the_jax_package_refuses(strategy):
    """The deliberate difference of the filters carries over to the
    temporal samplers: the JAX package refuses an ``exclude_dst`` filter on
    a CSR whose largest row exceeds 256 (``_filter_guard``); the port scans
    the prefix, whatever its length, and drops the excluded id."""
    a = temporal_arrays(n=40, seed=12)
    hub = 300
    a["src"] = np.concatenate([a["src"], np.zeros(hub, np.int64)])
    a["dst"] = np.concatenate([a["dst"], np.arange(hub) % 30 + 1])
    a["weights"] = np.concatenate([a["weights"], np.ones(hub, np.float32)])
    a["ts"] = np.concatenate([a["ts"], a["ts"].min() + np.arange(hub)])
    a["edge_feats"] = np.concatenate(
        [a["edge_feats"], np.zeros((hub, 3), np.float32)])
    _, _, jdev, tdev = _tables(a)
    assert tdev.out.max_degree > 256
    seeds = np.array([0, 0, 3], np.int32)
    bound = np.array([400, 150, 400], np.int32)
    excl = np.array([5, 7, 1], np.int32)
    from graph_learn_tpu.ops.sampling import SampleFilter as JFlt
    with pytest.raises(ValueError, match="max_degree <= 256"):
        jtemporal.temporal_topk_sample(jdev.out, jnp.asarray(seeds), 4,
                                       jnp.asarray(bound),
                                       flt=JFlt(exclude_dst=jnp.asarray(excl)))
    flt = sampling.SampleFilter(exclude_dst=torch.from_numpy(excl))
    ts_, tt_ = torch.from_numpy(seeds), torch.from_numpy(bound)
    gen = torch.Generator().manual_seed(0)
    k = 200
    if strategy == "topk":
        ids, eids = temporal.temporal_topk_sample(tdev.out, ts_, k, tt_, flt)
    elif strategy == "full":
        ids, eids, _ = temporal.temporal_full_sample(tdev.out, ts_, k, tt_,
                                                     flt)
    elif strategy == "edge_weight":
        ids, eids = temporal.temporal_weighted_sample(tdev.out, ts_, k, gen,
                                                      tt_, flt=flt)
    else:
        ids, eids = temporal.temporal_without_replacement_sample(
            tdev.out, ts_, k, gen, tt_, flt=flt)
    ids, eids = ids.numpy(), eids.numpy()
    ts = tdev.timestamps.numpy()
    for i in range(3):
        row = (a["src"] == seeds[i]) & (ts < bound[i])
        valid = eids[i] >= 0
        assert valid.any()
        assert np.all(ts[eids[i][valid]] < bound[i])
        # the prefix lists the excluded id more than once only by chance:
        # the slot removed is its last occurrence
        if (a["dst"][row] == excl[i]).sum() == 1:
            assert excl[i] not in ids[i][valid]
