"""The port's random walks (ops/walk.py, the GSL ``random_walk``, the walks
family and the node2vec example) against the JAX package's.

Torch cannot reproduce JAX's random bits, so the walks are held exactly
through the ``*_draw`` functions fed the uniform numbers that JAX itself
draws, in its key schedule: ``deepwalk`` splits its key into
``max(walk_len - 1, 1)`` keys and draws one ``uniform(k, [b])`` a step;
``node2vec_walk`` takes its first step uniformly on ``keys[0]`` and splits
each later key into a candidate key (``uniform([b, 8])``) and an
acceptance key (the same shape).  The port's own draws are held to the
invariants and the step shares of ``chip_smoke.py`` (on the host, from the
edge arrays)."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.core.store import EdgeTable as JaxEdgeTable
from graph_learn_tpu.core.store import NodeTable as JaxNodeTable
from graph_learn_tpu.graph import Graph as JaxGraph
from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu.ops import walk as jax_walk
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.examples import family_scale as fs
from graph_learn_tpu_torch.examples import node2vec as n2v
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.ops import segment, walk
from graph_learn_tpu_torch.errors import OutOfRangeError
from torch_parity import both_confs, jax_graph, numpy_graph, torch_graph

REPO = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_walks",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _csrs(seed, n=200, avg_degree=4, isolated=20, minimal=False):
    """The same graph's out-CSR in both packages; with ``minimal`` the
    port's has no id-sorted copy (membership by scan)."""
    a = numpy_graph(n=n, avg_degree=avg_degree, isolated=isolated,
                    seed=seed)
    jc = jax_graph(a)[0].store.edge_table("rel").device().out
    tc = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    if minimal:
        tc = tc.replace(nbr_ids_sorted=None, nbr_edge_ids_sorted=None)
    return a, jc, tc


def _seeds(seed, n, b=64):
    s = np.random.default_rng(seed).integers(0, n, b).astype(np.int32)
    s[:2] = [n - 1, 0]  # the first isolated, and a live node
    return s


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_deepwalk_draws(key, walk_len, b):
    """The [walk_len - 1, b] uniform numbers ``deepwalk`` draws."""
    keys = jax.random.split(key, max(walk_len - 1, 1))
    return np.array([np.asarray(jax.random.uniform(k, (b,)))
                     for k in keys[:walk_len - 1]],
                    np.float32).reshape(-1, b)


def jax_node2vec_draws(key, walk_len, b, tries=walk.NUM_TRIES):
    """(first, candidates, acceptances): the uniform numbers
    ``node2vec_walk`` draws, [b] and [walk_len - 2, b, tries] twice."""
    keys = jax.random.split(key, max(walk_len - 1, 1))
    first = np.asarray(jax.random.uniform(keys[0], (b,)))
    cand, acc = [], []
    for k in keys[1:walk_len - 1]:
        k1, k2 = jax.random.split(k)
        cand.append(np.asarray(jax.random.uniform(k1, (b, tries))))
        acc.append(np.asarray(jax.random.uniform(k2, (b, tries))))
    shape = (max(walk_len - 2, 0), b, tries)
    return (first, np.array(cand, np.float32).reshape(shape),
            np.array(acc, np.float32).reshape(shape))


@pytest.mark.parametrize("walk_len", [1, 2, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_deepwalk_equals_jax_on_its_draws(seed, walk_len):
    a, jc, tc = _csrs(seed)
    seeds = _seeds(seed, 200)
    key = jax.random.key(seed + 3)
    want = np.asarray(jax_walk.deepwalk(jc, jnp.asarray(seeds), walk_len,
                                        key))
    got = walk.deepwalk_draw(tc, _t(seeds),
                             _t(jax_deepwalk_draws(key, walk_len, 64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (64, walk_len)
    if walk_len > 1:
        assert (want == -1).any()  # walkers stuck at the isolated nodes


@pytest.mark.parametrize("minimal", [False, True])
@pytest.mark.parametrize("walk_len", [2, 3, 9])
@pytest.mark.parametrize("pq", [(0.5, 2.0), (0.3, 0.7), (4.0, 0.25)])
def test_node2vec_equals_jax_on_its_draws(pq, walk_len, minimal):
    """Every accepted or fallen-back candidate the same, on both membership
    routes of the port (bisection of the id-sorted copy, scan of the row);
    p = 0.3 gives 1/p, a weight that float32 rounds."""
    p, q = pq
    a, jc, tc = _csrs(walk_len, avg_degree=6, minimal=minimal)
    seeds = _seeds(walk_len, 200)
    key = jax.random.key(walk_len + 11)
    want = np.asarray(jax_walk.node2vec_walk(jc, jnp.asarray(seeds),
                                             walk_len, key, p=p, q=q))
    first, cand, acc = jax_node2vec_draws(key, walk_len, 64)
    got = walk.node2vec_draw(tc, _t(seeds), _t(first), _t(cand), _t(acc),
                             p, q)
    np.testing.assert_array_equal(got.numpy(), want)


def test_node2vec_with_p_q_one_is_deepwalk_and_length_one_is_the_seeds():
    a, jc, tc = _csrs(5)
    seeds = _seeds(5, 200)
    key = jax.random.key(8)
    want = np.asarray(jax_walk.node2vec_walk(jc, jnp.asarray(seeds), 6, key))
    got = walk.deepwalk_draw(tc, _t(seeds), _t(jax_deepwalk_draws(key, 6,
                                                                  64)))
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(4)
    one = walk.node2vec_walk(tc, _t(seeds), 6, gen)
    gen.manual_seed(4)
    np.testing.assert_array_equal(one.numpy(),
                                  walk.deepwalk(tc, _t(seeds), 6, gen))
    for fn in (walk.deepwalk, walk.node2vec_walk):
        got = fn(tc, _t(seeds), 1, gen)
        np.testing.assert_array_equal(got.numpy(), seeds[:, None])
    np.testing.assert_array_equal(
        walk.node2vec_walk(tc, _t(seeds), 1, gen, p=0.5, q=2.0).numpy(),
        np.asarray(jax_walk.node2vec_walk(jc, jnp.asarray(seeds), 1, key,
                                          p=0.5, q=2.0)))


def _chain():
    """0 -> 1 -> 2, node 2 a dead end (tests/test_edge_cases.py:69)."""
    src, dst = np.array([0, 1]), np.array([1, 2])
    dec = JaxDecoder(weighted=True)
    jg = JaxGraph()
    jg.store.add_node_table(JaxNodeTable("v", JaxDecoder(), np.arange(3)))
    jg.store.add_edge_table(JaxEdgeTable("e", "v", "v", dec, src=src,
                                         dst=dst, num_src_nodes=3,
                                         num_dst_nodes=3,
                                         weights=np.ones(2, np.float32)))
    jg._initialized = True
    tg = Graph(device="cpu")
    tg.add_node_table(NodeTable("v", Decoder(), np.arange(3)))
    tg.add_edge_table(EdgeTable("e", "v", "v", Decoder(weighted=True),
                                src=src, dst=dst, num_src_nodes=3,
                                num_dst_nodes=3,
                                weights=np.ones(2, np.float32)))
    return jg, tg


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 2.0)])
def test_walks_on_a_dead_end_chain(pq):
    """Every walker reaches the dead end and emits -1 from then on, as in
    the JAX package (both walks are forced: each row has one edge)."""
    jg, tg = _chain()
    p, q = pq
    seeds = np.array([0, 1, 2], np.int32)
    key = jax.random.key(0)
    want = np.asarray(jax_walk.node2vec_walk(
        jg.store.edge_table("e").device().out, jnp.asarray(seeds), 5, key,
        p=p, q=q))
    got = walk.node2vec_walk(tg.store.edge_table("e").device("cpu").out,
                             _t(seeds), 5, torch.Generator().manual_seed(0),
                             p=p, q=q)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[0, 1, 2, -1, -1], [1, 2, -1, -1, -1],
                                         [2, -1, -1, -1, -1]])


@pytest.mark.parametrize("window", [1, 2, 5])
def test_skipgram_pairs_equal_jax(window):
    rng = np.random.default_rng(window)
    walks = rng.integers(-1, 30, (6, 7)).astype(np.int32)
    want = jax_walk.skipgram_pairs(jnp.asarray(walks), window)
    got = walk.skipgram_pairs(_t(walks), window)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def _hub_csr(minimal):
    """Node 0 with 300 out-neighbours (some repeated), the rest a few."""
    rng = np.random.default_rng(4)
    n = 400
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(1, n, 800)])
    dst = np.concatenate([rng.integers(0, n, 300), rng.integers(0, n, 800)])
    g = Graph(device="cpu")
    g.add_node_table(NodeTable("v", Decoder(), np.arange(n)))
    g.add_edge_table(EdgeTable("e", "v", "v", Decoder(), src=src, dst=dst,
                               num_src_nodes=n, num_dst_nodes=n))
    with both_confs(storage_profile="minimal" if minimal else "full"):
        return g.store.edge_table("e").device("cpu").out, src, dst


def test_row_member_scans_rows_of_any_degree_without_the_sorted_copy():
    """The scan route (the "minimal" profile) answers as the bisection
    does and as a set lookup, on a hub row of degree 300, where the JAX
    package's window refuses (more than 256) and needs the sorted copy."""
    full, src, dst = _hub_csr(False)
    minimal, _, _ = _hub_csr(True)
    assert minimal.nbr_ids_sorted is None and minimal.max_degree == 300
    assert minimal.max_degree > segment.SCAN_CHUNK
    rng = np.random.default_rng(5)
    rows = np.concatenate([[0, 0, 0], rng.integers(0, 400, 61)])
    queries = rng.integers(-1, 400, (64, 3, 5)).astype(np.int32)
    queries[0, 0, :] = dst[:5]  # hits of the hub row
    queries[1, 0, 0] = dst[299]  # its last position, in the second pass
    got = segment.row_member(minimal, _t(rows.astype(np.int32)), _t(queries))
    bisect = segment.row_member(full, _t(rows.astype(np.int32)), _t(queries))
    nbrs = {}
    for s, d in zip(src, dst):
        nbrs.setdefault(int(s), set()).add(int(d))
    want = np.array([[[int(x) in nbrs.get(int(r), set()) for x in qq]
                      for qq in qs] for r, qs in zip(rows, queries)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bisect.numpy(), want)
    assert want[0, 0].all() and want[1, 0, 0] and not want.all()


def test_hub_rows_walk_on_minimal_where_the_jax_package_refuses():
    """node2vec on a "minimal" store whose largest row is 300: the JAX
    package raises; the port walks and equals its own bisection route."""
    minimal, src, dst = _hub_csr(True)
    full, _, _ = _hub_csr(False)
    seeds = _t(np.arange(64, dtype=np.int32) % 5)
    first, cand, acc = jax_node2vec_draws(jax.random.key(2), 8, 64)
    args = (_t(first), _t(cand), _t(acc), 0.5, 2.0)
    got = walk.node2vec_draw(minimal, seeds, *args)
    np.testing.assert_array_equal(got.numpy(),
                                  walk.node2vec_draw(full, seeds, *args))
    jg = JaxGraph()
    jg.store.add_node_table(JaxNodeTable("v", JaxDecoder(), np.arange(400)))
    jg.store.add_edge_table(JaxEdgeTable("e", "v", "v", JaxDecoder(),
                                         src=src, dst=dst, num_src_nodes=400,
                                         num_dst_nodes=400))
    with both_confs(storage_profile="minimal"):
        jcsr = jg.store.edge_table("e").device().out
    with pytest.raises(gl.InvalidArgumentError, match="max_degree 300"):
        jax_walk.node2vec_walk(jcsr, jnp.asarray(seeds.numpy()), 8,
                               jax.random.key(2), p=0.5, q=2.0)


def _synthetic():
    spec = importlib.util.spec_from_file_location(
        "walk_synthetic", REPO / "examples" / "data" / "synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_undirected_store_equals_the_jax_store_loaded_undirected(
        tmp_path):
    """``add_edge_table(table, directed=False)`` within one node type: the
    edge table and both CSRs bit-equal to the JAX package's flat views of
    the node2vec example's store, loaded from the TSV files its generator
    writes with ``directed=False``; the features within the files' five
    decimals."""
    _synthetic().cora_like(str(tmp_path), n=150, classes=7, feat_dim=16)
    jg = (gl.Graph()
          .node(str(tmp_path / "node_table"), "item",
                gl.Decoder(labeled=True, attr_types=["float"] * 16))
          .edge(str(tmp_path / "edge_table"), ("item", "item", "relation"),
                gl.Decoder(weighted=True), directed=False)).init()
    tg, _ = n2v.build_graph(n2v.cora_like(n=150, feat_dim=16), "cpu")
    jt, tt = jg.store.edge_table("relation"), tg.store.edge_table("relation")
    m = tt.num_edges // 2
    assert tt.num_edges == jt.num_edges == 2 * m and m > 0
    for f in ("src", "dst", "weights"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    np.testing.assert_array_equal(tt.src[m:], tt.dst[:m])
    jd, td = jt.device(), tt.device("cpu")
    for direction in ("out", "inc"):
        jc, tc = getattr(jd, direction), getattr(td, direction)
        assert tc.max_degree == jc.max_degree
        for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "nbr_ids_sorted",
                  "nbr_edge_ids_sorted", "cum_weights", "cum_in_degrees"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=direction + "." + f)
    for f in ("unique_dst", "unique_dst_indeg_cdf", "unique_src",
              "unique_src_outdeg_cdf"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))
    jn, tn = jg.store.node_table("item"), tg.store.node_table("item")
    np.testing.assert_array_equal(tn.labels, jn.labels)
    np.testing.assert_allclose(tn.float_attrs, jn.float_attrs, atol=5e-6)


def _forced_walk_graphs():
    """40 nodes, each of the first 30 with one out-edge, the last 10 dead
    ends: every walk is forced, so both packages walk the same ids."""
    rng = np.random.default_rng(9)
    a = {"raw_ids": np.arange(40, dtype=np.int64) * 3 + 7,
         "feats": rng.standard_normal((40, 6), np.float32),
         "labels": rng.integers(0, 3, 40).astype(np.int32),
         "src": np.arange(30), "dst": rng.permutation(40)[:30],
         "weights": None}
    return jax_graph(a)[0], torch_graph(a)[0]


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 2.0)])
def test_the_random_walk_query_answers_as_jax_does(pq):
    """``V().random_walk()`` through ``_execute``: the same [b, L] ids with
    the -1 of the stuck walkers kept, and the feature rows, labels and raw
    ids of JAX's lookup at ``max(id, 0)``."""
    p, q = pq
    jg, tg = _forced_walk_graphs()

    def query(g):
        return (g.V("item").batch(16).alias("src")
                .random_walk(6, p=p, q=q, edge_type="rel").alias("walks")
                .values())

    seeds = np.arange(16, dtype=np.int32) * 2 + 8
    jq, tq = query(jg), query(tg)
    want = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds),
                       jax.random.key(0))["walks"]
    got = tcompile._execute(tq, tq.device_tables(), _t(seeds),
                            torch.Generator().manual_seed(0))["walks"]
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert (got.ids == -1).any() and (got.ids[:, 0] == _t(seeds)).all()
    np.testing.assert_array_equal(got.float_attrs.materialize().numpy(),
                                  np.asarray(want.float_attrs))
    for f in ("labels", "raw_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_the_plan_walks_with_its_generator_over_the_named_edge_type():
    """The plan's walk is ``node2vec_walk`` on the out-CSR with the query's
    p and q, drawn from the plan's generator, reshaped to the parent's
    shape; a ``Dataset`` over a ``.shuffle(traverse=True)`` source walks
    each seed once an epoch."""
    a = numpy_graph(n=120, avg_degree=5, isolated=10, seed=2)
    g, _ = torch_graph(a)
    q = (g.V("item").batch(32).shuffle(traverse=True).alias("src")
         .random_walk(5, p=0.5, q=2.0, edge_type="rel").alias("walks")
         .values())
    seeds = _t(np.arange(32, dtype=np.int32) + 80)
    tables = q.device_tables()
    got = tcompile._execute(q, tables, seeds,
                            torch.Generator().manual_seed(6))["walks"].ids
    want = walk.node2vec_walk(tables["edges"]["rel"].out, seeds, 5,
                              torch.Generator().manual_seed(6), p=0.5, q=2.0)
    assert torch.equal(got, want) and (got == -1).any()
    ds = Dataset(q, window=2, device="cpu")
    firsts = []
    while True:
        try:
            out, count = ds.next_with_count()
        except OutOfRangeError:
            break
        assert out["walks"].ids.shape == (32, 5)
        firsts.append(out["walks"].ids[:count, 0])
    assert sorted(torch.cat(firsts).tolist()) == list(range(120))


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 2.0), (0.25, 0.25)])
def test_the_ports_own_walks_hold_the_invariants_and_the_step_shares(pq):
    """On the port's own draws: column 0 the seeds, every step an edge of
    the host arrays, -1 only at a dead end and after it; node2vec's
    return / neighbour-of-previous / other steps within a chi-square bound
    of their expectation, on the node2vec example's undirected store and
    on a directed one; ``chip_smoke.py``'s checks, each also broken once."""
    smoke = _smoke()
    p, q = pq
    for a, name in ((n2v.cora_like(n=300), "relation"), (None, "rel")):
        if a is None:
            g, _ = torch_graph(numpy_graph(n=300, avg_degree=4, isolated=30,
                                           seed=4))
        else:
            g, _ = n2v.build_graph(a, "cpu")
        et = g.store.edge_table(name)
        keys = smoke.edge_keys(et.src, et.dst, 300)
        seeds = torch.randint(0, 300, (256,),
                              generator=torch.Generator().manual_seed(1),
                              dtype=torch.int32)
        walks = walk.node2vec_walk(et.device("cpu").out, seeds, 12,
                                   torch.Generator().manual_seed(2), p=p,
                                   q=q).numpy()
        steps, stuck = smoke.walk_invariants(walks, seeds.numpy(), keys, 300)
        assert steps > 256 * 5 and (stuck > 0 or a is not None)
        obs, exp = smoke.node2vec_shares(walks, keys, 300, p, q,
                                         walk.NUM_TRIES)
        assert obs.sum() == pytest.approx(exp.sum())
        assert smoke.share_p_value(obs, exp) > 1e-3, (obs, exp)
        if a is not None:
            assert obs[0] > 20 and obs[1] > 20  # returns and triangles
            # the biased shares are not the uniform walk's
            uni = smoke.node2vec_shares(walks, keys, 300, 1.0, 1.0, 8)[1]
            if p != 1.0:
                assert smoke.share_p_value(obs, uni) < 1e-3
        bad = walks.copy()
        bad[5, 3] = (bad[5, 2] + 1) % 300 if bad[5, 2] >= 0 else 7
        with pytest.raises(smoke.SmokeFailure):
            smoke.walk_invariants(bad, seeds.numpy(), keys, 300)


def test_share_p_value_tails():
    smoke = _smoke()
    obs, exp = np.array([10.0, 20, 70]), np.array([10.0, 20, 70])
    assert smoke.share_p_value(obs, exp) == 1.0
    # 2 degrees of freedom: exp(-x/2); 1: erfc(sqrt(x/2))
    assert smoke.share_p_value(np.array([20.0, 20, 60]), exp) == \
        pytest.approx(np.exp(-(10 ** 2 / 10 + 10 ** 2 / 70) / 2))
    assert smoke.share_p_value(np.array([1.0, 0, 99]),
                               np.array([0.0, 0, 100])) == 0.0
    assert smoke.share_p_value(np.array([0.0, 10, 90]),
                               np.array([0.0, 12, 88])) == pytest.approx(
        float(__import__("math").erfc(np.sqrt((4 / 12 + 4 / 88) / 2))))


def test_the_host_checks_take_int32_ids_of_a_large_store():
    """Walk ids arrive as int32; at the 61.25M-edge store's 2.45M nodes an
    id times n overflows int32, so the checks widen it first."""
    smoke = _smoke()
    n = 2_450_000
    keys = smoke.edge_keys(np.array([2_400_000, 2_400_000, 5]),
                           np.array([7, n - 1, 3]), n)
    np.testing.assert_array_equal(smoke.key_row(keys, n, np.int32(2_400_000)),
                                  [7, n - 1])
    w = np.array([[2_400_000, n - 1, -1, -1]], np.int32)
    assert smoke.walk_invariants(w, w[:, 0], keys, n) == (1, 1)
    obs, exp = smoke.node2vec_shares(np.array([[5, 3, -1]], np.int32), keys,
                                     n, 0.5, 2.0, 8)
    assert obs.sum() == exp.sum() == 0  # node 3 has no out-edge


def test_walk_steps_run_k_batches_a_call_eagerly():
    """``WalkSteps``: K batches of the given walk a call, each from
    ``torch.randint`` seeds of the generator, ``acc`` the sum of the last
    ids; the same generator seed gives the same batches."""
    g, _ = torch_graph(numpy_graph(n=150, avg_degree=4, isolated=10,
                                   seed=3))
    csr = g.store.edge_table("rel").device("cpu").out
    steps = [fs.WalkSteps(csr, 150, 16, 6, 0.5, 2.0, 4,
                          torch.Generator().manual_seed(9), False)
             for _ in range(2)]
    for s in steps:
        s()
    s = steps[0]
    assert s.walks.shape == (4, 16, 6) and len(s.seeds) == 4
    assert torch.equal(s.walks, steps[1].walks)
    assert int(s.acc) == int(s.walks[:, :, -1].sum())
    for i in range(4):
        assert torch.equal(s.walks[i, :, 0], s.seeds[i])
    gen = torch.Generator().manual_seed(9)
    seeds = torch.randint(0, 150, (16,), generator=gen, device="cpu",
                          dtype=torch.int32)
    assert torch.equal(s.walks[0], walk.node2vec_walk(csr, seeds, 6, gen,
                                                      p=0.5, q=2.0))


def test_family_scale_walks_runs_eagerly_and_prints_its_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fs.main(["--small", "--cpu", "--families", "walks"]) == 0
    assert re.fullmatch("".join(
        r"walks/%-9s [0-9.]+M transitions/s  [0-9.]+ ms/batch \(len 8, "
        r"b 256\)\n" % label for label in ("deepwalk", "node2vec")),
        out.getvalue())


def test_run_walks_counts_its_transitions():
    cfg = dict(n_nodes=500, avg_degree=4, feat_dim=4, classes=3, batch=32,
               steps=4, scan_steps=2)
    with both_confs(storage_profile="minimal"):
        r = fs.run_walks(cfg, small=True, device="cpu")
    assert r["transitions_per_batch"] == 32 * 7 and not r["capture"]
    for label, p, q in fs.WALKS:
        assert r[label]["rounds"] == 2 and r[label]["transitions_per_s"] > 0
        assert r[label]["step"].walks.shape == (2, 32, 8)
        assert r[label]["capture_s"] is None
    assert r["graph"][0].store.edge_table("rel").device(
        "cpu").out.nbr_ids_sorted is None


def test_the_node2vec_example_runs_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        coherence = n2v.main(["--cpu", "--data_dir", str(tmp_path), "--epochs",
                              "1", "--walk_len", "4"])
    assert re.search(r"^epoch 0 loss [0-9.]+$", out.getvalue(), re.M)
    assert re.search(r"^nn label coherence: [01]\.\d{3} \(chance ~0\.143\)$",
                     out.getvalue(), re.M)
    assert 0.0 <= coherence <= 1.0


def test_the_node2vec_loss_equals_jax():
    """``skipgram_loss`` against ``examples/node2vec.py``'s on the same
    walks, negatives and tables (f32: within 1e-6 relative)."""
    rng = np.random.default_rng(0)
    walks = rng.integers(-1, 50, (8, 6)).astype(np.int32)
    emb = rng.standard_normal((50, 12)).astype(np.float32) * 0.1
    ctx = rng.standard_normal((50, 12)).astype(np.float32) * 0.1
    t, c, valid = jax_walk.skipgram_pairs(jnp.asarray(walks), 2)
    negs = rng.integers(0, 50, t.shape + (3,))
    te = emb[np.maximum(np.asarray(t), 0)]
    pos = np.sum(te * ctx[np.maximum(np.asarray(c), 0)], -1)
    neg = np.einsum("bpd,bpnd->bpn", te, ctx[negs])
    w = np.asarray(valid, np.float32)
    want = -(jax.nn.log_sigmoid(pos) * w).sum()
    want -= (jax.nn.log_sigmoid(-neg) * w[..., None]).sum()
    want = float(want / max(w.sum(), 1.0))
    got = n2v.skipgram_loss(_t(emb), _t(ctx),
                            walk.skipgram_pairs(_t(walks), 2), _t(negs))
    assert float(got) == pytest.approx(want, rel=1e-6)
