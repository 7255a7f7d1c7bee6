"""The port's uniform neighbour sampling against the JAX package's.

Torch cannot reproduce JAX's random bits, so exact parity is held through
``uniform_positions`` fed the uniform numbers that JAX itself draws; the
port's own generator is held to invariants and a chi-square test."""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from graph_learn_tpu.ops import sampling as jax_sampling
from graph_learn_tpu_torch.ops import sampling
from torch_parity import both_confs, jax_graph, numpy_graph, torch_graph


def _csrs(**kw):
    a = numpy_graph(**kw)
    jcsr = jax_graph(a)[0].store.edge_table("rel").device().out
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    return a, jcsr, tcsr


@pytest.mark.parametrize("key", [0, 1, 2])
@pytest.mark.parametrize("k", [15, 4])
def test_uniform_draw_with_jax_u_equals_jax_uniform_sample(key, k):
    a, jcsr, tcsr = _csrs(n=300, avg_degree=6, isolated=10, seed=key)
    seeds = np.random.default_rng(key).integers(0, 300, 64).astype(np.int32)
    seeds[:3] = [299, 295, 0]  # two zero-degree seeds
    jkey = jax.random.key(key)
    j_ids, j_eids = jax_sampling.uniform_sample(jcsr, jax.numpy.asarray(seeds),
                                                k, jkey)
    # the uniform numbers JAX drew inside uniform_sample
    # (_apply_filter_retry, no filter: one draw of seeds.shape + (k,))
    u = np.array(jax.random.uniform(jkey, (seeds.size, k)))
    t_ids, t_eids = sampling.uniform_draw(tcsr, torch.from_numpy(seeds),
                                          torch.from_numpy(u))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_eids.numpy(), np.asarray(j_eids))


def test_uniform_positions_formula():
    start = torch.tensor([0, 10, 10, 40], dtype=torch.int32)
    deg = torch.tensor([5, 0, 1, 3], dtype=torch.int32)
    u = torch.tensor([[0.0, 0.9999999], [0.5, 0.99], [0.3, 0.7],
                      [1 / 3, 0.6666667]], dtype=torch.float32)
    pos = sampling.uniform_positions(start, deg, u)
    # start + min(floor(u * deg), max(deg, 1) - 1)
    assert pos.tolist() == [[0, 4], [10, 10], [10, 10], [41, 42]]


@pytest.mark.parametrize("fill", [0, 77])
def test_zero_degree_seed_gets_default_neighbor_and_no_edge(fill):
    a, _, tcsr = _csrs(n=100, isolated=5)
    seeds = torch.tensor([99, 96, 3], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    with both_confs(default_neighbor_id=fill):
        ids, eids = sampling.uniform_sample(tcsr, seeds, 6, gen)
    assert (ids[:2] == fill).all() and (eids[:2] == -1).all()
    # the live seed draws true out-edges of node 3
    e = eids[2].numpy()
    assert (e >= 0).all() and (a["src"][e] == 3).all()
    np.testing.assert_array_equal(a["dst"][e], ids[2].numpy())


def test_sampled_edges_are_true_edges():
    a, _, tcsr = _csrs(n=200, avg_degree=8, isolated=3)
    seeds = torch.arange(200, dtype=torch.int32)
    ids, eids = sampling.uniform_sample(tcsr, seeds, 10,
                                        torch.Generator().manual_seed(1))
    live = eids >= 0
    assert bool((live.all(dim=1) | ~live.any(dim=1)).all())
    e = eids[live].numpy()
    np.testing.assert_array_equal(a["src"][e],
                                  seeds[:, None].expand(-1, 10)[live].numpy())
    np.testing.assert_array_equal(a["dst"][e], ids[live].numpy())


def test_same_generator_seed_same_draw():
    _, _, tcsr = _csrs(n=100)
    seeds = torch.arange(50, dtype=torch.int32)
    a = sampling.uniform_sample(tcsr, seeds, 5,
                                torch.Generator().manual_seed(3))
    b = sampling.uniform_sample(tcsr, seeds, 5,
                                torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_uniform_sample_chi_square_on_a_high_degree_row():
    # node 0 has 40 out-edges to 40 distinct neighbours; 40 000 draws
    deg = 40
    src = np.zeros(deg, np.int64)
    dst = np.arange(1, deg + 1)
    a = {"raw_ids": np.arange(deg + 1), "src": src, "dst": dst,
         "feats": np.zeros((deg + 1, 2), np.float32),
         "labels": np.zeros(deg + 1, np.int32), "weights": None}
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    seeds = torch.zeros(400, dtype=torch.int32)
    ids, _ = sampling.uniform_sample(tcsr, seeds, 100,
                                     torch.Generator().manual_seed(11))
    counts = np.bincount(ids.numpy().ravel(), minlength=deg + 1)[1:]
    assert counts.sum() == 40_000
    p = stats.chisquare(counts).pvalue
    # a fixed seed: the test is deterministic; p > 1e-3 rejects a biased
    # draw (e.g. floor(u * (deg - 1)) gives p ~ 0)
    assert p > 1e-3, p


# --- the samplers that read the full store ---------------------------------

def _seeds(n, key, b=64):
    seeds = np.random.default_rng(key).integers(0, n, b).astype(np.int32)
    seeds[:3] = [n - 1, n - 5, 0]  # two zero-degree seeds
    return seeds


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("padding_mode", [1, 0])
@pytest.mark.parametrize("k", [9, 2])
def test_topk_sample_equals_jax_in_both_padding_modes(k, padding_mode):
    a, jcsr, tcsr = _csrs(n=300, avg_degree=4, isolated=10, seed=1)
    seeds = _seeds(300, 1)
    with both_confs(padding_mode=padding_mode, default_neighbor_id=7):
        want = jax_sampling.topk_sample(jcsr, jax.numpy.asarray(seeds), k)
        got = sampling.topk_sample(tcsr, torch.from_numpy(seeds), k)
    _equal(got, want)
    ids, eids = got
    assert (ids[:2] == 7).all() and (eids[:2] == -1).all()
    # the heaviest edges first: weights never rise along a row's prefix
    deg = np.bincount(a["src"], minlength=300)[seeds]
    w = a["weights"][np.maximum(eids.numpy(), 0)]
    for i in np.nonzero(deg >= k)[0]:
        assert (np.diff(w[i]) <= 0).all()
        assert w[i, 0] == a["weights"][a["src"] == seeds[i]].max()


@pytest.mark.parametrize("key", [0, 1])
@pytest.mark.parametrize("by", ["edge_weight", "in_degree"])
def test_weighted_draw_with_jax_u_equals_jax_weighted_sample(by, key):
    a = numpy_graph(n=300, avg_degree=6, isolated=10, seed=key)
    a["weights"][a["src"] == 0] = 0.0  # an all-zero row: uniform
    jcsr = jax_graph(a)[0].store.edge_table("rel").device().out
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    seeds, k = _seeds(300, key), 12
    jkey = jax.random.key(key)
    want = jax_sampling.weighted_sample(jcsr, jax.numpy.asarray(seeds), k,
                                        jkey, by=by)
    u = np.array(jax.random.uniform(jkey, (seeds.size, k)))
    got = sampling.weighted_draw(tcsr, torch.from_numpy(seeds),
                                 torch.from_numpy(u), by=by)
    _equal(got, want)
    assert (got[0][:2] == 0).all() and (got[1][:2] == -1).all()


def test_weighted_positions_ties_and_row_end():
    # one row of four edges with CDF .25 .5 .75 1.; a draw on a CDF value
    # takes that slot (side="left"), and u past the last value stays inside
    cum = torch.tensor([0.25, 0.5, 0.75, 1.0, 1.0])
    start, end = torch.tensor([0, 4], dtype=torch.int32), torch.tensor(
        [4, 5], dtype=torch.int32)
    u = torch.tensor([[0.0, 0.25, 0.2500001, 0.999, 1.0],
                      [0.0, 0.5, 1.0, 1.0, 1.0]])
    pos = sampling.weighted_positions(start, end, cum, u, max_degree=4)
    assert pos.tolist() == [[0, 0, 1, 3, 3], [4, 4, 4, 4, 4]]


@pytest.mark.parametrize("key", [0, 1, 2])
@pytest.mark.parametrize("k", [8, 3])
def test_wor_positions_with_jax_draws_equal_jax(k, key):
    # average degree 6 and k = 8: rows above and below k, and the circular
    # branch for deg <= k
    a, jcsr, tcsr = _csrs(n=300, avg_degree=6, isolated=10, seed=key)
    seeds = _seeds(300, key)
    jkey = jax.random.key(key)
    want = jax_sampling.without_replacement_sample(
        jcsr, jax.numpy.asarray(seeds), k, jkey)
    r = np.stack([np.array(jax.random.uniform(kj, (seeds.size,)))
                  for kj in jax.random.split(jkey, k)])
    ts = torch.from_numpy(seeds)
    start, _, deg = sampling.row_bounds(tcsr.row_offsets, ts)
    pos = sampling.wor_positions(start, deg, k, torch.from_numpy(r))
    got = sampling._gather(tcsr, pos, (deg > 0)[:, None])
    _equal(got, want)
    # distinct edges wherever the row has at least k
    e = got[1].numpy()
    for i in np.nonzero(deg.numpy() >= k)[0]:
        assert len(set(e[i])) == k


@pytest.mark.parametrize("cap", [4, 40])
def test_full_sample_equals_jax_and_clips_degrees(cap):
    a, jcsr, tcsr = _csrs(n=200, avg_degree=6, isolated=5, seed=3)
    seeds = _seeds(200, 3)
    with both_confs(default_neighbor_id=9):
        want = jax_sampling.full_sample(jcsr, jax.numpy.asarray(seeds), cap)
        got = sampling.full_sample(tcsr, torch.from_numpy(seeds), cap)
    _equal(got, want)
    ids, eids, deg = got
    true_deg = np.bincount(a["src"], minlength=200)[seeds]
    np.testing.assert_array_equal(deg.numpy(), np.minimum(true_deg, cap))
    assert deg.dtype == torch.int32 and (ids[:2] == 9).all()
    pad = torch.arange(cap)[None, :] >= deg[:, None]
    assert (eids[pad] == -1).all() and (ids[pad] == 9).all()


@pytest.mark.parametrize("strategy", ["edge_weight", "in_degree",
                                      "random_without_replacement"])
def test_random_samplers_draw_true_edges_from_the_ports_generator(strategy):
    a, _, tcsr = _csrs(n=200, avg_degree=8, isolated=3)
    seeds = torch.arange(200, dtype=torch.int32)
    fn = sampling.STRATEGY_FNS[strategy]
    kw = {"by": strategy} if fn is sampling.weighted_sample else {}
    ids, eids = fn(tcsr, seeds, 5, torch.Generator().manual_seed(1), **kw)
    live = eids >= 0
    assert bool((live.all(dim=1) | ~live.any(dim=1)).all())
    e = eids[live].numpy()
    np.testing.assert_array_equal(a["src"][e],
                                  seeds[:, None].expand(-1, 5)[live].numpy())
    np.testing.assert_array_equal(a["dst"][e], ids[live].numpy())
    again = fn(tcsr, seeds, 5, torch.Generator().manual_seed(1), **kw)
    assert torch.equal(again[0], ids)


def test_edge_weight_sample_follows_the_weights_chi_square():
    deg = 8
    w = np.arange(1, deg + 1, dtype=np.float32)
    a = {"raw_ids": np.arange(deg + 1), "src": np.zeros(deg, np.int64),
         "dst": np.arange(1, deg + 1),
         "feats": np.zeros((deg + 1, 2), np.float32),
         "labels": np.zeros(deg + 1, np.int32), "weights": w}
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    ids, _ = sampling.weighted_sample(
        tcsr, torch.zeros(400, dtype=torch.int32), 90,
        torch.Generator().manual_seed(5))
    counts = np.bincount(ids.numpy().ravel(), minlength=deg + 1)[1:]
    p = stats.chisquare(counts, counts.sum() * w / w.sum()).pvalue
    assert p > 1e-3, p  # a fixed seed: deterministic


def test_weighted_sample_without_a_cdf_raises_like_jax():
    _, jcsr, tcsr = _csrs(n=50, weighted=False)
    seeds = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="no edge_weight CDF"):
        jax_sampling.weighted_sample(jcsr, jax.numpy.asarray(seeds), 3,
                                     jax.random.key(0))
    with pytest.raises(ValueError, match="no edge_weight CDF"):
        sampling.weighted_sample(tcsr, torch.from_numpy(seeds), 3,
                                 torch.Generator().manual_seed(0))
    # in_degree needs no weights
    sampling.weighted_sample(tcsr, torch.from_numpy(seeds), 3,
                             torch.Generator().manual_seed(0), by="in_degree")


@pytest.mark.parametrize("strategy", ["topk", "edge_weight", "full",
                                      "random_without_replacement", "random"])
def test_an_empty_adjacency_fills_every_slot(strategy):
    a = numpy_graph(n=10)
    a.update(src=a["src"][:0], dst=a["dst"][:0], weights=a["weights"][:0])
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    seeds = torch.arange(4, dtype=torch.int32)
    fn = sampling.STRATEGY_FNS[strategy]
    args = () if strategy == "full" else (torch.Generator().manual_seed(0),)
    out = fn(tcsr, seeds, 3, *args)
    assert (out[0] == 0).all() and (out[1] == -1).all()
    assert strategy != "full" or (out[2] == 0).all()


@pytest.mark.parametrize("strategy", sorted(sampling.BUILTIN_STRATEGIES))
def test_a_ts_upper_filter_matches_jax(strategy):
    """``SampleFilter(ts_upper=...)`` on each built-in strategy, on JAX's
    own draws: ``random`` rejects candidates whose edge is not strictly
    earlier than the bound (retry rounds, given the edge timestamps), the
    others read only ``exclude_dst``, as JAX's ``_filter_guard`` does."""
    import jax.numpy as jnp
    from graph_learn_tpu.core import schema, store
    from graph_learn_tpu_torch.core.schema import Decoder
    from graph_learn_tpu_torch.core.store import EdgeTable
    from graph_learn_tpu_torch.config import conf
    from torch_parity import temporal_arrays, temporal_table
    import types
    a = temporal_arrays(n=40, seed=3)
    jet = temporal_table(types.SimpleNamespace(
        Decoder=schema.Decoder, EdgeTable=store.EdgeTable), a).device()
    tet = temporal_table(types.SimpleNamespace(
        Decoder=Decoder, EdgeTable=EdgeTable), a).device("cpu")
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 40, 32).astype(np.int32)
    seeds[:2] = [39, 38]  # zero-degree seeds
    bound = rng.integers(0, 400, 32).astype(np.int32)
    jflt = jax_sampling.SampleFilter(ts_upper=jnp.asarray(bound))
    tflt = sampling.SampleFilter(ts_upper=torch.from_numpy(bound))
    js, ts_ = jnp.asarray(seeds), torch.from_numpy(seeds)
    key, k = jax.random.key(5), 6
    if strategy == "random":
        want = jax_sampling.uniform_sample(jet.out, js, k, key, flt=jflt,
                                           edge_ts=jet.timestamps)
        u = np.array(jax.random.uniform(
            key, (32, k, conf.sampling_retry_times + 1)))
        got = sampling.uniform_draw(tet.out, ts_, torch.from_numpy(u),
                                    flt=tflt, edge_ts=tet.timestamps)
        # every drawn edge that passed a round is earlier than its bound
        eids = got[1].numpy()
        late = (eids >= 0) & (a["ts"][np.maximum(eids, 0)] - a["ts"].min()
                              >= bound[:, None])
        assert late.mean() < 0.5
    elif strategy in ("edge_weight", "in_degree"):
        want = jax_sampling.weighted_sample(jet.out, js, k, key, by=strategy,
                                            flt=jflt)
        u = np.array(jax.random.uniform(key, (32, k)))
        got = sampling.weighted_draw(tet.out, ts_, torch.from_numpy(u),
                                     strategy, flt=tflt)
    elif strategy == "random_without_replacement":
        want = jax_sampling.without_replacement_sample(jet.out, js, k, key,
                                                       flt=jflt)
        r = np.stack([np.array(jax.random.uniform(kj, (32,)))
                      for kj in jax.random.split(key, k)])
        got = sampling.wor_draw(tet.out, ts_, torch.from_numpy(r), flt=tflt)
    elif strategy == "topk":
        want = jax_sampling.topk_sample(jet.out, js, k, flt=jflt)
        got = sampling.topk_sample(tet.out, ts_, k, flt=tflt)
    else:
        want = jax_sampling.full_sample(jet.out, js, k, flt=jflt)
        got = sampling.full_sample(tet.out, ts_, k, flt=tflt)
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


def test_segmented_searchsorted_matches_jax():
    from graph_learn_tpu.ops.segment import \
        segmented_searchsorted as jax_searchsorted
    from graph_learn_tpu_torch.ops.segment import segmented_searchsorted
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 9, 30)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    vals = np.concatenate([np.sort(rng.integers(0, 6, n)) for n in lens]
                          ).astype(np.float32)  # duplicates: ties
    q = rng.integers(-1, 7, (30, 5)).astype(np.float32)
    for side in ("left", "right"):
        want = jax_searchsorted(jax.numpy.asarray(vals), off[:-1, None],
                                off[1:, None], jax.numpy.asarray(q),
                                side=side)
        got = segmented_searchsorted(
            torch.from_numpy(vals), torch.from_numpy(off[:-1, None].copy()),
            torch.from_numpy(off[1:, None].copy()), torch.from_numpy(q),
            side=side)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- through the GSL query ---------------------------------------------------

def _batches(a, build):
    """The first batch of the same query on both packages' graphs."""
    import graph_learn_tpu as gl
    import graph_learn_tpu_torch as glt
    jq = build(jax_graph(a)[0])
    tq = build(torch_graph(a)[0])
    return (gl.Dataset(jq, window=1).next(),
            glt.Dataset(tq, window=1, device="cpu").next(), tq)


@pytest.mark.parametrize("hop", ["inV", "outV"])
@pytest.mark.parametrize("padding_mode", [1, 0])
def test_topk_query_matches_the_jax_query(hop, padding_mode):
    a = numpy_graph(n=120, avg_degree=3, isolated=6, seed=4)

    def build(g):
        return (getattr(g.V("item").batch(32).alias("src"), hop)("rel")
                .sample(4).by("topk").alias("h1").values())

    with both_confs(padding_mode=padding_mode):
        jb, tb, _ = _batches(a, build)
    for alias in ("src", "h1"):
        np.testing.assert_array_equal(tb[alias].ids.numpy(),
                                      np.asarray(jb[alias].ids))
    np.testing.assert_array_equal(tb["src"].out_degrees.numpy(),
                                  np.asarray(jb["src"].out_degrees))
    np.testing.assert_array_equal(tb["h1"].float_attrs.materialize().numpy(),
                                  np.asarray(jb["h1"].float_attrs))
    # in_v: every hop id is a true in-neighbour of its seed
    if hop == "inV":
        pairs = set(zip(a["dst"].tolist(), a["src"].tolist()))
        indeg = np.bincount(a["dst"], minlength=120)
        for s, row in zip(tb["src"].ids.tolist(), tb["h1"].ids.tolist()):
            assert all((s, n) in pairs for n in row) or indeg[s] == 0


@pytest.mark.parametrize("count", [5, 0])
def test_full_query_returns_sparse_nodes_like_jax(count):
    from graph_learn_tpu.ops.aggregate import \
        embedding_agg as jax_embedding_agg
    from graph_learn_tpu_torch.core.values import DeferredRows, SparseNodes
    a = numpy_graph(n=120, avg_degree=6, isolated=6, seed=5)

    def build(g):
        hop = g.V("item").batch(32).alias("src").outV("rel")
        if count:
            hop = hop.sample(count)
        return hop.by("full").alias("nbrs").values()

    with both_confs(default_full_nbr_num=9):
        jb, tb, _ = _batches(a, build)
    js, ts = jb["nbrs"], tb["nbrs"]
    assert isinstance(ts, SparseNodes) and ts.cap == (count or 9)
    assert isinstance(ts.float_attrs, DeferredRows)
    for name in ("ids", "degrees", "raw_ids", "labels"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    np.testing.assert_array_equal(ts.mask().numpy(), np.asarray(js.mask()))
    np.testing.assert_array_equal(ts.offsets().numpy(),
                                  np.asarray(js.offsets()))
    table = jax.numpy.asarray(a["feats"])
    for op in ("sum", "mean", "max", "min", "prod"):
        want = np.asarray(jax_embedding_agg(table, js.ids, js.degrees, op=op))
        want = np.where(np.isfinite(want), want, 0.0)  # empty max/min rows
        # f32 reductions over at most 9 rows in another order
        np.testing.assert_allclose(ts.embedding_agg(op).numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=op)
    with pytest.raises(ValueError, match="deferred"):
        ts.replace(float_attrs=None).embedding_agg("mean")


@pytest.mark.parametrize("strategy", ["edge_weight", "in_degree",
                                      "random_without_replacement"])
def test_random_strategies_run_through_the_query(strategy):
    a = numpy_graph(n=120, avg_degree=6, isolated=6, seed=6)
    g = torch_graph(a)[0]
    q = (g.V("item").batch(16).alias("src").outV("rel").sample(3)
         .by(strategy).alias("h1").inV("rel").sample(2).by(strategy)
         .alias("h2").values())
    out = q.run(torch.arange(100, 116, dtype=torch.int32),
                torch.Generator().manual_seed(0))
    assert out["h1"].ids.shape == (16, 3) and out["h2"].ids.shape == (16, 3, 2)
    fwd = set(zip(a["src"].tolist(), a["dst"].tolist()))
    deg = np.bincount(a["src"], minlength=120)
    for s, row in zip(range(100, 116), out["h1"].ids.tolist()):
        assert all((s, n) in fwd for n in row) if deg[s] else row == [0] * 3


def test_in_v_on_a_minimal_store_raises():
    from graph_learn_tpu_torch.errors import InvalidArgumentError
    with both_confs(storage_profile="minimal"):
        g = torch_graph(numpy_graph(n=30))[0]
        q = (g.V("item").batch(4).alias("src").inV("rel").sample(2)
             .by("topk").alias("h1").values())
        with pytest.raises(InvalidArgumentError, match="reverse CSR"):
            q.run(torch.arange(4, dtype=torch.int32),
                  torch.Generator().manual_seed(0))
