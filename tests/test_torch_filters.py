"""Sampler filters and registered strategies of the port against the JAX
package's.

An ``exclude_dst`` filter is exact for ``topk``, ``full`` and, on JAX's own
draws, for ``edge_weight`` / ``in_degree`` and
``random_without_replacement`` (the excluded slot is removed from the row)
and for ``random`` (retry rounds: JAX's ``u`` of [b, k, R + 1] fed to
``uniform_draw``).  Rows of more than 256 neighbours, which the JAX package
refuses, are the one deliberate difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu.ops import sampling as jax_sampling
from graph_learn_tpu.ops.segment import row_bounds_csr
from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl.compile import _execute
from graph_learn_tpu_torch.ops import sampling
from graph_learn_tpu_torch.ops.segment import row_bounds
from torch_parity import both_confs, jax_graph, numpy_graph, torch_graph

N, B = 300, 64


def _arrays(seed=0, n=N, avg_degree=6, isolated=10):
    """A random graph whose first 60 nodes also link to themselves and
    whose first 20 edges appear twice (a neighbour listed twice in a row:
    the filter removes one slot, the last)."""
    a = numpy_graph(n=n, avg_degree=avg_degree, isolated=isolated, seed=seed)
    loops = np.arange(60)
    a["src"] = np.concatenate([a["src"], loops, a["src"][:20]])
    a["dst"] = np.concatenate([a["dst"], loops, a["dst"][:20]])
    rng = np.random.default_rng(seed + 100)
    a["weights"] = np.concatenate(
        [a["weights"], rng.random(80).astype(np.float32)])
    return a


def _csrs(a):
    jcsr = jax_graph(a)[0].store.edge_table("rel").device().out
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    return jcsr, tcsr


def _seeds_and_excl(a, seed, n=N):
    """64 seeds (two of them without neighbours) and one id to exclude per
    seed: mostly a neighbour of the seed, else any node."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, n, B).astype(np.int32)
    seeds[:3] = [n - 1, n - 2, 0]
    excl = rng.integers(0, n, B).astype(np.int32)
    for i, s in enumerate(seeds):
        row = a["dst"][a["src"] == s]
        if row.size and rng.random() < 0.8:
            excl[i] = rng.choice(row)
    return seeds, excl


def _filters(excl):
    return (jax_sampling.SampleFilter(exclude_dst=jnp.asarray(excl)),
            sampling.SampleFilter(exclude_dst=torch.from_numpy(excl)))


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_excluded(a, seeds, excl, ids):
    """No sampled id equals the excluded one where the row lists it once
    beside at least one other neighbour."""
    for i, s in enumerate(seeds):
        row = a["dst"][a["src"] == s]
        if (row == excl[i]).sum() == 1 and row.size > 1:
            assert excl[i] not in ids[i], (i, s, excl[i], ids[i])


@pytest.mark.parametrize("key", [0, 1, 2])
@pytest.mark.parametrize("k", [15, 4])
def test_random_filter_on_jax_u_equals_jax(key, k):
    a = _arrays(seed=key)
    jcsr, tcsr = _csrs(a)
    seeds, excl = _seeds_and_excl(a, key)
    jflt, tflt = _filters(excl)
    jkey = jax.random.key(key)
    want = jax_sampling.uniform_sample(jcsr, jnp.asarray(seeds), k, jkey,
                                       flt=jflt)
    # the candidate rounds JAX drew inside _apply_filter_retry
    u = np.array(jax.random.uniform(
        jkey, (B, k, conf.sampling_retry_times + 1)))
    got = sampling.uniform_draw(tcsr, torch.from_numpy(seeds),
                                torch.from_numpy(u), flt=tflt)
    _equal(got, want)
    # an excluded id comes through only where all R + 1 rounds drew it
    ids = got[0].numpy()
    assert (ids == excl[:, None]).sum() < 0.05 * (
        np.array([(a["dst"][a["src"] == s] == x).any()
                  for s, x in zip(seeds, excl)]).sum() * k)


def test_retry_keeps_the_first_passing_round_else_the_last():
    # one row [5, 7, 9] at positions 0..2; candidates per round
    nbr = torch.tensor([5, 7, 9], dtype=torch.int32)
    csr = sampling.DeviceCSR(row_offsets=torch.tensor([0, 3],
                                                      dtype=torch.int32),
                             nbr_ids=nbr, nbr_edge_ids=nbr, max_degree=3)
    pos = torch.tensor([[[0, 0, 1], [0, 0, 0], [2, 0, 0]]],
                       dtype=torch.int32)
    got = sampling.retry_positions(csr, pos, torch.tensor([5]))
    assert got.tolist() == [[1, 0, 2]]


@pytest.mark.parametrize("padding_mode", [1, 0])
@pytest.mark.parametrize("k", [9, 2])
def test_topk_filter_equals_jax(k, padding_mode):
    a = _arrays(seed=1)
    jcsr, tcsr = _csrs(a)
    seeds, excl = _seeds_and_excl(a, 1)
    jflt, tflt = _filters(excl)
    with both_confs(padding_mode=padding_mode, default_neighbor_id=7):
        want = jax_sampling.topk_sample(jcsr, jnp.asarray(seeds), k,
                                        flt=jflt)
        got = sampling.topk_sample(tcsr, torch.from_numpy(seeds), k,
                                   flt=tflt)
    _equal(got, want)
    _check_excluded(a, seeds, excl, got[0].numpy())


@pytest.mark.parametrize("key", [0, 1])
@pytest.mark.parametrize("by", ["edge_weight", "in_degree"])
def test_weighted_filter_on_jax_u_equals_jax(by, key):
    a = _arrays(seed=key)
    a["weights"][a["src"] == 3] = 0.0  # an all-zero row: uniform
    jcsr, tcsr = _csrs(a)
    seeds, excl = _seeds_and_excl(a, key)
    seeds[3] = 3
    jflt, tflt = _filters(excl)
    jkey, k = jax.random.key(key), 12
    want = jax_sampling.weighted_sample(jcsr, jnp.asarray(seeds), k, jkey,
                                        by=by, flt=jflt)
    u = np.array(jax.random.uniform(jkey, (B, k)))
    got = sampling.weighted_draw(tcsr, torch.from_numpy(seeds),
                                 torch.from_numpy(u), by=by, flt=tflt)
    _equal(got, want)
    _check_excluded(a, seeds, excl, got[0].numpy())


def test_weighted_filter_steps_off_the_excluded_slot_at_a_boundary():
    # one row of four edges, CDF .25 .5 .75 1.; exclude slot 1 ([.25, .5))
    cum = torch.tensor([0.25, 0.5, 0.75, 1.0])
    start, end = (torch.tensor([0], dtype=torch.int32),
                  torch.tensor([4], dtype=torch.int32))
    rel = torch.tensor([1], dtype=torch.int32)
    present = torch.tensor([True])
    # the rest of the mass is .75: u * .75 below .25 keeps slot 0, else
    # it is shifted by .25 past the excluded interval
    u = torch.tensor([[0.0, 0.3, 1 / 3, 0.5, 0.999]])
    pos = sampling.excluded_weighted_positions(start, end, cum, u, rel,
                                               present, max_degree=4)
    assert 1 not in pos.tolist()[0]
    assert pos.tolist() == [[0, 0, 2, 2, 3]]


@pytest.mark.parametrize("key", [0, 1, 2])
@pytest.mark.parametrize("k", [8, 3])
def test_without_replacement_filter_on_jax_draws_equals_jax(k, key):
    a = _arrays(seed=key)
    jcsr, tcsr = _csrs(a)
    seeds, excl = _seeds_and_excl(a, key)
    jflt, tflt = _filters(excl)
    jkey = jax.random.key(key)
    want = jax_sampling.without_replacement_sample(
        jcsr, jnp.asarray(seeds), k, jkey, flt=jflt)
    r = np.stack([np.array(jax.random.uniform(kj, (B,)))
                  for kj in jax.random.split(jkey, k)])
    got = sampling.wor_draw(tcsr, torch.from_numpy(seeds),
                            torch.from_numpy(r), flt=tflt)
    _equal(got, want)
    _check_excluded(a, seeds, excl, got[0].numpy())


@pytest.mark.parametrize("cap", [4, 40])
def test_full_filter_equals_jax(cap):
    a = _arrays(seed=3)
    jcsr, tcsr = _csrs(a)
    seeds, excl = _seeds_and_excl(a, 3)
    jflt, tflt = _filters(excl)
    with both_confs(default_neighbor_id=9):
        want = jax_sampling.full_sample(jcsr, jnp.asarray(seeds), cap,
                                        flt=jflt)
        got = sampling.full_sample(tcsr, torch.from_numpy(seeds), cap,
                                   flt=tflt)
    _equal(got, want)
    ids, _, deg = got
    true_deg = np.array([(a["src"] == s).sum() for s in seeds])
    listed = np.array([(a["dst"][a["src"] == s] == x).any()
                       for s, x in zip(seeds, excl)])
    np.testing.assert_array_equal(deg.numpy(),
                                  np.minimum(true_deg - listed, cap))


def _queries(a, strategy, k1, k2=3, filtered=True):
    def q(g):
        hop = (g.V("item").batch(B).alias("src").outV("rel").sample(k1)
               .by(strategy))
        if filtered:
            hop = hop.filter("src")
        return (hop.alias("hop1").outV("rel").sample(k2).by("topk")
                .alias("hop2").values())
    (jg, _), (tg, _) = jax_graph(a), torch_graph(a)
    return q(jg), q(tg)


@pytest.mark.parametrize("strategy,k1", [("topk", 5), ("full", 12)])
def test_filtered_hop_in_a_query_equals_the_jax_query(strategy, k1):
    a = _arrays(seed=4)
    jq, tq = _queries(a, strategy, k1)
    seeds = np.random.default_rng(4).integers(0, 60, B).astype(np.int32)
    want = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds),
                       jax.random.key(0))
    got = _execute(tq, tq.device_tables("cpu"), torch.from_numpy(seeds),
                   torch.Generator().manual_seed(0))
    for alias in ("hop1", "hop2"):
        np.testing.assert_array_equal(got[alias].ids.numpy(),
                                      np.asarray(want[alias].ids))
    if strategy == "full":
        np.testing.assert_array_equal(got["hop1"].degrees.numpy(),
                                      np.asarray(want["hop1"].degrees))
    # every seed links to itself: the filter drops that slot
    hop1 = got["hop1"].ids.numpy()
    _check_excluded(a, seeds, seeds, hop1[:, :3])


@pytest.mark.parametrize("strategy", ["random", "edge_weight",
                                      "random_without_replacement"])
def test_filtered_random_hop_keeps_out_the_seed(strategy):
    # seeds among the self-linked nodes: unfiltered, the seed is drawn as
    # its own neighbour; filtered, never where the row has another
    a = _arrays(seed=5)
    seeds = np.arange(60, dtype=np.int32)[:B]
    hits = {}
    for filtered in (False, True):
        _, tq = _queries(a, strategy, 15, filtered=filtered)
        out = _execute(tq, tq.device_tables("cpu"), torch.from_numpy(seeds),
                       torch.Generator().manual_seed(1))
        ids = out["hop1"].ids.numpy()
        hits[filtered] = int((ids == seeds[:, None]).sum())
        for i, s in enumerate(seeds):
            row = a["dst"][a["src"] == s]
            assert np.isin(ids[i], row).all(), (i, ids[i], row)
        if filtered and strategy != "random":
            _check_excluded(a, seeds, seeds, ids)
    # random retries: the seed comes through only where all R + 1 rounds
    # drew it ((1/deg)^6 a slot); the others remove its slot
    assert hits[False] > 0, hits
    assert hits[True] <= (hits[False] // 100 if strategy == "random"
                          else 0), hits


@pytest.fixture
def registry():
    """Both packages' strategy tables, restored after the test."""
    saved = (dict(sampling.STRATEGY_FNS), dict(jax_sampling.STRATEGY_FNS))
    yield
    for table, old in zip((sampling.STRATEGY_FNS, jax_sampling.STRATEGY_FNS),
                          saved):
        table.clear()
        table.update(old)


def test_register_sampler_refuses_builtin_names_and_routes_a_custom_one(
        registry):
    # "first": the first neighbour of the adjacency, k times
    def tfirst(csr, seeds, k, generator):
        start, _, deg = row_bounds(csr.row_offsets, seeds)
        pos = start[:, None].expand(-1, k)
        return sampling._gather(csr, pos, (deg > 0)[:, None])

    def jfirst(csr, seeds, k, key):
        start, _, deg = row_bounds_csr(csr, seeds)
        pos = jnp.broadcast_to(start[:, None], (seeds.shape[0], k))
        return jax_sampling._gather(csr, pos, (deg > 0)[:, None])

    for name in sampling.BUILTIN_STRATEGIES:
        with pytest.raises(ValueError, match="already registered"):
            sampling.register_sampler(name, tfirst)
        with pytest.raises(ValueError, match="already registered"):
            jax_sampling.register_sampler(name, jfirst)
    sampling.register_sampler("first", tfirst)
    jax_sampling.register_sampler("first", jfirst)
    with pytest.raises(InvalidArgumentError, match="already registered"):
        sampling.register_sampler("first", tfirst)

    a = _arrays(seed=6)
    jq, tq = _queries(a, "first", 4, filtered=False)
    seeds = np.random.default_rng(6).integers(0, N, B).astype(np.int32)
    want = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds),
                       jax.random.key(0))
    got = _execute(tq, tq.device_tables("cpu"), torch.from_numpy(seeds),
                   torch.Generator().manual_seed(0))
    for alias in ("hop1", "hop2"):
        np.testing.assert_array_equal(got[alias].ids.numpy(),
                                      np.asarray(want[alias].ids))
    assert (got["hop1"].ids[:, 1:] == got["hop1"].ids[:, :1]).all()


def _hub_arrays():
    """Node 0 has 300 out-neighbours (one of them itself, listed once);
    the others a few."""
    a = numpy_graph(n=400, avg_degree=3, seed=7)
    hub = np.random.default_rng(7).permutation(np.arange(1, 400))[:299]
    a["src"] = np.concatenate([a["src"][a["src"] != 0], np.zeros(300, int)])
    a["dst"] = np.concatenate([a["dst"][:a["src"].size - 300], [0], hub])
    a["weights"] = np.random.default_rng(8).random(a["src"].size).astype(
        np.float32)
    return a


@pytest.mark.parametrize("strategy", ["topk", "full", "edge_weight",
                                      "random_without_replacement"])
def test_hub_rows_are_filtered_where_the_jax_package_refuses(strategy):
    """The deliberate difference: the JAX package finds the excluded slot
    in a 128-lane window and refuses rows of more than 256 neighbours; the
    port scans the flat row, whatever its length."""
    a = _hub_arrays()
    jcsr, tcsr = _csrs(a)
    assert tcsr.max_degree == 300 == jcsr.max_degree
    seeds = np.array([0, 0, 5, 0], dtype=np.int32)
    excl = np.array([0, 17, 1, int(a["dst"][a["src"] == 0][-1])],
                    dtype=np.int32)
    jflt, tflt = _filters(excl)
    k, gen = 280, torch.Generator().manual_seed(0)
    jargs = {"topk": (jax_sampling.topk_sample, (k,)),
             "full": (jax_sampling.full_sample, (k,)),
             "edge_weight": (jax_sampling.weighted_sample,
                             (k, jax.random.key(0))),
             "random_without_replacement": (
                 jax_sampling.without_replacement_sample,
                 (k, jax.random.key(0)))}[strategy]
    with pytest.raises(ValueError, match="max_degree <= 256"):
        jargs[0](jcsr, jnp.asarray(seeds), *jargs[1], flt=jflt)

    ts = torch.from_numpy(seeds)
    if strategy == "full":
        ids, _, deg = sampling.full_sample(tcsr, ts, k, flt=tflt)
    elif strategy == "topk":
        ids, _ = sampling.topk_sample(tcsr, ts, k, flt=tflt)
    elif strategy == "edge_weight":
        ids, _ = sampling.weighted_sample(tcsr, ts, k, gen, flt=tflt)
    else:
        ids, _ = sampling.without_replacement_sample(tcsr, ts, k, gen,
                                                     flt=tflt)
    ids = ids.numpy()
    start, end, _ = (t.numpy() for t in row_bounds(tcsr.row_offsets, ts))
    nbr = tcsr.nbr_ids.numpy()
    for i in range(seeds.size):
        row = nbr[start[i]:end[i]]
        hit = np.nonzero(row == excl[i])[0]
        rest = np.delete(row, hit[-1:]) if hit.size else row
        got = ids[i, :deg[i]] if strategy == "full" else ids[i]
        assert excl[i] not in got or (row == excl[i]).sum() > 1
        assert np.isin(got, rest).all()
        if strategy in ("topk", "full"):
            # the filtered row in adjacency order (full: up to the cap)
            want = (rest[np.arange(k) % rest.size] if strategy == "topk"
                    else rest[:k])
            np.testing.assert_array_equal(ids[i, :want.size], want)
        if strategy == "full":
            assert deg[i] == min(rest.size, k)
        if strategy == "random_without_replacement" and rest.size > k:
            assert np.unique(ids[i]).size == k


def test_a_ts_upper_filter_composes_with_exclusion_through_every_entry():
    """``exclude_dst`` and ``ts_upper`` together, on JAX's draws:
    ``random``'s rounds reject both (given the edge timestamps), and the
    without-replacement draw removes the excluded slot and ignores the
    bound, as the JAX package's samplers do."""
    import types
    from graph_learn_tpu.core import schema, store
    from graph_learn_tpu_torch.core.schema import Decoder
    from graph_learn_tpu_torch.core.store import EdgeTable
    from torch_parity import temporal_arrays, temporal_table
    a = temporal_arrays(n=40, seed=9)
    jet = temporal_table(types.SimpleNamespace(
        Decoder=schema.Decoder, EdgeTable=store.EdgeTable), a).device()
    tet = temporal_table(types.SimpleNamespace(
        Decoder=Decoder, EdgeTable=EdgeTable), a).device("cpu")
    rng = np.random.default_rng(2)
    seeds = rng.integers(0, 36, 16).astype(np.int32)
    excl = np.array([int(a["dst"][a["src"] == s][0]) if (a["src"] == s).any()
                     else 0 for s in seeds], np.int32)
    bound = rng.integers(0, 400, 16).astype(np.int32)
    jflt = jax_sampling.SampleFilter(exclude_dst=jnp.asarray(excl),
                                     ts_upper=jnp.asarray(bound))
    tflt = sampling.SampleFilter(exclude_dst=torch.from_numpy(excl),
                                 ts_upper=torch.from_numpy(bound))
    key, k = jax.random.key(3), 5
    want = jax_sampling.uniform_sample(jet.out, jnp.asarray(seeds), k, key,
                                       flt=jflt, edge_ts=jet.timestamps)
    u = np.array(jax.random.uniform(
        key, (16, k, conf.sampling_retry_times + 1)))
    got = sampling.uniform_draw(tet.out, torch.from_numpy(seeds),
                                torch.from_numpy(u), flt=tflt,
                                edge_ts=tet.timestamps)
    _equal(got, want)
    want = jax_sampling.without_replacement_sample(
        jet.out, jnp.asarray(seeds), k, key, flt=jflt)
    r = np.stack([np.array(jax.random.uniform(kj, (16,)))
                  for kj in jax.random.split(key, k)])
    got = sampling.wor_draw(tet.out, torch.from_numpy(seeds),
                            torch.from_numpy(r), flt=tflt)
    _equal(got, want)


def test_uniform_draw_refuses_a_u_of_the_wrong_rank():
    a = _arrays(seed=9)
    _, tcsr = _csrs(a)
    seeds = torch.arange(4, dtype=torch.int32)
    flt = sampling.SampleFilter(exclude_dst=seeds)
    with pytest.raises(InvalidArgumentError, match="rounds"):
        sampling.uniform_draw(tcsr, seeds, torch.zeros(4, 3), flt=flt)
    with pytest.raises(InvalidArgumentError, match="rounds"):
        sampling.uniform_draw(tcsr, seeds, torch.zeros(4, 3, 6))
