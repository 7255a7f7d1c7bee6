"""Kernels 4 and 5 of the port (plain versions on the CPU) and the sorted
branch of ``gather_group_agg`` against the JAX package: the sweep harness's
prep bit for bit, the Pallas sweep and stream kernels in interpret mode, the
sorted-gather route in both settings, ``segment_aggregate`` and
``embedding_agg`` ``prod``."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graph_learn_tpu.ops.aggregate import embedding_agg as jax_embedding_agg
from graph_learn_tpu.ops.aggregate import \
    gather_group_agg as jax_gather_group_agg
from graph_learn_tpu.ops.aggregate import \
    segment_aggregate as jax_segment_aggregate
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops import aggregate
from graph_learn_tpu_torch.ops.kernels import spmm, sweep
from torch_parity import both_confs


def _jax_harness():
    """examples/sweep_aggregate.py of the JAX package, loaded by path."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "sweep_aggregate.py"
    spec = importlib.util.spec_from_file_location("jax_sweep_aggregate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n_rows, n, d, seed=0, hi=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n_rows, d)).astype(np.float32)
    flat = rng.integers(0, hi or n_rows, n).astype(np.int32)
    return table, flat


# (n_rows, N, k, R, hi): the interpret test's shape; a table that is not a
# multiple of the slab; many duplicate rows and empty slabs
PREP_CASES = [(4096, 2048, 8, 1024, None), (5000, 1000, 10, 4096, None),
              (5000, 1000, 10, 1024, None), (4096, 2048, 8, 256, 37),
              (3000, 0, 4, 1024, None)]


@pytest.mark.parametrize("n_rows,n,k,R,hi", PREP_CASES)
def test_sweep_prep_is_bit_equal_to_make_prep(n_rows, n, k, R, hi):
    _, flat = _inputs(n_rows, n, 4, seed=n, hi=hi)
    n_slabs = -(-n_rows // R)
    jstarts, jpacked = _jax_harness().make_prep(n_rows, R, n_slabs)(
        jnp.asarray(flat), k)
    starts, packed = sweep.sweep_prep(torch.from_numpy(flat), k, n_rows, R)
    assert starts.dtype == torch.int32 and packed.dtype == torch.int32
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert int(starts[0]) == 0 and int(starts[-1]) == n
    rows, groups = sweep.unpack_hits(starts, packed, R)
    np.testing.assert_array_equal(rows.numpy(), np.sort(flat, kind="stable"))
    np.testing.assert_array_equal(
        groups.numpy(), np.argsort(flat, kind="stable") // k)


def test_sweep_aggregate_plain_matches_the_pallas_kernel():
    n_rows, n, k, d, R = 4096, 2048, 8, 128, 1024
    table, flat = _inputs(n_rows, n, d)
    harness = _jax_harness()
    jstarts, jpacked = harness.make_prep(n_rows, R, n_rows // R)(
        jnp.asarray(flat), k)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(harness.make_sweep_kernel(n_rows, n // k, R, d)(
            jstarts, jpacked, jnp.asarray(table)))
    starts, packed = sweep.sweep_prep(torch.from_numpy(flat), k, n_rows, R)
    out = sweep.sweep_aggregate(starts, packed, torch.from_numpy(table),
                                n // k, R)
    assert out.shape == (n // k, d) and out.dtype == torch.float32
    # sums of k = 8 f32 rows in another order: rtol = atol = 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out.numpy() / k, table[flat].reshape(n // k, k, d).mean(1),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 7])
def test_sweep_aggregate_any_width_and_dtype(dtype, d):
    # n_rows not a multiple of R, a last slab shorter than R
    table, flat = _inputs(2500, 600, d, seed=d)
    t = torch.from_numpy(table).to(dtype)
    starts, packed = sweep.sweep_prep(torch.from_numpy(flat), 6, 2500, 1024)
    out = sweep.sweep_aggregate(starts, packed, t, 100, 1024)
    ref = t.float().numpy()[flat].reshape(100, 6, d).sum(1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    empty = sweep.sweep_aggregate(*sweep.sweep_prep(
        torch.zeros(0, dtype=torch.int32), 6, 2500, 1024), t, 0, 1024)
    assert empty.shape == (0, d)


def test_stream_sum_plain_matches_the_pallas_kernel():
    n_rows, d, R = 4096, 128, 1024
    table, _ = _inputs(n_rows, 1, d, seed=5)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_jax_harness().make_stream_kernel(n_rows, R, d)(
            jnp.asarray(table)))
    out = sweep.stream_sum(torch.from_numpy(table))
    assert out.shape == (1, d) and out.dtype == torch.float32
    # 4096 f32 terms per column in another order: 1e-6 of the column's sum
    # of magnitudes, against the Pallas kernel and a float64 sum
    limit = 1e-6 * np.abs(table).sum(0, dtype=np.float64)
    assert (np.abs(out.numpy()[0] - ref[0]) <= 2 * limit).all()
    assert (np.abs(out.numpy()[0] - table.sum(0, dtype=np.float64))
            <= limit).all()
    bf = torch.from_numpy(table).to(torch.bfloat16)
    np.testing.assert_allclose(sweep.stream_sum(bf).numpy()[0],
                               bf.double().sum(0).numpy(), rtol=0,
                               atol=float(limit.max()))


@pytest.mark.parametrize("R", [0, 1000, 3 * 1024, 8192])
def test_a_slab_that_is_no_power_of_two_up_to_4096_is_refused(R):
    flat = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(InvalidArgumentError, match="power of two"):
        sweep.sweep_prep(flat, 2, 100, R)
    with pytest.raises(InvalidArgumentError, match="power of two"):
        sweep.sweep_aggregate(flat, flat, torch.zeros((100, 4)), 4, R)


def test_too_many_groups_are_refused():
    flat = torch.zeros(1 << 18, dtype=torch.int32)
    with pytest.raises(InvalidArgumentError, match="groups"):
        sweep.sweep_prep(flat, 1, 100, 1024)
    sweep.sweep_prep(flat, 2, 100, 1024)  # 2**17 groups fit
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(InvalidArgumentError, match="n_groups"):
        sweep.sweep_aggregate(starts, flat[:4], torch.zeros((100, 4)),
                              1 << 18, 1024)


@pytest.mark.parametrize("call", ["sweep", "stream"])
def test_sweep_wrappers_refuse_what_the_kernels_do_not_take(call):
    before = (sweep.LAUNCHES_SWEEP.count, sweep.LAUNCHES_STREAM.count)
    starts, packed = sweep.sweep_prep(torch.zeros(4, dtype=torch.int32), 2,
                                      10, 1024)

    def run(table):
        if call == "sweep":
            return sweep.sweep_aggregate(starts, packed, table, 2, 1024)
        return sweep.stream_sum(table)

    # a tensor that is not on the CPU never takes the plain version
    with pytest.raises(InvalidArgumentError, match="CUDA"):
        run(torch.empty((10, 4), device="meta"))
    with pytest.raises(InvalidArgumentError, match="gradient"):
        run(torch.zeros((10, 4), requires_grad=True))
    with pytest.raises(InvalidArgumentError, match=r"\[n_rows, D\]"):
        run(torch.zeros(10))
    run(torch.zeros((10, 4)))  # the plain version is no launch
    assert (sweep.LAUNCHES_SWEEP.count, sweep.LAUNCHES_STREAM.count) == before


# --- the sorted branch of gather_group_agg ---------------------------------

@pytest.mark.parametrize("sorted_on", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["mean", "sum", "max"])
def test_gather_group_agg_matches_jax_in_both_settings(op, dtype, sorted_on,
                                                       monkeypatch):
    # the cases of tests/test_deferred_agg.py:35-45
    table = np.random.default_rng(0).standard_normal((500, 16), np.float32)
    idx = np.random.default_rng(1).integers(0, 500, (32, 5, 7)).astype(
        np.int32)
    jt = jnp.asarray(table).astype(dtype)
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    calls = []
    monkeypatch.setattr(aggregate, "sweep_aggregate", lambda *a: (
        calls.append("sweep"), sweep.sweep_aggregate(*a))[1])
    monkeypatch.setattr(aggregate, "segment_spmm", lambda *a, **k: (
        calls.append("spmm"), spmm.segment_spmm(*a, **k))[1])
    with both_confs(sorted_gather=sorted_on, sorted_gather_min_bytes=0):
        ref = np.asarray(jax_gather_group_agg(jt, jnp.asarray(idx), op=op))
        out = aggregate.gather_group_agg(tt, torch.from_numpy(idx), op=op)
    # sums and means go to the sweep kernel, a max keeps the segment SpMM
    assert calls == (["sweep"] if sorted_on and op != "max" else ["spmm"])
    assert out.shape == (160, 16) and out.dtype == torch.float32
    # f32 accumulation over 7 rows in another order (bf16 rows widen
    # exactly): rtol 1e-5, atol 2e-6
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=2e-6)


def test_gather_group_agg_small_table_takes_the_unsorted_route(monkeypatch):
    table = torch.randn((50, 4), generator=torch.Generator().manual_seed(0))
    idx = torch.randint(0, 50, (8, 4), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    monkeypatch.setattr(aggregate, "sweep_prep", None)  # must not be reached
    with both_confs(sorted_gather=True):  # floor 32 MiB: the table is 800 B
        out = aggregate.gather_group_agg(table, idx, "mean")
    np.testing.assert_allclose(out.numpy(), table[idx.long()].mean(1).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_sorted_gather_clips_ids_like_the_jax_branch():
    table = np.random.default_rng(2).standard_normal((40, 8), np.float32)
    idx = np.array([[0, 39, 45], [-3, 7, 40]], np.int32)
    with both_confs(sorted_gather=True, sorted_gather_min_bytes=0):
        ref = np.asarray(jax_gather_group_agg(jnp.asarray(table),
                                              jnp.asarray(idx), op="sum"))
        out = aggregate.gather_group_agg(torch.from_numpy(table),
                                         torch.from_numpy(idx), "sum")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


# --- segment_aggregate and embedding_agg prod ------------------------------

@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod"])
def test_segment_aggregate_matches_jax(op):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((60, 5)).astype(np.float32)
    seg = rng.integers(0, 9, 60).astype(np.int32)
    seg[seg == 4] = 5  # segment 4 stays empty
    ref = np.asarray(jax_segment_aggregate(jnp.asarray(feats),
                                           jnp.asarray(seg), 9, op=op))
    out = aggregate.segment_aggregate(torch.from_numpy(feats),
                                      torch.from_numpy(seg), 9, op=op)
    assert out.shape == (9, 5)
    # at most a dozen f32 terms per segment in another order
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(InvalidArgumentError):
        aggregate.segment_aggregate(torch.from_numpy(feats),
                                    torch.from_numpy(seg), 9, op="median")


def test_embedding_agg_prod_matches_jax():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((60, 8)).astype(np.float32)
    ids = rng.integers(0, 60, (9, 6)).astype(np.int32)
    ids[0, 0] = 77  # clipped into the table, as the JAX package clips it
    deg = np.array([6, 0, 1, 3, 6, 2, 0, 5, 4], np.int32)
    ref = np.asarray(jax_embedding_agg(jnp.asarray(feats), jnp.asarray(ids),
                                       jnp.asarray(deg), op="prod"))
    before = spmm.LAUNCHES.count
    out = aggregate.embedding_agg(torch.from_numpy(feats),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(deg), op="prod")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-7)
    assert (out[1] == 1).all() and spmm.LAUNCHES.count == before
    with pytest.raises(InvalidArgumentError):
        aggregate.embedding_agg(torch.from_numpy(feats),
                                torch.from_numpy(ids),
                                torch.from_numpy(deg), op="median")

