"""The port's two kernels (plain versions on the CPU) against the Pallas
kernels they replace, run as tests/test_pallas.py runs them: in interpret
mode, and against their XLA formulation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.ops.aggregate import embedding_agg as jax_embedding_agg
from graph_learn_tpu.ops.aggregate import \
    gather_group_agg as jax_gather_group_agg
from graph_learn_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from graph_learn_tpu.ops.pallas.spmm import segment_spmm as jax_segment_spmm
from graph_learn_tpu.ops.pallas.spmm import segment_spmm_xla
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.aggregate import embedding_agg, gather_group_agg
from graph_learn_tpu_torch.ops.kernels import gather, spmm
from graph_learn_tpu_torch.ops.kernels.dispatch import feature_gather

AGGS = ("sum", "mean", "max", "min")


def _spmm_inputs(d, seed=0, n=60, b=9, cap=6):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, n, (b, cap)).astype(np.int32)
    # ragged, with an empty row and a full row
    deg = np.array([cap, 0, 1, 3, cap, 2, 0, 5, 4], np.int32)[:b]
    return feats, ids, deg


@pytest.mark.parametrize("d", [128, 8])
def test_gather_rows_plain_bitwise_equals_pallas(d):
    rng = np.random.default_rng(d)
    table = rng.standard_normal((97, d)).astype(np.float32)
    idx = rng.integers(0, 97, 45).astype(np.int32)
    ref = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                     interpret=True))
    out = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert out.dtype == torch.float32 and out.shape == (45, d)
    # bitwise: compare the raw 32-bit patterns
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))


def test_feature_gather_clips_like_the_jax_dispatch():
    # out-of-range indices are clipped into the table, as
    # graph_learn_tpu/ops/pallas/dispatch.py feature_gather does
    from graph_learn_tpu.ops.pallas.dispatch import \
        feature_gather as jax_feature_gather
    rng = np.random.default_rng(1)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    idx = np.array([[0, 19, 25], [-3, 7, 20]], np.int32)
    ref = np.asarray(jax_feature_gather(jnp.asarray(table), jnp.asarray(idx)))
    out = feature_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert out.shape == (2, 3, 8)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("d", [128, 8])
@pytest.mark.parametrize("agg", AGGS)
def test_segment_spmm_plain_matches_pallas_and_xla(agg, d):
    feats, ids, deg = _spmm_inputs(d)
    jf, ji, jd = jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(deg)
    out = spmm.segment_spmm(torch.from_numpy(feats), torch.from_numpy(ids),
                            torch.from_numpy(deg), agg=agg).numpy()
    # f32 sums over at most 6 rows in another order: rtol 1e-5, atol 1e-6
    np.testing.assert_allclose(out, np.asarray(segment_spmm_xla(jf, ji, jd,
                                                                agg=agg)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jax_segment_spmm(
        jf, ji, jd, agg=agg, interpret=True)), rtol=1e-5, atol=1e-6)
    # an empty row is 0 for every aggregation
    assert not out[1].any() and not out[6].any()


@pytest.mark.parametrize("agg", AGGS)
def test_segment_spmm_bf16_accumulates_in_f32(agg):
    feats, ids, deg = _spmm_inputs(128, seed=3)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    out = spmm.segment_spmm(fb, torch.from_numpy(ids), torch.from_numpy(deg),
                            agg=agg, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    # reference: the same bf16 values widened to f32 first; the sums are
    # exact-ish in f32, so rtol 1e-5, atol 1e-6
    ref = segment_spmm_xla(jnp.asarray(fb.float().numpy()), jnp.asarray(ids),
                           jnp.asarray(deg), agg=agg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the default output dtype is the features' (as spmm.py:106 writes)
    assert spmm.segment_spmm(fb, torch.from_numpy(ids), torch.from_numpy(deg),
                             agg=agg).dtype == torch.bfloat16


def test_segment_spmm_wrapper_clips_ids_and_degrees():
    # the kernel has no bounds checks: the wrapper clips, as
    # graph_learn_tpu/ops/aggregate.py:107-113 does before the Pallas call
    feats, ids, deg = _spmm_inputs(8, seed=4)
    bad_ids = ids.copy()
    bad_ids[0, 0], bad_ids[2, 0] = -5, 10_000
    bad_deg = deg.copy()
    bad_deg[0], bad_deg[3] = 99, -2
    out = spmm.segment_spmm(torch.from_numpy(feats), torch.from_numpy(bad_ids),
                            torch.from_numpy(bad_deg), agg="sum").numpy()
    ref = segment_spmm_xla(jnp.asarray(feats),
                           jnp.clip(jnp.asarray(bad_ids), 0, 59),
                           jnp.clip(jnp.asarray(bad_deg), 0, 6), agg="sum")
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["mean", "sum", "max"])
@pytest.mark.parametrize("d", [128, 8])
def test_gather_group_agg_matches_jax(op, d):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((150, d)).astype(np.float32)
    idx = rng.integers(0, 150, (4, 3, 5)).astype(np.int32)
    ref = np.asarray(jax_gather_group_agg(jnp.asarray(table),
                                          jnp.asarray(idx), op=op))
    out = gather_group_agg(torch.from_numpy(table), torch.from_numpy(idx),
                           op=op)
    assert out.shape == (12, d) and out.dtype == torch.float32
    # f32 means of 5 rows, summed in another order: rtol 1e-5, atol 1e-6
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", AGGS)
def test_embedding_agg_matches_jax(op):
    feats, ids, deg = _spmm_inputs(8, seed=6)
    ref = np.asarray(jax_embedding_agg(jnp.asarray(feats), jnp.asarray(ids),
                                       jnp.asarray(deg), op=op))
    out = embedding_agg(torch.from_numpy(feats), torch.from_numpy(ids),
                        torch.from_numpy(deg), op=op).numpy()
    # the XLA path leaves +-inf in an empty max/min row; the kernel (and
    # the Pallas kernel it replaces) writes 0 there
    ref = np.where(np.isfinite(ref), ref, 0.0)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("call", ["gather", "spmm"])
def test_wrappers_refuse_non_cpu_tensors_without_a_kernel(call):
    # a tensor that is not on the CPU never takes the plain version: off
    # the card (here a meta tensor) the wrapper raises
    before = (gather.LAUNCHES.count, spmm.LAUNCHES.count)
    table = torch.empty((10, 4), device="meta")
    ids = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    with pytest.raises(InvalidArgumentError):
        if call == "gather":
            gather.gather_rows(table, ids[:, 0].contiguous())
        else:
            spmm.segment_spmm(table, ids, ids[:, 0].contiguous())
    # the plain version on CPU tensors is no launch
    gather.gather_rows(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32))
    assert (gather.LAUNCHES.count, spmm.LAUNCHES.count) == before


def test_segment_spmm_rejects_unknown_aggregation():
    feats, ids, deg = _spmm_inputs(8)
    with pytest.raises(InvalidArgumentError):
        spmm.segment_spmm(torch.from_numpy(feats), torch.from_numpy(ids),
                          torch.from_numpy(deg), agg="prod")
