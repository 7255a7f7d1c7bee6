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


@pytest.mark.parametrize("call", ["gather", "feature_gather", "spmm",
                                  "group_agg"])
def test_wrappers_refuse_a_table_that_requires_a_gradient(call):
    # neither kernel has a backward (the Pallas kernels have none): a
    # table inside the graph must raise, not silently lose its gradient
    table = torch.zeros((10, 4), requires_grad=True)
    idx = torch.zeros((3, 2), dtype=torch.int32)
    deg = torch.ones(3, dtype=torch.int32)
    calls = {
        "gather": lambda t: gather.gather_rows(t, idx[:, 0].contiguous()),
        "feature_gather": lambda t: feature_gather(t, idx),
        "spmm": lambda t: spmm.segment_spmm(t, idx, deg),
        "group_agg": lambda t: gather_group_agg(t, idx),
    }
    with pytest.raises(InvalidArgumentError, match="gradient"):
        calls[call](table)
    calls[call](table.detach())  # the same table outside the graph is fine


def test_segment_spmm_rejects_unknown_aggregation():
    feats, ids, deg = _spmm_inputs(8)
    with pytest.raises(InvalidArgumentError):
        spmm.segment_spmm(torch.from_numpy(feats), torch.from_numpy(ids),
                          torch.from_numpy(deg), agg="prod")


# --- Kernel 2's launch on the card, prepared on CPU tensors ----------------

class _StubKernel:
    """Stands in for ``glt_segment_spmm``: records its arguments and returns
    ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.args = rc, None

    def __call__(self, *args):
        self.args = args
        return self.rc


def test_segment_spmm_cuda_branch_hands_the_kernel_unclipped_ids():
    # the kernel clips ids into [0, N - 1] and degrees into [0, cap] as it
    # reads them, so the CUDA branch passes the caller's int32 tensors as
    # they are: one launch, no clamp kernels
    feats, ids, deg = _spmm_inputs(8, seed=7)
    bad_ids = torch.from_numpy(ids)
    bad_ids[0, 0], bad_ids[2, 1] = -5, 10_000
    bad_deg = torch.from_numpy(deg)
    bad_deg[0], bad_deg[3] = 99, -2
    out = torch.empty((9, 8))
    args = spmm.kernel_args(torch.from_numpy(feats), bad_ids, bad_deg, "max",
                            out)
    assert args[1] == bad_ids.data_ptr() and args[2] == bad_deg.data_ptr()
    assert args[4:9] == (9, 6, 8, 60, 0)  # b, cap, d, N, f32 in
    assert args[10] == spmm.AGGS.index("max")
    stub = _StubKernel()
    spmm.launch(stub, args, 1234)
    assert stub.args[:-1] == args and stub.args[-1] == 1234
    # the values behind those pointers are still out of range
    assert int(bad_ids.min()) == -5 and int(bad_ids.max()) == 10_000
    assert int(bad_deg.min()) == -2 and int(bad_deg.max()) == 99


def test_segment_spmm_kernel_args_clip_and_cast_other_integer_types():
    # the kernel reads int32: int64 ids and degrees are clipped, then cast,
    # in the wrapper (a cast alone could wrap a large id around)
    feats, ids, deg = _spmm_inputs(8, seed=8)
    big = torch.from_numpy(ids).long()
    big[1, 2] = 2 ** 40
    long_deg = torch.from_numpy(deg).long()
    long_deg[4] = -7
    out = torch.empty((9, 8))
    args = spmm.kernel_args(torch.from_numpy(feats), big, long_deg, "sum",
                            out)
    assert args[1] != big.data_ptr() and args[2] != long_deg.data_ptr()
    want_ids, want_deg = spmm.clip(big, long_deg, 60)
    assert want_ids.dtype == want_deg.dtype == torch.int32
    assert int(want_ids[1, 2]) == 59 and int(want_deg[4]) == 0
    # a non-contiguous int32 view is made contiguous, not clipped
    view = torch.from_numpy(np.ascontiguousarray(ids.T)).t()
    assert not view.is_contiguous()
    args = spmm.kernel_args(torch.from_numpy(feats), view,
                            torch.from_numpy(deg), "sum", out)
    assert args[1] != view.data_ptr()


def test_segment_spmm_launch_raises_on_a_failed_launch():
    feats, ids, deg = _spmm_inputs(8)
    args = spmm.kernel_args(torch.from_numpy(feats), torch.from_numpy(ids),
                            torch.from_numpy(deg), "sum", torch.empty((9, 8)))
    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.launch(_StubKernel(rc=700), args, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.launch(_StubKernel(rc=-1), args, 0)  # a code it does not take


@pytest.mark.parametrize("d,dtype,out_dtype", [
    (128, torch.bfloat16, torch.float32),  # serving / training table
    (100, torch.bfloat16, torch.float32),  # the 62M-edge table
    (128, torch.float32, torch.float32),   # the harness bar
    (128, torch.bfloat16, torch.bfloat16),  # embedding_agg writes bf16
    (7, torch.bfloat16, torch.float32),
])
def test_kernel_args_at_the_main_path_shapes(d, dtype, out_dtype):
    # the shapes and dtype codes the C function reads; the vector width is
    # its own choice, by shape and alignment
    feats = torch.zeros((50, d), dtype=dtype)
    ids = torch.zeros((6, 10), dtype=torch.int32)
    deg = torch.full((6,), 10, dtype=torch.int32)
    out = torch.empty((6, d), dtype=out_dtype)
    args = spmm.kernel_args(feats, ids, deg, "mean", out)
    assert args[0] == feats.data_ptr() and args[3] == out.data_ptr()
    assert args[4:8] == (6, 10, d, 50)
    assert args[8:] == ((1 if dtype == torch.bfloat16 else 0),
                        (1 if out_dtype == torch.bfloat16 else 0),
                        spmm.AGGS.index("mean"))
