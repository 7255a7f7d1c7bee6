"""Kernel 2: segment SpMM ``out[i] = reduce_{c < deg[i]} feats[ids[i, c]]``.

Replaces ``graph_learn_tpu/ops/pallas/spmm.py`` ``segment_spmm:76``
(``_spmm_kernel:27``) for sum / mean / max / min.  It accumulates in f32,
divides a mean by ``max(deg, 1)`` and writes 0 for an empty (or
non-finite) max/min row, as the Pallas kernel does; with ``raw_extrema``
it writes the max/min as it is (inf, -inf, NaN), the rule of the JAX
package's ``gather_group_agg``, whose groups are never empty.  The CUDA
source is ``csrc/spmm.cu``; its note
gives the bound (bytes: sum(deg) rows read, [b, D] written) and the design
(a lane group per output row on a grid of the card's resident blocks,
ids clipped as they are read, f32 accumulators in registers).

``out_dtype`` serves the two callers: ``embedding_agg`` writes the
features' dtype, as the Pallas kernel does; ``gather_group_agg`` writes
``conf.compute_dtype``.

``ids`` are clipped into the table and ``degrees`` into [0, cap], as
``graph_learn_tpu/ops/aggregate.py:107-113`` clips them before the Pallas
call: by the kernel itself on the card, so that one call is one launch
(:func:`kernel_args` hands it the caller's tensors), and by :func:`clip`
before :func:`segment_spmm_plain` on the CPU.  A CUDA tensor launches the
kernel (or raises); a CPU tensor takes :func:`segment_spmm_plain`.  Like
the Pallas kernel it has no backward: ``feats`` that require a gradient
are refused rather than silently cut out of the graph.

Both routes sit behind one operator, ``torch.ops.glt.segment_spmm``
(``torch.library.custom_op``): its CUDA implementation is the kernel's
launch, its CPU implementation the clip and the plain version, and its
fake gives the output's shape and dtype, so ``torch.export`` keeps the
reduction as one node of the exported program (online/export.py).
:func:`segment_spmm` checks its inputs, then calls the operator.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.build import LaunchCounter, library

LAUNCHES = LaunchCounter("segment_spmm")
AGGS = ("sum", "mean", "max", "min")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def segment_spmm_plain(feats: torch.Tensor, ids: torch.Tensor,
                       degrees: torch.Tensor, agg: str,
                       out_dtype: torch.dtype,
                       raw_extrema: bool = False) -> torch.Tensor:
    """Plain version on in-range ``ids`` / ``degrees``: gather, mask, reduce
    in f32."""
    b, cap = ids.shape
    if cap == 0:
        return torch.zeros((b, feats.shape[1]), dtype=out_dtype,
                           device=feats.device)
    g = feats[ids].float()  # [b, cap, D]
    pos = torch.arange(cap, device=ids.device)[None, :]
    mask = (pos < degrees[:, None])[..., None]
    if agg in ("sum", "mean"):
        s = torch.where(mask, g, 0.0).sum(dim=1)
        if agg == "mean":
            s = s / torch.clamp(degrees, min=1)[:, None].float()
    else:
        fill = float("-inf") if agg == "max" else float("inf")
        g = torch.where(mask, g, fill)
        s = g.amax(dim=1) if agg == "max" else g.amin(dim=1)
        if not raw_extrema:
            s = torch.where(torch.isfinite(s), s, 0.0)
    return s.to(out_dtype)


def _lib():
    fn = library("spmm").glt_segment_spmm
    if fn.argtypes is None:
        # feats, ids, deg, out, b, cap, d, n_rows, in/out dtype codes, agg,
        # raw extrema, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("glt::segment_spmm", mutates_args=(),
                         device_types="cpu")
def _segment_spmm_op(feats: torch.Tensor, ids: torch.Tensor,
                     degrees: torch.Tensor, agg: str, out_dtype: torch.dtype,
                     raw_extrema: bool) -> torch.Tensor:
    ids, degrees = clip(ids, degrees, feats.shape[0])
    return segment_spmm_plain(feats, ids, degrees, agg, out_dtype,
                              raw_extrema)


@_segment_spmm_op.register_fake
def _segment_spmm_fake(feats, ids, degrees, agg, out_dtype, raw_extrema):
    return feats.new_empty((ids.shape[0], feats.shape[1]), dtype=out_dtype)


@_segment_spmm_op.register_kernel("cuda")
def _segment_spmm_cuda(feats, ids, degrees, agg, out_dtype, raw_extrema):
    out = torch.empty((ids.shape[0], feats.shape[1]), dtype=out_dtype,
                      device=feats.device)
    if out.numel() == 0:
        return out
    args = kernel_args(feats, ids, degrees, agg, out, raw_extrema)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        launch(_lib(), args, stream)
    LAUNCHES.add()
    return out


def segment_spmm(feats: torch.Tensor, ids: torch.Tensor,
                 degrees: torch.Tensor, agg: str = "sum",
                 out_dtype: Optional[torch.dtype] = None,
                 raw_extrema: bool = False) -> torch.Tensor:
    """feats [N, D] (f32/bf16), ids [b, cap], degrees [b] -> [b, D]."""
    if feats.requires_grad:
        raise InvalidArgumentError(
            "segment_spmm has no backward (feature tables are not "
            "parameters): feats must not require a gradient")
    if agg not in AGGS:
        raise InvalidArgumentError("unknown aggregation %r (one of %r)"
                                   % (agg, AGGS))
    out_dtype = out_dtype or feats.dtype
    if feats.dim() != 2 or ids.dim() != 2 or degrees.shape != ids.shape[:1]:
        raise InvalidArgumentError(
            "segment_spmm: want feats [N, D], ids [b, cap], degrees [b]; got "
            "%s, %s, %s" % (tuple(feats.shape), tuple(ids.shape),
                            tuple(degrees.shape)))
    if feats.device.type == "cpu" and ids.device.type == "cpu" \
            and degrees.device.type == "cpu":
        return _segment_spmm_op(feats, ids, degrees, agg, out_dtype,
                                raw_extrema)
    if not feats.is_cuda or ids.device != feats.device \
            or degrees.device != feats.device:
        raise InvalidArgumentError(
            "segment_spmm: inputs must be on one CUDA device, got %s, %s, %s"
            % (feats.device, ids.device, degrees.device))
    if feats.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise InvalidArgumentError(
            "segment_spmm: float32/bfloat16 only, got %s -> %s"
            % (feats.dtype, out_dtype))
    if not feats.is_contiguous():
        raise InvalidArgumentError("segment_spmm: feats must be contiguous")
    return _segment_spmm_op(feats, ids, degrees, agg, out_dtype, raw_extrema)
    args = kernel_args(feats, ids, degrees, agg, out, raw_extrema)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        launch(_lib(), args, stream)
    LAUNCHES.add()
    return out


def clip(ids: torch.Tensor, degrees: torch.Tensor,
         n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids into [0, n_rows - 1] and degrees into [0, cap], int32, as
    ``graph_learn_tpu/ops/aggregate.py:107-113`` clips them."""
    return (torch.clamp(ids, 0, max(n_rows - 1, 0)).to(torch.int32),
            torch.clamp(degrees, 0, ids.shape[1]).to(torch.int32))


def kernel_args(feats: torch.Tensor, ids: torch.Tensor,
                degrees: torch.Tensor, agg: str, out: torch.Tensor,
                raw_extrema: bool = False) -> tuple:
    """The arguments of ``glt_segment_spmm`` before the stream: the kernel
    clips int32 ``ids`` and ``degrees`` itself, so those are passed as the
    caller has them (made contiguous); another integer type is clipped and
    cast here, as the kernel reads int32."""
    if ids.dtype != torch.int32 or degrees.dtype != torch.int32:
        clipped = clip(ids, degrees, feats.shape[0])
        ids = ids if ids.dtype == torch.int32 else clipped[0]
        degrees = degrees if degrees.dtype == torch.int32 else clipped[1]
    ids, degrees = ids.contiguous(), degrees.contiguous()
    (b, cap), (n_rows, d) = ids.shape, feats.shape
    return (feats.data_ptr(), ids.data_ptr(), degrees.data_ptr(),
            out.data_ptr(), b, cap, d, n_rows, _DTYPE_CODE[feats.dtype],
            _DTYPE_CODE[out.dtype], AGGS.index(agg), int(raw_extrema))


def launch(fn, args: tuple, stream: int):
    """Call ``fn`` (``glt_segment_spmm``) on ``args`` and ``stream``."""
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError("segment_spmm kernel launch failed: CUDA error %d"
                           % rc)
