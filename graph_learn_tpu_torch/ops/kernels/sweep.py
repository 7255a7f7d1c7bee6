"""Kernels 4 and 5: sorted-hit group aggregation and the full-table sum.

They replace the two Pallas kernels of ``examples/sweep_aggregate.py``:
``make_sweep_kernel:39`` (Kernel 4, :func:`sweep_aggregate`) and
``make_stream_kernel:96`` (Kernel 5, :func:`stream_sum`);
:func:`sweep_prep` is the counterpart of ``make_prep:128`` and, like it, is
no kernel: a stable sort and a searchsorted in plain PyTorch.  The CUDA
source is ``csrc/sweep.cu``; its note gives the bounds (bytes: the hit
rows, not the table, for Kernel 4; the whole table for Kernel 5) and the
designs (a warp per 32 sorted hits, slabs found once a chunk, lanes
striding over (hit, column vector) pairs with four row loads in flight,
adding into an L2-resident output with ``red.global.add`` after a memset
of it on the stream; a grid-stride column sum with one pass of atomics
across blocks).

The hit list is the JAX package's format: the flat row ids sorted
(stably), each hit packed as ``row_in_slab | group << 12`` with
``group = position // k``, and ``starts[s]`` the first hit of slab ``s``
(slabs of ``R`` table rows).  So ``R`` is a power of two of at most 4096
and there are fewer than 2**18 groups.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version beside it.  Neither kernel has a backward: a table that
requires a gradient is refused.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.build import (LaunchCounter, library,
                                                 refuse_export)

LAUNCHES_SWEEP = LaunchCounter("sweep_aggregate")
LAUNCHES_STREAM = LaunchCounter("stream_sum")
MAX_SLAB_ROWS = 1 << 12  # the row inside its slab rides in the low 12 bits
MAX_GROUPS = 1 << 18  # the group id in the bits above: 2**30 > packed >= 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_slab_rows(R: int):
    if not (0 < R <= MAX_SLAB_ROWS and R & (R - 1) == 0):
        raise InvalidArgumentError(
            "the slab size must be a power of two <= %d, got %r"
            % (MAX_SLAB_ROWS, R))


def sweep_prep(flat: torch.Tensor, k: int, n_rows: int,
               R: int = MAX_SLAB_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat [N] table row ids in [0, n_rows), groups of ``k`` consecutive
    positions -> (starts [n_slabs + 1] int32, packed [N] int32).

    Bit-equal to the JAX harness's ``make_prep``: the sort is stable, as
    ``jnp.argsort`` is, so duplicate rows keep their order."""
    check_slab_rows(R)
    if flat.dim() != 1 or k <= 0:
        raise InvalidArgumentError(
            "sweep_prep: want flat [N] and k > 0, got %s, k=%r"
            % (tuple(flat.shape), k))
    if -(-flat.shape[0] // k) >= MAX_GROUPS:
        raise InvalidArgumentError(
            "sweep_prep: %d groups do not fit the packed hit word (fewer "
            "than %d)" % (-(-flat.shape[0] // k), MAX_GROUPS))
    n_slabs = -(-n_rows // R)
    rows_sorted, order = torch.sort(flat.to(torch.int32), stable=True)
    groups_sorted = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    slab_of = torch.div(rows_sorted, R, rounding_mode="floor")
    starts = torch.searchsorted(
        slab_of, torch.arange(n_slabs + 1, dtype=torch.int32,
                              device=flat.device)).to(torch.int32)
    packed = (rows_sorted - slab_of * R) | (groups_sorted << 12)
    return starts, packed


def unpack_hits(starts: torch.Tensor, packed: torch.Tensor,
                R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table rows [N], group ids [N]) of a packed hit list, int64."""
    pos = torch.arange(packed.shape[0], dtype=starts.dtype,
                       device=packed.device)
    slab = torch.searchsorted(starts.contiguous(), pos, right=True) - 1
    rows = slab * R + (packed & (R - 1)).long()
    return rows, (packed >> 12).long()


def sweep_aggregate_plain(starts: torch.Tensor, packed: torch.Tensor,
                          table: torch.Tensor, n_groups: int,
                          R: int) -> torch.Tensor:
    """Plain version: ``index_add_`` of the unpacked hit rows in f32."""
    rows, groups = unpack_hits(starts, packed, R)
    out = torch.zeros((n_groups, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    return out.index_add_(0, groups, table[rows].float())


def stream_sum_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 column sums, [1, D]."""
    return table.float().sum(0, keepdim=True)


def _fn(name: str, argtypes):
    fn = getattr(library("sweep"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_table(name: str, table: torch.Tensor):
    if table.requires_grad:
        raise InvalidArgumentError(
            "%s has no backward (feature tables are not parameters): the "
            "table must not require a gradient" % name)
    if table.dim() != 2:
        raise InvalidArgumentError("%s: table must be [n_rows, D], got %s"
                                   % (name, tuple(table.shape)))


def _check_cuda_table(name: str, table: torch.Tensor):
    if table.dtype not in _DTYPE_CODE:
        raise InvalidArgumentError("%s: float32/bfloat16 only, got %s"
                                   % (name, table.dtype))
    if not table.is_contiguous():
        raise InvalidArgumentError("%s: table must be contiguous" % name)


def sweep_aggregate(starts: torch.Tensor, packed: torch.Tensor,
                    table: torch.Tensor, n_groups: int,
                    R: int = MAX_SLAB_ROWS) -> torch.Tensor:
    """``out[g] = sum of table[slab * R + r]`` over the hits of
    :func:`sweep_prep` -> [n_groups, D] f32.

    On the card the adds of one group arrive in an order that changes from
    run to run, so two runs may differ in the last bits."""
    refuse_export("sweep_aggregate")
    _check_table("sweep_aggregate", table)
    check_slab_rows(R)
    n_slabs = -(-table.shape[0] // R)
    if starts.shape != (n_slabs + 1,) or packed.dim() != 1 \
            or starts.dtype != torch.int32 or packed.dtype != torch.int32:
        raise InvalidArgumentError(
            "sweep_aggregate: want int32 starts [%d] and packed [N] for a "
            "table of %d rows in slabs of %d, got %s %s and %s %s"
            % (n_slabs + 1, table.shape[0], R, tuple(starts.shape),
               starts.dtype, tuple(packed.shape), packed.dtype))
    if not 0 <= n_groups < MAX_GROUPS:
        raise InvalidArgumentError(
            "sweep_aggregate: n_groups must be in [0, %d), got %r"
            % (MAX_GROUPS, n_groups))
    devices = (table.device, starts.device, packed.device)
    if all(d.type == "cpu" for d in devices):
        return sweep_aggregate_plain(starts, packed, table, n_groups, R)
    if not table.is_cuda or any(d != table.device for d in devices):
        raise InvalidArgumentError(
            "sweep_aggregate: inputs must be on one CUDA device, got %s, %s, "
            "%s" % devices)
    _check_cuda_table("sweep_aggregate", table)
    starts, packed = starts.contiguous(), packed.contiguous()
    n, d = packed.shape[0], table.shape[1]
    # the C entry zeroes out with a memset on the stream, then launches
    out = torch.empty((n_groups, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    fn = _fn("glt_sweep_aggregate",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(starts.data_ptr(), packed.data_ptr(), table.data_ptr(),
                out.data_ptr(), n, n_slabs, R, table.shape[0], n_groups, d,
                _DTYPE_CODE[table.dtype], stream)
    if rc != 0:
        raise RuntimeError("sweep_aggregate kernel launch failed: CUDA error "
                           "%d" % rc)
    if n and n_slabs:
        LAUNCHES_SWEEP.add()
    return out


def stream_sum(table: torch.Tensor) -> torch.Tensor:
    """The whole table summed over its rows -> [1, D] f32: what reading
    the table once costs."""
    refuse_export("stream_sum")
    _check_table("stream_sum", table)
    if table.device.type == "cpu":
        return stream_sum_plain(table)
    if not table.is_cuda:
        raise InvalidArgumentError(
            "stream_sum: the table must be on a CUDA device or the CPU, got "
            "%s" % table.device)
    _check_cuda_table("stream_sum", table)
    n_rows, d = table.shape
    out = torch.zeros((1, d), dtype=torch.float32, device=table.device)
    if n_rows == 0 or d == 0:
        return out
    fn = _fn("glt_stream_sum",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(), out.data_ptr(), n_rows, d,
                _DTYPE_CODE[table.dtype], stream)
    if rc != 0:
        raise RuntimeError("stream_sum kernel launch failed: CUDA error %d"
                           % rc)
    LAUNCHES_STREAM.add()
    return out
