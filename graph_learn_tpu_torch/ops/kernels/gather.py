"""Kernel 1: feature-row gather ``out[m] = table[idx[m]]``.

Replaces ``graph_learn_tpu/ops/pallas/gather.py`` ``gather_rows:64``
(``_gather_kernel:34``).  The CUDA source is ``csrc/gather.cu``; its note
gives the bound (bytes: M rows read at random, M rows written) and the
design, which it picks itself by shape and alignment: bulk copies of each
row's 16-byte covering span into shared memory, a block's 128 rows in
flight, for 8-byte-granular rows past one wave of threads; else a lane
group per row with the widest vectors the row and pointers allow.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`gather_rows_plain`, the same function in plain PyTorch.  Like the
Pallas kernel it has no backward, so a table that requires a gradient is
refused rather than silently cut out of the graph.

Both routes sit behind one operator, ``torch.ops.glt.gather_rows``
(``torch.library.custom_op``): its CUDA implementation is the kernel's
launch, its CPU implementation the plain version, and its fake gives the
output's shape and dtype, so ``torch.export`` keeps a gather as one node
of the exported program (online/export.py) and the program launches the
kernel when it runs on the card.  :func:`gather_rows` checks its inputs,
then calls the operator.
"""

from __future__ import annotations

import ctypes

import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.build import LaunchCounter, library

LAUNCHES = LaunchCounter("gather_rows")
_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[idx]``."""
    return table[idx]


def _lib():
    lib = library("gather")
    fn = lib.glt_gather_rows
    if fn.argtypes is None:
        # table, n_rows, idx, out, m, row bytes, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("glt::gather_rows", mutates_args=(),
                         device_types="cpu")
def _gather_rows_op(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return gather_rows_plain(table, idx)


@_gather_rows_op.register_fake
def _gather_rows_fake(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.new_empty(tuple(idx.shape) + tuple(table.shape[1:]))


@_gather_rows_op.register_kernel("cuda")
def _gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    m, d = idx.shape[0], table.shape[1]
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    if m == 0 or d == 0:
        return out
    fn = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(), table.shape[0], idx.data_ptr(),
                out.data_ptr(), m, d * table.element_size(), stream)
    if rc != 0:
        raise RuntimeError("gather_rows kernel launch failed: CUDA error %d"
                           % rc)
    LAUNCHES.add()
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, D] (f32 or bf16), idx [M] int32 in [0, N) -> [M, D]."""
    if table.requires_grad:
        raise InvalidArgumentError(
            "gather_rows has no backward (feature tables are not "
            "parameters): the table must not require a gradient")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return _gather_rows_op(table, idx)
    if not table.is_cuda or idx.device != table.device:
        raise InvalidArgumentError(
            "gather_rows: table and idx must be on one CUDA device, got %s "
            "and %s" % (table.device, idx.device))
    if table.dim() != 2 or table.dtype not in _DTYPES:
        raise InvalidArgumentError(
            "gather_rows: table must be 2-D float32/bfloat16, got %s %s"
            % (tuple(table.shape), table.dtype))
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise InvalidArgumentError(
            "gather_rows: idx must be 1-D int32, got %s %s"
            % (tuple(idx.shape), idx.dtype))
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise InvalidArgumentError("gather_rows: inputs must be contiguous")
    return _gather_rows_op(table, idx)
