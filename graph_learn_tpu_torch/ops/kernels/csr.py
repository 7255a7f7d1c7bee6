"""The CSR order of one direction of an edge table: by row, then by a key,
ties by edge id.

Replaces no Pallas kernel.  The JAX package builds its CSR on the host
(``graph_learn_tpu/core/store.py`` ``_build_csr``, a stable ``np.lexsort``),
and so does the port's CPU view (``core/store.py _build_csr``); on a card
this builds the same order there, from the edge arrays the device view
keeps, so the view's set-up no longer waits for the host sort.  The CUDA
source is ``csrc/csr.cu``; its note gives the bound (bytes: ``rows``,
``cols`` and a 4-byte key read once, ``nbr_ids`` and ``nbr_edge_ids``
written once, 20 bytes an edge: 2.47 GB or 0.74 ms at 3.35 TB/s for the
123 718 280 edges of the benchmark's store) and the design: a counting
scatter of edge ids into their rows' slots, then a sort of each row by
(key, edge id), a warp per row up to :data:`WARP_ROWS` edges, past that a
block per row sorting tiles of :data:`TILE_ROWS` and merging them in a
scratch buffer.  The rows past the warp tier are counted under the
tracer's ``store.csr.long_rows``.

The key is compared as the host compares it: NaN last, -0.0 equal to
+0.0, a float key taken descending where the host sorts ``-key``.  The
edge id breaks every tie, so the result does not depend on the order of
the scatter's atomics, and each output equals the host's bit for bit.

A CUDA tensor launches the kernels (or raises); CPU tensors take
:func:`host_order` and the permutes, the host build's own code.  Both sit
behind one operator, ``torch.ops.glt.csr_order``; :func:`csr_order` checks
its inputs, then calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.build import LaunchCounter, library
from graph_learn_tpu_torch.utils import profiling

LAUNCHES = LaunchCounter("csr_order")
# the tiers of csrc/csr.cu (kWarpCap, kTileCap): rows of up to WARP_ROWS
# edges take a warp, longer ones a block that sorts tiles of TILE_ROWS in
# shared memory and merges them in a scratch buffer
WARP_ROWS = 256
TILE_ROWS = 2048
# scratch items of one batch of rows past WARP_ROWS (two buffers of this
# many; more where one row alone needs more)
LONG_BATCH_ITEMS = 1 << 21
_KINDS = {None: 0, torch.float32: 1, torch.int32: 2, torch.float64: 3}
_ITEM_BYTES = {0: 8, 1: 8, 2: 8, 3: 16}


def _stable_order(rows: np.ndarray, key: np.ndarray) -> np.ndarray:
    """``np.lexsort((key, rows))``: by row, then by key, ties in input
    order.  Where the key is integral and in [0, 2**32) (timestamps, ids)
    one stable argsort of ``row * 2**32 + key`` gives the same order in
    about a third of the time."""
    if (key.size and key.dtype.kind in "iuf" and key.min() >= 0
            and key.max() < 2 ** 32 and rows.max() < 2 ** 31
            and (key.dtype.kind != "f" or np.array_equal(key,
                                                         np.floor(key)))):
        return np.argsort((rows.astype(np.int64) << 32)
                          | key.astype(np.int64), kind="stable")
    return np.lexsort((key, rows))


def host_order(rows: np.ndarray, key: Optional[np.ndarray] = None,
               descending: bool = False) -> np.ndarray:
    """The CSR order on the host: stably by row, then by ``key`` (by
    ``-key`` when ``descending``), ties in input order."""
    if key is None:
        return np.argsort(rows, kind="stable")
    return _stable_order(rows, -key if descending else key)


def _lib():
    lib = library("csr")
    if lib.glt_csr_scatter.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # warp cap, block cap, key kind, item bytes
        lib.glt_csr_check.argtypes = [i32, i32, i32, i32]
        # rows, row offsets, cursor, eid, edges, rows of the CSR, stream
        lib.glt_csr_scatter.argtypes = [p, p, p, p, i64, i64, p]
        # row offsets, rows, eid, nbr, cols, key, kind, descending, stream
        lib.glt_csr_sort_rows.argtypes = [p, i64, p, p, p, p, i32, i32, p]
        # row offsets, listed rows, their scratch offsets, count, eid, nbr,
        # cols, key, kind, descending, scratch a, scratch b, stream
        lib.glt_csr_sort_listed.argtypes = [p, p, p, i64, p, p, p, p, i32,
                                            i32, p, p, p]
        for fn in (lib.glt_csr_check, lib.glt_csr_scatter,
                   lib.glt_csr_sort_rows, lib.glt_csr_sort_listed):
            fn.restype = i32
    return lib


def _ok(rc: int, what: str):
    if rc != 0:
        raise RuntimeError("csr_order %s failed: CUDA error %d" % (what, rc))


def _batches(lens: np.ndarray) -> Tuple[int, list]:
    """Rows past WARP_ROWS (their lengths ``lens``) in consecutive
    batches: (scratch items a buffer, [(first, end, offsets)])."""
    cap = max(LONG_BATCH_ITEMS, int(lens.max()))
    out, first, used = [], 0, 0
    offs = np.zeros(lens.size, dtype=np.int64)
    for i, m in enumerate(lens.tolist()):
        if used + m > cap:
            out.append((first, i, offs[first:i]))
            first, used = i, 0
        offs[i] = used
        used += m
    out.append((first, lens.size, offs[first:]))
    return cap, out


def _launch_order(rows: torch.Tensor, cols: torch.Tensor,
                  row_offsets: torch.Tensor, key: Optional[torch.Tensor],
                  descending: bool, stream: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' launches on ``stream``, with outputs and scratch on the
    inputs' device: (nbr_ids, nbr_edge_ids)."""
    dev, e, n = rows.device, rows.shape[0], row_offsets.shape[0] - 1
    nbr = torch.empty(e, dtype=torch.int32, device=dev)
    eids = torch.empty(e, dtype=torch.int32, device=dev)
    if e == 0 or n <= 0:
        return nbr, eids
    kind = _KINDS[None if key is None else key.dtype]
    lib = _lib()
    _ok(lib.glt_csr_check(WARP_ROWS, TILE_ROWS, kind, _ITEM_BYTES[kind]),
        "tier check (csrc/csr.cu and this module disagree)")
    kptr, desc = (0 if key is None else key.data_ptr()), int(descending)
    cursor = torch.zeros(n, dtype=torch.int32, device=dev)
    _ok(lib.glt_csr_scatter(rows.data_ptr(), row_offsets.data_ptr(),
                            cursor.data_ptr(), eids.data_ptr(), e, n,
                            stream), "scatter")
    LAUNCHES.add()
    del cursor
    _ok(lib.glt_csr_sort_rows(row_offsets.data_ptr(), n, eids.data_ptr(),
                              nbr.data_ptr(), cols.data_ptr(), kptr, kind,
                              desc, stream), "warp tier")
    LAUNCHES.add()
    deg = row_offsets[1:] - row_offsets[:-1]
    listed = torch.nonzero(deg > WARP_ROWS).flatten()
    if listed.numel() == 0:
        return nbr, eids
    lens = deg[listed].cpu().numpy().astype(np.int64)
    listed = listed.cpu().numpy().astype(np.int32)
    profiling.count("store.csr.long_rows", int(listed.size))
    cap, batches = _batches(lens)
    item = _ITEM_BYTES[kind]
    scratch = torch.empty(2 * cap * item, dtype=torch.uint8, device=dev)
    a, b = scratch.data_ptr(), scratch.data_ptr() + cap * item
    for first, end, offs in batches:
        rows_t = torch.from_numpy(listed[first:end]).to(dev)
        offs_t = torch.from_numpy(offs).to(dev)
        _ok(lib.glt_csr_sort_listed(
            row_offsets.data_ptr(), rows_t.data_ptr(), offs_t.data_ptr(),
            end - first, eids.data_ptr(), nbr.data_ptr(), cols.data_ptr(),
            kptr, kind, desc, a, b, stream), "long rows")
        LAUNCHES.add()
    return nbr, eids


@torch.library.custom_op("glt::csr_order", mutates_args=(),
                         device_types="cpu")
def _csr_order_op(rows: torch.Tensor, cols: torch.Tensor,
                  row_offsets: torch.Tensor, key: Optional[torch.Tensor],
                  descending: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    k = None
    if key is not None:
        k = key.numpy()
        # the host build's key: float weights and timestamps as float64
        k = k.astype(np.float64) if k.dtype.kind == "f" else k
    order = host_order(rows.numpy(), k, descending)
    return (torch.from_numpy(cols.numpy()[order].astype(np.int32)),
            torch.from_numpy(order.astype(np.int32)))


@_csr_order_op.register_fake
def _csr_order_fake(rows, cols, row_offsets, key, descending):
    return (rows.new_empty(rows.shape, dtype=torch.int32),
            rows.new_empty(rows.shape, dtype=torch.int32))


@_csr_order_op.register_kernel("cuda")
def _csr_order_cuda(rows, cols, row_offsets, key, descending):
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        return _launch_order(rows, cols, row_offsets, key, descending,
                             stream)


def csr_order(rows: torch.Tensor, cols: torch.Tensor,
              row_offsets: torch.Tensor, key: Optional[torch.Tensor] = None,
              descending: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows, cols [E] int32, row_offsets [N+1] int32 (the cumulative row
    counts of ``rows``), key [E] float32 / int32 / float64 or None ->
    (nbr_ids, nbr_edge_ids) [E] int32: ``cols`` and the edge ids in the
    CSR order.  ``descending`` takes a float key from the largest."""
    e = rows.shape[0]
    if (rows.dim() != 1 or cols.shape != rows.shape
            or row_offsets.dim() != 1 or rows.dtype != torch.int32
            or cols.dtype != torch.int32
            or row_offsets.dtype != torch.int32):
        raise InvalidArgumentError(
            "csr_order: want rows, cols [E] and row_offsets [N+1], int32; "
            "got %s %s, %s %s, %s %s"
            % (tuple(rows.shape), rows.dtype, tuple(cols.shape), cols.dtype,
               tuple(row_offsets.shape), row_offsets.dtype))
    if key is not None and (key.shape != rows.shape
                            or key.dtype not in _KINDS):
        raise InvalidArgumentError(
            "csr_order: key must be [E] float32, int32 or float64, got %s %s"
            % (tuple(key.shape), key.dtype))
    if descending and (key is None or not key.dtype.is_floating_point):
        raise InvalidArgumentError("csr_order: descending needs a float key")
    tensors = [rows, cols, row_offsets] + ([] if key is None else [key])
    if all(t.device.type == "cpu" for t in tensors):
        return _csr_order_op(rows, cols, row_offsets, key, descending)
    if not rows.is_cuda or any(t.device != rows.device for t in tensors):
        raise InvalidArgumentError(
            "csr_order: inputs must be on one CUDA device, got %s"
            % [str(t.device) for t in tensors])
    if not all(t.is_contiguous() for t in tensors):
        raise InvalidArgumentError("csr_order: inputs must be contiguous")
    if e >= 2 ** 31:
        raise InvalidArgumentError(
            "csr_order: %d edges; edge ids are int32" % e)
    return _csr_order_op(rows, cols, row_offsets, key, descending)
