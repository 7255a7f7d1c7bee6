"""Segment primitives over flat CSR rows.

Counterpart of ``graph_learn_tpu/ops/segment.py`` ``row_bounds:173``,
``segmented_searchsorted:82``, ``segment_member:123``, ``row_member:142``,
``set_member:189`` and ``segment_softmax:196`` (the last two in plain
PyTorch: the JAX ones are XLA), with ``segment_sum`` and ``take_rows``,
the deterministic forms of ``jax.ops.segment_sum`` and of row indexing
that the SubGraph convs and ``segment_softmax`` differentiate through.  The tiled gathers of the JAX package (``flat_gather``,
``pair_gather``) and ``row_member``'s 128-lane window exist for the TPU's
layout only; flat tensors index directly here.  Membership bisects the
row's id-sorted copy where the store has one, and otherwise scans the
flat row in passes of ``SCAN_CHUNK`` positions, as many as the widest
row needs: rows of any degree are answered, where the JAX package's
window takes rows of at most 256 and needs the sorted copy beyond that.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# row positions compared per pass when a row is scanned (membership here,
# a filter's excluded slot in ops/sampling.py)
SCAN_CHUNK = 256


def row_bounds(row_offsets: torch.Tensor, rows: torch.Tensor):
    """(start, end, degree) of each row, any batch shape."""
    start = row_offsets[rows]
    end = row_offsets[rows + 1]
    return start, end, end - start


def bisect_iters(n: int) -> int:
    """Bisection steps that cover a segment of up to ``n`` entries."""
    return max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)


def segmented_searchsorted(vals: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor, queries: torch.Tensor,
                           side: str = "left",
                           iters: Optional[int] = None) -> torch.Tensor:
    """Per-query binary search within [lo_i, hi_i) of a flat array that is
    sorted ascending inside each segment.

    Counterpart of ``graph_learn_tpu/ops/segment.py:82`` in its bisection
    form, the same comparisons in the same order (the window form is TPU
    layout).  ``lo`` / ``hi`` broadcast to ``queries``; ``iters`` bounds
    the steps (pass ``bisect_iters(max segment length)``).  Returns global
    flat insertion positions with lo <= pos <= hi, int32.
    """
    e = vals.shape[0]
    if iters is None:
        iters = bisect_iters(e)
    q = queries
    lo = torch.broadcast_to(lo, q.shape).to(torch.int32)
    hi = torch.broadcast_to(hi, q.shape).to(torch.int32)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        v = vals[torch.clamp(mid, 0, max(e - 1, 0)).long()]
        go_right = v < q if side == "left" else v <= q
        open_ = lo < hi
        lo, hi = (torch.where(go_right & open_, mid + 1, lo),
                  torch.where(go_right | ~open_, hi, mid))
    return lo


def segment_member(sorted_ids: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, queries: torch.Tensor,
                   iters: Optional[int] = None) -> torch.Tensor:
    """Is each query id present in its segment [lo, hi) of ``sorted_ids``
    (ascending inside each segment)?  ``lo`` / ``hi`` broadcast to
    ``queries``."""
    e = sorted_ids.shape[0]
    pos = segmented_searchsorted(sorted_ids, lo, hi, queries, side="left",
                                 iters=iters)
    found = sorted_ids[torch.clamp(pos, 0, max(e - 1, 0)).long()] == queries
    return (pos < torch.broadcast_to(hi, queries.shape)) & found


def row_member(csr, rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Is each query id in its row's neighbour list?  ``rows`` [b],
    ``queries`` [b, ...] -> bool of ``queries``' shape: by bisection over
    the row's id-sorted copy (``csr.nbr_ids_sorted``), or where the store
    has none (the "minimal" profile) by :func:`scan_member`."""
    start, end, _ = row_bounds(csr.row_offsets, rows)
    if csr.nbr_ids_sorted is None:
        return scan_member(csr, start, end, queries)
    shape = (rows.shape[0],) + (1,) * (queries.dim() - 1)
    return segment_member(csr.nbr_ids_sorted, start.reshape(shape),
                          end.reshape(shape), queries,
                          iters=bisect_iters(csr.max_degree))


def scan_member(csr, start: torch.Tensor, end: torch.Tensor,
                queries: torch.Tensor) -> torch.Tensor:
    """Is each query id among ``csr.nbr_ids[start_i:end_i]``?  ``start`` /
    ``end`` [b], ``queries`` [b, ...] -> bool of ``queries``' shape.

    The rows are compared in passes of ``SCAN_CHUNK`` positions, as many
    as ``csr.max_degree`` needs: a loop fixed on the host, with positions
    clamped into the table and masked by ``end``, so no value is read back
    and the scan can be captured in a CUDA graph."""
    b = queries.shape[0]
    q = queries.reshape(b, -1)
    hit = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    e = csr.nbr_ids.shape[0]
    if e:
        width = max(1, min(csr.max_degree, SCAN_CHUNK))
        ar = torch.arange(width, dtype=start.dtype, device=start.device)
        for c0 in range(0, max(csr.max_degree, 1), width):
            pos = start[:, None] + (ar + c0)[None, :]
            nbr = csr.nbr_ids[torch.clamp(pos, 0, e - 1)]
            valid = pos < end[:, None]
            hit |= ((nbr[:, None, :] == q[:, :, None])
                    & valid[:, None, :]).any(dim=-1)
    return hit.reshape(queries.shape)


def set_member(sorted_set: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Is each query in ``sorted_set`` (one ascending 1-D array, -1
    padding allowed)?  Bool of ``queries``' shape."""
    pos = torch.searchsorted(sorted_set, queries.contiguous())
    pos = torch.clamp(pos, 0, sorted_set.shape[0] - 1)
    return sorted_set[pos] == queries


class _SegmentSum(torch.autograd.Function):
    """Rows of ``values`` [N, d] summed into ``n`` segments by the sorted
    reduction of ``embedding``'s backward (no float atomics, so the same
    inputs give the same bits on the card); the backward is a row take."""

    @staticmethod
    def forward(ctx, values, seg, n):
        ctx.save_for_backward(seg)
        return torch.ops.aten.embedding_dense_backward(values, seg, n, -1,
                                                       False)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        return grad.index_select(0, seg), None, None


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``values`` [N, ...] summed by
    ``segment_ids`` [N] into [num_segments, ...]; a row whose id lies
    outside [0, num_segments) is dropped.  Deterministic on the card,
    forward and backward (``index_add_`` adds with atomics in no fixed
    order)."""
    n = num_segments
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    flat = values.reshape(values.shape[0], -1)
    out = _SegmentSum.apply(flat, seg, n + 1)[:n]
    return out.reshape((n,) + tuple(values.shape[1:]))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a table [n, ...] that may require a gradient:
    the rows are taken by ``embedding``, whose backward sums them by a
    sorted reduction (indexing's backward adds with atomics)."""
    rows = F.embedding(idx.long(), table.reshape(table.shape[0], -1))
    return rows.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def segment_softmax(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of ``values`` [N, ...] within the segments ``segment_ids``
    [N] (each in [0, num_segments)), shifted by each segment's max.
    Entries where ``mask`` is False get 0 and take no share; a segment
    with no entry (or none unmasked) is left out, as the JAX package's
    ``jax.ops.segment_max`` / ``segment_sum`` leave it.  The shift is
    held out of the gradient (the softmax does not depend on it), and the
    sums and takes are :func:`segment_sum` / :func:`take_rows`, so the
    function and its gradient are deterministic on the card."""
    if mask is not None:
        values = torch.where(mask, values, float("-inf"))
    seg = segment_ids.long()
    wide = seg.reshape((-1,) + (1,) * (values.dim() - 1)).expand(
        values.shape)
    seg_max = torch.full((num_segments,) + tuple(values.shape[1:]),
                         float("-inf"), dtype=values.dtype,
                         device=values.device)
    seg_max = seg_max.scatter_reduce(0, wide, values.detach(), "amax",
                                     include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(values - seg_max[seg])
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    seg_sum = segment_sum(ex, seg, num_segments)
    return ex / torch.clamp(take_rows(seg_sum, seg), min=1e-16)
