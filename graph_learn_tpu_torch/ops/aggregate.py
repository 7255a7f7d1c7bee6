"""Aggregation of node features over segments, fixed groups and sparse rows.

Counterpart of ``graph_learn_tpu/ops/aggregate.py`` ``segment_aggregate:20``,
``gather_group_agg:39`` and ``embedding_agg:90``.

``gather_group_agg`` and ``embedding_agg`` run on Kernel 2
(``segment_spmm``), which gathers and reduces in one pass:
``gather_group_agg`` calls it with every degree equal to the group size, so
the [n_groups * k, D] gathered rows are never written to memory.  Under
``conf.sorted_gather`` (the JAX package's gate: a 2-D table of at least
``conf.sorted_gather_min_bytes``) a sum or mean instead sorts the row ids
(``sweep_prep``) and adds the rows in sorted order into their groups with
Kernel 4 (``sweep_aggregate``), the hand-written form of the JAX branch's
sorted gather + segment sum.  ``segment_aggregate`` is plain PyTorch, as
XLA computed it outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.spmm import segment_spmm
from graph_learn_tpu_torch.ops.kernels.sweep import (MAX_GROUPS,
                                                     sweep_aggregate,
                                                     sweep_prep)
from graph_learn_tpu_torch.utils import profiling
from graph_learn_tpu_torch.utils.platform import torch_dtype

_SCATTER_REDUCE = {"max": "amax", "min": "amin", "prod": "prod"}


def segment_aggregate(feats: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, op: str = "sum") -> torch.Tensor:
    """feats [n, d] grouped by segment_ids [n] -> [num_segments, d].

    An empty segment is 0 for sum / mean, 1 for prod and -inf / +inf for
    max / min, and a row whose id lies outside [0, num_segments) is
    dropped, as ``jax.ops.segment_*`` do.  Launches no hand-written
    kernel."""
    if op not in ("sum", "mean", "max", "min", "prod"):
        raise InvalidArgumentError("unknown aggregation op %r" % op)
    seg = segment_ids.long()
    # rows out of range go to one extra segment, cut off at the end: no
    # host sync, and no device-side assert on a CUDA tensor
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    shape = (num_segments + 1, feats.shape[1])
    if op in ("sum", "mean"):
        out = torch.zeros(shape, dtype=feats.dtype, device=feats.device)
        out.index_add_(0, seg, feats)
        if op == "mean":
            cnt = torch.zeros(num_segments + 1, dtype=feats.dtype,
                              device=feats.device)
            cnt.index_add_(0, seg, torch.ones_like(feats[:, 0]))
            out = out / torch.clamp(cnt, min=1.0)[:, None]
        return out[:num_segments]
    init = {"max": float("-inf"), "min": float("inf"), "prod": 1.0}[op]
    out = torch.full(shape, init, dtype=feats.dtype, device=feats.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(feats), feats,
                              reduce=_SCATTER_REDUCE[op],
                              include_self=True)[:num_segments]


def _use_sorted(table: torch.Tensor, n_groups: int, op: str) -> bool:
    """The JAX package's gate, plus what the sweep kernel can take: it only
    sums (the order of its terms does not matter to a max either, but a max
    gains nothing from Kernel 4 and keeps Kernel 2), and its packed hit
    word holds fewer than 2**18 groups."""
    return (conf.sorted_gather and table.dim() == 2
            and table.numel() * table.element_size()
            >= conf.sorted_gather_min_bytes
            and op in ("sum", "mean") and n_groups < MAX_GROUPS)


def gather_group_agg(table: torch.Tensor, idx: torch.Tensor,
                     op: str = "mean") -> torch.Tensor:
    """Reduce table rows in fixed groups: idx [..., k] -> [n_groups, D].

    ``table[idx].reshape(-1, k, D)`` reduced over k, accumulated in f32
    and returned in ``conf.compute_dtype``.  A max keeps inf, -inf and NaN
    as the JAX package's ``jnp.max`` / ``segment_max`` do (Kernel 2 with
    ``raw_extrema``: a group is never empty).
    """
    if op not in ("mean", "sum", "max"):
        raise InvalidArgumentError("unknown group aggregation op %r" % op)
    k = idx.shape[-1]
    n_groups = idx.numel() // k if k else 0
    compute = torch_dtype(conf.compute_dtype)
    with profiling.span("aggregate"):
        if k and _use_sorted(table, n_groups, op):
            flat = torch.clamp(idx.reshape(-1), 0,
                               max(table.shape[0] - 1, 0))
            starts, packed = sweep_prep(flat, k, table.shape[0])
            out = sweep_aggregate(starts, packed, table, n_groups)
            return (out / k if op == "mean" else out).to(compute)
        ids = idx.reshape(-1, k)
        deg = torch.full((ids.shape[0],), k, dtype=torch.int32,
                         device=idx.device)
        return segment_spmm(table, ids, deg, agg=op, out_dtype=compute,
                            raw_extrema=True)


def embedding_agg(float_attrs: torch.Tensor, ids: torch.Tensor,
                  degrees: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce the float attrs of SparseNodes rows ([b, cap] + degrees [b])
    to one vector per row, in the attrs' dtype.  An empty max/min row is 0.

    sum / mean / max / min run on Kernel 2.  ``prod`` launches no kernel:
    it is a masked product over the slots in plain PyTorch, as the JAX
    package leaves it to XLA (an empty row is 1).
    """
    if op == "prod":
        cap = ids.shape[1]
        safe = torch.clamp(ids, 0, max(float_attrs.shape[0] - 1, 0)).long()
        mask = (torch.arange(cap, device=ids.device)[None, :]
                < degrees[:, None])[..., None]
        return torch.where(mask, float_attrs[safe], 1.0).prod(dim=1)
    if op not in ("sum", "mean", "max", "min"):
        raise InvalidArgumentError("unknown aggregation op %r" % op)
    return segment_spmm(float_attrs, ids, degrees, agg=op)
