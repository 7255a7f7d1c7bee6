"""Aggregation of node features over fixed groups and sparse rows.

Counterpart of ``graph_learn_tpu/ops/aggregate.py`` ``gather_group_agg:39``
and ``embedding_agg:90``.  Both run on Kernel 2 (``segment_spmm``), which
gathers and reduces in one pass: ``gather_group_agg`` calls it with every
degree equal to the group size, so the [n_groups * k, D] gathered rows are
never written to memory.  The sorted-gather branch of the JAX package
(``conf.sorted_gather``, off by default there) is not ported.
"""

from __future__ import annotations

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.spmm import segment_spmm
from graph_learn_tpu_torch.utils.platform import torch_dtype


def gather_group_agg(table: torch.Tensor, idx: torch.Tensor,
                     op: str = "mean") -> torch.Tensor:
    """Reduce table rows in fixed groups: idx [..., k] -> [n_groups, D].

    ``table[idx].reshape(-1, k, D)`` reduced over k, accumulated in f32
    and returned in ``conf.compute_dtype``.
    """
    if op not in ("mean", "sum", "max"):
        raise InvalidArgumentError("unknown group aggregation op %r" % op)
    k = idx.shape[-1]
    ids = idx.reshape(-1, k)
    deg = torch.full((ids.shape[0],), k, dtype=torch.int32, device=idx.device)
    return segment_spmm(table, ids, deg, agg=op,
                        out_dtype=torch_dtype(conf.compute_dtype))


def embedding_agg(float_attrs: torch.Tensor, ids: torch.Tensor,
                  degrees: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce the float attrs of SparseNodes rows ([b, cap] + degrees [b])
    to one vector per row, in the attrs' dtype.  An empty max/min row is 0.
    """
    if op not in ("sum", "mean", "max", "min"):
        raise InvalidArgumentError(
            "aggregation op %r is not yet ported (sum/mean/max/min)" % op)
    return segment_spmm(float_attrs, ids, degrees, agg=op)
