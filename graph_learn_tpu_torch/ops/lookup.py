"""Attribute lookup: node payloads into ``Nodes``.

Counterpart of ``graph_learn_tpu/ops/lookup.py`` ``_g:25`` and
``lookup_nodes:65`` on a single device.  1-D payloads (raw ids, labels,
weights) are plain indexing.  Feature rows (2-D tables) are not gathered
here: ``float_attrs`` is a ``DeferredRows`` over the table, gathered by
``feature_gather`` (Kernel 1 on the card) where a reader materialises it,
or reduced by Kernel 2 without a gather (core/values.py).  The sharded
branches wait for the parallel slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_learn_tpu_torch.core.store import DeviceNodeTable
from graph_learn_tpu_torch.core.values import DeferredRows, Nodes


def _g(arr: Optional[torch.Tensor], idx: torch.Tensor):
    if arr is None:
        return None
    if arr.dim() == 2:
        return DeferredRows(table=arr, idx=idx)
    return arr[torch.clamp(idx, 0, arr.shape[0] - 1)]


def lookup_nodes(table: DeviceNodeTable, ids: torch.Tensor,
                 type_name: str = "",
                 out_degrees: Optional[torch.Tensor] = None) -> Nodes:
    """ids: dense indices, any shape -> Nodes with the full payload (feature
    rows deferred)."""
    ids = ids.to(torch.int32)
    return Nodes(
        ids=ids,
        raw_ids=_g(table.raw_ids, ids),
        float_attrs=_g(table.float_attrs, ids),
        weights=_g(table.weights, ids),
        labels=_g(table.labels, ids),
        out_degrees=out_degrees,
        type_name=type_name)
