"""Attribute lookup: node payloads into ``Nodes``, edge payloads.

Counterpart of ``graph_learn_tpu/ops/lookup.py`` ``_g:25``,
``lookup_nodes:65``, ``lookup_sparse_nodes:84`` and ``edge_payload:100``
on a single device, and of the non-sharded branch of
``graph_learn_tpu/core/sharding.py edge_field:327``.  1-D
payloads (raw ids, labels, weights, edge timestamps) are plain indexing.
Feature rows (2-D tables, the edge features too) are not gathered here:
``float_attrs`` is a ``DeferredRows`` over the table, gathered by
``feature_gather`` (Kernel 1 on the card) where a reader materialises it,
or reduced by Kernel 2 without a gather (core/values.py).  The sharded
branches wait for the parallel slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_learn_tpu_torch.core.store import DeviceEdgeTable, DeviceNodeTable
from graph_learn_tpu_torch.core.values import (DeferredRows, Nodes,
                                              SparseNodes)


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


def lookup_sparse_nodes(table: DeviceNodeTable, ids: torch.Tensor,
                        degrees: torch.Tensor,
                        type_name: str = "") -> SparseNodes:
    """ids [b, cap] + degrees [b] -> SparseNodes with the full payload
    (feature rows deferred, as for ``Nodes``)."""
    ids = ids.to(torch.int32)
    return SparseNodes(
        ids=ids, degrees=degrees,
        raw_ids=_g(table.raw_ids, ids),
        float_attrs=_g(table.float_attrs, ids),
        weights=_g(table.weights, ids),
        labels=_g(table.labels, ids),
        type_name=type_name)


def edge_field(et: DeviceEdgeTable, name: str,
               edge_ids: torch.Tensor) -> Optional[torch.Tensor]:
    """A per-edge field (``src``, ``dst``, ...) at edge row ids; a -1 pad
    reads row 0 (masked downstream)."""
    arr = getattr(et, name)
    if arr is None:
        return None
    return arr[torch.clamp(edge_ids, min=0)]


def edge_payload(et: DeviceEdgeTable, edge_ids: torch.Tensor) -> dict:
    """{"weights", "labels", "timestamps", "float_attrs"} at edge row ids
    (-1 = pad): the weights are 0 where the edge id is -1, the other fields
    read edge row 0 there, as in the JAX package; the features are
    deferred; a field the table lacks is None."""
    valid = edge_ids >= 0
    idx = torch.clamp(edge_ids, min=0)
    w = edge_field(et, "weights", edge_ids)
    return {"weights": None if w is None else torch.where(valid, w, 0.0),
            "labels": edge_field(et, "labels", edge_ids),
            "timestamps": edge_field(et, "timestamps", edge_ids),
            "float_attrs": _g(et.float_attrs, idx)}
