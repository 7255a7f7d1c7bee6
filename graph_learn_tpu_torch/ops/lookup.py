"""Attribute lookup: node payloads into ``Nodes``, edge payloads.

Counterpart of ``graph_learn_tpu/ops/lookup.py`` ``_g:25``,
``lookup_nodes:65``, ``lookup_sparse_nodes:84`` and ``edge_payload:100``
on a single device, and of the non-sharded branch of
``graph_learn_tpu/core/sharding.py edge_field:327``.  Payloads other than
the float features (raw ids, labels, weights, timestamps, the int and
multi-value attribute columns and their lengths) are plain indexing with
the ids clipped into the table, as ``_g:25-33`` (the JAX package sends the
2-D int tables to XLA's gather, not to a Pallas kernel).
Float feature rows (the edge features too) are not gathered here:
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
    """``arr`` at ``idx`` (clipped into the table); None stays None."""
    if arr is None:
        return None
    return arr[torch.clamp(idx, 0, arr.shape[0] - 1)]


def _rows(arr: Optional[torch.Tensor], idx: torch.Tensor):
    """The float feature rows of ``arr`` at ``idx``, deferred."""
    if arr is None:
        return None
    return DeferredRows(table=arr, idx=idx)


def _payload(table, ids: torch.Tensor) -> dict:
    """Every payload field of a node table at ``ids``."""
    return dict(raw_ids=_g(table.raw_ids, ids),
                int_attrs=_g(table.int_attrs, ids),
                float_attrs=_rows(table.float_attrs, ids),
                multival_attrs=_g(table.multival_attrs, ids),
                multival_lens=_g(table.multival_lens, ids),
                weights=_g(table.weights, ids),
                labels=_g(table.labels, ids),
                timestamps=_g(table.timestamps, ids))


def lookup_nodes(table: DeviceNodeTable, ids: torch.Tensor,
                 type_name: str = "",
                 out_degrees: Optional[torch.Tensor] = None) -> Nodes:
    """ids: dense indices, any shape -> Nodes with the full payload (feature
    rows deferred)."""
    ids = ids.to(torch.int32)
    return Nodes(ids=ids, out_degrees=out_degrees, type_name=type_name,
                 **_payload(table, ids))


def lookup_sparse_nodes(table: DeviceNodeTable, ids: torch.Tensor,
                        degrees: torch.Tensor,
                        type_name: str = "") -> SparseNodes:
    """ids [b, cap] + degrees [b] -> SparseNodes with the full payload
    (feature rows deferred, as for ``Nodes``)."""
    ids = ids.to(torch.int32)
    return SparseNodes(ids=ids, degrees=degrees, type_name=type_name,
                       **_payload(table, ids))


def edge_field(et: DeviceEdgeTable, name: str,
               edge_ids: torch.Tensor) -> Optional[torch.Tensor]:
    """A per-edge field (``src``, ``dst``, ...) at edge row ids; a -1 pad
    reads row 0 (masked downstream)."""
    arr = getattr(et, name)
    if arr is None:
        return None
    return arr[torch.clamp(edge_ids, min=0)]


def edge_payload(et: DeviceEdgeTable, edge_ids: torch.Tensor) -> dict:
    """{"weights", "labels", "timestamps", "int_attrs", "float_attrs",
    "multival_attrs", "multival_lens"} at edge row ids (-1 = pad): the
    weights are 0 where the edge id is -1, the other fields read edge row 0
    there, as in the JAX package; the float features are deferred; a field
    the table lacks is None."""
    valid = edge_ids >= 0
    idx = torch.clamp(edge_ids, min=0)
    w = edge_field(et, "weights", edge_ids)
    out = {"weights": None if w is None else torch.where(valid, w, 0.0),
           "float_attrs": _rows(et.float_attrs, idx)}
    for name in ("labels", "timestamps", "int_attrs", "multival_attrs",
                 "multival_lens"):
        out[name] = edge_field(et, name, edge_ids)
    return out
