"""Result value types: ``Nodes``, ``SparseNodes`` and ``DeferredRows``.

Counterparts of ``graph_learn_tpu/core/values.py:29-100`` as plain
dataclasses of tensors.  Shapes follow the JAX package: ``Nodes.ids`` is
[batch] or fanout-shaped [batch, k1, ...]; ``SparseNodes`` is the cap +
degrees form of variable-degree results.

Feature rows are looked up where they are read.  Under ``jit`` the JAX
package gathers every hop's rows and lets XLA drop the gathers nobody
reads; an eager port would pay for each of them.  So a looked-up
``Nodes.float_attrs`` is a :class:`DeferredRows` (table + indices), and its
reader either materialises it (Kernel 1) or reduces it straight from the
table (Kernel 2).  ``DeferredRows`` is the JAX package's
``nn/data.py:25`` class, moved here because lookups make it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


class TensorStruct:
    """``replace`` and ``map`` for the port's dataclasses of tensors."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable[[torch.Tensor], Any]):
        """Apply ``fn`` to every batch tensor field (nested structs
        included); fields marked ``static`` (a whole table) are kept."""
        changes = {}
        for f in dataclasses.fields(self):
            if f.metadata.get("static"):
                continue
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                changes[f.name] = fn(v)
            elif isinstance(v, TensorStruct):
                changes[f.name] = v.map(fn)
        return self.replace(**changes)


@dataclasses.dataclass
class Nodes(TensorStruct):
    """A batch of nodes (possibly fanout-shaped)."""

    ids: torch.Tensor  # int32 dense indices, [*]
    raw_ids: Optional[torch.Tensor] = None  # int64 source ids
    # [*, n_float] features, or a stand-in: DeferredRows (rows not yet
    # gathered) or nn/data.py PreAggregatedRows
    float_attrs: Any = None
    weights: Optional[torch.Tensor] = None  # [*] f32
    labels: Optional[torch.Tensor] = None  # [*] int32
    out_degrees: Optional[torch.Tensor] = None  # [*] int32
    type_name: str = ""


@dataclasses.dataclass
class SparseNodes(TensorStruct):
    """Variable-degree nodes as [b, cap] ids plus [b] true degrees."""

    ids: torch.Tensor  # [b, cap] int32
    degrees: torch.Tensor  # [b] int32
    raw_ids: Optional[torch.Tensor] = None
    float_attrs: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    type_name: str = ""


@dataclasses.dataclass
class DeferredRows(TensorStruct):
    """An unmaterialised feature-row gather: table + hop-shaped indices.

    :meth:`materialize` gathers the rows (Kernel 1 on the card);
    :meth:`group_agg` reduces them over the trailing fanout axis straight
    from the table (Kernel 2), so the [..., k, D] rows are never written.
    """

    table: torch.Tensor = dataclasses.field(metadata={"static": True})
    idx: torch.Tensor  # hop-shaped int indices

    def materialize(self) -> torch.Tensor:
        from graph_learn_tpu_torch.ops.kernels.dispatch import feature_gather
        return feature_gather(self.table, self.idx)

    def group_agg(self, op: str = "mean") -> torch.Tensor:
        """[n_groups, D] reduction over the trailing fanout axis."""
        from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
        return gather_group_agg(self.table, self.idx, op=op)
