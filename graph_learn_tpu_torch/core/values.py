"""Result value types: ``Nodes``, ``SparseNodes``, ``Edges``,
``SparseEdges``, ``SubGraphVal`` and ``DeferredRows``.

Counterparts of ``graph_learn_tpu/core/values.py:29-210`` as plain
dataclasses of tensors (``SubGraphVal`` as the value type alone: the
subgraph sampler that makes one is not ported yet).  Int (embedding id)
attributes are [*, n_int] int32, multi-value ones [*, n_mv, max_len] int32
with their lengths [*, n_mv].  Shapes follow the JAX package: ``Nodes.ids`` is
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

import numpy as np
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


def map_result(fn: Callable[[torch.Tensor], Any], out: dict) -> dict:
    """Apply ``fn`` to every batch tensor of a {alias: value} result."""
    return {a: v.map(fn) if isinstance(v, TensorStruct) else fn(v)
            for a, v in out.items()}


@dataclasses.dataclass
class Nodes(TensorStruct):
    """A batch of nodes (possibly fanout-shaped)."""

    ids: torch.Tensor  # int32 dense indices, [*]
    raw_ids: Optional[torch.Tensor] = None  # int64 source ids
    int_attrs: Optional[torch.Tensor] = None  # [*, n_int] int32
    # [*, n_float] features, or a stand-in: DeferredRows (rows not yet
    # gathered) or nn/data.py PreAggregatedRows
    float_attrs: Any = None
    multival_attrs: Optional[torch.Tensor] = None  # [*, n_mv, L] int32
    multival_lens: Optional[torch.Tensor] = None  # [*, n_mv] int32
    weights: Optional[torch.Tensor] = None  # [*] f32
    labels: Optional[torch.Tensor] = None  # [*] int32
    timestamps: Optional[torch.Tensor] = None  # [*] int64
    out_degrees: Optional[torch.Tensor] = None  # [*] int32
    type_name: str = ""

    @property
    def shape(self):
        return self.ids.shape

    @property
    def batch_size(self) -> int:
        return self.ids.shape[0]

    def flat(self) -> "Nodes":
        """The fanout dims flattened into one leading dim (a deferred
        feature gather's indices with them)."""
        n = self.ids.dim()
        return self.map(lambda x: x.reshape((-1,) + tuple(x.shape[n:])))


@dataclasses.dataclass
class SparseNodes(TensorStruct):
    """Variable-degree nodes as [b, cap] ids plus [b] true degrees."""

    ids: torch.Tensor  # [b, cap] int32
    degrees: torch.Tensor  # [b] int32, clipped to cap
    raw_ids: Optional[torch.Tensor] = None
    int_attrs: Optional[torch.Tensor] = None
    float_attrs: Any = None  # DeferredRows from a lookup
    multival_attrs: Optional[torch.Tensor] = None
    multival_lens: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    timestamps: Optional[torch.Tensor] = None
    type_name: str = ""

    @property
    def cap(self) -> int:
        return self.ids.shape[-1]

    @property
    def dense_shape(self):
        return self.ids.shape

    def mask(self) -> torch.Tensor:
        """[b, cap] bool: True where a slot holds a neighbour."""
        pos = torch.arange(self.cap, dtype=torch.int32,
                           device=self.ids.device)[None, :]
        return pos < self.degrees[:, None]

    def offsets(self) -> torch.Tensor:
        """[b + 1] int32 exclusive prefix sum of the degrees."""
        zero = torch.zeros(1, dtype=torch.int32, device=self.degrees.device)
        return torch.cat([zero, torch.cumsum(self.degrees, 0).to(torch.int32)])

    def embedding_agg(self, op: str = "sum") -> torch.Tensor:
        """One vector per row: the float attrs of its neighbours reduced
        with ``op``, straight from the table the deferred rows point into
        (sum / mean / max / min on Kernel 2; prod in plain PyTorch)."""
        from graph_learn_tpu_torch.ops.aggregate import embedding_agg
        fa = self.float_attrs
        if not isinstance(fa, DeferredRows):
            raise ValueError("these SparseNodes carry no deferred float "
                             "attrs to reduce")
        return embedding_agg(fa.table, fa.idx, self.degrees, op)


@dataclasses.dataclass
class Edges(TensorStruct):
    """A batch of edges with src / dst node views (reference
    values.py:471-543)."""

    edge_ids: torch.Tensor  # [*] int32 dense edge indices, -1 = none
    src_nodes: Nodes
    dst_nodes: Nodes
    int_attrs: Optional[torch.Tensor] = None  # [*, n_int] int32
    weights: Optional[torch.Tensor] = None  # [*] f32, 0 where edge_ids < 0
    labels: Optional[torch.Tensor] = None  # [*] int32
    # [*] int32 rebased timestamps (a -1 pad reads edge row 0's)
    timestamps: Optional[torch.Tensor] = None
    float_attrs: Any = None  # [*, nf] f32 edge features: DeferredRows
    multival_attrs: Optional[torch.Tensor] = None  # [*, n_mv, L] int32
    multival_lens: Optional[torch.Tensor] = None  # [*, n_mv] int32
    type_name: str = ""

    @property
    def shape(self):
        return self.edge_ids.shape

    @property
    def src_ids(self) -> torch.Tensor:
        return self.src_nodes.ids

    @property
    def dst_ids(self) -> torch.Tensor:
        return self.dst_nodes.ids


@dataclasses.dataclass
class SparseEdges(TensorStruct):
    """Variable-degree edges as [b, cap] edge ids plus [b] true degrees;
    the src of every slot of a row is that row's seed."""

    edge_ids: torch.Tensor  # [b, cap]
    degrees: torch.Tensor  # [b]
    src_nodes: Nodes  # [b]
    dst_nodes: SparseNodes  # [b, cap]
    weights: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    timestamps: Optional[torch.Tensor] = None
    float_attrs: Any = None
    type_name: str = ""

    def mask(self) -> torch.Tensor:
        pos = torch.arange(self.edge_ids.shape[-1], dtype=torch.int32,
                           device=self.edge_ids.device)[None, :]
        return pos < self.degrees[:, None]


@dataclasses.dataclass
class SubGraphVal(TensorStruct):
    """An induced subgraph: ``edge_index`` [2, E_cap] local indices over
    ``node_ids`` [N_cap], with ``num_edges`` / ``num_nodes`` of them valid;
    optionally the nodes' payload, the global edge ids and the BFS
    distances to the src / dst seed (SEAL)."""

    node_ids: torch.Tensor  # [N_cap] int32 dense node indices
    num_nodes: torch.Tensor  # scalar int32
    edge_index: torch.Tensor  # [2, E_cap] int32, local indices
    num_edges: torch.Tensor  # scalar int32
    nodes: Optional[Nodes] = None  # the node payload, [N_cap]
    edge_ids: Optional[torch.Tensor] = None  # [E_cap] global edge indices
    dist_to_src: Optional[torch.Tensor] = None  # [N_cap] int32
    dist_to_dst: Optional[torch.Tensor] = None  # [N_cap] int32
    type_name: str = ""

    def node_mask(self) -> torch.Tensor:
        return torch.arange(self.node_ids.shape[0], dtype=torch.int32,
                            device=self.node_ids.device) < self.num_nodes

    def edge_mask(self) -> torch.Tensor:
        return torch.arange(self.edge_index.shape[1], dtype=torch.int32,
                            device=self.edge_index.device) < self.num_edges


@dataclasses.dataclass
class DeferredRows(TensorStruct):
    """An unmaterialised feature-row gather: table + hop-shaped indices.

    :meth:`materialize` gathers the rows (Kernel 1 on the card);
    :meth:`group_agg` reduces them over the trailing fanout axis straight
    from the table (Kernel 2), so the [..., k, D] rows are never written.
    It has the ``shape`` and ``dtype`` of the rows it stands for, and
    ``np.asarray`` of it gives them (gathered, then copied to the host),
    as it gives the JAX package's array.
    """

    table: torch.Tensor = dataclasses.field(metadata={"static": True})
    idx: torch.Tensor  # hop-shaped int indices

    @property
    def shape(self) -> torch.Size:
        return torch.Size(tuple(self.idx.shape) + tuple(self.table.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.table.dtype

    def __array__(self, dtype=None, copy=None):
        rows = self.materialize().detach().cpu()
        if rows.dtype == torch.bfloat16:  # numpy has no bfloat16
            rows = rows.float()
        return np.asarray(rows.numpy(), dtype=dtype)

    def materialize(self) -> torch.Tensor:
        from graph_learn_tpu_torch.ops.kernels.dispatch import feature_gather
        return feature_gather(self.table, self.idx)

    def group_agg(self, op: str = "mean") -> torch.Tensor:
        """[n_groups, D] reduction over the trailing fanout axis."""
        from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
        return gather_group_agg(self.table, self.idx, op=op)
