"""Device-resident graph store: node tables + per-edge-type CSR.

Counterpart of ``graph_learn_tpu/core/store.py``.  The host build is the
same numpy code (``IdIndex``, ``_build_csr``, adjacency order: weight desc
when weighted, else insertion order), copied rather than imported.  The
device views differ: flat int32 tensors ``row_offsets [N+1]``,
``nbr_ids [E]`` and ``nbr_edge_ids [E]`` replace the TPU's 128-lane tiled
views and interleaved ``off_pairs``, which only served the TPU's gather
layout.  A ``bfloat16`` feature table is ``torch.bfloat16``.

Device views are built lazily per device, on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.values import TensorStruct
from graph_learn_tpu_torch.errors import InvalidArgumentError, NotFoundError
from graph_learn_tpu_torch.utils.platform import (DeviceLike, resolve_device,
                                                  torch_dtype)


# ---------------------------------------------------------------------------
# Device-side views
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceNodeTable(TensorStruct):
    """Per-node-type payload tensors on one device."""

    raw_ids: torch.Tensor  # [N] int64
    float_attrs: Optional[torch.Tensor] = None  # [N, nf] conf.feature_dtype
    weights: Optional[torch.Tensor] = None  # [N] f32
    labels: Optional[torch.Tensor] = None  # [N] int32


@dataclasses.dataclass
class DeviceCSR(TensorStruct):
    """One direction of adjacency as flat CSR tensors."""

    row_offsets: torch.Tensor  # [Nrow+1] int32
    nbr_ids: torch.Tensor  # [E] int32, adjacency order
    nbr_edge_ids: torch.Tensor  # [E] int32
    max_degree: int = 0

    @property
    def num_edges(self) -> int:
        return self.nbr_ids.shape[0]

    def degrees(self) -> torch.Tensor:
        return self.row_offsets[1:] - self.row_offsets[:-1]


@dataclasses.dataclass
class DeviceEdgeTable(TensorStruct):
    """Per-edge-type topology (both directions) + edge payload."""

    out: DeviceCSR  # src -> dst
    src: torch.Tensor  # [E] int32, edge-row order
    dst: torch.Tensor  # [E] int32
    inc: Optional[DeviceCSR] = None  # dst -> src (None in minimal profile)
    weights: Optional[torch.Tensor] = None  # [E] f32
    labels: Optional[torch.Tensor] = None  # [E] int32


def _put(x, dev: torch.device, dtype: Optional[torch.dtype] = None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


# ---------------------------------------------------------------------------
# Host-side build
# ---------------------------------------------------------------------------


class IdIndex:
    """raw int64 id -> dense int32 index (reference AutoIndex)."""

    def __init__(self, raw_ids: np.ndarray):
        self.raw_ids = raw_ids.astype(np.int64)
        order = np.argsort(self.raw_ids, kind="stable")
        self._sorted = self.raw_ids[order]
        self._perm = order.astype(np.int32)
        if self._sorted.size and np.any(self._sorted[1:] == self._sorted[:-1]):
            raise InvalidArgumentError("duplicate node ids in table")

    def __len__(self):
        return self.raw_ids.size

    def lookup(self, ids: np.ndarray, strict: bool = True) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        pos = np.searchsorted(self._sorted, ids)
        pos = np.clip(pos, 0, max(len(self._sorted) - 1, 0))
        found = (self._sorted[pos] == ids if len(self._sorted)
                 else np.zeros(ids.shape, bool))
        if strict and not np.all(found):
            missing = ids[~found]
            raise NotFoundError(
                "%d ids not present in node table (e.g. %r)"
                % (missing.size, missing[:5].tolist()))
        out = self._perm[pos].astype(np.int32)
        out[~found] = -1
        return out


class NodeTable:
    """Host-side node table (numpy) + lazily created device views."""

    def __init__(self, type_name: str, decoder: Decoder, raw_ids: np.ndarray,
                 float_attrs=None, weights=None, labels=None):
        self.type_name = type_name
        self.decoder = decoder
        self.raw_ids = raw_ids.astype(np.int64)
        self.index = IdIndex(self.raw_ids)
        n = len(self.raw_ids)

        def chk(a, name, dtype):
            if a is None:
                return None
            a = np.asarray(a, dtype=dtype)
            if a.shape[0] != n:
                raise InvalidArgumentError(
                    "%s rows %d != ids %d for %s" % (name, a.shape[0], n,
                                                     type_name))
            return a

        self.float_attrs = chk(float_attrs, "float_attrs", np.float32)
        self.weights = chk(weights, "weights", np.float32)
        self.labels = chk(labels, "labels", np.int32)
        self._device: Dict[torch.device, DeviceNodeTable] = {}

    @property
    def num_nodes(self) -> int:
        return len(self.raw_ids)

    def device(self, device: DeviceLike = "cuda") -> DeviceNodeTable:
        dev = resolve_device(device)
        if dev not in self._device:
            # the cast to bf16 happens on the host so the f32 table never
            # occupies the card
            self._device[dev] = DeviceNodeTable(
                raw_ids=_put(self.raw_ids, dev),
                float_attrs=_put(self.float_attrs, dev,
                                 torch_dtype(conf.feature_dtype)),
                weights=_put(self.weights, dev),
                labels=_put(self.labels, dev))
        return self._device[dev]


def _build_csr(rows: np.ndarray, cols: np.ndarray, num_rows: int,
               sort_key: Optional[np.ndarray],
               sort_desc: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row_offsets, nbr, eid) of the CSR, rows sorted stably by row and
    within a row by ``sort_key`` (the JAX package's ``_build_csr`` order)."""
    e = rows.size
    eid = np.arange(e, dtype=np.int64)
    if sort_key is not None:
        key = -sort_key if sort_desc else sort_key
        order = np.lexsort((key, rows))
    else:
        order = np.argsort(rows, kind="stable")
    r = rows[order]
    nbr = cols[order].astype(np.int32)
    eids = eid[order].astype(np.int32)
    counts = np.bincount(r, minlength=num_rows).astype(np.int64)
    row_offsets = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_offsets[1:])
    return row_offsets, nbr, eids


class EdgeTable:
    """Host-side edge table with bidirectional CSR."""

    def __init__(self, type_name: str, src_type: str, dst_type: str,
                 decoder: Decoder, src: np.ndarray, dst: np.ndarray,
                 num_src_nodes: int, num_dst_nodes: int,
                 weights=None, labels=None):
        self.type_name = type_name
        self.src_type = src_type
        self.dst_type = dst_type
        self.decoder = decoder
        self.src = src.astype(np.int64)
        self.dst = dst.astype(np.int64)
        self.num_src_nodes = num_src_nodes
        self.num_dst_nodes = num_dst_nodes
        self.weights = None if weights is None else np.asarray(weights,
                                                               np.float32)
        self.labels = None if labels is None else np.asarray(labels, np.int32)
        self._device: Dict[torch.device, DeviceEdgeTable] = {}
        # adjacency sort key: weight desc > insertion order
        if self.weights is not None:
            self._sort_key, self._sort_desc = self.weights.astype(np.float64), True
        else:
            self._sort_key, self._sort_desc = None, False
        self.out_degrees = np.bincount(
            self.src, minlength=num_src_nodes).astype(np.int32)

    @property
    def num_edges(self) -> int:
        return self.src.size

    def _csr(self, rows, cols, num_rows, dev) -> DeviceCSR:
        ro, nbr, eids = _build_csr(rows, cols.astype(np.int32), num_rows,
                                   self._sort_key, self._sort_desc)
        d = np.diff(ro)
        return DeviceCSR(row_offsets=_put(ro, dev), nbr_ids=_put(nbr, dev),
                         nbr_edge_ids=_put(eids, dev),
                         max_degree=int(d.max()) if d.size else 0)

    def device(self, device: DeviceLike = "cuda") -> DeviceEdgeTable:
        dev = resolve_device(device)
        if dev not in self._device:
            inc = None
            if conf.storage_profile != "minimal":
                inc = self._csr(self.dst, self.src, self.num_dst_nodes, dev)
            self._device[dev] = DeviceEdgeTable(
                out=self._csr(self.src, self.dst, self.num_src_nodes, dev),
                inc=inc,
                src=_put(self.src.astype(np.int32), dev),
                dst=_put(self.dst.astype(np.int32), dev),
                weights=_put(self.weights, dev),
                labels=_put(self.labels, dev))
        return self._device[dev]


@dataclasses.dataclass
class NodeSet:
    """Seed set for traversal: dense indices into a base node table."""

    type_name: str
    base_type: str
    indices: np.ndarray  # [M] int32


class GraphStore:
    """Type registry: node_type -> NodeTable, edge_type -> EdgeTable."""

    def __init__(self):
        self.nodes: Dict[str, NodeTable] = {}
        self.edges: Dict[str, EdgeTable] = {}
        self.node_sets: Dict[str, NodeSet] = {}
        self.topology: Dict[str, Tuple[str, str]] = {}

    def add_node_table(self, table: NodeTable):
        self.nodes[table.type_name] = table
        self.node_sets[table.type_name] = NodeSet(
            type_name=table.type_name, base_type=table.type_name,
            indices=np.arange(table.num_nodes, dtype=np.int32))

    def add_edge_table(self, table: EdgeTable):
        self.edges[table.type_name] = table
        self.topology[table.type_name] = (table.src_type, table.dst_type)

    def node_table(self, t: str) -> NodeTable:
        if t not in self.nodes:
            raise NotFoundError("unknown node type %r" % t)
        return self.nodes[t]

    def edge_table(self, t: str) -> EdgeTable:
        if t not in self.edges:
            raise NotFoundError("unknown edge type %r" % t)
        return self.edges[t]

    def node_set(self, t: str) -> NodeSet:
        if t not in self.node_sets:
            raise NotFoundError("unknown node set %r" % t)
        return self.node_sets[t]

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {
            "nodes": {t: tb.num_nodes for t, tb in self.nodes.items()},
            "edges": {t: tb.num_edges for t, tb in self.edges.items()},
        }
