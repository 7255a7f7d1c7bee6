"""Device-resident graph store: node tables + per-edge-type CSR.

Counterpart of ``graph_learn_tpu/core/store.py``.  The host build is the
same numpy code (``IdIndex``, ``_build_csr``, adjacency order: timestamp
ascending when timestamped, else weight descending when weighted, else
insertion order, each stable, ``:15-16``, ``:394-396``;
``unify_ts_bases:583``), copied rather than imported.  The device views
differ: flat int32 tensors ``row_offsets [N+1]``, ``nbr_ids [E]``,
``nbr_edge_ids [E]`` and, for a timestamped edge type, ``nbr_ts [E]`` (the
rebased timestamps in CSR order, ascending inside each row) replace the
TPU's 128-lane tiled views and interleaved ``off_pairs``, which only served
the TPU's gather layout.  A ``bfloat16`` feature table is
``torch.bfloat16``; edge features stay float32, as in the JAX package.

Timestamps are int64 on the host.  An ``EdgeTable`` rebases its own to
their minimum, and ``unify_ts_bases`` moves every timestamped table of a
store to one base (and, where the span exceeds int32, one coarser scale):
the device holds int32 ``ts - ts_base`` (``// ts_scale``), and
``abs = ts * ts_scale + ts_base`` restores absolute time.  Under
``conf.storage_profile = "full"`` each CSR also carries the id-sorted copy
of its rows and the per-row weight and in-degree CDFs, flat and bit-equal
to the JAX package's flat views, and each edge table the negative-sampling
candidate pools (the sorted distinct dst / src ids with their in- / out-
degree CDFs, as ``_pool`` at ``core/store.py:468-479``); ``"minimal"``
leaves them (and the reverse CSR) off the device, and the samplers that
need them raise.  A weighted node table also carries the normalised
cumulative weights that ``node_weight`` negatives draw by.

Device views are built lazily per device, on the card unless the caller
passes ``device="cpu"``.  Int (embedding id) and multi-value attribute
columns and their lengths travel as int32, node timestamps as int64
(``core/store.py:238-263``, ``:356-364`` of the JAX package, whose device
views hold them as int32 too without x64).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
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
    int_attrs: Optional[torch.Tensor] = None  # [N, ni] int32
    float_attrs: Optional[torch.Tensor] = None  # [N, nf] conf.feature_dtype
    multival_attrs: Optional[torch.Tensor] = None  # [N, nm, L] int32
    multival_lens: Optional[torch.Tensor] = None  # [N, nm] int32
    weights: Optional[torch.Tensor] = None  # [N] f32
    labels: Optional[torch.Tensor] = None  # [N] int32
    timestamps: Optional[torch.Tensor] = None  # [N] int64
    # normalised cumulative node weights (node_weight negatives)
    cum_weights: Optional[torch.Tensor] = None  # [N] f32

    @property
    def num_nodes(self) -> int:
        return self.raw_ids.shape[0]


@dataclasses.dataclass
class DeviceCSR(TensorStruct):
    """One direction of adjacency as flat CSR tensors."""

    row_offsets: torch.Tensor  # [Nrow+1] int32
    nbr_ids: torch.Tensor  # [E] int32, adjacency order
    nbr_edge_ids: torch.Tensor  # [E] int32
    max_degree: int = 0
    # the same rows ordered by neighbour id (None under "minimal"):
    nbr_ids_sorted: Optional[torch.Tensor] = None  # [E] int32
    nbr_edge_ids_sorted: Optional[torch.Tensor] = None  # [E] int32
    # per-row normalised inclusive cumsums, adjacency order (None under
    # "minimal"; cum_weights also None for an unweighted edge type):
    cum_weights: Optional[torch.Tensor] = None  # [E] f32, by edge weight
    cum_in_degrees: Optional[torch.Tensor] = None  # [E] f32, by nbr degree
    # rebased edge timestamps in CSR order, ascending inside each row, on
    # every profile (None unless the edge type is timestamped)
    nbr_ts: Optional[torch.Tensor] = None  # [E] int32

    @property
    def num_rows(self) -> int:
        return self.row_offsets.shape[0] - 1

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
    timestamps: Optional[torch.Tensor] = None  # [E] int32, rebased
    int_attrs: Optional[torch.Tensor] = None  # [E, ni] int32
    float_attrs: Optional[torch.Tensor] = None  # [E, nf] f32
    multival_attrs: Optional[torch.Tensor] = None  # [E, nm, L] int32
    multival_lens: Optional[torch.Tensor] = None  # [E, nm] int32
    # negative-sampling candidate pools (None under "minimal"): the sorted
    # distinct dst ids with their in-degree CDF (outNeg), and the sorted
    # distinct src ids with their out-degree CDF (inNeg)
    unique_dst: Optional[torch.Tensor] = None  # [Du] int32
    unique_dst_indeg_cdf: Optional[torch.Tensor] = None  # [Du] f32
    unique_src: Optional[torch.Tensor] = None  # [Su] int32
    unique_src_outdeg_cdf: Optional[torch.Tensor] = None  # [Su] f32

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]


def _put(x, dev: torch.device, dtype: Optional[torch.dtype] = None):
    """``x`` as a tensor on ``dev`` that never aliases a read-only array:
    a snapshot's memory-mapped arrays (``core/snapshot.py``) are copied,
    so no write through a view can reach them."""
    if x is None:
        return None
    a = np.ascontiguousarray(x)
    if a.flags.writeable:
        t = torch.from_numpy(a)
    else:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable", UserWarning)
            t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    out = t.to(dev)
    if not a.flags.writeable and out.data_ptr() == a.ctypes.data:
        out = out.clone()
    return out


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
                 int_attrs=None, float_attrs=None, multival_attrs=None,
                 multival_lens=None, weights=None, labels=None,
                 timestamps=None):
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

        self.int_attrs = chk(int_attrs, "int_attrs", np.int32)
        self.float_attrs = chk(float_attrs, "float_attrs", np.float32)
        self.multival_attrs = chk(multival_attrs, "multival_attrs", np.int32)
        self.multival_lens = chk(multival_lens, "multival_lens", np.int32)
        self.weights = chk(weights, "weights", np.float32)
        self.labels = chk(labels, "labels", np.int32)
        self.timestamps = chk(timestamps, "timestamps", np.int64)
        self._device: Dict[torch.device, DeviceNodeTable] = {}

    @property
    def num_nodes(self) -> int:
        return len(self.raw_ids)

    def device(self, device: DeviceLike = "cuda") -> DeviceNodeTable:
        dev = resolve_device(device)
        if dev not in self._device:
            cum = None
            if self.weights is not None and self.num_nodes:
                w = np.maximum(self.weights.astype(np.float64), 0.0)
                total = w.sum()
                if total <= 0:
                    w = np.ones_like(w)
                    total = w.sum()
                cum = np.cumsum(w / total).astype(np.float32)
            # the cast to bf16 happens on the host so the f32 table never
            # occupies the card
            self._device[dev] = DeviceNodeTable(
                raw_ids=_put(self.raw_ids, dev),
                int_attrs=_put(self.int_attrs, dev),
                float_attrs=_put(self.float_attrs, dev,
                                 torch_dtype(conf.feature_dtype)),
                multival_attrs=_put(self.multival_attrs, dev),
                multival_lens=_put(self.multival_lens, dev),
                weights=_put(self.weights, dev),
                labels=_put(self.labels, dev),
                timestamps=_put(self.timestamps, dev),
                cum_weights=_put(cum, dev))
        return self._device[dev]

    def drop_device(self, device: DeviceLike = "cuda"):
        """Forget the view on ``device``: the next :meth:`device` builds it
        again under the current ``conf`` (its ``feature_dtype``).  Tables
        already handed out keep their tensors."""
        self._device.pop(resolve_device(device), None)


def _segment_cdf(vals: np.ndarray, row_offsets: np.ndarray,
                 counts: np.ndarray) -> np.ndarray:
    """Per-row normalised inclusive cumsum of ``vals`` (adjacency order),
    f32.  A row whose values sum to zero falls back to uniform."""
    num_rows, e = counts.size, vals.size
    v = np.maximum(vals.astype(np.float64), 0.0)
    row_of = np.repeat(np.arange(num_rows), counts)
    seg_sum = np.bincount(row_of, weights=v, minlength=num_rows)
    zero = np.repeat(seg_sum <= 0, counts)
    v = np.where(zero, 1.0, v)
    seg_sum = np.bincount(row_of, weights=v, minlength=num_rows)
    cs = np.cumsum(v)
    start = np.minimum(row_offsets[:-1], max(e - 1, 0))
    per_row = cs - np.repeat((cs - v)[start], counts)
    denom = np.repeat(np.where(seg_sum > 0, seg_sum, 1.0), counts)
    return (per_row / denom).astype(np.float32)


def _pool(ids32: np.ndarray, degs: np.ndarray):
    """The sorted distinct ids and the CDF of their degrees (float64
    normalised cumsum, cast to f32): a copy of the JAX package's ``_pool``."""
    uniq = np.unique(ids32)
    d = degs[uniq].astype(np.float64)
    tot = d.sum()
    cdf = np.cumsum(d / (tot if tot > 0 else 1.0)).astype(np.float32)
    return uniq.astype(np.int32), cdf


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


def _build_csr(rows: np.ndarray, cols: np.ndarray, num_rows: int,
               sort_key: Optional[np.ndarray], sort_desc: bool,
               weights: Optional[np.ndarray] = None,
               nbr_in_degrees: Optional[np.ndarray] = None,
               full: bool = False,
               timestamps: Optional[np.ndarray] = None
               ) -> Tuple[Optional[np.ndarray], ...]:
    """(row_offsets, nbr, eid, nbr_s, eid_s, cumw, cumind, nbr_ts) of the
    CSR, rows sorted stably by row and within a row by ``sort_key`` (the
    JAX package's ``_build_csr`` order and arithmetic).  ``nbr_ts`` is
    ``timestamps`` in CSR order (None without them).  The id-sorted copy,
    the weight CDF and the CDF over the neighbours' degrees are only
    computed when ``full``; else they are None.  Each CDF is cumulative
    over the row in CSR order: ts-ascending on a timestamped edge type."""
    e = rows.size
    eid = np.arange(e, dtype=np.int64)
    if sort_key is not None:
        key = -sort_key if sort_desc else sort_key
        order = _stable_order(rows, key)
    else:
        order = np.argsort(rows, kind="stable")
    r = rows[order]
    nbr = cols[order].astype(np.int32)
    eids = eid[order].astype(np.int32)
    counts = np.bincount(r, minlength=num_rows).astype(np.int64)
    row_offsets = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_offsets[1:])
    nbr_ts = None
    if timestamps is not None and e:
        nbr_ts = timestamps[order].astype(np.int32)
    if not full:
        return row_offsets, nbr, eids, None, None, None, None, nbr_ts
    order2 = _stable_order(rows, cols)
    nbr_s = cols[order2].astype(np.int32)
    eid_s = eid[order2].astype(np.int32)
    cumw = cumind = None
    if weights is not None and e:
        cumw = _segment_cdf(weights[order], row_offsets, counts)
    if nbr_in_degrees is not None and e:
        cumind = _segment_cdf(nbr_in_degrees[nbr], row_offsets, counts)
    return row_offsets, nbr, eids, nbr_s, eid_s, cumw, cumind, nbr_ts


class EdgeTable:
    """Host-side edge table with bidirectional CSR."""

    def __init__(self, type_name: str, src_type: str, dst_type: str,
                 decoder: Decoder, src: np.ndarray, dst: np.ndarray,
                 num_src_nodes: int, num_dst_nodes: int,
                 int_attrs=None, float_attrs=None, multival_attrs=None,
                 multival_lens=None, weights=None, labels=None,
                 timestamps=None):
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
        self.int_attrs = (None if int_attrs is None
                          else np.asarray(int_attrs, np.int32))
        self.float_attrs = (None if float_attrs is None
                            else np.asarray(float_attrs, np.float32))
        self.multival_attrs = (None if multival_attrs is None
                               else np.asarray(multival_attrs, np.int32))
        self.multival_lens = (None if multival_lens is None
                              else np.asarray(multival_lens, np.int32))
        self.timestamps = (None if timestamps is None
                           else np.asarray(timestamps, np.int64))
        # rebased to this table's own minimum: abs = ts * ts_scale +
        # ts_base (unify_ts_bases moves every table of a store to one base)
        self.ts_base = 0
        self.ts_scale = 1
        if self.timestamps is not None and self.timestamps.size:
            self.ts_base = int(self.timestamps.min())
            self.timestamps = self.timestamps - self.ts_base
        self._device: Dict[torch.device, DeviceEdgeTable] = {}
        self.host_build_s = 0.0  # host seconds of the last device view
        # adjacency sort key: ts asc > weight desc > insertion order
        if self.timestamps is not None:
            self._sort_key, self._sort_desc = (
                self.timestamps.astype(np.float64), False)
        elif self.weights is not None:
            self._sort_key, self._sort_desc = self.weights.astype(np.float64), True
        else:
            self._sort_key, self._sort_desc = None, False
        self.out_degrees = np.bincount(
            self.src, minlength=num_src_nodes).astype(np.int32)
        self.in_degrees = np.bincount(
            self.dst, minlength=num_dst_nodes).astype(np.int32)

    @property
    def num_edges(self) -> int:
        return self.src.size

    def _host_csr(self, rows, cols, num_rows, nbr_degrees) -> dict:
        """One direction's CSR arrays (numpy); ``nbr_degrees`` are the
        degrees the in-degree CDF weighs each neighbour by."""
        ro, nbr, eids, nbr_s, eid_s, cumw, cumind, nts = _build_csr(
            rows, cols.astype(np.int32), num_rows, self._sort_key,
            self._sort_desc, self.weights, nbr_degrees,
            full=conf.storage_profile != "minimal",
            timestamps=self.timestamps)
        return dict(row_offsets=ro, nbr_ids=nbr, nbr_edge_ids=eids,
                    nbr_ids_sorted=nbr_s, nbr_edge_ids_sorted=eid_s,
                    cum_weights=cumw, cum_in_degrees=cumind, nbr_ts=nts)

    def device(self, device: DeviceLike = "cuda") -> DeviceEdgeTable:
        """The table's view on ``device``, built on first use: the CSR
        arrays and candidate pools on the host (``host_build_s`` records
        those seconds), then every array copied to the device."""
        dev = resolve_device(device)
        if dev not in self._device:
            t0 = time.perf_counter()
            src32, dst32 = self.src.astype(np.int32), self.dst.astype(np.int32)
            out = self._host_csr(self.src, self.dst, self.num_src_nodes,
                                 self.in_degrees)
            inc, pools = None, [None] * 4
            if conf.storage_profile != "minimal":
                inc = self._host_csr(self.dst, self.src, self.num_dst_nodes,
                                     self.out_degrees)
                pools = (_pool(dst32, self.in_degrees)
                         + _pool(src32, self.out_degrees))
            self.host_build_s = time.perf_counter() - t0

            def csr(h):
                d = np.diff(h["row_offsets"])
                return DeviceCSR(max_degree=int(d.max()) if d.size else 0,
                                 **{k: _put(a, dev) for k, a in h.items()})

            u_dst, u_dst_cdf, u_src, u_src_cdf = [_put(a, dev) for a in pools]
            self._device[dev] = DeviceEdgeTable(
                out=csr(out), inc=None if inc is None else csr(inc),
                src=_put(src32, dev), dst=_put(dst32, dev),
                weights=_put(self.weights, dev),
                labels=_put(self.labels, dev),
                timestamps=_put(None if self.timestamps is None
                                else self.timestamps.astype(np.int32), dev),
                int_attrs=_put(self.int_attrs, dev),
                float_attrs=_put(self.float_attrs, dev),
                multival_attrs=_put(self.multival_attrs, dev),
                multival_lens=_put(self.multival_lens, dev),
                unique_dst=u_dst, unique_dst_indeg_cdf=u_dst_cdf,
                unique_src=u_src, unique_src_outdeg_cdf=u_src_cdf)
        return self._device[dev]


@dataclasses.dataclass
class NodeSet:
    """Seed set for traversal: dense indices into a base node table.  A
    masked split (``MASK*type``) or the distinct endpoints of an edge type
    (``ESRC*e`` / ``EDST*e``) maps into its base table, so lookups read the
    base payload."""

    type_name: str  # possibly masked name
    base_type: str
    indices: np.ndarray  # [M] int32
    weights: Optional[np.ndarray] = None  # [M] f32

    @property
    def size(self) -> int:
        return self.indices.size


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
            indices=np.arange(table.num_nodes, dtype=np.int32),
            weights=table.weights)

    def add_edge_table(self, table: EdgeTable):
        self.edges[table.type_name] = table
        self.topology[table.type_name] = (table.src_type, table.dst_type)
        # V(edge, node_from=EDGE_SRC/EDGE_DST) seed sets are snapshots of
        # this table's endpoints: rebuilt on next use
        for nm in ("ESRC*" + table.type_name, "EDST*" + table.type_name):
            self.node_sets.pop(nm, None)

    def add_node_set(self, ns: NodeSet):
        self.node_sets[ns.type_name] = ns

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

    def drop_device_views(self):
        """Forget every table's device views: the next ``device()`` call
        builds them from the host tables as they are now, and tensors no
        view holds any more return to the device's memory."""
        for t in list(self.nodes.values()) + list(self.edges.values()):
            t._device = {}

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {
            "nodes": {t: tb.num_nodes for t, tb in self.nodes.items()},
            "edges": {t: tb.num_edges for t, tb in self.edges.items()},
        }


def unify_ts_bases(store: GraphStore) -> None:
    """Rebase every timestamped edge table of ``store`` to one (base,
    scale): a copy of the JAX package's ``unify_ts_bases:583``.

    Temporal traversal compares timestamps across tables (events of one
    type bound hops over another; ``TemporalGraph`` spans), so all must
    share one time domain.  Device timestamps are int32: where the global
    span exceeds it, every table is coarsened by the smallest power of 10
    that fits, with a warning (before-t sampling is then exact at that
    resolution).  A table whose base or scale changes drops its device
    views, to be rebuilt on next use."""
    tables = [t for t in store.edges.values()
              if t.timestamps is not None and t.timestamps.size]
    if not tables:
        return
    lo = min(int(t.timestamps.min()) * t.ts_scale + t.ts_base
             for t in tables)
    hi = max(int(t.timestamps.max()) * t.ts_scale + t.ts_base
             for t in tables)
    span = hi - lo
    scale = 1
    while span // scale > 2**31 - 2:
        scale *= 10
    if scale > 1:
        warnings.warn(
            "global timestamp span %d exceeds int32; coarsening device "
            "timestamps by %dx (before-t sampling is exact at that "
            "resolution)" % (span, scale))
    for t in tables:
        if t.ts_base == lo and t.ts_scale == scale:
            continue
        absolute = t.timestamps.astype(np.int64) * t.ts_scale + t.ts_base
        t.timestamps = (absolute - lo) // scale
        t.ts_base = lo
        t.ts_scale = scale
        # the adjacency keeps the order of the table's own timestamps (the
        # JAX package's sort key is set once): under coarsening, ties of
        # the coarse values stay in their fine order
        t._device = {}
