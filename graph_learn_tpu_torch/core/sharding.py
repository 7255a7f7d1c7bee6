"""Views of a graph store sharded over the mesh's "graph" axis, and the
collectives that stitch per-shard answers.

Counterpart of ``graph_learn_tpu/core/sharding.py``.  Node rows are
range-partitioned over the graph axis: rank ``g`` of the axis owns rows
``[g * rps, (g + 1) * rps)``.  Every per-seed operator (samplers,
lookups, membership probes, degrees) runs on the owning rank's block and
one ``psum`` over the axis stitches the answer: non-owners contribute
exact zeros, so the sum is the owner's answer, in seed order.

The JAX package runs this as the body of a ``shard_map``; here every rank
of the axis's process group runs the same body on its own block.  An axis
name resolves to a process group through :class:`bind_axes` (the
partitioned plan binds the mesh's "data" and "graph" groups around the
plan, as ``shard_map`` binds its axis names), and the JAX collectives map
onto ``torch.distributed`` on that group:

    lax.psum        -> dist.all_reduce (a float sum stays a float sum, so
                       -0.0 + 0.0 = +0.0 as in the JAX package)
    lax.all_to_all  -> dist.all_to_all_single (equal blocks)
    all_gather      -> dist.all_gather_into_tensor
    (replication)   -> dist.broadcast from the axis's first rank
    lax.axis_index  -> the rank's index in the group (the mesh's local rank)

An axis of one rank runs no collective: its psum is the identity.  Every
collective goes through :func:`_collective`, the one place that counts
the bytes each sends (``COLLECTIVES``: per op and axis, calls and payload
bytes per rank; the payload is the collective's result tensor, as
``examples/routing_bytes.py`` of the JAX package counts StableHLO result
types).  gloo carries the three collectives of f32, bf16 and int32 CUDA
tensors itself (chip_smoke.py phase 24 runs each on the card), so no
tensor is staged through host memory here.

Randomness: a sharded sampler is exact only when every rank of the graph
axis draws the same numbers.  The draws of the port's samplers depend on
the seed count and the fan-out alone, never on the local block (the
retry rounds are fixed; a ``ShardedCSR`` carries the global
``max_degree``, which fixes the bisection and scan loops), so generators
seeded alike draw alike.  A branch taken on one rank and not on another
would hang the collective: the only data-dependent branch here, the
owner-routing overflow fallback, first sums the overflow count over the
axis, so every rank takes it alike.

Owner routing (``conf.partition_routing == "owner"``) moves payload rows
(the feature vectors) with two ``all_to_all`` s instead of the dense
psum: O(n * D) bytes over the axis instead of O(P * n * D).  The owner
side gathers its rows with Kernel 1 (``feature_gather``: ``glt::gather_rows``
on a CUDA table, its plain version on the CPU), where the JAX package
uses an XLA gather (``:218``, ``:310``).

Host-side construction lives in ``parallel/sharded_store.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from graph_learn_tpu_torch.core.store import DeviceCSR, DeviceNodeTable
from graph_learn_tpu_torch.core.values import TensorStruct

GRAPH_AXIS = "graph"
DATA_AXIS = "data"


# ---------------------------------------------------------------------------
# Axes and collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """A named mesh axis as this rank sees it: the process group over the
    ranks that share this rank's other coordinates, this rank's index in
    it, and its size.  ``group`` None with ``size`` 1 is a trivial axis."""

    group: object
    index: int
    size: int


_AXES = threading.local()


def _bound() -> Dict[str, Axis]:
    if not hasattr(_AXES, "axes"):
        _AXES.axes = {}
    return _AXES.axes


@contextlib.contextmanager
def bind_axes(**axes: Axis):
    """Bind axis names to process groups for the code inside, as
    ``shard_map`` binds its mesh's axis names."""
    table = _bound()
    prev = dict(table)
    table.update(axes)
    try:
        yield
    finally:
        table.clear()
        table.update(prev)


def mesh_axis(mesh, name: str) -> Axis:
    """The :class:`Axis` of dimension ``name`` of a ``DeviceMesh``."""
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return Axis(group=None, index=0, size=1)
    return Axis(group=mesh.get_group(name),
                index=mesh.get_local_rank(name), size=size)


def bind_mesh(mesh):
    """:func:`bind_axes` for every dimension of ``mesh``."""
    return bind_axes(**{n: mesh_axis(mesh, n) for n in mesh.mesh_dim_names})


def axis(name: str) -> Axis:
    try:
        return _bound()[name]
    except KeyError:
        raise RuntimeError(
            "mesh axis %r is not bound: sharded tables are read inside a "
            "partitioned plan (parallel/train.py), which binds the mesh's "
            "groups" % name) from None


def axis_index(name: str) -> int:
    return axis(name).index


def axis_size(name: str) -> int:
    return axis(name).size


class CollectiveLog:
    """Calls and payload bytes per rank of every collective this process
    ran, by (op, axis)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls: Dict[Tuple[str, str], int] = {}
        self.bytes: Dict[Tuple[str, str], int] = {}

    def add(self, op: str, axis_name: str, nbytes: int):
        key = (op, axis_name)
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + int(nbytes)

    def total_bytes(self, axis_name: Optional[str] = None) -> int:
        return sum(b for (op, a), b in self.bytes.items()
                   if axis_name is None or a == axis_name)

    def by_op(self, axis_name: Optional[str] = None) -> Dict[str, tuple]:
        """{op: (calls, bytes)} over one axis (or all)."""
        out: Dict[str, tuple] = {}
        for (op, a), n in self.calls.items():
            if axis_name is not None and a != axis_name:
                continue
            c, b = out.get(op, (0, 0))
            out[op] = (c + n, b + self.bytes[(op, a)])
        return out


COLLECTIVES = CollectiveLog()


def _collective(op: str, axis_name: str, out: torch.Tensor,
                inp: torch.Tensor) -> torch.Tensor:
    """Run ``op`` on the group of ``axis_name``: ``all_reduce`` sums
    ``inp`` in place and ``broadcast`` overwrites it with the axis's first
    rank's (``out`` is ``inp``), ``all_to_all`` and ``all_gather`` write
    ``out``.  Counts the payload (``out``'s bytes)."""
    import torch.distributed as dist

    group = axis(axis_name).group
    if op == "all_reduce":
        dist.all_reduce(inp, group=group)
    elif op == "all_to_all":
        dist.all_to_all_single(out, inp, group=group)
    elif op == "all_gather":
        dist.all_gather_into_tensor(out, inp, group=group)
    elif op == "broadcast":  # from the axis's first rank
        dist.broadcast(inp, src=dist.get_global_rank(group, 0), group=group)
    else:
        raise ValueError("unknown collective %r" % op)
    COLLECTIVES.add(op, axis_name, out.numel() * out.element_size())
    return out


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the axis (``lax.psum``)."""
    if axis_size(axis_name) == 1:
        return x
    y = x.contiguous().clone()
    return _collective("all_reduce", axis_name, y, y)


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0)``: block ``q`` of ``x`` [P, ...]
    goes to rank ``q``; block ``q`` of the result came from rank ``q``."""
    if axis_size(axis_name) == 1:
        return x
    x = x.contiguous()
    return _collective("all_to_all", axis_name, torch.empty_like(x), x)


def broadcast(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The axis's first rank's ``x`` on every rank of the axis."""
    if axis_size(axis_name) == 1:
        return x
    y = x.contiguous().clone()
    return _collective("broadcast", axis_name, y, y)


def all_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Every rank's ``x`` [m, ...] concatenated in rank order
    [P * m, ...]."""
    p = axis_size(axis_name)
    if p == 1:
        return x
    x = x.contiguous()
    out = torch.empty((p * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _collective("all_gather", axis_name, out, x)


# ---------------------------------------------------------------------------
# Sharded tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedCSR(TensorStruct):
    """One direction of adjacency, rows range-partitioned over ``axis``.

    ``local`` is this rank's rows re-indexed to [0, rows_per_shard) with
    GLOBAL neighbour and edge ids, padded to the edge count of the fullest
    block; its ``max_degree`` is the global one, so every rank runs the
    same loops."""

    local: DeviceCSR
    rows_per_shard: int = 0
    axis: str = GRAPH_AXIS

    @property
    def nbr_ts(self):
        return self.local.nbr_ts

    @property
    def max_degree(self) -> int:
        return self.local.max_degree


@dataclasses.dataclass
class ShardedNodeTable(TensorStruct):
    """Node payload rows range-partitioned over ``axis``; the global
    node-weight CDF (``node_weight`` negatives) stays replicated."""

    local: DeviceNodeTable
    cum_weights: Optional[torch.Tensor] = None  # replicated global CDF
    rows_per_shard: int = 0
    num_nodes_global: int = 0
    axis: str = GRAPH_AXIS

    @property
    def num_nodes(self) -> int:
        return self.num_nodes_global

    @property
    def device(self) -> torch.device:
        return self.local.raw_ids.device


@dataclasses.dataclass
class ShardedEdgeTable(TensorStruct):
    """Per-edge-type topology and payload sharded over ``axis``: the
    ``out`` / ``inc`` CSRs by src / dst owner, the edge-row arrays in
    blocks of ``edges_per_shard`` rows, the negative-sampling pools
    replicated (they are id-sized)."""

    out: ShardedCSR
    src: torch.Tensor  # [edges_per_shard] local block
    dst: torch.Tensor
    inc: Optional[ShardedCSR] = None
    weights: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    timestamps: Optional[torch.Tensor] = None
    int_attrs: Optional[torch.Tensor] = None
    float_attrs: Optional[torch.Tensor] = None
    multival_attrs: Optional[torch.Tensor] = None
    multival_lens: Optional[torch.Tensor] = None
    unique_dst: Optional[torch.Tensor] = None  # replicated
    unique_dst_indeg_cdf: Optional[torch.Tensor] = None
    unique_src: Optional[torch.Tensor] = None
    unique_src_outdeg_cdf: Optional[torch.Tensor] = None
    edges_per_shard: int = 0
    num_edges_global: int = 0
    axis: str = GRAPH_AXIS

    @property
    def num_edges(self) -> int:
        return self.num_edges_global


def is_sharded(x) -> bool:
    return isinstance(x, (ShardedCSR, ShardedNodeTable, ShardedEdgeTable))


# ---------------------------------------------------------------------------
# The psum stitch
# ---------------------------------------------------------------------------


def own_rows(rows_per_shard: int, axis_name: str, ids: torch.Tensor):
    """(local_index, owned_mask) of global row ids under range partition."""
    lo = axis_index(axis_name) * rows_per_shard
    loc = ids.to(torch.int32) - lo
    own = (loc >= 0) & (loc < rows_per_shard)
    return torch.clamp(loc, 0, rows_per_shard - 1), own


def psum_owned(x: torch.Tensor, own: torch.Tensor,
               axis_name: str) -> torch.Tensor:
    """Zero non-owned entries and sum over the axis (the "stitch")."""
    m = own.reshape(tuple(own.shape) + (1,) * (x.dim() - own.dim()))
    masked = torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    return psum(masked, axis_name)


def local_rows(arr: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """``arr[loc]`` on this rank's block: a 2-D float payload through
    Kernel 1 (``feature_gather``), anything else by indexing."""
    if arr.dim() == 2 and arr.is_floating_point():
        from graph_learn_tpu_torch.ops.kernels.dispatch import feature_gather
        return feature_gather(arr, loc)
    return arr[loc]


def row_sharded_sampler(fn):
    """Make a per-seed CSR sampler shard-transparent.

    ``fn(csr, seeds, *a, **kw) -> tensor | tuple``: on a
    :class:`ShardedCSR` every rank samples its block for the seeds (the
    seeds it does not own read a clipped row) and one psum keeps the
    owner's answer, fills included.  The draws are the same on every rank,
    so the result is bit-equal to the single-device sampler's."""

    @functools.wraps(fn)
    def wrapped(csr, seeds, *args, **kwargs):
        if not isinstance(csr, ShardedCSR):
            return fn(csr, seeds, *args, **kwargs)
        loc, own = own_rows(csr.rows_per_shard, csr.axis, seeds)
        out = fn(csr.local, loc, *args, **kwargs)
        if isinstance(out, tuple):
            return tuple(psum_owned(x, own, csr.axis) for x in out)
        return psum_owned(out, own, csr.axis)

    return wrapped


def sharded_row_gather(arr: Optional[torch.Tensor], rows_per_shard: int,
                       axis_name: str,
                       ids: torch.Tensor) -> Optional[torch.Tensor]:
    """``arr[ids]`` where ``arr`` is this rank's row block of a global
    array."""
    if arr is None:
        return None
    loc, own = own_rows(rows_per_shard, axis_name, ids)
    return psum_owned(local_rows(arr, loc), own, axis_name)


def csr_degrees(csr, ids: torch.Tensor) -> torch.Tensor:
    """Row degrees at ``ids`` (any shape); shard-transparent."""
    from graph_learn_tpu_torch.ops.segment import row_bounds
    if isinstance(csr, ShardedCSR):
        loc, own = own_rows(csr.rows_per_shard, csr.axis, ids)
        _, _, d = row_bounds(csr.local.row_offsets, loc)
        return psum_owned(d, own, csr.axis)
    _, _, d = row_bounds(csr.row_offsets, ids)
    return d


def edge_field(et, name: str,
               edge_ids: torch.Tensor) -> Optional[torch.Tensor]:
    """A per-edge field (``src``, ``dst``, ``timestamps``, ...) at edge
    row ids.  An invalid id (< 0) reads row 0 on the plain path (masked
    downstream) and zeros on the sharded path."""
    arr = getattr(et, name)
    if arr is None:
        return None
    idx = torch.clamp(edge_ids, min=0)
    if isinstance(et, ShardedEdgeTable):
        return sharded_row_gather(arr, et.edges_per_shard, et.axis, idx)
    return arr[idx]


# ---------------------------------------------------------------------------
# Owner-routed payload exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Striped(TensorStruct):
    """A payload leaf whose rows are striped over the graph axis: this
    rank holds rows ``[g * n / P, (g + 1) * n / P)`` of the flattened ids;
    ``logical_shape`` is the whole result's shape.  The partitioned plan
    all-gathers it over the axis (``parallel/train.py``), as the JAX plan
    reassembles its striped outputs."""

    local: torch.Tensor
    logical_shape: tuple = dataclasses.field(default=(),
                                             metadata={"static": True})
    axis: str = dataclasses.field(default=GRAPH_AXIS,
                                  metadata={"static": True})

    def assemble(self) -> torch.Tensor:
        return all_gather(self.local, self.axis).reshape(self.logical_shape)


class _OwnerCtx(threading.local):
    axis: Optional[str] = None
    nshards: int = 0


_OWNER = _OwnerCtx()


def owner_routing_active() -> bool:
    return _OWNER.axis is not None


@contextlib.contextmanager
def owner_routing(axis_name: str, nshards: int):
    """Owner-routed payload gathers for the code inside (the partitioned
    plan under ``conf.partition_routing == "owner"``)."""
    prev = (_OWNER.axis, _OWNER.nshards)
    _OWNER.axis, _OWNER.nshards = axis_name, nshards
    try:
        yield
    finally:
        _OWNER.axis, _OWNER.nshards = prev


def _route_capacity(m: int, p: int) -> int:
    """Bucket capacity per (sender, owner): max(ceil(m * factor / p) + 8,
    8), at most m (``conf.owner_route_capacity``, default 2.0)."""
    from graph_learn_tpu_torch.config import conf
    factor = conf.owner_route_capacity
    return int(min(m, max(int(-(-m * factor // p)) + 8, 8)))


def owner_routed_gather(arr: torch.Tensor, rps: int, axis_name: str,
                        flat_ids: torch.Tensor,
                        nshards: int) -> torch.Tensor:
    """``arr`` rows for THIS rank's stripe of ``flat_ids`` [n] (the same
    on every rank of the axis): [n / P, ...].

    The stripe's ids are bucketed by owner into [P, c] requests (slots
    past the capacity ``c`` overflow), sent with one ``all_to_all``; each
    owner gathers its rows (Kernel 1 for a float table) and sends them
    back with a second.  Overflowed ids are answered exactly by the psum
    stitch, after a psum of the overflow count that every rank branches
    on alike (the JAX package's ``lax.cond``)."""
    p = nshards
    n = flat_ids.shape[0]
    m = n // p
    g = axis_index(axis_name)
    dev = flat_ids.device
    my = flat_ids.to(torch.int32)[g * m:(g + 1) * m]
    owner = torch.clamp(torch.div(my, rps, rounding_mode="floor"), 0, p - 1)
    c = _route_capacity(m, p)
    onehot = owner[:, None] == torch.arange(p, dtype=torch.int32,
                                            device=dev)[None, :]
    pos = torch.gather(torch.cumsum(onehot.to(torch.int32), dim=0) - 1, 1,
                       owner[:, None].long())[:, 0]
    overflow = pos >= c
    slot = torch.clamp(pos, max=c)  # overflow parks in the spare column
    buckets = torch.full((p, c + 1), -1, dtype=torch.int32, device=dev)
    buckets[owner.long(), slot.long()] = torch.where(overflow, -1, my)
    req = all_to_all(buckets[:, :c], axis_name)  # [p, c] ids to serve
    loc = req - g * rps
    own = (loc >= 0) & (loc < rps) & (req >= 0)
    locc = torch.clamp(loc, 0, rps - 1)
    vals = local_rows(arr, locc.reshape(-1)).reshape(
        (p, c) + tuple(arr.shape[1:]))
    ownm = own.reshape(tuple(own.shape) + (1,) * (vals.dim() - own.dim()))
    vals = torch.where(ownm, vals, torch.zeros((), dtype=vals.dtype,
                                               device=dev))
    resp = all_to_all(vals, axis_name)  # [p, c, ...] answers
    out = resp[owner.long(), torch.clamp(pos, max=c - 1).long()]
    ofm = overflow.reshape(tuple(overflow.shape) + (1,) * (out.dim() - 1))
    zero = torch.zeros((), dtype=out.dtype, device=dev)
    out = torch.where(ofm, zero, out)

    n_over = psum(overflow.sum().to(torch.int32).reshape(1), axis_name)
    if int(n_over[0]) > 0:
        locf, ownf = own_rows(rps, axis_name, my)
        keep = (ownf & overflow).reshape(tuple(overflow.shape)
                                         + (1,) * (out.dim() - 1))
        dense = torch.where(keep, local_rows(arr, locf), zero)
        extra = psum(dense, axis_name)
    else:
        extra = torch.zeros_like(out)
    return out + extra


def defer_payload(arr: Optional[torch.Tensor], rps: int, axis_name: str,
                  ids: torch.Tensor) -> Optional[Striped]:
    """Owner-route a payload gather where the context allows it, else None.

    Eligible: owner routing is on for this axis, ``arr`` holds a vector
    per row (ndim >= 2: the expensive leaves) and the flattened ids split
    evenly over the axis."""
    if arr is None or not owner_routing_active():
        return None
    if _OWNER.axis != axis_name or arr.dim() < 2:
        return None
    p = _OWNER.nshards
    flat = ids.reshape(-1)
    if p <= 1 or flat.shape[0] % p != 0:
        return None
    local = owner_routed_gather(arr, rps, axis_name, flat, p)
    return Striped(local=local,
                   logical_shape=tuple(ids.shape) + tuple(arr.shape[1:]),
                   axis=axis_name)
