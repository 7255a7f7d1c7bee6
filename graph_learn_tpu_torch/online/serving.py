"""Online query serving: installed GSL queries answered on the card.

Counterpart of ``graph_learn_tpu/online/serving.py`` ``InstalledQuery:74``
and ``QueryService:345`` on a single device.  Each installed query owns a
dispatcher thread that coalesces concurrent callers: it drains every
pending request into one padded micro-batch, runs the plan once per
micro-batch and slices the result back per caller.

The dispatcher launches its work on a CUDA stream of its own and
synchronises that stream before any caller is woken (where the JAX
package calls ``jax.block_until_ready``).  A woken caller's tensors are
then complete; ``run`` records them on the caller's current stream so the
caching allocator does not hand their memory back to the dispatcher while
the caller's own kernels may still read it.

A query with a ``SubGraph`` node answers values that are not aligned with
the seeds (the node set is the union over the whole launch), so, as in the
JAX package (``:86-92``, ``:255-274``), each of its requests gets a launch
of its own, padded to the micro-batch and not sliced: its ``SubGraphVal``
keeps the launch's shapes, its other values are cut to the request's ids,
and a request longer than the micro-batch is refused.

Every round reads one immutable ``_Snapshot`` (the id index and the
device tables, captured together) and serves its whole batch from it, as
``graph_learn_tpu/online/serving.py:46-61`` does.  ``refresh()`` (after
``online/update.py apply_updates``) drops the tables' device views,
builds the next snapshot on the calling thread (the update pump's) while
rounds keep serving the current one, waits for its uploads to finish,
then swaps it in.  A round keeps its snapshot until its stream is
synchronised, so the old tables outlive every launch that reads them;
a caller's answer that still holds a table (its deferred feature rows)
records that table on the caller's stream too.

``install_model`` / ``predict`` serve an exported sample+forward program
(``online/export.py``, a ``torch.export`` program) by name:
``InstalledModel`` pads a request to the program's batch with its first
id and trims every output whose leading axis is that batch, as
``:327-342`` does.

**The partitioned service** (``graph_shards = P > 1``,
``graph_learn_tpu/online/serving.py:108-156``, ``:345-366``): the served
store is range-partitioned over the mesh's "graph" axis
(``parallel/sharded_store.py``), each rank holding one block, so the
served graph grows with the number of devices.  The JAX service is one
process that runs the partitioned plan as one SPMD program; here each
rank is a process (``parallel.bootstrap.init_cluster`` or
``parallel.launch.spawn``) and every rank builds the service.  Graph rank
0 is the **leader**: it keeps the surface above (callers, dispatchers,
``refresh``, exported models, which stay on the leader alone).  Every
other rank is a **follower** that calls :meth:`QueryService.follow` and
runs the leader's commands, in the leader's order, until the leader
closes the service:

- the commands (install, round, swap, close) travel over a gloo group
  made for them alone (:class:`_ControlStream`), as CPU tensors;
- a round sends the padded int32 chunk, then every rank runs the plan
  (``parallel/train.py make_partitioned_plan``) on it; a request's rounds
  run under the stream's lock, so the collectives of two queries never
  interleave and a request reads one snapshot on every rank;
- every rank's generator is seeded with ``conf.seed`` and advanced by
  the same launches, so the partitioned plan draws what the one-rank
  plan draws and its answers are the one-rank service's, bit for bit;
- ids that are not found, and a SubGraph request longer than the
  micro-batch, are refused on the leader before anything is sent;
- ``refresh()`` builds the next host blocks of all P shards on the
  leader's thread (the JAX service builds all P there too) and its own
  upload while rounds go on; then, under the lock, each follower gets
  the leaves of its block that changed and the replicated arrays, uploads
  them through ``ShardedTables.replace_blocks`` and answers with its
  bytes, and every rank swaps at that point of the stream.  So after a
  refresh each rank's block is the one ``build_sharded_tables(leader's
  graph, P, slack, shard=p)`` gives, without the followers' graphs ever
  changing; ``last_refresh_upload_bytes`` sums the ranks;
- an install sends each follower its whole block (the leader's graph
  may have taken updates since the ranks built theirs), the plan record
  (``gsl/plan.py``) and the leader's ``conf``, whose flags every rank's
  plan must read alike;
- a rank that dies fails the others' next collective, and the leader's
  ``run`` raises; the service then refuses every command.  ``close()``
  ends every follower's ``follow``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import pickle
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.values import (SubGraphVal, TensorStruct,
                                              map_result)
from graph_learn_tpu_torch.errors import InvalidArgumentError, NotFoundError
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_SHUTDOWN = object()


class _Snapshot:
    """What one round serves from: the host id index and the device tables
    of one state of the store, captured together so that a refresh can
    never remap rows under a request in flight.  On a partitioned service
    ``tables`` is this rank's placed ``ShardedTables`` (its ``stacked``
    keeps the host blocks of all P shards on the leader) and ``plan`` the
    partitioned plan made over it."""

    __slots__ = ("index", "tables", "plan")

    def __init__(self, index, tables, plan=None):
        self.index = index
        self.tables = tables
        self.plan = plan


class _Pending:
    __slots__ = ("ids", "event", "result", "error", "t0")

    def __init__(self, ids: np.ndarray):
        self.ids = ids
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()


class InstalledQuery:
    def __init__(self, service: "QueryService", qid: int, query: Query,
                 micro_batch: int):
        self.service = service
        self.qid = qid
        self.query = query
        self.micro_batch = micro_batch
        self.device = service.device
        if query.source.kind != "source_v":
            raise InvalidArgumentError("serving expects a V() query")
        self._seed_aligned = not any(n.kind == "subgraph"
                                     for n in query.dag.nodes)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(conf.seed)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._control = service._control  # None: one rank
        self.last_refresh_upload_bytes = 0
        if self._control is None:
            self._snap = self._build_snapshot()
        else:
            self._snap, self.last_refresh_upload_bytes = \
                self._partitioned_snapshot()
        self.latencies: List[float] = []
        self.served = 0
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._worker = threading.Thread(
            target=self._serve_loop, name="glt-serve-q%d" % qid, daemon=True)
        self._worker.start()

    # -- snapshot lifecycle ------------------------------------------------
    def _build_snapshot(self) -> _Snapshot:
        """The store's current state on the device; returns once its uploads
        have finished, so a round on another stream may read it at once."""
        store = self.query.graph.store
        ns = store.node_set(self.query.source.node_type)
        snap = _Snapshot(store.node_table(ns.base_type).index,
                         self.query.device_tables(self.device))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return snap

    def _partitioned_snapshot(self, prev: Optional[_Snapshot] = None,
                              builds: Optional[dict] = None):
        """(the next snapshot, this rank's upload bytes): the host blocks of
        all P shards, this rank's placed (or, after ``prev``, replaced)
        and the plan over it; returns once the uploads have finished.
        ``builds`` shares the host blocks among the queries of one
        refresh that read the same tables."""
        from graph_learn_tpu_torch.parallel.sharded_store import (
            _query_types, build_sharded_tables)
        from graph_learn_tpu_torch.parallel.train import \
            make_partitioned_plan
        svc = self.service
        store = self.query.graph.store
        # the .where() tables in a block's replicated part are the query's
        key = (id(self.query) if any(n.strategy == "conditional"
                                     for n in self.query.dag.nodes)
               else tuple(tuple(sorted(t))
                          for t in _query_types(self.query)))
        builds = {} if builds is None else builds
        if key not in builds:
            builds[key] = build_sharded_tables(
                self.query, svc.graph_shards, slack=conf.serving_shard_slack)
        host = builds[key]
        if prev is None:
            placed = host.place(svc.mesh, device=self.device)
            up = placed.device_bytes()
        else:
            placed, up = prev.tables.replace_blocks(host)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        ns = store.node_set(self.query.source.node_type)
        return _Snapshot(store.node_table(ns.base_type).index, placed,
                         make_partitioned_plan(self.query, svc.mesh,
                                               placed)), up

    def _swap_partitioned(self, builds: Optional[dict] = None):
        """A partitioned refresh (module note): the next snapshot built here
        while rounds go on, then each follower's changed leaves and the
        swap on every rank, at one point of the command stream."""
        with self.service._refresh_lock:
            prev = self._snap
            snap, up = self._partitioned_snapshot(prev, builds)
            payloads = {r: _block_payload(self.query, snap.tables, g,
                                          prev.tables)
                        for g, r in enumerate(self._control.ranks) if g}
            with self._control.command():
                acks = self._control.send(_SWAP, self.qid,
                                          payloads=payloads)
                self._snap = snap
            self.last_refresh_upload_bytes = up + sum(acks)

    def refresh(self):
        """Pick up applied graph updates: drop every table's device views,
        build the next snapshot while rounds keep serving the current one,
        then swap it in (rounds in flight keep theirs)."""
        _drop_device_views(self.query.graph.store)
        if self._control is None:
            self._snap = self._build_snapshot()
        else:
            self._swap_partitioned()

    def close(self):
        self._queue.put(_SHUTDOWN)
        self._worker.join(timeout=5)

    # -- request path ------------------------------------------------------
    def run(self, ids) -> dict:
        """Serve raw seed ids -> {alias: value}.  Thread-safe; concurrent
        callers are coalesced into shared launches."""
        p = _Pending(np.asarray(ids, np.int64).reshape(-1))
        self._queue.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        if self._stream is not None:
            caller = torch.cuda.current_stream(self.device)
            map_result(lambda x: x.record_stream(caller), p.result)
            for table in _static_tensors(p.result):
                table.record_stream(caller)
        return p.result

    def _serve_loop(self):
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            while self._serve_once():
                pass

    def _serve_once(self) -> bool:
        """One dispatcher round: drain pending requests -> one result."""
        first = self._queue.get()
        if first is _SHUTDOWN:
            return False
        batch = [first]
        total = first.ids.size
        # a SubGraph query's answers cannot be sliced per caller: one
        # request a launch
        while self._seed_aligned and total < self.micro_batch:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                self._queue.put(_SHUTDOWN)
                break
            batch.append(nxt)
            total += nxt.ids.size
        if self._first_t is None:
            self._first_t = time.perf_counter()
        ok = False
        try:
            out = self._execute_batch(np.concatenate([p.ids for p in batch]))
            if self._seed_aligned:
                off = 0
                for p in batch:
                    lo, hi = off, off + p.ids.size
                    p.result = map_result(lambda x: x[lo:hi], out)
                    off = hi
            else:
                batch[0].result = out
            ok = True
        except Exception as e:  # deliver to the callers, keep serving
            for p in batch:
                p.error = e
        now = time.perf_counter()
        self._last_t = now
        for p in batch:
            if ok:
                self.latencies.append(now - p.t0)
                self.served += p.ids.size
            p.event.set()
        return True

    def _launch(self, snap: _Snapshot, chunk: np.ndarray) -> dict:
        """The plan on one padded micro-batch of dense ids: the one-rank
        plan, or the command to the followers and then the partitioned
        plan (under the stream's lock)."""
        seeds = torch.as_tensor(chunk, dtype=torch.int32, device=self.device)
        if self._control is None:
            return _execute(self.query, snap.tables, seeds, self._generator)
        try:
            self._control.send(_ROUND, self.qid, chunk=chunk)
            return snap.plan(seeds, self._generator)
        except Exception as e:  # the ranks may be mid-collective
            self._control.failed = e
            raise

    def _execute_batch(self, ids: np.ndarray) -> dict:
        lock = (self._control.command() if self._control is not None
                else contextlib.nullcontext())
        with lock:
            snap = self._snap  # one snapshot for the whole round
            idx = snap.index.lookup(ids)
            if not self._seed_aligned:
                return self._execute_unaligned(snap, idx)
            n = idx.size
            mb = self.micro_batch
            outs = []
            for off in range(0, n, mb):
                chunk = idx[off:off + mb]
                if chunk.size < mb:
                    chunk = np.pad(chunk, (0, mb - chunk.size), mode="edge")
                outs.append(self._launch(snap, chunk))
        out = outs[0] if len(outs) == 1 else {
            a: _cat([o[a] for o in outs]) for a in outs[0]}
        out = map_result(lambda x: x[:n], out)
        if self._stream is not None:
            self._stream.synchronize()
        return out

    def _execute_unaligned(self, snap: _Snapshot, idx: np.ndarray) -> dict:
        """One launch for the whole request of a SubGraph query, padded by
        repeating its last id (induction is over the seed set)."""
        n, mb = idx.size, self.micro_batch
        if n > mb:
            raise InvalidArgumentError(
                "subGraph serving request of %d ids exceeds the installed "
                "micro_batch %d; install with a larger micro_batch or split "
                "the request" % (n, mb))
        chunk = np.pad(idx, (0, mb - n), mode="edge") if n < mb else idx
        out = self._launch(snap, chunk)

        def trim(x):
            return x[:n] if x.dim() and x.shape[0] >= n else x

        # the padding is cut from the seed-aligned values only
        out = {a: v if isinstance(v, SubGraphVal) else
               v.map(trim) if isinstance(v, TensorStruct) else trim(v)
               for a, v in out.items()}
        if self._stream is not None:
            self._stream.synchronize()
        return out

    def stats(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies[1:] or self.latencies)
        if lat.size == 0:
            return {}
        wall = max((self._last_t or 0) - (self._first_t or 0), 1e-9)
        return {
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            # over the serving wall-clock window: honest under concurrency
            "qps": float(self.served / wall),
        }


def _cat(values):
    """Concatenate per-micro-batch values of one alias along the batch
    (nested structs included; ``static`` fields are kept from the first)."""
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(values, dim=0)
    changes = {}
    for f in dataclasses.fields(first):
        parts = [getattr(v, f.name) for v in values]
        if not f.metadata.get("static") and isinstance(
                parts[0], (torch.Tensor, TensorStruct)):
            changes[f.name] = _cat(parts)
    return first.replace(**changes)


def _drop_device_views(store):
    """Forget every table's device views, so the next ``device()`` call
    builds them from the host tables as they are now."""
    for t in list(store.nodes.values()) + list(store.edges.values()):
        t._device = {}


def _static_tensors(result: dict):
    """The whole tables an answer still points at (``static`` fields, such
    as a ``DeferredRows``' table), nested values included."""
    stack = [v for v in result.values() if isinstance(v, TensorStruct)]
    while stack:
        v = stack.pop()
        for f in dataclasses.fields(v):
            x = getattr(v, f.name)
            if isinstance(x, TensorStruct):
                stack.append(x)
            elif f.metadata.get("static") and isinstance(x, torch.Tensor):
                yield x


class InstalledModel:
    """An exported sample+forward program served by name (the counterpart
    of ``graph_learn_tpu/online/serving.py InstalledModel:308``): one
    ``torch.export`` program (online/export.py) with signature
    ``call(seeds: int32[batch], seed)``, so the worker answers model
    predictions without the model's Python code."""

    def __init__(self, name: str, artifact, device: torch.device):
        from graph_learn_tpu_torch.online.export import load_serving_exported
        self.name = name
        exp = load_serving_exported(artifact)
        seeds = exp.example_seeds
        if seeds.device.type != device.type:
            raise InvalidArgumentError(
                "model %r was exported for %s; this service runs on %s"
                % (name, seeds.device, device))
        self._call = exp.call
        self.batch = int(seeds.shape[0])

    def predict(self, ids, seed: int = 0):
        """Outputs for 1..batch raw seed ids: the request padded with its
        first id, then every output whose leading axis is the batch cut
        back to the request (numpy)."""
        ids = np.asarray(ids, np.int32)
        if ids.size == 0 or ids.size > self.batch:
            raise InvalidArgumentError(
                "predict takes 1..%d ids (the exported batch size), got %d"
                % (self.batch, ids.size))
        n = ids.size
        padded = np.concatenate(
            [ids, np.full(self.batch - n, ids[0], np.int32)])
        out = self._call(padded, seed)

        def trim(x):
            a = _numpy(x)
            return a[:n] if a.ndim >= 1 and a.shape[0] == self.batch else a

        return torch.utils._pytree.tree_map(trim, out)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class QueryService:
    """Install/run surface of the serving tier, on the card unless
    ``device="cpu"``.

    With ``graph_shards = P > 1`` the service is partitioned (module
    note): built on every rank of a P-rank process group (``mesh``
    default ``make_mesh(n_data=1, n_graph=P)``), graph rank 0 leads with
    this surface and every other rank calls :meth:`follow`."""

    def __init__(self, graph, mesh=None, device: DeviceLike = "cuda",
                 graph_shards: int = 1):
        self.graph = graph
        self.device = resolve_device(device)
        self.graph_shards = graph_shards
        self.mesh = mesh
        self._control: Optional[_ControlStream] = None
        if graph_shards > 1:
            self._control = self._join_ranks(mesh)
        self._queries: Dict[int, InstalledQuery] = {}
        self._models: Dict[str, InstalledModel] = {}
        self._next = 0
        self._refresh_lock = threading.RLock()
        self._followed: Dict[int, _FollowerQuery] = {}  # a follower's

    def _join_ranks(self, mesh) -> "_ControlStream":
        import torch.distributed as dist

        from graph_learn_tpu_torch.core.sharding import (DATA_AXIS,
                                                         GRAPH_AXIS,
                                                         mesh_axis)
        from graph_learn_tpu_torch.parallel.mesh import make_mesh
        if mesh is None:
            mesh = make_mesh(n_data=1, n_graph=self.graph_shards,
                             device=self.device.type)
        graph = mesh_axis(mesh, GRAPH_AXIS)
        if graph.size != self.graph_shards:
            raise InvalidArgumentError(
                "QueryService(graph_shards=%d) on a mesh whose graph axis "
                "has %d ranks" % (self.graph_shards, graph.size))
        if mesh_axis(mesh, DATA_AXIS).size != 1:
            raise InvalidArgumentError(
                "a partitioned QueryService serves on a mesh (1, P): every "
                "rank answers the leader's whole batch")
        self.mesh = mesh
        self._shard = graph.index
        return _ControlStream(dist.get_process_group_ranks(graph.group))

    @property
    def is_leader(self) -> bool:
        """True on a one-rank service and on the leader of a partitioned
        one."""
        return self._control is None or self._control.is_leader

    def _lead(self, what: str):
        if not self.is_leader:
            raise InvalidArgumentError(
                "%s is the leader's: this rank of the partitioned service "
                "follows it (QueryService.follow)" % what)

    def install(self, query: Query, micro_batch: int = 256) -> int:
        self._lead("install")
        qid = self._next
        if self._control is not None:
            from graph_learn_tpu_torch.gsl.plan import query_to_plan
            record = query_to_plan(query)  # refused before anything is sent
        iq = InstalledQuery(self, qid, query, micro_batch)
        if self._control is not None:
            try:
                payloads = {r: dict(_block_payload(query, iq._snap.tables, g),
                                    plan=record, micro_batch=micro_batch,
                                    conf=dataclasses.asdict(conf))
                            for g, r in enumerate(self._control.ranks) if g}
                with self._control.command():
                    acks = self._control.send(_INSTALL, qid,
                                              payloads=payloads)
            except BaseException:
                iq.close()
                raise
            iq.last_refresh_upload_bytes += sum(acks)
        self._next += 1
        self._queries[qid] = iq
        return qid

    def install_model(self, name: str, artifact) -> InstalledModel:
        """Serve the exported program ``artifact`` (a path or its bytes) as
        ``name`` (on the leader alone, on one device, as in JAX)."""
        self._lead("install_model")
        m = InstalledModel(name, artifact, self.device)
        self._models[name] = m
        return m

    def predict(self, name: str, ids, seed: int = 0):
        if name not in self._models:
            raise NotFoundError("unknown model %r" % name)
        return self._models[name].predict(ids, seed=seed)

    def run(self, qid: int, ids) -> dict:
        return self._queries[qid].run(ids)

    def refresh(self):
        """Every installed query picks up applied updates: the device views
        are dropped once, then each query builds and swaps its snapshot
        (queries over the same tables share one upload; a partitioned
        query swaps on every rank, module note)."""
        self._lead("refresh")
        with self._refresh_lock:
            _drop_device_views(self.graph.store)
            builds: dict = {}
            for q in self._queries.values():
                if self._control is None:
                    q._snap = q._build_snapshot()
                else:
                    q._swap_partitioned(builds)

    def stats(self, qid: int) -> Dict[str, float]:
        return self._queries[qid].stats()

    def close(self):
        """Stop every dispatcher; on a partitioned leader, end every
        follower's :meth:`follow` too."""
        for q in self._queries.values():
            q.close()
        self._queries.clear()
        ctl = self._control
        if ctl is not None and ctl.is_leader and ctl.failed is None \
                and not ctl.closed:
            with ctl.command():
                ctl.send(_CLOSE)
            ctl.closed = True

    def follow(self):
        """A follower's loop: run the leader's commands in the leader's
        order; returns when the leader closes the service, raises when a
        rank fails (the leader's death among them)."""
        ctl = self._control
        if ctl is None or ctl.is_leader:
            raise InvalidArgumentError(
                "follow() is for the followers of a partitioned service")
        queries = self._followed
        while True:
            cmd, qid, n = ctl.recv_header()
            if cmd == _CLOSE:
                ctl.closed = True
                return
            if cmd == _ROUND:
                chunk = ctl.recv_chunk(n)
                fq = queries[qid]
                fq.plan(torch.as_tensor(chunk, device=self.device),
                        fq.generator)
            elif cmd in (_INSTALL, _SWAP):
                payload = ctl.recv_obj()
                try:
                    if cmd == _INSTALL:
                        queries[qid] = _FollowerQuery(self, payload)
                        uploaded = queries[qid].uploaded
                    else:
                        uploaded = queries[qid].swap(payload)
                except BaseException:
                    ctl.ack(-1)  # the leader must not wait for this rank
                    raise
                ctl.ack(uploaded)
            else:
                raise RuntimeError("unknown command %d from the leader"
                                   % cmd)


# the partitioned service's commands
_INSTALL, _ROUND, _SWAP, _CLOSE = 1, 2, 3, 4
# a follower waits for the leader's next command for as long as the
# service lives; a dead leader's closed sockets end the wait, not a clock
_CONTROL_TIMEOUT = datetime.timedelta(days=365)


class _ControlStream:
    """The leader's command stream to the followers of a partitioned
    service: a gloo group of the graph axis's ranks (leader first) made for
    control messages alone, carrying CPU tensors.  A command is a header
    [cmd, qid, n] broadcast from the leader, then the round's chunk
    (broadcast) or each follower's pickled payload (sent to it alone), and
    the followers' acknowledgements.  On the leader every command and the
    work it starts run under :meth:`command`, so the ranks meet them in
    one order; once one fails, every later command is refused."""

    def __init__(self, ranks):
        import torch.distributed as dist
        self.ranks = list(ranks)
        self.leader = self.ranks[0]
        self.is_leader = dist.get_rank() == self.leader
        self.group = dist.new_group(self.ranks, backend="gloo",
                                    timeout=_CONTROL_TIMEOUT)
        self.lock = threading.Lock()
        self.failed: Optional[BaseException] = None
        self.closed = False

    @contextlib.contextmanager
    def command(self):
        with self.lock:
            if self.failed is not None:
                raise RuntimeError(
                    "the ranks of the partitioned service are out of step "
                    "since a command failed: %r" % (self.failed,))
            if self.closed:
                raise InvalidArgumentError("the service is closed")
            yield

    def send(self, cmd: int, qid: int = 0, chunk=None, payloads=None):
        """(leader, under :meth:`command`) One command; returns the
        followers' acknowledgements when ``payloads`` ({rank: object})
        are sent."""
        import torch.distributed as dist
        try:
            n = 0 if chunk is None else int(chunk.size)
            dist.broadcast(torch.tensor([cmd, qid, n], dtype=torch.int64),
                           src=self.leader, group=self.group)
            if chunk is not None:
                dist.broadcast(torch.from_numpy(
                    np.ascontiguousarray(chunk, np.int32)),
                    src=self.leader, group=self.group)
            if payloads is None:
                return []
            for r in self.ranks[1:]:
                data = pickle.dumps(payloads[r],
                                    protocol=pickle.HIGHEST_PROTOCOL)
                dist.send(torch.tensor([len(data)], dtype=torch.int64), r,
                          group=self.group)
                dist.send(torch.frombuffer(bytearray(data),
                                           dtype=torch.uint8), r,
                          group=self.group)
            acks = []
            for r in self.ranks[1:]:
                ack = torch.zeros(1, dtype=torch.int64)
                dist.recv(ack, r, group=self.group)
                acks.append(int(ack[0]))
            if min(acks) < 0:
                raise RuntimeError("rank(s) %s failed command %d"
                                   % ([r for r, a in zip(self.ranks[1:], acks)
                                       if a < 0], cmd))
            return acks
        except Exception as e:
            self.failed = e
            raise

    def recv_header(self):
        import torch.distributed as dist
        t = torch.zeros(3, dtype=torch.int64)
        dist.broadcast(t, src=self.leader, group=self.group)
        return [int(x) for x in t]

    def recv_chunk(self, n: int) -> torch.Tensor:
        import torch.distributed as dist
        t = torch.empty(n, dtype=torch.int32)
        dist.broadcast(t, src=self.leader, group=self.group)
        return t

    def recv_obj(self):
        """The leader's payload: bytes this program pickled."""
        import torch.distributed as dist
        size = torch.zeros(1, dtype=torch.int64)
        dist.recv(size, self.leader, group=self.group)
        data = torch.empty(int(size[0]), dtype=torch.uint8)
        dist.recv(data, self.leader, group=self.group)
        return pickle.loads(data.numpy().tobytes())

    def ack(self, value: int):
        import torch.distributed as dist
        dist.send(torch.tensor([value], dtype=torch.int64), self.leader,
                  group=self.group)


def _leaf_paths(tree, prefix=()):
    """(path, leaf) of a nested dict of host arrays."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _shard_block(a, g: int):
    """Shard ``g``'s block of a stacked host leaf, [1, ...], in memory of
    its own (a pickled tensor view carries its whole storage)."""
    if isinstance(a, torch.Tensor):
        return a[g:g + 1].clone()
    return np.ascontiguousarray(a[g:g + 1])


def _block_payload(query, host, g: int, prev=None) -> dict:
    """What follower ``g`` needs to hold shard ``g`` of ``host`` (the
    ShardedTables of all P blocks): every leaf path, the leaves that
    differ from ``prev``'s (all of them without ``prev``), the replicated
    arrays, the metadata and the ``.where()`` condition tables built
    here."""
    from graph_learn_tpu_torch.gsl.compile import build_condition_tables
    from graph_learn_tpu_torch.parallel.sharded_store import same_leaf
    old = dict(_leaf_paths(prev.stacked)) if prev is not None else {}
    paths, blocks = [], {}
    for path, leaf in _leaf_paths(host.stacked):
        paths.append(path)
        if path not in old or not same_leaf(old[path][g], leaf[g]):
            blocks[path] = _shard_block(leaf, g)
    conditional = any(n.strategy == "conditional" for n in query.dag.nodes)
    return {"paths": paths, "blocks": blocks, "repl": host.repl,
            "meta": host.meta, "num_shards": host.num_shards,
            "cond": build_condition_tables(query, "cpu")
            if conditional else {}}


class _FollowerQuery:
    """A follower's side of one installed query: the query rebuilt from
    the leader's plan record over this rank's graph, its block placed from
    the leader's payload, the plan over it and a generator seeded as the
    leader's."""

    def __init__(self, service: QueryService, payload: dict):
        from graph_learn_tpu_torch.gsl.plan import plan_to_query
        for k, v in payload["conf"].items():
            setattr(conf, k, v)
        self.service = service
        self.query = plan_to_query(service.graph, payload["plan"])
        self.micro_batch = payload["micro_batch"]
        self.generator = torch.Generator(device=service.device)
        self.generator.manual_seed(conf.seed)
        self.tables = self._host(payload, None).place(
            service.mesh, device=service.device)
        self.uploaded = self.tables.device_bytes()
        self._plan()

    def _host(self, payload: dict, old):
        """The host tables of this rank's shard after ``payload``."""
        from graph_learn_tpu_torch.parallel.sharded_store import ShardedTables
        have = dict(_leaf_paths(old.stacked)) if old is not None else {}
        stacked: dict = {}
        for path in payload["paths"]:
            _set_path(stacked, path, payload["blocks"][path]
                      if path in payload["blocks"] else have[path])
        return ShardedTables(stacked=stacked,
                             repl=dict(payload["repl"], cond=payload["cond"]),
                             meta=payload["meta"],
                             num_shards=payload["num_shards"],
                             shards=(self.service._shard,), query=self.query)

    def _plan(self):
        from graph_learn_tpu_torch.parallel.train import \
            make_partitioned_plan
        self.plan = make_partitioned_plan(self.query, self.service.mesh,
                                          self.tables)

    def swap(self, payload: dict) -> int:
        """Take the leader's next block (the changed leaves uploaded, the
        others kept on the device); returns the bytes uploaded."""
        self.tables, up = self.tables.replace_blocks(
            self._host(payload, self.tables))
        self._plan()
        return up
