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
``:327-342`` does.  The partitioned (graph-sharded) branch over the
parallel store is not yet ported (A3b): ``graph_shards > 1`` raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.values import (SubGraphVal, TensorStruct,
                                              map_result)
from graph_learn_tpu_torch.errors import (InvalidArgumentError,
                                          NotFoundError, UnimplementedError)
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_SHUTDOWN = object()


class _Snapshot:
    """What one round serves from: the host id index and the device tables
    of one state of the store, captured together so that a refresh can
    never remap rows under a request in flight."""

    __slots__ = ("index", "tables")

    def __init__(self, index, tables):
        self.index = index
        self.tables = tables


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
        self._snap = self._build_snapshot()
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

    def refresh(self):
        """Pick up applied graph updates: drop every table's device views,
        build the next snapshot while rounds keep serving the current one,
        then swap it in (rounds in flight keep theirs)."""
        _drop_device_views(self.query.graph.store)
        self._snap = self._build_snapshot()

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

    def _execute_batch(self, ids: np.ndarray) -> dict:
        snap = self._snap  # one snapshot for the whole round
        idx = snap.index.lookup(ids)
        n = idx.size
        mb = self.micro_batch
        if not self._seed_aligned:
            return self._execute_unaligned(snap, idx)
        outs = []
        for off in range(0, n, mb):
            chunk = idx[off:off + mb]
            if chunk.size < mb:
                chunk = np.pad(chunk, (0, mb - chunk.size), mode="edge")
            seeds = torch.as_tensor(chunk, dtype=torch.int32,
                                    device=self.device)
            outs.append(_execute(self.query, snap.tables, seeds,
                                 self._generator))
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
        out = _execute(self.query, snap.tables,
                       torch.as_tensor(chunk, dtype=torch.int32,
                                       device=self.device), self._generator)
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
    """Install/run surface of the serving tier, on one device (the card
    unless ``device="cpu"``).  ``graph_shards > 1`` (the partitioned
    store over a mesh) is not yet ported."""

    def __init__(self, graph, device: DeviceLike = "cuda",
                 graph_shards: int = 1):
        if graph_shards > 1:
            raise UnimplementedError(
                "QueryService(graph_shards=%d): partitioned serving is not "
                "yet ported (A3b)" % graph_shards)
        self.graph = graph
        self.device = resolve_device(device)
        self._queries: Dict[int, InstalledQuery] = {}
        self._models: Dict[str, InstalledModel] = {}
        self._next = 0

    def install(self, query: Query, micro_batch: int = 256) -> int:
        qid = self._next
        self._next += 1
        self._queries[qid] = InstalledQuery(self, qid, query, micro_batch)
        return qid

    def install_model(self, name: str, artifact) -> InstalledModel:
        """Serve the exported program ``artifact`` (a path or its bytes) as
        ``name``."""
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
        (queries over the same tables share one upload)."""
        _drop_device_views(self.graph.store)
        for q in self._queries.values():
            q._snap = q._build_snapshot()

    def stats(self, qid: int) -> Dict[str, float]:
        return self._queries[qid].stats()

    def close(self):
        for q in self._queries.values():
            q.close()
        self._queries.clear()
