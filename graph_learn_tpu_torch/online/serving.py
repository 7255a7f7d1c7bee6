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

``refresh()`` after graph updates, the partitioned (graph-sharded) branch
and ``install_model`` wait for the online slice.
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
from graph_learn_tpu_torch.core.values import TensorStruct
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_SHUTDOWN = object()


def _map_result(fn, out: dict) -> dict:
    """Apply ``fn`` to every tensor of a {alias: value} result."""
    return {a: v.map(fn) if isinstance(v, TensorStruct) else fn(v)
            for a, v in out.items()}


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
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(conf.seed)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        ns = query.graph.store.node_set(query.source.node_type)
        self._index = query.graph.store.node_table(ns.base_type).index
        self._tables = query.device_tables(self.device)
        self.latencies: List[float] = []
        self.served = 0
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._worker = threading.Thread(
            target=self._serve_loop, name="glt-serve-q%d" % qid, daemon=True)
        self._worker.start()

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
            _map_result(lambda x: x.record_stream(caller), p.result)
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
        while total < self.micro_batch:
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
            off = 0
            for p in batch:
                lo, hi = off, off + p.ids.size
                p.result = _map_result(lambda x: x[lo:hi], out)
                off = hi
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
        idx = self._index.lookup(ids)
        n = idx.size
        mb = self.micro_batch
        outs = []
        for off in range(0, n, mb):
            chunk = idx[off:off + mb]
            if chunk.size < mb:
                chunk = np.pad(chunk, (0, mb - chunk.size), mode="edge")
            seeds = torch.as_tensor(chunk, dtype=torch.int32,
                                    device=self.device)
            outs.append(_execute(self.query, self._tables, seeds,
                                 self._generator))
        out = outs[0] if len(outs) == 1 else {
            a: _cat([o[a] for o in outs]) for a in outs[0]}
        out = _map_result(lambda x: x[:n], out)
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


class QueryService:
    """Install/run surface of the serving tier, on one device (the card
    unless ``device="cpu"``)."""

    def __init__(self, graph, device: DeviceLike = "cuda"):
        self.graph = graph
        self.device = resolve_device(device)
        self._queries: Dict[int, InstalledQuery] = {}
        self._next = 0

    def install(self, query: Query, micro_batch: int = 256) -> int:
        qid = self._next
        self._next += 1
        self._queries[qid] = InstalledQuery(self, qid, query, micro_batch)
        return qid

    def run(self, qid: int, ids) -> dict:
        return self._queries[qid].run(ids)

    def stats(self, qid: int) -> Dict[str, float]:
        return self._queries[qid].stats()

    def close(self):
        for q in self._queries.values():
            q.close()
        self._queries.clear()
