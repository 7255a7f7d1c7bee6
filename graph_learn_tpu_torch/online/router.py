"""Multi-worker serving: vid-hash routing with stitched answers, update
fan-out, latency-adaptive admission of updates, and the coordinator's
barrier and checkpoint.

Counterpart of ``graph_learn_tpu/online/router.py`` (``RateLimiter:40``,
``ServingRouter:96``), host code over ``ServingClient``-compatible
workers (URLs or client objects), the JAX package's logic line for line:

- a query's ids go to their owners (``vid % workers``, the DGS partition
  rule) and the per-worker answers are stitched back in request order,
  nested payloads (an ``outE`` alias's ``src_nodes`` / ``dst_nodes``)
  included;
- installs, updates and refreshes fan out to every worker, which hold
  replicas of the graph;
- ``RateLimiter`` admits updates at a rate that halves while the routed
  queries' p99 is over its target and recovers additively below it, on a
  fixed interval;
- ``barrier()`` bars updates and drains the queries and updates in
  flight; ``checkpoint(logs)`` records each worker's update-log offset
  inside it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from graph_learn_tpu_torch.errors import InvalidArgumentError, NotFoundError
from graph_learn_tpu_torch.online.http import ServingClient


class RateLimiter:
    """Latency-adaptive admission for update ingestion.

    Mirrors the control law of the reference's AdaptiveRateLimiter
    (adaptive_rate_limiter.h:30): when observed serving latency exceeds
    ``target_p99_ms``, the admitted update rate decays multiplicatively;
    when it is comfortably below, the rate recovers additively.
    """

    def __init__(self, target_p99_ms: float = 20.0,
                 max_updates_per_s: float = 100.0,
                 min_updates_per_s: float = 1.0,
                 adjust_interval_s: float = 1.0):
        self.target = target_p99_ms
        self.max_rate = max_updates_per_s
        self.min_rate = min_updates_per_s
        self.rate = max_updates_per_s
        self.adjust_interval = adjust_interval_s
        self._lat: List[float] = []
        self._last_admit = 0.0
        self._last_adjust = time.monotonic()
        self._lock = threading.Lock()

    def observe_latency(self, ms: float):
        with self._lock:
            self._lat.append(ms)
            if len(self._lat) > 256:
                self._lat = self._lat[-256:]

    def _adjust(self, now: float):
        """One AIMD step.  Runs on a FIXED wall-clock interval — never per
        admit() poll — so the control law's time constant is independent
        of caller polling frequency (the reference's AdaptiveRateLimiter
        is likewise interval-driven, adaptive_rate_limiter.h:30)."""
        if now - self._last_adjust < self.adjust_interval:
            return
        self._last_adjust = now
        if not self._lat:
            return
        p99 = float(np.percentile(np.asarray(self._lat[-64:]), 99))
        if p99 > self.target:
            self.rate = max(self.min_rate, self.rate * 0.5)
        else:
            self.rate = min(self.max_rate, self.rate + self.max_rate * 0.05)

    def admit(self) -> bool:
        """True if an update may be applied now (token at current rate)."""
        with self._lock:
            now = time.monotonic()
            self._adjust(now)
            if now - self._last_admit >= 1.0 / max(self.rate, 1e-6):
                self._last_admit = now
                return True
            return False


class ServingRouter:
    """Client-side router over N serving workers (DGS: coordinator +
    partitioned serving workers behind one logical endpoint).

    Workers are ``ServingClient``-compatible endpoints (URLs or client
    objects).  Queries hash-route by vid; installs/updates/refresh fan
    out; stats aggregate.
    """

    def __init__(self, workers: Sequence, target_p99_ms: float = 20.0):
        if not workers:
            raise InvalidArgumentError("router needs >= 1 worker")
        self.workers = [w if not isinstance(w, str) else ServingClient(w)
                        for w in workers]
        self.limiter = RateLimiter(target_p99_ms=target_p99_ms)
        self._qids: Dict[int, List[int]] = {}
        self._next = 0
        self._paused = threading.Event()  # set = updates barred (barrier)
        # in-flight run()/update() calls, drained by barrier()
        self._inflight = 0
        self._quiesce = threading.Condition()

    def _enter_flight(self):
        with self._quiesce:
            self._inflight += 1

    def _exit_flight(self):
        with self._quiesce:
            self._inflight -= 1
            if self._inflight == 0:
                self._quiesce.notify_all()

    # -- query plane -----------------------------------------------------
    def install(self, query_or_plan, micro_batch: int = 256) -> int:
        per_worker = [w.install(query_or_plan, micro_batch=micro_batch)
                      for w in self.workers]
        qid = self._next
        self._next += 1
        self._qids[qid] = per_worker
        return qid

    def _owner(self, vid: int) -> int:
        # hash(vid) % workers — the DGS partition rule
        # (dynamic_graph_service/src/common/partitioner.h)
        return int(vid) % len(self.workers)

    def run(self, qid: int, ids) -> dict:
        """Route each vid to its owner; merge per-worker results back in
        request order (the stitcher role, stitcher.h:26-120)."""
        if qid not in self._qids:
            raise NotFoundError("unknown qid %r" % qid)
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return {}
        self._enter_flight()
        try:
            return self._run_stitched(qid, ids)
        finally:
            self._exit_flight()

    def _run_stitched(self, qid: int, ids: np.ndarray) -> dict:
        owners = np.array([self._owner(v) for v in ids])
        t0 = time.perf_counter()
        parts: Dict[int, dict] = {}
        for w in np.unique(owners):
            sub = ids[owners == w]
            parts[int(w)] = self.workers[int(w)].run(
                self._qids[qid][int(w)], sub)
        self.limiter.observe_latency((time.perf_counter() - t0) * 1e3)
        # stitch: re-interleave per-worker rows to the original request
        # order. order[r] = (owner, row index within that owner's reply).
        pos_in_part = {int(w): 0 for w in parts}
        order = []
        for w in owners:
            order.append((int(w), pos_in_part[int(w)]))
            pos_in_part[int(w)] += 1

        def stitch(by_worker):
            """Recursive merge: every list is per-request-row (the plan
            is seed-aligned end to end — including nested src_nodes/
            dst_nodes payloads of outE/E aliases); dicts recurse;
            anything else is a per-query constant."""
            sample = next(iter(by_worker.values()))
            if isinstance(sample, dict):
                return {k: stitch({w: t[k] for w, t in by_worker.items()})
                        for k in sample}
            if isinstance(sample, list):
                return [by_worker[w][i] for w, i in order]
            return sample

        first = parts[int(owners[0])]
        return {alias: stitch({w: parts[w][alias] for w in parts})
                for alias in first}

    # -- update plane ------------------------------------------------------
    def update(self, nodes: Optional[dict] = None,
               edges: Optional[dict] = None, wait: bool = True) -> dict:
        """Fan an update out to every worker hosting the touched types.

        Returns {"applied": bool}; with wait=False a throttled update is
        rejected immediately (DGS would leave it in Kafka — here the
        caller's buffer is the durable log, online/update.py UpdateLog).
        """
        while True:
            if self._paused.is_set():
                if not wait:
                    return {"applied": False, "reason": "barrier"}
                while self._paused.is_set():
                    time.sleep(0.005)
            while not self.limiter.admit():
                if not wait:
                    return {"applied": False, "reason": "throttled"}
                time.sleep(0.002)
            self._enter_flight()
            try:
                if self._paused.is_set():
                    # barrier raced in after the pause check: back off and
                    # retry rather than land an update after the barrier's
                    # drain (a checkpoint may be recording offsets)
                    if not wait:
                        return {"applied": False, "reason": "barrier"}
                    continue
                for w in self.workers:
                    w.update(nodes=nodes, edges=edges)
                return {"applied": True}
            finally:
                self._exit_flight()

    def refresh(self):
        for w in self.workers:
            w.refresh()

    def stats(self, qid: int) -> dict:
        per = [w.stats(q) for w, q in zip(self.workers, self._qids[qid])]
        per = [s for s in per if s]
        if not per:
            return {}
        return {
            "p99_ms": max(s["p99_ms"] for s in per),
            "qps": sum(s["qps"] for s in per),
            "workers": len(per),
        }

    # -- coordinator plane -------------------------------------------------
    def barrier(self):
        """Pause updates and drain in-flight queries (DGS barrier.py:36-56).

        Returns a context manager; inside it the fleet is quiescent.
        """
        router = self

        class _Barrier:
            def __enter__(self):
                router._paused.set()
                # drain: in-flight updates/queries finish before the
                # fleet is declared quiescent (so a checkpoint's offsets
                # can't miss an update that was already past the gate)
                with router._quiesce:
                    router._quiesce.wait_for(
                        lambda: router._inflight == 0, timeout=60)
                return self

            def __exit__(self, *a):
                router._paused.clear()

        return _Barrier()

    def checkpoint(self, logs: Sequence) -> dict:
        """Consistent mark across workers: barrier, then record each
        worker's update-log offset (DGS checkpoint.py:44-197 records the
        Kafka ready-offset + RocksDB backup ids)."""
        with self.barrier():
            offsets = []
            for log in logs:
                offsets.append(0 if log is None else log.offset())
        return {"log_offsets": offsets, "time": time.time()}
