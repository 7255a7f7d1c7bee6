"""The port's tracer: spans and counters inside the program, on the
profiler's clock.

Off (the default) a :func:`span` costs one module-level test and returns
one shared ``nullcontext``, and :func:`count` returns at once: nothing is
recorded, allocated or handed to the profiler.  :func:`enable` turns it on
for the process (a benchmark's traced run, an operator); nothing else does.

On, a span records ``(name, parent, start_ns, end_ns, thread, call)`` on
``time.perf_counter_ns`` into a ring of the last :data:`RING` records
(``parent``: the span open below it on the same thread; ``call``: the
``bench.MultiStep`` call it ran in, or None), adds to its name's calls,
total and self seconds (self: the total less the time its child spans
cover), and opens ``torch.profiler.record_function("glt." + name)``, so
that under any profiler session it is a range of the same Chrome trace as
the device's kernels, copies and memsets.  (The ``glt::`` ranges of the
kernels' ``torch.library`` operators are the profiler's own, always
there.)  Counters add under the same lock, so serving and producer
threads may record too.  :func:`snapshot` returns all of it with the
kernel wrappers' ``LaunchCounter`` counts (always on), :func:`dump`
prints the aggregates, :func:`device_trace` records a Chrome trace of a
scope, and :func:`graph_nodes` counts a captured CUDA graph's nodes.

The names, by layer (``glt.`` before each in a trace):

* store: ``store.ingest_nodes`` / ``store.ingest_edges`` (the host
  tables' constructors), ``store.device_tables`` (``Query.device_tables``)
  holding, per edge table and direction, ``store.csr`` with its children
  ``store.csr.sort`` (the adjacency order; a process's first also takes the
  first ``torch.library`` operator call's import of ``torch._dynamo``,
  seconds), and on a store that is not
  ``"minimal"`` ``store.csr.sort_ids`` (the id-sorted copy) and
  ``store.csr.cdf`` (which copies its CDFs too), and ``store.pools``;
  ``store.upload`` (the copies of a table's arrays to its device, closed
  after the copies have landed) and the counter ``store.upload_bytes``;
  the counters ``store.csr.device_builds`` (CSR directions built on a
  card) and ``store.csr.long_rows`` (rows the card's order sorted past its
  warp tier, each sort counting its own);
* plan: ``plan.seeds`` (``bench.sample_one``'s draw), ``plan``
  (``_execute``) holding ``plan.<alias>.sample`` (the strategy's draw)
  and ``plan.<alias>.lookup`` (the node, edge and degree lookups) of each
  source and hop (``n<nid>`` for a node without an alias); the counter
  ``plan.sampled_ids``;
* ``aggregate`` (``gather_group_agg``);
* model: ``model.forward`` (``EgoGNN``), ``model.loss``
  (``supervised_softmax_loss``), ``model.backward`` and
  ``model.optimizer`` (``bench.MultiStep``);
* step loop: ``step.capture``, ``step.replay`` and ``step.eager`` around
  a ``bench.MultiStep`` call, and at the capture the counters
  ``step.graph_nodes``, ``step.graph_kernels``, ``step.graph_memcpys``
  and ``step.graph_memsets``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

import torch

RING = 65536
# CUgraphNodeType
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_ring: collections.deque = collections.deque(maxlen=RING)
_spans: Dict[str, list] = {}     # name -> [calls, total ns, self ns]
_counters: Dict[str, int] = {}
_call: Optional[int] = None


def enable():
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable():
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Forget every record, aggregate and counter."""
    with _lock:
        _ring.clear()
        _spans.clear()
        _counters.clear()


class _Span:
    __slots__ = ("name", "call", "parent", "start", "child_ns", "range",
                 "outer_call")

    def __init__(self, name: str, call: Optional[int]):
        self.name, self.call = name, call

    def __enter__(self):
        global _call
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.outer_call = _call
        if self.call is not None:
            _call = self.call
        self.range = torch.profiler.record_function("glt." + self.name)
        self.range.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _call
        end = time.perf_counter_ns()
        _local.stack.pop()
        self.range.__exit__(*exc)
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        with _lock:
            _ring.append((self.name, parent.name if parent else None,
                          self.start, end, threading.get_ident(), _call))
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
        if self.call is not None:
            _call = self.outer_call
        return False


def span(name: str, call: Optional[int] = None):
    """A span named ``name`` (and the range ``glt.<name>``) around a
    ``with`` block while tracing is on; ``call`` marks the block and the
    spans inside it as that ``bench.MultiStep`` call's."""
    if not _on:
        return _NULL
    return _Span(name, call)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """The spans' aggregates ({name: {"calls", "total_s", "self_s"}}), the
    ring's records (oldest first; dicts of the record's fields), the
    counters and the kernel wrappers' launch counts by wrapper."""
    from graph_learn_tpu_torch.ops.kernels.build import launch_counts
    fields = ("name", "parent", "start_ns", "end_ns", "thread", "call")
    with _lock:
        spans = {k: {"calls": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                 for k, (c, t, s) in _spans.items()}
        records = [dict(zip(fields, r)) for r in _ring]
        counters = dict(_counters)
    return {"spans": spans, "records": records, "counters": counters,
            "launches": launch_counts()}


def dump():
    """Print each span's total and self seconds, calls and mean ms, and
    each counter."""
    snap = snapshot()
    for key, a in sorted(snap["spans"].items()):
        print("[profiling] %s: total %.3fs, self %.3fs, count %d, avg %.3fms"
              % (key, a["total_s"], a["self_s"], a["calls"],
                 1000.0 * a["total_s"] / max(a["calls"], 1)))
    for key, n in sorted(snap["counters"].items()):
        print("[profiling] %s: %d" % (key, n))


@contextlib.contextmanager
def device_trace(logdir: str = ""):
    """Record a ``torch.profiler`` trace of the scope (the CPU, and the
    card when there is one) into ``logdir/trace.json`` (default: a
    ``glt_trace`` folder in the temporary directory), with the ``glt.``
    ranges of the spans recorded meanwhile; yields the profiler, whose
    ``key_averages()`` the caller may read."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "glt_trace")
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def graph_nodes(cuda_graph, name: Optional[Callable] = None
                ) -> Dict[str, int]:
    """{kind: count} of the nodes of a ``torch.cuda.CUDAGraph`` captured
    with ``keep_graph=True`` and not yet reset (``cuGraphGetNodes`` and
    ``cuGraphNodeGetType`` of ``libcuda.so.1``; kinds as
    :data:`NODE_KINDS` names them).  ``name(lib, node, kind)`` keys a node
    otherwise (``kind`` the ``CUgraphNodeType`` number)."""
    lib = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError("%s: CUresult %d" % (what, rc))

    graph = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    out: Dict[str, int] = {}
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        key = (name(lib, node, kind.value) if name is not None
               else NODE_KINDS.get(kind.value, "type %d" % kind.value))
        out[key] = out.get(key, 0) + 1
    return out
