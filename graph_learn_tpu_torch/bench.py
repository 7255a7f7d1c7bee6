"""Benchmark of the port: fused EgoSAGE sample+train throughput in edges/s.

Counterpart of the repository's ``bench.py``: ``CFG`` and ``CFG_SCALE``
(``bench.py:42-80``, copied with the ``GLT_BENCH_SMALL`` sizes),
``make_multi_step`` (``:119-203``), ``run_bench`` (``:236-296``) and
``main`` (``:331-385``), with its JSON lines: the headline record
``{"metric": "ego_sage_train_edges_per_s", "value", "unit",
"vs_baseline"}`` prints as soon as ``CFG`` is measured, then the same
record again with ``ego_sage_scale62m_edges_per_s`` added after
``CFG_SCALE`` (2.45M nodes, 61.25M weighted edges, the "minimal" store
profile) has run.

One call of the multi-step function runs K = ``cfg["scan_steps"]`` steps
in ``K // G`` groups: G seed batches drawn with ``torch.randint`` on the
device from the plan's ``torch.Generator``, the GSL plan for each, then G
steps of forward, softmax cross-entropy, backward and Adam
(``optax.adam(1e-3)``'s constants).  The hops are the query's aliases,
any number of them.  Where the model's deepest conv reduces its
neighbours by an op its encoder commutes with (``EgoGNN.deep_agg_op``:
EgoGraphSAGE's mean), the deepest hop of all G is reduced to its group
means outside the gradient (``gather_group_agg``: Kernel 2, or Kernel 4
under ``conf.sorted_gather``) and Kernel 1 gathers the rows of the seeds
and of the other hops in the forward; otherwise (attention: EgoGAT) the
deepest hop reaches the model as the plan's ``DeferredRows``, which the
forward gathers with Kernel 1 too.  The JAX bench compiles the K steps
into one XLA executable; here, on the card, the first call runs them
eagerly on a side stream (Adam's state, cuBLAS and every kernel route's
first-call queries) and then captures them once into one
``torch.cuda.CUDAGraph``, which every later call replays.  The generator
is registered with the graph, so each replay draws new seeds and
neighbours.  On the CPU the same steps run eagerly.
While tracing is on (``utils/profiling.py``) a call is a ``step.capture``,
``step.replay`` or ``step.eager`` span, a step's backward and Adam update
are ``model.backward`` and ``model.optimizer`` spans, and the capture
counts the graph's nodes by kind (``step.graph_nodes``, ...).

``vs_baseline`` is null on every line: the JAX bench divides by its own
CPU run or by a TPU record (``bench.py:81`` ``SCALE_BASELINE_EPS``), and
the port measures neither (its CPU run of the same pipeline measured the
host, not the card).  Left out: ``scale62m_vs_r02_record``.

Usage:  python -m graph_learn_tpu_torch.bench

Env:
  GLT_BENCH_SMALL=1    the small sizes (20 000 nodes, batch 256)
  GLT_BENCH_SCALE=1    only ``CFG_SCALE``: one ego_sage_scale62m line
  GLT_BENCH_NO_SCALE=1 only the headline line
  GLT_BENCH_GROUP=G    seed batches sampled per group (default 1; the
                       largest divisor of K that is <= G)
  GLT_FEATURE_DTYPE    float32 | bfloat16 (default bfloat16)
  GLT_PLATFORM=cpu     run on the CPU; otherwise on the card, or raise
                       DeviceUnavailableError
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples.scale_demo import nbytes, two_hop_query
from graph_learn_tpu_torch.graph import Graph, synthetic_graph
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.nn.data import (DeferredRows, EgoGraph,
                                           PreAggregatedRows)
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGNN, EgoGraphSAGE
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
from graph_learn_tpu_torch.utils import profiling
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

CFG = dict(
    n_nodes=200_000,
    avg_degree=16,
    feat_dim=128,
    hidden=256,
    batch=1024,
    fanout=(15, 10),
    classes=32,
    steps=120,
    warmup=2,
    scan_steps=30,
    prefetch_group=1,
)
# GLT_BENCH_SMALL=1
CFG_SMALL = dict(CFG, n_nodes=20_000, avg_degree=8, feat_dim=64, hidden=64,
                 batch=256, steps=20, scan_steps=10)
# the 62M-edge frontier (ogbn-products size), run on the "minimal" store
CFG_SCALE = dict(
    n_nodes=2_450_000,
    avg_degree=25,  # 61.25M directed, weighted edges
    feat_dim=100,
    hidden=256,
    batch=1024,
    fanout=(15, 10),
    classes=47,
    steps=60,
    warmup=1,
    scan_steps=20,
    prefetch_group=1,
)
HOPS = ("hop1", "hop2")
LEARNING_RATE = 1e-3


def _log(msg: str):
    print("[bench] " + msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def bench_conf(**fields):
    """Set ``conf`` fields for a run and restore them after it."""
    old = {k: getattr(conf, k) for k in fields}
    try:
        for k, v in fields.items():
            setattr(conf, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(conf, k, v)


def build_graph(cfg: dict, device: DeviceLike = "cuda",
                seed: int = 0) -> Tuple[Graph, Decoder]:
    """``bench.py build_graph_inmem``: the same numbers in the same order
    (``graph.synthetic_graph``)."""
    return synthetic_graph(cfg["n_nodes"], cfg["avg_degree"],
                           cfg["feat_dim"], cfg["classes"], seed=seed,
                           device=device)


def sample_one(q: Query, tables, n_nodes: int,
               generator: torch.Generator) -> Tuple[torch.Tensor, dict]:
    """One batch: ``q``'s batch size of seeds drawn uniformly from
    [0, n_nodes) on the generator's device, then the plan on them."""
    with profiling.span("plan.seeds"):
        seeds = torch.randint(0, n_nodes, (q.dag.batch_size,),
                              generator=generator, device=generator.device,
                              dtype=torch.int32)
    return seeds, _execute(q, tables, seeds, generator)


def make_optimizer(model: torch.nn.Module, device: torch.device,
                   lr: float = LEARNING_RATE) -> torch.optim.Optimizer:
    """``optax.adam(lr)``'s update (betas 0.9 / 0.999, eps 1e-8; the
    bench's rate 1e-3 unless given); on the card the fused kernel, which a
    CUDA graph can capture."""
    extra = ({"fused": True, "capturable": True} if device.type == "cuda"
             else {})
    return torch.optim.Adam(model.parameters(), lr=lr, **extra)


def group_size(cfg: dict) -> int:
    """``GLT_BENCH_GROUP`` (default ``cfg["prefetch_group"]``), cut to the
    largest divisor of K that is not above it."""
    K = cfg.get("scan_steps", 10)
    G = int(os.environ.get("GLT_BENCH_GROUP", cfg.get("prefetch_group", 1)))
    G = max(1, min(G, K))
    while K % G:
        G -= 1
    return G


def query_hops(q: Optional[Query]) -> Tuple[Optional[str], Tuple[str, ...]]:
    """The alias of ``q``'s source and those of its hops, in plan order
    (None and none without a query or aliases: a subclass's own step)."""
    aliases = [n.alias_name for n in q.dag.nodes if n.alias_name] if q else []
    return (aliases[0] if aliases else None), tuple(aliases[1:])


class MultiStep:
    """K fused sample+train steps a call (see the module docstring).

    ``losses`` [K] holds the loss of every step of the last call, on the
    device; a call returns ``losses[-1]``.  ``seeds`` are the seed batches
    of the last eager run; under a graph ``graph_seeds`` are the graph's
    own seed buffers, which each replay overwrites.  ``capture_s`` and
    ``pool_bytes`` are the seconds and the device memory the capture took.
    ``calls`` counts the calls (the tracer's call number).  ``src`` and
    ``hops`` are the query's aliases (:func:`query_hops`); ``deep_op`` is
    the reduction the deepest hop is pre-aggregated with, or None.

    A subclass may watch the steps: ``span(name)`` is a context around the
    group's plan ("plan"), its pre-aggregation ("aggregate") and each
    step ("model"), and ``keep(i, seeds, batch, logits, agg)`` is called
    after step i's update (``agg``: its deepest hop's means, or None).
    """

    def __init__(self, q: Query, tables, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, cfg: dict, G: int,
                 generator: torch.Generator, capture: bool):
        self.K = cfg.get("scan_steps", 10)
        if G < 1 or self.K % G:
            raise InvalidArgumentError(
                "group size %r does not divide K = %d" % (G, self.K))
        if capture and generator.device.type != "cuda":
            raise InvalidArgumentError("a CUDA graph needs a CUDA generator")
        self.q, self.tables, self.model = q, tables, model
        self.optimizer, self.generator = optimizer, generator
        self.G, self.n_nodes = G, cfg["n_nodes"]
        self.src, self.hops = query_hops(q)
        self.deep_op = (model.deep_agg_op(len(self.hops))
                        if isinstance(model, EgoGNN) and self.hops else None)
        self.capture = capture
        self.losses = torch.zeros(self.K, device=generator.device)
        self.seeds: List[torch.Tensor] = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_seeds: List[torch.Tensor] = []
        self.capture_s: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.calls = 0

    def span(self, name: str):
        return contextlib.nullcontext()

    def keep(self, i: int, seeds: torch.Tensor, batch: dict,
             logits: torch.Tensor, agg: Optional[torch.Tensor]):
        pass

    def _group(self, first: int):
        deepest = self.hops[-1]
        with self.span("plan"), torch.no_grad():
            batches = [sample_one(self.q, self.tables, self.n_nodes,
                                  self.generator) for _ in range(self.G)]
        aggs: List[Optional[torch.Tensor]] = [None] * self.G
        if self.deep_op is not None:
            with self.span("aggregate"), torch.no_grad():
                table = batches[0][1][deepest].float_attrs.table
                ids = [b[deepest].ids for _, b in batches]
                # [G, b, k1, ..., kN] ids -> [G * b * k1 ... kN-1, D]
                # means: one launch for the group, and the raw deepest-hop
                # rows are never written
                ids = ids[0][None] if self.G == 1 else torch.stack(ids)
                aggs = gather_group_agg(table, ids, self.deep_op).reshape(
                    self.G, -1, table.shape[-1])
        for j, (seeds, batch) in enumerate(batches):
            self.seeds.append(seeds)
            with self.span("model"):
                logits = self._step(first + j, batch, aggs[j])
            self.keep(first + j, seeds, batch, logits, aggs[j])

    def _step(self, i: int, batch: dict,
              agg: Optional[torch.Tensor]) -> torch.Tensor:
        """Step ``i`` on ``batch``: forward, loss, backward, Adam; returns
        the logits.  The deepest hop carries ``agg``, or stays the plan's
        ``DeferredRows``."""
        deepest = self.hops[-1]
        table = None
        if agg is not None:
            batch = {**batch, deepest: batch[deepest].replace(
                float_attrs=PreAggregatedRows(agg, self.deep_op))}
        elif isinstance(batch[deepest].float_attrs, DeferredRows):
            table = batch[deepest].float_attrs.table
        ego = EgoGraph.from_query_result(batch, self.src, self.hops,
                                         defer_last_table=table)
        logits = self.model(ego, training=True)
        loss = supervised_softmax_loss(logits, batch[self.src].labels)
        self.optimizer.zero_grad(set_to_none=True)
        with profiling.span("model.backward"):
            loss.backward()
        with profiling.span("model.optimizer"):
            self.optimizer.step()
        self.losses[i].copy_(loss.detach())
        return logits

    def _body(self):
        self.seeds = []
        for first in range(0, self.K, self.G):
            self._group(first)

    def run_eager(self) -> torch.Tensor:
        """The K steps without the graph (the first call's form)."""
        self._body()
        return self.losses[-1]

    def _capture(self):
        dev = self.generator.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()  # this call's K steps, and the warm-up
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        # while tracing, the graph is kept to count its nodes, then
        # instantiated where capture_end would have
        counted = profiling.enabled()
        graph = torch.cuda.CUDAGraph(keep_graph=counted)
        graph.register_generator_state(self.generator)
        eager_seeds = self.seeds
        with torch.cuda.graph(graph):
            self._body()
        if counted:
            nodes = profiling.graph_nodes(graph)
            profiling.count("step.graph_nodes", sum(nodes.values()))
            for kind in ("kernel", "memcpy", "memset"):
                profiling.count("step.graph_%ss" % kind, nodes.get(kind, 0))
            graph.instantiate()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph_seeds, self.seeds = self.seeds, eager_seeds
        self.graph = graph

    def __call__(self) -> torch.Tensor:
        self.calls += 1
        if self.graph is not None:
            with profiling.span("step.replay", call=self.calls):
                self.graph.replay()
        elif self.capture:
            with profiling.span("step.capture", call=self.calls):
                self._capture()
        else:
            with profiling.span("step.eager", call=self.calls):
                self._body()
        return self.losses[-1]


def make_multi_step(q: Query, tables, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, cfg: dict, G: int,
                    generator: torch.Generator,
                    capture: Optional[bool] = None) -> MultiStep:
    """The K-step function of ``bench.py make_multi_step``; ``capture``
    (default: on a CUDA generator) puts the steps in one CUDA graph."""
    if capture is None:
        capture = generator.device.type == "cuda"
    return MultiStep(q, tables, model, optimizer, cfg, G, generator, capture)


def time_calls(step: MultiStep, cfg: dict, edges_per_step: int,
               warmup: int = 1) -> Dict[str, object]:
    """``warmup`` calls of ``step`` (``warm_s``), then ``cfg["steps"] //
    K`` calls closed by one pull of the loss: rounds, edges/s, the step
    wall in ms, every step's loss, capture seconds and graph-pool bytes
    (None when eager), and on the card its peak allocated bytes."""
    dev = step.losses.device
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        step()
        losses.append(step.losses.clone())
    float(step.losses[-1])  # drain before timing
    warm_s = time.perf_counter() - t0
    rounds = max(cfg["steps"] // step.K, 1)
    t0 = time.perf_counter()
    for _ in range(rounds):
        step()
        losses.append(step.losses.clone())
    float(step.losses[-1])  # the one pull: a true barrier
    dt = time.perf_counter() - t0
    out = {"warm_s": warm_s, "rounds": rounds,
           "edges_per_s": edges_per_step * step.K * rounds / dt,
           "step_ms": dt / (step.K * rounds) * 1e3,
           "losses": torch.cat(losses).tolist(),
           "capture_s": step.capture_s, "graph_pool_bytes": step.pool_bytes}
    if dev.type == "cuda":
        out["device_bytes_peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def run_bench(cfg: dict, device: DeviceLike = "cuda",
              capture: Optional[bool] = None,
              graph: Optional[Tuple[Graph, Decoder]] = None,
              seed: int = 0) -> Dict[str, object]:
    """Build the graph (or take ``graph``, a :func:`build_graph` result on
    the same device), put the plan's tables on the device, take the first
    batch through a ``Dataset``, build the model, then time its K-step
    function with :func:`time_calls` after ``cfg["warmup"]`` calls.
    ``capture`` defaults to True on the card.

    Returns :func:`time_calls`'s numbers (edges/s is ``b * (k1 + k1 * k2)
    * K * rounds / dt``), K and G, host build and table seconds, table
    bytes, and under "graph", "query", "tables", "model", "optimizer",
    "generator" and "step" what it built."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    k1, k2 = cfg["fanout"]
    b = cfg["batch"]
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "capture": capture}
    t0 = time.perf_counter()
    if graph is None:
        graph = build_graph(cfg, dev, seed)
    g, dec = graph
    out["host_build_s"] = time.perf_counter() - t0
    _log("graph built (host) %.1fs" % out["host_build_s"])
    q = two_hop_query(g, b, (k1, k2))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tables = q.device_tables(dev)
    _sync(dev)
    out["tables_s"] = time.perf_counter() - t0
    out["tables_bytes"] = nbytes(tables)
    _log("tables on device %.1fs" % out["tables_s"])

    b0 = Dataset(q, window=1, seed=seed, device=dev).next()
    model = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                         dec, agg_type="gcn", device=dev)
    with torch.no_grad():
        logits0 = model(EgoGraph.from_query_result(
            b0, "src", HOPS,
            defer_last_table=tables["nodes"]["item"].float_attrs))
    if tuple(logits0.shape) != (b, cfg["classes"]):
        raise RuntimeError("first batch: logits %s" % (tuple(logits0.shape),))
    optimizer = make_optimizer(model, dev)
    K, G = cfg.get("scan_steps", 10), group_size(cfg)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    step = make_multi_step(q, tables, model, optimizer, cfg, G, generator,
                           capture)

    out.update(time_calls(step, cfg, b * (k1 + k1 * k2), cfg["warmup"]),
               K=K, G=G)
    _log("warm-up (%s) %.1fs" % ("eager run, then capture" if capture
                                 else "eager", out["warm_s"]))
    out.update(graph=graph, query=q, tables=tables, model=model,
               optimizer=optimizer, generator=generator, step=step)
    return out


def _record(eps: float) -> dict:
    return {"metric": "ego_sage_train_edges_per_s", "value": round(eps, 1),
            "unit": "edges/s/chip", "vs_baseline": None}


def main() -> int:
    device = "cpu" if os.environ.get("GLT_PLATFORM") == "cpu" else "cuda"
    resolve_device(device)  # no card: DeviceUnavailableError
    small = os.environ.get("GLT_BENCH_SMALL") == "1"
    dtype = os.environ.get("GLT_FEATURE_DTYPE", "bfloat16")
    if os.environ.get("GLT_BENCH_SCALE") == "1":
        with bench_conf(feature_dtype=dtype, storage_profile="minimal"):
            eps = run_bench(CFG_SCALE, device)["edges_per_s"]
        print(json.dumps({"metric": "ego_sage_scale62m_edges_per_s",
                          "value": round(eps, 1), "unit": "edges/s/chip",
                          "vs_baseline": None}), flush=True)
        return 0
    cfg = CFG_SMALL if small else CFG
    with bench_conf(feature_dtype=dtype):
        eps = run_bench(cfg, device)["edges_per_s"]
    rec = _record(eps)
    # the headline line first: a reader cut off during the scale phase
    # already has a complete record
    print(json.dumps(rec), flush=True)
    if not small and os.environ.get("GLT_BENCH_NO_SCALE") != "1":
        gc.collect()  # the first graph's tables (Graph, Dag, Query cycle)
        if device == "cuda":
            torch.cuda.empty_cache()
        with bench_conf(feature_dtype=dtype, storage_profile="minimal"):
            seps = run_bench(CFG_SCALE, device)["edges_per_s"]
        rec["ego_sage_scale62m_edges_per_s"] = round(seps, 1)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
