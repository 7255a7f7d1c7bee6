"""The model families at the 61M-edge scale: the rgcn, bipartite, temporal
and walks families.

Counterpart of ``examples/family_scale.py`` for its ``rgcn`` family
(``run_rgcn:57-161``), its ``bipartite`` family (``run_bipartite:164-281``),
its ``temporal`` family (``run_temporal:283-368``) and its ``walks``
family (``run_walks:371-420``), at ``bench.CFG_SCALE``'s sizes.

**rgcn.** ``EgoRGCN([100, 256, 47], num_relations=2, num_bases=1)`` over
2 450 000 "item" nodes with 100 float features and 47 classes, and two
weighted item -> item relations, ``rel0`` and ``rel1``, of 30 625 000
uniformly random edges each (``examples/ego_rgcn.py build_rgcn_graph``:
the same generator, ``np.random.default_rng(0)``, and the same draws in the
same order), on the "minimal" store profile.  ``V("item").batch(1024)``,
the hop tree expanded per relation at each level with fanout [10, 5], all
``random`` (aliases ``r0_h1, r1_h1, r0_r0_h2, r0_r1_h2, r1_r0_h2,
r1_r1_h2``): ``1024 * (2 * 10 + 4 * 10 * 5)`` = 225 280 sampled edges a step;
supervised softmax cross-entropy and Adam at 1e-3.  The port's lookups
leave every hop's rows deferred, where the JAX plan gathers them; so the
family gathers each hop's rows before the model (Kernel 1: 7 launches a
step), as the JAX batch arrives.  Under ``GLT_RGCN_DEFER=1`` the four
deepest hops are instead reduced to their means outside the gradient
(``pre_aggregate_hop``, Kernel 2) and the model takes its deferred route:
3 ``gather_rows`` + 4 ``segment_spmm`` a step.

**bipartite.** Bipartite SAGE u2i link prediction on 1 225 000 users and
1 225 000 items with 100 float features each, 41 037 500 weighted ``u-i``
and 20 212 500 weighted ``i-i`` edges (the same generator,
``np.random.default_rng(1)``, and the same draws in the same order), on the
"full" store profile, which ``outNeg`` needs for its candidate pools.  Edge
seeds on ``u-i``, the ``outV()`` / ``inV()`` endpoints, two ``random``
``outNeg`` negatives, 10 ``random`` neighbours per tower (``u-i`` for users,
``i-i`` for items and negatives), two one-layer EgoSAGEConv(mean) towers of
hidden width 256 with per-hop FeatureEncoders, the in-batch softmax loss
and Adam at 1e-3.  The three ``*_h1`` hops are deferred, so each tower's
mean over its neighbours runs on Kernel 2 straight from the item table;
the src, dst and negative rows are gathered by Kernel 1: 3 + 3 launches a
step.

**temporal.** Temporal EgoGraphSAGE: 2 450 000 "item" nodes with 100
float features and 47 classes, and 61 250 000 weighted, **timestamped**
item -> item ``rel`` edges with timestamps uniform in [0, 1 000 000) (the
same generator, ``np.random.default_rng(2)``, and the same draws in the
same order), on the "full" store profile, whose per-row weight CDFs the
temporal ``edge_weight`` draw reads.  ``E("rel").batch(1024)`` event
seeds, ``outV()`` (the src, at the event's time), then two ``edge_weight``
hops [15, 10] strictly before the propagated time (ops/temporal.py: the
first bounded by the event, the second by the edge that led to it):
``1024 * (15 + 150)`` = 168 960 sampled edges a step;
``EgoGraphSAGE([100, 256, 47], "gcn")``, the supervised softmax
cross-entropy on the src labels and Adam at 1e-3.  The src and hop-1 rows
are gathered (Kernel 1) and the hop-2 rows reduced to their means straight
from the table (Kernel 2): 2 + 1 launches a step.

**walks.** Random-walk generation over the port bench's ``CFG_SCALE``
store (``bench.build_graph``: 2 450 000 "item" nodes, 61 250 000
weighted ``rel`` edges, the same draws as ``bench.py
build_graph_inmem``) on the "minimal" profile: ``b`` seeds drawn
uniformly, one walk of length 20 (8 when small) each, deepwalk (p = q = 1)
and then node2vec (p 0.5, q 2; ``ops/walk.py``, its "neighbour of the
previous node" test a scan of the row, the profile having no id-sorted
copy).  The unit is the transition: ``b * (walk_len - 1)`` a batch, the
unit the reference's random-walk operator produces.  The walks' ids only;
no feature row is read, so no kernel of the port runs here (the GSL's
``random_walk`` hands its feature rows to Kernel 1 as ``DeferredRows``).

One call runs K = ``cfg["scan_steps"]`` steps, each on ``b`` seeds (node
ids for rgcn, ``u-i`` / ``rel`` edge ids for bipartite / temporal) drawn
with ``torch.randint`` on the card; on the card they are captured in one
CUDA graph after a first eager run: ``RGCNSteps``, ``BipartiteSteps`` and
``TemporalSteps`` are ``bench.MultiStep``s, with its side-stream warm-up,
its generator registered with the graph and its fused, capturable Adam,
whose step is the family's own.  ``--small`` takes the port bench's
``CFG_SMALL`` sizes (the JAX script's ``--small`` under
``GLT_BENCH_SMALL=1``) with fanout [4, 2] (rgcn, temporal) or 4
neighbours (bipartite).  ``WalkSteps`` is a ``MultiStep`` of K batches of
walks (no model), each batch's sum of last ids accumulated as the JAX
script does.

Usage:  python -m graph_learn_tpu_torch.examples.family_scale [--small]
            [--families rgcn,bipartite,temporal,walks] [--cpu]
Prints one line per family: <family>  <eps>M edges/s  <ms> ms/step
(warm <s>s); walks prints one line per walk: walks/<label>  <tps>M
transitions/s  <ms> ms/batch (len <walk_len>, b <b>).

Env:
  GLT_FEATURE_DTYPE    float32 | bfloat16 (default bfloat16)
  GLT_RGCN_DEFER=1     rgcn: the deepest level reduced outside the gradient
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder, Mask
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples.bipartite_sage import towers, tower_loss
from graph_learn_tpu_torch.examples.ego_rgcn import (RELS, build_rgcn_graph,
                                                     pre_aggregate_deepest,
                                                     rgcn_loss, rgcn_query)
from graph_learn_tpu_torch.examples.scale_demo import nbytes
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.nn.data import EgoGraph
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE, EgoRGCN
from graph_learn_tpu_torch.ops import walk as walk_ops
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

EDGE_TYPES = ("u-i", "i-i")
TEMPORAL_HOPS = ("h1", "h2")
# event timestamps of the temporal store: uniform in [0, TS_RANGE)
TS_RANGE = 1_000_000


def _device_tables(q: Query, edge_types, dev: torch.device, out: dict):
    """The plan's tables on ``dev``, timed into ``out``: ``tables_s``, the
    host's CSR (and pool) build ``csr_build_s``, the rest of it
    ``upload_s``, and ``tables_bytes``.  Resets the card's peak-memory
    count first."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ets = [q.graph.store.edge_table(t) for t in edge_types]
    for et in ets:
        et.host_build_s = 0.0  # stays 0 where the view is already built
    t0 = time.perf_counter()
    tables = q.device_tables(dev)
    bench._sync(dev)
    out["tables_s"] = time.perf_counter() - t0
    out["csr_build_s"] = sum(et.host_build_s for et in ets)
    out["upload_s"] = out["tables_s"] - out["csr_build_s"]
    out["tables_bytes"] = nbytes(tables)
    return tables


def _time_calls(step: bench.MultiStep, cfg: dict, dev: torch.device,
                out: dict):
    """One warm-up call of ``step`` (``warm_s``), then ``cfg["steps"] //
    K`` calls closed by one pull of the loss, into ``out``: rounds,
    edges/s, the step wall in ms, every step's loss, capture seconds and
    graph-pool bytes (None when eager), and the card's peak bytes."""
    K = step.K
    t0 = time.perf_counter()
    step()
    losses = [step.losses.clone()]
    float(step.losses[-1])
    out["warm_s"] = time.perf_counter() - t0
    rounds = max(cfg["steps"] // K, 1)
    t0 = time.perf_counter()
    for _ in range(rounds):
        step()
        losses.append(step.losses.clone())
    float(step.losses[-1])  # the one pull: a true barrier
    dt = time.perf_counter() - t0
    out.update(rounds=rounds,
               edges_per_s=out["edges_per_step"] * K * rounds / dt,
               step_ms=dt / (K * rounds) * 1e3,
               losses=torch.cat(losses).tolist(),
               capture_s=step.capture_s, graph_pool_bytes=step.pool_bytes)
    if dev.type == "cuda":
        out["device_bytes_peak"] = torch.cuda.max_memory_allocated(dev)


def rgcn_fanout(small: bool) -> Tuple[int, int]:
    """(k1, k2): [10, 5], and [4, 2] when small."""
    return (4, 2) if small else (10, 5)


class RGCNSteps(bench.MultiStep):
    """K rgcn sample+train steps a call (see the module docstring):
    ``bench.MultiStep`` with groups of one step; with ``defer`` the R^K
    deepest hops are reduced to their means under ``no_grad`` first."""

    def __init__(self, q: Query, tables, model: EgoRGCN,
                 optimizer: torch.optim.Optimizer, cfg: dict,
                 aliases, nbrs, defer: bool, generator: torch.Generator,
                 capture: bool):
        super().__init__(q, tables, model, optimizer, cfg, 1, generator,
                         capture)
        self.aliases, self.nbrs, self.defer = list(aliases), tuple(nbrs), defer
        self.n_deep = model.num_relations ** len(nbrs)
        self.table = tables["nodes"]["item"].float_attrs

    def prepare(self, batch: dict) -> dict:
        """The batch as the model takes it on this route."""
        if not self.defer:
            return batch
        with torch.no_grad():
            return pre_aggregate_deepest(batch, self.aliases, self.table,
                                         self.n_deep)

    def _group(self, first: int):
        with torch.no_grad():
            seeds, batch = bench.sample_one(self.q, self.tables, self.n_nodes,
                                            self.generator)
        self.seeds.append(seeds)
        loss = rgcn_loss(self.model, self.prepare(batch), self.aliases,
                         self.nbrs)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.losses[first].copy_(loss.detach())


def run_rgcn(cfg: dict, small: bool = False, device: DeviceLike = "cuda",
             capture: Optional[bool] = None,
             graph: Optional[Tuple[Graph, Decoder]] = None, seed: int = 0,
             defer: Optional[bool] = None) -> Dict[str, object]:
    """Build the store (or take ``graph``, a ``build_rgcn_graph`` result on
    the same device), put the plan's tables on the device, check the first
    batch through a ``Dataset``, build the model, make one warm-up call,
    then time ``cfg["steps"] // K`` calls closed by one pull of the loss.
    ``capture`` defaults to True on the card, ``defer`` to
    ``GLT_RGCN_DEFER``.

    Returns the dict of :func:`run_bipartite` (edges/s of ``b * (R k1 +
    R^2 k1 k2)`` edges a step) with "defer" and "aliases"."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    if defer is None:
        defer = os.environ.get("GLT_RGCN_DEFER") == "1"
    nbrs = rgcn_fanout(small)
    k1, k2 = nbrs
    R = len(RELS)
    b, K = cfg["batch"], cfg["scan_steps"]
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "capture": capture, "K": K, "defer": defer,
        "edges_per_step": b * (R * k1 + R * R * k1 * k2)}
    t0 = time.perf_counter()
    if graph is None:
        graph = build_rgcn_graph(cfg, dev)
    g, dec = graph
    out["host_draw_s"] = time.perf_counter() - t0
    q, aliases = rgcn_query(g, Mask.NONE, b, nbrs)
    tables = _device_tables(q, RELS, dev, out)

    model = EgoRGCN([cfg["feat_dim"], cfg["hidden"], cfg["classes"]], dec,
                    num_relations=R, num_bases=1, device=dev)
    optimizer = bench.make_optimizer(model, dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    step = RGCNSteps(q, tables, model, optimizer, cfg, aliases, nbrs, defer,
                     generator, capture)
    b0 = Dataset(q, window=1, seed=seed, device=dev).next()
    with torch.no_grad():
        loss0 = rgcn_loss(model, step.prepare(b0), aliases, nbrs, False)
    if b0[aliases[-1]].ids.shape != (b, k1, k2) or not bool(
            torch.isfinite(loss0)):
        raise RuntimeError("first batch: %s %s, loss %s"
                           % (aliases[-1], tuple(b0[aliases[-1]].ids.shape),
                              loss0))
    _time_calls(step, cfg, dev, out)
    out.update(graph=graph, query=q, aliases=aliases, tables=tables,
               model=model, optimizer=optimizer, generator=generator,
               step=step)
    return out


def build_graph(cfg: dict, device: DeviceLike = "cuda"
                ) -> Tuple[Graph, Decoder, Decoder]:
    """``run_bipartite:182-204``'s store: "u" and "i" with
    ``cfg["feat_dim"]`` float features, 67% of ``n_nodes * avg_degree``
    weighted edges "u-i", the rest "i-i", uniformly random."""
    rng = np.random.default_rng(1)
    n_u = n_i = cfg["n_nodes"] // 2
    d = cfg["feat_dim"]
    udec = Decoder(attr_types=["float"] * d)
    idec = Decoder(attr_types=["float"] * d)
    g = Graph(device=device)
    for name, dec, n_ in (("u", udec, n_u), ("i", idec, n_i)):
        g.add_node_table(NodeTable(
            name, dec, np.arange(n_, dtype=np.int64),
            float_attrs=rng.standard_normal((n_, d), np.float32)))
    e_ui = int(cfg["n_nodes"] * cfg["avg_degree"] * 0.67)
    e_ii = cfg["n_nodes"] * cfg["avg_degree"] - e_ui
    g.add_edge_table(EdgeTable(
        "u-i", "u", "i", Decoder(weighted=True),
        src=rng.integers(0, n_u, e_ui), dst=rng.integers(0, n_i, e_ui),
        num_src_nodes=n_u, num_dst_nodes=n_i,
        weights=rng.random(e_ui).astype(np.float32)))
    g.add_edge_table(EdgeTable(
        "i-i", "i", "i", Decoder(weighted=True),
        src=rng.integers(0, n_i, e_ii), dst=rng.integers(0, n_i, e_ii),
        num_src_nodes=n_i, num_dst_nodes=n_i,
        weights=rng.random(e_ii).astype(np.float32)))
    return g, udec, idec


def build_query(g: Graph, b: int, k1: int, n_neg: int,
                condition: Optional[dict] = None) -> Query:
    """``run_bipartite:208-216``'s query; with ``condition`` the negatives
    are conditional, ``.where("dst", condition)`` over the random base
    draw (the positive of each row is its ``dst`` item)."""
    seed = g.E("u-i").batch(b).alias("seed")
    src = seed.outV().alias("src")
    dst = seed.inV().alias("dst")
    neg = src.outNeg("u-i").sample(n_neg).by("random")
    if condition is not None:
        neg = neg.where("dst", condition)
    neg = neg.alias("neg")
    src.outV("u-i").sample(k1).by("random").alias("src_h1")
    dst.outV("i-i").sample(k1).by("random").alias("dst_h1")
    neg.outV("i-i").sample(k1).by("random").alias("neg_h1")
    return seed.values()


def fanout(small: bool) -> Tuple[int, int]:
    """(k1, n_neg): 10 neighbours and 2 negatives, 4 and 2 when small."""
    return (4, 2) if small else (10, 2)


class BipartiteSteps(bench.MultiStep):
    """K bipartite sample+train steps a call (see the module docstring):
    ``bench.MultiStep`` with groups of one step whose seeds are ``u-i``
    edge ids and whose loss is the two towers' on the deferred egos."""

    def __init__(self, q: Query, tables, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, cfg: dict,
                 generator: torch.Generator, capture: bool):
        super().__init__(q, tables, model, optimizer, cfg, 1, generator,
                         capture)
        self.n_edges = q.source_space()[0]
        self.table = tables["nodes"]["i"].float_attrs

    def _group(self, first: int):
        with torch.no_grad():
            seeds, batch = bench.sample_one(self.q, self.tables, self.n_edges,
                                            self.generator)
        self.seeds.append(seeds)
        loss = tower_loss(self.model, batch, self.table)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.losses[first].copy_(loss.detach())


def run_bipartite(cfg: dict, small: bool = False, device: DeviceLike = "cuda",
                  capture: Optional[bool] = None,
                  graph: Optional[Tuple[Graph, Decoder, Decoder]] = None,
                  seed: int = 0,
                  condition: Optional[dict] = None) -> Dict[str, object]:
    """Build the store (or take ``graph``, a :func:`build_graph` result on
    the same device), put the plan's tables on the device, check the first
    batch through a ``Dataset``, build the towers, make one warm-up call,
    then time ``cfg["steps"] // K`` calls closed by one pull of the loss.
    ``capture`` defaults to True on the card.  ``condition`` makes the
    negatives conditional (:func:`build_query`); the towers take the
    decoders' widths, so an item decoder with embedding columns widens
    them and its hops are gathered, not reduced (their encoders do not
    commute with the mean).

    Returns edges/s (``b * (2 k1 + n_neg (1 + k1)) * K * rounds / dt``),
    the step wall in ms, the warm-up call's seconds, the host draw, CSR and
    pool build and upload seconds, the tables' bytes, capture seconds and
    graph-pool bytes (None when eager), every step's loss, and under
    "graph", "query", "tables", "model", "optimizer", "generator" and
    "step" what it built."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    k1, n_neg = fanout(small)
    b, K = cfg["batch"], cfg["scan_steps"]
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "capture": capture, "K": K,
        "edges_per_step": b * (2 * k1 + n_neg * (1 + k1))}
    t0 = time.perf_counter()
    if graph is None:
        graph = build_graph(cfg, dev)
    g, udec, idec = graph
    out["host_draw_s"] = time.perf_counter() - t0
    q = build_query(g, b, k1, n_neg, condition)
    tables = _device_tables(q, EDGE_TYPES, dev, out)

    model = towers(udec, idec, cfg["hidden"], dev)
    b0 = Dataset(q, window=1, seed=seed, device=dev).next()
    with torch.no_grad():
        loss0 = tower_loss(model, b0, tables["nodes"]["i"].float_attrs)
    if b0["neg_h1"].ids.shape != (b, n_neg, k1) or not bool(
            torch.isfinite(loss0)):
        raise RuntimeError("first batch: neg_h1 %s, loss %s"
                           % (tuple(b0["neg_h1"].ids.shape), loss0))
    optimizer = bench.make_optimizer(model, dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    step = BipartiteSteps(q, tables, model, optimizer, cfg, generator,
                          capture)
    _time_calls(step, cfg, dev, out)
    out.update(graph=graph, query=q, tables=tables, model=model,
               optimizer=optimizer, generator=generator, step=step)
    return out


def build_temporal_graph(cfg: dict, device: DeviceLike = "cuda"
                         ) -> Tuple[Graph, Decoder]:
    """``run_temporal:299-315``'s store: ``cfg["n_nodes"]`` "item" nodes
    with ``cfg["feat_dim"]`` float features and labels in [0,
    ``cfg["classes"]``), and ``n_nodes * avg_degree`` weighted, timestamped
    ``rel`` edges, uniformly random."""
    rng = np.random.default_rng(2)
    n, d = cfg["n_nodes"], cfg["feat_dim"]
    e = n * cfg["avg_degree"]
    dec = Decoder(labeled=True, attr_types=["float"] * d)
    g = Graph(device=device)
    g.add_node_table(NodeTable(
        "item", dec, np.arange(n, dtype=np.int64),
        float_attrs=rng.standard_normal((n, d), np.float32),
        labels=rng.integers(0, cfg["classes"], n).astype(np.int32)))
    g.add_edge_table(EdgeTable(
        "rel", "item", "item", Decoder(weighted=True, timestamped=True),
        src=rng.integers(0, n, e), dst=rng.integers(0, n, e),
        num_src_nodes=n, num_dst_nodes=n,
        weights=rng.random(e).astype(np.float32),
        timestamps=rng.integers(0, TS_RANGE, e)))
    return g, dec


def temporal_query(g: Graph, b: int, nbrs: Tuple[int, int]) -> Query:
    """``run_temporal:317-322``'s query: event seeds, their src, two
    ``edge_weight`` hops bounded by the propagated time."""
    seed = g.E("rel").batch(b).alias("ev")
    src = seed.outV().alias("src")
    (src.outV("rel").sample(nbrs[0]).by("edge_weight").alias("h1")
     .outV("rel").sample(nbrs[1]).by("edge_weight").alias("h2"))
    return seed.values()


def temporal_fanout(small: bool) -> Tuple[int, int]:
    """(k1, k2): ``cfg["fanout"]`` [15, 10], and [4, 2] when small."""
    return (4, 2) if small else (15, 10)


def temporal_loss(model: torch.nn.Module, batch: dict,
                  table: torch.Tensor) -> torch.Tensor:
    """The supervised loss of a temporal batch: the src and h1 rows
    gathered, h2 reduced to its means from ``table`` (Kernel 2)."""
    logits = model(EgoGraph.from_query_result(batch, "src", TEMPORAL_HOPS,
                                              defer_last_table=table))
    return supervised_softmax_loss(logits, batch["src"].labels)


class TemporalSteps(bench.MultiStep):
    """K temporal sample+train steps a call (see the module docstring):
    ``bench.MultiStep`` with groups of one step whose seeds are ``rel``
    edge ids."""

    def __init__(self, q: Query, tables, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, cfg: dict,
                 generator: torch.Generator, capture: bool):
        super().__init__(q, tables, model, optimizer, cfg, 1, generator,
                         capture)
        self.n_edges = q.source_space()[0]
        self.table = tables["nodes"]["item"].float_attrs

    def _group(self, first: int):
        with torch.no_grad():
            seeds, batch = bench.sample_one(self.q, self.tables, self.n_edges,
                                            self.generator)
        self.seeds.append(seeds)
        loss = temporal_loss(self.model, batch, self.table)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.losses[first].copy_(loss.detach())


def run_temporal(cfg: dict, small: bool = False, device: DeviceLike = "cuda",
                 capture: Optional[bool] = None,
                 graph: Optional[Tuple[Graph, Decoder]] = None,
                 seed: int = 0) -> Dict[str, object]:
    """Build the store (or take ``graph``, a :func:`build_temporal_graph`
    result on the same device), put the plan's tables on the device, check
    the first batch through a ``Dataset``, build the model, make one
    warm-up call, then time ``cfg["steps"] // K`` calls closed by one pull
    of the loss.  ``capture`` defaults to True on the card.

    Returns the dict of :func:`run_bipartite` (edges/s of ``b * (k1 + k1
    k2)`` edges a step)."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    k1, k2 = temporal_fanout(small)
    b, K = cfg["batch"], cfg["scan_steps"]
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "capture": capture, "K": K,
        "edges_per_step": b * (k1 + k1 * k2)}
    t0 = time.perf_counter()
    if graph is None:
        graph = build_temporal_graph(cfg, dev)
    g, dec = graph
    out["host_draw_s"] = time.perf_counter() - t0
    q = temporal_query(g, b, (k1, k2))
    tables = _device_tables(q, ("rel",), dev, out)
    table = tables["nodes"]["item"].float_attrs

    model = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                         dec, agg_type="gcn", device=dev)
    b0 = Dataset(q, window=1, seed=seed, device=dev).next()
    with torch.no_grad():
        loss0 = temporal_loss(model, b0, table)
    if b0["h2"].ids.shape != (b, k1, k2) or not bool(torch.isfinite(loss0)):
        raise RuntimeError("first batch: h2 %s, loss %s"
                           % (tuple(b0["h2"].ids.shape), loss0))
    optimizer = bench.make_optimizer(model, dev)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    step = TemporalSteps(q, tables, model, optimizer, cfg, generator,
                         capture)
    _time_calls(step, cfg, dev, out)
    out.update(graph=graph, query=q, tables=tables, model=model,
               optimizer=optimizer, generator=generator, step=step)
    return out


# (label, p, q) of run_walks:386
WALKS = (("deepwalk", 1.0, 1.0), ("node2vec", 0.5, 2.0))


def walk_len(small: bool) -> int:
    """20, and 8 when small."""
    return 8 if small else 20


class WalkSteps(bench.MultiStep):
    """K batches of walks a call: ``bench.MultiStep`` with no model, each
    batch's ``b`` seeds drawn with ``torch.randint`` on the device, its
    walks kept in ``walks[i]`` [b, walk_len] and the sum of their last ids
    added to ``acc`` (``run_walks:390-398``)."""

    def __init__(self, csr, n_nodes: int, b: int, length: int, p: float,
                 q: float, K: int, generator: torch.Generator,
                 capture: bool):
        super().__init__(None, None, None, None,
                         {"scan_steps": K, "n_nodes": n_nodes}, 1, generator,
                         capture)
        self.csr, self.b, self.walk_len, self.pq = csr, b, length, (p, q)
        dev = generator.device
        self.walks = torch.zeros((K, b, length), dtype=torch.int32,
                                 device=dev)
        self.acc = torch.zeros((), dtype=torch.int64, device=dev)

    def _body(self):
        self.acc.zero_()
        super()._body()

    def _group(self, first: int):
        seeds = torch.randint(0, self.n_nodes, (self.b,),
                              generator=self.generator,
                              device=self.generator.device,
                              dtype=torch.int32)
        self.seeds.append(seeds)
        p, q = self.pq
        w = walk_ops.node2vec_walk(self.csr, seeds, self.walk_len,
                                   self.generator, p=p, q=q)
        self.walks[first].copy_(w)
        self.acc += w[:, -1].sum()


def run_walks(cfg: dict, small: bool = False, device: DeviceLike = "cuda",
              capture: Optional[bool] = None,
              graph: Optional[Tuple[Graph, Decoder]] = None,
              seed: int = 0) -> Dict[str, object]:
    """Build the store (or take ``graph``, a ``bench.build_graph`` result on
    the same device, whose ``rel`` view is built under the "minimal"
    profile), then for each walk of ``WALKS`` one warm-up call of
    :class:`WalkSteps` and ``cfg["steps"] // K`` timed calls closed by one
    read of ``acc``.  ``capture`` defaults to True on the card.

    Returns the host draw and table seconds and bytes, and under each
    label: rounds, transitions/s (``b * (walk_len - 1) * K * rounds /
    dt``), ms a batch, the warm-up call's seconds, capture seconds and
    graph-pool bytes (None when eager) and the ``step``."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    b, K, length = cfg["batch"], cfg["scan_steps"], walk_len(small)
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "capture": capture, "K": K,
        "walk_len": length, "transitions_per_batch": b * (length - 1)}
    t0 = time.perf_counter()
    if graph is None:
        graph = bench.build_graph(cfg, dev)
    g, _ = graph
    out["host_draw_s"] = time.perf_counter() - t0
    host = g.store.edge_table("rel")
    t0 = time.perf_counter()
    csr = host.device(dev).out
    bench._sync(dev)
    out["tables_s"] = time.perf_counter() - t0
    out["tables_bytes"] = nbytes(csr)
    n, rounds = cfg["n_nodes"], max(cfg["steps"] // K, 1)
    for i, (label, p, q) in enumerate(WALKS):
        generator = torch.Generator(device=dev).manual_seed(seed + 1 + i)
        step = WalkSteps(csr, n, b, length, p, q, K, generator, capture)
        t0 = time.perf_counter()
        step()
        int(step.acc)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        int(step.acc)  # the one read: a true barrier
        dt = time.perf_counter() - t0
        out[label] = dict(
            p=p, q=q, rounds=rounds, warm_s=warm, step=step,
            transitions_per_s=out["transitions_per_batch"] * K * rounds / dt,
            batch_ms=dt / (K * rounds) * 1e3, capture_s=step.capture_s,
            graph_pool_bytes=step.pool_bytes)
    out["graph"] = graph
    return out


RUNNERS = {"rgcn": run_rgcn, "bipartite": run_bipartite,
           "temporal": run_temporal, "walks": run_walks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--families", default="rgcn,bipartite,temporal")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    families = args.families.split(",")
    for fam in families:
        if fam not in RUNNERS:
            raise InvalidArgumentError("unknown family %r" % fam)
    cfg = bench.CFG_SMALL if args.small else bench.CFG_SCALE
    dtype = os.environ.get("GLT_FEATURE_DTYPE", "bfloat16")
    for fam in families:
        # rgcn and walks sample only forward adjacencies: the minimal
        # profile, as the JAX script runs them; bipartite's outNeg needs
        # the full one's pools, temporal edge_weight its CDFs
        profile = "minimal" if fam in ("rgcn", "walks") else "full"
        with bench.bench_conf(feature_dtype=dtype, storage_profile=profile):
            r = RUNNERS[fam](cfg, args.small, dev)
        if fam == "walks":
            for label, _, _ in WALKS:
                print("walks/%-9s %.1fM transitions/s  %.2f ms/batch "
                      "(len %d, b %d)" % (label, r[label][
                          "transitions_per_s"] / 1e6, r[label]["batch_ms"],
                          r["walk_len"], cfg["batch"]), flush=True)
            continue
        print("%-10s %.1fM edges/s  %.2f ms/step  (warm %.1fs)"
              % (fam, r["edges_per_s"] / 1e6, r["step_ms"], r["warm_s"]),
              flush=True)
    return 0


if __name__ == "__main__":
    main()
