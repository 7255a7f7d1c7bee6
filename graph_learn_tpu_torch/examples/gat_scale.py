"""EgoGAT trained at the 62M-edge frontier config, K steps a call.

Counterpart of ``examples/gat_scale.py`` (``main:35-163``).  The bench's
EgoGraphSAGE reduces its deepest hop outside the gradient, so the raw
``[b * k1 * k2, D]`` rows are never written.  Attention cannot do that:
the neighbour weights depend on the attention parameters, so the
deepest-hop rows must reach the model.  This script measures EgoGAT
``[feat_dim, hidden, classes]``, heads [8, 1], dropout 0, Adam 1e-3,
trained on ``bench.CFG_SCALE`` (2 450 000 nodes, 61.25M weighted edges,
100 features, hidden 256, 47 classes, batch 1 024, fanout [15, 10], K = 20
steps a call) on the "minimal" store profile, in three variants:

  pre=0  the hop-2 rows are gathered inside the differentiated step
         (``EgoGraph.from_query_result`` in the loss: Kernel 1)
  pre=1  the hop-2 rows are gathered by ``dispatch.feature_gather``
         (Kernel 1) before the loss, outside the gradient (the JAX
         script's ``:107-115``); the gradients are the same
  pre=2  the whole loss runs under ``torch.utils.checkpoint`` (the JAX
         script's ``jax.checkpoint``, ``:125-128``): the backward runs
         the forward again instead of keeping its activations

``GatSteps`` is a ``bench.MultiStep`` of K such steps: on the card the
first call runs them eagerly on a side stream and captures them in one
``torch.cuda.CUDAGraph``, which later calls replay; on the CPU they run
eagerly.  The bench's own ``MultiStep`` reduces the deepest hop with
``gather_group_agg``, which attention cannot use, so ``GatSteps`` has a
step of its own.  Each step launches (:func:`launches_per_step`)
Kernel 1 for the src, hop-1 and hop-2 rows and Kernel 3 (``gat_block``)
for the three neighbour blocks, forward and backward: 3 + 3 + 3.  Under
pre=2 the recomputation gathers the rows and runs the forwards again:
6 + 6 + 3.  Kernel 3's backward adds across blocks with atomics, so the
losses of two runs agree only to rounding after the first step.

``checkpoint`` runs with ``preserve_rng_state=False``: the model draws no
random numbers (dropout 0, no attention dropout), and saving the CUDA
generator's state is not allowed while a CUDA graph is captured.

``GLT_GAT_CHUNKS`` (a comma list, default 256) sweeps ``EgoGATConv``'s
``seed_chunk``, as in the JAX script.  On the card every chunk value runs
the same kernel: ``EgoGATConv`` hands the whole block to Kernel 3 there
(``nn/layers/ego.py:176-182``), and the chunks apply only to the plain
version on the CPU.  ``GLT_GAT_VARIANTS`` (default ``0,1,2``) picks the
variants.

Usage:  python -m graph_learn_tpu_torch.examples.gat_scale [--small]
            [--hidden H] [--cpu]
``--small`` takes the port bench's ``CFG`` (its ``CFG_SMALL`` sizes under
``GLT_BENCH_SMALL=1``, as the JAX bench's ``CFG``).  Prints one line per
(chunk, variant): chunk=<c> pre=<v>  <eps>M edges/s  <ms> ms/step (warm
<s>s).

Env:
  GLT_FEATURE_DTYPE    float32 | bfloat16 (default bfloat16)
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.examples.scale_demo import loss_of, two_hop_query
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.compile import Query
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT
from graph_learn_tpu_torch.ops.kernels import dispatch
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

HEADS = (8, 1)
VARIANTS = (0, 1, 2)
DEFAULT_CHUNKS = "256"
# the weights' seed; the steps' generator is seeded with SEED + 7
SEED = 0


def scale_cfg(small: bool) -> dict:
    """``CFG_SCALE``; with ``small`` the bench's ``CFG`` (``CFG_SMALL``
    under ``GLT_BENCH_SMALL=1``)."""
    if not small:
        return dict(bench.CFG_SCALE)
    tiny = os.environ.get("GLT_BENCH_SMALL") == "1"
    return dict(bench.CFG_SMALL if tiny else bench.CFG)


def env_chunks() -> List[int]:
    return [int(x) for x in
            os.environ.get("GLT_GAT_CHUNKS", DEFAULT_CHUNKS).split(",")]


def env_variants() -> Tuple[int, ...]:
    raw = os.environ.get("GLT_GAT_VARIANTS")
    return VARIANTS if raw is None else tuple(int(x) for x in raw.split(","))


def launches_per_step(pre: int) -> Dict[str, int]:
    """Kernel launches of one step: ``gather_rows`` (src, hop 1, hop 2),
    ``gat_block`` forwards (two first-layer blocks, one second-layer) and
    backwards; under pre=2 the backward's recomputation gathers and runs
    the forwards again."""
    again = 2 if pre == 2 else 1
    return {"gather_rows": 3 * again, "gat_block": 3 * again,
            "gat_block_bwd": 3}


def make_model(cfg: dict, dec: Decoder, chunk: Optional[int],
               device: DeviceLike = "cuda"):
    """EgoGAT ``[feat_dim, hidden, classes]``, heads [8, 1], dropout 0;
    weights drawn from a generator seeded with ``SEED`` (the same weights
    for every chunk and variant)."""
    return EgoGAT([cfg["feat_dim"], cfg["hidden"], cfg["classes"]], dec,
                  num_heads=list(HEADS), seed_chunk=chunk, dropout=0.0,
                  device=device,
                  generator=torch.Generator().manual_seed(SEED))


def prepare(batch: dict, table: torch.Tensor, pre: int) -> dict:
    """The batch as variant ``pre`` hands it to the loss: under pre=1 the
    hop-2 rows gathered first, outside the gradient."""
    if pre != 1:
        return batch
    hop2 = batch["hop2"]
    with torch.no_grad():
        rows = dispatch.feature_gather(table, hop2.ids)
    return {**batch, "hop2": hop2.replace(float_attrs=rows)}


def gat_loss(model, batch: dict, pre: int) -> torch.Tensor:
    """Variant ``pre``'s loss of a prepared batch."""
    if pre == 2:
        # the model draws nothing (dropout 0): no RNG state to restore,
        # and saving it is not allowed under CUDA graph capture
        return checkpoint(loss_of, model, batch, use_reentrant=False,
                          preserve_rng_state=False)
    return loss_of(model, batch)


def loss_and_grads(model, batch: dict, table: torch.Tensor, pre: int):
    """(loss, gradients of every parameter) of one step of variant ``pre``
    on ``batch``, the parameters left as they are."""
    loss = gat_loss(model, prepare(batch, table, pre), pre)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


class GatSteps(bench.MultiStep):
    """K EgoGAT sample+train steps of variant ``pre`` a call (module
    note): ``bench.MultiStep`` with groups of one step, each step its
    own."""

    def __init__(self, q: Query, tables, model, optimizer, cfg: dict,
                 pre: int, generator: torch.Generator, capture: bool):
        if pre not in VARIANTS:
            raise ValueError("unknown gat_scale variant %r" % (pre,))
        super().__init__(q, tables, model, optimizer, cfg, 1, generator,
                         capture)
        self.pre = pre
        self.table = tables["nodes"]["item"].float_attrs

    def _group(self, first: int):
        with torch.no_grad():
            seeds, batch = bench.sample_one(self.q, self.tables, self.n_nodes,
                                            self.generator)
        self.seeds.append(seeds)
        loss = gat_loss(self.model, prepare(batch, self.table, self.pre),
                        self.pre)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.losses[first].copy_(loss.detach())


def make_steps(q: Query, tables, cfg: dict, dec: Decoder, pre: int,
               chunk: Optional[int], device: DeviceLike = "cuda",
               capture: Optional[bool] = None) -> GatSteps:
    """A fresh model, its Adam and a ``GatSteps`` whose generator is
    seeded with ``SEED + 7``: two calls with the same arguments start from
    the same state.  ``capture`` defaults to True on the card."""
    dev = resolve_device(device)
    if capture is None:
        capture = dev.type == "cuda"
    model = make_model(cfg, dec, chunk, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    return GatSteps(q, tables, model, bench.make_optimizer(model, dev), cfg,
                    pre, gen, capture)


def run(cfg: dict, device: DeviceLike = "cuda",
        chunks: Optional[Sequence[int]] = None,
        variants: Optional[Sequence[int]] = None,
        graph: Optional[Tuple[Graph, Decoder]] = None) -> Dict[str, object]:
    """Build the bench graph (or take ``graph``, a ``bench.build_graph``
    result on the same device), put the plan's tables on the device, then
    time every (chunk, variant) from the same weights and generator seed
    (one warm-up call, captured on the card, then ``bench.time_calls``).
    ``chunks`` and ``variants`` default to the environment's.

    Returns "device", "tables_s", and under "runs" one dict per (chunk,
    variant) with "chunk", "pre" and ``bench.time_calls``'s numbers."""
    dev = resolve_device(device)
    chunks = env_chunks() if chunks is None else list(chunks)
    variants = env_variants() if variants is None else tuple(variants)
    for pre in variants:
        if pre not in VARIANTS:
            raise ValueError("unknown gat_scale variant %r" % (pre,))
    if graph is None:
        graph = bench.build_graph(cfg, dev, SEED)
    g, dec = graph
    k1, k2 = cfg["fanout"]
    edges = cfg["batch"] * (k1 + k1 * k2)
    q = two_hop_query(g, cfg["batch"], cfg["fanout"])
    t0 = time.perf_counter()
    tables = q.device_tables(dev)
    bench._sync(dev)
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "tables_s": time.perf_counter() - t0,
        "runs": []}
    for chunk in chunks:
        for pre in variants:
            step = make_steps(q, tables, cfg, dec, pre, chunk, dev)
            r = bench.time_calls(step, cfg, edges)
            r.update(chunk=chunk, pre=pre)
            out["runs"].append(r)
            del step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = scale_cfg(args.small)
    cfg["hidden"] = args.hidden
    dtype = os.environ.get("GLT_FEATURE_DTYPE", "bfloat16")
    profile = "full" if args.small else "minimal"
    with bench.bench_conf(feature_dtype=dtype, storage_profile=profile):
        r = run(cfg, dev)
    print("[gat] %s: tables on the device %.1fs" % (r["device"],
                                                    r["tables_s"]),
          flush=True)
    for x in r["runs"]:
        print("chunk=%d pre=%d  %.1fM edges/s  %.2f ms/step  (warm %.1fs)"
              % (x["chunk"], x["pre"], x["edges_per_s"] / 1e6, x["step_ms"],
                 x["warm_s"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
