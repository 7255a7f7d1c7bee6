"""Bytes over the graph axis per step: the psum stitch against owner
routing.

Counterpart of the repository's ``examples/routing_bytes.py``.  The JAX
script compiles the partitioned plan on 8 virtual CPU devices and counts
the collectives' payloads in the StableHLO.  Here ``--ranks`` ranks run
the same plan (a 1-hop EgoSAGE-style query: batch 256, fan-out 8,
``edge_weight``, over 4 096 nodes of 128 f32 features and 8 weighted
edges each, all drawn from seed 0 as the JAX script draws them) on
``--device`` and read the counter of ``core/sharding.py``
(``COLLECTIVES``): the payload bytes per rank of every collective the
step ran over the graph group, by op.  The lines are the JAX script's.

Where the numbers differ from the JAX script's at the same P:

- the port counts the collectives a step ran, the JAX script those the
  program holds: owner routing's exact fallback (a psum inside a
  ``lax.cond``) is in the JAX count whether or not it runs, and in the
  port's only when a bucket overflows (the seeds are rows 0-255, all on
  shard 0, so the src rows' buckets overflow from P = 4 on: one dense
  psum of a stripe's rows; the hop's rows, spread over the shards, do
  not);
- the owner-routed rows come back striped over the graph axis and the
  port all-gathers the stripes (``all_gather``) so that every graph rank
  holds its batch, where the JAX plan leaves them striped to the step;
- both send the buckets at their padded capacity, ``max(ceil(m * 2 / P)
  + 8, 8)`` ids a (sender, owner) pair, whatever the draw filled, so
  their ``all_to_all`` payloads are equal;
- the port's raw ids are int64 (the JAX device views hold int32 with x64
  off), and the eager plan stitches the hop's edge ids, which no output
  reads and XLA drops from its program: two more ``all_reduce`` payloads
  in both routings (``tests/test_torch_parallel.py::
  test_routing_bytes_against_the_jax_count`` holds every one of these
  differences at P = 2).

    python -m graph_learn_tpu_torch.examples.routing_bytes --ranks 2 --device cpu
    python -m graph_learn_tpu_torch.examples.routing_bytes --ranks 2 --device cuda --backend gloo

Ranks that share a card need ``--backend gloo`` (NCCL refuses two ranks
on one device); without it the launch raises before any rank starts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

N_NODES, DEGREE, WIDTH = 4096, 8, 128
BATCH, FANOUT = 256, 8


def build_graph(device):
    """The JAX script's store: the same draws in the same order."""
    import graph_learn_tpu_torch as glt

    rng = np.random.default_rng(0)
    n, deg, d = N_NODES, DEGREE, WIDTH
    g = glt.Graph(device=device)
    nd = glt.Decoder(labeled=True, attr_types=["float"] * d)
    ed = glt.Decoder(weighted=True)
    g.add_node_table(glt.NodeTable(
        "v", nd, np.arange(n, dtype=np.int64),
        float_attrs=rng.standard_normal((n, d)).astype(np.float32),
        labels=rng.integers(0, 4, n).astype(np.int32)))
    src = rng.integers(0, n, n * deg)
    dst = rng.integers(0, n, n * deg)
    g.add_edge_table(glt.EdgeTable(
        "e", "v", "v", ed, src=src, dst=dst, num_src_nodes=n,
        num_dst_nodes=n, weights=rng.random(n * deg).astype(np.float32)))
    return g


def rank_bytes(rank: int, world: int, steps: int = 2) -> Dict[str, dict]:
    """On every rank of a (1, world) mesh: {routing: {op: [calls, bytes]}}
    of one step of the partitioned plan (the mean of ``steps`` steps
    after one warm step), with the step's wall on this rank's clock."""
    import time

    from graph_learn_tpu_torch.core.sharding import COLLECTIVES, GRAPH_AXIS
    from graph_learn_tpu_torch.parallel import bootstrap
    from graph_learn_tpu_torch.parallel.mesh import make_mesh
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)
    from graph_learn_tpu_torch.parallel.train import make_partitioned_plan

    from graph_learn_tpu_torch.config import conf

    dev = bootstrap.current_device()
    g = build_graph(dev)
    q = (g.V("v").batch(BATCH).alias("src")
         .outV("e").sample(FANOUT).by("edge_weight").alias("h1").values())
    mesh = make_mesh(1, world)
    old, conf.feature_dtype = conf.feature_dtype, "float32"  # the JAX f32
    try:
        st = build_sharded_tables(q, world, shard=rank).place(mesh,
                                                              device=dev)
    finally:
        conf.feature_dtype = old
    seeds = torch.arange(BATCH, dtype=torch.int32, device=dev)
    out = {}
    for routing in ("psum", "owner"):
        plan = make_partitioned_plan(q, mesh, st, routing=routing)
        gen = torch.Generator(device=dev).manual_seed(0)
        plan(seeds, gen)  # warm
        COLLECTIVES.reset()
        t0 = time.perf_counter()
        for _ in range(steps):
            res = plan(seeds, gen)
        float(res["h1"].float_attrs.sum())  # drain
        wall = (time.perf_counter() - t0) / steps * 1e3
        ops = {op: [c / steps, b / steps] for op, (c, b)
               in COLLECTIVES.by_op(GRAPH_AXIS).items()}
        out[routing] = {"ops": ops, "step_ms": wall}
    return out


def run(ranks: int = 2, device: str = "cuda",
        backend: Optional[str] = None, timeout_s: float = 300.0) -> dict:
    """Spawn ``ranks`` ranks and return rank 0's counts (every rank's
    must agree: one program)."""
    from graph_learn_tpu_torch.parallel.launch import spawn

    out = spawn(rank_bytes, ranks, device=device, backend=backend,
                timeout_s=timeout_s, threads=1 if device == "cpu" else None)
    for r in out[1:]:
        for routing in ("psum", "owner"):
            if r[routing]["ops"] != out[0][routing]["ops"]:
                raise RuntimeError("routing_bytes: the ranks counted apart: "
                                   "%r against %r" % (r, out[0]))
    return out[0]


def report(res: dict, ranks: int) -> None:
    print("config: batch=%d fanout=%d D=%d graph_shards=%d "
          "(1-hop EgoSAGE-style plan, float payload f32)"
          % (BATCH, FANOUT, WIDTH, ranks))
    for routing in ("psum", "owner"):
        acc = res[routing]["ops"]
        total = sum(v[1] for v in acc.values())
        print("routing=%-5s  per-device collective payload/step:" % routing)
        for op, (c, by) in sorted(acc.items()):
            print("    %-15s x%-2d  %10.1f KiB" % (op, c, by / 1024))
        print("    TOTAL              %10.1f KiB" % (total / 1024))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="gloo for ranks that share a card (required "
                    "there); default nccl on cards, gloo on the CPU")
    args = ap.parse_args(argv)
    res = run(args.ranks, args.device, args.backend)
    report(res, args.ranks)
    print(json.dumps({"graph_shards": args.ranks, "device": args.device,
                      "backend": args.backend or (
                          "gloo" if args.device == "cpu" else "nccl"),
                      **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
