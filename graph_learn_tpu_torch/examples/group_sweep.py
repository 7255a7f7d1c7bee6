"""The grouped-sampling width G at the 62M-edge frontier config.

Counterpart of ``examples/group_sweep.py`` (``main:23-87``).  The port
bench's K-step function (``bench.make_multi_step``) samples its seed
batches G at a time and reduces the deepest hop of all G in one call of
``gather_group_agg`` (Kernel 2 on the card: one launch for ``[G * b *
k1, k2]`` ids), then runs the G train steps; the src and hop-1 rows are
gathered by Kernel 1 in each step.  This script times G in {1, 4, 10, 20}
at ``bench.CFG_SCALE`` (2 450 000 nodes, 61.25M weighted edges, K = 20,
the "minimal" store profile), skipping any G that does not divide K, as
the JAX script does, from the same weights and generator seed for every
G; on the card each G's K steps are one CUDA graph.  A call of K steps
launches ``2 K`` ``gather_rows`` and ``K / G`` ``segment_spmm``
(:func:`launches_per_call`).

Usage:  python -m graph_learn_tpu_torch.examples.group_sweep [--small]
            [--cpu]
``--small`` takes the port bench's ``CFG`` (its ``CFG_SMALL`` sizes under
``GLT_BENCH_SMALL=1``), whose K = 30 skips G = 4 and 20.  Prints one line
per G:  G=<g>  <eps> edges/s   <ms> ms/step   (warmup <s>s).

Env:
  GLT_FEATURE_DTYPE    float32 | bfloat16 (default bfloat16)
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.examples.gat_scale import scale_cfg
from graph_learn_tpu_torch.examples.scale_demo import two_hop_query
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

GROUPS = (1, 4, 10, 20)
# the weights' seed; the steps' generator is seeded with SEED + 7
SEED = 0


def widths(K: int) -> List[int]:
    """The G of ``GROUPS`` that divide K (the others are skipped)."""
    return [G for G in GROUPS if K % G == 0]


def launches_per_call(K: int, G: int) -> Dict[str, int]:
    """Kernel launches of one call of K steps in groups of G."""
    return {"gather_rows": 2 * K, "segment_spmm": K // G}


def run(cfg: dict, device: DeviceLike = "cuda",
        graph: Optional[Tuple[Graph, Decoder]] = None,
        inspect: Optional[Callable[[int, bench.MultiStep], object]] = None
        ) -> Dict[str, object]:
    """Build the bench graph (or take ``graph``, a ``bench.build_graph``
    result on the same device), put the plan's tables on the device, then
    for each G of :func:`widths`: a fresh EgoGraphSAGE ``[feat_dim,
    hidden, classes]`` "gcn" (weights from ``SEED``) and Adam, the K-step
    function (captured on the card; its generator seeded with ``SEED +
    7``), one warm-up call and ``cfg["steps"] // K`` timed calls
    (``bench.time_calls``).

    Returns "device", "K", "skipped" (the G that do not divide K) and
    under "runs" one dict per G: "G", ``bench.time_calls``'s numbers, and
    what ``inspect(G, step)``, called after the timed calls, returned."""
    dev = resolve_device(device)
    if graph is None:
        graph = bench.build_graph(cfg, dev, SEED)
    g, dec = graph
    k1, k2 = cfg["fanout"]
    b, K = cfg["batch"], cfg["scan_steps"]
    q = two_hop_query(g, b, (k1, k2))
    tables = q.device_tables(dev)
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "K": K,
        "skipped": [G for G in GROUPS if K % G], "runs": []}
    for G in widths(K):
        model = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                             dec, agg_type="gcn", device=dev,
                             generator=torch.Generator().manual_seed(SEED))
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        step = bench.make_multi_step(q, tables, model,
                                     bench.make_optimizer(model, dev), cfg, G,
                                     gen)
        r = bench.time_calls(step, cfg, b * (k1 + k1 * k2))
        r.update(G=G, inspected=inspect(G, step) if inspect is not None
                 else None)
        out["runs"].append(r)
        del step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    dtype = os.environ.get("GLT_FEATURE_DTYPE", "bfloat16")
    profile = "full" if args.small else "minimal"
    with bench.bench_conf(feature_dtype=dtype, storage_profile=profile):
        r = run(scale_cfg(args.small), dev)
    for x in r["runs"]:
        print("G=%-3d %12.1f edges/s   %.3f ms/step   (warmup %.1fs)"
              % (x["G"], x["edges_per_s"], x["step_ms"], x["warm_s"]),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
