"""Store snapshot and restore at the 61.25M-edge scale configuration.

Counterpart of the repository's ``examples/snapshot_scale.py``: on the
host, with one sampled batch at the end,

  build  draw and build the weighted 61.25M-edge store (``bench.CFG_SCALE``
         under the "minimal" profile): what a cold start pays without a
         snapshot
  save   ``Graph.save`` to a directory of ``.npy`` arrays
  load   ``Graph.load`` (memory-mapped)
  touch  the first sampled batch of the restored store, its device views
         (the CSR build) included

Usage:  python -m graph_learn_tpu_torch.examples.snapshot_scale [--small]
            [--dir PATH] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.snapshot import MANIFEST
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


def snapshot_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def clear(path: str):
    """Remove ``path`` if it is a snapshot directory; refuse any other
    existing directory (a mistyped path is never deleted)."""
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, MANIFEST)):
            raise SystemExit("%r exists and is not a snapshot directory (no "
                             "%s); refusing to delete it" % (path, MANIFEST))
        shutil.rmtree(path)


def touch(g: Graph, device: DeviceLike) -> float:
    """Seconds to the first sampled batch (256 seeds, 5 neighbours)."""
    t0 = time.perf_counter()
    q = (g.V("item").batch(256).alias("src")
         .outV("rel").sample(5).by("random").alias("h1").values())
    out = Dataset(q, window=1, device=device).next()
    if tuple(out["h1"].ids.shape) != (256, 5):
        raise RuntimeError("touch: hop shape %s" % (tuple(out["h1"].ids.shape),))
    bench._sync(resolve_device(device))
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "glt_snapshot_scale"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = dict(bench.CFG if args.small else bench.CFG_SCALE)
    profile = "full" if args.small else "minimal"
    with bench.bench_conf(storage_profile=profile):
        t0 = time.perf_counter()
        g, _ = bench.build_graph(cfg, dev)
        t_build = time.perf_counter() - t0
        print("build  %6.1fs  (%d nodes / %d edges)"
              % (t_build, cfg["n_nodes"], cfg["n_nodes"] * cfg["avg_degree"]),
              flush=True)
        clear(args.dir)
        t0 = time.perf_counter()
        g.save(args.dir)
        t_save = time.perf_counter() - t0
        nb = snapshot_bytes(args.dir)
        print("save   %6.1fs  (%.2f GB, %.0f MB/s)"
              % (t_save, nb / 1e9, nb / 1e6 / t_save), flush=True)
        t0 = time.perf_counter()
        g2 = Graph.load(args.dir, device=dev)
        t_load = time.perf_counter() - t0
        print("load   %6.1fs  (memory-mapped; %.1fx faster than the build)"
              % (t_load, t_build / max(t_load, 1e-9)), flush=True)
        print("touch  %6.1fs  (first sampled batch, device views included)"
              % touch(g2, dev), flush=True)


if __name__ == "__main__":
    main()
