"""The 62M-edge frontier config with float32 and then bfloat16 tables.

Counterpart of ``examples/scale_matrix.py`` (``main:27-46``): the port
bench's ``run_bench(CFG_SCALE)`` (2 450 000 nodes, 61.25M weighted edges,
EgoGraphSAGE fanout [15, 10], batch 1 024, the "minimal" store profile;
K = 20 steps a call in one CUDA graph on the card) twice in one process,
``conf.feature_dtype`` float32 and then bfloat16 (half the bytes of the
feature rows the step gathers).  One store serves both runs
(``run_bench(graph=...)``): its edge table's CSR is built once, and its
node table's view is dropped before each run (``NodeTable.drop_device``)
so that each run's feature table has that run's dtype; each record names
the table's dtype and bytes.  The kernels on this path are Kernel 1 (the
src and hop-1 rows) and Kernel 2 (the deepest hop's means).

Each run prints one JSON line ``{"metric":
"ego_sage_scale62m_edges_per_s", "feature_dtype", "value", "unit",
"wall_s"}``, then a line with the table's dtype and bytes.  The JAX
script's ``vs_r2_record`` is left out: it divides by a TPU record
(``bench.py:81``), as the port bench leaves out
``scale62m_vs_r02_record``.  ``GLT_USE_PALLAS=1`` raises, as
``config.set_use_pallas`` does: the port has no plain-route switch.

Usage:  python -m graph_learn_tpu_torch.examples.scale_matrix [--small]
            [--cpu]
``--small`` takes the port bench's ``CFG`` (its ``CFG_SMALL`` sizes under
``GLT_BENCH_SMALL=1``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from graph_learn_tpu_torch import bench, config
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.examples.gat_scale import scale_cfg
from graph_learn_tpu_torch.graph import Graph
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

DTYPES = ("float32", "bfloat16")
METRIC = "ego_sage_scale62m_edges_per_s"


def run(cfg: Optional[dict] = None, device: DeviceLike = "cuda",
        graph: Optional[Tuple[Graph, Decoder]] = None
        ) -> List[Dict[str, object]]:
    """``run_bench(cfg)`` (default ``CFG_SCALE``) once per dtype of
    ``DTYPES``, on one store (``graph``, a ``bench.build_graph`` result on
    the same device, or one built here).  Returns one dict per run: the
    JSON record under "record", the feature table's "table_dtype" and
    "table_bytes", and ``run_bench``'s result under "bench"."""
    if os.environ.get("GLT_USE_PALLAS") == "1":
        config.set_use_pallas(True)  # raises: no plain-route switch
    dev = resolve_device(device)
    cfg = dict(bench.CFG_SCALE if cfg is None else cfg)
    out = []
    for dt in DTYPES:
        with bench.bench_conf(feature_dtype=dt, storage_profile="minimal"):
            t0 = time.time()
            if graph is None:
                graph = bench.build_graph(cfg, dev)
            graph[0].store.node_table("item").drop_device(dev)
            r = bench.run_bench(cfg, dev, graph=graph)
            wall = time.time() - t0
        table = r["tables"]["nodes"]["item"].float_attrs
        out.append({
            "record": {"metric": METRIC, "feature_dtype": dt,
                       "value": round(r["edges_per_s"], 1),
                       "unit": "edges/s/chip", "wall_s": round(wall, 1)},
            "table_dtype": str(table.dtype).replace("torch.", ""),
            "table_bytes": table.numel() * table.element_size(),
            "bench": r})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    for r in run(scale_cfg(args.small), dev):
        print(json.dumps(r["record"]), flush=True)
        print("[scale_matrix] %s: feature table %s, %d bytes; %s"
              % (r["record"]["feature_dtype"], r["table_dtype"],
                 r["table_bytes"], r["bench"]["device"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
