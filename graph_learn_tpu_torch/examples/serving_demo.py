"""Serving-worker demo: the flow ``deploy/k8s/serving.yaml`` runs, on the
port.

Counterpart of ``examples/serving_demo.py``: writes a small graph as TSV
files and a ``serve_main`` config JSON (the shape the k8s ConfigMap
mounts), starts the worker in-process, and drives it as an outside client
does: the healthz probe, a query installed over HTTP, serving runs, an
update streamed through a FileTopic and picked up by the update pump, and
a query after it.

Usage:  python -m graph_learn_tpu_torch.examples.serving_demo [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
import urllib.request

import numpy as np

from graph_learn_tpu_torch.gsl.plan import query_to_plan
from graph_learn_tpu_torch.online.http import ServingClient
from graph_learn_tpu_torch.online.serve_main import serve
from graph_learn_tpu_torch.online.stream import FileTopic, StreamProducer


def write_graph(d: str, n: int = 200):
    """The example's node and edge tables (the JAX example's bytes)."""
    rng = np.random.default_rng(0)
    node, edge = os.path.join(d, "node_table"), os.path.join(d, "edge_table")
    with open(node, "w") as f:
        f.write("id:int64\tlabel:int64\tfeature:string\n")
        for i in range(n):
            f.write("%d\t%d\t%s\n" % (i, i % 5, ":".join(
                "%.4f" % x for x in rng.random(4))))
    with open(edge, "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for i in range(n):
            for j in range(1 + i % 4):
                f.write("%d\t%d\t%.2f\n"
                        % (i, (i * 7 + j * 13) % n, 0.5 + j))
    return node, edge


def run(device: str = "cuda") -> dict:
    """The demo; returns the degree of node 0 after the streamed update and
    the shape of the last answer's first hop."""
    d = tempfile.mkdtemp(prefix="glt_serving_demo_")
    try:
        node, edge = write_graph(d)
        topic_root = os.path.join(d, "topic")
        FileTopic(topic_root, num_partitions=2)
        cfg = {
            "host": "127.0.0.1", "port": 0, "device": device,
            "nodes": [{"source": node, "type": "item",
                       "decoder": {"labeled": True,
                                   "attr_types": ["float"] * 4}}],
            "edges": [{"source": edge, "type": ["item", "item", "rel"],
                       "decoder": {"weighted": True}}],
            "update_topic": {"root": topic_root, "poll_interval_s": 0.5},
        }
        cfg_path = os.path.join(d, "serving.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2)
        print("config (the k8s ConfigMap payload): %s" % cfg_path)

        server, stop = serve(cfg, block=False)
        try:
            base = "http://%s:%d" % (server.host, server.port)
            print("worker up at %s on %s" % (base, server.service.device))
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                print("healthz:", json.loads(r.read()))
            client = ServingClient(base, timeout=300.0)
            q = (server.graph.V("item").batch(8).alias("src")
                 .outV("rel").sample(4).by("edge_weight").alias("h1")
                 .outV("rel").sample(3).by("random").alias("h2").values())
            qid = client.install(query_to_plan(q), micro_batch=8)
            t0 = time.perf_counter()
            out = client.run(qid, list(range(8)))
            print("install+run qid=%d: h2 ids %s (%.1f ms on the host "
                  "clock)" % (qid, np.asarray(out["h2"]["ids"]).shape,
                              1e3 * (time.perf_counter() - t0)))
            # stream an update as a dataloader pod would
            StreamProducer(FileTopic(topic_root, create=False)).put_edges(
                "rel", [0] * 3, [50, 60, 70], weights=[9.0, 9.0, 9.0])
            deadline = time.time() + 15
            deg = 0
            while time.time() < deadline:
                deg = int(server.graph.out_degrees(np.array([0]), "rel")[0])
                if deg >= 4:
                    break
                time.sleep(0.2)
            print("deg(0) after streamed update:", deg)
            out2 = client.run(qid, [0])
            h1 = np.asarray(out2["h1"]["ids"]).shape
            print("post-update serve ok:", h1)
        finally:
            stop()
        print("done")
        return {"deg0": deg, "h1_shape": h1}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU instead of the card")
    args = ap.parse_args(argv)
    return run(device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
