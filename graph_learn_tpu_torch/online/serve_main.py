"""Serving-worker entry point: config JSON -> Graph -> HTTP server.

Counterpart of ``graph_learn_tpu/online/serve_main.py``: the process a
serving container runs (``deploy/k8s/serving.yaml``).  One process builds
the graph from TSV sources (or restores a ``Graph.save`` snapshot),
installs the configured queries and exported models, optionally polls an
update topic, and serves HTTP until SIGTERM.

The config is the JAX worker's, plus ``"device"`` (``--device`` on the
command line): the card (``"cuda"``) unless ``"cpu"`` is asked for; with
no card and no ``"cpu"`` the worker raises.  ``graph_shards`` above 1 (the
partitioned store) is not yet ported and raises::

    {
      "port": 8080,
      "host": "0.0.0.0",
      "device": "cuda",
      "nodes": [{"source": "file:///data/node_table", "type": "item",
                 "decoder": {"weighted": true, "labeled": true,
                              "attr_types": ["float", "float"]}}],
      "edges": [{"source": "file:///data/edge_table",
                 "type": ["item", "item", "rel"],
                 "decoder": {"weighted": true}, "directed": false}],
      "queries": [{"plan": {...gsl/plan.py JSON...}, "micro_batch": 256}],
      "models": [{"name": "sage", "artifact": "/models/sage.pt2"}],
      "update_topic": {"root": "/data/topic", "partitions": [0, 1],
                       "poll_interval_s": 5.0}
    }

Run: ``python -m graph_learn_tpu_torch.online.serve_main --config
conf.json [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import resolve_device


def _decoder(spec: dict) -> Decoder:
    spec = dict(spec or {})
    if "attr_types" in spec:  # JSON lists -> tuples for bucketed entries
        spec["attr_types"] = [tuple(t) if isinstance(t, list) else t
                              for t in spec["attr_types"]]
    return Decoder(**spec)


def graph_from_config(cfg: dict):
    """Build and init a Graph on the config's device from its nodes/edges
    sections, or restore a built store (``"snapshot": "/path"``) without
    any TSV ingest; the update pump then applies streamed deltas on
    top."""
    from graph_learn_tpu_torch.graph import Graph, Mask
    device = resolve_device(cfg.get("device", "cuda"))
    if cfg.get("snapshot"):
        return Graph.load(cfg["snapshot"], device=device)
    g = Graph(device=device)
    for n in cfg.get("nodes", []):
        mask = getattr(Mask, n["mask"].upper()) if n.get("mask") else None
        kw = {"mask": mask} if mask is not None else {}
        g.node(n["source"], node_type=n["type"],
               decoder=_decoder(n.get("decoder")), **kw)
    for e in cfg.get("edges", []):
        t = e["type"]
        if not (isinstance(t, (list, tuple)) and len(t) == 3):
            raise InvalidArgumentError(
                "edge type must be [src_type, dst_type, edge_type]")
        g.edge(e["source"], edge_type=tuple(t),
               decoder=_decoder(e.get("decoder")),
               directed=e.get("directed", True))
    return g.init()


def serve(cfg: dict, block: bool = True):
    """Start a ServingServer (and the update pump, given an
    ``update_topic``) from a config dict.

    Returns (server, stop_fn); with ``block=True`` runs until SIGTERM /
    SIGINT and returns None after shutdown."""
    from graph_learn_tpu_torch.gsl.plan import plan_to_query
    from graph_learn_tpu_torch.online.http import ServingServer
    g = graph_from_config(cfg)
    server = ServingServer(g, host=cfg.get("host", "127.0.0.1"),
                           port=int(cfg.get("port", 0)),
                           graph_shards=int(cfg.get("graph_shards", 1)),
                           device=g.device)
    server.start()
    for q in cfg.get("queries", []):
        server.service.install(plan_to_query(g, q["plan"]),
                               micro_batch=int(q.get("micro_batch", 256)))
    for m in cfg.get("models", []):
        server.service.install_model(m["name"], m["artifact"])
    stop_evt = threading.Event()
    pump = None
    topic_cfg = cfg.get("update_topic")
    if topic_cfg:
        from graph_learn_tpu_torch.online.stream import (FileTopic,
                                                         RecordPoller, ingest)
        topic = FileTopic(topic_cfg["root"], create=False)
        poller = RecordPoller(topic, partitions=topic_cfg.get("partitions"),
                              offsets=topic_cfg.get("offsets"))
        interval = float(topic_cfg.get("poll_interval_s", 5.0))

        def _pump():
            while not stop_evt.wait(interval):
                try:
                    ingest(g, poller, service=server.service)
                except Exception as e:  # keep serving on a bad batch
                    print("[serve] update batch failed: %s" % e,
                          file=sys.stderr)

        pump = threading.Thread(target=_pump, name="glt-update-pump",
                                daemon=True)
        pump.start()

    def stop(*_a):
        stop_evt.set()
        if pump is not None and pump is not threading.current_thread():
            pump.join(timeout=120)  # a batch in flight ends first
        server.stop()

    if block:
        signal.signal(signal.SIGTERM, stop)
        signal.signal(signal.SIGINT, stop)
        print("[serve] listening on %s:%d" % (server.host, server.port),
              flush=True)
        try:
            stop_evt.wait()
        except KeyboardInterrupt:
            pass
        stop()
        return None
    return server, stop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="config JSON path")
    ap.add_argument("--port", type=int, default=None,
                    help="override config port")
    ap.add_argument("--snapshot", default=None,
                    help="restore the built store from a Graph.save() "
                         "directory instead of ingesting TSVs")
    ap.add_argument("--device", default=None,
                    help="override config device (cuda or cpu; default "
                         "cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    for key in ("port", "snapshot", "device"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    serve(cfg, block=True)


if __name__ == "__main__":
    main()
