"""Serving-worker entry point: config JSON -> Graph -> HTTP server.

Counterpart of ``graph_learn_tpu/online/serve_main.py``: the process a
serving container runs (``deploy/k8s/serving.yaml``).  One process builds
the graph from TSV sources (or restores a ``Graph.save`` snapshot),
installs the configured queries and exported models, optionally polls an
update topic, and serves HTTP until SIGTERM.

The config is the JAX worker's, plus ``"device"`` (``--device`` on the
command line): the card (``"cuda"``) unless ``"cpu"`` is asked for; with
no card and no ``"cpu"`` the worker raises.

``"graph_shards": P`` above 1 serves from the partitioned store
(``online/serving.py``): the worker runs as P ranks.  Rank 0 builds the
graph, serves HTTP and runs the update pump; ranks 1..P-1 build the same
graph from the same config and follow it.  The ranks start one of two
ways: with ``GLT_COORDINATOR``, ``GLT_NUM_PROCS`` = P and
``GLT_PROC_ID`` set, each of P processes started apart (the k8s form)
joins through ``parallel.bootstrap.init_cluster``; otherwise this process
is rank 0 and starts ranks 1..P-1 on this host itself
(``parallel.launch.start``).  Stopping rank 0 ends every rank: its close
ends the followers' ``follow``, and a rank 0 that dies closes their
sockets.  Ranks that would share a card need ``"backend": "gloo"``
(NCCL refuses two ranks on one device); without it the worker raises::

    {
      "port": 8080,
      "host": "0.0.0.0",
      "device": "cuda",
      "graph_shards": 1,
      "backend": "gloo",
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
import os
import signal
import sys
import threading
import time
import traceback
from typing import Optional

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import resolve_device

# the deadline of the ranks' group: a rank waits this long for the others
# to arrive (each builds the graph first) and for a collective of a round
RANK_TIMEOUT_S = 600.0


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


class _Ranks:
    """The process group of a partitioned worker: joined from the
    environment, or made here with this process as rank 0 and ranks
    1..P-1 started on this host (module note)."""

    def __init__(self):
        self.procs, self.where, self.rank = [], None, 0

    def start(self, cfg: dict, shards: int):
        """Join (or make) the group; returns this rank's graph."""
        import torch.distributed as dist

        from graph_learn_tpu_torch.parallel import bootstrap, launch
        device = cfg.get("device", "cuda")
        backend = cfg.get("backend")
        if os.environ.get("GLT_COORDINATOR"):
            bootstrap.init_cluster(backend=backend, device=device,
                                   timeout_s=RANK_TIMEOUT_S)
            g = graph_from_config(
                dict(cfg, device=str(bootstrap.current_device())))
        else:
            dev = bootstrap.rank_device(0, device)  # raises without a card
            bootstrap.choose_backend(dev, shards, backend)  # the refusal
            self.where, self.procs = launch.start(
                _follower_main, range(1, shards), (shards, cfg))
            g = graph_from_config(dict(cfg, device=str(dev)))
            self._wait_ready()
            launch.join(0, shards, self.where, device, backend,
                        RANK_TIMEOUT_S)
        self.rank = dist.get_rank()
        if dist.get_world_size() != shards:
            raise InvalidArgumentError(
                "graph_shards %d over a group of %d ranks"
                % (shards, dist.get_world_size()))
        return g

    def _wait_ready(self):
        """Wait until every started rank has built its graph (and is about
        to join); a rank that dies first fails the start with its
        traceback."""
        from graph_learn_tpu_torch.parallel import launch
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for r, p in enumerate(self.procs, start=1):
            ready = os.path.join(self.where, "rank%d.ready" % r)
            while not os.path.exists(ready):
                if not p.is_alive() or time.monotonic() > deadline:
                    errors = launch.stop(self.procs, self.where)
                    self.procs, self.where = [], None
                    raise launch.RankFailed(
                        "serving rank %d did not start: %s" % (
                            r, "\n".join(errors) or "exit code %s"
                            % p.exitcode))
                time.sleep(0.05)

    def stop(self):
        """Wait for the started ranks (their ``follow`` ended by the
        service's close), end any left, and leave the group."""
        from graph_learn_tpu_torch.parallel import bootstrap, launch
        procs, where, self.procs, self.where = self.procs, self.where, [], None
        for err in launch.stop(procs, where, grace_s=30.0):
            print("[serve] a rank failed:\n%s" % err, file=sys.stderr)
        bootstrap.shutdown()


def _follower_main(rank: int, where: str, shards: int, cfg: dict):
    """A rank that the worker's rank 0 started: the same graph from the
    same config, then the leader's commands until it closes the
    service."""
    from graph_learn_tpu_torch.online.serving import QueryService
    from graph_learn_tpu_torch.parallel import bootstrap, launch
    try:
        device = cfg.get("device", "cuda")
        g = graph_from_config(
            dict(cfg, device=str(bootstrap.rank_device(rank, device))))
        open(os.path.join(where, "rank%d.ready" % rank), "w").close()
        launch.join(rank, shards, where, device, cfg.get("backend"),
                    RANK_TIMEOUT_S)
        try:
            QueryService(g, device=g.device, graph_shards=shards).follow()
        finally:
            bootstrap.shutdown()
    except BaseException:
        with open(os.path.join(where, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def serve(cfg: dict, block: bool = True):
    """Start a ServingServer (and the update pump, given an
    ``update_topic``) from a config dict.

    Returns (server, stop_fn); with ``block=True`` runs until SIGTERM /
    SIGINT and returns None after shutdown.  With ``graph_shards`` above
    1 on a rank other than 0 (the environment's form), follows rank 0
    until it stops and returns None."""
    from graph_learn_tpu_torch.online.serving import QueryService
    shards = int(cfg.get("graph_shards", 1))
    if shards <= 1:
        return _serve(graph_from_config(cfg), cfg, block, None)
    ranks = _Ranks()
    try:
        g = ranks.start(cfg, shards)
        if ranks.rank != 0:
            QueryService(g, device=g.device, graph_shards=shards).follow()
            ranks.stop()
            return None
        return _serve(g, cfg, block, ranks)
    except BaseException:
        ranks.stop()
        raise


def _serve(g, cfg: dict, block: bool, ranks: Optional[_Ranks]):
    from graph_learn_tpu_torch.gsl.plan import plan_to_query
    from graph_learn_tpu_torch.online.http import ServingServer
    server = ServingServer(g, host=cfg.get("host", "127.0.0.1"),
                           port=int(cfg.get("port", 0)),
                           graph_shards=int(cfg.get("graph_shards", 1)),
                           device=g.device)
    server.ranks = ranks
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
        if ranks is not None:
            ranks.stop()

    if block:
        signal.signal(signal.SIGTERM, stop)
        signal.signal(signal.SIGINT, stop)
        print("[serve] listening on %s:%d%s" % (
            server.host, server.port, "" if ranks is None else
            " (rank 0 of %d; ranks started here: pids %s)" % (
                server.service.graph_shards,
                [p.pid for p in ranks.procs])), flush=True)
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
