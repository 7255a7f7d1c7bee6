"""HTTP front end and client of the online tier.

Counterpart of ``graph_learn_tpu/online/http.py`` (the DGS service edge:
the admin routes of the coordinator and the serving route of the
workers), one stdlib ``ThreadingHTTPServer`` in front of ``QueryService``.
Routes, each the JAX worker's:

- ``POST /admin/query``      body = plan JSON (gsl/plan.py) -> {"qid": n}
- ``GET  /admin/schema``     node/edge types and counts
- ``GET  /admin/query/stats?qid=N``  latency / QPS stats
- ``POST /serving``          {"qid": n, "ids": [...]} -> {alias: payload}
- ``POST /admin/update``     {"edges": {type: {src_ids, dst_ids, ...}},
                              "nodes": {type: {ids, ...}}} staged + applied
- ``POST /admin/expire``     {"older_than": t, "edge_types": [...]}
- ``POST /admin/refresh``    publish applied updates to the served queries
- ``POST /admin/model``      {"name", "artifact" (a path on the server) or
                              "artifact_b64"} -> {"name", "batch"}
- ``POST /predict``          {"model", "ids", "seed"} -> {"outputs"}
- ``GET  /healthz``          readiness / liveness probe

The JSON on the wire is the JAX worker's (``_to_jsonable`` /
``_value_payload``): every payload field a value carries, floats as
float64 lists, ints as int lists, deferred feature rows gathered (Kernel 1
on the card) and brought to the host first.  So ``clients/py`` and
``clients/cpp`` talk to a worker of either package unchanged.  The
artifact of ``/admin/model`` is a ``torch.export`` program
(online/export.py); it is read from any path the server can open, as the
JAX worker reads its StableHLO artifacts, and anything else is refused.

``/serving`` takes no lock: each installed query coalesces its callers
and serves them from copy-on-write snapshots, so admin work never stalls
reads.  Admin mutations take one lock.

With ``graph_shards = P > 1`` the server runs on the leader of a
partitioned ``QueryService`` (rank 0 of a P-rank group; the other ranks
follow it, ``online/serving.py``): ``/admin/query`` installs through the
service's command stream, and ``/admin/update``, ``/admin/expire`` and
``/admin/refresh`` change the leader's graph, which reaches the
followers' blocks at the next refresh.

``online/serve_main.py`` builds the graph from a config JSON and runs this
server.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import request as _urlreq
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from graph_learn_tpu_torch.core.values import DeferredRows
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.gsl.plan import plan_to_query, query_to_plan
from graph_learn_tpu_torch.online.serving import QueryService
from graph_learn_tpu_torch.online.update import (UpdateBuffer,
                                                 apply_updates, expire_edges)
from graph_learn_tpu_torch.utils.platform import DeviceLike


def _to_jsonable(x):
    if isinstance(x, DeferredRows):
        x = x.materialize()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype.is_floating_point:
            x = x.to(torch.float64)
        return x.tolist()
    return x


def _value_payload(v) -> dict:
    out = {}
    for f in ("ids", "raw_ids", "degrees", "weights", "labels",
              "timestamps", "int_attrs", "float_attrs", "edge_ids"):
        a = getattr(v, f, None)
        if a is not None:
            out[f] = _to_jsonable(a)
    for sub in ("src_nodes", "dst_nodes"):
        n = getattr(v, sub, None)
        if n is not None:
            out[sub] = _value_payload(n)
    return out


class ServingServer:
    """HTTP front end over a graph: install plans, serve, ingest updates,
    serve exported models; on the card unless ``device="cpu"``.  With
    ``graph_shards > 1``, built on the leader rank (the followers build
    the ``QueryService`` alone and follow it)."""

    def __init__(self, graph, host: str = "127.0.0.1", port: int = 0,
                 graph_shards: int = 1, device: DeviceLike = "cuda"):
        self.graph = graph
        self.service = QueryService(graph, device=device,
                                    graph_shards=graph_shards)
        if not self.service.is_leader:
            raise InvalidArgumentError(
                "the HTTP server runs on the leader of the partitioned "
                "service; this rank follows it (QueryService.follow)")
        self._buf = UpdateBuffer()
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                try:
                    u = urlparse(self.path)
                    if u.path == "/healthz":
                        self._send(200, {"ok": True,
                                         "queries": len(
                                             outer.service._queries)})
                    elif u.path == "/admin/schema":
                        self._send(200, outer.graph.get_stats())
                    elif u.path == "/admin/query/stats":
                        qid = int(parse_qs(u.query)["qid"][0])
                        self._send(200, outer.service.stats(qid))
                    else:
                        self._send(404, {"error": "unknown route"})
                except Exception as e:  # the client gets the error
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                try:
                    self._post(urlparse(self.path).path, self._body())
                except Exception as e:  # the client gets the error
                    self._send(500, {"error": str(e)})

            def _post(self, path: str, body: dict):
                svc = outer.service
                if path == "/admin/query":
                    q = plan_to_query(outer.graph, body)
                    mb = int(body.get("micro_batch", 256))
                    with outer._lock:
                        qid = svc.install(q, micro_batch=mb)
                    self._send(200, {"qid": qid})
                elif path == "/serving":
                    ids = np.asarray(body["ids"], np.int64)
                    qid = int(body["qid"])
                    if qid not in svc._queries:
                        raise KeyError("unknown qid %r" % qid)
                    out = svc.run(qid, ids)
                    self._send(200, {a: _value_payload(v)
                                     for a, v in out.items()})
                elif path == "/admin/update":
                    with outer._lock:
                        for t, kw in body.get("nodes", {}).items():
                            outer._buf.add_nodes(t, **{
                                k: np.asarray(v) for k, v in kw.items()})
                        for t, kw in body.get("edges", {}).items():
                            outer._buf.add_edges(t, **{
                                k: np.asarray(v) for k, v in kw.items()})
                        apply_updates(outer.graph, outer._buf)
                        outer._buf.clear()
                    self._send(200, {"ok": True})
                elif path == "/admin/expire":
                    with outer._lock:
                        dropped = expire_edges(outer.graph,
                                               body["older_than"],
                                               body.get("edge_types"))
                    self._send(200, {"dropped": dropped})
                elif path == "/admin/refresh":
                    with outer._lock:
                        svc.refresh()
                    self._send(200, {"ok": True})
                elif path == "/admin/model":
                    art = (base64.b64decode(body["artifact_b64"])
                           if "artifact_b64" in body else body["artifact"])
                    with outer._lock:
                        m = svc.install_model(body["name"], art)
                    self._send(200, {"name": m.name, "batch": m.batch})
                elif path == "/predict":
                    out = svc.predict(body["model"], body["ids"],
                                      seed=int(body.get("seed", 0)))
                    self._send(200, {"outputs": torch.utils._pytree.tree_map(
                        lambda x: np.asarray(x).tolist(), out)})
                else:
                    self._send(404, {"error": "unknown route"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.service.close()


class ServingClient:
    """Remote GSL client: a built query or plan JSON -> install -> run by
    ids (the Java GSL client's transport)."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = _urlreq.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with _urlreq.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _get(self, path: str) -> dict:
        with _urlreq.urlopen(self.base + path, timeout=self.timeout) as r:
            return json.loads(r.read())

    def schema(self) -> dict:
        return self._get("/admin/schema")

    def install(self, query_or_plan, micro_batch: int = 256) -> int:
        plan = (query_or_plan if isinstance(query_or_plan, dict)
                else query_to_plan(query_or_plan))
        plan = dict(plan, micro_batch=micro_batch)
        return int(self._post("/admin/query", plan)["qid"])

    def run(self, qid: int, ids) -> dict:
        return self._post("/serving", {
            "qid": qid, "ids": np.asarray(ids).tolist()})

    def install_model(self, name: str, artifact) -> dict:
        """artifact: a path on the server (str) or the exported bytes."""
        if isinstance(artifact, (bytes, bytearray)):
            return self._post("/admin/model", {
                "name": name,
                "artifact_b64": base64.b64encode(bytes(artifact)).decode()})
        return self._post("/admin/model", {"name": name,
                                           "artifact": artifact})

    def predict(self, model: str, ids, seed: int = 0):
        return self._post("/predict", {
            "model": model, "ids": np.asarray(ids).tolist(),
            "seed": int(seed)})["outputs"]

    def update(self, nodes: Optional[dict] = None,
               edges: Optional[dict] = None) -> dict:
        return self._post("/admin/update", {
            "nodes": nodes or {}, "edges": edges or {}})

    def expire(self, older_than, edge_types=None) -> dict:
        return self._post("/admin/expire", {
            "older_than": int(older_than), "edge_types": edge_types})

    def refresh(self):
        return self._post("/admin/refresh", {})

    def stats(self, qid: int) -> dict:
        return self._get("/admin/query/stats?qid=%d" % qid)
