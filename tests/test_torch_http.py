"""The port's HTTP worker, router and serve_main on the CPU: each case of
tests/test_online.py's HTTP cases, tests/test_router.py,
tests/test_serve_main.py and tests/test_multiprocess_serving.py (worker
processes with ``--device cpu``); plus a port worker's wire format and
``/predict`` answer held to the JAX worker's."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.gsl.compile import _execute
from graph_learn_tpu_torch.gsl.plan import query_to_plan
from graph_learn_tpu_torch.online.export import export_serving_fn
from graph_learn_tpu_torch.online.http import ServingClient, ServingServer
from graph_learn_tpu_torch.online.router import RateLimiter, ServingRouter
from graph_learn_tpu_torch.online.serve_main import (_decoder,
                                                     graph_from_config, serve)
from graph_learn_tpu_torch.online.stream import FileTopic, StreamProducer
from graph_learn_tpu_torch.online.update import (UpdateBuffer, UpdateLog,
                                                 apply_updates)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_graph(paths):
    g = glt.Graph(device="cpu")
    g.node(paths["node"], node_type="item",
           decoder=glt.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(paths["edge"], edge_type=("item", "item", "rel"),
           decoder=glt.Decoder(weighted=True))
    return g.init()


def _jax_graph(paths):
    g = gl.Graph()
    g.node(paths["node"], node_type="item",
           decoder=gl.Decoder(weighted=True, labeled=True,
                              attr_types=["float"] * 4))
    g.edge(paths["edge"], edge_type=("item", "item", "rel"),
           decoder=gl.Decoder(weighted=True))
    return g.init()


def _url(srv):
    return "http://%s:%d" % (srv.host, srv.port)


@pytest.fixture
def g(tmp_graph_dir):
    return _mk_graph(tmp_graph_dir)


# --- the worker (tests/test_online.py:113-152, 272-329, 548-597) ----------

def test_http_serving_tier(g):
    srv = ServingServer(g, device="cpu").start()
    try:
        c = ServingClient(_url(srv))
        assert c.schema()["nodes"]["item"] == 40
        q = (g.V("item").batch(4).alias("src")
             .outV("rel").sample(3).by("random").alias("hop1").values())
        qid = c.install(q, micro_batch=8)
        out = c.run(qid, [0, 10, 20, 30, 40, 50])
        assert len(out["src"]["ids"]) == 6
        assert len(out["hop1"]["ids"]) == 6
        assert len(out["hop1"]["ids"][0]) == 3
        assert len(out["src"]["float_attrs"][0]) == 4
        assert c.stats(qid)["qps"] > 0
        c.update(edges={"rel": {"src_ids": [0, 0], "dst_ids": [390, 380],
                                "weights": [9.0, 8.0]}})
        c.refresh()
        q2 = (g.V("item").batch(1).alias("src")
              .outV("rel").sample(3).by("topk").alias("top").values())
        qid2 = c.install(q2, micro_batch=4)
        got = set(c.run(qid2, [0])["top"]["ids"][0])
        assert 39 in got and 38 in got
        # errors reach the client as HTTP 500 with the message
        with pytest.raises(urllib.error.HTTPError):
            c.run(99, [0])
        with pytest.raises(urllib.error.HTTPError):
            c._get("/nope")
    finally:
        srv.stop()


def test_expire_route(tmp_path):
    with open(tmp_path / "n", "w") as f:
        f.write("id:int64\n" + "".join("%d\n" % i for i in range(4)))
    with open(tmp_path / "e", "w") as f:
        f.write("src_id:int64\tdst_id:int64\ttimestamp:int64\n")
        f.write("0\t1\t10\n1\t2\t20\n2\t3\t30\n")
    g = (glt.Graph(device="cpu").node(str(tmp_path / "n"), "v", glt.Decoder())
         .edge(str(tmp_path / "e"), ("v", "v", "e"),
               glt.Decoder(timestamped=True))).init()
    srv = ServingServer(g, device="cpu").start()
    try:
        assert ServingClient(_url(srv)).expire(25) == {"dropped": {"e": 2}}
        assert g.store.edge_table("e").num_edges == 1
    finally:
        srv.stop()


def test_concurrent_clients_with_streaming_updates(g):
    """8 concurrent clients on one installed query while updates stream
    through /admin/update + /admin/refresh: every answer equals the topk
    oracle of ids the updates do not touch."""
    srv = ServingServer(g, device="cpu").start()
    try:
        c = ServingClient(_url(srv))
        q = (g.V("item").batch(4).alias("src")
             .outV("rel").sample(3).by("topk").alias("h1").values())
        qid = c.install(q, micro_batch=32)
        ids = [100, 110, 120, 130, 140, 150, 160, 170]
        oracle = {i: c.run(qid, [i])["h1"]["ids"][0] for i in ids}
        errors, done = [], threading.Event()

        def client(tid):
            cc = ServingClient(_url(srv))
            try:
                for r in range(6):
                    i = ids[(tid + r) % len(ids)]
                    out = cc.run(qid, [i])
                    if out["h1"]["ids"][0] != oracle[i]:
                        errors.append((tid, i, out["h1"]["ids"][0]))
            except Exception as e:  # reported by the assert below
                errors.append((tid, repr(e)))

        def updater():
            cc = ServingClient(_url(srv))
            k = 0
            while not done.is_set() and k < 20:
                cc.update(edges={"rel": {"src_ids": [0],
                                         "dst_ids": [(k * 10) % 390],
                                         "weights": [5.0 + k]}})
                cc.refresh()
                k += 1

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        upd = threading.Thread(target=updater)
        upd.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        upd.join(timeout=120)
        assert not any(t.is_alive() for t in threads + [upd])
        assert not errors, errors[:5]
        st = c.stats(qid)
        assert st["p99_ms"] > 0 and st["qps"] > 0
    finally:
        srv.stop()


def _toy_serve(q, tables):
    def serve_fn(seeds, generator):
        out = _execute(q, tables, seeds, generator)
        nbr = out["hop1"].float_attrs.materialize().mean(dim=1)
        return torch.cat([out["src"].float_attrs.materialize(), nbr], dim=-1)
    return serve_fn


def test_model_predict_over_http(g, tmp_path):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("hop1").values())
    serve_fn = _toy_serve(q, q.device_tables("cpu"))
    path = str(tmp_path / "embed.pt2")
    blob = export_serving_fn(serve_fn, (np.arange(4), 0), path=path,
                             device="cpu")
    srv = ServingServer(g, device="cpu").start()
    try:
        c = ServingClient(_url(srv))
        assert c.install_model("embed", path) == {"name": "embed",
                                                  "batch": 4}
        got = np.asarray(c.predict("embed", [1, 2, 3]))
        want = serve_fn(torch.tensor([1, 2, 3, 1], dtype=torch.int32),
                        None).numpy()[:3]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        c.install_model("embed2", blob)  # inline bytes
        assert np.asarray(c.predict("embed2", [5], seed=3)).shape == (1, 8)
        for bad in ({"model": "nope", "ids": [1]},
                    {"model": "embed", "ids": list(range(9))},
                    {"model": "embed", "ids": []}):
            with pytest.raises(urllib.error.HTTPError):
                c._post("/predict", bad)
        with pytest.raises(urllib.error.HTTPError):
            c.install_model("bad", b"\x00not a program")
    finally:
        srv.stop()


# --- the wire format and /predict against the JAX worker -------------------

def _two_hop_topk(graph):
    return (graph.V("item").batch(4).alias("src")
            .outV("rel").sample(3).by("topk").alias("hop1")
            .outV("rel").sample(2).by("topk").alias("hop2").values())


def test_serving_payloads_equal_the_jax_workers(tmp_graph_dir):
    """The same deterministic query on a JAX worker and a port worker:
    the JSON answers are equal, key for key and value for value, edge
    hops' nested payloads included."""
    from graph_learn_tpu.online.http import ServingServer as JaxServer
    jsrv = JaxServer(_jax_graph(tmp_graph_dir)).start()
    tsrv = ServingServer(_mk_graph(tmp_graph_dir), device="cpu").start()
    try:
        plan = query_to_plan(_two_hop_topk(tsrv.graph))
        edge_plan = query_to_plan(
            tsrv.graph.V("item").batch(4).alias("src")
            .outE("rel").sample(3).by("topk").alias("e1").values())
        ids = [0, 10, 20, 390, 70]
        for p in (plan, edge_plan):
            answers = []
            for srv in (jsrv, tsrv):
                c = ServingClient(_url(srv))
                answers.append(c._post("/serving", {
                    "qid": c.install(p, micro_batch=4), "ids": ids}))
            assert json.dumps(answers[0], sort_keys=True) == \
                json.dumps(answers[1], sort_keys=True)
    finally:
        jsrv.stop()
        tsrv.stop()


def test_predict_equals_the_jax_workers(tmp_graph_dir, tmp_path):
    """The whole slice: a flax EgoGraphSAGE's params, carried by
    load_flax_params, exported on a deterministic topk query in both
    packages; the port worker's /predict equals the JAX worker's."""
    from graph_learn_tpu.gsl.compile import _execute as jax_execute
    from graph_learn_tpu.nn import data as jdata
    from graph_learn_tpu.nn.models.ego_gnn import \
        EgoGraphSAGE as JaxEgoGraphSAGE
    from graph_learn_tpu.online.export import export_serving_fn as jexport
    from graph_learn_tpu.online.http import ServingServer as JaxServer
    from graph_learn_tpu_torch.nn import data as tdata
    from graph_learn_tpu_torch.nn.convert import load_flax_params
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    jg, tg = _jax_graph(tmp_graph_dir), _mk_graph(tmp_graph_dir)
    jq, tq = _two_hop_topk(jg), _two_hop_topk(tg)
    jtables, ttables = jq.device_tables(), tq.device_tables("cpu")
    jmodel = JaxEgoGraphSAGE([4, 16, 3], jg.get_node_decoder("item"),
                             agg_type="gcn")

    def jserve(seeds, key):
        ego = jdata.EgoGraph.from_query_result(
            jax_execute(jq, jtables, seeds, key), "src", ["hop1", "hop2"])
        return jmodel.apply(params, ego)

    seeds = jnp.arange(4, dtype=jnp.int32)
    params = jmodel.init(jax.random.key(0), jdata.EgoGraph.from_query_result(
        jax_execute(jq, jtables, seeds, jax.random.key(0)), "src",
        ["hop1", "hop2"]))
    tmodel = load_flax_params(
        EgoGraphSAGE([4, 16, 3], tg.get_node_decoder("item"), agg_type="gcn",
                     device="cpu"),
        jax.tree_util.tree_map(np.asarray, params)).eval()
    table = ttables["nodes"]["item"].float_attrs

    def tserve(s, generator):
        ego = tdata.EgoGraph.from_query_result(
            _execute(tq, ttables, s, generator), "src", ["hop1", "hop2"],
            defer_last_table=table)
        return tmodel(ego)

    jblob = jexport(jserve, (seeds, jax.random.key(0)))
    tpath = str(tmp_path / "sage.pt2")
    export_serving_fn(tserve, (np.arange(4), 0), path=tpath, device="cpu")
    jsrv = JaxServer(jg).start()
    tsrv = ServingServer(tg, device="cpu").start()
    try:
        jc, tc = ServingClient(_url(jsrv)), ServingClient(_url(tsrv))
        assert jc.install_model("sage", bytes(jblob)) == \
            tc.install_model("sage", tpath) == {"name": "sage", "batch": 4}
        for ids in ([0, 10, 20, 39], [7], [0, 30, 0]):  # dense indices
            want = np.asarray(jc.predict("sage", ids))
            got = np.asarray(tc.predict("sage", ids, seed=7))
            assert got.shape == want.shape == (len(ids), 3)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            assert tc.predict("sage", ids, seed=7) == \
                tc.predict("sage", ids, seed=7)
        # the JAX artifact is refused by the port worker
        with pytest.raises(urllib.error.HTTPError) as err:
            tc.install_model("jax", bytes(jblob))
        assert "torch.export" in err.value.read().decode()
    finally:
        jsrv.stop()
        tsrv.stop()


# --- the router (tests/test_router.py) ------------------------------------

@pytest.fixture
def fleet(tmp_graph_dir):
    """3 workers over replicas of the same graph, and a router."""
    servers = [ServingServer(_mk_graph(tmp_graph_dir), device="cpu").start()
               for _ in range(3)]
    router = ServingRouter([_url(s) for s in servers])
    yield servers, router
    for s in servers:
        s.stop()


def _assert_tree_equal(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], path + "/" + str(k))
    else:
        assert a == b, path


def test_router_stitch_matches_single_worker(fleet):
    servers, router = fleet
    q = (servers[0].graph.V("item").batch(4).alias("src")
         .outE("rel").sample(3).by("topk").alias("e1").values())
    qid = router.install(q)
    ids = [0, 10, 20, 30, 40, 50, 130, 260]
    assert {int(v) % 3 for v in ids} == {0, 1, 2}
    single = ServingClient(_url(servers[0])).run(router._qids[qid][0], ids)
    routed = router.run(qid, ids)
    assert set(routed) == {"src", "e1"}
    _assert_tree_equal(routed, single)
    assert len(routed["e1"]["src_nodes"]["ids"]) == len(ids)


def test_router_empty_ids(fleet):
    servers, router = fleet
    q = (servers[0].graph.V("item").batch(4).alias("src")
         .outV("rel").sample(2).by("topk").alias("h1").values())
    qid = router.install(q)
    assert router.run(qid, np.array([], np.int64)) == {}
    with pytest.raises(glt.NotFoundError):
        router.run(qid + 1, [0])


def test_router_single_owner_batch(fleet):
    servers, router = fleet
    q = (servers[0].graph.V("item").batch(4).alias("src")
         .outV("rel").sample(2).by("topk").alias("h1").values())
    qid = router.install(q)
    out = router.run(qid, [0, 30, 90, 120])  # all on worker 0
    assert len(out["src"]["ids"]) == 4 and len(out["h1"]["ids"]) == 4


def test_router_stats_aggregate(fleet):
    servers, router = fleet
    q = (servers[0].graph.V("item").batch(4).alias("src")
         .outV("rel").sample(2).by("topk").alias("h1").values())
    qid = router.install(q)
    router.run(qid, [0, 10, 20])
    st = router.stats(qid)
    assert st["workers"] >= 1 and st["qps"] > 0


def test_rate_limiter_decays_then_recovers():
    rl = RateLimiter(target_p99_ms=20.0, max_updates_per_s=64.0,
                     min_updates_per_s=1.0, adjust_interval_s=0.02)
    for _ in range(64):
        rl.observe_latency(100.0)
    r0 = rl.rate
    for _ in range(50):
        rl.admit()
    assert rl.rate == r0  # within one interval the rate does not move
    for _ in range(4):
        time.sleep(0.025)
        rl.admit()
    assert rl.rate <= r0 / 8
    decayed = rl.rate
    rl._lat.clear()
    for _ in range(64):
        rl.observe_latency(1.0)
    for _ in range(4):
        time.sleep(0.025)
        rl.admit()
    assert decayed < rl.rate <= rl.max_rate


class _FakeWorker:
    """ServingClient-shaped stub with a set run latency."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.updates = []

    def install(self, plan, micro_batch=256):
        return 0

    def run(self, qid, ids):
        time.sleep(self.delay)
        ids = list(np.asarray(ids).tolist())
        return {"src": {"ids": ids,
                        "src_nodes": {"ids": [i * 2 for i in ids]}}}

    def update(self, nodes=None, edges=None):
        self.updates.append((nodes, edges))

    def refresh(self):
        pass

    def stats(self, qid):
        return {"p99_ms": 1.0, "qps": 10.0}


def test_barrier_drains_inflight_queries():
    router = ServingRouter([_FakeWorker(delay=0.3), _FakeWorker(delay=0.3)])
    qid = router.install(None)
    t_run_done = []

    def slow_query():
        router.run(qid, [0, 1])
        t_run_done.append(time.monotonic())

    th = threading.Thread(target=slow_query)
    th.start()
    time.sleep(0.05)
    with router.barrier():
        assert t_run_done, "barrier returned before in-flight run drained"
        assert time.monotonic() >= t_run_done[0]
    th.join(timeout=30)
    assert not th.is_alive()


def test_barrier_blocks_new_updates():
    workers = [_FakeWorker()]
    router = ServingRouter(workers)
    with router.barrier():
        out = router.update(edges={"rel": {"src_ids": [1], "dst_ids": [2]}},
                            wait=False)
        assert out == {"applied": False, "reason": "barrier"}
        assert workers[0].updates == []
    out = router.update(edges={"rel": {"src_ids": [1], "dst_ids": [2]}},
                        wait=False)
    assert out["applied"] is True and len(workers[0].updates) == 1
    with pytest.raises(glt.InvalidArgumentError):
        ServingRouter([])


def test_checkpoint_offsets_then_replay_restore(tmp_graph_dir, tmp_path):
    g = _mk_graph(tmp_graph_dir)
    srv = ServingServer(g, device="cpu").start()
    try:
        router = ServingRouter([_url(srv)])
        q = (g.V("item").batch(2).alias("src")
             .outV("rel").sample(3).by("topk").alias("h1").values())
        qid = router.install(q)
        log = UpdateLog(str(tmp_path / "updates.jsonl"))

        def routed_update(**edges_kw):
            log.append_edges("rel", **edges_kw)
            router.update(edges={"rel": {k: list(v) for k, v in
                                         edges_kw.items()}})
            router.refresh()

        routed_update(src_ids=[0, 0], dst_ids=[390, 380], weights=[9., 8.])
        mark = router.checkpoint([log])
        assert mark["log_offsets"] == [1]
        oracle = router.run(qid, [0])["h1"]["ids"]
        routed_update(src_ids=[0], dst_ids=[370], weights=[99.0])
        assert router.run(qid, [0])["h1"]["ids"] != oracle
        g2 = _mk_graph(tmp_graph_dir)
        buf = UpdateBuffer()
        assert log.replay(buf, upto=mark["log_offsets"][0]) == 1
        apply_updates(g2, buf)
        srv2 = ServingServer(g2, device="cpu").start()
        try:
            router2 = ServingRouter([_url(srv2)])
            assert router2.run(router2.install(q), [0])["h1"]["ids"] == oracle
        finally:
            srv2.stop()
    finally:
        srv.stop()


# --- serve_main (tests/test_serve_main.py) ---------------------------------

@pytest.fixture
def cfg(tmp_graph_dir, tmp_path):
    FileTopic(str(tmp_path / "topic"), num_partitions=2)
    return {
        "host": "127.0.0.1", "port": 0, "device": "cpu",
        "nodes": [{"source": tmp_graph_dir["node"], "type": "item",
                   "decoder": {"weighted": True, "labeled": True,
                               "attr_types": ["float"] * 4}}],
        "edges": [{"source": tmp_graph_dir["edge"],
                   "type": ["item", "item", "rel"],
                   "decoder": {"weighted": True}}],
        "update_topic": {"root": str(tmp_path / "topic"),
                         "poll_interval_s": 0.2},
    }


def test_graph_from_config(cfg, tmp_path):
    g = graph_from_config(cfg)
    assert g.device == torch.device("cpu")
    stats = g.get_stats()
    assert stats["nodes"]["item"] == 40 and stats["edges"]["rel"] > 0
    # a snapshot restores the same store without the TSV sources
    g.save(str(tmp_path / "snap"))
    g2 = graph_from_config({"snapshot": str(tmp_path / "snap"),
                            "device": "cpu"})
    assert g2.get_stats() == stats
    with pytest.raises(glt.InvalidArgumentError, match="edge type"):
        graph_from_config(dict(cfg, edges=[dict(cfg["edges"][0],
                                                type="rel")]))


def test_graph_from_config_bucketed_attr_tuples():
    d = _decoder({"attr_types": ["float", ["int", 100]],
                  "attr_dims": [None, 8]})
    assert d.int_attrs and d.int_attrs[0].bucket_size == 100


def test_serve_end_to_end_with_update_pump(cfg, tmp_path):
    server, stop = serve(cfg, block=False)
    try:
        base = _url(server)
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
        client = ServingClient(base)
        g = server.graph
        q = (g.V("item").batch(4).alias("src")
             .outV("rel").sample(3).by("topk").alias("h1").values())
        qid = client.install(query_to_plan(q), micro_batch=4)
        out = client.run(qid, [0, 10, 20, 30])
        assert np.asarray(out["h1"]["ids"]).shape == (4, 3)
        StreamProducer(FileTopic(str(tmp_path / "topic"), create=False)) \
            .put_edges("rel", [0, 0, 0], [390, 380, 370],
                       weights=[9.0, 8.0, 7.0])
        deadline = time.time() + 10
        while time.time() < deadline:
            top = set(client.run(qid, [0])["h1"]["ids"][0])
            if top == {39, 38, 37}:
                break
            time.sleep(0.1)
        # the pump applied the update and refreshed the served snapshot
        assert int(server.graph.out_degrees(np.array([0]), "rel")[0]) == 4
        assert top == {39, 38, 37}
    finally:
        stop()


def test_serve_main_models_config(cfg, tmp_path):
    g0 = graph_from_config(cfg)
    q = (g0.V("item").batch(2).alias("src")
         .outV("rel").sample(2).by("topk").alias("h1").values())
    tables = q.device_tables("cpu")

    def serve_fn(seeds, generator):
        out = _execute(q, tables, seeds, generator)
        return out["h1"].float_attrs.materialize().mean(dim=1)

    path = str(tmp_path / "m.pt2")
    export_serving_fn(serve_fn, (np.arange(2), 0), path=path, device="cpu")
    cfg2 = dict(cfg, models=[{"name": "m", "artifact": path}])
    cfg2.pop("update_topic")
    server, stop = serve(cfg2, block=False)
    try:
        req = urllib.request.Request(
            _url(server) + "/predict",
            data=json.dumps({"model": "m", "ids": [1]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())["outputs"]
        assert np.asarray(out).shape == (1, 4)
    finally:
        stop()


def test_serve_main_refuses_graph_shards(cfg, tmp_graph_dir, tmp_path):
    """``graph_shards`` is ported (the name is the refusal's this test once
    pinned): serve() with "graph_shards": 2 and "backend": "gloo" is rank
    0 and starts rank 1 itself; /serving answers the JAX worker's JSON, a
    streamed update reaches the followers' blocks through the pump's
    refresh, and stopping rank 0 ends rank 1."""
    from graph_learn_tpu.online.http import ServingServer as JaxServer
    server, stop = serve(dict(cfg, graph_shards=2, backend="gloo"),
                         block=False)
    procs = list(server.ranks.procs)
    jsrv = JaxServer(_jax_graph(tmp_graph_dir)).start()
    try:
        assert [p.is_alive() for p in procs] == [True]
        plan = query_to_plan(_two_hop_topk(server.graph))
        ids = [0, 10, 20, 390, 70]
        answers = []
        for srv in (jsrv, server):
            c = ServingClient(_url(srv))
            answers.append(c._post("/serving", {
                "qid": c.install(plan, micro_batch=4), "ids": ids}))
        assert json.dumps(answers[0], sort_keys=True) == \
            json.dumps(answers[1], sort_keys=True)
        client = ServingClient(_url(server))
        qid = client.install(query_to_plan(
            server.graph.V("item").batch(4).alias("src")
            .outV("rel").sample(3).by("topk").alias("h1").values()),
            micro_batch=4)
        StreamProducer(FileTopic(str(tmp_path / "topic"), create=False)) \
            .put_edges("rel", [0, 0, 0], [390, 380, 370],
                       weights=[9.0, 8.0, 7.0])
        deadline = time.time() + 30
        while time.time() < deadline:
            top = set(client.run(qid, [0])["h1"]["ids"][0])
            if top == {39, 38, 37}:
                break
            time.sleep(0.1)
        assert top == {39, 38, 37}
    finally:
        jsrv.stop()
        stop()
    assert [p.is_alive() for p in procs] == [False]
    assert [p.exitcode for p in procs] == [0]


# --- worker processes (tests/test_multiprocess_serving.py) -----------------

N_WORKERS = 3


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _wait_healthy(url, deadline):
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                if r.status == 200:
                    return True
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.3)
    return False


@pytest.fixture
def process_fleet(cfg, tmp_path):
    """3 ``serve_main`` worker processes on the CPU (``--device cpu``)."""
    cfg = dict(cfg, device="cuda")  # the command line asks for the CPU
    cfg.pop("update_topic")
    cfg_path = str(tmp_path / "serve.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    ports = _free_ports(N_WORKERS)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "graph_learn_tpu_torch.online.serve_main",
         "--config", cfg_path, "--port", str(p), "--device", "cpu"],
        env=env, cwd=_REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for p in ports]
    urls = ["http://127.0.0.1:%d" % p for p in ports]
    try:
        deadline = time.time() + 240
        for u, pr in zip(urls, procs):
            if not _wait_healthy(u, deadline):
                pr.kill()
                raise RuntimeError("worker %s not healthy; rc=%r stderr:\n%s"
                                   % (u, pr.poll(), pr.stderr.read()[-2000:]))
        yield cfg, urls
    finally:
        for pr in procs:
            pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait(timeout=30)


def _local_query(cfg):
    g = graph_from_config(dict(cfg, device="cpu"))
    return g, (g.V("item").batch(4).alias("src")
               .outV("rel").sample(3).by("topk").alias("h1").values())


def test_router_over_worker_processes(process_fleet):
    cfg, urls = process_fleet
    _, q = _local_query(cfg)
    router = ServingRouter(urls)
    qid = router.install(q, micro_batch=4)
    ids = [0, 10, 20, 30, 50, 110, 170, 230]
    assert {int(v) % N_WORKERS for v in ids} == set(range(N_WORKERS))
    out = router.run(qid, ids)
    oracle = ServingClient(urls[0])
    want = oracle.run(oracle.install(q, micro_batch=4), ids)
    _assert_tree_equal(out, want)
    st = router.stats(qid)
    assert st["workers"] == N_WORKERS and st["qps"] > 0


def test_update_fans_out_to_every_replica(process_fleet):
    cfg, urls = process_fleet
    g, q = _local_query(cfg)
    router = ServingRouter(urls)
    qid = router.install(q, micro_batch=4)
    base = router.run(qid, [0])
    router.update(edges={"rel": {"src_ids": [0], "dst_ids": [230],
                                 "weights": [99.0]}})
    router.refresh()
    want = int(g.store.node_table("item").index.lookup(np.array([230]))[0])
    out = router.run(qid, [0])
    assert out["h1"]["ids"][0][0] == want and out != base
    for u in urls:
        c = ServingClient(u)
        w_out = c.run(c.install(q, micro_batch=4), [0])
        assert w_out["h1"]["ids"][0][0] == want, u


def test_checkpoint_barrier_quiesces_fleet(process_fleet):
    _, urls = process_fleet
    router = ServingRouter(urls)
    mark = router.checkpoint(logs=[None] * N_WORKERS)
    assert mark["log_offsets"] == [0] * N_WORKERS
    r = router.update(edges={"rel": {"src_ids": [10], "dst_ids": [20],
                                     "weights": [1.0]}})
    assert r["applied"]


def test_a_worker_process_without_a_card_refuses_cuda(cfg, tmp_path):
    cfg = dict(cfg, device="cuda")
    cfg.pop("update_topic")
    cfg_path = str(tmp_path / "serve.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "graph_learn_tpu_torch.online.serve_main",
         "--config", cfg_path, "--port", "0"], env=env, cwd=_REPO,
        capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "DeviceUnavailableError" in out.stderr


def test_the_serving_demo_runs_on_the_cpu(capsys):
    """graph_learn_tpu_torch/examples/serving_demo.py, the flow
    deploy/k8s/serving.yaml runs: the streamed update reaches the store
    through the update pump and the worker serves after it."""
    from graph_learn_tpu_torch.examples import serving_demo
    out = serving_demo.run(device="cpu")
    assert out == {"deg0": 4, "h1_shape": (1, 4)}
    text = capsys.readouterr().out
    assert "healthz: {'ok': True" in text and "done" in text
