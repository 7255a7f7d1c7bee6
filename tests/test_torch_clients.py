"""The repository's clients, unchanged, against a port worker:
clients/py/gsl_client.py (the cases of tests/test_py_client.py:58-239)
and clients/cpp (tests/test_cpp_client.py, skipped without g++ as there),
each held to the port's own ServingClient on the same worker."""

import importlib.util
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.gsl.compile import _execute
from graph_learn_tpu_torch.gsl.plan import query_to_plan
from graph_learn_tpu_torch.online.export import export_serving_fn
from graph_learn_tpu_torch.online.http import ServingClient, ServingServer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_ROOT, "tests", "fixtures", "plan_2hop.json")
_CPP_DIR = os.path.join(_ROOT, "clients", "cpp")


@pytest.fixture(scope="module")
def client_mod():
    """clients/py/gsl_client.py imported by path, without either
    package."""
    spec = importlib.util.spec_from_file_location(
        "standalone_gsl_client_port",
        os.path.join(_ROOT, "clients", "py", "gsl_client.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def g(tmp_graph_dir):
    g = glt.Graph(device="cpu")
    g.node(tmp_graph_dir["node"], node_type="item",
           decoder=glt.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(tmp_graph_dir["edge"], edge_type=("item", "item", "rel"),
           decoder=glt.Decoder(weighted=True))
    return g.init()


@pytest.fixture
def worker(g):
    srv = ServingServer(g, device="cpu").start()
    yield srv
    srv.stop()


def _two_hop(g):
    return (g.V("item").batch(4).alias("src")
            .outV("rel").sample(3).by("topk").alias("h1")
            .outV("rel").sample(2).by("topk").alias("h2").values())


def test_plan_conformance(client_mod, g):
    """The standalone client's plan == the committed fixture == the port's
    query_to_plan."""
    cg = client_mod.Graph("127.0.0.1", 0)
    plan = (cg.V("item").batch(4).alias("src")
            .outV("rel").sample(3).by("topk").alias("h1")
            .outV("rel").sample(2).by("topk").alias("h2")).plan()
    with open(_FIXTURE) as f:
        fixture = json.load(f)
    assert json.loads(json.dumps(plan)) == query_to_plan(_two_hop(g)) \
        == fixture


def test_standalone_client_end_to_end(client_mod, g, worker):
    cg = client_mod.Graph(worker.host, worker.port)
    assert "item" in cg.schema()["nodes"]
    q = (cg.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("h1")
         .outV("rel").sample(2).by("topk").alias("h2"))
    qid = cg.install(q, micro_batch=16)
    ids = [0, 10, 20, 30, 40]
    out = cg.run(qid, ids)
    c = ServingClient("http://%s:%d" % (worker.host, worker.port))
    py = c.run(c.install(_two_hop(g), micro_batch=16), ids)
    for a in ("src", "h1", "h2"):
        assert out[a]["ids"] == py[a]["ids"]
    np.testing.assert_allclose(out["src"]["float_attrs"],
                               py["src"]["float_attrs"], rtol=1e-6)
    assert "qps" in cg.stats(qid)
    # a fused branching query answers as the unfused one
    bq = cg.V("item").batch(4).alias("s").each(
        lambda v: (v.outV("rel").sample(3).by("topk")
                   .outV("rel").sample(2).by("topk").alias("x")),
        lambda v: (v.outV("rel").sample(3).by("topk").alias("y")))
    rf = cg.run(cg.install(bq, micro_batch=16, fuse=True), ids)
    ru = cg.run(cg.install(bq, micro_batch=16, fuse=False), ids)
    assert rf["x"]["ids"] == ru["x"]["ids"]
    assert rf["y"]["ids"] == ru["y"]["ids"]
    assert cg.update(edges={"rel": {"src_ids": [0], "dst_ids": [390],
                                    "weights": [99.0]}})["ok"]
    cg.refresh()
    assert 39 in cg.run(qid, [0])["h1"]["ids"][0]


def test_standalone_client_predict(client_mod, g, worker):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("hop1").values())
    tables = q.device_tables("cpu")

    def serve(seeds, generator):
        out = _execute(q, tables, seeds, generator)
        return out["hop1"].float_attrs.materialize().mean(dim=1)

    blob = export_serving_fn(serve, (np.arange(4), 0), device="cpu")
    cg = client_mod.Graph(worker.host, worker.port)
    assert cg.install_model("emb", bytes(blob))["batch"] == 4
    got = np.asarray(cg.predict("emb", [2, 7]))
    want = serve(torch.tensor([2, 7, 2, 2], dtype=torch.int32),
                 None).numpy()[:2]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_standalone_client_where_conditional(client_mod, tmp_path):
    n = 24
    with open(tmp_path / "n", "w") as f:
        f.write("id:int64\tfeature:string\n")
        for i in range(n):
            f.write("%d\t%d\n" % (i, i % 2))
    with open(tmp_path / "e", "w") as f:
        f.write("src_id:int64\tdst_id:int64\n")
        for i in range(n):
            for j in range(n):
                if j != i and (j - i) % n > 6:
                    f.write("%d\t%d\n" % (i, j))
    gg = (glt.Graph(device="cpu")
          .node(str(tmp_path / "n"), "item",
                glt.Decoder(attr_types=["int"], attr_dims=[4]))
          .edge(str(tmp_path / "e"), ("item", "item", "rel"),
                glt.Decoder())).init()
    # each seed has exactly three non-neighbours of its own category
    # (i + 2, i + 4, i + 6), and the three unique negatives must be those:
    # 20 retries (the JAX test's) leave 63 uniform draws over 24 nodes a
    # row, which miss one of the three with probability about 0.19 a row,
    # so the JAX test passes on its key's draws; 200 retries make a miss
    # about 1e-11 a row on any generator's draws
    old = glt.conf.sampling_retry_times
    glt.conf.sampling_retry_times = 200
    srv = ServingServer(gg, device="cpu").start()
    try:
        cg = client_mod.Graph(srv.host, srv.port)
        q = (cg.V("item").batch(8).alias("src")
             .outNeg("rel").sample(3).by("random")
             .where("src", {"int_cols": [0], "int_props": [1.0],
                            "unique": True}).alias("neg"))
        out = cg.run(cg.install(q, micro_batch=8), list(range(8)))
        neg = np.asarray(out["neg"]["ids"])
        src = np.asarray(out["src"]["ids"])
        cats = np.arange(n) % 2
        et = gg.store.edge_table("rel")
        nbrs = {}
        for s, t in zip(et.src.tolist(), et.dst.tolist()):
            nbrs.setdefault(s, set()).add(t)
        for i in range(len(src)):
            assert (cats[neg[i]] == cats[src[i]]).all()
            assert len(set(neg[i].tolist())) == 3
            for v in neg[i]:
                assert v not in nbrs[src[i]] and v != src[i]
    finally:
        srv.stop()
        glt.conf.sampling_retry_times = old


# --- clients/cpp (tests/test_cpp_client.py) --------------------------------

@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = str(tmp_path_factory.mktemp("cppclient") / "gsl_client")
    subprocess.run(["g++", "-std=c++17", "-O2", "-o", out,
                    os.path.join(_CPP_DIR, "conformance_main.cc")],
                   check=True, capture_output=True, text=True)
    return out


def test_cpp_plan_conformance(client_bin, g):
    out = subprocess.run([client_bin, "plan"], check=True,
                         capture_output=True, text=True)
    with open(_FIXTURE) as f:
        assert json.loads(out.stdout) == query_to_plan(_two_hop(g)) \
            == json.load(f)


def test_cpp_client_end_to_end(client_bin, g, worker):
    ids = [0, 10, 20, 30, 40]
    out = subprocess.run(
        [client_bin, "drive", worker.host, str(worker.port), "item", "rel"]
        + [str(i) for i in ids],
        check=True, capture_output=True, text=True, timeout=120)
    cpp = json.loads(out.stdout)
    assert "installed qid=" in out.stderr and "qps" in out.stderr
    c = ServingClient("http://%s:%d" % (worker.host, worker.port))
    qid = c.install(_two_hop(g), micro_batch=16)
    py = c.run(qid, ids)
    for a in ("src", "h1", "h2"):
        assert cpp[a]["ids"] == py[a]["ids"]
    np.testing.assert_allclose(cpp["src"]["float_attrs"],
                               py["src"]["float_attrs"], rtol=1e-6)
    assert c.update(edges={"rel": {"src_ids": [0], "dst_ids": [390],
                                   "weights": [99.0]}})["ok"]
    c.refresh()
    assert 39 in c.run(qid, [0])["h1"]["ids"][0]
