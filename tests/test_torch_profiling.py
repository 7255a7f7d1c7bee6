"""The port's tracer (``utils/profiling.py``): off it records nothing and
enters no profiler range; on it records nesting, parents, self time, the
ring's last records, counters and the snapshot; its spans are ranges of a
``torch.profiler`` trace; and the spans and counters of the store build,
the plan and the step loop where the program puts them.

The test marked ``chip`` needs a CUDA card; on the card run it with
``python3 -m pytest --noconftest tests/test_torch_profiling.py -m chip``
(this folder's ``conftest.py`` loads JAX, which that machine lacks)."""

import collections
import contextlib
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.examples.scale_demo import nbytes, two_hop_query
from graph_learn_tpu_torch.graph import Graph, synthetic_graph
from graph_learn_tpu_torch.gsl.compile import _execute
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.utils import profiling

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def tracer():
    """Tracing on, from a clean state; off and clean again after."""
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def _no_range(name):
    raise AssertionError("record_function(%r) entered" % name)


def case_off(tr, monkeypatch, capsys, tmp_path):
    tr.disable()
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    a, b = tr.span("plan"), tr.span("model.forward", call=3)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            torch.ones(3).sum()
    tr.count("plan.sampled_ids", 7)
    snap = tr.snapshot()
    assert (snap["spans"], snap["records"], snap["counters"]) == ({}, [], {})
    assert not tr.enabled()


def case_nesting(tr, monkeypatch, capsys, tmp_path):
    with tr.span("step.eager", call=1):
        with tr.span("plan"):
            with tr.span("plan.hop1.sample"):
                time.sleep(0.002)
            time.sleep(0.002)
        with tr.span("plan"):
            pass
    with tr.span("plan"):  # outside any call
        pass
    snap = tr.snapshot()
    recs = snap["records"]
    assert [r["name"] for r in recs] == [
        "plan.hop1.sample", "plan", "plan", "step.eager", "plan"]
    assert [r["parent"] for r in recs] == [
        "plan", "step.eager", "step.eager", None, None]
    assert [r["call"] for r in recs] == [1, 1, 1, 1, None]
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    assert {r["thread"] for r in recs} == {threading.get_ident()}
    spans = snap["spans"]
    assert spans["plan"]["calls"] == 3
    dur = {id(r): (r["end_ns"] - r["start_ns"]) * 1e-9 for r in recs}
    step = recs[3]
    assert spans["step.eager"]["total_s"] == pytest.approx(dur[id(step)])
    # self time: the total less what the child spans cover
    children = sum(dur[id(r)] for r in recs[1:3])
    assert spans["step.eager"]["self_s"] == pytest.approx(
        dur[id(step)] - children)
    assert spans["plan"]["self_s"] == pytest.approx(
        spans["plan"]["total_s"] - spans["plan.hop1.sample"]["total_s"])
    assert spans["plan.hop1.sample"]["self_s"] == pytest.approx(
        spans["plan.hop1.sample"]["total_s"])
    assert spans["plan.hop1.sample"]["total_s"] >= 0.002


def case_ring(tr, monkeypatch, capsys, tmp_path):
    assert tr.RING == 65536 and profiling._ring.maxlen == tr.RING
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=4))
    for i in range(10):
        with tr.span("s%d" % i):
            pass
    snap = tr.snapshot()
    assert [r["name"] for r in snap["records"]] == ["s6", "s7", "s8", "s9"]
    assert len(snap["spans"]) == 10  # the aggregates keep every name


def case_counters(tr, monkeypatch, capsys, tmp_path):
    tr.count("plan.sampled_ids", 40)
    tr.count("plan.sampled_ids", 2)
    tr.count("step.graph_nodes")
    tr.disable()
    tr.count("step.graph_nodes", 100)  # off: not added
    assert tr.snapshot()["counters"] == {"plan.sampled_ids": 42,
                                         "step.graph_nodes": 1}


def case_reset(tr, monkeypatch, capsys, tmp_path):
    with tr.span("plan"):
        tr.count("plan.sampled_ids", 3)
    tr.reset()
    snap = tr.snapshot()
    assert (snap["spans"], snap["records"], snap["counters"]) == ({}, [], {})
    assert tr.enabled()  # reset forgets, it does not switch off


def case_snapshot(tr, monkeypatch, capsys, tmp_path):
    from graph_learn_tpu_torch.ops.kernels import gather, spmm
    gather.LAUNCHES.reset()
    gather.LAUNCHES.add()
    with tr.span("aggregate"):
        tr.count("store.upload_bytes", 64)
    snap = tr.snapshot()
    assert sorted(snap) == ["counters", "launches", "records", "spans"]
    assert snap["launches"]["gather_rows"] == 1
    assert snap["launches"]["segment_spmm"] == spmm.LAUNCHES.count
    assert sorted(snap["records"][0]) == ["call", "end_ns", "name", "parent",
                                          "start_ns", "thread"]
    assert sorted(snap["spans"]["aggregate"]) == ["calls", "self_s",
                                                  "total_s"]
    json.dumps(snap)  # plain data
    gather.LAUNCHES.reset()


def case_threads(tr, monkeypatch, capsys, tmp_path):
    def work():
        for _ in range(50):
            with tr.span("serve"):
                with tr.span("plan"):
                    tr.count("plan.sampled_ids")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = tr.snapshot()
    assert snap["spans"]["plan"]["calls"] == snap["spans"]["serve"][
        "calls"] == 200
    assert snap["counters"]["plan.sampled_ids"] == 200
    assert all(r["parent"] == ("serve" if r["name"] == "plan" else None)
               for r in snap["records"])
    assert len({r["thread"] for r in snap["records"]}) >= 2


def case_accumulates_and_dumps(tr, monkeypatch, capsys, tmp_path):
    for _ in range(3):
        with tr.span("lookup"):
            pass
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("inside")
    tr.count("store.upload_bytes", 12)
    tr.dump()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[profiling] boom: total ")
    assert "count 1" in out[0] and ", self " in out[0]
    assert out[1].startswith("[profiling] lookup: total ") and \
        "count 3" in out[1]
    assert out[2] == "[profiling] store.upload_bytes: 12"
    # a span that raised is closed: the next one has no parent
    with tr.span("after"):
        pass
    assert tr.snapshot()["records"][-1]["parent"] is None


def case_device_trace_writes_a_chrome_trace(tr, monkeypatch, capsys,
                                            tmp_path):
    with tr.device_trace(str(tmp_path)) as prof:
        with tr.span("scoped"):
            torch.ones(8).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert "glt.scoped" in names
    assert (tmp_path / "trace.json").stat().st_size > 0


CASES = {k[len("case_"):]: v for k, v in list(globals().items())
         if k.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracer(case, tracer, monkeypatch, capsys, tmp_path):
    CASES[case](tracer, monkeypatch, capsys, tmp_path)


def test_a_span_is_a_range_of_the_profilers_trace(tracer, tmp_path):
    """One clock: the span's range holds the operators run inside it, in
    the same Chrome trace, and does not collide with the ``glt::``
    operator ranges."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("plan.hop1.sample"):
            torch.mm(x, x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (rng,) = [e for e in events if e["name"] == "glt.plan.hop1.sample"]
    assert rng["cat"] == "user_annotation"
    mm = [e for e in events if e["name"] == "aten::mm"]
    assert mm and all(rng["ts"] <= e["ts"] and e["ts"] + e["dur"]
                      <= rng["ts"] + rng["dur"] for e in mm)
    assert not any(e["name"].startswith("glt::") for e in events)
    (rec,) = tracer.snapshot()["records"]
    assert rec["name"] == "plan.hop1.sample"


def _two_table_graph():
    """50 items, a weighted edge type and an unweighted one, on the CPU."""
    rng = np.random.default_rng(3)
    n = 50
    g = Graph(device="cpu")
    dec = Decoder(labeled=True, attr_types=["float"] * 4)
    g.add_node_table(NodeTable(
        "item", dec, np.arange(n, dtype=np.int64),
        float_attrs=rng.standard_normal((n, 4)).astype(np.float32),
        labels=rng.integers(0, 3, n)))
    for name, weighted in (("rel", True), ("rel2", False)):
        e = 200
        g.add_edge_table(EdgeTable(
            name, "item", "item", Decoder(weighted=weighted),
            src=rng.integers(0, n, e), dst=rng.integers(0, n, e),
            num_src_nodes=n, num_dst_nodes=n,
            weights=rng.random(e).astype(np.float32) if weighted else None))
    return g


@pytest.mark.parametrize("profile", ["minimal", "full"])
def test_store_build_spans(tracer, profile):
    with bench.bench_conf(storage_profile=profile):
        g = _two_table_graph()
        q = (g.V("item").batch(8).alias("src")
             .outV("rel").sample(2).by("random").alias("hop1")
             .outV("rel2").sample(2).by("random").alias("hop2").values())
        tables = q.device_tables("cpu")
    snap = tracer.snapshot()
    spans = {k: v["calls"] for k, v in snap["spans"].items()}
    directions = 1 if profile == "minimal" else 2
    want = {"store.ingest_nodes": 1, "store.ingest_edges": 2,
            "store.device_tables": 1, "store.upload": 3,
            "store.csr": 2 * directions, "store.csr.sort": 2 * directions}
    if profile == "full":
        want.update({"store.csr.sort_ids": 4, "store.csr.cdf": 4,
                     "store.pools": 2})
    assert spans == want
    parents = {r["name"]: r["parent"] for r in snap["records"]}
    assert parents["store.csr.sort"] == "store.csr"
    assert parents["store.csr"] == parents["store.upload"] == \
        "store.device_tables"
    assert parents["store.device_tables"] is None
    if profile == "full":
        assert parents["store.pools"] == "store.device_tables"
        assert parents["store.csr.cdf"] == "store.csr"
    # every array of the views is a copy, but the CSR's orders and what
    # they permute, which each view builds from its copied edge arrays
    built = sum(nbytes(getattr(c, f))
                for t in tables["edges"].values() for c in (t.out, t.inc)
                if c is not None
                for f in ("nbr_ids", "nbr_edge_ids", "nbr_ids_sorted",
                          "nbr_edge_ids_sorted", "nbr_ts"))
    assert built > 0
    assert snap["counters"]["store.upload_bytes"] == (
        nbytes(tables["nodes"]) + nbytes(tables["edges"]) - built)
    # built once: a second call uploads nothing more
    q.device_tables("cpu")
    again = tracer.snapshot()
    assert again["spans"]["store.device_tables"]["calls"] == 2
    assert again["spans"]["store.csr"]["calls"] == spans["store.csr"]
    assert again["counters"] == snap["counters"]


@pytest.fixture(scope="module")
def small_graph():
    return synthetic_graph(2000, 8, 16, 5, device="cpu")


def test_plan_spans_once_per_execute(small_graph, tracer):
    g, _ = small_graph
    b, (k1, k2) = 32, (5, 3)
    q = two_hop_query(g, b, (k1, k2))
    tables = q.device_tables("cpu")
    seeds = torch.arange(b, dtype=torch.int32)
    tracer.disable()
    want = _execute(q, tables, seeds, torch.Generator().manual_seed(5))
    tracer.enable()
    tracer.reset()
    got = None
    for _ in range(2):
        got = _execute(q, tables, seeds, torch.Generator().manual_seed(5))
    for alias in ("src", "hop1", "hop2"):  # tracing changes no answer
        assert torch.equal(got[alias].ids, want[alias].ids)
    snap = tracer.snapshot()
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {
        "plan": 2, "plan.src.lookup": 2, "plan.hop1.sample": 2,
        "plan.hop1.lookup": 2, "plan.hop2.sample": 2, "plan.hop2.lookup": 2}
    assert {r["parent"] for r in snap["records"]
            if r["name"] != "plan"} == {"plan"}
    assert snap["counters"] == {"plan.sampled_ids": 2 * (b * k1
                                                         + b * k1 * k2)}
    # a node without an alias is named by its dag id
    q2 = (g.V("item").batch(8).alias("src").outV("rel").sample(2)
          .by("random").outV("rel").sample(2).by("random").alias("hop2")
          .values())
    tracer.reset()
    _execute(q2, q2.device_tables("cpu"), seeds[:8],
             torch.Generator().manual_seed(1))
    names = set(tracer.snapshot()["spans"])
    assert any(re.fullmatch(r"plan\.n\d+\.sample", n) for n in names)


def _small_step(small_graph, K=2, capture=False):
    g, dec = small_graph
    q = two_hop_query(g, 16, (3, 2))
    tables = q.device_tables("cpu")
    model = EgoGraphSAGE([16, 8, 5], dec, agg_type="gcn", device="cpu")
    opt = bench.make_optimizer(model, torch.device("cpu"))
    gen = torch.Generator().manual_seed(7)
    return bench.MultiStep(q, tables, model, opt,
                           {"scan_steps": K, "n_nodes": 2000}, 1, gen,
                           capture)


def test_a_steps_spans_share_its_call(small_graph, tracer):
    step = _small_step(small_graph)
    tracer.reset()
    step()
    step()
    recs = tracer.snapshot()["records"]
    calls = [r for r in recs if r["name"] == "step.eager"]
    assert [r["call"] for r in calls] == [1, 2]
    per_call = collections.Counter((r["name"], r["call"]) for r in recs)
    for name in ("plan.seeds", "plan", "plan.hop1.sample", "aggregate",
                 "model.forward", "model.loss", "model.backward",
                 "model.optimizer"):
        assert per_call[(name, 1)] == per_call[(name, 2)] == step.K, name
    for r in recs:  # every span inside its call's step.eager
        outer = calls[r["call"] - 1]
        assert outer["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= outer["end_ns"]


class _FakeGraph:
    """A ``torch.cuda.CUDAGraph`` stand-in that records how it was made."""

    made = []

    def __init__(self, keep_graph=False):
        self.keep_graph, self.instantiated, self.replays = keep_graph, 0, 0
        _FakeGraph.made.append(self)

    def register_generator_state(self, gen):
        pass

    def instantiate(self):
        self.instantiated += 1

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("tracing", [False, True])
def test_the_capture_counts_nodes_only_while_tracing(small_graph, tracer,
                                                     monkeypatch, tracing):
    """Off, the capture is today's: no ``keep_graph``, no node walk, no
    explicit instantiate, no record.  On, the graph is kept, its nodes
    counted by kind, and instantiated at once."""
    nodes_calls = []

    def fake_nodes(graph):
        nodes_calls.append(graph)
        return {"kernel": 5, "memcpy": 2, "memset": 1, "empty": 1}

    cuda = torch.cuda
    _FakeGraph.made = []
    for name, value in {
            "CUDAGraph": _FakeGraph,
            "graph": lambda g, **kw: contextlib.nullcontext(),
            "Stream": lambda dev=None: _FakeStream(),
            "current_stream": lambda dev=None: _FakeStream(),
            "stream": lambda s: contextlib.nullcontext(),
            "synchronize": lambda dev=None: None,
            "empty_cache": lambda: None,
            "memory_reserved": lambda dev=None: 0}.items():
        monkeypatch.setattr(cuda, name, value)
    monkeypatch.setattr(profiling, "graph_nodes", fake_nodes)
    step = _small_step(small_graph)
    step.capture = True  # the capture path on the CPU, through the fakes
    if not tracing:
        tracer.disable()
        monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    tracer.reset()
    step()
    step()
    (graph,) = _FakeGraph.made
    assert graph.replays == 1
    snap = tracer.snapshot()
    if not tracing:
        assert graph.keep_graph is False and graph.instantiated == 0
        assert nodes_calls == []
        assert (snap["spans"], snap["records"], snap["counters"]) == (
            {}, [], {})
        return
    assert graph.keep_graph is True and graph.instantiated == 1
    assert nodes_calls == [graph]
    assert snap["counters"]["step.graph_nodes"] == 9
    assert (snap["counters"]["step.graph_kernels"],
            snap["counters"]["step.graph_memcpys"],
            snap["counters"]["step.graph_memsets"]) == (5, 2, 1)
    top = [(r["name"], r["call"]) for r in snap["records"]
           if r["parent"] is None]
    assert top == [("step.capture", 1), ("step.replay", 2)]


@pytest.mark.chip
def test_the_captured_graphs_nodes_on_the_card(tmp_path):
    """The capture's ``step.graph_nodes`` equals ``graph_nodes`` of a
    ``keep_graph`` capture of the same body, and the device operations
    (kernels, copies, memsets) of a traced replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    g, dec = synthetic_graph(20_000, 8, 64, 8, device="cuda")
    q = two_hop_query(g, 256, (5, 3))
    tables = q.device_tables("cuda")
    model = EgoGraphSAGE([64, 32, 8], dec, agg_type="gcn", device="cuda")
    opt = bench.make_optimizer(model, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    step = bench.MultiStep(q, tables, model, opt,
                           {"scan_steps": 4, "n_nodes": 20_000}, 1, gen,
                           True)
    profiling.reset()
    profiling.enable()
    try:
        step()  # the eager call, then the capture
        step()
    finally:
        profiling.disable()
    counters = profiling.snapshot()["counters"]
    n = counters["step.graph_nodes"]
    assert n == (counters["step.graph_kernels"]
                 + counters["step.graph_memcpys"]
                 + counters["step.graph_memsets"]) > 0
    assert torch.isfinite(step.losses).all()

    again = torch.cuda.CUDAGraph(keep_graph=True)
    again.register_generator_state(gen)
    with torch.cuda.graph(again):
        step._body()
    assert sum(profiling.graph_nodes(again).values()) == n
    again.reset()

    replays, seen = 5, None
    # CUPTI records a copy node as a copy in one run and as a kernel in
    # another: the two kinds are compared together
    want = {"kernel or copy": replays * (counters["step.graph_kernels"]
                                         + counters["step.graph_memcpys"]),
            "memset": replays * counters["step.graph_memsets"]}
    for _ in range(5):  # a window may lose device records: profile again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("replays"):
                for _ in range(replays):
                    step()
                torch.cuda.synchronize()
            time.sleep(0.2)
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        xs = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
        (r,) = [e for e in xs if e["name"] == "replays"
                and e.get("cat") == "user_annotation"]
        launch = {e["args"]["correlation"]: e["name"] for e in xs
                  if e.get("cat", "").startswith("cuda_")
                  and "correlation" in e.get("args", {})}
        # the graph's operations are those its launch started; a replay
        # also resets the generators' state outside the graph
        seen, outside = collections.Counter(), collections.Counter()
        for e in xs:
            if (e.get("cat") in DEVICE_CATS
                    and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]):
                by = launch.get(e["args"].get("correlation"), "")
                if by.startswith("cudaGraphLaunch"):
                    seen["memset" if e["cat"] == "gpu_memset"
                         else "kernel or copy"] += 1
                else:
                    outside[(by, e["name"][:60])] += 1
        if seen == +collections.Counter(want):
            break
    assert seen == +collections.Counter(want), (seen, want, outside)
    profiling.reset()
