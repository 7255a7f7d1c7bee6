"""Guards of the port: it imports nothing of JAX or of the JAX package, its
entry points never fall back to the CPU on their own, and chip_smoke.py
refuses to report without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.errors import (DeviceUnavailableError,
                                          InvalidArgumentError)
from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.examples import (bipartite_sage,
                                            ego_sage_supervised, node2vec,
                                            sage_unsupervised, scale_demo,
                                            seal, sweep_aggregate, tgn,
                                            ultra_gcn)
from graph_learn_tpu_torch.examples.data import (cora, ogbl_collab,
                                                 ogbn_products, synthetic)
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT, EgoGraphSAGE
from graph_learn_tpu_torch.nn.models.sub_models import GCN, LinkPredictor
from graph_learn_tpu_torch.nn import torch_bridge
from graph_learn_tpu_torch.nn.checkpoint import Checkpointer
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.ops import knn
from graph_learn_tpu_torch.ops.kernels import build
from graph_learn_tpu_torch.online import loader_main, serve_main
from graph_learn_tpu_torch.online.export import export_serving_fn
from graph_learn_tpu_torch.online.http import ServingServer
from graph_learn_tpu_torch.examples import routing_bytes
from graph_learn_tpu_torch.parallel import bootstrap, dryrun, launch
from graph_learn_tpu_torch.parallel.full_graph import ShardedGCN
from graph_learn_tpu_torch.parallel.mesh import make_mesh
from graph_learn_tpu_torch.parallel.train import DistTrainer
from torch_parity import numpy_graph, torch_graph, two_hop

REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "graph_learn_tpu")


def _port_sources():
    files = sorted((REPO / "graph_learn_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_of_the_port_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, (path, name)


def _root_module_names():
    """The names the repository's root modules and examples import by
    (``bench``, ``examples``, ``data``, ``common``, each example ...)."""
    ex = REPO / "examples"
    return ({p.stem for p in REPO.glob("*.py")} | {"examples"}
            | {p.stem for p in ex.glob("*.py")}
            | {p.name for p in ex.iterdir() if p.is_dir()}) - {"chip_smoke"}


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_of_the_port_imports_the_root_examples(path):
    """The port keeps its own copies (``examples/data/synthetic.py``,
    ``examples/common.py``, the bench): no import reaches the JAX side's
    root modules or examples."""
    root = _root_module_names()
    assert {"bench", "examples", "data", "common", "synthetic"} & root
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in root, (path, name)


def test_importing_every_module_of_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import graph_learn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "assert 'jax' not in sys.modules, bad\n"
        "assert not bad, bad\n"
        "print('imported', len([m for m in sys.modules\n"
        "                       if m.startswith(p.__name__)]))\n" % (BANNED,))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["graph", "graph_cuda0", "service", "model",
                                   "node_table", "edge_table", "gat_model",
                                   "trainer", "dataset", "scale_demo",
                                   "sweep_harness", "bench", "bench_main",
                                   "sub_stack", "link_predictor",
                                   "seal_model", "sage_link", "knn_index",
                                   "knn_build", "graph_load", "host_dataset",
                                   "host_trainer", "torch_dataset",
                                   "torch_loader", "checkpointer",
                                   "serve", "serve_main", "serving_server",
                                   "install_model", "export_serving_fn",
                                   "cora_load_graph", "node2vec_load",
                                   "node2vec_main", "sage_unsup_load",
                                   "sage_unsup_main", "tgn_load", "tgn_main",
                                   "u2i_load", "ultra_gcn_main",
                                   "bipartite_main", "collab_load",
                                   "seal_collab_main", "seal_main",
                                   "init_cluster", "spawn", "make_mesh",
                                   "dist_trainer", "sharded_gcn",
                                   "dryrun_multichip", "routing_bytes_main",
                                   "shard_index", "partitioned_service",
                                   "serve_graph_shards"])
def test_entry_points_raise_without_a_card(no_card, entry, monkeypatch,
                                           tmp_path):
    monkeypatch.delenv("GLT_PLATFORM", raising=False)
    a = numpy_graph(n=30, d=4)
    g, dec = torch_graph(a)  # device="cpu" works without a card
    calls = {
        "graph": lambda: glt.Graph(),
        "graph_cuda0": lambda: glt.Graph(device="cuda:0"),
        "service": lambda: glt.QueryService(g),
        "model": lambda: EgoGraphSAGE([4, 8, 2], dec),
        "node_table": lambda: g.store.node_table("item").device(),
        "edge_table": lambda: g.store.edge_table("rel").device(),
        "gat_model": lambda: EgoGAT([4, 8, 2], dec, num_heads=[2, 1]),
        "trainer": lambda: LocalTrainer(),
        "dataset": lambda: glt.Dataset(two_hop(g, 2, 2, batch=8)),
        "scale_demo": lambda: scale_demo.run(steps=1, **scale_demo.SMALL),
        "sweep_harness": lambda: sweep_aggregate.run(small=True, steps=1),
        "bench": lambda: bench.run_bench(bench.CFG_SMALL),
        "bench_main": bench.main,
        "sub_stack": lambda: GCN([4, 8]),
        "link_predictor": lambda: LinkPredictor(8),
        "seal_model": lambda: seal.seal_model(4, 8),
        "sage_link": lambda: sage_unsupervised.SageLink(dec, 4, 8, 8),
        "knn_index": lambda: knn.IVFFlatIndex(4),
        "knn_build": lambda: knn.build_index(a["feats"], a["raw_ids"],
                                             glt.KnnOption()),
        "graph_load": lambda: glt.Graph.load(str(snap)),
        "host_dataset": lambda: glt.Dataset(two_hop(g, 2, 2, batch=8),
                                            tier="host"),
        "host_trainer": lambda: LocalTrainer().train(
            two_hop(g, 2, 2, batch=8), None, None, None, tier="host"),
        "torch_dataset": lambda: torch_bridge.TorchDataset(
            two_hop(g, 2, 2, batch=8)),
        "torch_loader": lambda: torch_bridge.torch_loader(
            two_hop(g, 2, 2, batch=8)),
        "checkpointer": lambda: Checkpointer(str(tmp_path / "ck")),
        "serve": lambda: serve_main.serve(cfg, block=False),
        "serve_main": lambda: serve_main.main(["--config", str(cfg_path)]),
        "serving_server": lambda: ServingServer(g),
        "install_model": lambda: glt.QueryService(g).install_model(
            "m", b"PK\x03\x04"),
        "export_serving_fn": lambda: export_serving_fn(
            lambda seeds, generator: seeds, (np.arange(4), 0)),
        "cora_load_graph": lambda: ego_sage_supervised.load_graph(
            str(files), 8),
        "node2vec_load": lambda: node2vec.load(str(files), 8),
        "node2vec_main": lambda: node2vec.main(["--data_dir", str(files)]),
        "sage_unsup_load": lambda: sage_unsupervised.load(str(files), 8),
        "sage_unsup_main": lambda: sage_unsupervised.main(
            ["--data_dir", str(files)]),
        "tgn_load": lambda: tgn.load(str(tmp_path / "tgn")),
        "tgn_main": lambda: tgn.main(["--data_dir", str(tmp_path / "tgn")]),
        "u2i_load": lambda: bipartite_sage.load(str(tmp_path / "u2i")),
        "ultra_gcn_main": lambda: ultra_gcn.main(
            ["--data_dir", str(tmp_path / "u2i")]),
        "bipartite_main": lambda: bipartite_sage.main(
            ["--data_dir", str(tmp_path / "u2i")]),
        "collab_load": lambda: seal.load_collab(str(tmp_path / "collab")),
        "seal_collab_main": lambda: seal.main(
            ["--collab_dir", str(tmp_path / "collab")]),
        "seal_main": lambda: seal.main(["--data_dir", str(files)]),
        "init_cluster": lambda: bootstrap.init_cluster(
            "file://" + str(tmp_path / "store"), 1, 0),
        "spawn": lambda: launch.spawn(print, 2),
        "make_mesh": lambda: make_mesh(1, 1),
        "dist_trainer": lambda: DistTrainer(None),
        "sharded_gcn": lambda: ShardedGCN([4], None, None, in_dim=4),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(2),
        "routing_bytes_main": lambda: routing_bytes.main(["--ranks", "2"]),
        "shard_index": lambda: knn.shard_index(knn.FlatIndex(4), None),
        "partitioned_service": lambda: glt.QueryService(g, graph_shards=2),
        "serve_graph_shards": lambda: serve_main.serve(
            dict(cfg, graph_shards=2, backend="gloo"), block=False),
    }
    files = tmp_path / "cora_like"
    if entry in ("cora_load_graph", "node2vec_load", "sage_unsup_load"):
        # the files exist: the device is what fails
        synthetic.cora_like(str(files), n=20, feat_dim=8)
    cfg = {"nodes": [], "edges": [], "port": 0}  # "device" defaults to cuda
    cfg_path = tmp_path / "serve.json"
    cfg_path.write_text(json.dumps(cfg))
    snap = tmp_path / "snap"
    if entry == "graph_load":
        g.save(str(snap))  # a real snapshot: the device is what fails
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["init_cluster", "spawn", "serve_main"])
def test_ranks_sharing_a_card_are_refused_without_gloo(entry, monkeypatch,
                                                        tmp_path):
    """Two ranks on one card: NCCL refuses them, so the entry points that
    start ranks raise unless ``backend="gloo"`` is asked for, before any
    process group or process starts."""
    from graph_learn_tpu_torch.errors import InvalidArgumentError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    calls = {
        "init_cluster": lambda: bootstrap.init_cluster(
            "file://" + str(tmp_path / "store"), 2, 0),
        "spawn": lambda: launch.spawn(print, 2),
        "serve_main": lambda: serve_main.serve(
            {"nodes": [], "edges": [], "port": 0, "graph_shards": 2},
            block=False),
    }
    with pytest.raises(InvalidArgumentError, match="backend='gloo'"):
        calls[entry]()
    assert bootstrap.current_device() is None


ONLINE_MODULES = ("update", "serving", "export", "stream", "http", "router",
                  "serve_main", "loader_main")


def test_the_online_modules_are_in_the_guards_scope():
    sources = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    for name in ONLINE_MODULES:
        assert "graph_learn_tpu_torch/online/%s.py" % name in sources
    assert "graph_learn_tpu_torch/examples/serving_demo.py" in sources


def test_the_data_writers_need_no_card(no_card, monkeypatch, tmp_path):
    """Preparing data is host work: the writers run where there is no
    card, and the examples' generators write their files there too."""
    monkeypatch.delenv("GLT_PLATFORM", raising=False)
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "cora.content").write_text("31\t1\t0\tA\n7\t0\t1\tB\n")
    (raw / "cora.cites").write_text("31\t7\n")
    cora.prepare_cora(str(raw), str(tmp_path / "cora"))
    e = np.array([[0, 1]])
    ogbl_collab.write_collab_tables(str(tmp_path / "collab"), e,
                                    np.ones(1), e, e, e, e, np.ones((2, 3)))
    ogbn_products.write_products_tables(str(tmp_path / "products"),
                                        np.ones((2, 3)), [0, 1], e, [0],
                                        [1], [1])
    tgn.write_temporal_u2i(str(tmp_path / "tgn"), 4, 3, 10)
    for d, n in (("cora", 5), ("collab", 6), ("products", 5), ("tgn", 3)):
        assert len(os.listdir(tmp_path / d)) == n, d


def test_the_loader_needs_no_card(no_card, monkeypatch, tmp_path, capsys):
    """loader_main is the dataloader's host work (parse, partition,
    publish): it runs where there is no card, as the JAX loader does."""
    monkeypatch.delenv("GLT_PLATFORM", raising=False)
    nodes = tmp_path / "nodes"
    nodes.write_text("id:int64\n1\n2\n3\n")
    topic = str(tmp_path / "topic")
    assert loader_main.main(["load", "--topic", topic, "--partitions", "2",
                             "--nodes", "item=%s" % nodes]) == 0
    assert loader_main.main(["offsets", "--topic", topic]) == 0
    assert "published 3 rows" in capsys.readouterr().out


def test_cpu_service_works_without_a_card(no_card):
    g, _ = torch_graph(numpy_graph(n=30, d=4))
    svc = glt.QueryService(g, device="cpu")
    try:
        qid = svc.install(two_hop(g, 2, 2, batch=8), micro_batch=8)
        ans = svc.run(qid, np.array([7, 10]))
    finally:
        svc.close()
    assert ans["hop2"].ids.shape == (2, 2, 2)


def test_cpu_trainer_and_dataset_work_without_a_card(no_card):
    g, dec = torch_graph(numpy_graph(n=30, d=4))
    q = two_hop(g, 2, 2, batch=8)
    assert glt.Dataset(q, device="cpu").next()["hop2"].ids.shape == (8, 2, 2)
    model = EgoGraphSAGE([4, 8, 4], dec, device="cpu")
    ids = LocalTrainer(device="cpu").evaluate(
        q, model, lambda m, b: b["src"].ids.float())
    assert ids == pytest.approx(14.5)  # the mean of 0..29


@pytest.mark.parametrize("call", ["train", "evaluate"])
def test_the_host_tier_is_refused_until_it_is_ported(call):
    """The host tier is ported: ``tier="host"`` runs on the CPU (its own
    tests in test_torch_host_tier.py) and only an unknown tier is
    refused."""
    g, dec = torch_graph(numpy_graph(n=30, d=4))
    q = two_hop(g, 2, 2, batch=8)
    model = EgoGraphSAGE([4, 8, 4], dec, device="cpu")
    tr = LocalTrainer(device="cpu")
    if call == "train":
        def loss_fn(m, batch, generator, training):
            from graph_learn_tpu_torch.nn.data import EgoGraph
            return m(EgoGraph.from_query_result(
                batch, "src", ["hop1", "hop2"])).sum()
        _, hist = tr.train(q, model, loss_fn,
                           torch.optim.SGD(model.parameters(), lr=0.0),
                           verbose=False, tier="host")
        assert len(hist) == 1 and np.isfinite(hist[0])
        with pytest.raises(InvalidArgumentError, match="tier must be"):
            tr.train(q, model, loss_fn, None, tier="gpu")
    else:
        ids = tr.evaluate(q, model, lambda m, b: b["src"].ids.float(),
                          tier="host")
        assert ids == pytest.approx(14.5)  # the mean of 0..29
        with pytest.raises(InvalidArgumentError, match="tier must be"):
            tr.evaluate(q, model, None, tier="gpu")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(DeviceUnavailableError, match="nvcc"):
        build.build()


def test_library_path_changes_with_source_header_and_flags(monkeypatch,
                                                           tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.cu").write_text('#include "shared.cuh"\n')
    (src / "two.cu").write_text("// no include\n")
    (src / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    first = {n: build.library_path(n) for n in ("one", "two")}
    assert first["one"].name.startswith("libone-")
    assert first["one"].parent == tmp_path / "_build"
    assert first == {n: build.library_path(n) for n in first}  # stable
    # an edited header rebuilds every library (any source may include it)
    (src / "shared.cuh").write_text("// v2\n")
    second = {n: build.library_path(n) for n in first}
    assert all(second[n] != first[n] for n in first)
    # a new header too, an edited source only its own library, and a flag all
    (src / "other.cuh").write_text("")
    third = {n: build.library_path(n) for n in first}
    assert all(third[n] != second[n] for n in first)
    (src / "two.cu").write_text("// edited\n")
    fourth = {n: build.library_path(n) for n in first}
    assert fourth["one"] == third["one"] and fourth["two"] != third["two"]
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-g",))
    assert all(build.library_path(n) != fourth[n] for n in first)


def test_every_kernel_header_is_hashed_and_the_gat_source_includes_its_own():
    headers = sorted(p.name for p in build.SRC_DIR.glob("*.cuh"))
    source = (build.SRC_DIR / "gat.cu").read_text()
    for name in ("gat_mma.cuh", "gat_wgmma.cuh"):
        assert name in headers and '#include "%s"' % name in source


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def _chip_smoke_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_device_busy_leaves_out_annotated_ranges():
    """chip_smoke.py's device-busy sum counts kernels only: a range that
    user code annotates shows up on the device's timeline with the idle
    gaps between its kernels as its own time."""
    import types
    smoke = _chip_smoke_module()

    def ev(key, us, device="DeviceType.CUDA", annotation=False):
        return types.SimpleNamespace(key=key, self_device_time_total=us,
                                     device_type=device,
                                     is_user_annotation=annotation)

    prof = types.SimpleNamespace(key_averages=lambda: [
        ev("gather_rows_kernel", 30.0), ev("gather_rows_kernel", 20.0),
        ev("Optimizer.step#Adam.step", 300.0, annotation=True),
        ev("aten::index", 0.0, device="DeviceType.CPU"),
        ev("cpu_side_range", 40.0, device="DeviceType.CPU")])
    assert smoke.device_ms_by_kernel(prof) == {"gather_rows_kernel": 0.05}


K2 = "void segment_spmm_kernel<float, float, 4, 0>(SpmmArgs)"


@pytest.mark.parametrize("work,allow_memset,ok", [
    ({K2: 1.0}, False, True),
    ({K2: 1.0, "Memset (Device)": 1.0}, True, True),
    ({K2: 1.0, "Memset (Device)": 1.0}, False, False),  # a fill beside it
    ({K2: 1.0, "void at::native::clamp_kernel": 2.0}, False, False),
    ({K2: 1.0, "Memset (Device)": 2.0}, True, False),  # more than one fill
    ({K2: 2.0}, False, False),
    ({"Memset (Device)": 1.0}, True, False),  # no kernel at all
])
def test_chip_smoke_one_launch_rule(monkeypatch, work, allow_memset, ok):
    """chip_smoke.py's check that one wrapper call puts exactly one of its
    kernels on the card (and at most one memset where the call zeroes its
    output), on the nodes of a captured call."""
    smoke = _chip_smoke_module()
    monkeypatch.setattr(smoke, "captured_work",
                        lambda torch, fn: {n: int(c)
                                           for n, c in work.items()})
    monkeypatch.setattr(smoke, "device_ms_per_launch",
                        lambda torch, fn, kernel, parts: {
                            p: 0.002 if p == "memset" else 0.03
                            for p in parts})
    if ok:
        got, got_ms = smoke.check_one_launch(None, "k", None,
                                             "segment_spmm_kernel",
                                             allow_memset)
        assert sum(got.values()) == sum(work.values())
        assert got_ms["kernel"] == 0.03
        assert got_ms.get("memset", 0.002) == 0.002
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke.check_one_launch(None, "k", None, "segment_spmm_kernel",
                                   allow_memset)


def _row(**times):
    return dict(name="k", bound_ms=0.02, bwd_bound_ms=0.05,
                bar_bound_ms=0.03, bound_ms_62m=0.01, **times)


@pytest.mark.parametrize("row,ok", [
    (_row(ms=0.025), True),
    (_row(ms=0.015), False),  # the call under its bound
    # a warm call whose rows sit in the L2 may read under a bound of
    # device-memory bytes: it is not held to it
    (_row(ms=0.025, warm_ms=0.012, ms_62m=0.009), True),
    (_row(ms=0.025, bwd_ms=0.04), False),
    (_row(ms=0.025, bar_ms=0.029), False),
    (_row(ms=0.025, cold_ms_62m=0.011), True),
    (_row(ms=0.025, cold_ms_62m=0.0099), False),
    (dict(name="k", ms=0.01), True),  # no bound to hold it to
    # Kernel 1 cold at the row counts the paths launch, each held to its
    # own bound
    (_row(ms=0.025, ms_1024=0.003, bound_ms_1024=0.0002), True),
    (_row(ms=0.025, ms_15360=0.002, bound_ms_15360=0.0024), False),
    (_row(ms=0.025, cold_ms_62m_15360=0.01, bound_ms_62m_15360=0.0019),
     True),
    (_row(ms=0.025, cold_ms_62m_1024=0.0001, bound_ms_62m_1024=0.00012),
     False),
    # the rgcn path's shapes: Kernel 1 at 10 240 and 51 200 rows, Kernel 2
    # at [10 240, 5] means; and Kernel 2's sum at the 200k table
    (_row(ms=0.025, cold_ms_62m_51200=0.02, bound_ms_62m_51200=0.0062),
     True),
    (_row(ms=0.025, cold_ms_62m_10240=0.001, bound_ms_62m_10240=0.0013),
     False),
    (_row(ms=0.025, cold_ms_rgcn=0.01, bound_ms_rgcn=0.004), True),
    (_row(ms=0.025, cold_ms_rgcn=0.003, bound_ms_rgcn=0.004), False),
    (_row(ms=0.025, ms_sum=0.02, bound_ms_sum=0.014), True),
    (_row(ms=0.025, ms_sum=0.013, bound_ms_sum=0.014), False),
    # the categorical path's item-row shapes
    (_row(ms=0.025, cold_ms_cond_10240=0.004, bound_ms_cond_10240=0.0013),
     True),
    (_row(ms=0.025, cold_ms_cond_1024=0.0001, bound_ms_cond_1024=0.00012),
     False),
    # the SEAL step's 896 rows of the ogbl-collab-sized table
    (_row(ms=0.025, cold_ms_seal_896=0.006, bound_ms_seal_896=0.00028),
     True),
    (_row(ms=0.025, cold_ms_seal_896=0.0002, bound_ms_seal_896=0.00028),
     False),
    # the reference Cora configuration's rows of the 1 433-wide f32 table
    # and its hop-2 means
    (_row(ms=0.025, cold_ms_cora_3500=0.03, bound_ms_cora_3500=0.012),
     True),
    (_row(ms=0.025, cold_ms_cora_140=0.0004, bound_ms_cora_140=0.0005),
     False),
    (_row(ms=0.025, cold_ms_cora_spmm=0.05, bound_ms_cora_spmm=0.06),
     False),
])
def test_chip_smoke_holds_times_to_their_bounds(row, ok):
    """chip_smoke.py fails when a time on its kernels line reads under the
    least time it is held to."""
    smoke = _chip_smoke_module()
    if ok:
        smoke.check_bounds([row])
    else:
        with pytest.raises(smoke.SmokeFailure, match="under their bound"):
            smoke.check_bounds([row])


def test_chip_smoke_category_draw_follows_one_over_rank():
    """The categorical items' category: value r with probability
    proportional to 1 / (r + 1), so the heaviest run holds about a
    seventh of the items and the lightest a few hundred at the store's
    size."""
    smoke = _chip_smoke_module()
    rng = np.random.default_rng(0)
    n = 400_000
    cat = smoke.category_draw(n, 1000, rng)
    assert cat.min() >= 0 and cat.max() < 1000
    counts = np.bincount(cat, minlength=1000)
    p = 1.0 / np.arange(1, 1001)
    p /= p.sum()
    assert abs(counts[0] / n - p[0]) < 0.005
    assert counts[:10].sum() > counts[500:].sum()
    strs, cats = smoke.categorical_strings(2000, seed=3)
    assert len(strs) == 2000 and np.array_equal(
        [int(x.split(":")[0]) for x in strs], cats)
    tags = [x.split(":")[2] for x in strs]
    lens = {len(t.split(",")) if t else 0 for t in tags}
    assert lens == set(range(smoke.CAT_MAX_TAGS + 1))
    assert all(x.split(":")[1].startswith("brand_") for x in strs)


@pytest.mark.parametrize("dof", [1, 9, 99])
def test_chip_smoke_chi_square_p_tracks_scipy(dof):
    from scipy import stats
    smoke = _chip_smoke_module()
    rng = np.random.default_rng(dof)
    exp = np.full(dof + 1, 1000.0)
    for shift in (0.0, 0.02, 0.06):
        obs = rng.poisson(exp * (1 + shift * np.sign(
            np.arange(dof + 1) - dof / 2)))
        obs = obs * exp.sum() / obs.sum()
        stat = ((obs - exp) ** 2 / exp).sum()
        want = stats.chi2.sf(stat, dof)
        got = smoke.chi_square_p(obs, exp)
        # the normal approximation of the tail, off by a few hundredths of
        # one at one degree of freedom and by less above
        assert abs(got - want) < (0.05 if dof == 1 else 0.01), (got, want)


def test_chip_smoke_relaxed_rows_are_the_forced_rows():
    smoke = _chip_smoke_module()
    bad = np.array([[0, 0], [1, 0], [0, 1], [0, 0]], bool)
    assert smoke.relaxed_rows(bad, np.array([0, 1, 1, 0], bool)) == (
        2, 2, True)
    # a rejected negative in a row that did not have to relax
    assert smoke.relaxed_rows(bad, np.array([0, 1, 0, 0], bool)) == (
        2, 1, False)
    # a row that had to relax but holds no rejected negative
    assert smoke.relaxed_rows(bad, np.array([1, 1, 1, 0], bool)) == (
        2, 3, False)


@pytest.mark.parametrize("weighted,cap,steps", [(True, 3, 2), (True, 40, 3),
                                                (False, 5, None)])
def test_chip_smoke_host_induction_equals_the_port(weighted, cap, steps):
    """chip_smoke.py's host induction (host_adjacency, induce_host,
    check_induction) agrees with ops/subgraph.py on the CPU, counts the
    rows cut at the cap, and fails on an edge moved or a distance off."""
    from graph_learn_tpu_torch.ops.subgraph import induce_batched
    smoke = _chip_smoke_module()
    a = numpy_graph(n=50, avg_degree=5, d=2, isolated=4, seed=8,
                    weighted=weighted)
    g, _ = torch_graph(a)
    host = g.store.edge_table("rel")
    seeds = np.random.default_rng(1).integers(0, 50, (6, 8))
    seeds[0] = 7  # one node, all slots the same
    sg = induce_batched(host.device("cpu").out, torch.from_numpy(seeds),
                        nbr_cap=cap, need_dist=steps is not None,
                        num_bfs_steps=steps or 3)
    adj = smoke.host_adjacency(host.src, host.dst, host.weights,
                               set(seeds.reshape(-1).tolist()))
    cut, kept = smoke.check_induction(torch, sg, adj, seeds, cap, steps,
                                      "case")
    assert kept == int(sg.num_edges.sum()) and kept > 0
    want_cut = sum(int((host.src == v).sum()) > cap for row in seeds
                   for v in set(row.tolist()))
    assert cut == want_cut and (cut > 0) == (cap < 10)
    moved = sg.replace(edge_index=sg.edge_index.flip(1))
    with pytest.raises(smoke.SmokeFailure, match="host induction"):
        smoke.check_induction(torch, moved, adj, seeds, cap, steps, "case")
    if steps is not None:
        off = sg.replace(dist_to_dst=sg.dist_to_dst + 1)
        with pytest.raises(smoke.SmokeFailure, match="host induction"):
            smoke.check_induction(torch, off, adj, seeds, cap, steps, "case")


def test_chip_smoke_profiles_again_when_a_window_holds_no_kernel(
        monkeypatch):
    """A window that recorded nothing, or a memset and no kernel, lost its
    records: device_work_per_call profiles again rather than report it."""
    smoke = _chip_smoke_module()
    windows = [[], [(0, "Memset (Device)", 1.0)],
               [(i, n, 2.0) for i in range(10)
                for n in ("gather_rows_kernel", "Memset (Device)")]]
    settles = []

    def windows_in_turn(torch, fn, calls, settle=0.0):
        settles.append(settle)
        return windows.pop(0)
    monkeypatch.setattr(smoke, "profiled_work", windows_in_turn)
    work, ms = smoke.device_work_per_call(torch, None, calls=10)
    assert work == {"gather_rows_kernel": 1.0, "Memset (Device)": 1.0}
    # the windows profiled again are left to settle before they close
    assert windows == [] and settles == [0.0] + [smoke.PROFILER_SETTLE_S] * 2
    monkeypatch.setattr(smoke, "profiled_work", lambda torch, fn, calls,
                        settle=0.0: [(0, "Memset (Device)", 1.0)])
    with pytest.raises(smoke.SmokeFailure, match="no whole calls"):
        smoke.device_work_per_call(torch, None, calls=10)


GATHER_BULK = ("_ZN41_GLOBAL__N__84789cab_9_gather_cu_7b05fd7823"
               "gather_rows_bulk_kernelENS_8BulkArgsE")
CLAMP = ("_ZN2at6native29vectorized_elementwise_kernelILi4EZZZNS0_"
         "19launch_clamp_scalarEEEEviT0_T1_")


@pytest.mark.parametrize("works,ok", [
    ([{GATHER_BULK: 1}, {GATHER_BULK: 1}], True),
    ([{GATHER_BULK: 1}, {GATHER_BULK: 1, CLAMP: 1}], False),  # a clamp
    ([{GATHER_BULK: 2}], False),
    ([{}], False),  # no kernel at all
    ([{CLAMP: 1}], False),  # another kernel in its place
])
def test_chip_smoke_gather_kernels_takes_one_kernel_a_call(monkeypatch,
                                                           works, ok):
    """Kernel 1's one-kernel-a-call check reads the nodes of each call's
    capture and answers each call's kernel name (its route)."""
    smoke = _chip_smoke_module()
    given = list(works)
    monkeypatch.setattr(smoke, "captured_work",
                        lambda torch, fn: dict(given.pop(0)))
    calls = [None] * len(works)
    if ok:
        assert smoke.gather_kernels(None, calls, "here") == [
            GATHER_BULK] * len(works)
    else:
        with pytest.raises(smoke.SmokeFailure, match="want one gather_rows"):
            smoke.gather_kernels(None, calls, "here")


@pytest.mark.parametrize("name,label", [
    (GATHER_BULK, "gather_rows_bulk_kernel"),
    ("_ZN41_GLOBAL__N__84789cab_9_gather_cu_7b05fd7818gather_rows_kernelI5"
     "uint2EEvPKT_PKiPS2_lli", "gather_rows_kernel"),
    (CLAMP, "at::native::vectorized_elementwise_kernel"),
    ("_Z10foo_kernelPf", "foo_kernel"),
    ("Memset (Device)", "Memset (Device)"),
    ("void segment_spmm_kernel<float>(SpmmArgs)",
     "void segment_spmm_kernel<float>(SpmmArgs)"),
])
def test_chip_smoke_labels_mangled_kernel_names(name, label):
    assert _chip_smoke_module().kernel_label(name) == label


def test_chip_smoke_times_a_launch_from_the_records_that_came(monkeypatch):
    """A launch's mean device time needs no whole window: a window without
    a record of the memset is profiled again, and one with some records of
    each is averaged over them."""
    smoke = _chip_smoke_module()
    windows = [[(0, "sweep_aggregate_kernel<f>", 40.0)],
               [(0, "Memset (Device)", 2.0),
                (1, "sweep_aggregate_kernel<f>", 30.0),
                (2, "sweep_aggregate_kernel<f>", 50.0),
                (3, "at::native::fill", 9.0)]]
    monkeypatch.setattr(smoke, "profiled_work",
                        lambda torch, fn, calls, settle=0.0: windows.pop(0))
    ms = smoke.device_ms_per_launch(None, None, "sweep_aggregate_kernel",
                                    {"kernel", "memset"})
    assert windows == [] and ms == {"kernel": 0.04, "memset": 0.002}
    monkeypatch.setattr(smoke, "profiled_work",
                        lambda torch, fn, calls, settle=0.0: [])
    with pytest.raises(smoke.SmokeFailure, match="recorded no"):
        smoke.device_ms_per_launch(None, None, "k", {"kernel"})


def test_chip_smoke_main_runs_phase_20():
    """main() drives the file tier, the sampler objects and k-NN, and
    merges the first two's fields into the kernels line."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    called = {n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert {"file_tier_path", "sampler_api_path", "knn_path"} <= called
    merged = {n.id for n in ast.walk(main) if isinstance(n, ast.Name)}
    assert {"file_rows", "sampler_rows"} <= merged


def test_chip_smoke_main_runs_phase_22():
    """main() drives the online tier after phase 20."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    called = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "online_path" in called
    assert called.index("online_path") > called.index("knn_path")


def test_chip_smoke_main_runs_phase_25():
    """main() drives partitioned serving after phase 24, from the files
    phase 22 kept, and merges its fields into the kernels line."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    calls = [n for n in ast.walk(main)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    line = {n.func.id: n.lineno for n in calls}
    assert line["partitioned_path"] > line["parallel_path"]
    online = next(n for n in calls if n.func.id == "online_path")
    assert [k.arg for k in online.keywords] == ["files"]
    assert "pserve_rows" in {n.id for n in ast.walk(main)
                             if isinstance(n, ast.Name)}


def test_chip_smoke_main_runs_phase_27():
    """main() holds the CSR order to its plain version on phase 11's
    weighted store, before that store is freed, and puts its row on the
    kernels line; its bound counts 20 bytes an edge."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    calls = [n for n in ast.walk(main)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    line = {n.func.id: n.lineno for n in calls}
    assert line["bench_path"] < line["csr_path"] < line["walks_path"]
    assert "csr_row" in {n.id for n in ast.walk(main)
                         if isinstance(n, ast.Name)}
    assert _chip_smoke_module().csr_work(123_718_280) == 2_474_365_600


def test_chip_smoke_parallel_path_rehearses_on_the_cpu(capsys,
                                                       monkeypatch):
    """Phase 24 at a small size on the CPU: DistTrainer at (1, 1) against
    LocalTrainer, then two gloo ranks: the partitioned store in both
    routings with three topk batches against the one-rank plan, the
    data-parallel run with equal parameters on both ranks, ShardedGCN
    and routing_bytes; on the CPU no kernel launches."""
    import importlib
    from graph_learn_tpu_torch.ops.kernels import gather, spmm
    # by its own name, so that the spawned ranks import it
    monkeypatch.syspath_prepend(str(REPO))
    smoke = importlib.import_module("chip_smoke")
    with bench.bench_conf(storage_profile="full"):
        rows = smoke.parallel_path(torch, "the CPU", gather, spmm, cfg=dict(
            n_nodes=400, avg_degree=6, feat_dim=8, hidden=16, classes=4,
            batch=32, fanout=(3, 2), device="cpu"))
    assert rows["gather_rows"]["parallel_dp_launches_per_step"] == 0
    assert rows["segment_spmm"]["parallel_halo_launches_per_spmm"] == 0
    assert rows["gather_rows"]["parallel_halo_launches_per_spmm"] == 0
    out = capsys.readouterr().out
    for line in ("parallel (a) DistTrainer mesh (1, 1)", "owner routing",
                 "psum routing", "3 topk batches bit-equal",
                 "parallel (c) DistTrainer mesh (2, 1)", "bit-equal on both",
                 "parallel (d) ShardedGCN", "of a one-rank dense GCN's",
                 "parallel (e) routing_bytes",
                 "phase 24 (parallel)"):
        assert line in out, line


def test_chip_smoke_partitioned_path_rehearses_on_the_cpu(capsys,
                                                         monkeypatch,
                                                         tmp_path):
    """Phase 25 at a small size on the CPU: two gloo ranks serve the
    random 2-hop query bit-equal to a one-rank service, topk callers get
    the one-rank answers, refreshes under callers with probe edges, the
    serve_main worker from TSV files with graph_shards 2 over HTTP, and
    the sharded k-NN index of each configuration; on the CPU no kernel
    launches."""
    import importlib
    from graph_learn_tpu_torch.ops.kernels import gather, spmm
    monkeypatch.syspath_prepend(str(REPO))  # the ranks import it by name
    smoke = importlib.import_module("chip_smoke")
    cfg = dict(n_nodes=1500, avg_degree=6, feat_dim=8, classes=4, batch=32,
               fanout=(3, 2), device="cpu", sizes=(1, 3, 7, 32, 50, 5),
               clients=3, requests=4, max_ids=3, edge_batches=2,
               edge_batch=200, knn=dict(base=500, queries=40, check=20,
                                        nlist=8, nprobe=3, k=10))
    g, _ = glt.synthetic_graph(cfg["n_nodes"], cfg["avg_degree"],
                               cfg["feat_dim"], cfg["classes"], seed=0,
                               device="cpu")
    nt = g.store.node_table("item")
    smoke.write_store_tsv(str(tmp_path), nt, g.store.edge_table("rel"),
                          nt.raw_ids[:1])
    rows = smoke.partitioned_path(torch, "the CPU", gather, spmm,
                                  str(tmp_path), cfg=cfg)
    assert rows == {"gather_rows": {"pserve_launches_per_round": 0.0,
                                    "pserve_follower_launches_per_round":
                                        0.0},
                    "segment_spmm": {"pserve_launches_per_round": 0}}
    out = capsys.readouterr().out
    for line in ("partitioned (a) QueryService(graph_shards=2)",
                 "bit-equal to a one-rank QueryService",
                 "every answer the one-rank answer", "partitioned (b)",
                 "every probe led", "partitioned (c) serve_main",
                 "SIGTERM ended both ranks", "k-NN flat/L2", "k-NN flat/ip",
                 "k-NN ivfflat/L2", "k-NN ivfpq/L2",
                 "phase 25 (partitioned serving)"):
        assert line in out, line


def test_chip_smoke_online_path_rehearses_on_the_cpu(capsys):
    """Phase 22 at a small size on the CPU: the worker from its TSV files,
    HTTP clients through clients/py, the stream with the live-snapshot
    and CSR checks, the exports through /admin/model (EgoGraphSAGE,
    EgoGAT and EgoGraphSAGE on the sorted route, each program holding its
    glt operators; the StableHLO fixture refused), the router; on the CPU
    no kernel launches."""
    from graph_learn_tpu_torch.ops.kernels import gather, spmm
    smoke = _chip_smoke_module()
    old = glt.conf.feature_dtype
    glt.conf.feature_dtype = "bfloat16"
    try:
        with bench.bench_conf(storage_profile="full"):
            counts = smoke.online_path(torch, "the CPU", gather, spmm,
                                       n_nodes=1500, feat_dim=8,
                                       device="cpu", edge_batch=300,
                                       new_nodes=40)
    finally:
        glt.conf.feature_dtype = old
    zero = {"gather_rows": 0, "segment_spmm": 0}
    none = dict(zero, gat_block=0, gat_block_bwd=0, sweep_aggregate=0)
    assert counts == {"http_serving": zero, "predict": zero,
                      "router": zero, "one_predict": zero,
                      "gat_one_predict": none, "sorted_one_predict": none}
    out = capsys.readouterr().out
    for line in ("online store", "online HTTP serving", "online stream",
                 "bit-equal to an in-memory build", "online export",
                 "EgoGAT [8, 256, 32] heads [8, 1]",
                 "'gather_rows': 3, 'gat_block': 3",
                 "'gather_rows': 2, 'sweep_aggregate': 1",
                 "a JAX StableHLO artifact is refused",
                 "online router", "glt_online launches"):
        assert line in out, line


def test_chip_smoke_main_runs_phase_23():
    """main() drives the examples on real layouts after the TSV examples
    (phase 21d) and merges their fields into the kernels line."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    called = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "real_layout_path" in called
    assert called.index("real_layout_path") > called.index(
        "tsv_examples_path")
    assert "real_rows" in {n.id for n in ast.walk(main)
                           if isinstance(n, ast.Name)}


def test_chip_smoke_main_runs_phase_24():
    """main() drives the parallel path after the online tier (phase 22)
    and merges its fields into the kernels line."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    called = [n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "parallel_path" in called
    assert called.index("parallel_path") > called.index("online_path")
    assert "parallel_rows" in {n.id for n in ast.walk(main)
                               if isinstance(n, ast.Name)}


def test_chip_smoke_real_layout_path_rehearses_on_the_cpu(capsys):
    """Phase 23 at a small size on the CPU, 1 433 features wide: the
    reference Cora configuration from cora_like files, Cora's raw layout
    through prepare_cora (its store held to the raw files), SEAL through
    --collab_dir (its store held to the in-memory twin); on the CPU no
    kernel launches and none is timed."""
    from graph_learn_tpu_torch.ops.kernels import gather, spmm
    smoke = _chip_smoke_module()
    with bench.bench_conf(storage_profile="full", feature_dtype="float32"):
        fields = smoke.real_layout_path(
            torch, "the CPU", gather, spmm, device="cpu",
            cora_ref=dict(nodes=300, features=1433, classes=7, epochs=2,
                          bar=0.0),
            raw_cora=dict(smoke.RAW_CORA, papers=700, cites=1400,
                          epochs=1),
            collab=dict(nodes=2000, train=6000, valid=50, test=300,
                        neg=400, steps=3, batch=64))
    g, s = fields["gather_rows"], fields["segment_spmm"]
    assert g["cora_ref_launches_per_step"] == 2.0
    assert s["cora_ref_launches_per_step"] == 1.0
    assert 0.0 <= g["cora_ref_test_accuracy"] <= 1.0
    assert g["collab_files_launches_per_step"] == 0.0
    assert np.isfinite(g["collab_files_hits_at_50"])
    assert "cold_ms_cora_140" not in g  # nothing timed off the card
    out = capsys.readouterr().out
    for line in ("cora reference configuration", "raw cora",
                 "seal --collab_dir", "phase 23"):
        assert line in out, line


@pytest.mark.parametrize("per,steps,evals,want", [
    ({"gather_rows": 2, "segment_spmm": 1}, 240, 10,
     {"gather_rows": 500, "segment_spmm": 250}),
    ({"gather_rows": 3, "gat_block": 3, "gat_block_bwd": 3}, 16, 4,
     {"gather_rows": 60, "gat_block": 60, "gat_block_bwd": 48}),
    ({"gather_rows": 7}, 5, 2, {"gather_rows": 49, "segment_spmm": 0}),
])
def test_chip_smoke_counts_launches_over_steps_and_evaluations(
        per, steps, evals, want):
    """The launches a TSV example or phase 23 is held to: ``per`` a step
    over the training steps and the evaluated batches; a backward only in
    training."""
    smoke = _chip_smoke_module()
    assert smoke.expected_launches(per, want, steps, evals) == want


@pytest.mark.parametrize("name,route", [
    (GATHER_BULK, "bulk"),
    ("_ZN41_GLOBAL__N__84789cab_9_gather_cu_7b05fd7818gather_rows_kernelI5"
     "uint2EEvPKT_PKiPS2_lli", "lanes, 8-byte words"),
    ("_ZN41_GLOBAL__N__84789cab_9_gather_cu_7b05fd7818gather_rows_kernelI5"
     "uint4EEvPKT_PKiPS2_lli", "lanes, 16-byte words"),
    ("_ZN41_GLOBAL__N__84789cab_9_gather_cu_7b05fd7818gather_rows_kernelIj"
     "EEvPKT_PKiPS1_lli", "lanes, 4-byte words"),
    ("_ZN41_GLOBAL__N__5ab_7_spmm_cu_1c2d3e4f19segment_spmm_kernelIffLi1E"
     "EEvNS_8SpmmArgsE", "vec 1"),
    ("_ZN41_GLOBAL__N__5ab_7_spmm_cu_1c2d3e4f19segment_spmm_kernelI13__nv_"
     "bfloat16fLi8EEEvNS_8SpmmArgsE", "vec 8"),
])
def test_chip_smoke_reads_the_route_from_a_kernel_name(name, route):
    assert _chip_smoke_module().vector_route(name) == route


def test_chip_smoke_fails_off_the_native_ingest_route():
    """The file tier's route check: a loader that could not be built (the
    Python parser's route) fails the phase."""
    import types
    smoke = _chip_smoke_module()
    missing = types.SimpleNamespace(available=lambda: False,
                                    library_path=lambda: "none")
    with pytest.raises(smoke.SmokeFailure, match="Python parser"):
        smoke.check_native_route(missing)
    built = types.SimpleNamespace(available=lambda: True,
                                  library_path=lambda: "/lib.so")
    assert smoke.check_native_route(built) == "/lib.so"


@pytest.mark.parametrize("peak,ok", [(1.9e9, True), (8.5e9, False)])
def test_chip_smoke_knn_memory_check_reads_the_peak(peak, ok):
    """k-NN's memory check resets the peak, runs the search and reads
    ``torch.cuda.max_memory_allocated``."""
    import types
    smoke = _chip_smoke_module()
    calls = []
    cuda = types.SimpleNamespace(
        synchronize=lambda: calls.append("sync"),
        reset_peak_memory_stats=lambda: calls.append("reset"),
        max_memory_allocated=lambda: calls.append("read") or peak)
    fake = types.SimpleNamespace(cuda=cuda)
    if ok:
        assert smoke.knn_peak_bytes(fake, lambda: "answer") == ("answer",
                                                                peak)
    else:
        with pytest.raises(smoke.SmokeFailure, match="peaked"):
            smoke.knn_peak_bytes(fake, lambda: "answer")
    assert calls == ["sync", "reset", "sync", "read"]


def test_chip_smoke_tsv_text_reads_back(tmp_path):
    """The vectorised TSV writer: ids and labels exact, weights at nine
    significant digits read back to the same float32 (tiny, zero and
    near-one ones among them), features within half a unit of the fifth
    decimal plus one ulp; both parse routes agree on the file."""
    from graph_learn_tpu_torch.core import ingest
    smoke = _chip_smoke_module()
    rng = np.random.default_rng(0)
    n, d, e = 300, 6, 2000
    nt = glt.NodeTable("item", glt.Decoder(labeled=True,
                                           attr_types=["float"] * d),
                       rng.permutation(10_000)[:n],
                       float_attrs=(rng.standard_normal((n, d)) * 20).astype(
                           np.float32),
                       labels=rng.integers(0, 40, n))
    w = rng.random(e).astype(np.float32)
    w[:4] = [0.0, 1e-30, 0.99999994, 1.5e-7]
    et = glt.EdgeTable("rel", "item", "item", glt.Decoder(weighted=True),
                       src=rng.integers(0, n, e), dst=rng.integers(0, n, e),
                       num_src_nodes=n, num_dst_nodes=n, weights=w)
    paths, sizes, _ = smoke.write_store_tsv(str(tmp_path), nt, et,
                                            nt.raw_ids[:30])
    assert sizes["nodes"] == (tmp_path / "nodes").stat().st_size
    for parse in (ingest._load, ingest._parse_records):  # native, Python
        nodes = parse(paths["nodes"], ingest.NODE_IDS, nt.decoder)
        edges = parse(paths["edges"], ingest.EDGE_IDS, et.decoder)
        train = parse(paths["train"], ingest.NODE_IDS, glt.Decoder())
        np.testing.assert_array_equal(nodes["ids"], nt.raw_ids)
        np.testing.assert_array_equal(nodes["labels"], nt.labels)
        err = np.abs(nodes["float_attrs"] - nt.float_attrs)
        assert (err <= smoke.FILE_FEATURE_TOL
                + np.spacing(np.abs(nt.float_attrs))).all()
        np.testing.assert_array_equal(edges["src_ids"], nt.raw_ids[et.src])
        np.testing.assert_array_equal(edges["dst_ids"], nt.raw_ids[et.dst])
        np.testing.assert_array_equal(edges["weights"], w)
        np.testing.assert_array_equal(train["ids"], nt.raw_ids[:30])
    head = smoke.head_file(paths["edges"], 10, str(tmp_path))
    assert len(open(head).read().splitlines()) == 11
