"""Guards of the port: it imports nothing of JAX or of the JAX package, its
entry points never fall back to the CPU on their own, and chip_smoke.py
refuses to report without a card."""

import ast
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
from graph_learn_tpu_torch.examples import scale_demo, sweep_aggregate
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT, EgoGraphSAGE
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.ops.kernels import build
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
                                   "sweep_harness", "bench", "bench_main"])
def test_entry_points_raise_without_a_card(no_card, entry, monkeypatch):
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
    }
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        calls[entry]()


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
    g, dec = torch_graph(numpy_graph(n=30, d=4))
    q = two_hop(g, 2, 2, batch=8)
    model = EgoGraphSAGE([4, 8, 4], dec, device="cpu")
    tr = LocalTrainer(device="cpu")
    with pytest.raises(InvalidArgumentError, match="not yet ported"):
        if call == "train":
            tr.train(q, model, None, None, tier="host")
        else:
            tr.evaluate(q, model, None, tier="host")


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
    output), on profiler counts per call."""
    smoke = _chip_smoke_module()
    ms = {n: 0.002 if n.startswith("Memset") else 0.03 for n in work}
    monkeypatch.setattr(smoke, "device_work_per_call",
                        lambda torch, fn: (dict(work), ms))
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
