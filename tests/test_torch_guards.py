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
from graph_learn_tpu_torch.errors import DeviceUnavailableError
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
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
                                   "node_table", "edge_table"])
def test_entry_points_raise_without_a_card(no_card, entry):
    a = numpy_graph(n=30, d=4)
    g, dec = torch_graph(a)  # device="cpu" works without a card
    calls = {
        "graph": lambda: glt.Graph(),
        "graph_cuda0": lambda: glt.Graph(device="cuda:0"),
        "service": lambda: glt.QueryService(g),
        "model": lambda: EgoGraphSAGE([4, 8, 2], dec),
        "node_table": lambda: g.store.node_table("item").device(),
        "edge_table": lambda: g.store.edge_table("rel").device(),
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


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(DeviceUnavailableError, match="nvcc"):
        build.build()


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
