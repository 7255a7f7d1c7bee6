"""Whole runs at a test's size on the CPU (``GLT_PLATFORM=cpu``): the port
against the reference, the faults and the control that the comparison must
catch, a cell, and a configuration of three hops with a model of its own,
added by files alone, and the run without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gnnbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FIXTURES = HERE / "tests" / "fixtures"
CELLS = ["tiny-sage-products.uniform"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(capsys, cell, seed=2 ** 32 + 17, extra=(), catalog=FIXTURES,
             spec=FIXTURES / "spec.json"):
    """One in-process run on the CPU; returns (exit code, result line)."""
    old = os.environ.get("GLT_PLATFORM")
    os.environ["GLT_PLATFORM"] = "cpu"
    try:
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", "0.3", "--catalog", str(catalog),
                           "--spec", str(spec), *extra])
    finally:
        if old is None:
            del os.environ["GLT_PLATFORM"]
        else:
            os.environ["GLT_PLATFORM"] = old
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(capsys, cell):
    rc, res = run_cell(capsys, cell)
    assert rc == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == "compared"
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_edges_per_s", "train_mfu",
                                   "setup_s"}
    assert res["device"]["platform"] == "cpu"
    for name, v in res["compared"].items():
        assert v["value"] <= v["limit"], name


def test_a_traced_run_reports_per_layer_metrics(capsys):
    rc, res = run_cell(capsys, CELLS[0], extra=["--trace", "1"])
    assert rc == 0 and res["correct"]
    # no card: nothing from a device trace, only the host's store span
    assert set(res["metrics"]) == {"store_build_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(capsys, cell):
    """The reference in TF32 (emulated on the CPU) in the program's place
    fails a limit; so does the loss over half the batch."""
    rc, res = run_cell(capsys, cell, extra=["--control", "1"])
    assert rc == 0 and res["correct"]
    limits = {k: v["limit"] for k, v in res["compared"].items()}
    for kind in ("control_tf32", "half_batch"):
        nums = res["calibration"][kind]
        assert any(v > limits[k] for k, v in nums.items()), (kind, nums)


class _Frozen(torch.optim.Adam):
    def step(self, closure=None):  # the state is returned unchanged
        return None


class _FrozenLater(torch.optim.Adam):
    """Adam for the first call's steps, then the state returned unchanged:
    a fault that only the calls after the first show."""

    def step(self, closure=None):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls <= 4:  # the fixture cell's K
            return super().step(closure)
        return None


def _half_loss(orig):
    def loss(logits, labels, valid=None):
        n = logits.shape[0] // 2
        return orig(logits[:n], labels[:n])
    return loss


def _altered_sample(orig):
    def sample_one(q, tables, n_nodes, generator):
        seeds, batch = orig(q, tables, n_nodes, generator)
        hop1 = batch["hop1"]
        ids = hop1.ids.clone()
        ids[0] = (ids[0] + 1) % n_nodes
        return seeds, {**batch, "hop1": hop1.replace(ids=ids)}
    return sample_one


def _altered_mean(orig):
    def gather_group_agg(table, idx, op="mean"):
        out = orig(table, idx, op).clone()
        out[0] += 1.0
        return out
    return gather_group_agg


@pytest.mark.parametrize("fault", ["unchanged_state", "unchanged_later",
                                   "half_batch", "altered_sample",
                                   "altered_mean"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(capsys, monkeypatch, cell, fault):
    from graph_learn_tpu_torch import bench
    from graph_learn_tpu_torch.nn import loss as loss_mod
    from graph_learn_tpu_torch.ops import aggregate
    if fault == "unchanged_state":
        monkeypatch.setattr(bench, "make_optimizer",
                            lambda m, d, lr: _Frozen(m.parameters(), lr=lr))
    elif fault == "unchanged_later":
        monkeypatch.setattr(bench, "make_optimizer",
                            lambda m, d, lr: _FrozenLater(m.parameters(),
                                                          lr=lr))
    elif fault == "half_batch":
        monkeypatch.setattr(loss_mod, "supervised_softmax_loss",
                            _half_loss(loss_mod.supervised_softmax_loss))
    elif fault == "altered_sample":
        monkeypatch.setattr(bench, "sample_one",
                            _altered_sample(bench.sample_one))
    else:
        monkeypatch.setattr(aggregate, "gather_group_agg",
                            _altered_mean(aggregate.gather_group_agg))
    rc, res = run_cell(capsys, cell)
    assert rc == 0
    assert res["correct"] is False, res["compared"]


def _skewed_cell(root: Path) -> str:
    """A new workload of the fixture's configuration: a workload file and
    its entry."""
    (root / "workloads").mkdir()
    wl = json.loads((FIXTURES / "workloads" /
                     "tiny-sage-products.uniform.json").read_text())
    wl.update(name="tiny-sage-products.skewed", graph={"alpha": 0.8})
    (root / "workloads" / "tiny-sage-products.skewed.json").write_text(
        json.dumps(wl))
    spec = json.loads((FIXTURES / "spec.json").read_text())
    spec["workloads"].append({"name": "tiny-sage-products.skewed",
                              "config": "tiny-sage-products",
                              "traffic": "skewed", "chips": 1, "why": "t"})
    (root / "spec.json").write_text(json.dumps(spec))
    return "tiny-sage-products.skewed"


def _three_hop_cell(root: Path) -> str:
    """A configuration of three layers on fanout [15, 10, 5] with a model
    of its own (``ego_sage``'s step and reference under another name):
    a configuration, a workload, ``models/<m>.py``, ``references/<m>.py``
    and their entries."""
    for sub in ("configs", "workloads", "models", "references"):
        (root / sub).mkdir()
    cfg = json.loads((FIXTURES / "configs" /
                      "tiny-sage-products.json").read_text())
    cfg.update(name="tiny-sage3-products", model="ego_sage_deep",
               dims=[100, 256, 256, 47], num_layers=3, fanout=[15, 10, 5],
               reduced=["dropout"])
    (root / "configs" / "tiny-sage3-products.json").write_text(
        json.dumps(cfg))
    wl = json.loads((FIXTURES / "workloads" /
                     "tiny-sage-products.uniform.json").read_text())
    wl.update(name="tiny-sage3-products.uniform", config=cfg["name"])
    wl["traffic"].update(batch=32, fanout=[15, 10, 5])
    (root / "workloads" / "tiny-sage3-products.uniform.json").write_text(
        json.dumps(wl))
    for sub in ("models", "references"):
        shutil.copy(HERE / sub / "ego_sage.py",
                    root / sub / "ego_sage_deep.py")
    spec = json.loads((FIXTURES / "spec.json").read_text())
    spec["configs"].append({**spec["configs"][0], "reduced": ["dropout"],
                            "name": "tiny-sage3-products",
                            "file": "configs/tiny-sage3-products.json"})
    spec["workloads"].append({"name": "tiny-sage3-products.uniform",
                              "config": "tiny-sage3-products",
                              "traffic": "uniform", "chips": 1, "why": "t"})
    (root / "spec.json").write_text(json.dumps(spec))
    return "tiny-sage3-products.uniform"


@pytest.mark.parametrize("added", [_skewed_cell, _three_hop_cell],
                         ids=["skewed", "three_hops"])
def test_a_cell_added_by_files_alone(capsys, tmp_path, added):
    """A new cell, or a configuration of another depth with a model and
    reference of its own, is new files and entries: the harness finds them
    in another catalog directory with no edit."""
    cell = added(tmp_path)
    rc, res = run_cell(capsys, cell, seed=9, spec=tmp_path / "spec.json",
                       extra=["--catalog", str(tmp_path)])
    assert rc == 0 and res["correct"], res["compared"]


def _hop3_off_the_csr(monkeypatch):
    from graph_learn_tpu_torch import bench

    def sample_one(q, tables, n_nodes, generator, orig=bench.sample_one):
        seeds, batch = orig(q, tables, n_nodes, generator)
        hop3 = batch["hop3"]
        ids = hop3.ids.clone()
        ids[0] = (ids[0] + 1) % n_nodes
        return seeds, {**batch, "hop3": hop3.replace(ids=ids)}
    monkeypatch.setattr(bench, "sample_one", sample_one)
    return "bad_samples"


def _layer2_weight(monkeypatch):
    """The program's third-layer weight off the benchmark's by 1e-3 of
    itself; the reference starts from the benchmark's."""
    orig = harness.draw_weights

    def draw_weights(model, ref_name, seed, dev):
        out = orig(model, ref_name, seed, dev)
        with torch.no_grad():
            dict(model.named_parameters())[
                "layers.2.convs.0.trans_nodes.weight"].mul_(1 + 1e-3)
        return out
    monkeypatch.setattr(harness, "draw_weights", draw_weights)
    return "logit_gap"


@pytest.mark.parametrize("fault", [_hop3_off_the_csr, _layer2_weight],
                         ids=["hop3_off_the_csr", "layer2_weight"])
def test_a_fault_at_the_third_hop_is_caught(capsys, monkeypatch, tmp_path,
                                            fault):
    cell = _three_hop_cell(tmp_path)
    number = fault(monkeypatch)
    rc, res = run_cell(capsys, cell, seed=9, catalog=tmp_path,
                       spec=tmp_path / "spec.json")
    assert rc == 0 and res["correct"] is False
    assert res["compared"][number]["value"] > res["compared"][number][
        "limit"], res["compared"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "GLT_PLATFORM"}
    out = subprocess.run(
        [sys.executable, "gnnbench/run.py", "--workload",
         "sage-products.uniform", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_only_the_benchmark_files_is_no_run(tmp_path):
    """A checkout of BENCHMARK.json and gnnbench/ alone: the program is
    missing, so the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "GLT_PLATFORM": "cpu", "PYTHONPATH": ""}
    out = subprocess.run(
        [sys.executable, "gnnbench/run.py", "--workload",
         "sage-products.uniform", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["sage-products.uniform"])
def test_the_control_fails_on_the_card(cell):
    """At the cell's own size on the card, on three seeds: the port is
    correct, and the control (TF32 products) and the half batch each fail a
    limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        out = subprocess.run(
            [sys.executable, "gnnbench/run.py", "--workload", cell, "--seed",
             str(seed), "--seconds", "2", "--trace", "0", "--control", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["compared"]
        limits = {k: v["limit"] for k, v in res["compared"].items()}
        for kind in ("control_tf32", "half_batch"):
            nums = res["calibration"][kind]
            assert any(v > limits[k] for k, v in nums.items()), (kind, nums)
