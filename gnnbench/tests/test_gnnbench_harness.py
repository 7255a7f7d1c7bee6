"""Whole runs at a test's size on the CPU (``GLT_PLATFORM=cpu``): the port
against the reference, the faults and the control that the comparison must
catch, a cell added by files alone, and the run without a card."""

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


def test_a_cell_added_by_files_alone(capsys, tmp_path):
    """A new cell is a workload file (and its entry): the harness finds it
    in another catalog directory with no edit."""
    (tmp_path / "workloads").mkdir()
    wl = json.loads((FIXTURES / "workloads" /
                     "tiny-sage-products.uniform.json").read_text())
    wl.update(name="tiny-sage-products.skewed", graph={"alpha": 0.8})
    (tmp_path / "workloads" / "tiny-sage-products.skewed.json").write_text(
        json.dumps(wl))
    spec = json.loads((FIXTURES / "spec.json").read_text())
    spec["workloads"].append({"name": "tiny-sage-products.skewed",
                              "config": "tiny-sage-products",
                              "traffic": "skewed", "chips": 1, "why": "t"})
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    old = os.environ.get("GLT_PLATFORM")
    os.environ["GLT_PLATFORM"] = "cpu"
    try:
        rc = harness.main(["--workload", "tiny-sage-products.skewed",
                           "--seed", "9", "--seconds", "0.3",
                           "--catalog", str(FIXTURES),
                           "--catalog", str(tmp_path),
                           "--spec", str(tmp_path / "spec.json")])
    finally:
        if old is None:
            del os.environ["GLT_PLATFORM"]
        else:
            os.environ["GLT_PLATFORM"] = old
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"]


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
