"""The GAT configuration (``configs/gat-products.json``, ``models/
ego_gat.py``, ``references/ego_gat.py``, ``flops_gat.py``) at a test's
size on the CPU (``GLT_PLATFORM=cpu``): a run agrees with the reference,
the control and the half batch fail a limit, a step that drops the
self-loop is not correct; and the counts against counts made by hand."""

import json

import pytest
import torch

from gnnbench import flops, flops_gat
from gnnbench.catalog import Catalog
from gnnbench.tests.test_gnnbench_harness import FIXTURES, run_cell

CELL = "tiny-gat-products.uniform"
PUBLISHED = dict(dims=[100, 128, 128, 47], heads=[4, 4, 4],
                 concat=[True, True, False])


@pytest.fixture
def spec(tmp_path):
    """The fixture's spec with the tiny GAT cell added, and to every
    per-layer metric's cells."""
    s = json.loads((FIXTURES / "spec.json").read_text())
    s["workloads"].append({"name": CELL, "config": "tiny-gat-products",
                           "traffic": "uniform", "chips": 1, "why": "test"})
    for m in s["per_layer"]:
        m["workloads"].append(CELL)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(s))
    return path


def test_the_port_agrees_with_the_reference_and_the_control_fails(capsys,
                                                                  spec):
    rc, res = run_cell(capsys, CELL, spec=spec, extra=["--control", "1"])
    assert rc == 0 and res["correct"], res["compared"]
    assert "agg_gap" not in res["compared"]  # nothing is pre-averaged
    limits = {k: v["limit"] for k, v in res["compared"].items()}
    for kind in ("control_tf32", "half_batch"):
        nums = res["calibration"][kind]
        assert any(v > limits[k] for k, v in nums.items() if k in limits), (
            kind, nums)


def test_a_traced_run_reports_what_the_cpu_has(capsys, spec):
    rc, res = run_cell(capsys, CELL, spec=spec, extra=["--trace", "1"])
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"store_build_s"}


def test_a_step_without_its_self_loops_is_not_correct(capsys, monkeypatch,
                                                      spec):
    from graph_learn_tpu_torch.nn.layers.ego import EgoGATConv
    orig = EgoGATConv.forward

    def forward(self, *args, **kwargs):
        loop, self.self_loop = self.self_loop, False
        try:
            return orig(self, *args, **kwargs)
        finally:
            self.self_loop = loop
    monkeypatch.setattr(EgoGATConv, "forward", forward)
    rc, res = run_cell(capsys, CELL, spec=spec)
    assert rc == 0 and res["correct"] is False
    assert res["compared"]["logit_gap"]["value"] > res["compared"][
        "logit_gap"]["limit"]


def test_the_reference_names_are_one_to_one():
    cat = Catalog([str(FIXTURES)])
    mod = cat.module("models", "ego_gat")
    cfg = cat.config("tiny-gat-products")
    from graph_learn_tpu_torch.core.schema import Decoder
    model = mod.build(cfg, Decoder(labeled=True, attr_types=["float"] * 100),
                      torch.device("cpu"))
    names = [mod.ref_name(k) for k, _ in model.named_parameters()]
    assert len(set(names)) == len(names) == 3 * (2 * 4 + 3)
    with pytest.raises(ValueError):
        mod.ref_name("layers.0.convs.0.n_0.weight")


def test_the_published_widths_count_751574_parameters():
    assert flops_gat.n_params(out_bias=True, residual=True,
                              **PUBLISHED) == 751_574
    assert flops_gat.layers(**PUBLISHED) == [(100, 4, 128, 512),
                                             (512, 4, 128, 512),
                                             (512, 4, 47, 47)]


def test_a_block_by_hand():
    # b 2 targets of n 3 rows, din 4, h 2 heads of w 5
    fwd = flops_gat.block_forward(2, 3, 4, 2, 5, 4)
    assert fwd.products == (2 * 2 * 4 * 5 + 2 * (2 * 2 * 3 * 4 * 2)
                            + 2 * 2 * 2 * 4 * 5)
    assert fwd.other == 5 * 2 * 3 * 2
    assert fwd.bytes == 2 * 3 * 4 * 4 + 4 * (40 + 10 + 4 + 20)
    bwd = flops_gat.block_backward(2, 3, 4, 2, 5, 4, d_nbr=False)
    with_nbr = flops_gat.block_backward(2, 3, 4, 2, 5, 4, d_nbr=True)
    assert with_nbr.products - bwd.products == 2 * 2 * 2 * 3 * 4 * 2
    assert with_nbr.bytes - bwd.bytes == 4 * 2 * 3 * 4


def test_the_cell_launches_six_blocks_each_way_and_four_gathers():
    cat = Catalog()
    cfg, wl = cat.config("gat-products"), cat.workload("gat-products.uniform")
    tr = wl["traffic"]
    gen = torch.Generator().manual_seed(0)
    shape = [512]
    rec = {"seeds": torch.randint(0, 1000, (512,), generator=gen)}
    for j, k in enumerate(tr["fanout"], 1):
        shape.append(k)
        rec["hop%d" % j] = torch.randint(0, 1000, tuple(shape), generator=gen)
    works = cat.module("models", "ego_gat").kernel_work(cfg, tr, rec, 4)
    assert [len(works[op]) for op in ("glt::gather_rows", "glt::gat_block",
                                      "glt::gat_block_backward")] == [4, 6, 6]
    # the largest block: 51 200 targets of 11 rows of 100 f32, 225 MB read
    assert max(w.bytes for w in works["glt::gat_block"]) > 51200 * 11 * 400
    # every gathered row of the step: 568 832
    assert sum(r.numel() for r in rec.values()) == 568_832


def test_the_step_needs_less_than_projecting_every_row():
    """The least association's products at the cell's shapes, against
    PyG's literal ones (every source row projected, forward only) as an
    upper reference: well below them, and the step's least time is a
    fraction of a millisecond."""
    w = flops_gat.gat_step(512, [10, 10, 10], self_loop=True, out_bias=True,
                           residual=True, **PUBLISHED)
    rows = flops_gat.hop_rows(512, [10, 10, 10])
    literal = sum(2.0 * rows[j] * 11 * din * h * wd
                  for i, (din, h, wd, _) in enumerate(
                      flops_gat.layers(**PUBLISHED))
                  for j in range(3 - i))
    assert w.products < literal
    assert 0.05e-3 < flops.compute_s(w, flops.load_peaks("h100_sxm")) < 0.5e-3


@pytest.mark.parametrize("part", ["self_loop", "out_bias", "residual"])
def test_the_build_takes_the_three_pyg_parts_together(part):
    """The port's ``EgoGAT`` has one option for the self-loop, the bias
    after aggregation and the skip; a configuration that turns one of
    them off alone is refused, not built as something else."""
    cat = Catalog([str(FIXTURES)])
    mod = cat.module("models", "ego_gat")
    cfg = {**cat.config("tiny-gat-products"), part: False}
    from graph_learn_tpu_torch.core.schema import Decoder
    with pytest.raises(ValueError, match="together"):
        mod.build(cfg, Decoder(labeled=True, attr_types=["float"] * 100),
                  torch.device("cpu"))
