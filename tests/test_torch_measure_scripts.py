"""The port's root measurement scripts (``graph_learn_tpu_torch/examples/
{gat_scale, segment_softmax_probe, scale_matrix, group_sweep, gather_micro,
host_overlap_probe}.py``) on the CPU at tiny sizes, against the JAX
package's scripts on the same numpy inputs; ``ShardedGraph.local``'s
device; and the port's serving manifest ``deploy/k8s/serving_torch.yaml``
against the port's config reader."""

import ast
import json
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.loss import supervised_softmax_loss as jax_sm_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGAT as JaxEgoGAT
from graph_learn_tpu.ops.pallas.dispatch import feature_gather as jax_gather
from graph_learn_tpu.core.values import Nodes as JaxNodes
from graph_learn_tpu_torch import bench as tbench
from graph_learn_tpu_torch.core.store import EdgeTable
from graph_learn_tpu_torch.errors import (DeviceUnavailableError,
                                          InvalidArgumentError)
from graph_learn_tpu_torch.examples import (gat_scale, gather_micro,
                                            group_sweep, host_overlap_probe,
                                            scale_matrix,
                                            segment_softmax_probe)
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.layers import ego as ego_layers
from graph_learn_tpu_torch.ops.kernels import dispatch
from graph_learn_tpu_torch.ops.lookup import lookup_nodes
from graph_learn_tpu_torch.online import serve_main
from graph_learn_tpu_torch.parallel.partition import partition_edges
from torch_parity import assert_trees_close, both_confs

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples"))
import bench as jbench  # noqa: E402  (the JAX bench at the repository root)
import gather_micro as jgather_micro  # noqa: E402
from segment_softmax_probe import make_pallas  # noqa: E402

SCRIPTS = (gat_scale, segment_softmax_probe, scale_matrix, group_sweep,
           gather_micro, host_overlap_probe)
TINY = dict(tbench.CFG_SMALL, n_nodes=2_000, avg_degree=8, feat_dim=12,
            hidden=16, batch=64, fanout=(5, 3), classes=5, steps=1,
            warmup=0, scan_steps=1)
HOPS = ["hop1", "hop2"]
# the tiny gather_micro shape: 192 draws in 48 groups of 4
MICRO = dict(n_rows=5_000, d=8, b=16, k1=3, k2=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- gat_scale -----------------------------------------------------------

def _jax_gat_step(cfg, pre, key):
    """One step of ``examples/gat_scale.py make_step(pre)`` (``:91-137``)
    outside the scan: the batch, the flax weights before, the weights
    after one Adam step, and the loss."""
    jg, jdec = jbench.build_graph_inmem(cfg)
    k1, k2 = cfg["fanout"]
    b, n = cfg["batch"], cfg["n_nodes"]
    jq = (jg.V("item").batch(b).alias("src")
          .outV("rel").sample(k1).by("random").alias("hop1")
          .outV("rel").sample(k2).by("random").alias("hop2").values())
    tables = jq.device_tables()
    ks, km, ksd = jax.random.split(key, 3)
    seeds = jax.random.randint(ksd, (b,), 0, n)
    batch = jax_execute(jq, tables, seeds, ks)
    model = JaxEgoGAT([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                      jdec, num_heads=[8, 1], seed_chunk=256)
    ego0 = jdata.EgoGraph.from_query_result(batch, "src", HOPS)
    params = model.init(jax.random.key(0), ego0, training=False)
    if pre == 1:
        ft = tables["nodes"]["item"].float_attrs
        ids2 = batch["hop2"].ids
        rows = jax_gather(ft, jnp.clip(ids2.reshape(-1), 0, n - 1))
        rows = rows.reshape(ids2.shape + (ft.shape[-1],))
        batch = dict(batch)
        batch["hop2"] = JaxNodes(ids=ids2, float_attrs=rows,
                                 type_name="item")

    def lf(pp):
        ego = jdata.EgoGraph.from_query_result(batch, "src", HOPS)
        logits = model.apply(pp, ego, training=True, rngs={"dropout": km})
        return jax_sm_loss(logits, batch["src"].labels)

    opt = optax.adam(tbench.LEARNING_RATE)
    loss, grads = jax.jit(jax.value_and_grad(jax.checkpoint(lf) if pre == 2
                                             else lf))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    ids = {a: np.array(batch[a].ids) for a in ("src", "hop1", "hop2")}
    return (ids, _np(params), _np(optax.apply_updates(params, updates)),
            float(loss))


def _port_tiny(cfg=TINY):
    g, dec = tbench.build_graph(cfg, "cpu")
    q = tbench.two_hop_query(g, cfg["batch"], cfg["fanout"])
    return g, dec, q, q.device_tables("cpu")


# the JAX step's own tolerances (tests/test_torch_bench.py): 1e-5 on the
# loss, and one Adam step of 1e-3 within rtol 1e-4 / atol 2e-5
@pytest.mark.parametrize("pre", gat_scale.VARIANTS)
def test_one_gat_scale_step_equals_the_jax_scripts_step(pre, monkeypatch):
    with both_confs(feature_dtype="float32"):
        ids, params, jparams, jloss = _jax_gat_step(TINY, pre,
                                                    jax.random.key(11))
        _, dec, q, tables = _port_tiny()
    nt = tables["nodes"]["item"]

    def jax_ids(q_, tables_, n, generator):
        return (torch.from_numpy(ids["src"]),
                {a: lookup_nodes(nt, torch.from_numpy(v), type_name="item")
                 for a, v in ids.items()})

    monkeypatch.setattr(tbench, "sample_one", jax_ids)
    model = gat_scale.make_model(TINY, dec, 256, "cpu")
    load_flax_params(model, params)
    step = gat_scale.GatSteps(q, tables, model,
                              tbench.make_optimizer(model,
                                                    torch.device("cpu")),
                              TINY, pre, torch.Generator().manual_seed(0),
                              capture=False)
    loss = step()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5, atol=1e-6)
    assert_trees_close(to_flax_params(model), jparams, rtol=1e-4, atol=2e-5)


def _counting(monkeypatch):
    """Count the gathers of feature rows and the gat_block forwards."""
    calls = {"gather_rows": 0, "gat_block": 0}
    real_gather, real_block = dispatch.gather_rows, ego_layers.gat_block

    def gather(*a):
        calls["gather_rows"] += 1
        return real_gather(*a)

    def block(*a):
        calls["gat_block"] += 1
        return real_block(*a)

    monkeypatch.setattr(dispatch, "gather_rows", gather)
    monkeypatch.setattr(ego_layers, "gat_block", block)
    return calls


def test_gat_scale_variants_give_the_same_k_step_losses(monkeypatch):
    cfg = dict(TINY, scan_steps=3)
    with both_confs(feature_dtype="float32"):
        _, dec, q, tables = _port_tiny(cfg)
    calls = _counting(monkeypatch)
    losses = {}
    for pre in gat_scale.VARIANTS:
        # unchunked: the plain version's chunks are more calls of it
        step = gat_scale.make_steps(q, tables, cfg, dec, pre, 0, "cpu")
        assert not step.capture
        for k in calls:
            calls[k] = 0
        step()
        losses[pre] = step.losses.clone()
        # the derived launches a step: gathers and forwards (the
        # backward's launches are counted on the card)
        want = gat_scale.launches_per_step(pre)
        assert calls == {k: want[k] * cfg["scan_steps"] for k in calls}, pre
    assert bool(torch.isfinite(losses[0]).all())
    assert not torch.equal(losses[0][0], losses[0][1])
    for pre in (1, 2):
        torch.testing.assert_close(losses[pre], losses[0], rtol=1e-6,
                                   atol=1e-7)


def test_gat_scale_run_and_env(monkeypatch):
    monkeypatch.setenv("GLT_GAT_CHUNKS", "0,256")
    monkeypatch.setenv("GLT_GAT_VARIANTS", "1")
    assert gat_scale.env_chunks() == [0, 256]
    assert gat_scale.env_variants() == (1,)
    monkeypatch.delenv("GLT_GAT_VARIANTS")
    assert gat_scale.env_variants() == (0, 1, 2)
    with both_confs(feature_dtype="float32"):
        r = gat_scale.run(dict(TINY, steps=2), "cpu", variants=(0, 2))
    assert [(x["chunk"], x["pre"]) for x in r["runs"]] == [
        (0, 0), (0, 2), (256, 0), (256, 2)]
    for x in r["runs"]:
        assert x["rounds"] == 2 and len(x["losses"]) == 3
        assert x["capture_s"] is None and x["edges_per_s"] > 0
    # the chunks cut the plain version's blocks only: the same losses
    np.testing.assert_allclose(r["runs"][0]["losses"], r["runs"][2]["losses"],
                               rtol=1e-5)
    with pytest.raises(ValueError, match="variant"):
        gat_scale.run(TINY, "cpu", variants=(3,))


def test_gat_scale_cfg_follows_the_bench(monkeypatch):
    monkeypatch.delenv("GLT_BENCH_SMALL", raising=False)
    assert gat_scale.scale_cfg(False) == tbench.CFG_SCALE
    assert gat_scale.scale_cfg(True) == tbench.CFG
    monkeypatch.setenv("GLT_BENCH_SMALL", "1")
    assert gat_scale.scale_cfg(True) == tbench.CFG_SMALL


# --- segment_softmax_probe -----------------------------------------------

def _probe_inputs(S, k2, D, H, W, n_blocks, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S * n_blocks * k2, D)).astype(np.float32)
    w, al, ar = ((rng.standard_normal(s) * 0.1).astype(np.float32)
                 for s in ((H, D, W), (H, 1, W), (H, 1, W)))
    return x, w, al, ar


def _jax_probe_formula(x, w, al, ar, k2):
    """``fwd_ref`` of examples/segment_softmax_probe.py:124-132."""
    n_seeds = x.shape[0] // k2
    H = w.shape[0]
    wx = jnp.einsum("nd,hdw->nhw", x, w)
    er = (wx * ar[:, 0][None]).sum(-1).reshape(n_seeds, k2, H)
    el = (wx * al[:, 0][None]).sum(-1).reshape(n_seeds, k2, H)[:, :1]
    alpha = jax.nn.softmax(jax.nn.leaky_relu(el + er, negative_slope=0.2),
                           axis=1)
    return np.asarray(jnp.einsum("skh,skhw->hsw", alpha,
                                 wx.reshape(n_seeds, k2, H, -1)))


def test_probe_variants_match_the_pallas_kernel_and_the_jax_formula():
    from jax.experimental.pallas import tpu as pltpu
    S, k2, D, H, W, n_blocks = 8, 4, 128, 2, 128, 2
    x, w, al, ar = _probe_inputs(S, k2, D, H, W, n_blocks)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(make_pallas(S, k2, D, H, W, n_blocks)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(al),
            jnp.asarray(ar)))
    formula = _jax_probe_formula(x, w, al, ar, k2)
    t = [torch.from_numpy(a) for a in (x, w, al, ar)]
    got = {"bar": segment_softmax_probe.bar(*t, k2),
           "chunked": segment_softmax_probe.chunked(*t, k2, S),
           "fused": segment_softmax_probe.fused(*t, k2)}
    tol = dict(rtol=segment_softmax_probe.CPU_TOL,
               atol=segment_softmax_probe.CPU_TOL)
    for name, out in got.items():
        assert out.shape == (H, S * n_blocks, W), name
        np.testing.assert_allclose(out.numpy(), kernel, err_msg=name, **tol)
        np.testing.assert_allclose(out.numpy(), formula, err_msg=name, **tol)


def test_probe_run_checks_and_times_on_the_cpu():
    r = segment_softmax_probe.run(small=True, steps=1, device="cpu")
    assert (r["seeds"], r["k2"], r["D"], r["heads"], r["width"],
            r["block"]) == (2048, 10, 128, 4, 128, 256)
    assert r["tol"] == segment_softmax_probe.CPU_TOL
    assert r["fused_max_abs_err"] <= r["tol"]
    assert r["fused_over_bar"] == r["bar_ms"] / r["fused_ms"]
    assert r["timer"] == "host clock" and r["device"] == "cpu"


# --- gather_micro --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_micro_checksums_equal_the_jax_variants(dtype):
    c = MICRO
    nseg, n = c["b"] * c["k1"], c["b"] * c["k1"] * c["k2"]
    r = gather_micro.run(dtype=dtype, iters=1, device="cpu", **c)
    # the JAX script's draws, in its order
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((c["n_rows"], c["d"]),
                                            np.float32).astype(
                                                jnp.dtype(dtype)))
    idx_np = rng.integers(0, c["n_rows"] - gather_micro.K - 1,
                          n).astype(np.int32)
    fns = jgather_micro.make_variants(c["n_rows"], nseg, c["k2"], c["d"])
    assert tuple(fns) == gather_micro.VARIANTS
    for name, fn in fns.items():
        arg = np.sort(idx_np) if name == "gather_presorted" else idx_np
        want = float(fn(table, jnp.asarray(arg)))
        # f32 sums of the same terms in other orders (argsort is stable in
        # both, so sort_only is exact)
        np.testing.assert_allclose(r["checksum"][name], want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the port's two routes of the same mean sum what plain sums
    for name in gather_micro.KERNEL_ROWS:
        np.testing.assert_allclose(r["checksum"][name], r["checksum"]["plain"],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert 0 <= r["max_abs_diff"] <= 1e-6
    assert all(r[name + "_ms"] > 0 for name in fns)


def test_gather_micro_draws_as_the_jax_script():
    table, idx = gather_micro.draw(100, 3, 7, "bfloat16")
    rng = np.random.default_rng(0)
    want = rng.standard_normal((100, 3), np.float32).astype(jnp.bfloat16)
    np.testing.assert_array_equal(table.float().numpy(),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, 100 - gather_micro.K - 1, 7))


# --- scale_matrix --------------------------------------------------------

def test_scale_matrix_runs_float32_then_bfloat16_on_one_store(monkeypatch):
    monkeypatch.delenv("GLT_USE_PALLAS", raising=False)
    graph = tbench.build_graph(TINY, "cpu")
    out = scale_matrix.run(TINY, "cpu", graph=graph)
    recs = [r["record"] for r in out]
    assert [r["feature_dtype"] for r in recs] == ["float32", "bfloat16"]
    for r, x in zip(recs, out):
        assert set(r) == {"metric", "feature_dtype", "value", "unit",
                          "wall_s"}
        assert r["metric"] == "ego_sage_scale62m_edges_per_s"
        assert r["unit"] == "edges/s/chip" and r["value"] > 0
        assert json.loads(json.dumps(r)) == r
        # each run's own table, the second not the first one kept
        assert x["table_dtype"] == r["feature_dtype"]
        assert x["bench"]["graph"] is graph
    n, d = TINY["n_nodes"], TINY["feat_dim"]
    assert [x["table_bytes"] for x in out] == [4 * n * d, 2 * n * d]


def test_scale_matrix_refuses_use_pallas(monkeypatch):
    monkeypatch.setenv("GLT_USE_PALLAS", "1")
    with pytest.raises(InvalidArgumentError, match="set_use_pallas"):
        scale_matrix.run(TINY, "cpu")


def test_node_table_drop_device_rebuilds_the_view_under_the_conf():
    g, _ = tbench.build_graph(TINY, "cpu")
    nt = g.store.node_table("item")
    with tbench.bench_conf(feature_dtype="float32"):
        first = nt.device("cpu")
    with tbench.bench_conf(feature_dtype="bfloat16"):
        assert nt.device("cpu") is first  # kept
        nt.drop_device("cpu")
        again = nt.device("cpu")
    assert first.float_attrs.dtype == torch.float32
    assert again.float_attrs.dtype == torch.bfloat16
    torch.testing.assert_close(again.float_attrs.float(),
                               first.float_attrs.to(torch.bfloat16).float())


# --- group_sweep ---------------------------------------------------------

@pytest.mark.parametrize("K", [1, 10, 20, 30, 40])
def test_group_sweep_skips_the_widths_the_jax_script_skips(K):
    jax_widths = [G for G in [1, 4, 10, 20] if not K % G]
    assert group_sweep.widths(K) == jax_widths


def test_group_sweep_runs_each_width_from_the_same_state():
    cfg = dict(TINY, scan_steps=4, steps=4)
    seen = []
    r = group_sweep.run(cfg, "cpu",
                        inspect=lambda G, step: seen.append((G, step.G)))
    assert r["K"] == 4 and r["skipped"] == [10, 20]
    assert [x["G"] for x in r["runs"]] == [1, 4] and seen == [(1, 1), (4, 4)]
    for x in r["runs"]:
        assert len(x["losses"]) == 8 and x["capture_s"] is None
    # the first step: same weights, same first batch in both widths
    np.testing.assert_allclose(r["runs"][0]["losses"][0],
                               r["runs"][1]["losses"][0], rtol=1e-6)
    assert group_sweep.launches_per_call(20, 4) == {"gather_rows": 40,
                                                    "segment_spmm": 5}


# --- host_overlap_probe --------------------------------------------------

def test_host_overlap_probe_lines_parse(capsys):
    host_overlap_probe.main(["--small", "--cpu", "--steps", "2",
                             "--window", "1,2"])
    lines = capsys.readouterr().out.strip().splitlines()
    head = re.match(r"t_host ([\d.]+) ms  t_dev ([\d.]+) ms  \(overlap "
                    r"ceiling ([\d.]+)x; cpu\)$", lines[0])
    assert head, lines[0]
    t_host, t_dev, ceil = map(float, head.groups())
    assert ceil == pytest.approx(host_overlap_probe.ceiling(t_host, t_dev),
                                 abs=0.011)
    assert [int(re.match(r"window=(\d+)  t_loop [\d.]+ ms  overlap "
                         r"[\d.]+x  [\d.]+M edges/s$", ln).group(1))
            for ln in lines[1:]] == [1, 2]


def test_host_overlap_probe_factor_and_launches():
    cfg = dict(TINY, batch=32)
    r = host_overlap_probe.run(cfg, steps=2, windows=(1, 2), device="cpu")
    assert r["launches"] == {"gather_rows": 0, "segment_spmm": 0}
    for w in r["windows"]:
        assert w["overlap"] == pytest.approx(
            (r["t_host_ms"] + r["t_dev_ms"]) / w["t_loop_ms"])
    assert r["ceiling"] == pytest.approx(
        (r["t_host_ms"] + r["t_dev_ms"]) / max(r["t_host_ms"],
                                               r["t_dev_ms"]))


# --- guards: no JAX, the card unless the CPU is asked for ---------------

BANNED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "graph_learn_tpu")


@pytest.mark.parametrize("mod", SCRIPTS, ids=lambda m: m.__name__)
def test_the_scripts_import_no_jax_and_are_guarded(mod):
    path = Path(mod.__file__).resolve()
    assert path.parent == REPO / "graph_learn_tpu_torch" / "examples"
    # tests/test_torch_guards.py walks every source of the package
    assert path in sorted((REPO / "graph_learn_tpu_torch").rglob("*.py"))
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not {n.split(".")[0] for n in names} & set(BANNED), names


ENTRIES = {
    "gat_scale": lambda: gat_scale.run(TINY),
    "gat_scale_main": lambda: gat_scale.main(["--small"]),
    "probe": lambda: segment_softmax_probe.run(small=True),
    "probe_main": lambda: segment_softmax_probe.main(["--small"]),
    "scale_matrix": lambda: scale_matrix.run(TINY),
    "scale_matrix_main": lambda: scale_matrix.main(["--small"]),
    "group_sweep": lambda: group_sweep.run(TINY),
    "group_sweep_main": lambda: group_sweep.main(["--small"]),
    "gather_micro": lambda: gather_micro.run(**MICRO),
    "gather_micro_main": lambda: gather_micro.main(["--small"]),
    "host_overlap": lambda: host_overlap_probe.run(TINY),
    "host_overlap_main": lambda: host_overlap_probe.main(["--small"]),
    "sharded_graph_local": lambda: _sharded().local(0),
}


def _sharded():
    rng = np.random.default_rng(0)
    et = EdgeTable("e", "v", "v", __import__(
        "graph_learn_tpu_torch").Decoder(),
        src=rng.integers(0, 20, 60), dst=rng.integers(0, 20, 60),
        num_src_nodes=20, num_dst_nodes=20)
    return partition_edges(et, 2)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_the_entry_points_raise_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GLT_USE_PALLAS", raising=False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        ENTRIES[entry]()


def test_sharded_graph_local_takes_the_cpu_when_asked():
    sg = _sharded()
    lg = sg.local(1, "cpu")
    assert lg.row_offsets.device.type == "cpu"
    np.testing.assert_array_equal(lg.nbr_local.numpy(), sg.nbr_local[1])


# --- the serving manifest ------------------------------------------------

MANIFEST = REPO / "deploy" / "k8s" / "serving_torch.yaml"


def _config_json(text: str) -> dict:
    """The ConfigMap's ``serving.json: |`` block (no YAML parser: the
    card's machine has none)."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.strip() == "serving.json: |")
    indent = len(lines[start + 1]) - len(lines[start + 1].lstrip())
    block = []
    for ln in lines[start + 1:]:
        if ln.strip() and len(ln) - len(ln.lstrip()) < indent:
            break
        block.append(ln)
    return json.loads("\n".join(block))


def test_the_manifest_starts_the_ports_worker_on_a_gpu():
    text = MANIFEST.read_text()
    cmd = re.search(r'command: \[(.*?)\]', text, re.S).group(1)
    assert [s.strip().strip('"') for s in cmd.split(",")] == [
        "python", "-m", "graph_learn_tpu_torch.online.serve_main",
        "--config", "/etc/glt/serving.json"]
    assert re.search(r'limits: \{nvidia\.com/gpu: "1"\}', text)
    assert "google.com/tpu" not in text
    assert "serving.yaml" in text.splitlines()[1]  # the header names it
    # the same config and probes as the JAX manifest, plus the device
    jax_text = (REPO / "deploy" / "k8s" / "serving.yaml").read_text()
    cfg, jcfg = _config_json(text), _config_json(jax_text)
    assert cfg == dict(jcfg, device="cuda")
    for probe in ("readinessProbe", "livenessProbe"):
        block = re.search(probe + r":\n((?:\s{12}.*\n)+)", text).group(1)
        assert block in jax_text, probe


def test_the_manifest_config_is_read_by_serve_main(tmp_path):
    cfg = _config_json(MANIFEST.read_text())
    data = tmp_path / "graph"
    data.mkdir()
    rng = np.random.default_rng(0)
    with open(data / "node_table", "w") as f:
        f.write("id:int64\tweight:float\tlabel:int64\tfeature:string\n")
        for i in range(30):
            f.write("%d\t1.0\t%d\t%s\n" % (i, i % 3, ":".join(
                "%.3f" % x for x in rng.random(4))))
    with open(data / "edge_table", "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for i in range(30):
            f.write("%d\t%d\t0.5\n" % (i, (i * 7 + 1) % 30))
    for part in cfg["nodes"] + cfg["edges"]:
        part["source"] = part["source"].replace("/data/graph", str(data))
    g = serve_main.graph_from_config(dict(cfg, device="cpu"))
    assert g.store.node_table("item").num_nodes == 30
    # undirected: each edge and its reverse
    assert g.store.edge_table("rel").num_edges == 60
    assert g.store.node_table("item").float_attrs.shape == (30, 4)


# --- chip_smoke.py phase 26 ------------------------------------------------

def test_chip_smoke_main_runs_phase_26():
    """main() runs 26a inside phase 11 on its store, before the store is
    freed, 26b after it, and merges both into the kernels line."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    calls = {n.func.id: n for n in ast.walk(main)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    scale = calls["a4_scale_path"]
    assert scale.args[-1].id == "scale_graph"
    assert calls["host_tier_path"].lineno < scale.lineno
    freed = next(n.lineno for n in ast.walk(main) if isinstance(n, ast.Delete)
                 and "scale_graph" in {t.id for t in n.targets})
    assert scale.lineno < freed < calls["a4_micro_path"].lineno
    assert {"a4_rows", "a4_micro_rows"} <= {
        n.id for n in ast.walk(main) if isinstance(n, ast.Name)}
