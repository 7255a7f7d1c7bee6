"""The port's bench (graph_learn_tpu_torch/bench.py) on the CPU: its graph
against ``bench.build_graph_inmem``, one call of its K-step function against
``bench.make_multi_step`` itself on the same ids and weights, K steps a
call against K single steps, its JSON lines (``tests/test_bench_contract.py``
ported), and the guard that keeps the step capturable in a CUDA graph."""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.models.ego_gnn import EgoGraphSAGE as JaxEgoGraphSAGE
from graph_learn_tpu_torch import bench as tbench
from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.gsl.compile import _execute
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.data import PreAggregatedRows
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.ops.lookup import lookup_nodes
from torch_parity import assert_trees_close, both_confs

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench as jbench  # noqa: E402  (the JAX bench at the repository root)

TINY = dict(tbench.CFG_SMALL, n_nodes=2_000, avg_degree=8, feat_dim=12,
            hidden=16, batch=64, fanout=(5, 3), classes=5, steps=1,
            warmup=0, scan_steps=1)
AUX = ("nbr_ids_sorted", "nbr_edge_ids_sorted", "cum_weights",
       "cum_in_degrees")


@pytest.mark.parametrize("profile", ["full", "minimal"])
def test_the_bench_graph_equals_build_graph_inmem(profile):
    cfg = tbench.CFG_SMALL
    with both_confs(storage_profile=profile):
        jg, _ = jbench.build_graph_inmem(cfg)
        tg, _ = tbench.build_graph(cfg, "cpu")
        jcsr = jg.store.edge_table("rel").device().out
        tcsr = tg.store.edge_table("rel").device("cpu").out
    for name in ("row_offsets", "nbr_ids", "nbr_edge_ids") + AUX:
        j, t = getattr(jcsr, name), getattr(tcsr, name)
        if profile == "minimal" and name in AUX:
            assert j is None and t is None, name
            continue
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    jet, tet = jg.store.edge_table("rel"), tg.store.edge_table("rel")
    np.testing.assert_array_equal(tet.weights, jet.weights)
    jnt, tnt = jg.store.node_table("item"), tg.store.node_table("item")
    np.testing.assert_array_equal(tnt.float_attrs, jnt.float_attrs)
    np.testing.assert_array_equal(tnt.labels, jnt.labels)
    assert tcsr.num_edges == cfg["n_nodes"] * cfg["avg_degree"]


def _jax_step(cfg, key):
    """``bench.make_multi_step`` at K = G = 1 from fresh parameters, and
    the batch it samples inside (the same key splits, outside the jit)."""
    jg, jdec = jbench.build_graph_inmem(cfg)
    k1, k2 = cfg["fanout"]
    jq = (jg.V("item").batch(cfg["batch"]).alias("src")
          .outV("rel").sample(k1).by("random").alias("hop1")
          .outV("rel").sample(k2).by("random").alias("hop2").values())
    tables = jq.device_tables()
    gk = jax.random.split(key, 1)[0]
    kexec, _ = jax.random.split(gk)
    ks, ksd = jax.random.split(jax.random.split(kexec, 1)[0])
    seeds = jax.random.randint(ksd, (cfg["batch"],), 0, cfg["n_nodes"])
    batch = jax_execute(jq, tables, seeds, ks)
    model = JaxEgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                            jdec, agg_type="gcn")
    ego0 = jdata.EgoGraph.from_query_result(batch, "src", ["hop1", "hop2"])
    params = model.init(jax.random.key(0), ego0, training=False)
    opt = optax.adam(tbench.LEARNING_RATE)
    step = jbench.make_multi_step(jq, tables, model, opt, cfg, 1)
    new_params, _, loss = step(params, opt.init(params), tables, key)
    ids = {a: np.array(batch[a].ids) for a in ("src", "hop1", "hop2")}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ids, to_np(params), to_np(new_params), float(loss)


# the JAX step's own tolerances (tests/test_torch_scale.py): 1e-5 on the
# loss, and one Adam step of 1e-3 within 2e-5.  bf16 features: the same
# bf16 values reach both packages' f32 arithmetic, so the same limits hold
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_port_step_equals_the_jax_bench_step(dtype, monkeypatch):
    with both_confs(feature_dtype=dtype):
        ids, params, jparams, jloss = _jax_step(TINY, jax.random.key(100))
        tg, tdec = tbench.build_graph(TINY, "cpu")
        q = tbench.two_hop_query(tg, TINY["batch"], TINY["fanout"])
        tables = q.device_tables("cpu")
    nt = tables["nodes"]["item"]

    def jax_ids(q_, tables_, n, generator):
        # JAX's batch, through the port's lookups
        return (torch.from_numpy(ids["src"]),
                {a: lookup_nodes(nt, torch.from_numpy(v), type_name="item")
                 for a, v in ids.items()})

    monkeypatch.setattr(tbench, "sample_one", jax_ids)
    dims = [TINY["feat_dim"], TINY["hidden"], TINY["classes"]]
    model = EgoGraphSAGE(dims, tdec, agg_type="gcn", device="cpu")
    load_flax_params(model, params)
    step = tbench.make_multi_step(q, tables, model,
                                  tbench.make_optimizer(model,
                                                        torch.device("cpu")),
                                  TINY, 1, torch.Generator().manual_seed(0))
    assert not step.capture
    loss = step()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5, atol=1e-6)
    assert_trees_close(to_flax_params(model), jparams, rtol=1e-4, atol=2e-5)


def _port_run(cfg, K, G, calls):
    """``calls`` calls of a fresh K-step function from the same graph,
    model weights and generator seed: (losses of every step, parameters)."""
    cfg = dict(cfg, scan_steps=K)
    g, dec = tbench.build_graph(cfg, "cpu")
    q = tbench.two_hop_query(g, cfg["batch"], cfg["fanout"])
    model = EgoGraphSAGE([cfg["feat_dim"], cfg["hidden"], cfg["classes"]],
                         dec, agg_type="gcn", device="cpu")
    step = tbench.make_multi_step(
        q, q.device_tables("cpu"), model,
        tbench.make_optimizer(model, torch.device("cpu")), cfg, G,
        torch.Generator().manual_seed(7))
    losses = []
    for _ in range(calls):
        step()
        losses.append(step.losses.clone())
    return torch.cat(losses), [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("G", [1, 3])
def test_k_steps_a_call_equal_k_single_steps_bit_for_bit(G):
    losses, params = _port_run(TINY, 3, G, 1)
    one_losses, one_params = _port_run(TINY, 1, 1, 3)
    assert torch.equal(losses, one_losses), (losses, one_losses)
    assert all(torch.equal(a, b) for a, b in zip(params, one_params))
    assert bool(torch.isfinite(losses).all())


def test_the_bench_makes_no_host_tensor_and_reads_nothing_back(monkeypatch):
    """What a CUDA graph cannot capture: a tensor made from Python data
    (a host-to-device copy) or a value read back (a sync).  No function of
    the port on the plan's or the step's path calls one."""
    g, dec = tbench.build_graph(TINY, "cpu")
    q = tbench.two_hop_query(g, TINY["batch"], TINY["fanout"])
    tables = q.device_tables("cpu")
    model = EgoGraphSAGE([TINY["feat_dim"], TINY["hidden"], TINY["classes"]],
                         dec, agg_type="gcn", device="cpu")
    step = tbench.make_multi_step(
        q, tables, model, tbench.make_optimizer(model, torch.device("cpu")),
        dict(TINY, scan_steps=2), 1, torch.Generator().manual_seed(0))
    calls = []
    _guard_host_tensors(monkeypatch, calls)
    seeds = torch.randint(0, TINY["n_nodes"], (TINY["batch"],),
                          dtype=torch.int32)
    out = _execute(q, tables, seeds, torch.Generator().manual_seed(1))
    loss = step()
    monkeypatch.undo()
    assert calls == []
    assert out["hop2"].ids.shape == (TINY["batch"],) + TINY["fanout"]
    assert np.isfinite(loss.item())


def _guard_host_tensors(monkeypatch, calls):
    """Make torch.tensor / as_tensor and Tensor.item / tolist / cpu / numpy
    raise when a function of the port calls them."""
    def guard(name, fn):
        def wrapped(*args, **kwargs):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("graph_learn_tpu_torch"):
                calls.append((name, caller))
                raise AssertionError("%s called from %s" % (name, caller))
            return fn(*args, **kwargs)
        return wrapped

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, guard(name, getattr(torch, name)))
    for name in ("item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name,
                            guard(name, getattr(torch.Tensor, name)))


@pytest.mark.parametrize("neg", ["random", "in_degree", "node_weight"])
def test_the_bipartite_plan_makes_no_host_tensor_and_reads_nothing_back(
        neg, monkeypatch):
    """The same guard over the bipartite path: ``source_e``, the endpoint
    views, ``edge_payload`` (an outE hop), ``negative_sample`` and
    family_scale's K-step function."""
    from graph_learn_tpu_torch.examples import family_scale as fs
    from torch_parity import torch_u2i_graph, u2i_arrays
    g = torch_u2i_graph(u2i_arrays(seed=1))[0]
    seed = g.E("u-i").batch(16).alias("seed")
    src, dst = seed.outV().alias("src"), seed.inV().alias("dst")
    src.outNeg("u-i").sample(2).by(neg).alias("neg")
    dst.inNeg("u-i").sample(2).by("in_degree").alias("ineg")
    src.Neg("i").sample(2).by(neg if neg != "in_degree" else "random") \
        .alias("nneg")
    src.outE("u-i").sample(3).by("random").alias("e")
    q = seed.values()
    tables = q.device_tables("cpu")
    cfg = dict(tbench.CFG_SMALL, n_nodes=400, avg_degree=4, feat_dim=8,
               hidden=16, batch=32, scan_steps=2)
    with both_confs(storage_profile="full"):
        graph = fs.build_graph(cfg, "cpu")
        fq = fs.build_query(graph[0], 32, 4, 2)
        ftables = fq.device_tables("cpu")
    model = fs.towers(graph[1], graph[2], 16, "cpu")
    step = fs.BipartiteSteps(fq, ftables, model,
                             tbench.make_optimizer(model,
                                                   torch.device("cpu")),
                             cfg, torch.Generator().manual_seed(0), False)
    calls = []
    _guard_host_tensors(monkeypatch, calls)
    seeds = torch.randint(0, 400, (16,), dtype=torch.int32)
    out = _execute(q, tables, seeds, torch.Generator().manual_seed(1))
    loss = step()
    monkeypatch.undo()
    assert calls == []
    assert out["e"].weights.shape == (16, 3) and out["neg"].ids.shape == (
        16, 2)
    assert torch.equal(out["src"].ids, out["seed"].src_ids)
    assert np.isfinite(loss.item())


@pytest.mark.parametrize("defer", [False, True])
def test_the_rgcn_plan_makes_no_host_tensor_and_reads_nothing_back(
        defer, monkeypatch):
    """The same guard over the rgcn family: its six-hop plan over two
    relations, the gathers or the deepest level's pre-reduction, and its
    K-step function."""
    from graph_learn_tpu_torch.examples import family_scale as fs
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoRGCN
    cfg = dict(tbench.CFG_SMALL, n_nodes=400, avg_degree=6, feat_dim=8,
               hidden=16, classes=5, batch=32, scan_steps=2)
    with both_confs(storage_profile="minimal"):
        g, dec = fs.build_rgcn_graph(cfg, "cpu")
        q, aliases = fs.rgcn_query(g, fs.Mask.NONE, 32, (4, 2))
        tables = q.device_tables("cpu")
    model = EgoRGCN([8, 16, 5], dec, num_relations=2, num_bases=1,
                    device="cpu")
    step = fs.RGCNSteps(q, tables, model,
                        tbench.make_optimizer(model, torch.device("cpu")),
                        cfg, aliases, (4, 2), defer,
                        torch.Generator().manual_seed(0), False)
    calls = []
    _guard_host_tensors(monkeypatch, calls)
    seeds = torch.randint(0, 400, (32,), dtype=torch.int32)
    out = step.prepare(_execute(q, tables, seeds,
                                torch.Generator().manual_seed(1)))
    loss = step()
    monkeypatch.undo()
    assert calls == []
    assert out["r1_r1_h2"].ids.shape == (32, 4, 2)
    assert isinstance(out["r1_r1_h2"].float_attrs, PreAggregatedRows) is defer
    assert np.isfinite(loss.item())


@pytest.mark.parametrize("strategy", ["edge_weight", "random", "in_degree",
                                      "random_without_replacement", "topk",
                                      "full"])
def test_the_temporal_plan_makes_no_host_tensor_and_reads_nothing_back(
        strategy, monkeypatch):
    """The same guard over the temporal family: ``source_e`` with its
    timestamps, the endpoint view, every temporal strategy's cut-off
    bisection and draw (ops/temporal.py), ``hop_ts``, and family_scale's
    K-step function."""
    from graph_learn_tpu_torch.examples import family_scale as fs
    cfg = dict(tbench.CFG_SMALL, n_nodes=400, avg_degree=6, feat_dim=8,
               hidden=16, classes=5, batch=32, scan_steps=2)
    with both_confs(storage_profile="full"):
        g, dec = fs.build_temporal_graph(cfg, "cpu")
        q = fs.temporal_query(g, 32, (4, 2))
        tables = q.device_tables("cpu")
        seed = g.E("rel").batch(32).alias("ev")
        (seed.outV().alias("src").outV("rel").sample(4).by(strategy)
         .alias("h1").outE("rel").sample(3).by(strategy).alias("e2"))
        sq = seed.values()
        stables = sq.device_tables("cpu")
    model = EgoGraphSAGE([8, 16, 5], dec, agg_type="gcn", device="cpu")
    step = fs.TemporalSteps(q, tables, model,
                            tbench.make_optimizer(model,
                                                  torch.device("cpu")),
                            cfg, torch.Generator().manual_seed(0), False)
    calls = []
    _guard_host_tensors(monkeypatch, calls)
    seeds = torch.randint(0, 2400, (32,), dtype=torch.int32)
    out = _execute(sq, stables, seeds, torch.Generator().manual_seed(1))
    loss = step()
    monkeypatch.undo()
    assert calls == []
    # a full hop answers SparseNodes [rows, cap], on an edge hop too
    if strategy == "full":
        assert out["e2"].ids.shape == (128, 3)
    else:
        assert out["e2"].timestamps.shape == (32, 4, 3)
    assert np.isfinite(loss.item())


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]


@pytest.fixture
def bench_env(monkeypatch):
    """The port's main() on the CPU, with fake runs."""
    for name in ("GLT_BENCH_SMALL", "GLT_BENCH_SCALE", "GLT_BENCH_NO_SCALE",
                 "GLT_BENCH_GROUP", "GLT_FEATURE_DTYPE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GLT_PLATFORM", "cpu")
    return monkeypatch


def test_two_lines_headline_then_scale(bench_env):
    calls = []

    def fake_run(cfg, device):
        calls.append((cfg, device, conf.storage_profile, conf.feature_dtype))
        return {"edges_per_s": 54e6 if cfg is tbench.CFG_SCALE else 134e6}

    bench_env.setattr(tbench, "run_bench", fake_run)
    before = (conf.storage_profile, conf.feature_dtype)
    first, last = _lines(tbench.main)
    assert [c[0] for c in calls] == [tbench.CFG, tbench.CFG_SCALE]
    assert [c[1:] for c in calls] == [("cpu", before[0], "bfloat16"),
                                      ("cpu", "minimal", "bfloat16")]
    assert (conf.storage_profile, conf.feature_dtype) == before
    assert first["metric"] == last["metric"] == "ego_sage_train_edges_per_s"
    assert first["unit"] == "edges/s/chip"
    assert "ego_sage_scale62m_edges_per_s" not in first
    assert last["ego_sage_scale62m_edges_per_s"] == 54e6
    # no baseline the port measures: null, as on the scale line
    assert last["vs_baseline"] is None and first["vs_baseline"] is None
    # the TPU record ratio is left out
    assert "scale62m_vs_r02_record" not in last


def test_headline_survives_scale_phase_crash(bench_env):
    def fake_run(cfg, device):
        if cfg is tbench.CFG_SCALE:
            raise RuntimeError("killed mid-scale")
        return {"edges_per_s": 134e6}

    bench_env.setattr(tbench, "run_bench", fake_run)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with pytest.raises(RuntimeError):
            tbench.main()
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]
    assert len(recs) == 1 and recs[0]["value"] == 134e6


def test_scale_env_flag_single_line(bench_env):
    bench_env.setenv("GLT_BENCH_SCALE", "1")
    bench_env.setattr(tbench, "run_bench",
                      lambda cfg, device: {"edges_per_s": 54e6})
    (rec,) = _lines(tbench.main)
    assert rec == {"metric": "ego_sage_scale62m_edges_per_s",
                   "value": 54e6, "unit": "edges/s/chip",
                   "vs_baseline": None}


def test_small_cpu_run_prints_the_headline(monkeypatch):
    monkeypatch.setenv("GLT_PLATFORM", "cpu")
    monkeypatch.setenv("GLT_BENCH_SMALL", "1")
    monkeypatch.delenv("GLT_BENCH_SCALE", raising=False)
    before = (conf.storage_profile, conf.feature_dtype)

    def no_subprocess(*args, **kwargs):
        raise AssertionError("the bench started a subprocess")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    (rec,) = _lines(tbench.main)
    assert (conf.storage_profile, conf.feature_dtype) == before
    assert sorted(rec) == ["metric", "unit", "value", "vs_baseline"]
    assert rec["metric"] == "ego_sage_train_edges_per_s" and rec["value"] > 0
    assert rec["vs_baseline"] is None


def test_run_bench_on_the_cpu_returns_its_numbers():
    r = tbench.run_bench(dict(TINY, steps=4, warmup=1, scan_steps=2), "cpu")
    assert r["device"] == "cpu" and r["capture"] is False
    assert (r["K"], r["G"], r["rounds"]) == (2, 1, 2)
    assert len(r["losses"]) == 2 * (1 + 2)
    assert np.isfinite(r["losses"]).all()
    assert r["edges_per_s"] > 0 and r["step_ms"] > 0
    assert r["capture_s"] is None and r["graph_pool_bytes"] is None
    assert "device_bytes_peak" not in r
    with pytest.raises(Exception, match="CUDA generator"):
        tbench.make_multi_step(r["query"], r["tables"], r["model"],
                               r["optimizer"], TINY, 1, r["generator"],
                               capture=True)


@pytest.mark.parametrize("K,want", [(30, 3), (20, 4), (6, 3), (7, 1)])
def test_the_group_is_the_largest_divisor_of_k_not_above_the_request(
        monkeypatch, K, want):
    monkeypatch.setenv("GLT_BENCH_GROUP", "4")
    assert tbench.group_size(dict(TINY, scan_steps=K)) == want
    monkeypatch.delenv("GLT_BENCH_GROUP")
    assert tbench.group_size(dict(TINY, scan_steps=K)) == 1
