"""The 62M-edge frontier path of the port at a small size on the CPU:
``examples.scale_demo`` end to end, one of its training steps against the
same step of the JAX package on the same ids and weights (both routes of
the deepest-hop mean), and the sweep-aggregate harness."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.loss import \
    supervised_softmax_loss as jax_supervised_softmax_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGraphSAGE as JaxEgoGraphSAGE
from graph_learn_tpu.ops.lookup import lookup_nodes as jax_lookup_nodes
from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.examples import scale_demo, sweep_aggregate
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.ops.kernels import spmm, sweep
from torch_parity import (assert_trees_close, both_confs, flax_grad_tree,
                          jax_graph)

SIZE = dict(n_nodes=2_000, n_edges=20_000, feat_dim=12, classes=5)


def _arrays(g):
    nt, et = g.store.node_table("item"), g.store.edge_table("rel")
    return {"raw_ids": nt.raw_ids, "feats": nt.float_attrs,
            "labels": nt.labels, "src": et.src, "dst": et.dst,
            "weights": None}


def _community_graph(n, e, d, classes, seed=0):
    """Nodes linked to nodes of their own class, features that carry the
    class: a task a neighbour-mean model can learn."""
    import graph_learn_tpu_torch as glt
    rng = np.random.default_rng(seed)
    labels = np.sort(rng.integers(0, classes, n)).astype(np.int32)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats[np.arange(n), labels] += 3.0
    first = np.searchsorted(labels, np.arange(classes))
    count = np.bincount(labels, minlength=classes)
    src = rng.integers(0, n, e)
    dst = first[labels[src]] + rng.integers(0, 1 << 30, e) % count[labels[src]]
    dec = glt.Decoder(labeled=True, attr_types=["float"] * d)
    g = glt.Graph(device="cpu")
    g.add_node_table(glt.NodeTable("item", dec, np.arange(n, dtype=np.int64),
                                   float_attrs=feats, labels=labels))
    g.add_edge_table(glt.EdgeTable("rel", "item", "item", glt.Decoder(),
                                   src=src, dst=dst, num_src_nodes=n,
                                   num_dst_nodes=n))
    return g, dec


def test_scale_demo_runs_small_on_the_cpu_and_its_loss_falls():
    g, dec = _community_graph(*SIZE.values())
    before = (conf.storage_profile, conf.feature_dtype)
    r = scale_demo.run(batch=64, fanout=(5, 3), steps=120, warmup=0,
                       device="cpu", graph=(g, dec), **SIZE)
    assert (conf.storage_profile, conf.feature_dtype) == before
    losses = np.asarray(r["losses"])
    assert losses.shape == (120,) and np.isfinite(losses).all()
    assert losses[-20:].mean() < 0.5 * losses[:20].mean(), losses
    assert r["device"] == "cpu" and "device_bytes_peak" not in r
    assert r["edges_per_s"] > 0 and r["step_ms"] > 0
    # the frontier store: forward CSR only, bf16 features
    tables = r["query"].device_tables("cpu")
    assert tables["edges"]["rel"].inc is None
    assert tables["edges"]["rel"].out.cum_in_degrees is None
    assert tables["nodes"]["item"].float_attrs.dtype == torch.bfloat16


def test_scale_demo_draws_the_graph_as_the_jax_script_does():
    g, _ = scale_demo.build_graph(device="cpu", seed=0, **SIZE)
    n, e, d, classes = SIZE.values()
    rng = np.random.default_rng(0)  # examples/scale_demo.py:39-51
    feats = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    a = _arrays(g)
    for got, want in ((a["feats"], feats), (a["labels"], labels),
                      (a["src"], src), (a["dst"], dst)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sorted_on", [False, True])
def test_one_scale_demo_step_equals_the_jax_step(sorted_on):
    hidden, batch, fanout, lr = 16, 64, (5, 3), 1e-3
    with both_confs(storage_profile="minimal", feature_dtype="bfloat16",
                    sorted_gather=sorted_on, sorted_gather_min_bytes=0):
        g, dec = scale_demo.build_graph(device="cpu", **SIZE)
        jg, jdec = jax_graph(_arrays(g))
        q = scale_demo.two_hop_query(g, batch, fanout)
        tables = q.device_tables("cpu")
        gen = torch.Generator().manual_seed(3)
        seeds = torch.randint(0, SIZE["n_nodes"], (batch,), generator=gen,
                              dtype=torch.int32)
        launches = (spmm.LAUNCHES.count, sweep.LAUNCHES_SWEEP.count)
        tbatch = scale_demo.sample_batch(q, tables, seeds, gen)
        assert (spmm.LAUNCHES.count,
                sweep.LAUNCHES_SWEEP.count) == launches  # CPU: plain

        # the same ids through the JAX package's lookups and reduction
        jnt = jg.store.node_table("item").device()
        jbatch = {a: jax_lookup_nodes(jnt, jnp.asarray(v.ids.numpy()),
                                      type_name="item")
                  for a, v in tbatch.items()}
        jbatch = jdata.pre_aggregate_hop(jbatch, "hop2", jnt.float_attrs,
                                         "mean")
    np.testing.assert_allclose(
        tbatch["hop2"].float_attrs.agg.numpy(),
        np.asarray(jbatch["hop2"].float_attrs.agg), rtol=1e-5, atol=1e-6)

    dims = [SIZE["feat_dim"], hidden, SIZE["classes"]]
    jmodel = JaxEgoGraphSAGE(dims, jdec, agg_type="gcn")
    tmodel = EgoGraphSAGE(dims, dec, agg_type="gcn", device="cpu")
    jego = jdata.EgoGraph.from_query_result(jbatch, "src", scale_demo.HOPS)
    params = jmodel.init(jax.random.key(0), jego, training=False)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))

    def jloss(p):
        return jax_supervised_softmax_loss(
            jmodel.apply(p, jego, training=True), jbatch["src"].labels)

    jval, jgrads = jax.value_and_grad(jloss)(params)
    opt = optax.adam(lr)
    updates, _ = opt.update(jgrads, opt.init(params), params)
    jparams = optax.apply_updates(params, updates)

    topt = torch.optim.Adam(tmodel.parameters(), lr=lr)
    tval = scale_demo.loss_of(tmodel, tbatch)
    topt.zero_grad()
    tval.backward()
    # f32 forward and backward in other summation orders (as
    # tests/test_torch_trainer.py holds a step): 1e-5 on the loss, 1e-4 on
    # the gradients, and one Adam step of 1e-3 within 2e-5
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5, atol=1e-6)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    assert_trees_close(flax_grad_tree(tmodel), to_np(jgrads), rtol=1e-4,
                       atol=1e-5)
    topt.step()
    assert_trees_close(to_flax_params(tmodel), to_np(jparams), rtol=1e-4,
                       atol=2e-5)


def test_both_routes_of_the_deepest_hop_give_the_same_first_loss():
    losses = []
    for sorted_on in (False, True):
        with both_confs(sorted_gather=sorted_on, sorted_gather_min_bytes=0):
            r = scale_demo.run(batch=32, fanout=(4, 3), steps=3, warmup=0,
                               device="cpu", **SIZE)
        losses.append(r["losses"])
    # the same generator seed, so the same ids: only the order of the
    # deepest hop's f32 sums differs
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_sweep_harness_runs_small_on_the_cpu():
    r = sweep_aggregate.run(small=True, steps=2, device="cpu")
    assert r["device"] == "cpu" and r["timer"] == "host clock"
    assert (r["n_rows"], r["n_hits"], r["k"], r["groups"]) == (
        20_000, 16_384, 8, 2_048)
    for key in ("bar_ms", "bar_plain_ms", "prep_ms", "stream_ms", "sweep_ms"):
        assert r[key] > 0
    assert r["total_ms"] == r["prep_ms"] + r["sweep_ms"]
    assert r["sweep_max_abs_err"] <= 1e-5
    assert conf.sorted_gather is False
    assert sweep_aggregate.main(["--small", "--cpu", "--steps", "1"]) == 0
    assert scale_demo.main(["--small", "--cpu", "--steps", "2"]) == 0
