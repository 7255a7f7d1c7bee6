"""The port's training slice on the CPU against the JAX package: single
train steps and Adam on a fixed batch, the whole LocalTrainer on a graph
whose sampling is deterministic, Dataset epoch semantics, evaluate, and a
toy task whose loss falls."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.gsl import plan as jplan
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.loss import \
    supervised_softmax_loss as jax_supervised_softmax_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGAT as JaxEgoGAT
from graph_learn_tpu.nn.models.ego_gnn import EgoGraphSAGE as JaxEgoGraphSAGE
from graph_learn_tpu.nn.trainer import LocalTrainer as JaxLocalTrainer
from graph_learn_tpu_torch.errors import (InvalidArgumentError,
                                          OutOfRangeError)
from graph_learn_tpu_torch.gsl import plan as tplan
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT, EgoGraphSAGE
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.ops.kernels import spmm
from torch_parity import (assert_trees_close, degree_one_graph, ego_pair,
                          flax_grad_tree, jax_graph, torch_graph)

HOPS = ["hop1", "hop2"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(kind, d, hidden, classes, jdec=None, tdec=None):
    jdec = jdec or JaxDecoder(attr_types=["float"] * d)
    tdec = tdec or glt.Decoder(attr_types=["float"] * d)
    dims = [d, hidden, classes]
    if kind == "gat":
        return (JaxEgoGAT(dims, jdec, num_heads=[2, 1]),
                EgoGAT(dims, tdec, num_heads=[2, 1], device="cpu"))
    return (JaxEgoGraphSAGE(dims, jdec, agg_type="gcn"),
            EgoGraphSAGE(dims, tdec, agg_type="gcn", device="cpu"))


# --- (a) train steps on a fixed batch ------------------------------------

@pytest.mark.parametrize("kind,mode", [("sage", "materialised"),
                                       ("sage", "preagg"),
                                       ("sage", "deferred"),
                                       ("gat", "materialised"),
                                       ("gat", "deferred")])
def test_train_steps_on_a_fixed_batch_match_flax_and_optax(kind, mode):
    d, lr, steps = 8, 1e-2, 5
    jego, tego, labels = ego_pair(d, mode)
    plain, _, _ = ego_pair(d)
    jmodel, tmodel = _models(kind, d, 16, 4)
    params = jmodel.init(jax.random.key(0), plain, training=False)
    load_flax_params(tmodel, _np(params))
    jl, tl = jnp.asarray(labels), torch.from_numpy(labels)

    def jloss(p):
        return jax_supervised_softmax_loss(
            jmodel.apply(p, jego, training=True), jl)

    opt = optax.adam(lr)
    opt_state = opt.init(params)
    topt = torch.optim.Adam(tmodel.parameters(), lr=lr)
    for step in range(steps):
        jval, jgrads = jax.value_and_grad(jloss)(params)
        tval = supervised_softmax_loss(tmodel(tego, training=True), tl)
        topt.zero_grad()
        tval.backward()
        # f32 forward and backward in other summation orders: 1e-5 on the
        # loss; 1e-4 on gradients (sums over the batch of O(1) terms)
        np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5,
                                   atol=1e-6)
        if step == 0:
            assert_trees_close(flax_grad_tree(tmodel), _np(jgrads),
                               rtol=1e-4, atol=1e-5)
        updates, opt_state = opt.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        topt.step()
    # Adam divides by sqrt(v): a gradient error of 1e-5 relative moves a
    # step of lr = 1e-2 by 1e-7; five steps stay within 2e-5
    assert_trees_close(to_flax_params(tmodel), _np(params), rtol=1e-4,
                       atol=2e-5)


# --- (b) the whole trainer on a deterministic graph --------------------

def _queries(a, batch, k1=2, k2=2, shuffle=True):
    """The same 2-hop query on both packages' graphs of ``a``."""
    out = []
    for g, dec in (jax_graph(a), torch_graph(a)):
        src = g.V("item").batch(batch)
        if shuffle:
            src = src.shuffle(traverse=True)
        q = (src.alias("src").outV("rel").sample(k1).by("random")
             .alias("hop1").outV("rel").sample(k2).by("random").alias("hop2")
             .values())
        out.append((q, dec))
    return out


def _jax_loss_fn(model, p, batch, rng, training):
    ego = jdata.EgoGraph.from_query_result(batch, "src", HOPS)
    logits = model.apply(p, ego, training=training, rngs={"dropout": rng})
    return jax_supervised_softmax_loss(logits, batch["src"].labels)


def _loss_fn(model, batch, generator, training):
    ego = tdata.EgoGraph.from_query_result(batch, "src", HOPS)
    logits = model(ego, training=training, generator=generator)
    return supervised_softmax_loss(logits, batch["src"].labels)


def _jax_pre_aggregate(batch, tables):
    return jdata.pre_aggregate_hop(
        batch, "hop2", tables["nodes"]["item"].float_attrs, op="mean")


def _pre_aggregate(batch, tables):
    return tdata.pre_aggregate_hop(
        batch, "hop2", tables["nodes"]["item"].float_attrs, op="mean")


@pytest.mark.parametrize("kind,pre", [("sage", False), ("sage", True),
                                      ("gat", False)])
def test_local_trainer_loss_history_matches_the_jax_trainer(kind, pre):
    """Every node has out-degree 1, so both packages sample the same
    neighbours; with the same shuffle seed, carried weights and Adam the
    per-epoch mean losses agree."""
    a = degree_one_graph(n=40, d=8, classes=3, seed=1)
    (jq, jdec), (tq, tdec) = _queries(a, batch=16)  # 40 = 16 + 16 + 8 padded
    jmodel, tmodel = _models(kind, 8, 16, 3, jdec, tdec)
    ego0 = jdata.EgoGraph.from_query_result(
        gl.Dataset(jq, window=1).next(), "src", HOPS)
    params = jmodel.init(jax.random.key(0), ego0, training=False)
    load_flax_params(tmodel, _np(params))
    jparams, jhist = JaxLocalTrainer(seed=5).train(
        jq, jmodel, params, _jax_loss_fn, optax.adam(1e-2), epochs=3,
        verbose=False, batch_transform=_jax_pre_aggregate if pre else None)
    model, hist = LocalTrainer(seed=5, device="cpu").train(
        tq, tmodel, _loss_fn, torch.optim.Adam(tmodel.parameters(), lr=1e-2),
        epochs=3, verbose=False,
        batch_transform=_pre_aggregate if pre else None)
    assert model is tmodel and len(hist) == 3
    # 9 Adam steps from equal weights on equal batches: 1e-4
    np.testing.assert_allclose(hist, jhist, rtol=1e-4, atol=1e-5)
    assert_trees_close(to_flax_params(tmodel), _np(jparams), rtol=1e-3,
                       atol=1e-4)


def test_batch_transform_runs_kernel_two_outside_the_gradient():
    a = degree_one_graph(n=20, d=8, seed=2)
    _, (tq, tdec) = _queries(a, batch=8)
    _, tmodel = _models("sage", 8, 16, 3, tdec=tdec)
    calls = []
    plain = spmm.segment_spmm_plain

    def spy(*args):
        calls.append(torch.is_grad_enabled())
        return plain(*args)

    spmm.segment_spmm_plain = spy
    try:
        LocalTrainer(device="cpu").train(
            tq, tmodel, _loss_fn, torch.optim.Adam(tmodel.parameters()),
            epochs=1, verbose=False, batch_transform=_pre_aggregate)
    finally:
        spmm.segment_spmm_plain = plain
    assert calls == [False, False, False]  # one per step, never in the graph


def test_random_source_needs_steps_per_epoch():
    a = degree_one_graph(n=20, d=8, seed=2)
    tg, tdec = torch_graph(a)
    q = (tg.V("item").batch(8).shuffle().alias("src").outV("rel").sample(2)
         .by("random").alias("hop1").outV("rel").sample(2).by("random")
         .alias("hop2").values())
    assert q.source.strategy == "random"
    _, tmodel = _models("sage", 8, 16, 3, tdec=tdec)
    opt = torch.optim.Adam(tmodel.parameters())
    tr = LocalTrainer(device="cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        tr.train(q, tmodel, _loss_fn, opt, verbose=False)
    _, hist = tr.train(q, tmodel, _loss_fn, opt, epochs=2, steps_per_epoch=3,
                       verbose=False)
    assert len(hist) == 2 and all(np.isfinite(hist))
    with pytest.raises(ValueError, match="random"):
        tr.evaluate(q, tmodel, lambda m, b: b["src"].ids.float())


# --- (c) Dataset and evaluate --------------------------------------------

def _drain(ds, eof, n):
    out = []
    for _ in range(n):
        try:
            out.append(ds.next_with_count())
        except eof:
            out.append("EOF")
    return out


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_dataset_epochs_match_the_jax_dataset(window, shuffle, drop_last):
    a = degree_one_graph(n=21, d=4, seed=3)
    (jq, _), (tq, _) = _queries(a, batch=8, shuffle=shuffle)
    jds = gl.Dataset(jq, window=window, seed=4, drop_last=drop_last)
    tds = glt.Dataset(tq, window=window, seed=4, drop_last=drop_last,
                      device="cpu")
    assert tds.batch_size == 8 and tds.epoch == 0
    from graph_learn_tpu.errors import OutOfRangeError as JaxEOF
    got, want = _drain(tds, OutOfRangeError, 9), _drain(jds, JaxEOF, 9)
    # the EOF marker keeps its place in the queue whatever the lookahead.
    # With drop_last the dropped partial batch ends the epoch and the
    # exhausted traverser ends an empty one right after it: the JAX
    # package's behaviour, kept
    assert [i for i, w in enumerate(want) if isinstance(w, str)] == (
        [2, 3, 6, 7] if drop_last else [3, 7])
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
            continue
        assert g[1] == w[1]
        for alias in ("src", "hop1", "hop2"):
            np.testing.assert_array_equal(g[0][alias].ids.numpy(),
                                          np.asarray(w[0][alias].ids))
        np.testing.assert_array_equal(g[0]["src"].labels.numpy(),
                                      np.asarray(w[0]["src"].labels))
        # feature rows stay deferred until a reader gathers them
        np.testing.assert_array_equal(
            g[0]["hop1"].float_attrs.materialize().numpy(),
            np.asarray(w[0]["hop1"].float_attrs))


def test_dataset_iterates_applies_post_func_and_transform():
    a = degree_one_graph(n=21, d=4, seed=3)
    tg, _ = torch_graph(a)
    q = (tg.V("item").batch(8).alias("src").outV("rel").sample(2)
         .by("random").alias("hop1")
         .values(lambda batch: batch["src"].ids.tolist()))
    seen = list(glt.Dataset(q, window=2, device="cpu"))
    assert [len(s) for s in seen] == [8, 8, 8]
    assert sum(seen, [])[:21] == list(range(21))
    # next_with_count skips the post-processor; transform runs with the
    # plan and sees the tables
    ds = glt.Dataset(q, window=2, device="cpu", transform=lambda b, t: {
        **b, "n_tables": len(t["nodes"]) + len(t["edges"])})
    batch, count = ds.next_with_count()
    assert count == 8 and batch["n_tables"] == 2
    assert isinstance(batch["src"], glt.core.values.Nodes)


def test_dataset_refuses_unported_tiers():
    a = degree_one_graph(n=10, d=4)
    tg, _ = torch_graph(a)
    q = tg.V("item").batch(4).alias("src").values()
    # the host tier is ported (test_torch_host_tier.py); only unknown tiers
    # are refused, whether given or read from conf.storage_device
    host = glt.Dataset(q, tier="host", device="cpu")
    assert host.tier == "host" and host.next()["src"].ids.shape == (4,)
    host.close()
    with pytest.raises(InvalidArgumentError, match="tier must be"):
        glt.Dataset(q, tier="disk", device="cpu")
    old = glt.conf.storage_device
    glt.conf.storage_device = "disk"
    try:
        with pytest.raises(InvalidArgumentError, match="tier must be"):
            glt.Dataset(q, device="cpu")
    finally:
        glt.conf.storage_device = old
    # E() sources, walks, conditional negatives and subgraphs are ported;
    # a SubGraph node records the JAX package's settings
    seed = tg.E("rel")
    assert seed.kind == "source_e" and seed.edge_type == "rel"
    assert seed.outV().random_walk(3).kind == "walk"
    sub = seed.outV().SubGraph("rel", nbr_cap=2, need_dist=True)
    assert (sub.kind, sub.nbr_cap, sub.need_dist) == ("subgraph", 2, True)
    plans = []
    for g, plan_mod in ((tg, tplan), (jax_graph(a)[0], jplan)):
        src = g.V("item").batch(4).alias("src")
        src.SubGraph("rel", nbr_cap=2, need_dist=True).alias("sg")
        plans.append(plan_mod.query_to_plan(src.values()))
    assert plans[0] == plans[1]
    # conditional negatives build now (tests/test_torch_conditional.py)
    neg = seed.outV().outNeg("rel").where("src")
    assert (neg.strategy, neg.base_strategy) == ("conditional", "random")


@pytest.mark.parametrize("pre", [False, True])
def test_evaluate_does_not_count_the_padded_tail(pre):
    a = degree_one_graph(n=21, d=8, classes=3, seed=6)
    (jq, jdec), (tq, tdec) = _queries(a, batch=8, shuffle=False)
    jmodel, tmodel = _models("sage", 8, 16, 3, jdec, tdec)
    ego0 = jdata.EgoGraph.from_query_result(
        gl.Dataset(jq, window=1).next(), "src", HOPS)
    params = jmodel.init(jax.random.key(0), ego0, training=False)
    load_flax_params(tmodel, _np(params))
    tr = LocalTrainer(device="cpu")
    # the mean of the dense ids is 10 only if the 3 padded rows of the
    # last batch (ids 16, 17, 18 again) are left out
    assert tr.evaluate(tq, tmodel, lambda m, b: b["src"].ids.float()) == 10.0

    def jacc(model, p, batch):
        ego = jdata.EgoGraph.from_query_result(batch, "src", HOPS)
        return (jnp.argmax(model.apply(p, ego), 1)
                == batch["src"].labels).astype(jnp.float32)

    def acc(model, batch):
        ego = tdata.EgoGraph.from_query_result(batch, "src", HOPS)
        assert not torch.is_grad_enabled()
        return (model(ego).argmax(1) == batch["src"].labels).float()

    want = JaxLocalTrainer().evaluate(
        jq, jmodel, params, jacc,
        batch_transform=_jax_pre_aggregate if pre else None)
    got = tr.evaluate(tq, tmodel, acc,
                      batch_transform=_pre_aggregate if pre else None)
    assert got == pytest.approx(want, abs=1e-6)


# --- (d) learning --------------------------------------------------------

@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_loss_falls_on_a_learnable_toy_graph(kind):
    a = degree_one_graph(n=96, d=8, classes=3, seed=7)
    _, (tq, tdec) = _queries(a, batch=16)
    _, tmodel = _models(kind, 8, 16, 3, tdec=tdec)
    tr = LocalTrainer(seed=0, device="cpu")
    _, hist = tr.train(tq, tmodel, _loss_fn,
                       torch.optim.Adam(tmodel.parameters(), lr=0.03),
                       epochs=40, verbose=False)
    assert hist[-1] < 0.6 * hist[0], hist

    def acc(model, batch):
        ego = tdata.EgoGraph.from_query_result(batch, "src", HOPS)
        return (model(ego).argmax(1) == batch["src"].labels).float()

    assert tr.evaluate(tq, tmodel, acc) > 0.6
