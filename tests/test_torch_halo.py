"""The port's halo exchange and sharded full-graph SpMM
(parallel/{partition,halo,full_graph}.py) against the JAX package's
tests/test_halo.py.

One set of 4 CPU ranks (gloo) runs every case once for the module
(tests/torch_parity.py ``halo_ranks``): P = 4 on mesh (1, 4) and P = 2 on
the graph axis of mesh (2, 2).  ``partition_edges``' arrays and
``sharded_spmm``'s rows equal the JAX package's bit for bit; the
gradient through the exchange equals a one-process dense reference
within rtol 1e-5; ShardedGCN's first step equals the flax model's within
rtol 1e-5, and 30 steps cut the loss as the JAX test asks.
"""

import numpy as np
import pytest

import graph_learn_tpu_torch as glt
from torch_parity import HALO_CASES, gcn_arrays, halo_graph


def _jax_gcn(p):
    """The flax ShardedGCN [16, 2] of tests/test_halo.py at P = p: its
    initial parameters [(kernel, bias)], the loss and parameters after one
    Adam(0.02) step."""
    import jax
    import jax.numpy as jnp
    import optax
    from graph_learn_tpu.core.schema import Decoder
    from graph_learn_tpu.core.store import EdgeTable
    from graph_learn_tpu.parallel.full_graph import (
        ShardedGCN, make_full_graph_train_step)
    from graph_learn_tpu.parallel.mesh import make_mesh
    from graph_learn_tpu.parallel.partition import (partition_edges,
                                                    shard_features)

    src, dst, feats, labels = gcn_arrays()
    n = feats.shape[0]
    et = EdgeTable("e", "v", "v", Decoder(), src=src, dst=dst,
                   num_src_nodes=n, num_dst_nodes=n)
    sg = partition_edges(et, p)
    mesh = make_mesh(n_data=1, n_graph=p, devices=jax.devices()[:p])
    xs = jnp.asarray(shard_features(feats, p))
    rows = sg.rows_per_shard
    lab = np.pad(labels, (0, p * rows - n)).reshape(p, rows)
    msk = np.pad(np.ones(n, np.float32), (0, p * rows - n)).reshape(p, rows)
    model = ShardedGCN(dims=[16, 2], sg=sg, mesh=mesh)
    params = jax.jit(model.init)(jax.random.key(0), xs)

    def loss_fn(logits, labels_, mask):
        ls = optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(-1, 2), labels_.reshape(-1))
        m = mask.reshape(-1)
        return jnp.sum(ls * m) / jnp.sum(m)

    opt = optax.adam(0.02)
    step = make_full_graph_train_step(model, opt, mesh, loss_fn)
    p1, _, loss = step(params, opt.init(params), xs, jnp.asarray(lab),
                       jnp.asarray(msk))

    def pairs(pp):
        return [(np.asarray(pp["params"]["dense_%d" % i]["kernel"]),
                 np.asarray(pp["params"]["dense_%d" % i]["bias"]))
                for i in range(2)]
    return pairs(params), float(loss), pairs(p1)


@pytest.fixture(scope="module")
def jax_gcn():
    return _jax_gcn(4)


@pytest.fixture(scope="module")
def ranks(jax_gcn):
    import torch_parity
    from graph_learn_tpu_torch.parallel.launch import spawn
    return spawn(torch_parity.halo_ranks, 4, device="cpu",
                 args=(jax_gcn[0],), timeout_s=120, threads=1)


def _jax_spmm(name, p, agg):
    import jax
    import jax.numpy as jnp
    from graph_learn_tpu.core.schema import Decoder
    from graph_learn_tpu.core.store import EdgeTable
    from graph_learn_tpu.parallel.halo import sharded_spmm
    from graph_learn_tpu.parallel.mesh import make_mesh
    from graph_learn_tpu.parallel.partition import (partition_edges,
                                                    shard_features)

    _, n, e, seed = [c for c in HALO_CASES if c[0] == name][0]
    src, dst, w, feats = halo_graph(n, e, seed)
    et = EdgeTable("e", "v", "v", Decoder(weighted=True), src=src, dst=dst,
                   num_src_nodes=n, num_dst_nodes=n, weights=w)
    sg = partition_edges(et, p)
    mesh = make_mesh(n_data=1, n_graph=p, devices=jax.devices()[:p])
    # under jit: an eager shard_map compiles for seconds on every call
    fn = jax.jit(lambda x: sharded_spmm(sg, x, mesh, agg=agg))
    return np.asarray(fn(jnp.asarray(shard_features(feats, p)))), sg


def _dense(n, src, dst, x, agg, w=None):
    """One-process float64 reference (tests/test_halo.py ``_dense_ref``,
    with the edge weights for ``weighted_sum``)."""
    import torch
    x = torch.as_tensor(x, dtype=torch.float64) if not isinstance(
        x, torch.Tensor) else x
    msg = x[torch.as_tensor(src)]
    if agg == "weighted_sum":
        msg = msg * torch.as_tensor(w, dtype=torch.float64)[:, None]
    out = torch.zeros((n, x.shape[1]), dtype=torch.float64).index_add(
        0, torch.as_tensor(dst), msg)
    if agg == "mean":
        cnt = torch.bincount(torch.as_tensor(dst), minlength=n)
        out = out / torch.clamp(cnt, min=1)[:, None]
    return out


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("agg", ["sum", "mean", "weighted_sum"])
@pytest.mark.parametrize("case", ["even", "uneven"])
def test_sharded_spmm_matches_jax(ranks, p, agg, case):
    """Every rank's rows equal the JAX package's block bit for bit, and
    the whole equals a dense float64 reference within rtol 1e-5."""
    want, _ = _jax_spmm(case, p, agg)
    _, n, e, seed = [c for c in HALO_CASES if c[0] == case][0]
    src, dst, w, feats = halo_graph(n, e, seed)
    for gi in range(p):
        got = ranks[gi][(p, case, agg)][0].numpy()
        np.testing.assert_array_equal(got, want[gi])
    dense = _dense(n, src, dst, feats, agg, w).numpy()
    np.testing.assert_allclose(want.reshape(-1, 8)[:n], dense, rtol=1e-5,
                               atol=1e-5)
    if p == 2:  # data slice 1 holds the same graph shards
        for gi in range(p):
            assert np.array_equal(ranks[2 + gi][(p, case, agg)][0].numpy(),
                                  want[gi])


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("agg", ["sum", "mean", "weighted_sum"])
def test_halo_exchange_gradient(ranks, p, agg):
    """The backward (the reverse all_to_all and the scatter-add into the
    sent rows): d sum(y * proj) / dx equals the one-process gradient
    within rtol 1e-5."""
    import torch
    from graph_learn_tpu_torch.parallel.partition import shard_features
    _, n, e, seed = HALO_CASES[0]
    src, dst, w, feats = halo_graph(n, e, seed)
    # each rank's projection is drawn from the same seed for its block
    proj = np.concatenate([
        np.random.default_rng(seed + 1).standard_normal(
            (-(-n // p), 8)).astype(np.float32)] * p)
    xs = torch.as_tensor(feats, dtype=torch.float64).requires_grad_(True)
    y = _dense(n, src, dst, xs, agg, w)
    (y * torch.as_tensor(proj[:n], dtype=torch.float64)).sum().backward()
    want = shard_features(xs.grad.numpy(), p)
    for gi in range(p):
        got = ranks[gi][(p, "even", agg)][1].numpy()
        np.testing.assert_allclose(got, want[gi], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", [2, 4])
def test_partition_edges_matches_jax(p):
    """partition_edges' arrays (the searchsorted halo positions in place
    of the JAX build's dict) are the JAX package's, bit for bit."""
    from graph_learn_tpu.core.schema import Decoder
    from graph_learn_tpu.core.store import EdgeTable
    from graph_learn_tpu.parallel.partition import (
        partition_edges as jpartition)
    from graph_learn_tpu_torch.parallel.partition import partition_edges
    for name, n, e, seed in HALO_CASES:
        src, dst, w, _ = halo_graph(n, e, seed)
        jsg = jpartition(EdgeTable("e", "v", "v", Decoder(weighted=True),
                                   src=src, dst=dst, num_src_nodes=n,
                                   num_dst_nodes=n, weights=w), p)
        et = glt.EdgeTable("e", "v", "v", glt.Decoder(weighted=True),
                           src=src, dst=dst, num_src_nodes=n,
                           num_dst_nodes=n, weights=w)
        tsg = partition_edges(et, p)
        for f in ("row_offsets", "nbr_local", "edge_weight", "send_idx",
                  "send_counts", "recv_offsets"):
            np.testing.assert_array_equal(getattr(tsg, f),
                                          np.asarray(getattr(jsg, f)),
                                          err_msg=f)
        for f in ("num_shards", "rows_per_shard", "halo_max", "s_max",
                  "buffer_rows"):
            assert getattr(tsg, f) == getattr(jsg, f), f


def test_partition_halo_plan_consistency():
    from graph_learn_tpu_torch.parallel.partition import partition_edges
    n, e, p = 40, 200, 4
    src, dst, w, _ = halo_graph(n, e, seed=7)
    et = glt.EdgeTable("e", "v", "v", glt.Decoder(weighted=True), src=src,
                       dst=dst, num_src_nodes=n, num_dst_nodes=n, weights=w)
    sg = partition_edges(et, p)
    for q in range(p):
        assert sg.send_counts[:, q].sum() == sg.recv_offsets[q, -1]
    assert np.all(np.diag(sg.send_counts) == 0)


def test_full_graph_gcn_first_step_matches_flax(ranks, jax_gcn):
    """ShardedGCN [16, 2] from the flax parameters: after one Adam(0.02)
    step every rank's parameters equal the JAX step's within rtol 1e-5."""
    _, _, want = jax_gcn
    for r in ranks:
        for (kw, bw), (kt, bt) in zip(want, r["gcn_step1"]):
            np.testing.assert_allclose(kt.numpy(), kw, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(bt.numpy(), bw, rtol=1e-5, atol=1e-6)


def test_full_graph_gcn_trains(ranks, jax_gcn):
    """30 steps cut the loss below 0.7 of the first (tests/test_halo.py),
    whose first value is the flax model's within rtol 1e-5; every rank
    sees the same losses."""
    losses = ranks[0]["gcn_losses"]
    np.testing.assert_allclose(losses[0], jax_gcn[1], rtol=1e-5)
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    for r in ranks[1:]:
        assert r["gcn_losses"] == losses
