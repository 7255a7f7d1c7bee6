"""The port's UltraGCN example (graph_learn_tpu_torch/examples/ultra_gcn.py)
against examples/ultra_gcn.py: the store built in memory against the one
the JAX example loads from its TSV files, and one step (negatives, i-i
neighbours, loss, gradients and one Adam step) from the same weights and
JAX's own negative draws."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graph_learn_tpu as gl
from graph_learn_tpu.ops.negative import negative_sample as jax_negatives
from graph_learn_tpu.ops.sampling import topk_sample as jax_topk
from graph_learn_tpu_torch.examples import ultra_gcn as ug
from graph_learn_tpu_torch.examples.bipartite_sage import (build_graph,
                                                          u2i_arrays)
from graph_learn_tpu_torch.ops import negative, sampling

REPO = Path(__file__).resolve().parents[1]
# f32 throughout, the same sums in other orders: the loss within 1e-5
# relative; gradients and the parameters after one Adam step within 1e-5
# relative plus 1e-6 absolute
RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(n_users=60, n_items=40, feat_dim=16, seed=2)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The JAX example's store, loaded from the TSV files of
    ``examples/data/synthetic.py u2i`` as the example loads them, and the
    port's, built in memory from the same draws."""
    spec = importlib.util.spec_from_file_location(
        "ultra_synthetic", REPO / "examples" / "data" / "synthetic.py")
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)
    d = tmp_path_factory.mktemp("u2i")
    synthetic.u2i(str(d), **SMALL)
    jg = (gl.Graph()
          .node(str(d / "user_table"), "u", gl.Decoder(attr_types=["float"]
                                                       * 16))
          .node(str(d / "item_table"), "i", gl.Decoder(attr_types=["float"]
                                                       * 16))
          .edge(str(d / "u2i_table"), ("u", "i", "u-i"),
                gl.Decoder(weighted=True))
          .edge(str(d / "i2i_table"), ("i", "i", "i-i"),
                gl.Decoder(weighted=True))).init()
    tg, _, _ = build_graph(u2i_arrays(**SMALL), "cpu")
    return jg, tg


def test_the_store_holds_the_jax_example_data(stores):
    jg, tg = stores
    for name in ("u-i", "i-i"):
        jt, tt = jg.store.edge_table(name), tg.store.edge_table(name)
        for f in ("src", "dst", "weights", "out_degrees", "in_degrees"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
        jc, tc = jt.device().out, tt.device("cpu").out
        for f in ("row_offsets", "nbr_ids", "nbr_edge_ids"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))
    np.testing.assert_array_equal(
        tg.store.edge_table("u-i").device("cpu").unique_dst.numpy(),
        np.asarray(jg.store.edge_table("u-i").device().unique_dst))
    for t in ("u", "i"):
        np.testing.assert_allclose(tg.store.node_table(t).float_attrs,
                                   jg.store.node_table(t).float_attrs,
                                   atol=5e-6)


def _jax_loss(p, uu, ii, neg, ii_nbrs, du, di, w_ii):
    """``examples/ultra_gcn.py``'s ``lf`` with its constraint weights."""
    beta_pos = (1.0 / jnp.maximum(du[uu], 1.0)) * jnp.sqrt(
        (du[uu] + 1.0) / (di[ii] + 1.0))
    beta_neg = (1.0 / jnp.maximum(du[uu], 1.0))[:, None] * jnp.sqrt(
        (du[uu][:, None] + 1.0) / (di[neg] + 1.0))
    ue = p["u"][uu]
    pe = p["i"][ii]
    ne = p["i"][neg]
    pos_logit = jnp.sum(ue * pe, -1)
    neg_logit = jnp.einsum("bd,bnd->bn", ue, ne)
    loss = jnp.mean((1.0 + beta_pos) * optax.sigmoid_binary_cross_entropy(
        pos_logit, jnp.ones_like(pos_logit)))
    loss += jnp.mean((1.0 + beta_neg) * optax.sigmoid_binary_cross_entropy(
        neg_logit, jnp.zeros_like(neg_logit)))
    ce = p["i"][ii_nbrs]
    ii_logit = jnp.einsum("bd,bkd->bk", ue, ce)
    loss += w_ii * jnp.mean(optax.sigmoid_binary_cross_entropy(
        ii_logit, jnp.ones_like(ii_logit)))
    return loss


@pytest.mark.parametrize("seed", [0, 1])
def test_one_step_equals_jax_from_the_same_weights_and_draws(stores, seed):
    """The port's negatives on JAX's own draws (``uniform_ids`` over the
    pool), the i-i ``topk`` neighbours, the loss, its gradients and the
    parameters after one Adam step at lr 0.005."""
    jg, tg = stores
    jet, tet = jg.store.edge_table("u-i"), tg.store.edge_table("u-i")
    jdev, tdev = jet.device(), tet.device("cpu")
    n_u, n_i, d, b, n_neg, k, lr = 60, 40, 8, 24, 5, 3, 0.005
    rng = np.random.default_rng(seed)
    emb = {"u": rng.standard_normal((n_u, d)).astype(np.float32) * 0.1,
           "i": rng.standard_normal((n_i, d)).astype(np.float32) * 0.1}
    eidx = rng.integers(0, jet.num_edges, b)
    key = jax.random.key(seed)
    uu = np.asarray(jdev.src[eidx])
    ii = np.asarray(jdev.dst[eidx])
    neg = np.asarray(jax_negatives(jdev, jnp.asarray(uu), n_neg, key,
                                   "random"))
    # the port's draw on the same numbers: JAX's randint into the pool
    idx = np.asarray(jax.random.randint(key, (b, n_neg), 0,
                                        tdev.unique_dst.shape[0]))
    np.testing.assert_array_equal(tdev.unique_dst[idx].numpy(), neg)
    ii_nbrs = np.asarray(jax_topk(jg.store.edge_table("i-i").device().out,
                                  jnp.asarray(ii), k)[0])
    t_nbrs, _ = sampling.topk_sample(
        tg.store.edge_table("i-i").device("cpu").out, torch.from_numpy(ii), k)
    np.testing.assert_array_equal(t_nbrs.numpy(), ii_nbrs)
    du = np.asarray(jet.out_degrees, np.float32)
    di = np.asarray(jet.in_degrees, np.float32)

    jp = {k_: jnp.asarray(v) for k_, v in emb.items()}
    loss, grads = jax.value_and_grad(_jax_loss)(
        jp, uu, ii, neg, ii_nbrs, jnp.asarray(du), jnp.asarray(di), 1.0)
    opt = optax.adam(lr)
    upd, _ = opt.update(grads, opt.init(jp), jp)
    after = optax.apply_updates(jp, upd)

    tp = {k_: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k_, v in emb.items()}
    t_loss = ug.ultra_loss(tp, torch.from_numpy(uu), torch.from_numpy(ii),
                           torch.from_numpy(neg), t_nbrs,
                           torch.from_numpy(du), torch.from_numpy(di), 1.0)
    topt = torch.optim.Adam(tp.values(), lr=lr)
    t_loss.backward()
    assert float(t_loss) == pytest.approx(float(loss), rel=RTOL)
    for k_ in emb:
        np.testing.assert_allclose(tp[k_].grad.numpy(), np.asarray(grads[k_]),
                                   rtol=RTOL, atol=ATOL)
    topt.step()
    for k_ in emb:
        np.testing.assert_allclose(tp[k_].detach().numpy(),
                                   np.asarray(after[k_]), rtol=RTOL,
                                   atol=ATOL)


def test_random_negatives_come_from_the_pool(stores):
    _, tg = stores
    dev = tg.store.edge_table("u-i").device("cpu")
    neg = negative.negative_sample(dev, dev.src[:30], 20,
                                   torch.Generator().manual_seed(0), "random")
    assert neg.shape == (30, 20)
    assert np.isin(neg.numpy(), dev.unique_dst.numpy()).all()


def test_recall_at_k_counts_hits_over_the_truth():
    u = np.eye(3, dtype=np.float32)
    i = np.eye(3, dtype=np.float32)[[2, 1, 0]]  # item j scores user 2 - j
    src, dst = np.array([0, 0, 1, 2]), np.array([2, 0, 1, 1])
    # top-1: user 0 -> item 2 (hit of 2), user 1 -> 1 (hit), user 2 -> 0
    assert ug.recall_at(u, i, src, dst, k=1) == pytest.approx(2 / 3)
    assert ug.recall_at(u, i, src, dst, k=3) == pytest.approx(1.0)


def test_the_example_runs_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recall = ug.main(["--cpu", "--data_dir", str(tmp_path), "--steps", "3",
                          "--batch_size", "64"])
    assert re.search(r"^step 0 loss [0-9.]+$", out.getvalue(), re.M)
    assert re.search(r"^recall@20: [01]\.\d{4}$", out.getvalue(), re.M)
    assert 0.0 <= recall <= 1.0
