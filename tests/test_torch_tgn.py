"""The port's TGN example (graph_learn_tpu_torch/examples/tgn.py) against
examples/tgn.py: the store built in memory against the one the JAX example
loads from its TSV files, the flax ``GRUCell`` carried into a
``torch.nn.GRUCell``, and one step (recency neighbours, loss, gradients,
one Adam step, the memories updated after scoring) from the same weights
and JAX's own negative draws."""

import ast
import contextlib
import io
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import graph_learn_tpu as gl
from graph_learn_tpu.ops.negative import negative_sample as jax_negatives
from graph_learn_tpu.ops.temporal import \
    temporal_topk_sample as jax_temporal_topk
from graph_learn_tpu_torch.examples import tgn
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.ops.temporal import temporal_topk_sample
from torch_parity import assert_trees_close

REPO = Path(__file__).resolve().parents[1]
# f32 throughout, the same products in other orders: the loss within 1e-5
# relative; gradients, memories and the parameters after one Adam step
# within 1e-5 relative plus 1e-6 absolute
RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(n_u=30, n_i=20, events=400)
MEM, NBRS, B, LR = 16, 5, 32, 0.003


def _jax_example():
    """``gen_temporal_u2i`` and ``TGNScorer`` of examples/tgn.py, run as
    written (the module itself sets the platform when it is imported)."""
    path = REPO / "examples" / "tgn.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in ("gen_temporal_u2i", "TGNScorer")]
    ns = {"np": np, "os": os, "jnp": jnp, "nn": fnn}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    ex = _jax_example()
    d = tmp_path_factory.mktemp("tgn")
    ex["gen_temporal_u2i"](str(d), **SMALL)
    jg = (gl.Graph()
          .node(str(d / "user_table"), "u",
                gl.Decoder(attr_types=["float"] * 8))
          .node(str(d / "item_table"), "i",
                gl.Decoder(attr_types=["float"] * 8))
          .edge(str(d / "event_table"), ("u", "i", "ev"),
                gl.Decoder(timestamped=True))).init()
    tg = tgn.build_graph(tgn.gen_temporal_u2i(**SMALL), "cpu")
    return ex, jg, tg


def test_the_store_holds_the_jax_example_data(example):
    """Features bit for bit (each read back from its three decimals as the
    loader reads it), raw ids, events, rebased timestamps and the
    ts-ascending CSR with its ``nbr_ts`` and pools."""
    _, jg, tg = example
    for t in ("u", "i"):
        jn, tn = jg.store.node_table(t), tg.store.node_table(t)
        np.testing.assert_array_equal(tn.float_attrs, jn.float_attrs)
        np.testing.assert_array_equal(tn.raw_ids, jn.raw_ids)
    jt, tt = jg.store.edge_table("ev"), tg.store.edge_table("ev")
    for f in ("src", "dst", "timestamps"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    assert tt.ts_base == jt.ts_base
    jd, td = jt.device(), tt.device("cpu")
    for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "nbr_ts"):
        np.testing.assert_array_equal(getattr(td.out, f).numpy(),
                                      np.asarray(getattr(jd.out, f)))
    np.testing.assert_array_equal(td.unique_dst.numpy(),
                                  np.asarray(jd.unique_dst))


def _flax_params(in_dim):
    gru = fnn.GRUCell(features=MEM)
    h0 = jnp.zeros((1, MEM))
    return gru, gru.init(jax.random.key(1), h0, jnp.zeros((1, in_dim)))


def test_the_flax_gru_cell_carries_into_torch():
    """``load_flax_params`` into ``gru_cell``: the same next state, flax's
    tree back from ``to_flax_params``, and the hidden r / z biases held at
    zero through an Adam step."""
    gru, params = _flax_params(2 * MEM)
    cell = tgn.gru_cell(2 * MEM, MEM, torch.Generator().manual_seed(0),
                        "cpu")
    load_flax_params(cell, params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 2 * MEM)).astype(np.float32)
    h = rng.standard_normal((7, MEM)).astype(np.float32)
    want, _ = gru.apply(params, jnp.asarray(h), jnp.asarray(x))
    got = cell(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(to_flax_params(cell)["params"], params["params"],
                       rtol=0, atol=0)
    opt = torch.optim.Adam(cell.parameters(), lr=0.1)
    cell(torch.from_numpy(x), torch.from_numpy(h)).sum().backward()
    opt.step()
    assert not cell.bias_hh[:2 * MEM].any() and cell.bias_hh[2 * MEM:].any()


def _jax_loss(scorer, gru, p, mem_u, mem_i, i_feat, uu, ii, neg, nbr_i):
    """``examples/tgn.py``'s ``lf``."""
    nbr_m = mem_i[jnp.maximum(nbr_i, 0)]
    last_msg = jnp.concatenate([mem_u[uu], nbr_m[:, 0]], -1)
    u_m, _ = gru.apply(p["gru"], mem_u[uu], last_msg)
    i_m = mem_i[ii]
    n_m = mem_i[neg]
    pos = scorer.apply(p["scorer"], u_m, i_m, nbr_m, i_feat[ii])
    negs = scorer.apply(p["scorer"], u_m, n_m, nbr_m, i_feat[neg])
    loss = optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)).mean()
    loss += optax.sigmoid_binary_cross_entropy(
        negs, jnp.zeros_like(negs)).mean()
    return loss, (pos, negs)


@pytest.mark.parametrize("off", [0, 256])
def test_one_step_equals_jax_from_the_same_weights_and_draws(example, off):
    """A batch of events at offset ``off`` of the stream: the recency
    neighbours, the loss, the pairwise AUC, the gradients' effect through
    one Adam step at lr 0.003, and both endpoints' memories after the
    update (with the weights the batch was scored with)."""
    ex, jg, tg = example
    jdev = jg.store.edge_table("ev").device()
    tdev = tg.store.edge_table("ev").device("cpu")
    scorer = ex["TGNScorer"](MEM)
    gru, gp = _flax_params(2 * MEM)
    d0 = jnp.zeros((1, MEM))
    params = {"scorer": scorer.init(jax.random.key(0), d0, d0,
                                    jnp.zeros((1, NBRS, MEM)),
                                    jnp.zeros((1, 8))),
              "gru": gp}
    model = tgn.make_model(MEM, device="cpu")
    load_flax_params(model, params)
    proj = np.random.default_rng(42).standard_normal((8, MEM)).astype(
        np.float32) * 0.5
    u_feat = jg.store.node_table("u").float_attrs
    i_feat = jg.store.node_table("i").float_attrs
    mem_u, mem_i = u_feat @ proj, i_feat @ proj
    order = np.argsort(jg.store.edge_table("ev").timestamps, kind="stable")
    eidx = order[off:off + B]
    key = jax.random.key(off)
    uu, ii = jdev.src[eidx], jdev.dst[eidx]
    ts = jdev.timestamps[eidx]
    neg = np.asarray(jax_negatives(jdev, uu, 1, key, "random")[:, 0])
    nbr_i = np.asarray(jax_temporal_topk(jdev.out, uu, NBRS, ts)[0])
    t_nbr, _ = temporal_topk_sample(tdev.out, torch.from_numpy(
        np.asarray(uu)), NBRS, torch.from_numpy(np.asarray(ts)))
    np.testing.assert_array_equal(t_nbr.numpy(), nbr_i)

    args = (jnp.asarray(mem_u), jnp.asarray(mem_i), jnp.asarray(i_feat), uu,
            ii, jnp.asarray(neg), jnp.asarray(nbr_i))
    (loss, (pos, negs)), grads = jax.value_and_grad(
        lambda p: _jax_loss(scorer, gru, p, *args), has_aux=True)(params)
    opt = optax.adam(LR)
    upd, _ = opt.update(grads, opt.init(params), params)
    after = optax.apply_updates(params, upd)
    msg_u = jnp.concatenate([args[0][uu], args[1][ii]], -1)
    msg_i = jnp.concatenate([args[1][ii], args[0][uu]], -1)
    new_u, _ = gru.apply(params["gru"], args[0][uu], msg_u)
    new_i, _ = gru.apply(params["gru"], args[1][ii], msg_i)

    mem = (torch.from_numpy(mem_u.copy()), torch.from_numpy(mem_i.copy()))
    topt = torch.optim.Adam(model.parameters(), lr=LR)
    t_loss, t_auc = tgn.tgn_step(
        model, topt, (tdev, torch.from_numpy(i_feat)), mem,
        torch.from_numpy(eidx), torch.from_numpy(neg), NBRS)
    assert float(t_loss) == pytest.approx(float(loss), rel=RTOL)
    assert float(t_auc) == pytest.approx(float((pos > negs).mean()))
    got = to_flax_params(model)
    for part in ("scorer", "gru"):
        assert_trees_close(got[part]["params"], after[part]["params"],
                           rtol=RTOL, atol=ATOL)
    # rows of users / items that occur once in the batch (a repeated row's
    # last write is not defined in either package)
    for m, rows, new in ((mem[0], np.asarray(uu), new_u),
                         (mem[1], np.asarray(ii), new_i)):
        vals, counts = np.unique(rows, return_counts=True)
        once = np.isin(rows, vals[counts == 1])
        assert once.any()
        np.testing.assert_allclose(m[rows[once]].numpy(),
                                   np.asarray(new)[once], rtol=RTOL,
                                   atol=ATOL)


def test_the_example_runs_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        auc = tgn.main(["--cpu", "--data_dir", str(tmp_path), "--epochs", "1",
                         "--batch_size", "512"])
    assert re.search(r"^epoch 0 loss [0-9.]+ pairwise-auc [01]\.\d{3} "
                     r"\(last quarter [01]\.\d{3}\)$", out.getvalue(), re.M)
    assert 0.0 <= auc <= 1.0
