"""The port's five losses against graph_learn_tpu/nn/loss.py: values and
gradients on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.nn import loss as jloss
from graph_learn_tpu_torch.nn import loss as tloss

# f32 on both sides; log-sum-exp, softplus and the means are summed in
# other orders: 1e-5 on values, 1e-5 on gradients (entries are O(1/b))
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _compare(jfn, tfn, arrays, **kwargs):
    """Value and the gradient w.r.t. every float array."""
    val, grads = jax.value_and_grad(
        lambda xs: jfn(*xs, **kwargs))([jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = tfn(*ts, **kwargs)
    assert out.shape == () and out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), float(val), **TOL)
    out.backward()
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("valid", [None, "some", "none"])
def test_supervised_softmax_loss(valid):
    (logits,) = _inputs(0, (9, 5))
    labels = np.random.default_rng(1).integers(0, 5, 9).astype(np.int32)
    mask = {None: None, "some": np.arange(9) % 3 != 0,
            "none": np.zeros(9, bool)}[valid]
    jval, jgrad = jax.value_and_grad(
        lambda lg: jloss.supervised_softmax_loss(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    out = tloss.supervised_softmax_loss(
        t, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.item(), float(jval), **TOL)
    out.backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **TOL)
    if valid == "none":
        assert out.item() == 0.0  # no valid row: 0 / max(0, 1)


def test_sigmoid_cross_entropy_loss():
    _compare(jloss.sigmoid_cross_entropy_loss,
             tloss.sigmoid_cross_entropy_loss, _inputs(2, (7,), (21,)))


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_unsupervised_softmax_cross_entropy_loss(temperature):
    _compare(jloss.unsupervised_softmax_cross_entropy_loss,
             tloss.unsupervised_softmax_cross_entropy_loss,
             _inputs(3, (6, 8), (6, 8), (11, 8)), temperature=temperature)


def test_unsupervised_softmax_loss_keeps_its_epsilon():
    # a positive similarity far below the negatives: the softmax entry
    # underflows to 0 and the loss is -log(1e-12), not inf
    src = np.full((2, 4), 10.0, np.float32)
    out = tloss.unsupervised_softmax_cross_entropy_loss(
        torch.from_numpy(src), torch.from_numpy(-src), torch.from_numpy(src))
    ref = jloss.unsupervised_softmax_cross_entropy_loss(
        jnp.asarray(src), jnp.asarray(-src), jnp.asarray(src))
    assert np.isfinite(out.item())
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(out.item(), -np.log(1e-12), rtol=1e-4)


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("neg_num", [1, 3])
def test_triplet_margin_loss(L, neg_num):
    b, d = 5, 6
    arrays = _inputs(4 + L, (b, d), (b, d), (b, d), (b * neg_num, d),
                     (b * neg_num, d), (b * neg_num, d))
    _compare(jloss.triplet_margin_loss, tloss.triplet_margin_loss, arrays,
             margin=0.7, neg_num=neg_num, L=L)


def test_triplet_softplus_loss():
    _compare(jloss.triplet_softplus_loss, tloss.triplet_softplus_loss,
             _inputs(8, (5, 6), (5, 6), (5, 6), (15, 6), (15, 6), (15, 6)))
