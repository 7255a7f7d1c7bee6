"""Kernels 3-5 as ``torch.library`` operators on the CPU: ``glt::gat_block``
with its backward ``glt::gat_block_backward`` (``register_autograd``),
``glt::sweep_aggregate`` and ``glt::stream_sum``.  Each passes
``torch.library.opcheck``, its fake gives the real output's shape and
dtype, its CPU implementation is the plain version, the backward's equals
``jax.vjp`` of the block restated in ``jax.numpy``, and each wrapper is one
call of its operator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels import gat, sweep

# f32 on both sides, sums in other orders (tests/test_torch_gat.py's TOL)
TOL = dict(rtol=1e-5, atol=1e-5)


def _gat_inputs(b=6, e=4, din=5, h=3, w=7, bias=False, drop=False,
                dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    keep = (rng.random((h, b, e)) < 0.7).astype(np.float32) / 0.7
    return (t(b, e, din).to(dtype), t(h, din, w), t(h, w), t(h, b),
            t(h, w) if bias else None, t(h) if bias else None,
            torch.from_numpy(keep) if drop else None)


def _jax_block(nbr, wn, ar, el, bn, ba, drop):
    """gat_block_plain restated in jax.numpy (module note of
    ops/kernels/gat.py)."""
    b, e, din = nbr.shape
    nh = jnp.einsum("nd,hdw->hnw", nbr.reshape(b * e, din), wn)
    if bn is not None:
        nh = nh + bn[:, None, :]
    nh = nh.reshape(wn.shape[0], b, e, wn.shape[2])
    z = el[..., None] + (nh * ar[:, None, None, :]).sum(-1)
    if ba is not None:
        z = z + ba[:, None, None]
    coef = jax.nn.softmax(jax.nn.leaky_relu(z, negative_slope=0.2), axis=2)
    if drop is not None:
        coef = coef * drop
    return (coef[..., None] * nh).sum(2)


CASES = [dict(), dict(bias=True), dict(drop=True), dict(bias=True, drop=True),
         dict(b=1, e=1, din=1, h=1, w=1)]


@pytest.mark.parametrize("case", CASES)
def test_gat_block_backward_equals_jax_vjp(case):
    t = _gat_inputs(**case, seed=1)
    nbr, wn, ar, el, bn, ba, drop = t
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (wn.shape[0], nbr.shape[0], wn.shape[2])).astype(np.float32))
    d_nbr, d_wn, d_ar, d_el = torch.ops.glt.gat_block_backward(g, *t, True)
    jt = [None if x is None else jnp.asarray(x.numpy()) for x in t]
    primals = [jt[0], jt[1], jt[2], jt[3]] + ([jt[4]] if bn is not None
                                              else [])
    out, vjp = jax.vjp(lambda *p: _jax_block(
        *p[:4], p[4] if bn is not None else None, jt[5], jt[6]), *primals)
    np.testing.assert_allclose(
        torch.ops.glt.gat_block(*t).numpy(), np.asarray(out), **TOL)
    want = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(d_nbr.numpy(), want[0], **TOL)
    din = nbr.shape[2]
    np.testing.assert_allclose(d_wn[:, :din].numpy(), want[1], **TOL)
    np.testing.assert_allclose(d_ar.numpy(), want[2], **TOL)
    np.testing.assert_allclose(d_el.numpy(), want[3], **TOL)
    if bn is not None:  # the bias's gradient rides as row Din
        assert d_wn.shape == (wn.shape[0], din + 1, wn.shape[2])
        np.testing.assert_allclose(d_wn[:, din].numpy(), want[4], **TOL)
    else:
        assert d_wn.shape == wn.shape


@pytest.mark.parametrize("case", CASES[:4])
def test_gat_block_gradients_through_the_operator_equal_autograd_of_plain(
        case):
    t = [None if x is None else x.requires_grad_(i < 6)
         for i, x in enumerate(_gat_inputs(**case, seed=3))]
    leaves = [x for x in t if x is not None and x.requires_grad]
    out = gat.gat_block(*t)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(gat.gat_block_plain(*t), leaves, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_gat_block_skips_d_nbr_when_nbr_needs_no_gradient(monkeypatch):
    seen = []
    op = gat._gat_block_backward_op
    monkeypatch.setattr(gat, "_gat_block_backward_op",
                        lambda *a: (seen.append(a[-1]), op(*a))[1])
    nbr, wn, ar, el, bn, ba, _ = _gat_inputs(bias=True)
    for x in (wn, ar, el, bn, ba):
        x.requires_grad_()
    gat.gat_block(nbr, wn, ar, el, bn, ba).sum().backward()
    assert seen == [False] and nbr.grad is None
    assert wn.grad.shape == wn.shape and bn.grad.shape == bn.shape
    # z = el + er + ba: d_ba is d_el summed over the seeds
    np.testing.assert_allclose(ba.grad.numpy(), el.grad.sum(1).numpy(),
                               rtol=0, atol=0)
    nbr.requires_grad_()
    gat.gat_block(nbr, wn, ar, el, bn, ba).sum().backward()
    assert seen == [False, True] and nbr.grad.shape == nbr.shape


def test_gat_block_is_differentiable_once():
    t = [None if x is None else x.requires_grad_()
         for x in _gat_inputs()[:4]] + [None] * 3
    (d_wn,) = torch.autograd.grad(gat.gat_block(*t).square().sum(), [t[1]],
                                  create_graph=True)
    with pytest.raises(RuntimeError, match="once"):
        d_wn.sum().backward()


def test_bf16_neighbours_give_an_f32_block_and_bf16_gradients():
    t = list(_gat_inputs(dtype=torch.bfloat16))
    t[0].requires_grad_()
    out = gat.gat_block(*t)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert t[0].grad.dtype == torch.bfloat16


@pytest.mark.parametrize("case", CASES[:4] + [dict(dtype=torch.bfloat16)])
def test_the_gat_operators_pass_opcheck_and_their_fakes_match(case):
    t = _gat_inputs(**case)
    g = torch.ones((t[1].shape[0], t[0].shape[0], t[1].shape[2]))
    torch.library.opcheck(torch.ops.glt.gat_block.default, t)
    grads = [None if x is None or i == 6 else x.clone().requires_grad_(
        x.dtype == torch.float32) for i, x in enumerate(t)]
    torch.library.opcheck(torch.ops.glt.gat_block.default,
                          tuple(grads[:6]) + (t[6],))
    for want_nbr in (True, False):
        torch.library.opcheck(torch.ops.glt.gat_block_backward.default,
                              (g, *t, want_nbr))
    real = (torch.ops.glt.gat_block(*t),
            *torch.ops.glt.gat_block_backward(g, *t, False))
    with FakeTensorMode() as mode:
        fake_in = [None if x is None else mode.from_tensor(x) for x in t]
        fake = (torch.ops.glt.gat_block(*fake_in),
                *torch.ops.glt.gat_block_backward(mode.from_tensor(g),
                                                  *fake_in, False))
    assert [(tuple(x.shape), x.dtype) for x in fake] == \
        [(tuple(x.shape), x.dtype) for x in real]
    assert real[0].dtype == torch.float32 and real[1].shape == (0,)


def _hits(n_rows=300, n=48, k=4, d=5, R=64, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.standard_normal((n_rows, d)).astype(np.float32)).to(dtype)
    flat = torch.from_numpy(rng.integers(0, n_rows, n).astype(np.int32))
    starts, packed = sweep.sweep_prep(flat, k, n_rows, R)
    return starts, packed, table, n // k, R


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_sweep_operators_pass_opcheck_and_give_the_plain_result(dtype):
    args = _hits(dtype=dtype)
    torch.library.opcheck(torch.ops.glt.sweep_aggregate.default, args)
    torch.library.opcheck(torch.ops.glt.stream_sum.default, (args[2],))
    assert torch.equal(torch.ops.glt.sweep_aggregate(*args),
                       sweep.sweep_aggregate_plain(*args))
    assert torch.equal(torch.ops.glt.stream_sum(args[2]),
                       sweep.stream_sum_plain(args[2]))
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = (torch.ops.glt.sweep_aggregate(*fake),
               torch.ops.glt.stream_sum(fake[2]))
    assert [(tuple(x.shape), x.dtype) for x in got] == \
        [((12, 5), torch.float32), ((1, 5), torch.float32)]


@pytest.mark.parametrize("call", ["gat_block", "sweep_aggregate",
                                  "stream_sum"])
def test_the_wrappers_go_through_the_operators(call, monkeypatch):
    """One wrapper call is one operator call (on the card: one launch);
    what a wrapper refuses never reaches its operator; on the CPU no
    launch is counted."""
    mod = gat if call == "gat_block" else sweep
    name = "_%s_op" % call
    op = getattr(mod, name)
    seen = []
    monkeypatch.setattr(mod, name, lambda *a: (seen.append(a), op(*a))[1])
    hits = _hits()
    calls = {
        "gat_block": lambda bad: gat.gat_block(
            *_gat_inputs(dtype=torch.float64 if bad else torch.float32)),
        "sweep_aggregate": lambda bad: sweep.sweep_aggregate(
            *hits[:2], hits[2].clone().requires_grad_(bad), *hits[3:]),
        "stream_sum": lambda bad: sweep.stream_sum(
            hits[2].clone().requires_grad_(bad)),
    }
    before = [c.count for c in (gat.LAUNCHES_FWD, gat.LAUNCHES_BWD,
                                sweep.LAUNCHES_SWEEP, sweep.LAUNCHES_STREAM)]
    calls[call](False)
    assert len(seen) == 1
    with pytest.raises(InvalidArgumentError):
        calls[call](True)
    assert len(seen) == 1
    assert [c.count for c in (gat.LAUNCHES_FWD, gat.LAUNCHES_BWD,
                              sweep.LAUNCHES_SWEEP,
                              sweep.LAUNCHES_STREAM)] == before
