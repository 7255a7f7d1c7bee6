"""Kernel 3: the fused GAT neighbour block, forward and backward.

    gat_block(nbr [b, e, Din], wn [H, Din, W], ar [H, W], el [H, b],
              bn [H, W] | None, ba [H] | None, drop [H, b, e] | None)
        -> out [H, b, W] f32
      nh     = nbr . wn[h] (+ bn[h])
      logits = leaky_relu(el[h, s] + nh . ar[h] (+ ba[h]), 0.2)
      coef   = softmax_j(logits) (* drop)
      out    = sum_j coef[j] * nh[j]

Replaces ``examples/segment_softmax_probe.py`` ``make_pallas:36`` (the
fused per-(seed block, head) project -> score -> softmax -> weighted sum)
as ``EgoGATConv``'s ``block`` needs it
(``graph_learn_tpu/nn/layers/ego.py:163-175``): the self term ``el`` is an
input, where the probe takes it from each group's first row
(``el = (nbr[:, 0] . wn) . a_l`` gives the probe's case).  The CUDA source
is ``csrc/gat.cu``; its note gives the bound (operations) and the design:
``nh`` is never formed, the matrix product runs on the attention-weighted
neighbour sums, and the backward recomputes everything from the inputs.

:func:`gat_block` is differentiable in ``nbr``, ``wn``, ``ar``, ``el``,
``bn`` and ``ba``.  CUDA tensors launch the kernels (forward and, through
``torch.autograd.Function``, the hand-written backward) or raise; CPU
tensors take :func:`gat_block_plain`, differentiated by autograd.  Sums
across blocks in the backward use f32 ``atomicAdd``, so the last bits of
``d_wn``, ``d_ar``, ``d_bn`` vary from run to run.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.build import LaunchCounter, library

LAUNCHES_FWD = LaunchCounter("gat_block")
LAUNCHES_BWD = LaunchCounter("gat_block_bwd")
LEAKY_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gat_block_plain(nbr: torch.Tensor, wn: torch.Tensor, ar: torch.Tensor,
                    el: torch.Tensor, bn: Optional[torch.Tensor] = None,
                    ba: Optional[torch.Tensor] = None,
                    drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the projection written out, softmax over the fanout."""
    b, e, din = nbr.shape
    h, _, w = wn.shape
    nh = torch.einsum("nd,hdw->hnw", nbr.reshape(b * e, din).to(wn.dtype), wn)
    if bn is not None:
        nh = nh + bn[:, None, :]
    logits = el[..., None] + (nh * ar[:, None, :]).sum(-1).reshape(h, b, e)
    if ba is not None:
        logits = logits + ba[:, None, None]
    coef = torch.softmax(F.leaky_relu(logits, LEAKY_SLOPE), dim=2)
    if drop is not None:
        coef = coef * drop
    return (coef[..., None] * nh.reshape(h, b, e, w)).sum(dim=2)


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(library("gat"), name)
    if fn.argtypes is None:
        # (nbr, dtype code), the f32 pointers, b, the int sizes, the stream
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * n_ptr + [ctypes.c_longlong]
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise(rc: int, what: str):
    if rc == -2:
        raise InvalidArgumentError(
            "%s: heads * fanout is too large for the kernel's shared-memory "
            "softmax scratch" % what)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (what, rc))


class _GatBlock(torch.autograd.Function):
    """Launches csrc/gat.cu.  Saves the inputs only; the backward recomputes
    the softmax and the weighted neighbour sums."""

    @staticmethod
    def forward(ctx, nbr, wn, ar, el, bn, ba, drop):
        b, e, din = nbr.shape
        h, _, w = wn.shape
        dev = nbr.device
        # [wn; bn]: the bias rides as row Din of the weights, against a
        # constant 1 appended to every neighbour row inside the kernel
        wn_aug = wn if bn is None else torch.cat([wn, bn[:, None, :]], dim=1)
        wn_aug = wn_aug.detach().contiguous()
        k = wn_aug.shape[1]
        out = torch.empty((h, b, w), dtype=torch.float32, device=dev)
        ctx.save_for_backward(nbr, wn_aug, ar, el, ba, drop)
        ctx.has_bn = bn is not None
        if out.numel() == 0:
            return out
        v = torch.empty((h, k), dtype=torch.float32, device=dev)
        a = torch.empty((h, b, k), dtype=torch.float32, device=dev)
        fn = _fn("glt_gat_block_fwd", 8, 5)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(nbr.data_ptr(), _DTYPE_CODE[nbr.dtype], wn_aug.data_ptr(),
                    ar.data_ptr(), el.data_ptr(), _ptr(ba), _ptr(drop),
                    v.data_ptr(), a.data_ptr(), out.data_ptr(), b, e, din, k,
                    h, w, stream)
        _raise(rc, "gat_block")
        LAUNCHES_FWD.add()
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        nbr, wn_aug, ar, el, ba, drop = ctx.saved_tensors
        b, e, din = nbr.shape
        h, k, w = wn_aug.shape
        dev = nbr.device
        g = grad_out.to(torch.float32).contiguous()
        f32 = dict(dtype=torch.float32, device=dev)
        want_nbr = ctx.needs_input_grad[0]
        d_nbr = torch.empty((b, e, din), **f32) if want_nbr else None
        d_wn = torch.empty((h, k, w), **f32)
        d_ar = torch.empty((h, w), **f32)
        d_el = torch.empty((h, b), **f32)
        v = torch.empty((h, k), **f32)
        dv = torch.empty((h, k), **f32)
        a = torch.empty((h, b, k), **f32)
        da = torch.empty((h, b, k), **f32)
        fn = _fn("glt_gat_block_bwd", 14, 5)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(nbr.data_ptr(), _DTYPE_CODE[nbr.dtype], wn_aug.data_ptr(),
                    ar.data_ptr(), el.data_ptr(), _ptr(ba), _ptr(drop),
                    g.data_ptr(), v.data_ptr(), a.data_ptr(), da.data_ptr(),
                    dv.data_ptr(), _ptr(d_nbr), d_wn.data_ptr(),
                    d_ar.data_ptr(), d_el.data_ptr(), b, e, din, k, h, w,
                    stream)
        _raise(rc, "gat_block backward")
        LAUNCHES_BWD.add()
        d_bn = d_wn[:, din, :] if ctx.has_bn else None
        # z = el + er + ba: d_ba is d_el summed over the seeds
        d_ba = d_el.sum(dim=1) if ba is not None else None
        if want_nbr:
            d_nbr = d_nbr.to(nbr.dtype)
        return d_nbr, d_wn[:, :din, :], d_ar, d_el, d_bn, d_ba, None


def _check(name, t, shape, dev):
    if t is None:
        return
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise InvalidArgumentError(
            "gat_block: %s must be float32 %s, got %s %s"
            % (name, shape, t.dtype, tuple(t.shape)))
    if t.device != dev:
        raise InvalidArgumentError(
            "gat_block: inputs must be on one device, got %s on %s and nbr "
            "on %s" % (name, t.device, dev))
    if not t.is_contiguous():
        raise InvalidArgumentError("gat_block: %s must be contiguous" % name)


def gat_block(nbr: torch.Tensor, wn: torch.Tensor, ar: torch.Tensor,
              el: torch.Tensor, bn: Optional[torch.Tensor] = None,
              ba: Optional[torch.Tensor] = None,
              drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused neighbour block (shapes in the module note) -> [H, b, W]."""
    if nbr.dim() != 3 or wn.dim() != 3 or wn.shape[1] != nbr.shape[2]:
        raise InvalidArgumentError(
            "gat_block: want nbr [b, e, Din] and wn [H, Din, W], got %s and "
            "%s" % (tuple(nbr.shape), tuple(wn.shape)))
    b, e, din = nbr.shape
    h, _, w = wn.shape
    if e < 1 or din < 1 or h < 1 or w < 1:
        raise InvalidArgumentError(
            "gat_block: fanout, Din, heads and width must be at least 1, "
            "got %s and %s" % (tuple(nbr.shape), tuple(wn.shape)))
    if nbr.dtype not in _DTYPE_CODE or not nbr.is_contiguous():
        raise InvalidArgumentError(
            "gat_block: nbr must be contiguous float32/bfloat16, got %s"
            % nbr.dtype)
    dev = nbr.device
    for name, t, shape in (("wn", wn, (h, din, w)), ("ar", ar, (h, w)),
                           ("el", el, (h, b)), ("bn", bn, (h, w)),
                           ("ba", ba, (h,)), ("drop", drop, (h, b, e))):
        _check(name, t, shape, dev)
    if dev.type == "cpu":
        return gat_block_plain(nbr, wn, ar, el, bn, ba, drop)
    if not nbr.is_cuda:
        raise InvalidArgumentError(
            "gat_block: inputs must be on the CPU or on one CUDA device, "
            "got %s" % dev)
    return _GatBlock.apply(nbr, wn, ar, el, bn, ba, drop)
