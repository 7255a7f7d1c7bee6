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
is ``csrc/gat.cu`` (the products: ``csrc/gat_mma.cuh`` and
``csrc/gat_wgmma.cuh``); its note gives the
bound (bytes) and the design: ``nh`` is never formed, the matrix products
run on the attention-weighted neighbour sums ``a``, on the tensor cores in
split TF32 where the width allows, and the backward recomputes everything
from the inputs.

:func:`gat_block` is differentiable in ``nbr``, ``wn``, ``ar``, ``el``,
``bn`` and ``ba``.  CUDA tensors launch the kernels (forward and, through
``torch.autograd.Function``, the hand-written backward) or raise; CPU
tensors take :func:`gat_block_plain`, differentiated by autograd.  Sums
across blocks in the backward are added with atomics, so the last bits of
``d_wn``, ``d_ar``, ``d_bn`` vary from run to run.

The products take one of two hand-written routes, chosen by shape alone
(:func:`product_route`): ``"tensor"`` (TF32 tensor cores, each f32 operand
split into a TF32 high part and a residual, three passes summed in f32:
:func:`split_tf32` and :func:`split_tf32_matmul` restate that arithmetic
in plain torch) or ``"fma"`` (f32 FMA tiles, any width).  On the tensor
route the forward's product runs on ``wgmma`` where the depth allows
(:func:`forward_product_kernel`), every other product on ``mma.sync``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.kernels.build import (LaunchCounter, library,
                                                 refuse_export)

LAUNCHES_FWD = LaunchCounter("gat_block")
LAUNCHES_BWD = LaunchCounter("gat_block_bwd")
# launches (forward or backward) whose products took each route
ROUTE_LAUNCHES = {"tensor": LaunchCounter("gat_block products, tensor cores"),
                  "fma": LaunchCounter("gat_block products, f32 FMA")}
# forwards whose product ran on the wgmma kernel
WGMMA_LAUNCHES = LaunchCounter("gat_block forward product, wgmma")
LEAKY_SLOPE = 0.2
# the deepest (padded) K' whose weights a block of csrc/gat_wgmma.cuh keeps
# in shared memory (kMaxDepth there)
WGMMA_MAX_DEPTH = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# "mma": the tensor route without the wgmma kernel (asked for only: timing)
_ROUTE_CODE = {None: 0, "tensor": 1, "fma": 2, "mma": 3}
_ROUTE_NAME = {1: "tensor", 2: "fma"}
_USED_WGMMA = 4  # added to the reported route by csrc/gat.cu
# `what` of csrc/gat.cu glt_gat_block: the whole forward or backward, or
# one of its kernels alone
_WHAT = {"forward": -1, "backward": -2, "prep": 0, "attn_fwd": 1,
         "product_out": 2, "product_da": 3, "attn_bwd": 4, "product_dwn": 5,
         "tail": 6}


def product_route(w: int) -> str:
    """The route of the block's three products at output width ``w``: the
    tensor-core product moves every operand in 16-byte chunks, so it takes
    the widths that are a multiple of 4 floats; the f32 FMA product takes
    the rest.  (Din puts no condition: ``a`` and ``d_a`` are padded.)"""
    return "tensor" if w % 4 == 0 else "fma"


def forward_product_kernel(k: int, w: int) -> str:
    """The kernel of the forward's product ``out = a . wn'`` at depth ``k``
    (K': Din, plus 1 with a bias) and width ``w``: ``"wgmma"`` on the
    tensor route when a block can keep the whole padded depth of the
    weights in shared memory, else ``"mma.sync"``; ``"fma"`` on the FMA
    route.  The backward's two products are ``"mma.sync"`` on the tensor
    route: both read an operand with the depth as its rows, which TF32
    ``wgmma`` does not take, or have a depth that does not fit."""
    if product_route(w) == "fma":
        return "fma"
    return "wgmma" if padded_depth(k) <= WGMMA_MAX_DEPTH else "mma.sync"


def padded_depth(k: int) -> int:
    """Row length of the scratch ``a`` and ``d_a`` [H, b, .]: K' rounded up
    to a multiple of 4 floats, so that every row starts on 16 bytes."""
    return (k + 3) // 4 * 4


def to_tf32(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """A float32 tensor as a TF32 number (10 mantissa bits, the low 13 bits
    0): rounded to nearest, ties away from zero, or cut (the bits cleared,
    as the tensor core reads an f32 register)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -8192).view(torch.float32)


def split_tf32(x: torch.Tensor, rounded: bool = True):
    """(hi, lo) of a float32 tensor as csrc/gat_mma.cuh splits it: hi = x
    as a TF32 number (``rounded``: the forward's product; cut: the
    backward's two), lo = x - hi (exact in f32) as the tensor core reads
    it."""
    hi = to_tf32(x, rounded)
    return hi, to_tf32(x - hi, False)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3,
                      rounded: bool = True) -> torch.Tensor:
    """``a @ b`` as csrc/gat_mma.cuh computes it, in plain torch: every
    operand a TF32 number, products summed in f32, small terms first:
    lo.hi + hi.lo + hi.hi.  ``passes=1`` is a single TF32 pass (hi.hi).
    The sums here are torch's f32 sums: the tensor core's own, which cut
    instead of rounding, only the card shows."""
    a_hi, a_lo = split_tf32(a, rounded)
    b_hi, b_lo = split_tf32(b, rounded)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


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


def _entry():
    fn = library("gat").glt_gat_block
    if fn.argtypes is None:
        # what, force_route, (nbr, dtype code), 17 f32 pointers, *route, b,
        # (e, din, k, lda, nh, w), the stream
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int] + [ctypes.c_void_p] * 17
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy that starts on 16 bytes (a view into a larger
    tensor may not): the kernels move rows as 16-byte chunks."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _launch(what: str, t: dict, force_route: Optional[str] = None) -> str:
    """Call csrc/gat.cu on the tensors of ``t`` (keys as the C struct's
    fields; a missing or None one is passed as null).  Returns the route
    the products took, "" when nothing was launched."""
    nbr, wn = t["nbr"], t["wn"]
    b, e, din = nbr.shape
    h, k, w = wn.shape
    ptrs = [None if t.get(n) is None else t[n].data_ptr()
            for n in ("wn", "ar", "el", "ba", "drop", "g", "v", "a", "da",
                      "dv", "bt_hi", "bt_lo", "out", "d_nbr", "d_wn", "d_ar",
                      "d_el")]
    route = ctypes.c_int(0)
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream(nbr.device).cuda_stream
        rc = _entry()(_WHAT[what], _ROUTE_CODE[force_route], nbr.data_ptr(),
                      _DTYPE_CODE[nbr.dtype], *ptrs, ctypes.byref(route), b,
                      e, din, k, padded_depth(k), h, w, stream)
    if rc == -2:
        raise InvalidArgumentError(
            "gat_block %s: heads * (fanout, Din) is too large for the "
            "kernel's shared-memory scratch" % what)
    if rc != 0:
        raise RuntimeError("gat_block %s kernel launch failed: error %d"
                           % (what, rc))
    took = _ROUTE_NAME.get(route.value & ~_USED_WGMMA, "")
    want = "tensor" if force_route == "mma" else force_route
    if took and took != (want or product_route(w)):
        raise RuntimeError("gat_block %s: the products took the %s route, "
                           "the shape rule says %s"
                           % (what, took, product_route(w)))
    used_wgmma = bool(route.value & _USED_WGMMA)
    if used_wgmma != (took == "tensor" and force_route != "mma"
                      and what in ("forward", "product_out")
                      and forward_product_kernel(k, w) == "wgmma"):
        raise RuntimeError("gat_block %s: the wgmma kernel %s, the shape "
                           "rule says %s" % (what, "ran" if used_wgmma
                                             else "did not run",
                                             forward_product_kernel(k, w)))
    return took


def _scratch(t: dict, names) -> dict:
    """``t`` with the named scratch and output tensors allocated."""
    b, e, din = t["nbr"].shape
    h, k, w = t["wn"].shape
    lda = padded_depth(k)
    shapes = dict(v=(h, k), dv=(h, k), a=(h, b, lda), da=(h, b, lda),
                  bt_hi=(h, w, lda), bt_lo=(h, w, lda),
                  out=(h, b, w), d_nbr=(b, e, din), d_wn=(h, k, w),
                  d_ar=(h, w), d_el=(h, b))
    for n in names:
        t[n] = torch.empty(shapes[n], dtype=torch.float32,
                           device=t["nbr"].device)
    return t


class _GatBlock(torch.autograd.Function):
    """Launches csrc/gat.cu.  Saves the inputs only; the backward recomputes
    the softmax and the weighted neighbour sums."""

    @staticmethod
    def forward(ctx, nbr, wn, ar, el, bn, ba, drop):
        # [wn; bn]: the bias rides as row Din of the weights, against a
        # constant 1 appended to every neighbour row inside the kernel
        wn_aug = wn if bn is None else torch.cat([wn, bn[:, None, :]], dim=1)
        wn_aug = _aligned(wn_aug.detach().contiguous())
        nbr = _aligned(nbr)
        t = _scratch(dict(nbr=nbr, wn=wn_aug, ar=ar, el=el, ba=ba, drop=drop),
                     ("out",))
        ctx.save_for_backward(nbr, wn_aug, ar, el, ba, drop)
        ctx.has_bn = bn is not None
        if t["out"].numel() == 0:
            return t["out"]
        # the wgmma product reads the weights transposed and split
        on_wgmma = forward_product_kernel(*wn_aug.shape[1:]) == "wgmma"
        took = _launch("forward", _scratch(
            t, ("v", "a") + (("bt_hi", "bt_lo") if on_wgmma else ())))
        LAUNCHES_FWD.add()
        ROUTE_LAUNCHES[took].add()
        if on_wgmma:  # _launch has held the C side to the rule
            WGMMA_LAUNCHES.add()
        return t["out"]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        nbr, wn_aug, ar, el, ba, drop = ctx.saved_tensors
        din = nbr.shape[2]
        want_nbr = ctx.needs_input_grad[0]
        t = dict(nbr=nbr, wn=wn_aug, ar=ar, el=el, ba=ba, drop=drop,
                 g=_aligned(grad_out.to(torch.float32).contiguous()))
        _scratch(t, ("v", "dv", "a", "da", "d_wn", "d_ar", "d_el")
                 + (("d_nbr",) if want_nbr else ()))
        took = _launch("backward", t)
        LAUNCHES_BWD.add()
        if took:
            ROUTE_LAUNCHES[took].add()
        d_wn, d_el = t["d_wn"], t["d_el"]
        d_bn = d_wn[:, din, :] if ctx.has_bn else None
        # z = el + er + ba: d_ba is d_el summed over the seeds
        d_ba = d_el.sum(dim=1) if ba is not None else None
        d_nbr = t["d_nbr"].to(nbr.dtype) if want_nbr else None
        return d_nbr, d_wn[:, :din, :], t["d_ar"], d_el, d_bn, d_ba, None


class GatParts:
    """The kernels of one forward and backward of :func:`gat_block`, one at
    a time, on fixed inputs and with the scratch allocated once: for timing
    each part and for running the products on either route (``"mma"``: the
    tensor route with every product on ``mma.sync``).  ``run(part)``
    launches one of ``PARTS`` (not counted as a launch of the block); a
    part reads what the parts before it in ``PARTS`` wrote, and a lone
    ``product_dwn`` or ``tail`` adds into ``d_wn`` / ``d_ar`` as they are.
    """

    PARTS = ("prep", "attn_fwd", "product_out", "product_da", "attn_bwd",
             "product_dwn", "tail")

    def __init__(self, nbr, wn, ar, el, g):
        if not nbr.is_cuda:
            raise InvalidArgumentError("GatParts: the inputs must be on a "
                                       "CUDA device, got %s" % nbr.device)
        self.t = _scratch(
            dict(nbr=_aligned(nbr), wn=_aligned(wn.detach().contiguous()),
                 ar=ar.detach(), el=el.detach(), g=_aligned(g)),
            ("v", "dv", "a", "da", "bt_hi", "bt_lo", "out", "d_wn", "d_ar",
             "d_el"))
        for n in ("dv", "d_wn", "d_ar"):
            self.t[n].zero_()

    def run(self, part: str, route: Optional[str] = None) -> str:
        if part not in self.PARTS:
            raise InvalidArgumentError("GatParts: no part %r" % part)
        return _launch(part, self.t, route)


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
    refuse_export("gat_block")
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
