"""The fused GAT neighbour block against its unfused forms.

Counterpart of ``examples/segment_softmax_probe.py`` (``main:88-188``).
The per-seed neighbour attention of a GAT layer (project -> score ->
softmax over the k2 neighbours -> weighted sum) can be computed without
writing the wide ``[N, heads * width]`` projections to memory.  This probe
times its forward at the 62M-edge frontier shape (15 360 seeds, k2 10,
D 128, 8 heads x 256, f32, seed blocks of 512), in three variants on the
same ``[N, D]`` rows:

  bar      :func:`bar`, the unfused torch forward at full N: the einsum
           writes ``Wx`` [N, H, W], then the scores, the softmax and a
           second einsum
  chunked  :func:`chunked`, the same formula over blocks of seeds
  fused    :func:`fused`, Kernel 3 (``gat_block``'s forward) with the
           probe's self term ``el = (nbr[:, 0] . wn) . a_l``, which it
           takes as an input (``ops/kernels/gat.py:13-16``); ``el`` is
           computed first as ``nbr[:, 0] . (wn . a_l)``

Semantics as the JAX probe: ``score_ij = leaky_relu(a_l . Wh_i + a_r .
Wh_j, 0.2)`` with ``Wh_i`` the group's first row's projection, the
softmax over the k2 neighbours, ``out = sum_j alpha_ij Wh_j`` ->
``[H, seeds, W]``.  The rows are gathered already: the gather is measured
elsewhere.  ``fused`` and ``chunked`` are held to ``bar`` within 3e-3 on
the card (f32 sums in other orders and the kernel's split-TF32 products;
the JAX script's hardware limit) and 2e-4 on the CPU, where ``fused`` is
the plain version.  On the card the variants are timed between CUDA
events, ``bar`` and ``fused`` with the stream held while the host queues
the calls (the card's time alone), ``chunked`` without (its hundreds of
launches a call would fill the launch queue of a held stream, so its
time includes the host's launches); on the CPU on the host clock.

Usage:  python -m graph_learn_tpu_torch.examples.segment_softmax_probe
            [--small] [--steps N] [--block S] [--cpu]
``--small``: (2 048 seeds, 10, 128, 4 heads, 128), blocks of at most 256.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.ops.kernels.gat import LEAKY_SLOPE, gat_block
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device
from graph_learn_tpu_torch.utils.timing import time_ms

FULL = (15_360, 10, 128, 8, 256)  # seeds, k2, D, heads, width
SMALL = (2_048, 10, 128, 4, 128)
# fused and chunked against bar: the JAX script's limits
CARD_TOL = 3e-3
CPU_TOL = 2e-4


def _attend(wx: torch.Tensor, al: torch.Tensor, ar: torch.Tensor,
            k2: int) -> torch.Tensor:
    """[n, H, W] projections -> [H, n // k2, W] attention outputs."""
    n, h, w = wx.shape
    s = n // k2
    er = (wx * ar[:, 0][None]).sum(-1).reshape(s, k2, h)
    el = (wx * al[:, 0][None]).sum(-1).reshape(s, k2, h)[:, :1]
    alpha = torch.softmax(F.leaky_relu(el + er, LEAKY_SLOPE), dim=1)
    return torch.einsum("skh,skhw->hsw", alpha, wx.reshape(s, k2, h, w))


def bar(x: torch.Tensor, w: torch.Tensor, al: torch.Tensor,
        ar: torch.Tensor, k2: int) -> torch.Tensor:
    """The unfused forward: x [N, D], w [H, D, W], al / ar [H, 1, W] ->
    [H, N // k2, W]; ``Wx`` [N, H, W] is written whole."""
    return _attend(torch.einsum("nd,hdw->nhw", x, w), al, ar, k2)


def chunked(x: torch.Tensor, w: torch.Tensor, al: torch.Tensor,
            ar: torch.Tensor, k2: int, block: int) -> torch.Tensor:
    """:func:`bar` over blocks of ``block`` seeds."""
    rows = block * k2
    return torch.cat([bar(x[lo:lo + rows], w, al, ar, k2)
                      for lo in range(0, x.shape[0], rows)], dim=1)


def fused(x: torch.Tensor, w: torch.Tensor, al: torch.Tensor,
          ar: torch.Tensor, k2: int) -> torch.Tensor:
    """Kernel 3's forward on the probe's layout (the plain version on the
    CPU)."""
    nbr = x.reshape(-1, k2, x.shape[1])
    # el[h, s] = (nbr[s, 0] . w[h]) . a_l[h] = nbr[s, 0] . (w[h] . a_l[h])
    vl = torch.einsum("hdw,hw->hd", w, al[:, 0])
    el = torch.einsum("sd,hd->hs", nbr[:, 0], vl).contiguous()
    return gat_block(nbr, w, ar[:, 0].contiguous(), el)


def inputs(n_seeds: int, k2: int, d: int, h: int, w: int,
           device: torch.device, seed: int = 0):
    """x [n_seeds * k2, D] standard normal from a torch generator on the
    device; w, al, ar 0.1 x standard normal from numpy (the JAX script's
    draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n_seeds * k2, d), generator=gen, device=device)
    rng = np.random.default_rng(seed)
    w_, al, ar = (torch.from_numpy(rng.standard_normal(s, np.float32) * 0.1)
                  .to(device) for s in ((h, d, w), (h, 1, w), (h, 1, w)))
    return x, w_, al, ar


def run(small: bool = False, steps: int = 30, block: int = 512,
        device: DeviceLike = "cuda") -> Dict[str, object]:
    """Check ``fused`` and ``chunked`` against ``bar`` and time all three;
    returns the shape, the times (ms), ``fused_over_bar`` (bar's time over
    fused's) and the errors."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_seeds, k2, d, h, w = SMALL if small else FULL
    if small:
        block = min(block, 256)
    n_blocks = -(-n_seeds // block)
    n_seeds = n_blocks * block
    x, w_, al, ar = inputs(n_seeds, k2, d, h, w, dev)
    fns: Dict[str, Callable[[], torch.Tensor]] = {
        "bar": lambda: bar(x, w_, al, ar, k2),
        "chunked": lambda: chunked(x, w_, al, ar, k2, block),
        "fused": lambda: fused(x, w_, al, ar, k2)}
    tol = CARD_TOL if on_card else CPU_TOL
    out: Dict[str, object] = {
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "timer": "cuda events" if on_card else "host clock",
        "seeds": n_seeds, "k2": k2, "D": d, "heads": h, "width": w,
        "block": block, "tol": tol,
        "wx_bytes": n_seeds * k2 * h * w * 4}
    with torch.no_grad():
        want = fns["bar"]()
        for name in ("chunked", "fused"):
            got = fns[name]()
            err = (got - want).abs().max().item()
            out[name + "_max_abs_err"] = err
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                raise RuntimeError("%s differs from bar: max abs err %g "
                                   "(limit %g)" % (name, err, tol))
        del want, got
        for name, fn in fns.items():
            if on_card:
                out[name + "_ms"] = time_ms(fn, iters=steps, warmup=2,
                                            hold=name != "chunked")
            else:
                fn()
                t0 = time.perf_counter()
                for _ in range(steps):
                    fn()
                out[name + "_ms"] = (time.perf_counter() - t0) / steps * 1e3
    out["fused_over_bar"] = out["bar_ms"] / out["fused_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    r = run(args.small, args.steps, args.block,
            "cpu" if args.cpu else "cuda")
    print("[probe] %s, %s: seeds=%d k2=%d D=%d heads=%d width=%d block=%d "
          "(Wx if written: %.2f GB)"
          % (r["device"], r["timer"], r["seeds"], r["k2"], r["D"],
             r["heads"], r["width"], r["block"], r["wx_bytes"] / 1e9),
          flush=True)
    for label, key in (("bar: unfused torch fwd", "bar_ms"),
                       ("chunked: seed blocks fwd", "chunked_ms"),
                       ("fused: gat_block fwd", "fused_ms")):
        print("%-26s %.3f ms" % (label, r[key]), flush=True)
    print("[probe] fused and chunked within %g of bar (max abs err %g, %g); "
          "fused/bar = %.2fx" % (r["tol"], r["fused_max_abs_err"],
                                 r["chunked_max_abs_err"],
                                 r["fused_over_bar"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
