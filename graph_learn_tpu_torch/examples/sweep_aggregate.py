"""Sweep-aggregate harness: the deepest-hop group mean of the 62M-edge
frontier, stage by stage.

Counterpart of ``examples/sweep_aggregate.py`` ``main:155``.  At the
frontier shape the feature table (2 457 600 x 128 f32, 1.26 GB) is many
times the card's L2, and a training step reduces 153 600 random rows of it
(batch 1024, fanout [15, 10]) to 15 360 group means.  The harness times:

  bar      the op being replaced: ``gather_group_agg`` on Kernel 2
           (``segment_spmm``), and the plain
           ``table[flat].reshape(G, k, D).mean(1)`` beside it
  prep     ``sweep_prep``: stable sort of the flat ids + packed hit list
  stream   Kernel 5 ``stream_sum``: what reading the whole table costs
  sweep    Kernel 4 ``sweep_aggregate``: the sorted hits added into [G, D]
  total    prep + sweep, against the bar

then holds ``sweep / k`` against the plain mean and the stream sum against
a float64 column sum.  On the card the stages are timed between CUDA
events with the stream held, so the times are the card's alone; on the CPU
(``--small --cpu``) the plain versions run and the host clock times them.

Usage:  python -m graph_learn_tpu_torch.examples.sweep_aggregate
            [--small] [--steps N] [--slab R] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
from graph_learn_tpu_torch.ops.kernels.sweep import (stream_sum,
                                                     sweep_aggregate,
                                                     sweep_prep)
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device
from graph_learn_tpu_torch.utils.timing import time_ms

D = 128
# sweep / k against the plain mean: both sum k f32 terms, in other orders
SWEEP_TOL = 1e-5
# the stream sum against a float64 column sum: n_rows f32 terms added in
# another order, so the error is held relative to the column's sum of
# magnitudes
STREAM_TOL = 1e-6


@contextlib.contextmanager
def _unsorted_gather():
    old = conf.sorted_gather
    conf.sorted_gather = False
    try:
        yield
    finally:
        conf.sorted_gather = old


def _host_ms(fn: Callable[[], object], iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def run(small: bool = False, steps: int = 30, slab: int = 4096,
        device: DeviceLike = "cuda") -> Dict[str, object]:
    """Time every stage and check both kernels; returns the numbers."""
    dev = resolve_device(device)
    if small:
        n_rows, n, k = 20_000, 8_192 * 2, 8
    else:
        # 2.45M rows x 100 features (padded to 128), 153.6k draws
        n_rows, n, k = 2_457_600, 153_600, 10
    groups = n // k

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((n_rows, D), generator=gen, device=dev,
                        dtype=torch.float32)
    rng = np.random.default_rng(0)
    keys = [torch.from_numpy(rng.integers(0, n_rows, n, dtype=np.int32))
            .to(dev) for _ in range(4)]
    on_card = dev.type == "cuda"

    def timed(fn, *argsets):
        """Mean ms of ``fn`` over ``steps`` calls, the argument sets taken
        in turn."""
        turn = itertools.cycle(argsets)
        call = lambda: fn(*next(turn))  # noqa: E731
        if on_card:
            return time_ms(call, iters=steps, warmup=3, hold=True)
        return _host_ms(call, steps)

    def plain_mean(flat):
        return table[flat.long()].reshape(groups, k, D).mean(1)

    def bar(flat):
        with _unsorted_gather():
            return gather_group_agg(table, flat.reshape(groups, k), "mean")

    out = {
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "timer": ("cuda events, stream held" if on_card else "host clock"),
        "n_rows": n_rows, "n_hits": n, "k": k, "groups": groups, "slab": slab,
        "table_bytes": table.numel() * table.element_size(),
        "bar_ms": timed(bar, *[(f,) for f in keys]),
        "bar_plain_ms": timed(plain_mean, *[(f,) for f in keys]),
        "prep_ms": timed(lambda f: sweep_prep(f, k, n_rows, slab),
                         *[(f,) for f in keys]),
    }
    preps = [sweep_prep(f, k, n_rows, slab) for f in keys]
    out["stream_ms"] = timed(stream_sum, (table,))
    out["sweep_ms"] = timed(
        lambda s, p: sweep_aggregate(s, p, table, groups, slab), *preps)
    out["total_ms"] = out["prep_ms"] + out["sweep_ms"]

    got = sweep_aggregate(*preps[0], table, groups, slab) / k
    want = plain_mean(keys[0])
    out["sweep_max_abs_err"] = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=SWEEP_TOL, atol=SWEEP_TOL):
        raise RuntimeError("sweep / k differs from the plain mean: max abs "
                           "err %g" % out["sweep_max_abs_err"])
    if not torch.allclose(bar(keys[0]), want, rtol=SWEEP_TOL, atol=SWEEP_TOL):
        raise RuntimeError("the bar differs from the plain mean")
    col = stream_sum(table)[0].double()
    err = (col - table.sum(0, dtype=torch.float64)).abs()
    limit = STREAM_TOL * table.abs().sum(0, dtype=torch.float64)
    out["stream_max_abs_err"] = err.max().item()
    if not bool((err <= limit).all()):
        raise RuntimeError("the stream sum is off by %g (limit %g)"
                           % (err.max().item(), limit.min().item()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--slab", type=int, default=4096)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (with --small)")
    args = ap.parse_args(argv)
    r = run(small=args.small, steps=args.steps, slab=args.slab,
            device="cpu" if args.cpu else "cuda")
    print("[sweep] %s, %s: rows=%d N=%d k=%d slab=%d table=%.2f GB"
          % (r["device"], r["timer"], r["n_rows"], r["n_hits"], r["k"],
             r["slab"], r["table_bytes"] / 1e9))
    for label, key in (("bar: segment_spmm group mean", "bar_ms"),
                       ("bar: plain gather+reshape-mean", "bar_plain_ms"),
                       ("prep: sort+packed hitlist", "prep_ms"),
                       ("stream: full-table sum", "stream_ms"),
                       ("sweep: sorted scatter-add", "sweep_ms")):
        print("%-32s %.4f ms" % (label, r[key]))
    print("[sweep] total sweep path = %.4f ms (prep %.4f + kernel %.4f) vs "
          "bar %.4f ms; max abs err: sweep %g, stream %g"
          % (r["total_ms"], r["prep_ms"], r["sweep_ms"], r["bar_ms"],
             r["sweep_max_abs_err"], r["stream_max_abs_err"]))
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
