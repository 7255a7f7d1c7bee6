"""Microbench: the deepest hop's group mean, sorted against plain, and its
parts, at the 62M-edge frontier shapes.

Counterpart of ``examples/gather_micro.py`` (``make_variants:45``,
``run:102``).  A training step at the frontier reduces 153 600 random rows
(batch 1 024, fanout [15, 10]) of a 2 450 000 x 100 table, far larger than
the card's L2, to 15 360 group means.  Sorting the row ids makes the
gather walk memory in order but breaks the output order, unless the
consumer is a sum over each group: then the sort's permutation goes into
the segment ids and is never undone.  The JAX script's six variants, in
torch ops (``index_select``, ``argsort``, ``index_add_``):

  plain             gather, reshape, mean over the group
  sorted_seg        argsort, gather in sorted order, index_add_ into the
                    groups
  sort_only         the argsort alone
  gather_only       the gather alone
  gather_presorted  the gather of ids sorted once, ahead
  segsum_only       sorted_seg with the rows from a 1 024-row slab (the
                    scatter-add's cost without the random reads)

and two rows that are the port's own routes of the same mean
(``ops/aggregate.py gather_group_agg``): ``kernel_sorted``
(``conf.sorted_gather``: ``sweep_prep``, then Kernel 4
``sweep_aggregate``) and ``kernel_unsorted`` (Kernel 2
``segment_spmm``).  On this card "sorted against plain" is those two rows
beside ``plain``.  (XLA may shrink the JAX ``gather_only`` to the one
element it reads; torch's runs the whole gather.)

Each variant runs K = 24 iterations with the JAX script's per-step index
variation (``vary``: ``(idx + i * 7919) % n_rows``) and adds one element
of each iteration's result into a checksum.  On the card the 24
iterations are one captured CUDA graph (after an eager warm-up on a side
stream), replayed each call; on the CPU they run eagerly.  The first call
is the warm-up, then ``iters`` calls are timed on the host clock, and the
pull of their checksums is the only barrier: ms an iteration.  The
numeric check is ``max_abs_diff``: ``gather_group_agg(..., "mean")``
under ``conf.sorted_gather = True, sorted_gather_min_bytes = 0`` (Kernel
4 on the card) against the plain mean in float32.

Usage:  python -m graph_learn_tpu_torch.examples.gather_micro [--small]
            [--cpu]
Prints bf16 D=100: and f32 D=100: blocks, one ``<name>_ms`` line per
variant and the ``max_abs_diff``.  ``--small``: a 20 000-row table, batch
64.
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

K = 24
PRIME = 7919
SLAB = 1024
VARIANTS = ("plain", "sorted_seg", "sort_only", "gather_only",
            "gather_presorted", "segsum_only")
KERNEL_ROWS = ("kernel_sorted", "kernel_unsorted")
SMALL = dict(n_rows=20_000, b=64)


def make_variants(n_rows: int, nseg: int, k2: int,
                  d: int) -> Dict[str, Callable]:
    """{name: body(table, idx0, i) -> the scalar iteration i adds to the
    checksum}, the JAX script's variants and the two kernel routes."""

    def vary(idx0, i):
        return (idx0 + i * PRIME) % n_rows

    def rows_of(table, idx):
        return torch.index_select(table, 0, idx)

    def segsum(rows, order):
        seg = torch.div(order, k2, rounding_mode="floor")
        out = torch.zeros((nseg, d), dtype=torch.float32, device=rows.device)
        return out.index_add_(0, seg, rows)

    def plain(table, idx0, i):
        rows = rows_of(table, vary(idx0, i))
        return rows.reshape(nseg, k2, d).float().mean(1)[0, 0]

    def sorted_seg(table, idx0, i):
        idx = vary(idx0, i)
        order = torch.argsort(idx, stable=True)
        rows = rows_of(table, idx[order]).float()
        return (segsum(rows, order) / k2)[0, 0]

    def sort_only(table, idx0, i):
        return torch.argsort(vary(idx0, i), stable=True)[0].float()

    def gather_only(table, idx0, i):
        return rows_of(table, vary(idx0, i))[0, 0].float()

    def gather_presorted(table, idx0, i):
        # idx0 sorted with headroom: + i keeps it sorted
        return rows_of(table, idx0 + i)[0, 0].float()

    def segsum_only(table, idx0, i):
        idx = vary(idx0, i)
        order = torch.argsort(idx, stable=True)
        rows = rows_of(table, idx[order] % SLAB).float()
        return segsum(rows, order)[0, 0]

    def kernel(sorted_route):
        def body(table, idx0, i):
            with bench.bench_conf(sorted_gather=sorted_route,
                                  sorted_gather_min_bytes=0):
                out = gather_group_agg(table, vary(idx0, i).reshape(nseg, k2),
                                       "mean")
            return out[0, 0].float()
        return body

    return dict(plain=plain, sorted_seg=sorted_seg, sort_only=sort_only,
                gather_only=gather_only, gather_presorted=gather_presorted,
                segsum_only=segsum_only, kernel_sorted=kernel(True),
                kernel_unsorted=kernel(False))


class Scan:
    """K iterations of ``body`` summed into one f32 checksum a call: one
    CUDA graph on the card (captured at the first call, after an eager
    run on a side stream), eager on the CPU."""

    def __init__(self, body: Callable, table: torch.Tensor,
                 idx0: torch.Tensor):
        self.body, self.table, self.idx0 = body, table, idx0
        self.graph = None
        self.out = None

    def _run(self) -> torch.Tensor:
        c = torch.zeros((), dtype=torch.float32, device=self.table.device)
        for i in range(K):
            c = c + self.body(self.table, self.idx0, i)
        return c

    def __call__(self) -> torch.Tensor:
        dev = self.table.device
        if dev.type != "cuda":
            return self._run()
        if self.graph is None:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._run()
        self.graph.replay()
        return self.out


def timed_scan(fn: Scan, iters: int = 3):
    """(seconds an iteration, the checksum of one call): one warm-up call,
    then ``iters`` calls whose checksums are pulled once at the end."""
    first = float(fn())  # capture + first run
    t0 = time.perf_counter()
    outs = [fn().clone() for _ in range(iters)]
    float(torch.stack(outs).sum())  # the one barrier
    return (time.perf_counter() - t0) / (iters * K), first


def draw(n_rows: int, d: int, n: int, dtype: str):
    """The JAX script's draws, in its order: the table (standard normal,
    float32, then cast) and ``n`` ids in [0, n_rows - K - 1) from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n_rows, d), np.float32)
    idx = rng.integers(0, n_rows - K - 1, n).astype(np.int32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return torch.from_numpy(table).to(tdt), torch.from_numpy(idx)


def run(n_rows: int = 2_450_000, d: int = 100, b: int = 1024, k1: int = 15,
        k2: int = 10, dtype: str = "bfloat16", iters: int = 3,
        device: DeviceLike = "cuda",
        inspect: Optional[Callable] = None) -> Dict[str, object]:
    """Time each variant (ms an iteration under
    ``<name>_ms``, the checksum of one call under "checksum") and measure
    ``max_abs_diff``.  ``inspect(name, body, table, idx0)``, where given,
    is called for each variant after its timing."""
    dev = resolve_device(device)
    table, idx = draw(n_rows, d, b * k1 * k2, dtype)
    table, idx = table.to(dev), idx.to(dev)
    idx_sorted = torch.sort(idx).values
    nseg = b * k1
    fns = make_variants(n_rows, nseg, k2, d)
    res: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "dtype": dtype, "checksum": {}}
    for name in VARIANTS + KERNEL_ROWS:
        arg = idx_sorted if name == "gather_presorted" else idx
        scan = Scan(fns[name], table, arg)
        dt, res["checksum"][name] = timed_scan(scan, iters)
        res[name + "_ms"] = dt * 1e3
        if inspect is not None:
            inspect(name, fns[name], table, arg)
        del scan
        gc.collect()
    # the numeric check against the plain mean
    want = table[idx.long()].float().reshape(nseg, k2, d).mean(1)
    with bench.bench_conf(sorted_gather=True, sorted_gather_min_bytes=0):
        got = gather_group_agg(table, idx.reshape(nseg, k2), "mean")
    res["max_abs_diff"] = (got.float() - want).abs().max().item()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    size = SMALL if args.small else {}
    for label, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        print("%s D=100:" % label)
        res = run(dtype=dtype, device=dev, **size)
        for k, v in res.items():
            if k.endswith("_ms") or k == "max_abs_diff":
                print("  %-22s %.4f" % (k, v))
        print("  (%s)" % res["device"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
