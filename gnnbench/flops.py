"""Operations and bytes: the yardstick of ``train_mfu``, ``step_mfu`` and
the kernels' roofline shares.

Every count is of the least work that the layer equations need at the
cell's shapes, forward plus backward, with no recompute, so that no route,
association or precision that a later program takes can read above 100%:

* ``products`` are multiply-adds of contractions (matrix products, batched
  or not), held to the tensor-core rate of an f32-accurate product (TF32);
* ``other`` is the remaining f32 arithmetic (elementwise, reductions,
  softmax, Adam), held to the f32 rate outside the tensor cores;
* the least time of a count is ``products / tf32 + other / fp32``; of a
  kernel, the larger of that and its bytes over the memory bandwidth.

Bytes count each distinct input row read once, each output written once
and the ids, as the traced steps' own ids fix them.

The peaks are in ``peaks.json``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


@dataclasses.dataclass
class Work:
    """Operations and bytes of some work; ``+`` adds two."""

    products: float = 0.0
    other: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.products + o.products, self.other + o.other,
                    self.bytes + o.bytes)


def load_peaks(name: str) -> dict:
    """The named entry of ``peaks.json``: ``tf32_flops``, ``fp32_flops``,
    ``hbm_bytes_per_s``."""
    return json.loads(PEAKS_FILE.read_text())[name]


def compute_s(w: Work, peaks: dict) -> float:
    """The least seconds of ``w``'s operations."""
    return w.products / peaks["tf32_flops"] + w.other / peaks["fp32_flops"]


def least_s(w: Work, peaks: dict) -> float:
    """The least seconds of ``w``: operations or bytes, whichever bound."""
    return max(compute_s(w, peaks), w.bytes / peaks["hbm_bytes_per_s"])


def adam(n_params: int) -> Work:
    """One Adam update: two moments, the bias corrections, the step."""
    return Work(other=12.0 * n_params)


def cross_entropy(b: int, c: int) -> Work:
    """Mean softmax cross-entropy over [b, c] logits and its gradient."""
    return Work(other=8.0 * b * c)


def sage_step(b: int, fanout: Sequence[int], dims: Sequence[int],
              bias: bool) -> Work:
    """One training step of EgoGraphSAGE ``dims`` [d0, ..., dN], agg
    "mean" (each conv one Linear of a node's row concatenated with its
    neighbours' mean, with ``bias`` or without), on an N-hop batch of ``b``
    seeds with ``fanout`` [k1, ..., kN]: the deepest hop's means, every
    layer forward, the loss, the weight gradients (the features take none)
    and Adam.

    Hop j holds ``r_j = b k1 ... kj`` rows (hop 0 the seeds); layer i maps
    hops 0 ... N - 1 - i, each row with the mean of its ``k_{j+1}``
    neighbours in hop j + 1 (the deepest of layer 0's means are the
    pre-averaged hop N); relu after every layer but the last."""
    n = len(fanout)
    if len(dims) != n + 1:
        raise ValueError("%d layers on %d hops" % (len(dims) - 1, n))
    rows = [b]
    for k in fanout:
        rows.append(rows[-1] * k)
    fwd, bwd, n_params = Work(), Work(), 0
    for i in range(n):
        din, dout = dims[i], dims[i + 1]
        out_rows = sum(rows[:n - i])        # layer i's outputs
        # every output row's mean of its neighbours in the next hop
        means = sum(rows[j] * (fanout[j] + 1) for j in range(n - i)) * din
        gemm = 2.0 * out_rows * 2 * din * dout
        relu = out_rows * dout if i < n - 1 else 0
        biases = out_rows * dout if bias else 0
        fwd += Work(products=gemm, other=means + relu + biases)
        bwd += Work(products=gemm, other=biases)              # dW, d bias
        if i > 0:  # d [x; mean], the means' and the previous relu's
            bwd += Work(products=gemm,
                        other=means + sum(rows[:n - i + 1]) * din)
        n_params += 2 * din * dout + (dout if bias else 0)
    return fwd + bwd + cross_entropy(b, dims[-1]) + adam(n_params)


def gather_rows(distinct: int, rows: int, d: int, itemsize: int) -> Work:
    """Kernel 1 on ``rows`` ids of a [N, d] table: each of the ``distinct``
    rows read once, every output row written, the ids read."""
    return Work(bytes=float(distinct * d * itemsize + rows * d * itemsize
                            + rows * 4))


def group_mean(distinct: int, groups: int, k: int, d: int,
               itemsize: int) -> Work:
    """Kernel 2's means of ``groups`` groups of ``k`` ids: the sums, the
    scale, each distinct row read once, the f32 means written, the ids
    read."""
    return Work(other=float(groups * k * d + groups * d),
                bytes=float(distinct * d * itemsize + groups * d * 4
                            + groups * k * 4))
