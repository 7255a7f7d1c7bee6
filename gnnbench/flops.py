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


def sage_step(b: int, k1: int, k2: int, d: int, h: int, c: int,
              bias: bool) -> Work:
    """One training step of EgoGraphSAGE [d, h, c], agg "mean" (each conv
    one Linear of a node's row concatenated with its neighbours' mean, with
    ``bias`` or without), on a 2-hop batch of ``b`` seeds with fanout
    [k1, k2]: the deepest hop's means, both layers forward, the loss, the
    weight gradients (the features take none) and Adam."""
    n1 = b * k1
    rows0 = n1 + b                          # layer 0's outputs
    fwd = Work(
        products=2.0 * rows0 * 2 * d * h + 2.0 * b * 2 * h * c,
        other=(n1 * (k2 + 1) * d            # the deepest hop's means
               + b * (k1 + 1) * d           # the seeds' mean of hop 1
               + rows0 * h                  # relu
               + b * (k1 + 1) * h           # layer 1's mean of hop 1
               + (rows0 * h + b * c if bias else 0)))
    bwd = Work(
        products=(2.0 * rows0 * 2 * d * h          # dW0
                  + 4.0 * b * 2 * h * c),          # dW1, d [h; mean]
        other=(2.0 * b * (k1 + 1) * h              # mean, relu
               + (rows0 * h + b * c if bias else 0)))   # d bias
    n_params = 2 * d * h + 2 * h * c + (h + c if bias else 0)
    return fwd + bwd + cross_entropy(b, c) + adam(n_params)


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
