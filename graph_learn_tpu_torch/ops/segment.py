"""Segment primitives over flat CSR rows.

Counterpart of ``graph_learn_tpu/ops/segment.py:173-177``.  The tiled
gathers of the JAX package (``flat_gather``, ``pair_gather``) exist for
the TPU's layout only; flat tensors index directly here.
"""

from __future__ import annotations

import torch


def row_bounds(row_offsets: torch.Tensor, rows: torch.Tensor):
    """(start, end, degree) of each row, any batch shape."""
    start = row_offsets[rows]
    end = row_offsets[rows + 1]
    return start, end, end - start
