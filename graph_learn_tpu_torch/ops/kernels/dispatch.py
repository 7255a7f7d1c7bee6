"""Routing of feature-row gathers onto Kernel 1.

Counterpart of ``graph_learn_tpu/ops/pallas/dispatch.py:39-64``
``feature_gather``.  It keeps the clip of indices into the table.  There
is no flag and no size, dtype or width gate: a CUDA table always goes
through the ``gather_rows`` kernel, a CPU table through its plain version.
"""

from __future__ import annotations

import torch

from graph_learn_tpu_torch.ops.kernels.gather import gather_rows


def feature_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 2-D float table; idx of any shape -> idx.shape + (D,)."""
    flat = torch.clamp(idx.reshape(-1), 0, max(table.shape[0] - 1, 0))
    out = gather_rows(table, flat.to(torch.int32).contiguous())
    return out.reshape(tuple(idx.shape) + (table.shape[1],))
