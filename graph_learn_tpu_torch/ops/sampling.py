"""Neighbour sampling: the GSL ``.sample(k).by("random")`` strategy.

Counterpart of ``graph_learn_tpu/ops/sampling.py`` ``uniform_sample:204``
and ``_gather:116`` over flat CSR tensors (no per-seed tile windows).
Uniform with replacement; zero-degree seeds are filled with
``conf.default_neighbor_id`` and edge id -1.

The draw is split in two so that a test can feed both packages the same
uniform numbers: :func:`uniform_positions` maps ``u`` to CSR positions,
:func:`uniform_draw` turns given ``u`` into (neighbour, edge) ids, and
:func:`uniform_sample` draws ``u`` from an explicit ``torch.Generator``.
Filters, ``topk`` and the weighted samplers are not yet ported.
"""

from __future__ import annotations

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.store import DeviceCSR
from graph_learn_tpu_torch.ops.segment import row_bounds


def uniform_positions(start: torch.Tensor, deg: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Flat CSR positions ``start + min(floor(u*deg), max(deg,1)-1)``.

    ``start``/``deg`` are [b], ``u`` is [b, k] float32 in [0, 1); the
    float32 product matches the JAX package's arithmetic exactly.
    """
    d = deg[:, None]
    idx = torch.floor(u * d).to(torch.int32)
    idx = torch.minimum(idx, torch.clamp(d, min=1) - 1)
    return start[:, None] + idx


def _gather(csr: DeviceCSR, pos: torch.Tensor, valid: torch.Tensor):
    """(nbr_ids, edge_ids) at flat CSR positions, filled where invalid."""
    posc = torch.clamp(pos, 0, max(csr.num_edges - 1, 0))
    ids = csr.nbr_ids[posc]
    eids = csr.nbr_edge_ids[posc]
    fill = torch.tensor(conf.default_neighbor_id, dtype=ids.dtype,
                        device=ids.device)
    ids = torch.where(valid, ids, fill)
    eids = torch.where(valid, eids, torch.full_like(eids, -1))
    return ids, eids


def uniform_draw(csr: DeviceCSR, seeds: torch.Tensor, u: torch.Tensor):
    """Uniform neighbours of ``seeds`` [b] for given ``u`` [b, k]."""
    start, _, deg = row_bounds(csr.row_offsets, seeds)
    pos = uniform_positions(start, deg, u)
    return _gather(csr, pos, (deg > 0)[:, None])


def uniform_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                   generator: torch.Generator):
    """Uniform with replacement.  Returns (nbr_ids [b,k], edge_ids [b,k])."""
    u = torch.rand((seeds.shape[0], k), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    return uniform_draw(csr, seeds, u)
