"""Neighbour sampling: the GSL ``.sample(k).by(strategy)`` strategies.

Counterpart of ``graph_learn_tpu/ops/sampling.py`` over flat CSR tensors
(no per-seed tile windows): ``uniform_sample:204`` (``random``),
``topk_sample:224``, ``weighted_sample:251`` (``edge_weight`` and
``in_degree``, by bisection of the per-row CDFs the "full" store profile
carries), ``wor_positions:310`` / ``without_replacement_sample:375`` and
``full_sample:391``.  All return fixed [b, k] ids and edge ids; zero-degree
seeds are filled with ``conf.default_neighbor_id`` and edge id -1.  All are
plain PyTorch, as the JAX package samples with XLA.

Each random sampler is split so that a test can feed both packages the
same uniform numbers: a ``*_positions`` function maps given draws to CSR
positions, and the sampler itself draws them from an explicit
``torch.Generator``.  ``SampleFilter`` (the ``flt`` argument),
``register_sampler`` and the temporal samplers are not yet ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.store import DeviceCSR
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.segment import (bisect_iters, row_bounds,
                                               segmented_searchsorted)


def _no_filter(flt):
    if flt is not None:
        raise InvalidArgumentError("sampling filters are not yet ported")


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
    if csr.num_edges == 0:  # nothing to index: every slot is a fill
        valid = torch.zeros_like(pos, dtype=torch.bool)
        ids = eids = torch.zeros_like(pos)
    else:
        posc = torch.clamp(pos, 0, csr.num_edges - 1)
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
                   generator: torch.Generator, flt=None):
    """Uniform with replacement.  Returns (nbr_ids [b,k], edge_ids [b,k])."""
    _no_filter(flt)
    u = torch.rand((seeds.shape[0], k), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    return uniform_draw(csr, seeds, u)


def _arange(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=like.device)


def topk_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                generator: Optional[torch.Generator] = None, flt=None):
    """The first k of the adjacency (weight-descending when the edge type
    is weighted), padded circularly (``conf.padding_mode`` 1) or with the
    last neighbour (0)."""
    _no_filter(flt)
    start, _, deg = row_bounds(csr.row_offsets, seeds)
    ar = _arange(k, seeds)[None, :]
    degm = torch.clamp(deg, min=1)[:, None]
    if conf.padding_mode == 1:
        idx = ar % degm
    else:
        idx = torch.minimum(ar, degm - 1)
    return _gather(csr, start[:, None] + idx, (deg > 0)[:, None])


def weighted_positions(start: torch.Tensor, end: torch.Tensor,
                       cum: torch.Tensor, u: torch.Tensor,
                       max_degree: int) -> torch.Tensor:
    """Flat CSR positions of the inverse-CDF draws ``u`` [b, k]: the first
    position of each row whose cumulative weight reaches ``u`` (ties go
    left), kept inside the row."""
    pos = segmented_searchsorted(cum, start[:, None], end[:, None], u,
                                 side="left", iters=bisect_iters(max_degree))
    return torch.minimum(pos, torch.clamp(end, min=1)[:, None] - 1)


def weighted_draw(csr: DeviceCSR, seeds: torch.Tensor, u: torch.Tensor,
                  by: str = "edge_weight"):
    """Weighted neighbours of ``seeds`` [b] for given ``u`` [b, k]."""
    if csr.num_edges == 0:
        # every seed gets the default fill
        return topk_sample(csr, seeds, u.shape[-1])
    cum = csr.cum_weights if by == "edge_weight" else csr.cum_in_degrees
    if cum is None:
        raise ValueError(
            "CSR has no %s CDF table (source not weighted?)" % by)
    start, end, deg = row_bounds(csr.row_offsets, seeds)
    pos = weighted_positions(start, end, cum, u, csr.max_degree)
    return _gather(csr, pos, (deg > 0)[:, None])


def weighted_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                    generator: torch.Generator, by: str = "edge_weight",
                    flt=None):
    """Inverse-CDF sampling with replacement: a neighbour's probability
    follows its edge weight (``edge_weight``) or its own in-degree
    (``in_degree``)."""
    _no_filter(flt)
    u = torch.rand((seeds.shape[0], k), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    return weighted_draw(csr, seeds, u, by)


def wor_positions(start: torch.Tensor, deg: torch.Tensor, k: int,
                  r: torch.Tensor) -> torch.Tensor:
    """Exact uniform-without-replacement flat positions within CSR rows.

    ``r`` [k, b] float32 in [0, 1) holds the draw of each of the k steps.
    A virtual Fisher-Yates shuffle: step j draws from [0, deg - j) over
    the remaining index space, tracked by up to k recorded (index ->
    replacement) swaps.  Rows with deg <= k return every neighbour, then
    pad circularly."""
    b = start.shape[0]
    ar = _arange(k, start)[None, :]
    degm = torch.clamp(deg, min=1)
    sel_keys = torch.full((b, k), -1, dtype=torch.int32, device=start.device)
    sel_vals = torch.zeros((b, k), dtype=torch.int32, device=start.device)

    def lookup(q):
        # the latest recorded replacement of q (the most recent slot wins)
        slot = torch.where(sel_keys == q[:, None], ar, -1).amax(dim=1)
        hit = sel_vals.gather(1, torch.clamp(slot, min=0)[:, None].long())
        return torch.where(slot >= 0, hit[:, 0], q)

    drawn = []
    for j in range(k):
        span = torch.clamp(degm - j, min=1)
        rj = torch.minimum(torch.floor(r[j] * span).to(torch.int32), span - 1)
        drawn.append(lookup(rj))
        tail_val = lookup(degm - 1 - j)
        sel_keys[:, j] = rj
        sel_vals[:, j] = tail_val
    drawn = (torch.stack(drawn, dim=1) if k
             else torch.zeros((b, 0), dtype=torch.int32, device=start.device))
    idx = torch.where(deg[:, None] > k, drawn, ar % degm[:, None])
    return start[:, None] + idx


def without_replacement_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                               generator: torch.Generator, flt=None):
    """Uniform without replacement over each seed's row."""
    _no_filter(flt)
    start, _, deg = row_bounds(csr.row_offsets, seeds)
    r = torch.rand((k, seeds.shape[0]), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    pos = wor_positions(start, deg, k, r)
    return _gather(csr, pos, (deg > 0)[:, None])


def full_sample(csr: DeviceCSR, seeds: torch.Tensor, cap: int, flt=None):
    """All neighbours up to ``cap``.  Returns (ids [b, cap], edge ids,
    degrees [b] clipped to the cap); slots past a row's degree hold the
    default fill and edge id -1."""
    _no_filter(flt)
    start, _, deg = row_bounds(csr.row_offsets, seeds)
    ar = _arange(cap, seeds)[None, :]
    ids, eids = _gather(csr, start[:, None] + ar, ar < deg[:, None])
    return ids, eids, torch.clamp(deg, max=cap).to(torch.int32)


STRATEGY_FNS = {
    "random": uniform_sample,
    "topk": topk_sample,
    "edge_weight": weighted_sample,
    "in_degree": weighted_sample,
    "random_without_replacement": without_replacement_sample,
    "full": full_sample,
}
