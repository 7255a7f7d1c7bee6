"""Temporal neighbour sampling: exact before-t prefix sampling.

Counterpart of ``graph_learn_tpu/ops/temporal.py`` over flat CSR tensors:
``_prefix_filter:31`` / ``_skip_excluded:49``, ``_cutoffs:55``,
``temporal_uniform_sample:77``, ``temporal_weighted_sample:90``
(``edge_weight`` and ``in_degree``),
``temporal_without_replacement_sample:156``, ``temporal_topk_sample:169``
and ``temporal_full_sample:184``.

A timestamped edge type's rows are ts-ascending (``core/store.py``), so the
edges of a seed that are strictly earlier than its bound ``t_upper`` are a
prefix ``[start, hi)`` of its row.  :func:`cutoffs` finds ``hi`` with one
bisection per seed over ``csr.nbr_ts``, in a fixed number of steps set by
the CSR's ``max_degree`` (``ops/segment.py``); each strategy then selects
inside the prefix, with no rejection.  The JAX package reads the prefix
through 128-lane windows (``_nwin`` / ``fetch_window``) where a row fits
two of them; the bisection here gives the same positions on rows of any
length.  The weighted draw is an inverse CDF over ``(0, cdf[hi - 1]]``:
the row's CDF is cumulative over the ts-ascending row, so the prefix is
its first ``hi - start`` entries and ``P(j) = w_j / W_prefix``.

An ``exclude_dst`` filter removes the excluded neighbour's slot from the
prefix before the selection (and its mass from the weighted draw), as
``_prefix_filter`` does.  Zero admissible edges give
``conf.default_neighbor_id`` and edge id -1.

Nothing here makes a tensor from host data or reads one back, so a plan
that samples through these functions captures in one CUDA graph.  As in
``ops/sampling.py``, each random strategy has a ``*_draw`` function that
takes its uniform numbers, so a test can feed JAX's own draws; the sampler
draws them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_learn_tpu_torch.core.store import DeviceCSR
from graph_learn_tpu_torch.ops.sampling import (SampleFilter, _arange,
                                                _exclusion, _gather, _skip,
                                                excluded_slot,
                                                excluded_weighted_positions,
                                                weighted_positions,
                                                wor_positions)
from graph_learn_tpu_torch.ops.segment import (bisect_iters, row_bounds,
                                               segmented_searchsorted)


def cutoffs(csr: DeviceCSR, seeds: torch.Tensor, t_upper: torch.Tensor):
    """(start, hi, deg) of each seed: its row's start, the end of the
    prefix of edges with ts < ``t_upper`` (exclusive), and that prefix's
    length.  ``t_upper`` [b] is in the store's rebased time domain."""
    if csr.nbr_ts is None:
        raise ValueError("edge type is not timestamped")
    start, end, _ = row_bounds(csr.row_offsets, seeds)
    hi = segmented_searchsorted(csr.nbr_ts, start, end,
                                t_upper.to(torch.int32), side="left",
                                iters=bisect_iters(csr.max_degree))
    return start, hi, hi - start


def _prefix_filter(csr: DeviceCSR, start, hi, deg,
                   flt: Optional[SampleFilter]):
    """(rel, present, deg'): the excluded neighbour's slot inside the
    prefix ``[start, hi)`` (``excluded_slot``) and the prefix length
    without it; (None, None, deg) without an ``exclude_dst`` filter."""
    excl = _exclusion(flt)
    if excl is None:
        return None, None, deg
    rel, present = excluded_slot(csr, start, hi, excl)
    return rel, present, deg - present.to(deg.dtype)


def _skip_excluded(idx, rel, present):
    return idx if rel is None else _skip(idx, rel, present)


def _rand(shape, generator: torch.Generator, like: torch.Tensor):
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=torch.float32)


def temporal_uniform_draw(csr: DeviceCSR, seeds: torch.Tensor,
                          u: torch.Tensor, t_upper: torch.Tensor,
                          flt: Optional[SampleFilter] = None):
    """Uniform (with replacement) among the edges of ``seeds`` [b] with ts
    < ``t_upper`` [b], for given ``u`` [b, k] in [0, 1)."""
    start, hi, deg = cutoffs(csr, seeds, t_upper)
    rel, present, deg = _prefix_filter(csr, start, hi, deg, flt)
    d = deg[:, None]
    idx = torch.minimum(torch.floor(u * d).to(torch.int32),
                        torch.clamp(d, min=1) - 1)
    pos = start[:, None] + _skip_excluded(idx, rel, present)
    return _gather(csr, pos, (deg > 0)[:, None])


def temporal_uniform_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                            generator: torch.Generator,
                            t_upper: torch.Tensor,
                            flt: Optional[SampleFilter] = None):
    """Uniform with replacement among edges with ts < t_upper[i]."""
    u = _rand((seeds.shape[0], k), generator, seeds)
    return temporal_uniform_draw(csr, seeds, u, t_upper, flt)


def temporal_weighted_positions(start: torch.Tensor, hi: torch.Tensor,
                                cum: torch.Tensor, u: torch.Tensor,
                                max_degree: int,
                                rel: Optional[torch.Tensor] = None,
                                present: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Flat positions of the inverse-CDF draws ``u`` [b, k] inside the
    prefixes ``[start, hi)``: ``u`` is scaled to the prefix's mass
    ``cdf[hi - 1]`` (0 for an empty prefix) and bisected; with ``rel`` /
    ``present`` the excluded slot's mass is removed first
    (``excluded_weighted_positions`` over the prefix)."""
    e = cum.shape[0]
    c_hi = torch.where(hi > start, cum[torch.clamp(hi - 1, 0, e - 1)], 0.0)
    if rel is None:
        return weighted_positions(start, hi, cum, u * c_hi[:, None],
                                  max_degree)
    return excluded_weighted_positions(start, hi, cum, u, rel, present,
                                       max_degree, mass=c_hi)


def temporal_weighted_draw(csr: DeviceCSR, seeds: torch.Tensor,
                           u: torch.Tensor, t_upper: torch.Tensor,
                           by: str = "edge_weight",
                           flt: Optional[SampleFilter] = None):
    """Weighted neighbours of ``seeds`` [b] among edges with ts <
    ``t_upper`` [b], for given ``u`` [b, k]: a neighbour's probability
    follows its edge weight (``edge_weight``) or its in-degree
    (``in_degree``) over the prefix."""
    cum = csr.cum_weights if by == "edge_weight" else csr.cum_in_degrees
    if cum is None:
        raise ValueError(
            "CSR has no %s CDF table (source not weighted?)" % by)
    start, hi, deg = cutoffs(csr, seeds, t_upper)
    rel, present, deg = _prefix_filter(csr, start, hi, deg, flt)
    pos = temporal_weighted_positions(start, hi, cum, u, csr.max_degree,
                                      rel, present)
    return _gather(csr, pos, (deg > 0)[:, None])


def temporal_weighted_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                             generator: torch.Generator,
                             t_upper: torch.Tensor, by: str = "edge_weight",
                             flt: Optional[SampleFilter] = None):
    """Weight-proportional draws restricted to edges with ts < t_upper[i]
    (the reference's Filter(ts LARGER_THAN) inside EdgeWeightSampler /
    InDegreeSampler)."""
    u = _rand((seeds.shape[0], k), generator, seeds)
    return temporal_weighted_draw(csr, seeds, u, t_upper, by, flt)


def temporal_wor_draw(csr: DeviceCSR, seeds: torch.Tensor, r: torch.Tensor,
                      t_upper: torch.Tensor,
                      flt: Optional[SampleFilter] = None):
    """Without-replacement neighbours among edges with ts < ``t_upper``,
    for given step draws ``r`` [k, b] (``sampling.wor_positions`` over the
    prefix)."""
    start, hi, deg = cutoffs(csr, seeds, t_upper)
    rel, present, deg = _prefix_filter(csr, start, hi, deg, flt)
    pos = wor_positions(start, deg, r.shape[0], r, rel, present)
    return _gather(csr, pos, (deg > 0)[:, None])


def temporal_without_replacement_sample(csr: DeviceCSR, seeds: torch.Tensor,
                                        k: int, generator: torch.Generator,
                                        t_upper: torch.Tensor,
                                        flt: Optional[SampleFilter] = None):
    """Uniform without replacement among edges with ts < t_upper[i]."""
    r = _rand((k, seeds.shape[0]), generator, seeds)
    return temporal_wor_draw(csr, seeds, r, t_upper, flt)


def temporal_topk_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                         t_upper: torch.Tensor,
                         flt: Optional[SampleFilter] = None):
    """The k most recent edges before t, most recent first, padded
    circularly over the prefix (TGN-style recency neighbourhood)."""
    start, hi, deg = cutoffs(csr, seeds, t_upper)
    rel, present, deg = _prefix_filter(csr, start, hi, deg, flt)
    degm = torch.clamp(deg, min=1)[:, None]
    idx = degm - 1 - _arange(k, seeds)[None, :] % degm
    pos = start[:, None] + _skip_excluded(idx, rel, present)
    return _gather(csr, torch.maximum(pos, start[:, None]),
                   (deg > 0)[:, None])


def temporal_full_sample(csr: DeviceCSR, seeds: torch.Tensor, cap: int,
                         t_upper: torch.Tensor,
                         flt: Optional[SampleFilter] = None):
    """The admissible edges up to ``cap``, the most recent ``cap`` in CSR
    order (oldest first).  Returns (ids [b, cap], edge ids, degrees [b]
    clipped to the cap)."""
    start, hi, deg = cutoffs(csr, seeds, t_upper)
    rel, present, deg = _prefix_filter(csr, start, hi, deg, flt)
    degc = torch.clamp(deg, max=cap)
    ar = _arange(cap, seeds)[None, :]
    idx = (deg - degc)[:, None] + ar
    pos = start[:, None] + _skip_excluded(idx, rel, present)
    ids, eids = _gather(csr, torch.maximum(pos, start[:, None]),
                        ar < degc[:, None])
    return ids, eids, degc.to(torch.int32)
