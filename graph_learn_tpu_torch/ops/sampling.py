"""Neighbour sampling: the GSL ``.sample(k).by(strategy)`` strategies.

Counterpart of ``graph_learn_tpu/ops/sampling.py`` over flat CSR tensors
(no per-seed tile windows): ``uniform_sample:204`` (``random``),
``topk_sample:224``, ``weighted_sample:251`` (``edge_weight`` and
``in_degree``, by bisection of the per-row CDFs the "full" store profile
carries), ``wor_positions:310`` / ``without_replacement_sample:375`` and
``full_sample:391``.  All return fixed [b, k] ids and edge ids; zero-degree
seeds are filled with ``conf.default_neighbor_id`` and edge id -1.  All are
plain PyTorch, as the JAX package samples with XLA.  None makes a tensor
from host data or reads one back, so a plan can be captured in a CUDA
graph.

Each random sampler is split so that a test can feed both packages the
same uniform numbers: a ``*_positions`` (or ``*_draw``) function maps given
draws to CSR positions, and the sampler itself draws them from an explicit
``torch.Generator``.

Filters (``SampleFilter``, the ``flt`` argument; reference
sampler/filter.cc): ``exclude_dst`` rejects one neighbour id per seed.
``random`` redraws, keeping the first of ``conf.sampling_retry_times + 1``
candidate rounds that passes (``retry_positions``, as
``_apply_filter_retry:173``); the other strategies remove the excluded
slot from the row before they select (``excluded_slot``, as ``_excl_rel:137``).
The JAX package finds that slot in a 128-lane window and so refuses rows
of more than 256 neighbours; the flat CSR here scans a row of any length.
``ts_upper`` (a [b] bound, as ``SampleFilter:45-63``) rejects a candidate
whose edge timestamp is not strictly below it: ``random`` counts such a
candidate as failing its round when the caller passes the edge type's
timestamps (``edge_ts``), as ``_apply_filter_retry:173`` does; like
``_filter_guard:149`` the other strategies read only ``exclude_dst``.  The
GSL sends hops on a temporal path to ``ops/temporal.py`` instead, whose
before-t prefix is exact.  ``register_sampler:423`` adds a custom
strategy.

The five samplers above run on a ``ShardedCSR`` too
(``core/sharding.py row_sharded_sampler``, as ``:204-390`` are
decorated): each rank samples the seeds' rows in its block and one psum
keeps the owner's answer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.sharding import row_sharded_sampler
from graph_learn_tpu_torch.core.store import DeviceCSR
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.segment import (SCAN_CHUNK, bisect_iters,
                                               row_bounds,
                                               segmented_searchsorted)


@dataclasses.dataclass(frozen=True)
class SampleFilter:
    """Per-seed rejection predicates (reference filter.h)."""

    exclude_dst: Optional[torch.Tensor] = None  # [b] neighbour id to reject
    ts_upper: Optional[torch.Tensor] = None  # [b] timestamp upper bound

    def hit(self, cand_ids: torch.Tensor,
            cand_ts: Optional[torch.Tensor]) -> torch.Tensor:
        """True where a candidate [b, ...] violates the filter: its id is
        the seed's excluded one, or (given ``cand_ts``) its edge time is
        not strictly below the seed's bound."""
        bad = torch.zeros(cand_ids.shape, dtype=torch.bool,
                          device=cand_ids.device)
        shape = (-1,) + (1,) * (cand_ids.dim() - 1)
        if self.exclude_dst is not None:
            bad |= cand_ids == self.exclude_dst.reshape(shape)
        if self.ts_upper is not None and cand_ts is not None:
            bad |= cand_ts >= self.ts_upper.reshape(shape)
        return bad


def _exclusion(flt: Optional[SampleFilter]) -> Optional[torch.Tensor]:
    """The [b] ids ``flt`` rejects, or None: the only part of a filter the
    strategies other than ``random`` read (``_filter_guard:149``)."""
    return None if flt is None else flt.exclude_dst


def _retries(flt: Optional[SampleFilter]) -> bool:
    """Does ``random`` draw candidate rounds for ``flt``?"""
    return flt is not None and (flt.exclude_dst is not None
                                or flt.ts_upper is not None)


def excluded_slot(csr: DeviceCSR, start: torch.Tensor, end: torch.Tensor,
                  excl: torch.Tensor):
    """(rel, present): the position inside its row of the last neighbour
    equal to ``excl`` (2**30 where the row has none), as ``_excl_rel:137``.

    The row is scanned in passes of ``SCAN_CHUNK`` positions, as many as
    the widest row needs, so rows of any degree are searched."""
    last = torch.full_like(start, -1)
    if csr.num_edges:
        width = max(1, min(csr.max_degree, SCAN_CHUNK))
        ar = _arange(width, start)[None, :]
        for c0 in range(0, max(csr.max_degree, 1), width):
            pos = start[:, None] + (ar + c0)
            nbr = csr.nbr_ids[torch.clamp(pos, 0, csr.num_edges - 1)]
            hit = (pos < end[:, None]) & (nbr == excl[:, None])
            last = torch.maximum(last, torch.where(hit, pos, -1).amax(dim=1))
    present = last >= 0
    return torch.where(present, last - start, 2 ** 30), present


def _skip(idx: torch.Tensor, rel: torch.Tensor,
          present: torch.Tensor) -> torch.Tensor:
    """Index j of the row with the excluded slot removed -> index in the
    whole row: one past the slot from ``rel`` on."""
    return idx + (present[:, None] & (idx >= rel[:, None])).to(idx.dtype)


def uniform_positions(start: torch.Tensor, deg: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Flat CSR positions ``start + min(floor(u*deg), max(deg,1)-1)``.

    ``start``/``deg`` are [b], ``u`` is [b, k] (or [b, k, rounds]) float32
    in [0, 1); the float32 product matches the JAX package's arithmetic
    exactly.
    """
    shape = (-1,) + (1,) * (u.dim() - 1)
    d = deg.reshape(shape)
    idx = torch.floor(u * d).to(torch.int32)
    idx = torch.minimum(idx, torch.clamp(d, min=1) - 1)
    return start.reshape(shape) + idx


def retry_positions(csr: DeviceCSR, pos: torch.Tensor,
                    excl: Optional[torch.Tensor],
                    ts_upper: Optional[torch.Tensor] = None,
                    edge_ts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Candidate positions [b, k, rounds] -> [b, k]: per draw the first
    round whose neighbour is not ``excl`` [b] and, given ``ts_upper`` [b]
    and the edge type's timestamps ``edge_ts`` [E], whose edge is strictly
    earlier than the bound; else the last round
    (``_apply_filter_retry:173``; reference random_sampler.cc:62-72)."""
    if csr.num_edges == 0:  # every slot is a fill
        return pos[..., -1]
    posc = torch.clamp(pos, 0, csr.num_edges - 1)
    cand_ts = None
    if edge_ts is not None:
        cand_ts = edge_ts[torch.clamp(csr.nbr_edge_ids[posc], min=0)]
    bad = SampleFilter(exclude_dst=excl, ts_upper=ts_upper).hit(
        csr.nbr_ids[posc], cand_ts)
    first_ok = torch.argmax((~bad).to(torch.uint8), dim=-1)
    pick = torch.where(bad.all(dim=-1), pos.shape[-1] - 1, first_ok)
    return torch.gather(pos, -1, pick[..., None])[..., 0]


def _gather(csr: DeviceCSR, pos: torch.Tensor, valid: torch.Tensor):
    """(nbr_ids, edge_ids) at flat CSR positions, filled where invalid."""
    if csr.num_edges == 0:  # nothing to index: every slot is a fill
        valid = torch.zeros_like(pos, dtype=torch.bool)
        ids = eids = torch.zeros_like(pos)
    else:
        posc = torch.clamp(pos, 0, csr.num_edges - 1)
        ids = csr.nbr_ids[posc]
        eids = csr.nbr_edge_ids[posc]
    # fills are scalars, not tensors made from host data: capture-safe
    ids = torch.where(valid, ids, conf.default_neighbor_id)
    eids = torch.where(valid, eids, -1)
    return ids, eids


def uniform_draw(csr: DeviceCSR, seeds: torch.Tensor, u: torch.Tensor,
                 flt: Optional[SampleFilter] = None,
                 edge_ts: Optional[torch.Tensor] = None):
    """Uniform neighbours of ``seeds`` [b] for given ``u``: [b, k], or with
    a filter [b, k, conf.sampling_retry_times + 1]; a ``ts_upper`` bound
    rejects candidates by ``edge_ts`` (the edge type's [E] timestamps)
    where it is given."""
    if u.dim() != (3 if _retries(flt) else 2):
        raise InvalidArgumentError(
            "uniform_draw: u must be [b, k] without a filter and [b, k, "
            "rounds] with one, got %s" % (tuple(u.shape),))
    start, _, deg = row_bounds(csr.row_offsets, seeds)
    pos = uniform_positions(start, deg, u)
    if _retries(flt):
        pos = retry_positions(csr, pos, flt.exclude_dst, flt.ts_upper,
                              edge_ts)
    return _gather(csr, pos, (deg > 0)[:, None])


@row_sharded_sampler
def uniform_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                   generator: torch.Generator,
                   flt: Optional[SampleFilter] = None,
                   edge_ts: Optional[torch.Tensor] = None):
    """Uniform with replacement.  Returns (nbr_ids [b,k], edge_ids [b,k]).

    With a filter it draws ``conf.sampling_retry_times + 1`` candidate
    rounds per slot, as the JAX package does."""
    shape = (seeds.shape[0], k)
    if _retries(flt):
        shape += (conf.sampling_retry_times + 1,)
    u = torch.rand(shape, generator=generator, device=seeds.device,
                   dtype=torch.float32)
    return uniform_draw(csr, seeds, u, flt, edge_ts)


def _arange(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=like.device)


@row_sharded_sampler
def topk_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                generator: Optional[torch.Generator] = None,
                flt: Optional[SampleFilter] = None):
    """The first k of the adjacency (weight-descending when the edge type
    is weighted), padded circularly (``conf.padding_mode`` 1) or with the
    last neighbour (0).  A filter removes the excluded slot first."""
    start, end, deg = row_bounds(csr.row_offsets, seeds)
    excl = _exclusion(flt)
    if excl is not None:
        rel, present = excluded_slot(csr, start, end, excl)
        deg = deg - present.to(deg.dtype)
    ar = _arange(k, seeds)[None, :]
    degm = torch.clamp(deg, min=1)[:, None]
    if conf.padding_mode == 1:
        idx = ar % degm
    else:
        idx = torch.minimum(ar, degm - 1)
    if excl is not None:
        idx = _skip(idx, rel, present)
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


def excluded_weighted_positions(start: torch.Tensor, end: torch.Tensor,
                                cum: torch.Tensor, u: torch.Tensor,
                                rel: torch.Tensor, present: torch.Tensor,
                                max_degree: int,
                                mass: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """:func:`weighted_positions` with the excluded slot's mass removed:
    ``u`` is drawn over the rest of the row's CDF and shifted past the
    slot's interval, then stepped off the slot where a float boundary lands
    on it (``weighted_sample:277-296``, the same f32 arithmetic).  ``mass``
    [b] is the CDF's value at ``end - 1`` (the temporal prefix's, in
    ops/temporal.py); without it a whole row's, 1."""
    e = cum.shape[0]
    last = torch.clamp(end - start, min=1) - 1
    relc = torch.minimum(rel, last)
    at = start + relc
    at_x = cum[torch.clamp(at, 0, e - 1)]
    prev_x = torch.where(relc > 0, cum[torch.clamp(at - 1, 0, e - 1)], 0.0)
    w_x = torch.where(present, at_x - prev_x, 0.0)
    u2 = u * ((1.0 if mass is None else mass) - w_x)[:, None]
    t = torch.where(u2 < prev_x[:, None], u2, u2 + w_x[:, None])
    pos = segmented_searchsorted(cum, start[:, None], end[:, None], t,
                                 side="left", iters=bisect_iters(max_degree))
    on_x = present[:, None] & (pos - start[:, None] == relc[:, None])
    step = torch.where(relc == last, -1, 1).to(pos.dtype)[:, None]
    pos = torch.where(on_x, pos + step, pos)
    return torch.minimum(pos, torch.clamp(end, min=1)[:, None] - 1)


def weighted_draw(csr: DeviceCSR, seeds: torch.Tensor, u: torch.Tensor,
                  by: str = "edge_weight",
                  flt: Optional[SampleFilter] = None):
    """Weighted neighbours of ``seeds`` [b] for given ``u`` [b, k]."""
    if csr.num_edges == 0:
        # every seed gets the default fill
        return topk_sample(csr, seeds, u.shape[-1])
    cum = csr.cum_weights if by == "edge_weight" else csr.cum_in_degrees
    if cum is None:
        raise ValueError(
            "CSR has no %s CDF table (source not weighted?)" % by)
    start, end, deg = row_bounds(csr.row_offsets, seeds)
    excl = _exclusion(flt)
    if excl is None:
        pos = weighted_positions(start, end, cum, u, csr.max_degree)
    else:
        rel, present = excluded_slot(csr, start, end, excl)
        deg = deg - present.to(deg.dtype)
        pos = excluded_weighted_positions(start, end, cum, u, rel, present,
                                          csr.max_degree)
    return _gather(csr, pos, (deg > 0)[:, None])


@row_sharded_sampler
def weighted_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                    generator: torch.Generator, by: str = "edge_weight",
                    flt: Optional[SampleFilter] = None):
    """Inverse-CDF sampling with replacement: a neighbour's probability
    follows its edge weight (``edge_weight``) or its own in-degree
    (``in_degree``).  A filter removes the excluded neighbour's mass."""
    u = torch.rand((seeds.shape[0], k), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    return weighted_draw(csr, seeds, u, by, flt)


def wor_positions(start: torch.Tensor, deg: torch.Tensor, k: int,
                  r: torch.Tensor, rel: Optional[torch.Tensor] = None,
                  present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact uniform-without-replacement flat positions within CSR rows.

    ``r`` [k, b] float32 in [0, 1) holds the draw of each of the k steps.
    A virtual Fisher-Yates shuffle: step j draws from [0, deg - j) over
    the remaining index space, tracked by up to k recorded (index ->
    replacement) swaps.  Rows with deg <= k return every neighbour, then
    pad circularly.  With ``rel`` / ``present`` (:func:`excluded_slot`;
    ``deg`` already without the slot) indices skip the excluded slot."""
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
    if rel is not None:
        idx = _skip(idx, rel, present)
    return start[:, None] + idx


def wor_draw(csr: DeviceCSR, seeds: torch.Tensor, r: torch.Tensor,
             flt: Optional[SampleFilter] = None):
    """Without-replacement neighbours of ``seeds`` [b] for given step
    draws ``r`` [k, b]; a filter removes the excluded slot first."""
    start, end, deg = row_bounds(csr.row_offsets, seeds)
    rel = present = None
    excl = _exclusion(flt)
    if excl is not None:
        rel, present = excluded_slot(csr, start, end, excl)
        deg = deg - present.to(deg.dtype)
    pos = wor_positions(start, deg, r.shape[0], r, rel, present)
    return _gather(csr, pos, (deg > 0)[:, None])


@row_sharded_sampler
def without_replacement_sample(csr: DeviceCSR, seeds: torch.Tensor, k: int,
                               generator: torch.Generator,
                               flt: Optional[SampleFilter] = None):
    """Uniform without replacement over each seed's (filtered) row."""
    r = torch.rand((k, seeds.shape[0]), generator=generator,
                   device=seeds.device, dtype=torch.float32)
    return wor_draw(csr, seeds, r, flt)


@row_sharded_sampler
def full_sample(csr: DeviceCSR, seeds: torch.Tensor, cap: int,
                flt: Optional[SampleFilter] = None):
    """All neighbours up to ``cap``.  Returns (ids [b, cap], edge ids,
    degrees [b] clipped to the cap); slots past a row's degree hold the
    default fill and edge id -1.  A filter compacts the excluded slot out
    of the row before the cap."""
    start, end, deg = row_bounds(csr.row_offsets, seeds)
    ar = _arange(cap, seeds)[None, :]
    idx = ar
    excl = _exclusion(flt)
    if excl is not None:
        rel, present = excluded_slot(csr, start, end, excl)
        deg = deg - present.to(deg.dtype)
        idx = _skip(ar, rel, present)
    ids, eids = _gather(csr, start[:, None] + idx, ar < deg[:, None])
    return ids, eids, torch.clamp(deg, max=cap).to(torch.int32)


STRATEGY_FNS = {
    "random": uniform_sample,
    "topk": topk_sample,
    "edge_weight": weighted_sample,
    "in_degree": weighted_sample,
    "random_without_replacement": without_replacement_sample,
    "full": full_sample,
}
BUILTIN_STRATEGIES = tuple(STRATEGY_FNS)


def register_sampler(name: str, fn) -> None:
    """Register a custom neighbour-sampling strategy for GSL ``.by(name)``
    (``register_sampler:423``; reference docs/en/gl/developer/operator.md)::

        fn(csr: DeviceCSR, seeds: [b] int32, k: int, generator) -> (ids, eids)

    returning [b, k] neighbour and edge ids (the helpers here:
    ``row_bounds``, ``uniform_positions``, ``_gather``).  It draws from the
    plan's ``torch.Generator`` where the JAX package passes a key, and a
    query's ``.filter()`` does not reach it, as in the JAX package.
    Built-in and already registered names cannot be overridden."""
    if name in STRATEGY_FNS:
        raise InvalidArgumentError("strategy %r already registered" % name)
    STRATEGY_FNS[name] = fn
