"""Conditional negative sampling: negatives that share the positive's
attribute values (``.where(target, condition)``).

A port of ``graph_learn_tpu/ops/conditional.py`` (reference
conditional_negative_sampler.cc:33-110, condition_table.h:57-140).  Per
positive (src, dst) pair, ``round(prop * k)`` negatives per selected int /
float column share the positive dst's value in that column, drawn in
proportion to the base strategy's weight (uniform, in-degree or node
weight), and the rest are unconditioned base draws.  True neighbours of
the seed and its positive dst are rejected (with ``batch_share``: the
batch's positive dsts), ``unique`` also rejects repeats within a row.

Per selected column the host builds a value-sorted index with a weight
CDF inside each run of equal values (:class:`ConditionTable`, on the
device once per query); on the device the positive's value bisects into
its run and each draw bisects the run's CDF.  String columns are hashed
int columns in the store, so they take the int path.

As in ops/negative.py, the random function draws its numbers from an
explicit ``torch.Generator`` and hands them to
:func:`conditional_negative_sample_draw`, a plain function of the draws,
so a test can feed it the JAX function's own draws.  Nothing reads a
tensor back to the host and every shape is known on the host, so the
sampler can be captured in a CUDA graph.

Two JAX behaviours are kept on purpose:

- the value index holds int columns as int32 and float columns as f32
  (the JAX device arrays without x64), and the positive's value is cast to
  that type before the bisection;
- a float column's positive value is read from the device feature table:
  under ``conf.feature_dtype = "bfloat16"`` it is the bf16 rounding of the
  f32 value the index holds, so most positives find no run and take the
  fallback draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.store import DeviceEdgeTable, NodeTable
from graph_learn_tpu_torch.core.values import TensorStruct
from graph_learn_tpu_torch.ops.segment import (row_member,
                                               segmented_searchsorted)
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

# base_draw(generator, shape) -> candidate ids of that shape
BaseDraw = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass
class ColumnIndex(TensorStruct):
    """Device arrays of one conditioned column."""

    vals_sorted: torch.Tensor  # [N] ascending, int32 or f32
    perm: torch.Tensor  # [N] int32 node index at each sorted position
    run_cdf: torch.Tensor  # [N] f32 within-run normalised inclusive cumsum


@dataclasses.dataclass
class ConditionTable:
    """The column indexes of one conditional negative node:
    {int_attrs column: ColumnIndex} and {float_attrs column: ColumnIndex}."""

    int_cols: Dict[int, ColumnIndex]
    float_cols: Dict[int, ColumnIndex]

    @staticmethod
    def build(table: NodeTable, int_cols: Sequence[int],
              float_cols: Sequence[int], weights: Optional[np.ndarray],
              device: DeviceLike = "cuda") -> "ConditionTable":
        """``int_cols`` / ``float_cols`` index ``table``'s int_attrs /
        float_attrs columns; ``weights`` [N] weigh each node inside its run
        (None: uniform; a run whose weights sum to 0 is uniform too)."""
        dev = resolve_device(device)
        n = table.num_nodes
        w = (np.ones(n, np.float64) if weights is None
             else np.maximum(np.asarray(weights, np.float64), 0.0))

        def build_col(vals: np.ndarray, dtype) -> ColumnIndex:
            order = np.argsort(vals, kind="stable")
            sv = vals[order]
            wv = w[order]
            new_run = np.ones(n, bool)
            new_run[1:] = sv[1:] != sv[:-1]
            run_id = np.cumsum(new_run) - 1
            run_sum = np.bincount(run_id, weights=wv)
            zero = run_sum[run_id] <= 0
            wv = np.where(zero, 1.0, wv)
            run_sum = np.bincount(run_id, weights=wv)
            cs = np.cumsum(wv)
            starts = np.where(new_run)[0]
            base = (cs - wv)[starts][run_id]
            cdf = ((cs - base) / run_sum[run_id]).astype(np.float32)
            return ColumnIndex(
                torch.from_numpy(sv.astype(dtype)).to(dev),
                torch.from_numpy(order.astype(np.int32)).to(dev),
                torch.from_numpy(cdf).to(dev))

        ic = {c: build_col(table.int_attrs[:, c].astype(np.int64), np.int32)
              for c in int_cols}
        fc = {c: build_col(table.float_attrs[:, c].astype(np.float64),
                           np.float32)
              for c in float_cols}
        return ConditionTable(int_cols=ic, float_cols=fc)


def _sample_matching(col: ColumnIndex, pos_vals: torch.Tensor,
                     u: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """[b] positive values, [b, n] uniform draws -> [b, n] node indices
    sharing the value; a row whose value no node holds takes ``fallback``
    (unconditioned candidates of the same shape)."""
    e = col.perm.shape[0]
    pv = pos_vals.to(col.vals_sorted.dtype).contiguous()
    lo = torch.searchsorted(col.vals_sorted, pv, side="left")
    hi = torch.searchsorted(col.vals_sorted, pv, side="right")
    found = hi > lo
    pos = segmented_searchsorted(col.run_cdf, lo[:, None], hi[:, None], u,
                                 side="left")
    pos = torch.minimum(pos, torch.clamp(hi, min=1)[:, None].to(pos.dtype)
                        - 1)
    drawn = col.perm[torch.clamp(pos, 0, max(e - 1, 0)).long()]
    return torch.where(found[:, None], drawn, fallback.to(drawn.dtype))


def _batch_member(pool: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """True where a candidate appears anywhere in ``pool`` (a small 1-D id
    set, e.g. the batch's positive dsts)."""
    sp = torch.sort(pool).values
    pos = torch.searchsorted(sp, cands.contiguous(), side="left")
    pos = torch.clamp(pos, 0, sp.shape[0] - 1)
    return sp[pos] == cands


def _mark_pool_dups(pool: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """dup[b, i]: pool[b, i] equals an earlier acceptable pool element, so
    a row keeps the first acceptable occurrence of each id (the reference
    inserts accepted draws into ``nbr_set`` when ``unique``)."""
    m = pool.shape[1]
    eq = pool[:, :, None] == pool[:, None, :]
    lower = torch.tril(torch.ones((m, m), dtype=torch.bool,
                                  device=pool.device), -1)  # j < i
    return torch.any(eq & lower[None] & ok[:, None, :], dim=-1)


def _first_q_acceptable(pool: torch.Tensor, ok: torch.Tensor,
                        q: int) -> torch.Tensor:
    """The first q acceptable candidates of each row in draw order; a row
    with fewer relaxes and takes its earliest rejected draws (the
    reference clears ``nbr_set`` after its retries).  A stable sort of
    ``~ok`` as uint8: CUDA sorts no bool tensor stably."""
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    return torch.take_along_dim(pool, order[:, :q], dim=1)


def quotas(k: int, int_cols: Sequence[int], int_props: Sequence[float],
           float_cols: Sequence[int], float_props: Sequence[float]
           ) -> Tuple[List[Tuple[str, int, int]], int]:
    """([(kind, column, quota)], the unconditioned count): each quota is
    ``int(round(prop * k))``, Python's rounding (half to even:
    ``round(0.5) == 0``), as the JAX package computes it."""
    parts: List[Tuple[str, int, int]] = []
    used = 0
    for kind, cols, props in (("int", int_cols, int_props),
                              ("float", float_cols, float_props)):
        for c, p in zip(cols, props):
            q = int(round(p * k))
            parts.append((kind, c, q))
            used += q
    return parts, max(k - used, 0)


def conditional_negative_sample_draw(
        et: DeviceEdgeTable, ct: ConditionTable, seeds: torch.Tensor,
        pos_dst: torch.Tensor, pos_int_attrs: Optional[torch.Tensor],
        pos_float_attrs: Optional[torch.Tensor], k: int,
        int_cols: Sequence[int], int_props: Sequence[float],
        float_cols: Sequence[int], float_props: Sequence[float],
        quota_draws: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        free: Optional[torch.Tensor], batch_share: bool = False,
        unique: bool = False, reverse: bool = False) -> torch.Tensor:
    """[b, k] negatives from the given draws: for each quota of
    :func:`quotas` above 0, in order, ``(fallback, u)`` of shape [b, q R]
    (R = ``conf.sampling_retry_times + 1``): the unconditioned candidates
    a row takes when its value has no run, and the uniform numbers of the
    run draws; then ``free`` [b, nf R], the unconditioned candidates
    (None when no such part).  Each part keeps the first q acceptable of
    its pool, in draw order."""
    parts, n_free = quotas(k, int_cols, int_props, float_cols, float_props)
    pools: List[Tuple[torch.Tensor, int]] = []
    draws = iter(quota_draws)
    for kind, c, q in parts:
        if q <= 0:
            continue
        fb, u = next(draws)
        col = ct.int_cols[c] if kind == "int" else ct.float_cols[c]
        pv = (pos_int_attrs if kind == "int" else pos_float_attrs)[:, c]
        pools.append((_sample_matching(col, pv, u, fb).to(torch.int32), q))
    if free is not None:
        nf = max(n_free, k - sum(q for _, _, q in parts))
        pools.append((free.to(torch.int32), nf))

    # one membership probe over every part's pool
    all_pool = torch.cat([p for p, _ in pools], dim=1)
    if batch_share:
        bad = _batch_member(pos_dst.to(torch.int32), all_pool)
    else:
        csr = et.inc if reverse else et.out
        bad = row_member(csr, seeds, all_pool)
        bad = bad | (all_pool == pos_dst[:, None])

    picked: List[torch.Tensor] = []
    off = 0
    for pool, q in pools:
        m = pool.shape[1]
        ok = ~bad[:, off:off + m]
        off += m
        if unique:
            if picked:
                prev = torch.cat(picked, dim=1)
                ok = ok & ~torch.any(pool[:, :, None] == prev[:, None, :],
                                     dim=-1)
            ok = ok & ~_mark_pool_dups(pool, ok)
        picked.append(_first_q_acceptable(pool, ok, q))
    return torch.cat(picked, dim=1)[:, :k]


def conditional_negative_sample(
        et: DeviceEdgeTable, ct: ConditionTable, seeds: torch.Tensor,
        pos_dst: torch.Tensor, pos_int_attrs: Optional[torch.Tensor],
        pos_float_attrs: Optional[torch.Tensor], k: int,
        generator: torch.Generator,
        int_cols: Sequence[int], int_props: Sequence[float],
        float_cols: Sequence[int], float_props: Sequence[float],
        base_draw: BaseDraw, batch_share: bool = False,
        unique: bool = False, reverse: bool = False) -> torch.Tensor:
    """[b, k] int32 negatives of ``seeds`` [b] whose positives are
    ``pos_dst`` [b] (their int / float attribute rows ``pos_*_attrs``
    [b, n]).  The draws, in the JAX package's order: per quota the
    fallback candidates ``base_draw(generator, (b, q R))``, then the run
    draws' uniform numbers; then the unconditioned part's candidates."""
    b = seeds.shape[0]
    R = conf.sampling_retry_times + 1
    parts, n_free = quotas(k, int_cols, int_props, float_cols, float_props)
    quota_draws = []
    for _, _, q in parts:
        if q <= 0:
            continue
        shape = (b, q * R)
        fb = base_draw(generator, shape)
        u = torch.rand(shape, generator=generator, device=seeds.device)
        quota_draws.append((fb, u))
    free = None
    if n_free > 0 or not quota_draws:
        nf = max(n_free, k - sum(q for _, _, q in parts))
        free = base_draw(generator, (b, nf * R))
    return conditional_negative_sample_draw(
        et, ct, seeds, pos_dst, pos_int_attrs, pos_float_attrs, k,
        int_cols, int_props, float_cols, float_props, quota_draws, free,
        batch_share=batch_share, unique=unique, reverse=reverse)
