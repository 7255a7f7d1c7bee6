"""Negative sampling: ``.outNeg(e)`` / ``.inNeg(e)`` / ``.Neg(t)`` with
``.sample(k).by(strategy)``.

Counterpart of ``graph_learn_tpu/ops/negative.py`` (``negative_sample:88``,
``negative_sample_from_nodes:63``) for the strategies

- ``random``         uniform over the candidate pool (the distinct dst ids
                     of the edge type, the distinct src ids for ``inNeg``);
                     true neighbours are NOT rejected, as in the
                     reference's random_negative_sampler.cc;
- ``in_degree``      candidates in proportion to their in- (``inNeg``:
                     out-) degree, true neighbours rejected;
- ``soft_in_degree`` the same draw without the rejection;
- ``node_weight``    candidates in proportion to the dst node table's
                     weights, true neighbours rejected.

A rejecting strategy draws R = ``conf.sampling_retry_times + 1`` candidate
rounds per slot, keeps the first round that is not a neighbour of its seed
and, where every round is one, the last.  ``conditional`` negatives
(``.where``) are drawn by ops/conditional.py, which takes one of these
strategies' draws as its base.

As in ops/sampling.py, the draws come from an explicit
``torch.Generator`` and the step after them is a plain function of the
draws (:func:`cdf_positions`, :func:`pick_negatives`), so a test can feed
both packages the same numbers.  Nothing here makes a tensor from host data
or reads one back: pool sizes are shapes, known on the host.

On a sharded store (``core/sharding.py``) the pools and the node-weight
CDF are replicated and the neighbour rejection is ``row_member``'s psum
stitch, so the draws and the answer are the single-device ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.sharding import ShardedNodeTable
from graph_learn_tpu_torch.core.store import DeviceEdgeTable, DeviceNodeTable
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops.segment import row_member

NEGATIVE_STRATEGIES = ("random", "in_degree", "soft_in_degree",
                       "node_weight")


def uniform_ids(cand_ids: torch.Tensor, shape,
                generator: torch.Generator) -> torch.Tensor:
    """``shape`` ids drawn uniformly from ``cand_ids``."""
    idx = torch.randint(0, max(cand_ids.shape[0], 1), shape,
                        generator=generator, device=cand_ids.device)
    return cand_ids[idx]


def cdf_positions(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Positions of the inverse-CDF draws ``u``: the first entry of the
    (ascending) ``cdf`` that reaches each draw, kept inside the table."""
    pos = torch.searchsorted(cdf, u.contiguous(), side="left")
    return torch.clamp(pos, 0, cdf.shape[0] - 1)


def cdf_ids(cand_ids: torch.Tensor, cdf: torch.Tensor, shape,
            generator: torch.Generator) -> torch.Tensor:
    """``shape`` ids drawn from ``cand_ids`` in proportion to the weights
    whose normalised cumsum is ``cdf``."""
    u = torch.rand(shape, generator=generator, device=cdf.device,
                   dtype=torch.float32)
    return cand_ids[cdf_positions(cdf, u)]


def pick_negatives(et: DeviceEdgeTable, seeds: torch.Tensor,
                   cands: torch.Tensor, reverse: bool = False
                   ) -> torch.Tensor:
    """Candidates [b, k, R] -> [b, k]: per slot the first round that is not
    a neighbour of its seed (in the reverse CSR with ``reverse``), else
    the last round."""
    csr = et.inc if reverse else et.out
    bad = row_member(csr, seeds, cands)
    first_ok = torch.argmax((~bad).to(torch.uint8), dim=-1)
    pick = torch.where(bad.all(dim=-1), cands.shape[-1] - 1, first_ok)
    return torch.gather(cands, -1, pick[..., None])[..., 0]


def _node_cdf(nt: Optional[DeviceNodeTable]) -> torch.Tensor:
    if nt is None or nt.cum_weights is None:
        raise InvalidArgumentError("node_weight negative sampling needs a "
                                   "weighted dst node table")
    return nt.cum_weights


def _check(strategy: str):
    if strategy == "conditional":
        raise InvalidArgumentError(
            "conditional negatives need the .where() condition: they are "
            "drawn by ops/conditional.py conditional_negative_sample")
    if strategy not in NEGATIVE_STRATEGIES:
        raise InvalidArgumentError("unknown negative strategy %r" % strategy)


def negative_sample_from_nodes(nt: DeviceNodeTable, b: int, k: int,
                               generator: torch.Generator,
                               strategy: str = "random") -> torch.Tensor:
    """``Neg(node_type)``: [b, k] negatives from a node set, no topology:
    uniform (``in_degree`` degrades to it) or by node weight."""
    _check(strategy)
    dev = nt.device if isinstance(nt, ShardedNodeTable) else nt.raw_ids.device
    all_ids = torch.arange(nt.num_nodes, dtype=torch.int32, device=dev)
    if strategy == "node_weight":
        return cdf_ids(all_ids, _node_cdf(nt), (b, k), generator)
    return uniform_ids(all_ids, (b, k), generator)


def negative_sample(et: DeviceEdgeTable, seeds: torch.Tensor, k: int,
                    generator: torch.Generator, strategy: str = "random",
                    dst_table: Optional[DeviceNodeTable] = None,
                    reverse: bool = False) -> torch.Tensor:
    """[b, k] int32 negative dst indices of ``seeds`` [b]; ``reverse``
    (``inNeg``) takes the src side's pool and the reverse CSR."""
    _check(strategy)
    pool = et.unique_src if reverse else et.unique_dst
    pool_cdf = et.unique_src_outdeg_cdf if reverse else et.unique_dst_indeg_cdf
    if pool is None:
        raise InvalidArgumentError(
            "negative sampling needs the candidate-pool tables, which "
            "storage_profile='minimal' drops — use the default profile "
            "for queries with outNeg/inNeg")
    b = seeds.shape[0]
    if strategy == "random":
        return uniform_ids(pool, (b, k), generator)
    shape = (b, k, conf.sampling_retry_times + 1)
    if strategy == "node_weight":
        cdf = _node_cdf(dst_table)
        all_ids = torch.arange(dst_table.num_nodes, dtype=torch.int32,
                               device=pool.device)
        cands = cdf_ids(all_ids, cdf, shape, generator)
    else:
        cands = cdf_ids(pool, pool_cdf, shape, generator)
    if strategy == "soft_in_degree":
        return cands[..., 0]
    return pick_negatives(et, seeds, cands, reverse)
