"""Subgraph induction over seed node sets.

Counterpart of ``graph_learn_tpu/ops/subgraph.py`` ``_full_candidates:30``,
``induce_subgraph:51``, ``induce_batched:112`` and ``_bfs_local:128``:
the (deduplicated, sorted) seed set is the node set, each seed's
neighbour list is read up to ``nbr_cap`` entries, an edge is kept where
its other end is also a seed, and the kept edges are compacted to the
front as local ``edge_index`` [2, S * cap] with ``num_edges`` of them
valid; optionally the BFS hop distances to local nodes 0 and 1 (SEAL's
labels).

The JAX package writes one sample and ``jax.vmap``s it; here the batched
form over ``[B, S]`` seed sets is the only one (a row-wise sort, one
batched ``searchsorted`` of ``[B, S * cap]`` neighbours into ``[B, S]``
sorted rows, a row-wise stable compaction), and ``induce_subgraph`` is its
``B = 1`` case.  The deduplication keeps ``jnp.unique(size=S,
fill_value=2**31 - 1)``'s static shape without ``torch.unique``: a sort,
a first-occurrence mask and a stable compaction, padded with the fill.
Nothing reads a value back to the host, so a plan that induces can be
captured in a CUDA graph.  All plain PyTorch, as the JAX package induces
with XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.sharding import row_sharded_sampler
from graph_learn_tpu_torch.core.store import DeviceCSR
from graph_learn_tpu_torch.core.values import SubGraphVal
from graph_learn_tpu_torch.ops.segment import row_bounds

# the id that pads a deduplicated seed set (jnp.unique's fill_value)
FILL = 2 ** 31 - 1


@row_sharded_sampler
def _full_candidates(csr: DeviceCSR, rows: torch.Tensor, cap: int):
    """(nbr, eid, deg): each row's first ``cap`` neighbour and edge ids
    [*, cap] (positions past the row read clamped entries, masked by the
    caller) and its degree [*]; a row past the table (the fill) reads the
    last row, as ``_full_candidates:30``."""
    num_rows = csr.row_offsets.shape[0] - 1
    start, _, deg = row_bounds(csr.row_offsets,
                               torch.clamp(rows, max=num_rows - 1).long())
    pos = start[..., None] + torch.arange(cap, dtype=start.dtype,
                                          device=start.device)
    if csr.num_edges == 0:
        zeros = torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
        return zeros, zeros, deg
    posc = torch.clamp(pos, 0, csr.num_edges - 1).long()
    return csr.nbr_ids[posc], csr.nbr_edge_ids[posc], deg


def unique_rows(seeds: torch.Tensor) -> torch.Tensor:
    """Each row of ``seeds`` [B, S] as its sorted distinct ids padded with
    ``FILL`` [B, S]: ``jnp.unique(row, size=S, fill_value=FILL)``."""
    s = torch.sort(seeds.to(torch.int32), dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    # firsts to the front, in their sorted order
    order = torch.argsort((~first).to(torch.uint8), dim=-1, stable=True)
    num = first.sum(dim=-1, dtype=torch.int32)
    ar = torch.arange(s.shape[1], dtype=torch.int32, device=s.device)
    return torch.where(ar[None, :] < num[:, None], torch.gather(s, 1, order),
                       FILL)


def induce_batched(csr: DeviceCSR, seed_sets: torch.Tensor,
                   nbr_cap: Optional[int] = None, need_dist: bool = False,
                   num_bfs_steps: int = 3) -> SubGraphVal:
    """Seed sets [B, S] -> a SubGraphVal with a leading batch axis: node ids
    [B, S] (the unique seeds, then ``FILL``), edge_index [B, 2, S * cap],
    edge ids [B, S * cap] (-1 past ``num_edges``), ``num_nodes`` and
    ``num_edges`` [B] and, with ``need_dist``, the distances [B, S] to local
    nodes 0 and 1 (``num_bfs_steps + 1`` where unreached)."""
    B, S = seed_sets.shape
    cap = nbr_cap or conf.default_full_nbr_num
    uniq = unique_rows(seed_sets)
    num_nodes = (uniq < FILL).sum(dim=-1, dtype=torch.int32)

    nbr, eid, deg = _full_candidates(csr, uniq, cap)  # [B, S, cap]
    ar_cap = torch.arange(cap, dtype=torch.int32, device=uniq.device)
    ar_s = torch.arange(S, dtype=torch.int32, device=uniq.device)
    row_valid = ((ar_cap[None, None, :] < deg[..., None])
                 & (ar_s[None, :, None] < num_nodes[:, None, None]))

    # membership of each neighbour in its sample's sorted seed set (the
    # fill is int32 max, so the search stays right)
    loc = torch.searchsorted(uniq, nbr.reshape(B, S * cap), out_int32=True)
    loc = torch.clamp(loc, 0, S - 1)
    member = ((torch.gather(uniq, 1, loc.long()) == nbr.reshape(B, -1))
              & (loc < num_nodes[:, None]))
    flat_keep = row_valid.reshape(B, -1) & member

    # compact the kept edges to the front: a stable sort by ~keep
    order = torch.argsort((~flat_keep).to(torch.uint8), dim=-1, stable=True)
    num_edges = flat_keep.sum(dim=-1, dtype=torch.int32)
    # flat slot s * cap + c holds local node s's c-th neighbour
    src = torch.div(order, cap, rounding_mode="floor").to(torch.int32)
    dst = torch.gather(loc, 1, order)
    eids = torch.gather(eid.reshape(B, -1), 1, order)
    slot_valid = (torch.arange(S * cap, dtype=torch.int32,
                               device=uniq.device)[None, :]
                  < num_edges[:, None])
    ei = torch.where(slot_valid[:, None, :], torch.stack([src, dst], dim=1),
                     0)
    eids = torch.where(slot_valid, eids, -1)

    dist_src = dist_dst = None
    if need_dist:
        # BFS from local nodes 0 and 1: the two smallest ids of each
        # sample's sorted seed set, as the JAX package roots it
        dist_src = _bfs_local(ei, slot_valid, S, 0, num_bfs_steps)
        dist_dst = _bfs_local(ei, slot_valid, S, 1, num_bfs_steps)
    return SubGraphVal(node_ids=uniq, num_nodes=num_nodes, edge_index=ei,
                       num_edges=num_edges, edge_ids=eids,
                       dist_to_src=dist_src, dist_to_dst=dist_dst)


def induce_subgraph(csr: DeviceCSR, seeds: torch.Tensor,
                    nbr_cap: Optional[int] = None, need_dist: bool = False,
                    num_bfs_steps: int = 3) -> SubGraphVal:
    """Seeds [b] -> the SubGraphVal of their unique set: the ``B = 1`` case
    of :func:`induce_batched`, without the batch axis."""
    sg = induce_batched(csr, seeds.reshape(1, -1), nbr_cap=nbr_cap,
                        need_dist=need_dist, num_bfs_steps=num_bfs_steps)
    return sg.map(lambda x: x[0])


def _bfs_local(edge_index: torch.Tensor, edge_valid: torch.Tensor, n: int,
               root: int, steps: int) -> torch.Tensor:
    """Hop distances [B, n] from local node ``root`` over each sample's
    valid edges [B, 2, E], relaxed both ways ``steps`` times; ``steps +
    1`` where unreached.  Each round reads the distances of the round
    before, as the JAX ``fori_loop`` does."""
    B = edge_index.shape[0]
    inf = steps + 1
    dist = torch.full((B, n), inf, dtype=torch.int32,
                      device=edge_index.device)
    if root < n:  # the JAX .at[root].set drops a root past the set
        dist[:, root] = 0
    src, dst = edge_index[:, 0].long(), edge_index[:, 1].long()
    for _ in range(steps):
        d_src = torch.gather(dist, 1, src)
        d_dst = torch.gather(dist, 1, dst)
        cand = torch.where(edge_valid & (d_src < inf), d_src + 1, inf)
        cand2 = torch.where(edge_valid & (d_dst < inf), d_dst + 1, inf)
        dist = (dist.scatter_reduce(1, dst, cand, "amin", include_self=True)
                .scatter_reduce(1, src, cand2, "amin", include_self=True))
    return dist
