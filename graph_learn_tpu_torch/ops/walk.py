"""Random walks: DeepWalk (uniform) and node2vec p/q-biased walks, and the
skip-gram pairs of a batch of walks.

Counterpart of ``graph_learn_tpu/ops/walk.py`` ``_uniform_step:40``,
``deepwalk:64``, ``node2vec_walk:78`` and ``skipgram_pairs:166``, with
their ``ShardedCSR`` branches (``:30-62``, ``:122``): each step's
proposals come from the owner of the walker's node and the membership
probe from the owner of its previous node, each stitched by one psum, so
a sharded walk equals the single-device one.  A walk
is a [b, walk_len] id matrix whose first column is the seed.  A walker
that reaches a node with no out-edge emits -1 for every later step, as
the JAX package does (the reference's operator emits its default id; -1
is an invalid dense index, easily masked).

node2vec biases each step by rejection sampling (Grover & Leskovec; as
csrgraph / pecanpy do): ``num_tries`` uniform candidates y of the current
node v, each accepted with probability w(y) / max_w, where w = 1/p if y is
the previous node, 1 if y is a neighbour of it, 1/q otherwise; the first
accepted candidate is taken, and the last one if none is.  The first step
has no previous node and is uniform.  "Neighbour of the previous node" is
``ops/segment.py row_member``: a bisection of the row's id-sorted copy, or
on the "minimal" profile a scan of the row.

Each random function is split, as in ``ops/sampling.py``: a ``*_draw``
function takes the uniform numbers and is exact against the JAX package
on its own draws (``floor(u * deg)`` in float32, the same acceptance test
``u * max_w < w`` in float32), and the walk itself draws them from an
explicit ``torch.Generator``.  Nothing reads a value back to the host and
every loop is fixed by host integers (the walk length, the tries, the
CSR's ``max_degree``), so batches of walks can be captured in one CUDA
graph.
"""

from __future__ import annotations

import torch

from graph_learn_tpu_torch.core.sharding import (ShardedCSR, own_rows,
                                                 psum_owned)
from graph_learn_tpu_torch.core.store import DeviceCSR
from graph_learn_tpu_torch.ops.sampling import uniform_positions
from graph_learn_tpu_torch.ops.segment import row_bounds, row_member

# proposals a node2vec step draws before it takes its last one
NUM_TRIES = 8


def _neighbours(csr: DeviceCSR, cur: torch.Tensor, u: torch.Tensor):
    """Uniform neighbours of ``cur`` [b] for the draws ``u`` [b, n]:
    [b, n] ids, -1 where ``cur`` is -1 or has no out-edge.  On a
    ``ShardedCSR`` the owner of each walker's node proposes and one psum
    stitches the ids in id + 1 space, so a walker with no owner (-1)
    decodes back to -1 (``_stitch_ids:29``)."""
    if isinstance(csr, ShardedCSR):
        loc, own = own_rows(csr.rows_per_shard, csr.axis,
                            torch.clamp(cur, min=0))
        nxt = _neighbours(csr.local, torch.where(cur >= 0, loc, -1), u)
        live = (own & (cur >= 0))[:, None]
        return psum_owned(nxt + 1, live, csr.axis) - 1
    e = csr.num_edges
    if e == 0:
        return torch.full(u.shape, -1, dtype=torch.int32, device=u.device)
    start, _, deg = row_bounds(csr.row_offsets, torch.clamp(cur, min=0))
    pos = torch.clamp(uniform_positions(start, deg, u), 0, e - 1)
    live = ((deg > 0) & (cur >= 0))[:, None]
    return torch.where(live, csr.nbr_ids[pos], -1)


def uniform_step(csr: DeviceCSR, cur: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """One uniform step of the walkers ``cur`` [b] for the draws ``u`` [b]
    (``_uniform_step:40``)."""
    return _neighbours(csr, cur, u[:, None])[:, 0]


def deepwalk_draw(csr: DeviceCSR, seeds: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Uniform walks from ``seeds`` [b] for the draws ``u`` [walk_len - 1,
    b], one row a step: [b, walk_len] int32."""
    cur = seeds.to(torch.int32)
    cols = [cur]
    for t in range(u.shape[0]):
        cur = uniform_step(csr, cur, u[t])
        cols.append(cur)
    return torch.stack(cols, dim=1)


def deepwalk(csr: DeviceCSR, seeds: torch.Tensor, walk_len: int,
             generator: torch.Generator) -> torch.Tensor:
    """[b] seeds -> [b, walk_len] uniform walks (column 0 the seeds)."""
    u = torch.rand((max(walk_len - 1, 0), seeds.shape[0]),
                   generator=generator, device=seeds.device,
                   dtype=torch.float32)
    return deepwalk_draw(csr, seeds, u)


def biased_step(csr: DeviceCSR, prev: torch.Tensor, cur: torch.Tensor,
                u_cand: torch.Tensor, u_acc: torch.Tensor, p: float,
                q: float) -> torch.Tensor:
    """One node2vec step of the walkers at ``cur`` [b] that came from
    ``prev`` [b], for the candidate draws ``u_cand`` and the acceptance
    draws ``u_acc`` [b, num_tries] (``node2vec_walk:step``)."""
    inv_p, inv_q = 1.0 / p, 1.0 / q
    max_w = max(inv_p, 1.0, inv_q)
    cand = _neighbours(csr, cur, u_cand)
    is_pnbr = row_member(csr, torch.clamp(prev, min=0), cand)
    is_prev = cand == prev[:, None]
    w = torch.where(is_prev, inv_p, torch.where(is_pnbr, 1.0, inv_q))
    acc = u_acc * max_w < w
    first = torch.argmax(acc.to(torch.uint8), dim=-1)
    pick = torch.where(acc.any(dim=-1), first, cand.shape[-1] - 1)
    nxt = torch.gather(cand, 1, pick[:, None])[:, 0]
    return torch.clamp(nxt, min=-1)


def node2vec_draw(csr: DeviceCSR, seeds: torch.Tensor, u_first: torch.Tensor,
                  u_cand: torch.Tensor, u_acc: torch.Tensor, p: float,
                  q: float) -> torch.Tensor:
    """p/q-biased walks from ``seeds`` [b] for the draws of the uniform
    first step ``u_first`` [b] and of each later step ``u_cand`` /
    ``u_acc`` [walk_len - 2, b, num_tries]: [b, walk_len] int32."""
    prev = seeds.to(torch.int32)
    cur = uniform_step(csr, prev, u_first)
    cols = [prev, cur]
    for t in range(u_cand.shape[0]):
        prev, cur = cur, biased_step(csr, prev, cur, u_cand[t], u_acc[t],
                                     p, q)
        cols.append(cur)
    return torch.stack(cols, dim=1)


def node2vec_walk(csr: DeviceCSR, seeds: torch.Tensor, walk_len: int,
                  generator: torch.Generator, p: float = 1.0, q: float = 1.0,
                  num_tries: int = NUM_TRIES) -> torch.Tensor:
    """[b] seeds -> [b, walk_len] p/q-biased walks; ``p == q == 1`` is
    :func:`deepwalk`."""
    if p == 1.0 and q == 1.0:
        return deepwalk(csr, seeds, walk_len, generator)
    if walk_len <= 1:
        return seeds[:, None].to(torch.int32)
    b, dev = seeds.shape[0], seeds.device
    u_first = torch.rand((b,), generator=generator, device=dev,
                         dtype=torch.float32)
    shape = (walk_len - 2, b, num_tries)
    u_cand = torch.rand(shape, generator=generator, device=dev,
                        dtype=torch.float32)
    u_acc = torch.rand(shape, generator=generator, device=dev,
                       dtype=torch.float32)
    return node2vec_draw(csr, seeds, u_first, u_cand, u_acc, p, q)


def skipgram_pairs(walks: torch.Tensor, window: int):
    """(target, context, valid) training pairs of ``walks`` [b, L]: for
    each position i and offset d in [-window, window] (d != 0, i + d inside
    the walk), in that order, [b, P] targets ``walks[:, i]`` and contexts
    ``walks[:, i + d]``; ``valid`` where both ids are >= 0."""
    L = walks.shape[1]
    tgt, ctx = [], []
    for i in range(L):
        for d in range(-window, window + 1):
            j = i + d
            if d == 0 or j < 0 or j >= L:
                continue
            tgt.append(walks[:, i])
            ctx.append(walks[:, j])
    t = torch.stack(tgt, dim=1)
    c = torch.stack(ctx, dim=1)
    return t, c, (t >= 0) & (c >= 0)
