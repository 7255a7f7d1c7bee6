"""Graph partitioning for full-graph aggregation over the graph axis.

Counterpart of ``graph_learn_tpu/parallel/partition.py``: nodes are
range-partitioned into P contiguous shards, and every edge lives on its
destination's owner, so each shard aggregates its own nodes completely
from local edges.  The only communication is the boundary ("halo")
source rows, exchanged with one ``all_to_all`` (``parallel/halo.py``).

The host build is the JAX package's numpy, with the per-edge Python dict
of halo positions (``:73-75``) replaced by a ``searchsorted`` over the
shard's sorted ``halo_ids``: the same arrays.  Every array is stacked on a
leading shard axis; :meth:`ShardedGraph.local` is one rank's block on its
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graph_learn_tpu_torch.core.store import EdgeTable
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


@dataclasses.dataclass
class LocalGraph:
    """One shard's block of a :class:`ShardedGraph` on a device."""

    row_offsets: torch.Tensor  # [rows + 1] int32
    nbr_local: torch.Tensor  # [E_max] int32 index into [own ++ halo]
    edge_weight: Optional[torch.Tensor]  # [E_max] f32
    send_idx: torch.Tensor  # [P, S_max] int32 local rows to send to q
    send_counts: torch.Tensor  # [P] int32
    recv_offsets: torch.Tensor  # [P + 1] int32
    num_shards: int
    rows_per_shard: int
    halo_max: int
    s_max: int


@dataclasses.dataclass
class ShardedGraph:
    """Per-shard CSR and halo exchange plan; leading axis = shard."""

    row_offsets: np.ndarray  # [P, rows_per_shard + 1] int32
    nbr_local: np.ndarray  # [P, E_max] int32 (padded)
    edge_weight: Optional[np.ndarray]  # [P, E_max] f32
    # send_idx[p, q, s] = p-local row index to send to shard q
    send_idx: np.ndarray  # [P, P, S_max] int32 (padded with 0)
    send_counts: np.ndarray  # [P, P] int32
    # rows received from shard q land in the local buffer at
    # [own + recv_offsets[p, q], own + recv_offsets[p, q + 1])
    recv_offsets: np.ndarray  # [P, P + 1] int32
    num_shards: int = 1
    rows_per_shard: int = 0
    halo_max: int = 0
    s_max: int = 0

    @property
    def buffer_rows(self) -> int:
        return self.rows_per_shard + self.halo_max

    def local(self, p: int, device: DeviceLike = "cuda") -> LocalGraph:
        """Shard ``p``'s block on ``device``: the card unless the CPU is
        asked for."""
        device = resolve_device(device)

        def put(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a[p])).to(device)
        return LocalGraph(
            row_offsets=put(self.row_offsets), nbr_local=put(self.nbr_local),
            edge_weight=put(self.edge_weight), send_idx=put(self.send_idx),
            send_counts=put(self.send_counts),
            recv_offsets=put(self.recv_offsets), num_shards=self.num_shards,
            rows_per_shard=self.rows_per_shard, halo_max=self.halo_max,
            s_max=self.s_max)


def partition_edges(et: EdgeTable, num_shards: int) -> ShardedGraph:
    """Range-partition the dst nodes; build per-shard CSR + halo plan."""
    n = et.num_dst_nodes
    if et.num_src_nodes != et.num_dst_nodes:
        raise ValueError("full-graph partitioning assumes a homogeneous "
                         "node space")
    P = num_shards
    rows = -(-n // P)  # rows per shard (last shard padded)

    src = et.src.astype(np.int64)
    dst = et.dst.astype(np.int64)
    w = et.weights

    owner = (dst // rows).astype(np.int32)
    shard_csr = []
    shard_halo = []
    for p in range(P):
        sel = owner == p
        s_p = src[sel]
        d_p = dst[sel] - p * rows  # local dst row
        w_p = w[sel] if w is not None else None
        own_lo, own_hi = p * rows, (p + 1) * rows
        is_own = (s_p >= own_lo) & (s_p < own_hi)
        halo_ids = np.unique(s_p[~is_own])
        # local buffer index: own rows [0, rows), the halo appended
        local_src = np.where(is_own, s_p - own_lo,
                             rows + np.searchsorted(halo_ids, s_p))
        order = np.argsort(d_p, kind="stable")
        counts = np.bincount(d_p, minlength=rows)
        ro = np.zeros(rows + 1, np.int32)
        np.cumsum(counts, out=ro[1:])
        shard_csr.append((ro, local_src[order].astype(np.int32),
                          w_p[order] if w_p is not None else None))
        shard_halo.append(halo_ids)

    e_max = max(len(c[1]) for c in shard_csr)
    halo_max = max(len(h) for h in shard_halo) if P > 1 else 0

    # send plan: shard q needs the halo ids owned by p
    send_lists = [[np.zeros(0, np.int64) for _ in range(P)] for _ in range(P)]
    for q in range(P):
        h = shard_halo[q]
        hp = (h // rows).astype(np.int32)
        for p in range(P):
            send_lists[p][q] = h[hp == p] - p * rows  # p-local rows
    s_max = max((len(send_lists[p][q]) for p in range(P) for q in range(P)),
                default=0)
    s_max = max(s_max, 1)

    send_idx = np.zeros((P, P, s_max), np.int32)
    send_counts = np.zeros((P, P), np.int32)
    recv_offsets = np.zeros((P, P + 1), np.int32)
    for p in range(P):
        for q in range(P):
            lst = send_lists[p][q]
            send_counts[p, q] = len(lst)
            send_idx[p, q, :len(lst)] = lst
    for q in range(P):
        # q's halo ids are sorted, so the rows from shard p are one run
        # (ids in [p * rows, (p + 1) * rows)): the all_to_all receive layout
        h = shard_halo[q]
        hp = (h // rows).astype(np.int32)
        cnt = np.bincount(hp, minlength=P)
        np.cumsum(cnt, out=recv_offsets[q, 1:])

    ro_s = np.stack([c[0] for c in shard_csr])
    nbr_s = np.stack([np.pad(c[1], (0, e_max - len(c[1]))) for c in shard_csr])
    w_s = None
    if w is not None:
        w_s = np.stack([np.pad(c[2], (0, e_max - len(c[2])))
                        for c in shard_csr]).astype(np.float32)
    return ShardedGraph(
        row_offsets=ro_s, nbr_local=nbr_s, edge_weight=w_s,
        send_idx=send_idx, send_counts=send_counts,
        recv_offsets=recv_offsets, num_shards=P, rows_per_shard=int(rows),
        halo_max=int(halo_max), s_max=int(s_max))


def shard_features(feats: np.ndarray, num_shards: int) -> np.ndarray:
    """[N, D] -> [P, rows, D] range-partitioned (zero-padded tail)."""
    n, d = feats.shape
    rows = -(-n // num_shards)
    pad = num_shards * rows - n
    fp = np.pad(np.asarray(feats), ((0, pad), (0, 0)))
    return fp.reshape(num_shards, rows, d)
