"""Halo exchange and the sharded full-graph SpMM over the graph axis.

Counterpart of ``graph_learn_tpu/parallel/halo.py``: each shard owns its
destination rows' edges (``parallel/partition.py``), so one
``all_to_all`` of the boundary source rows makes every aggregation local.
The JAX package writes one ``shard_map`` over the stacked [P, rows, D]
features; here each rank of the graph group passes its own block
``x`` [rows, D] and gets its rows' aggregation back.

The exchange is a ``torch.autograd.Function``: its forward is the
``all_to_all_single`` of the send buffers, placed into the halo rows; its
backward is the reverse ``all_to_all_single`` of the halo rows' gradients
and a deterministic scatter-add (``ops/segment.py segment_sum``) of them
into the owned rows that were sent.  The local aggregation is plain
PyTorch (``take_rows`` and ``segment_sum``, deterministic forward and
backward): Kernel 2 has no backward and refuses a table that needs a
gradient.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch

from graph_learn_tpu_torch.core.sharding import (all_to_all, axis,
                                                 axis_index, bind_axes,
                                                 bind_mesh)
from graph_learn_tpu_torch.ops.segment import segment_sum, take_rows
from graph_learn_tpu_torch.parallel.partition import LocalGraph, ShardedGraph


def _dest(lg: LocalGraph) -> torch.Tensor:
    """[P, S_max] halo slot of each received row (``halo_max`` for
    padding, dropped)."""
    slot = torch.arange(lg.s_max, dtype=torch.int32,
                        device=lg.recv_offsets.device)[None, :]
    recv_counts = lg.recv_offsets[1:] - lg.recv_offsets[:-1]
    dest = lg.recv_offsets[:-1][:, None] + slot
    return torch.where(slot < recv_counts[:, None], dest, lg.halo_max)


class HaloExchange(torch.autograd.Function):
    """``x_own`` [rows, D] -> the halo rows [max(halo_max, 1), D]."""

    @staticmethod
    def forward(ctx, x_own, lg: LocalGraph, axis_name: str):
        p, s_max, d = lg.num_shards, lg.s_max, x_own.shape[-1]
        send = x_own[lg.send_idx.reshape(-1).long()].reshape(p, s_max, d)
        recv = all_to_all(send, axis_name).reshape(-1, d)
        dest = _dest(lg).reshape(-1).long()
        halo = torch.zeros((max(lg.halo_max, 1) + 1, d), dtype=x_own.dtype,
                           device=x_own.device)
        halo[dest] = recv
        # the backward may run on another thread (autograd's device
        # threads): it rebinds the axis it captured here
        ctx.lg, ctx.axis_name, ctx.rows = lg, axis_name, x_own.shape[0]
        ctx.axis = axis(axis_name)
        return halo[:max(lg.halo_max, 1)]

    @staticmethod
    def backward(ctx, g_halo):
        lg, d = ctx.lg, g_halo.shape[-1]
        p, s_max = lg.num_shards, lg.s_max
        g_ext = torch.cat([g_halo, torch.zeros((1, d), dtype=g_halo.dtype,
                                               device=g_halo.device)])
        g_recv = g_ext[torch.clamp(_dest(lg), max=g_ext.shape[0] - 1)
                       .reshape(-1).long()].reshape(p, s_max, d)
        with bind_axes(**{ctx.axis_name: ctx.axis}):
            g_send = all_to_all(g_recv.contiguous(), ctx.axis_name)
        slot = torch.arange(s_max, dtype=torch.int32,
                            device=g_halo.device)[None, :]
        seg = torch.where(slot < lg.send_counts[:, None], lg.send_idx,
                          ctx.rows)
        g_x = segment_sum(g_send.reshape(-1, d), seg.reshape(-1), ctx.rows)
        return g_x, None, None


def _local_graph(sg: Union[ShardedGraph, LocalGraph], axis_name: str,
                 device) -> LocalGraph:
    if isinstance(sg, LocalGraph):
        return sg
    cache = sg.__dict__.setdefault("_local", {})
    key = (axis_index(axis_name), str(device))
    if key not in cache:
        cache[key] = sg.local(key[0], device)
    return cache[key]


def local_spmm(lg: LocalGraph, x_own: torch.Tensor, halo: torch.Tensor,
               agg: str = "sum") -> torch.Tensor:
    """Aggregate [own ++ halo] rows over the shard's CSR: ``sum``,
    ``mean`` (by in-degree) or ``weighted_sum`` (by edge weight)."""
    buf = torch.cat([x_own, halo], dim=0)
    ro, nbr, rows = lg.row_offsets, lg.nbr_local, lg.rows_per_shard
    eidx = torch.arange(nbr.shape[0], dtype=torch.int32, device=nbr.device)
    dst_row = torch.searchsorted(ro, eidx, right=True, out_int32=True) - 1
    valid = eidx < ro[-1]
    msgs = take_rows(buf, nbr)
    if lg.edge_weight is not None and agg == "weighted_sum":
        msgs = msgs * lg.edge_weight[:, None]
    msgs = torch.where(valid[:, None], msgs, 0.0)
    seg = torch.where(valid, dst_row, rows)
    out = segment_sum(msgs, seg, rows)
    if agg == "mean":
        deg = ro[1:] - ro[:-1]
        out = out / torch.clamp(deg, min=1).to(out.dtype)[:, None]
    return out


def sharded_spmm(sg: Union[ShardedGraph, LocalGraph], x: torch.Tensor,
                 mesh=None, agg: str = "sum",
                 axis_name: str = "graph") -> torch.Tensor:
    """Distributed SpMM on this rank: ``x`` [rows, D] is the rank's block
    of the node features; returns its rows' aggregation over the local
    CSR of [own ++ halo] (``agg`` ``sum`` / ``mean`` / ``weighted_sum``).
    Every rank of the graph group calls it.  ``mesh`` binds the axis (a
    caller already inside a bound mesh passes None)."""
    if agg not in ("sum", "mean", "weighted_sum"):
        raise ValueError("agg must be sum, mean or weighted_sum, got %r"
                         % agg)
    with (bind_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        lg = _local_graph(sg, axis_name, x.device)
        if lg.num_shards > 1 and lg.halo_max > 0:
            halo = HaloExchange.apply(x, lg, axis_name)
        else:
            halo = torch.zeros((1, x.shape[-1]), dtype=x.dtype,
                               device=x.device)
        return local_spmm(lg, x, halo, agg)
