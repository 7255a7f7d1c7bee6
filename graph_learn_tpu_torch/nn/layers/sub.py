"""SubGraph (edge_index) convolutions: SAGE, GCN, GAT and Hetero.

Counterpart of ``graph_learn_tpu/nn/layers/sub.py`` ``SAGEConv:45``,
``GCNConv:84``, ``GATConv:118`` and ``HeteroConv:167``:

- ``SAGEConv``: messages from ``edge_index[0]`` summed or averaged onto
  ``edge_index[1]``, then ``neigh_weights`` plus (but for ``gcn``)
  ``self_weights`` of the dst nodes;
- ``GCNConv``: self-loops appended, ``weights`` x scaled by each node's
  ``deg^-1/2`` (degree along ``edge_index[0]``), messages from
  ``edge_index[1]`` summed onto ``edge_index[0]``;
- ``GATConv``: self-loops appended, per-head ``w`` x, attention
  ``leaky_relu(a_src·h_i + a_dst·h_j, 0.2)`` softmaxed over each
  ``edge_index[0]`` segment, weighted sums, heads concatenated or
  averaged;
- ``HeteroConv``: one conv per edge type, summed per dst node type.

A masked edge slot (``edge_mask`` False) carries nothing.  Flax infers a
``Dense``'s input width; a torch ``Linear`` needs it, so each conv states
its ``in_dim`` (SAGE: ``(src, dst)`` widths where they differ).  The
parameters keep the flax names: ``neigh_weights`` / ``self_weights``,
``weights``, ``w`` with ``attn_src`` / ``attn_dst`` [1, H, D], ``bias``.
A conv draws its weights at construction from ``generator`` (default:
seeded with 0) on the CPU.

Every sum over edges is ``ops.segment.segment_sum`` and every row take
that a gradient flows back through is ``take_rows``: sorted reductions,
not atomics, so a step gives the same bits eagerly and replayed in a CUDA
graph.  All plain PyTorch, as the JAX convs are XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from graph_learn_tpu_torch.nn.layers.ego import (init_lecun, init_linear,
                                                 make_linear)
from graph_learn_tpu_torch.nn.models.ego_gnn import _dropout
from graph_learn_tpu_torch.ops.segment import (segment_softmax, segment_sum,
                                               take_rows)

InDim = Union[int, Tuple[int, int]]


def _masked(vals: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return vals
    return torch.where(mask.reshape((-1,) + (1,) * (vals.dim() - 1)), vals,
                       0.0)


def _seg_sum(vals, seg, n, mask=None):
    return segment_sum(_masked(vals, mask), seg, n)


def _seg_mean(vals, seg, n, mask=None):
    s = _seg_sum(vals, seg, n, mask)
    ones = torch.ones((vals.shape[0], 1), dtype=vals.dtype,
                      device=vals.device)
    cnt = _seg_sum(ones, seg, n, mask)
    return s / torch.clamp(cnt, min=1.0)


def _with_self_loops(edge_index: torch.Tensor,
                     edge_mask: Optional[torch.Tensor], n: int):
    """``edge_index`` with one self-loop per node appended (always valid)."""
    diag = torch.arange(n, dtype=edge_index.dtype, device=edge_index.device)
    ei = torch.cat([edge_index, torch.stack([diag, diag])], dim=1)
    mask = None
    if edge_mask is not None:
        mask = torch.cat([edge_mask, torch.ones(n, dtype=torch.bool,
                                                device=edge_mask.device)])
    return ei, mask


class SAGEConv(nn.Module):
    """GraphSAGE over ``edge_index`` (reference sage_conv.py:59-90)."""

    def __init__(self, in_dim: InDim, out_dim: int, agg_type: str = "mean",
                 normalize: bool = False, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg_type not in ("mean", "sum", "gcn"):
            raise ValueError("unsupported agg_type %r" % agg_type)
        d_src, d_dst = (tuple(in_dim) if isinstance(in_dim, (tuple, list))
                        else (in_dim, in_dim))
        self.agg_type, self.normalize = agg_type, normalize
        self.neigh_weights = make_linear(d_src, out_dim, False)
        self.self_weights = (None if agg_type == "gcn"
                             else make_linear(d_dst, out_dim, False))
        self.bias = (nn.Parameter(torch.zeros(out_dim)) if use_bias
                     else None)
        init_sub(self, generator)

    def forward(self, edge_index, node_vec, edge_mask=None):
        if not isinstance(node_vec, (tuple, list)):
            node_vec = (node_vec, node_vec)
        n_dst = node_vec[1].shape[0]
        msgs = take_rows(node_vec[0], edge_index[0])
        agg_fn = _seg_mean if self.agg_type == "mean" else _seg_sum
        agg = agg_fn(msgs, edge_index[1], n_dst, edge_mask)
        out = self.neigh_weights(agg)
        if self.self_weights is not None:
            out = out + self.self_weights(node_vec[1])
        if self.bias is not None:
            out = out + self.bias
        if self.normalize:
            out = out / torch.clamp(torch.linalg.norm(out, dim=-1,
                                                      keepdim=True),
                                    min=1e-12)
        return out


class GCNConv(nn.Module):
    """GCN over ``edge_index`` with self-loops (reference
    gcn_conv.py:48-80)."""

    def __init__(self, in_dim: int, out_dim: int, normalize: bool = True,
                 use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize = normalize
        self.weights = make_linear(in_dim, out_dim, False)
        self.bias = (nn.Parameter(torch.zeros(out_dim)) if use_bias
                     else None)
        init_sub(self, generator)

    def forward(self, edge_index, node_vec, edge_mask=None):
        n = node_vec.shape[0]
        ei, mask = _with_self_loops(edge_index, edge_mask, n)
        h = self.weights(node_vec)
        if self.normalize:
            w = torch.ones((ei.shape[1], 1), dtype=h.dtype, device=h.device)
            deg = _seg_sum(w, ei[0], n, mask)[:, 0]
            dinv = torch.where(deg > 0,
                               torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
            h = h * dinv[:, None]
        out = _seg_sum(take_rows(h, ei[1]), ei[0], n, mask)
        if self.bias is not None:
            out = out + self.bias
        return out


class GATConv(nn.Module):
    """Multi-head GAT over ``edge_index`` with self-loops (reference
    gat_conv.py:40-120).  Attention dropout draws from the ``generator``
    passed to ``forward`` when ``training``."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 concat: bool = False, attn_dropout: float = 0.0,
                 use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.out_dim = num_heads, out_dim
        self.concat, self.attn_dropout = concat, attn_dropout
        self.w = make_linear(in_dim, num_heads * out_dim, False)
        self.attn_src = nn.Parameter(torch.empty(1, num_heads, out_dim))
        self.attn_dst = nn.Parameter(torch.empty(1, num_heads, out_dim))
        width = num_heads * out_dim if concat else out_dim
        self.bias = (nn.Parameter(torch.zeros(width)) if use_bias else None)
        init_sub(self, generator)

    def forward(self, edge_index, node_vec, edge_mask=None,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        n = node_vec.shape[0]
        H, D = self.num_heads, self.out_dim
        ei, mask = _with_self_loops(edge_index, edge_mask, n)
        h = self.w(node_vec).reshape(-1, H, D)
        src_e = (h * self.attn_src).sum(dim=-1)  # [n, H]
        dst_e = (h * self.attn_dst).sum(dim=-1)
        e = F.leaky_relu(take_rows(src_e, ei[0]) + take_rows(dst_e, ei[1]),
                         0.2)  # [E, H]
        m = None if mask is None else mask[:, None].expand(e.shape)
        alpha = segment_softmax(e, ei[0], n, mask=m)
        alpha = _dropout(alpha, self.attn_dropout, training, generator)
        msgs = _masked(take_rows(h, ei[1]) * alpha[..., None], mask)
        out = segment_sum(msgs, ei[0], n)  # [n, H, D]
        out = out.reshape(-1, H * D) if self.concat else out.mean(dim=1)
        if self.bias is not None:
            out = out + self.bias
        return out


class HeteroConv(nn.Module):
    """One conv per edge type, outputs summed per dst node type (reference
    hetero_conv.py); ``convs`` is an ``nn.ModuleDict`` (flax names each
    ``convs_<edge type>``)."""

    def __init__(self, convs: dict):
        super().__init__()
        self.convs = nn.ModuleDict(convs)

    def forward(self, edge_indices: dict, node_vecs: dict, topology: dict,
                edge_masks: Optional[dict] = None, **kwargs):
        out = {}
        for et, conv in self.convs.items():
            s_t, d_t = topology[et]
            vec = (node_vecs[s_t] if s_t == d_t
                   else (node_vecs[s_t], node_vecs[d_t]))
            res = conv(edge_indices[et], vec,
                       edge_mask=(edge_masks or {}).get(et), **kwargs)
            out[d_t] = res if d_t not in out else out[d_t] + res
        return out


def init_sub(module: nn.Module,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every Linear (LeCun normal) and GAT attention vector of
    ``module`` from ``generator`` (default: seeded with 0); biases start
    at zero."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            init_linear(m, generator)
        elif isinstance(m, GATConv):
            init_lecun(m.attn_src, generator)
            init_lecun(m.attn_dst, generator)
    return module
