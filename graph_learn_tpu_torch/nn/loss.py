"""Losses: supervised softmax CE and the unsupervised quartet.

Counterpart of ``graph_learn_tpu/nn/loss.py:15-66`` (sigmoid CE, in-batch
unsupervised softmax CE, triplet margin, triplet softplus, and the
supervised softmax CE of the examples), on plain tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def supervised_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Mean softmax CE with integer labels; with ``valid`` [b] the mean
    over the valid rows only (at least one)."""
    ls = F.cross_entropy(logits, labels.long(), reduction="none")
    if valid is not None:
        w = valid.to(ls.dtype)
        return (ls * w).sum() / torch.clamp(w.sum(), min=1.0)
    return ls.mean()


def sigmoid_cross_entropy_loss(pos_logit: torch.Tensor,
                               neg_logit: torch.Tensor) -> torch.Tensor:
    """mean BCE(pos, 1) + mean BCE(neg, 0)."""
    pos = F.binary_cross_entropy_with_logits(pos_logit,
                                             torch.ones_like(pos_logit))
    neg = F.binary_cross_entropy_with_logits(neg_logit,
                                             torch.zeros_like(neg_logit))
    return pos + neg


def unsupervised_softmax_cross_entropy_loss(src_emb: torch.Tensor,
                                            pos_emb: torch.Tensor,
                                            neg_emb: torch.Tensor,
                                            temperature: float = 1.0
                                            ) -> torch.Tensor:
    """Positive similarity against [b, neg] in-batch similarities."""
    pos_sim = (src_emb * pos_emb).sum(dim=-1, keepdim=True)
    neg_sim = src_emb @ neg_emb.T
    prob = torch.softmax(torch.cat([pos_sim, neg_sim], dim=-1) / temperature,
                         dim=-1)
    return -torch.log(prob[:, :1] + 1e-12).mean()


def triplet_margin_loss(pos_src_emb, pos_edge_emb, pos_dst_emb,
                        neg_src_emb, neg_edge_emb, neg_dst_emb,
                        margin: float, neg_num: int, L: int = 1
                        ) -> torch.Tensor:
    """TransE margin loss; ``L`` = 2 takes squared distances, else L1."""
    pos = pos_src_emb + pos_edge_emb - pos_dst_emb
    neg = neg_src_emb + neg_edge_emb - neg_dst_emb
    if L == 2:
        pos_d, neg_d = pos.square().sum(-1), neg.square().sum(-1)
    else:
        pos_d, neg_d = pos.abs().sum(-1), neg.abs().sum(-1)
    if neg_num > 1:
        pos_d = pos_d.repeat_interleave(neg_num)
    return torch.clamp(margin + pos_d - neg_d, min=0.0).mean()


def triplet_softplus_loss(pos_src_emb, pos_edge_emb, pos_dst_emb,
                          neg_src_emb, neg_edge_emb, neg_dst_emb
                          ) -> torch.Tensor:
    """DistMult softplus loss."""
    pos_s = (pos_src_emb * pos_edge_emb * pos_dst_emb).sum(-1)
    neg_s = (neg_src_emb * neg_edge_emb * neg_dst_emb).sum(-1)
    return F.softplus(-pos_s).mean() + F.softplus(neg_s).mean()
