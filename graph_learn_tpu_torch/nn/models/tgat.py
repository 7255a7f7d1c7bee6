"""EgoTGAT: temporal graph attention over ``TemporalGraph`` hop lists.

Counterpart of ``graph_learn_tpu/nn/models/tgat.py`` ``TimeEncoder:30``,
``EgoTGAT:46``, ``MergeLayer:124`` and ``LinkScorePredict:139``: a Bochner
time encoding ``cos(t * basis_freq + phase)`` (``basis_freq`` starts at
``1 / 10**linspace(0, 9, time_dim)``), and per level one ``EgoGATConv``
shared over the level's hop pairs, attending over ``[node feat ++ edge
feat ++ time emb]`` of the neighbours with ``[feat ++ time emb]`` of the
centre as the query.  Every neighbour block is ``gat_block`` (Kernel 3 on
the card, forward and backward).

The flax layer infers its input widths; the port states them (a torch
``Linear`` needs them at construction):

- level 0: queries ``feat + time``, keys ``feat + edge feat + time``, with
  the neighbour projections ``n_<i>`` even where the two are equal (the
  flax model marks level 0 hetero with ``in_dim=(1, 2)``);
- later levels: ``hidden + time`` on both sides.

The widths are the encoders' output widths (``FeatureEncoder.out_dim``)
and the edge features': the width of hop i's edge encoder
(``edge_encoders[i]``, a ``FeatureEncoder`` over the edge type's
decoder), or, where it has none, ``edge_dim``, the width of the hop
edges' raw float attrs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn.data import TemporalGraph
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.ego import (EgoGATConv, init_linear,
                                                 make_linear)
from graph_learn_tpu_torch.nn.models.ego_gnn import _dropout
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


def _width(enc: nn.Module) -> int:
    """The output width of a ``FeatureEncoder``."""
    return FeatureEncoder.out_dim(enc.decoder, enc.output_dim)


def _init(model: nn.Module, generator: Optional[torch.Generator],
          device: DeviceLike) -> nn.Module:
    """Draw every Linear (``init_linear``) and time phase on the CPU from
    ``generator`` (default: seeded with 0), then move to ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear(m, generator)
        elif isinstance(m, TimeEncoder):
            m.reset_parameters(generator)
    return model.to(resolve_device(device))


class TimeEncoder(nn.Module):
    """Bochner time-span encoding (reference temporalgraph.py:145-163):
    [...] spans -> [n, time_dim] ``cos(t * basis_freq + phase)``."""

    def __init__(self, time_dim: int):
        super().__init__()
        self.time_dim = time_dim
        self.basis_freq = nn.Parameter(torch.empty(time_dim))
        self.phase = nn.Parameter(torch.empty(time_dim))

    def reset_parameters(self, generator: torch.Generator):
        """``basis_freq`` to ``1 / 10**linspace(0, 9, time_dim)`` and
        ``phase`` uniform in [0, 1), as the flax initialisers."""
        freq0 = (1.0 / 10 ** np.linspace(0, 9, self.time_dim)).astype(
            np.float32)
        with torch.no_grad():
            self.basis_freq.copy_(torch.from_numpy(freq0))
            self.phase.uniform_(0.0, 1.0, generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        ts = t.to(torch.float32).reshape(-1)[:, None]
        return torch.cos(ts * self.basis_freq[None, :]
                         + self.phase[None, :])


class EgoTGAT(nn.Module):
    """TGAT over a ``TemporalGraph`` of ``num_hops`` hops (reference
    ego_tgat.py:31-97).

    ``encoders``: ``num_hops + 1`` node feature encoders (src, then each
    hop's node type; one width for all); the hop edges' features join the
    keys: ``edge_encoders[i]`` of hop i's ``Edges`` where given (a list
    of ``num_hops`` modules or None), else their raw float attrs,
    ``edge_dim`` wide (0: none).  Every hop's edge features need one
    width, since level 0's conv is shared over the hops.  ``convs[l]`` is level l's
    conv, shared over its hop pairs.  ``act`` (and dropout when training)
    between levels.  Weights are drawn from ``generator`` on the CPU
    (``_init``), then moved to ``device``."""

    def __init__(self, hidden_dim: int, out_dim: int, time_dim: int,
                 num_hops: int, encoders: Sequence[nn.Module],
                 edge_dim: int = 0, num_head: int = 1,
                 attn_dropout: float = 0.0, act: Callable = torch.relu,
                 dropout: float = 0.0, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 edge_encoders: Optional[Sequence[Optional[nn.Module]]]
                 = None):
        super().__init__()
        if len(encoders) != num_hops + 1:
            raise InvalidArgumentError(
                "EgoTGAT: %d encoders for %d hops (want hops + 1)"
                % (len(encoders), num_hops))
        feat = {_width(e) for e in encoders}
        if len(feat) != 1:
            raise InvalidArgumentError(
                "EgoTGAT: the convs are shared over the hop pairs, so every "
                "encoder needs one width, got %s" % sorted(feat))
        edge_encoders = list(edge_encoders or [None] * num_hops)
        if len(edge_encoders) != num_hops:
            raise InvalidArgumentError(
                "EgoTGAT: %d edge encoders for %d hops"
                % (len(edge_encoders), num_hops))
        # the modules by hop position (a hop without one reads raw attrs)
        self.edge_encoders = nn.ModuleDict(
            {str(i): enc for i, enc in enumerate(edge_encoders)
             if enc is not None})
        widths = {edge_dim if enc is None else _width(enc)
                  for enc in edge_encoders}
        if len(widths) > 1:
            raise InvalidArgumentError(
                "EgoTGAT: level 0's conv is shared over the hops, so every "
                "hop's edge features need one width, got %s"
                % sorted(widths))
        f, T = feat.pop(), time_dim
        e = widths.pop() if widths else edge_dim
        self.hidden_dim, self.out_dim, self.time_dim = hidden_dim, out_dim, T
        self.num_hops = num_hops
        self.act, self.dropout = act, dropout
        self.encoders = nn.ModuleList(encoders)
        self.time_encoder = TimeEncoder(T)
        convs = []
        for lvl in range(num_hops):
            width = out_dim if lvl == num_hops - 1 else hidden_dim
            in_dim = ((f + T, f + e + T) if lvl == 0
                      else hidden_dim + T)
            convs.append(EgoGATConv(in_dim, width, num_head=num_head,
                                    attn_dropout=attn_dropout,
                                    hetero=lvl == 0))
        self.convs = nn.ModuleList(convs)
        _init(self, generator, device)

    def forward(self, tg: TemporalGraph, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        K = self.num_hops
        if len(tg.nbr_nodes) != K:
            raise InvalidArgumentError("EgoTGAT of %d hops given %d"
                                       % (K, len(tg.nbr_nodes)))
        time_enc = self.time_encoder
        # h^0: [feat, (edge feat,) time emb] per hop position, [n, d] each
        h = [[self.encoders[0](tg.src), time_enc(tg.src_t)]]
        for i in range(K):
            ev = tg.nbr_edges[i]
            if str(i) in self.edge_encoders:
                e_feat = self.edge_encoders[str(i)](ev)
            else:
                fa = ev.float_attrs
                e_feat = None if fa is None else fa.reshape(-1, fa.shape[-1])
            h.append([self.encoders[i + 1](tg.nbr_nodes[i])]
                     + ([e_feat] if e_feat is not None else [])
                     + [time_enc(tg.nbr_t[i])])
        hops = list(tg.nbr_nums)
        for lvl, conv in enumerate(self.convs):
            current = hops if lvl == 0 else hops[:len(hops) - lvl]
            new_h = [conv(torch.cat([h[i - 1][0], h[i - 1][-1]], dim=-1),
                          torch.cat(h[i], dim=-1), current[i - 1],
                          training=training, generator=generator)
                     for i in range(1, len(h))]
            if lvl == K - 1:
                assert len(new_h) == 1
                return new_h[0]
            h = [[_dropout(self.act(x), self.dropout, training, generator),
                  time_enc(tg.src_t if idx == 0 else tg.nbr_t[idx - 1])]
                 for idx, x in enumerate(new_h)]
        raise AssertionError("unreachable")


class MergeLayer(nn.Module):
    """Two Linears over the concatenated embeddings, ``act`` between
    (reference ego_tgat.py:99-121): ``merge_layer1``, ``merge_layer2``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 act: Callable = torch.relu):
        super().__init__()
        self.merge_layer1 = make_linear(in_dim, hidden_dim, True)
        self.merge_layer2 = make_linear(hidden_dim, out_dim, True)
        self.act = act

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.merge_layer2(self.act(self.merge_layer1(
            torch.cat([x1, x2], dim=-1))))


class LinkScorePredict(nn.Module):
    """Affinity scores of (src, pos dst) and (src, neg dst) (reference
    ego_tgat.py:138-146): one ``MergeLayer(feat_dim, 1)``,
    ``affinity_score``, over pairs of ``emb_dim``-wide embeddings (default
    ``feat_dim``)."""

    def __init__(self, feat_dim: int, emb_dim: Optional[int] = None,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        emb = feat_dim if emb_dim is None else emb_dim
        self.affinity_score = MergeLayer(2 * emb, feat_dim, 1)
        _init(self, generator, device)

    def forward(self, src_emb, pos_dst_emb, neg_dst_emb):
        pos = self.affinity_score(src_emb, pos_dst_emb).squeeze(-1)
        neg = self.affinity_score(src_emb, neg_dst_emb).squeeze(-1)
        return pos, neg
