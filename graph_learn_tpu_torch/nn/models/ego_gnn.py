"""EgoGNN: hop-list folding over EgoLayers, ``EgoGraphSAGE``, ``EgoGAT``,
``EgoGIN`` and the multi-relation ``EgoRGCN``.

Counterpart of ``graph_learn_tpu/nn/models/ego_gnn.py``
``_encoder_commutes:27``, ``EgoGNN:47``, ``EgoGraphSAGE:126``,
``EgoGAT:140``, ``EgoGIN:157`` and ``EgoRGCN:169``.  A deepest hop carrying
``DeferredRows`` is reduced straight from the table by Kernel 2
(``gather_group_agg``) when the conv and the encoder allow it (EgoGIN's
with a sum, EgoRGCN's with its ``agg_type`` over every deepest hop);
attention needs every neighbour's row, so under an ``EgoGATConv`` the
deferred rows are gathered instead (Kernel 1), as they are under an
encoder with embedding or multi-value columns, which commutes with no
reduction.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn.data import (DeferredRows, EgoGraph,
                                           PreAggregatedRows, materialized)
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.ego import (EgoGATConv, EgoGINConv,
                                                 EgoLayer, EgoRGCNConv,
                                                 EgoSAGEConv, init_linear)
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


def _encoder_commutes(enc, op: str) -> bool:
    """Does ``enc(group_agg(rows)) == group_agg(enc(rows))``?

    A float-only FeatureEncoder is a cast or a cast + Linear: mean
    commutes with any affine map, sum/max only with the plain cast.  An
    encoder with int-attribute embeddings or multi-value columns commutes
    with nothing, so its hop is materialised.
    """
    if not isinstance(enc, FeatureEncoder):
        return False
    d = enc.decoder
    if d.int_attr_num or d.multival_attr_num:
        return False
    if op == "mean":
        return True
    return enc.output_dim is None


class EgoGNN(nn.Module):
    """Fold K+1 hop tensors through EgoLayers; ``act`` (and dropout when
    training) between layers, none after the last.

    ``encoder`` encodes every hop; ``hop_encoders`` (one per hop position,
    index 0 = src), where given, takes its place for heterogeneous hops, as
    in a bipartite tower."""

    def __init__(self, layers: Sequence[EgoLayer],
                 encoder: Optional[nn.Module] = None,
                 act: Callable = torch.relu, dropout: float = 0.0,
                 hop_encoders: Optional[Sequence[nn.Module]] = None):
        super().__init__()
        if encoder is None and hop_encoders is None:
            raise InvalidArgumentError(
                "EgoGNN needs an encoder or hop_encoders")
        self.layers = nn.ModuleList(layers)
        self.encoder = encoder
        self.hop_encoders = (nn.ModuleList(hop_encoders)
                             if hop_encoders is not None else None)
        self.act = act
        self.dropout = dropout

    def _enc_for(self, i: int) -> nn.Module:
        return (self.hop_encoders[i] if self.hop_encoders is not None
                else self.encoder)

    def _prepare(self, ego: EgoGraph):
        """Split into (values to encode, deep_agg), handling deferral."""
        values = [ego.src] + list(ego.hops)
        fa = ego.hops[-1].float_attrs if ego.hops else None
        if not isinstance(fa, (DeferredRows, PreAggregatedRows)):
            return values, None
        conv = self.layers[0].convs[-1]
        op = getattr(conv, "deferred_op", None)
        enc = self._enc_for(len(values) - 1)
        if isinstance(fa, PreAggregatedRows):
            if op != fa.op or not _encoder_commutes(enc, op):
                raise InvalidArgumentError(
                    "PreAggregatedRows(op=%r) cannot feed %s (deferred_op="
                    "%r, encoder commutes=%s) — pre-aggregate with the "
                    "conv's op and a float-only affine encoder"
                    % (fa.op, type(conv).__name__, op,
                       _encoder_commutes(enc, op) if op else "-"))
            agg_raw = fa.agg
        elif op is None or not _encoder_commutes(enc, op):
            values[-1] = ego.hops[-1].replace(float_attrs=fa.materialize())
            return values, None
        else:
            agg_raw = fa.group_agg(op)  # [n_prev_flat, D_raw], Kernel 2
        return values[:-1], _encode_agg(enc, agg_raw, ego.hops[-1].type_name)

    def forward(self, ego: EgoGraph, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        values, deep_agg = self._prepare(ego)
        h = [self._enc_for(i)(v) for i, v in enumerate(values)]
        hops = list(ego.nbr_nums)
        n_layers = len(self.layers)
        for i in range(n_layers - 1):
            current = hops if i == 0 else hops[:len(hops) - i]
            h = self.layers[i](h, current,
                               deep_agg=deep_agg if i == 0 else None)
            h = [_dropout(self.act(x), self.dropout, training, generator)
                 for x in h]
        h = self.layers[-1](h, [hops[0]],
                            deep_agg=deep_agg if n_layers == 1 else None)
        assert len(h) == 1
        return h[0]


def _dropout(x: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; ``x`` itself when not
    training or at rate 0."""
    if not (rate and training):
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _encode_agg(enc: nn.Module, agg_raw: torch.Tensor,
                type_name: str) -> torch.Tensor:
    """``enc`` of a pre-reduced [n_groups, D_raw] deepest-hop aggregate."""
    return enc(Nodes(ids=torch.zeros(agg_raw.shape[0], dtype=torch.int32,
                                     device=agg_raw.device),
                     float_attrs=agg_raw, type_name=type_name))


def _build(make_conv: Callable[[int], nn.Module], n_layers: int,
           decoder: Decoder, act: Callable, dropout: float,
           device: DeviceLike,
           generator: Optional[torch.Generator]) -> EgoGNN:
    """One shared conv per layer (``make_conv(i)``) over its hop pairs.
    Weights are drawn on the CPU from ``generator`` (default: seeded with
    0), the encoder's embedding tables first, then moved to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    layers = [EgoLayer([make_conv(i)] * (n_layers - i))
              for i in range(n_layers)]
    model = EgoGNN(layers, FeatureEncoder(decoder, generator=generator),
                   act=act, dropout=dropout)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            init_linear(m, generator)
    return model.to(dev)


def EgoGraphSAGE(dims: Sequence[int], decoder: Decoder,
                 agg_type: str = "gcn", act: Callable = torch.relu,
                 dropout: float = 0.0, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None) -> EgoGNN:
    """dims[0] must equal the encoder output dim."""
    return _build(
        lambda i: EgoSAGEConv(dims[i], dims[i + 1], agg_type=agg_type),
        len(dims) - 1, decoder, act, dropout, device, generator)


def EgoGAT(dims: Sequence[int], decoder: Decoder,
           num_heads: Optional[Sequence[int]] = None,
           attn_dropout: float = 0.0, act: Callable = torch.relu,
           dropout: float = 0.0, seed_chunk: Optional[int] = None,
           device: DeviceLike = "cuda",
           generator: Optional[torch.Generator] = None) -> EgoGNN:
    """``num_heads[i]`` attention heads in layer i (default 1 each)."""
    return _build(
        lambda i: EgoGATConv(dims[i], dims[i + 1],
                             num_head=num_heads[i] if num_heads else 1,
                             attn_dropout=attn_dropout,
                             seed_chunk=seed_chunk),
        len(dims) - 1, decoder, act, dropout, device, generator)


def EgoGIN(dims: Sequence[int], decoder: Decoder, eps: float = 0.0,
           act: Callable = torch.relu, dropout: float = 0.0,
           device: DeviceLike = "cuda",
           generator: Optional[torch.Generator] = None) -> EgoGNN:
    """Each layer's in dim is an int, so every conv takes the equal-dims
    form (one ``output`` Linear, no ``(1 + eps)``), as in the JAX package;
    a deferred deepest hop is summed by Kernel 2."""
    return _build(
        lambda i: EgoGINConv(dims[i], dims[i + 1], eps=eps),
        len(dims) - 1, decoder, act, dropout, device, generator)


class EgoRGCN(nn.Module):
    """Multi-relation EgoGNN over R relations and K = len(dims) - 1 levels.

    ``ego.hops`` lists level l's R^l per-relation hop tensors, level by
    level: with 2 relations and 2 levels the aliases
    [r0_h1, r1_h1, r0_r0_h2, r0_r1_h2, r1_r0_h2, r1_r1_h2].  Conv i
    (``convs[i]``, an EgoRGCNConv) is shared over every group of its
    levels; group g of level l takes level l+1's tensors g*R .. g*R+R-1 as
    its per-relation neighbours.  ``act`` (and dropout from ``generator``
    when training) between layers, none after the last.

    The deferred deepest level: when every one of the R^K deepest hops
    carries ``DeferredRows`` or ``PreAggregatedRows`` and the encoder
    commutes with ``agg_type``, each is reduced over its fanout first
    (Kernel 2 for ``DeferredRows``), encoded, and fed to conv 0 as
    ``neighbors_agg``; otherwise the deepest rows are gathered (Kernel 1).
    A ``PreAggregatedRows`` of another op, or one under an encoder that
    does not commute, raises InvalidArgumentError.  Other hops' deferred
    rows are gathered.  Weights are drawn on the CPU from ``generator``
    (default: seeded with 0), then moved to ``device``.
    """

    def __init__(self, dims: Sequence[int], decoder: Decoder,
                 num_relations: int, num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None, agg_type: str = "mean",
                 act: Callable = torch.relu, dropout: float = 0.0,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_relations = num_relations
        self.agg_type = agg_type
        self.act = act
        self.dropout = dropout
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.encoder = FeatureEncoder(decoder, generator=generator)
        self.convs = nn.ModuleList([
            EgoRGCNConv(dims[i], dims[i + 1], num_relations,
                        num_bases=num_bases, num_blocks=num_blocks,
                        agg_type=agg_type)
            for i in range(len(dims) - 1)])
        for conv in self.convs:
            conv.reset_parameters(generator)
        self.to(dev)

    def _prepare(self, ego: EgoGraph):
        """(values to encode, encoded deepest aggregates or None)."""
        R, K = self.num_relations, len(self.convs)
        values = [ego.src] + list(ego.hops)
        n_deep = R ** K
        deep_vals = values[-n_deep:]
        if not all(isinstance(v.float_attrs, (DeferredRows,
                                              PreAggregatedRows))
                   for v in deep_vals):
            return values, None
        op = self.agg_type
        commute = _encoder_commutes(self.encoder, op)
        pre = [v.float_attrs for v in deep_vals
               if isinstance(v.float_attrs, PreAggregatedRows)]
        if pre and (not commute or any(fa.op != op for fa in pre)):
            raise InvalidArgumentError(
                "PreAggregatedRows cannot feed EgoRGCN (agg_type=%r, "
                "encoder commutes=%s) — pre-aggregate with the conv's op "
                "and a float-only affine encoder" % (op, commute))
        if not commute:
            return values, None
        deep_aggs = []
        for v in deep_vals:
            fa = v.float_attrs
            agg_raw = (fa.agg if isinstance(fa, PreAggregatedRows)
                       else fa.group_agg(op))  # Kernel 2
            deep_aggs.append(_encode_agg(self.encoder, agg_raw, v.type_name))
        return values[:-n_deep], deep_aggs

    def forward(self, ego: EgoGraph, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        R, K = self.num_relations, len(self.convs)
        values, deep_aggs = self._prepare(ego)
        h = [self.encoder(materialized(v)) for v in values]
        # the flat hop list as levels: level l holds R^l tensors
        levels: List[List[torch.Tensor]] = [[h[0]]]
        idx = 1
        for lvl in range(1, K + 1 - (deep_aggs is not None)):
            levels.append(h[idx:idx + R ** lvl])
            idx += R ** lvl
        expands = list(ego.nbr_nums)
        for i, conv in enumerate(self.convs):
            new_levels = []
            for lvl in range(K - i):
                outs = []
                for g in range(R ** lvl):
                    x = levels[lvl][g]
                    if i == 0 and deep_aggs is not None and lvl == K - 1:
                        outs.append(conv(x, None, expands[lvl],
                                         neighbors_agg=deep_aggs[
                                             g * R:g * R + R]))
                    else:
                        outs.append(conv(x, levels[lvl + 1][g * R:g * R + R],
                                         expands[lvl]))
                new_levels.append(outs)
            levels = new_levels
            if i < K - 1:
                levels = [[_dropout(self.act(x), self.dropout, training,
                                    generator) for x in lv]
                          for lv in levels]
        return levels[0][0]
