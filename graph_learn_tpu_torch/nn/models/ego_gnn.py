"""EgoGNN: hop-list folding over EgoLayers, ``EgoGraphSAGE`` and ``EgoGAT``.

Counterpart of ``graph_learn_tpu/nn/models/ego_gnn.py``
``_encoder_commutes:27``, ``EgoGNN:47``, ``EgoGraphSAGE:126`` and
``EgoGAT:140``.  A deepest hop carrying ``DeferredRows`` is reduced
straight from the table by Kernel 2 (``gather_group_agg``) when the conv
and the encoder allow it; attention needs every neighbour's row, so under
an ``EgoGATConv`` the deferred rows are gathered instead (Kernel 1).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn.data import (DeferredRows, EgoGraph,
                                           PreAggregatedRows)
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.ego import (EgoGATConv, EgoLayer,
                                                 EgoSAGEConv, init_linear)
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


def _encoder_commutes(enc, op: str) -> bool:
    """Does ``enc(group_agg(rows)) == group_agg(enc(rows))``?

    A float-only FeatureEncoder is a cast or a cast + Linear: mean
    commutes with any affine map, sum/max only with the plain cast.
    """
    if not isinstance(enc, FeatureEncoder):
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
                    "%r) — pre-aggregate with the conv's op and a float-only "
                    "affine encoder" % (fa.op, type(conv).__name__, op))
            agg_raw = fa.agg
        elif op is None or not _encoder_commutes(enc, op):
            values[-1] = ego.hops[-1].replace(float_attrs=fa.materialize())
            return values, None
        else:
            agg_raw = fa.group_agg(op)  # [n_prev_flat, D_raw], Kernel 2
        deep_agg = enc(Nodes(ids=torch.zeros(agg_raw.shape[0],
                                             dtype=torch.int32,
                                             device=agg_raw.device),
                             float_attrs=agg_raw,
                             type_name=ego.hops[-1].type_name))
        return values[:-1], deep_agg

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
            h = [self._dropout(self.act(x), training, generator) for x in h]
        h = self.layers[-1](h, [hops[0]],
                            deep_agg=deep_agg if n_layers == 1 else None)
        assert len(h) == 1
        return h[0]

    def _dropout(self, x, training, generator):
        if not (self.dropout and training):
            return x
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


def _build(make_conv: Callable[[int], nn.Module], n_layers: int,
           decoder: Decoder, act: Callable, dropout: float,
           device: DeviceLike,
           generator: Optional[torch.Generator]) -> EgoGNN:
    """One shared conv per layer (``make_conv(i)``) over its hop pairs.
    Weights are drawn on the CPU from ``generator`` (default: seeded with
    0), then moved to ``device``."""
    dev = resolve_device(device)
    layers = [EgoLayer([make_conv(i)] * (n_layers - i))
              for i in range(n_layers)]
    model = EgoGNN(layers, FeatureEncoder(decoder), act=act, dropout=dropout)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
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
