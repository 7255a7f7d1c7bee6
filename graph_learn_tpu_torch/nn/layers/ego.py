"""EgoGraph convolution layers: ``EgoSAGEConv`` and ``EgoLayer``.

Counterpart of ``graph_learn_tpu/nn/layers/ego.py`` ``EgoSAGEConv:36`` and
``EgoLayer:308``.  Tensors keep the JAX package's layout: ``x`` [b, D],
``neighbor`` [b * expand, D].  Weights are created uninitialised and set by
:func:`init_linear` from an explicit ``torch.Generator`` (or carried over
from a flax model by ``nn/convert.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

InDim = Union[int, Tuple[int, int]]


def _pair(in_dim: InDim) -> Tuple[int, int]:
    if isinstance(in_dim, (tuple, list)):
        assert len(in_dim) == 2
        return tuple(in_dim)
    return (in_dim, in_dim)


def make_linear(in_features: int, out_features: int,
                bias: bool) -> nn.Linear:
    """An ``nn.Linear`` whose weights are allocated but not drawn."""
    return nn.utils.skip_init(nn.Linear, in_features, out_features, bias=bias)


def init_linear(linear: nn.Linear, generator: torch.Generator):
    """LeCun-normal weight (std = fan_in^-1/2), zero bias."""
    with torch.no_grad():
        linear.weight.normal_(0.0, linear.in_features ** -0.5,
                              generator=generator)
        if linear.bias is not None:
            linear.bias.zero_()


class EgoSAGEConv(nn.Module):
    """Aggregate neighbours (mean | sum | max | gcn), then one Linear.

    'gcn' takes the mean over the neighbours and x together; the others
    concatenate x with the neighbour aggregate.
    """

    def __init__(self, in_dim: InDim, out_dim: int, agg_type: str = "mean",
                 use_bias: bool = False):
        super().__init__()
        if agg_type not in ("mean", "sum", "max", "gcn"):
            raise ValueError("unknown agg_type %r" % agg_type)
        self.in_dim = _pair(in_dim)
        self.out_dim = out_dim
        self.agg_type = agg_type
        lin_in = self.in_dim[1] if agg_type == "gcn" else sum(self.in_dim)
        self.trans_nodes = make_linear(lin_in, out_dim, use_bias)

    @property
    def deferred_op(self) -> str:
        """The reduction a pre-aggregated ``neighbor_agg`` must contain."""
        return "mean" if self.agg_type == "gcn" else self.agg_type

    def forward(self, x: torch.Tensor, neighbor: Optional[torch.Tensor],
                expand: int,
                neighbor_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        if neighbor_agg is not None:
            if self.agg_type == "gcn":
                # mean over [k nbrs ++ x] == (k * mean_nbr + x) / (k + 1)
                h = (expand * neighbor_agg + x) / (expand + 1.0)
            else:
                h = torch.cat([x, neighbor_agg], dim=1)
            return self.trans_nodes(h)
        nbr = neighbor.reshape(-1, expand, self.in_dim[1])
        if self.agg_type == "gcn":
            h = torch.cat([nbr, x[:, None, :]], dim=1).mean(dim=1)
            return self.trans_nodes(h)
        if self.agg_type == "mean":
            agg = nbr.mean(dim=1)
        elif self.agg_type == "sum":
            agg = nbr.sum(dim=1)
        else:
            agg = nbr.amax(dim=1)
        return self.trans_nodes(torch.cat([x, agg], dim=1))


class EgoLayer(nn.Module):
    """Apply conv i to hop pair (i, i+1): h_out[i] = conv_i(h[i], h[i+1]).

    ``share`` uses ONE conv (``convs[0]``) for every pair of this layer,
    as the JAX package's ``EgoGraphSAGE`` builds ``[conv] * n``.
    """

    def __init__(self, convs: Sequence[nn.Module], share: bool = True):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.share = share

    def forward(self, x_list, expands, deep_agg=None):
        # deep_agg: the deepest hop arrives pre-aggregated; x_list is then
        # one entry short and the last conv consumes the aggregate
        n_pairs = len(expands)
        assert len(x_list) == n_pairs + (deep_agg is None)
        out = []
        for i in range(n_pairs):
            conv = self.convs[0] if self.share else self.convs[i]
            if deep_agg is not None and i == n_pairs - 1:
                out.append(conv(x_list[i], None, expands[i],
                                neighbor_agg=deep_agg))
            else:
                out.append(conv(x_list[i], x_list[i + 1], expands[i]))
        return out
