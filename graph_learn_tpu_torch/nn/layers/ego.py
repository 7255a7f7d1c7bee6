"""EgoGraph convolution layers: ``EgoSAGEConv``, ``EgoGATConv``, ``EgoLayer``.

Counterpart of ``graph_learn_tpu/nn/layers/ego.py`` ``EgoSAGEConv:36``,
``EgoGATConv:82`` and ``EgoLayer:308``.  Tensors keep the JAX package's layout: ``x`` [b, D],
``neighbor`` [b * expand, D].  Weights are created uninitialised and set by
:func:`init_linear` from an explicit ``torch.Generator`` (or carried over
from a flax model by ``nn/convert.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from graph_learn_tpu_torch.ops.kernels.gat import gat_block

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


class EgoGATConv(nn.Module):
    """Multi-head ego attention.

    Per head: project x and the neighbours, score each neighbour with
    leaky_relu(0.2) on attn([xt, nh]), softmax over the fanout, weighted
    sum of the projected neighbours; heads averaged.  The attn Linear on
    the concatenation splits linearly, ``xt @ a_l + nh @ a_r``.  Parameters
    mirror the flax layer: per head ``x_<i>``, ``n_<i>`` (hetero dims only:
    a homo layer projects neighbours with ``x_<i>``, so that weight gets
    both gradients) and ``attn_<i>`` ([2W] -> 1).

    The neighbour block (project, score, softmax, weighted sum) is
    :func:`graph_learn_tpu_torch.ops.kernels.gat.gat_block`: on the card
    one fused kernel that tiles the seeds itself, whatever ``seed_chunk``
    says.  On the CPU the plain version honours ``seed_chunk`` as the flax
    layer does (None = chunks of 256 seeds when ``num_head * out_dim`` >=
    1024, 0 = never, an int = that many seeds per chunk); chunked and
    unchunked results are equal.
    """

    _AUTO_CHUNK = 256
    _AUTO_MIN_WIDTH = 1024

    def __init__(self, in_dim: InDim, out_dim: int, num_head: int = 1,
                 use_bias: bool = False, attn_dropout: float = 0.0,
                 seed_chunk: Optional[int] = None):
        super().__init__()
        self.in_dim = _pair(in_dim)
        self.out_dim = out_dim
        self.num_head = num_head
        self.use_bias = use_bias
        self.attn_dropout = attn_dropout
        self.seed_chunk = seed_chunk
        self.is_homo = self.in_dim[0] == self.in_dim[1]
        for i in range(num_head):
            setattr(self, "x_%d" % i,
                    make_linear(self.in_dim[0], out_dim, use_bias))
            if not self.is_homo:
                setattr(self, "n_%d" % i,
                        make_linear(self.in_dim[1], out_dim, use_bias))
            setattr(self, "attn_%d" % i,
                    make_linear(2 * out_dim, 1, use_bias))

    def _heads(self, prefix: str):
        return [getattr(self, "%s_%d" % (prefix, i))
                for i in range(self.num_head)]

    def forward(self, x: torch.Tensor, neighbor: torch.Tensor, expand: int,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        heads, w, e = self.num_head, self.out_dim, expand
        b = x.shape[0]
        nbr = neighbor.reshape(b, e, self.in_dim[1]).contiguous()
        x_layers = self._heads("x")
        n_layers = x_layers if self.is_homo else self._heads("n")
        attn = torch.stack([a.weight[0] for a in self._heads("attn")])
        al, ar = attn[:, :w], attn[:, w:].contiguous()  # [H, W] each
        wx = torch.stack([m.weight.t() for m in x_layers])  # [H, Din, W]
        wn = torch.stack([m.weight.t() for m in n_layers])
        xh = torch.einsum("bd,hdw->hbw", x, wx)
        bn = ba = None
        if self.use_bias:
            xh = xh + torch.stack([m.bias for m in x_layers])[:, None, :]
            bn = torch.stack([m.bias for m in n_layers])
            ba = torch.cat([a.bias for a in self._heads("attn")])
        el = (xh * al[:, None, :]).sum(-1)  # [H, b]
        drop = None
        if self.attn_dropout and training:
            keep = 1.0 - self.attn_dropout
            drop = (torch.rand((heads, b, e), generator=generator,
                               device=x.device) < keep).to(x.dtype) / keep
        chunk = self.seed_chunk
        if chunk is None:
            wide = heads * w >= self._AUTO_MIN_WIDTH
            chunk = self._AUTO_CHUNK if wide else 0
        if nbr.is_cuda or not chunk or b <= chunk:
            out = gat_block(nbr, wn, ar, el, bn, ba, drop)  # [H, b, W]
        else:
            out = torch.cat([
                gat_block(nbr[lo:lo + chunk], wn, ar,
                          el[:, lo:lo + chunk].contiguous(), bn, ba,
                          None if drop is None
                          else drop[:, lo:lo + chunk].contiguous())
                for lo in range(0, b, chunk)], dim=1)
        return out.mean(dim=0)


class EgoLayer(nn.Module):
    """Apply conv i to hop pair (i, i+1): h_out[i] = conv_i(h[i], h[i+1]).

    ``share`` uses ONE conv (``convs[0]``) for every pair of this layer,
    as the JAX package's ``EgoGraphSAGE`` builds ``[conv] * n``.
    """

    def __init__(self, convs: Sequence[nn.Module], share: bool = True):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.share = share

    def forward(self, x_list, expands, deep_agg=None, **kwargs):
        # deep_agg: the deepest hop arrives pre-aggregated; x_list is then
        # one entry short and the last conv consumes the aggregate
        n_pairs = len(expands)
        assert len(x_list) == n_pairs + (deep_agg is None)
        out = []
        for i in range(n_pairs):
            conv = self.convs[0] if self.share else self.convs[i]
            if deep_agg is not None and i == n_pairs - 1:
                out.append(conv(x_list[i], None, expands[i],
                                neighbor_agg=deep_agg, **kwargs))
            else:
                out.append(conv(x_list[i], x_list[i + 1], expands[i],
                                **kwargs))
        return out
