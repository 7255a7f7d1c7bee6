"""EgoGraph convolution layers: ``EgoSAGEConv``, ``EgoGATConv``,
``EgoGINConv``, ``EgoRGCNConv``, ``EgoLayer``.

Counterpart of ``graph_learn_tpu/nn/layers/ego.py`` ``EgoSAGEConv:36``,
``EgoGATConv:82``, ``EgoGINConv:209``, ``EgoRGCNConv:239`` and
``EgoLayer:308``.  Tensors keep the JAX package's layout: ``x`` [b, D],
``neighbor`` [b * expand, D].  Weights are created uninitialised and set by
:func:`init_linear` / :func:`init_lecun` from an explicit
``torch.Generator`` (or carried over from a flax model by
``nn/convert.py``).
"""

from __future__ import annotations

import math
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


def init_lecun(param: torch.Tensor, generator: torch.Generator):
    """LeCun-normal draw of a raw weight array (std = fan_in^-1/2), with
    flax's fan-in for its shape: ``shape[-2]`` times the product of the
    leading axes (``I * B`` for [B, I, O], ``R`` for [R, B])."""
    fan_in = param.shape[-2] * math.prod(param.shape[:-2])
    with torch.no_grad():
        param.normal_(0.0, fan_in ** -0.5, generator=generator)


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
    both gradients) and ``attn_<i>`` ([2W] -> 1).  ``hetero=True`` keeps
    ``n_<i>`` even where the two widths are equal, as the flax layer does
    for the ``in_dim`` pair EgoTGAT's first level passes it.

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
                 seed_chunk: Optional[int] = None, hetero: bool = False):
        super().__init__()
        self.in_dim = _pair(in_dim)
        self.out_dim = out_dim
        self.num_head = num_head
        self.use_bias = use_bias
        self.attn_dropout = attn_dropout
        self.seed_chunk = seed_chunk
        self.is_homo = self.in_dim[0] == self.in_dim[1] and not hetero
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


class EgoGINConv(nn.Module):
    """W((1 + eps) x + sum of the neighbours).

    With unequal in dims, ``trans_x`` projects ``(1 + eps) x``,
    ``trans_nbrs`` the neighbour sum and ``output`` their sum.  With equal
    dims there is one ``output`` Linear and no ``(1 + eps)`` factor: the
    JAX layer's reference-parity quirk, copied.
    """

    deferred_op = "sum"

    def __init__(self, in_dim: InDim, out_dim: int, eps: float = 0.0,
                 use_bias: bool = False):
        super().__init__()
        self.in_dim = _pair(in_dim)
        self.out_dim = out_dim
        self.eps = eps
        self.hetero = self.in_dim[0] != self.in_dim[1]
        if self.hetero:
            self.trans_x = make_linear(self.in_dim[0], out_dim, use_bias)
            self.trans_nbrs = make_linear(self.in_dim[1], out_dim, use_bias)
            self.output = make_linear(out_dim, out_dim, use_bias)
        else:
            self.output = make_linear(self.in_dim[0], out_dim, use_bias)

    def forward(self, x: torch.Tensor, neighbor: Optional[torch.Tensor],
                expand: int,
                neighbor_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        if neighbor_agg is not None:
            agg = neighbor_agg
        else:
            agg = neighbor.reshape(-1, expand, self.in_dim[1]).sum(dim=1)
        if self.hetero:
            return self.output(self.trans_x((1.0 + self.eps) * x)
                               + self.trans_nbrs(agg))
        return self.output(x + agg)


class EgoRGCNConv(nn.Module):
    """Multi-relation conv; ``neighbor`` is a list of R per-relation tensors.

    Each relation's neighbours are reduced over the fanout (mean | sum |
    max), stacked to [R, b, I] and multiplied by their relation's weight in
    one batched product over R; the results are summed over relations, then
    the ``root_weight`` Linear of ``x`` (no bias) and the optional ``bias``
    are added.  Weights have the JAX layer's shapes: bases ``weight`` [B,
    I, O] with ``coefficient`` [R, B]; blocks ``weight`` [R, nb, I/nb,
    O/nb]; otherwise ``weight`` [R, I, O].
    """

    def __init__(self, in_dim: InDim, out_dim: int, num_relations: int,
                 num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None, agg_type: str = "mean",
                 use_bias: bool = False):
        super().__init__()
        if agg_type not in ("mean", "sum", "max"):
            raise ValueError("unknown agg_type %r" % agg_type)
        self.in_dim = _pair(in_dim)
        self.out_dim = out_dim
        self.num_relations = num_relations
        self.num_bases = num_bases
        self.num_blocks = num_blocks
        self.agg_type = agg_type
        R, I, O = num_relations, self.in_dim[1], out_dim
        self.coefficient = None
        if num_bases is not None:
            self.weight = nn.Parameter(torch.empty(num_bases, I, O))
            self.coefficient = nn.Parameter(torch.empty(R, num_bases))
        elif num_blocks is not None:
            if I % num_blocks or O % num_blocks:
                raise ValueError("num_blocks %d does not divide %d and %d"
                                 % (num_blocks, I, O))
            self.weight = nn.Parameter(torch.empty(
                R, num_blocks, I // num_blocks, O // num_blocks))
        else:
            self.weight = nn.Parameter(torch.empty(R, I, O))
        self.root_weight = make_linear(self.in_dim[0], O, False)
        self.bias = nn.Parameter(torch.zeros(O)) if use_bias else None

    @property
    def deferred_op(self) -> str:
        """The per-relation reduction that pre-aggregated
        ``neighbors_agg`` entries must contain."""
        return self.agg_type

    def reset_parameters(self, generator: torch.Generator):
        """LeCun-normal ``weight`` and ``coefficient`` (:func:`init_lecun`'s
        fan-in), ``root_weight`` as :func:`init_linear`, zero bias."""
        init_lecun(self.weight, generator)
        if self.coefficient is not None:
            init_lecun(self.coefficient, generator)
        init_linear(self.root_weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _agg(self, t: torch.Tensor, expand: int) -> torch.Tensor:
        t = t.reshape(-1, expand, self.in_dim[1])
        if self.agg_type == "mean":
            return t.mean(dim=1)
        if self.agg_type == "sum":
            return t.sum(dim=1)
        return t.amax(dim=1)

    def forward(self, x: torch.Tensor,
                neighbors: Optional[Sequence[torch.Tensor]], expand: int,
                neighbors_agg: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        R, O = self.num_relations, self.out_dim
        if neighbors_agg is not None:
            # per-relation neighbours already reduced (the deferred deepest
            # level, as EgoSAGEConv's neighbor_agg)
            assert len(neighbors_agg) == R
            h = torch.stack(list(neighbors_agg))  # [R, b, I]
        else:
            assert len(neighbors) == R
            h = torch.stack([self._agg(n, expand) for n in neighbors])
        if self.num_bases is not None:
            w = torch.einsum("rb,bio->rio", self.coefficient, self.weight)
            out = torch.bmm(h, w)
        elif self.num_blocks is not None:
            nb = self.num_blocks
            hb = h.reshape(R, -1, nb, self.in_dim[1] // nb)
            out = torch.einsum("rbni,rnio->rbno", hb,
                               self.weight).reshape(R, -1, O)
        else:
            out = torch.bmm(h, self.weight)
        out = out.sum(dim=0) + self.root_weight(x)
        if self.bias is not None:
            out = out + self.bias
        return out


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
