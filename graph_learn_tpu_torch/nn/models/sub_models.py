"""SubGraph model stacks over ``edge_index`` and the link predictor.

Counterpart of ``graph_learn_tpu/nn/models/sub_models.py``
``SubGraphStack:18``, ``GraphSAGE:38``, ``GCN:47``, ``GAT:54`` and
``LinkPredictor:64``.  Flax adopts a stack's convs as ``convs_<i>``,
not under the ``sage_<i>`` / ``gcn_<i>`` / ``gat_<i>`` names that
``GraphSAGE`` / ``GCN`` / ``GAT`` give them (those hold where a stack is
made in another module's ``setup``), and the predictor's layers are
``mlp_<i>`` and ``out``; the torch modules carry the same names, which
``nn/convert.py`` maps.

``dims[0]`` is the input width: a torch ``Linear`` needs it where flax
infers it (the JAX SEAL example passes ``GCN([hidden, hidden])`` and its
first conv still reads the 68- or 132-wide labelled features).  Weights
are drawn from ``generator`` (default: seeded with 0) on the CPU, then
moved to ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from graph_learn_tpu_torch.nn.layers.ego import make_linear
from graph_learn_tpu_torch.nn.layers.sub import (GATConv, GCNConv, SAGEConv,
                                                 init_sub)
from graph_learn_tpu_torch.nn.models.ego_gnn import _dropout
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


def _place(module: nn.Module, generator: Optional[torch.Generator],
           device: DeviceLike) -> nn.Module:
    """Redraw ``module``'s weights from ``generator``, in module order,
    then move it to ``device``."""
    return init_sub(module, generator).to(resolve_device(device))


class SubGraphStack(nn.Module):
    """Convs over (edge_index, x); ``act`` and dropout between layers.
    Dropout draws from the ``generator`` passed to ``forward`` when
    ``training``.  As in the JAX stack, ``training`` does not reach the
    convs, so a GAT conv's attention dropout never acts inside a stack."""

    def __init__(self, convs: Sequence[nn.Module],
                 act: Callable = torch.relu, dropout: float = 0.0,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.act, self.dropout = act, dropout
        _place(self, generator, device)

    def forward(self, edge_index, x, edge_mask=None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        h = x
        for i, conv in enumerate(self.convs):
            h = conv(edge_index, h, edge_mask=edge_mask)
            if i < len(self.convs) - 1:
                h = _dropout(self.act(h), self.dropout, training, generator)
        return h


def GraphSAGE(dims: Sequence[int], agg_type: str = "mean",
              act: Callable = torch.relu, dropout: float = 0.0,
              normalize: bool = False, **kw) -> SubGraphStack:
    """SAGE convs ``dims[i] -> dims[i + 1]``."""
    convs = [SAGEConv(dims[i], dims[i + 1], agg_type=agg_type,
                      normalize=normalize) for i in range(len(dims) - 1)]
    return SubGraphStack(convs, act=act, dropout=dropout, **kw)


def GCN(dims: Sequence[int], act: Callable = torch.relu,
        dropout: float = 0.0, **kw) -> SubGraphStack:
    """GCN convs ``dims[i] -> dims[i + 1]``."""
    convs = [GCNConv(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    return SubGraphStack(convs, act=act, dropout=dropout, **kw)


def GAT(dims: Sequence[int], num_heads: int = 1, attn_dropout: float = 0.0,
        act: Callable = torch.relu, dropout: float = 0.0,
        **kw) -> SubGraphStack:
    """GAT convs ``dims[i] -> dims[i + 1]`` (heads averaged)."""
    convs = [GATConv(dims[i], dims[i + 1], num_heads=num_heads,
                     attn_dropout=attn_dropout)
             for i in range(len(dims) - 1)]
    return SubGraphStack(convs, act=act, dropout=dropout, **kw)


class LinkPredictor(nn.Module):
    """MLP edge scorer (reference link_predictor.py): ``src * dst``, then
    ``num_layers - 1`` ReLU layers ``mlp_<i>`` of ``hidden_dim`` and
    ``out`` -> [b] logits.  ``in_dim`` (default ``hidden_dim``) is the
    embeddings' width."""

    def __init__(self, hidden_dim: int, num_layers: int = 2,
                 dropout: float = 0.0, in_dim: Optional[int] = None,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        width = hidden_dim if in_dim is None else in_dim
        for i in range(num_layers - 1):
            setattr(self, "mlp_%d" % i, make_linear(width, hidden_dim, True))
            width = hidden_dim
        self.out = make_linear(width, 1, True)
        _place(self, generator, device)

    def forward(self, src_emb, dst_emb, training: bool = False,
                generator: Optional[torch.Generator] = None):
        h = src_emb * dst_emb
        for i in range(self.num_layers - 1):
            h = torch.relu(getattr(self, "mlp_%d" % i)(h))
            h = _dropout(h, self.dropout, training, generator)
        return self.out(h)[..., 0]
