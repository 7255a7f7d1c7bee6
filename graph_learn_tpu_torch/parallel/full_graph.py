"""Full-graph distributed GCN training over the partitioned graph.

Counterpart of ``graph_learn_tpu/parallel/full_graph.py``: every layer is
the halo exchange and local SpMM of ``parallel/halo.py``, then a dense
update; the whole graph trains full-batch, each rank holding its rows.

The JAX step differentiates one global loss over the stacked [P, rows]
logits.  Here each rank computes its rows' logits; they are all-gathered
over the graph group (the backward hands each rank its own rows'
gradient), the loss of the whole graph is the same on every rank, and the
parameters' gradients, each rank's share of the whole, are summed over the
group before the optimizer's step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from graph_learn_tpu_torch.core.sharding import (GRAPH_AXIS, all_gather,
                                                 axis, axis_size, bind_mesh)
from graph_learn_tpu_torch.parallel.halo import sharded_spmm
from graph_learn_tpu_torch.parallel.partition import ShardedGraph
from graph_learn_tpu_torch.parallel.train import sum_grads
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


class ShardedGCN(torch.nn.Module):
    """GCN stack whose aggregation is the distributed SpMM: each layer
    takes the mean over in-neighbours, concatenates it to the node's own
    row and applies a dense layer (ReLU between layers)."""

    def __init__(self, dims: Sequence[int], sg: ShardedGraph, mesh,
                 in_dim: int, act: Callable = torch.relu,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dims, self.sg, self.mesh, self.act = list(dims), sg, mesh, act
        widths = [in_dim] + list(dims)
        self.dense = torch.nn.ModuleList(
            torch.nn.Linear(2 * widths[i], widths[i + 1], device=dev)
            for i in range(len(dims)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [rows, D]: this rank's rows -> their outputs."""
        h = x
        with bind_mesh(self.mesh):
            for i, layer in enumerate(self.dense):
                agg = sharded_spmm(self.sg, h, agg="mean")
                h = layer(torch.cat([h, agg], dim=-1))
                if i < len(self.dense) - 1:
                    h = self.act(h)
        return h


class _GatherRows(torch.autograd.Function):
    """All-gather of each rank's rows over the graph group; the backward
    keeps this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.index, ctx.rows = axis(axis_name).index, x.shape[0]
        return all_gather(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        i = ctx.index
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def gather_rows_over_graph(x: torch.Tensor, mesh) -> torch.Tensor:
    """[rows, ...] on each rank -> [P, rows, ...] on every rank."""
    with bind_mesh(mesh):
        p = axis_size(GRAPH_AXIS)
        return _GatherRows.apply(x, GRAPH_AXIS).reshape(
            (p,) + tuple(x.shape))


def make_full_graph_train_step(model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer, mesh,
                               loss_fn: Callable):
    """``step(x, labels, mask) -> loss``: ``x`` [rows, D] is this rank's
    rows; ``labels`` and ``mask`` [P, rows] cover the whole graph (they
    are small and replicated) and ``loss_fn(logits [P, rows, C], labels,
    mask)`` is the JAX step's."""
    def step(x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
        logits = gather_rows_over_graph(model(x), mesh)
        loss = loss_fn(logits, labels, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_grads(model, mesh, GRAPH_AXIS)
        optimizer.step()
        return loss.detach()

    return step
