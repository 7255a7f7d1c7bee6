"""Sharded training: the partitioned plan, the data-parallel step and
``DistTrainer``.

Counterpart of ``graph_learn_tpu/parallel/train.py`` (the reference's
PS/worker ``DistTrainer``, ``examples/tf/trainer.py:327-371``, made
synchronous).  The JAX package runs each step as one SPMD program; here
every rank of the mesh runs the same eager step on its part:

- seeds: every rank reads the same global batch of ``b`` seeds and takes
  its data slice, ``b / n_data`` seeds at its "data" index;
- the graph: replicated tables (every rank runs the single-device plan;
  on the card its feature rows stay deferred, gathered by Kernel 1 and
  reduced by Kernel 2), or the range-partitioned store
  (``parallel/sharded_store.py``) under :func:`make_partitioned_plan`,
  whose ids are psum-stitched over the "graph" group and whose payload
  rows follow ``conf.partition_routing`` ("owner": two ``all_to_all`` s
  and an all-gather of the stripes, so every graph rank ends with its data
  slice's whole batch, as the JAX plan's reassembly; "psum": the masked
  psum);
- the parameters: replicated; after the backward the gradients are
  ``all_reduce`` d over the "data" group and divided by ``n_data`` before
  ``optimizer.step()`` (XLA inserts that psum in the JAX step).  The
  graph ranks of one data slice compute the same gradients from the same
  batch, so their parameters stay equal.

Every rank seeds its ``torch.Generator`` alike, so the graph ranks of a
data slice draw the same numbers: the partitioned plan at mesh (1, P)
equals the single-device plan bit for bit.  Under data parallelism each
data slice draws the numbers the single-device plan would draw for a
batch of its size (as each JAX shard draws from the same key at its block
shape), so a data-parallel step equals the single-device step on the
deterministic strategies (``topk``, ``full``) and differs in the random
draws otherwise.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, List, Optional, Tuple

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.sharding import (DATA_AXIS, GRAPH_AXIS,
                                                 Striped, all_gather,
                                                 axis_index, axis_size,
                                                 bind_mesh, mesh_axis,
                                                 owner_routing, psum)
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.core.values import SubGraphVal, TensorStruct
from graph_learn_tpu_torch.errors import InvalidArgumentError, OutOfRangeError
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.parallel import bootstrap
from graph_learn_tpu_torch.utils.platform import resolve_device


def _assemble(v):
    """``v`` with every :class:`Striped` leaf all-gathered over its axis
    (in field order, the same on every rank)."""
    if isinstance(v, Striped):
        return v.assemble()
    if isinstance(v, TensorStruct):
        import dataclasses
        changes = {}
        for f in dataclasses.fields(v):
            x = getattr(v, f.name)
            if isinstance(x, TensorStruct):
                changes[f.name] = _assemble(x)
        return v.replace(**changes) if changes else v
    return v


def _stack_over_data(sg: SubGraphVal) -> SubGraphVal:
    """Every leaf of a data slice's ``SubGraphVal`` gathered over the
    "data" group: [n_data, ...], each slice one data shard's induction
    (``:56-79``)."""
    return sg.map(lambda x: all_gather(x[None].contiguous(), DATA_AXIS))


def data_slice(seeds: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a global seed batch (inside a bound mesh)."""
    n = axis_size(DATA_AXIS)
    b = seeds.shape[0] // n
    d = axis_index(DATA_AXIS)
    return seeds[d * b:(d + 1) * b]


def make_partitioned_plan(query: Query, mesh, stables,
                          routing: Optional[str] = None) -> Callable:
    """The GSL plan over a graph-sharded store: ``plan(seeds, generator)
    -> {alias: value}`` for this rank's data slice of the global ``seeds``
    [b].  ``stables`` is a placed ``ShardedTables`` (this rank's block).
    A ``SubGraph`` result under data parallelism comes back stacked
    [n_data, ...] over the data shards."""
    routing = routing or conf.partition_routing
    if routing not in ("owner", "psum"):
        raise InvalidArgumentError("partition_routing must be 'owner' or "
                                   "'psum', got %r" % routing)
    if stables.placed is None:
        raise InvalidArgumentError("make_partitioned_plan needs placed "
                                   "tables (ShardedTables.place)")
    graph = mesh_axis(mesh, GRAPH_AXIS)
    if graph.size != stables.num_shards:
        raise InvalidArgumentError(
            "the mesh's graph axis has %d ranks, the store %d shards"
            % (graph.size, stables.num_shards))
    n_data = mesh_axis(mesh, DATA_AXIS).size
    stack_sg = n_data > 1 and any(n.kind == "subgraph"
                                  for n in query.dag.nodes)
    tables = stables.view()

    def plan(seeds: torch.Tensor, generator: torch.Generator):
        with bind_mesh(mesh):
            local = data_slice(seeds.to(torch.int32))
            route = (owner_routing(stables.axis, stables.num_shards)
                     if routing == "owner" else contextlib.nullcontext())
            with route:
                out = _execute(query, tables, local, generator)
            out = {a: _assemble(v) for a, v in out.items()}
            if stack_sg:
                out = {a: _stack_over_data(v) if isinstance(v, SubGraphVal)
                       else v for a, v in out.items()}
        return out

    plan.tables = tables
    return plan


def sum_grads(model: torch.nn.Module, mesh, axis_name: str,
              divide_by: int = 1) -> None:
    """Sum the gradients over the group of ``axis_name`` in one flat
    buffer and divide by ``divide_by`` (a parameter without a gradient
    counts as zeros, so every rank sends the same buffer)."""
    if mesh_axis(mesh, axis_name).size == 1:
        return
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    with bind_mesh(mesh):
        flat = psum(flat, axis_name)
    if divide_by != 1:
        flat = flat / divide_by
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def _train_step(model, loss_fn, optimizer, mesh, batch) -> torch.Tensor:
    loss = loss_fn(model, batch[0], batch[1], True)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    # the gradients' mean over the "data" group
    sum_grads(model, mesh, DATA_AXIS, mesh_axis(mesh, DATA_AXIS).size)
    optimizer.step()
    return loss.detach()


def make_partitioned_train_step(query: Query, model: torch.nn.Module,
                                loss_fn: Callable,
                                optimizer: torch.optim.Optimizer, mesh,
                                stables,
                                batch_transform: Optional[Callable] = None
                                ) -> Callable:
    """``step(seeds, generator) -> loss``: the partitioned plan (graph
    axis), then the model step with the gradients averaged over the data
    axis.  No rank holds more than its block of the graph tables.
    ``loss_fn(model, batch, generator, training)``; ``batch_transform(
    batch, tables)`` runs after the plan, outside the gradient."""
    plan = make_partitioned_plan(query, mesh, stables)

    def step(seeds: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            batch = plan(seeds, generator)
            if batch_transform is not None:
                batch = batch_transform(batch, plan.tables)
        return _train_step(model, loss_fn, optimizer, mesh,
                           (batch, generator))

    step.plan = plan
    return step


def make_sharded_train_step(query: Query, model: torch.nn.Module,
                            loss_fn: Callable,
                            optimizer: torch.optim.Optimizer, mesh,
                            batch_transform: Optional[Callable] = None
                            ) -> Callable:
    """``step(tables, seeds, generator) -> loss``: every rank runs the
    single-device plan on its data slice of ``seeds`` over ``tables``
    (``Query.device_tables``, or ``parallel.mesh.shard_tables``), then
    the model step with the gradients averaged over the data axis."""

    def step(tables, seeds: torch.Tensor, generator: torch.Generator):
        with torch.no_grad(), bind_mesh(mesh):
            batch = _execute(query, tables, data_slice(seeds.to(
                torch.int32)), generator)
            if batch_transform is not None:
                batch = batch_transform(batch, tables)
        return _train_step(model, loss_fn, optimizer, mesh,
                           (batch, generator))

    return step


class DistTrainer:
    """Epoch loop over the sharded step (the reference's ``DistTrainer``,
    synchronous: no parameter server, no barrier; the mesh is the
    cluster).

    Storage: when the mesh has a graph axis of more than one rank and the
    query's tables reach ``partition_above_bytes``, each rank builds and
    places only its block of the range-partitioned store
    (``build_sharded_tables(..., shard=g)``) and trains through
    :func:`make_partitioned_train_step`.  Below the threshold, or when the
    partitioned build refuses the query (with a warning), the tables are
    placed by ``parallel.mesh.shard_tables``.  ``train`` takes
    ``LocalTrainer.train``'s arguments; every rank of the mesh calls it."""

    def __init__(self, mesh, seed: int = 0,
                 partition_above_bytes: int = 64 << 20,
                 device: Optional[torch.device] = None):
        self.mesh = mesh
        self.seed = seed
        self.partition_above_bytes = partition_above_bytes
        self.device = resolve_device(device or bootstrap.current_device()
                                     or "cuda")
        self.partitioned = False
        self.stables = None

    def _step(self, query, model, loss_fn, optimizer, tables,
              batch_transform):
        gx = mesh_axis(self.mesh, GRAPH_AXIS)
        if tables is None and gx.size > 1:
            from graph_learn_tpu_torch.parallel.sharded_store import (
                build_sharded_tables, estimate_query_table_bytes)
            if (estimate_query_table_bytes(query)
                    >= self.partition_above_bytes):
                try:
                    self.stables = build_sharded_tables(
                        query, gx.size, shard=gx.index).place(
                            self.mesh, device=self.device)
                    self.partitioned = True
                    step = make_partitioned_train_step(
                        query, model, loss_fn, optimizer, self.mesh,
                        self.stables, batch_transform)
                    return lambda seeds, gen: step(seeds, gen)
                except InvalidArgumentError as e:
                    warnings.warn("DistTrainer: falling back to replicated "
                                  "tables (%s)" % e, stacklevel=3)
        if tables is None:
            from graph_learn_tpu_torch.parallel.mesh import shard_tables
            tables = shard_tables(query.device_tables(self.device),
                                  self.mesh)
        step = make_sharded_train_step(query, model, loss_fn, optimizer,
                                       self.mesh, batch_transform)
        return lambda seeds, gen: step(tables, seeds, gen)

    def train(self, query: Query, model: torch.nn.Module, loss_fn: Callable,
              optimizer: torch.optim.Optimizer, epochs: int = 1,
              steps_per_epoch: Optional[int] = None, log_every: int = 50,
              verbose: bool = True,
              batch_transform: Optional[Callable] = None, tables=None
              ) -> Tuple[torch.nn.Module, List[float]]:
        """Train ``model`` in place on every rank; returns (model, mean
        loss per epoch of this rank's data slice)."""
        import time

        import torch.distributed as dist

        run_step = self._step(query, model, loss_fn, optimizer, tables,
                              batch_transform)
        size, _ = query.source_space()
        trav = Traverser(size, query.dag.batch_size,
                         strategy=query.source.strategy, seed=self.seed)
        idx = query.seed_indices()
        if trav.strategy == "random" and steps_per_epoch is None:
            raise ValueError("a 'random' (shuffle()) source never exhausts "
                             "an epoch; pass steps_per_epoch")
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        talk = verbose and (not dist.is_initialized()
                            or dist.get_rank() == 0)
        history, it, t0 = [], 0, time.time()
        for epoch in range(epochs):
            losses = []
            while steps_per_epoch is None or len(losses) < steps_per_epoch:
                try:
                    pos, _ = trav.next()
                except OutOfRangeError:
                    break
                seeds = torch.as_tensor(pos if idx is None else idx[pos],
                                        dtype=torch.int32,
                                        device=self.device)
                losses.append(run_step(seeds, generator))
                it += 1
                if talk and log_every and it % log_every == 0:
                    print("step %d (%.1f steps/s queued)"
                          % (it, it / max(time.time() - t0, 1e-9)))
            mean = float(torch.stack(losses).mean()) if losses else 0.0
            history.append(mean)
            if talk:
                print("epoch %d loss %.4f" % (epoch, mean))
        return model, history
