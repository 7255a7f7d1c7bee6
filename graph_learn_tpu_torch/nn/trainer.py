"""Trainers: the training-loop surface of the framework.

Counterpart of ``graph_learn_tpu/nn/trainer.py`` ``LocalTrainer:31-225`` on
one device.  The JAX package fuses sampling, the forward, the backward and
the optimizer update into one jitted step; here one step is a plain eager
sequence on the card:

    seeds from the Traverser (node-set indices of a ``V()`` query, edge ids
    of an ``E()`` query) -> ``_execute`` (GSL plan)
    -> ``batch_transform`` under ``torch.no_grad()``
    -> ``loss_fn`` -> ``backward()`` -> ``optimizer.step()``

``batch_transform`` is the place for work that needs no gradient, such as
:func:`graph_learn_tpu_torch.nn.data.pre_aggregate_hop` (Kernel 2 reduces
the deepest hop outside the differentiated part).  Losses stay on the
device and are pulled once per epoch.

``tier="host"`` (default ``conf.storage_device``) keeps the graph in host
RAM, following the JAX package's ``_train_host:129-175`` and
``evaluate:177-225``: a host-tier :class:`~graph_learn_tpu_torch.gsl.
dataset.Dataset` samples (and runs ``batch_transform``) on the CPU and
ships each batch to the trainer's device, and the step there is the same
loss / backward / optimizer sequence as the device tier's, its dropout
drawn from a generator on that device.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.errors import OutOfRangeError
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.gsl.dataset import Dataset, check_tier
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device


class LocalTrainer:
    """Single-process trainer on one device (the card unless
    ``device="cpu"``).

    ``loss_fn(model, batch, generator, training)`` -> scalar loss, where
    ``batch`` is the {alias: value} dict the query plan produces and
    ``generator`` the trainer's ``torch.Generator`` (sampling and dropout
    draw from it in turn).  ``model`` is any ``nn.Module``: a two-tower
    model is, for example, an ``nn.ModuleDict`` of the towers whose
    ``loss_fn`` calls both.
    """

    def __init__(self, seed: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self.seed = conf.seed if seed is None else seed
        self.device = resolve_device(device)

    def _seed_stream(self, query: Query):
        size, _ = query.source_space()
        trav = Traverser(size, query.dag.batch_size,
                         strategy=query.source.strategy, seed=self.seed)
        idx = query.seed_indices()
        # an E() source's positions are its edge ids
        return trav, (lambda pos: pos) if idx is None else idx.__getitem__

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _batch(self, query, tables, seeds, generator, batch_transform):
        with torch.no_grad():
            batch = _execute(query, tables,
                             torch.as_tensor(seeds, dtype=torch.int32,
                                             device=self.device), generator)
            if batch_transform is not None:
                batch = batch_transform(batch, tables)
        return batch

    def train(self, query: Query, model: torch.nn.Module, loss_fn: Callable,
              optimizer: torch.optim.Optimizer, epochs: int = 1,
              steps_per_epoch: Optional[int] = None, log_every: int = 50,
              verbose: bool = True,
              batch_transform: Optional[Callable] = None,
              tier: Optional[str] = None
              ) -> Tuple[torch.nn.Module, List[float]]:
        """Train ``model`` in place; returns (model, mean loss per epoch).

        ``batch_transform(batch, tables) -> batch`` (optional) runs after
        the plan, outside the gradient.  ``log_every`` steps a verbose run
        prints the step count and rate (no loss: that would wait for the
        device)."""
        host = check_tier(tier) == "host"
        generator = self._generator(self.seed)
        if query.source.strategy == "random" and steps_per_epoch is None:
            raise ValueError("a 'random' (shuffle()) source never exhausts an "
                             "epoch; pass steps_per_epoch")
        if host:
            ds = Dataset(query, seed=self.seed, transform=batch_transform,
                         tier="host", device=self.device)
            next_batch = lambda: ds.next_with_count()[0]  # noqa: E731
        else:
            tables = query.device_tables(self.device)
            trav, seeds_of = self._seed_stream(query)

            def next_batch():
                pos, _ = trav.next()
                return self._batch(query, tables, seeds_of(pos), generator,
                                   batch_transform)
        try:
            return model, self._loop(model, loss_fn, optimizer, next_batch,
                                     generator, epochs, steps_per_epoch,
                                     log_every, verbose,
                                     ", host tier" if host else "")
        finally:
            if host:
                ds.close()

    def _loop(self, model, loss_fn, optimizer, next_batch, generator,
              epochs, steps_per_epoch, log_every, verbose, what):
        """The epochs: ``next_batch()`` until OutOfRangeError or
        ``steps_per_epoch``; returns the mean loss of each epoch."""
        history = []
        it = 0
        t0 = time.time()
        for epoch in range(epochs):
            losses = []
            while steps_per_epoch is None or len(losses) < steps_per_epoch:
                try:
                    batch = next_batch()
                except OutOfRangeError:
                    break
                loss = loss_fn(model, batch, generator, True)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                losses.append(loss.detach())
                it += 1
                if verbose and log_every and it % log_every == 0:
                    print("step %d (%.1f steps/s queued)"
                          % (it, it / max(time.time() - t0, 1e-9)))
            # one pull per epoch: the steps above queue without waiting
            mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
            history.append(mean_loss)
            if verbose:
                dt = time.time() - t0
                print("epoch %d loss %.4f (%.1f steps/s%s)"
                      % (epoch, mean_loss, it / max(dt, 1e-9), what))
        return history

    def evaluate(self, query: Query, model: torch.nn.Module,
                 metric_fn: Callable,
                 batch_transform: Optional[Callable] = None,
                 tier: Optional[str] = None) -> float:
        """Mean of ``metric_fn(model, batch)`` -> per-row values [b] over one
        epoch of ``query``.

        A padded final batch only counts its first n_valid rows (the
        Traverser pads circularly, so the tail rows are duplicates)."""
        host = check_tier(tier) == "host"
        if query.source.strategy == "random":
            raise ValueError("a 'random' (shuffle()) source never exhausts an "
                             "epoch; evaluate over a by_order or "
                             "shuffle(traverse=True) source")
        if host:
            ds = Dataset(query, seed=self.seed + 1,
                         transform=batch_transform, tier="host",
                         device=self.device)
            next_batch = ds.next_with_count
        else:
            tables = query.device_tables(self.device)
            generator = self._generator(self.seed + 1)
            trav, seeds_of = self._seed_stream(query)

            def next_batch():
                pos, n_valid = trav.next()
                return self._batch(query, tables, seeds_of(pos), generator,
                                   batch_transform), n_valid
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = 0
        try:
            with torch.no_grad():
                while True:
                    try:
                        batch, n_valid = next_batch()
                    except OutOfRangeError:
                        break
                    vals = metric_fn(model, batch)
                    total += vals[:n_valid].double().sum()
                    count += n_valid
        finally:
            if host:
                ds.close()
        return float(total) / max(count, 1)
