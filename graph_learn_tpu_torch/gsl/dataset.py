"""Dataset: epoch iterator over a GSL query.

Counterpart of ``graph_learn_tpu/gsl/dataset.py`` ``Dataset:46-170``:
``next()`` returns {alias: value} per batch and raises OutOfRangeError at
the end of an epoch; an EOF marker queued in order keeps epoch ends where
they belong while batches are produced ahead.  A ``V()`` query walks its
node set; an ``E()`` query walks the edge ids of its edge type.

The JAX package's lookahead rests on async dispatch of the jitted plan.
Here the plan of each queued batch (and its ``transform``) runs on a side
CUDA stream, under ``torch.no_grad()``, with one event recorded per batch.
``next()`` makes the caller's current stream wait on that event and records
the batch's tensors on it, so that the caching allocator does not hand
their memory back to the side stream while the caller's kernels may still
read it.  On the CPU the window only queues finished batches.

Only the device tier is ported: ``tier="host"`` (tables in host RAM,
batches shipped to the card) raises.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Callable, Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.core.values import map_result
from graph_learn_tpu_torch.errors import InvalidArgumentError, OutOfRangeError
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_EOF = object()


def check_tier(tier: Optional[str]) -> str:
    """The storage tier to use; only "device" is ported."""
    tier = conf.storage_device if tier is None else tier
    if tier == "host":
        raise InvalidArgumentError(
            "tier='host' (tables in host RAM) is not yet ported; use "
            "tier='device'")
    if tier != "device":
        raise InvalidArgumentError(
            "tier must be 'device' or 'host', got %r" % (tier,))
    return tier


class Dataset:
    def __init__(self, query: Query, window: Optional[int] = None,
                 seed: Optional[int] = None, drop_last: bool = False,
                 tier: Optional[str] = None, device: DeviceLike = "cuda",
                 transform: Optional[Callable] = None):
        """``window`` batches are queued ahead (default
        ``conf.dataset_capacity``).  ``transform(batch, tables) -> batch``
        runs with the plan, outside any gradient: the place for
        :func:`graph_learn_tpu_torch.nn.data.pre_aggregate_hop`."""
        self.tier = check_tier(tier)
        self.query = query
        self.window = window if window is not None else conf.dataset_capacity
        self.drop_last = drop_last
        self.transform = transform
        self.device = resolve_device(device)
        seed = conf.seed if seed is None else seed
        size, _ = query.source_space()
        self._trav = Traverser(size, query.dag.batch_size,
                               strategy=query.source.strategy, seed=seed)
        self._seed_indices = query.seed_indices()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._tables = query.device_tables(self.device)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            # the tables were written on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._pending = deque()

    @property
    def epoch(self) -> int:
        return self._trav.epoch

    @property
    def batch_size(self) -> int:
        return self._trav.batch_size

    def _dispatch(self):
        positions, count = self._trav.next()
        if self.drop_last and count < self._trav.batch_size:
            raise OutOfRangeError("No more nodes exist.")
        seeds = (positions if self._seed_indices is None
                 else self._seed_indices[positions])
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            out = _execute(self.query, self._tables,
                           torch.as_tensor(seeds, dtype=torch.int32,
                                           device=self.device),
                           self._generator)
            if self.transform is not None:
                out = self.transform(out, self._tables)
            event = (self._stream.record_event()
                     if self._stream is not None else None)
        return out, count, event

    def _refill(self):
        while len(self._pending) < self.window:
            try:
                self._pending.append(self._dispatch())
            except OutOfRangeError:
                self._pending.append(_EOF)
                return

    def next_with_count(self):
        """({alias: value}, true_count); raises OutOfRangeError at the end
        of an epoch."""
        if not self._pending:
            self._refill()
        item = self._pending.popleft()
        if item is _EOF:
            raise OutOfRangeError("No more nodes exist.")
        self._refill()
        out, count, event = item
        if event is not None:
            caller = torch.cuda.current_stream(self.device)
            caller.wait_event(event)
            map_result(lambda x: x.record_stream(caller), out)
        return out, count

    def next(self):
        """One batch {alias: Nodes}; a ``values(func)`` post-processor set
        on the query is applied here."""
        out = self.next_with_count()[0]
        if self.query.post_func is not None:
            return self.query.post_func(out)
        return out

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self.next()
        except OutOfRangeError:
            raise StopIteration
