"""Dataset: epoch iterator over a GSL query.

Counterpart of ``graph_learn_tpu/gsl/dataset.py`` ``Dataset:46-170``:
``next()`` returns {alias: value} per batch and raises OutOfRangeError at
the end of an epoch; an EOF marker queued in order keeps epoch ends where
they belong while batches are produced ahead.  A ``V()`` query walks its
node set; an ``E()`` query walks the edge ids of its edge type.

Two storage tiers (``tier=``, default ``conf.storage_device``), as in the
JAX package (``:46-110``):

- ``"device"``: the tables live on ``device``.  The JAX package's
  lookahead rests on async dispatch of the jitted plan; here the plan of
  each queued batch (and its ``transform``) runs on a side CUDA stream,
  under ``torch.no_grad()``, with one event recorded per batch.
  ``next()`` makes the caller's current stream wait on that event and
  records the batch's tensors on it, so that the caching allocator does
  not hand their memory back to the side stream while the caller's
  kernels may still read it.  On the CPU the window only queues finished
  batches.
- ``"host"``: the tables stay in host RAM, for a graph larger than the
  card.  They are the store's CPU views (``query.device_tables("cpu")``;
  ``core/store.py`` keys its views by device, so the two tiers never share
  one).  The plan and ``transform`` run on the CPU under
  ``torch.no_grad()`` with a CPU generator, so a ``pre_aggregate_hop``
  there takes Kernel 2's plain version: the caller asked for host RAM,
  and that is the tier, not a fallback.  Only the batch crosses to
  ``device`` (:func:`host_batch`): its deferred rows gathered on the CPU
  straight into pinned memory, its other tensors pinned, then copied with
  ``non_blocking`` on the side stream, with the device tier's event and
  ``record_stream`` handling; each pinned buffer is held until its copy's
  event has completed.  With ``device="cpu"`` nothing is gathered, pinned
  or copied.

Torch's CPU operations run on the calling thread, so on the host tier a
window above 1 is filled by one producer thread: the batches, the epoch
ends and the draws of the one generator come in the order the caller's
thread would give them, so a seed gives the same batches with and without
it, and an OutOfRangeError or an exception of the producer is raised by
``next()``.  A window of 1 is filled on the caller's thread, as the device
tier's is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from collections import deque
from typing import Callable, Optional

import torch

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.traversal import Traverser
from graph_learn_tpu_torch.core.values import (DeferredRows, TensorStruct,
                                               map_result)
from graph_learn_tpu_torch.errors import InvalidArgumentError, OutOfRangeError
from graph_learn_tpu_torch.gsl.compile import Query, _execute
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_EOF = object()
TIERS = ("device", "host")
# seconds a blocked producer or consumer waits before it looks again
# whether the other side has stopped
_POLL_S = 0.1


def check_tier(tier: Optional[str]) -> str:
    """The storage tier to use: ``tier`` or ``conf.storage_device``."""
    tier = conf.storage_device if tier is None else tier
    if tier not in TIERS:
        raise InvalidArgumentError(
            "tier must be 'device' or 'host', got %r" % (tier,))
    return tier


def _tensors(fn):
    """``fn`` on tensors, other values (a transform's own entries) kept."""
    return lambda x: fn(x) if isinstance(x, torch.Tensor) else x


def host_batch(out: dict, pin: bool = True) -> dict:
    """``out`` as the host tier ships it: every deferred row gathered on
    the CPU (``index_select`` of the ids ``feature_gather`` clips, the rows
    Kernel 1 gathers on the card) straight into pinned memory, every other
    tensor pinned, so that one copy moves the batch and no page of it is
    written twice.  ``pin=False`` (a machine without a card) allocates
    plain host memory."""
    def rows(d: DeferredRows) -> torch.Tensor:
        n, width = d.table.shape
        out = torch.empty(tuple(d.idx.shape) + (width,), dtype=d.table.dtype,
                          pin_memory=pin)
        flat = torch.clamp(d.idx.reshape(-1), 0, max(n - 1, 0))
        torch.index_select(d.table, 0, flat, out=out.view(-1, width))
        return out

    def ship(v):
        if isinstance(v, DeferredRows):
            return rows(v)
        if isinstance(v, torch.Tensor):
            return v.pin_memory() if pin else v
        if isinstance(v, TensorStruct):
            return v.replace(**{f.name: ship(getattr(v, f.name))
                                for f in dataclasses.fields(v)})
        return v
    return {a: ship(v) for a, v in out.items()}


class _Failure:
    """An exception of the producer thread, raised again by ``next()``."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Source:
    """Makes the batches: seeds from the Traverser, the plan and the
    transform on the tables' device, and on the host tier the trip to the
    card.  Holds no reference to the Dataset, so a producer thread does
    not keep it alive."""

    def __init__(self, query: Query, tier: str, device: torch.device,
                 seed: int, drop_last: bool, transform: Optional[Callable]):
        self.query = query
        self.device = device  # where batches land
        self.plan_device = torch.device("cpu") if tier == "host" else device
        self.drop_last = drop_last
        self.transform = transform
        size, _ = query.source_space()
        self.trav = Traverser(size, query.dag.batch_size,
                              strategy=query.source.strategy, seed=seed)
        self.seed_indices = query.seed_indices()
        self.generator = torch.Generator(device=self.plan_device)
        self.generator.manual_seed(seed)
        self.tables = query.device_tables(self.plan_device)
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device=device)
            # the device tier's tables were written on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def __call__(self):
        """(batch, true count, event or None, pinned host batch or None)."""
        positions, count = self.trav.next()
        if self.drop_last and count < self.trav.batch_size:
            raise OutOfRangeError("No more nodes exist.")
        seeds = (positions if self.seed_indices is None
                 else self.seed_indices[positions])
        on_card = self.plan_device.type == "cuda"
        ctx = (torch.cuda.stream(self.stream) if on_card
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            out = _execute(self.query, self.tables,
                           torch.as_tensor(seeds, dtype=torch.int32,
                                           device=self.plan_device),
                           self.generator)
            if self.transform is not None:
                out = self.transform(out, self.tables)
            event = self.stream.record_event() if on_card else None
        if self.stream is None or on_card:
            return out, count, event, None
        return self._ship(out, count)

    def _ship(self, out: dict, count: int):
        """The host tier's trip to the card: :func:`host_batch`, then the
        copies on the side stream; the event marks their end, and the
        pinned batch must live until it has completed."""
        pinned = host_batch(out)
        with torch.cuda.stream(self.stream):
            moved = map_result(_tensors(
                lambda x: x.to(self.device, non_blocking=True)), pinned)
            event = self.stream.record_event()
        return moved, count, event, pinned


class _Producer:
    """One thread that fills a queue of at most ``size`` items with
    ``make()``'s results in order: an OutOfRangeError becomes the EOF
    marker, any other exception a :class:`_Failure`, after which the
    thread stops."""

    def __init__(self, make: Callable, size: int):
        self._make = make
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="glt-dataset-producer")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self._make()
            except OutOfRangeError:
                item = _EOF
            except Exception as e:  # noqa: BLE001 - raised again by get()
                item = _Failure(e)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=_POLL_S)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _Failure):
                return

    def get(self):
        while True:
            try:
                return self._queue.get(timeout=_POLL_S)
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("the dataset's producer thread "
                                       "stopped")

    def close(self):
        self._stop.set()
        self._thread.join()


class Dataset:
    def __init__(self, query: Query, window: Optional[int] = None,
                 seed: Optional[int] = None, drop_last: bool = False,
                 tier: Optional[str] = None, device: DeviceLike = "cuda",
                 transform: Optional[Callable] = None):
        """``window`` batches are queued ahead (default
        ``conf.dataset_capacity``).  ``tier`` is "device" (tables on
        ``device``) or "host" (tables in host RAM, batches shipped to
        ``device``); default ``conf.storage_device``.  ``transform(batch,
        tables) -> batch`` runs with the plan, on the tables' device and
        outside any gradient: the place for
        :func:`graph_learn_tpu_torch.nn.data.pre_aggregate_hop`, which on
        the host tier shrinks what crosses to the card by the deepest
        fanout."""
        self.tier = check_tier(tier)
        self.query = query
        self.window = window if window is not None else conf.dataset_capacity
        if self.window < 1:
            raise InvalidArgumentError("window must be at least 1, got %r"
                                       % (self.window,))
        self.drop_last = drop_last
        self.transform = transform
        self.device = resolve_device(device)
        self._source = _Source(query, self.tier, self.device,
                               conf.seed if seed is None else seed,
                               drop_last, transform)
        self._pending = deque()
        self._in_flight = []  # (event, pinned batch) of unfinished copies
        self._failure: Optional[BaseException] = None
        self._producer = (_Producer(self._source, self.window)
                          if self.tier == "host" and self.window > 1
                          else None)

    @property
    def epoch(self) -> int:
        return self._source.trav.epoch

    @property
    def batch_size(self) -> int:
        return self._source.trav.batch_size

    @property
    def _tables(self):
        return self._source.tables

    def _refill(self):
        while len(self._pending) < self.window:
            try:
                self._pending.append(self._source())
            except OutOfRangeError:
                self._pending.append(_EOF)
                return
            except Exception as e:  # noqa: BLE001 - raised in its turn
                self._pending.append(_Failure(e))
                return

    def _take(self):
        """The next item in order; a failure is raised in its turn, and
        again on every later call."""
        if self._failure is not None:
            raise self._failure
        if self._producer is not None:
            item = self._producer.get()
        else:
            if not self._pending:
                self._refill()
            item = self._pending.popleft()
            if item is not _EOF and not isinstance(item, _Failure):
                self._refill()
        if isinstance(item, _Failure):
            self._failure = item.exc
            raise item.exc
        return item

    def next_with_count(self):
        """({alias: value}, true_count); raises OutOfRangeError at the end
        of an epoch."""
        item = self._take()
        if item is _EOF:
            raise OutOfRangeError("No more nodes exist.")
        out, count, event, pinned = item
        if event is not None:
            caller = torch.cuda.current_stream(self.device)
            caller.wait_event(event)
            map_result(_tensors(lambda x: x.record_stream(caller)), out)
        if pinned is not None:
            self._in_flight = [(e, p) for e, p in self._in_flight
                               if not e.query()]
            self._in_flight.append((event, pinned))
        return out, count

    def next(self):
        """One batch {alias: Nodes}; a ``values(func)`` post-processor set
        on the query is applied here."""
        out = self.next_with_count()[0]
        if self.query.post_func is not None:
            return self.query.post_func(out)
        return out

    def close(self):
        """Stop the producer thread, if there is one (also done when the
        dataset is collected)."""
        producer = getattr(self, "_producer", None)
        if producer is not None:
            self._producer = None
            producer.close()

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self.next()
        except OutOfRangeError:
            raise StopIteration
