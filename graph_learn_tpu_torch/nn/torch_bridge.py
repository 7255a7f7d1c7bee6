"""PyTorch data bridge: a GSL query as a torch ``IterableDataset``.

Counterpart of ``graph_learn_tpu/nn/torch_bridge.py:1-135``
(``value_to_torch``, ``TorchDataset``, ``Collater``, ``torch_loader``),
made native: the port's values are already tensors, so
``value_to_torch`` returns them field by field, as the JAX bridge does,
on the device they were sampled on (a deferred feature gather is made
there: Kernel 1 on the card).  ``induce_func`` keeps the reference's
contract: it takes the {alias: value} batch and returns what the torch
model consumes.  A partial last batch of an epoch is cut to its true rows
(``:105-111``).  ``tier="host"`` keeps the graph in host RAM and the
batches on the CPU (``:84-88``): a torch consumer that wants CPU tensors
gets them without a trip through the card.

A ``DataLoader`` with ``num_workers > 0`` runs the whole query in every
worker, as the JAX bridge does (an ``IterableDataset`` is not split by
the loader), so each batch comes once per worker; and its workers fork
after the parent has initialised CUDA, which CUDA does not support.  Use
``num_workers=0``: the dataset already samples ahead in its own window.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.data import IterableDataset

from graph_learn_tpu_torch.core.values import DeferredRows, map_result
from graph_learn_tpu_torch.errors import OutOfRangeError
from graph_learn_tpu_torch.gsl.dataset import Dataset, check_tier
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

FIELDS = ("ids", "raw_ids", "degrees", "weights", "labels", "timestamps",
          "int_attrs", "float_attrs", "edge_ids")
SUBVALUES = ("src_nodes", "dst_nodes", "nodes")


def value_to_torch(v) -> dict:
    """A Nodes / Edges / SparseNodes / SubGraphVal value as {field:
    tensor} (the JAX bridge's field names), nested values as nested
    dicts; deferred feature rows are gathered."""
    out = {}
    for f in FIELDS:
        a = getattr(v, f, None)
        if isinstance(a, DeferredRows):
            a = a.materialize()
        if a is not None:
            out[f] = a
    for sub in SUBVALUES:
        n = getattr(v, sub, None)
        if n is not None:
            out[sub] = value_to_torch(n)
    ei = getattr(v, "edge_index", None)
    if ei is not None:
        out["edge_index"] = ei
    return out


def _trim(count: int):
    return lambda x: x[:count] if x.dim() >= 1 else x


class TorchDataset(IterableDataset):
    """Iterates ``epochs`` epochs of ``query``: {alias: {field: tensor}}
    per batch, or what ``induce_func(batch)`` returns.  Batches are
    sampled on ``device`` (the card unless ``device="cpu"``), or with
    ``tier="host"`` from host RAM onto the CPU."""

    def __init__(self, query, window: int = 10,
                 induce_func: Optional[Callable] = None, epochs: int = 1,
                 tier: Optional[str] = None, device: DeviceLike = "cuda"):
        self._query = query
        self._window = window
        self._induce = induce_func
        self._epochs = epochs
        self._tier = check_tier(tier)
        self._device = (torch.device("cpu") if self._tier == "host"
                        else resolve_device(device))

    def __iter__(self):
        for _ in range(self._epochs):
            ds = Dataset(self._query, window=self._window, tier=self._tier,
                         device=self._device)
            try:
                while True:
                    try:
                        batch, count = ds.next_with_count()
                    except OutOfRangeError:
                        break
                    if count < ds.batch_size:
                        # the padded rows of the last batch are repeats
                        batch = map_result(_trim(count), batch)
                    if self._induce is not None:
                        yield self._induce(batch)
                    else:
                        yield {a: value_to_torch(v)
                               for a, v in batch.items()}
            finally:
                ds.close()


class Collater:
    """The collate function of a batch-of-one loader: GSL batches are
    already batched, so ``DataLoader(batch_size=1)`` unwraps them."""

    def __call__(self, batch):
        if len(batch) != 1:
            raise ValueError("Collater takes batches of one, got %d"
                             % len(batch))
        return batch[0]


def torch_loader(query, window: int = 10,
                 induce_func: Optional[Callable] = None,
                 tier: Optional[str] = None, device: DeviceLike = "cuda",
                 **kwargs) -> torch.utils.data.DataLoader:
    """A torch ``DataLoader`` over ``query`` (the reference's
    PyGDataLoader); ``batch_size`` and ``collate_fn`` are the bridge's."""
    ds = TorchDataset(query, window=window, induce_func=induce_func,
                      tier=tier, device=device)
    kwargs.pop("batch_size", None)
    kwargs.pop("collate_fn", None)
    return torch.utils.data.DataLoader(ds, batch_size=1,
                                       collate_fn=Collater(), **kwargs)
