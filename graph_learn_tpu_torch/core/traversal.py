"""Host-side seed traversal: by_order / shuffle / random epoch generators.

A copy of ``graph_learn_tpu/core/traversal.py`` ``Traverser:29-75`` (pure
numpy; the port imports nothing of the JAX package), so that the same seed
gives the same batches as the JAX package's, bit for bit:

- ``by_order``: sequential over the set; a partial final batch is returned,
  the following pull raises OutOfRangeError and resets for the next epoch.
- ``shuffle``: same epoch semantics over a fresh permutation per epoch.
- ``random``: uniform with replacement, never OutOfRange.

A partial final batch is padded circularly to the static batch size and
returned together with its true count; ``LocalTrainer.evaluate`` and model
code mask on it.  Seed generation stays on the host (numpy): it is cheap
next to device sampling, and epoch ends depend on the data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from graph_learn_tpu_torch.errors import InvalidArgumentError, OutOfRangeError


class Traverser:
    """Yields (indices[int32 batch], true_count) batches over [0, size)."""

    def __init__(self, size: int, batch_size: int, strategy: str = "by_order",
                 seed: int = 0):
        if size <= 0:
            raise InvalidArgumentError("empty traversal set")
        if batch_size <= 0:
            raise InvalidArgumentError("batch_size must be positive")
        self.size = size
        self.batch_size = batch_size
        self.strategy = strategy
        self.epoch = 0
        self._rng = np.random.default_rng(seed)
        self._cursor = 0
        self._perm: Optional[np.ndarray] = None
        if strategy not in ("by_order", "shuffle", "random"):
            raise InvalidArgumentError("unknown traversal strategy %r" % strategy)
        if strategy == "shuffle":
            self._perm = self._rng.permutation(size).astype(np.int64)

    def next(self) -> Tuple[np.ndarray, int]:
        b = self.batch_size
        if self.strategy == "random":
            idx = self._rng.integers(0, self.size, size=b, dtype=np.int64)
            return idx, b
        if self._cursor >= self.size:
            # epoch exhausted: reset and signal (node_getter.cc:120-131)
            self._cursor = 0
            self.epoch += 1
            if self.strategy == "shuffle":
                self._perm = self._rng.permutation(self.size).astype(np.int64)
            raise OutOfRangeError("No more nodes exist.")
        end = min(self._cursor + b, self.size)
        sel = np.arange(self._cursor, end, dtype=np.int64)
        self._cursor = end
        if self.strategy == "shuffle":
            sel = self._perm[sel]
        count = sel.size
        if count < b:
            # circular pad to the static batch size
            pad = sel[np.arange(b - count) % count]
            sel = np.concatenate([sel, pad])
        return sel, count

    def reset(self):
        self._cursor = 0
