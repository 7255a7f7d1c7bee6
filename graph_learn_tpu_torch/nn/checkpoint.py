"""Checkpoint and resume of a training state.

Counterpart of ``graph_learn_tpu/nn/checkpoint.py``'s ``Checkpointer``
(``save(step, state, force)``, ``latest_step()``, ``restore(template,
step)``, the newest ``max_to_keep`` steps kept), built on ``torch.save`` /
``torch.load(weights_only=True)`` instead of orbax.  A state is a dict of
tensors, numbers, strings and their dicts and lists, for example
``{"model": model.state_dict(), "optimizer": opt.state_dict(), "step": n,
"extra": ...}``.  Each step is one file, ``step_<n>.pt``, written under a
temporary name and renamed into place, so a crash leaves either the whole
step or none of it.  The graph store is not part of a state: it is rebuilt
from its sources or restored from a snapshot (``Graph.load``).

Orbax is not a dependency of the port, and it does not read orbax
directories: a state the JAX package saved is carried over by restoring it
there and loading the params with ``nn/convert.load_flax_params``.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    """Saves and restores training states in ``directory``, one file a
    step; tensors are restored onto ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 device: DeviceLike = "cuda"):
        if max_to_keep is not None and max_to_keep < 1:
            raise InvalidArgumentError("max_to_keep must be at least 1 or "
                                       "None, got %r" % (max_to_keep,))
        self.device = resolve_device(device)
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, "step_%d.pt" % step)

    def all_steps(self) -> List[int]:
        """The saved steps, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` as ``step``; returns whether it was written.  A
        step not newer than the latest one is skipped unless ``force``
        (then it replaces that step's file), as orbax's manager skips it.
        Steps beyond the newest ``max_to_keep`` are deleted."""
        step = int(step)
        latest = self.latest_step()
        if not force and latest is not None and step <= latest:
            return False
        tmp = self._path(step) + ".tmp.%d" % os.getpid()
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def restore(self, template: Any = None,
                step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default: the latest), its tensors
        on the checkpointer's device, or None when there is no step.  A
        ``template`` dict (for example the state a fresh model and
        optimizer give) names the keys the state must have."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        if not os.path.exists(self._path(step)):
            raise InvalidArgumentError("no checkpoint of step %d in %r"
                                       % (step, self.directory))
        state = torch.load(self._path(step), map_location=self.device,
                           weights_only=True)
        if isinstance(template, dict):
            missing = set(template) - set(state)
            if missing:
                raise InvalidArgumentError(
                    "checkpoint of step %d lacks %s" % (step, sorted(missing)))
        return state
