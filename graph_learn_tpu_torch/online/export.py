"""Serving-model export: the fused sample+forward function as one
``torch.export`` program.

Counterpart of ``graph_learn_tpu/online/export.py:25-58``.  The JAX
package serialises ``jax.jit(fn)`` as a StableHLO artifact; here ``fn``
is traced by ``torch.export`` and written with ``torch.export.save``.  A
serving process loads the program and calls it with raw seed ids: no
model code and no graph store are needed at load time, because the
tables the function closes over are constants of the program.

The function is ``fn(seeds, generator)``, as the port's plan runs
(``gsl/compile.py _execute``), and is traced with ``generator=None``: its
draws come from the default generator of the seeds' device.  The loaded
program is called as ``call(seeds: int32[batch], seed)``, the JAX
artifact's signature with an int seed for the key: ``call`` seeds the
default generators under ``torch.random.fork_rng`` and runs the program,
so one seed gives one answer and the process's own random state is left
as it was.  The seeds are traced on the device the program serves from,
so on the card the feature gathers and the deepest-hop reduction stay the
``glt::gather_rows`` / ``glt::segment_spmm`` operators (Kernels 1-2) and
the program launches the kernels when it runs.  A function that reaches
Kernels 3-5 is refused while it is traced (``ops/kernels/build.py
refuse_export``).
"""

from __future__ import annotations

import io
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

# the default generators are the process's: two programs running at once
# would draw from each other's seeds
_RNG_LOCK = threading.Lock()
# torch.export.save writes a zip archive
_ZIP_MAGIC = b"PK\x03\x04"


class _Program(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, seeds):
        return self.fn(seeds, None)


def export_serving_fn(fn: Callable, example_args, path: Optional[str] = None,
                      device: DeviceLike = "cuda") -> bytes:
    """Trace ``fn(seeds, generator)`` at the shape of ``example_args[0]``
    (the seeds; a second entry, the seed, is not traced) on ``device``,
    and serialise it.  Returns the program's bytes; also writes them to
    ``path`` when given."""
    dev = resolve_device(device)
    seeds = torch.as_tensor(np.asarray(example_args[0]), dtype=torch.int32,
                            device=dev)
    with torch.no_grad():
        program = torch.export.export(_Program(fn), (seeds,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class Exported:
    """A loaded serving program: ``call(seeds, seed)``, the traced seeds'
    shape and device (``example_seeds``, a meta-like fake), and the
    ``torch.export`` program itself."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()
        first = next(n for n in program.graph.nodes
                     if n.op == "placeholder"
                     and n.name in _user_inputs(program))
        self.example_seeds = first.meta["val"]
        self.device = self.example_seeds.device

    def call(self, seeds, seed: int = 0):
        seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int32,
                                device=self.device)
        devices = [self.device] if self.device.type == "cuda" else []
        with _RNG_LOCK, torch.random.fork_rng(devices=devices), \
                torch.no_grad():
            torch.manual_seed(int(seed))
            return self._module(seeds)


def _user_inputs(program):
    return set(program.graph_signature.user_inputs)


def load_serving_fn(path_or_bytes) -> Callable:
    """Load an exported serving program; returns ``call(seeds, seed)``."""
    return load_serving_exported(path_or_bytes).call


def load_serving_exported(path_or_bytes) -> Exported:
    """Load to the full :class:`Exported` (the serving tier reads the
    traced batch size from it).  Bytes that are not a ``torch.export``
    program, a JAX StableHLO artifact among them, are refused."""
    blob = path_or_bytes
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    blob = bytes(blob)
    if not blob.startswith(_ZIP_MAGIC):
        raise InvalidArgumentError(
            "not a torch.export serving program (no zip archive: a JAX "
            "StableHLO artifact is not one); export it with "
            "graph_learn_tpu_torch.online.export.export_serving_fn")
    try:
        program = torch.export.load(io.BytesIO(blob))
    except Exception as e:  # any unreadable blob is the caller's error
        raise InvalidArgumentError(
            "not a torch.export serving program (%s: %s); export it with "
            "graph_learn_tpu_torch.online.export.export_serving_fn"
            % (type(e).__name__, e)) from e
    if not _user_inputs(program):
        raise InvalidArgumentError("the exported program takes no seeds")
    return Exported(program)
