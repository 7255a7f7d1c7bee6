"""Error types of the PyTorch port.

Same hierarchy as ``graph_learn_tpu/errors.py`` (kept as a copy: the port
imports nothing of the JAX package), plus :class:`DeviceUnavailableError`
for entry points asked to run on a card that is not there.
"""

from __future__ import annotations


class GLError(Exception):
    """Base error for the framework."""


class OutOfRangeError(GLError):
    """Raised by traversal datasets at the end of an epoch."""


class InvalidArgumentError(GLError, ValueError):
    pass


class NotFoundError(GLError, KeyError):
    pass


class AlreadyExistsError(GLError):
    pass


class UnimplementedError(GLError, NotImplementedError):
    pass


class DeviceUnavailableError(GLError, RuntimeError):
    """The requested device (by default the CUDA card) is not present.

    Entry points never fall back to the CPU on their own: a caller that
    wants the CPU passes ``device="cpu"``."""
