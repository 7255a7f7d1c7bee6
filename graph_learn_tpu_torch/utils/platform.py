"""Device selection for the port's entry points.

Every entry point (graph device views, ``QueryService``, the models) takes
a ``device`` argument that defaults to ``"cuda"``.  The CPU is used only
when a caller asks for it, as the tests do; a missing card is an error.
"""

from __future__ import annotations

from typing import Union

import torch

from graph_learn_tpu_torch.errors import DeviceUnavailableError

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it is a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "device %r requested but no CUDA card is available; pass "
                "device='cpu' to run on the CPU" % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """"float32" / "bfloat16" config strings -> torch dtypes."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
