"""Multi-process bootstrap: ``torch.distributed`` in place of the
reference's coordinator and naming service.

Counterpart of ``graph_learn_tpu/parallel/bootstrap.py``, where one
``jax.distributed.initialize`` wires every process into one mesh.  Here
:func:`init_cluster` starts the default process group with the same
environment fallbacks (``GLT_COORDINATOR``, ``GLT_NUM_PROCS``,
``GLT_PROC_ID``, ``:18-37``) and picks each rank's device explicitly:
``cuda:<local rank % device_count>``, or the CPU when ``device="cpu"``
is asked for.

The backend follows the device: ``gloo`` on the CPU, ``nccl`` on the card
when every rank has a card of its own.  NCCL refuses two ranks of one
communicator on one device ("Duplicate GPU detected"), so where ranks
would share a card the caller must ask for ``backend="gloo"`` (which
carries CUDA tensors); without it :func:`init_cluster` raises rather than
change the backend on its own.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

# the device init_cluster (or parallel/launch.py spawn) gave this process
_DEVICE = {"device": None}


def rank_device(process_id: int, device: DeviceLike = "cuda",
                local_rank: Optional[int] = None) -> torch.device:
    """The device of a rank: ``cuda:<local rank % device_count>`` for
    ``device="cuda"`` (raises without a card), else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    resolve_device("cuda")  # raises DeviceUnavailableError without a card
    lr = process_id if local_rank is None else local_rank
    return torch.device("cuda", lr % torch.cuda.device_count())


def choose_backend(dev: torch.device, local_world_size: int,
                   backend: Optional[str] = None) -> str:
    """``gloo`` for the CPU, ``nccl`` for ranks with a card each; ranks
    that share a card need ``backend="gloo"`` asked for."""
    if dev.type != "cuda":
        if backend not in (None, "gloo"):
            raise InvalidArgumentError(
                "backend %r cannot carry CPU tensors; use gloo" % backend)
        return "gloo"
    shared = local_world_size > torch.cuda.device_count()
    if shared and backend != "gloo":
        raise InvalidArgumentError(
            "%d ranks on %d card(s) would share a card, which NCCL refuses "
            "(duplicate GPU); pass backend='gloo' to run them over gloo"
            % (local_world_size, torch.cuda.device_count()))
    return backend or "nccl"


def current_device() -> Optional[torch.device]:
    """The device this process's rank was given (None before
    :func:`init_cluster`)."""
    return _DEVICE["device"]


def init_cluster(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 backend: Optional[str] = None,
                 device: DeviceLike = "cuda",
                 timeout_s: float = 60.0) -> bool:
    """Start this process's rank (no-op, False, without a coordinator).

    ``coordinator_address`` is ``host:port`` (a TCP store on the rank 0
    host) or any ``init_method`` URL (``file://...``).  The local world
    size is ``LOCAL_WORLD_SIZE``, else ``num_processes`` (one host)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "GLT_COORDINATOR")
    if coordinator_address is None:
        return False  # single process
    num_processes = int(num_processes
                        or os.environ.get("GLT_NUM_PROCS", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("GLT_PROC_ID", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_ws = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dev = rank_device(process_id, device, local_rank)
    backend = choose_backend(dev, local_ws, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = (coordinator_address if "://" in coordinator_address
           else "tcp://" + coordinator_address)
    dist.init_process_group(
        backend, init_method=url, rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    _DEVICE["device"] = dev
    return True


def barrier(name: str = "sync"):
    """Cluster-wide barrier (reference ``Coordinator::Sync``); ``name``
    labels it for the reader only."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def shutdown():
    """Leave the process group (a no-op when none was started)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE["device"] = None
