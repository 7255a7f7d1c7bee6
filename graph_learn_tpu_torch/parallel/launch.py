"""Start ranks on one host: :func:`spawn`, or :func:`start` / :func:`join`
/ :func:`stop` for a caller that is a rank itself.

The port's own launcher (the JAX package starts its processes by hand,
``tests/test_multiprocess.py``).  ``spawn(fn, world_size, ...)`` runs
``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
(``torch.multiprocessing``, start method "spawn"), each a rank of one
process group that meets through a ``FileStore`` in a temporary directory
(no TCP port, so concurrent callers never collide).  Each rank's device
and backend come from ``parallel/bootstrap.py`` (``cuda:<rank %
device_count>`` unless ``device="cpu"``; ranks that share a card need
``backend="gloo"``).

Every wait has a deadline: ``init_process_group`` gets ``timeout_s``, and
the caller joins the ranks until ``timeout_s`` after the start.  A rank
that raises fails the call with its traceback; a rank still running at
the deadline fails it too, after every rank is ended.  ``fn`` must be
importable by the children (a module-level function of an importable
module) and its return value picklable (``torch.save``; tensors come back
on the CPU).

A partitioned serving worker (``online/serve_main.py``) is rank 0 itself:
it :func:`start` s ranks 1..P-1 in daemon processes, :func:`join` s their
group, and :func:`stop` s them when it stops.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from graph_learn_tpu_torch.parallel import bootstrap


class RankFailed(RuntimeError):
    """A spawned rank raised, died or outlived the deadline."""


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def join(rank: int, world_size: int, where: str, device: str = "cuda",
         backend: Optional[str] = None, timeout_s: float = 60.0):
    """Start this process's rank of the group whose ``FileStore`` lies in
    ``where`` (the directory :func:`start` returns)."""
    import torch.distributed as dist

    dev = bootstrap.rank_device(rank, device)
    be = bootstrap.choose_backend(dev, world_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        be, init_method="file://" + os.path.join(where, "store"),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if be == "nccl" else None)
    bootstrap._DEVICE["device"] = dev


def _child(rank: int, where: str, world_size: int, device: str,
           backend: Optional[str], fn: Callable, args: tuple,
           timeout_s: float, threads: Optional[int]):
    out_path = os.path.join(where, "rank%d.pt" % rank)
    try:
        if threads:
            torch.set_num_threads(threads)
        join(rank, world_size, where, device, backend, timeout_s)
        try:
            result = fn(rank, world_size, *args)
        finally:
            bootstrap.shutdown()
        torch.save({"ok": _to_cpu(result)}, out_path + ".tmp")
        os.replace(out_path + ".tmp", out_path)
    except BaseException:
        with open(os.path.join(where, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def start(target: Callable, ranks: Sequence[int], args: Sequence = ()):
    """Start ``target(rank, where, *args)`` for each of ``ranks`` in a
    daemon process of its own (start method "spawn"); returns (a new
    temporary directory ``where`` for the group's ``FileStore``, the
    processes)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    where = tempfile.mkdtemp(prefix="glt_spawn_")
    procs = []
    try:
        for r in ranks:
            p = ctx.Process(target=target, daemon=True,
                            args=(r, where) + tuple(args))
            p.start()
            procs.append(p)
    except BaseException:
        stop(procs, where)
        raise
    return where, procs


def stop(procs, where: Optional[str], grace_s: float = 5.0) -> List[str]:
    """End the processes (terminated after ``grace_s``, killed after as
    long again) and remove the group's directory; returns the tracebacks
    the ranks left."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(max(grace_s, 5.0))
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    if where is not None:
        for name in sorted(os.listdir(where)):
            if name.endswith(".err"):
                with open(os.path.join(where, name)) as f:
                    errors.append(f.read())
        shutil.rmtree(where, ignore_errors=True)
    return errors


def spawn(fn: Callable, world_size: int, device: str = "cuda",
          backend: Optional[str] = None, args: Sequence = (),
          timeout_s: float = 60.0, threads: Optional[int] = None) -> List:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks of one
    host; returns each rank's return value, in rank order.  ``threads``
    caps each rank's intra-op threads (CPU ranks)."""
    dev = bootstrap.rank_device(0, device)  # raises without a card
    bootstrap.choose_backend(dev, world_size, backend)  # the refusal
    where, procs = start(_child, range(world_size), (
        world_size, str(device), backend, fn, tuple(args), timeout_s,
        threads))
    try:
        deadline = time.monotonic() + timeout_s
        failed = None
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if not p.is_alive() and p.exitcode != 0]
            if bad or time.monotonic() > deadline:
                failed = bad
                break
            time.sleep(0.05)
        stop(procs, None, grace_s=0.0)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(where, "rank%d.err" % r)
            if os.path.exists(err):
                with open(err) as f:
                    errors.append("rank %d:\n%s" % (r, f.read()))
            elif p.exitcode != 0 and failed is None:
                errors.append("rank %d exited with code %s"
                              % (r, p.exitcode))
        if failed is not None and not failed and not errors:
            errors.append("ranks still running %.0f s after the start"
                          % timeout_s)
        if errors or failed is not None:
            raise RankFailed("spawn(%s, %d ranks on %s): %s"
                             % (getattr(fn, "__name__", fn), world_size,
                                device, "\n".join(errors)
                                or "ranks %s failed" % failed))
        out = []
        for r in range(world_size):
            res = torch.load(os.path.join(where, "rank%d.pt" % r),
                             weights_only=False)
            out.append(res["ok"])
        return out
    finally:
        shutil.rmtree(where, ignore_errors=True)
