"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``graph_learn_tpu_torch/_build/`` (listed in ``.gitignore``).  A library's
file name carries a hash of its source, of every header ``csrc/*.cuh`` and
of the flags, so an edited source or header is rebuilt and an unchanged one
is reused.  :func:`build` starts one ``nvcc``
per missing library, all at once.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` never reaches :func:`build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

from graph_learn_tpu_torch.errors import DeviceUnavailableError

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("gather", "spmm", "gat", "sweep", "csr")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_counters: List["LaunchCounter"] = []


class LaunchCounter:
    """Number of kernel launches made by one wrapper (thread-safe)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()
        _counters.append(self)

    def add(self):
        with self._lock:
            self.count += 1

    def reset(self):
        with self._lock:
            self.count = 0


def launch_counts() -> Dict[str, int]:
    """{wrapper name: launches} of every counter made so far."""
    return {c.name: c.count for c in _counters}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), DEFAULT_NVCC]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise DeviceUnavailableError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin); the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / (name + ".cu")).read_bytes())
    # any source may include any header: an edited header rebuilds them all
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:12]))


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named library that is missing, all ``nvcc`` runs in
    parallel.  Returns the compiler's output (``-Xptxas -v`` register and
    spill report) per library built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            out = library_path(n)
            tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / (n + ".cu"))]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        logs = {}
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for csrc/%s.cu:\n%s" % (n, log))
            os.replace(tmp, out)
            logs[n] = log
        return logs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
