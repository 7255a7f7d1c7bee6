"""ctypes wrapper over the native TSV loader (``csrc/ingest.cpp``).

The port's counterpart of ``graph_learn_tpu/csrc/native_ingest.py``
(``_attr_spec:70``, ``load_table:93``): the repository's unchanged
``csrc/ingest.cpp`` is compiled with ``g++`` and the JAX wrapper's flags
(``:42``) into ``graph_learn_tpu_torch/_build/`` under a name that carries
a hash of the source and the flags, as ``ops/kernels/build.py`` names the
CUDA libraries, so the port never shares the JAX wrapper's
``csrc/build/``.  The build runs at the first load, never at import, and
writes a temporary file that is renamed into place, so processes that
build at once do not see each other's half-written library.

Where the library cannot be built (no compiler), :func:`load_table`
returns None and ``core/ingest.py`` parses with the Python parser, as the
JAX package does, but says so once with a ``RuntimeWarning``;
:func:`available` tells a caller which route a load will take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "csrc" / "ingest.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None  # why the library could not be built
_warned = False

# attribute kinds: AttrKind in csrc/ingest.cpp
K_FLOAT, K_INT_NUMERIC, K_INT_ID, K_STRING_HASH, K_MULTIVAL = range(5)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / ("libglt_ingest-%s.so" % digest.hexdigest()[:12])


def _build() -> ctypes.CDLL:
    """Compile the library if it is missing, then load it."""
    out = library_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise OSError("g++ not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise OSError("g++ failed for csrc/ingest.cpp:\n" + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.glt_count_rows.restype = ctypes.c_int64
    lib.glt_count_rows.argtypes = [ctypes.c_char_p]
    lib.glt_parse_table.restype = ctypes.c_int32
    return lib


def library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built (the reason is kept for :func:`available`)."""
    global _lib, _failed
    with _lock:
        if _lib is None and _failed is None:
            try:
                _lib = _build()
            except (OSError, subprocess.SubprocessError) as e:
                _failed = str(e)
        return _lib


def available() -> bool:
    """Whether file ingest takes the native route."""
    return library() is not None


def warn_python_route():
    """Say once that tables are parsed by the Python parser."""
    global _warned
    if not _warned:
        _warned = True
        warnings.warn("native TSV loader unavailable (%s); parsing tables "
                      "with the Python parser" % _failed, RuntimeWarning,
                      stacklevel=3)


def _attr_spec(decoder: Decoder):
    """(kinds [n_attrs] int32, buckets [n_attrs] int64, 0 = none) for the
    loader."""
    kinds, buckets = [], []
    for a in decoder.attrs:
        if a.is_multival:
            kinds.append(K_MULTIVAL)
            buckets.append(a.bucket_size or 0)
        elif a.is_numeric:
            kinds.append(K_FLOAT if a.type_name == "float" else K_INT_NUMERIC)
            buckets.append(0)
        else:
            kinds.append(K_INT_ID if a.type_name == "int" else K_STRING_HASH)
            buckets.append(a.bucket_size or 0)
    return np.asarray(kinds, np.int32), np.asarray(buckets, np.int64)


def _ptr(a: Optional[np.ndarray], ctype):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctype))


def load_table(path: str, n_id_cols: int,
               decoder: Decoder) -> Optional[Dict[str, Optional[np.ndarray]]]:
    """The columns of a node (``n_id_cols`` 1) or edge (2) table, as
    ``core/ingest.py load_*_table`` returns them; None without the
    library."""
    lib = library()
    if lib is None:
        return None
    n = lib.glt_count_rows(path.encode())
    if n < 0:
        raise InvalidArgumentError("cannot read table %r" % path)
    nf, ni = decoder.float_attr_num, decoder.int_attr_num
    nm, L = decoder.multival_attr_num, decoder.multival_max_len

    def col(on, shape, dtype, fill=None):
        if not on:
            return None
        return (np.empty(shape, dtype) if fill is None
                else np.full(shape, fill, dtype))

    ids0 = np.empty(n, np.int64)
    ids1 = col(n_id_cols == 2, n, np.int64)
    weights = col(decoder.weighted, n, np.float32)
    labels = col(decoder.labeled, n, np.int32)
    ts = col(decoder.timestamped, n, np.int64)
    fa = col(nf, (n, nf), np.float32)
    ia = col(ni, (n, ni), np.int32)
    mv = col(nm, (n, nm, L), np.int32, 0)  # slots past a list's end stay 0
    ml = col(nm, (n, nm), np.int32)
    kinds, buckets = _attr_spec(decoder)
    rc = lib.glt_parse_table(
        path.encode(),
        ctypes.c_int32(n_id_cols), ctypes.c_int32(int(decoder.weighted)),
        ctypes.c_int32(int(decoder.labeled)),
        ctypes.c_int32(int(decoder.timestamped)),
        ctypes.c_int32(len(decoder.attrs)),
        _ptr(kinds, ctypes.c_int32), _ptr(buckets, ctypes.c_int64),
        ctypes.c_int32(L),
        ctypes.c_char(conf.field_delimiter.encode()),
        ctypes.c_char(decoder.attr_delimiter.encode()),
        ctypes.c_int64(n),
        _ptr(ids0, ctypes.c_int64), _ptr(ids1, ctypes.c_int64),
        _ptr(weights, ctypes.c_float), _ptr(labels, ctypes.c_int32),
        _ptr(ts, ctypes.c_int64), _ptr(fa, ctypes.c_float),
        _ptr(ia, ctypes.c_int32), _ptr(mv, ctypes.c_int32),
        _ptr(ml, ctypes.c_int32),
        ctypes.c_int32(nf), ctypes.c_int32(ni), ctypes.c_int32(nm),
        ctypes.c_int32(os.cpu_count() or 1))
    if rc != 0:
        raise InvalidArgumentError(
            "native parse failed (%d) for %r: the records do not match the "
            "decoder (field or attribute count)" % (rc, path))
    out: Dict[str, Optional[np.ndarray]] = {
        "weights": weights, "labels": labels, "timestamps": ts,
        "int_attrs": ia, "float_attrs": fa,
        "multival_attrs": mv, "multival_lens": ml}
    if n_id_cols == 2:
        out["src_ids"], out["dst_ids"] = ids0, ids1
    else:
        out["ids"] = ids0
    return out
