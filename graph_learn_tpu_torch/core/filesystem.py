"""Pluggable source filesystems: scheme-registered fetchers.

A copy of ``graph_learn_tpu/core/filesystem.py`` (the port imports nothing
of the JAX package): ``register_filesystem:154`` maps a scheme to
``fetch(url) -> local_path``, ``resolve_path:159`` turns a source path or
URL into a local file before ingest parses it (``file://`` and bare paths
are local), ``http_fetch:53`` downloads ``http(s)://`` sources into a
cache and revalidates them (ETag / Last-Modified), and ``hdfs_fetch:117``
copies an ``hdfs://`` file through a libhdfs loaded at run time, raising
``NotFoundError`` where there is none.  The cache directory is
``$GLT_FS_CACHE``, else ``glt_fs_cache`` under the temporary directory.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable, Dict, Optional

from graph_learn_tpu_torch.errors import NotFoundError

_SCHEMES: Dict[str, Callable[[str], str]] = {}


def _cache_dir() -> str:
    d = os.environ.get("GLT_FS_CACHE") or os.path.join(
        tempfile.gettempdir(), "glt_fs_cache")
    os.makedirs(d, exist_ok=True)
    return d


def _cache_path(url: str) -> str:
    h = hashlib.sha256(url.encode()).hexdigest()[:24]
    base = os.path.basename(url.split("?", 1)[0]) or "data"
    return os.path.join(_cache_dir(), h + "-" + base)


def http_fetch(url: str) -> str:
    """Fetch ``http(s)://`` source to the local cache; revalidates with
    If-None-Match / If-Modified-Since so unchanged files are not re-pulled."""
    from urllib import error as _uerr
    from urllib import request as _urlreq

    local = _cache_path(url)
    meta = local + ".meta"
    headers = {}
    if os.path.exists(local) and os.path.exists(meta):
        try:
            with open(meta) as f:
                for ln in f:
                    k, _, v = ln.rstrip("\n").partition("\t")
                    if k == "etag" and v:
                        headers["If-None-Match"] = v
                    elif k == "last-modified" and v:
                        headers["If-Modified-Since"] = v
        except OSError:
            pass
    req = _urlreq.Request(url, headers=headers)
    try:
        with _urlreq.urlopen(req, timeout=60) as r:
            tmp = local + ".part"
            with open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(tmp, local)
            with open(meta, "w") as f:
                f.write("etag\t%s\n" % (r.headers.get("ETag") or ""))
                f.write("last-modified\t%s\n"
                        % (r.headers.get("Last-Modified") or ""))
    except _uerr.HTTPError as e:
        if e.code == 304 and os.path.exists(local):
            return local  # cache still valid
        raise NotFoundError("fetch %r failed: HTTP %d" % (url, e.code))
    except _uerr.URLError as e:
        if os.path.exists(local):
            return local  # offline but cached
        raise NotFoundError("fetch %r failed: %s" % (url, e.reason))
    return local


_LIBHDFS_NAMES = ("libhdfs.so", "libhdfs.so.0.0.0", "libhdfs3.so")
_libhdfs_checked: Optional[bool] = None


def _load_libhdfs():
    """dlopen libhdfs like the reference (hadoop_file_system.cc:69-86)."""
    import ctypes
    for name in _LIBHDFS_NAMES:
        for root in (os.environ.get("HADOOP_HDFS_HOME"), None):
            path = (os.path.join(root, "lib", "native", name)
                    if root else name)
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    return None


def hdfs_fetch(url: str) -> str:
    """Copy an ``hdfs://`` file to the local cache via dlopen'd libhdfs."""
    lib = _load_libhdfs()
    if lib is None:
        raise NotFoundError(
            "hdfs source %r: no libhdfs found (tried %s; set "
            "HADOOP_HDFS_HOME) — matching the reference's runtime-dlopen "
            "behavior (hadoop_file_system.cc:69-86)" % (url, _LIBHDFS_NAMES))
    import ctypes
    rest = url.split("://", 1)[1]
    host, _, path = rest.partition("/")
    host, _, port = host.partition(":")
    lib.hdfsConnect.restype = ctypes.c_void_p
    fs = lib.hdfsConnect(host.encode() or b"default",
                         ctypes.c_uint16(int(port or 0)))
    if not fs:
        raise NotFoundError("hdfs connect failed for %r" % url)
    local = _cache_path(url)
    lib.hdfsOpenFile.restype = ctypes.c_void_p
    f = lib.hdfsOpenFile(ctypes.c_void_p(fs), ("/" + path).encode(),
                         os.O_RDONLY, 0, 0, 0)
    if not f:
        raise NotFoundError("hdfs open failed for %r" % url)
    try:
        with open(local, "wb") as out:
            buf = ctypes.create_string_buffer(1 << 20)
            while True:
                n = lib.hdfsRead(ctypes.c_void_p(fs), ctypes.c_void_p(f),
                                 buf, len(buf))
                if n <= 0:
                    break
                out.write(buf.raw[:n])
    finally:
        lib.hdfsCloseFile(ctypes.c_void_p(fs), ctypes.c_void_p(f))
    return local


def register_filesystem(scheme: str, fetch: Callable[[str], str]) -> None:
    """Register ``fetch(url) -> local_path`` for ``scheme://`` sources."""
    _SCHEMES[scheme] = fetch


def resolve_path(path: str) -> str:
    """Map a source path/URL to a local file path."""
    if "://" not in path:
        return path
    scheme, rest = path.split("://", 1)
    if scheme == "file":
        return "/" + rest.lstrip("/") if not rest.startswith("/") else rest
    if scheme in _SCHEMES:
        return _SCHEMES[scheme](path)
    raise NotFoundError(
        "no filesystem registered for scheme %r (register_filesystem)"
        % scheme)


register_filesystem("http", http_fetch)
register_filesystem("https", http_fetch)
register_filesystem("hdfs", hdfs_fetch)
