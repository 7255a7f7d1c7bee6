"""Attribute strings -> the three column arrays of a node or edge table.

A copy of the attribute part of ``graph_learn_tpu/core/ingest.py``
(``hash64:37``, ``hash64_array:51``, ``_parse_attrs:83``): FNV-1a 64-bit
hashing of string attributes into embedding ids, and the parse of
``attr_delimiter``-joined attribute strings into int (embedding id),
float and multi-value columns, for ``NodeTable`` / ``EdgeTable``.
``hash64_array`` is vectorised in numpy (uint64 arithmetic wraps as the
hash's does) and bit for bit equal to the JAX package's per-string loop;
``_parse_attrs`` hashes a multi-value column's items in one such call.
Reading tables from files waits for the port of file ingest.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)
# strings hashed together in one padded block of hash64_array
_HASH_BLOCK = 1 << 16
# the modulus of a string column without a bucket (JAX: (1 << 31) - 1)
_NO_BUCKET = (1 << 31) - 1


def hash64(s: str) -> int:
    """FNV-1a 64-bit hash of the UTF-8 bytes of ``s``."""
    h = int(_FNV_OFFSET)
    for b in s.encode("utf-8"):
        h = ((h ^ b) * int(_FNV_PRIME)) % (1 << 64)
    return h


def hash64_array(strs: Sequence[str]) -> np.ndarray:
    """:func:`hash64` of every string -> [n] uint64.

    The strings' bytes are laid out in blocks of ``_HASH_BLOCK`` strings
    of similar length (sorted by length), each padded to its longest, and
    hashed one byte position at a time over the whole block."""
    n = len(strs)
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    encoded = [s.encode("utf-8") for s in strs]
    lens = np.fromiter((len(b) for b in encoded), dtype=np.int64, count=n)
    buf = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    order = np.argsort(lens, kind="stable")
    for lo in range(0, n, _HASH_BLOCK):
        rows = order[lo:lo + _HASH_BLOCK]
        h = np.full(rows.size, _FNV_OFFSET, dtype=np.uint64)
        width = int(lens[rows].max())
        for j in range(width):
            live = lens[rows] > j
            pos = np.minimum(starts[rows] + j, max(buf.size - 1, 0))
            byte = buf[pos].astype(np.uint64) if buf.size else 0
            h = np.where(live, (h ^ byte) * _FNV_PRIME, h)
        out[rows] = h
    return out


def _parse_attrs(attr_col: List[str], decoder: Decoder):
    """attr-string column -> (int_attrs [n, ni] int32, float_attrs [n, nf]
    f32, multival [n, nm, L] int32, mv_lens [n, nm] int32), each None when
    the decoder has no such column."""
    n = len(attr_col)
    delim = decoder.attr_delimiter
    n_attr = len(decoder.attrs)
    grid: List[List[str]] = []
    for s in attr_col:
        parts = s.split(delim)
        if len(parts) != n_attr:
            raise InvalidArgumentError(
                "attribute count %d != decoder %d in %r"
                % (len(parts), n_attr, s))
        grid.append(parts)

    int_cols, float_cols = [], []
    mv_cols, mv_len_cols = [], []
    for a in decoder.attrs:
        vals = [g[a.index] for g in grid]
        if a.is_multival:
            L = decoder.multival_max_len
            bucket = np.uint64(a.bucket_size or _NO_BUCKET)
            items = [[x for x in v.split(",") if x][:L] if v else []
                     for v in vals]
            lens = np.fromiter((len(it) for it in items), dtype=np.int32,
                               count=n)
            ids = np.zeros((n, L), dtype=np.int32)
            flat = [x for it in items for x in it]
            if flat:
                rows = np.repeat(np.arange(n), lens)
                first = np.repeat(np.cumsum(lens) - lens, lens)
                slots = np.arange(len(flat)) - first
                ids[rows, slots] = (hash64_array(flat) % bucket).astype(
                    np.int32)
            mv_cols.append(ids)
            mv_len_cols.append(lens)
        elif a.is_numeric:
            try:
                col = np.asarray(vals, dtype=np.float32)
            except ValueError as e:
                raise InvalidArgumentError(
                    "attribute %d expects numeric: %s" % (a.index, e))
            float_cols.append(col)
        else:
            if a.type_name == "int":
                col = np.asarray(vals, dtype=np.int64)
                if a.bucket_size:
                    col = col % a.bucket_size
            else:
                bucket = a.bucket_size or _NO_BUCKET
                col = (hash64_array(vals) % np.uint64(bucket)).astype(
                    np.int64)
            int_cols.append(col.astype(np.int32))

    int_attrs = np.stack(int_cols, axis=1) if int_cols else None
    float_attrs = np.stack(float_cols, axis=1) if float_cols else None
    multival = np.stack(mv_cols, axis=1) if mv_cols else None
    mv_lens = np.stack(mv_len_cols, axis=1) if mv_len_cols else None
    return int_attrs, float_attrs, multival, mv_lens
