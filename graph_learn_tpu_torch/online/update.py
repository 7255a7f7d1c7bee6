"""Streaming graph updates: delta buffers, rebuild of the host tables, an
append-only log with replay, and TTL eviction.

Counterpart of ``graph_learn_tpu/online/update.py:31-279``, host numpy
over the port's ``core/store.py`` tables:

- ``UpdateBuffer`` gathers node and edge deltas per type.
- ``apply_updates(graph, buf)`` merges them into the host tables: new
  nodes only (an id already in the table is refused), the edge tables of
  a grown node type rebuilt over the new row space, edge timestamps
  brought back to absolute before they are concatenated, and one
  ``unify_ts_bases`` at the end.  The replaced tables carry no device
  views, so the next ``device()`` call, or ``QueryService.refresh()``,
  uploads the rebuilt CSR.  The rebuild is O(E log E) on the host.
- ``UpdateLog`` appends JSONL records and replays ``[start, upto)``; its
  records are the JAX package's, so a log written by either package
  replays in the other.
- ``expire_edges`` drops edges older than a time (``<type>_reverse`` with
  its type).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from graph_learn_tpu_torch.core.store import (EdgeTable, NodeTable,
                                              unify_ts_bases)
from graph_learn_tpu_torch.errors import InvalidArgumentError, NotFoundError


class UpdateBuffer:
    def __init__(self):
        self.node_updates: Dict[str, List[dict]] = {}
        self.edge_updates: Dict[str, List[dict]] = {}

    def add_nodes(self, node_type: str, ids, weights=None, labels=None,
                  float_attrs=None, int_attrs=None, timestamps=None):
        self.node_updates.setdefault(node_type, []).append(dict(
            ids=np.asarray(ids, np.int64),
            weights=_opt(weights, np.float32),
            labels=_opt(labels, np.int32),
            float_attrs=_opt(float_attrs, np.float32),
            int_attrs=_opt(int_attrs, np.int32),
            timestamps=_opt(timestamps, np.int64)))

    def add_edges(self, edge_type: str, src_ids, dst_ids, weights=None,
                  timestamps=None):
        self.edge_updates.setdefault(edge_type, []).append(dict(
            src_ids=np.asarray(src_ids, np.int64),
            dst_ids=np.asarray(dst_ids, np.int64),
            weights=_opt(weights, np.float32),
            timestamps=_opt(timestamps, np.int64)))

    def clear(self):
        self.node_updates.clear()
        self.edge_updates.clear()

    @property
    def empty(self) -> bool:
        return not self.node_updates and not self.edge_updates


def _opt(a, dtype):
    return None if a is None else np.asarray(a, dtype)


def _concat_opt(a: Optional[np.ndarray], b: Optional[np.ndarray], n_a: int,
                n_b: int, fill=0):
    if a is None and b is None:
        return None
    if a is None:
        a = np.full((n_a,) + b.shape[1:], fill, b.dtype)
    if b is None:
        b = np.full((n_b,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, b])


def apply_updates(graph, buf: UpdateBuffer):
    """Merge the buffer's deltas into the store and clear it; device views
    are rebuilt when next asked for."""
    store = graph.store
    for t, batches in buf.node_updates.items():
        if t not in store.nodes:
            raise NotFoundError("unknown node type %r" % t)
        old = store.nodes[t]
        ids = np.concatenate([old.raw_ids] + [b["ids"] for b in batches])
        if np.unique(ids).size != ids.size:
            raise InvalidArgumentError(
                "node update contains existing ids (attribute overwrite is "
                "not yet supported; new nodes only)")
        store.add_node_table(NodeTable(
            t, old.decoder, ids,
            int_attrs=_cat_field(old, batches, "int_attrs"),
            float_attrs=_cat_field(old, batches, "float_attrs"),
            multival_attrs=old.multival_attrs,
            multival_lens=old.multival_lens,
            weights=_cat_field(old, batches, "weights"),
            labels=_cat_field(old, batches, "labels"),
            timestamps=_cat_field(old, batches, "timestamps")))
        # edge tables over this node type grow their row space; their
        # timestamps go back as the JAX package hands them (+ ts_base)
        for e_t, et in list(store.edges.items()):
            if et.src_type == t or et.dst_type == t:
                store.add_edge_table(EdgeTable(
                    e_t, et.src_type, et.dst_type, et.decoder,
                    src=et.src, dst=et.dst,
                    num_src_nodes=store.node_table(et.src_type).num_nodes,
                    num_dst_nodes=store.node_table(et.dst_type).num_nodes,
                    weights=et.weights, labels=et.labels,
                    timestamps=(et.timestamps + et.ts_base
                                if et.timestamps is not None else None),
                    int_attrs=et.int_attrs, float_attrs=et.float_attrs,
                    multival_attrs=et.multival_attrs,
                    multival_lens=et.multival_lens))

    for t, batches in buf.edge_updates.items():
        if t not in store.edges:
            raise NotFoundError("unknown edge type %r" % t)
        old = store.edges[t]
        src_tab = store.node_table(old.src_type)
        dst_tab = store.node_table(old.dst_type)
        new_src = np.concatenate(
            [old.src] + [src_tab.index.lookup(b["src_ids"]).astype(np.int64)
                         for b in batches])
        new_dst = np.concatenate(
            [old.dst] + [dst_tab.index.lookup(b["dst_ids"]).astype(np.int64)
                         for b in batches])
        store.add_edge_table(EdgeTable(
            t, old.src_type, old.dst_type, old.decoder,
            src=new_src, dst=new_dst,
            num_src_nodes=src_tab.num_nodes,
            num_dst_nodes=dst_tab.num_nodes,
            weights=_cat_edge_field(old, batches, "weights"),
            labels=_cat_edge_field(old, batches, "labels"),
            timestamps=_cat_edge_field(old, batches, "timestamps")))
    unify_ts_bases(store)
    buf.clear()


def _cat_field(old, batches, field):
    out = getattr(old, field)
    n_old = old.num_nodes
    for b in batches:
        nb = b["ids"].size
        out = _concat_opt(out, b.get(field), n_old, nb)
        n_old += nb
    return out


def _cat_edge_field(old, batches, field):
    out = getattr(old, field)
    # the stored timestamps are rebased (and scaled): absolute first
    if field == "timestamps" and out is not None:
        out = out.astype(np.int64) * old.ts_scale + old.ts_base
    n_old = old.num_edges
    for b in batches:
        nb = b["src_ids"].size
        out = _concat_opt(out, b.get(field), n_old, nb)
        n_old += nb
    return out


class UpdateLog:
    """Append-only JSONL update log with replay (the durability tier)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append_nodes(self, node_type: str, **kw):
        self._append({"kind": "nodes", "type": node_type,
                      **{k: np.asarray(v).tolist()
                         for k, v in kw.items() if v is not None}})

    def append_edges(self, edge_type: str, **kw):
        self._append({"kind": "edges", "type": edge_type,
                      **{k: np.asarray(v).tolist()
                         for k, v in kw.items() if v is not None}})

    def _append(self, rec: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def offset(self) -> int:
        """Records appended so far: the checkpoint mark."""
        if not os.path.exists(self.path):
            return 0
        with open(self.path) as f:
            return sum(1 for _ in f)

    def replay(self, buf: UpdateBuffer, start: int = 0, upto=None) -> int:
        """Replay records ``[start, upto)`` into ``buf`` (``upto=None``: to
        the end); returns the count."""
        if not os.path.exists(self.path):
            return 0
        n = 0
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i < start or (upto is not None and i >= upto):
                    continue
                rec = json.loads(line)
                kind, t = rec.pop("kind"), rec.pop("type")
                if kind == "nodes":
                    buf.add_nodes(t, **rec)
                else:
                    buf.add_edges(t, **rec)
                n += 1
        return n


def expire_edges(graph, older_than,
                 edge_types: Optional[List[str]] = None) -> Dict[str, int]:
    """Drop edges whose absolute timestamp is below ``older_than``, from
    every timestamped type or from ``edge_types`` (each with its
    ``<type>_reverse`` twin, so reverse hops stop serving them too).
    Returns {edge type: edges dropped}."""
    store = graph.store
    dropped: Dict[str, int] = {}
    if edge_types is None:
        types = [t for t, et in store.edges.items()
                 if et.timestamps is not None]
    else:
        types = []
        for t in edge_types:
            types.append(t)
            rev = t + "_reverse"
            if rev in store.edges and rev not in edge_types:
                types.append(rev)
    for t in types:
        old = store.edges.get(t)
        if old is None:
            raise NotFoundError("unknown edge type %r" % t)
        if old.timestamps is None:
            raise InvalidArgumentError("edge type %r is not timestamped" % t)
        absolute = old.timestamps.astype(np.int64) * old.ts_scale \
            + old.ts_base
        keep = absolute >= int(older_than)
        n_drop = int((~keep).sum())
        dropped[t] = n_drop
        if n_drop == 0:
            continue

        def sel(a):
            return None if a is None else a[keep]

        store.add_edge_table(EdgeTable(
            t, old.src_type, old.dst_type, old.decoder,
            src=old.src[keep], dst=old.dst[keep],
            num_src_nodes=old.num_src_nodes,
            num_dst_nodes=old.num_dst_nodes,
            int_attrs=sel(old.int_attrs), float_attrs=sel(old.float_attrs),
            multival_attrs=sel(old.multival_attrs),
            multival_lens=sel(old.multival_lens),
            weights=sel(old.weights), labels=sel(old.labels),
            timestamps=absolute[keep]))
    unify_ts_bases(store)
    return dropped
