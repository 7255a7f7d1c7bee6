"""Built-store snapshot and restore: a cold start without re-ingesting.

Counterpart of ``graph_learn_tpu/core/snapshot.py:1-177``, in the same
on-disk format: a directory of ``.npy`` arrays (``a00000.npy``,
``a00001.npy``, ... in the order the manifest names them) and a
``manifest.json`` of version 1 with the same keys, so a snapshot that
either package writes loads in the other.  What is saved is the built host
store: the id-remapped payload tables, the rebased edge lists with their
time domain (``ts_base``, ``ts_scale``), the node sets and the decoders.
Float features stay float32 on the host in both packages; the bfloat16
cast happens where a device view is built (``core/store.py``), so no array
of the snapshot needs ``ml_dtypes``.

``load_store`` memory-maps the arrays by default (``mmap_mode="r"``), so a
restore costs the ``IdIndex`` sort and the degree counts, not the parse.
The mapped arrays are read-only: the store's device views copy them
(``core/store.py _put``) and no path writes into them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import (EdgeTable, GraphStore, NodeSet,
                                              NodeTable)
from graph_learn_tpu_torch.errors import InvalidArgumentError

FORMAT_VERSION = 1
MANIFEST = "manifest.json"


def _decoder_cfg(dec: Decoder) -> dict:
    return {
        "weighted": dec.weighted,
        "labeled": dec.labeled,
        "timestamped": dec.timestamped,
        "attr_types": [list(t) if isinstance(t, (tuple, list)) else t
                       for t in dec.attr_types],
        "attr_dims": dec.attr_dims,
        "attr_delimiter": dec.attr_delimiter,
        "multival_max_len": dec.multival_max_len,
    }


def _decoder_from_cfg(cfg: dict) -> Decoder:
    return Decoder(
        weighted=cfg["weighted"], labeled=cfg["labeled"],
        timestamped=cfg["timestamped"],
        attr_types=[tuple(t) if isinstance(t, list) else t
                    for t in cfg["attr_types"]],
        attr_dims=cfg["attr_dims"],
        attr_delimiter=cfg["attr_delimiter"],
        multival_max_len=cfg["multival_max_len"])


class _ArrayWriter:
    """Writes each array to the next ``a%05d.npy`` and returns its name."""

    def __init__(self, path: str):
        self.path = path
        self.n = 0

    def put(self, a: Optional[np.ndarray]) -> Optional[str]:
        if a is None:
            return None
        name = "a%05d.npy" % self.n
        self.n += 1
        np.save(os.path.join(self.path, name), np.ascontiguousarray(a))
        return name


def save_store(store: GraphStore, path: str) -> None:
    """Write the host store to ``path/``: the arrays, then the manifest,
    written to a temporary name and renamed into place, so a directory
    with a manifest holds a whole snapshot."""
    os.makedirs(path, exist_ok=True)
    w = _ArrayWriter(path)
    man: Dict[str, object] = {"version": FORMAT_VERSION,
                              "nodes": [], "edges": [], "node_sets": []}
    for t, nt in store.nodes.items():
        man["nodes"].append({
            "type": t,
            "decoder": _decoder_cfg(nt.decoder),
            "raw_ids": w.put(nt.raw_ids),
            "int_attrs": w.put(nt.int_attrs),
            "float_attrs": w.put(nt.float_attrs),
            "multival_attrs": w.put(nt.multival_attrs),
            "multival_lens": w.put(nt.multival_lens),
            "weights": w.put(nt.weights),
            "labels": w.put(nt.labels),
            "timestamps": w.put(nt.timestamps),
        })
    for t, et in store.edges.items():
        man["edges"].append({
            "type": t, "src_type": et.src_type, "dst_type": et.dst_type,
            "decoder": _decoder_cfg(et.decoder),
            "num_src_nodes": et.num_src_nodes,
            "num_dst_nodes": et.num_dst_nodes,
            "ts_base": et.ts_base, "ts_scale": et.ts_scale,
            "src": w.put(et.src), "dst": w.put(et.dst),
            "weights": w.put(et.weights), "labels": w.put(et.labels),
            "timestamps": w.put(et.timestamps),
            "int_attrs": w.put(et.int_attrs),
            "float_attrs": w.put(et.float_attrs),
            "multival_attrs": w.put(et.multival_attrs),
            "multival_lens": w.put(et.multival_lens),
        })
    for t, ns in store.node_sets.items():
        man["node_sets"].append({
            "type": t, "base_type": ns.base_type,
            "indices": w.put(ns.indices),
            "weights": w.put(ns.weights),
        })
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(man, f)
    os.replace(tmp, os.path.join(path, MANIFEST))


def load_store(path: str, mmap: bool = True) -> GraphStore:
    """Rebuild a ``GraphStore`` from ``save_store``'s output (either
    package's).

    An edge table is built without timestamps and then given the saved
    ones with their saved (base, scale) domain and the ts-ascending sort
    key, as the JAX package does (``:162-171``): ``EdgeTable.__init__``
    would rebase them again and, without them, order a weighted table's
    rows by weight."""
    mf = os.path.join(path, MANIFEST)
    if not os.path.exists(mf):
        raise InvalidArgumentError("no store snapshot at %r" % path)
    with open(mf) as f:
        man = json.load(f)
    if man.get("version") != FORMAT_VERSION:
        raise InvalidArgumentError(
            "snapshot version %r unsupported" % man.get("version"))

    def rd(name):
        if name is None:
            return None
        return np.load(os.path.join(path, name),
                       mmap_mode="r" if mmap else None)

    store = GraphStore()
    for m in man["nodes"]:
        store.add_node_table(NodeTable(
            m["type"], _decoder_from_cfg(m["decoder"]),
            np.asarray(rd(m["raw_ids"])),
            int_attrs=rd(m["int_attrs"]), float_attrs=rd(m["float_attrs"]),
            multival_attrs=rd(m["multival_attrs"]),
            multival_lens=rd(m["multival_lens"]),
            weights=rd(m["weights"]), labels=rd(m["labels"]),
            timestamps=rd(m["timestamps"])))
    for m in man["edges"]:
        ts = rd(m["timestamps"])
        et = EdgeTable(
            m["type"], m["src_type"], m["dst_type"],
            _decoder_from_cfg(m["decoder"]),
            src=np.asarray(rd(m["src"])), dst=np.asarray(rd(m["dst"])),
            num_src_nodes=m["num_src_nodes"],
            num_dst_nodes=m["num_dst_nodes"],
            int_attrs=rd(m["int_attrs"]), float_attrs=rd(m["float_attrs"]),
            multival_attrs=rd(m["multival_attrs"]),
            multival_lens=rd(m["multival_lens"]),
            weights=rd(m["weights"]), labels=rd(m["labels"]),
            timestamps=None)
        if ts is not None:
            et.timestamps = np.asarray(ts, np.int64)
            et.ts_base = int(m["ts_base"])
            et.ts_scale = int(m["ts_scale"])
            et._sort_key = et.timestamps.astype(np.float64)
            et._sort_desc = False
        store.add_edge_table(et)
    for m in man["node_sets"]:
        store.node_sets[m["type"]] = NodeSet(
            type_name=m["type"], base_type=m["base_type"],
            indices=np.asarray(rd(m["indices"]), np.int32),
            weights=rd(m["weights"]))
    return store
