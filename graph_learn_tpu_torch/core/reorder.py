"""Ingest-time locality reorder: relabel nodes so neighbours get nearby
indices.

Counterpart of ``graph_learn_tpu/core/reorder.py:1-142``, the port's own
numpy copy, enabled by ``Graph.init(reorder="bfs")``.  A breadth-first
(Cuthill-McKee style) labelling, one level a seed as in the JAX
package, puts a node's neighbours at nearby
indices on community-structured graphs, so the feature rows one seed's
hops gather lie closer together in the table.  Only edge types within one
node type drive that type's order; a type without such edges keeps its
load order.

The JAX package measured it neutral on a TPU (its gather fetched a tile
per index).  On the card it is a measurement, not a claim: ``chip_smoke.py``
times Kernel 1 over one batch's rows before and after.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from graph_learn_tpu_torch.core.store import EdgeTable, IdIndex

REORDER_STRATEGIES = ("bfs",)
NODE_FIELDS = ("raw_ids", "int_attrs", "float_attrs", "multival_attrs",
               "multival_lens", "weights", "labels", "timestamps")


def bfs_order(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """perm with ``perm[old_index] = new_index``, equal to the JAX
    package's ``bfs_order`` bit for bit.

    Seeds are taken in descending degree (stable); each unvisited seed
    with edges is emitted, then its unvisited neighbours in ascending
    degree (Cuthill-McKee); nodes without edges go last, in index order.
    The JAX loop never advances its frontier past the seed (``frontier``
    is not reassigned, so its second pass finds every neighbour visited
    and stops): each seed emits one level, and so does this copy."""
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    order_e = np.argsort(s2, kind="stable")
    s2, d2 = s2[order_e], d2[order_e]
    counts = np.bincount(s2, minlength=n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offs[1:])

    visited = np.zeros(n, bool)
    out: List[np.ndarray] = []
    emitted = 0
    for seed in np.argsort(-deg, kind="stable"):
        if visited[seed] or deg[seed] == 0:
            continue
        visited[seed] = True
        out.append(np.array([seed], np.int64))
        emitted += 1
        nxt = np.unique(d2[offs[seed]:offs[seed + 1]])
        nxt = nxt[~visited[nxt]]
        if nxt.size:
            nxt = nxt[np.argsort(deg[nxt], kind="stable")]
            visited[nxt] = True
            out.append(nxt)
            emitted += nxt.size
        if emitted >= n:
            break
    rest = np.flatnonzero(~visited)
    if rest.size:
        out.append(rest)
    new_to_old = np.concatenate(out) if out else np.arange(n)
    perm = np.empty(n, np.int64)
    perm[new_to_old] = np.arange(n)
    return perm.astype(np.int32)


def reorder_store(store, strategy: str = "bfs") -> Dict[str, np.ndarray]:
    """Relabel every node type that has edges within itself and remap
    every table that refers to it; returns {node type: perm}.

    Runs before any device view is used (``Graph.init`` calls it after the
    edges and before ``unify_ts_bases``): each reordered node table drops
    its device views and rebuilds its ``IdIndex``; each edge table that
    touches a reordered type is built anew from its absolute timestamps;
    the node sets' indices are remapped."""
    if strategy not in REORDER_STRATEGIES:
        raise ValueError("unknown reorder strategy %r" % strategy)
    perms: Dict[str, np.ndarray] = {}
    for ntype, nt in store.nodes.items():
        srcs = [et.src for et in store.edges.values()
                if et.src_type == ntype and et.dst_type == ntype]
        dsts = [et.dst for et in store.edges.values()
                if et.src_type == ntype and et.dst_type == ntype]
        if srcs:
            perms[ntype] = bfs_order(nt.num_nodes, np.concatenate(srcs),
                                     np.concatenate(dsts))

    for ntype, perm in perms.items():
        nt = store.nodes[ntype]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size, dtype=perm.dtype)  # new -> old
        for f in NODE_FIELDS:
            a = getattr(nt, f)
            if a is not None:
                setattr(nt, f, a[inv])
        nt.index = IdIndex(nt.raw_ids)
        nt._device = {}

    for e_t, et in list(store.edges.items()):
        ps, pd = perms.get(et.src_type), perms.get(et.dst_type)
        if ps is None and pd is None:
            continue
        store.edges[e_t] = EdgeTable(
            e_t, et.src_type, et.dst_type, et.decoder,
            src=ps[et.src] if ps is not None else et.src,
            dst=pd[et.dst] if pd is not None else et.dst,
            num_src_nodes=et.num_src_nodes, num_dst_nodes=et.num_dst_nodes,
            int_attrs=et.int_attrs, float_attrs=et.float_attrs,
            multival_attrs=et.multival_attrs, multival_lens=et.multival_lens,
            weights=et.weights, labels=et.labels,
            timestamps=(et.timestamps.astype(np.int64) * et.ts_scale
                        + et.ts_base if et.timestamps is not None else None))

    for ns in store.node_sets.values():
        p = perms.get(ns.base_type)
        if p is not None and ns.indices is not None:
            ns.indices = p[ns.indices].astype(np.int32)
    return perms
