"""Synthetic datasets written as TSV tables in the reference format.

The port's own copy of the repository's ``examples/data/synthetic.py``
(``cora_like:24``, ``u2i:80``, ``temporal_u2i:122``): for the same
arguments each generator draws the same numbers in the same order and
writes the same bytes.  The draws of ``cora_like`` and ``temporal_u2i``
are also returned as arrays (``cora_like_arrays``,
``temporal_u2i_arrays``), so an example can build the same store in
memory; :func:`as_read` gives float columns as the loader reads them back
from their five-decimal text.

- ``cora_like``: a homophilous stochastic block graph with class-centred
  noisy features, for node classification;
- ``u2i``: a bipartite user-item graph with latent preference clusters,
  and item-item co-cluster edges, for link prediction;
- ``temporal_u2i``: a JODIE-style timestamped user-item event stream,
  split in time into train, val and test events.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def as_read(x: np.ndarray) -> np.ndarray:
    """``x`` as the loader reads back its ``%.5f`` text: float32 of the
    printed decimal (the native loader's ``strtod`` and cast)."""
    x = np.asarray(x)
    return np.asarray(["%.5f" % v for v in x.reshape(-1)],
                      dtype=np.float32).reshape(x.shape)


def cora_like_arrays(n: int = 1000, classes: int = 7, feat_dim: int = 64,
                     avg_degree: int = 8, homophily: float = 0.85,
                     feat_noise: float = 2.0, train_frac: float = 0.3,
                     val_frac: float = 0.2, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """The draws of :func:`cora_like`: labels [n], unit-norm float64
    features [n, feat_dim], the kept edges (src, dst), and the sorted ids
    of the train, val and test splits."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    centers = rng.normal(0, 1, (classes, feat_dim))
    feats = centers[labels] + rng.normal(0, feat_noise, (n, feat_dim))
    feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)

    m = n * avg_degree // 2
    src = rng.integers(0, n, 4 * m)
    dst = rng.integers(0, n, 4 * m)
    same = labels[src] == labels[dst]
    keep_same = same & (rng.random(4 * m) < homophily)
    keep_diff = (~same) & (rng.random(4 * m)
                           < (1 - homophily) / max(classes - 1, 1))
    keep = (keep_same | keep_diff) & (src != dst)
    src, dst = src[keep][:m], dst[keep][:m]
    perm = rng.permutation(n)
    n_train = int(n * train_frac)
    n_val = int(n * val_frac)
    return {"labels": labels, "feats": feats, "src": src, "dst": dst,
            "train": np.sort(perm[:n_train]),
            "val": np.sort(perm[n_train:n_train + n_val]),
            "test": np.sort(perm[n_train + n_val:])}


def cora_like(out_dir: str, n: int = 1000, classes: int = 7,
              feat_dim: int = 64, avg_degree: int = 8,
              homophily: float = 0.85, feat_noise: float = 2.0,
              train_frac: float = 0.3, val_frac: float = 0.2,
              seed: int = 0):
    """Writes node_table / edge_table / train_table / val_table /
    test_table; returns the sizes."""
    a = cora_like_arrays(n, classes, feat_dim, avg_degree, homophily,
                         feat_noise, train_frac, val_frac, seed)
    os.makedirs(out_dir, exist_ok=True)
    labels, feats = a["labels"], a["feats"]
    with open(os.path.join(out_dir, "node_table"), "w") as f:
        f.write("id:int64\tlabel:int64\tfeature:string\n")
        for i in range(n):
            f.write("%d\t%d\t%s\n"
                    % (i, labels[i], ":".join("%.5f" % x for x in feats[i])))
    with open(os.path.join(out_dir, "edge_table"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for s, d in zip(a["src"], a["dst"]):
            f.write("%d\t%d\t1.0\n" % (s, d))
    for name in ("train", "val", "test"):
        with open(os.path.join(out_dir, name + "_table"), "w") as f:
            f.write("id:int64\tweight:float\n")
            for i in a[name]:
                f.write("%d\t1.0\n" % i)
    return {"n": n, "classes": classes, "feat_dim": feat_dim,
            "num_edges": len(a["src"])}


def u2i(out_dir: str, n_users: int = 500, n_items: int = 300,
        n_clusters: int = 5, edges_per_user: int = 10,
        feat_dim: int = 16, seed: int = 0):
    """Bipartite user-item graph: user_table, item_table, u2i_table and
    the item-item co-cluster edges of i2i_table."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    u_cluster = rng.integers(0, n_clusters, n_users)
    i_cluster = rng.integers(0, n_clusters, n_items)
    u_feat = rng.normal(0, 1, (n_users, feat_dim)) + \
        3.0 * np.eye(n_clusters)[u_cluster] @ rng.normal(
            0, 1, (n_clusters, feat_dim))
    i_feat = rng.normal(0, 1, (n_items, feat_dim)) + \
        3.0 * np.eye(n_clusters)[i_cluster] @ rng.normal(
            0, 1, (n_clusters, feat_dim))

    srcs, dsts = [], []
    item_by_cluster = [np.where(i_cluster == c)[0]
                       for c in range(n_clusters)]
    for u in range(n_users):
        pool = item_by_cluster[u_cluster[u]]
        if pool.size == 0:
            pool = np.arange(n_items)
        picks = rng.choice(pool, size=min(edges_per_user, pool.size),
                           replace=False)
        srcs.extend([u] * len(picks))
        dsts.extend(picks.tolist())

    def write_nodes(name, count, feats):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("id:int64\tfeature:string\n")
            for i in range(count):
                f.write("%d\t%s\n"
                        % (i, ":".join("%.5f" % x for x in feats[i])))

    write_nodes("user_table", n_users, u_feat)
    write_nodes("item_table", n_items, i_feat)
    with open(os.path.join(out_dir, "u2i_table"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for s, d in zip(srcs, dsts):
            f.write("%d\t%d\t1.0\n" % (s, d))
    with open(os.path.join(out_dir, "i2i_table"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for c in range(n_clusters):
            items = item_by_cluster[c]
            for i in items:
                nbrs = rng.choice(items, size=min(5, items.size),
                                  replace=False)
                for j in nbrs:
                    if i != j:
                        f.write("%d\t%d\t1.0\n" % (i, j))
    return {"n_users": n_users, "n_items": n_items,
            "num_edges": len(srcs), "feat_dim": feat_dim}


# the first absolute timestamp and the step between events
TS0, TS_STEP = 1_600_000_000, 60


def temporal_u2i_arrays(n_users: int = 300, n_items: int = 200,
                        n_clusters: int = 4, events: int = 6000,
                        feat_dim: int = 8, edge_feat_dim: int = 4,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """The draws of :func:`temporal_u2i`: float64 user and item features
    around their cluster's centre, and ``events`` (user, item of the
    user's cluster, ts, float64 edge features) one minute apart."""
    rng = np.random.default_rng(seed)
    cu = rng.integers(0, n_clusters, n_users)
    ci = rng.integers(0, n_clusters, n_items)
    centers = rng.normal(0, 2.0, (n_clusters, feat_dim))
    u_feat = centers[cu] + rng.normal(0, 0.6, (n_users, feat_dim))
    i_feat = centers[ci] + rng.normal(0, 0.6, (n_items, feat_dim))
    item_by_cluster = [np.where(ci == c)[0] for c in range(n_clusters)]
    src = np.empty(events, np.int64)
    dst = np.empty(events, np.int64)
    ef = np.empty((events, edge_feat_dim))
    for t in range(events):
        u = int(rng.integers(0, n_users))
        pool = item_by_cluster[cu[u]]
        dst[t] = (int(pool[rng.integers(0, pool.size)]) if pool.size
                  else int(rng.integers(0, n_items)))
        src[t] = u
        ef[t] = rng.normal(0, 1, edge_feat_dim)
    return {"u_feat": u_feat, "i_feat": i_feat, "src": src, "dst": dst,
            "ts": TS0 + np.arange(events, dtype=np.int64) * TS_STEP,
            "edge_feat": ef}


def temporal_u2i(out_dir: str, n_users: int = 300, n_items: int = 200,
                 n_clusters: int = 4, events: int = 6000,
                 feat_dim: int = 8, edge_feat_dim: int = 4, seed: int = 0):
    """Writes user_table / item_table and the interaction (every event),
    train (first 70%), val (next 15%) and test (last 15%) event tables
    (``src dst ts edge_attrs``)."""
    a = temporal_u2i_arrays(n_users, n_items, n_clusters, events, feat_dim,
                            edge_feat_dim, seed)
    os.makedirs(out_dir, exist_ok=True)

    def write_nodes(name, count, feats):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("id:int64\tfeature:string\n")
            for i in range(count):
                f.write("%d\t%s\n" %
                        (i, ":".join("%.5f" % x for x in feats[i])))

    write_nodes("user_table", n_users, a["u_feat"])
    write_nodes("item_table", n_items, a["i_feat"])
    rows = list(zip(a["src"], a["dst"], a["ts"], a["edge_feat"]))

    def write_events(name, subset):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("src_id:int64\tdst_id:int64\ttimestamp:int64"
                    "\tfeature:string\n")
            for u, i, ts, ef in subset:
                f.write("%d\t%d\t%d\t%s\n" %
                        (u, i, ts, ":".join("%.5f" % x for x in ef)))

    n_tr = int(events * 0.7)
    n_va = int(events * 0.85)
    write_events("interaction_table", rows)
    write_events("train_table", rows[:n_tr])
    write_events("val_table", rows[n_tr:n_va])
    write_events("test_table", rows[n_va:])
    return {"n_users": n_users, "n_items": n_items, "events": events,
            "feat_dim": feat_dim, "edge_feat_dim": edge_feat_dim}
