"""Real Cora -> the reference's TSV table layout.

The port's own copy of the repository's ``examples/data/cora.py``
(``prepare_cora:27``): for the same raw files it writes the same bytes.
The tables are what the reference's prep script produces: a node_table
of row-normalised features and integer labels (the class names sorted),
an edge_table_with_self_loop (every citation that is not a loop, then one
self-loop per node, all of weight 0.0), and train / val / test id tables
split 0:140 / 200:500 / 500:1500.  Load them with
``ego_sage_supervised.load_graph`` or run ``python -m
graph_learn_tpu_torch.examples.ego_sage_supervised --data_dir <out>
--features_num 1433 --nodes 2708 --classes 7 --epochs 40``.

Input: ``cora.content`` (id, 1 433 word flags, class name) and
``cora.cites`` (cited, citing) of the standard Cora distribution, in a
directory the caller already has; nothing is downloaded.

Usage:
  python -m graph_learn_tpu_torch.examples.data.cora --raw_dir D
      [--out_dir O]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "glt_cora")


def prepare_cora(raw_dir: str, out_dir: str) -> str:
    """Convert raw cora.content / cora.cites to the reference TSV layout
    in ``out_dir``; returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    content = np.genfromtxt(os.path.join(raw_dir, "cora.content"),
                            dtype=np.dtype(str))
    ids = content[:, 0].astype(np.int64)
    feats = content[:, 1:-1].astype(np.float32)
    # row-normalise (the reference's feature_normalize); a zero row stays
    row_sum = feats.sum(axis=1, keepdims=True)
    feats = feats / np.where(row_sum == 0, 1.0, row_sum)
    classes = sorted(set(content[:, -1]))
    cls_map = {c: i for i, c in enumerate(classes)}
    labels = np.array([cls_map[c] for c in content[:, -1]], np.int64)

    with open(os.path.join(out_dir, "node_table"), "w") as f:
        f.write("id:int64\tlabel:int64\tfeature:string\n")
        for i in range(ids.shape[0]):
            f.write("%d\t%d\t%s\n" % (ids[i], labels[i],
                                      ":".join(map(str, feats[i]))))

    n = ids.shape[0]
    splits = {"train_table": range(0, min(140, n)),
              "val_table": range(min(200, n), min(500, n)),
              "test_table": range(min(500, n), min(1500, n))}
    for name, rows in splits.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("id:int64\tweight:float\n")
            for i in rows:
                f.write("%d\t1.0\n" % ids[i])

    cites = np.genfromtxt(os.path.join(raw_dir, "cora.cites"),
                          dtype=np.int64).reshape(-1, 2)
    with open(os.path.join(out_dir, "edge_table"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for s, d in cites:
            if s != d:
                f.write("%d\t%d\t0.0\n" % (s, d))
        for i in ids:
            f.write("%d\t%d\t0.0\n" % (i, i))
    return out_dir


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_dir", required=True,
                    help="directory holding cora.content and cora.cites")
    ap.add_argument("--out_dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    prepare_cora(args.raw_dir, args.out_dir)
    print("wrote reference-layout tables to", args.out_dir)
    return args.out_dir


if __name__ == "__main__":
    main()
