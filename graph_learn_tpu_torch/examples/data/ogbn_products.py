"""ogbn-products -> the reference's TSV table layout.

The port's own copy of the repository's ``examples/data/ogbn_products.py``
(``write_products_tables:30``, ``_read_csv_gz:54``, ``prepare_products:59``):
for the same inputs it writes the same bytes.  The tables are those of the
Cora prep: a node_table of ``%.6g`` features and integer labels, an
edge_table of weight 1.0, and train / val / test id tables.  Then
``python -m graph_learn_tpu_torch.examples.ego_sage_supervised --data_dir
<out> --features_num 100 --classes 47 --nodes 2449029`` trains on them.

Input: OGB's raw csv.gz layout, from files the user already has
(``products/raw/node-feat.csv.gz``, ``node-label.csv.gz``,
``edge.csv.gz``, and ``products/split/sales_ranking/{train,valid,
test}.csv.gz``, or a flat ``raw/split/`` beside them); nothing is
downloaded and no ``ogb`` package is needed.

Usage:
  python -m graph_learn_tpu_torch.examples.data.ogbn_products
      --raw_dir products/raw --out_dir O
"""

from __future__ import annotations

import argparse
import gzip
import os

import numpy as np


def write_products_tables(out_dir, node_feat, node_label, edges, train_idx,
                          valid_idx, test_idx) -> str:
    """Write the node / edge / split tables in the reference layout;
    returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    n = node_feat.shape[0]
    with open(os.path.join(out_dir, "node_table"), "w") as f:
        f.write("id:int64\tlabel:int64\tfeature:string\n")
        for i in range(n):
            f.write("%d\t%d\t%s\n" % (
                i, int(node_label[i]),
                ":".join("%.6g" % x for x in node_feat[i])))
    with open(os.path.join(out_dir, "edge_table"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\n")
        for s, d in edges:
            f.write("%d\t%d\t1.0\n" % (s, d))
    for name, idx in (("train_table", train_idx), ("val_table", valid_idx),
                      ("test_table", test_idx)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("id:int64\tweight:float\n")
            for i in idx:
                f.write("%d\t1.0\n" % i)
    return out_dir


def _read_csv_gz(path, dtype):
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def prepare_products(raw_dir: str, out_dir: str) -> str:
    """OGB's raw csv.gz layout -> the reference tables; the split comes
    from ``<raw_dir>/../split/sales_ranking``, or where that is missing
    from ``<raw_dir>/split``."""
    feat = _read_csv_gz(os.path.join(raw_dir, "node-feat.csv.gz"),
                        np.float32)
    label = _read_csv_gz(os.path.join(raw_dir, "node-label.csv.gz"),
                         np.int64).reshape(-1)
    edges = _read_csv_gz(os.path.join(raw_dir, "edge.csv.gz"), np.int64)
    split_dir = os.path.join(os.path.dirname(raw_dir), "split",
                             "sales_ranking")
    if not os.path.isdir(split_dir):
        split_dir = os.path.join(raw_dir, "split")

    def idxs(name):
        return _read_csv_gz(os.path.join(split_dir, name + ".csv.gz"),
                            np.int64).reshape(-1)

    return write_products_tables(out_dir, feat, label, edges, idxs("train"),
                                 idxs("valid"), idxs("test"))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_dir", required=True,
                    help="OGB's products/raw directory (csv.gz files)")
    ap.add_argument("--out_dir", required=True)
    args = ap.parse_args(argv)
    prepare_products(args.raw_dir, args.out_dir)
    print("wrote", args.out_dir)
    return args.out_dir


if __name__ == "__main__":
    main()
