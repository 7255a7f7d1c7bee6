"""ogbl-collab -> the reference's SEAL TSV table layout.

The port's own copy of the repository's ``examples/data/ogbl_collab.py``
(``write_collab_tables:20``): for the same arrays it writes the same
bytes.  Six tables: the train, val and test edges with their weights
(``str`` of each weight, so a float32, float64 or int64 array each writes
as numpy prints its scalars; ``1.0`` where no weight is given), the val
and test negative edges, and the node table of ``:``-joined features
(``str`` of each value: a float32's shortest text, which reads back to
the same float32).  ``python -m graph_learn_tpu_torch.examples.seal
--collab_dir <out>`` trains on them and reports hits@50.

The arrays are OGB's ``LinkPropPredDataset("ogbl-collab")`` split
(``split["train"]["edge"]``, ``["weight"]``, ``split["valid"]["edge"]``,
``["edge_neg"]``, the same for ``"test"``, and ``graph["node_feat"]``),
taken from files the user already has; nothing is downloaded.

Usage (Python):
  write_collab_tables(out_dir, train_edge, train_weight, valid_edge,
                      valid_neg, test_edge, test_neg, node_feat)
"""

from __future__ import annotations

import os


def write_collab_tables(out_dir, train_edge, train_weight, valid_edge,
                        valid_neg, test_edge, test_neg, node_feat) -> str:
    """Write the six reference-layout tables from in-memory arrays;
    returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)

    def edges(name, e, w=None):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("src_id:int64\tdst_id:int64\tweight:float\n")
            for i in range(len(e)):
                f.write("%d\t%d\t%s\n" % (
                    e[i, 0], e[i, 1], str(w[i]) if w is not None else "1.0"))

    edges("ogbl_collab_train_edge", train_edge, train_weight)
    edges("ogbl_collab_val_edge", valid_edge)
    edges("ogbl_collab_test_edge", test_edge)
    edges("ogbl_collab_val_edge_neg", valid_neg)
    edges("ogbl_collab_test_edge_neg", test_neg)
    with open(os.path.join(out_dir, "ogbl_collab_node"), "w") as f:
        f.write("id:int64\tfeature:string\n")
        for i in range(node_feat.shape[0]):
            f.write("%d\t%s\n" % (i, ":".join(map(str, node_feat[i]))))
    return out_dir
