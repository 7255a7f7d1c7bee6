"""EgoGraphSAGE supervised node classification on the Cora-like TSV files.

Counterpart of the repository's ``examples/ego_sage_supervised.py`` (the
reference's flagship flow): fanout [25, 10] over two hops, agg "gcn",
hidden 128, dropout 0.5, Adam 0.05, 20 epochs over the masked train split
of batch 140, then the test accuracy.  The graph is the reference's Cora
table layout in ``--data_dir`` loaded through
``Graph().node(...).edge(...).init()`` (:func:`load_graph`): real Cora or
ogbn-products prepared by ``examples/data/cora.py`` or
``ogbn_products.py``, or ``cora_like``'s files, written first when
``--data_dir`` has none.  On the card the rows of src and the first hop
are gathered by Kernel 1 and the deepest hop is reduced straight from the
table by Kernel 2: two plus one launches a step.

The reference's Cora configuration: ``--features_num 1433 --nodes 2708
--classes 7 --epochs 40`` with the other defaults.

Usage:  python -m graph_learn_tpu_torch.examples.ego_sage_supervised
            [--cpu] [--data_dir D] [--epochs N] [--nbrs K1 K2]
            [--features_num F] [--nodes N] [--classes C]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from graph_learn_tpu_torch.core.schema import Mask
from graph_learn_tpu_torch.examples.common import (accuracy_fn, hop_aliases,
                                                   load_cora_like,
                                                   read_cora_layout,
                                                   supervised_loss_fn,
                                                   supervised_query)
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import DeviceLike, resolve_device

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "glt_cora_like")


def load_graph(data_dir: str, feat_dim: int, device: DeviceLike = "cuda"):
    """(graph, node decoder) of the Cora table layout in ``data_dir``
    (``examples/ego_sage_supervised.py load_graph:34``); loads, never
    writes.  Raw ids need not be contiguous, and edges of weight 0 sample
    uniformly, as in the JAX store."""
    return read_cora_layout(data_dir, feat_dim, device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--steps_per_epoch", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=140)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--features_num", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--nbrs", type=int, nargs="+", default=[25, 10])
    ap.add_argument("--agg", default="gcn")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap


def run(args, graph=None) -> dict:
    """Train and evaluate; ``graph`` = (graph, node decoder) replaces the
    files.  Returns the test accuracy, the per-epoch losses, the graph,
    the model and the seconds of the training on the host clock."""
    dev = resolve_device("cpu" if args.cpu else "cuda")
    g, dec = graph or load_cora_like(args.data_dir, args.features_num,
                                     args.nodes, args.classes, device=dev)
    model = EgoGraphSAGE([args.features_num, args.hidden, args.classes], dec,
                         agg_type=args.agg, dropout=args.dropout, device=dev)
    hops = hop_aliases(args.nbrs)
    train_q = supervised_query(g, Mask.TRAIN, args.batch_size, args.nbrs)
    test_q = supervised_query(g, Mask.TEST, args.batch_size, args.nbrs)
    tr = LocalTrainer(device=dev)
    t0 = time.perf_counter()
    _, hist = tr.train(train_q, model, supervised_loss_fn(hops, True),
                       torch.optim.Adam(model.parameters(), lr=args.lr),
                       epochs=args.epochs,
                       steps_per_epoch=args.steps_per_epoch)
    train_s = time.perf_counter() - t0
    acc = tr.evaluate(test_q, model, accuracy_fn(hops, True))
    return {"acc": acc, "history": hist, "graph": g, "model": model,
            "train_s": train_s}


def main(argv=None) -> float:
    out = run(build_parser().parse_args(argv))
    print("test accuracy: %.4f" % out["acc"])
    return out["acc"]


if __name__ == "__main__":
    main()
