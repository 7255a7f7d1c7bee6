"""EgoGAT supervised node classification on the Cora-like TSV files.

Counterpart of the repository's ``examples/ego_gat_supervised.py``: hidden
16, heads [8, 1], attention dropout 0.6, fanout [5, 2] over two hops,
Adam 0.01, 20 epochs over the train split of batch 140, then the test
accuracy; the graph loaded through ``Graph.node/edge/init``
(``examples/common.py``).  Every neighbour block, forward and backward,
runs on Kernel 3 (``gat_block``): three a step each way.

Usage:  python -m graph_learn_tpu_torch.examples.ego_gat_supervised
            [--cpu] [--data_dir D] [--epochs N] [--nbrs K1 K2]
"""

from __future__ import annotations

import argparse

import torch

from graph_learn_tpu_torch.core.schema import Mask
from graph_learn_tpu_torch.examples.common import (accuracy_fn, hop_aliases,
                                                   load_cora_like,
                                                   supervised_loss_fn,
                                                   supervised_query)
from graph_learn_tpu_torch.examples.ego_sage_supervised import DEFAULT_DIR
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--steps_per_epoch", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=140)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--features_num", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--nbrs", type=int, nargs="+", default=[5, 2])
    ap.add_argument("--heads", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--attn_drop", type=float, default=0.6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap


def run(args, graph=None) -> dict:
    """As ``ego_sage_supervised.run``, with EgoGAT."""
    dev = resolve_device("cpu" if args.cpu else "cuda")
    g, dec = graph or load_cora_like(args.data_dir, args.features_num,
                                     args.nodes, args.classes, device=dev)
    model = EgoGAT([args.features_num, args.hidden, args.classes], dec,
                   num_heads=args.heads, attn_dropout=args.attn_drop,
                   device=dev)
    hops = hop_aliases(args.nbrs)
    train_q = supervised_query(g, Mask.TRAIN, args.batch_size, args.nbrs)
    test_q = supervised_query(g, Mask.TEST, args.batch_size, args.nbrs)
    tr = LocalTrainer(device=dev)
    _, hist = tr.train(train_q, model, supervised_loss_fn(hops),
                       torch.optim.Adam(model.parameters(), lr=args.lr),
                       epochs=args.epochs,
                       steps_per_epoch=args.steps_per_epoch)
    acc = tr.evaluate(test_q, model, accuracy_fn(hops))
    return {"acc": acc, "history": hist, "graph": g, "model": model}


def main(argv=None) -> float:
    out = run(build_parser().parse_args(argv))
    print("test accuracy: %.4f" % out["acc"])
    return out["acc"]


if __name__ == "__main__":
    main()
