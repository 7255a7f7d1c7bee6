"""EgoRGCN supervised over two relations, on the Cora-like TSV files.

Counterpart of the repository's ``examples/ego_rgcn_supervised.py``: the
``cora_like`` files loaded through ``Graph.node/edge/init`` with two
relations over one edge file (``relation`` and ``relation2``, both
undirected, ``examples/common.py``), the hop tree of ``ego_rgcn.py``
(level l has R^l groups, fanout [10, 5]), ``EgoRGCN`` with basis (or
block) decomposition, hidden 64, Adam 0.05, 20 epochs of batch 128, then
the test accuracy.  ``examples/ego_rgcn.py`` keeps the in-memory form
over the family generator's store.  Every hop's rows are gathered by
Kernel 1 on the card: seven launches a step.

Usage:  python -m graph_learn_tpu_torch.examples.ego_rgcn_supervised
            [--cpu] [--data_dir D] [--epochs N] [--num_bases B]
"""

from __future__ import annotations

import argparse

import torch

from graph_learn_tpu_torch.core.schema import Mask
from graph_learn_tpu_torch.examples.common import RELATIONS, load_cora_like
from graph_learn_tpu_torch.examples.ego_rgcn import (make_ego, rgcn_loss,
                                                     rgcn_query)
from graph_learn_tpu_torch.examples.ego_sage_supervised import DEFAULT_DIR
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoRGCN
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from graph_learn_tpu_torch.utils.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--steps_per_epoch", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--features_num", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--nbrs", type=int, nargs="+", default=[10, 5])
    ap.add_argument("--num_bases", type=int, default=1)
    ap.add_argument("--num_blocks", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap


def run(args, graph=None) -> dict:
    """Train and evaluate; ``graph`` = (graph, node decoder) replaces the
    files.  Returns the test accuracy, the per-epoch losses, the graph,
    the model and the hop aliases."""
    dev = resolve_device("cpu" if args.cpu else "cuda")
    g, dec = graph or load_cora_like(args.data_dir, args.features_num,
                                     args.nodes, args.classes,
                                     two_relations=True, device=dev)
    model = EgoRGCN([args.features_num, args.hidden, args.classes], dec,
                    num_relations=len(RELATIONS),
                    num_bases=args.num_bases or None,
                    num_blocks=args.num_blocks or None, device=dev)
    train_q, aliases = rgcn_query(g, Mask.TRAIN, args.batch_size, args.nbrs,
                                  RELATIONS)
    test_q, _ = rgcn_query(g, Mask.TEST, args.batch_size, args.nbrs,
                           RELATIONS)

    def loss_fn(m, batch, generator, training):
        return rgcn_loss(m, batch, aliases, args.nbrs, training, generator)

    def acc_fn(m, batch):
        logits = m(make_ego(batch, aliases, args.nbrs), training=False)
        return (logits.argmax(1) == batch["src"].labels.long()).float()

    tr = LocalTrainer(device=dev)
    _, hist = tr.train(train_q, model, loss_fn,
                       torch.optim.Adam(model.parameters(), lr=args.lr),
                       epochs=args.epochs,
                       steps_per_epoch=args.steps_per_epoch)
    acc = tr.evaluate(test_q, model, acc_fn)
    return {"acc": acc, "history": hist, "graph": g, "model": model,
            "aliases": aliases}


def main(argv=None) -> float:
    out = run(build_parser().parse_args(argv))
    print("test accuracy: %.4f" % out["acc"])
    return out["acc"]


if __name__ == "__main__":
    main()
