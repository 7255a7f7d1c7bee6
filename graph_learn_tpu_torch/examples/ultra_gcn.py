"""UltraGCN: constraint-weighted matrix factorisation for recommendation.

Counterpart of ``examples/ultra_gcn.py``: user and item embedding tables
(parameters, indexed plainly: Kernel 1 refuses a table that requires a
gradient) trained on ``u-i`` edges drawn uniformly, with ``neg_num``
``random`` negative items per edge (``ops/negative.py``), a binary
cross-entropy weighted by the degree constraints ``beta = (1 / d_u) *
sqrt((d_u + 1) / (d_i + 1))``, an item-item constraint towards the first
``ii_k`` ``i-i`` neighbours of the positive item (``topk``), and Adam;
then Recall@20 over every user.

As the JAX example does, the store is ``examples/data/synthetic.py
u2i:72``'s TSV files at 16 features (written first when ``--data_dir``
has none) loaded through ``Graph.node/edge/init``
(``bipartite_sage.load``); ``bipartite_sage.build_graph`` of the same
draws read back from their text is its in-memory twin.

Usage:  python -m graph_learn_tpu_torch.examples.ultra_gcn [--cpu]
            [--data_dir D] [--steps N] [--batch_size B]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.examples.bipartite_sage import DEFAULT_DIR, load
from graph_learn_tpu_torch.ops.negative import negative_sample
from graph_learn_tpu_torch.ops.sampling import topk_sample
from graph_learn_tpu_torch.utils.platform import resolve_device


def _bce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy against a constant label."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, label), reduction="none")


def ultra_loss(params: Dict[str, torch.Tensor], uu: torch.Tensor,
               ii: torch.Tensor, neg: torch.Tensor, ii_nbrs: torch.Tensor,
               du: torch.Tensor, di: torch.Tensor,
               w_ii: float) -> torch.Tensor:
    """The loss of a batch of edges (users ``uu``, items ``ii`` [b]) with
    negatives ``neg`` [b, n] and item-item neighbours ``ii_nbrs`` [b, k];
    ``du`` / ``di`` are the f32 out- / in-degrees of ``u-i``
    (``ultra_gcn.py:step``)."""
    beta_pos = (1.0 / torch.clamp(du[uu], min=1.0)) * torch.sqrt(
        (du[uu] + 1.0) / (di[ii] + 1.0))
    beta_neg = (1.0 / torch.clamp(du[uu], min=1.0))[:, None] * torch.sqrt(
        (du[uu][:, None] + 1.0) / (di[neg] + 1.0))
    ue = params["u"][uu]
    pos_logit = (ue * params["i"][ii]).sum(-1)
    neg_logit = torch.einsum("bd,bnd->bn", ue, params["i"][neg])
    loss = ((1.0 + beta_pos) * _bce(pos_logit, 1.0)).mean()
    loss = loss + ((1.0 + beta_neg) * _bce(neg_logit, 0.0)).mean()
    # item-item constraint: pull the user towards co-items of its item
    ii_logit = torch.einsum("bd,bkd->bk", ue, params["i"][ii_nbrs])
    return loss + w_ii * _bce(ii_logit, 1.0).mean()


def recall_at(u: np.ndarray, i: np.ndarray, src: np.ndarray,
              dst: np.ndarray, k: int = 20) -> float:
    """Recall@k of the scores ``u @ i.T`` against the ``u-i`` edges
    (``ultra_gcn.py:105-119``)."""
    top = np.argsort(-(u @ i.T), axis=1)[:, :k]
    truth: Dict[int, set] = {}
    for s, d in zip(src, dst):
        truth.setdefault(int(s), set()).add(int(d))
    hits = total = 0
    for user in range(u.shape[0]):
        t = truth.get(user, set())
        if not t:
            continue
        hits += len(set(top[user].tolist()) & t)
        total += min(len(t), k)
    return hits / max(total, 1)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=DEFAULT_DIR)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--emb_dim", type=int, default=64)
    ap.add_argument("--neg_num", type=int, default=20)
    ap.add_argument("--w_ii", type=float, default=1.0)
    ap.add_argument("--ii_k", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    g, _, _ = load(args.data_dir, 16, dev)
    et = g.store.edge_table("u-i")
    ui = et.device(dev)
    ii_csr = g.store.edge_table("i-i").device(dev).out
    n_u, n_i = et.num_src_nodes, et.num_dst_nodes
    du = torch.as_tensor(et.out_degrees, dtype=torch.float32, device=dev)
    di = torch.as_tensor(et.in_degrees, dtype=torch.float32, device=dev)
    init = torch.Generator(device=dev).manual_seed(0)
    params = {
        "u": torch.nn.Parameter(0.1 * torch.randn(
            (n_u, args.emb_dim), generator=init, device=dev)),
        "i": torch.nn.Parameter(0.1 * torch.randn(
            (n_i, args.emb_dim), generator=init, device=dev))}
    opt = torch.optim.Adam(params.values(), lr=args.lr)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for step in range(args.steps):
        eidx = torch.as_tensor(rng.integers(0, et.num_edges, args.batch_size),
                               dtype=torch.int64, device=dev)
        uu, ii = ui.src[eidx], ui.dst[eidx]
        neg = negative_sample(ui, uu, args.neg_num, gen, "random")
        ii_nbrs, _ = topk_sample(ii_csr, ii, args.ii_k)
        loss = ultra_loss(params, uu, ii, neg, ii_nbrs, du, di, args.w_ii)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step % 100 == 0:
            print("step %d loss %.4f" % (step, float(loss.detach())),
                  flush=True)

    recall = recall_at(params["u"].detach().cpu().numpy(),
                       params["i"].detach().cpu().numpy(), et.src, et.dst)
    print("recall@20: %.4f" % recall, flush=True)
    return recall


if __name__ == "__main__":
    main()
