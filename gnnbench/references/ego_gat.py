"""The plain reference of ``models/ego_gat.py``: PyG's ogbn-products GAT
(``examples/ogbn_products_gat.py``: ``GATConv`` layers, each with a skip
``Linear`` beside it, ELU between) as its layer equations read, in plain
PyTorch and float32 (``reference.matmul`` is the one product, so the
control changes the products only).  It imports nothing of the program.

One conv, as ``GATConv`` computes it (``lin`` without bias, shared by
sources and targets; LeakyReLU 0.2; attention dropout 0): every source
row is projected, ``x'_j = lin(x_j)`` [H, W]; each head scores
``leaky_relu(att_src . x'_j + att_dst . x'_i)``; the softmax runs over the
neighbours and the self-loop; the output is the weighted sum of the
projected rows, heads concatenated (head-major) or averaged, then the
bias; the skip ``Linear`` of the target row is added.  The program
instead sums the raw rows by their weights and projects the sum once
(Kernel 3); that reassociation is what this file checks.

Departures from PyG, each the benchmark's:

* the ego tree: every sampled path is its own row (GraphLearn's
  EgoGraph), so a node drawn twice is projected twice; PyG's sampler
  de-duplicates each hop's nodes, so its layer 0 projects fewer rows and
  a node's neighbours are the de-duplicated draws;
* the self-loop is the target's own row appended after its neighbours,
  as ``add_self_loops`` appends it to a node's edges;
* dropout 0 (the configuration's ``reduced``);
* ``log_softmax`` + ``nll_loss`` is ``reference.cross_entropy``.

Leaves, by the names ``models/ego_gat.py ref_name`` gives: ``layer<i>.lin.
head<h>`` [W, Din] (head h's rows of PyG's ``lin.weight``),
``layer<i>.att.head<h>`` [1, 2 W] (``att_dst`` then ``att_src`` of head
h), ``layer<i>.bias`` [H, W] concatenated or [1, W] averaged (PyG's
``bias``), ``layer<i>.skip.weight`` [F, Din] and ``layer<i>.skip.bias``
[F].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from gnnbench.reference import matmul

SLOPE = 0.2
ACTS = {"elu": F.elu}


def gat_conv(x: torch.Tensor, nbr: torch.Tensor,
             p: Dict[str, torch.Tensor], i: int, spec: dict,
             tf32: bool) -> torch.Tensor:
    """Layer ``i`` on targets ``x`` [..., Din] with neighbours ``nbr``
    [..., k, Din]: [..., F]."""
    heads, concat = spec["heads"][i], spec["concat"][i]
    lead, din = x.shape[:-1], x.shape[-1]
    lin = torch.cat([p["layer%d.lin.head%d" % (i, h)]
                     for h in range(heads)])            # [H W, Din]
    att = torch.cat([p["layer%d.att.head%d" % (i, h)]
                     for h in range(heads)])            # [H, 2 W]
    w = lin.shape[0] // heads
    att_dst, att_src = att[:, :w], att[:, w:]
    src = (torch.cat([nbr, x.unsqueeze(-2)], dim=-2) if spec["self_loop"]
           else nbr)
    k = src.shape[-2]
    xs = matmul(src.reshape(-1, din), lin.t(), tf32).reshape(
        *lead, k, heads, w)                             # every source row
    xd = matmul(x.reshape(-1, din), lin.t(), tf32).reshape(*lead, heads, w)
    score = (xs * att_src).sum(-1) + (xd * att_dst).sum(-1).unsqueeze(-2)
    alpha = torch.softmax(F.leaky_relu(score, SLOPE), dim=-2)  # [..., k, H]
    out = (alpha.unsqueeze(-1) * xs).sum(dim=-3)        # [..., H, W]
    out = out.reshape(*lead, heads * w) if concat else out.mean(dim=-2)
    if spec["out_bias"]:
        out = out + p["layer%d.bias" % i].reshape(-1)
    if spec["residual"]:
        skip = matmul(x.reshape(-1, din), p["layer%d.skip.weight" % i].t(),
                      tf32) + p["layer%d.skip.bias" % i]
        out = out + skip.reshape(*lead, -1)
    return out


def logits(p: Dict[str, torch.Tensor], feats: torch.Tensor, batch,
           spec: dict, tf32: bool) -> torch.Tensor:
    """N layers on N hops ("hop1" ... "hopN" beside "seeds"), ``spec["act"]``
    between: layer i on (hop j, hop j + 1) for j in 0 ... N - 1 - i, hop 0
    the seeds, each time on the previous layer's outputs."""
    n = len(spec["dims"]) - 1
    if set(batch) != {"seeds"} | {"hop%d" % j for j in range(1, n + 1)}:
        raise ValueError("%d layers need hops 1 ... %d, not %s"
                         % (n, n, sorted(batch)))
    act = ACTS[spec["act"]]
    # [b, D], [b, k1, D], [b, k1, k2, D], ...
    xs = [feats[batch["seeds"]]] + [feats[batch["hop%d" % j]]
                                    for j in range(1, n + 1)]
    for i in range(n):
        xs = [gat_conv(xs[j], xs[j + 1], p, i, spec, tf32)
              for j in range(n - i)]
        if i < n - 1:
            xs = [act(x) for x in xs]
    return xs[0]
