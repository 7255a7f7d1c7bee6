"""The plain reference of ``models/ego_sage.py``: EgoGraphSAGE's logits, as
its layer equations read, in plain PyTorch (``reference.matmul`` is the one
product, so the control changes the products only).  It imports nothing of
the program."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gnnbench.reference import matmul


def sage_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor], tf32: bool) -> torch.Tensor:
    """One GraphSAGE conv with mean aggregation (PyG's ``SAGEConv``):
    ``W_r x + W_l mean(nbr) + bias``, with ``W = [W_r, W_l]`` [out, 2 din]
    taken as one matrix over ``[x, mean(nbr)]``.  ``x`` [..., din],
    ``nbr`` [..., k, din]."""
    h = torch.cat([x, nbr.mean(dim=-2)], dim=-1)
    out = matmul(h.reshape(-1, h.shape[-1]), w.t(), tf32)
    if bias is not None:
        out = out + bias
    return out.reshape(*h.shape[:-1], -1)


def logits(p: Dict[str, torch.Tensor], feats: torch.Tensor, batch,
           spec: dict, tf32: bool) -> torch.Tensor:
    """EgoGraphSAGE, agg "mean", N layers on N hops ("hop1" ... "hopN"
    beside "seeds"), relu between: layer i on (hop j, hop j + 1) for j in
    0 ... N - 1 - i, hop 0 the seeds, each time on the previous layer's
    outputs.  ``p``: "layer<i>.weight" [dims[i + 1], 2 dims[i]] and, where
    the configuration has them, "layer<i>.bias" [dims[i + 1]]."""
    if spec["agg"] != "mean":
        raise ValueError("the reference computes agg 'mean' only")
    n = len(spec["dims"]) - 1
    if set(batch) != {"seeds"} | {"hop%d" % j for j in range(1, n + 1)}:
        raise ValueError("%d layers need hops 1 ... %d, not %s"
                         % (n, n, sorted(batch)))
    # [b, D], [b, k1, D], [b, k1, k2, D], ...
    xs = [feats[batch["seeds"]]] + [feats[batch["hop%d" % j]]
                                    for j in range(1, n + 1)]
    for i in range(n):
        w, bias = p["layer%d.weight" % i], p.get("layer%d.bias" % i)
        xs = [sage_conv(xs[j], xs[j + 1], w, bias, tf32)
              for j in range(n - i)]
        if i < n - 1:
            xs = [torch.relu(x) for x in xs]
    return xs[0]
