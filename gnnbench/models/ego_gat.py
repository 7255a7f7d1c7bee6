"""PyG's ogbn-products GAT as the port trains it at scale: the port's
``EgoGAT`` with concatenated heads, self-loops, a bias after aggregation
and a skip ``Linear`` a layer, ELU between, trained by the port's own
N-hop ``bench.MultiStep`` body: the rows of the seeds and of every hop
gathered by Kernel 1 (the deepest reaches the model as the plan's
``DeferredRows``, since attention cannot be pre-averaged), each block on
Kernel 3 forward and backward, softmax cross-entropy, fused Adam.  Its
plain reference is ``references/ego_gat.py``; its counts are
``flops_gat.py``."""

from __future__ import annotations

import re
from typing import Dict, List

import torch
import torch.nn.functional as F

from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT

from gnnbench import flops, flops_gat
from gnnbench.steps import RecordedSteps, hop_aliases

ACTS = {"elu": F.elu}

_LEAVES = (
    (r"layers\.(\d+)\.convs\.0\.x_(\d+)\.weight", "layer%s.lin.head%s"),
    (r"layers\.(\d+)\.convs\.0\.attn_(\d+)\.weight", "layer%s.att.head%s"),
    (r"layers\.(\d+)\.convs\.0\.bias", "layer%s.bias"),
    (r"layers\.(\d+)\.convs\.0\.skip\.(weight|bias)", "layer%s.skip.%s"),
)


def build(cfg: dict, decoder, device) -> torch.nn.Module:
    """``EgoGAT`` at ``cfg``'s widths (``dims``: each head's width),
    heads, ``concat`` and ``act``, no dropout; ``self_loop``, ``out_bias``
    and ``residual`` on together are the port's one option ``pyg``, and
    off together its default.  Its weights are set by the harness."""
    parts = {k: cfg[k] for k in ("self_loop", "out_bias", "residual")}
    if len(set(parts.values())) != 1:
        raise ValueError("the port's EgoGAT takes the self-loop, the bias "
                         "after aggregation and the skip together, got %s"
                         % parts)
    return EgoGAT(cfg["dims"], decoder, num_heads=cfg["heads"],
                  act=ACTS[cfg["act"]], concat=cfg["concat"],
                  pyg=cfg["self_loop"], device=device)


def ref_name(port_name: str) -> str:
    """The port's leaf -> the reference's (``references/ego_gat.py``)."""
    for pattern, name in _LEAVES:
        m = re.fullmatch(pattern, port_name)
        if m is not None:
            return name % m.groups()
    raise ValueError("unexpected EgoGAT leaf %r" % port_name)


class Steps(RecordedSteps):
    """The port's ``bench.MultiStep`` body as it is, on every hop of the
    query; ``RecordedSteps`` gives it its spans and ``keep`` (with no
    means: nothing is pre-averaged)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.deep_op is not None:
            raise ValueError("attention gathers its deepest hop; the step "
                             "would pre-average it with %r" % self.deep_op)


def step_work(cfg: dict, traffic: dict) -> flops.Work:
    return flops_gat.gat_step(traffic["batch"], traffic["fanout"],
                              cfg["dims"], cfg["heads"], cfg["concat"],
                              cfg["self_loop"], cfg["out_bias"],
                              cfg["residual"])


def kernel_work(cfg: dict, traffic: dict, rec: Dict[str, torch.Tensor],
                itemsize: int) -> Dict[str, List[flops.Work]]:
    """The work of each kernel launch of one step, by operator: Kernel 1
    on the rows of the seeds and of every hop; Kernel 3 forward and
    backward on each block of each layer (the blocks' rows are f32, the
    encoder's output; the first layer takes no gradient of its rows)."""
    d = cfg["dims"][0]
    fanout = traffic["fanout"]
    rows = flops_gat.hop_rows(traffic["batch"], fanout)
    gathers = [flops.gather_rows(int(torch.unique(rec[a]).numel()),
                                 rec[a].numel(), d, itemsize)
               for a in ("seeds",) + hop_aliases(fanout)]
    fwd, bwd = [], []
    layers = flops_gat.layers(cfg["dims"], cfg["heads"], cfg["concat"])
    for i, (din, h, w, _) in enumerate(layers):
        for j in range(len(fanout) - i):
            n = fanout[j] + int(cfg["self_loop"])
            fwd.append(flops_gat.block_forward(rows[j], n, din, h, w, 4))
            bwd.append(flops_gat.block_backward(rows[j], n, din, h, w, 4,
                                                d_nbr=i > 0))
    return {"glt::gather_rows": gathers, "glt::gat_block": fwd,
            "glt::gat_block_backward": bwd}
