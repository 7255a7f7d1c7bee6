"""The plain reference: what a sampled training step of any depth
computes, in plain PyTorch, float32, with TF32 off (or, for the control,
on).

It takes only what the benchmark made (edge arrays, features, labels, the
initial weights) and the ids that the program sampled, and works out
everything else again: the CSR that the samples must come from, the
deepest hop's means, the softmax cross-entropy, the gradients (autograd
over plain operations) and Adam's update.  A model's logits, as its layer
equations read, are that model's own reference, ``references/<model>.py``
(``logits(p, feats, batch, spec, tf32)``), which the catalog finds by the
configuration's ``model`` and ``follow`` is given.  Neither this module
nor those import anything of the program.

``follow`` runs the reference's own steps; ``matmul`` is the one place
where a product happens, so the control (``tf32=True``) changes the
products only: on the card TF32 tensor cores, on the CPU the operands
rounded to TF32's 10 mantissa bits.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


# ---------------------------------------------------------------------------
# products, in f32 or in TF32 for the control
# ---------------------------------------------------------------------------


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 number (1 + 10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in f32 (``tf32=False``) or on TF32 tensor cores; the flags
    are restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b`` in f32; with ``tf32`` as TF32 tensor cores compute it (on
    a CPU tensor emulated: both operands rounded to TF32, then an f32
    product; the backward's products take the rounded operands)."""
    if tf32 and not a.is_cuda:
        # the rounded values forward; the gradient passes through
        a = a + (to_tf32(a.detach()) - a.detach())
        b = b + (to_tf32(b.detach()) - b.detach())
    return a @ b


# ---------------------------------------------------------------------------
# the graph: membership of samples, the deepest hop's means
# ---------------------------------------------------------------------------


class EdgeIndex:
    """The directed edges (src -> dst) of a graph of ``n`` nodes, as sorted
    ``src * n + dst`` keys, with every node's out-degree: a CSR rebuilt
    from the edge arrays, for membership tests."""

    def __init__(self, src, dst, n: int, device):
        s = torch.as_tensor(src, device=device).long()
        d = torch.as_tensor(dst, device=device).long()
        self.n = n
        self.keys = torch.sort(s * n + d).values
        self.degree = torch.bincount(s, minlength=n)

    def bad_children(self, parent: torch.Tensor, child: torch.Tensor,
                     fill: int) -> int:
        """How many ``child`` ids [..., k] are not an out-neighbour of
        their ``parent`` [...] (a parent without out-edges must give
        ``fill``), or lie outside [0, n)."""
        p = parent.long().reshape(-1, 1).expand(-1, child.shape[-1])
        c = child.long().reshape(p.shape)
        out_of_range = (c < 0) | (c >= self.n) | (p < 0) | (p >= self.n)
        p = p.clamp(0, self.n - 1)
        c = c.clamp(0, self.n - 1)
        q = p * self.n + c
        pos = torch.searchsorted(self.keys, q).clamp(max=self.keys.numel() - 1)
        member = self.keys[pos] == q
        empty = self.degree[p] == 0
        ok = torch.where(empty, c == fill, member) & ~out_of_range
        return int((~ok).sum())

    def bad_seeds(self, seeds: torch.Tensor) -> int:
        """How many seeds lie outside [0, n)."""
        return int(((seeds < 0) | (seeds >= self.n)).sum())


def group_mean(feats: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The mean of each group of ``ids`` [..., k]'s rows: [prod(...), D]."""
    k = ids.shape[-1]
    rows = feats[ids.long().reshape(-1, k)]
    return rows.sum(dim=1) / k


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy: logsumexp minus the label's logit."""
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=1) - picked).mean()


# ---------------------------------------------------------------------------
# the reference's own training steps
# ---------------------------------------------------------------------------


def follow(logits_fn: Callable, spec: dict,
           params0: Dict[str, torch.Tensor],
           feats: torch.Tensor, labels: torch.Tensor, batches: List[dict],
           lr: float, tf32: bool = False, rows: Optional[int] = None,
           state: Optional[dict] = None) -> dict:
    """Train a copy of ``params0`` for ``len(batches)`` steps on the given
    ids: logits (``logits_fn``, a model's ``references/<model>.py``
    ``logits``), loss, gradients by autograd, then Adam (betas 0.9 /
    0.999, eps 1e-8, bias-corrected).  Adam starts from ``state``
    ("exp_avg" and "exp_avg_sq" by leaf, "step": the steps taken), or
    from nothing.  ``rows`` takes the loss over the first ``rows`` seeds
    only (the fault of a half batch).

    Returns "losses" [float per step], "logits" (step 1), "grads" (step 1,
    by leaf) and "params" (after the last step, by leaf)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    if state is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        t0 = 0
    else:
        m = {k: state["exp_avg"][k].clone() for k in params}
        v2 = {k: state["exp_avg_sq"][k].clone() for k in params}
        t0 = int(state["step"])
    out = {"losses": [], "logits": None, "grads": None}
    b1, b2 = BETAS
    with precision(tf32):
        for i, batch in enumerate(batches, 1):
            t = t0 + i
            z = logits_fn(params, feats, batch, spec, tf32)
            y = labels[batch["seeds"]]
            n = z.shape[0] if rows is None else rows
            loss = cross_entropy(z[:n], y[:n])
            grads = torch.autograd.grad(loss, list(params.values()))
            out["losses"].append(float(loss.detach()))
            if i == 1:
                out["logits"] = z.detach()
                out["grads"] = {k: g.detach().clone()
                                for k, g in zip(params, grads)}
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(EPS)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------


def rel_max_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| over max |ref|."""
    prog = prog.to(ref.device, torch.float32)
    return float((prog - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def moved_leaves(grads: Dict[str, torch.Tensor],
                 floor: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least ``floor`` times the median leaf's."""
    norms = leaf_norms(grads)
    med = float(torch.tensor(list(norms.values())).median())
    return [k for k, n in norms.items() if n >= floor * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms, |‖prog‖ - ‖ref‖|, over the larger of that
    leaf's reference norm and the median leaf's."""
    keep = list(ref) if keep is None else list(keep)
    pn, rn = leaf_norms({k: prog[k] for k in keep}), leaf_norms(
        {k: ref[k] for k in keep})
    med = float(torch.tensor(list(rn.values())).median())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}

