"""Operations and bytes of the GAT cells (``models/ego_gat.py``): the
yardstick of their ``train_mfu``, ``step_mfu`` and Kernel 3's roofline
shares, under ``flops.py``'s rules (the least work the layer equations
need, forward plus backward, with no recompute; contractions as
``products``, the rest as ``other``).

The least association.  A conv never needs its neighbours projected: each
head's score of a source row is ``x_j . v_h`` with ``v_h = W_h att_src_h``
(and the target's ``x_i . u_h``, ``u_h = W_h att_dst_h``), and the
weighted sum of the projected rows is ``(sum_j coef_j x_j) W_h``, one
product on each target's row.  At fanout 11 that is about 1/11 of the
projections' products, so a count of projected rows could read above
100% of a kernel that takes this association (Kernel 3 does).

A layer is ``(din, heads, width, out)``: ``out`` = heads * width where
the heads are concatenated, else width.  A block is b targets of ``n``
source rows each (the fanout, plus the self row).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from gnnbench.flops import Work, adam, cross_entropy

# elementwise work of the attention a (target, source row, head): the
# target's term added, the leaky relu, the exponential, the sum and the
# division of the softmax; in the backward the softmax's and the leaky
# relu's
SOFTMAX = 5.0


def layers(dims: Sequence[int], heads: Sequence[int],
           concat: Sequence[bool]) -> List[Tuple[int, int, int, int]]:
    """``(din, heads, width, out)`` of each layer: ``dims[i + 1]`` is each
    head's width, and a layer that concatenates hands ``heads * width``
    features on."""
    out, din = [], dims[0]
    for h, w, c in zip(heads, dims[1:], concat):
        f = h * w if c else w
        out.append((din, h, w, f))
        din = f
    return out


def block_forward(b: int, n: int, din: int, h: int, w: int,
                  itemsize: int) -> Work:
    """Kernel 3's forward on one block: ``v_h``, each row's score, the
    softmax, ``a_h = sum_j coef_j x_j`` and ``a_h W_h``.  Bytes: ``nbr``
    [b, n, din] whole, the weights, ``att_src``, the targets' scores read,
    the output [H, b, W] written."""
    products = (2.0 * h * din * w           # v
                + 2.0 * b * n * din * h     # scores
                + 2.0 * b * n * din * h     # a
                + 2.0 * b * h * din * w)    # a W
    return Work(products=products, other=SOFTMAX * b * n * h,
                bytes=float(b * n * din * itemsize
                            + 4 * (h * din * w + h * w + h * b + h * b * w)))


def block_backward(b: int, n: int, din: int, h: int, w: int, itemsize: int,
                   d_nbr: bool) -> Work:
    """Kernel 3's backward on one block, given the output's gradient g:
    ``d_a = g W_h^T``, ``d_W += a^T g``, each row's ``d_coef = d_a . x_j``,
    the softmax's and leaky relu's backward, ``d_v = sum d_z x_j``, then
    ``d_att_src = W_h^T d_v`` and ``d_W += d_v att_src^T``, each target's
    score gradient, and with ``d_nbr`` each row's ``coef d_a + d_z v``.
    Bytes: g, the block's inputs, and the gradients written."""
    products = (2.0 * b * h * w * din * 2       # d_a, d_W
                + 2.0 * b * n * din * h * 2     # d_coef, d_v
                + 2.0 * h * din * w * 2)        # d_att_src, d_W from d_v
    if d_nbr:
        products += 2.0 * b * n * din * h * 2
    grads = h * din * w + h * w + h * b + (b * n * din if d_nbr else 0)
    return Work(products=products, other=(SOFTMAX + 1.0) * b * n * h,
                bytes=float(b * n * din * itemsize
                            + 4 * (h * b * w + h * din * w + h * w + h * b
                                   + grads)))


def hop_rows(b: int, fanout: Sequence[int]) -> List[int]:
    """Rows of hop 0 (the seeds) ... hop N."""
    rows = [b]
    for k in fanout:
        rows.append(rows[-1] * k)
    return rows


def n_params(dims, heads, concat, out_bias: bool, residual: bool) -> int:
    """The model's parameters: per layer ``lin``, ``att_src`` and
    ``att_dst``, the bias and the skip."""
    total = 0
    for din, h, w, f in layers(dims, heads, concat):
        total += h * w * din + 2 * h * w
        total += f if out_bias else 0
        total += din * f + f if residual else 0
    return total


def gat_step(b: int, fanout: Sequence[int], dims: Sequence[int],
             heads: Sequence[int], concat: Sequence[bool], self_loop: bool,
             out_bias: bool, residual: bool) -> Work:
    """One training step of the GAT on an N-hop batch of ``b`` seeds: every
    layer forward (layer i on hops 0 ... N - 1 - i, each row with its
    neighbours in the next hop, plus itself with ``self_loop``), ELU
    between, the loss, the weight gradients (the features take none; the
    inputs of layers 1 ... N - 1 do) and Adam.  Each block is counted as
    Kernel 3's (:func:`block_forward`, :func:`block_backward`) less the
    work on the weights alone, which a layer does once for all its
    blocks."""
    n_hops = len(fanout)
    if len(dims) != n_hops + 1:
        raise ValueError("%d layers on %d hops" % (len(dims) - 1, n_hops))
    rows = hop_rows(b, fanout)
    total = Work()
    for i, (din, h, w, f) in enumerate(layers(dims, heads, concat)):
        weights = 2.0 * h * din * w
        # v and u; d att_src, d att_dst and their terms of d W
        total += Work(products=2 * weights + 4 * weights)
        elementwise = (0 if concat[i] else h * w) + (f if out_bias else 0) \
            + (f if i < n_hops - 1 else 0)   # heads' mean, bias, ELU
        for j in range(n_hops - i):
            r, n = rows[j], fanout[j] + int(self_loop)
            fwd = block_forward(r, n, din, h, w, 4)
            bwd = block_backward(r, n, din, h, w, 4, d_nbr=i > 0)
            total += Work(products=fwd.products - weights
                          + bwd.products - 2 * weights,
                          other=fwd.other + bwd.other)
            # the target's score x_i . u, forward and its two gradients
            total += Work(products=2.0 * r * din * h * (3 if i else 2),
                          other=2.0 * r * elementwise)
            if residual:  # forward, d W_skip, and d x where it is taken
                total += Work(products=2.0 * r * din * f * (3 if i else 2),
                              other=3.0 * r * f)
            if i > 0 and self_loop:  # the self row's gradient added
                total += Work(other=float(r * din))
    params = n_params(dims, heads, concat, out_bias, residual)
    return total + cross_entropy(b, dims[-1]) + adam(params)
