"""The models' plain references: ``references/ego_sage.py`` at two layers
gives, to the bit, the two-layer logits and gradients the reference had
before it took any depth."""

import pytest
import torch

from gnnbench.catalog import Catalog
from gnnbench.reference import matmul


def _sage_conv(x, nbr, w, bias, tf32):
    h = torch.cat([x, nbr.mean(dim=-2)], dim=-1)
    out = matmul(h.reshape(-1, h.shape[-1]), w.t(), tf32)
    if bias is not None:
        out = out + bias
    return out.reshape(*h.shape[:-1], -1)


def _two_layer_logits(p, feats, batch, spec, tf32):
    """The two-layer ``sage_logits`` as it was written before any depth."""
    x0 = feats[batch["seeds"]]
    x1 = feats[batch["hop1"]]
    x2 = feats[batch["hop2"]]
    w0, w1 = p["layer0.weight"], p["layer1.weight"]
    b0, b1 = p.get("layer0.bias"), p.get("layer1.bias")
    h_src = torch.relu(_sage_conv(x0, x1, w0, b0, tf32))
    h_hop = torch.relu(_sage_conv(x1, x2, w0, b0, tf32))
    return _sage_conv(h_src, h_hop, w1, b1, tf32)


def _inputs(dims, fanout, bias, seed=3):
    gen = torch.Generator().manual_seed(seed)
    n, b = 200, 8
    feats = torch.randn(n, dims[0], generator=gen)
    p = {}
    for i, (din, dout) in enumerate(zip(dims, dims[1:])):
        p["layer%d.weight" % i] = torch.randn(dout, 2 * din, generator=gen)
        if bias:
            p["layer%d.bias" % i] = torch.randn(dout, generator=gen)
    batch, shape = {"seeds": torch.randint(0, n, (b,), generator=gen)}, [b]
    for j, k in enumerate(fanout, 1):
        shape.append(k)
        batch["hop%d" % j] = torch.randint(0, n, shape, generator=gen)
    spec = {"agg": "mean", "dims": dims}
    return p, feats, batch, spec


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_two_layers_give_the_old_logits_to_the_bit(bias, tf32):
    logits = Catalog().module("references", "ego_sage").logits
    p, feats, batch, spec = _inputs([12, 16, 5], [4, 3], bias)
    outs = []
    for fn in (logits, _two_layer_logits):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        z = fn(leaves, feats, batch, spec, tf32)
        grads = torch.autograd.grad(z.square().sum(), list(leaves.values()))
        outs.append([z.detach()] + list(grads))
    for new, old in zip(*outs):
        assert torch.equal(new, old)


def test_the_depth_is_the_batch_hops():
    logits = Catalog().module("references", "ego_sage").logits
    p, feats, batch, spec = _inputs([12, 16, 16, 5], [4, 3, 2], True)
    assert logits(p, feats, batch, spec, False).shape == (8, 5)
    del batch["hop3"]
    with pytest.raises(ValueError):
        logits(p, feats, batch, spec, False)
