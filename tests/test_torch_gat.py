"""The port's GAT slice on the CPU: ``gat_block_plain`` against the Pallas
probe kernel (interpret mode) and its unfused formula, ``EgoGATConv`` and
``EgoGAT`` against flax with carried weights (forward and gradients), and
the flax <-> torch weight round trip; and the arithmetic and the shape rule
of the card's tensor-core products, restated in plain torch."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.nn.layers.ego import EgoGATConv as JaxEgoGATConv
from graph_learn_tpu.nn.models.ego_gnn import EgoGAT as JaxEgoGAT
from graph_learn_tpu_torch import Decoder
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.layers.ego import EgoGATConv, EgoLayer
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT
from graph_learn_tpu_torch.ops.kernels import gat
from torch_parity import assert_trees_close, ego_pair, flax_grad_tree

# f32 on both sides; projections, scores and the softmax-weighted sums are
# summed in other orders by the two frameworks
TOL = dict(rtol=1e-5, atol=1e-5)
# gradients of a sum of squares multiply those errors by activations of
# O(1..10) and sum them over the batch
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- (a) the plain version against the Pallas kernel it replaces -------

def _probe_inputs(S, k2, D, H, W, n_blocks, seed=0):
    rng = np.random.default_rng(seed)
    n_seeds = S * n_blocks
    x = rng.standard_normal((n_seeds * k2, D)).astype(np.float32)
    w = (rng.standard_normal((H, D, W)) * 0.1).astype(np.float32)
    al = (rng.standard_normal((H, 1, W)) * 0.1).astype(np.float32)
    ar = (rng.standard_normal((H, 1, W)) * 0.1).astype(np.float32)
    return x, w, al, ar


def _port_on_probe_layout(x, w, al, ar, k2):
    """gat_block on the probe's inputs: the self term is each group's
    first row, el = (nbr[:, 0] . w) . a_l."""
    nbr = torch.from_numpy(x).reshape(-1, k2, x.shape[1])
    wn = torch.from_numpy(w)
    el = (torch.einsum("sd,hdw->hsw", nbr[:, 0], wn)
          * torch.from_numpy(al)).sum(-1)
    return gat.gat_block(nbr, wn, torch.from_numpy(ar[:, 0]), el).numpy()


def test_gat_block_plain_matches_the_pallas_probe_kernel():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    from segment_softmax_probe import make_pallas
    from jax.experimental.pallas import tpu as pltpu

    S, k2, D, H, W, n_blocks = 8, 4, 128, 2, 128, 2
    x, w, al, ar = _probe_inputs(S, k2, D, H, W, n_blocks)
    fused = make_pallas(S, k2, D, H, W, n_blocks)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(al), jnp.asarray(ar)))
    out = _port_on_probe_layout(x, w, al, ar, k2)
    assert out.shape == ref.shape == (H, S * n_blocks, W)
    # f32 dots of depth 128 in another order: 1e-5
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("shape", [(8, 4, 128, 2, 128, 2),
                                   (5, 10, 12, 3, 7, 3)])
def test_gat_block_plain_matches_the_probes_unfused_formula(shape):
    # fwd_ref of examples/segment_softmax_probe.py:124-132 (a local
    # function there), restated
    S, k2, D, H, W, n_blocks = shape
    x, w, al, ar = _probe_inputs(*shape, seed=1)
    n_seeds = S * n_blocks
    wx = jnp.einsum("nd,hdw->nhw", x, w)
    er = (wx * ar[:, 0][None]).sum(-1).reshape(n_seeds, k2, H)
    el = (wx * al[:, 0][None]).sum(-1).reshape(n_seeds, k2, H)[:, :1]
    alpha = jax.nn.softmax(jax.nn.leaky_relu(el + er, negative_slope=0.2),
                           axis=1)
    ref = jnp.einsum("skh,skhw->hsw", alpha, wx.reshape(n_seeds, k2, H, W))
    np.testing.assert_allclose(_port_on_probe_layout(x, w, al, ar, k2),
                               np.asarray(ref), **TOL)


def test_gat_block_checks_its_arguments():
    nbr = torch.zeros((4, 3, 5))
    wn, ar, el = torch.zeros((2, 5, 6)), torch.zeros((2, 6)), torch.zeros(
        (2, 4))
    assert gat.gat_block(nbr, wn, ar, el).shape == (2, 4, 6)
    bad = [
        (nbr, torch.zeros((2, 4, 6)), ar, el),  # Din mismatch
        (nbr, wn, torch.zeros((2, 5)), el),  # ar shape
        (nbr, wn, ar, torch.zeros((4, 2))),  # el shape
        (nbr.double(), wn, ar, el),  # dtype
        (nbr.transpose(0, 1), wn, ar, el.t().contiguous()),  # not contiguous
        (torch.zeros((4, 0, 5)), wn, ar, el),  # no neighbours
        (nbr.to("meta"), wn.to("meta"), ar.to("meta"), el.to("meta")),
    ]
    before = (gat.LAUNCHES_FWD.count, gat.LAUNCHES_BWD.count)
    for args in bad:
        with pytest.raises(InvalidArgumentError):
            gat.gat_block(*args)
    with pytest.raises(InvalidArgumentError):
        gat.gat_block(nbr, wn, ar, el, bn=torch.zeros((2, 5)))
    # the plain version on CPU tensors is no launch
    assert (gat.LAUNCHES_FWD.count, gat.LAUNCHES_BWD.count) == before


# --- (a') the tensor-core products' arithmetic and route rule ----------

# chip_smoke.py's limit for gat_block: errors relative to the largest
# reference value of the tensor
GAT_TOL = 2e-4


def _product_inputs(depth, seed, m=24, n=40):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, depth)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((depth, n))
                          * depth ** -0.5).astype(np.float32))
    return a, b, a.double() @ b.double()


def _rel_err(got, exact):
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


@pytest.mark.parametrize("rounded", [True, False])
def test_split_tf32_parts_are_tf32_numbers_and_sum_to_the_input(rounded):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-6, 6, 4096)
                          ).astype(np.float32))
    hi, lo = gat.split_tf32(x, rounded)
    for part in (hi, lo):  # TF32 numbers: the low 13 mantissa bits are 0
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi within 2^-11 of x when rounded to nearest, 2^-10 when cut
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** (-11 if rounded
                                                    else -10)).all())
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0 ** -20).all())
    # rounding has no preferred side; cutting leaves every |hi| below |x|
    above = (hi.abs() > x.abs()).float().mean().item()
    assert (0.4 < above < 0.6) if rounded else above == 0.0, above


@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("depth", [128, 15_360])
def test_split_tf32_product_holds_the_kernel_tolerance(depth, rounded):
    # the three-pass product of csrc/gat_mma.cuh, emulated, in both its
    # grades: far inside the limit the card's kernel is held to, at the
    # depths of the three products of the training path (K' = 128 and
    # b = 15 360)
    a, b, exact = _product_inputs(depth, seed=depth)
    err = _rel_err(gat.split_tf32_matmul(a, b, rounded=rounded), exact)
    assert err <= GAT_TOL / 20, err
    # and about as good as the plain f32 product
    assert err <= 4 * _rel_err(a @ b, exact) + 1e-7


@pytest.mark.parametrize("depth", [128, 15_360])
def test_a_single_tf32_pass_does_not_hold_the_kernel_tolerance(depth):
    # why the operands are split: one pass keeps about three digits
    a, b, exact = _product_inputs(depth, seed=depth)
    one = _rel_err(gat.split_tf32_matmul(a, b, passes=1), exact)
    three = _rel_err(gat.split_tf32_matmul(a, b), exact)
    assert one > GAT_TOL, one
    assert one > 100 * three


@pytest.mark.parametrize("w,route", [(256, "tensor"), (32, "tensor"),
                                     (12, "tensor"), (4, "tensor"),
                                     (5, "fma"), (1, "fma"), (130, "fma")])
def test_product_route_is_decided_by_the_width_alone(w, route):
    assert gat.product_route(w) == route


def test_training_path_shapes_take_the_tensor_core_route():
    # EgoGAT([128, 256, 32], num_heads=[8, 1]): widths 256, 256 and 32
    assert {gat.product_route(w) for w in (256, 256, 32)} == {"tensor"}


@pytest.mark.parametrize("k,w,kernel", [
    (128, 256, "wgmma"), (128, 32, "wgmma"), (4, 4, "wgmma"),
    (125, 12, "wgmma"),          # K' padded to 128: still fits
    (129, 256, "mma.sync"),      # a bias on Din = 128: padded to 132
    (256, 32, "mma.sync"), (128, 5, "fma"), (256, 130, "fma")])
def test_forward_product_kernel_is_decided_by_depth_and_width(k, w, kernel):
    assert gat.forward_product_kernel(k, w) == kernel


def test_training_path_forward_products_take_wgmma_in_the_first_layer():
    # EgoGAT([128, 256, 32], num_heads=[8, 1]): (depth, width) of a step's
    # three calls; the second layer's depth does not fit in shared memory
    kernels = [gat.forward_product_kernel(k, w)
               for k, w in ((128, 256), (128, 256), (256, 32))]
    assert kernels == ["wgmma", "wgmma", "mma.sync"]
    assert gat.WGMMA_MAX_DEPTH == 128  # csrc/gat_wgmma.cuh kMaxDepth
    from graph_learn_tpu_torch.ops.kernels import build
    header = (build.SRC_DIR / "gat_wgmma.cuh").read_text()
    assert "kBK = 32" in header and "kMaxDepth = 4 * kBK" in header


@pytest.mark.parametrize("k,lda", [(128, 128), (129, 132), (1, 4), (5, 8),
                                   (100, 100), (101, 104)])
def test_padded_depth_rounds_rows_up_to_16_bytes(k, lda):
    assert gat.padded_depth(k) == lda
    assert lda % 4 == 0 and 0 <= lda - k < 4


def test_scratch_shapes_follow_the_padded_depth():
    t = gat._scratch(dict(nbr=torch.zeros((7, 3, 5)),
                          wn=torch.zeros((2, 6, 9))),
                     ("v", "a", "da", "dv", "bt_hi", "bt_lo", "out", "d_wn",
                      "d_ar", "d_el", "d_nbr"))
    shapes = {n: tuple(t[n].shape) for n in t if n not in ("nbr", "wn")}
    assert shapes == dict(v=(2, 6), dv=(2, 6), a=(2, 7, 8), da=(2, 7, 8),
                          bt_hi=(2, 9, 8), bt_lo=(2, 9, 8), out=(2, 7, 9),
                          d_nbr=(7, 3, 5), d_wn=(2, 6, 9), d_ar=(2, 9),
                          d_el=(2, 7))
    assert all(t[n].dtype == torch.float32 for n in shapes)


def test_gat_parts_refuses_cpu_tensors():
    with pytest.raises(InvalidArgumentError, match="CUDA"):
        gat.GatParts(torch.zeros((4, 3, 5)), torch.zeros((2, 5, 8)),
                     torch.zeros((2, 8)), torch.zeros((2, 4)),
                     torch.zeros((2, 4, 8)))


# --- (b) EgoGATConv against flax -----------------------------------------

def _load_conv(tconv, params):
    with torch.no_grad():
        for name, dense in params["params"].items():
            lin = getattr(tconv, name)
            lin.weight.copy_(torch.from_numpy(np.array(dense["kernel"]).T))
            if "bias" in dense:
                lin.bias.copy_(torch.from_numpy(np.array(dense["bias"])))
    assert sorted(n for n, _ in tconv.named_children()) == sorted(
        params["params"])


def _conv_grads(tconv):
    return {"params": {
        name: {"kernel": lin.weight.grad.numpy().T,
               **({"bias": lin.bias.grad.numpy()} if lin.bias is not None
                  else {})}
        for name, lin in tconv.named_children()}}


CONV_CASES = {
    "homo_1head": dict(in_dim=6, num_head=1, use_bias=False),
    "homo_3heads": dict(in_dim=4, num_head=3, use_bias=False),
    "homo_bias": dict(in_dim=6, num_head=2, use_bias=True),
    "hetero_bias_3heads": dict(in_dim=(6, 7), num_head=3, use_bias=True),
    "hetero_1head": dict(in_dim=(4, 5), num_head=1, use_bias=False),
}


@pytest.mark.parametrize("seed_chunk", [0, 8, None])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_ego_gat_conv_matches_flax_forward_and_gradients(case, seed_chunk):
    kw = CONV_CASES[case]
    b, e, dout = 21, 4, 5  # 21 % 8 != 0: a ragged last chunk
    din = kw["in_dim"] if isinstance(kw["in_dim"], tuple) else (
        kw["in_dim"], kw["in_dim"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, din[0])).astype(np.float32)
    nbr = rng.standard_normal((b * e, din[1])).astype(np.float32)
    chunk_kw = {} if seed_chunk is None else {"seed_chunk": seed_chunk}
    jconv = JaxEgoGATConv(out_dim=dout, **kw, **chunk_kw)
    params = jconv.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(nbr),
                        e)
    if kw["use_bias"]:  # flax zero-initialises biases: make them count
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.1 * (1 + np.arange(a.size, dtype=np.float32)
                                    ).reshape(a.shape)
            if p[-1].key == "bias" else a, params)
    tconv = EgoGATConv(out_dim=dout, **kw, **chunk_kw)
    _load_conv(tconv, _np(params))

    def jloss(p, xx, nn_):
        return (jconv.apply(p, xx, nn_, e) ** 2).sum()

    ref = np.asarray(jconv.apply(params, jnp.asarray(x), jnp.asarray(nbr), e))
    gp, gx, gn = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(nbr))
    tx = torch.from_numpy(x).requires_grad_(True)
    tn = torch.from_numpy(nbr).requires_grad_(True)
    out = tconv(tx, tn, e)
    assert out.shape == (b, dout) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn), **GRAD_TOL)
    assert_trees_close(_conv_grads(tconv), _np(gp), **GRAD_TOL)


def test_ego_gat_conv_chunked_equals_unchunked_and_auto_rule():
    rng = np.random.default_rng(4)
    b, e, din = 21, 4, 6
    x = torch.from_numpy(rng.standard_normal((b, din)).astype(np.float32))
    nbr = torch.from_numpy(
        rng.standard_normal((b * e, din)).astype(np.float32))
    convs = {c: EgoGATConv(din, 5, num_head=2, seed_chunk=c)
             for c in (0, 8, 1)}
    outs = {}
    for c, conv in convs.items():
        gen = torch.Generator().manual_seed(1)  # the same weights in each
        for m in conv.children():
            m.weight.data.normal_(0, 0.5, generator=gen)
        outs[c] = conv(x, nbr, e)
    # chunking only regroups whole seeds: equal to rounding
    for c in (8, 1):
        np.testing.assert_allclose(outs[c].detach().numpy(),
                                   outs[0].detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
    # AUTO: chunks of 256 seeds only when heads * width >= 1024; the
    # chunked calls are visible as several calls of the block
    calls = []
    plain = gat.gat_block_plain

    def spy(nbr_c, *args):
        calls.append(nbr_c.shape[0])
        return plain(nbr_c, *args)

    gat.gat_block_plain = spy
    try:
        big = torch.zeros((300, 3))
        nbig = torch.zeros((600, 3))
        EgoGATConv(3, 256, num_head=4)(big, nbig, 2)
        EgoGATConv(3, 8, num_head=4)(big, nbig, 2)
    finally:
        gat.gat_block_plain = plain
    assert calls == [256, 44, 300]


def test_ego_gat_conv_attention_dropout_uses_the_given_generator():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32))
    nbr = torch.from_numpy(rng.standard_normal((27, 4)).astype(np.float32))
    conv = EgoGATConv(4, 5, num_head=2, attn_dropout=0.5)
    gen = torch.Generator().manual_seed(0)
    for m in conv.children():
        m.weight.data.normal_(0, 0.5, generator=gen)

    def run(seed, training=True):
        g = torch.Generator().manual_seed(seed)
        return conv(x, nbr, 3, training=training, generator=g)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    # not training: no dropout, whatever the generator
    assert torch.equal(run(1, training=False), conv(x, nbr, 3))
    assert not torch.equal(run(1), conv(x, nbr, 3))
    # EgoLayer hands training / generator through to its conv
    layer = EgoLayer([conv])
    g = torch.Generator().manual_seed(1)
    assert torch.equal(layer([x, nbr], [3], training=True, generator=g)[0],
                       run(1))


# --- (c) the EgoGAT model against flax -----------------------------------

def _ego_pair(d, deferred):
    return ego_pair(d, "deferred" if deferred else "materialised")[:2]


def _gat_models(d, heads, dims_tail=(16, 4)):
    jmodel = JaxEgoGAT([d, *dims_tail], JaxDecoder(attr_types=["float"] * d),
                       num_heads=heads)
    tmodel = EgoGAT([d, *dims_tail], Decoder(attr_types=["float"] * d),
                    num_heads=heads, device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("heads", [[3, 1], None])
def test_ego_gat_model_matches_flax_forward_and_gradients(heads, deferred):
    d = 8
    jego, tego = _ego_pair(d, deferred)
    plain, _ = _ego_pair(d, False)
    jmodel, tmodel = _gat_models(d, heads)
    params = jmodel.init(jax.random.key(0), plain, training=False)
    load_flax_params(tmodel, _np(params))
    ref = np.asarray(jmodel.apply(params, jego, training=False))
    out = tmodel(tego)
    assert out.shape == (6, 4)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    grads = jax.grad(lambda p: (jmodel.apply(p, jego) ** 2).sum())(params)
    (out ** 2).sum().backward()
    assert_trees_close(flax_grad_tree(tmodel), _np(grads), **GRAD_TOL)


def test_ego_gnn_keeps_attention_dropout_off_as_the_jax_model_does():
    # EgoGNN hands `training` to its own dropout only, never to the convs
    # (graph_learn_tpu/nn/models/ego_gnn.py:110): with attn_dropout set,
    # a training forward still equals the flax model's, which draws nothing
    d = 8
    jego, tego = _ego_pair(d, False)
    dims = [d, 16, 4]
    jmodel = JaxEgoGAT(dims, JaxDecoder(attr_types=["float"] * d),
                       num_heads=[2, 1], attn_dropout=0.5)
    tmodel = EgoGAT(dims, Decoder(attr_types=["float"] * d),
                    num_heads=[2, 1], attn_dropout=0.5, device="cpu")
    params = jmodel.init(jax.random.key(0), jego, training=False)
    load_flax_params(tmodel, _np(params))
    ref = np.asarray(jmodel.apply(params, jego, training=True))
    with torch.no_grad():
        out = tmodel(tego, training=True,
                     generator=torch.Generator().manual_seed(0))
        assert torch.equal(out, tmodel(tego, training=False))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_ego_gat_rejects_a_preaggregated_deepest_hop():
    _, tego = _ego_pair(8, False)
    h2 = tego.hops[1]
    agg = h2.float_attrs.reshape(-1, 4, 8).mean(1)
    pre = tego.replace(hops=[tego.hops[0], h2.replace(
        float_attrs=tdata.PreAggregatedRows(agg, "mean"))])
    _, tmodel = _gat_models(8, [2, 2])
    with pytest.raises(InvalidArgumentError):
        tmodel(pre)


# --- (d) weights to and from flax ---------------------------------------

@pytest.mark.parametrize("heads", [[3, 1], [2, 2]])
def test_flax_params_round_trip(heads):
    d = 8
    plain, _ = _ego_pair(d, False)
    jmodel, tmodel = _gat_models(d, heads)
    params = _np(jmodel.init(jax.random.key(1), plain, training=False))
    load_flax_params(tmodel, params)
    back = to_flax_params(tmodel)
    assert_trees_close(back, params, rtol=0, atol=0)
    # homo layers share x and n weights: the tree holds no n_<h>
    conv = params["params"]["layers_0"]["convs_0"]
    assert sorted(conv) == sorted(
        ["x_%d" % i for i in range(heads[0])]
        + ["attn_%d" % i for i in range(heads[0])])
    # a second model loaded from the exported tree computes the same
    _, other = _gat_models(d, heads)
    load_flax_params(other, back)
    _, tego = _ego_pair(d, False)
    with torch.no_grad():
        assert torch.equal(other(tego), tmodel(tego))


def test_load_flax_params_refuses_leftover_and_missing_leaves():
    d = 8
    plain, _ = _ego_pair(d, False)
    jmodel, tmodel = _gat_models(d, [2, 1])
    params = _np(jmodel.init(jax.random.key(1), plain, training=False))
    conv = params["params"]["layers_0"]["convs_0"]
    extra = {"params": {**params["params"], "layers_0": {"convs_0": {
        **conv, "n_0": conv["x_0"]}}}}
    with pytest.raises(InvalidArgumentError, match="n_0"):
        load_flax_params(tmodel, extra)
    missing = {"params": {**params["params"], "layers_0": {"convs_0": {
        k: v for k, v in conv.items() if k != "attn_1"}}}}
    with pytest.raises(InvalidArgumentError, match="attn_1"):
        load_flax_params(tmodel, missing)
