"""The operation and byte counts against counts made by hand."""

import pytest

from gnnbench import flops

PEAKS = flops.load_peaks("h100_sxm")


def test_sage_step_products_by_hand():
    # b 2, k1 3, k2 2, d 4, h 5, c 6: layer 0 on [x; mean] (8 wide) of 2*3
    # hop-1 rows and 2 seeds, layer 1 on [h; mean] (10 wide) of 2 seeds;
    # dW0 again, dW1 and the gradient of layer 1's input
    fwd = 2 * 8 * 8 * 5 + 2 * 2 * 10 * 6
    bwd = 2 * 8 * 8 * 5 + 4 * 2 * 10 * 6
    for bias in (False, True):
        w = flops.sage_step(2, [3, 2], [4, 5, 6], bias)
        assert w.products == fwd + bwd == 2000


def test_sage_step_other_by_hand():
    w = flops.sage_step(2, [3, 2], [4, 5, 6], False)
    n1, rows0 = 6, 8
    other = (n1 * 3 * 4 + 2 * 4 * 4 + rows0 * 5 + 2 * 4 * 5
             + 2 * 2 * 4 * 5             # backward mean and relu
             + 8 * 2 * 6                 # cross-entropy
             + 12 * (8 * 5 + 10 * 6))    # Adam
    assert w.other == other
    biased = flops.sage_step(2, [3, 2], [4, 5, 6], True)
    # the biases: added forward, summed backward, and Adam on 5 + 6 more
    assert biased.other - w.other == 2 * (rows0 * 5 + 2 * 6) + 12 * 11


def test_sage_at_the_cell_shapes():
    w = flops.sage_step(1024, [15, 10], [100, 256, 47], True)
    # 8 (b k1 + b) d h + 12 b h c
    assert w.products == (8 * (1024 * 15 + 1024) * 100 * 256
                          + 12 * 1024 * 256 * 47)


def _two_hop_sage_step(b, k1, k2, d, h, c, bias):
    """``flops.sage_step`` as it was written for two hops alone."""
    n1 = b * k1
    rows0 = n1 + b
    fwd = flops.Work(
        products=2.0 * rows0 * 2 * d * h + 2.0 * b * 2 * h * c,
        other=(n1 * (k2 + 1) * d + b * (k1 + 1) * d + rows0 * h
               + b * (k1 + 1) * h + (rows0 * h + b * c if bias else 0)))
    bwd = flops.Work(
        products=2.0 * rows0 * 2 * d * h + 4.0 * b * 2 * h * c,
        other=(2.0 * b * (k1 + 1) * h + (rows0 * h + b * c if bias else 0)))
    n_params = 2 * d * h + 2 * h * c + (h + c if bias else 0)
    return fwd + bwd + flops.cross_entropy(b, c) + flops.adam(n_params)


@pytest.mark.parametrize("shape", [(1024, 15, 10, 100, 256, 47),
                                   (2, 3, 2, 4, 5, 6), (7, 1, 9, 3, 8, 2)])
@pytest.mark.parametrize("bias", [False, True])
def test_two_hops_count_as_before(shape, bias):
    b, k1, k2, d, h, c = shape
    assert (flops.sage_step(b, [k1, k2], [d, h, c], bias)
            == _two_hop_sage_step(b, k1, k2, d, h, c, bias))


def test_sage_step_three_hops_by_hand():
    # b 1024, fanout [15, 10, 5], dims [100, 256, 256, 47], with biases
    r0, r1, r2, r3 = 1024, 15360, 153600, 768000     # rows of hops 0-3
    out0, out1, out2 = r0 + r1 + r2, r0 + r1, r0      # layers' outputs
    g0 = 2 * out0 * 200 * 256                         # [x; mean] products
    g1 = 2 * out1 * 512 * 256
    g2 = 2 * out2 * 512 * 47
    w = flops.sage_step(1024, [15, 10, 5], [100, 256, 256, 47], True)
    # forward; dW of every layer; d [x; mean] of layers 1 and 2
    assert w.products == (g0 + g1 + g2) + (g0 + g1 + g2) + (g1 + g2)
    means0 = (r0 * 16 + r1 * 11 + r2 * 6) * 100      # hop 3's pre-averaged
    means1 = (r0 * 16 + r1 * 11) * 256
    means2 = r0 * 16 * 256
    relu = out0 * 256 + out1 * 256
    biases = out0 * 256 + out1 * 256 + out2 * 47
    fwd = means0 + means1 + means2 + relu + biases
    bwd = (means1 + out0 * 256) + (means2 + out1 * 256) + biases
    n_params = (2 * 100 * 256 + 256) + (2 * 256 * 256 + 256) + (2 * 256 * 47
                                                                  + 47)
    assert w.other == fwd + bwd + 8 * 1024 * 47 + 12 * n_params


def test_sage_step_needs_a_layer_a_hop():
    with pytest.raises(ValueError):
        flops.sage_step(4, [3, 2], [4, 5, 6, 7], True)


def test_gather_and_mean_bytes():
    assert flops.gather_rows(10, 15, 100, 4).bytes == (10 * 400 + 15 * 400
                                                       + 15 * 4)
    m = flops.group_mean(120, 15, 10, 100, 4)
    assert m.bytes == 120 * 400 + 15 * 400 + 150 * 4
    assert m.other == 150 * 100 + 15 * 100


def test_least_time_takes_the_binding_bound():
    mem = flops.Work(products=1.0, bytes=3.35e12)
    assert flops.least_s(mem, PEAKS) == pytest.approx(1.0)
    ops = flops.Work(products=495e12, other=67e12, bytes=1.0)
    assert flops.least_s(ops, PEAKS) == pytest.approx(2.0)
