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
        w = flops.sage_step(2, 3, 2, 4, 5, 6, bias)
        assert w.products == fwd + bwd == 2000


def test_sage_step_other_by_hand():
    w = flops.sage_step(2, 3, 2, 4, 5, 6, False)
    n1, rows0 = 6, 8
    other = (n1 * 3 * 4 + 2 * 4 * 4 + rows0 * 5 + 2 * 4 * 5
             + 2 * 2 * 4 * 5             # backward mean and relu
             + 8 * 2 * 6                 # cross-entropy
             + 12 * (8 * 5 + 10 * 6))    # Adam
    assert w.other == other
    biased = flops.sage_step(2, 3, 2, 4, 5, 6, True)
    # the biases: added forward, summed backward, and Adam on 5 + 6 more
    assert biased.other - w.other == 2 * (rows0 * 5 + 2 * 6) + 12 * 11


def test_sage_at_the_cell_shapes():
    w = flops.sage_step(1024, 15, 10, 100, 256, 47, True)
    # 8 (b k1 + b) d h + 12 b h c
    assert w.products == (8 * (1024 * 15 + 1024) * 100 * 256
                          + 12 * 1024 * 256 * 47)


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
