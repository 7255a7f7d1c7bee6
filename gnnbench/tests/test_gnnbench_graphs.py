"""The graph generator: the same seed gives the same graph, and the
degrees follow the exponent."""

import numpy as np
import pytest

from gnnbench.graphs import powerlaw

N, M = 20_000, 500_000


def params(alpha):
    return {"nodes": N, "edges": M, "feat_dim": 8, "classes": 5,
            "alpha": alpha}


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_same_seed_same_graph(alpha):
    a = powerlaw.generate(params(alpha), 2 ** 33 + 5, "cpu")
    b = powerlaw.generate(params(alpha), 2 ** 33 + 5, "cpu")
    c = powerlaw.generate(params(alpha), 2 ** 33 + 6, "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["src"], c["src"])
    assert a["features"].dtype == np.float32 and a["features"].shape == (N, 8)
    assert a["labels"].min() >= 0 and a["labels"].max() < 5
    assert 0 <= a["weights"].min() and a["weights"].max() < 1
    assert a["src"].min() >= 0 and a["dst"].max() < N


def test_uniform_degrees_are_poisson():
    g = powerlaw.generate(params(0.0), 11, "cpu")
    deg = np.bincount(g["src"], minlength=N)
    mean = M / N
    assert deg.mean() == pytest.approx(mean)
    assert deg.var() == pytest.approx(mean, rel=0.05)
    assert deg.max() < 2.5 * mean


def test_powerlaw_degrees_follow_the_rank_weights():
    g = powerlaw.generate(params(0.5), 11, "cpu")
    deg = np.bincount(g["src"], minlength=N)
    hub = M / (2 * np.sqrt(N))  # the rank-0 node's expected degree
    assert deg.max() == pytest.approx(hub, rel=0.1)
    # the lightest node expects half the mean degree
    assert np.percentile(deg, 1) < 0.75 * M / N
    # hubs are scattered over the ids, not the low ids
    top = np.argsort(deg)[-100:]
    assert top.min() < N // 4 and top.max() > 3 * N // 4
    # in- and out-degrees are drawn alike and independently
    indeg = np.bincount(g["dst"], minlength=N)
    assert indeg.max() == pytest.approx(hub, rel=0.1)


def test_a_symmetric_graph_stores_each_edge_both_ways():
    one = powerlaw.generate(params(0.0), 13, "cpu")
    two = powerlaw.generate({**params(0.0), "symmetric": True}, 13, "cpu")
    np.testing.assert_array_equal(two["src"], np.concatenate(
        [one["src"], one["dst"]]))
    np.testing.assert_array_equal(two["dst"], np.concatenate(
        [one["dst"], one["src"]]))
    np.testing.assert_array_equal(two["weights"], np.tile(one["weights"], 2))
    np.testing.assert_array_equal(two["features"], one["features"])
    # out-degree equals in-degree, node by node
    np.testing.assert_array_equal(np.bincount(two["src"], minlength=N),
                                  np.bincount(two["dst"], minlength=N))
