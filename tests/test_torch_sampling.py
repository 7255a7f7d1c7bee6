"""The port's uniform neighbour sampling against the JAX package's.

Torch cannot reproduce JAX's random bits, so exact parity is held through
``uniform_positions`` fed the uniform numbers that JAX itself draws; the
port's own generator is held to invariants and a chi-square test."""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from graph_learn_tpu.ops import sampling as jax_sampling
from graph_learn_tpu_torch.ops import sampling
from torch_parity import both_confs, jax_graph, numpy_graph, torch_graph


def _csrs(**kw):
    a = numpy_graph(**kw)
    jcsr = jax_graph(a)[0].store.edge_table("rel").device().out
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    return a, jcsr, tcsr


@pytest.mark.parametrize("key", [0, 1, 2])
@pytest.mark.parametrize("k", [15, 4])
def test_uniform_draw_with_jax_u_equals_jax_uniform_sample(key, k):
    a, jcsr, tcsr = _csrs(n=300, avg_degree=6, isolated=10, seed=key)
    seeds = np.random.default_rng(key).integers(0, 300, 64).astype(np.int32)
    seeds[:3] = [299, 295, 0]  # two zero-degree seeds
    jkey = jax.random.key(key)
    j_ids, j_eids = jax_sampling.uniform_sample(jcsr, jax.numpy.asarray(seeds),
                                                k, jkey)
    # the uniform numbers JAX drew inside uniform_sample
    # (_apply_filter_retry, no filter: one draw of seeds.shape + (k,))
    u = np.array(jax.random.uniform(jkey, (seeds.size, k)))
    t_ids, t_eids = sampling.uniform_draw(tcsr, torch.from_numpy(seeds),
                                          torch.from_numpy(u))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_eids.numpy(), np.asarray(j_eids))


def test_uniform_positions_formula():
    start = torch.tensor([0, 10, 10, 40], dtype=torch.int32)
    deg = torch.tensor([5, 0, 1, 3], dtype=torch.int32)
    u = torch.tensor([[0.0, 0.9999999], [0.5, 0.99], [0.3, 0.7],
                      [1 / 3, 0.6666667]], dtype=torch.float32)
    pos = sampling.uniform_positions(start, deg, u)
    # start + min(floor(u * deg), max(deg, 1) - 1)
    assert pos.tolist() == [[0, 4], [10, 10], [10, 10], [41, 42]]


@pytest.mark.parametrize("fill", [0, 77])
def test_zero_degree_seed_gets_default_neighbor_and_no_edge(fill):
    a, _, tcsr = _csrs(n=100, isolated=5)
    seeds = torch.tensor([99, 96, 3], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    with both_confs(default_neighbor_id=fill):
        ids, eids = sampling.uniform_sample(tcsr, seeds, 6, gen)
    assert (ids[:2] == fill).all() and (eids[:2] == -1).all()
    # the live seed draws true out-edges of node 3
    e = eids[2].numpy()
    assert (e >= 0).all() and (a["src"][e] == 3).all()
    np.testing.assert_array_equal(a["dst"][e], ids[2].numpy())


def test_sampled_edges_are_true_edges():
    a, _, tcsr = _csrs(n=200, avg_degree=8, isolated=3)
    seeds = torch.arange(200, dtype=torch.int32)
    ids, eids = sampling.uniform_sample(tcsr, seeds, 10,
                                        torch.Generator().manual_seed(1))
    live = eids >= 0
    assert bool((live.all(dim=1) | ~live.any(dim=1)).all())
    e = eids[live].numpy()
    np.testing.assert_array_equal(a["src"][e],
                                  seeds[:, None].expand(-1, 10)[live].numpy())
    np.testing.assert_array_equal(a["dst"][e], ids[live].numpy())


def test_same_generator_seed_same_draw():
    _, _, tcsr = _csrs(n=100)
    seeds = torch.arange(50, dtype=torch.int32)
    a = sampling.uniform_sample(tcsr, seeds, 5,
                                torch.Generator().manual_seed(3))
    b = sampling.uniform_sample(tcsr, seeds, 5,
                                torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_uniform_sample_chi_square_on_a_high_degree_row():
    # node 0 has 40 out-edges to 40 distinct neighbours; 40 000 draws
    deg = 40
    src = np.zeros(deg, np.int64)
    dst = np.arange(1, deg + 1)
    a = {"raw_ids": np.arange(deg + 1), "src": src, "dst": dst,
         "feats": np.zeros((deg + 1, 2), np.float32),
         "labels": np.zeros(deg + 1, np.int32), "weights": None}
    tcsr = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    seeds = torch.zeros(400, dtype=torch.int32)
    ids, _ = sampling.uniform_sample(tcsr, seeds, 100,
                                     torch.Generator().manual_seed(11))
    counts = np.bincount(ids.numpy().ravel(), minlength=deg + 1)[1:]
    assert counts.sum() == 40_000
    p = stats.chisquare(counts).pvalue
    # a fixed seed: the test is deterministic; p > 1e-3 rejects a biased
    # draw (e.g. floor(u * (deg - 1)) gives p ~ 0)
    assert p > 1e-3, p
