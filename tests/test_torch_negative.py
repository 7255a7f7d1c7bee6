"""The port's negative sampling (ops/negative.py) against the JAX package's
(graph_learn_tpu/ops/negative.py).

Torch cannot reproduce JAX's random bits, so the CDF strategies are held
exactly on JAX's own uniform numbers: the same numbers go through JAX's
code and through the port's ``cdf_positions`` / ``pick_negatives``, and
the negatives must be equal, rows where every round is a true neighbour
and hub rows (more than 256 neighbours) among them.  ``random`` is held to
its pool and a chi-square bound; the rate of true neighbours among the
draws to what ``chip_smoke.py neighbour_mass`` predicts."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import graph_learn_tpu_torch as glt
from graph_learn_tpu.ops import negative as jneg
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops import negative
from torch_parity import (both_confs, jax_u2i_graph, torch_u2i_graph,
                          u2i_arrays)

REPO = Path(__file__).resolve().parents[1]


def _tables(a, t="u-i"):
    jg, tg = jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]
    return (jg.store.edge_table(t).device(),
            tg.store.edge_table(t).device("cpu"),
            jg.store.node_table("i").device(),
            tg.store.node_table("i").device("cpu"))


def _with_draws(monkeypatch, u):
    """JAX's ``_draw_cdf_ids`` on the given uniform numbers instead of its
    key's (the rest of JAX's negative_sample runs as it is)."""
    def draw(cand_ids, cdf, key, shape):
        assert u.shape == tuple(shape)
        pos = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u), side="left"),
                       0, cand_ids.shape[0] - 1)
        return cand_ids[pos]
    monkeypatch.setattr(jneg, "_draw_cdf_ids", draw)


def _force_neighbours(u, cdf, csr_ro, csr_nbr, pool, seeds, rows):
    """Rewrite ``u`` so that every round of every slot of the given rows
    lands on a true neighbour of the row's seed."""
    cdf = np.asarray(cdf, np.float64)
    for r in rows:
        s = seeds[r]
        nbrs = np.asarray(csr_nbr)[csr_ro[s]:csr_ro[s + 1]]
        assert nbrs.size, "a forced row needs a seed with neighbours"
        at = np.searchsorted(np.asarray(pool), nbrs)
        lo = np.where(at > 0, cdf[np.maximum(at - 1, 0)], 0.0)
        # the midpoint of each neighbour's interval of the CDF
        mids = ((lo + cdf[at]) / 2).astype(np.float32)
        u[r] = mids[np.arange(u[r].size) % mids.size].reshape(u[r].shape)
    return u


# node_weight draws from the dst node table on either side, so its inNeg
# case is the in_degree one's
@pytest.mark.parametrize("hub", [0, 300])
@pytest.mark.parametrize("strategy,reverse",
                         [("in_degree", False), ("in_degree", True),
                          ("soft_in_degree", False), ("soft_in_degree", True),
                          ("node_weight", False)])
def test_cdf_negatives_equal_jax_on_its_own_draws(strategy, reverse, hub,
                                                  monkeypatch):
    a = u2i_arrays(hub=hub, seed=4)
    jet, tet, jnt, tnt = _tables(a)
    b, k, rounds = 24, 3, 6
    n_seeds = 50 if reverse else 59
    seeds = np.random.default_rng(0).integers(0, n_seeds, b).astype(np.int32)
    seeds[:2] = 0  # the hub user (with hub > 0), or item 0
    u = np.array(jax.random.uniform(jax.random.key(7), (b, k, rounds)))
    if strategy == "node_weight":
        pool, cdf = np.arange(50, dtype=np.int32), np.asarray(jnt.cum_weights)
    elif reverse:
        pool, cdf = np.asarray(jet.unique_src), np.asarray(
            jet.unique_src_outdeg_cdf)
    else:
        pool, cdf = np.asarray(jet.unique_dst), np.asarray(
            jet.unique_dst_indeg_cdf)
    csr = tet.inc if reverse else tet.out
    forced = [0, 2, 5]
    u = _force_neighbours(u, cdf, csr.row_offsets.numpy(),
                          csr.nbr_ids.numpy(), pool, seeds, forced)
    _with_draws(monkeypatch, u)
    with both_confs(sampling_retry_times=rounds - 1):
        want = np.asarray(jneg.negative_sample(
            jet, jnp.asarray(seeds), k, jax.random.key(0), strategy=strategy,
            dst_table=jnt, reverse=reverse))
        tcdf = torch.from_numpy(cdf)
        pos = negative.cdf_positions(tcdf, torch.from_numpy(u))
        np.testing.assert_array_equal(pos.numpy(), np.clip(
            np.searchsorted(cdf, u, side="left"), 0, cdf.size - 1))
        cands = torch.from_numpy(pool)[pos]
        got = (cands[..., 0] if strategy == "soft_in_degree" else
               negative.pick_negatives(tet, torch.from_numpy(seeds), cands,
                                       reverse))
    np.testing.assert_array_equal(got.numpy(), want)
    if strategy != "soft_in_degree":
        # a forced row keeps its last round, a true neighbour
        np.testing.assert_array_equal(got[forced].numpy(),
                                      cands[forced][..., -1].numpy())


@pytest.mark.parametrize("reverse", [False, True])
def test_random_negatives_come_uniformly_from_the_pool(reverse):
    a = u2i_arrays(n_i=80, seed=2)
    _, tet, _, tnt = _tables(a)
    pool = (tet.unique_src if reverse else tet.unique_dst).numpy()
    np.testing.assert_array_equal(
        pool, np.unique(a["ui_src"] if reverse else a["ui_dst"]))
    seeds = torch.zeros(400, dtype=torch.int32)
    ids = negative.negative_sample(tet, seeds, 50,
                                   torch.Generator().manual_seed(3),
                                   strategy="random", dst_table=tnt,
                                   reverse=reverse)
    assert ids.shape == (400, 50) and ids.dtype == torch.int32
    assert np.isin(ids.numpy(), pool).all()
    counts = np.bincount(np.searchsorted(pool, ids.numpy().ravel()),
                         minlength=pool.size)
    # uniform over the pool: chi-square at the 1e-4 level
    assert stats.chisquare(counts).pvalue > 1e-4


@pytest.mark.parametrize("strategy", ["random", "node_weight", "in_degree"])
def test_neg_of_a_node_type(strategy, monkeypatch):
    """``Neg(t)``: no topology; node_weight by the node weights (exact on
    JAX's draws), the others uniform over the node set."""
    a = u2i_arrays(seed=5)
    _, _, jnt, tnt = _tables(a)
    b, k = 300, 20
    gen = torch.Generator().manual_seed(1)
    if strategy == "node_weight":
        u = np.array(jax.random.uniform(jax.random.key(2), (b, k)))
        _with_draws(monkeypatch, u)
        want = np.asarray(jneg.negative_sample_from_nodes(
            jnt, b, k, jax.random.key(0), strategy="node_weight"))
        np.testing.assert_array_equal(
            negative.cdf_positions(tnt.cum_weights, torch.from_numpy(u))
            .numpy(), want)
        np.testing.assert_array_equal(tnt.cum_weights.numpy(),
                                      np.asarray(jnt.cum_weights))
    ids = negative.negative_sample_from_nodes(tnt, b, k, gen,
                                              strategy=strategy).numpy()
    counts = np.bincount(ids.ravel(), minlength=50)
    assert ids.shape == (b, k) and counts.size == 50
    w = (a["i_weights"] if strategy == "node_weight"
         else np.ones(50, np.float32)).astype(np.float64)
    assert stats.chisquare(counts, counts.sum() * w / w.sum()).pvalue > 1e-4


def test_negatives_through_the_plan():
    """outNeg / inNeg / Neg in a query: shapes, types and pools."""
    a = u2i_arrays(seed=6)
    g = torch_u2i_graph(a)[0]
    seed = g.E("u-i").batch(16).alias("seed")
    src, dst = seed.outV().alias("src"), seed.inV().alias("dst")
    src.outNeg("u-i").sample(3).by("in_degree").alias("on")
    dst.inNeg("u-i").sample(2).by("soft_in_degree").alias("in")
    src.Neg("i").sample(4).by("node_weight").alias("nn")
    out = glt.Dataset(seed.values(), window=1, device="cpu").next()
    et = g.store.edge_table("u-i").device("cpu")
    assert out["on"].ids.shape == (16, 3) and out["on"].type_name == "i"
    assert out["in"].ids.shape == (16, 2) and out["in"].type_name == "u"
    assert out["nn"].ids.shape == (16, 4) and out["nn"].type_name == "i"
    assert torch.isin(out["on"].ids, et.unique_dst).all()
    assert torch.isin(out["in"].ids, et.unique_src).all()
    # the negatives' features are the item rows, deferred
    assert torch.equal(out["on"].float_attrs.materialize(),
                       g.store.node_table("i").device("cpu")
                       .float_attrs[out["on"].ids.long()])


def test_minimal_store_raises_with_the_jax_message():
    from graph_learn_tpu.errors import InvalidArgumentError as JaxError
    a = u2i_arrays(seed=1)
    with both_confs(storage_profile="minimal"):
        jet, tet, jnt, tnt = _tables(a)
    assert tet.unique_dst is None and tet.unique_src_outdeg_cdf is None
    seeds = np.zeros(4, np.int32)
    with pytest.raises(JaxError) as je:
        jneg.negative_sample(jet, jnp.asarray(seeds), 2, jax.random.key(0))
    with pytest.raises(InvalidArgumentError) as te:
        negative.negative_sample(tet, torch.from_numpy(seeds), 2,
                                 torch.Generator())
    assert str(te.value) == str(je.value)
    for strategy in ("conditional", "nope"):
        with pytest.raises(InvalidArgumentError):
            negative.negative_sample(tet, torch.from_numpy(seeds), 2,
                                     torch.Generator(), strategy=strategy)


def test_node_weight_needs_a_weighted_table():
    a = u2i_arrays(seed=1)
    _, tet, _, _ = _tables(a)
    unweighted = torch_u2i_graph(a)[0].store.node_table("u").device("cpu")
    with pytest.raises(InvalidArgumentError, match="weighted"):
        negative.negative_sample(tet, torch.zeros(3, dtype=torch.int32), 2,
                                 torch.Generator(), strategy="node_weight",
                                 dst_table=unweighted)


def test_row_member_equals_a_set_lookup_on_hub_rows():
    from graph_learn_tpu_torch.ops.segment import row_member
    a = u2i_arrays(hub=400, seed=8)
    _, tet, _, _ = _tables(a)
    assert tet.out.max_degree > 256
    seeds = np.arange(59, dtype=np.int32)
    q = np.random.default_rng(0).integers(0, 50, (59, 7)).astype(np.int32)
    got = row_member(tet.out, torch.from_numpy(seeds), torch.from_numpy(q))
    edges = set(zip(a["ui_src"].tolist(), a["ui_dst"].tolist()))
    want = np.array([[(s, d) in edges for d in row] for s, row in
                     zip(seeds.tolist(), q.tolist())])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].any() and not want.all()


def test_chip_smoke_predicts_the_rate_of_true_neighbours():
    """chip_smoke.py checks the card's negatives against neighbour_mass:
    on a dense graph the rates are large enough to see here."""
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a = u2i_arrays(e_ui=900, hub=30, seed=9)
    _, tet, _, _ = _tables(a)
    seeds = torch.arange(59, dtype=torch.int32)
    p = smoke.neighbour_mass(torch, tet, seeds).numpy()
    # the same share from the host arrays
    indeg = np.bincount(a["ui_dst"], minlength=50).astype(np.float64)
    want = [indeg[np.unique(a["ui_dst"][a["ui_src"] == s])].sum()
            / indeg.sum() for s in range(59)]
    np.testing.assert_allclose(p, want, rtol=1e-5, atol=1e-7)
    rates = smoke.negative_rates(torch, tet, seeds,
                                 torch.Generator().manual_seed(0), k=400)
    for strategy, (hits, expected) in rates.items():
        assert smoke.rate_agrees(hits, expected), (strategy, hits, expected)
    # soft draws find neighbours often; six rounds of rejection rarely
    assert rates["soft_in_degree"][0] > 20 * (rates["in_degree"][0] + 1)
