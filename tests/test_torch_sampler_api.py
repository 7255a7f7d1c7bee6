"""The port's sampler objects (sampler_api.py) against the JAX package's.

The same seeded numpy graph is loaded into both.  The deterministic
samplers are held bit for bit: node and edge batches in every traversal
(the port's Traverser is a copy), ``topk`` and ``full`` neighbours and
induced subgraphs.  Torch cannot reproduce JAX's random bits, so the
random strategies, the CDF negatives and the walks are held exactly on
JAX's own uniform numbers: the JAX sampler's key stream is replayed, its
numbers go through the port's ``*_draw`` / ``cdf_positions`` functions in
place of the port's generator, and the answers must be equal.  The port's
own draws are held to invariants (true neighbours, the candidate pool,
walks along edges)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.ops import negative as jneg
from graph_learn_tpu_torch import sampler_api
from graph_learn_tpu_torch.errors import InvalidArgumentError, OutOfRangeError
from graph_learn_tpu_torch.ops import negative, sampling, walk
from torch_parity import (both_confs, degree_one_graph, jax_graph,
                          jax_u2i_graph, numpy_graph, torch_graph,
                          torch_u2i_graph, u2i_arrays)

FIELDS = ("ids", "raw_ids", "labels", "weights")


def _graphs(**kw):
    a = numpy_graph(n=200, avg_degree=6, d=8, isolated=5, **kw)
    return a, jax_graph(a)[0], torch_graph(a)[0]


def _rows(t):
    return t.materialize() if hasattr(t, "materialize") else t


def _assert_nodes_equal(tn, jn):
    for f in FIELDS:
        want = getattr(jn, f)
        if want is None:
            assert getattr(tn, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(tn, f).numpy(),
                                          np.asarray(want), err_msg=f)
    np.testing.assert_array_equal(_rows(tn.float_attrs).numpy(),
                                  np.asarray(jn.float_attrs))


def _jax_keys(seed):
    """The keys a JAX sampler of ``seed`` hands to its ops, one a call."""
    key = jax.random.key(seed)
    while True:
        key, sub = jax.random.split(key)
        yield sub


@pytest.mark.parametrize("strategy", ["by_order", "shuffle", "random"])
@pytest.mark.parametrize("mask", [gl.Mask.NONE, gl.Mask.TRAIN])
def test_node_sampler_batches_equal_jax(strategy, mask):
    a, jg, tg = _graphs()
    train = a["raw_ids"][::3]
    jg.store.add_node_set(gl.core.store.NodeSet(
        type_name="MASK*item", base_type="item",
        indices=jg.store.node_table("item").index.lookup(train)))
    tg.add_node_set("item", train, glt.Mask.TRAIN)
    tmask = glt.Mask[mask.name]
    js = jg.node_sampler("item", 30, strategy, mask=mask, seed=4)
    ts = tg.node_sampler("item", 30, strategy, mask=tmask, seed=4)
    for _ in range(8):
        try:
            want = js.get()
        except gl.OutOfRangeError:
            with pytest.raises(OutOfRangeError):
                ts.get()
            continue
        _assert_nodes_equal(ts.get(), want)


@pytest.mark.parametrize("strategy", ["by_order", "shuffle"])
def test_edge_sampler_batches_equal_jax(strategy):
    _, jg, tg = _graphs()
    js = jg.edge_sampler("rel", 256, strategy, seed=2)
    ts = tg.edge_sampler("rel", 256, strategy, seed=2)
    for _ in range(6):
        try:
            want = js.get()
        except gl.OutOfRangeError:
            with pytest.raises(OutOfRangeError):
                ts.get()
            continue
        got = ts.get()
        np.testing.assert_array_equal(got.edge_ids.numpy(),
                                      np.asarray(want.edge_ids))
        np.testing.assert_array_equal(got.weights.numpy(),
                                      np.asarray(want.weights))
        _assert_nodes_equal(got.src_nodes, want.src_nodes)
        _assert_nodes_equal(got.dst_nodes, want.dst_nodes)
        assert got.type_name == "rel"


@pytest.mark.parametrize("fanouts", [[3, 2], 4])
@pytest.mark.parametrize("strategy", ["topk", "full"])
def test_topk_and_full_neighbours_equal_jax(strategy, fanouts):
    a, jg, tg = _graphs()
    ids = a["raw_ids"][[0, 5, 199, 198, 40, 41]]  # two zero-degree seeds
    want = jg.neighbor_sampler("rel", fanouts, strategy).get(ids)
    got = tg.neighbor_sampler(["rel"], fanouts, strategy).get(ids)
    assert len(got) == len(want)
    for tn, jn in zip(got, want):
        _assert_nodes_equal(tn, jn)
        if strategy == "full":
            assert isinstance(tn, glt.SparseNodes)
            np.testing.assert_array_equal(tn.degrees.numpy(),
                                          np.asarray(jn.degrees))


def _on_jax_draws(monkeypatch, seed, strategy):
    """Route the port's random samplers through their ``*_draw`` functions
    on the numbers JAX's ops draw from the JAX sampler's keys."""
    keys = _jax_keys(seed)
    uniform_draw, weighted_draw, wor_draw = (
        sampling.uniform_draw, sampling.weighted_draw, sampling.wor_draw)

    def u_of(seeds, k):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            next(keys), (seeds.shape[0], k))))

    def wor_r(seeds, k):
        return torch.from_numpy(np.array([np.asarray(jax.random.uniform(
            kj, (seeds.shape[0],))) for kj in jax.random.split(next(keys), k)
        ], np.float32).reshape(k, seeds.shape[0]))

    monkeypatch.setattr(sampling, "uniform_sample",
                        lambda csr, seeds, k, gen, *a, **kw: uniform_draw(
                            csr, seeds, u_of(seeds, k)))
    monkeypatch.setattr(sampling, "weighted_sample",
                        lambda csr, seeds, k, gen, by="edge_weight":
                        weighted_draw(csr, seeds, u_of(seeds, k), by))
    monkeypatch.setattr(sampling, "without_replacement_sample",
                        lambda csr, seeds, k, gen: wor_draw(
                            csr, seeds, wor_r(seeds, k)))


@pytest.mark.parametrize("strategy", ["random", "edge_weight", "in_degree",
                                      "random_without_replacement"])
def test_random_neighbours_equal_jax_on_its_draws(strategy, monkeypatch):
    a, jg, tg = _graphs(seed=3)
    ids = a["raw_ids"][[0, 5, 199, 7, 7, 100]]
    want = jg.neighbor_sampler("rel", [4, 3], strategy, seed=6)
    _on_jax_draws(monkeypatch, 6, strategy)
    got = tg.neighbor_sampler("rel", [4, 3], strategy, seed=6)
    for _ in range(2):  # the key stream moves on between calls
        for tn, jn in zip(got.get(ids), want.get(ids)):
            _assert_nodes_equal(tn, jn)


@pytest.mark.parametrize("strategy", ["random", "edge_weight", "in_degree",
                                      "random_without_replacement"])
def test_random_neighbours_on_the_ports_draws_are_true_edges(strategy):
    a, _, tg = _graphs(seed=1)
    ids = a["raw_ids"][:50]
    hops = tg.neighbor_sampler("rel", [5, 2], strategy, seed=3).get(ids)
    edges = set(zip(a["src"].tolist(), a["dst"].tolist()))
    prev = np.arange(50)
    for h in hops:
        nbr = h.ids.numpy().reshape(prev.size, -1)
        deg = np.bincount(a["src"], minlength=200)[prev]
        for s, row, d in zip(prev, nbr, deg):
            if d == 0:
                assert (row == glt.conf.default_neighbor_id).all()
            else:
                assert all((s, v) in edges for v in row)
        prev = nbr.reshape(-1)


def test_an_unknown_strategy_raises():
    a, _, tg = _graphs()
    with pytest.raises(InvalidArgumentError, match="strategy"):
        tg.neighbor_sampler("rel", 2, "nope").get(a["raw_ids"][:2])


@pytest.mark.parametrize("strategy", ["in_degree", "soft_in_degree",
                                      "node_weight"])
def test_cdf_negatives_equal_jax_on_its_draws(strategy, monkeypatch):
    """Over an edge type of the u2i store (with weighted items for
    node_weight): the port's negatives on JAX's uniform numbers."""
    a = u2i_arrays(seed=2)
    jg, tg = jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]
    ids = jg.store.node_table("u").raw_ids[[0, 3, 3, 9, 20]]
    k, rounds = 4, 3
    drawn = []

    def jdraw(cand_ids, cdf, key, shape):
        u = np.asarray(jax.random.uniform(key, shape))
        drawn.append(u)
        pos = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u), side="left"),
                       0, cand_ids.shape[0] - 1)
        return cand_ids[pos]
    monkeypatch.setattr(jneg, "_draw_cdf_ids", jdraw)
    monkeypatch.setattr(negative, "cdf_ids", lambda cand, cdf, shape, gen:
                        cand[negative.cdf_positions(
                            cdf, torch.from_numpy(drawn.pop(0)))])
    with both_confs(sampling_retry_times=rounds - 1):
        js = jg.negative_sampler("u-i", k, strategy, seed=1)
        ts = tg.negative_sampler("u-i", k, strategy, seed=1)
        for _ in range(2):
            want = js.get(ids)
            _assert_nodes_equal(ts.get(ids), want)
    assert not drawn


def test_random_and_node_set_negatives_come_from_their_pools():
    a = u2i_arrays(seed=2)
    tg = torch_u2i_graph(a)[0]
    ids = tg.store.node_table("u").raw_ids[:40]
    neg = tg.negative_sampler("u-i", 5, "random", seed=0).get(ids)
    pool = tg.store.edge_table("u-i").device("cpu").unique_dst.numpy()
    assert neg.ids.shape == (40, 5) and np.isin(neg.ids.numpy(), pool).all()
    for strategy in ("random", "node_weight"):
        neg = tg.negative_sampler("i", 3, strategy, seed=0).get(ids)
        assert neg.ids.shape == (40, 3) and neg.type_name == "i"
        assert ((neg.ids >= 0) & (neg.ids < 50)).all()
    # the same seed, the same draws; the default seed is conf.seed
    with both_confs(seed=11):
        s1 = tg.negative_sampler("i", 3)
    s2 = tg.negative_sampler("i", 3, seed=11)
    assert torch.equal(s1.get(ids).ids, s2.get(ids).ids)


@pytest.mark.parametrize("need_dist", [False, True])
@pytest.mark.parametrize("num_nbrs", [(0,), (3,)])
def test_subgraph_sampler_equals_jax(need_dist, num_nbrs):
    a, jg, tg = _graphs()
    ids = a["raw_ids"][[4, 9, 9, 17, 120, 199, 33, 60]]
    want = jg.subgraph_sampler("item", "rel", num_nbrs, need_dist).get(ids)
    got = tg.subgraph_sampler("item", "rel", num_nbrs, need_dist).get(ids)
    for f in ("node_ids", "num_nodes", "edge_index", "num_edges", "edge_ids",
              "dist_to_src", "dist_to_dst"):
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(w), err_msg=f)
    _assert_nodes_equal(got.nodes, want.nodes)


def test_random_walks_equal_jax_on_its_draws(monkeypatch):
    a, jg, tg = _graphs(seed=5)
    ids = a["raw_ids"][[0, 1, 2, 199, 50]]
    keys = _jax_keys(8)
    tries = walk.NUM_TRIES

    def draws(key, walk_len, b):
        ks = jax.random.split(key, walk_len - 1)
        first = np.asarray(jax.random.uniform(ks[0], (b,)))
        cand, acc = [], []
        for kk in ks[1:]:
            k1, k2 = jax.random.split(kk)
            cand.append(np.asarray(jax.random.uniform(k1, (b, tries))))
            acc.append(np.asarray(jax.random.uniform(k2, (b, tries))))
        return [torch.from_numpy(np.array(x, np.float32))
                for x in (first, cand, acc)]

    node2vec_draw = walk.node2vec_draw
    monkeypatch.setattr(walk, "node2vec_walk",
                        lambda csr, seeds, walk_len, gen, p, q:
                        node2vec_draw(csr, seeds,
                                      *draws(next(keys), walk_len,
                                             seeds.shape[0]), p, q))
    js = jg.random_walk_sampler("rel", 6, p=0.5, q=2.0, seed=8)
    ts = tg.random_walk_sampler("rel", 6, p=0.5, q=2.0, seed=8)
    for _ in range(2):
        np.testing.assert_array_equal(ts.get(ids).numpy(),
                                      np.asarray(js.get(ids)))


def test_walks_on_the_ports_draws_follow_edges():
    a = degree_one_graph(n=40)
    jg, tg = jax_graph(a)[0], torch_graph(a)[0]
    ids = a["raw_ids"][:10]
    # every node has one out-edge: the walk is forced, in both packages
    np.testing.assert_array_equal(
        tg.random_walk_sampler("rel", 5, p=0.5, q=2.0).get(ids).numpy(),
        np.asarray(jg.random_walk_sampler("rel", 5, p=0.5, q=2.0).get(ids)))
    a, _, tg = _graphs(seed=2)
    w = tg.random_walk_sampler("rel", 8, seed=1).get(a["raw_ids"][:60])
    edges = set(zip(a["src"].tolist(), a["dst"].tolist()))
    w = w.numpy()
    np.testing.assert_array_equal(w[:, 0], np.arange(60))
    for row in w:
        for u, v in zip(row[:-1], row[1:]):
            assert v == -1 or (u, v) in edges
            if u == -1:
                assert v == -1


def test_the_factories_are_attached_on_import():
    for name in ("node_sampler", "edge_sampler", "neighbor_sampler",
                 "negative_sampler", "subgraph_sampler",
                 "random_walk_sampler"):
        assert callable(getattr(glt.Graph, name)), name
    _, _, tg = _graphs()
    assert isinstance(tg.node_sampler("item"), sampler_api.NodeSampler)
    assert isinstance(tg.random_walk_sampler("rel", 3),
                      sampler_api.RandomWalkSampler)
    assert tg.node_sampler("item").generator.device.type == "cpu"
