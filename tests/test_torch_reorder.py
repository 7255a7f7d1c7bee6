"""The locality reorder (core/reorder.py, ``Graph.init(reorder="bfs")``)
against the JAX package's: ``bfs_order`` bit for bit on the same edges,
the reordered store (tables, node sets, CSRs, pools) bit-equal to JAX's,
and the raw-id semantics of tests/test_core_store.py:156 (adjacency,
payloads and masked sets unchanged, neighbours closer, the GSL answers
the same raw neighbours)."""

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.core import reorder as jreorder
from graph_learn_tpu_torch.core import reorder
from torch_parity import store_equal


@pytest.mark.parametrize("n,e,seed", [(1, 0, 0), (12, 5, 1), (60, 90, 2),
                                      (300, 200, 3), (500, 4000, 4)])
def test_bfs_order_equals_the_jax_order(n, e, seed):
    """Sparse graphs (isolated nodes, many components) and a dense one;
    self-loops and repeated edges among them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    got = reorder.bfs_order(n, src, dst)
    want = jreorder.bfs_order(n, src, dst)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


def _register(mod, g, f, timestamped=False):
    g.node(f["node"], node_type="item",
           decoder=mod.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(f["edge"], edge_type=("item", "item", "rel"),
           decoder=mod.Decoder(weighted=True))
    g.node(f["train"], node_type="item", decoder=mod.Decoder(weighted=True),
           mask=mod.Mask.TRAIN)
    if timestamped:
        g.node(f["user"], node_type="user", decoder=mod.Decoder())
        g.edge(f["ev"], edge_type=("user", "item", "ev"),
               decoder=mod.Decoder(timestamped=True), directed=False)
    return g


def _event_files(tmp_graph_dir):
    rng = np.random.default_rng(9)
    d = tmp_graph_dir["dir"]
    with open(d / "user", "w") as f:
        f.write("id:int64\n")
        for i in range(7):
            f.write("%d\n" % (i + 1000))
    with open(d / "ev", "w") as f:
        f.write("src_id:int64\tdst_id:int64\ttimestamp:int64\n")
        for _ in range(30):
            f.write("%d\t%d\t%d\n" % (1000 + rng.integers(0, 7),
                                      10 * rng.integers(0, 40),
                                      1_650_000_000 + rng.integers(0, 5000)))
    return {**tmp_graph_dir, "user": str(d / "user"), "ev": str(d / "ev")}


@pytest.mark.parametrize("timestamped", [False, True])
def test_the_reordered_store_equals_the_jax_one(tmp_graph_dir, timestamped):
    """The reordered type's tables, node sets and CSRs, and (with a
    timestamped u-i type between two node types) the edge tables rebuilt
    from absolute time, with their reverse copy, bit for bit."""
    f = _event_files(tmp_graph_dir) if timestamped else tmp_graph_dir
    tg = _register(glt, glt.Graph(device="cpu"), f, timestamped).init(
        reorder="bfs")
    jg = _register(gl, gl.Graph(), f, timestamped).init(reorder="bfs")
    store_equal(tg, jg)
    plain = _register(glt, glt.Graph(device="cpu"), f, timestamped).init()
    assert not np.array_equal(tg.store.node_table("item").raw_ids,
                              plain.store.node_table("item").raw_ids)
    if timestamped:
        for t in ("ev", "ev_reverse"):
            a, b = tg.store.edge_table(t), plain.store.edge_table(t)
            assert (a.ts_base, a.ts_scale) == (b.ts_base, b.ts_scale)
            np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_array_equal(
            tg.store.node_table("user").raw_ids,
            plain.store.node_table("user").raw_ids)


def test_bfs_reorder_preserves_semantics(tmp_graph_dir):
    """tests/test_core_store.py:156 on the port: raw-id adjacency,
    payloads and the masked set unchanged, neighbour indices closer, and
    a ``topk`` query answers the same raw neighbours of the same raw
    seeds."""
    g0 = _register(glt, glt.Graph(device="cpu"), tmp_graph_dir).init()
    g1 = _register(glt, glt.Graph(device="cpu"), tmp_graph_dir).init(
        reorder="bfs")

    def adj(g):
        et = g.store.edge_table("rel")
        raw = g.store.node_table("item").raw_ids
        return {(int(raw[s]), int(raw[d]), float(w))
                for s, d, w in zip(et.src, et.dst, et.weights)}
    assert adj(g0) == adj(g1)

    nt1 = g1.store.node_table("item")
    for new_idx in range(0, nt1.num_nodes, 7):
        raw = int(nt1.raw_ids[new_idx])
        assert nt1.labels[new_idx] == (raw // 10) % 5
        np.testing.assert_allclose(nt1.weights[new_idx], (raw // 10) * 0.1,
                                   rtol=1e-5)
    raws = {int(nt1.raw_ids[i])
            for i in g1.store.node_set("MASK*item").indices}
    assert raws == set(range(0, tmp_graph_dir["n"] * 10, 20))

    def mean_nbr_dist(g):
        et = g.store.edge_table("rel")
        return float(np.abs(et.src - et.dst).mean())
    assert mean_nbr_dist(g1) <= mean_nbr_dist(g0)

    answers = []
    for g in (g0, g1):
        raw = torch.as_tensor(g.store.node_table("item").raw_ids)
        q = (g.V("item", mask=glt.Mask.TRAIN).batch(4).alias("s")
             .outV("rel").sample(8).by("topk").alias("h").values())
        ds = glt.Dataset(q, device="cpu")
        rows = {}
        for _ in range(5):
            out = ds.next()
            assert out["h"].ids.shape == (4, 8)
            for s, h in zip(raw[out["s"].ids.long()].tolist(),
                            raw[out["h"].ids.long()].tolist()):
                rows[s] = sorted(h)
        answers.append(rows)
    assert answers[0] == answers[1]
