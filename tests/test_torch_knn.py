"""The port's k-NN (ops/knn.py, Graph.search) against the JAX package's
(graph_learn_tpu/ops/knn.py, Graph.search).

The same seeded numpy vectors go through both.  k-means starts from the
rows JAX's ``jax.random.choice`` picks, passed to the port's ``train``
(or, through ``Graph.search``, handed to the port's row draw), so the
centroids, codebooks, cells and codes follow the same path.  Tolerances:
ids equal; distances within ``rtol=1e-5, atol=1e-4`` (the products are
summed in another order); centroids and codebooks within ``1e-5``.  The
chunked search is held to itself with other chunk sizes, at the same
tolerances, and its largest tensor to the chunk sizes' bound."""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.ops import knn as jknn
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops import knn
from graph_learn_tpu_torch.parallel.mesh import make_mesh
from torch_parity import (both_confs, jax_graph, numpy_graph, one_rank_group,
                          torch_graph)

DIST_TOL = dict(rtol=1e-5, atol=1e-4)
TRAIN_TOL = dict(rtol=0, atol=1e-5)


def _data(n=600, d=16, m=40, seed=0, clusters=12):
    """Points about ``clusters`` Gaussian centres, ids not dense, and
    queries near the first ``m`` points."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((clusters, d)).astype(np.float32) * 3
    x = (centres[rng.integers(0, clusters, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[:m] + 0.05 * rng.standard_normal((m, d))).astype(np.float32)
    return x, np.arange(n, dtype=np.int64) * 5 + 3, q


def _jax_rows(n, size, seed):
    return np.asarray(jax.random.choice(jax.random.key(seed), n, (size,),
                                        replace=n < size))


def _pq_rows(n, nlist, m, ksub, seed=0):
    return (_jax_rows(n, nlist, seed),
            [_jax_rows(n, ksub, seed + 1 + s) for s in range(m)])


def _assert_search_equal(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **DIST_TOL)


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("n,k", [(600, 10), (300, 50)])
def test_flat_search_equals_jax(metric, n, k):
    x, ids, q = _data(n=n)
    j = jknn.FlatIndex(16, metric)
    j.add(x, ids)
    t = knn.FlatIndex(16, metric, device="cpu")
    t.add(x, ids)
    got = t.search(q, k)
    _assert_search_equal(got, j.search(q, k))
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32
    if metric == 0:  # each query's own point first
        np.testing.assert_array_equal(got[0][:, 0], ids[:len(q)])


@pytest.mark.parametrize("kind", ["flat", "ivfflat", "ivfpq"])
@pytest.mark.parametrize("metric", [0, 1])
def test_padding_past_ntotal(kind, metric):
    """k above ntotal: ids -1 and distances +inf (L2, and IVFPQ's ADC L2
    whatever the metric) or -inf (inner product) past the points."""
    x, ids, q = _data(n=6, m=3)
    opt = dict(index_type=kind, nlist=2, nprobe=2, metric=metric, k=9)
    j = jknn.build_index(x, ids, gl.KnnOption(**opt))
    rows = (_jax_rows(6, 2, 0) if kind == "ivfflat"
            else _pq_rows(6, 2, 4, 64) if kind == "ivfpq" else None)
    t = {"flat": knn.FlatIndex, "ivfflat": knn.IVFFlatIndex,
         "ivfpq": knn.IVFPQIndex}[kind](16, metric=metric, device="cpu",
                                        **({} if kind == "flat" else
                                           dict(nlist=2, nprobe=2)))
    t.train(x, rows)
    t.add(x, ids)
    got = t.search(q, 9)
    _assert_search_equal(got, j.search(q, 9))
    fill = np.inf if metric == 0 or kind == "ivfpq" else -np.inf
    assert (got[0][:, 6:] == -1).all() and (got[1][:, 6:] == fill).all()


@pytest.mark.parametrize("metric", [0, 1])
def test_ivfflat_equals_jax_from_its_initial_rows(metric):
    x, ids, q = _data()
    j = jknn.IVFFlatIndex(16, nlist=16, nprobe=3, metric=metric)
    j.train(x)
    j.add(x, ids)
    t = knn.IVFFlatIndex(16, nlist=16, nprobe=3, metric=metric, device="cpu")
    t.train(x, _jax_rows(len(x), 16, 0))
    t.add(x, ids)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               **TRAIN_TOL)
    np.testing.assert_array_equal(t._cell.numpy(), np.asarray(j._cell))
    got = t.search(q, 20)
    _assert_search_equal(got, j.search(q, 20))


@pytest.mark.parametrize("metric", [0, 1])
def test_ivfpq_equals_jax_from_its_initial_rows(metric):
    x, ids, q = _data()
    j = jknn.IVFPQIndex(16, nlist=8, nprobe=2, m=4, ksub=16, metric=metric)
    j.train(x)
    j.add(x, ids)
    t = knn.IVFPQIndex(16, nlist=8, nprobe=2, m=4, ksub=16, metric=metric,
                       device="cpu")
    t.train(x, _pq_rows(len(x), 8, 4, 16))
    t.add(x, ids)
    np.testing.assert_allclose(t.coarse.centroids.numpy(),
                               np.asarray(j.coarse.centroids), **TRAIN_TOL)
    np.testing.assert_allclose(t.codebooks.numpy(), np.asarray(j.codebooks),
                               **TRAIN_TOL)
    np.testing.assert_array_equal(t._cell.numpy(), np.asarray(j._cell))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    _assert_search_equal(t.search(q, 15), j.search(q, 15))


def test_kmeans_keeps_the_centroid_of_an_emptied_cell():
    """Two starting rows on one point: the second cell gets nothing (the
    tie goes to the lower cell) and keeps its centroid, as in JAX."""
    x = np.array([[0.0, 0], [0, 0], [10, 10], [10, 11]], np.float32)
    rows = np.array([0, 1, 2])
    t = knn.IVFFlatIndex(2, nlist=3, nprobe=1, iters=3, device="cpu")
    t.train(x, rows)
    np.testing.assert_array_equal(t.centroids.numpy(),
                                  [[0, 0], [0, 0], [10, 10.5]])


def _built(kind, x, ids, metric=0):
    if kind == "flat":
        t = knn.FlatIndex(x.shape[1], metric, device="cpu")
    elif kind == "ivfflat":
        t = knn.IVFFlatIndex(x.shape[1], nlist=8, nprobe=3, metric=metric,
                             device="cpu")
    else:
        t = knn.IVFPQIndex(x.shape[1], nlist=8, nprobe=3, m=4, ksub=16,
                           device="cpu")
    t.train(x)
    t.add(x, ids)
    return t


@pytest.mark.parametrize("kind", ["flat", "ivfflat", "ivfpq"])
@pytest.mark.parametrize("chunk", [1, 7, "n"])
def test_the_chunked_search_equals_the_unchunked_one(kind, chunk,
                                                     monkeypatch):
    """Queries and data rows a chunk at a time (1, 7, or all of them)
    answer as one block does: the same ids, distances within
    ``DIST_TOL`` (a product over fewer rows may sum in another order);
    duplicated points (equal scores) come back in ascending row order, as
    one ``top_k`` gives them."""
    x, ids, q = _data(n=300, m=25)
    x[200:210] = x[3]  # ties with row 3 across chunks
    t = _built(kind, x, ids, metric=1 if kind == "ivfflat" else 0)
    monkeypatch.setattr(knn, "QUERY_CHUNK", 10**6)
    monkeypatch.setattr(knn, "DATA_CHUNK", 10**6)
    want = t.search(q, 30)
    size = len(x) if chunk == "n" else chunk
    monkeypatch.setattr(knn, "QUERY_CHUNK", size)
    monkeypatch.setattr(knn, "DATA_CHUNK", size)
    got = t.search(q, 30)
    _assert_search_equal(got, want)
    if kind != "ivfpq":
        # the copies of row 3 that made the cut are its lowest rows, in
        # row order (all 11 where the metric is L2)
        copies = ids[[3] + list(range(200, 210))]
        hits = np.flatnonzero(np.isin(got[0][3], copies))
        assert hits.size == 11 or (kind == "ivfflat" and hits.size)
        np.testing.assert_array_equal(got[0][3][hits], copies[:hits.size])


def test_chunk_top_breaks_ties_toward_the_lower_row():
    s = torch.tensor([[1.0, 5, 5, 2, 5, 5, 0], [3, 3, 3, 3, 3, 3, 3]])
    vals, rows = knn._chunk_top(s, 3, base=10)
    assert rows.tolist() == [[11, 12, 14], [10, 11, 12]]
    assert vals.tolist() == [[5, 5, 5], [3, 3, 3]]
    v, r = knn._merge(vals, rows, torch.tensor([[5.0, 6], [3, 3]]),
                      torch.tensor([[20, 21], [20, 21]]), 3)
    assert r.tolist() == [[21, 11, 12], [10, 11, 12]]


class _Largest(TorchDispatchMode):
    """The most elements of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor):
                self.numel = max(self.numel, leaf.numel())
        return out


@pytest.mark.parametrize("kind", ["flat", "ivfflat", "ivfpq"])
def test_no_search_materialises_the_jax_layouts(kind):
    """On 20 000 x 16 data with 64 queries: no tensor of a search reaches
    [m, n, nprobe] or [n, m, ksub] (nor JAX's [nq, P, n]); the largest is
    bounded by the chunk sizes."""
    n, d, m, nlist, nprobe, subs, ksub = 20_000, 16, 64, 64, 8, 4, 64
    x, ids, q = _data(n=n, d=d, m=m, clusters=40)
    opt = glt.KnnOption(index_type=kind, nlist=nlist, nprobe=nprobe)
    t = knn.build_index(x, ids, opt, device="cpu")
    with _Largest() as seen:
        t.search(q, 10)
    chunk_bound = min(m, knn.QUERY_CHUNK) * min(n, knn.DATA_CHUNK)
    assert seen.numel <= chunk_bound
    assert seen.numel < min(m * n * nprobe, n * subs * ksub)


def test_graph_search_equals_jax_and_keeps_its_first_index(monkeypatch):
    """``Graph.search`` over the node table's float attributes with raw
    ids, equal to JAX's; the index is cached per (type, index type), so a
    second call with another metric, nlist or nprobe gets the first
    index's answer, in both packages."""
    a = numpy_graph(n=300, d=8)
    jg, tg = jax_graph(a)[0], torch_graph(a)[0]
    q = a["feats"][:20] + 0.01
    for opt in ({"metric": 0}, {"metric": 1}):
        want = jg.search("item", q, gl.KnnOption(k=7, **opt))
        got = tg.search("item", q, glt.KnnOption(k=7, **opt))
        _assert_search_equal(got, want)
    np.testing.assert_array_equal(got[0][:, 0], a["raw_ids"][:20])
    # IVF through Graph.search: the port's row draw gives JAX's rows
    rows = [_jax_rows(300, 8, 0)] * 2 + [_jax_rows(300, 64, 1 + s)
                                         for s in range(4)]
    monkeypatch.setattr(knn, "_choice", lambda n, size, gen: torch.as_tensor(
        rows.pop(0)))
    for kind in ("ivfflat", "ivfpq"):
        for nprobe in (2, 5):
            want = jg.search("item", q, gl.KnnOption(
                k=7, index_type=kind, nlist=8, nprobe=nprobe))
            got = tg.search("item", q, glt.KnnOption(
                k=7, index_type=kind, nlist=8, nprobe=nprobe))
            _assert_search_equal(got, want)
    assert not rows and set(tg._knn_indexes) == {
        ("item", t, False) for t in ("flat", "ivfflat", "ivfpq")}
    assert tg._knn_indexes[("item", "ivfflat", False)].nprobe == 2


def test_graph_search_refuses_a_table_without_features_and_a_mesh(
        tmp_path):
    g = glt.Graph(device="cpu")
    g.add_node_table(glt.NodeTable("v", glt.Decoder(), np.arange(5)))
    with pytest.raises(InvalidArgumentError, match="no float attrs"):
        g.search("v", np.zeros((1, 2), np.float32), glt.KnnOption())
    # a mesh whose graph axis has one rank searches the unsharded index,
    # under the unsharded key (graph_learn_tpu/graph.py:298); more ranks
    # shard it (tests/test_torch_sharded_knn.py)
    a = numpy_graph(n=50, d=4)
    tg = torch_graph(a)[0]
    with one_rank_group(str(tmp_path)):
        mesh = make_mesh(1, 1, device="cpu")
        ids, dist = tg.search("item", a["feats"][:2], glt.KnnOption(k=3),
                              mesh=mesh)
    np.testing.assert_array_equal(ids[:, 0], a["raw_ids"][:2])
    assert list(tg._knn_indexes) == [("item", "flat", False)]
    want = tg.search("item", a["feats"][:2], glt.KnnOption(k=3))
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dist, want[1])


def test_set_knn_metric_sets_the_default_metric():
    x, ids, q = _data(n=200)
    with both_confs(knn_metric=0):
        glt.set_knn_metric(1)
        gl.set_knn_metric(1)
        t = knn.FlatIndex(16, device="cpu")
        j = jknn.FlatIndex(16)
        assert t.metric == j.metric == 1
        t.add(x, ids)
        j.add(x, ids)
        _assert_search_equal(t.search(q, 5), j.search(q, 5))
        assert knn.FlatIndex(16, metric=0, device="cpu").metric == 0


def test_an_unknown_index_type_raises():
    x, ids, _ = _data(n=20, m=5)
    with pytest.raises(InvalidArgumentError, match="unknown index type"):
        knn.build_index(x, ids, glt.KnnOption(index_type="hnsw"),
                        device="cpu")
    with pytest.raises(InvalidArgumentError):
        knn.IVFPQIndex(10, m=4, device="cpu")
    with pytest.raises(InvalidArgumentError, match="train"):
        knn.IVFFlatIndex(16, device="cpu").add(x, ids)
