"""The port's sharded k-NN index (ops/knn.py ``ShardedIndex``,
``shard_index``, ``Graph.search(mesh=...)``) against the JAX package's
tests/test_knn_conditional.py:257-320 and against the port's one-rank
index.

One spawn of two gloo ranks on the CPU runs every case
(tests/torch_parity.py ``sharded_knn_ranks``); the JAX ``shard_index``
runs here over the 8 virtual CPU devices on the same data.  The IVF
indexes start from JAX's k-means rows (``train(data, init_rows=...)``)
so the centroids match.  Tolerances: ids equal; distances within
``rtol=1e-5, atol=1e-5`` (the JAX test's).
"""

import jax
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import torch_parity
from torch_parity import KNN_BIG_K, knn_case_data

KINDS = ["flat", "ivfflat", "ivfpq"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_rows(n, size, seed):
    return np.asarray(jax.random.choice(jax.random.key(seed), n, (size,),
                                        replace=n < size))


@pytest.fixture(scope="module")
def ranks():
    from graph_learn_tpu_torch.parallel.launch import spawn
    n = knn_case_data()[0].shape[0]
    rows = {"ivfflat": _jax_rows(n, 8, 0),
            "ivfpq": (_jax_rows(n, 8, 0),
                      [_jax_rows(n, 64, 1 + s) for s in range(4)])}
    return spawn(torch_parity.sharded_knn_ranks, 2, device="cpu",
                 args=(rows,), timeout_s=120, threads=1)


@pytest.fixture(scope="module")
def jax_answers():
    from graph_learn_tpu.ops.knn import build_index, shard_index
    from graph_learn_tpu.parallel.mesh import make_mesh
    data, ids, q = knn_case_data()
    mesh = make_mesh(n_data=1, n_graph=8)
    out = {}
    for kind in KINDS:
        for metric in (0, 1):
            base = build_index(data, ids, gl.KnnOption(
                k=5, index_type=kind, nlist=8, nprobe=3, metric=metric))
            sharded = shard_index(base, mesh)
            for k in (5, KNN_BIG_K):
                out[(kind, metric, k)] = sharded.search(q, k)
    return out


@pytest.mark.parametrize("k", [5, KNN_BIG_K])
@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_search_equals_jax_and_the_one_rank_index(
        ranks, jax_answers, kind, metric, k):
    """n = 203 over two ranks (a padded last block); k 110 is above a
    shard's 102 rows.  Both ranks answer alike."""
    want_ids, want_dist = jax_answers[(kind, metric, k)]
    for r in ranks:
        got = r[(kind, metric, k)]
        ids, dist = got["sharded"]
        np.testing.assert_array_equal(ids, np.asarray(want_ids))
        np.testing.assert_allclose(dist, np.asarray(want_dist), **TOL)
        np.testing.assert_array_equal(ids, got["one"][0])
        np.testing.assert_allclose(dist, got["one"][1], **TOL)


@pytest.mark.parametrize("kind", ["ivfflat", "ivfpq"])
def test_every_rank_holds_the_same_replicated_arrays(ranks, kind):
    for metric in (0, 1):
        a, b = (r[(kind, metric, "repl")] for r in ranks)
        assert sorted(a) == sorted(b) and a
        for name in a:
            assert torch.equal(a[name], b[name]), (kind, metric, name)


@pytest.mark.parametrize("kind", ["flat", "ivfflat"])
def test_graph_search_over_a_mesh_equals_the_unsharded_call(ranks, kind):
    for r in ranks:
        got = r[("graph", kind)]
        np.testing.assert_array_equal(got["sharded"][0], got["one"][0])
        np.testing.assert_allclose(got["sharded"][1], got["one"][1], **TOL)
        assert r["graph_keys"] == [("item", t, s)
                                   for t in ("flat", "ivfflat")
                                   for s in (False, True)]
