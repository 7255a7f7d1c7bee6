"""``Graph.close()`` and ``DeviceCSR.num_rows`` of the port against the JAX
package (``graph_learn_tpu/graph.py:217-219``,
``graph_learn_tpu/core/store.py:101-103``) on the same files."""

import numpy as np

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from torch_parity import store_equal


def _graphs(paths):
    out = []
    for mod, kw in ((gl, {}), (glt, {"device": "cpu"})):
        g = mod.Graph(**kw)
        g.node(paths["node"], node_type="item",
               decoder=mod.Decoder(weighted=True, labeled=True,
                                   attr_types=["float"] * 4))
        g.edge(paths["edge"], edge_type=("item", "item", "rel"),
               decoder=mod.Decoder(weighted=True))
        out.append(g.init())
    return out


def test_device_csr_num_rows_equals_jax(tmp_graph_dir):
    jg, tg = _graphs(tmp_graph_dir)
    jet, tet = jg.store.edge_table("rel").device(), \
        tg.store.edge_table("rel").device("cpu")
    for side in ("out", "inc"):
        assert getattr(tet, side).num_rows == getattr(jet, side).num_rows \
            == 40
    assert tet.out.num_rows == tet.out.row_offsets.shape[0] - 1


def test_close_empties_the_store_and_init_builds_it_again(tmp_graph_dir):
    jg, tg = _graphs(tmp_graph_dir)
    old = tg.store
    views = (old.node_table("item").device("cpu"),
             old.edge_table("rel").device("cpu"))
    assert all(t._device for t in (old.nodes["item"], old.edges["rel"]))
    jg.close()
    tg.close()
    # a new empty store, the device views of the old one dropped
    assert tg.store is not old and not tg._initialized
    assert tg.get_stats() == jg.get_stats() == {"nodes": {}, "edges": {}}
    assert not old.nodes["item"]._device and not old.edges["rel"]._device
    assert views[1].out.num_rows == 40  # views handed out keep their tensors
    # the sources stay registered: init() builds the JAX store again
    store_equal(tg.init(), jg.init())
    assert tg._initialized and tg.store is not old


def test_close_keeps_the_knn_indexes_as_the_jax_package_does(tmp_graph_dir):
    """A behaviour of the JAX package copied as it is: ``close`` leaves
    ``_knn_indexes`` alone (graph_learn_tpu/graph.py:299-308), so a search
    after it still answers from the index of the closed store."""
    jg, tg = _graphs(tmp_graph_dir)
    q = np.random.default_rng(0).random((5, 4)).astype(np.float32)
    want = jg.search("item", q, gl.KnnOption(k=3))
    got = tg.search("item", q, glt.KnnOption(k=3))
    jg.close()
    tg.close()
    assert set(tg._knn_indexes) == set(jg._knn_indexes) == {
        ("item", "flat", False)}
    after_j = jg.search("item", q, gl.KnnOption(k=3))
    after_t = tg.search("item", q, glt.KnnOption(k=3))
    for a, b in ((after_t, after_j), (got, want), (after_t, got)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-4)
