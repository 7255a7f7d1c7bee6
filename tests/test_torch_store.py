"""The port's graph store against the JAX package's on the same numpy graph:
flat CSR device views, the id index, the bf16 feature table."""

import numpy as np
import pytest
import torch

from graph_learn_tpu.errors import NotFoundError as JaxNotFoundError
from graph_learn_tpu_torch.errors import NotFoundError
from torch_parity import both_confs, jax_graph, numpy_graph, torch_graph


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("direction", ["out", "inc"])
def test_csr_bitwise_equals_jax(weighted, direction):
    a = numpy_graph(n=250, avg_degree=5, weighted=weighted, isolated=7)
    jg, _ = jax_graph(a)
    tg, _ = torch_graph(a)
    jcsr = getattr(jg.store.edge_table("rel").device(), direction)
    tcsr = getattr(tg.store.edge_table("rel").device("cpu"), direction)
    for name in ("row_offsets", "nbr_ids", "nbr_edge_ids"):
        t = getattr(tcsr, name)
        assert t.dtype == torch.int32 and t.dim() == 1, name
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(jcsr, name)), name)
    jdeg = np.asarray(jcsr.row_offsets[1:] - jcsr.row_offsets[:-1])
    assert tcsr.max_degree == int(jdeg.max())
    np.testing.assert_array_equal(tcsr.degrees().numpy(), jdeg)


def test_minimal_profile_builds_only_the_forward_csr():
    a = numpy_graph(n=50)
    with both_confs(storage_profile="minimal"):
        tg, _ = torch_graph(a)
        et = tg.store.edge_table("rel").device("cpu")
    assert et.inc is None and et.out.num_edges == a["src"].size


def test_id_index_lookup_matches_jax():
    a = numpy_graph(n=120)
    jidx = jax_graph(a)[0].store.node_table("item").index
    tidx = torch_graph(a)[0].store.node_table("item").index
    rng = np.random.default_rng(2)
    ids = rng.choice(a["raw_ids"], 40)
    np.testing.assert_array_equal(tidx.lookup(ids), jidx.lookup(ids))
    missing = np.concatenate([ids[:3], [5, 8]])  # 5 and 8 are not ids
    with pytest.raises(JaxNotFoundError):
        jidx.lookup(missing)
    with pytest.raises(NotFoundError):
        tidx.lookup(missing)
    np.testing.assert_array_equal(tidx.lookup(missing, strict=False),
                                  jidx.lookup(missing, strict=False))
    assert tidx.lookup(missing, strict=False)[-1] == -1


def test_bf16_feature_table_matches_jax():
    a = numpy_graph(n=80, d=128)
    with both_confs(feature_dtype="bfloat16"):
        jt = jax_graph(a)[0].store.node_table("item").device()
        tt = torch_graph(a)[0].store.node_table("item").device("cpu")
    assert tt.float_attrs.dtype == torch.bfloat16
    np.testing.assert_array_equal(tt.float_attrs.float().numpy(),
                                  np.asarray(jt.float_attrs, np.float32))
    np.testing.assert_array_equal(tt.raw_ids.numpy(), np.asarray(jt.raw_ids))
    np.testing.assert_array_equal(tt.labels.numpy(), np.asarray(jt.labels))


def test_graph_stats_and_out_degrees_match_jax():
    a = numpy_graph(n=90, isolated=4)
    jg, tg = jax_graph(a)[0], torch_graph(a)[0]
    assert tg.get_stats() == jg.store.stats()
    ids = a["raw_ids"][[0, 5, 88, 89]]
    np.testing.assert_array_equal(tg.out_degrees(ids, "rel"),
                                  jg.store.edge_table("rel").out_degrees[
                                      jg.store.node_table("item")
                                      .index.lookup(ids)])
    assert tg.out_degrees(ids, "rel")[-1] == 0


def test_graph_lookup_nodes_matches_jax():
    a = numpy_graph(n=60, d=8)
    jg, tg = jax_graph(a)[0], torch_graph(a)[0]
    ids = a["raw_ids"][[3, 59, 0, 3]]
    jn, tn = jg.lookup_nodes("item", ids), tg.lookup_nodes("item", ids)
    for field in ("ids", "raw_ids", "labels"):
        np.testing.assert_array_equal(getattr(tn, field).numpy(),
                                      np.asarray(getattr(jn, field)), field)
    np.testing.assert_array_equal(tn.float_attrs.materialize().numpy(),
                                  np.asarray(jn.float_attrs))
    with pytest.raises(NotFoundError):
        tg.lookup_nodes("item", np.array([1]))


AUX = ("nbr_ids_sorted", "nbr_edge_ids_sorted", "cum_weights",
       "cum_in_degrees")


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("direction", ["out", "inc"])
def test_full_profile_arrays_bitwise_equal_the_jax_flat_views(weighted,
                                                              direction):
    a = numpy_graph(n=250, avg_degree=5, weighted=weighted, isolated=7)
    if weighted:
        # an all-zero row falls back to uniform; a negative weight counts 0
        a["weights"][a["src"] == 3] = 0.0
        a["weights"][:5] = -1.0
    jcsr = getattr(jax_graph(a)[0].store.edge_table("rel").device(),
                   direction)
    tcsr = getattr(torch_graph(a)[0].store.edge_table("rel").device("cpu"),
                   direction)
    for name in AUX:
        j, t = getattr(jcsr, name), getattr(tcsr, name)
        if j is None:
            assert t is None and name == "cum_weights" and not weighted
            continue
        want = np.asarray(j)
        assert t.dim() == 1 and t.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(t.numpy(), want, name)
    if weighted and direction == "out":
        ro = tcsr.row_offsets.numpy()
        np.testing.assert_allclose(
            tcsr.cum_weights.numpy()[ro[3]:ro[4]],
            np.arange(1, ro[4] - ro[3] + 1) / (ro[4] - ro[3]), rtol=1e-6)


def test_minimal_profile_leaves_the_auxiliary_arrays_off_the_device():
    a = numpy_graph(n=50)
    with both_confs(storage_profile="minimal"):
        jout = jax_graph(a)[0].store.edge_table("rel").device().out
        tout = torch_graph(a)[0].store.edge_table("rel").device("cpu").out
    for name in AUX:
        assert getattr(jout, name) is None and getattr(tout, name) is None
    np.testing.assert_array_equal(tout.nbr_ids.numpy(),
                                  np.asarray(jout.nbr_ids))


def test_in_degrees_match_jax():
    a = numpy_graph(n=90, isolated=4)
    jet = jax_graph(a)[0].store.edge_table("rel")
    tet = torch_graph(a)[0].store.edge_table("rel")
    assert tet.in_degrees.dtype == np.int32
    np.testing.assert_array_equal(tet.in_degrees, jet.in_degrees)
    np.testing.assert_array_equal(tet.out_degrees, jet.out_degrees)


def test_empty_edge_table_builds_empty_views():
    a = numpy_graph(n=10)
    a.update(src=a["src"][:0], dst=a["dst"][:0], weights=a["weights"][:0])
    et = torch_graph(a)[0].store.edge_table("rel").device("cpu")
    assert et.out.num_edges == 0 and et.out.max_degree == 0
    assert et.out.cum_weights is None and et.out.nbr_ids_sorted.numel() == 0


POOLS = ("unique_dst", "unique_dst_indeg_cdf", "unique_src",
         "unique_src_outdeg_cdf")


@pytest.mark.parametrize("edge_type", ["u-i", "i-i"])
def test_candidate_pools_bitwise_equal_jax(edge_type):
    """The negative-sampling pools of a weighted two-type graph: the sorted
    distinct dst / src ids and their degree CDFs, bit for bit."""
    from torch_parity import jax_u2i_graph, torch_u2i_graph, u2i_arrays
    a = u2i_arrays(hub=40, seed=3)
    jet = jax_u2i_graph(a)[0].store.edge_table(edge_type).device()
    tet = torch_u2i_graph(a)[0].store.edge_table(edge_type).device("cpu")
    for name in POOLS:
        want, got = np.asarray(getattr(jet, name)), getattr(tet, name)
        assert got.dim() == 1 and got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want, name)
    assert tet.num_edges == jet.num_edges


def test_minimal_profile_has_no_pools_and_node_weights_keep_their_cdf():
    from torch_parity import jax_u2i_graph, torch_u2i_graph, u2i_arrays
    a = u2i_arrays(seed=2)
    a["i_weights"][:4] = 0.0
    with both_confs(storage_profile="minimal"):
        jg, tg = jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]
        tet = tg.store.edge_table("u-i").device("cpu")
        jnt = jg.store.node_table("i").device()
        tnt = tg.store.node_table("i").device("cpu")
    assert all(getattr(tet, name) is None for name in POOLS)
    np.testing.assert_array_equal(tnt.cum_weights.numpy(),
                                  np.asarray(jnt.cum_weights))
    assert tnt.num_nodes == 50
    assert tg.store.node_table("u").device("cpu").cum_weights is None
    # a node table's own seed set carries its weights
    np.testing.assert_array_equal(tg.store.node_set("i").weights,
                                  a["i_weights"])
