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
