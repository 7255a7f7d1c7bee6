"""The port's EgoGraphSAGE against the flax model, with the flax weights
carried over by ``nn/convert.py``: materialised, ``DeferredRows`` and
``PreAggregatedRows`` deepest hops, every ``agg_type``, and one case that
runs the whole serving slice on a small graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.core.values import Nodes as JaxNodes
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.models.ego_gnn import EgoGraphSAGE as JaxEgoGraphSAGE
from graph_learn_tpu.ops.lookup import lookup_nodes as jax_lookup_nodes
from graph_learn_tpu_torch import Decoder, QueryService
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.ops.kernels import spmm
from torch_parity import (both_confs, ego_pair, jax_graph, numpy_graph,
                          torch_graph, two_hop)

AGG_TYPES = ("gcn", "mean", "sum", "max")
# f32 throughout; the two frameworks sum the products and the fanout means
# in other orders: 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _ego_pair(d, mode, agg_type):
    """The same 2-hop batch as a JAX EgoGraph and a port EgoGraph; the
    deepest hop materialised, deferred or pre-aggregated."""
    return ego_pair(d, mode, "mean" if agg_type == "gcn" else agg_type)[:2]


def _models(d, agg_type, dims_tail=(32, 4)):
    jdec = JaxDecoder(attr_types=["float"] * d)
    tdec = Decoder(attr_types=["float"] * d)
    jmodel = JaxEgoGraphSAGE([d, *dims_tail], jdec, agg_type=agg_type)
    tmodel = EgoGraphSAGE([d, *dims_tail], tdec, agg_type=agg_type,
                          device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("mode", ["materialised", "deferred", "preagg"])
@pytest.mark.parametrize("agg_type", AGG_TYPES)
@pytest.mark.parametrize("d", [8, 128])
def test_logits_match_flax_with_carried_weights(d, agg_type, mode):
    jego, tego = _ego_pair(d, mode, agg_type)
    jmodel, tmodel = _models(d, agg_type)
    plain, _ = _ego_pair(d, "materialised", agg_type)
    params = jmodel.init(jax.random.key(0), plain, training=False)
    load_flax_params(tmodel, _numpy_params(params))
    ref = np.asarray(jmodel.apply(params, jego, training=False))
    with torch.no_grad():
        out = tmodel(tego)
    assert out.shape == (6, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_deferred_hop_runs_through_the_segment_spmm_wrapper():
    _, tego = _ego_pair(8, "deferred", "gcn")
    _, tmodel = _models(8, "gcn")
    calls = []
    plain = spmm.segment_spmm_plain

    def spy(*args):
        calls.append(args[1].shape)
        return plain(*args)

    spmm.segment_spmm_plain = spy
    try:
        with torch.no_grad():
            tmodel(tego)
    finally:
        spmm.segment_spmm_plain = plain
    # one group mean: [b * k1, k2] ids with every degree k2
    assert calls == [(18, 4)]


def test_convert_maps_shared_convs_and_checks_the_tree():
    d = 8
    jmodel, tmodel = _models(d, "gcn", dims_tail=(16, 16, 4))
    # a 3-layer model needs a 3-hop batch
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((50, d)).astype(np.float32))
    shapes = ((2,), (2, 3), (2, 3, 2), (2, 3, 2, 2))
    nodes = []
    for s in shapes:
        i = jnp.asarray(rng.integers(0, 50, s).astype(np.int32))
        nodes.append(JaxNodes(ids=i, float_attrs=table[i]))
    jego = jdata.EgoGraph(src=nodes[0], hops=nodes[1:], nbr_nums=(3, 2, 2))
    params = _numpy_params(jmodel.init(jax.random.key(1), jego))
    # the real tree: one conv per layer, whatever its pair count
    assert sorted(params["params"]) == ["layers_0", "layers_1", "layers_2"]
    assert all(list(v) == ["convs_0"] for v in params["params"].values())
    load_flax_params(tmodel, params)
    assert tmodel.layers[0].convs[0] is tmodel.layers[0].convs[2]
    k = params["params"]["layers_1"]["convs_0"]["trans_nodes"]["kernel"]
    np.testing.assert_array_equal(
        tmodel.layers[1].convs[0].trans_nodes.weight.detach().numpy(), k.T)
    tnodes = [Nodes(ids=torch.from_numpy(np.array(n.ids)),
                    float_attrs=torch.from_numpy(np.array(n.float_attrs)))
              for n in nodes]
    tego = tdata.EgoGraph(src=tnodes[0], hops=tnodes[1:], nbr_nums=(3, 2, 2))
    with torch.no_grad():
        np.testing.assert_allclose(tmodel(tego).numpy(),
                                   np.asarray(jmodel.apply(params, jego)),
                                   **TOL)
    extra = {"params": {**params["params"], "stray": {"kernel": k}}}
    with pytest.raises(InvalidArgumentError, match="stray"):
        load_flax_params(tmodel, extra)
    _, small = _models(d, "gcn", dims_tail=(8, 4))
    with pytest.raises(InvalidArgumentError):
        load_flax_params(small, params)


def test_preaggregated_hop_with_the_wrong_op_raises():
    _, tego = _ego_pair(8, "preagg", "sum")
    _, tmodel = _models(8, "gcn")
    with pytest.raises(InvalidArgumentError):
        tmodel(tego)


def test_pre_aggregate_hop_matches_jax():
    rng = np.random.default_rng(9)
    table = rng.standard_normal((40, 8)).astype(np.float32)
    ids = rng.integers(0, 40, (3, 2, 5)).astype(np.int32)
    jb = jdata.pre_aggregate_hop(
        {"hop2": JaxNodes(ids=jnp.asarray(ids))}, "hop2", jnp.asarray(table))
    tb = tdata.pre_aggregate_hop(
        {"hop2": Nodes(ids=torch.from_numpy(ids))}, "hop2",
        torch.from_numpy(table))
    assert tb["hop2"].float_attrs.op == "mean"
    np.testing.assert_allclose(tb["hop2"].float_attrs.agg.numpy(),
                               np.asarray(jb["hop2"].float_attrs.agg), **TOL)


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
def test_serving_slice_end_to_end_matches_flax(feature_dtype):
    """QueryService -> sampling -> feature gathers -> deepest-hop group
    mean -> EgoGraphSAGE in the port, on a small graph; the flax model is
    fed the port's sampled ids through the JAX package's own lookups."""
    k1, k2, d = 5, 3, 16
    a = numpy_graph(n=200, avg_degree=6, d=d, isolated=4, seed=8)
    with both_confs(feature_dtype=feature_dtype):
        tg, tdec = torch_graph(a)
        jg, jdec = jax_graph(a)
        q = two_hop(tg, k1, k2, batch=32)
        svc = QueryService(tg, device="cpu")
        try:
            qid = svc.install(q, micro_batch=32)
            ids = a["raw_ids"][np.r_[0:40, 196:200]]  # 44 > micro-batch
            ans = svc.run(qid, ids)
        finally:
            svc.close()
        table = q.device_tables()["nodes"]["item"].float_attrs
        tego = tdata.EgoGraph.from_query_result(ans, "src", ["hop1", "hop2"],
                                                defer_last_table=table)
        jtable = jg.store.node_table("item").device()
        jn = [jax_lookup_nodes(jtable, jnp.asarray(ans[al].ids.numpy()))
              for al in ("src", "hop1", "hop2")]
    assert table.dtype == getattr(torch, feature_dtype)
    jego = jdata.EgoGraph(src=jn[0], hops=jn[1:], nbr_nums=(k1, k2))
    jmodel = JaxEgoGraphSAGE([d, 32, 4], jdec, agg_type="gcn")
    params = jmodel.init(jax.random.key(2), jego)
    tmodel = load_flax_params(
        EgoGraphSAGE([d, 32, 4], tdec, agg_type="gcn", device="cpu"),
        _numpy_params(params))
    with torch.no_grad():
        out = tmodel(tego)
    ref = np.asarray(jmodel.apply(params, jego))
    assert out.shape == (44, 4) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
