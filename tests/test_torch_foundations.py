"""The port's remaining foundations against the JAX package:
``set_member`` and ``segment_softmax`` (ops/segment.py), query plans
(gsl/plan.py) in both directions, the Graph's direct APIs, the EgoGraph
and TemporalGraph accessors, the ``set_*`` setters, and EgoTGAT with edge
encoders against the flax model (the tracer's tests, once here, are in
``test_torch_profiling.py``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu import config as jconfig
from graph_learn_tpu.core.values import Edges as JEdges
from graph_learn_tpu.core.values import Nodes as JNodes
from graph_learn_tpu.gsl import plan as jplan
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.feature_column import FeatureEncoder as JEnc
from graph_learn_tpu.nn.models import tgat as jtgat
from graph_learn_tpu.ops import segment as jseg
from graph_learn_tpu_torch import config as tconfig
from graph_learn_tpu_torch.core.values import Edges, Nodes
from graph_learn_tpu_torch.errors import (InvalidArgumentError,
                                          UnimplementedError)
from graph_learn_tpu_torch.gsl import plan as tplan
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.models.tgat import EgoTGAT
from graph_learn_tpu_torch.ops import segment as tseg
from torch_parity import (assert_trees_close, cat_u2i_arrays, jax_u2i_graph,
                          torch_u2i_graph)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("trailing", [(), (3,)])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_equals_jax(masked, trailing):
    rng = np.random.default_rng(len(trailing) + masked)
    n, segs = 60, 12
    v = (rng.standard_normal((n,) + trailing) * 4).astype(np.float32)
    s = rng.integers(0, segs, n)
    s[np.isin(s, [3, 7])] = 5  # empty segments
    m = rng.random((n,) + trailing) > 0.3 if masked else None
    if masked:
        m[s == 2] = False  # a segment with every entry masked
    want = jseg.segment_softmax(jnp.asarray(v), jnp.asarray(s), segs,
                                None if m is None else jnp.asarray(m))
    got = tseg.segment_softmax(torch.from_numpy(v), torch.from_numpy(s),
                               segs, None if m is None
                               else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        assert bool((got[torch.from_numpy(~m)] == 0).all())


def test_set_member_equals_jax():
    rng = np.random.default_rng(0)
    sset = np.concatenate([[-1, -1], np.unique(rng.integers(0, 90, 40))])
    q = rng.integers(-3, 95, (7, 9))
    want = np.asarray(jseg.set_member(jnp.asarray(sset), jnp.asarray(q)))
    got = tseg.set_member(torch.from_numpy(sset), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _query(g):
    """A query with every kind of node record: an edge source, endpoints,
    a conditional negative, hops, a filter and a walk."""
    seed = g.E("u-i").batch(8).alias("seed")
    src = seed.outV().alias("src")
    dst = seed.inV().alias("dst")
    src.outNeg("u-i").sample(3).by("in_degree").where(
        "dst", {"int_cols": [0], "int_props": [0.5], "unique": True}
    ).alias("neg")
    src.outV("u-i").sample(4).by("random").alias("h1")
    dst.outV("i-i").sample(2).by("topk").filter("dst").alias("h2") \
        .random_walk(3, p=0.5, q=2.0).alias("walk")
    return seed.values()


def test_plans_are_equal_and_install_in_either_package():
    a = cat_u2i_arrays(seed=1)
    jg, tg = jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]
    jp, tp = jplan.query_to_plan(_query(jg)), tplan.query_to_plan(_query(tg))
    assert json.loads(json.dumps(tp)) == tp
    # the records are the JAX package's, SubGraph settings included
    assert tp == jp
    assert {(r["nbr_cap"], r["need_dist"]) for r in jp["nodes"]} == \
        {(None, False)}
    # each package's plan installs in the other's and records the same
    assert tplan.query_to_plan(tplan.plan_to_query(tg, jp)) == tp
    assert jplan.query_to_plan(jplan.plan_to_query(jg, tp)) == jp
    sub = dict(jp, nodes=jp["nodes"] + [dict(
        jp["nodes"][1], nid=len(jp["nodes"]), kind="subgraph", parent=0,
        alias_name=None, endpoint=False, nbr_cap=4)])
    # a SubGraph record installs in either package too
    assert tplan.query_to_plan(tplan.plan_to_query(tg, sub)) == sub
    assert jplan.query_to_plan(jplan.plan_to_query(jg, sub)) == sub
    q = tplan.plan_to_query(tg, jp)
    batch = glt.Dataset(q, window=1, device="cpu").next()
    assert batch["neg"].ids.shape == (8, 3)
    assert batch["walk"].ids.shape == (8, 2, 3)
    neg_cat = batch["neg"].int_attrs[:, 0, 0]
    assert bool((neg_cat == batch["dst"].int_attrs[:, 0]).all())


@pytest.mark.parametrize("broken", ["key", "parent", "source"])
def test_bad_plans_are_refused_as_in_jax(broken):
    a = cat_u2i_arrays(seed=1)
    jg, tg = jax_u2i_graph(a)[0], torch_u2i_graph(a)[0]
    plan = tplan.query_to_plan(_query(tg))
    if broken == "key":
        plan["nodes"] = [dict(r, condition={"int_colz": [0]})
                         if r["strategy"] == "conditional" else r
                         for r in plan["nodes"]]
    elif broken == "parent":
        plan["nodes"][3] = dict(plan["nodes"][3], parent=99)
    else:
        hop = next(r for r in plan["nodes"] if r["kind"] == "out_v")
        plan["nodes"] = [dict(hop, parent=None)]
    with pytest.raises(gl.InvalidArgumentError) as je:
        jplan.plan_to_query(jg, plan)
    with pytest.raises(InvalidArgumentError) as te:
        tplan.plan_to_query(tg, plan)
    assert str(te.value) == str(je.value)


def test_graph_direct_apis_equal_jax():
    a = cat_u2i_arrays(seed=2)
    jg, _, jidec = jax_u2i_graph(a)
    tg, _, tidec = torch_u2i_graph(a)
    assert tg.topology() == jg.topology() == {"u-i": ("u", "i"),
                                              "i-i": ("i", "i")}
    assert tg.get_node_decoder("i") is tidec
    assert tg.get_node_decoder("nope").attr_types == \
        jg.get_node_decoder("nope").attr_types == []
    assert tg.get_edge_decoder("u-i").weighted and \
        tg.get_edge_decoder("u-i").labeled
    assert not tg.get_edge_decoder("nope").weighted
    ids = np.arange(0, 50, 3)
    np.testing.assert_array_equal(tg.in_degrees(ids, "u-i"),
                                  jg.in_degrees(ids, "u-i"))
    np.testing.assert_array_equal(tg.out_degrees(ids + 100, "u-i"),
                                  jg.out_degrees(ids + 100, "u-i"))
    with pytest.raises(glt.NotFoundError):
        tg.in_degrees(np.array([999]), "u-i")
    eids = np.array([-1, 0, 5, 17, 399])
    want = jg.lookup_edges("u-i", eids)
    got = tg.lookup_edges("u-i", eids)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        x = got[k].materialize() if k == "float_attrs" else got[k]
        np.testing.assert_array_equal(x.numpy(), np.asarray(v), k)
    nodes = tg.lookup_nodes("i", np.array([1, 4]))
    np.testing.assert_array_equal(nodes.int_attrs.numpy(), a["i_int"][[1, 4]])


def test_ego_and_temporal_graph_accessors():
    n0 = Nodes(ids=torch.arange(4, dtype=torch.int32))
    n1 = Nodes(ids=torch.zeros((4, 2), dtype=torch.int32))
    ego = tdata.EgoGraph(src=n0, hops=[n1], nbr_nums=(2,))
    assert ego.batch_size == 4 and ego.hop_node(0) is n1
    assert n0.batch_size == 4
    e1 = Edges(edge_ids=n1.ids, src_nodes=n1, dst_nodes=n1)
    t1 = torch.ones(4, 2)
    tg = tdata.TemporalGraph(src=n0, src_t=torch.zeros(4), nbr_nodes=[n1],
                             nbr_t=[t1], nbr_edges=[e1], nbr_nums=(2,))
    assert tg.batch_size == 4
    assert tg.hop_node(0) is n1 and tg.hop_edge(0) is e1 and tg.hop_t(0) is t1
    # the same accessors as the JAX package's
    for cls, jcls in ((tdata.EgoGraph, jdata.EgoGraph),
                      (tdata.TemporalGraph, jdata.TemporalGraph)):
        names = {n for n in dir(jcls) if n.startswith("hop_")
                 or n == "batch_size"}
        assert names <= set(dir(cls)), (cls, names - set(dir(cls)))


def test_every_setter_sets_its_flag():
    jnames = {n for n in dir(jconfig) if n.startswith("set_")}
    tnames = {n for n in dir(tconfig) if n.startswith("set_")}
    # every setter of the JAX package has its counterpart (the parallel
    # store's too, since its port)
    assert jnames == tnames
    values = {"padding_mode": 0, "default_neighbor_id": 7,
              "sampling_retry_times": 2, "default_full_nbr_num": 12,
              "dataset_capacity": 4, "seed": 9, "storage_device": "device",
              "field_delimiter": ";", "knn_metric": 1, "graph_shards": 4,
              "partition_routing": "psum"}
    setters = {"set_retry_times": "sampling_retry_times"}
    # flags no ported code reads: their setters refuse, and the port keeps
    # no field for them (file ingest reads the field delimiter and k-NN
    # the metric, so theirs set them)
    refused = {"set_default_int_attribute": "JAX package either",
               "set_default_float_attribute": "JAX package either",
               "set_default_string_attribute": "JAX package either",
               "set_tape_capacity": "JAX package either",
               "set_storage_mode": "JAX package either"}
    old = {f: getattr(glt.conf, f) for f in values}
    try:
        for name in sorted(tnames - {"set_use_pallas"} - set(refused)):
            field = setters.get(name, name[len("set_"):])
            getattr(glt, name)(values[field])
            assert getattr(glt.conf, field) == values[field], name
            assert hasattr(jconfig.conf, field), name
    finally:
        for f, v in old.items():
            setattr(glt.conf, f, v)
    before = dataclasses.asdict(glt.conf)
    for name, why in refused.items():
        with pytest.raises(UnimplementedError,
                           match=f"{name} is not ported: .*{why}"):
            getattr(glt, name)(1)
    assert dataclasses.asdict(glt.conf) == before
    with pytest.raises(InvalidArgumentError, match="no counterpart"):
        glt.set_use_pallas(True)
    for name in ("FeatureSpec", "Nodes", "Edges", "SparseNodes",
                 "SparseEdges", "SubGraphVal", "UnimplementedError",
                 "register_sampler", "register_filesystem", "KnnOption"):
        assert name in glt.__all__ and hasattr(glt, name), name


def _tgat_inputs(b, k, d, e_dec, seed=0):
    """One-hop TemporalGraph inputs whose hop edges carry a float and a
    categorical column."""
    rng = np.random.default_rng(seed)
    return {"src": rng.standard_normal((b, d)).astype(np.float32),
            "nbr": rng.standard_normal((b, k, d)).astype(np.float32),
            "ef": rng.standard_normal((b, k, e_dec.float_attr_num)).astype(
                np.float32),
            "ei": rng.integers(0, 9, (b, k, e_dec.int_attr_num)).astype(
                np.int32),
            "t": rng.uniform(0, 100, (b, k)).astype(np.float32)}


@pytest.mark.parametrize("proj", [None, 3])
def test_ego_tgat_with_edge_encoders_equals_flax(proj, monkeypatch):
    d, T, k, b = 5, 4, 3, 6
    types, dims = ["float", "float", ("int", 7)], [None, None, 3]
    jedec = gl.Decoder(attr_types=types, attr_dims=dims)
    tedec = glt.Decoder(attr_types=types, attr_dims=dims)
    e_w = FeatureEncoder.out_dim(tedec, proj)
    orig = jtgat.EgoGATConv

    def conv(in_dim, **kw):
        if in_dim == (1, 2):
            in_dim = (d + T, d + e_w + T)
        return orig(in_dim=in_dim, **kw)
    monkeypatch.setattr(jtgat, "EgoGATConv", conv)
    x = _tgat_inputs(b, k, d, tedec)
    jn = [JNodes(ids=jnp.zeros(s, jnp.int32), float_attrs=jnp.asarray(f))
          for s, f in (((b,), x["src"]), ((b, k), x["nbr"]))]
    je = JEdges(edge_ids=jn[1].ids, src_nodes=jn[1], dst_nodes=jn[1],
                float_attrs=jnp.asarray(x["ef"]),
                int_attrs=jnp.asarray(x["ei"]))
    jtg = jdata.TemporalGraph(src=jn[0], src_t=jnp.zeros(b), nbr_nodes=[jn[1]],
                              nbr_t=[jnp.asarray(x["t"])], nbr_edges=[je],
                              nbr_nums=(k,))
    tn = [Nodes(ids=torch.zeros(s, dtype=torch.int32),
                float_attrs=torch.from_numpy(f))
          for s, f in (((b,), x["src"]), ((b, k), x["nbr"]))]
    te = Edges(edge_ids=tn[1].ids, src_nodes=tn[1], dst_nodes=tn[1],
               float_attrs=torch.from_numpy(x["ef"]),
               int_attrs=torch.from_numpy(x["ei"]))
    ttg = tdata.TemporalGraph(src=tn[0], src_t=torch.zeros(b),
                              nbr_nodes=[tn[1]],
                              nbr_t=[torch.from_numpy(x["t"])],
                              nbr_edges=[te], nbr_nums=(k,))
    ndec = gl.Decoder(attr_types=["float"] * d)
    jm = jtgat.EgoTGAT(hidden_dim=6, out_dim=4, time_dim=T, num_hops=1,
                       encoders=[JEnc(ndec)] * 2,
                       edge_encoders=[JEnc(jedec, output_dim=proj)],
                       num_head=2)
    p = jm.init(jax.random.key(1), jtg)
    assert "embedding_2" in p["params"]["edge_encoders_0"]
    tdec = glt.Decoder(attr_types=["float"] * d)
    tm = EgoTGAT(6, 4, T, 1, [FeatureEncoder(tdec)] * 2, num_head=2,
                 device="cpu",
                 edge_encoders=[FeatureEncoder(tedec, output_dim=proj)])
    np_p = jax.tree_util.tree_map(np.asarray, p)
    load_flax_params(tm, np_p)
    assert_trees_close(to_flax_params(tm), np_p, rtol=0, atol=0)
    got = tm(ttg)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.apply(p, jtg)), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(InvalidArgumentError, match="one width"):
        EgoTGAT(6, 4, T, 2, [FeatureEncoder(tdec)] * 3, edge_dim=2,
                device="cpu",
                edge_encoders=[FeatureEncoder(tedec), None])
