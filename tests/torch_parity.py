"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

One numpy graph, made from a seed, is loaded into both packages: the JAX
reference (``graph_learn_tpu``) and the PyTorch port
(``graph_learn_tpu_torch``, on the CPU).  The layout is the benchmark's: one
"item" node type with float features and labels, one weighted "rel" edge
type, uniformly random edges.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np


def numpy_graph(n: int = 300, avg_degree: int = 6, d: int = 8,
                classes: int = 4, seed: int = 0,
                weighted: bool = True,
                isolated: int = 0) -> Dict[str, np.ndarray]:
    """Arrays of a random graph.  The last ``isolated`` nodes get no
    out-edges, so a test has zero-degree seeds."""
    rng = np.random.default_rng(seed)
    e = n * avg_degree
    src = rng.integers(0, n - isolated, e)
    dst = rng.integers(0, n, e)
    return {
        "raw_ids": np.arange(n, dtype=np.int64) * 3 + 7,  # not dense
        "feats": rng.standard_normal((n, d), np.float32),
        "labels": rng.integers(0, classes, n).astype(np.int32),
        "src": src, "dst": dst,
        "weights": rng.random(e).astype(np.float32) if weighted else None,
    }


def jax_graph(a: Dict[str, np.ndarray]):
    """The JAX package's Graph over ``a`` (built as bench.py builds it)."""
    from graph_learn_tpu.core.schema import Decoder
    from graph_learn_tpu.core.store import EdgeTable, NodeTable
    from graph_learn_tpu.graph import Graph

    n, d = a["feats"].shape
    node_dec = Decoder(labeled=True, attr_types=["float"] * d)
    edge_dec = Decoder(weighted=a["weights"] is not None)
    g = Graph()
    g.store.add_node_table(NodeTable("item", node_dec, a["raw_ids"],
                                     float_attrs=a["feats"],
                                     labels=a["labels"]))
    g.store.add_edge_table(EdgeTable("rel", "item", "item", edge_dec,
                                     src=a["src"], dst=a["dst"],
                                     num_src_nodes=n, num_dst_nodes=n,
                                     weights=a["weights"]))
    g._node_decoders["item"] = node_dec
    g._edge_decoders["rel"] = edge_dec
    g._initialized = True
    return g, node_dec


def torch_graph(a: Dict[str, np.ndarray]):
    """The port's Graph over ``a``, on the CPU."""
    import graph_learn_tpu_torch as glt

    n, d = a["feats"].shape
    node_dec = glt.Decoder(labeled=True, attr_types=["float"] * d)
    edge_dec = glt.Decoder(weighted=a["weights"] is not None)
    g = glt.Graph(device="cpu")
    g.add_node_table(glt.NodeTable("item", node_dec, a["raw_ids"],
                                   float_attrs=a["feats"],
                                   labels=a["labels"]))
    g.add_edge_table(glt.EdgeTable("rel", "item", "item", edge_dec,
                                   src=a["src"], dst=a["dst"],
                                   num_src_nodes=n, num_dst_nodes=n,
                                   weights=a["weights"]))
    return g, node_dec


def two_hop(g, k1: int, k2: int, batch: int = 64):
    """The benchmark's 2-hop query shape on either package's Graph."""
    return (g.V("item").batch(batch).alias("src")
            .outV("rel").sample(k1).by("random").alias("hop1")
            .outV("rel").sample(k2).by("random").alias("hop2").values())


@contextlib.contextmanager
def both_confs(**fields):
    """Set the same config fields in both packages, restore them after."""
    from graph_learn_tpu.config import conf as jconf
    from graph_learn_tpu_torch.config import conf as tconf
    old = [(c, k, getattr(c, k)) for c in (jconf, tconf) for k in fields]
    try:
        for c in (jconf, tconf):
            for k, v in fields.items():
                setattr(c, k, v)
        yield
    finally:
        for c, k, v in old:
            setattr(c, k, v)


def degree_one_graph(n: int = 40, d: int = 8, classes: int = 3,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Arrays of a graph where every node has exactly one out-edge, so that
    neighbour sampling is deterministic in both packages.  Labels follow
    the features (argmax of the first ``classes`` columns), so a model can
    learn them."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d), np.float32)
    return {
        "raw_ids": np.arange(n, dtype=np.int64) * 3 + 7,
        "feats": feats,
        "labels": feats[:, :classes].argmax(axis=1).astype(np.int32),
        "src": np.arange(n), "dst": rng.permutation(n),
        "weights": None,
    }


def flax_grad_tree(model) -> Dict:
    """The gradients of the port's EgoGNN parameters as the flax tree:
    ``layers.0.convs.0.x_0.weight`` -> params/layers_0/convs_0/x_0/kernel,
    transposed as a flax Dense kernel is (``nn/convert.py to_flax_params``
    gives the parameters themselves)."""
    tree: Dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            path = ["layers_" + parts[1], "convs_" + parts[3]] + parts[4:-1]
        else:
            path = parts[:-1]
        sub = tree
        for key in path:
            sub = sub.setdefault(key, {})
        a = p.grad.cpu().numpy()
        sub["kernel" if parts[-1] == "weight" else "bias"] = (
            a.T.copy() if parts[-1] == "weight" else a.copy())
    return {"params": tree}


def grad_tree(model) -> Dict:
    """The gradients of the port model's parameters as its flax tree:
    ``to_flax_params`` of a copy that holds them (zeros where a parameter
    has none), embedding tables included."""
    import copy

    import torch

    from graph_learn_tpu_torch.nn.convert import to_flax_params
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), clone.parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return to_flax_params(clone)


def assert_trees_close(got: Dict, want: Dict, path: str = "", **tol):
    """Two nested dicts of arrays: same keys, allclose leaves."""
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], path + "/" + k, **tol)
        else:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]),
                err_msg=path + "/" + k, **tol)


def ego_pair(d: int, mode: str = "materialised", op: str = "mean",
             b: int = 6, k1: int = 3, k2: int = 4, classes: int = 4,
             seed: int = 3):
    """The same 2-hop batch as a JAX EgoGraph and a port EgoGraph, plus its
    int32 labels [b]; the deepest hop ``materialised``, ``deferred``
    (DeferredRows) or ``preagg`` (PreAggregatedRows reduced with ``op``)."""
    import jax.numpy as jnp
    import torch

    from graph_learn_tpu.core.values import Nodes as JaxNodes
    from graph_learn_tpu.nn import data as jdata
    from graph_learn_tpu.ops.aggregate import \
        gather_group_agg as jax_gather_group_agg
    from graph_learn_tpu_torch.core.values import Nodes
    from graph_learn_tpu_torch.nn import data as tdata
    from graph_learn_tpu_torch.ops.aggregate import gather_group_agg

    rng = np.random.default_rng(seed)
    table = rng.standard_normal((120, d)).astype(np.float32)
    ids = [rng.integers(0, 120, s).astype(np.int32)
           for s in ((b,), (b, k1), (b, k1, k2))]
    labels = rng.integers(0, classes, b).astype(np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jn = [JaxNodes(ids=jnp.asarray(i), float_attrs=jt[i], type_name="item")
          for i in ids]
    tn = [Nodes(ids=torch.from_numpy(i), float_attrs=tt[torch.from_numpy(i)],
                type_name="item") for i in ids]
    if mode == "deferred":
        jn[2] = jn[2].replace(float_attrs=jdata.DeferredRows(jt, jn[2].ids))
        tn[2] = tn[2].replace(float_attrs=tdata.DeferredRows(tt, tn[2].ids))
    elif mode == "preagg":
        jn[2] = jn[2].replace(float_attrs=jdata.PreAggregatedRows(
            jax_gather_group_agg(jt, jn[2].ids, op=op), op))
        tn[2] = tn[2].replace(float_attrs=tdata.PreAggregatedRows(
            gather_group_agg(tt, tn[2].ids, op=op), op))
    else:
        assert mode == "materialised", mode
    return (jdata.EgoGraph(src=jn[0], hops=jn[1:], nbr_nums=(k1, k2)),
            tdata.EgoGraph(src=tn[0], hops=tn[1:], nbr_nums=(k1, k2)),
            labels)


def u2i_arrays(n_u: int = 60, n_i: int = 50, e_ui: int = 400,
               e_ii: int = 200, d: int = 8, seed: int = 0,
               hub: int = 0) -> Dict[str, np.ndarray]:
    """Arrays of a weighted two-type graph: users "u" and items "i" with
    float features (items also weighted), weighted and labelled "u-i" and
    "i-i" edges, uniformly random.  The last user is isolated.  ``hub``
    extra "u-i" edges go from user 0 to random items, so that its row is
    longer than a 128-lane window pair (256)."""
    rng = np.random.default_rng(seed)
    ui_src = np.concatenate([rng.integers(0, n_u - 1, e_ui),
                             np.zeros(hub, np.int64)])
    ui_dst = np.concatenate([rng.integers(0, n_i, e_ui),
                             rng.integers(0, n_i, hub)])
    return {
        "u_feat": rng.standard_normal((n_u, d), np.float32),
        "i_feat": rng.standard_normal((n_i, d), np.float32),
        "i_weights": rng.random(n_i).astype(np.float32),
        "ui_src": ui_src, "ui_dst": ui_dst,
        "ui_w": rng.random(ui_src.size).astype(np.float32),
        "ui_labels": rng.integers(0, 3, ui_src.size).astype(np.int32),
        "ii_src": rng.integers(0, n_i, e_ii),
        "ii_dst": rng.integers(0, n_i, e_ii),
        "ii_w": rng.random(e_ii).astype(np.float32),
    }


# the categorical item columns of cat_u2i_arrays: a bucketed category, a
# hashed brand string and multi-value hashed tags, each embedded
CAT_TYPES = [("int", 5), ("string", 37), ("string", 23, True)]
CAT_DIMS = [4, 3, 5]
CAT_MV_LEN = 3


def cat_u2i_arrays(n_cat: int = 4, **kw) -> Dict[str, np.ndarray]:
    """``u2i_arrays`` with categorical item attributes: the attribute
    strings ``"<category>:brand_<j>:<tag>,<tag>,..."`` (categories in
    [0, n_cat), so one bucket row is never used; 0-4 tags, so rows are
    empty and rows are cut at ``CAT_MV_LEN``) and their columns as the
    JAX package's ``_parse_attrs`` makes them (``i_int`` [n_i, 2],
    ``i_mv`` [n_i, 1, 3], ``i_mv_lens`` [n_i, 1])."""
    from graph_learn_tpu.core.ingest import _parse_attrs
    from graph_learn_tpu.core.schema import Decoder
    a = u2i_arrays(**kw)
    n_i = a["i_feat"].shape[0]
    rng = np.random.default_rng(kw.get("seed", 0) + 11)
    cat = rng.integers(0, n_cat, n_i)
    strs = []
    for i in range(n_i):
        tags = ["tag_%d" % t for t in rng.integers(0, 40, rng.integers(0, 5))]
        strs.append("%d:brand_%d:%s" % (cat[i], rng.integers(0, 30),
                                         ",".join(tags)))
    a["i_attr_strs"] = strs
    dec = Decoder(attr_types=CAT_TYPES, attr_dims=CAT_DIMS,
                  multival_max_len=CAT_MV_LEN)
    a["i_int"], _, a["i_mv"], a["i_mv_lens"] = _parse_attrs(strs, dec)
    return a


def cat_item_decoder(mod, d: int):
    """The item decoder of ``cat_u2i_arrays`` in ``mod``: ``d`` floats,
    then the categorical columns."""
    return mod.Decoder(weighted=True,
                       attr_types=["float"] * d + CAT_TYPES,
                       attr_dims=[None] * d + CAT_DIMS,
                       multival_max_len=CAT_MV_LEN)


def _u2i_tables(mod, a):
    """(node tables, edge tables) of ``a`` built with ``mod``'s
    NodeTable / EdgeTable / Decoder; with ``cat_u2i_arrays``' columns the
    items carry them."""
    n_u, d = a["u_feat"].shape
    n_i = a["i_feat"].shape[0]
    udec = mod.Decoder(attr_types=["float"] * d)
    cat = {}
    if "i_int" in a:
        idec = cat_item_decoder(mod, d)
        cat = dict(int_attrs=a["i_int"], multival_attrs=a["i_mv"],
                   multival_lens=a["i_mv_lens"])
    else:
        idec = mod.Decoder(weighted=True, attr_types=["float"] * d)
    nodes = [mod.NodeTable("u", udec, np.arange(n_u, dtype=np.int64) + 100,
                           float_attrs=a["u_feat"]),
             mod.NodeTable("i", idec, np.arange(n_i, dtype=np.int64),
                           float_attrs=a["i_feat"], weights=a["i_weights"],
                           **cat)]
    edges = [mod.EdgeTable("u-i", "u", "i",
                           mod.Decoder(weighted=True, labeled=True),
                           src=a["ui_src"], dst=a["ui_dst"],
                           num_src_nodes=n_u, num_dst_nodes=n_i,
                           weights=a["ui_w"], labels=a["ui_labels"]),
             mod.EdgeTable("i-i", "i", "i", mod.Decoder(weighted=True),
                           src=a["ii_src"], dst=a["ii_dst"],
                           num_src_nodes=n_i, num_dst_nodes=n_i,
                           weights=a["ii_w"])]
    return nodes, edges, udec, idec


def jax_u2i_graph(a: Dict[str, np.ndarray]):
    """The JAX package's Graph over ``u2i_arrays``: (graph, udec, idec)."""
    import types

    from graph_learn_tpu.core import schema, store
    from graph_learn_tpu.graph import Graph

    mod = types.SimpleNamespace(Decoder=schema.Decoder,
                                NodeTable=store.NodeTable,
                                EdgeTable=store.EdgeTable)
    nodes, edges, udec, idec = _u2i_tables(mod, a)
    g = Graph()
    for t in nodes:
        g.store.add_node_table(t)
        g._node_decoders[t.type_name] = t.decoder
    for t in edges:
        g.store.add_edge_table(t)
        g._edge_decoders[t.type_name] = t.decoder
    g._initialized = True
    return g, udec, idec


def torch_u2i_graph(a: Dict[str, np.ndarray]):
    """The port's Graph over ``u2i_arrays``, on the CPU."""
    import graph_learn_tpu_torch as glt

    nodes, edges, udec, idec = _u2i_tables(glt, a)
    g = glt.Graph(device="cpu")
    for t in nodes:
        g.add_node_table(t)
    for t in edges:
        g.add_edge_table(t)
    return g, udec, idec


def temporal_arrays(n: int = 80, avg_degree: int = 6, seed: int = 0,
                    isolated: int = 4, ts_range: int = 400,
                    t0: int = 1_600_000_000,
                    edge_dim: int = 3) -> Dict[str, np.ndarray]:
    """``numpy_graph``'s arrays plus int64 epoch-style edge timestamps in
    [t0, t0 + ts_range) (narrow enough that rows hold ties) and
    ``edge_dim`` float edge features."""
    a = numpy_graph(n=n, avg_degree=avg_degree, seed=seed, isolated=isolated)
    rng = np.random.default_rng(seed + 7)
    e = a["src"].size
    a["ts"] = t0 + rng.integers(0, ts_range, e)
    a["edge_feats"] = rng.standard_normal((e, edge_dim), np.float32)
    return a


def temporal_table(mod, a: Dict[str, np.ndarray], name: str = "rel",
                   rows=slice(None)):
    """A weighted, timestamped item -> item edge table of ``a`` (the rows
    ``rows``) built with ``mod``'s EdgeTable / Decoder."""
    n = a["feats"].shape[0]
    dec = mod.Decoder(weighted=True, timestamped=True,
                      attr_types=["float"] * a["edge_feats"].shape[1])
    return mod.EdgeTable(name, "item", "item", dec, src=a["src"][rows],
                         dst=a["dst"][rows], num_src_nodes=n,
                         num_dst_nodes=n, weights=a["weights"][rows],
                         timestamps=a["ts"][rows],
                         float_attrs=a["edge_feats"][rows])


def jax_temporal_graph(a: Dict[str, np.ndarray], events=None):
    """The JAX package's Graph over ``temporal_arrays``: "item" nodes, the
    timestamped "rel" edges and, given ``events`` (a slice of the rows),
    an "ev" table of those rows; the ts bases unified as ``Graph.init``
    does."""
    import types

    from graph_learn_tpu.core import schema, store
    g, dec = jax_graph(a)
    mod = types.SimpleNamespace(Decoder=schema.Decoder,
                                EdgeTable=store.EdgeTable)
    tables = [temporal_table(mod, a)]
    if events is not None:
        tables.append(temporal_table(mod, a, "ev", events))
    for t in tables:
        g.store.add_edge_table(t)
        g._edge_decoders[t.type_name] = t.decoder
    store.unify_ts_bases(g.store)
    return g, dec


def torch_temporal_graph(a: Dict[str, np.ndarray], events=None):
    """The port's Graph over the same tables, on the CPU."""
    import graph_learn_tpu_torch as glt

    g, dec = torch_graph(a)
    g.add_edge_table(temporal_table(glt, a))
    if events is not None:
        g.add_edge_table(temporal_table(glt, a, "ev", events))
    return g, dec


STORE_COLUMNS = ("weights", "labels", "timestamps", "int_attrs",
                 "float_attrs", "multival_attrs", "multival_lens")


def store_equal(tg, jg):
    """Node tables, node sets, edge tables, both CSRs and the candidate
    pools of a port graph ``tg`` (views on the CPU) and a JAX graph ``jg``,
    bit for bit."""
    ts, js = tg.store, jg.store
    assert set(ts.nodes) == set(js.nodes)
    assert set(ts.edges) == set(js.edges)
    assert set(ts.node_sets) == set(js.node_sets)
    assert ts.topology == js.topology
    for t in js.nodes:
        a, b = ts.nodes[t], js.nodes[t]
        np.testing.assert_array_equal(a.raw_ids, b.raw_ids)
        for f in STORE_COLUMNS:
            if getattr(b, f) is None:
                assert getattr(a, f) is None, f
            else:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=t + "." + f)
    for t in js.node_sets:
        a, b = ts.node_sets[t], js.node_sets[t]
        assert a.base_type == b.base_type
        np.testing.assert_array_equal(a.indices, b.indices)
    for t in js.edges:
        a, b = ts.edges[t], js.edges[t]
        assert (a.src_type, a.dst_type, a.ts_base, a.ts_scale) == (
            b.src_type, b.dst_type, b.ts_base, b.ts_scale)
        for f in ("src", "dst") + STORE_COLUMNS:
            if getattr(b, f) is None:
                assert getattr(a, f) is None, f
            else:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=t + "." + f)
        ad, bd = a.device("cpu"), b.device()
        for direction in ("out", "inc"):
            ac, bc = getattr(ad, direction), getattr(bd, direction)
            for f in ("row_offsets", "nbr_ids", "nbr_edge_ids",
                      "nbr_ids_sorted", "cum_weights", "cum_in_degrees"):
                av, bv = getattr(ac, f), getattr(bc, f)
                if bv is None:
                    assert av is None
                else:
                    np.testing.assert_array_equal(av.numpy(), np.asarray(bv),
                                                  err_msg=t + direction + f)
        for f in ("unique_dst", "unique_dst_indeg_cdf", "unique_src",
                  "unique_src_outdeg_cdf"):
            np.testing.assert_array_equal(getattr(ad, f).numpy(),
                                          np.asarray(getattr(bd, f)))


# ---------------------------------------------------------------------------
# The parallel slice: a weighted, timestamped, labelled store written as
# files (tests/test_sharded_store.py's ``wts_graph``), loaded by both
# packages, and the rank functions that parallel/launch.py spawn runs
# (module-level, so the child processes import them from here).
# ---------------------------------------------------------------------------


def write_wts_files(where: str, n: int = 50):
    """tests/test_sharded_store.py ``wts_graph``'s files under ``where``."""
    import os
    rng = np.random.default_rng(3)
    with open(os.path.join(where, "nodes"), "w") as f:
        f.write("id:int64\tweight:float\tlabel:int64\tfeature:string\n")
        for i in range(n):
            feats = ":".join("%.4f" % x for x in rng.random(6))
            f.write("%d\t%.2f\t%d\t%s\n" % (i, 0.1 + i * 0.05, i % 4, feats))
    with open(os.path.join(where, "edges"), "w") as f:
        f.write("src_id:int64\tdst_id:int64\tweight:float\ttimestamp:int64\n")
        for i in range(n):
            for j in range(1 + i % 6):
                f.write("%d\t%d\t%.2f\t%d\n"
                        % (i, (i * 7 + j * 3 + 1) % n, 0.5 + j, 100 * i + j))
    with open(os.path.join(where, "train"), "w") as f:
        f.write("id:int64\tweight:float\n")
        for i in range(0, n, 2):
            f.write("%d\t1.0\n" % i)


def wts_graph(mod, where: str):
    """The store of :func:`write_wts_files` in ``mod`` (either package;
    the port's on the CPU)."""
    import os
    kw = {"device": "cpu"} if mod.__name__.endswith("_torch") else {}
    g = (mod.Graph(**kw)
         .node(os.path.join(where, "nodes"), "v",
               mod.Decoder(weighted=True, labeled=True,
                           attr_types=["float"] * 6))
         .edge(os.path.join(where, "edges"), ("v", "v", "e"),
               mod.Decoder(weighted=True, timestamped=True))
         .node(os.path.join(where, "train"), "v", mod.Decoder(weighted=True),
               mask=mod.Mask.TRAIN))
    return g.init()


def wts_queries(mod, g) -> Dict[str, object]:
    """The queries of tests/test_sharded_store.py, by case name."""
    M = mod.Mask
    qs = {}
    for s in ("random", "topk", "edge_weight", "in_degree",
              "random_without_replacement", "full"):
        qs["plan-" + s] = (g.V("v", mask=M.TRAIN).batch(8).alias("src")
                           .outV("e").sample(3).by(s).alias("h1")
                           .outV("e").sample(2).by("random").alias("h2")
                           .values())
    qs["temporal"] = (g.E("e").batch(6).alias("ev").outV().alias("src")
                      .outE("e").sample(3).by("edge_weight").alias("h1")
                      .values())
    qs["negatives"] = (g.V("v").batch(6).alias("src")
                       .outNeg("e").sample(4).by("in_degree").alias("neg")
                       .values())
    for name, p, q in (("deepwalk", 1.0, 1.0), ("node2vec", 0.5, 2.0)):
        qs["walk-" + name] = (g.V("v").batch(6).alias("src")
                              .random_walk(4, p=p, q=q, edge_type="e")
                              .alias("w").values())
    seed = g.E("e").batch(6).alias("seed")
    src = seed.outV().alias("src")
    seed.inV().alias("dst")
    (src.outNeg("e").sample(4).by("node_weight")
     .where("dst", {"float_cols": [0], "float_props": [0.5]}).alias("neg"))
    qs["conditional"] = seed.values()
    seed = g.E("e").batch(8).alias("ev")
    src = seed.outV().alias("src")
    seed.inV().alias("dst")
    src.outE("e").sample(3).by("edge_weight").filter("dst").alias("h1")
    qs["temporal-filter"] = seed.values()
    qs["routing"] = (g.V("v", mask=M.TRAIN).batch(8).alias("src")
                     .outV("e").sample(4).by("edge_weight").alias("h1")
                     .values())
    qs["overflow"] = (g.V("v").batch(128).alias("src")
                      .outV("e").sample(3).by("topk").alias("h1").values())
    for nd in (False, True):
        qs["subgraph-%s" % nd] = (g.V("v", mask=M.TRAIN).batch(8)
                                  .alias("src")
                                  .SubGraph("e", nbr_cap=8, need_dist=nd)
                                  .alias("sg").values())
    # deterministic hops with edge payloads: held against the JAX package
    qs["topk-edges"] = (g.V("v").batch(8).alias("src")
                        .outV("e").sample(3).by("topk").alias("h1")
                        .outE("e").sample(2).by("topk").alias("e2").values())
    return qs


WTS_SEEDS = {"temporal": 6, "negatives": 6, "walk-deepwalk": 6,
             "walk-node2vec": 6, "conditional": 6}


def wts_seeds(case: str) -> np.ndarray:
    """The seeds tests/test_sharded_store.py feeds each case."""
    if case == "overflow":
        return np.full(128, 7, np.int32)
    return np.arange(WTS_SEEDS.get(case, 8), dtype=np.int32)


def flat_result(res, prefix: str = "") -> Dict[str, object]:
    """{path: CPU tensor} of every tensor of a port plan result, feature
    rows materialised (a deferred gather's table left out)."""
    import dataclasses

    import torch

    from graph_learn_tpu_torch.core.values import DeferredRows, TensorStruct

    out = {}

    def walk(p, v):
        if isinstance(v, DeferredRows):
            out[p] = v.materialize().cpu()
        elif isinstance(v, TensorStruct):
            for f in dataclasses.fields(v):
                if not f.metadata.get("static"):
                    walk(p + "." + f.name, getattr(v, f.name))
        elif isinstance(v, torch.Tensor):
            out[p] = v.detach().cpu()

    for a, v in (res.items() if isinstance(res, dict) else [(prefix, res)]):
        walk(prefix + a, v)
    return out


def jax_flat_result(res) -> Dict[str, np.ndarray]:
    """{path: numpy} of a JAX plan result (flax struct dataclasses)."""
    import dataclasses

    out = {}

    def walk(p, v):
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(p + "." + f.name, getattr(v, f.name))
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            out[p] = np.asarray(v)

    for a, v in res.items():
        walk(a, v)
    return out


def _mismatch(a: Dict, b: Dict):
    """Keys whose tensors differ (bit for bit, NaN-free), or are missing."""
    import torch
    keys = sorted(set(a) | set(b))
    return [k for k in keys if k not in a or k not in b
            or a[k].shape != b[k].shape or a[k].dtype != b[k].dtype
            or not torch.equal(a[k], b[k])]


def _single(q, seeds, seed: int):
    import torch

    from graph_learn_tpu_torch.gsl.compile import _execute
    return flat_result(_execute(q, q.device_tables("cpu"),
                                torch.as_tensor(seeds),
                                torch.Generator().manual_seed(seed)))


def sharded_store_ranks(rank: int, world: int, where: str):
    """tests/test_torch_sharded_store.py's cases on 4 ranks: mesh (1, 4)
    (every plan against the single-device plan, bit for bit) and mesh
    (2, 2) (data parallelism), returning the mismatches and the results
    the test holds against the JAX package."""
    import torch

    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.core.sharding import COLLECTIVES
    from graph_learn_tpu_torch.parallel.mesh import make_mesh
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)
    from graph_learn_tpu_torch.parallel.train import make_partitioned_plan

    g = wts_graph(glt, where)
    qs = wts_queries(glt, g)
    out = {"bad": {}, "jax": {}}
    mesh = make_mesh(1, world, device="cpu")
    for case, q in qs.items():
        routings = ("owner", "psum") if case == "routing" else (None,)
        for routing in routings:
            name = case if routing is None else "routing-" + routing
            st = build_sharded_tables(q, world, shard=rank).place(mesh)
            plan = make_partitioned_plan(q, mesh, st, routing=routing)
            seeds = torch.as_tensor(wts_seeds(case))
            COLLECTIVES.reset()
            got = flat_result(plan(seeds, torch.Generator().manual_seed(5)))
            want = _single(q, seeds, 5)
            out["bad"][name] = _mismatch(got, want)
            if case == "overflow":
                out["overflow_calls"] = dict(COLLECTIVES.by_op("graph"))
            if case == "topk-edges":
                out["jax"]["1x%d" % world] = got
            if case.startswith("subgraph"):
                out[name + "-edges"] = int(got["sg.num_edges"])
    assert conf.owner_route_capacity == 2.0

    # mesh (2, 2): data parallelism; each data slice draws for its size
    mesh2 = make_mesh(2, world // 2, device="cpu")
    half = world // 2
    gi = rank % half
    et = g.store.edge_table("e")
    feats = torch.as_tensor(g.store.node_table("v").float_attrs)
    dp = {}
    for case in ("dp-random", "dp-owner"):
        q = (g.V("v").batch(8).alias("src")
             .outE("e").sample(3).by("random").alias("h1").values()
             if case == "dp-random" else
             g.V("v").batch(8).alias("src")
             .outV("e").sample(4).by("random").alias("h1").values())
        st = build_sharded_tables(q, half, shard=gi).place(mesh2)
        plan = make_partitioned_plan(q, mesh2, st,
                                     routing="owner" if case == "dp-owner"
                                     else None)
        res = flat_result(plan(torch.arange(8, dtype=torch.int32),
                               torch.Generator().manual_seed(2)))
        d = rank // half
        seeds = torch.arange(8, dtype=torch.int32)[d * 4:(d + 1) * 4]
        if case == "dp-random":
            ids, eids = res["h1.dst_nodes.ids"], res["h1.edge_ids"]
            ok = []
            for i in range(4):
                s = int(seeds[i])
                adm = set(et.dst[et.src == s].tolist())
                ok.append(set(ids[i].tolist()) <= adm)
            m = eids >= 0
            src = torch.as_tensor(et.src)[eids.clamp(min=0).long()]
            dst = torch.as_tensor(et.dst)[eids.clamp(min=0).long()]
            w = torch.as_tensor(et.weights)[eids.clamp(min=0).long()]
            dp[case] = dict(
                true_neighbours=all(ok),
                eids_consistent=bool(
                    (src[m] == seeds[:, None].expand_as(eids)[m].long()).all()
                    and (dst[m] == ids[m].long()).all()),
                feats=torch.equal(res["h1.dst_nodes.float_attrs"],
                                  feats[ids.long()]),
                weights=torch.equal(res["h1.weights"][m], w[m]))
        else:
            ids = res["h1.ids"]
            dp[case] = dict(feats=torch.equal(res["h1.float_attrs"],
                                              feats[ids.long()]))
    # topk under data parallelism: held against the JAX plan at P = 2
    q = qs["topk-edges"]
    st = build_sharded_tables(q, half, shard=gi).place(mesh2)
    plan = make_partitioned_plan(q, mesh2, st)
    out["jax"]["2x%d" % half] = flat_result(plan(
        torch.arange(8, dtype=torch.int32), torch.Generator().manual_seed(5)))
    # SubGraph x data parallelism: stacked [n_data, ...], each slice the
    # single-device induction of that shard's seeds
    q = qs["subgraph-True"]
    st = build_sharded_tables(q, half, shard=gi).place(mesh2)
    plan = make_partitioned_plan(q, mesh2, st)
    res = plan(torch.arange(8, dtype=torch.int32),
               torch.Generator().manual_seed(5))
    sg = res["sg"]
    stack_ok = []
    for d in range(2):
        want = {k: v for k, v in _single(
            q, np.arange(8, dtype=np.int32)[d * 4:(d + 1) * 4], 5).items()
            if k.startswith("sg.")}
        got = flat_result({"sg": sg.map(lambda x: x[d])})
        stack_ok.append(_mismatch(got, want))
    dp["dp-subgraph"] = dict(bad=stack_ok,
                             edges=int(sg.num_edges.sum()),
                             shape=tuple(sg.node_ids.shape))
    out["dp"] = dp
    out["dp"]["train"] = _partitioned_train_losses(g, mesh2, half, gi)
    return out


def _partitioned_train_losses(g, mesh, half: int, gi: int):
    """Three partitioned train steps of EgoGraphSAGE [6, 8, 4] on one
    repeated batch over mesh (2, 2) (tests/test_sharded_store.py
    ``test_partitioned_train_step_runs``): the losses and the parameters'
    checksum."""
    import torch

    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)
    from graph_learn_tpu_torch.parallel.train import (
        make_partitioned_train_step)

    q = (g.V("v", mask=glt.Mask.TRAIN).batch(8).alias("src")
         .outV("e").sample(4).by("edge_weight").alias("hop1")
         .outV("e").sample(2).by("random").alias("hop2").values())
    torch.manual_seed(0)
    model = EgoGraphSAGE([6, 8, 4], g.get_node_decoder("v"),
                         agg_type="mean", device="cpu")

    def loss_fn(m, batch, gen, training):
        ego = EgoGraph.from_query_result(batch, "src", ["hop1", "hop2"])
        return supervised_softmax_loss(m(ego, training=training,
                                         generator=gen),
                                       batch["src"].labels)

    st = build_sharded_tables(q, half, shard=gi).place(mesh)
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    step = make_partitioned_train_step(q, model, loss_fn, opt, mesh, st)
    losses = []
    for i in range(3):
        losses.append(float(step(torch.arange(8, dtype=torch.int32),
                                 torch.Generator().manual_seed(i))))
    return dict(losses=losses, params=torch.cat(
        [p.detach().reshape(-1) for p in model.parameters()]))


def halo_graph(n: int, e: int, seed: int = 0, weighted: bool = True):
    """tests/test_halo.py ``_random_graph``'s arrays: (src, dst, weights,
    feats [n, 8])."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) if weighted else None
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    return src, dst, w, feats


def gcn_arrays(n: int = 64, e: int = 500):
    """tests/test_halo.py ``test_full_graph_gcn_trains``'s homophilous
    two-block graph: (src, dst, feats, labels)."""
    rng = np.random.default_rng(11)
    labels = (np.arange(n) < n // 2).astype(np.int32)
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.9,
                   (src + rng.integers(1, n // 2, e)) % (n // 2)
                   + (src >= n // 2) * (n // 2),
                   rng.integers(0, n, e))
    feats = (labels[:, None] * 2.0 - 1.0) + \
        rng.standard_normal((n, 8)).astype(np.float32) * 2.0
    return src, dst, feats.astype(np.float32), labels


HALO_CASES = (("even", 64, 400, 0), ("uneven", 53, 300, 3))


def halo_ranks(rank: int, world: int, gcn_params):
    """tests/test_torch_halo.py's cases on 4 ranks: sharded_spmm (three
    aggregations, forward and the gradient of a fixed projection of it)
    at P = 4 on mesh (1, 4) and P = 2 on mesh (2, 2); ShardedGCN one step
    from the given flax parameters at P = 4, then 30 steps of training."""
    import torch

    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.parallel.full_graph import (
        ShardedGCN, make_full_graph_train_step)
    from graph_learn_tpu_torch.parallel.halo import sharded_spmm
    from graph_learn_tpu_torch.parallel.mesh import make_mesh
    from graph_learn_tpu_torch.parallel.partition import (partition_edges,
                                                          shard_features)

    out = {}
    for n_data in (1, 2):
        p = world // n_data
        gi = rank % p
        mesh = make_mesh(n_data, p, device="cpu")
        for name, n, e, seed in HALO_CASES:
            src, dst, w, feats = halo_graph(n, e, seed)
            et = glt.EdgeTable("e", "v", "v", glt.Decoder(weighted=True),
                               src=src, dst=dst, num_src_nodes=n,
                               num_dst_nodes=n, weights=w)
            sg = partition_edges(et, p)
            x = torch.as_tensor(shard_features(feats, p)[gi])
            proj = torch.as_tensor(np.random.default_rng(seed + 1)
                                   .standard_normal(x.shape)
                                   .astype(np.float32))
            for agg in ("sum", "mean", "weighted_sum"):
                xg = x.clone().requires_grad_(True)
                y = sharded_spmm(sg, xg, mesh, agg=agg)
                (y * proj).sum().backward()
                out[(p, name, agg)] = (y.detach(), xg.grad)
            out[(p, name, "halo_rows")] = int(sg.recv_offsets[gi, -1])
    # ShardedGCN [16, 2] at P = 4: one step from the flax parameters, then
    # training from them
    p = world
    mesh = make_mesh(1, p, device="cpu")
    src, dst, feats, labels = gcn_arrays()
    n = feats.shape[0]
    et = glt.EdgeTable("e", "v", "v", glt.Decoder(), src=src, dst=dst,
                       num_src_nodes=n, num_dst_nodes=n)
    sg = partition_edges(et, p)
    rows = sg.rows_per_shard
    x = torch.as_tensor(shard_features(feats, p)[rank])
    lab = torch.as_tensor(np.pad(labels, (0, p * rows - n))
                          .reshape(p, rows)).long()
    msk = torch.as_tensor(np.pad(np.ones(n, np.float32), (0, p * rows - n))
                          .reshape(p, rows))
    model = ShardedGCN([16, 2], sg, mesh, in_dim=8, device="cpu")
    with torch.no_grad():
        for i, layer in enumerate(model.dense):
            layer.weight.copy_(torch.as_tensor(gcn_params[i][0]).T)
            layer.bias.copy_(torch.as_tensor(gcn_params[i][1]))

    def loss_fn(logits, labels_, mask):
        ls = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 2), labels_.reshape(-1), reduction="none")
        m = mask.reshape(-1)
        return (ls * m).sum() / m.sum()

    opt = torch.optim.Adam(model.parameters(), lr=0.02)
    step = make_full_graph_train_step(model, opt, mesh, loss_fn)
    losses = [float(step(x, lab, msk))]
    out["gcn_step1"] = [(l.weight.detach().T.clone(), l.bias.detach().clone())
                        for l in model.dense]
    for _ in range(29):
        losses.append(float(step(x, lab, msk)))
    out["gcn_losses"] = losses
    return out


def _wts_sage(g, dims=(6, 8, 4)):
    """EgoGraphSAGE over the wts store, its weights drawn from seed 0 (the
    same on every rank), and its loss function."""
    import torch

    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE

    torch.manual_seed(0)
    model = EgoGraphSAGE(list(dims), g.get_node_decoder("v"),
                         agg_type="mean", device="cpu")
    hops = ["hop1", "hop2"][:len(dims) - 1]

    def loss_fn(m, batch, gen, training):
        ego = EgoGraph.from_query_result(batch, "src", hops)
        return supervised_softmax_loss(m(ego, training=training,
                                         generator=gen),
                                       batch["src"].labels)
    return model, loss_fn


def _params(model):
    import torch
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def parallel_ranks(rank: int, world: int, where: str):
    """tests/test_torch_parallel.py's cases on 2 ranks: meshes (1, 2) and
    (2, 1), shard_tables, the placement rules, the sharded and
    data-parallel steps and DistTrainer, each held to one process."""
    import warnings

    import torch

    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.core.sharding import ShardedNodeTable
    from graph_learn_tpu_torch.core.store import DeviceNodeTable
    from graph_learn_tpu_torch.gsl.compile import _execute
    from graph_learn_tpu_torch.nn.trainer import LocalTrainer
    from graph_learn_tpu_torch.parallel.mesh import (make_mesh,
                                                     params_sharding_rules,
                                                     shard_tables)
    from graph_learn_tpu_torch.parallel.train import (DistTrainer,
                                                      make_sharded_train_step)

    out = {}
    m12 = make_mesh(1, 2, device="cpu")
    m21 = make_mesh(2, 1, device="cpu")
    out["shapes"] = (tuple(m12.shape), tuple(m21.shape),
                     tuple(m12.mesh_dim_names))

    # shard_tables: rows that do not divide the graph axis are replicated
    # with the JAX package's warning; divisible ones shard
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shard_tables({"nodes": {"item": {
            "float_attrs": torch.ones((41, 4)),
            "labels": torch.zeros((41,), dtype=torch.int32)}},
            "edges": {}}, m12)
        ok = shard_tables({"nodes": {"item": DeviceNodeTable(
            raw_ids=torch.arange(40), float_attrs=torch.ones((40, 4)))},
            "edges": {}}, m12)
    out["warnings"] = [str(w.message) for w in rec]
    nt = ok["nodes"]["item"]
    out["sharded_rows"] = (isinstance(nt, ShardedNodeTable)
                           and nt.local.float_attrs.shape[0] == 20
                           and nt.num_nodes == 40)

    # placement rules: the JAX rule's answer; every rank holds every
    # parameter all the same
    emb = torch.nn.Module()
    emb.embedding = torch.nn.Parameter(torch.ones(4, 3))
    emb.dense = torch.nn.Linear(3, 2)
    out["rules"] = (params_sharding_rules(emb, m12),
                    params_sharding_rules(emb, m21))

    g = wts_graph(glt, where)
    q = (g.V("v").batch(16).alias("src")
         .outV("e").sample(4).by("random").alias("hop1")
         .outV("e").sample(2).by("random").alias("hop2").values())
    seeds = torch.arange(16, dtype=torch.int32)

    # (1, 2): node payloads sharded, CSR whole; the same batch as one
    # process (the graph ranks draw alike), so the same loss
    model, loss_fn = _wts_sage(g)
    before = _params(model)
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    step = make_sharded_train_step(q, model, loss_fn, opt, m12)
    tables = shard_tables(q.device_tables("cpu"), m12)
    out["sharded_tables"] = isinstance(tables["nodes"]["v"],
                                       ShardedNodeTable)
    loss = float(step(tables, seeds, torch.Generator().manual_seed(1)))
    ref, _ = _wts_sage(g)
    with torch.no_grad():
        ref_loss = float(loss_fn(ref, _execute(
            q, q.device_tables("cpu"), seeds,
            torch.Generator().manual_seed(1)), None, True))
    out["sharded_step"] = dict(loss=loss, ref_loss=ref_loss,
                               moved=float((_params(model) - before)
                                           .abs().max()))

    # (2, 1) on topk: the data-parallel step against one process's step
    # on the whole batch
    qt = (g.V("v").batch(16).alias("src")
          .outV("e").sample(4).by("topk").alias("hop1")
          .outV("e").sample(2).by("topk").alias("hop2").values())
    model, loss_fn = _wts_sage(g)
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    step = make_sharded_train_step(qt, model, loss_fn, opt, m21)
    loss = float(step(qt.device_tables("cpu"), seeds,
                      torch.Generator().manual_seed(1)))
    ref, _ = _wts_sage(g)
    ropt = torch.optim.Adam(ref.parameters(), lr=0.05)
    batch = _execute(qt, qt.device_tables("cpu"), seeds,
                     torch.Generator().manual_seed(1))
    rl = loss_fn(ref, batch, None, True)
    ropt.zero_grad()
    rl.backward()
    ropt.step()
    out["dp_step"] = dict(loss=loss, ref_loss=float(rl),
                          params=_params(model), ref_params=_params(ref))
    # random draws under data parallelism: each data slice draws for its
    # own size (the JAX data-parallel step draws for the whole batch)
    from graph_learn_tpu_torch.core.sharding import bind_mesh
    from graph_learn_tpu_torch.parallel.train import data_slice
    with bind_mesh(m21):
        mine = data_slice(seeds)
    got = _execute(q, q.device_tables("cpu"), mine,
                   torch.Generator().manual_seed(1))["hop1"].ids
    whole = _execute(q, q.device_tables("cpu"), seeds,
                     torch.Generator().manual_seed(1))["hop1"].ids
    et = g.store.edge_table("e")
    out["dp_draws"] = dict(
        slice=mine.tolist(),
        differs=not torch.equal(got, whole[rank * 8:(rank + 1) * 8]),
        true=all(set(got[i].tolist()) <= set(
            et.dst[et.src == int(mine[i])].tolist()) for i in range(8)))

    # DistTrainer at (2, 1) against LocalTrainer on one process
    q1 = (g.V("v").batch(16).alias("src")
          .outV("e").sample(3).by("topk").alias("hop1").values())
    model, loss_fn = _wts_sage(g, (6, 5))
    trainer = DistTrainer(m21, device="cpu")
    _, hist = trainer.train(q1, model, loss_fn,
                            torch.optim.SGD(model.parameters(), lr=0.1),
                            epochs=2, verbose=False)
    ref, _ = _wts_sage(g, (6, 5))
    _, ref_hist = LocalTrainer(seed=0, device="cpu").train(
        q1, ref, loss_fn, torch.optim.SGD(ref.parameters(), lr=0.1),
        epochs=2, verbose=False)
    out["dist_trainer"] = dict(hist=hist, ref_hist=ref_hist,
                               params=_params(model), ref_params=_params(ref),
                               partitioned=trainer.partitioned)

    # DistTrainer at (1, 2) above the threshold: the partitioned store,
    # whose plan equals one process's (random draws included)
    model, loss_fn = _wts_sage(g)
    trainer = DistTrainer(m12, device="cpu", partition_above_bytes=0)
    _, hist = trainer.train(q, model, loss_fn,
                            torch.optim.Adam(model.parameters(), lr=0.05),
                            epochs=1, verbose=False)
    ref, _ = _wts_sage(g)
    _, ref_hist = LocalTrainer(seed=0, device="cpu").train(
        q, ref, loss_fn, torch.optim.Adam(ref.parameters(), lr=0.05),
        epochs=1, verbose=False)
    out["partitioned_trainer"] = dict(
        hist=hist, ref_hist=ref_hist, params=_params(model),
        ref_params=_params(ref), partitioned=trainer.partitioned,
        block_rows=trainer.stables.placed["nodes"]["v"]["raw_ids"].shape[0])
    # below the threshold: shard_tables
    model, loss_fn = _wts_sage(g)
    trainer = DistTrainer(m12, device="cpu")
    _, hist = trainer.train(q, model, loss_fn,
                            torch.optim.Adam(model.parameters(), lr=0.05),
                            epochs=1, verbose=False)
    out["replicated_trainer"] = dict(hist=hist,
                                     partitioned=trainer.partitioned)
    # examples/routing_bytes.py's counts at P = 2
    from graph_learn_tpu_torch.examples import routing_bytes
    out["routing"] = routing_bytes.rank_bytes(rank, world, steps=1)
    return out


@contextlib.contextmanager
def one_rank_group(where: str):
    """A gloo process group of this process alone (a FileStore under
    ``where``) for the code inside."""
    import os

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        where, "store"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def failing_rank(rank: int, world: int):
    """A rank function whose rank 1 raises (tests/test_torch_multiprocess.py)."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one gives up")
    dist.barrier()
    return rank


def sleeping_rank(rank: int, world: int, seconds: float):
    """A rank function whose rank 0 outlives any short deadline."""
    import time
    if rank == 0:
        time.sleep(seconds)
    return rank


def echo_rank(rank: int, world: int, tag: str):
    """Each rank's (rank, world, tag, device, the world's sum of ranks)."""
    import torch
    import torch.distributed as dist

    from graph_learn_tpu_torch.parallel import bootstrap
    x = torch.tensor([rank])
    dist.all_reduce(x)
    return rank, world, tag, str(bootstrap.current_device()), int(x)


# --- partitioned serving and the sharded k-NN index ----------------------

PART_IDS = np.array([0, 5, 17, 123, 999, 1500, 1999, 3], np.int64)
PART_RANDOM_SIZES = (1, 5, 8, 13, 20)
INC_ORACLE_IDS = (100, 600, 1100, 1600, 1999)
INC_REFRESHES = 5


def write_partition_files(where: str) -> Dict[str, Dict[str, str]]:
    """tests/test_online.py's partitioned-serving files: "part" (:381-446,
    32 features) and "inc" (:449-543, 16 features), each 2 000 nodes with
    8 weighted out-edges; {name: {"nodes", "edges", "f"}}."""
    import os
    out = {}
    for name, seed, f in (("part", 0, 32), ("inc", 1, 16)):
        rng = np.random.default_rng(seed)
        n, deg = 2000, 8
        paths = {"nodes": os.path.join(where, name + "_nodes"),
                 "edges": os.path.join(where, name + "_edges"), "f": f}
        with open(paths["nodes"], "w") as fh:
            fh.write("id:int64\tfeature:string\n")
            for i in range(n):
                fh.write("%d\t%s\n" % (i, ":".join(
                    "%.3f" % x for x in rng.random(f))))
        with open(paths["edges"], "w") as fh:
            fh.write("src_id:int64\tdst_id:int64\tweight:float\n")
            for i in range(n):
                for j in range(deg):
                    fh.write("%d\t%d\t%.2f\n" % (i, (i * 13 + j * 7) % n,
                                                 j + 1.0))
        out[name] = paths
    return out


def partition_graph(mod, paths: Dict[str, str]):
    """Either package's Graph over one set of those files ("v" / "e"); the
    port's on the CPU."""
    kw = {"device": "cpu"} if mod.__name__ == "graph_learn_tpu_torch" else {}
    return (mod.Graph(**kw)
            .node(paths["nodes"], "v",
                  mod.Decoder(attr_types=["float"] * paths["f"]))
            .edge(paths["edges"], ("v", "v", "e"),
                  mod.Decoder(weighted=True))).init()


def part_topk(g, batch: int = 8):
    return (g.V("v").batch(batch).alias("src")
            .outV("e").sample(3).by("topk").alias("h1").values())


def _flat_block(tree, prefix: str = "") -> Dict:
    """A placed or host block (nested dicts of arrays) as {path: tensor}."""
    import torch
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_block(v, prefix + k + "/"))
        else:
            out[prefix + k] = torch.as_tensor(v)
    return out


def partitioned_serving_ranks(rank: int, world: int, files):
    """tests/test_torch_partitioned_serving.py's cases on ``world`` ranks,
    each on a partitioned QueryService of its own (every rank builds it;
    rank 0 leads, the others follow until it closes): the topk answers,
    the bytes a rank holds and a streamed update (every world); at two
    ranks also the random answers against the one-rank service, the
    refusals, SubGraph rounds and the incremental refresh of
    tests/test_online.py:449-543 with every rank's block after each
    refresh."""
    import threading

    import torch

    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.config import conf
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.online import serving
    from graph_learn_tpu_torch.online.update import (UpdateBuffer,
                                                     apply_updates)
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)

    out = {"followed": 0}

    def service(g):
        svc = serving.QueryService(g, device="cpu", graph_shards=world)
        if rank:
            try:  # models stay on the leader
                svc.install_model("m", b"")
            except glt.InvalidArgumentError:
                out["model_refused"] = True
            svc.follow()
            out["followed"] += 1
            return None
        return svc

    # the topk case (tests/test_online.py:381-446)
    g = partition_graph(glt, files["part"])
    svc = service(g)
    if svc is not None:
        qid = svc.install(part_topk(g), micro_batch=8)
        ans = svc.run(qid, PART_IDS)["h1"]
        out["topk"] = (ans.ids, ans.float_attrs)
        out["bytes"] = (build_sharded_tables(part_topk(g), world)
                        .bytes_per_device(),
                        nbytes(part_topk(g).device_tables("cpu")))
        out["block"] = svc._queries[qid]._snap.tables.device_bytes()
        buf = UpdateBuffer()
        buf.add_edges("e", src_ids=[0, 0, 0], dst_ids=[42, 43, 44],
                      weights=[99.0, 98.0, 97.0])
        apply_updates(g, buf)
        svc.refresh()
        out["after"] = svc.run(qid, [0])["h1"].ids
        svc.close()
    if world > 2:
        # a data axis is refused on every rank, before any control group
        from graph_learn_tpu_torch.parallel.mesh import make_mesh
        try:
            serving.QueryService(g, mesh=make_mesh(2, world // 2,
                                                   device="cpu"),
                                 device="cpu", graph_shards=world // 2)
        except glt.InvalidArgumentError as e:
            out["data_axis"] = str(e)
        return out

    # random answers, refusals and SubGraph rounds
    g = partition_graph(glt, files["part"])
    svc = service(g)
    if svc is not None:
        one = serving.QueryService(g, device="cpu")
        q2 = (lambda gg: gg.V("v").batch(8).alias("src")
              .outV("e").sample(4).by("random").alias("h1")
              .outV("e").sample(2).by("random").alias("h2").values())
        qid, oid = (s.install(q2(g), micro_batch=8) for s in (svc, one))
        rng = np.random.default_rng(3)
        bad = []
        for size in PART_RANDOM_SIZES:
            ids = rng.integers(0, 2000, size)
            bad.append(_mismatch(flat_result(svc.run(qid, ids)),
                                 flat_result(one.run(oid, ids))))
        out["random_bad"] = bad
        refused = []
        for ids in ([10 ** 9], [0, 10 ** 9]):
            try:
                svc.run(qid, ids)
            except glt.NotFoundError:
                refused.append("not found")
        sg = (lambda gg: gg.V("v").batch(4).alias("src")
              .SubGraph("e").alias("sg").values())
        sid, osid = svc.install(sg(g), micro_batch=4), one.install(
            sg(g), micro_batch=4)
        try:
            svc.run(sid, np.arange(8))
        except glt.InvalidArgumentError:
            refused.append("oversized")
        out["refused"] = refused
        # one round a request: two requests queued before one dispatch
        iq = svc._queries[sid]
        iq.close()
        sends = []
        real_send = svc._control.send

        def counting_send(cmd, *a, **kw):
            sends.append(cmd)
            return real_send(cmd, *a, **kw)
        svc._control.send = counting_send
        pa = serving._Pending(np.array([0, 5], np.int64))
        pb = serving._Pending(np.array([17, 123, 999], np.int64))
        iq._queue.put(pa)
        iq._queue.put(pb)
        iq._serve_once()
        iq._serve_once()
        out["sg_rounds"] = sends.count(serving._ROUND)
        out["sg_bad"] = [_mismatch(flat_result(p.result),
                                   flat_result(one.run(osid, p.ids)))
                         for p in (pa, pb)]
        out["after_refusals"] = _mismatch(
            flat_result(svc.run(qid, [7, 8])), flat_result(
                one.run(oid, [7, 8])))
        svc._control.send = real_send
        svc.close()
        one.close()

    # the incremental refresh (tests/test_online.py:449-543), "minimal"
    conf.storage_profile = "minimal"
    g = partition_graph(glt, files["inc"])
    if rank:
        blocks = []
        real_swap = serving._FollowerQuery.swap

        def recording_swap(self, payload):
            up = real_swap(self, payload)
            blocks.append(_flat_block(self.tables.placed))
            return up
        serving._FollowerQuery.swap = recording_swap
        service(g)
        out["blocks"] = blocks
        return out
    svc = service(g)
    q = part_topk(g)
    qid = svc.install(q, micro_batch=8)
    iq = svc._queries[qid]
    inc = {"full": iq.last_refresh_upload_bytes, "uploads": [],
           "fresh": [], "leader": [], "errors": []}
    oracle = {i: svc.run(qid, [i])["h1"].ids[0].tolist()
              for i in INC_ORACLE_IDS}

    def client(tid):
        try:
            for r in range(8):
                i = INC_ORACLE_IDS[(tid + r) % len(INC_ORACLE_IDS)]
                got = svc.run(qid, [i])["h1"].ids[0].tolist()
                if got != oracle[i]:
                    inc["errors"].append((tid, i, got))
        except Exception as e:  # reported by the test
            inc["errors"].append((tid, repr(e)))

    def updater():
        for k in range(INC_REFRESHES):
            buf = UpdateBuffer()
            buf.add_edges("e", src_ids=[0], dst_ids=[42 + k],
                          weights=[50.0 + k])
            apply_updates(g, buf)
            svc.refresh()
            inc["uploads"].append(iq.last_refresh_upload_bytes)
            inc["leader"].append(_flat_block(iq._snap.tables.placed))
            inc["fresh"].append([_flat_block(build_sharded_tables(
                q, world, slack=conf.serving_shard_slack, shard=p).stacked)
                for p in range(world)])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
    upd = threading.Thread(target=updater)
    upd.start()
    for t in threads:
        t.start()
    for t in threads + [upd]:
        t.join(timeout=120)
    inc["final"] = svc.run(qid, [0])["h1"].ids[0].tolist()
    svc.close()
    out["inc"] = inc
    return out


def online_partitioned_ranks(rank: int, world: int, paths):
    """tests/test_torch_online.py's partitioned case on the tmp_graph_dir
    files: topk answers, then a streamed update after refresh()."""
    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.online.serving import QueryService
    from graph_learn_tpu_torch.online.update import (UpdateBuffer,
                                                     apply_updates)
    g = (glt.Graph(device="cpu")
         .node(paths["node"], node_type="item",
               decoder=glt.Decoder(weighted=True, labeled=True,
                                   attr_types=["float"] * 4))
         .edge(paths["edge"], edge_type=("item", "item", "rel"),
               decoder=glt.Decoder(weighted=True))).init()
    svc = QueryService(g, device="cpu", graph_shards=world)
    if rank:
        svc.follow()
        return None
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("h1").values())
    qid = svc.install(q, micro_batch=4)
    before = flat_result(svc.run(qid, [0, 10, 20, 390, 70]))
    buf = UpdateBuffer()
    buf.add_edges("rel", src_ids=[0, 0], dst_ids=[390, 380],
                  weights=[9.0, 8.0])
    apply_updates(g, buf)
    svc.refresh()
    after = svc.run(qid, [0])["h1"].ids[0].tolist()
    svc.close()
    return before, after


def dead_follower_rank(rank: int, where: str, mode: str):
    """Two ranks started by parallel.launch.start.  ``mode`` "killed": rank
    1 is killed on its second round.  "refused": rank 1's refresh raises
    and the process lives on (30 s) after its follow() raised.  Rank 0
    writes how its calls ended to leader.json."""
    import json
    import os
    import signal
    import time
    import traceback

    import torch

    from graph_learn_tpu_torch.online import serving
    from graph_learn_tpu_torch.online.update import (UpdateBuffer,
                                                     apply_updates)
    from graph_learn_tpu_torch.parallel import launch
    torch.set_num_threads(1)
    report = {}
    try:
        launch.join(rank, 2, where, "cpu", None, 60.0)
        a = numpy_graph(n=200)
        g = torch_graph(a)[0]
        svc = serving.QueryService(g, device="cpu", graph_shards=2)
        if rank == 1:
            if mode == "killed":
                ctl, seen = svc._control, []
                real = ctl.recv_chunk

                def die_on_the_second(n):
                    seen.append(n)
                    if len(seen) == 2:
                        os.kill(os.getpid(), signal.SIGKILL)
                    return real(n)
                ctl.recv_chunk = die_on_the_second
                svc.follow()
            else:
                def refuse(self, payload):
                    raise ValueError("this rank refuses the block")
                serving._FollowerQuery.swap = refuse
                try:
                    svc.follow()
                except ValueError:
                    time.sleep(30)
            return
        qid = svc.install(two_hop(g, 3, 2, batch=8), micro_batch=8)
        raw = a["raw_ids"]
        report["first"] = len(svc.run(qid, raw[:3])["hop1"].ids)
        buf = UpdateBuffer()
        buf.add_edges("rel", src_ids=raw[:2], dst_ids=raw[2:4],
                      weights=[2.0, 3.0])
        apply_updates(g, buf)
        calls = {"killed": (("second", lambda: svc.run(qid, raw[3:5])),
                            ("third", lambda: svc.run(qid, raw[3:5]))),
                 "refused": (("second", svc.refresh),
                             ("third", lambda: svc.run(qid, raw[3:5])))}
        for key, call in calls[mode]:
            t0 = time.monotonic()
            try:
                call()
                report[key] = None
            except Exception as e:  # the test reads what it was
                report[key] = repr(e)
            report[key + "_s"] = time.monotonic() - t0
    except BaseException:
        report["error"] = traceback.format_exc()
    if rank == 0:
        with open(os.path.join(where, "leader.json.tmp"), "w") as f:
            json.dump(report, f)
        os.replace(os.path.join(where, "leader.json.tmp"),
                   os.path.join(where, "leader.json"))


def sharded_knn_ranks(rank: int, world: int, init_rows):
    """tests/test_torch_sharded_knn.py's cases on ``world`` ranks: every
    index kind and metric of tests/test_knn_conditional.py:257-320 built
    on each rank from JAX's starting rows (``init_rows``), sharded, and
    searched at k 5 and at k above the rows of a shard; the one-rank
    index's answers; the replicated arrays each rank holds; then
    Graph.search(mesh=...) against the unsharded call."""
    import graph_learn_tpu_torch as glt
    from graph_learn_tpu_torch.ops import knn
    from graph_learn_tpu_torch.parallel.mesh import make_mesh

    data, ids, q = knn_case_data()
    mesh = make_mesh(1, world, device="cpu")
    out = {}
    for kind in ("flat", "ivfflat", "ivfpq"):
        for metric in (0, 1):
            opt = glt.KnnOption(k=5, index_type=kind, nlist=8, nprobe=3,
                                metric=metric)
            if kind == "flat":
                base = knn.FlatIndex(data.shape[1], metric, device="cpu")
            elif kind == "ivfflat":
                base = knn.IVFFlatIndex(data.shape[1], nlist=8, nprobe=3,
                                        metric=metric, device="cpu")
            else:
                base = knn.IVFPQIndex(data.shape[1], nlist=8, nprobe=3,
                                      metric=metric, device="cpu")
            base.train(data, init_rows=init_rows.get(kind))
            base.add(data, ids)
            sharded = knn.shard_index(base, mesh)
            for k in (opt.k, KNN_BIG_K):
                out[(kind, metric, k)] = dict(
                    sharded=sharded.search(q, k), one=base.search(q, k))
            out[(kind, metric, "repl")] = dict(sharded.repl)
    t = glt.NodeTable("item", glt.Decoder(attr_types=["float"] *
                                          data.shape[1]), ids,
                      float_attrs=data)
    g = glt.Graph(device="cpu").add_node_table(t)
    for kind in ("flat", "ivfflat"):
        opt = glt.KnnOption(k=4, index_type=kind, nlist=8, nprobe=3)
        out[("graph", kind)] = dict(
            sharded=g.search("item", q, opt, mesh=mesh),
            one=g.search("item", q, opt))
    out["graph_keys"] = sorted(g._knn_indexes)
    return out


# k above a shard's rows at two ranks (ceil(203 / 2) = 102)
KNN_BIG_K = 110


def knn_case_data():
    """tests/test_knn_conditional.py:265-271's data: 203 points (not a
    multiple of the ranks) in 8 dimensions, ids from 1 000, 17 queries."""
    rng = np.random.default_rng(7)
    n, d = 203, 8
    data = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(1000, 1000 + n)
    q = data[rng.integers(0, n, 17)] + \
        0.01 * rng.standard_normal((17, d)).astype(np.float32)
    return data, ids, q
