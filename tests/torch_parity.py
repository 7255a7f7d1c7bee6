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
