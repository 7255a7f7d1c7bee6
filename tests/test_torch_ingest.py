"""The port's file ingest against the JAX package's: the Python parser and
the native loader of ``csrc/ingest.cpp`` (core/ingest.py,
core/native_ingest.py) against JAX's ``ingest.load_*_table`` on both of
its routes, bit for bit, on tables with every decoder kind and two field
delimiters; ``Graph.node/edge/init`` against JAX's (node tables, masked
node sets, edge tables, CSRs and candidate pools bit for bit, undirected
sources within one type and between two); the source filesystems
(core/filesystem.py); and the JAX errors."""

import functools
import http.server
import threading
import warnings

import numpy as np
import pytest

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.core import ingest as jingest
from graph_learn_tpu_torch.core import filesystem, ingest, native_ingest
from graph_learn_tpu_torch.errors import (InvalidArgumentError,
                                          NotFoundError, UnimplementedError)
from torch_parity import both_confs, store_equal as _store_equal

COLUMNS = ("weights", "labels", "timestamps", "int_attrs", "float_attrs",
           "multival_attrs", "multival_lens")
# every attribute kind: float, numeric int, bucketed int id, hashed string
# with and without a bucket, multi-value string
ATTR_TYPES = ["float", "int", ("int", 7), ("string", 100), "string",
              ("string", 50, True)]
ATTR_DIMS = [None, None, 4, 4, 4, 4]


def _decoder(mod, **flags):
    return mod.Decoder(attr_types=ATTR_TYPES, attr_dims=ATTR_DIMS,
                       multival_max_len=3, **flags)


def _attr_strings(rng, n):
    """Attribute strings of ``ATTR_TYPES``: negative ints for the bucket,
    multi-value lists empty, with empty items and longer than the cap."""
    words = np.array(["red", "green", "blue", "", "x y", "naïve"])
    out = []
    for i in range(n):
        items = rng.choice(words[:3], rng.integers(0, 6)).tolist()
        if i % 5 == 1:
            items.insert(1, "")
        out.append(":".join([
            "%.6g" % rng.standard_normal(), str(int(rng.integers(-50, 50))),
            str(int(rng.integers(-1000, 1000))), str(rng.choice(words)),
            "tag%d" % rng.integers(0, 30), ",".join(items)]))
    return out


def _write(path, header, cols, delim):
    rows = [delim.join(str(c[i]) for c in cols) for i in range(len(cols[0]))]
    path.write_text(delim.join(header) + "\n" + "\n".join(rows) + "\n")
    return str(path)


def _node_file(tmp_path, delim, n=60, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(10 * n)[:n] * 3 + 1
    cols = [ids, ["%.7g" % w for w in rng.random(n)],
            rng.integers(0, 9, n), rng.integers(10**12, 10**12 + 10**6, n),
            _attr_strings(rng, n)]
    return _write(tmp_path / "nodes", ["id:int64", "weight:float",
                                       "label:int64", "ts:int64",
                                       "attrs:string"], cols, delim), ids


def _edge_file(tmp_path, delim, ids, e=200, seed=1, name="edges"):
    rng = np.random.default_rng(seed)
    cols = [rng.choice(ids, e), rng.choice(ids, e),
            ["%.9g" % w for w in rng.random(e).astype(np.float32)],
            rng.integers(0, 4, e), rng.integers(5 * 10**11, 6 * 10**11, e),
            _attr_strings(rng, e)]
    return _write(tmp_path / name, ["src_id:int64", "dst_id:int64",
                                    "weight:float", "label:int64",
                                    "ts:int64", "attrs:string"], cols, delim)


def _assert_columns_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == np.asarray(w).dtype or k in (
                "labels", "int_attrs", "multival_attrs", "multival_lens"), k
            np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


def _jax_python_load(monkeypatch, fn, path, dec):
    monkeypatch.setattr(jingest, "_try_native_load", lambda *a: None)
    try:
        return fn(path, dec)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("delim", ["\t", "|"])
@pytest.mark.parametrize("kind", ["node", "edge"])
def test_python_parser_native_loader_and_jax_load_the_same_columns(
        tmp_path, delim, kind, monkeypatch):
    """Four routes, one answer, bit for bit: the port's Python parser and
    native loader, and JAX's Python parser and native loader."""
    assert native_ingest.available(), "g++ builds csrc/ingest.cpp"
    path, ids = _node_file(tmp_path, delim)
    flags = dict(weighted=True, labeled=True, timestamped=True)
    if kind == "edge":
        path = _edge_file(tmp_path, delim, ids)
    tload = ingest.load_node_table if kind == "node" else \
        ingest.load_edge_table
    jload = jingest.load_node_table if kind == "node" else \
        jingest.load_edge_table
    with both_confs(field_delimiter=delim):
        want = _jax_python_load(monkeypatch, jload, path, _decoder(gl,
                                                                   **flags))
        jnative = jload(path, _decoder(gl, **flags))
        py = ingest._parse_records(path, ingest.NODE_IDS if kind == "node"
                                   else ingest.EDGE_IDS,
                                   _decoder(glt, **flags))
        nat = tload(path, _decoder(glt, **flags))
    _assert_columns_equal(py, want)
    _assert_columns_equal(nat, want)
    _assert_columns_equal(nat, jnative)
    lens = want["multival_lens"]
    assert lens.max() == 3 and lens.min() == 0


def test_the_native_library_is_the_ports_own_build():
    """Built from the repository's csrc/ingest.cpp into the port's _build/
    under a source-and-flags hash, never into the JAX wrapper's
    csrc/build/."""
    path = native_ingest.library_path()
    assert path.parent == native_ingest.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "graph_learn_tpu_torch"
    assert native_ingest.SOURCE.parent.name == "csrc"
    assert native_ingest.available() and path.exists()
    assert "-march=native" in native_ingest.CXX_FLAGS


def test_without_the_library_the_python_parser_loads_and_warns_once(
        tmp_path, monkeypatch):
    path, _ = _node_file(tmp_path, "\t", n=20)
    dec = _decoder(glt, weighted=True, labeled=True, timestamped=True)
    want = ingest.load_node_table(path, dec)
    monkeypatch.setattr(native_ingest, "_lib", None)
    monkeypatch.setattr(native_ingest, "_failed", "g++ not found")
    monkeypatch.setattr(native_ingest, "_warned", False)
    assert not native_ingest.available()
    with pytest.warns(RuntimeWarning, match="Python parser"):
        got = ingest.load_node_table(path, dec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = ingest.load_node_table(path, dec)
    _assert_columns_equal(got, want)
    _assert_columns_equal(again, want)


@pytest.mark.parametrize("native", [True, False])
def test_bad_records_raise_the_jax_errors(tmp_path, native):
    p = tmp_path / "bad"
    p.write_text("id:int64\tattrs:string\n1\t0.5:2\n2\t0.5\n")
    dec = glt.Decoder(attr_types=["float", "float"])
    with pytest.raises(InvalidArgumentError):
        if native:
            ingest.load_node_table(str(p), dec)
        else:
            ingest._parse_records(str(p), ingest.NODE_IDS, dec)
    with pytest.raises(gl.InvalidArgumentError):
        jingest.load_node_table(str(p), gl.Decoder(attr_types=["float",
                                                               "float"]))


# --- Graph.node / edge / init --------------------------------------------


def _two_type_files(tmp_path, delim="\t"):
    """Users and items, each node type in two files, a train split, a
    weighted u-i file, two i-i files."""
    rng = np.random.default_rng(3)
    f = {}
    for t, n, off in (("u", 30, 0), ("i", 40, 1000)):
        ids = np.arange(n) * 2 + off
        for part, sl in (("a", slice(0, n // 2)), ("b", slice(n // 2, n))):
            f[t + part] = _write(
                tmp_path / (t + part),
                ["id:int64", "weight:float", "attrs:string"],
                [ids[sl], ["%.4f" % w for w in rng.random(n)[sl]],
                 ["%.5f:%.5f" % tuple(rng.standard_normal(2))
                  for _ in ids[sl]]], delim)
        f[t + "_ids"] = ids
    f["train"] = _write(tmp_path / "train", ["id:int64"],
                        [f["u_ids"][::3]], delim)
    f["ui"] = _write(tmp_path / "ui", ["src_id:int64", "dst_id:int64",
                                       "weight:float"],
                     [rng.choice(f["u_ids"], 150), rng.choice(f["i_ids"], 150),
                      ["%.9g" % w for w in rng.random(150).astype(
                          np.float32)]], delim)
    for name in ("ii1", "ii2"):
        f[name] = _write(tmp_path / name, ["src_id:int64", "dst_id:int64"],
                         [rng.choice(f["i_ids"], 90),
                          rng.choice(f["i_ids"], 90)], delim)
    return f


def _register(mod, g, f, ii_directed=(True, False)):
    node_dec = mod.Decoder(weighted=True, attr_types=["float", "float"])
    return (g.node(f["ua"] + "," + f["ub"], "u", node_dec)
            .node(f["ia"], "i", node_dec).node(f["ib"], "i", node_dec)
            .node(f["train"], "u", mod.Decoder(), mask=mod.Mask.TRAIN)
            .edge(f["ui"], ("u", "i", "u-i"), mod.Decoder(weighted=True),
                  directed=False)
            .edge(f["ii1"], ("i", "i", "i-i"), directed=ii_directed[0])
            .edge(f["ii2"], ("i", "i", "i-i"), directed=ii_directed[1]))


@pytest.mark.parametrize("ii_directed", [(True, False), (False, False),
                                         (True, True)])
@pytest.mark.parametrize("delim", ["\t", ";"])
def test_init_builds_the_jax_store(tmp_path, ii_directed, delim):
    """Comma-separated and repeated node sources merged, the masked set
    resolved into its base table, u-i undirected between two types (its
    ``u-i_reverse`` table), i-i from two sources of which the undirected
    ones load reversed copies into the type itself, in source order."""
    f = _two_type_files(tmp_path, delim)
    with both_confs(field_delimiter=delim):
        jg = _register(gl, gl.Graph(), f, ii_directed).init()
        tg = _register(glt, glt.Graph(device="cpu"), f, ii_directed).init()
    _store_equal(tg, jg)
    assert set(tg.store.edges) == {"u-i", "u-i_reverse", "i-i"}
    assert tg.store.node_table("u").num_nodes == 30
    assert tg.get_node_decoder("MASK*u").weighted is False
    assert tg.init() is tg  # a second init loads nothing


def test_init_equals_the_in_memory_undirected_build(tmp_path):
    """``edge(directed=False)`` of one (comma-separated) source list
    through ``init()`` and ``add_edge_table(directed=False)`` of the same
    edges give the same store, within one node type and between two."""
    f = _two_type_files(tmp_path)
    node_dec = glt.Decoder(weighted=True, attr_types=["float", "float"])
    tg = (glt.Graph(device="cpu")
          .node(f["ua"] + "," + f["ub"], "u", node_dec)
          .node(f["ia"] + "," + f["ib"], "i", node_dec)
          .edge(f["ui"], ("u", "i", "u-i"), glt.Decoder(weighted=True),
                directed=False)
          .edge(f["ii1"] + "," + f["ii2"], ("i", "i", "i-i"),
                directed=False)).init()
    mem = glt.Graph(device="cpu")
    for t in ("u", "i"):
        mem.add_node_table(tg.store.node_table(t))
    for t in ("u-i", "i-i"):
        cols = [ingest.load_edge_table(f[s], glt.Decoder(weighted=t == "u-i"))
                for s in (("ui",) if t == "u-i" else ("ii1", "ii2"))]
        src_t, dst_t = tg.store.topology[t]
        mem.add_edge_table(glt.EdgeTable(
            t, src_t, dst_t, glt.Decoder(weighted=t == "u-i"),
            src=mem.store.node_table(src_t).index.lookup(
                np.concatenate([c["src_ids"] for c in cols])),
            dst=mem.store.node_table(dst_t).index.lookup(
                np.concatenate([c["dst_ids"] for c in cols])),
            num_src_nodes=mem.store.node_table(src_t).num_nodes,
            num_dst_nodes=mem.store.node_table(dst_t).num_nodes,
            weights=cols[0]["weights"]), directed=False)
    for t in ("u-i", "u-i_reverse"):
        a, b = tg.store.edge_table(t), mem.store.edge_table(t)
        for fld in ("src", "dst", "weights"):
            np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld))
    # i-i: [ii1; ii2; ii1 swapped; ii2 swapped] both ways
    a, b = tg.store.edge_table("i-i"), mem.store.edge_table("i-i")
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)


def test_timestamped_sources_share_one_time_base(tmp_path):
    rng = np.random.default_rng(5)
    ids = np.arange(20)
    nodes = _write(tmp_path / "n", ["id:int64"], [ids], "\t")
    e1 = _write(tmp_path / "e1", ["src_id:int64", "dst_id:int64", "ts:int64"],
                [rng.choice(ids, 30), rng.choice(ids, 30),
                 rng.integers(10**9, 2 * 10**9, 30)], "\t")
    e2 = _write(tmp_path / "e2", ["src_id:int64", "dst_id:int64", "ts:int64"],
                [rng.choice(ids, 30), rng.choice(ids, 30),
                 rng.integers(5 * 10**8, 10**9, 30)], "\t")

    def build(mod, g):
        return (g.node(nodes, "v", mod.Decoder())
                .edge(e1, ("v", "v", "a"), mod.Decoder(timestamped=True))
                .edge(e2, ("v", "v", "b"), mod.Decoder(timestamped=True),
                      directed=False)).init()
    _store_equal(build(glt, glt.Graph(device="cpu")), build(gl, gl.Graph()))


def test_init_raises_the_jax_errors(tmp_path):
    f = _two_type_files(tmp_path)
    bad_edge = _write(tmp_path / "bad_edge", ["src_id:int64",
                                              "dst_id:int64"],
                      [[0, 2], [1000, 999_999]], "\t")
    unweighted = _write(tmp_path / "unweighted", ["id:int64", "attrs:string"],
                        [[1, 3], ["0.5:1.5", "2:3"]], "\t")
    for mod, g in ((gl, gl.Graph()), (glt, glt.Graph(device="cpu"))):
        dec = mod.Decoder(weighted=True, attr_types=["float", "float"])
        g.node(f["ua"], "u", dec).node(f["ia"] + "," + f["ib"], "i", dec)
        g.edge(bad_edge, ("u", "i", "x"))
        with pytest.raises(mod.NotFoundError):
            g.init()
    for mod, g in ((gl, gl.Graph()), (glt, glt.Graph(device="cpu"))):
        g.node(f["ua"], "u", mod.Decoder(weighted=True,
                                         attr_types=["float"] * 3))
        with pytest.raises(mod.InvalidArgumentError):
            g.init()
    for mod, g in ((gl, gl.Graph()), (glt, glt.Graph(device="cpu"))):
        g.node(f["ua"], "u", mod.Decoder(weighted=True,
                                         attr_types=["float", "float"]))
        g.node(unweighted, "u", mod.Decoder(attr_types=["float", "float"]))
        with pytest.raises(mod.InvalidArgumentError, match="disagree"):
            g.init()
    for mod, g in ((gl, gl.Graph()), (glt, glt.Graph(device="cpu"))):
        with pytest.raises(mod.InvalidArgumentError):
            g.node(f["ua"], "u", "not a decoder")
        with pytest.raises(mod.InvalidArgumentError):
            g.edge(f["ui"], ("u", "i"))


def test_init_reorder_is_refused(tmp_path):
    """An unknown reorder strategy is refused before anything loads (the
    JAX package raises the same ValueError after loading); ``"bfs"``
    relabels the nodes and keeps the raw-id store (tests of its own in
    test_torch_reorder.py)."""
    f = _two_type_files(tmp_path)
    g = glt.Graph(device="cpu").node(f["ua"], "u", glt.Decoder(
        weighted=True, attr_types=["float", "float"]))
    with pytest.raises(ValueError, match="unknown reorder strategy"):
        g.init(reorder="metis")
    assert not g.store.nodes
    tg = _register(glt, glt.Graph(device="cpu"), f).init(reorder="bfs")
    jg = _register(gl, gl.Graph(), f).init(reorder="bfs")
    _store_equal(tg, jg)
    assert tg.store.node_table("u").num_nodes == 15 + 15


def test_the_loaded_graph_answers_a_query_on_its_train_split(tmp_path):
    f = _two_type_files(tmp_path)
    g = _register(glt, glt.Graph(device="cpu"), f).init()
    q = (g.V("u", mask=glt.Mask.TRAIN).batch(4).alias("s")
         .outV("u-i").sample(3).by("random").alias("h").values())
    batch = glt.Dataset(q, device="cpu").next()
    train = g.store.node_table("u").index.lookup(f["u_ids"][::3])
    assert np.isin(batch["s"].ids.numpy(), train).all()
    assert batch["h"].ids.shape == (4, 3)


# --- source filesystems ----------------------------------------------------


def test_register_filesystem_routes_a_scheme(tmp_path):
    f = _two_type_files(tmp_path)
    calls = []

    def fetch(url):
        calls.append(url)
        return url.split("://", 1)[1]

    glt.register_filesystem("fakefs", fetch)
    g = (glt.Graph(device="cpu")
         .node("fakefs://" + f["ua"], "u", glt.Decoder(
             weighted=True, attr_types=["float", "float"]))
         .node("file://" + f["ia"], "i", glt.Decoder(
             weighted=True, attr_types=["float", "float"]))).init()
    assert calls == ["fakefs://" + f["ua"]]
    assert g.get_stats()["nodes"] == {"u": 15, "i": 20}
    with pytest.raises(NotFoundError, match="no filesystem registered"):
        filesystem.resolve_path("nope://x")


def test_http_fetch_from_a_loopback_server_revalidates(tmp_path,
                                                       monkeypatch):
    f = _two_type_files(tmp_path)
    monkeypatch.setenv("GLT_FS_CACHE", str(tmp_path / "fscache"))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(tmp_path))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = "http://127.0.0.1:%d" % httpd.server_address[1]
        dec = glt.Decoder(weighted=True, attr_types=["float", "float"])
        g = (glt.Graph(device="cpu")
             .node(base + "/ua," + base + "/ub", "u", dec)
             .node(base + "/ia," + base + "/ib", "i", dec)
             .edge(base + "/ui", ("u", "i", "u-i"),
                   glt.Decoder(weighted=True))).init()
        jg = (gl.Graph().node(f["ua"] + "," + f["ub"], "u", gl.Decoder(
            weighted=True, attr_types=["float", "float"]))).init()
        np.testing.assert_array_equal(g.store.node_table("u").float_attrs,
                                      jg.store.node_table("u").float_attrs)
        assert g.get_stats()["edges"]["u-i"] == 150
        p1 = filesystem.resolve_path(base + "/ua")
        p2 = filesystem.http_fetch(base + "/ua")
        assert p1 == p2 and open(p1).readline().startswith("id:")
        with pytest.raises(NotFoundError, match="404"):
            filesystem.resolve_path(base + "/definitely_missing")
    finally:
        httpd.shutdown()


def test_the_hdfs_hook_raises_not_found_without_libhdfs():
    with pytest.raises(NotFoundError, match="libhdfs"):
        filesystem.resolve_path("hdfs://namenode:9000/data/nodes.tsv")
