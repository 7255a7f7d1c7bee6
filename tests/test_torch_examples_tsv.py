"""The TSV forms of the examples: the port's examples/data/synthetic.py
writes the root generator's bytes; each TSV example (the supervised ones,
ego_tgat, and node2vec, sage_unsupervised, tgn, ultra_gcn, bipartite_sage
and seal's default path) writes its JAX example's files byte for byte,
loads a store bit-equal to the JAX example's from the same files and to
its in-memory twin (the generator's draws, features as their text reads
back), and runs a few steps at narrow widths.
Tolerances: the stores are compared exactly (every array bit for bit);
the short runs are held to finite losses and accuracies in [0, 1], and
the EgoGraphSAGE run, which learns this graph in a few epochs, to a loss
that falls and an accuracy over 0.5."""

import ast
import contextlib
import filecmp
import io
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
from graph_learn_tpu_torch.examples import (bipartite_sage, common,
                                            ego_gat_supervised,
                                            ego_rgcn_supervised,
                                            ego_sage_supervised, ego_tgat,
                                            node2vec, sage_unsupervised,
                                            seal, tgn, ultra_gcn)
from graph_learn_tpu_torch.examples.data import synthetic
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from torch_parity import store_equal

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(nodes=200, features_num=16, classes=4)


def _root_module(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_function(rel, name, **ns):
    """One function of a root example, run as written (its module sets
    the platform and the path when imported, so only the definition is
    taken)."""
    tree = ast.parse((REPO / rel).read_text())
    keep = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == name]
    exec(compile(ast.Module(body=keep, type_ignores=[]), rel, "exec"), ns)
    return ns[name]


ROOT_SYNTHETIC = _root_module("root_synthetic", "examples/data/synthetic.py")


@pytest.mark.parametrize("name,kw", [
    ("cora_like", dict(n=150, feat_dim=8, classes=3)),
    ("cora_like", dict(n=120, avg_degree=4, homophily=0.5, seed=4)),
    ("u2i", dict(n_users=40, n_items=25, feat_dim=6)),
    ("temporal_u2i", dict(events=250, n_users=30, n_items=20))])
def test_the_generator_writes_the_root_generators_bytes(tmp_path, name, kw):
    a, b = str(tmp_path / "root"), str(tmp_path / "port")
    assert getattr(ROOT_SYNTHETIC, name)(a, **kw) == getattr(
        synthetic, name)(b, **kw)
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and files
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


def _ports_equal(a, b):
    """Two port stores, every host array and CPU CSR array bit for bit."""
    sa, sb = a.store, b.store
    assert set(sa.nodes) == set(sb.nodes) and set(sa.edges) == set(sb.edges)
    assert set(sa.node_sets) == set(sb.node_sets)
    for t in sa.nodes:
        for f in ("raw_ids", "float_attrs", "labels", "weights"):
            x, y = getattr(sa.nodes[t], f), getattr(sb.nodes[t], f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), (t, f)
    for t in sa.node_sets:
        assert np.array_equal(sa.node_sets[t].indices,
                              sb.node_sets[t].indices), t
        wa, wb = sa.node_sets[t].weights, sb.node_sets[t].weights
        assert (wa is None) == (wb is None) and (
            wa is None or np.array_equal(wa, wb)), t
    for t in sa.edges:
        x, y = sa.edges[t], sb.edges[t]
        assert (x.ts_base, x.ts_scale) == (y.ts_base, y.ts_scale)
        for f in ("src", "dst", "weights", "timestamps", "float_attrs"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                assert np.array_equal(u, v), (t, f)
        dx, dy = x.device("cpu"), y.device("cpu")
        for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "cum_weights"):
            u, v = getattr(dx.out, f), getattr(dy.out, f)
            assert (u is None) == (v is None) and (
                u is None or torch.equal(u, v)), (t, f)


def _jax_cora(d, two_relations):
    load = _root_function("examples/common.py", "load_cora_like", gl=gl,
                          os=os, cora_like=ROOT_SYNTHETIC.cora_like)
    return load(d, SMALL["features_num"], nodes=SMALL["nodes"],
                classes=SMALL["classes"], two_relations=two_relations)[0]


@pytest.mark.parametrize("two_relations", [False, True])
def test_the_cora_like_store_equals_the_jax_one_and_its_twin(
        tmp_path, two_relations):
    d = str(tmp_path / "cora")
    g, dec = common.load_cora_like(d, SMALL["features_num"], SMALL["nodes"],
                                   SMALL["classes"], two_relations,
                                   device="cpu")
    assert dec.float_attr_num == SMALL["features_num"]
    store_equal(g, _jax_cora(d, two_relations))
    twin, _ = common.cora_like_twin(SMALL["features_num"], SMALL["nodes"],
                                    SMALL["classes"], two_relations,
                                    device="cpu")
    _ports_equal(g, twin)
    assert set(g.store.edges) == set(common.RELATIONS[:1 + two_relations])


def _args(module, tmp_path, **kw):
    ap = module.build_parser()
    return ap.parse_args(["--cpu", "--data_dir", str(tmp_path / "cora"),
                          "--nodes", str(SMALL["nodes"]),
                          "--features_num", str(SMALL["features_num"]),
                          "--classes", str(SMALL["classes"])]
                         + [t for k, v in kw.items()
                            for t in ("--" + k, *map(str, np.atleast_1d(v)))])


def test_ego_sage_supervised_learns_on_the_files(tmp_path):
    out = ego_sage_supervised.run(_args(ego_sage_supervised, tmp_path,
                                        epochs=4, hidden=16, nbrs=[5, 3]))
    hist = out["history"]
    assert len(hist) == 4 and np.all(np.isfinite(hist))
    assert hist[-1] < hist[0] and out["acc"] > 0.5, (hist, out["acc"])


def test_ego_gat_supervised_runs_on_the_files(tmp_path):
    out = ego_gat_supervised.run(_args(ego_gat_supervised, tmp_path,
                                       epochs=2, hidden=8, heads=[2, 1],
                                       nbrs=[3, 2]))
    assert np.all(np.isfinite(out["history"])) and 0 <= out["acc"] <= 1


def test_ego_rgcn_supervised_runs_on_the_files(tmp_path):
    out = ego_rgcn_supervised.run(_args(ego_rgcn_supervised, tmp_path,
                                        epochs=2, hidden=8, nbrs=[3, 2]))
    assert out["aliases"] == ["r0_h1", "r1_h1", "r0_r0_h2", "r0_r1_h2",
                              "r1_r0_h2", "r1_r1_h2"]
    assert np.all(np.isfinite(out["history"])) and 0 <= out["acc"] <= 1
    assert set(out["graph"].store.edges) == set(common.RELATIONS)


def test_the_tgat_files_store_equals_the_jax_one_and_its_twin(tmp_path):
    d = str(tmp_path / "tgat")
    kw = dict(events=300, n_users=30, n_items=20)
    synthetic.temporal_u2i(d, **kw)
    g = ego_tgat.load(d, device="cpu")[0]
    load = _root_function("examples/ego_tgat.py", "load", gl=gl, os=os,
                          temporal_u2i=ROOT_SYNTHETIC.temporal_u2i)
    store_equal(g, load(d, 8, 4)[0])
    twin = ego_tgat.build_graph(ego_tgat.temporal_u2i(**kw, text=True),
                                "cpu")[0]
    _ports_equal(g, twin)
    # a few steps of the example on the loaded store
    q = ego_tgat.build_query(g, 16, [4, 2], "train")
    udec, idec = (g.store.node_table(t).decoder for t in ("u", "i"))
    model = ego_tgat.TGATLink(udec, idec, 16, 8, 4, 2, 4, device="cpu")
    _, hist = LocalTrainer(device="cpu").train(
        q, model, lambda m, b, gen, tr: ego_tgat.tgat_loss(m, b, 2, tr, gen),
        torch.optim.Adam(model.parameters(), lr=1e-3), steps_per_epoch=3,
        verbose=False)
    assert np.all(np.isfinite(hist))


def test_the_tgat_main_loads_its_files(tmp_path):
    acc = ego_tgat.main(["--cpu", "--data_dir", str(tmp_path / "t"),
                         "--events", "400", "--epochs", "1",
                         "--steps_per_epoch", "2", "--batch_size", "32"])
    assert 0 <= acc <= 1
    assert os.path.exists(tmp_path / "t" / "interaction_table")


# ---------------------------------------------------------------------------
# The six TSV forms of queue A1: node2vec, sage_unsupervised, tgn,
# ultra_gcn, bipartite_sage and seal's default path.  For each: the files
# the port example writes are the JAX example's bytes; the store it loads
# from them is the JAX example's store from the same files and its own
# in-memory twin of the same draws read back from their text, bit for
# bit; and its main runs on the files it writes.
# ---------------------------------------------------------------------------

def _jax_homogeneous(d, feat_dim, node_type="item", edge_type="relation"):
    """``examples/node2vec.py:39-46`` / ``seal.py:84-94``'s load."""
    return (gl.Graph()
            .node(os.path.join(d, "node_table"), node_type,
                  gl.Decoder(labeled=True, attr_types=["float"] * feat_dim))
            .edge(os.path.join(d, "edge_table"),
                  (node_type, node_type, edge_type),
                  gl.Decoder(weighted=True), directed=False)).init()


def _jax_u2i(d, feat_dim=16):
    """``examples/ultra_gcn.py:40-48`` / ``bipartite_sage.py:33-41``'s
    load."""
    return (gl.Graph()
            .node(os.path.join(d, "user_table"), "u",
                  gl.Decoder(attr_types=["float"] * feat_dim))
            .node(os.path.join(d, "item_table"), "i",
                  gl.Decoder(attr_types=["float"] * feat_dim))
            .edge(os.path.join(d, "u2i_table"), ("u", "i", "u-i"),
                  gl.Decoder(weighted=True))
            .edge(os.path.join(d, "i2i_table"), ("i", "i", "i-i"),
                  gl.Decoder(weighted=True))).init()


def _jax_tgn(d):
    """``examples/tgn.py:81-89``'s load."""
    return (gl.Graph()
            .node(os.path.join(d, "user_table"), "u",
                  gl.Decoder(attr_types=["float"] * 8))
            .node(os.path.join(d, "item_table"), "i",
                  gl.Decoder(attr_types=["float"] * 8))
            .edge(os.path.join(d, "event_table"), ("u", "i", "ev"),
                  gl.Decoder(timestamped=True))).init()


def _jax_sage_unsup(d):
    load = _root_function("examples/sage_unsupervised.py", "load", gl=gl,
                          os=os, cora_like=ROOT_SYNTHETIC.cora_like)
    return load(d, 32)[0]


def _jax_tgn_writer(d):
    _root_function("examples/tgn.py", "gen_temporal_u2i", np=np,
                   os=os)(d)


# name: (the JAX example's writing call as its main makes it, its load,
# the port's load, the port's in-memory twin, argv of a short main)
TSV_FORMS = {
    "node2vec": (
        lambda d: ROOT_SYNTHETIC.cora_like(d, n=1000, classes=7,
                                           feat_dim=64),
        lambda d: _jax_homogeneous(d, 64),
        lambda d: node2vec.load(d, device="cpu")[0],
        lambda: node2vec.build_graph(node2vec.cora_like(text=True),
                                     "cpu")[0],
        ["--epochs", "1", "--walk_len", "4"]),
    "sage_unsupervised": (
        lambda d: ROOT_SYNTHETIC.cora_like(d, n=800, feat_dim=32),
        _jax_sage_unsup,
        lambda d: sage_unsupervised.load(d, 32, "cpu")[0],
        lambda: sage_unsupervised.build_graph(
            node2vec.cora_like(n=800, feat_dim=32, text=True), "cpu")[0],
        ["--epochs", "1", "--steps_per_epoch", "2", "--batch_size",
         "256"]),
    "tgn": (
        _jax_tgn_writer, _jax_tgn,
        lambda d: tgn.load(d, "cpu"),
        lambda: tgn.build_graph(tgn.gen_temporal_u2i(), "cpu"),
        ["--epochs", "1", "--batch_size", "512"]),
    "ultra_gcn": (
        lambda d: ROOT_SYNTHETIC.u2i(d, feat_dim=16), _jax_u2i,
        lambda d: bipartite_sage.load(d, 16, "cpu")[0],
        lambda: bipartite_sage.build_graph(
            bipartite_sage.u2i_arrays(feat_dim=16, text=True), "cpu")[0],
        ["--steps", "3", "--batch_size", "64"]),
    "bipartite_sage": (
        lambda d: ROOT_SYNTHETIC.u2i(d, feat_dim=16), _jax_u2i,
        lambda d: bipartite_sage.load(d, 16, "cpu")[0],
        lambda: bipartite_sage.build_graph(
            bipartite_sage.u2i_arrays(feat_dim=16, text=True), "cpu")[0],
        ["--epochs", "1", "--steps_per_epoch", "2"]),
    "seal": (
        lambda d: ROOT_SYNTHETIC.cora_like(d, n=1000, classes=7,
                                           feat_dim=64),
        lambda d: _jax_homogeneous(d, 64),
        lambda d: node2vec.load(d, 64, device="cpu")[0],
        lambda: node2vec.build_graph(node2vec.cora_like(text=True),
                                     "cpu")[0],
        ["--steps", "2", "--batch_size", "8"]),
}
EXAMPLES = {"node2vec": node2vec, "sage_unsupervised": sage_unsupervised,
            "tgn": tgn, "ultra_gcn": ultra_gcn,
            "bipartite_sage": bipartite_sage, "seal": seal}


@pytest.fixture(scope="module")
def tsv_forms(tmp_path_factory):
    """{name: (directory the port example wrote, the JAX example's)}."""
    out = {}
    for name, (jax_write, _, port_load, _, _) in TSV_FORMS.items():
        d = tmp_path_factory.mktemp(name)
        port_load(str(d / "port"))
        jax_write(str(d / "jax"))
        out[name] = (str(d / "port"), str(d / "jax"))
    return out


@pytest.mark.parametrize("name", sorted(TSV_FORMS))
def test_each_example_writes_its_jax_examples_bytes(tsv_forms, name):
    port, jax_dir = tsv_forms[name]
    files = sorted(os.listdir(jax_dir))
    assert files and files == sorted(os.listdir(port))
    for f in files:
        assert filecmp.cmp(os.path.join(port, f), os.path.join(jax_dir, f),
                           shallow=False), f


@pytest.mark.parametrize("name", sorted(TSV_FORMS))
def test_each_file_store_equals_the_jax_examples_store(tsv_forms, name):
    """The port's load of the files and the JAX example's load of the same
    files: every table, CSR and pool bit for bit."""
    _, jax_load, port_load, _, _ = TSV_FORMS[name]
    port, _ = tsv_forms[name]
    store_equal(port_load(port), jax_load(port))


@pytest.mark.parametrize("name", sorted(TSV_FORMS))
def test_each_file_store_equals_its_in_memory_twin(tsv_forms, name):
    """The in-memory build of the same draws, features as their text
    reads back: every host array and CPU CSR array bit for bit."""
    _, _, port_load, twin, _ = TSV_FORMS[name]
    _ports_equal(port_load(tsv_forms[name][0]), twin())


@pytest.mark.parametrize("name", sorted(TSV_FORMS))
def test_each_main_runs_on_the_files_it_writes(tmp_path, name):
    """``main([... "--cpu"])`` on an empty ``--data_dir``: the files are
    written there, then loaded and trained on; the quality number it
    returns lies in [0, 1]."""
    d = str(tmp_path / name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = EXAMPLES[name].main(["--cpu", "--data_dir", d]
                                  + TSV_FORMS[name][4])
    TSV_FORMS[name][0](str(tmp_path / "jax"))
    assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path / "jax"))
    assert np.isfinite(got) and 0.0 <= got <= 1.0, out.getvalue()
