"""The port's data writers and its real-layout examples against the JAX
package's (examples/data/{cora,ogbl_collab,ogbn_products}.py,
examples/ego_sage_supervised.py load_graph, examples/seal.py
--collab_dir), on generated raw files of the real formats, as
tests/test_real_datasets.py holds the JAX side: each port writer writes
the JAX writer's bytes on the same inputs; each loaded store equals the
JAX store loaded from the same files (non-contiguous Cora ids, the
uniform cum_weights of Cora's zero weights) and, for the collab tables,
the in-memory build of the same draws; seal --collab_dir prints its
hits@50 and reaches 0.6 on the planted 400-node set; the reference Cora
configuration (1 433 features) trains for 2 epochs with 2 + 1 kernel
calls a step.
Tolerances: bytes and stores exact (every array bit for bit); losses
finite and falling; hits@50 at least 0.6 (the JAX test's bar)."""

import ast
import contextlib
import filecmp
import gzip
import importlib.util
import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
from graph_learn_tpu_torch.errors import NotFoundError
from graph_learn_tpu_torch.examples import ego_sage_supervised, seal
from graph_learn_tpu_torch.examples.data import (cora, ogbl_collab,
                                                 ogbn_products, synthetic)
from graph_learn_tpu_torch.ops.kernels import gather, spmm
from torch_parity import store_equal

REPO = Path(__file__).resolve().parents[1]


def _root_module(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROOT_CORA = _root_module("root_cora", "examples/data/cora.py")
ROOT_COLLAB = _root_module("root_ogbl_collab", "examples/data/ogbl_collab.py")
ROOT_PRODUCTS = _root_module("root_ogbn_products",
                             "examples/data/ogbn_products.py")


def _jax_load_graph():
    """``examples/ego_sage_supervised.py load_graph``, run as written (its
    module sets the platform when imported, so only the function is
    taken)."""
    rel = "examples/ego_sage_supervised.py"
    tree = ast.parse((REPO / rel).read_text())
    keep = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == "load_graph"]
    ns = {"gl": gl, "os": os}
    exec(compile(ast.Module(body=keep, type_ignores=[]), rel, "exec"), ns)
    return ns["load_graph"]


def _jax_collab(d):
    """``examples/seal.py:61-69``: the --collab_dir load."""
    return (gl.Graph()
            .node(os.path.join(d, "ogbl_collab_node"), "item",
                  gl.Decoder(attr_types=["float"] * 128))
            .edge(os.path.join(d, "ogbl_collab_train_edge"),
                  ("item", "item", "relation"), gl.Decoder(weighted=True),
                  directed=False)).init()


def _same_dirs(a, b):
    files = sorted(os.listdir(a))
    assert files and files == sorted(os.listdir(b))
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


# ---------------------------------------------------------------------------
# Cora
# ---------------------------------------------------------------------------

def _fake_raw_cora(d, n=60, nf=16, classes=4, seed=0, loops=False):
    """Miniature cora.content / cora.cites in the real raw format
    (``tests/test_real_datasets.py:23-37``); with ``loops`` the last node's
    words are all zero and some citations cite themselves."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(100, 100 + n))  # non-contiguous ids
    names = ["Case_%d" % c for c in range(classes)]
    with open(os.path.join(d, "cora.content"), "w") as f:
        for i, nid in enumerate(ids):
            w = (rng.random(nf) < 0.2).astype(int)
            if loops and i == n - 1:
                w[:] = 0
            f.write("%d\t%s\t%s\n"
                    % (nid, "\t".join(map(str, w)), names[i % classes]))
    with open(os.path.join(d, "cora.cites"), "w") as f:
        for i in range(n * 3):
            a, b = rng.choice(ids, 2, replace=False)
            if loops and i % 7 == 0:
                b = a
            f.write("%d\t%d\n" % (a, b))
    return ids


CORA_CASES = {"the JAX test's": dict(),
              "zero row, self-citations, 7 classes": dict(
                  n=300, nf=40, classes=7, seed=5, loops=True)}


@pytest.fixture(scope="module", params=sorted(CORA_CASES))
def cora_dirs(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("cora")
    (d / "raw").mkdir()
    ids = _fake_raw_cora(str(d / "raw"), **CORA_CASES[request.param])
    ROOT_CORA.prepare_cora(str(d / "raw"), str(d / "jax"))
    cora.main(["--raw_dir", str(d / "raw"), "--out_dir", str(d / "port")])
    nf = CORA_CASES[request.param].get("nf", 16)
    return ids, nf, str(d / "port"), str(d / "jax")


def test_prepare_cora_writes_the_jax_writers_bytes(cora_dirs):
    _, _, port, jax_dir = cora_dirs
    _same_dirs(port, jax_dir)


def test_the_cora_store_equals_the_jax_store(cora_dirs):
    """``ego_sage_supervised.load_graph`` against the JAX example's on the
    prepared tables: the id index of the permuted raw ids, the
    row-normalised features, the self-loops and the uniform
    ``cum_weights`` that all-zero weights fall back to."""
    ids, nf, port, _ = cora_dirs
    g, dec = ego_sage_supervised.load_graph(port, nf, device="cpu")
    jg, _ = _jax_load_graph()(port, nf)
    store_equal(g, jg)
    nt = g.store.node_table("item")
    np.testing.assert_array_equal(nt.raw_ids, ids)
    assert dec.float_attr_num == nf
    sums = nt.float_attrs.sum(1)
    assert np.all((sums == 0) | (np.abs(sums - 1) < 1e-5))
    et = g.store.edge_table("relation")
    assert np.all(et.weights == 0)
    out = et.device("cpu").out
    deg = np.diff(out.row_offsets.numpy())
    assert deg.min() >= 2  # the self-loop, both ways
    rows = np.repeat(np.arange(deg.size), deg)
    first = out.row_offsets.numpy()[:-1]
    rank = np.arange(rows.size) - first[rows] + 1
    np.testing.assert_array_equal(out.cum_weights.numpy(),
                                  (rank / deg[rows]).astype(np.float32))
    n = ids.size
    for name, size in (("MASK*item", min(140, n)),
                       ("MASK**item", max(min(500, n) - min(200, n), 0)),
                       ("MASK***item", max(min(1500, n) - min(500, n), 0))):
        assert g.store.node_set(name).size == size, name


# ---------------------------------------------------------------------------
# ogbl-collab
# ---------------------------------------------------------------------------

COLLAB_CASES = {
    "f32 features, int64 weights": (np.float32, lambda r, k: r.integers(
        1, 5, k)),
    "f64 features, f64 weights": (np.float64, lambda r, k: r.random(k)),
    "f32 features, f32 weights": (np.float32, lambda r, k: r.random(
        k).astype(np.float32)),
    "f64 features, unit f64 weights": (np.float64, lambda r, k: np.ones(k)),
}


@pytest.mark.parametrize("case", sorted(COLLAB_CASES))
def test_write_collab_tables_writes_the_jax_writers_bytes(tmp_path, case):
    feat_dtype, weights = COLLAB_CASES[case]
    rng = np.random.default_rng(1)
    n = 50
    args = (rng.integers(0, n, (200, 2)), weights(rng, 200),
            rng.integers(0, n, (20, 2)), rng.integers(0, n, (20, 2)),
            rng.integers(0, n, (20, 2)), rng.integers(0, n, (20, 2)),
            rng.standard_normal((n, 8)).astype(feat_dtype))
    assert ogbl_collab.write_collab_tables(str(tmp_path / "port"),
                                           *args) == str(tmp_path / "port")
    ROOT_COLLAB.write_collab_tables(str(tmp_path / "jax"), *args)
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.fixture(scope="module")
def planted_dir(tmp_path_factory):
    """The planted 400-node set of ``tests/test_real_datasets.py:277-305``
    written as collab tables (unit float64 train weights), as that test
    writes it."""
    a = seal.planted_collab()
    d = str(tmp_path_factory.mktemp("planted"))
    ogbl_collab.write_collab_tables(d, a["train"], np.ones(len(a["train"])),
                                    a["valid"], a["valid_neg"], a["test"],
                                    a["test_neg"], a["feats"])
    return a, d


def test_the_collab_store_equals_the_jax_store_and_its_twin(planted_dir):
    """``seal.load_collab`` against the JAX example's --collab_dir load,
    and against ``seal.build_graph`` of the same draws: a float32's
    ``str`` reads back to the same float32, so the features too are
    bit-equal."""
    a, d = planted_dir
    g = seal.load_collab(d, "cpu")
    store_equal(g, _jax_collab(d))
    twin = seal.build_graph(a["feats"], a["train"][:, 0], a["train"][:, 1],
                            "cpu")
    for t in ("item",):
        x, y = g.store.node_table(t), twin.store.node_table(t)
        for f in ("raw_ids", "float_attrs"):
            assert getattr(x, f).dtype == getattr(y, f).dtype, f
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
    x, y = g.store.edge_table("relation"), twin.store.edge_table("relation")
    for f in ("src", "dst", "weights"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
    dx, dy = x.device("cpu").out, y.device("cpu").out
    for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "cum_weights"):
        assert torch.equal(getattr(dx, f), getattr(dy, f)), f


def test_seal_collab_dir_prints_hits_at_50(tmp_path):
    """``tests/test_real_datasets.py:180-202`` on the port: 80 nodes, 2
    steps of batch 8."""
    rng = np.random.default_rng(1)
    n = 80
    tr = rng.integers(0, n, (200, 2))
    va = rng.integers(0, n, (20, 2))
    te = rng.integers(0, n, (20, 2))
    neg = rng.integers(0, n, (30, 2))
    ogbl_collab.write_collab_tables(str(tmp_path), tr, np.ones(len(tr)), va,
                                    neg, te, neg,
                                    rng.random((n, 128)).astype(np.float32))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hits = seal.main(["--cpu", "--collab_dir", str(tmp_path), "--steps",
                          "2", "--batch_size", "8"])
    assert out.getvalue().splitlines()[-1] == "hits@50: %.4f" % hits
    assert 0.0 <= hits <= 1.0


def test_seal_collab_dir_reaches_the_bar_on_the_planted_set(planted_dir):
    """``tests/test_real_datasets.py:277-319`` on the port: 150 steps of
    batch 64 through --collab_dir, hits@50 at least 0.6."""
    _, d = planted_dir
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hits = seal.main(["--cpu", "--collab_dir", d, "--steps", "150",
                          "--batch_size", "64"])
    assert hits >= 0.6, out.getvalue()


def test_the_collab_test_pairs_go_through_the_node_index(tmp_path):
    """Raw ids that are not the dense indices: the test pairs are looked
    up through the node table's index, and an unknown raw id raises."""
    rng = np.random.default_rng(2)
    raw = rng.permutation(np.arange(1000, 1060))
    with open(tmp_path / "ogbl_collab_node", "w") as f:
        f.write("id:int64\tfeature:string\n")
        for r in raw:
            f.write("%d\t%s\n" % (r, ":".join(["0.5"] * 128)))
    pairs = raw[rng.integers(0, 60, (40, 2))]
    for name in ("ogbl_collab_train_edge", "ogbl_collab_test_edge",
                 "ogbl_collab_test_edge_neg"):
        with open(tmp_path / name, "w") as f:
            f.write("src_id:int64\tdst_id:int64\tweight:float\n")
            for s, t in pairs:
                f.write("%d\t%d\t1.0\n" % (s, t))
    g = seal.load_collab(str(tmp_path), "cpu")
    index = g.store.node_table("item").index
    dense = index.lookup(seal._read_edge_tsv(
        str(tmp_path / "ogbl_collab_test_edge")))
    np.testing.assert_array_equal(g.store.node_table("item").raw_ids[dense],
                                  pairs)
    hits = seal.main(["--cpu", "--collab_dir", str(tmp_path), "--steps",
                      "1", "--batch_size", "16"])
    assert 0.0 <= hits <= 1.0
    with open(tmp_path / "ogbl_collab_test_edge_neg", "a") as f:
        f.write("5\t6\t1.0\n")
    with pytest.raises(NotFoundError, match="not present"):
        seal.main(["--cpu", "--collab_dir", str(tmp_path), "--steps", "1",
                   "--batch_size", "16"])


# ---------------------------------------------------------------------------
# ogbn-products
# ---------------------------------------------------------------------------

def _fake_raw_products(raw, split, seed=0, n=30, f=6, e=90):
    """OGB's raw csv.gz layout (``tests/test_real_datasets.py:129-160``),
    the split in ``split``."""
    rng = np.random.default_rng(seed)

    def gz(path, arr, fmt):
        with gzip.open(path, "wt") as fh:
            for row in arr:
                fh.write(",".join(fmt % x for x in np.atleast_1d(row))
                         + "\n")

    raw.mkdir(parents=True)
    gz(raw / "node-feat.csv.gz", rng.random((n, f)).astype(np.float32),
       "%.4f")
    gz(raw / "node-label.csv.gz", rng.integers(0, 5, n), "%d")
    gz(raw / "edge.csv.gz", rng.integers(0, n, (e, 2)), "%d")
    split.mkdir(parents=True)
    order = rng.permutation(n)
    for name, sl in (("train", order[:20]), ("valid", order[20:25]),
                     ("test", order[25:])):
        with gzip.open(split / (name + ".csv.gz"), "wt") as fh:
            fh.write("\n".join(str(i) for i in sl) + "\n")


@pytest.mark.parametrize("layout", ["flat raw/split",
                                    "split/sales_ranking"])
def test_prepare_products_writes_the_jax_writers_bytes(tmp_path, layout):
    raw = tmp_path / "products" / "raw"
    split = (raw / "split" if layout == "flat raw/split"
             else tmp_path / "products" / "split" / "sales_ranking")
    _fake_raw_products(raw, split)
    ogbn_products.main(["--raw_dir", str(raw), "--out_dir",
                        str(tmp_path / "port")])
    ROOT_PRODUCTS.prepare_products(str(raw), str(tmp_path / "jax"))
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    g, _ = ego_sage_supervised.load_graph(str(tmp_path / "port"), 6, "cpu")
    store_equal(g, _jax_load_graph()(str(tmp_path / "port"), 6)[0])
    assert g.store.node_set("MASK*item").size == 20


def test_write_products_tables_writes_the_jax_writers_bytes(tmp_path):
    """The array writer alone, on features whose ``%.6g`` text takes an
    exponent and labels of another integer dtype."""
    rng = np.random.default_rng(4)
    n = 40
    args = ((rng.standard_normal((n, 5)) * 10.0 ** rng.integers(
        -8, 8, (n, 5))).astype(np.float32), rng.integers(0, 47, n).astype(
            np.int32), rng.integers(0, n, (100, 2)), np.arange(0, 20),
        np.arange(20, 30), np.arange(30, 40))
    ogbn_products.write_products_tables(str(tmp_path / "port"), *args)
    ROOT_PRODUCTS.write_products_tables(str(tmp_path / "jax"), *args)
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_read_csv_gz_reads_what_the_jax_reader_reads(tmp_path):
    path = tmp_path / "x.csv.gz"
    with gzip.open(path, "wt") as fh:
        fh.write("1,2.5\n3,4e-3\n")
    for dtype in (np.float32, np.float64):
        got = ogbn_products._read_csv_gz(str(path), dtype)
        want = ROOT_PRODUCTS._read_csv_gz(str(path), dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The reference Cora configuration on the supervised SAGE example
# ---------------------------------------------------------------------------

def test_the_reference_cora_configuration_trains_two_epochs(tmp_path,
                                                            monkeypatch):
    """``tests/test_real_datasets.py:249-275``'s configuration (cora_like
    2 708 nodes, 1 433 features, 7 classes, fanout [25, 10], gcn, hidden
    128, batch 140, Adam 0.05, dropout 0.5) for 2 epochs on the CPU, where
    its 40 epochs would take minutes: the loss falls, and every step and
    evaluated batch calls Kernel 1's wrapper twice (140 and 3 500 rows)
    and Kernel 2's once ([3 500, 10] means).  The accuracy bar (0.88) is
    held by chip_smoke.py on the card."""
    d = str(tmp_path / "cora_ref")
    synthetic.cora_like(d, n=2708, classes=7, feat_dim=1433)
    calls = []
    plain_gather, plain_spmm = gather.gather_rows_plain, \
        spmm.segment_spmm_plain

    def spy_gather(table, idx):
        calls.append(("gather", tuple(idx.shape), table.shape[1]))
        return plain_gather(table, idx)

    def spy_spmm(feats, ids, degrees, agg, *args, **kw):
        calls.append(("spmm", tuple(ids.shape), agg))
        return plain_spmm(feats, ids, degrees, agg, *args, **kw)

    monkeypatch.setattr(gather, "gather_rows_plain", spy_gather)
    monkeypatch.setattr(spmm, "segment_spmm_plain", spy_spmm)
    args = ego_sage_supervised.build_parser().parse_args(
        ["--cpu", "--data_dir", d, "--features_num", "1433", "--nodes",
         "2708", "--classes", "7", "--epochs", "2"])
    out = ego_sage_supervised.run(args)
    hist = out["history"]
    assert len(hist) == 2 and np.all(np.isfinite(hist)) and hist[1] < hist[0]
    store = out["graph"].store
    steps = 2 * -(-store.node_set("MASK*item").size // 140)
    evals = -(-store.node_set("MASK***item").size // 140)
    per_step = [("gather", (140,), 1433), ("gather", (3500,), 1433),
                ("spmm", (3500, 10), "mean")]
    assert sorted(calls) == sorted(per_step * (steps + evals)), calls[:6]
    assert 0.0 <= out["acc"] <= 1.0


# ---------------------------------------------------------------------------
# Deliberate differences from the JAX writers and examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,argv", [
    (cora, ["--raw_dir", "r", "--download"]),
    (ogbn_products, ["--raw_dir", "r", "--out_dir", "o", "--use_ogb"]),
])
def test_the_writers_have_no_download_or_ogb_flag(module, argv, capsys):
    """The port prepares data from files the user has: the JAX writers'
    ``--download`` (network) and ``--use_ogb`` (the ogb package and a
    download) are refused."""
    with pytest.raises(SystemExit):
        module.main(argv)
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("module,name", [
    (ogbl_collab, "prepare_from_ogb"), (ogbn_products, "prepare_from_ogb"),
    (cora, "CORA_URL")])
def test_the_writers_leave_out_the_ogb_and_network_routes(module, name):
    root = {cora: ROOT_CORA, ogbl_collab: ROOT_COLLAB,
            ogbn_products: ROOT_PRODUCTS}[module]
    assert hasattr(root, name) and not hasattr(module, name)


def test_sage_unsupervised_spells_its_flags_with_underscores(tmp_path,
                                                             capsys):
    """The port's examples spell flags with underscores; the JAX
    sage_unsupervised example's dashes (``--data-dir``) are refused."""
    from graph_learn_tpu_torch.examples import sage_unsupervised
    with pytest.raises(SystemExit):
        sage_unsupervised.main(["--cpu", "--data-dir", str(tmp_path)])
    assert "unrecognized arguments" in capsys.readouterr().err
    acc = sage_unsupervised.main(["--cpu", "--data_dir", str(tmp_path),
                                  "--epochs", "1", "--steps_per_epoch", "1",
                                  "--batch_size", "512"])
    assert 0.0 <= acc <= 1.0 and os.path.exists(tmp_path / "node_table")
