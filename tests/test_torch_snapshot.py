"""Store snapshots across the two packages (core/snapshot.py,
``Graph.save`` / ``Graph.load``): a snapshot the JAX package saves loads
in the port and one the port saves loads in the JAX package, on a graph
with weights, labels, timestamps, hashed and multi-value columns and a
masked set; the restored tables, node sets, CSRs and candidate pools are
bit-equal to the other package's own build, the time domain is kept, and
the format errors are the JAX package's (tests/test_core_store.py:
337-480)."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.core import snapshot
from torch_parity import store_equal

N = 24
ATTR_TYPES = [("string", 50), "float", ("string", 20, True), "string"]
ATTR_DIMS = [8, None, 8, 4]


def _files(tmp_path):
    rng = np.random.default_rng(5)
    f = {k: str(tmp_path / k) for k in ("n", "e", "train")}
    with open(f["n"], "w") as fh:
        fh.write("id:int64\tweight:float\tlabel:int64\tfeature:string\n")
        for i in range(N):
            tags = "|".join("t%d" % t for t in rng.integers(0, 9, i % 4 + 1))
            fh.write("%d\t%.3f\t%d\tcat%d:%.5f:%s:w%d\n"
                     % (i * 3 + 1, rng.random(), i % 4, i % 5,
                        rng.standard_normal(), tags, i % 7))
    with open(f["e"], "w") as fh:
        fh.write("src_id:int64\tdst_id:int64\tweight:float\t"
                 "timestamp:int64\n")
        for _ in range(90):
            s, d = rng.integers(0, N, 2)
            fh.write("%d\t%d\t%.4f\t%d\n" % (s * 3 + 1, d * 3 + 1,
                                             rng.random(),
                                             1_700_000_000
                                             + int(rng.integers(0, 10**6))))
    with open(f["train"], "w") as fh:
        fh.write("id:int64\n")
        for i in range(0, N, 3):
            fh.write("%d\n" % (i * 3 + 1))
    return f


def _build(mod, g, f):
    dec = mod.Decoder(weighted=True, labeled=True, attr_types=ATTR_TYPES,
                      attr_dims=ATTR_DIMS)
    return (g.node(f["n"], "v", dec)
            .node(f["train"], "v", mod.Decoder(), mask=mod.Mask.TRAIN)
            .edge(f["e"], ("v", "v", "e"),
                  mod.Decoder(weighted=True, timestamped=True),
                  directed=False)).init()


def test_a_jax_snapshot_loads_in_the_port(tmp_path):
    f = _files(tmp_path)
    jg = _build(gl, gl.Graph(), f)
    jg.save(str(tmp_path / "snap"))
    tg = glt.Graph.load(str(tmp_path / "snap"), device="cpu")
    store_equal(tg, jg)
    assert tg.device == torch.device("cpu")
    et, jet = tg.store.edge_table("e"), jg.store.edge_table("e")
    assert (et.ts_base, et.ts_scale) == (jet.ts_base, jet.ts_scale)
    assert et.ts_base >= 1_700_000_000 and et.timestamps.min() == 0


def test_a_port_snapshot_loads_in_the_jax_package(tmp_path):
    f = _files(tmp_path)
    tg = _build(glt, glt.Graph(device="cpu"), f)
    tg.save(str(tmp_path / "snap"))
    jg = gl.Graph.load(str(tmp_path / "snap"))
    store_equal(tg, jg)
    # the same bytes as the JAX package's own snapshot of its own build
    _build(gl, gl.Graph(), f).save(str(tmp_path / "jsnap"))
    names = sorted(os.listdir(tmp_path / "snap"))
    assert names == sorted(os.listdir(tmp_path / "jsnap"))
    for n in names:
        if n.endswith(".npy"):
            a = np.load(tmp_path / "snap" / n)
            b = np.load(tmp_path / "jsnap" / n)
            assert a.dtype == b.dtype, n
            np.testing.assert_array_equal(a, b, err_msg=n)
    assert (json.load(open(tmp_path / "snap" / "manifest.json"))
            == json.load(open(tmp_path / "jsnap" / "manifest.json")))


@pytest.mark.parametrize("mmap", [True, False])
def test_the_timestamped_domain_and_ts_order_survive(tmp_path, mmap):
    """A weighted, timestamped table restores with its saved (base,
    scale) and keeps its rows in time order, not weight order; the
    restored views never alias the read-only mapped arrays."""
    f = _files(tmp_path)
    tg = _build(glt, glt.Graph(device="cpu"), f)
    tg.save(str(tmp_path / "snap"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g2 = glt.Graph.load(str(tmp_path / "snap"), mmap=mmap, device="cpu")
        views = g2.store.edge_table("e").device("cpu")
        nodes = g2.store.node_table("v").device("cpu")
    a, b = tg.store.edge_table("e"), g2.store.edge_table("e")
    assert (a.ts_base, a.ts_scale) == (b.ts_base, b.ts_scale)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert b._sort_desc is False
    np.testing.assert_array_equal(b._sort_key, b.timestamps.astype(float))
    ts = views.out.nbr_ts.numpy()
    ro = views.out.row_offsets.numpy()
    for r in range(N):
        assert np.all(np.diff(ts[ro[r]:ro[r + 1]]) >= 0)
    assert int(b.timestamps.min()) * b.ts_scale + b.ts_base == int(
        a.timestamps.min()) * a.ts_scale + a.ts_base
    if mmap:
        # the mapped arrays are read-only, and a write through a view
        # must not reach them
        assert not b.weights.flags.writeable
        nodes.weights.add_(1.0)
        views.weights.mul_(0.0)
        np.testing.assert_array_equal(g2.store.node_table("v").weights,
                                      tg.store.node_table("v").weights)
        np.testing.assert_array_equal(b.weights, a.weights)


def test_the_restored_store_answers_the_same_query(tmp_path):
    f = _files(tmp_path)
    tg = _build(glt, glt.Graph(device="cpu"), f)
    tg.save(str(tmp_path / "snap"))
    for name in ("n", "e", "train"):
        os.remove(f[name])  # a restore does not read the sources
    g2 = glt.Graph.load(str(tmp_path / "snap"), device="cpu")
    outs = []
    for g in (tg, g2):
        q = (g.V("v", mask=glt.Mask.TRAIN).batch(4).alias("src")
             .outV("e").sample(3).by("edge_weight").alias("h1").values())
        outs.append(glt.Dataset(q, seed=4, device="cpu").next())
    for a in ("src", "h1"):
        assert torch.equal(outs[0][a].ids, outs[1][a].ids)
        assert torch.equal(outs[0][a].int_attrs, outs[1][a].int_attrs)
        assert torch.equal(outs[0][a].float_attrs.materialize(),
                           outs[1][a].float_attrs.materialize())


def test_the_version_and_missing_path_errors(tmp_path):
    with pytest.raises(glt.InvalidArgumentError, match="no store snapshot"):
        glt.Graph.load(str(tmp_path / "nope"), device="cpu")
    f = _files(tmp_path)
    _build(glt, glt.Graph(device="cpu"), f).save(str(tmp_path / "snap"))
    man = json.load(open(tmp_path / "snap" / "manifest.json"))
    assert man["version"] == snapshot.FORMAT_VERSION == 1
    man["version"] = 999
    json.dump(man, open(tmp_path / "snap" / "manifest.json", "w"))
    for mod, kw in ((glt, {"device": "cpu"}), (gl, {})):
        with pytest.raises(mod.InvalidArgumentError, match="version"):
            mod.Graph.load(str(tmp_path / "snap"), **kw)
    # a graph with file sources saves only after init()
    g = glt.Graph(device="cpu").node(f["n"], "v", glt.Decoder())
    with pytest.raises(glt.InvalidArgumentError, match="initialized"):
        g.save(str(tmp_path / "early"))


def test_an_in_memory_graph_saves_and_restores(tmp_path):
    g, dec = glt.synthetic_graph(50, 4, 6, 3, seed=2, device="cpu")
    g.add_node_set("item", np.arange(0, 50, 5), glt.Mask.TEST)
    g.save(str(tmp_path / "snap"))
    g2 = glt.Graph.load(str(tmp_path / "snap"), device="cpu")
    jg = gl.Graph.load(str(tmp_path / "snap"))
    store_equal(g2, jg)
    a, b = g.store.edge_table("rel").device("cpu"), \
        g2.store.edge_table("rel").device("cpu")
    for f in ("row_offsets", "nbr_ids", "nbr_edge_ids", "cum_weights"):
        assert torch.equal(getattr(a.out, f), getattr(b.out, f))
    assert torch.equal(g.store.node_table("item").device("cpu").float_attrs,
                       g2.store.node_table("item").device("cpu").float_attrs)
