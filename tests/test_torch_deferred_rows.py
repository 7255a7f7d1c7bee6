"""A batch's feature rows on the port are a ``DeferredRows`` (the port's
deliberate difference: they are gathered where they are read), and it
reads as the array the JAX package's batch carries: ``np.asarray`` gathers
the rows, ``shape`` and ``dtype`` are the rows'."""

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.core.values import DeferredRows


def _write_two_sources(d):
    """tests/test_gsl_parity_nits.py:174-187's files."""
    for part, rng in (("a", range(0, 5)), ("b", range(5, 9))):
        with open(d + "/n_%s" % part, "w") as f:
            f.write("id:int64\tlabel:int64\tfeature:string\n")
            for i in rng:
                f.write("%d\t%d\t%.1f:%.1f\n" % (i, i % 2, i, i * 2))
    with open(d + "/e", "w") as f:
        f.write("src_id:int64\tdst_id:int64\n")
        for i in range(9):
            f.write("%d\t%d\n" % (i, (i + 1) % 9))


def _graph(mod, d, **kw):
    dec = mod.Decoder(labeled=True, attr_types=["float"] * 2)
    return (mod.Graph(**kw).node(d + "/n_a," + d + "/n_b", "v", dec)
            .edge(d + "/e", ("v", "v", "e"), mod.Decoder())).init()


def test_multiple_node_sources_merge_reads_as_the_jax_array(tmp_path):
    """The body of tests/test_gsl_parity_nits.py:174-195
    (test_multiple_node_sources_merge) on the port."""
    d = str(tmp_path)
    _write_two_sources(d)
    g = _graph(glt, d, device="cpu")
    assert g.get_stats()["nodes"]["v"] == 9
    out = glt.Dataset(g.V("v").batch(9).alias("s").values(), window=1,
                      device="cpu").next()
    assert isinstance(out["s"].float_attrs, DeferredRows)  # still deferred
    feats = np.asarray(out["s"].float_attrs)
    assert feats.shape == (9, 2) and feats.dtype == np.float32
    np.testing.assert_allclose(feats[:, 0], np.arange(9), atol=1e-5)
    jout = gl.Dataset(_graph(gl, d).V("v").batch(9).alias("s").values(),
                      window=1).next()
    np.testing.assert_array_equal(feats, np.asarray(jout["s"].float_attrs))
    # duplicate ids across sources raise loudly
    dec = glt.Decoder(labeled=True, attr_types=["float"] * 2)
    g2 = (glt.Graph(device="cpu").node(d + "/n_a," + d + "/n_a", "v2", dec)
          .edge(d + "/e", ("v2", "v2", "e2"), glt.Decoder()))
    with pytest.raises(Exception):
        g2.init()


def test_a_hop_reads_as_the_jax_hop(tmp_path):
    """A fanout-shaped hop of a deterministic query: its DeferredRows has
    the JAX array's shape and dtype, and np.asarray of it equals the JAX
    batch's rows; materialize() gives the same rows as a tensor."""
    d = str(tmp_path)
    _write_two_sources(d)
    outs = []
    for mod, kw in ((gl, {}), (glt, {"device": "cpu"})):
        q = (_graph(mod, d, **kw).V("v").batch(4).alias("s")
             .outV("e").sample(2).by("topk").alias("h1").values())
        outs.append(mod.Dataset(q, window=1, **kw).next())
    jrows, rows = outs[0]["h1"].float_attrs, outs[1]["h1"].float_attrs
    assert isinstance(rows, DeferredRows)
    assert tuple(rows.shape) == jrows.shape == (4, 2, 2)
    assert rows.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(rows), np.asarray(jrows))
    np.testing.assert_array_equal(np.asarray(rows, dtype=np.float64),
                                  np.asarray(jrows, dtype=np.float64))
    assert torch.equal(rows.materialize(), torch.from_numpy(np.asarray(rows)))


def test_bf16_rows_read_as_float32():
    """numpy has no bfloat16: a bf16 table's rows read as float32, with
    the same values."""
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    rows = DeferredRows(table=table.bfloat16(), idx=torch.tensor([[5, 0]]))
    assert rows.dtype == torch.bfloat16 and tuple(rows.shape) == (1, 2, 2)
    got = np.asarray(rows)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, table.numpy()[[[5, 0]]])
