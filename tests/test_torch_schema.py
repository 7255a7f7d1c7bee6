"""The port's schema, attribute parsing and categorical columns
(core/schema.py, core/ingest.py, core/store.py, ops/lookup.py) against the
JAX package's: ``Decoder`` / ``AttrDef`` / ``FeatureSpec`` over a lattice
of attribute types and every error, ``hash64`` / ``hash64_array`` bit for
bit, ``_parse_attrs`` column by column, and node and edge tables with int
and multi-value columns and node timestamps, looked up exactly."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.core import ingest as jingest
from graph_learn_tpu.core import schema as jschema
from graph_learn_tpu.core import store as jstore
from graph_learn_tpu.errors import InvalidArgumentError as JaxError
from graph_learn_tpu.ops import lookup as jlookup
from graph_learn_tpu_torch.core import ingest, schema, store
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.ops import lookup

# one of each attribute kind, with and without an embedding dim
KINDS = [("float", None), ("int", None), ("int", 6), (("int", 9), 4),
         ("string", None), ("string", 3), (("string", 11), None),
         (("string", 13, True), 5), (("string", 7, True), None)]
# every pair and a few longer lists of them
LATTICE = ([[k] for k in KINDS]
           + [list(p) for p in itertools.combinations(KINDS, 2)]
           + [KINDS, KINDS[::-1], KINDS[1::2]])


def _decoders(kinds, **kw):
    types = [t for t, _ in kinds]
    dims = [d for _, d in kinds]
    if not any(dims):
        dims = None
    return (jschema.Decoder(attr_types=types, attr_dims=dims, **kw),
            schema.Decoder(attr_types=types, attr_dims=dims, **kw))


def _same_decoder(j, t):
    assert [_attr_tuple(a) for a in t.attrs] == \
        [_attr_tuple(a) for a in j.attrs]
    for f in ("int_attrs", "float_attrs", "multival_attrs"):
        assert [a.index for a in getattr(t, f)] == \
            [a.index for a in getattr(j, f)], f
    for f in ("int_attr_num", "float_attr_num", "multival_attr_num",
              "has_property", "attributed", "weighted", "labeled",
              "timestamped", "attr_delimiter", "multival_max_len",
              "attr_types", "attr_dims"):
        assert getattr(t, f) == getattr(j, f), f
    for a in t.attrs:
        ja = j.attrs[a.index]
        assert (a.is_numeric, a.is_embedding) == (ja.is_numeric,
                                                  ja.is_embedding)
    js, ts = j.feature_spec(), t.feature_spec()
    assert ts.total_dim == js.total_dim
    for f in ("numeric", "embeddings", "multivals"):
        assert [a.index for a in getattr(ts, f)] == \
            [a.index for a in getattr(js, f)]


def _attr_tuple(a):
    return (a.index, a.type_name, a.bucket_size, a.is_multival, a.dim)


@pytest.mark.parametrize("kinds", LATTICE,
                         ids=["-".join(str(t) for t, _ in k)[:60]
                              for k in LATTICE])
def test_decoder_resolves_like_jax(kinds):
    j, t = _decoders(kinds, weighted=True, multival_max_len=4)
    _same_decoder(j, t)


@pytest.mark.parametrize("flags", list(itertools.product([False, True],
                                                         repeat=3)))
def test_flag_only_decoders(flags):
    w, lab, ts = flags
    j = jschema.Decoder(weighted=w, labeled=lab, timestamped=ts)
    t = schema.Decoder(weighted=w, labeled=lab, timestamped=ts)
    _same_decoder(j, t)


@pytest.mark.parametrize("types,dims", [
    (["bytes"], None),
    ([("float", 4)], None),
    ([("float", None, True)], None),
    ([("int", 4, True)], None),
    (["float", "int"], [3]),
    ([3.5], None),
])
def test_decoder_errors_match_jax(types, dims):
    with pytest.raises(JaxError) as je:
        jschema.Decoder(attr_types=types, attr_dims=dims)
    with pytest.raises(InvalidArgumentError) as te:
        schema.Decoder(attr_types=types, attr_dims=dims)
    assert str(te.value) == str(je.value)


STRINGS = ["", "a", "brand_17", "héllo wörld", "日本語テキスト", "🙂",
           "tab\there", "x" * 1000, "a,b,c", ":"]


def test_hash64_is_bit_equal():
    for s in STRINGS:
        assert ingest.hash64(s) == jingest.hash64(s), s
    rng = np.random.default_rng(0)
    many = STRINGS + ["".join(chr(c) for c in rng.integers(32, 0x3000, n))
                      for n in rng.integers(0, 40, 3000)]
    got, want = ingest.hash64_array(many), jingest.hash64_array(many)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert ingest.hash64_array([]).shape == (0,)


def _attr_strings(n, rng):
    rows = []
    for i in range(n):
        tags = ",".join("t%d" % x for x in rng.integers(0, 50,
                                                         rng.integers(0, 7)))
        if i % 5 == 0:
            tags = ",," + tags  # empty items are dropped
        rows.append(":".join([
            "%.3f" % rng.standard_normal(), str(int(rng.integers(-5, 50))),
            str(int(rng.integers(0, 90))), "s%d" % rng.integers(0, 9),
            "é%d" % rng.integers(0, 9), tags, "u%d" % i]))
    return rows


@pytest.mark.parametrize("max_len", [1, 3, 8])
def test_parse_attrs_equals_jax_column_by_column(max_len):
    types = ["float", "int", ("int", 17), "string", ("string", 5),
             ("string", 31, True), ("string", None, True)]
    kw = dict(attr_types=types, attr_dims=[None, None, 4, 2, 3, 5, 6],
              multival_max_len=max_len)
    col = _attr_strings(200, np.random.default_rng(max_len))
    want = jingest._parse_attrs(col, jschema.Decoder(**kw))
    got = ingest._parse_attrs(col, schema.Decoder(**kw))
    for g, w, name in zip(got, want, ("int", "float", "multival", "lens")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # an empty multi-value row, and the dynamic bucket of a bare string
    lens = got[3][:, 1]
    assert (lens <= max_len).all()


@pytest.mark.parametrize("bad", ["1.0:2", "x:2:3", "1.0:2:3:4"])
def test_parse_attrs_errors_match_jax(bad):
    types = ["float", "int", "string"]
    with pytest.raises(JaxError) as je:
        jingest._parse_attrs([bad], jschema.Decoder(attr_types=types))
    with pytest.raises(InvalidArgumentError) as te:
        ingest._parse_attrs([bad], schema.Decoder(attr_types=types))
    assert str(te.value) == str(je.value)


def _tables(mod_schema, mod_store, n=40, e=120, seed=0):
    """A node table with int, float and multi-value columns, weights,
    labels and timestamps, and an edge table with int and multi-value
    columns, in one package."""
    rng = np.random.default_rng(seed)
    ndec = mod_schema.Decoder(
        weighted=True, labeled=True, timestamped=True,
        attr_types=["float", ("int", 8), ("string", 10, True), "float"],
        attr_dims=[None, 3, 4, None], multival_max_len=3)
    edec = mod_schema.Decoder(
        weighted=True, attr_types=[("string", 6), "float",
                                   ("string", 5, True)],
        attr_dims=[2, None, 3], multival_max_len=2)
    nt = mod_store.NodeTable(
        "v", ndec, np.arange(n, dtype=np.int64) * 2 + 1,
        int_attrs=rng.integers(0, 8, (n, 1)),
        float_attrs=rng.standard_normal((n, 2)).astype(np.float32),
        multival_attrs=rng.integers(0, 10, (n, 1, 3)),
        multival_lens=rng.integers(0, 4, (n, 1)),
        weights=rng.random(n).astype(np.float32),
        labels=rng.integers(0, 3, n),
        timestamps=1_600_000_000_000 + rng.integers(0, 10**6, n))
    et = mod_store.EdgeTable(
        "r", "v", "v", edec, src=rng.integers(0, n, e),
        dst=rng.integers(0, n, e), num_src_nodes=n, num_dst_nodes=n,
        int_attrs=rng.integers(0, 6, (e, 1)),
        float_attrs=rng.standard_normal((e, 1)).astype(np.float32),
        multival_attrs=rng.integers(0, 5, (e, 1, 2)),
        multival_lens=rng.integers(0, 3, (e, 1)),
        weights=rng.random(e).astype(np.float32))
    return nt, et


def test_tables_carry_the_columns_with_the_jax_dtypes():
    jnt, jet = _tables(jschema, jstore)
    tnt, tet = _tables(schema, store)
    for f in ("int_attrs", "float_attrs", "multival_attrs", "multival_lens",
              "weights", "labels", "timestamps"):
        x, y = getattr(jnt, f), getattr(tnt, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x)
    for f in ("int_attrs", "float_attrs", "multival_attrs",
              "multival_lens"):
        x, y = getattr(jet, f), getattr(tet, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x)
    dn, de = tnt.device("cpu"), tet.device("cpu")
    assert dn.int_attrs.dtype == dn.multival_attrs.dtype == torch.int32
    assert dn.multival_lens.dtype == torch.int32
    assert dn.timestamps.dtype == torch.int64
    assert dn.timestamps[0].item() > 2 ** 40  # no int32 truncation
    assert de.int_attrs.dtype == de.multival_lens.dtype == torch.int32
    with pytest.raises(InvalidArgumentError) as te:
        schema_bad = schema.Decoder(attr_types=[("int", 3)], attr_dims=[2])
        store.NodeTable("v", schema_bad, np.arange(4),
                        int_attrs=np.zeros((3, 1)))
    with pytest.raises(JaxError) as je:
        jstore.NodeTable("v", jschema.Decoder(attr_types=[("int", 3)],
                                              attr_dims=[2]),
                         np.arange(4), int_attrs=np.zeros((3, 1)))
    assert str(te.value) == str(je.value)


def test_lookups_and_edge_payload_equal_jax():
    jnt, jet = _tables(jschema, jstore)
    tnt, tet = _tables(schema, store)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, (5, 3)).astype(np.int32)
    jn = jlookup.lookup_nodes(jnt.device(), jnp.asarray(ids), "v")
    tn = lookup.lookup_nodes(tnt.device("cpu"), torch.from_numpy(ids), "v")
    for f in ("raw_ids", "int_attrs", "multival_attrs", "multival_lens",
              "weights", "labels"):
        np.testing.assert_array_equal(getattr(tn, f).numpy(),
                                      np.asarray(getattr(jn, f)), f)
    # JAX's device views hold the node timestamps in int32 without x64;
    # the port keeps int64
    np.testing.assert_array_equal(tn.timestamps.numpy(),
                                  tnt.timestamps[ids])
    np.testing.assert_array_equal(tn.float_attrs.materialize().numpy(),
                                  np.asarray(jn.float_attrs))
    deg = rng.integers(0, 4, 5).astype(np.int32)
    js = jlookup.lookup_sparse_nodes(jnt.device(), jnp.asarray(ids),
                                     jnp.asarray(deg))
    ts = lookup.lookup_sparse_nodes(tnt.device("cpu"), torch.from_numpy(ids),
                                    torch.from_numpy(deg))
    for f in ("int_attrs", "multival_attrs", "multival_lens"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    eids = rng.integers(-1, 120, (6, 4)).astype(np.int32)
    eids[0, 0] = -1
    jp = jlookup.edge_payload(jet.device(), jnp.asarray(eids))
    tp = lookup.edge_payload(tet.device("cpu"), torch.from_numpy(eids))
    assert sorted(tp) == sorted(jp)
    assert [f for f, v in tp.items() if v is None] == \
        [f for f, v in jp.items() if v is None] == ["labels", "timestamps"]
    for f, v in jp.items():
        got = tp[f]
        if v is None:
            continue
        if f == "float_attrs":
            got = got.materialize()
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), f)


def test_the_dispatcher_carries_categorical_columns_to_each_caller():
    """QueryService coalesces concurrent requests into one plan run and
    slices each caller's rows back out: the int and multi-value columns of
    the seeds and of their hop come back with the rows they belong to."""
    import threading

    import graph_learn_tpu_torch as glt
    from torch_parity import cat_u2i_arrays, torch_u2i_graph
    a = cat_u2i_arrays(seed=8)
    tg = torch_u2i_graph(a)[0]
    q = (tg.V("i").batch(8).alias("src").outV("i-i").sample(3)
         .by("random").alias("h1").values())
    svc = glt.QueryService(tg, device="cpu")
    try:
        qid = svc.install(q, micro_batch=32)
        reqs = [np.arange(k, k + n) for k, n in ((0, 5), (7, 11), (30, 2),
                                                 (12, 20))]
        out = [None] * len(reqs)

        def call(i):
            out[i] = svc.run(qid, reqs[i])
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        svc.close()
    for ids, ans in zip(reqs, out):
        src, h1 = ans["src"], ans["h1"]
        np.testing.assert_array_equal(src.int_attrs.numpy(), a["i_int"][ids])
        np.testing.assert_array_equal(src.multival_attrs.numpy(),
                                      a["i_mv"][ids])
        np.testing.assert_array_equal(src.multival_lens.numpy(),
                                      a["i_mv_lens"][ids])
        hid = h1.ids.numpy()
        assert hid.shape == (ids.size, 3)
        np.testing.assert_array_equal(h1.int_attrs.numpy(), a["i_int"][hid])
        np.testing.assert_array_equal(h1.multival_lens.numpy(),
                                      a["i_mv_lens"][hid])
