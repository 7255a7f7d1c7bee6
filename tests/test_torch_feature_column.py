"""The port's FeatureEncoder (nn/feature_column.py) against the JAX
package's flax one: float, bucketed int, hashed string and multi-value
columns, with and without a projection, the flax params carried across by
``nn/convert.py`` and the output within 1e-6; the dynamic bucket's clip
and empty multi-value rows pinned; and an encoder with embeddings making
EgoGNN gather its deepest hop (``_encoder_commutes`` False), where a
pre-aggregated hop is refused with the JAX message."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_learn_tpu.core import schema as jschema
from graph_learn_tpu.core.values import Nodes as JNodes
from graph_learn_tpu.errors import InvalidArgumentError as JaxError
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.feature_column import FeatureEncoder as JaxEncoder
from graph_learn_tpu.nn.layers.ego import EgoLayer as JaxEgoLayer
from graph_learn_tpu.nn.layers.ego import EgoSAGEConv as JaxSAGEConv
from graph_learn_tpu.nn.models import ego_gnn as jego_gnn
from graph_learn_tpu.ops.aggregate import gather_group_agg as jax_group_agg
from graph_learn_tpu_torch.core import schema
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.feature_column import (DYNAMIC_BUCKET,
                                                     FeatureEncoder)
from graph_learn_tpu_torch.nn.layers.ego import EgoLayer, EgoSAGEConv
from graph_learn_tpu_torch.nn.models import ego_gnn
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg
from graph_learn_tpu_torch.ops.kernels import gather
from torch_parity import assert_trees_close

# f32 sums and a Linear in another order
TOL = dict(rtol=1e-6, atol=1e-6)

TYPES = ["float", ("int", 7), "string", ("string", 11),
         ("string", 13, True), "int", ("string", 5, True)]
DIMS = [None, 3, None, 4, 5, None, 2]


def _decoders(types=TYPES, dims=DIMS, max_len=4):
    return (jschema.Decoder(attr_types=types, attr_dims=dims,
                            multival_max_len=max_len),
            schema.Decoder(attr_types=types, attr_dims=dims,
                           multival_max_len=max_len))


def _nodes(dec, shape, seed=0):
    """Random JAX and port Nodes of ``shape`` over ``dec``'s columns: ids
    past the buckets (clipped), a dynamic-bucket string column's hashed
    ids (clipped to the last row), empty multi-value rows."""
    rng = np.random.default_rng(seed)
    nf, ni, nm = dec.float_attr_num, dec.int_attr_num, dec.multival_attr_num
    L = dec.multival_max_len
    fa = rng.standard_normal(shape + (nf,)).astype(np.float32)
    ia = rng.integers(-2, 16, shape + (ni,)).astype(np.int32)
    for col, a in enumerate(dec.int_attrs):
        if a.bucket_size is None and a.type_name == "string":
            ia[..., col] = rng.integers(0, 2 ** 31 - 1, shape)
    mv = rng.integers(-1, 16, shape + (nm, L)).astype(np.int32)
    ml = rng.integers(0, L + 1, shape + (nm,)).astype(np.int32)
    ml.reshape(-1, nm)[:3] = 0  # empty rows
    ids = np.zeros(shape, np.int32)
    j = JNodes(ids=jnp.asarray(ids), float_attrs=jnp.asarray(fa),
               int_attrs=jnp.asarray(ia), multival_attrs=jnp.asarray(mv),
               multival_lens=jnp.asarray(ml))
    t = Nodes(ids=torch.from_numpy(ids), float_attrs=torch.from_numpy(fa),
              int_attrs=torch.from_numpy(ia),
              multival_attrs=torch.from_numpy(mv),
              multival_lens=torch.from_numpy(ml))
    return j, t


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(9,), (4, 3)])
@pytest.mark.parametrize("proj", [None, 6])
def test_encoder_equals_flax(proj, shape):
    jdec, tdec = _decoders()
    jn, tn = _nodes(jdec, shape, seed=len(shape))
    jenc = JaxEncoder(jdec, output_dim=proj)
    params = jenc.init(jax.random.key(0), jn)
    # attribute 5, an "int" without a dim, is a numeric column
    want_names = {"embedding_1", "embedding_2", "embedding_3",
                  "embedding_mv_4", "embedding_mv_6"}
    if proj:
        want_names.add("proj")
    assert set(params["params"]) == want_names
    enc = FeatureEncoder(tdec, output_dim=proj)
    for name, table in enc.embedding_tables():
        assert tuple(table.shape) == params["params"][name].shape, name
    load_flax_params(enc, _np(params))
    assert_trees_close(to_flax_params(enc), _np(params), rtol=0, atol=0)
    got = enc(tn)
    want = np.asarray(jenc.apply(params, jn))
    assert got.shape == want.shape == (
        int(np.prod(shape)), proj or FeatureEncoder.out_dim(tdec))
    assert FeatureEncoder.out_dim(tdec, proj) == \
        JaxEncoder.out_dim(jdec, proj)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_dynamic_bucket_clip_and_empty_rows():
    """A bare "string" column is a 2**20-row table whose hashed ids (below
    2**31 - 1) nearly all clip to the last row; a column without a dim is
    8 wide; an empty multi-value row encodes to zeros."""
    jdec, tdec = _decoders(["string", ("string", 9, True)], [None, None])
    enc = FeatureEncoder(tdec)
    dyn, mv = enc.embedding_0, enc.embedding_mv_1
    assert tuple(dyn.shape) == (DYNAMIC_BUCKET, 8)
    assert tuple(mv.shape) == (9, 8)
    jn, tn = _nodes(jdec, (50,), seed=4)
    out = enc(tn).detach()
    hashed = tn.int_attrs[:, 0]
    last = hashed >= DYNAMIC_BUCKET - 1
    assert last.float().mean() > 0.99
    np.testing.assert_array_equal(out[last, :8].numpy(),
                                  dyn[-1].detach().expand(
                                      int(last.sum()), 8).numpy())
    empty = tn.multival_lens[:, 0] == 0
    assert empty.sum() >= 3
    assert bool((out[empty, 8:] == 0).all())
    params = JaxEncoder(jdec).init(jax.random.key(1), jn)
    load_flax_params(enc, _np(params))
    np.testing.assert_allclose(enc(tn).detach().numpy(),
                               np.asarray(JaxEncoder(jdec).apply(params, jn)),
                               **TOL)


def test_tables_start_uniform_at_the_flax_scale():
    _, tdec = _decoders()
    a = FeatureEncoder(tdec, generator=torch.Generator().manual_seed(3))
    b = FeatureEncoder(tdec, generator=torch.Generator().manual_seed(3))
    for (name, t), (_, u) in zip(a.embedding_tables(), b.embedding_tables()):
        t = t.detach()
        # the bound as the f32 the draw rounds it to
        limit = float(np.float32(math.sqrt(3.0 / t.shape[1])))
        assert float(t.abs().max()) <= limit
        if t.numel() >= 100:  # a table large enough to near its bound
            assert float(t.abs().max()) > 0.9 * limit
        assert torch.equal(t, u), name


def test_a_bf16_table_is_encoded_in_the_compute_dtype():
    _, tdec = _decoders()
    _, tn = _nodes(_decoders()[0], (6,))
    tn = tn.replace(float_attrs=tn.float_attrs.to(torch.bfloat16))
    assert FeatureEncoder(tdec)(tn).dtype == torch.float32


def _ego_pair(mode, b=5, k=3, seed=2):
    """A 1-hop batch whose hop nodes carry categorical columns, as JAX and
    port EgoGraphs; the hop's float rows gathered, deferred or
    pre-aggregated (mean)."""
    jdec, tdec = _decoders(["float", "float", ("int", 6)], [None, None, 3])
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((20, 2)).astype(np.float32)
    cats = rng.integers(0, 6, (20, 1)).astype(np.int32)
    s = rng.integers(0, 20, b).astype(np.int32)
    h = rng.integers(0, 20, (b, k)).astype(np.int32)

    def jn(ids):
        return JNodes(ids=jnp.asarray(ids), float_attrs=jnp.asarray(
            table[ids]), int_attrs=jnp.asarray(cats[ids]))

    def tn(ids):
        return Nodes(ids=torch.from_numpy(ids),
                     float_attrs=torch.from_numpy(table[ids]),
                     int_attrs=torch.from_numpy(cats[ids]))
    jh, th = jn(h), tn(h)
    tt = torch.from_numpy(table)
    if mode == "deferred":
        jh = jh.replace(float_attrs=jdata.DeferredRows(jnp.asarray(table),
                                                       jh.ids))
        th = th.replace(float_attrs=tdata.DeferredRows(tt, th.ids))
    elif mode == "preagg":
        jh = jh.replace(float_attrs=jdata.PreAggregatedRows(
            jax_group_agg(jnp.asarray(table), jh.ids, op="mean"), "mean"))
        th = th.replace(float_attrs=tdata.PreAggregatedRows(
            gather_group_agg(tt, th.ids, op="mean"), "mean"))
    return (jdec, tdec,
            jdata.EgoGraph(src=jn(s), hops=[jh], nbr_nums=(k,)),
            tdata.EgoGraph(src=tn(s), hops=[th], nbr_nums=(k,)))


def _models(jdec, tdec):
    w = FeatureEncoder.out_dim(tdec)
    jm = jego_gnn.EgoGNN(layers=[JaxEgoLayer(convs=[JaxSAGEConv(
        in_dim=(w, w), out_dim=4, agg_type="mean")])],
        hop_encoders=[JaxEncoder(jdec), JaxEncoder(jdec)])
    tm = ego_gnn.EgoGNN([EgoLayer([EgoSAGEConv((w, w), 4,
                                               agg_type="mean")])],
                        hop_encoders=[FeatureEncoder(tdec),
                                      FeatureEncoder(tdec)])
    return jm, tm


def test_embeddings_do_not_commute_so_the_deepest_hop_is_gathered(
        monkeypatch):
    jdec, tdec, jego, tego = _ego_pair("deferred")
    for op in ("mean", "sum", "max"):
        assert not ego_gnn._encoder_commutes(FeatureEncoder(tdec), op)
        assert not jego_gnn._encoder_commutes(JaxEncoder(jdec), op)
    jm, tm = _models(jdec, tdec)
    params = jm.init(jax.random.key(0), jego)
    load_flax_params(tm, _np(params))
    calls = []
    real = gather.gather_rows_plain

    def spy(table, idx):
        calls.append(tuple(idx.shape))
        return real(table, idx)
    monkeypatch.setattr(gather, "gather_rows_plain", spy)
    monkeypatch.setattr(tdata.DeferredRows, "group_agg",
                        lambda *a, **k: pytest.fail("hop reduced"))
    got = tm(tego)
    assert calls == [(15,)]  # the deferred hop's rows, gathered once
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.apply(params, jego)),
                               rtol=1e-5, atol=1e-6)
    _, _, _, gathered = _ego_pair("gathered")
    np.testing.assert_allclose(tm(gathered).detach().numpy(),
                               got.detach().numpy(), **TOL)


def test_preaggregated_rows_under_embeddings_raise_the_jax_message():
    jdec, tdec, jego, tego = _ego_pair("preagg")
    jm, tm = _models(jdec, tdec)
    with pytest.raises(JaxError) as je:
        jm.init(jax.random.key(0), jego)
    with pytest.raises(InvalidArgumentError) as te:
        tm(tego)
    assert str(te.value) == str(je.value)
    assert "encoder commutes=False" in str(te.value)


def test_two_towers_take_the_encoders_widths_and_dense_table_grads():
    """The bipartite towers over a categorical item decoder: each tower's
    input widths are its encoders' (2 floats; 2 floats + a 3-wide
    embedding), and the embedding tables' gradients are dense."""
    from graph_learn_tpu_torch.examples import bipartite_sage as bs
    _, tdec, _, tego = _ego_pair("deferred")
    udec = schema.Decoder(attr_types=["float", "float"])
    model = bs.towers(udec, tdec, 4, "cpu")
    assert model["u"].layers[0].convs[0].in_dim == (2, 5)
    assert model["i"].layers[0].convs[0].in_dim == (5, 5)
    out = model["i"](tego)
    assert out.shape == (5, 4) and bool(torch.isfinite(out).all())
    out.sum().backward()
    g = model["i"].hop_encoders[1].embedding_2.grad
    assert g is not None and g.shape == (6, 3) and g.layout == torch.strided
