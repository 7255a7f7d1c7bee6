"""EgoTGAT, its time encoder and scorer, and the ego_tgat example against the
JAX package's.

The flax ``EgoTGAT`` passes ``in_dim=(1, 2)`` to its first level's conv to
mark it hetero, and ``EgoGATConv`` reads ``in_dim[1]`` as the key width
(``graph_learn_tpu/nn/layers/ego.py:128``), so the JAX model runs only
where the keys are 2 wide.  These tests run it with that conv given the
true widths, ``(feat + time, feat + edge + time)``, which is what the port
computes (the ``true_widths`` fixture); nothing in the JAX package is
changed.

Tolerances: forwards within 1e-5 relative (f32 sums in other orders); one
Adam step of 1e-3 within 2e-5 (tests/test_torch_bench.py's).
"""

import ast
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import graph_learn_tpu as gl
from graph_learn_tpu.core.values import Edges as JEdges
from graph_learn_tpu.core.values import Nodes as JNodes
from graph_learn_tpu.gsl.compile import _execute as jax_execute
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.feature_column import FeatureEncoder as JEnc
from graph_learn_tpu.nn.layers import ego as jego
from graph_learn_tpu.nn.loss import sigmoid_cross_entropy_loss as jax_sig_loss
from graph_learn_tpu.nn.models import tgat as jtgat
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.values import Edges, Nodes
from graph_learn_tpu_torch.examples import ego_tgat as et
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers import ego as tego
from graph_learn_tpu_torch.nn.models.tgat import (EgoTGAT, LinkScorePredict,
                                                  TimeEncoder)
from graph_learn_tpu_torch.ops import negative
from graph_learn_tpu_torch.ops.kernels import gat, gather
from torch_parity import assert_trees_close

REPO = Path(__file__).resolve().parents[1]
FWD = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def true_widths(monkeypatch):
    """Run the flax EgoTGAT with its level-0 conv given the true widths
    (feat + time, feat + edge + time), set by the test through
    ``widths["q"]`` / ``widths["k"]``."""
    widths = {}

    def conv(in_dim, **kw):
        if in_dim == (1, 2):
            in_dim = (widths["q"], widths["k"])
        return jego.EgoGATConv(in_dim=in_dim, **kw)

    monkeypatch.setattr(jtgat, "EgoGATConv", conv)
    return widths


def _tg_arrays(b, nbrs, d, e_dim, seed):
    """Numpy inputs of a TemporalGraph: node features per hop position,
    edge features and spans per hop."""
    rng = np.random.default_rng(seed)
    shapes = [(b,)]
    for k in nbrs:
        shapes.append(shapes[-1] + (k,))
    return {
        "feats": [rng.standard_normal(s + (d,)).astype(np.float32)
                  for s in shapes],
        "efeats": [rng.standard_normal(s + (e_dim,)).astype(np.float32)
                   if e_dim else None for s in shapes[1:]],
        "spans": [rng.uniform(0, 500, s).astype(np.float32)
                  for s in shapes[1:]],
    }


def _tgs(arr):
    """The same TemporalGraph in both packages."""
    def nodes(mod, f):
        ids = np.zeros(f.shape[:-1], np.int32)
        if mod == "jax":
            return JNodes(ids=jnp.asarray(ids), float_attrs=jnp.asarray(f))
        return Nodes(ids=torch.from_numpy(ids),
                     float_attrs=torch.from_numpy(f))

    out = []
    for mod in ("jax", "torch"):
        src = nodes(mod, arr["feats"][0])
        nn_ = [nodes(mod, f) for f in arr["feats"][1:]]
        es = []
        for n_, ef in zip(nn_, arr["efeats"]):
            if mod == "jax":
                es.append(JEdges(edge_ids=n_.ids, src_nodes=n_,
                                 dst_nodes=n_,
                                 float_attrs=None if ef is None
                                 else jnp.asarray(ef)))
            else:
                es.append(Edges(edge_ids=n_.ids, src_nodes=n_, dst_nodes=n_,
                                float_attrs=None if ef is None
                                else torch.from_numpy(ef)))
        b = arr["feats"][0].shape[0]
        nums = tuple(f.shape[-2] for f in arr["feats"][1:])
        if mod == "jax":
            out.append(jdata.TemporalGraph(
                src=src, src_t=jnp.zeros(b, jnp.float32), nbr_nodes=nn_,
                nbr_t=[jnp.asarray(s) for s in arr["spans"]], nbr_edges=es,
                nbr_nums=nums))
        else:
            out.append(tdata.TemporalGraph(
                src=src, src_t=torch.zeros(b), nbr_nodes=nn_,
                nbr_t=[torch.from_numpy(s) for s in arr["spans"]],
                nbr_edges=es, nbr_nums=nums))
    return out


def test_the_time_encoder_equals_flax():
    t = np.random.default_rng(0).uniform(0, 1e4, (3, 4)).astype(np.float32)
    jte = jtgat.TimeEncoder(time_dim=6)
    p = jte.init(jax.random.key(0), jnp.asarray(t))
    te = TimeEncoder(6)
    te.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(te.basis_freq.detach().numpy(),
                                  np.asarray(p["params"]["basis_freq"]))
    assert 0 <= te.phase.min() and te.phase.max() < 1
    load_flax_params(te, _np(p))
    got = te(torch.from_numpy(t))
    assert got.shape == (12, 6)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jte.apply(p, jnp.asarray(t))),
                               **FWD)


@pytest.mark.parametrize("nbrs,heads,e_dim", [((4, 3), 2, 3),
                                              ((5,), 1, 2),
                                              ((3, 2), 1, 1)])
def test_ego_tgat_forward_equals_flax(nbrs, heads, e_dim, true_widths):
    d, T, hidden, out = 5, 4, 6, 3
    jdec, tdec = (gl.Decoder(attr_types=["float"] * d),
                  Decoder(attr_types=["float"] * d))
    true_widths.update(q=d + T, k=d + e_dim + T)
    jtg, ttg = _tgs(_tg_arrays(7, nbrs, d, e_dim, seed=len(nbrs)))
    K = len(nbrs)
    jm = jtgat.EgoTGAT(hidden_dim=hidden, out_dim=out, time_dim=T,
                       num_hops=K, encoders=[JEnc(jdec)] * (K + 1),
                       num_head=heads)
    p = jm.init(jax.random.key(1), jtg)
    tm = EgoTGAT(hidden, out, T, K, [FeatureEncoder(tdec)] * (K + 1),
                 edge_dim=e_dim, num_head=heads, device="cpu")
    assert not tm.convs[0].is_homo and all(c.is_homo for c in tm.convs[1:])
    load_flax_params(tm, _np(p))
    assert_trees_close(to_flax_params(tm), _np(p), rtol=0, atol=0)
    got = tm(ttg)
    assert got.shape == (7, out)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.apply(p, jtg)), **FWD)


def test_level_0_keeps_its_neighbour_projections_at_equal_widths():
    """Without edge features the level-0 query and key widths are equal;
    the flax model still marks that level hetero (``in_dim=(1, 2)``), so
    the port keeps ``n_<h>`` there."""
    dec = Decoder(attr_types=["float"] * 5)
    tm = EgoTGAT(6, 3, 4, 2, [FeatureEncoder(dec)] * 3, edge_dim=0,
                 num_head=2, device="cpu")
    c0 = tm.convs[0]
    assert c0.in_dim == (9, 9) and not c0.is_homo and hasattr(c0, "n_1")
    _, ttg = _tgs(_tg_arrays(4, (3, 2), 5, 0, seed=1))
    assert tm(ttg).shape == (4, 3)


def test_the_scorer_equals_flax():
    rng = np.random.default_rng(2)
    x = [rng.standard_normal((9, 4)).astype(np.float32) for _ in range(3)]
    jm = jtgat.LinkScorePredict(4)
    p = jm.init(jax.random.key(0), *map(jnp.asarray, x))
    tm = LinkScorePredict(4, device="cpu")
    load_flax_params(tm, _np(p))
    for got, want in zip(tm(*map(torch.from_numpy, x)),
                         jm.apply(p, *map(jnp.asarray, x))):
        assert got.shape == (9,)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)


def _jax_example():
    """``load``, ``build_query``, ``tower`` and ``TGATLink`` of
    examples/ego_tgat.py, run as written (the module itself sets the
    platform when it is imported)."""
    import os
    path = REPO / "examples" / "ego_tgat.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in ("load", "build_query", "tower", "TGATLink")]
    spec = importlib.util.spec_from_file_location(
        "tgat_synthetic", REPO / "examples" / "data" / "synthetic.py")
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)
    ns = {"gl": gl, "os": os, "nn": fnn, "temporal_u2i":
          synthetic.temporal_u2i, "TemporalGraph": jdata.TemporalGraph,
          "FeatureEncoder": JEnc, "EgoTGAT": jtgat.EgoTGAT,
          "LinkScorePredict": jtgat.LinkScorePredict}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


SMALL = dict(events=400, n_users=40, n_items=30)
NBRS = [8, 4]


@pytest.fixture
def example_graphs(tmp_path):
    """The JAX example's graph, loaded from the TSVs its generator writes,
    and the port's, built in memory from the same draws."""
    ex = _jax_example()
    synthetic = ex["temporal_u2i"]
    kw = dict(SMALL, feat_dim=8, edge_feat_dim=4)
    synthetic(str(tmp_path), **kw)
    jg, udec, idec, edec = ex["load"](str(tmp_path), 8, 4)
    graph = et.build_graph(et.temporal_u2i(**kw), "cpu")
    return ex, (jg, udec, idec), graph


def test_the_store_holds_the_jax_example_data(example_graphs):
    """Ids, timestamps and the time base equal; features as the TSVs hold
    them, to five decimals."""
    _, (jg, _, _), (tg, udec, idec, edec) = example_graphs
    assert edec.timestamped and udec.float_attr_num == 8
    for t in ("u", "i"):
        np.testing.assert_allclose(tg.store.node_table(t).float_attrs,
                                   jg.store.node_table(t).float_attrs,
                                   atol=5.1e-6, rtol=0)
    for t in ("interaction", "interaction_reverse", "train", "test"):
        je, te = jg.store.edge_table(t), tg.store.edge_table(t)
        assert (te.src_type, te.dst_type) == (je.src_type, je.dst_type)
        for f in ("src", "dst", "timestamps"):
            np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
        assert te.ts_base == je.ts_base and te.ts_scale == je.ts_scale
        np.testing.assert_allclose(te.float_attrs, je.float_attrs,
                                   atol=5.1e-6, rtol=0)


def test_the_towers_answer_the_jax_example_query(example_graphs,
                                                 monkeypatch):
    """The example's query on one batch of events: the src and dst towers
    (recency topk, deterministic) equal the JAX plan's; the negative tower
    too once the port is given JAX's negative ids."""
    ex, (jg, _, _), (tg, _, _, _) = example_graphs
    jq = ex["build_query"](jg, 16, NBRS, "train")
    tq = et.build_query(tg, 16, NBRS, "train")
    seeds = np.arange(16, dtype=np.int32) + 100
    jb = jax_execute(jq, jq.device_tables(), jnp.asarray(seeds),
                     jax.random.key(0))
    monkeypatch.setattr(negative, "negative_sample",
                        lambda *a, **kw: torch.from_numpy(
                            np.array(jb["neg"].ids).reshape(-1, 1)))
    tb = tcompile._execute(tq, tq.device_tables("cpu"),
                           torch.from_numpy(seeds), torch.Generator())
    for name in et.TOWERS:
        for i in (1, 2):
            for a, fields in (("%s_nbr_%d" % (name, i),
                               ("edge_ids", "timestamps")),
                              ("%s_nbr_node_%d" % (name, i), ("ids",))):
                for f in fields:
                    np.testing.assert_array_equal(
                        getattr(tb[a], f).numpy(),
                        np.asarray(getattr(jb[a], f)), "%s.%s" % (a, f))
        jtg, ttg = ex["tower"](jb, name, 2), et.tower(tb, name, 2)
        for got, want in zip(ttg.nbr_t, jtg.nbr_t):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # hops strictly before the event
    ev = tb["event"].timestamps.numpy()
    e1 = tb["src_nbr_1"]
    m = e1.edge_ids.numpy() >= 0
    assert m.any() and np.all(e1.timestamps.numpy()[m]
                              < np.broadcast_to(ev[:, None], m.shape)[m])


def test_tgat_link_forward_and_one_adam_step_equal_flax_and_optax(
        true_widths):
    d, e_dim, T, hidden, out, b = 8, 4, 8, 32, 16, 6
    true_widths.update(q=d + T, k=d + e_dim + T)
    ex = _jax_example()
    jdec = gl.Decoder(attr_types=["float"] * d)
    tdec = Decoder(attr_types=["float"] * d)
    towers = [_tgs(_tg_arrays(b, NBRS, d, e_dim, seed=s)) for s in (3, 4, 5)]
    jtgs, ttgs = [t[0] for t in towers], [t[1] for t in towers]
    jm = ex["TGATLink"](udec=jdec, idec=jdec, hidden=hidden, out_dim=out,
                        time_dim=T, nhops=2)
    p = jm.init(jax.random.key(0), *jtgs, training=False)
    tm = et.TGATLink(tdec, tdec, hidden, out, T, 2, e_dim, device="cpu")
    load_flax_params(tm, _np(p))
    assert_trees_close(to_flax_params(tm), _np(p), rtol=0, atol=0)

    def lf(pp):
        pos, neg = jm.apply(pp, *jtgs, training=True)
        return jax_sig_loss(pos, neg)

    jloss, jgrads = jax.value_and_grad(lf)(p)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(jgrads, tx.init(p), p)
    new = optax.apply_updates(p, upd)

    from graph_learn_tpu_torch.nn.loss import sigmoid_cross_entropy_loss
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    loss = sigmoid_cross_entropy_loss(*tm(*ttgs, training=True))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-6)
    loss.backward()
    opt.step()
    assert_trees_close(to_flax_params(tm), _np(new), rtol=1e-4, atol=2e-5)


def test_a_step_puts_every_conv_on_the_gat_block_at_the_design_shapes(
        monkeypatch):
    """One ego_tgat step: 9 ``gat_block`` calls (three towers, three convs
    each) at (b, e, Din, H, W) = (b, 8, 20, 2, 32), (8 b, 4, 20, 2, 32) and
    (b, 8, 40, 2, 16), each differentiated, and 15 row gathers (src, two
    node hops and two edge hops per tower)."""
    shapes, gathers = [], []
    plain = gat.gat_block
    plain_gather = gather.gather_rows_plain

    def spy(nbr, wn, *rest):
        shapes.append(tuple(nbr.shape) + (wn.shape[0], wn.shape[2]))
        return plain(nbr, wn, *rest)

    def spy_gather(*args):
        gathers.append(args[1].shape)
        return plain_gather(*args)

    monkeypatch.setattr(tego, "gat_block", spy)
    monkeypatch.setattr(gather, "gather_rows_plain", spy_gather)
    g, udec, idec, _ = et.build_graph(et.temporal_u2i(**SMALL), "cpu")
    q = et.build_query(g, 16, NBRS)
    b = tcompile._execute(q, q.device_tables("cpu"),
                          torch.arange(16, dtype=torch.int32),
                          torch.Generator().manual_seed(0))
    model = et.TGATLink(udec, idec, 32, 16, 8, 2, 4, device="cpu")
    loss = et.tgat_loss(model, b, 2)
    loss.backward()
    one = [(16, 8, 20, 2, 32), (128, 4, 20, 2, 32), (16, 8, 40, 2, 16)]
    assert shapes == one * 3
    assert len(gathers) == 15
    assert all(p.grad is not None for p in model.parameters())


def test_the_example_trains_and_prints_a_test_accuracy():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc = et.main(["--cpu", "--events", "600", "--epochs", "2",
                       "--batch_size", "32", "--hidden", "16"])
    text = out.getvalue()
    assert re.search(r"^test link-pred acc: [01]\.\d{4}$", text, re.M)
    losses = [float(x) for x in re.findall(r"^epoch \d loss ([0-9.]+)",
                                           text, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert 0.0 <= acc <= 1.0
