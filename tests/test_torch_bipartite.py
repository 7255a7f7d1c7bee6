"""The bipartite u2i path of the port (examples/bipartite_sage.py,
examples/family_scale.py) against the JAX package's: per-hop encoders
(``EgoGNN(hop_encoders=...)``) loaded by ``load_flax_params``, deferred and
gathered tower hops, then the slice as a whole on one in-memory u2i graph
and one batch of ids taken from the JAX plan (so the sampling streams do
not matter): both towers' embeddings, the in-batch softmax loss, one
step's gradients and parameters; then LocalTrainer.train, eval_recall and
family_scale on the CPU."""

import ast
import contextlib
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graph_learn_tpu as gl
from graph_learn_tpu.core.schema import Decoder as JaxDecoder
from graph_learn_tpu.core.store import EdgeTable as JaxEdgeTable
from graph_learn_tpu.core.store import NodeTable as JaxNodeTable
from graph_learn_tpu.core.values import Nodes as JaxNodes
from graph_learn_tpu.graph import Graph as JaxGraph
from graph_learn_tpu.nn import data as jdata
from graph_learn_tpu.nn.feature_column import FeatureEncoder as JaxEncoder
from graph_learn_tpu.nn.layers.ego import EgoLayer as JaxEgoLayer
from graph_learn_tpu.nn.layers.ego import EgoSAGEConv as JaxSAGEConv
from graph_learn_tpu.nn.loss import \
    unsupervised_softmax_cross_entropy_loss as jax_loss
from graph_learn_tpu.nn.models.ego_gnn import EgoGNN as JaxEgoGNN
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.examples import bipartite_sage as bs
from graph_learn_tpu_torch.examples import family_scale as fs
from graph_learn_tpu_torch.gsl import compile as tcompile
from graph_learn_tpu_torch.nn import data as tdata
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.ego import EgoLayer, EgoSAGEConv
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGNN
from graph_learn_tpu_torch.ops import negative, sampling
from torch_parity import assert_trees_close, flax_grad_tree

REPO = Path(__file__).resolve().parents[1]
# f32 throughout, the same products in other orders: embeddings and losses
# within 1e-5 relative; gradients within 1e-5 relative plus 1e-6 absolute
RTOL, GRAD_ATOL = 1e-5, 1e-6


def _jax_example():
    """``build_query`` and ``towers`` of examples/bipartite_sage.py, run as
    written (the module itself loads files and sets the platform when it
    is imported, so only these two functions are taken from it)."""
    path = REPO / "examples" / "bipartite_sage.py"
    tree = ast.parse(path.read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("build_query", "towers")]
    ns = {"EgoGNN": JaxEgoGNN, "EgoLayer": JaxEgoLayer,
          "EgoSAGEConv": JaxSAGEConv, "FeatureEncoder": JaxEncoder}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _jax_egos(batch):
    """The JAX example's ``egos`` (examples/bipartite_sage.py main)."""
    src = jdata.EgoGraph.from_query_result(batch, "src", ["src_h1"])
    dst = jdata.EgoGraph.from_query_result(batch, "dst", ["dst_h1"])
    neg = batch["neg"].flat()
    neg_h1 = jax.tree.map(
        lambda x: x.reshape((-1,) + x.shape[2:]) if hasattr(x, "reshape")
        else x, batch["neg_h1"])
    return src, dst, jdata.EgoGraph(src=neg, hops=[neg_h1],
                                    nbr_nums=(batch["neg_h1"].ids.shape[-1],))


def _jax_graph(a):
    n_u, d = a["u_feat"].shape
    n_i = a["i_feat"].shape[0]
    udec = JaxDecoder(attr_types=["float"] * d)
    idec = JaxDecoder(attr_types=["float"] * d)
    g = JaxGraph()
    g.store.add_node_table(JaxNodeTable("u", udec, np.arange(n_u),
                                        float_attrs=a["u_feat"]))
    g.store.add_node_table(JaxNodeTable("i", idec, np.arange(n_i),
                                        float_attrs=a["i_feat"]))
    for name, s_t, src, dst, n_s in (("u-i", "u", a["ui_src"], a["ui_dst"],
                                      n_u),
                                     ("i-i", "i", a["ii_src"], a["ii_dst"],
                                      n_i)):
        g.store.add_edge_table(JaxEdgeTable(
            name, s_t, "i", JaxDecoder(weighted=True), src=src, dst=dst,
            num_src_nodes=n_s, num_dst_nodes=n_i,
            weights=np.ones(src.size, np.float32)))
    g._node_decoders.update(u=udec, i=idec)
    g._initialized = True
    return g, udec, idec


@pytest.fixture(scope="module")
def u2i():
    return bs.u2i_arrays(n_users=60, n_items=40, feat_dim=8, seed=1)


def _ego_pair(hops_of, b=6, k=4, d=8, seed=0):
    """One 1-hop batch as JAX and port EgoGraphs (src from table "u",
    hop from table "i")."""
    rng = np.random.default_rng(seed)
    tu = rng.standard_normal((30, d)).astype(np.float32)
    ti = rng.standard_normal((25, d)).astype(np.float32)
    s = rng.integers(0, 30, b).astype(np.int32)
    h = rng.integers(0, 25, (b, k)).astype(np.int32)
    j = jdata.EgoGraph(
        src=JaxNodes(ids=jnp.asarray(s), float_attrs=jnp.asarray(tu[s])),
        hops=[JaxNodes(ids=jnp.asarray(h), float_attrs=jnp.asarray(ti[h]))],
        nbr_nums=(k,))
    tt = torch.from_numpy(ti)
    hop = Nodes(ids=torch.from_numpy(h), float_attrs=hops_of(tt, h))
    t = tdata.EgoGraph(src=Nodes(ids=torch.from_numpy(s),
                                 float_attrs=torch.from_numpy(tu[s])),
                       hops=[hop], nbr_nums=(k,))
    return j, t


@pytest.mark.parametrize("proj", [None, 6])
@pytest.mark.parametrize("hop", ["gathered", "deferred"])
def test_hop_encoders_load_from_flax_and_match(proj, hop):
    d = 8
    dec_u = JaxDecoder(attr_types=["float"] * d)
    tdec = bs.Decoder(attr_types=["float"] * d)
    width = proj or d
    jm = JaxEgoGNN(layers=[JaxEgoLayer(convs=[JaxSAGEConv(
        in_dim=(width, width), out_dim=5, agg_type="mean")])],
        hop_encoders=[JaxEncoder(dec_u, output_dim=proj),
                      JaxEncoder(dec_u, output_dim=proj)])
    tm = EgoGNN([EgoLayer([EgoSAGEConv((width, width), 5, agg_type="mean")])],
                hop_encoders=[FeatureEncoder(tdec, output_dim=proj),
                              FeatureEncoder(tdec, output_dim=proj)])
    if hop == "deferred":
        def hops_of(tt, h):
            return tdata.DeferredRows(tt, torch.from_numpy(h))
    else:
        def hops_of(tt, h):
            return tt[torch.from_numpy(h).long()]
    jego, tego = _ego_pair(hops_of)
    params = jm.init(jax.random.key(3), jego)
    if proj:
        assert sorted(params["params"]) == ["hop_encoders_0", "hop_encoders_1",
                                            "layers_0"]
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    want = np.asarray(jm.apply(params, jego))
    got = tm(tego)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-6)
    assert_trees_close(to_flax_params(tm), jax.tree.map(np.asarray, params),
                       rtol=0, atol=0)


def test_deferred_and_gathered_hops_give_the_same_tower():
    """The K-step form defers each tower's hop (Kernel 2's plain version on
    the CPU); LocalTrainer's gathers it: the same output within 1e-5."""
    _, gathered = _ego_pair(lambda tt, h: tt[torch.from_numpy(h).long()])
    _, deferred = _ego_pair(
        lambda tt, h: tdata.DeferredRows(tt, torch.from_numpy(h)))
    dec = bs.Decoder(attr_types=["float"] * 8)
    tower = bs.tower([dec, dec], 8, 16, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tower(deferred).detach().numpy(),
                               tower(gathered).detach().numpy(), rtol=RTOL,
                               atol=1e-6)


def test_encoderless_egognn_is_refused():
    with pytest.raises(InvalidArgumentError, match="encoder"):
        EgoGNN([EgoLayer([EgoSAGEConv(4, 4)])])


def _port_batch_from_jax(tq, jb, monkeypatch):
    """The port's plan on JAX's seed edges, its samplers answering JAX's
    ids in DAG order."""
    hops = [np.asarray(jb[a].ids) for a in ("src_h1", "dst_h1", "neg_h1")]
    hops = [h.reshape(-1, h.shape[-1]) for h in hops]
    calls = iter(hops)

    def sampler(csr, seeds, k, generator, flt=None):
        ids = torch.from_numpy(next(calls))
        assert ids.shape == (seeds.shape[0], k)
        return ids, torch.zeros_like(ids)

    monkeypatch.setitem(sampling.STRATEGY_FNS, "random", sampler)
    monkeypatch.setattr(negative, "negative_sample",
                        lambda et, seeds, k, g_, **kw: torch.from_numpy(
                            np.asarray(jb["neg"].ids)))
    seeds = torch.from_numpy(np.asarray(jb["seed"].edge_ids))
    return tcompile._execute(tq, tq.device_tables("cpu"), seeds,
                             torch.Generator())


def test_the_slice_matches_jax_towers_loss_and_one_step(u2i, monkeypatch):
    ex = _jax_example()
    jg, judec, jidec = _jax_graph(u2i)
    tg, tudec, tidec = bs.build_graph(u2i, "cpu")
    d, out_dim, nbrs = 8, 12, [4]
    jq = ex["build_query"](jg, 16, nbrs)
    tq = bs.build_query(tg, 16, nbrs)
    jb = gl.Dataset(jq, window=1).next()
    tb = _port_batch_from_jax(tq, jb, monkeypatch)
    for a in ("src", "dst", "neg", "src_h1", "dst_h1", "neg_h1"):
        np.testing.assert_array_equal(tb[a].ids.numpy(),
                                      np.asarray(jb[a].ids), a)
    np.testing.assert_array_equal(tb["seed"].edge_ids.numpy(),
                                  np.asarray(jb["seed"].edge_ids))

    u_tower, i_tower = ex["towers"](judec, jidec, d, 32, out_dim)
    s0, d0, n0 = _jax_egos(jb)
    params = {"u": u_tower.init(jax.random.key(0), s0),
              "i": i_tower.init(jax.random.key(1), d0)}
    model = bs.towers(tudec, tidec, out_dim, "cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))

    def jax_embs(p):
        return (u_tower.apply(p["u"], s0), i_tower.apply(p["i"], d0),
                i_tower.apply(p["i"], n0))

    def jax_lf(p):
        return jax_loss(*jax_embs(p))

    src, dst, neg = bs.egos(tb)
    embs = (model["u"](src), model["i"](dst), model["i"](neg))
    for got, want, what in zip(embs, jax_embs(params), ("u", "i", "neg")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-5, err_msg=what)
    loss = bs.loss_fn(model, tb, None, True)
    jloss, jgrads = jax.value_and_grad(jax_lf)(params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    # the deferred form of the same batch: the same loss
    np.testing.assert_allclose(
        bs.tower_loss(model, tb, tg.store.node_table("i").device("cpu")
                      .float_attrs).item(), float(jloss), rtol=RTOL)

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    opt.zero_grad()
    loss.backward()
    for k in ("u", "i"):
        assert_trees_close(flax_grad_tree(model[k]),
                           jax.tree.map(np.asarray, jgrads[k]), rtol=RTOL,
                           atol=GRAD_ATOL)
    opt.step()
    tx = optax.adam(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    # one Adam step of 1e-3 within 2e-5 (tests/test_torch_bench.py)
    assert_trees_close(to_flax_params(model), jax.tree.map(np.asarray, new),
                       rtol=1e-4, atol=2e-5)


def test_local_trainer_trains_two_epochs_then_recall(u2i):
    g, udec, idec = bs.build_graph(u2i, "cpu")
    model = bs.towers(udec, idec, 16, "cpu")
    q = bs.build_query(g, 16, [4])
    opt = torch.optim.Adam(model.parameters(), lr=0.005)
    _, hist = bs.LocalTrainer(device="cpu").train(
        q, model, bs.loss_fn, opt, epochs=2, verbose=False)
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert hist[1] < hist[0], hist
    recall = bs.eval_recall(g, model, [4], k=20, device="cpu")
    assert 0.0 <= recall <= 1.0


def test_the_example_runs_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recall = bs.main(["--cpu", "--data_dir", str(tmp_path), "--epochs",
                          "1", "--steps_per_epoch",
                          "3"])
    assert re.search(r"^recall@20: [01]\.\d{4}$", out.getvalue(), re.M)
    assert 0.0 <= recall <= 1.0


def test_family_scale_small_runs_eagerly_and_prints_its_line():
    """The default families, rgcn, bipartite and temporal, one line each,
    in that order (walks runs when asked for: tests/test_torch_walk.py); a
    family the script does not know is refused."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fs.main(["--small", "--cpu"]) == 0
    assert re.fullmatch("".join(
        r"%s +[0-9.]+M edges/s  [0-9.]+ ms/step  \(warm [0-9.]+s\)\n" % fam
        for fam in ("rgcn", "bipartite", "temporal")), out.getvalue())
    with pytest.raises(InvalidArgumentError, match="unknown family"):
        fs.main(["--small", "--cpu", "--families", "gat"])


def test_family_scale_store_draws_the_jax_numbers():
    """``build_graph`` at a small cfg: the arrays of run_bipartite's
    numpy draws (np.random.default_rng(1), the same order)."""
    cfg = dict(n_nodes=400, avg_degree=5, feat_dim=6)
    g, _, _ = fs.build_graph(cfg, "cpu")
    rng = np.random.default_rng(1)
    fu = rng.standard_normal((200, 6), np.float32)
    fi = rng.standard_normal((200, 6), np.float32)
    src, dst = rng.integers(0, 200, 1340), rng.integers(0, 200, 1340)
    w = rng.random(1340).astype(np.float32)
    np.testing.assert_array_equal(g.store.node_table("u").float_attrs, fu)
    np.testing.assert_array_equal(g.store.node_table("i").float_attrs, fi)
    et = g.store.edge_table("u-i")
    np.testing.assert_array_equal(et.src, src)
    np.testing.assert_array_equal(et.dst, dst)
    np.testing.assert_array_equal(et.weights, w)
    assert g.store.edge_table("i-i").num_edges == 2000 - 1340


def test_k_steps_a_call_are_finite_and_count_their_edges():
    cfg = dict(fs.bench.CFG_SMALL, n_nodes=600, avg_degree=4, feat_dim=8,
               hidden=16, batch=32, steps=4, scan_steps=2)
    r = fs.run_bipartite(cfg, small=True, device="cpu")
    assert r["capture"] is False and r["capture_s"] is None
    assert r["edges_per_step"] == 32 * (2 * 4 + 2 * (1 + 4))
    assert len(r["losses"]) == (1 + r["rounds"]) * 2
    assert np.isfinite(r["losses"]).all()
    assert r["csr_build_s"] > 0 and r["tables_bytes"] > 0
    step = r["step"]
    assert all(s.dtype == torch.int32 and int(s.max()) < 1608
               for s in step.seeds)
