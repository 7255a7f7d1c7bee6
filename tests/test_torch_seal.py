"""The port's SEAL and edge-star GraphSAGE examples
(graph_learn_tpu_torch/examples/{seal,sage_unsupervised}.py) against
examples/seal.py and examples/sage_unsupervised.py: the planted-community
link set draw for draw; one SEAL step on JAX's own neighbour and negative
draws (the induced graphs exactly; the loss, every gradient and one Adam
step within 1e-5); the two behaviours of the JAX example that the port
copies, and the input width it states; one edge-star SAGE step; both
examples run eagerly, with their Kernel 1 calls counted."""

import ast
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.core.schema import Decoder as JDecoder
from graph_learn_tpu.core.store import EdgeTable as JEdgeTable
from graph_learn_tpu.core.store import NodeTable as JNodeTable
from graph_learn_tpu.graph import Graph as JGraph
from graph_learn_tpu.nn.feature_column import FeatureEncoder as JEncoder
from graph_learn_tpu.nn.loss import sigmoid_cross_entropy_loss as jax_bce
from graph_learn_tpu.nn.models.sub_models import GCN as JGCN
from graph_learn_tpu.nn.models.sub_models import GraphSAGE as JGraphSAGE
from graph_learn_tpu.nn.models.sub_models import LinkPredictor as JLinkPred
from graph_learn_tpu.nn.subgraph_data import BatchGraph as JBatchGraph
from graph_learn_tpu.ops.negative import negative_sample as jax_negatives
from graph_learn_tpu.ops.sampling import uniform_sample
from graph_learn_tpu.ops.subgraph import induce_batched
from graph_learn_tpu_torch import bench as tbench
from graph_learn_tpu_torch.examples import node2vec as n2v
from graph_learn_tpu_torch.examples import sage_unsupervised as sage
from graph_learn_tpu_torch.examples import seal
from graph_learn_tpu_torch.nn.convert import load_flax_params, to_flax_params
from graph_learn_tpu_torch.nn.models.sub_models import GCN
from graph_learn_tpu_torch.ops import negative as neg_ops
from graph_learn_tpu_torch.ops.kernels import dispatch
from torch_parity import assert_trees_close, grad_tree

REPO = Path(__file__).resolve().parents[1]
# f32 throughout, the same sums in other orders: the loss within 1e-5
# relative; gradients and the parameters after one Adam step within 1e-4
# relative plus 1e-5 absolute
RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-5
B, HIDDEN, LR = 16, 8, 0.01


def _jax_example(name, keep):
    """The named functions and classes of ``examples/<name>.py``, run as
    written (the module itself sets the platform when it is imported)."""
    path = REPO / "examples" / (name + ".py")
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in keep]
    ns = {"jax": jax, "jnp": jnp, "np": np, "nn": fnn, "gl": gl,
          "uniform_sample": uniform_sample, "induce_batched": induce_batched,
          "BatchGraph": JBatchGraph, "FeatureEncoder": JEncoder,
          "GraphSAGE": JGraphSAGE}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _write_collab_tables():
    spec = importlib.util.spec_from_file_location(
        "ogbl_collab", REPO / "examples" / "data" / "ogbl_collab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_collab_tables


def test_planted_collab_is_the_jax_tests_set_draw_for_draw():
    """``tests/test_real_datasets.py:284-305``, as written there."""
    rng = np.random.default_rng(3)
    n = 400
    comm = rng.integers(0, 8, n)
    pos = []
    while len(pos) < 1600:
        a, b = rng.integers(0, n, 2)
        if a != b and comm[a] == comm[b]:
            pos.append((a, b))
    pos = np.array(pos)

    def negs(k):
        out = []
        while len(out) < k:
            a, b = rng.integers(0, n, 2)
            if a != b and comm[a] != comm[b]:
                out.append((a, b))
        return np.array(out)

    feats = (np.eye(8)[comm]
             + 0.5 * rng.standard_normal((n, 8))).astype(np.float32)
    feats = np.concatenate(
        [feats, 0.01 * rng.standard_normal((n, 120)).astype(np.float32)], 1)
    want = {"comm": comm, "train": pos[:1200], "valid": pos[1200:1400],
            "test": pos[1400:1600], "feats": feats, "valid_neg": negs(200),
            "test_neg": negs(200)}
    got = seal.planted_collab()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
        assert got[k].dtype == want[k].dtype, k


@pytest.fixture(scope="module")
def seal_stores(tmp_path_factory):
    """A small planted set in both packages: the JAX store loaded from the
    tables its writer makes, as the JAX example's --collab_dir path loads
    them; the port's built in memory."""
    a = seal.planted_collab(n=120, n_train=300, n_valid=0, n_test=40,
                            n_neg=40)
    d = tmp_path_factory.mktemp("collab")
    empty = np.zeros((0, 2), np.int64)
    _write_collab_tables()(str(d), a["train"], np.ones(len(a["train"])),
                           empty, empty, a["test"], a["test_neg"],
                           a["feats"])
    jg = (gl.Graph()
          .node(str(d / "ogbl_collab_node"), "item",
                gl.Decoder(attr_types=["float"] * 128))
          .edge(str(d / "ogbl_collab_train_edge"),
                ("item", "item", "relation"), gl.Decoder(weighted=True),
                directed=False)).init()
    tg = seal.build_graph(a["feats"], a["train"][:, 0], a["train"][:, 1],
                          "cpu")
    return a, jg, tg


def _jax_seal(jg):
    ex = _jax_example("seal", ("build_pair_subgraphs",))
    dev = jg.store.edge_table("relation").device()
    feats = jnp.asarray(jg.store.node_table("item").float_attrs)
    return ex["build_pair_subgraphs"], dev, feats


def _draws(key, b, nbrs=seal.NBRS):
    """The uniform numbers the JAX example's ``uniform_sample`` calls draw
    inside ``build_pair_subgraphs`` with ``key``."""
    k1, k2 = jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.uniform(k, (b, nbrs))))
            for k in (k1, k2)]


def _same_graph(t, j):
    for f in ("edge_index", "node_ids", "node_mask", "edge_mask",
              "graph_ids", "dist_to_src", "dist_to_dst"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    assert (t.num_samples, t.node_cap) == (j.num_samples, j.node_cap)


def test_the_store_holds_the_jax_collab_tables(seal_stores):
    _, jg, tg = seal_stores
    jt, tt = jg.store.edge_table("relation"), tg.store.edge_table("relation")
    for f in ("src", "dst", "weights"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    np.testing.assert_array_equal(tg.store.node_table("item").float_attrs,
                                  jg.store.node_table("item").float_attrs)


def test_one_seal_step_equals_the_jax_example(seal_stores):
    _, jg, tg = seal_stores
    build, jdev, jfeats = _jax_seal(jg)
    tdev = tg.store.edge_table("relation").device("cpu")
    tfeats = tg.store.node_table("item").device("cpu").float_attrs

    # the example's init: its first batch at key(0), GCN at key(1), the
    # scorer at key(2)
    model, scorer = JGCN([HIDDEN, HIDDEN]), JLinkPred(hidden_dim=HIDDEN)
    bg0, x0 = build(jdev, jfeats, jdev.src[:B], jdev.dst[:B],
                    jax.random.key(0))
    params = {"gcn": model.init(jax.random.key(1), bg0.edge_index, x0,
                                edge_mask=bg0.edge_mask)}
    r0 = bg0.readout(model.apply(params["gcn"], bg0.edge_index, x0,
                                 edge_mask=bg0.edge_mask))
    params["mlp"] = scorer.init(jax.random.key(2), r0, r0)
    tmodel = seal.seal_model(128, HIDDEN, device="cpu")
    load_flax_params(tmodel, params)

    # the step at one key, as examples/seal.py:110-131 writes it
    eidx = jnp.asarray(np.random.default_rng(0).integers(0, jdev.src.shape[0],
                                                         B), jnp.int32)
    _, kneg, ksg1, ksg2 = jax.random.split(jax.random.key(7), 4)
    src, dst = jdev.src[eidx], jdev.dst[eidx]
    neg_dst = jax_negatives(jdev, src, 1, kneg, "random")[:, 0]

    def lf(p):
        def score(s, d, k):
            bg, x = build(jdev, jfeats, s, d, k)
            h = model.apply(p["gcn"], bg.edge_index, x,
                            edge_mask=bg.edge_mask)
            r = bg.readout(h)
            return scorer.apply(p["mlp"], r, r)
        pl, nl = score(src, dst, ksg1), score(src, neg_dst, ksg2)
        return (optax.sigmoid_binary_cross_entropy(
                    pl, jnp.ones_like(pl)).mean()
                + optax.sigmoid_binary_cross_entropy(
                    nl, jnp.zeros_like(nl)).mean())

    jloss, jgrads = jax.value_and_grad(lf)(params)
    opt = optax.adam(LR)
    upd, _ = opt.update(jgrads, opt.init(params), params)
    jnew = optax.apply_updates(params, upd)

    # the same step in the port, on JAX's draws
    t = [torch.from_numpy(np.asarray(v)) for v in (src, dst, neg_dst)]
    draws = _draws(ksg1, B) + _draws(ksg2, B)
    for (s, d, k, u) in ((src, dst, ksg1, draws[:2]),
                         (src, neg_dst, ksg2, draws[2:])):
        jbg, jx = build(jdev, jfeats, s, d, k)
        tbg, tx = seal.pair_graph(tdev, tfeats,
                                  torch.from_numpy(np.asarray(s)),
                                  torch.from_numpy(np.asarray(d)), *u)
        _same_graph(tbg, jbg)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    loss, _, _ = seal.pairs_loss(tmodel, tdev, tfeats, *t, draws)
    topt = tbench.make_optimizer(tmodel, torch.device("cpu"), LR)
    topt.zero_grad()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert_trees_close(grad_tree(tmodel), jgrads, rtol=G_RTOL, atol=G_ATOL)
    topt.step()
    assert_trees_close(to_flax_params(tmodel), jnew, rtol=G_RTOL,
                       atol=G_ATOL)


def test_bfs_roots_are_the_two_smallest_ids_not_the_pair(seal_stores):
    """Copied from the JAX example: the labels' distances are from local
    nodes 0 and 1, each sample's two smallest ids, whatever its pair."""
    _, jg, tg = seal_stores
    build, jdev, jfeats = _jax_seal(jg)
    tdev = tg.store.edge_table("relation").device("cpu")
    tfeats = tg.store.node_table("item").device("cpu").float_attrs
    key = jax.random.key(3)
    jbg, _ = build(jdev, jfeats, jdev.src[:B], jdev.dst[:B], key)
    tbg, _ = seal.pair_graph(tdev, tfeats,
                             torch.from_numpy(np.asarray(jdev.src[:B])),
                             torch.from_numpy(np.asarray(jdev.dst[:B])),
                             *_draws(key, B))
    _same_graph(tbg, jbg)
    S = tbg.node_cap
    ids = tbg.node_ids.reshape(B, S)
    d2s = tbg.dist_to_src.reshape(B, S)
    assert bool((d2s[:, 0] == 0).all())
    src = torch.from_numpy(np.asarray(jdev.src[:B]))
    at_src = d2s[ids == src[:, None]]
    # in samples whose src is not the smallest id, the src is not a root
    not_smallest = src > ids[:, 0]
    assert bool(not_smallest.any())
    assert bool((d2s.gather(1, (ids == src[:, None]).int().argmax(1,
                 keepdim=True))[not_smallest] > 0).any())
    assert at_src.numel() >= B


def test_the_scorer_scores_the_readout_against_itself(seal_stores):
    _, _, tg = seal_stores
    tdev = tg.store.edge_table("relation").device("cpu")
    tfeats = tg.store.node_table("item").device("cpu").float_attrs
    model = seal.seal_model(128, HIDDEN, device="cpu")
    gen = torch.Generator().manual_seed(0)
    bg, x = seal.build_pair_subgraphs(tdev, tfeats, tdev.src[:B],
                                      tdev.dst[:B], gen)
    r = bg.readout(model["gcn"](bg.edge_index, x, edge_mask=bg.edge_mask))
    got = seal.score_graph(model, bg, x)
    assert torch.equal(got, model["mlp"](r, r))
    assert not torch.allclose(got, model["mlp"](
        r, torch.zeros_like(r)))


def test_the_gcn_states_the_input_width_flax_infers(seal_stores):
    """The JAX example's GCN([hidden, hidden]) reads the 128 + 2 + 2 wide
    labelled features (flax infers the width); the port states it."""
    _, jg, _ = seal_stores
    build, jdev, jfeats = _jax_seal(jg)
    bg, x = build(jdev, jfeats, jdev.src[:B], jdev.dst[:B],
                  jax.random.key(0))
    p = JGCN([HIDDEN, HIDDEN]).init(jax.random.key(1), bg.edge_index, x,
                                    edge_mask=bg.edge_mask)
    kernel = p["params"]["convs_0"]["weights"]["kernel"]
    assert kernel.shape == (128 + seal.STEPS + 2, HIDDEN) == (132, HIDDEN)
    conv = seal.seal_model(128, HIDDEN, device="cpu")["gcn"].convs[0]
    assert (conv.weights.in_features, conv.weights.out_features) == (132,
                                                                     HIDDEN)
    # the JAX example's own dims do not fit the features in torch
    with pytest.raises(RuntimeError):
        GCN([HIDDEN, HIDDEN], device="cpu")(
            torch.from_numpy(np.asarray(bg.edge_index)),
            torch.from_numpy(np.asarray(x)))


def _count_gathers(monkeypatch):
    calls = []
    real = dispatch.gather_rows

    def counted(table, idx):
        calls.append(idx.numel())
        return real(table, idx)
    monkeypatch.setattr(dispatch, "gather_rows", counted)
    return calls


def test_seal_steps_run_k_steps_a_call_with_two_gathers_each(
        seal_stores, monkeypatch):
    _, _, tg = seal_stores
    tdev = tg.store.edge_table("relation").device("cpu")
    tfeats = tg.store.node_table("item").device("cpu").float_attrs
    runs = []
    for _ in range(2):
        calls = _count_gathers(monkeypatch)
        model = seal.seal_model(128, HIDDEN, device="cpu")
        opt = tbench.make_optimizer(model, torch.device("cpu"), LR)
        step = seal.SealSteps(model, opt, tdev, tfeats, B, 3,
                              torch.Generator().manual_seed(4), False)
        step()
        runs.append(step.losses.clone())
        # two batches of subgraphs a step, B * 14 node rows each
        assert calls == [B * 14] * 6
        assert len(step.seeds) == 3 and step.seeds[0].shape == (B,)
    assert bool(torch.isfinite(runs[0]).all())
    assert torch.equal(runs[0], runs[1])


@pytest.fixture(scope="module")
def sage_stores():
    a = n2v.cora_like(n=120, feat_dim=8)
    n = a["feats"].shape[0]
    dec = JDecoder(labeled=True, attr_types=["float"] * 8)
    jg = JGraph()
    jg.store.add_node_table(JNodeTable("i", dec, np.arange(n),
                                       float_attrs=a["feats"],
                                       labels=a["labels"]))
    # an undirected type: the edges, then the same edges swapped
    src = np.concatenate([a["src"], a["dst"]])
    dst = np.concatenate([a["dst"], a["src"]])
    edec = JDecoder(weighted=True)
    jg.store.add_edge_table(JEdgeTable(
        "train", "i", "i", edec, src=src, dst=dst, num_src_nodes=n,
        num_dst_nodes=n, weights=np.ones(src.size, np.float32)))
    jg._node_decoders["i"], jg._edge_decoders["train"] = dec, edec
    jg._initialized = True
    tg, tdec = sage.build_graph(a, "cpu")
    return jg, dec, tg, tdec


def test_one_edge_star_sage_step_equals_the_jax_example(sage_stores,
                                                        monkeypatch):
    jg, jdec, tg, tdec = sage_stores
    ex = _jax_example("sage_unsupervised", ("build_query", "induce",
                                            "SageLink"))
    jb = gl.Dataset(ex["build_query"](jg, 24, 5), window=1).next()
    # the port's plan on JAX's negatives (its other draws are exact)
    monkeypatch.setattr(neg_ops, "negative_sample", lambda *a, **k:
                        torch.from_numpy(np.asarray(jb["neg_dst"].ids)))
    tb = glt.Dataset(sage.build_query(tg, 24, 5), window=1,
                     device="cpu").next()
    jpos, jneg = ex["induce"](jb)
    tpos, tneg = sage.induce(tb)
    for t, j in ((tpos, jpos), (tneg, jneg)):
        for f in ("edge_index", "node_ids", "node_mask", "edge_mask"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
        np.testing.assert_array_equal(
            t.nodes.float_attrs.materialize().numpy(),
            np.asarray(j.nodes.float_attrs))

    jm = ex["SageLink"](dec=jdec, feat_dim=8, hidden=16, out_dim=8)
    params = jm.init(jax.random.key(0), jpos, jneg, training=False)
    tm = sage.SageLink(tdec, 8, 16, 8, device="cpu")
    load_flax_params(tm, params)

    def lf(p):
        return jax_bce(*jm.apply(p, jpos, jneg, training=True))
    jloss, jgrads = jax.value_and_grad(lf)(params)
    opt = optax.adam(5e-4)
    upd, _ = opt.update(jgrads, opt.init(params), params)
    jnew = optax.apply_updates(params, upd)

    topt = torch.optim.Adam(tm.parameters(), lr=5e-4)
    loss = sage.link_loss(tm, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert_trees_close(grad_tree(tm), jgrads, rtol=G_RTOL, atol=G_ATOL)
    topt.step()
    assert_trees_close(to_flax_params(tm), jnew, rtol=G_RTOL, atol=G_ATOL)


def test_the_seal_example_runs_eagerly_on_the_cpu(monkeypatch, tmp_path):
    calls = _count_gathers(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        auc = seal.main(["--cpu", "--data_dir", str(tmp_path), "--steps",
                         "2", "--batch_size", "8"])
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", "0"],
                                                ["step", "1"]]
    assert 0.0 <= auc <= 1.0 and len(calls) == 4


def test_the_planted_seal_example_prints_hits_at_50():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hits = seal.main(["--cpu", "--planted", "--steps", "3",
                          "--batch_size", "16"])
    assert out.getvalue().splitlines()[-1] == "hits@50: %.4f" % hits
    assert 0.0 <= hits <= 1.0


def test_the_sage_unsupervised_example_runs_eagerly_on_the_cpu(monkeypatch,
                                                               tmp_path):
    calls = _count_gathers(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc = sage.main(["--cpu", "--data_dir", str(tmp_path), "--epochs",
                         "1", "--steps_per_epoch", "2",
                         "--batch_size", "32"])
    assert out.getvalue().splitlines()[-1] == \
        "link accuracy (pos>neg): %.4f" % acc
    # two stars a step, one gather each: 2 training steps, then one epoch
    # of evaluation over the train edges (both ways) in batches of 32
    g, _ = sage.build_graph(n2v.cora_like(n=800, feat_dim=32), "cpu")
    batches = -(-g.store.edge_table("train").num_edges // 32)
    assert len(calls) == 2 * 2 + 2 * batches
    assert 0.0 <= acc <= 1.0
