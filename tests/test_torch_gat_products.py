"""PyG's ogbn-products GAT on the port, on the CPU: ``EgoGATConv``'s port
options (``concat`` and ``pyg``: self-loop, bias after aggregation and
skip ``Linear`` together; each part also held alone) and the
three-layer ``EgoGAT`` against the benchmark's plain reference
(``gnnbench/references/ego_gat.py``, PyG's ``GATConv`` as its equations
read), forward and every gradient; the parameter count at the published
widths; PyG's head-major concatenation; faults the comparison must see;
and ``bench.MultiStep`` at three hops (the deepest pre-averaged for
EgoGraphSAGE, gathered for EgoGAT) and at two, where it samples what it
sampled before it took any depth."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.values import DeferredRows
from graph_learn_tpu_torch.examples.scale_demo import loss_of
from graph_learn_tpu_torch.graph import synthetic_graph
from graph_learn_tpu_torch.nn.data import EgoGraph, PreAggregatedRows
from graph_learn_tpu_torch.nn.layers.ego import EgoGATConv
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGAT, EgoGraphSAGE
from graph_learn_tpu_torch.ops import aggregate
from graph_learn_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from gnnbench.catalog import Catalog  # noqa: E402
from gnnbench.reference import cross_entropy  # noqa: E402
from gnnbench.references import ego_gat as ref  # noqa: E402

GAT_MODEL = Catalog().module("models", "ego_gat")

# f32 on both sides: the port sums the weighted raw rows and projects the
# sum once, the reference projects every row and sums the projections, so
# the two differ by reassociation alone
TOL = dict(rtol=2e-5, atol=2e-5)
# gradients multiply those errors by activations of O(1) and sum them over
# the batch
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
PUBLISHED = dict(dims=[100, 128, 128, 47], heads=[4, 4, 4],
                 concat=[True, True, False])


def _spec(heads, concat, pyg, dims=None):
    return {"dims": dims or [0] * (len(heads) + 1), "heads": list(heads),
            "concat": list(concat), "self_loop": pyg, "out_bias": pyg,
            "residual": pyg, "act": "elu"}


def _draw(module, seed):
    """Every leaf of ``module`` normal (biases too, so that each counts)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.5, generator=gen)


def _ref_leaves(module, prefix=""):
    """The module's leaves under the reference's names, as leaves of their
    own (a gradient each)."""
    return {GAT_MODEL.ref_name(prefix + k): p.detach().clone()
            .requires_grad_(True) for k, p in module.named_parameters()}


# ``pyg``'s parts one at a time: the leaves of the others zeroed (their
# gradients are still compared), so that only the part named shapes the
# output beside the attention
CONV_CASES = {
    "defaults": dict(),
    "concat": dict(concat=True),
    "self_loop": dict(pyg=True, zero=("bias", "skip")),
    "out_bias": dict(pyg=True, zero=("skip",)),
    "out_bias_concat": dict(pyg=True, concat=True, zero=("skip",)),
    "residual": dict(pyg=True, zero=("bias",)),
    "residual_concat": dict(pyg=True, concat=True, zero=("bias",)),
    "all_concat": dict(concat=True, pyg=True),
    "all_mean": dict(pyg=True),
}


def _zero(conv, parts):
    with torch.no_grad():
        for name, p in conv.named_parameters():
            if name.split(".")[0] in parts:
                p.zero_()


def _conv_case(kw, heads=3, din=6, w=5, b=7, k=4, seed=0):
    kw = dict(kw)
    zero = kw.pop("zero", ())
    conv = EgoGATConv(din, w, num_head=heads, **kw)
    _draw(conv, seed)
    _zero(conv, zero)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(b, din, generator=gen)
    nbr = torch.randn(b, k, din, generator=gen)
    spec = _spec([heads], [kw.get("concat", False)], kw.get("pyg", False))
    return conv, x, nbr, spec


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_each_conv_option_matches_the_reference(case):
    kw = CONV_CASES[case]
    conv, x, nbr, spec = _conv_case(kw)
    b, k, din = nbr.shape
    tx, tn = x.clone().requires_grad_(True), nbr.clone().requires_grad_(True)
    out = conv(tx, tn.reshape(b * k, din), k)
    leaves = _ref_leaves(conv, "layers.0.convs.0.")
    rx, rn = x.clone().requires_grad_(True), nbr.clone().requires_grad_(True)
    want = ref.gat_conv(rx, rn, leaves, 0, spec, False)
    heads, w = conv.num_head, conv.out_dim
    assert out.shape == want.shape == (b, heads * w if kw.get("concat")
                                       else w)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               **TOL)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    out.backward(g)
    want.backward(g)
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(tn.grad.numpy(), rn.grad.numpy(), **GRAD_TOL)
    for name, p in conv.named_parameters():
        r = leaves[GAT_MODEL.ref_name("layers.0.convs.0." + name)]
        np.testing.assert_allclose(p.grad.numpy(), r.grad.numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_the_defaults_add_no_leaf_and_keep_the_jax_layer():
    conv = EgoGATConv(6, 5, num_head=3)
    assert sorted(n for n, _ in conv.named_parameters()) == sorted(
        ["x_%d.weight" % h for h in range(3)]
        + ["attn_%d.weight" % h for h in range(3)])
    assert conv.output_dim == 5 and conv.bias is None and conv.skip is None


def test_a_self_loop_needs_one_width():
    with pytest.raises(ValueError):
        EgoGATConv((6, 7), 5, pyg=True)


def test_concatenation_is_pygs_head_major_layout():
    """Columns h W ... h W + W - 1 are head h's output: a one-head conv
    with head h's weights gives them (to the rounding of a batched
    product; the bias and the skip zeroed on both)."""
    conv, x, nbr, _ = _conv_case(dict(concat=True, pyg=True,
                                      zero=("bias", "skip")))
    b, k, din = nbr.shape
    heads, w = conv.num_head, conv.out_dim
    with torch.no_grad():
        out = conv(x, nbr.reshape(b * k, din), k)
        for h in range(heads):
            one = EgoGATConv(din, w, num_head=1, pyg=True)
            _zero(one, ("bias", "skip"))
            one.x_0.load_state_dict(getattr(conv, "x_%d" % h).state_dict())
            one.attn_0.load_state_dict(
                getattr(conv, "attn_%d" % h).state_dict())
            torch.testing.assert_close(out[:, h * w:(h + 1) * w],
                                       one(x, nbr.reshape(b * k, din), k),
                                       rtol=1e-6, atol=1e-6)


def test_the_comparison_sees_a_dropped_self_loop_and_a_misplaced_bias():
    """The reference without the self-loop, or with the bias added in a
    head-minor layout, lies far outside the tolerance the port meets."""
    kw = CONV_CASES["all_concat"]
    conv, x, nbr, spec = _conv_case(kw)
    b, k, din = nbr.shape
    with torch.no_grad():
        out = conv(x, nbr.reshape(b * k, din), k).numpy()
        leaves = _ref_leaves(conv, "layers.0.convs.0.")
        good = ref.gat_conv(x, nbr, leaves, 0, spec, False).numpy()
        no_loop = ref.gat_conv(x, nbr, leaves, 0, {**spec, "self_loop": False},
                               False).numpy()
        bias = leaves["layer0.bias"]
        moved = {**leaves, "layer0.bias": bias.t().reshape(bias.shape)}
        misplaced = ref.gat_conv(x, nbr, moved, 0, spec, False).numpy()
    np.testing.assert_allclose(out, good, **TOL)
    for fault in (no_loop, misplaced):
        assert np.abs(out - fault).max() > 100 * TOL["atol"]


def _published_model():
    dims = PUBLISHED["dims"]
    return EgoGAT(dims, Decoder(attr_types=["float"] * dims[0]),
                  num_heads=PUBLISHED["heads"], act=F.elu,
                  concat=PUBLISHED["concat"], pyg=True, device="cpu")


def test_the_published_widths_hold_751574_parameters():
    model = _published_model()
    assert sum(p.numel() for p in model.parameters()) == 751_574
    convs = [layer.convs[0] for layer in model.layers]
    assert [c.output_dim for c in convs] == [512, 512, 47]
    assert [c.in_dim for c in convs] == [(100, 100), (512, 512), (512, 512)]
    # PyG's per-layer counts: conv (lin, att_src, att_dst, bias) and skip
    sizes = [(sum(p.numel() for n, p in c.named_parameters()
                  if not n.startswith("skip")),
              sum(p.numel() for p in c.skip.parameters())) for c in convs]
    assert sizes == [(52_736, 51_712), (263_680, 262_656), (96_679, 24_111)]


# --- the whole model on three hops ------------------------------------

DIMS, HEADS, CONCAT = [12, 8, 8, 5], [2, 3, 2], [True, True, False]


def _three_hop_batch(b=6, fanout=(3, 2, 2), n=60, d=12, seed=4):
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(n, d, generator=gen)
    shape, ids = [b], {"seeds": torch.randint(0, n, (b,), generator=gen)}
    for j, k in enumerate(fanout, 1):
        shape.append(k)
        ids["hop%d" % j] = torch.randint(0, n, tuple(shape), generator=gen)
    labels = torch.randint(0, DIMS[-1], (n,), generator=gen)
    return feats, ids, labels


def _ego(feats, ids, deferred):
    from graph_learn_tpu_torch.core.values import Nodes
    vals = [Nodes(ids=ids[a].int(), float_attrs=feats[ids[a]],
                  type_name="item") for a in ids]
    if deferred:  # the deepest hop as the plan leaves it
        last = vals[-1]
        vals[-1] = last.replace(float_attrs=DeferredRows(feats, last.ids))
    return EgoGraph(src=vals[0], hops=vals[1:],
                    nbr_nums=tuple(ids["hop%d" % j].shape[-1]
                                   for j in range(1, len(ids))))


@pytest.mark.parametrize("deferred", [False, True])
def test_the_three_layer_model_matches_the_reference(deferred):
    feats, ids, labels = _three_hop_batch()
    model = EgoGAT(DIMS, Decoder(attr_types=["float"] * DIMS[0]),
                   num_heads=HEADS, act=F.elu, concat=CONCAT, pyg=True,
                   device="cpu")
    _draw(model, 11)
    assert model.deep_agg_op(3) is None  # attention: gathered
    logits = model(_ego(feats, ids, deferred), training=True)
    y = labels[ids["seeds"]]
    loss = supervised_softmax_loss(logits, y)
    loss.backward()
    leaves = _ref_leaves(model)
    spec = _spec(HEADS, CONCAT, True, DIMS)
    want = ref.logits(leaves, feats, ids, spec, False)
    ref_loss = cross_entropy(want, y)
    ref_loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               want.detach().numpy(), **TOL)
    np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), leaves[GAT_MODEL.ref_name(name)].grad.numpy(),
            err_msg=name, **GRAD_TOL)


# --- bench.MultiStep at any depth ---------------------------------------

N_NODES, FEAT = 2000, 16


@pytest.fixture(scope="module")
def small_graph():
    return synthetic_graph(N_NODES, 8, FEAT, 5, device="cpu")


def _query(g, fanout, batch=16):
    q = g.V("item").batch(batch).alias("src")
    for j, k in enumerate(fanout, 1):
        q = q.outV("rel").sample(k).by("random").alias("hop%d" % j)
    return q.values()


class _Watched(bench.MultiStep):
    """Keeps every step's batch and its deepest-hop means."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kept = []

    def keep(self, i, seeds, batch, logits, agg):
        self.kept.append((i, seeds, batch, logits.detach(), agg))


def _steps(cls, g, fanout, model, K=2, G=1, seed=7):
    q = _query(g, fanout)
    return cls(q, q.device_tables("cpu"), model,
               bench.make_optimizer(model, torch.device("cpu")),
               {"scan_steps": K, "n_nodes": N_NODES}, G,
               torch.Generator().manual_seed(seed), False)


def _gat(dec, dims=(FEAT, 8, 8, 5)):
    return EgoGAT(list(dims), dec, num_heads=[2, 2, 1], act=F.elu,
                  concat=[True, True, False], pyg=True, device="cpu")


def test_query_hops_are_the_plans_aliases(small_graph):
    g, _ = small_graph
    assert bench.query_hops(_query(g, (3, 2, 2))) == (
        "src", ("hop1", "hop2", "hop3"))


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_a_three_hop_step_equals_its_steps_done_by_hand(small_graph,
                                                        monkeypatch, kind):
    """One eager call at three hops: EgoGraphSAGE's deepest hop reduced by
    one ``gather_group_agg`` a group, EgoGAT's reaching the model as
    ``DeferredRows`` and gathered there; each step's loss and the updated
    weights equal the same steps written out on the ids it sampled."""
    g, dec = small_graph
    fanout = (3, 2, 2)
    model = (EgoGraphSAGE([FEAT, 8, 8, 5], dec, agg_type="gcn",
                          device="cpu") if kind == "sage" else _gat(dec))
    twin = copy.deepcopy(model)
    aggs, gathered = [], []
    orig_agg, orig_mat = aggregate.gather_group_agg, DeferredRows.materialize
    monkeypatch.setattr(bench, "gather_group_agg",
                        lambda *a: aggs.append(a[1].shape) or orig_agg(*a))
    monkeypatch.setattr(DeferredRows, "materialize",
                        lambda self: gathered.append(tuple(self.idx.shape))
                        or orig_mat(self))
    step = _steps(_Watched, g, fanout, model, K=2)
    assert step.hops == ("hop1", "hop2", "hop3")
    assert step.deep_op == ("mean" if kind == "sage" else None)
    step()
    b, deepest = 16, (16, 3, 2, 2)
    if kind == "sage":
        assert aggs == [(1,) + deepest] * 2
        assert gathered == [(b,), (b, 3), (b, 3, 2)] * 2
    else:
        assert aggs == []
        assert gathered == [(b,), (b, 3), (b, 3, 2), deepest] * 2
    # the same two steps by hand, on the ids the call sampled
    opt = bench.make_optimizer(twin, torch.device("cpu"))
    for i, _, batch, _, agg in step.kept:
        if agg is not None:
            batch = {**batch, "hop3": batch["hop3"].replace(
                float_attrs=PreAggregatedRows(agg, "mean"))}
        ego = EgoGraph.from_query_result(batch, "src",
                                         ["hop1", "hop2", "hop3"])
        loss = supervised_softmax_loss(twin(ego, training=True),
                                       batch["src"].labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        assert torch.equal(loss.detach(), step.losses[i])
    for a, c in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, c)


class _TwoHopStepAsItWas(bench.MultiStep):
    """``MultiStep._group`` as it was written before it took any depth:
    two hops, hop 2 pre-averaged, ``scale_demo.loss_of``."""

    def _group(self, first):
        table = self.tables["nodes"]["item"].float_attrs
        with torch.no_grad():
            batches = [bench.sample_one(self.q, self.tables, self.n_nodes,
                                        self.generator)
                       for _ in range(self.G)]
            ids2 = [b["hop2"].ids for _, b in batches]
            ids2 = ids2[0][None] if self.G == 1 else torch.stack(ids2)
            agg2 = aggregate.gather_group_agg(table, ids2, "mean").reshape(
                self.G, -1, table.shape[-1])
        for j, (seeds, batch) in enumerate(batches):
            self.seeds.append(seeds)
            hop2 = batch["hop2"].replace(
                float_attrs=PreAggregatedRows(agg2[j], "mean"))
            loss = loss_of(self.model, {**batch, "hop2": hop2})
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            self.losses[first + j].copy_(loss.detach())


@pytest.mark.parametrize("G", [1, 3])
def test_the_two_hop_sage_step_samples_and_trains_as_it_did(small_graph, G):
    """Same seeds, same ids, same losses and weights, bit for bit."""
    g, dec = small_graph
    runs = []
    for cls in (_TwoHopStepAsItWas, _Watched):
        torch.manual_seed(0)
        model = EgoGraphSAGE([FEAT, 8, 5], dec, agg_type="gcn",
                             device="cpu")
        step = _steps(cls, g, (5, 3), model, K=3, G=G)
        step()
        step()  # the second call starts from the first's generator state
        runs.append((step, [p.detach().clone() for p in model.parameters()]))
    (old, old_p), (new, new_p) = runs
    assert len(old.seeds) == len(new.seeds) == 3
    for a, c in zip(old.seeds, new.seeds):
        assert torch.equal(a, c)
    assert torch.equal(old.losses, new.losses)
    assert all(torch.equal(a, c) for a, c in zip(old_p, new_p))
    # the ids of the second call's steps, drawn again from the same seed
    gen = torch.Generator().manual_seed(7)
    q = _query(g, (5, 3))
    tables = q.device_tables("cpu")
    drawn = [bench.sample_one(q, tables, N_NODES, gen) for _ in range(6)]
    for (_, seeds, batch, _, _), (s2, b2) in zip(new.kept[3:], drawn[3:]):
        assert torch.equal(seeds, s2)
        for a in ("hop1", "hop2"):
            assert torch.equal(batch[a].ids, b2[a].ids)


def test_the_gat_spans_and_counters(small_graph):
    """While tracing, each block is a ``model.gat.block`` span inside a
    step and counts its rows; the projection is ``model.gat.project``."""
    g, dec = small_graph
    step = _steps(bench.MultiStep, g, (3, 2, 2), _gat(dec), K=1)
    profiling.reset()
    profiling.enable()
    try:
        step()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    blocks = [(16, 3), (48, 2), (96, 2), (16, 3), (48, 2), (16, 3)]
    assert snap["spans"]["model.gat.block"]["calls"] == len(blocks)
    assert snap["spans"]["model.gat.project"]["calls"] == len(blocks)
    assert snap["counters"]["gat.block_rows"] == sum(
        b * (k + 1) for b, k in blocks)
    assert snap["counters"]["gat.self_loop_rows"] == sum(b for b, _ in blocks)


def test_init_draws_the_skip_and_zeroes_the_biases():
    model = _published_model()
    for layer in model.layers:
        conv = layer.convs[0]
        assert torch.count_nonzero(conv.bias) == 0
        assert torch.count_nonzero(conv.skip.bias) == 0
        std = float(conv.skip.weight.detach().std())
        assert abs(std - conv.skip.in_features ** -0.5) < 0.1 * std
