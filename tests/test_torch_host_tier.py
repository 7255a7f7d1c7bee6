"""The host-RAM tier (gsl/dataset.py ``tier="host"``, nn/trainer.py)
against the device tier and the JAX package's tests/test_host_tier.py:
the same batches for one seed with and without the producer thread, the
epochs and OutOfRangeError, the tables' caches kept apart, a bad tier
refused, ``conf.storage_device``, the supervised run of
``test_local_trainer_host_tier:123-189`` on the CPU, an exception of the
producer raised by ``next()``, and the rows a card-bound batch carries
gathered on the CPU (``host_batch``)."""

import sys
import threading

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.core.values import DeferredRows, TensorStruct
from graph_learn_tpu_torch.gsl.dataset import host_batch
from graph_learn_tpu_torch.core.values import Nodes
from graph_learn_tpu_torch.examples import common
from graph_learn_tpu_torch.examples.data.synthetic import cora_like
from graph_learn_tpu_torch.nn.data import pre_aggregate_hop
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.nn.trainer import LocalTrainer
from torch_parity import both_confs


def _graph(mod, f, **kw):
    g = mod.Graph(**kw)
    g.node(f["node"], node_type="item",
           decoder=mod.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(f["edge"], edge_type=("item", "item", "rel"),
           decoder=mod.Decoder(weighted=True))
    return g.init()


@pytest.fixture
def g(tmp_graph_dir):
    return _graph(glt, tmp_graph_dir, device="cpu")


def _query(g):
    return (g.V("item").batch(8).shuffle().alias("src")
            .outV("rel").sample(3).by("edge_weight").alias("hop1")
            .outV("rel").sample(2).by("random").alias("hop2").values())


def _leaves(v, out=None):
    """Every tensor of a batch, deferred rows gathered, in field order."""
    out = [] if out is None else out
    if isinstance(v, dict):
        for k in sorted(v):
            _leaves(v[k], out)
    elif isinstance(v, DeferredRows):
        out.append(v.materialize())
    elif isinstance(v, TensorStruct):
        for f in v.__dataclass_fields__:
            _leaves(getattr(v, f), out)
    elif isinstance(v, torch.Tensor):
        out.append(v)
    return out


def _same_batches(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("window", [1, 2, 5])
def test_host_tier_matches_device_tier(g, window):
    """One seed, 12 batches over two epochs of a random source: the host
    tier (window 1 on the caller's thread, else the producer thread) gives
    the device tier's batches bit for bit."""
    q = _query(g)
    dev = glt.Dataset(q, seed=11, window=window, device="cpu")
    host = glt.Dataset(q, seed=11, window=window, tier="host", device="cpu")
    assert (host._producer is not None) == (window > 1)
    for _ in range(12):
        _same_batches(dev.next(), host.next())
    host.close()


def test_host_tier_answers_the_jax_host_tier(tmp_graph_dir):
    """A deterministic query (``topk`` over a by-order source): the ids of
    every batch equal the JAX host tier's, and so do the features."""
    tg, jg = _graph(glt, tmp_graph_dir, device="cpu"), _graph(gl,
                                                              tmp_graph_dir)

    def q(g):
        return (g.V("item").batch(8).alias("src")
                .outV("rel").sample(3).by("topk").alias("hop1").values())
    tds = glt.Dataset(q(tg), seed=5, window=3, tier="host", device="cpu")
    jds = gl.Dataset(q(jg), seed=5, tier="host")
    for _ in range(5):
        t, j = tds.next(), jds.next()
        for a in ("src", "hop1"):
            np.testing.assert_array_equal(t[a].ids.numpy(),
                                          np.asarray(j[a].ids))
            np.testing.assert_array_equal(
                t[a].float_attrs.materialize().numpy(),
                np.asarray(j[a].float_attrs))
    tds.close()


@pytest.mark.parametrize("window", [1, 4])
def test_host_tier_epochs_and_out_of_range(g, window):
    q = (g.V("item").batch(8).alias("src")
         .outV("rel").sample(3).by("topk").alias("hop1").values())
    ds = glt.Dataset(q, seed=5, tier="host", window=window, device="cpu")
    for epoch in range(3):
        n = 0
        with pytest.raises(glt.OutOfRangeError):
            while True:
                ds.next()
                n += 1
                assert n < 1000
        assert n == -(-g.store.node_set("item").size // 8)
    # the epoch restarts after OutOfRange
    assert ds.next()["src"].ids.shape == (8,)
    assert list(iter(glt.Dataset(q, tier="host", window=window,
                                 device="cpu"))) != []
    ds.close()


def test_tier_caches_do_not_leak(g):
    """The host tier's tables are the store's CPU views; the device tier's
    are built for their own device and are other tensors (a second
    device stands in for the card: "meta")."""
    q = _query(g)
    ds_host = glt.Dataset(q, seed=1, tier="host", window=1, device="meta")
    dev_tables = q.device_tables("meta")
    host_leaves = _leaves(ds_host._tables["nodes"]) + _leaves(
        ds_host._tables["edges"])
    dev_leaves = _leaves(dev_tables["nodes"]) + _leaves(dev_tables["edges"])
    assert host_leaves and all(x.device.type == "cpu" for x in host_leaves)
    assert dev_leaves and all(x.device.type == "meta" for x in dev_leaves)
    nt = g.store.node_table("item")
    assert set(d.type for d in nt._device) == {"cpu", "meta"}
    assert ds_host._tables["nodes"]["item"] is nt.device("cpu")


def test_bad_tier_rejected(g):
    with pytest.raises(glt.InvalidArgumentError, match="tier must be"):
        glt.Dataset(_query(g), tier="gpu", device="cpu")
    with pytest.raises(glt.InvalidArgumentError, match="window"):
        glt.Dataset(_query(g), tier="host", window=0, device="cpu")


def test_conf_storage_device_default(g):
    with both_confs(storage_device="host"):
        ds = glt.Dataset(_query(g), seed=2, device="cpu")
        assert ds.tier == "host"
        assert all(x.device.type == "cpu" for x in _leaves(ds._tables))
        ds.next()
        ds.close()
        assert LocalTrainer(device="cpu").evaluate(
            g.V("item").batch(8).alias("src").values(), None,
            lambda m, b: b["src"].ids.float()) == pytest.approx(19.5)


def test_local_trainer_host_tier(tmp_path):
    """test_host_tier.py:123-189 on the port: the deepest hop reduced on
    the CPU before the batch leaves it; the loss falls to under half and
    the test accuracy passes 0.6."""
    d = str(tmp_path / "cora")
    cora_like(d, n=300, classes=3, feat_dim=16, avg_degree=6, seed=1)
    g, dec = common.load_cora_like(d, feat_dim=16, device="cpu")
    q = common.supervised_query(g, glt.Mask.TRAIN, 32, [5, 3])
    model = EgoGraphSAGE([16, 32, 3], dec, agg_type="gcn", dropout=0.0,
                         device="cpu")

    def transform(batch, tables):
        return pre_aggregate_hop(
            batch, "hop2", tables["nodes"]["item"].float_attrs, op="mean")

    tr = LocalTrainer(device="cpu")
    _, hist = tr.train(q, model, common.supervised_loss_fn(["hop1", "hop2"]),
                       torch.optim.Adam(model.parameters(), lr=0.03),
                       epochs=8, verbose=False, tier="host",
                       batch_transform=transform)
    assert hist[-1] < hist[0] * 0.5, hist
    tq = common.supervised_query(g, glt.Mask.TEST, 32, [5, 3])
    acc = tr.evaluate(tq, model, common.accuracy_fn(["hop1", "hop2"]),
                      tier="host")
    assert acc > 0.6, acc
    # no producer thread outlives the calls
    assert not [t for t in threading.enumerate()
                if t.name == "glt-dataset-producer"]


@pytest.mark.parametrize("window", [1, 3])
def test_a_producer_exception_reaches_next(g, window):
    """Two good batches, then the transform raises: next() raises it (and
    again on the next call); nothing is swallowed."""
    calls = []

    def transform(batch, tables):
        calls.append(1)
        if len(calls) == 3:
            raise KeyError("bad batch")
        return batch

    ds = glt.Dataset(_query(g), seed=3, window=window, tier="host",
                     device="cpu", transform=transform)
    ds.next()
    ds.next()
    with pytest.raises(KeyError, match="bad batch"):
        ds.next()
    with pytest.raises(KeyError, match="bad batch"):
        ds.next()
    ds.close()


def test_the_producer_keeps_order_under_contention(g):
    """A time-bounded stress run: a short switch interval and four
    datasets read at once from threads; each gives the batches of its
    seed on the caller's thread, in order."""
    q = _query(g)
    want = {s: [_leaves(b) for b in _take(glt.Dataset(
        q, seed=s, window=1, tier="host", device="cpu"), 9)]
        for s in range(4)}
    got, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def read(s):
            try:
                ds = glt.Dataset(q, seed=s, window=3, tier="host",
                                 device="cpu")
                got[s] = [_leaves(b) for b in _take(ds, 9)]
                ds.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
        threads = [threading.Thread(target=read, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for s in range(4):
        for a, b in zip(got[s], want[s]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def _take(ds, n):
    return [ds.next() for _ in range(n)]


def test_host_batch_gathers_every_deferred_row(g):
    """What a card-bound batch carries (``host_batch``, unpinned on a
    machine without a card): every deferred row gathered on the CPU,
    nested edge values too, equal to Kernel 1's plain version, ids out of
    the table clipped as ``feature_gather`` clips them."""
    q = (g.V("item").batch(4).alias("src")
         .outE("rel").sample(2).by("topk").alias("e")
         .inV().alias("dst").values())
    out = glt.Dataset(q, device="cpu").next()
    flat = host_batch(out, pin=False)

    def deferred(v):
        if isinstance(v, DeferredRows):
            return True
        return isinstance(v, TensorStruct) and any(
            deferred(getattr(v, f)) for f in v.__dataclass_fields__)
    assert any(deferred(v) for v in out.values())
    assert not any(deferred(v) for v in flat.values())
    assert torch.equal(flat["dst"].float_attrs,
                       out["dst"].float_attrs.materialize())
    assert torch.equal(flat["e"].dst_nodes.float_attrs,
                       out["e"].dst_nodes.float_attrs.materialize())
    assert torch.equal(flat["src"].ids, out["src"].ids)
    table = out["src"].float_attrs.table
    odd = DeferredRows(table, torch.tensor([[-3, 0], [1, 10**6]]))
    got = host_batch({"x": Nodes(ids=odd.idx, float_attrs=odd)},
                     pin=False)["x"].float_attrs
    assert got.shape == (2, 2, table.shape[1])
    assert torch.equal(got, odd.materialize())
