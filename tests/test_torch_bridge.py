"""The port's torch data bridge (nn/torch_bridge.py) against the JAX
package's, the three cases of tests/test_api_aux.py:92-150 on the same
deterministic query (``topk`` hops over a by-order source): the same ids
and features batch for batch, ``induce_func``, the host tier's batches on
the CPU, and the trimmed last batch; plus the collate function and the
duplicate batches of a loader with workers."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.nn import torch_bridge as jbridge
from graph_learn_tpu_torch.nn import torch_bridge as bridge

REPO = Path(__file__).resolve().parents[1]


def _graph(mod, f, **kw):
    g = mod.Graph(**kw)
    g.node(f["node"], node_type="item",
           decoder=mod.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(f["edge"], edge_type=("item", "item", "rel"),
           decoder=mod.Decoder(weighted=True))
    return g.init()


def _query(g, batch=8):
    return (g.V("item").batch(batch).alias("src")
            .outV("rel").sample(3).by("topk").alias("hop").values())


@pytest.fixture
def graphs(tmp_graph_dir):
    return _graph(glt, tmp_graph_dir, device="cpu"), _graph(gl,
                                                            tmp_graph_dir)


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same(got[k], v)
        else:
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)


def test_torch_bridge(graphs):
    """GSL -> torch IterableDataset / DataLoader: tensors, shapes, float
    features, and the ``induce_func`` contract."""
    tg, jg = graphs
    got = list(bridge.TorchDataset(_query(tg), window=1, device="cpu"))
    want = list(jbridge.TorchDataset(_query(jg), window=1))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        _same(a, b)
    b0 = got[0]
    assert isinstance(b0["src"]["ids"], torch.Tensor)
    assert b0["hop"]["ids"].shape == (8, 3)
    assert b0["src"]["float_attrs"].dtype == torch.float32

    def induce(batch):
        return (batch["src"].ids.shape[0], tuple(batch["hop"].ids.shape))
    loader = bridge.torch_loader(_query(tg), window=1, induce_func=induce,
                                 device="cpu", batch_size=4)
    assert next(iter(loader)) == (8, (8, 3))


def test_torch_bridge_host_tier_stays_on_host(graphs):
    """``tier="host"``: the graph's CPU views, batches on the CPU, equal to
    the device tier's and to the JAX host tier's."""
    tg, jg = graphs
    host = list(bridge.TorchDataset(_query(tg), window=3, tier="host"))
    dev = list(bridge.TorchDataset(_query(tg), window=1, device="cpu"))
    want = list(jbridge.TorchDataset(_query(jg), window=1, tier="host"))
    assert len(host) == len(dev) == len(want)
    for h, d, w in zip(host, dev, want):
        _same(h, w)
        _same(d, w)
        assert h["src"]["ids"].device.type == "cpu"


def test_torch_bridge_trims_partial_batch(graphs):
    """40 nodes in batches of 16: 16, 16, then the 8 true rows."""
    tg, jg = graphs
    sizes = [b["src"]["ids"].shape[0] for b in
             bridge.TorchDataset(tg.V("item").batch(16).alias("src")
                                 .values(), window=1, device="cpu")]
    assert sizes == [16, 16, 8]
    got = list(bridge.TorchDataset(_query(tg, 16), window=2, device="cpu",
                                   epochs=2))
    want = list(jbridge.TorchDataset(_query(jg, 16), window=1, epochs=2))
    assert [b["hop"]["float_attrs"].shape[:2] for b in got] == \
        [(16, 3), (16, 3), (8, 3)] * 2
    for a, b in zip(got, want):
        _same(a, b)


WORKERS = """
import numpy as np
import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.core.store import NodeTable
from graph_learn_tpu_torch.nn import torch_bridge as bridge

g = glt.Graph(device="cpu")
g.add_node_table(NodeTable("item", glt.Decoder(), np.arange(40) * 10))
q = g.V("item").batch(16).alias("src").values()
ids = lambda **kw: [b["src"]["ids"].tolist() for b in bridge.torch_loader(
    q, window=1, device="cpu", **kw)]
one, two = ids(), ids(num_workers=2, multiprocessing_context="fork")
assert len(one) == 3 and len(two) == 6, (one, two)
assert sorted(two) == sorted(one + one)
print("repeated")
"""


def test_collater_and_workers_repeat_the_query(graphs):
    """A batch of one unwraps, another size is refused; a loader with two
    workers runs the whole query in each (the JAX bridge's behaviour,
    noted in the module): every batch comes twice.  The workers fork in a
    process of their own, which has not loaded JAX."""
    assert bridge.Collater()([{"a": 1}]) == {"a": 1}
    with pytest.raises(ValueError, match="batches of one"):
        bridge.Collater()([1, 2])
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", WORKERS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "repeated"
