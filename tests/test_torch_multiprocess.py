"""Ranks as processes: parallel/bootstrap.py ``init_cluster`` and
parallel/launch.py ``spawn``, against the JAX package's
tests/test_multiprocess.py.

Two OS processes started by hand with the ``GLT_COORDINATOR`` /
``GLT_NUM_PROCS`` / ``GLT_PROC_ID`` environment join one gloo group on the
CPU and take a data-parallel step on the same graph, the gradient
all-reduce crossing the process boundary; both end with the same
parameters.  ``spawn`` returns the ranks' values in rank order and fails
the call, with the rank's traceback, when a rank raises or outlives the
deadline; ranks that would share one card need ``backend="gloo"``.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.parallel import bootstrap, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
sys.path.insert(0, {{REPO}})
import numpy as np
import torch

import graph_learn_tpu_torch as glt
from graph_learn_tpu_torch.core.sharding import DATA_AXIS, bind_mesh, psum
from graph_learn_tpu_torch.nn.data import EgoGraph
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
from graph_learn_tpu_torch.parallel.bootstrap import init_cluster, shutdown
from graph_learn_tpu_torch.parallel.mesh import make_mesh
from graph_learn_tpu_torch.parallel.train import make_sharded_train_step

assert "jax" not in sys.modules
ok = init_cluster(device="cpu")
assert ok, "init_cluster should engage in multi-process mode"
import torch.distributed as dist
pid = dist.get_rank()
assert dist.get_world_size() == 2

d = {{DATA}}
dec = glt.Decoder(labeled=True, attr_types=["float"] * 4)
g = (glt.Graph(device="cpu")
     .node(os.path.join(d, "nodes"), "v", dec)
     .edge(os.path.join(d, "edges"), ("v", "v", "e"), glt.Decoder(),
           directed=False)).init()
q = (g.V("v").batch(16).alias("src")
     .outV("e").sample(3).by("random").alias("h1").values())
torch.manual_seed(0)
model = EgoGraphSAGE([4, 3], dec, agg_type="mean", device="cpu")
opt = torch.optim.SGD(model.parameters(), lr=0.1)

def loss_fn(m, batch, gen, training):
    ego = EgoGraph.from_query_result(batch, "src", ["h1"])
    return supervised_softmax_loss(m(ego, training=False),
                                   batch["src"].labels)

mesh = make_mesh(n_data=2, n_graph=1)
step = make_sharded_train_step(q, model, loss_fn, opt, mesh)
loss = step(q.device_tables("cpu"), torch.arange(16, dtype=torch.int32),
            torch.Generator().manual_seed(1))
with bind_mesh(mesh):
    mean = float(psum(loss.reshape(1), DATA_AXIS)[0]) / 2
assert np.isfinite(mean)
leaf0 = next(model.parameters()).detach().reshape(-1)[:4]
print("WORKER_OK", pid, round(mean, 6), " ".join("%.6f" % x for x in leaf0))
shutdown()
"""


def test_two_process_data_parallel(tmp_path):
    n = 64
    with open(tmp_path / "nodes", "w") as f:
        f.write("id:int64\tlabel:int64\tfeature:string\n")
        for i in range(n):
            f.write("%d\t%d\t%s\n"
                    % (i, i % 3,
                       ":".join("%.2f" % (i * 0.1 + j) for j in range(4))))
    with open(tmp_path / "edges", "w") as f:
        f.write("src_id:int64\tdst_id:int64\n")
        for i in range(n):
            for j in range(1, 4):
                f.write("%d\t%d\n" % (i, (i + j) % n))
    code = _WORKER.replace("{{REPO}}", repr(REPO)) \
                  .replace("{{DATA}}", repr(str(tmp_path)))
    store = "file://" + str(tmp_path / "store")
    procs = []
    for pid in range(2):
        env = dict(os.environ, GLT_COORDINATOR=store, GLT_NUM_PROCS="2",
                   GLT_PROC_ID=str(pid), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, (out, err[-2000:])
            outs.append([ln for ln in out.splitlines()
                         if ln.startswith("WORKER_OK")][0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # the same data-mean loss and the same parameters after the step
    assert outs[0].split()[2:] == outs[1].split()[2:], outs


def test_init_cluster_without_coordinator_is_single_process(monkeypatch):
    monkeypatch.delenv("GLT_COORDINATOR", raising=False)
    assert bootstrap.init_cluster(device="cpu") is False
    assert bootstrap.current_device() is None


def test_spawn_returns_each_rank_in_order():
    import torch_parity
    out = launch.spawn(torch_parity.echo_rank, 3, device="cpu",
                       args=("t",), timeout_s=60, threads=1)
    assert out == [(r, 3, "t", "cpu", 3) for r in range(3)]


def test_spawn_reports_a_failing_rank():
    import torch_parity
    with pytest.raises(launch.RankFailed, match="rank one gives up"):
        launch.spawn(torch_parity.failing_rank, 2, device="cpu",
                     timeout_s=60, threads=1)


def test_spawn_ends_ranks_at_the_deadline():
    """A rank that outlives the deadline fails the call soon after it,
    and no rank is left running."""
    import torch_parity
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed, match="still running"):
        launch.spawn(torch_parity.sleeping_rank, 2, device="cpu",
                     args=(300.0,), timeout_s=5, threads=1)
    assert time.monotonic() - t0 < 40


def test_ranks_sharing_a_card_need_gloo(monkeypatch):
    """Two ranks on one card: NCCL refuses them, so without
    ``backend="gloo"`` the launch (and routing_bytes without ``--backend
    gloo``) raises before any process starts; one
    rank a card takes NCCL; the CPU takes gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    with pytest.raises(InvalidArgumentError, match="backend='gloo'"):
        bootstrap.choose_backend(card, 2)
    with pytest.raises(InvalidArgumentError, match="backend='gloo'"):
        bootstrap.choose_backend(card, 2, "nccl")
    assert bootstrap.choose_backend(card, 2, "gloo") == "gloo"
    assert bootstrap.choose_backend(card, 1) == "nccl"
    assert bootstrap.choose_backend(torch.device("cpu"), 4) == "gloo"
    assert bootstrap.rank_device(3, "cuda") == card
    with pytest.raises(InvalidArgumentError, match="backend='gloo'"):
        launch.spawn(print, 2, device="cuda")
    # the example asks for no backend itself: its --backend gloo or a raise
    from graph_learn_tpu_torch.examples import routing_bytes
    with pytest.raises(InvalidArgumentError, match="backend='gloo'"):
        routing_bytes.main(["--ranks", "2", "--device", "cuda"])
