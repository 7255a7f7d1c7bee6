"""The port's mesh, placement and data-parallel training
(parallel/{mesh,train}.py) against the JAX package's tests/test_parallel.py.

One set of 2 CPU ranks (gloo) runs every case once for the module
(tests/torch_parity.py ``parallel_ranks``) on meshes (1, 2) and (2, 1).
A data-parallel run is held to one process's run on the whole batch: the
parameters after the steps within rtol 1e-5 (the gradients are averaged
over the data axis), on topk, where the draws do not depend on the
batch's split.  The partitioned store at (1, 2) draws as one process
does, so there the random plan is held too.
"""

import numpy as np
import pytest

from torch_parity import write_wts_files


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch_parity
    from graph_learn_tpu_torch.parallel.launch import spawn
    where = tmp_path_factory.mktemp("wts")
    write_wts_files(str(where))
    return spawn(torch_parity.parallel_ranks, 2, device="cpu",
                 args=(str(where),), timeout_s=120, threads=1)


def test_mesh_shapes(ranks):
    for r in ranks:
        assert r["shapes"] == ((1, 2), (2, 1), ("data", "graph"))


def test_shard_tables_warns_on_silent_replication(ranks):
    """The warning, word for word the JAX package's at the same table (41
    rows over a graph axis of 2); rows that divide the axis shard."""
    import warnings

    import jax
    import jax.numpy as jnp
    from graph_learn_tpu.parallel.mesh import make_mesh, shard_tables

    mesh = make_mesh(n_data=1, n_graph=2, devices=jax.devices()[:2])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shard_tables({"nodes": {"item": {
            "float_attrs": jnp.ones((41, 4), jnp.float32),
            "labels": jnp.zeros((41,), jnp.int32)}}, "edges": {}}, mesh)
    want = [str(w.message) for w in rec if "REPLICATED" in str(w.message)]
    for r in ranks:
        assert r["warnings"] == want
        assert r["sharded_rows"]


def test_params_sharding_rules(ranks):
    """The JAX rule's placement names: a 2-D embedding whose rows divide
    the graph axis would shard over it.  The port keeps every parameter
    on every rank (ROADMAP.md queue C): the data-parallel cases below
    end with equal parameters on both ranks."""
    for r in ranks:
        at12, at21 = r["rules"]
        assert at12 == {"embedding": "graph", "dense.weight": "replicated",
                        "dense.bias": "replicated"}
        assert set(at21.values()) == {"replicated"}


def test_sharded_step_runs_and_updates(ranks):
    """(1, 2) with shard_tables: node payloads on their owners, the loss
    one process's (rtol 1e-5), the parameters moved."""
    for r in ranks:
        s = r["sharded_tables"], r["sharded_step"]
        assert s[0]
        np.testing.assert_allclose(s[1]["loss"], s[1]["ref_loss"], rtol=1e-5)
        assert np.isfinite(s[1]["loss"]) and s[1]["moved"] > 0


def test_sharded_matches_single_device(ranks):
    """(2, 1), topk: the mean of the two data slices' losses is one
    process's loss on the whole batch, and after the step both ranks hold
    that process's parameters (rtol 1e-5)."""
    losses = [r["dp_step"]["loss"] for r in ranks]
    np.testing.assert_allclose(np.mean(losses), ranks[0]["dp_step"]
                               ["ref_loss"], rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["dp_step"]["params"].numpy(),
                                   r["dp_step"]["ref_params"].numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_dist_trainer(ranks):
    """DistTrainer at (2, 1), 2 epochs of SGD: finite, falling, the
    parameters equal on both ranks and LocalTrainer's on one process
    (rtol 1e-5); the epoch means average to LocalTrainer's."""
    import torch
    a, b = (r["dist_trainer"] for r in ranks)
    assert not a["partitioned"]
    assert len(a["hist"]) == 2 and np.isfinite(a["hist"]).all()
    assert a["hist"][1] <= a["hist"][0] + 0.5
    assert torch.equal(a["params"], b["params"])
    np.testing.assert_allclose(a["params"].numpy(), a["ref_params"].numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose((np.array(a["hist"]) + b["hist"]) / 2,
                               a["ref_hist"], rtol=1e-5)


def test_dist_trainer_selects_partitioned_store(ranks):
    """(1, 2) with ``partition_above_bytes=0``: each rank trains over its
    block of the partitioned store (25 of the 50 rows), and the run is
    one process's (same draws; rtol 1e-5)."""
    for r in ranks:
        t = r["partitioned_trainer"]
        assert t["partitioned"] and t["block_rows"] == 25
        np.testing.assert_allclose(t["hist"], t["ref_hist"], rtol=1e-5)
        np.testing.assert_allclose(t["params"].numpy(),
                                   t["ref_params"].numpy(), rtol=1e-5,
                                   atol=1e-7)
        rep = r["replicated_trainer"]
        assert not rep["partitioned"] and np.isfinite(rep["hist"]).all()


def test_data_parallel_draws_per_slice(ranks):
    """Each data rank draws for its own slice of the batch, as each JAX
    shard draws at its block's shape, so a random hop of rank 1 is not
    the whole batch's draw for those seeds (the JAX data-parallel step
    draws for the whole batch; ROADMAP.md queue C); every draw is a true
    neighbour."""
    for r, out in enumerate(ranks):
        d = out["dp_draws"]
        assert d["slice"] == list(range(8 * r, 8 * r + 8))
        assert d["true"]
    assert ranks[1]["dp_draws"]["differs"]


def _jax_routing_bytes(p):
    """The JAX script's StableHLO payload counts at P = p for its query
    (examples/routing_bytes.py ``main``, on p of the 8 virtual devices)."""
    import importlib.util
    import os

    import jax
    import jax.numpy as jnp
    from graph_learn_tpu.core.schema import Decoder
    from graph_learn_tpu.core.store import EdgeTable, NodeTable
    from graph_learn_tpu.graph import Graph
    from graph_learn_tpu.parallel.mesh import make_mesh
    from graph_learn_tpu.parallel.sharded_store import build_sharded_tables
    from graph_learn_tpu.parallel.train import make_partitioned_plan

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_routing_bytes", os.path.join(root, "examples",
                                          "routing_bytes.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rng = np.random.default_rng(0)
    n, deg, d = 4096, 8, 128
    g = Graph()
    nd = Decoder(labeled=True, attr_types=["float"] * d)
    ed = Decoder(weighted=True)
    g.store.add_node_table(NodeTable(
        "v", nd, np.arange(n, dtype=np.int64),
        float_attrs=rng.standard_normal((n, d)).astype(np.float32),
        labels=rng.integers(0, 4, n).astype(np.int32)))
    src = rng.integers(0, n, n * deg)
    dst = rng.integers(0, n, n * deg)
    g.store.add_edge_table(EdgeTable(
        "e", "v", "v", ed, src=src, dst=dst, num_src_nodes=n,
        num_dst_nodes=n, weights=rng.random(n * deg).astype(np.float32)))
    g._node_decoders["v"] = nd
    g._edge_decoders["e"] = ed
    g._initialized = True
    q = (g.V("v").batch(256).alias("src")
         .outV("e").sample(8).by("edge_weight").alias("h1").values())
    mesh = make_mesh(n_data=1, n_graph=p, devices=jax.devices()[:p])
    stables = build_sharded_tables(q, p).place(mesh)
    out = {}
    for routing in ("psum", "owner"):
        plan = make_partitioned_plan(q, mesh, stables, routing=routing)
        with jax.set_mesh(mesh):
            text = jax.jit(plan).lower(jnp.arange(256, dtype=jnp.int32),
                                       jax.random.key(0)).as_text()
        out[routing] = script.collective_bytes(text)
    return out


def test_routing_bytes_against_the_jax_count(ranks):
    """examples/routing_bytes.py at P = 2 against the JAX script's
    StableHLO count of the same query, every difference named: the
    port's raw ids are int64 (the JAX package's device views int32, x64
    off); the eager port stitches the hop's edge ids, which no output
    reads and XLA drops; the JAX count holds owner routing's exact
    fallback (one dense psum of each routed leaf's stripe inside a
    ``lax.cond``, not run here: no bucket overflows at P = 2) and the port
    all-gathers the stripes.  The all_to_all payloads (the buckets at
    their padded capacity) are equal."""
    want = _jax_routing_bytes(2)
    widen = (256 + 2048) * 4  # src and h1 raw ids, int64 against int32
    dead = 2048 * 4  # the h1 edge ids' psum
    fallback = (128 + 1024) * 128 * 4  # the src and h1 feature stripes
    for r in ranks:
        got = r["routing"]
        (jc, jb), (c, b) = want["psum"]["all_reduce"], \
            got["psum"]["ops"]["all_reduce"]
        assert set(got["psum"]["ops"]) == set(want["psum"]) == {"all_reduce"}
        assert (c, b) == (jc + 1, jb + widen + dead)
        own, jown = got["owner"]["ops"], want["owner"]
        assert own["all_to_all"] == [float(x) for x in jown["all_to_all"]]
        (jc, jb), (c, b) = jown["all_reduce"], own["all_reduce"]
        assert (c, b) == (jc + 1 - 2, jb + widen + dead - fallback)
        assert own["all_gather"] == [2.0, (256 + 2048) * 128 * 4]
        assert "all_gather" not in jown
