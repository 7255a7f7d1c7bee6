"""The graph-sharded sampled path of the port (parallel/sharded_store.py,
core/sharding.py, parallel/train.py) against the JAX package's
tests/test_sharded_store.py.

One set of 4 CPU ranks (gloo, parallel/launch.py spawn) runs every case
once for the module (tests/torch_parity.py ``sharded_store_ranks``):

- mesh (1, 4): every plan of tests/test_sharded_store.py on the
  partitioned store equals the port's single-device plan bit for bit
  (both routings, the owner-routing overflow, temporal hops and filters,
  negatives, walks, conditional negatives, SubGraph);
- mesh (2, 2): data parallelism, held to the table (random draws) and,
  on topk, to the JAX plan.

The host blocks of ``build_sharded_tables`` and ``bytes_per_device`` are
held against the JAX package's in this process, bit for bit.
"""

import numpy as np
import pytest

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from torch_parity import jax_flat_result, wts_graph, wts_queries, write_wts_files

P_RANKS = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    where = tmp_path_factory.mktemp("wts")
    write_wts_files(str(where))
    return str(where)


@pytest.fixture(scope="module")
def ranks(files):
    import torch_parity
    from graph_learn_tpu_torch.parallel.launch import spawn
    return spawn(torch_parity.sharded_store_ranks, P_RANKS, device="cpu",
                 args=(files,), timeout_s=120, threads=1)


PLAN_CASES = ["plan-random", "plan-topk", "plan-edge_weight",
              "plan-in_degree", "plan-random_without_replacement",
              "plan-full"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_sharded_plan_matches_single_device(ranks, case):
    """Mesh (1, 4): bit for bit the single-device plan (the same
    generator seed on every rank)."""
    for r in ranks:
        assert r["bad"][case] == [], case


@pytest.mark.parametrize("case", ["temporal", "negatives"])
def test_sharded_temporal_and_negatives_match(ranks, case):
    for r in ranks:
        assert r["bad"][case] == []


@pytest.mark.parametrize("case", ["walk-deepwalk", "walk-node2vec"])
def test_sharded_walks_match_single_device(ranks, case):
    for r in ranks:
        assert r["bad"][case] == []


def test_sharded_conditional_negatives_match(ranks):
    for r in ranks:
        assert r["bad"]["conditional"] == []


def test_temporal_filter_composes(ranks):
    for r in ranks:
        assert r["bad"]["temporal-filter"] == []


@pytest.mark.parametrize("routing", ["owner", "psum"])
def test_payload_routing_modes_identical(ranks, routing):
    for r in ranks:
        assert r["bad"]["routing-" + routing] == []


def test_owner_routing_overflow_falls_back_exactly(ranks):
    """128 identical seeds: every request has one owner and overflows its
    bucket (m = 96 a rank, capacity 56); the psum fallback keeps the
    answer exact, and it ran (the psum of the overflow count, then the
    fallback's stitch)."""
    for r in ranks:
        assert r["bad"]["overflow"] == []
        calls = r["overflow_calls"]
        assert calls["all_to_all"][0] == 4  # two exchanges, two payloads
        assert calls["all_gather"][0] == 2


@pytest.mark.parametrize("need_dist", [False, True])
def test_sharded_subgraph_matches_single_device(ranks, need_dist):
    case = "subgraph-%s" % need_dist
    for r in ranks:
        assert r["bad"][case] == []
        assert r[case + "-edges"] > 0


def test_sharded_plan_valid_under_data_parallelism(ranks):
    """(2, 2): every sampled neighbour is a true one, the edge ids are
    global and consistent with (src, dst), the feature rows and edge
    weights are the table's."""
    for r in ranks:
        assert r["dp"]["dp-random"] == dict(
            true_neighbours=True, eids_consistent=True, feats=True,
            weights=True)


def test_owner_routing_under_data_parallelism(ranks):
    for r in ranks:
        assert r["dp"]["dp-owner"] == dict(feats=True)


def test_sharded_subgraph_data_parallel_stacks(ranks):
    for r in ranks:
        dp = r["dp"]["dp-subgraph"]
        assert dp["bad"] == [[], []]
        assert dp["shape"] == (2, 4) and dp["edges"] > 0


def test_partitioned_train_step_runs(ranks):
    """Three steps on a repeated batch over (2, 2): the loss falls, and
    every rank ends with the same parameters (rtol 0: the gradients are
    averaged over the data axis and the graph ranks compute alike)."""
    import torch
    for r in ranks:
        losses = r["dp"]["train"]["losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    p0 = ranks[0]["dp"]["train"]["params"]
    for r in ranks[1:]:
        assert torch.equal(r["dp"]["train"]["params"], p0)


# --- against the JAX package -------------------------------------------

CSR_KEYS = {"row_offsets": "row_offsets", "nbr_ids": "nbr_tiled",
            "nbr_edge_ids": "eid_tiled", "nbr_ids_sorted": "nbr_sorted_tiled",
            "nbr_edge_ids_sorted": "eid_sorted_tiled",
            "cum_weights": "cumw_tiled", "cum_in_degrees": "cumind_tiled",
            "nbr_ts": "ts_tiled"}


def _as_np(x):
    import torch
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def _jax_block(jst, p):
    import jax
    return jax.tree.map(lambda a: np.asarray(a)[p], jst.stacked)


def _check_block(tb, jb, where="", empty=False):
    """``empty``: a block of the store has no edge; the JAX build then
    drops the CDFs and edge timestamps from every block (its
    ``_build_csr`` gives None for an empty block) where the port keeps
    them, padding-only in the empty block (ROADMAP.md queue C)."""
    for k, tv in tb.items():
        if isinstance(tv, dict):
            if k in ("out", "inc"):
                for tk, jk in CSR_KEYS.items():
                    if tk in tv and jk not in jb[k] and tk in (
                            "cum_weights", "cum_in_degrees", "nbr_ts"):
                        assert empty, (where, k, tk)
                        continue
                    assert (tk in tv) == (jk in jb[k]), (where, k, tk)
                    if tk in tv:
                        np.testing.assert_array_equal(
                            _as_np(tv[tk]), _as_np(jb[k][jk]).reshape(-1),
                            err_msg="%s %s.%s" % (where, k, tk))
            else:
                _check_block(tv, jb[k], where + "." + k, empty)
        else:
            np.testing.assert_array_equal(_as_np(tv), _as_np(jb[k]),
                                          err_msg=where + "." + k)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("variant", ["full", "minimal", "bf16", "slack"])
def test_sharded_blocks_match_jax(files, p, variant):
    """build_sharded_tables(..., shard=q) builds block q alone, equal to
    the JAX package's stacked[q] bit for bit (its ``*_tiled`` arrays
    flattened), with the same replicated arrays and metadata; and the
    bytes a device holds are the JAX figure less ``off_pairs``."""
    from graph_learn_tpu.config import conf as jconf
    from graph_learn_tpu.parallel.sharded_store import (
        build_sharded_tables as jbuild)
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables as tbuild)

    jg, tg = wts_graph(gl, files), wts_graph(glt, files)
    jq = wts_queries(gl, jg)["plan-edge_weight"]
    tq = wts_queries(glt, tg)["plan-edge_weight"]
    kw = dict(profile="minimal" if variant == "minimal" else None,
              slack=1.25 if variant == "slack" else 1.0)
    dtype = "bfloat16" if variant == "bf16" else "float32"
    old = (jconf.feature_dtype, glt.conf.feature_dtype)
    jconf.feature_dtype = glt.conf.feature_dtype = dtype
    try:
        jst = jbuild(jq, p, **kw)
        tall = tbuild(tq, p, **kw)
        ro = np.asarray(jst.stacked["edges"]["e"]["out"]["row_offsets"])
        empty = bool((ro[:, -1] == 0).any())
        assert empty == (variant == "slack")  # 64-row blocks of 50 nodes
        for q in range(p):
            tst = tbuild(tq, p, shard=q, **kw)
            assert tst.meta == jst.meta and tst.shards == (q,)
            _check_block(tst.block(q), _jax_block(jst, q), "shard%d" % q,
                         empty)
            _check_block(tall.block(q), _jax_block(jst, q), "all%d" % q,
                         empty)
        _check_block({"nodes": tall.repl["nodes"],
                      "edges": tall.repl["edges"]},
                     {"nodes": jst.repl["nodes"],
                      "edges": jst.repl["edges"]}, "repl")
    finally:
        jconf.feature_dtype, glt.conf.feature_dtype = old
    off_pairs = sum(np.asarray(jst.stacked["edges"][t][d]["off_pairs"]).nbytes
                    for t in jst.stacked["edges"]
                    for d in ("out", "inc") if d in jst.stacked["edges"][t])
    kept = 0
    if empty:  # the arrays the JAX build dropped
        kept = sum(tall.stacked["edges"]["e"][d][f].nbytes
                   for d in ("out", "inc") for f in ("cum_weights",
                                                     "cum_in_degrees",
                                                     "nbr_ts"))
    assert tall.bytes_per_device() == (jst.bytes_per_device()
                                       + (kept - off_pairs) // p)
    assert tst.bytes_per_device() == tall.bytes_per_device()


def test_per_device_bytes_shrink():
    """On a non-toy graph each device holds about 1/P of the store."""
    from graph_learn_tpu_torch.examples.scale_demo import nbytes
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables)
    rng = np.random.default_rng(0)
    n, deg, f = 2000, 10, 32
    g = glt.Graph(device="cpu")
    g.add_node_table(glt.NodeTable(
        "v", glt.Decoder(attr_types=["float"] * f),
        np.arange(n, dtype=np.int64),
        float_attrs=rng.random((n, f)).astype(np.float32)))
    src = np.repeat(np.arange(n), deg)
    dst = (src * 13 + np.tile(np.arange(deg), n) * 7) % n
    g.add_edge_table(glt.EdgeTable(
        "e", "v", "v", glt.Decoder(weighted=True), src=src, dst=dst,
        num_src_nodes=n, num_dst_nodes=n,
        weights=np.tile(np.arange(deg) + 1.0, n).astype(np.float32)))
    q = (g.V("v").batch(8).alias("src")
         .outV("e").sample(3).by("edge_weight").alias("h1").values())
    full = nbytes(q.device_tables("cpu"))
    per_dev = build_sharded_tables(q, 8).bytes_per_device()
    assert per_dev < full * 0.3, (per_dev, full)


def _jax_plan(files, p):
    import jax
    import jax.numpy as jnp
    from graph_learn_tpu.parallel.mesh import make_mesh
    from graph_learn_tpu.parallel.sharded_store import build_sharded_tables
    from graph_learn_tpu.parallel.train import make_partitioned_plan

    jg = wts_graph(gl, files)
    q = wts_queries(gl, jg)["topk-edges"]
    mesh = make_mesh(n_data=1, n_graph=p, devices=jax.devices()[:p])
    st = build_sharded_tables(q, p).place(mesh)
    plan = make_partitioned_plan(q, mesh, st)
    with jax.set_mesh(mesh):
        out = jax.jit(plan)(jnp.arange(8, dtype=jnp.int32),
                            jax.random.key(5))
    return jax_flat_result(out)


@pytest.mark.parametrize("p", [2, 4])
def test_topk_partitioned_plan_matches_jax(ranks, files, p):
    """The topk plan (ids, degrees, edge ids and fields, routed feature
    rows) equals the JAX package's partitioned plan bit for bit: at P = 4
    on mesh (1, 4), at P = 2 as the two data slices of mesh (2, 2)."""
    import torch
    want = _jax_plan(files, p)
    if p == 4:
        got = ranks[0]["jax"]["1x4"]
    else:  # data slices 0 and 1 live on ranks 0 and 2
        a, b = ranks[0]["jax"]["2x2"], ranks[2]["jax"]["2x2"]
        got = {k: torch.cat([a[k], b[k]]) for k in a}
    common = sorted(set(got) & set(want))
    for k in ("src.ids", "src.out_degrees", "src.float_attrs", "h1.ids",
              "h1.float_attrs", "h1.labels", "e2.edge_ids", "e2.weights",
              "e2.timestamps", "e2.dst_nodes.ids",
              "e2.dst_nodes.float_attrs", "e2.src_nodes.raw_ids"):
        assert k in common, k
    for k in common:
        g = got[k].numpy()
        w = want[k]
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(
            g.astype(np.float64 if g.dtype.kind == "f" else np.int64),
            w.astype(np.float64 if w.dtype.kind == "f" else np.int64),
            err_msg=k)


def test_bytes_per_device_leave_out_condition_tables(files):
    """With a ``.where()`` node the JAX figure also counts the replicated
    condition tables; the port's leaves them out (ROADMAP.md queue C)."""
    import jax
    from graph_learn_tpu.parallel.sharded_store import (
        build_sharded_tables as jbuild)
    from graph_learn_tpu_torch.parallel.sharded_store import (
        build_sharded_tables as tbuild)
    jq = wts_queries(gl, wts_graph(gl, files))["conditional"]
    tq = wts_queries(glt, wts_graph(glt, files))["conditional"]
    jst, tst = jbuild(jq, 2), tbuild(tq, 2)
    cond = sum(np.asarray(x).nbytes
               for x in jax.tree.leaves(jst.repl["cond"]))
    off_pairs = sum(np.asarray(jst.stacked["edges"][t][d]["off_pairs"])
                    .nbytes for t in jst.stacked["edges"]
                    for d in ("out", "inc"))
    assert cond > 0
    assert tst.bytes_per_device() == (jst.bytes_per_device() - cond
                                      - off_pairs // 2)
