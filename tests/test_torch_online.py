"""The port's online tier on one device: streaming updates, copy-on-write
refresh, exported serving programs and installed-query serving, each case
of tests/test_online.py but the partitioned ones, on the CPU; plus the
update sequence through both packages, bit for bit, and logs that cross
between them."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import graph_learn_tpu_torch as glt
from graph_learn_tpu.online import update as jupdate
from graph_learn_tpu_torch.gsl.compile import _execute
from graph_learn_tpu_torch.online.export import (export_serving_fn,
                                                 load_serving_exported,
                                                 load_serving_fn)
from graph_learn_tpu_torch.online import update as tupdate
from graph_learn_tpu_torch.online.serving import QueryService, _Pending
from graph_learn_tpu_torch.online.update import (UpdateBuffer, UpdateLog,
                                                 apply_updates, expire_edges)
from torch_parity import store_equal


def _port_graph(paths):
    g = glt.Graph(device="cpu")
    g.node(paths["node"], node_type="item",
           decoder=glt.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(paths["edge"], edge_type=("item", "item", "rel"),
           decoder=glt.Decoder(weighted=True))
    return g.init()


def _jax_graph(paths):
    g = gl.Graph()
    g.node(paths["node"], node_type="item",
           decoder=gl.Decoder(weighted=True, labeled=True,
                              attr_types=["float"] * 4))
    g.edge(paths["edge"], edge_type=("item", "item", "rel"),
           decoder=gl.Decoder(weighted=True))
    return g.init()


@pytest.fixture
def g(tmp_graph_dir):
    return _port_graph(tmp_graph_dir)


def _ids(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- updates (tests/test_online.py:23-67) ----------------------------------

def test_add_edges_visible_after_refresh(g):
    n0 = g.store.edge_table("rel").num_edges
    buf = UpdateBuffer()
    buf.add_edges("rel", src_ids=[0, 0, 0], dst_ids=[390, 380, 370],
                  weights=[9.0, 8.0, 7.0])
    apply_updates(g, buf)
    assert g.store.edge_table("rel").num_edges == n0 + 3
    assert g.out_degrees(np.array([0]), "rel")[0] == 1 + 3
    assert buf.empty


def test_add_nodes_then_edges(g):
    n0 = g.store.node_table("item").num_nodes
    buf = UpdateBuffer()
    buf.add_nodes("item", ids=[10_000, 10_010], weights=[1.0, 1.0],
                  labels=[2, 3], float_attrs=np.ones((2, 4), np.float32))
    apply_updates(g, buf)
    t = g.store.node_table("item")
    assert t.num_nodes == n0 + 2
    # the edge table grew its row space with the node table
    assert g.store.edge_table("rel").num_src_nodes == n0 + 2
    buf.add_edges("rel", src_ids=[10_000], dst_ids=[10_010], weights=[1.0])
    apply_updates(g, buf)
    assert g.out_degrees(np.array([10_000]), "rel")[0] == 1


def test_duplicate_node_add_rejected(g):
    buf = UpdateBuffer()
    buf.add_nodes("item", ids=[0], weights=[1.0], labels=[0],
                  float_attrs=np.ones((1, 4), np.float32))
    with pytest.raises(glt.InvalidArgumentError, match="new nodes only"):
        apply_updates(g, buf)


def test_update_log_replay(g, tmp_path):
    log = UpdateLog(str(tmp_path / "updates.jsonl"))
    log.append_edges("rel", src_ids=[0], dst_ids=[100], weights=[5.0])
    log.append_edges("rel", src_ids=[10], dst_ids=[200], weights=[5.0])
    assert log.offset() == 2
    buf = UpdateBuffer()
    assert log.replay(buf) == 2
    n0 = g.store.edge_table("rel").num_edges
    apply_updates(g, buf)
    assert g.store.edge_table("rel").num_edges == n0 + 2
    part = UpdateBuffer()
    assert log.replay(part, start=1, upto=2) == 1
    assert part.edge_updates["rel"][0]["src_ids"].tolist() == [10]


def _ttl_files(d):
    with open(d / "n", "w") as f:
        f.write("id:int64\n")
        for i in range(10):
            f.write("%d\n" % i)
    with open(d / "e", "w") as f:
        f.write("src_id:int64\tdst_id:int64\ttimestamp:int64\n")
        for i in range(10):
            for j in range(3):
                f.write("%d\t%d\t%d\n" % (i, (i + j + 1) % 10,
                                          1000 + i * 10 + j))
    return str(d / "n"), str(d / "e")


def test_expire_edges_ttl(tmp_path):
    n, e = _ttl_files(tmp_path)
    g = (glt.Graph(device="cpu").node(n, "v", glt.Decoder())
         .edge(e, ("v", "v", "e"), glt.Decoder(timestamped=True))).init()
    assert g.store.edge_table("e").num_edges == 30
    dropped = expire_edges(g, older_than=1050)
    assert dropped == {"e": 15}  # ts 1000..1042 below 1050: nodes 0-4
    et1 = g.store.edge_table("e")
    assert et1.num_edges == 15
    assert int((et1.timestamps + et1.ts_base).min()) >= 1050
    q = (g.V("v").batch(10).alias("s")
         .outV("e").sample(2).by("topk").alias("h").values())
    out = glt.Dataset(q, window=1, device="cpu").next()
    # nodes 0..3 fully expired -> default neighbour fill (id 0)
    assert np.all(_ids(out["h"].ids)[:4] == 0)
    with pytest.raises(glt.InvalidArgumentError, match="not timestamped"):
        expire_edges(_port_graph_no_ts(tmp_path), 0, ["e"])


def _port_graph_no_ts(d):
    n, e = str(d / "n"), str(d / "e2")
    with open(e, "w") as f:
        f.write("src_id:int64\tdst_id:int64\n0\t1\n")
    return (glt.Graph(device="cpu").node(n, "v", glt.Decoder())
            .edge(e, ("v", "v", "e"), glt.Decoder())).init()


def test_expire_edges_drops_the_reverse_twin(tmp_path):
    n, e = _ttl_files(tmp_path)
    with open(tmp_path / "u", "w") as f:
        f.write("id:int64\n")
        for i in range(5):
            f.write("%d\n" % i)
    with open(tmp_path / "ue", "w") as f:
        f.write("src_id:int64\tdst_id:int64\ttimestamp:int64\n")
        for i in range(5):
            f.write("%d\t%d\t%d\n" % (i, i + 3, 100 + i))
    g = (glt.Graph(device="cpu").node(str(tmp_path / "u"), "u", glt.Decoder())
         .node(n, "v", glt.Decoder())
         .edge(str(tmp_path / "ue"), ("u", "v", "uv"),
               glt.Decoder(timestamped=True), directed=False)).init()
    assert expire_edges(g, 103, ["uv"]) == {"uv": 3, "uv_reverse": 3}
    assert g.store.edge_table("uv_reverse").num_edges == 2


# --- the update sequence through both packages ------------------------------

def _sequence(mod, g, log_path):
    """Nodes with payloads, edges onto them, a logged replay, a TTL
    expiry: one sequence of the online update API of ``mod``."""
    buf = mod.UpdateBuffer()
    buf.add_nodes("item", ids=[5000, 5010, 5020], weights=[0.5, 0.25, 2.0],
                  labels=[1, 2, 3],
                  float_attrs=np.arange(12, dtype=np.float32).reshape(3, 4))
    mod.apply_updates(g, buf)
    buf.add_edges("rel", src_ids=[0, 5000, 5010, 390],
                  dst_ids=[5020, 0, 5000, 5010], weights=[3.0, 0.0, 1.5, 7.0])
    buf.add_edges("rel", src_ids=[5020], dst_ids=[10], weights=[0.125])
    mod.apply_updates(g, buf)
    log = mod.UpdateLog(log_path)
    log.append_nodes("item", ids=[6000], weights=[1.0], labels=[4],
                     float_attrs=np.ones((1, 4), np.float32))
    log.append_edges("rel", src_ids=[6000, 6000], dst_ids=[0, 10],
                     weights=[2.0, 4.0])
    return log


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_the_update_sequence_is_bit_equal_to_jax(tmp_graph_dir, tmp_path,
                                                 writer):
    """The same UpdateBuffer / UpdateLog sequence through both packages:
    node and edge tables, the flat CSR views (nbr_ids, nbr_edge_ids,
    cum_weights, both directions), the pools and the id indexes are
    bit-equal; a log written by one package replays in the other."""
    tg, jg = _port_graph(tmp_graph_dir), _jax_graph(tmp_graph_dir)
    tlog = _sequence(tupdate, tg, str(tmp_path / "t.jsonl"))
    jlog = _sequence(jupdate, jg, str(tmp_path / "j.jsonl"))
    with open(tlog.path) as a, open(jlog.path) as b:
        assert a.read() == b.read()  # the same records, byte for byte
    # each package replays the log the other one wrote
    src = jlog if writer == "jax" else tlog
    tbuf, jbuf = UpdateBuffer(), jupdate.UpdateBuffer()
    assert UpdateLog(src.path).replay(tbuf) == 2
    assert jupdate.UpdateLog(src.path).replay(jbuf) == 2
    apply_updates(tg, tbuf)
    jupdate.apply_updates(jg, jbuf)
    store_equal(tg, jg)
    raw = tg.store.node_table("item").raw_ids
    np.testing.assert_array_equal(
        tg.store.node_table("item").index.lookup(raw),
        jg.store.node_table("item").index.lookup(raw))


def test_timestamped_updates_and_expiry_are_bit_equal_to_jax(tmp_path):
    n, e = _ttl_files(tmp_path)
    tg = (glt.Graph(device="cpu").node(n, "v", glt.Decoder())
          .edge(e, ("v", "v", "e"), glt.Decoder(timestamped=True))).init()
    jg = (gl.Graph().node(n, "v", gl.Decoder())
          .edge(e, ("v", "v", "e"), gl.Decoder(timestamped=True))).init()
    for mod, g in ((tupdate, tg), (jupdate, jg)):
        buf = mod.UpdateBuffer()
        buf.add_nodes("v", ids=[20, 21])
        mod.apply_updates(g, buf)  # the edge table is rebuilt over 12 rows
        # new edges older than the table's base move the base down
        buf.add_edges("e", src_ids=[20, 21, 3],
                      dst_ids=[21, 3, 20], timestamps=[900, 5000, 1001])
        mod.apply_updates(g, buf)
        # node 0's three edges, 900 and 1001
        assert mod.expire_edges(g, older_than=1005) == {"e": 5}
    store_equal(tg, jg)
    a, b = tg.store.edge_table("e"), jg.store.edge_table("e")
    assert (a.ts_base, a.ts_scale) == (b.ts_base, b.ts_scale)
    np.testing.assert_array_equal(a.device("cpu").out.nbr_ts.numpy(),
                                  np.asarray(b.device().out.nbr_ts))


# --- serving (tests/test_online.py:70-110, 217-379) ------------------------

def test_query_service_serving(g):
    q = (g.V("item").batch(8).alias("src")
         .outV("rel").sample(3).by("random").alias("h1")
         .outV("rel").sample(2).by("topk").alias("h2").values())
    svc = QueryService(g, device="cpu")
    try:
        qid = svc.install(q, micro_batch=8)
        out = svc.run(qid, np.array([0, 10, 20, 30, 40]))
        assert out["src"].ids.shape[0] == 5
        assert tuple(out["h1"].ids.shape) == (5, 3)
        assert tuple(out["h2"].ids.shape) == (5, 3, 2)
        buf = UpdateBuffer()
        buf.add_edges("rel", src_ids=[0] * 5,
                      dst_ids=[100, 110, 120, 130, 140], weights=[9.0] * 5)
        apply_updates(g, buf)
        svc.refresh()
        out2 = svc.run(qid, np.array([0]))
        assert tuple(out2["h1"].ids.shape) == (1, 3)
        # node 0 now has 6 out-edges, each a true neighbour
        assert int(out2["src"].out_degrees[0]) == 6
        assert svc.stats(qid)["qps"] > 0
    finally:
        svc.close()


def test_plan_roundtrip(g):
    from graph_learn_tpu_torch.gsl.plan import plan_to_query, query_to_plan
    q = (g.V("item").batch(6).alias("src")
         .outV("rel").sample(3).by("topk").alias("hop1")
         .outNeg("rel").sample(2).by("in_degree").alias("neg")
         .values())
    plan = json.loads(json.dumps(query_to_plan(q)))  # through the wire
    q2 = plan_to_query(g, plan)
    seeds = torch.arange(6, dtype=torch.int32)
    out1 = q.run(seeds, torch.Generator().manual_seed(3))
    out2 = q2.run(seeds, torch.Generator().manual_seed(3))
    assert set(out1) == set(out2) == {"src", "hop1", "neg"}
    for a in ("hop1", "neg"):
        assert torch.equal(out1[a].ids, out2[a].ids)


def test_coalescer_batches_concurrent_requests(g):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("h1").values())
    svc = QueryService(g, device="cpu")
    qid = svc.install(q, micro_batch=16)
    iq = svc._queries[qid]
    iq.close()  # stop the live worker; drive _serve_once by hand
    calls = []
    orig = iq._execute_batch
    iq._execute_batch = lambda ids: (calls.append(ids.size), orig(ids))[1]
    pend = [_Pending(np.array([i * 10, i * 10 + 10], np.int64))
            for i in range(3)]
    for p in pend:
        iq._queue.put(p)
    assert iq._serve_once()  # one round
    assert calls == [6]  # 3 requests x 2 ids -> one 6-id launch
    for p in pend:
        assert p.error is None
        assert tuple(p.result["src"].ids.shape) == (2,)
        assert tuple(p.result["h1"].ids.shape) == (2, 3)
    assert len(iq.latencies) == 3 and iq.served == 6


def test_refresh_is_copy_on_write(g):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("h1").values())
    svc = QueryService(g, device="cpu")
    qid = svc.install(q, micro_batch=8)
    iq = svc._queries[qid]
    snap0 = iq._snap
    out0 = svc.run(qid, np.array([100]))
    buf = UpdateBuffer()
    buf.add_edges("rel", src_ids=[100, 100], dst_ids=[390, 380],
                  weights=[9.0, 8.0])
    apply_updates(g, buf)
    svc.refresh()
    assert iq._snap is not snap0  # a new snapshot object
    # the old snapshot still evaluates: nothing was changed in place
    old_out = _execute(q, snap0.tables, torch.full((8,), 10, dtype=torch.int32),
                       iq._generator)
    assert tuple(old_out["h1"].ids.shape) == (8, 3)
    assert snap0.tables["edges"]["rel"].out.num_edges + 2 == \
        iq._snap.tables["edges"]["rel"].out.num_edges
    out1 = svc.run(qid, np.array([100]))
    top = set(_ids(out1["h1"].ids)[0].tolist())
    assert {39, 38} <= top  # the new heavy edges lead topk
    assert set(_ids(out0["h1"].ids)[0].tolist()) != top
    svc.close()


def test_a_round_reads_one_snapshot_while_refresh_runs(g, monkeypatch):
    """A round of two micro-batches with a refresh landing between them
    answers both from the snapshot it read first."""
    from graph_learn_tpu_torch.online import serving
    q = (g.V("item").batch(2).alias("src")
         .outV("rel").sample(3).by("topk").alias("h1").values())
    svc = QueryService(g, device="cpu")
    try:
        qid = svc.install(q, micro_batch=2)
        before = _ids(svc.run(qid, [100])["h1"].ids)[0].tolist()
        buf = UpdateBuffer()
        buf.add_edges("rel", src_ids=[100] * 3, dst_ids=[390, 380, 370],
                      weights=[9.0, 8.0, 7.0])
        apply_updates(g, buf)
        real, calls = serving._execute, []

        def execute_then_refresh(*a):
            out = real(*a)
            calls.append(len(calls))
            if len(calls) == 1:
                svc.refresh()  # lands after the round's first chunk
            return out

        monkeypatch.setattr(serving, "_execute", execute_then_refresh)
        old = _ids(svc.run(qid, [100, 100, 100, 100])["h1"].ids)
        assert len(calls) == 2
        assert all(row.tolist() == before for row in old)
        after = _ids(svc.run(qid, [100])["h1"].ids)[0].tolist()
        assert set(after) == {39, 38, 37}
    finally:
        svc.close()


def test_subgraph_serving_not_coalesced(g):
    q = (g.V("item").batch(4).alias("src")
         .SubGraph("rel").alias("sg").values())
    svc = QueryService(g, device="cpu")
    qid = svc.install(q, micro_batch=16)
    iq = svc._queries[qid]
    assert iq._seed_aligned is False
    a_ids = np.array([0, 10], np.int64)
    b_ids = np.array([200, 210, 220], np.int64)
    oracle_a = iq.run(a_ids)
    oracle_b = iq.run(b_ids)
    iq.close()
    pa, pb = _Pending(a_ids), _Pending(b_ids)
    iq._queue.put(pa)
    iq._queue.put(pb)
    assert iq._serve_once()  # serves ONLY pa (no coalescing)
    assert pa.error is None and pb.result is None
    assert iq._serve_once()
    assert pb.error is None
    for p, oracle in ((pa, oracle_a), (pb, oracle_b)):
        n = int(p.result["sg"].num_nodes)
        assert n == int(oracle["sg"].num_nodes)
        assert (_ids(p.result["sg"].node_ids)[:n].tolist()
                == _ids(oracle["sg"].node_ids)[:n].tolist())
    assert _ids(pa.result["src"].ids).shape[0] == 2
    assert _ids(pb.result["src"].ids).shape[0] == 3


def test_subgraph_serving_rejects_oversized_request(g):
    q = (g.V("item").batch(4).alias("src")
         .SubGraph("rel").alias("sg").values())
    svc = QueryService(g, device="cpu")
    qid = svc.install(q, micro_batch=4)
    with pytest.raises(glt.InvalidArgumentError):
        svc.run(qid, np.arange(8, dtype=np.int64) * 10)
    svc.close()


def test_partitioned_serving_is_not_yet_ported(tmp_graph_dir):
    """The partitioned branch is ported (the name is the refusal's this
    test once pinned): QueryService(graph_shards=2) on two gloo ranks
    answers the JAX one-device service's topk, value for value, and
    serves a streamed update after refresh(); the other cases are in
    tests/test_torch_partitioned_serving.py."""
    import torch_parity
    from graph_learn_tpu.online.serving import QueryService as JaxService
    from graph_learn_tpu_torch.parallel.launch import spawn
    before, after = spawn(torch_parity.online_partitioned_ranks, 2,
                          device="cpu", args=(tmp_graph_dir,),
                          timeout_s=120, threads=1)[0]
    jg = _jax_graph(tmp_graph_dir)
    jsvc = JaxService(jg)
    q = (jg.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("h1").values())
    want = jsvc.run(jsvc.install(q, micro_batch=4), [0, 10, 20, 390, 70])
    jsvc.close()
    np.testing.assert_array_equal(before["h1.ids"].numpy(),
                                  np.asarray(want["h1"].ids))
    np.testing.assert_array_equal(before["h1.float_attrs"].numpy(),
                                  np.asarray(want["h1"].float_attrs))
    assert 39 in after and 38 in after


# --- export (tests/test_online.py:155-181) --------------------------------

def _toy_serve(q, tables):
    def serve(seeds, generator):
        out = _execute(q, tables, seeds, generator)
        # toy "embedding": the mean of the neighbours' rows after the
        # seed's (both gathered by Kernel 1's operator)
        nbr = out["hop1"].float_attrs.materialize().mean(dim=1)
        return torch.cat([out["src"].float_attrs.materialize(), nbr], dim=-1)
    return serve


def test_export_serving_fn(g, tmp_path):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("random").alias("hop1").values())
    serve = _toy_serve(q, q.device_tables("cpu"))
    seeds = np.arange(4)
    path = str(tmp_path / "serving.pt2")
    blob = export_serving_fn(serve, (seeds, 0), path=path, device="cpu")
    with open(path, "rb") as f:
        assert f.read() == blob
    call = load_serving_fn(path)
    out = call(seeds, 0)
    assert torch.equal(out, call(seeds, 0))  # one seed, one answer
    # the program draws what the function draws from the same seed
    torch.manual_seed(0)
    ref = serve(torch.as_tensor(seeds, dtype=torch.int32), None)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5)
    exp = load_serving_exported(blob)
    assert tuple(exp.example_seeds.shape) == (4,)
    assert exp.example_seeds.dtype == torch.int32


def test_export_leaves_the_process_random_state_alone(g):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("random").alias("hop1").values())
    call = load_serving_fn(export_serving_fn(
        _toy_serve(q, q.device_tables("cpu")), (np.arange(4), 0),
        device="cpu"))
    state = torch.random.get_rng_state()
    a, b = call(np.arange(4), 1), call(np.arange(4), 2)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert not torch.equal(a, b)  # another seed, other draws


def test_a_stablehlo_artifact_is_refused(tmp_graph_dir, g):
    """A JAX serving artifact is not a torch.export program: loading or
    installing it raises InvalidArgumentError."""
    from graph_learn_tpu.gsl.compile import _execute as jax_execute
    from graph_learn_tpu.online.export import export_serving_fn as jexport
    jg = _jax_graph(tmp_graph_dir)
    q = (jg.V("item").batch(4).alias("src")
         .outV("rel").sample(3).by("topk").alias("hop1").values())
    tables = q.device_tables()
    blob = jexport(lambda s, k: jax_execute(q, tables, s, k)["hop1"].ids,
                   (jnp.arange(4, dtype=jnp.int32), jax.random.key(0)))
    with pytest.raises(glt.InvalidArgumentError, match="torch.export"):
        load_serving_exported(blob)
    svc = QueryService(g, device="cpu")
    try:
        with pytest.raises(glt.InvalidArgumentError, match="torch.export"):
            svc.install_model("jax", blob)
        with pytest.raises(glt.NotFoundError):
            svc.predict("jax", [0])
    finally:
        svc.close()


@pytest.mark.parametrize("kernel", ["gat_block", "sweep_aggregate",
                                    "stream_sum"])
def test_export_keeps_kernels_3_to_5_as_operators(kernel):
    """A serving function that reaches Kernels 3-5 exports: the program
    holds the kernel as its glt operator and gives the eager answer."""
    from graph_learn_tpu_torch.ops.kernels import gat, sweep
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, wn, ar, el, table = t(4, 3, 2), t(2, 2, 5), t(2, 5), t(2, 4), t(40, 3)

    def gat_fn(seeds, generator):
        return gat.gat_block(x[seeds.long()], wn, ar, el)

    def sweep_fn(seeds, generator):
        starts, packed = sweep.sweep_prep(seeds.repeat(3), 3, 40, R=16)
        return sweep.sweep_aggregate(starts, packed, table, 4, 16)

    def sum_fn(seeds, generator):
        return sweep.stream_sum(table[seeds.long()])

    fn = {"gat_block": gat_fn, "sweep_aggregate": sweep_fn,
          "stream_sum": sum_fn}[kernel]
    seeds = np.array([3, 0, 2, 1])
    exp = load_serving_exported(
        export_serving_fn(fn, (seeds, 0), device="cpu"))
    ops = [str(n.target) for n in exp.program.graph.nodes
           if n.op == "call_function"]
    assert ops.count("glt.%s.default" % kernel) == 1
    want = fn(torch.as_tensor(seeds, dtype=torch.int32), None)
    got = exp.call(seeds, 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_the_exported_program_holds_the_kernel_operators(g):
    """Exported on the CPU, the EgoGraphSAGE serving function keeps the
    feature gathers and the deepest-hop mean as glt operators; two calls
    with one seed are equal."""
    from graph_learn_tpu_torch.nn.data import EgoGraph
    from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGraphSAGE
    q = (g.V("item").batch(8).alias("src")
         .outV("rel").sample(3).by("random").alias("hop1")
         .outV("rel").sample(2).by("random").alias("hop2").values())
    tables = q.device_tables("cpu")
    dec = g.get_node_decoder("item")
    model = EgoGraphSAGE([4, 8, 3], dec, agg_type="gcn", device="cpu")

    def serve(seeds, generator):
        ans = _execute(q, tables, seeds, generator)
        return model(EgoGraph.from_query_result(
            ans, "src", ["hop1", "hop2"],
            defer_last_table=tables["nodes"]["item"].float_attrs))

    exp = load_serving_exported(export_serving_fn(
        serve, (np.arange(8), 0), device="cpu"))
    targets = [str(n.target) for n in exp.program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("glt.gather_rows.default") == 2
    assert targets.count("glt.segment_spmm.default") == 1
    a, b = exp.call(np.arange(8), 5), exp.call(np.arange(8), 5)
    assert a.shape == (8, 3) and torch.equal(a, b)
    with torch.no_grad():
        torch.manual_seed(5)
        ref = serve(torch.arange(8, dtype=torch.int32), None)
    torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-6)


def test_the_committed_stablehlo_fixture_is_a_jax_artifact(tmp_path):
    """tests/fixtures/jax_serving.stablehlo (the artifact chip_smoke.py
    phase 22 posts to /admin/model) is a JAX serving artifact that the JAX
    package loads and calls, and the port refuses."""
    from graph_learn_tpu.online.export import (export_serving_fn as jexport,
                                               load_serving_exported as jload)
    path = "tests/fixtures/jax_serving.stablehlo"
    exp = jload(path)
    assert exp.in_avals[0].shape == (4,)
    out = exp.call(jnp.arange(4, dtype=jnp.int32), jax.random.key(0))
    assert out.shape == (4,)
    # the fixture is what this toy serving function exports to
    blob = jexport(lambda s, k: (s * 2 + jax.random.randint(
        k, s.shape, 0, 3)).astype(jnp.float32),
        (jnp.arange(4, dtype=jnp.int32), jax.random.key(0)))
    with open(path, "rb") as f:
        assert jload(bytes(blob)).in_avals == jload(f.read()).in_avals
    with pytest.raises(glt.InvalidArgumentError, match="torch.export"):
        load_serving_exported(path)
