"""The port's partitioned serving tier (online/serving.py with
``graph_shards > 1``) against the JAX package's tests/test_online.py:381-543
and against the port's one-rank service.

The ranks are gloo processes on the CPU (parallel/launch.py spawn); each
builds the service, rank 0 leads and the others follow.  One spawn of two
ranks and one of four run every case once for the module
(tests/torch_parity.py ``partitioned_serving_ranks``); the JAX services
(one device and ``graph_shards=8`` on the 8 virtual CPU devices) run in
this process on the same files.  Tolerances: ids equal, feature rows
within ``rtol=1e-6`` of the JAX package's (the JAX test's), and bit for
bit against the port's one-rank service.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import graph_learn_tpu as gl
import torch_parity
from torch_parity import (INC_REFRESHES, PART_IDS, part_topk,
                          partition_graph, write_partition_files)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_partition_files(str(tmp_path_factory.mktemp("part")))


def _spawn(files, world):
    from graph_learn_tpu_torch.parallel.launch import spawn
    return spawn(torch_parity.partitioned_serving_ranks, world,
                 device="cpu", args=(files,), timeout_s=120, threads=1)


@pytest.fixture(scope="module")
def ranks(files):
    return {2: _spawn(files, 2), 4: _spawn(files, 4)}


@pytest.fixture(scope="module")
def jax_topk(files):
    """The JAX services' topk answers at the test's ids: one device, and
    the partitioned store over 8 virtual devices."""
    from graph_learn_tpu.online.serving import QueryService
    out = {}
    for shards in (1, 8):
        g = partition_graph(gl, files["part"])
        svc = QueryService(g, graph_shards=shards)
        ans = svc.run(svc.install(part_topk(g), micro_batch=8), PART_IDS)
        out[shards] = (np.asarray(ans["h1"].ids),
                       np.asarray(ans["h1"].float_attrs, np.float32))
        svc.close()
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shards", [1, 8])
def test_topk_answers_equal_the_jax_services(ranks, jax_topk, world, shards):
    ids, rows = ranks[world][0]["topk"]
    want_ids, want_rows = jax_topk[shards]
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(rows.numpy(), want_rows, rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_holds_part_of_the_store(ranks, world):
    """``bytes_per_device`` against the whole store's device bytes: below
    0.3 at four ranks (the JAX test's bound at eight), below 0.6 at two;
    the block rank 0 placed (with the serving slack's tail rows) below
    the whole store."""
    part, full = ranks[world][0]["bytes"]
    bound = 0.3 if world == 4 else 0.6
    assert part < bound * full, (part, full)
    assert ranks[world][0]["block"] < full


@pytest.mark.parametrize("world", [2, 4])
def test_a_streamed_update_is_served_after_refresh(ranks, world):
    assert set(ranks[world][0]["after"][0].tolist()) == {42, 43, 44}


def test_random_answers_equal_the_one_rank_service(ranks):
    """Requests of 1..20 ids at micro-batch 8 (up to three rounds each):
    every value of every alias bit-equal to the one-rank service's, both
    generators seeded with conf.seed."""
    assert ranks[2][0]["random_bad"] == [[]] * len(
        torch_parity.PART_RANDOM_SIZES)


def test_refused_requests_leave_the_ranks_in_step(ranks):
    """Unknown ids and a SubGraph request over the micro-batch are refused
    on the leader before anything is sent; the next request is served,
    equal to the one-rank service's."""
    r = ranks[2][0]
    assert r["refused"] == ["not found", "not found", "oversized"]
    assert r["after_refusals"] == []


def test_subgraph_queries_take_one_round_a_request(ranks):
    r = ranks[2][0]
    assert r["sg_rounds"] == 2
    assert r["sg_bad"] == [[], []]


def test_close_ends_every_follower(ranks):
    """Each service's close ended its followers' follow(): three services
    at two ranks, one at four (every rank returned)."""
    assert [r["followed"] for r in ranks[2][1:]] == [3]
    assert [r["followed"] for r in ranks[4][1:]] == [1, 1, 1]


def test_models_stay_on_the_leader_and_the_mesh_is_one_row(ranks):
    """A follower refuses install_model (exported models are served by the
    leader alone, on one device); a mesh with a data axis is refused on
    every rank before any group of the service is made."""
    for world in (2, 4):
        assert all(r.get("model_refused") for r in ranks[world][1:])
    assert all("mesh (1, P)" in r["data_axis"] for r in ranks[4])


def test_incremental_refresh_under_concurrent_clients(ranks):
    """tests/test_online.py:449-543 at two ranks: six clients keep their
    oracle answers during five refreshes, each refresh uploads at most
    full / P summed over the ranks, and the streamed edges lead the
    answer after."""
    inc = ranks[2][0]["inc"]
    assert not inc["errors"], inc["errors"][:5]
    assert len(inc["uploads"]) == INC_REFRESHES
    for up in inc["uploads"]:
        assert up <= inc["full"] / 2, (up, inc["full"])
    assert set(inc["final"]) <= {42, 43, 44, 45, 46}
    assert 42 + INC_REFRESHES - 1 in inc["final"]


def test_every_rank_holds_a_fresh_build_after_each_refresh(ranks):
    """After each refresh, rank p's placed block is bit-equal to
    build_sharded_tables(leader's graph, P, slack, shard=p)'s block."""
    inc = ranks[2][0]["inc"]
    follower = ranks[2][1]["blocks"]
    assert len(follower) == INC_REFRESHES
    for k in range(INC_REFRESHES):
        for p, placed in ((0, inc["leader"][k]), (1, follower[k])):
            fresh = inc["fresh"][k][p]
            assert sorted(placed) == sorted(fresh)
            for path, x in placed.items():
                assert torch.equal(x, fresh[path][0]), (k, p, path)


@pytest.mark.parametrize("mode", ["killed", "refused"])
def test_a_dead_follower_fails_the_leaders_run(mode):
    """A follower killed in the middle of a round: the leader's run raises
    within seconds, not at a deadline.  A follower whose refresh raises
    (and whose process lives on): the leader's refresh raises at once.
    The service then refuses every request."""
    from graph_learn_tpu_torch.parallel import launch
    where, procs = launch.start(torch_parity.dead_follower_rank, (0, 1),
                                (mode,))
    report = os.path.join(where, "leader.json")
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(report) and time.monotonic() < deadline:
            time.sleep(0.1)
        with open(report) as f:
            out = json.load(f)
    finally:
        launch.stop(procs, where)
    assert "error" not in out, out.get("error")
    assert out["first"] == 3
    assert out["second"] is not None and out["second_s"] < 20, out
    if mode == "refused":
        assert "failed command" in out["second"], out
    assert "out of step" in out["third"] and out["third_s"] < 1, out
