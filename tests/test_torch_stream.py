"""The port's streaming transport: topics, producers, pollers, bulk load
and the loader CLI, each case of tests/test_stream.py on the CPU; plus
partition_of bit for bit against the JAX package and topics that one
package writes and the other reads."""

import json
import threading

import numpy as np
import pytest

import graph_learn_tpu_torch as glt
from graph_learn_tpu.online import stream as jstream
from graph_learn_tpu.online import update as jupdate
from graph_learn_tpu_torch.online import stream as tstream
from graph_learn_tpu_torch.online.serving import QueryService
from graph_learn_tpu_torch.online.stream import (FileTopic, KafkaTopic,
                                                 RecordPoller, StreamProducer,
                                                 bulk_load, ingest,
                                                 partition_of)
from graph_learn_tpu_torch.online.update import UpdateBuffer


@pytest.fixture
def g(tmp_graph_dir):
    g = glt.Graph(device="cpu")
    g.node(tmp_graph_dir["node"], node_type="item",
           decoder=glt.Decoder(weighted=True, labeled=True,
                               attr_types=["float"] * 4))
    g.edge(tmp_graph_dir["edge"], edge_type=("item", "item", "rel"),
           decoder=glt.Decoder(weighted=True))
    return g.init()


def test_partition_of_deterministic_and_balanced():
    ids = np.arange(20_000)
    p1 = partition_of(ids, 8)
    np.testing.assert_array_equal(p1, partition_of(ids, 8))
    counts = np.bincount(p1, minlength=8)
    assert counts.min() > 0.8 * ids.size / 8
    assert counts.max() < 1.2 * ids.size / 8
    counts = np.bincount(partition_of(ids * 1000 + 17, 8), minlength=8)
    assert counts.min() > 0.8 * ids.size / 8


@pytest.mark.parametrize("parts", [1, 2, 3, 8, 1000])
def test_partition_of_is_bit_equal_to_jax(parts):
    rng = np.random.default_rng(parts)
    ids = np.concatenate([np.arange(5000), rng.integers(0, 2 ** 62, 5000),
                          np.array([0, 2 ** 63 - 1])])
    got = partition_of(ids, parts)
    want = jstream.partition_of(ids, parts)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_producer_routes_to_owner_partitions(tmp_path):
    topic = FileTopic(str(tmp_path / "t"), num_partitions=4)
    StreamProducer(topic).put_edges("rel", np.arange(100),
                                    np.arange(100) + 1,
                                    weights=np.ones(100, np.float32))
    src = np.arange(100)
    own = partition_of(src, 4)
    for p in range(4):
        recs = topic.read(p)
        got = (np.concatenate([r["src_ids"] for r in recs]) if recs
               else np.array([], np.int64))
        np.testing.assert_array_equal(np.sort(got), np.sort(src[own == p]))


def test_two_workers_split_partitions_no_dup_no_loss(tmp_path):
    topic = FileTopic(str(tmp_path / "t"), num_partitions=4)
    ids = np.arange(500)
    StreamProducer(topic).put_nodes("item", ids,
                                    labels=np.zeros(500, np.int32))
    w0 = RecordPoller(topic, partitions=[0, 1])
    w1 = RecordPoller(topic, partitions=[2, 3])
    b0, b1 = UpdateBuffer(), UpdateBuffer()
    n0, n1 = w0.poll(b0), w1.poll(b1)
    assert n0 + n1 == sum(topic.end_offset(p) for p in range(4))
    got = np.concatenate(
        [b["ids"] for b in b0.node_updates.get("item", [])]
        + [b["ids"] for b in b1.node_updates.get("item", [])])
    np.testing.assert_array_equal(np.sort(got), ids)


def test_offsets_checkpoint_resume(tmp_path):
    topic = FileTopic(str(tmp_path / "t"), num_partitions=2)
    prod = StreamProducer(topic)
    prod.put_edges("rel", np.arange(50), np.arange(50) + 1)
    poller = RecordPoller(topic)
    poller.poll(UpdateBuffer())
    mark = poller.offsets()
    prod.put_edges("rel", np.arange(50, 90), np.arange(50, 90) + 1)
    resumed = RecordPoller(topic, offsets=mark)
    buf2 = UpdateBuffer()
    resumed.poll(buf2)
    got = np.concatenate([b["src_ids"] for b in buf2.edge_updates["rel"]])
    np.testing.assert_array_equal(np.sort(got), np.arange(50, 90))
    assert resumed.lag() == 0


def test_ingest_updates_serving(g, tmp_path):
    q = (g.V("item").batch(4).alias("src")
         .outV("rel").sample(4).by("topk").alias("h1").values())
    svc = QueryService(g, device="cpu")
    try:
        qid = svc.install(q, micro_batch=4)
        deg0 = int(g.out_degrees(np.array([0]), "rel")[0])
        topic = FileTopic(str(tmp_path / "t"), num_partitions=2)
        StreamProducer(topic).put_edges("rel", [0, 0], [390, 380],
                                        weights=[9.0, 8.0])
        assert ingest(g, RecordPoller(topic), service=svc) >= 1
        assert int(g.out_degrees(np.array([0]), "rel")[0]) == deg0 + 2
        out = svc.run(qid, np.array([0, 10, 20, 30]))
        assert tuple(out["h1"].ids.shape) == (4, 4)
        # the refresh published the new edges: they lead node 0's topk
        assert {39, 38} <= set(out["h1"].ids[0].tolist())
        assert ingest(g, RecordPoller(topic, offsets={0: 99, 1: 99}),
                      service=svc) == 0  # nothing new: no refresh
    finally:
        svc.close()


def test_bulk_load_matches_direct_parse(tmp_graph_dir, tmp_path):
    from graph_learn_tpu_torch.core.ingest import load_node_table
    dec = glt.Decoder(weighted=True, labeled=True, attr_types=["float"] * 4)
    topic = FileTopic(str(tmp_path / "t"), num_partitions=3)
    n = bulk_load(StreamProducer(topic), "nodes", "item",
                  tmp_graph_dir["node"], dec)
    buf = UpdateBuffer()
    RecordPoller(topic).poll(buf)
    got_ids = np.sort(np.concatenate(
        [b["ids"] for b in buf.node_updates["item"]]))
    direct = load_node_table(tmp_graph_dir["node"], dec)
    np.testing.assert_array_equal(got_ids, np.sort(direct["ids"]))
    assert n == direct["ids"].shape[0]
    b0 = buf.node_updates["item"][0]
    lookup = {int(i): row for i, row in zip(direct["ids"],
                                            direct["float_attrs"])}
    for i, row in zip(b0["ids"], b0["float_attrs"]):
        np.testing.assert_allclose(row, lookup[int(i)], rtol=1e-6)
    with pytest.raises(glt.InvalidArgumentError, match="kind"):
        bulk_load(StreamProducer(topic), "rows", "item",
                  tmp_graph_dir["node"], dec)


def test_kafka_adapter_gated():
    with pytest.raises(glt.UnimplementedError, match="kafka"):
        KafkaTopic("localhost:9092", "updates")


def test_kafka_topic_executes_against_fake_client(monkeypatch):
    from tests import fake_kafka
    fake_kafka.install(monkeypatch)
    topic = KafkaTopic("fake:9092", "updates", num_partitions=4)
    prod = StreamProducer(topic)
    src = np.arange(100)
    prod.put_edges("rel", src, src + 1, weights=np.ones(100, np.float32))
    own = partition_of(src, 4)
    for p in range(4):
        recs = topic.read(p)
        got = (np.concatenate([r["src_ids"] for r in recs]) if recs
               else np.array([], np.int64))
        np.testing.assert_array_equal(np.sort(got), np.sort(src[own == p]))
        assert topic.end_offset(p) == len(recs)
    n0 = topic.end_offset(0)
    prod.put_nodes("item", np.arange(64))
    tail = topic.read(0, start=n0)
    assert len(tail) == topic.end_offset(0) - n0
    assert all(r["kind"] == "nodes" for r in tail)
    assert len(topic.read(0, start=0, max_records=1)) == 1
    buf = UpdateBuffer()
    poller = RecordPoller(topic)
    assert poller.poll(buf) == sum(topic.end_offset(p) for p in range(4))
    got = np.concatenate([b["src_ids"] for b in buf.edge_updates["rel"]])
    np.testing.assert_array_equal(np.sort(got), src)
    assert poller.lag() == 0


def test_kafka_read_bounded_on_stalled_broker(monkeypatch):
    from tests import fake_kafka
    broker = fake_kafka.install(monkeypatch)
    topic = KafkaTopic("fake:9092", "updates", num_partitions=1)
    StreamProducer(topic).put_nodes("item", np.arange(10))
    broker.stalled = True
    assert topic.read(0) == []  # returned (bounded), not hung
    broker.stalled = False
    assert len(topic.read(0)) == topic.end_offset(0)


def test_concurrent_producers_interleave_atomically(tmp_path):
    topic = FileTopic(str(tmp_path / "t"), num_partitions=1)

    def work(base):
        prod = StreamProducer(topic)
        for i in range(50):
            prod.put_nodes("item", [base + i])

    ts = [threading.Thread(target=work, args=(b,)) for b in (0, 1000)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    ids = sorted(r["ids"][0] for r in topic.read(0))
    assert ids == sorted(list(range(50)) + list(range(1000, 1050)))


def _put_everything(stream_mod, topic):
    prod = stream_mod.StreamProducer(topic)
    prod.put_nodes("item", [7000, 7001, 7002, 13], weights=[1, 2, 3, 4],
                   labels=[0, 1, 2, 3], timestamps=[5, 6, 7, 8],
                   float_attrs=np.arange(16, dtype=np.float32).reshape(4, 4))
    prod.put_edges("rel", [0, 10, 20, 7000], [10, 20, 7001, 0],
                   weights=np.array([0.5, 1.5, 2.5, 3.25], np.float32),
                   timestamps=[1, 2, 3, 4])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_topics_cross_between_the_packages(tmp_path, writer):
    """A FileTopic written by one package's StreamProducer holds the same
    bytes as the other's, and each package's RecordPoller reads the
    other's records into the same buffers."""
    roots = {w: str(tmp_path / w) for w in ("jax", "port")}
    _put_everything(jstream, jstream.FileTopic(roots["jax"],
                                               num_partitions=3))
    _put_everything(tstream, FileTopic(roots["port"], num_partitions=3))
    for p in range(3):
        name = "part-%05d.jsonl" % p
        a = tmp_path / "jax" / name
        b = tmp_path / "port" / name
        assert a.exists() == b.exists()
        if a.exists():
            assert a.read_bytes() == b.read_bytes()
    assert (tmp_path / "jax" / "topic.json").read_text() == \
        (tmp_path / "port" / "topic.json").read_text()
    root = roots[writer]
    tbuf, jbuf = UpdateBuffer(), jupdate.UpdateBuffer()
    tpoll = RecordPoller(FileTopic(root, create=False))
    jpoll = jstream.RecordPoller(jstream.FileTopic(root, create=False))
    assert tpoll.poll(tbuf) == jpoll.poll(jbuf) > 0
    assert tpoll.offsets() == jpoll.offsets()
    for kind in ("node_updates", "edge_updates"):
        ta, ja = getattr(tbuf, kind), getattr(jbuf, kind)
        assert set(ta) == set(ja)
        for t in ta:
            for rt, rj in zip(ta[t], ja[t]):
                assert set(rt) == set(rj)
                for k in rt:
                    if rj[k] is None:
                        assert rt[k] is None
                    else:
                        assert rt[k].dtype == rj[k].dtype, k
                        np.testing.assert_array_equal(rt[k], rj[k])


def test_loader_main_cli_roundtrip(tmp_graph_dir, tmp_path, capsys):
    from graph_learn_tpu_torch.core.ingest import load_node_table
    from graph_learn_tpu_torch.online.loader_main import main as loader_main
    topic_dir = str(tmp_path / "topic")
    rc = loader_main([
        "load", "--topic", topic_dir, "--partitions", "3",
        "--nodes", "item=%s" % tmp_graph_dir["node"],
        "--node-decoder",
        '{"weighted": true, "labeled": true, '
        '"attr_types": ["float", "float", "float", "float"]}',
        "--edges", "rel:item:item=%s" % tmp_graph_dir["edge"],
        "--edge-decoder", '{"weighted": true}',
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loaded 40 node rows (item)" in out and "published" in out
    assert loader_main(["offsets", "--topic", topic_dir]) == 0
    offs = json.loads(capsys.readouterr().out)
    assert sorted(offs["end_offsets"]) == ["0", "1", "2"]
    assert sum(offs["end_offsets"].values()) > 0
    assert loader_main(["view", "--topic", topic_dir, "--limit", "4"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 4
    for ln in lines:
        assert {"partition", "offset", "kind"} <= set(json.loads(ln))
    buf = UpdateBuffer()
    RecordPoller(FileTopic(topic_dir, create=False)).poll(buf)
    dec = glt.Decoder(weighted=True, labeled=True, attr_types=["float"] * 4)
    direct = load_node_table(tmp_graph_dir["node"], dec)
    got_ids = np.sort(np.concatenate(
        [b["ids"] for b in buf.node_updates["item"]]))
    np.testing.assert_array_equal(got_ids, np.sort(direct["ids"]))
    assert sum(len(b["src_ids"]) for b in buf.edge_updates["rel"]) > 0


def test_loader_main_writes_the_jax_loaders_topic(tmp_graph_dir, tmp_path,
                                                  capsys):
    """Both packages' loader CLIs publish the same files."""
    from graph_learn_tpu.online.loader_main import main as jax_loader
    from graph_learn_tpu_torch.online.loader_main import main as loader
    for name, fn in (("jax", jax_loader), ("port", loader)):
        assert fn(["load", "--topic", str(tmp_path / name),
                   "--partitions", "2",
                   "--nodes", "item=%s" % tmp_graph_dir["node"],
                   "--node-decoder", '{"weighted": true, "labeled": true, '
                   '"attr_types": ["float", "float", "float", "float"]}',
                   "--edges", "rel=%s" % tmp_graph_dir["edge"],
                   "--edge-decoder", '{"weighted": true}']) == 0
    published = [ln.split(" to ")[0] for ln in
                 capsys.readouterr().out.splitlines()
                 if ln.startswith("published")]
    assert len(published) == 2 and published[0] == published[1]
    for p in range(2):
        name = "part-%05d.jsonl" % p
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    with pytest.raises(glt.InvalidArgumentError, match="type=/path"):
        loader(["load", "--topic", str(tmp_path / "x"), "--nodes", "item"])
