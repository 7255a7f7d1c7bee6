"""Streaming ingestion transport: partitioned record topics and pollers.

Counterpart of ``graph_learn_tpu/online/stream.py:46-309`` (the DGS
ingestion fabric: dataloaders partition update records by vertex id and
publish them; each serving worker polls the partitions it owns and applies
them):

- :func:`partition_of`: the owner partition of each vertex id, the
  Fibonacci hash of the JAX package, bit for bit, so that a producer of
  either package and a worker of the other agree on partitions.
- :class:`FileTopic`: a durable, partitioned, append-only record log, one
  JSONL file per partition, in the JAX package's format (``topic.json``,
  ``part-%05d.jsonl``, one compact JSON record a line, written with one
  ``write``), so offsets and records cross between the packages.
- :class:`KafkaTopic`: the same interface over a Kafka cluster, where the
  ``kafka`` package can be imported (it is imported when a topic is made).
- :class:`StreamProducer`: splits update batches by owner (an edge goes
  to its source's partition) and publishes them.
- :class:`RecordPoller`: drains an assigned partition set into an
  ``UpdateBuffer`` by offset; ``offsets()`` is the checkpoint mark.
- :func:`ingest`: poll, ``apply_updates``, ``refresh()``.
- :func:`bulk_load`: a TSV file through the port's parser
  (``core/ingest.py``) out to the topic.

All of it is host work: none of it touches a device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from graph_learn_tpu_torch.errors import (InvalidArgumentError,
                                          NotFoundError, UnimplementedError)
from graph_learn_tpu_torch.online.update import UpdateBuffer, apply_updates


def partition_of(ids, num_partitions: int) -> np.ndarray:
    """Owner partition per vertex id: a multiplicative (Fibonacci) hash,
    the same across producers, packages and languages."""
    v = np.asarray(ids, np.uint64)
    h = (v * np.uint64(11400714819323198485)) >> np.uint64(40)
    return (h % np.uint64(num_partitions)).astype(np.int64)


class FileTopic:
    """Durable partitioned record log: one JSONL file per partition."""

    def __init__(self, root: str, num_partitions: int = 1,
                 create: bool = True):
        self.root = os.path.abspath(root)
        meta = os.path.join(self.root, "topic.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self.num_partitions = json.load(f)["num_partitions"]
        elif create:
            os.makedirs(self.root, exist_ok=True)
            self.num_partitions = int(num_partitions)
            with open(meta, "w") as f:
                json.dump({"num_partitions": self.num_partitions}, f)
        else:
            raise NotFoundError("no topic at %r" % root)

    def _part_path(self, p: int) -> str:
        if not 0 <= p < self.num_partitions:
            raise InvalidArgumentError("partition %d out of range" % p)
        return os.path.join(self.root, "part-%05d.jsonl" % p)

    def append(self, partition: int, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":")) + "\n"
        # one write() of one complete line: producers interleave whole
        # records
        with open(self._part_path(partition), "a") as f:
            f.write(line)

    def read(self, partition: int, start: int = 0,
             max_records: Optional[int] = None) -> List[dict]:
        path = self._part_path(partition)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for i, line in enumerate(f):
                if i < start:
                    continue
                if max_records is not None and len(out) >= max_records:
                    break
                out.append(json.loads(line))
        return out

    def end_offset(self, partition: int) -> int:
        path = self._part_path(partition)
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return sum(1 for _ in f)


class KafkaTopic:
    """The same interface against a Kafka cluster (needs the ``kafka``
    package, kafka-python)."""

    def __init__(self, bootstrap_servers: str, topic: str,
                 num_partitions: int = 1):
        try:
            from kafka import KafkaConsumer, KafkaProducer
            from kafka.structs import TopicPartition
        except ImportError as e:
            raise UnimplementedError(
                "KafkaTopic needs the 'kafka' (kafka-python) package; use "
                "FileTopic on a shared filesystem instead") from e
        self._TP = TopicPartition
        self.topic = topic
        self.num_partitions = int(num_partitions)
        self._producer = KafkaProducer(bootstrap_servers=bootstrap_servers)
        self._consumer = KafkaConsumer(bootstrap_servers=bootstrap_servers)

    def append(self, partition: int, record: dict) -> None:
        self._producer.send(self.topic, partition=partition,
                            value=json.dumps(record).encode())
        self._producer.flush()

    def read(self, partition: int, start: int = 0,
             max_records: Optional[int] = None) -> List[dict]:
        tp = self._TP(self.topic, partition)
        self._consumer.assign([tp])
        self._consumer.seek(tp, start)
        end = self._consumer.end_offsets([tp])[tp]
        n = end - start if max_records is None else min(
            max_records, end - start)
        out = []
        empty_polls = 0
        while len(out) < n:
            polled = self._consumer.poll(timeout_ms=1000)
            if not polled:
                # a broker that reports end offsets but stops delivering
                # must not spin the reader for ever
                empty_polls += 1
                if empty_polls >= 10:
                    break
                continue
            empty_polls = 0
            for recs in polled.values():
                out.extend(json.loads(r.value) for r in recs)
        return out[:n]

    def end_offset(self, partition: int) -> int:
        tp = self._TP(self.topic, partition)
        return self._consumer.end_offsets([tp])[tp]


def _tolist(a):
    return None if a is None else np.asarray(a).tolist()


class StreamProducer:
    """Partition update batches by owner and publish them: a node record
    to its id's partition, an edge record to its source's (a vertex's
    out-adjacency lives on one worker)."""

    def __init__(self, topic):
        self.topic = topic

    def put_nodes(self, node_type: str, ids, weights=None, labels=None,
                  float_attrs=None, int_attrs=None, timestamps=None):
        ids = np.asarray(ids, np.int64)
        parts = partition_of(ids, self.topic.num_partitions)
        fields = dict(weights=weights, labels=labels,
                      float_attrs=float_attrs, int_attrs=int_attrs,
                      timestamps=timestamps)
        for p in np.unique(parts):
            m = parts == p
            rec = {"kind": "nodes", "type": node_type,
                   "ids": ids[m].tolist()}
            for k, v in fields.items():
                if v is not None:
                    rec[k] = _tolist(np.asarray(v)[m])
            self.topic.append(int(p), rec)

    def put_edges(self, edge_type: str, src_ids, dst_ids, weights=None,
                  timestamps=None):
        src = np.asarray(src_ids, np.int64)
        dst = np.asarray(dst_ids, np.int64)
        if src.shape != dst.shape:
            raise InvalidArgumentError("src/dst length mismatch")
        parts = partition_of(src, self.topic.num_partitions)
        fields = dict(weights=weights, timestamps=timestamps)
        for p in np.unique(parts):
            m = parts == p
            rec = {"kind": "edges", "type": edge_type,
                   "src_ids": src[m].tolist(), "dst_ids": dst[m].tolist()}
            for k, v in fields.items():
                if v is not None:
                    rec[k] = _tolist(np.asarray(v)[m])
            self.topic.append(int(p), rec)


class RecordPoller:
    """Consume an assigned partition set into UpdateBuffers by offset;
    ``offsets()`` after a poll is the resume mark."""

    def __init__(self, topic, partitions: Optional[Sequence[int]] = None,
                 offsets: Optional[Dict[int, int]] = None):
        self.topic = topic
        self.partitions = (list(range(topic.num_partitions))
                           if partitions is None else list(partitions))
        self._offsets = {int(p): 0 for p in self.partitions}
        for p, o in (offsets or {}).items():
            self._offsets[int(p)] = int(o)

    def poll(self, buf: UpdateBuffer,
             max_records: Optional[int] = None) -> int:
        """Drain new records into ``buf``; returns the record count."""
        n = 0
        for p in self.partitions:
            budget = None if max_records is None else max_records - n
            if budget is not None and budget <= 0:
                break
            recs = self.topic.read(p, start=self._offsets[p],
                                   max_records=budget)
            for rec in recs:
                rec = dict(rec)
                kind, t = rec.pop("kind"), rec.pop("type")
                if kind == "nodes":
                    buf.add_nodes(t, **rec)
                elif kind == "edges":
                    buf.add_edges(t, **rec)
                else:
                    raise InvalidArgumentError("bad record kind %r" % kind)
            self._offsets[p] += len(recs)
            n += len(recs)
        return n

    def offsets(self) -> Dict[int, int]:
        return dict(self._offsets)

    def lag(self) -> int:
        return sum(self.topic.end_offset(p) - self._offsets[p]
                   for p in self.partitions)


def ingest(graph, poller: RecordPoller, service=None,
           max_records: Optional[int] = None) -> int:
    """Poll the owned partitions, apply the records to the store and, given
    a ``service`` (anything with ``refresh()``), publish the new state to
    it copy-on-write.  Returns the number of records applied."""
    buf = UpdateBuffer()
    n = poller.poll(buf, max_records=max_records)
    if not buf.empty:
        apply_updates(graph, buf)
        if service is not None:
            service.refresh()
    return n


def bulk_load(producer: StreamProducer, kind: str, type_name: str,
              path: str, decoder) -> int:
    """A reference-layout TSV file, parsed as ``Graph.node()/edge()`` parse
    it, published as topic records.  Returns the rows published."""
    from graph_learn_tpu_torch.core.ingest import (load_edge_table,
                                                   load_node_table)
    if kind == "nodes":
        cols = load_node_table(path, decoder)
        producer.put_nodes(type_name, cols["ids"],
                           weights=cols.get("weights"),
                           labels=cols.get("labels"),
                           float_attrs=cols.get("float_attrs"),
                           int_attrs=cols.get("int_attrs"),
                           timestamps=cols.get("timestamps"))
        return int(np.asarray(cols["ids"]).shape[0])
    if kind == "edges":
        cols = load_edge_table(path, decoder)
        producer.put_edges(type_name, cols["src_ids"], cols["dst_ids"],
                           weights=cols.get("weights"),
                           timestamps=cols.get("timestamps"))
        return int(np.asarray(cols["src_ids"]).shape[0])
    raise InvalidArgumentError("kind must be 'nodes' or 'edges'")
