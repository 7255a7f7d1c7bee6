"""Dataloader apps: the file loader and the output viewer of stream topics.

Counterpart of ``graph_learn_tpu/online/loader_main.py`` (the DGS
dataloader's file_loader and output_viewer): ``load`` parses
reference-layout TSV files with the port's parser (``core/ingest.py``, the
rules of ``Graph.node()/edge()``) and publishes their rows, partitioned by
vertex id, to a topic (``online/stream.py``: a FileTopic directory, or
``kafka://broker/topic``); ``view`` prints records as JSON lines;
``offsets`` prints each partition's end offset.  It is host work only: a
loader needs no card.  Usage::

    python -m graph_learn_tpu_torch.online.loader_main load \\
        --topic /data/updates --partitions 4 \\
        --nodes item=/data/node_table \\
        --node-decoder '{"labeled": true, "attr_types": ["float", "float"]}' \\
        --edges rel:item:item=/data/edge_table \\
        --edge-decoder '{"weighted": true}'
    python -m graph_learn_tpu_torch.online.loader_main view \\
        --topic /data/updates --partition 0 --start 0 --limit 5
    python -m graph_learn_tpu_torch.online.loader_main offsets \\
        --topic /data/updates
"""

from __future__ import annotations

import argparse
import json
import sys

from graph_learn_tpu_torch.errors import InvalidArgumentError
from graph_learn_tpu_torch.online.serve_main import _decoder as _spec_decoder
from graph_learn_tpu_torch.online.stream import (FileTopic, KafkaTopic,
                                                 StreamProducer, bulk_load)


def _decoder(text: str):
    return _spec_decoder(json.loads(text) if text else {})


def _topic(args, create: bool):
    if args.topic.startswith("kafka://"):
        # kafka://broker:9092/topic-name
        broker, _, name = args.topic[len("kafka://"):].partition("/")
        if not name:
            raise InvalidArgumentError("kafka:// topic needs /topic-name")
        return KafkaTopic(broker, name, num_partitions=args.partitions)
    return FileTopic(args.topic, num_partitions=args.partitions,
                     create=create)


def _parse_target(spec: str, kind: str):
    """'item=/path' or 'rel:src:dst=/path' -> (type_name, path)."""
    type_part, _, path = spec.partition("=")
    if not path:
        raise InvalidArgumentError(
            "%s spec must look like type=/path (got %r)" % (kind, spec))
    return type_part.split(":")[0], path


def cmd_load(args) -> int:
    topic = _topic(args, create=True)
    producer = StreamProducer(topic)
    total = 0
    for kind, specs, dec in (("nodes", args.nodes, args.node_decoder),
                             ("edges", args.edges, args.edge_decoder)):
        for spec in specs or []:
            type_name, path = _parse_target(spec, kind)
            n = bulk_load(producer, kind, type_name, path, _decoder(dec))
            print("loaded %d %s rows (%s) from %s"
                  % (n, kind[:-1], type_name, path))
            total += n
    print("published %d rows to %s (%d partitions)"
          % (total, args.topic, topic.num_partitions))
    return 0


def cmd_view(args) -> int:
    topic = _topic(args, create=False)
    parts = ([args.partition] if args.partition is not None
             else range(topic.num_partitions))
    shown = 0
    for p in parts:
        recs = topic.read(p, start=args.start,
                          max_records=args.limit - shown)
        for i, rec in enumerate(recs):
            print(json.dumps({"partition": p, "offset": args.start + i,
                              **rec}))
        shown += len(recs)
        if shown >= args.limit:
            break
    return 0


def cmd_offsets(args) -> int:
    topic = _topic(args, create=False)
    out = {str(p): topic.end_offset(p) for p in range(topic.num_partitions)}
    print(json.dumps({"topic": args.topic, "end_offsets": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graph_learn_tpu_torch.online.loader_main",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    load = sub.add_parser("load", help="TSV file(s) -> topic records")
    load.add_argument("--topic", required=True,
                      help="FileTopic root dir or kafka://broker/topic")
    load.add_argument("--partitions", type=int, default=1)
    load.add_argument("--nodes", action="append",
                      metavar="TYPE=/path/to/node_table")
    load.add_argument("--edges", action="append",
                      metavar="TYPE[:SRC:DST]=/path/to/edge_table")
    load.add_argument("--node-decoder", default="{}",
                      help="Decoder kwargs as JSON")
    load.add_argument("--edge-decoder", default="{}")
    load.set_defaults(fn=cmd_load)

    view = sub.add_parser("view", help="dump topic records as JSON lines")
    view.add_argument("--topic", required=True)
    view.add_argument("--partitions", type=int, default=0,
                      help="0 = read the count from the topic dir")
    view.add_argument("--partition", type=int, default=None)
    view.add_argument("--start", type=int, default=0)
    view.add_argument("--limit", type=int, default=20)
    view.set_defaults(fn=cmd_view)

    offs = sub.add_parser("offsets", help="per-partition end offsets")
    offs.add_argument("--topic", required=True)
    offs.add_argument("--partitions", type=int, default=0)
    offs.set_defaults(fn=cmd_offsets)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
