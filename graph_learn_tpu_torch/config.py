"""Global configuration flags and the ``set_*`` setters.

A copy of the flags of ``graph_learn_tpu/config.py`` that this package
reads or that a user sets through a setter (``:112-137``).  There is no
``use_pallas`` counterpart: on the card the hand-written kernels are the
only path, and CPU tensors take their plain versions, so
``set_use_pallas`` raises.  The parallel store's flags
(``graph_shards``, ``partition_routing``, ``owner_route_capacity``,
``serving_shard_slack``, ``:76-95``) take the JAX defaults, with the
setters the JAX package has (``:136-137``).
The setters of flags that no code reads
raise ``UnimplementedError`` instead of storing a value nothing looks at:
the attribute defaults, tape capacity and storage mode, which the JAX
package stores but never reads either.
"""

from __future__ import annotations

import dataclasses

from graph_learn_tpu_torch.errors import (InvalidArgumentError,
                                          UnimplementedError)


@dataclasses.dataclass
class _Config:
    # padding of samplers that run out of neighbours: 0 = replicate the
    # last, 1 = circular (reference PaddingMode)
    padding_mode: int = 1
    # fill for the neighbours of zero-degree seeds (reference DefaultNeighborId)
    default_neighbor_id: int = 0
    # extra candidate rounds of a filtered "random" draw (reference
    # SamplingRetryTimes): after that many rejections the last is kept
    sampling_retry_times: int = 5
    # cap of "full" neighbour sampling when the query gives none (reference
    # DefaultFullNbrNum): the width of the SparseNodes result
    default_full_nbr_num: int = 100
    # dtype of the device feature tables ("float32" | "bfloat16")
    feature_dtype: str = "float32"
    # dtype that encoders and deepest-hop reductions compute in
    compute_dtype: str = "float32"
    # sorted-gather group aggregation (ops/aggregate.py gather_group_agg):
    # sort the deepest hop's row ids and sum the rows in sorted order with
    # the sweep kernel instead of the segment SpMM kernel.  Off by default,
    # as in the JAX package; tables smaller than the floor never take it
    sorted_gather: bool = False
    sorted_gather_min_bytes: int = 32 << 20
    # default seed of the sampling generators (serving, Dataset, trainer)
    seed: int = 0
    # "full" also puts the reverse (dst -> src) CSR, the id-sorted copies
    # and the weight / in-degree CDFs on the device; "minimal" only the
    # forward CSR, and samplers that need a missing array raise
    storage_profile: str = "full"
    # batches a Dataset queues ahead of its reader (reference
    # DatasetCapacity)
    dataset_capacity: int = 10
    # where the graph tables live: only "device" is ported; "host" (tables
    # in host RAM, batches shipped to the card) raises until it is
    storage_device: str = "device"
    # column separator of the TSV tables that file ingest reads
    # (reference FieldDelimiter)
    field_delimiter: str = "\t"
    # k-NN metric of an index built without one: 0 = L2, 1 = inner product
    # (reference KnnMetric)
    knn_metric: int = 0
    # number of graph shards (the mesh's "graph" axis); 1 = one device
    graph_shards: int = 1
    # payload exchange of the partitioned plan: "owner" routes feature rows
    # to their owning shards with all_to_all (O(n * D) bytes over the
    # axis), "psum" stitches them with a masked all_reduce (O(P * n * D));
    # both are exact (core/sharding.py)
    partition_routing: str = "owner"
    # owner-routing bucket capacity factor: capacity per (sender, owner)
    # bucket = max(ceil(m * factor / P) + 8, 8); an overflow stays exact
    # through the psum fallback
    owner_route_capacity: float = 2.0
    # per-shard tail capacity of the partitioned QueryService's store:
    # appended rows land in padding, so a refresh keeps the block layouts
    # and uploads only the blocks an update touched
    # (ShardedTables.replace_blocks)
    serving_shard_slack: float = 1.25


conf = _Config()


def _make_setter(field: str):
    def setter(value):
        setattr(conf, field, value)

    setter.__name__ = "set_" + field
    return setter


def _refuse(name: str, reason: str):
    def setter(value):
        raise UnimplementedError(f"{name} is not ported: {reason}")

    setter.__name__ = name
    return setter


_UNREAD = "nothing reads it, in the JAX package either"

# the gl.set_* surface of graph_learn_tpu/config.py:112-137
set_padding_mode = _make_setter("padding_mode")
set_default_neighbor_id = _make_setter("default_neighbor_id")
set_retry_times = _make_setter("sampling_retry_times")
set_default_full_nbr_num = _make_setter("default_full_nbr_num")
set_dataset_capacity = _make_setter("dataset_capacity")
set_seed = _make_setter("seed")
set_storage_device = _make_setter("storage_device")
set_field_delimiter = _make_setter("field_delimiter")
set_knn_metric = _make_setter("knn_metric")
set_graph_shards = _make_setter("graph_shards")
set_partition_routing = _make_setter("partition_routing")
set_default_int_attribute = _refuse("set_default_int_attribute", _UNREAD)
set_default_float_attribute = _refuse("set_default_float_attribute", _UNREAD)
set_default_string_attribute = _refuse("set_default_string_attribute",
                                       _UNREAD)
set_tape_capacity = _refuse("set_tape_capacity", _UNREAD)
set_storage_mode = _refuse("set_storage_mode", _UNREAD)


def set_use_pallas(value):
    """Refused: the port has no plain-route switch.  A CUDA tensor always
    takes the hand-written kernel and a CPU tensor its plain version."""
    raise InvalidArgumentError(
        "set_use_pallas has no counterpart in the PyTorch port: tensors on "
        "the card always take the hand-written CUDA kernels, tensors on the "
        "CPU their plain versions")
