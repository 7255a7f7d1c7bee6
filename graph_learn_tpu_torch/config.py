"""Global configuration flags read by the ported serving and training paths.

A copy of the subset of ``graph_learn_tpu/config.py`` that this package
reads.  There is no ``use_pallas`` counterpart: on the card the hand-written
kernels are the only path, and CPU tensors take their plain versions.
"""

from __future__ import annotations

import dataclasses


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


conf = _Config()
