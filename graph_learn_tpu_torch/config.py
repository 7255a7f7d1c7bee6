"""Global configuration flags read by the ported serving and training paths.

A copy of the subset of ``graph_learn_tpu/config.py`` that this package
reads.  There is no ``use_pallas`` counterpart: on the card the hand-written
kernels are the only path, and CPU tensors take their plain versions.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _Config:
    # fill for the neighbours of zero-degree seeds (reference DefaultNeighborId)
    default_neighbor_id: int = 0
    # dtype of the device feature tables ("float32" | "bfloat16")
    feature_dtype: str = "float32"
    # dtype that encoders and deepest-hop reductions compute in
    compute_dtype: str = "float32"
    # default seed of the sampling generators (serving, Dataset, trainer)
    seed: int = 0
    # "full" also builds the reverse (dst -> src) CSR on the device;
    # "minimal" builds only the forward CSR
    storage_profile: str = "full"
    # batches a Dataset queues ahead of its reader (reference
    # DatasetCapacity)
    dataset_capacity: int = 10
    # where the graph tables live: only "device" is ported; "host" (tables
    # in host RAM, batches shipped to the card) raises until it is
    storage_device: str = "device"


conf = _Config()
