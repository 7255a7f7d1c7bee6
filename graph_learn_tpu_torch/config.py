"""Global configuration flags read by the ported serving path.

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
    # seed of the serving tier's sampling generator
    seed: int = 0
    # "full" also builds the reverse (dst -> src) CSR on the device;
    # "minimal" builds only the forward CSR
    storage_profile: str = "full"


conf = _Config()
