"""graph_learn_tpu_torch: the PyTorch/CUDA port of graph_learn_tpu.

The serving path of the 2-hop EgoSAGE pipeline (graph store, GSL sampling,
feature gathers, deepest-hop group mean, EgoGraphSAGE forward, QueryService)
on an NVIDIA H100, with hand-written CUDA kernels for the feature gather and
the segment SpMM (``ops/kernels``, sources in ``csrc/``).  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.errors import (DeviceUnavailableError, GLError,
                                          InvalidArgumentError, NotFoundError)
from graph_learn_tpu_torch.graph import Graph, synthetic_graph
from graph_learn_tpu_torch.online.serving import QueryService

__all__ = ["conf", "Decoder", "EdgeTable", "NodeTable", "Graph",
           "synthetic_graph", "QueryService", "GLError",
           "InvalidArgumentError", "NotFoundError", "DeviceUnavailableError"]
