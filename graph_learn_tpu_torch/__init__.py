"""graph_learn_tpu_torch: the PyTorch/CUDA port of graph_learn_tpu.

The 2-hop ego pipeline (graph store, GSL sampling, feature gathers,
deepest-hop group mean, EgoGraphSAGE and EgoGAT) served by ``QueryService``
and trained by ``nn.trainer.LocalTrainer`` over ``Dataset`` / ``Traverser``
on an NVIDIA H100, with hand-written CUDA kernels for the feature gather,
the segment SpMM, the fused GAT neighbour block, forward and backward, and
the sorted-hit sweep aggregation and full-table sum of the 62M-edge
frontier (``ops/kernels``, sources in ``csrc/``; ``examples/`` holds the
62M-edge training run and the sweep-aggregate harness).  ``bench`` is the
counterpart of the repository's ``bench.py``: K sample+train steps a call,
captured in one CUDA graph on the card.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from graph_learn_tpu_torch.config import conf
from graph_learn_tpu_torch.core.schema import Decoder
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.errors import (DeviceUnavailableError, GLError,
                                          InvalidArgumentError, NotFoundError,
                                          OutOfRangeError)
from graph_learn_tpu_torch.graph import Graph, synthetic_graph
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.online.serving import QueryService

__all__ = ["conf", "Decoder", "EdgeTable", "NodeTable", "Graph",
           "synthetic_graph", "QueryService", "Dataset", "GLError",
           "InvalidArgumentError", "NotFoundError", "OutOfRangeError",
           "DeviceUnavailableError"]
