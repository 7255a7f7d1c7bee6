"""graph_learn_tpu_torch: the PyTorch/CUDA port of graph_learn_tpu.

The 2-hop ego pipeline (graph store, GSL sampling, feature gathers,
deepest-hop group mean, EgoGraphSAGE and EgoGAT) served by ``QueryService``
and trained by ``nn.trainer.LocalTrainer`` over ``Dataset`` / ``Traverser``
on an NVIDIA H100, with hand-written CUDA kernels for the feature gather,
the segment SpMM, the fused GAT neighbour block, forward and backward, and
the sorted-hit sweep aggregation and full-table sum of the 62M-edge
frontier (``ops/kernels``, sources in ``csrc/``; ``examples/`` holds the
62M-edge training run, the sweep-aggregate harness, the bipartite u2i
link prediction over ``E()`` edge sources with negatives and two towers,
EgoRGCN, and EgoTGAT temporal link prediction over timestamped events,
whose hops sample only edges strictly before the event,
``ops/temporal.py``), and categorical attributes (hashed, bucketed and
multi-value columns, ``core/ingest.py``, with their embedding encoders,
``nn/feature_column.py``) with conditional negatives (``.where()``,
``ops/conditional.py``).
``bench`` is the counterpart of the repository's ``bench.py``: K sample+train steps a call,
captured in one CUDA graph on the card.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from graph_learn_tpu_torch import config
from graph_learn_tpu_torch.config import (conf, set_dataset_capacity,
                                          set_default_float_attribute,
                                          set_default_full_nbr_num,
                                          set_default_int_attribute,
                                          set_default_neighbor_id,
                                          set_default_string_attribute,
                                          set_field_delimiter, set_knn_metric,
                                          set_padding_mode, set_retry_times,
                                          set_seed, set_storage_device,
                                          set_storage_mode,
                                          set_tape_capacity, set_use_pallas)
from graph_learn_tpu_torch.core.schema import (Decoder, FeatureSpec, Mask,
                                               NodeFrom)
from graph_learn_tpu_torch.core.store import EdgeTable, NodeTable
from graph_learn_tpu_torch.core.values import (Edges, Nodes, SparseEdges,
                                               SparseNodes, SubGraphVal)
from graph_learn_tpu_torch.errors import (DeviceUnavailableError, GLError,
                                          InvalidArgumentError, NotFoundError,
                                          OutOfRangeError, UnimplementedError)
from graph_learn_tpu_torch.graph import Graph, synthetic_graph
from graph_learn_tpu_torch.gsl.dataset import Dataset
from graph_learn_tpu_torch.online.serving import QueryService
from graph_learn_tpu_torch.ops.sampling import register_sampler

__all__ = ["conf", "Decoder", "FeatureSpec", "Mask", "NodeFrom", "EdgeTable",
           "NodeTable", "Graph", "synthetic_graph", "QueryService", "Dataset",
           "register_sampler", "Nodes", "Edges", "SparseNodes", "SparseEdges",
           "SubGraphVal", "GLError", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "UnimplementedError", "DeviceUnavailableError",
           "set_dataset_capacity", "set_default_float_attribute",
           "set_default_full_nbr_num", "set_default_int_attribute",
           "set_default_neighbor_id", "set_default_string_attribute",
           "set_field_delimiter", "set_knn_metric", "set_padding_mode",
           "set_retry_times", "set_seed", "set_storage_device",
           "set_storage_mode", "set_tape_capacity", "set_use_pallas"]
