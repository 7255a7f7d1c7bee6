"""Device mesh and placement rules for the graph store and training step.

Counterpart of ``graph_learn_tpu/parallel/mesh.py:29-106``.  One mesh, two
named dimensions over the world's ranks:

- ``"data"``: seed batches (data parallelism; the reference's PS/worker);
- ``"graph"``: graph storage rows (the reference's hash-partitioned
  servers).

A JAX mesh axis is a ``torch.distributed`` process group here: the mesh is
``init_device_mesh(device_type, (n_data, n_graph),
mesh_dim_names=("data", "graph"))`` over the default group, and
``mesh.get_group("graph")`` is the group a rank's graph-axis collectives
run on (``core/sharding.py``).

Parameters stay replicated in the port.  The JAX rule row-shards a 2-D
parameter named ``embedding*`` over "graph" when its rows divide the axis
(``params_sharding_rules``); :func:`params_sharding_rules` returns the
placement that rule would choose, but every rank holds every parameter
and the data-parallel step all-reduces the gradients (a row-sharded
embedding lookup is a later item of the port).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch

from graph_learn_tpu_torch.core.sharding import (GRAPH_AXIS, ShardedNodeTable,
                                                 mesh_axis)
from graph_learn_tpu_torch.core.store import DeviceNodeTable
from graph_learn_tpu_torch.parallel import bootstrap
from graph_learn_tpu_torch.utils.platform import resolve_device


def make_mesh(n_data: Optional[int] = None, n_graph: int = 1,
              device: Optional[str] = None):
    """A ``DeviceMesh`` of shape (n_data, n_graph) over the world's ranks
    (``n_data`` defaults to world size // n_graph).  ``device`` is the
    mesh's device type, by default this rank's (``init_cluster``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device is None:
        dev = bootstrap.current_device()
        device = dev.type if dev is not None else "cuda"
    resolve_device(device)  # raises without a card
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks "
                           "with parallel.bootstrap.init_cluster or "
                           "parallel.launch.spawn")
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_graph
    if n_data * n_graph != n:
        raise ValueError("mesh (%d, %d) over %d ranks" % (n_data, n_graph, n))
    return init_device_mesh(torch.device(device).type, (n_data, n_graph),
                            mesh_dim_names=("data", "graph"))


def _row_block(x: Optional[torch.Tensor], p: int, g: int):
    if x is None:
        return None
    rows = x.shape[0] // p
    return x[g * rows:(g + 1) * rows].contiguous()


def shard_tables(tables: Dict, mesh) -> Dict:
    """Place device tables on the mesh: node payloads whose row count
    divides the graph axis become :class:`ShardedNodeTable` blocks (their
    lookups psum-stitch over the axis); CSR and edge payloads stay whole
    on every rank, and so does a node table with a payload whose rows do
    not divide the axis, with the JAX package's warning and byte count.
    For a store partitioned whole, use
    ``parallel.sharded_store.build_sharded_tables``."""
    ax = mesh_axis(mesh, GRAPH_AXIS)
    p = ax.size
    fell_back = [0, 0]  # bytes replicated for non-divisible rows, count
    out = {"nodes": {}, "edges": dict(tables.get("edges", {}))}
    if "cond" in tables:
        out["cond"] = tables["cond"]
    for t, nt in tables["nodes"].items():
        fields = ({k: v for k, v in vars(nt).items()}
                  if isinstance(nt, DeviceNodeTable) else dict(nt))
        arrays = {k: v for k, v in fields.items()
                  if isinstance(v, torch.Tensor) and v.dim() >= 1
                  and k != "cum_weights"}
        if p > 1:
            bad = {k: v for k, v in arrays.items() if v.shape[0] % p != 0}
            for v in bad.values():
                fell_back[0] += v.numel() * v.element_size()
                fell_back[1] += 1
        else:
            bad = arrays
        if bad or not isinstance(nt, DeviceNodeTable):
            out["nodes"][t] = nt
            continue
        local = DeviceNodeTable(**{k: (_row_block(v, p, ax.index)
                                       if k in arrays else v)
                                   for k, v in fields.items()
                                   if k != "cum_weights"})
        out["nodes"][t] = ShardedNodeTable(
            local=local, cum_weights=nt.cum_weights,
            rows_per_shard=nt.num_nodes // p, num_nodes_global=nt.num_nodes,
            axis=GRAPH_AXIS)
    if fell_back[1]:
        warnings.warn(
            "shard_tables: %d array(s) (%.1f MiB) have row counts not "
            "divisible by the graph axis (%d) and were REPLICATED on "
            "every device; use parallel.sharded_store.build_sharded_tables "
            "for true per-device partitioning"
            % (fell_back[1], fell_back[0] / 2**20, p), stacklevel=2)
    return out


def params_sharding_rules(params, mesh) -> Dict[str, str]:
    """{parameter name: "graph" | "replicated"}: the placement the JAX
    rule gives each parameter (a 2-D ``embedding`` whose rows divide a
    graph axis of more than one rank shards over "graph").  ``params`` is
    a module or a {name: tensor} dict.  The port holds every parameter on
    every rank whatever this says (ROADMAP.md queue C)."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    p = mesh_axis(mesh, GRAPH_AXIS).size
    return {name: ("graph" if "embedding" in name and x.dim() >= 2
                   and p > 1 and x.shape[0] % p == 0 else "replicated")
            for name, x in items}
