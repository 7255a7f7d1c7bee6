"""EgoGraphSAGE as the port trains it at scale: ``bench.MultiStep``'s step
on the workload's hops (the deepest, hop N, reduced outside the gradient
by Kernel 2, the rows of the seeds and of hops 1 ... N - 1 gathered by
Kernel 1 in the forward, SAGE convs, softmax cross-entropy, fused Adam),
with the step kept for the comparison.  Its plain reference is
``references/ego_sage.py``.

The model is the port's ``EgoGraphSAGE`` composed with the convs' own
bias switch (``cfg["bias"]``), which ``EgoGraphSAGE`` does not pass on:
with agg "mean" and a bias each conv is PyG's ``SAGEConv``, ``lin_l`` of
the neighbours' mean (with its bias) plus ``lin_r`` of the node itself,
as one Linear of their concatenation."""

from __future__ import annotations

import re
from typing import Dict, List

import torch

from graph_learn_tpu_torch import bench
from graph_learn_tpu_torch.nn.data import EgoGraph, PreAggregatedRows
from graph_learn_tpu_torch.nn.feature_column import FeatureEncoder
from graph_learn_tpu_torch.nn.layers.ego import EgoLayer, EgoSAGEConv
from graph_learn_tpu_torch.nn.loss import supervised_softmax_loss
from graph_learn_tpu_torch.nn.models.ego_gnn import EgoGNN
from graph_learn_tpu_torch.ops.aggregate import gather_group_agg

from gnnbench import flops
from gnnbench.steps import RecordedSteps, hop_aliases


def build(cfg: dict, decoder, device) -> torch.nn.Module:
    """EgoGraphSAGE ``cfg["dims"]`` with ``cfg["agg"]`` and ``cfg["bias"]``,
    composed as the port's ``EgoGraphSAGE`` composes it (one shared conv a
    layer, relu between, no dropout); its weights are set by the
    harness."""
    dims = cfg["dims"]
    n = len(dims) - 1
    convs = [EgoSAGEConv(dims[i], dims[i + 1], agg_type=cfg["agg"],
                         use_bias=cfg["bias"]) for i in range(n)]
    layers = [EgoLayer([convs[i]] * (n - i)) for i in range(n)]
    return EgoGNN(layers, FeatureEncoder(decoder)).to(device)


def ref_name(port_name: str) -> str:
    """``layers.<l>.convs.0.trans_nodes.<leaf>`` -> ``layer<l>.<leaf>``."""
    m = re.fullmatch(r"layers\.(\d+)\.convs\.0\.trans_nodes\.(weight|bias)",
                     port_name)
    if m is None:
        raise ValueError("unexpected EgoGraphSAGE leaf %r" % port_name)
    return "layer%s.%s" % m.groups()


class Steps(RecordedSteps):
    """``bench.MultiStep._group`` on every hop of ``self.hops``, the
    deepest pre-averaged, with its spans and ``keep`` calls."""

    def _group(self, first: int):
        table = self.tables["nodes"]["item"].float_attrs
        deepest = self.hops[-1]
        with self.span("plan"), torch.no_grad():
            batches = [bench.sample_one(self.q, self.tables, self.n_nodes,
                                        self.generator)
                       for _ in range(self.G)]
        with self.span("aggregate"), torch.no_grad():
            ids = [b[deepest].ids for _, b in batches]
            ids = ids[0][None] if self.G == 1 else torch.stack(ids)
            agg = gather_group_agg(table, ids, "mean").reshape(
                self.G, -1, table.shape[-1])
        for j, (seeds, batch) in enumerate(batches):
            self.seeds.append(seeds)
            with self.span("model"):
                last = batch[deepest].replace(
                    float_attrs=PreAggregatedRows(agg[j], "mean"))
                ego = EgoGraph.from_query_result({**batch, deepest: last},
                                                 "src", self.hops)
                logits = self.model(ego, training=True)
                loss = supervised_softmax_loss(logits, batch["src"].labels)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                self.optimizer.step()
                self.losses[first + j].copy_(loss.detach())
            self.keep(first + j, seeds, batch, logits, agg[j])


def step_work(cfg: dict, traffic: dict) -> flops.Work:
    if cfg["agg"] != "mean":
        raise ValueError("the step's count is of agg 'mean'")
    return flops.sage_step(traffic["batch"], traffic["fanout"], cfg["dims"],
                           cfg["bias"])


def kernel_work(cfg: dict, traffic: dict, rec: Dict[str, torch.Tensor],
                itemsize: int) -> Dict[str, List[flops.Work]]:
    """The work of each kernel launch of one step, by operator: Kernel 1
    on the rows of the seeds and of hops 1 ... N - 1, Kernel 2's means of
    hop N."""
    d = cfg["dims"][0]
    fanout = traffic["fanout"]
    hops = hop_aliases(fanout)

    def distinct(t):
        return int(torch.unique(t).numel())

    gathers = [flops.gather_rows(distinct(rec[a]), rec[a].numel(), d,
                                 itemsize) for a in ("seeds",) + hops[:-1]]
    k = fanout[-1]
    groups = rec[hops[-1]].numel() // k
    mean = flops.group_mean(distinct(rec[hops[-1]]), groups, k, d, itemsize)
    return {"glt::gather_rows": gathers, "glt::segment_spmm": [mean]}
