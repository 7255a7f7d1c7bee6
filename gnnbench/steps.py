"""The timed step: the port's ``bench.MultiStep``, subclassed only to keep
what the comparison needs.

A model's module (``models/<model>.py``) writes the step's body as the
port composes it and calls :meth:`RecordedSteps.keep` after each step's
Adam update.  What is kept:

* the first call (eager, in set-up): every step's seeds and the sampled
  ids of every hop ("hop1" ... "hopN", N the fanout's length), copied to
  the host; the first ``FOLLOWED`` steps' logits and deepest-hop
  means; Adam's first moment after step 1 (the first gradient as the
  optimizer got it) and the parameters after step ``FOLLOWED``, before
  step ``FOLLOWED + 1`` changes them;
* under capture (and, without a graph, in each later eager call):
  references to every step's ids, the first step's logits and the first
  and last steps' means, which every replay overwrites in place, so that
  after a replay they hold that replay's (``replayed``; no copy is added
  to the graph);
* in the traced eager steps: references to every step's ids (the
  rooflines' bytes).

``span`` opens a ``record_function`` range around a call into a layer
while ``spans`` is set (the traced eager steps only).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from graph_learn_tpu_torch import bench

# the steps the reference follows
FOLLOWED = 3


def hop_aliases(fanout: Sequence[int]) -> Tuple[str, ...]:
    """The plan's alias of each hop of ``fanout``: "hop1" ... "hopN"."""
    return tuple("hop%d" % j for j in range(1, len(fanout) + 1))


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host (a copy also where ``t`` is there)."""
    return t.detach().to("cpu", copy=True)


def capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class RecordedSteps(bench.MultiStep):
    """``bench.MultiStep`` whose steps keep their ids (module note);
    ``hops`` are the plan's hop aliases, in order."""

    def __init__(self, *args, hops: Sequence[str], beta1: float = 0.9,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.hops = tuple(hops)
        self.beta1 = beta1
        self.mode = "first"
        self.spans = False
        self.first: List[Dict[str, torch.Tensor]] = []
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None
        self.first_params: Optional[Dict[str, torch.Tensor]] = None
        self.replayed: List[Dict[str, torch.Tensor]] = []
        self.traced: List[Dict[str, torch.Tensor]] = []

    def span(self, name: str):
        if self.spans:
            return torch.profiler.record_function("gnnbench." + name)
        return contextlib.nullcontext()

    def _body(self):
        if self.mode is None:  # a capture, or an eager call after the first
            self.replayed = []
        super()._body()
        if self.mode == "first" and not capturing():
            self.mode = None

    def keep(self, i: int, seeds: torch.Tensor, batch: dict,
             logits: torch.Tensor, agg: Optional[torch.Tensor]):
        """Keep step ``i``'s ids (and, where due, logits and means)."""
        rec = {"seeds": seeds, **{a: batch[a].ids for a in self.hops}}
        if agg is not None:
            rec["agg"] = agg
        if capturing() or (self.graph is None and self.mode is None):
            if i == 0:
                rec["logits"] = logits.detach()
            if 0 < i < self.K - 1:
                rec.pop("agg", None)
            self.replayed.append(rec)
        elif self.mode == "first":
            if i < FOLLOWED:
                rec["logits"] = logits.detach()
                rec["loss"] = self.losses[i].detach()
            else:
                rec.pop("agg", None)
            self.first.append({k: host_copy(v) for k, v in rec.items()})
            named = list(self.model.named_parameters())
            if i == 0:  # no moment: the optimizer took no gradient
                state = self.optimizer.state
                self.first_grads = {
                    k: host_copy(state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)) / (1 - self.beta1))
                    for k, p in named}
            if i == FOLLOWED - 1:
                self.first_params = {k: host_copy(p) for k, p in named}
        elif self.mode == "trace":
            self.traced.append(rec)
