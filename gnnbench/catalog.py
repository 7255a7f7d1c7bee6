"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells and the
metrics.  Everything else is found by name in the catalog directories
(``gnnbench/`` itself, then any given with ``--catalog``):

* ``workloads/<cell>.json``: the traffic (generator, its parameters, batch,
  fanout, strategy, steps a call) and the cell's ``why``; the depth is the
  fanout's length (N hops, "hop1" ... "hopN");
* ``configs/<config>.json``: the model, its widths and the store, as run;
* ``models/<model>.py``: the port's model and step for that model;
* ``references/<model>.py``: that model's plain reference, ``logits(p,
  feats, batch, spec, tf32)`` in plain PyTorch, importing nothing of the
  program;
* ``graphs/<generator>.py``: a graph generator;
* ``metrics/<metric>.py``: a per-layer metric's reader.

So a cell, a configuration of any depth, a model or a per-layer metric is
added by new files and new entries, with no edit to a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


class Catalog:
    def __init__(self, extra: Sequence[str] = (),
                 spec_file: Optional[str] = None):
        self.dirs: List[Path] = [HERE] + [Path(d).resolve() for d in extra]
        self.spec = json.loads(Path(spec_file or SPEC_FILE).read_text())

    def _find(self, sub: str, name: str, ext: str) -> Path:
        for d in reversed(self.dirs):
            p = d / sub / (name + ext)
            if p.exists():
                return p
        raise FileNotFoundError("no %s/%s%s in %s" % (sub, name, ext,
                                                      [str(d) for d in
                                                       self.dirs]))

    def cell(self, name: str) -> dict:
        """The cell's ``BENCHMARK.json`` entry."""
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in the benchmark" % name)

    def workload(self, name: str) -> dict:
        return json.loads(self._find("workloads", name, ".json").read_text())

    def config(self, name: str) -> dict:
        return json.loads(self._find("configs", name, ".json").read_text())

    def module(self, sub: str, name: str):
        """``<sub>/<name>.py`` loaded as a module."""
        path = self._find(sub, name, ".py")
        mod_name = "gnnbench._%s_%s" % (sub, name.replace(".", "_")
                                        .replace("-", "_"))
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``traced`` the per-layer ones, each where its ``workloads``
        (if given) list the cell."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or cell in m["workloads"]]
