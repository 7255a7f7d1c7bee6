"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the references load nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from gnnbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FIXTURES = HERE / "tests" / "fixtures"


def _top_levels(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "GLT_PLATFORM": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_check_compares_whole_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "graph_learn_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "graph_learn_tpu.ops", sys)
    assert harness.forbidden_modules() == sorted(set(before)
                                                 | {"graph_learn_tpu"})


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, (path,
                                                                     name)


def test_a_whole_run_loads_none():
    code = (
        "import json, sys; sys.path.insert(0, '.');"
        "from gnnbench import harness, catalog, flops, readers, steps, trace;"
        "from gnnbench.graphs import powerlaw;"
        "rc = harness.main(['--workload', 'tiny-sage-products.uniform',"
        " '--seed', '7', '--seconds', '0.5', '--trace', '1', '--catalog', %r,"
        " '--spec', %r]);"
        "assert rc == 0;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % (str(FIXTURES), str(FIXTURES / "spec.json")))
    tops = _top_levels(code)
    assert not set(tops) & set(harness.FORBIDDEN)
    assert "graph_learn_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    """``reference.py`` and every model's ``references/<model>.py``: in a
    process of their own no module of the program is loaded, and their
    sources import torch, the standard library's helpers and the shared
    reference alone."""
    tops = _top_levels(
        "import json, sys; sys.path.insert(0, '.');"
        "from gnnbench import reference, flops;"
        "from gnnbench.catalog import Catalog;"
        "[Catalog().module('references', p.stem) for p in"
        " Catalog().dirs[0].joinpath('references').glob('*.py')];"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "graph_learn_tpu_torch" not in tops
    assert not set(tops) & set(harness.FORBIDDEN)
    sources = [HERE / "reference.py"] + sorted(HERE.glob("references/*.py"))
    assert len(sources) > 1
    for path in sources:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                assert all(m.split(".")[0] in ("torch", "contextlib",
                                               "typing", "__future__")
                           or m == "gnnbench.reference"
                           for m in mods), (path, mods)
