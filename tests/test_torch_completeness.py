"""Every public function, class and method of the JAX package has a
counterpart of the same name in the port, or a line below that says why
not.  Both packages are read with ``ast`` only (nothing is imported), so a
later addition to ``graph_learn_tpu/`` without a port shows up here.

The Pallas kernels (``graph_learn_tpu/ops/pallas/``) are left out: their
Hopper counterparts live in ``graph_learn_tpu_torch/ops/kernels/`` under
other names.  A module's counterpart is the port's module of the same
path (``MOVED`` lists the one that moved).  A name counts as present when
the port's module binds it (defines, assigns or imports it); a method when
the port's class of that name, or a base class of it, defines it as a
method, a property, a dataclass field, a class attribute or an attribute
set in ``__init__``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "graph_learn_tpu", ROOT / "graph_learn_tpu_torch"
MOVED = {"csrc/native_ingest.py": "core/native_ingest.py"}

# "module name" or "module Class.method" -> why the port has no counterpart
NOT_PORTED = {
    "core/sharding.py ShardedCSR.ts_tiled":
        "a TPU layout: the port keeps a shard's timestamps as the flat "
        "nbr_ts field, not in [rows, 128] tiles",
    "core/store.py DeviceNodeSet":
        "jit's device copy of a seed set: the port's NodeSet indices are "
        "moved to the device where a query reads them",
    "core/store.py NodeSet.device":
        "builds DeviceNodeSet, which the port does not need (above)",
    "gsl/compile.py Query.build":
        "jax.jit's compile of the plan: the port's plan runs eagerly",
    "ops/sampling.py fetch_window":
        "a TPU layout: reads a [rows, 128]-tiled adjacency window; the "
        "port samples from flat CSR arrays",
    "ops/segment.py flat_gather":
        "a TPU layout: gathers from 128-lane tiles; the port's arrays are "
        "flat",
    "ops/segment.py pair_gather":
        "a TPU layout: gathers lane pairs from 128-lane tiles",
    "ops/segment.py pack_pairs_host":
        "a TPU layout: packs host arrays into lane-pair tiles",
    "ops/segment.py pad_lanes_host":
        "a TPU layout: pads host arrays to 128 lanes",
    "ops/segment.py row_bounds_csr":
        "a TPU layout: a row's (start, end) from the tiled off_pairs "
        "table; the port reads row_offsets directly",
    "utils/platform.py ensure_platform":
        "selects JAX's backend (TPU or CPU); the port takes an explicit "
        "torch device (utils/platform.py resolve_device)",
    "utils/platform.py enable_compile_cache":
        "XLA's persistent compile cache; the port compiles no XLA programs",
    "utils/profiling.py profiling":
        "the always-on scope timer is the port's tracer's span (utils/"
        "profiling.py span: calls, total and self seconds per name, on "
        "while profiling.enable() is in force)",
    "utils/profiling.py annotate":
        "a named trace region is the port's tracer's span, which opens the "
        "profiler range glt.<name> while tracing is on",
}


def _tree(path):
    return ast.parse(path.read_text())


def _bound(tree):
    """Names a module binds at its top level (under if / try too)."""
    names = set()

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in n.names)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                names.update(x.id for t in targets for x in ast.walk(t)
                             if isinstance(x, ast.Name))
            elif isinstance(n, (ast.If, ast.Try)):
                visit(n.body)
                visit(n.orelse)
                for h in getattr(n, "handlers", []):
                    visit(h.body)
                visit(getattr(n, "finalbody", []))

    visit(tree.body)
    return names


def _members(cls):
    """What a class defines: methods, properties, fields, class
    attributes and the attributes ``__init__`` sets on ``self``."""
    out = set()
    for n in cls.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
            if n.name == "__init__":
                out.update(x.attr for x in ast.walk(n)
                           if isinstance(x, ast.Attribute)
                           and isinstance(x.ctx, ast.Store)
                           and isinstance(x.value, ast.Name)
                           and x.value.id == "self")
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return out


def _port_index():
    modules, classes = {}, {}
    for p in PORT_PKG.rglob("*.py"):
        tree = _tree(p)
        modules[str(p.relative_to(PORT_PKG))] = tree
        for n in ast.walk(tree):
            if isinstance(n, ast.ClassDef):
                classes.setdefault(n.name, []).append(n)
    return modules, classes


def _class_members(classes, name, seen=()):
    """Members of every port class called ``name`` and of its bases."""
    out = set()
    for cls in classes.get(name, []):
        out |= _members(cls)
        for b in cls.bases:
            base = b.id if isinstance(b, ast.Name) else getattr(b, "attr",
                                                                None)
            if base and base not in seen:
                out |= _class_members(classes, base, seen + (name,))
    return out


def _missing():
    modules, classes = _port_index()
    missing = []
    for p in sorted(JAX_PKG.rglob("*.py")):
        rel = str(p.relative_to(JAX_PKG))
        if rel.startswith("ops/pallas/"):
            continue
        port = modules.get(MOVED.get(rel, rel))
        bound = _bound(port) if port is not None else set()
        for n in _tree(p).body:
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) or n.name.startswith("_"):
                continue
            if n.name not in bound:
                missing.append("%s %s" % (rel, n.name))
                continue
            if isinstance(n, ast.ClassDef):
                have = _class_members(classes, n.name)
                missing += ["%s %s.%s" % (rel, n.name, m.name)
                            for m in n.body
                            if isinstance(m, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                            and not m.name.startswith("_")
                            and m.name not in have]
    return missing


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    unexplained = [m for m in _missing() if m not in NOT_PORTED]
    assert not unexplained, (
        "public names of graph_learn_tpu/ with no counterpart in "
        "graph_learn_tpu_torch/ and no reason in NOT_PORTED: %s"
        % unexplained)


def test_every_entry_of_the_list_is_still_missing_and_has_a_reason():
    missing = set(_missing())
    for name, why in NOT_PORTED.items():
        assert name in missing, "%s has a counterpart now: drop it" % name
        assert len(why.split()) >= 5, name


@pytest.mark.parametrize("name", ["graph.py Graph.close",
                                  "core/store.py DeviceCSR.num_rows"])
def test_the_guard_sees_a_missing_name(name, monkeypatch):
    """Without the port's counterpart the guard reports the name."""
    module, member = name.split(" ")
    cls, attr = member.split(".")
    real = _class_members

    def without(classes, n, seen=()):
        got = real(classes, n, seen)
        return got - {attr} if n == cls else got

    monkeypatch.setitem(globals(), "_class_members", without)
    assert name in _missing()
