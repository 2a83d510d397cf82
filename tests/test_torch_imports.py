"""Import boundary of the port: ``src/repro_torch``, ``chip_smoke.py`` and
the mesh tests' rank workers (``tests/torch_*mesh_worker.py``) import
neither jax nor anything of the reference package ``repro``, name
no reference module in a string (a spawn command or import spec would run
the reference's workers), importing the port builds and loads no kernel
library, and the protocol linter's worker-purity, atomic-write and
tmp-invisible rules hold when pointed at the port's module names."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tests").glob("torch_*mesh_worker.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_port_files_exist():
    assert (PORT / "__init__.py").is_file()
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [f"{path.name}:{line} imports {name}"
           for line, name in _imported_modules(tree) if _forbidden(name)]
    # importlib.import_module("repro...") would dodge the AST check
    bad += [f"{path.name}:{n.lineno} imports {n.args[0].value} dynamically"
            for n in ast.walk(tree)
            if isinstance(n, ast.Call) and n.args
            and isinstance(n.args[0], ast.Constant)
            and isinstance(n.args[0].value, str)
            and getattr(n.func, "attr", getattr(n.func, "id", None))
            in ("import_module", "__import__")
            and _forbidden(n.args[0].value)]
    assert not bad, bad


def test_triton_and_kernel_libraries_never_at_module_scope():
    for path in FILES:
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(n and n.split(".")[0] == "triton"
                               for n in names), path


def test_importing_the_port_builds_and_loads_nothing():
    """Every module of the port imports with nvcc and ctypes loading
    disabled, no jax or repro module ends up imported, and no kernel
    library was loaded."""
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = f"""
import ctypes, json, subprocess, sys
import numpy, torch   # their own libraries load first
def refuse(*a, **k):
    raise AssertionError("kernel build or load at import time")
ctypes.CDLL = refuse
subprocess.Popen = refuse
import importlib
for name in {modules!r}:
    importlib.import_module(name)
from repro_torch.kernels import _build
print(json.dumps({{"loaded": sorted(_build._loaded),
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "repro"))}}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"loaded": [], "foreign": []}


# ---------------------------------------------------------------------------
# The queue runtime's two traps: module paths in strings, and the protocol
# linter's module names
# ---------------------------------------------------------------------------

# a reference module named in a string: "repro.runtime.mq", "-m repro.x",
# "repro.fitness.hostsim:sphere"
REFERENCE_NAME = re.compile(r"(?<![\w.])repro\.[a-z_]")
REFERENCE_SPAWN = re.compile(r"-m\s+repro\.")
PORT_WORKERS = ("repro_torch.runtime.mq", "repro_torch.runtime.batchq",
                "repro_torch.runtime.netbroker")


def _docstring_ids(tree):
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                ids.add(id(first.value))
    return ids


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_reference_module(path):
    """A spawn command, script or import spec that names ``repro.`` would
    quietly run the reference's workers on the shared protocol. Docstrings
    may name the module a file ports, but never spawn it."""
    tree = ast.parse(path.read_text(), str(path))
    docs = _docstring_ids(tree)
    bad = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        text = node.value
        if REFERENCE_SPAWN.search(text) or (
                id(node) not in docs and REFERENCE_NAME.search(text)):
            bad.append(f"{path.name}:{node.lineno} {text[:60]!r}")
    assert not bad, bad


def test_string_guard_catches_the_reference_spawn_forms():
    for text in ('"repro.runtime.mq"', '"repro.fitness.hostsim:sphere"',
                 "-m repro.runtime.batchq --worker"):
        assert REFERENCE_NAME.search(text) or REFERENCE_SPAWN.search(text)
    for text in ("repro_torch.runtime.mq", "python -m repro_torch.obs",
                 "src/repro/runtime/mq.py"):
        assert not (REFERENCE_NAME.search(text)
                    or REFERENCE_SPAWN.search(text))


def test_worker_purity_of_the_ports_entry_points():
    from repro.analysis.core import load_universe
    from repro.analysis.imports import build_import_graph, \
        check_worker_purity
    universe = load_universe([str(ROOT / "src")])
    findings = check_worker_purity(universe, entrypoints=PORT_WORKERS)
    assert findings == [], "\n".join(map(str, findings))
    # the check reaches the port: its closure holds the three workers and
    # the numpy-only core module they import
    graph = build_import_graph(universe)
    closure = graph.closure(PORT_WORKERS)
    assert set(PORT_WORKERS) | {"repro_torch.core.hostbridge",
                                "repro_torch.runtime.fsatomic"} \
        <= set(closure)
    assert "repro_torch.core.broker" not in closure


def _enclosing(tree, line):
    """Dotted names of the classes and functions around ``line``."""
    names = []
    node = tree
    while True:
        inner = [c for c in ast.iter_child_nodes(node)
                 if isinstance(c, (ast.ClassDef, ast.FunctionDef,
                                   ast.AsyncFunctionDef))
                 and c.lineno <= line <= c.end_lineno]
        if not inner:
            return ".".join(names)
        node = inner[0]
        names.append(node.name)


def _keyed(findings, universe, strip):
    by_path = {sf.path: sf for sf in universe}
    keys = []
    for f in findings:
        sf = by_path[f.path]
        keys.append((sf.module.removeprefix(strip), f.rule,
                     _enclosing(sf.tree, f.line)))
    return keys


def test_atomic_write_and_tmp_invisible_hold_on_the_port(monkeypatch):
    """Both rules, their module tuples pointed at the port's names, give
    zero findings beyond the reference's own exceptions: every raw finding
    on the port sits in a function where the reference carries a
    ``lint: allow`` for the same rule (and the port marks it
    ``# exception[rule]``), one for one. The port's copies carry no
    ``lint: allow`` comments: under the default module tuples they would
    read as stale."""
    from collections import Counter

    from repro.analysis import atomic, tmpvis
    from repro.analysis.core import load_universe
    universe = load_universe([str(ROOT / "src")])
    ref_allowed = []
    for check in (atomic.check_atomic_writes, tmpvis.check_tmp_invisible):
        raw = check(universe)
        kept = [f for f in raw if f.rule in next(
            sf for sf in universe if sf.path == f.path).allowed_rules(f.line)]
        assert len(kept) == len(raw)     # the reference lints clean
        ref_allowed += _keyed(kept, universe, "repro.")
    port_protocol = tuple(m.replace("repro.", "repro_torch.", 1)
                          for m in atomic.PROTOCOL_MODULES)
    port_tmpvis = tuple(m.replace("repro.", "repro_torch.", 1)
                        for m in tmpvis.TMPVIS_MODULES)
    monkeypatch.setattr(atomic, "PROTOCOL_MODULES", port_protocol)
    monkeypatch.setattr(tmpvis, "TMPVIS_MODULES", port_tmpvis)
    port_raw = (atomic.check_atomic_writes(universe)
                + tmpvis.check_tmp_invisible(universe))
    assert port_raw, "the rules did not reach the port"
    assert all(f.path.startswith(str(PORT)) for f in port_raw)
    port_keys = _keyed(port_raw, universe, "repro_torch.")
    assert Counter(port_keys) == Counter(ref_allowed)
    by_path = {sf.path: sf for sf in universe}
    for f in port_raw:
        sf = by_path[f.path]
        marks = [sf.lines[i - 1] for i in range(max(1, f.line - 6),
                                                 f.line + 1)]
        assert any(f"# exception[{f.rule}]" in m for m in marks), str(f)
