"""Import boundary of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither jax nor anything of the reference package ``repro``, and
importing the port builds and loads no kernel library."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
