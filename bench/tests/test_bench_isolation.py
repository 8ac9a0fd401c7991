"""Nothing the harness runs loads JAX or the JAX package; the reference
imports nothing of the port.  Top-level names are compared whole:
``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from bench.run import FORBIDDEN, forbidden_modules
from conftest import ROOT

BENCH = ROOT / "bench"


def _top_level_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_harness(path):
    assert not set(_top_level_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_level_imports(path))
    assert "repro_torch" not in names
    mods = {n for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.ImportFrom) and n.module
            and n.module.startswith("bench.")}
    assert all(m.module.split(".")[1] in ("reference", "weights")
               for m in mods)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_run_loads_no_jax():
    names = _loaded("import sys, bench.run, bench.kinds.train, "
                    "bench.control; from bench.spec import reader; "
                    "[reader(m) for m in ('train_mfu', 'gradstats_roofline')]; "
                    "print(*{n.split('.')[0] for n in sys.modules})")
    assert "repro_torch" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded("import sys, bench.reference.train; "
                    "print(*{n.split('.')[0] for n in sys.modules})")
    assert not names & (set(FORBIDDEN) | {"repro_torch"})


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.configs", sys)
    assert "repro" in forbidden_modules()
