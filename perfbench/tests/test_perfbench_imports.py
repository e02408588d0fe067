"""Nothing the benchmark runs is JAX or the JAX package, compared by whole
top-level module names; the reference imports nothing of the program."""
import ast
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

PKG = ROOT / "perfbench"
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_top_level_name(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert names <= {"__future__", "math", "typing", "contextlib", "wave",
                     "types", "numpy", "torch", "perfbench"}, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference")


def test_forbidden_names_compare_whole():
    assert "index_tts_dubbing_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    code = ("import sys; sys.path.insert(0, %r);"
            "import perfbench.harness as h, perfbench.reference;"
            "import index_tts_dubbing_tpu_torch.engine.tts;"
            "print(h.forbidden_modules())" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_modules_sees_the_jax_package(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "index_tts_dubbing_tpu.engine",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["index_tts_dubbing_tpu"]
