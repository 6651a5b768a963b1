"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port, ``repro_torch``, begins with the
JAX package's name ``repro``), and nothing reads ``benchmarks/``."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from annbench import harness

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "annbench").rglob("*.py"))


def _imported(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            tops |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_no_jax_package_no_benchmarks_dir(path):
    assert not _imported(path) & set(harness.FORBIDDEN_MODULES)
    assert not re.search(r"""["'/]benchmarks[/"']""", path.read_text())


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", sys)
    assert "repro_torch_probe" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.probe", sys)
    assert "repro.probe" in harness.forbidden_loaded()


def test_a_run_loads_neither():
    """A whole run on the CPU in a fresh process: afterwards no module of
    JAX or the JAX package is loaded."""
    code = """
import io, sys, time
from contextlib import redirect_stderr
from pathlib import Path
root = Path(sys.argv[1]); sys.path[:0] = [str(root), str(root / "src")]
from annbench import conftest, harness
with redirect_stderr(io.StringIO()):
    rc = harness.run(root, "sift1m.search", 5, 0.01, True, time.perf_counter(), device="cpu",
                     require_gpu=False, overrides=conftest.SMALL, out=io.StringIO())
print(rc, harness.forbidden_loaded())
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["0", "[]"]
