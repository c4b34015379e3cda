"""What the benchmark may import: nothing of JAX or the JAX package
(`mvoc_tpu`, compared by whole top-level names: the port `mvoc_tpu_torch`
is not it), and, in the yardstick (the reference, the inputs, the traces'
reduction, the metric readers), nothing of the port either."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench import run as RUN

BENCH = os.path.join(RUN.ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "mvoc_tpu"}
# every file of the benchmark but these two stays clear of the port
PROGRAM_SIDE = {"program.py", "run.py"}


def imported_tops(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources():
    return sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_sources_import_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in sources() if "tests" not in p.split(os.sep)
                                  and os.path.basename(p) not in PROGRAM_SIDE],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_yardstick_imports_no_program(path):
    assert "mvoc_tpu_torch" not in imported_tops(path)


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=RUN.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": RUN.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_no_program():
    last = _fresh("import sys, portbench.reference.model, portbench.reference.pipeline, "
                  "portbench.reference.count, portbench.check, portbench.inputs; "
                  "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                  "('mvoc_tpu_torch', 'mvoc_tpu', 'jax', 'jaxlib', 'flax')))")
    assert last == "[]"


def test_a_run_loads_no_jax():
    """A whole run (tiny geometry, CPU) leaves no JAX module loaded."""
    last = _fresh(
        "from portbench import run as R\n"
        "from portbench.tests.conftest import tiny_geometry\n"
        "R.run_cell('composite-720p', 7, 0.0, True, device='cpu', geometry=tiny_geometry(False))\n"
        "print(R.forbidden_modules())")
    assert last == "[]"
