"""mvoc_tpu_torch and chip_smoke.py import nothing of JAX or the JAX package,
nor the packages the JAX loader takes a checkpoint with (safetensors,
transformers, regex, ftfy): the port carries its own safetensors reader and
CLIP tokenizer."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "mvoc_tpu", "safetensors", "transformers", "regex", "ftfy")


def _sources():
    yield from sorted((ROOT / "mvoc_tpu_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_or_jax_package_imports():
    bad = [(str(p.relative_to(ROOT)), m) for p in _sources() for m in _imported(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_package_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "mvoc_tpu_torch").rglob("*.py"))
    code = (f"import sys\nfor m in {FORBIDDEN!r}: sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_native_codec_is_the_ports_own():
    """io/native.py builds and loads csrc/traj_codec.cpp of the port, never
    the JAX package's native/ library."""
    from mvoc_tpu_torch.io import native

    src = pathlib.Path(native.SOURCE).resolve()
    assert src.is_relative_to(ROOT / "mvoc_tpu_torch" / "csrc") and src.exists()
    assert not pathlib.Path(native.library_path()).resolve().is_relative_to(ROOT / "native")
