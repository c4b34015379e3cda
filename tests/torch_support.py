"""Shared helpers of the tests that hold mvoc_tpu_torch against the JAX
package, and of scripts/torch_parity_goldens.py, which writes their stored
JAX outputs.  Imports no JAX."""

from __future__ import annotations

import contextlib
import hashlib
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_parity_goldens.npz")
# every file whose code the stored JAX outputs come from
GOLDEN_SOURCES = (
    "mvoc_tpu/io/media.py", "mvoc_tpu/io/trajectory.py", "mvoc_tpu/models/clip.py",
    "mvoc_tpu/models/layers.py", "mvoc_tpu/models/unet_i2vgen.py", "mvoc_tpu/models/vae.py",
    "mvoc_tpu/ops/attention.py", "mvoc_tpu/ops/conv.py", "mvoc_tpu/ops/ddim.py",
    "mvoc_tpu/ops/quantize.py", "mvoc_tpu/pipeline/core.py", "mvoc_tpu/pipeline/i2vgen.py",
    "mvoc_tpu/pnp.py", "mvoc_tpu/utils/testing.py", "scripts/torch_parity_goldens.py",
)
REGENERATE = "JAX_PLATFORMS=cpu python scripts/torch_parity_goldens.py"
# tier-1 runs six xdist workers on one host, one of them busy with
# tests/test_pipeline.py for most of the run; the port's test modules run
# this many niceness steps below it
NICENESS = 10


def golden_sources_digest() -> str:
    h = hashlib.sha256()
    for rel in GOLDEN_SOURCES:
        with open(os.path.join(ROOT, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()


def load_goldens() -> dict[str, np.ndarray]:
    """The stored JAX side, refused when the sources it came from changed."""
    with np.load(GOLDENS) as z:
        goldens = {k: z[k] for k in z.files}
    stored = str(goldens.pop("sources_digest", "none"))
    if stored != golden_sources_digest():
        pytest.fail(f"{os.path.relpath(GOLDENS, ROOT)} was written from other JAX sources "
                    f"than these ({', '.join(GOLDEN_SOURCES)}): regenerate goldens with "
                    f"`{REGENERATE}`")
    return goldens


def nest(flat: dict, prefix: str) -> dict:
    """{prefix/a/b: array} -> {a: {b: array}}."""
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def noisy_params(tree, rng):
    """Seeded noise of each leaf's shape: kernels ~ N(0, 1/fan_in), other
    leaves ~ 0.1 N(0, 1) (+1 for norm scales)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = noisy_params(v, rng)
            continue
        shp = tuple(v.shape)
        if len(shp) >= 2:
            a = rng.standard_normal(shp) / np.sqrt(np.prod(shp[:-1]))
        else:
            a = 0.1 * rng.standard_normal(shp) + (1.0 if k == "scale" else 0.0)
        out[k] = a.astype(np.float32)
    return out


def _thread_ids() -> list[int]:
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except FileNotFoundError:  # not Linux: the calling thread only
        return [0]


def _set_priority(tid: int, value: int) -> None:
    try:
        os.setpriority(os.PRIO_PROCESS, tid, min(19, value))
    except (PermissionError, ProcessLookupError):  # raising needs privilege; thread gone
        pass


@contextlib.contextmanager
def low_cpu_priority():
    """Run the body with one torch thread and every thread of this process
    NICENESS steps lower in CPU priority (Linux niceness is per thread, and
    compiler thread pools exist before the body starts), so that the test
    module fills idle cores rather than taking busy ones.  Both are restored
    afterwards; the priority only where the process may raise it again."""
    threads = torch.get_num_threads()
    before = {tid: os.getpriority(os.PRIO_PROCESS, tid) for tid in _thread_ids()}
    base = os.getpriority(os.PRIO_PROCESS, 0)
    torch.set_num_threads(1)
    for tid, prio in before.items():
        _set_priority(tid, prio + NICENESS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        for tid in _thread_ids():
            _set_priority(tid, before.get(tid, base))


@pytest.fixture(scope="module", autouse=True)
def yield_cpu():
    """Imported by a test module, runs the whole module at low CPU priority."""
    with low_cpu_priority():
        yield
