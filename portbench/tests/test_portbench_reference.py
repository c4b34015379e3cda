"""The benchmark's plain reference against the port, on the CPU at a tiny
geometry: whole runs of the harness (set-up, window, comparison) on the
fused and streamed composite paths and the batched inversion, in float32
and int8-mixed; the w8a8 layers one by one; and the reference's operation
count against the port's own count (utils/flops.py)."""

import json
import os
import shutil

import pytest
import torch

from portbench import run as RUN
from portbench.reference import count as K
from portbench.reference import model as M
from portbench.tests.conftest import TINY_CONFIG, tiny_geometry

SEED = 2 ** 33 + 5
# float32 on both sides: the two differ by the order of float32 roundings
FLOAT_TOL = 1e-4
# int8 rounding is discontinuous: where the two sides' float32 activations
# differ by a rounding, a value can land on the next int8 level, and at the
# tiny widths one such level moves a step by some percent.  The layers
# themselves agree to float32 rounding (test_w8a8_layers_match_program).
INT8_TOL = 0.25


def bench_root(tmp_path, extra: dict | None = None) -> str:
    """A copy of BENCHMARK.json and portbench's data files, with one more
    cell whose workload file is `extra` (a test-only cell)."""
    root = str(tmp_path / "root")
    os.makedirs(os.path.join(root, "portbench"))
    for sub in ("configs", "workloads"):
        shutil.copytree(os.path.join(RUN.ROOT, "portbench", sub),
                        os.path.join(root, "portbench", sub))
    with open(os.path.join(RUN.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    if extra is not None:
        manifest["workloads"].append({"name": extra["name"], "config": extra["config"],
                                      "traffic": extra["name"], "chips": 1, "why": "test"})
        with open(os.path.join(root, "portbench", "workloads", f"{extra['name']}.json"), "w") as f:
            json.dump(extra, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


def composite_variant(name: str, path: str, config: str) -> dict:
    """The 720p cell's workload on another path and configuration."""
    with open(os.path.join(RUN.ROOT, "portbench", "workloads", "composite-720p.json")) as f:
        wl = json.load(f)
    two_pass = {"fused": False, "two_pass": True, "stream": "stream"}[path]
    return {**wl, "name": name, "config": config, "path": path,
            "call": {**wl["call"], "two_pass": two_pass}}


def inversion_workload(name: str, config: str) -> dict:
    return {"name": name, "config": config, "entry_point": "invert_batch", "path": "inversion",
            "why": "test", "call": {"width": 32, "height": 16, "frames": 4, "entries": 2,
                                    "n_steps": 6, "fps": 8, "prompt": ""},
            "warmup_steps": 1, "trace": {"from_step": 1, "steps": 2},
            "check": {"later_steps": 2, "limits": {"start_step": 1.0, "later_step": 1.0}}}


@pytest.mark.parametrize("path", ["fused", "stream", "inversion"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_step_matches_program(tmp_path, path, int8):
    config = "i2vgen-xl-w8a8-mixed" if int8 else "i2vgen-xl-bf16"
    name = f"test-{path}"
    extra = (inversion_workload(name, config) if path == "inversion"
             else composite_variant(name, path, config))
    res = RUN.run_cell(name, SEED, 0.0, False, device="cpu", geometry=tiny_geometry(int8),
                       root=bench_root(tmp_path, extra))
    checks = {k: v["value"] for k, v in res["checks"].items()}
    tol = INT8_TOL if int8 else FLOAT_TOL
    assert checks["steps_compared"] >= 2
    assert checks["start_step"] < tol and checks["later_step"] < tol, checks


def test_w8a8_layers_match_program():
    from mvoc_tpu_torch.models import layers as L
    from mvoc_tpu_torch.ops import quantize as Q

    torch.manual_seed(0)
    lin = torch.nn.Linear(64, 48)
    x = torch.randn(10, 7, 64)
    ref = M.QLinear(lin, M.Precision())(x)
    got = Q.QuantLinear(lin.weight, lin.bias)(x)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    # per-token scales (at most 4096 rows) and per-sample scales (more)
    for shape in [(1, 4, 8, 8), (2, 4, 32, 32), (5, 16, 8, 8)]:
        conv = L.Conv3d(32, 32, (3, 1, 1), padding=(1, 0, 0))
        mine = M.Conv3d(32, 32, (3, 1, 1), padding=(1, 0, 0))
        mine.load_state_dict(conv.state_dict())
        x5 = torch.randn(*shape, 32)
        ref = M.QConv3d(mine, M.Precision())(x5)
        got = Q.QuantConv(conv)(x5)
        assert (got - ref).abs().max() <= 1e-6 * ref.abs().max(), shape


@pytest.mark.parametrize("case", ["512-stream-5", "720p-fused-j2"])
def test_full_width_count_matches_port(case):
    """utils/flops.py's counts of the same steps (PERF.md, PR 10)."""
    if case == "512-stream-5":
        got = K.unet_step_count({}, 16, 64, 64, [5]).flops
        assert got == 104.67545350144e12
    else:
        got = K.unet_step_count({}, 16, 90, 160, K.call_batches("fused", 2, 2)).flops
        assert got == 912950314434560.0


@pytest.mark.parametrize("path", ["fused", "stream"])
def test_tiny_count_matches_port_counter(path):
    from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet, UNetConfig
    from mvoc_tpu_torch.utils.flops import matmul_flops_by_class

    cfg = TINY_CONFIG["unet"]
    unet = I2VGenXLUNet(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in cfg.items()}))
    f, h, w, text = 4, 8, 16, 12
    total = 0.0
    batches = K.call_batches(path, 1, 2)
    for b in batches:
        args = (torch.zeros(b, f, h, w, 4), 500, torch.full((b,), 8),
                torch.zeros(b, f, h, w, 4), torch.zeros(b, f, h, w, 4),
                torch.zeros(b, f, 16), torch.zeros(b, text, 16))
        with torch.inference_mode():
            total += matmul_flops_by_class(unet, *args)["total"]
    assert K.unet_step_count(cfg, f, h, w, batches, text_len=text).flops == total
