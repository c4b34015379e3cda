"""The arithmetic behind the metrics, on synthetic profiler stretches and
step records, the manifest against the benchmark's contract, and the keys
of a run's last line."""

import importlib.util
import json
import math
import os
import re

import pytest

from portbench import run as RUN
from portbench import trace as T
from portbench.readings import Readings
from portbench.reference.count import StepCount
from portbench.tests.conftest import tiny_geometry

MANIFEST = json.load(open(os.path.join(RUN.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def reader(name):
    path = os.path.join(RUN.BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readings(stretch=None, count=None, **kw):
    base = dict(seconds=10.0, steps=4.0, entries=1, step_intervals=[2.0, 2.0, 2.5],
                count=count, act_bytes=2, stretch=stretch)
    return Readings(**{**base, **kw})


def test_busy_is_the_union_of_kernel_intervals():
    s = T.Stretch([("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 3.0)], [], 4.0, 2)
    assert s.busy_s() == pytest.approx(2.5)
    assert reader("idle_share")(readings(s)) == pytest.approx(100 * (1 - 2.5 / 4.0))


def test_kernel_groups_and_no_ops():
    assert T.kernel_group("flash_wgmma_d64") == "K1 flash attention"
    assert T.kernel_group("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert T.kernel_group("sm90_xmma_gemm_bf16bf16") == "GEMM"
    assert T.kernel_group("s8_wgmma_kernel") == "K3 s8 GEMM"
    assert T.kernel_group("cudnn::norm_fwd") == "normalisation"
    s = T.Stretch([("vectorized_elementwise", 0.0, 0.3), ("reduce_kernel", 0.3, 0.4),
                   ("CatArrayBatchedCopy", 0.4, 0.6), ("flash_kernel", 0.6, 1.0)], [], 1.0, 2)
    assert reader("no_ops_ms")(readings(s)) == pytest.approx(1e3 * 0.6 / 2)


def test_idle_gaps_named_by_the_host_op_around_them():
    host = [("aten::conv", 0.0, 5.0, ""), ("cudaLaunchKernel", 1.1, 1.9, "aten::add")]
    s = T.Stretch([("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 4.0, 4.5)], host, 5.0, 1)
    gaps = s.idle_gaps()
    assert gaps == {"aten::add > cudaLaunchKernel": pytest.approx(1.0),
                    "aten::conv": pytest.approx(1.0)}


def test_k1_roofline_arithmetic():
    # one K1 launch: 10 x (1000 x 1000) at D = 64, bound by operations
    count = StepCount(1.0, [("token", 10, 1000, 1000, 64), ("frame", 5, 16, 16, 64),
                            ("token", 4, 64, 64, 64)], [])
    need = 4.0 * 10 * 1000 * 1000 * 64 / T.PEAK_BF16
    s = T.Stretch([("flash_wgmma_d64", 0.0, 4 * need)], [], 1.0, 2)
    assert reader("k1_roofline")(readings(s, count)) == pytest.approx(100 * 2 * need / (4 * need))
    assert reader("k1_roofline")(readings(s, StepCount(1.0, [], []))) is None


def test_k3_roofline_arithmetic_takes_the_larger_bound():
    m, k, n = 4096, 1280, 1280
    ops = 2.0 * m * k * n / T.PEAK_INT8
    byt = (m * k + k * n + 2 * m * n + 4 * (m + n)) / T.PEAK_BYTES
    count = StepCount(1.0, [], [(m, k, n, 2)])
    s = T.Stretch([("s8_wgmma_kernel", 0.0, 0.001)], [], 1.0, 1)
    assert reader("k3_roofline")(readings(s, count)) == pytest.approx(100 * max(ops, byt) / 0.001)
    assert reader("k3_roofline")(readings(s, StepCount(1.0, [], []))) is None


def test_mfu_and_shares():
    count = StepCount(456e12, [], [])
    r = readings(count=count, steps=17.25, seconds=45.0)
    assert reader("mfu")(r) == pytest.approx(100 * 456e12 * 17.25 / 45.0 / T.PEAK_BF16)
    assert reader("step_s.median")(r) == 2.0
    assert reader("outside_steps_share")(r) == pytest.approx(100 * (1 - 17.25 * 2.0 / 45.0))
    assert reader("step_s.median")(readings(step_intervals=[])) is None


def test_window_counts_the_step_cut_short_by_its_share():
    # call 0: steps end at 1, 2, 3; call 1 (after its preparation): 5, 6
    marks = [(0, 0, 1.0), (0, 1, 2.0), (0, 2, 3.0), (1, 0, 5.0), (1, 1, 6.0)]
    assert RUN.finished_steps([t for *_, t in marks], 5.5) == pytest.approx(4.5)
    assert RUN.finished_steps([t for *_, t in marks], 4.0) == pytest.approx(3.5)
    assert RUN.step_intervals(marks) == [1.0, 1.0, 1.0]


def test_manifest_keeps_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(MANIFEST) == keys
    names = [x["name"] for x in MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in MANIFEST["configs"]:
        assert os.path.exists(os.path.join(RUN.ROOT, c["file"]))
    config_names = {c["name"] for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert w["config"] in config_names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(RUN.BENCH_DIR, "workloads", f"{w['traffic']}.json"))
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(RUN.BENCH_DIR, "metrics", f"{m['name']}.py"))
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in MANIFEST["workloads"]}
    rs = MANIFEST["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_last_line_keys(tmp_path):
    res = RUN.run_cell("composite-720p", 11, 0.0, True, device="cpu",
                       geometry=tiny_geometry(False))
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device", "breakdown"} <= set(res)
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"} <= set(
        res["device"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)
