"""The booking of the card's idle time to the program's spans
(portbench/spans.py) and the three metrics that read it, on synthetic
stretches."""

import json
import os

import pytest

from portbench import run as RUN
from portbench import spans as S
from portbench import trace as T
from portbench.tests.test_portbench_metrics import MANIFEST, reader, readings

NEW = ("idle_step_loop_ms", "idle_unet_ms", "idle_int8_glue_ms")


def test_split_gaps_are_booked_exactly():
    # kernels leave gaps [1, 3] and [4, 6]; the host's spans overlap them in
    # part, and an aten op and a name of no layer open no span
    kernels = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 7.0)]
    host = [("step", 0.5, 1.5, ""), ("I2VGenXLUNet", 1.2, 5.0, ""),
            ("I2VGenXLUNet/up_blocks.1/resnets.0", 1.5, 2.5, "I2VGenXLUNet"),
            ("int8/linear", 2.5, 2.75, "I2VGenXLUNet"), ("aten::mul", 2.6, 2.7, "int8/linear"),
            ("entry/decode", 5.5, 5.75, ""), ("not a span", 5.75, 6.0, "")]
    s = T.Stretch(kernels, host, 7.0, 2)
    got = S.idle_by_span(s)
    # gap [1, 3]: step to 1.2, then the UNet span (opened later) to 1.5, the
    # sub-block to 2.5, the glue to 2.75, the UNet to 3; gap [4, 6]: the UNet
    # to 5, nothing to 5.5, entry/decode to 5.75, nothing to 6
    want = {"step": 0.2, "I2VGenXLUNet": 0.3 + 0.25 + 1.0,
            "I2VGenXLUNet/up_blocks.1/resnets.0": 1.0, "int8/linear": 0.25,
            "entry/decode": 0.25, None: 0.5 + 0.25}
    assert got == {k: pytest.approx(v, abs=1e-12) for k, v in want.items()}
    assert sum(got.values()) == pytest.approx(sum(s.idle_gaps().values()), abs=1e-12)


def test_a_gap_deep_inside_an_old_span_is_booked_to_it():
    """The span opened thousands of host events before the gap: no window
    of recent events limits the search."""
    host = [("I2VGenXLUNet/mid_block", 0.0, 10.0, "")]
    host += [(f"aten::op{i}", 1e-3 * i, 1e-3 * i + 5e-4, "I2VGenXLUNet/mid_block")
             for i in range(3000)]
    kernels = [("k", 0.0, 1.0), ("k", 9.0, 9.5)]
    s = T.Stretch(kernels, host, 10.0, 1)
    assert S.idle_by_span(s) == {"I2VGenXLUNet/mid_block": pytest.approx(8.0)}
    assert s.idle_gaps() == {"(no host op)": pytest.approx(8.0)}


def test_the_metrics_and_the_unbooked_idle_sum_to_the_gap_idle():
    kernels = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 4.0, 5.0), ("k", 6.0, 7.0),
               ("k", 8.0, 9.0)]
    host = [("step", 0.0, 7.6, ""), ("step/fusion", 1.0, 1.5, "step"),
            ("I2VGenXLUNet", 2.5, 7.5, "step"), ("I2VGenXLUNet/conv_in", 3.0, 4.5, ""),
            ("int8/conv", 5.0, 5.75, ""), ("int8/s8_matmul", 5.25, 5.5, "int8/conv"),
            ("entry/sample_composite", 7.75, 10.0, "")]
    s = T.Stretch(kernels, host, 10.0, 2)
    r = readings(s)
    step, unet, glue = (reader(n)(r) for n in NEW)
    # gaps [1, 2], [3, 4], [5, 6], [7, 8]
    assert step == pytest.approx(1e3 * (1.0 + 0.1) / 2)  # [1, 2], [7.5, 7.6]
    assert unet == pytest.approx(1e3 * (1.0 + 0.25 + 0.5) / 2)  # [3, 4], [5.75, 6], [7, 7.5]
    assert glue == pytest.approx(1e3 * 0.75 / 2)  # [5, 5.75]
    unbooked = S.idle_by_span(s).get(None, 0.0)
    entry = S.idle_by_span(s)["entry/sample_composite"]
    gap = sum(s.idle_gaps().values())
    assert unbooked == pytest.approx(0.15) and entry == pytest.approx(0.25)
    assert (step + unet + glue) * 2 / 1e3 + entry + unbooked == pytest.approx(gap)


def test_metrics_read_nothing_without_their_spans():
    kernels = [("k", 0.0, 1.0), ("k", 2.0, 3.0)]
    bare = T.Stretch(kernels, [("aten::mul", 1.0, 2.0, "")], 3.0, 1)
    for name in NEW:
        assert reader(name)(readings(bare)) is None
        assert reader(name)(readings(None)) is None
    unet_only = T.Stretch(kernels, [("I2VGenXLUNet/conv_in", 1.0, 2.0, "")], 3.0, 1)
    assert reader("idle_unet_ms")(readings(unet_only)) == pytest.approx(1e3)
    assert reader("idle_int8_glue_ms")(readings(unet_only)) is None


def test_the_int8_glue_metric_is_read_in_its_cell_alone():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert set(NEW) <= set(entries)
    assert entries["idle_int8_glue_ms"]["workloads"] == ["composite-512-stream-int8"]
    assert "workloads" not in entries["idle_step_loop_ms"]
    assert "workloads" not in entries["idle_unet_ms"]
    for name in NEW:
        assert entries[name]["source"] == "device_trace"
        assert entries[name]["moves"] == "video_steps_per_s"
        assert os.path.exists(os.path.join(RUN.BENCH_DIR, "metrics", f"{name}.py"))
    kernels = [("k", 0.0, 1.0), ("k", 2.0, 3.0)]
    s = T.Stretch(kernels, [("int8/linear", 1.0, 2.0, "")], 3.0, 1)
    cell = {"name": "composite-720p"}
    got = RUN._per_layer(MANIFEST, cell, readings(s))
    assert "idle_int8_glue_ms" not in got
    got = RUN._per_layer(MANIFEST, {"name": "composite-512-stream-int8"}, readings(s))
    assert got["idle_int8_glue_ms"]["value"] == pytest.approx(1e3)
    json.dumps(got)
