"""The port's spans (utils.profiling.span): the gate on torch's profiler
flag, the span tree of a tiny int8 stream composite under a CPU profiler,
device_op_breakdown's by_span and by_op tables, and StepTimer's stages as
spans."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mvoc_tpu_torch.io.trajectory import TrajectoryStore
from mvoc_tpu_torch.ops import quantize
from mvoc_tpu_torch.ops.ddim import sampling_timesteps
from mvoc_tpu_torch.utils import profiling
from mvoc_tpu_torch.utils import testing as tt

F, HW, N_OBJ, N_STEPS, T0 = 2, 16, 1, 3, 1


def test_span_is_gated_on_the_profiler_flag():
    """No profiler: the shared no-op, nothing recorded.  Under a CPU profiler:
    a record_function scope that lands among the events.  Fails if torch
    stops setting the flag the gate reads."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    off = profiling.span("entry/off")
    assert off is profiling.span("step") is profiling._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled is True
        on = profiling.span("entry/on")
        assert isinstance(on, record_function)
        with on, off:
            torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert "entry/on" in names and "entry/off" not in names
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiling.is_span("I2VGenXLUNet") and profiling.is_span("step")
    assert profiling.is_span("int8/s8_matmul") and not profiling.is_span("stepper")


class _Span:
    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end
        self.parent, self.children = None, []

    def ancestors(self):
        p = self.parent
        while p is not None:
            yield p
            p = p.parent

    def descendants(self):
        for c in self.children:
            yield c
            yield from c.descendants()


def _span_tree(prof) -> list:
    """The recorded spans (and the test's own `callback` scopes) as a tree,
    nested by time on each thread: read from the profiler's raw events,
    which skips building a FunctionEvent for each of the ~10^5 aten ops."""
    by_thread = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if profiling.is_span(name) or name == "callback":
            by_thread.setdefault(e.start_thread_id(), []).append(
                _Span(name, e.start_ns(), e.start_ns() + e.duration_ns()))
    out = []
    for spans in by_thread.values():
        spans.sort(key=lambda s: (s.start, -s.end))
        stack = []
        for s in spans:
            while stack and stack[-1].end <= s.start:
                stack.pop()
            if stack:
                s.parent = stack[-1]
                stack[-1].children.append(s)
            stack.append(s)
        out += spans
    return out


@pytest.fixture(scope="module")
def traced_stream_call(tmp_path_factory):
    """A tiny int8 stream composite through sample_composite, decode
    included, under a CPU profiler (every layer of up_blocks.1 quantized:
    linears, 2D convs through im2col, stacked temporal convs); the step
    callback opens a scope of its own.  Returns (the span tree, the
    quantized layers' calls, the run steps)."""
    pipe = tt.build_tiny_pipeline(device="cpu", natural=True)
    pipe.enable_int8(predicate=lambda names: quantize.default_unet_predicate(names)
                     and "up_blocks.1." in ".".join(names))
    calls = [0]
    for m in pipe.unet.modules():
        if isinstance(m, (quantize.QuantLinear, quantize.QuantConv)):
            m.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    ts = sampling_timesteps(pipe.scheduler_config, N_STEPS)
    lat = HW // pipe.vae_scale_factor
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("stores")
    stores = []
    for j in range(N_OBJ + 1):
        store = TrajectoryStore(str(root / f"src{j}"))
        store.save(ts, rng.standard_normal((len(ts), F, lat, lat, 4)).astype(np.float32))
        stores.append(store)
    masks = np.zeros((N_OBJ, F, lat, lat), np.float32)
    masks[:, :, :1] = 1.0
    frames = tt.tiny_frames(n=F, seed=5)

    def callback(i):
        with record_function("callback"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.sample_composite(
            "a cat", frames[0], frames, tt.tiny_frames(n=F, seed=0),
            [tt.tiny_frames(n=F, seed=1 + j) for j in range(N_OBJ)], masks, masks,
            stores[0], stores[1:], height=HW, width=HW, num_frames=F,
            num_inference_steps=N_STEPS, guidance_scale=3.0, two_pass="stream",
            ddim_init_latents_t_idx=T0, fusion_steps=(0, 1), step_callback=callback)
    return _span_tree(prof), calls[0], N_STEPS - T0


def test_span_tree_of_an_int8_stream_call(traced_stream_call):
    spans, layer_calls, n_run = traced_stream_call
    by = lambda name: [e for e in spans if e.name == name]  # noqa: E731

    # the entry point and its preparation
    (entry,) = by("entry/sample_composite")
    inside = {d.name for d in entry.descendants()}
    for child in ("entry/encode_prompt", "entry/encode_image", "entry/encode_vae",
                  "entry/trajectory_upload", "entry/mask_pyramids", "entry/decode"):
        assert child in inside, child

    # one `step` a run step, closed before the callback
    steps = by("step")
    assert len(steps) == n_run and len(by("callback")) == n_run
    for cb in by("callback"):
        assert not any(a.name.startswith("step") for a in cb.ancestors())
    for i, step in enumerate(steps):
        kids = [c.name for c in step.children]
        assert kids.count("step/capture") == N_OBJ + 1
        assert kids.count("step/edit") == 1 and kids.count("step/guidance_ddim") == 1
        assert kids.count("step/fusion") == (1 if i == 0 else 0)
        for c in step.children:
            if c.name in ("step/capture", "step/edit"):
                assert [g.name for g in c.children] == ["I2VGenXLUNet"]

    # the UNet: N+2 forwards a step, its children and their sub-blocks
    unets = by("I2VGenXLUNet")
    assert len(unets) == n_run * (N_OBJ + 2)
    names = {d.name for d in unets[0].descendants()}
    for want in ("I2VGenXLUNet/conv_in", "I2VGenXLUNet/down_blocks.0/resnets.0",
                 "I2VGenXLUNet/down_blocks.0/attentions.0",
                 "I2VGenXLUNet/down_blocks.0/temp_convs.1",
                 "I2VGenXLUNet/down_blocks.0/temp_attentions.0",
                 "I2VGenXLUNet/down_blocks.0/downsamplers.0",
                 "I2VGenXLUNet/mid_block/resnets.1", "I2VGenXLUNet/up_blocks.0/upsamplers.0",
                 "I2VGenXLUNet/up_blocks.1/temp_attentions.2"):
        assert want in names, want
    for e in spans:
        if e.name.startswith("I2VGenXLUNet/") and e.name.count("/") == 2:
            assert e.parent.name == e.name.rsplit("/", 1)[0], (e.name, e.parent.name)

    # one int8 layer span per quantized layer call, each with its K3 call
    layers = [e for e in spans if e.name in ("int8/linear", "int8/conv")]
    assert layer_calls > 0 and len(layers) == layer_calls
    for e in layers:
        inner = [d.name for d in e.descendants()]
        assert inner.count("int8/s8_matmul") == 1 and inner.count("int8/quantize") == 1
        assert any(a.name.startswith("I2VGenXLUNet/up_blocks.1/") for a in e.ancestors())
    assert {e.parent.name for e in by("int8/im2col")} == {"int8/conv"}


def _event(cat, name, pid, tid, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, pid=pid, tid=tid, ts=ts, dur=dur, args=args)


def test_device_op_breakdown_by_span_and_by_op(tmp_path):
    """Kernels booked through their launch to the innermost span (at full
    name) and the innermost aten op around it; module and group tables as
    before; every table sums to total_s."""
    host, dev = 1, 0
    events = [
        _event("user_annotation", "step", host, 1, 0, 1000),
        _event("user_annotation", "I2VGenXLUNet", host, 1, 50, 800),
        _event("user_annotation", "I2VGenXLUNet/up_blocks.1", host, 1, 100, 500),
        _event("user_annotation", "I2VGenXLUNet/up_blocks.1/resnets.0", host, 1, 110, 200),
        _event("user_annotation", "int8/linear", host, 1, 400, 100),
        _event("user_annotation", "int8/s8_matmul", host, 1, 450, 40),
        _event("user_annotation", "not a span", host, 1, 120, 30),
        _event("user_annotation", "step/guidance_ddim", host, 1, 900, 50),
        _event("cpu_op", "aten::group_norm", host, 1, 115, 60),
        _event("cpu_op", "aten::mul", host, 1, 410, 20),
        _event("cpu_op", "aten::add", host, 1, 905, 20),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 125, 5, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 415, 5, correlation=2),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 460, 5, correlation=3),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 910, 5, correlation=4),
        _event("cuda_runtime", "cudaLaunchKernel", host, 1, 700, 5, correlation=5),
        _event("kernel", "vectorized_elementwise_kernel", dev, 7, 2000, 30, correlation=1),
        _event("kernel", "elementwise_kernel<mul>", dev, 7, 2030, 10, correlation=2),
        _event("kernel", "s8_wgmma_kernel", dev, 7, 2040, 50, correlation=3),
        _event("kernel", "vectorized_elementwise_kernel", dev, 7, 2090, 7, correlation=4),
        _event("kernel", "flash_wgmma_d64<64>", dev, 7, 2100, 40, correlation=5),
        _event("kernel", "unlaunched", dev, 7, 2140, 3, correlation=99),
    ]
    (tmp_path / "run").mkdir()
    with open(tmp_path / "run" / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    out = profiling.device_op_breakdown(str(tmp_path))
    us = 1e-6
    approx = lambda d: {k: pytest.approx(v * us, rel=1e-12) for k, v in d.items()}  # noqa: E731
    assert out["by_span"] == approx({"I2VGenXLUNet/up_blocks.1/resnets.0": 30,
                                     "int8/linear": 10, "int8/s8_matmul": 50,
                                     "step/guidance_ddim": 7, "I2VGenXLUNet": 40,
                                     profiling.NO_SPAN: 3})
    assert out["by_op"] == approx({"aten::group_norm": 30, "aten::mul": 10,
                                   "aten::add": 7, profiling.NO_OP: 93})
    assert out["by_module"] == approx({"up_blocks.1": 90, profiling.OUTSIDE: 50})
    assert out["by_category"] == approx({"elementwise": 47, "K3 s8 GEMM": 50,
                                         "K1 flash attention": 40, "other": 3})
    assert out["by_span_category"]["I2VGenXLUNet/up_blocks.1/resnets.0"] == approx(
        {"elementwise": 30})
    assert out["by_op_category"][profiling.NO_OP] == approx(
        {"K3 s8 GEMM": 50, "K1 flash attention": 40, "other": 3})
    for key in ("by_category", "by_module", "by_span", "by_op"):
        assert sum(out[key].values()) == pytest.approx(out["total_s"], rel=1e-12)
    for key in ("by_module", "by_span", "by_op"):
        assert sum(sum(v.values()) for v in out[f"{key}_category"].values()) == pytest.approx(
            out["total_s"], rel=1e-12)


def test_step_timer_stages_are_spans(tmp_path):
    timer = profiling.StepTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("composite/entry"):
            torch.ones(3).sum()
    with timer.stage("composite/entry"):
        pass
    assert [e.name for e in prof.events()].count("stage/composite/entry") == 1
    assert set(timer.summary()) == {"composite/entry"}
    assert profiling.is_span("stage/composite/entry")
