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
    "mvoc_tpu/ops/quantize.py", "mvoc_tpu/ops/ring_attention.py", "mvoc_tpu/ops/s8gemm.py",
    "mvoc_tpu/parallel/mesh.py", "mvoc_tpu/pipeline/core.py", "mvoc_tpu/pipeline/i2vgen.py",
    "mvoc_tpu/pnp.py", "mvoc_tpu/utils/flops.py", "mvoc_tpu/utils/quality.py",
    "mvoc_tpu/utils/testing.py",
    "scripts/torch_parity_goldens.py",
)
REGENERATE = "JAX_PLATFORMS=cpu python scripts/torch_parity_goldens.py"
# tier-1 runs six xdist workers on one host, which start on the JAX
# package's compile-bound files (tests/tier1_pacing.py: QUEUE_HEAD); the
# port's test modules, queued behind them, run this many niceness steps
# below the last of those
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


# int8 runs replaying the JAX tape: max error <= INT8_REL * max|JAX int8
# output|, which must stay under INT8_SHARE of the JAX int8-vs-fp32
# distance; the port's own quantization of each taped activation at most
# one int8 step from JAX's on at most FLIP_SHARE of the elements, its scales
# within SCALE_REL
INT8_REL = 1e-5
INT8_SHARE = 0.1
FLIP_SHARE = 1e-5
SCALE_REL = 1e-5


def check_int8_replay(tape) -> None:
    """Every taped quantization consumed, the port's own ones close to JAX's."""
    print(f"tape: {tape.calls} calls, {tape.flips} of {tape.elements} elements one step "
          f"apart, max scale rel diff {tape.max_scale_rel:.3g}")
    assert tape.calls == len(tape.records) > 0
    assert tape.max_step <= 1 and tape.flips <= FLIP_SHARE * tape.elements
    assert tape.max_scale_rel <= SCALE_REL


def check_int8(got, want, fp32, rel: float = INT8_REL) -> None:
    """The port's int8 output against JAX's, with a tolerance that must stay
    under INT8_SHARE of how far int8 moves JAX's own output from fp32."""
    got, want, fp32 = (np.asarray(a) for a in (got, want, fp32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    drift = np.abs(want - fp32).max()
    print(f"int8: max |err| {err:.3g} of max |jax| {scale:.3g}; jax int8 vs fp32 {drift:.3g}")
    assert err <= rel * scale, (err, scale)
    assert rel * scale <= INT8_SHARE * drift, (rel * scale, drift)


def load_tape(goldens: dict, case: str) -> list:
    """The JAX run's activation quantizations, [(int8 q, fp32 scale)] in call
    order (scripts/torch_parity_goldens.py: Tape.store)."""
    out = []
    pos = {"q": 0, "s": 0}
    for q_shape, s_shape in zip(goldens[f"int8/tape/{case}/q_shapes"],
                                goldens[f"int8/tape/{case}/s_shapes"]):
        pair = []
        for key, shape in (("q", q_shape), ("s", s_shape)):
            shape = tuple(int(d) for d in shape if d >= 0)
            n = int(np.prod(shape))
            flat = goldens[f"int8/tape/{case}/{key}"]
            pair.append(flat[pos[key]:pos[key] + n].reshape(shape))
            pos[key] += n
        out.append(tuple(pair))
    return out


def batch_slice(records: list, batch: int, lo: int, hi: int) -> list:
    """The records of a run at batch `batch` cut to its batch entries
    [lo, hi): every quantized activation of the UNet is batch-major (its
    leading axis is batch x something), and so are its scales."""
    out = []
    for pair in records:
        cut = []
        for a in pair:
            assert a.shape[0] % batch == 0, a.shape
            per = a.shape[0] // batch
            cut.append(a[lo * per:hi * per])
        out.append(tuple(cut))
    return out


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


# the tiny checkpoint's text tower: the goldens' tiny CLIP text params with a
# token embedding wide enough for a CLIP-layout vocabulary (512 byte symbols,
# the merges, two specials)
TINY_TOKENIZER_MERGES = 60
TINY_TEXT_VOCAB = 512 + TINY_TOKENIZER_MERGES + 2


def write_tiny_checkpoint(root: str, goldens: dict) -> None:
    """A tiny diffusers-layout I2VGen-XL directory from the goldens' seeded
    flax leaves, carried across by the port's weight bridge: unet/ as fp32
    and fp16 safetensors written by the `safetensors` package (the fp16
    variant is the one both loaders must pick), vae/ by the port's own
    writer, text_encoder/ as a torch .bin (with HF's position_ids buffer,
    which both loaders drop), image_encoder/ by the `safetensors` package;
    diffusers / HF config.json files, the scheduler config and a small
    synthetic BPE tokenizer (pad token "!", as SD-2.x's special tokens map
    has it)."""
    import dataclasses

    from safetensors.torch import save_file as st_save

    from mvoc_tpu_torch.io import safetensors as port_st
    from mvoc_tpu_torch.models import convert
    from mvoc_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from mvoc_tpu_torch.models.unet_i2vgen import UNetConfig
    from mvoc_tpu_torch.models.vae import VAEConfig
    from mvoc_tpu_torch.ops.ddim import SchedulerConfig
    from mvoc_tpu_torch.utils import testing as tt

    text_params = nest(goldens, "pipe/text_encoder")
    emb = text_params["token_embedding"]["embedding"]
    rng = np.random.default_rng(77)
    text_params["token_embedding"]["embedding"] = (
        0.1 * rng.standard_normal((TINY_TEXT_VOCAB, emb.shape[1]))).astype(np.float32)
    text_cfg = dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=TINY_TEXT_VOCAB)
    sched = SchedulerConfig(timestep_spacing="trailing", steps_offset=0)
    configs = tt.diffusers_configs(UNetConfig.tiny(), VAEConfig.tiny(), text_cfg,
                                   CLIPVisionConfig.tiny(), sched)
    tt.write_checkpoint_configs(root, configs, tt.template_prompts(), TINY_TOKENIZER_MERGES)
    unet = convert.unet_state_dict_from_flax(nest(goldens, "params"))
    st_save(unet, os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"))
    st_save({k: v.half() for k, v in unet.items()},
            os.path.join(root, "unet", "diffusion_pytorch_model.fp16.safetensors"))
    port_st.save_file(convert.vae_state_dict_from_flax(nest(goldens, "pipe/vae")),
                      os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"))
    text = convert.clip_text_state_dict_from_flax(text_params)
    text["text_model.embeddings.position_ids"] = torch.arange(
        text_cfg.max_position_embeddings)[None]
    torch.save(text, os.path.join(root, "text_encoder", "pytorch_model.bin"))
    st_save(convert.clip_vision_state_dict_from_flax(nest(goldens, "pipe/image_encoder")),
            os.path.join(root, "image_encoder", "model.safetensors"))
