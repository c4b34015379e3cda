"""The port's checkpoint loader (mvoc_tpu_torch.models.convert.load_pipeline)
against the JAX package's (mvoc_tpu.models.convert.load_pipeline), on a tiny
diffusers-layout directory written from the goldens' seeded leaves
(torch_support.write_tiny_checkpoint: safetensors files from the
`safetensors` package and from the port's writer, a torch .bin, the
configs, a synthetic BPE tokenizer):

* every tensor the port loads equals the JAX loader's tensor carried across
  by the weight bridge, bit for bit, and both took the fp16 variant file;
* every config field the port derives (the UNet's head dims from the
  checkpoint's shapes included) equals the JAX loader's;
* the port's safetensors reader and writer against the `safetensors`
  package, bit for bit, and its refusals;
* the port's CLIP tokenizer against `transformers.CLIPTokenizer` (without
  ftfy, as on both machines) on the templates' prompts and harder text;
* verify_activations raises on a NaN-poisoned weight, the strict check
  names a missing key and a wrong shape, and both `main`s print the same
  conversion line.

The JAX loader builds its modules from `jax.eval_shape` (no compile)."""

import copy
import dataclasses
import io
import json
import os
import shutil
import struct
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvoc_tpu.models import clip as jclip
from mvoc_tpu.models import convert as jconvert
from mvoc_tpu.models import unet_i2vgen as junet
from mvoc_tpu.models import vae as jvae
from mvoc_tpu.ops import ddim as jddim
from mvoc_tpu_torch.io import safetensors as port_st
from mvoc_tpu_torch.models import clip as tclip
from mvoc_tpu_torch.models import convert as tconvert
from mvoc_tpu_torch.models import unet_i2vgen as tunet
from mvoc_tpu_torch.models import vae as tvae
from mvoc_tpu_torch.models.tokenizer import CLIPTokenizer
from mvoc_tpu_torch.ops import ddim as tddim
from mvoc_tpu_torch.utils import testing as tt
from torch_support import load_goldens, nest, write_tiny_checkpoint
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

BRIDGE = {"unet": tconvert.unet_state_dict_from_flax, "vae": tconvert.vae_state_dict_from_flax,
          "text_encoder": tconvert.clip_text_state_dict_from_flax,
          "image_encoder": tconvert.clip_vision_state_dict_from_flax}


@pytest.fixture(scope="module")
def goldens():
    return load_goldens()


@pytest.fixture(scope="module")
def ckpt(goldens, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt") / "i2vgen-xl")
    write_tiny_checkpoint(root, goldens)
    return root


@pytest.fixture(scope="module")
def jax_pipe(ckpt):
    return jconvert.load_pipeline(ckpt, dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_pipe(ckpt):
    return tconvert.load_pipeline(ckpt, dtype=torch.float32, device="cpu")


def test_loaded_tensors_equal_the_jax_loaders(jax_pipe, port_pipe, goldens):
    """Every model's tensors, key for key and bit for bit."""
    for model, bridge in BRIDGE.items():
        want = bridge(jax_pipe.params[model])
        got = getattr(port_pipe, model).state_dict()
        assert sorted(got) == sorted(want), model
        for k in want:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), (model, k)
    # both took diffusion_pytorch_model.fp16.safetensors
    got = port_pipe.unet.state_dict()
    ref = tconvert.unet_state_dict_from_flax(nest(goldens, "params"))
    assert all(torch.equal(got[k], ref[k].half().float()) for k in ref)
    assert any(not torch.equal(got[k], ref[k]) for k in ref)


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


def test_configs_equal_the_jax_loaders(jax_pipe, port_pipe):
    """Every field of every config the port derives, the UNet's head dims
    from the checkpoint's shapes included."""
    pairs = {
        "unet": (jax_pipe.unet.config, port_pipe.unet.config),
        "vae": (jax_pipe.vae.config, port_pipe.vae.config),
        "text_encoder": (jax_pipe.text_encoder.config, port_pipe.text_encoder.config),
        "image_encoder": (jax_pipe.image_encoder.config, port_pipe.image_encoder.config),
        "scheduler": (jax_pipe.scheduler_config, port_pipe.scheduler_config),
    }
    for kind, (jcfg, tcfg) in pairs.items():
        names = [f.name for f in dataclasses.fields(tcfg)]
        assert set(names) <= {f.name for f in dataclasses.fields(jcfg)}, kind
        assert _fields(tcfg, names) == _fields(jcfg, names), kind
    unet, sched = port_pipe.unet.config, port_pipe.scheduler_config
    # from the shapes: 8 heads (the diffusers constant) x 1
    assert (unet.transformer_in_heads, unet.transformer_in_head_dim) == (8, 1)
    assert (unet.img_temporal_encoder_heads, unet.img_temporal_encoder_head_dim) == (2, 4)
    assert (sched.timestep_spacing, sched.steps_offset) == ("trailing", 0)  # read from the file


def test_config_readers_match_jax(ckpt):
    for jf, tf in ((junet.UNetConfig.from_pretrained, tunet.UNetConfig.from_pretrained),
                   (jvae.VAEConfig.from_pretrained, tvae.VAEConfig.from_pretrained),
                   (jddim.SchedulerConfig.from_pretrained, tddim.SchedulerConfig.from_pretrained)):
        assert dataclasses.asdict(tf(ckpt)).items() <= dataclasses.asdict(jf(ckpt)).items()
    for jf, tf, sub in ((jclip.CLIPTextConfig.from_json, tclip.CLIPTextConfig.from_json,
                         "text_encoder"),
                        (jclip.CLIPVisionConfig.from_json, tclip.CLIPVisionConfig.from_json,
                         "image_encoder")):
        path = os.path.join(ckpt, sub, "config.json")
        assert dataclasses.asdict(tf(path)) == dataclasses.asdict(jf(path))


def test_infer_unet_geometry_errors_match_jax(ckpt):
    sd = tconvert.load_torch_state_dict(os.path.join(ckpt, "unet"))
    jsd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in sd.items()}
    jcfg, tcfg = junet.UNetConfig.from_pretrained(ckpt), tunet.UNetConfig.from_pretrained(ckpt)
    for mutate in (lambda d: d.pop("image_latents_temporal_encoder.attn1.to_q.weight"),
                   lambda d: d.__setitem__("transformer_in.transformer_blocks.0.attn1.to_q.weight",
                                           d["transformer_in.transformer_blocks.0.attn1.to_q."
                                             "weight"][:7])):
        js, ts = dict(jsd), dict(sd)
        mutate(js)
        mutate(ts)
        with pytest.raises((KeyError, ValueError)) as je:
            jconvert.infer_unet_geometry(js, jcfg)
        with pytest.raises((KeyError, ValueError)) as te:
            tconvert.infer_unet_geometry(ts, tcfg)
        assert type(te.value) is type(je.value) and str(te.value) == str(je.value)


def test_load_torch_state_dict_picks_the_jax_loaders_file(ckpt):
    for sub in ("unet", "vae", "text_encoder", "image_encoder"):
        got = tconvert.load_torch_state_dict(os.path.join(ckpt, sub))
        want = jconvert.load_torch_state_dict(os.path.join(ckpt, sub))
        want = {k: v for k, v in want.items() if not k.endswith("position_ids")}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k].float().numpy(), v), (sub, k)
    with pytest.raises(FileNotFoundError, match="no weight files"):
        tconvert.load_torch_state_dict(os.path.join(ckpt, "scheduler"))


# -- safetensors -------------------------------------------------------------------


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
            "bf16": torch.randn(2, 9, generator=g).bfloat16(),
            "i64": torch.randint(-2**40, 2**40, (4,), generator=g),
            "i32": torch.randint(-9, 9, (2, 2), generator=g, dtype=torch.int32),
            "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 3)}


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors.torch import load_file as st_load
    from safetensors.torch import save_file as st_save

    ts = _tensors()
    st_save(ts, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    got = port_st.load_file(str(tmp_path / "pkg.safetensors"))
    n = port_st.save_file(ts, str(tmp_path / "port.safetensors"), metadata={"format": "pt"})
    assert n == os.path.getsize(tmp_path / "port.safetensors")
    back = st_load(str(tmp_path / "port.safetensors"))
    for k, v in ts.items():
        for other in (got[k], back[k]):
            assert other.dtype == v.dtype and other.shape == v.shape
            assert torch.equal(other.view(-1).view(torch.uint8) if v.numel() else other,
                               v.view(-1).view(torch.uint8) if v.numel() else v), k


def _raw(header: dict, data: bytes) -> bytes:
    h = json.dumps(header).encode()
    return struct.pack("<Q", len(h)) + h + data


BROKEN = [
    (struct.pack("<Q", 10_000) + b"{}", "overruns the file"),
    (_raw({"x": {"dtype": "F8_E9", "shape": [1], "data_offsets": [0, 1]}}, b"\0"),
     "unknown dtype"),
    (_raw({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8),
     "overrun"),
    (_raw({"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8),
     "bytes for shape"),
    (b"\x01\x02", "too short"),
]


def test_safetensors_reader_refuses_broken_files(tmp_path):
    for i, (blob, match) in enumerate(BROKEN):
        path = tmp_path / f"bad{i}.safetensors"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=match):
            port_st.load_file(str(path))


# -- tokenizer ---------------------------------------------------------------------

TEXTS = [
    "", "a red boat and a surfer on the sea",
    "Hello, World!!! It's a boat's sail; they'll've gone... (really?) #42 $3.50",
    "Café crème brûlée, naïve résumé, Ærøskøbing, ĳsselmeer",
    "Привет, мир — 東京タワーの夜景 안녕하세요 مرحبا بالعالم ελληνικά",
    "  tabs\tand\nnewlines\r\n  and nbsp emsp\u0007bell​zw ",
    "WINDSURF,Sailboat,SKY,ocean 1234567890 ½ ² ٣",
    "a <|endoftext|> b <|startoftext|>c!d",
    "emoji 🏄‍♂️⛵🌊 and symbols ©®™ € ← → ✓",
    " ".join(["windsurf sailboat sky ocean, chaotic colors"] * 12),
]


@pytest.mark.parametrize("pad,max_len", [("!", 77), ("<|endoftext|>", 77), ("!", 12)])
def test_tokenizer_matches_transformers(tmp_path, pad, max_len):
    transformers = pytest.importorskip("transformers")
    d = str(tmp_path / "tok")
    tt.write_tokenizer(d, tt.template_prompts() + TEXTS[1:4], n_merges=300, pad_token=pad,
                       model_max_length=max_len)
    hf = transformers.CLIPTokenizer.from_pretrained(d)
    port = CLIPTokenizer.from_pretrained(d)
    assert port.model_max_length == hf.model_max_length == max_len
    texts = tt.template_prompts() + TEXTS
    kw = dict(padding="max_length", max_length=max_len, truncation=True, return_tensors="np")
    want = hf(texts, **kw)["input_ids"]
    got = port(texts, **kw)["input_ids"]
    for t, g, w in zip(texts, got, want):
        assert g.tolist() == w.tolist(), t
    assert got.dtype == want.dtype and got.shape == (len(texts), max_len)
    assert len(port.tokenize(texts[-1])) > 77  # the long prompt was truncated


def test_tokenizer_is_optional(ckpt, tmp_path, port_pipe):
    assert isinstance(port_pipe.tokenizer, CLIPTokenizer)
    bare = str(tmp_path / "bare")
    shutil.copytree(ckpt, bare, ignore=shutil.ignore_patterns("tokenizer"))
    pipe = tconvert.load_pipeline(bare, dtype=torch.float32, device="cpu")
    assert pipe.tokenizer is None
    with pytest.raises(ValueError, match="no tokenizer"):
        pipe.tokenize(["a boat"])


# -- checks --------------------------------------------------------------------------


def test_verify_activations_raises_on_a_nan_weight(port_pipe):
    stats = tconvert.verify_activations(port_pipe)
    assert any(k.startswith("unet/") for k in stats) and all(
        np.isfinite(m) and np.isfinite(s) for m, s in stats.values())
    for model, key in (("unet", "up_blocks.1.resnets.0.conv1.weight"),
                       ("image_encoder", "vision_model.pre_layrnorm.weight")):
        pipe = copy.copy(port_pipe)
        poisoned = copy.deepcopy(getattr(port_pipe, model))
        with torch.no_grad():
            poisoned.get_parameter(key).view(-1)[0] = float("nan")
        setattr(pipe, model, poisoned)
        with pytest.raises(ValueError, match=f"non-finite activation at {model}/"):
            tconvert.verify_activations(pipe)


def test_strict_check_names_missing_and_misshaped_keys(port_pipe):
    sd = dict(port_pipe.vae.state_dict())
    sd.pop("decoder.conv_out.bias")
    sd["encoder.conv_in.weight"] = sd["encoder.conv_in.weight"][:, :2]
    sd["encoder.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError) as e:
        tconvert.verify_state_dict(sd, port_pipe.vae, "vae")
    msg = str(e.value)
    assert msg.startswith("checkpoint conversion mismatch (vae):")
    assert "missing (1): ['decoder.conv_out.bias']" in msg
    assert "extra (1): ['encoder.extra.weight']" in msg
    assert "encoder.conv_in.weight: got (8, 2, 3, 3) want (8, 3, 3, 3)" in msg


def test_main_prints_the_jax_conversion_line(ckpt, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["convert", ckpt])
    jconvert.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("conversion OK")]
    out = io.StringIO()
    with redirect_stdout(out):
        tconvert.main([ckpt, "--verify", "--device", "cpu", "--dtype", "float32"])
    lines = out.getvalue().splitlines()
    assert [ln for ln in lines if ln.startswith("conversion OK")] == want
    assert lines[-1].startswith("activation verify OK:") and lines[-1].endswith("modules finite")
