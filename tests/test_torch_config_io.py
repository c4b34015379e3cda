"""mvoc_tpu_torch's config, mask, media, metrics and trajectory modules against
the JAX package's, on the same files: every comparison is exact (the two
packages run the same host code, so the results must be equal bit for bit;
the trajectory stores read back bitwise across the packages in both
containers)."""

import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from mvoc_tpu import config as jcfg
from mvoc_tpu.cli import composite as jcomposite
from mvoc_tpu.io import masks as jmasks
from mvoc_tpu.io import media as jmedia
from mvoc_tpu.io import trajectory as jtraj
from mvoc_tpu.utils import metrics as jmetrics
from mvoc_tpu_torch import config as tcfg
from mvoc_tpu_torch.cli import composite as tcomposite
from mvoc_tpu_torch.io import masks as tmasks
from mvoc_tpu_torch.io import media as tmedia
from mvoc_tpu_torch.io import native as tnative
from mvoc_tpu_torch.io import trajectory as ttraj
from mvoc_tpu_torch.utils import metrics as tmetrics
from torch_support import ROOT
from torch_support import yield_cpu  # noqa: F401  (autouse: low CPU priority)

TEMPLATES = ("group_inversion", "group_composite")


def _equal(a, b):
    """Exact equality of nested results: arrays bitwise, PIL images by
    pixels and size, the rest by ==."""
    if isinstance(a, Image.Image):
        assert isinstance(b, Image.Image) and a.size == b.size and a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b, (a, b)


# -- config ---------------------------------------------------------------------


@pytest.mark.parametrize("name", TEMPLATES)
def test_templates_and_examples_load_merge_and_dump_alike(name):
    d = os.path.join(ROOT, "configs", name)
    template = os.path.join(d, "template.yaml")
    example = os.path.join(d, "group_config.example.json")
    jt, tt_ = jcfg.load(template), tcfg.load(template)
    assert tcfg.to_container(tt_, resolve=False) == jcfg.to_container(jt, resolve=False)
    assert tcfg.to_container(tt_) == jcfg.to_container(jt)
    assert tcfg.to_yaml(tt_) == jcfg.to_yaml(jt)
    assert tcfg.check_no_replaceme(tt_) == jcfg.check_no_replaceme(jt)
    entries = tcfg.load_json_list(example)
    assert entries == jcfg.load_json_list(example)
    for entry in entries:
        jm, tm = jcfg.merge(jt, entry), tcfg.merge(tt_, entry)
        assert tcfg.to_container(tm) == jcfg.to_container(jm)
        assert tcfg.to_yaml(tm) == jcfg.to_yaml(jm)
        assert tcfg.check_no_replaceme(tm) == jcfg.check_no_replaceme(jm)
        # a value merged later retroactively moves every templated path
        jm2, tm2 = jcfg.merge(jm, {"data_dir": "/x"}), tcfg.merge(tm, {"data_dir": "/x"})
        assert tm2.output_dir == jm2.output_dir and tm2.output_dir.startswith("/x/")
        copy = tcfg.create(tm2)
        assert tcfg.to_container(copy) == tcfg.to_container(tm2)


def test_create_from_yaml_text_and_errors_alike():
    text = "a: 1\nb:\n  c: ${a}\n  d: [1, '${b.c}']\ne: ${missing.key}\nf: x${a}y\n"
    jc, tc = jcfg.create(text), tcfg.create(text)
    assert tc.b.c == jc.b.c == 1 and tc.b.d == jc.b.d == [1, 1] and tc.f == jc.f == "x1y"
    with pytest.raises(tcfg.InterpolationError) as te:
        tc.e
    with pytest.raises(jcfg.InterpolationError) as je:
        jc.e
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError):
        tcfg.load_json_list(os.path.join(ROOT, "configs", "group_inversion", "template.yaml"))


def test_replaceme_detection_alike():
    cfg = {"video_name": "ReplaceMe", "nested": {"x": ["a", "ReplaceMe"]}, "ok": 1,
           "p": "${video_name}/y"}
    assert tcfg.check_no_replaceme(tcfg.create(cfg)) == jcfg.check_no_replaceme(
        jcfg.create(cfg)) == ["video_name", "nested", "p"]


# -- masks ----------------------------------------------------------------------


def _random_mask(path, w, h, rng):
    """Random 8 x 8 blocks of gray 8..14, so that the x8 downscale straddles
    the > 10 threshold."""
    blocks = rng.integers(8, 15, (h // 8, w // 8), dtype=np.uint8)
    Image.fromarray(np.kron(blocks, np.ones((8, 8), np.uint8)), mode="L").save(path)


@pytest.fixture(scope="module")
def mask_files(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("masks")
    _random_mask(root / "static.png", 48, 32, rng)
    dyn = root / "dyn"
    dyn.mkdir()
    for stem in ("10", "2", "1", "3"):  # numeric order 1, 2, 3, 10
        _random_mask(dyn / f"{stem}.png", 48, 32, rng)
    return root


@pytest.mark.parametrize("case", ["static", "dyn_cut", "dyn_padded", "target_wh"])
def test_mask_preprocess_bitwise(mask_files, case):
    path = str(mask_files / ("static.png" if case == "static" else "dyn"))
    kw = dict(n_frames={"static": 3, "dyn_cut": 3, "dyn_padded": 6, "target_wh": 2}[case])
    if case == "target_wh":
        kw["target_wh"] = (5, 7)
    got = tmasks.mask_preprocess(path, **kw)
    _equal(list(got), list(jmasks.mask_preprocess(path, **kw)))
    soft, binary = got
    assert soft.shape[0] == kw["n_frames"]
    if case == "dyn_cut":  # numeric-stem order, cut to n_frames: 1, 2, 3
        for i, stem in enumerate(("1", "2", "3")):
            _equal(soft[i], tmasks._load_one(str(mask_files / "dyn" / f"{stem}.png"), 8)[0])
    if case == "dyn_padded":  # 4 files, the last (10) repeated
        _equal(soft[3:], np.repeat(soft[3:4], 3, axis=0))
    # soft = gray / 255 of the bicubic x8 downscale, binary = gray > 10
    gray = np.round(soft * 255.0)
    _equal(binary, (gray > 10).astype(np.float32))
    assert (gray == 10).any() and (gray == 11).any()


def test_mask_threshold_and_arrays_bitwise():
    rng = np.random.default_rng(1)
    # a ramp of gray 0..25 across the width, crossing the > 10 threshold
    ramp = np.broadcast_to(np.linspace(0.0, 0.1, 48), (2, 32, 48))
    arr = (ramp + rng.uniform(-0.01, 0.01, (2, 32, 48))).clip(0, 1).astype(np.float32)
    got = tmasks.masks_from_arrays(arr, 4)
    _equal(list(got), list(jmasks.masks_from_arrays(arr, 4)))
    assert 0 < got[1].mean() < 1
    one = tmasks.masks_from_arrays(arr[0], 3)
    _equal(list(one), list(jmasks.masks_from_arrays(arr[0], 3)))
    b = (rng.uniform(size=(3, 2, 4, 6)) > 0.5).astype(np.float32)
    s = rng.uniform(size=(3, 2, 4, 6)).astype(np.float32)
    _equal(list(tmasks.exclusive_occlusion_masks(b, s)),
           list(jmasks.exclusive_occlusion_masks(b, s)))


@pytest.mark.parametrize("resize", [False, True])
def test_entry_masks_mismatch_raises_or_resizes(mask_files, resize):
    """Masks authored at 48 x 32 for a 64 x 48 working size: the reference's
    x8 downscale gives 6 x 4, not the 8 x 6 latent, so both CLIs raise unless
    mask_resize_to_latent."""
    entry = {"obj_mask_path": [str(mask_files / "static.png"), str(mask_files / "dyn")],
             "mask_resize_to_latent": resize}
    args = ((64, 48), 3)
    if not resize:
        with pytest.raises(ValueError, match="latent resolution") as te:
            tcomposite.load_entry_masks(tcfg.create(entry), *args)
        with pytest.raises(ValueError) as je:
            jcomposite.load_entry_masks(jcfg.create(entry), *args)
        assert str(te.value) == str(je.value)
        return
    got = tcomposite.load_entry_masks(tcfg.create(entry), *args)
    assert got[0].shape == (2, 3, 6, 8)
    _equal(list(got), list(jcomposite.load_entry_masks(jcfg.create(entry), *args)))


# -- media ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    rng = np.random.default_rng(2)
    d = tmp_path_factory.mktemp("frames")
    for stem in ("frame_10", "frame_2", "frame_1", "frame_0"):
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(d / f"{stem}.png")
    (d / "notes.txt").write_text("not a frame")
    return d


@pytest.mark.parametrize("size", [(40, 24), (32, 16)])
def test_scan_dir_and_load_video_frames_alike(frame_dir, size):
    n, paths = tmedia.scan_dir(str(frame_dir))
    assert (n, sorted(paths)) == (4, sorted(jmedia.scan_dir(str(frame_dir))[1]))
    got = tmedia.load_video_frames(str(frame_dir), 3, size)
    want = jmedia.load_video_frames(str(frame_dir), 3, size)
    assert got[0] == want[0] == [str(frame_dir / f"frame_{i}.png") for i in range(3)]
    _equal(got[1], want[1])
    assert got[1][0].size == size
    with pytest.raises(FileNotFoundError):
        tmedia.load_video_frames(str(frame_dir / ".."), 3, size)


@pytest.mark.parametrize("ext", [".mp4", ".mov"])
def test_convert_video_to_frames_alike(tmp_path, ext):
    """A small video written here with OpenCV; .mov frames come out rotated
    by -90 degrees (the torchvision quirk the reference carries)."""
    import cv2

    rng = np.random.default_rng(3)
    path = str(tmp_path / f"clip{ext}")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (32, 16))
    for _ in range(4):
        writer.write(rng.integers(0, 256, (16, 32, 3), dtype=np.uint8))
    writer.release()
    got = tmedia.convert_video_to_frames(path, (32, 16))
    saved = sorted(os.listdir(tmp_path / "clip"))
    want = jmedia.convert_video_to_frames(path, (32, 16), save_frames=False)
    assert len(got) == 4 and saved == [f"{i:05d}.png" for i in range(4)]
    _equal(got, want)
    native = tmedia.convert_video_to_frames(path, (16, 32) if ext == ".mov" else (32, 16),
                                            save_frames=False)
    for a, b in zip(native, got):  # no resize on the rotated size
        assert a.size == ((16, 32) if ext == ".mov" else (32, 16))
    with pytest.raises(FileNotFoundError):
        tmedia.convert_video_to_frames(str(tmp_path / "missing.mp4"))


def test_exports_alike(tmp_path):
    import cv2

    frames = tmedia.video_to_pil(np.random.default_rng(4).uniform(size=(3, 16, 24, 3)))
    _equal(frames, jmedia.video_to_pil(np.asarray([np.asarray(f) / 255.0 for f in frames])))
    for mod, tag in ((tmedia, "t"), (jmedia, "j")):
        mod.export_to_gif(frames, str(tmp_path / tag / "v.gif"))
        mod.export_to_video(frames, str(tmp_path / tag / "v.mp4"))
    assert (tmp_path / "t" / "v.gif").read_bytes() == (tmp_path / "j" / "v.gif").read_bytes()
    decoded = []
    for tag in ("t", "j"):
        cap, out = cv2.VideoCapture(str(tmp_path / tag / "v.mp4")), []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            out.append(fr)
        decoded.append(np.stack(out))
    assert decoded[0].shape == (3, 16, 24, 3)
    _equal(decoded[0], decoded[1])


# -- metrics ----------------------------------------------------------------------


def test_psnr_ssim_equal_to_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(3, 8, 12, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a[0], b[0])):
        assert tmetrics.psnr(x, y) == jmetrics.psnr(x, y)
        assert tmetrics.ssim(x, y) == jmetrics.ssim(x, y)
        assert tmetrics.psnr(x, y, data_range=2.0) == jmetrics.psnr(x, y, data_range=2.0)
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")


# -- trajectories ---------------------------------------------------------------


def _traj(rng, steps=4):
    ts = np.array([1, 251, 501, 751][:steps], np.int32)
    lat = rng.standard_normal((steps, 2, 3, 5, 4)).astype(np.float32) * 3
    lat[0, 0, 0, 0] = [70000.0, 1e-8, -0.0, 6e-5]  # overflow, underflow, signed zero, subnormal
    return ts, lat


def test_native_codec_builds_here():
    assert tnative.get_lib() is not None, "g++ could not build csrc/traj_codec.cpp"


@pytest.fixture(scope="module")
def jax_codec():
    """The JAX package builds native/libmvoc_native.so at its first use and
    gives up for the process if that fails; another test process may be
    building it at the same moment, so load it here, retrying."""
    from mvoc_tpu.io import native as jnative

    for _ in range(60):
        if jnative.get_lib() is not None:
            return jnative
        jnative._tried = False
        time.sleep(1)
    pytest.fail("the JAX package's native trajectory codec could not be built or loaded")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trajectory_stores_read_back_bitwise_across_packages(tmp_path, jax_codec, native,
                                                             writer):
    rng = np.random.default_rng(6)
    ts, lat = _traj(rng)
    meta = dict(n_steps=4, num_frames=2, height=6, width=10, prompt="", seed=8888)
    store = (jtraj if writer == "jax" else ttraj).TrajectoryStore(str(tmp_path), prefer_native=native)
    written = store.save(ts, lat, meta=meta)
    assert os.path.basename(written) == (ttraj.NATIVE_NAME if native else ttraj.STACK_NAME)
    assert (ttraj.NATIVE_NAME, ttraj.STACK_NAME, ttraj.META_NAME) == (
        jtraj.NATIVE_NAME, jtraj.STACK_NAME, jtraj.META_NAME)
    t, j = ttraj.TrajectoryStore(str(tmp_path)), jtraj.TrajectoryStore(str(tmp_path))
    _equal(t.timesteps.astype(np.int32), j.timesteps.astype(np.int32))
    with np.errstate(over="ignore"):  # 70000 overflows fp16 to inf in both packages
        want = lat.astype(np.float16).astype(np.float32)  # fp16 storage, fp32 reads
    _equal(t.gather(ts[::-1]), j.gather(ts[::-1]))
    _equal(t.gather(ts), want)
    _equal(t.load_at_t(501), j.load_at_t(501))
    tT, jT = t.load_at_T(), j.load_at_T()
    assert tT[0] == jT[0] == 751
    _equal(tT[1], jT[1])
    assert t.meta == j.meta == meta
    with pytest.raises(KeyError, match="not in trajectory"):
        t.load_at_t(2)
    # the same file whichever package writes it
    other = tmp_path / "other"
    (ttraj if writer == "jax" else jtraj).TrajectoryStore(str(other), prefer_native=native).save(
        ts, lat)
    name = ttraj.NATIVE_NAME if native else ttraj.STACK_NAME
    if native:
        assert (tmp_path / name).read_bytes() == (other / name).read_bytes()
    else:
        with np.load(tmp_path / name) as a, np.load(other / name) as b:
            _equal(a["latents"], b["latents"])
            _equal(a["timesteps"], b["timesteps"])


def test_reference_pt_files_read_alike(tmp_path):
    rng = np.random.default_rng(7)
    for t in (1, 21, 41):  # the reference's [1, C, F, h, w] per-step files
        x = torch.from_numpy(rng.standard_normal((1, 4, 2, 3, 5)).astype(np.float32)).half()
        torch.save(x, tmp_path / f"ddim_latents_{t}.pt")
    t, j = ttraj.TrajectoryStore(str(tmp_path)), jtraj.TrajectoryStore(str(tmp_path))
    _equal(t.timesteps, j.timesteps)
    assert list(t.timesteps) == [1, 21, 41]
    _equal(t.gather([41, 1]), j.gather([41, 1]))
    assert t.load_at_t(21).shape == (2, 3, 5, 4)
    _equal(t.load_at_T()[1], j.load_at_T()[1])
    with pytest.raises(FileNotFoundError):
        t.load_at_t(7)
    with pytest.raises(FileNotFoundError):
        ttraj.TrajectoryStore(str(tmp_path / "empty")).timesteps


def test_matches_meta_alike(tmp_path):
    meta = dict(n_steps=500, num_frames=16, height=720, width=1280, prompt="", seed=8888)
    with open(tmp_path / ttraj.META_NAME, "w") as f:
        json.dump(meta, f)
    bare = tmp_path / "bare"
    bare.mkdir()
    cases = [(tmp_path, meta, False), (tmp_path, dict(meta, seed=6), False),
             (tmp_path, dict(meta, extra=1), False), (tmp_path, {"n_steps": "500"}, False),
             (bare, meta, False), (bare, meta, True)]
    for path, expected, missing_ok in cases:
        got = ttraj.TrajectoryStore(str(path)).matches_meta(expected, missing_ok=missing_ok)
        assert got == jtraj.TrajectoryStore(str(path)).matches_meta(expected,
                                                                     missing_ok=missing_ok)
    assert ttraj.TrajectoryStore(str(tmp_path)).matches_meta(meta)
    assert not ttraj.TrajectoryStore(str(tmp_path)).matches_meta(dict(meta, seed=6))
