"""Shared CLI plumbing: argparse, logging, pipeline construction (the port's
own copy of mvoc_tpu/cli/common.py).

The config surface is the reference CLIs' (reference: inverse.py:230-255,
composite.py:227-255): a template YAML plus a JSON list of per-job
overrides, `active` flags, `ReplaceMe` sentinels, so the reference's own
config files run unchanged.  The template's `device` key picks the torch
device when it names one (`cpu`, `cuda`, `cuda:N`); anything else (the
shipped templates say "tpu") means CUDA, and without CUDA the CLIs raise:
there is no fall-back to the CPU.

The device mesh (--mesh, the template's mesh_devices) runs one process per
rank under a launcher:

    torchrun --nproc_per_node N -m mvoc_tpu_torch.cli.inverse ... --mesh N

(NCCL on CUDA, one card per rank by LOCAL_RANK; gloo with `device: cpu`).
Every rank runs the whole CLI; rank 0 alone writes the trajectories, media
and metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re

import torch

from mvoc_tpu_torch import config as cfglib
from mvoc_tpu_torch.parallel import mesh as pm
from mvoc_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mvoc_tpu_torch")

DEFAULT_CHECKPOINT = "./checkpoints/i2vgen-xl"
_TORCH_DEVICE = re.compile(r"cpu|cuda(:\d+)?")


def parse_args(default_template: str, argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--template_config", type=str, default=default_template)
    p.add_argument("--configs_json", type=str, required=True)
    p.add_argument(
        "--checkpoint", type=str, default=None,
        help="HF i2vgen-xl checkpoint dir (default ./checkpoints/i2vgen-xl; "
        "'tiny' builds a random tiny pipeline for smoke runs)",
    )
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler (Chrome) trace here")
    p.add_argument(
        "--mesh", type=str, default=None,
        help="shard the pipeline over a device mesh: an int rank count or "
        "'auto' (the launcher's world size); overrides the template's mesh_devices; "
        "more than one rank runs under torchrun --nproc_per_node N",
    )
    p.add_argument(
        "--batch", action="store_true",
        help="run same-signature entries as one batched step loop (the template's "
        "batch_inversions / batch_composites do the same)",
    )
    p.add_argument(
        "--mesh_seq", type=int, default=None,
        help="frame-parallel ('seq') width of the mesh; the rest is tensor parallelism "
        "('model')",
    )
    p.add_argument(
        "--mesh_job", type=int, default=None,
        help="independent-video ('job') width of the mesh (pairs with --batch)",
    )
    return p.parse_args(argv)


def setup_logging(template_cfg) -> None:
    level = logging.DEBUG if template_cfg.get("debug", False) else logging.INFO
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - [%(funcName)s] - %(message)s",
    )


def load_configs(args):
    template = cfglib.load(args.template_config)
    entries = cfglib.load_json_list(args.configs_json)
    return template, entries


def template_device(template_cfg) -> torch.device:
    """The template's `device` when it names a torch device, else CUDA;
    raises when CUDA is meant and absent."""
    dev = str(template_cfg.get("device", ""))
    return resolve_device(dev if _TORCH_DEVICE.fullmatch(dev) else "cuda")


def build_pipeline(args, template_cfg):
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    ckpt = args.checkpoint or template_cfg.get("pretrained_model_path", DEFAULT_CHECKPOINT)
    device = template_device(template_cfg)
    if ckpt == "tiny":
        from mvoc_tpu_torch.utils.testing import build_tiny_pipeline

        logger.warning("building TINY random pipeline (smoke mode)")
        return build_tiny_pipeline(dtype=torch.float32, device=device)
    if not os.path.isdir(ckpt):
        raise FileNotFoundError(
            f"checkpoint dir not found: {ckpt} (pass --checkpoint, set "
            "pretrained_model_path in the template, or use --checkpoint tiny)"
        )
    from mvoc_tpu_torch.pipeline.i2vgen import I2VGenXLPipeline

    return I2VGenXLPipeline.from_pretrained(ckpt, dtype=dtype, device=device)


def init_launcher(template_cfg) -> None:
    """Under a launcher (torchrun), initialise the process group before the
    pipeline is built, so each rank builds it on its own card (LOCAL_RANK):
    NCCL on CUDA, gloo on the CPU."""
    if pm.launched():
        pm.init_distributed(template_device(template_cfg))


def apply_mesh(pipe, args, template_cfg):
    """Shard the pipeline over a (job, seq, model) mesh when --mesh or the
    template's mesh_devices asks for one (JAX's apply_mesh): 'auto' is the
    launcher's world size; a count above it warns and takes the world; a
    count below it puts ranks 0..n-1 on the mesh and the others leave
    (`mesh.member` False: the CLIs return without running or writing).
    --mesh_seq / --mesh_job (or mesh_seq / mesh_job) set the axes, and the
    template's `context_parallel: ring|ulysses` the temporal attention.
    Without a launcher a mesh raises, naming the torchrun command: the JAX
    package runs a mesh in one process, the port one process per rank.  As
    in the JAX CLI, --mesh_seq / --mesh_job without a mesh size leave the
    pipeline as it is."""
    spec = args.mesh if args.mesh is not None else template_cfg.get("mesh_devices")
    if spec in (None, "", 0, "0", "off", False):
        return pipe
    if not pm.launched() and str(spec) != "1":
        raise RuntimeError(
            f"--mesh {spec} runs one process per rank: launch the CLI with "
            f"`torchrun --nproc_per_node <ranks> -m mvoc_tpu_torch.cli.<inverse|composite> ... "
            f"--mesh {spec}`")
    world = int(os.environ.get("WORLD_SIZE", 1))
    n = world if str(spec) == "auto" else int(spec)
    if n > world:
        logger.warning("mesh_devices=%d > %d ranks in the world — using %d", n, world, world)
        n = world
    seq = args.mesh_seq if args.mesh_seq is not None else template_cfg.get("mesh_seq")
    job = args.mesh_job if args.mesh_job is not None else template_cfg.get("mesh_job")
    pipe = pipe.enable_mesh(n, seq=int(seq) if seq else None, job=int(job) if job else 1)
    cp = template_cfg.get("context_parallel")
    if cp:
        # ring / Ulysses temporal attention over the frames split on "seq"
        pipe.unet.set_parallel(pipe.unet.config.attn_mesh, str(cp))
        logger.info("temporal context parallelism: %s", cp)
    return pipe


def is_writer(pipe) -> bool:
    """Whether this process writes the CLI's files: rank 0 of the mesh (the
    only process without one)."""
    return pm.is_writer(getattr(pipe, "mesh", None))


def off_mesh(pipe) -> bool:
    """A rank outside a mesh smaller than the world: it runs nothing."""
    mesh = getattr(pipe, "mesh", None)
    if mesh is not None and not mesh.member:
        logger.info("rank outside the %d-rank mesh: leaving without running", mesh.size)
        return True
    return False


def save_config(pipe, config) -> None:
    """save_run_config on rank 0 only."""
    from mvoc_tpu_torch.utils.profiling import save_run_config

    if is_writer(pipe):
        save_run_config(config, config.output_dir)


def apply_quantize(pipe, template_cfg):
    """Template key `quantize: int8 | int8_mixed`: w8a8-quantize the UNet
    (an approximate mode; pipeline.enable_int8, whose GEMMs run on K3).
    `int8_mixed` quantizes the mixed selection (dense layers with K >= 1280
    and the deep temporal convs), `int8` everything that does not anchor
    the network.  Any other value raises; absent or falsy leaves the exact
    path untouched."""
    q = template_cfg.get("quantize", None)
    if q in (None, "", False, "off", "none"):
        return pipe
    if str(q) not in ("int8", "int8_mixed"):
        raise ValueError(
            f"quantize: {q!r} — supported modes are 'int8' and 'int8_mixed'")
    logger.warning(
        "quantize: %s is an APPROXIMATE mode (w8a8 UNet kernels) — quantify the drift for "
        "your content via recon_config.enable_recon before production use", q)
    return pipe.enable_int8(mode="mixed" if str(q) == "int8_mixed" else "full")


def check_replaceme(cfg) -> None:
    bad = cfglib.check_no_replaceme(cfg, logger)
    for k in bad:
        logger.error("field %s still contains 'ReplaceMe'", k)


def apply_unet_options(pipe, template_cfg):
    """Template-level UNet compute options that keep the weights:
    `temporal_window` (band-limited temporal attention) and
    `temporal_natural_layout` (frame-major temporal transformers, default
    on; `false` restores the reference's [B*H*W, F, C] layout).  The UNet is
    rebuilt with the new config and takes the old one's weights, device and
    dtype."""
    from mvoc_tpu_torch.models.unet_i2vgen import I2VGenXLUNet

    opts = {}
    if template_cfg.get("temporal_window", None) is not None:
        opts["temporal_window"] = int(template_cfg.get("temporal_window"))
    if template_cfg.get("temporal_natural_layout", True):
        opts["temporal_natural_layout"] = True
    if opts:
        old = pipe.unet
        with torch.device("meta"):
            new = I2VGenXLUNet(dataclasses.replace(old.config, **opts))
        new.load_state_dict(old.state_dict(), strict=True, assign=True)
        pipe.unet = new.eval()
        logger.info("UNet options applied: %s", opts)
    return pipe
