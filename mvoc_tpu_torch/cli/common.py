"""Shared CLI plumbing: argparse, logging, pipeline construction (the port's
own copy of mvoc_tpu/cli/common.py).

The config surface is the reference CLIs' (reference: inverse.py:230-255,
composite.py:227-255): a template YAML plus a JSON list of per-job
overrides, `active` flags, `ReplaceMe` sentinels, so the reference's own
config files run unchanged.  The template's `device` key picks the torch
device when it names one (`cpu`, `cuda`, `cuda:N`); anything else (the
shipped templates say "tpu") means CUDA, and without CUDA the CLIs raise:
there is no fall-back to the CPU.  The device mesh, not ported yet, raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re

import torch

from mvoc_tpu_torch import config as cfglib
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
        help="shard the pipeline over a device mesh: an int device count or "
        "'auto' (all visible devices); overrides the template's mesh_devices "
        "(not ported yet: ROADMAP.md item 10)",
    )
    p.add_argument(
        "--batch", action="store_true",
        help="run same-signature entries as one batched step loop (the template's "
        "batch_inversions / batch_composites do the same)",
    )
    p.add_argument(
        "--mesh_seq", type=int, default=None,
        help="frame-parallel ('seq') width of the mesh (not ported yet: ROADMAP.md item 10)",
    )
    p.add_argument(
        "--mesh_job", type=int, default=None,
        help="independent-video ('job') width of the mesh (not ported yet: "
        "ROADMAP.md item 10)",
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


def apply_mesh(pipe, args, template_cfg):
    """Sharding over a device mesh (--mesh, the template's mesh_devices): not
    ported yet, refused when a mesh size is asked for.  As in the JAX CLI,
    --mesh_seq / --mesh_job without a mesh size leave the pipeline as it is."""
    spec = args.mesh if args.mesh is not None else template_cfg.get("mesh_devices")
    if spec in (None, "", 0, "0", "off", False):
        return pipe
    raise NotImplementedError(
        f"the device mesh (--mesh {spec}, --mesh_seq {args.mesh_seq}, --mesh_job "
        f"{args.mesh_job}) is not ported yet (ROADMAP.md §1 item 10: multi-GPU)")


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
