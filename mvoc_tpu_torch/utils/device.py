"""Device resolution for the port's entry points: CUDA unless the caller
asks for another device, and never a silent fall-back to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mvoc_tpu_torch runs on CUDA by default and no CUDA device is "
                           "available; pass device='cpu' explicitly to run on the CPU")
    return dev
