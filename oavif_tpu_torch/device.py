"""The port's device: CUDA unless the CPU is asked for by name."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The torch.device the port computes on.

    Default ``cuda``; raises when CUDA is absent. ``cpu`` only when asked
    for explicitly, by argument or by ``OAVIF_TORCH_DEVICE=cpu`` (the CPU
    runs the kernels' plain PyTorch versions). TF32 stays off for
    convolutions and matmuls, so float32 work keeps float32 precision."""
    dev = torch.device(
        device if device is not None
        else os.environ.get("OAVIF_TORCH_DEVICE", "cuda"))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; set OAVIF_TORCH_DEVICE=cpu to run the "
            "plain PyTorch versions on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
