"""Encoder backend of the port: ``cuda.CudaBackend``, the counterpart of
``oavif_tpu.backend.tpu.TpuBackend``, and the encoder context and
bitstream cache types it works on (copies of the reference's)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..options import EncOptions
from ..io.image import Image


@dataclass
class EncBuffer:
    """Cached last-encoded bitstream (reference main.zig:11-23)."""

    q: Optional[int] = None
    data: Optional[bytes] = None
    size: int = 0


@dataclass
class EncCtx:
    """Encoder context shared by the CLI, TQ loop, and backends
    (reference main.zig:26-35)."""

    o: EncOptions
    src: Image
    rgb: np.ndarray  # 8-bit RGB metric reference, (h, w, 3)
    w: int
    h: int
    q: int = 0
    num_pass: int = 0       # encodes performed (reference pass semantics)
    num_rounds: int = 0     # batched mode: scoring rounds (<= num_pass)
    score: float = 0.0
    buf: EncBuffer = field(default_factory=EncBuffer)
