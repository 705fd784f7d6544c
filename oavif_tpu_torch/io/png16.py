"""Minimal 16-bit PNG decoder (Pillow lacks an RGB48 mode).

Handles bit-depth-16, color types 0/2/4/6, non-interlaced, producing RGBA16
like the reference's spng SPNG_FMT_RGBA16 path (oavif src/io.zig:
269-271): missing alpha fills with 65535, gray expands to RGB. Extracts the
iCCP chunk (io.zig:261-267).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .png8 import chunks, icc_of, inflate, unfilter


def decode_png16(data: bytes) -> Tuple[np.ndarray, Optional[bytes]]:
    """Decode a 16-bit PNG to ((h, w, 4) uint16 RGBA, icc_or_None)."""
    width = height = 0
    color_type = -1
    idat = bytearray()
    icc: Optional[bytes] = None
    for ctype, payload in chunks(data):
        if ctype == b"IHDR":
            width, height = struct.unpack(">II", payload[:8])
            bit_depth = payload[8]
            color_type = payload[9]
            interlace = payload[12]
            if bit_depth != 16:
                raise ValueError("decode_png16 requires bit depth 16")
            if interlace != 0:
                raise ValueError("interlaced 16-bit PNG not supported")
        elif ctype == b"iCCP":
            icc = icc_of(payload)
        elif ctype == b"IDAT":
            idat.extend(payload)

    nch = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if nch is None:
        raise ValueError(f"unsupported 16-bit PNG color type {color_type}")

    raw = inflate(bytes(idat))
    bpp = nch * 2
    stride = width * bpp
    rows = unfilter(raw, height, stride, bpp)
    # PNG 16-bit samples are big-endian.
    arr = rows.reshape(height, width, nch, 2)
    vals = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1].astype(np.uint16)

    out = np.empty((height, width, 4), dtype=np.uint16)
    if nch == 1:
        out[..., 0] = out[..., 1] = out[..., 2] = vals[..., 0]
        out[..., 3] = 65535
    elif nch == 2:
        out[..., 0] = out[..., 1] = out[..., 2] = vals[..., 0]
        out[..., 3] = vals[..., 1]
    elif nch == 3:
        out[..., :3] = vals
        out[..., 3] = 65535
    else:
        out[...] = vals
    return out, icc
