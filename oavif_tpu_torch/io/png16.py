"""Minimal 16-bit PNG decoder (Pillow lacks an RGB48 mode).

Handles bit-depth-16, color types 0/2/4/6, non-interlaced, producing RGBA16
like the reference's spng SPNG_FMT_RGBA16 path (oavif src/io.zig:
269-271): missing alpha fills with 65535, gray expands to RGB. Extracts the
iCCP chunk (io.zig:261-267).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters. Returns (height, stride) uint8."""
    out = np.zeros((height, stride), dtype=np.uint8)
    pos = 0
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        ftype = raw[pos]
        pos += 1
        row = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=pos).copy()
        pos += stride
        if ftype == 0:
            pass
        elif ftype == 2:  # up
            row += prev
        elif ftype == 1:  # sub
            r = row.astype(np.int32)
            for x in range(bpp, stride):
                r[x] = (r[x] + r[x - bpp]) & 0xFF
            row = r.astype(np.uint8)
        elif ftype == 3:  # average
            r = row.astype(np.int32)
            p = prev.astype(np.int32)
            for x in range(stride):
                left = r[x - bpp] if x >= bpp else 0
                r[x] = (r[x] + ((left + p[x]) >> 1)) & 0xFF
            row = r.astype(np.uint8)
        elif ftype == 4:  # paeth
            r = row.astype(np.int32)
            p = prev.astype(np.int32)
            for x in range(stride):
                left = r[x - bpp] if x >= bpp else 0
                ul = p[x - bpp] if x >= bpp else 0
                r[x] = (r[x] + _paeth(left, int(p[x]), ul)) & 0xFF
            row = r.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = row
        prev = row
    return out


def decode_png16(path: str) -> Tuple[np.ndarray, Optional[bytes]]:
    """Decode a 16-bit PNG to ((h, w, 4) uint16 RGBA, icc_or_None)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError("not a PNG")

    pos = len(_SIG)
    width = height = 0
    color_type = -1
    interlace = 0
    idat = bytearray()
    icc: Optional[bytes] = None

    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
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
            nul = payload.find(b"\x00")
            if nul >= 0 and len(payload) > nul + 2:
                icc = zlib.decompress(payload[nul + 2 :])
        elif ctype == b"IDAT":
            idat.extend(payload)
        elif ctype == b"IEND":
            break

    nch = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if nch is None:
        raise ValueError(f"unsupported 16-bit PNG color type {color_type}")

    raw = zlib.decompress(bytes(idat))
    bpp = nch * 2
    stride = width * bpp
    rows = _unfilter(raw, height, stride, bpp)
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
