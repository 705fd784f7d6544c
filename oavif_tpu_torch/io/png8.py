"""PNG decoder for bit depths 1, 2, 4 and 8, without Pillow.

Color types 0 (gray), 2 (truecolor), 3 (palette), 4 (gray + alpha) and 6
(truecolor + alpha), ``PLTE`` and ``tRNS``, the five filters, Adam7
interlacing, and ``iCCP`` passed through as the ICC profile. The result
follows the reference's format selection (oavif src/io.zig:269-297):
truecolor decodes to RGB8, everything else to RGBA8, with the samples
and the transparency that Pillow's ``convert("RGBA")`` gives the same
file (``tests/test_torch_png.py`` holds the two equal).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# samples per pixel, and the bit depths legal for each color type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, payload) of each chunk up to ``IEND``; raises ValueError on a
    missing signature or a bad CRC. A file that ends early ends the
    chunks: the last one, cut short, comes with what it holds (as Pillow
    reads it, the image decodes if its data is all there)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        end = pos + 8 + length
        payload = data[pos + 8 : end]
        if end + 4 > len(data):
            yield ctype, payload
            return
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"broken PNG file (bad CRC in {ctype!r})")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def icc_of(payload: bytes) -> Optional[bytes]:
    """The profile of an ``iCCP`` payload (name, NUL, method 0, zlib)."""
    nul = payload.find(b"\x00")
    if nul < 0 or len(payload) < nul + 2:
        return None
    return zlib.decompress(payload[nul + 2 :])


def inflate(idat: bytes) -> bytes:
    """The zlib stream of the ``IDAT`` chunks, inflated as far as it goes
    (a stream cut short leaves too few rows, which ``unfilter`` refuses)."""
    try:
        return zlib.decompressobj().decompress(idat)
    except zlib.error as e:
        raise ValueError(f"broken PNG image data: {e}") from None


def unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``height`` rows of ``stride`` bytes
    (each preceded by its filter type); (height, stride) uint8."""
    from ..av1.entropy.fast import get_lib

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable: the C runtime "
                           "(oavif_tpu_torch/av1/entropy) failed to build")
    out = np.empty((height, stride), dtype=np.uint8)
    rc = lib.png_unfilter(raw, len(raw), out.ctypes.data, height, stride,
                          bpp)
    if rc < 0:
        raise ValueError("truncated PNG image data")
    if rc > 0:
        raise ValueError(f"bad PNG filter type in row {rc - 1}")
    return out


def _samples(rows: np.ndarray, width: int, nch: int, depth: int
             ) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, width, nch) uint8 samples at
    their own depth (not scaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : width * nch].reshape(h, width, nch)
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    vals = vals.reshape(h, rows.shape[1] * per_byte)[:, : width * nch]
    return vals.reshape(h, width, nch).astype(np.uint8)


def _decode_pixels(raw: bytes, width: int, height: int, nch: int,
                   depth: int, interlace: int) -> np.ndarray:
    """The image's (height, width, nch) samples from the inflated data."""
    bpp = max(1, nch * depth // 8)

    def stride(w: int) -> int:
        return (w * nch * depth + 7) // 8

    if interlace == 0:
        rows = unfilter(raw, height, stride(width), bpp)
        return _samples(rows, width, nch, depth)
    out = np.zeros((height, width, nch), dtype=np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if pw == 0 or ph == 0:
            continue  # an empty pass has no bytes, not even filter types
        n = ph * (stride(pw) + 1)
        rows = unfilter(raw[pos : pos + n], ph, stride(pw), bpp)
        pos += n
        out[y0::dy, x0::dx] = _samples(rows, pw, nch, depth)
    return out


def decode_png8(data: bytes) -> Tuple[np.ndarray, Optional[bytes]]:
    """Decode a PNG of bit depth 1, 2, 4 or 8 to ((h, w, 3) uint8 for
    truecolor, else (h, w, 4) uint8 RGBA, icc_or_None)."""
    ihdr = None
    palette = trns = icc = None
    idat = []
    for ctype, payload in chunks(data):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise ValueError("bad PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif ihdr is None:
            raise ValueError("PNG file does not start with IHDR")
        elif ctype == b"PLTE":
            if len(payload) % 3 or not payload:
                raise ValueError("bad PNG palette")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"iCCP":
            icc = icc_of(payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if ihdr is None:
        raise ValueError("PNG file has no IHDR")
    width, height, depth, ctype_, comp, filt, interlace = ihdr
    if ctype_ not in _CHANNELS or depth not in _DEPTHS[ctype_]:
        raise ValueError(f"bad PNG color type {ctype_} at depth {depth}")
    if depth == 16:
        raise ValueError("decode_png8 takes bit depths 1 to 8")
    if width == 0 or height == 0 or comp != 0 or filt != 0 or interlace > 1:
        raise ValueError("bad PNG header")
    if not idat:
        raise ValueError("PNG file has no image data")
    raw = inflate(b"".join(idat))
    px = _decode_pixels(raw, width, height, _CHANNELS[ctype_], depth,
                        interlace)
    if ctype_ == 2:  # truecolor: RGB8, any tRNS ignored (io.zig:269-297)
        return px, icc
    return _to_rgba(px, ctype_, depth, palette, trns), icc


def _to_rgba(px: np.ndarray, color_type: int, depth: int,
             palette: Optional[np.ndarray], trns: Optional[bytes]
             ) -> np.ndarray:
    """(h, w, nch) samples -> (h, w, 4) RGBA8 as Pillow converts them."""
    h, w = px.shape[:2]
    out = np.empty((h, w, 4), dtype=np.uint8)
    if color_type == 3:
        if palette is None:
            raise ValueError("PNG palette image without PLTE")
        lut = np.zeros((256, 4), dtype=np.uint8)
        lut[:, 3] = 255
        lut[: len(palette), :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            lut[: len(alpha), 3] = alpha
        return lut[px[..., 0]]
    if color_type == 4:
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
        return out
    if color_type == 6:
        return np.ascontiguousarray(px)
    # gray: Pillow scales 1-, 2- and 4-bit samples to 8 bits, and tests
    # tRNS's gray value against the scaled sample: scaled itself at depth
    # 1 (mode "1"), as it stands at depths 2 and 4 (mode "L")
    g = px[..., 0]
    if depth < 8:
        g = (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
    out[..., :3] = g[..., None]
    out[..., 3] = 255
    if trns is not None and len(trns) >= 2:
        (key,) = struct.unpack(">H", trns[:2])
        out[..., 3] = np.where(g == key * (255 if depth == 1 else 1), 0, 255)
    return out
