"""Host-side image ingestion.

Equivalent capability surface to the reference loader
(oavif src/io.zig:42-542): extension-dispatched decode of
PNG / PAM / JPEG / WebP / AVIF to an interleaved RGB(A)/gray image at 8 or
16 bits with ICC passthrough, plus the to_rgb8 normalization used as the
metric reference (io.zig:57-133).

PNG (``png8``, ``png16``), JPEG (``jpeg``), WebP (``webp``), AVIF
(``avif``) and PAM are decoded by the port's own readers, with zlib,
NumPy and the host library's C (the reference delegates to
libjpeg-turbo/libwebp/libavif — format decode is host work, not device
work).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Image:
    """Decoded image: interleaved, row-major (io.zig:42-48).

    ``data`` is (h, w, channels) uint8, or uint16 when ``hbd``.
    channels: 1=Gray, 2=GrayA, 3=RGB, 4=RGBA.
    """

    width: int
    height: int
    channels: int
    hbd: bool
    data: np.ndarray
    icc: Optional[bytes] = None


def to_rgb8(img: Image) -> np.ndarray:
    """Normalize to (h, w, 3) uint8 for the metric reference (io.zig:57-133).

    16-bit samples shift down by 8; gray expands to 3 channels; alpha drops.
    """
    d = img.data
    if img.hbd:
        d = (d >> 8).astype(np.uint8)
    if img.channels == 3:
        return np.ascontiguousarray(d)
    if img.channels == 4:
        return np.ascontiguousarray(d[..., :3])
    if img.channels in (1, 2):
        g = d[..., 0] if d.ndim == 3 else d
        return np.ascontiguousarray(np.repeat(g[..., None], 3, axis=-1))
    raise ValueError(f"unsupported channel count {img.channels}")


def _has_ext(path: str, *exts: str) -> bool:
    lower = path.lower()
    return any(lower.endswith(e) for e in exts)


def load_image(path: str) -> Image:
    """Extension-dispatched load (io.zig:136-150)."""
    if _has_ext(path, ".jpg", ".jpeg"):
        return load_jpeg(path)
    if _has_ext(path, ".png"):
        return load_png(path)
    if _has_ext(path, ".pam"):
        return load_pam(path)
    if _has_ext(path, ".webp"):
        return load_webp(path)
    if _has_ext(path, ".avif"):
        return load_avif(path)
    raise ValueError(f"unsupported image format: {path}")


def load_jpeg(path: str) -> Image:
    """JPEG decode: grayscale stays 1-channel, everything else RGB
    (io.zig:196-199); ICC passthrough (io.zig:186-194). Decoded by the
    port's own reader (``jpeg``), not Pillow."""
    from .jpeg import decode_jpeg

    with open(path, "rb") as f:
        arr, icc = decode_jpeg(f.read())
    h, w, ch = arr.shape
    return Image(width=w, height=h, channels=ch, hbd=False, data=arr, icc=icc)


def load_png(path: str) -> Image:
    """PNG decode mirroring the reference's format selection
    (io.zig:269-297): 16-bit → RGBA16; truecolor → RGB8; anything else
    (gray, gray+alpha, palette, truecolor+alpha) → RGBA8. Decoded by the
    port's own readers (``png16``, ``png8``), not Pillow."""
    with open(path, "rb") as f:
        data = f.read()
    # IHDR: bit depth at offset 24, color type at 25 (after 8-byte sig +
    # 4-len + 4-type + 13-byte IHDR payload starts at 16).
    if len(data) >= 26 and data[24] == 16:
        from .png16 import decode_png16

        arr, icc = decode_png16(data)  # (h, w, 4) uint16 RGBA
        h, w = arr.shape[:2]
        return Image(width=w, height=h, channels=4, hbd=True, data=arr, icc=icc)

    from .png8 import decode_png8

    arr, icc = decode_png8(data)
    h, w, ch = arr.shape
    return Image(width=w, height=h, channels=ch, hbd=False, data=arr, icc=icc)


def load_pam(path: str) -> Image:
    """Netpbm PAM (P7) parser (io.zig:309-406): maxval must be 255, depth
    1..4, TUPLTYPE consistency enforced."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 3 or not buf.startswith(b"P7"):
        raise ValueError("not a PAM file")

    idx = buf.find(b"ENDHDR\n")
    if idx >= 0:
        header_end = idx + 7
    else:
        idx = buf.find(b"\n\n")
        if idx < 0:
            raise ValueError("PAM header not found")
        header_end = idx + 2

    width = height = depth = maxval = 0
    tuple_type = "UNSPECIFIED"
    for raw in buf[:header_end].splitlines():
        line = raw.decode("latin-1").strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("WIDTH"):
            width = int(line[5:].split()[0])
        elif line.startswith("HEIGHT"):
            height = int(line[6:].split()[0])
        elif line.startswith("DEPTH"):
            depth = int(line[5:].split()[0])
        elif line.startswith("MAXVAL"):
            maxval = int(line[6:].split()[0])
        elif line.startswith("TUPLTYPE"):
            tuple_type = line[8:].split()[0]
        elif line == "ENDHDR":
            break

    if width == 0 or height == 0 or depth == 0 or maxval == 0:
        raise ValueError("invalid PAM dimensions")
    if maxval != 255:
        raise ValueError("unsupported PAM maxval (must be 255)")
    if depth not in (1, 2, 3, 4):
        raise ValueError("unsupported PAM depth")

    expected = {
        "GRAYSCALE": 1,
        "GRAYSCALE_ALPHA": 2,
        "RGB": 3,
        "RGB_ALPHA": 4,
    }.get(tuple_type.upper())
    if tuple_type.upper() == "BLACKANDWHITE":
        raise ValueError("unsupported PAM tuple type")
    if expected is not None and expected != depth:
        raise ValueError("PAM tuple type / depth mismatch")

    n = width * height * depth
    if header_end + n > len(buf):
        raise ValueError("insufficient data in PAM file")
    arr = np.frombuffer(buf, dtype=np.uint8, count=n, offset=header_end)
    arr = arr.reshape(height, width, depth).copy()
    return Image(width=width, height=height, channels=depth, hbd=False, data=arr)


def load_webp(path: str) -> Image:
    """WebP decode with alpha detection (io.zig:408-445): RGBA where the
    file has alpha, else RGB; the first frame of an animation; the ICC
    profile dropped, as the reference drops it. Decoded by the port's own
    reader (``webp``), not Pillow."""
    from .webp import decode_webp

    with open(path, "rb") as f:
        arr = decode_webp(f.read())
    h, w, ch = arr.shape
    return Image(width=w, height=h, channels=ch, hbd=False, data=arr)


def load_avif(path: str) -> Image:
    """AVIF input decode (io.zig:499-542), by the port's own reader
    (``avif``: the container in Python, the AV1 key frame in the host
    library's C), neither Pillow nor libavif.

    As the reference reads: 10-bit full-range streams with matrix
    coefficients 2, 5 or 6 and no alpha convert to RGB at their depth and
    shift to 16 bits (io.zig:525-532); everything else is 8-bit RGB, or
    RGBA with an alpha item, converted as libavif converts; the ICC
    profile passes through.
    """
    from .avif import read_avif

    with open(path, "rb") as f:
        arr, hbd, icc = read_avif(f.read())
    h, w, ch = arr.shape
    return Image(width=w, height=h, channels=ch, hbd=hbd, data=arr, icc=icc)


def decode_avif_to_rgb8(avif_bytes: bytes) -> np.ndarray:
    """Decode an in-memory AVIF to (h, w, 3) uint8, alpha dropped — the
    metric's decode window (io.zig:638-666, forced 8-bit, 3 channels) —
    by the port's own reader, with libavif's conversion to RGB as
    Pillow's AVIF plugin asks for it (``avif.decode_avif_rgb8``)."""
    from .avif import decode_avif_rgb8

    return decode_avif_rgb8(avif_bytes)
