"""Host-side image ingestion.

Equivalent capability surface to the reference loader
(oavif src/io.zig:42-542): extension-dispatched decode of
PNG / PAM / JPEG / WebP / AVIF to an interleaved RGB(A)/gray image at 8 or
16 bits with ICC passthrough, plus the to_rgb8 normalization used as the
metric reference (io.zig:57-133).

Implementation is NumPy + Pillow for the baseline formats (the reference
likewise delegates to libspng/libjpeg-turbo/libwebp — format decode is host
work, not TPU work), with a custom decoder for 16-bit PNG (Pillow has no
RGB48 mode) and a custom P7 PAM parser (Pillow has none).
"""

from __future__ import annotations

import io as _stdio
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


def _pil_open(path: str):
    from PIL import Image as PILImage

    im = PILImage.open(path)
    im.load()
    return im


def load_jpeg(path: str) -> Image:
    """JPEG decode: grayscale stays 1-channel, everything else RGB
    (io.zig:196-199); ICC passthrough (io.zig:186-194)."""
    im = _pil_open(path)
    icc = im.info.get("icc_profile")
    if im.mode == "L":
        arr = np.asarray(im)[..., None]
        ch = 1
    else:
        arr = np.asarray(im.convert("RGB"))
        ch = 3
    h, w = arr.shape[:2]
    return Image(width=w, height=h, channels=ch, hbd=False, data=arr, icc=icc)


def load_png(path: str) -> Image:
    """PNG decode mirroring the reference's format selection
    (io.zig:269-297): 16-bit → RGBA16; truecolor → RGB8; anything else
    (gray, gray+alpha, palette, truecolor+alpha) → RGBA8."""
    with open(path, "rb") as f:
        head = f.read(33)
    # IHDR: bit depth at offset 24, color type at 25 (after 8-byte sig +
    # 4-len + 4-type + 13-byte IHDR payload starts at 16).
    is_16bit = len(head) >= 26 and head[24] == 16

    if is_16bit:
        from .png16 import decode_png16

        arr, icc = decode_png16(path)  # (h, w, 4) uint16 RGBA
        h, w = arr.shape[:2]
        return Image(width=w, height=h, channels=4, hbd=True, data=arr, icc=icc)

    im = _pil_open(path)
    icc = im.info.get("icc_profile")
    if im.mode == "RGB":
        arr = np.asarray(im)
        ch = 3
    else:
        arr = np.asarray(im.convert("RGBA"))
        ch = 4
    h, w = arr.shape[:2]
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
    """WebP decode with alpha detection (io.zig:408-445)."""
    im = _pil_open(path)
    has_alpha = "A" in im.mode or "transparency" in im.info
    if has_alpha:
        arr = np.asarray(im.convert("RGBA"))
        ch = 4
    else:
        arr = np.asarray(im.convert("RGB"))
        ch = 3
    h, w = arr.shape[:2]
    return Image(width=w, height=h, channels=ch, hbd=False, data=arr)


def load_avif(path: str) -> Image:
    """AVIF input decode (io.zig:499-542).

    Depth-preserving path first: libavif (ctypes) yields native-depth
    YUV444 planes; high-bit-depth converts to RGB at source depth and
    left-shifts to 16-bit exactly like the reference (io.zig:525-532).
    The native path runs only for full-range BT.601 streams
    (matrixCoefficients 5/6 — checked from the decoded image's CICP,
    which is what the _INV matrix implements) with no alpha; everything
    else — 8-bit, alpha, other matrices — takes Pillow (8-bit window,
    keeps alpha + ICC), matching the reference's avifImageYUVToRGB
    CICP handling through its own converter.
    """
    im = _pil_open(path)  # opened once: alpha probe + ICC + fallback
    icc = im.info.get("icc_profile")
    try:
        from .avif_ctypes import decode_to_yuv

        # alpha images keep the Pillow path (the native path is Y'UV only)
        has_alpha = "A" in im.mode
        with open(path, "rb") as f:
            data = f.read()
        planes, depth, yuv_range, cicp = decode_to_yuv(data, want_cicp=True)
        mc = cicp[2]
        # 5/6 = BT.601 (what _INV implements); 2 = unspecified, which
        # libavif's own converter also resolves to 601 in practice
        if depth > 8 and yuv_range == 1 and mc in (2, 5, 6) and not has_alpha:
            from ..av1.yuv import _INV

            maxv = (1 << depth) - 1
            h, w = planes[0].shape
            yuv = np.stack(
                [p.reshape(-1) for p in planes], axis=1
            ).astype(np.float32)
            yuv[:, 1:] -= np.float32((maxv + 1) / 2)
            rgb = np.clip(np.floor(yuv @ _INV + 0.5), 0, maxv)
            rgb16 = (rgb.astype(np.uint16) << (16 - depth)).reshape(h, w, 3)
            return Image(width=w, height=h, channels=3, hbd=True,
                         data=rgb16, icc=icc)
    except Exception:
        pass
    if "A" in im.mode:
        arr = np.asarray(im.convert("RGBA"))
        ch = 4
    else:
        arr = np.asarray(im.convert("RGB"))
        ch = 3
    h, w = arr.shape[:2]
    return Image(width=w, height=h, channels=ch, hbd=False, data=arr, icc=icc)


def decode_avif_to_rgb8(avif_bytes: bytes) -> np.ndarray:
    """Decode an in-memory AVIF to (h, w, 3) uint8, alpha dropped — the
    metric's decode window (io.zig:638-666, forced 8-bit, 3 channels)."""
    from PIL import Image as PILImage

    im = PILImage.open(_stdio.BytesIO(avif_bytes))
    im.load()
    return np.asarray(im.convert("RGB"))
