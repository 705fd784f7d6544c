"""WebP decoder without Pillow.

The container (RIFF ``WEBP``: the simple ``VP8 `` and ``VP8L`` forms and
the extended ``VP8X`` form with its ``ALPH``, ``ANIM``, ``ANMF``,
``ICCP``, ``EXIF`` and ``XMP `` chunks) is read here, with the checks of
libwebp's demuxer; the C side (``webp_decode.c``, in the host library)
decodes the VP8 key frames, the VP8L image streams and the ``ALPH``
planes. The result is what the reference's loader gets from Pillow, which
decodes with libwebp's animation decoder in ``MODE_RGBA``: the first
frame on a zero canvas at its offset, RGBA where libwebp reports alpha
(``WebPGetFeatures``) and RGB otherwise (``tests/test_torch_webp.py``
holds both equal). A file that libwebp refuses raises ``OSError``, as
Pillow's ``open`` and ``load`` do; the variants it refuses by design (a
VP8 inter frame, a VP8L version other than 0) raise ``UnsupportedWebP``,
which is both an ``OSError`` and a ``ValueError`` naming them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# VP8X flags (libwebp's format_constants.h)
ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ALPHA_FLAG, ICCP_FLAG = 2, 4, 8, 16, 32
_VALID_FLAGS = ANIMATION_FLAG | XMP_FLAG | EXIF_FLAG | ALPHA_FLAG | ICCP_FLAG
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_ERRORS = {-1: "corrupt", -2: "truncated", -3: "out of memory"}


class UnsupportedWebP(OSError, ValueError):
    """A WebP variant that libwebp's decoder refuses by design."""


def _broken(what: str) -> OSError:
    return OSError(f"broken WebP file ({what})")


def _le(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "little")


@dataclass
class Frame:
    """One frame: its image chunk (payload offset and size), its ALPH
    chunk's where it has one, and its place on the canvas."""

    image: Tuple[int, int]
    lossless: bool
    width: int
    height: int
    alpha: Optional[Tuple[int, int]] = None
    x: int = 0
    y: int = 0


def bitstream_info(data: bytes, start: int, size: int, lossless: bool):
    """libwebp's VP8GetInfo / VP8LGetInfo of a chunk payload: (width,
    height, the VP8L alpha hint)."""
    p = data[start:start + size]
    if lossless:
        if len(p) < 5 or p[0] != 0x2F:
            raise _broken("VP8L signature")
        if p[4] >> 5:
            raise UnsupportedWebP(f"unsupported WebP VP8L version "
                                  f"{p[4] >> 5}")
        bits = _le(p, 1, 4)
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, \
            bool((bits >> 28) & 1)
    if len(p) < 10 or p[3:6] != b"\x9d\x01\x2a":
        raise _broken("VP8 signature")
    tag = _le(p, 0, 3)
    if tag & 1:
        raise UnsupportedWebP("unsupported WebP: a VP8 inter frame")
    if (tag >> 1) & 7 > 3 or not (tag >> 4) & 1 or tag >> 5 >= size:
        raise _broken("VP8 frame tag")
    w, h = _le(p, 6, 2) & 0x3FFF, _le(p, 8, 2) & 0x3FFF
    if not w or not h:
        raise _broken("VP8 size")
    return w, h, False


class _Demux:
    """libwebp's demuxer (demux.c) over a whole file: the canvas, the
    flags and the frames."""

    def __init__(self, data: bytes) -> None:
        if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise _broken("no RIFF WEBP header")
        riff_size = _le(data, 4, 4)
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise _broken("RIFF size")
        end = riff_size + 8
        if len(data) < end:
            raise _broken("truncated")
        self.data, self.end = data, end
        self.flags = 0
        self.has_alpha_hint = False
        self.first_chunk = 12  # after the VP8X chunk in the extended form
        self.canvas = (0, 0)
        self.frames = []
        first = data[12:16]
        if first in (b"VP8 ", b"VP8L"):
            self._tail(self._single(12))
            self.canvas = (self.frames[0].width, self.frames[0].height)
        elif first == b"VP8X":
            self._vp8x()
        else:
            raise _broken(f"first chunk {first!r}")
        if not self.frames:
            raise _broken("no image")

    def _chunk(self, pos: int):
        """(fourcc, payload size, payload start, next chunk); raises
        where the chunk runs past the RIFF data."""
        if self.end - pos < 8:
            raise _broken("truncated chunk header")
        size = _le(self.data, pos + 4, 4)
        if size > _MAX_CHUNK_PAYLOAD:
            raise _broken("chunk size")
        padded = size + (size & 1)
        if padded > self.end - pos - 8:
            raise _broken("truncated chunk")
        return self.data[pos:pos + 4], size, pos + 8, pos + 8 + padded

    def _store(self, pos: int, limit: int):
        """StoreFrame: an ALPH chunk and then the image chunk, from pos up
        to limit; returns (alpha, image, lossless, next position)."""
        alpha = image = None
        lossless = False
        while pos < limit:
            tag, size, start, nxt = self._chunk(pos)
            if tag == b"ALPH" and alpha is None and image is None:
                alpha = (start, size)
            elif tag in (b"VP8 ", b"VP8L") and image is None:
                if tag == b"VP8L" and alpha is not None:
                    raise _broken("ALPH before VP8L")
                image, lossless = (start, size), tag == b"VP8L"
            else:
                break
            pos = nxt
        return alpha, image, lossless, pos

    def _single(self, pos: int) -> int:
        if self.frames:
            raise _broken("a second image")
        alpha, image, lossless, pos = self._store(pos, self.end)
        if image is None:
            raise _broken("no image chunk")
        w, h, hint = bitstream_info(self.data, *image, lossless)
        self.has_alpha_hint = hint
        if not self.flags & ALPHA_FLAG:
            alpha = None  # an ALPH chunk counts only under the VP8X flag
        self.frames.append(Frame(image, lossless, w, h, alpha))
        return pos

    def _tail(self, pos: int) -> None:
        """A simple file after its image: chunks up to the RIFF end."""
        while pos < self.end:
            _, _, _, pos = self._chunk(pos)

    def _vp8x(self) -> None:
        tag, size, start, pos = self._chunk(12)
        if size < 10:
            raise _broken("VP8X size")
        self.first_chunk = pos
        d = self.data
        self.flags = d[start]
        self.canvas = (1 + _le(d, start + 4, 3), 1 + _le(d, start + 7, 3))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            raise _broken("canvas size")
        animated = bool(self.flags & ANIMATION_FLAG)
        anim = False
        while pos < self.end:
            tag, size, start, nxt = self._chunk(pos)
            if tag == b"VP8X":
                raise _broken("a second VP8X chunk")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim or animated:
                    raise _broken("an image outside ANMF in an animation")
                nxt = self._single(pos)
            elif tag == b"ANIM":
                if size + (size & 1) < 6:
                    raise _broken("ANIM size")
                anim = True
            elif tag == b"ANMF":
                if not anim:
                    raise _broken("ANMF before ANIM")
                self._anmf(start, size + (size & 1), animated)
            pos = nxt
        if self.flags & ~_VALID_FLAGS:
            raise _broken("reserved VP8X flags")
        for f in self.frames:
            if animated:
                fits = (f.x + f.width <= self.canvas[0]
                        and f.y + f.height <= self.canvas[1])
            else:
                fits = (f.x, f.y, f.width, f.height) == (0, 0, *self.canvas)
            if not fits:
                raise _broken("frame outside the canvas")

    def _anmf(self, start: int, size: int, animated: bool) -> None:
        if size < 16:
            raise _broken("ANMF size")
        d = self.data
        x, y = 2 * _le(d, start, 3), 2 * _le(d, start + 3, 3)
        w, h = 1 + _le(d, start + 6, 3), 1 + _le(d, start + 9, 3)
        if w * h >= _MAX_IMAGE_AREA:
            raise _broken("frame size")
        alpha, image, lossless, pos = self._store(start + 16, start + size)
        if pos - start > size:
            raise _broken("ANMF size")
        if image is None:
            if alpha is not None:
                raise _broken("ANMF with ALPH and no image")
            return
        if not animated:
            return
        fw, fh, _ = bitstream_info(d, *image, lossless)
        if (fw, fh) != (w, h):
            raise _broken("frame size against its bitstream")
        self.frames.append(Frame(image, lossless, w, h, alpha, x, y))

    def has_alpha(self) -> bool:
        """WebPGetFeatures' has_alpha, which sets Pillow's mode: the VP8X
        flag of an animation; the VP8L header's hint; or, for VP8, the
        VP8X flag or any ALPH chunk."""
        if self.flags & ANIMATION_FLAG:
            return bool(self.flags & ALPHA_FLAG)
        f = self.frames[0]
        if f.lossless:
            return self.has_alpha_hint
        return bool(self.flags & ALPHA_FLAG) or self._any_alph()

    def _any_alph(self) -> bool:
        pos = self.first_chunk
        while pos < self.end:
            tag, _, _, nxt = self._chunk(pos)
            if tag in (b"VP8 ", b"VP8L"):
                return False
            if tag == b"ALPH":
                return True
            pos = nxt
        return False


def _check(rc: int, what: str) -> None:
    if rc:
        raise _broken(f"{what}: {_ERRORS.get(rc, rc)}")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def decode_vp8(lib, data: bytes, start: int, size: int, w: int, h: int):
    """The Y', U and V planes of a VP8 key frame, as libwebp's."""
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(lib.webp_vp8_decode(data[start:start + size], size, w, h,
                               _ptr(y), _ptr(u), _ptr(v)), "VP8")
    return y, u, v


def _frame_rgba(lib, data: bytes, f: Frame) -> np.ndarray:
    """One frame as libwebp's WebPDecode gives it in MODE_RGBA."""
    start, size = f.image
    if f.lossless:
        argb = np.empty((f.height, f.width), np.uint32)
        _check(lib.webp_vp8l_decode(data[start + 5:start + size], size - 5,
                                    f.width, f.height, _ptr(argb)), "VP8L")
        out = argb.view(np.uint8).reshape(f.height, f.width, 4)
        return out[..., [2, 1, 0, 3]]  # B, G, R, A in memory -> RGBA
    y, u, v = decode_vp8(lib, data, start, size, f.width, f.height)
    rgba = np.empty((f.height, f.width, 4), np.uint8)
    lib.webp_yuv_to_rgba(_ptr(y), _ptr(u), _ptr(v), f.width, f.height,
                         _ptr(rgba), f.width * 4)
    if f.alpha is not None:
        a0, asize = f.alpha
        alpha = np.empty((f.height, f.width), np.uint8)
        _check(lib.webp_alpha_decode(data[a0:a0 + asize], asize, f.width,
                                     f.height, _ptr(alpha)), "ALPH")
        rgba[..., 3] = alpha
    return rgba


def decode_webp(data: bytes) -> np.ndarray:
    """Decode a WebP file to (h, w, 4) uint8 RGBA where libwebp reports
    alpha, else (h, w, 3) uint8 RGB: the first frame on the canvas."""
    from ..av1.entropy.fast import get_lib

    dmx = _Demux(bytes(data))
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable: the C runtime "
                           "(oavif_tpu_torch/av1/entropy) failed to build")
    f = dmx.frames[0]
    rgba = _frame_rgba(lib, dmx.data, f)
    cw, ch = dmx.canvas
    if (f.x, f.y, f.width, f.height) != (0, 0, cw, ch):
        canvas = np.zeros((ch, cw, 4), np.uint8)  # a key frame's canvas
        canvas[f.y:f.y + f.height, f.x:f.x + f.width] = rgba
        rgba = canvas
    if dmx.has_alpha():
        return np.ascontiguousarray(rgba)
    return np.ascontiguousarray(rgba[..., :3])
