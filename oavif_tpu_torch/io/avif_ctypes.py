"""ctypes bindings to the system libavif decoder — a yardstick for the
tests, on no entry point's path.

The port decodes AVIF with its own reader (``avif``). The tests hold its
Y'UV planes to the system libavif's (0.11.1 with dav1d, through
avifDecoder.image->yuvPlanes: the reference's recon==decode invariant,
SURVEY.md §4a), and can read that libavif's own RGB through
avifImageYUVToRGB. The card's machine has no libavif; nothing of the
port calls this module.
"""

from __future__ import annotations

import contextlib
import ctypes as C
from typing import List, Tuple

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is None:
        try:
            _lib = C.CDLL("libavif.so.15")
        except OSError as e:
            raise OSError(f"AVIF decode needs libavif.so.15, which this "
                          f"machine does not have ({e})") from None
    return _lib


class _avifROData(C.Structure):
    _fields_ = [("data", C.POINTER(C.c_uint8)), ("size", C.c_size_t)]


@contextlib.contextmanager
def _decoded(avif_bytes: bytes):
    """Decode the first image of an AVIF; yields (library, avifImage*),
    valid until the block ends. Raises RuntimeError on decode failure
    (conformance failure signal) or an unknown struct layout."""
    lib = _load()
    lib.avifDecoderCreate.restype = C.c_void_p
    dec = lib.avifDecoderCreate()
    if not dec:
        raise RuntimeError("avifDecoderCreate failed")
    try:
        buf = (C.c_uint8 * len(avif_bytes)).from_buffer_copy(avif_bytes)
        res = lib.avifDecoderSetIOMemory(
            C.c_void_p(dec), buf, C.c_size_t(len(avif_bytes))
        )
        if res != 0:
            raise RuntimeError(f"avifDecoderSetIOMemory: {res}")
        res = lib.avifDecoderParse(C.c_void_p(dec))
        if res != 0:
            raise RuntimeError(f"avifDecoderParse: {res}")
        res = lib.avifDecoderNextImage(C.c_void_p(dec))
        if res != 0:
            raise RuntimeError(f"avifDecoderNextImage: {res}")

        # avifDecoder (libavif 0.11.x): image* sits at byte offset 48
        # (11 leading int fields + 4 pad). Guarded by a dimension check.
        slots = C.cast(C.c_void_p(dec), C.POINTER(C.c_void_p))
        img_ptr = slots[6]  # offset 48
        u_chk = C.cast(C.c_void_p(img_ptr), C.POINTER(C.c_uint32))
        if not (
            0 < u_chk[0] <= 65536 and 0 < u_chk[1] <= 65536
            and u_chk[2] in (8, 10, 12)
        ):
            raise RuntimeError("avifImage layout mismatch")
        yield lib, img_ptr
    finally:
        lib.avifDecoderDestroy(C.c_void_p(dec))


# avifPixelFormat -> (chroma shift x, chroma shift y); 400 has no chroma
_CHROMA_SHIFT = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: None}


def decode_to_yuv(avif_bytes: bytes, want_cicp: bool = False):
    """Decode AVIF → ([y, u, v] int32 planes, each at its own size: the
    chroma ones subsampled for 4:2:2 and 4:2:0, None for 4:0:0;
    bit_depth, range_flag) — plus (color_primaries, transfer,
    matrix_coefficients) when ``want_cicp`` (offsets located empirically
    against our own muxer's CICP round-trip; guarded by the dimension
    check in ``_decoded``).

    Raises RuntimeError on decode failure (conformance failure signal).
    """
    with _decoded(avif_bytes) as (_, img_ptr):
        # avifImage layout (libavif 0.11): width, height, depth (u32 x3),
        # yuvFormat, yuvRange, yuvChromaSamplePosition (enum=int x3),
        # yuvPlanes[3] (u8*), yuvRowBytes[3] (u32), imageOwnsYUVPlanes,
        # alphaPlane, ...
        u32 = C.cast(img_ptr, C.POINTER(C.c_uint32))
        width, height, depth = u32[0], u32[1], u32[2]
        if u32[3] not in _CHROMA_SHIFT:
            raise RuntimeError(f"avifImage yuvFormat {u32[3]}")
        shift = _CHROMA_SHIFT[u32[3]]
        yuv_range = u32[4]
        # offset of yuvPlanes: 6 x u32 = 24 bytes, padded to pointer align 8
        base = img_ptr + 24
        planes_ptr = C.cast(C.c_void_p(base), C.POINTER(C.c_void_p))
        rowbytes_ptr = C.cast(C.c_void_p(base + 3 * 8), C.POINTER(C.c_uint32))

        out = []
        bytes_pp = 2 if depth > 8 else 1
        dt = np.uint16 if depth > 8 else np.uint8
        for p in range(3):
            ptr = planes_ptr[p]
            rb = rowbytes_ptr[p]
            if not ptr or (p and shift is None):
                out.append(None)
                continue
            sx, sy = shift if p else (0, 0)
            pw, ph = (width + sx) >> sx, (height + sy) >> sy
            raw = C.cast(
                C.c_void_p(ptr), C.POINTER(C.c_uint8 * (rb * ph))
            )[0]
            arr = np.frombuffer(bytearray(raw), dtype=dt).reshape(
                ph, rb // bytes_pp
            )[:, :pw]
            out.append(arr.astype(np.int32))
        if want_cicp:
            u16 = C.cast(img_ptr, C.POINTER(C.c_uint16))
            cicp = (int(u16[52]), int(u16[53]), int(u16[54]))
            return out, int(depth), int(yuv_range), cicp
        return out, int(depth), int(yuv_range)


# avifRGBImage: width, height, depth, format, chromaUpsampling,
# chromaDownsampling, avoidLibYUV, ignoreAlpha, alphaPremultiplied,
# isFloat (u32 x10), [maxThreads (int), from libavif 1.0], pixels (u8*),
# rowBytes (u32): byte offsets of pixels and rowBytes by major version
_RGB_PIXELS_AT = {0: (40, 48), 1: (48, 56)}
_AVIF_RGB_FORMAT_RGB = 0


def decode_to_rgb8(avif_bytes: bytes) -> np.ndarray:
    """Decode AVIF → (h, w, 3) uint8 RGB, alpha dropped, through
    libavif's own ``avifImageYUVToRGB`` with ``avifRGBImage`` set up as
    Pillow's AVIF plugin sets it (its defaults for the image, then depth
    8, format RGB).

    Raises RuntimeError on decode or conversion failure, or a libavif
    whose struct layout is unknown; OSError where libavif is absent."""
    with _decoded(avif_bytes) as (lib, img_ptr):
        lib.avifVersion.restype = C.c_char_p
        major = int(lib.avifVersion().split(b".")[0])
        if major not in _RGB_PIXELS_AT:
            raise RuntimeError(f"libavif {lib.avifVersion().decode()}: "
                               "unknown avifRGBImage layout")
        at_pixels, at_rowbytes = _RGB_PIXELS_AT[major]
        lib.avifRGBImageSetDefaults.argtypes = [C.c_void_p, C.c_void_p]
        lib.avifRGBImageSetDefaults.restype = None
        lib.avifImageYUVToRGB.argtypes = [C.c_void_p, C.c_void_p]
        lib.avifImageYUVToRGB.restype = C.c_int
        rgb = (C.c_uint8 * 128)()  # larger than the struct in either layout
        lib.avifRGBImageSetDefaults(C.addressof(rgb), img_ptr)
        fields = np.frombuffer(rgb, dtype=np.uint32)
        img = C.cast(C.c_void_p(img_ptr), C.POINTER(C.c_uint32))
        width, height = int(fields[0]), int(fields[1])
        if (width, height) != (img[0], img[1]):
            raise RuntimeError("avifRGBImage layout mismatch")
        out = np.empty((height, width, 3), dtype=np.uint8)
        fields[2] = 8
        fields[3] = _AVIF_RGB_FORMAT_RGB
        C.c_void_p.from_buffer(rgb, at_pixels).value = out.ctypes.data
        fields[at_rowbytes // 4] = 3 * width
        res = lib.avifImageYUVToRGB(img_ptr, C.addressof(rgb))
        if res != 0:
            raise RuntimeError(f"avifImageYUVToRGB: {res}")
        return out
