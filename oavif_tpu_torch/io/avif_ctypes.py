"""ctypes bindings to the system libavif decoder — YUV-plane access.

Pillow's decoder only exposes RGB; for bit-exact conformance testing the
encoder's reconstruction must compare against the decoder's YUV planes
directly (the reference's recon==decode invariant, SURVEY.md §4a). System
libavif 0.11.1 (dav1d/aom) provides that via avifDecoder.image->yuvPlanes.
"""

from __future__ import annotations

import ctypes as C
from typing import List, Tuple

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = C.CDLL("libavif.so.15")
    return _lib


class _avifROData(C.Structure):
    _fields_ = [("data", C.POINTER(C.c_uint8)), ("size", C.c_size_t)]


def decode_to_yuv(avif_bytes: bytes, want_cicp: bool = False):
    """Decode AVIF → ([y, u, v] int32 planes (444), bit_depth, range_flag)
    — plus (color_primaries, transfer, matrix_coefficients) when
    ``want_cicp`` (offsets located empirically against our own muxer's
    CICP round-trip; guarded by the dimension check below).

    Raises RuntimeError on decode failure (conformance failure signal).
    """
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
        # avifImage layout (libavif 0.11): width, height, depth (u32 x3),
        # yuvFormat, yuvRange, yuvChromaSamplePosition (enum=int x3),
        # yuvPlanes[3] (u8*), yuvRowBytes[3] (u32), imageOwnsYUVPlanes,
        # alphaPlane, ...
        u32 = C.cast(img_ptr, C.POINTER(C.c_uint32))
        width, height, depth = u32[0], u32[1], u32[2]
        yuv_format, yuv_range = u32[3], u32[4]
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
            if not ptr:
                out.append(None)
                continue
            raw = C.cast(
                C.c_void_p(ptr), C.POINTER(C.c_uint8 * (rb * height))
            )[0]
            arr = np.frombuffer(bytearray(raw), dtype=dt).reshape(
                height, rb // bytes_pp
            )[:, :width]
            out.append(arr.astype(np.int32))
        if want_cicp:
            u16 = C.cast(img_ptr, C.POINTER(C.c_uint16))
            cicp = (int(u16[52]), int(u16[53]), int(u16[54]))
            return out, int(depth), int(yuv_range), cicp
        return out, int(depth), int(yuv_range)
    finally:
        lib.avifDecoderDestroy(C.c_void_p(dec))
