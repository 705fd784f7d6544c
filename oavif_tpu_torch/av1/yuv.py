"""RGB ↔ YUV444 conversion.

The reference encodes YUV444 via avifImageRGBToYUV (io.zig:578) with the
CICP matrix coefficients defaulting to "unspecified" (2), which libavif
maps to BT.601. We mirror that with full-range BT.601. The RGB→YUV
direction is encoder freedom; YUV→RGB here mirrors the decode-side
conversion for in-loop scoring (the conformance tests compare recon in
YUV space against the oracle decoder's planes, which is exact).
"""

from __future__ import annotations

import numpy as np

KR, KB = 0.299, 0.114
KG = 1.0 - KR - KB


_FWD = np.array(
    [
        [KR, KG, KB],
        [-KR / (2 * (1 - KB)), -KG / (2 * (1 - KB)), 0.5],
        [0.5, -KG / (2 * (1 - KR)), -KB / (2 * (1 - KR))],
    ],
    dtype=np.float32,
).T
_INV = np.array(
    [
        [1.0, 0.0, 2 * (1 - KR)],
        [1.0, -2 * (1 - KB) * KB / KG, -2 * (1 - KR) * KR / KG],
        [1.0, 2 * (1 - KB), 0.0],
    ],
    dtype=np.float32,
).T


def rgb_to_yuv444(rgb: np.ndarray, bitdepth: int = 8):
    """(h, w, 3) uint8/uint16 full-range RGB → [y, u, v] int32 planes.
    Single fused pass in the C runtime when available; numpy fallback."""
    if rgb.dtype in (np.uint8, np.uint16):
        from .entropy.fast import rgb_to_yuv444_native

        out = rgb_to_yuv444_native(rgb, bitdepth, _FWD)
        if out is not None:
            return out
    maxv = (1 << bitdepth) - 1
    h, w = rgb.shape[:2]
    flat = rgb.reshape(-1, 3).astype(np.float32)
    yuv = flat @ _FWD
    yuv[:, 1:] += np.float32((maxv + 1) / 2)
    yuv = np.clip(np.floor(yuv + 0.5), 0, maxv).astype(np.int32)
    return [np.ascontiguousarray(yuv[:, i].reshape(h, w)) for i in range(3)]


def yuv444_to_rgb(planes, bitdepth: int = 8) -> np.ndarray:
    """[y, u, v] planes → (h, w, 3) uint8 full-range RGB (decode mirror).
    Single fused pass in the C runtime when available; numpy fallback."""
    if len(planes) == 3:
        from .entropy.fast import yuv444_to_rgb8_native

        out = yuv444_to_rgb8_native(planes, bitdepth, _INV)
        if out is not None:
            return out
    maxv = (1 << bitdepth) - 1
    h, w = planes[0].shape
    yuv = np.stack(
        [p.reshape(-1) for p in planes], axis=1
    ).astype(np.float32)
    yuv[:, 1:] -= np.float32((maxv + 1) / 2)
    out = yuv @ _INV
    out = np.clip(np.floor(out + 0.5), 0, maxv).reshape(h, w, 3)
    if bitdepth == 8:
        return out.astype(np.uint8)
    return (out.astype(np.uint16) >> (bitdepth - 8)).astype(np.uint8)
