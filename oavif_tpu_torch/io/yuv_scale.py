"""libyuv's ScalePlane, as libavif 1.3 calls it to bring a decoded frame to
the size its ``ispe`` property states (avifImageScale, ``kFilterBox``).

libavif scales each Y'UV plane (and an alpha plane) on its own, 8-bit
planes through ``ScalePlane`` and deeper ones through ``ScalePlane_12``;
the chroma planes of subsampled formats go to ``(w + ss_x) >> ss_x`` by
``(h + ss_y) >> ss_y``. libyuv reduces the box filter to bilinear where
either side shrinks by at most half, and then picks:

- a copy where the size does not change;
- ``ScalePlaneVertical`` where only the height changes (8-bit row
  fractions, ``InterpolateRow``);
- ``ScalePlaneDown2``'s 2x2 box where both sides halve exactly;
- ``ScalePlaneUp2_Linear`` (3, 1) / 4 where only the width doubles;
- ``ScalePlaneUp2_Bilinear`` (9, 3, 3, 1) / 16 where both sides double;
- ``ScalePlaneBilinearUp`` / ``ScalePlaneBilinearDown`` otherwise: 16.16
  fixed-point steps, rows blended with 8-bit fractions and columns with
  the x86 SIMD column filter's 7-bit fractions on 8-bit planes (what
  Pillow's libavif runs), with libyuv's C column filter's 16-bit
  fractions on deeper ones.

The box filter proper (a frame more than twice as tall as its ``ispe``)
and libyuv's 3/4, 3/8 and 1/4 special cases are not reproduced: they
raise ``NotImplementedError``, which the reader turns into a refusal.
"""

from __future__ import annotations

import numpy as np

from .avif import _libyuv_upsample, _up2_linear


def _fixed_div(num: int, div: int) -> int:
    return (num << 16) // div


def _fixed_div1(num: int, div: int) -> int:
    return ((num << 16) - 0x00010001) // (div - 1)


def _center(dx: int) -> int:
    """libyuv's CENTERSTART(dx, -32768)."""
    return (dx >> 1) - 32768


def _reduce_filter(sw: int, sh: int, dw: int, dh: int) -> str:
    """ScaleFilterReduce of kFilterBox."""
    f = "box"
    if dw * 2 >= sw or dh * 2 >= sh:
        f = "bilinear"
    if f == "bilinear":
        if sh == 1 or dh == sh or dh * 3 == sh:
            f = "linear"
        if sw == 1:
            f = "none"
    if f == "linear" and (sw == 1 or dw == sw or dw * 3 == sw):
        f = "none"
    return f


def _interp_rows(a: np.ndarray, b: np.ndarray, yf: int) -> np.ndarray:
    """InterpolateRow: row a blended with the row below it by yf / 256."""
    if yf == 0:
        return a.copy()
    if yf == 128:
        return (a + b + 1) >> 1
    return (a * (256 - yf) + b * yf + 128) >> 8


def _filter_cols(row: np.ndarray, dw: int, x: int, dx: int,
                 deep: bool) -> np.ndarray:
    """ScaleFilterCols at 16.16 positions x + i * dx: 7-bit fractions for
    8-bit samples (the SSSE3 version), 16-bit ones for deeper samples (the
    C version, ScaleFilterCols_16_C)."""
    xs = x + dx * np.arange(dw, dtype=np.int64)
    xi = xs >> 16
    a = row[xi]
    b = row[np.minimum(xi + 1, row.shape[0] - 1)]
    if not deep:
        f = (xs >> 9) & 0x7F
        return (a * (128 - f) + b * f + 64) >> 7
    return a + (((xs & 0xFFFF) * (b - a) + 0x8000) >> 16)


def scale_plane(src: np.ndarray, dw: int, dh: int, deep: bool) -> np.ndarray:
    """One plane at dw x dh as libyuv's ScalePlane (``deep``: more than 8
    bits, ScalePlane_12) with kFilterBox scales it; int32 out."""
    sh, sw = src.shape
    s = src.astype(np.int64)
    f = _reduce_filter(sw, sh, dw, dh)
    if (dw, dh) == (sw, sh):
        return src.astype(np.int32)
    if dw == sw and f != "box":
        y = dy = 0
        if dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _center(dy)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
        out = np.empty((dh, dw), dtype=np.int64)
        for j in range(dh):
            y = min(y, max_y)
            yi = y >> 16
            out[j] = _interp_rows(s[yi], s[min(yi + 1, sh - 1)],
                                  (y >> 8) & 255 if f != "none" else 0)
            y += dy
        return out.astype(np.int32)
    if dw <= sw and dh <= sh:
        if 4 * dw == 3 * sw and 4 * dh == 3 * sh:
            raise NotImplementedError("libyuv's 3/4 downscale")
        if 2 * dw == sw and 2 * dh == sh:
            return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                     + s[1::2, 1::2] + 2) >> 2).astype(np.int32)
        if 8 * dw == 3 * sw and dh == (sh * 3 + 7) // 8:
            raise NotImplementedError("libyuv's 3/8 downscale")
        if 4 * dw == sw and 4 * dh == sh and f == "box":
            raise NotImplementedError("libyuv's 1/4 downscale")
    if f == "box" and dh * 2 < sh:
        raise NotImplementedError("libyuv's box downscale (a frame more "
                                  "than twice as tall as its ispe)")
    if (dw + 1) // 2 == sw and f == "linear":
        # ScalePlaneUp2_Linear: each row ScaleRowUp2_Linear's (3, 1) / 4
        rows = [(sh - 1) // 2]
        if dh > 1:
            dy = _fixed_div(sh - 1, dh - 1)
            rows = [((1 << 15) - 1 + j * dy) >> 16 for j in range(dh)]
        return _up2_linear(s[rows], dw)
    if (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in ("bilinear",
                                                              "box"):
        # ScalePlaneUp2_Bilinear: libavif's 4:2:0 chroma upsampling
        return _libyuv_upsample(s, dh, dw, (1, 1)).astype(np.int32)
    if f == "none":
        raise NotImplementedError("libyuv's point sampling")
    # ScaleSlope of kFilterBilinear (kFilterLinear steps y by whole rows)
    x = y = dx = dy = 0
    if dw <= sw:
        dx = _fixed_div(sw, dw)
        x = _center(dx)
    elif sw > 1 and dw > 1:
        dx = _fixed_div1(sw, dw)
    if f == "linear":
        dy = _fixed_div(sh, dh)
        y = dy >> 1
    elif dh <= sh:
        dy = _fixed_div(sh, dh)
        y = _center(dy)
    elif sh > 1 and dh > 1:
        dy = _fixed_div1(sh, dh)
    max_y = (sh - 1) << 16
    out = np.empty((dh, dw), dtype=np.int64)
    cols = lambda r: _filter_cols(r, dw, x, dx, deep)  # noqa: E731
    if dh > sh:  # ScalePlaneBilinearUp: two filtered rows, swapped
        y = min(y, max_y)
        srow = lasty = y >> 16
        rows = [cols(s[srow])]
        if sh > 1:
            srow += 1
        rows.append(cols(s[srow]))
        if sh > 2:
            srow += 1
        cur = 0
        for j in range(dh):
            yi = y >> 16
            if yi != lasty:
                if y > max_y:
                    y = max_y
                    yi = srow = y >> 16
                if yi != lasty:
                    rows[cur] = cols(s[srow])
                    cur ^= 1
                    lasty = yi
                    if y + 65536 < max_y:
                        srow += 1
            out[j] = rows[cur] if f == "linear" else \
                _interp_rows(rows[cur], rows[cur ^ 1], (y >> 8) & 255)
            y += dy
        return out.astype(np.int32)
    y = min(y, max_y)  # ScalePlaneBilinearDown
    for j in range(dh):
        yi = y >> 16
        if f == "linear":
            out[j] = cols(s[yi])
        else:
            out[j] = cols(_interp_rows(s[yi], s[min(yi + 1, sh - 1)],
                                       (y >> 8) & 255))
        y = min(y + dy, max_y)
    return out.astype(np.int32)
