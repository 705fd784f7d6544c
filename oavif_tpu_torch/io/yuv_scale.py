"""libyuv's ScalePlane, as libavif 1.3 calls it to bring a decoded frame to
the size its ``ispe`` property states (avifImageScale, ``kFilterBox``).

libavif scales each Y'UV plane (and an alpha plane) on its own, 8-bit
planes through ``ScalePlane`` and deeper ones through ``ScalePlane_12``;
the chroma planes of subsampled formats go to ``(w + ss_x) >> ss_x`` by
``(h + ss_y) >> ss_y``. libyuv reduces the box filter to bilinear where
either side shrinks by at most half (to linear or to point sampling on
some sizes), and then picks (``route``):

- a copy where the size does not change;
- ``ScalePlaneVertical`` where only the height changes (8-bit row
  fractions, ``InterpolateRow``);
- ``ScalePlaneDown34`` where both sides go to 3/4: rows of four samples
  to three by (3, 1), (1, 1), (1, 3) weights, rounded, and each three
  output rows from four source rows (``_0_Box``, ``_1_Box``, ``_0_Box``
  upside down);
- ``ScalePlaneDown2``'s 2x2 box where both sides halve exactly;
- ``ScalePlaneDown38`` where the width goes to 3/8 and the height to
  ``(3h + 7) / 8``: boxes of 3x3, 2x3, 3x2 and 2x2 samples (``_3_Box``
  on two rows of three source rows, ``_2_Box`` on one of two), each sum
  times 65536 / area, shifted down 16;
- ``ScalePlaneDown4``'s 4x4 box, rounded, where both sides go to 1/4;
- ``ScalePlaneBox`` where the filter stays the box (both sides shrink by
  more than half) and no case above applies: each output sample the sum
  of the source box between 16.16 positions (``ScaleAddRow`` down the
  rows, ``ScaleAddCols`` along them) times 65536 / area, shifted down 16;
- ``ScalePlaneUp2_Linear`` (3, 1) / 4 where only the width doubles;
- ``ScalePlaneUp2_Bilinear`` (9, 3, 3, 1) / 16 where both sides double;
- ``ScalePlaneBilinearUp`` / ``ScalePlaneBilinearDown`` otherwise: 16.16
  fixed-point steps, rows blended with 8-bit fractions and columns with
  the x86 SIMD column filter's 7-bit fractions on 8-bit planes (what
  Pillow's libavif runs), with libyuv's C column filter's 16-bit
  fractions on deeper ones;
- ``ScalePlaneSimple``, point sampling, where the filter reduces to none
  (a width cut to exactly a third while the height stays, or a source
  one sample wide): sample ``(x0 + i * dx) >> 16`` from the centre
  ``dx / 2``.

On 8-bit planes the x86 build runs SSSE3 rows where libyuv has them, and
two of them round otherwise than its C rows: ``ScaleRowDown34_0_Box`` and
``_1_Box`` blend the two rows first (``pavgb`` once, or twice for 3:1)
and then along the row, and ``ScaleRowDown38_2_Box`` averages its two
rows by ``pavgb`` before the sums of three or two along the row. The
SSSE3 rows cover the output columns up to a multiple of 24 (3/4) or 6
(3/8); the C rows the rest (libyuv's ``_Any_`` wrappers). Deeper planes
run the C rows. Pillow's libyuv (libavif 1.3) and the system's (1857,
under libavif 0.11.1) give the same planes on every route; where a 3/8
height reaches past the last source row (``(3h + 7) / 8`` with ``h`` not
a multiple of 8), libyuv reads memory past the plane, and this module
reads the last row again.
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


def route(sw: int, sh: int, dw: int, dh: int) -> str:
    """The libyuv function ScalePlane (or ScalePlane_12) with kFilterBox
    runs to scale a sw x sh plane to dw x dh."""
    f = _reduce_filter(sw, sh, dw, dh)
    if (dw, dh) == (sw, sh):
        return "copy"
    if dw == sw and f != "box":
        return "vertical"
    if dw <= sw and dh <= sh:
        if 4 * dw == 3 * sw and 4 * dh == 3 * sh:
            return "down34"
        if 2 * dw == sw and 2 * dh == sh:
            return "down2"
        if 8 * dw == 3 * sw and dh == (sh * 3 + 7) // 8:
            return "down38"
        if 4 * dw == sw and 4 * dh == sh and f in ("box", "none"):
            return "down4"
    if f == "box" and dh * 2 < sh:
        return "box"
    if (dw + 1) // 2 == sw and f == "linear":
        return "up2_linear"
    if (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in ("bilinear",
                                                              "box"):
        return "up2_bilinear"
    if f == "none":
        return "simple"
    return "bilinear_up" if dh > sh else "bilinear_down"


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


def _avg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """pavgb: (a + b + 1) >> 1."""
    return (a + b + 1) >> 1


def _rows(s: np.ndarray, dh: int, pattern: tuple, taps: int,
          stride: int) -> list:
    """The source rows of libyuv's ScalePlaneDown34 (``pattern`` (1, 1, 2):
    the rows each output row of a group of three advances by; 2 taps) and
    ScalePlaneDown38 ((3, 3, 2); 3 taps, 2 on the third row of a group):
    for each place k in the group, the k-th output row of every group and
    of the one or two rows left over, as ``taps`` arrays of rows,
    ``stride`` rows apart (0 on the unfiltered last row left over). Rows
    past the plane (a 3/8 height rounded up) read its last row again."""
    sh = s.shape[0]
    groups, rem = divmod(dh, 3)
    step = sum(pattern)
    rows = []
    for k in range(3):
        first = sum(pattern[:k])
        n = 2 if k == 2 else taps
        idx = [first + step * np.arange(groups) + i * stride
               for i in range(n)]
        if k < rem:  # the row left over at this place
            last = step * groups + first
            st = 0 if k == rem - 1 else stride
            idx = [np.append(x, last + i * st) for i, x in enumerate(idx)]
        rows.append([s[np.minimum(x, sh - 1)] for x in idx])
    return rows


def _down34(s: np.ndarray, dw: int, dh: int, filtered: bool,
            simd: bool) -> np.ndarray:
    """ScalePlaneDown34 with its box rows: the C rows blend along each
    row and then the two rows, the SSSE3 rows (``simd``: output columns
    up to a multiple of 24) the two rows and then along the row; the
    third row of each group reads its two rows upwards."""
    n = dw - dw % 24 if simd else 0
    out = np.empty((dh, dw), dtype=np.int32)

    def h3(r, lo, hi):
        """Each row's groups of four samples (for output columns lo to
        hi) to three."""
        r = r[:, lo // 3 * 4:hi // 3 * 4]
        o = np.empty((r.shape[0], hi - lo), dtype=np.int32)
        o[:, 0::3] = (r[:, 0::4] * 3 + r[:, 1::4] + 2) >> 2
        o[:, 1::3] = (r[:, 1::4] + r[:, 2::4] + 1) >> 1
        o[:, 2::3] = (r[:, 2::4] + r[:, 3::4] * 3 + 2) >> 2
        return o

    for k, (a, b) in enumerate(_rows(s, dh, (1, 1, 2), 2, int(filtered))):
        if k == 2:  # ScaleRowDown34_0 on (row + 1, row)
            a, b = b, a
        dst = out[k::3]
        if n:
            v = _avg(a[:, :n // 3 * 4], b[:, :n // 3 * 4])
            dst[:, :n] = h3(v if k == 1 else _avg(a[:, :n // 3 * 4], v), 0,
                            n)
        if n < dw:
            x, y = h3(a, n, dw), h3(b, n, dw)
            dst[:, n:] = (x + y + 1) >> 1 if k == 1 else (x * 3 + y + 2) >> 2
    return out


def _down38(s: np.ndarray, dw: int, dh: int, filtered: bool,
            simd: bool) -> np.ndarray:
    """ScalePlaneDown38 with its box rows: ``_3_Box`` (three rows; C and
    SSSE3 alike) and ``_2_Box`` (two rows: the C row sums them, the SSSE3
    row, ``simd``, on output columns up to a multiple of 6, averages
    them by pavgb first); each sum of 3x3, 2x3, 3x2 or 2x2 samples times
    65536 / area, shifted down 16."""
    g = dw // 3
    n = (dw - dw % 6) // 3 if simd else 0
    out = np.empty((dh, g, 3), dtype=np.int32)

    def sums(r):
        """Each group of 8 samples' sums of 3, 3 and 2."""
        r = r.reshape(r.shape[0], g, 8)
        return [r[..., 0] + r[..., 1] + r[..., 2],
                r[..., 3] + r[..., 4] + r[..., 5], r[..., 6] + r[..., 7]]

    for k, taps in enumerate(_rows(s, dh, (3, 3, 2), 3, int(filtered))):
        dst = out[k::3]
        c = [sum(v) for v in zip(*(sums(r) for r in taps))]
        scales = (65536 // 9, 65536 // 9, 65536 // 6) if len(taps) == 3 \
            else (65536 // 6, 65536 // 6, 65536 // 4)
        for i in range(3):
            dst[..., i] = (c[i].astype(np.int64) * scales[i]) >> 16
        if len(taps) == 2 and n:
            av = sums(_avg(taps[0], taps[1]))
            for i, m in enumerate((65536 // 3, 65536 // 3, 65536 // 2)):
                dst[:, :n, i] = (av[i][:, :n].astype(np.int64) * m) >> 16
    return out.reshape(dh, 3 * g)


def _down4(s: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """ScalePlaneDown4 with ScaleRowDown4Box: (16 samples + 8) >> 4."""
    b = s[:4 * dh, :4 * dw].reshape(dh, 4, dw, 4)
    return ((b.sum(axis=(1, 3)) + 8) >> 4).astype(np.int32)


def _box(s: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """ScalePlaneBox: the boxes start at 0 and step by FixedDiv(sw, dw)
    and FixedDiv(sh, dh) (the last row box clamped to the plane), each
    sum (``ScaleAddRow`` down the rows, ``ScaleAddCols`` along them)
    times 65536 / area (its tables), shifted down 16. Both steps exceed
    2, so the boxes lie side by side from 0, each at least two samples
    on a side."""
    sh, sw = s.shape
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    xs = (dx * np.arange(dw + 1, dtype=np.int64)) >> 16
    ys = np.minimum(dy * np.arange(dh + 1, dtype=np.int64), sh << 16) >> 16
    if sw % dw == 0 and sh % dh == 0:  # boxes of one size
        total = s.reshape(dh, sh // dh, dw, sw // dw).sum(axis=(1, 3))
    else:
        rows = np.add.reduceat(s[:ys[-1], :xs[-1]], ys[:-1], axis=0)
        total = np.add.reduceat(rows, xs[:-1], axis=1)
    area = np.diff(ys)[:, None] * np.diff(xs)[None, :]
    return ((total * (65536 // area)) >> 16).astype(np.int32)


def _simple(s: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """ScalePlaneSimple: point sampling from CENTERSTART(d, 0)."""
    sh, sw = s.shape
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    xi = ((dx >> 1) + dx * np.arange(dw, dtype=np.int64)) >> 16
    yi = ((dy >> 1) + dy * np.arange(dh, dtype=np.int64)) >> 16
    return s[yi[:, None], xi[None, :]]


def scale_plane(src: np.ndarray, dw: int, dh: int, deep: bool) -> np.ndarray:
    """One plane at dw x dh as libyuv's ScalePlane (``deep``: more than 8
    bits, ScalePlane_12) with kFilterBox scales it; int32 out."""
    sh, sw = src.shape
    f = _reduce_filter(sw, sh, dw, dh)
    how = route(sw, sh, dw, dh)
    if how == "copy":
        return src.astype(np.int32)
    # the whole-plane routes in int32 (a box's sum times 65536 / area
    # stays below 2**28 at 12 bits), the row loops in int64
    s32 = src.astype(np.int32)
    if how == "down34":
        return _down34(s32, dw, dh, f != "linear", not deep)
    if how == "down38":
        return _down38(s32, dw, dh, f != "linear", not deep)
    if how == "down4":
        return _down4(s32, dw, dh)
    if how == "box":
        return _box(s32, dw, dh)
    if how == "simple":
        return _simple(s32, dw, dh)
    s = src.astype(np.int64)
    if how == "vertical":
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
    if how == "down2":
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                 + s[1::2, 1::2] + 2) >> 2).astype(np.int32)
    if how == "up2_linear":
        # ScalePlaneUp2_Linear: each row ScaleRowUp2_Linear's (3, 1) / 4
        rows = [(sh - 1) // 2]
        if dh > 1:
            dy = _fixed_div(sh - 1, dh - 1)
            rows = [((1 << 15) - 1 + j * dy) >> 16 for j in range(dh)]
        return _up2_linear(s[rows], dw)
    if how == "up2_bilinear":
        # ScalePlaneUp2_Bilinear: libavif's 4:2:0 chroma upsampling
        return _libyuv_upsample(s, dh, dw, (1, 1)).astype(np.int32)
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
    if how == "bilinear_up":  # two filtered rows, swapped
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
