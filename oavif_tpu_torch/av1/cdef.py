"""Normative CDEF (constrained directional enhancement filter), spec 7.15.

The decoder applies CDEF after deblocking; the encoder replicates it here
bit-exactly so its reconstruction still equals the decoder's output and the
TQ loop can keep scoring recon directly (no decode round-trip). Validated
against the independent dav1d decoder in tests/test_cdef.py, the same way
the deblocker was (reference behavior boundary: the reference gets CDEF
implicitly from libaom, SURVEY.md §2b N1).

Geometry: with 64x64 superblocks a CDEF unit == one superblock. We emit
cdef_bits = 0 (a single frame-wide strength set), so no per-unit index is
coded; a unit is filtered iff any block in it is non-skip, and an 8x8
filter block is filtered iff any of its four 4x4 cells is non-skip.

All filtering reads the pre-CDEF (deblocked) planes and writes to a copy —
CDEF is not applied in place.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# spec 7.15.3 Cdef_Directions: per direction, two (dy, dx) tap offsets
CDEF_DIRECTIONS = (
    ((-1, 1), (-2, 2)),
    ((0, 1), (-1, 2)),
    ((0, 1), (0, 2)),
    ((0, 1), (1, 2)),
    ((1, 1), (2, 2)),
    ((1, 0), (2, 1)),
    ((1, 0), (2, 0)),
    ((1, 0), (2, -1)),
)

# spec 7.15.3: primary taps by (strength & 1), secondary taps
CDEF_PRI_TAPS = ((4, 2), (3, 3))
CDEF_SEC_TAPS = (2, 1)

_DIV_TABLE = (840, 420, 280, 210, 168, 140, 120)

VAR_SHIFT = 10  # empirically pinned against dav1d (see tests/test_cdef.py)


def _find_dir(block: np.ndarray, bitdepth: int) -> Tuple[int, int]:
    """Direction search over one 8x8 luma block (spec 7.15.2).

    Returns (dir, var). Operates on 8-bit-normalised, 128-centred pixels.
    """
    px = (block >> (bitdepth - 8)).astype(np.int64) - 128
    partial_diag = [np.zeros(15, np.int64), np.zeros(15, np.int64)]
    partial_alt = [np.zeros(11, np.int64) for _ in range(4)]
    partial_hv = [np.zeros(8, np.int64), np.zeros(8, np.int64)]
    for y in range(8):
        for x in range(8):
            v = px[y, x]
            partial_diag[0][y + x] += v
            partial_alt[0][y + (x >> 1)] += v
            partial_hv[0][y] += v
            partial_alt[1][3 + y - (x >> 1)] += v
            partial_diag[1][7 + y - x] += v
            partial_alt[2][3 - (y >> 1) + x] += v
            partial_hv[1][x] += v
            partial_alt[3][(y >> 1) + x] += v
    cost = [0] * 8
    cost[2] = int(np.sum(partial_hv[0] * partial_hv[0])) * 105
    cost[6] = int(np.sum(partial_hv[1] * partial_hv[1])) * 105
    for n in range(7):
        d = _DIV_TABLE[n]
        cost[0] += int(partial_diag[0][n] ** 2 + partial_diag[0][14 - n] ** 2) * d
        cost[4] += int(partial_diag[1][n] ** 2 + partial_diag[1][14 - n] ** 2) * d
    cost[0] += int(partial_diag[0][7] ** 2) * 105
    cost[4] += int(partial_diag[1][7] ** 2) * 105
    for i in range(4):
        c = 0
        for m in range(5):
            c += int(partial_alt[i][3 + m] ** 2)
        c *= 105
        for m in range(3):
            d = _DIV_TABLE[2 * m + 1]
            c += int(partial_alt[i][m] ** 2 + partial_alt[i][10 - m] ** 2) * d
        cost[2 * i + 1] = c
    best = 0
    for d in range(8):
        if cost[d] > cost[best]:
            best = d
    var = (cost[best] - cost[best ^ 4]) >> VAR_SHIFT
    return best, var


def _constrain(diff: int, threshold: int, damping: int) -> int:
    if not threshold:
        return 0
    shift = max(0, damping - (threshold.bit_length() - 1))
    mag = abs(diff)
    v = min(mag, max(0, threshold - (mag >> shift)))
    return -v if diff < 0 else v


def _adjust_pri(strength: int, var: int) -> int:
    """Luma primary strength scales with the direction variance
    (spec 7.15.3: strength * (4 + min(12, FloorLog2(var >> 6))) + 8 >> 4,
    zero when the block has no variance)."""
    if not var:
        return 0
    i = min(12, (var >> 6).bit_length() - 1) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def _filter_block(
    src: np.ndarray,  # full pre-CDEF plane (padded), int
    dst: np.ndarray,
    y0: int,
    x0: int,
    pri: int,
    sec: int,
    damping: int,
    direction: int,
    bitdepth: int,
    avail_h: int,
    avail_w: int,
) -> None:
    """Filter one 8x8 block at (y0, x0) of `src` into `dst` (spec 7.15.3).

    Taps outside the padded plane contribute nothing to the sum and are
    excluded from the min/max clamp (CDEF_VERY_LARGE semantics)."""
    h, w = avail_h, avail_w
    coeff_shift = bitdepth - 8
    pri_taps = CDEF_PRI_TAPS[(pri >> coeff_shift) & 1]
    if damping < 1:
        damping = 1
    for yy in range(8):
        for xx in range(8):
            y, x = y0 + yy, x0 + xx
            px = int(src[y, x])
            s = 0
            mx = px
            mn = px
            for k in range(2):
                if pri:
                    dy, dx = CDEF_DIRECTIONS[direction][k]
                    for sgn in (1, -1):
                        py, pxx = y + sgn * dy, x + sgn * dx
                        if 0 <= py < h and 0 <= pxx < w:
                            p = int(src[py, pxx])
                            s += pri_taps[k] * _constrain(p - px, pri, damping)
                            mx = max(mx, p)
                            mn = min(mn, p)
                if sec:
                    for dd in ((direction + 2) & 7, (direction + 6) & 7):
                        dy, dx = CDEF_DIRECTIONS[dd][k]
                        for sgn in (1, -1):
                            py, pxx = y + sgn * dy, x + sgn * dx
                            if 0 <= py < h and 0 <= pxx < w:
                                p = int(src[py, pxx])
                                s += CDEF_SEC_TAPS[k] * _constrain(
                                    p - px, sec, damping
                                )
                                mx = max(mx, p)
                                mn = min(mn, p)
            v = px + ((8 + s - (1 if s < 0 else 0)) >> 4)
            dst[y, x] = min(max(v, mn), mx)


def cdef_frame(
    planes: List[np.ndarray],  # padded mi-grid planes, modified in place
    blocks: Sequence[Tuple[int, ...]],  # (mi_r, mi_c, size_px, skip)
    strengths: Tuple[int, int, int, int],  # y_pri, y_sec, uv_pri, uv_sec
    damping: int,
    bitdepth: int,
) -> None:
    """Apply CDEF to the (deblocked) padded recon planes in place."""
    y_pri, y_sec, uv_pri, uv_sec = strengths
    if not (y_pri or y_sec or uv_pri or uv_sec):
        return
    from .entropy.fast import cdef_frame_native

    if cdef_frame_native(planes, blocks, strengths, damping, bitdepth):
        return
    h, w = planes[0].shape
    mi_rows, mi_cols = h // 4, w // 4
    # taps read the full padded mi-grid plane (decoded padding blocks are
    # real pixels to CDEF; pinned against dav1d on non-multiple-of-8 sizes)
    avail_h, avail_w = h, w
    skip_map = np.ones((mi_rows, mi_cols), dtype=np.uint8)
    for b in blocks:
        r, c, size = b[0], b[1], b[2]
        sk = b[3] if len(b) > 3 else 0
        bw = size & 0xFFFF
        bh = (size >> 16) or bw
        skip_map[r : r + bh // 4, c : c + bw // 4] = sk

    coeff_shift = bitdepth - 8
    y_pri_s = y_pri << coeff_shift
    y_sec_s = y_sec << coeff_shift
    uv_pri_s = uv_pri << coeff_shift
    uv_sec_s = uv_sec << coeff_shift
    y_damp = damping + coeff_shift
    uv_damp = y_damp - 1

    srcs = [p.copy() for p in planes]
    for ur in range(0, mi_rows, 16):
        for uc in range(0, mi_cols, 16):
            unit = skip_map[ur : ur + 16, uc : uc + 16]
            if unit.all():
                continue  # all-skip unit: cdef_idx stays -1, no filtering
            for r in range(ur, min(ur + 16, mi_rows - 1), 2):
                for c in range(uc, min(uc + 16, mi_cols - 1), 2):
                    if skip_map[r : r + 2, c : c + 2].all():
                        continue
                    y0, x0 = r * 4, c * 4
                    if y_pri_s or uv_pri_s:
                        # direction search runs when some primary strength
                        # is nonzero
                        direction, var = _find_dir(
                            srcs[0][y0 : y0 + 8, x0 : x0 + 8], bitdepth
                        )
                    else:
                        direction, var = 0, 0
                    # each plane uses the searched direction only when its
                    # own primary strength is nonzero (sec-only filtering
                    # runs at dir 0 — pinned against dav1d)
                    dir_y = direction if y_pri_s else 0
                    dir_uv = direction if uv_pri_s else 0
                    pri_y = _adjust_pri(y_pri_s, var) if y_pri_s else 0
                    if pri_y or y_sec_s:
                        _filter_block(
                            srcs[0], planes[0], y0, x0, pri_y, y_sec_s,
                            y_damp, dir_y, bitdepth, avail_h, avail_w,
                        )
                    if len(planes) > 1 and (uv_pri_s or uv_sec_s):
                        for pi in (1, 2):
                            _filter_block(
                                srcs[pi], planes[pi], y0, x0, uv_pri_s,
                                uv_sec_s, uv_damp, dir_uv, bitdepth,
                                avail_h, avail_w,
                            )
