"""AV1 intra predictors (spec 7.11.2), 8/10-bit, edge filtering disabled.

The sequence header sets enable_intra_edge_filter = 0 and
enable_filter_intra = 0 (oavif_tpu.av1.obu), so the normative prediction
is the plain sample-based process below — no edge smoothing or upsampling
branches. Predictors must match the decoder bit-exactly because the
encoder's reconstruction (predictor + inverse-transformed residual) seeds
the next block's neighbors.

Host reference implementation in NumPy; the batched all-modes TPU
evaluation used by the RD search lives in oavif_tpu.av1.encode_tpu.
"""

from __future__ import annotations

import numpy as np

from .consts import (
    DC_PRED,
    H_PRED,
    MODE_TO_ANGLE,
    PAETH_PRED,
    SMOOTH_H_PRED,
    SMOOTH_PRED,
    SMOOTH_V_PRED,
    V_PRED,
)
from .tables import TABLES


def _sm_weights(n: int) -> np.ndarray:
    return TABLES[f"sm_weights_{n}"]


def build_edges(
    recon: np.ndarray,
    x: int,
    y: int,
    w: int,
    h: int,
    have_above: bool,
    have_left: bool,
    bitdepth: int = 8,
    num_top_right: int = 0,
    num_bottom_left: int = 0,
):
    """Neighbor arrays (spec 7.11.2 steps 1-3): AboveRow[-1..w+h-1],
    LeftCol[-1..w+h-1] with unavailability fills and edge replication."""
    base = 1 << (bitdepth - 1)
    above = np.empty(w + h + 1, dtype=np.int32)  # above[0] == AboveRow[-1]
    left = np.empty(w + h + 1, dtype=np.int32)

    if have_above:
        n_avail = w + min(num_top_right, h)
        src = recon[y - 1, x : x + n_avail]
        above[1 : 1 + n_avail] = src
        above[1 + n_avail :] = src[-1]
    elif have_left:
        above[1:] = recon[y, x - 1]
    else:
        above[1:] = base - 1

    if have_left:
        n_avail = h + min(num_bottom_left, w)
        src = recon[y : y + n_avail, x - 1]
        left[1 : 1 + n_avail] = src
        left[1 + n_avail :] = src[-1]
    elif have_above:
        left[1:] = recon[y - 1, x]
    else:
        left[1:] = base + 1

    if have_above and have_left:
        corner = recon[y - 1, x - 1]
    elif have_above:
        corner = recon[y - 1, x]
    elif have_left:
        corner = recon[y, x - 1]
    else:
        corner = base
    above[0] = corner
    left[0] = corner
    return above, left


def predict(
    mode: int,
    above: np.ndarray,
    left: np.ndarray,
    w: int,
    h: int,
    have_above: bool,
    have_left: bool,
    angle_delta: int = 0,
    bitdepth: int = 8,
) -> np.ndarray:
    """Predict a w×h block from neighbor arrays. Returns (h, w) int32.

    mode >= FILTER_BASE encodes a filter-intra block (mode - FILTER_BASE
    is the filter_intra_mode); syntax-wise those blocks are DC_PRED."""
    if mode >= FILTER_BASE:
        return predict_filter_intra(
            mode - FILTER_BASE, above, left, w, h, bitdepth
        )
    a = above[1 : 1 + w + h].astype(np.int64)
    l = left[1 : 1 + w + h].astype(np.int64)
    corner = int(above[0])

    if mode == DC_PRED:
        if have_above and have_left:
            s = a[:w].sum() + l[:h].sum()
            avg = (s + ((w + h) >> 1)) // (w + h)
        elif have_above:
            avg = (a[:w].sum() + (w >> 1)) >> int(np.log2(w))
        elif have_left:
            avg = (l[:h].sum() + (h >> 1)) >> int(np.log2(h))
        else:
            avg = 1 << (bitdepth - 1)  # spec dc_128 predictor
        return np.full((h, w), avg, dtype=np.int32)

    if mode == V_PRED:
        return np.tile(a[:w], (h, 1)).astype(np.int32)

    if mode == H_PRED:
        return np.tile(l[:h, None], (1, w)).astype(np.int32)

    if mode == PAETH_PRED:
        base = a[None, :w] + l[:h, None] - corner
        pa = np.abs(base - a[None, :w])
        pl = np.abs(base - l[:h, None])
        pc = np.abs(base - corner)
        out = np.where(
            (pa <= pl) & (pa <= pc),
            np.tile(a[:w], (h, 1)),
            np.where(pl <= pc, np.tile(l[:h, None], (1, w)), corner),
        )
        return out.astype(np.int32)

    if mode in (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED):
        wh = _sm_weights(h).astype(np.int64)
        ww = _sm_weights(w).astype(np.int64)
        below = l[h - 1]
        right = a[w - 1]
        if mode == SMOOTH_PRED:
            acc = (
                wh[:, None] * a[None, :w]
                + (256 - wh[:, None]) * below
                + ww[None, :] * l[:h, None]
                + (256 - ww[None, :]) * right
            )
            return ((acc + 256) >> 9).astype(np.int32)
        if mode == SMOOTH_V_PRED:
            acc = wh[:, None] * a[None, :w] + (256 - wh[:, None]) * below
            return ((acc + 128) >> 8).astype(np.int32)
        acc = ww[None, :] * l[:h, None] + (256 - ww[None, :]) * right
        return ((acc + 128) >> 8).astype(np.int32)

    if mode in MODE_TO_ANGLE:
        return _predict_directional(
            mode, a, l, corner, w, h, angle_delta
        )

    raise NotImplementedError(f"mode {mode}")


def _predict_directional(mode, a, l, corner, w, h, angle_delta):
    """Directional prediction (spec 7.11.2.4), intra edge filter disabled
    → upsample = 0, no edge smoothing."""
    dr = TABLES["dr_intra_derivative"]
    p_angle = MODE_TO_ANGLE[mode] + angle_delta * 3
    out = np.zeros((h, w), dtype=np.int32)

    # Build the -1-indexed edge arrays used by zone 2.
    above_m1 = np.concatenate([[corner], a])  # above_m1[i+1] = AboveRow[i]
    left_m1 = np.concatenate([[corner], l])

    if p_angle < 90:  # zone 1: above only
        dx = int(dr[p_angle])
        max_base_x = w + h - 1
        r = np.arange(h)[:, None]
        cc = np.arange(w)[None, :]
        x = (r + 1) * dx
        base = (x >> 6) + cc
        shift = (x >> 1) & 0x1F
        base_c = np.minimum(base, max_base_x)
        v = a[base_c] * (32 - shift) + a[np.minimum(base_c + 1, max_base_x)] * shift
        v = (v + 16) >> 5
        out = np.where(base > max_base_x, a[max_base_x], v)
        return out.astype(np.int32)

    if p_angle > 180:  # zone 3: left only
        dy = int(dr[270 - p_angle])
        max_base_y = w + h - 1
        r = np.arange(h)[:, None]
        cc = np.arange(w)[None, :]
        y = (cc + 1) * dy
        base = (y >> 6) + r
        shift = (y >> 1) & 0x1F
        base_c = np.minimum(base, max_base_y)
        v = l[base_c] * (32 - shift) + l[np.minimum(base_c + 1, max_base_y)] * shift
        v = (v + 16) >> 5
        out = np.where(base > max_base_y, l[max_base_y], v)
        return out.astype(np.int32)

    # zone 2: 90 < angle < 180, both edges
    dx = int(dr[180 - p_angle])
    dy = int(dr[p_angle - 90])
    for r in range(h):
        for c in range(w):
            x = (c << 6) - (r + 1) * dx
            base_x = x >> 6
            if base_x >= -1:
                shift = (x >> 1) & 0x1F
                v = above_m1[base_x + 1] * (32 - shift) + above_m1[base_x + 2] * shift
            else:
                y = (r << 6) - (c + 1) * dy
                base_y = y >> 6
                shift = (y >> 1) & 0x1F
                v = left_m1[base_y + 1] * (32 - shift) + left_m1[base_y + 2] * shift
            out[r, c] = (v + 16) >> 5
    return out


# ---- filter intra (spec 7.11.2.3 recursive intra prediction) ----------------
# 5 modes; the block is predicted in 4x2 patches in raster order, each
# patch's 8 outputs a 7-tap combination of the patch's above row (4 + the
# corner) and left column (2), where interior patches consume previously
# predicted pixels. Taps from av1_tables.npz (filter_intra_taps, every
# row sums to 16 = unit DC gain); rounding is signed round-half to
# match the reference decoder exactly.

FILTER_INTRA_MODES = 5
# internal y_mode encoding of a filter-intra block: FILTER_BASE + mode
# (real y modes are 0..12; the syntax codes DC_PRED + the filter fields)
FILTER_BASE = 16
# filter_intra_mode -> intra direction used by tx-type syntax
# (spec Filter_Intra_Mode_To_Intra_Dir): DC, V, H, D157, DC — note the
# PAETH-shaped filter maps back to DC for transform-set purposes
FILTER_TO_DIR = (0, 1, 2, 6, 0)


def predict_filter_intra(
    mode: int,
    above: np.ndarray,
    left: np.ndarray,
    w: int,
    h: int,
    bitdepth: int = 8,
) -> np.ndarray:
    """Recursive filter-intra prediction of a w×h block. Returns (h, w)."""
    taps = TABLES["filter_intra_taps"][mode][:, :7].astype(np.int64)  # (8,7)
    buf = np.zeros((h + 1, w + 1), dtype=np.int64)
    buf[0, 0] = int(above[0])  # corner
    buf[0, 1 : 1 + w] = above[1 : 1 + w]
    buf[1 : 1 + h, 0] = left[1 : 1 + h]
    hi = (1 << bitdepth) - 1
    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):
            p = np.array(
                [
                    buf[r - 1, c - 1],
                    buf[r - 1, c],
                    buf[r - 1, c + 1],
                    buf[r - 1, c + 2],
                    buf[r - 1, c + 3],
                    buf[r, c - 1],
                    buf[r + 1, c - 1],
                ],
                dtype=np.int64,
            )
            v = taps @ p  # the 8 patch outputs have no interdependency
            # Round2Signed at INTRA_FILTER_SCALE_BITS = 4
            v = np.where(v >= 0, (v + 8) >> 4, -((-v + 8) >> 4))
            buf[r : r + 2, c : c + 4] = np.clip(v, 0, hi).reshape(2, 4)
    return buf[1:, 1:].astype(np.int32)
