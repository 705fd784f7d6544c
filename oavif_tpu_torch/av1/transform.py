"""AV1 integer transforms.

Inverse transforms are normative (spec 7.13): the decoder applies them to
dequantized coefficients, so the encoder's reconstruction must match them
bit-exactly — validated structurally against the float DCT-III here
(tests/test_transform.py) and end-to-end against the independent dav1d
decoder (tests/test_conformance.py).

The inverse DCT is implemented as the generic butterfly cascade the spec
uses for every size 4..64: an even half that recurses, and an odd half
(a DCT-IV network) built from one initial rotation stage followed by
alternating add/sub and rotation levels with a systematic angle schedule.
All rotations are Round2(a*cos128 ± b*sin128, 12) on integers.

Forward transforms are encoder freedom: any map producing good
coefficients is valid since recon always runs the normative inverse. We
derive the forward matrices numerically from the integer inverse (probe
unit vectors → linear map → scaled inverse), guaranteeing round trips land
near identity in the exact scale convention the decoder expects. The
forward path is pure matmuls — it runs batched on the TPU MXU
(oavif_tpu.av1.encode).
"""

from __future__ import annotations

import functools

import numpy as np

COS_BIT = 12


@functools.lru_cache(maxsize=None)
def cospi_table():
    i = np.arange(65)
    return np.round((1 << COS_BIT) * np.cos(i * np.pi / 128)).astype(np.int64)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def _hb(w0, x0, w1, x1):
    """half_btf: Round2(w0*x0 + w1*x1, 12) — integer butterfly rotation."""
    return _round2(w0 * x0 + w1 * x1, COS_BIT)


def brev(nbits: int, x: int) -> int:
    out = 0
    for i in range(nbits):
        out |= ((x >> i) & 1) << (nbits - 1 - i)
    return out


def _idct_odd(o, N):
    """Odd half (DCT-IV network) of the size-N inverse DCT.

    ``o`` is a list of h = N/2 arrays: o[j] = coefficient x[2j+1].
    Returns list of h arrays.
    """
    c = cospi_table()
    h = N // 2
    m = h.bit_length() - 1  # log2 h

    # Stage A: initial rotations, pairs (i, h-1-i), angle k*(64/N) with
    # k = 2*brev(m, i) + 1.
    s = [None] * h
    for i in range(h // 2):
        k = 2 * brev(m, i) + 1
        theta = k * (64 // N) * 2  # == k * (128 / N) ... careful below
        theta = k * (64 * 2 // N)  # k * 128/N: for N=16, k=1 → 8?? see note
        # Angle unit: cospi index = k * 64 / N ... for N=16, k=1 the known
        # angle is 4 (c60/c4). 64/N = 4. Use that.
        theta = k * (64 // N)
        a, b = o[(k - 1) // 2], o[(N - k - 1) // 2]
        s[i] = _hb(c[64 - theta], a, -c[theta], b)
        s[h - 1 - i] = _hb(c[theta], a, c[64 - theta], b)

    # Levels 1..m-1: add/sub stage then rotation stage.
    for L in range(1, m):
        g = 1 << L  # add/sub group size is 2^L ... pairs within group
        # --- add/sub: groups of size 2^L? No: groups of 2^L pairs → size
        # 2^L. Level 1 pairs adjacent (group 2), level 2 groups of 4, etc.
        gs = 1 << L
        t = list(s)
        for q in range(h // gs):
            base = q * gs
            for j in range(gs // 2):
                x, y = s[base + j], s[base + gs - 1 - j]
                if q % 2 == 0:
                    t[base + j] = x + y
                    t[base + gs - 1 - j] = x - y
                else:
                    t[base + j] = -x + y
                    t[base + gs - 1 - j] = x + y
        s = t
        # --- rotations: pairs (i, h-1-i) for i in the middle half of each
        # group of size 2^(L+1) (lower array half only).
        gr = 1 << (L + 1)
        t = list(s)
        unit = 64 >> (m - L)
        for i in range(h // 2):
            pos_in_group = i % gr
            if not (gr // 4 <= pos_in_group < 3 * gr // 4):
                continue
            q = i // gr
            theta = (2 * brev(max(m - L - 1, 0), q) + 1) * unit
            x, y = s[i], s[h - 1 - i]
            if pos_in_group < gr // 2:  # type +
                t[i] = _hb(-c[theta], x, c[64 - theta], y)
                t[h - 1 - i] = _hb(c[64 - theta], x, c[theta], y)
            else:  # type -
                t[i] = _hb(-c[64 - theta], x, -c[theta], y)
                t[h - 1 - i] = _hb(-c[theta], x, c[64 - theta], y)
        s = t
    return s


def idct_1d(x, N):
    """Size-N inverse DCT on natural-order coefficients.

    ``x`` is a list of N numpy arrays (vectorized over trailing dims).
    """
    c = cospi_table()
    if N == 2:
        s0 = _hb(c[32], x[0], c[32], x[1])
        s1 = _hb(c[32], x[0], -c[32], x[1])
        return [s0, s1]
    if N == 4:
        s0 = _hb(c[32], x[0], c[32], x[2])
        s1 = _hb(c[32], x[0], -c[32], x[2])
        s2 = _hb(c[48], x[1], -c[16], x[3])
        s3 = _hb(c[16], x[1], c[48], x[3])
        return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]
    h = N // 2
    even = idct_1d([x[2 * i] for i in range(h)], h)
    odd = _idct_odd([x[2 * i + 1] for i in range(h)], N)
    out = [even[i] + odd[h - 1 - i] for i in range(h)]
    out += [even[h - 1 - i] - odd[i] for i in range(h)]
    return out


def iidentity_1d(x, N):
    """Identity transform scaling (spec 7.13.3: ×sqrt2 per odd log size)."""
    SQRT2 = 5793  # round(2^12 * sqrt(2))
    if N == 4:
        return [_round2(v * SQRT2, 12) for v in x]
    if N == 8:
        return [v * 2 for v in x]
    if N == 16:
        return [_round2(v * 2 * SQRT2, 12) for v in x]
    if N == 32:
        return [v * 4 for v in x]
    raise ValueError(N)


# ---------------------------------------------------------------------------
# 2D inverse transform (spec 7.13.3): rows then columns with shifts.
# ---------------------------------------------------------------------------

INV_SQRT2 = 2896  # round(2^12 / sqrt(2))

# Right-shift after the row (first) inverse pass, per max dimension
# (libaom inverse shift schedule; the column pass always shifts 4).
INV_ROW_SHIFT = {4: 0, 8: 1, 16: 2, 32: 2, 64: 2}


def inv_row_shift(w: int, h: int) -> int:
    """Row-pass right shift of the normative inverse transform.

    Squares use INV_ROW_SHIFT[dim]; 2:1 rectangles shift ONE LESS than
    their max dimension's square (dav1d per-size shift table, verified
    by disassembly of the 32x16 template wrapper: shift=1 where 32x32
    uses 2, paired with the 1/sqrt2 input pre-scale). Validated
    bit-exact against the dav1d oracle over single-coefficient and
    dense 32x16 probes (tools/probe_rect_inverse.py)."""
    if w == h:
        return INV_ROW_SHIFT[w]
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if abs(log2w - log2h) == 1:
        return INV_ROW_SHIFT[max(w, h)] - 1
    # 4:1 rects (dav1d wrapper shifts): 4x16/16x4 -> 1, 8x32/32x8 -> 2,
    # 16x64/64x16 -> 2
    return {16: 1, 32: 2, 64: 2}[max(w, h)]


def inv_txfm2d(coeffs: np.ndarray, bitdepth: int = 8, tx_type: str = "dct_dct") -> np.ndarray:
    """Normative 2D inverse transform → residual (int array, h×w).

    ``coeffs`` is the dequantized coefficient array (h, w) in natural
    order, where h/w may be 64 with only the upper-left 32×32 nonzero.
    Dispatches to the native implementation when available (byte-identical;
    tests/test_transform.py cross-checks).
    """
    h, w = coeffs.shape
    if tx_type == "dct_dct":
        from .entropy.fast import inv_txfm2d_native

        out = inv_txfm2d_native(coeffs, bitdepth)
        if out is not None:
            return out
    assert tx_type == "dct_dct" or (h <= 16 and w <= 16), tx_type
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    t = coeffs.astype(np.int64)

    # 64-point transforms only keep 32 coefficients per axis (zeroed here
    # by the caller's layout; enforce).
    if w == 64:
        t[:, 32:] = 0
    if h == 64:
        t[32:, :] = 0

    rect_odd = abs(log2w - log2h) % 2 == 1
    if rect_odd:
        t = _round2(t * INV_SQRT2, 12)

    row_shift = inv_row_shift(w, h)
    col_shift = 4

    row_clamp = (1 << (bitdepth + 8 - 1)) - 1  # intermediate 16-bit for 8b

    # Row transforms (length w) on each row.
    cols_in = [t[:, i] for i in range(w)]
    rows_out = _apply_1d(cols_in, w, tx_type, horizontal=True)
    t = np.stack(rows_out, axis=1)
    t = _round2(t, row_shift) if row_shift else t
    t = np.clip(t, -row_clamp - 1, row_clamp)

    # Column transforms (length h).
    rows_in = [t[i, :] for i in range(h)]
    cols_out = _apply_1d(rows_in, h, tx_type, horizontal=False)
    t = np.stack(cols_out, axis=0)
    t = _round2(t, col_shift)
    return t


_IADST = {}


def _apply_1d(elems, N, tx_type, horizontal):
    # tx_type "X_Y": X = vertical (column) 1D transform, Y = horizontal (row)
    if "_" in tx_type:
        col_kind, row_kind = tx_type.split("_")
    else:
        col_kind = row_kind = tx_type
    kind = row_kind if horizontal else col_kind
    if kind == "dct":
        return idct_1d(elems, N)
    if kind == "adst":
        fn = {4: iadst4_1d, 8: iadst8_1d, 16: iadst16_1d}[N]
        return fn(elems)
    if kind == "idtx":
        return iidentity_1d(elems, N)
    raise NotImplementedError(tx_type)


# ---------------------------------------------------------------------------
# Forward transform: numerically derived from the integer inverse.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inv_matrix_1d(N: int, kind: str = "dct") -> np.ndarray:
    """Linearization of the integer inverse transform (N×N float)."""
    if kind == "dct":
        fn = lambda x: idct_1d(x, N)
    elif kind == "idtx":
        fn = lambda x: iidentity_1d(x, N)
    else:
        fn = {4: iadst4_1d, 8: iadst8_1d, 16: iadst16_1d}[N]
    cols = []
    scale = 512  # probe amplitude well inside range, averages rounding
    for k in range(N):
        x = [np.zeros(1, np.int64) for _ in range(N)]
        x[k] = np.full(1, scale, np.int64)
        xm = [
            np.full(1, -scale, np.int64) if i == k else np.zeros(1, np.int64)
            for i in range(N)
        ]
        up = np.array([v[0] for v in fn(x)], dtype=np.float64)
        dn = np.array([v[0] for v in fn(xm)], dtype=np.float64)
        cols.append((up - dn) / (2 * scale))
    return np.stack(cols, axis=1)  # out = M @ coeffs


@functools.lru_cache(maxsize=None)
def fwd_matrices(w: int, h: int, tx_type: str = "dct_dct"):
    """Forward 2D transform matrices (Fh, Fw) such that
    coeffs ≈ Fh @ residual @ Fw.T lands where the normative inverse
    reproduces the residual: residual ≈ inv(coeffs)."""
    if "_" in tx_type:
        col_kind, row_kind = tx_type.split("_")
    else:
        col_kind = row_kind = tx_type
    mw = _inv_matrix_1d(w, row_kind)
    mh = _inv_matrix_1d(h, col_kind)
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    row_shift = inv_row_shift(w, h)
    # inverse: res = round2(Mh @ (round2(Mw @ C^T, row_shift))^T, 4)
    #        = Mh @ C @ Mw^T / 2^(row_shift+4)    (as floats)
    # plus the rect sqrt2 pre-scale.
    pre = (INV_SQRT2 / 4096.0) if abs(log2w - log2h) % 2 == 1 else 1.0
    total = pre / (1 << (row_shift + 4))
    fh = np.linalg.inv(mh)
    fw = np.linalg.inv(mw)
    # res = total * Mh C Mw^T → C = (1/total) Mh^-1 res Mw^-T
    return fh / np.sqrt(total), fw / np.sqrt(total)


def fwd_txfm2d(residual: np.ndarray, tx_type: str = "dct_dct") -> np.ndarray:
    """Float forward transform matched to the normative inverse. The 64-pt
    high-frequency region is zeroed like the bitstream requires."""
    h, w = residual.shape
    fh, fw = fwd_matrices(w, h, tx_type)
    c = fh @ residual.astype(np.float64) @ fw.T
    if w == 64:
        c[:, 32:] = 0
    if h == 64:
        c[32:, :] = 0
    return c


# ---------------------------------------------------------------------------
# Integer fixed-point forward transform — the production path.
#
# Two-stage int16xint16->int32 matrix product (Q12 matrices, a per-matrix
# stage-1 shift chosen so nothing can overflow), exactly mirrored by the C
# encoder's VNNI kernels: integer arithmetic is order-independent, so C and
# NumPy are bit-identical with no float-ordering rules. The forward
# transform is encoder freedom (only the inverse is normative), so the
# ~1e-3-relative rounding vs the float64 matrices just realizes a slightly
# different quantizer.
# ---------------------------------------------------------------------------

_FWD_INT_SCALE_BITS = 12


@functools.lru_cache(maxsize=None)
def fwd_matrices_int16(w: int, h: int, tx_type: str = "dct_dct",
                       bitdepth: int = 8):
    """Q12 int16 forward matrices + the stage-1 shift SA.

    Stage 1: acc1 = fh16 @ resid        (int32, provably no overflow)
             tmp16 = (acc1 + 2^(SA-1)) >> SA   (fits int16)
    Stage 2: out32 = tmp16 @ fw16.T     (int32, provably no overflow)
    Coefficient scale: out32 = real * 2^(2*SCALE_BITS - SA)."""
    fh, fw = fwd_matrices(w, h, tx_type)
    s = float(1 << _FWD_INT_SCALE_BITS)
    fh16 = np.floor(fh * s + 0.5).astype(np.int64)
    fw16 = np.floor(fw * s + 0.5).astype(np.int64)
    assert np.abs(fh16).max() < 32768 and np.abs(fw16).max() < 32768
    maxr = (1 << bitdepth) - 1
    l1_fh = int(np.abs(fh16).sum(axis=1).max())
    l1_fw = int(np.abs(fw16).sum(axis=1).max())
    acc1 = l1_fh * maxr
    assert acc1 < 2**31, "stage-1 overflow"
    sa = 0
    while True:
        t = (acc1 + (1 << sa >> 1)) >> sa
        if t <= 32767 and l1_fw * t < 2**31:
            break
        sa += 1
    return (fh16.astype(np.int16), fw16.astype(np.int16), sa)


def fwd_txfm2d_int(residual: np.ndarray, tx_type: str = "dct_dct",
                   bitdepth: int = 8) -> np.ndarray:
    """Integer forward transform; returns float64 coefficients at the real
    scale (exact: int32 values times an exact power-of-two factor)."""
    h, w = residual.shape
    fh16, fw16, sa = fwd_matrices_int16(w, h, tx_type, bitdepth)
    r32 = residual.astype(np.int32)
    acc1 = fh16.astype(np.int32) @ r32
    tmp16 = (acc1 + (1 << sa >> 1)) >> sa if sa else acc1
    out32 = tmp16.astype(np.int32) @ fw16.astype(np.int32).T
    c = out32.astype(np.float64) * (1.0 / (1 << (2 * _FWD_INT_SCALE_BITS - sa)))
    if w == 64:
        c[:, 32:] = 0
    if h == 64:
        c[32:, :] = 0
    return c


# ---------------------------------------------------------------------------
# Lossless 4x4 Walsh-Hadamard pair (spec 7.13.3 inverse WHT; the forward is
# its exact integer inverse — round-trip verified in tests/test_transform.py).
# ---------------------------------------------------------------------------


def inv_wht4x4(coeffs: np.ndarray) -> np.ndarray:
    """Normative lossless inverse WHT: input (4,4) int, output residual."""
    t = coeffs.astype(np.int64).copy()
    # rows (with the input >>2 on the first pass)
    for r in range(4):
        a, c, d, b = t[r, 0] >> 2, t[r, 1] >> 2, t[r, 2] >> 2, t[r, 3] >> 2
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        t[r] = [a, b, c, d]
    for cidx in range(4):
        a, c, d, b = t[0, cidx], t[1, cidx], t[2, cidx], t[3, cidx]
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        t[:, cidx] = [a, b, c, d]
    return t


def fwd_wht4x4(resid: np.ndarray) -> np.ndarray:
    """Forward WHT (libaom av1_fwht4x4 structure): produces coefficients
    whose normative inverse reproduces the residual exactly (x4 gain
    matching the >>2 on the inverse input)."""
    t = resid.astype(np.int64).copy()
    for cidx in range(4):
        a, b, c, d = t[0, cidx], t[1, cidx], t[2, cidx], t[3, cidx]
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        t[:, cidx] = [a, c, d, b]
    for r in range(4):
        a, b, c, d = t[r, 0], t[r, 1], t[r, 2], t[r, 3]
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        t[r] = [a, c, d, b]
    return t * 4


# ---------------------------------------------------------------------------
# Inverse ADST (spec 7.13.2.6 / libaom av1_iadst*_c structure). Validated
# end-to-end against the independent decoder (tests/test_conformance.py):
# recon through these must equal dav1d's output bit-exactly.
# ---------------------------------------------------------------------------


def iadst4_1d(x):
    sinpi = [0, 1321, 2482, 3344, 3803]
    x0, x1, x2, x3 = x
    s0 = sinpi[1] * x0
    s1 = sinpi[2] * x0
    s2 = sinpi[3] * x1
    s3 = sinpi[4] * x2
    s4 = sinpi[1] * x2
    s5 = sinpi[2] * x3
    s6 = sinpi[4] * x3
    a7 = x0 - x2
    b7 = a7 + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sinpi[3] * b7
    s0 = s0 + s5
    s1 = s1 - s6
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = s0 + s1 - s3
    return [_round2(v, 12) for v in (o0, o1, o2, o3)]


def iadst8_1d(xin):
    c = cospi_table()

    # stage 1: reorder
    x = [xin[7], xin[0], xin[5], xin[2], xin[3], xin[4], xin[1], xin[6]]
    # stage 2
    s = [
        _hb(c[4], x[0], c[60], x[1]),
        _hb(c[60], x[0], -c[4], x[1]),
        _hb(c[20], x[2], c[44], x[3]),
        _hb(c[44], x[2], -c[20], x[3]),
        _hb(c[36], x[4], c[28], x[5]),
        _hb(c[28], x[4], -c[36], x[5]),
        _hb(c[52], x[6], c[12], x[7]),
        _hb(c[12], x[6], -c[52], x[7]),
    ]
    # stage 3
    x = [s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
         s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7]]
    # stage 4
    s = [x[0], x[1], x[2], x[3],
         _hb(c[16], x[4], c[48], x[5]),
         _hb(c[48], x[4], -c[16], x[5]),
         _hb(-c[48], x[6], c[16], x[7]),
         _hb(c[16], x[6], c[48], x[7])]
    # stage 5
    x = [s[0] + s[2], s[1] + s[3], s[0] - s[2], s[1] - s[3],
         s[4] + s[6], s[5] + s[7], s[4] - s[6], s[5] - s[7]]
    # stage 6
    s = [x[0], x[1],
         _hb(c[32], x[2], c[32], x[3]),
         _hb(c[32], x[2], -c[32], x[3]),
         x[4], x[5],
         _hb(c[32], x[6], c[32], x[7]),
         _hb(c[32], x[6], -c[32], x[7])]
    # stage 7: alternate negation
    return [s[0], -s[4], s[6], -s[2], s[3], -s[7], s[5], -s[1]]


def iadst16_1d(xin):
    c = cospi_table()

    # stage 1: reorder
    x = [xin[15], xin[0], xin[13], xin[2], xin[11], xin[4], xin[9], xin[6],
         xin[7], xin[8], xin[5], xin[10], xin[3], xin[12], xin[1], xin[14]]
    # stage 2
    s = [
        _hb(c[2], x[0], c[62], x[1]),
        _hb(c[62], x[0], -c[2], x[1]),
        _hb(c[10], x[2], c[54], x[3]),
        _hb(c[54], x[2], -c[10], x[3]),
        _hb(c[18], x[4], c[46], x[5]),
        _hb(c[46], x[4], -c[18], x[5]),
        _hb(c[26], x[6], c[38], x[7]),
        _hb(c[38], x[6], -c[26], x[7]),
        _hb(c[34], x[8], c[30], x[9]),
        _hb(c[30], x[8], -c[34], x[9]),
        _hb(c[42], x[10], c[22], x[11]),
        _hb(c[22], x[10], -c[42], x[11]),
        _hb(c[50], x[12], c[14], x[13]),
        _hb(c[14], x[12], -c[50], x[13]),
        _hb(c[58], x[14], c[6], x[15]),
        _hb(c[6], x[14], -c[58], x[15]),
    ]
    # stage 3
    x = [s[i] + s[i + 8] for i in range(8)] + \
        [s[i] - s[i + 8] for i in range(8)]
    # stage 4
    s = x[:8] + [
        _hb(c[8], x[8], c[56], x[9]),
        _hb(c[56], x[8], -c[8], x[9]),
        _hb(c[40], x[10], c[24], x[11]),
        _hb(c[24], x[10], -c[40], x[11]),
        _hb(-c[56], x[12], c[8], x[13]),
        _hb(c[8], x[12], c[56], x[13]),
        _hb(-c[24], x[14], c[40], x[15]),
        _hb(c[40], x[14], c[24], x[15]),
    ]
    # stage 5
    x = [s[i] + s[i + 4] for i in range(4)] + \
        [s[i] - s[i + 4] for i in range(4)] + \
        [s[i] + s[i + 4] for i in range(8, 12)] + \
        [s[i] - s[i + 4] for i in range(8, 12)]
    # stage 6
    s = x[:4] + [
        _hb(c[16], x[4], c[48], x[5]),
        _hb(c[48], x[4], -c[16], x[5]),
        _hb(-c[48], x[6], c[16], x[7]),
        _hb(c[16], x[6], c[48], x[7]),
    ] + x[8:12] + [
        _hb(c[16], x[12], c[48], x[13]),
        _hb(c[48], x[12], -c[16], x[13]),
        _hb(-c[48], x[14], c[16], x[15]),
        _hb(c[16], x[14], c[48], x[15]),
    ]
    # stage 7
    x = [s[0] + s[2], s[1] + s[3], s[0] - s[2], s[1] - s[3],
         s[4] + s[6], s[5] + s[7], s[4] - s[6], s[5] - s[7],
         s[8] + s[10], s[9] + s[11], s[8] - s[10], s[9] - s[11],
         s[12] + s[14], s[13] + s[15], s[12] - s[14], s[13] - s[15]]
    # stage 8
    s = [x[0], x[1],
         _hb(c[32], x[2], c[32], x[3]),
         _hb(c[32], x[2], -c[32], x[3]),
         x[4], x[5],
         _hb(c[32], x[6], c[32], x[7]),
         _hb(c[32], x[6], -c[32], x[7]),
         x[8], x[9],
         _hb(c[32], x[10], c[32], x[11]),
         _hb(c[32], x[10], -c[32], x[11]),
         x[12], x[13],
         _hb(c[32], x[14], c[32], x[15]),
         _hb(c[32], x[14], -c[32], x[15])]
    # stage 9: alternate negation
    return [s[0], -s[8], s[12], -s[4], s[6], -s[14], s[10], -s[2],
            s[3], -s[11], s[15], -s[7], s[5], -s[13], s[9], -s[1]]
