"""AV1 loop restoration — Wiener filter (spec 7.17), normative decode +
encoder-side tap search.

The reference gets loop restoration from libaom behind
avifEncoderAddImage (reference src/io.zig:629-632); here both sides are
from scratch:

  * `apply_wiener` replicates the decoder's filter bit-exactly (validated
    against dav1d in tests/test_conformance.py): 7-tap separable integer
    convolution, horizontal pass into a clamped intermediate then
    vertical (spec 7.17.4), with the stripe-boundary source selection of
    get_source_sample (spec 7.17.3) — rows outside the current 64-row
    stripe come from the *deblocked pre-CDEF* frame, limited to 2 rows
    beyond the stripe edge and duplicated outward, while in-stripe rows
    read the CDEF output. Stripes start at -8 (boundaries at 56, 120, …).

  * `search_wiener` is encoder freedom: per restoration unit it solves
    the separable Wiener-Hopf normal equations (7x7 auto/cross
    correlation statistics, alternating vertical/horizontal least
    squares under the symmetric + unit-DC-gain constraints), quantizes
    to the coded tap grid, and keeps the unit only when the measured SSE
    gain beats the syntax cost at the frame's lambda.

The full restoration toolset ships: WIENER, SGRPROJ (`sgrproj_unit` +
`search_sgrproj_unit`, bit-exact vs BOTH system decoders across the
whole coded weight space) and per-unit SWITCHABLE
(`search_restoration` / `apply_restoration`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

FILTER_BITS = 7
# coded tap bounds / subexp k / mid (refs), per tap position 0..2
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)
WIENER_TAPS_MID = (3, -7, 15)


def unit_size(unit_shift: int) -> int:
    return 256 >> (2 - unit_shift)


def count_units(frame_size: int, size: int) -> int:
    return max((frame_size + (size >> 1)) // size, 1)


def _coeffs7(t0: int, t1: int, t2: int) -> np.ndarray:
    c = 128 - 2 * (t0 + t1 + t2)
    return np.array([t0, t1, t2, c, t2, t1, t0], dtype=np.int32)


def _band_rows(y0: int, y1: int):
    """Split output rows [y0, y1) at the 64-row stripe boundaries
    (stripe k covers rows [64k-8, 64k+56) — first boundary at 56).
    Yields (r0, r1, stripe_start, stripe_end) with inclusive stripe
    bounds as the spec's StripeStartY/StripeEndY."""
    y = y0
    while y < y1:
        k = (y + 8) // 64
        ss = 64 * k - 8
        se = ss + 63
        r1 = min(y1, se + 1)
        yield y, r1, ss, se
        y = r1


def _gather_rows(cdef: np.ndarray, deblk: np.ndarray, rows: np.ndarray,
                 ss: int, se: int, h: int) -> np.ndarray:
    """get_source_sample row selection for a vector of source rows:
    clamp to the visible frame, then rows outside [ss, se] read the
    deblocked frame at most 2 rows past the stripe edge."""
    r = np.clip(rows, 0, h - 1)
    out = cdef[r]
    above = r < ss
    below = r > se
    if above.any():
        out[above] = deblk[np.maximum(ss - 2, r[above])]
    if below.any():
        out[below] = deblk[np.minimum(se + 2, r[below])]
    return out


def wiener_unit(cdef: np.ndarray, deblk: np.ndarray, vis_h: int, vis_w: int,
                x0: int, x1: int, y0: int, y1: int,
                vtaps, htaps, bitdepth: int,
                out: np.ndarray) -> None:
    """Filter one restoration unit [y0,y1)x[x0,x1) into `out` (spec
    7.17.4 wienerFilter, all integer)."""
    round0, round1 = 3, 11  # 12-bit would be 5/9; we code 8/10 only
    offset = 1 << (bitdepth + FILTER_BITS - round0 - 1)
    limit = (1 << (bitdepth + 1 + FILTER_BITS - round0)) - 1
    vf = _coeffs7(*vtaps)
    hf = _coeffs7(*htaps)
    w = x1 - x0
    cols = np.clip(np.arange(x0 - 3, x1 + 3), 0, vis_w - 1)
    for r0, r1, ss, se in _band_rows(y0, y1):
        h = r1 - r0
        rows = np.arange(r0 - 3, r1 + 3)
        src = _gather_rows(cdef, deblk, rows, ss, se, vis_h)[:, cols]
        src = src.astype(np.int32, copy=False)
        # horizontal pass -> clamped intermediate (h+6, w)
        s = np.zeros((h + 6, w), dtype=np.int32)
        for t in range(7):
            if hf[t]:
                s += hf[t] * src[:, t : t + w]
        inter = np.clip((s + (1 << (round0 - 1))) >> round0,
                        -offset, limit - offset)
        # vertical pass
        s2 = np.zeros((h, w), dtype=np.int32)
        for t in range(7):
            if vf[t]:
                s2 += vf[t] * inter[t : t + h]
        v = (s2 + (1 << (round1 - 1))) >> round1
        out[r0:r1, x0:x1] = np.clip(v, 0, (1 << bitdepth) - 1)


def unit_row_bounds(ur: int, urows: int, size: int, vis_h: int):
    """Vertical pixel extent a restoration-unit row governs. The unit
    grid is shifted UP by RESTORATION_UNIT_OFFSET=8 so each 64-row
    filtering stripe falls entirely inside one unit row (boundaries at
    56, 120, ... — empirically pinned against both system decoders in
    tests/test_restoration.py); the first row absorbs the offset and
    the last extends to the frame edge."""
    y0 = 0 if ur == 0 else ur * size - 8
    y1 = vis_h if ur + 1 >= urows else (ur + 1) * size - 8
    return y0, min(y1, vis_h)


def apply_wiener(cdef_planes: List[np.ndarray],
                 deblk_planes: List[np.ndarray],
                 vis_h: int, vis_w: int,
                 lr_types, unit_shift: int, wiener_taps: dict,
                 bitdepth: int) -> List[np.ndarray]:
    """Normative loop-restoration output: LrFrame = CDEF frame with each
    WIENER-flagged unit refiltered. `wiener_taps[plane][ur][uc]` is None
    or a 6-list (vertical t0..t2, horizontal t0..t2)."""
    size = unit_size(unit_shift)
    out_planes = []
    for p, cdef in enumerate(cdef_planes):
        out = cdef[:vis_h, :vis_w].copy()
        if lr_types[p] == 0 or wiener_taps.get(p) is None:
            out_planes.append(out)
            continue
        deblk = deblk_planes[p]
        urows = count_units(vis_h, size)
        ucols = count_units(vis_w, size)
        grid = wiener_taps[p]
        for ur in range(urows):
            y0, y1 = unit_row_bounds(ur, urows, size, vis_h)
            for uc in range(ucols):
                taps = grid[ur][uc]
                if taps is None:
                    continue
                x0 = uc * size
                x1 = (uc + 1) * size if uc + 1 < ucols else vis_w
                wiener_unit(cdef[:vis_h, :vis_w], deblk[:vis_h, :vis_w],
                            vis_h, vis_w, x0, x1, y0, y1,
                            taps[0:3], taps[3:6], bitdepth, out)
        out_planes.append(out)
    return out_planes


# ---------------------------------------------------------------------------
# self-guided restoration (SGRPROJ, spec 7.17.3)
# ---------------------------------------------------------------------------

# Sgr_Params[set] = (r0, e0, r1, e1); radii gate which xqd weights are
# coded. The filter itself consumes only the PRECOMPUTED strengths
# s = ((1<<20) + n^2 e / 2) / (n^2 e), taken verbatim from libdav1d's
# table at .rodata+0x21940 (pass-0/pass-1 per set) — deriving s from a
# misremembered e is how the first draft picked up a +-1 bias.
SGR_PARAMS = (
    (2, 12, 1, 4), (2, 15, 1, 6), (2, 18, 1, 8), (2, 21, 1, 9),
    (2, 24, 1, 10), (2, 29, 1, 11), (2, 36, 1, 12), (2, 45, 1, 13),
    (2, 56, 1, 14), (2, 68, 1, 15), (0, 0, 1, 5), (0, 0, 1, 8),
    (0, 0, 1, 11), (0, 0, 1, 14), (2, 30, 0, 0), (2, 75, 0, 0),
)
# (s0, s1) strengths per set: libdav1d's precomputed table verbatim
# (.rodata+0x21940). An earlier draft replaced the two-pass s1 column
# with spec-e1-derived values because the COMBINE was wrong (see
# av1_decode_xq below) and the wrong weights made the wrong strengths
# fit better; with the complemented weight the dav1d table zeroes every
# set (zero-interval fits on two content seeds).
SGR_S = (
    (140, 3236), (112, 2158), (93, 1618), (80, 1438), (70, 1295),
    (58, 1177), (47, 1079), (37, 996), (30, 925), (25, 863),
    (0, 2589), (0, 1618), (0, 1177), (0, 925), (56, 0), (22, 0),
)

SGRPROJ_SGR_BITS = 8
SGRPROJ_RECIP_BITS = 12
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7


def _sgr_box_sums(ext: np.ndarray, h: int, w: int, r: int):
    """Box sums (and squared sums) over (2r+1)^2 windows centered at
    grid (i, j), via integral images over the (h+6, w+6) extension.
    Strength-independent — the search shares one pair across every
    candidate set with this radius. Grid rows: the r=2 pass only ever
    reads the ODD grid rows -1, 1, 3, ... (spec: A/B every other row
    starting at -1), so r=2 sums skip the even ones; r=1 covers
    [-1, h] densely. Cols cover [-1, w]."""
    e = ext.astype(np.int64)
    ii = np.zeros((ext.shape[0] + 1, ext.shape[1] + 1), np.int64)
    ii2 = np.zeros_like(ii)
    np.cumsum(np.cumsum(e, 0), 1, out=ii[1:, 1:])
    np.cumsum(np.cumsum(e * e, 0), 1, out=ii2[1:, 1:])

    def box(iiX, i0, i1, j0, j1):
        # sums over ext rows [i0, i1) cols [j0, j1), vectorized grids
        return (iiX[i1[:, None], j1[None, :]] - iiX[i0[:, None], j1[None, :]]
                - iiX[i1[:, None], j0[None, :]] + iiX[i0[:, None], j0[None, :]])

    step = 2 if r == 2 else 1
    gi = np.arange(-1, h + 1, step) + 3  # grid rows in ext coords
    gj = np.arange(-1, w + 1) + 3
    b_sum = box(ii, gi - r, gi + r + 1, gj - r, gj + r + 1)
    a_sum = box(ii2, gi - r, gi + r + 1, gj - r, gj + r + 1)
    return b_sum, a_sum


def _sgr_box_filter(ext: np.ndarray, h: int, w: int, r: int, s: int,
                    bitdepth: int, pass0_fast: bool,
                    sums=None) -> np.ndarray:
    """One box-filter pass over a (h+6, w+6) extended source window
    (offset 3,3 = unit origin). Returns flt (h, w) at the << RST_BITS
    scale. `pass0_fast` enables the r=2 every-other-row A/B grid with
    the 5/6 // 3/4 cross sums (spec 7.17.3). `sums` short-circuits
    the radius-dependent box sums (from _sgr_box_sums)."""
    n = (2 * r + 1) * (2 * r + 1)
    one_over_n = ((1 << SGRPROJ_RECIP_BITS) + n // 2) // n
    e = ext.astype(np.int64)
    b_sum, a_sum = sums if sums is not None else _sgr_box_sums(ext, h, w, r)
    shift2 = 2 * (bitdepth - 8)
    d = (a_sum + (1 << shift2 >> 1)) >> shift2 if shift2 else a_sum
    c2 = (b_sum + (1 << (bitdepth - 8) >> 1)) >> (bitdepth - 8) \
        if bitdepth > 8 else b_sum
    p = np.maximum(0, d * n - c2 * c2)
    z = (p * s + (1 << (SGRPROJ_MTABLE_BITS - 1))) >> SGRPROJ_MTABLE_BITS
    a2 = np.where(
        z >= 255, 256,
        np.where(z == 0, 1, ((z << SGRPROJ_SGR_BITS) + z // 2) // (z + 1)))
    b2 = (((1 << SGRPROJ_SGR_BITS) - a2) * b_sum * one_over_n
          + (1 << (SGRPROJ_RECIP_BITS - 1))) >> SGRPROJ_RECIP_BITS
    # A/B indexed [i+1][j+1] for i in [-1, h]; cross-sums vectorized
    # over all output rows at once (the search runs this per candidate
    # strength — the original per-row loop priced a 16-set sweep out)
    A, B = a2, b2
    src = e[3 : 3 + h, 3 : 3 + w]
    ar = np.empty((h, w), np.int64)
    br = np.empty_like(ar)
    shift = np.empty((h, 1), np.int64)
    if pass0_fast:
        # the r=2 A/B grid holds ONLY the odd grid rows -1, 1, 3, ...
        # (pinned against dav1d: the even-grid variant leaves a ±1
        # bias under strong eps); row index j holds grid row 2j-1.
        # Even output row i reads grid rows i-1, i+1 -> A[i/2], A[i/2+1]
        # with a 5/6 cross-sum; odd output row i sits ON grid row i
        # -> A[(i+1)/2], 3-tap {5,6,5}. All strided slices — fancy
        # gathers here dominated the whole SGR search.
        ne = (h + 1) // 2  # even output rows
        no = h // 2        # odd output rows
        for G, out in ((A, ar), (B, br)):
            g0 = G[0 : ne, :]            # grid row i-1
            g1 = G[1 : ne + 1, :]        # grid row i+1
            out[0:h:2] = (5 * (g0[:, 0:w] + g0[:, 2 : w + 2]
                               + g1[:, 0:w] + g1[:, 2 : w + 2])
                          + 6 * (g0[:, 1 : w + 1] + g1[:, 1 : w + 1]))
            go = G[1 : no + 1, :]        # own grid row
            out[1:h:2] = (5 * (go[:, 0:w] + go[:, 2 : w + 2])
                          + 6 * go[:, 1 : w + 1])
        shift[0:h:2] = 5  # weight sum 32
        shift[1:h:2] = 4  # weight sum 16
    else:
        # r=1 pass: full 3x3 cross sum, weights 3 corners / 4 edges+c
        for G, out in ((A, ar), (B, br)):
            out[:] = (3 * (G[0:h, 0:w] + G[0:h, 2 : w + 2]
                           + G[2 : h + 2, 0:w] + G[2 : h + 2, 2 : w + 2])
                      + 4 * (G[0:h, 1 : w + 1] + G[2 : h + 2, 1 : w + 1]
                             + G[1 : h + 1, 0:w] + G[1 : h + 1, 2 : w + 2]
                             + G[1 : h + 1, 1 : w + 1]))
        shift[:] = 5
    tot = SGRPROJ_SGR_BITS + shift - SGRPROJ_RST_BITS
    return (ar * src + br + (np.int64(1) << (tot - 1))) >> tot


def sgrproj_unit(cdef: np.ndarray, deblk: np.ndarray, vis_h: int,
                 vis_w: int, x0: int, x1: int, y0: int, y1: int,
                 set_idx: int, w0: int, w1: int, bitdepth: int,
                 out: np.ndarray) -> None:
    """Self-guided restoration of one unit (spec 7.17.3), stripe-banded
    like the Wiener path."""
    r0, _, r1, _ = SGR_PARAMS[set_idx]
    s0, s1 = SGR_S[set_idx]
    w = x1 - x0
    cols = np.clip(np.arange(x0 - 3, x1 + 3), 0, vis_w - 1)
    for b0, b1, ss, se in _band_rows(y0, y1):
        h = b1 - b0
        rows = np.arange(b0 - 3, b1 + 3)
        ext = _gather_rows(cdef, deblk, rows, ss, se, vis_h)[:, cols]
        src = ext[3 : 3 + h, 3 : 3 + w].astype(np.int64)
        u = src << SGRPROJ_RST_BITS
        flt0 = _sgr_box_filter(ext, h, w, r0, s0, bitdepth, True) \
            if r0 else u
        flt1 = _sgr_box_filter(ext, h, w, r1, s1, bitdepth, False) \
            if r1 else u
        # effective projection weights (libaom av1_decode_xq, pinned
        # empirically via isolation probes): the r=1 filter weight is
        # the COMPLEMENT 128 - xq0 - xqd[1] whenever pass 1 runs - the
        # coded xqd[1] ends up weighting the unfiltered sample
        if r0 == 0:
            xq0, xq1 = 0, (1 << SGRPROJ_PRJ_BITS) - w1
        elif r1 == 0:
            xq0, xq1 = w0, 0
        else:
            xq0, xq1 = w0, (1 << SGRPROJ_PRJ_BITS) - w0 - w1
        v = (u << SGRPROJ_PRJ_BITS) + xq0 * (flt0 - u) + xq1 * (flt1 - u)
        sh = SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS
        res = (v + (1 << (sh - 1))) >> sh
        out[b0:b1, x0:x1] = np.clip(res, 0, (1 << bitdepth) - 1)


def apply_sgrproj(cdef_planes: List[np.ndarray],
                  deblk_planes: List[np.ndarray],
                  vis_h: int, vis_w: int, lr_types, unit_shift: int,
                  sgr_grids: dict, bitdepth: int) -> List[np.ndarray]:
    """LrFrame for SGRPROJ-type planes. sgr_grids[plane][ur][uc] is None
    or (set_idx, xqd0, xqd1)."""
    size = unit_size(unit_shift)
    out_planes = []
    for p, cdef in enumerate(cdef_planes):
        out = cdef[:vis_h, :vis_w].copy()
        if lr_types[p] != 3 or sgr_grids.get(p) is None:
            out_planes.append(out)
            continue
        deblk = deblk_planes[p]
        urows = count_units(vis_h, size)
        ucols = count_units(vis_w, size)
        grid = sgr_grids[p]
        for ur in range(urows):
            y0, y1 = unit_row_bounds(ur, urows, size, vis_h)
            for uc in range(ucols):
                entry = grid[ur][uc]
                if entry is None:
                    continue
                x0 = uc * size
                x1 = (uc + 1) * size if uc + 1 < ucols else vis_w
                sgrproj_unit(cdef[:vis_h, :vis_w], deblk[:vis_h, :vis_w],
                             vis_h, vis_w, x0, x1, y0, y1,
                             entry[0], entry[1], entry[2], bitdepth, out)
        out_planes.append(out)
    return out_planes


# ---------------------------------------------------------------------------
# encoder-side tap search (encoder freedom; nothing here is normative)
# ---------------------------------------------------------------------------


def _solve_constrained(A: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """Minimize fᵀAf − 2bᵀf over symmetric unit-gain 7-taps
    f = [a,b,c, 1−2(a+b+c), c,b,a]; returns the full 7-vector."""
    B = np.zeros((7, 3))
    for j in range(3):
        B[j, j] = 1.0
        B[6 - j, j] = 1.0
        B[3, j] = -2.0
    f0 = np.zeros(7)
    f0[3] = 1.0
    M = B.T @ A @ B
    rhs = B.T @ (b - A @ f0)
    try:
        p = np.linalg.solve(M + 1e-8 * np.eye(3), rhs)
    except np.linalg.LinAlgError:
        return None
    return f0 + B @ p


def solve_wiener_taps(src: np.ndarray, deg: np.ndarray,
                      chroma: bool = False, iters: int = 6):
    """Alternating separable Wiener solve on one unit. `src`/`deg` are
    the source and degraded (post-CDEF) unit at equal shape. Returns
    (vtaps, htaps) as coded int 3-tuples, or None if degenerate."""
    h, w = deg.shape
    if h < 16 or w < 16:
        return None
    # interior windows only (no boundary modeling in the stats),
    # subsampled stride 2 on both axes — keeps the normal equations
    # well-conditioned and quarters the GEMM. Window rows/cols are
    # arithmetic sequences, so each shifted window is a strided SLICE
    # (a np.ix_ fancy gather here cost more than the solve itself)
    if h - 6 < 8 or w - 6 < 8:
        return None
    d = deg.astype(np.float32)
    ny = len(range(3, h - 3, 2))
    nx = len(range(3, w - 3, 2))
    X = np.empty((49, ny * nx), dtype=np.float32)
    k = 0
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            X[k] = d[3 + dy : h - 3 + dy : 2,
                     3 + dx : w - 3 + dx : 2].ravel()
            k += 1
    tgt = src.astype(np.float32)[3 : h - 3 : 2, 3 : w - 3 : 2].ravel()
    n = float(tgt.size)
    H = (X @ X.T) / n
    M = (X @ tgt) / n
    Hm = H.reshape(7, 7, 7, 7)  # [vi, hi, vj, hj]
    Mm = M.reshape(7, 7)
    vf = np.zeros(7)
    vf[3] = 1.0
    hf = vf.copy()
    for _ in range(iters):
        # fix hf, solve vf
        A = np.einsum("k,l,ikjl->ij", hf, hf, Hm)
        b = Mm @ hf
        nv = _solve_constrained(A, b)
        if nv is None:
            return None
        vf = nv
        # fix vf, solve hf
        A = np.einsum("i,j,ikjl->kl", vf, vf, Hm)
        b = vf @ Mm
        nh = _solve_constrained(A, b)
        if nh is None:
            return None
        hf = nh

    def quant(f):
        t = []
        for j in range(3):
            lo, hi = WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j]
            if chroma and j == 0:
                t.append(0)
                continue
            t.append(int(np.clip(round(f[j] * 128.0), lo, hi)))
        return tuple(t)

    vt, ht = quant(vf), quant(hf)
    if chroma:
        vt = (0, vt[1], vt[2])
        ht = (0, ht[1], ht[2])
    return vt, ht


def _subexp_bits(mx: int, k: int, r: int, v: int) -> int:
    """Exact bit count of the encoder's subexp-with-ref coding."""
    if (r << 1) <= mx:
        from .frame import _recenter

        vv = _recenter(r, v)
    else:
        from .frame import _recenter

        vv = _recenter(mx - 1 - r, mx - 1 - v)
    bits = 0
    i = 0
    mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if mx <= mk + 3 * a:
            n = mx - mk
            if n > 1:
                w = n.bit_length()
                m = (1 << w) - n
                bits += (w - 1) if (vv - mk) < m else w
            return bits
        bits += 1
        if vv >= mk + a:
            i += 1
            mk += a
        else:
            return bits + b2


def taps_bits(taps, refs, chroma: bool) -> int:
    """Syntax bits for one unit's coded taps given the running refs."""
    bits = 0
    j0 = 1 if chroma else 0
    for p2 in range(2):
        for j in range(j0, 3):
            lo = WIENER_TAPS_MIN[j]
            hi = WIENER_TAPS_MAX[j] + 1
            bits += _subexp_bits(hi - lo, WIENER_TAPS_K[j],
                                 refs[p2][j] - lo, taps[p2 * 3 + j] - lo)
    return bits


def search_wiener(src_planes: List[np.ndarray],
                  cdef_planes: List[np.ndarray],
                  deblk_planes: List[np.ndarray],
                  vis_h: int, vis_w: int, bitdepth: int,
                  lam_pix: float, unit_shift: int = 2,
                  planes: Optional[range] = None):
    """Per-unit Wiener decision for the frame. Returns (lr_types,
    wiener_taps) in the encoder's config format, or (None, None) when no
    unit pays for itself. lam_pix is in SSE-per-rate-unit (128 units per
    bit, the block RD convention)."""
    size = unit_size(unit_shift)
    urows = count_units(vis_h, size)
    ucols = count_units(vis_w, size)
    lr_types = [0, 0, 0][: len(src_planes)]
    taps_cfg: dict = {}
    for p in range(len(src_planes)):
        chroma = p > 0
        src = src_planes[p][:vis_h, :vis_w]
        cdef = cdef_planes[p][:vis_h, :vis_w]
        deblk = deblk_planes[p][:vis_h, :vis_w]
        grid = [[None] * ucols for _ in range(urows)]
        any_on = False
        refs = [list(WIENER_TAPS_MID), list(WIENER_TAPS_MID)]
        for ur in range(urows):
            y0, y1 = unit_row_bounds(ur, urows, size, vis_h)
            for uc in range(ucols):
                x0 = uc * size
                x1 = (uc + 1) * size if uc + 1 < ucols else vis_w
                s = src[y0:y1, x0:x1]
                dg = cdef[y0:y1, x0:x1]
                base_sse = float(
                    np.square(s.astype(np.int64) - dg).sum()
                )
                if base_sse == 0.0:
                    continue
                sol = solve_wiener_taps(s, dg, chroma=chroma)
                if sol is None:
                    continue
                vt, ht = sol
                taps6 = list(vt) + list(ht)
                trial = dg.copy()
                wiener_unit(cdef, deblk, vis_h, vis_w, x0, x1, y0, y1,
                            vt, ht, bitdepth,
                            _FullWriter(trial, y0, x0))
                sse = float(
                    np.square(s.astype(np.int64) - trial).sum()
                )
                bits = 1 + taps_bits(taps6, refs, chroma)
                if base_sse - sse > lam_pix * 128.0 * bits:
                    grid[ur][uc] = taps6
                    any_on = True
                    for p2 in range(2):
                        for j in range(3):
                            refs[p2][j] = taps6[p2 * 3 + j]
        if any_on:
            lr_types[p] = 2
            taps_cfg[p] = grid
    if not any(lr_types):
        return None, None
    return tuple(lr_types), taps_cfg


SGRPROJ_XQD0_MIN, SGRPROJ_XQD0_MAX = -96, 31
SGRPROJ_XQD1_MIN, SGRPROJ_XQD1_MAX = -32, 95
SGR_XQD_MID = (-32, 31)  # C-truncated range midpoints (see frame.py)
# approximate symbol costs (bits) from the extracted default CDFs —
# RD guidance only, never coded
_BITS_WIENER_FLAG = (0.63, 1.50)  # (use=1, use=0) from [21198, 0]
_BITS_SGR_FLAG = (1.04, 0.96)  # from [15913, 0]
_BITS_SWITCHABLE = (1.80, 1.32, 1.69)  # NONE/WIENER/SGR from [23355,10187,0]


def _sgr_unit_parts(cdef: np.ndarray, deblk: np.ndarray, vis_h: int,
                    vis_w: int, x0: int, x1: int, y0: int, y1: int,
                    rs_list, bitdepth: int):
    """Degraded unit u (<<RST_BITS) plus the box-filter output for every
    requested (radius, strength) pair, banded exactly like
    sgrproj_unit — so a closed-form projection solve on these arrays
    reproduces the decoder's combine bit-for-bit."""
    w = x1 - x0
    H = y1 - y0
    u = np.empty((H, w), np.int64)
    flts = {rs: np.empty((H, w), np.int64) for rs in rs_list}
    cols = np.clip(np.arange(x0 - 3, x1 + 3), 0, vis_w - 1)
    for b0, b1, ss, se in _band_rows(y0, y1):
        h = b1 - b0
        rows = np.arange(b0 - 3, b1 + 3)
        ext = _gather_rows(cdef, deblk, rows, ss, se, vis_h)[:, cols]
        src = ext[3 : 3 + h, 3 : 3 + w].astype(np.int64)
        u[b0 - y0 : b1 - y0] = src << SGRPROJ_RST_BITS
        sums = {r: _sgr_box_sums(ext, h, w, r)
                for r in {r for r, _ in rs_list}}
        for r, s in rs_list:
            flts[(r, s)][b0 - y0 : b1 - y0] = _sgr_box_filter(
                ext, h, w, r, s, bitdepth, r == 2, sums=sums[r])
    return u, flts


def _sgr_sse(src: np.ndarray, u: np.ndarray, a, b, xq0: int, xq1: int,
             bitdepth: int) -> float:
    """Exact decoder-combine SSE for candidate effective weights."""
    v = u << SGRPROJ_PRJ_BITS
    if xq0:
        v = v + xq0 * a
    if xq1:
        v = v + xq1 * b
    sh = SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS
    res = np.clip((v + (1 << (sh - 1))) >> sh, 0, (1 << bitdepth) - 1)
    return float(np.square(src - res).sum())


def _sgr_bits(set_idx: int, w0: int, w1: int, refs) -> int:
    """Syntax bits for one SGR unit given the running xqd refs (flag
    excluded; the frame-type-dependent flag is priced by the caller)."""
    r0, _, r1, _ = SGR_PARAMS[set_idx]
    bits = 4
    if r0:
        bits += _subexp_bits(SGRPROJ_XQD0_MAX + 1 - SGRPROJ_XQD0_MIN, 4,
                             refs[0] - SGRPROJ_XQD0_MIN,
                             w0 - SGRPROJ_XQD0_MIN)
    if r1:
        bits += _subexp_bits(SGRPROJ_XQD1_MAX + 1 - SGRPROJ_XQD1_MIN, 4,
                             refs[1] - SGRPROJ_XQD1_MIN,
                             w1 - SGRPROJ_XQD1_MIN)
    return bits


# candidate ep sets for the search: spans the strength range of both
# families (two-pass 0..9, r1-only 10..13, r0-only 14..15)
SGR_SETS_FULL = tuple(range(16))
SGR_SETS_REDUCED = (1, 4, 7, 9, 11, 12, 14)


def search_sgrproj_unit(src: np.ndarray, cdef: np.ndarray,
                        deblk: np.ndarray, vis_h: int, vis_w: int,
                        x0: int, x1: int, y0: int, y1: int,
                        bitdepth: int, refs, sets=SGR_SETS_REDUCED):
    """Best SGRPROJ candidate for one unit: per ep set, solve the
    projection least squares over the decoder's (flt - u) bases, round
    to the coded xqd grid, then score the exact integer combine.
    Returns ((set, w0, w1), sse, bits) or None. Mirrors the role of
    libaom's search_sgrproj (encoder freedom; nothing normative)."""
    rs = set()
    for si in sets:
        r0, _, r1, _ = SGR_PARAMS[si]
        s0, s1 = SGR_S[si]
        if r0:
            rs.add((2, s0))
        if r1:
            rs.add((1, s1))
    u, flts = _sgr_unit_parts(cdef, deblk, vis_h, vis_w, x0, x1, y0, y1,
                              rs, bitdepth)
    s64 = src.astype(np.int64)
    c = (s64 - (u >> SGRPROJ_RST_BITS)) << (SGRPROJ_PRJ_BITS
                                            + SGRPROJ_RST_BITS)
    best = None
    for si in sets:
        r0, _, r1, _ = SGR_PARAMS[si]
        s0, s1 = SGR_S[si]
        a = flts[(2, s0)] - u if r0 else None
        b = flts[(1, s1)] - u if r1 else None
        if r0 and r1:
            aa = float((a * a).sum())
            bb = float((b * b).sum())
            ab = float((a * b).sum())
            det = aa * bb - ab * ab
            if det <= 1e-6:
                continue
            ca = float((a * c).sum())
            cb = float((b * c).sum())
            xq0 = (bb * ca - ab * cb) / det
            xq1 = (aa * cb - ab * ca) / det
            w0 = int(np.clip(round(xq0), SGRPROJ_XQD0_MIN,
                             SGRPROJ_XQD0_MAX))
            # effective xq1 bounded by the coded complement's range:
            # w1 = 128 - xq0 - xq1 in [-32, 95]
            xq1i = int(np.clip(round(xq1), 33 - w0, 160 - w0))
            w1 = (1 << SGRPROJ_PRJ_BITS) - w0 - xq1i
            sse = _sgr_sse(s64, u, a, b, w0, xq1i, bitdepth)
        elif r1:
            bb = float((b * b).sum())
            if bb <= 0:
                continue
            xq1 = float((b * c).sum()) / bb
            # decode maps w1 -> xq1 = 128 - w1, w1 in [-32, 95]
            xq1i = int(np.clip(round(xq1), 33, 160))
            w0 = 0
            w1 = (1 << SGRPROJ_PRJ_BITS) - xq1i
            sse = _sgr_sse(s64, u, None, b, 0, xq1i, bitdepth)
        else:
            aa = float((a * a).sum())
            if aa <= 0:
                continue
            xq0 = float((a * c).sum()) / aa
            w0 = int(np.clip(round(xq0), SGRPROJ_XQD0_MIN,
                             SGRPROJ_XQD0_MAX))
            w1 = 95  # pinned by the coder when pass 1 is off
            sse = _sgr_sse(s64, u, a, None, w0, 0, bitdepth)
        bits = _sgr_bits(si, w0, w1, refs)
        if best is None or sse < best[1]:
            best = ((si, w0, w1), sse, bits)
    return best


def search_restoration(src_planes: List[np.ndarray],
                       cdef_planes: List[np.ndarray],
                       deblk_planes: List[np.ndarray],
                       vis_h: int, vis_w: int, bitdepth: int,
                       lam_pix: float, unit_shift: int = 2,
                       sgr_sets=SGR_SETS_REDUCED):
    """Joint per-unit WIENER / SGRPROJ / NONE decision (the libaom
    search_loop_restoration role). Greedy in scan order with running
    subexp refs, like search_wiener. Per plane the frame type becomes
    WIENER(2) or SGRPROJ(3) when one family wins everywhere, else
    SWITCHABLE(1). Returns (lr_types, wiener_cfg, sgr_cfg) —
    (None, None, None) when nothing pays for itself."""
    size = unit_size(unit_shift)
    urows = count_units(vis_h, size)
    ucols = count_units(vis_w, size)
    lr_types = [0] * len(src_planes)
    wiener_cfg: dict = {}
    sgr_cfg: dict = {}
    for p in range(len(src_planes)):
        chroma = p > 0
        src = src_planes[p][:vis_h, :vis_w]
        cdef = cdef_planes[p][:vis_h, :vis_w]
        deblk = deblk_planes[p][:vis_h, :vis_w]
        wgrid = [[None] * ucols for _ in range(urows)]
        sgrid = [[None] * ucols for _ in range(urows)]
        kinds = set()
        wrefs = [list(WIENER_TAPS_MID), list(WIENER_TAPS_MID)]
        srefs = list(SGR_XQD_MID)
        for ur in range(urows):
            y0, y1 = unit_row_bounds(ur, urows, size, vis_h)
            for uc in range(ucols):
                x0 = uc * size
                x1 = (uc + 1) * size if uc + 1 < ucols else vis_w
                s = src[y0:y1, x0:x1]
                dg = cdef[y0:y1, x0:x1]
                base_sse = float(np.square(s.astype(np.int64) - dg).sum())
                if base_sse == 0.0:
                    continue
                cand = []  # (gain - cost, kind, payload, refs update)
                sol = solve_wiener_taps(s, dg, chroma=chroma)
                if sol is not None:
                    vt, ht = sol
                    taps6 = list(vt) + list(ht)
                    trial = dg.copy()
                    wiener_unit(cdef, deblk, vis_h, vis_w, x0, x1, y0, y1,
                                vt, ht, bitdepth, _FullWriter(trial, y0, x0))
                    sse = float(np.square(s.astype(np.int64) - trial).sum())
                    bits = _BITS_WIENER_FLAG[0] + taps_bits(
                        taps6, wrefs, chroma)
                    cand.append((base_sse - sse - lam_pix * 128.0 * bits,
                                 "W", taps6))
                sg = search_sgrproj_unit(s, cdef, deblk, vis_h, vis_w,
                                         x0, x1, y0, y1, bitdepth, srefs,
                                         sets=sgr_sets)
                if sg is not None:
                    entry, sse, bits = sg
                    cand.append((base_sse - sse - lam_pix * 128.0
                                 * (bits + _BITS_SGR_FLAG[0]),
                                 "S", entry))
                if not cand:
                    continue
                gain, kind, payload = max(cand, key=lambda t: t[0])
                if gain <= 0:
                    continue
                kinds.add(kind)
                if kind == "W":
                    wgrid[ur][uc] = payload
                    for p2 in range(2):
                        for j in range(3):
                            wrefs[p2][j] = payload[p2 * 3 + j]
                else:
                    sgrid[ur][uc] = payload
                    si, w0, w1 = payload
                    r0, _, r1, _ = SGR_PARAMS[si]
                    srefs[0] = w0 if r0 else 0
                    srefs[1] = w1 if r1 else 95
        if not kinds:
            continue
        if kinds == {"W"}:
            lr_types[p] = 2
            wiener_cfg[p] = wgrid
        elif kinds == {"S"}:
            lr_types[p] = 3
            sgr_cfg[p] = sgrid
        else:
            lr_types[p] = 1
            wiener_cfg[p] = wgrid
            sgr_cfg[p] = sgrid
    if not any(lr_types):
        return None, None, None
    return tuple(lr_types), wiener_cfg, sgr_cfg


def apply_restoration(cdef_planes: List[np.ndarray],
                      deblk_planes: List[np.ndarray],
                      vis_h: int, vis_w: int, lr_types, unit_shift: int,
                      wiener_cfg, sgr_cfg, bitdepth: int):
    """LrFrame for mixed per-unit types (spec 7.17 loop_restore_block
    dispatch): each unit applies the filter its grid entry names —
    Wiener taps, SGR (set, xqd) — or passes CDEF through."""
    size = unit_size(unit_shift)
    out_planes = []
    wiener_cfg = wiener_cfg or {}
    sgr_cfg = sgr_cfg or {}
    for p, cdef in enumerate(cdef_planes):
        out = cdef[:vis_h, :vis_w].copy()
        if lr_types[p] == 0:
            out_planes.append(out)
            continue
        deblk = deblk_planes[p]
        urows = count_units(vis_h, size)
        ucols = count_units(vis_w, size)
        wg = wiener_cfg.get(p)
        sg = sgr_cfg.get(p)
        for ur in range(urows):
            y0, y1 = unit_row_bounds(ur, urows, size, vis_h)
            for uc in range(ucols):
                x0 = uc * size
                x1 = (uc + 1) * size if uc + 1 < ucols else vis_w
                taps = wg[ur][uc] if wg is not None else None
                entry = sg[ur][uc] if sg is not None else None
                if taps is not None:
                    wiener_unit(cdef[:vis_h, :vis_w],
                                deblk[:vis_h, :vis_w], vis_h, vis_w,
                                x0, x1, y0, y1, taps[0:3], taps[3:6],
                                bitdepth, out)
                elif entry is not None:
                    sgrproj_unit(cdef[:vis_h, :vis_w],
                                 deblk[:vis_h, :vis_w], vis_h, vis_w,
                                 x0, x1, y0, y1, entry[0], entry[1],
                                 entry[2], bitdepth, out)
        out_planes.append(out)
    return out_planes


class _FullWriter:
    """Adapter: wiener_unit writes out[y, x] in frame coordinates; this
    view redirects them into a unit-local buffer."""

    def __init__(self, buf: np.ndarray, y0: int, x0: int) -> None:
        self.buf = buf
        self.y0 = y0
        self.x0 = x0

    def __setitem__(self, key, value):
        ys, xs = key
        self.buf[
            ys.start - self.y0 : ys.stop - self.y0,
            xs.start - self.x0 : xs.stop - self.x0,
        ] = value
