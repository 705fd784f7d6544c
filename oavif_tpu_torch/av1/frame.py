"""AV1 intra frame encoder: tile symbol emission + reconstruction.

Host reference implementation (exact integer arithmetic, NumPy). The
compute-heavy stages (prediction, transforms, quantization, RD, and the
SSIMULACRA2 in-loop scoring) have batched TPU counterparts in
oavif_tpu.av1.encode; this module owns the *sequential* parts: context
tracking and adaptive symbol coding, which are entropy-inherent serial per
tile (SURVEY.md §2c — tiles are the parallel axis).

Replaces the reference's libaom delegation (io.zig:629-632). Coding-tool
configuration matches oavif_tpu.av1.obu (loop filter + CDEF replicated
normatively post-encode; TX_MODE_SELECT with per-block tx-depth RD; no
restoration, no screen content tools) so reconstruction here equals the
decoder's output bit-exactly — verified against dav1d in
tests/test_conformance.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .consts import (
    DC_PRED,
    INTRA_MODE_CONTEXT,
    MODE_TO_ANGLE,
    PARTITION_NONE,
    PARTITION_SPLIT,
    SKIP_CONTEXTS_TABLE,
    UV_CFL_PRED,
    coeff_q_ctx,
)
from .entropy.rangecoder import RangeEncoder, update_cdf


def _sum8(t: np.ndarray) -> float:
    """8-lane blocked double sum — THE accumulation-order contract with
    oav1tile.c vsum8_f64: interleaved lane accumulators over the array,
    lanes folded in index order, tail appended sequentially. Both sides
    add the same doubles in the same order, so sums are bit-identical."""
    t = np.ascontiguousarray(t, dtype=np.float64)
    n = t.size
    m = n & ~7
    s = 0.0
    if m:
        acc = np.zeros(8, dtype=np.float64)
        for row in t[:m].reshape(-1, 8):
            acc += row
        for l in range(8):
            s += float(acc[l])
    for i in range(m, n):
        s += float(t[i])
    return s


class _PyShim:
    """Adapter giving the pure-Python RangeEncoder the native interface."""

    def __init__(self, enc: "RangeEncoder") -> None:
        self.enc = enc

    def sym_adapt(self, cdf_row, s: int) -> None:
        nsym = len(cdf_row) - 1
        self.enc.encode_symbol(s, cdf_row, nsym)
        update_cdf(cdf_row, s, nsym)

    def sym_noadapt(self, cdf_row, s: int) -> None:
        self.enc.encode_symbol(s, cdf_row, len(cdf_row) - 1)

    def bool_q15(self, val: int, f: int) -> None:
        self.enc.encode_bool_q15(val, f)

    def write_literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.enc.encode_bool_q15((v >> i) & 1, 16384)

    def done(self) -> bytes:
        return self.enc.done()

    coeffs = None  # python coefficient path used instead


class _NativeShim:
    def __init__(self, enc) -> None:
        self.enc = enc
        self.coeffs = enc.coeffs

    def sym_adapt(self, cdf_row, s: int) -> None:
        self.enc.sym_adapt(cdf_row, s)

    def sym_noadapt(self, cdf_row, s: int) -> None:
        self.enc.sym_noadapt(cdf_row, s)

    def bool_q15(self, val: int, f: int) -> None:
        self.enc.bool_q15(val, f)

    def write_literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.enc.bool_q15((v >> i) & 1, 16384)

    def done(self) -> bytes:
        return self.enc.done()
from .intra import FILTER_BASE, FILTER_TO_DIR, build_edges, predict
from .tables import TABLES, ac_q, dc_q
from .transform import INV_ROW_SHIFT, fwd_txfm2d_int, inv_txfm2d

# dequant right-shift per (max) tx dimension — normative (spec 7.12.2 /
# dav1d dq_shift). Validated by single-coefficient oracle probes.
DQ_SHIFT = {4: 0, 8: 0, 16: 0, 32: 1, 64: 2}

_PARTITION_CDF_KEY = {8: "partition_w8", 16: "partition_w16",
                      32: "partition_w32", 64: "partition_w64",
                      128: "partition_w128"}
_PARTITION_NSYM = {8: 4, 16: 10, 32: 10, 64: 10, 128: 8}

# partition context lookup: above/left byte per block width/height in px
_PART_CTX_BYTE = {4: 31, 8: 30, 16: 28, 32: 24, 64: 16, 128: 0}

_TXS_CTX = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}


def _recenter(r: int, v: int) -> int:
    """Forward of the spec's inverse_recenter: fold v around the
    reference r so small |v - r| codes short. Parity carries the side:
    v >= r codes even, v < r codes odd (inverse_recenter's odd branch
    subtracts). Verified by exhaustive round-trip in
    tests/test_restoration.py."""
    if v > 2 * r:
        return v
    if v >= r:
        return 2 * (v - r)
    return 2 * (r - v) - 1

# BLOCK_SIZES_ALL index rows of the use_filter_intra CDF bank: square
# sizes and the two rect sizes the product path codes
_FI_BSIZE_IDX = {4: 0, 8: 3, 16: 6, 32: 9, (16, 32): 7, (32, 16): 8}

_EOB_PT_NSYM = {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}
_EOB_PT_KEY = {16: "eob_pt_16", 32: "eob_pt_32", 64: "eob_pt_64",
               128: "eob_pt_128", 256: "eob_pt_256", 512: "eob_pt_512",
               1024: "eob_pt_1024"}

NUM_BASE_LEVELS_ = 2

# --- RDOQ rate model ----------------------------------------------------
# Bit costs in 1/128-bit units from symbol probabilities at 1/256
# resolution (the same resolution libaom's av1_prob_cost tables use).
# The C runtime embeds this exact table (generated from this expression)
# so RDOQ decisions are bit-identical between the two paths.
_PROB_COST = np.round(
    -np.log2((np.arange(256, dtype=np.float64) + 1.0) / 256.0) * 128.0
).astype(np.int32)

# λ = RDOQ_K · (dq_ac² >> 2·DQ_SHIFT) / 128, with RDOQ_K = KNUM/KDEN.
# Calibrated on iso-SSIMULACRA2 bytes (photo/gradient/noise probes).
RDOQ_KNUM = 1
RDOQ_KDEN = 4


def _icdf_cost_rows(rows: np.ndarray, nsym: int) -> np.ndarray:
    """Per-symbol bit costs (1/128-bit units) from adaptive icdf rows
    (must be called on INITIAL rows, before any adaptation)."""
    a = rows.astype(np.int64)[..., :nsym]
    prev = np.concatenate(
        [np.full(a.shape[:-1] + (1,), 32768, np.int64), a[..., : nsym - 1]], -1
    )
    p = np.clip(prev - a, 1, 32768)
    return _PROB_COST[np.minimum((p - 1) >> 7, 255)].astype(np.int32)


def _icdf_sym_cost_row(row, s: int) -> int:
    """Bit cost (1/128 units) of symbol s under one adaptive icdf row
    (same formula as _icdf_cost_rows, evaluated at the row's current
    state — the palette RD reads live rows; mirrored in C)."""
    prev = 32768 if s == 0 else int(row[s - 1])
    p = max(1, prev - int(row[s]))
    return int(_PROB_COST[min((p - 1) >> 7, 255)])


def _adaptive(arr: np.ndarray) -> np.ndarray:
    """ICDF table row(s) → mutable adaptive CDF rows with a trailing
    adaptation-counter column, contiguous uint16 (shared with the native
    coder)."""
    a = np.asarray(arr, dtype=np.uint16)
    out = np.zeros(a.shape[:-1] + (a.shape[-1] + 1,), dtype=np.uint16)
    out[..., : a.shape[-1]] = a
    return np.ascontiguousarray(out)


class CdfBank:
    """All adaptive CDFs for one tile, initialized from the extracted
    defaults (av1_tables.npz), sliced at the frame's coefficient q-ctx.
    Every leaf is a contiguous uint16 array of rows (nsym values, last 0,
    then the counter)."""

    def __init__(self, qctx: int) -> None:
        t = TABLES
        self.partition = {
            w: _adaptive(t[_PARTITION_CDF_KEY[w]])
            for w in (8, 16, 32, 64, 128)
        }
        self.skip = _adaptive(t["skip"])
        self.kf_y = _adaptive(t["kf_y_mode"])
        self.uv_mode = _adaptive(t["uv_mode"])
        self.uv_mode_cfl = _adaptive(t["uv_mode_cfl"])
        self.angle_delta = _adaptive(t["angle_delta"])
        self.txb_skip = _adaptive(t["txb_skip"][qctx])  # (5, 13, 3)
        self.eob_pt = {
            n: _adaptive(t[_EOB_PT_KEY[n]][qctx])  # (2, 2, nsym+1)
            for n in (16, 32, 64, 128, 256, 512, 1024)
        }
        self.eob_extra = _adaptive(t["eob_extra"][qctx])  # (5, 2, 9, 3)
        self.coeff_base_eob = _adaptive(t["coeff_base_eob"][qctx])  # (5,2,4,4)
        self.coeff_base = _adaptive(t["coeff_base"][qctx])  # (5, 2, 42, 5)
        self.coeff_br = _adaptive(t["coeff_br"][qctx])  # (5, 2, 21, 5)
        self.dc_sign = _adaptive(t["dc_sign"][qctx])  # (2, 3, 3)
        self.cfl_sign = _adaptive(t["cfl_sign"])  # (9,)
        self.cfl_alpha = _adaptive(t["cfl_alpha"])  # (6, 17)
        self.intra_ext_tx1 = _adaptive(t["intra_ext_tx_set1"])  # (4, 13, 8)
        self.intra_ext_tx2 = _adaptive(t["intra_ext_tx_set2"])  # (4, 13, 6)
        # tx_size depth cdfs: (4 cats, 3 ctxs, 4) — cat 0 rows code 2
        # symbols (counter lives at index 2), cats 1-3 code 3 (counter at
        # index 3); one uniform array so the native pack stride is fixed.
        self.tx_size = np.zeros((4, 3, 4), dtype=np.uint16)
        self.tx_size[..., :3] = t["tx_size"]
        # palette (spec 5.11.46-50 defaults)
        self.palette_y_mode = _adaptive(t["palette_y_mode"])    # (7,3,3)
        self.palette_uv_mode = _adaptive(t["palette_uv_mode"])  # (2,3)
        self.palette_y_size = _adaptive(t["palette_y_size"])    # (7,8)
        self.palette_y_ci = {
            n: _adaptive(t[f"palette_y_color_index_{n}"])
            for n in range(2, 9)
        }
        # filter intra (spec 5.11.24): use bit per BLOCK_SIZES_ALL + mode
        self.filter_intra_use = _adaptive(t["filter_intra_use"])  # (22, 3)
        self.filter_intra_mode = _adaptive(t["filter_intra_mode"])  # (6,)
        # loop restoration (spec 5.11.32): per-RU restoration_type CDFs
        if "wiener_restore" in t:
            self.wiener_restore = _adaptive(t["wiener_restore"])  # (3,)
            self.sgrproj_restore = _adaptive(t["sgrproj_restore"])
            self.switchable_restore = _adaptive(t["switchable_restore"])


@dataclass
class PlaneState:
    """Per-plane entropy context lines (4x4 granularity)."""

    above_lvl: np.ndarray  # cul levels, frame-width mi units
    left_lvl: np.ndarray  # one SB tall (16 units)
    above_dc: np.ndarray  # dc sign categories
    left_dc: np.ndarray


class TileEncoder:
    """Encodes one tile (round 1: the whole frame is one tile)."""

    def __init__(
        self,
        planes: List[np.ndarray],  # [y, u, v] int arrays (h, w)
        qindex: int,
        bitdepth: int = 8,
        speed: int = 9,
        plan: Optional[dict] = None,  # device plan arrays (encode_tpu)
        u_ac_delta_q: int = 0,
        dec: Optional[dict] = None,  # decision record/replay (see C mirror)
        screen_tools: bool = False,  # frame allow_screen_content_tools
        filter_intra: bool = False,  # seq enable_filter_intra
        lr: Optional[dict] = None,   # loop restoration (see _emit_lr)
        sb128: bool = False,         # seq use_128x128_superblock
    ) -> None:
        if qindex == 0:
            sb128 = False  # lossless path stays on the 64px grid
        self.sb128 = bool(sb128)
        self.sbn = 32 if sb128 else 16  # superblock height/width in mi
        self._lm = self.sbn - 1         # left-context index mask
        self.screen_tools = bool(screen_tools)
        # frequency-weighted RDOQ strength (see _rdoq; mirrors
        # oav1tile.c): 0 on screen-content frames whose value IS the
        # high-frequency detail, else 2; OAVIF_RDOQ_HF overrides
        hf_env = os.environ.get("OAVIF_RDOQ_HF")
        self._rdoq_hf = (
            max(0.0, float(hf_env)) if hf_env is not None
            else (0.0 if screen_tools else 2.0)
        )
        hfu_env = os.environ.get("OAVIF_RDOQ_HF_UV")
        self._rdoq_hf_uv = (
            max(0.0, float(hfu_env)) if hfu_env is not None
            else self._rdoq_hf
        )
        self.filter_intra = bool(filter_intra)
        # loop restoration config: {"types": (t0,t1,t2) coded
        # FrameRestorationType per plane, "unit_shift": 0..2,
        # "wiener": {plane: [[6-tap list or None] per unitCol] per
        # unitRow}}. The tile must span the frame (1-tile requirement —
        # RU coordinates are frame-level).
        self.lr = lr
        # per-pass/tap subexp refs (spec RefLrWiener), reset per tile
        self._lr_ref = None
        self._dec = dec
        self._dec_mode = int(dec["mode"]) if dec else 0
        self._dec_pos = 0
        self._dec_out: List[int] = []
        self.planes = planes
        self.qindex = qindex
        self.lossless = qindex == 0
        self.bitdepth = bitdepth
        self.speed = speed
        self.plan = plan or {}
        # 16-blocks coded with the device stage's levels (plan["lv16"])
        self.lv16_consumed = 0
        h, w = planes[0].shape
        self.w, self.h = w, h
        self.mi_cols = 2 * ((w + 7) >> 3)
        self.mi_rows = 2 * ((h + 7) >> 3)
        self.sb_cols = (self.mi_cols + self.sbn - 1) // self.sbn
        self.sb_rows = (self.mi_rows + self.sbn - 1) // self.sbn

        from .entropy.fast import NativeEncoder, get_lib

        if get_lib() is not None:
            self.enc = _NativeShim(NativeEncoder())
        else:
            self.enc = _PyShim(RangeEncoder())
        self.cdf = CdfBank(coeff_q_ctx(qindex))
        self._scan_cache = {
            n: np.ascontiguousarray(TABLES[f"scan_{n}x{n}"], dtype=np.int32)
            for n in (4, 8, 16, 32)
        }
        # RDOQ bit-cost tables from the INITIAL (pre-adaptation) CDFs —
        # computed here, before any symbol is coded.
        self._cost_base = _icdf_cost_rows(self.cdf.coeff_base, 4)
        self._cost_base_eob = _icdf_cost_rows(self.cdf.coeff_base_eob, 3)
        self._cost_br = _icdf_cost_rows(self.cdf.coeff_br, 4)
        self._cost_eob_extra = _icdf_cost_rows(self.cdf.eob_extra, 2)
        self._cost_eob_pt = {
            n: _icdf_cost_rows(self.cdf.eob_pt[n], _EOB_PT_NSYM[n])
            for n in self.cdf.eob_pt
        }
        self._cost_txsz = _icdf_cost_rows(self.cdf.tx_size, 3)
        self._cost_cache = {}

        # reconstruction buffers (padded to mi grid)
        pw, ph = self.mi_cols * 4, self.mi_rows * 4
        self.recon = [np.zeros((ph, pw), dtype=np.int32) for _ in planes]
        self.src = []
        for p in planes:
            buf = np.zeros((ph, pw), dtype=np.int32)
            buf[:h, :w] = p
            # edge-replicate into the padding so edge blocks predict sanely
            buf[:h, w:] = buf[:h, w - 1 : w]
            buf[h:, :] = buf[h - 1 : h, :]
            self.src.append(buf)

        # context lines (left lines span one superblock column: sbn mi)
        sbn = self.sbn
        self.above_part = np.zeros(self.mi_cols, dtype=np.uint8)
        self.left_part = np.zeros(sbn, dtype=np.uint8)
        self.above_skip = np.zeros(self.mi_cols, dtype=np.uint8)
        self.left_skip = np.zeros(sbn, dtype=np.uint8)
        self.above_mode = np.full(self.mi_cols, DC_PRED, dtype=np.uint8)
        # palette context lines: color array (ascending) or None, per mi
        self.above_pal = [None] * self.mi_cols
        self.left_pal = [None] * sbn
        self.left_mode = np.full(sbn, DC_PRED, dtype=np.uint8)
        self.above_txw = np.zeros(self.mi_cols, dtype=np.int32)
        self.left_txh = np.zeros(sbn, dtype=np.int32)
        self.pstate = [
            PlaneState(
                above_lvl=np.zeros(self.mi_cols, dtype=np.int32),
                left_lvl=np.zeros(sbn, dtype=np.int32),
                above_dc=np.zeros(self.mi_cols, dtype=np.int32),
                left_dc=np.zeros(sbn, dtype=np.int32),
            )
            for _ in planes
        ]

        self.dq_dc = dc_q(qindex, bitdepth)
        self.dq_ac = ac_q(qindex, bitdepth)
        # chroma AC delta-q (frame header u_ac_delta_q; DC delta stays 0):
        # bits shift from chroma to luma, where the metric lives
        self.u_ac_delta_q = u_ac_delta_q
        quv = min(max(qindex + u_ac_delta_q, 0), 255)
        self.dq_ac_uv = ac_q(quv, bitdepth) if u_ac_delta_q else self.dq_ac
        self.blocks = []  # (mi_r, mi_c, size_px, skip, y_tx) for post-filters

        # Variance-adaptive λ (SSIM-style rate allocation, the behavior
        # behind the reference's default --tune iq/ssim): the SSIMULACRA2
        # error is dominated by the WORST local regions (4-norm terms), so
        # bits move from masked high-variance blocks toward flat ones.
        # λ_block = λ · sqrt((var_b + C)/(mean_var + C)), clamp [1/4, 4].
        # sqrt/div are IEEE-exact → identical in C and NumPy.
        lsrc = self.src[0].astype(np.int64)
        vh, vw = (h // 16) * 16, (w // 16) * 16
        self._mean_var = 0.0
        if vh >= 16 and vw >= 16 and not self.lossless:
            blk = lsrc[:vh, :vw].reshape(vh // 16, 16, vw // 16, 16)
            s1 = blk.sum(axis=(1, 3), dtype=np.int64)
            s2 = (blk * blk).sum(axis=(1, 3), dtype=np.int64)
            var_num = 256 * s2 - s1 * s1  # n·Σd² − (Σd)², n = 256
            # exact integer total, then one float division → identical in C
            self._mean_var = float(int(var_num.sum())) / (
                65536.0 * float(var_num.size)
            )
        self._lam_scale = 1.0  # per-block, set in _encode_block

    # -- intra edge availability (square-only z-order, spec BlockDecoded) ----

    def _has_top_right(self, r: int, c: int, n_mi: int) -> bool:
        """True if the 4x4s above-right of the block are decoded: TL/BL
        children always (the row above resp. the TR sibling's bottom is
        done), TR children inherit the parent, BR children never; at the
        superblock root the above-right SB must exist."""
        size = n_mi
        rr, cc = r, c
        while size < self.sbn:
            parent = size * 2
            top = (rr % parent) < size
            left = (cc % parent) < size
            if left:
                return True  # TL or BL child
            if not top:
                return False  # BR child
            size = parent  # TR child: ask the parent
        return rr > 0 and ((cc | self._lm) + 1) < self.mi_cols

    def _has_bottom_left(self, r: int, c: int, n_mi: int) -> bool:
        size = n_mi
        rr, cc = r, c
        while size < self.sbn:
            parent = size * 2
            top = (rr % parent) < size
            left = (cc % parent) < size
            if top and left:
                return cc > 0  # TL child: left-neighbour subtree is decoded
            if top or not left:
                return False  # TR or BR child
            size = parent  # BL child: ask the parent
        return False  # below-left SB is in a later SB row

    def _edge_counts(self, r: int, c: int, size: int):
        """(num_top_right, num_bottom_left) pixel counts for build_edges."""
        n_mi = size // 4
        ntr = nbl = 0
        if self._has_top_right(r, c, n_mi):
            ntr = max(0, min(size, (self.mi_cols - c - n_mi) * 4))
        if self._has_bottom_left(r, c, n_mi):
            nbl = max(0, min(size, (self.mi_rows - r - n_mi) * 4))
        return ntr, nbl

    # -- symbol helpers -------------------------------------------------------

    def _sym(self, cdf_row: np.ndarray, s: int) -> None:
        self.enc.sym_adapt(cdf_row, s)

    # -- top level ------------------------------------------------------------

    def _dec_flush(self) -> None:
        if self._dec is not None and self._dec_mode == 1:
            n = len(self._dec_out)
            self._dec["buf"][:n] = self._dec_out
            self._dec["len"] = n

    def encode(self) -> bytes:
        if self.lr:
            self._lr_ref = {
                p: [[3, -7, 15], [3, -7, 15]]
                for p in range(len(self.planes))
            }
            # SGRPROJ xqd refs: Sgrproj_Xqd_Mid = {-32, 31} — C-truncated
            # midpoints (-96+31)/2 and (-32+95)/2 (libaom
            # set_default_sgrproj). A 32 mid makes BOTH system decoders
            # read every xqd[1] one LOW (effective xq1 = 129 - w1), which
            # is invisible except at rounding-boundary pixels — that was
            # the long-standing ±1 "z-plateau" artifact, root-caused by
            # multi-weight window intersection + libaom arbitration.
            self._lr_sgr_ref = {
                p: [-32, 31] for p in range(len(self.planes))
            }
        for sb_r in range(self.sb_rows):
            self.left_part[:] = 0
            self.left_skip[:] = 0
            self.left_mode[:] = DC_PRED
            self.left_txh[:] = 0
            self.left_pal = [None] * self.sbn
            for ps in self.pstate:
                ps.left_lvl[:] = 0
                ps.left_dc[:] = 0
            for sb_c in range(self.sb_cols):
                if self.lr:
                    self._emit_lr(sb_r * self.sbn, sb_c * self.sbn)
                self._encode_partition(sb_r * self.sbn, sb_c * self.sbn,
                                       self.sbn * 4)
        self._dec_flush()
        return self.enc.done()

    # -- loop restoration syntax (spec 5.11.31 read_lr) -----------------------

    def _emit_lr(self, r: int, c: int) -> None:
        """Code the restoration units whose top-left lands in this SB
        (spec read_lr at the superblock root, before the partition)."""
        types = self.lr["types"]
        shift = self.lr["unit_shift"]
        for plane in range(len(self.planes)):
            if types[plane] == 0:
                continue
            unit = 256 >> (2 - shift)  # 4:4:4: chroma size == luma size
            urows = max((self.h + (unit >> 1)) // unit, 1)
            ucols = max((self.w + (unit >> 1)) // unit, 1)
            ur0 = (r * 4 + unit - 1) // unit
            ur1 = min(urows, ((r + self.sbn) * 4 + unit - 1) // unit)
            uc0 = (c * 4 + unit - 1) // unit
            uc1 = min(ucols, ((c + self.sbn) * 4 + unit - 1) // unit)
            for ur in range(ur0, ur1):
                for uc in range(uc0, uc1):
                    self._emit_lr_unit(plane, ur, uc)

    def _emit_lr_unit(self, plane: int, ur: int, uc: int) -> None:
        """read_lr_unit (spec 5.11.32): the frame restoration type picks
        the flag alphabet — WIENER(2)/SGRPROJ(3) code a use bool,
        SWITCHABLE(1) codes the unit's type with the 3-ary
        switchable_restore CDF — then the params for the chosen kind."""
        ftype = self.lr["types"][plane]
        taps = self.lr.get("wiener", {}).get(plane)
        taps = taps[ur][uc] if taps is not None else None
        entry = self.lr.get("sgrproj", {}).get(plane)
        entry = entry[ur][uc] if entry is not None else None
        if ftype == 1:
            kind = 1 if taps is not None else (2 if entry is not None else 0)
            self._sym(self.cdf.switchable_restore, kind)
            if kind == 1:
                self._emit_wiener_params(plane, taps)
            elif kind == 2:
                self._emit_sgr_params(plane, entry)
            return
        if ftype == 3:
            self._sym(self.cdf.sgrproj_restore,
                      1 if entry is not None else 0)
            if entry is not None:
                self._emit_sgr_params(plane, entry)
            return
        assert ftype == 2, "WIENER, SGRPROJ or SWITCHABLE"
        self._sym(self.cdf.wiener_restore, 1 if taps is not None else 0)
        if taps is not None:
            self._emit_wiener_params(plane, taps)

    def _emit_wiener_params(self, plane: int, taps) -> None:
        # wiener_filter_coefficients (spec 5.11.33): vertical pass then
        # horizontal pass, 3 signed taps each, subexp-ref coded. Chroma
        # planes never code tap 0 (firstCoeff = 1; the outermost tap is
        # implicitly 0, i.e. a 5-tap filter).
        mins, maxs, ks = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
        j0 = 0 if plane == 0 else 1
        for p2 in range(2):
            ref = self._lr_ref[plane][p2]
            for j in range(j0, 3):
                v = int(taps[p2 * 3 + j])
                self._enc_signed_subexp_ref(
                    mins[j], maxs[j] + 1, ks[j], ref[j], v
                )
                ref[j] = v

    def _emit_sgr_params(self, plane: int, entry) -> None:
        """SGRPROJ params (spec 5.11.34 read_sgrproj_filter): 4-bit set
        index, per-pass projection weight xqd coded signed-subexp
        against running refs. A pass with radius 0 codes no weight:
        xqd[0] = 0 / xqd[1] = Clip3(-32, 95, 128 - xqd[0]) (always 95
        for legal xqd[0]) — and the REFS take those values."""
        from .restoration import SGR_PARAMS

        set_idx, w0, w1 = entry
        self.enc.write_literal(set_idx, 4)
        r0, _, r1, _ = SGR_PARAMS[set_idx]
        ref = self._lr_sgr_ref[plane]
        if r0:
            self._enc_signed_subexp_ref(-96, 32, 4, ref[0], int(w0))
            ref[0] = int(w0)
        else:
            assert w0 == 0
            ref[0] = 0
        if r1:
            self._enc_signed_subexp_ref(-32, 96, 4, ref[1], int(w1))
            ref[1] = int(w1)
        else:
            assert w1 == 95
            ref[1] = 95

    def _enc_signed_subexp_ref(self, low, high, k, ref, v):
        self._enc_unsigned_subexp_ref(high - low, k, ref - low, v - low)

    def _enc_unsigned_subexp_ref(self, mx, k, r, v):
        if (r << 1) <= mx:
            self._enc_subexp_bool(mx, k, _recenter(r, v))
        else:
            self._enc_subexp_bool(mx, k, _recenter(mx - 1 - r, mx - 1 - v))

    def _enc_subexp_bool(self, num_syms, k, v):
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                self._enc_uniform_bool(num_syms - mk, v - mk)
                return
            if v >= mk + a:
                self.enc.bool_q15(1, 16384)
                i += 1
                mk += a
            else:
                self.enc.bool_q15(0, 16384)
                self.enc.write_literal(v - mk, b2)
                return

    def _enc_uniform_bool(self, n, v):
        """ns(n) with equiprobable bool bits (spec 4.10.7 semantics)."""
        if n <= 1:
            return
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            self.enc.write_literal(v, w - 1)
        else:
            self.enc.write_literal((v + m) >> 1, w - 1)
            self.enc.write_literal((v + m) & 1, 1)

    # -- partitions -----------------------------------------------------------

    def _partition_ctx(self, r: int, c: int, size: int) -> int:
        bsl = {8: 0, 16: 1, 32: 2, 64: 3, 128: 4}[size]
        above = (int(self.above_part[c]) >> bsl) & 1
        left = (int(self.left_part[r & self._lm]) >> bsl) & 1
        return left * 2 + above

    def _update_part_ctx(self, r: int, c: int, size: int, sub: int) -> None:
        n_mi = size // 4
        byte = _PART_CTX_BYTE[sub]
        self.above_part[c : c + n_mi] = byte
        self.left_part[(r & self._lm) : (r & self._lm) + n_mi] = byte

    def _partition_bool_icdf(self, cdf: list, size: int, members) -> int:
        """Derived psplit for split_or_horz / split_or_vert (spec): the sum
        of the partition CDF widths of the named partition types."""
        nsym = len(cdf) - 1
        widths = []
        prev = 32768
        for s in range(nsym):
            widths.append(prev - cdf[s])
            prev = cdf[s]
        return sum(widths[m] for m in members if m < nsym)

    def _dec_part_replay(self, r: int, c: int, size: int):
        """Replay a recorded host partition pick (128/64/32 nodes incl.
        the rect duel); None = caller must compute. Pseudo size byte 2 in
        the tag is disjoint from every real block tag. Mirrors
        oav1tile.c dec_part_replay."""
        if self._dec_mode != 2:
            return None
        buf, pos = self._dec["buf"], self._dec_pos
        tag = (r << 16) | (c << 8) | 2
        if (pos + 10 <= int(self._dec["len"]) and int(buf[pos]) == tag
                and int(buf[pos + 1]) == size):
            self._dec_pos += 10
            return int(buf[pos + 2])
        self._dec_mode = 0  # sequence diverged: disarm for the tile
        return None

    def _dec_part_record(self, r: int, c: int, size: int, part: int) -> None:
        if self._dec_mode == 1:
            self._dec_out += [(r << 16) | (c << 8) | 2, size, part,
                              0, 0, 0, 0, 0, 0, 0]

    def _encode_partition(self, r: int, c: int, size: int) -> None:
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        half_mi = size // 8
        has_rows = (r + half_mi) < self.mi_rows
        has_cols = (c + half_mi) < self.mi_cols

        # policy: split to 32x32 inside, then RD-decide 32 vs 4x16;
        # split partial nodes; NONE at small leaves
        if has_rows and has_cols:
            if self.lossless:
                part = PARTITION_SPLIT
            elif size == 128:
                # 128 root (sb128 frames): NONE only when the whole
                # region is near-flat AND fits the mi grid (hanging
                # blocks force SPLIT, the 32/64 convention)
                if (r + 32 <= self.mi_rows and c + 32 <= self.mi_cols
                        and not self._force_sb128_none_test):
                    part = self._dec_part_replay(r, c, 128)
                    if part is None:
                        part = self._choose_partition128(r, c)
                        self._dec_part_record(r, c, 128, part)
                elif self._force_sb128_none_test and (
                        r + 32 <= self.mi_rows and c + 32 <= self.mi_cols):
                    part = PARTITION_NONE
                else:
                    part = PARTITION_SPLIT
            elif (size == 64 and r + 16 <= self.mi_rows
                  and c + 16 <= self.mi_cols):
                part = self._planned_part64(r, c)
                if part is None:
                    part = self._dec_part_replay(r, c, 64)
                    if part is None:
                        part = self._choose_partition64(r, c)
                        self._dec_part_record(r, c, 64, part)
            elif size > 32:
                part = PARTITION_SPLIT
            elif size == 32 and (
                r + 8 > self.mi_rows or c + 8 > self.mi_cols
            ):
                # hasRows/hasCols allow a NONE block hanging past the mi
                # grid (spec 5.11.4); always split instead so recon stays
                # inside the mi-grid buffers (encoder choice, conformant)
                part = PARTITION_SPLIT
            elif size == 32 and self._force_rect_test:
                part = 1  # PARTITION_HORZ — test-gated rect slice
            elif size == 32 and self.speed <= 9 and self.qindex <= 90:
                part = None if self._enable_rect else (
                    self._planned_part32(r, c)
                )
                if part is None:
                    part = self._dec_part_replay(r, c, 32)
                if part is None:
                    # splitting pays at high quality (closer prediction
                    # edges beat the extra signaling); at coarse q it only
                    # adds overhead — measured on the rate/score curves
                    part = self._choose_partition32(r, c)
                    self._dec_part_record(r, c, 32, part)
            else:
                part = PARTITION_NONE
            ctx = self._partition_ctx(r, c, size)
            cdf = self.cdf.partition[size][ctx]
            self._sym(cdf, part)
            if part == 1:  # HORZ: two (size x size/2) px blocks
                self._encode_block_rect(r, c, size, size // 2)
                if r + size // 8 < self.mi_rows:
                    self._encode_block_rect(r + size // 8, c,
                                            size, size // 2)
                self._update_part_ctx_rect(r, c, size, size, size // 2)
                return
            if part == 2:  # VERT: two (size/2 x size) px blocks
                self._encode_block_rect(r, c, size // 2, size)
                if c + size // 8 < self.mi_cols:
                    self._encode_block_rect(r, c + size // 8,
                                            size // 2, size)
                self._update_part_ctx_rect(r, c, size, size // 2, size)
                return
        elif not has_rows and not has_cols:
            part = PARTITION_SPLIT  # implicit, nothing coded
        else:
            part = PARTITION_SPLIT if size > 8 else PARTITION_NONE
            ctx = self._partition_ctx(r, c, size)
            cdf = self.cdf.partition[size][ctx]
            if size > 8:
                if has_cols:  # bottom clipped: split_or_horz
                    # {VERT, SPLIT, HORZ_A, VERT_A, VERT_B, VERT_4}
                    members = (2, 3, 4, 6, 7, 9)
                else:  # right clipped: split_or_vert
                    # {HORZ, SPLIT, HORZ_A, HORZ_B, VERT_A, HORZ_4}
                    members = (1, 3, 4, 5, 6, 8)
                psum = self._partition_bool_icdf(cdf, size, members)
                derived = np.array([psum, 0, 0], dtype=np.uint16)
                self.enc.sym_noadapt(derived, 1)  # always split
            # at size 8: partition would be HORZ/VERT bool... 8x8 partial
            # cannot happen (mi dims are even), assert:
            else:
                raise AssertionError("partial 8x8 block impossible")

        if part == PARTITION_SPLIT:
            sub = size // 2
            sub_mi = half_mi
            if size == 8:
                # lossless splits 8x8 into four 4x4 BLOCKS (no further
                # partition symbols at size 4 — spec decode_partition)
                assert self.lossless
                for dr in (0, 1):
                    for dc in (0, 1):
                        if r + dr < self.mi_rows and c + dc < self.mi_cols:
                            self._encode_block(r + dr, c + dc, 4)
                            self._update_part_ctx(r + dr, c + dc, 4, 4)
                return
            self._encode_partition(r, c, sub)
            self._encode_partition(r, c + sub_mi, sub)
            self._encode_partition(r + sub_mi, c, sub)
            self._encode_partition(r + sub_mi, c + sub_mi, sub)
        else:
            self._encode_block(r, c, size)
            self._update_part_ctx(r, c, size, size)

    # -- blocks ---------------------------------------------------------------

    def _choose_y_mode(self, r: int, c: int, size: int):
        """Pick the Y mode by prediction SSD over the source block (fast
        path; full RD runs on TPU in the batched encoder)."""
        x, y = c * 4, r * 4
        have_above = r > 0
        have_left = c > 0
        src = self.src[0][y : y + size, x : x + size]
        ntr, nbl = self._edge_counts(r, c, size)
        above, left = build_edges(
            self.recon[0], x, y, size, size, have_above, have_left,
            self.bitdepth, num_top_right=ntr, num_bottom_left=nbl,
        )
        from .consts import (
            D45_PRED,
            D67_PRED,
            D113_PRED,
            D135_PRED,
            D157_PRED,
            D203_PRED,
            H_PRED,
            PAETH_PRED,
            SMOOTH_H_PRED,
            SMOOTH_PRED,
            SMOOTH_V_PRED,
            V_PRED,
        )

        # speed presets control search breadth (SURVEY.md §7): the smooth
        # variants measure rate-positive at the default; directional modes
        # only pay off below speed 9 (their residuals want ADST, not DCT)
        candidates = [DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED]
        if self.speed <= 9:
            candidates += [SMOOTH_V_PRED, SMOOTH_H_PRED]
        n_base = len(candidates)
        if self.speed <= 8:
            candidates += [D45_PRED, D135_PRED]
        if self.speed <= 6:
            candidates += [D67_PRED, D113_PRED, D157_PRED, D203_PRED]
        best = None
        for i, m in enumerate(candidates):
            pred = predict(m, above, left, size, size, have_above, have_left, bitdepth=self.bitdepth)
            ssd = int(((src - pred) ** 2).sum())
            if i >= n_base:
                # extended modes carry a symbol-rate premium (rarer kf_y
                # symbols + angle_delta): require a clear distortion win
                ssd += ssd >> 3
            if best is None or ssd < best[0]:
                best = (ssd, m, pred)
        return best[1], best[2], above, left

    def _src_mode_ssd(self, x: int, y: int, size: int, h: int = 0) -> int:
        """Best-candidate-mode prediction SSD using *source* pixels as
        edges (children aren't reconstructed yet at decision time — the
        standard partition-RD approximation). `h` (default size) allows
        rectangular candidates."""
        from .consts import (
            H_PRED, PAETH_PRED, SMOOTH_H_PRED, SMOOTH_PRED, SMOOTH_V_PRED,
            V_PRED,
        )

        w = size
        if h == 0:
            h = size
        have_above, have_left = y > 0, x > 0
        above, left = build_edges(
            self.src[0], x, y, w, h, have_above, have_left, self.bitdepth
        )
        srcb = self.src[0][y : y + h, x : x + w]
        # keep this NARROW (the 5 cheap modes): it only ranks split vs none,
        # and the full candidate set runs in the per-block search anyway
        cands = [DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED]
        best = None
        for m in cands:
            pred = predict(m, above, left, w, h, have_above, have_left,
                           bitdepth=self.bitdepth)
            ssd = int(((srcb - pred) ** 2).sum())
            if best is None or ssd < best:
                best = ssd
        return best

    def _choose_partition64(self, r: int, c: int) -> int:
        """NONE at 64 saves three partition symbols + three mode/skip sets
        on smooth superblocks; prefer it when one 64-wide prediction is
        nearly as good as four 32s (integer RD, mirrored in C)."""
        x, y = c * 4, r * 4
        ssd_parent = self._src_mode_ssd(x, y, 64)
        ssd_kids = 0
        for dy in (0, 32):
            for dx in (0, 32):
                ssd_kids += self._src_mode_ssd(x + dx, y + dy, 32)
        penalty = 4 * self.dq_ac * self.dq_ac
        # also require a near-flat SB (residual quantizes to ~zero): larger
        # blocks forgo CfL, which costs more than the saved signaling on
        # content with luma-correlated chroma (measured on gradients)
        flat_gate = 64 * 64 * self.dq_ac * self.dq_ac // 64
        if ssd_parent > ssd_kids + penalty or ssd_parent > flat_gate:
            return PARTITION_SPLIT
        # chroma must be near-flat too: 64 blocks can't use CfL, and
        # DC-only chroma costs more than the saved signaling unless it
        # quantizes away (measured on gradients)
        for p in range(1, len(self.planes)):
            if self._src_dc_ssd(p, x, y, 64) > flat_gate:
                return PARTITION_SPLIT
        return PARTITION_NONE

    _force_sb128_none_test = False  # test hook: force NONE at every root

    def _choose_partition128(self, r: int, c: int) -> int:
        """NONE at the 128 root saves the four 64-level partition symbols
        plus their mode/skip sets; it pays only on near-flat superblocks
        (no CfL above 32, DC-only 128 prediction). Two gates, mirrored in
        C: (a) every plane's whole-region DC residual is near the
        quantization floor, and (b) the DC parent does not lose much to
        the four 64-quadrant best-mode predictions (kills the coarse-q
        false positives where the dq^2-scaled flat gate passes anything
        - measured +15% bytes on the mixed class before this duel)."""
        x, y = c * 4, r * 4
        flat_gate = 128 * 128 * self.dq_ac * self.dq_ac // 64
        for p in range(len(self.planes)):
            if self._src_dc_ssd(p, x, y, 128) > flat_gate:
                return PARTITION_SPLIT
        ssd_parent = self._src_dc_ssd(0, x, y, 128)
        ssd_kids = 0
        for dy in (0, 64):
            for dx in (0, 64):
                ssd_kids += self._src_mode_ssd(x + dx, y + dy, 64)
        penalty = 16 * self.dq_ac * self.dq_ac
        if ssd_parent > ssd_kids + penalty:
            return PARTITION_SPLIT
        return PARTITION_NONE

    def _src_dc_ssd(self, plane: int, x: int, y: int, size: int) -> int:
        above, left = build_edges(
            self.src[plane], x, y, size, size, y > 0, x > 0, self.bitdepth,
        )
        pred = predict(DC_PRED, above, left, size, size, y > 0, x > 0,
                       bitdepth=self.bitdepth)
        d = (self.src[plane][y : y + size, x : x + size] - pred).astype(
            np.int64)
        return int((d * d).sum())

    def _choose_partition32(self, r: int, c: int) -> int:
        """NONE / HORZ / VERT / SPLIT for a full 32x32 node: best-mode
        source SSD of each arm plus a q-scaled rate penalty for the extra
        partition/mode/coeff signaling (SPLIT pays 4 header sets + 3
        partition symbols; HORZ/VERT pay 2 header sets)."""
        x, y = c * 4, r * 4
        ssd_parent = self._src_mode_ssd(x, y, 32)
        ssd_kids = 0
        for dy in (0, 16):
            for dx in (0, 16):
                ssd_kids += self._src_mode_ssd(x + dx, y + dy, 16)
        penalty = self.dq_ac * self.dq_ac
        best = (ssd_parent, PARTITION_NONE)
        if ssd_kids + penalty < best[0]:
            best = (ssd_kids + penalty, PARTITION_SPLIT)
        if not self._enable_rect:
            return best[1]
        # rect arms: the SSD proxy only NOMINATES (finer prediction
        # always lowers SSD, so the proxy over-picks rect — measured
        # +8% bytes on striped content); a nominated rect runs a REAL
        # luma D+lambda*R duel against the proxy-winning square arm.
        half_pen = penalty >> 1
        ssd_h = (self._src_mode_ssd(x, y, 32, 16)
                 + self._src_mode_ssd(x, y + 16, 32, 16))
        ssd_v = (self._src_mode_ssd(x, y, 16, 32)
                 + self._src_mode_ssd(x + 16, y, 16, 32))
        ssd_r, part_r = (ssd_h, 1) if ssd_h <= ssd_v else (ssd_v, 2)
        # quality speeds (<= 4) duel BOTH rect orientations with real RD
        # unconditionally; the default requires the SSD nomination margin
        exhaustive = self.speed <= 4
        if not exhaustive and ssd_r + half_pen >= best[0]:
            return best[1]
        lam_pix = float(
            ((self.dq_ac * self.dq_ac) >> 6) * RDOQ_KNUM
        ) / (RDOQ_KDEN * 128.0)
        save_lam = self._lam_scale
        self._lam_scale = 1.0
        try:
            d_sq, r_sq = self._try_square_arm(r, c, best[1])
            arms = [(part_r, self._try_rect_luma(x, y, part_r))]
            if exhaustive:
                other = 2 if part_r == 1 else 1
                arms.append((other, self._try_rect_luma(x, y, other)))
        finally:
            self._lam_scale = save_lam
        # header premium: each extra skip/mode/tx set ~5 bits; rect pays
        # 1 more set than NONE, SPLIT pays 3 more than NONE plus its sub
        # partition symbols (already proxied by the SSD penalty)
        hdr = 640
        n_sq = 0 if best[1] == PARTITION_NONE else 3 * hdr
        rd_best = float(d_sq) + lam_pix * float(r_sq + n_sq)
        pick = best[1]
        for part_c, (d_re, r_re) in arms:
            rd_re = float(d_re) + lam_pix * float(r_re + hdr)
            if rd_re < rd_best:
                rd_best = rd_re
                pick = part_c
        return pick

    # -- palette (spec 5.11.46-51; screen-content tool) ----------------------

    def _palette_cache(self, r: int, c: int):
        """Merged sorted cache of the above (same-SB only) and left
        neighbor palettes (spec get_palette_cache)."""
        above = self.above_pal[c] if (r & 15) > 0 else None
        left = self.left_pal[r & self._lm] if c > 0 else None
        a = list(above) if above is not None else []
        l = list(left) if left is not None else []
        out = []
        i = j = 0
        while i < len(a) and j < len(l):
            if a[i] < l[j]:
                v = a[i]; i += 1
            elif l[j] < a[i]:
                v = l[j]; j += 1
            else:
                v = a[i]; i += 1; j += 1
            if not out or out[-1] != v:
                out.append(v)
        for v in a[i:] + l[j:]:
            if not out or out[-1] != v:
                out.append(v)
        return out[:16]

    def _code_palette_colors_y(self, pal, cache):
        """palette_colors_y (spec 5.11.49): cache reuse bits, then the
        delta-coded explicit colors with the shrinking bit width."""
        bd = self.bitdepth
        pal_set = set(pal)
        reused = []
        n_read = 0
        for v in cache:
            if n_read >= len(pal):
                break
            use = 1 if (v in pal_set and v not in reused) else 0
            self.enc.bool_q15(use, 16384)  # L(1)
            if use:
                reused.append(v)
                n_read += 1
        ext = [v for v in pal if v not in reused]
        if ext:
            # aom read_palette_colors_y order: first explicit color
            # L(bd); IF more explicit colors follow: extra-precision
            # L(2), then (delta-1) at a width that shrinks with
            # av1_ceil_log2 of the REMAINING range (1<<bd) - color.
            self.enc.write_literal(ext[0], bd)
            if len(ext) > 1:
                min_bits = bd - 3

                def ceil_log2(n):
                    return (n - 1).bit_length() if n >= 2 else 0

                deltas = [ext[i] - ext[i - 1] - 1
                          for i in range(1, len(ext))]
                extra = 3
                for extra in range(4):
                    bits = min_bits + extra
                    ok = True
                    for i, dlt in enumerate(deltas):
                        if bits <= 0 or dlt >= (1 << bits):
                            ok = False
                            break
                        # decoder shrink range is maxVal - color =
                        # (1<<bd)-1-color (dav1d read_pal_plane); the
                        # off-by-one only bites when maxVal-color is a
                        # power of two
                        bits = min(bits,
                                   ceil_log2((1 << bd) - 1 - ext[i + 1]))
                    if ok:
                        break
                self.enc.write_literal(extra, 2)
                bits = min_bits + extra
                for i, dlt in enumerate(deltas):
                    self.enc.write_literal(dlt, bits)
                    bits = min(bits, ceil_log2((1 << bd) - 1 - ext[i + 1]))

    @staticmethod
    def _palette_color_ctx(idx_map, rr, cc, n):
        """(color_order, ctx) for one index-map position (spec
        get_palette_color_context)."""
        scores = [0] * 8
        if cc > 0:
            scores[idx_map[rr][cc - 1]] += 2
        if rr > 0 and cc > 0:
            scores[idx_map[rr - 1][cc - 1]] += 1
        if rr > 0:
            scores[idx_map[rr - 1][cc]] += 2
        order = list(range(n))
        sc = scores[:n]
        for i in range(min(3, n)):
            mx, mi_ = sc[i], i
            for j in range(i + 1, n):
                if sc[j] > mx:
                    mx, mi_ = sc[j], j
            if mi_ != i:
                mo = order[mi_]
                for k in range(mi_, i, -1):
                    sc[k] = sc[k - 1]
                    order[k] = order[k - 1]
                sc[i] = mx
                order[i] = mo
        hash_ = sc[0] * 1 + (sc[1] if n > 1 else 0) * 2 + (
            sc[2] if n > 2 else 0) * 2
        lookup = [-1, -1, 0, -1, -1, 4, 3, 2, 1]
        ctx = lookup[hash_] if 0 <= hash_ < len(lookup) else 0
        return order, max(ctx, 0)

    def _palette_tokens_y(self, idx_map, h, w, n, emit=True):
        """Wavefront index-map coding (spec 5.11.50). emit=False returns
        the CDF bit cost (1/128 units, initial CDFs) for the RD duel."""
        cost = 0
        nbits = (n - 1).bit_length()
        if emit:
            # first sample: av1_write_uniform (truncated binary over n
            # values — a plain CeilLog2(n) literal only matches at
            # powers of two; pinned empirically: n=3/5/6/7 desynced)
            m = (1 << nbits) - n
            v = idx_map[0][0]
            if nbits == 0:
                pass
            elif v < m:
                self.enc.write_literal(v, nbits - 1)
            else:
                self.enc.write_literal(m + ((v - m) >> 1), nbits - 1)
                self.enc.write_literal((v - m) & 1, 1)
        else:
            cost += 128 * nbits
        ci = self.cdf.palette_y_ci[n]
        for k in range(1, h + w - 1):
            j0 = min(k, w - 1)
            j1 = max(0, k - h + 1)
            for j in range(j0, j1 - 1, -1):
                rr = k - j
                order, ctx = self._palette_color_ctx(idx_map, rr, j, n)
                sym = order.index(idx_map[rr][j])
                if emit:
                    self._sym(ci[ctx], sym)
                else:
                    cost += _icdf_sym_cost_row(ci[ctx], sym)
        return cost

    def _try_palette_y(self, x, y, size):
        """Palette candidate for one block (mirrors oav1tile.c
        try_palette_y_c): exact when the block has 2..8 distinct luma
        values (distortion 0); LOSSY for up to 64 distinct values via a
        deterministic count-weighted 1-D Lloyd clustering (quantile
        init, 4 rounds, integer centers, ties to the lower center) whose
        SSE enters the duel as the palette arm's distortion — this is
        what lets palette fire on 8-bit screen content re-expanded to
        the 10-bit default. Returns (pal, idx_map, rate_est, dist) or
        None."""
        src = self.src[0][y : y + size, x : x + size]
        vals, cnt = np.unique(src, return_counts=True)
        n = len(vals)
        if n < 2 or n > 64:
            return None
        vals = vals.astype(np.int64)
        cnt = cnt.astype(np.int64)
        dist = 0
        if n <= 8:
            pal = [int(v) for v in vals]
        else:
            k = 8
            cum = np.cumsum(cnt)
            total = int(cum[-1])
            centers = np.empty(k, np.int64)
            for i in range(k):
                target = ((2 * i + 1) * total) // (2 * k)
                j = int(np.searchsorted(cum, target, side="right"))
                centers[i] = vals[min(j, n - 1)]
            # assignment = the C mirror's prefix scan: first boundary j
            # with 2v <= centers[j]+centers[j+1] (NOT searchsorted —
            # integer Lloyd centers can transiently unsort, where a
            # bisection would diverge from the scan)
            def _assign(cs):
                bounds = cs[:-1] + cs[1:]
                cond = 2 * vals[:, None] <= bounds[None, :]
                return np.where(cond.any(axis=1), cond.argmax(axis=1),
                                len(cs) - 1)

            for _ in range(4):
                idx = _assign(centers)
                sums = np.bincount(idx, weights=(vals * cnt).astype(
                    np.float64), minlength=k).astype(np.int64)
                cnts = np.bincount(idx, weights=cnt.astype(np.float64),
                                   minlength=k).astype(np.int64)
                nz = cnts > 0
                centers[nz] = (sums[nz] + cnts[nz] // 2) // cnts[nz]
            # sort (integer-rounding edge cases must not yield an
            # unsorted palette — the syntax needs ascending colors),
            # then dedup; mirrors the C
            centers = np.sort(centers)
            pal = []
            for cv in centers:
                if not pal or int(cv) != pal[-1]:
                    pal.append(int(cv))
            if len(pal) < 2:
                return None
            pala = np.asarray(pal, np.int64)
            idx = _assign(pala)
            d = vals - pala[idx]
            dist = int((d * d * cnt).sum())
        pala = np.asarray(pal, np.int64)
        bounds = pala[:-1] + pala[1:]
        cond = 2 * vals[:, None] <= bounds[None, :]
        vidx = np.where(cond.any(axis=1), cond.argmax(axis=1), len(pal) - 1)
        lut = {int(v): int(i) for v, i in zip(vals, vidx)}
        idx_map = [[lut[int(src[rr, cc])] for cc in range(size)]
                   for rr in range(size)]
        npal = len(pal)
        # rate estimate: flag+size symbols (~coarse 128*6), colors
        # (bd + deltas bits), index map (exact CDF cost)
        rate = 128 * 6 + 128 * self.bitdepth + 128 * (
            self.bitdepth - 3) * (npal - 1)
        rate += self._palette_tokens_y(idx_map, size, size, npal,
                                       emit=False)
        return pal, idx_map, rate, dist

    def _encode_block(self, r: int, c: int, size: int) -> None:
        if self.lossless:
            self._encode_block_lossless(r, c, size)
            return
        x, y = c * 4, r * 4
        n_mi = size // 4
        lr = r & self._lm

        # Device plan supplies the mode decision (source-edge search on
        # the TPU); levels still derive from recon-edge prediction
        # (quantizing a source-edge residual lets recon error random-walk
        # across blocks).
        y_mode = self._planned_mode(r, c, size)
        # a 16-grid plan entry may carry a directional NOMINEE in the
        # high byte: dueled against the non-directional winner with a
        # real D + lambda*R trial below (mirrors oav1tile.c)
        y_nominee = None
        if y_mode is not None and y_mode >= 256:
            y_nominee = (y_mode >> 8) - 1
            y_mode = y_mode & 255
        if y_mode is None:
            if size == 128:
                # 128 roots arrive only through the near-flat gate: DC
                # is the one whole-block mode worth coding there (and
                # SMOOTH weights stop at 64)
                y_mode = DC_PRED
            else:
                y_mode, _, _, _ = self._choose_y_mode(r, c, size)
        y_levels_planned = None
        # device-computed open-loop levels for planned 16-blocks (the
        # batched device encode stage, device_stage.py): consume when the
        # open-loop guard holds — recon still tracks source at the
        # prediction edges, so the source-edge residual the device
        # transformed is the one worth coding. Exact recon (dequant +
        # normative inverse of these levels) keeps the stream conformant
        # regardless.
        if (size == 16 and self.plan is not None and y_nominee is None
                and self._dec_mode != 2
                and self.plan.get("lv16") is not None):
            i16, j16 = r // 4, c // 4
            lvmap = self.plan["lv16"]
            mmask = self.plan["lv16_mask"]
            if (i16 < mmask.shape[0] and j16 < mmask.shape[1]
                    and mmask[i16, j16]):
                ha, hl = y > 0, x > 0
                a_s, l_s = build_edges(
                    self.src[0], x, y, 16, 16, ha, hl, self.bitdepth,
                )
                pred_s = predict(y_mode, a_s, l_s, 16, 16, ha, hl,
                                 bitdepth=self.bitdepth)
                a_r, l_r = build_edges(
                    self.recon[0], x, y, 16, 16, ha, hl, self.bitdepth,
                )
                pred_r = predict(y_mode, a_r, l_r, 16, 16, ha, hl,
                                 bitdepth=self.bitdepth)
                # tight guard: consume only where recon-edge and
                # source-edge predictions agree to ~1/16 LSB/px — the
                # open-loop residual then IS the closed-loop residual.
                # A looser guard (1 LSB/px average) measured a 14-point
                # SSIMULACRA2 collapse on 1/f content at fine quantizers
                # (the per-block drift compounds through the prediction
                # chain); at this threshold the consumed blocks are
                # provably-safe and the rest fall back to the exact
                # closed-loop path.
                if int(np.abs(pred_r - pred_s).sum()) <= 16:
                    y_levels_planned = (
                        lvmap[i16, j16].astype(np.int64).reshape(16, 16)
                    )

        # cross-probe decision replay (mirrors oav1tile.c: per block
        # [tag, y_depth, tt0..3, uv_mode, a_u, a_v, y_mode])
        rep = None
        if self._dec_mode == 2:
            buf, pos = self._dec["buf"], self._dec_pos
            tag = (r << 16) | (c << 8) | size
            if pos + 10 <= int(self._dec["len"]) and int(buf[pos]) == tag:
                rep = [int(v) for v in buf[pos : pos + 10]]
                self._dec_pos += 10
                y_mode = rep[9]  # the recorded duel winner
                y_nominee = None
            else:
                self._dec_mode = 0

        # --- plan residuals: luma first (CfL predicts chroma from the
        # reconstructed luma of this block), then chroma ---
        tx = min(size, 64)
        can_code_coeffs = size >= 8  # tx_type signaled for tx <= 16
        lo, hi = 0, (1 << self.bitdepth) - 1
        have_above, have_left = y > 0, x > 0

        ntr, nbl = self._edge_counts(r, c, size)

        def plane_pred(plane, mode):
            above, left = build_edges(
                self.recon[plane], x, y, tx, tx,
                have_above, have_left, self.bitdepth,
                num_top_right=ntr, num_bottom_left=nbl,
            )
            return predict(
                mode, above, left, tx, tx, have_above, have_left,
                bitdepth=self.bitdepth,
            )

        def plane_levels(plane, pred):
            if not can_code_coeffs:
                return np.zeros((tx, tx), dtype=np.int64)
            src = self.src[plane][y : y + tx, x : x + tx]
            return self._quantize(src - pred, tx, ptype=0 if plane == 0 else 1)

        # per-block λ scale from source-luma variance (masking model)
        if self._mean_var > 0.0:
            blk = self.src[0][y : y + size, x : x + size].astype(np.int64)
            n_ = size * size
            s1 = int(blk.sum())
            s2 = int((blk * blk).sum())
            var_b = float(n_ * s2 - s1 * s1) / float(n_ * n_)
            sc = np.sqrt((var_b + 16.0) / (self._mean_var + 16.0))
            self._lam_scale = float(min(max(sc, 0.25), 4.0))
        else:
            self._lam_scale = 1.0

        # --- palette duel (screen-content frames): an exact-palette
        # candidate (2..8 distinct luma values) against the normal
        # depth-0 path by D + lambda*R — palette distortion is ZERO and
        # its rate is the real CDF cost of the index map ---
        use_palette = None
        if (self.screen_tools and 8 <= size <= 64
                and y_levels_planned is None and can_code_coeffs):
            if rep is not None:
                # replayed palette decision (depth slot 9 marks it): the
                # candidate is deterministic from the source, so only
                # the duel is skipped
                if rep[1] == 9:
                    cand = self._try_palette_y(x, y, size)
                    if cand is not None:
                        use_palette = (cand[0], cand[1])
                        y_mode = DC_PRED
                        y_nominee = None
                    else:
                        rep = None
                        self._dec_mode = 0
            else:
                cand = self._try_palette_y(x, y, size)
                if cand is not None:
                    pal_c, idx_map_c, rate_pal, dist_pal = cand
                    tN = self._try_luma_depth(x, y, size, 0, y_mode, ntr,
                                              nbl)
                    lam_pix = float(
                        ((self.dq_ac * self.dq_ac) >> 6) * RDOQ_KNUM
                    ) / (RDOQ_KDEN * 128.0) * self._lam_scale
                    # lossy candidates carry their clustering SSE as
                    # distortion (zero for exact 2..8-value blocks)
                    if float(dist_pal) + lam_pix * float(rate_pal) < (
                            float(tN[1]) + lam_pix * float(tN[2])):
                        use_palette = (pal_c, idx_map_c)
                        y_mode = DC_PRED
                        y_nominee = None

        # --- luma tx-depth RD: tx == block vs 4-way split (TX_MODE_SELECT).
        # Each candidate runs the real per-txb encode (prediction from the
        # in-progress recon, RDOQ, recon) and is judged by pixel SSE +
        # λ·(CDF rate estimate). depth 1 is tried when the block is coded
        # and the speed preset allows it.
        if use_palette is not None:
            pal_c, idx_map_c = use_palette
            pal_arr = np.asarray(pal_c, dtype=np.int32)
            y_pred = pal_arr[np.asarray(idx_map_c, dtype=np.int32)]
            y_levels = np.zeros((tx, tx), dtype=np.int64)
            y_depth = 0
            y_jobs = [(y_levels, y_pred, "dct_dct", x, y)]
            y_recon = np.clip(y_pred, lo, hi)
        elif y_levels_planned is not None:
            # device plan supplies 32x32 levels at depth 0
            self.lv16_consumed += 1
            y_pred = plane_pred(0, y_mode)
            y_levels = y_levels_planned.astype(np.int64)
            y_depth = 0
            y_jobs = [(y_levels, y_pred, "dct_dct", x, y)]
            if np.any(y_levels):
                y_recon = np.clip(
                    y_pred + self._dequant_inv(y_levels, tx, "dct_dct"), lo, hi
                )
            else:
                y_recon = np.clip(y_pred, lo, hi)
        elif rep is not None:
            y_depth = rep[1]
            trial = self._try_luma_depth(
                x, y, size, y_depth, y_mode, ntr, nbl, forced_tt=rep[2:6]
            )
            if trial is None:
                # replayed split is all-zero at this q: skip semantics
                # demand the depth-0 whole-block prediction
                y_depth = 0
                trial = self._try_luma_depth(
                    x, y, size, 0, y_mode, ntr, nbl, forced_tt=[0, 0, 0, 0]
                )
            y_jobs, _, _, y_recon = trial
        else:
            pre0 = None
            if y_nominee is not None:
                # directional-nominee duel: real rate, not SSD. +600 rate
                # units (~4.7 bits) models the rarer kf_y symbol + the
                # angle_delta symbol the directional side pays.
                tA = self._try_luma_depth(x, y, size, 0, y_mode, ntr, nbl)
                tB = self._try_luma_depth(
                    x, y, size, 0, y_nominee, ntr, nbl
                )
                lam_pix = float(
                    ((self.dq_ac * self.dq_ac) >> 6) * RDOQ_KNUM
                ) / (RDOQ_KDEN * 128.0) * self._lam_scale
                # only directional nominees pay the angle_delta +
                # kf_y-rarity premium
                prem = 600 if 3 <= y_nominee <= 8 else 0
                rd_a = float(tA[1]) + lam_pix * float(tA[2])
                rd_b = float(tB[1]) + lam_pix * float(tB[2] + prem)
                if tB is not None and rd_b < rd_a:
                    y_mode = y_nominee
                    pre0 = tB
                else:
                    pre0 = tA
            # filter-intra duel (spec 7.11.2.3 recursive filter): on an
            # eligible (<= 32) block, nominate the best of the 5 filter
            # modes by prediction SSD against the INCUMBENT's prediction
            # (filter intra is coded as DC + flag, so it can replace any
            # winner); the nominee earns a real D + lambda*R trial only
            # when it beats the incumbent's SSD by > 10%.
            force_fi = getattr(self, "_force_fi_test", None)
            if (self.filter_intra and size <= 32 and force_fi is not None):
                y_mode = FILTER_BASE + int(force_fi)
            elif (self.filter_intra and size <= 32 and self.speed <= 9):
                above_b, left_b = build_edges(
                    self.recon[0], x, y, tx, tx, have_above, have_left,
                    self.bitdepth, num_top_right=ntr, num_bottom_left=nbl,
                )
                srcb = self.src[0][y : y + tx, x : x + tx].astype(np.int64)
                pred_inc = predict(y_mode, above_b, left_b, tx, tx,
                                   have_above, have_left,
                                   bitdepth=self.bitdepth)
                ssd_inc = int(((srcb - pred_inc) ** 2).sum())
                fi_best, fi_ssd = -1, 0
                for fi in range(5):
                    pf = predict(FILTER_BASE + fi, above_b, left_b, tx, tx,
                                 have_above, have_left,
                                 bitdepth=self.bitdepth)
                    s = int(((srcb - pf) ** 2).sum())
                    if fi_best < 0 or s < fi_ssd:
                        fi_best, fi_ssd = fi, s
                if 10 * fi_ssd < 9 * ssd_inc:
                    if pre0 is None:
                        pre0 = self._try_luma_depth(x, y, size, 0, y_mode,
                                                    ntr, nbl)
                    tF = self._try_luma_depth(
                        x, y, size, 0, FILTER_BASE + fi_best, ntr, nbl)
                    lam_pix = float(
                        ((self.dq_ac * self.dq_ac) >> 6) * RDOQ_KNUM
                    ) / (RDOQ_KDEN * 128.0) * self._lam_scale
                    # +300 rate units ~ the filter_intra_mode symbol the
                    # filter side pays (both sides pay the use flag; a
                    # non-DC incumbent's rarer kf_y symbol roughly funds
                    # the flag the filter side adds)
                    rd_d = float(pre0[1]) + lam_pix * float(pre0[2])
                    rd_f = float(tF[1]) + lam_pix * float(tF[2] + 300)
                    if rd_f < rd_d:
                        y_mode = FILTER_BASE + fi_best
                        pre0 = tF
            depth_cands = [0]
            # speed 9 keeps the split trial only for <=16 blocks (cheap,
            # where most splits land); lower speeds try every size;
            # speed 10 skips the trial entirely
            if can_code_coeffs and tx >= 8 and size <= 64 and (
                self.speed <= 9 and (self.speed <= 8 or tx <= 16)
            ):
                depth_cands.append(1)
            best = None
            for depth in depth_cands:
                if depth == 1 and best is not None and self.speed > 5:
                    # prune: when the whole-block tx is already near its
                    # quantization floor, a split can only add signaling
                    # (speeds <= 5 always run the trial)
                    dist0 = best[4]
                    if dist0 <= (
                        size * size * self.dq_ac * self.dq_ac
                    ) >> 9:
                        continue
                # two-phase tx-type search at the default speed (mirrors
                # oav1tile.c): the split TRIAL judges on DCT only; a
                # winning split re-runs with the per-txb duels
                duel_in_trial = depth == 0 or self.speed <= 8
                trial = pre0 if (depth == 0 and pre0 is not None) else (
                    self._try_luma_depth(x, y, size, depth, y_mode, ntr, nbl,
                                         allow_duel=duel_in_trial)
                )
                if trial is None:
                    # a split whose levels are ALL zero is rejected: a
                    # zero-luma block may become skip, and skip blocks
                    # must reconstruct with the depth-0 whole-block
                    # prediction the decoder uses.
                    continue
                jobs_d, dist, rate, recon_blk = trial
                rate += self._tx_depth_cost(r, c, size, depth)
                lam_pix = float(
                    ((self.dq_ac * self.dq_ac) >> 6) * RDOQ_KNUM
                ) / (RDOQ_KDEN * 128.0) * self._lam_scale
                rd = float(dist) + lam_pix * float(rate)
                if best is None or rd < best[0]:
                    if not duel_in_trial:
                        trial = self._try_luma_depth(
                            x, y, size, depth, y_mode, ntr, nbl
                        )
                        if trial is None:
                            continue  # dueled split went all-zero: keep 0
                        jobs_d, _, _, recon_blk = trial
                    best = (rd, depth, jobs_d, recon_blk, dist)
            _, y_depth, y_jobs, y_recon, _ = best
        y_tx = tx >> y_depth

        plane_jobs = [
            (0, y_tx, px_, py_, lv, pr, tt) for lv, pr, tt, px_, py_ in y_jobs
        ]
        uv_mode = DC_PRED
        cfl_alphas = (0, 0)
        if len(self.planes) > 1:
            uv_mode, cfl_alphas, uv_jobs = self._plan_chroma(
                x, y, size, tx, y_recon, plane_pred, plane_levels,
                forced=(rep[6], rep[7], rep[8]) if rep is not None else None,
            )
            plane_jobs += [j + ("dct_dct",) for j in uv_jobs]
        if size == 128:
            # spec residual(): blocks wider/taller than 64 code their
            # transform blocks in 64x64 CHUNKS with the planes
            # interleaved per chunk (Y chunk txbs, then U, then V, then
            # the next chunk) — not plane-major like <= 64 blocks
            plane_jobs = [
                j for cy in (0, 64) for cx in (0, 64)
                for j in plane_jobs
                if (j[3] - y) // 64 * 64 == cy and (j[2] - x) // 64 * 64 == cx
            ]

        skip = not any(np.any(lv) for _, _, _, _, lv, _, _ in plane_jobs)
        assert not (skip and y_depth), "skip block must be depth 0"
        if self._dec_mode == 1:
            tts = [0, 0, 0, 0]
            for i, j in enumerate(y_jobs[:4]):
                tts[i] = {"dct_dct": 0, "adst_adst": 1, "idtx": 2}[j[2]]
            self._dec_out += [
                (r << 16) | (c << 8) | size,
                9 if use_palette is not None else y_depth, *tts,
                uv_mode, cfl_alphas[0], cfl_alphas[1], y_mode,
            ]
        self.blocks.append((r, c, size, 1 if skip else 0, y_tx))

        # --- symbols: skip, modes ---
        skip_ctx = int(self.above_skip[c]) + int(self.left_skip[lr])
        self._sym(self.cdf.skip[skip_ctx], 1 if skip else 0)

        # filter-intra blocks code YMode = DC_PRED + the filter fields
        fi_mode = (y_mode - FILTER_BASE) if y_mode >= FILTER_BASE else None
        sym_y = DC_PRED if fi_mode is not None else y_mode
        actx = INTRA_MODE_CONTEXT[int(self.above_mode[c])] if r > 0 else 0
        lctx = INTRA_MODE_CONTEXT[int(self.left_mode[lr])] if c > 0 else 0
        self._sym(self.cdf.kf_y[actx][lctx], sym_y)
        if sym_y in MODE_TO_ANGLE and size >= 8:
            self._sym(self.cdf.angle_delta[sym_y - 1], 3)  # delta 0

        if len(self.planes) > 1:
            cfl_allowed = size <= 32
            uv_cdfs = self.cdf.uv_mode_cfl if cfl_allowed else self.cdf.uv_mode
            self._sym(uv_cdfs[sym_y], uv_mode)
            if uv_mode == UV_CFL_PRED:
                self._emit_cfl_alphas(*cfl_alphas)
            elif uv_mode in MODE_TO_ANGLE and size >= 8:
                self._sym(self.cdf.angle_delta[uv_mode - 1], 3)  # delta 0

        # palette_mode_info (spec 5.11.46): coded on screen-content
        # frames for every eligible DC block, then the index map
        # (palette_tokens precedes read_block_tx_size)
        pal_ctx_val = None
        if self.screen_tools and 8 <= size <= 64:
            bctx = 2 * (size.bit_length() - 4)
            if sym_y == DC_PRED:
                pctx = (
                    (1 if (r > 0 and self.above_pal[c] is not None) else 0)
                    + (1 if (c > 0 and self.left_pal[lr] is not None)
                       else 0)
                )
                self._sym(self.cdf.palette_y_mode[bctx][pctx],
                          1 if use_palette else 0)
                if use_palette:
                    pal_c = use_palette[0]
                    self._sym(self.cdf.palette_y_size[bctx],
                              len(pal_c) - 2)
                    self._code_palette_colors_y(
                        pal_c, self._palette_cache(r, c))
                    pal_ctx_val = pal_c
            if len(self.planes) > 1 and uv_mode == DC_PRED:
                self._sym(
                    self.cdf.palette_uv_mode[1 if use_palette else 0], 0)
            if use_palette:
                self._palette_tokens_y(
                    use_palette[1], size, size, len(use_palette[0]),
                    emit=True)

        # filter_intra_mode_info (spec 5.11.24): after palette_mode_info,
        # before read_block_tx_size; coded for DC blocks <= 32 with no
        # palette when the sequence enables the tool
        if (self.filter_intra and size <= 32 and sym_y == DC_PRED
                and use_palette is None):
            bsi = _FI_BSIZE_IDX[size]
            self._sym(self.cdf.filter_intra_use[bsi],
                      0 if fi_mode is None else 1)
            if fi_mode is not None:
                self._sym(self.cdf.filter_intra_mode, fi_mode)

        # read_block_tx_size: intra blocks code tx_depth after mode info
        # (allowSelect is true even for skip intra blocks)
        if size > 4:
            self._emit_tx_depth(r, c, size, y_depth)

        # --- residual coding + recon ---
        # tx-type syntax indexes its CDF row by the intra DIRECTION: the
        # spec maps filter-intra blocks via Filter_Intra_Mode_To_Intra_Dir
        txdir = FILTER_TO_DIR[fi_mode] if fi_mode is not None else y_mode
        for plane, tx, px, py, levels, pred, tt in plane_jobs:
            if skip:
                self._set_lvl_ctx(plane, px, py, tx, 0, 0)
                recon_block = pred
            else:
                self._encode_coeffs(plane, tx, px, py, levels, size, txdir, tt)
                resid = self._dequant_inv(levels, tx, tt,
                                          ptype=0 if plane == 0 else 1)
                recon_block = pred + resid
            lo, hi = 0, (1 << self.bitdepth) - 1
            self.recon[plane][py : py + tx, px : px + tx] = np.clip(
                recon_block, lo, hi
            )

        # --- context updates ---
        self.above_skip[c : c + n_mi] = 1 if skip else 0
        self.left_skip[lr : lr + n_mi] = 1 if skip else 0
        self.above_mode[c : c + n_mi] = sym_y
        self.left_mode[lr : lr + n_mi] = sym_y
        self.above_txw[c : c + n_mi] = y_tx
        self.left_txh[lr : lr + n_mi] = y_tx
        if self.screen_tools:
            for i in range(n_mi):
                self.above_pal[c + i] = pal_ctx_val
                if lr + i < self.sbn:
                    self.left_pal[lr + i] = pal_ctx_val

    # -- rectangular blocks (round-4 groundwork; test-gated slice) ---------------
    # The first conformant rect path: PARTITION_HORZ at 32 -> two 32x16
    # blocks, tx == block (TX_32X16 carries no tx_type syntax), DC-only
    # modes, round-half quantization. Validated end-to-end against the
    # independent oracle decoder (tests/test_conformance.py). The full
    # rect RD (planner nomination, RDOQ, VERT, 16x8) builds on this.

    _force_rect_test = False
    # rect HORZ/VERT in the product partition RD (default on; both
    # mirrored encoders implement it — OAVIF_RECT=0 disables)
    _enable_rect = os.environ.get("OAVIF_RECT", "1") == "1"

    @property
    def _idtx_on(self):
        # --tune ssim arms the identity transform (encode.py exports the
        # tune choice; both mirrored encoders read the same switch)
        return os.environ.get("OAVIF_IDTX", "0") == "1"

    def _update_part_ctx_rect(self, r, c, size, sub_w, sub_h):
        n_mi = size // 4
        self.above_part[c : c + n_mi] = _PART_CTX_BYTE[sub_w]
        self.left_part[(r & self._lm) : (r & self._lm) + n_mi] = _PART_CTX_BYTE[sub_h]

    @staticmethod
    def _rect_dq_shift(th, tw):
        # Normative dequant shift (libaom av1_get_tx_scale):
        # (pels > 256) + (pels > 1024). TX_32X16's 512 pels shift 1 —
        # paired with the rect row shift of 1 this is bit-exact vs the
        # dav1d oracle (tools/probe_rect_inverse.py); the earlier
        # area>=1024 rule matched squares only.
        pels = th * tw
        return (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)

    @staticmethod
    def _rect_txs_ctx(th, tw):
        """Coefficient-CDF tx-size context: (sqr + sqr_up + 1) >> 1 over
        the {4,8,16,32,64} size indices (spec get_tx_size_ctx)."""
        idx = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}
        lo, hi = idx[min(th, tw)], idx[max(th, tw)]
        return (lo + hi + 1) >> 1

    def _quantize_rect(self, resid, th, tw, ptype):
        """RDOQ quantization of a rect residual (same trellis-lite passes
        as the square path, with rect scan/contexts)."""
        from .transform import fwd_matrices_int16

        if not resid.any():
            return np.zeros((th, tw), dtype=np.int64)
        fh16, fw16, sa = fwd_matrices_int16(tw, th, "dct_dct", self.bitdepth)
        acc1 = fh16.astype(np.int32) @ resid.astype(np.int32)
        tmp16 = (acc1 + (1 << sa >> 1)) >> sa if sa else acc1
        out32 = tmp16.astype(np.int32) @ fw16.astype(np.int32).T
        cf = out32.astype(np.float64) * (1.0 / (1 << (24 - sa)))
        return self._rdoq_rect(cf, th, tw, ptype)

    def _rdoq_rect(self, coeffs, th, tw, ptype):
        """Rect-shape RDOQ: mirrors _rdoq with per-axis dims, the rect
        scan table, the rect dequant shift and the rect base-ctx bands
        (wide +16 on the first two columns, tall +11 on the first two
        rows; no square rr+cc<2 band)."""
        from .tables import TABLES

        shift = self._rect_dq_shift(th, tw)
        scan = np.asarray(TABLES[f"scan_{tw}x{th}"])
        n_coded = tw * th
        txs_ctx = self._rect_txs_ctx(th, tw)
        ct = self._cost_tables(txs_ctx, ptype)
        cost_base = ct["base"]
        cost_base_eob = ct["base_eob"]
        cost_br = ct["br"]
        cost_eob_extra = ct["eob_extra"]
        cost_eob_pt = self._cost_eob_pt[n_coded][ptype][0].tolist()

        dqd = self.dq_dc
        dqa = self.dq_ac_uv if ptype else self.dq_ac
        lam = float(((dqa * dqa) >> (2 * shift)) * RDOQ_KNUM) / (
            RDOQ_KDEN * 128.0
        ) * self._lam_scale

        flat = coeffs.reshape(-1)
        a_nat = np.abs(flat)
        sg_nat = np.where(flat < 0.0, -1, 1)

        up = float(1 << shift)
        dq_nat = np.full(n_coded, float(dqa))
        dq_nat[0] = float(dqd)
        l0 = np.floor(a_nat * up / dq_nat + 0.5).astype(np.int64)
        order = l0[scan]
        nz = np.nonzero(order)[0]
        out = np.zeros((th, tw), dtype=np.int64)
        if len(nz) == 0:
            return out
        eob = int(nz[-1]) + 1

        a_scan = a_nat[scan]
        if self.speed >= 10:
            lv_nat0 = np.zeros(n_coded, dtype=np.int64)
            for si in range(eob):
                if order[si]:
                    p = int(scan[si])
                    lv_nat0[p] = order[si] * int(sg_nat[p])
            return lv_nat0.reshape(th, tw)
        dq_scan = [dqd if int(scan[si]) == 0 else dqa for si in range(eob)]
        pos_r = [int(scan[si]) // tw for si in range(eob)]
        pos_c = [int(scan[si]) % tw for si in range(eob)]

        pad = np.zeros((th + 2, tw + 2), dtype=np.int64)
        ofl = order.tolist()
        for si in range(eob):
            if ofl[si]:
                pad[pos_r[si], pos_c[si]] = min(ofl[si], 127)

        hf_a = self._rdoq_hf_uv if ptype else self._rdoq_hf
        hf_den = float(n_coded)

        def err2(si, lvl):
            e = float(a_scan[si]) - float((lvl * dq_scan[si]) >> shift)
            if hf_a > 0.0:
                return e * e * (1.0 / (1.0 + hf_a * float(si) / hf_den))
            return e * e

        def hi_cost(lvl, brctx):
            r = 0
            rem = lvl - 3
            row = cost_br[brctx]
            for _ in range(4):
                k = rem if rem < 3 else 3
                r += row[k]
                rem -= k
                if k < 3:
                    break
            if lvl > 14:
                r += 128 * (2 * (lvl - 14).bit_length() - 1)
            return r

        def base_ctx(si):
            rr, cc = pos_r[si], pos_c[si]
            mag = (
                min(int(pad[rr, cc + 1]), 3)
                + min(int(pad[rr + 1, cc]), 3)
                + min(int(pad[rr + 1, cc + 1]), 3)
                + min(int(pad[rr, cc + 2]), 3)
                + min(int(pad[rr + 2, cc]), 3)
            )
            mag = min((mag + 1) >> 1, 4)
            if rr == 0 and cc == 0:
                return 0
            if tw > th and cc < 2:
                return mag + 16
            if tw < th and rr < 2:
                return mag + 11
            if rr + cc < 4:
                return mag + 6
            return mag + 21

        def br_ctx(si):
            rr, cc = pos_r[si], pos_c[si]
            mag = (
                min(int(pad[rr, cc + 1]), 15)
                + min(int(pad[rr + 1, cc]), 15)
                + min(int(pad[rr + 1, cc + 1]), 15)
            )
            mag = min((mag + 1) >> 1, 6)
            if pos_r[si] == 0 and pos_c[si] == 0:
                return mag
            if rr < 2 and cc < 2:
                return mag + 7
            return mag + 14

        def eob_ctx(si):
            if si == 0:
                return 0
            if si <= n_coded // 8:
                return 1
            if si <= n_coded // 4:
                return 2
            return 3

        def int_cost(lvl, bctx, si):
            r = cost_base[bctx][lvl if lvl < 3 else 3]
            if lvl:
                r += 128  # sign
                if lvl > 3:
                    r += hi_cost(lvl, br_ctx(si))
            return r

        def eob_coeff_cost(lvl, si):
            r = cost_base_eob[eob_ctx(si)][(lvl if lvl < 3 else 3) - 1] + 128
            if lvl > 3:
                r += hi_cost(lvl, br_ctx(si))
            return r

        def eobpt_cost(e):
            if e == 1:
                pt = 1
            elif e == 2:
                pt = 2
            else:
                pt = (e - 1).bit_length() + 1
            r = cost_eob_pt[pt - 1]
            if pt >= 3:
                nbits = pt - 2
                rest = e - (1 << (pt - 2)) - 1
                msb = (rest >> (nbits - 1)) & 1
                r += cost_eob_extra[pt - 3][msb] + 128 * (nbits - 1)
            return r

        # phase 1: eob shrinking
        while eob > 0:
            si = eob - 1
            lvl = ofl[si]
            keep = err2(si, lvl) + lam * (
                eobpt_cost(eob) + eob_coeff_cost(lvl, si)
            )
            pe = si - 1
            while pe >= 0 and ofl[pe] == 0:
                pe -= 1
            pad[pos_r[si], pos_c[si]] = 0
            if pe < 0:
                if err2(si, 0) < keep:
                    ofl[si] = 0
                    eob = 0
                else:
                    pad[pos_r[si], pos_c[si]] = min(lvl, 127)
                break
            lp = ofl[pe]
            drop = err2(si, 0) + lam * (
                eobpt_cost(pe + 1) + eob_coeff_cost(lp, pe)
            )
            keep += lam * int_cost(lp, base_ctx(pe), pe)
            if drop < keep:
                ofl[si] = 0
                eob = pe + 1
            else:
                pad[pos_r[si], pos_c[si]] = min(lvl, 127)
                break

        if eob > 0:
            # phase 2: eob coefficient level decrement (floor 1)
            si = eob - 1
            lvl = ofl[si]
            if lvl >= 2:
                if err2(si, lvl - 1) + lam * eob_coeff_cost(
                    lvl - 1, si
                ) < err2(si, lvl) + lam * eob_coeff_cost(lvl, si):
                    ofl[si] = lvl - 1
                    pad[pos_r[si], pos_c[si]] = min(lvl - 1, 127)
            # phase 3: interior level decrements (reverse scan)
            for si in range(eob - 2, -1, -1):
                lvl = ofl[si]
                if lvl == 0:
                    continue
                bctx = base_ctx(si)
                if err2(si, lvl - 1) + lam * int_cost(
                    lvl - 1, bctx, si
                ) < err2(si, lvl) + lam * int_cost(lvl, bctx, si):
                    ofl[si] = lvl - 1
                    pad[pos_r[si], pos_c[si]] = min(lvl - 1, 127)

        lv_nat = np.zeros(n_coded, dtype=np.int64)
        for si in range(eob):
            if ofl[si]:
                p = int(scan[si])
                lv_nat[p] = ofl[si] * int(sg_nat[p])
        return lv_nat.reshape(th, tw)

    def _dequant_inv_rect(self, levels, th, tw, ptype):
        shift = self._rect_dq_shift(th, tw)
        q = np.full_like(levels, self.dq_ac_uv if ptype else self.dq_ac)
        q[0, 0] = self.dq_dc
        mag = (np.abs(levels) * q) & 0xFFFFFF
        mag >>= shift
        # spec conformance clamp to bd+8 signed bits (dav1d stores 8-bit
        # coefficients as int16)
        mag = np.minimum(mag, (1 << (self.bitdepth + 7)) - 1)
        return inv_txfm2d(np.sign(levels) * mag, self.bitdepth)

    def _set_lvl_ctx_rect(self, plane, px, py, tw, th, cul, dc_cat):
        ps = self.pstate[plane]
        mi_c, mi_r = px // 4, py // 4
        ps.above_lvl[mi_c : mi_c + tw // 4] = cul
        ps.left_lvl[(mi_r & self._lm) : (mi_r & self._lm) + th // 4] = cul
        ps.above_dc[mi_c : mi_c + tw // 4] = dc_cat
        ps.left_dc[(mi_r & self._lm) : (mi_r & self._lm) + th // 4] = dc_cat

    def _dc_sign_ctx_rect(self, plane, px, py, tw, th):
        ps = self.pstate[plane]
        mi_c, mi_r = px // 4, py // 4
        cats = np.concatenate(
            [
                ps.above_dc[mi_c : mi_c + tw // 4],
                ps.left_dc[(mi_r & self._lm) : (mi_r & self._lm) + th // 4],
            ]
        )
        bal = int((cats == 2).sum()) - int((cats == 1).sum())
        if bal < 0:
            return 1
        if bal > 0:
            return 2
        return 0

    def _encode_block_rect(self, r, c, bw, bh):
        """One rect block (bw x bh px), tx == block.

        Y mode from the square candidate ladder by prediction SSD (same
        policy as _choose_y_mode); chroma DC-vs-CfL with the rect lumaAC
        average (log2w+log2h rounding); RDOQ levels via _rdoq_rect.
        Cross-probe decision replay records rect rows with the bh-coded
        tag (mirrored disarm on mismatch)."""
        from .consts import (
            PAETH_PRED, SMOOTH_H_PRED, SMOOTH_PRED, SMOOTH_V_PRED,
            UV_CFL_PRED, V_PRED,
        )
        from .consts import H_PRED as H_PRED_

        x, y = c * 4, r * 4
        lr = r & self._lm
        lo, hi = 0, (1 << self.bitdepth) - 1
        have_above, have_left = y > 0, x > 0

        # per-block λ scale from source-luma variance (mirror the square)
        if self._mean_var > 0.0:
            blk = self.src[0][y : y + bh, x : x + bw].astype(np.int64)
            n_ = bw * bh
            s1 = int(blk.sum())
            s2 = int((blk * blk).sum())
            var_b = float(n_ * s2 - s1 * s1) / float(n_ * n_)
            sc = np.sqrt((var_b + 16.0) / (self._mean_var + 16.0))
            self._lam_scale = float(min(max(sc, 0.25), 4.0))
        else:
            self._lam_scale = 1.0

        # replay (10-int rows like squares; tag size byte = bh|1 marks
        # HORZ rect, bw|2 VERT — disjoint from the square size values)
        tagsz = (bh | 1) if bw > bh else (bw | 2)
        tag = (r << 16) | (c << 8) | tagsz
        rep = None
        if self._dec_mode == 2:
            buf, pos = self._dec["buf"], self._dec_pos
            if pos + 10 <= int(self._dec["len"]) and int(buf[pos]) == tag:
                rep = [int(v) for v in buf[pos : pos + 10]]
                self._dec_pos += 10
            else:
                self._dec_mode = 0

        # --- luma: mode by pred SSD over the candidate ladder ---
        src0 = self.src[0][y : y + bh, x : x + bw]
        if rep is not None:
            y_mode = rep[9]
            above0, left0 = build_edges(
                self.recon[0], x, y, bw, bh, have_above, have_left,
                self.bitdepth,
            )
            y_pred = predict(y_mode, above0, left0, bw, bh, have_above,
                             have_left, bitdepth=self.bitdepth)
            y_levels = self._quantize_rect(src0 - y_pred, bh, bw, 0)
        else:
            y_mode, y_pred, y_levels = self._rect_mode_and_levels(
                x, y, bw, bh
            )
        if np.any(y_levels):
            y_recon = np.clip(
                y_pred + self._dequant_inv_rect(y_levels, bh, bw, 0), lo, hi
            )
        else:
            y_recon = np.clip(y_pred, lo, hi)

        # --- chroma: DC vs CfL (rect lumaAC) ---
        uv_mode = DC_PRED
        cfl_alphas = (0, 0)
        uv_planes = []
        if len(self.planes) > 1:
            dc_preds = []
            for p in (1, 2):
                a_, l_ = build_edges(
                    self.recon[p], x, y, bw, bh, have_above, have_left,
                    self.bitdepth,
                )
                dc_preds.append(
                    predict(DC_PRED, a_, l_, bw, bh, have_above, have_left,
                            bitdepth=self.bitdepth)
                )
            luma = y_recon.astype(np.int64) << 3
            lg = (bw.bit_length() - 1) + (bh.bit_length() - 1)
            avg = (int(luma.sum()) + (1 << (lg - 1))) >> lg
            diff = luma - avg
            if rep is not None:
                uv_mode = rep[6]
                cfl_alphas = (rep[7], rep[8])
                if uv_mode != UV_CFL_PRED:
                    cfl_alphas = (0, 0)
                for i, p in enumerate((1, 2)):
                    if uv_mode == UV_CFL_PRED:
                        prod = cfl_alphas[i] * diff
                        contrib = np.sign(prod) * (
                            (np.abs(prod) + 32) >> 6)
                        predp = np.clip(dc_preds[i] + contrib, 0, hi)
                    else:
                        predp = dc_preds[i]
                    srcp = self.src[p][y : y + bh, x : x + bw]
                    lvp = self._quantize_rect(srcp - predp, bh, bw, 1)
                    uv_planes.append((p, lvp, predp))
            else:
                # closed-form least-squares alpha + refinement and the
                # rate-proxy DC-vs-CfL decision (same algorithm as the
                # square _plan_chroma; mirrored in C)
                var = int((diff * diff).sum())
                best_alpha, cfl_preds = [], []
                for i, p in enumerate((1, 2)):
                    srcp = self.src[p][y : y + bh, x : x + bw]
                    res = (srcp - dc_preds[i]).astype(np.int64)
                    cov = int((diff * res).sum())
                    if var == 0 or cov == 0:
                        a_est = 0
                    else:
                        a_est = (64 * abs(cov) + var // 2) // var
                        a_est = min(a_est, 16)
                        if cov < 0:
                            a_est = -a_est
                    if a_est == 0:
                        best_alpha.append(0)
                        cfl_preds.append(dc_preds[i])
                        continue
                    if self.speed <= 6:
                        cands = [a for a in range(-16, 17) if a]
                    else:
                        cands = [a for a in (a_est, a_est - 1, a_est + 1)
                                 if -16 <= a <= 16]
                    best = None
                    for a in cands:
                        prod = a * diff
                        contrib = np.sign(prod) * ((np.abs(prod) + 32) >> 6)
                        predp = np.clip(dc_preds[i] + contrib, 0, hi)
                        ssd = int(((srcp - predp) ** 2).sum())
                        if best is None or ssd < best[0]:
                            best = (ssd, a, predp)
                    best_alpha.append(best[1])
                    cfl_preds.append(best[2])

                def _rate_proxy(lv):
                    nz = lv != 0
                    return int(nz.sum()) + int(np.abs(lv).sum())

                lv_dc = [
                    self._quantize_rect(
                        self.src[1 + i][y : y + bh, x : x + bw]
                        - dc_preds[i], bh, bw, 1)
                    for i in (0, 1)
                ]
                if best_alpha == [0, 0]:
                    for i, p in enumerate((1, 2)):
                        uv_planes.append((p, lv_dc[i], dc_preds[i]))
                else:
                    lv_cfl = [
                        self._quantize_rect(
                            self.src[1 + i][y : y + bh, x : x + bw]
                            - cfl_preds[i], bh, bw, 1)
                        for i in (0, 1)
                    ]
                    cost_dc = _rate_proxy(lv_dc[0]) + _rate_proxy(lv_dc[1])
                    cost_cfl = (_rate_proxy(lv_cfl[0])
                                + _rate_proxy(lv_cfl[1]) + 4)
                    if cost_cfl < cost_dc:
                        uv_mode = UV_CFL_PRED
                        cfl_alphas = (best_alpha[0], best_alpha[1])
                        for i, p in enumerate((1, 2)):
                            uv_planes.append((p, lv_cfl[i], cfl_preds[i]))
                    else:
                        for i, p in enumerate((1, 2)):
                            uv_planes.append((p, lv_dc[i], dc_preds[i]))

        skip = not np.any(y_levels) and not any(
            np.any(lv) for _, lv, _ in uv_planes
        )
        if self._dec_mode == 1:
            self._dec_out += [
                tag, 0, 0, 0, 0, 0,
                uv_mode, cfl_alphas[0], cfl_alphas[1], y_mode,
            ]

        nw, nh = bw // 4, bh // 4
        self.blocks.append((r, c, bw | (bh << 16), 1 if skip else 0,
                            bw | (bh << 16)))

        # --- symbols ---
        skip_ctx = int(self.above_skip[c]) + int(self.left_skip[lr])
        self._sym(self.cdf.skip[skip_ctx], 1 if skip else 0)
        actx = INTRA_MODE_CONTEXT[int(self.above_mode[c])] if r > 0 else 0
        lctx = INTRA_MODE_CONTEXT[int(self.left_mode[lr])] if c > 0 else 0
        self._sym(self.cdf.kf_y[actx][lctx], y_mode)
        if y_mode in MODE_TO_ANGLE and min(bw, bh) >= 8:
            self._sym(self.cdf.angle_delta[y_mode - 1], 3)  # delta 0
        if len(self.planes) > 1:
            cfl_allowed = max(bw, bh) <= 32
            uv_cdfs = (self.cdf.uv_mode_cfl if cfl_allowed
                       else self.cdf.uv_mode)
            self._sym(uv_cdfs[y_mode], uv_mode)
            if uv_mode == UV_CFL_PRED:
                self._emit_cfl_alphas(*cfl_alphas)
            elif uv_mode in MODE_TO_ANGLE and min(bw, bh) >= 8:
                self._sym(self.cdf.angle_delta[uv_mode - 1], 3)
        # palette_mode_info on screen-content frames: rect blocks are
        # eligible sizes, we always decline (flags = 0)
        if self.screen_tools:
            bctx = (bw.bit_length() - 3) + (bh.bit_length() - 3) - 2
            if y_mode == DC_PRED:
                pctx = (
                    (1 if (r > 0 and self.above_pal[c] is not None) else 0)
                    + (1 if (c > 0 and self.left_pal[lr] is not None)
                       else 0)
                )
                self._sym(self.cdf.palette_y_mode[bctx][pctx], 0)
            if len(self.planes) > 1 and uv_mode == DC_PRED:
                self._sym(self.cdf.palette_uv_mode[0], 0)
        # filter_intra_mode_info: rect DC blocks <= 32 are eligible and
        # must code the use flag; the rect path always declines
        if (self.filter_intra and max(bw, bh) <= 32 and y_mode == DC_PRED):
            self._sym(self.cdf.filter_intra_use[_FI_BSIZE_IDX[(bw, bh)]], 0)
        # tx_depth 0 of the rect max tx: cat = sqr_up category, ctx from
        # the rect dims
        cat = {8: 0, 16: 1, 32: 2, 64: 3}[max(bw, bh)]
        above = int(self.above_txw[c]) if r > 0 else 0
        left = int(self.left_txh[lr]) if c > 0 else 0
        tctx = (1 if above >= bw else 0) + (1 if left >= bh else 0)
        row = self.cdf.tx_size[cat, tctx]
        self._sym(row[:3] if cat == 0 else row, 0)

        # --- residual coding + recon ---
        plane_sets = [(0, y_levels, y_pred)] + uv_planes
        for plane, lv, pred in plane_sets:
            if skip:
                self._set_lvl_ctx_rect(plane, x, y, bw, bh, 0, 0)
                recon_blk = pred
            elif plane == 0:
                self._encode_coeffs_rect(plane, bw, bh, x, y, lv)
                recon_blk = y_recon
            else:
                self._encode_coeffs_rect(plane, bw, bh, x, y, lv)
                if np.any(lv):
                    recon_blk = pred + self._dequant_inv_rect(lv, bh, bw, 1)
                else:
                    recon_blk = pred
            self.recon[plane][y : y + bh, x : x + bw] = np.clip(
                recon_blk, lo, hi
            )

        self.above_skip[c : c + nw] = 1 if skip else 0
        self.left_skip[lr : lr + nh] = 1 if skip else 0
        self.above_mode[c : c + nw] = y_mode
        self.left_mode[lr : lr + nh] = y_mode
        self.above_txw[c : c + nw] = bw
        self.left_txh[lr : lr + nh] = bh
        if self.screen_tools:
            for i in range(nw):
                self.above_pal[c + i] = None
            for i in range(nh):
                if lr + i < self.sbn:
                    self.left_pal[lr + i] = None

    def _encode_coeffs_rect(self, plane, tw, th, px, py, levels2d):
        """Coefficient emission for one rect txb (DCT only; mirrors the
        square Python path with per-axis dims)."""
        from .tables import TABLES

        txs_ctx = self._rect_txs_ctx(th, tw)
        ptype = 0 if plane == 0 else 1
        lv = levels2d
        scan = np.asarray(TABLES[f"scan_{tw}x{th}"])
        n_coded = tw * th

        if plane == 0:
            ctx = 0  # tx == block
        else:
            ps = self.pstate[plane]
            mi_c, mi_r = px // 4, py // 4
            above_nz = np.any(ps.above_lvl[mi_c : mi_c + tw // 4] != 0)
            left_nz = np.any(
                ps.left_lvl[(mi_r & self._lm) : (mi_r & self._lm) + th // 4] != 0
            )
            ctx = 7 + int(above_nz) + int(left_nz)  # tx dims == block dims

        flat = lv.reshape(-1)
        nz = np.nonzero(flat[scan])[0]
        eob = int(nz[-1]) + 1 if len(nz) else 0

        self._sym(self.cdf.txb_skip[txs_ctx][ctx], 1 if eob == 0 else 0)
        if eob == 0:
            self._set_lvl_ctx_rect(plane, px, py, tw, th, 0, 0)
            return
        # TX_32X16/16X32/32X32-class txs carry no tx_type syntax

        if eob == 1:
            eob_pt = 1
        elif eob == 2:
            eob_pt = 2
        else:
            eob_pt = (eob - 1).bit_length() + 1
        self._sym(self.cdf.eob_pt[n_coded][ptype][0], eob_pt - 1)
        if eob_pt >= 3:
            nbits = eob_pt - 2
            rest = eob - (1 << (eob_pt - 2)) - 1
            msb = (rest >> (nbits - 1)) & 1
            self._sym(self.cdf.eob_extra[txs_ctx][ptype][eob_pt - 3], msb)
            for i in range(nbits - 2, -1, -1):
                self.enc.bool_q15((rest >> i) & 1, 16384)

        absl = np.minimum(np.abs(lv), 127).astype(np.int64)
        pad = np.zeros((th + 2, tw + 2), dtype=np.int64)
        pad[:th, :tw] = absl

        for si in range(eob - 1, -1, -1):
            pos = int(scan[si])
            rr, cc = pos // tw, pos % tw
            level = int(absl[rr, cc])
            if si == eob - 1:
                if si == 0:
                    ctx_eob = 0
                elif si <= n_coded // 8:
                    ctx_eob = 1
                elif si <= n_coded // 4:
                    ctx_eob = 2
                else:
                    ctx_eob = 3
                self._sym(
                    self.cdf.coeff_base_eob[txs_ctx][ptype][ctx_eob],
                    min(level, 3) - 1,
                )
            else:
                mag = (
                    min(int(pad[rr, cc + 1]), 3)
                    + min(int(pad[rr + 1, cc]), 3)
                    + min(int(pad[rr + 1, cc + 1]), 3)
                    + min(int(pad[rr, cc + 2]), 3)
                    + min(int(pad[rr + 2, cc]), 3)
                )
                mag = min((mag + 1) >> 1, 4)
                # rect 2D base-ctx offsets (extracted from the decoder's
                # av1_nz_map_ctx_offset tables and verified byte-for-byte
                # against the generating rule): wide txs give the first
                # two COLUMNS offset 16, tall txs the first two ROWS
                # offset 11; the square 1-offset band is unreachable
                if pos == 0:
                    base_ctx = 0
                elif tw > th and cc < 2:
                    base_ctx = mag + 16
                elif tw < th and rr < 2:
                    base_ctx = mag + 11
                elif rr + cc < 4:
                    base_ctx = mag + 6
                else:
                    base_ctx = mag + 21
                self._sym(
                    self.cdf.coeff_base[txs_ctx][ptype][base_ctx],
                    min(level, 3),
                )
            if level > 2:  # NUM_BASE_LEVELS — br coded from level 3 up
                mag = (
                    min(int(pad[rr, cc + 1]), 15)
                    + min(int(pad[rr + 1, cc]), 15)
                    + min(int(pad[rr + 1, cc + 1]), 15)
                )
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    br_ctx = mag
                elif rr < 2 and cc < 2:
                    br_ctx = mag + 7
                else:
                    br_ctx = mag + 14
                remaining = level - 3
                for _ in range(4):
                    k = min(remaining, 3)
                    self._sym(
                        self.cdf.coeff_br[min(txs_ctx, 3)][ptype][br_ctx], k
                    )
                    remaining -= k
                    if k < 3:
                        break

        dc_cat = 0
        cul = 0
        for si in range(eob):
            pos = int(scan[si])
            rr, cc = pos // tw, pos % tw
            v = int(lv[rr, cc])
            level = abs(v)
            cul += level
            if level == 0:
                continue
            sign = 1 if v < 0 else 0
            if si == 0:
                sctx = self._dc_sign_ctx_rect(plane, px, py, tw, th)
                self._sym(self.cdf.dc_sign[ptype][sctx], sign)
                dc_cat = 1 if sign else 2
            else:
                self.enc.bool_q15(sign, 16384)
            if level > 14:
                self._write_golomb(level - 15)

        self._set_lvl_ctx_rect(plane, px, py, tw, th, min(cul, 63), dc_cat)

    # -- lossless (CodedLossless: WHT 4x4, recon == source) -----------------------

    # libaom skip_contexts[min][max] for luma txbs smaller than the block
    _SKIP_CTX_TABLE = np.array(
        [[1, 2, 2, 2, 3],
         [1, 4, 4, 4, 5],
         [1, 4, 4, 4, 5],
         [1, 4, 4, 4, 5],
         [1, 4, 4, 4, 6]], dtype=np.int32)

    def _txb_skip_ctx_sub(self, plane: int, px: int, py: int, tx: int) -> int:
        """txb-skip context for a luma txb smaller than its block (spec
        get_txb_skip_ctx, OR-combine of 4x4 level contexts)."""
        ps = self.pstate[plane]
        mi_c, mi_r = px // 4, py // 4
        n = tx // 4
        top = 0
        left = 0
        for i in range(n):
            top |= int(ps.above_lvl[mi_c + i])
            left |= int(ps.left_lvl[(mi_r & self._lm) + i])
        top &= 63
        left &= 63
        mx = min(top | left, 4)
        mn = min(min(top, left), 4)
        return int(self._SKIP_CTX_TABLE[mn][mx])

    def _encode_block_lossless(self, r: int, c: int, size: int) -> None:
        """4x4 block in a CodedLossless frame (tx == block — the decoder-
        validated configuration): WHT residual per plane. Reconstruction
        equals the source exactly, so prediction edges come straight from
        the source planes."""
        from .transform import fwd_wht4x4

        assert size == 4
        x, y = c * 4, r * 4
        lr = r & self._lm
        nplanes = len(self.planes)
        y_mode, _, _, _ = self._choose_y_mode(r, c, size)

        ntr, nbl = self._edge_counts(r, c, 4)
        jobs = []  # (plane, levels, pred)
        for plane in range(nplanes):
            mode = y_mode if plane == 0 else DC_PRED
            above, left = build_edges(
                self.src[plane], x, y, 4, 4, y > 0, x > 0, self.bitdepth,
                num_top_right=ntr, num_bottom_left=nbl,
            )
            pred = predict(mode, above, left, 4, 4, y > 0, x > 0,
                           bitdepth=self.bitdepth)
            resid = self.src[plane][y : y + 4, x : x + 4] - pred
            levels = fwd_wht4x4(resid) >> 2  # q = 4 at qindex 0
            jobs.append((plane, levels, pred))
        skip = not any(np.any(lv) for _, lv, _ in jobs)

        skip_ctx = int(self.above_skip[c]) + int(self.left_skip[lr])
        self._sym(self.cdf.skip[skip_ctx], 1 if skip else 0)
        actx = INTRA_MODE_CONTEXT[int(self.above_mode[c])] if r > 0 else 0
        lctx = INTRA_MODE_CONTEXT[int(self.left_mode[lr])] if c > 0 else 0
        self._sym(self.cdf.kf_y[actx][lctx], y_mode)
        # size 4: no angle_delta (use_angle_delta needs >= 8x8)
        if nplanes > 1:
            self._sym(self.cdf.uv_mode_cfl[y_mode], DC_PRED)

        for plane, levels, pred in jobs:
            if skip:
                self._set_lvl_ctx(plane, x, y, 4, 0, 0)
            else:
                self._encode_coeffs_lossless(plane, x, y, levels, 4)
            # lossless: recon is exactly the source
            self.recon[plane][y : y + 4, x : x + 4] = self.src[plane][
                y : y + 4, x : x + 4
            ]

        self.above_skip[c] = 1 if skip else 0
        self.left_skip[lr] = 1 if skip else 0
        self.above_mode[c] = y_mode
        self.left_mode[lr] = y_mode

    def _encode_coeffs_lossless(
        self, plane: int, px: int, py: int, levels: np.ndarray, bsize: int
    ) -> None:
        """4x4 txb coefficients in a lossless frame: no tx_type symbol (the
        WHT is implicit), luma skip context from the sub-block process."""
        ptype = 0 if plane == 0 else 1
        if plane == 0:
            ctx = 0  # tx == block for 4x4 lossless blocks
        else:
            ctx = self._txb_skip_ctx(plane, px, py, 4, bsize)
        scan = self._scan_cache[4]
        sctx = self._dc_sign_ctx(plane, px, py, 4)
        if self.enc.coeffs is not None:
            eob, cul, dc_cat = self.enc.coeffs(
                levels[:4, :4].astype(np.int32), scan,
                self.cdf.txb_skip[0][ctx],
                self.cdf.eob_pt[16][ptype][0],
                self.cdf.eob_extra[0][ptype],
                self.cdf.coeff_base_eob[0][ptype],
                self.cdf.coeff_base[0][ptype],
                self.cdf.coeff_br[0][ptype],
                self.cdf.dc_sign[ptype][sctx],
            )
            self._set_lvl_ctx(plane, px, py, 4, cul, dc_cat)
            return
        raise NotImplementedError("lossless path requires the native coder")

    # -- chroma planning (CfL) ---------------------------------------------------

    def _plan_chroma(self, x, y, size, tx, y_recon, plane_pred, plane_levels,
                     forced=None):
        """Choose DC vs CfL for the chroma planes (spec 7.11.5).

        CfL predicts chroma as DC + Round2Signed(alpha_q3 * lumaAC, 6) where
        lumaAC = (reconLuma << 3) - Round2(sum, log2w+log2h). Per-plane alpha
        is an exhaustive search over the ±16 alphabet by prediction SSD; the
        DC-vs-CfL decision compares quantized-level rate proxies.
        Returns (uv_mode, (alpha_u, alpha_v), plane_jobs)."""
        if size > 32:
            # 64x64 block: chroma transforms cap at 32x32 (spec adjusted
            # tx size), so each plane codes four 32x32 txbs in raster
            # order, each DC-predicted from its own (already
            # reconstructed) edges. CfL is not allowed above 32.
            lo, hi = 0, (1 << self.bitdepth) - 1
            jobs = []
            for p in (1, 2):
                for sy in range(0, size, 32):
                    for sx in range(0, size, 32):
                        px_, py_ = x + sx, y + sy
                        ha, hl = py_ > 0, px_ > 0
                        above, left = build_edges(
                            self.recon[p], px_, py_, 32, 32, ha, hl,
                            self.bitdepth,
                        )
                        pred = predict(DC_PRED, above, left, 32, 32, ha, hl,
                                       bitdepth=self.bitdepth)
                        src = self.src[p][py_ : py_ + 32, px_ : px_ + 32]
                        lv = self._quantize(src - pred, 32, ptype=1)
                        if np.any(lv):
                            rec = np.clip(
                                pred + self._dequant_inv(lv, 32, "dct_dct",
                                                         ptype=1),
                                lo, hi)
                        else:
                            rec = np.clip(pred, lo, hi)
                        # write recon now: the next txb predicts from it
                        # (the coding loop later rewrites the same values)
                        self.recon[p][py_ : py_ + 32, px_ : px_ + 32] = rec
                        jobs.append((p, 32, px_, py_, lv, pred))
            return DC_PRED, (0, 0), jobs

        dc_preds = [plane_pred(p, DC_PRED) for p in (1, 2)]

        if forced is not None:
            # replayed decision (mirrors oav1tile.c): DC goes straight to
            # DC levels; CfL rebuilds lumaAC at THIS q and applies the
            # recorded alphas — no alpha search, no DC-vs-CfL trial
            f_uv, f_au, f_av = forced
            if f_uv == UV_CFL_PRED and (f_au or f_av) and size <= 32:
                luma_f = (y_recon.astype(np.int64)) << 3
                lg_f = 2 * (size.bit_length() - 1)
                avg_f = (int(luma_f.sum()) + (1 << (lg_f - 1))) >> lg_f
                diff_f = luma_f - avg_f
                hi_f = (1 << self.bitdepth) - 1
                jobs = []
                for i, a in enumerate((f_au, f_av)):
                    prod = a * diff_f
                    contrib = np.sign(prod) * ((np.abs(prod) + 32) >> 6)
                    pred = np.clip(dc_preds[i] + contrib, 0, hi_f)
                    jobs.append((1 + i, tx, x, y,
                                 plane_levels(1 + i, pred), pred))
                return UV_CFL_PRED, (f_au, f_av), jobs
            jobs = [
                (p, tx, x, y, plane_levels(p, dc_preds[p - 1]),
                 dc_preds[p - 1])
                for p in (1, 2)
            ]
            return DC_PRED, (0, 0), jobs

        luma = (y_recon.astype(np.int64)) << 3
        lg = 2 * (size.bit_length() - 1)
        avg = (int(luma.sum()) + (1 << (lg - 1))) >> lg
        diff = luma - avg  # (size, size)

        hi = (1 << self.bitdepth) - 1
        var = int((diff * diff).sum())

        best_alpha = []
        cfl_preds = []
        for i in (0, 1):
            src = self.src[1 + i][y : y + size, x : x + size]
            res = (src - dc_preds[i]).astype(np.int64)
            # closed-form least-squares alpha (contribution = a*diff/64), +-1
            cov = int((diff * res).sum())
            if var == 0 or cov == 0:
                a_est = 0
            else:
                a_est = (64 * abs(cov) + var // 2) // var
                a_est = min(a_est, 16)
                if cov < 0:
                    a_est = -a_est
            if a_est == 0:
                best_alpha.append(0)
                cfl_preds.append(dc_preds[i])
                continue
            if self.speed <= 6:
                cands = [a for a in range(-16, 17) if a]
            else:
                cands = [a for a in (a_est, a_est - 1, a_est + 1)
                         if -16 <= a <= 16]
            best = None
            for a in cands:
                prod = a * diff
                contrib = np.sign(prod) * ((np.abs(prod) + 32) >> 6)
                pred = np.clip(dc_preds[i] + contrib, 0, hi)
                ssd = int(((src - pred) ** 2).sum())
                if best is None or ssd < best[0]:
                    best = (ssd, a, pred)
            best_alpha.append(best[1])
            cfl_preds.append(best[2])

        if best_alpha == [0, 0]:
            jobs = [
                (p, tx, x, y, plane_levels(p, dc_preds[p - 1]), dc_preds[p - 1])
                for p in (1, 2)
            ]
            return DC_PRED, (0, 0), jobs

        def rate_proxy(lv):
            nz = lv != 0
            return int(nz.sum()) + int(np.abs(lv).sum())

        lv_dc = [plane_levels(1 + i, dc_preds[i]) for i in (0, 1)]
        lv_cfl = [plane_levels(1 + i, cfl_preds[i]) for i in (0, 1)]
        cost_dc = rate_proxy(lv_dc[0]) + rate_proxy(lv_dc[1])
        cost_cfl = rate_proxy(lv_cfl[0]) + rate_proxy(lv_cfl[1]) + 4

        if cost_cfl < cost_dc:
            jobs = [(1 + i, tx, x, y, lv_cfl[i], cfl_preds[i]) for i in (0, 1)]
            return UV_CFL_PRED, tuple(best_alpha), jobs
        jobs = [(1 + i, tx, x, y, lv_dc[i], dc_preds[i]) for i in (0, 1)]
        return DC_PRED, (0, 0), jobs

    def _emit_cfl_alphas(self, alpha_u: int, alpha_v: int) -> None:
        """cfl_alphas() syntax (spec 5.11.45): joint sign symbol, then the
        per-plane alphabet index under its sign-derived context."""
        sign_u = 0 if alpha_u == 0 else (1 if alpha_u < 0 else 2)
        sign_v = 0 if alpha_v == 0 else (1 if alpha_v < 0 else 2)
        joint = sign_u * 3 + sign_v - 1
        self._sym(self.cdf.cfl_sign, joint)
        if sign_u:
            ctx_u = joint - 2
            self._sym(self.cdf.cfl_alpha[ctx_u], abs(alpha_u) - 1)
        if sign_v:
            ctx_v = sign_v * 3 + sign_u - 3
            self._sym(self.cdf.cfl_alpha[ctx_v], abs(alpha_v) - 1)

    # -- device plan application --------------------------------------------------

    def _planned_part64(self, r: int, c: int):
        p = self.plan.get("plan64") if self.plan else None
        if p is None:
            return None
        i, j = r // 16, c // 16
        if i >= p.shape[0] or j >= p.shape[1] or p[i, j] < 0:
            return None
        return PARTITION_NONE if p[i, j] > 0 else PARTITION_SPLIT

    def _planned_part32(self, r: int, c: int):
        p = self.plan.get("part32") if self.plan else None
        if p is None:
            return None
        i, j = r // 8, c // 8
        if i >= p.shape[0] or j >= p.shape[1]:
            return None
        return PARTITION_SPLIT if p[i, j] else PARTITION_NONE

    def _planned_mode(self, r: int, c: int, size: int):
        if not self.plan:
            return None
        if size == 64:
            p = self.plan.get("plan64")
            i, j = r // 16, c // 16
            if p is not None and i < p.shape[0] and j < p.shape[1] \
                    and p[i, j] > 0:
                return int(p[i, j]) - 1
        elif size == 32:
            p = self.plan.get("mode32")
            i, j = r // 8, c // 8
            if p is not None and i < p.shape[0] and j < p.shape[1] \
                    and p[i, j] >= 0:
                return int(p[i, j])
        elif size == 16:
            p = self.plan.get("mode16")
            i, j = r // 4, c // 4
            if p is not None and i < p.shape[0] and j < p.shape[1] \
                    and p[i, j] >= 0:
                return int(p[i, j])
        return None

    # -- luma tx-depth RD ---------------------------------------------------------

    _TX_CAT = {8: 0, 16: 1, 32: 2, 64: 3, 128: 3}

    def _tx_ctx(self, r: int, c: int, btx: int) -> int:
        """tx_depth cdf ctx: (aboveTxW >= maxTxW) + (leftTxH >= maxTxH);
        unavailable neighbors contribute 0 (dav1d get_tx_ctx with the -1
        reset)."""
        above = int(self.above_txw[c]) if r > 0 else 0
        left = int(self.left_txh[r & self._lm]) if c > 0 else 0
        return (1 if above >= btx else 0) + (1 if left >= btx else 0)

    def _tx_size_row(self, size: int, ctx: int):
        cat = self._TX_CAT[size]
        row = self.cdf.tx_size[cat, ctx]
        return row[:3] if cat == 0 else row  # cat 0 codes 2 symbols

    def _emit_tx_depth(self, r: int, c: int, size: int, depth: int) -> None:
        self._sym(self._tx_size_row(size, self._tx_ctx(r, c, min(size, 64))),
                  depth)

    def _tx_depth_cost(self, r: int, c: int, size: int, depth: int) -> int:
        cat = self._TX_CAT[size]
        ctx = self._tx_ctx(r, c, min(size, 64))
        return int(self._cost_txsz[cat][ctx][depth])

    def _txb_edge_counts(
        self, size: int, tx: int, ti: int, tj: int, ntr_blk: int, nbl_blk: int
    ):
        """(num_top_right, num_bottom_left) for the (ti, tj) txb of a
        split block, from txb raster decode order: a top-row txb sees the
        block-interior row above fully decoded to the block's right edge
        (plus the block-level extension); an interior-row txb sees only
        to the block's right edge; only left-column txbs see below-left
        (the left neighbor block's column, plus the block extension)."""
        ntxb = size // tx
        right_in_blk = (ntxb - 1 - tj) * tx
        below_in_blk = (ntxb - 1 - ti) * tx
        ntr = right_in_blk + (ntr_blk if ti == 0 else 0)
        nbl = (below_in_blk + nbl_blk) if tj == 0 else 0
        return min(ntr, tx), min(nbl, tx)

    def _encode_luma_txb(self, px_: int, py_: int, tx: int, y_mode: int,
                         ntr: int, nbl: int, can_code: bool = True,
                         forced_tt: int = -1, allow_duel: bool = True):
        """Predict one luma txb from the current recon, quantize (RDOQ),
        two-way ADST RD for tx 8/16. Returns (levels, pred, tx_type).
        forced_tt >= 0 replays a recorded transform choice: quantize under
        that transform only, no rate estimate (mirrors oav1tile.c).
        allow_duel=False keeps the DCT path + rate but skips the tx-type
        duel (the two-phase tx search, mirrors oav1tile.c)."""
        ha, hl = py_ > 0, px_ > 0
        above, left = build_edges(
            self.recon[0], px_, py_, tx, tx, ha, hl, self.bitdepth,
            num_top_right=ntr, num_bottom_left=nbl,
        )
        pred = predict(y_mode, above, left, tx, tx, ha, hl,
                       bitdepth=self.bitdepth)
        if not can_code:
            return np.zeros((tx, tx), dtype=np.int64), pred, "dct_dct", 256
        resid = self.src[0][py_ : py_ + tx, px_ : px_ + tx] - pred
        if forced_tt >= 0:
            if tx in (8, 16) and forced_tt == 2:
                tt = "idtx"
            elif tx in (8, 16) and forced_tt == 1:
                tt = "adst_adst"
            else:
                tt = "dct_dct"
            return self._quantize(resid, tx, tt, ptype=0), pred, tt, 0
        levels, e2 = self._quantize_rd(resid, tx, ptype=0)
        rate = self._rate_estimate_txb(levels, tx, 0)
        tx_type = "dct_dct"
        nnz_gate = 1 if self.speed <= 4 else 6
        if (tx in (8, 16) and int((levels != 0).sum()) >= nnz_gate
                and self.speed <= 9 and allow_duel):
            # three-way transform RD in the COEFFICIENT domain (the AV1
            # integer transforms share one gain per size, so SSEs are
            # comparable): DCT vs ADST vs IDTX — identity is the
            # screen-content transform (hard edges keep their energy
            # compact in the pixel basis); no inverse for the losers
            shift = DQ_SHIFT[tx]
            lam = float(
                ((self.dq_ac * self.dq_ac) >> (2 * shift)) * RDOQ_KNUM
            ) / (RDOQ_KDEN * 128.0) * self._lam_scale
            best_rd = e2 + lam * float(rate)
            cands = ["adst_adst"]
            # IDTX (identity transform, the screen-content tool) wins
            # L2-fairly — measured -8..-17% bytes at iso-q on text — but
            # per-pixel quantization damages exactly the structures
            # SSIMULACRA2 weights (posterized gradients, softened glyph
            # edges: -2..-12 score). Under the default perceptual tune
            # that trade LOSES on the target-quality curve, so IDTX arms
            # only for --tune ssim (MSE-faithful tuning), on
            # palette-class blocks (<= 8 distinct source values).
            if self._idtx_on:
                srcb = self.src[0][py_ : py_ + tx, px_ : px_ + tx]
                if len(np.unique(srcb)) <= 8:
                    cands.append("idtx")
            for tt in cands:
                lv_c, e2_c = self._quantize_rd(resid, tx, tt)
                rate_c = self._rate_estimate_txb(lv_c, tx, 0)
                rd_c = e2_c + lam * float(rate_c)
                if rd_c < best_rd:
                    best_rd = rd_c
                    levels = lv_c
                    tx_type = tt
                    rate = rate_c
        return levels, pred, tx_type, rate

    def _try_luma_depth(self, x: int, y: int, size: int, depth: int,
                        y_mode: int, ntr_blk: int, nbl_blk: int,
                        forced_tt=None, allow_duel: bool = True):
        """Trial-encode the block's luma at the given tx depth. Writes the
        trial recon into self.recon[0] and restores it before returning
        (the final coding pass rewrites it). Returns (jobs, dist, rate,
        recon_block) or None for an all-zero split (see caller)."""
        btx = min(size, 64)
        tx = btx >> depth
        n = size // tx
        lo, hi = 0, (1 << self.bitdepth) - 1
        region = self.recon[0][y : y + size, x : x + size]
        saved = region.copy()
        jobs = []
        rate = 0
        any_nz = False
        for ti in range(n):
            for tj in range(n):
                px_, py_ = x + tj * tx, y + ti * tx
                if depth == 0:
                    ntr, nbl = ntr_blk, nbl_blk
                else:
                    ntr, nbl = self._txb_edge_counts(
                        size, tx, ti, tj, ntr_blk, nbl_blk
                    )
                idx = ti * n + tj
                levels, pred, tt, r_txb = self._encode_luma_txb(
                    px_, py_, tx, y_mode, ntr, nbl, can_code=size >= 8,
                    forced_tt=forced_tt[idx] if forced_tt else -1,
                    allow_duel=allow_duel,
                )
                if np.any(levels):
                    any_nz = True
                    rec = np.clip(
                        pred + self._dequant_inv(levels, tx, tt), lo, hi
                    )
                else:
                    rec = np.clip(pred, lo, hi)
                self.recon[0][py_ : py_ + tx, px_ : px_ + tx] = rec
                jobs.append((levels, pred, tt, px_, py_))
                rate += r_txb
                if tx <= 16:
                    rate += 256  # tx_type symbol, ~2 bits
        if depth > 0 and not any_nz:
            self.recon[0][y : y + size, x : x + size] = saved
            return None
        src = self.src[0][y : y + size, x : x + size]
        dist = int(
            ((src - self.recon[0][y : y + size, x : x + size]).astype(np.int64)
             ** 2).sum()
        )
        recon_blk = self.recon[0][y : y + size, x : x + size].copy()
        self.recon[0][y : y + size, x : x + size] = saved
        return jobs, dist, rate, recon_blk

    def _rate_estimate_txb(self, levels: np.ndarray, tx: int, ptype: int) -> int:
        """Approximate coded bits (1/128 units) of one txb from the RDOQ
        cost tables: eob_pt + per-coefficient base/br/golomb/sign costs
        with pad-neighbor contexts (no adaptation). Deterministic and
        mirrored in C for the tx-depth decision."""
        cw = min(tx, 32)
        n_coded = cw * cw
        scan = self._scan_cache[cw]
        txs_ctx = _TXS_CTX[tx]
        ct = self._cost_tables(txs_ctx, ptype)
        cost_base = ct["base"]
        cost_base_eob = ct["base_eob"]
        cost_br = ct["br"]
        cost_eob_extra = ct["eob_extra"]
        cost_eob_pt = self._cost_eob_pt[n_coded][ptype][0].tolist()

        flat = np.abs(levels[:cw, :cw]).reshape(-1)
        order = flat[scan]
        nz = np.nonzero(order)[0]
        if len(nz) == 0:
            return 256  # txb_skip=1, ~2 bits
        eob = int(nz[-1]) + 1
        bwl = cw.bit_length() - 1
        pad = np.zeros((cw + 2, cw + 2), dtype=np.int64)
        ofl = order.tolist()
        for si in range(eob):
            if ofl[si]:
                pad[int(scan[si]) >> bwl, int(scan[si]) & (cw - 1)] = min(
                    ofl[si], 127
                )

        if eob == 1:
            pt = 1
        elif eob == 2:
            pt = 2
        else:
            pt = (eob - 1).bit_length() + 1
        r = 128 + cost_eob_pt[pt - 1]  # txb_skip(0) ~1 bit + eob_pt
        if pt >= 3:
            nbits = pt - 2
            rest = eob - (1 << (pt - 2)) - 1
            msb = (rest >> (nbits - 1)) & 1
            r += cost_eob_extra[pt - 3][msb] + 128 * (nbits - 1)

        for si in range(eob - 1, -1, -1):
            lvl = ofl[si]
            pos = int(scan[si])
            rr, cc = pos >> bwl, pos & (cw - 1)
            if si == eob - 1:
                if si == 0:
                    ectx = 0
                elif si <= n_coded // 8:
                    ectx = 1
                elif si <= n_coded // 4:
                    ectx = 2
                else:
                    ectx = 3
                r += cost_base_eob[ectx][(lvl if lvl < 3 else 3) - 1]
            else:
                mag = (
                    min(int(pad[rr, cc + 1]), 3)
                    + min(int(pad[rr + 1, cc]), 3)
                    + min(int(pad[rr + 1, cc + 1]), 3)
                    + min(int(pad[rr, cc + 2]), 3)
                    + min(int(pad[rr + 2, cc]), 3)
                )
                mag = min((mag + 1) >> 1, 4)
                if pos == 0:
                    bctx = 0
                elif rr + cc < 2:
                    bctx = mag + 1
                elif rr + cc < 4:
                    bctx = mag + 6
                else:
                    bctx = mag + 21
                r += cost_base[bctx][lvl if lvl < 3 else 3]
            if lvl:
                r += 128  # sign
            if lvl > 3:
                mag = (
                    min(int(pad[rr, cc + 1]), 15)
                    + min(int(pad[rr + 1, cc]), 15)
                    + min(int(pad[rr + 1, cc + 1]), 15)
                )
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    brctx = mag
                elif rr < 2 and cc < 2:
                    brctx = mag + 7
                else:
                    brctx = mag + 14
                rem = lvl - 3
                for _ in range(4):
                    k = rem if rem < 3 else 3
                    r += cost_br[brctx][k]
                    rem -= k
                    if k < 3:
                        break
                if lvl > 14:
                    r += 128 * (2 * (lvl - 14).bit_length() - 1)
        return r

    def _rate_estimate_rect_txb(self, levels, th, tw, ptype):
        """Rect twin of _rate_estimate_txb: rect scan, rect base-ctx
        bands, eob table keyed by tw*th."""
        from .tables import TABLES

        scan = np.asarray(TABLES[f"scan_{tw}x{th}"])
        n_coded = tw * th
        txs_ctx = self._rect_txs_ctx(th, tw)
        ct = self._cost_tables(txs_ctx, ptype)
        cost_base = ct["base"]
        cost_base_eob = ct["base_eob"]
        cost_br = ct["br"]
        cost_eob_extra = ct["eob_extra"]
        cost_eob_pt = self._cost_eob_pt[n_coded][ptype][0].tolist()

        flat = np.abs(levels).reshape(-1)
        order = flat[scan]
        nz = np.nonzero(order)[0]
        if len(nz) == 0:
            return 256
        eob = int(nz[-1]) + 1
        pad = np.zeros((th + 2, tw + 2), dtype=np.int64)
        ofl = order.tolist()
        for si in range(eob):
            if ofl[si]:
                pad[int(scan[si]) // tw, int(scan[si]) % tw] = min(
                    ofl[si], 127
                )

        if eob == 1:
            pt = 1
        elif eob == 2:
            pt = 2
        else:
            pt = (eob - 1).bit_length() + 1
        r = 128 + cost_eob_pt[pt - 1]
        if pt >= 3:
            nbits = pt - 2
            rest = eob - (1 << (pt - 2)) - 1
            msb = (rest >> (nbits - 1)) & 1
            r += cost_eob_extra[pt - 3][msb] + 128 * (nbits - 1)

        for si in range(eob - 1, -1, -1):
            lvl = ofl[si]
            pos = int(scan[si])
            rr, cc = pos // tw, pos % tw
            if si == eob - 1:
                if si == 0:
                    ectx = 0
                elif si <= n_coded // 8:
                    ectx = 1
                elif si <= n_coded // 4:
                    ectx = 2
                else:
                    ectx = 3
                r += cost_base_eob[ectx][(lvl if lvl < 3 else 3) - 1]
            else:
                mag = (
                    min(int(pad[rr, cc + 1]), 3)
                    + min(int(pad[rr + 1, cc]), 3)
                    + min(int(pad[rr + 1, cc + 1]), 3)
                    + min(int(pad[rr, cc + 2]), 3)
                    + min(int(pad[rr + 2, cc]), 3)
                )
                mag = min((mag + 1) >> 1, 4)
                if pos == 0:
                    bctx = 0
                elif tw > th and cc < 2:
                    bctx = mag + 16
                elif tw < th and rr < 2:
                    bctx = mag + 11
                elif rr + cc < 4:
                    bctx = mag + 6
                else:
                    bctx = mag + 21
                r += cost_base[bctx][lvl if lvl < 3 else 3]
            if lvl:
                r += 128
            if lvl > 3:
                mag = (
                    min(int(pad[rr, cc + 1]), 15)
                    + min(int(pad[rr + 1, cc]), 15)
                    + min(int(pad[rr + 1, cc + 1]), 15)
                )
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    brctx = mag
                elif rr < 2 and cc < 2:
                    brctx = mag + 7
                else:
                    brctx = mag + 14
                rem = lvl - 3
                for _ in range(4):
                    k = rem if rem < 3 else 3
                    r += cost_br[brctx][k]
                    rem -= k
                    if k < 3:
                        break
                if lvl > 14:
                    r += 128 * (2 * (lvl - 14).bit_length() - 1)
        return r

    def _rect_mode_and_levels(self, x, y, bw, bh):
        """Shared by the duel trial and the final rect encode: mode by
        pred SSD over the candidate ladder, then RDOQ levels."""
        from .consts import (
            PAETH_PRED, SMOOTH_H_PRED, SMOOTH_PRED, SMOOTH_V_PRED, V_PRED,
        )
        from .consts import H_PRED as H_PRED_

        have_above, have_left = y > 0, x > 0
        above0, left0 = build_edges(
            self.recon[0], x, y, bw, bh, have_above, have_left,
            self.bitdepth,
        )
        src0 = self.src[0][y : y + bh, x : x + bw]
        candidates = [DC_PRED, V_PRED, H_PRED_, SMOOTH_PRED, PAETH_PRED]
        if self.speed <= 9:
            candidates += [SMOOTH_V_PRED, SMOOTH_H_PRED]
        best = None
        for m in candidates:
            pred = predict(m, above0, left0, bw, bh, have_above,
                           have_left, bitdepth=self.bitdepth)
            ssd = int(((src0 - pred) ** 2).sum())
            if best is None or ssd < best[0]:
                best = (ssd, m, pred)
        _, y_mode, y_pred = best
        levels = self._quantize_rect(src0 - y_pred, bh, bw, 0)
        return y_mode, y_pred, levels

    def _try_rect_luma(self, x, y, part):
        """Real-RD luma trial of a 32-node rect arm (part 1 HORZ /
        2 VERT): encode both sub-blocks sequentially (the second predicts
        from the first's trial recon), restore recon, return
        (dist, rate)."""
        bw, bh = (32, 16) if part == 1 else (16, 32)
        lo, hi = 0, (1 << self.bitdepth) - 1
        region = self.recon[0][y : y + 32, x : x + 32]
        saved = region.copy()
        rate = 0
        for k in range(2):
            sx = x + (16 * k if part == 2 else 0)
            sy = y + (16 * k if part == 1 else 0)
            _, y_pred, levels = self._rect_mode_and_levels(sx, sy, bw, bh)
            if np.any(levels):
                rec = np.clip(
                    y_pred + self._dequant_inv_rect(levels, bh, bw, 0),
                    lo, hi,
                )
            else:
                rec = np.clip(y_pred, lo, hi)
            self.recon[0][sy : sy + bh, sx : sx + bw] = rec
            rate += self._rate_estimate_rect_txb(levels, bh, bw, 0)
        src = self.src[0][y : y + 32, x : x + 32]
        dist = int(((src - self.recon[0][y : y + 32, x : x + 32]).astype(
            np.int64) ** 2).sum())
        self.recon[0][y : y + 32, x : x + 32] = saved
        return dist, rate

    def _try_square_arm(self, r, c, part):
        """Real-RD luma trial of the NONE (part 0) or SPLIT (part 3) arm
        of a 32-node, depth-0 tx, per-block pred-SSD modes. Returns
        (dist, rate) with recon restored."""
        x, y = c * 4, r * 4
        saved = self.recon[0][y : y + 32, x : x + 32].copy()
        rate = 0
        dist = 0
        coords = ([(r, c, 32)] if part == 0 else
                  [(r + dr, c + dc, 16) for dr in (0, 4) for dc in (0, 4)])
        for (br, bc, bs) in coords:
            bx, by = bc * 4, br * 4
            y_mode, _, _, _ = self._choose_y_mode(br, bc, bs)
            ntr, nbl = self._edge_counts(br, bc, bs)
            trial = self._try_luma_depth(bx, by, bs, 0, y_mode, ntr, nbl)
            jobs, d, rt, recon_blk = trial
            self.recon[0][by : by + bs, bx : bx + bs] = recon_blk
            dist += d
            rate += rt
        self.recon[0][y : y + 32, x : x + 32] = saved
        return dist, rate

    # -- quant / dequant --------------------------------------------------------

    def _quantize(self, resid: np.ndarray, tx: int,
                  tx_type: str = "dct_dct", ptype: int = 0) -> np.ndarray:
        """Rate-distortion optimized quantization (trellis-lite RDOQ).

        Round-half initial levels, then a greedy reverse-scan optimization
        against the real CDF bit costs: eob shrinking (each trailing coeff
        pays an eob move + base_eob/base cost delta) and per-coefficient
        level decrements (L vs L−1), both judged by coefficient-domain
        D + λR with λ ∝ dq². Replaces the round-1 shaped deadzone + tail
        trim (libaom's edge at iso-score traced to exactly this machinery,
        see PARITY.md)."""
        return self._quantize_rd(resid, tx, tx_type, ptype)[0]

    def _quantize_rd(self, resid: np.ndarray, tx: int,
                     tx_type: str = "dct_dct", ptype: int = 0):
        """RDOQ quantize returning (levels, coefficient-domain SSE). The
        SSE accumulates in scan order (identical loop order in C) so
        transform-type RD can compare candidates without inverse
        transforms."""
        if not resid.any():
            return np.zeros((tx, tx), dtype=np.int64), 0.0
        coeffs = fwd_txfm2d_int(resid, tx_type, self.bitdepth)
        return self._rdoq(coeffs, tx, ptype)

    def _cost_tables(self, txs_ctx: int, ptype: int):
        key = (txs_ctx, ptype)
        ct = self._cost_cache.get(key)
        if ct is None:
            ct = {
                "base": self._cost_base[txs_ctx][ptype].tolist(),
                "base_eob": self._cost_base_eob[txs_ctx][ptype].tolist(),
                "br": self._cost_br[min(txs_ctx, 3)][ptype].tolist(),
                "eob_extra": self._cost_eob_extra[txs_ctx][ptype].tolist(),
            }
            self._cost_cache[key] = ct
        return ct

    def _rdoq(self, coeffs: np.ndarray, tx: int, ptype: int) -> np.ndarray:
        shift = DQ_SHIFT[tx]
        cw = min(tx, 32)
        n_coded = cw * cw
        scan = self._scan_cache[cw]
        txs_ctx = _TXS_CTX[tx]
        ct = self._cost_tables(txs_ctx, ptype)
        cost_base = ct["base"]
        cost_base_eob = ct["base_eob"]
        cost_br = ct["br"]
        cost_eob_extra = ct["eob_extra"]
        cost_eob_pt = self._cost_eob_pt[n_coded][ptype][0].tolist()

        dqd = self.dq_dc
        dqa = self.dq_ac_uv if ptype else self.dq_ac
        lam = float(((dqa * dqa) >> (2 * shift)) * RDOQ_KNUM) / (
            RDOQ_KDEN * 128.0
        ) * self._lam_scale
        bwl = cw.bit_length() - 1

        flat = coeffs[:cw, :cw].reshape(-1)
        a_nat = np.abs(flat)  # float64 magnitudes, natural order
        sg_nat = np.where(flat < 0.0, -1, 1)

        # initial round-half levels
        up = float(1 << shift)
        dq_nat = np.full(n_coded, float(dqa))
        dq_nat[0] = float(dqd)
        l0 = np.floor(a_nat * up / dq_nat + 0.5).astype(np.int64)
        order = l0[scan]
        nz = np.nonzero(order)[0]
        out = np.zeros((tx, tx), dtype=np.int64)
        if len(nz) == 0:
            a_s = np.asarray(a_nat, dtype=np.float64)[scan]
            return out, _sum8(a_s * a_s)
        eob = int(nz[-1]) + 1

        a_scan = a_nat[scan]
        if self.speed >= 10:
            # speed 10: plain round-half quantization, no RDOQ passes
            lv_nat0 = np.zeros(n_coded, dtype=np.int64)
            for si in range(eob):
                if order[si]:
                    p = int(scan[si])
                    lv_nat0[p] = order[si] * int(sg_nat[p])
            out[:cw, :cw] = lv_nat0.reshape(cw, cw)
            lvl_f = np.zeros(n_coded, dtype=np.int64)
            lvl_f[:eob] = np.asarray(order[:eob], dtype=np.int64)
            dq_f = np.full(n_coded, int(dqa), dtype=np.int64)
            dq_f[np.asarray(scan) == 0] = int(dqd)
            e = (np.asarray(a_scan, dtype=np.float64)
                 - ((lvl_f * dq_f) >> shift).astype(np.float64))
            return out, _sum8(e * e)
        dq_scan = [dqd if int(scan[si]) == 0 else dqa for si in range(eob)]
        pos_r = [int(scan[si]) >> bwl for si in range(eob)]
        pos_c = [int(scan[si]) & (cw - 1) for si in range(eob)]

        pad = np.zeros((cw + 2, cw + 2), dtype=np.int64)
        ofl = order.tolist()
        for si in range(eob):
            if ofl[si]:
                pad[pos_r[si], pos_c[si]] = min(ofl[si], 127)

        # frequency-weighted RDOQ distortion (mirrors oav1tile.c WS):
        # HF error is discounted on non-screen frames — SSIMULACRA2's
        # pyramid can't see it, so MSE-faithful decrements under-fire
        hf_a = self._rdoq_hf_uv if ptype else self._rdoq_hf
        hf_den = float(n_coded)

        def err2(si: int, lvl: int) -> float:
            e = float(a_scan[si]) - float((lvl * dq_scan[si]) >> shift)
            if hf_a > 0.0:
                return e * e * (1.0 / (1.0 + hf_a * float(si) / hf_den))
            return e * e

        def hi_cost(lvl: int, brctx: int) -> int:
            r = 0
            rem = lvl - 3
            row = cost_br[brctx]
            for _ in range(4):
                k = rem if rem < 3 else 3
                r += row[k]
                rem -= k
                if k < 3:
                    break
            if lvl > 14:
                r += 128 * (2 * (lvl - 14).bit_length() - 1)
            return r

        def base_ctx(si: int) -> int:
            rr, cc = pos_r[si], pos_c[si]
            mag = (
                min(int(pad[rr, cc + 1]), 3)
                + min(int(pad[rr + 1, cc]), 3)
                + min(int(pad[rr + 1, cc + 1]), 3)
                + min(int(pad[rr, cc + 2]), 3)
                + min(int(pad[rr + 2, cc]), 3)
            )
            mag = min((mag + 1) >> 1, 4)
            if rr == 0 and cc == 0:
                return 0
            if rr + cc < 2:
                return mag + 1
            if rr + cc < 4:
                return mag + 6
            return mag + 21

        def br_ctx(si: int) -> int:
            rr, cc = pos_r[si], pos_c[si]
            mag = (
                min(int(pad[rr, cc + 1]), 15)
                + min(int(pad[rr + 1, cc]), 15)
                + min(int(pad[rr + 1, cc + 1]), 15)
            )
            mag = min((mag + 1) >> 1, 6)
            if pos_r[si] == 0 and pos_c[si] == 0:
                return mag
            if rr < 2 and cc < 2:
                return mag + 7
            return mag + 14

        def eob_ctx(si: int) -> int:
            if si == 0:
                return 0
            if si <= n_coded // 8:
                return 1
            if si <= n_coded // 4:
                return 2
            return 3

        def int_cost(lvl: int, bctx: int, si: int) -> int:
            r = cost_base[bctx][lvl if lvl < 3 else 3]
            if lvl:
                r += 128  # sign
                if lvl > 3:
                    r += hi_cost(lvl, br_ctx(si))
            return r

        def eob_coeff_cost(lvl: int, si: int) -> int:
            r = cost_base_eob[eob_ctx(si)][(lvl if lvl < 3 else 3) - 1] + 128
            if lvl > 3:
                r += hi_cost(lvl, br_ctx(si))
            return r

        def eobpt_cost(e: int) -> int:
            if e == 1:
                pt = 1
            elif e == 2:
                pt = 2
            else:
                pt = (e - 1).bit_length() + 1
            r = cost_eob_pt[pt - 1]
            if pt >= 3:
                nbits = pt - 2
                rest = e - (1 << (pt - 2)) - 1
                msb = (rest >> (nbits - 1)) & 1
                r += cost_eob_extra[pt - 3][msb] + 128 * (nbits - 1)
            return r

        # --- phase 1: eob shrinking ---
        while eob > 0:
            si = eob - 1
            lvl = ofl[si]
            keep = err2(si, lvl) + lam * (
                eobpt_cost(eob) + eob_coeff_cost(lvl, si)
            )
            pe = si - 1
            while pe >= 0 and ofl[pe] == 0:
                pe -= 1
            pad[pos_r[si], pos_c[si]] = 0
            if pe < 0:
                if err2(si, 0) < keep:
                    ofl[si] = 0
                    eob = 0
                else:
                    pad[pos_r[si], pos_c[si]] = min(lvl, 127)
                break
            lp = ofl[pe]
            drop = err2(si, 0) + lam * (
                eobpt_cost(pe + 1) + eob_coeff_cost(lp, pe)
            )
            keep += lam * int_cost(lp, base_ctx(pe), pe)
            if drop < keep:
                ofl[si] = 0
                eob = pe + 1
            else:
                pad[pos_r[si], pos_c[si]] = min(lvl, 127)
                break

        if eob > 0:
            # --- phase 2: eob coefficient level decrement (floor 1) ---
            si = eob - 1
            lvl = ofl[si]
            if lvl >= 2:
                if err2(si, lvl - 1) + lam * eob_coeff_cost(
                    lvl - 1, si
                ) < err2(si, lvl) + lam * eob_coeff_cost(lvl, si):
                    ofl[si] = lvl - 1
                    pad[pos_r[si], pos_c[si]] = min(lvl - 1, 127)
            # --- phase 3: interior level decrements (reverse scan) ---
            for si in range(eob - 2, -1, -1):
                lvl = ofl[si]
                if lvl == 0:
                    continue
                bctx = base_ctx(si)
                if err2(si, lvl - 1) + lam * int_cost(
                    lvl - 1, bctx, si
                ) < err2(si, lvl) + lam * int_cost(lvl, bctx, si):
                    ofl[si] = lvl - 1
                    pad[pos_r[si], pos_c[si]] = min(lvl - 1, 127)

        lv_nat = np.zeros(n_coded, dtype=np.int64)
        for si in range(eob):
            if ofl[si]:
                p = int(scan[si])
                lv_nat[p] = ofl[si] * int(sg_nat[p])
        out[:cw, :cw] = lv_nat.reshape(cw, cw)
        lvl_f = np.zeros(n_coded, dtype=np.int64)
        lvl_f[:eob] = np.asarray(ofl[:eob], dtype=np.int64)
        dq_f = np.full(n_coded, int(dqa), dtype=np.int64)
        dq_f[np.asarray(scan) == 0] = int(dqd)
        e = (np.asarray(a_nat, dtype=np.float64)[scan]
             - ((lvl_f * dq_f) >> shift).astype(np.float64))
        return out, _sum8(e * e)

    def _dequant_inv(self, levels: np.ndarray, tx: int,
                     tx_type: str = "dct_dct", ptype: int = 0) -> np.ndarray:
        shift = DQ_SHIFT[tx]
        q = np.full_like(levels, self.dq_ac_uv if ptype else self.dq_ac)
        q[0, 0] = self.dq_dc
        mag = (np.abs(levels) * q) & 0xFFFFFF
        mag >>= shift
        deq = np.sign(levels) * mag
        return inv_txfm2d(deq, self.bitdepth, tx_type)

    # -- coefficient coding -----------------------------------------------------

    def _txb_skip_ctx(self, plane: int, px: int, py: int, tx: int, bsize: int) -> int:
        if plane == 0:
            # ctx 0 iff the tx covers the whole block; a 128 block's
            # TX_64X64 units take the neighbor-derived ctx (dav1d
            # get_coef_skip_ctx compares block dims, not the 64 cap)
            if tx == bsize:
                return 0
            return self._txb_skip_ctx_sub(plane, px, py, tx)
        ps = self.pstate[plane]
        mi_c, mi_r = px // 4, py // 4
        n = tx // 4
        above_nz = np.any(ps.above_lvl[mi_c : mi_c + n] != 0)
        left_nz = np.any(ps.left_lvl[(mi_r & self._lm) : (mi_r & self._lm) + n] != 0)
        offset = 7 if tx == bsize else 10
        return offset + int(above_nz) + int(left_nz)

    def _dc_sign_ctx(self, plane: int, px: int, py: int, tx: int) -> int:
        ps = self.pstate[plane]
        mi_c, mi_r = px // 4, py // 4
        n = tx // 4
        cats = np.concatenate(
            [
                ps.above_dc[mi_c : mi_c + n],
                ps.left_dc[(mi_r & self._lm) : (mi_r & self._lm) + n],
            ]
        )
        bal = int((cats == 2).sum()) - int((cats == 1).sum())
        if bal < 0:
            return 1
        if bal > 0:
            return 2
        return 0

    def _set_lvl_ctx(
        self, plane: int, px: int, py: int, tx: int, cul: int, dc_cat: int
    ) -> None:
        ps = self.pstate[plane]
        mi_c, mi_r = px // 4, py // 4
        n = tx // 4
        ps.above_lvl[mi_c : mi_c + n] = cul
        ps.left_lvl[(mi_r & self._lm) : (mi_r & self._lm) + n] = cul
        ps.above_dc[mi_c : mi_c + n] = dc_cat
        ps.left_dc[(mi_r & self._lm) : (mi_r & self._lm) + n] = dc_cat

    # intra tx-set symbol index per type (validated by decoder probes):
    # set2 (tx16): {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST}
    # set1 (tx4/8): {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST}
    _TXTYPE_SYM2 = {"idtx": 0, "dct_dct": 1, "adst_adst": 2,
                    "adst_dct": 3, "dct_adst": 4}
    _TXTYPE_SYM1 = {"idtx": 0, "dct_dct": 1, "v_dct": 2, "h_dct": 3,
                    "adst_adst": 4, "adst_dct": 5, "dct_adst": 6}

    def _encode_coeffs(
        self, plane: int, tx: int, px: int, py: int, levels2d: np.ndarray,
        bsize: int, y_mode: int = 0, tx_type: str = "dct_dct"
    ) -> None:
        txs_ctx = _TXS_CTX[tx]
        ptype = 0 if plane == 0 else 1
        cw = min(tx, 32)  # coded region (64-pt keeps 32)
        lv = levels2d[:cw, :cw]
        scan32 = self._scan_cache[cw]
        ctx = self._txb_skip_ctx(plane, px, py, tx, bsize)

        # Y-plane tx <= 16 signals intra_tx_type after txb_skip (spec
        # coeffs()/transform_type; tx 32/64 are DCT-only, nothing coded).
        # Intra tx sets (spec get_tx_set): 16x16 -> TX_SET_INTRA_2
        # {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST}; 4x4/8x8 ->
        # TX_SET_INTRA_1 {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT,
        # DCT_ADST}. We always choose DCT_DCT: symbol 1 in both orders
        # (validated by decoder probes in tests/test_conformance.py).
        txtype_row = None
        txtype_sym = 1
        if plane == 0 and tx <= 16:
            if tx == 16:
                bank = self.cdf.intra_ext_tx2
                txtype_sym = self._TXTYPE_SYM2[tx_type]
            else:
                bank = self.cdf.intra_ext_tx1
                txtype_sym = self._TXTYPE_SYM1[tx_type]
            txtype_row = bank[txs_ctx][y_mode]

        if self.enc.coeffs is not None:
            sctx = self._dc_sign_ctx(plane, px, py, tx)
            eob, cul, dc_cat = self.enc.coeffs(
                lv.astype(np.int32),
                scan32,
                self.cdf.txb_skip[txs_ctx][ctx],
                self.cdf.eob_pt[cw * cw][ptype][0],
                self.cdf.eob_extra[txs_ctx][ptype],
                self.cdf.coeff_base_eob[txs_ctx][ptype],
                self.cdf.coeff_base[txs_ctx][ptype],
                # br CDFs clamp at TX_32X32 (spec coeff_br; tx64 reuses
                # the 32 rows — pinned by decoder probes)
                self.cdf.coeff_br[min(txs_ctx, 3)][ptype],
                self.cdf.dc_sign[ptype][sctx],
                txtype_row,
                txtype_sym,
            )
            self._set_lvl_ctx(plane, px, py, tx, cul, dc_cat)
            return

        scan = scan32
        flat = lv.reshape(-1)
        nz = np.nonzero(flat[scan])[0]
        eob = int(nz[-1]) + 1 if len(nz) else 0

        self._sym(self.cdf.txb_skip[txs_ctx][ctx], 1 if eob == 0 else 0)
        if eob == 0:
            self._set_lvl_ctx(plane, px, py, tx, 0, 0)
            return
        if txtype_row is not None:
            self._sym(txtype_row, txtype_sym)

        # eob_pt
        n_coded = cw * cw
        if eob == 1:
            eob_pt = 1
        elif eob == 2:
            eob_pt = 2
        else:
            eob_pt = (eob - 1).bit_length() + 1
        self._sym(self.cdf.eob_pt[n_coded][ptype][0], eob_pt - 1)
        if eob_pt >= 3:
            nbits = eob_pt - 2
            rest = eob - (1 << (eob_pt - 2)) - 1
            msb = (rest >> (nbits - 1)) & 1
            self._sym(
                self.cdf.eob_extra[txs_ctx][ptype][eob_pt - 3], msb
            )
            for i in range(nbits - 2, -1, -1):
                self.enc.bool_q15((rest >> i) & 1, 16384)

        # levels buffer, padded for neighbor context reads
        absl = np.minimum(np.abs(lv), 127).astype(np.int64)
        pad = np.zeros((cw + 2, cw + 2), dtype=np.int64)
        pad[:cw, :cw] = absl

        bwl = cw.bit_length() - 1

        # base + br levels, reverse scan; br interleaves per coefficient
        # immediately after its base symbol (spec coeffs() order).
        for si in range(eob - 1, -1, -1):
            pos = int(scan[si])
            rr, cc = pos >> bwl, pos & (cw - 1)
            level = int(absl[rr, cc])
            if si == eob - 1:
                if si == 0:
                    ctx_eob = 0
                elif si <= n_coded // 8:
                    ctx_eob = 1
                elif si <= n_coded // 4:
                    ctx_eob = 2
                else:
                    ctx_eob = 3
                self._sym(
                    self.cdf.coeff_base_eob[txs_ctx][ptype][ctx_eob],
                    min(level, 3) - 1,
                )
            else:
                mag = (
                    min(int(pad[rr, cc + 1]), 3)
                    + min(int(pad[rr + 1, cc]), 3)
                    + min(int(pad[rr + 1, cc + 1]), 3)
                    + min(int(pad[rr, cc + 2]), 3)
                    + min(int(pad[rr + 2, cc]), 3)
                )
                mag = min((mag + 1) >> 1, 4)
                if pos == 0:
                    base_ctx = 0
                elif rr + cc < 2:
                    base_ctx = mag + 1
                elif rr + cc < 4:
                    base_ctx = mag + 6
                else:
                    base_ctx = mag + 21
                self._sym(
                    self.cdf.coeff_base[txs_ctx][ptype][base_ctx], min(level, 3)
                )
            if level > NUM_BASE_LEVELS_:
                mag = (
                    min(int(pad[rr, cc + 1]), 15)
                    + min(int(pad[rr + 1, cc]), 15)
                    + min(int(pad[rr + 1, cc + 1]), 15)
                )
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    br_ctx = mag
                elif rr < 2 and cc < 2:
                    br_ctx = mag + 7
                else:
                    br_ctx = mag + 14
                remaining = level - 3
                for _ in range(4):
                    k = min(remaining, 3)
                    self._sym(
                        self.cdf.coeff_br[min(txs_ctx, 3)][ptype][br_ctx], k)
                    remaining -= k
                    if k < 3:
                        break

        # signs + golomb, forward scan
        dc_cat = 0
        cul = 0
        for si in range(eob):
            pos = int(scan[si])
            rr, cc = pos >> bwl, pos & (cw - 1)
            v = int(lv[rr, cc])
            level = abs(v)
            cul += level
            if level == 0:
                continue
            sign = 1 if v < 0 else 0
            if si == 0:
                sctx = self._dc_sign_ctx(plane, px, py, tx)
                self._sym(self.cdf.dc_sign[ptype][sctx], sign)
                dc_cat = 1 if sign else 2
            else:
                self.enc.bool_q15(sign, 16384)
            if level > 14:
                self._write_golomb(level - 15)

        self._set_lvl_ctx(plane, px, py, tx, min(cul, 63), dc_cat)

    def _write_golomb(self, value: int) -> None:
        x = value + 1
        n = x.bit_length()
        for _ in range(n - 1):
            self.enc.bool_q15(0, 16384)
        self.enc.bool_q15(1, 16384)
        for i in range(n - 2, -1, -1):
            self.enc.bool_q15((x >> i) & 1, 16384)


# Cross-probe decision cache: one entry per live device-plan instance and
# option set (the TQ loop re-encodes the same tile at nearby quantizers;
# the plan object identity inherits the plan cache's ±16-qindex / q90-gate
# reuse window). The options are those that shape the recorded decisions
# (``_dec_options``): a plan reused in one process under other options
# (another speed, IDTX or ``--tune ssim``, screen tools) must not replay
# decisions those options' headers do not allow. Entry: (id(plan),
# options) -> (weakref(plan), buf, length).
_DEC_CACHE: dict = {}


def _dec_options(speed, screen_tools, filter_intra, sb128):
    """The options a recorded decision set holds for: the speed's tool
    set, IDTX (``OAVIF_IDTX``, which ``--tune ssim`` sets), the screen
    tools, filter intra and the superblock size. Each stays fixed over
    the probes of one search (the chroma AC delta, which follows the
    probe's q, is no part of the key: the probes of a search replay
    across it, as in the reference)."""
    return (speed, os.environ.get("OAVIF_IDTX", "0") == "1",
            bool(screen_tools), bool(filter_intra), bool(sb128))


def _get_dec(plan, tile_planes, qindex, speed=9, options=()):
    import os

    if plan is None or os.environ.get("OAVIF_DEC_REUSE", "1") == "0":
        return None, False
    if speed <= 4:
        # quality speeds: every probe re-derives exact per-q decisions
        return None, False
    key = (id(plan), options)
    ent = _DEC_CACHE.get(key)
    if ent is not None and ent[0]() is plan:
        return {"mode": 2, "buf": ent[1], "len": ent[2]}, False
    _DEC_CACHE.pop(key, None)
    h, w = tile_planes[0].shape
    cap = ((h // 8) + 2) * ((w // 8) + 2) * 10
    return {"mode": 1, "buf": np.zeros(cap, dtype=np.int32), "len": cap}, True


def _store_dec(plan, dec, options=()):
    import weakref

    if len(_DEC_CACHE) > 16:
        _DEC_CACHE.clear()
    _DEC_CACHE[(id(plan), options)] = (weakref.ref(plan), dec["buf"],
                                       dec["len"])


# ---------------------------------------------------------------------------
# The port's frame encode over tiles: the counterpart of the reference's
# planner cache, _attach_device_levels, _encode_one_tile and
# encode_frame_planes, with the GPU planner (encode_tpu.FramePlanner) and
# the GPU encode stage (device_stage.DeviceLevels). The tile coder is the
# native C tile encoder (tile_encode_native), or TileEncoder above under
# OAVIF_PY_TILE=1. Unlike the reference, planning and the device stage are
# not wrapped in a fallback: a planner or a launch that fails raises
# instead of degrading to a host-only search.

import threading  # noqa: E402
import weakref  # noqa: E402
import zlib  # noqa: E402

from ..device import resolve_device  # noqa: E402
from .encode_tpu import MODE_IDS, N_MODES, FramePlanner  # noqa: E402
from .obu import tile_grid  # noqa: E402

_PLANNER_CACHE: dict = {}
_PLANNER_CACHE_LOCK = threading.Lock()
_DIGEST_CACHE: dict = {}
_COUNT_LOCK = threading.Lock()
# 16-blocks whose luma levels the Python tile coder took from the device
# stage, over every encode of this process (TileEncoder.lv16_consumed)
lv16_consumed = 0


def reset_planners() -> None:
    """Drop every cached planner (and its device planes) and the
    cross-probe decision cache keyed by their plans, so that the next
    encode uploads, plans and decides afresh. (The decision cache clears
    itself whenever it passes 16 entries, dead plans' included, so what it
    holds changes which later probes replay decisions.)"""
    with _PLANNER_CACHE_LOCK:
        _PLANNER_CACHE.clear()
        _DIGEST_CACHE.clear()
        _DEC_CACHE.clear()


def planners() -> List[FramePlanner]:
    """The cached planners, oldest first."""
    with _PLANNER_CACHE_LOCK:
        return list(_PLANNER_CACHE.values())


def get_planner(tile_planes, bitdepth, nmodes=13,
                duel_level=0) -> FramePlanner:
    """Planner per tile content and device: the TQ loop re-encodes the
    same planes at several quantizers, and the planes (device-resident in
    the planner) don't change with q. Keyed by a full-content digest (crc32
    of the Y bytes), LRU over 8 entries. Get-or-create is serialized: a
    duplicate planner would break the decision cache's id(plan) binding.

    Plane buffers handed to the encoder are never written in place after
    creation, so the digest is memoized by buffer identity
    (weakref-guarded); OAVIF_DEBUG=1 recomputes and asserts."""
    device = resolve_device()
    y = np.ascontiguousarray(tile_planes[0])
    with _PLANNER_CACHE_LOCK:
        ent = _DIGEST_CACHE.get(id(y))
        if ent is not None and ent[0]() is y:
            digest = ent[1]
            if os.environ.get("OAVIF_DEBUG"):
                assert digest == zlib.crc32(y.tobytes()), \
                    "plane buffer mutated in place (digest memo stale)"
        else:
            digest = zlib.crc32(y.tobytes())
            if len(_DIGEST_CACHE) > 64:
                _DIGEST_CACHE.clear()
            _DIGEST_CACHE[id(y)] = (weakref.ref(y), digest)
        key = (y.shape, len(tile_planes), bitdepth, nmodes, duel_level,
               str(device), digest)
        fp = _PLANNER_CACHE.pop(key, None)  # re-inserted below: LRU order
        if fp is None:
            while len(_PLANNER_CACHE) >= 8:
                _PLANNER_CACHE.pop(next(iter(_PLANNER_CACHE)))
            fp = FramePlanner(tile_planes, bitdepth, nmodes=nmodes,
                              duel_level=duel_level, device=device)
        _PLANNER_CACHE[key] = fp
        return fp


def _attach_device_levels(planner, plan, qindex, bitdepth):
    """Attach the device encode stage's open-loop 16-grid luma levels at
    ``qindex`` to the plan (``plan["lv16"]``, ``plan["lv16_mask"]``): one
    quantization launch and one fetch per probe; the coefficients persist
    across probes of one plan (device_stage.DeviceLevels)."""
    from .device_stage import DeviceLevels

    dl = getattr(planner, "_dlv", None)
    if dl is None:
        dl = planner._dlv = DeviceLevels(planner, bitdepth)
    modes, mask = device_level_modes(plan)
    lv, _ = dl.levels(modes, [qindex])
    plan["lv16"] = lv[0].reshape(mask.shape[0], mask.shape[1], 256)
    plan["lv16_mask"] = mask


def device_level_modes(plan):
    """(modes, mask) of the plan's 16-grid for the device encode stage:
    mode indices 0..6 (int32, 0 outside the mask) and the blocks whose
    levels the coder may consume."""
    m16 = np.asarray(plan["mode16"])
    # consume only planner base-mode wins without a directional nominee
    low = m16 & 0xFF
    mask = (m16 < 256) & np.isin(low, MODE_IDS[:N_MODES])
    # frame-edge blocks use the decoder's single-edge/128 prediction
    # formulas the planner only approximates with edge fills; keep them
    # on the exact host path
    mask[0, :] = False
    mask[:, 0] = False
    idx = np.zeros_like(m16)
    for i, s in enumerate(MODE_IDS[:N_MODES]):
        idx[low == s] = i
    return np.where(mask, idx, 0).astype(np.int32), mask


def _encode_one_tile(args):
    global lv16_consumed
    (tile_planes, qindex, bitdepth, speed, u_ac_delta_q, screen_tools,
     filter_intra, lr, sb128) = args
    plan = None
    # The planner arms on real frames only (at least 256x256 pixels);
    # smaller tiles take the coder's own host search, as in the reference.
    # It also stays off below speed 6, where the reference gets no plan
    # either: its duel level 2 packs a 32-grid runner-up that its
    # unpack_plan cannot index, and the IndexError is swallowed into a
    # host-only search.
    if (os.environ.get("OAVIF_TPU_PLANNER", "1") != "0"
            and qindex > 0 and 6 <= speed <= 9
            and np.asarray(tile_planes[0]).size >= 256 * 256):
        # 7 modes + directional nomination; speed 6 adds host runner-up
        # duels at the 16 grid
        duel_level = 1 if speed <= 6 else 0
        planner = get_planner(tile_planes, bitdepth, 13, duel_level)
        plan = planner.plan(qindex, exact=speed <= 4)
        # the device encode stage: only the Python coder consumes levels
        if plan is not None and os.environ.get("OAVIF_PY_TILE") == "1":
            from .device_stage import device_levels_enabled

            if device_levels_enabled():
                _attach_device_levels(planner, plan, qindex, bitdepth)

    options = _dec_options(speed, screen_tools, filter_intra, sb128)
    dec, record = _get_dec(plan, tile_planes, qindex, speed, options)

    if os.environ.get("OAVIF_PY_TILE") != "1":
        # production path: the whole per-tile serial loop in C
        from .entropy.fast import tile_encode_native

        res = tile_encode_native(tile_planes, qindex, bitdepth, speed, plan,
                                 u_ac_delta_q, dec=dec,
                                 screen_tools=screen_tools,
                                 filter_intra=filter_intra, lr=lr,
                                 sb128=sb128)
        if res is None:
            raise RuntimeError(
                "native tile coder unavailable: the C runtime "
                "(oavif_tpu_torch/av1/entropy) failed to build")
        if record and dec is not None:
            _store_dec(plan, dec, options)
        return res

    te = TileEncoder(tile_planes, qindex, bitdepth, speed, plan=plan,
                     u_ac_delta_q=u_ac_delta_q, dec=dec,
                     screen_tools=screen_tools, filter_intra=filter_intra,
                     lr=lr, sb128=sb128)
    payload = te.encode()
    if record and dec is not None:
        _store_dec(plan, dec, options)
    with _COUNT_LOCK:
        lv16_consumed += te.lv16_consumed
    return payload, [r.copy() for r in te.recon], te.blocks


def encode_frame_planes(
    planes: List[np.ndarray],
    qindex: int,
    bitdepth: int = 8,
    speed: int = 9,
    tile_cols_log2: int = 0,
    tile_rows_log2: int = 0,
    max_threads: int = 1,
    u_ac_delta_q: int = 0,
    screen_tools: bool = False,
    filter_intra: bool = False,
    lr=None,
    sb128: bool = False,
):
    """Encode YUV444 planes -> (list of tile payloads, padded recon planes,
    coded blocks).

    Tiles are AV1's parallel axis: each tile encodes as an isolated
    region, across host threads when max_threads > 1 (the native coder
    releases the GIL). Each tile's partition and mode search is planned on
    the device. OAVIF_TPU_PLANNER=0 turns the planner off (host search
    only), as in the reference."""
    h, w = planes[0].shape
    col_starts, row_starts = tile_grid(w, h, tile_cols_log2, tile_rows_log2)
    jobs = []
    bounds = []
    for r0, r1 in zip(row_starts[:-1], row_starts[1:]):
        for c0, c1 in zip(col_starts[:-1], col_starts[1:]):
            y0, y1 = r0 * 64, min(r1 * 64, h)
            x0, x1 = c0 * 64, min(c1 * 64, w)
            tile_planes = [
                np.ascontiguousarray(p[y0:y1, x0:x1]) for p in planes
            ]
            jobs.append((tile_planes, qindex, bitdepth, speed, u_ac_delta_q,
                         screen_tools, filter_intra, lr, sb128))
            bounds.append((y0, y1, x0, x1))

    if max_threads > 1 and len(jobs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(max_threads, len(jobs))) as ex:
            results = list(ex.map(_encode_one_tile, jobs))
    else:
        results = [_encode_one_tile(j) for j in jobs]

    # assemble the PADDED mi-grid reconstruction: the loop filter operates
    # on the padded plane (the decoder filters the whole mi grid; edges in
    # the padding write into visible pixels). Callers crop to (h, w).
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    recon = [np.zeros((mi_rows * 4, mi_cols * 4), dtype=np.int32)
             for _ in planes]
    payloads = []
    blocks = []
    for (payload, tile_recon, tile_blocks), (y0, y1, x0, x1) in zip(
        results, bounds
    ):
        payloads.append(payload)
        th, tw = tile_recon[0].shape
        for pi in range(len(planes)):
            recon[pi][y0 : y0 + th, x0 : x0 + tw] = tile_recon[pi]
        mi_r0, mi_c0 = y0 // 4, x0 // 4
        blocks += [(mi_r0 + b[0], mi_c0 + b[1]) + tuple(b[2:])
                   for b in tile_blocks]
    return payloads, recon, blocks
