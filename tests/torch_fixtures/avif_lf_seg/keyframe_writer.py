"""An AV1 key-frame writer, symbol by symbol, for the tools libaom never
puts into a key frame, and a small AVIF container writer around it.

    from keyframe_writer import Block, Frame, frame_obus, avif_still
    av1 = frame_obus(Frame(width=128, height=64, ...))
    data = avif_still(av1, frame)

The frame is cut into 64x64 blocks (``Frame.blocks[row][col]``, one per
64x64 of the frame, those past its edge unused), coded with
PARTITION_NONE, or, with 128-pixel superblocks, four of them under one
PARTITION_SPLIT. Each block predicts its luma with DC_PRED, V_PRED or
H_PRED (angle delta 0) and its chroma with UV_DC_PRED, takes the largest
transforms (TX_MODE_LARGEST: 64x64 luma, 32x32 chroma) and codes in each
transform block either nothing (``all_zero``) or one DC level (past 14
with its Exp-Golomb tail): neighbouring blocks then differ by steps that the
deblocking filter smooths or leaves by its level. Around the blocks the
frame header carries what the decoder must read:

- segmentation with any of the eight features in any segment
  (``Frame.features``: 8 lists of 8 values, None where off), the ids
  coded against their prediction before or after ``skip`` as
  SegIdPreSkip says, a SKIP segment's blocks skipped without a symbol;
- delta q and delta LF (``delta_lf_multi`` too), each superblock's
  reduced deltas read at its first block (``Block.dq``, ``Block.dlf``);
- the loop filter levels and sharpness, ``loop_filter_delta_enabled``
  with or without an update of the intra reference delta;
- CDEF with its strength sets and each 64x64's index (``Block.cdef``);
- 4:2:0, 4:4:4 and monochrome, 8 and 10 bits, 64 and 128 superblocks,
  one tile.

Nothing is coded in a block of a lossless segment but its header (such a
stream only serves header tests). The entropy coding is the port's own
``RangeEncoder`` over ``CdfBank``'s defaults, adapting as the decoder
does; the headers are ``BitWriter`` fields in spec order (5.5, 5.9).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from oavif_tpu_torch.av1.consts import coeff_q_ctx
from oavif_tpu_torch.av1.entropy.rangecoder import RangeEncoder, update_cdf
from oavif_tpu_torch.av1.frame import CdfBank, _adaptive
from oavif_tpu_torch.av1.obu import BitWriter, obu
from oavif_tpu_torch.io import avif as A

SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_NAMES = ("ALT_Q", "ALT_LF_Y_V", "ALT_LF_Y_H", "ALT_LF_U", "ALT_LF_V",
             "REF_FRAME", "SKIP", "GLOBALMV")
ALT_LF = (1, 2, 3, 4)
SKIP, PRESKIP_FEATURES = 6, (5, 6, 7)


@dataclass
class Block:
    """One 64x64 block: the DC level of each plane's transform blocks (0
    codes all_zero), skip, the segment id (where it is coded), the luma
    mode (0 DC, 1 V, 2 H), the reduced delta q and DeltaLF values read at
    its superblock's first block, and its 64x64's CDEF index."""

    dc: Tuple[int, int, int] = (0, 0, 0)
    skip: int = 0
    seg: int = 0
    mode: int = 0
    dq: int = 0
    dlf: Tuple[int, int, int, int] = (0, 0, 0, 0)
    cdef: int = 0


@dataclass
class Frame:
    width: int
    height: int
    blocks: List[List[Block]] = field(default_factory=list)
    bitdepth: int = 8
    mono: bool = False
    ss: Tuple[int, int] = (1, 1)  # (1, 1) 4:2:0 or (0, 0) 4:4:4
    sb128: bool = False
    base_q: int = 100
    features: Optional[List[List[Optional[int]]]] = None
    lf: Tuple[int, int, int, int] = (0, 0, 0, 0)
    sharpness: int = 0
    # loop_filter_delta_enabled: None off; else the intra reference
    # delta the update writes, or True for no update (the default 1)
    lf_delta: object = None
    delta_q_res: Optional[int] = None
    delta_lf: Optional[Tuple[int, bool]] = None  # (delta_lf_res, multi)
    # (damping, cdef_bits, strength sets (y pri, y sec, uv pri, uv sec)
    # with the secondary strengths as coded, 0-3)
    cdef: Optional[Tuple[int, int, Sequence[Tuple[int, int, int, int]]]] = None

    @property
    def nplanes(self) -> int:
        return 1 if self.mono else 3

    @property
    def ssxy(self) -> Tuple[int, int]:
        return (1, 1) if self.mono else self.ss

    @property
    def profile(self) -> int:
        return 1 if (not self.mono and self.ss == (0, 0)) else 0

    def seg_on(self, seg: int, j: int) -> bool:
        return self.features is not None and self.features[seg][j] is not None

    @property
    def preskip(self) -> bool:
        return self.features is not None and any(
            row[j] is not None for row in self.features
            for j in PRESKIP_FEATURES)

    @property
    def last_active(self) -> int:
        if self.features is None:
            return 0
        return max([i for i, row in enumerate(self.features)
                    if any(v is not None for v in row)] or [0])

    def seg_lossless(self, seg: int) -> bool:
        q = self.base_q + (self.features[seg][0] or 0
                           if self.features is not None else 0)
        return min(max(q, 0), 255) == 0

    @property
    def coded_lossless(self) -> bool:
        return all(self.seg_lossless(i) for i in range(8))


def _sequence_header(fr: Frame) -> bytes:
    w = BitWriter()
    w.f(fr.profile, 3)
    w.f(1, 1)  # still_picture
    w.f(1, 1)  # reduced_still_picture_header
    w.f(31, 5)  # seq_level_idx: no level's limits
    w.f(15, 4)
    w.f(15, 4)  # 16-bit frame size fields
    w.f(fr.width - 1, 16)
    w.f(fr.height - 1, 16)
    w.f(int(fr.sb128), 1)
    w.f(0, 1)  # enable_filter_intra
    w.f(0, 1)  # enable_intra_edge_filter
    w.f(0, 1)  # enable_superres
    w.f(int(fr.cdef is not None), 1)
    w.f(0, 1)  # enable_restoration
    # color_config
    w.f(int(fr.bitdepth == 10), 1)  # high_bitdepth
    if fr.profile == 0:
        w.f(int(fr.mono), 1)
    w.f(0, 1)  # color_description_present_flag
    w.f(1, 1)  # color_range: full
    if not fr.mono:
        if fr.ss == (1, 1):
            w.f(0, 2)  # chroma_sample_position
        w.f(0, 1)  # separate_uv_delta_q
    w.f(0, 1)  # film_grain_params_present
    w.trailing_bits()
    return w.data()


def _su(w: BitWriter, v: int, n: int) -> None:
    w.f(v & ((1 << n) - 1), n)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _frame_header(fr: Frame) -> BitWriter:
    w = BitWriter()
    w.f(0, 1)  # disable_cdf_update
    w.f(0, 1)  # allow_screen_content_tools
    w.f(0, 1)  # render_and_frame_size_different
    sb = 128 if fr.sb128 else 64
    sb_cols, sb_rows = -(-fr.width // sb), -(-fr.height // sb)
    w.f(1, 1)  # uniform_tile_spacing_flag
    if _tile_log2(1, min(sb_cols, 64)) > 0:
        w.f(0, 1)  # no increment_tile_cols_log2
    if _tile_log2(1, min(sb_rows, 64)) > 0:
        w.f(0, 1)
    w.f(fr.base_q, 8)
    w.f(0, 1)  # DeltaQYDc
    if not fr.mono:
        w.f(0, 1)
        w.f(0, 1)  # DeltaQUDc, DeltaQUAc (no diff_uv_delta)
    w.f(0, 1)  # using_qmatrix
    w.f(int(fr.features is not None), 1)
    if fr.features is not None:
        for row in fr.features:
            for j, v in enumerate(row):
                w.f(int(v is not None), 1)
                if v is None:
                    continue
                if SEG_SIGNED[j]:
                    _su(w, v, SEG_BITS[j] + 1)
                elif SEG_BITS[j]:
                    w.f(v, SEG_BITS[j])
    if fr.base_q > 0:
        w.f(int(fr.delta_q_res is not None), 1)
        if fr.delta_q_res is not None:
            w.f(fr.delta_q_res, 2)
            w.f(int(fr.delta_lf is not None), 1)
            if fr.delta_lf is not None:
                w.f(fr.delta_lf[0], 2)
                w.f(int(fr.delta_lf[1]), 1)
    if not fr.coded_lossless:
        l0, l1, l2, l3 = fr.lf
        w.f(l0, 6)
        w.f(l1, 6)
        if not fr.mono and (l0 or l1):
            w.f(l2, 6)
            w.f(l3, 6)
        w.f(fr.sharpness, 3)
        w.f(int(fr.lf_delta is not None), 1)
        if fr.lf_delta is not None:
            update = fr.lf_delta is not True
            w.f(int(update), 1)
            if update:
                for i in range(8):
                    w.f(int(i == 0), 1)
                    if i == 0:
                        _su(w, int(fr.lf_delta), 7)
                w.f(0, 1)
                w.f(0, 1)  # no mode delta update
        if fr.cdef is not None:
            damping, bits, sets = fr.cdef
            w.f(damping - 3, 2)
            w.f(bits, 2)
            for yp, ys, up, us in sets[: 1 << bits]:
                w.f(yp, 4)
                w.f(ys, 2)
                if not fr.mono:
                    w.f(up, 4)
                    w.f(us, 2)
        w.f(0, 1)  # tx_mode_select: TX_MODE_LARGEST
    w.f(0, 1)  # reduced_tx_set
    w.byte_align()
    return w


def _neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)


class _Tile:
    """The one tile's symbols and the contexts they depend on."""

    def __init__(self, fr: Frame) -> None:
        self.fr = fr
        self.bank = CdfBank(coeff_q_ctx(fr.base_q))
        t = A._tool_tables()
        self.seg_cdf = _adaptive(t["segment_id"])
        self.dq_cdf = _adaptive(t["delta_q"])
        self.dlf_cdf = _adaptive(t["delta_lf"])
        self.dlf_multi = _adaptive(np.tile(t["delta_lf"], (4, 1)))
        self.enc = RangeEncoder()
        self.rows, self.cols = -(-fr.height // 64), -(-fr.width // 64)
        self.mi_rows = 2 * ((fr.height + 7) >> 3)
        self.mi_cols = 2 * ((fr.width + 7) >> 3)
        n4 = 16 * (self.cols + 2)
        m4 = 16 * (self.rows + 2)
        self.above = np.zeros((3, 2, n4), dtype=np.int64)  # level, dc
        self.left = np.zeros((3, 2, m4), dtype=np.int64)
        self.seg = {}  # (row, col) of a 64x64 -> segment_id
        self.skip = {}
        self.mode = {}
        self.segs_used: List[int] = []

    def put(self, cdf, s: int, nsym: int) -> None:
        self.enc.encode_symbol(s, cdf, nsym)
        update_cdf(cdf, s, nsym)

    def literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.enc.encode_bool_q15((v >> i) & 1, 16384)

    def _segment_id(self, r: int, c: int, want: int, skip: int) -> int:
        ul = self.seg.get((r - 1, c - 1), -1) if r and c else -1
        u = self.seg.get((r - 1, c), -1) if r else -1
        lf = self.seg.get((r, c - 1), -1) if c else -1
        pred = (0 if lf == -1 else lf) if u == -1 else \
            (u if lf == -1 else (u if ul == u else lf))
        if skip:
            return pred
        ctx = 0 if ul < 0 else 2 if ul == u == lf else \
            1 if (ul == u or ul == lf or u == lf) else 0
        last = self.fr.last_active
        coded = next(v for v in range(last + 1)
                     if _neg_deinterleave(v, pred, last + 1) == want)
        self.put(self.seg_cdf[ctx], coded, 8)
        return want

    def _delta(self, cdf, v: int) -> None:
        a = abs(v)
        assert a < 3, "deltas of 3 or more are not written here"
        self.put(cdf, a, 4)
        if a:
            self.literal(int(v < 0), 1)

    def _coeffs(self, plane: int, x4: int, y4: int, w4: int, h4: int,
                level: int, tx_ctx: int, skip_ctx: int) -> None:
        """One transform block of w4 x h4 4x4s at (x4, y4) of its plane:
        all_zero, or a DC level alone (eob 1)."""
        b = self.bank
        ptype = int(plane > 0)
        self.put(b.txb_skip[tx_ctx][skip_ctx], int(level == 0), 2)
        cul, cat = 0, 0
        if level:
            a = abs(level)
            self.put(b.eob_pt[1024][ptype][0], 0, 11)  # eob 1
            self.put(b.coeff_base_eob[tx_ctx][ptype][0], min(a, 3) - 1, 3)
            if a > 2:
                rest = a - 3
                for _ in range(4):
                    br = min(rest, 3)
                    self.put(b.coeff_br[min(tx_ctx, 3)][ptype][0], br, 4)
                    rest -= br
                    if br < 3:
                        break
            self._dc_sign(plane, x4, y4, w4, h4, level, ptype)
            if a > 14:  # past the base and range levels: Exp-Golomb
                x = a - 14
                n = x.bit_length()
                self.literal(1, n)  # n - 1 zeros, then a one
                self.literal(x & ((1 << (n - 1)) - 1), n - 1)
            cul, cat = min(63, a), (1 if level < 0 else 2)
        for arr, pos, n in ((self.above, x4, w4), (self.left, y4, h4)):
            arr[plane, 0, pos: pos + n] = cul
            arr[plane, 1, pos: pos + n] = cat

    def _dc_sign(self, plane, x4, y4, w4, h4, level, ptype) -> None:
        sx, sy = self.fr.ssxy if plane else (0, 0)
        max_x4, max_y4 = self.mi_cols >> sx, self.mi_rows >> sy
        s = 0
        for arr, pos, n, mx in ((self.above, x4, w4, max_x4),
                                (self.left, y4, h4, max_y4)):
            cats = arr[plane, 1, pos: min(pos + n, mx)]
            s += int((cats == 2).sum() - (cats == 1).sum())
        ctx = 1 if s < 0 else 2 if s > 0 else 0
        self.put(self.bank.dc_sign[ptype][ctx], int(level < 0), 2)

    def _chroma_skip_ctx(self, plane, x4, y4, w4, h4, bigger) -> int:
        sx, sy = self.fr.ssxy
        max_x4, max_y4 = self.mi_cols >> sx, self.mi_rows >> sy
        above = self.above[plane, :, x4: min(x4 + w4, max_x4)].any()
        left = self.left[plane, :, y4: min(y4 + h4, max_y4)].any()
        return 7 + int(above) + int(left) + 3 * int(bigger)

    def block(self, r: int, c: int, first_in_sb: bool) -> None:
        fr, b = self.fr, self.bank
        blk = fr.blocks[r][c]
        mi_r, mi_c = 16 * r, 16 * c
        skip_ctx = self.skip.get((r - 1, c), 0) + self.skip.get((r, c - 1), 0)
        seg = 0
        if fr.features is not None and fr.preskip:
            seg = self._segment_id(r, c, blk.seg, 0)
        if fr.preskip and fr.seg_on(seg, SKIP):
            skip = 1
        else:
            skip = blk.skip
            self.put(b.skip[skip_ctx], skip, 2)
        if fr.features is not None and not fr.preskip:
            seg = self._segment_id(r, c, blk.seg, skip)
        self.seg[r, c], self.skip[r, c] = seg, skip
        self.segs_used.append(seg)
        if fr.cdef is not None and not skip and not fr.coded_lossless:
            self.literal(blk.cdef, fr.cdef[1])
        sb_sized = not fr.sb128
        if (fr.delta_q_res is not None and first_in_sb
                and not (sb_sized and skip)):
            self._delta(self.dq_cdf, blk.dq)
            if fr.delta_lf is not None:
                if fr.delta_lf[1]:
                    for i in range(2 if fr.mono else 4):
                        self._delta(self.dlf_multi[i], blk.dlf[i])
                else:
                    self._delta(self.dlf_cdf, blk.dlf[0])
        ctx_of = (0, 1, 2)  # Intra_Mode_Context of DC, V and H
        above = ctx_of[self.mode.get((r - 1, c), 0)]
        left = ctx_of[self.mode.get((r, c - 1), 0)]
        self.put(b.kf_y[above][left], blk.mode, 13)
        if blk.mode:
            self.put(b.angle_delta[blk.mode - 1], 3, 7)  # delta 0
        self.mode[r, c] = blk.mode
        if not fr.mono:
            self.put(b.uv_mode[blk.mode], 0, 13)  # UV_DC_PRED, no CFL
        if skip:
            for p in range(fr.nplanes):
                sx, sy = fr.ssxy if p else (0, 0)
                self.above[p, :, mi_c >> sx: (mi_c + 16) >> sx] = 0
                self.left[p, :, mi_r >> sy: (mi_r + 16) >> sy] = 0
            return
        # luma: TX_64X64 (coded in its 32x32 context), txSzCtx 4, ctx 0
        if mi_r < self.mi_rows and mi_c < self.mi_cols:
            self._coeffs(0, mi_c, mi_r, 16, 16, blk.dc[0], 4, 0)
        for p in range(1, fr.nplanes):
            sx, sy = fr.ssxy
            bw4, bh4 = 16 >> sx, 16 >> sy
            for ty in range(0, bh4, 8):
                for tx in range(0, bw4, 8):
                    x4, y4 = (mi_c >> sx) + tx, (mi_r >> sy) + ty
                    if x4 >= self.mi_cols >> sx or y4 >= self.mi_rows >> sy:
                        continue
                    ctx = self._chroma_skip_ctx(p, x4, y4, 8, 8,
                                                bw4 * bh4 > 64)
                    self._coeffs(p, x4, y4, 8, 8, blk.dc[p], 3, ctx)

    def encode(self) -> bytes:
        fr = self.fr
        if not fr.sb128:
            for r in range(self.rows):
                self.left[:] = 0
                for c in range(self.cols):
                    self.put(self.bank.partition[64][0], 0, 10)  # NONE
                    self.block(r, c, True)
            return self.enc.done()
        mi_rows, mi_cols = self.mi_rows, self.mi_cols
        for r2 in range(0, self.rows, 2):
            self.left[:] = 0
            for c2 in range(0, self.cols, 2):
                ctx = 2 * int(c2 > 0) + int(r2 > 0)
                self.put(self.bank.partition[128][ctx], 3, 8)  # SPLIT
                first = True
                for r, c in ((r2, c2), (r2, c2 + 1), (r2 + 1, c2),
                             (r2 + 1, c2 + 1)):
                    if 16 * r >= mi_rows or 16 * c >= mi_cols:
                        continue
                    self.put(self.bank.partition[64][0], 0, 10)
                    self.block(r, c, first)
                    first = False
        return self.enc.done()


def frame_obus(fr: Frame, header: Optional[Frame] = None) -> bytes:
    """The sequence header and frame OBUs of a frame; with ``header``,
    that frame's headers over fr's tile (a stream a decoder misreads)."""
    for size in (fr.width, fr.height):
        for n in (64, 128) if fr.sb128 else (64,):
            assert size % n == 0 or size % n > n // 2, \
                "the frame must not end in the first half of a block"
    data = _Tile(fr).encode()
    head = header or fr
    return obu(1, _sequence_header(head)) + obu(
        6, _frame_header(head).data() + data)


# ---------------------------------------------------------------------------
# AVIF containers
# ---------------------------------------------------------------------------


def box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


def fullbox(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def av1c(fr: Frame) -> bytes:
    """The av1C property of the frame's sequence header."""
    sx, sy = fr.ssxy
    return box(b"av1C", bytes([
        0x81, (fr.profile << 5) | 31,
        (int(fr.bitdepth == 10) << 6) | (int(fr.mono) << 4) | (sx << 3)
        | (sy << 2), 0]))


def ispe(w: int, h: int) -> bytes:
    return fullbox(b"ispe", 0, 0, struct.pack(">II", w, h))


def pixi(fr: Frame) -> bytes:
    return fullbox(b"pixi", 0, 0, bytes([fr.nplanes]
                                        + [fr.bitdepth] * fr.nplanes))


@dataclass
class Item:
    """An item of an AVIF file: its id, type, data and properties (the
    boxes, and whether each is essential)."""

    item_id: int
    typ: bytes
    data: bytes
    props: List[Tuple[bytes, bool]] = field(default_factory=list)
    hidden: bool = False


def avif_file(items: Sequence[Item], primary: int,
              refs: Sequence[Tuple[bytes, int, Sequence[int]]] = (),
              groups: Sequence[Tuple[bytes, int, Sequence[int]]] = (),
              brands: Sequence[bytes] = (b"avif", b"mif1", b"miaf"),
              major: bytes = b"avif") -> bytes:
    """An AVIF file: ``ftyp``, a ``meta`` with ``hdlr``, ``pitm``,
    ``iloc`` (the data in ``mdat``), ``iinf``, ``iref`` (``refs``: type,
    from, to ids), ``grpl`` (``groups``: type, group id, entity ids) and
    ``iprp`` (shared property boxes written once)."""
    ftyp = box(b"ftyp", major + struct.pack(">I", 0) + b"".join(brands))
    hdlr = fullbox(b"hdlr", 0, 0, struct.pack(">I4s3I", 0, b"pict", 0, 0, 0)
                   + b"\x00")
    pitm = fullbox(b"pitm", 0, 0, struct.pack(">H", primary))
    infes = b"".join(fullbox(b"infe", 2, int(it.hidden), struct.pack(
        ">HH4s", it.item_id, 0, it.typ) + b"\x00") for it in items)
    iinf = fullbox(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)
    iref = b""
    if refs:
        iref = fullbox(b"iref", 0, 0, b"".join(
            box(t, struct.pack(">HH", a, len(to))
                + b"".join(struct.pack(">H", x) for x in to))
            for t, a, to in refs))
    grpl = b""
    if groups:
        grpl = box(b"grpl", b"".join(
            fullbox(t, 0, 0, struct.pack(">II", gid, len(ids))
                    + b"".join(struct.pack(">I", x) for x in ids))
            for t, gid, ids in groups))
    props: List[bytes] = []
    assoc = b""
    for it in items:
        idx = []
        for p, essential in it.props:
            if p not in props:
                props.append(p)
            idx.append((props.index(p) + 1) | (0x80 if essential else 0))
        assoc += struct.pack(">HB", it.item_id, len(idx)) + bytes(idx)
    iprp = box(b"iprp", box(b"ipco", b"".join(props)) + fullbox(
        b"ipma", 0, 0, struct.pack(">I", len(items)) + assoc))

    def meta(offsets):
        iloc = fullbox(b"iloc", 0, 0, struct.pack(">BBH", 0x44, 0,
                                                  len(items)) + b"".join(
            struct.pack(">HHHII", it.item_id, 0, 1, off, len(it.data))
            for it, off in zip(items, offsets)))
        return fullbox(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref
                       + grpl + iprp)

    start = len(ftyp) + len(meta([0] * len(items))) + 8
    offsets, pos = [], start
    for it in items:
        offsets.append(pos)
        pos += len(it.data)
    return ftyp + meta(offsets) + box(b"mdat", b"".join(
        it.data for it in items))


def avif_still(av1: bytes, fr: Frame) -> bytes:
    """One colour item holding the frame's stream."""
    nclx = box(b"colr", b"nclx" + struct.pack(">HHHB", 2, 2, 2, 0x80))
    item = Item(1, b"av01", av1, [(ispe(fr.width, fr.height), False),
                                  (pixi(fr), False), (av1c(fr), True),
                                  (nclx, False)])
    return avif_file([item], 1)
