"""An AV1 inter-frame writer, symbol by symbol, for the inter tools libaom
3.6's realtime usage never writes into a layered image: the sharp and
bilinear filters, two filters per block (``enable_dual_filter``), chroma
predicted from several 4x4 blocks' MVs, loop filter mode deltas, the
motion modes OBMC and LOCALWARP where libaom would not pick them: local
warps that fall back to translation, OBMC beside two filters, both at
3840x2160 (``motion=True``); and compound blocks (``pair``) in every
compound mode and type, on any reference pair, distance-weighted under
``enable_jnt_comp`` (which libaom's realtime usage turns off), over one
layer of libaom or two (``base_layers``, so that the two references lie
at different distances); global motion of every type (``gm``: each
reference frame's GmType and gm_params, coded against the primary
reference's, with GLOBALMV and GLOBAL_GLOBALMV blocks beside NEARESTMV,
NEARMV and NEWMV ones, and a second written frame on the first, ``chain``)
and skip_mode blocks (``skip_mode``, ``SkipModeBlock``), with delta q
(``delta_q``) and 128-pixel superblocks where libaom's sequence has them;
inter-intra blocks (``interintra``, ``InterBlock.ii``: every
interintra_mode, smooth or by a wedge); segmentation with its ids before
or after skip, kept from the primary reference frame's map or coded
against it (``seg``, ``InterBlock.seg`` and ``seg_pred``); the adapted
CDFs a chained frame inherits (``end_cdf``) and rows of tiles
(``tile_rows``).

    from inter_writer import InterBlock, write_layered
    data = write_layered(key_obus, blocks, filter=4, dual=True)

The stream is libaom's key frame (layer 0, from ``make_avif_layers``)
under a sequence header written again with the inter tools this frame
needs (``enable_dual_filter``, ``enable_warped_motion`` under ``motion``,
``enable_masked_compound`` and ``enable_jnt_comp`` as asked; no
reference MVs), then one inter frame of spatial layer 1 with every
block inter, skipped (no residual) and predicted from LAST at its own MV
(NEWMV, the difference from its MV stack's prediction coded in MV context
0; or NEARESTMV, NEARMV or GLOBALMV as ``InterBlock.mode`` asks),
filters and motion mode; or, with ``pair``, every block a compound
block of 8x8 or more on that pair of references (``CompoundBlock``: its
mode, type and the MVs of its NEWMV sides); under ``skip_mode`` a
``SkipModeBlock`` is a skip_mode block (8x8 or more) on SkipModeFrame. With ``base_layers`` 2 the
stream keeps libaom's first two layers (their sequence header's inter
tools kept as libaom wrote them) and the frame is layer 2, its
references the key frame (slot 0, order hint 0) or layer 1 (slot 1,
order hint 1) as ``ref_slots`` says. The frame is cut into 64x64 superblocks,
each one block (PARTITION_NONE) or split into square blocks of one size
down to 4x4. Its header takes the default CDFs (``primary_ref_frame``
none), a fixed interpolation filter or SWITCHABLE, loop filter levels
with reference and mode deltas and, under ``motion``,
``is_motion_mode_switchable`` and ``allow_warped_motion``.

The MV stack, its contexts and the symbols' contexts follow the spec
(7.10.2, 8.3.2) as dav1d computes them, here in Python, and so do the
local warp's samples, least squares and shear (spec 7.10.4, 7.11.3.6-8),
with which a block asks for a warp of a kind (``InterBlock.warp``) gets
an MV that makes it; dav1d, which decodes the result, is the judge of
whether they are right. The entropy
coder is the port's ``RangeEncoder`` over the decoder's default CDFs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from oavif_tpu_torch.av1.consts import coeff_q_ctx
from oavif_tpu_torch.av1.entropy.rangecoder import RangeEncoder, update_cdf
from oavif_tpu_torch.av1.obu import BitWriter
from oavif_tpu_torch.io import avif as A

REF_CAT = 640


SIMPLE, OBMC, LOCALWARP = 0, 1, 2
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3
GM_IDENTITY = (0, 0, 1 << 16, 0, 0, 1 << 16)
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)
# compound modes (NEAREST_NEARESTMV + n) and each side's single mode
NEAREST, NEAR, GLOBAL, NEW = "nearest", "near", "global", "new"
COMPOUND_SIDES = ((NEAREST, NEAREST), (NEAR, NEAR), (NEAREST, NEW),
                  (NEW, NEAREST), (NEAR, NEW), (NEW, NEAR), (GLOBAL, GLOBAL),
                  (NEW, NEW))
COMPOUND_TYPES = ("average", "distance", "wedge", "diffwtd")
# spec Compound_Mode_Ctx_Map
COMPOUND_MODE_CTX = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))
# the block sizes (log2 w4 of a square) with wedges: 8x8 to 32x32
WEDGE_SQUARES = {1: 3, 2: 6, 3: 9}
# the segmentation features (spec SEG_LVL_*) the writer acts on
SEG_REF_FRAME, SEG_SKIP, SEG_GLOBALMV = 5, 6, 7


@dataclass
class InterBlock:
    """One inter block: its MV (row, col in 1/8 sample), its filters (y,
    x: 0 regular, 1 smooth, 2 sharp) where they are switchable, its
    motion mode where the frame lets the block choose one, and its
    reference frame (LAST, or in a frame of compound blocks either of the
    pair). ``warp`` asks a
    LOCALWARP block for a kind of warp: "valid", "singular" (LocalValid
    0: no sample within LS_MV_MAX) or "shear" (a shear the warp filter
    cannot follow); the writer then moves ``mv`` until the warp is of
    that kind, where it finds such an MV."""

    mv: Tuple[int, int] = (0, 0)
    filt: Tuple[int, int] = (0, 0)
    motion: int = SIMPLE
    warp: Optional[str] = None
    ref: int = 1  # LAST; another in a frame of compound blocks (``pair``)
    # NEW, or NEAREST, NEAR or GLOBAL (the MV then the stack's or the
    # block's GlobalMv, ``mv`` unused; LOCALWARP only with NEW)
    mode: str = NEW
    # inter-intra (a frame with ``interintra``, 8x8 to 32x32): its
    # interintra_mode (0 II_DC .. 3 II_SMOOTH) and its wedge_index, or None
    # for the smooth mask; the block's motion mode is then SIMPLE
    ii: Optional[Tuple[int, Optional[int]]] = None
    # in a frame with segmentation (``seg``): the block's segment id where
    # it is coded, and under temporal update whether it takes the predicted
    # one instead (seg_id_predicted 1)
    seg: int = 0
    seg_pred: bool = False


@dataclass
class CompoundBlock:
    """One compound block: its compound mode (0 NEAREST_NEARESTMV .. 7
    NEW_NEWMV), its compound type (``COMPOUND_TYPES``; where the frame or
    the block's size does not allow it, the writer takes the nearest one
    it allows), the MVs of its NEWMV sides (row, col in 1/8 sample), its
    filters (y, x) where they are switchable, and its wedge index and
    sign or mask type."""

    mode: int = 0
    ctype: str = "average"
    mv: Tuple[int, int] = (0, 0)
    mv2: Tuple[int, int] = (0, 0)
    filt: Tuple[int, int] = (0, 0)
    wedge: int = 0
    sign: int = 0


@dataclass
class SkipModeBlock:
    """A skip_mode block (8x8 or more, in a frame with ``skip_mode``): one
    symbol, the rest implied."""


def _ref_count_ctx(a: int, b: int) -> int:
    return 0 if a < b else (1 if a == b else 2)


def neg_interleave(x: int, ref: int, n: int) -> int:
    """The segment_id symbol that codes id ``x`` against the predicted
    id ``ref`` among ``n`` (libaom's av1_neg_interleave, the inverse of
    the spec's neg_deinterleave)."""
    if not ref:
        return x
    if ref >= n - 1:
        return n - 1 - x
    diff = x - ref
    if 2 * ref < n:
        if abs(diff) <= ref:
            return 2 * diff - 1 if diff > 0 else -2 * diff
        return x
    if abs(diff) < n - ref:
        return 2 * diff - 1 if diff > 0 else -2 * diff
    return n - 1 - x


def segmentation_params(w: BitWriter, seg: Optional[dict],
                        primary: int) -> None:
    """segmentation_params: ``seg`` None (off) or a dict of ``map``
    ("update", "keep": segmentation_update_map 0, or "temporal":
    segmentation_temporal_update 1; only "update" without a primary
    reference frame), ``data`` (segmentation_update_data, True where
    absent) and ``features`` ({segment: {SEG_LVL_*: value}})."""
    w.f(int(seg is not None), 1)  # segmentation_enabled
    if seg is None:
        return
    mode, data = seg.get("map", "update"), seg.get("data", True)
    if primary == 7:
        assert mode == "update" and data
    else:
        w.f(int(mode != "keep"), 1)  # segmentation_update_map
        if mode != "keep":
            w.f(int(mode == "temporal"), 1)  # segmentation_temporal_update
        w.f(int(data), 1)  # segmentation_update_data
    if not data:
        return
    feats = seg["features"]
    for i in range(8):
        for j in range(8):
            v = feats.get(i, {}).get(j)
            w.f(int(v is not None), 1)
            if v is None:
                continue
            if A._SEG_SIGNED[j]:
                _su(w, v, 1 + A._SEG_BITS[j])
            elif A._SEG_BITS[j]:
                w.f(v, A._SEG_BITS[j])


def _obus(data: bytes):
    pos = 0
    while pos < len(data):
        head = data[pos]
        p = pos + 1 + ((head >> 2) & 1)
        size = shift = 0
        while True:
            b = data[p]
            p += 1
            size |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        yield (head >> 3) & 15, data[pos:p + size], p, p + size
        pos = p + size


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _obu_ext(typ: int, payload: bytes, sid: int) -> bytes:
    """An OBU with its extension header (temporal id 0, spatial ``sid``)."""
    return bytes([(typ << 3) | 0x04 | 0x02, sid << 3]) + _leb128(
        len(payload)) + payload


def sequence_header(s: A.SequenceHeader) -> bytes:
    """A full sequence header of ``s``'s operating points, size, frame id
    lengths, tools (inter-intra, masked compound, warped motion, dual
    filter, distance weights, reference MVs) and colour."""
    w = BitWriter()
    w.f(s.profile, 3)
    w.f(0, 1)  # still_picture
    w.f(0, 1)  # reduced_still_picture_header
    w.f(0, 1)  # timing_info_present_flag
    w.f(0, 1)  # initial_display_delay_present_flag
    w.f(len(s.op_idcs) - 1, 5)
    for idc in s.op_idcs:
        w.f(idc, 12)
        w.f(31, 5)  # seq_level_idx: no level's limits
        w.f(0, 1)  # seq_tier
    w.f(s.width_bits - 1, 4)
    w.f(s.height_bits - 1, 4)
    w.f(s.width - 1, s.width_bits)
    w.f(s.height - 1, s.height_bits)
    w.f(int(s.frame_ids), 1)  # frame_id_numbers_present_flag
    if s.frame_ids:
        w.f(s.delta_id_len - 2, 4)
        w.f(s.id_len - s.delta_id_len - 1, 3)
    w.f(int(s.sb128), 1)
    w.f(int(s.filter_intra), 1)
    w.f(int(s.intra_edge), 1)
    w.f(int(s.interintra), 1)  # enable_interintra_compound
    w.f(int(s.masked_compound), 1)
    w.f(int(s.warped_motion), 1)
    w.f(int(s.dual_filter), 1)
    w.f(1, 1)  # enable_order_hint
    w.f(int(s.jnt_comp), 1)
    w.f(int(s.ref_frame_mvs), 1)
    if s.screen_tools == 2:
        w.f(1, 1)  # seq_choose_screen_content_tools
    else:
        w.f(0, 1)
        w.f(s.screen_tools, 1)
    if s.screen_tools:
        w.f(int(s.integer_mv == 2), 1)  # seq_choose_integer_mv
        if s.integer_mv != 2:
            w.f(s.integer_mv, 1)
    w.f(s.order_hint_bits - 1, 3)
    w.f(int(s.superres), 1)
    w.f(int(s.cdef), 1)
    w.f(int(s.restoration), 1)
    # color_config
    w.f(int(s.bit_depth > 8), 1)
    if s.profile == 2 and s.bit_depth > 8:
        w.f(int(s.bit_depth == 12), 1)
    if s.profile != 1:
        w.f(int(s.mono), 1)
    w.f(1, 1)  # color_description_present_flag
    for v in s.cicp:
        w.f(v, 8)
    w.f(int(s.full_range), 1)
    if not s.mono:
        if s.profile == 2 and s.bit_depth == 12:
            w.f(s.ss[0], 1)
            if s.ss[0]:
                w.f(s.ss[1], 1)
        if s.ss == (1, 1):
            w.f(0, 2)  # chroma_sample_position
        w.f(int(s.separate_uv_delta_q), 1)
    w.f(0, 1)  # film_grain_params_present
    w.trailing_bits()
    return w.data()


def _su(w: BitWriter, v: int, n: int) -> None:
    w.f(v & ((1 << n) - 1), n)


def _ns(w: BitWriter, n: int, v: int) -> None:
    """ns(n) of v (spec 4.10.7)."""
    if n <= 1:
        return
    bits = n.bit_length()
    m = (1 << bits) - n
    if v < m:
        w.f(v, bits - 1)
    else:
        w.f((v + m) >> 1, bits - 1)
        w.f((v + m) & 1, 1)


def _subexp(w: BitWriter, n: int, v: int, k: int = 3) -> None:
    """decode_subexp's code of v < n (libaom's
    wb_write_primitive_subexpfin)."""
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if n <= mk + 3 * a:
            _ns(w, n - mk, v - mk)
            return
        more = v >= mk + a
        w.f(int(more), 1)
        if not more:
            w.f(v - mk, b2)
            return
        i += 1
        mk += a


def _recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return (v - r) << 1 if v >= r else ((r - v) << 1) - 1


def global_param(w: BitWriter, typ: int, idx: int, value: int, prev: int,
                 hp: bool) -> None:
    """read_global_param's code of gm_params[idx] ``value`` against
    PrevGmParams' ``prev`` (decode_signed_subexp_with_ref)."""
    abs_bits, prec_bits = 12, 15
    if idx < 2:
        abs_bits, prec_bits = (9 - (not hp), 3 - (not hp)) \
            if typ == TRANSLATION else (12, 6)
    diff = 16 - prec_bits
    rnd = (1 << 16) if idx % 3 == 2 else 0
    sub = (1 << prec_bits) if idx % 3 == 2 else 0
    mx = 1 << abs_bits
    v = (value - rnd) >> diff
    assert (v << diff) + rnd == value and -mx <= v <= mx, (idx, value)
    n = 2 * mx + 1
    r, v = (prev >> diff) - sub + mx, v + mx
    _subexp(w, n, _recenter(r, v) if 2 * r <= n
            else _recenter(n - 1 - r, n - 1 - v))


def global_motion(w: BitWriter, gm, prev, hp: bool) -> None:
    """global_motion_params of LAST..ALTREF: (GmType, gm_params) each,
    coded against PrevGmParams ``prev``."""
    for (typ, p), q in zip(gm, prev):
        w.f(int(typ != IDENTITY), 1)  # is_global
        if typ != IDENTITY:
            w.f(int(typ == ROTZOOM), 1)
            if typ != ROTZOOM:
                w.f(int(typ == TRANSLATION), 1)
        if typ == ROTZOOM:
            assert p[4] == -p[3] and p[5] == p[2]
        idxs = ((2, 3, 4, 5) if typ == AFFINE else (2, 3)) \
            if typ >= ROTZOOM else ()
        for i in idxs + ((0, 1) if typ >= TRANSLATION else ()):
            global_param(w, typ, i, p[i], q[i], hp)


def frame_header(s: A.SequenceHeader, base_q: int, filt: int, hp: bool,
                 lf: Tuple[int, int, int, int], ref_deltas, mode_deltas,
                 size: Optional[Tuple[int, int]] = None, primary: int = 7,
                 compound: bool = False, seg: Optional[dict] = None,
                 motion: bool = False, order_hint: int = 1,
                 ref_slots: Tuple[int, ...] = (0,) * 7,
                 slot_hints: Tuple[int, ...] = (0,) * 8, gm=None,
                 prev_gm=None, skip_mode: bool = False, refresh: int = 0,
                 delta_q: bool = False, end_cdf: bool = False,
                 tile_rows_log2: int = 0,
                 short: Optional[Tuple[int, int]] = None,
                 frame_ids: Optional[Tuple[int, Tuple[int, ...]]] = None
                 ) -> BitWriter:
    """uncompressed_header of a shown inter frame of ``order_hint`` on
    the slots ``ref_slots`` (of order hints ``slot_hints``) for LAST ..
    ALTREF, refreshing no slot, with the CDFs of ``primary`` (the
    defaults where it is 7), of another ``size``
    than the sequence's where given, ``reference_select`` for
    ``compound`` (and skip_mode_present 0 where skip mode is allowed),
    segmentation ``seg`` (``segmentation_params``); ``motion`` sets
    ``is_motion_mode_switchable`` and ``allow_warped_motion``, which is
    written where the sequence enables warped motion. ``gm`` gives each
    reference's global motion (GmType, gm_params; identity where None),
    coded against ``prev_gm`` (PrevGmParams, identity where None);
    ``skip_mode`` writes skip_mode_present 1 where it is allowed,
    ``refresh`` is refresh_frame_flags, ``delta_q`` sets
    delta_q_present (delta_q_res 0, no delta LF), ``end_cdf`` saves the
    first tile's CDFs at the frame's end (disable_frame_end_update_cdf 0)
    and ``tile_rows_log2`` cuts the frame into that many (log2) uniform
    rows of tiles. ``short`` codes the slots of LAST and GOLDEN alone
    (frame_refs_short_signaling; ``ref_slots`` must then be what
    set_frame_refs makes of them), and ``frame_ids``, under a sequence
    with frame ids, is (current_frame_id, each reference's
    delta_frame_id_minus_1)."""
    w = BitWriter()
    w.f(0, 1)  # show_existing_frame
    w.f(1, 2)  # INTER_FRAME
    w.f(1, 1)  # show_frame
    w.f(0, 1)  # error_resilient_mode
    w.f(0, 1)  # disable_cdf_update
    if s.screen_tools == 2:
        w.f(0, 1)  # allow_screen_content_tools
    assert s.frame_ids == (frame_ids is not None)
    if frame_ids is not None:
        w.f(frame_ids[0], s.id_len)  # current_frame_id
    w.f(int(size is not None), 1)  # frame_size_override_flag
    w.f(order_hint, s.order_hint_bits)
    w.f(primary, 3)  # primary_ref_frame
    w.f(refresh, 8)  # refresh_frame_flags
    w.f(int(short is not None), 1)  # frame_refs_short_signaling
    if short is not None:
        w.f(short[0], 3)  # last_frame_idx
        w.f(short[1], 3)  # gold_frame_idx
    for i, slot in enumerate(ref_slots):
        if short is None:
            w.f(slot, 3)  # ref_frame_idx
        if frame_ids is not None:
            w.f(frame_ids[1][i], s.delta_id_len)  # delta_frame_id_minus_1
    width, height = size or (s.width, s.height)
    if size is not None:
        for _ in range(7):
            w.f(0, 1)  # found_ref
        w.f(width - 1, s.width_bits)
        w.f(height - 1, s.height_bits)
    if s.superres:
        w.f(0, 1)  # use_superres
    w.f(0, 1)  # render_and_frame_size_different
    w.f(int(hp), 1)  # allow_high_precision_mv
    w.f(int(filt == 4), 1)  # is_filter_switchable
    if filt != 4:
        w.f(filt, 2)
    w.f(int(motion), 1)  # is_motion_mode_switchable
    if s.ref_frame_mvs:
        w.f(0, 1)  # use_ref_frame_mvs
    w.f(int(not end_cdf), 1)  # disable_frame_end_update_cdf
    sb = 128 if s.sb128 else 64
    sb_cols, sb_rows = -(-width // sb), -(-height // sb)
    w.f(1, 1)  # uniform_tile_spacing_flag
    k = 0
    while (1 << k) < min(sb_cols, 64):
        k += 1
    if k:
        w.f(0, 1)
    k = 0
    while (1 << k) < min(sb_rows, 64):
        k += 1
    assert tile_rows_log2 <= k
    for _ in range(tile_rows_log2):
        w.f(1, 1)  # increment_tile_rows_log2
    if tile_rows_log2 < k:
        w.f(0, 1)
    if tile_rows_log2:
        w.f(0, tile_rows_log2)  # context_update_tile_id
        w.f(3, 2)  # tile_size_bytes_minus_1
    w.f(base_q, 8)
    w.f(0, 1)  # DeltaQYDc
    if not s.mono:
        if s.separate_uv_delta_q:
            w.f(0, 1)
        w.f(0, 1)
        w.f(0, 1)
    w.f(0, 1)  # using_qmatrix
    segmentation_params(w, seg, primary)
    w.f(int(delta_q), 1)  # delta_q_present
    if delta_q:
        w.f(0, 2)  # delta_q_res
        w.f(0, 1)  # delta_lf_present
    l0, l1, l2, l3 = lf
    w.f(l0, 6)
    w.f(l1, 6)
    if not s.mono and (l0 or l1):
        w.f(l2, 6)
        w.f(l3, 6)
    w.f(0, 3)  # sharpness
    w.f(1, 1)  # loop_filter_delta_enabled
    w.f(1, 1)  # loop_filter_delta_update
    for v in ref_deltas:
        w.f(1, 1)
        _su(w, v, 7)
    for v in mode_deltas:
        w.f(1, 1)
        _su(w, v, 7)
    if s.cdef:
        w.f(0, 2)  # cdef_damping_minus_3
        w.f(0, 2)  # cdef_bits
        w.f(0, 4)
        w.f(0, 2)
        if not s.mono:
            w.f(0, 4)
            w.f(0, 2)
    if s.restoration:
        for _ in range(1 if s.mono else 3):
            w.f(0, 2)
    w.f(0, 1)  # tx_mode_select: TX_MODE_LARGEST
    w.f(int(compound), 1)  # reference_select
    hints = [slot_hints[i] for i in ref_slots]
    rel = [A._relative_dist(s, h, order_hint) for h in hints]
    fwd = [h for h, d in zip(hints, rel) if d < 0]
    if compound and fwd and (any(d > 0 for d in rel) or any(
            A._relative_dist(s, h, max(fwd)) < 0 for h in fwd)):
        w.f(int(skip_mode), 1)  # skip_mode_present
    else:
        assert not skip_mode, "skip mode is not allowed"
    if s.warped_motion:
        w.f(int(motion), 1)  # allow_warped_motion
    w.f(0, 1)  # reduced_tx_set
    global_motion(w, gm or ((IDENTITY, GM_IDENTITY),) * 7,
                  prev_gm or (GM_IDENTITY,) * 7, hp)
    w.byte_align()
    return w


class _Tile:
    """The inter frame's one tile and the state its contexts read."""

    def __init__(self, s: A.SequenceHeader, base_q: int, filt: int,
                 dual: bool, hp: bool, size: Tuple[int, int],
                 motion: bool = False, pair: Optional[Tuple[int, int]] = None,
                 bias: Tuple[int, ...] = (0,) * 8,
                 same_dist: bool = True, gm=None,
                 skip_frames: Optional[Tuple[int, int]] = None,
                 delta_q: bool = False, interintra: bool = False,
                 seg: Optional[dict] = None,
                 cdfs: Optional[dict] = None) -> None:
        self.s, self.filt, self.dual, self.hp = s, filt, dual, hp
        self.motion = motion
        # inter-intra (enable_interintra_compound) and each mi's block's;
        # segmentation (``seg``: the frame's ``map`` mode, each segment's
        # ``features``, ``prev`` the PrevSegmentIds it predicts from, None
        # for zeros), each mi's segment id and the seg_id_predicted
        # contexts by row and column
        self.interintra = interintra
        self.ii: Dict[Tuple[int, int], bool] = {}
        self.seg = seg
        self.segids: Dict[Tuple[int, int], int] = {}
        # global motion of LAST..ALTREF, the block whose stack is being
        # built's GlobalMvs, and per mi whether its block is a GLOBALMV or
        # GLOBAL_GLOBALMV block of 8x8 or more; SkipModeFrame (None where
        # the frame has no skip_mode) and each mi's skip_mode; delta q
        # (one delta_q_abs at the first block of a superblock, unless it
        # is the whole superblock)
        self.gm = gm or ((IDENTITY, GM_IDENTITY),) * 7
        self.cur_gmv = ((0, 0), (0, 0))
        self.gmv_blk: Dict[Tuple[int, int], bool] = {}
        self.skip_frames = skip_frames
        self.skipm: Dict[Tuple[int, int], int] = {}
        self.delta_q, self.read_deltas, self.n_deltas = delta_q, False, 0
        # compound frames: the pair, the sign bias of each reference frame
        # and whether the pair lies at one distance (compound_idx's
        # context); each block's comp_group_idx, compound_idx and compound
        # mode, and the count of each mode, type and kind of side
        self.pair, self.bias, self.same_dist = pair, bias, same_dist
        # each block's RefFrame[0] and [1] (-1: a single reference; LAST
        # where not set), and the block whose stack is being built's
        self.refs: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.target = (LAST, -1)
        self.cgi: Dict[Tuple[int, int], int] = {}
        self.cidx: Dict[Tuple[int, int], int] = {}
        self.counts: Dict[str, int] = {}
        # LOCALWARP blocks by kind of warp ("valid", "singular", "shear")
        self.warps: Dict[str, int] = {}
        arrs = A._cdf_pack(coeff_q_ctx(base_q))[0]
        self.cdf = {k: a.copy() for k, a in zip(A._CDF_ORDER, arrs)} \
            if cdfs is None else {k: a.copy() for k, a in cdfs.items()}
        self.start_cdf = {k: a.copy() for k, a in self.cdf.items()}
        self.first_cdf: Optional[dict] = None  # the first tile's, at its end
        self.base_q = base_q
        self.enc = RangeEncoder()
        self.mi_rows = 2 * ((size[1] + 7) >> 3)
        self.mi_cols = 2 * ((size[0] + 7) >> 3)
        self.above_sp = [0] * (self.mi_cols + 32)
        self.left_sp = [0] * (self.mi_rows + 32)
        # the current tile's first and end mi rows (tiles are rows of
        # superblocks across the frame)
        self.r0, self.r1 = 0, self.mi_rows
        self.size: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.mv: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.newmv: Dict[Tuple[int, int], int] = {}
        self.fil: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.written = set()

    def put(self, name: str, row: int, s: int, nsym: int, width: int
            ) -> None:
        cdf = self.cdf[name][row * width:(row + 1) * width]
        self.enc.encode_symbol(s, cdf, nsym)
        update_cdf(cdf, s, nsym)

    def literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.enc.encode_bool_q15((v >> i) & 1, 16384)

    # -- the MV stack (spec 7.10.2 as dav1d scans it) --------------------

    def _refs_of(self, p) -> Tuple[int, int]:
        return self.refs.get(p, (LAST, -1))

    def gm_type(self, ref: int) -> int:
        return self.gm[ref - 1][0] if ref > 0 else IDENTITY

    def _lower(self, mv):
        """lower_mv_precision (no force_integer_mv here)."""
        if self.hp:
            return tuple(mv)
        return tuple(v - (1 if v > 0 else -1) if v & 1 else v for v in mv)

    def global_mv(self, ref: int, r: int, c: int, wl: int, hl: int):
        """setup_global_mv: the GlobalMv of ``ref`` for the block at (r,
        c); TRANSLATION's row from gm_params[0], as the spec reads it."""
        typ, p = self.gm[ref - 1] if ref > 0 else (IDENTITY, GM_IDENTITY)
        if typ == IDENTITY:
            return (0, 0)
        if typ == TRANSLATION:
            return self._lower((p[0] >> 13, p[1] >> 13))
        x, y = c * 4 + (2 << wl) - 1, r * 4 + (2 << hl) - 1
        xc = (p[2] - (1 << 16)) * x + p[3] * y + p[0]
        yc = p[4] * x + (p[5] - (1 << 16)) * y + p[1]
        n = 13 + (not self.hp)
        return self._lower(tuple(self._round2s(v, n) * (1 + (not self.hp))
                                 for v in (yc, xc)))

    def _cand(self, r, c):
        """The MV (a pair's MVs) the block at (r, c) offers the target's
        stack: a single reference matches either of its references, a
        pair both; None where it matches not. A GLOBALMV or
        GLOBAL_GLOBALMV block of 8x8 or more offers, for a reference whose
        GmType is past TRANSLATION, the target's GlobalMv."""
        (ra, rb), mv = self._refs_of((r, c)), self.mv[r, c]
        t0, t1 = self.target
        glob = self.gmv_blk.get((r, c), False)

        def sub(ref, m, lst):
            if glob and self.gm_type(ref) > TRANSLATION:
                return self.cur_gmv[lst]
            return m

        if t1 >= 0:
            if (ra, rb) != (t0, t1):
                return None
            return (sub(t0, mv[0], 0), sub(t1, mv[1], 1))
        if ra == t0:
            return sub(t0, mv if rb < 0 else mv[0], 0)
        return sub(t0, mv[1], 0) if rb == t0 else None

    def _add(self, st, r, c, weight, flags, row):
        if (r, c) not in self.mv:
            return
        mv = self._cand(r, c)
        if mv is None:
            return
        flags[row] = 1
        flags[2] |= self.newmv[r, c]
        for e in st:
            if e[0] == mv:
                e[1] += weight
                return
        if len(st) < 8:
            st.append([mv, weight])

    def _scan(self, st, row, col, b4, n4, mx, step, flags, horiz):
        """dav1d's scan_row (horiz) or scan_col from the mi (row, col)."""
        idx = 0 if horiz else 1
        cw = 1 << self.size[row, col][idx]
        length = max(step, min(b4, cw))
        if b4 <= cw:
            other = 1 << self.size[row, col][1 - idx]
            weight = 2 if b4 == 1 else max(2, min(2 * mx, other))
            self._add(st, row, col, length * weight, flags, idx)
            return weight >> 1
        x = 0
        while True:
            r, c = (row, col + x) if horiz else (row + x, col)
            self._add(st, r, c, length * 2, flags, idx)
            x += length
            end = self.mi_cols if horiz else self.r1
            if x >= n4 or (col if horiz else row) + x >= end:
                return 1
            r, c = (row, col + x) if horiz else (row + x, col)
            length = max(step, 1 << self.size[r, c][idx])

    def stack(self, r: int, c: int, wl: int, hl: int):
        bw4, bh4 = 1 << wl, 1 << hl
        self.cur_gmv = tuple(self.global_mv(t, r, c, wl, hl)
                             for t in self.target)
        w4, h4 = min(bw4, 16, self.mi_cols - c), min(bh4, 16, self.r1 - r)
        st: List[list] = []
        flags = [0, 0, 0]  # row match, column match, NEWMV match
        none = 1 << 20
        max_rows = max_cols = 0
        n_rows = n_cols = none
        if r > self.r0:
            max_rows = min((r - self.r0 + 1) >> 1, 2 + (bh4 > 1))
            n_rows = self._scan(st, r - 1, c, bw4, w4, max_rows,
                                4 if bw4 >= 16 else 1, flags, True)
        if c > 0:
            max_cols = min((c + 1) >> 1, 2 + (bw4 > 1))
            n_cols = self._scan(st, r, c - 1, bh4, h4, max_cols,
                                4 if bh4 >= 16 else 1, flags, False)
        if n_rows != none and max(bw4, bh4) <= 16 and \
                (r - 1, c + bw4) in self.written:
            self._add(st, r - 1, c + bw4, 4, flags, 0)
        nearest_match = flags[0] + flags[1]
        nearest = len(st)
        for e in st:
            e[1] += REF_CAT
        dummy = [0, 0, 0]
        if n_rows != none and n_cols != none:
            self._add(st, r - 1, c - 1, 4, dummy, 0)
            flags[0] |= dummy[0]
        for k in (2, 3):
            if n_rows < k <= max_rows:
                d = [0, 0, 0]
                n_rows += self._scan(st, (r - 2 * k + 1) | 1, c | 1, bw4, w4,
                                     1 + max_rows - k,
                                     4 if bw4 >= 16 else 2, d, True)
                flags[0] |= d[0]
            if n_cols < k <= max_cols:
                d = [0, 0, 0]
                n_cols += self._scan(st, r | 1, (c - 2 * k + 1) | 1, bh4, h4,
                                     1 + max_cols - k,
                                     4 if bh4 >= 16 else 2, d, False)
                flags[1] |= d[1]
        ref_match = flags[0] + flags[1]
        if nearest_match == 0:
            refmv_ctx, newmv_ctx = min(2, ref_match), int(ref_match > 0)
        elif nearest_match == 1:
            refmv_ctx, newmv_ctx = min(ref_match * 3, 4), 3 - flags[2]
        else:
            refmv_ctx, newmv_ctx = 5, 5 - flags[2]
        st[:nearest] = sorted(st[:nearest], key=lambda e: -e[1])
        st[nearest:] = sorted(st[nearest:], key=lambda e: -e[1])
        # the extra search: the pair's fills the stack to two
        if len(st) < 2:
            extra = self._extra_pair if self.target[1] >= 0 else \
                self._extra_single
            st = extra(st, r, c, min(w4, h4), n_rows != none,
                       n_cols != none)
        top = -(r * 32) - (128 + bh4 * 32)
        bottom = (self.mi_rows - r) * 32 + 128
        left = -(c * 32) - (128 + bw4 * 32)
        right = (self.mi_cols - c) * 32 + 128

        def clamp(mv):
            return (min(max(mv[0], top), bottom),
                    min(max(mv[1], left), right))

        for e in st:
            e[0] = tuple(clamp(m) for m in e[0]) if self.target[1] >= 0 \
                else clamp(e[0])
        return st, newmv_ctx, refmv_ctx

    def _lists(self, p):
        """The (reference, MV) of each list of the block at mi p."""
        ra, rb = self._refs_of(p)
        mv = self.mv[p]
        return [(ra, mv)] if rb < 0 else [(ra, mv[0]), (rb, mv[1])]

    def _neighbours(self, r, c, sz4, top, left):
        """The extra search's neighbours: the row above, then the column
        to the left, sz4 4x4s of each, a block at a time."""
        for along, ok in ((0, top), (1, left)):
            i = 0
            while ok and i < sz4:
                p = (r - 1, c + i) if along == 0 else (r + i, c - 1)
                yield p
                i += 1 << self.size[p][along]

    def _extra_single(self, st, r, c, sz4, top, left):
        """Spec 7.10.2.12 for a single reference (dav1d's
        add_single_extended_candidate): each list's MV of a neighbour,
        negated across sign biases, joins the stack unless there, while
        it holds fewer than two."""
        t0 = self.target[0]
        for p in self._neighbours(r, c, sz4, top, left):
            if len(st) >= 2:
                break
            for cref, mv in self._lists(p):
                k = -1 if self.bias[cref] != self.bias[t0] else 1
                mv = (k * mv[0], k * mv[1])
                if all(e[0] != mv for e in st):
                    st.append([mv, 2])
        return st

    def _extra_pair(self, st, r, c, sz4, top, left):
        """Spec 7.10.2.12 for the pair (dav1d's compound extended search):
        the neighbours' MVs as RefIdMvs of their own list and RefDiffMvs of
        the other (negated across sign biases), two of each, then the
        GlobalMvs; the stack filled to two."""
        ids, diffs = [[], []], [[], []]
        pair = self.target
        for p in self._neighbours(r, c, sz4, top, left):
            for cref, mv in self._lists(p):
                for lst in range(2):
                    if cref == pair[lst]:
                        if len(ids[lst]) < 2:
                            ids[lst].append(mv)
                    elif len(diffs[lst]) < 2:
                        k = -1 if self.bias[cref] != self.bias[
                            pair[lst]] else 1
                        diffs[lst].append((k * mv[0], k * mv[1]))
        comb = [[None, None], [None, None]]
        for lst in range(2):
            vals = (ids[lst] + diffs[lst])[:2]
            vals += [self.cur_gmv[lst]] * (2 - len(vals))
            comb[0][lst], comb[1][lst] = vals
        comb = [tuple(x) for x in comb]
        if len(st) == 1:
            return st + [[comb[1] if comb[0] == st[0][0] else comb[0], 2]]
        return [[comb[0], 2], [comb[1], 2]]

    # -- the local warp (spec 7.10.4, 7.11.3.6-8) ---------------------------

    def warp_samples(self, r, c, wl, hl, mv, ref: int = LAST):
        """find_warp_samples: CandList[:NumSamples] of the block at (r, c)
        with ``mv`` on ``ref``, every neighbour being an inter block; one
        on another reference, a compound or an inter-intra one
        (RefFrame[1] not NONE) is no sample, nor scanned."""
        w4, h4 = 1 << wl, 1 << hl
        thresh = min(max(4 << max(wl, hl), 16), 112)
        out, scanned = [], [0]
        first = []

        def add(dr, dc):
            rr, cc = r + dr, c + dc
            if scanned[0] >= 8 or (rr, cc) not in self.written or \
                    rr < self.r0 or \
                    self._refs_of((rr, cc)) != (ref, -1) or \
                    self.ii.get((rr, cc)):
                return
            cwl, chl = self.size[rr, cc]
            cw4, ch4 = 1 << cwl, 1 << chl
            midy = (rr & ~(ch4 - 1)) * 4 + ch4 * 2 - 1
            midx = (cc & ~(cw4 - 1)) * 4 + cw4 * 2 - 1
            nmv = self.mv[rr, cc]
            valid = abs(nmv[0] - mv[0]) + abs(nmv[1] - mv[1]) <= thresh
            scanned[0] += 1
            cand = (midy * 8, midx * 8, midy * 8 + nmv[0], midx * 8 + nmv[1])
            if scanned[0] == 1:
                first.append(cand)
            if valid:
                out.append(cand)

        top_left = top_right = True
        if r > self.r0:
            sw = 1 << self.size[r - 1, c][0]
            if w4 <= sw:
                off = -(c & (sw - 1))
                top_left &= off == 0
                top_right &= off + sw <= w4
                add(-1, 0)
            else:
                i = 0
                while i < min(w4, self.mi_cols - c):
                    step = 1 << self.size[r - 1, c + i][0]
                    add(-1, i)
                    i += step
        if c > 0:
            sh = 1 << self.size[r, c - 1][1]
            if h4 <= sh:
                top_left &= (r & (sh - 1)) == 0
                add(0, -1)
            else:
                i = 0
                while i < min(h4, self.r1 - r):
                    step = 1 << self.size[r + i, c - 1][1]
                    add(i, -1)
                    i += step
        if top_left:
            add(-1, -1)
        if top_right and max(w4, h4) <= 16:
            add(-1, w4)
        return out or first

    @staticmethod
    def _divisor(v: int):
        """resolve_divisor: (Div_Lut's multiplier signed as v, shift)."""
        a = abs(v)
        n = a.bit_length() - 1
        e = a - (1 << n)
        f = (e + (1 << (n - 9)) >> (n - 8)) if n > 8 else e << (8 - n)
        m = int(A._tool_tables()["div_lut"][f])
        return (-m if v < 0 else m), n + 14

    @staticmethod
    def _round2s(v: int, n: int) -> int:
        r = (abs(v) + (1 << n >> 1)) >> n
        return -r if v < 0 else r

    def warp_kind(self, r, c, wl, hl, mv, ref: int = LAST) -> str:
        """"valid", "singular" or "shear": warpEstimation and setupShear
        of the block at (r, c) with ``mv`` on ``ref``."""
        r2 = self._round2s
        a00 = a01 = a11 = bx0 = bx1 = by0 = by1 = 0
        midy, midx = r * 4 + (2 << hl) - 1, c * 4 + (2 << wl) - 1
        suy, sux = midy * 8, midx * 8
        duy, dux = suy + mv[0], sux + mv[1]

        def ls(a, b):
            return ((a * b) >> 2) + a + b

        for cy, cx, ey, ex in self.warp_samples(r, c, wl, hl, mv, ref):
            sy, sx, dy, dx = cy - suy, cx - sux, ey - duy, ex - dux
            if abs(sx - dx) < 256 and abs(sy - dy) < 256:
                a00 += ls(sx, sx) + 8
                a01 += ls(sx, sy) + 4
                a11 += ls(sy, sy) + 8
                bx0 += ls(sx, dx) + 8
                bx1 += ls(sy, dx) + 4
                by0 += ls(sx, dy) + 4
                by1 += ls(sy, dy) + 8
        det = a00 * a11 - a01 * a01
        if det == 0:
            return "singular"
        div, shift = self._divisor(det)
        shift -= 16
        if shift < 0:
            div, shift = div << -shift, 0
        one, nd = 1 << 16, (1 << 13) - 1
        p2 = min(max(r2((a11 * bx0 - a01 * bx1) * div, shift), one - nd),
                 one + nd)
        p3 = min(max(r2((a00 * bx1 - a01 * bx0) * div, shift), -nd), nd)
        p4 = min(max(r2((a11 * by0 - a01 * by1) * div, shift), -nd), nd)
        p5 = min(max(r2((a00 * by1 - a01 * by0) * div, shift), one - nd),
                 one + nd)
        div, shift = self._divisor(p2)

        def clip16(v):
            return min(max(v, -32768), 32767)

        alpha, beta = clip16(p2 - one), clip16(p3)
        gamma = clip16(r2((p4 << 16) * div, shift))
        delta = clip16(p5 - r2(p3 * p4 * div, shift) - one)
        alpha, beta, gamma, delta = (r2(v, 6) * 64 for v in (alpha, beta,
                                                              gamma, delta))
        ok = 4 * abs(alpha) + 7 * abs(beta) < one and \
            4 * abs(gamma) + 4 * abs(delta) < one
        return "valid" if ok else "shear"

    def _warp_mv(self, r, c, wl, hl, blk: InterBlock):
        """blk.mv, or the first MV near it (a seeded walk) whose warp is
        of the kind blk.warp asks for; blk.mv where the walk finds none."""
        rng = np.random.default_rng(r * 4096 + c)
        mv = blk.mv
        for _ in range(4000):
            if self.warp_kind(r, c, wl, hl, mv, blk.ref) == blk.warp:
                return mv
            spread = {"valid": 16, "shear": 160}.get(blk.warp, 400)
            mv = tuple(int(v + rng.integers(-spread, spread + 1))
                       for v in blk.mv)
        return blk.mv

    # -- symbols ------------------------------------------------------------

    def _mv_comp(self, comp: int, v: int) -> None:
        mag = abs(v) - 1
        self.put("mv0_sign", comp, int(v < 0), 2, 3)
        if mag < 16:
            self.put("mv0_classes", comp, 0, 11, 12)
            self.put("mv0_class0", comp, mag >> 3, 2, 3)
            self.put("mv0_class0_fr", comp * 2 + (mag >> 3), (mag >> 1) & 3,
                     4, 5)
            if self.hp:
                self.put("mv0_class0_hp", comp, mag & 1, 2, 3)
            return
        cls = (mag >> 3).bit_length() - 1
        self.put("mv0_classes", comp, cls, 11, 12)
        d = (mag - (2 << (cls + 2))) >> 3
        for i in range(cls):
            self.put("mv0_bits", comp * 10 + i, (d >> i) & 1, 2, 3)
        self.put("mv0_fr", comp, (mag >> 1) & 3, 4, 5)
        if self.hp:
            self.put("mv0_hp", comp, mag & 1, 2, 3)

    def _pred(self, st, k: int):
        """RefStackMv[k][0] of a single reference: the stack's, or past
        NumMvFound the GlobalMv."""
        return tuple(st[k][0]) if k < len(st) else self.cur_gmv[0]

    def _preamble(self, r: int, c: int, wl: int, hl: int, nbrs,
                  skip_mode: int, blk: Optional[InterBlock] = None) -> dict:
        """The segment id where it comes before skip, skip_mode where the
        frame has it (8x8 or more, in a segment without REF_FRAME, SKIP or
        GLOBALMV), skip (1) unless skip_mode or the segment's SKIP, the
        segment id where it comes after, and delta q at a superblock's
        first block; returns the block's segment's features."""
        sg = self.seg
        sid = 0
        if sg is not None:
            if sg["map"] == "keep":
                sid = self._predicted(r, c, wl, hl)
            elif sg["preskip"]:
                sid = self._code_segment(r, c, wl, hl, blk, 0)
        feats = sg["features"][sid] if sg else {}
        if self.skip_frames and min(wl, hl) >= 1 and not feats.keys() & {
                SEG_REF_FRAME, SEG_SKIP, SEG_GLOBALMV}:
            self.put("skip_mode", sum(self.skipm.get(p, 0) for p in nbrs),
                     skip_mode, 2, 3)
        if not skip_mode and SEG_SKIP not in feats:
            self.put("skip", len(nbrs), 1, 2, 3)  # every neighbour skipped
        if sg is not None and sg["map"] != "keep" and not sg["preskip"]:
            sid = self._code_segment(r, c, wl, hl, blk, 1)
            feats = sg["features"][sid]
        if sg is not None:
            for y in range(r, min(r + (1 << hl), self.mi_rows)):
                for x in range(c, min(c + (1 << wl), self.mi_cols)):
                    self.segids[y, x] = sid
        sb = 5 if self.s.sb128 else 4
        if self.delta_q and self.read_deltas and not wl == hl == sb:
            # delta_q_abs 0, 1 or 2 in turn, the sign alternating
            k = self.n_deltas % 3
            self.put("delta_q", 0, k, 4, 5)
            if k:
                self.literal((self.n_deltas // 3) & 1, 1)
            self.n_deltas += 1
        self.read_deltas = False
        return feats

    # -- segment ids (spec 5.11.9 inter_segment_id, read_segment_id) -------

    def _predicted(self, r: int, c: int, wl: int, hl: int) -> int:
        """get_segment_id: the least PrevSegmentIds over the block."""
        prev = self.seg["prev"]
        if prev is None:
            return 0
        return int(prev[r:r + (1 << hl), c:c + (1 << wl)].min())

    def _spatial(self, r: int, c: int) -> Tuple[int, int]:
        """read_segment_id's prediction from the above-left, above and
        left ids, and its context."""
        top = r > self.r0
        u = self.segids[r - 1, c] if top else None
        lf = self.segids[r, c - 1] if c else None
        ul = self.segids[r - 1, c - 1] if top and c else None
        pred = (0 if lf is None else lf) if u is None else \
            (u if lf is None else (u if ul == u else lf))
        if ul is None:
            ctx = 0
        elif ul == u == lf:
            ctx = 2
        else:
            ctx = int(ul == u or ul == lf or u == lf)
        return pred, ctx

    def _code_segment(self, r: int, c: int, wl: int, hl: int,
                      blk: InterBlock, skip: int) -> int:
        """The segment id of ``blk`` where the map is coded: under
        temporal update seg_id_predicted (a skipped block after skip takes
        the spatial prediction and 0 for the contexts), then where it is 0
        segment_id against the spatial prediction (none for a skipped
        block after skip)."""
        sg = self.seg
        post = not sg["preskip"]
        if sg["map"] == "temporal" and not (post and skip):
            ctx = self.left_sp[r] + self.above_sp[c]
            pred = int(blk.seg_pred)
            self.put("segment_id_predicted", ctx, pred, 2, 3)
            self.above_sp[c:c + (1 << wl)] = [pred] * (1 << wl)
            self.left_sp[r:r + (1 << hl)] = [pred] * (1 << hl)
            if pred:
                self.counts["seg_id_predicted"] = \
                    self.counts.get("seg_id_predicted", 0) + 1
                return self._predicted(r, c, wl, hl)
        elif sg["map"] == "temporal":
            self.above_sp[c:c + (1 << wl)] = [0] * (1 << wl)
            self.left_sp[r:r + (1 << hl)] = [0] * (1 << hl)
        pred, ctx = self._spatial(r, c)
        if post and skip:
            return pred
        assert 0 <= blk.seg <= sg["last"]
        self.put("segment_id", ctx, neg_interleave(blk.seg, pred,
                                                  sg["last"] + 1), 8, 9)
        return blk.seg

    def _store(self, r: int, c: int, wl: int, hl: int, mv, refs, newmv,
               filt, glob: bool = False, skip_mode: int = 0,
               cgi: int = 0, cidx: int = 1, ii: bool = False) -> None:
        for y in range(r, min(r + (1 << hl), self.mi_rows)):
            for x in range(c, min(c + (1 << wl), self.mi_cols)):
                self.size[y, x] = (wl, hl)
                self.mv[y, x] = mv
                self.refs[y, x] = refs
                self.newmv[y, x] = newmv
                self.fil[y, x] = filt
                self.gmv_blk[y, x] = glob
                self.skipm[y, x] = skip_mode
                self.cgi[y, x], self.cidx[y, x] = cgi, cidx
                self.ii[y, x] = ii
                self.written.add((y, x))

    def block(self, r: int, c: int, wl: int, hl: int, blk: InterBlock
              ) -> None:
        above = (r - 1, c) if r > self.r0 else None
        left = (r, c - 1) if c else None
        nbrs = [p for p in (above, left) if p]
        feats = self._preamble(r, c, wl, hl, nbrs, 0, blk)
        # a segment's REF_FRAME sets the reference, its SKIP or GLOBALMV
        # LAST and GLOBALMV, none of them with a symbol
        seg_ref = feats.get(SEG_REF_FRAME)
        forced = SEG_SKIP in feats or SEG_GLOBALMV in feats
        if seg_ref is not None or forced:
            blk = replace(blk, ref=LAST if seg_ref is None else seg_ref,
                          mode=GLOBAL if forced else blk.mode)
        glob = blk.mode == GLOBAL
        # read_motion_mode: a block of 8x8 at least with a neighbour (every
        # neighbour is inter), unless it is a GLOBALMV block on a GmType
        # past TRANSLATION or an inter-intra block
        switchable = self.motion and min(wl, hl) >= 1 and bool(
            above or left) and not (glob and self.gm_type(blk.ref)
                                    > TRANSLATION) and blk.ii is None
        motion = blk.motion if switchable else SIMPLE
        assert motion != LOCALWARP or blk.mode == NEW
        if motion == LOCALWARP and blk.warp:
            blk = replace(blk, mv=self._warp_mv(r, c, wl, hl, blk),
                          motion=motion)
        if seg_ref is None and SEG_GLOBALMV not in feats:
            self.put("is_inter", 0, 1, 2, 3)  # every neighbour inter
        if self.pair and min(wl, hl) >= 1 and seg_ref is None \
                and not forced:
            self.put("comp_mode", self._comp_mode_ctx(above, left), 0, 2, 3)
        if seg_ref is None and not forced:
            self._single_ref(nbrs, blk.ref)
        if self.pair:
            self.counts["single"] = self.counts.get("single", 0) + 1
        self.target = (blk.ref, -1)
        st, newmv_ctx, refmv_ctx = self.stack(r, c, wl, hl)
        if not forced:
            self.put("new_mv", newmv_ctx, int(blk.mode != NEW), 2, 3)
        if blk.mode != NEW and not forced:
            # zero_mv in ZeroMvContext 0 (no reference MVs), then ref_mv
            self.put("zero_mv", 0, int(not glob), 2, 3)
            if not glob:
                self.put("ref_mv", refmv_ctx, int(blk.mode == NEAR), 2, 3)
        if blk.mode == NEW:
            self._drl(st, 0)
            pred = self._pred(st, 0)
            self._mv((blk.mv[0] - pred[0], blk.mv[1] - pred[1]))
            mv = blk.mv
        elif blk.mode == NEAR:
            self._drl(st, 1)
            mv = self._pred(st, 1)
        else:
            mv = self.cur_gmv[0] if glob else self._pred(st, 0)
        if blk.mode != NEW:
            self.counts[blk.mode] = self.counts.get(blk.mode, 0) + 1
        bsize = WEDGE_SQUARES.get(wl) if wl == hl else None
        if self.interintra and bsize is not None:
            # interintra by size group (wl of a square 8x8 .. 32x32),
            # interintra_mode, wedge_interintra and wedge_index
            self.put("interintra", wl, int(blk.ii is not None), 2, 3)
            if blk.ii is not None:
                mode, wedge = blk.ii
                self.put("interintra_mode", wl, mode, 4, 5)
                self.put("wedge_interintra", bsize, int(wedge is not None),
                         2, 3)
                if wedge is not None:
                    self.put("wedge_index", bsize, wedge, 16, 17)
                key = "ii_wedge" if wedge is not None else f"ii{mode}"
                self.counts[key] = self.counts.get(key, 0) + 1
        else:
            assert blk.ii is None, "inter-intra outside 8x8 .. 32x32"
        if switchable:
            msize = {(1, 1): 3, (2, 2): 6, (3, 3): 9, (4, 4): 12}[wl, hl]
            # NumSamples 0 (every neighbour compound, inter-intra or on
            # another reference): use_obmc in place of motion_mode
            if self.warp_samples(r, c, wl, hl, mv, blk.ref):
                self.put("motion_mode", msize, motion, 3, 4)
            else:
                assert motion != LOCALWARP
                self.put("obmc", msize, motion, 2, 3)
            if motion == LOCALWARP:
                kind = self.warp_kind(r, c, wl, hl, blk.mv, blk.ref)
                self.warps[kind] = self.warps.get(kind, 0) + 1
        filt = blk.filt if self.filt == 4 else (self.filt, self.filt)
        # needs_interp_filter: none for a local warp, nor for a GLOBALMV
        # block of 8x8 or more unless its GmType is TRANSLATION (EIGHTTAP)
        if motion == LOCALWARP or (glob and min(wl, hl) >= 1 and self.gm_type(
                blk.ref) != TRANSLATION):
            filt = (0, 0) if self.filt == 4 else filt
        elif self.filt == 4:
            for d in range(2 if self.dual else 1):
                self.put("interp_filter", self._interp_ctx(
                    d, above, left, blk.ref, 0), filt[d], 3, 4)
            if not self.dual:
                filt = (filt[0], filt[0])
        self._store(r, c, wl, hl, tuple(mv), (blk.ref, -1),
                    int(blk.mode == NEW), filt, glob and min(wl, hl) >= 1,
                    ii=blk.ii is not None)

    # -- the contexts of spec 8.3.2 (libaom's forms), every block inter ----

    def _count(self, nbrs) -> List[int]:
        """How often the neighbours use each reference frame, both of a
        compound neighbour's counted."""
        cnt = [0] * 8
        for p in nbrs:
            for rf in self._refs_of(p):
                if rf > 0:
                    cnt[rf] += 1
        return cnt

    def _single_ref(self, nbrs, ref: int) -> None:
        """single_ref_p1 .. p6 for ``ref``."""
        cnt, ctx = self._count(nbrs), _ref_count_ctx

        def put(p, c, bit):
            self.put("single_ref", c * 6 + p - 1, int(bit), 2, 3)

        back = ref >= BWDREF
        put(1, ctx(sum(cnt[1:5]), sum(cnt[5:])), back)
        if back:
            put(2, ctx(cnt[5] + cnt[6], cnt[7]), ref == ALTREF)
            if ref != ALTREF:
                put(6, ctx(cnt[5], cnt[6]), ref == ALTREF2)
        else:
            far = ref in (LAST3, GOLDEN)
            put(3, ctx(cnt[1] + cnt[2], cnt[3] + cnt[4]), far)
            if far:
                put(5, ctx(cnt[3], cnt[4]), ref == GOLDEN)
            else:
                put(4, ctx(cnt[1], cnt[2]), ref == LAST2)

    def _comp_mode_ctx(self, above, left) -> int:
        a = self._refs_of(above) if above else None
        lf = self._refs_of(left) if left else None

        def back(e):
            return int(e[0] >= BWDREF)

        if a and lf:
            if a[1] < 0 and lf[1] < 0:
                return back(a) ^ back(lf)
            if a[1] < 0 or lf[1] < 0:
                return 2 + back(a if a[1] < 0 else lf)
            return 4
        if a or lf:
            e = a or lf
            return back(e) if e[1] < 0 else 3
        return 1

    def _comp_ref_type_ctx(self, above, left) -> int:
        a = self._refs_of(above) if above else None
        lf = self._refs_of(left) if left else None

        def uni(e):
            return e[1] > 0 and (e[0] >= BWDREF) == (e[1] >= BWDREF)

        if a and lf:
            same = (a[0] >= BWDREF) == (lf[0] >= BWDREF)
            if a[1] < 0 and lf[1] < 0:
                return 1 + 2 * same
            if a[1] < 0 or lf[1] < 0:
                return 3 + same if uni(lf if a[1] < 0 else a) else 1
            if not uni(a) and not uni(lf):
                return 0
            if not uni(a) or not uni(lf):
                return 2
            return 3 + ((a[0] == BWDREF) == (lf[0] == BWDREF))
        if a or lf:
            e = a or lf
            return 2 if e[1] < 0 else 4 * uni(e)
        return 2

    def _idx_ctx(self, nbrs, table, altref: int) -> int:
        """comp_group_idx's or compound_idx's neighbour part: a compound
        neighbour's own index, a single one on ALTREF ``altref``."""
        out = 0
        for p in nbrs:
            ra, rb = self._refs_of(p)
            out += table[p] if rb > 0 else (altref if ra == ALTREF else 0)
        return out

    def _interp_ctx(self, d, above, left, ref: int, comp: int) -> int:
        """interp_filter's context: a neighbour's filter where either of
        its references is the block's RefFrame[0]."""
        def kind(p):
            return self.fil[p][d] if p and ref in self._refs_of(p) else 3

        lt, at = kind(left), kind(above)
        return (d * 2 + comp) * 4 + (lt if lt == at else (
            at if lt == 3 else (lt if at == 3 else 3)))

    def _drl(self, st, first: int) -> None:
        """drl_mode 0 at the first index the stack offers one."""
        for i in range(first, first + 2):
            if len(st) > i + 1:
                w0, w1 = st[i][1], st[i + 1][1]
                dctx = (1 if w1 < REF_CAT else 0) if w0 >= REF_CAT else \
                    (2 if w1 < REF_CAT else 0)
                self.put("drl", dctx, 0, 2, 3)
                return

    def _mv(self, diff) -> None:
        joint = (2 if diff[0] else 0) | (1 if diff[1] else 0)
        self.put("mv0_joints", 0, joint, 4, 5)
        if diff[0]:
            self._mv_comp(0, diff[0])
        if diff[1]:
            self._mv_comp(1, diff[1])

    def _refs(self, above, left) -> None:
        """comp_mode 1, comp_ref_type and the pair's reference symbols."""
        r0, r1 = self.pair
        self.put("comp_mode", self._comp_mode_ctx(above, left), 1, 2, 3)
        uni = (r0 >= BWDREF) == (r1 >= BWDREF)
        self.put("comp_ref_type", self._comp_ref_type_ctx(above, left),
                 0 if uni else 1, 2, 3)
        cnt = self._count([p for p in (above, left) if p])
        ctx = _ref_count_ctx
        if uni:
            self.put("uni_comp_ref", ctx(sum(cnt[1:5]), sum(cnt[5:])) * 3,
                     int(r0 == BWDREF), 2, 3)
            if r0 == LAST:
                self.put("uni_comp_ref", ctx(cnt[2], cnt[3] + cnt[4]) * 3 + 1,
                         int(r1 != LAST2), 2, 3)
                if r1 != LAST2:
                    self.put("uni_comp_ref", ctx(cnt[3], cnt[4]) * 3 + 2,
                             int(r1 == GOLDEN), 2, 3)
            self.counts["unidir"] = self.counts.get("unidir", 0) + 1
            return
        far = r0 in (LAST3, GOLDEN)
        self.put("comp_ref", ctx(cnt[1] + cnt[2], cnt[3] + cnt[4]) * 3,
                 int(far), 2, 3)
        if far:
            self.put("comp_ref", ctx(cnt[3], cnt[4]) * 3 + 2,
                     int(r0 == GOLDEN), 2, 3)
        else:
            self.put("comp_ref", ctx(cnt[1], cnt[2]) * 3 + 1,
                     int(r0 == LAST2), 2, 3)
        self.put("comp_bwdref", ctx(cnt[5] + cnt[6], cnt[7]) * 2,
                 int(r1 == ALTREF), 2, 3)
        if r1 != ALTREF:
            self.put("comp_bwdref", ctx(cnt[5], cnt[6]) * 2 + 1,
                     int(r1 == ALTREF2), 2, 3)
        self.counts["bidir"] = self.counts.get("bidir", 0) + 1

    def block_pair(self, r: int, c: int, wl: int, hl: int,
                   blk: CompoundBlock) -> None:
        """A skipped compound block on the pair (8x8 or more): its
        references, mode, drl, the MVs of its NEWMV sides, compound type
        and filters, with the contexts of spec 8.3.2 (every neighbour
        inter: a compound block on the pair or a single one on either of
        its references)."""
        above = (r - 1, c) if r > self.r0 else None
        left = (r, c - 1) if c else None
        nbrs = [p for p in (above, left) if p]
        self._preamble(r, c, wl, hl, nbrs, 0)
        self.put("is_inter", 0, 1, 2, 3)
        self._refs(above, left)
        self.target = self.pair
        st, newmv_ctx, refmv_ctx = self.stack(r, c, wl, hl)
        mctx = COMPOUND_MODE_CTX[refmv_ctx >> 1][min(newmv_ctx, 4)]
        self.put("compound_mode", mctx, blk.mode, 8, 9)
        sides = COMPOUND_SIDES[blk.mode]
        idx = 0
        if sides == (NEW, NEW):
            self._drl(st, 0)
        elif NEAR in sides:
            idx = 1
            self._drl(st, 1)
        mvs = []
        for i, (side, want) in enumerate(zip(sides, (blk.mv, blk.mv2))):
            pred = self.cur_gmv[i] if side == GLOBAL else \
                st[0 if side == NEAREST else idx][0][i]
            if side == NEW:
                self._mv((want[0] - pred[0], want[1] - pred[1]))
                pred = want
            mvs.append(tuple(pred))
        # read_compound_type
        masked, jnt = self.s.masked_compound, self.s.jnt_comp
        wedge = WEDGE_SQUARES.get(wl) if wl == hl else None
        ctype = blk.ctype
        if ctype in ("wedge", "diffwtd") and not masked:
            ctype = "average"
        if ctype == "distance" and not jnt:
            ctype = "average"
        if ctype == "wedge" and wedge is None:
            ctype = "diffwtd"
        cgi = int(ctype in ("wedge", "diffwtd"))
        cidx = int(ctype != "distance")
        if masked:
            self.put("comp_group_idx",
                     min(5, self._idx_ctx(nbrs, self.cgi, 3)), cgi, 2, 3)
        if not cgi and jnt:
            self.put("compound_idx", 3 * self.same_dist
                     + self._idx_ctx(nbrs, self.cidx, 1), cidx, 2, 3)
        if cgi and wedge is not None:
            self.put("compound_type", wedge, int(ctype == "diffwtd"), 2, 3)
        if ctype == "wedge":
            self.put("wedge_index", wedge, blk.wedge, 16, 17)
            self.literal(blk.sign, 1)
        elif ctype == "diffwtd":
            self.literal(blk.sign, 1)  # mask_type
        # filters: none for GLOBAL_GLOBALMV unless a side's GmType is
        # TRANSLATION
        filt = (0, 0)
        glob = sides == (GLOBAL, GLOBAL)
        if self.filt != 4:
            filt = (self.filt, self.filt)
        elif not glob or TRANSLATION in map(self.gm_type, self.pair):
            filt = blk.filt
            for d in range(2 if self.dual else 1):
                self.put("interp_filter", self._interp_ctx(
                    d, above, left, self.pair[0], 1), filt[d], 3, 4)
            if not self.dual:
                filt = (filt[0], filt[0])
        for key in (f"mode{blk.mode}", ctype):
            self.counts[key] = self.counts.get(key, 0) + 1
        self._store(r, c, wl, hl, tuple(mvs), self.pair, int(NEW in sides),
                    filt, glob, 0, cgi, cidx)

    def block_skip(self, r: int, c: int, wl: int, hl: int) -> None:
        """A skip_mode block: skip_mode 1 (and delta q), its MVs the
        NEAREST_NEARESTMV of SkipModeFrame's stack, its filters EIGHTTAP
        (or the frame's), averaged."""
        above = (r - 1, c) if r > self.r0 else None
        left = (r, c - 1) if c else None
        nbrs = [p for p in (above, left) if p]
        assert self.skip_frames and min(wl, hl) >= 1
        self._preamble(r, c, wl, hl, nbrs, 1)
        self.target = self.skip_frames
        st = self.stack(r, c, wl, hl)[0]
        filt = (0, 0) if self.filt == 4 else (self.filt, self.filt)
        self.counts["skip_mode"] = self.counts.get("skip_mode", 0) + 1
        self._store(r, c, wl, hl, tuple(st[0][0]), self.skip_frames, 0, filt,
                    skip_mode=1)

    def partition(self, r: int, c: int, bl: int, leaf: int,
                  blocks) -> None:
        """The partition of the bl (log2 w4) block at (r, c) into square
        blocks of log2 w4 ``leaf``, in coding order from ``blocks``."""
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        names = {1: "part8", 2: "part16", 3: "part32", 4: "part64"}
        nsym = 4 if bl == 1 else 10
        a = r > self.r0 and self.size[r - 1, c][0] < bl
        lft = c > 0 and self.size[r, c - 1][1] < bl
        ctx = 2 * int(lft) + int(a)
        self.put(names[bl], ctx, 3 if leaf < bl else 0, nsym, nsym + 1)
        if leaf == bl:
            blk = next(blocks)
            if isinstance(blk, SkipModeBlock):
                self.block_skip(r, c, bl, bl)
            else:
                (self.block_pair if isinstance(blk, CompoundBlock)
                 else self.block)(r, c, bl, bl, blk)
            return
        half = 1 << (bl - 1)
        for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
            if bl == 1:
                self.block(r + dr, c + dc, 0, 0, next(blocks))
            else:
                self.partition(r + dr, c + dc, bl - 1, leaf, blocks)

    def saved_cdfs(self, end: bool) -> dict:
        """The CDFs a later frame loads of this one: its starting ones,
        or under ``end`` (disable_frame_end_update_cdf 0) those the tile
        ended with, their adaptation counters cleared."""
        from oavif_tpu_torch.io.av1_refs import clear_counters

        if not end:
            return self.start_cdf
        out = {k: a.copy() for k, a in (self.first_cdf or self.cdf).items()}
        rows = A._cdf_pack(coeff_q_ctx(self.base_q))[3]
        clear_counters([out[k] for k in A._CDF_ORDER], rows)
        return out

    def saved_ids(self):
        """The segment ids a later frame of this size predicts from:
        ((MiRows, MiCols), the map), or None for zeros (spec 7.4, 7.20)."""
        if self.seg is None:
            return None
        if self.seg["map"] == "keep":
            return None if self.seg["prev"] is None else (
                (self.mi_rows, self.mi_cols), self.seg["prev"])
        ids = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        for (y, x), v in self.segids.items():
            ids[y, x] = v
        return (self.mi_rows, self.mi_cols), ids

    def encode(self, sbs: List[Tuple[bool, list]],
               rows_log2: int = 0) -> bytes:
        """The tile group of the superblocks ``sbs`` (128x128 ones split
        into four 64x64 quadrants, each an entry of ``sbs``), in 1 <<
        ``rows_log2`` uniform rows of tiles: each tile from the frame's
        starting CDFs and contexts, each but the last after its size in 4
        bytes, the first's CDFs kept (``context_update_tile_id`` 0)."""
        it = iter(sbs)
        sb = 32 if self.s.sb128 else 16
        sb_rows = -(-self.mi_rows // sb)
        per = -(-sb_rows // (1 << rows_log2)) * sb
        tiles = []
        for r in range(0, self.mi_rows, sb):
            if r and r % per == 0:
                tiles.append(self.enc.done())
                if len(tiles) == 1:
                    self.first_cdf = {k: a.copy() for k, a in self.cdf.items()}
                self.enc = RangeEncoder()
                self.cdf = {k: a.copy() for k, a in self.start_cdf.items()}
                self.above_sp = [0] * len(self.above_sp)
                self.left_sp = [0] * len(self.left_sp)
            self.r0 = r - r % per
            self.r1 = min(self.r0 + per, self.mi_rows)
            for c in range(0, self.mi_cols, sb):
                self.read_deltas = True
                if sb == 16:
                    split, blks = next(it)
                    self.partition(r, c, 4, _leaf(split), iter(blks))
                    continue
                assert r + 16 < self.mi_rows and c + 16 < self.mi_cols
                a = r > self.r0 and self.size[r - 1, c][0] < 5
                lft = c > 0 and self.size[r, c - 1][1] < 5
                self.put("part128", 2 * int(lft) + int(a), 3, 8, 9)
                for dr, dc in ((0, 0), (0, 16), (16, 0), (16, 16)):
                    split, blks = next(it)
                    self.partition(r + dr, c + dc, 4, _leaf(split),
                                   iter(blks))
        tiles.append(self.enc.done())
        if len(tiles) == 1:
            return tiles[0]
        # tile_start_and_end_present_flag 0, then each tile's size
        return b"\0" + b"".join((len(t) - 1).to_bytes(4, "little") + t
                                for t in tiles[:-1]) + tiles[-1]


def _leaf(split) -> int:
    """A superblock's block size (log2 w4): True splits it into 4x4
    blocks and False keeps it whole; an int names the size."""
    if split is True or split is False:
        return 0 if split else 4
    return int(split)


def write_layered(key_obus: bytes, sbs: List[Tuple[bool, list]],
                  filt: int = 4, dual: bool = False, hp: bool = True,
                  base_q: int = 80, lf=(20, 20, 12, 12),
                  ref_deltas=(1, 0, 0, 0, -1, 0, -1, -1),
                  mode_deltas=(0, 0), size=None,
                  motion: bool = False, warps: Optional[dict] = None,
                  pair: Optional[Tuple[int, int]] = None,
                  masked: bool = False, jnt: bool = False,
                  base_layers: int = 1,
                  ref_slots: Tuple[int, ...] = (0,) * 7,
                  order_hint: Optional[int] = None,
                  counts: Optional[dict] = None, gm=None,
                  skip_mode: bool = False, delta_q: bool = False,
                  chain: Optional[dict] = None, interintra: bool = False,
                  seg: Optional[dict] = None, end_cdf: bool = False,
                  tile_rows: int = 0,
                  short: Optional[Tuple[int, int]] = None) -> bytes:
    """libaom's first ``base_layers`` layers (the sequence header and
    frame OBUs of layers 0 .. base_layers - 1 of a layered stream of
    base_layers + 1 layers) and an inter frame of the next layer, of
    ``order_hint`` (``base_layers`` where None), whose superblocks
    ``sbs`` are, in raster order, (False, [one block]) or (True, [the 4x4
    blocks in coding order]) or (n, [the square blocks of log2 width n in
    4x4 units, in coding order]), of ``size`` (the sequence's where
    None), on the slots ``ref_slots`` for LAST .. ALTREF (slot i holds
    layer i, of order hint i). With ``pair`` (two reference frames, LAST
    .. ALTREF) a ``CompoundBlock`` is a compound block on them (8x8 or
    more), under ``enable_masked_compound`` ``masked`` and
    ``enable_jnt_comp`` ``jnt``;
    ``counts``, where given, gets the count of each compound mode
    ("mode0" ..), type and reference kind ("unidir", "bidir") written,
    and of the single-reference blocks among them ("single": an
    ``InterBlock`` there takes its ``ref``, either of the pair), of the
    inter-intra blocks ("ii0" .. "ii3" smooth by interintra_mode,
    "ii_wedge") and of the blocks that took the predicted segment id
    ("seg_id_predicted"). ``motion`` lets each block of 8x8 or
    more with a neighbour take its ``InterBlock.motion`` (a frame of the
    sequence's size only); ``warps``, where given, gets the count of its
    LOCALWARP blocks of each kind. ``gm`` is the frame's global motion
    (``frame_header``), ``skip_mode`` writes skip_mode_present (a
    ``SkipModeBlock`` is then a skip_mode block), ``delta_q`` delta q;
    ``interintra`` sets enable_interintra_compound (an ``InterBlock``'s
    ``ii`` is then written), ``seg`` the frame's segmentation
    (``segmentation_params``; each ``InterBlock``'s ``seg`` and
    ``seg_pred`` where its id is coded; a segment's REF_FRAME, SKIP and
    GLOBALMV features decide its blocks' reference and mode) and
    ``end_cdf`` saves the frame's CDFs for a frame that names it primary
    and ``tile_rows`` cuts it into 1 << tile_rows rows of tiles;
    ``chain``, where given, writes a second frame after this one (which
    then refreshes slot ``base_layers``), of the next layer and order
    hint, whose arguments are this one's but for those ``chain`` names
    (``sbs``, ``gm``, ``ref_slots``, ``pair``, ``skip_mode``, ``delta_q``,
    ``seg``, ``size``, ``end_cdf``, ``tile_rows`` and ``primary``, its
    primary_ref_frame,
    whose slot's global motion, CDFs, segmentation features and segment
    ids (where of its size) it starts from). A 128x128 superblock of
    libaom's sequence is four entries of ``sbs``, its 64x64 quadrants.
    ``short`` (the slots of LAST and GOLDEN; ``chain`` may name its own)
    writes frame_refs_short_signaling, the other references then those
    set_frame_refs picks from the slots' order hints as libaom's layers
    left them; under a sequence with frame ids (libaom's error-resilient
    layers) each written frame takes the id after the last and codes
    its references' ids."""
    obus = list(_obus(key_obus))
    seq_payload = next(key_obus[p:e] for t, _, p, e in obus if t == 1)
    s = A.parse_sequence_header(A._Bits(seq_payload))
    frames = [dict(sbs=sbs, gm=gm, ref_slots=ref_slots, pair=pair,
                   skip_mode=skip_mode, delta_q=delta_q, primary=7,
                   order_hint=base_layers if order_hint is None
                   else order_hint, seg=seg, size=size, end_cdf=end_cdf,
                   tile_rows=tile_rows, short=short)]
    if chain:
        frames.append({**frames[0], "order_hint": frames[0]["order_hint"]
                       + 1, **chain})
    assert s.op_idcs[0] >> 8 == (1 << (base_layers + len(frames))) - 1, \
        "base_layers + the written frames' layers"
    assert s.screen_tools in (0, 2) and not s.decoder_model_info
    key = [raw for t, raw, p, e in obus if t in (3, 4, 6)
           and not ((raw[0] >> 2) & 1 and (raw[1] >> 3) & 3 >= base_layers)]
    # each slot's order hint and frame id after libaom's layers, where a
    # written frame's references follow from them or code them
    real_hints, slot_ids, frame_id = [0] * 8, [0] * 8, 0
    if s.frame_ids or any(f["short"] is not None for f in frames):
        seq_obu = bytes([(1 << 3) | 2]) + _leb128(len(seq_payload)) \
            + seq_payload
        for f_ in A.parse_av1(seq_obu + b"".join(key)).frames:
            frame_id = f_.frame.frame_id
            for j in range(8):
                if f_.frame.refresh_frame_flags >> j & 1:
                    real_hints[j] = f_.frame.order_hint
                    slot_ids[j] = f_.frame.frame_id
    # the sequence header written again: libaom's inter tools where its
    # layer 1 was coded under them, else the frame's
    keep = base_layers > 1
    ws = replace(s, interintra=(s.interintra and keep) or interintra,
                 masked_compound=masked, jnt_comp=jnt,
                 warped_motion=s.warped_motion if keep else motion,
                 dual_filter=s.dual_filter if keep else dual,
                 ref_frame_mvs=s.ref_frame_mvs and keep)
    # each slot's order hint and global motion (libaom's layers: identity)
    slot_hints = list(range(8))
    saved_gm = [None] * 8
    # each slot's saved CDFs (None: libaom's, which no written frame
    # loads), segmentation features and segment ids with their frame size
    # (None: zeros)
    saved_cdfs: List[Optional[dict]] = [None] * 8
    saved_feats: List[Optional[list]] = [None] * 8
    saved_ids: List[Optional[tuple]] = [None] * 8
    seq = sequence_header(ws)
    out = bytes([(1 << 3) | 2]) + _leb128(len(seq)) + seq + b"".join(key)
    if s.frame_ids or frames[0]["short"] is not None:
        slot_hints = real_hints
    for i, f in enumerate(frames):
        hint, slots, fpair = f["order_hint"], f["ref_slots"], f["pair"]
        if f["short"] is not None:
            from oavif_tpu_torch.io.av1_refs import set_frame_refs

            slots = tuple(set_frame_refs(*f["short"], slot_hints, hint,
                                         s.order_hint_bits))
        fids = None
        if s.frame_ids:
            frame_id = (frame_id + 1) % (1 << s.id_len)
            fids = (frame_id, tuple((frame_id - slot_ids[j])
                                    % (1 << s.id_len) - 1 for j in slots))
            assert all(0 <= d < 1 << s.delta_id_len for d in fids[1])
        hints = tuple(slot_hints[j] for j in slots)
        rel = [0] + [A._relative_dist(s, h, hint) for h in hints]
        same_dist = fpair is None or abs(rel[fpair[0]]) == abs(rel[fpair[1]])
        skip_frames = A._skip_mode_frames(s, A.FrameHeader(
            reference_select=True, order_hint=hint,
            ref_order_hints=hints)) if f["skip_mode"] else None
        primary = f["primary"]
        psl = slots[primary] if primary != 7 else None
        fsize = f["size"] or (s.width, s.height)
        assert not motion or fsize == (s.width, s.height), "an unscaled frame"
        fseg = f["seg"]
        tseg, feats = None, None
        if fseg is not None:
            feats = [dict(fseg["features"].get(k, {})) for k in range(8)] \
                if fseg.get("data", True) else saved_feats[psl]
            on = [(k, j) for k in range(8) for j in feats[k]]
            ids = saved_ids[psl] if psl is not None else None
            mi = (2 * ((fsize[1] + 7) >> 3), 2 * ((fsize[0] + 7) >> 3))
            prev = ids[1] if ids is not None and ids[0] == mi else None
            tseg = dict(map=fseg.get("map", "update"), features=feats,
                        last=max((k for k, _ in on), default=0),
                        preskip=any(j >= SEG_REF_FRAME for _, j in on),
                        prev=prev)
        assert psl is None or saved_cdfs[psl] is not None, \
            "a primary reference frame whose CDFs the writer has"
        tile = _Tile(ws, base_q, filt, ws.dual_filter, hp, fsize, motion,
                     fpair, tuple(int(d > 0) for d in rel), same_dist,
                     f["gm"], skip_frames, f["delta_q"], ws.interintra,
                     tseg, saved_cdfs[psl] if psl is not None else None)
        data = tile.encode(f["sbs"], f["tile_rows"])
        refresh = 1 << base_layers if chain and i == 0 else 0
        head = frame_header(
            ws, base_q, filt, hp, lf, ref_deltas, mode_deltas,
            size=None if fsize == (s.width, s.height) else fsize,
            primary=primary, compound=fpair is not None, seg=fseg,
            motion=motion, order_hint=hint, ref_slots=slots,
            slot_hints=tuple(slot_hints), gm=f["gm"],
            prev_gm=saved_gm[psl] if psl is not None else None,
            skip_mode=f["skip_mode"], refresh=refresh, delta_q=f["delta_q"],
            end_cdf=f["end_cdf"], tile_rows_log2=f["tile_rows"],
            short=f["short"], frame_ids=fids)
        if refresh:
            slot_hints[base_layers] = hint
            slot_ids[base_layers] = frame_id
            saved_gm[base_layers] = tuple(
                p for _, p in f["gm"] or ((IDENTITY, GM_IDENTITY),) * 7)
            saved_cdfs[base_layers] = tile.saved_cdfs(f["end_cdf"])
            saved_feats[base_layers] = feats
            saved_ids[base_layers] = tile.saved_ids()
        if warps is not None:
            for k, v in tile.warps.items():
                warps[k] = warps.get(k, 0) + v
        if counts is not None:
            for k, v in tile.counts.items():
                counts[k] = counts.get(k, 0) + v
        out += _obu_ext(6, head.data() + data, base_layers + i)
    return out


def random_sbs(rng: np.random.Generator, n_sb: int, split_every: int,
               max_mv: int, filters: int, hp: bool) -> list:
    """Superblocks of random MVs and filters: every ``split_every``-th
    one split into 256 4x4 blocks (near one MV, so their chroma mixes
    nearby samples), the others one 64x64 block."""
    out = []
    for i in range(n_sb):
        step = 1 if hp else 2

        def mv(base=(0, 0), spread=max_mv):
            return tuple(int(b + step * rng.integers(-spread, spread + 1))
                         for b in base)

        def filt():
            return (int(rng.integers(filters)), int(rng.integers(filters)))

        if split_every and i % split_every == split_every - 1:
            base = mv()
            out.append((True, [InterBlock(mv(base, 6), filt())
                               for _ in range(256)]))
        else:
            out.append((False, [InterBlock(mv(), filt())]))
    return out


def random_compound_sbs(rng: np.random.Generator, n_sb: int, leaves,
                        max_mv: int, hp: bool, types=COMPOUND_TYPES,
                        mode_weights=None, single: float = 0.0,
                        pair: Tuple[int, int] = (1, 7)) -> list:
    """Superblocks of compound blocks: each cut into square blocks of a
    size drawn from ``leaves`` (log2 w4, 1 .. 4), each block of a random
    compound mode (drawn by ``mode_weights``, uniform where None) and type
    (from ``types``), NEWMV sides within ``max_mv`` of zero, filters,
    wedge and sign; or, with probability ``single``, a single-reference
    NEWMV block on either reference of ``pair``."""
    step = 1 if hp else 2
    out = []
    for _ in range(n_sb):
        leaf = int(rng.choice(leaves))

        def mv():
            return tuple(int(step * rng.integers(-max_mv, max_mv + 1))
                         for _ in range(2))

        def block():
            if single and rng.random() < single:
                return InterBlock(mv(), (int(rng.integers(3)),
                                         int(rng.integers(3))),
                                  ref=int(rng.choice(pair)))
            return CompoundBlock(
                int(rng.choice(8, p=mode_weights) if mode_weights else
                    rng.integers(8)), str(rng.choice(types)), mv(), mv(),
                (int(rng.integers(3)), int(rng.integers(3))),
                int(rng.integers(16)), int(rng.integers(2)))

        out.append((leaf, [block() for _ in range(1 << 2 * (4 - leaf))]))
    return out
