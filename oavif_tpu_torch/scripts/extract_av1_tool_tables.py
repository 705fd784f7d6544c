"""Extract the AV1 tables the AVIF reader needs beyond the encoder's
(``oavif_tpu_torch/av1/av1_tables.npz``) from a libaom binary's ``.rodata``
and write ``oavif_tpu_torch/io/av1_tool_tables.npz``:

- ``qm``: the inverse quantizer matrices (spec Quantizer_Matrix, libaom's
  ``iwt_matrix_ref``), 15 levels x 2 plane types (luma, chroma) x 3344
  weights, uint8; level 15 is flat and has no table;
- ``gaussian_sequence``: the film grain's 2048 Gaussian samples (spec
  Gaussian_Sequence), int16;
- ``delta_q`` and ``delta_lf``: the default CDFs of ``delta_q_abs`` and
  ``delta_lf_abs`` (spec Default_Delta_Q_Cdf, Default_Delta_Lf_Cdf; the
  multi-LF CDFs start as four copies of the latter), inverse-CDF uint16
  with the closing 0, as the other tables store them;
- the default CDFs of intra block copy: ``intrabc`` (use_intrabc), the
  motion vector CDFs its DV reads (``mv_joints``, and per component
  ``mv_sign``, ``mv_classes``, ``mv_class0`` and ``mv_bits``; libaom's
  ``default_nmv_context``, which the DV context starts from; an integer
  DV reads no fraction and no high-precision bit), ``txfm_split`` (the
  21 contexts of the var-tx split) and the inter transform-type CDFs
  ``inter_tx1`` (16 types), ``inter_tx2`` (12) and ``inter_tx3`` (2), each
  by the square transform size 4x4 to 32x32;
- ``segment_id``: the default CDFs of ``segment_id`` (spec
  Default_Segment_Id_Cdf, libaom's ``default_spatial_pred_seg_tree_cdf``),
  one row of 8 symbols for each of the 3 contexts of the spatial
  prediction;
- ``upscale_filter``: superres's 8-tap filters at the 64 phases (spec
  Upscale_Filter, libaom's ``av1_resize_filter_normative``), int16;
- the default CDFs of inter frames: ``y_mode`` (by size group),
  ``is_inter``, ``comp_mode``, ``single_ref`` (3 contexts x p1..p6),
  ``new_mv``, ``zero_mv``, ``ref_mv``, ``drl``, ``interp_filter`` (16
  contexts of 3 filters), ``motion_mode`` and ``obmc`` (by block size),
  ``interintra`` (by size group), and the MV CDFs of MvCtx 0, whose
  defaults are those of ``default_nmv_context`` (the intrabc ones above)
  with the fractions ``mv_class0_fr`` and ``mv_fr`` and the
  high-precision bits ``mv_class0_hp`` and ``mv_hp``;
- ``subpel_filters``: inter prediction's Subpel_Filters[6][16][8]
  (regular, smooth, sharp, bilinear, and the 4-tap regular and smooth
  rows of blocks 4 wide or tall; libaom's ``av1_sub_pel_filters_*``),
  int16;
- ``warped_filter``: the warp's 8-tap filters at 193 phases (spec
  Warped_Filters, libaom's ``av1_warped_filter``: three ranges of 64
  phases and a last row that repeats the one before), int16;
- ``div_lut``: the divisor table of the local warp's least squares (spec
  Div_Lut, libaom's ``div_lut``), 257 uint16 from 16384 down to 8192;
- ``obmc_mask``: OBMC's blending weights (spec Obmc_Mask_1 .. _32, libaom's
  ``obmc_mask_*``), uint8, the mask of length n at ``n - 1`` (63 in all);
- ``div_mult``: the MV projection's multipliers of motion field
  estimation (spec Div_Mult, libaom's ``div_mult``), 32 int32 stored as
  int16, 2^14 // i after a leading 0;
- the default CDFs of compound blocks: ``comp_ref_type``, ``uni_comp_ref``
  (3 contexts x p, p1, p2), ``comp_ref`` (3 x p, p1, p2), ``comp_bwdref``
  (3 x p, p1), ``compound_mode`` (8 contexts of the 8 compound modes),
  ``compound_type`` and ``wedge_index`` (by block size), ``comp_group_idx``
  and ``compound_idx`` (6 contexts each);
- ``wedge_codebook``: the spec's Wedge_Codebook[3][16][3] (direction, x
  and y offset of each wedge, for blocks taller than wide, wider than
  tall, and square; libaom's ``wedge_codebook_16_hgtw``, ``_hltw`` and
  ``_heqw``), uint8;
- ``wedge_master``: the wedge masks' master rows (spec
  Wedge_Master_Oblique_Even, _Odd and Wedge_Master_Vertical, libaom's
  ``wedge_master_*``), 3 x 64 uint8, from which spec 7.11.3.11 generates
  every wedge mask;
- ``quant_dist_weight`` and ``quant_dist_lookup``: the distance weights
  of distance-weighted compound prediction (spec Quant_Dist_Weight and
  Quant_Dist_Lookup, libaom's ``quant_dist_weight`` and
  ``quant_dist_lookup_table``), 4 x 2 int32 stored as int16;
- ``skip_mode``: the default CDFs of ``skip_mode`` (spec
  Default_Skip_Mode_Cdf, libaom's ``default_skip_mode_cdfs``), one CDF2 row
  for each of its 3 contexts;
- the default CDFs of inter-intra: ``interintra_mode`` (spec
  Default_Inter_Intra_Mode_Cdf, libaom's ``default_interintra_mode_cdf``),
  4 rows of 4 symbols by size group (row 0, size group 0's, no block
  reads), and ``wedge_interintra`` (spec Default_Wedge_Inter_Intra_Cdf,
  libaom's ``default_wedge_interintra_cdf``), one CDF2 row per block size;
- ``segment_id_predicted``: the default CDFs of ``seg_id_predicted``
  (spec Default_Segment_Id_Predicted_Cdf, libaom's
  ``default_segment_pred_cdf``), three equiprobable CDF2 rows;
- ``ii_weights``: inter-intra's smooth mask weights (spec Ii_Weights_1d,
  libaom's ``ii_weights1d``), 128 uint8.

Each table is found by a structural signature and checked against anchor
values before anything is written: the matrices by their first 4x4 (the
spec's first row), the symmetry of every square matrix (and each w x h
the transpose of h x w), their range and their product with the forward
matrices that follow them in libaom's ``.rodata``; the Gaussian samples by their first eight values, their range
and their spacing of 4; the CDFs by the spec's values and by their shape
(each row decreasing to its closing 0); the upscale filter by its first
three phases, its sums of 128 and its mirror symmetry; the subpel filters
by their first two phases, their sums of 128 and the mirror symmetry of
every phase with its complement; the warped filter by its first two
phases, its sums of 128 and its repeated last row; the divisor table by
its first four values, its end at 8192 and its descent; the OBMC masks by
the spec's 32-entry mask, which libaom keeps followed by the 16, 8, 4, 2
and 1 entry ones, each rising to 64; the projection's multipliers by
their first four values and each the floor of 2^14 / i; the compound
CDFs by their first rows and the spec's values of their last; the wedge
codebooks by their horizontal and vertical entries (which tell the three
apart) and the spec's tables; the wedge master rows and the distance
weights by the spec's values; skip_mode by the spec's three rows, which
libaom keeps as one 16-byte chunk (its zero tail left to the zeroed frame
context); interintra_mode by the spec's rows, its first 32 bytes in
``.rodata`` and its last 8 stored by a ``mov qword`` immediate;
wedge_interintra by the spec's rows, its three chunks that hold the
wedge sizes' rows in ``.rodata`` and its equiprobable ones in the pool;
segment_id_predicted by the spec's rows, the two chunks its copy reads
in the pool (every one of its rows is equiprobable, so no chunk of it is
its own); Ii_Weights_1d by the spec's 128 values. libaom copies its
small default CDFs into the frame context with immediate stores and
16-byte loads, so ``intrabc`` is read from the one store of its value in ``.text``, and
``txfm_split`` from its 16-byte chunks, which the linker keeps in order
with the last one (the array's final 16 bytes, overlapping the one
before) after them; likewise ``uni_comp_ref`` and ``comp_ref`` end in a
row stored by a ``mov qword`` immediate, and a chunk that equals one
already in the pool (the equiprobable head of ``compound_type``, the
constant 16 bytes of ``wedge_master``'s vertical row) is kept only once,
elsewhere.

    python -m oavif_tpu_torch.scripts.extract_av1_tool_tables [LIBAOM]

LIBAOM defaults to the Debian runtime,
``/usr/lib/x86_64-linux-gnu/libaom.so.3.6.0``. ``objcopy`` must be on the
path.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

LIBAOM = "/usr/lib/x86_64-linux-gnu/libaom.so.3.6.0"
OUT = Path(__file__).resolve().parent.parent / "io" / "av1_tool_tables.npz"

QM_LEVELS = 15
QM_TOTAL = 3344
# (width, height) of each stored matrix in table order, as the spec's
# Qm_Offset walks them: the 64-point sizes reuse the 32-point ones
QM_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
            (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))
QM_FIRST = (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150,
            200)
GAUSS_FIRST = (56, 568, -180, 172, 124, -84, 172, -64)
DELTA_CDF = (28160, 32120, 32677)  # AOM_CDF4, both delta-q and delta-LF


NMV_JOINTS = (4096, 11264, 19328)  # AOM_CDF4
INTRABC = 30531  # AOM_CDF2
TXFM_SPLIT_ENDS = ((28581, 23846, 20847), (22401, 16088))
INTER_TX1_FIRST = (4458, 5560, 7695)  # the 4x4 row of TX_SET_INTER_1
# the nsym of each inter transform set (TX_SET_INTER_1, _2, _3)
INTER_TX_NSYM = (16, 12, 2)
SEGMENT_ID_FIRST = (5622, 7893, 16093, 18233, 27809, 28373, 32533)  # AOM_CDF8
UPSCALE_FIRST = ((0, 0, 0, 128, 0, 0, 0, 0), (0, 0, -1, 128, 2, -1, 0, 0),
                 (0, 1, -3, 127, 4, -2, 1, 0))
# each Subpel_Filters table's phase 1 (phase 0 is the identity)
SUBPEL_PHASE1 = ((0, 2, -6, 126, 8, -2, 0, 0), (0, 2, 28, 62, 34, 2, 0, 0),
                 (-2, 2, -6, 126, 8, -2, 2, 0), (0, 0, 0, 120, 8, 0, 0, 0),
                 (0, 0, -4, 126, 8, -2, 0, 0), (0, 0, 30, 62, 34, 2, 0, 0))
WARPED_FIRST = ((0, 0, 127, 1, 0, 0, 0, 0), (0, -1, 127, 2, 0, 0, 0, 0))
DIV_LUT_FIRST = (16384, 16320, 16257, 16194)
DIV_MULT_FIRST = (0, 16384, 8192, 5461)
OBMC_MASK_32 = (33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50, 51, 52, 53,
                55, 56, 57, 58, 59, 60, 60, 61, 62, 64, 64, 64, 64, 64, 64,
                64, 64)
# the inter default CDFs: name -> (the first rows' probabilities, or the
# start of the first row, rows, symbols); each table is found by them and
# read whole
INTER_CDFS = {
    "y_mode": ((22801, 23489, 24293), 4, 13),
    "new_mv": ((24035, 16630, 15339), 6, 2),
    "ref_mv": ((23974, 24188, 17848), 6, 2),
    "comp_mode": ((26828, 24035, 12031), 5, 2),
    "single_ref": ((4897, 1555, 4236), 18, 2),
    "interp_filter": ((31935, 32720), 16, 3),
    "motion_mode": ((10923, 21845) * 3 + (7651, 24760), 20, 3),
    "obmc": ((16384, 16384, 16384, 10437), 22, 2),
    "interintra": ((16384, 26887, 27597), 3, 2),
}
# CDFs found by their first two rows only
CHUNKED_CDFS = {"drl": ((13104, 24560, 18945), 3)}
# zero_mv's two rows live in one ``movabs`` immediate in ``.text``;
# is_inter's first three rows in ``.rodata`` (its fourth, 26538, is the
# spec's Default_Is_Inter_Cdf, which libaom stores by immediate)
ZERO_MV = (2175, 1054)
INTERINTRA_LAST = 30237
IS_INTER = (806, 16662, 20186, 26538)
# the compound blocks' default CDFs: name -> (the first rows'
# probabilities, rows, symbols, the spec's value of the last row's first
# symbol); uni_comp_ref's and comp_ref's last rows are stored by immediate
COMPOUND_CDFS = {
    "comp_ref_type": ((1198, 2070, 9166), 5, 2, 22475),
    "uni_comp_ref": ((5284, 3865, 3128), 9, 2, 26710),
    "comp_ref": ((4946, 9468, 1503), 9, 2, 27544),
    "comp_bwdref": ((2235, 1423, 17182), 6, 2, 30489),
    "compound_mode": ((7760, 13823, 15808, 17641, 19156, 20666, 26891), 8,
                      8, 13046),
    "comp_group_idx": ((26607, 22891, 18840), 6, 2, 22674),
    "compound_idx": ((18244, 12865, 7053), 6, 2, 4644),
}
IMMEDIATE_LAST_ROW = ("uni_comp_ref", "comp_ref")
# compound_type by block size: the rows past its equiprobable head, and
# wedge_index's first row past its three equiprobable ones (8x8)
COMPOUND_TYPE = (23431, 13171, 11470, 9770, 9100, 8233, 6172)
WEDGE_8X8 = (2438, 4440, 6599, 8663)
# the block sizes (BLOCK_SIZES order) that have wedges
WEDGE_SIZES = (3, 4, 5, 6, 7, 8, 9, 18, 19)
# Wedge_Codebook: WEDGE_HORIZONTAL 0, VERTICAL 1, OBLIQUE27 2, OBLIQUE63
# 3, OBLIQUE117 4, OBLIQUE153 5; for blocks taller than wide, wider than
# tall, square (the spec's order)
_WEDGE_COMMON = ((2, 4, 4), (3, 4, 4), (4, 4, 4), (5, 4, 4))
_WEDGE_TAIL = ((2, 4, 2), (2, 4, 6), (5, 4, 2), (5, 4, 6), (3, 2, 4),
               (3, 6, 4), (4, 2, 4), (4, 6, 4))
WEDGE_CODEBOOK = tuple(_WEDGE_COMMON + mid + _WEDGE_TAIL for mid in (
    ((0, 4, 2), (0, 4, 4), (0, 4, 6), (1, 4, 4)),
    ((1, 2, 4), (1, 4, 4), (1, 6, 4), (0, 4, 4)),
    ((0, 4, 2), (0, 4, 6), (1, 2, 4), (1, 6, 4))))
# the master rows: (zeros, the rising samples); 64s fill the rest
WEDGE_MASTER = ((28, (1, 4, 11, 27, 46, 58, 62, 63)),
                (28, (1, 2, 6, 18, 37, 53, 60, 63)),
                (29, (2, 7, 21, 43, 57, 62)))
QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7), (1, 31))
QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))
# Default_Skip_Mode_Cdf
SKIP_MODE = (32621, 20708, 8127)
# Default_Inter_Intra_Mode_Cdf by size group (libaom's first row, size
# group 0's, included), Default_Wedge_Inter_Intra_Cdf's rows of the sizes
# 8x8 .. 32x32 (the others 16384), Default_Segment_Id_Predicted_Cdf
INTERINTRA_MODE = ((8192, 16384, 24576), (1875, 11082, 27332),
                   (2473, 9996, 26388), (4238, 11537, 25926))
WEDGE_INTERINTRA = (20036, 24957, 26704, 27530, 29564, 29444, 26872)
SEGMENT_ID_PREDICTED = (16384, 16384, 16384)
# Ii_Weights_1d as (value, count) runs
II_WEIGHTS = ((60, 1), (58, 1), (56, 1), (54, 1), (52, 1), (50, 1), (48, 1),
              (47, 1), (45, 1), (44, 1), (42, 1), (41, 1), (39, 1), (38, 1),
              (37, 1), (35, 1), (34, 1), (33, 1), (32, 1), (31, 1), (30, 1),
              (29, 1), (28, 1), (27, 1), (26, 1), (25, 1), (24, 1), (23, 1),
              (22, 2), (21, 1), (20, 1), (19, 2), (18, 2), (17, 1), (16, 2),
              (15, 2), (14, 2), (13, 2), (12, 3), (11, 2), (10, 3), (9, 3),
              (8, 4), (7, 4), (6, 5), (5, 5), (4, 8), (3, 9), (2, 15),
              (1, 22))


def section(lib: str, name: str = ".rodata") -> bytes:
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        subprocess.run(["objcopy", "-O", "binary", f"--only-section={name}",
                        lib, f.name], check=True)
        return Path(f.name).read_bytes()


def require(ok, what: str) -> None:
    """Refuse the binary where a table fails its check."""
    if not ok:
        raise ValueError(f"libaom's tables: {what}")


def find_once(data: bytes, pattern: bytes, what: str) -> int:
    at = data.find(pattern)
    require(at >= 0 and data.find(pattern, at + 1) < 0,
            f"{what}: not exactly one match")
    return at


def quantizer_matrices(data: bytes) -> np.ndarray:
    at = find_once(data, bytes(QM_FIRST), "inverse quantizer matrices")
    n = QM_LEVELS * 2 * QM_TOTAL
    iwt = np.frombuffer(data, np.uint8, n, at).reshape(QM_LEVELS, 2, QM_TOTAL)
    wt = np.frombuffer(data, np.uint8, n, at + n).reshape(iwt.shape)
    # weights of 2^5 scale: the flattest levels round to 31-34
    require(iwt.min() >= 30 and 0 < wt.min() and wt.max() <= 34,
            "quantizer matrix weights out of range")
    # forward and inverse weights multiply to 2^10 within the rounding of
    # the forward weight
    prod = wt.astype(np.int32) * iwt
    require(np.all(np.abs(prod - 1024) <= (iwt + 1) // 2),
            "forward and inverse weights do not multiply to 1024")
    mats, off = {}, 0
    for w, h in QM_SIZES:
        mats[w, h] = iwt[..., off:off + w * h].reshape(QM_LEVELS, 2, h, w)
        off += w * h
    # the square matrices are symmetric, each w x h the transpose of h x w
    for w, h in QM_SIZES:
        require(np.array_equal(mats[w, h], np.swapaxes(mats[h, w], 2, 3)),
                f"the {w}x{h} matrix is not the {h}x{w} one transposed")
    # the levels flatten towards 15
    require(iwt[QM_LEVELS - 1].max() <= iwt[0].max(), "level order")
    return iwt.copy()


def gaussian_sequence(data: bytes) -> np.ndarray:
    at = find_once(data, np.array(GAUSS_FIRST, "<i4").tobytes(),
                   "Gaussian sequence")
    g = np.frombuffer(data, "<i4", 2048, at)
    require(np.all(g % 4 == 0) and np.abs(g).max() < 2048,
            "Gaussian samples off their grid")
    require(abs(float(g.mean())) < 16 and 400 < float(g.std()) < 600,
            "Gaussian samples' mean or spread")
    return g.astype(np.int16)


def delta_cdf(data: bytes) -> np.ndarray:
    unit = np.array([32768 - p for p in DELTA_CDF] + [0, 0], "<u2")
    require(data.find(unit.tobytes()) >= 0, "delta q / delta LF CDF not found")
    return unit[:4].astype(np.uint16)


def _icdf(*probs) -> list:
    return [32768 - p for p in probs]


def _cdf_row(row, nsym: int, what: str) -> np.ndarray:
    """One stored CDF row (nsym - 1 decreasing values, the closing 0 and
    the counter 0) as the tables keep it: without the counter."""
    row = np.asarray(row, np.int64)
    vals = row[:nsym - 1]
    require(np.all((vals > 0) & (vals < 32768)) and np.all(np.diff(vals) < 0)
            and row[nsym - 1] == 0 and row[nsym] == 0, f"{what}: not a CDF")
    return row[:nsym].astype(np.uint16)


def mv_cdfs(data: bytes) -> dict:
    """libaom's default_nmv_context: joints, then per component (vertical,
    horizontal) classes, class0_fp[2], fp, sign, class0_hp, hp, class0 and
    bits[10], each row with its counter."""
    head = np.array(_icdf(*NMV_JOINTS) + [0, 0], "<u2").tobytes()
    at = data.find(head)
    require(at >= 0, "MV joints CDF not found")
    comp = 12 + 2 * 5 + 5 + 3 + 3 + 3 + 3 + 10 * 3
    a = np.frombuffer(data, "<u2", 5 + 2 * comp, at)
    out = {"mv_joints": _cdf_row(a[:5], 4, "MV joints")}
    comps = [a[5 + k * comp:5 + (k + 1) * comp] for k in range(2)]
    require(np.array_equal(comps[0], comps[1]),
            "the two MV components' defaults differ")
    rows = {"mv_classes": [], "mv_sign": [], "mv_class0": [], "mv_bits": []}
    for c in comps:
        rows["mv_classes"].append(_cdf_row(c[:12], 11, "MV classes"))
        for off in (12, 17, 22):  # class0_fp, fp: 4 symbols each
            _cdf_row(c[off:off + 5], 4, "MV fraction")
        rows["mv_sign"].append(_cdf_row(c[27:30], 2, "MV sign"))
        for off in (30, 33):  # class0_hp, hp
            _cdf_row(c[off:off + 3], 2, "MV high precision")
        rows["mv_class0"].append(_cdf_row(c[36:39], 2, "MV class0"))
        rows["mv_bits"].append(np.stack([_cdf_row(c[39 + 3 * i:42 + 3 * i], 2,
                                                  "MV bits")
                                         for i in range(10)]))
    require(rows["mv_sign"][0][0] == 16384, "MV sign CDF")
    out.update({k: np.stack(v) for k, v in rows.items()})
    return out


def intrabc_cdf(text: bytes) -> np.ndarray:
    """The frame context's intrabc CDF: libaom stores it with one
    ``mov dword [reg + disp32], imm32`` of its first two entries."""
    imm = np.array(_icdf(INTRABC) + [0], "<u2").tobytes()
    hits = [i for i in range(len(text)) if text.startswith(imm, i)
            and i >= 6 and text[i - 6] == 0xC7 and 0x80 <= text[i - 5] <= 0x87]
    require(len(hits) == 1, "intrabc CDF store: not exactly one")
    return np.frombuffer(imm, "<u2").astype(np.uint16)


def txfm_split_cdf(data: bytes) -> np.ndarray:
    """default_txfm_partition_cdf, 21 CDF2 rows of 3 uint16 (126 bytes):
    its first seven 16-byte chunks in order, then its last 16 bytes."""
    first, last = TXFM_SPLIT_ENDS
    at = find_once(data, np.array(sum(([v, 0, 0] for v in _icdf(*first)),
                                      []), "<u2").tobytes(), "txfm split CDF")
    body = data[at:at + 112] + data[at + 112 + 2:at + 112 + 16]
    a = np.frombuffer(body, "<u2").reshape(21, 3)
    rows = np.stack([_cdf_row(r, 2, "txfm split") for r in a])
    require(tuple(32768 - rows[-2:, 0].astype(int)) == last,
            "txfm split CDF: its last rows")
    return rows


def inter_tx_cdfs(data: bytes) -> dict:
    """default_inter_ext_tx_cdf[4 sets][4 sizes][17]: set 0 (DCT only)
    zero, then TX_SET_INTER_1, _2 and _3 each padded to 17 entries."""
    at = find_once(data, np.array(_icdf(*INTER_TX1_FIRST), "<u2").tobytes(),
                   "inter transform type CDF") - 4 * 17 * 2
    a = np.frombuffer(data, "<u2", 4 * 4 * 17, at).reshape(4, 4, 17)
    require(not a[0].any(), "inter transform type CDF: set 0 not empty")
    out = {}
    for s, n in enumerate(INTER_TX_NSYM, 1):
        require(not a[s, :, n + 1:].any(), "inter transform type padding")
        out[f"inter_tx{s}"] = np.stack([_cdf_row(r, n, f"inter set {s}")
                                        for r in a[s]])
    return out


def segment_id_cdf(data: bytes) -> np.ndarray:
    """default_spatial_pred_seg_tree_cdf, 3 rows of 8 symbols, which
    libaom's ``.rodata`` holds in 16-byte rows (7 values and the closing
    0; the frame context adds the counter)."""
    at = find_once(data, np.array(_icdf(*SEGMENT_ID_FIRST) + [0], "<u2")
                   .tobytes(), "segment id CDF")
    a = np.frombuffer(data, "<u2", 3 * 8, at).reshape(3, 8)
    rows = np.stack([_cdf_row(np.append(r, 0), 8, "segment id") for r in a])
    require(tuple(32768 - rows[2, :3].astype(int)) == (27527, 28487, 28723),
            "segment id CDF: its last row")
    return rows


def upscale_filter(data: bytes) -> np.ndarray:
    """av1_resize_filter_normative: 64 phases of 8 int16 taps."""
    at = find_once(data, np.array(UPSCALE_FIRST, "<i2").tobytes(),
                   "upscale filter")
    f = np.frombuffer(data, "<i2", 64 * 8, at).reshape(64, 8)
    require(np.all(f.sum(1) == 128), "upscale filter: a phase's taps do not "
            "sum to 128")
    # phase 64 - i is phase i mirrored
    require(np.array_equal(f[1:][::-1], f[1:, ::-1]),
            "upscale filter: phases not mirrored")
    return f.astype(np.int16)


def _rows(probs, nsym: int) -> list:
    """Stored rows of CDF``nsym`` tables: each the inverse CDF, its
    closing 0 and the counter; ``probs`` flat, nsym - 1 per row."""
    out = []
    for i in range(0, len(probs), nsym - 1):
        out += _icdf(*probs[i:i + nsym - 1]) + [0, 0]
    return out


def _table(data: bytes, at: int, rows: int, nsym: int, what: str):
    """A CDF table of ``rows`` rows at ``at``: stored whole; or without
    its last row's closing 0 and counter (the compiler leaves the zero
    tail of an array to the zeroed frame context); or, as txfm_split is,
    as its whole 16-byte chunks in order, then the array's last 16 bytes,
    overlapping the chunk before."""
    n = rows * (nsym + 1) * 2
    k = n // 16
    whole = data[at:at + n]
    trimmed = data[at:at + n - 4] + bytes(4)
    split = data[at:at + 16 * k] + data[at + 16 * k + 16 * (k + 1) - n:
                                        at + 16 * (k + 1)]
    for body in (whole, trimmed, split):
        a = np.frombuffer(body, "<u2").reshape(rows, nsym + 1)
        try:
            return np.stack([_cdf_row(r, nsym, what) for r in a])
        except ValueError:
            continue
    require(False, f"{what}: not a CDF table")


def inter_cdfs(data: bytes, text: bytes) -> dict:
    """The inter frames' default CDFs (INTER_CDFS, CHUNKED_CDFS, ZERO_MV,
    IS_INTER), each row checked to be a CDF."""
    out = {}
    for name, (first, rows, nsym) in INTER_CDFS.items():
        # whole rows, or the start of the first one
        sig = _rows(first, nsym) if len(first) % (nsym - 1) == 0 \
            else _icdf(*first)
        at = find_once(data, np.array(sig, "<u2").tobytes(), f"{name} CDF")
        out[name] = _table(data, at, rows, nsym, name)
    for name, (first, rows) in CHUNKED_CDFS.items():
        at = find_once(data, np.array(_rows(first[:2], 2), "<u2").tobytes(),
                       f"{name} CDF")
        out[name] = _table(data, at, rows, 2, name)
        require(tuple(32768 - out[name][:, 0].astype(int)) == first,
                f"{name} CDF: its rows")
    imm = np.array(_icdf(ZERO_MV[0]) + [0, 0] + _icdf(ZERO_MV[1]),
                   "<u2").tobytes()
    hits = [i for i in range(2, len(text) - 8) if text.startswith(imm, i)
            and text[i - 2] in (0x48, 0x49) and 0xB8 <= text[i - 1] <= 0xBF]
    require(len(hits) == 1, "zero_mv CDF store: not exactly one")
    out["zero_mv"] = np.array([_icdf(p) + [0] for p in ZERO_MV], np.uint16)
    head = np.array(_rows(IS_INTER[:3], 2)[:8], "<u2").tobytes()
    find_once(data, head, "is_inter CDF")
    out["is_inter"] = np.array([_icdf(p) + [0] for p in IS_INTER], np.uint16)
    out["single_ref"] = out["single_ref"].reshape(3, 6, 2)
    # libaom's .rodata holds 20 rows of motion_mode: the 4x16 and 16x4
    # rows, which no block reads (OBMC and warped motion need both sides
    # at least 8), are the equiprobable ones of 4x4-8x4
    # interintra's fourth row is not beside its first three (the spec's
    # Default_Inter_Intra_Cdf gives 30237)
    out["interintra"] = np.concatenate(
        [out["interintra"], np.array([_icdf(INTERINTRA_LAST) + [0]],
                                     np.uint16)])
    mm = out["motion_mode"]
    out["motion_mode"] = np.concatenate([mm[:16], mm[:2], mm[16:]])
    return out


def mv_fraction_cdfs(data: bytes) -> dict:
    """The MV fraction and high-precision CDFs of default_nmv_context
    (class0_fp[2], fp, class0_hp, hp per component), as ``mv_cdfs`` reads
    the others."""
    at = data.find(np.array(_icdf(*NMV_JOINTS) + [0, 0], "<u2").tobytes())
    comp = 12 + 2 * 5 + 5 + 3 + 3 + 3 + 3 + 10 * 3
    a = np.frombuffer(data, "<u2", 5 + 2 * comp, at)
    cs = [a[5 + k * comp:5 + (k + 1) * comp] for k in range(2)]
    return {"mv_class0_fr": np.stack([np.stack(
                [_cdf_row(c[o:o + 5], 4, "MV class0 fraction")
                 for o in (12, 17)]) for c in cs]),
            "mv_fr": np.stack([_cdf_row(c[22:27], 4, "MV fraction")
                               for c in cs]),
            "mv_class0_hp": np.stack([_cdf_row(c[30:33], 2, "MV class0 hp")
                                      for c in cs]),
            "mv_hp": np.stack([_cdf_row(c[33:36], 2, "MV hp") for c in cs])}


def subpel_filters(data: bytes) -> np.ndarray:
    """Subpel_Filters: six tables of 16 phases of 8 int16 taps, each found
    by its first two phases (libaom keeps identical copies)."""
    out = []
    for first in SUBPEL_PHASE1:
        sig = np.array(((0, 0, 0, 128, 0, 0, 0, 0), first), "<i2").tobytes()
        at = data.find(sig)
        require(at >= 0, "subpel filter not found")
        f = np.frombuffer(data, "<i2", 16 * 8, at).reshape(16, 8)
        i = at
        while (i := data.find(sig, i + 1)) >= 0:
            require(np.array_equal(np.frombuffer(data, "<i2", 128, i)
                                   .reshape(16, 8), f),
                    "subpel filter copies differ")
        require(np.all(f.sum(1) == 128), "subpel filter: taps do not sum "
                "to 128")
        require(np.array_equal(f[1:][::-1], f[1:, ::-1]),
                "subpel filter: phases not mirrored")
        out.append(f)
    return np.stack(out).astype(np.int16)


def warped_filter(data: bytes) -> np.ndarray:
    """av1_warped_filter: 193 phases of 8 int16 taps, found by its first
    two phases (a shorter table elsewhere shares them; it fails the sums)."""
    sig = np.array(WARPED_FIRST, "<i2").tobytes()
    found = []
    at = -1
    while (at := data.find(sig, at + 1)) >= 0:
        if at + 193 * 16 > len(data):
            continue
        f = np.frombuffer(data, "<i2", 193 * 8, at).reshape(193, 8)
        if np.all(f.sum(1) == 128):
            found.append(f)
    require(len(found) == 1, "warped filter: not exactly one table whose "
            "taps sum to 128")
    f = found[0]
    require(np.array_equal(f[192], f[191]), "warped filter: the last row "
            "does not repeat the one before")
    require(np.array_equal(f[64], (0, 0, 0, 127, 1, 0, 0, 0)),
            "warped filter: phase 64")
    return f.astype(np.int16)


def div_lut(data: bytes) -> np.ndarray:
    """div_lut: 257 uint16 multipliers, 2^14 / (1 + i / 256) rounded."""
    at = find_once(data, np.array(DIV_LUT_FIRST, "<u2").tobytes(),
                   "divisor table")
    t = np.frombuffer(data, "<u2", 257, at)
    require(t[-1] == 8192 and np.all(np.diff(t.astype(int)) < 0),
            "divisor table: not falling to 8192")
    want = np.floor((1 << 22) / (256 + np.arange(257)) + 0.5)
    require(np.array_equal(t, want), "divisor table: not 2^22 / (256 + i)")
    return t.astype(np.uint16)


def obmc_masks(data: bytes) -> np.ndarray:
    """obmc_mask_1 .. _32 as one array, the mask of length n at n - 1:
    libaom keeps the 32-entry one followed by the 16, 8, 4, 2 and 1 entry
    ones."""
    at = find_once(data, bytes(OBMC_MASK_32), "OBMC mask")
    masks = {}
    for n in (32, 16, 8, 4, 2, 1):
        m = np.frombuffer(data, np.uint8, n, at)
        require(m[-1] == 64 and np.all(np.diff(m.astype(int)) >= 0),
                f"OBMC mask of {n}: not rising to 64")
        masks[n] = m
        at += n
    return np.concatenate([masks[n] for n in (1, 2, 4, 8, 16, 32)])


def div_mult(data: bytes) -> np.ndarray:
    """div_mult: 32 int32 multipliers, 0 then 2^14 // i."""
    at = find_once(data, np.array(DIV_MULT_FIRST, "<i4").tobytes(),
                   "projection multipliers")
    t = np.frombuffer(data, "<i4", 32, at)
    want = [0] + [(1 << 14) // i for i in range(1, 32)]
    require(t.tolist() == want, "projection multipliers: not 2^14 // i")
    return t.astype(np.int16)


def _last_row_store(text: bytes, prob: int, what: str) -> np.ndarray:
    """The last row of a CDF2 table that libaom stores with one ``mov
    qword [reg + disp32], imm32``: the table's final 8 bytes, the row
    before's counter then the row (its value, the closing 0, the counter
    0)."""
    imm = np.array([0] + _icdf(prob), "<u2").tobytes()
    hits = [i for i in range(7, len(text) - 4) if text.startswith(imm, i)
            and text[i - 7] == 0x48 and text[i - 6] == 0xC7
            and 0x80 <= text[i - 5] <= 0x87]
    require(len(hits) == 1, f"{what}: its last row's store, not exactly one")
    return np.array(_icdf(prob) + [0], np.uint16)


def _pooled(data: bytes, chunk: bytes, what: str) -> None:
    """Require a 16-byte chunk the linker may have merged with an equal
    one: somewhere in ``.rodata`` at a 16-byte boundary."""
    at = -1
    while (at := data.find(chunk, at + 1)) >= 0:
        if at % 16 == 0:
            return
    require(False, f"{what}: a 16-byte chunk not in the pool")


def compound_cdfs(data: bytes, text: bytes) -> dict:
    """The compound blocks' default CDFs (COMPOUND_CDFS, COMPOUND_TYPE,
    WEDGE_8X8), each row checked to be a CDF and the last against the
    spec."""
    out = {}
    for name, (first, rows, nsym, last) in COMPOUND_CDFS.items():
        sig = _rows(first, nsym) if len(first) % (nsym - 1) == 0 \
            else _icdf(*first)
        at = find_once(data, np.array(sig, "<u2").tobytes(), f"{name} CDF")
        if name in IMMEDIATE_LAST_ROW:
            head = np.frombuffer(data, "<u2", (rows - 1) * (nsym + 1), at)
            t = np.stack([_cdf_row(r, nsym, name)
                          for r in head.reshape(rows - 1, nsym + 1)]
                         + [_last_row_store(text, last, name)])
        else:
            t = _table(data, at, rows, nsym, name)
        require(32768 - int(t[-1, 0]) == last, f"{name} CDF: its last row")
        out[name] = t
    out["uni_comp_ref"] = out["uni_comp_ref"].reshape(3, 3, 2)
    out["comp_ref"] = out["comp_ref"].reshape(3, 3, 2)
    out["comp_bwdref"] = out["comp_bwdref"].reshape(3, 2, 2)
    # compound_type: its first 16 bytes (two and a half equiprobable rows)
    # merged into the pool; the rest, up to its zero tail, in order
    eq = np.array([16384, 0, 0] * 2 + [16384, 0], "<u2").tobytes()
    _pooled(data, eq, "compound_type CDF")
    sig = np.array([0] + sum((_icdf(p) + [0, 0] for p in COMPOUND_TYPE), []),
                   "<u2").tobytes()
    at = find_once(data, sig, "compound_type CDF")
    body = eq + data[at:at + 22 * 3 * 2 - 16 - 4] + bytes(4)
    a = np.frombuffer(body, "<u2").reshape(22, 3)
    ct = np.stack([_cdf_row(r, 2, "compound_type") for r in a])
    want = [16384] * 22
    for i, p in zip((3, 4, 5, 6, 7, 8, 9, 18, 19),
                    COMPOUND_TYPE + (11820, 7701)):
        want[i] = p
    require((32768 - ct[:, 0].astype(int)).tolist() == want,
            "compound_type CDF: its rows")
    out["compound_type"] = ct
    # wedge_index: 22 rows of 16 symbols, whole, the 8x8 row the fourth
    at = find_once(data, np.array(_icdf(*WEDGE_8X8), "<u2").tobytes(),
                   "wedge_index CDF") - 3 * 17 * 2
    wi = _table(data, at, 22, 16, "wedge_index")
    flat = np.array(_icdf(*range(2048, 32768, 2048)) + [0], np.uint16)
    for i in range(22):
        require((i in WEDGE_SIZES) != np.array_equal(wi[i], flat),
                "wedge_index CDF: equiprobable rows where no wedge is")
    out["wedge_index"] = wi
    return out


def wedge_tables(data: bytes) -> dict:
    """Wedge_Codebook, each table found by its middle entries (the
    horizontal and vertical wedges, which differ by shape), and the master
    rows: the oblique ones whole, the vertical one by its two rising
    chunks (its constant chunks merged into the pool)."""
    book = []
    for shape in WEDGE_CODEBOOK:
        mid = np.array(shape[4:8], "<i4").tobytes()
        at = find_once(data, mid, "wedge codebook") - 4 * 12
        t = np.frombuffer(data, "<i4", 48, at).reshape(16, 3)
        require(t.tolist() == [list(e) for e in shape],
                "wedge codebook: not the spec's")
        book.append(t)
    master = []
    for zeros, ramp in WEDGE_MASTER:
        row = bytes([0] * zeros + list(ramp) + [64] * (64 - zeros - len(ramp)))
        if data.find(row) < 0:
            find_once(data, row[16:48], "wedge master")
            _pooled(data, row[:16], "wedge master")
            _pooled(data, row[48:], "wedge master")
        else:
            find_once(data, row, "wedge master")
        master.append(np.frombuffer(row, np.uint8))
    return {"wedge_codebook": np.stack(book).astype(np.uint8),
            "wedge_master": np.stack(master)}


def quant_dist(data: bytes) -> dict:
    """Quant_Dist_Weight and Quant_Dist_Lookup, int32 in libaom."""
    out = {}
    for name, want in (("quant_dist_weight", QUANT_DIST_WEIGHT),
                       ("quant_dist_lookup", QUANT_DIST_LOOKUP)):
        at = find_once(data, np.array(want, "<i4").tobytes(), name)
        out[name] = np.frombuffer(data, "<i4", 8, at).reshape(4, 2) \
            .astype(np.int16)
    return out


def skip_mode_cdf(data: bytes) -> np.ndarray:
    """default_skip_mode_cdfs: three CDF2 rows, found by all of them but
    the last row's counter and checked to be a CDF."""
    sig = np.array(_rows(SKIP_MODE[:2], 2) + _icdf(SKIP_MODE[2]) + [0],
                   "<u2").tobytes()
    t = _table(data, find_once(data, sig, "skip_mode CDF"), 3, 2,
               "skip_mode")
    require(tuple(32768 - t[:, 0].astype(int)) == SKIP_MODE,
            "skip_mode CDF: its rows")
    return t


def interintra_cdfs(data: bytes, text: bytes) -> dict:
    """default_interintra_mode_cdf: its first two 16-byte chunks in
    ``.rodata``, its last 8 bytes (the fourth row's last two values, the
    closing 0 and the counter) stored by one ``mov qword [reg + disp32],
    imm32``; default_wedge_interintra_cdf: the chunks of its wedge sizes'
    rows (16-bit words 8 .. 31) in ``.rodata``, the equiprobable others
    merged into the pool. Each row is checked against the spec's."""
    flat = sum((_icdf(*r) + [0, 0] for r in INTERINTRA_MODE), [])
    at = find_once(data, np.array(flat[:16], "<u2").tobytes(),
                   "interintra_mode CDF")
    imm = np.array(flat[16:18], "<u2").tobytes()
    hits = [i for i in range(7, len(text) - 4) if text.startswith(imm, i)
            and text[i - 7] == 0x48 and text[i - 6] == 0xC7
            and 0x80 <= text[i - 5] <= 0x87]
    require(len(hits) == 1, "interintra_mode CDF: its last row's store, "
            "not exactly one")
    body = data[at:at + 32] + imm + bytes(4)
    mode = np.stack([_cdf_row(r, 4, "interintra_mode") for r in
                     np.frombuffer(body, "<u2").reshape(4, 5)])
    require([tuple(32768 - r[:3].astype(int)) for r in mode]
            == list(INTERINTRA_MODE), "interintra_mode CDF: its rows")
    probs = [16384] * 22
    probs[3:10] = WEDGE_INTERINTRA
    wflat = np.array(sum((_icdf(p) + [0, 0] for p in probs), []), "<u2")
    at = find_once(data, wflat[8:32].tobytes(), "wedge_interintra CDF")
    for k in (0, 32, 40, 48, 56, 58):
        _pooled(data, wflat[k:k + 8].tobytes(), "wedge_interintra CDF")
    body = wflat[:8].tobytes() + data[at:at + 48] + wflat[32:].tobytes()
    wedge = np.stack([_cdf_row(r, 2, "wedge_interintra") for r in
                      np.frombuffer(body, "<u2").reshape(22, 3)])
    require((32768 - wedge[:, 0].astype(int)).tolist() == probs,
            "wedge_interintra CDF: its rows")
    return {"interintra_mode": mode, "wedge_interintra": wedge}


def segment_id_predicted_cdf(data: bytes) -> np.ndarray:
    """default_segment_pred_cdf: three equiprobable CDF2 rows, which
    libaom copies by two 16-byte loads (words 0 .. 7 and 1 .. 8) from the
    pool its equal chunks share."""
    flat = np.array(sum((_icdf(p) + [0, 0] for p in SEGMENT_ID_PREDICTED),
                        []), "<u2")
    for k in (0, 1):
        _pooled(data, flat[k:k + 8].tobytes(), "segment_id_predicted CDF")
    return np.stack([_cdf_row(r, 2, "segment_id_predicted")
                     for r in flat.reshape(3, 3)])


def ii_weights(data: bytes) -> np.ndarray:
    """ii_weights1d: 128 uint8 falling from 60 to 1, found by its first
    16 and checked whole against the spec's Ii_Weights_1d."""
    want = [v for v, n in II_WEIGHTS for _ in range(n)]
    at = find_once(data, bytes(want[:16]), "inter-intra weights")
    t = np.frombuffer(data, np.uint8, 128, at)
    require(len(want) == 128 and t.tolist() == want,
            "inter-intra weights: not the spec's Ii_Weights_1d")
    return t.copy()


def main(argv: list) -> None:
    lib = argv[0] if argv else LIBAOM
    data = section(lib)
    cdf = delta_cdf(data)
    tables = {"qm": quantizer_matrices(data),
              "gaussian_sequence": gaussian_sequence(data),
              "delta_q": cdf, "delta_lf": cdf.copy(),
              "intrabc": intrabc_cdf(section(lib, ".text")),
              **mv_cdfs(data), "txfm_split": txfm_split_cdf(data),
              **inter_tx_cdfs(data), "segment_id": segment_id_cdf(data),
              "upscale_filter": upscale_filter(data),
              **inter_cdfs(data, section(lib, ".text")),
              **mv_fraction_cdfs(data), "subpel_filters": subpel_filters(data),
              "warped_filter": warped_filter(data), "div_lut": div_lut(data),
              "obmc_mask": obmc_masks(data), "div_mult": div_mult(data),
              **compound_cdfs(data, section(lib, ".text")),
              **wedge_tables(data), **quant_dist(data),
              "skip_mode": skip_mode_cdf(data),
              **interintra_cdfs(data, section(lib, ".text")),
              "segment_id_predicted": segment_id_predicted_cdf(data),
              "ii_weights": ii_weights(data)}
    np.savez_compressed(OUT, **tables)
    for k, v in tables.items():
        print(f"{k}: {v.shape} {v.dtype}")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1:])
