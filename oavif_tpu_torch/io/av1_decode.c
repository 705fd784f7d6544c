/* AV1 tile decoding for the port's AVIF reader
 * (oavif_tpu_torch/io/avif.py).
 *
 * One call decodes every tile of one frame whose headers the Python side
 * has parsed, a shown key frame or an inter frame on reference frames of
 * any size within the spec's limits (their planes and sizes from
 * io/av1_refs.py; the CDFs it
 * starts from are the defaults or a reference's, and the call returns the
 * context_update_tile_id tile's at its end): the symbol decoder (spec 8.2), the partition
 * and mode-info syntax of intra frames (spec 5.11), the coefficient
 * syntax (spec 5.11.39), the loop-restoration unit syntax (spec
 * 5.11.57-58), and the reconstruction: intra prediction (spec 7.11.2:
 * every mode, the angle deltas, smooth, Paeth, CFL, palette and the
 * recursive filter), dequantization (with the quantizer matrices and
 * each superblock's delta q) and the inverse transforms (spec 7.12.3,
 * 7.13.3); and intra block copy (allow_intrabc): the DV stack of the
 * spatial neighbours (spec 7.10.2), the DV itself (spec 5.11.26, 5.11.32),
 * the var-tx tree (spec 5.11.17) and the inter transform sets with their
 * FLIPADST types, and the bilinear prediction from the frame decoded so far
 * (spec 7.11.3); and an inter frame's blocks (spec 5.11.18-5.11.33, 7.10.2,
 * 7.11.3): intra blocks with y_mode by size group, single-reference inter
 * blocks (read_ref_frames, the MV stack as dav1d scans it, NEWMV,
 * NEARESTMV, NEARMV and GLOBALMV with their contexts and drl, read_mv in
 * MV context 0 with the fraction and high-precision bits, the motion mode
 * and inter-intra symbols, switchable and dual interpolation filters) and
 * their prediction by the Subpel_Filters, sub-8x8 chroma from several
 * blocks' MVs, and through a reference of another size (or the coded width
 * under superres) by the scaled position and step of spec 7.11.3.3; the
 * motion modes OBMC (spec 7.11.3.10-11: the above and left neighbours'
 * predictions blended in) and LOCALWARP (spec 7.10.4 find_warp_samples,
 * 7.11.3.5-8: the least-squares warp of the neighbours' MVs, its shear,
 * and the block warp per 8x8 by the Warped_Filters); compound blocks
 * (spec 5.11.25-5.11.27, 7.10.2, 7.11.3.1, 7.11.3.11-15: comp_mode, the
 * unidirectional and bidirectional reference pairs, the pair's MV stack
 * with its compound extra search, the eight compound modes, and the
 * average, distance-weighted, wedge and difference-weighted blends of the
 * two unclipped predictions); inter-intra (spec 5.11.24, 7.11.3.13-14: a
 * single-reference block of 8x8 to 32x32 whose prediction, by its MV or
 * the global warp, is blended with the DC, V, H or SMOOTH intra prediction
 * of its plane block by a smooth or wedge mask); global
 * motion of every type (spec 7.10.2.1, 7.11.3.1: each block's GlobalMvs in
 * its MV stack and its GLOBAL sides, and the block warp by a reference's
 * gm_params where its shear is valid); skip_mode blocks (spec 5.11.10,
 * 5.11.18-25: a compound NEAREST_NEARESTMV average on SkipModeFrame,
 * read with one symbol); under use_ref_frame_mvs, motion field
 * estimation (spec 7.9: the MVs that earlier frames stored, projected onto
 * this one before its tiles) and the MV stack's temporal candidates (spec
 * 7.10.2.5-6), and for every frame the storage of its own MVs that later
 * frames project (spec 7.19); and segment ids that an inter frame predicts
 * from its primary reference frame's map (spec 5.11.9, 7.20-21: kept
 * whole under segmentation_update_map 0, or per block by seg_id_predicted
 * under segmentation_temporal_update). The tile decode refuses no tool; the
 * frame types and header forms it does not read are refused before it,
 * by avif.py. The post-filters (deblocking, CDEF,
 * loop restoration) and film grain run afterwards on the block records
 * and restoration units this call returns.
 *
 * The default CDFs, the scans, the smooth weights, the directional
 * derivatives and the filter-intra taps come from the caller
 * (av1/av1_tables.npz), the quantizer matrices too (io/av1_tool_tables.npz,
 * scripts/extract_av1_tool_tables.py); the CDFs adapt with the host library's
 * update_cdf_c and are copied afresh for every tile. The 1D inverse
 * transforms are the host library's (inv_1d_kind_pub).
 *
 * The toolset is that of libaom's intra frames: 4:4:4, 4:2:2, 4:2:0 and
 * monochrome planes at 8, 10 and 12 bits (the chroma of 4xN and Nx4 blocks
 * coded on the last block of their 8x8, CFL on subsampled luma), every
 * partition (the A/B and 4-way ones included), every transform size
 * (the 4:1 ones and the 64-length zero-out) and the intra transform sets
 * (V_DCT and H_DCT with their own scans and contexts), TX_MODE_SELECT,
 * luma and chroma palettes, filter intra, the intra edge filter and
 * upsampling, quantizer matrices, delta q and delta LF (one DeltaLF, or
 * under delta_lf_multi one per plane and direction), segmentation (the
 * ids, before or after skip, and a segment's SEG_LVL_SKIP; its ALT_Q
 * here, its ALT_LF in av1_postfilter.c; in an inter frame also predicted
 * from the previous map), and intrabc.
 *
 * Besides the planes, one call returns what the post-filters
 * (av1_postfilter.c) read: the transform size of every 4x4 of every
 * plane, the skip flag of every 4x4 luma block, the CDEF strength index
 * of every 64x64, the four DeltaLF and the segment of every 4x4 and the
 * restoration units; and
 * a count of each tool a stream used (the T_* enum).
 *
 * Built into the host library beside the tile coder (av1/entropy/fast.py).
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

void update_cdf_c(uint16_t *icdf, int nsym, int val);
void inv_1d_kind_pub(const int64_t *in, int64_t *out, int n, int kind);

enum { AV1D_OK = 0, AV1D_CORRUPT = 1 };

/* CDF pack order (must match avif.py _CDF_ORDER) */
enum {
    D_PART8, D_PART16, D_PART32, D_PART64, D_PART128, D_SKIP, D_KF_Y,
    D_UV_MODE, D_UV_MODE_CFL, D_ANGLE_DELTA, D_CFL_SIGN, D_CFL_ALPHA,
    D_TX_SIZE, D_TX1, D_TX2, D_TXB_SKIP, D_EOB16, D_EOB32, D_EOB64,
    D_EOB128, D_EOB256, D_EOB512, D_EOB1024, D_EOB_EXTRA, D_BASE_EOB,
    D_BASE, D_BR, D_DC_SIGN, D_PAL_Y_MODE, D_PAL_UV_MODE, D_PAL_Y_SIZE,
    D_PAL_Y_CI2, D_PAL_Y_CI3, D_PAL_Y_CI4, D_PAL_Y_CI5, D_PAL_Y_CI6,
    D_PAL_Y_CI7, D_PAL_Y_CI8, D_FI_USE, D_FI_MODE, D_WIENER, D_SGR,
    D_SWITCHABLE, D_DELTA_Q, D_DELTA_LF, D_PAL_UV_SIZE,
    D_PAL_UV_CI2, D_PAL_UV_CI3, D_PAL_UV_CI4, D_PAL_UV_CI5, D_PAL_UV_CI6,
    D_PAL_UV_CI7, D_PAL_UV_CI8, D_INTRABC, D_MV_JOINTS, D_MV_SIGN,
    D_MV_CLASSES, D_MV_CLASS0, D_MV_BITS, D_TXFM_SPLIT, D_INTER_TX1,
    D_INTER_TX2, D_INTER_TX3, D_SEGMENT_ID, D_DELTA_LF_MULTI,
    /* inter frames: y_mode by size group, is_inter, comp_mode,
     * single_ref_p1..p6, new_mv, zero_mv, ref_mv, drl_mode, interp_filter,
     * motion_mode, use_obmc, interintra, and the MV CDFs of MvCtx 0 */
    D_Y_MODE, D_IS_INTER, D_COMP_MODE, D_SINGLE_REF, D_NEW_MV, D_ZERO_MV,
    D_REF_MV, D_DRL, D_INTERP, D_MOTION_MODE, D_OBMC, D_INTERINTRA,
    D_MV0_JOINTS, D_MV0_SIGN, D_MV0_CLASSES, D_MV0_CLASS0, D_MV0_BITS,
    D_MV0_CLASS0_FR, D_MV0_FR, D_MV0_CLASS0_HP, D_MV0_HP,
    /* compound blocks: comp_ref_type, uni_comp_ref p..p2, comp_ref
     * p..p2, comp_bwdref p..p1, compound_mode, compound_type and
     * wedge_index by block size, comp_group_idx, compound_idx */
    D_COMP_REF_TYPE, D_UNI_COMP_REF, D_COMP_REF, D_COMP_BWDREF,
    D_COMPOUND_MODE, D_COMPOUND_TYPE, D_WEDGE_INDEX, D_COMP_GROUP_IDX,
    D_COMPOUND_IDX,
    /* skip_mode by the above and left blocks' skip_mode */
    D_SKIP_MODE,
    /* interintra_mode by size group, wedge_interintra by block size, and
     * seg_id_predicted by the above and left blocks' */
    D_INTERINTRA_MODE, D_WEDGE_INTERINTRA, D_SEG_ID_PREDICTED, D_NCDF
};

#include "av1_header.h"

enum {
    DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
    D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
    PAETH_PRED, UV_CFL_PRED
};
enum { NEARESTMV = 13, NEARMV = 14, GLOBALMV = 15, NEWMV = 16,
       NEAREST_NEARESTMV = 17, NEAR_NEARMV = 18, NEAREST_NEWMV = 19,
       NEW_NEARESTMV = 20, NEAR_NEWMV = 21, NEW_NEARMV = 22,
       GLOBAL_GLOBALMV = 23, NEW_NEWMV = 24 };
enum { NONE_FRAME = -1, INTRA_FRAME = 0, LAST_FRAME = 1, LAST2_FRAME = 2,
       LAST3_FRAME = 3, GOLDEN_FRAME = 4, BWDREF_FRAME = 5,
       ALTREF2_FRAME = 6, ALTREF_FRAME = 7 };
/* compound_type (spec 5.11.25) */
enum { COMPOUND_WEDGE = 0, COMPOUND_DIFFWTD = 1, COMPOUND_AVERAGE = 2,
       COMPOUND_DISTANCE = 4 };
enum { REF_CAT_LEVEL = 640 };
enum { SIMPLE = 0, OBMC = 1, LOCALWARP = 2 };
/* GmType (spec 5.9.24) */
enum { IDENTITY = 0, TRANSLATION = 1, ROTZOOM = 2, AFFINE = 3 };
/* the inter prediction tables, one int16 pack (avif._tool_tables()'s
 * "inter_tables"):
 * Subpel_Filters [6][16][8], Warped_Filters [193][8], Div_Lut [257],
 * Obmc_Mask_1..32 (the mask of length n at n - 1), the MV projection's
 * Div_Mult [32], Quant_Dist_Weight [4][2], Quant_Dist_Lookup [4][2],
 * inter-intra's Ii_Weights_1d [128] and the WedgeMasks (spec 7.11.3.11)
 * of each block size with wedges in BLOCK_SIZES order, each
 * [wedge_sign][wedge_index][h][w] */
enum { TAB_SUBPEL = 0, TAB_WARP = TAB_SUBPEL + 6 * 16 * 8,
       TAB_DIV_LUT = TAB_WARP + 193 * 8, TAB_OBMC = TAB_DIV_LUT + 257,
       TAB_DIV_MULT = TAB_OBMC + 63, TAB_QDIST_WEIGHT = TAB_DIV_MULT + 32,
       TAB_QDIST_LOOKUP = TAB_QDIST_WEIGHT + 8,
       TAB_II_WEIGHTS = TAB_QDIST_LOOKUP + 8,
       TAB_WEDGE = TAB_II_WEIGHTS + 128 };
/* interintra_mode (spec 5.11.24) */
enum { II_DC_PRED = 0, II_V_PRED = 1, II_H_PRED = 2, II_SMOOTH_PRED = 3 };
/* Wedge_Bits > 0: 8x8 to 32x32 and 8x32, 32x8 */
static int has_wedge(int bsize) { return (bsize >= 3 && bsize <= 9) || bsize == 18 || bsize == 19; }
/* spec Compound_Mode_Ctx_Map */
static const int COMPOUND_MODE_CTX[3][5] = {{0, 1, 1, 1, 1}, {1, 2, 3, 4, 4},
                                            {4, 4, 5, 6, 7}};
/* spec constants of motion field estimation (7.9) and the MV stack's
 * temporal candidates (7.10.2.5-6) */
enum { MAX_FRAME_DISTANCE = 31, REFMVS_LIMIT = (1 << 12) - 1,
       PROJ_MV_MAX = (1 << 14) - 1, MAX_OFFSET_WIDTH = 8,
       MAX_OFFSET_HEIGHT = 0, MFMV_STACK_SIZE = 3 };
/* spec constants of the local warp (7.11.3.5-8) */
enum { LS_MV_MAX = 256, WARPEDMODEL_PREC_BITS = 16, WARP_PARAM_REDUCE_BITS = 6,
       WARPEDMODEL_NONDIAGAFFINE_CLAMP = 1 << 13,
       WARPEDMODEL_TRANS_CLAMP = 1 << 23, DIV_LUT_BITS = 8,
       DIV_LUT_PREC_BITS = 14, WARPEDDIFF_PREC_BITS = 10,
       WARPEDPIXEL_PREC_SHIFTS = 1 << 6 };
enum { TX_ONLY_4X4 = 0, TX_MODE_LARGEST = 1, TX_MODE_SELECT = 2 };
enum {
    DCT_DCT = 0, ADST_DCT = 1, DCT_ADST = 2, ADST_ADST = 3, FLIPADST_DCT = 4,
    DCT_FLIPADST = 5, FLIPADST_FLIPADST = 6, ADST_FLIPADST = 7,
    FLIPADST_ADST = 8, IDTX = 9, V_DCT = 10, H_DCT = 11, V_ADST = 12,
    H_ADST = 13, V_FLIPADST = 14, H_FLIPADST = 15
};
enum { SET_DCTONLY = 0, SET_INTRA_1 = 1, SET_INTRA_2 = 2 };
enum { SET_INTER_1 = 1, SET_INTER_2 = 2, SET_INTER_3 = 3 };

/* Size_Group of each block size */
static const int SIZE_GROUP[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3,
                                   3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};
static const int MODE_TO_ANGLE[9] = {0, 90, 180, 45, 135, 113, 157, 203, 67};
static const int INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3,
                                           0, 1, 2, 0};
static const int FILTER_INTRA_TO_DIR[5] = {DC_PRED, V_PRED, H_PRED,
                                           D157_PRED, DC_PRED};
static const int MODE_TO_TXFM[14] = {
    DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
static const int TX_INTRA_INV_SET1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT,
                                         ADST_ADST, ADST_DCT, DCT_ADST};
static const int TX_INTRA_INV_SET2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT,
                                         DCT_ADST};
/* the inter sets' symbols (libaom's av1_ext_tx_inv of its ALL16,
 * DTT9_IDTX_1DDCT and DCT_IDTX sets) */
static const int TX_INTER_INV_SET1[16] = {
    IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT,
    ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
static const int TX_INTER_INV_SET2[12] = {
    IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
    DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
static const int TX_INTER_INV_SET3[2] = {IDTX, DCT_DCT};
/* BLOCK_SIZES enum by (log2 w4, log2 h4); -1 = not a block size */
static const int BSIZE_OF[6][6] = {
    {0, 1, 16, -1, -1, -1}, {2, 3, 4, 18, -1, -1}, {17, 5, 6, 7, 20, -1},
    {-1, 19, 8, 9, 10, -1}, {-1, -1, 21, 11, 12, 13}, {-1, -1, -1, -1, 14, 15},
};
static const int WIENER_MIN[3] = {-5, -23, -17};
static const int WIENER_MAX[3] = {10, 8, 46};
static const int WIENER_K[3] = {1, 2, 3};
static const int WIENER_MID[3] = {3, -7, 15};
static const int SGRPROJ_XQD_MIN[2] = {-96, -32};
static const int SGRPROJ_XQD_MAX[2] = {31, 95};
static const int SGRPROJ_XQD_MID[2] = {-32, 31};
static const int PALETTE_COLOR_CONTEXT[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
/* where each coded transform size's matrix starts in a level's 3344
 * weights (spec Qm_Offset), by (log2 w - 2, log2 h - 2); -1 = none */
static const int QM_OFFSET[4][4] = {
    {0, 1360, 2704, -1}, {1392, 16, 1424, 2832},
    {2768, 1552, 80, 1680}, {-1, 3088, 2192, 336}};
enum { QM_TOTAL = 3344, QM_FLAT = 15 };
static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int64_t clip64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline int64_t rnd2(int64_t x, int n) {
    return n ? (x + ((int64_t)1 << (n - 1))) >> n : x;
}
static inline int64_t rnd2s(int64_t x, int n) {
    return x >= 0 ? rnd2(x, n) : -rnd2(-x, n);
}
static int floor_log2(uint32_t x) { return 31 - __builtin_clz(x); }
static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) { i++; p <<= 1; }
    return i;
}

typedef struct {
    /* symbol decoder (spec 8.2.2-8.2.6) */
    const uint8_t *buf;
    size_t size, bitpos;
    uint32_t rng, val;
    int64_t max_bits;
    int no_adapt;
    /* frame */
    int mi_rows, mi_cols, nplanes, bd, sb128, sb4, lossless, tx_mode;
    int reduced_tx_set, screen_tools, filter_intra, cdef_on, cdef_bits;
    int ssx, ssy, edge_filter, width, height, allow_intrabc;
    int base_q, qdc[3], qac[3];
    /* delta q (spec 5.11.11): CurrentQIndex, the frame's DC/AC deltas
     * (y dc, u dc, u ac, v dc, v ac) and the lookups they index */
    int qidx, dq[5], delta_q_res, delta_lf_res, read_deltas;
    const int32_t *dc_lut, *ac_lut;
    /* DeltaLF[FRAME_LF_COUNT]: under delta_lf_multi one for each of y
     * vertical, y horizontal, u and v, else the first for all four */
    int delta_lf[4], delta_lf_multi;
    int8_t *mi_dlf;           /* the four DeltaLF of every mi */
    /* segmentation (spec 5.9.14): enabled, SegIdPreSkip,
     * LastActiveSegId, the ALT_Q segments and data, LosslessArray as a
     * mask, the SKIP and ALT_LF segments (the counters' only use of
     * ALT_LF here); CodedLossless; the current block's segment_id,
     * Lossless and get_qindex(1, segment_id); SegmentIds of every mi */
    int seg_enabled, seg_preskip, seg_last, seg_altq_mask, seg_altq[8];
    int seg_lossless_mask, seg_skip_mask;
    uint32_t seg_altlf_mask;
    int coded_lossless, seg_id, txq;
    uint8_t *mi_seg;
    /* an inter frame's segmentation_update_map and
     * segmentation_temporal_update, PrevSegmentIds (spec 7.21: the primary
     * reference frame's map, NULL for zeros) and the seg_id_predicted
     * contexts AboveSegPredContext and LeftSegPredContext (by mi column
     * and row, cleared per tile) */
    int seg_update_map, seg_temporal;
    const uint8_t *prev_seg;
    uint8_t *above_segpred, *left_segpred;
    /* quantizer matrices: the level of each plane (15 = flat) */
    int qm_level[3];
    const uint8_t *qm;
    int32_t *plane[3];
    int stride;
    /* tables */
    uint16_t *cdf[D_NCDF];
    const int32_t *scan[10];
    const int32_t *smw[5];
    const int32_t *dr;
    const int32_t *fi_taps;
    /* per-mi frame state */
    uint8_t *mi_wl, *mi_hl;   /* log2 of block width/height in 4x4 units */
    uint8_t *mi_skip, *mi_ymode, *mi_uvmode, *mi_txw, *mi_txh, *mi_paln;
    uint16_t *mi_pal;         /* 8 colours per mi */
    uint8_t *mi_paln_uv;      /* chroma palette size per mi */
    uint16_t *mi_pal_u;       /* its 8 U colours per mi */
    /* IsInters (an intrabc block; every block's RefFrame[0] is
     * INTRA_FRAME in a key frame) and the DV (row, col in 1/8 pel) of each
     * mi, which later blocks' DV stacks read; mi_txw/mi_txh are the
     * spec's InterTxSizes, per mi, the var-tx leaves included */
    uint8_t *mi_inter;
    int16_t *mi_mv;
    /* transform size of each 4x4 of each plane, (log2 w - 2) | (log2 h -
     * 2) << 4, rows of mi_cols (the post-filters' LoopfilterTxSizes) */
    uint8_t *txmap[3];
    /* coefficient contexts (frame-wide, reset per tile / SB row) */
    uint8_t *above_lvl[3], *above_dc[3], *left_lvl[3], *left_dc[3];
    /* tile */
    int r0, r1, c0, c1;
    uint8_t decoded[3][34][34]; /* BlockDecoded, offset by 1 */
    int8_t *cdef_idx; int cdef_stride;
    /* loop restoration */
    int lr_type[3], lr_unit[3], lr_urows[3], lr_ucols[3];
    int superres_denom; /* SuperresDenom: 8 without superres */
    int lr_rstride, lr_cstride;
    int32_t *lr_out;
    int lr_ref[3][2][3], lr_sgr_ref[3][2];
    /* an inter frame: its header fields (H_FRAME_TYPE..), the reference
     * frames' planes (after the post-filters), strides, sizes and scales
     * by reference frame 1..7, the Subpel_Filters [6][16][8], and per mi
     * RefFrames[0] (0 intra), whether the block's mode was NEWMV, its
     * filters (y | x << 2) and what deblocking reads (mi_lf: RefFrame * 2
     * + the mode delta's index, | 16 for a skipped inter block);
     * inter_frame is !FrameIsIntra (frame_type INTER_FRAME 1 or
     * SWITCH_FRAME 3: a KEY_FRAME 0 or INTRA_ONLY_FRAME 2 takes the intra
     * path) */
    int inter_frame, allow_hp, force_int_mv, interp_filter, motion_switchable;
    int use_ref_mvs, reference_select, allow_warped, dual_filter, interintra_on;
    int sign_bias, lf_delta_enabled, lf_ref_deltas[8], lf_mode_deltas[2];
    int masked_compound, jnt_comp; /* enable_masked_compound, enable_jnt_comp */
    int seg_ref_mask, seg_ref_frames, seg_gmv_mask;
    /* skip_mode_present and SkipModeFrame; each reference frame's GmType,
     * gm_params, whether the global warp may follow it (GmType past
     * TRANSLATION, globalValid, not scaled, no force_integer_mv) and its
     * shear; the current block's GlobalMvs (spec setup_global_mv, set by
     * inter_mv_stack) */
    int skip_mode_present, skip_mode_frame[2];
    int gm_type[8], gm_warp[8], gm_abgd[8][4], gmv[2][2];
    int32_t gm_params[8][6];
    const int32_t *ref_plane[8][3];
    int ref_stride[8], ref_w[8], ref_h[8];
    int xscale[8], yscale[8]; /* spec xScale, yScale of each reference */
    const int16_t *subpel, *warp_filter, *div_lut, *obmc_mask, *div_mult;
    const int16_t *qdist_weight, *qdist_lookup, *ii_weights;
    const int16_t *wedge_mask[22]; /* each size's WedgeMasks, or NULL */
    /* RefFrames[0] and [1] of each mi (-1 NONE: a single reference), the
     * second MV, and comp_group_idx and compound_idx (spec
     * CompGroupIdxs, CompoundIdxs) */
    int8_t *mi_ref, *mi_ref2;
    int16_t *mi_mv2;
    uint8_t *mi_cgi, *mi_cidx;
    /* motion field estimation (spec 7.9), per 8x8 of the frame: the MV a
     * projection left there (row, column in 1/8 sample, as its source
     * saved it) and its source's distance to that MV's reference
     * (tpl_off, 0 where no projection landed); and the distance from the
     * frame to each of its references (get_relative_dist(OrderHint,
     * OrderHints[ref]), by reference frame) */
    int16_t *tpl_mv;
    int8_t *tpl_off;
    int cur_off[8];
    uint8_t *mi_newmv, *mi_filt, *mi_lf;
    /* per mi: a GLOBALMV or GLOBAL_GLOBALMV block of 8x8 or more (whose
     * MV stack candidate is the current block's GlobalMvs where the
     * reference's GmType is past TRANSLATION), and skip_mode */
    uint8_t *mi_gmv, *mi_skip_mode;
    /* tool counters (T_*) */
    int32_t *count;
    /* where not NULL, the ns of OBMC ([0]), of the local warp ([1]), of
     * motion field estimation ([2]), of compound blends and masks ([3]), of
     * the global warp ([4]) and of inter-intra's intra predictions and
     * blends ([5]) */
    int64_t *motion_ns;
    int lf_on;         /* a luma loop filter level is not 0 */
    uint8_t *mi_bsz;   /* log2 w4 | log2 h4 << 4 of each mi's block */
    /* error */
    int err;
    char *msg; int msglen;
} Dec;

/* current block */
typedef struct {
    int r, c, wl, hl; /* mi position, log2 w4/h4 */
    int bsize;
    int skip, ymode, uvmode, angle_y, angle_uv, cfl_u, cfl_v;
    int use_fi, fi_mode, pal_n, has_chroma, avail_u, avail_l;
    int avail_uc, avail_lc; /* AvailUChroma, AvailLChroma */
    int smooth_y, smooth_uv;  /* get_filter_type for luma and chroma */
    uint16_t pal[8];
    uint8_t cmap[64 * 64];
    int pal_uv_n;
    uint16_t pal_u[8], pal_v[8];
    uint8_t cmap_uv[64 * 64];
    int txwl, txhl; /* luma tx log2 width/height in px */
    int max_luma_w, max_luma_h;
    int is_inter, mv[2]; /* use_intrabc (or an inter block) and its MV */
    int ref, mode, filt[2]; /* RefFrame[0], YMode, interp_filter (y, x) */
    /* a compound block's RefFrame[1] (NONE_FRAME otherwise) and Mv[1],
     * its compound_type, wedge_index, wedge_sign, mask_type,
     * comp_group_idx and compound_idx */
    int ref2, mv2[2], ctype, wedge_idx, wedge_sign, mask_type, cgi, cidx;
    int skip_mode;
    /* interintra, interintra_mode and wedge_interintra (the wedge in
     * wedge_idx, its sign 0) */
    int ii, ii_mode, ii_wedge;
    /* motion_mode, and find_warp_samples' NumSamples and CandList (each
     * sample's position and its position plus the neighbour's MV, row
     * then column, in 1/8 sample) */
    int motion_mode, nsamples, cand[8][4];
    uint8_t txtypes[32][32]; /* TxTypes of the block's luma 4x4s */
} Blk;

static void fail(Dec *d, int code, const char *fmt, const char *what) {
    if (d->err) return;
    d->err = code;
    snprintf(d->msg, (size_t)d->msglen, fmt, what);
}

/* ---- symbol decoder ---------------------------------------------------- */

static uint32_t read_bits_raw(Dec *d, int n) {
    if (n <= 0) return 0;
    size_t byte = d->bitpos >> 3;
    int off = (int)(d->bitpos & 7);
    uint32_t w = 0;
    for (int k = 0; k < 4; k++) {
        w <<= 8;
        if (byte + (size_t)k < d->size) w |= d->buf[byte + k];
    }
    d->bitpos += (size_t)n;
    return (w << off) >> (32 - n);
}

static void sym_init(Dec *d, const uint8_t *buf, size_t sz) {
    d->buf = buf;
    d->size = sz;
    d->bitpos = 0;
    int nb = (int)(sz * 8 < 15 ? sz * 8 : 15);
    uint32_t b = read_bits_raw(d, nb);
    uint32_t padded = b << (15 - nb);
    d->val = ((1u << 15) - 1) ^ padded;
    d->rng = 1u << 15;
    d->max_bits = (int64_t)sz * 8 - 15;
}

static int read_symbol_na(Dec *d, const uint16_t *icdf, int n) {
    uint32_t cur = d->rng, prev;
    int s = -1;
    do {
        s++;
        prev = cur;
        cur = ((d->rng >> 8) * (uint32_t)(icdf[s] >> 6) >> 1) +
              4u * (uint32_t)(n - s - 1);
    } while (d->val < cur);
    d->rng = prev - cur;
    d->val -= cur;
    int bits = 15 - floor_log2(d->rng);
    d->rng <<= bits;
    int64_t avail = d->max_bits > 0 ? d->max_bits : 0;
    int nb = bits < avail ? bits : (int)avail;
    uint32_t data = read_bits_raw(d, nb);
    uint32_t padded = data << (bits - nb);
    d->val = padded ^ (((d->val + 1) << bits) - 1);
    d->max_bits -= bits;
    return s;
}

static int read_symbol(Dec *d, uint16_t *icdf, int n) {
    int s = read_symbol_na(d, icdf, n);
    if (!d->no_adapt) update_cdf_c(icdf, n, s);
    return s;
}

static int read_bool(Dec *d) {
    static const uint16_t half[2] = {16384, 0};
    return read_symbol_na(d, half, 2);
}

static int read_literal(Dec *d, int n) {
    int x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + read_bool(d);
    return x;
}

/* ns(n) coded with bools (spec 4.10.7 over the symbol decoder) */
static int read_ns(Dec *d, int n) {
    if (n <= 1) return 0;
    int w = floor_log2((uint32_t)n) + 1;
    int m = (1 << w) - n;
    int v = read_literal(d, w - 1);
    if (v < m) return v;
    return (v << 1) - m + read_literal(d, 1);
}

/* ---- block geometry ------------------------------------------------------ */

static inline int mi_at(const Dec *d, int r, int c) {
    return r * d->mi_cols + c;
}
static inline int32_t *px(Dec *d, int plane, int y, int x) {
    return d->plane[plane] + (size_t)y * d->stride + x;
}
static int is_inside(const Dec *d, int r, int c) {
    return r >= d->r0 && r < d->r1 && c >= d->c0 && c < d->c1;
}

/* tx sizes as (log2 w px, log2 h px); split halves the larger side */
static void split_tx(int *wl, int *hl) {
    if (*wl == *hl) { (*wl)--; (*hl)--; }
    else if (*wl > *hl) (*wl)--;
    else (*hl)--;
}
static int tx_depth_to_4x4(int wl, int hl) {
    int n = 0;
    while (wl > 2 || hl > 2) { split_tx(&wl, &hl); n++; }
    return n;
}
static int tx_set(const Dec *d, int wl, int hl) {
    int sqr = imin(wl, hl), up = imax(wl, hl);
    if (up >= 5) return SET_DCTONLY;
    if (d->reduced_tx_set) return SET_INTRA_2;
    if (sqr == 4) return SET_INTRA_2;
    return SET_INTRA_1;
}
/* spec get_tx_set for an inter (intrabc) block */
static int inter_tx_set(const Dec *d, int wl, int hl) {
    int sqr = imin(wl, hl), up = imax(wl, hl);
    if (up >= 6) return SET_DCTONLY;
    if (d->reduced_tx_set || up == 5) return SET_INTER_3;
    return sqr == 4 ? SET_INTER_2 : SET_INTER_1;
}
static int tx_in_inter_set(int set, int t) {
    if (set == SET_DCTONLY) return t == DCT_DCT;
    if (set == SET_INTER_3) return t == DCT_DCT || t == IDTX;
    return set == SET_INTER_1 || t < V_ADST;
}
static int tx_in_set(int set, int t) {
    if (set == SET_DCTONLY) return t == DCT_DCT;
    if (t == DCT_DCT || t == ADST_DCT || t == DCT_ADST || t == ADST_ADST ||
        t == IDTX)
        return 1;
    return set == SET_INTRA_1 && (t == V_DCT || t == H_DCT);
}
/* the block's size in a plane, in log2 4x4 units (spec
 * get_plane_residual_size) */
static void plane_block(const Dec *d, const Blk *b, int plane, int *wl4,
                        int *hl4) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    *wl4 = imax(0, b->wl - sx);
    *hl4 = imax(0, b->hl - sy);
}
/* chroma tx size (spec get_tx_size): the largest that fits the plane's
 * block, 64 capped at 32 */
static void uv_tx(const Dec *d, const Blk *b, int *wl, int *hl) {
    int wl4, hl4;
    plane_block(d, b, 1, &wl4, &hl4);
    int w = imin(wl4 + 2, 6), h = imin(hl4 + 2, 6);
    if (w == 6 || h == 6) {
        if (w == 4) { *wl = 4; *hl = 5; return; }
        if (h == 4) { *wl = 5; *hl = 4; return; }
        *wl = 5; *hl = 5;
        return;
    }
    *wl = w;
    *hl = h;
}

/* the default scan of a coded size (log2 px, at most 32): the square and
 * 2:1 ones from the tables, the 4:1 ones by the diagonal rule those
 * follow (up-right for wide, down-left for tall) */
static int32_t SCAN41[4][512];
static int scan41_ready;
static void make_diag_scan(int32_t *out, int w, int h) {
    int n = 0;
    for (int k = 0; k < w + h - 1; k++) {
        if (w < h) {
            for (int r = 0; r < h; r++)
                if (k - r >= 0 && k - r < w) out[n++] = r * w + (k - r);
        } else {
            for (int r = h - 1; r >= 0; r--)
                if (k - r >= 0 && k - r < w) out[n++] = r * w + (k - r);
        }
    }
}
static const int32_t *scan_for(const Dec *d, int cwl, int chl) {
    if (cwl == chl) return d->scan[cwl - 2];
    static const int RECT[6][2] = {{2, 3}, {3, 2}, {3, 4}, {4, 3}, {4, 5}, {5, 4}};
    for (int i = 0; i < 6; i++)
        if (RECT[i][0] == cwl && RECT[i][1] == chl) return d->scan[4 + i];
    static const int R41[4][2] = {{2, 4}, {4, 2}, {3, 5}, {5, 3}};
    if (!__atomic_load_n(&scan41_ready, __ATOMIC_ACQUIRE)) {
        static int32_t tmp[4][512];
        for (int i = 0; i < 4; i++)
            make_diag_scan(tmp[i], 1 << R41[i][0], 1 << R41[i][1]);
        /* every thread writes the same values */
        memcpy(SCAN41, tmp, sizeof(SCAN41));
        __atomic_store_n(&scan41_ready, 1, __ATOMIC_RELEASE);
    }
    for (int i = 0; i < 4; i++)
        if (R41[i][0] == cwl && R41[i][1] == chl) return SCAN41[i];
    return NULL;
}

/* ---- intra prediction (spec 7.11.2) -------------------------------------- */

static const int INTRA_EDGE_KERNEL[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

static int edge_strength(int w, int h, int smooth, int delta) {
    int d = abs(delta), wh = w + h, s = 0;
    if (!smooth) {
        if (wh <= 8) { if (d >= 56) s = 1; }
        else if (wh <= 12) { if (d >= 40) s = 1; }
        else if (wh <= 16) { if (d >= 40) s = 1; }
        else if (wh <= 24) {
            if (d >= 8) s = 1;
            if (d >= 16) s = 2;
            if (d >= 32) s = 3;
        } else if (wh <= 32) {
            if (d >= 1) s = 1;
            if (d >= 4) s = 2;
            if (d >= 32) s = 3;
        } else {
            if (d >= 1) s = 3;
        }
    } else {
        if (wh <= 8) {
            if (d >= 40) s = 1;
            if (d >= 64) s = 2;
        } else if (wh <= 16) {
            if (d >= 20) s = 1;
            if (d >= 48) s = 2;
        } else if (wh <= 24) {
            if (d >= 4) s = 3;
        } else {
            if (d >= 1) s = 3;
        }
    }
    return s;
}

static int edge_upsample(int w, int h, int smooth, int delta) {
    int d = abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return smooth ? wh <= 8 : wh <= 16;
}

/* filter buf[-1 .. sz-2] in place (spec intra_edge_filter) */
static void edge_filter(int32_t *buf, int sz, int strength) {
    if (!strength) return;
    int32_t edge[129 + 32];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int k = imin(imax(i - 2 + j, 0), sz - 1);
            s += INTRA_EDGE_KERNEL[strength - 1][j] * edge[k];
        }
        buf[i - 1] = (s + 8) >> 4;
    }
}

static void edge_upsample_run(int32_t *buf, int n, int bd) {
    int32_t dup[64 + 3];
    dup[0] = buf[-1];
    for (int i = -1; i < n; i++) dup[i + 2] = buf[i];
    dup[n + 2] = buf[n - 1];
    buf[-2] = dup[0];
    int maxv = (1 << bd) - 1;
    for (int i = 0; i < n; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        s = (int)clip64(rnd2s(s, 4), 0, maxv);
        buf[2 * i - 1] = s;
        buf[2 * i] = dup[i + 2];
    }
}

static void predict_intra(Dec *d, const Blk *b, int plane, int x, int y,
                          int have_left, int have_above, int have_ar,
                          int have_bl, int mode, int wl, int hl,
                          int angle_delta) {
    int w = 1 << wl, h = 1 << hl;
    int bd = d->bd;
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    int maxx = ((d->mi_cols * 4) >> sx) - 1, maxy = ((d->mi_rows * 4) >> sy) - 1;
    int32_t above_buf[288], left_buf[288];
    int32_t *above = above_buf + 16, *left = left_buf + 16;
    int n = w + h;
    if (!have_above && have_left) {
        int32_t v = *px(d, plane, y, x - 1);
        for (int i = 0; i < n; i++) above[i] = v;
    } else if (!have_above) {
        for (int i = 0; i < n; i++) above[i] = (1 << (bd - 1)) - 1;
    } else {
        int lim = imin(maxx, x + (have_ar ? 2 * w : w) - 1);
        const int32_t *row = px(d, plane, y - 1, 0);
        for (int i = 0; i < n; i++) above[i] = row[imin(lim, x + i)];
    }
    if (!have_left && have_above) {
        int32_t v = *px(d, plane, y - 1, x);
        for (int i = 0; i < n; i++) left[i] = v;
    } else if (!have_left) {
        for (int i = 0; i < n; i++) left[i] = (1 << (bd - 1)) + 1;
    } else {
        int lim = imin(maxy, y + (have_bl ? 2 * h : h) - 1);
        for (int i = 0; i < n; i++) left[i] = *px(d, plane, imin(lim, y + i), x - 1);
    }
    if (have_above && have_left) above[-1] = *px(d, plane, y - 1, x - 1);
    else if (have_above) above[-1] = *px(d, plane, y - 1, x);
    else if (have_left) above[-1] = *px(d, plane, y, x - 1);
    else above[-1] = 1 << (bd - 1);
    left[-1] = above[-1];
    int maxv = (1 << bd) - 1;

    if (plane == 0 && b->use_fi) {
        const int32_t *taps = d->fi_taps + (size_t)b->fi_mode * 64;
        int64_t buf[33 * 33];
        int W = w + 1;
        buf[0] = above[-1];
        for (int c = 0; c < w; c++) buf[1 + c] = above[c];
        for (int r = 0; r < h; r++) buf[(size_t)(r + 1) * W] = left[r];
        for (int r = 1; r <= h; r += 2)
            for (int c = 1; c <= w; c += 4) {
                const int64_t p[7] = {
                    buf[(size_t)(r - 1) * W + c - 1], buf[(size_t)(r - 1) * W + c],
                    buf[(size_t)(r - 1) * W + c + 1], buf[(size_t)(r - 1) * W + c + 2],
                    buf[(size_t)(r - 1) * W + c + 3], buf[(size_t)r * W + c - 1],
                    buf[(size_t)(r + 1) * W + c - 1]};
                for (int k = 0; k < 8; k++) {
                    int64_t v = 0;
                    for (int j = 0; j < 7; j++) v += (int64_t)taps[k * 8 + j] * p[j];
                    buf[(size_t)(r + (k >> 2)) * W + c + (k & 3)] =
                        clip64(rnd2s(v, 4), 0, maxv);
                }
            }
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++)
                *px(d, plane, y + r, x + c) = (int32_t)buf[(size_t)(r + 1) * W + c + 1];
        return;
    }
    if (mode == DC_PRED) {
        int64_t avg;
        if (have_above && have_left) {
            int64_t s = 0;
            for (int i = 0; i < w; i++) s += above[i];
            for (int i = 0; i < h; i++) s += left[i];
            avg = (s + ((w + h) >> 1)) / (w + h);
        } else if (have_left) {
            int64_t s = 0;
            for (int i = 0; i < h; i++) s += left[i];
            avg = (s + (h >> 1)) >> hl;
        } else if (have_above) {
            int64_t s = 0;
            for (int i = 0; i < w; i++) s += above[i];
            avg = (s + (w >> 1)) >> wl;
        } else {
            avg = 1 << (bd - 1);
        }
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) *px(d, plane, y + r, x + c) = (int32_t)avg;
        return;
    }
    if (mode == PAETH_PRED) {
        int32_t tl = above[-1];
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int32_t base = above[c] + left[r] - tl;
                int32_t pl = abs(base - left[r]), pt = abs(base - above[c]);
                int32_t ptl = abs(base - tl);
                *px(d, plane, y + r, x + c) =
                    (pl <= pt && pl <= ptl) ? left[r] : (pt <= ptl ? above[c] : tl);
            }
        return;
    }
    if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
        const int32_t *wy = d->smw[hl - 2], *wx = d->smw[wl - 2];
        int64_t below = left[h - 1], right = above[w - 1];
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t v;
                if (mode == SMOOTH_PRED)
                    v = rnd2(wy[r] * (int64_t)above[c] + (256 - wy[r]) * below +
                             wx[c] * (int64_t)left[r] + (256 - wx[c]) * right, 9);
                else if (mode == SMOOTH_V_PRED)
                    v = rnd2(wy[r] * (int64_t)above[c] + (256 - wy[r]) * below, 8);
                else
                    v = rnd2(wx[c] * (int64_t)left[r] + (256 - wx[c]) * right, 8);
                *px(d, plane, y + r, x + c) = (int32_t)v;
            }
        return;
    }
    /* directional (spec 7.11.2.4), with the edge filter and upsampling */
    int p_angle = MODE_TO_ANGLE[mode] + angle_delta * 3;
    int up_above = 0, up_left = 0;
    if (d->edge_filter) {
        int smooth = plane ? b->smooth_uv : b->smooth_y;
        if (p_angle != 90 && p_angle != 180) {
            if (p_angle > 90 && p_angle < 180 && w + h >= 24) {
                int32_t s = (int32_t)rnd2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                left[-1] = above[-1] = s;
            }
            if (have_above) {
                int st = edge_strength(w, h, smooth, p_angle - 90);
                int np = imin(w, maxx - x + 1) + (p_angle < 90 ? h : 0) + 1;
                edge_filter(above, np, st);
                if (st) d->count[T_EDGE_FILTER]++;
            }
            if (have_left) {
                int st = edge_strength(w, h, smooth, p_angle - 180);
                int np = imin(h, maxy - y + 1) + (p_angle > 180 ? w : 0) + 1;
                edge_filter(left, np, st);
                if (st) d->count[T_EDGE_FILTER]++;
            }
        }
        up_above = edge_upsample(w, h, smooth, p_angle - 90);
        if (up_above) edge_upsample_run(above, w + (p_angle < 90 ? h : 0), bd);
        up_left = edge_upsample(w, h, smooth, p_angle - 180);
        if (up_left) edge_upsample_run(left, h + (p_angle > 180 ? w : 0), bd);
        if (up_above || up_left) d->count[T_EDGE_UPSAMPLE]++;
    }
    int dx = 0, dy = 0;
    if (p_angle < 90) dx = d->dr[p_angle];
    else if (p_angle > 90 && p_angle < 180) { dx = d->dr[180 - p_angle]; dy = d->dr[p_angle - 90]; }
    else if (p_angle > 180) dy = d->dr[270 - p_angle];
    int ua = up_above, ul = up_left;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int64_t v;
            if (p_angle < 90) {
                int idx = (i + 1) * dx;
                int base = (idx >> (6 - ua)) + (j << ua);
                int shift = ((idx << ua) >> 1) & 0x1F;
                int max_base = (w + h - 1) << ua;
                if (base < max_base)
                    v = rnd2(above[base] * (int64_t)(32 - shift) + above[base + 1] * (int64_t)shift, 5);
                else
                    v = above[max_base];
            } else if (p_angle > 90 && p_angle < 180) {
                int idx = (j << 6) - (i + 1) * dx;
                int base = idx >> (6 - ua);
                if (base >= -(1 << ua)) {
                    int shift = ((idx << ua) >> 1) & 0x1F;
                    v = rnd2(above[base] * (int64_t)(32 - shift) + above[base + 1] * (int64_t)shift, 5);
                } else {
                    idx = (i << 6) - (j + 1) * dy;
                    base = idx >> (6 - ul);
                    int shift = ((idx << ul) >> 1) & 0x1F;
                    v = rnd2(left[base] * (int64_t)(32 - shift) + left[base + 1] * (int64_t)shift, 5);
                }
            } else if (p_angle > 180) {
                int idx = (j + 1) * dy;
                int base = (idx >> (6 - ul)) + (i << ul);
                int shift = ((idx << ul) >> 1) & 0x1F;
                int max_base = (w + h - 1) << ul;
                if (base < max_base)
                    v = rnd2(left[base] * (int64_t)(32 - shift) + left[base + 1] * (int64_t)shift, 5);
                else
                    v = left[max_base];
            } else if (p_angle == 90) {
                v = above[j];
            } else {
                v = left[i];
            }
            *px(d, plane, y + i, x + j) = (int32_t)v;
        }
}

/* CFL (spec 7.11.5): the luma average over the subsampled luma, the luma
 * replicated past MaxLumaW/H */
static void predict_cfl(Dec *d, const Blk *b, int plane, int x, int y,
                        int wl, int hl) {
    int w = 1 << wl, h = 1 << hl;
    int sx = d->ssx, sy = d->ssy;
    int alpha = plane == 1 ? b->cfl_u : b->cfl_v;
    static _Thread_local int32_t L[32 * 32];
    int64_t avg = 0;
    for (int i = 0; i < h; i++) {
        int ly = imin((y + i) << sy, b->max_luma_h - (1 << sy));
        for (int j = 0; j < w; j++) {
            int lx = imin((x + j) << sx, b->max_luma_w - (1 << sx));
            int32_t t = 0;
            for (int dy = 0; dy <= sy; dy++)
                for (int dx = 0; dx <= sx; dx++) t += *px(d, 0, ly + dy, lx + dx);
            int32_t v = t << (3 - sx - sy);
            L[i * w + j] = v;
            avg += v;
        }
    }
    avg = rnd2(avg, wl + hl);
    int maxv = (1 << d->bd) - 1;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int32_t *p = px(d, plane, y + i, x + j);
            int64_t s = rnd2s((int64_t)alpha * (L[i * w + j] - avg), 6);
            *p = (int32_t)clip64(*p + s, 0, maxv);
        }
}

/* ---- inverse transform and reconstruction (spec 7.12.3, 7.13.3) ---------- */

static void inverse_wht(int64_t *t, int shift) {
    int64_t a = t[0] >> shift, c = t[1] >> shift, dd = t[2] >> shift,
            b = t[3] >> shift;
    a += c;
    dd -= b;
    int64_t e = (a - dd) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    dd += c;
    t[0] = a; t[1] = b; t[2] = c; t[3] = dd;
}

static void reconstruct(Dec *d, int plane, int x, int y, int wl, int hl,
                        int txtype, const int32_t *quant) {
    int tw = 1 << wl, th = 1 << hl;
    int cw = imin(tw, 32), ch = imin(th, 32);
    int bd = d->bd;
    int pels = tw * th;
    int dq_denom = (pels > 256) + (pels > 1024);
    int64_t dmax = ((int64_t)1 << (7 + bd)) - 1, dmin = -((int64_t)1 << (7 + bd));
    static _Thread_local int64_t res[64 * 64];
    memset(res, 0, sizeof(int64_t) * (size_t)pels);
    /* the quantizer matrix weighs 2-D transforms only; the 1-D and
     * identity ones take the flat level (spec 7.12.3) */
    const uint8_t *qm = NULL;
    int lvl = d->qm_level[plane];
    if (lvl < QM_FLAT && txtype < IDTX && !d->lossless) {
        int off = QM_OFFSET[imin(wl, 5) - 2][imin(hl, 5) - 2];
        qm = d->qm + ((size_t)lvl * 2 + (plane > 0)) * QM_TOTAL + off;
        d->count[T_QM]++;
    }
    for (int i = 0; i < ch; i++)
        for (int j = 0; j < cw; j++) {
            int32_t q = quant[i * cw + j];
            if (!q) continue;
            int64_t qs = (i == 0 && j == 0) ? d->qdc[plane] : d->qac[plane];
            if (qm) qs = (qm[i * cw + j] * qs + 16) >> 5;
            int64_t mag = ((int64_t)(q < 0 ? -q : q) * qs) & 0xFFFFFF;
            mag >>= dq_denom;
            res[i * tw + j] = clip64(q < 0 ? -mag : mag, dmin, dmax);
        }
    int64_t t[64], o[64];
    if (d->lossless) {
        for (int i = 0; i < 4; i++) {
            for (int j = 0; j < 4; j++) t[j] = res[i * 4 + j];
            inverse_wht(t, 2);
            for (int j = 0; j < 4; j++) res[i * 4 + j] = t[j];
        }
        for (int j = 0; j < 4; j++) {
            for (int i = 0; i < 4; i++) t[i] = res[i * 4 + j];
            inverse_wht(t, 0);
            for (int i = 0; i < 4; i++) res[i * 4 + j] = t[i];
        }
    } else {
        /* the 1-D kinds (0 DCT, 1 ADST, 2 identity) of the columns and
         * rows; a FLIPADST is the ADST with its output reversed, up-down
         * for the columns, left-right for the rows (libaom's
         * get_flip_cfg) */
        int col_kind, row_kind, ud = 0, lr = 0;
        switch (txtype) {
            case ADST_DCT: col_kind = 1; row_kind = 0; break;
            case DCT_ADST: col_kind = 0; row_kind = 1; break;
            case ADST_ADST: col_kind = 1; row_kind = 1; break;
            case FLIPADST_DCT: col_kind = 1; row_kind = 0; ud = 1; break;
            case DCT_FLIPADST: col_kind = 0; row_kind = 1; lr = 1; break;
            case FLIPADST_FLIPADST: col_kind = 1; row_kind = 1; ud = lr = 1; break;
            case ADST_FLIPADST: col_kind = 1; row_kind = 1; lr = 1; break;
            case FLIPADST_ADST: col_kind = 1; row_kind = 1; ud = 1; break;
            case IDTX: col_kind = 2; row_kind = 2; break;
            case V_DCT: col_kind = 0; row_kind = 2; break;
            case H_DCT: col_kind = 2; row_kind = 0; break;
            case V_ADST: col_kind = 1; row_kind = 2; break;
            case H_ADST: col_kind = 2; row_kind = 1; break;
            case V_FLIPADST: col_kind = 1; row_kind = 2; ud = 1; break;
            case H_FLIPADST: col_kind = 2; row_kind = 1; lr = 1; break;
            default: col_kind = 0; row_kind = 0; break;
        }
        if (ud || lr) d->count[T_TX_FLIP]++;
        static const int ROW_SHIFT[5][5] = {
            /* [log2w-2][log2h-2] (spec Transform_Row_Shift) */
            {0, 0, 1, -1, -1}, {0, 1, 1, 2, -1}, {1, 1, 2, 1, 2},
            {-1, 2, 1, 2, 1}, {-1, -1, 2, 1, 2}};
        int row_shift = ROW_SHIFT[wl - 2][hl - 2];
        int rect2 = abs(wl - hl) == 1;
        int64_t rmax = ((int64_t)1 << (bd + 7)) - 1, rmin = -((int64_t)1 << (bd + 7));
        int ccr = imax(bd + 6, 16);
        int64_t cmax = ((int64_t)1 << (ccr - 1)) - 1, cmin = -((int64_t)1 << (ccr - 1));
        for (int i = 0; i < th; i++) {
            if (i >= 32) {
                for (int j = 0; j < tw; j++) res[i * tw + j] = 0;
                continue;
            }
            int any = 0;
            for (int j = 0; j < tw; j++) {
                int64_t v = res[i * tw + j];
                if (rect2) v = rnd2(v * 2896, 12);
                t[j] = clip64(v, rmin, rmax);
                any |= t[j] != 0;
            }
            if (!any) continue;
            inv_1d_kind_pub(t, o, tw, row_kind);
            for (int j = 0; j < tw; j++)
                res[i * tw + (lr ? tw - 1 - j : j)] =
                    clip64(rnd2(o[j], row_shift), cmin, cmax);
        }
        for (int j = 0; j < tw; j++) {
            for (int i = 0; i < th; i++) t[i] = res[i * tw + j];
            inv_1d_kind_pub(t, o, th, col_kind);
            for (int i = 0; i < th; i++)
                res[(ud ? th - 1 - i : i) * tw + j] = rnd2(o[i], 4);
        }
    }
    int maxv = (1 << bd) - 1;
    for (int i = 0; i < th; i++)
        for (int j = 0; j < tw; j++) {
            int32_t *p = px(d, plane, y + i, x + j);
            *p = (int32_t)clip64(*p + res[i * tw + j], 0, maxv);
        }
}

/* ---- coefficients (spec 5.11.39) ----------------------------------------- */

enum { TXC_2D = 0, TXC_HORIZ = 1, TXC_VERT = 2 };

static int read_coeffs(Dec *d, const Blk *b, int plane, int x, int y,
                       int wl, int hl, int *txtype_io, int32_t *quant) {
    int x4 = x >> 2, y4 = y >> 2;
    int w4 = 1 << (wl - 2), h4 = 1 << (hl - 2);
    int sqr = imin(wl, hl) - 2, up = imax(wl, hl) - 2;
    int txs_ctx = (sqr + up + 1) >> 1;
    int ptype = plane > 0;
    int cwl = imin(wl, 5), chl = imin(hl, 5);
    int cw = 1 << cwl, ch = 1 << chl;
    int n = cw * ch;
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    int max_x4 = d->mi_cols >> sx, max_y4 = d->mi_rows >> sy;
    uint8_t *al = d->above_lvl[plane], *ad = d->above_dc[plane];
    uint8_t *ll = d->left_lvl[plane], *ld = d->left_dc[plane];

    /* all_zero context */
    int ctx;
    int pwl4, phl4;
    plane_block(d, b, plane, &pwl4, &phl4);
    int bw = 4 << pwl4, bh = 4 << phl4;
    if (plane == 0) {
        int top = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < max_x4) top = imax(top, al[x4 + k]);
        for (int k = 0; k < h4; k++)
            if (y4 + k < max_y4) left = imax(left, ll[y4 + k]);
        if (bw == (1 << wl) && bh == (1 << hl)) ctx = 0;
        else if (top == 0 && left == 0) ctx = 1;
        else if (top == 0 || left == 0) ctx = 2 + (imax(top, left) > 3);
        else if (imax(top, left) <= 3) ctx = 4;
        else if (imin(top, left) <= 3) ctx = 5;
        else ctx = 6;
    } else {
        int above = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < max_x4) above |= al[x4 + k] | ad[x4 + k];
        for (int k = 0; k < h4; k++)
            if (y4 + k < max_y4) left |= ll[y4 + k] | ld[y4 + k];
        ctx = (above != 0) + (left != 0) + 7;
        if (bw * bh > (1 << wl) * (1 << hl)) ctx += 3;
    }
    int all_zero = read_symbol(d, d->cdf[D_TXB_SKIP] + ((size_t)txs_ctx * 13 + ctx) * 3, 2);
    int eob = 0, cul = 0, dc_cat = 0;
    if (!all_zero) {
        int txtype;
        if (plane == 0 && b->is_inter) {
            /* spec transform_type with the inter sets, their CDFs by the
             * square size */
            int set = inter_tx_set(d, wl, hl);
            txtype = DCT_DCT;
            if (set != SET_DCTONLY && d->txq > 0) {
                if (set == SET_INTER_1)
                    txtype = TX_INTER_INV_SET1[read_symbol(
                        d, d->cdf[D_INTER_TX1] + (size_t)sqr * 17, 16)];
                else if (set == SET_INTER_2)
                    txtype = TX_INTER_INV_SET2[read_symbol(
                        d, d->cdf[D_INTER_TX2] + (size_t)sqr * 13, 12)];
                else
                    txtype = TX_INTER_INV_SET3[read_symbol(
                        d, d->cdf[D_INTER_TX3] + (size_t)sqr * 3, 2)];
                d->count[T_TX_INTER_SET1 + set - SET_INTER_1]++;
            }
            *txtype_io = txtype;
        } else if (plane == 0) {
            int set = tx_set(d, wl, hl);
            txtype = DCT_DCT;
            if (set != SET_DCTONLY && d->txq > 0) {
                int dir = b->use_fi ? FILTER_INTRA_TO_DIR[b->fi_mode] : b->ymode;
                if (set == SET_INTRA_1)
                    txtype = TX_INTRA_INV_SET1[read_symbol(
                        d, d->cdf[D_TX1] + ((size_t)sqr * 13 + dir) * 8, 7)];
                else
                    txtype = TX_INTRA_INV_SET2[read_symbol(
                        d, d->cdf[D_TX2] + ((size_t)sqr * 13 + dir) * 6, 5)];
            }
            *txtype_io = txtype;
        } else {
            txtype = *txtype_io;
        }
        int txc = (txtype == V_DCT || txtype == V_ADST || txtype == V_FLIPADST)
                      ? TXC_VERT
                      : (txtype == H_DCT || txtype == H_ADST || txtype == H_FLIPADST)
                      ? TXC_HORIZ : TXC_2D;
        if (txtype == V_DCT) d->count[T_TX_V_DCT]++;
        if (txtype == H_DCT) d->count[T_TX_H_DCT]++;
        /* spec get_scan: mrow (raster) for V_*, mcol for H_* */
        static _Thread_local int32_t scan1d[32 * 32];
        const int32_t *scan;
        if (txc == TXC_VERT) {
            for (int i = 0; i < n; i++) scan1d[i] = i;
            scan = scan1d;
        } else if (txc == TXC_HORIZ) {
            for (int i = 0; i < n; i++) scan1d[i] = (i % ch) * cw + i / ch;
            scan = scan1d;
        } else {
            scan = scan_for(d, cwl, chl);
        }
        if (!scan) {
            fail(d, AV1D_CORRUPT, "AV1: %s", "bad transform size");
            return 0;
        }
        int m = cwl + chl - 4;
        static const int EOB_CDF[7] = {D_EOB16, D_EOB32, D_EOB64, D_EOB128,
                                       D_EOB256, D_EOB512, D_EOB1024};
        int eob_nsym = 5 + m;
        int eob_pt = 1 + read_symbol(
            d, d->cdf[EOB_CDF[m]] + ((size_t)ptype * 2 + (txc != TXC_2D)) * (eob_nsym + 1),
            eob_nsym);
        eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
        int eob_shift = eob_pt - 3;
        if (eob_shift >= 0) {
            if (read_symbol(d, d->cdf[D_EOB_EXTRA] +
                                   (((size_t)txs_ctx * 2 + ptype) * 9 + eob_pt - 3) * 3, 2))
                eob += 1 << eob_shift;
            for (int i = 1; i < imax(1, eob_pt - 2); i++) {
                eob_shift = eob_pt - 2 - 1 - i;
                if (read_literal(d, 1)) eob += 1 << eob_shift;
            }
        }
        int stride = cw + 4;
        static _Thread_local uint8_t pad[(32 + 4) * (32 + 5)];
        memset(pad, 0, (size_t)stride * (ch + 5));
        memset(quant, 0, sizeof(int32_t) * (size_t)n);
        uint16_t *base_eob = d->cdf[D_BASE_EOB] + ((size_t)txs_ctx * 2 + ptype) * 4 * 4;
        uint16_t *base = d->cdf[D_BASE] + ((size_t)txs_ctx * 2 + ptype) * 42 * 5;
        uint16_t *br = d->cdf[D_BR] + ((size_t)imin(txs_ctx, 3) * 2 + ptype) * 21 * 5;
        /* the context offsets follow the shape of the transform, not of
         * its coded 32x32 part (spec Coeff_Base_Ctx_Offset[txSz]) */
        int square = wl == hl, wide = wl > hl;
        for (int si = eob - 1; si >= 0; si--) {
            int pos = scan[si];
            int rr = pos >> cwl, cc = pos & (cw - 1);
            int level;
            const uint8_t *p = pad + rr * stride + cc;
            if (si == eob - 1) {
                int c2 = si == 0 ? 0 : (si <= n / 8 ? 1 : (si <= n / 4 ? 2 : 3));
                level = 1 + read_symbol(d, base_eob + (size_t)c2 * 4, 3);
            } else {
                int mag, bctx;
                if (txc == TXC_2D) {
                    mag = imin(p[1], 3) + imin(p[stride], 3) + imin(p[stride + 1], 3) +
                          imin(p[2], 3) + imin(p[2 * stride], 3);
                    mag = imin((mag + 1) >> 1, 4);
                    if (pos == 0) bctx = 0;
                    else if (square) bctx = mag + (rr + cc < 2 ? 1 : (rr + cc < 4 ? 6 : 21));
                    else if (wide && cc < 2) bctx = mag + 16;
                    else if (!wide && rr < 2) bctx = mag + 11;
                    else bctx = mag + (rr + cc < 4 ? 6 : 21);
                } else {
                    int s2 = txc == TXC_HORIZ ? 1 : stride;
                    mag = imin(p[1], 3) + imin(p[stride], 3) + imin(p[2 * s2], 3) +
                          imin(p[3 * s2], 3) + imin(p[4 * s2], 3);
                    mag = imin((mag + 1) >> 1, 4);
                    int idx = txc == TXC_VERT ? rr : cc;
                    bctx = mag + 26 + 5 * imin(idx, 2);
                }
                level = read_symbol(d, base + (size_t)bctx * 5, 4);
            }
            if (level > 2) {
                int third = txc == TXC_2D ? p[stride + 1]
                          : (txc == TXC_HORIZ ? p[2] : p[2 * stride]);
                int mag = imin(p[1], 15) + imin(p[stride], 15) + imin(third, 15);
                mag = imin((mag + 1) >> 1, 6);
                int near;
                if (txc == TXC_2D) near = rr < 2 && cc < 2;
                else if (txc == TXC_HORIZ) near = cc == 0;
                else near = rr == 0;
                int brctx = pos == 0 ? mag : (near ? mag + 7 : mag + 14);
                for (int k = 0; k < 4; k++) {
                    int s = read_symbol(d, br + (size_t)brctx * 5, 4);
                    level += s;
                    if (s < 3) break;
                }
            }
            pad[rr * stride + cc] = (uint8_t)level;
            quant[pos] = level;
        }
        /* dc sign context */
        int dcs = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < max_x4) dcs += (ad[x4 + k] == 2) - (ad[x4 + k] == 1);
        for (int k = 0; k < h4; k++)
            if (y4 + k < max_y4) dcs += (ld[y4 + k] == 2) - (ld[y4 + k] == 1);
        int sctx = dcs < 0 ? 1 : (dcs > 0 ? 2 : 0);
        for (int si = 0; si < eob; si++) {
            int pos = scan[si];
            int32_t lv = quant[pos];
            if (!lv) continue;
            int sign = si == 0
                ? read_symbol(d, d->cdf[D_DC_SIGN] + ((size_t)ptype * 3 + sctx) * 3, 2)
                : read_literal(d, 1);
            if (lv > 14) {
                int length = 0, bit;
                do {
                    length++;
                    bit = read_literal(d, 1);
                    if (length > 32) {
                        fail(d, AV1D_CORRUPT, "AV1: %s", "Golomb code too long");
                        return 0;
                    }
                } while (!bit);
                uint32_t xg = 1;
                for (int i = length - 2; i >= 0; i--) xg = (xg << 1) | (uint32_t)read_literal(d, 1);
                lv = (int32_t)(xg + 14);
            }
            if (pos == 0) dc_cat = sign ? 1 : 2;
            lv &= 0xFFFFF;
            cul += lv;
            quant[pos] = sign ? -lv : lv;
        }
        cul = imin(63, cul);
    }
    for (int k = 0; k < w4; k++) { al[x4 + k] = (uint8_t)cul; ad[x4 + k] = (uint8_t)dc_cat; }
    for (int k = 0; k < h4; k++) { ll[y4 + k] = (uint8_t)cul; ld[y4 + k] = (uint8_t)dc_cat; }
    return eob;
}

/* ---- transform blocks and the residual (spec 5.11.34-36) ----------------- */

static void transform_block(Dec *d, Blk *b, int plane, int base_x, int base_y,
                            int wl, int hl, int x, int y) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sbmask = d->sb4 - 1;
    int sub_r = (row & sbmask) >> sy, sub_c = (col & sbmask) >> sx;
    int step_x = 1 << (wl - 2), step_y = 1 << (hl - 2);
    if (start_x >= (d->mi_cols * 4) >> sx || start_y >= (d->mi_rows * 4) >> sy) return;
    uint8_t (*dec)[34] = d->decoded[plane];
    if (b->is_inter) {
        /* predicted with the whole block (predict_intrabc) */
    } else if (plane == 0 && b->pal_n) {
        for (int i = 0; i < (1 << hl); i++)
            for (int j = 0; j < (1 << wl); j++)
                *px(d, 0, start_y + i, start_x + j) =
                    b->pal[b->cmap[(y * 4 + i) * 64 + x * 4 + j]];
    } else if (plane && b->pal_uv_n) {
        const uint16_t *pal = plane == 1 ? b->pal_u : b->pal_v;
        for (int i = 0; i < (1 << hl); i++)
            for (int j = 0; j < (1 << wl); j++)
                *px(d, plane, start_y + i, start_x + j) =
                    pal[b->cmap_uv[(y * 4 + i) * 64 + x * 4 + j]];
    } else {
        int is_cfl = plane > 0 && b->uvmode == UV_CFL_PRED;
        int mode = plane == 0 ? b->ymode : (is_cfl ? DC_PRED : b->uvmode);
        int have_ar = dec[sub_r - 1 + 1][sub_c + step_x + 1];
        int have_bl = dec[sub_r + step_y + 1][sub_c - 1 + 1];
        predict_intra(d, b, plane, start_x, start_y,
                      (plane == 0 ? b->avail_l : b->avail_lc) || x > 0,
                      (plane == 0 ? b->avail_u : b->avail_uc) || y > 0,
                      have_ar, have_bl, mode, wl, hl,
                      plane == 0 ? b->angle_y : b->angle_uv);
        if (is_cfl) {
            predict_cfl(d, b, plane, start_x, start_y, wl, hl);
            if (sx || sy) d->count[T_CFL_SUBSAMPLED]++;
        }
    }
    if (plane == 0) {
        b->max_luma_w = start_x + step_x * 4;
        b->max_luma_h = start_y + step_y * 4;
    }
    if (!b->skip) {
        static _Thread_local int32_t quant[32 * 32];
        int txtype;
        if (plane == 0) {
            txtype = DCT_DCT;
        } else if (b->is_inter) {
            /* spec compute_tx_type for inter chroma: the co-located luma
             * transform's type where the chroma set has it */
            txtype = DCT_DCT;
            if (!d->lossless && imax(wl, hl) <= 5) {
                int lx = imax(b->c, (start_x >> 2) << sx);
                int ly = imax(b->r, (start_y >> 2) << sy);
                txtype = b->txtypes[ly - b->r][lx - b->c];
                if (!tx_in_inter_set(inter_tx_set(d, wl, hl), txtype)) txtype = DCT_DCT;
            }
        } else {
            /* spec compute_tx_type for intra chroma */
            int set = tx_set(d, wl, hl);
            txtype = MODE_TO_TXFM[b->uvmode];
            if (d->lossless || imax(wl, hl) > 5 || !tx_in_set(set, txtype))
                txtype = DCT_DCT;
        }
        int eob = read_coeffs(d, b, plane, start_x, start_y, wl, hl, &txtype, quant);
        if (d->err) return;
        if (plane == 0 && (d->lossless || imax(wl, hl) > 5)) txtype = DCT_DCT;
        if (plane == 0 && b->is_inter) {
            /* TxTypes: DCT_DCT where the transform had no coefficients */
            int t = eob > 0 ? txtype : DCT_DCT;
            for (int i = 0; i < step_y; i++)
                memset(&b->txtypes[(start_y >> 2) - b->r + i][(start_x >> 2) - b->c],
                       t, (size_t)step_x);
        }
        if (eob > 0) reconstruct(d, plane, start_x, start_y, wl, hl, txtype, quant);
    }
    if (abs(wl - hl) == 2) d->count[T_TX_4TO1]++;
    if (imax(wl, hl) == 6) d->count[T_TX_64]++;
    uint8_t packed = (uint8_t)((wl - 2) | ((hl - 2) << 4));
    int pr = start_y >> 2, pc = start_x >> 2;
    int prows = d->mi_rows >> sy, pcols = d->mi_cols >> sx;
    for (int i = 0; i < step_y; i++)
        for (int j = 0; j < step_x; j++) {
            if (sub_r + i <= 32 && sub_c + j <= 32) dec[sub_r + i + 1][sub_c + j + 1] = 1;
            if (pr + i < prows && pc + j < pcols)
                d->txmap[plane][(size_t)(pr + i) * d->mi_cols + pc + j] = packed;
        }
}

/* spec transform_tree: the luma of an inter block over its var-tx leaves
 * (InterTxSizes) */
static void transform_tree(Dec *d, Blk *b, int x, int y, int wl, int hl) {
    if (x >= d->mi_cols * 4 || y >= d->mi_rows * 4 || d->err) return;
    int m = mi_at(d, y >> 2, x >> 2);
    if (wl <= d->mi_txw[m] + 2 && hl <= d->mi_txh[m] + 2) {
        transform_block(d, b, 0, x, y, wl, hl, 0, 0);
        return;
    }
    if (wl > hl) {
        transform_tree(d, b, x, y, wl - 1, hl);
        transform_tree(d, b, x + (1 << (wl - 1)), y, wl - 1, hl);
    } else if (wl < hl) {
        transform_tree(d, b, x, y, wl, hl - 1);
        transform_tree(d, b, x, y + (1 << (hl - 1)), wl, hl - 1);
    } else {
        for (int k = 0; k < 4; k++)
            transform_tree(d, b, x + ((k & 1) << (wl - 1)),
                           y + ((k >> 1) << (hl - 1)), wl - 1, hl - 1);
    }
}

static void residual(Dec *d, Blk *b) {
    int bw4 = 1 << b->wl, bh4 = 1 << b->hl;
    int wchunks = imax(1, bw4 >> 4), hchunks = imax(1, bh4 >> 4);
    int nplanes = b->has_chroma ? d->nplanes : 1;
    for (int cy = 0; cy < hchunks; cy++)
        for (int cx = 0; cx < wchunks; cx++)
            for (int plane = 0; plane < nplanes; plane++) {
                if (plane == 0 && b->is_inter && !d->lossless) {
                    /* one tree per 64x64 chunk, as libaom walks them */
                    transform_tree(d, b, b->c * 4 + (cx << 6), b->r * 4 + (cy << 6),
                                   imin(b->wl + 2, 6), imin(b->hl + 2, 6));
                    if (d->err) return;
                    continue;
                }
                int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
                int wl, hl;
                if (d->lossless) { wl = 2; hl = 2; }
                else if (plane == 0) { wl = b->txwl; hl = b->txhl; }
                else uv_tx(d, b, &wl, &hl);
                int stepx = 1 << (wl - 2), stepy = 1 << (hl - 2);
                int pwl4, phl4;
                plane_block(d, b, plane, &pwl4, &phl4);
                int n4w = 1 << pwl4, n4h = 1 << phl4;
                int base_x = (b->c >> sx) * 4, base_y = (b->r >> sy) * 4;
                for (int y = 0; y < imin(n4h, 16 >> sy); y += stepy)
                    for (int x = 0; x < imin(n4w, 16 >> sx); x += stepx) {
                        transform_block(d, b, plane, base_x, base_y, wl, hl,
                                        x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
                        if (d->err) return;
                    }
            }
}

/* ---- mode info (spec 5.11.7-5.11.27, 5.11.46-50) ------------------------- */

/* spec get_palette_cache: the above (within the 64-row band) and left
 * neighbours' colours of the plane (Y, or U for the chroma palette),
 * merged ascending without repeats */
static int palette_cache(Dec *d, const Blk *b, int plane, uint16_t *cache) {
    const uint8_t *sizes = plane ? d->mi_paln_uv : d->mi_paln;
    const uint16_t *colours = plane ? d->mi_pal_u : d->mi_pal;
    int an = 0, ln = 0;
    const uint16_t *ac = NULL, *lc = NULL;
    if (((b->r * 4) % 64) && b->avail_u) {
        int m = mi_at(d, b->r - 1, b->c);
        an = sizes[m];
        ac = colours + (size_t)m * 8;
    }
    if (b->avail_l) {
        int m = mi_at(d, b->r, b->c - 1);
        ln = sizes[m];
        lc = colours + (size_t)m * 8;
    }
    int ai = 0, li = 0, n = 0;
    while (ai < an && li < ln) {
        uint16_t a = ac[ai], l = lc[li];
        if (l < a) {
            if (n == 0 || l != cache[n - 1]) cache[n++] = l;
            li++;
        } else {
            if (n == 0 || a != cache[n - 1]) cache[n++] = a;
            ai++;
            if (l == a) li++;
        }
    }
    for (; ai < an; ai++)
        if (n == 0 || ac[ai] != cache[n - 1]) cache[n++] = ac[ai];
    for (; li < ln; li++)
        if (n == 0 || lc[li] != cache[n - 1]) cache[n++] = lc[li];
    return n;
}

static void sort_colours(uint16_t *c, int n) {
    for (int i = 1; i < n; i++) /* ascending */
        for (int j = i; j > 0 && c[j - 1] > c[j]; j--) {
            uint16_t t = c[j]; c[j] = c[j - 1]; c[j - 1] = t;
        }
}

static void palette_mode_info(Dec *d, Blk *b) {
    int bctx = b->wl + b->hl - 2;
    if (b->ymode == DC_PRED) {
        int ctx = 0;
        if (b->avail_u && d->mi_paln[mi_at(d, b->r - 1, b->c)]) ctx++;
        if (b->avail_l && d->mi_paln[mi_at(d, b->r, b->c - 1)]) ctx++;
        if (read_symbol(d, d->cdf[D_PAL_Y_MODE] + ((size_t)bctx * 3 + ctx) * 3, 2)) {
            int n = 2 + read_symbol(d, d->cdf[D_PAL_Y_SIZE] + (size_t)bctx * 8, 7);
            uint16_t cache[16];
            int cn = palette_cache(d, b, 0, cache);
            int idx = 0;
            for (int i = 0; i < cn && idx < n; i++)
                if (read_literal(d, 1)) b->pal[idx++] = cache[i];
            int maxv = (1 << d->bd) - 1;
            if (idx < n) b->pal[idx++] = (uint16_t)read_literal(d, d->bd);
            int bits = 0;
            if (idx < n) bits = d->bd - 3 + read_literal(d, 2);
            while (idx < n) {
                int delta = read_literal(d, bits) + 1;
                b->pal[idx] = (uint16_t)imin(b->pal[idx - 1] + delta, maxv);
                int range = (1 << d->bd) - b->pal[idx] - 1;
                bits = imin(bits, ceil_log2(range));
                idx++;
            }
            sort_colours(b->pal, n);
            b->pal_n = n;
        }
    }
    if (b->has_chroma && b->uvmode == DC_PRED &&
        read_symbol(d, d->cdf[D_PAL_UV_MODE] + (size_t)(b->pal_n > 0) * 3, 2)) {
        /* palette_colors_u: cache, one literal, then deltas whose width
         * shrinks with the range left (no +1, unlike luma); palette_colors_v
         * by wrapping signed deltas or literals */
        int n = 2 + read_symbol(d, d->cdf[D_PAL_UV_SIZE] + (size_t)bctx * 8, 7);
        int bd = d->bd, maxv = (1 << bd) - 1;
        uint16_t cache[16];
        int cn = palette_cache(d, b, 1, cache);
        int idx = 0;
        for (int i = 0; i < cn && idx < n; i++)
            if (read_literal(d, 1)) b->pal_u[idx++] = cache[i];
        if (idx < n) b->pal_u[idx++] = (uint16_t)read_literal(d, bd);
        int bits = 0;
        if (idx < n) bits = bd - 3 + read_literal(d, 2);
        while (idx < n) {
            int delta = read_literal(d, bits);
            b->pal_u[idx] = (uint16_t)imin(b->pal_u[idx - 1] + delta, maxv);
            bits = imin(bits, ceil_log2((1 << bd) - b->pal_u[idx]));
            idx++;
        }
        sort_colours(b->pal_u, n);
        if (read_literal(d, 1)) {
            int vbits = bd - 4 + read_literal(d, 2);
            b->pal_v[0] = (uint16_t)read_literal(d, bd);
            for (int i = 1; i < n; i++) {
                int delta = read_literal(d, vbits);
                if (delta && read_literal(d, 1)) delta = -delta;
                int v = b->pal_v[i - 1] + delta;
                if (v < 0) v += maxv + 1;
                if (v > maxv) v -= maxv + 1;
                b->pal_v[i] = (uint16_t)imin(imax(v, 0), maxv);
            }
        } else {
            for (int i = 0; i < n; i++) b->pal_v[i] = (uint16_t)read_literal(d, bd);
        }
        b->pal_uv_n = n;
        d->count[T_UV_PALETTE]++;
    }
}

/* one colour-index map (spec palette_tokens) of bw x bh, onw x onh of it
 * on screen, the rest replicated */
static void colour_map(Dec *d, uint8_t *m, int n, uint16_t *cdf, int bw, int bh,
                       int onw, int onh) {
    m[0] = (uint8_t)read_ns(d, n);
    for (int i = 1; i < onh + onw - 1; i++)
        for (int j = imin(i, onw - 1); j >= imax(0, i - onh + 1); j--) {
            int r = i - j, c = j;
            int scores[8] = {0}, order[8];
            for (int k = 0; k < 8; k++) order[k] = k;
            if (c > 0) scores[m[r * 64 + c - 1]] += 2;
            if (r > 0 && c > 0) scores[m[(r - 1) * 64 + c - 1]] += 1;
            if (r > 0) scores[m[(r - 1) * 64 + c]] += 2;
            for (int k = 0; k < 3; k++) {
                int ms = scores[k], mi = k;
                for (int l = k + 1; l < n; l++)
                    if (scores[l] > ms) { ms = scores[l]; mi = l; }
                if (mi != k) {
                    int mo = order[mi];
                    for (int l = mi; l > k; l--) { scores[l] = scores[l - 1]; order[l] = order[l - 1]; }
                    scores[k] = ms;
                    order[k] = mo;
                }
            }
            int hash = scores[0] + 2 * scores[1] + 2 * scores[2];
            int ctx = hash < 9 ? PALETTE_COLOR_CONTEXT[hash] : -1;
            if (ctx < 0) { fail(d, AV1D_CORRUPT, "AV1: %s", "bad palette context"); return; }
            int s = read_symbol(d, cdf + (size_t)ctx * (n + 1), n);
            m[r * 64 + c] = (uint8_t)order[s];
        }
    for (int i = 0; i < onh; i++)
        for (int j = onw; j < bw; j++) m[i * 64 + j] = m[i * 64 + onw - 1];
    for (int i = onh; i < bh; i++)
        for (int j = 0; j < bw; j++) m[i * 64 + j] = m[(onh - 1) * 64 + j];
}

static void palette_tokens(Dec *d, Blk *b) {
    int bw = 4 << b->wl, bh = 4 << b->hl;
    int onh = imin(bh, (d->mi_rows - b->r) * 4);
    int onw = imin(bw, (d->mi_cols - b->c) * 4);
    if (b->pal_n)
        colour_map(d, b->cmap, b->pal_n, d->cdf[D_PAL_Y_CI2 + b->pal_n - 2], bw, bh,
                   onw, onh);
    if (b->pal_uv_n && !d->err) {
        int sx = d->ssx, sy = d->ssy;
        bw >>= sx; bh >>= sy; onw >>= sx; onh >>= sy;
        if (bw < 4) { bw += 2; onw += 2; }
        if (bh < 4) { bh += 2; onh += 2; }
        colour_map(d, b->cmap_uv, b->pal_uv_n,
                   d->cdf[D_PAL_UV_CI2 + b->pal_uv_n - 2], bw, bh, onw, onh);
    }
}

static void read_cdef(Dec *d, Blk *b) {
    if (b->skip || d->coded_lossless || !d->cdef_on) return;
    int r = b->r & ~15, c = b->c & ~15;
    int8_t *ci = d->cdef_idx + (size_t)(r >> 4) * d->cdef_stride + (c >> 4);
    if (*ci == -1) {
        int v = read_literal(d, d->cdef_bits);
        if (d->cdef_bits) d->count[T_CDEF_IDX_READ]++;
        int w4 = 1 << b->wl, h4 = 1 << b->hl;
        for (int y = r; y < r + h4; y += 16)
            for (int x = c; x < c + w4; x += 16)
                if ((y >> 4) < (d->mi_rows + 15) / 16 && (x >> 4) < d->cdef_stride)
                    d->cdef_idx[(size_t)(y >> 4) * d->cdef_stride + (x >> 4)] = (int8_t)v;
    }
}

/* spec get_above_tx_width / get_left_tx_height at mi (row, col) of the
 * current block: a skipped inter neighbour gives its block's size */
static int above_tx_w(Dec *d, const Blk *b, int row, int col) {
    if (row == b->r) {
        if (!b->avail_u) return 64;
        int m = mi_at(d, row - 1, col);
        if (d->mi_skip[m] && d->mi_inter[m]) return 4 << d->mi_wl[m];
    }
    return 4 << d->mi_txw[mi_at(d, row - 1, col)];
}
static int left_tx_h(Dec *d, const Blk *b, int row, int col) {
    if (col == b->c) {
        if (!b->avail_l) return 64;
        int m = mi_at(d, row, col - 1);
        if (d->mi_skip[m] && d->mi_inter[m]) return 4 << d->mi_hl[m];
    }
    return 4 << d->mi_txh[mi_at(d, row, col - 1)];
}

/* spec read_tx_size: the depth's context takes an inter neighbour's block
 * size, another's transform size at the exact position */
static void tx_size(Dec *d, Blk *b, int allow_select) {
    if (d->lossless) { b->txwl = 2; b->txhl = 2; return; }
    int wl = imin(b->wl + 2, 6), hl = imin(b->hl + 2, 6);
    if (b->bsize > 0 && allow_select && d->tx_mode == TX_MODE_SELECT) {
        int max_depth = tx_depth_to_4x4(wl, hl);
        int cat = imin(max_depth, 4) - 1;
        int nsym = cat ? 3 : 2;
        int maxw = 1 << wl, maxh = 1 << hl;
        int aw = 0, lh = 0;
        if (b->avail_u) {
            int m = mi_at(d, b->r - 1, b->c);
            aw = d->mi_inter[m] ? 4 << d->mi_wl[m] : above_tx_w(d, b, b->r, b->c);
        }
        if (b->avail_l) {
            int m = mi_at(d, b->r, b->c - 1);
            lh = d->mi_inter[m] ? 4 << d->mi_hl[m] : left_tx_h(d, b, b->r, b->c);
        }
        int ctx = (aw >= maxw) + (lh >= maxh);
        int depth = read_symbol(d, d->cdf[D_TX_SIZE] + ((size_t)cat * 3 + ctx) * 4, nsym);
        for (int i = 0; i < depth; i++) split_tx(&wl, &hl);
        if (depth == 1) d->count[T_TX_DEPTH1]++;
        if (depth == 2) d->count[T_TX_DEPTH2]++;
    }
    b->txwl = wl;
    b->txhl = hl;
}

static void set_inter_tx(Dec *d, int row, int col, int h4, int w4, int wl, int hl) {
    for (int i = 0; i < h4 && row + i < d->mi_rows; i++)
        for (int j = 0; j < w4 && col + j < d->mi_cols; j++) {
            int m = mi_at(d, row + i, col + j);
            d->mi_txw[m] = (uint8_t)(wl - 2);
            d->mi_txh[m] = (uint8_t)(hl - 2);
        }
}

/* spec read_var_tx_size: txfm_split down to depth 2 (MAX_VARTX_DEPTH),
 * its context libaom's txfm_partition_context */
static void var_tx_size(Dec *d, Blk *b, int row, int col, int wl, int hl, int depth) {
    if (row >= d->mi_rows || col >= d->mi_cols || d->err) return;
    int split = 0;
    if ((wl > 2 || hl > 2) && depth < 2) {
        int max_sz = imin(6, imax(b->wl, b->hl) + 2) - 2; /* TX_4X4 .. TX_64X64 */
        int up = imax(wl, hl) - 2;
        int above = above_tx_w(d, b, row, col) < (1 << wl);
        int left = left_tx_h(d, b, row, col) < (1 << hl);
        int cat = (up != max_sz && max_sz > 1) + (4 - max_sz) * 2;
        split = read_symbol(d, d->cdf[D_TXFM_SPLIT] + ((size_t)cat * 3 + above + left) * 3, 2);
    }
    if (!split) {
        set_inter_tx(d, row, col, 1 << (hl - 2), 1 << (wl - 2), wl, hl);
        return;
    }
    d->count[T_VARTX_SPLIT]++;
    int swl = wl, shl = hl;
    split_tx(&swl, &shl);
    for (int i = 0; i < 1 << (hl - 2); i += 1 << (shl - 2))
        for (int j = 0; j < 1 << (wl - 2); j += 1 << (swl - 2))
            var_tx_size(d, b, row + i, col + j, swl, shl, depth + 1);
}

/* spec read_block_tx_size: the var-tx tree for a coded inter block under
 * TX_MODE_SELECT, else one size, written to InterTxSizes */
static void block_tx_size(Dec *d, Blk *b) {
    int bw4 = 1 << b->wl, bh4 = 1 << b->hl;
    if (d->tx_mode == TX_MODE_SELECT && b->bsize > 0 && b->is_inter && !b->skip &&
        !d->lossless) {
        int wl = imin(b->wl + 2, 6), hl = imin(b->hl + 2, 6);
        for (int r = b->r; r < b->r + bh4; r += 1 << (hl - 2))
            for (int c = b->c; c < b->c + bw4; c += 1 << (wl - 2))
                var_tx_size(d, b, r, c, wl, hl, 0);
        return;
    }
    tx_size(d, b, !b->skip || !b->is_inter);
    set_inter_tx(d, b->r, b->c, bh4, bw4, b->txwl, b->txhl);
}

static int is_smooth_mode(int m) {
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
}

/* spec get_filter_type: is an above or left neighbour SMOOTH*? (their UV
 * modes for chroma, at the block that carries the neighbouring chroma) */
static void filter_types(Dec *d, Blk *b) {
    b->smooth_y = (b->avail_u && is_smooth_mode(d->mi_ymode[mi_at(d, b->r - 1, b->c)])) ||
                  (b->avail_l && is_smooth_mode(d->mi_ymode[mi_at(d, b->r, b->c - 1)]));
    b->smooth_uv = 0;
    if (!b->has_chroma) return;
    if (b->avail_uc) {
        int r = b->r - 1, c = b->c;
        if (d->ssx && !(b->c & 1)) c++;
        if (d->ssy && (b->r & 1)) r--;
        b->smooth_uv |= is_smooth_mode(d->mi_uvmode[mi_at(d, r, c)]);
    }
    if (b->avail_lc) {
        int r = b->r, c = b->c - 1;
        if (d->ssx && (b->c & 1)) c--;
        if (d->ssy && !(b->r & 1)) r++;
        b->smooth_uv |= is_smooth_mode(d->mi_uvmode[mi_at(d, r, c)]);
    }
}

/* CurrentQIndex and the dequantizers of each plane at it */
/* the dequantizers of qindex ``qidx`` (spec 7.12.2 dc_q and ac_q) */
static void set_dequant(Dec *d, int qidx) {
    for (int p = 0; p < 3; p++) {
        int dc = p ? d->dq[2 * p - 1] : d->dq[0], ac = p ? d->dq[2 * p] : 0;
        d->qdc[p] = d->dc_lut[imin(imax(qidx + dc, 0), 255)];
        d->qac[p] = d->ac_lut[imin(imax(qidx + ac, 0), 255)];
    }
}

/* CurrentQIndex, and the dequantizers that follow it */
static void set_qidx(Dec *d, int qidx) {
    d->qidx = qidx;
    set_dequant(d, qidx);
}

/* spec get_qindex: a segment's ALT_Q moves base_q_idx, or CurrentQIndex
 * under delta q where ``ignore_dq`` is 0 */
static int get_qindex(const Dec *d, int ignore_dq, int seg) {
    int q = !ignore_dq && d->delta_q_res >= 0 ? d->qidx : d->base_q;
    if (d->seg_altq_mask >> seg & 1) return imin(imax(q + d->seg_altq[seg], 0), 255);
    return q;
}

/* spec neg_deinterleave */
static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
        if (diff <= 2 * ref) return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
        return diff;
    }
    if (diff <= 2 * (max - ref - 1))
        return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
}

/* spec intra_segment_id / read_segment_id: the id predicted from the
 * above-left, above and left ids (a skipped block takes it), else coded
 * against it in the context of how many of the three agree */
static int read_segment_id(Dec *d, const Blk *b, int skip) {
    int ul = -1, u = -1, l = -1;
    if (b->avail_u && b->avail_l) ul = d->mi_seg[mi_at(d, b->r - 1, b->c - 1)];
    if (b->avail_u) u = d->mi_seg[mi_at(d, b->r - 1, b->c)];
    if (b->avail_l) l = d->mi_seg[mi_at(d, b->r, b->c - 1)];
    int pred = u == -1 ? (l == -1 ? 0 : l) : l == -1 ? u : ul == u ? u : l;
    if (skip) {
        d->count[T_SEG_PRED_SKIP]++;
        return pred;
    }
    int ctx = ul < 0 ? 0 : (ul == u && ul == l) ? 2 : (ul == u || ul == l || u == l) ? 1 : 0;
    int v = read_symbol(d, d->cdf[D_SEGMENT_ID] + (size_t)ctx * 9, 8);
    d->count[T_SEGMENTATION]++;
    return imin(imax(neg_deinterleave(v, pred, d->seg_last + 1), 0), d->seg_last);
}

/* a delta_q_abs / delta_lf_abs value: the symbol, or past DELTA_*_SMALL
 * (3) a 3-bit length and that many bits, then a sign (spec 5.11.11-12) */
static int read_delta(Dec *d, uint16_t *cdf) {
    int a = read_symbol(d, cdf, 4);
    if (a == 3) {
        int n = read_literal(d, 3) + 1;
        a = read_literal(d, n) + (1 << n) + 1;
    }
    return a && read_literal(d, 1) ? -a : a;
}

/* read_delta_qindex and read_delta_lf, once per superblock: CurrentQIndex
 * and DeltaLF move by the deltas, and the block's dequantizers follow.
 * Under delta_lf_multi FRAME_LF_COUNT values follow (2 in a monochrome
 * frame), each with its own CDF (DeltaLFMulti[i], adapting apart). */
static void read_deltas(Dec *d, Blk *b) {
    int sb = d->sb128 ? 5 : 4;
    if (!d->read_deltas || (b->wl == sb && b->hl == sb && b->skip)) return;
    int dq = read_delta(d, d->cdf[D_DELTA_Q]);
    if (dq) {
        set_qidx(d, imin(imax(d->qidx + dq * (1 << d->delta_q_res), 1), 255));
        d->count[T_DELTA_Q]++;
    }
    if (d->delta_lf_res < 0) return;
    int n = d->delta_lf_multi ? (d->nplanes > 1 ? 4 : 2) : 1;
    for (int i = 0; i < n; i++) {
        int dl = read_delta(d, d->delta_lf_multi ? d->cdf[D_DELTA_LF_MULTI] + 5 * i
                                                 : d->cdf[D_DELTA_LF]);
        if (dl) {
            d->delta_lf[i] = imin(imax(d->delta_lf[i] + dl * (1 << d->delta_lf_res), -63), 63);
            d->count[T_DELTA_LF]++;
            if (d->delta_lf_multi) d->count[T_DELTA_LF_MULTI]++;
        }
    }
}

/* ---- MV stacks and intra block copy (spec 5.11.26, 5.11.32, 7.10.2) ---- */

/* a stack entry: the MV of RefFrame[0] and, for a compound block, of
 * RefFrame[1] (row, column in 1/8 sample), and its weight */
typedef struct { int mv[2], mv2[2], weight; } MvCand;

/* spec sorting: a stable bubble sort by weight, descending */
static void sort_mv_stack(MvCand *st, int start, int end) {
    while (end > start) {
        int last = start;
        for (int k = start + 1; k < end; k++)
            if (st[k - 1].weight < st[k].weight) {
                MvCand t = st[k - 1];
                st[k - 1] = st[k];
                st[k] = t;
                last = k;
            }
        end = last;
    }
}

/* spec lower_mv_precision */
static void lower_mv(const Dec *d, int *mv) {
    if (d->allow_hp) return;
    for (int i = 0; i < 2; i++) {
        if (d->force_int_mv) {
            int a = (abs(mv[i]) + 3) >> 3;
            mv[i] = mv[i] > 0 ? a << 3 : -(a << 3);
        } else if (mv[i] & 1) {
            mv[i] += mv[i] > 0 ? -1 : 1;
        }
    }
}

/* spec setup_global_mv: the GlobalMv of reference frame ref for the
 * block b (0 for INTRA_FRAME and IDENTITY); TRANSLATION's row from
 * gm_params[0] and column from gm_params[1], as the spec (and libaom and
 * dav1d with it) reads them; ROTZOOM and AFFINE the model at the block's
 * centre, rounded to the frame's precision; then lower_mv_precision */
static void global_mv(const Dec *d, const Blk *b, int ref, int *mv) {
    mv[0] = mv[1] = 0;
    int typ = ref > INTRA_FRAME ? d->gm_type[ref] : IDENTITY;
    const int32_t *p = d->gm_params[imax(ref, 0)];
    if (typ == TRANSLATION) {
        mv[0] = p[0] >> (WARPEDMODEL_PREC_BITS - 3);
        mv[1] = p[1] >> (WARPEDMODEL_PREC_BITS - 3);
    } else if (typ > TRANSLATION) {
        int x = b->c * 4 + (2 << b->wl) - 1, y = b->r * 4 + (2 << b->hl) - 1;
        const int64_t one = 1 << WARPEDMODEL_PREC_BITS;
        int64_t xc = (p[2] - one) * x + (int64_t)p[3] * y + p[0];
        int64_t yc = (int64_t)p[4] * x + (p[5] - one) * y + p[1];
        int n = WARPEDMODEL_PREC_BITS - 3 + !d->allow_hp;
        mv[0] = (int)rnd2s(yc, n) * (1 + !d->allow_hp);
        mv[1] = (int)rnd2s(xc, n) * (1 + !d->allow_hp);
    }
    lower_mv(d, mv);
}

/* the MV of list 0 or 1 of mi m */
static void mi_mv_of(const Dec *d, int m, int list, int *mv) {
    const int16_t *p = list ? d->mi_mv2 : d->mi_mv;
    mv[0] = p[2 * m];
    mv[1] = p[2 * m + 1];
}

/* the stack's entry equal to mv (and mv2 for a pair), or -1 */
static int stack_find(const MvCand *st, int n, const int *mv, const int *mv2) {
    for (int k = 0; k < n; k++)
        if (st[k].mv[0] == mv[0] && st[k].mv[1] == mv[1] &&
            (!mv2 || (st[k].mv2[0] == mv2[0] && st[k].mv2[1] == mv2[1])))
            return k;
    return -1;
}

/* mv (and mv2) joins the stack with weight, or adds weight to its equal */
static void stack_add(MvCand *st, int *n, const int *mv, const int *mv2, int weight) {
    int k = stack_find(st, *n, mv, mv2);
    if (k >= 0) {
        st[k].weight += weight;
        return;
    }
    if (*n < 8) {
        MvCand *e = st + (*n)++;
        e->mv[0] = mv[0];
        e->mv[1] = mv[1];
        e->mv2[0] = mv2 ? mv2[0] : 0;
        e->mv2[1] = mv2 ? mv2[1] : 0;
        e->weight = weight;
    }
}

/* add_spatial_candidate (dav1d's refmvs.c, spec add_ref_mv_candidate): a
 * neighbour joins the stack or adds its weight where, for a single
 * reference ref (ref2 NONE_FRAME), either of its references is ref (with
 * that list's MV), or for a pair both of its references are the pair; it
 * counts as a match, and as a NEWMV match where its mode had a NEWMV side.
 * A GLOBALMV or GLOBAL_GLOBALMV neighbour of 8x8 or more offers, for a
 * reference whose GmType is past TRANSLATION, the block's own GlobalMv
 * instead of its MV (spec 7.10.2.7, 7.10.2.9) */
static void add_spatial(Dec *d, MvCand *st, int *n, int r, int c, int ref, int ref2,
                        int weight, int *newmv_match, int *ref_match) {
    int m = mi_at(d, r, c);
    if (!d->mi_inter[m]) return;
    int mv[2], mv2[2];
    if (ref2 <= INTRA_FRAME) {
        int list;
        if (d->mi_ref[m] == ref) list = 0;
        else if (d->mi_ref2[m] == ref) list = 1;
        else return;
        mi_mv_of(d, m, list, mv);
        if (d->mi_gmv[m] && d->gm_type[ref] > TRANSLATION) memcpy(mv, d->gmv[0], sizeof(mv));
    } else {
        if (d->mi_ref[m] != ref || d->mi_ref2[m] != ref2) return;
        mi_mv_of(d, m, 0, mv);
        mi_mv_of(d, m, 1, mv2);
        if (d->mi_gmv[m] && d->gm_type[ref] > TRANSLATION) memcpy(mv, d->gmv[0], sizeof(mv));
        if (d->mi_gmv[m] && d->gm_type[ref2] > TRANSLATION) memcpy(mv2, d->gmv[1], sizeof(mv2));
        lower_mv(d, mv2);
    }
    *ref_match = 1;
    *newmv_match |= d->mi_newmv[m];
    lower_mv(d, mv);
    stack_add(st, n, mv, ref2 > INTRA_FRAME ? mv2 : NULL, weight);
}

/* one row of neighbours from (row, col), bw4 wide, w4 of it scanned, as
 * dav1d's scan_row: a neighbour at least as wide as the block counts for
 * the rows it spans (up to max_rows pairs); returns the pairs of rows
 * covered (mv_scan_col likewise down a column) */
static int mv_scan_row(Dec *d, MvCand *st, int *n, int ref, int ref2, int row, int col,
                       int bw4, int w4, int max_rows, int step, int *nm, int *rm) {
    int m = mi_at(d, row, col);
    int cw = 1 << d->mi_wl[m];
    int len = imax(step, imin(bw4, cw));
    if (bw4 <= cw) {
        int weight = bw4 == 1 ? 2 : imax(2, imin(2 * max_rows, 1 << d->mi_hl[m]));
        add_spatial(d, st, n, row, col, ref, ref2, len * weight, nm, rm);
        return weight >> 1;
    }
    for (int x = 0;;) {
        add_spatial(d, st, n, row, col + x, ref, ref2, len * 2, nm, rm);
        x += len;
        if (x >= w4 || col + x >= d->c1) return 1;
        len = imax(step, 1 << d->mi_wl[mi_at(d, row, col + x)]);
    }
}

static int mv_scan_col(Dec *d, MvCand *st, int *n, int ref, int ref2, int row, int col,
                       int bh4, int h4, int max_cols, int step, int *nm, int *cm) {
    int m = mi_at(d, row, col);
    int ch = 1 << d->mi_hl[m];
    int len = imax(step, imin(bh4, ch));
    if (bh4 <= ch) {
        int weight = bh4 == 1 ? 2 : imax(2, imin(2 * max_cols, 1 << d->mi_wl[m]));
        add_spatial(d, st, n, row, col, ref, ref2, len * weight, nm, cm);
        return weight >> 1;
    }
    for (int y = 0;;) {
        add_spatial(d, st, n, row + y, col, ref, ref2, len * 2, nm, cm);
        y += len;
        if (y >= h4 || row + y >= d->r1) return 1;
        len = imax(step, 1 << d->mi_hl[mi_at(d, row + y, col)]);
    }
}

static int sign_differs(const Dec *d, int a, int b) {
    return (d->sign_bias >> a & 1) != (d->sign_bias >> b & 1);
}

/* spec add_extra_mv_candidate for a single reference: each reference's MV
 * of a neighbour, negated where its sign bias differs, joins the stack
 * unless it is there */
static void add_extended(Dec *d, MvCand *st, int *n, int m, int ref) {
    if (!d->mi_inter[m]) return;
    for (int list = 0; list < 2; list++) {
        int cref = list ? d->mi_ref2[m] : d->mi_ref[m];
        if (cref <= INTRA_FRAME) return;
        int mv[2];
        mi_mv_of(d, m, list, mv);
        if (sign_differs(d, cref, ref)) {
            mv[0] = -mv[0];
            mv[1] = -mv[1];
        }
        if (stack_find(st, *n, mv, NULL) < 0) stack_add(st, n, mv, NULL, 2);
    }
}

/* spec add_extra_mv_candidate for a pair (dav1d's
 * add_compound_extended_candidate): each reference's MV of a neighbour
 * goes to RefIdMvs of the list whose reference it is, and to RefDiffMvs
 * of the other list (of both, where it is neither), negated where the
 * sign biases differ; two of each at most */
static void add_extended_pair(const Dec *d, int m, const int *refs, int id[2][2][2],
                              int *nid, int diff[2][2][2], int *ndiff) {
    for (int list = 0; list < 2; list++) {
        int cref = list ? d->mi_ref2[m] : d->mi_ref[m];
        if (cref <= INTRA_FRAME) return;
        int mv[2];
        mi_mv_of(d, m, list, mv);
        for (int l = 0; l < 2; l++) {
            if (cref == refs[l]) {
                if (nid[l] < 2) {
                    id[l][nid[l]][0] = mv[0];
                    id[l][nid[l]][1] = mv[1];
                    nid[l]++;
                }
            } else if (ndiff[l] < 2) {
                int s = sign_differs(d, cref, refs[l]) ? -1 : 1;
                diff[l][ndiff[l]][0] = s * mv[0];
                diff[l][ndiff[l]][1] = s * mv[1];
                ndiff[l]++;
            }
        }
    }
}

/* spec get_mv_projection (7.9.3): mv scaled by num / den through
 * Div_Mult, both distances clamped to MAX_FRAME_DISTANCE, rounded half
 * away from zero and clamped to PROJ_MV_MAX */
static void mv_projection(const Dec *d, const int16_t *mv, int num, int den, int *out) {
    den = imin(den, MAX_FRAME_DISTANCE);
    num = num > 0 ? imin(num, MAX_FRAME_DISTANCE) : imax(num, -MAX_FRAME_DISTANCE);
    for (int i = 0; i < 2; i++)
        out[i] = (int)clip64(rnd2s((int64_t)mv[i] * num * d->div_mult[den], 14), -PROJ_MV_MAX,
                             PROJ_MV_MAX);
}

/* spec add_tpl_ref_mv (libaom add_tpl_ref_mv, dav1d
 * add_temporal_candidate): the projected MV of the 8x8 at (r | 1, c | 1),
 * where that lies in the tile and a projection landed there, scaled to the
 * block's reference (to both, for a pair), at its precision, joins the
 * stack with weight 2 or adds 2 to an equal entry's; at the block's own
 * position it sets ZeroMvContext (zero_ctx, where given; a pair reads
 * none) by its distance from the block's GlobalMv */
static void add_temporal(Dec *d, MvCand *st, int *n, int r, int c, int ref, int ref2,
                         int *zero_ctx) {
    r |= 1;
    c |= 1;
    if (!is_inside(d, r, c)) return;
    size_t i = (size_t)(r >> 1) * (size_t)(d->mi_cols >> 1) + (size_t)(c >> 1);
    if (!d->tpl_off[i]) return;
    int mv[2], mv2[2];
    mv_projection(d, d->tpl_mv + 2 * i, d->cur_off[ref], d->tpl_off[i], mv);
    lower_mv(d, mv);
    if (ref2 > INTRA_FRAME) {
        mv_projection(d, d->tpl_mv + 2 * i, d->cur_off[ref2], d->tpl_off[i], mv2);
        lower_mv(d, mv2);
    }
    if (zero_ctx) *zero_ctx = abs(mv[0] - d->gmv[0][0]) >= 16 || abs(mv[1] - d->gmv[0][1]) >= 16;
    d->count[T_TEMPORAL_MV]++;
    stack_add(st, n, mv, ref2 > INTRA_FRAME ? mv2 : NULL, 2);
}

/* spec temporal scan (7.10.2.5): the block's 8x8s up to 64x64, every
 * second one (every fourth on a side of 64 or more), then, for a block
 * 8 to 32 on both sides, three positions past its bottom-left, bottom-right
 * and right where they lie in its 64x64 (check_sb_border) */
static void temporal_scan(Dec *d, const Blk *b, int ref, int ref2, MvCand *st, int *n,
                          int *zero_ctx) {
    int r = b->r, c = b->c, bw4 = 1 << b->wl, bh4 = 1 << b->hl;
    int step_r = bh4 >= 16 ? 4 : 2, step_c = bw4 >= 16 ? 4 : 2;
    for (int dr = 0; dr < imin(bh4, 16); dr += step_r)
        for (int dc = 0; dc < imin(bw4, 16); dc += step_c)
            add_temporal(d, st, n, r + dr, c + dc, ref, ref2, dr || dc ? NULL : zero_ctx);
    if (bh4 < 2 || bh4 >= 16 || bw4 < 2 || bw4 >= 16) return;
    const int pos[3][2] = {{bh4, -2}, {bh4, bw4}, {bh4 - 2, bw4}};
    for (int k = 0; k < 3; k++) {
        int rr = (r & 15) + pos[k][0], cc = (c & 15) + pos[k][1];
        if (rr >= 0 && rr < 16 && cc >= 0 && cc < 16)
            add_temporal(d, st, n, r + pos[k][0], c + pos[k][1], ref, ref2, NULL);
    }
}

/* find_mv_stack for a single reference (ref2 NONE_FRAME) or the pair (ref,
 * ref2), as dav1d scans it: the spatial rows, columns and points with
 * their weights, the temporal candidates under use_ref_frame_mvs
 * (ZeroMvContext is use_ref_frame_mvs where the block's own 8x8 holds no
 * projection), the sorting, the extra search (spec 7.10.2.12: for a pair
 * the RefIdMvs and RefDiffMvs of the neighbours combined, filling the
 * stack to two with the GlobalMvs) and the clamping; for a single
 * reference RefStackMv past NumMvFound takes the GlobalMv. The block's
 * GlobalMvs are left in d->gmv. Returns NumMvFound; ctx gets
 * NewMvContext | ZeroMvContext << 3 | RefMvContext << 4 */
static int inter_mv_stack(Dec *d, Blk *b, int ref, int ref2, MvCand *st, int *ctx) {
    int r = b->r, c = b->c, bw4 = 1 << b->wl, bh4 = 1 << b->hl;
    global_mv(d, b, ref, d->gmv[0]);
    global_mv(d, b, ref2, d->gmv[1]);
    int w4 = imin(imin(bw4, 16), d->c1 - c), h4 = imin(imin(bh4, 16), d->r1 - r);
    enum { NONE = 1 << 20 };
    int n = 0, max_rows = 0, max_cols = 0, n_rows = NONE, n_cols = NONE;
    int newmv = 0, row_m = 0, col_m = 0, dummy = 0;
    if (r > d->r0) {
        max_rows = imin((r - d->r0 + 1) >> 1, 2 + (bh4 > 1));
        n_rows = mv_scan_row(d, st, &n, ref, ref2, r - 1, c, bw4, w4, max_rows,
                             bw4 >= 16 ? 4 : 1, &newmv, &row_m);
    }
    if (c > d->c0) {
        max_cols = imin((c - d->c0 + 1) >> 1, 2 + (bw4 > 1));
        n_cols = mv_scan_col(d, st, &n, ref, ref2, r, c - 1, bh4, h4, max_cols,
                             bh4 >= 16 ? 4 : 1, &newmv, &col_m);
    }
    int sbmask = d->sb4 - 1;
    if (n_rows != NONE && imax(bw4, bh4) <= 16 && c + bw4 < d->c1 &&
        d->decoded[0][(r & sbmask) - 1 + 1][(c & sbmask) + bw4 + 1])
        add_spatial(d, st, &n, r - 1, c + bw4, ref, ref2, 4, &newmv, &row_m);
    int nearest_match = row_m + col_m, nearest = n;
    for (int k = 0; k < nearest; k++) st[k].weight += REF_CAT_LEVEL;
    int zero_ctx = d->use_ref_mvs;
    if (d->use_ref_mvs) temporal_scan(d, b, ref, ref2, st, &n, &zero_ctx);
    if (n_rows != NONE && n_cols != NONE)
        add_spatial(d, st, &n, r - 1, c - 1, ref, ref2, 4, &dummy, &row_m);
    for (int k = 2; k <= 3; k++) {
        if (k > n_rows && k <= max_rows)
            n_rows += mv_scan_row(d, st, &n, ref, ref2, (r - 2 * k + 1) | 1, c | 1, bw4, w4,
                                  1 + max_rows - k, bw4 >= 16 ? 4 : 2, &dummy, &row_m);
        if (k > n_cols && k <= max_cols)
            n_cols += mv_scan_col(d, st, &n, ref, ref2, r | 1, (c - 2 * k + 1) | 1, bh4, h4,
                                  1 + max_cols - k, bh4 >= 16 ? 4 : 2, &dummy, &col_m);
    }
    int ref_match = row_m + col_m, refmv_ctx, newmv_ctx;
    if (nearest_match == 0) {
        refmv_ctx = imin(2, ref_match);
        newmv_ctx = ref_match > 0;
    } else if (nearest_match == 1) {
        refmv_ctx = imin(ref_match * 3, 4);
        newmv_ctx = 3 - newmv;
    } else {
        refmv_ctx = 5;
        newmv_ctx = 5 - newmv;
    }
    sort_mv_stack(st, 0, nearest);
    sort_mv_stack(st, nearest, n);
    int sz4 = imin(w4, h4);
    if (n < 2 && ref2 > INTRA_FRAME) {
        /* the pair's RefIdMvs and RefDiffMvs, then the GlobalMvs */
        int refs[2] = {ref, ref2}, id[2][2][2], diff[2][2][2], nid[2] = {0, 0},
            ndiff[2] = {0, 0}, comb[2][2][2];
        if (n_rows != NONE)
            for (int x = 0; x < sz4;) {
                int m = mi_at(d, r - 1, c + x);
                if (d->mi_inter[m]) add_extended_pair(d, m, refs, id, nid, diff, ndiff);
                x += 1 << d->mi_wl[m];
            }
        if (n_cols != NONE)
            for (int y = 0; y < sz4;) {
                int m = mi_at(d, r + y, c - 1);
                if (d->mi_inter[m]) add_extended_pair(d, m, refs, id, nid, diff, ndiff);
                y += 1 << d->mi_hl[m];
            }
        for (int l = 0; l < 2; l++) {
            int k = 0;
            for (int i = 0; i < nid[l]; i++, k++) memcpy(comb[k][l], id[l][i], sizeof(comb[k][l]));
            for (int i = 0; i < ndiff[l] && k < 2; i++, k++)
                memcpy(comb[k][l], diff[l][i], sizeof(comb[k][l]));
            for (; k < 2; k++) memcpy(comb[k][l], d->gmv[l], sizeof(comb[k][l]));
        }
        if (n == 1) {
            int same = comb[0][0][0] == st[0].mv[0] && comb[0][0][1] == st[0].mv[1] &&
                       comb[0][1][0] == st[0].mv2[0] && comb[0][1][1] == st[0].mv2[1];
            const int (*e)[2] = comb[same];
            st[1].mv[0] = e[0][0];
            st[1].mv[1] = e[0][1];
            st[1].mv2[0] = e[1][0];
            st[1].mv2[1] = e[1][1];
            st[1].weight = 2;
        } else {
            for (int k = 0; k < 2; k++) {
                st[k].mv[0] = comb[k][0][0];
                st[k].mv[1] = comb[k][0][1];
                st[k].mv2[0] = comb[k][1][0];
                st[k].mv2[1] = comb[k][1][1];
                st[k].weight = 2;
            }
        }
        n = 2;
    } else if (n < 2) {
        if (n_rows != NONE)
            for (int x = 0; x < sz4 && n < 2;) {
                int m = mi_at(d, r - 1, c + x);
                add_extended(d, st, &n, m, ref);
                x += 1 << d->mi_wl[m];
            }
        if (n_cols != NONE)
            for (int y = 0; y < sz4 && n < 2;) {
                int m = mi_at(d, r + y, c - 1);
                add_extended(d, st, &n, m, ref);
                y += 1 << d->mi_hl[m];
            }
    }
    int top = -(r * 32) - (128 + bh4 * 32), bottom = (d->mi_rows - r) * 32 + 128;
    int left = -(c * 32) - (128 + bw4 * 32), right = (d->mi_cols - c) * 32 + 128;
    for (int k = 0; k < n; k++) {
        st[k].mv[0] = (int)clip64(st[k].mv[0], top, bottom);
        st[k].mv[1] = (int)clip64(st[k].mv[1], left, right);
        st[k].mv2[0] = (int)clip64(st[k].mv2[0], top, bottom);
        st[k].mv2[1] = (int)clip64(st[k].mv2[1], left, right);
    }
    for (int k = n; k < 2; k++) {
        st[k].mv[0] = d->gmv[0][0];
        st[k].mv[1] = d->gmv[0][1];
        st[k].mv2[0] = st[k].mv2[1] = 0;
    }
    *ctx = newmv_ctx | zero_ctx << 3 | refmv_ctx << 4;
    return n;
}

static int drl_ctx(const MvCand *st, int idx) {
    if (st[idx].weight >= REF_CAT_LEVEL) return st[idx + 1].weight < REF_CAT_LEVEL;
    return st[idx + 1].weight < REF_CAT_LEVEL ? 2 : 0;
}

/* read_mv_component in MvCtx 0 (``inter``) or intrabc's
 * MV_INTRABC_CONTEXT (the D_MV_* CDFs, whose DV is an integer): an
 * integer MV reads no fraction (mv_fr 3), one without high precision no
 * hp bit (mv_hp 1) */
static int read_mv_comp(Dec *d, int comp, int inter) {
    int sign = read_symbol(d, d->cdf[inter ? D_MV0_SIGN : D_MV_SIGN] + (size_t)comp * 3, 2);
    int cls = read_symbol(d, d->cdf[inter ? D_MV0_CLASSES : D_MV_CLASSES] + (size_t)comp * 12, 11);
    int integer = !inter || d->force_int_mv, hp = inter && d->allow_hp;
    int mag, fr, hpb;
    if (cls == 0) {
        int bit = read_symbol(d, d->cdf[inter ? D_MV0_CLASS0 : D_MV_CLASS0] + (size_t)comp * 3, 2);
        fr = integer ? 3 : read_symbol(d, d->cdf[D_MV0_CLASS0_FR] + ((size_t)comp * 2 + bit) * 5, 4);
        hpb = hp ? read_symbol(d, d->cdf[D_MV0_CLASS0_HP] + (size_t)comp * 3, 2) : 1;
        mag = ((bit << 3) | (fr << 1) | hpb) + 1;
    } else {
        int bits = 0;
        for (int i = 0; i < cls; i++)
            bits |= read_symbol(d, d->cdf[inter ? D_MV0_BITS : D_MV_BITS] + ((size_t)comp * 10 + i) * 3,
                                2) << i;
        fr = integer ? 3 : read_symbol(d, d->cdf[D_MV0_FR] + (size_t)comp * 5, 4);
        hpb = hp ? read_symbol(d, d->cdf[D_MV0_HP] + (size_t)comp * 3, 2) : 1;
        mag = (2 << (cls + 2)) + ((bits << 3) | (fr << 1) | hpb) + 1;
    }
    return sign ? -mag : mag;
}

/* find_mv_stack(0) for RefFrame INTRA_FRAME (inter_mv_stack, whose extra
 * search adds nothing for it: only references past INTRA_FRAME), then
 * assign_mv: PredMv from the stack or the default DV, plus read_mv in
 * MV_INTRABC_CONTEXT */
static void intrabc_dv(Dec *d, Blk *b) {
    MvCand st[8];
    int ctx, n = inter_mv_stack(d, b, INTRA_FRAME, NONE_FRAME, st, &ctx);
    int pred[2] = {0, 0};
    for (int k = 0; k < imin(n, 2); k++)
        if (st[k].mv[0] || st[k].mv[1]) {
            pred[0] = st[k].mv[0];
            pred[1] = st[k].mv[1];
            break;
        }
    if (!pred[0] && !pred[1]) {
        /* the default DV: a superblock (and the 256-pixel delay) to the
         * left in the tile's first superblock row, else one up */
        if (b->r - d->sb4 < d->r0) pred[1] = -(d->sb4 * 4 + 256) * 8;
        else pred[0] = -(d->sb4 * 4 * 8);
        d->count[T_INTRABC_DEFAULT_DV]++;
    }
    int joint = read_symbol(d, d->cdf[D_MV_JOINTS], 4);
    b->mv[0] = pred[0] + ((joint == 2 || joint == 3) ? read_mv_comp(d, 0, 0) : 0);
    b->mv[1] = pred[1] + ((joint == 1 || joint == 3) ? read_mv_comp(d, 1, 0) : 0);
}

/* spec 7.11.3 for an intrabc block: each plane's whole block from the
 * frame decoded so far at the DV, with the BILINEAR filter (a copy for
 * luma, a half sample for subsampled chroma at an odd DV); the chroma of a
 * 4xN or Nx4 block covers its neighbours too and takes this block's DV
 * (someUseIntra: every block of a key frame has RefFrame INTRA_FRAME) */
static void predict_intrabc(Dec *d, Blk *b) {
    static _Thread_local int32_t mid[(128 + 1) * 128], out[128 * 128];
    int round0 = d->bd == 12 ? 5 : 3, round1 = d->bd == 12 ? 9 : 11;
    int maxv = (1 << d->bd) - 1;
    for (int plane = 0; plane < (b->has_chroma ? d->nplanes : 1); plane++) {
        int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
        int wl4, hl4;
        plane_block(d, b, plane, &wl4, &hl4);
        int w = 4 << wl4, h = 4 << hl4;
        int bx = (b->c >> sx) * 4, by = (b->r >> sy) * 4;
        /* the position in 1/16 sample */
        int px16 = (bx << 4) + ((2 * b->mv[1]) >> sx);
        int py16 = (by << 4) + ((2 * b->mv[0]) >> sy);
        int fx = px16 & 15, fy = py16 & 15, ix = px16 >> 4, iy = py16 >> 4;
        if (fx || fy) d->count[T_INTRABC_CHROMA_SUBPEL]++;
        if (plane == 1 && ((sx && b->wl == 0) || (sy && b->hl == 0)))
            d->count[T_INTRABC_SUB8X8_CHROMA]++;
        int lastx = ((d->width + sx) >> sx) - 1, lasty = ((d->height + sy) >> sy) - 1;
        for (int i = 0; i <= h; i++) {
            const int32_t *row = px(d, plane, imin(imax(iy + i, 0), lasty), 0);
            for (int j = 0; j < w; j++) {
                int32_t a = row[imin(imax(ix + j, 0), lastx)];
                int32_t c = row[imin(imax(ix + j + 1, 0), lastx)];
                mid[i * w + j] = (int32_t)rnd2((int64_t)(128 - 8 * fx) * a + 8 * fx * c, round0);
            }
        }
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++)
                out[i * w + j] = (int32_t)clip64(
                    rnd2((int64_t)(128 - 8 * fy) * mid[i * w + j] + 8 * fy * mid[(i + 1) * w + j],
                         round1), 0, maxv);
        for (int i = 0; i < h; i++)
            memcpy(px(d, plane, by + i, bx), out + (size_t)i * w, sizeof(int32_t) * (size_t)w);
    }
}

/* spec get_segment_id: the least PrevSegmentIds over the block's 4x4s
 * inside the frame */
static int predicted_segment_id(const Dec *d, const Blk *b) {
    if (!d->prev_seg) return 0;
    int seg = 7;
    for (int y = b->r; y < imin(d->mi_rows, b->r + (1 << b->hl)); y++)
        for (int x = b->c; x < imin(d->mi_cols, b->c + (1 << b->wl)); x++)
            seg = imin(seg, d->prev_seg[(size_t)y * d->mi_cols + x]);
    return seg;
}

/* AboveSegPredContext and LeftSegPredContext over the block */
static void set_segpred(Dec *d, const Blk *b, int v) {
    memset(d->above_segpred + b->c, v, (size_t)1 << b->wl);
    memset(d->left_segpred + b->r, v, (size_t)1 << b->hl);
}

/* inter_segment_id under segmentation_temporal_update: seg_id_predicted
 * in the context of the above and left blocks' (a skipped block after
 * skip takes the spatial prediction and sets them to 0), then the
 * predicted id or read_segment_id */
static int temporal_segment_id(Dec *d, const Blk *b) {
    if (!d->seg_preskip && b->skip) {
        set_segpred(d, b, 0);
        return read_segment_id(d, b, 1);
    }
    int ctx = d->left_segpred[b->r] + d->above_segpred[b->c];
    int pred = read_symbol(d, d->cdf[D_SEG_ID_PREDICTED] + (size_t)ctx * 3, 2);
    set_segpred(d, b, pred);
    if (!pred) return read_segment_id(d, b, 0);
    d->count[T_SEG_ID_PREDICTED]++;
    return predicted_segment_id(d, b);
}

/* the start of intra_frame_mode_info and inter_frame_mode_info: the
 * segment id (before or after skip; in an inter frame the predicted one
 * under segmentation_update_map 0, or coded against it under
 * segmentation_temporal_update), skip_mode, skip, the CDEF index, the
 * deltas and the block's dequantizers */
static void block_preamble(Dec *d, Blk *b) {
    int skip_ctx = 0, skip_mode_ctx = 0;
    if (b->avail_u) {
        int m = mi_at(d, b->r - 1, b->c);
        skip_ctx += d->mi_skip[m];
        skip_mode_ctx += d->mi_skip_mode[m];
    }
    if (b->avail_l) {
        int m = mi_at(d, b->r, b->c - 1);
        skip_ctx += d->mi_skip[m];
        skip_mode_ctx += d->mi_skip_mode[m];
    }
    int seg = 0;
    int kept = d->seg_enabled && !d->seg_update_map;
    int temporal = d->seg_enabled && d->seg_update_map && d->seg_temporal;
    if (kept) {
        seg = predicted_segment_id(d, b);
    } else if (d->seg_enabled && d->seg_preskip) {
        seg = temporal ? temporal_segment_id(d, b) : read_segment_id(d, b, 0);
        d->count[T_SEG_PRESKIP]++;
    }
    /* read_skip_mode: a block of 8x8 or more whose segment has no SKIP,
     * REF_FRAME or GLOBALMV feature (each of which sets SegIdPreSkip) */
    b->skip_mode = 0;
    if (d->skip_mode_present && imin(b->wl, b->hl) >= 1 &&
        !(d->seg_enabled && ((d->seg_skip_mask | d->seg_ref_mask | d->seg_gmv_mask) >> seg & 1)))
        b->skip_mode = read_symbol(d, d->cdf[D_SKIP_MODE] + (size_t)skip_mode_ctx * 3, 2);
    /* read_skip: a skip_mode block skips, and a segment with
     * SEG_LVL_SKIP (which sets SegIdPreSkip) skips its blocks, without a
     * symbol */
    if (b->skip_mode) {
        b->skip = 1;
    } else if (d->seg_enabled && d->seg_preskip && (d->seg_skip_mask >> seg & 1)) {
        b->skip = 1;
        d->count[T_SEG_SKIP]++;
    } else {
        b->skip = read_symbol(d, d->cdf[D_SKIP] + (size_t)skip_ctx * 3, 2);
    }
    if (d->seg_enabled && !d->seg_preskip && !kept)
        seg = temporal ? temporal_segment_id(d, b) : read_segment_id(d, b, b->skip);
    d->seg_id = seg;
    if (d->seg_enabled && (d->seg_altlf_mask >> (4 * seg) & 15)) d->count[T_SEG_ALT_LF]++;
    d->lossless = d->seg_lossless_mask >> seg & 1;
    read_cdef(d, b);
    if (d->delta_q_res >= 0) read_deltas(d, b);
    d->read_deltas = 0;
    if (d->seg_enabled) {
        /* the block's dequantizers at get_qindex(0, segment_id); its
         * transform types are read where get_qindex(1, segment_id) > 0 */
        set_dequant(d, get_qindex(d, 0, seg));
        d->txq = get_qindex(d, 1, seg);
        if (d->seg_altq_mask >> seg & 1 && d->seg_altq[seg]) d->count[T_SEG_ALT_Q]++;
    }
}

/* intra_frame_y_mode (the above and left modes' contexts, ``kf``) or
 * y_mode (the block's size group), then the angles, the uv mode and
 * CFL, the palettes and filter intra */
static void intra_modes(Dec *d, Blk *b, int kf) {
    if (kf) {
        int am = b->avail_u ? d->mi_ymode[mi_at(d, b->r - 1, b->c)] : DC_PRED;
        int lm = b->avail_l ? d->mi_ymode[mi_at(d, b->r, b->c - 1)] : DC_PRED;
        b->ymode = read_symbol(d, d->cdf[D_KF_Y] + ((size_t)INTRA_MODE_CONTEXT[am] * 5 +
                                                   INTRA_MODE_CONTEXT[lm]) * 14, 13);
    } else {
        b->ymode = read_symbol(d, d->cdf[D_Y_MODE] + (size_t)SIZE_GROUP[b->bsize] * 14, 13);
    }
    b->angle_y = 0;
    if (b->bsize >= 3 && b->ymode >= V_PRED && b->ymode <= D67_PRED)
        b->angle_y = read_symbol(d, d->cdf[D_ANGLE_DELTA] + (size_t)(b->ymode - V_PRED) * 8, 7) - 3;
    b->uvmode = DC_PRED;
    b->angle_uv = 0;
    b->cfl_u = b->cfl_v = 0;
    if (b->has_chroma) {
        int bw = 4 << b->wl, bh = 4 << b->hl;
        int pwl4, phl4;
        plane_block(d, b, 1, &pwl4, &phl4);
        int cfl_allowed = d->lossless ? (pwl4 == 0 && phl4 == 0) : (imax(bw, bh) <= 32);
        if (cfl_allowed)
            b->uvmode = read_symbol(d, d->cdf[D_UV_MODE_CFL] + (size_t)b->ymode * 15, 14);
        else
            b->uvmode = read_symbol(d, d->cdf[D_UV_MODE] + (size_t)b->ymode * 14, 13);
        if (b->uvmode == UV_CFL_PRED) {
            int signs = read_symbol(d, d->cdf[D_CFL_SIGN], 8);
            int su = (signs + 1) / 3, sv = (signs + 1) % 3;
            if (su) {
                int a = 1 + read_symbol(d, d->cdf[D_CFL_ALPHA] + (size_t)((su - 1) * 3 + sv) * 17, 16);
                b->cfl_u = su == 1 ? -a : a;
            }
            if (sv) {
                int a = 1 + read_symbol(d, d->cdf[D_CFL_ALPHA] + (size_t)((sv - 1) * 3 + su) * 17, 16);
                b->cfl_v = sv == 1 ? -a : a;
            }
        }
        if (b->bsize >= 3 && b->uvmode >= V_PRED && b->uvmode <= D67_PRED)
            b->angle_uv = read_symbol(d, d->cdf[D_ANGLE_DELTA] + (size_t)(b->uvmode - V_PRED) * 8, 7) - 3;
    }
    b->pal_n = b->pal_uv_n = 0;
    if (b->bsize >= 3 && b->wl <= 4 && b->hl <= 4 && d->screen_tools) {
        palette_mode_info(d, b);
        if (d->err) return;
    }
    b->use_fi = 0;
    if (d->filter_intra && b->ymode == DC_PRED && b->pal_n == 0 &&
        imax(b->wl, b->hl) <= 3) {
        b->use_fi = read_symbol(d, d->cdf[D_FI_USE] + (size_t)b->bsize * 3, 2);
        if (b->use_fi) b->fi_mode = read_symbol(d, d->cdf[D_FI_MODE], 5);
    }
}

static void intra_mode_info(Dec *d, Blk *b) {
    block_preamble(d, b);
    b->ref = INTRA_FRAME;
    b->mode = 0;
    b->is_inter = d->allow_intrabc && read_symbol(d, d->cdf[D_INTRABC], 2);
    if (b->is_inter) {
        /* as libaom's read_intrabc_info: DC_PRED for the kf_y context,
         * the palette cache and get_filter_type of later blocks */
        b->ymode = b->uvmode = DC_PRED;
        b->angle_y = b->angle_uv = b->cfl_u = b->cfl_v = 0;
        b->pal_n = b->pal_uv_n = b->use_fi = 0;
        memset(b->txtypes, DCT_DCT, sizeof(b->txtypes));
        intrabc_dv(d, b);
        d->count[T_INTRABC]++;
        return;
    }
    intra_modes(d, b, 1);
}

/* ---- inter blocks (spec 5.11.18-5.11.33, 7.10.2, 7.11.3) ------------------ */

static int seg_active(const Dec *d, int mask) {
    return d->seg_enabled && (mask >> d->seg_id & 1);
}

/* how often the above and left blocks use reference frame rf, both
 * references of a compound neighbour counted (libaom's
 * neighbors_ref_counts) */
static int count_ref(const Dec *d, const Blk *b, int rf) {
    int n = 0;
    if (b->avail_u) {
        int m = mi_at(d, b->r - 1, b->c);
        n += (d->mi_ref[m] == rf) + (d->mi_ref2[m] == rf);
    }
    if (b->avail_l) {
        int m = mi_at(d, b->r, b->c - 1);
        n += (d->mi_ref[m] == rf) + (d->mi_ref2[m] == rf);
    }
    return n;
}
static int ref_count_ctx(int a, int b) { return a < b ? 0 : (a == b ? 1 : 2); }
static int is_backward(int rf) { return rf >= BWDREF_FRAME && rf <= ALTREF_FRAME; }

/* the above and left neighbours' RefFrame[0] and [1] (INTRA_FRAME and
 * NONE_FRAME where one is outside the tile) */
static void neighbour_refs(const Dec *d, const Blk *b, int *a, int *l) {
    a[0] = l[0] = INTRA_FRAME;
    a[1] = l[1] = NONE_FRAME;
    if (b->avail_u) {
        int m = mi_at(d, b->r - 1, b->c);
        a[0] = d->mi_ref[m];
        a[1] = d->mi_ref2[m];
    }
    if (b->avail_l) {
        int m = mi_at(d, b->r, b->c - 1);
        l[0] = d->mi_ref[m];
        l[1] = d->mi_ref2[m];
    }
}

/* spec comp_mode's context (libaom av1_get_reference_mode_context) */
static int comp_mode_ctx(const Dec *d, const Blk *b) {
    int a[2], l[2];
    neighbour_refs(d, b, a, l);
    int as = a[1] <= INTRA_FRAME, ls = l[1] <= INTRA_FRAME;
    if (b->avail_u && b->avail_l) {
        if (as && ls) return is_backward(a[0]) ^ is_backward(l[0]);
        if (as) return 2 + (is_backward(a[0]) || a[0] <= INTRA_FRAME);
        if (ls) return 2 + (is_backward(l[0]) || l[0] <= INTRA_FRAME);
        return 4;
    }
    if (b->avail_u) return as ? is_backward(a[0]) : 3;
    if (b->avail_l) return ls ? is_backward(l[0]) : 3;
    return 1;
}

/* has_uni_comp_refs: a pair on one side of the frame */
static int uni_pair(const int *rf) {
    return rf[1] > INTRA_FRAME && (rf[0] >= BWDREF_FRAME) == (rf[1] >= BWDREF_FRAME);
}

/* spec comp_ref_type's context (libaom
 * av1_get_comp_reference_type_context) */
static int comp_ref_type_ctx(const Dec *d, const Blk *b) {
    int a[2], l[2];
    neighbour_refs(d, b, a, l);
    if (b->avail_u && b->avail_l) {
        int ai = a[0] <= INTRA_FRAME, li = l[0] <= INTRA_FRAME;
        if (ai && li) return 2;
        if (ai || li) {
            const int *e = ai ? l : a;
            return e[1] <= INTRA_FRAME ? 2 : 1 + 2 * uni_pair(e);
        }
        int asg = a[1] <= INTRA_FRAME, lsg = l[1] <= INTRA_FRAME;
        int samedir = (a[0] >= BWDREF_FRAME) == (l[0] >= BWDREF_FRAME);
        if (asg && lsg) return 1 + 2 * samedir;
        if (asg || lsg) return uni_pair(asg ? l : a) ? 3 + samedir : 1;
        int au = uni_pair(a), lu = uni_pair(l);
        if (!au && !lu) return 0;
        if (!au || !lu) return 2;
        return 3 + ((a[0] == BWDREF_FRAME) == (l[0] == BWDREF_FRAME));
    }
    if (b->avail_u || b->avail_l) {
        const int *e = b->avail_u ? a : l;
        if (e[0] <= INTRA_FRAME || e[1] <= INTRA_FRAME) return 2;
        return 4 * uni_pair(e);
    }
    return 2;
}

/* spec read_ref_frames: the segment's reference, or comp_mode, then the
 * single_ref tree or a compound pair: unidirectional through uni_comp_ref
 * (LAST with LAST2, LAST3 or GOLDEN; BWDREF with ALTREF) or bidirectional
 * through comp_ref and comp_bwdref, each with its spec 8.3.2 context */
static void read_ref_frames(Dec *d, Blk *b) {
    b->ref2 = NONE_FRAME;
    if (seg_active(d, d->seg_ref_mask)) {
        b->ref = (d->seg_ref_frames >> (3 * d->seg_id)) & 7;
        return;
    }
    if (seg_active(d, d->seg_skip_mask) || seg_active(d, d->seg_gmv_mask)) {
        b->ref = LAST_FRAME;
        return;
    }
    int c[8];
    for (int rf = 1; rf < 8; rf++) c[rf] = count_ref(d, b, rf);
#define REF2(which, stride, p, ctx) \
    read_symbol(d, d->cdf[which] + ((size_t)(ctx) * (stride) + (p)) * 3, 2)
    if (d->reference_select && imin(b->wl, b->hl) >= 1 &&
        read_symbol(d, d->cdf[D_COMP_MODE] + (size_t)comp_mode_ctx(d, b) * 3, 2)) {
        if (!read_symbol(d, d->cdf[D_COMP_REF_TYPE] + (size_t)comp_ref_type_ctx(d, b) * 3, 2)) {
            d->count[T_COMP_REF_UNIDIR]++;
            if (REF2(D_UNI_COMP_REF, 3, 0, ref_count_ctx(c[1] + c[2] + c[3] + c[4],
                                                         c[5] + c[6] + c[7]))) {
                b->ref = BWDREF_FRAME;
                b->ref2 = ALTREF_FRAME;
            } else {
                b->ref = LAST_FRAME;
                if (REF2(D_UNI_COMP_REF, 3, 1, ref_count_ctx(c[2], c[3] + c[4])))
                    b->ref2 = REF2(D_UNI_COMP_REF, 3, 2, ref_count_ctx(c[3], c[4]))
                                  ? GOLDEN_FRAME : LAST3_FRAME;
                else
                    b->ref2 = LAST2_FRAME;
            }
            return;
        }
        d->count[T_COMP_REF_BIDIR]++;
        if (!REF2(D_COMP_REF, 3, 0, ref_count_ctx(c[1] + c[2], c[3] + c[4])))
            b->ref = REF2(D_COMP_REF, 3, 1, ref_count_ctx(c[1], c[2])) ? LAST2_FRAME : LAST_FRAME;
        else
            b->ref = REF2(D_COMP_REF, 3, 2, ref_count_ctx(c[3], c[4])) ? GOLDEN_FRAME : LAST3_FRAME;
        if (!REF2(D_COMP_BWDREF, 2, 0, ref_count_ctx(c[5] + c[6], c[7])))
            b->ref2 = REF2(D_COMP_BWDREF, 2, 1, ref_count_ctx(c[5], c[6])) ? ALTREF2_FRAME
                                                                         : BWDREF_FRAME;
        else
            b->ref2 = ALTREF_FRAME;
        return;
    }
#undef REF2
#define SREF(p, ctx) read_symbol(d, d->cdf[D_SINGLE_REF] + ((size_t)(ctx) * 6 + (p) - 1) * 3, 2)
    if (SREF(1, ref_count_ctx(c[1] + c[2] + c[3] + c[4], c[5] + c[6] + c[7]))) {
        if (SREF(2, ref_count_ctx(c[5] + c[6], c[7]))) b->ref = ALTREF_FRAME;
        else b->ref = SREF(6, ref_count_ctx(c[5], c[6])) ? ALTREF2_FRAME : BWDREF_FRAME;
        return;
    }
    if (SREF(3, ref_count_ctx(c[1] + c[2], c[3] + c[4])))
        b->ref = SREF(5, ref_count_ctx(c[3], c[4])) ? GOLDEN_FRAME : LAST3_FRAME;
    else
        b->ref = SREF(4, ref_count_ctx(c[1], c[2])) ? LAST2_FRAME : LAST_FRAME;
#undef SREF
}

/* spec 7.11.3.3 xScale/yScale of a reference RefUpscaledWidth x
 * RefFrameHeight for a frame FrameWidth x FrameHeight, in 1/2^14 */
enum { NO_SCALE = 1 << 14 };
static int ref_scale(int ref_size, int size) {
    return (int)((((int64_t)ref_size << 14) + size / 2) / size);
}

/* spec is_scaled */
static int ref_is_scaled(const Dec *d, int ref) {
    return d->xscale[ref] != NO_SCALE || d->yscale[ref] != NO_SCALE;
}

/* spec has_overlappable_candidates */
static int overlappable(const Dec *d, const Blk *b) {
    if (b->avail_u)
        for (int x = b->c; x < imin(d->mi_cols, b->c + (1 << b->wl)); x += 2)
            if (d->mi_ref[mi_at(d, b->r - 1, imin(x | 1, d->mi_cols - 1))] > INTRA_FRAME) return 1;
    if (b->avail_l)
        for (int y = b->r; y < imin(d->mi_rows, b->r + (1 << b->hl)); y += 2)
            if (d->mi_ref[mi_at(d, imin(y | 1, d->mi_rows - 1), b->c - 1)] > INTRA_FRAME) return 1;
    return 0;
}

/* spec 7.10.4.2 add_sample: the neighbour at (r + dr, c + dc), where it
 * is inside the tile and of the block's single reference (a compound or
 * inter-intra neighbour, RefFrame[1] not NONE_FRAME, is no sample, nor
 * scanned), joins CandList
 * at its block's centre less one sample; one whose MV differs from the
 * block's by more than the size's threshold is dropped unless it is the
 * first scanned, which stays at CandList[0] uncounted */
static void add_sample(const Dec *d, Blk *b, int dr, int dc, int *scanned) {
    if (*scanned >= 8) return;
    int r = b->r + dr, c = b->c + dc;
    if (!is_inside(d, r, c)) return;
    int m = mi_at(d, r, c);
    if (d->mi_ref[m] != b->ref || d->mi_ref2[m] != NONE_FRAME) return;
    int cw4 = 1 << d->mi_wl[m], ch4 = 1 << d->mi_hl[m];
    int midy = (r & ~(ch4 - 1)) * 4 + ch4 * 2 - 1;
    int midx = (c & ~(cw4 - 1)) * 4 + cw4 * 2 - 1;
    int thresh = imin(imax(4 << imax(b->wl, b->hl), 16), 112);
    int mvr = d->mi_mv[2 * m], mvc = d->mi_mv[2 * m + 1];
    int valid = abs(mvr - b->mv[0]) + abs(mvc - b->mv[1]) <= thresh;
    (*scanned)++;
    if (!valid && *scanned > 1) return;
    int *cand = b->cand[b->nsamples];
    cand[0] = midy * 8;
    cand[1] = midx * 8;
    cand[2] = midy * 8 + mvr;
    cand[3] = midx * 8 + mvc;
    if (valid) b->nsamples++;
}

/* spec 7.10.4.1 find_warp_samples: the above row and left column of
 * neighbours (each neighbour once), the top-left, and the top-right where
 * it is decoded; NumSamples 1 where every sample scanned was dropped */
static void find_warp_samples(const Dec *d, Blk *b) {
    int w4 = 1 << b->wl, h4 = 1 << b->hl, r = b->r, c = b->c;
    int top_left = 1, top_right = 1, scanned = 0;
    b->nsamples = 0;
    if (b->avail_u) {
        int sw = 1 << d->mi_wl[mi_at(d, r - 1, c)];
        if (w4 <= sw) {
            int off = -(c & (sw - 1));
            if (off < 0) top_left = 0;
            if (off + sw > w4) top_right = 0;
            add_sample(d, b, -1, 0, &scanned);
        } else {
            for (int i = 0; i < imin(w4, d->mi_cols - c);) {
                int step = 1 << d->mi_wl[mi_at(d, r - 1, c + i)];
                add_sample(d, b, -1, i, &scanned);
                i += step;
            }
        }
    }
    if (b->avail_l) {
        int sh = 1 << d->mi_hl[mi_at(d, r, c - 1)];
        if (h4 <= sh) {
            if (-(r & (sh - 1)) < 0) top_left = 0;
            add_sample(d, b, 0, -1, &scanned);
        } else {
            for (int i = 0; i < imin(h4, d->mi_rows - r);) {
                int step = 1 << d->mi_hl[mi_at(d, r + i, c - 1)];
                add_sample(d, b, i, -1, &scanned);
                i += step;
            }
        }
    }
    if (top_left) add_sample(d, b, -1, -1, &scanned);
    int sbmask = d->sb4 - 1;
    if (top_right && imax(w4, h4) <= 16 && is_inside(d, r - 1, c + w4) &&
        d->decoded[0][(r & sbmask) - 1 + 1][(c & sbmask) + w4 + 1])
        add_sample(d, b, -1, w4, &scanned);
    if (!b->nsamples && scanned) b->nsamples = 1;
}

/* spec interp_filter's context: a neighbour's filter counts where either
 * of its references is the block's RefFrame[0] */
static int interp_ctx(const Dec *d, const Blk *b, int dir) {
    int ctx = ((dir & 1) * 2 + (b->ref2 > INTRA_FRAME)) * 4, left = 3, above = 3;
    if (b->avail_l) {
        int m = mi_at(d, b->r, b->c - 1);
        if (d->mi_ref[m] == b->ref || d->mi_ref2[m] == b->ref)
            left = (d->mi_filt[m] >> (2 * dir)) & 3;
    }
    if (b->avail_u) {
        int m = mi_at(d, b->r - 1, b->c);
        if (d->mi_ref[m] == b->ref || d->mi_ref2[m] == b->ref)
            above = (d->mi_filt[m] >> (2 * dir)) & 3;
    }
    if (left == above) return ctx + left;
    if (left == 3) return ctx + above;
    if (above == 3) return ctx + left;
    return ctx + 3;
}

/* spec get_mode: the single mode of side i of a mode (the mode itself
 * for a single reference) */
static int side_mode(int mode, int i) {
    static const int SIDES[8][2] = {
        {NEARESTMV, NEARESTMV}, {NEARMV, NEARMV}, {NEARESTMV, NEWMV}, {NEWMV, NEARESTMV},
        {NEARMV, NEWMV}, {NEWMV, NEARMV}, {GLOBALMV, GLOBALMV}, {NEWMV, NEWMV}};
    return mode < NEAREST_NEARESTMV ? mode : SIDES[mode - NEAREST_NEARESTMV][i];
}

/* comp_group_idx's (cidx 0) or compound_idx's (cidx 1) context: the
 * neighbours' own, or for a single neighbour on ALTREF 3 (1) */
static int comp_idx_ctx(const Dec *d, const Blk *b, int cidx) {
    int ctx = 0;
    for (int k = 0; k < 2; k++) {
        if (!(k ? b->avail_l : b->avail_u)) continue;
        int m = k ? mi_at(d, b->r, b->c - 1) : mi_at(d, b->r - 1, b->c);
        if (d->mi_ref2[m] > INTRA_FRAME) ctx += cidx ? d->mi_cidx[m] : d->mi_cgi[m];
        else if (d->mi_ref[m] == ALTREF_FRAME) ctx += cidx ? 1 : 3;
    }
    if (cidx) return ctx + 3 * (abs(d->cur_off[b->ref]) == abs(d->cur_off[b->ref2]));
    return imin(ctx, 5);
}

/* spec read_compound_type: comp_group_idx under enable_masked_compound;
 * in group 0 compound_idx under enable_jnt_comp (AVERAGE or DISTANCE),
 * else AVERAGE; in group 1 compound_type where the size has wedges (WEDGE
 * or DIFFWTD), else DIFFWTD; then wedge_index and wedge_sign, or
 * mask_type */
static void read_compound_type(Dec *d, Blk *b) {
    b->cgi = 0;
    b->cidx = 1;
    b->ctype = COMPOUND_AVERAGE;
    if (d->masked_compound)
        b->cgi = read_symbol(d, d->cdf[D_COMP_GROUP_IDX] + (size_t)comp_idx_ctx(d, b, 0) * 3, 2);
    if (!b->cgi) {
        if (d->jnt_comp) {
            b->cidx = read_symbol(d, d->cdf[D_COMPOUND_IDX] + (size_t)comp_idx_ctx(d, b, 1) * 3, 2);
            b->ctype = b->cidx ? COMPOUND_AVERAGE : COMPOUND_DISTANCE;
        }
    } else {
        b->ctype = has_wedge(b->bsize)
                       ? read_symbol(d, d->cdf[D_COMPOUND_TYPE] + (size_t)b->bsize * 3, 2)
                       : COMPOUND_DIFFWTD;
    }
    if (b->ctype == COMPOUND_WEDGE) {
        b->wedge_idx = read_symbol(d, d->cdf[D_WEDGE_INDEX] + (size_t)b->bsize * 17, 16);
        b->wedge_sign = read_literal(d, 1);
    } else if (b->ctype == COMPOUND_DIFFWTD) {
        b->mask_type = read_literal(d, 1);
    }
    static const int COUNTER[5] = {T_COMPOUND_WEDGE, T_COMPOUND_DIFFWTD, T_COMPOUND_AVERAGE, 0,
                                   T_COMPOUND_DISTANCE};
    d->count[COUNTER[b->ctype]]++;
}

/* inter_block_mode_info: the references, the MV stack, the mode (a
 * compound one through compound_mode and Compound_Mode_Ctx_Map), drl,
 * assign_mv for each side (a GLOBAL side takes its GlobalMv), inter-intra
 * and the motion mode of a single reference, a compound block's
 * type, and the filters; a skip_mode block reads none of these and takes
 * SkipModeFrame, NEAREST_NEARESTMV averaged, SIMPLE and EIGHTTAP (or the
 * frame's filter) */
static void inter_block_mode_info(Dec *d, Blk *b) {
    if (b->skip_mode) {
        b->ref = d->skip_mode_frame[0];
        b->ref2 = d->skip_mode_frame[1];
    } else {
        read_ref_frames(d, b);
    }
    if (d->err) return;
    int comp = b->ref2 > INTRA_FRAME;
    MvCand st[8];
    int ctx, n = inter_mv_stack(d, b, b->ref, b->ref2, st, &ctx);
    if (b->skip_mode) b->mode = NEAREST_NEARESTMV;
    else if (seg_active(d, d->seg_skip_mask) || seg_active(d, d->seg_gmv_mask)) b->mode = GLOBALMV;
    else if (comp)
        b->mode = NEAREST_NEARESTMV +
                  read_symbol(d, d->cdf[D_COMPOUND_MODE] +
                                     (size_t)COMPOUND_MODE_CTX[ctx >> 5][imin(ctx & 7, 4)] * 9, 8);
    else if (!read_symbol(d, d->cdf[D_NEW_MV] + (size_t)(ctx & 7) * 3, 2)) b->mode = NEWMV;
    else if (!read_symbol(d, d->cdf[D_ZERO_MV] + (size_t)((ctx >> 3) & 1) * 3, 2)) b->mode = GLOBALMV;
    else b->mode = read_symbol(d, d->cdf[D_REF_MV] + (size_t)(ctx >> 4) * 3, 2) ? NEARMV : NEARESTMV;
    int idx = 0;
    int near = b->mode == NEARMV || b->mode == NEAR_NEARMV || b->mode == NEAR_NEWMV ||
               b->mode == NEW_NEARMV;
    if (b->mode == NEWMV || b->mode == NEW_NEWMV || near) {
        int first = near;
        idx = first;
        for (int i = first; i < first + 2; i++) {
            if (n <= i + 1) break;
            if (!read_symbol(d, d->cdf[D_DRL] + (size_t)drl_ctx(st, i) * 3, 2)) {
                idx = i;
                break;
            }
            idx = i + 1;
        }
        if (idx > first) d->count[T_DRL]++;
    }
    if (b->skip_mode) d->count[T_SKIP_MODE]++;
    else if (comp) d->count[T_NEAREST_NEARESTMV + b->mode - NEAREST_NEARESTMV]++;
    else d->count[b->mode == NEWMV ? T_NEWMV : T_NEARESTMV + b->mode - NEARESTMV]++;
    /* assign_mv: PredMv from the stack (a GLOBAL side: its GlobalMv),
     * plus read_mv on a NEWMV side */
    b->mv2[0] = b->mv2[1] = 0;
    for (int i = 0; i < 1 + comp; i++) {
        int sm = side_mode(b->mode, i), *mv = i ? b->mv2 : b->mv;
        if (sm == GLOBALMV) {
            static const int COUNTER[4] = {0, T_GLOBAL_TRANSLATION, T_GLOBAL_ROTZOOM,
                                           T_GLOBAL_AFFINE};
            int typ = d->gm_type[i ? b->ref2 : b->ref];
            memcpy(mv, d->gmv[i], 2 * sizeof(int));
            if (typ) d->count[COUNTER[typ]]++;
        } else {
            const MvCand *e = st + (sm == NEARESTMV ? 0 : idx);
            mv[0] = i ? e->mv2[0] : e->mv[0];
            mv[1] = i ? e->mv2[1] : e->mv[1];
        }
        if (sm == NEWMV) {
            int joint = read_symbol(d, d->cdf[D_MV0_JOINTS], 4);
            if (joint == 2 || joint == 3) mv[0] += read_mv_comp(d, 0, 1);
            if (joint == 1 || joint == 3) mv[1] += read_mv_comp(d, 1, 1);
        }
    }
    if ((b->mv[0] | b->mv[1] | b->mv2[0] | b->mv2[1]) & 7) d->count[T_SUBPEL_MV]++;
    /* read_interintra_mode: 8x8 to 32x32, the CDFs by size group (their
     * first row, size group 0's, unused) and by block size; the intra
     * part takes no angle delta and no filter intra, its wedge sign 0 */
    b->ii = 0;
    if (!b->skip_mode && !comp && d->interintra_on && b->bsize >= 3 && b->bsize <= 9 &&
        read_symbol(d, d->cdf[D_INTERINTRA] + (size_t)SIZE_GROUP[b->bsize] * 3, 2)) {
        b->ii = 1;
        b->ref2 = INTRA_FRAME;
        b->ii_mode = read_symbol(d, d->cdf[D_INTERINTRA_MODE] + (size_t)SIZE_GROUP[b->bsize] * 5, 4);
        b->ii_wedge = read_symbol(d, d->cdf[D_WEDGE_INTERINTRA] + (size_t)b->bsize * 3, 2);
        if (b->ii_wedge) {
            b->wedge_idx = read_symbol(d, d->cdf[D_WEDGE_INDEX] + (size_t)b->bsize * 17, 16);
            b->wedge_sign = 0;
            d->count[T_INTERINTRA_WEDGE]++;
        } else {
            d->count[T_II_DC + b->ii_mode]++;
        }
        d->count[T_INTERINTRA]++;
    }
    /* read_motion_mode: none for a GLOBALMV block on a reference whose
     * GmType is past TRANSLATION (unless force_integer_mv), nor for an
     * inter-intra block (RefFrame[1] INTRA_FRAME) */
    int global = b->mode == GLOBALMV || b->mode == GLOBAL_GLOBALMV;
    b->motion_mode = SIMPLE;
    if (!comp && !b->ii && d->motion_switchable && imin(b->wl, b->hl) >= 1 &&
        !(global && !d->force_int_mv && d->gm_type[b->ref] > TRANSLATION) && overlappable(d, b)) {
        find_warp_samples(d, b);
        if (d->force_int_mv || !b->nsamples || !d->allow_warped || ref_is_scaled(d, b->ref))
            b->motion_mode = read_symbol(d, d->cdf[D_OBMC] + (size_t)b->bsize * 3, 2);
        else
            b->motion_mode = read_symbol(d, d->cdf[D_MOTION_MODE] + (size_t)b->bsize * 4, 3);
    }
    b->cgi = 0;
    b->cidx = 1;
    if (b->skip_mode) b->ctype = COMPOUND_AVERAGE;
    else if (comp) read_compound_type(d, b);
    /* spec needs_interp_filter: none for skip_mode, a local warp, nor for
     * GLOBALMV or GLOBAL_GLOBALMV of 8x8 or more unless a side's GmType
     * is TRANSLATION */
    if (d->interp_filter == 4) {
        int trans = d->gm_type[b->ref] == TRANSLATION ||
                    (comp && d->gm_type[b->ref2] == TRANSLATION);
        int need = !b->skip_mode && b->motion_mode != LOCALWARP &&
                   !(imin(b->wl, b->hl) >= 1 && global && !trans);
        for (int dir = 0; dir < (d->dual_filter ? 2 : 1); dir++)
            b->filt[dir] = need ? read_symbol(d, d->cdf[D_INTERP] + (size_t)interp_ctx(d, b, dir) * 4, 3)
                                : 0;
        if (!d->dual_filter) b->filt[1] = b->filt[0];
    } else {
        b->filt[0] = b->filt[1] = d->interp_filter;
    }
    d->count[T_FILTER_REGULAR + b->filt[0]]++;
    if (b->filt[1] != b->filt[0]) {
        d->count[T_FILTER_REGULAR + b->filt[1]]++;
        d->count[T_DUAL_FILTER]++;
    }
}

/* inter_frame_mode_info: intra blocks read their y mode by size group */
static void inter_frame_mode_info(Dec *d, Blk *b) {
    block_preamble(d, b);
    if (d->err) return;
    int is_inter;
    if (b->skip_mode) {
        is_inter = 1;
    } else if (seg_active(d, d->seg_ref_mask)) {
        is_inter = ((d->seg_ref_frames >> (3 * d->seg_id)) & 7) != INTRA_FRAME;
    } else if (seg_active(d, d->seg_gmv_mask)) {
        is_inter = 1;
    } else {
        int ai = !b->avail_u || d->mi_ref[mi_at(d, b->r - 1, b->c)] <= INTRA_FRAME;
        int li = !b->avail_l || d->mi_ref[mi_at(d, b->r, b->c - 1)] <= INTRA_FRAME;
        int ctx;
        if (b->avail_u && b->avail_l) ctx = (li && ai) ? 3 : (li || ai);
        else if (b->avail_u || b->avail_l) ctx = 2 * (b->avail_u ? ai : li);
        else ctx = 0;
        is_inter = read_symbol(d, d->cdf[D_IS_INTER] + (size_t)ctx * 3, 2);
    }
    b->is_inter = is_inter;
    if (!is_inter) {
        b->ref = INTRA_FRAME;
        b->mode = 0;
        intra_modes(d, b, 0);
        d->count[T_INTRA_IN_INTER]++;
        return;
    }
    b->ymode = b->uvmode = DC_PRED;
    b->angle_y = b->angle_uv = b->cfl_u = b->cfl_v = 0;
    b->pal_n = b->pal_uv_n = b->use_fi = 0;
    memset(b->txtypes, DCT_DCT, sizeof(b->txtypes));
    inter_block_mode_info(d, b);
}

/* the counts of the test hook av1_scaled_parity, or NULL */
static int64_t *scaled_parity;

static int64_t now_ns(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (int64_t)t.tv_sec * 1000000000 + t.tv_nsec;
}

/* stmt, its time added to d->motion_ns[slot] where that is given */
#define MOTION_TIMED(slot, stmt) do { \
        if (d->motion_ns) { \
            int64_t t_ = now_ns(); \
            stmt; \
            d->motion_ns[slot] += now_ns() - t_; \
        } else { \
            stmt; \
        } \
    } while (0)

/* spec 7.11.3.2 InterRound1: 7 for a side of a compound block (whose
 * prediction stays unclipped at that precision), else 11 (9 at 12 bits) */
static int inter_round1(const Dec *d, int compound) {
    return compound ? 7 : (d->bd == 12 ? 9 : 11);
}

/* the last stage of both prediction loops: the sum rounded by
 * InterRound1, clipped to the bit depth unless it is a compound side */
static inline int32_t pred_out(int64_t s, int round1, int compound, int maxv) {
    return compound ? (int32_t)rnd2(s, round1) : (int32_t)clip64(rnd2(s, round1), 0, maxv);
}

/* block inter prediction through a scaled reference (spec 7.11.3.3 motion
 * vector scaling, 7.11.3.4 at startX + xStep * c): the position in 1/1024
 * sample, each row's and column's filter at (p >> 6) & 15 and its samples
 * at p >> 10, clamped at the reference's edges, InterRound0 then
 * InterRound1 as in the unscaled loop; from reference ref at mv with the
 * filters filt (y | x << 2), into dst of stride dstride */
static void predict_scaled(const Dec *d, int plane, int x, int y, int w, int h, int ref,
                           const int *mv, int filt, int compound, int xscale, int yscale,
                           int32_t *dst, int dstride) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    int64_t origx = ((int64_t)x << 4) + ((2 * mv[1]) >> sx) + 8;
    int64_t origy = ((int64_t)y << 4) + ((2 * mv[0]) >> sy) + 8;
    int startx = (int)rnd2s(origx * xscale - ((int64_t)8 << 14), 8) + 32;
    int starty = (int)rnd2s(origy * yscale - ((int64_t)8 << 14), 8) + 32;
    int xstep = (int)rnd2s(xscale, 4), ystep = (int)rnd2s(yscale, 4);
    int fy = filt & 3, fx = (filt >> 2) & 3;
    if (w <= 4) fx = fx == 1 ? 5 : (fx == 3 ? 3 : 4);
    if (h <= 4) fy = fy == 1 ? 5 : (fy == 3 ? 3 : 4);
    const int32_t *src = d->ref_plane[ref][plane];
    int rs = d->ref_stride[ref];
    int lastx = ((d->ref_w[ref] + sx) >> sx) - 1, lasty = ((d->ref_h[ref] + sy) >> sy) - 1;
    int round0 = d->bd == 12 ? 5 : 3, round1 = inter_round1(d, compound);
    int maxv = (1 << d->bd) - 1;
    /* intermediateHeight: up to 263 rows for 128 at the 2x limit */
    static _Thread_local int32_t mid[(2 * 128 + 8) * 128];
    int ih = (((h - 1) * ystep + (1 << 10) - 1) >> 10) + 8;
    /* each column's filter and clamped taps, the same on every row */
    int cols[128 * 8];
    const int16_t *FX[128];
    for (int c = 0; c < w; c++) {
        int p = startx + xstep * c;
        FX[c] = d->subpel + ((size_t)fx * 16 + ((p >> 6) & 15)) * 8;
        for (int t = 0; t < 8; t++) cols[c * 8 + t] = imin(imax((p >> 10) + t - 3, 0), lastx);
    }
    for (int r = 0; r < ih; r++) {
        const int32_t *row = src + (size_t)imin(imax((starty >> 10) + r - 3, 0), lasty) * rs;
        for (int c = 0; c < w; c++) {
            const int *at = cols + c * 8;
            int64_t s = 0;
            for (int t = 0; t < 8; t++) s += (int64_t)FX[c][t] * row[at[t]];
            mid[r * w + c] = (int32_t)rnd2(s, round0);
        }
    }
    for (int r = 0; r < h; r++) {
        int p = (starty & 1023) + ystep * r;
        const int16_t *F = d->subpel + ((size_t)fy * 16 + ((p >> 6) & 15)) * 8;
        const int32_t *col = mid + (size_t)(p >> 10) * w;
        int32_t *out = dst + (size_t)r * dstride;
        for (int c = 0; c < w; c++) {
            int64_t s = 0;
            for (int t = 0; t < 8; t++) s += (int64_t)F[t] * col[t * w + c];
            out[c] = pred_out(s, round1, compound, maxv);
        }
    }
}

/* block inter prediction (spec 7.11.3.3-4) of one w x h part of a plane
 * at (x, y) from reference ref at mv with the filters filt (y | x << 2),
 * into dst of stride dstride: at scale 1 here, Subpel_Filters in 1/16
 * sample (the 4-tap rows for a side of 4 or less), InterRound0 then
 * InterRound1 (clipped pixels, or a compound side's unclipped
 * intermediate), the reference's samples clamped at its edges; through
 * predict_scaled otherwise */
static void predict_side(Dec *d, int plane, int x, int y, int w, int h, int ref,
                         const int *mv, int filt, int compound, int32_t *dst, int dstride) {
    if (ref <= INTRA_FRAME || !d->ref_plane[ref][0]) {
        fail(d, AV1D_CORRUPT, "AV1: %s", "an inter block without its reference frame");
        return;
    }
    if (ref_is_scaled(d, ref)) {
        predict_scaled(d, plane, x, y, w, h, ref, mv, filt, compound, d->xscale[ref],
                       d->yscale[ref], dst, dstride);
        return;
    }
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    const int32_t *src = d->ref_plane[ref][plane];
    int rs = d->ref_stride[ref];
    int fy = filt & 3, fx = (filt >> 2) & 3;
    if (w <= 4) fx = fx == 1 ? 5 : (fx == 3 ? 3 : 4);
    if (h <= 4) fy = fy == 1 ? 5 : (fy == 3 ? 3 : 4);
    int x16 = (x << 4) + ((2 * mv[1]) >> sx);
    int y16 = (y << 4) + ((2 * mv[0]) >> sy);
    const int16_t *FX = d->subpel + ((size_t)fx * 16 + (x16 & 15)) * 8;
    const int16_t *FY = d->subpel + ((size_t)fy * 16 + (y16 & 15)) * 8;
    int x0 = (x16 >> 4) - 3, y0 = (y16 >> 4) - 3;
    int lastx = ((d->ref_w[ref] + sx) >> sx) - 1, lasty = ((d->ref_h[ref] + sy) >> sy) - 1;
    int round0 = d->bd == 12 ? 5 : 3, round1 = inter_round1(d, compound);
    int maxv = (1 << d->bd) - 1;
    static _Thread_local int32_t mid[(128 + 7) * 128];
    int cols[128 + 7];
    for (int j = 0; j < w + 7; j++) cols[j] = imin(imax(x0 + j, 0), lastx);
    for (int i = 0; i < h + 7; i++) {
        const int32_t *row = src + (size_t)imin(imax(y0 + i, 0), lasty) * rs;
        for (int j = 0; j < w; j++) {
            int64_t s = 0;
            for (int t = 0; t < 8; t++) s += (int64_t)FX[t] * row[cols[j + t]];
            mid[i * w + j] = (int32_t)rnd2(s, round0);
        }
    }
    for (int i = 0; i < h; i++) {
        int32_t *out = dst + (size_t)i * dstride;
        for (int j = 0; j < w; j++) {
            int64_t s = 0;
            for (int t = 0; t < 8; t++) s += (int64_t)FY[t] * mid[(i + t) * w + j];
            out[j] = pred_out(s, round1, compound, maxv);
        }
    }
    if (scaled_parity) {
        static _Thread_local int32_t alt[128 * 128];
        predict_scaled(d, plane, x, y, w, h, ref, mv, filt, compound, NO_SCALE, NO_SCALE, alt, w);
        int same = 1;
        for (int i = 0; i < h && same; i++)
            same = !memcmp(alt + i * w, dst + (size_t)i * dstride, (size_t)w * sizeof(int32_t));
        scaled_parity[0]++;
        scaled_parity[1] += !same;
    }
}

/* predict_side with the RefFrame[0], MV and filters of the block at mi
 * (cr, cc): a single-reference part, or OBMC's prediction of a neighbour
 * (from its first reference, compound or not) */
static void predict_part_to(Dec *d, int plane, int x, int y, int w, int h, int cr, int cc,
                            int32_t *dst, int dstride) {
    int m = mi_at(d, cr, cc);
    int mv[2];
    mi_mv_of(d, m, 0, mv);
    predict_side(d, plane, x, y, w, h, d->mi_ref[m], mv, d->mi_filt[m], 0, dst, dstride);
}

static void predict_part(Dec *d, int plane, int x, int y, int w, int h, int cr, int cc) {
    predict_part_to(d, plane, x, y, w, h, cr, cc, px(d, plane, y, x), d->stride);
}

/* spec 7.11.3.15 distance weights (as dav1d's jnt_weights): FwdWeight of
 * RefFrame[0]'s prediction from the two references' distances to the
 * frame, each clamped to MAX_FRAME_DISTANCE; BckWeight is 16 less it */
static int fwd_weight(const Dec *d, const Blk *b) {
    int d1 = imin(abs(d->cur_off[b->ref]), MAX_FRAME_DISTANCE);
    int d0 = imin(abs(d->cur_off[b->ref2]), MAX_FRAME_DISTANCE);
    int order = d0 <= d1, k;
    for (k = 0; k < 3; k++) {
        int c0 = d->qdist_weight[2 * k + order], c1 = d->qdist_weight[2 * k + !order];
        if ((d0 > d1 && d0 * c0 < d1 * c1) || (d0 <= d1 && d0 * c0 > d1 * c1)) break;
    }
    return d->qdist_lookup[2 * k + order];
}

/* the blend of a compound block's two predictions p0, p1 of its pw x ph
 * block of a plane at (bx, by), with InterPostRound: the average, the
 * distance weights (FwdWeight fwd), or the mask (luma's, which plane 0
 * makes first: the wedge's, or the difference-weighted one of the two
 * predictions inverted by mask_type; spec 7.11.3.11-14), chroma taking it
 * subsampled */
static void compound_blend(Dec *d, const Blk *b, int plane, int bx, int by, int pw, int ph,
                           const int32_t *p0, const int32_t *p1, uint8_t *mask, int fwd) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    int post = d->bd == 12 ? 2 : 4; /* InterPostRound */
    int maxv = (1 << d->bd) - 1, bw = 4 << b->wl;
    if (plane == 0 && b->ctype == COMPOUND_WEDGE) {
        const int16_t *w =
            d->wedge_mask[b->bsize] + ((size_t)b->wedge_sign * 16 + b->wedge_idx) * pw * ph;
        for (int i = 0; i < pw * ph; i++) mask[i] = (uint8_t)w[i];
    } else if (plane == 0 && b->ctype == COMPOUND_DIFFWTD) {
        for (int i = 0; i < pw * ph; i++) {
            int m = imin(38 + (int)(rnd2(abs(p0[i] - p1[i]), d->bd - 8 + post) / 16), 64);
            mask[i] = (uint8_t)(b->mask_type ? 64 - m : m);
        }
    }
    for (int i = 0; i < ph; i++) {
        int32_t *out = px(d, plane, by + i, bx);
        const int32_t *a = p0 + (size_t)i * pw, *c = p1 + (size_t)i * pw;
        for (int j = 0; j < pw; j++) {
            int64_t v;
            if (b->ctype == COMPOUND_AVERAGE) {
                v = rnd2((int64_t)a[j] + c[j], 1 + post);
            } else if (b->ctype == COMPOUND_DISTANCE) {
                v = rnd2((int64_t)fwd * a[j] + (int64_t)(16 - fwd) * c[j], 4 + post);
            } else {
                const uint8_t *mr = mask + (size_t)(i << sy) * bw + (j << sx);
                int m = mr[0];
                if (sx && sy) m = (int)rnd2(m + mr[1] + mr[bw] + mr[bw + 1], 2);
                else if (sx) m = (int)rnd2(m + mr[1], 1);
                else if (sy) m = (int)rnd2(m + mr[bw], 1);
                v = rnd2((int64_t)m * a[j] + (int64_t)(64 - m) * c[j], 6 + post);
            }
            out[j] = (int32_t)clip64(v, 0, maxv);
        }
    }
}

/* spec 7.11.3.7 resolve_divisor: Div_Lut's multiplier for |v| and its
 * shift, signed as v */
static int64_t resolve_divisor(const Dec *d, int64_t v, int *shift) {
    uint64_t a = (uint64_t)(v < 0 ? -v : v);
    int n = 63 - __builtin_clzll(a);
    int64_t e = (int64_t)(a - ((uint64_t)1 << n));
    int64_t f = n > DIV_LUT_BITS ? rnd2(e, n - DIV_LUT_BITS) : e << (DIV_LUT_BITS - n);
    *shift = n + DIV_LUT_PREC_BITS;
    return v < 0 ? -(int64_t)d->div_lut[f] : d->div_lut[f];
}

static int64_t ls_product(int64_t a, int64_t b) { return ((a * b) >> 2) + (a + b); }

/* spec 7.11.3.8 warpEstimation: the affine LocalWarpParams that fit the
 * block's samples by least squares, each product's rounding as libaom's
 * and dav1d's 64-bit forms; 0 where the system is singular (LocalValid 0) */
static int warp_estimation(const Dec *d, const Blk *b, int32_t *wp) {
    int64_t a00 = 0, a01 = 0, a11 = 0, bx0 = 0, bx1 = 0, by0 = 0, by1 = 0;
    int midy = b->r * 4 + (2 << b->hl) - 1, midx = b->c * 4 + (2 << b->wl) - 1;
    int suy = midy * 8, sux = midx * 8, duy = suy + b->mv[0], dux = sux + b->mv[1];
    for (int i = 0; i < b->nsamples; i++) {
        int sy = b->cand[i][0] - suy, sx = b->cand[i][1] - sux;
        int dy = b->cand[i][2] - duy, dx = b->cand[i][3] - dux;
        if (abs(sx - dx) < LS_MV_MAX && abs(sy - dy) < LS_MV_MAX) {
            a00 += ls_product(sx, sx) + 8;
            a01 += ls_product(sx, sy) + 4;
            a11 += ls_product(sy, sy) + 8;
            bx0 += ls_product(sx, dx) + 8;
            bx1 += ls_product(sy, dx) + 4;
            by0 += ls_product(sx, dy) + 4;
            by1 += ls_product(sy, dy) + 8;
        }
    }
    int64_t det = a00 * a11 - a01 * a01;
    if (!det) return 0;
    int shift;
    int64_t div = resolve_divisor(d, det, &shift);
    shift -= WARPEDMODEL_PREC_BITS;
    if (shift < 0) {
        div *= (int64_t)1 << -shift;
        shift = 0;
    }
    const int64_t one = 1 << WARPEDMODEL_PREC_BITS, nd = WARPEDMODEL_NONDIAGAFFINE_CLAMP - 1;
    wp[2] = (int32_t)clip64(rnd2s((a11 * bx0 - a01 * bx1) * div, shift), one - nd, one + nd);
    wp[3] = (int32_t)clip64(rnd2s((a00 * bx1 - a01 * bx0) * div, shift), -nd, nd);
    wp[4] = (int32_t)clip64(rnd2s((a11 * by0 - a01 * by1) * div, shift), -nd, nd);
    wp[5] = (int32_t)clip64(rnd2s((a00 * by1 - a01 * by0) * div, shift), one - nd, one + nd);
    int64_t vx = (int64_t)b->mv[1] * (1 << (WARPEDMODEL_PREC_BITS - 3)) -
                 ((int64_t)midx * (wp[2] - one) + (int64_t)midy * wp[3]);
    int64_t vy = (int64_t)b->mv[0] * (1 << (WARPEDMODEL_PREC_BITS - 3)) -
                 ((int64_t)midx * wp[4] + (int64_t)midy * (wp[5] - one));
    wp[0] = (int32_t)clip64(vx, -WARPEDMODEL_TRANS_CLAMP, WARPEDMODEL_TRANS_CLAMP - 1);
    wp[1] = (int32_t)clip64(vy, -WARPEDMODEL_TRANS_CLAMP, WARPEDMODEL_TRANS_CLAMP - 1);
    return 1;
}

/* spec 7.11.3.6 setupShear: alpha, beta, gamma, delta of wp, each reduced
 * to WARP_PARAM_REDUCE_BITS; 0 where the warp filter cannot follow them
 * (wp[2], the divisor, is positive: warp_estimation clamps it to within
 * 8191 of 1 << 16) */
static int setup_shear(const Dec *d, const int32_t *wp, int *abgd) {
    const int64_t one = 1 << WARPEDMODEL_PREC_BITS;
    int64_t alpha = clip64(wp[2] - one, INT16_MIN, INT16_MAX);
    int64_t beta = clip64(wp[3], INT16_MIN, INT16_MAX);
    int shift;
    int64_t div = resolve_divisor(d, wp[2], &shift);
    int64_t gamma = clip64(rnd2s(((int64_t)wp[4] << WARPEDMODEL_PREC_BITS) * div, shift),
                           INT16_MIN, INT16_MAX);
    int64_t delta = clip64(wp[5] - rnd2s((int64_t)wp[3] * wp[4] * div, shift) - one,
                           INT16_MIN, INT16_MAX);
    int64_t v[4] = {alpha, beta, gamma, delta};
    for (int i = 0; i < 4; i++)
        abgd[i] = (int)(rnd2s(v[i], WARP_PARAM_REDUCE_BITS) * (1 << WARP_PARAM_REDUCE_BITS));
    return 4 * abs(abgd[0]) + 7 * abs(abgd[1]) < one && 4 * abs(abgd[2]) + 4 * abs(abgd[3]) < one;
}

/* spec 7.11.3.5 block warp of a w x h plane block at (x, y) from
 * reference ref with the warp wp and its shear abgd, one 8x8 at a time:
 * each output sample's horizontal then vertical Warped_Filters phase from
 * the 8x8 centre's warped position, its fraction's low
 * WARP_PARAM_REDUCE_BITS dropped as libaom and dav1d drop them,
 * InterRound0 and InterRound1 as in the translation loop (clipped pixels,
 * or a compound side's unclipped intermediate), into dst of stride
 * dstride; the reference clamped at its edges */
static void warp_block(Dec *d, int ref, int plane, int x, int y, int w, int h,
                       const int32_t *wp, const int *abgd, int compound, int32_t *dst,
                       int dstride) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    const int32_t *src = d->ref_plane[ref][plane];
    int rs = d->ref_stride[ref];
    int lastx = ((d->ref_w[ref] + sx) >> sx) - 1, lasty = ((d->ref_h[ref] + sy) >> sy) - 1;
    int round0 = d->bd == 12 ? 5 : 3, round1 = inter_round1(d, compound);
    int maxv = (1 << d->bd) - 1;
    const int alpha = abgd[0], beta = abgd[1], gamma = abgd[2], delta = abgd[3];
    int32_t mid[15 * 8];
    for (int i8 = 0; i8 < h; i8 += 8)
        for (int j8 = 0; j8 < w; j8 += 8) {
            int64_t srcx = (int64_t)(x + j8 + 4) << sx, srcy = (int64_t)(y + i8 + 4) << sy;
            int64_t dstx = wp[2] * srcx + wp[3] * srcy + wp[0];
            int64_t dsty = wp[4] * srcx + wp[5] * srcy + wp[1];
            int64_t x4 = dstx >> sx, y4 = dsty >> sy;
            int ix4 = (int)(x4 >> WARPEDMODEL_PREC_BITS), iy4 = (int)(y4 >> WARPEDMODEL_PREC_BITS);
            int sx4 = (int)(x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1));
            int sy4 = (int)(y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1));
            sx4 = (sx4 - 4 * alpha - 4 * beta) & ~((1 << WARP_PARAM_REDUCE_BITS) - 1);
            sy4 = (sy4 - 4 * gamma - 4 * delta) & ~((1 << WARP_PARAM_REDUCE_BITS) - 1);
            int cols[15];
            for (int t = 0; t < 15; t++) cols[t] = imin(imax(ix4 - 7 + t, 0), lastx);
            for (int k = -7; k < 8; k++) {
                const int32_t *row = src + (size_t)imin(imax(iy4 + k, 0), lasty) * rs;
                int p = sx4 + beta * (k + 4);
                for (int l = -4; l < 4; l++, p += alpha) {
                    const int16_t *F = d->warp_filter + 8 * (WARPEDPIXEL_PREC_SHIFTS +
                        ((p + (1 << (WARPEDDIFF_PREC_BITS - 1))) >> WARPEDDIFF_PREC_BITS));
                    int64_t s = 0;
                    for (int t = 0; t < 8; t++) s += (int64_t)F[t] * row[cols[l + 4 + t]];
                    mid[(k + 7) * 8 + l + 4] = (int32_t)rnd2(s, round0);
                }
            }
            for (int k = -4; k < imin(4, h - i8 - 4); k++) {
                int p = sy4 + delta * (k + 4);
                int32_t *out = dst + (size_t)(i8 + k + 4) * dstride + j8;
                for (int l = -4; l < imin(4, w - j8 - 4); l++, p += gamma) {
                    const int16_t *F = d->warp_filter + 8 * (WARPEDPIXEL_PREC_SHIFTS +
                        ((p + (1 << (WARPEDDIFF_PREC_BITS - 1))) >> WARPEDDIFF_PREC_BITS));
                    int64_t s = 0;
                    for (int t = 0; t < 8; t++) s += (int64_t)F[t] * mid[(k + t + 4) * 8 + l + 4];
                    out[l + 4] = pred_out(s, round1, compound, maxv);
                }
            }
        }
}

/* spec 7.11.3.1 useWarp 2: a side of a GLOBALMV or GLOBAL_GLOBALMV
 * block's plane block of 8x8 or more on a reference the global warp may
 * follow (gm_warp) */
static int global_warp(const Dec *d, const Blk *b, int ref, int pw, int ph) {
    return (b->mode == GLOBALMV || b->mode == GLOBAL_GLOBALMV) && d->gm_warp[ref] && pw >= 8 &&
           ph >= 8;
}

/* the block counters of the global warp: a block warped, or one of 8x8 or
 * more whose global side's reference has a GmType past TRANSLATION and a
 * shear setupShear refuses (globalValid 0) */
static void count_global_warp(Dec *d, const Blk *b, int warped) {
    int invalid = 0;
    if ((b->mode == GLOBALMV || b->mode == GLOBAL_GLOBALMV) && imin(b->wl, b->hl) >= 1 &&
        !d->force_int_mv)
        for (int i = 0; i < 1 + (b->ref2 > INTRA_FRAME); i++) {
            int ref = i ? b->ref2 : b->ref;
            invalid |= d->gm_type[ref] > TRANSLATION && !ref_is_scaled(d, ref) && !d->gm_warp[ref];
        }
    if (warped) d->count[T_GLOBAL_WARP]++;
    else if (invalid) d->count[T_GLOBAL_WARP_INVALID]++;
}

/* spec 7.11.3.1 for a compound block (at least 8x8, SIMPLE motion): each
 * plane's two sides predicted unclipped (either through a reference of
 * another scale, or by the global warp, its time in motion_ns[4]), then
 * blended (compound_blend, its time in motion_ns[3]) */
static void predict_compound(Dec *d, Blk *b) {
    static _Thread_local int32_t p0[128 * 128], p1[128 * 128];
    static _Thread_local uint8_t mask[128 * 128];
    int fwd = b->ctype == COMPOUND_DISTANCE ? fwd_weight(d, b) : 0;
    if (ref_is_scaled(d, b->ref) || ref_is_scaled(d, b->ref2)) {
        d->count[T_SCALED_PRED]++;
        d->count[T_COMPOUND_SCALED]++;
    }
    int filt = b->filt[0] | b->filt[1] << 2, warped = 0;
    for (int plane = 0; plane < (b->has_chroma ? d->nplanes : 1) && !d->err; plane++) {
        int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
        int wl4, hl4;
        plane_block(d, b, plane, &wl4, &hl4);
        int pw = 4 << wl4, ph = 4 << hl4;
        int bx = (b->c >> sx) * 4, by = (b->r >> sy) * 4;
        for (int i = 0; i < 2; i++) {
            int ref = i ? b->ref2 : b->ref;
            int32_t *p = i ? p1 : p0;
            if (global_warp(d, b, ref, pw, ph)) {
                warped = 1;
                MOTION_TIMED(4, warp_block(d, ref, plane, bx, by, pw, ph, d->gm_params[ref],
                                           d->gm_abgd[ref], 1, p, pw));
            } else {
                predict_side(d, plane, bx, by, pw, ph, ref, i ? b->mv2 : b->mv, filt, 1, p, pw);
            }
        }
        if (d->err) return;
        MOTION_TIMED(3, compound_blend(d, b, plane, bx, by, pw, ph, p0, p1, mask, fwd));
    }
    count_global_warp(d, b, warped);
}

/* spec 7.11.3.10-11 overlapped motion compensation of the block's w x h
 * plane block at (x0, y0): up to four above neighbours (unless the
 * plane's block is smaller than 8x8), then up to four left ones, each
 * inter neighbour predicted over the overlap with its own MV, reference
 * and filters, then blended in by Obmc_Mask rows (above) or columns
 * (left) with Round2(.., 6) */
static void predict_obmc(Dec *d, const Blk *b, int plane, int x0, int y0, int w, int h) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    static _Thread_local int32_t lap[64 * 64];
    if (b->avail_u && w + h >= 16) {
        int end = imin(d->mi_cols, b->c + (1 << b->wl));
        for (int x4 = b->c, n = 0; n < imin(4, b->wl) && x4 < end && !d->err;) {
            int cr = b->r - 1, cc = imin(x4 | 1, d->mi_cols - 1);
            int m = mi_at(d, cr, cc);
            int step = imin(imax(1 << d->mi_wl[m], 2), 16);
            if (d->mi_ref[m] > INTRA_FRAME) {
                n++;
                int pw = imin(w, (step * 4) >> sx), ph = imin(h >> 1, 32 >> sy);
                int px0 = (x4 * 4) >> sx;
                const int16_t *mask = d->obmc_mask + ph - 1;
                predict_part_to(d, plane, px0, y0, pw, ph, cr, cc, lap, pw);
                for (int i = 0; i < ph; i++) {
                    int32_t *cur = px(d, plane, y0 + i, px0);
                    for (int j = 0; j < pw; j++)
                        cur[j] = (int32_t)rnd2((int64_t)mask[i] * cur[j] + (64 - mask[i]) * lap[i * pw + j], 6);
                }
            }
            x4 += step;
        }
    }
    if (b->avail_l) {
        int end = imin(d->mi_rows, b->r + (1 << b->hl));
        for (int y4 = b->r, n = 0; n < imin(4, b->hl) && y4 < end && !d->err;) {
            int cr = imin(y4 | 1, d->mi_rows - 1), cc = b->c - 1;
            int m = mi_at(d, cr, cc);
            int step = imin(imax(1 << d->mi_hl[m], 2), 16);
            if (d->mi_ref[m] > INTRA_FRAME) {
                n++;
                int pw = imin(w >> 1, 32 >> sx), ph = imin(h, (step * 4) >> sy);
                int py0 = (y4 * 4) >> sy;
                const int16_t *mask = d->obmc_mask + pw - 1;
                predict_part_to(d, plane, x0, py0, pw, ph, cr, cc, lap, pw);
                for (int i = 0; i < ph; i++) {
                    int32_t *cur = px(d, plane, py0 + i, x0);
                    for (int j = 0; j < pw; j++)
                        cur[j] = (int32_t)rnd2((int64_t)mask[j] * cur[j] + (64 - mask[j]) * lap[i * pw + j], 6);
                }
            }
            y4 += step;
        }
    }
}

/* compute_prediction's intra part of an inter-intra block (spec 5.11.33):
 * the plane block (pw x ph at (bx, by)) predicted in the frame by the
 * intra mode of its interintra_mode, with the block's AvailL/AvailU (the
 * chroma ones on chroma) and no angle delta, and kept in ``intra`` */
static void interintra_intra(Dec *d, const Blk *b, int plane, int bx, int by, int pw, int ph,
                             int32_t *intra) {
    static const int MODE[4] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED};
    predict_intra(d, b, plane, bx, by, plane ? b->avail_lc : b->avail_l,
                  plane ? b->avail_uc : b->avail_u, 0, 0, MODE[b->ii_mode],
                  floor_log2((uint32_t)pw), floor_log2((uint32_t)ph), 0);
    for (int i = 0; i < ph; i++)
        memcpy(intra + (size_t)i * pw, px(d, plane, by + i, bx), sizeof(int32_t) * (size_t)pw);
}

/* spec 7.11.3.14's inter-intra blend of the plane block's inter prediction
 * (in the frame, at pixel precision) with its intra prediction: Round2(m *
 * intra + (64 - m) * inter, 6), the mask m the luma block's wedge
 * (WedgeMasks[MiSize][0][wedge_index], subsampled on chroma) or the smooth
 * mask of the plane block's own size (spec 7.11.3.13: 32 for II_DC, else
 * Ii_Weights_1d at the row, the column or the nearer of the two, scaled by
 * 128 / Max(pw, ph)) */
static void interintra_blend(Dec *d, const Blk *b, int plane, int bx, int by, int pw, int ph,
                             const int32_t *intra) {
    int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
    int bw = 4 << b->wl, bh = 4 << b->hl;
    int scale = 128 / imax(pw, ph);
    const int16_t *wedge =
        b->ii_wedge ? d->wedge_mask[b->bsize] + (size_t)b->wedge_idx * bw * bh : NULL;
    for (int i = 0; i < ph; i++) {
        int32_t *out = px(d, plane, by + i, bx);
        for (int j = 0; j < pw; j++) {
            int m;
            if (wedge) {
                const int16_t *mr = wedge + (size_t)(i << sy) * bw + (j << sx);
                m = mr[0];
                if (sx && sy) m = (int)rnd2(m + mr[1] + mr[bw] + mr[bw + 1], 2);
                else if (sx) m = (int)rnd2(m + mr[1], 1);
                else if (sy) m = (int)rnd2(m + mr[bw], 1);
            } else if (b->ii_mode == II_V_PRED) {
                m = d->ii_weights[i * scale];
            } else if (b->ii_mode == II_H_PRED) {
                m = d->ii_weights[j * scale];
            } else if (b->ii_mode == II_SMOOTH_PRED) {
                m = d->ii_weights[imin(i, j) * scale];
            } else {
                m = 32;
            }
            out[j] = (int32_t)rnd2((int64_t)m * intra[(size_t)i * pw + j] + (int64_t)(64 - m) * out[j], 6);
        }
    }
}

/* spec 7.11.3.1 for an inter block: each plane's block at the block's MV
 * (or warped: by its local warp, or by the global motion of a GLOBALMV
 * block's reference, its time in motion_ns[4]); the chroma of a block
 * narrower or shorter than 8 in a subsampled direction covers the blocks
 * before it, each part predicted with its own block's MV, reference and
 * filters, unless one of them is intra (someUseIntra); an inter-intra
 * block's plane block blended with its intra prediction (its time in
 * motion_ns[5]) */
static void predict_inter(Dec *d, Blk *b) {
    static _Thread_local int32_t intra_part[32 * 32];
    if (b->ref2 > INTRA_FRAME) {
        predict_compound(d, b);
        return;
    }
    if (ref_is_scaled(d, b->ref)) d->count[T_SCALED_PRED]++;
    /* spec 7.11.3.1: LocalValid and the shear once, at plane 0 */
    int32_t wp[6];
    int abgd[4], warp = 0, warped = 0;
    if (b->motion_mode == LOCALWARP) {
        d->count[T_LOCAL_WARP]++;
        MOTION_TIMED(1, warp = warp_estimation(d, b, wp) && setup_shear(d, wp, abgd));
        if (!warp) d->count[T_LOCAL_WARP_INVALID]++;
    } else if (b->motion_mode == OBMC) {
        d->count[T_OBMC]++;
    }
    for (int plane = 0; plane < (b->has_chroma ? d->nplanes : 1) && !d->err; plane++) {
        int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
        int wl4, hl4;
        plane_block(d, b, plane, &wl4, &hl4);
        int pw = 4 << wl4, ph = 4 << hl4;
        int bx = (b->c >> sx) * 4, by = (b->r >> sy) * 4;
        int cr = (b->r >> sy) << sy, cc = (b->c >> sx) << sx;
        int predw = (4 << b->wl) >> sx, predh = (4 << b->hl) >> sy;
        int intra = 0;
        for (int i = 0; i < ((ph >> 2) << sy); i++)
            for (int j = 0; j < ((pw >> 2) << sx); j++)
                if (d->mi_ref[mi_at(d, imin(cr + i, d->mi_rows - 1), imin(cc + j, d->mi_cols - 1))] ==
                    INTRA_FRAME)
                    intra = 1;
        if (intra) {
            predw = pw;
            predh = ph;
            cr = b->r;
            cc = b->c;
        }
        if (plane == 1 && (predw < pw || predh < ph)) d->count[T_SUB8X8_CHROMA_MVS]++;
        if (b->ii) MOTION_TIMED(5, interintra_intra(d, b, plane, bx, by, pw, ph, intra_part));
        /* a warp needs a plane block of 8x8 at least (useWarp) */
        if (warp && pw >= 8 && ph >= 8) {
            MOTION_TIMED(1, warp_block(d, b->ref, plane, bx, by, pw, ph, wp, abgd, 0,
                                       px(d, plane, by, bx), d->stride));
            continue;
        }
        if (global_warp(d, b, b->ref, pw, ph)) {
            warped = 1;
            MOTION_TIMED(4, warp_block(d, b->ref, plane, bx, by, pw, ph, d->gm_params[b->ref],
                                       d->gm_abgd[b->ref], 0, px(d, plane, by, bx), d->stride));
        } else {
            for (int y = 0, i = 0; y < ph; y += predh, i++)
                for (int x = 0, j = 0; x < pw; x += predw, j++)
                    predict_part(d, plane, bx + x, by + y, predw, predh, cr + i, cc + j);
        }
        if (b->motion_mode == OBMC) MOTION_TIMED(0, predict_obmc(d, b, plane, bx, by, pw, ph));
        if (b->ii) MOTION_TIMED(5, interintra_blend(d, b, plane, bx, by, pw, ph, intra_part));
    }
    count_global_warp(d, b, warped);
}

static void decode_block(Dec *d, int r, int c, int wl, int hl) {
    Blk blk;
    Blk *b = &blk;
    b->r = r; b->c = c; b->wl = wl; b->hl = hl;
    b->bsize = BSIZE_OF[wl][hl];
    if (b->bsize < 0) {
        fail(d, AV1D_CORRUPT, "AV1: %s", "bad block size");
        return;
    }
    int w4 = 1 << wl, h4 = 1 << hl;
    /* spec decode_block: HasChroma and AvailU/LChroma */
    if (d->nplanes == 1) b->has_chroma = 0;
    else if (d->ssy && h4 == 1 && !(r & 1)) b->has_chroma = 0;
    else if (d->ssx && w4 == 1 && !(c & 1)) b->has_chroma = 0;
    else b->has_chroma = 1;
    if (b->has_chroma && ((d->ssx && w4 == 1) || (d->ssy && h4 == 1)))
        d->count[T_CHROMA_OF_4XN]++;
    b->avail_u = is_inside(d, r - 1, c);
    b->avail_l = is_inside(d, r, c - 1);
    b->avail_uc = b->avail_lc = 0;
    b->ref2 = NONE_FRAME;
    b->mv2[0] = b->mv2[1] = 0;
    b->cgi = 0;
    b->cidx = 1;
    b->skip_mode = 0;
    b->ii = 0;
    if (b->has_chroma) {
        b->avail_uc = (d->ssy && h4 == 1) ? is_inside(d, r - 2, c) : b->avail_u;
        b->avail_lc = (d->ssx && w4 == 1) ? is_inside(d, r, c - 2) : b->avail_l;
    }
    if (d->inter_frame) inter_frame_mode_info(d, b);
    else intra_mode_info(d, b);
    if (d->err) return;
    palette_tokens(d, b);
    if (d->err) return;
    block_tx_size(d, b);
    if (d->err) return;
    filter_types(d, b);
    if (b->skip)
        for (int p = 0; p < (b->has_chroma ? d->nplanes : 1); p++) {
            int sx = p ? d->ssx : 0, sy = p ? d->ssy : 0;
            int a0 = c >> sx, a1 = (c + w4) >> sx, l0 = r >> sy, l1 = (r + h4) >> sy;
            memset(d->above_lvl[p] + a0, 0, (size_t)(a1 - a0));
            memset(d->above_dc[p] + a0, 0, (size_t)(a1 - a0));
            memset(d->left_lvl[p] + l0, 0, (size_t)(l1 - l0));
            memset(d->left_dc[p] + l0, 0, (size_t)(l1 - l0));
        }
    int uvm = b->has_chroma ? b->uvmode : DC_PRED;
    int ref = b->is_inter ? b->ref : INTRA_FRAME;
    /* deblocking's RefFrame and mode delta (spec 7.14.4), and whether
     * transform edges inside the block are left alone (skip && is_inter) */
    int mode_type = ref > INTRA_FRAME && b->mode != GLOBALMV && b->mode != GLOBAL_GLOBALMV;
    int ref2 = b->is_inter ? b->ref2 : NONE_FRAME;
    int newmv = ref > INTRA_FRAME && (side_mode(b->mode, 0) == NEWMV ||
                                      (ref2 > INTRA_FRAME && side_mode(b->mode, 1) == NEWMV));
    uint8_t lf = (uint8_t)(ref * 2 + mode_type + ((b->skip && b->is_inter) << 4));
    int gmv = ref > INTRA_FRAME && !mode_type && imin(wl, hl) >= 1;
    if (ref > INTRA_FRAME && d->lf_delta_enabled && d->lf_on) {
        if (d->lf_ref_deltas[ref]) d->count[T_LF_REF_DELTA]++;
        if (d->lf_mode_deltas[mode_type]) d->count[T_LF_MODE_DELTA]++;
    }
    for (int y = 0; y < h4 && r + y < d->mi_rows; y++)
        for (int x = 0; x < w4 && c + x < d->mi_cols; x++) {
            int m = mi_at(d, r + y, c + x);
            d->mi_wl[m] = (uint8_t)wl;
            d->mi_hl[m] = (uint8_t)hl;
            d->mi_skip[m] = (uint8_t)b->skip;
            d->mi_ymode[m] = (uint8_t)b->ymode;
            d->mi_uvmode[m] = (uint8_t)uvm;
            d->mi_inter[m] = (uint8_t)b->is_inter;
            d->mi_mv[2 * m] = (int16_t)(b->is_inter ? b->mv[0] : 0);
            d->mi_mv[2 * m + 1] = (int16_t)(b->is_inter ? b->mv[1] : 0);
            d->mi_ref2[m] = (int8_t)ref2;
            d->mi_mv2[2 * m] = (int16_t)(ref2 > INTRA_FRAME ? b->mv2[0] : 0);
            d->mi_mv2[2 * m + 1] = (int16_t)(ref2 > INTRA_FRAME ? b->mv2[1] : 0);
            d->mi_cgi[m] = (uint8_t)b->cgi;
            d->mi_cidx[m] = (uint8_t)b->cidx;
            d->mi_gmv[m] = (uint8_t)gmv;
            d->mi_skip_mode[m] = (uint8_t)b->skip_mode;
            d->mi_paln[m] = (uint8_t)b->pal_n;
            if (b->pal_n) memcpy(d->mi_pal + (size_t)m * 8, b->pal, sizeof(b->pal));
            d->mi_paln_uv[m] = (uint8_t)b->pal_uv_n;
            if (b->pal_uv_n)
                memcpy(d->mi_pal_u + (size_t)m * 8, b->pal_u, sizeof(b->pal_u));
            for (int i = 0; i < 4; i++) d->mi_dlf[4 * (size_t)m + i] = (int8_t)d->delta_lf[i];
            d->mi_seg[m] = (uint8_t)d->seg_id;
            d->mi_ref[m] = (int8_t)ref;
            d->mi_newmv[m] = (uint8_t)newmv;
            d->mi_filt[m] = (uint8_t)(ref > INTRA_FRAME ? b->filt[0] | b->filt[1] << 2 : 0);
            d->mi_lf[m] = lf;
            d->mi_bsz[m] = (uint8_t)(wl | hl << 4);
        }
    if (d->bd == 12) d->count[T_TWELVE_BIT]++;
    b->max_luma_w = b->max_luma_h = 0;
    if (b->is_inter && d->inter_frame) predict_inter(d, b);
    else if (b->is_inter) predict_intrabc(d, b);
    if (d->err) return;
    residual(d, b);
}

static void decode_partition(Dec *d, int r, int c, int bl /* log2 w4 */) {
    if (r >= d->mi_rows || c >= d->mi_cols || d->err) return;
    int avail_u = is_inside(d, r - 1, c), avail_l = is_inside(d, r, c - 1);
    int n4 = 1 << bl, half = n4 >> 1, quarter = half >> 1;
    int has_rows = (r + half) < d->mi_rows;
    int has_cols = (c + half) < d->mi_cols;
    int part;
    if (bl == 0) {
        part = 0;
    } else {
        static const int CDF_OF[6] = {-1, D_PART8, D_PART16, D_PART32, D_PART64, D_PART128};
        static const int NSYM[6] = {0, 4, 10, 10, 10, 8};
        int nsym = NSYM[bl];
        int above = avail_u && d->mi_wl[mi_at(d, r - 1, c)] < bl;
        int left = avail_l && d->mi_hl[mi_at(d, r, c - 1)] < bl;
        uint16_t *cdf = d->cdf[CDF_OF[bl]] + (size_t)(left * 2 + above) * (nsym + 1);
        if (has_rows && has_cols) {
            part = read_symbol(d, cdf, nsym);
        } else if (has_cols || has_rows) {
            static const int HORZ_M[6] = {2, 3, 4, 6, 7, 9};
            static const int VERT_M[6] = {1, 3, 4, 5, 6, 8};
            const int *mem = has_cols ? HORZ_M : VERT_M;
            uint32_t psum = 0;
            for (int i = 0; i < 6; i++) {
                int s = mem[i];
                if (s >= nsym) continue;
                uint32_t prev = s ? cdf[s - 1] : 32768;
                psum += prev - cdf[s];
            }
            uint16_t derived[2] = {(uint16_t)psum, 0};
            int split = read_symbol_na(d, derived, 2);
            part = split ? 3 : (has_cols ? 1 : 2);
        } else {
            part = 3;
        }
    }
    if (part >= 4) d->count[T_PART_HORZ_A + part - 4]++;
    switch (part) {
        case 0: /* NONE */
            decode_block(d, r, c, bl, bl);
            break;
        case 1: /* HORZ */
            decode_block(d, r, c, bl, bl - 1);
            if (has_rows) decode_block(d, r + half, c, bl, bl - 1);
            break;
        case 2: /* VERT */
            decode_block(d, r, c, bl - 1, bl);
            if (has_cols) decode_block(d, r, c + half, bl - 1, bl);
            break;
        case 3: /* SPLIT */
            if (bl == 1) {
                decode_partition(d, r, c, 0);
                decode_partition(d, r, c + 1, 0);
                decode_partition(d, r + 1, c, 0);
                decode_partition(d, r + 1, c + 1, 0);
            } else {
                decode_partition(d, r, c, bl - 1);
                decode_partition(d, r, c + half, bl - 1);
                decode_partition(d, r + half, c, bl - 1);
                decode_partition(d, r + half, c + half, bl - 1);
            }
            break;
        case 4: /* HORZ_A */
            decode_block(d, r, c, bl - 1, bl - 1);
            decode_block(d, r, c + half, bl - 1, bl - 1);
            decode_block(d, r + half, c, bl, bl - 1);
            break;
        case 5: /* HORZ_B */
            decode_block(d, r, c, bl, bl - 1);
            decode_block(d, r + half, c, bl - 1, bl - 1);
            decode_block(d, r + half, c + half, bl - 1, bl - 1);
            break;
        case 6: /* VERT_A */
            decode_block(d, r, c, bl - 1, bl - 1);
            decode_block(d, r + half, c, bl - 1, bl - 1);
            decode_block(d, r, c + half, bl - 1, bl);
            break;
        case 7: /* VERT_B */
            decode_block(d, r, c, bl - 1, bl);
            decode_block(d, r, c + half, bl - 1, bl - 1);
            decode_block(d, r + half, c + half, bl - 1, bl - 1);
            break;
        case 8: /* HORZ_4 */
            for (int i = 0; i < 4; i++)
                if (i < 3 || r + quarter * 3 < d->mi_rows)
                    decode_block(d, r + quarter * i, c, bl, bl - 2);
            break;
        case 9: /* VERT_4 */
            for (int i = 0; i < 4; i++)
                if (i < 3 || c + quarter * 3 < d->mi_cols)
                    decode_block(d, r, c + quarter * i, bl - 2, bl);
            break;
    }
}

/* ---- loop restoration units (spec 5.11.57-58) ----------------------------- */

static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
}

static int decode_subexp_bool(Dec *d, int num_syms, int k) {
    int i = 0, mk = 0;
    for (;;) {
        int b2 = i ? k + i - 1 : k;
        int a = 1 << b2;
        if (num_syms <= mk + 3 * a) return read_ns(d, num_syms - mk) + mk;
        if (read_literal(d, 1)) { i++; mk += a; }
        else return read_literal(d, b2) + mk;
    }
}

static int decode_signed_subexp_ref(Dec *d, int low, int high, int k, int r) {
    int mx = high - low;
    r -= low;
    int v = decode_subexp_bool(d, mx, k);
    int x = (r << 1) <= mx ? inverse_recenter(r, v)
                           : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
}

static void read_lr_unit(Dec *d, int plane, int ur, int uc) {
    int ftype = d->lr_type[plane];
    int kind;
    if (ftype == 2) kind = read_symbol(d, d->cdf[D_WIENER], 2) ? 1 : 0;
    else if (ftype == 3) kind = read_symbol(d, d->cdf[D_SGR], 2) ? 2 : 0;
    else kind = read_symbol(d, d->cdf[D_SWITCHABLE], 3);
    int32_t *e = d->lr_out +
                 (((size_t)plane * d->lr_rstride + ur) * d->lr_cstride + uc) * 7;
    memset(e, 0, 7 * sizeof(int32_t));
    e[0] = kind;
    if (kind == 1) {
        for (int pass = 0; pass < 2; pass++) {
            int first = plane ? 1 : 0;
            for (int j = first; j < 3; j++) {
                int v = decode_signed_subexp_ref(d, WIENER_MIN[j], WIENER_MAX[j] + 1,
                                                 WIENER_K[j], d->lr_ref[plane][pass][j]);
                e[1 + pass * 3 + j] = v;
                d->lr_ref[plane][pass][j] = v;
            }
        }
    } else if (kind == 2) {
        int set = read_literal(d, 4);
        e[1] = set;
        /* Sgr_Params radii: sets 10-13 have r0 = 0, sets 14-15 r1 = 0 */
        int radius[2] = {!(set >= 10 && set <= 13), set < 14};
        for (int i = 0; i < 2; i++) {
            int v;
            if (radius[i]) {
                v = decode_signed_subexp_ref(d, SGRPROJ_XQD_MIN[i], SGRPROJ_XQD_MAX[i] + 1,
                                             4, d->lr_sgr_ref[plane][i]);
            } else {
                v = 0;
                if (i == 1)
                    v = (int)clip64((1 << 7) - d->lr_sgr_ref[plane][0],
                                    SGRPROJ_XQD_MIN[1], SGRPROJ_XQD_MAX[1]);
            }
            e[2 + i] = v;
            d->lr_sgr_ref[plane][i] = v;
        }
    }
}

/* spec read_lr: the units whose first row and column lie in this
 * superblock; under superres the unit grid is the upscaled frame's, so a
 * coded column stands for SuperresDenom / 8 of them */
static void read_lr(Dec *d, int r, int c) {
    for (int plane = 0; plane < d->nplanes; plane++) {
        if (!d->lr_type[plane]) continue;
        int sx = plane ? d->ssx : 0, sy = plane ? d->ssy : 0;
        int unit = d->lr_unit[plane];
        int ur0 = (r * (4 >> sy) + unit - 1) / unit;
        int ur1 = imin(d->lr_urows[plane], ((r + d->sb4) * (4 >> sy) + unit - 1) / unit);
        int num = (4 >> sx) * d->superres_denom, den = unit * 8;
        int uc0 = (c * num + den - 1) / den;
        int uc1 = imin(d->lr_ucols[plane], ((c + d->sb4) * num + den - 1) / den);
        for (int ur = ur0; ur < ur1; ur++)
            for (int uc = uc0; uc < uc1; uc++) read_lr_unit(d, plane, ur, uc);
    }
}

/* ---- tiles and frame ------------------------------------------------------ */

static void decode_tile(Dec *d) {
    memset(d->delta_lf, 0, sizeof(d->delta_lf));
    memset(d->above_segpred, 0, (size_t)d->mi_cols + 32);
    memset(d->left_segpred, 0, (size_t)d->mi_rows + 32);
    for (int p = 0; p < d->nplanes; p++) {
        memset(d->above_lvl[p], 0, (size_t)d->mi_cols + 32);
        memset(d->above_dc[p], 0, (size_t)d->mi_cols + 32);
        for (int pass = 0; pass < 2; pass++) {
            d->lr_sgr_ref[p][pass] = SGRPROJ_XQD_MID[pass];
            for (int i = 0; i < 3; i++) d->lr_ref[p][pass][i] = WIENER_MID[i];
        }
    }
    int sb4 = d->sb4;
    for (int r = d->r0; r < d->r1 && !d->err; r += sb4) {
        for (int p = 0; p < d->nplanes; p++) {
            memset(d->left_lvl[p], 0, (size_t)d->mi_rows + 32);
            memset(d->left_dc[p], 0, (size_t)d->mi_rows + 32);
        }
        for (int c = d->c0; c < d->c1 && !d->err; c += sb4) {
            /* clear_cdef */
            for (int y = r; y < r + sb4; y += 16)
                for (int x = c; x < c + sb4; x += 16)
                    if ((y >> 4) < (d->mi_rows + 15) / 16 && (x >> 4) < d->cdef_stride)
                        d->cdef_idx[(size_t)(y >> 4) * d->cdef_stride + (x >> 4)] = -1;
            /* clear_block_decoded_flags */
            for (int p = 0; p < d->nplanes; p++) {
                int sx = p ? d->ssx : 0, sy = p ? d->ssy : 0;
                int sbw4 = (d->c1 - c) >> sx, sbh4 = (d->r1 - r) >> sy;
                for (int y = -1; y <= (sb4 >> sy); y++)
                    for (int x = -1; x <= (sb4 >> sx); x++) {
                        uint8_t v;
                        if (y < 0 && x < sbw4) v = 1;
                        else if (x < 0 && y < sbh4) v = 1;
                        else v = 0;
                        d->decoded[p][y + 1][x + 1] = v;
                    }
                d->decoded[p][(sb4 >> sy) + 1][0] = 0;
            }
            read_lr(d, r, c);
            d->read_deltas = d->delta_q_res >= 0;
            decode_partition(d, r, c, d->sb128 ? 5 : 4);
        }
    }
}

/* ---- motion field estimation and motion vector storage (spec 7.9, 7.19) -- */

/* spec project (7.9.2's get_block_position): v8 moved by delta (1/8
 * sample) in 8x8 units, rounded toward zero, the way sign says; -1 where
 * that leaves the frame (max8) or the 64 pixels of v8's own 64x64 plus
 * max_off 8x8s either side */
static int mf_position(int v8, int delta, int sign, int max8, int max_off) {
    int base = (v8 >> 3) << 3;
    int off = delta >= 0 ? delta >> 6 : -((-delta) >> 6);
    v8 += sign * off;
    if (v8 < 0 || v8 >= max8 || v8 < base - max_off || v8 >= base + 8 + max_off) return -1;
    return v8;
}

/* spec 7.9.2 (libaom motion_field_projection, dav1d load_tmvs) for one
 * source frame of the frame's size: each 8x8 whose saved MV points to a
 * reference before the source (off[ref], that distance, not 0) moves by
 * that MV scaled to the distance from the source to this frame (num, the
 * sign of LAST and LAST2 folded in, sign -1 for them) and, where it lands
 * inside the limits, leaves there the MV and the distance; the later of
 * two landings on one 8x8 wins */
static void mf_project(Dec *d, const int8_t *src_ref, const int16_t *src_mv, int sign, int num,
                       const int32_t *off) {
    int h8 = d->mi_rows >> 1, w8 = d->mi_cols >> 1;
    for (int y = 0; y < h8; y++)
        for (int x = 0; x < w8; x++) {
            size_t i = (size_t)y * w8 + x;
            int rf = src_ref[i];
            if (rf <= INTRA_FRAME || !off[rf]) continue;
            int mv[2];
            mv_projection(d, src_mv + 2 * i, num, off[rf], mv);
            int row = mf_position(y, mv[0], sign, h8, MAX_OFFSET_HEIGHT);
            int col = mf_position(x, mv[1], sign, w8, MAX_OFFSET_WIDTH);
            if (row < 0 || col < 0) continue;
            size_t j = (size_t)row * w8 + col;
            d->tpl_mv[2 * j] = src_mv[2 * i];
            d->tpl_mv[2 * j + 1] = src_mv[2 * i + 1];
            d->tpl_off[j] = (int8_t)off[rf];
        }
}

/* spec 7.19 (libaom av1_copy_frame_mvs, dav1d save_tmvs): for each 8x8,
 * the reference and MV of the block at its odd 4x4 (its last) of the
 * later of its two lists whose reference is one of the store mask's
 * (before the frame in order) and whose MV is within REFMVS_LIMIT; else
 * reference 0 (none) */
static void mf_store(const Dec *d, int mask, int8_t *refs, int16_t *mvs) {
    int h8 = d->mi_rows >> 1, w8 = d->mi_cols >> 1;
    for (int y = 0; y < h8; y++)
        for (int x = 0; x < w8; x++) {
            size_t i = (size_t)y * w8 + x;
            int m = mi_at(d, 2 * y + 1, 2 * x + 1);
            refs[i] = 0;
            mvs[2 * i] = mvs[2 * i + 1] = 0;
            for (int list = 0; list < 2; list++) {
                int rf = list ? d->mi_ref2[m] : d->mi_ref[m], mv[2];
                mi_mv_of(d, m, list, mv);
                if (rf > INTRA_FRAME && (mask >> rf & 1) && abs(mv[0]) <= REFMVS_LIMIT &&
                    abs(mv[1]) <= REFMVS_LIMIT) {
                    refs[i] = (int8_t)rf;
                    mvs[2 * i] = (int16_t)mv[0];
                    mvs[2 * i + 1] = (int16_t)mv[1];
                }
            }
        }
}

/* tiles[i] / tile_sizes[i] in tile order (row-major); tile_starts =
 * mi_col_starts[tile_cols + 1] then mi_row_starts[tile_rows + 1]. Planes
 * are int32 buffers of (rows >= sb-aligned height) x stride, the chroma
 * ones used at their subsampled size. Outputs: txmaps (one uint8 map of
 * mi_rows x mi_cols per plane, the chroma ones filled at their
 * subsampled size), skips (mi_rows x mi_cols), cdef_idx
 * (ceil(mi_rows / 16) x ceil(mi_cols / 16), -1 where every block is
 * skipped), delta_lf (mi_rows x mi_cols x 4: the DeltaLF of y vertical,
 * y horizontal, u and v), segs (mi_rows x mi_cols: each block's
 * segment_id), the restoration units (per plane, row and column, strides
 * H_LR_RSTRIDE x H_LR_CSTRIDE: kind 0 none / 1 Wiener / 2 SGR, then 6
 * taps or set, xqd0, xqd1) and the tool counters (T_NCOUNTERS). prev_segs
 * is PrevSegmentIds (mi_rows x mi_cols, the primary reference frame's
 * SegmentIds where it is of the frame's MiRows and MiCols), or NULL for
 * zeros. Where
 * motion_ns (six int64) is not NULL, it gains the nanoseconds spent in
 * OBMC's neighbour predictions and blends ([0]), in the local warp, its
 * estimation, shear and block warps ([1]), in motion field estimation
 * ([2]), in compound blocks' masks and blends ([3]), in the block
 * warps of global motion ([4]) and in inter-intra's intra predictions and
 * blends ([5]).
 * Returns 0, or 1 (corrupt stream) with msg set.
 *
 * Motion field estimation (spec 7.9): mf = [the store mask (bit ref for
 * each reference before the frame in order), the projections n (at most
 * MFMV_STACK_SIZE), then for each reference frame 0..7 the distance from
 * the frame to it, then per projection k at 10 + 10 * k: its sign (-1 for
 * LAST and LAST2, else 1), the distance from its source to the frame (of
 * that sign), and for each reference frame 0..7 of the source the
 * distance from the source to it (0 where it is not before the source
 * within MAX_FRAME_DISTANCE)]; mf_src_refs[k] and mf_src_mvs[k] are the
 * source's saved references and MVs (an int8 and two int16 per 8x8,
 * mi_rows / 2 x mi_cols / 2, the frame's size). Where use_ref_frame_mvs
 * is set the projections run before the tiles, their ns into
 * motion_ns[2]. At the end mf_refs and mf_mvs get the frame's own
 * (mf_store). */
int av1_decode_frame(const uint8_t *const *tiles, const int64_t *tile_sizes,
                     const int32_t *hdr, const int32_t *tile_starts,
                     uint16_t *const *cdfs, const int64_t *cdf_lens,
                     const int32_t *const *scans, const int32_t *const *smw,
                     const int32_t *dr, const int32_t *fi_taps,
                     const int32_t *qlut, const uint8_t *qm,
                     int32_t *const *planes, int stride,
                     uint8_t *const *txmaps, uint8_t *skips, int8_t *cdef_idx,
                     int8_t *delta_lf, uint8_t *segs, const uint8_t *prev_segs,
                     int32_t *lr_out, int32_t *counts,
                     const int32_t *const *refs, const int32_t *ref_info,
                     const int16_t *inter_tables, uint16_t *cdf_out, uint8_t *mi_lf,
                     uint8_t *mi_bsz, int64_t *motion_ns, const int32_t *mf,
                     const int8_t *const *mf_src_refs, const int16_t *const *mf_src_mvs,
                     int8_t *mf_refs, int16_t *mf_mvs, char *msg, int msglen) {
    Dec *d = (Dec *)calloc(1, sizeof(Dec));
    if (!d) return AV1D_CORRUPT;
    int rc = AV1D_OK;
    d->msg = msg;
    d->msglen = msglen;
    d->motion_ns = motion_ns;
    d->mi_rows = hdr[H_MI_ROWS];
    d->mi_cols = hdr[H_MI_COLS];
    d->nplanes = hdr[H_NPLANES];
    d->bd = hdr[H_BITDEPTH];
    d->sb128 = hdr[H_SB128];
    d->sb4 = d->sb128 ? 32 : 16;
    d->base_q = hdr[H_BASE_Q];
    d->lossless = d->coded_lossless = hdr[H_LOSSLESS];
    d->txq = d->base_q;
    d->seg_enabled = hdr[H_SEG_ENABLED];
    d->seg_preskip = hdr[H_SEG_PRESKIP];
    d->seg_last = hdr[H_SEG_LAST_ACTIVE];
    d->seg_altq_mask = hdr[H_SEG_ALT_Q_MASK];
    for (int i = 0; i < 8; i++) d->seg_altq[i] = hdr[H_SEG_ALT_Q0 + i];
    d->seg_lossless_mask = hdr[H_SEG_LOSSLESS_MASK];
    d->seg_skip_mask = hdr[H_SEG_SKIP_MASK];
    d->seg_altlf_mask = (uint32_t)hdr[H_SEG_ALT_LF_MASK];
    d->seg_update_map = hdr[H_SEG_UPDATE_MAP];
    d->seg_temporal = hdr[H_SEG_TEMPORAL];
    d->prev_seg = prev_segs;
    if (d->seg_enabled && !d->seg_update_map) counts[T_SEG_MAP_KEPT]++;
    if (d->seg_enabled && d->seg_update_map && d->seg_temporal) counts[T_SEG_TEMPORAL]++;
    d->tx_mode = hdr[H_TX_MODE];
    d->reduced_tx_set = hdr[H_REDUCED_TX_SET];
    d->screen_tools = hdr[H_SCREEN_TOOLS];
    d->filter_intra = hdr[H_FILTER_INTRA];
    d->cdef_on = hdr[H_CDEF_ON];
    d->cdef_bits = hdr[H_CDEF_BITS];
    d->no_adapt = hdr[H_DISABLE_CDF_UPDATE];
    d->ssx = hdr[H_SS_X];
    d->ssy = hdr[H_SS_Y];
    d->edge_filter = hdr[H_EDGE_FILTER];
    d->width = hdr[H_WIDTH];
    d->height = hdr[H_HEIGHT];
    d->allow_intrabc = hdr[H_ALLOW_INTRABC];
    d->inter_frame = hdr[H_FRAME_TYPE] & 1;
    d->allow_hp = hdr[H_ALLOW_HP];
    d->force_int_mv = hdr[H_FORCE_INTEGER_MV];
    d->interp_filter = hdr[H_INTERP_FILTER];
    d->motion_switchable = hdr[H_MOTION_SWITCHABLE];
    d->use_ref_mvs = hdr[H_USE_REF_FRAME_MVS];
    d->reference_select = hdr[H_REFERENCE_SELECT];
    d->allow_warped = hdr[H_ALLOW_WARPED];
    d->dual_filter = hdr[H_DUAL_FILTER];
    d->interintra_on = hdr[H_INTERINTRA];
    d->sign_bias = hdr[H_SIGN_BIAS];
    d->lf_delta_enabled = hdr[H_LF_DELTA_ENABLED];
    d->lf_on = hdr[H_LF_Y0] || hdr[H_LF_Y1];
    d->lf_ref_deltas[0] = hdr[H_LF_REF_DELTA_INTRA];
    for (int i = 1; i < 8; i++) d->lf_ref_deltas[i] = hdr[H_LF_REF_DELTA1 + i - 1];
    d->lf_mode_deltas[0] = hdr[H_LF_MODE_DELTA0];
    d->lf_mode_deltas[1] = hdr[H_LF_MODE_DELTA1];
    d->seg_ref_mask = hdr[H_SEG_REF_MASK];
    d->seg_ref_frames = hdr[H_SEG_REF_FRAMES];
    d->seg_gmv_mask = hdr[H_SEG_GLOBALMV_MASK];
    d->masked_compound = hdr[H_MASKED_COMPOUND];
    d->jnt_comp = hdr[H_JNT_COMP];
    d->qdist_weight = inter_tables + TAB_QDIST_WEIGHT;
    d->qdist_lookup = inter_tables + TAB_QDIST_LOOKUP;
    d->ii_weights = inter_tables + TAB_II_WEIGHTS;
    {
        const int16_t *w = inter_tables + TAB_WEDGE;
        for (int bs = 0; bs < 22; bs++) {
            if (!has_wedge(bs)) continue;
            d->wedge_mask[bs] = w;
            for (int wl = 0; wl < 6; wl++)
                for (int hl = 0; hl < 6; hl++)
                    if (BSIZE_OF[wl][hl] == bs) w += (size_t)2 * 16 * (4 << wl) * (4 << hl);
        }
    }
    d->subpel = inter_tables + TAB_SUBPEL;
    d->warp_filter = inter_tables + TAB_WARP;
    d->div_lut = inter_tables + TAB_DIV_LUT;
    d->obmc_mask = inter_tables + TAB_OBMC;
    d->div_mult = inter_tables + TAB_DIV_MULT;
    d->skip_mode_present = hdr[H_SKIP_MODE_PRESENT];
    d->skip_mode_frame[0] = hdr[H_SKIP_MODE_FRAME0];
    d->skip_mode_frame[1] = hdr[H_SKIP_MODE_FRAME1];
    for (int rf = 0; rf < 8; rf++) d->cur_off[rf] = mf[2 + rf];
    for (int rf = 1; rf < 8 && refs; rf++) {
        for (int p = 0; p < 3; p++) d->ref_plane[rf][p] = refs[(rf - 1) * 3 + p];
        d->ref_stride[rf] = ref_info[(rf - 1) * 3];
        d->ref_w[rf] = ref_info[(rf - 1) * 3 + 1];
        d->ref_h[rf] = ref_info[(rf - 1) * 3 + 2];
        d->xscale[rf] = d->yscale[rf] = NO_SCALE;
        if (!d->ref_plane[rf][0]) continue;
        /* spec 7.11.3.3's limits on a reference's size (RefUpscaledWidth
         * against FrameWidth, the coded width), which also bound
         * predict_scaled's intermediate rows */
        if (2 * d->width < d->ref_w[rf] || 2 * d->height < d->ref_h[rf] ||
            d->width > 16 * d->ref_w[rf] || d->height > 16 * d->ref_h[rf]) {
            snprintf(msg, (size_t)msglen,
                     "AV1: a reference frame of %dx%d for a frame of %dx%d, "
                     "beyond the 2x and 16x scaling limits",
                     d->ref_w[rf], d->ref_h[rf], d->width, d->height);
            free(d);
            return AV1D_CORRUPT;
        }
        d->xscale[rf] = ref_scale(d->ref_w[rf], d->width);
        d->yscale[rf] = ref_scale(d->ref_h[rf], d->height);
    }
    /* global motion: each reference's parameters, and whether its warp is
     * allowed (spec 7.11.3.1's globalValid from setupShear, and useWarp's
     * other conditions that hold for the whole frame) */
    for (int rf = 1; rf < 8; rf++) {
        d->gm_type[rf] = hdr[H_GM_TYPE1 + rf - 1];
        for (int i = 0; i < 6; i++) d->gm_params[rf][i] = hdr[H_GM1_0 + 6 * (rf - 1) + i];
        d->gm_warp[rf] = d->gm_type[rf] > TRANSLATION && !d->force_int_mv &&
                         setup_shear(d, d->gm_params[rf], d->gm_abgd[rf]) &&
                         refs && d->ref_plane[rf][0] && !ref_is_scaled(d, rf);
    }
    if (d->inter_frame) counts[T_INTER_FRAME]++;
    d->dc_lut = qlut;
    d->ac_lut = qlut + 256;
    for (int i = 0; i < 5; i++) d->dq[i] = hdr[H_DQ_Y_DC + i];
    d->delta_q_res = hdr[H_DELTA_Q_RES];
    d->delta_lf_res = hdr[H_DELTA_LF_RES];
    d->delta_lf_multi = hdr[H_DELTA_LF_MULTI];
    d->qm = qm;
    d->mi_dlf = delta_lf;
    for (int p = 0; p < 3; p++) {
        d->qm_level[p] = qm ? hdr[H_QM_Y + p] : QM_FLAT;
        d->lr_type[p] = hdr[H_LR_TYPE0 + p];
        d->lr_unit[p] = hdr[H_LR_UNIT0 + p];
        d->lr_urows[p] = hdr[H_LR_UROWS0 + p];
        d->lr_ucols[p] = hdr[H_LR_UCOLS0 + p];
        d->plane[p] = p < d->nplanes ? planes[p] : NULL;
        d->txmap[p] = p < d->nplanes ? txmaps[p] : NULL;
    }
    d->superres_denom = hdr[H_SUPERRES_DENOM];
    d->lr_rstride = hdr[H_LR_RSTRIDE];
    d->lr_cstride = hdr[H_LR_CSTRIDE];
    d->lr_out = lr_out;
    d->count = counts;
    d->stride = stride;
    for (int i = 0; i < 10; i++) d->scan[i] = scans[i];
    for (int i = 0; i < 5; i++) d->smw[i] = smw[i];
    d->dr = dr;
    d->fi_taps = fi_taps;
    d->cdef_stride = (d->mi_cols + 15) / 16;
    d->cdef_idx = cdef_idx;
    memset(cdef_idx, -1, (size_t)d->cdef_stride * ((d->mi_rows + 15) / 16));
    size_t nmi = (size_t)d->mi_rows * d->mi_cols;
    uint8_t *mi8 = (uint8_t *)calloc(nmi * 17, 1);
    d->mi_pal = (uint16_t *)calloc(nmi * 16, sizeof(uint16_t));
    d->mi_mv = (int16_t *)calloc(nmi * 4, sizeof(int16_t));
    size_t n8 = (size_t)(d->mi_rows >> 1) * (size_t)(d->mi_cols >> 1);
    d->tpl_mv = (int16_t *)calloc(n8 * 2 + 1, sizeof(int16_t));
    d->tpl_off = (int8_t *)calloc(n8 + 1, 1);
    uint8_t *ctxmem = (uint8_t *)calloc((size_t)(4 * 3 + 1) * ((size_t)d->mi_cols + d->mi_rows + 64), 1);
    size_t cdf_total = 0;
    for (int k = 0; k < D_NCDF; k++) cdf_total += (size_t)cdf_lens[k];
    uint16_t *cdfmem = (uint16_t *)malloc(cdf_total * sizeof(uint16_t));
    if (!mi8 || !d->mi_pal || !d->mi_mv || !ctxmem || !cdfmem || !d->tpl_mv || !d->tpl_off) {
        rc = AV1D_CORRUPT;
        snprintf(msg, (size_t)msglen, "AV1: out of memory");
        goto done;
    }
    d->mi_wl = mi8; d->mi_hl = mi8 + nmi; d->mi_skip = skips;
    d->mi_ymode = mi8 + 2 * nmi; d->mi_uvmode = mi8 + 3 * nmi;
    d->mi_txw = mi8 + 4 * nmi; d->mi_txh = mi8 + 5 * nmi;
    d->mi_paln = mi8 + 6 * nmi; d->mi_paln_uv = mi8 + 7 * nmi;
    d->mi_inter = mi8 + 8 * nmi; d->mi_seg = segs;
    d->mi_ref = (int8_t *)(mi8 + 9 * nmi); d->mi_newmv = mi8 + 10 * nmi;
    d->mi_filt = mi8 + 11 * nmi; d->mi_lf = mi_lf; d->mi_bsz = mi_bsz;
    d->mi_ref2 = (int8_t *)(mi8 + 12 * nmi); d->mi_cgi = mi8 + 13 * nmi;
    d->mi_cidx = mi8 + 14 * nmi; d->mi_mv2 = d->mi_mv + 2 * nmi;
    d->mi_gmv = mi8 + 15 * nmi; d->mi_skip_mode = mi8 + 16 * nmi;
    d->mi_pal_u = d->mi_pal + nmi * 8;
    {
        size_t ac = (size_t)d->mi_cols + 32, lc = (size_t)d->mi_rows + 32;
        uint8_t *q = ctxmem;
        for (int p = 0; p < 3; p++) {
            d->above_lvl[p] = q; q += ac;
            d->above_dc[p] = q; q += ac;
            d->left_lvl[p] = q; q += lc;
            d->left_dc[p] = q; q += lc;
        }
        d->above_segpred = q; q += ac;
        d->left_segpred = q;
    }
    {
        size_t off = 0;
        for (int k = 0; k < D_NCDF; k++) { d->cdf[k] = cdfmem + off; off += (size_t)cdf_lens[k]; }
    }
    if (d->use_ref_mvs) {
        int64_t t0 = now_ns();
        for (int k = 0; k < imin(mf[1], MFMV_STACK_SIZE); k++) {
            const int32_t *p = mf + 10 + 10 * k;
            mf_project(d, mf_src_refs[k], mf_src_mvs[k], p[0], p[1], p + 2);
        }
        for (size_t i = 0; i < n8; i++) counts[T_MF_PROJECTED] += d->tpl_off[i] != 0;
        if (motion_ns) motion_ns[2] += now_ns() - t0;
    }
    int tile_cols = hdr[H_TILE_COLS], tile_rows = hdr[H_TILE_ROWS];
    const int32_t *col_starts = tile_starts, *row_starts = tile_starts + tile_cols + 1;
    for (int tr = 0; tr < tile_rows && !d->err; tr++)
        for (int tc = 0; tc < tile_cols && !d->err; tc++) {
            int ti = tr * tile_cols + tc;
            for (int k = 0; k < D_NCDF; k++)
                memcpy(d->cdf[k], cdfs[k], (size_t)cdf_lens[k] * sizeof(uint16_t));
            d->r0 = row_starts[tr];
            d->r1 = row_starts[tr + 1];
            d->c0 = col_starts[tc];
            d->c1 = col_starts[tc + 1];
            if (tile_sizes[ti] <= 0) {
                fail(d, AV1D_CORRUPT, "AV1: %s", "empty tile");
                break;
            }
            sym_init(d, tiles[ti], (size_t)tile_sizes[ti]);
            set_qidx(d, d->base_q);
            decode_tile(d);
            /* the CDFs the frame saves: this tile's at its end */
            if (ti == hdr[H_CONTEXT_TILE] && cdf_out && !d->err)
                memcpy(cdf_out, cdfmem, cdf_total * sizeof(uint16_t));
        }
    rc = d->err;
    if (!rc) mf_store(d, mf[0], mf_refs, mf_mvs);
done:
    free(d->tpl_mv);
    free(d->tpl_off);
    free(mi8);
    free(d->mi_pal);
    free(d->mi_mv);
    free(ctxmem);
    free(cdfmem);
    free(d);
    return rc;
}

/* A test hook: with counts (two int64), every later inter part at scale 1
 * is also predicted by predict_scaled, and counts[0] gains the parts and
 * counts[1] those where the two differ; NULL turns it off. The decode
 * itself is unchanged. */
void av1_scaled_parity(int64_t *counts) { scaled_parity = counts; }
