/* The header pack that avif.py hands to av1_decode.c and
 * av1_postfilter.c: one int32 per field, in this order (avif.py
 * _HDR_FIELDS names them and must change with this enum), the film grain
 * pack av1_grain.c reads (avif._GRAIN_FIELDS, likewise), and the tool
 * counters the decoder fills (avif.py TOOL_NAMES). */
#ifndef OAVIF_AV1_HEADER_H
#define OAVIF_AV1_HEADER_H

enum {
    H_MI_ROWS, H_MI_COLS, H_NPLANES, H_BITDEPTH, H_SB128, H_TILE_COLS,
    H_TILE_ROWS, H_BASE_Q, H_LOSSLESS, H_TX_MODE, H_REDUCED_TX_SET,
    H_SCREEN_TOOLS, H_FILTER_INTRA, H_CDEF_ON, H_CDEF_BITS,
    H_DISABLE_CDF_UPDATE,
    /* the frame's quantizer deltas: y dc, u dc, u ac, v dc, v ac */
    H_DQ_Y_DC, H_DQ_U_DC, H_DQ_U_AC, H_DQ_V_DC, H_DQ_V_AC,
    H_LR_TYPE0, H_LR_TYPE1, H_LR_TYPE2,
    /* per plane: restoration unit size and the unit grid */
    H_LR_UNIT0, H_LR_UNIT1, H_LR_UNIT2, H_LR_UROWS0, H_LR_UROWS1,
    H_LR_UROWS2, H_LR_UCOLS0, H_LR_UCOLS1, H_LR_UCOLS2,
    /* the unit table's row and column strides (the largest grid) */
    H_LR_RSTRIDE, H_LR_CSTRIDE,
    H_SS_X, H_SS_Y, H_EDGE_FILTER,
    /* post-filters: visible size, the frame's loop filter levels (y
     * vertical, y horizontal, u, v) and sharpness, CDEF damping */
    H_WIDTH, H_HEIGHT, H_LF_Y0, H_LF_Y1, H_LF_U, H_LF_V, H_LF_SHARPNESS,
    H_CDEF_DAMPING,
    /* quantizer matrix level of y, u and v (15 = flat) */
    H_QM_Y, H_QM_U, H_QM_V,
    /* log2 of the delta q and delta LF steps (-1 = not present), and
     * delta_lf_multi (a DeltaLF per plane and direction) */
    H_DELTA_Q_RES, H_DELTA_LF_RES, H_DELTA_LF_MULTI,
    /* loop_filter_delta_enabled and the intra frame's reference delta */
    H_LF_DELTA_ENABLED, H_LF_REF_DELTA_INTRA,
    /* allow_intrabc (the strength sets stay the pack's tail) */
    H_ALLOW_INTRABC,
    /* segmentation_params (a key frame's: update_map 1, temporal_update
     * 0; an inter frame's map flags are the two words before the CDEF
     * tail): segmentation_enabled, SegIdPreSkip, LastActiveSegId, the
     * segments with SEG_LVL_ALT_Q (bit i for segment i) and their
     * FeatureData, and LosslessArray as a mask (H_LOSSLESS is then
     * CodedLossless); the segments' SEG_LVL_ALT_LF_Y_V.._V (bit 4 * i + k
     * for feature k of segment i, read as uint32: segment 7's ALT_LF_V is
     * the sign bit) and their FeatureData (feature k in byte k of
     * segment i's word, as int8), and the segments with
     * SEG_LVL_SKIP. REF_FRAME and GLOBALMV only set SegIdPreSkip and
     * LastActiveSegId in a key frame. */
    H_SEG_ENABLED, H_SEG_PRESKIP, H_SEG_LAST_ACTIVE, H_SEG_ALT_Q_MASK,
    H_SEG_ALT_Q0, H_SEG_ALT_Q1, H_SEG_ALT_Q2, H_SEG_ALT_Q3, H_SEG_ALT_Q4,
    H_SEG_ALT_Q5, H_SEG_ALT_Q6, H_SEG_ALT_Q7, H_SEG_LOSSLESS_MASK,
    H_SEG_ALT_LF_MASK, H_SEG_ALT_LF0, H_SEG_ALT_LF1, H_SEG_ALT_LF2,
    H_SEG_ALT_LF3, H_SEG_ALT_LF4, H_SEG_ALT_LF5, H_SEG_ALT_LF6,
    H_SEG_ALT_LF7, H_SEG_SKIP_MASK,
    /* superres: SuperresDenom (8 without it) and UpscaledWidth, the
     * visible width; H_WIDTH is then the coded FrameWidth, which the
     * tiles, deblocking and CDEF cover, and the upscaled frame the one
     * loop restoration and film grain work on */
    H_SUPERRES_DENOM, H_UPSCALED_WIDTH,
    /* an inter frame (spec 5.9.2): its frame type (0 key, 1 inter, 2
     * intra-only, 3 switch; the decoder reads bit 0, !FrameIsIntra),
     * allow_high_precision_mv, force_integer_mv, interpolation_filter (4
     * SWITCHABLE), is_motion_mode_switchable, use_ref_frame_mvs,
     * reference_select, allow_warped_motion, the sequence's
     * enable_dual_filter and enable_interintra_compound, the sign bias
     * of LAST..ALTREF (bit r for reference frame r), the tile whose CDFs
     * the frame saves (context_update_tile_id), loop_filter_ref_deltas
     * of LAST..ALTREF (H_LF_REF_DELTA_INTRA is INTRA_FRAME's) and the two
     * loop_filter_mode_deltas; the segments with SEG_LVL_REF_FRAME (bit
     * i), their reference frames (3 bits at 3 * i) and the segments with
     * SEG_LVL_GLOBALMV */
    H_FRAME_TYPE, H_ALLOW_HP, H_FORCE_INTEGER_MV, H_INTERP_FILTER,
    H_MOTION_SWITCHABLE, H_USE_REF_FRAME_MVS, H_REFERENCE_SELECT,
    H_ALLOW_WARPED, H_DUAL_FILTER, H_INTERINTRA, H_SIGN_BIAS,
    H_CONTEXT_TILE, H_LF_REF_DELTA1, H_LF_REF_DELTA2, H_LF_REF_DELTA3,
    H_LF_REF_DELTA4, H_LF_REF_DELTA5, H_LF_REF_DELTA6, H_LF_REF_DELTA7,
    H_LF_MODE_DELTA0, H_LF_MODE_DELTA1, H_SEG_REF_MASK, H_SEG_REF_FRAMES, H_SEG_GLOBALMV_MASK,
    /* the sequence's enable_masked_compound and enable_jnt_comp */
    H_MASKED_COMPOUND, H_JNT_COMP,
    /* skip_mode_present and SkipModeFrame[0..1] (spec 5.9.22) */
    H_SKIP_MODE_PRESENT, H_SKIP_MODE_FRAME0, H_SKIP_MODE_FRAME1,
    /* GmType of LAST..ALTREF (0 IDENTITY, 1 TRANSLATION, 2 ROTZOOM, 3
     * AFFINE) and their gm_params[0..5] (spec 5.9.24) */
    H_GM_TYPE1, H_GM_TYPE2, H_GM_TYPE3, H_GM_TYPE4, H_GM_TYPE5, H_GM_TYPE6, H_GM_TYPE7,
    H_GM1_0, H_GM1_1, H_GM1_2, H_GM1_3, H_GM1_4, H_GM1_5,
    H_GM2_0, H_GM2_1, H_GM2_2, H_GM2_3, H_GM2_4, H_GM2_5,
    H_GM3_0, H_GM3_1, H_GM3_2, H_GM3_3, H_GM3_4, H_GM3_5,
    H_GM4_0, H_GM4_1, H_GM4_2, H_GM4_3, H_GM4_4, H_GM4_5,
    H_GM5_0, H_GM5_1, H_GM5_2, H_GM5_3, H_GM5_4, H_GM5_5,
    H_GM6_0, H_GM6_1, H_GM6_2, H_GM6_3, H_GM6_4, H_GM6_5,
    H_GM7_0, H_GM7_1, H_GM7_2, H_GM7_3, H_GM7_4, H_GM7_5,
    /* segmentation_update_map and segmentation_temporal_update (spec
     * 5.9.14; 1 and 0 where the frame has no primary reference frame) */
    H_SEG_UPDATE_MAP, H_SEG_TEMPORAL,
    /* the 1 << cdef_bits strength sets (y primary, y secondary, uv
     * primary, uv secondary; secondary 3 already read as 4) */
    H_CDEF_STRENGTHS,
    H_NFIELDS = H_CDEF_STRENGTHS + 8 * 4
};

/* film_grain_params (spec 5.9.30): the points as (value, scaling)
 * arrays, the auto-regressive coefficients less 128, the shifts with
 * their offsets added (scaling 8-11, ar 6-9), and whether the matrix is
 * the identity (the chroma clip of clip_to_restricted_range) */
enum {
    G_SEED, G_NUM_Y, G_Y_VALUE, G_Y_SCALING = G_Y_VALUE + 14,
    G_CHROMA_FROM_LUMA = G_Y_SCALING + 14, G_NUM_CB, G_CB_VALUE,
    G_CB_SCALING = G_CB_VALUE + 10, G_NUM_CR = G_CB_SCALING + 10, G_CR_VALUE,
    G_CR_SCALING = G_CR_VALUE + 10, G_SCALING_SHIFT = G_CR_SCALING + 10,
    G_AR_LAG, G_AR_Y, G_AR_CB = G_AR_Y + 24, G_AR_CR = G_AR_CB + 25,
    G_AR_SHIFT = G_AR_CR + 25, G_SCALE_SHIFT, G_CB_MULT, G_CB_LUMA_MULT,
    G_CB_OFFSET, G_CR_MULT, G_CR_LUMA_MULT, G_CR_OFFSET, G_OVERLAP,
    G_CLIP_RESTRICTED, G_MC_IDENTITY, G_NFIELDS
};

/* tools a stream used, counted while decoding */
enum {
    T_CHROMA_OF_4XN, T_CFL_SUBSAMPLED, T_EDGE_FILTER, T_EDGE_UPSAMPLE,
    T_TX_V_DCT, T_TX_H_DCT, T_TX_4TO1, T_TX_64, T_TX_DEPTH1, T_TX_DEPTH2,
    T_PART_HORZ_A, T_PART_HORZ_B, T_PART_VERT_A, T_PART_VERT_B,
    T_PART_HORZ_4, T_PART_VERT_4, T_CDEF_IDX_READ, T_CDEF_UNITS_VARIED,
    T_LR_CHROMA_SUBSAMPLED,
    /* transform blocks dequantized through a quantizer matrix */
    T_QM,
    /* superblocks that moved CurrentQIndex, and DeltaLF changes */
    T_DELTA_Q, T_DELTA_LF,
    /* planes that film grain was added to */
    T_FILM_GRAIN,
    /* blocks with a chroma palette */
    T_UV_PALETTE,
    /* blocks decoded at 12 bits */
    T_TWELVE_BIT,
    /* intra block copy: intrabc blocks, those whose DV prediction fell
     * back to the default DV, chroma predicted at a half sample, and
     * chroma blocks that cover more than their intrabc block (4xN, Nx4) */
    T_INTRABC, T_INTRABC_DEFAULT_DV, T_INTRABC_CHROMA_SUBPEL,
    /* var-tx splits read, luma transform types read from each inter set,
     * and transform blocks reconstructed with a FLIPADST */
    T_VARTX_SPLIT, T_TX_INTER_SET1, T_TX_INTER_SET2, T_TX_INTER_SET3,
    T_TX_FLIP, T_INTRABC_SUB8X8_CHROMA,
    /* segmentation: segment ids read, blocks whose segment moved their
     * qindex (SEG_LVL_ALT_Q), ids read before skip (SegIdPreSkip), and
     * skipped blocks that took the predicted id */
    T_SEGMENTATION, T_SEG_ALT_Q, T_SEG_PRESKIP, T_SEG_PRED_SKIP,
    /* planes upscaled by superres */
    T_SUPERRES,
    /* blocks whose segment moves a loop filter level (SEG_LVL_ALT_LF_*),
     * blocks skipped by their segment (SEG_LVL_SKIP: no skip read), and
     * DeltaLF changes read under delta_lf_multi */
    T_SEG_ALT_LF, T_SEG_SKIP, T_DELTA_LF_MULTI,
    /* inter frames: frames decoded, blocks of each inter mode, NEWMV and
     * NEARMV blocks with a drl index past their first candidate, blocks
     * whose MV has a fractional luma part, predictions through each
     * interpolation filter (regular, smooth, sharp, bilinear; the 4-tap
     * ones count with their 8-tap ones), blocks with two filters, intra
     * blocks, chroma predicted from several blocks' MVs (sub-8x8), and
     * inter blocks whose deblocking level a reference delta and a mode
     * delta move */
    T_INTER_FRAME, T_NEWMV, T_NEARESTMV, T_NEARMV, T_GLOBALMV, T_DRL,
    T_SUBPEL_MV, T_FILTER_REGULAR, T_FILTER_SMOOTH, T_FILTER_SHARP,
    T_FILTER_BILINEAR, T_DUAL_FILTER, T_INTRA_IN_INTER, T_SUB8X8_CHROMA_MVS,
    T_LF_REF_DELTA, T_LF_MODE_DELTA,
    /* inter blocks predicted from a reference of another scale (spec
     * is_scaled: another size, or the coded width under superres) */
    T_SCALED_PRED,
    /* inter blocks of each motion mode past SIMPLE (OBMC, LOCALWARP), and
     * LOCALWARP blocks predicted by translation instead (LocalValid 0, or
     * a shear setupShear refuses) */
    T_OBMC, T_LOCAL_WARP, T_LOCAL_WARP_INVALID,
    /* motion field estimation (spec 7.9): 8x8 positions that hold a
     * projected MV when the projections end, and temporal candidates of
     * MV stacks (the projected MVs that joined a stack or added to the
     * weight of one there) */
    T_MF_PROJECTED, T_TEMPORAL_MV,
    /* compound blocks (two references): blocks of each compound mode
     * (NEAREST_NEARESTMV .. NEW_NEWMV), of each compound type (average,
     * distance-weighted, wedge, difference-weighted), of each reference
     * type (unidirectional, bidirectional), and those with a side through
     * a reference of another scale (which the scaled_pred counter also
     * counts) */
    T_NEAREST_NEARESTMV, T_NEAR_NEARMV, T_NEAREST_NEWMV, T_NEW_NEARESTMV,
    T_NEAR_NEWMV, T_NEW_NEARMV, T_GLOBAL_GLOBALMV, T_NEW_NEWMV,
    T_COMPOUND_AVERAGE, T_COMPOUND_DISTANCE, T_COMPOUND_WEDGE,
    T_COMPOUND_DIFFWTD, T_COMP_REF_UNIDIR, T_COMP_REF_BIDIR, T_COMPOUND_SCALED,
    /* global motion (spec 7.10.2.1, 7.11.3.1): the sides of GLOBALMV and
     * GLOBAL_GLOBALMV blocks on a reference of each GmType past IDENTITY,
     * blocks warped by global motion, and blocks that would have been but
     * for a shear setupShear refuses (globalValid 0); skip_mode blocks */
    T_GLOBAL_TRANSLATION, T_GLOBAL_ROTZOOM, T_GLOBAL_AFFINE, T_GLOBAL_WARP,
    T_GLOBAL_WARP_INVALID, T_SKIP_MODE,
    /* inter-intra (spec 5.11.24, 7.11.3.13-14): blocks blended with an
     * intra prediction, those of them by a wedge, and the smooth ones of
     * each interintra_mode (II_DC, II_V, II_H, II_SMOOTH) */
    T_INTERINTRA, T_INTERINTRA_WEDGE, T_II_DC, T_II_V, T_II_H, T_II_SMOOTH,
    /* segmentation map prediction (spec 5.11.9, 7.20-21): frames that keep
     * the previous map (segmentation_update_map 0), frames that code the
     * map against it (segmentation_temporal_update 1), and blocks whose
     * seg_id_predicted took the predicted id */
    T_SEG_MAP_KEPT, T_SEG_TEMPORAL, T_SEG_ID_PREDICTED,
    T_NCOUNTERS
};

#endif
