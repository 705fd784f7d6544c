/* The header pack that avif.py hands to av1_decode.c and
 * av1_postfilter.c: one int32 per field, in this order (avif.py
 * _HDR_FIELDS names them and must change with this enum), and the tool
 * counters the decoder fills (avif.py TOOL_NAMES). */
#ifndef OAVIF_AV1_HEADER_H
#define OAVIF_AV1_HEADER_H

enum {
    H_MI_ROWS, H_MI_COLS, H_NPLANES, H_BITDEPTH, H_SB128, H_TILE_COLS,
    H_TILE_ROWS, H_BASE_Q, H_LOSSLESS, H_TX_MODE, H_REDUCED_TX_SET,
    H_SCREEN_TOOLS, H_FILTER_INTRA, H_CDEF_ON, H_CDEF_BITS,
    H_DISABLE_CDF_UPDATE, H_Q_Y_DC, H_Q_Y_AC, H_Q_U_DC, H_Q_U_AC, H_Q_V_DC,
    H_Q_V_AC, H_LR_TYPE0, H_LR_TYPE1, H_LR_TYPE2,
    /* per plane: restoration unit size and the unit grid */
    H_LR_UNIT0, H_LR_UNIT1, H_LR_UNIT2, H_LR_UROWS0, H_LR_UROWS1,
    H_LR_UROWS2, H_LR_UCOLS0, H_LR_UCOLS1, H_LR_UCOLS2,
    /* the unit table's row and column strides (the largest grid) */
    H_LR_RSTRIDE, H_LR_CSTRIDE,
    H_SS_X, H_SS_Y, H_EDGE_FILTER,
    /* post-filters: visible size, loop filter levels (y vertical, y
     * horizontal, u, v, after the intra reference delta) and
     * sharpness, CDEF damping and the 1 << cdef_bits strength sets
     * (y primary, y secondary, uv primary, uv secondary; secondary 3
     * already read as 4) */
    H_WIDTH, H_HEIGHT, H_LF_Y0, H_LF_Y1, H_LF_U, H_LF_V, H_LF_SHARPNESS,
    H_CDEF_DAMPING, H_CDEF_STRENGTHS,
    H_NFIELDS = H_CDEF_STRENGTHS + 8 * 4
};

/* tools a stream used, counted while decoding */
enum {
    T_CHROMA_OF_4XN, T_CFL_SUBSAMPLED, T_EDGE_FILTER, T_EDGE_UPSAMPLE,
    T_TX_V_DCT, T_TX_H_DCT, T_TX_4TO1, T_TX_64, T_TX_DEPTH1, T_TX_DEPTH2,
    T_PART_HORZ_A, T_PART_HORZ_B, T_PART_VERT_A, T_PART_VERT_B,
    T_PART_HORZ_4, T_PART_VERT_4, T_CDEF_IDX_READ, T_CDEF_UNITS_VARIED,
    T_LR_CHROMA_SUBSAMPLED, T_NCOUNTERS
};

#endif
