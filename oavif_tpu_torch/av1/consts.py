"""AV1 constants, enums, and small context tables (from the AV1 spec).

Only what the intra (still-picture) encoder needs. Large trained tables
(CDF defaults, quantizer lookups, scans) live in av1_tables.npz; this file
holds the small structural tables that are algorithmically meaningful.
"""

from __future__ import annotations

import numpy as np

# ---- intra prediction modes (spec 'intra_frame_y_mode' symbol order) ----
DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D135_PRED = 4
D113_PRED = 5
D157_PRED = 6
D203_PRED = 7
D67_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12
UV_CFL_PRED = 13  # uv only, when CfL allowed
INTRA_MODES = 13

MODE_NAMES = [
    "DC", "V", "H", "D45", "D135", "D113", "D157", "D203", "D67",
    "SMOOTH", "SMOOTH_V", "SMOOTH_H", "PAETH",
]

# Mode → kf_y context class (spec Intra_Mode_Context).
INTRA_MODE_CONTEXT = np.array([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0])

# Base angles for the directional modes (degrees).
MODE_TO_ANGLE = {
    V_PRED: 90,
    H_PRED: 180,
    D45_PRED: 45,
    D135_PRED: 135,
    D113_PRED: 113,
    D157_PRED: 157,
    D203_PRED: 203,
    D67_PRED: 67,
}
ANGLE_STEP = 3
MAX_ANGLE_DELTA = 3

# ---- transform sizes (square subset used: TX_SIZES indexing the
# coefficient CDF tables) ----
TX_4X4 = 0
TX_8X8 = 1
TX_16X16 = 2
TX_32X32 = 3
TX_64X64 = 4

TX_SIZE_WIDE = {TX_4X4: 4, TX_8X8: 8, TX_16X16: 16, TX_32X32: 32, TX_64X64: 64}

# tx_size → index into the 5-entry coefficient-CDF tx dimension: the square
# sizes map 1:1 (coefficient CDFs index by txsize_sqr_up for 64 → ... the
# spec uses Min(txSize, TX_64X64) square mapping; with square-only tx this
# is the identity).

# ---- partition symbols (spec) ----
PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3

# ---- block sizes used (square subset) ----
BLOCK_8X8 = 8
BLOCK_16X16 = 16
BLOCK_32X32 = 32
BLOCK_64X64 = 64

# txb skip contexts (spec Skip_Contexts): indexed [min(top,4)][min(left,4)→3?]
SKIP_CONTEXTS_TABLE = np.array(
    [
        [1, 2, 2],
        [2, 3, 3],
        [2, 3, 3],
        [3, 4, 4],
        [3, 4, 5],
    ]
)

# q-index → coefficient-CDF context (spec get_q_ctx / av1_get_adapted...):
#   qindex <= 20 → 0, <= 60 → 1, <= 120 → 2, else 3
def coeff_q_ctx(base_qindex: int) -> int:
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
MAX_TX_SQUARE = 64 * 64

# libavif quality (0..100) → libaom quantizer (0..63) → AV1 base q-index.
# Mirrors libavif avifQualityToQuantizer (rounded 63-scale) and libaom's
# av1_quantizer_to_qindex (×4), so the TQ search seed formula
# (tq.zig:40-43) lands in the same quantizer neighborhood as the reference.
def quality_to_qindex(quality: int) -> int:
    quantizer = ((100 - quality) * 63 + 50) // 100
    return quantizer * 4
