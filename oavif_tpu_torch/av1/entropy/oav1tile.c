/* oavif-tpu native tile encoder.
 *
 * The whole per-tile serial path in C: partition walk, intra prediction,
 * forward DCT (double matmuls with matrices derived from the normative
 * integer inverse), quantization, symbol coding (via the range coder /
 * coefficient tokenizer in oav1ec.c), and reconstruction.
 *
 * Mirrors the verified Python reference (oavif_tpu/av1/frame.py
 * TileEncoder) symbol-for-symbol; the Python path remains the readable
 * reference and fallback. Conformance is anchored the same way: every
 * bitstream must decode bit-exactly to this encoder's reconstruction
 * through the independent libavif/dav1d decoder
 * (tests/test_conformance.py). Replaces the reference's libaom delegation
 * (oavif src/io.zig:629-632) with a from-scratch runtime.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <time.h>
#if defined(__AVX512VNNI__) && defined(__AVX512VL__)
#include <immintrin.h>
#endif

/* ---- OAVIF_PROF=1: per-stage wall accumulation, dumped to stderr at
 * the end of every tile_encode call. Scope-exit timers (gcc cleanup)
 * so early returns are counted; nested stages overlap (LUMA_TRIAL
 * contains QUANT/RATE/INV). Zero-cost-ish when the env is unset. ---- */
enum {
    PROF_BLOCK, PROF_LUMA_TRIAL, PROF_QUANT, PROF_RATE, PROF_INV,
    PROF_PREDICT, PROF_MODE, PROF_PART, PROF_PAL, PROF_RECT,
    PROF_RECT_BLK, PROF_QFWD, PROF_QSETUP, PROF_QRDOQ, PROF_QE2,
    PROF_COEFFS,
    PROF_SETUP, PROF_CODE, PROF_TOTAL,
    PROF_NSLOT
};
static const char *const PROF_NAMES[PROF_NSLOT] = {
    "block", "luma_trial", "quant_rdoq", "rate_est", "inv_recon",
    "predict", "mode_choose", "part_ssd", "palette", "rect_duel",
    "rect_block", "q_fwd", "q_setup", "q_rdoq", "q_e2",
    "coeffs",
    "setup", "code", "total"};
static _Thread_local double prof_acc[PROF_NSLOT];
static _Thread_local int64_t prof_cnt[PROF_NSLOT];
static int prof_enabled = -1;
static inline double prof_now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}
static void prof_scope_end(const double *v) {
    if (prof_enabled > 0) prof_acc[(int)v[1]] += prof_now() - v[0];
}
#define PROF_SCOPE(slot)                                               \
    double _prof_v[2] __attribute__((cleanup(prof_scope_end))) = {     \
        prof_enabled > 0 ? (prof_cnt[slot]++, prof_now()) : 0.0,       \
        (double)(slot)}
static void prof_dump(void) {
    fprintf(stderr, "OAVIF_PROF");
    for (int i = 0; i < PROF_NSLOT; i++) {
        fprintf(stderr, " %s=%.1fms/%lld", PROF_NAMES[i],
                prof_acc[i] * 1e3, (long long)prof_cnt[i]);
        prof_acc[i] = 0.0;
        prof_cnt[i] = 0;
    }
    fprintf(stderr, "\n");
}

/* from oav1ec.c (compiled into the same shared object) */
typedef struct Enc Enc;
Enc *enc_new(void);
void enc_free(Enc *e);
void enc_symbol(Enc *e, uint16_t *icdf, int nsym, int s);
void enc_symbol_adapt(Enc *e, uint16_t *icdf, int nsym, int s);
void enc_bool(Enc *e, int val, uint32_t f);
size_t enc_done(Enc *e, uint8_t **dst);
int enc_coeffs(Enc *e, const int32_t *lv, int cw, const int32_t *scan,
               uint16_t *txb_skip_row, uint16_t *eob_pt_row, int eob_pt_nsym,
               uint16_t *eob_extra_rows, uint16_t *base_eob_rows,
               uint16_t *base_rows, uint16_t *br_rows, uint16_t *dc_sign_row,
               uint16_t *txtype_row, int txtype_nsym, int txtype_sym,
               int32_t *out_ctx);
void inv_txfm2d_c(int32_t *c, int w, int h, int bitdepth);
void inv_txfm2d_tt(int32_t *cf, int n, int bitdepth, int col_kind,
                   int row_kind);

/* ---- modes (oavif_tpu/av1/consts.py) ---- */
enum {
    DC_PRED = 0, V_PRED = 1, H_PRED = 2, D45_PRED = 3, D135_PRED = 4,
    D113_PRED = 5, D157_PRED = 6, D203_PRED = 7, D67_PRED = 8,
    SMOOTH_PRED = 9, SMOOTH_V_PRED = 10, SMOOTH_H_PRED = 11, PAETH_PRED = 12,
};
static const int INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
static const int MODE_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                                   0, 0, 0, 0};
/* filter-intra (spec 7.11.2.3): internal y_mode FILTER_BASE+mode; the
 * syntax codes DC_PRED + use/mode fields (mirrors intra.py FILTER_BASE) */
enum { FILTER_BASE = 16 };
static const int FIMODE_TO_DIR[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED,
                                     DC_PRED};
enum { PARTITION_NONE = 0, PARTITION_SPLIT = 3 };

/* CDF pointer pack order (must match fast.py CDF_ORDER) */
enum {
    CDF_PART_W8 = 0, CDF_PART_W16, CDF_PART_W32, CDF_PART_W64,
    CDF_SKIP, CDF_KF_Y, CDF_UV_MODE, CDF_UV_MODE_CFL, CDF_ANGLE_DELTA,
    CDF_TXB_SKIP, CDF_EOB_PT16, CDF_EOB_PT64, CDF_EOB_PT256, CDF_EOB_PT1024,
    CDF_EOB_EXTRA, CDF_COEFF_BASE_EOB, CDF_COEFF_BASE, CDF_COEFF_BR,
    CDF_DC_SIGN, CDF_CFL_SIGN, CDF_CFL_ALPHA, CDF_INTRA_EXT_TX1,
    CDF_INTRA_EXT_TX2, CDF_TX_SIZE, CDF_EOB_PT128, CDF_EOB_PT512,
    CDF_PAL_Y_MODE, CDF_PAL_UV_MODE, CDF_PAL_Y_SIZE,
    CDF_PAL_Y_CI2, CDF_PAL_Y_CI3, CDF_PAL_Y_CI4, CDF_PAL_Y_CI5,
    CDF_PAL_Y_CI6, CDF_PAL_Y_CI7, CDF_PAL_Y_CI8,
    CDF_FI_USE, CDF_FI_MODE, CDF_WIENER, CDF_PART_W128,
    CDF_SGR, CDF_SWITCHABLE, CDF_N
};

enum { UV_CFL_PRED = 13 };

typedef struct {
    Enc *enc;
    int w, h;               /* tile px dims */
    int mi_cols, mi_rows;
    int sb_cols, sb_rows;
    int pw, ph;             /* padded dims (mi grid * 4) */
    int nplanes;
    int bitdepth, speed;
    int qindex;
    int sb128, sbn, lmask; /* superblock size: 128px mode, mi per SB */
    int dq_dc, dq_ac;
    int dq_ac_uv; /* chroma AC dq (u_ac_delta_q applied) */
    int32_t *src[3];        /* padded (ph, pw) */
    int32_t *recon[3];      /* padded (ph, pw) */
    uint16_t *cdf[CDF_N];
    const int32_t *scan[6]; /* log2(cw)-2: 4,8,16,32; [4]=32x16, [5]=16x32 */
    /* RDOQ bit-cost tables (1/128-bit units), computed from the INITIAL
     * CDFs at tile start (mirrors frame.py _icdf_cost_rows) */
    int32_t rc_base[5][2][42][4];
    int32_t rc_base_eob[5][2][4][3];
    int32_t rc_br[4][2][21][4];
    int32_t rc_eob_extra[5][2][9][2];
    int32_t rc_eob_pt[4][2][11]; /* by log2(cw)-2: nsym 5,7,9,11 */
    int32_t rc_eob_pt_rect[2][2][11]; /* [0]=128 (nsym 8), [1]=512 (10) */
    int32_t rc_txsz[4][3][3];    /* tx_size depth costs [cat][ctx][depth] */
    /* phase-3 EXACT decrement rate deltas per reachable base ctx
     * (0..25 = OCBASE[oc] + mag): cost(l) - cost(l-1) for lvl 1..3,
     * with the +-1-cost-unit guard BAKED IN as doubles (lo = del-1,
     * hi = del+1), compared against dd * (1/lam) — one multiply and
     * two loads per position, no int->double converts. Outcomes are
     * identical to the exact evaluation: the bounds sit a full cost
     * unit inside/outside the true boundary, dwarfing the ~1e-16
     * relative rounding of the reciprocal form; marginal cases re-run
     * the original float op order. */
    double rc_dd3_lo[5][2][26][4], rc_dd3_hi[5][2][26][4];
    /* offset-class-tightened bands for phase 1: [txs][pt][oc][lclass
     * 1..3] min/max of base[bctx][lclass]+128 (rdoq_int_cost's table
     * part for nonzero lvl <= 3) over the class's reachable ctxs */
    int32_t rc_ic_min[5][2][6][4], rc_ic_max[5][2][6][4];
    /* scan-position decompositions per scan table k (squares 0..3,
     * rect 4=32x16 / 5=16x32): row, column, and the running row max
     * (so quantize's maxr over si<eob is one lookup) */
    int16_t scan_r[6][1024], scan_c[6][1024], scan_rmax[6][1024];
    /* base-ctx offset class per scan position (index into OCBASE):
     * 0 = DC, 1 = +1 (square rr+cc<2), 2 = +6 (rr+cc<4), 3 = +11
     * (tall rr<2), 4 = +16 (wide cc<2), 5 = +21 */
    int8_t scan_oc[6][1024];
    /* RDOQ frequency weights, exactly 1.0/(1 + hf_a*si/n_coded) per
     * ptype: squares flat at WS_SQ_OFF[log2(cw)-2], rect at 0/128 —
     * hoists the per-call serial divisions out of the phase-3 loop */
    double ws_sq[2][16 + 64 + 256 + 1024];
    double ws_rect[2][128 + 512];
    const int32_t *smw[5];  /* sm_weights by log2(n)-2: 4,8,16,32,64 */
    const double *fh[11], *fw[11]; /* dct 8,16,32,64; adst 8,16; dct 4;
                                      rect dct 32x16, 16x32; idtx 8, 16 */
    /* integer forward-transform matrices (Q12; mirrors transform.py
     * fwd_matrices_int16): int16 fh, TRANSPOSED int16 fw (k-major so
     * stage 2 streams unit-stride), its k-pair-interleaved form for the
     * VNNI kernel, the stage-1 shift, and the exact pow2 scale back to
     * real coefficient units. Integer math => bit-identical to NumPy
     * regardless of summation order. */
    int16_t fh16[11][64 * 64];
    int16_t fwT16[11][64 * 64];
    int32_t fwP[11][32 * 64];
    int fwd_sa[11];
    double fwd_inv_scale[11];
    int enable_rect; /* HORZ/VERT 32-node arms (OAVIF_RECT, mirrors
                        frame.py TileEncoder._enable_rect) */
    int enable_idtx; /* identity-transform duel arm (OAVIF_IDTX) */
    int screen_tools; /* frame allow_screen_content_tools: palette
                         syntax coded per eligible DC block */
    double rdoq_hf;   /* frequency-weighted RDOQ strength (see
                         quantize_mat): 0 on screen frames, else 2;
                         OAVIF_RDOQ_HF overrides */
    double rdoq_hf_uv; /* chroma-plane strength (default = luma's;
                          OAVIF_RDOQ_HF_UV overrides) */
    int filter_intra; /* seq enable_filter_intra: use flag coded per
                         eligible DC block <= 32 */
    const int32_t *fi_taps; /* filter-intra taps [5][8][8] (av1_tables) */
    /* loop restoration (spec 5.11.31-34; mirrors frame.py _emit_lr):
     * lr_cfg = [types[3] (coded frame type: 0 none / 1 switchable /
     * 2 wiener / 3 sgrproj), unit_shift, urows, ucols, then per plane
     * urows*ucols entries of 7 ints keyed by [0] = unit kind
     * (0 none, 1 wiener, 2 sgr): wiener -> v0,v1,v2, h0,h1,h2;
     * sgr -> set, xqd0, xqd1, pad*3. NULL = restoration off.
     * lr_ref = running Wiener subexp refs per (plane, pass, tap),
     * reset to Wiener_Taps_Mid per tile. */
    const int32_t *lr_cfg;
    int lr_ref[3][2][3];
    int lr_sgr_ref[3][2];   /* SGRPROJ xqd refs, mid {-32, 31} */
    /* palette context lines: per-mi neighbor palette (count 0 = none) */
    uint8_t *above_pal_n;
    uint16_t *above_pal_c; /* mi_cols * 8 */
    uint8_t left_pal_n[32];
    uint16_t left_pal_c[32][8];
    const int32_t *dr_deriv; /* dr_intra_derivative[90] */
    /* device plan (encode_tpu.FramePlanner): sections of one packed
     * int32 buffer; NULL = host searches everything */
    const int32_t *plan64;  /* (sby, sbx): 0 = SPLIT, mode+1 = NONE, -1 */
    const int32_t *mode32;  /* (nby, nbx) spec mode ids, -1 = search */
    const int32_t *part32;  /* (nby, nbx) 0/1 split flags */
    const int32_t *mode16;  /* (2*nby, 2*nbx) spec mode ids, -1 */
    int plan_nbx, plan_nby;
    int32_t *blocks_out;  /* (r, c, size, skip) quads for the post-filters */
    int n_blocks;
    /* cross-probe decision record/replay (mode 0 off, 1 record, 2 replay):
     * per coded block 9 ints [tag, y_depth, tt0..3, uv_mode, a_u, a_v];
     * tag guards block-sequence alignment (edge SBs fall back to
     * q-dependent host partition search, so sequences CAN diverge — on
     * the first tag mismatch replay disarms for the rest of the tile) */
    int32_t *dec_buf;
    int dec_pos, dec_cap, dec_mode;
    /* context lines */
    uint8_t *above_part, *above_skip, *above_mode;
    uint8_t left_part[32], left_skip[32], left_mode[32];
    int32_t *above_txw; /* chosen luma tx width px, per mi col */
    int32_t left_txh[32];
    /* variance-adaptive λ (mirrors frame.py _mean_var/_lam_scale) */
    double mean_var;
    double cur_lamscale;
    int32_t *above_lvl[3], *above_dc[3];
    int32_t left_lvl[3][32], left_dc[3][32];
} Tile;

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

/* ---- edges + prediction (mirrors intra.py) ---- */

typedef struct {
    int64_t above[129]; /* above[0] = corner, above[1..w+h] */
    int64_t left[129];
} Edges;

static void build_edges_buf_tr(const Tile *t, const int32_t *recon, int x,
                               int y, int w, int h, int have_above,
                               int have_left, int ntr, int nbl, Edges *e) {
    int base = 1 << (t->bitdepth - 1);
    int pw = t->pw;
    int n = w + h;
    if (have_above) {
        const int32_t *srcrow = recon + (size_t)(y - 1) * pw + x;
        int n_avail = w + (ntr < h ? ntr : h);
        for (int i = 0; i < n_avail; i++) e->above[1 + i] = srcrow[i];
        for (int i = n_avail; i < n; i++) e->above[1 + i] = srcrow[n_avail - 1];
    } else if (have_left) {
        int64_t v = recon[(size_t)y * pw + x - 1];
        for (int i = 0; i < n; i++) e->above[1 + i] = v;
    } else {
        for (int i = 0; i < n; i++) e->above[1 + i] = base - 1;
    }
    if (have_left) {
        int n_avail = h + (nbl < w ? nbl : w);
        for (int i = 0; i < n_avail; i++)
            e->left[1 + i] = recon[(size_t)(y + i) * pw + x - 1];
        for (int i = n_avail; i < n; i++)
            e->left[1 + i] = recon[(size_t)(y + n_avail - 1) * pw + x - 1];
    } else if (have_above) {
        int64_t v = recon[(size_t)(y - 1) * pw + x];
        for (int i = 0; i < n; i++) e->left[1 + i] = v;
    } else {
        for (int i = 0; i < n; i++) e->left[1 + i] = base + 1;
    }
    int64_t corner;
    if (have_above && have_left) corner = recon[(size_t)(y - 1) * pw + x - 1];
    else if (have_above) corner = recon[(size_t)(y - 1) * pw + x];
    else if (have_left) corner = recon[(size_t)y * pw + x - 1];
    else corner = base;
    e->above[0] = corner;
    e->left[0] = corner;
}

static void build_edges_buf(const Tile *t, const int32_t *recon, int x,
                            int y, int w, int h, int have_above,
                            int have_left, Edges *e) {
    build_edges_buf_tr(t, recon, x, y, w, h, have_above, have_left, 0, 0, e);
}

/* intra edge availability (square-only z-order; mirrors frame.py) */
/* Edge availability recursion runs up to the SUPERBLOCK root (t->sbn =
 * 32 mi under sb128, 16 otherwise — mirrors frame.py _has_top_right /
 * _has_bottom_left). The 64px-hardcoded version silently mis-derived
 * the TR/BL prediction edges for blocks inside 128 superblocks, making
 * the encoder recon diverge from the decoder's (caught by the fuzz
 * soak; tests/test_sb128.py now pins a directional-bait case). */
static int has_top_right_c(const Tile *t, int r, int c, int n_mi) {
    int size = n_mi;
    while (size < t->sbn) {
        int parent = size * 2;
        int top = (r % parent) < size;
        int left = (c % parent) < size;
        if (left) return 1;
        if (!top) return 0;
        size = parent;
    }
    return r > 0 && ((c | t->lmask) + 1) < t->mi_cols;
}

static int has_bottom_left_c(const Tile *t, int r, int c, int n_mi) {
    int size = n_mi;
    while (size < t->sbn) {
        int parent = size * 2;
        int top = (r % parent) < size;
        int left = (c % parent) < size;
        if (top && left) return c > 0;
        if (top || !left) return 0;
        size = parent;
    }
    return 0;
}

static void edge_counts(const Tile *t, int r, int c, int size, int *ntr,
                        int *nbl) {
    int n_mi = size / 4;
    *ntr = 0;
    *nbl = 0;
    if (has_top_right_c(t, r, c, n_mi)) {
        int v = (t->mi_cols - c - n_mi) * 4;
        if (v > size) v = size;
        if (v > 0) *ntr = v;
    }
    if (has_bottom_left_c(t, r, c, n_mi)) {
        int v = (t->mi_rows - r - n_mi) * 4;
        if (v > size) v = size;
        if (v > 0) *nbl = v;
    }
}

static void build_edges(const Tile *t, int plane, int x, int y, int w, int h,
                        int have_above, int have_left, Edges *e) {
    build_edges_buf(t, t->recon[plane], x, y, w, h, have_above, have_left, e);
}

static int log2i(int n) { return 31 - __builtin_clz((unsigned)n); }

/* Directional prediction, zones 1-3 (intra edge filter disabled). */
static void pred_directional(const Edges *e, int mode, int angle_delta,
                             const int32_t *dr, int w, int h, int32_t *out) {
    const int64_t *a = e->above + 1;
    const int64_t *l = e->left + 1;
    int p_angle = MODE_ANGLE[mode] + angle_delta * 3;
    if (p_angle < 90) { /* zone 1: above only */
        int dx = dr[p_angle];
        int max_base = w + h - 1;
        for (int r = 0; r < h; r++) {
            int x = (r + 1) * dx;
            for (int c = 0; c < w; c++) {
                int base = (x >> 6) + c;
                if (base > max_base) { out[r * w + c] = (int32_t)a[max_base]; continue; }
                int shift = (x >> 1) & 0x1F;
                int b2 = imin(base + 1, max_base);
                out[r * w + c] =
                    (int32_t)((a[base] * (32 - shift) + a[b2] * shift + 16) >> 5);
            }
        }
        return;
    }
    if (p_angle > 180) { /* zone 3: left only */
        int dy = dr[270 - p_angle];
        int max_base = w + h - 1;
        for (int c = 0; c < w; c++) {
            int y = (c + 1) * dy;
            for (int r = 0; r < h; r++) {
                int base = (y >> 6) + r;
                if (base > max_base) { out[r * w + c] = (int32_t)l[max_base]; continue; }
                int shift = (y >> 1) & 0x1F;
                int b2 = imin(base + 1, max_base);
                out[r * w + c] =
                    (int32_t)((l[base] * (32 - shift) + l[b2] * shift + 16) >> 5);
            }
        }
        return;
    }
    /* zone 2: both edges; -1-indexed arrays (above[-1] = corner) */
    int dx = dr[180 - p_angle];
    int dy = dr[p_angle - 90];
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int x = (c << 6) - (r + 1) * dx;
            int base_x = x >> 6;
            int64_t v;
            if (base_x >= -1) {
                int shift = (x >> 1) & 0x1F;
                v = e->above[base_x + 1] * (32 - shift) + e->above[base_x + 2] * shift;
            } else {
                int y = (r << 6) - (c + 1) * dy;
                int base_y = y >> 6;
                int shift = (y >> 1) & 0x1F;
                v = e->left[base_y + 1] * (32 - shift) + e->left[base_y + 2] * shift;
            }
            out[r * w + c] = (int32_t)((v + 16) >> 5);
        }
}

/* spec 7.11.2.3 recursive filter prediction: 4x2 patches in raster
 * order, each output a 7-tap combination of the patch's above row (4 +
 * corner) and left column (2); interior patches consume previously
 * predicted pixels. Round2Signed at scale 4 (mirrors intra.py). */
static void pred_filter_intra(const Tile *t, const Edges *e, int fimode,
                              int w, int h, int32_t *out) {
    const int32_t *taps = t->fi_taps + (size_t)fimode * 64;
    int hi = (1 << t->bitdepth) - 1;
    int64_t buf[33 * 33]; /* (h+1) x (w+1); blocks cap at 32 */
    int W = w + 1;
    buf[0] = e->above[0];
    for (int c = 0; c < w; c++) buf[1 + c] = e->above[1 + c];
    for (int r = 0; r < h; r++) buf[(size_t)(r + 1) * W] = e->left[1 + r];
    for (int r = 1; r <= h; r += 2)
        for (int c = 1; c <= w; c += 4) {
            const int64_t p[7] = {
                buf[(size_t)(r - 1) * W + c - 1], buf[(size_t)(r - 1) * W + c],
                buf[(size_t)(r - 1) * W + c + 1],
                buf[(size_t)(r - 1) * W + c + 2],
                buf[(size_t)(r - 1) * W + c + 3],
                buf[(size_t)r * W + c - 1], buf[(size_t)(r + 1) * W + c - 1],
            };
            for (int k = 0; k < 8; k++) {
                int64_t v = 0;
                for (int j = 0; j < 7; j++) v += (int64_t)taps[k * 8 + j] * p[j];
                v = v >= 0 ? (v + 8) >> 4 : -((-v + 8) >> 4);
                if (v < 0) v = 0;
                if (v > hi) v = hi;
                buf[(size_t)(r + (k >> 2)) * W + c + (k & 3)] = v;
            }
        }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++)
            out[r * w + c] = (int32_t)buf[(size_t)(r + 1) * W + c + 1];
}

static void predict(const Tile *t, const Edges *e, int mode, int w, int h,
                    int have_above, int have_left, int32_t *out) {
    PROF_SCOPE(PROF_PREDICT);
    if (mode >= FILTER_BASE) {
        pred_filter_intra(t, e, mode - FILTER_BASE, w, h, out);
        return;
    }
    const int64_t *a = e->above + 1;
    const int64_t *l = e->left + 1;
    int64_t corner = e->above[0];
    if (mode == DC_PRED) {
        int64_t avg;
        if (have_above && have_left) {
            int64_t s = 0;
            for (int i = 0; i < w; i++) s += a[i];
            for (int i = 0; i < h; i++) s += l[i];
            avg = (s + ((w + h) >> 1)) / (w + h);
        } else if (have_above) {
            int64_t s = 0;
            for (int i = 0; i < w; i++) s += a[i];
            avg = (s + (w >> 1)) >> log2i(w);
        } else if (have_left) {
            int64_t s = 0;
            for (int i = 0; i < h; i++) s += l[i];
            avg = (s + (h >> 1)) >> log2i(h);
        } else {
            avg = 1 << (t->bitdepth - 1);
        }
        for (int i = 0; i < w * h; i++) out[i] = (int32_t)avg;
        return;
    }
    if (mode == V_PRED || mode == H_PRED) {
        if (MODE_ANGLE[mode] == 90) {
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) out[r * w + c] = (int32_t)a[c];
        } else {
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) out[r * w + c] = (int32_t)l[r];
        }
        return;
    }
    if (mode == PAETH_PRED) {
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t base = a[c] + l[r] - corner;
                int64_t pa = llabs(base - a[c]);
                int64_t pl = llabs(base - l[r]);
                int64_t pc = llabs(base - corner);
                out[r * w + c] = (int32_t)((pa <= pl && pa <= pc)
                                               ? a[c]
                                               : (pl <= pc ? l[r] : corner));
            }
        return;
    }
    if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
        const int32_t *wh = t->smw[log2i(h) - 2];
        const int32_t *ww = t->smw[log2i(w) - 2];
        int64_t below = l[h - 1];
        int64_t right = a[w - 1];
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t acc;
                if (mode == SMOOTH_PRED) {
                    acc = (int64_t)wh[r] * a[c] + (int64_t)(256 - wh[r]) * below +
                          (int64_t)ww[c] * l[r] + (int64_t)(256 - ww[c]) * right;
                    out[r * w + c] = (int32_t)((acc + 256) >> 9);
                } else if (mode == SMOOTH_V_PRED) {
                    acc = (int64_t)wh[r] * a[c] + (int64_t)(256 - wh[r]) * below;
                    out[r * w + c] = (int32_t)((acc + 128) >> 8);
                } else {
                    acc = (int64_t)ww[c] * l[r] + (int64_t)(256 - ww[c]) * right;
                    out[r * w + c] = (int32_t)((acc + 128) >> 8);
                }
            }
        return;
    }
    /* directional D45..D67 (and V/H with nonzero delta) */
    pred_directional(e, mode, 0, t->dr_deriv, w, h, out);
}

/* ---- forward transform + quant (mirrors frame.py _quantize) ---- */

static const int DQ_SHIFT_BY_TX[65] = {
    [4] = 0, [8] = 0, [16] = 0, [32] = 1, [64] = 2};

/* resid (n*n int32) -> levels (int32, natural order) via the Q12 integer
 * forward transform + RDOQ. fi = matrix index into t->fh16/fwT16.
 * ord_out/eob_out (optional) export the scan-order magnitudes + eob so
 * the caller's rate estimate skips re-gathering the levels; rate_out
 * (optional) returns the fused exact rate estimate (see
 * rdoq_rate_from_pad). */
static void quantize_mat(const Tile *t, const int32_t *resid, int n,
                         int ptype, int fi, int32_t *levels, double *e2_out,
                         int64_t *ord_out, int *eob_out, int64_t *rate_out);

static void quantize_n(const Tile *t, const int32_t *resid, int n, int ptype,
                       int32_t *levels) {
    int fi = n == 4 ? 6 : log2i(n) - 3;
    quantize_mat(t, resid, n, ptype, fi, levels, NULL, NULL, NULL, NULL);
}

/* matrix dims: fh is MAT_NH x MAT_NH (column/height side), fw is
 * MAT_NW x MAT_NW (row/width side); square entries have NH == NW */
static const int MAT_NH[11] = {8, 16, 32, 64, 8, 16, 4, 16, 32, 8, 16};
static const int MAT_NW[11] = {8, 16, 32, 64, 8, 16, 4, 32, 16, 8, 16};

/* Build the Q12 int16 matrices + per-matrix stage-1 shift from the double
 * matrices (identical algorithm to transform.py fwd_matrices_int16). */
static void fwd_init(Tile *t) {
    for (int m = 0; m < 11; m++) {
        int nh = MAT_NH[m], nw = MAT_NW[m];
        int16_t *fh16 = t->fh16[m];
        int16_t *fwt = t->fwT16[m];
        int64_t l1h_max = 0, l1w_max = 0;
        for (int r = 0; r < nh; r++) {
            int64_t l1 = 0;
            for (int c = 0; c < nh; c++) {
                int v = (int)floor(t->fh[m][(size_t)r * nh + c] * 4096.0 + 0.5);
                fh16[r * nh + c] = (int16_t)v;
                l1 += v < 0 ? -v : v;
            }
            if (l1 > l1h_max) l1h_max = l1;
        }
        for (int r = 0; r < nw; r++) {
            int64_t l1 = 0;
            for (int c = 0; c < nw; c++) {
                int v = (int)floor(t->fw[m][(size_t)r * nw + c] * 4096.0 + 0.5);
                fwt[c * nw + r] = (int16_t)v; /* transposed */
                l1 += v < 0 ? -v : v;
            }
            if (l1 > l1w_max) l1w_max = l1;
        }
        int64_t maxr = (1 << t->bitdepth) - 1;
        int64_t acc1 = l1h_max * maxr;
        int sa = 0;
        for (;;) {
            int64_t tm = (acc1 + (((int64_t)1 << sa) >> 1)) >> sa;
            if (tm <= 32767 && l1w_max * tm < ((int64_t)1 << 31)) break;
            sa++;
        }
        t->fwd_sa[m] = sa;
        t->fwd_inv_scale[m] = 1.0 / (double)((int64_t)1 << (24 - sa));
        for (int kp = 0; kp < nw / 2; kp++) {
            const int16_t *r0 = fwt + (size_t)(2 * kp) * nw, *r1 = r0 + nw;
            int32_t *p = t->fwP[m] + (size_t)kp * nw;
            for (int c = 0; c < nw; c++)
                p[c] = (int32_t)((uint32_t)(uint16_t)r0[c] |
                                 ((uint32_t)(uint16_t)r1[c] << 16));
        }
    }
}

/* General (m x k) @ (k x n) with B supplied k-PAIR interleaved. Integer
 * arithmetic: SIMD and scalar paths agree bit-for-bit. */
static void mm_i16_pairs_g(const int16_t *A, const int32_t *Bp, int m, int k,
                           int n, int32_t *out) {
#if defined(__AVX512VNNI__) && defined(__AVX512VL__)
    if (n >= 16 && n % 16 == 0) {
        for (int r = 0; r < m; r++) {
            const int32_t *ap = (const int32_t *)(A + (size_t)r * k);
            for (int cb = 0; cb < n; cb += 16) {
                __m512i acc = _mm512_setzero_si512();
                for (int kp = 0; kp < k / 2; kp++)
                    acc = _mm512_dpwssd_epi32(
                        acc, _mm512_set1_epi32(ap[kp]),
                        _mm512_loadu_si512(
                            (const void *)(Bp + (size_t)kp * n + cb)));
                _mm512_storeu_si512((void *)(out + (size_t)r * n + cb), acc);
            }
        }
        return;
    }
#endif
    for (int r = 0; r < m; r++) {
        int32_t *o = out + (size_t)r * n;
        for (int c = 0; c < n; c++) o[c] = 0;
        const int16_t *ar = A + (size_t)r * k;
        for (int kp = 0; kp < k / 2; kp++) {
            int32_t a0 = ar[2 * kp], a1 = ar[2 * kp + 1];
            const int32_t *bp = Bp + (size_t)kp * n;
            for (int c = 0; c < n; c++) {
                int32_t b = bp[c];
                o[c] += a0 * (int16_t)(uint16_t)b +
                        a1 * (int16_t)(uint16_t)((uint32_t)b >> 16);
            }
        }
    }
}

/* out[r][c] = sum_k A[r][k] * B[k][c] with B supplied k-PAIR interleaved
 * (Bp[kp][c] packs B[2kp][c] in the low and B[2kp+1][c] in the high int16)
 * and A rows read as int32 pairs. Integer arithmetic: SIMD and scalar
 * paths agree bit-for-bit. */
static void mm_i16_pairs(const int16_t *A, const int32_t *Bp, int n,
                         int32_t *out) {
#if defined(__AVX512VNNI__) && defined(__AVX512VL__)
    if (n >= 16) {
        for (int r = 0; r < n; r++) {
            const int32_t *ap = (const int32_t *)(A + (size_t)r * n);
            for (int cb = 0; cb < n; cb += 16) {
                __m512i acc = _mm512_setzero_si512();
                for (int kp = 0; kp < n / 2; kp++)
                    acc = _mm512_dpwssd_epi32(
                        acc, _mm512_set1_epi32(ap[kp]),
                        _mm512_loadu_si512(
                            (const void *)(Bp + (size_t)kp * n + cb)));
                _mm512_storeu_si512((void *)(out + (size_t)r * n + cb), acc);
            }
        }
        return;
    }
    if (n == 8) {
        for (int r = 0; r < 8; r++) {
            const int32_t *ap = (const int32_t *)(A + r * 8);
            __m256i acc = _mm256_setzero_si256();
            for (int kp = 0; kp < 4; kp++)
                acc = _mm256_dpwssd_epi32(
                    acc, _mm256_set1_epi32(ap[kp]),
                    _mm256_loadu_si256((const __m256i *)(Bp + kp * 8)));
            _mm256_storeu_si256((__m256i *)(out + r * 8), acc);
        }
        return;
    }
#endif
    for (int r = 0; r < n; r++) {
        int32_t *o = out + (size_t)r * n;
        for (int c = 0; c < n; c++) o[c] = 0;
        const int16_t *ar = A + (size_t)r * n;
        for (int kp = 0; kp < n / 2; kp++) {
            int32_t a0 = ar[2 * kp], a1 = ar[2 * kp + 1];
            const int32_t *bp = Bp + (size_t)kp * n;
            for (int c = 0; c < n; c++) {
                int32_t b = bp[c];
                o[c] += a0 * (int16_t)(uint16_t)b +
                        a1 * (int16_t)(uint16_t)((uint32_t)b >> 16);
            }
        }
    }
}

/* ---- elementwise float64 vector helpers for the quantizer ----
 * Per-element IEEE double ops only (abs/mul/div/floor/convert): a lane
 * computes exactly what the scalar expression computes, so results are
 * bit-identical to the NumPy mirror regardless of vector width. Float
 * ACCUMULATIONS follow the vsum8_f64 blocked order, which the NumPy
 * mirror reproduces exactly (frame.py _sum8 — the order IS the
 * C<->Python parity contract). */
#if defined(__AVX512F__) && defined(__AVX512DQ__)
#define OAV1_F64_VEC 1
#endif

/* a_out[i] = fabs((double)v[i]) * scale */
static inline void vabs_scale_f64(const int32_t *v, int cnt, double scale,
                                  double *a_out) {
    int i = 0;
#if OAV1_F64_VEC
    const __m512d vs = _mm512_set1_pd(scale);
    const __m512d mask = _mm512_castsi512_pd(
        _mm512_set1_epi64((int64_t)0x7fffffffffffffffLL));
    for (; i + 8 <= cnt; i += 8) {
        __m512d d = _mm512_cvtepi32_pd(
            _mm256_loadu_si256((const __m256i *)(v + i)));
        _mm512_storeu_pd(a_out + i,
                         _mm512_mul_pd(_mm512_and_pd(d, mask), vs));
    }
#endif
    for (; i < cnt; i++) a_out[i] = fabs((double)v[i]) * scale;
}

/* l[i] = (int64)floor(a[i] * up / dq + 0.5) */
static inline void vquant_f64(const double *a, int cnt, double up, double dq,
                              int64_t *l) {
    int i = 0;
#if OAV1_F64_VEC
    const __m512d vu = _mm512_set1_pd(up);
    const __m512d vd = _mm512_set1_pd(dq);
    const __m512d vh = _mm512_set1_pd(0.5);
    for (; i + 8 <= cnt; i += 8) {
        __m512d x = _mm512_div_pd(
            _mm512_mul_pd(_mm512_loadu_pd(a + i), vu), vd);
        x = _mm512_roundscale_pd(_mm512_add_pd(x, vh),
                                 _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
        _mm512_storeu_si512((void *)(l + i), _mm512_cvttpd_epi64(x));
    }
#endif
    for (; i < cnt; i++)
        l[i] = (int64_t)floor(a[i] * up / dq + 0.5);
}

/* t[i] = e*e with e = a[i] - (double)((l[i]*dq) >> shift); l[i] >= 0 */
static inline void verr2_terms_f64(const double *a, const int64_t *l,
                                   int cnt, int64_t dq, int shift,
                                   double *t) {
    int i = 0;
#if OAV1_F64_VEC
    const __m512i vdq = _mm512_set1_epi64(dq);
    for (; i + 8 <= cnt; i += 8) {
        __m512i p = _mm512_srli_epi64(
            _mm512_mullo_epi64(_mm512_loadu_si512((const void *)(l + i)),
                               vdq),
            shift);
        __m512d e = _mm512_sub_pd(_mm512_loadu_pd(a + i),
                                  _mm512_cvtepi64_pd(p));
        _mm512_storeu_pd(t + i, _mm512_mul_pd(e, e));
    }
#endif
    for (; i < cnt; i++) {
        double e = a[i] - (double)((l[i] * dq) >> shift);
        t[i] = e * e;
    }
}

/* RDOQ phase-3 decrement terms: ek[i] = (a-((l*dq)>>s))^2 * w,
 * ed[i] = (a-(((l-1)*dq)>>s))^2 * w. Same per-element float op order as
 * the scalar loop (bit-identical where l >= 1; lanes with l == 0 are
 * never read — phase 3 skips zero levels — so the logical-vs-arithmetic
 * shift difference there is dead). */
static inline void vdec_terms_f64(const double *a, const int64_t *l,
                                  const double *w, int cnt, int64_t dq,
                                  int shift, double *ek, double *ed) {
    int i = 0;
#if OAV1_F64_VEC
    const __m512i vdq = _mm512_set1_epi64(dq);
    const __m512i vone = _mm512_set1_epi64(1);
    for (; i + 8 <= cnt; i += 8) {
        __m512i lv = _mm512_loadu_si512((const void *)(l + i));
        __m512i p0 = _mm512_srli_epi64(_mm512_mullo_epi64(lv, vdq),
                                       (unsigned)shift);
        __m512i p1 = _mm512_srli_epi64(
            _mm512_mullo_epi64(_mm512_sub_epi64(lv, vone), vdq),
            (unsigned)shift);
        __m512d av = _mm512_loadu_pd(a + i);
        __m512d wv = _mm512_loadu_pd(w + i);
        __m512d e0 = _mm512_sub_pd(av, _mm512_cvtepi64_pd(p0));
        __m512d e1 = _mm512_sub_pd(av, _mm512_cvtepi64_pd(p1));
        _mm512_storeu_pd(ek + i,
                         _mm512_mul_pd(_mm512_mul_pd(e0, e0), wv));
        _mm512_storeu_pd(ed + i,
                         _mm512_mul_pd(_mm512_mul_pd(e1, e1), wv));
    }
#endif
    for (; i < cnt; i++) {
        int64_t lv = l[i];
        double e0 = a[i] - (double)((lv * dq) >> shift);
        double e1 = a[i] - (double)(((lv - 1) * dq) >> shift);
        ek[i] = e0 * e0 * w[i];
        ed[i] = e1 * e1 * w[i];
    }
}

/* e0[i] = (a[i]*a[i]) * w[i] — the drop-to-zero distortion term. The
 * phases' ERR2(si, 0) computes a - (double)0 first; a >= 0 here (abs
 * magnitudes), so a - 0.0 == a bitwise and (a*a)*w matches exactly. */
static inline void vdrop_terms_f64(const double *a, const double *w,
                                   int cnt, double *e0) {
    int i = 0;
#if OAV1_F64_VEC
    for (; i + 8 <= cnt; i += 8) {
        __m512d av = _mm512_loadu_pd(a + i);
        _mm512_storeu_pd(
            e0 + i,
            _mm512_mul_pd(_mm512_mul_pd(av, av), _mm512_loadu_pd(w + i)));
    }
#endif
    for (; i < cnt; i++) e0[i] = a[i] * a[i] * w[i];
}

/* eob = 1 + highest index with l[i] != 0, scanning from the tail 8
 * lanes at a time (typical eob << n_coded after quantization) */
static inline int veob_scan(const int64_t *l, int n) {
    int i = n;
#if OAV1_F64_VEC
    for (; i >= 8; i -= 8) {
        __m512i v = _mm512_loadu_si512((const void *)(l + i - 8));
        __mmask8 nzm = _mm512_test_epi64_mask(v, v);
        if (nzm) return i - 8 + (31 - __builtin_clz((unsigned)nzm)) + 1;
    }
#endif
    for (; i > 0; i--)
        if (l[i - 1]) return i;
    return 0;
}

/* 8-lane blocked double sum: interleaved lane accumulators over the
 * array, lanes folded in index order, tail appended sequentially. This
 * IS the accumulation-order contract shared with the NumPy mirror
 * (frame.py _sum8) — both sides add the same doubles in the same order,
 * so results are bit-identical, and the addsd latency chain of a plain
 * sequential sum (the old contract) drops 8x. */
static double vsum8_f64(const double *t, int n) {
    int m = n & ~7;
    double s = 0.0;
#if OAV1_F64_VEC
    if (m) {
        __m512d acc = _mm512_setzero_pd();
        for (int i = 0; i < m; i += 8)
            acc = _mm512_add_pd(acc, _mm512_loadu_pd(t + i));
        double lanes[8];
        _mm512_storeu_pd(lanes, acc);
        for (int l = 0; l < 8; l++) s += lanes[l];
    }
#else
    if (m) {
        double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int i = 0; i < m; i += 8)
            for (int l = 0; l < 8; l++) acc[l] += t[i + l];
        for (int l = 0; l < 8; l++) s += acc[l];
    }
#endif
    for (int i = m; i < n; i++) s += t[i];
    return s;
}

/* quantizer reconstruction error: sum of (a - dequant(level))^2 over
 * the coded region + passthrough energy past eob. ord[i] == 0 for all
 * i >= eob (eob = last nonzero + 1), so the err2 term collapses to
 * a*a bitwise there (a >= 0 and a - 0.0 == a), letting one fused pass
 * compute terms in-register and accumulate them in exactly the
 * vsum8_f64 blocked order (the parity contract with the NumPy mirror's
 * _sum8: 8 lane accumulators over full blocks in index order, lanes
 * folded in order, tail sequential — n_coded here is always a multiple
 * of 8, so no tail). The DC lane of block 0 uses dq_dc. */
static double e2_scan_f64(int64_t dq_dc, int64_t dq_ac, int shift,
                          const double *a_scan, const int64_t *ord, int eob,
                          int n_coded) {
#if OAV1_F64_VEC
    const __m512i vdq = _mm512_set1_epi64(dq_ac);
    const __m512i vdq0 = _mm512_mask_set1_epi64(vdq, 1, dq_dc);
    __m512d acc = _mm512_setzero_pd();
    int m1 = (eob + 7) & ~7; /* err2 region incl. the boundary block */
    int i = 0;
    for (; i < m1; i += 8) {
        __m512i lv = _mm512_loadu_si512((const void *)(ord + i));
        __m512i p = _mm512_srli_epi64(
            _mm512_mullo_epi64(lv, i ? vdq : vdq0), (unsigned)shift);
        __m512d e = _mm512_sub_pd(_mm512_loadu_pd(a_scan + i),
                                  _mm512_cvtepi64_pd(p));
        acc = _mm512_add_pd(acc, _mm512_mul_pd(e, e));
    }
    for (; i < n_coded; i += 8) { /* past eob: levels all zero */
        __m512d av = _mm512_loadu_pd(a_scan + i);
        acc = _mm512_add_pd(acc, _mm512_mul_pd(av, av));
    }
    double lanes[8], s = 0.0;
    _mm512_storeu_pd(lanes, acc);
    for (int l = 0; l < 8; l++) s += lanes[l];
    return s;
#else
    double tsq[64 * 64];
    verr2_terms_f64(a_scan, ord, n_coded, dq_ac, shift, tsq);
    double e0 = a_scan[0] - (double)((ord[0] * dq_dc) >> shift);
    tsq[0] = e0 * e0;
    return vsum8_f64(tsq, n_coded);
#endif
}

/* RDOQ rate model: bit costs in 1/128-bit units at 1/256 probability
 * resolution. This table is generated from frame.py's _PROB_COST
 * expression — the two must stay identical for byte parity. */
static const int32_t PROB_COST[256] = {
    1024,  896,  821,  768,  727,  693,  665,  640,  618,  599,  581,  565,
     550,  537,  524,  512,  501,  490,  480,  471,  462,  453,  445,  437,
     430,  422,  415,  409,  402,  396,  390,  384,  378,  373,  367,  362,
     357,  352,  347,  343,  338,  334,  329,  325,  321,  317,  313,  309,
     305,  302,  298,  294,  291,  287,  284,  281,  277,  274,  271,  268,
     265,  262,  259,  256,  253,  250,  248,  245,  242,  239,  237,  234,
     232,  229,  227,  224,  222,  219,  217,  215,  212,  210,  208,  206,
     204,  201,  199,  197,  195,  193,  191,  189,  187,  185,  183,  181,
     179,  177,  175,  174,  172,  170,  168,  166,  165,  163,  161,  159,
     158,  156,  154,  153,  151,  149,  148,  146,  145,  143,  141,  140,
     138,  137,  135,  134,  132,  131,  129,  128,  127,  125,  124,  122,
     121,  120,  118,  117,  115,  114,  113,  111,  110,  109,  108,  106,
     105,  104,  102,  101,  100,   99,   97,   96,   95,   94,   93,   91,
      90,   89,   88,   87,   86,   84,   83,   82,   81,   80,   79,   78,
      77,   76,   75,   73,   72,   71,   70,   69,   68,   67,   66,   65,
      64,   63,   62,   61,   60,   59,   58,   57,   56,   55,   54,   53,
      52,   51,   50,   49,   48,   47,   47,   46,   45,   44,   43,   42,
      41,   40,   39,   38,   37,   37,   36,   35,   34,   33,   32,   31,
      31,   30,   29,   28,   27,   26,   25,   25,   24,   23,   22,   21,
      21,   20,   19,   18,   17,   17,   16,   15,   14,   13,   13,   12,
      11,   10,   10,    9,    8,    7,    7,    6,    5,    4,    4,    3,
       2,    1,    1,    0};

/* λ = (dq_ac² >> 2·shift) · KNUM / (KDEN · 128) — frame.py RDOQ_K */
#define RDOQ_KNUM 1
#define RDOQ_KDEN 4

static int32_t icdf_sym_cost(const uint16_t *row, int s) {
    int prev = s == 0 ? 32768 : row[s - 1];
    int p = prev - row[s];
    if (p < 1) p = 1;
    int idx = (p - 1) >> 7;
    if (idx > 255) idx = 255;
    return PROB_COST[idx];
}

static void build_rdoq_costs(Tile *t) {
    for (int txs = 0; txs < 5; txs++)
        for (int pt = 0; pt < 2; pt++) {
            for (int c = 0; c < 42; c++) {
                const uint16_t *row = t->cdf[CDF_COEFF_BASE] +
                                      ((size_t)(txs * 2 + pt) * 42 + c) * 5;
                for (int s = 0; s < 4; s++)
                    t->rc_base[txs][pt][c][s] = icdf_sym_cost(row, s);
            }
            for (int c = 0; c < 4; c++) {
                const uint16_t *row = t->cdf[CDF_COEFF_BASE_EOB] +
                                      ((size_t)(txs * 2 + pt) * 4 + c) * 4;
                for (int s = 0; s < 3; s++)
                    t->rc_base_eob[txs][pt][c][s] = icdf_sym_cost(row, s);
            }
            for (int c = 0; c < 9; c++) {
                const uint16_t *row = t->cdf[CDF_EOB_EXTRA] +
                                      ((size_t)(txs * 2 + pt) * 9 + c) * 3;
                for (int s = 0; s < 2; s++)
                    t->rc_eob_extra[txs][pt][c][s] = icdf_sym_cost(row, s);
            }
        }
    for (int txs = 0; txs < 4; txs++)
        for (int pt = 0; pt < 2; pt++)
            for (int c = 0; c < 21; c++) {
                const uint16_t *row = t->cdf[CDF_COEFF_BR] +
                                      ((size_t)(txs * 2 + pt) * 21 + c) * 5;
                for (int s = 0; s < 4; s++)
                    t->rc_br[txs][pt][c][s] = icdf_sym_cost(row, s);
            }
    static const int eob_cdf_idx[4] = {CDF_EOB_PT16, CDF_EOB_PT64,
                                       CDF_EOB_PT256, CDF_EOB_PT1024};
    static const int eob_nsym_by[4] = {5, 7, 9, 11};
    for (int k = 0; k < 4; k++)
        for (int pt = 0; pt < 2; pt++) {
            int nsym = eob_nsym_by[k];
            const uint16_t *row =
                t->cdf[eob_cdf_idx[k]] + (size_t)pt * 2 * (nsym + 1);
            for (int s = 0; s < nsym; s++)
                t->rc_eob_pt[k][pt][s] = icdf_sym_cost(row, s);
        }
    static const int eob_rect_idx[2] = {CDF_EOB_PT128, CDF_EOB_PT512};
    static const int eob_rect_nsym[2] = {8, 10};
    for (int k = 0; k < 2; k++)
        for (int pt = 0; pt < 2; pt++) {
            if (!t->cdf[eob_rect_idx[k]]) continue;
            int nsym = eob_rect_nsym[k];
            const uint16_t *row =
                t->cdf[eob_rect_idx[k]] + (size_t)pt * 2 * (nsym + 1);
            for (int s = 0; s < nsym; s++)
                t->rc_eob_pt_rect[k][pt][s] = icdf_sym_cost(row, s);
        }
    for (int cat = 0; cat < 4; cat++)
        for (int ctx = 0; ctx < 3; ctx++) {
            const uint16_t *row =
                t->cdf[CDF_TX_SIZE] + ((size_t)cat * 3 + ctx) * 4;
            for (int s = 0; s < 3; s++)
                t->rc_txsz[cat][ctx][s] = icdf_sym_cost(row, s);
        }
    /* RDOQ decrement deltas / level-cost bands (the per-quantize ctx
     * scans, hoisted: exact per-ctx deltas for phase 3, offset-class
     * bands for phase 1) */
    static const int OCBASE[6] = {0, 1, 6, 11, 16, 21};
    for (int txs = 0; txs < 5; txs++)
        for (int pt = 0; pt < 2; pt++) {
            const int32_t(*base)[4] = t->rc_base[txs][pt];
            for (int b = 0; b < 26; b++) {
                t->rc_dd3_lo[txs][pt][b][0] = 0.0;
                t->rc_dd3_hi[txs][pt][b][0] = 0.0;
                for (int l = 1; l < 4; l++) {
                    int d = (int)base[b][l] - (int)base[b][l - 1] +
                            (l == 1 ? 128 : 0);
                    t->rc_dd3_lo[txs][pt][b][l] = (double)(d - 1);
                    t->rc_dd3_hi[txs][pt][b][l] = (double)(d + 1);
                }
            }
            /* offset-class-tightened bands: a position's ctx spans only
             * OCBASE[oc]..OCBASE[oc]+4 (oc 0 = DC is exactly ctx 0) */
            for (int oc = 0; oc < 6; oc++) {
                int span = oc == 0 ? 1 : 5;
                for (int l = 1; l < 4; l++) {
                    int icmin = 1 << 30, icmax = -(1 << 30);
                    for (int m = 0; m < span; m++) {
                        int b = OCBASE[oc] + m;
                        int ic = (int)base[b][l] + 128;
                        if (ic < icmin) icmin = ic;
                        if (ic > icmax) icmax = ic;
                    }
                    t->rc_ic_min[txs][pt][oc][l] = icmin;
                    t->rc_ic_max[txs][pt][oc][l] = icmax;
                }
                t->rc_ic_min[txs][pt][oc][0] = 0;
                t->rc_ic_max[txs][pt][oc][0] = 0;
            }
        }
    /* scan-position decompositions + prefix row max + offset class */
    static const int SCAN_LEN[6] = {16, 64, 256, 1024, 512, 512};
    static const int SCAN_W[6] = {4, 8, 16, 32, 32, 16};
    for (int k = 0; k < 6; k++) {
        if (!t->scan[k]) continue;
        int lw = log2i(SCAN_W[k]);
        int rect = k == 4 ? 1 : (k == 5 ? 2 : 0);
        int16_t rmax = 0;
        for (int si = 0; si < SCAN_LEN[k]; si++) {
            int pos = t->scan[k][si];
            int rr = pos >> lw, cc = pos & (SCAN_W[k] - 1);
            t->scan_r[k][si] = (int16_t)rr;
            t->scan_c[k][si] = (int16_t)cc;
            if (rr > rmax) rmax = (int16_t)rr;
            t->scan_rmax[k][si] = rmax;
            int8_t oc;
            if (rr == 0 && cc == 0) oc = 0;
            else if (rect == 1 && cc < 2) oc = 4;
            else if (rect == 2 && rr < 2) oc = 3;
            else if (!rect && rr + cc < 2) oc = 1;
            else if (rr + cc < 4) oc = 2;
            else oc = 5;
            t->scan_oc[k][si] = oc;
        }
    }
}

static const int WS_SQ_OFF[4] = {0, 16, 80, 336};

/* RDOQ frequency-weight vectors: must run AFTER rdoq_hf/rdoq_hf_uv are
 * set. Entries are bit-identical to the WS macro the quantizers used to
 * evaluate per call (same IEEE expression, computed once). */
static void build_ws_tables(Tile *t) {
    static const int SQ_N[4] = {16, 64, 256, 1024};
    for (int pt = 0; pt < 2; pt++) {
        double hf_a = pt ? t->rdoq_hf_uv : t->rdoq_hf;
        for (int k = 0; k < 4; k++) {
            double *w = t->ws_sq[pt] + WS_SQ_OFF[k];
            double hf_den = (double)SQ_N[k];
            for (int si = 0; si < SQ_N[k]; si++)
                w[si] = hf_a > 0.0
                            ? 1.0 / (1.0 + hf_a * (double)si / hf_den)
                            : 1.0;
        }
        for (int k = 0; k < 2; k++) {
            double *w = t->ws_rect[pt] + (k ? 128 : 0);
            int n = k ? 512 : 128;
            double hf_den = (double)n;
            for (int si = 0; si < n; si++)
                w[si] = hf_a > 0.0
                            ? 1.0 / (1.0 + hf_a * (double)si / hf_den)
                            : 1.0;
        }
    }
}

/* ---- RDOQ (mirrors frame.py _rdoq exactly, incl. float op order) ---- */

typedef struct {
    const int32_t (*base)[4];
    const int32_t (*base_eob)[3];
    const int32_t (*br)[4];
    const int32_t (*eob_extra)[2];
    const int32_t *eob_pt;
    const int16_t *pos_r, *pos_c; /* tile scan_r/scan_c rows */
    const int8_t *oc;             /* tile scan_oc row */
    const int16_t *rmax;          /* tile scan_rmax row */
    const double (*dd3_lo)[4], (*dd3_hi)[4];  /* rc_dd3_* [bctx] rows
                                                 (guarded bounds, f64) */
    const int32_t (*ic_min)[4], (*ic_max)[4]; /* rc_ic_* [oc] rows */
    int n_coded, cw;
    int rect; /* 0 square, 1 wide (w>h), 2 tall — rect base-ctx bands */
    int pad[34 * 34 + 16]; /* +16: the bulk mag map's full-width vector
                              loads may overread past a row end (the
                              overread lanes are discarded) */
} Rdoq;

static int rdoq_hi_cost(const Rdoq *q, int brctx, int64_t lvl) {
    int r = 0;
    int64_t rem = lvl - 3;
    for (int i = 0; i < 4; i++) {
        int k = rem < 3 ? (int)rem : 3;
        r += q->br[brctx][k];
        rem -= k;
        if (k < 3) break;
    }
    if (lvl > 14) {
        int bl = 64 - __builtin_clzll((unsigned long long)(lvl - 14));
        r += 128 * (2 * bl - 1);
    }
    return r;
}

static int rdoq_base_ctx(const Rdoq *q, int si) {
    int rr = q->pos_r[si], cc = q->pos_c[si];
    const int *pad = q->pad;
    int W = q->cw + 2;
    int mag = imin(pad[rr * W + cc + 1], 3) + imin(pad[(rr + 1) * W + cc], 3) +
              imin(pad[(rr + 1) * W + cc + 1], 3) +
              imin(pad[rr * W + cc + 2], 3) + imin(pad[(rr + 2) * W + cc], 3);
    mag = imin((mag + 1) >> 1, 4);
    if (rr == 0 && cc == 0) return 0;
    if (q->rect == 1 && cc < 2) return mag + 16;
    if (q->rect == 2 && rr < 2) return mag + 11;
    if (!q->rect && rr + cc < 2) return mag + 1;
    if (rr + cc < 4) return mag + 6;
    return mag + 21;
}

static int rdoq_br_ctx(const Rdoq *q, int si) {
    int rr = q->pos_r[si], cc = q->pos_c[si];
    const int *pad = q->pad;
    int W = q->cw + 2;
    int mag = imin(pad[rr * W + cc + 1], 15) +
              imin(pad[(rr + 1) * W + cc], 15) +
              imin(pad[(rr + 1) * W + cc + 1], 15);
    mag = imin((mag + 1) >> 1, 6);
    if (rr == 0 && cc == 0) return mag;
    if (rr < 2 && cc < 2) return mag + 7;
    return mag + 14;
}

static int rdoq_eob_ctx(const Rdoq *q, int si) {
    if (si == 0) return 0;
    if (si <= q->n_coded / 8) return 1;
    if (si <= q->n_coded / 4) return 2;
    return 3;
}

static int rdoq_int_cost(const Rdoq *q, int64_t lvl, int bctx, int si) {
    int r = q->base[bctx][lvl < 3 ? (int)lvl : 3];
    if (lvl) {
        r += 128; /* sign */
        if (lvl > 3) r += rdoq_hi_cost(q, rdoq_br_ctx(q, si), lvl);
    }
    return r;
}

static int rdoq_eob_coeff_cost(const Rdoq *q, int64_t lvl, int si) {
    int r = q->base_eob[rdoq_eob_ctx(q, si)][(lvl < 3 ? (int)lvl : 3) - 1] + 128;
    if (lvl > 3) r += rdoq_hi_cost(q, rdoq_br_ctx(q, si), lvl);
    return r;
}

static int rdoq_eobpt_cost(const Rdoq *q, int e) {
    int pt;
    if (e == 1) pt = 1;
    else if (e == 2) pt = 2;
    else pt = (32 - __builtin_clz((unsigned)(e - 1))) + 1;
    int r = q->eob_pt[pt - 1];
    if (pt >= 3) {
        int nbits = pt - 2;
        int rest = e - (1 << (pt - 2)) - 1;
        int msb = (rest >> (nbits - 1)) & 1;
        r += q->eob_extra[pt - 3][msb] + 128 * (nbits - 1);
    }
    return r;
}

/* Bulk base-ctx stencil-sum map over the pad: for every grid position,
 * the RAW sum of the 5 clamped-to-3 neighbors (rdoq_base_ctx's mag
 * before its (s+1)>>1 / clamp-4 — applied at read time, 2 ops), 16
 * columns per vector step. Keeping sums instead of clamped mags makes
 * the phase-3 decrement resync 5 in-place decrements (a level drop
 * from lvl <= 3 lowers each affected stencil sum by exactly 1) instead
 * of 5 full stencil recomputes. Row overreads land in the next pad row
 * (allocated; lanes discarded). */
static void vsum5_map(const int *pad, int W, int rows, int cw,
                      int8_t *summ) {
    for (int rr = 0; rr < rows; rr++) {
        const int *p0 = pad + (size_t)rr * W;
        const int *p1 = p0 + W, *p2 = p1 + W;
        int c = 0;
#if OAV1_F64_VEC
        const __m512i three = _mm512_set1_epi32(3);
        for (; c < cw; c += 16) {
            __m512i a = _mm512_min_epi32(
                _mm512_loadu_si512((const void *)(p0 + c + 1)), three);
            __m512i b = _mm512_min_epi32(
                _mm512_loadu_si512((const void *)(p1 + c)), three);
            __m512i d = _mm512_min_epi32(
                _mm512_loadu_si512((const void *)(p1 + c + 1)), three);
            __m512i e = _mm512_min_epi32(
                _mm512_loadu_si512((const void *)(p0 + c + 2)), three);
            __m512i f = _mm512_min_epi32(
                _mm512_loadu_si512((const void *)(p2 + c)), three);
            __m512i m = _mm512_add_epi32(
                _mm512_add_epi32(_mm512_add_epi32(a, b),
                                 _mm512_add_epi32(d, e)),
                f);
            int rem = cw - c < 16 ? cw - c : 16;
            __m128i m8 = _mm512_cvtepi32_epi8(m);
            if (rem == 16) {
                _mm_storeu_si128((__m128i *)(summ + (size_t)rr * cw + c),
                                 m8);
            } else {
                int8_t tmp[16];
                _mm_storeu_si128((__m128i *)tmp, m8);
                memcpy(summ + (size_t)rr * cw + c, tmp, (size_t)rem);
            }
        }
#else
        for (; c < cw; c++) {
            int mag = imin(p0[c + 1], 3) + imin(p1[c], 3) +
                      imin(p1[c + 1], 3) + imin(p0[c + 2], 3) +
                      imin(p2[c], 3);
            summ[(size_t)rr * cw + c] = (int8_t)mag;
        }
#endif
    }
}

/* mag read from the sum map: rdoq_base_ctx's final two ops */
static inline int mag_of_sum(int s) { return imin((s + 1) >> 1, 4); }

/* Fused txb rate: identical integer value to rate_estimate_scan/_rect
 * over the same final levels, but computed from the quantizer's OWN
 * end-of-phase pad (which equals the pad those functions rebuild from
 * scratch: drops zero it, decrements update it, kept levels restore
 * it). Every term is the same frozen-table lookup; the base-ctx mags
 * come from one vectorized sweep over the static pad instead of 5
 * scalar neighbor reads per coefficient. */
static int64_t rdoq_rate_from_pad_m(const Rdoq *q, const int64_t *ord,
                                    int eob, const int8_t *summ) {
    if (eob == 0) return 256; /* txb_skip=1, ~2 bits */
    int64_t r = 128 + rdoq_eobpt_cost(q, eob);
    r += rdoq_eob_coeff_cost(q, ord[eob - 1], eob - 1);
    if (eob < 2) return r;
    static const int OCB[6] = {0, 1, 6, 11, 16, 21};
    for (int si = eob - 2; si >= 0; si--) {
        int64_t lvl = ord[si];
        int oc = q->oc[si];
        int bctx = oc == 0
                       ? 0
                       : OCB[oc] +
                             mag_of_sum(summ[(size_t)q->pos_r[si] * q->cw +
                                             q->pos_c[si]]);
        r += q->base[bctx][lvl < 3 ? (int)lvl : 3];
        if (lvl) {
            r += 128;
            if (lvl > 3)
                r += rdoq_hi_cost(q, rdoq_br_ctx(q, si), lvl);
        }
    }
    return r;
}

static int64_t rdoq_rate_from_pad(const Rdoq *q, const int64_t *ord,
                                  int eob) {
    static _Thread_local int8_t summ[32 * 32];
    if (eob >= 2)
        vsum5_map(q->pad, q->cw + 2, q->rmax[eob - 2] + 1, q->cw, summ);
    return rdoq_rate_from_pad_m(q, ord, eob, summ);
}

/* --- phase 3 (interior level decrements, reverse scan), shared by the
 * square and rect quantizers ---
 * EXACT per-position base contexts: one bulk stencil-sum sweep over
 * the post-phase-2 pad (vsum5_map) replaces the 5-neighbor ctx read
 * per position, and the old offset-class bands collapse to the
 * position's exact decrement rate delta rc_dd3[bctx][lvl]. The
 * +-1-cost-unit guard keeps outcomes identical to the full float
 * evaluation: the regrouped (ed-ek) < lam*delta compare differs from
 * the original (ed+lam*c1) < (ek+lam*c0) by ~1e-13 relative rounding,
 * dwarfed by a full lam cost unit; marginal cases re-run the original
 * op order. The sum map stays in sync with pad across decrements at 5
 * in-place decrements each (a drop from lvl <= 3 lowers min(lvl,3) by
 * exactly 1; the stencil positions reading (rr,cc) are scan-earlier,
 * i.e. not yet visited in reverse scan; a drop from lvl > 3 leaves
 * min(lvl,3) unchanged). Post: summ == vsum5_map(final pad), so the
 * fused rate reuses it. */
static void rdoq_phase3(Rdoq *q, int64_t *ord, int eob, double lam,
                        const double *ek_pre, const double *ed_pre,
                        int8_t *summ) {
    static const int OCB[6] = {0, 1, 6, 11, 16, 21};
    int W = q->cw + 2, cw = q->cw;
    int rows3 = q->rmax[eob - 2] + 1;
    double inv_lam = 1.0 / lam;
    vsum5_map(q->pad, W, rows3, cw, summ);
    for (int si = eob - 2; si >= 0; si--) {
        int64_t lvl = ord[si];
        if (lvl == 0) continue;
        double ek = ek_pre[si], ed = ed_pre[si];
        double dd = ed - ek;
        int rr = q->pos_r[si], cc = q->pos_c[si];
        if (lvl <= 3) {
            int oc = q->oc[si];
            int bctx =
                oc == 0
                    ? 0
                    : OCB[oc] + mag_of_sum(summ[(size_t)rr * cw + cc]);
            double rr_ = dd * inv_lam;
            if (rr_ >= q->dd3_hi[bctx][lvl]) continue;
            int dec;
            if (rr_ < q->dd3_lo[bctx][lvl]) {
                dec = 1;
            } else {
                /* marginal: the original-order exact evaluation */
                dec = ed + lam * (double)rdoq_int_cost(q, lvl - 1, bctx,
                                                       si) <
                      ek + lam * (double)rdoq_int_cost(q, lvl, bctx, si);
            }
            if (!dec) continue;
            ord[si] = lvl - 1;
            q->pad[rr * W + cc] = (int)(lvl - 1);
            /* each stencil source reading (rr,cc) loses exactly 1 */
            int8_t *sr = summ + (size_t)rr * cw + cc;
            if (cc >= 1) sr[-1]--;                      /* (rr, cc-1) */
            if (cc >= 2) sr[-2]--;                      /* (rr, cc-2) */
            if (rr >= 1) {
                sr[-(ptrdiff_t)cw]--;                   /* (rr-1, cc) */
                if (cc >= 1) sr[-(ptrdiff_t)cw - 1]--;  /* (rr-1,cc-1) */
            }
            if (rr >= 2) sr[-2 * (ptrdiff_t)cw]--;      /* (rr-2, cc) */
        } else {
            if (dd * inv_lam >= 6144.0) continue; /* provably losing */
            int bctx = rdoq_base_ctx(q, si);
            if (ed + lam * (double)rdoq_int_cost(q, lvl - 1, bctx, si) <
                ek + lam * (double)rdoq_int_cost(q, lvl, bctx, si)) {
                ord[si] = lvl - 1;
                q->pad[rr * W + cc] =
                    (lvl - 1) < 127 ? (int)(lvl - 1) : 127;
                /* lvl-1 >= 3: min(pad,3) unchanged, summ stays valid */
            }
        }
    }
}

static void quantize_mat(const Tile *t, const int32_t *resid, int n,
                         int ptype, int fi, int32_t *levels, double *e2_out,
                         int64_t *ord_out, int *eob_out, int64_t *rate_out) {
    PROF_SCOPE(PROF_QUANT);
    /* Q12 integer forward transform (mirrors transform.py
     * fwd_txfm2d_int exactly — integer ops are order-independent, so the
     * VNNI kernels and NumPy agree bit-for-bit). */
    int16_t r16[64 * 64];
    int32_t bp1[32 * 64];
    int32_t st1[64 * 64];
    int16_t tmp16[64 * 64];
    int32_t out32[64 * 64];
    double _pq0 = prof_enabled > 0 ? prof_now() : 0.0;
    for (int i = 0; i < n * n; i++) r16[i] = (int16_t)resid[i];
    for (int kp = 0; kp < n / 2; kp++) {
        const int16_t *r0 = r16 + (size_t)(2 * kp) * n, *r1 = r0 + n;
        int32_t *p = bp1 + (size_t)kp * n;
        for (int c = 0; c < n; c++)
            p[c] = (int32_t)((uint32_t)(uint16_t)r0[c] |
                             ((uint32_t)(uint16_t)r1[c] << 16));
    }
    mm_i16_pairs(t->fh16[fi], bp1, n, st1);
    int sa = t->fwd_sa[fi];
    int32_t rnd = sa ? 1 << (sa - 1) : 0;
    for (int i = 0; i < n * n; i++)
        tmp16[i] = (int16_t)((st1[i] + rnd) >> sa);
    mm_i16_pairs(tmp16, t->fwP[fi], n, out32);
    if (prof_enabled > 0) { prof_acc[PROF_QFWD] += prof_now() - _pq0; prof_cnt[PROF_QFWD]++; _pq0 = prof_now(); }
    double inv_scale = t->fwd_inv_scale[fi];
    int shift = DQ_SHIFT_BY_TX[n];
    /* per-element (v * (1<<shift)) / dq in that op order — one rounding,
     * matching NumPy's _quantize exactly (a precomputed reciprocal scale
     * adds a second rounding that can flip floor() at integer boundaries) */
    double up = (double)(1 << shift);
    int dqa_i = ptype ? t->dq_ac_uv : t->dq_ac;
    double dq_ac = (double)dqa_i, dq_dc = (double)t->dq_dc;

    int cw = n < 32 ? n : 32;
    int n_coded = cw * cw;
    const int32_t *scan = t->scan[log2i(cw) - 2];
    int txs = log2i(n) - 2;

    memset(levels, 0, (size_t)n * n * 4);

    /* coded-region magnitudes, natural (cw-wide) order, at the real
     * coefficient scale (exact: int32 x a pow2 factor); signs are read
     * straight from out32 at the levels write-out */
    double a_nat[32 * 32];
    for (int r = 0; r < cw; r++)
        vabs_scale_f64(out32 + (size_t)r * n, cw, inv_scale, a_nat + r * cw);

    /* magnitudes gathered to scan order once; every later use is then a
     * unit-stride stream (AV1 scans always put DC at si = 0, so the dq
     * select needs no gather either) */
    double a_scan[1024];
    for (int si = 0; si < n_coded; si++) a_scan[si] = a_nat[scan[si]];

    /* initial round-half levels, scan order: AC vectorized, DC redone
     * scalar with its own quantizer */
    int64_t ord[1024];
    vquant_f64(a_scan, n_coded, up, dq_ac, ord);
    ord[0] = (int64_t)floor(a_scan[0] * up / dq_dc + 0.5);
    int eob = veob_scan(ord, n_coded);
    if (eob == 0) {
        if (e2_out)
            *e2_out = e2_scan_f64(t->dq_dc, dqa_i, shift, a_scan, ord, 0,
                                  n_coded);
        if (eob_out) *eob_out = 0;
        if (rate_out) *rate_out = 256;
        return;
    }
    if (prof_enabled > 0) { prof_acc[PROF_QSETUP] += prof_now() - _pq0; prof_cnt[PROF_QSETUP]++; _pq0 = prof_now(); }

    int sk = log2i(cw) - 2;
    Rdoq q;
    q.base = t->rc_base[txs][ptype];
    q.base_eob = t->rc_base_eob[txs][ptype];
    q.br = t->rc_br[txs < 3 ? txs : 3][ptype];
    q.eob_extra = t->rc_eob_extra[txs][ptype];
    q.eob_pt = t->rc_eob_pt[sk][ptype];
    q.pos_r = t->scan_r[sk];
    q.pos_c = t->scan_c[sk];
    q.oc = t->scan_oc[sk];
    q.rmax = t->scan_rmax[sk];
    q.dd3_lo = t->rc_dd3_lo[txs][ptype];
    q.dd3_hi = t->rc_dd3_hi[txs][ptype];
    q.ic_min = t->rc_ic_min[txs][ptype];
    q.ic_max = t->rc_ic_max[txs][ptype];
    q.n_coded = n_coded;
    q.cw = cw;
    q.rect = 0;
    int W = cw + 2;
    if (t->speed < 10 || rate_out) {
        /* zero only the rows the context reads can touch (max coded
         * row + 2 neighbors): a full 34x34 memset dominated this stage
         * on dense-coefficient content */
        int maxr = t->scan_rmax[sk][eob - 1];
        int zrows = maxr + 3 < W ? maxr + 3 : W;
        memset(q.pad, 0, sizeof(int) * (size_t)W * zrows);
        for (int si = 0; si < eob; si++)
            if (ord[si])
                q.pad[q.pos_r[si] * W + q.pos_c[si]] =
                    ord[si] < 127 ? (int)ord[si] : 127;
    }
    if (t->speed >= 10) {
        /* speed 10: plain round-half quantization, no RDOQ passes */
        for (int si = 0; si < eob; si++) {
            if (!ord[si]) continue;
            size_t oi = (size_t)q.pos_r[si] * n + q.pos_c[si];
            levels[oi] = out32[oi] < 0 ? (int32_t)-ord[si]
                                       : (int32_t)ord[si];
        }
        if (ord_out) memcpy(ord_out, ord, (size_t)eob * 8);
        if (eob_out) *eob_out = eob;
        if (e2_out)
            *e2_out = e2_scan_f64(t->dq_dc, dqa_i, shift, a_scan, ord, eob,
                                  n_coded);
        if (rate_out) *rate_out = rdoq_rate_from_pad(&q, ord, eob);
        return;
    }

    double lam = (double)((((int64_t)dqa_i * dqa_i) >> (2 * shift)) *
                          RDOQ_KNUM) /
                 (RDOQ_KDEN * 128.0) * t->cur_lamscale;

    /* Frequency-weighted RDOQ distortion (mirrors frame.py _rdoq):
     * scale the error term at scan position si by 1/(1 + a*si/n_coded),
     * so level decrements fire more readily on high-frequency
     * coefficients. SSIMULACRA2's blur+downsample pyramid discounts HF
     * error, so MSE-faithful RDOQ over-spends on noise coefficients the
     * metric cannot see (the reference's libaom plays the same game
     * with quantization matrices). a = 2 on non-screen frames (measured
     * -2..-6% iso-score bytes on sinusoid/fractal/mixed/oriented), 0 on
     * screen-content frames whose value IS the HF (text/edges regressed
     * +6..13% under weighting). OAVIF_RDOQ_HF overrides. Weights come
     * from the tile's precomputed table (build_ws_tables) — values are
     * the identical IEEE expression, minus the per-call divisions. */
    const double *ws = t->ws_sq[ptype] + WS_SQ_OFF[sk];

    /* Distortion-term precompute for ALL phases (vectorized): keep
     * (ek_pre, at the initial level), decrement (ed_pre, level-1) and
     * drop (e0sq, level 0) terms. Exactness: phase 1 only ZEROES a
     * strict suffix, reading each position's terms at its initial
     * level; phase 2 touches only the final eob coefficient (still at
     * its initial level); phase 3 visits each interior position once.
     * So every term a phase reads is exactly what the old in-place
     * ERR2 evaluation computed (identical per-element IEEE op order).
     * DC (si 0) is scalar for its own quantizer. */
    static _Thread_local double ek_pre[1024], ed_pre[1024], e0sq[1024];
    {
        int64_t l0 = ord[0];
        double a0 = a_scan[0];
        double e0 = a0 - (double)((l0 * t->dq_dc) >> shift);
        double e1 = a0 - (double)(((l0 - 1) * t->dq_dc) >> shift);
        ek_pre[0] = e0 * e0 * ws[0];
        ed_pre[0] = e1 * e1 * ws[0];
        vdec_terms_f64(a_scan + 1, ord + 1, ws + 1, eob - 1, dqa_i,
                       shift, ek_pre + 1, ed_pre + 1);
        vdrop_terms_f64(a_scan, ws, eob, e0sq);
    }

    /* --- phase 1: eob shrinking ---
     * The only pad-dependent term in the drop-vs-keep comparison is
     * rdoq_int_cost(lp, bctx(pe)); for lp <= 3 it lies in the
     * offset-class band [ic_min, ic_max] (bctx = OCBASE[oc(pe)] + mag,
     * mag 0..4). When the margin clears the band by one cost unit the
     * decision skips the 5-neighbor context read; the +-1 guard dwarfs
     * the regrouped-float rounding (same argument as phase 3's bands,
     * documented there), so outcomes are identical.
     * Drop chains average ~35 iterations on dense content, so the two
     * rate terms that recur across iterations are carried: after a
     * drop, the new tail's eobpt(eob) IS the just-computed eobpt(pe+1)
     * and its eob-coeff cost IS the just-computed ec(lp, pe). */
    int c_eobpt = eob > 0 ? rdoq_eobpt_cost(&q, eob) : 0;
    int c_ec = eob > 0 ? rdoq_eob_coeff_cost(&q, ord[eob - 1], eob - 1) : 0;
    while (eob > 0) {
        int si = eob - 1;
        int64_t lvl = ord[si];
        double keep = ek_pre[si] + lam * (double)(c_eobpt + c_ec);
        int pe = si - 1;
        while (pe >= 0 && ord[pe] == 0) pe--;
        q.pad[q.pos_r[si] * W + q.pos_c[si]] = 0;
        if (pe < 0) {
            if (e0sq[si] < keep) {
                ord[si] = 0;
                eob = 0;
            } else {
                q.pad[q.pos_r[si] * W + q.pos_c[si]] =
                    lvl < 127 ? (int)lvl : 127;
            }
            break;
        }
        int64_t lp = ord[pe];
        int n_eobpt = rdoq_eobpt_cost(&q, pe + 1);
        int n_ec = rdoq_eob_coeff_cost(&q, lp, pe);
        double drop = e0sq[si] + lam * (double)(n_eobpt + n_ec);
        int do_drop;
        double m;
        if (lp <= 3 &&
            ((m = drop - keep) <
                 lam * (double)(q.ic_min[q.oc[pe]][lp] - 1) ||
             m >= lam * (double)(q.ic_max[q.oc[pe]][lp] + 1))) {
            do_drop = m < lam * (double)(q.ic_min[q.oc[pe]][lp] - 1);
        } else {
            keep += lam *
                    (double)rdoq_int_cost(&q, lp, rdoq_base_ctx(&q, pe), pe);
            do_drop = drop < keep;
        }
        if (do_drop) {
            ord[si] = 0;
            eob = pe + 1;
            c_eobpt = n_eobpt;
            c_ec = n_ec;
        } else {
            q.pad[q.pos_r[si] * W + q.pos_c[si]] = lvl < 127 ? (int)lvl : 127;
            break;
        }
    }

    static _Thread_local int8_t summ[32 * 32];
    if (eob > 0) {
        /* --- phase 2: eob coefficient level decrement (floor 1) --- */
        int si = eob - 1;
        int64_t lvl = ord[si];
        if (lvl >= 2) {
            if (ed_pre[si] +
                    lam * (double)rdoq_eob_coeff_cost(&q, lvl - 1, si) <
                ek_pre[si] +
                    lam * (double)rdoq_eob_coeff_cost(&q, lvl, si)) {
                ord[si] = lvl - 1;
                q.pad[q.pos_r[si] * W + q.pos_c[si]] =
                    (lvl - 1) < 127 ? (int)(lvl - 1) : 127;
            }
        }
        /* --- phase 3: exact-ctx interior decrements (rdoq_phase3) --- */
        if (eob >= 2)
            rdoq_phase3(&q, ord, eob, lam, ek_pre, ed_pre, summ);
    }

    if (prof_enabled > 0) { prof_acc[PROF_QRDOQ] += prof_now() - _pq0; prof_cnt[PROF_QRDOQ]++; _pq0 = prof_now(); }
    for (int si = 0; si < eob; si++) {
        if (!ord[si]) continue;
        size_t oi = (size_t)q.pos_r[si] * n + q.pos_c[si];
        levels[oi] = out32[oi] < 0 ? (int32_t)-ord[si] : (int32_t)ord[si];
    }
    if (ord_out) memcpy(ord_out, ord, (size_t)eob * 8);
    if (eob_out) *eob_out = eob;
    if (rate_out)
        *rate_out = eob >= 2 ? rdoq_rate_from_pad_m(&q, ord, eob, summ)
                             : rdoq_rate_from_pad(&q, ord, eob);
    if (e2_out) {
        *e2_out = e2_scan_f64(t->dq_dc, dqa_i, shift, a_scan, ord, eob,
                              n_coded);
        if (prof_enabled > 0) { prof_acc[PROF_QE2] += prof_now() - _pq0; prof_cnt[PROF_QE2]++; }
    }
}

/* Rect-txb RDOQ quantize (mirrors frame.py _quantize_rect/_rdoq_rect):
 * residual (th x tw) -> levels (th x tw). Same phase structure and float
 * op order as quantize_mat with per-axis dims, the rect scan, the rect
 * dequant shift ((pels>256)+(pels>1024)) and rect base-ctx bands. */
static void quantize_rect(const Tile *t, const int32_t *resid, int tw,
                          int th, int ptype, int32_t *levels,
                          double *e2_out, int64_t *ord_out, int *eob_out,
                          int64_t *rate_out) {
    PROF_SCOPE(PROF_QUANT);
    int fi = tw > th ? 7 : 8;
    int16_t r16[32 * 32];
    int32_t bp1[16 * 32];
    int32_t st1[32 * 32];
    int16_t tmp16[32 * 32];
    int32_t out32[32 * 32];
    int npx = tw * th;
    for (int i = 0; i < npx; i++) r16[i] = (int16_t)resid[i];
    for (int kp = 0; kp < th / 2; kp++) {
        const int16_t *r0 = r16 + (size_t)(2 * kp) * tw, *r1 = r0 + tw;
        int32_t *p = bp1 + (size_t)kp * tw;
        for (int c = 0; c < tw; c++)
            p[c] = (int32_t)((uint32_t)(uint16_t)r0[c] |
                             ((uint32_t)(uint16_t)r1[c] << 16));
    }
    mm_i16_pairs_g(t->fh16[fi], bp1, th, th, tw, st1);
    int sa = t->fwd_sa[fi];
    int32_t rnd = sa ? 1 << (sa - 1) : 0;
    for (int i = 0; i < npx; i++)
        tmp16[i] = (int16_t)((st1[i] + rnd) >> sa);
    mm_i16_pairs_g(tmp16, t->fwP[fi], th, tw, tw, out32);
    double inv_scale = t->fwd_inv_scale[fi];
    int pels = tw * th;
    int shift = (pels > 256) + (pels > 1024);
    double up = (double)(1 << shift);
    int dqa_i = ptype ? t->dq_ac_uv : t->dq_ac;
    double dq_ac = (double)dqa_i, dq_dc = (double)t->dq_dc;

    int n_coded = npx;
    const int32_t *scan = t->scan[tw > th ? 4 : 5];
    int lo_i = log2i(tw < th ? tw : th), hi_i = log2i(tw > th ? tw : th);
    int txs = ((lo_i - 2) + (hi_i - 2) + 1) >> 1;

    memset(levels, 0, (size_t)npx * 4);

    double a_nat[32 * 32];
    vabs_scale_f64(out32, npx, inv_scale, a_nat);
    double a_scan[1024];
    for (int si = 0; si < n_coded; si++) a_scan[si] = a_nat[scan[si]];

    int64_t ord[1024];
    vquant_f64(a_scan, n_coded, up, dq_ac, ord);
    ord[0] = (int64_t)floor(a_scan[0] * up / dq_dc + 0.5);
    int eob = veob_scan(ord, n_coded);
    if (eob == 0) {
        if (e2_out)
            *e2_out = e2_scan_f64(t->dq_dc, dqa_i, shift, a_scan, ord, 0,
                                  n_coded);
        if (eob_out) *eob_out = 0;
        if (rate_out) *rate_out = 256;
        return;
    }

    int sk = tw > th ? 4 : 5;
    Rdoq q;
    q.base = t->rc_base[txs][ptype];
    q.base_eob = t->rc_base_eob[txs][ptype];
    q.br = t->rc_br[txs < 3 ? txs : 3][ptype];
    q.eob_extra = t->rc_eob_extra[txs][ptype];
    q.eob_pt = t->rc_eob_pt_rect[n_coded == 128 ? 0 : 1][ptype];
    q.pos_r = t->scan_r[sk];
    q.pos_c = t->scan_c[sk];
    q.oc = t->scan_oc[sk];
    q.rmax = t->scan_rmax[sk];
    q.dd3_lo = t->rc_dd3_lo[txs][ptype];
    q.dd3_hi = t->rc_dd3_hi[txs][ptype];
    q.ic_min = t->rc_ic_min[txs][ptype];
    q.ic_max = t->rc_ic_max[txs][ptype];
    q.n_coded = n_coded;
    q.cw = tw;
    q.rect = tw > th ? 1 : 2;
    int W = tw + 2;
    if (t->speed < 10 || rate_out) {
        int maxr = t->scan_rmax[sk][eob - 1];
        int zrows = maxr + 3 < th + 2 ? maxr + 3 : th + 2;
        memset(q.pad, 0, sizeof(int) * (size_t)W * zrows);
        for (int si = 0; si < eob; si++)
            if (ord[si])
                q.pad[q.pos_r[si] * W + q.pos_c[si]] =
                    ord[si] < 127 ? (int)ord[si] : 127;
    }
    if (t->speed >= 10) {
        for (int si = 0; si < eob; si++) {
            if (!ord[si]) continue;
            int pos = scan[si];
            levels[pos] = out32[pos] < 0 ? (int32_t)-ord[si]
                                         : (int32_t)ord[si];
        }
        if (ord_out) memcpy(ord_out, ord, (size_t)eob * 8);
        if (eob_out) *eob_out = eob;
        if (e2_out)
            *e2_out = e2_scan_f64(t->dq_dc, dqa_i, shift, a_scan, ord, eob,
                                  n_coded);
        if (rate_out) *rate_out = rdoq_rate_from_pad(&q, ord, eob);
        return;
    }

    double lam = (double)((((int64_t)dqa_i * dqa_i) >> (2 * shift)) *
                          RDOQ_KNUM) /
                 (RDOQ_KDEN * 128.0) * t->cur_lamscale;

    /* frequency weighting as in quantize_mat (mirrors _rdoq_rect);
     * precomputed per-ptype table, same IEEE values */
    const double *ws = t->ws_rect[ptype] + (n_coded == 128 ? 0 : 128);

    /* distortion-term precompute for all phases, as in quantize_mat
     * (same exactness argument: each phase reads a position's terms at
     * its initial level exactly once) */
    static _Thread_local double ek_pre[1024], ed_pre[1024], e0sq[1024];
    {
        int64_t l0 = ord[0];
        double a0 = a_scan[0];
        double e0 = a0 - (double)((l0 * t->dq_dc) >> shift);
        double e1 = a0 - (double)(((l0 - 1) * t->dq_dc) >> shift);
        ek_pre[0] = e0 * e0 * ws[0];
        ed_pre[0] = e1 * e1 * ws[0];
        vdec_terms_f64(a_scan + 1, ord + 1, ws + 1, eob - 1, dqa_i,
                       shift, ek_pre + 1, ed_pre + 1);
        vdrop_terms_f64(a_scan, ws, eob, e0sq);
    }

    /* --- phase 1: eob shrinking (banded + carried terms, as in
     * quantize_mat) --- */
    int c_eobpt = eob > 0 ? rdoq_eobpt_cost(&q, eob) : 0;
    int c_ec = eob > 0 ? rdoq_eob_coeff_cost(&q, ord[eob - 1], eob - 1) : 0;
    while (eob > 0) {
        int si = eob - 1;
        int64_t lvl = ord[si];
        double keep = ek_pre[si] + lam * (double)(c_eobpt + c_ec);
        int pe = si - 1;
        while (pe >= 0 && ord[pe] == 0) pe--;
        q.pad[q.pos_r[si] * W + q.pos_c[si]] = 0;
        if (pe < 0) {
            if (e0sq[si] < keep) {
                ord[si] = 0;
                eob = 0;
            } else {
                q.pad[q.pos_r[si] * W + q.pos_c[si]] =
                    lvl < 127 ? (int)lvl : 127;
            }
            break;
        }
        int64_t lp = ord[pe];
        int n_eobpt = rdoq_eobpt_cost(&q, pe + 1);
        int n_ec = rdoq_eob_coeff_cost(&q, lp, pe);
        double drop = e0sq[si] + lam * (double)(n_eobpt + n_ec);
        int do_drop;
        double m;
        if (lp <= 3 &&
            ((m = drop - keep) <
                 lam * (double)(q.ic_min[q.oc[pe]][lp] - 1) ||
             m >= lam * (double)(q.ic_max[q.oc[pe]][lp] + 1))) {
            do_drop = m < lam * (double)(q.ic_min[q.oc[pe]][lp] - 1);
        } else {
            keep += lam *
                    (double)rdoq_int_cost(&q, lp, rdoq_base_ctx(&q, pe), pe);
            do_drop = drop < keep;
        }
        if (do_drop) {
            ord[si] = 0;
            eob = pe + 1;
            c_eobpt = n_eobpt;
            c_ec = n_ec;
        } else {
            q.pad[q.pos_r[si] * W + q.pos_c[si]] = lvl < 127 ? (int)lvl : 127;
            break;
        }
    }

    static _Thread_local int8_t summ[32 * 32];
    if (eob > 0) {
        /* --- phase 2: eob coefficient level decrement (floor 1) --- */
        int si = eob - 1;
        int64_t lvl = ord[si];
        if (lvl >= 2) {
            if (ed_pre[si] +
                    lam * (double)rdoq_eob_coeff_cost(&q, lvl - 1, si) <
                ek_pre[si] +
                    lam * (double)rdoq_eob_coeff_cost(&q, lvl, si)) {
                ord[si] = lvl - 1;
                q.pad[q.pos_r[si] * W + q.pos_c[si]] =
                    (lvl - 1) < 127 ? (int)(lvl - 1) : 127;
            }
        }
        /* --- phase 3: exact-ctx interior decrements (rdoq_phase3;
         * the rect offset classes ride the same oc tables) --- */
        if (eob >= 2)
            rdoq_phase3(&q, ord, eob, lam, ek_pre, ed_pre, summ);
    }

    for (int si = 0; si < eob; si++) {
        if (!ord[si]) continue;
        int pos = scan[si];
        levels[pos] = out32[pos] < 0 ? (int32_t)-ord[si] : (int32_t)ord[si];
    }
    if (ord_out) memcpy(ord_out, ord, (size_t)eob * 8);
    if (eob_out) *eob_out = eob;
    if (rate_out)
        *rate_out = eob >= 2 ? rdoq_rate_from_pad_m(&q, ord, eob, summ)
                             : rdoq_rate_from_pad(&q, ord, eob);
    if (e2_out)
        *e2_out = e2_scan_f64(t->dq_dc, dqa_i, shift, a_scan, ord, eob,
                              n_coded);

}

/* rect dequant + normative inverse (frame.py _dequant_inv_rect): the
 * pels-thresholded shift and the bd+8 conformance clamp */
static void dequant_inv_rect(const Tile *t, const int32_t *levels, int tw,
                             int th, int ptype, int32_t *resid_out) {
    PROF_SCOPE(PROF_INV);
    int pels = tw * th;
    int shift = (pels > 256) + (pels > 1024);
    int64_t cl = ((int64_t)1 << (t->bitdepth + 7)) - 1;
    for (int i = 0; i < pels; i++) {
        int64_t lv = levels[i];
        int64_t q = i == 0 ? t->dq_dc : (ptype ? t->dq_ac_uv : t->dq_ac);
        int64_t mag = (llabs(lv) * q) & 0xFFFFFF;
        mag >>= shift;
        if (mag > cl) mag = cl;
        resid_out[i] = (int32_t)(lv < 0 ? -mag : mag);
    }
    inv_txfm2d_c(resid_out, tw, th, t->bitdepth);
}


/* dequant + normative inverse transform (frame.py _dequant_inv) */
static void dequant_inv_tt(const Tile *t, const int32_t *levels, int tx,
                           int txtype, int ptype, int32_t *resid_out) {
    PROF_SCOPE(PROF_INV);
    int shift = DQ_SHIFT_BY_TX[tx];
    for (int i = 0; i < tx * tx; i++) {
        int64_t lv = levels[i];
        int64_t q = i == 0 ? t->dq_dc : (ptype ? t->dq_ac_uv : t->dq_ac);
        int64_t mag = (llabs(lv) * q) & 0xFFFFFF;
        mag >>= shift;
        resid_out[i] = (int32_t)(lv < 0 ? -mag : mag);
    }
    if (txtype == 0)
        inv_txfm2d_c(resid_out, tx, tx, t->bitdepth);
    else if (txtype == 2)
        inv_txfm2d_tt(resid_out, tx, t->bitdepth, 2, 2);
    else
        inv_txfm2d_tt(resid_out, tx, t->bitdepth, 1, 1);
}

static void dequant_inv(const Tile *t, const int32_t *levels, int tx,
                        int32_t *resid_out) {
    dequant_inv_tt(t, levels, tx, 0, 0, resid_out);
}

/* ---- coefficient-coding context (mirrors frame.py) ---- */

/* libaom skip_contexts[min][max] for luma txbs smaller than the block
 * (mirrors frame.py _SKIP_CTX_TABLE) */
static const int SKIP_CTX_TABLE[5][5] = {
    {1, 2, 2, 2, 3},
    {1, 4, 4, 4, 5},
    {1, 4, 4, 4, 5},
    {1, 4, 4, 4, 5},
    {1, 4, 4, 4, 6},
};

static int txb_skip_ctx(const Tile *t, int plane, int px, int py, int tx,
                        int bsize) {
    if (plane == 0) {
        /* ctx 0 iff the tx covers the whole block; a 128 block's
         * TX_64X64 units take the neighbor-derived ctx (mirrors
         * frame.py _txb_skip_ctx after the sb128 fix) */
        if (tx == bsize) return 0;
        /* luma txb smaller than its block: OR-combine the 4x4 level
         * contexts over the txb extent (mirrors frame.py
         * _txb_skip_ctx_sub) */
        int mi_c0 = px / 4, mi_r0 = py / 4;
        int nn = tx / 4;
        int top = 0, left = 0;
        for (int i = 0; i < nn; i++) {
            top |= t->above_lvl[0][mi_c0 + i];
            left |= t->left_lvl[0][(mi_r0 & t->lmask) + i];
        }
        top &= 63;
        left &= 63;
        int mx = (top | left) < 4 ? (top | left) : 4;
        int mn = top < left ? top : left;
        if (mn > 4) mn = 4;
        return SKIP_CTX_TABLE[mn][mx];
    }
    int mi_c = px / 4, mi_r = py / 4;
    int n = tx / 4;
    int above_nz = 0, left_nz = 0;
    for (int i = 0; i < n; i++) {
        if (t->above_lvl[plane][mi_c + i]) above_nz = 1;
        if (t->left_lvl[plane][((mi_r & t->lmask) + i)]) left_nz = 1;
    }
    int offset = tx == bsize ? 7 : 10;
    return offset + above_nz + left_nz;
}

static int dc_sign_ctx(const Tile *t, int plane, int px, int py, int tx) {
    int mi_c = px / 4, mi_r = py / 4;
    int n = tx / 4;
    int bal = 0;
    for (int i = 0; i < n; i++) {
        int32_t c1 = t->above_dc[plane][mi_c + i];
        int32_t c2 = t->left_dc[plane][(mi_r & t->lmask) + i];
        bal += (c1 == 2) - (c1 == 1) + (c2 == 2) - (c2 == 1);
    }
    return bal < 0 ? 1 : (bal > 0 ? 2 : 0);
}

static void set_lvl_ctx(Tile *t, int plane, int px, int py, int tx, int cul,
                        int dc_cat) {
    int mi_c = px / 4, mi_r = py / 4;
    int n = tx / 4;
    for (int i = 0; i < n; i++) {
        t->above_lvl[plane][mi_c + i] = cul;
        t->left_lvl[plane][(mi_r & t->lmask) + i] = cul;
        t->above_dc[plane][mi_c + i] = dc_cat;
        t->left_dc[plane][(mi_r & t->lmask) + i] = dc_cat;
    }
}

static void encode_coeffs_txb(Tile *t, int plane, int tx, int px, int py,
                              const int32_t *levels, int bsize,
                              int y_mode_ctx) {
    static const int TXS_CTX[65] = {[4] = 0, [8] = 1, [16] = 2, [32] = 3, [64] = 4};
    int txs = TXS_CTX[tx];
    int ptype = plane == 0 ? 0 : 1;
    int cw = imin(tx, 32);
    int ctx = txb_skip_ctx(t, plane, px, py, tx, bsize);
    int sctx = dc_sign_ctx(t, plane, px, py, tx);

    /* CDF row addressing (strides from CdfBank shapes, see fast.py) */
    uint16_t *txb_skip_row = t->cdf[CDF_TXB_SKIP] + ((size_t)txs * 13 + ctx) * 3;
    int eob_idx, eob_nsym;
    switch (cw) {
        case 4: eob_idx = CDF_EOB_PT16; eob_nsym = 5; break;
        case 8: eob_idx = CDF_EOB_PT64; eob_nsym = 7; break;
        case 16: eob_idx = CDF_EOB_PT256; eob_nsym = 9; break;
        default: eob_idx = CDF_EOB_PT1024; eob_nsym = 11; break;
    }
    uint16_t *eob_pt_row =
        t->cdf[eob_idx] + (size_t)ptype * 2 * (eob_nsym + 1); /* [ptype][0] */
    uint16_t *eob_extra_rows =
        t->cdf[CDF_EOB_EXTRA] + ((size_t)txs * 2 + ptype) * 9 * 3;
    uint16_t *base_eob_rows =
        t->cdf[CDF_COEFF_BASE_EOB] + ((size_t)txs * 2 + ptype) * 4 * 4;
    uint16_t *base_rows =
        t->cdf[CDF_COEFF_BASE] + ((size_t)txs * 2 + ptype) * 42 * 5;
    /* br CDFs clamp at TX_32X32 (tx64 reuses the 32 rows — pinned by
     * decoder probes in tests/test_conformance.py) */
    uint16_t *br_rows =
        t->cdf[CDF_COEFF_BR] + ((size_t)imin(txs, 3) * 2 + ptype) * 21 * 5;
    uint16_t *dc_sign_row = t->cdf[CDF_DC_SIGN] + ((size_t)ptype * 3 + sctx) * 3;

    /* Y tx <= 16 signals intra_tx_type: 16x16 uses TX_SET_INTRA_2
     * {IDTX, DCT, ADST_ADST, ADST_DCT, DCT_ADST}, 4x4/8x8 TX_SET_INTRA_1
     * {IDTX, DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST}. The chosen
     * type arrives in y_mode_ctx bits 8+ (0 DCT, 1 ADST_ADST). */
    int y_txtype = y_mode_ctx >= 0 ? (y_mode_ctx >> 8) : 0;
    int y_mode_only = y_mode_ctx >= 0 ? (y_mode_ctx & 0xFF) : y_mode_ctx;
    uint16_t *txtype_row = NULL;
    int txtype_nsym = 0;
    int txtype_sym = 1;
    if (y_mode_ctx < 0) {
        /* lossless: WHT implicit, no tx_type symbol */
    } else if (plane == 0 && tx == 16) {
        txtype_row =
            t->cdf[CDF_INTRA_EXT_TX2] + ((size_t)txs * 13 + y_mode_only) * 6;
        txtype_nsym = 5;
        /* set2 order {IDTX, DCT, ADST_ADST, ADST_DCT, DCT_ADST} */
        txtype_sym = y_txtype == 2 ? 0 : (y_txtype ? 2 : 1);
    } else if (plane == 0 && tx <= 8) {
        txtype_row =
            t->cdf[CDF_INTRA_EXT_TX1] + ((size_t)txs * 13 + y_mode_only) * 8;
        txtype_nsym = 7;
        /* set1 order {IDTX, DCT, V_DCT, H_DCT, ADST_ADST, ...} */
        txtype_sym = y_txtype == 2 ? 0 : (y_txtype ? 4 : 1);
    }

    int32_t out_ctx[2];
    const int32_t *lv = levels;
    int32_t packed[32 * 32];
    if (tx > cw) { /* tx64: compact the coded 32x32 region */
        for (int r = 0; r < cw; r++)
            for (int c2 = 0; c2 < cw; c2++)
                packed[r * cw + c2] = levels[(size_t)r * tx + c2];
        lv = packed;
    }
    PROF_SCOPE(PROF_COEFFS);
    enc_coeffs(t->enc, lv, cw, t->scan[log2i(cw) - 2], txb_skip_row,
               eob_pt_row, eob_nsym, eob_extra_rows, base_eob_rows, base_rows,
               br_rows, dc_sign_row, txtype_row, txtype_nsym, txtype_sym,
               out_ctx);
    set_lvl_ctx(t, plane, px, py, tx, out_ctx[0], out_ctx[1]);
}

/* ---- palette (mirrors frame.py, spec 5.11.46-51) ---- */

void enc_literal(Enc *e, uint32_t v, int n);

static void write_literal_c(Tile *t, uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--)
        enc_bool(t->enc, (v >> i) & 1, 16384);
}

static int ceil_log2_c(int n) {
    if (n < 2) return 0;
    int i = 1, p = 2;
    while (p < n) { i++; p <<= 1; }
    return i;
}

static int palette_bsize_ctx(int bw, int bh) {
    return (log2i(bw) - 2) + (log2i(bh) - 2) - 2;
}

/* merged sorted neighbor cache (above only inside the same SB row) */
static int palette_cache_c(const Tile *t, int r, int c, uint16_t *cache) {
    const uint16_t *a = NULL, *l = NULL;
    int an = 0, ln = 0;
    if ((r & 15) > 0 && t->above_pal_n[c]) {
        a = t->above_pal_c + (size_t)c * 8;
        an = t->above_pal_n[c];
    }
    if (c > 0 && t->left_pal_n[r & t->lmask]) {
        l = t->left_pal_c[r & t->lmask];
        ln = t->left_pal_n[r & t->lmask];
    }
    int n = 0, i = 0, j = 0;
    while (i < an && j < ln) {
        uint16_t v;
        if (a[i] < l[j]) v = a[i++];
        else if (l[j] < a[i]) v = l[j++];
        else { v = a[i++]; j++; }
        if (n == 0 || cache[n - 1] != v) cache[n++] = v;
    }
    while (i < an) {
        uint16_t v = a[i++];
        if (n == 0 || cache[n - 1] != v) cache[n++] = v;
    }
    while (j < ln) {
        uint16_t v = l[j++];
        if (n == 0 || cache[n - 1] != v) cache[n++] = v;
    }
    return n > 16 ? 16 : n;
}

static void code_palette_colors_y_c(Tile *t, const uint16_t *pal, int npal,
                                    const uint16_t *cache, int ncache) {
    int bd = t->bitdepth;
    uint16_t reused[8];
    int n_read = 0;
    for (int i = 0; i < ncache; i++) {
        if (n_read >= npal) break;
        int use = 0;
        for (int k = 0; k < npal && !use; k++)
            if (pal[k] == cache[i]) {
                use = 1;
                for (int m2 = 0; m2 < n_read; m2++)
                    if (reused[m2] == cache[i]) use = 0;
            }
        enc_bool(t->enc, use, 16384);
        if (use) reused[n_read++] = cache[i];
    }
    uint16_t ext[8];
    int next = 0;
    for (int k = 0; k < npal; k++) {
        int re = 0;
        for (int m2 = 0; m2 < n_read; m2++)
            if (reused[m2] == pal[k]) re = 1;
        if (!re) ext[next++] = pal[k];
    }
    if (next) {
        write_literal_c(t, ext[0], bd);
        if (next > 1) {
            int min_bits = bd - 3;
            int extra = 3;
            for (extra = 0; extra < 4; extra++) {
                int bits = min_bits + extra;
                int ok = 1;
                for (int i = 1; i < next; i++) {
                    int d = ext[i] - ext[i - 1] - 1;
                    if (bits <= 0 || d >= (1 << bits)) { ok = 0; break; }
                    /* decoder shrink range is maxVal - color =
                     * (1<<bd) - 1 - color (dav1d read_pal_plane) — the
                     * off-by-one only bites when 255-color is a power
                     * of two, which no pre-round-4 test palette hit */
                    int bl = ceil_log2_c((1 << bd) - 1 - ext[i]);
                    if (bl < bits) bits = bl;
                }
                if (ok) break;
            }
            write_literal_c(t, extra, 2);
            int bits = min_bits + extra;
            for (int i = 1; i < next; i++) {
                write_literal_c(t, ext[i] - ext[i - 1] - 1, bits);
                int bl = ceil_log2_c((1 << bd) - 1 - ext[i]);
                if (bl < bits) bits = bl;
            }
        }
    }
}

/* (color_order, ctx) for one index-map position */
static int palette_color_ctx_c(const uint8_t *map, int stride, int rr,
                               int cc, int n, uint8_t *order) {
    int scores[8] = {0};
    if (cc > 0) scores[map[rr * stride + cc - 1]] += 2;
    if (rr > 0 && cc > 0) scores[map[(rr - 1) * stride + cc - 1]] += 1;
    if (rr > 0) scores[map[(rr - 1) * stride + cc]] += 2;
    for (int i = 0; i < n; i++) order[i] = (uint8_t)i;
    int lim = n < 3 ? n : 3;
    for (int i = 0; i < lim; i++) {
        int mx = scores[i], mi2 = i;
        for (int j = i + 1; j < n; j++)
            if (scores[j] > mx) { mx = scores[j]; mi2 = j; }
        if (mi2 != i) {
            uint8_t mo = order[mi2];
            for (int k = mi2; k > i; k--) {
                scores[k] = scores[k - 1];
                order[k] = order[k - 1];
            }
            scores[i] = mx;
            order[i] = mo;
        }
    }
    int hash = scores[0] + (n > 1 ? scores[1] : 0) * 2 +
               (n > 2 ? scores[2] : 0) * 2;
    static const int lookup[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
    int ctx = (hash >= 0 && hash <= 8) ? lookup[hash] : 0;
    return ctx < 0 ? 0 : ctx;
}

/* wavefront index-map coding; emit=0 returns the CDF bit cost (live
 * rows, mirrors frame.py _palette_tokens_y) */
static int64_t palette_tokens_y_c(Tile *t, const uint8_t *map, int hh,
                                  int ww, int n, int emit) {
    int64_t cost = 0;
    int nbits = ceil_log2_c(n);
    uint16_t *ci = t->cdf[CDF_PAL_Y_CI2 + (n - 2)];
    int stride_cdf = n + 1; /* nsym values incl trailing 0, + counter */
    if (emit) {
        /* av1_write_uniform: truncated binary over n values */
        int m2 = (1 << nbits) - n;
        int v = map[0];
        if (nbits > 0) {
            if (v < m2) write_literal_c(t, v, nbits - 1);
            else {
                write_literal_c(t, m2 + ((v - m2) >> 1), nbits - 1);
                write_literal_c(t, (v - m2) & 1, 1);
            }
        }
    } else {
        cost += 128 * nbits;
    }
    uint8_t order[8];
    for (int k = 1; k < hh + ww - 1; k++) {
        int j0 = k < ww - 1 ? k : ww - 1;
        int j1 = k - hh + 1 > 0 ? k - hh + 1 : 0;
        for (int j = j0; j >= j1; j--) {
            int rr = k - j;
            int ctx = palette_color_ctx_c(map, ww, rr, j, n, order);
            int sym = 0;
            while (order[sym] != map[rr * ww + j]) sym++;
            uint16_t *row = ci + (size_t)ctx * stride_cdf;
            if (emit) {
                enc_symbol_adapt(t->enc, row, n, sym);
            } else {
                int prev = sym == 0 ? 32768 : row[sym - 1];
                int p = prev - row[sym];
                if (p < 1) p = 1;
                cost += PROB_COST[((p - 1) >> 7) < 255 ? ((p - 1) >> 7)
                                                       : 255];
            }
        }
    }
    return cost;
}

/* exact-palette candidate: 2..8 distinct source values. Returns npal
 * (0 = none), fills pal + map, and rate_out (mirrors _try_palette_y) */
/* Palette candidate for one block (mirrors frame.py _try_palette_y).
 *
 * Exact when the block has 2..8 distinct luma values (distortion 0);
 * LOSSY otherwise: up to 64 distinct values are clustered to <= 8
 * palette colors by a deterministic count-weighted 1-D Lloyd iteration
 * (quantile init, 4 rounds, integer centers, ties to the lower center)
 * and the clustering SSE enters the RD duel as the palette arm's
 * distortion. This is what makes palette fire on DEPTH-CONVERTED screen
 * content: an 8-bit text-on-gradient source re-expanded to the 10-bit
 * default spreads each block past 8 exact values, while the underlying
 * content still quantizes to a handful of colors (reference behavior:
 * libaom's k-means palette search behind io.zig:629). */
static int try_palette_y_c(Tile *t, int x, int y, int size, uint16_t *pal,
                           uint8_t *map, int64_t *rate_out,
                           int64_t *dist_out, int want_rate) {
    PROF_SCOPE(PROF_PAL);
    enum { MAXD = 64 };
    static _Thread_local int32_t hist[1 << 12]; /* zero at rest */
    uint16_t touched[MAXD];
    int ntouch = 0, over = 0;
    for (int rr = 0; rr < size && !over; rr++)
        for (int cc = 0; cc < size; cc++) {
            uint16_t v =
                (uint16_t)t->src[0][(size_t)(y + rr) * t->pw + x + cc];
            if (hist[v] == 0) {
                if (ntouch >= MAXD) { over = 1; break; }
                touched[ntouch++] = v;
            }
            hist[v]++;
        }
    if (over || ntouch < 2) {
        for (int i = 0; i < ntouch; i++) hist[touched[i]] = 0;
        return 0;
    }
    /* ascending (value, count) lists; insertion sort over <= 64 */
    uint16_t vals[MAXD];
    int32_t cnt[MAXD];
    for (int i = 0; i < ntouch; i++) {
        uint16_t v = touched[i];
        int k = i;
        while (k > 0 && vals[k - 1] > v) {
            vals[k] = vals[k - 1];
            cnt[k] = cnt[k - 1];
            k--;
        }
        vals[k] = v;
        cnt[k] = hist[v];
    }
    int n = ntouch;
    int npal;
    int64_t dist = 0;
    if (n <= 8) {
        npal = n;
        for (int k = 0; k < npal; k++) pal[k] = vals[k];
    } else {
        /* weighted-quantile init over the sorted histogram */
        enum { K = 8 };
        int64_t total = 0;
        int64_t cum[MAXD];
        for (int i = 0; i < n; i++) {
            total += cnt[i];
            cum[i] = total;
        }
        int64_t centers[K];
        for (int i = 0; i < K; i++) {
            int64_t target = ((int64_t)(2 * i + 1) * total) / (2 * K);
            int j = 0;
            while (j < n - 1 && cum[j] <= target) j++;
            centers[i] = vals[j];
        }
        /* 4 Lloyd rounds; assignment ties go to the LOWER center */
        for (int it = 0; it < 4; it++) {
            int64_t sums[K] = {0};
            int64_t cnts[K] = {0};
            for (int i = 0; i < n; i++) {
                int idx = 0;
                while (idx < K - 1 &&
                       2 * (int64_t)vals[i] > centers[idx] + centers[idx + 1])
                    idx++;
                sums[idx] += (int64_t)vals[i] * cnt[i];
                cnts[idx] += cnt[i];
            }
            for (int i = 0; i < K; i++)
                if (cnts[i])
                    centers[i] = (sums[i] + cnts[i] / 2) / cnts[i];
        }
        /* sort (1-D Lloyd preserves order, but integer rounding edge
         * cases must not produce an unsorted palette — the syntax
         * requires strictly ascending colors), then dedup */
        for (int i = 1; i < K; i++) {
            int64_t v = centers[i];
            int k2 = i;
            while (k2 > 0 && centers[k2 - 1] > v) {
                centers[k2] = centers[k2 - 1];
                k2--;
            }
            centers[k2] = v;
        }
        npal = 0;
        for (int i = 0; i < K; i++)
            if (npal == 0 || (uint16_t)centers[i] != pal[npal - 1])
                pal[npal++] = (uint16_t)centers[i];
        if (npal < 2) {
            for (int i = 0; i < ntouch; i++) hist[touched[i]] = 0;
            return 0;
        }
        /* distortion of the final assignment */
        for (int i = 0; i < n; i++) {
            int idx = 0;
            while (idx < npal - 1 &&
                   2 * (int64_t)vals[i] > (int64_t)pal[idx] + pal[idx + 1])
                idx++;
            int64_t d = (int64_t)vals[i] - pal[idx];
            dist += d * d * cnt[i];
        }
    }
    /* reuse the histogram as a value -> palette-index LUT for the map */
    for (int i = 0; i < n; i++) {
        int idx = 0;
        while (idx < npal - 1 &&
               2 * (int64_t)vals[i] > (int64_t)pal[idx] + pal[idx + 1])
            idx++;
        hist[vals[i]] = idx + 1;
    }
    for (int rr = 0; rr < size; rr++)
        for (int cc = 0; cc < size; cc++) {
            uint16_t v =
                (uint16_t)t->src[0][(size_t)(y + rr) * t->pw + x + cc];
            map[rr * size + cc] = (uint8_t)(hist[v] - 1);
        }
    for (int i = 0; i < ntouch; i++) hist[touched[i]] = 0;
    if (want_rate) {
        /* the token-cost walk is the bulk of the candidate's cost;
         * replay callers need only pal/map (the duel is skipped) */
        int64_t rate = 128 * 6 + 128 * t->bitdepth +
                       (int64_t)128 * (t->bitdepth - 3) * (npal - 1);
        rate += palette_tokens_y_c(t, map, size, size, npal, 0);
        *rate_out = rate;
    } else {
        *rate_out = 0;
    }
    *dist_out = dist;
    return npal;
}

static void set_pal_ctx(Tile *t, int r, int c, int nw_mi, int nh_mi,
                        const uint16_t *pal, int npal) {
    for (int i = 0; i < nw_mi; i++) {
        t->above_pal_n[c + i] = (uint8_t)npal;
        for (int k = 0; k < npal; k++)
            t->above_pal_c[(size_t)(c + i) * 8 + k] = pal[k];
    }
    for (int i = 0; i < nh_mi && (r & t->lmask) + i < t->sbn; i++) {
        t->left_pal_n[(r & t->lmask) + i] = (uint8_t)npal;
        for (int k = 0; k < npal; k++)
            t->left_pal_c[(r & t->lmask) + i][k] = pal[k];
    }
}

/* ---- block encode (mirrors frame.py _encode_block) ---- */

static int choose_y_mode(const Tile *t, int r, int c, int size,
                         const Edges *e, int have_above, int have_left,
                         int32_t *pred_scratch) {
    PROF_SCOPE(PROF_MODE);
    int x = c * 4, y = r * 4;
    const int32_t *src = t->src[0];
    int cands[13] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED,
                     SMOOTH_V_PRED, SMOOTH_H_PRED, D45_PRED, D135_PRED,
                     D67_PRED, D113_PRED, D157_PRED, D203_PRED};
    int ncand = t->speed <= 6 ? 13
                : (t->speed <= 8 ? 9 : (t->speed <= 9 ? 7 : 5));
    int best_mode = DC_PRED;
    int64_t best_ssd = -1;
    for (int m = 0; m < ncand; m++) {
        predict(t, e, cands[m], size, size, have_above, have_left, pred_scratch);
        int64_t ssd = 0;
        for (int rr = 0; rr < size; rr++)
            for (int cc = 0; cc < size; cc++) {
                int64_t d = src[(size_t)(y + rr) * t->pw + x + cc] -
                            pred_scratch[rr * size + cc];
                ssd += d * d;
            }
        if (m >= 7) ssd += ssd >> 3; /* rate premium for directional */
        if (best_ssd < 0 || ssd < best_ssd) {
            best_ssd = ssd;
            best_mode = cands[m];
        }
    }
    return best_mode;
}

/* ---- inverse ADST (mirrors transform.py; conformance-validated) ---- */

static const int32_t COSPI_T[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897, 799, 700, 601, 501, 401, 301, 201, 101, 0,
};

static inline int64_t rnd2_t(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}
static inline int64_t hb_t(int64_t w0, int64_t x0, int64_t w1, int64_t x1) {
    return rnd2_t(w0 * x0 + w1 * x1, 12);
}

static void iadst4_c(const int64_t *x, int64_t *o) {
    static const int64_t sp[5] = {0, 1321, 2482, 3344, 3803};
    int64_t s0 = sp[1] * x[0], s1 = sp[2] * x[0], s2 = sp[3] * x[1];
    int64_t s3 = sp[4] * x[2], s4 = sp[1] * x[2], s5 = sp[2] * x[3];
    int64_t s6 = sp[4] * x[3];
    int64_t b7 = (x[0] - x[2]) + x[3];
    s0 += s3;
    s1 -= s4;
    s3 = s2;
    s2 = sp[3] * b7;
    s0 += s5;
    s1 -= s6;
    o[0] = rnd2_t(s0 + s3, 12);
    o[1] = rnd2_t(s1 + s3, 12);
    o[2] = rnd2_t(s2, 12);
    o[3] = rnd2_t(s0 + s1 - s3, 12);
}

static void iadst8_c(const int64_t *xin, int64_t *out) {
    const int32_t *c = COSPI_T;
    int64_t x[8], s[8];
    x[0]=xin[7]; x[1]=xin[0]; x[2]=xin[5]; x[3]=xin[2];
    x[4]=xin[3]; x[5]=xin[4]; x[6]=xin[1]; x[7]=xin[6];
    s[0]=hb_t(c[4],x[0],c[60],x[1]);  s[1]=hb_t(c[60],x[0],-c[4],x[1]);
    s[2]=hb_t(c[20],x[2],c[44],x[3]); s[3]=hb_t(c[44],x[2],-c[20],x[3]);
    s[4]=hb_t(c[36],x[4],c[28],x[5]); s[5]=hb_t(c[28],x[4],-c[36],x[5]);
    s[6]=hb_t(c[52],x[6],c[12],x[7]); s[7]=hb_t(c[12],x[6],-c[52],x[7]);
    x[0]=s[0]+s[4]; x[1]=s[1]+s[5]; x[2]=s[2]+s[6]; x[3]=s[3]+s[7];
    x[4]=s[0]-s[4]; x[5]=s[1]-s[5]; x[6]=s[2]-s[6]; x[7]=s[3]-s[7];
    s[0]=x[0]; s[1]=x[1]; s[2]=x[2]; s[3]=x[3];
    s[4]=hb_t(c[16],x[4],c[48],x[5]);  s[5]=hb_t(c[48],x[4],-c[16],x[5]);
    s[6]=hb_t(-c[48],x[6],c[16],x[7]); s[7]=hb_t(c[16],x[6],c[48],x[7]);
    x[0]=s[0]+s[2]; x[1]=s[1]+s[3]; x[2]=s[0]-s[2]; x[3]=s[1]-s[3];
    x[4]=s[4]+s[6]; x[5]=s[5]+s[7]; x[6]=s[4]-s[6]; x[7]=s[5]-s[7];
    s[0]=x[0]; s[1]=x[1];
    s[2]=hb_t(c[32],x[2],c[32],x[3]); s[3]=hb_t(c[32],x[2],-c[32],x[3]);
    s[4]=x[4]; s[5]=x[5];
    s[6]=hb_t(c[32],x[6],c[32],x[7]); s[7]=hb_t(c[32],x[6],-c[32],x[7]);
    out[0]=s[0]; out[1]=-s[4]; out[2]=s[6]; out[3]=-s[2];
    out[4]=s[3]; out[5]=-s[7]; out[6]=s[5]; out[7]=-s[1];
}

static void iadst16_c(const int64_t *xin, int64_t *out) {
    const int32_t *c = COSPI_T;
    int64_t x[16], s[16];
    static const int reord[16] = {15,0,13,2,11,4,9,6,7,8,5,10,3,12,1,14};
    for (int i = 0; i < 16; i++) x[i] = xin[reord[i]];
    static const int a2[8] = {2,10,18,26,34,42,50,58};
    for (int i = 0; i < 8; i++) {
        int th = a2[i];
        s[2*i]   = hb_t(c[th], x[2*i], c[64-th], x[2*i+1]);
        s[2*i+1] = hb_t(c[64-th], x[2*i], -c[th], x[2*i+1]);
    }
    for (int i = 0; i < 8; i++) { x[i] = s[i] + s[i+8]; x[i+8] = s[i] - s[i+8]; }
    for (int i = 0; i < 8; i++) s[i] = x[i];
    s[8]  = hb_t(c[8],  x[8],  c[56], x[9]);
    s[9]  = hb_t(c[56], x[8],  -c[8], x[9]);
    s[10] = hb_t(c[40], x[10], c[24], x[11]);
    s[11] = hb_t(c[24], x[10], -c[40], x[11]);
    s[12] = hb_t(-c[56], x[12], c[8],  x[13]);
    s[13] = hb_t(c[8],   x[12], c[56], x[13]);
    s[14] = hb_t(-c[24], x[14], c[40], x[15]);
    s[15] = hb_t(c[40],  x[14], c[24], x[15]);
    for (int i = 0; i < 4; i++) { x[i] = s[i] + s[i+4]; x[i+4] = s[i] - s[i+4]; }
    for (int i = 8; i < 12; i++) { x[i] = s[i] + s[i+4]; x[i+4] = s[i] - s[i+4]; }
    for (int i = 0; i < 4; i++) s[i] = x[i];
    s[4] = hb_t(c[16], x[4], c[48], x[5]);
    s[5] = hb_t(c[48], x[4], -c[16], x[5]);
    s[6] = hb_t(-c[48], x[6], c[16], x[7]);
    s[7] = hb_t(c[16], x[6], c[48], x[7]);
    for (int i = 8; i < 12; i++) s[i] = x[i];
    s[12] = hb_t(c[16], x[12], c[48], x[13]);
    s[13] = hb_t(c[48], x[12], -c[16], x[13]);
    s[14] = hb_t(-c[48], x[14], c[16], x[15]);
    s[15] = hb_t(c[16], x[14], c[48], x[15]);
    for (int g = 0; g < 16; g += 4) {
        x[g]   = s[g]   + s[g+2];
        x[g+1] = s[g+1] + s[g+3];
        x[g+2] = s[g]   - s[g+2];
        x[g+3] = s[g+1] - s[g+3];
    }
    for (int g = 0; g < 16; g += 4) {
        s[g] = x[g]; s[g+1] = x[g+1];
        s[g+2] = hb_t(c[32], x[g+2], c[32], x[g+3]);
        s[g+3] = hb_t(c[32], x[g+2], -c[32], x[g+3]);
    }
    out[0]=s[0];  out[1]=-s[8];  out[2]=s[12];  out[3]=-s[4];
    out[4]=s[6];  out[5]=-s[14]; out[6]=s[10];  out[7]=-s[2];
    out[8]=s[3];  out[9]=-s[11]; out[10]=s[15]; out[11]=-s[7];
    out[12]=s[5]; out[13]=-s[13]; out[14]=s[9]; out[15]=-s[1];
}

/* 2D inverse with per-axis kind (0=dct, 1=adst); square n<=16 for adst */
void idct_1d_pub(const int64_t *x, int64_t *out, int N);

static void apply_1d_kind(const int64_t *in, int64_t *out, int n, int kind) {
    if (kind == 0) { idct_1d_pub(in, out, n); return; }
    if (kind == 2) { /* identity (spec 7.13.3: x sqrt2 per odd log size) */
        for (int i = 0; i < n; i++) {
            if (n == 4) out[i] = rnd2_t(in[i] * 5793, 12);
            else if (n == 8) out[i] = in[i] * 2;
            else if (n == 16) out[i] = rnd2_t(in[i] * 2 * 5793, 12);
            else out[i] = in[i] * 4;
        }
        return;
    }
    if (n == 4) iadst4_c(in, out);
    else if (n == 8) iadst8_c(in, out);
    else iadst16_c(in, out);
}

/* the 1D kinds for the AV1 decoder's general 2D inverse
 * (io/av1_decode.c): 0 DCT (4-64), 1 ADST (4-16), 2 identity (4-32) */
void inv_1d_kind_pub(const int64_t *in, int64_t *out, int n, int kind) {
    apply_1d_kind(in, out, n, kind);
}

void inv_txfm2d_tt(int32_t *cf, int n, int bitdepth, int col_kind,
                   int row_kind) {
    int64_t buf[16 * 16], vec[16], ov[16];
    int row_shift = n >= 16 ? 2 : (n >= 8 ? 1 : 0);
    int64_t clamp = ((int64_t)1 << (bitdepth + 7)) - 1;
    for (int i = 0; i < n * n; i++) buf[i] = cf[i];
    for (int r = 0; r < n; r++) {
        for (int i = 0; i < n; i++) vec[i] = buf[r * n + i];
        apply_1d_kind(vec, ov, n, row_kind);
        for (int i = 0; i < n; i++) {
            int64_t v = row_shift ? rnd2_t(ov[i], row_shift) : ov[i];
            if (v < -clamp - 1) v = -clamp - 1;
            if (v > clamp) v = clamp;
            buf[r * n + i] = v;
        }
    }
    for (int ccx = 0; ccx < n; ccx++) {
        for (int i = 0; i < n; i++) vec[i] = buf[i * n + ccx];
        apply_1d_kind(vec, ov, n, col_kind);
        for (int i = 0; i < n; i++) buf[i * n + ccx] = rnd2_t(ov[i], 4);
    }
    for (int i = 0; i < n * n; i++) cf[i] = (int32_t)buf[i];
}

/* ---- lossless (CodedLossless): WHT 4x4, recon == source ---- */

static void fwd_wht4x4_c(const int32_t *resid, int32_t *lv) {
    int64_t t[16];
    for (int i = 0; i < 16; i++) t[i] = resid[i];
    for (int cidx = 0; cidx < 4; cidx++) {
        int64_t a = t[cidx], b = t[4 + cidx], c2 = t[8 + cidx], d = t[12 + cidx];
        a += b; d -= c2;
        int64_t e = (a - d) >> 1;
        b = e - b; c2 = e - c2;
        a -= c2; d += b;
        t[cidx] = a; t[4 + cidx] = c2; t[8 + cidx] = d; t[12 + cidx] = b;
    }
    for (int r = 0; r < 4; r++) {
        int64_t a = t[r * 4], b = t[r * 4 + 1], c2 = t[r * 4 + 2], d = t[r * 4 + 3];
        a += b; d -= c2;
        int64_t e = (a - d) >> 1;
        b = e - b; c2 = e - c2;
        a -= c2; d += b;
        /* x4 gain folded with the q=4 quantizer: levels = wht(resid) */
        t[r * 4] = a; t[r * 4 + 1] = c2; t[r * 4 + 2] = d; t[r * 4 + 3] = b;
    }
    for (int i = 0; i < 16; i++) lv[i] = (int32_t)t[i];
}

static void encode_coeffs_txb(Tile *t, int plane, int tx, int px, int py,
                              const int32_t *levels, int bsize, int y_mode_ctx);

static void encode_block_lossless(Tile *t, int r, int c) {
    int x = c * 4, y = r * 4;
    int lr = r & t->lmask;
    int nplanes = t->nplanes;
    int ntr0, nbl0;
    edge_counts(t, r, c, 4, &ntr0, &nbl0);
    Edges ey;
    build_edges_buf_tr(t, t->src[0], x, y, 4, 4, r > 0, c > 0, ntr0, nbl0,
                       &ey);
    int32_t pred_scratch[64 * 64];
    int y_mode = choose_y_mode(t, r, c, 4, &ey, r > 0, c > 0, pred_scratch);

    int32_t levels[3][16], preds[3][16];
    int any_nonzero = 0;
    for (int plane = 0; plane < nplanes; plane++) {
        int mode = plane == 0 ? y_mode : DC_PRED;
        Edges e;
        build_edges_buf_tr(t, t->src[plane], x, y, 4, 4, y > 0, x > 0,
                           ntr0, nbl0, &e);
        predict(t, &e, mode, 4, 4, y > 0, x > 0, preds[plane]);
        int32_t resid[16];
        for (int rr = 0; rr < 4; rr++)
            for (int cc = 0; cc < 4; cc++)
                resid[rr * 4 + cc] =
                    t->src[plane][(size_t)(y + rr) * t->pw + x + cc] -
                    preds[plane][rr * 4 + cc];
        /* Python pair: fwd returns wht*4, quant by q=4 cancels exactly —
         * here the x4 was never applied, so levels = wht directly. */
        fwd_wht4x4_c(resid, levels[plane]);
        for (int i = 0; i < 16; i++)
            if (levels[plane][i]) any_nonzero = 1;
    }
    int skip = !any_nonzero;

    int skip_ctx = t->above_skip[c] + t->left_skip[lr];
    enc_symbol_adapt(t->enc, t->cdf[CDF_SKIP] + (size_t)skip_ctx * 3, 2, skip);
    int actx = r > 0 ? INTRA_MODE_CONTEXT[t->above_mode[c]] : 0;
    int lctx = c > 0 ? INTRA_MODE_CONTEXT[t->left_mode[lr]] : 0;
    enc_symbol_adapt(t->enc, t->cdf[CDF_KF_Y] + ((size_t)actx * 5 + lctx) * 14,
                     13, y_mode);
    /* size 4: no angle_delta */
    if (nplanes > 1)
        enc_symbol_adapt(t->enc, t->cdf[CDF_UV_MODE_CFL] + (size_t)y_mode * 15,
                         14, DC_PRED);

    for (int plane = 0; plane < nplanes; plane++) {
        if (skip)
            set_lvl_ctx(t, plane, x, y, 4, 0, 0);
        else
            encode_coeffs_txb(t, plane, 4, x, y, levels[plane], 4, -1);
        for (int rr = 0; rr < 4; rr++)
            for (int cc = 0; cc < 4; cc++)
                t->recon[plane][(size_t)(y + rr) * t->pw + x + cc] =
                    t->src[plane][(size_t)(y + rr) * t->pw + x + cc];
    }
    t->above_skip[c] = skip;
    t->left_skip[lr] = skip;
    t->above_mode[c] = (uint8_t)y_mode;
    t->left_mode[lr] = (uint8_t)y_mode;
}

/* quantized residual of src-plane minus pred; zero when coeffs can't code */
static int plane_levels_c(Tile *t, int plane, int x, int y, int tx,
                          int can_code, const int32_t *pred, int32_t *lv) {
    if (!can_code) {
        memset(lv, 0, (size_t)tx * tx * 4);
        return 0;
    }
    int32_t resid[64 * 64];
    const int32_t *srcp = t->src[plane];
    int64_t sad = 0;
    for (int rr = 0; rr < tx; rr++)
        for (int cc = 0; cc < tx; cc++) {
            int32_t d = srcp[(size_t)(y + rr) * t->pw + x + cc] -
                        pred[rr * tx + cc];
            resid[rr * tx + cc] = d;
            sad += d < 0 ? -d : d;
        }
    if (sad == 0) {
        memset(lv, 0, (size_t)tx * tx * 4);
        return 0;
    }
    quantize_n(t, resid, tx, plane == 0 ? 0 : 1, lv);
    for (int i = 0; i < tx * tx; i++)
        if (lv[i]) return 1;
    return 0;
}

static int64_t rate_proxy(const int32_t *lv, int n) {
    int64_t s = 0;
    for (int i = 0; i < n; i++)
        if (lv[i]) s += 1 + llabs((int64_t)lv[i]);
    return s;
}

/* ---- luma tx-depth RD (mirrors frame.py _try_luma_depth family) ---- */

static void txb_edge_counts(int size, int tx, int ti, int tj, int ntr_blk,
                            int nbl_blk, int *ntr, int *nbl) {
    int ntxb = size / tx;
    int right_in_blk = (ntxb - 1 - tj) * tx;
    int below_in_blk = (ntxb - 1 - ti) * tx;
    int a = right_in_blk + (ti == 0 ? ntr_blk : 0);
    int b = tj == 0 ? below_in_blk + nbl_blk : 0;
    *ntr = a < tx ? a : tx;
    *nbl = b < tx ? b : tx;
}


/* predict + quantize one luma txb from the current recon; two-way ADST RD
 * for tx 8/16 (mirrors frame.py _encode_luma_txb). Returns tx_type.
 * allow_duel=0 keeps the DCT path + rate but skips the tx-type duel
 * (the two-phase tx search: split TRIALS at the default speed judge on
 * DCT, and only the winning depth re-runs with duels). */
static int encode_luma_txb_c(Tile *t, int px_, int py_, int tx, int y_mode,
                             int ntr, int nbl, int can_code, int forced_tt,
                             int allow_duel, int32_t *lv, int32_t *pred,
                             int64_t *rate_out) {
    Edges e;
    build_edges_buf_tr(t, t->recon[0], px_, py_, tx, tx, py_ > 0, px_ > 0,
                       ntr, nbl, &e);
    predict(t, &e, y_mode, tx, tx, py_ > 0, px_ > 0, pred);
    int npx = tx * tx;
    if (!can_code) {
        memset(lv, 0, (size_t)npx * 4);
        *rate_out = 256;
        return 0;
    }
    int32_t resid[64 * 64];
    for (int rr = 0; rr < tx; rr++)
        for (int cc = 0; cc < tx; cc++)
            resid[rr * tx + cc] =
                t->src[0][(size_t)(py_ + rr) * t->pw + px_ + cc] -
                pred[rr * tx + cc];
    if (forced_tt >= 0) {
        /* replayed decision: quantize under the recorded transform only,
         * no rate estimate (there is no RD comparison to feed) */
        int tt = (tx == 8 || tx == 16) ? forced_tt : 0;
        int fi2 = tt == 2 ? (tx == 8 ? 9 : 10)
                  : tt == 1 ? (tx == 8 ? 4 : 5)
                            : (tx == 4 ? 6 : log2i(tx) - 3);
        quantize_mat(t, resid, tx, 0, fi2, lv, NULL, NULL, NULL, NULL);
        *rate_out = 0;
        return tt;
    }
    int fi = tx == 4 ? 6 : log2i(tx) - 3;
    double e2;
    int64_t ord[1024];
    int eob = 0;
    int64_t rate;
    quantize_mat(t, resid, tx, 0, fi, lv, &e2, ord, &eob, &rate);
    int nnz = 0;
    for (int si = 0; si < eob; si++)
        if (ord[si]) nnz++;
    int txtype = 0;
    int nnz_gate = t->speed <= 4 ? 1 : 6;
    if ((tx == 8 || tx == 16) && nnz >= nnz_gate && t->speed <= 9 &&
        allow_duel) {
        /* three-way transform RD in the COEFFICIENT domain (one shared
         * gain per size): DCT vs ADST vs IDTX — identity is the
         * screen-content transform. No inverse for the losers. */
        int32_t lv_c[64 * 64];
        int shift = DQ_SHIFT_BY_TX[tx];
        double lam =
            (double)((((int64_t)t->dq_ac * t->dq_ac) >> (2 * shift)) *
                     RDOQ_KNUM) /
            (RDOQ_KDEN * 128.0) * t->cur_lamscale;
        double best_rd = e2 + lam * (double)rate;
        /* IDTX arms only for --tune ssim (OAVIF_IDTX, exported by
         * encode.py) on palette-class blocks (<= 8 distinct source
         * values): under the perceptual default its L2-fair wins lose
         * on the SSIMULACRA2 target curve (mirrors frame.py) */
        int n_distinct = 9;
        if (t->enable_idtx) {
            n_distinct = 0;
            uint64_t seen[16] = {0};
            for (int rr = 0; rr < tx && n_distinct <= 8; rr++)
                for (int cc = 0; cc < tx; cc++) {
                    int v = (int)t->src[0][(size_t)(py_ + rr) * t->pw +
                                           px_ + cc];
                    if (!(seen[v >> 6] >> (v & 63) & 1)) {
                        seen[v >> 6] |= (uint64_t)1 << (v & 63);
                        if (++n_distinct > 8) break;
                    }
                }
        }
        int ncand = n_distinct <= 8 ? 2 : 1;
        static const int cand_tt[2] = {1, 2}; /* adst, idtx */
        for (int k = 0; k < ncand; k++) {
            int fi_c = cand_tt[k] == 1 ? (tx == 8 ? 4 : 5)
                                       : (tx == 8 ? 9 : 10);
            double e2_c;
            int eob_c = 0;
            int64_t rate_c;
            quantize_mat(t, resid, tx, 0, fi_c, lv_c, &e2_c, ord, &eob_c,
                         &rate_c);
            double rd_c = e2_c + lam * (double)rate_c;
            if (rd_c < best_rd) {
                best_rd = rd_c;
                txtype = cand_tt[k];
                memcpy(lv, lv_c, (size_t)npx * 4);
                rate = rate_c;
            }
        }
    }
    *rate_out = rate;
    return txtype;
}

/* trial-encode the block's luma at one tx depth into t->recon[0]
 * (restored before return). Returns 0 for a rejected all-zero split. */
static int try_luma_depth_c(Tile *t, int x, int y, int size, int depth,
                            int y_mode, int ntr_blk, int nbl_blk,
                            int can_code, const int *forced_tt,
                            int allow_duel,
                            int32_t *lv_out /* txb-major */,
                            int32_t *pred_out, int *txtypes,
                            int32_t *recon_out /* (size,size) */,
                            int64_t *dist_out, int64_t *rate_out) {
    PROF_SCOPE(PROF_LUMA_TRIAL);
    int btx = size < 64 ? size : 64;
    int tx = btx >> depth;
    int n = size / tx;
    int hi = (1 << t->bitdepth) - 1;
    static _Thread_local int32_t saved[64 * 64];
    int32_t *rec = t->recon[0];
    for (int rr = 0; rr < size; rr++)
        memcpy(saved + (size_t)rr * size, rec + (size_t)(y + rr) * t->pw + x,
               (size_t)size * 4);
    int64_t rate = 0;
    int any_nz = 0;
    int idx = 0;
    for (int ti = 0; ti < n; ti++)
        for (int tj = 0; tj < n; tj++, idx++) {
            int px_ = x + tj * tx, py_ = y + ti * tx;
            int ntr, nbl;
            if (depth == 0) {
                ntr = ntr_blk;
                nbl = nbl_blk;
            } else {
                txb_edge_counts(size, tx, ti, tj, ntr_blk, nbl_blk, &ntr,
                                &nbl);
            }
            int32_t *lv = lv_out + (size_t)idx * tx * tx;
            int32_t *pred = pred_out + (size_t)idx * tx * tx;
            int64_t r_txb;
            txtypes[idx] =
                encode_luma_txb_c(t, px_, py_, tx, y_mode, ntr, nbl,
                                  can_code, forced_tt ? forced_tt[idx] : -1,
                                  allow_duel, lv, pred, &r_txb);
            int lnz = 0;
            for (int i = 0; i < tx * tx; i++)
                if (lv[i]) { lnz = 1; break; }
            int32_t residb[64 * 64];
            if (lnz) {
                any_nz = 1;
                dequant_inv_tt(t, lv, tx, txtypes[idx], 0, residb);
            }
            for (int rr = 0; rr < tx; rr++)
                for (int cc = 0; cc < tx; cc++) {
                    int32_t v = pred[rr * tx + cc] +
                                (lnz ? residb[rr * tx + cc] : 0);
                    rec[(size_t)(py_ + rr) * t->pw + px_ + cc] =
                        v < 0 ? 0 : (v > hi ? hi : v);
                }
            rate += r_txb;
            if (tx <= 16) rate += 256; /* tx_type symbol, ~2 bits */
        }
    if (depth > 0 && !any_nz) {
        for (int rr = 0; rr < size; rr++)
            memcpy(rec + (size_t)(y + rr) * t->pw + x,
                   saved + (size_t)rr * size, (size_t)size * 4);
        return 0;
    }
    int64_t dist = 0;
    for (int rr = 0; rr < size; rr++)
        for (int cc = 0; cc < size; cc++) {
            int64_t d = t->src[0][(size_t)(y + rr) * t->pw + x + cc] -
                        rec[(size_t)(y + rr) * t->pw + x + cc];
            dist += d * d;
            recon_out[(size_t)rr * size + cc] =
                rec[(size_t)(y + rr) * t->pw + x + cc];
        }
    for (int rr = 0; rr < size; rr++)
        memcpy(rec + (size_t)(y + rr) * t->pw + x, saved + (size_t)rr * size,
               (size_t)size * 4);
    *dist_out = dist;
    *rate_out = rate;
    return 1;
}

/* ---- rect blocks (mirror frame.py _encode_block_rect + the duel) ---- */

int enc_coeffs_rect(Enc *e, const int32_t *lv, int cw, int ch,
                    const int32_t *scan, uint16_t *txb_skip_row,
                    uint16_t *eob_pt_row, int eob_pt_nsym,
                    uint16_t *eob_extra_rows, uint16_t *base_eob_rows,
                    uint16_t *base_rows, uint16_t *br_rows,
                    uint16_t *dc_sign_row, int32_t *out_ctx);

static int rect_txs_ctx(int tw, int th) {
    int lo = log2i(tw < th ? tw : th) - 2, hi = log2i(tw > th ? tw : th) - 2;
    return (lo + hi + 1) >> 1;
}

static void set_lvl_ctx_rect(Tile *t, int plane, int px, int py, int tw,
                             int th, int cul, int dc_cat) {
    int mi_c = px / 4, mi_r = py / 4;
    for (int i = 0; i < tw / 4; i++) {
        t->above_lvl[plane][mi_c + i] = cul;
        t->above_dc[plane][mi_c + i] = dc_cat;
    }
    for (int i = 0; i < th / 4; i++) {
        t->left_lvl[plane][(mi_r & t->lmask) + i] = cul;
        t->left_dc[plane][(mi_r & t->lmask) + i] = dc_cat;
    }
}

static int dc_sign_ctx_rect(const Tile *t, int plane, int px, int py,
                            int tw, int th) {
    int mi_c = px / 4, mi_r = py / 4;
    int bal = 0;
    for (int i = 0; i < tw / 4; i++) {
        int32_t c1 = t->above_dc[plane][mi_c + i];
        bal += (c1 == 2) - (c1 == 1);
    }
    for (int i = 0; i < th / 4; i++) {
        int32_t c2 = t->left_dc[plane][(mi_r & t->lmask) + i];
        bal += (c2 == 2) - (c2 == 1);
    }
    return bal < 0 ? 1 : (bal > 0 ? 2 : 0);
}

static void encode_coeffs_rect_c(Tile *t, int plane, int tw, int th, int px,
                                 int py, const int32_t *levels) {
    int txs = rect_txs_ctx(tw, th);
    int ptype = plane == 0 ? 0 : 1;
    int n_coded = tw * th;
    int ctx;
    if (plane == 0) {
        ctx = 0; /* tx == block */
    } else {
        int mi_c = px / 4, mi_r = py / 4;
        int above_nz = 0, left_nz = 0;
        for (int i = 0; i < tw / 4; i++)
            if (t->above_lvl[plane][mi_c + i]) above_nz = 1;
        for (int i = 0; i < th / 4; i++)
            if (t->left_lvl[plane][(mi_r & t->lmask) + i]) left_nz = 1;
        ctx = 7 + above_nz + left_nz; /* tx dims == block dims */
    }
    int sctx = dc_sign_ctx_rect(t, plane, px, py, tw, th);
    uint16_t *txb_skip_row = t->cdf[CDF_TXB_SKIP] + ((size_t)txs * 13 + ctx) * 3;
    int eob_idx = n_coded == 128 ? CDF_EOB_PT128 : CDF_EOB_PT512;
    int eob_nsym = n_coded == 128 ? 8 : 10;
    uint16_t *eob_pt_row =
        t->cdf[eob_idx] + (size_t)ptype * 2 * (eob_nsym + 1);
    uint16_t *eob_extra_rows =
        t->cdf[CDF_EOB_EXTRA] + ((size_t)txs * 2 + ptype) * 9 * 3;
    uint16_t *base_eob_rows =
        t->cdf[CDF_COEFF_BASE_EOB] + ((size_t)txs * 2 + ptype) * 4 * 4;
    uint16_t *base_rows =
        t->cdf[CDF_COEFF_BASE] + ((size_t)txs * 2 + ptype) * 42 * 5;
    uint16_t *br_rows =
        t->cdf[CDF_COEFF_BR] + ((size_t)imin(txs, 3) * 2 + ptype) * 21 * 5;
    uint16_t *dc_sign_row = t->cdf[CDF_DC_SIGN] + ((size_t)ptype * 3 + sctx) * 3;
    int32_t out_ctx[2];
    PROF_SCOPE(PROF_COEFFS);
    enc_coeffs_rect(t->enc, levels, tw, th, t->scan[tw > th ? 4 : 5],
                    txb_skip_row, eob_pt_row, eob_nsym, eob_extra_rows,
                    base_eob_rows, base_rows, br_rows, dc_sign_row, out_ctx);
    set_lvl_ctx_rect(t, plane, px, py, tw, th, out_ctx[0], out_ctx[1]);
}

/* mode by pred SSD over the non-directional candidate ladder + RDOQ
 * levels (mirrors frame.py _rect_mode_and_levels: shared by the duel
 * trial and the final rect encode) */
static int rect_mode_and_levels_c(Tile *t, int x, int y, int bw, int bh,
                                  int32_t *pred_out, int32_t *lv_out,
                                  int64_t *rate_out /* nullable: fused
                                  exact rate (== rate_estimate_rect) */) {
    int ha = y > 0, hl = x > 0;
    Edges e;
    build_edges_buf(t, t->recon[0], x, y, bw, bh, ha, hl, &e);
    int cands[7] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED,
                    SMOOTH_V_PRED, SMOOTH_H_PRED};
    int ncand = t->speed <= 9 ? 7 : 5;
    int best_mode = DC_PRED;
    int64_t best_ssd = -1;
    int32_t pred[32 * 32];
    for (int m = 0; m < ncand; m++) {
        predict(t, &e, cands[m], bw, bh, ha, hl, pred);
        int64_t ssd = 0;
        for (int rr = 0; rr < bh; rr++)
            for (int cc = 0; cc < bw; cc++) {
                int64_t d = t->src[0][(size_t)(y + rr) * t->pw + x + cc] -
                            pred[rr * bw + cc];
                ssd += d * d;
            }
        if (best_ssd < 0 || ssd < best_ssd) {
            best_ssd = ssd;
            best_mode = cands[m];
            memcpy(pred_out, pred, (size_t)bw * bh * 4);
        }
    }
    int32_t resid[32 * 32];
    for (int rr = 0; rr < bh; rr++)
        for (int cc = 0; cc < bw; cc++)
            resid[rr * bw + cc] =
                t->src[0][(size_t)(y + rr) * t->pw + x + cc] -
                pred_out[rr * bw + cc];
    int all0 = 1;
    for (int i = 0; i < bw * bh; i++)
        if (resid[i]) { all0 = 0; break; }
    if (all0) {
        memset(lv_out, 0, (size_t)bw * bh * 4);
        if (rate_out) *rate_out = 256; /* eob 0: txb_skip only */
    } else {
        quantize_rect(t, resid, bw, bh, 0, lv_out, NULL, NULL, NULL,
                      rate_out);
    }
    return best_mode;
}

/* real-RD luma trial of a 32-node rect arm (mirrors frame.py
 * _try_rect_luma): both sub-blocks sequentially, recon restored */
static void try_rect_luma_c(Tile *t, int x, int y, int part,
                            int64_t *dist_out, int64_t *rate_out) {
    PROF_SCOPE(PROF_RECT);
    int bw = part == 1 ? 32 : 16, bh = part == 1 ? 16 : 32;
    int hi = (1 << t->bitdepth) - 1;
    int32_t saved[32 * 32];
    int32_t *rec = t->recon[0];
    for (int rr = 0; rr < 32; rr++)
        memcpy(saved + (size_t)rr * 32, rec + (size_t)(y + rr) * t->pw + x,
               32 * 4);
    int64_t rate = 0;
    for (int k = 0; k < 2; k++) {
        int sx = x + (part == 2 ? 16 * k : 0);
        int sy = y + (part == 1 ? 16 * k : 0);
        int32_t pred[32 * 32], lv[32 * 32];
        int64_t rate_k;
        rect_mode_and_levels_c(t, sx, sy, bw, bh, pred, lv, &rate_k);
        int lnz = 0;
        for (int i = 0; i < bw * bh; i++)
            if (lv[i]) { lnz = 1; break; }
        int32_t residb[32 * 32];
        if (lnz) dequant_inv_rect(t, lv, bw, bh, 0, residb);
        for (int rr = 0; rr < bh; rr++)
            for (int cc = 0; cc < bw; cc++) {
                int32_t v = pred[rr * bw + cc] +
                            (lnz ? residb[rr * bw + cc] : 0);
                rec[(size_t)(sy + rr) * t->pw + sx + cc] =
                    v < 0 ? 0 : (v > hi ? hi : v);
            }
        rate += rate_k;
    }
    int64_t dist = 0;
    for (int rr = 0; rr < 32; rr++)
        for (int cc = 0; cc < 32; cc++) {
            int64_t d = t->src[0][(size_t)(y + rr) * t->pw + x + cc] -
                        rec[(size_t)(y + rr) * t->pw + x + cc];
            dist += d * d;
        }
    for (int rr = 0; rr < 32; rr++)
        memcpy(rec + (size_t)(y + rr) * t->pw + x, saved + (size_t)rr * 32,
               32 * 4);
    *dist_out = dist;
    *rate_out = rate;
}

/* real-RD luma trial of the NONE/SPLIT arm (mirrors frame.py
 * _try_square_arm): depth-0 tx, per-block pred-SSD modes, recon restored */
static void try_square_arm_c(Tile *t, int r, int c, int part,
                             int64_t *dist_out, int64_t *rate_out) {
    PROF_SCOPE(PROF_RECT);
    int x = c * 4, y = r * 4;
    int32_t saved[32 * 32];
    int32_t *rec = t->recon[0];
    for (int rr = 0; rr < 32; rr++)
        memcpy(saved + (size_t)rr * 32, rec + (size_t)(y + rr) * t->pw + x,
               32 * 4);
    int64_t dist = 0, rate = 0;
    int nsub = part == 0 ? 1 : 4;
    for (int k = 0; k < nsub; k++) {
        int br = part == 0 ? r : r + (k / 2) * 4;
        int bc = part == 0 ? c : c + (k % 2) * 4;
        int bs = part == 0 ? 32 : 16;
        int bx = bc * 4, by = br * 4;
        int ha = by > 0, hl = bx > 0;
        int ntr, nbl;
        edge_counts(t, br, bc, bs, &ntr, &nbl);
        Edges e;
        build_edges_buf_tr(t, t->recon[0], bx, by, bs, bs, ha, hl, ntr, nbl,
                           &e);
        int32_t scratch[32 * 32];
        int y_mode = choose_y_mode(t, br, bc, bs, &e, ha, hl, scratch);
        static _Thread_local int32_t lv_t[32 * 32], pr_t[32 * 32],
            rec_t[32 * 32];
        int tts[4];
        int64_t d_, r_;
        try_luma_depth_c(t, bx, by, bs, 0, y_mode, ntr, nbl, 1, NULL, 1,
                         lv_t, pr_t, tts, rec_t, &d_, &r_);
        for (int rr = 0; rr < bs; rr++)
            memcpy(rec + (size_t)(by + rr) * t->pw + bx,
                   rec_t + (size_t)rr * bs, (size_t)bs * 4);
        dist += d_;
        rate += r_;
    }
    for (int rr = 0; rr < 32; rr++)
        memcpy(rec + (size_t)(y + rr) * t->pw + x, saved + (size_t)rr * 32,
               32 * 4);
    *dist_out = dist;
    *rate_out = rate;
}

/* Host partition picks (128/64/32 nodes incl. the rect duel) recorded
 * into the decision stream so replay probes skip the SSD proxies and the
 * real-RD duels entirely (the duel was ~20 ms of every replayed encode).
 * Same 10-int row stride as block rows; pseudo size byte 2 in the tag is
 * disjoint from every real block tag (16/17/18/32/64/128). Mirrors
 * frame.py _dec_part_replay/_dec_part_record. */
static int dec_part_replay(Tile *t, int r, int c, int size) {
    if (t->dec_mode != 2) return -2; /* -2: caller must compute */
    int tag = (r << 16) | (c << 8) | 2;
    if (t->dec_pos + 10 <= t->dec_cap && t->dec_buf[t->dec_pos] == tag &&
        t->dec_buf[t->dec_pos + 1] == size) {
        int part = t->dec_buf[t->dec_pos + 2];
        t->dec_pos += 10;
        return part;
    }
    t->dec_mode = 0; /* sequence diverged: disarm for the tile */
    return -2;
}

static void dec_part_record(Tile *t, int r, int c, int size, int part) {
    if (t->dec_mode == 1 && t->dec_buf && t->dec_pos + 10 <= t->dec_cap) {
        int32_t *dd = t->dec_buf + t->dec_pos;
        t->dec_pos += 10;
        memset(dd, 0, 10 * sizeof(int32_t));
        dd[0] = (r << 16) | (c << 8) | 2;
        dd[1] = size;
        dd[2] = part;
    }
}

static const uint8_t PART_CTX_BYTE_FWD[65] = {
    [4] = 31, [8] = 30, [16] = 28, [32] = 24, [64] = 16};

static void update_part_ctx_rect(Tile *t, int r, int c, int size, int sub_w,
                                 int sub_h) {
    int n_mi = size / 4;
    for (int i = 0; i < n_mi; i++) {
        t->above_part[c + i] = PART_CTX_BYTE_FWD[sub_w];
        t->left_part[(r & t->lmask) + i] = PART_CTX_BYTE_FWD[sub_h];
    }
}

/* one rect block (mirrors frame.py _encode_block_rect) */
static void encode_block_rect_c(Tile *t, int r, int c, int bw, int bh) {
    PROF_SCOPE(PROF_RECT_BLK);
    int x = c * 4, y = r * 4;
    int lr = r & t->lmask;
    int hi = (1 << t->bitdepth) - 1;
    int npx = bw * bh;
    int nplanes = t->nplanes;

    int block_idx = -1;
    if (t->blocks_out) {
        block_idx = t->n_blocks++;
        t->blocks_out[block_idx * 5 + 0] = r;
        t->blocks_out[block_idx * 5 + 1] = c;
        t->blocks_out[block_idx * 5 + 2] = bw | (bh << 16);
        t->blocks_out[block_idx * 5 + 3] = 0;
        t->blocks_out[block_idx * 5 + 4] = bw | (bh << 16);
    }

    /* per-block lambda scale (mirrors frame.py) */
    if (t->mean_var > 0.0) {
        int64_t s1 = 0, s2 = 0;
        for (int rr = 0; rr < bh; rr++)
            for (int cc = 0; cc < bw; cc++) {
                int64_t v = t->src[0][(size_t)(y + rr) * t->pw + x + cc];
                s1 += v;
                s2 += v * v;
            }
        int64_t n_ = (int64_t)npx;
        double var_b = (double)(n_ * s2 - s1 * s1) / (double)(n_ * n_);
        double sc = sqrt((var_b + 16.0) / (t->mean_var + 16.0));
        if (sc < 0.25) sc = 0.25;
        if (sc > 4.0) sc = 4.0;
        t->cur_lamscale = sc;
    } else {
        t->cur_lamscale = 1.0;
    }

    /* replay rows under rect-coded tags (bh|1 HORZ, bw|2 VERT) */
    int tagsz = bw > bh ? (bh | 1) : (bw | 2);
    int32_t dec_tag = (int32_t)((r << 16) | (c << 8) | tagsz);
    int rep_on = 0, rep_uv = -1, rep_au = 0, rep_av = 0, rep_mode = 0;
    if (t->dec_mode == 2) {
        if (t->dec_pos + 10 <= t->dec_cap &&
            t->dec_buf[t->dec_pos] == dec_tag) {
            const int32_t *dd = t->dec_buf + t->dec_pos;
            t->dec_pos += 10;
            rep_on = 1;
            rep_uv = dd[6]; rep_au = dd[7]; rep_av = dd[8];
            rep_mode = dd[9];
        } else {
            t->dec_mode = 0;
        }
    }

    /* --- luma --- */
    static _Thread_local int32_t y_pred[32 * 32], y_levels[32 * 32];
    static _Thread_local int32_t y_recon[32 * 32];
    int y_mode;
    if (rep_on) {
        y_mode = rep_mode;
        Edges e;
        build_edges_buf(t, t->recon[0], x, y, bw, bh, y > 0, x > 0, &e);
        predict(t, &e, y_mode, bw, bh, y > 0, x > 0, y_pred);
        int32_t resid[32 * 32];
        int all0 = 1;
        for (int rr = 0; rr < bh; rr++)
            for (int cc = 0; cc < bw; cc++) {
                resid[rr * bw + cc] =
                    t->src[0][(size_t)(y + rr) * t->pw + x + cc] -
                    y_pred[rr * bw + cc];
                if (resid[rr * bw + cc]) all0 = 0;
            }
        if (all0)
            memset(y_levels, 0, (size_t)npx * 4);
        else
            quantize_rect(t, resid, bw, bh, 0, y_levels, NULL, NULL, NULL,
                          NULL);
    } else {
        y_mode = rect_mode_and_levels_c(t, x, y, bw, bh, y_pred, y_levels,
                                        NULL);
    }
    int y_nz = 0;
    for (int i = 0; i < npx; i++)
        if (y_levels[i]) { y_nz = 1; break; }
    if (y_nz) {
        int32_t residb[32 * 32];
        dequant_inv_rect(t, y_levels, bw, bh, 0, residb);
        for (int i = 0; i < npx; i++) {
            int32_t v = y_pred[i] + residb[i];
            y_recon[i] = v < 0 ? 0 : (v > hi ? hi : v);
        }
    } else {
        for (int i = 0; i < npx; i++) {
            int32_t v = y_pred[i];
            y_recon[i] = v < 0 ? 0 : (v > hi ? hi : v);
        }
    }

    /* --- chroma: DC vs CfL with the rect lumaAC average (mirrors the
     * aligned frame.py algorithm: closed-form LS alpha + refinement,
     * rate-proxy decision) --- */
    int uv_mode = DC_PRED;
    int alpha_u = 0, alpha_v = 0;
    static _Thread_local int32_t uv_pred[2][32 * 32], uv_lv[2][32 * 32];
    int any_uv_nz = 0;
    if (nplanes > 1) {
        int32_t dc_pred[2][32 * 32];
        for (int i = 0; i < 2; i++) {
            Edges e;
            build_edges_buf(t, t->recon[1 + i], x, y, bw, bh, y > 0, x > 0,
                            &e);
            predict(t, &e, DC_PRED, bw, bh, y > 0, x > 0, dc_pred[i]);
        }
        int64_t sum = 0;
        int lg = log2i(bw) + log2i(bh);
        static _Thread_local int64_t diff[32 * 32];
        for (int i = 0; i < npx; i++) sum += (int64_t)y_recon[i] << 3;
        int64_t avg = (sum + ((int64_t)1 << (lg - 1))) >> lg;
        for (int i = 0; i < npx; i++)
            diff[i] = ((int64_t)y_recon[i] << 3) - avg;

        int done = 0;
        if (rep_on) {
            uv_mode = rep_uv == UV_CFL_PRED ? UV_CFL_PRED : DC_PRED;
            if (uv_mode == UV_CFL_PRED) { alpha_u = rep_au; alpha_v = rep_av; }
            int aa[2] = {alpha_u, alpha_v};
            for (int i = 0; i < 2; i++) {
                if (uv_mode == UV_CFL_PRED) {
                    for (int k = 0; k < npx; k++) {
                        int64_t prod = (int64_t)aa[i] * diff[k];
                        int64_t contrib = prod < 0 ? -((-prod + 32) >> 6)
                                                   : ((prod + 32) >> 6);
                        int64_t p = dc_pred[i][k] + contrib;
                        if (p < 0) p = 0;
                        if (p > hi) p = hi;
                        uv_pred[i][k] = (int32_t)p;
                    }
                } else {
                    memcpy(uv_pred[i], dc_pred[i], (size_t)npx * 4);
                }
            }
            done = 1;
        } else {
            int64_t var = 0;
            for (int i = 0; i < npx; i++) var += diff[i] * diff[i];
            int best_a[2] = {0, 0};
            static _Thread_local int32_t cfl_pred[2][32 * 32];
            for (int i = 0; i < 2; i++) {
                const int32_t *srcp = t->src[1 + i];
                int64_t cov = 0;
                for (int rr = 0; rr < bh; rr++)
                    for (int cc = 0; cc < bw; cc++)
                        cov += diff[rr * bw + cc] *
                               (int64_t)(srcp[(size_t)(y + rr) * t->pw + x + cc] -
                                         dc_pred[i][rr * bw + cc]);
                int64_t a_est;
                if (var == 0 || cov == 0) a_est = 0;
                else {
                    a_est = (64 * llabs(cov) + var / 2) / var;
                    if (a_est > 16) a_est = 16;
                    if (cov < 0) a_est = -a_est;
                }
                if (a_est == 0) {
                    best_a[i] = 0;
                    memcpy(cfl_pred[i], dc_pred[i], (size_t)npx * 4);
                    continue;
                }
                int64_t best_ssd = -1;
                int64_t order[33];
                int ncand_a;
                if (t->speed <= 6) {
                    ncand_a = 0;
                    for (int a2 = -16; a2 <= 16; a2++)
                        if (a2) order[ncand_a++] = a2;
                } else {
                    order[0] = a_est; order[1] = a_est - 1;
                    order[2] = a_est + 1;
                    ncand_a = 3;
                }
                for (int k = 0; k < ncand_a; k++) {
                    int64_t a = order[k];
                    if (a < -16 || a > 16) continue;
                    int64_t ssd = 0;
                    int32_t cand[32 * 32];
                    for (int rr = 0; rr < bh; rr++)
                        for (int cc = 0; cc < bw; cc++) {
                            int64_t prod = a * diff[rr * bw + cc];
                            int64_t contrib =
                                prod < 0 ? -((-prod + 32) >> 6)
                                         : ((prod + 32) >> 6);
                            int64_t p = dc_pred[i][rr * bw + cc] + contrib;
                            if (p < 0) p = 0;
                            if (p > hi) p = hi;
                            cand[rr * bw + cc] = (int32_t)p;
                            int64_t dd =
                                srcp[(size_t)(y + rr) * t->pw + x + cc] - p;
                            ssd += dd * dd;
                        }
                    if (best_ssd < 0 || ssd < best_ssd) {
                        best_ssd = ssd;
                        best_a[i] = (int)a;
                        memcpy(cfl_pred[i], cand, (size_t)npx * 4);
                    }
                }
            }
            static _Thread_local int32_t lv_dc[2][32 * 32],
                lv_cfl[2][32 * 32];
            for (int i = 0; i < 2; i++) {
                int32_t resid[32 * 32];
                int all0 = 1;
                for (int rr = 0; rr < bh; rr++)
                    for (int cc = 0; cc < bw; cc++) {
                        resid[rr * bw + cc] =
                            t->src[1 + i][(size_t)(y + rr) * t->pw + x + cc] -
                            dc_pred[i][rr * bw + cc];
                        if (resid[rr * bw + cc]) all0 = 0;
                    }
                if (all0) memset(lv_dc[i], 0, (size_t)npx * 4);
                else quantize_rect(t, resid, bw, bh, 1, lv_dc[i], NULL,
                                   NULL, NULL, NULL);
            }
            if (best_a[0] == 0 && best_a[1] == 0) {
                for (int i = 0; i < 2; i++) {
                    memcpy(uv_pred[i], dc_pred[i], (size_t)npx * 4);
                    memcpy(uv_lv[i], lv_dc[i], (size_t)npx * 4);
                }
                done = 2; /* DC levels already in uv_lv */
            } else {
                for (int i = 0; i < 2; i++) {
                    int32_t resid[32 * 32];
                    int all0 = 1;
                    for (int rr = 0; rr < bh; rr++)
                        for (int cc = 0; cc < bw; cc++) {
                            resid[rr * bw + cc] =
                                t->src[1 + i][(size_t)(y + rr) * t->pw + x +
                                              cc] -
                                cfl_pred[i][rr * bw + cc];
                            if (resid[rr * bw + cc]) all0 = 0;
                        }
                    if (all0) memset(lv_cfl[i], 0, (size_t)npx * 4);
                    else quantize_rect(t, resid, bw, bh, 1, lv_cfl[i], NULL,
                                       NULL, NULL, NULL);
                }
                int64_t cost_dc = 0, cost_cfl = 4;
                for (int i = 0; i < 2; i++) {
                    cost_dc += rate_proxy(lv_dc[i], npx);
                    cost_cfl += rate_proxy(lv_cfl[i], npx);
                }
                if (cost_cfl < cost_dc) {
                    uv_mode = UV_CFL_PRED;
                    alpha_u = best_a[0];
                    alpha_v = best_a[1];
                    for (int i = 0; i < 2; i++) {
                        memcpy(uv_pred[i], cfl_pred[i], (size_t)npx * 4);
                        memcpy(uv_lv[i], lv_cfl[i], (size_t)npx * 4);
                    }
                } else {
                    for (int i = 0; i < 2; i++) {
                        memcpy(uv_pred[i], dc_pred[i], (size_t)npx * 4);
                        memcpy(uv_lv[i], lv_dc[i], (size_t)npx * 4);
                    }
                }
                done = 2;
            }
        }
        if (done == 1) {
            /* replay: quantize under the replayed prediction */
            for (int i = 0; i < 2; i++) {
                int32_t resid[32 * 32];
                int all0 = 1;
                for (int rr = 0; rr < bh; rr++)
                    for (int cc = 0; cc < bw; cc++) {
                        resid[rr * bw + cc] =
                            t->src[1 + i][(size_t)(y + rr) * t->pw + x + cc] -
                            uv_pred[i][rr * bw + cc];
                        if (resid[rr * bw + cc]) all0 = 0;
                    }
                if (all0) memset(uv_lv[i], 0, (size_t)npx * 4);
                else quantize_rect(t, resid, bw, bh, 1, uv_lv[i], NULL,
                                   NULL, NULL, NULL);
            }
        }
        for (int i = 0; i < 2; i++)
            for (int k = 0; k < npx; k++)
                if (uv_lv[i][k]) { any_uv_nz = 1; break; }
    }

    int skip = !y_nz && !any_uv_nz;
    if (t->dec_mode == 1 && t->dec_buf && t->dec_pos + 10 <= t->dec_cap) {
        int32_t *dd = t->dec_buf + t->dec_pos;
        t->dec_pos += 10;
        dd[0] = dec_tag;
        dd[1] = 0; dd[2] = 0; dd[3] = 0; dd[4] = 0; dd[5] = 0;
        dd[6] = uv_mode; dd[7] = alpha_u; dd[8] = alpha_v;
        dd[9] = y_mode;
    }
    if (block_idx >= 0) t->blocks_out[block_idx * 5 + 3] = skip;

    int nw = bw / 4, nh = bh / 4;

    /* --- symbols --- */
    int skip_ctx = t->above_skip[c] + t->left_skip[lr];
    enc_symbol_adapt(t->enc, t->cdf[CDF_SKIP] + (size_t)skip_ctx * 3, 2, skip);
    int actx = r > 0 ? INTRA_MODE_CONTEXT[t->above_mode[c]] : 0;
    int lctx = c > 0 ? INTRA_MODE_CONTEXT[t->left_mode[lr]] : 0;
    enc_symbol_adapt(t->enc,
                     t->cdf[CDF_KF_Y] + ((size_t)actx * 5 + lctx) * 14, 13,
                     y_mode);
    if (MODE_ANGLE[y_mode] && (bw < bh ? bw : bh) >= 8)
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_ANGLE_DELTA] + (size_t)(y_mode - 1) * 8, 7,
                         3);
    if (nplanes > 1) {
        /* cfl_allowed: max(bw,bh) <= 32 always true for these sizes */
        enc_symbol_adapt(t->enc, t->cdf[CDF_UV_MODE_CFL] + (size_t)y_mode * 15,
                         14, uv_mode);
        if (uv_mode == UV_CFL_PRED) {
            int sign_u = alpha_u == 0 ? 0 : (alpha_u < 0 ? 1 : 2);
            int sign_v = alpha_v == 0 ? 0 : (alpha_v < 0 ? 1 : 2);
            int joint = sign_u * 3 + sign_v - 1;
            enc_symbol_adapt(t->enc, t->cdf[CDF_CFL_SIGN], 8, joint);
            if (sign_u)
                enc_symbol_adapt(
                    t->enc, t->cdf[CDF_CFL_ALPHA] + (size_t)(joint - 2) * 17,
                    16, abs(alpha_u) - 1);
            if (sign_v)
                enc_symbol_adapt(
                    t->enc,
                    t->cdf[CDF_CFL_ALPHA] +
                        (size_t)(sign_v * 3 + sign_u - 3) * 17,
                    16, abs(alpha_v) - 1);
        } else if (MODE_ANGLE[uv_mode] && (bw < bh ? bw : bh) >= 8) {
            enc_symbol_adapt(t->enc,
                             t->cdf[CDF_ANGLE_DELTA] + (size_t)(uv_mode - 1) * 8,
                             7, 3);
        }
    }
    /* palette_mode_info on screen-content frames: rect blocks are
     * eligible sizes; we always decline (mirrors frame.py) */
    if (t->screen_tools) {
        int bctx = palette_bsize_ctx(bw, bh);
        if (y_mode == DC_PRED) {
            int pctx = ((r > 0 && t->above_pal_n[c]) ? 1 : 0) +
                       ((c > 0 && t->left_pal_n[lr]) ? 1 : 0);
            enc_symbol_adapt(
                t->enc, t->cdf[CDF_PAL_Y_MODE] + ((size_t)bctx * 3 + pctx) * 3,
                2, 0);
        }
        if (nplanes > 1 && uv_mode == DC_PRED)
            enc_symbol_adapt(t->enc, t->cdf[CDF_PAL_UV_MODE], 2, 0);
    }
    /* filter_intra_mode_info: rect DC blocks <= 32 are eligible and must
     * code the use flag; the rect path always declines (mirrors
     * frame.py; rows 7/8 = BLOCK_16X32/BLOCK_32X16) */
    if (t->filter_intra && y_mode == DC_PRED && bw <= 32 && bh <= 32) {
        int fi_row = bw == 16 ? 7 : 8;
        enc_symbol_adapt(t->enc, t->cdf[CDF_FI_USE] + (size_t)fi_row * 3, 2,
                         0);
    }
    /* tx_depth 0 of the rect max tx (cat = sqr_up category) */
    {
        int mx = bw > bh ? bw : bh;
        int cat = mx == 8 ? 0 : mx == 16 ? 1 : mx == 32 ? 2 : 3;
        int above = r > 0 ? t->above_txw[c] : 0;
        int left = c > 0 ? t->left_txh[lr] : 0;
        int tctx = (above >= bw ? 1 : 0) + (left >= bh ? 1 : 0);
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_TX_SIZE] + ((size_t)cat * 3 + tctx) * 4,
                         cat == 0 ? 2 : 3, 0);
    }

    /* --- residual coding + recon --- */
    for (int plane = 0; plane < nplanes; plane++) {
        const int32_t *lv = plane == 0 ? y_levels : uv_lv[plane - 1];
        const int32_t *pred = plane == 0 ? y_pred : uv_pred[plane - 1];
        int32_t *rec = t->recon[plane];
        if (skip) {
            set_lvl_ctx_rect(t, plane, x, y, bw, bh, 0, 0);
            for (int rr = 0; rr < bh; rr++)
                for (int cc = 0; cc < bw; cc++) {
                    int32_t v = pred[rr * bw + cc];
                    rec[(size_t)(y + rr) * t->pw + x + cc] =
                        v < 0 ? 0 : (v > hi ? hi : v);
                }
            continue;
        }
        encode_coeffs_rect_c(t, plane, bw, bh, x, y, lv);
        if (plane == 0) {
            for (int rr = 0; rr < bh; rr++)
                memcpy(rec + (size_t)(y + rr) * t->pw + x,
                       y_recon + (size_t)rr * bw, (size_t)bw * 4);
        } else {
            int lnz = 0;
            for (int i = 0; i < npx; i++)
                if (lv[i]) { lnz = 1; break; }
            int32_t residb[32 * 32];
            if (lnz) dequant_inv_rect(t, lv, bw, bh, 1, residb);
            for (int rr = 0; rr < bh; rr++)
                for (int cc = 0; cc < bw; cc++) {
                    int32_t v = pred[rr * bw + cc] +
                                (lnz ? residb[rr * bw + cc] : 0);
                    rec[(size_t)(y + rr) * t->pw + x + cc] =
                        v < 0 ? 0 : (v > hi ? hi : v);
                }
        }
    }

    /* --- context updates --- */
    for (int i = 0; i < nw; i++) {
        t->above_skip[c + i] = skip;
        t->above_mode[c + i] = (uint8_t)y_mode;
        t->above_txw[c + i] = bw;
    }
    for (int i = 0; i < nh; i++) {
        t->left_skip[lr + i] = skip;
        t->left_mode[lr + i] = (uint8_t)y_mode;
        t->left_txh[lr + i] = bh;
    }
    if (t->screen_tools) set_pal_ctx(t, r, c, nw, nh, NULL, 0);
}

/* device-plan lookups (mirror frame.py _planned_*) */
static int planned_part64(const Tile *t, int r, int c) {
    if (!t->plan64) return -1;
    int i = r / 16, j = c / 16;
    int sby = t->plan_nby / 2, sbx = t->plan_nbx / 2;
    if (i >= sby || j >= sbx || t->plan64[(size_t)i * sbx + j] < 0) return -1;
    return t->plan64[(size_t)i * sbx + j] > 0 ? PARTITION_NONE
                                              : PARTITION_SPLIT;
}

static int planned_part32(const Tile *t, int r, int c) {
    if (!t->part32) return -1;
    int i = r / 8, j = c / 8;
    if (i >= t->plan_nby || j >= t->plan_nbx) return -1;
    return t->part32[(size_t)i * t->plan_nbx + j] ? PARTITION_SPLIT
                                                  : PARTITION_NONE;
}

static int planned_mode(const Tile *t, int r, int c, int size) {
    if (!t->plan64) return -1;
    if (size == 64) {
        int i = r / 16, j = c / 16;
        int sby = t->plan_nby / 2, sbx = t->plan_nbx / 2;
        if (i < sby && j < sbx && t->plan64[(size_t)i * sbx + j] > 0)
            return t->plan64[(size_t)i * sbx + j] - 1;
    } else if (size == 32) {
        int i = r / 8, j = c / 8;
        if (i < t->plan_nby && j < t->plan_nbx &&
            t->mode32[(size_t)i * t->plan_nbx + j] >= 0)
            return t->mode32[(size_t)i * t->plan_nbx + j];
    } else if (size == 16) {
        int i = r / 4, j = c / 4;
        if (i < 2 * t->plan_nby && j < 2 * t->plan_nbx &&
            t->mode16[(size_t)i * 2 * t->plan_nbx + j] >= 0)
            return t->mode16[(size_t)i * 2 * t->plan_nbx + j];
    }
    return -1;
}

static int tx_ctx_c(const Tile *t, int r, int c, int btx) {
    int above = r > 0 ? t->above_txw[c] : 0;
    int left = c > 0 ? t->left_txh[r & t->lmask] : 0;
    return (above >= btx ? 1 : 0) + (left >= btx ? 1 : 0);
}

static void encode_block(Tile *t, int r, int c, int size) {
    PROF_SCOPE(PROF_BLOCK);
    int x = c * 4, y = r * 4;
    int n_mi = size / 4;
    int lr = r & t->lmask;
    int nplanes = t->nplanes;

    int block_idx = -1;
    if (t->blocks_out) {
        block_idx = t->n_blocks++;
        t->blocks_out[block_idx * 5] = r;
        t->blocks_out[block_idx * 5 + 1] = c;
        t->blocks_out[block_idx * 5 + 2] = size;
        t->blocks_out[block_idx * 5 + 3] = 0; /* skip backfilled below */
        t->blocks_out[block_idx * 5 + 4] = size < 64 ? size : 64;
    }

    /* per-block λ scale from source-luma variance (mirrors frame.py) */
    if (t->mean_var > 0.0) {
        int64_t s1 = 0, s2 = 0;
        const int32_t *srcp = t->src[0];
        for (int rr = 0; rr < size; rr++)
            for (int cc = 0; cc < size; cc++) {
                int64_t v = srcp[(size_t)(y + rr) * t->pw + x + cc];
                s1 += v;
                s2 += v * v;
            }
        int64_t n_ = (int64_t)size * size;
        double var_b = (double)(n_ * s2 - s1 * s1) / (double)(n_ * n_);
        double sc = sqrt((var_b + 16.0) / (t->mean_var + 16.0));
        if (sc < 0.25) sc = 0.25;
        if (sc > 4.0) sc = 4.0;
        t->cur_lamscale = sc;
    } else {
        t->cur_lamscale = 1.0;
    }

    int have_above0 = r > 0, have_left0 = c > 0;
    int ntr0, nbl0;
    edge_counts(t, r, c, size, &ntr0, &nbl0);
    Edges ey;
    build_edges_buf_tr(t, t->recon[0], x, y, size, size, have_above0,
                       have_left0, ntr0, nbl0, &ey);

    int y_mode = planned_mode(t, r, c, size);
    /* a 16-grid plan entry may carry a directional NOMINEE in the high
     * byte: the host duels it against the non-directional winner with a
     * real D + lambda*R trial below */
    int y_nominee = -1;
    if (y_mode >= 256) {
        y_nominee = (y_mode >> 8) - 1;
        y_mode &= 255;
    }
    int32_t pred_scratch[64 * 64];
    if (y_mode < 0)
        y_mode = choose_y_mode(t, r, c, size, &ey, have_above0, have_left0,
                               pred_scratch);

    /* cross-probe decision replay */
    int rep_on = 0, rep_depth = 0, rep_uv = -1, rep_au = 0, rep_av = 0;
    int rep_tt[4] = {0, 0, 0, 0};
    int32_t dec_tag = (int32_t)((r << 16) | (c << 8) | size);
    if (t->dec_mode == 2) {
        if (t->dec_pos + 10 <= t->dec_cap &&
            t->dec_buf[t->dec_pos] == dec_tag) {
            const int32_t *dd = t->dec_buf + t->dec_pos;
            t->dec_pos += 10;
            rep_on = 1;
            rep_depth = dd[1];
            rep_tt[0] = dd[2]; rep_tt[1] = dd[3];
            rep_tt[2] = dd[4]; rep_tt[3] = dd[5];
            rep_uv = dd[6]; rep_au = dd[7]; rep_av = dd[8];
            y_mode = dd[9]; /* the recorded duel winner */
            y_nominee = -1;
        } else {
            t->dec_mode = 0; /* sequence diverged: disarm for the tile */
        }
    }

    int can_code = size >= 8; /* tx_type signaled for tx <= 16 */
    int tx = size;
    int npx = tx * tx;
    int hi = (1 << t->bitdepth) - 1;
    int32_t *preds = (int32_t *)malloc((size_t)nplanes * npx * 4);
    int32_t *levels = (int32_t *)malloc((size_t)nplanes * npx * 4);

    /* --- palette duel (screen-content frames; mirrors frame.py): an
     * exact-palette candidate against the normal depth-0 path --- */
    int use_palette = 0, npal = 0;
    static _Thread_local uint16_t pal_colors[8];
    static _Thread_local uint8_t pal_map[64 * 64];
    if (t->screen_tools && size >= 8 && size <= 64 && rep_on &&
        rep_depth == 9 && can_code) {
        /* replayed palette decision (depth slot 9): the candidate is
         * deterministic from the source; only the duel is skipped */
        int64_t rate_pal, dist_pal;
        int cand = try_palette_y_c(t, x, y, size, pal_colors, pal_map,
                                   &rate_pal, &dist_pal, 0);
        if (cand) {
            use_palette = 1;
            npal = cand;
            y_mode = DC_PRED;
            y_nominee = -1;
        } else {
            rep_on = 0;
            t->dec_mode = 0;
        }
    }
    static _Thread_local int32_t lv_a[64 * 64], pr_a[64 * 64];
    static _Thread_local int32_t y_recon[64 * 64];
    int tt_a[4] = {0, 0, 0, 0};
    int64_t d0 = 0, r0 = 0;
    int d0_done = 0; /* depth-0 trial already cached in lv_a/... */
    if (t->screen_tools && size >= 8 && size <= 64 && !rep_on &&
        !use_palette && can_code) {
        int64_t rate_pal, dist_pal;
        int cand = try_palette_y_c(t, x, y, size, pal_colors, pal_map,
                                   &rate_pal, &dist_pal, 1);
        if (cand) {
            /* the duel's depth-0 trial doubles as the main duel's
             * depth-0 arm (identical inputs, recon restored) — cached
             * so the losing-palette path never recomputes it */
            try_luma_depth_c(t, x, y, size, 0, y_mode, ntr0, nbl0,
                             can_code, NULL, 1, lv_a, pr_a, tt_a, y_recon,
                             &d0, &r0);
            d0_done = 1;
            double lam_pix =
                (double)(((int64_t)t->dq_ac * t->dq_ac >> 6) * RDOQ_KNUM) /
                (RDOQ_KDEN * 128.0) * t->cur_lamscale;
            /* lossy candidates carry their clustering SSE as distortion
             * (zero for exact 2..8-value blocks) */
            if ((double)dist_pal + lam_pix * (double)rate_pal <
                (double)d0 + lam_pix * (double)r0) {
                use_palette = 1;
                npal = cand;
                y_mode = DC_PRED;
                y_nominee = -1;
            }
        }
    }

    /* --- luma tx-depth RD: tx == block vs 4-way split (mirrors
     * frame.py). Each candidate runs the real per-txb encode; judged by
     * pixel SSE + λ·(CDF rate estimate + tx_depth symbol cost). --- */
    int btx = size < 64 ? size : 64;
    int y_depth = 0;
    int y_txtypes[4] = {0, 0, 0, 0};
    if (use_palette) {
        /* palette prediction is exact; zero residual, depth 0 */
        memset(levels, 0, (size_t)npx * 4);
        for (int i = 0; i < npx; i++) {
            int32_t v = pal_colors[pal_map[i]];
            preds[i] = v;
            y_recon[i] = v < 0 ? 0 : (v > hi ? hi : v);
        }
    } else {
        static _Thread_local int32_t lv_b[64 * 64], pr_b[64 * 64];
        static _Thread_local int32_t rec_b[64 * 64];
        int tt_b[4] = {0, 0, 0, 0};
        if (rep_on) {
            y_depth = rep_depth;
            if (!try_luma_depth_c(t, x, y, size, y_depth, y_mode, ntr0,
                                  nbl0, can_code, rep_tt, 1, lv_a, pr_a,
                                  tt_a, y_recon, &d0, &r0)) {
                /* replayed split is all-zero at this q: skip semantics
                 * demand the depth-0 whole-block prediction */
                static const int tt_dct[4] = {0, 0, 0, 0};
                y_depth = 0;
                try_luma_depth_c(t, x, y, size, 0, y_mode, ntr0, nbl0,
                                 can_code, tt_dct, 1, lv_a, pr_a, tt_a,
                                 y_recon, &d0, &r0);
            }
            memcpy(y_txtypes, tt_a, sizeof(tt_a));
            goto luma_done;
        }
        if (!d0_done)
            try_luma_depth_c(t, x, y, size, 0, y_mode, ntr0, nbl0, can_code,
                             NULL, 1, lv_a, pr_a, tt_a, y_recon, &d0, &r0);
        int cat = log2i(size) - 3;
        int tctx = size > 4 ? tx_ctx_c(t, r, c, btx) : 0;
        double lam_pix =
            (double)(((int64_t)t->dq_ac * t->dq_ac >> 6) * RDOQ_KNUM) /
            (RDOQ_KDEN * 128.0) * t->cur_lamscale;
        if (y_nominee >= 0) {
            /* directional-nominee duel: real rate, not SSD. +600 rate
             * units (~4.7 bits) models the rarer kf_y symbol + the
             * angle_delta symbol the directional side pays. */
            int64_t dB = 0, rB = 0;
            if (try_luma_depth_c(t, x, y, size, 0, y_nominee, ntr0, nbl0,
                                 can_code, NULL, 1, lv_b, pr_b, tt_b, rec_b,
                                 &dB, &rB)) {
                /* only directional nominees pay the angle_delta +
                 * kf_y-rarity premium */
                int prem = (y_nominee >= 3 && y_nominee <= 8) ? 600 : 0;
                double rdA = (double)d0 + lam_pix * (double)r0;
                double rdB = (double)dB + lam_pix * (double)(rB + prem);
                if (rdB < rdA) {
                    y_mode = y_nominee;
                    d0 = dB;
                    r0 = rB;
                    memcpy(lv_a, lv_b, (size_t)npx * 4);
                    memcpy(pr_a, pr_b, (size_t)npx * 4);
                    memcpy(y_recon, rec_b, (size_t)npx * 4);
                    memcpy(tt_a, tt_b, sizeof(tt_b));
                }
            }
        }
        /* filter-intra duel (mirrors frame.py): the best-of-5 SSD
         * nominee vs the INCUMBENT's prediction (filter intra codes as
         * DC + flag, so it can replace any winner); the nominee earns a
         * real D + lambda*R trial only when it beats the incumbent's
         * SSD by > 10%. +300 rate units ~ the filter_intra_mode symbol. */
        if (t->filter_intra && size <= 32 && t->speed <= 9) {
            const int32_t *srcp0 = t->src[0];
            predict(t, &ey, y_mode, size, size, have_above0, have_left0,
                    pred_scratch);
            int64_t ssd_dc = 0;
            for (int rr = 0; rr < size; rr++)
                for (int cc = 0; cc < size; cc++) {
                    int64_t d = srcp0[(size_t)(y + rr) * t->pw + x + cc] -
                                pred_scratch[rr * size + cc];
                    ssd_dc += d * d;
                }
            int fi_best = -1;
            int64_t fi_ssd = 0;
            for (int fi2 = 0; fi2 < 5; fi2++) {
                predict(t, &ey, FILTER_BASE + fi2, size, size, have_above0,
                        have_left0, pred_scratch);
                int64_t s = 0;
                for (int rr = 0; rr < size; rr++)
                    for (int cc = 0; cc < size; cc++) {
                        int64_t d =
                            srcp0[(size_t)(y + rr) * t->pw + x + cc] -
                            pred_scratch[rr * size + cc];
                        s += d * d;
                    }
                if (fi_best < 0 || s < fi_ssd) {
                    fi_best = fi2;
                    fi_ssd = s;
                }
            }
            if (10 * fi_ssd < 9 * ssd_dc) {
                int64_t dF = 0, rF = 0;
                if (try_luma_depth_c(t, x, y, size, 0, FILTER_BASE + fi_best,
                                     ntr0, nbl0, can_code, NULL, 1, lv_b,
                                     pr_b, tt_b, rec_b, &dF, &rF)) {
                    double rdD = (double)d0 + lam_pix * (double)r0;
                    double rdF = (double)dF + lam_pix * (double)(rF + 300);
                    if (rdF < rdD) {
                        y_mode = FILTER_BASE + fi_best;
                        d0 = dF;
                        r0 = rF;
                        memcpy(lv_a, lv_b, (size_t)npx * 4);
                        memcpy(pr_a, pr_b, (size_t)npx * 4);
                        memcpy(y_recon, rec_b, (size_t)npx * 4);
                        memcpy(tt_a, tt_b, sizeof(tt_b));
                    }
                }
            }
        }
        if (can_code && btx >= 8 && t->speed <= 9 &&
            (t->speed <= 8 || btx <= 16) &&
            (t->speed <= 5 ||
             d0 > ((int64_t)size * size * t->dq_ac * t->dq_ac) >> 9)) {
            /* Two-phase tx-type search at the default speed: the split
             * TRIAL judges on DCT only (the per-sub-txb ADST duel is
             * most of the trial's quantize cost, wasted whenever
             * depth 0 wins); only a WINNING split re-runs with duels.
             * Quality presets (speed <= 8) keep dueled trials. */
            int duel_in_trial = t->speed <= 8;
            int64_t d1, r1;
            if (try_luma_depth_c(t, x, y, size, 1, y_mode, ntr0, nbl0,
                                 can_code, NULL, duel_in_trial, lv_b, pr_b,
                                 tt_b, rec_b, &d1, &r1)) {
                double rd0 = (double)(d0) +
                             lam_pix * (double)(r0 + t->rc_txsz[cat][tctx][0]);
                double rd1 = (double)(d1) +
                             lam_pix * (double)(r1 + t->rc_txsz[cat][tctx][1]);
                if (rd1 < rd0 &&
                    (duel_in_trial ||
                     try_luma_depth_c(t, x, y, size, 1, y_mode, ntr0, nbl0,
                                      can_code, NULL, 1, lv_b, pr_b, tt_b,
                                      rec_b, &d1, &r1))) {
                    y_depth = 1;
                    memcpy(lv_a, lv_b, (size_t)npx * 4);
                    memcpy(pr_a, pr_b, (size_t)npx * 4);
                    memcpy(y_recon, rec_b, (size_t)npx * 4);
                    memcpy(y_txtypes, tt_b, sizeof(tt_b));
                }
            }
        }
        if (!y_depth) memcpy(y_txtypes, tt_a, sizeof(tt_a));
    luma_done:
        memcpy(levels, lv_a, (size_t)npx * 4);
        memcpy(preds, pr_a, (size_t)npx * 4);
    }
    int y_tx = btx >> y_depth;
    int any_nonzero = 0;
    for (int i = 0; i < npx; i++)
        if (levels[i]) { any_nonzero = 1; break; }

    /* --- chroma: DC vs CfL (mirrors frame.py _plan_chroma) --- */
    int uv_mode = DC_PRED;
    int alpha_u = 0, alpha_v = 0;
    static _Thread_local int32_t uv64_lv[2][4][32 * 32];
    static _Thread_local int32_t uv64_pred[2][4][32 * 32];
    if (nplanes > 1 && size > 32) {
        /* 64x64 block: chroma transforms cap at 32x32 (spec adjusted tx
         * size) — four DC-predicted 32x32 txbs per plane in raster order,
         * each predicting from the previous txb's reconstruction
         * (mirrors frame.py _plan_chroma size > 32) */
        for (int p = 0; p < 2; p++) {
            int pi = 1 + p;
            int ti = 0;
            for (int sy = 0; sy < 64; sy += 32)
                for (int sx = 0; sx < 64; sx += 32, ti++) {
                    int px_ = x + sx, py_ = y + sy;
                    Edges e;
                    build_edges_buf(t, t->recon[pi], px_, py_, 32, 32,
                                    py_ > 0, px_ > 0, &e);
                    predict(t, &e, DC_PRED, 32, 32, py_ > 0, px_ > 0,
                            uv64_pred[p][ti]);
                    if (plane_levels_c(t, pi, px_, py_, 32, can_code,
                                       uv64_pred[p][ti], uv64_lv[p][ti]))
                        any_nonzero = 1;
                    int lnz = 0;
                    for (int i = 0; i < 32 * 32; i++)
                        if (uv64_lv[p][ti][i]) { lnz = 1; break; }
                    int32_t residb[32 * 32];
                    if (lnz)
                        dequant_inv_tt(t, uv64_lv[p][ti], 32, 0, 1, residb);
                    int32_t *rec = t->recon[pi];
                    for (int rr = 0; rr < 32; rr++)
                        for (int cc = 0; cc < 32; cc++) {
                            int32_t v = uv64_pred[p][ti][rr * 32 + cc] +
                                        (lnz ? residb[rr * 32 + cc] : 0);
                            rec[(size_t)(py_ + rr) * t->pw + px_ + cc] =
                                v < 0 ? 0 : (v > hi ? hi : v);
                        }
                }
        }
    } else if (nplanes > 1) {
        int32_t *dc_pred[2] = {preds + npx, preds + 2 * (size_t)npx};
        for (int i = 0; i < 2; i++) {
            Edges e;
            build_edges_buf_tr(t, t->recon[1 + i], x, y, tx, tx, y > 0,
                               x > 0, ntr0, nbl0, &e);
            predict(t, &e, DC_PRED, tx, tx, y > 0, x > 0, dc_pred[i]);
        }
        int use_cfl = 0;
        static _Thread_local int32_t cfl_pred[2][64 * 64];
        if (rep_on) {
            if (rep_uv == UV_CFL_PRED && (rep_au || rep_av) && size <= 32) {
                /* replayed CfL: rebuild lumaAC from THIS q's recon, apply
                 * the recorded alphas, skip the alpha search + DC trial */
                int64_t sum = 0;
                int lg = 0;
                while ((1 << lg) < size) lg++;
                lg *= 2;
                static _Thread_local int64_t diff_r[64 * 64];
                for (int i = 0; i < npx; i++) sum += (int64_t)y_recon[i] << 3;
                int64_t avg = (sum + ((int64_t)1 << (lg - 1))) >> lg;
                for (int i = 0; i < npx; i++)
                    diff_r[i] = ((int64_t)y_recon[i] << 3) - avg;
                int aa[2] = {rep_au, rep_av};
                for (int i = 0; i < 2; i++) {
                    for (int rr = 0; rr < tx; rr++)
                        for (int cc = 0; cc < tx; cc++) {
                            int64_t prod =
                                (int64_t)aa[i] * diff_r[rr * tx + cc];
                            int64_t contrib = prod < 0
                                                  ? -((-prod + 32) >> 6)
                                                  : ((prod + 32) >> 6);
                            int64_t p = dc_pred[i][rr * tx + cc] + contrib;
                            if (p < 0) p = 0;
                            if (p > hi) p = hi;
                            cfl_pred[i][rr * tx + cc] = (int32_t)p;
                        }
                    if (plane_levels_c(t, 1 + i, x, y, tx, can_code,
                                       cfl_pred[i],
                                       levels + (size_t)(1 + i) * npx))
                        any_nonzero = 1;
                    memcpy(preds + (size_t)(1 + i) * npx, cfl_pred[i],
                           (size_t)npx * 4);
                }
                uv_mode = UV_CFL_PRED;
                alpha_u = rep_au;
                alpha_v = rep_av;
                use_cfl = 1;
            }
        } else if (size <= 32) {
            /* lumaAC: (recon << 3) - Round2(sum, log2w+log2h) */
            int64_t sum = 0;
            int lg = 0;
            while ((1 << lg) < size) lg++;
            lg *= 2;
            static _Thread_local int64_t diff[64 * 64];
            for (int i = 0; i < npx; i++) sum += (int64_t)y_recon[i] << 3;
            int64_t avg = (sum + ((int64_t)1 << (lg - 1))) >> lg;
            for (int i = 0; i < npx; i++)
                diff[i] = ((int64_t)y_recon[i] << 3) - avg;

            int64_t var = 0;
            for (int i2 = 0; i2 < npx; i2++) var += diff[i2] * diff[i2];
            int best_a[2] = {0, 0};
            for (int i = 0; i < 2; i++) {
                const int32_t *srcp = t->src[1 + i];
                /* closed-form least-squares alpha (gain = alpha/8), +-1 */
                int64_t cov = 0;
                for (int rr = 0; rr < tx; rr++)
                    for (int cc = 0; cc < tx; cc++)
                        cov += diff[rr * tx + cc] *
                               (int64_t)(srcp[(size_t)(y + rr) * t->pw + x + cc] -
                                         dc_pred[i][rr * tx + cc]);
                int64_t a_est;
                if (var == 0 || cov == 0) a_est = 0;
                else {
                    a_est = (64 * llabs(cov) + var / 2) / var;
                    if (a_est > 16) a_est = 16;
                    if (cov < 0) a_est = -a_est;
                }
                if (a_est == 0) { best_a[i] = 0; continue; }
                int64_t best_ssd = -1;
                int64_t order[33];
                int ncand_a;
                if (t->speed <= 6) {
                    /* exhaustive alphabet at low speeds */
                    ncand_a = 0;
                    for (int a2 = -16; a2 <= 16; a2++)
                        if (a2) order[ncand_a++] = a2;
                } else {
                    order[0] = a_est; order[1] = a_est - 1;
                    order[2] = a_est + 1;
                    ncand_a = 3;
                }
                for (int k = 0; k < ncand_a; k++) {
                    int64_t a = order[k];
                    if (a < -16 || a > 16) continue;
                    int64_t ssd = 0;
                    for (int rr = 0; rr < tx; rr++)
                        for (int cc = 0; cc < tx; cc++) {
                            int64_t prod = a * diff[rr * tx + cc];
                            int64_t contrib =
                                prod < 0 ? -((-prod + 32) >> 6)
                                         : ((prod + 32) >> 6);
                            int64_t p = dc_pred[i][rr * tx + cc] + contrib;
                            if (p < 0) p = 0;
                            if (p > hi) p = hi;
                            int64_t dd =
                                srcp[(size_t)(y + rr) * t->pw + x + cc] - p;
                            ssd += dd * dd;
                        }
                    if (best_ssd < 0 || ssd < best_ssd) {
                        best_ssd = ssd;
                        best_a[i] = (int)a;
                    }
                }
            }
            if (best_a[0] || best_a[1]) {
                for (int i = 0; i < 2; i++)
                    for (int rr = 0; rr < tx; rr++)
                        for (int cc = 0; cc < tx; cc++) {
                            int64_t prod =
                                (int64_t)best_a[i] * diff[rr * tx + cc];
                            int64_t contrib =
                                prod < 0 ? -((-prod + 32) >> 6)
                                         : ((prod + 32) >> 6);
                            int64_t p =
                                dc_pred[i][rr * tx + cc] + contrib;
                            if (p < 0) p = 0;
                            if (p > hi) p = hi;
                            cfl_pred[i][rr * tx + cc] = (int32_t)p;
                        }
                static _Thread_local int32_t lv_dc[2][64 * 64],
                    lv_cfl[2][64 * 64];
                int64_t cost_dc = 0, cost_cfl = 4;
                for (int i = 0; i < 2; i++) {
                    plane_levels_c(t, 1 + i, x, y, tx, can_code, dc_pred[i],
                                   lv_dc[i]);
                    plane_levels_c(t, 1 + i, x, y, tx, can_code, cfl_pred[i],
                                   lv_cfl[i]);
                    cost_dc += rate_proxy(lv_dc[i], npx);
                    cost_cfl += rate_proxy(lv_cfl[i], npx);
                }
                if (cost_cfl < cost_dc) {
                    uv_mode = UV_CFL_PRED;
                    alpha_u = best_a[0];
                    alpha_v = best_a[1];
                    for (int i = 0; i < 2; i++) {
                        memcpy(preds + (size_t)(1 + i) * npx, cfl_pred[i],
                               (size_t)npx * 4);
                        memcpy(levels + (size_t)(1 + i) * npx, lv_cfl[i],
                               (size_t)npx * 4);
                        for (int k = 0; k < npx; k++)
                            if (lv_cfl[i][k]) { any_nonzero = 1; break; }
                    }
                } else {
                    for (int i = 0; i < 2; i++) {
                        memcpy(levels + (size_t)(1 + i) * npx, lv_dc[i],
                               (size_t)npx * 4);
                        for (int k = 0; k < npx; k++)
                            if (lv_dc[i][k]) { any_nonzero = 1; break; }
                    }
                }
                use_cfl = 1; /* levels already computed either way */
            }
        }
        if (!use_cfl) {
            for (int i = 0; i < 2; i++)
                if (plane_levels_c(t, 1 + i, x, y, tx, can_code, dc_pred[i],
                                   levels + (size_t)(1 + i) * npx))
                    any_nonzero = 1;
        }
    }
    int skip = !any_nonzero;
    if (skip) { y_depth = 0; y_tx = btx; } /* all-zero splits are rejected
                                              upstream, so skip ⇒ depth 0 */
    if (t->dec_mode == 1 && t->dec_buf && t->dec_pos + 10 <= t->dec_cap) {
        int32_t *dd = t->dec_buf + t->dec_pos;
        t->dec_pos += 10;
        dd[0] = dec_tag;
        dd[1] = use_palette ? 9 : y_depth;
        dd[2] = y_txtypes[0]; dd[3] = y_txtypes[1];
        dd[4] = y_txtypes[2]; dd[5] = y_txtypes[3];
        dd[6] = uv_mode; dd[7] = alpha_u; dd[8] = alpha_v;
        dd[9] = y_mode;
    }
    if (block_idx >= 0) {
        t->blocks_out[block_idx * 5 + 3] = skip;
        t->blocks_out[block_idx * 5 + 4] = y_tx;
    }

    /* symbols: skip, modes */
    int skip_ctx = t->above_skip[c] + t->left_skip[lr];
    enc_symbol_adapt(t->enc, t->cdf[CDF_SKIP] + (size_t)skip_ctx * 3, 2, skip);

    /* filter-intra blocks code YMode = DC_PRED + the filter fields */
    int fi_blk = y_mode >= FILTER_BASE ? y_mode - FILTER_BASE : -1;
    int sym_y = fi_blk >= 0 ? DC_PRED : y_mode;
    int actx = r > 0 ? INTRA_MODE_CONTEXT[t->above_mode[c]] : 0;
    int lctx = c > 0 ? INTRA_MODE_CONTEXT[t->left_mode[lr]] : 0;
    enc_symbol_adapt(t->enc,
                     t->cdf[CDF_KF_Y] + ((size_t)actx * 5 + lctx) * 14, 13,
                     sym_y);
    if (MODE_ANGLE[sym_y] && size >= 8)
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_ANGLE_DELTA] + (size_t)(sym_y - 1) * 8, 7,
                         3); /* delta 0 */
    if (nplanes > 1) {
        int cfl_allowed = size <= 32;
        if (cfl_allowed)
            enc_symbol_adapt(
                t->enc, t->cdf[CDF_UV_MODE_CFL] + (size_t)sym_y * 15, 14,
                uv_mode);
        else
            enc_symbol_adapt(t->enc, t->cdf[CDF_UV_MODE] + (size_t)sym_y * 14,
                             13, uv_mode);
        if (uv_mode == UV_CFL_PRED) {
            /* cfl_alphas(): joint sign, then per-plane alphabet index */
            int sign_u = alpha_u == 0 ? 0 : (alpha_u < 0 ? 1 : 2);
            int sign_v = alpha_v == 0 ? 0 : (alpha_v < 0 ? 1 : 2);
            int joint = sign_u * 3 + sign_v - 1;
            enc_symbol_adapt(t->enc, t->cdf[CDF_CFL_SIGN], 8, joint);
            if (sign_u)
                enc_symbol_adapt(
                    t->enc,
                    t->cdf[CDF_CFL_ALPHA] + (size_t)(joint - 2) * 17, 16,
                    abs(alpha_u) - 1);
            if (sign_v)
                enc_symbol_adapt(
                    t->enc,
                    t->cdf[CDF_CFL_ALPHA] +
                        (size_t)(sign_v * 3 + sign_u - 3) * 17,
                    16, abs(alpha_v) - 1);
        } else if (MODE_ANGLE[uv_mode] && size >= 8) {
            enc_symbol_adapt(t->enc,
                             t->cdf[CDF_ANGLE_DELTA] + (size_t)(uv_mode - 1) * 8,
                             7, 3);
        }
    }

    /* palette_mode_info + index map (mirrors frame.py; spec
     * palette_tokens precedes read_block_tx_size) */
    if (t->screen_tools && size >= 8 && size <= 64) {
        int bctx = palette_bsize_ctx(size, size);
        if (sym_y == DC_PRED) {
            int pctx = ((r > 0 && t->above_pal_n[c]) ? 1 : 0) +
                       ((c > 0 && t->left_pal_n[lr]) ? 1 : 0);
            enc_symbol_adapt(
                t->enc, t->cdf[CDF_PAL_Y_MODE] + ((size_t)bctx * 3 + pctx) * 3,
                2, use_palette);
            if (use_palette) {
                enc_symbol_adapt(t->enc,
                                 t->cdf[CDF_PAL_Y_SIZE] + (size_t)bctx * 8,
                                 7, npal - 2);
                uint16_t cache[18];
                int nc = palette_cache_c(t, r, c, cache);
                code_palette_colors_y_c(t, pal_colors, npal, cache, nc);
            }
        }
        if (nplanes > 1 && uv_mode == DC_PRED)
            enc_symbol_adapt(
                t->enc,
                t->cdf[CDF_PAL_UV_MODE] + (size_t)(use_palette ? 1 : 0) * 3,
                2, 0);
        if (use_palette)
            palette_tokens_y_c(t, pal_map, size, size, npal, 1);
    }

    /* filter_intra_mode_info (spec 5.11.24): after palette_mode_info,
     * before read_block_tx_size (mirrors frame.py) */
    if (t->filter_intra && size <= 32 && sym_y == DC_PRED && !use_palette) {
        static const int FI_BSI[33] = {[4] = 0, [8] = 3, [16] = 6, [32] = 9};
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_FI_USE] + (size_t)FI_BSI[size] * 3, 2,
                         fi_blk >= 0);
        if (fi_blk >= 0)
            enc_symbol_adapt(t->enc, t->cdf[CDF_FI_MODE], 5, fi_blk);
    }

    /* read_block_tx_size: intra blocks code tx_depth after mode info
     * (allowSelect is true even for skip intra blocks) */
    if (size > 4) {
        int cat = log2i(size) - 3;
        int tctx = tx_ctx_c(t, r, c, btx);
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_TX_SIZE] + ((size_t)cat * 3 + tctx) * 4,
                         cat == 0 ? 2 : 3, y_depth);
    }

    /* residual coding + recon. The tx-type syntax indexes its CDF row by
     * the intra DIRECTION (Filter_Intra_Mode_To_Intra_Dir for filter
     * blocks; mirrors frame.py). */
    int txdir = fi_blk >= 0 ? FIMODE_TO_DIR[fi_blk] : y_mode;
    for (int plane = 0; plane < nplanes; plane++) {
        if (plane == 0) {
            /* luma: per-txb coeffs in raster order; recon = trial recon */
            int ytx = y_tx;
            int nt = size / ytx;
            int idx = 0;
            for (int ti = 0; ti < nt; ti++)
                for (int tj = 0; tj < nt; tj++, idx++) {
                    int px_ = x + tj * ytx, py_ = y + ti * ytx;
                    if (skip) {
                        set_lvl_ctx(t, 0, px_, py_, ytx, 0, 0);
                    } else {
                        encode_coeffs_txb(
                            t, 0, ytx, px_, py_,
                            levels + (size_t)idx * ytx * ytx, size,
                            txdir | (y_txtypes[idx] << 8));
                    }
                }
            int32_t *rec = t->recon[0];
            for (int rr = 0; rr < size; rr++)
                memcpy(rec + (size_t)(y + rr) * t->pw + x,
                       y_recon + (size_t)rr * size, (size_t)size * 4);
            continue;
        }
        if (size > 32 && plane > 0) {
            /* chroma of a 64 block: four 32x32 txbs (recon already
             * written during planning) */
            int p = plane - 1, ti = 0;
            for (int sy = 0; sy < 64; sy += 32)
                for (int sx = 0; sx < 64; sx += 32, ti++) {
                    int px_ = x + sx, py_ = y + sy;
                    if (skip)
                        set_lvl_ctx(t, plane, px_, py_, 32, 0, 0);
                    else
                        encode_coeffs_txb(t, plane, 32, px_, py_,
                                          uv64_lv[p][ti], size, y_mode);
                }
            continue;
        }
        int32_t *pred = preds + (size_t)plane * tx * tx;
        int32_t *lv = levels + (size_t)plane * tx * tx;
        int32_t *rec = t->recon[plane];
        if (skip) {
            set_lvl_ctx(t, plane, x, y, tx, 0, 0);
            for (int rr = 0; rr < tx; rr++)
                for (int cc = 0; cc < tx; cc++) {
                    int32_t v = pred[rr * tx + cc];
                    rec[(size_t)(y + rr) * t->pw + x + cc] =
                        v < 0 ? 0 : (v > hi ? hi : v);
                }
        } else {
            encode_coeffs_txb(t, plane, tx, x, y, lv, size, txdir);
            int32_t resid[64 * 64];
            dequant_inv_tt(t, lv, tx, 0, 1, resid);
            for (int rr = 0; rr < tx; rr++)
                for (int cc = 0; cc < tx; cc++) {
                    int32_t v = pred[rr * tx + cc] + resid[rr * tx + cc];
                    rec[(size_t)(y + rr) * t->pw + x + cc] =
                        v < 0 ? 0 : (v > hi ? hi : v);
                }
        }
    }
    free(preds);
    free(levels);

    /* context updates (filter blocks store their syntax mode, DC) */
    for (int i = 0; i < n_mi; i++) {
        t->above_skip[c + i] = skip;
        t->left_skip[lr + i] = skip;
        t->above_mode[c + i] = (uint8_t)sym_y;
        t->left_mode[lr + i] = (uint8_t)sym_y;
        t->above_txw[c + i] = y_tx;
        t->left_txh[lr + i] = y_tx;
    }
    if (t->screen_tools)
        set_pal_ctx(t, r, c, n_mi, n_mi, pal_colors,
                    use_palette ? npal : 0);
}

/* ---- partition RD decision (mirrors frame.py) ---- */

static int64_t src_mode_ssd_wh(const Tile *t, int x, int y, int w, int h) {
    PROF_SCOPE(PROF_PART);
    Edges e;
    int ha = y > 0, hl = x > 0;
    build_edges_buf(t, t->src[0], x, y, w, h, ha, hl, &e);
    int cands[5] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED};
    int ncand = 5;
    int32_t pred[64 * 64];
    int64_t best = -1;
    for (int m = 0; m < ncand; m++) {
        predict(t, &e, cands[m], w, h, ha, hl, pred);
        int64_t ssd = 0;
        for (int rr = 0; rr < h; rr++)
            for (int cc = 0; cc < w; cc++) {
                int64_t d = t->src[0][(size_t)(y + rr) * t->pw + x + cc] -
                            pred[rr * w + cc];
                ssd += d * d;
            }
        if (best < 0 || ssd < best) best = ssd;
    }
    return best;
}

static int64_t src_mode_ssd(const Tile *t, int x, int y, int size) {
    return src_mode_ssd_wh(t, x, y, size, size);
}

static int64_t src_dc_ssd(const Tile *t, int plane, int x, int y,
                          int size) {
    Edges e;
    int ha = y > 0, hl = x > 0;
    build_edges_buf(t, t->src[plane], x, y, size, size, ha, hl, &e);
    int32_t pred[64 * 64];
    predict(t, &e, DC_PRED, size, size, ha, hl, pred);
    int64_t ssd = 0;
    for (int rr = 0; rr < size; rr++)
        for (int cc = 0; cc < size; cc++) {
            int64_t d = t->src[plane][(size_t)(y + rr) * t->pw + x + cc] -
                        pred[rr * size + cc];
            ssd += d * d;
        }
    return ssd;
}

static int choose_partition64(const Tile *t, int r, int c) {
    /* NONE at 64 saves three partition symbols + three mode/skip sets on
     * smooth superblocks; prefer it when one 64-wide prediction is nearly
     * as good as four 32s (integer RD, mirrors frame.py) */
    int x = c * 4, y = r * 4;
    int64_t ssd_parent = src_mode_ssd(t, x, y, 64);
    int64_t ssd_kids = 0;
    for (int dy = 0; dy < 64; dy += 32)
        for (int dx = 0; dx < 64; dx += 32)
            ssd_kids += src_mode_ssd(t, x + dx, y + dy, 32);
    int64_t penalty = 4 * (int64_t)t->dq_ac * t->dq_ac;
    /* also require a near-flat SB (residual quantizes to ~zero): larger
     * blocks forgo CfL, which costs more than the saved signaling on
     * content with luma-correlated chroma (measured on gradients) */
    int64_t flat_gate = (int64_t)64 * 64 * t->dq_ac * t->dq_ac / 64;
    if (ssd_parent > ssd_kids + penalty || ssd_parent > flat_gate)
        return PARTITION_SPLIT;
    /* chroma must be near-flat too: 64 blocks can't use CfL, and DC-only
     * chroma costs more than the saved signaling unless it quantizes away
     * (measured on gradients with luma-correlated chroma) */
    for (int p = 1; p < t->nplanes; p++)
        if (src_dc_ssd(t, p, c * 4, r * 4, 64) > flat_gate)
            return PARTITION_SPLIT;
    return PARTITION_NONE;
}

static int choose_partition32(Tile *t, int r, int c) {
    int x = c * 4, y = r * 4;
    int64_t ssd_parent = src_mode_ssd(t, x, y, 32);
    int64_t ssd_kids = 0;
    for (int dy = 0; dy <= 16; dy += 16)
        for (int dx = 0; dx <= 16; dx += 16)
            ssd_kids += src_mode_ssd(t, x + dx, y + dy, 16);
    int64_t penalty = (int64_t)t->dq_ac * t->dq_ac;
    int64_t best_ssd = ssd_parent;
    int best_part = PARTITION_NONE;
    if (ssd_kids + penalty < best_ssd) {
        best_ssd = ssd_kids + penalty;
        best_part = PARTITION_SPLIT;
    }
    if (!t->enable_rect) return best_part;
    /* rect arms: SSD proxy nominates, a real luma D+lambda*R duel
     * against the proxy-winning square arm decides (mirrors frame.py
     * _choose_partition32) */
    int64_t half_pen = penalty >> 1;
    int64_t ssd_h = src_mode_ssd_wh(t, x, y, 32, 16) +
                    src_mode_ssd_wh(t, x, y + 16, 32, 16);
    int64_t ssd_v = src_mode_ssd_wh(t, x, y, 16, 32) +
                    src_mode_ssd_wh(t, x + 16, y, 16, 32);
    int64_t ssd_r = ssd_h <= ssd_v ? ssd_h : ssd_v;
    int part_r = ssd_h <= ssd_v ? 1 : 2;
    /* quality speeds (<= 4) duel BOTH rect orientations with real RD
     * unconditionally (mirrors frame.py) */
    int exhaustive = t->speed <= 4;
    if (!exhaustive && ssd_r + half_pen >= best_ssd) return best_part;
    double lam_pix =
        (double)((((int64_t)t->dq_ac * t->dq_ac) >> 6) * RDOQ_KNUM) /
        (RDOQ_KDEN * 128.0);
    double save_lam = t->cur_lamscale;
    t->cur_lamscale = 1.0;
    int64_t d_sq, r_sq;
    try_square_arm_c(t, r, c, best_part == PARTITION_NONE ? 0 : 3, &d_sq,
                     &r_sq);
    int arms[2] = {part_r, part_r == 1 ? 2 : 1};
    int narms = exhaustive ? 2 : 1;
    int hdr = 640;
    int64_t n_sq = best_part == PARTITION_NONE ? 0 : 3 * hdr;
    double rd_best = (double)d_sq + lam_pix * (double)(r_sq + n_sq);
    int pick = best_part;
    for (int a = 0; a < narms; a++) {
        int64_t d_re, r_re;
        try_rect_luma_c(t, x, y, arms[a], &d_re, &r_re);
        double rd_re = (double)d_re + lam_pix * (double)(r_re + hdr);
        if (rd_re < rd_best) {
            rd_best = rd_re;
            pick = arms[a];
        }
    }
    t->cur_lamscale = save_lam;
    return pick;
}

/* ---- 128x128 blocks (sb128 roots; mirrors frame.py size==128) ----
 * Reached only through the near-flat partition gate: DC luma mode at
 * depth 0 (four TX_64X64 units), DC chroma (sixteen TX_32X32), and the
 * spec residual() CHUNK order: 64x64 chunks with planes interleaved
 * per chunk. Byte-identical to the Python coder
 * (tests/test_sb128.py). */

static void encode_block_128(Tile *t, int r, int c) {
    PROF_SCOPE(PROF_BLOCK);
    int x = c * 4, y = r * 4;
    int lr = r & t->lmask;
    int nplanes = t->nplanes;
    int hi = (1 << t->bitdepth) - 1;
    enum { SZ = 128, NPX = 128 * 128 };

    int block_idx = -1;
    if (t->blocks_out) {
        block_idx = t->n_blocks++;
        t->blocks_out[block_idx * 5] = r;
        t->blocks_out[block_idx * 5 + 1] = c;
        t->blocks_out[block_idx * 5 + 2] = SZ;
        t->blocks_out[block_idx * 5 + 3] = 0;
        t->blocks_out[block_idx * 5 + 4] = 64;
    }

    /* per-block lambda scale (mirrors frame.py) */
    if (t->mean_var > 0.0) {
        int64_t s1 = 0, s2 = 0;
        const int32_t *srcp = t->src[0];
        for (int rr = 0; rr < SZ; rr++)
            for (int cc = 0; cc < SZ; cc++) {
                int64_t v = srcp[(size_t)(y + rr) * t->pw + x + cc];
                s1 += v;
                s2 += v * v;
            }
        int64_t n_ = (int64_t)SZ * SZ;
        double var_b = (double)(n_ * s2 - s1 * s1) / (double)(n_ * n_);
        double sc = sqrt((var_b + 16.0) / (t->mean_var + 16.0));
        if (sc < 0.25) sc = 0.25;
        if (sc > 4.0) sc = 4.0;
        t->cur_lamscale = sc;
    } else {
        t->cur_lamscale = 1.0;
    }

    int dec_tag = (r << 16) | (c << 8) | SZ;
    if (t->dec_mode == 2) {
        /* every 128 decision is forced (DC, depth 0): consume the row */
        if (t->dec_pos + 10 <= t->dec_cap &&
            t->dec_buf[t->dec_pos] == dec_tag)
            t->dec_pos += 10;
        else
            t->dec_mode = 0;
    }

    /* luma: four TX_64X64 units, DC-predicted sequentially from recon */
    static _Thread_local int32_t lv128[4][64 * 64];
    static _Thread_local int32_t pr64[64 * 64], resid64[64 * 64];
    int skip = 1;
    int unz[4] = {0, 0, 0, 0};
    for (int ti = 0; ti < 2; ti++)
        for (int tj = 0; tj < 2; tj++) {
            int idx = ti * 2 + tj;
            int px_ = x + tj * 64, py_ = y + ti * 64;
            Edges e;
            build_edges_buf(t, t->recon[0], px_, py_, 64, 64, py_ > 0,
                            px_ > 0, &e);
            predict(t, &e, DC_PRED, 64, 64, py_ > 0, px_ > 0, pr64);
            if (plane_levels_c(t, 0, px_, py_, 64, 1, pr64, lv128[idx]))
                skip = 0;
            int lnz = 0;
            for (int i = 0; i < 64 * 64; i++)
                if (lv128[idx][i]) { lnz = 1; break; }
            unz[idx] = lnz;
            if (lnz) dequant_inv_tt(t, lv128[idx], 64, 0, 0, resid64);
            int32_t *rec = t->recon[0];
            for (int rr = 0; rr < 64; rr++)
                for (int cc = 0; cc < 64; cc++) {
                    int32_t v = pr64[rr * 64 + cc] +
                                (lnz ? resid64[rr * 64 + cc] : 0);
                    rec[(size_t)(py_ + rr) * t->pw + px_ + cc] =
                        v < 0 ? 0 : (v > hi ? hi : v);
                }
        }

    /* chroma: sixteen TX_32X32 per plane, DC, raster (prediction order
     * is raster per plane; only the SYMBOL order is chunked) */
    static _Thread_local int32_t uvlv128[2][16][32 * 32];
    if (nplanes > 1) {
        static _Thread_local int32_t pr32[32 * 32], resid32[32 * 32];
        for (int p = 0; p < 2; p++) {
            int pi = 1 + p, ti = 0;
            for (int sy = 0; sy < SZ; sy += 32)
                for (int sx = 0; sx < SZ; sx += 32, ti++) {
                    int px_ = x + sx, py_ = y + sy;
                    Edges e;
                    build_edges_buf(t, t->recon[pi], px_, py_, 32, 32,
                                    py_ > 0, px_ > 0, &e);
                    predict(t, &e, DC_PRED, 32, 32, py_ > 0, px_ > 0, pr32);
                    if (plane_levels_c(t, pi, px_, py_, 32, 1, pr32,
                                       uvlv128[p][ti]))
                        skip = 0;
                    int lnz = 0;
                    for (int i = 0; i < 32 * 32; i++)
                        if (uvlv128[p][ti][i]) { lnz = 1; break; }
                    if (lnz)
                        dequant_inv_tt(t, uvlv128[p][ti], 32, 0, 1, resid32);
                    int32_t *rec = t->recon[pi];
                    for (int rr = 0; rr < 32; rr++)
                        for (int cc = 0; cc < 32; cc++) {
                            int32_t v = pr32[rr * 32 + cc] +
                                        (lnz ? resid32[rr * 32 + cc] : 0);
                            rec[(size_t)(py_ + rr) * t->pw + px_ + cc] =
                                v < 0 ? 0 : (v > hi ? hi : v);
                        }
                }
        }
    }

    if (t->dec_mode == 1 && t->dec_buf && t->dec_pos + 10 <= t->dec_cap) {
        int32_t *dd = t->dec_buf + t->dec_pos;
        t->dec_pos += 10;
        dd[0] = dec_tag;
        dd[1] = 0; dd[2] = 0; dd[3] = 0; dd[4] = 0; dd[5] = 0;
        dd[6] = DC_PRED; dd[7] = 0; dd[8] = 0; dd[9] = DC_PRED;
    }
    if (block_idx >= 0) t->blocks_out[block_idx * 5 + 3] = skip;

    /* --- symbols: skip, modes, tx depth --- */
    int skip_ctx = t->above_skip[c] + t->left_skip[lr];
    enc_symbol_adapt(t->enc, t->cdf[CDF_SKIP] + (size_t)skip_ctx * 3, 2, skip);
    int actx = r > 0 ? INTRA_MODE_CONTEXT[t->above_mode[c]] : 0;
    int lctx = c > 0 ? INTRA_MODE_CONTEXT[t->left_mode[lr]] : 0;
    enc_symbol_adapt(t->enc,
                     t->cdf[CDF_KF_Y] + ((size_t)actx * 5 + lctx) * 14, 13,
                     DC_PRED);
    if (nplanes > 1)
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_UV_MODE] + (size_t)DC_PRED * 14, 13,
                         DC_PRED);
    /* read_block_tx_size: cat 3 (max square tx 64, same as 64 blocks) */
    {
        int tctx = tx_ctx_c(t, r, c, 64);
        enc_symbol_adapt(t->enc,
                         t->cdf[CDF_TX_SIZE] + ((size_t)3 * 3 + tctx) * 4, 3,
                         0);
    }

    /* residual: 64x64 chunks, planes interleaved per chunk (spec
     * residual() for blocks wider/taller than 64) */
    for (int ti = 0; ti < 2; ti++)
        for (int tj = 0; tj < 2; tj++) {
            int idx = ti * 2 + tj;
            int px_ = x + tj * 64, py_ = y + ti * 64;
            if (skip)
                set_lvl_ctx(t, 0, px_, py_, 64, 0, 0);
            else
                encode_coeffs_txb(t, 0, 64, px_, py_, lv128[idx], SZ,
                                  DC_PRED);
            for (int plane = 1; plane < nplanes; plane++)
                for (int cy = 0; cy < 2; cy++)
                    for (int cx = 0; cx < 2; cx++) {
                        int qx = px_ + cx * 32, qy = py_ + cy * 32;
                        /* raster index within the plane's 4x4 grid */
                        int ci = ((ti * 2 + cy) * 4) + (tj * 2 + cx);
                        if (skip)
                            set_lvl_ctx(t, plane, qx, qy, 32, 0, 0);
                        else
                            encode_coeffs_txb(t, plane, 32, qx, qy,
                                              uvlv128[plane - 1][ci], SZ,
                                              DC_PRED);
                    }
        }

    /* context updates */
    for (int i = 0; i < 32; i++) {
        t->above_skip[c + i] = skip;
        t->left_skip[lr + i] = skip;
        t->above_mode[c + i] = DC_PRED;
        t->left_mode[lr + i] = DC_PRED;
        t->above_txw[c + i] = 64;
        t->left_txh[lr + i] = 64;
    }
    if (t->screen_tools)
        set_pal_ctx(t, r, c, 32, 32, NULL, 0);
}

static int choose_partition128(Tile *t, int r, int c) {
    /* near-flat gate (mirrors frame.py _choose_partition128): DC-SSD of
     * every plane over the 128 region under the quantization floor */
    int x = c * 4, y = r * 4;
    int64_t flat_gate =
        (int64_t)128 * 128 * t->dq_ac * t->dq_ac / 64;
    int64_t ssd_parent = 0;
    for (int p = 0; p < t->nplanes; p++) {
        /* DC prediction value from source edges (spec DC semantics) */
        const int32_t *src = t->src[p];
        int have_a = y > 0, have_l = x > 0;
        int64_t sum = 0;
        int cnt = 0;
        if (have_a) {
            for (int i = 0; i < 128; i++)
                sum += src[(size_t)(y - 1) * t->pw + x + i];
            cnt += 128;
        }
        if (have_l) {
            for (int i = 0; i < 128; i++)
                sum += src[(size_t)(y + i) * t->pw + x - 1];
            cnt += 128;
        }
        int32_t dc = cnt ? (int32_t)((sum + cnt / 2) / cnt)
                         : (1 << (t->bitdepth - 1));
        int64_t ssd = 0;
        for (int rr = 0; rr < 128; rr++)
            for (int cc = 0; cc < 128; cc++) {
                int64_t d = src[(size_t)(y + rr) * t->pw + x + cc] - dc;
                ssd += d * d;
            }
        if (ssd > flat_gate) return PARTITION_SPLIT;
        if (p == 0) ssd_parent = ssd;
    }
    /* gate (b): the DC parent must not lose much to the four
     * 64-quadrant best-mode predictions (mirrors frame.py) */
    {
        int64_t ssd_kids = 0;
        for (int dy = 0; dy < 128; dy += 64)
            for (int dx = 0; dx < 128; dx += 64)
                ssd_kids += src_mode_ssd_wh(t, x + dx, y + dy, 64, 64);
        int64_t penalty = (int64_t)16 * t->dq_ac * t->dq_ac;
        if (ssd_parent > ssd_kids + penalty) return PARTITION_SPLIT;
    }
    return PARTITION_NONE;
}

/* ---- partitions (mirrors frame.py) ---- */

static const uint8_t PART_CTX_BYTE[129] = {
    [4] = 31, [8] = 30, [16] = 28, [32] = 24, [64] = 16, [128] = 0};

static int partition_ctx(const Tile *t, int r, int c, int size) {
    static const int BSL[129] = {[8] = 0, [16] = 1, [32] = 2, [64] = 3,
                                 [128] = 4};
    int bsl = BSL[size];
    int above = (t->above_part[c] >> bsl) & 1;
    int left = (t->left_part[r & t->lmask] >> bsl) & 1;
    return left * 2 + above;
}

static void update_part_ctx(Tile *t, int r, int c, int size, int sub) {
    int n_mi = size / 4;
    uint8_t byte = PART_CTX_BYTE[sub];
    for (int i = 0; i < n_mi; i++) {
        t->above_part[c + i] = byte;
        t->left_part[(r & t->lmask) + i] = byte;
    }
}

static uint32_t partition_bool_icdf(const uint16_t *cdf, int nsym,
                                    const int *members, int nmem) {
    uint32_t widths[10];
    uint32_t prev = 32768;
    for (int s = 0; s < nsym; s++) {
        widths[s] = prev - cdf[s];
        prev = cdf[s];
    }
    uint32_t psum = 0;
    for (int i = 0; i < nmem; i++)
        if (members[i] < nsym) psum += widths[members[i]];
    return psum;
}

static void encode_partition(Tile *t, int r, int c, int size) {
    if (r >= t->mi_rows || c >= t->mi_cols) return;
    int half_mi = size / 8;
    int has_rows = (r + half_mi) < t->mi_rows;
    int has_cols = (c + half_mi) < t->mi_cols;
    static const int PART_NSYM[129] = {[8] = 4, [16] = 10, [32] = 10,
                                       [64] = 10, [128] = 8};
    int cdf_idx = size == 8 ? CDF_PART_W8
                  : size == 16 ? CDF_PART_W16
                  : size == 32 ? CDF_PART_W32
                  : size == 64 ? CDF_PART_W64 : CDF_PART_W128;
    int nsym = PART_NSYM[size];

    int part;
    if (has_rows && has_cols) {
        if (t->qindex == 0)
            part = PARTITION_SPLIT; /* lossless: descend to 4x4 blocks */
        else if (size == 128) {
            /* sb128 root: NONE only when near-flat AND inside the mi
             * grid (hanging roots split, the 32/64 convention) */
            if (r + 32 <= t->mi_rows && c + 32 <= t->mi_cols) {
                part = dec_part_replay(t, r, c, 128);
                if (part < 0) {
                    part = choose_partition128(t, r, c);
                    dec_part_record(t, r, c, 128, part);
                }
            } else {
                part = PARTITION_SPLIT;
            }
        }
        else if (size == 64 && r + 16 <= t->mi_rows &&
                 c + 16 <= t->mi_cols) {
            part = planned_part64(t, r, c);
            if (part < 0) {
                part = dec_part_replay(t, r, c, 64);
                if (part < 0) {
                    part = choose_partition64(t, r, c);
                    dec_part_record(t, r, c, 64, part);
                }
            }
        }
        else if (size > 32)
            part = PARTITION_SPLIT;
        else if (size == 32 &&
                 (r + 8 > t->mi_rows || c + 8 > t->mi_cols))
            /* hasRows/hasCols allow a NONE block hanging past the mi grid
             * (spec 5.11.4); we always split instead so recon stays inside
             * the mi-grid buffers (encoder choice, still conformant) */
            part = PARTITION_SPLIT;
        else if (size == 32 && t->speed <= 9 && t->qindex <= 90) {
            part = t->enable_rect ? -1 : planned_part32(t, r, c);
            if (part < 0) {
                part = dec_part_replay(t, r, c, 32);
                if (part < 0) {
                    part = choose_partition32(t, r, c);
                    dec_part_record(t, r, c, 32, part);
                }
            }
        }
        else
            part = PARTITION_NONE;
        int ctx = partition_ctx(t, r, c, size);
        enc_symbol_adapt(t->enc,
                         t->cdf[cdf_idx] + (size_t)ctx * (nsym + 1), nsym, part);
    } else if (!has_rows && !has_cols) {
        part = PARTITION_SPLIT; /* implicit */
    } else {
        part = PARTITION_SPLIT; /* size > 8 guaranteed (mi dims even) */
        int ctx = partition_ctx(t, r, c, size);
        uint16_t *cdf = t->cdf[cdf_idx] + (size_t)ctx * (nsym + 1);
        static const int horz_members[6] = {2, 3, 4, 6, 7, 9};
        static const int vert_members[6] = {1, 3, 4, 5, 6, 8};
        uint32_t psum = partition_bool_icdf(
            cdf, nsym, has_cols ? horz_members : vert_members, 6);
        uint16_t derived[3] = {(uint16_t)psum, 0, 0};
        enc_symbol(t->enc, derived, 2, 1);
    }

    if (part == PARTITION_SPLIT) {
        int sub = size / 2;
        if (size == 8) { /* lossless: four 4x4 blocks, no more symbols */
            for (int dr = 0; dr < 2; dr++)
                for (int dc = 0; dc < 2; dc++)
                    if (r + dr < t->mi_rows && c + dc < t->mi_cols) {
                        encode_block_lossless(t, r + dr, c + dc);
                        t->above_part[c + dc] = PART_CTX_BYTE[4];
                        t->left_part[(r + dr) & t->lmask] = PART_CTX_BYTE[4];
                    }
            return;
        }
        encode_partition(t, r, c, sub);
        encode_partition(t, r, c + half_mi, sub);
        encode_partition(t, r + half_mi, c, sub);
        encode_partition(t, r + half_mi, c + half_mi, sub);
    } else if (part == 1) { /* HORZ: two (size x size/2) px blocks */
        encode_block_rect_c(t, r, c, size, size / 2);
        if (r + size / 8 < t->mi_rows)
            encode_block_rect_c(t, r + size / 8, c, size, size / 2);
        update_part_ctx_rect(t, r, c, size, size, size / 2);
    } else if (part == 2) { /* VERT */
        encode_block_rect_c(t, r, c, size / 2, size);
        if (c + size / 8 < t->mi_cols)
            encode_block_rect_c(t, r, c + size / 8, size / 2, size);
        update_part_ctx_rect(t, r, c, size, size / 2, size);
    } else if (size == 128) {
        encode_block_128(t, r, c);
        update_part_ctx(t, r, c, size, size);
    } else {
        encode_block(t, r, c, size);
        update_part_ctx(t, r, c, size, size);
    }
}

/* ---- loop restoration unit syntax (spec 5.11.31-34) ----
 * Mirrors frame.py TileEncoder._emit_lr: per-unit WIENER / SGRPROJ /
 * NONE under the frame's restoration type (incl. SWITCHABLE's 3-ary
 * type symbol), params coded signed-subexp against running refs.
 * Byte-identity with the Python coder is pinned by
 * tests/test_restoration.py. */

static int lr_recenter(int r, int v) {
    /* forward of the spec's inverse_recenter: v >= r codes even */
    if (v > 2 * r) return v;
    if (v >= r) return 2 * (v - r);
    return 2 * (r - v) - 1;
}

static void lr_enc_subexp(Tile *t, int num_syms, int k, int v) {
    int i = 0, mk = 0;
    for (;;) {
        int b2 = i ? k + i - 1 : k;
        int a = 1 << b2;
        if (num_syms <= mk + 3 * a) {
            int n = num_syms - mk, vv = v - mk;
            if (n <= 1) return;
            int w = 32 - __builtin_clz((unsigned)n);
            int m = (1 << w) - n;
            if (vv < m) {
                enc_literal(t->enc, (uint32_t)vv, w - 1);
            } else {
                enc_literal(t->enc, (uint32_t)((vv + m) >> 1), w - 1);
                enc_literal(t->enc, (uint32_t)((vv + m) & 1), 1);
            }
            return;
        }
        if (v >= mk + a) {
            enc_bool(t->enc, 1, 16384);
            i++;
            mk += a;
        } else {
            enc_bool(t->enc, 0, 16384);
            enc_literal(t->enc, (uint32_t)(v - mk), b2);
            return;
        }
    }
}

static void lr_enc_signed_subexp(Tile *t, int low, int high, int k, int ref,
                                 int v) {
    int mx = high - low, r = ref - low, vv = v - low;
    if ((r << 1) <= mx)
        lr_enc_subexp(t, mx, k, lr_recenter(r, vv));
    else
        lr_enc_subexp(t, mx, k, lr_recenter(mx - 1 - r, mx - 1 - vv));
}

static const int LR_TAPS_MIN[3] = {-5, -23, -17};
static const int LR_TAPS_MAX[3] = {10, 8, 46};
static const int LR_TAPS_K[3] = {1, 2, 3};

static void emit_wiener_params(Tile *t, int plane, const int32_t *taps6) {
    int j0 = plane ? 1 : 0; /* chroma: firstCoeff=1, tap0 implicit 0 */
    for (int p2 = 0; p2 < 2; p2++) {
        int *ref = t->lr_ref[plane][p2];
        for (int j = j0; j < 3; j++) {
            int v = taps6[p2 * 3 + j];
            lr_enc_signed_subexp(t, LR_TAPS_MIN[j], LR_TAPS_MAX[j] + 1,
                                 LR_TAPS_K[j], ref[j], v);
            ref[j] = v;
        }
    }
}

/* per-set pass radii gates (av1_sgr_params r0/r1 != 0) */
static const uint8_t SGR_HAS_R0[16] = {1,1,1,1,1,1,1,1,1,1,0,0,0,0,1,1};
static const uint8_t SGR_HAS_R1[16] = {1,1,1,1,1,1,1,1,1,1,1,1,1,1,0,0};

static void emit_sgr_params(Tile *t, int plane, const int32_t *e) {
    /* spec 5.11.34 read_sgrproj_filter: 4-bit set index, radius-gated
     * xqd subexp vs running refs; a radius-0 pass codes nothing and
     * pins the ref (0 for pass 0, 95 for pass 1). */
    int set = e[1], w0 = e[2], w1 = e[3];
    enc_literal(t->enc, (uint32_t)set, 4);
    int *ref = t->lr_sgr_ref[plane];
    if (SGR_HAS_R0[set]) {
        lr_enc_signed_subexp(t, -96, 32, 4, ref[0], w0);
        ref[0] = w0;
    } else {
        ref[0] = 0;
    }
    if (SGR_HAS_R1[set]) {
        lr_enc_signed_subexp(t, -32, 96, 4, ref[1], w1);
        ref[1] = w1;
    } else {
        ref[1] = 95;
    }
}

static void emit_lr_unit(Tile *t, int plane, int ftype, const int32_t *e) {
    int kind = e[0]; /* 0 none, 1 wiener, 2 sgr */
    if (ftype == 1) { /* SWITCHABLE: 3-ary restoration type per unit */
        enc_symbol_adapt(t->enc, t->cdf[CDF_SWITCHABLE], 3, kind);
        if (kind == 1) emit_wiener_params(t, plane, e + 1);
        else if (kind == 2) emit_sgr_params(t, plane, e);
    } else if (ftype == 3) { /* SGRPROJ frame type: use bool */
        enc_symbol_adapt(t->enc, t->cdf[CDF_SGR], 2, kind == 2);
        if (kind == 2) emit_sgr_params(t, plane, e);
    } else { /* WIENER frame type: use bool */
        enc_symbol_adapt(t->enc, t->cdf[CDF_WIENER], 2, kind == 1);
        if (kind == 1) emit_wiener_params(t, plane, e + 1);
    }
}

static void emit_lr(Tile *t, int r, int c) {
    const int32_t *cfg = t->lr_cfg;
    int shift = cfg[3], urows = cfg[4], ucols = cfg[5];
    int unit = 256 >> (2 - shift);
    const int32_t *units = cfg + 6;
    for (int plane = 0; plane < t->nplanes; plane++) {
        if (cfg[plane] == 0) continue;
        int ur0 = (r * 4 + unit - 1) / unit;
        int ur1 = ((r + t->sbn) * 4 + unit - 1) / unit;
        int uc0 = (c * 4 + unit - 1) / unit;
        int uc1 = ((c + t->sbn) * 4 + unit - 1) / unit;
        if (ur1 > urows) ur1 = urows;
        if (uc1 > ucols) uc1 = ucols;
        const int32_t *pg = units + (size_t)plane * urows * ucols * 7;
        for (int ur = ur0; ur < ur1; ur++)
            for (int uc = uc0; uc < uc1; uc++)
                emit_lr_unit(t, plane, cfg[plane],
                             pg + ((size_t)ur * ucols + uc) * 7);
    }
}

/* ---- public entry ---- */

size_t tile_encode(
    const int32_t *const *src_planes, /* per-plane (h, w) int32, row-major */
    int32_t *const *recon_out,        /* per-plane (h, w) int32 out */
    int nplanes, int w, int h, int bitdepth, int speed, int qindex,
    int dq_dc, int dq_ac, int dq_ac_uv,
    uint16_t *const *cdf_ptrs,        /* CDF_N pointers */
    const int32_t *const *scans,      /* 4: scan4,8,16,32 */
    const int32_t *const *sm_weights, /* 5: 4,8,16,32,64 */
    const double *const *fhs, const double *const *fws, /* 8,16,32,64 */
    const int32_t *dr_deriv,
    const int32_t *plan, int plan_nbx, int plan_nby,
    int32_t *blocks_out, int32_t *n_blocks_out, /* optional geometry export */
    int32_t *dec_buf, int32_t *dec_len_io, int dec_mode, /* decision reuse */
    int screen_tools,                 /* palette syntax (frame header) */
    int filter_intra,                 /* seq enable_filter_intra */
    const int32_t *fi_taps,           /* filter-intra taps [5][8][8] */
    const int32_t *lr_cfg,            /* loop restoration units, or NULL */
    int sb128,                        /* seq use_128x128_superblock */
    uint8_t **out_payload)            /* malloc'd; caller frees */
{
    if (prof_enabled < 0) {
        const char *pe = getenv("OAVIF_PROF");
        prof_enabled = pe && pe[0] == '1';
    }
    PROF_SCOPE(PROF_TOTAL);
    double prof_setup_t0 = prof_enabled > 0 ? prof_now() : 0.0;
    Tile t;
    memset(&t, 0, sizeof(t));
    t.w = w; t.h = h;
    t.nplanes = nplanes;
    t.bitdepth = bitdepth;
    t.speed = speed;
    t.qindex = qindex;
    t.dq_dc = dq_dc; t.dq_ac = dq_ac;
    t.dq_ac_uv = dq_ac_uv;
    t.mi_cols = 2 * ((w + 7) >> 3);
    t.mi_rows = 2 * ((h + 7) >> 3);
    t.sb128 = sb128 && qindex != 0; /* lossless stays on the 64 grid */
    t.sbn = t.sb128 ? 32 : 16;
    t.lmask = t.sbn - 1;
    t.sb_cols = (t.mi_cols + t.sbn - 1) / t.sbn;
    t.sb_rows = (t.mi_rows + t.sbn - 1) / t.sbn;
    t.pw = t.mi_cols * 4;
    t.ph = t.mi_rows * 4;
    for (int i = 0; i < CDF_N; i++) t.cdf[i] = cdf_ptrs[i];
    for (int i = 0; i < 6; i++) t.scan[i] = scans[i];
    build_rdoq_costs(&t); /* from the INITIAL CDFs, before any coding */
    for (int i = 0; i < 5; i++) t.smw[i] = sm_weights[i];
    for (int i = 0; i < 11; i++) { t.fh[i] = fhs[i]; t.fw[i] = fws[i]; }
    fwd_init(&t);
    {
        const char *rs = getenv("OAVIF_RECT");
        t.enable_rect = !rs || rs[0] == '1'; /* default on */
        const char *is = getenv("OAVIF_IDTX");
        t.enable_idtx = is && is[0] == '1';
    }
    t.dr_deriv = dr_deriv;
    t.plan64 = NULL; t.mode32 = NULL; t.part32 = NULL; t.mode16 = NULL;
    t.plan_nbx = plan_nbx;
    t.plan_nby = plan_nby;
    if (plan && plan_nbx > 0 && plan_nby > 0) {
        int sby = plan_nby / 2, sbx = plan_nbx / 2;
        t.plan64 = plan;
        t.mode32 = t.plan64 + (size_t)sby * sbx;
        t.part32 = t.mode32 + (size_t)plan_nby * plan_nbx;
        t.mode16 = t.part32 + (size_t)plan_nby * plan_nbx;
    }
    t.blocks_out = blocks_out;
    t.n_blocks = 0;
    t.dec_buf = dec_buf;
    t.dec_pos = 0;
    t.dec_cap = dec_buf && dec_len_io ? *dec_len_io : 0;
    t.dec_mode = dec_buf ? dec_mode : 0;
    t.screen_tools = screen_tools;
    {
        const char *hf_env = getenv("OAVIF_RDOQ_HF");
        t.rdoq_hf = hf_env ? atof(hf_env) : (screen_tools ? 0.0 : 2.0);
        if (t.rdoq_hf < 0.0) t.rdoq_hf = 0.0;
        const char *hfu_env = getenv("OAVIF_RDOQ_HF_UV");
        t.rdoq_hf_uv = hfu_env ? atof(hfu_env) : t.rdoq_hf;
        if (t.rdoq_hf_uv < 0.0) t.rdoq_hf_uv = 0.0;
    }
    build_ws_tables(&t); /* after rdoq_hf/_uv: the weights bake them in */
    t.filter_intra = filter_intra && fi_taps != NULL;
    t.fi_taps = fi_taps;
    t.lr_cfg = lr_cfg;
    for (int p = 0; p < 3; p++) {
        for (int p2 = 0; p2 < 2; p2++) {
            t.lr_ref[p][p2][0] = 3;  /* Wiener_Taps_Mid */
            t.lr_ref[p][p2][1] = -7;
            t.lr_ref[p][p2][2] = 15;
        }
        t.lr_sgr_ref[p][0] = -32; /* C-truncated xqd range midpoints */
        t.lr_sgr_ref[p][1] = 31;
    }

    /* padded src (edge-replicated) + zeroed recon */
    for (int p = 0; p < nplanes; p++) {
        t.src[p] = (int32_t *)malloc((size_t)t.ph * t.pw * 4);
        t.recon[p] = (int32_t *)calloc((size_t)t.ph * t.pw, 4);
        for (int r = 0; r < t.ph; r++) {
            int sr = r < h ? r : h - 1;
            const int32_t *srow = src_planes[p] + (size_t)sr * w;
            int32_t *drow = t.src[p] + (size_t)r * t.pw;
            memcpy(drow, srow, (size_t)w * 4);
            for (int c = w; c < t.pw; c++) drow[c] = srow[w - 1];
        }
    }
    t.above_part = (uint8_t *)calloc(t.mi_cols, 1);
    t.above_skip = (uint8_t *)calloc(t.mi_cols, 1);
    t.above_mode = (uint8_t *)malloc(t.mi_cols);
    memset(t.above_mode, DC_PRED, t.mi_cols);
    t.above_txw = (int32_t *)calloc(t.mi_cols, 4);
    t.above_pal_n = (uint8_t *)calloc(t.mi_cols, 1);
    t.above_pal_c = (uint16_t *)calloc((size_t)t.mi_cols * 8, 2);
    for (int p = 0; p < nplanes; p++) {
        t.above_lvl[p] = (int32_t *)calloc(t.mi_cols, 4);
        t.above_dc[p] = (int32_t *)calloc(t.mi_cols, 4);
    }

    /* mean 16x16 source-luma variance over the visible region (mirrors
     * frame.py: exact integer total, one float division) */
    t.mean_var = 0.0;
    t.cur_lamscale = 1.0;
    {
        int vh = (h / 16) * 16, vw = (w / 16) * 16;
        if (vh >= 16 && vw >= 16 && qindex != 0) {
            int64_t total = 0;
            int nb = 0;
            for (int by = 0; by < vh; by += 16)
                for (int bx = 0; bx < vw; bx += 16, nb++) {
                    int64_t s1 = 0, s2 = 0;
                    for (int rr = 0; rr < 16; rr++)
                        for (int cc = 0; cc < 16; cc++) {
                            int64_t v =
                                t.src[0][(size_t)(by + rr) * t.pw + bx + cc];
                            s1 += v;
                            s2 += v * v;
                        }
                    total += 256 * s2 - s1 * s1;
                }
            t.mean_var = (double)total / (65536.0 * (double)nb);
        }
    }

    if (prof_enabled > 0) {
        prof_acc[PROF_SETUP] += prof_now() - prof_setup_t0;
        prof_cnt[PROF_SETUP]++;
    }
    t.enc = enc_new();
    double prof_code_t0 = prof_enabled > 0 ? prof_now() : 0.0;
    for (int sb_r = 0; sb_r < t.sb_rows; sb_r++) {
        memset(t.left_part, 0, sizeof(t.left_part));
        memset(t.left_skip, 0, sizeof(t.left_skip));
        memset(t.left_mode, DC_PRED, sizeof(t.left_mode));
        memset(t.left_txh, 0, sizeof(t.left_txh));
        memset(t.left_pal_n, 0, sizeof(t.left_pal_n));
        for (int p = 0; p < nplanes; p++) {
            memset(t.left_lvl[p], 0, sizeof(t.left_lvl[p]));
            memset(t.left_dc[p], 0, sizeof(t.left_dc[p]));
        }
        for (int sb_c = 0; sb_c < t.sb_cols; sb_c++) {
            if (t.lr_cfg) emit_lr(&t, sb_r * t.sbn, sb_c * t.sbn);
            encode_partition(&t, sb_r * t.sbn, sb_c * t.sbn, t.sbn * 4);
        }
    }

    if (prof_enabled > 0) {
        prof_acc[PROF_CODE] += prof_now() - prof_code_t0;
        prof_cnt[PROF_CODE]++;
    }
    uint8_t *payload;
    size_t n = enc_done(t.enc, &payload);
    *out_payload = (uint8_t *)malloc(n);
    memcpy(*out_payload, payload, n);
    enc_free(t.enc);

    /* export the FULL padded mi-grid recon: the loop filter operates on
     * the padded plane (edges in the padding write into visible pixels) */
    for (int p = 0; p < nplanes; p++) {
        memcpy(recon_out[p], t.recon[p], (size_t)t.ph * t.pw * 4);
        free(t.src[p]);
        free(t.recon[p]);
        free(t.above_lvl[p]);
        free(t.above_dc[p]);
    }
    free(t.above_part);
    free(t.above_skip);
    free(t.above_mode);
    free(t.above_txw);
    free(t.above_pal_n);
    free(t.above_pal_c);
    if (n_blocks_out) *n_blocks_out = t.n_blocks;
    if (dec_len_io && dec_mode == 1) *dec_len_io = t.dec_pos;
    if (prof_enabled > 0) prof_dump();
    return n;
}

void tile_payload_free(uint8_t *p) { free(p); }

/* ------------------------------------------------------------------ */
/* One-pass YUV444 <-> RGB conversions (BT.601 full-range, float32 —  */
/* mirrors yuv.py's formulas; feeds the metric, not the bitstream).    */
/* ------------------------------------------------------------------ */

void yuv444_to_rgb8_c(const int32_t *const *planes, int npx, int bitdepth,
                      const float *inv /* 3x3 row-major: rgb = yuv @ inv */,
                      uint8_t *rgb_out) {
    float maxv = (float)((1 << bitdepth) - 1);
    float off = (float)(1 << (bitdepth - 1));
    int shift = bitdepth - 8;
    const int32_t *yp = planes[0], *up = planes[1], *vp = planes[2];
    for (int i = 0; i < npx; i++) {
        float y = (float)yp[i];
        float u = (float)up[i] - off;
        float v = (float)vp[i] - off;
        for (int c = 0; c < 3; c++) {
            float s = y * inv[c] + u * inv[3 + c] + v * inv[6 + c];
            s = floorf(s + 0.5f);
            if (s < 0) s = 0;
            if (s > maxv) s = maxv;
            int32_t q = (int32_t)s >> shift;
            rgb_out[(size_t)i * 3 + c] = (uint8_t)q;
        }
    }
}

void rgb_to_yuv444_c(const uint8_t *rgb8, const uint16_t *rgb16, int npx,
                     int bitdepth,
                     const float *fwd /* 3x3 row-major: yuv = rgb @ fwd */,
                     int32_t *const *planes_out) {
    float maxv = (float)((1 << bitdepth) - 1);
    float off = (float)(1 << (bitdepth - 1));
    int32_t *yp = planes_out[0], *up = planes_out[1], *vp = planes_out[2];
    for (int i = 0; i < npx; i++) {
        float r, g, b;
        if (rgb8) {
            r = (float)rgb8[(size_t)i * 3];
            g = (float)rgb8[(size_t)i * 3 + 1];
            b = (float)rgb8[(size_t)i * 3 + 2];
        } else {
            r = (float)rgb16[(size_t)i * 3];
            g = (float)rgb16[(size_t)i * 3 + 1];
            b = (float)rgb16[(size_t)i * 3 + 2];
        }
        float vy = r * fwd[0] + g * fwd[3] + b * fwd[6];
        float vu = r * fwd[1] + g * fwd[4] + b * fwd[7] + off;
        float vv = r * fwd[2] + g * fwd[5] + b * fwd[8] + off;
        vy = floorf(vy + 0.5f);
        vu = floorf(vu + 0.5f);
        vv = floorf(vv + 0.5f);
        yp[i] = (int32_t)(vy < 0 ? 0 : (vy > maxv ? maxv : vy));
        up[i] = (int32_t)(vu < 0 ? 0 : (vu > maxv ? maxv : vu));
        vp[i] = (int32_t)(vv < 0 ? 0 : (vv > maxv ? maxv : vv));
    }
}

/* ------------------------------------------------------------------ */
/* Deblocking loop filter (mirrors oavif_tpu/av1/loopfilter.py; taps   */
/* identified bit-exactly against dav1d). Frame-level, in place.       */
/* ------------------------------------------------------------------ */

typedef struct {
    int64_t limit, blimit, thresh, f1;
    int bd;
} LfParams;

static inline int64_t iabs64(int64_t v) { return v < 0 ? -v : v; }

/* px: 14 pixels across the edge (p6..p0, q0..q6); width: 4/6/8/16 */
static void lf_segment(int64_t *px, int width, const LfParams *lp) {
    int64_t p6=px[0],p5=px[1],p4=px[2],p3=px[3],p2=px[4],p1=px[5],p0=px[6];
    int64_t q0=px[7],q1=px[8],q2=px[9],q3=px[10],q4=px[11],q5=px[12],q6=px[13];
    int64_t limit=lp->limit, blimit=lp->blimit, thresh=lp->thresh, f1=lp->f1;

    int fm = iabs64(p1-p0) <= limit && iabs64(q1-q0) <= limit &&
             iabs64(p0-q0)*2 + iabs64(p1-q1)/2 <= blimit;
    if (width >= 8)
        fm = fm && iabs64(p2-p1) <= limit && iabs64(q2-q1) <= limit &&
             iabs64(p3-p2) <= limit && iabs64(q3-q2) <= limit;
    else if (width >= 6)
        fm = fm && iabs64(p2-p1) <= limit && iabs64(q2-q1) <= limit;
    if (!fm) return;

    int hev = iabs64(p1-p0) > thresh || iabs64(q1-q0) > thresh;
    int flat = iabs64(p1-p0) <= f1 && iabs64(q1-q0) <= f1 &&
               iabs64(p2-p0) <= f1 && iabs64(q2-q0) <= f1 &&
               iabs64(p3-p0) <= f1 && iabs64(q3-q0) <= f1;
    int flat6 = iabs64(p1-p0) <= f1 && iabs64(q1-q0) <= f1 &&
                iabs64(p2-p0) <= f1 && iabs64(q2-q0) <= f1;
    int flat2 = iabs64(p6-p0) <= f1 && iabs64(q6-q0) <= f1 &&
                iabs64(p5-p0) <= f1 && iabs64(q5-q0) <= f1 &&
                iabs64(p4-p0) <= f1 && iabs64(q4-q0) <= f1;

    if (width >= 16 && flat && flat2) {
        px[1] = (p6*7 + p5*2 + p4*2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4;
        px[2] = (p6*5 + p5*2 + p4*2 + p3*2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4;
        px[3] = (p6*4 + p5 + p4*2 + p3*2 + p2*2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4;
        px[4] = (p6*3 + p5 + p4 + p3*2 + p2*2 + p1*2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4;
        px[5] = (p6*2 + p5 + p4 + p3 + p2*2 + p1*2 + p0*2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4;
        px[6] = (p6 + p5 + p4 + p3 + p2 + p1*2 + p0*2 + q0*2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4;
        px[7] = (p5 + p4 + p3 + p2 + p1 + p0*2 + q0*2 + q1*2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4;
        px[8] = (p4 + p3 + p2 + p1 + p0 + q0*2 + q1*2 + q2*2 + q3 + q4 + q5 + q6*2 + 8) >> 4;
        px[9] = (p3 + p2 + p1 + p0 + q0 + q1*2 + q2*2 + q3*2 + q4 + q5 + q6*3 + 8) >> 4;
        px[10] = (p2 + p1 + p0 + q0 + q1 + q2*2 + q3*2 + q4*2 + q5 + q6*4 + 8) >> 4;
        px[11] = (p1 + p0 + q0 + q1 + q2 + q3*2 + q4*2 + q5*2 + q6*5 + 8) >> 4;
        px[12] = (p0 + q0 + q1 + q2 + q3 + q4*2 + q5*2 + q6*7 + 8) >> 4;
        return;
    }
    if (width >= 8 && flat) {
        px[4] = (p3*3 + p2*2 + p1 + p0 + q0 + 4) >> 3;
        px[5] = (p3*2 + p2 + p1*2 + p0 + q0 + q1 + 4) >> 3;
        px[6] = (p3 + p2 + p1 + p0*2 + q0 + q1 + q2 + 4) >> 3;
        px[7] = (p2 + p1 + p0 + q0*2 + q1 + q2 + q3 + 4) >> 3;
        px[8] = (p1 + p0 + q0 + q1*2 + q2 + q3*2 + 4) >> 3;
        px[9] = (p0 + q0 + q1 + q2*2 + q3*3 + 4) >> 3;
        return;
    }
    if (width == 6 && flat6) {
        px[5] = (p2*3 + p1*2 + p0*2 + q0 + 4) >> 3;
        px[6] = (p2 + p1*2 + p0*2 + q0*2 + q1 + 4) >> 3;
        px[7] = (p1 + p0*2 + q0*2 + q1*2 + q2 + 4) >> 3;
        px[8] = (p0 + q0*2 + q1*2 + q2*3 + 4) >> 3;
        return;
    }
    /* filter4 on clamped signed values */
    {
        int bd = lp->bd;
        int64_t half = (int64_t)1 << (bd - 1);
        int64_t smin = -half, smax = half - 1;
#define SCLAMP(v) ((v) < smin ? smin : ((v) > smax ? smax : (v)))
        int64_t ps1 = p1 - half, ps0 = p0 - half;
        int64_t qs0 = q0 - half, qs1 = q1 - half;
        int64_t f = hev ? SCLAMP(ps1 - qs1) : 0;
        int64_t a = SCLAMP(f + 3 * (qs0 - ps0));
        int64_t f1v = SCLAMP(a + 4) >> 3;
        int64_t f2v = SCLAMP(a + 3) >> 3;
        px[7] = SCLAMP(qs0 - f1v) + half;
        px[6] = SCLAMP(ps0 + f2v) + half;
        if (!hev) {
            int64_t f3 = (f1v + 1) >> 1;
            px[8] = SCLAMP(qs1 - f3) + half;
            px[5] = SCLAMP(ps1 + f3) + half;
        }
#undef SCLAMP
    }
}

/* planes: nplanes pointers to (h, w) int32 (padded mi grid); blocks: n*4
 * int32 (r, c, size, skip); levels: 4 ints (y_v, y_h, u, v); vis_h/vis_w:
 * visible frame dims (<=0 means same as h/w). In-place. */
void loop_filter_frame_c(int32_t *const *planes, int nplanes, int w, int h,
                         const int32_t *blocks, int n_blocks,
                         const int32_t *levels, int sharpness, int bitdepth,
                         int vis_h, int vis_w) {
    /* Edge POSITIONS and the along-edge SPAN are bounded by the visible
     * frame in 4px units (an edge at x == FrameWidth is not filtered,
     * and a y-edge does not run through x >= FrameWidth columns, even
     * though the mi grid extends past it — pinned against dav1d).
     * Reads and writes of an eligible segment still reach into the
     * padding. */
    if (vis_h <= 0 || vis_h > h) vis_h = h;
    if (vis_w <= 0 || vis_w > w) vis_w = w;
    /* per-4x4 TX size maps per plane (filter width = min of the tx sizes
     * across the edge). Edges: block left/top boundaries plus internal
     * transform edges (luma: the coded y_tx grid; chroma: the 32px cap
     * inside 64 blocks). All-intra frames filter every tx edge
     * regardless of skip (spec applyFilter's IsInter==0 terms; pinned
     * against dav1d). Mirrors loopfilter.py. */
    int mi_rows = 2 * ((h + 7) >> 3), mi_cols = 2 * ((w + 7) >> 3);
    int32_t *size_map = (int32_t *)calloc((size_t)mi_rows * mi_cols, 4);
    int32_t *size_map_uv = (int32_t *)calloc((size_t)mi_rows * mi_cols, 4);
    uint8_t *start_v = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    uint8_t *start_h = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    uint8_t *start_v_uv = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    uint8_t *start_h_uv = (uint8_t *)calloc((size_t)mi_rows * mi_cols, 1);
    for (int b = 0; b < n_blocks; b++) {
        /* rect blocks pack w | h<<16 in the size/tx fields; the maps
         * store txw | txh<<16 (vertical edges use the width half,
         * horizontal edges the height half). Mirrors loopfilter.py. */
        int r = blocks[b*5], c = blocks[b*5+1];
        int size = blocks[b*5+2];
        int bw = size & 0xFFFF, bh = (size >> 16) ? (size >> 16) : bw;
        int y_tx = blocks[b*5+4];
        int txw = y_tx & 0xFFFF, txh = (y_tx >> 16) ? (y_tx >> 16) : txw;
        int nw = bw / 4, nh = bh / 4;
        int uvw = bw < 32 ? bw : 32, uvh = bh < 32 ? bh : 32;
        int32_t packed_y = txw | (txh << 16);
        int32_t packed_uv = uvw | (uvh << 16);
        for (int i = 0; i < nh; i++)
            for (int j = 0; j < nw; j++) {
                size_map[(size_t)(r+i) * mi_cols + c + j] = packed_y;
                size_map_uv[(size_t)(r+i) * mi_cols + c + j] = packed_uv;
            }
        for (int i = 0; i < nh; i++) {
            start_v[(size_t)(r+i) * mi_cols + c] = 1;
            start_v_uv[(size_t)(r+i) * mi_cols + c] = 1;
        }
        for (int i = 0; i < nw; i++) {
            start_h[(size_t)r * mi_cols + c + i] = 1;
            start_h_uv[(size_t)r * mi_cols + c + i] = 1;
        }
        for (int k = txw / 4; k < nw; k += txw / 4)
            for (int i = 0; i < nh; i++)
                start_v[(size_t)(r+i) * mi_cols + c + k] = 1;
        for (int k = txh / 4; k < nh; k += txh / 4)
            for (int i = 0; i < nw; i++)
                start_h[(size_t)(r+k) * mi_cols + c + i] = 1;
        /* internal chroma tx edges: chroma tx caps at 32px, so blocks
         * wider/taller than 32 have chroma edges every 8 mi (one for 64
         * blocks, three for 128) */
        for (int k = 8; k < nw; k += 8)
            for (int i = 0; i < nh; i++)
                start_v_uv[(size_t)(r+i) * mi_cols + c + k] = 1;
        for (int k = 8; k < nh; k += 8)
            for (int i = 0; i < nw; i++)
                start_h_uv[(size_t)(r+k) * mi_cols + c + i] = 1;
    }

    for (int pi = 0; pi < nplanes; pi++) {
        int32_t *pl = planes[pi];
        int lvl_v = pi == 0 ? levels[0] : levels[1 + pi];
        int lvl_h = pi == 0 ? levels[1] : levels[1 + pi];
        int max_w = pi == 0 ? 16 : 8;
        int64_t px[14];

        for (int pass = 0; pass < 2; pass++) {
            int lvl = pass == 0 ? lvl_v : lvl_h;
            if (lvl <= 0) continue;
            LfParams lp;
            int sh = bitdepth - 8;
            int64_t limit;
            if (sharpness > 0) {
                int shift2 = sharpness > 4 ? 2 : 1;
                limit = lvl >> shift2;
                if (limit < 1) limit = 1;
                if (limit > 9 - sharpness) limit = 9 - sharpness;
            } else {
                limit = lvl > 1 ? lvl : 1;
            }
            lp.limit = limit << sh;
            lp.blimit = (int64_t)(2 * (lvl + 2) + limit) << sh;
            lp.thresh = (int64_t)(lvl >> 4) << sh;
            lp.f1 = (int64_t)1 << sh;
            lp.bd = bitdepth;

            const uint8_t *edge_v = pi == 0 ? start_v : start_v_uv;
            const uint8_t *edge_h = pi == 0 ? start_h : start_h_uv;
            const int32_t *smap = pi == 0 ? size_map : size_map_uv;
            if (pass == 0) { /* vertical edges */
                for (int c = 1; c < mi_cols; c++) {
                    int x = c * 4;
                    if (x >= vis_w) break;
                    for (int r = 0; r < mi_rows; r++) {
                        if (!edge_v[(size_t)r * mi_cols + c]) continue;
                        if (r * 4 >= vis_h) continue;
                        int sz_r = smap[(size_t)r * mi_cols + c] & 0xFFFF;
                        int sz_l = smap[(size_t)r * mi_cols + c - 1] & 0xFFFF;
                        int wd = sz_r < sz_l ? sz_r : sz_l;
                        if (wd > max_w) wd = max_w;
                        if (pi != 0 && wd >= 8) wd = 6;
                        int ymax = r * 4 + 4 < h ? r * 4 + 4 : h;
                        for (int y = r * 4; y < ymax; y++) {
                            for (int k = 0; k < 14; k++) {
                                int xx = x - 7 + k;
                                if (xx < 0) xx = 0;
                                if (xx > w - 1) xx = w - 1;
                                px[k] = pl[(size_t)y * w + xx];
                            }
                            lf_segment(px, wd, &lp);
                            int lo = x - 6 > 0 ? x - 6 : 0;
                            int hi2 = x + 6 < w ? x + 6 : w;
                            for (int xx = lo; xx < hi2; xx++)
                                pl[(size_t)y * w + xx] =
                                    (int32_t)px[xx - x + 7];
                        }
                    }
                }
            } else { /* horizontal edges */
                for (int r = 1; r < mi_rows; r++) {
                    int y = r * 4;
                    if (y >= vis_h) break;
                    for (int c = 0; c < mi_cols; c++) {
                        if (!edge_h[(size_t)r * mi_cols + c]) continue;
                        if (c * 4 >= vis_w) continue;
                        int sz_b = smap[(size_t)r * mi_cols + c] >> 16;
                        int sz_t = smap[(size_t)(r - 1) * mi_cols + c] >> 16;
                        int wd = sz_b < sz_t ? sz_b : sz_t;
                        if (wd > max_w) wd = max_w;
                        if (pi != 0 && wd >= 8) wd = 6;
                        int xmax = c * 4 + 4 < w ? c * 4 + 4 : w;
                        for (int x = c * 4; x < xmax; x++) {
                            for (int k = 0; k < 14; k++) {
                                int yy = y - 7 + k;
                                if (yy < 0) yy = 0;
                                if (yy > h - 1) yy = h - 1;
                                px[k] = pl[(size_t)yy * w + x];
                            }
                            lf_segment(px, wd, &lp);
                            int lo = y - 6 > 0 ? y - 6 : 0;
                            int hi2 = y + 6 < h ? y + 6 : h;
                            for (int yy = lo; yy < hi2; yy++)
                                pl[(size_t)yy * w + x] =
                                    (int32_t)px[yy - y + 7];
                        }
                    }
                }
            }
        }
    }
    free(size_map);
    free(size_map_uv);
    free(start_v);
    free(start_h);
    free(start_v_uv);
    free(start_h_uv);
}

/* ------------------------------------------------------------------ */
/* Normative CDEF (mirrors cdef.py; conformance-pinned against dav1d) */
/* ------------------------------------------------------------------ */

static const int CDEF_DIRS[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},
};
static const int CDEF_PRI_TAPS_C[2][2] = {{4, 2}, {3, 3}};
static const int CDEF_SEC_TAPS_C[2] = {2, 1};
static const int CDEF_DIV[7] = {840, 420, 280, 210, 168, 140, 120};

static void cdef_find_dir_c(const int32_t *p, int stride, int bitdepth,
                            int *out_dir, int *out_var) {
    int64_t pd[2][15] = {{0}}, pa[4][11] = {{0}}, ph[2][8] = {{0}};
    int sh = bitdepth - 8;
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
            int64_t v = (p[(size_t)y * stride + x] >> sh) - 128;
            pd[0][y + x] += v;
            pa[0][y + (x >> 1)] += v;
            ph[0][y] += v;
            pa[1][3 + y - (x >> 1)] += v;
            pd[1][7 + y - x] += v;
            pa[2][3 - (y >> 1) + x] += v;
            ph[1][x] += v;
            pa[3][(y >> 1) + x] += v;
        }
    int64_t cost[8] = {0};
    for (int n = 0; n < 8; n++) {
        cost[2] += ph[0][n] * ph[0][n];
        cost[6] += ph[1][n] * ph[1][n];
    }
    cost[2] *= 105;
    cost[6] *= 105;
    for (int n = 0; n < 7; n++) {
        cost[0] += (pd[0][n] * pd[0][n] + pd[0][14 - n] * pd[0][14 - n]) *
                   CDEF_DIV[n];
        cost[4] += (pd[1][n] * pd[1][n] + pd[1][14 - n] * pd[1][14 - n]) *
                   CDEF_DIV[n];
    }
    cost[0] += pd[0][7] * pd[0][7] * 105;
    cost[4] += pd[1][7] * pd[1][7] * 105;
    for (int i = 0; i < 4; i++) {
        int64_t c2 = 0;
        for (int m = 0; m < 5; m++) c2 += pa[i][3 + m] * pa[i][3 + m];
        c2 *= 105;
        for (int m = 0; m < 3; m++)
            c2 += (pa[i][m] * pa[i][m] + pa[i][10 - m] * pa[i][10 - m]) *
                  CDEF_DIV[2 * m + 1];
        cost[2 * i + 1] = c2;
    }
    int best = 0;
    for (int d = 1; d < 8; d++)
        if (cost[d] > cost[best]) best = d;
    *out_dir = best;
    *out_var = (int)((cost[best] - cost[best ^ 4]) >> 10);
}

static inline int cdef_constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int shift = damping - (31 - __builtin_clz((unsigned)threshold));
    if (shift < 0) shift = 0;
    int mag = diff < 0 ? -diff : diff;
    int t = threshold - (mag >> shift);
    if (t < 0) t = 0;
    int v = mag < t ? mag : t;
    return diff < 0 ? -v : v;
}

static void cdef_filter_block_c(const int32_t *restrict src,
                                int32_t *restrict dst, int h,
                                int w, int y0, int x0, int pri, int sec,
                                int damping, int dir, int coeff_shift) {
    const int *pt = CDEF_PRI_TAPS_C[(pri >> coeff_shift) & 1];
    if (damping < 1) damping = 1;
    if (y0 >= 2 && x0 >= 2 && y0 + 10 <= h && x0 + 10 <= w) {
        /* interior fast path: all 12 tap offsets in-bounds; fully
         * unrolled with the constrain shift hoisted (it depends only on
         * the strength, not the tap) */
        int po0 = CDEF_DIRS[dir][0][0] * w + CDEF_DIRS[dir][0][1];
        int po1 = CDEF_DIRS[dir][1][0] * w + CDEF_DIRS[dir][1][1];
        int d2 = (dir + 2) & 7, d6 = (dir + 6) & 7;
        int so0 = CDEF_DIRS[d2][0][0] * w + CDEF_DIRS[d2][0][1];
        int so1 = CDEF_DIRS[d2][1][0] * w + CDEF_DIRS[d2][1][1];
        int so2 = CDEF_DIRS[d6][0][0] * w + CDEF_DIRS[d6][0][1];
        int so3 = CDEF_DIRS[d6][1][0] * w + CDEF_DIRS[d6][1][1];
        int psh = 0, ssh = 0;
        if (pri) {
            psh = damping - (31 - __builtin_clz((unsigned)pri));
            if (psh < 0) psh = 0;
        }
        if (sec) {
            ssh = damping - (31 - __builtin_clz((unsigned)sec));
            if (ssh < 0) ssh = 0;
        }
        int pt0 = pri ? pt[0] : 0, pt1 = pri ? pt[1] : 0;
        /* hand-vectorized row form (GNU vector extensions): one 8-wide
         * int32 vector per row, ~14 vector ops per tap; the auto
         * vectorizer refuses this shape (alias-check explosion on the
         * 12 runtime tap offsets) */
        typedef int32_t v8si __attribute__((vector_size(32), aligned(4)));
#define VLOAD(ptr) (*(const v8si *)(const void *)(ptr))
#define TAPROW(off, tapw, thr, sh)                                         \
        do {                                                               \
            v8si p_ = VLOAD(sp + (off));                                   \
            v8si d_ = p_ - pxv;                                            \
            v8si msk_ = d_ >> 31;                                          \
            v8si m_ = (d_ ^ msk_) - msk_;                                  \
            v8si t_ = thrv_##thr - (m_ >> (sh));                           \
            t_ &= ~(t_ >> 31);                                             \
            v8si sel_ = m_ < t_;                                           \
            t_ = (m_ & sel_) | (t_ & ~sel_);                               \
            sv += (tapw) * ((t_ ^ msk_) - msk_);                           \
            sel_ = p_ > mxv;                                               \
            mxv = (p_ & sel_) | (mxv & ~sel_);                             \
            sel_ = p_ < mnv;                                               \
            mnv = (p_ & sel_) | (mnv & ~sel_);                             \
        } while (0)
        v8si thrv_pri = {pri, pri, pri, pri, pri, pri, pri, pri};
        v8si thrv_sec = {sec, sec, sec, sec, sec, sec, sec, sec};
        for (int yy = 0; yy < 8; yy++) {
            const int32_t *sp = src + (size_t)(y0 + yy) * w + x0;
            int32_t *dp = dst + (size_t)(y0 + yy) * w + x0;
            v8si pxv = VLOAD(sp);
            v8si sv = {0, 0, 0, 0, 0, 0, 0, 0};
            v8si mxv = pxv, mnv = pxv;
            if (pri) {
                TAPROW(po0, pt0, pri, psh);
                TAPROW(-po0, pt0, pri, psh);
                TAPROW(po1, pt1, pri, psh);
                TAPROW(-po1, pt1, pri, psh);
            }
            if (sec) {
                TAPROW(so0, 2, sec, ssh);
                TAPROW(-so0, 2, sec, ssh);
                TAPROW(so2, 2, sec, ssh);
                TAPROW(-so2, 2, sec, ssh);
                TAPROW(so1, 1, sec, ssh);
                TAPROW(-so1, 1, sec, ssh);
                TAPROW(so3, 1, sec, ssh);
                TAPROW(-so3, 1, sec, ssh);
            }
            v8si neg = sv >> 31;
            v8si v = pxv + ((sv + 8 + neg) >> 4);
            v8si sel = v < mnv;
            v = (mnv & sel) | (v & ~sel);
            sel = v > mxv;
            v = (mxv & sel) | (v & ~sel);
            for (int xx = 0; xx < 8; xx++) dp[xx] = v[xx];
        }
#undef TAPROW
#undef VLOAD
        return;
    }
    for (int yy = 0; yy < 8; yy++)
        for (int xx = 0; xx < 8; xx++) {
            int y = y0 + yy, x = x0 + xx;
            int px = src[(size_t)y * w + x];
            int s = 0, mx = px, mn = px;
            for (int k = 0; k < 2; k++) {
                if (pri) {
                    int dy = CDEF_DIRS[dir][k][0], dx = CDEF_DIRS[dir][k][1];
                    for (int sgn = 0; sgn < 2; sgn++) {
                        int py = sgn ? y - dy : y + dy;
                        int pxx = sgn ? x - dx : x + dx;
                        if (py >= 0 && py < h && pxx >= 0 && pxx < w) {
                            int p = src[(size_t)py * w + pxx];
                            s += pt[k] * cdef_constrain(p - px, pri, damping);
                            if (p > mx) mx = p;
                            if (p < mn) mn = p;
                        }
                    }
                }
                if (sec) {
                    for (int di = 0; di < 2; di++) {
                        int dd = di ? (dir + 6) & 7 : (dir + 2) & 7;
                        int dy = CDEF_DIRS[dd][k][0], dx = CDEF_DIRS[dd][k][1];
                        for (int sgn = 0; sgn < 2; sgn++) {
                            int py = sgn ? y - dy : y + dy;
                            int pxx = sgn ? x - dx : x + dx;
                            if (py >= 0 && py < h && pxx >= 0 && pxx < w) {
                                int p = src[(size_t)py * w + pxx];
                                s += CDEF_SEC_TAPS_C[k] *
                                     cdef_constrain(p - px, sec, damping);
                                if (p > mx) mx = p;
                                if (p < mn) mn = p;
                            }
                        }
                    }
                }
            }
            int v = px + ((8 + s - (s < 0)) >> 4);
            if (v < mn) v = mn;
            if (v > mx) v = mx;
            dst[(size_t)y * w + x] = v;
        }
}

/* planes: padded mi-grid (h, w) int32; blocks n*4 (r, c, size, skip);
 * strengths: y_pri, y_sec, uv_pri, uv_sec (coded values, sec 4 allowed);
 * in-place. */
void cdef_frame_c(int32_t *const *planes, int nplanes, int w, int h,
                  const int32_t *blocks, int n_blocks,
                  const int32_t *strengths, int damping, int bitdepth) {
    int y_pri = strengths[0], y_sec = strengths[1];
    int uv_pri = strengths[2], uv_sec = strengths[3];
    if (!(y_pri | y_sec | uv_pri | uv_sec)) return;
    int mi_rows = h / 4, mi_cols = w / 4;
    uint8_t *skip_map = (uint8_t *)malloc((size_t)mi_rows * mi_cols);
    memset(skip_map, 1, (size_t)mi_rows * mi_cols);
    for (int b = 0; b < n_blocks; b++) {
        int r = blocks[b * 5], c = blocks[b * 5 + 1];
        int size = blocks[b * 5 + 2], sk = blocks[b * 5 + 3];
        int bw = size & 0xFFFF, bh = (size >> 16) ? (size >> 16) : bw;
        int nw = bw / 4, nh = bh / 4;
        for (int i = 0; i < nh && r + i < mi_rows; i++)
            memset(skip_map + (size_t)(r + i) * mi_cols + c, sk,
                   (size_t)(c + nw <= mi_cols ? nw : mi_cols - c));
    }
    int cs = bitdepth - 8;
    int yp = y_pri << cs, ys = y_sec << cs;
    int up = uv_pri << cs, us = uv_sec << cs;
    int y_damp = damping + cs, uv_damp = y_damp - 1;
    int32_t *srcs[3];
    for (int p = 0; p < nplanes; p++) {
        srcs[p] = (int32_t *)malloc((size_t)h * w * 4);
        memcpy(srcs[p], planes[p], (size_t)h * w * 4);
    }
    for (int ur = 0; ur < mi_rows; ur += 16)
        for (int uc = 0; uc < mi_cols; uc += 16) {
            int any = 0;
            int re = ur + 16 < mi_rows ? ur + 16 : mi_rows;
            int ce = uc + 16 < mi_cols ? uc + 16 : mi_cols;
            for (int r = ur; r < re && !any; r++)
                for (int c = uc; c < ce; c++)
                    if (!skip_map[(size_t)r * mi_cols + c]) { any = 1; break; }
            if (!any) continue; /* all-skip unit: no cdef_idx, no filter */
            for (int r = ur; r + 2 <= re; r += 2)
                for (int c = uc; c + 2 <= ce; c += 2) {
                    int allskip = 1;
                    for (int i = 0; i < 2 && allskip; i++)
                        for (int j = 0; j < 2; j++)
                            if (r + i < mi_rows && c + j < mi_cols &&
                                !skip_map[(size_t)(r + i) * mi_cols + c + j]) {
                                allskip = 0;
                                break;
                            }
                    if (allskip) continue;
                    int y0 = r * 4, x0 = c * 4;
                    int dir = 0, var = 0;
                    if (yp || up)
                        cdef_find_dir_c(srcs[0] + (size_t)y0 * w + x0, w,
                                        bitdepth, &dir, &var);
                    int dir_y = yp ? dir : 0, dir_uv = up ? dir : 0;
                    int pri_y = 0;
                    if (yp) {
                        if (var) {
                            int v6 = var >> 6;
                            int i2 = v6 ? (31 - __builtin_clz((unsigned)v6))
                                        : 0;
                            if (i2 > 12) i2 = 12;
                            pri_y = (yp * (4 + i2) + 8) >> 4;
                        }
                    }
                    if (pri_y || ys)
                        cdef_filter_block_c(srcs[0], planes[0], h, w, y0, x0,
                                            pri_y, ys, y_damp, dir_y, cs);
                    if (nplanes > 1 && (up || us))
                        for (int p = 1; p < 3; p++)
                            cdef_filter_block_c(srcs[p], planes[p], h, w, y0,
                                                x0, up, us, uv_damp, dir_uv,
                                                cs);
                }
        }
    for (int p = 0; p < nplanes; p++) free(srcs[p]);
    free(skip_map);
}

/* Encoder-side CDEF strength search (our analogue of libaom's
 * av1_cdef_search, SURVEY.md §2b N1): evaluate candidate strength sets on
 * a subsample of non-skip 8x8 blocks, scoring SSE of the filtered recon
 * against the SOURCE over visible pixels. The direction search per block
 * is shared across candidates; filtering runs through the vectorized
 * block filter. Returns the argmin candidate index (candidate 0 must be
 * all-zero = "CDEF off"); a win must beat "off" by >= sse/256. */
int cdef_search_c(int32_t *const *src_planes, int32_t *const *recon_planes,
                  int nplanes, int w, int h, int vis_w, int vis_h,
                  const int32_t *blocks, int n_blocks,
                  const int32_t *cands, int n_cands, /* n*4 strength sets */
                  int damping, int bitdepth, int sample_log2) {
    int mi_rows = h / 4, mi_cols = w / 4;
    uint8_t *skip_map = (uint8_t *)malloc((size_t)mi_rows * mi_cols);
    memset(skip_map, 1, (size_t)mi_rows * mi_cols);
    for (int b = 0; b < n_blocks; b++) {
        int r = blocks[b * 5], c = blocks[b * 5 + 1];
        int size = blocks[b * 5 + 2], sk = blocks[b * 5 + 3];
        int bw = size & 0xFFFF, bh = (size >> 16) ? (size >> 16) : bw;
        int nw = bw / 4, nh = bh / 4;
        for (int i = 0; i < nh && r + i < mi_rows; i++)
            memset(skip_map + (size_t)(r + i) * mi_cols + c, sk,
                   (size_t)(c + nw <= mi_cols ? nw : mi_cols - c));
    }
    int cs = bitdepth - 8;
    int step = 2 << sample_log2; /* mi step between sampled 8x8 blocks */
    int64_t *sse = (int64_t *)calloc((size_t)n_cands, 8);
    int32_t *scratch = (int32_t *)malloc((size_t)h * w * 4);
    for (int r = 0; r + 2 <= mi_rows; r += step)
        for (int c = 0; c + 2 <= mi_cols; c += step) {
            if (skip_map[(size_t)r * mi_cols + c] &&
                skip_map[(size_t)r * mi_cols + c + 1] &&
                skip_map[(size_t)(r + 1) * mi_cols + c] &&
                skip_map[(size_t)(r + 1) * mi_cols + c + 1])
                continue;
            int y0 = r * 4, x0 = c * 4;
            int ylim = vis_h - y0 < 8 ? vis_h - y0 : 8;
            int xlim = vis_w - x0 < 8 ? vis_w - x0 : 8;
            if (ylim <= 0 || xlim <= 0) continue;
            int dir = 0, var = 0;
            cdef_find_dir_c(recon_planes[0] + (size_t)y0 * w + x0, w,
                            bitdepth, &dir, &var);
            for (int ci = 0; ci < n_cands; ci++) {
                int yp = cands[ci * 4] << cs, ys = cands[ci * 4 + 1] << cs;
                int up = cands[ci * 4 + 2] << cs, us = cands[ci * 4 + 3] << cs;
                for (int p = 0; p < nplanes; p++) {
                    int pri, sec, damp, d2;
                    if (p == 0) {
                        pri = 0;
                        if (yp && var) {
                            int v6 = var >> 6;
                            int i2 = v6 ? (31 - __builtin_clz((unsigned)v6))
                                        : 0;
                            if (i2 > 12) i2 = 12;
                            pri = (yp * (4 + i2) + 8) >> 4;
                        }
                        sec = ys;
                        damp = damping + cs;
                        d2 = yp ? dir : 0;
                    } else {
                        pri = up;
                        sec = us;
                        damp = damping + cs - 1;
                        d2 = up ? dir : 0;
                    }
                    const int32_t *rp = recon_planes[p];
                    const int32_t *sp = src_planes[p];
                    const int32_t *outp = rp;
                    if (pri || sec) {
                        cdef_filter_block_c(rp, scratch, h, w, y0, x0, pri,
                                            sec, damp, d2, cs);
                        outp = scratch;
                    }
                    int64_t acc = 0;
                    for (int yy = 0; yy < ylim; yy++)
                        for (int xx = 0; xx < xlim; xx++) {
                            int64_t e =
                                (int64_t)outp[(size_t)(y0 + yy) * w + x0 +
                                              xx] -
                                sp[(size_t)(y0 + yy) * w + x0 + xx];
                            acc += e * e;
                        }
                    sse[ci] += acc;
                }
            }
        }
    int best = 0;
    for (int ci = 1; ci < n_cands; ci++)
        if (sse[ci] < sse[best]) best = ci;
    /* require a material SSE win over "off" (>= ~0.4%): marginal picks
     * cost a full-frame filter pass for perceptually invisible change */
    if (best != 0 && sse[best] + (sse[0] >> 8) >= sse[0]) best = 0;
    free(scratch);
    free(sse);
    free(skip_map);
    return best;
}
