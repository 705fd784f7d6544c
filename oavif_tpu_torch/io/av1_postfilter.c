/* AV1 post-filters for the port's AVIF reader (oavif_tpu_torch/io/avif.py),
 * on the planes and side information av1_decode.c returns, for 4:4:4,
 * 4:2:2, 4:2:0 and monochrome frames at 8, 10 and 12 bits:
 *
 * - deblocking (spec 7.14) on each plane's own transform grid: luma up to
 *   16 taps, chroma up to 6, each block at the frame's level moved by its
 *   DeltaLF (its own per plane and direction under delta_lf_multi), its
 *   segment's ALT_LF and its reference frame's delta (and an inter
 *   block's mode delta); the transform edges inside a skipped inter block
 *   are left alone;
 * - CDEF (spec 7.15) per 8x8 luma block with the strength set of its
 *   64x64 (cdef_idx; -1 leaves the 64x64 alone), the chroma blocks
 *   4x4 (4:2:0), 4x8 (4:2:2) or 8x8 filtered in the luma direction
 *   (Cdef_Uv_Dir for 4:2:2), with the UV damping;
 * - superres upscaling (spec 7.16) of a frame coded narrower than it is
 *   shown: each plane's rows by the 8-tap Upscale_Filter, the CDEF output
 *   and, for loop restoration, the deblocked frame;
 * - loop restoration (spec 7.17): Wiener and self-guided units on each
 *   plane's own unit grid (the chroma unit lr_uv_shift smaller) over the
 *   upscaled width, in stripes of 64 luma rows offset by 8, the rows past
 *   a stripe read from the deblocked frame.
 *
 * The arithmetic is that of the encoder's post-filters (av1/entropy/
 * oav1tile.c loop_filter_frame_c and cdef_frame_c, av1/restoration.py),
 * which are held to dav1d on 4:4:4; here the geometry is each plane's.
 *
 * Built into the host library beside the tile decoder (av1/entropy/fast.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "av1_header.h"

static inline int pmin(int a, int b) { return a < b ? a : b; }
static inline int pmax(int a, int b) { return a > b ? a : b; }
static inline int64_t pabs64(int64_t v) { return v < 0 ? -v : v; }

/* ---- deblocking ------------------------------------------------------------ */

typedef struct {
    int64_t limit, blimit, thresh, f1;
    int bd;
} Lf;

/* px: 14 samples across the edge (p6..p0, q0..q6); width 4/6/8/16 */
static void lf_taps(int64_t *px, int width, const Lf *lp) {
    int64_t p6=px[0],p5=px[1],p4=px[2],p3=px[3],p2=px[4],p1=px[5],p0=px[6];
    int64_t q0=px[7],q1=px[8],q2=px[9],q3=px[10],q4=px[11],q5=px[12],q6=px[13];
    int64_t limit=lp->limit, blimit=lp->blimit, thresh=lp->thresh, f1=lp->f1;
    int fm = pabs64(p1-p0) <= limit && pabs64(q1-q0) <= limit &&
             pabs64(p0-q0)*2 + pabs64(p1-q1)/2 <= blimit;
    if (width >= 8)
        fm = fm && pabs64(p2-p1) <= limit && pabs64(q2-q1) <= limit &&
             pabs64(p3-p2) <= limit && pabs64(q3-q2) <= limit;
    else if (width >= 6)
        fm = fm && pabs64(p2-p1) <= limit && pabs64(q2-q1) <= limit;
    if (!fm) return;
    int hev = pabs64(p1-p0) > thresh || pabs64(q1-q0) > thresh;
    int flat = pabs64(p1-p0) <= f1 && pabs64(q1-q0) <= f1 &&
               pabs64(p2-p0) <= f1 && pabs64(q2-q0) <= f1 &&
               pabs64(p3-p0) <= f1 && pabs64(q3-q0) <= f1;
    int flat6 = pabs64(p1-p0) <= f1 && pabs64(q1-q0) <= f1 &&
                pabs64(p2-p0) <= f1 && pabs64(q2-q0) <= f1;
    int flat2 = pabs64(p6-p0) <= f1 && pabs64(q6-q0) <= f1 &&
                pabs64(p5-p0) <= f1 && pabs64(q5-q0) <= f1 &&
                pabs64(p4-p0) <= f1 && pabs64(q4-q0) <= f1;
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
    int64_t half = (int64_t)1 << (lp->bd - 1);
    int64_t smin = -half, smax = half - 1;
#define SCLAMP(v) ((v) < smin ? smin : ((v) > smax ? smax : (v)))
    int64_t ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
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

static void lf_params(Lf *lp, int lvl, int sharpness, int bd) {
    int sh = bd - 8;
    int64_t limit;
    if (sharpness > 0) {
        limit = lvl >> (sharpness > 4 ? 2 : 1);
        if (limit < 1) limit = 1;
        if (limit > 9 - sharpness) limit = 9 - sharpness;
    } else {
        limit = lvl > 1 ? lvl : 1;
    }
    lp->limit = limit << sh;
    lp->blimit = (int64_t)(2 * (lvl + 2) + limit) << sh;
    lp->thresh = (int64_t)(lvl >> 4) << sh;
    lp->f1 = (int64_t)1 << sh;
    lp->bd = bd;
}

/* the filter level of a block for plane and direction i (y vertical, y
 * horizontal, u, v; spec 7.14.4): the frame level moved by the block's
 * DeltaLF, then by its segment's SEG_LVL_ALT_LF_Y_V + i, then by the
 * delta of its reference frame and, for an inter block, of its mode
 * (``lf``: RefFrame * 2 + the mode delta's index), each step clamped to
 * 0..63 */
static int block_level(const int32_t *hdr, int i, int seg, int dl, int lf) {
    int base = hdr[H_LF_Y0 + i];
    int lvl = hdr[H_DELTA_LF_RES] >= 0 ? pmin(pmax(base + dl, 0), 63) : base;
    if (hdr[H_SEG_ENABLED] && ((uint32_t)hdr[H_SEG_ALT_LF_MASK] >> (4 * seg + i) & 1))
        lvl = pmin(pmax(lvl + (int8_t)((uint32_t)hdr[H_SEG_ALT_LF0 + seg] >> (8 * i)), 0), 63);
    if (hdr[H_LF_DELTA_ENABLED]) {
        int ref = (lf & 15) >> 1, sh = lvl >> 5;
        lvl += (ref ? hdr[H_LF_REF_DELTA1 + ref - 1] : hdr[H_LF_REF_DELTA_INTRA]) * (1 << sh);
        if (ref) lvl += hdr[H_LF_MODE_DELTA0 + (lf & 1)] * (1 << sh);
        lvl = pmin(pmax(lvl, 0), 63);
    }
    return lvl;
}

static void deblock_plane(int32_t *pl, int stride, int plane, int sx, int sy,
                          const uint8_t *txmap, const int8_t *delta_lf,
                          const uint8_t *segs, const uint8_t *mi_lf, const uint8_t *mi_bsz,
                          int mi_rows, int mi_cols, int frame_w, int frame_h,
                          const int32_t *hdr) {
    int pw4 = mi_cols >> sx, ph4 = mi_rows >> sy;
    int pw = pw4 * 4, ph = ph4 * 4;
    int bd = hdr[H_BITDEPTH];
    int64_t px[14];
    Lf lps[64];
    int have_lp[64];
    memset(have_lp, 0, sizeof(have_lp));
    for (int pass = 0; pass < 2; pass++) {
        /* the 4x4's segment and DeltaLF: those of the mi at the bottom
         * right of its luma area (libaom's odd mi for subsampled chroma) */
        int i = plane == 0 ? pass : plane + 1;
        const int8_t *dlf = delta_lf + (hdr[H_DELTA_LF_MULTI] ? i : 0);
        for (int cy = 0; cy < ph4; cy++) {
            if (((cy * 4) << sy) >= frame_h) break;
            for (int cx = 0; cx < pw4; cx++) {
                if (((cx * 4) << sx) >= frame_w) break;
                if (pass == 0 ? cx == 0 : cy == 0) continue;
                int t = txmap[(size_t)cy * mi_cols + cx];
                int prev = pass == 0 ? txmap[(size_t)cy * mi_cols + cx - 1]
                                     : txmap[(size_t)(cy - 1) * mi_cols + cx];
                int tl = pass == 0 ? (t & 15) : (t >> 4);
                int pl2 = pass == 0 ? (prev & 15) : (prev >> 4);
                int pos = pass == 0 ? cx : cy;
                if (pos % (1 << tl)) continue; /* not a transform edge */
                int my = (cy << sy) | sy, mx = (cx << sx) | sx;
                size_t m = (size_t)my * mi_cols + mx;
                if (mi_lf[m] & 16) {
                    /* inside a skipped inter block only its own edges */
                    int bl = pass == 0 ? (mi_bsz[m] & 15) - sx : (mi_bsz[m] >> 4) - sy;
                    if (pos % (1 << pmax(bl, 0))) continue;
                }
                int size = 4 << pmin(tl, pl2);
                size = plane == 0 ? pmin(16, size) : pmin(8, size);
                if (plane && size == 8) size = 6;
                /* the block's level, or where it is 0 the previous one's */
                int lvl = block_level(hdr, i, segs[m], dlf[4 * m], mi_lf[m]);
                if (!lvl) {
                    int py = pass ? ((cy - 1) << sy) | sy : my;
                    int pxm = pass ? mx : ((cx - 1) << sx) | sx;
                    size_t q = (size_t)py * mi_cols + pxm;
                    lvl = block_level(hdr, i, segs[q], dlf[4 * q], mi_lf[q]);
                }
                if (!lvl) continue;
                if (!have_lp[lvl]) {
                    lf_params(&lps[lvl], lvl, hdr[H_LF_SHARPNESS], bd);
                    have_lp[lvl] = 1;
                }
                const Lf *lp = &lps[lvl];
                for (int k = 0; k < 4; k++) {
                    if (pass == 0) {
                        int y = cy * 4 + k, x = cx * 4;
                        int32_t *row = pl + (size_t)y * stride;
                        for (int t = 0; t < 14; t++) px[t] = row[pmin(pmax(x - 7 + t, 0), pw - 1)];
                        lf_taps(px, size, lp);
                        for (int xx = pmax(x - 6, 0); xx < pmin(x + 6, pw); xx++)
                            row[xx] = (int32_t)px[xx - x + 7];
                    } else {
                        int y = cy * 4, x = cx * 4 + k;
                        for (int t = 0; t < 14; t++)
                            px[t] = pl[(size_t)pmin(pmax(y - 7 + t, 0), ph - 1) * stride + x];
                        lf_taps(px, size, lp);
                        for (int yy = pmax(y - 6, 0); yy < pmin(y + 6, ph); yy++)
                            pl[(size_t)yy * stride + x] = (int32_t)px[yy - y + 7];
                    }
                }
            }
        }
    }
}

/* ---- CDEF -------------------------------------------------------------------- */

static const int CDEF_DIRS[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},
};
static const int CDEF_PRI_TAPS[2][2] = {{4, 2}, {3, 3}};
static const int CDEF_SEC_TAPS[2] = {2, 1};
static const int CDEF_DIV[7] = {840, 420, 280, 210, 168, 140, 120};
/* Cdef_Uv_Dir[ss_x][ss_y] */
static const int CDEF_UV_DIR[2][2][8] = {
    {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
    {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};

static void cdef_direction(const int32_t *p, int stride, int bd, int *out_dir,
                           int *out_var) {
    int64_t pd[2][15] = {{0}}, pa[4][11] = {{0}}, ph[2][8] = {{0}};
    int sh = bd - 8;
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
        cost[0] += (pd[0][n] * pd[0][n] + pd[0][14 - n] * pd[0][14 - n]) * CDEF_DIV[n];
        cost[4] += (pd[1][n] * pd[1][n] + pd[1][14 - n] * pd[1][14 - n]) * CDEF_DIV[n];
    }
    cost[0] += pd[0][7] * pd[0][7] * 105;
    cost[4] += pd[1][7] * pd[1][7] * 105;
    for (int i = 0; i < 4; i++) {
        int64_t c2 = 0;
        for (int m = 0; m < 5; m++) c2 += pa[i][3 + m] * pa[i][3 + m];
        c2 *= 105;
        for (int m = 0; m < 3; m++)
            c2 += (pa[i][m] * pa[i][m] + pa[i][10 - m] * pa[i][10 - m]) * CDEF_DIV[2 * m + 1];
        cost[2 * i + 1] = c2;
    }
    int best = 0;
    for (int k = 1; k < 8; k++)
        if (cost[k] > cost[best]) best = k;
    *out_dir = best;
    *out_var = (int)((cost[best] - cost[best ^ 4]) >> 10);
}

static inline int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int shift = damping - (31 - __builtin_clz((unsigned)threshold));
    if (shift < 0) shift = 0;
    int mag = diff < 0 ? -diff : diff;
    int t = threshold - (mag >> shift);
    if (t < 0) t = 0;
    int v = mag < t ? mag : t;
    return diff < 0 ? -v : v;
}

/* one bw x bh block at (x0, y0) of a (ph, pw) plane: src (deblocked) to
 * dst; taps outside the plane are unavailable */
/* an 8-wide block whose taps all lie inside the plane: one 8-lane
 * vector per row (GNU vector extensions), as the encoder's cdef_frame_c */
static void cdef_block8(const int32_t *src, int32_t *dst, int stride, int x0,
                        int y0, int bh, int pri, int sec, int damping,
                        int dir, int coeff_shift) {
    typedef int32_t v8si __attribute__((vector_size(32), aligned(4)));
    const int *pt = CDEF_PRI_TAPS[(pri >> coeff_shift) & 1];
    int po0 = CDEF_DIRS[dir][0][0] * stride + CDEF_DIRS[dir][0][1];
    int po1 = CDEF_DIRS[dir][1][0] * stride + CDEF_DIRS[dir][1][1];
    int d2 = (dir + 2) & 7, d6 = (dir + 6) & 7;
    int so0 = CDEF_DIRS[d2][0][0] * stride + CDEF_DIRS[d2][0][1];
    int so1 = CDEF_DIRS[d2][1][0] * stride + CDEF_DIRS[d2][1][1];
    int so2 = CDEF_DIRS[d6][0][0] * stride + CDEF_DIRS[d6][0][1];
    int so3 = CDEF_DIRS[d6][1][0] * stride + CDEF_DIRS[d6][1][1];
    int psh = 0, ssh = 0;
    if (pri) psh = pmax(0, damping - (31 - __builtin_clz((unsigned)pri)));
    if (sec) ssh = pmax(0, damping - (31 - __builtin_clz((unsigned)sec)));
#define VLOAD(ptr) (*(const v8si *)(const void *)(ptr))
#define TAPROW(off, tapw, thrv, sh)                                        \
    do {                                                                   \
        v8si p_ = VLOAD(sp + (off));                                       \
        v8si d_ = p_ - pxv;                                                \
        v8si msk_ = d_ >> 31;                                              \
        v8si m_ = (d_ ^ msk_) - msk_;                                      \
        v8si t_ = (thrv) - (m_ >> (sh));                                   \
        t_ &= ~(t_ >> 31);                                                 \
        v8si sel_ = m_ < t_;                                               \
        t_ = (m_ & sel_) | (t_ & ~sel_);                                   \
        sv += (tapw) * ((t_ ^ msk_) - msk_);                               \
        sel_ = p_ > mxv;                                                   \
        mxv = (p_ & sel_) | (mxv & ~sel_);                                 \
        sel_ = p_ < mnv;                                                   \
        mnv = (p_ & sel_) | (mnv & ~sel_);                                 \
    } while (0)
    v8si thr_pri = {pri, pri, pri, pri, pri, pri, pri, pri};
    v8si thr_sec = {sec, sec, sec, sec, sec, sec, sec, sec};
    for (int yy = 0; yy < bh; yy++) {
        const int32_t *sp = src + (size_t)(y0 + yy) * stride + x0;
        int32_t *dp = dst + (size_t)(y0 + yy) * stride + x0;
        v8si pxv = VLOAD(sp);
        v8si sv = {0, 0, 0, 0, 0, 0, 0, 0};
        v8si mxv = pxv, mnv = pxv;
        if (pri) {
            TAPROW(po0, pt[0], thr_pri, psh);
            TAPROW(-po0, pt[0], thr_pri, psh);
            TAPROW(po1, pt[1], thr_pri, psh);
            TAPROW(-po1, pt[1], thr_pri, psh);
        }
        if (sec) {
            TAPROW(so0, 2, thr_sec, ssh);
            TAPROW(-so0, 2, thr_sec, ssh);
            TAPROW(so2, 2, thr_sec, ssh);
            TAPROW(-so2, 2, thr_sec, ssh);
            TAPROW(so1, 1, thr_sec, ssh);
            TAPROW(-so1, 1, thr_sec, ssh);
            TAPROW(so3, 1, thr_sec, ssh);
            TAPROW(-so3, 1, thr_sec, ssh);
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
}

static void cdef_block(const int32_t *src, int32_t *dst, int stride, int ph,
                       int pw, int x0, int y0, int bw, int bh, int pri,
                       int sec, int damping, int dir, int coeff_shift) {
    if (bw == 8 && y0 >= 2 && x0 >= 2 && y0 + bh + 2 <= ph && x0 + 10 <= pw) {
        cdef_block8(src, dst, stride, x0, y0, bh, pri, sec, damping, dir,
                    coeff_shift);
        return;
    }
    const int *pt = CDEF_PRI_TAPS[(pri >> coeff_shift) & 1];
    for (int yy = 0; yy < bh; yy++)
        for (int xx = 0; xx < bw; xx++) {
            int y = y0 + yy, x = x0 + xx;
            int p0 = src[(size_t)y * stride + x];
            int s = 0, mx = p0, mn = p0;
            for (int k = 0; k < 2; k++) {
                if (pri) {
                    int dy = CDEF_DIRS[dir][k][0], dx = CDEF_DIRS[dir][k][1];
                    for (int sg = -1; sg <= 1; sg += 2) {
                        int py = y + sg * dy, pxx = x + sg * dx;
                        if (py >= 0 && py < ph && pxx >= 0 && pxx < pw) {
                            int p = src[(size_t)py * stride + pxx];
                            s += pt[k] * constrain(p - p0, pri, damping);
                            mx = pmax(mx, p);
                            mn = pmin(mn, p);
                        }
                    }
                }
                if (sec) {
                    for (int di = 0; di < 2; di++) {
                        int dd = (dir + (di ? 6 : 2)) & 7;
                        int dy = CDEF_DIRS[dd][k][0], dx = CDEF_DIRS[dd][k][1];
                        for (int sg = -1; sg <= 1; sg += 2) {
                            int py = y + sg * dy, pxx = x + sg * dx;
                            if (py >= 0 && py < ph && pxx >= 0 && pxx < pw) {
                                int p = src[(size_t)py * stride + pxx];
                                s += CDEF_SEC_TAPS[k] * constrain(p - p0, sec, damping);
                                mx = pmax(mx, p);
                                mn = pmin(mn, p);
                            }
                        }
                    }
                }
            }
            int v = p0 + ((8 + s - (s < 0)) >> 4);
            dst[(size_t)y * stride + x] = pmin(pmax(v, mn), mx);
        }
}

static void cdef_frame(int32_t *const *planes, int32_t *const *src, int stride,
                       int nplanes, int sx, int sy, const uint8_t *skips,
                       const int8_t *cdef_idx, int mi_rows, int mi_cols,
                       const int32_t *hdr, int32_t *counts) {
    int bd = hdr[H_BITDEPTH], cs = bd - 8;
    int damping = hdr[H_CDEF_DAMPING];
    int cstride = (mi_cols + 15) / 16;
    int first = -2;
    for (int fr = 0; fr < (mi_rows + 15) / 16; fr++)
        for (int fc = 0; fc < cstride; fc++) {
            int idx = cdef_idx[(size_t)fr * cstride + fc];
            if (idx < 0) continue;
            if (first == -2) first = idx;
            else if (idx != first) counts[T_CDEF_UNITS_VARIED]++;
            const int32_t *st = hdr + H_CDEF_STRENGTHS + 4 * idx;
            int yp = st[0] << cs, ys = st[1] << cs, up = st[2] << cs, us = st[3] << cs;
            for (int r = fr * 16; r < pmin(fr * 16 + 16, mi_rows); r += 2)
                for (int c = fc * 16; c < pmin(fc * 16 + 16, mi_cols); c += 2) {
                    const uint8_t *sk = skips + (size_t)r * mi_cols + c;
                    if (sk[0] && sk[1] && sk[mi_cols] && sk[mi_cols + 1]) continue;
                    int dir = 0, var = 0;
                    cdef_direction(src[0] + (size_t)(r * 4) * stride + c * 4, stride, bd,
                                   &dir, &var);
                    int pri = yp;
                    if (pri) {
                        int v6 = var >> 6;
                        int vs = v6 ? pmin(31 - __builtin_clz((unsigned)v6), 12) : 0;
                        pri = var ? (yp * (4 + vs) + 8) >> 4 : 0;
                    }
                    if (pri || ys)
                        cdef_block(src[0], planes[0], stride, mi_rows * 4, mi_cols * 4,
                                   c * 4, r * 4, 8, 8, pri, ys, damping + cs,
                                   yp ? dir : 0, cs);
                    if (nplanes > 1 && (up || us)) {
                        int udir = up ? CDEF_UV_DIR[sx][sy][dir] : 0;
                        for (int p = 1; p < 3; p++)
                            cdef_block(src[p], planes[p], stride, (mi_rows * 4) >> sy,
                                       (mi_cols * 4) >> sx, (c * 4) >> sx, (r * 4) >> sy,
                                       8 >> sx, 8 >> sy, up, us, damping + cs - 1, udir,
                                       cs);
                    }
                }
        }
}

/* ---- loop restoration ------------------------------------------------------ */

/* Sgr_Params radii and the strengths s derived from them (libdav1d's
 * precomputed table, as av1/restoration.py SGR_S) */
static const int SGR_R[16][2] = {
    {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1}, {2, 1},
    {2, 1}, {2, 1}, {0, 1}, {0, 1}, {0, 1}, {0, 1}, {2, 0}, {2, 0}};
static const int SGR_S[16][2] = {
    {140, 3236}, {112, 2158}, {93, 1618}, {80, 1438}, {70, 1295},
    {58, 1177}, {47, 1079}, {37, 996}, {30, 925}, {25, 863},
    {0, 2589}, {0, 1618}, {0, 1177}, {0, 925}, {56, 0}, {22, 0}};

typedef struct {
    const int32_t *cdef, *deblk;
    int stride, end_x, end_y; /* PlaneEndX/Y */
    int ss, se;               /* StripeStartY / StripeEndY */
} LrSrc;

/* spec get_source_sample */
static inline int32_t lr_sample(const LrSrc *s, int x, int y) {
    x = pmax(0, pmin(s->end_x, x));
    y = pmax(0, pmin(s->end_y, y));
    if (y < s->ss) return s->deblk[(size_t)pmax(s->ss - 2, y) * s->stride + x];
    if (y > s->se) return s->deblk[(size_t)pmin(s->se + 2, y) * s->stride + x];
    return s->cdef[(size_t)y * s->stride + x];
}

static void wiener_rect(const LrSrc *s, int32_t *out, int x0, int y0, int w, int h,
                        const int32_t *taps, int bd) {
    int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
    int offset = 1 << (bd + 7 - r0 - 1);
    int limit = (1 << (bd + 1 + 7 - r0)) - 1;
    int vf[7], hf[7];
    for (int pass = 0; pass < 2; pass++) {
        int *f = pass == 0 ? vf : hf;
        const int32_t *t = taps + pass * 3;
        f[3] = 128;
        for (int i = 0; i < 3; i++) {
            f[i] = f[6 - i] = t[i];
            f[3] -= 2 * t[i];
        }
    }
    int32_t *inter = (int32_t *)malloc(sizeof(int32_t) * (size_t)(h + 6) * w);
    for (int r = 0; r < h + 6; r++)
        for (int c = 0; c < w; c++) {
            int64_t acc = 0;
            for (int t = 0; t < 7; t++) acc += (int64_t)hf[t] * lr_sample(s, x0 + c + t - 3, y0 + r - 3);
            int v = (int)((acc + (1 << (r0 - 1))) >> r0);
            inter[(size_t)r * w + c] = pmin(pmax(v, -offset), limit - offset);
        }
    int maxv = (1 << bd) - 1;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int64_t acc = 0;
            for (int t = 0; t < 7; t++) acc += (int64_t)vf[t] * inter[(size_t)(r + t) * w + c];
            int v = (int)((acc + (1 << (r1 - 1))) >> r1);
            out[(size_t)(y0 + r) * s->stride + x0 + c] = pmin(pmax(v, 0), maxv);
        }
    free(inter);
}

/* one box-filter pass (spec box_filter) over rows [y0, y0 + h) x [x0,
 * x0 + w): flt at the << SGRPROJ_RST_BITS scale */
static void sgr_box(const LrSrc *s, int64_t *flt, int x0, int y0, int w, int h,
                    int r, int strength, int pass, int bd) {
    int n = (2 * r + 1) * (2 * r + 1);
    int one_over_n = ((1 << 12) + n / 2) / n;
    int gw = w + 2;
    int64_t *A = (int64_t *)malloc(sizeof(int64_t) * (size_t)(h + 2) * gw);
    int64_t *B = (int64_t *)malloc(sizeof(int64_t) * (size_t)(h + 2) * gw);
    for (int i = -1; i < h + 1; i++) {
        if (pass == 0 && !(i & 1)) continue; /* r = 2 reads the odd rows */
        for (int j = -1; j < w + 1; j++) {
            int64_t a = 0, b = 0;
            for (int dy = -r; dy <= r; dy++)
                for (int dx = -r; dx <= r; dx++) {
                    int64_t c = lr_sample(s, x0 + j + dx, y0 + i + dy);
                    a += c * c;
                    b += c;
                }
            int sh2 = 2 * (bd - 8), sh1 = bd - 8;
            a = sh2 ? (a + ((int64_t)1 << (sh2 - 1))) >> sh2 : a;
            int64_t dd = sh1 ? (b + ((int64_t)1 << (sh1 - 1))) >> sh1 : b;
            int64_t p = a * n - dd * dd;
            if (p < 0) p = 0;
            int64_t z = (p * strength + (1 << 19)) >> 20;
            int64_t a2 = z >= 255 ? 256 : (z == 0 ? 1 : ((z << 8) + z / 2) / (z + 1));
            int64_t b2 = ((256 - a2) * b * one_over_n + (1 << 11)) >> 12;
            A[(size_t)(i + 1) * gw + j + 1] = a2;
            B[(size_t)(i + 1) * gw + j + 1] = b2;
        }
    }
    for (int i = 0; i < h; i++) {
        int shift = (pass == 0 && (i & 1)) ? 4 : 5;
        for (int j = 0; j < w; j++) {
            int64_t a = 0, b = 0;
            for (int dy = -1; dy <= 1; dy++)
                for (int dx = -1; dx <= 1; dx++) {
                    int wt;
                    if (pass == 0) wt = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                    else wt = (dx == 0 || dy == 0) ? 4 : 3;
                    if (!wt) continue;
                    size_t k = (size_t)(i + dy + 1) * gw + j + dx + 1;
                    a += wt * A[k];
                    b += wt * B[k];
                }
            int64_t v = a * s->cdef[(size_t)(y0 + i) * s->stride + x0 + j] + b;
            int tot = 8 + shift - 4;
            flt[(size_t)i * w + j] = (v + ((int64_t)1 << (tot - 1))) >> tot;
        }
    }
    free(A);
    free(B);
}

static void sgr_rect(const LrSrc *s, int32_t *out, int x0, int y0, int w, int h,
                     const int32_t *e, int bd) {
    int set = e[1], w0 = e[2], w1 = e[3];
    int r0 = SGR_R[set][0], r1 = SGR_R[set][1];
    int64_t *f0 = (int64_t *)malloc(sizeof(int64_t) * (size_t)w * h);
    int64_t *f1 = (int64_t *)malloc(sizeof(int64_t) * (size_t)w * h);
    if (r0) sgr_box(s, f0, x0, y0, w, h, 2, SGR_S[set][0], 0, bd);
    if (r1) sgr_box(s, f1, x0, y0, w, h, 1, SGR_S[set][1], 1, bd);
    int w2 = 128 - w0 - w1, maxv = (1 << bd) - 1;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int64_t u = (int64_t)s->cdef[(size_t)(y0 + i) * s->stride + x0 + j] << 4;
            int64_t v = w1 * u;
            v += w0 * (r0 ? f0[(size_t)i * w + j] : u);
            v += w2 * (r1 ? f1[(size_t)i * w + j] : u);
            int64_t q = (v + (1 << 10)) >> 11;
            out[(size_t)(y0 + i) * s->stride + x0 + j] = (int32_t)(q < 0 ? 0 : (q > maxv ? maxv : q));
        }
    free(f0);
    free(f1);
}

static void restore_plane(int32_t *out, const int32_t *cdef, const int32_t *deblk,
                          int stride, int plane, int sx, int sy,
                          const int32_t *lr, const int32_t *hdr) {
    int bd = hdr[H_BITDEPTH];
    int fw = hdr[H_UPSCALED_WIDTH], fh = hdr[H_HEIGHT];
    int unit = hdr[H_LR_UNIT0 + plane];
    int urows = hdr[H_LR_UROWS0 + plane], ucols = hdr[H_LR_UCOLS0 + plane];
    int rs = hdr[H_LR_RSTRIDE], cstr = hdr[H_LR_CSTRIDE];
    LrSrc s = {cdef, deblk, stride, ((fw + sx) >> sx) - 1, ((fh + sy) >> sy) - 1, 0, 0};
    /* luma mi rows: the stripe and the unit row are those of each 4 luma
     * rows (spec loop_restore_block) */
    for (int ly = 0; ly < fh; ly += 4) {
        int stripe = (ly + 8) / 64;
        s.ss = (-8 + stripe * 64) >> sy;
        s.se = s.ss + (64 >> sy) - 1;
        int y = ly >> sy;
        int h = pmin(4 >> sy, s.end_y - y + 1);
        if (h <= 0) continue;
        int ur = pmin(urows - 1, ((ly + 8) >> sy) / unit);
        for (int uc = 0; uc < ucols; uc++) {
            int x0 = uc * unit;
            int x1 = uc + 1 < ucols ? (uc + 1) * unit : s.end_x + 1;
            if (x0 > s.end_x) break;
            const int32_t *e = lr + (((size_t)plane * rs + ur) * cstr + uc) * 7;
            if (e[0] == 1) wiener_rect(&s, out, x0, y, x1 - x0, h, e + 1, bd);
            else if (e[0] == 2) sgr_rect(&s, out, x0, y, x1 - x0, h, e, bd);
        }
    }
}

/* ---- superres upscaling --------------------------------------------------- */

/* One plane's rows (spec 7.16, in place): w coded samples a row (Round2(
 * FrameWidth, subX)) to up_w (Round2(UpscaledWidth, subX)), each output
 * sample an 8-tap filter (filter: 64 phases of 8 int16) at a position
 * that steps by w / up_w in 1/16384 units from initialSubpelX, its taps
 * clamped to the plane's coded columns [0, src_w) (src_w = MiCols * 4 >>
 * subX, past w where the frame is not a multiple of 8 wide). */
static int upscale_plane(int32_t *pl, int stride, int rows, int w, int up_w,
                         int src_w, int bd, const int16_t *filter) {
    int32_t *row = (int32_t *)malloc(sizeof(int32_t) * (size_t)src_w);
    if (!row) return 2;
    int step = ((w << 14) + up_w / 2) / up_w;
    int err = up_w * step - (w << 14);
    int x0 = ((-((up_w - w) << 13) + up_w / 2) / up_w + 128 - err / 2) & 0x3fff;
    int maxv = (1 << bd) - 1;
    for (int y = 0; y < rows; y++) {
        int32_t *p = pl + (size_t)y * stride;
        memcpy(row, p, sizeof(int32_t) * (size_t)src_w);
        for (int x = 0; x < up_w; x++) {
            int64_t pos = x0 + (int64_t)x * step;
            int base = (int)(pos >> 14) - 4;
            const int16_t *f = filter + ((pos & 0x3fff) >> 8) * 8;
            int64_t sum = 0;
            for (int k = 0; k < 8; k++)
                sum += (int64_t)row[pmax(0, pmin(src_w - 1, base + k))] * f[k];
            int v = (int)((sum + 64) >> 7);
            p[x] = pmin(pmax(v, 0), maxv);
        }
    }
    free(row);
    return 0;
}

/* In place on the decoder's planes (each (mi_rows * 4 >> ss) x (mi_cols *
 * 4 >> ss) used of an int32 buffer of the given stride and at least as
 * many rows, and under superres as wide as the upscaled frame):
 * deblocking, CDEF, the superres upscaling, then loop restoration.
 * txmaps, skips, cdef_idx, delta_lf (the four DeltaLF of every mi,
 * mi_rows x mi_cols x 4) and segs (the segment of every mi, mi_rows
 * x mi_cols) are av1_decode_frame's outputs; lr the restoration units;
 * upscale_filter the spec's Upscale_Filter (64 x 8 int16); upscale_s,
 * where not NULL, gains the seconds the upscaling took.
 * Returns 0, or 2 when out of memory. */
int av1_postfilter(int32_t *const *planes, int stride, const int32_t *hdr,
                   const uint8_t *const *txmaps, const uint8_t *skips,
                   const int8_t *cdef_idx, const int8_t *delta_lf, const uint8_t *segs,
                   const uint8_t *mi_lf, const uint8_t *mi_bsz, const int32_t *lr,
                   const int16_t *upscale_filter, int32_t *counts,
                   double *upscale_s) {
    int nplanes = hdr[H_NPLANES], mi_rows = hdr[H_MI_ROWS], mi_cols = hdr[H_MI_COLS];
    int sx = hdr[H_SS_X], sy = hdr[H_SS_Y];
    int fw = hdr[H_WIDTH], fh = hdr[H_HEIGHT];
    int superres = hdr[H_SUPERRES_DENOM] != 8;
    /* a lossless frame has its levels 0, CDEF off and, at its full width,
     * no restoration */
    /* no deblocking where both luma levels are 0; a chroma plane whose
     * level is 0 stays unfiltered whatever its deltas and its segments'
     * ALT_LF (spec 7.14.1, as dav1d) */
    if (hdr[H_LF_Y0] || hdr[H_LF_Y1])
        for (int p = 0; p < nplanes; p++)
            if (!p || hdr[H_LF_U + p - 1])
                deblock_plane(planes[p], stride, p, p ? sx : 0, p ? sy : 0, txmaps[p],
                              delta_lf, segs, mi_lf, mi_bsz, mi_rows, mi_cols, fw, fh, hdr);
    int any_lr = hdr[H_LR_TYPE0] || hdr[H_LR_TYPE1] || hdr[H_LR_TYPE2];
    int any_cdef = 0;
    if (hdr[H_CDEF_ON])
        for (int i = 0; i < (1 << hdr[H_CDEF_BITS]) * 4; i++) any_cdef |= hdr[H_CDEF_STRENGTHS + i];
    if (!any_cdef && !any_lr && !superres) return 0;
    size_t rows = (size_t)mi_rows * 4;
    size_t n = rows * (size_t)stride;
    int32_t *deblk[3] = {NULL, NULL, NULL}, *cdef[3] = {NULL, NULL, NULL};
    int rc = 0;
    for (int p = 0; p < nplanes && (any_cdef || any_lr); p++) {
        deblk[p] = (int32_t *)malloc(n * sizeof(int32_t));
        if (!deblk[p]) { rc = 2; goto done; }
        memcpy(deblk[p], planes[p], n * sizeof(int32_t));
    }
    if (any_cdef)
        cdef_frame(planes, deblk, stride, nplanes, sx, sy, skips, cdef_idx, mi_rows,
                   mi_cols, hdr, counts);
    if (superres) {
        struct timespec t0, t1;
        clock_gettime(CLOCK_MONOTONIC, &t0);
        int up = hdr[H_UPSCALED_WIDTH];
        for (int p = 0; p < nplanes && !rc; p++) {
            int px = p ? sx : 0, py = p ? sy : 0;
            int w = (fw + px) >> px, up_w = (up + px) >> px;
            int src_w = (mi_cols * 4) >> px, prow = (int)(rows >> py);
            rc = upscale_plane(planes[p], stride, prow, w, up_w, src_w,
                               hdr[H_BITDEPTH], upscale_filter);
            /* the rows loop restoration reads past its stripes */
            if (!rc && hdr[H_LR_TYPE0 + p])
                rc = upscale_plane(deblk[p], stride, prow, w, up_w, src_w,
                                   hdr[H_BITDEPTH], upscale_filter);
            counts[T_SUPERRES]++;
        }
        clock_gettime(CLOCK_MONOTONIC, &t1);
        if (upscale_s)
            *upscale_s += (double)(t1.tv_sec - t0.tv_sec)
                          + 1e-9 * (double)(t1.tv_nsec - t0.tv_nsec);
        if (rc) goto done;
    }
    if (any_lr) {
        for (int p = 0; p < nplanes; p++) {
            if (!hdr[H_LR_TYPE0 + p]) continue;
            cdef[p] = (int32_t *)malloc(n * sizeof(int32_t));
            if (!cdef[p]) { rc = 2; goto done; }
            memcpy(cdef[p], planes[p], n * sizeof(int32_t));
            if (p && (sx || sy)) counts[T_LR_CHROMA_SUBSAMPLED]++;
            restore_plane(planes[p], cdef[p], deblk[p], stride, p, p ? sx : 0,
                          p ? sy : 0, lr, hdr);
        }
    }
done:
    for (int p = 0; p < 3; p++) {
        free(deblk[p]);
        free(cdef[p]);
    }
    return rc;
}
