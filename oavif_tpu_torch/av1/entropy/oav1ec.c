/* oavif-tpu native entropy coder.
 *
 * C mirror of the verified Python range coder + coefficient tokenizer
 * (rangecoder.py / frame.py::_encode_coeffs). The serial, entropy-inherent
 * part of the AV1 encode runs here; everything batched runs on the TPU.
 *
 * Semantics are locked by tests/test_rangecoder.py (round-trip vs the
 * Python decoder) and tests/test_conformance.py (bit-exact decode through
 * dav1d).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__AVX512F__) && defined(__AVX512BW__)
#define ENC_U8_VEC 1
#include <immintrin.h>
#else
#define ENC_U8_VEC 0
#endif

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define PROB_TOP 32768u

typedef struct {
    uint64_t low;     /* < 2^(15+pending), transiently < 2^(22+15) in
                         normalize — must be 64-bit */
    uint32_t rng;     /* [0x8000, 0xFFFF] */
    int pending;      /* 0..7 */
    uint8_t *out;
    size_t len, cap;
} Enc;

static void out_grow(Enc *e) {
    e->cap = e->cap ? e->cap * 2 : 4096;
    e->out = (uint8_t *)realloc(e->out, e->cap);
}

static void out_push(Enc *e, uint8_t b) {
    if (e->len == e->cap) out_grow(e);
    e->out[e->len++] = b;
}

Enc *enc_new(void) {
    Enc *e = (Enc *)calloc(1, sizeof(Enc));
    e->rng = 0x8000;
    return e;
}

void enc_free(Enc *e) {
    if (e) {
        free(e->out);
        free(e);
    }
}

static void carry(Enc *e) {
    size_t i = e->len;
    while (i-- > 0) {
        if (e->out[i] != 0xFF) {
            e->out[i]++;
            return;
        }
        e->out[i] = 0;
    }
    /* carry out of stream start: cannot happen for valid streams */
}

static int ilog_nz(uint32_t x) {
    return 32 - __builtin_clz(x);
}

static void normalize(Enc *e, uint64_t low, uint32_t rng) {
    uint64_t bound = 1ull << (15 + e->pending);
    while (low >= bound) {
        low -= bound;
        carry(e);
    }
    int d = 16 - ilog_nz(rng);
    low <<= d;
    rng <<= d;
    int pending = e->pending + d;
    if (pending >= 8) {
        /* at most 2 bytes per call (pending <= 7 + 13); one capacity
         * check, unchecked writes */
        while (e->len + 2 > e->cap) out_grow(e);
        do {
            int shift = 15 + pending - 8;
            e->out[e->len++] = (uint8_t)(low >> shift);
            low &= (1ull << shift) - 1;
            pending -= 8;
        } while (pending >= 8);
    }
    e->low = low;
    e->rng = rng;
    e->pending = pending;
}

/* icdf: nsym entries (last 0) followed by the adaptation counter. */
void enc_symbol(Enc *e, uint16_t *icdf, int nsym, int s) {
    uint32_t fl = s > 0 ? icdf[s - 1] : PROB_TOP;
    uint32_t fh = icdf[s];
    uint64_t l = e->low;
    uint32_t r = e->rng, u, v;
    int n = nsym - 1;
    if (fl < PROB_TOP) {
        u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) +
            EC_MIN_PROB * (uint32_t)(n - (s - 1));
        v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) +
            EC_MIN_PROB * (uint32_t)(n - s);
        l += r - u;
        r = u - v;
    } else {
        r -= (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) +
             EC_MIN_PROB * (uint32_t)(n - s);
    }
    normalize(e, l, r);
}

void update_cdf_c(uint16_t *icdf, int nsym, int val) {
    int count = icdf[nsym];
    int rate = 3 + (count > 15) + (count > 31) + (nsym <= 3 ? 1 : 2);
    /* split at val: tmp is PROB_TOP for i < val (pull up; equal-value
     * no-op matches the old subtract-zero branch) and 0 from val on
     * (pull down) — same arithmetic, no per-element branch */
    int i = 0;
    for (; i < val && i < nsym - 1; i++)
        icdf[i] += (uint16_t)((PROB_TOP - icdf[i]) >> rate);
    for (; i < nsym - 1; i++)
        icdf[i] -= (uint16_t)(icdf[i] >> rate);
    icdf[nsym] = (uint16_t)(count + (count < 32));
}

void enc_symbol_adapt(Enc *e, uint16_t *icdf, int nsym, int s) {
    enc_symbol(e, icdf, nsym, s);
    update_cdf_c(icdf, nsym, s);
}

void enc_bool(Enc *e, int val, uint32_t f) {
    uint64_t l = e->low;
    uint32_t r = e->rng;
    uint32_t v =
        (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB;
    if (val) {
        l += r - v;
        r = v;
    } else {
        r -= v;
    }
    normalize(e, l, r);
}

void enc_literal(Enc *e, uint32_t value, int bits) {
    for (int i = bits - 1; i >= 0; i--) enc_bool(e, (value >> i) & 1, 16384);
}

static void enc_golomb(Enc *e, uint32_t v) {
    uint32_t x = v + 1;
    int n = ilog_nz(x);
    for (int i = 0; i < n - 1; i++) enc_bool(e, 0, 16384);
    enc_bool(e, 1, 16384);
    for (int i = n - 2; i >= 0; i--) enc_bool(e, (x >> i) & 1, 16384);
}

/* Flush: returns number of bytes written to *dst (caller frees via
 * enc_free; dst points into internal storage after this call). */
size_t enc_done(Enc *e, uint8_t **dst) {
    uint32_t m = 0x3FFF;
    uint64_t ev = ((uint64_t)(e->low + m) & ~(uint64_t)m) | (m + 1);
    int bits = 15 + e->pending;
    int nbytes = (bits + 7) / 8;
    ev <<= nbytes * 8 - bits;
    if (ev >> (nbytes * 8)) {
        ev &= ((uint64_t)1 << (nbytes * 8)) - 1;
        carry(e);
    }
    for (int i = nbytes - 1; i >= 0; i--) out_push(e, (uint8_t)(ev >> (8 * i)));
    *dst = e->out;
    return e->len;
}

/* ------------------------------------------------------------------ */
/* Coefficient tokenizer: one call per transform block.                 */
/* ------------------------------------------------------------------ */

static inline int min_i(int a, int b) { return a < b ? a : b; }

#if ENC_U8_VEC
/* Bulk base-ctx magnitude map over the (static-during-emission) pad:
 * min((sum of the 5 clamped-to-3 stencil neighbors + 1) >> 1, 4) for
 * every grid position, one masked 64-lane row per step. avg_epu8(s, 0)
 * is exactly (s + 1) >> 1. Identical values to the scalar 5-load read,
 * so the emitted bitstream is unchanged. */
static void mag5_map_u8(const uint8_t *pad, int stride, int rows, int cw,
                        uint8_t *magm) {
    const __m512i three = _mm512_set1_epi8(3);
    const __m512i four = _mm512_set1_epi8(4);
    const __m512i zero = _mm512_setzero_si512();
    __mmask64 m = cw >= 64 ? ~(__mmask64)0 : (((__mmask64)1 << cw) - 1);
    for (int rr = 0; rr < rows; rr++) {
        const uint8_t *p0 = pad + (size_t)rr * stride;
        const uint8_t *p1 = p0 + stride, *p2 = p1 + stride;
        __m512i a = _mm512_min_epu8(_mm512_maskz_loadu_epi8(m, p0 + 1),
                                    three);
        __m512i b = _mm512_min_epu8(_mm512_maskz_loadu_epi8(m, p1), three);
        __m512i d = _mm512_min_epu8(_mm512_maskz_loadu_epi8(m, p1 + 1),
                                    three);
        __m512i e = _mm512_min_epu8(_mm512_maskz_loadu_epi8(m, p0 + 2),
                                    three);
        __m512i f = _mm512_min_epu8(_mm512_maskz_loadu_epi8(m, p2), three);
        __m512i s = _mm512_add_epi8(
            _mm512_add_epi8(_mm512_add_epi8(a, b), _mm512_add_epi8(d, e)),
            f);
        __m512i mg = _mm512_min_epu8(_mm512_avg_epu8(s, zero), four);
        _mm512_mask_storeu_epi8(magm + (size_t)rr * cw, m, mg);
    }
}
#endif

/* levels: cw*cw natural-order int32 (signed). scan: cw*cw int32.
 * CDF row pointers with strides; returns eob (0 if all-zero txb).
 * Also writes cul_level (capped 63) and dc category to out_ctx[2]. */
int enc_coeffs(
    Enc *e,
    const int32_t *lv, int cw,
    const int32_t *scan,
    uint16_t *txb_skip_row,                 /* 1 row: 2+1 */
    uint16_t *eob_pt_row, int eob_pt_nsym,  /* 1 row */
    uint16_t *eob_extra_rows,               /* 9 rows x 3 */
    uint16_t *base_eob_rows,                /* 4 rows x 4 */
    uint16_t *base_rows,                    /* 42 rows x 5 */
    uint16_t *br_rows,                      /* 21 rows x 5 */
    uint16_t *dc_sign_row,                  /* 1 row (ctx preselected) */
    uint16_t *txtype_row, int txtype_nsym, int txtype_sym, /* NULL = none */
    int32_t *out_ctx)
{
    int n_coded = cw * cw;
    int bwl = ilog_nz((uint32_t)cw) - 1;

    /* eob = highest nonzero scan index + 1, and levels gathered to scan
     * order ONCE (16-lane tail-first gather with an early exit at the
     * first nonzero block) so every later loop is a unit-stride read
     * instead of a scan[] gather. n_coded is always a multiple of 16. */
    int eob = 0;
#if ENC_U8_VEC
    static _Thread_local int32_t ls_buf[64 * 64];
    const int32_t *ls = ls_buf;
    {
        int si = n_coded;
        while (si >= 16) {
            si -= 16;
            __m512i idx = _mm512_loadu_si512((const void *)(scan + si));
            __m512i v = _mm512_i32gather_epi32(idx, lv, 4);
            _mm512_storeu_si512((void *)(ls_buf + si), v);
            __mmask16 nz = _mm512_test_epi32_mask(v, v);
            if (nz) {
                eob = si + 32 - __builtin_clz((unsigned)nz);
                break;
            }
        }
        for (int i = 0; i + 16 <= si; i += 16) {
            __m512i idx = _mm512_loadu_si512((const void *)(scan + i));
            _mm512_storeu_si512((void *)(ls_buf + i),
                                _mm512_i32gather_epi32(idx, lv, 4));
        }
    }
#define LV_AT(si_) ls[si_]
#else
    for (int si = n_coded - 1; si >= 0; si--)
        if (lv[scan[si]]) { eob = si + 1; break; }
#define LV_AT(si_) lv[scan[si_]]
#endif

    enc_symbol_adapt(e, txb_skip_row, 2, eob == 0);
    if (eob == 0) {
        out_ctx[0] = 0;
        out_ctx[1] = 0;
        return 0;
    }
    if (txtype_row) enc_symbol_adapt(e, txtype_row, txtype_nsym, txtype_sym);

    int eob_pt;
    if (eob == 1) eob_pt = 1;
    else if (eob == 2) eob_pt = 2;
    else eob_pt = ilog_nz((uint32_t)(eob - 1)) + 1;
    enc_symbol_adapt(e, eob_pt_row, eob_pt_nsym, eob_pt - 1);
    if (eob_pt >= 3) {
        int nbits = eob_pt - 2;
        int rest = eob - (1 << (eob_pt - 2)) - 1;
        enc_symbol_adapt(e, eob_extra_rows + (size_t)(eob_pt - 3) * 3, 2,
                         (rest >> (nbits - 1)) & 1);
        for (int i = nbits - 2; i >= 0; i--) enc_bool(e, (rest >> i) & 1, 16384);
    }

    /* padded abs levels (cap 127) for context reads: a thread-local
     * all-zero buffer, SPARSELY set at the <= eob coded positions and
     * cleared back to zero after the symbol loop (the buffer's rest-
     * state is all-zero, so never-touched cells read as the zero
     * padding the contexts expect) — replaces a calloc+dense-fill+free
     * per transform block */
    int stride = cw + 2;
    static _Thread_local uint8_t pad_buf[(64 + 2) * (64 + 2)];
    uint8_t *pad = pad_buf;
    int maxr = 0;
    for (int si = 0; si < eob; si++) {
        int pos = scan[si];
        int rf = pos >> bwl;
        if (rf > maxr) maxr = rf;
        int32_t v = LV_AT(si);
        if (!v) continue;
        int a = v < 0 ? -v : v;
        pad[rf * stride + (pos & (cw - 1))] = (uint8_t)(a > 127 ? 127 : a);
    }
    const uint8_t *magm = NULL;
#if ENC_U8_VEC
    static _Thread_local uint8_t magm_buf[64 * 64];
    if (eob >= 8) {
        mag5_map_u8(pad, stride, maxr + 1, cw, magm_buf);
        magm = magm_buf;
    }
#endif

    for (int si = eob - 1; si >= 0; si--) {
        int pos = scan[si];
        int rr = pos >> bwl, cc = pos & (cw - 1);
        int32_t v = LV_AT(si);
        int level = v < 0 ? -v : v;
        if (si == eob - 1) {
            int ctx_eob;
            if (si == 0) ctx_eob = 0;
            else if (si <= n_coded / 8) ctx_eob = 1;
            else if (si <= n_coded / 4) ctx_eob = 2;
            else ctx_eob = 3;
            enc_symbol_adapt(e, base_eob_rows + (size_t)ctx_eob * 4, 3,
                             min_i(level, 3) - 1);
        } else {
            int mag;
            if (magm) {
                mag = magm[rr * cw + cc];
            } else {
                const uint8_t *p = pad + rr * stride + cc;
                mag = min_i(p[1], 3) + min_i(p[stride], 3) +
                      min_i(p[stride + 1], 3) + min_i(p[2], 3) +
                      min_i(p[2 * stride], 3);
                mag = min_i((mag + 1) >> 1, 4);
            }
            int bctx;
            if (pos == 0) bctx = 0;
            else if (rr + cc < 2) bctx = mag + 1;
            else if (rr + cc < 4) bctx = mag + 6;
            else bctx = mag + 21;
            enc_symbol_adapt(e, base_rows + (size_t)bctx * 5, 4, min_i(level, 3));
        }
        if (level > 2) {
            const uint8_t *p = pad + rr * stride + cc;
            int mag = min_i(p[1], 15) + min_i(p[stride], 15) +
                      min_i(p[stride + 1], 15);
            mag = min_i((mag + 1) >> 1, 6);
            int brctx;
            if (pos == 0) brctx = mag;
            else if (rr < 2 && cc < 2) brctx = mag + 7;
            else brctx = mag + 14;
            int remaining = level - 3;
            for (int k = 0; k < 4; k++) {
                int kk = min_i(remaining, 3);
                enc_symbol_adapt(e, br_rows + (size_t)brctx * 5, 4, kk);
                remaining -= kk;
                if (kk < 3) break;
            }
        }
    }

    /* signs + golomb, forward */
    int dc_cat = 0;
    int cul = 0;
    for (int si = 0; si < eob; si++) {
        int32_t v = LV_AT(si);
        int level = v < 0 ? -v : v;
        cul += level;
        if (!level) continue;
        int sign = v < 0;
        if (si == 0) {
            enc_symbol_adapt(e, dc_sign_row, 2, sign);
            dc_cat = sign ? 1 : 2;
        } else {
            enc_bool(e, sign, 16384);
        }
        if (level > 14) enc_golomb(e, (uint32_t)(level - 15));
    }
    /* restore the thread-local pad's all-zero rest state */
    for (int si = 0; si < eob; si++) {
        if (!LV_AT(si)) continue;
        int pos = scan[si];
        pad[(pos >> bwl) * stride + (pos & (cw - 1))] = 0;
    }
#undef LV_AT
    out_ctx[0] = cul > 63 ? 63 : cul;
    out_ctx[1] = dc_cat;
    return eob;
}

/* Rect-txb coefficient emitter: same symbol sequence as enc_coeffs with
 * per-axis dims. Position decode uses pos/cw, pos%cw; the base-level
 * context uses the rect bands (wide txs: +16 on the first two columns,
 * tall txs: +11 on the first two rows; the square rr+cc<2 band is
 * unreachable). Mirrors frame.py _encode_coeffs_rect. */
int enc_coeffs_rect(
    Enc *e,
    const int32_t *lv, int cw, int ch,
    const int32_t *scan,
    uint16_t *txb_skip_row,
    uint16_t *eob_pt_row, int eob_pt_nsym,
    uint16_t *eob_extra_rows,
    uint16_t *base_eob_rows,
    uint16_t *base_rows,
    uint16_t *br_rows,
    uint16_t *dc_sign_row,
    int32_t *out_ctx)
{
    int n_coded = cw * ch;
    int wide = cw > ch;

    /* eob + scan-order level gather, as in enc_coeffs (n_coded is 128
     * or 512 — multiples of 16) */
    int eob = 0;
#if ENC_U8_VEC
    static _Thread_local int32_t ls_buf_r[32 * 32];
    const int32_t *ls = ls_buf_r;
    {
        int si = n_coded;
        while (si >= 16) {
            si -= 16;
            __m512i idx = _mm512_loadu_si512((const void *)(scan + si));
            __m512i v = _mm512_i32gather_epi32(idx, lv, 4);
            _mm512_storeu_si512((void *)(ls_buf_r + si), v);
            __mmask16 nz = _mm512_test_epi32_mask(v, v);
            if (nz) {
                eob = si + 32 - __builtin_clz((unsigned)nz);
                break;
            }
        }
        for (int i = 0; i + 16 <= si; i += 16) {
            __m512i idx = _mm512_loadu_si512((const void *)(scan + i));
            _mm512_storeu_si512((void *)(ls_buf_r + i),
                                _mm512_i32gather_epi32(idx, lv, 4));
        }
    }
#define LV_AT(si_) ls[si_]
#else
    for (int si = n_coded - 1; si >= 0; si--)
        if (lv[scan[si]]) { eob = si + 1; break; }
#define LV_AT(si_) lv[scan[si_]]
#endif

    enc_symbol_adapt(e, txb_skip_row, 2, eob == 0);
    if (eob == 0) {
        out_ctx[0] = 0;
        out_ctx[1] = 0;
        return 0;
    }
    /* TX_32X16-class sizes carry no tx_type syntax */

    int eob_pt;
    if (eob == 1) eob_pt = 1;
    else if (eob == 2) eob_pt = 2;
    else eob_pt = ilog_nz((uint32_t)(eob - 1)) + 1;
    enc_symbol_adapt(e, eob_pt_row, eob_pt_nsym, eob_pt - 1);
    if (eob_pt >= 3) {
        int nbits = eob_pt - 2;
        int rest = eob - (1 << (eob_pt - 2)) - 1;
        enc_symbol_adapt(e, eob_extra_rows + (size_t)(eob_pt - 3) * 3, 2,
                         (rest >> (nbits - 1)) & 1);
        for (int i = nbits - 2; i >= 0; i--) enc_bool(e, (rest >> i) & 1, 16384);
    }

    int stride = cw + 2;
    /* thread-local all-zero pad, sparsely set + cleared (see enc_coeffs) */
    static _Thread_local uint8_t pad_buf_r[(64 + 2) * (64 + 2)];
    uint8_t *pad = pad_buf_r;
    int maxr = 0;
    for (int si = 0; si < eob; si++) {
        int pos = scan[si];
        int rf = pos / cw;
        if (rf > maxr) maxr = rf;
        int32_t v = LV_AT(si);
        if (!v) continue;
        int a = v < 0 ? -v : v;
        pad[rf * stride + (pos % cw)] = (uint8_t)(a > 127 ? 127 : a);
    }
    const uint8_t *magm = NULL;
#if ENC_U8_VEC
    static _Thread_local uint8_t magm_buf_r[64 * 64];
    if (eob >= 8) {
        mag5_map_u8(pad, stride, maxr + 1, cw, magm_buf_r);
        magm = magm_buf_r;
    }
#endif

    for (int si = eob - 1; si >= 0; si--) {
        int pos = scan[si];
        int rr = pos / cw, cc = pos % cw;
        int32_t v = LV_AT(si);
        int level = v < 0 ? -v : v;
        if (si == eob - 1) {
            int ctx_eob;
            if (si == 0) ctx_eob = 0;
            else if (si <= n_coded / 8) ctx_eob = 1;
            else if (si <= n_coded / 4) ctx_eob = 2;
            else ctx_eob = 3;
            enc_symbol_adapt(e, base_eob_rows + (size_t)ctx_eob * 4, 3,
                             min_i(level, 3) - 1);
        } else {
            int mag;
            if (magm) {
                mag = magm[rr * cw + cc];
            } else {
                const uint8_t *p = pad + rr * stride + cc;
                mag = min_i(p[1], 3) + min_i(p[stride], 3) +
                      min_i(p[stride + 1], 3) + min_i(p[2], 3) +
                      min_i(p[2 * stride], 3);
                mag = min_i((mag + 1) >> 1, 4);
            }
            int bctx;
            if (pos == 0) bctx = 0;
            else if (wide && cc < 2) bctx = mag + 16;
            else if (!wide && rr < 2) bctx = mag + 11;
            else if (rr + cc < 4) bctx = mag + 6;
            else bctx = mag + 21;
            enc_symbol_adapt(e, base_rows + (size_t)bctx * 5, 4, min_i(level, 3));
        }
        if (level > 2) {
            const uint8_t *p = pad + rr * stride + cc;
            int mag = min_i(p[1], 15) + min_i(p[stride], 15) +
                      min_i(p[stride + 1], 15);
            mag = min_i((mag + 1) >> 1, 6);
            int brctx;
            if (pos == 0) brctx = mag;
            else if (rr < 2 && cc < 2) brctx = mag + 7;
            else brctx = mag + 14;
            int remaining = level - 3;
            for (int k = 0; k < 4; k++) {
                int kk = min_i(remaining, 3);
                enc_symbol_adapt(e, br_rows + (size_t)brctx * 5, 4, kk);
                remaining -= kk;
                if (kk < 3) break;
            }
        }
    }

    int dc_cat = 0;
    int cul = 0;
    for (int si = 0; si < eob; si++) {
        int32_t v = LV_AT(si);
        int level = v < 0 ? -v : v;
        cul += level;
        if (!level) continue;
        int sign = v < 0;
        if (si == 0) {
            enc_symbol_adapt(e, dc_sign_row, 2, sign);
            dc_cat = sign ? 1 : 2;
        } else {
            enc_bool(e, sign, 16384);
        }
        if (level > 14) enc_golomb(e, (uint32_t)(level - 15));
    }
    for (int si = 0; si < eob; si++) {
        if (!LV_AT(si)) continue;
        int pos = scan[si];
        pad[(pos / cw) * stride + (pos % cw)] = 0;
    }
#undef LV_AT
    out_ctx[0] = cul > 63 ? 63 : cul;
    out_ctx[1] = dc_cat;
    return eob;
}


/* ------------------------------------------------------------------ */
/* Normative inverse DCT (generic cascade, mirrors transform.py).      */
/* ------------------------------------------------------------------ */

static const int32_t COSPI[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897, 799, 700, 601, 501, 401, 301, 201, 101, 0,
};

static inline int64_t round2(int64_t x, int n) {
    return (x + ((int64_t)1 << (n - 1))) >> n;
}

static inline int64_t hb(int64_t w0, int64_t x0, int64_t w1, int64_t x1) {
    return round2(w0 * x0 + w1 * x1, 12);
}

static int brev_c(int nbits, int x) {
    int out = 0;
    for (int i = 0; i < nbits; i++) out |= ((x >> i) & 1) << (nbits - 1 - i);
    return out;
}

static void idct_1d_c(const int64_t *x, int64_t *out, int N);

static void idct_odd_c(const int64_t *o, int64_t *s, int N) {
    int h = N / 2;
    int m = 0;
    while ((1 << m) < h) m++;
    for (int i = 0; i < h / 2; i++) {
        int k = 2 * brev_c(m, i) + 1;
        int theta = k * (64 / N);
        const int64_t a = o[(k - 1) / 2], b = o[(N - k - 1) / 2];
        s[i] = hb(COSPI[64 - theta], a, -COSPI[theta], b);
        s[h - 1 - i] = hb(COSPI[theta], a, COSPI[64 - theta], b);
    }
    int64_t t[32];
    for (int L = 1; L < m; L++) {
        int gs = 1 << L;
        memcpy(t, s, sizeof(int64_t) * h);
        for (int q = 0; q < h / gs; q++) {
            int base = q * gs;
            for (int j = 0; j < gs / 2; j++) {
                int64_t xx = s[base + j], yy = s[base + gs - 1 - j];
                if (q % 2 == 0) {
                    t[base + j] = xx + yy;
                    t[base + gs - 1 - j] = xx - yy;
                } else {
                    t[base + j] = -xx + yy;
                    t[base + gs - 1 - j] = xx + yy;
                }
            }
        }
        memcpy(s, t, sizeof(int64_t) * h);
        int gr = 1 << (L + 1);
        memcpy(t, s, sizeof(int64_t) * h);
        int unit = 64 >> (m - L);
        for (int i = 0; i < h / 2; i++) {
            int pig = i % gr;
            if (!(gr / 4 <= pig && pig < 3 * gr / 4)) continue;
            int q = i / gr;
            int nb = m - L - 1;
            if (nb < 0) nb = 0;
            int theta = (2 * brev_c(nb, q) + 1) * unit;
            int64_t xx = s[i], yy = s[h - 1 - i];
            if (pig < gr / 2) {
                t[i] = hb(-COSPI[theta], xx, COSPI[64 - theta], yy);
                t[h - 1 - i] = hb(COSPI[64 - theta], xx, COSPI[theta], yy);
            } else {
                t[i] = hb(-COSPI[64 - theta], xx, -COSPI[theta], yy);
                t[h - 1 - i] = hb(-COSPI[theta], xx, COSPI[64 - theta], yy);
            }
        }
        memcpy(s, t, sizeof(int64_t) * h);
    }
}

static void idct_1d_c(const int64_t *x, int64_t *out, int N) {
    if (N == 4) {
        int64_t s0 = hb(COSPI[32], x[0], COSPI[32], x[2]);
        int64_t s1 = hb(COSPI[32], x[0], -COSPI[32], x[2]);
        int64_t s2 = hb(COSPI[48], x[1], -COSPI[16], x[3]);
        int64_t s3 = hb(COSPI[16], x[1], COSPI[48], x[3]);
        out[0] = s0 + s3; out[1] = s1 + s2; out[2] = s1 - s2; out[3] = s0 - s3;
        return;
    }
    int h = N / 2;
    int64_t ev_in[32], ev[32], od_in[32], od[32];
    for (int i = 0; i < h; i++) { ev_in[i] = x[2 * i]; od_in[i] = x[2 * i + 1]; }
    idct_1d_c(ev_in, ev, h);
    idct_odd_c(od_in, od, N);
    for (int i = 0; i < h; i++) {
        out[i] = ev[i] + od[h - 1 - i];
        out[h + i] = ev[h - 1 - i] - od[i];
    }
}

/* ---- lane-batched cascades: idct_ln_impl.h instantiated at 4 and 8
 * lanes. Per-lane results are bit-identical to the scalar path and to
 * each other (lanes are independent columns); 8 lanes = one zmm of
 * int64, amortising the cascade's index bookkeeping twice as far. ---- */
#define IDCT_LANES 4
#define IDCT_ODD_FN idct_odd_ln4
#define IDCT_FN idct_ln4
#include "idct_ln_impl.h"
#undef IDCT_LANES
#undef IDCT_ODD_FN
#undef IDCT_FN
#define IDCT_LANES 8
#define IDCT_ODD_FN idct_odd_ln8
#define IDCT_FN idct_ln8
#include "idct_ln_impl.h"
#undef IDCT_LANES
#undef IDCT_ODD_FN
#undef IDCT_FN

/* 2D inverse (square DCT_DCT only for now): coeffs h*w int32 natural
 * order in `c`, result residual written back into `c`. Rows and columns
 * run through the 4-lane cascade (all dims here are multiples of 4). */
void inv_txfm2d_c(int32_t *c, int w, int h, int bitdepth) {
    int64_t buf[64 * 64];
    int64_t vec[64 * 8], outv[64 * 8];
    /* INV_ROW_SHIFT: {4:0, 8:1, 16:2, 32:2, 64:2} by max dim; 2:1 rects
     * shift ONE LESS (dav1d per-size table, disasm-verified: 32x16 uses
     * 1 where 32x32 uses 2) -- mirrors transform.py inv_row_shift */
    int maxd = w > h ? w : h;
    int row_shift = maxd >= 16 ? 2 : (maxd >= 8 ? 1 : 0);
    int64_t clamp = ((int64_t)1 << (bitdepth + 7)) - 1;

    /* per-row nonzero flags: an all-zero row passes through the row
     * cascade EXACTLY as zeros (every butterfly and round2 maps 0 to 0,
     * and the clamp keeps 0), so its lane group can skip the transform
     * when the whole group is zero — quantized blocks concentrate
     * energy in the top rows, so most row groups skip */
    uint8_t nzr[64] = {0};
    for (int r = 0; r < h; r++) {
        int64_t acc = 0;
        for (int cc = 0; cc < w; cc++) {
            int64_t v = (w == 64 && cc >= 32) || (h == 64 && r >= 32)
                            ? 0
                            : c[r * w + cc];
            buf[r * w + cc] = v;
            acc |= v;
        }
        nzr[r] = acc != 0;
    }

    /* rect (|log2w - log2h| odd): the spec's 1/sqrt2 pre-scale
     * (Round2(x * 2896, 12)), mirrored from transform.py inv_txfm2d */
    {
        int lw = 0, lh = 0;
        while ((1 << lw) < w) lw++;
        while ((1 << lh) < h) lh++;
        if ((lw + lh) & 1) {
            for (int i = 0; i < h * w; i++)
                buf[i] = round2(buf[i] * 2896, 12);
            row_shift -= 1;
        } else if (lw != lh) {
            /* 4:1 rects: 4x16/16x4 -> 1, others keep the max-dim shift */
            if (maxd == 16) row_shift = 1;
        }
    }

    /* rows: lanes = consecutive rows (transposed load/store); 8 lanes
     * whenever h allows (every dim here but 4 is a multiple of 8) */
#define ROWS_PASS(LNC, FN)                                                   \
    for (int r0 = 0; r0 < h; r0 += LNC) {                                    \
        int any = 0;                                                         \
        for (int l = 0; l < LNC; l++) any |= nzr[r0 + l];                    \
        if (!any) continue; /* zero rows stay exact zeros */                 \
        for (int i = 0; i < w; i++)                                          \
            for (int l = 0; l < LNC; l++)                                    \
                vec[i * LNC + l] = buf[(size_t)(r0 + l) * w + i];            \
        FN(vec, outv, w);                                                    \
        for (int i = 0; i < w; i++)                                          \
            for (int l = 0; l < LNC; l++) {                                  \
                int64_t v = row_shift ? round2(outv[i * LNC + l], row_shift) \
                                      : outv[i * LNC + l];                   \
                if (v < -clamp - 1) v = -clamp - 1;                          \
                if (v > clamp) v = clamp;                                    \
                buf[(size_t)(r0 + l) * w + i] = v;                           \
            }                                                                \
    }
    if (h % 8 == 0) { ROWS_PASS(8, idct_ln8) }
    else { ROWS_PASS(4, idct_ln4) }
#undef ROWS_PASS
    /* cols: lanes = consecutive columns (contiguous loads) */
#define COLS_PASS(LNC, FN)                                                   \
    for (int c0 = 0; c0 < w; c0 += LNC) {                                    \
        for (int i = 0; i < h; i++)                                          \
            for (int l = 0; l < LNC; l++)                                    \
                vec[i * LNC + l] = buf[(size_t)i * w + c0 + l];              \
        FN(vec, outv, h);                                                    \
        for (int i = 0; i < h; i++)                                          \
            for (int l = 0; l < LNC; l++)                                    \
                buf[(size_t)i * w + c0 + l] = round2(outv[i * LNC + l], 4);  \
    }
    if (w % 8 == 0) { COLS_PASS(8, idct_ln8) }
    else { COLS_PASS(4, idct_ln4) }
#undef COLS_PASS
    for (int r = 0; r < h; r++)
        for (int cc = 0; cc < w; cc++) c[r * w + cc] = (int32_t)buf[r * w + cc];
}

/* public 1D inverse DCT (used by the tile encoder's typed 2D inverse) */
void idct_1d_pub(const int64_t *x, int64_t *out, int N) {
    idct_1d_c(x, out, N);
}
