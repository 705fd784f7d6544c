/* JPEG decoding work for the port's reader (oavif_tpu_torch/io/jpeg.py):
 * the entropy decode of baseline, extended-sequential and progressive
 * Huffman scans into coefficient arrays, then dequantization, the integer
 * inverse DCT, upsampling and colour conversion to interleaved 8-bit
 * samples. Every stage follows libjpeg-turbo's default decompression
 * (JDCT_ISLOW, fancy upsampling, no block smoothing), so the samples are
 * the ones libjpeg-turbo gives: jdhuff.c and jdphuff.c for the scans,
 * jidctint.c for the IDCT, jdsample.c for the upsampling, jdcolor.c for the
 * colour conversion. It is built into the host library beside the tile
 * coder (av1/entropy/fast.py).
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* zigzag index -> natural (row-major) index; the 16 extra entries keep a
 * corrupt run length inside the block, as libjpeg's table does */
static const int NATURAL[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* ---- entropy decode ---------------------------------------------------- */

/* One Huffman table as jpeg.py lays it out (int32 words): a 9-bit
 * look-ahead table ((length << 8) | symbol, 0 for longer codes), then
 * maxcode[18], valoffset[17] and the 256 symbols. */
#define LOOK_BITS 9
#define HT_LOOK 0
#define HT_MAXCODE (1 << LOOK_BITS)
#define HT_VALOFF (HT_MAXCODE + 18)
#define HT_VAL (HT_VALOFF + 17)
#define HT_WORDS (HT_VAL + 256)

/* One scan's descriptor (int32 words) */
enum { S_OFF, S_LEN, S_NCOMP, S_COMP, S_DC = S_COMP + 4, S_AC = S_DC + 4,
       S_SS = S_AC + 4, S_SE, S_AH, S_AL, S_RI, S_WORDS = 24 };

/* One component's geometry (int32 words): sampling factors, the
 * allocated width in blocks (the row stride of its coefficient array) and
 * the width and height in blocks that hold image samples */
enum { C_H, C_V, C_BW, C_WIB, C_HIB, C_WORDS = 8 };

typedef struct {
    const uint8_t *p, *end;
    uint64_t buf;
    int bits;
    int marker;       /* a marker (or the segment's end) stopped the input */
    int insufficient; /* the data ran out inside this restart interval */
} Bits;

/* Load bytes until 57 bits are held or a marker is reached: 0xFF 0x00 is
 * a 0xFF byte, 0xFF fill bytes before a marker are skipped, and the
 * reader then stays at the marker's first 0xFF. */
static void fill(Bits *b)
{
    while (b->bits <= 56 && !b->marker) {
        if (b->p >= b->end) {
            b->marker = 1;
            break;
        }
        int c = *b->p;
        if (c == 0xFF) {
            const uint8_t *q = b->p + 1;
            while (q < b->end && *q == 0xFF)
                q++;
            if (q < b->end && *q == 0x00) {
                b->p = q + 1;
            } else {
                b->marker = 1;
                break;
            }
        } else {
            b->p++;
        }
        b->buf = (b->buf << 8) | (uint64_t)c;
        b->bits += 8;
    }
}

/* Make n bits available; past the data they are zeros and the interval
 * is marked short of data (libjpeg's jpeg_fill_bit_buffer). */
static inline void need(Bits *b, int n)
{
    if (b->bits < n) {
        fill(b);
        if (b->bits < n) {
            b->insufficient = 1;
            b->buf <<= 32;
            b->bits += 32;
        }
    }
}

static inline int get_bits(Bits *b, int n)
{
    if (n == 0)
        return 0;
    need(b, n);
    b->bits -= n;
    return (int)((b->buf >> b->bits) & ((1u << n) - 1));
}

static inline int extend(int r, int s)
{
    return r < (1 << (s - 1)) ? r + (int)((~0u << s) + 1) : r;
}

static int huff_decode(Bits *b, const int32_t *t)
{
    if (b->bits < LOOK_BITS)
        fill(b);
    int have = b->bits;
    int peek;
    if (have >= LOOK_BITS)
        peek = (int)((b->buf >> (have - LOOK_BITS)) & ((1 << LOOK_BITS) - 1));
    else
        peek = (int)((b->buf << (LOOK_BITS - have)) & ((1 << LOOK_BITS) - 1));
    int e = t[HT_LOOK + peek];
    if (e) {
        int len = e >> 8;
        if (len > have) { /* the code's last bits lie past the data */
            b->insufficient = 1;
            b->buf <<= 32;
            b->bits += 32;
        }
        b->bits -= len;
        return e & 0xFF;
    }
    /* longer than the look-ahead: one bit at a time (jpeg_huff_decode) */
    int l = 1;
    int code = get_bits(b, 1);
    while (l <= 16 && code > t[HT_MAXCODE + l]) {
        code = (code << 1) | get_bits(b, 1);
        l++;
    }
    if (l > 16)
        return 0; /* corrupt data: libjpeg decodes a zero */
    return t[HT_VAL + ((code + t[HT_VALOFF + l]) & 0xFF)];
}

/* At a restart boundary: drop the bits held, find the RSTn marker (past
 * any bytes before it) and step over it. */
static void restart(Bits *b)
{
    b->bits = 0;
    b->buf = 0;
    const uint8_t *q = b->p;
    while (q < b->end && *q != 0xFF)
        q++;
    while (q < b->end && *q == 0xFF)
        q++;
    if (q < b->end && *q >= 0xD0 && *q <= 0xD7) {
        b->p = q + 1;
        b->marker = 0;
        b->insufficient = 0;
    } else {
        b->p = b->end; /* no marker: the rest of the scan is out of data */
        b->marker = 1;
    }
}

typedef struct {
    int16_t *const *coefs;
    const int32_t *comp;
    const int32_t *tables;
    int mcux, mcuy;
} Frame;

/* The blocks of one MCU: their component (scan position) and pointers */
typedef struct {
    int n;
    int ci[10];
    int16_t *blk[10];
} Mcu;

static int mcu_blocks(const Frame *f, const int32_t *sc, int mx, int my,
                      Mcu *m)
{
    int ns = sc[S_NCOMP];
    m->n = 0;
    if (ns == 1) {
        const int32_t *g = f->comp + C_WORDS * sc[S_COMP];
        m->ci[0] = 0;
        m->blk[0] = f->coefs[sc[S_COMP]] + ((size_t)my * g[C_BW] + mx) * 64;
        m->n = 1;
        return 1;
    }
    for (int s = 0; s < ns; s++) {
        const int32_t *g = f->comp + C_WORDS * sc[S_COMP + s];
        for (int v = 0; v < g[C_V]; v++)
            for (int h = 0; h < g[C_H]; h++) {
                if (m->n >= 10)
                    return 0;
                size_t by = (size_t)my * g[C_V] + v;
                size_t bx = (size_t)mx * g[C_H] + h;
                m->ci[m->n] = s;
                m->blk[m->n] = f->coefs[sc[S_COMP + s]]
                               + (by * g[C_BW] + bx) * 64;
                m->n++;
            }
    }
    return 1;
}

/* A correction bit of 1 on a nonzero coefficient: one more bit of its
 * magnitude, away from zero */
static inline int16_t refine(int16_t coef, int p1, int m1)
{
    return (int16_t)(coef + (coef >= 0 ? p1 : m1));
}

/* Decode one scan; progressive selects jdphuff's four procedures, else
 * jdhuff's sequential one. Returns 0, or -1 for a malformed MCU. */
static int decode_scan(const Frame *f, const uint8_t *data,
                       const int32_t *sc, int progressive)
{
    Bits b = {data + sc[S_OFF], data + sc[S_OFF] + sc[S_LEN], 0, 0, 0, 0};
    int ns = sc[S_NCOMP];
    int ss = sc[S_SS], se = sc[S_SE], ah = sc[S_AH], al = sc[S_AL];
    int ri = sc[S_RI];
    int cols, rows;
    if (ns == 1) {
        const int32_t *g = f->comp + C_WORDS * sc[S_COMP];
        cols = g[C_WIB];
        rows = g[C_HIB];
    } else {
        cols = f->mcux;
        rows = f->mcuy;
    }
    const int32_t *dct[4], *act[4];
    for (int s = 0; s < ns; s++) {
        int d = sc[S_DC + s], a = sc[S_AC + s];
        dct[s] = d >= 0 ? f->tables + (size_t)HT_WORDS * d : NULL;
        act[s] = a >= 0 ? f->tables + (size_t)HT_WORDS * a : NULL;
    }
    int last_dc[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    int togo = ri;
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    Mcu m;
    for (int my = 0; my < rows; my++)
        for (int mx = 0; mx < cols; mx++) {
            if (ri) {
                if (togo == 0) {
                    restart(&b);
                    memset(last_dc, 0, sizeof last_dc);
                    eobrun = 0;
                    togo = ri;
                }
                togo--;
            }
            if (!mcu_blocks(f, sc, mx, my, &m))
                return -1;
            if (b.insufficient)
                continue; /* libjpeg leaves the rest of the interval */
            if (!progressive) {
                for (int k0 = 0; k0 < m.n; k0++) {
                    int16_t *blk = m.blk[k0];
                    int c = m.ci[k0];
                    int s = huff_decode(&b, dct[c]);
                    if (s) {
                        int r = get_bits(&b, s);
                        s = extend(r, s);
                    }
                    s = (int)((unsigned)s + (unsigned)last_dc[c]);
                    last_dc[c] = s;
                    blk[0] = (int16_t)s;
                    for (int k = 1; k < 64; k++) {
                        s = huff_decode(&b, act[c]);
                        int r = s >> 4;
                        s &= 15;
                        if (s) {
                            k += r;
                            r = get_bits(&b, s);
                            blk[NATURAL[k]] = (int16_t)extend(r, s);
                        } else {
                            if (r != 15)
                                break;
                            k += 15;
                        }
                    }
                }
            } else if (ss == 0) {
                for (int k0 = 0; k0 < m.n; k0++) {
                    int16_t *blk = m.blk[k0];
                    if (ah == 0) {
                        int c = m.ci[k0];
                        int s = huff_decode(&b, dct[c]);
                        if (s) {
                            int r = get_bits(&b, s);
                            s = extend(r, s);
                        }
                        s = (int)((unsigned)s + (unsigned)last_dc[c]);
                        last_dc[c] = s;
                        blk[0] = (int16_t)((unsigned)s << al);
                    } else if (get_bits(&b, 1)) {
                        blk[0] = (int16_t)(blk[0] | p1);
                    }
                }
            } else if (ah == 0) {
                int16_t *blk = m.blk[0];
                if (eobrun > 0) {
                    eobrun--;
                    continue;
                }
                for (int k = ss; k <= se; k++) {
                    int s = huff_decode(&b, act[0]);
                    int r = s >> 4;
                    s &= 15;
                    if (s) {
                        k += r;
                        r = get_bits(&b, s);
                        blk[NATURAL[k]] =
                            (int16_t)((unsigned)extend(r, s) << al);
                    } else if (r == 15) {
                        k += 15;
                    } else {
                        eobrun = 1u << r;
                        if (r)
                            eobrun += (unsigned)get_bits(&b, r);
                        eobrun--;
                        break;
                    }
                }
            } else {
                int16_t *blk = m.blk[0];
                int k = ss;
                if (eobrun == 0) {
                    for (; k <= se; k++) {
                        int s = huff_decode(&b, act[0]);
                        int r = s >> 4;
                        s &= 15;
                        if (s) {
                            s = get_bits(&b, 1) ? p1 : m1;
                        } else if (r != 15) {
                            eobrun = 1u << r;
                            if (r)
                                eobrun += (unsigned)get_bits(&b, r);
                            break;
                        }
                        do {
                            int16_t *coef = blk + NATURAL[k];
                            if (*coef != 0) {
                                if (get_bits(&b, 1) && (*coef & p1) == 0)
                                    *coef = refine(*coef, p1, m1);
                            } else if (--r < 0) {
                                break;
                            }
                            k++;
                        } while (k <= se);
                        if (s)
                            blk[NATURAL[k]] = (int16_t)s;
                    }
                }
                if (eobrun > 0) {
                    for (; k <= se; k++) {
                        int16_t *coef = blk + NATURAL[k];
                        if (*coef != 0 && get_bits(&b, 1)
                            && (*coef & p1) == 0)
                            *coef = refine(*coef, p1, m1);
                    }
                    eobrun--;
                }
            }
        }
    return 0;
}

/* data: the file; scans: nscans descriptors of S_WORDS int32 (offset and
 * length of the entropy-coded segment, with its RSTn markers, in data);
 * tables: HT_WORDS int32 per Huffman table; coefs: per component, its
 * int16 blocks of 64 coefficients in natural order, zeroed by the caller;
 * comp: C_WORDS int32 per component; mcux, mcuy: MCUs of an interleaved
 * scan. Returns 0, or 1 + the index of a scan with an MCU of more than 10
 * blocks. */
int jpeg_entropy(const uint8_t *data, const int32_t *scans, int nscans,
                 const int32_t *tables, int16_t *const *coefs,
                 const int32_t *comp, int mcux, int mcuy, int progressive)
{
    Frame f = {coefs, comp, tables, mcux, mcuy};
    for (int i = 0; i < nscans; i++)
        if (decode_scan(&f, data, scans + (size_t)S_WORDS * i, progressive))
            return 1 + i;
    return 0;
}

/* ---- inverse DCT (jidctint.c, jpeg_idct_islow) -------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* libjpeg's post-IDCT range limit (jdmaster.c, prepare_range_limit_table):
 * a centred value x, taken modulo 1024, to a sample */
static inline uint8_t idct_limit(int x)
{
    int i = x & 1023;
    if (i < 128)
        return (uint8_t)(i + 128);
    if (i < 512)
        return 255;
    if (i < 896)
        return 0;
    return (uint8_t)(i - 896);
}

static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out,
                       ptrdiff_t stride)
{
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const int16_t *qp = q + c;
        int *wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48]
            && !ip[56]) {
            int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++)
                wp[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = (int64_t)ip[16] * qp[16];
        z3 = (int64_t)ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * -FIX_1_847759065;
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        t0 = (z2 + z3) * (1 << CONST_BITS);
        t1 = (z2 - z3) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = (int64_t)ip[56] * qp[56];
        t1 = (int64_t)ip[40] * qp[40];
        t2 = (int64_t)ip[24] * qp[24];
        t3 = (int64_t)ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        wp[0] = (int)DESCALE(t10 + t3, sh);
        wp[56] = (int)DESCALE(t10 - t3, sh);
        wp[8] = (int)DESCALE(t11 + t2, sh);
        wp[48] = (int)DESCALE(t11 - t2, sh);
        wp[16] = (int)DESCALE(t12 + t1, sh);
        wp[40] = (int)DESCALE(t12 - t1, sh);
        wp[24] = (int)DESCALE(t13 + t0, sh);
        wp[32] = (int)DESCALE(t13 - t0, sh);
    }
    const int sh = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; r++) {
        const int *wp = ws + 8 * r;
        uint8_t *op = out + r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6]
            && !wp[7]) {
            uint8_t v =
                idct_limit((int)DESCALE((int64_t)wp[0], PASS1_BITS + 3));
            memset(op, v, 8);
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * -FIX_1_847759065;
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 *= FIX_0_298631336;
        t1 *= FIX_2_053119869;
        t2 *= FIX_3_072711026;
        t3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        op[0] = idct_limit((int)DESCALE(t10 + t3, sh));
        op[7] = idct_limit((int)DESCALE(t10 - t3, sh));
        op[1] = idct_limit((int)DESCALE(t11 + t2, sh));
        op[6] = idct_limit((int)DESCALE(t11 - t2, sh));
        op[2] = idct_limit((int)DESCALE(t12 + t1, sh));
        op[5] = idct_limit((int)DESCALE(t12 - t1, sh));
        op[3] = idct_limit((int)DESCALE(t13 + t0, sh));
        op[4] = idct_limit((int)DESCALE(t13 - t0, sh));
    }
}

/* ---- upsampling (jdsample.c) ------------------------------------------- */

static inline int clampi(int v, int lo, int hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

/* One component's samples (dh x dw, row stride `stride`) to the full
 * image (height x width, dense). The fancy filters read the rows above
 * and below across iMCU rows and repeat the edge rows and columns, as
 * libjpeg's context buffers do; their +1/+2 and +8/+7 biases alternate. */
static void upsample(const uint8_t *in, ptrdiff_t stride, int dw, int dh,
                     int hx, int vx, uint8_t *out, int width, int height)
{
    if (hx == 1 && vx == 1) {
        for (int y = 0; y < height; y++)
            memcpy(out + (size_t)y * width, in + y * stride, (size_t)width);
        return;
    }
    if (hx == 2 && vx == 1 && dw > 2) { /* h2v1_fancy_upsample */
        for (int y = 0; y < height; y++) {
            const uint8_t *r = in + y * stride;
            uint8_t *o = out + (size_t)y * width;
            for (int x = 0; x < width; x++) {
                int i = x >> 1;
                int n = clampi((x & 1) ? i + 1 : i - 1, 0, dw - 1);
                o[x] = (uint8_t)((3 * r[i] + r[n] + 1 + (x & 1)) >> 2);
            }
        }
        return;
    }
    if (hx == 1 && vx == 2) { /* h1v2_fancy_upsample */
        for (int y = 0; y < height; y++) {
            int i = y >> 1;
            int n = clampi((y & 1) ? i + 1 : i - 1, 0, dh - 1);
            const uint8_t *r0 = in + i * stride, *r1 = in + n * stride;
            uint8_t *o = out + (size_t)y * width;
            int bias = 1 + (y & 1);
            for (int x = 0; x < width; x++)
                o[x] = (uint8_t)((3 * r0[x] + r1[x] + bias) >> 2);
        }
        return;
    }
    if (hx == 2 && vx == 2 && dw > 2) { /* h2v2_fancy_upsample */
        int *cs = (int *)malloc(sizeof(int) * (size_t)dw);
        for (int y = 0; y < height; y++) {
            int i = y >> 1;
            int n = clampi((y & 1) ? i + 1 : i - 1, 0, dh - 1);
            const uint8_t *r0 = in + i * stride, *r1 = in + n * stride;
            for (int x = 0; x < dw; x++)
                cs[x] = 3 * r0[x] + r1[x];
            uint8_t *o = out + (size_t)y * width;
            for (int x = 0; x < width; x++) {
                int j = x >> 1;
                if (x & 1)
                    o[x] = (uint8_t)((3 * cs[j] + cs[clampi(j + 1, 0, dw - 1)]
                                      + 7) >> 4);
                else
                    o[x] = (uint8_t)((3 * cs[j] + cs[clampi(j - 1, 0, dw - 1)]
                                      + 8) >> 4);
            }
        }
        free(cs);
        return;
    }
    /* int_upsample, and h2v1/h2v2_upsample for rows of 2 samples or fewer */
    for (int y = 0; y < height; y++) {
        const uint8_t *r = in + (y / vx) * stride;
        uint8_t *o = out + (size_t)y * width;
        for (int x = 0; x < width; x++)
            o[x] = r[x / hx];
    }
}

/* ---- colour conversion (jdcolor.c) ------------------------------------- */

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

/* ycc_rgb_convert's tables as functions of the centred chroma x:
 * Cr=>R and Cb=>B rounded, Cr=>G and Cb=>G (with ONE_HALF) scaled up */
static inline int cr_r(int cr)
{
    return (FIX(1.40200) * (cr - 128) + ONE_HALF) >> SCALEBITS;
}

static inline int cb_b(int cb)
{
    return (FIX(1.77200) * (cb - 128) + ONE_HALF) >> SCALEBITS;
}

static inline int cbcr_g(int cb, int cr)
{
    return (-FIX(0.34414) * (cb - 128) + ONE_HALF - FIX(0.71414) * (cr - 128))
           >> SCALEBITS;
}

static inline uint8_t lim(int v)
{
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

enum { CS_GRAY, CS_YCC, CS_RGB, CS_CMYK, CS_YCCK };

/* coefs, comp: as for jpeg_entropy; quant: 64 int16 per component in
 * natural order (the table latched at the component's first scan, as
 * libjpeg casts it); hmax, vmax: the largest sampling factors; color: one
 * of CS_*; out: height x width x (1, 3 or 4) bytes: gray, RGB, or CMYK
 * as libjpeg outputs it. Returns 0, or -1 for a sampling ratio that is
 * not an integer. */
int jpeg_pixels(int16_t *const *coefs, const int32_t *comp, int ncomp,
                const int16_t *quant, int width, int height, int hmax,
                int vmax, int color, uint8_t *out)
{
    for (int c = 0; c < ncomp; c++) {
        const int32_t *g = comp + C_WORDS * c;
        if (hmax % g[C_H] || vmax % g[C_V])
            return -1;
    }
    size_t npix = (size_t)width * height;
    uint8_t *full = (uint8_t *)malloc(npix * (size_t)ncomp);
    for (int c = 0; c < ncomp; c++) {
        const int32_t *g = comp + C_WORDS * c;
        int wib = g[C_WIB], hib = g[C_HIB];
        ptrdiff_t stride = (ptrdiff_t)wib * 8;
        uint8_t *plane = (uint8_t *)malloc((size_t)stride * hib * 8);
        for (int by = 0; by < hib; by++)
            for (int bx = 0; bx < wib; bx++)
                idct_islow(coefs[c] + ((size_t)by * g[C_BW] + bx) * 64,
                           quant + 64 * c, plane + by * 8 * stride + bx * 8,
                           stride);
        int dw = (int)(((int64_t)width * g[C_H] + hmax - 1) / hmax);
        int dh = (int)(((int64_t)height * g[C_V] + vmax - 1) / vmax);
        upsample(plane, stride, dw, dh, hmax / g[C_H], vmax / g[C_V],
                 full + npix * c, width, height);
        free(plane);
    }
    const uint8_t *p0 = full, *p1 = full + npix, *p2 = full + 2 * npix,
                  *p3 = full + 3 * npix;
    switch (color) {
    case CS_GRAY:
        memcpy(out, p0, npix);
        break;
    case CS_RGB:
        for (size_t i = 0; i < npix; i++) {
            out[3 * i] = p0[i];
            out[3 * i + 1] = p1[i];
            out[3 * i + 2] = p2[i];
        }
        break;
    case CS_YCC:
        for (size_t i = 0; i < npix; i++) {
            int y = p0[i], cb = p1[i], cr = p2[i];
            out[3 * i] = lim(y + cr_r(cr));
            out[3 * i + 1] = lim(y + cbcr_g(cb, cr));
            out[3 * i + 2] = lim(y + cb_b(cb));
        }
        break;
    case CS_CMYK:
        for (size_t i = 0; i < npix; i++) {
            out[4 * i] = p0[i];
            out[4 * i + 1] = p1[i];
            out[4 * i + 2] = p2[i];
            out[4 * i + 3] = p3[i];
        }
        break;
    case CS_YCCK:
        for (size_t i = 0; i < npix; i++) {
            int y = p0[i], cb = p1[i], cr = p2[i];
            out[4 * i] = lim(255 - (y + cr_r(cr)));
            out[4 * i + 1] = lim(255 - (y + cbcr_g(cb, cr)));
            out[4 * i + 2] = lim(255 - (y + cb_b(cb)));
            out[4 * i + 3] = p3[i];
        }
        break;
    }
    free(full);
    return 0;
}
