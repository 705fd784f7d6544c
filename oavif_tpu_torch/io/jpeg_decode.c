/* JPEG decoding work for the port's reader (oavif_tpu_torch/io/jpeg.py):
 * the entropy decode of baseline, extended-sequential and progressive
 * scans, Huffman- or arithmetic-coded, into coefficient arrays, then
 * dequantization, the integer inverse DCT, upsampling and colour
 * conversion to interleaved 8-bit samples. Every stage follows
 * libjpeg-turbo's default decompression (JDCT_ISLOW, fancy upsampling,
 * block smoothing of progressive files), so the samples are the ones
 * libjpeg-turbo gives: jdhuff.c and jdphuff.c for the Huffman scans,
 * jdarith.c for the arithmetic ones, jdcoefct.c for the smoothing,
 * jidctint.c for the IDCT, jdsample.c for the upsampling, jdcolor.c for
 * the colour conversion. It is built into the host library beside the
 * tile coder (av1/entropy/fast.py).
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

/* One scan's descriptor (int32 words); S_COND: an arithmetic scan's
 * conditioning per member, L | U << 4 | K << 8 (the DAC values) */
enum { S_OFF, S_LEN, S_NCOMP, S_COMP, S_DC = S_COMP + 4, S_AC = S_DC + 4,
       S_SS = S_AC + 4, S_SE, S_AH, S_AL, S_RI, S_COND, S_WORDS = 24 };

/* One component's geometry (int32 words): sampling factors, the
 * allocated width in blocks (the row stride of its coefficient array),
 * the width and height in blocks that hold image samples, and the
 * allocated height in blocks (whole iMCU rows) */
enum { C_H, C_V, C_BW, C_WIB, C_HIB, C_BH, C_WORDS = 8 };

typedef struct {
    const uint8_t *p, *end;
    uint64_t buf;
    int bits;
    int marker;       /* a marker (or the segment's end) stopped the input */
    int insufficient; /* the data ran out inside this restart interval */
    int open;         /* the data ends here with no marker after it */
    int suspended;    /* libjpeg would have had to wait for more data */
} Bits;

/* The reader ran into the end of data that no marker ends: libjpeg's
 * suspending source returns, and Pillow, which has no more bytes to
 * give, raises. Zeros follow so the scan runs out quickly. */
static void suspend(Bits *b)
{
    b->suspended = 1;
    b->marker = 1;
}

/* Load bytes until 57 bits are held or a marker is reached: 0xFF 0x00 is
 * a 0xFF byte, 0xFF fill bytes before a marker are skipped, and the
 * reader then stays at the marker's first 0xFF. As in libjpeg's
 * jpeg_fill_bit_buffer, a fill that meets the end of open data suspends
 * even when the bits asked for are already held. */
static void fill(Bits *b)
{
    while (b->bits <= 56 && !b->marker) {
        if (b->p >= b->end) {
            if (b->open)
                suspend(b);
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
                if (q >= b->end && b->open)
                    suspend(b);
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

static inline int peek_code(const Bits *b, const int32_t *t)
{
    int have = b->bits;
    int peek;
    if (have >= LOOK_BITS)
        peek = (int)((b->buf >> (have - LOOK_BITS)) & ((1 << LOOK_BITS) - 1));
    else
        peek = (int)((b->buf << (LOOK_BITS - have)) & ((1 << LOOK_BITS) - 1));
    return t[HT_LOOK + peek];
}

/* libjpeg-turbo looks 8 bits ahead (HUFF_DECODE): it refills below 8
 * bits, and below 9 for a longer code (jpeg_huff_decode's first
 * CHECK_BIT_BUFFER); the 9-bit table here decodes the same symbols, and
 * the refills are libjpeg's, so the data runs out where it does. */
static int huff_decode(Bits *b, const int32_t *t)
{
    if (b->bits < 8)
        fill(b);
    int e = peek_code(b, t);
    if ((!e || (e >> 8) > 8) && b->bits < 9) {
        fill(b);
        e = peek_code(b, t);
    }
    int have = b->bits;
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
        if (q >= b->end && b->open)
            suspend(b); /* next_marker met the end of the data */
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
                       const int32_t *sc, int progressive, int open)
{
    Bits b = {data + sc[S_OFF], data + sc[S_OFF] + sc[S_LEN], 0, 0, 0, 0,
              open, 0};
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
    return b.suspended ? -2 : 0;
}

/* ---- arithmetic decoding (ITU T.81 Annex D, F.2.4 and G.1.3; jdarith.c) */

/* Table D.2, packed as libjpeg packs it: Qe << 16 | Next_Index_MPS << 8 |
 * Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate of
 * 0.5 that codes the sign of an AC coefficient and each refinement bit */
#define V(qe, nlps, nmps, sw) \
    (((int32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
static const int32_t ARITAB[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0), V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0), V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0), V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0), V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0), V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0), V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0), V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0), V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0), V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0), V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0), V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0), V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0), V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0), V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0), V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0), V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

#define DC_STAT_BINS 64
#define AC_STAT_BINS 256
#define FIXED_BIN 113

typedef struct {
    const uint8_t *p, *end;
    int64_t c;  /* base of the coding interval, with the input bits */
    int64_t a;  /* the interval's size, normalised */
    int ct;     /* bits left in c's buffer; -16 before the first two bytes,
                   -1 after a coding error (the interval decodes nothing) */
    int marker; /* a marker stopped the input: zeros follow */
    int open;   /* the data ends here with no marker after it */
    int broken; /* a byte was read past the end of open data */
} Arith;

/* The reader met the segment's end: zeros follow, and where no marker
 * ends the data, libjpeg would have wanted a byte that is not there */
static void arith_end_marker(Arith *e)
{
    e->broken |= e->open;
    e->marker = 1;
}

/* jdarith's get_byte cannot suspend: a byte wanted past the end of open
 * data is an error (JERR_CANT_SUSPEND), which Pillow raises */
static int arith_byte(Arith *e)
{
    if (e->marker)
        return 0;
    if (e->p >= e->end) {
        arith_end_marker(e);
        return 0;
    }
    int data = *e->p;
    if (data != 0xFF) {
        e->p++;
        return data;
    }
    const uint8_t *q = e->p + 1;
    while (q < e->end && *q == 0xFF)
        q++;
    if (q < e->end && *q == 0x00) {
        e->p = q + 1;
        return 0xFF;
    }
    if (q >= e->end) {
        arith_end_marker(e);
        return 0;
    }
    e->marker = 1; /* the reader stays at the marker's first 0xFF */
    return 0;
}

/* One binary decision in the statistics bin st (D.2.4-D.2.6) */
static int arith_decode(Arith *e, uint8_t *st)
{
    while (e->a < 0x8000) {
        if (--e->ct < 0) {
            e->c = (e->c << 8) | arith_byte(e);
            if ((e->ct += 8) < 0 && ++e->ct == 0)
                e->a = 0x8000; /* two initial bytes read: 0x10000 below */
        }
        e->a <<= 1;
    }
    int sv = *st;
    int32_t qe = ARITAB[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* libjpeg's next_marker from the reader's position: skip to an 0xFF that
 * starts a marker; step over it when it is RSTn */
static void arith_restart(Arith *e)
{
    const uint8_t *q = e->p;
    for (;;) {
        while (q < e->end && *q != 0xFF)
            q++;
        while (q < e->end && *q == 0xFF)
            q++;
        if (q >= e->end || *q != 0x00)
            break;
        q++;
    }
    if (q < e->end && *q >= 0xD0 && *q <= 0xD7) {
        e->p = q + 1;
        e->marker = 0;
    } else {
        if (q >= e->end)
            arith_end_marker(e);
        e->p = e->end;
        e->marker = 1;
    }
    e->c = 0;
    e->a = 0;
    e->ct = -16;
}

/* Decode_DC_DIFF (F.19-F.24) in the component's DC bins; updates its
 * conditioning context; returns the difference */
static int arith_dc_diff(Arith *e, uint8_t *dc, int *context, int L, int U)
{
    uint8_t *st = dc + *context;
    if (arith_decode(e, st) == 0) {
        *context = 0;
        return 0;
    }
    int sign = arith_decode(e, st + 1);
    st += 2 + sign;
    int m = arith_decode(e, st);
    if (m) {
        st = dc + 20;
        while (arith_decode(e, st)) {
            if ((m <<= 1) == 0x8000) {
                e->ct = -1; /* magnitude overflow */
                return 0;
            }
            st++;
        }
    }
    if (m < (int)((1L << L) >> 1))
        *context = 0;
    else if (m > (int)((1L << U) >> 1))
        *context = 12 + sign * 4;
    else
        *context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(e, st))
            v |= m;
    v += 1;
    return sign ? -v : v;
}

/* One nonzero AC value at zigzag index k (F.21-F.24 with F.20's bins
 * at st); returns 0 with ct = -1 on a magnitude overflow */
static int arith_ac_value(Arith *e, uint8_t *ac, uint8_t *st, int k, int K,
                          uint8_t *fixed)
{
    int sign = arith_decode(e, fixed);
    st += 2;
    int m = arith_decode(e, st);
    if (m && arith_decode(e, st)) {
        m <<= 1;
        st = ac + (k <= K ? 189 : 217);
        while (arith_decode(e, st)) {
            if ((m <<= 1) == 0x8000) {
                e->ct = -1;
                return 0;
            }
            st++;
        }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(e, st))
            v |= m;
    v += 1;
    return sign ? -v : v;
}

/* Decode one arithmetic-coded scan: jdarith's sequential MCU, or its four
 * progressive procedures. The scan's S_DC and S_AC words hold the
 * conditioning table slots, S_COND each member's L | U << 4 | K << 8. */
static int decode_scan_arith(const Frame *f, const uint8_t *data,
                             const int32_t *sc, int progressive, int open)
{
    Arith e = {data + sc[S_OFF], data + sc[S_OFF] + sc[S_LEN], 0, 0, -16,
               0, open, 0};
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
    uint8_t dc_stats[16][DC_STAT_BINS], ac_stats[16][AC_STAT_BINS];
    uint8_t fixed = FIXED_BIN;
    int uses_dc = !progressive || (ss == 0 && ah == 0);
    int uses_ac = !progressive || ss > 0;
    int last_dc[4], context[4];
    int togo = ri;
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    Mcu m;
    for (int my = 0; my < rows; my++)
        for (int mx = 0; mx < cols; mx++) {
            /* statistics and predictions start over at the scan's start
             * and at every restart marker */
            int fresh = my == 0 && mx == 0;
            if (ri) {
                if (togo == 0) {
                    arith_restart(&e);
                    fresh = 1;
                    togo = ri;
                }
                togo--;
            }
            if (fresh) {
                for (int s = 0; s < ns; s++) {
                    if (uses_dc) {
                        memset(dc_stats[sc[S_DC + s]], 0, DC_STAT_BINS);
                        last_dc[s] = 0;
                        context[s] = 0;
                    }
                    if (uses_ac)
                        memset(ac_stats[sc[S_AC + s]], 0, AC_STAT_BINS);
                }
            }
            if (!mcu_blocks(f, sc, mx, my, &m))
                return -1;
            if (e.ct == -1)
                continue; /* after a coding error: nothing until a restart */
            if (progressive && ss == 0 && ah) { /* DC refinement */
                for (int k0 = 0; k0 < m.n; k0++)
                    if (arith_decode(&e, &fixed))
                        m.blk[k0][0] = (int16_t)(m.blk[k0][0] | p1);
                continue;
            }
            if (!progressive || ss == 0) {
                for (int k0 = 0; k0 < m.n; k0++) {
                    int16_t *blk = m.blk[k0];
                    int c = m.ci[k0];
                    int cond = sc[S_COND + c];
                    int v = arith_dc_diff(&e, dc_stats[sc[S_DC + c]],
                                          &context[c], cond & 15,
                                          (cond >> 4) & 15);
                    if (e.ct == -1)
                        break;
                    last_dc[c] = (last_dc[c] + v) & 0xFFFF;
                    blk[0] = (int16_t)((unsigned)last_dc[c] << al);
                    if (progressive)
                        continue;
                    uint8_t *ac = ac_stats[sc[S_AC + c]];
                    int K = cond >> 8;
                    for (int k = 1; k <= 63; k++) {
                        uint8_t *st = ac + 3 * (k - 1);
                        if (arith_decode(&e, st))
                            break; /* EOB */
                        while (arith_decode(&e, st + 1) == 0) {
                            st += 3;
                            if (++k >= 64) {
                                e.ct = -1; /* spectral overflow */
                                break;
                            }
                        }
                        if (e.ct == -1)
                            break;
                        v = arith_ac_value(&e, ac, st, k, K, &fixed);
                        if (e.ct == -1)
                            break;
                        blk[NATURAL[k]] = (int16_t)v;
                    }
                    if (e.ct == -1)
                        break;
                }
                continue;
            }
            int16_t *blk = m.blk[0];
            uint8_t *ac = ac_stats[sc[S_AC]];
            int K = sc[S_COND] >> 8;
            if (ah == 0) { /* AC first */
                for (int k = ss; k <= se; k++) {
                    uint8_t *st = ac + 3 * (k - 1);
                    if (arith_decode(&e, st))
                        break;
                    while (arith_decode(&e, st + 1) == 0) {
                        st += 3;
                        if (++k > se) {
                            e.ct = -1;
                            break;
                        }
                    }
                    if (e.ct == -1)
                        break;
                    int v = arith_ac_value(&e, ac, st, k, K, &fixed);
                    if (e.ct == -1)
                        break;
                    blk[NATURAL[k]] = (int16_t)((unsigned)v << al);
                }
                continue;
            }
            /* AC refinement: EOBx is the previous stage's end of block */
            int kex = se;
            for (; kex > 0; kex--)
                if (blk[NATURAL[kex]])
                    break;
            for (int k = ss; k <= se; k++) {
                uint8_t *st = ac + 3 * (k - 1);
                if (k > kex && arith_decode(&e, st))
                    break;
                for (;;) {
                    int16_t *coef = blk + NATURAL[k];
                    if (*coef) {
                        if (arith_decode(&e, st + 2))
                            *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
                        break;
                    }
                    if (arith_decode(&e, st + 1)) {
                        *coef = (int16_t)(arith_decode(&e, &fixed) ? m1 : p1);
                        break;
                    }
                    st += 3;
                    if (++k > se) {
                        e.ct = -1;
                        break;
                    }
                }
                if (e.ct == -1)
                    break;
            }
        }
    return e.broken ? -3 : 0;
}

/* ---- lossless scans (ITU T.81 Annex H; jdlhuff.c, jdlossls.c, jddiffct.c) */

/* One row of a component's samples from its differences: the first row
 * of the scan and of each restart interval from the sample to its left
 * (its first sample from `init`), the other rows by the scan's predictor
 * from the row above, their first sample from the sample above. Sums
 * wrap at 16 bits, as libjpeg-turbo's undifferencer does. */
static void undifference(const int32_t *diff, const uint16_t *prev,
                         uint16_t *cur, int width, int psv, int first,
                         int init)
{
    int ra, rb, rc;
    if (first) {
        ra = (diff[0] + init) & 0xFFFF;
        cur[0] = (uint16_t)ra;
        for (int x = 1; x < width; x++) {
            ra = (diff[x] + ra) & 0xFFFF;
            cur[x] = (uint16_t)ra;
        }
        return;
    }
    rb = prev[0];
    ra = (diff[0] + rb) & 0xFFFF;
    cur[0] = (uint16_t)ra;
    for (int x = 1; x < width; x++) {
        rc = rb;
        rb = prev[x];
        int p;
        switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
        }
        ra = (diff[x] + p) & 0xFFFF;
        cur[x] = (uint16_t)ra;
    }
}

/* Decode one lossless Huffman scan (predictor S_SS, point transform
 * S_AL) into its components' sample planes, which hold one int16 sample
 * per position (row stride C_BW). An MCU holds C_H x C_V samples of each
 * member of an interleaved scan, one sample of a single component's.
 * Restart intervals are whole MCU rows (the caller checks it). Where the
 * data ran out before an MCU row, its differences are zero. Either starts
 * the first-row prediction again, and, as in libjpeg-turbo, which
 * undifferences a whole iMCU row once it is decoded, at the first row of
 * the iMCU row: a single component's scan has C_V MCU rows in one. */
static int decode_scan_lossless(const Frame *f, const uint8_t *data,
                                const int32_t *sc, int open)
{
    Bits b = {data + sc[S_OFF], data + sc[S_OFF] + sc[S_LEN], 0, 0, 0, 0,
              open, 0};
    int ns = sc[S_NCOMP];
    int psv = sc[S_SS], pt = sc[S_AL], ri = sc[S_RI];
    int init = 1 << (8 - pt - 1);
    int cols, rows, group;
    const int32_t *g0 = f->comp + C_WORDS * sc[S_COMP];
    if (ns == 1) {
        cols = g0[C_WIB];
        rows = g0[C_HIB];
        group = g0[C_V];
    } else {
        cols = f->mcux;
        rows = f->mcuy;
        group = 1;
    }
    int rows_per_ri = ri ? ri / cols : 0;
    int hs[4], vs[4], first[4];
    int32_t *diff[4];
    uint16_t *prev[4], *cur[4];
    const int32_t *tbl[4];
    for (int s = 0; s < ns; s++) {
        const int32_t *g = f->comp + C_WORDS * sc[S_COMP + s];
        hs[s] = ns == 1 ? 1 : g[C_H];
        vs[s] = ns == 1 ? 1 : g[C_V];
        size_t w = (size_t)cols * hs[s];
        diff[s] = (int32_t *)calloc(w * vs[s] * group, sizeof(int32_t));
        prev[s] = (uint16_t *)calloc(w, sizeof(uint16_t));
        cur[s] = (uint16_t *)calloc(w, sizeof(uint16_t));
        tbl[s] = f->tables + (size_t)HT_WORDS * sc[S_DC + s];
        first[s] = 1;
    }
    int togo = rows_per_ri;
    for (int my0 = 0; my0 < rows; my0 += group) {
        int nrow = rows - my0 < group ? rows - my0 : group;
        int reset = 0;
        for (int k = 0; k < nrow; k++) {
            if (ri) {
                if (togo == 0) {
                    restart(&b);
                    reset = 1;
                    togo = rows_per_ri;
                }
                togo--;
            }
            if (b.insufficient) {
                for (int s = 0; s < ns; s++) {
                    size_t w = (size_t)cols * hs[s] * vs[s];
                    memset(diff[s] + k * w, 0, sizeof(int32_t) * w);
                }
                reset = 1;
                continue;
            }
            for (int mx = 0; mx < cols; mx++)
                for (int s = 0; s < ns; s++) {
                    size_t w = (size_t)cols * hs[s];
                    int32_t *d = diff[s] + k * w * vs[s] + (size_t)mx * hs[s];
                    for (int v = 0; v < vs[s]; v++)
                        for (int h = 0; h < hs[s]; h++) {
                            int t = huff_decode(&b, tbl[s]);
                            int e = 0;
                            if (t == 16) {
                                e = 32768;
                            } else if (t) {
                                e = extend(get_bits(&b, t), t);
                            }
                            d[v * w + h] = e;
                        }
                }
        }
        for (int s = 0; s < ns; s++) {
            const int32_t *g = f->comp + C_WORDS * sc[S_COMP + s];
            int16_t *plane = f->coefs[sc[S_COMP + s]];
            size_t w = (size_t)cols * hs[s];
            if (reset)
                first[s] = 1;
            for (int r = 0; r < nrow * vs[s]; r++) {
                int y = my0 * vs[s] + r;
                if (y >= g[C_HIB])
                    break;
                undifference(diff[s] + r * w, prev[s], cur[s], g[C_WIB],
                             psv, first[s], init);
                first[s] = 0;
                int16_t *row = plane + (size_t)y * g[C_BW];
                for (int x = 0; x < g[C_WIB]; x++)
                    row[x] = (int16_t)(uint8_t)(cur[s][x] << pt);
                uint16_t *t = prev[s];
                prev[s] = cur[s];
                cur[s] = t;
            }
        }
    }
    for (int s = 0; s < ns; s++) {
        free(diff[s]);
        free(prev[s]);
        free(cur[s]);
    }
    return b.suspended ? -2 : 0;
}

/* data: the file; scans: nscans descriptors of S_WORDS int32 (offset and
 * length of the entropy-coded segment, with its RSTn markers, in data);
 * tables: HT_WORDS int32 per Huffman table; coefs: per component, its
 * int16 blocks of 64 coefficients in natural order, zeroed by the caller;
 * comp: C_WORDS int32 per component; mcux, mcuy: MCUs of an interleaved
 * scan; mode: 1 for a progressive frame, | 2 for arithmetic coding, 4
 * for a lossless frame (coefs then hold one sample per position, C_BW to
 * a row), | 8 when the last scan's data is the end of the file, with no
 * marker after it. Returns 0; 1 + the index of a scan with an MCU of
 * more than 10 blocks; -1 where a Huffman scan ran into the end of that
 * data (libjpeg suspends), -2 where an arithmetic one did (libjpeg
 * cannot suspend there and fails). */
int jpeg_entropy(const uint8_t *data, const int32_t *scans, int nscans,
                 const int32_t *tables, int16_t *const *coefs,
                 const int32_t *comp, int mcux, int mcuy, int mode)
{
    Frame f = {coefs, comp, tables, mcux, mcuy};
    int progressive = mode & 1;
    for (int i = 0; i < nscans; i++) {
        const int32_t *sc = scans + (size_t)S_WORDS * i;
        int open = (mode & 8) && i == nscans - 1;
        int rc = mode & 4 ? decode_scan_lossless(&f, data, sc, open)
                 : mode & 2 ? decode_scan_arith(&f, data, sc, progressive,
                                                open)
                            : decode_scan(&f, data, sc, progressive, open);
        if (rc == -1)
            return 1 + i;
        if (rc)
            return rc + 1;
    }
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

/* ---- block smoothing (jdcoefct.c, decompress_smooth_data) --------------- */

static inline int clampi(int v, int lo, int hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}


/* libjpeg's estimate of one coefficient: num / (Q << 8), rounded, its
 * magnitude held below 1 << Al where Al > 0 (clamp) */
static int16_t smooth_pred(int64_t num, int64_t q, int al, int clamp)
{
    int64_t a = num >= 0 ? num : -num;
    int pred = (int)(((q << 7) + a) / (q << 8));
    if (clamp && al > 0 && pred >= (1 << al))
        pred = (1 << al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

/* The first nine AC coefficients of a block (and, where no AC data came
 * at all, its DC) estimated from the DC values d[1..25] of its 5x5
 * neighbourhood (row by row), for each coefficient still zero and not
 * known to full precision; bits: the component's coef_bits[0..9] as the
 * last scan left them; q: its quantization table (natural order). */
static void smooth_block(int16_t *w, const int *d, const int *bits,
                         const int16_t *qt)
{
    int change_dc = 1;
    for (int k = 1; k < 10; k++)
        change_dc &= bits[k] == -1;
    int64_t q00 = (uint16_t)qt[0];
#define Q(pos) ((int64_t)(uint16_t)qt[pos])
#define EST(k, pos, dc_num, ac_num) \
    if (bits[k] != 0 && w[pos] == 0) \
        w[pos] = smooth_pred(q00 * (change_dc ? (int64_t)(dc_num) \
                                              : (int64_t)(ac_num)), \
                             Q(pos), bits[k], 1);
    EST(1, 1,
        -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9]
            + 3 * d[10] - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15]
            - 3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] - d[21]
            - d[22] + d[24] + d[25],
        -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15])
    EST(2, 8,
        -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7]
            + 38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17]
            - 38 * d[18] - 13 * d[19] + d[20] + d[21] + 3 * d[22]
            + 3 * d[23] + 3 * d[24] + d[25],
        -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23])
    EST(3, 16,
        d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13]
            - 5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23],
        -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23])
    EST(4, 9,
        -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21]
            - d[25],
        d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22]
            - d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9])
    EST(5, 2,
        2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13]
            + 7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19],
        -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15])
    if (!change_dc)
        return;
    EST(6, 3, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19], 0)
    EST(7, 10, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19], 0)
    EST(8, 17, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19], 0)
    EST(9, 24, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19], 0)
#undef EST
#undef Q
    int64_t num = q00 * (int64_t)(
        -2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6]
        + 6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11]
        + 42 * d[12] + 152 * d[13] + 42 * d[14] - 8 * d[15] - 6 * d[16]
        + 6 * d[17] + 42 * d[18] + 6 * d[19] - 6 * d[20] - 2 * d[21]
        - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
    w[0] = smooth_pred(num, q00, 0, 0);
}

/* The coefficient rows libjpeg's smoothing reads around block row `row`
 * of a component (its 5 rows, top to bottom): the neighbours' edge tests
 * use the iMCU row's count of block rows, as decompress_smooth_data does,
 * so that count's rows beyond the image (in whole iMCU rows) can be
 * read. */
static void smooth_rows(const int32_t *g, int row, int *r)
{
    int v = g[C_V], total = g[C_BH] / v;
    int imcu = row / v, br = row % v;
    int block_rows = v;
    if (imcu == total - 1) {
        block_rows = g[C_HIB] % v;
        if (block_rows == 0)
            block_rows = v;
    }
    int image_rows = block_rows * total;
    int ibr = imcu * block_rows + br;
    r[2] = row;
    r[1] = ibr > 0 ? row - 1 : row;
    r[0] = ibr > 1 ? row - 2 : r[1];
    r[3] = ibr < image_rows - 1 ? row + 1 : row;
    r[4] = ibr < image_rows - 2 ? row + 2 : r[3];
}

/* ---- upsampling (jdsample.c) ------------------------------------------- */

/* One component's samples (dh x dw, row stride `stride`) to the full
 * image (height x width, dense). The fancy filters read the rows above
 * and below across iMCU rows and repeat the edge rows and columns, as
 * libjpeg's context buffers do; their +1/+2 and +8/+7 biases alternate. */
static void upsample(const uint8_t *in, ptrdiff_t stride, int dw, int dh,
                     int hx, int vx, int fancy, uint8_t *out, int width,
                     int height)
{
    if (hx == 1 && vx == 1) {
        for (int y = 0; y < height; y++)
            memcpy(out + (size_t)y * width, in + y * stride, (size_t)width);
        return;
    }
    if (hx == 2 && vx == 1 && dw > 2 && fancy) { /* h2v1_fancy_upsample */
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
    if (hx == 1 && vx == 2 && fancy) { /* h1v2_fancy_upsample */
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
    if (hx == 2 && vx == 2 && dw > 2 && fancy) { /* h2v2_fancy_upsample */
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
    /* int_upsample, and h2v1/h2v2_upsample for rows of 2 samples or fewer
     * and for lossless frames (libjpeg-turbo upsamples those by boxes) */
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
 * of CS_*; coef_bits: NULL, or, where libjpeg smooths the blocks of a
 * progressive file, 10 int32 per component, its coef_bits[0..9] after the
 * last scan; lossless: the coefs hold a lossless frame's samples
 * (jpeg_entropy's mode 4), which skip the IDCT and are upsampled by
 * boxes; out: height x width x (1, 3 or 4) bytes: gray, RGB, or CMYK as
 * libjpeg outputs it. Returns 0, or -1 for a sampling ratio that is not
 * an integer. */
int jpeg_pixels(int16_t *const *coefs, const int32_t *comp, int ncomp,
                const int16_t *quant, int width, int height, int hmax,
                int vmax, int color, int lossless, const int32_t *coef_bits,
                uint8_t *out)
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
        int dw = (int)(((int64_t)width * g[C_H] + hmax - 1) / hmax);
        int dh = (int)(((int64_t)height * g[C_V] + vmax - 1) / vmax);
        if (lossless) {
            uint8_t *plane = (uint8_t *)malloc((size_t)wib * hib);
            for (size_t i = 0; i < (size_t)wib * hib; i++)
                plane[i] = (uint8_t)coefs[c][(i / wib) * g[C_BW] + i % wib];
            upsample(plane, wib, dw, dh, hmax / g[C_H], vmax / g[C_V], 0,
                     full + npix * c, width, height);
            free(plane);
            continue;
        }
        ptrdiff_t stride = (ptrdiff_t)wib * 8;
        uint8_t *plane = (uint8_t *)malloc((size_t)stride * hib * 8);
        const int16_t *qt = quant + 64 * c;
        int bits[10];
        for (int k = 0; coef_bits && k < 10; k++)
            bits[k] = coef_bits[10 * c + k];
        for (int by = 0; by < hib; by++) {
            const int16_t *row = coefs[c] + (size_t)by * g[C_BW] * 64;
            int r[5];
            if (coef_bits)
                smooth_rows(g, by, r);
            for (int bx = 0; bx < wib; bx++) {
                const int16_t *blk = row + (size_t)bx * 64;
                uint8_t *dst = plane + by * 8 * stride + bx * 8;
                if (!coef_bits) {
                    idct_islow(blk, qt, dst, stride);
                    continue;
                }
                int d[26];
                for (int i = 0; i < 5; i++)
                    for (int j = 0; j < 5; j++) {
                        int x = clampi(bx + j - 2, 0, wib - 1);
                        d[1 + 5 * i + j] =
                            coefs[c][((size_t)r[i] * g[C_BW] + x) * 64];
                    }
                int16_t w[64];
                memcpy(w, blk, sizeof w);
                smooth_block(w, d, bits, qt);
                idct_islow(w, qt, dst, stride);
            }
        }
        upsample(plane, stride, dw, dh, hmax / g[C_H], vmax / g[C_V], 1,
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
