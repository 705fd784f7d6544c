/* AV1 film grain synthesis (spec 7.18.3) for the port's AVIF reader
 * (oavif_tpu_torch/io/avif.py), on the planes after the post-filters
 * (av1_postfilter.c), in place:
 *
 * - the grain templates: a 73x82 luma block and 73x82, 38x44 or 73x44
 *   chroma blocks of Gaussian samples (the caller's Gaussian_Sequence,
 *   av1_tool_tables.npz) drawn by the 16-bit register, then the
 *   auto-regressive filter of lag 0-3, chroma taking the collocated luma
 *   grain as one more tap;
 * - the noise: per 32x32 luma block an 8-bit random offset into each
 *   template, the blocks overlapped across their 2-sample (1 for
 *   subsampled chroma) seams where overlap_flag says;
 * - the blend: each sample plus its noise scaled by the piecewise-linear
 *   scaling function of the sample (luma) or of the luma and chroma mix,
 *   clipped to the full or the restricted range.
 *
 * The frame is done one 32-row stripe at a time: the chroma rows of a
 * stripe read only its own luma rows, before the luma noise is added.
 *
 * Built into the host library beside the tile decoder (av1/entropy/fast.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "av1_header.h"

static inline int gmin(int a, int b) { return a < b ? a : b; }
static inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
static inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }

/* spec get_random_number */
static int random_number(int *reg, int bits) {
    int r = *reg;
    int bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    r = (r >> 1) | (bit << 15);
    *reg = r;
    return (r >> (16 - bits)) & ((1 << bits) - 1);
}

enum { GH = 73, GW = 82 };

typedef struct {
    int bd, ssx, ssy, nplanes, grain_min, grain_max; /* GrainMin, GrainMax */
    int luma[GH][GW], cb[GH][GW], cr[GH][GW];
    int lut[3][256];
} Grain;

/* spec generate_grain */
static void generate_grain(Grain *s, const int32_t *g, const int16_t *gauss) {
    int num_y = g[G_NUM_Y], cfl = g[G_CHROMA_FROM_LUMA];
    int lag = g[G_AR_LAG], ar_shift = g[G_AR_SHIFT];
    int shift = 12 - s->bd + g[G_SCALE_SHIFT];
    int reg = g[G_SEED];
    for (int y = 0; y < GH; y++)
        for (int x = 0; x < GW; x++)
            s->luma[y][x] = num_y ? round2(gauss[random_number(&reg, 11)], shift) : 0;
    if (num_y)
        for (int y = 3; y < GH; y++)
            for (int x = 3; x < GW - 3; x++) {
                int sum = 0, pos = 0;
                for (int dr = -lag; dr <= 0; dr++)
                    for (int dc = -lag; dc <= lag; dc++) {
                        if (!dr && !dc) break;
                        sum += s->luma[y + dr][x + dc] * g[G_AR_Y + pos++];
                    }
                s->luma[y][x] = clip3(s->grain_min, s->grain_max, s->luma[y][x] + round2(sum, ar_shift));
            }
    if (s->nplanes == 1) return;
    int ch = s->ssy ? 38 : GH, cw = s->ssx ? 44 : GW;
    int use[2] = {g[G_NUM_CB] || cfl, g[G_NUM_CR] || cfl};
    int (*c[2])[GW] = {s->cb, s->cr};
    const int seeds[2] = {0xb524, 0x49d8};
    for (int k = 0; k < 2; k++) {
        reg = g[G_SEED] ^ seeds[k];
        for (int y = 0; y < ch; y++)
            for (int x = 0; x < cw; x++)
                c[k][y][x] = use[k] ? round2(gauss[random_number(&reg, 11)], shift) : 0;
    }
    for (int y = 3; y < ch; y++)
        for (int x = 3; x < cw - 3; x++) {
            int sum[2] = {0, 0}, pos = 0;
            for (int dr = -lag; dr <= 0; dr++)
                for (int dc = -lag; dc <= lag; dc++) {
                    if (!dr && !dc) {
                        if (num_y) {
                            int l = 0, ly = ((y - 3) << s->ssy) + 3, lx = ((x - 3) << s->ssx) + 3;
                            for (int i = 0; i <= s->ssy; i++)
                                for (int j = 0; j <= s->ssx; j++) l += s->luma[ly + i][lx + j];
                            l = round2(l, s->ssx + s->ssy);
                            sum[0] += l * g[G_AR_CB + pos];
                            sum[1] += l * g[G_AR_CR + pos];
                        }
                        break;
                    }
                    sum[0] += s->cb[y + dr][x + dc] * g[G_AR_CB + pos];
                    sum[1] += s->cr[y + dr][x + dc] * g[G_AR_CR + pos];
                    pos++;
                }
            for (int k = 0; k < 2; k++)
                if (use[k])
                    c[k][y][x] = clip3(s->grain_min, s->grain_max, c[k][y][x] + round2(sum[k], ar_shift));
        }
}

/* spec scaling_lookup_init: the piecewise-linear scaling of each plane */
static void scaling_init(Grain *s, const int32_t *g) {
    for (int p = 0; p < s->nplanes; p++) {
        int n, vo, so;
        if (p == 0 || g[G_CHROMA_FROM_LUMA]) { n = g[G_NUM_Y]; vo = G_Y_VALUE; so = G_Y_SCALING; }
        else if (p == 1) { n = g[G_NUM_CB]; vo = G_CB_VALUE; so = G_CB_SCALING; }
        else { n = g[G_NUM_CR]; vo = G_CR_VALUE; so = G_CR_SCALING; }
        int *lut = s->lut[p];
        if (!n) { memset(lut, 0, sizeof(s->lut[p])); continue; }
        const int32_t *v = g + vo, *sc = g + so;
        for (int i = 0; i < v[0]; i++) lut[i] = sc[0];
        for (int i = 0; i < n - 1; i++) {
            int dy = sc[i + 1] - sc[i], dx = v[i + 1] - v[i];
            int delta = dy * ((65536 + (dx >> 1)) / dx);
            for (int x = 0; x < dx; x++) lut[v[i] + x] = sc[i] + ((x * delta + 32768) >> 16);
        }
        for (int i = v[n - 1]; i < 256; i++) lut[i] = sc[n - 1];
    }
}

/* spec scale_lut */
static inline int scale_lut(const Grain *s, int p, int index) {
    int shift = s->bd - 8, x = index >> shift, rem = index - (x << shift);
    if (s->bd == 8 || x == 255) return s->lut[p][x];
    int a = s->lut[p][x], b = s->lut[p][x + 1];
    return a + round2((b - a) * rem, shift);
}

/* Adds the grain of pack g (G_*) to planes (int32, the given stride, the
 * visible H_UPSCALED_WIDTH x H_HEIGHT of each at its subsampling).
 * Returns 0, or 2 when out of memory. */
int av1_film_grain(int32_t *const *planes, int stride, const int32_t *hdr,
                   const int32_t *g, const int16_t *gauss, int32_t *counts) {
    Grain *s = (Grain *)calloc(1, sizeof(Grain));
    if (!s) return 2;
    s->bd = hdr[H_BITDEPTH];
    s->nplanes = hdr[H_NPLANES];
    s->ssx = hdr[H_SS_X];
    s->ssy = hdr[H_SS_Y];
    s->grain_min = -(128 << (s->bd - 8));
    s->grain_max = (256 << (s->bd - 8)) - 1 - (128 << (s->bd - 8));
    int fw = hdr[H_UPSCALED_WIDTH], fh = hdr[H_HEIGHT];
    generate_grain(s, g, gauss);
    scaling_init(s, g);
    int overlap = g[G_OVERLAP];
    /* two stripes of noise: 34 rows (17 subsampled) of each plane, wide
     * enough for the last 32-column block and its overhang */
    int sw = 2 * (((fw + 1) / 2 + 15) / 16 * 16) + 34;
    size_t plane_sz = (size_t)34 * sw;
    int32_t *stripes = (int32_t *)calloc(2 * 3 * plane_sz, sizeof(int32_t));
    if (!stripes) { free(s); return 2; }
    int bd = s->bd, maxv = (1 << bd) - 1;
    int minv = 0, max_luma = maxv, max_chroma = maxv;
    if (g[G_CLIP_RESTRICTED]) {
        minv = 16 << (bd - 8);
        max_luma = 235 << (bd - 8);
        max_chroma = g[G_MC_IDENTITY] ? max_luma : 240 << (bd - 8);
    }
    int sshift = g[G_SCALING_SHIFT];
    int nstripes = ((fh + 1) / 2 + 15) / 16;
    int cw = (fw + s->ssx) >> s->ssx, ch = (fh + s->ssy) >> s->ssy;
    for (int n = 0; n < nstripes; n++) {
        int32_t *cur = stripes + (size_t)(n & 1) * 3 * plane_sz;
        int32_t *prev = stripes + (size_t)((n + 1) & 1) * 3 * plane_sz;
        /* spec add_noise, one stripe: the blocks' offsets and seams */
        int reg = g[G_SEED];
        reg ^= ((n * 37 + 178) & 255) << 8;
        reg ^= (n * 173 + 105) & 255;
        for (int x = 0; x < (fw + 1) / 2; x += 16) {
            int rnd = random_number(&reg, 8);
            int ox = rnd >> 4, oy = rnd & 15;
            for (int p = 0; p < s->nplanes; p++) {
                int psx = p ? s->ssx : 0, psy = p ? s->ssy : 0;
                int pox = psx ? 6 + ox : 9 + ox * 2, poy = psy ? 6 + oy : 9 + oy * 2;
                int (*tmpl)[GW] = p == 0 ? s->luma : (p == 1 ? s->cb : s->cr);
                int32_t *st = cur + (size_t)p * plane_sz;
                for (int i = 0; i < (34 >> psy); i++)
                    for (int j = 0; j < (34 >> psx); j++) {
                        int v = tmpl[poy + i][pox + j];
                        int col = psx ? x + j : x * 2 + j;
                        int32_t *o = st + (size_t)i * sw + col;
                        if (!psx && j < 2 && overlap && x > 0)
                            v = clip3(s->grain_min, s->grain_max,
                                      round2(j ? *o * 17 + v * 27 : *o * 27 + v * 17, 5));
                        else if (psx && j == 0 && overlap && x > 0)
                            v = clip3(s->grain_min, s->grain_max, round2(*o * 23 + v * 22, 5));
                        *o = v;
                    }
            }
        }
        /* the stripe's rows of each plane, overlapped with the stripe
         * above, then blended: chroma first, from the luma before its noise */
        int noise_at[3];
        for (int p = s->nplanes - 1; p >= 0; p--) {
            int psx = p ? s->ssx : 0, psy = p ? s->ssy : 0;
            int pw = p ? cw : fw, ph = p ? ch : fh;
            int rows = 32 >> psy;
            int use = p == 0 ? g[G_NUM_Y] > 0
                    : (p == 1 ? g[G_NUM_CB] || g[G_CHROMA_FROM_LUMA]
                              : g[G_NUM_CR] || g[G_CHROMA_FROM_LUMA]);
            noise_at[p] = use;
            if (!use) continue;
            const int32_t *st = cur + (size_t)p * plane_sz;
            const int32_t *pst = prev + (size_t)p * plane_sz;
            int mult = 0, lmult = 0, offset = 0;
            if (p) {
                mult = g[p == 1 ? G_CB_MULT : G_CR_MULT] - 128;
                lmult = g[p == 1 ? G_CB_LUMA_MULT : G_CR_LUMA_MULT] - 128;
                offset = (g[p == 1 ? G_CB_OFFSET : G_CR_OFFSET] - 256) << (bd - 8);
            }
            for (int i = 0; i < rows; i++) {
                int y = n * rows + i;
                if (y >= ph) break;
                int32_t *row = planes[p] + (size_t)y * stride;
                const int32_t *luma = planes[0] + (size_t)(y << psy) * stride;
                for (int x = 0; x < pw; x++) {
                    int v = st[(size_t)i * sw + x];
                    if (overlap && n > 0) {
                        if (!psy && i < 2) {
                            int old = pst[(size_t)(i + 32) * sw + x];
                            v = clip3(s->grain_min, s->grain_max,
                                      round2(i ? old * 17 + v * 27 : old * 27 + v * 17, 5));
                        } else if (psy && i < 1) {
                            int old = pst[(size_t)(i + 16) * sw + x];
                            v = clip3(s->grain_min, s->grain_max, round2(old * 23 + v * 22, 5));
                        }
                    }
                    int orig = row[x];
                    if (p == 0) {
                        int noise = round2(scale_lut(s, 0, orig) * v, sshift);
                        row[x] = clip3(minv, max_luma, orig + noise);
                        continue;
                    }
                    int lx = x << psx;
                    int avg = psx ? round2(luma[lx] + luma[gmin(lx + 1, fw - 1)], 1) : luma[lx];
                    int merged = avg;
                    if (!g[G_CHROMA_FROM_LUMA])
                        merged = clip3(0, maxv, ((avg * lmult + orig * mult) >> 6) + offset);
                    int noise = round2(scale_lut(s, p, merged) * v, sshift);
                    row[x] = clip3(minv, max_chroma, orig + noise);
                }
            }
        }
        if (n == 0)
            for (int p = 0; p < s->nplanes; p++) counts[T_FILM_GRAIN] += noise_at[p];
    }
    free(stripes);
    free(s);
    return 0;
}
