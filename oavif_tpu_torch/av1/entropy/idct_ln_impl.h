/* Lane-batched inverse-DCT cascade, templated over the lane count.
 *
 * Included by oav1ec.c twice (IDCT_LANES = 4 and 8) to instantiate
 * idct_odd_ln{4,8} / idct_ln{4,8}: the SAME arithmetic as idct_1d_c
 * applied to IDCT_LANES independent vectors at once ([element][lane]
 * layout). Per-lane results are bit-identical regardless of the lane
 * count — lanes are independent columns — so the 2D driver picks 8
 * lanes (one zmm of int64) whenever the batched dimension allows and
 * falls back to 4 for the 4px dimension. Define IDCT_LANES,
 * IDCT_ODD_FN and IDCT_FN before inclusion.
 */

static void IDCT_ODD_FN(const int64_t *o, int64_t *s, int N) {
    int h = N / 2;
    int m = 0;
    while ((1 << m) < h) m++;
    for (int i = 0; i < h / 2; i++) {
        int k = 2 * brev_c(m, i) + 1;
        int theta = k * (64 / N);
        const int64_t *a = o + (size_t)((k - 1) / 2) * IDCT_LANES;
        const int64_t *b = o + (size_t)((N - k - 1) / 2) * IDCT_LANES;
        int64_t *s0 = s + (size_t)i * IDCT_LANES;
        int64_t *s1 = s + (size_t)(h - 1 - i) * IDCT_LANES;
        for (int l = 0; l < IDCT_LANES; l++) {
            s0[l] = hb(COSPI[64 - theta], a[l], -COSPI[theta], b[l]);
            s1[l] = hb(COSPI[theta], a[l], COSPI[64 - theta], b[l]);
        }
    }
    int64_t t[32 * IDCT_LANES];
    for (int L = 1; L < m; L++) {
        int gs = 1 << L;
        memcpy(t, s, sizeof(int64_t) * h * IDCT_LANES);
        for (int q = 0; q < h / gs; q++) {
            int base = q * gs;
            for (int j = 0; j < gs / 2; j++) {
                const int64_t *xx = s + (size_t)(base + j) * IDCT_LANES;
                const int64_t *yy =
                    s + (size_t)(base + gs - 1 - j) * IDCT_LANES;
                int64_t *t0 = t + (size_t)(base + j) * IDCT_LANES;
                int64_t *t1 = t + (size_t)(base + gs - 1 - j) * IDCT_LANES;
                if (q % 2 == 0)
                    for (int l = 0; l < IDCT_LANES; l++) {
                        t0[l] = xx[l] + yy[l];
                        t1[l] = xx[l] - yy[l];
                    }
                else
                    for (int l = 0; l < IDCT_LANES; l++) {
                        t0[l] = -xx[l] + yy[l];
                        t1[l] = xx[l] + yy[l];
                    }
            }
        }
        memcpy(s, t, sizeof(int64_t) * h * IDCT_LANES);
        int gr = 1 << (L + 1);
        memcpy(t, s, sizeof(int64_t) * h * IDCT_LANES);
        int unit = 64 >> (m - L);
        for (int i = 0; i < h / 2; i++) {
            int pig = i % gr;
            if (!(gr / 4 <= pig && pig < 3 * gr / 4)) continue;
            int q = i / gr;
            int nb = m - L - 1;
            if (nb < 0) nb = 0;
            int theta = (2 * brev_c(nb, q) + 1) * unit;
            const int64_t *xx = s + (size_t)i * IDCT_LANES;
            const int64_t *yy = s + (size_t)(h - 1 - i) * IDCT_LANES;
            int64_t *t0 = t + (size_t)i * IDCT_LANES;
            int64_t *t1 = t + (size_t)(h - 1 - i) * IDCT_LANES;
            if (pig < gr / 2)
                for (int l = 0; l < IDCT_LANES; l++) {
                    t0[l] =
                        hb(-COSPI[theta], xx[l], COSPI[64 - theta], yy[l]);
                    t1[l] =
                        hb(COSPI[64 - theta], xx[l], COSPI[theta], yy[l]);
                }
            else
                for (int l = 0; l < IDCT_LANES; l++) {
                    t0[l] = hb(-COSPI[64 - theta], xx[l], -COSPI[theta],
                               yy[l]);
                    t1[l] =
                        hb(-COSPI[theta], xx[l], COSPI[64 - theta], yy[l]);
                }
        }
        memcpy(s, t, sizeof(int64_t) * h * IDCT_LANES);
    }
}

static void IDCT_FN(const int64_t *x, int64_t *out, int N) {
    if (N == 4) {
        int64_t s0[IDCT_LANES], s1[IDCT_LANES], s2[IDCT_LANES],
            s3[IDCT_LANES];
        for (int l = 0; l < IDCT_LANES; l++) {
            s0[l] = hb(COSPI[32], x[0 * IDCT_LANES + l], COSPI[32],
                       x[2 * IDCT_LANES + l]);
            s1[l] = hb(COSPI[32], x[0 * IDCT_LANES + l], -COSPI[32],
                       x[2 * IDCT_LANES + l]);
            s2[l] = hb(COSPI[48], x[1 * IDCT_LANES + l], -COSPI[16],
                       x[3 * IDCT_LANES + l]);
            s3[l] = hb(COSPI[16], x[1 * IDCT_LANES + l], COSPI[48],
                       x[3 * IDCT_LANES + l]);
        }
        for (int l = 0; l < IDCT_LANES; l++) {
            out[0 * IDCT_LANES + l] = s0[l] + s3[l];
            out[1 * IDCT_LANES + l] = s1[l] + s2[l];
            out[2 * IDCT_LANES + l] = s1[l] - s2[l];
            out[3 * IDCT_LANES + l] = s0[l] - s3[l];
        }
        return;
    }
    int h = N / 2;
    int64_t ev_in[32 * IDCT_LANES], ev[32 * IDCT_LANES],
        od_in[32 * IDCT_LANES], od[32 * IDCT_LANES];
    for (int i = 0; i < h; i++)
        for (int l = 0; l < IDCT_LANES; l++) {
            ev_in[i * IDCT_LANES + l] = x[(size_t)(2 * i) * IDCT_LANES + l];
            od_in[i * IDCT_LANES + l] =
                x[(size_t)(2 * i + 1) * IDCT_LANES + l];
        }
    IDCT_FN(ev_in, ev, h);
    IDCT_ODD_FN(od_in, od, N);
    for (int i = 0; i < h; i++)
        for (int l = 0; l < IDCT_LANES; l++) {
            out[i * IDCT_LANES + l] =
                ev[i * IDCT_LANES + l] + od[(h - 1 - i) * IDCT_LANES + l];
            out[(h + i) * IDCT_LANES + l] =
                ev[(h - 1 - i) * IDCT_LANES + l] - od[i * IDCT_LANES + l];
        }
}
