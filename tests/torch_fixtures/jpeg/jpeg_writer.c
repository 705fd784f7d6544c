/* Writes JPEG variants that Pillow's encoder cannot make, through
 * libjpeg-turbo's compression API: sampling factors per component,
 * YCCK, RGB without a transform, custom scan scripts (one component per
 * sequential scan, progressive scripts that leave coefficients
 * unrefined) and arithmetic coding.
 *
 *   cc -O2 -o jpeg_writer jpeg_writer.c -ljpeg   (or libjpeg.a)
 *   jpeg_writer in.raw width height channels quality variant out.jpg
 *
 * in.raw: width x height x channels bytes (1 gray, 3 RGB, 4 CMYK as
 * Pillow stores it). variant: 440, 411, 311 (luma 3x1 with chroma 1x1),
 * noninterleaved, ycck, rgb, progressive_unrefined, 444, progressive,
 * baseline, or a scan script "scans:S;S;..." with each scan S written
 * "c,c,..:Ss-Se:Ah:Al" (component indices, spectral band, successive
 * approximation); and any of these options before it, each ending in "+":
 * "arith+" (arithmetic coding), "dac+" (arithmetic coding with DC
 * conditioning L=2, U=6 and AC K=12 in slot 0, L=1, U=3, K=2 in slot 1,
 * which the DAC markers carry), "rst+" (a restart marker every 7 MCUs),
 * "444+" (every component 1x1).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv)
{
    if (argc != 8) {
        fprintf(stderr, "usage: %s in.raw w h ch quality variant out.jpg\n",
                argv[0]);
        return 2;
    }
    int w = atoi(argv[2]), h = atoi(argv[3]), ch = atoi(argv[4]);
    int quality = atoi(argv[5]);
    const char *variant = argv[6];
    size_t n = (size_t)w * h * ch;
    unsigned char *px = malloc(n);
    FILE *fi = fopen(argv[1], "rb");
    if (!fi || fread(px, 1, n, fi) != n)
        return 1;
    fclose(fi);
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr err;
    c.err = jpeg_std_error(&err);
    jpeg_create_compress(&c);
    FILE *fo = fopen(argv[7], "wb");
    jpeg_stdio_dest(&c, fo);
    c.image_width = w;
    c.image_height = h;
    c.input_components = ch;
    c.in_color_space = ch == 4 ? JCS_CMYK : (ch == 1 ? JCS_GRAYSCALE
                                                      : JCS_RGB);
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, quality, TRUE);
    static jpeg_scan_info scans[64];
    for (;;) {
        const char *plus = strchr(variant, '+');
        if (!plus)
            break;
        if (!strncmp(variant, "arith+", 6)) {
            c.arith_code = TRUE;
        } else if (!strncmp(variant, "dac+", 4)) {
            c.arith_code = TRUE;
            c.arith_dc_L[0] = 2;
            c.arith_dc_U[0] = 6;
            c.arith_ac_K[0] = 12;
            c.arith_dc_L[1] = 1;
            c.arith_dc_U[1] = 3;
            c.arith_ac_K[1] = 2;
        } else if (!strncmp(variant, "rst+", 4)) {
            c.restart_interval = 7;
        } else if (!strncmp(variant, "444+", 4)) {
            for (int i = 0; i < c.num_components; i++)
                c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor =
                    1;
        } else {
            fprintf(stderr, "unknown option in %s\n", variant);
            return 2;
        }
        variant = plus + 1;
    }
    if (!strncmp(variant, "scans:", 6)) {
        int n = 0;
        const char *p = variant + 6;
        while (*p && n < 64) {
            jpeg_scan_info *sc = &scans[n++];
            sc->comps_in_scan = 0;
            for (;;) {
                sc->component_index[sc->comps_in_scan++] =
                    (int)strtol(p, (char **)&p, 10);
                if (*p != ',')
                    break;
                p++;
            }
            if (sscanf(p, ":%d-%d:%d:%d", &sc->Ss, &sc->Se, &sc->Ah,
                       &sc->Al) != 4) {
                fprintf(stderr, "bad scan script %s\n", variant);
                return 2;
            }
            while (*p && *p != ';')
                p++;
            if (*p == ';')
                p++;
        }
        c.scan_info = scans;
        c.num_scans = n;
    } else if (!strcmp(variant, "baseline") || !strcmp(variant, "444")) {
        /* the defaults (4:2:0), or every component 1x1 */
        for (int i = 0; !strcmp(variant, "444") && i < c.num_components; i++)
            c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
    } else if (!strcmp(variant, "progressive")) {
        jpeg_simple_progression(&c);
    } else if (!strcmp(variant, "440")) {
        c.comp_info[0].h_samp_factor = 1;
        c.comp_info[0].v_samp_factor = 2;
    } else if (!strcmp(variant, "411")) {
        c.comp_info[0].h_samp_factor = 4;
        c.comp_info[0].v_samp_factor = 1;
    } else if (!strcmp(variant, "311")) {
        c.comp_info[0].h_samp_factor = 3;
        c.comp_info[0].v_samp_factor = 1;
    } else if (!strcmp(variant, "noninterleaved")) {
        c.comp_info[0].h_samp_factor = 2;
        c.comp_info[0].v_samp_factor = 2;
        for (int i = 0; i < 3; i++) {
            scans[i].comps_in_scan = 1;
            scans[i].component_index[0] = 2 - i;
            scans[i].Ss = 0;
            scans[i].Se = 63;
            scans[i].Ah = scans[i].Al = 0;
        }
        c.scan_info = scans;
        c.num_scans = 3;
    } else if (!strcmp(variant, "ycck")) {
        jpeg_set_colorspace(&c, JCS_YCCK);
        c.comp_info[0].h_samp_factor = 2;
        c.comp_info[0].v_samp_factor = 2;
        c.comp_info[3].h_samp_factor = 2;
        c.comp_info[3].v_samp_factor = 2;
    } else if (!strcmp(variant, "rgb")) {
        jpeg_set_colorspace(&c, JCS_RGB);
    } else if (!strcmp(variant, "progressive_unrefined")) {
        /* jpeg_simple_progression without its last luma refinement: the
         * low AC coefficients of Y stay at Al = 1 */
        jpeg_simple_progression(&c);
        c.num_scans -= 1;
    } else {
        fprintf(stderr, "unknown variant %s\n", variant);
        return 2;
    }
    jpeg_start_compress(&c, TRUE);
    while (c.next_scanline < c.image_height) {
        JSAMPROW row = px + (size_t)c.next_scanline * w * ch;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    fclose(fo);
    jpeg_destroy_compress(&c);
    free(px);
    return 0;
}
