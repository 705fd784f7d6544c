/* Writes JPEG variants that Pillow's encoder cannot make, through
 * libjpeg-turbo's compression API: sampling factors per component,
 * YCCK, RGB without a transform, and custom scan scripts (one component
 * per sequential scan).
 *
 *   cc -O2 -o jpeg_writer jpeg_writer.c -ljpeg   (or libjpeg.a)
 *   jpeg_writer in.raw width height channels quality variant out.jpg
 *
 * in.raw: width x height x channels bytes (3 RGB, 4 CMYK as Pillow
 * stores it). variant: 440, 411, 311 (luma 3x1 with chroma 1x1),
 * noninterleaved, ycck, rgb, progressive_unrefined.
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
    c.in_color_space = ch == 4 ? JCS_CMYK : JCS_RGB;
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, quality, TRUE);
    static jpeg_scan_info scans[16];
    if (!strcmp(variant, "440")) {
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
