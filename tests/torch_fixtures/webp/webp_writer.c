/* Writes WebP files with encoder settings that Pillow's save cannot
 * reach, through libwebp's encoding API: token partitions, segments,
 * filter type, strength and sharpness, the alpha plane's compression and
 * filter, near-lossless.
 *
 *   cc -O2 -o webp_writer webp_writer.c -lwebp
 *   webp_writer in.raw width height channels out.webp [key=value ...]
 *
 * in.raw: width x height x channels bytes (3 RGB, 4 RGBA). Keys: quality,
 * method, lossless, exact, partitions, segments, filter_type,
 * filter_strength, filter_sharpness, autofilter, sns_strength,
 * alpha_compression, alpha_filtering, alpha_quality, near_lossless, all
 * as in WebPConfig.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>

int main(int argc, char **argv)
{
    if (argc < 6) {
        fprintf(stderr, "usage: %s in.raw w h ch out.webp [key=value ...]\n",
                argv[0]);
        return 2;
    }
    int w = atoi(argv[2]), h = atoi(argv[3]), ch = atoi(argv[4]);
    size_t n = (size_t)w * h * ch;
    unsigned char *px = malloc(n);
    FILE *fi = fopen(argv[1], "rb");
    if (!fi || fread(px, 1, n, fi) != n)
        return 1;
    fclose(fi);
    WebPConfig config;
    if (!WebPConfigInit(&config))
        return 1;
    for (int i = 6; i < argc; i++) {
        char key[64];
        float v;
        if (sscanf(argv[i], "%63[^=]=%f", key, &v) != 2) {
            fprintf(stderr, "bad setting %s\n", argv[i]);
            return 2;
        }
#define SET(name) else if (!strcmp(key, #name)) config.name = (int)v
        if (!strcmp(key, "quality"))
            config.quality = v;
        SET(method);
        SET(lossless);
        SET(exact);
        SET(partitions);
        SET(segments);
        SET(filter_type);
        SET(filter_strength);
        SET(filter_sharpness);
        SET(autofilter);
        SET(sns_strength);
        SET(alpha_compression);
        SET(alpha_filtering);
        SET(alpha_quality);
        SET(near_lossless);
        else {
            fprintf(stderr, "unknown key %s\n", key);
            return 2;
        }
#undef SET
    }
    if (!WebPValidateConfig(&config)) {
        fprintf(stderr, "invalid configuration\n");
        return 2;
    }
    WebPPicture pic;
    if (!WebPPictureInit(&pic))
        return 1;
    pic.width = w;
    pic.height = h;
    pic.use_argb = config.lossless;
    int ok = ch == 4 ? WebPPictureImportRGBA(&pic, px, w * 4)
                     : WebPPictureImportRGB(&pic, px, w * 3);
    if (!ok)
        return 1;
    WebPMemoryWriter wr;
    WebPMemoryWriterInit(&wr);
    pic.writer = WebPMemoryWrite;
    pic.custom_ptr = &wr;
    if (!WebPEncode(&config, &pic)) {
        fprintf(stderr, "encode failed: %d\n", pic.error_code);
        return 1;
    }
    FILE *fo = fopen(argv[5], "wb");
    if (!fo || fwrite(wr.mem, 1, wr.size, fo) != wr.size)
        return 1;
    fclose(fo);
    WebPMemoryWriterClear(&wr);
    WebPPictureFree(&pic);
    free(px);
    return 0;
}
