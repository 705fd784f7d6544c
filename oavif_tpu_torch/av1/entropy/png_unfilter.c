/* PNG scanline unfiltering (PNG specification, section 9: filter method 0
 * with its five filter types), for the port's PNG readers
 * (oavif_tpu_torch/io/png8.py, io/png16.py). It is built into the host
 * library beside the tile coder (av1/entropy/fast.py): the Average and
 * Paeth filters run sequentially along a row, which Python cannot do at
 * image sizes.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* raw: `height` filtered rows of 1 + `stride` bytes (the filter type, then
 * the row); out: height x stride bytes; bpp: bytes per complete pixel,
 * at least 1. Returns 0, -1 when raw holds fewer bytes than that, or
 * 1 + y for row y with a filter type above 4. */
int png_unfilter(const uint8_t *raw, size_t raw_len, uint8_t *out,
                 int height, int stride, int bpp)
{
    if (height < 0 || stride < 0 || bpp < 1)
        return -1;
    if ((size_t)height * ((size_t)stride + 1) > raw_len)
        return -1;
    const uint8_t *prev = NULL;
    for (int y = 0; y < height; y++) {
        const uint8_t *in = raw + (size_t)y * ((size_t)stride + 1);
        uint8_t *row = out + (size_t)y * stride;
        int ftype = in[0];
        in++;
        switch (ftype) {
        case 0:
            memcpy(row, in, (size_t)stride);
            break;
        case 1:
            for (int x = 0; x < stride; x++)
                row[x] = (uint8_t)(in[x] + (x >= bpp ? row[x - bpp] : 0));
            break;
        case 2:
            for (int x = 0; x < stride; x++)
                row[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
            break;
        case 3:
            for (int x = 0; x < stride; x++) {
                int left = x >= bpp ? row[x - bpp] : 0;
                int up = prev ? prev[x] : 0;
                row[x] = (uint8_t)(in[x] + ((left + up) >> 1));
            }
            break;
        case 4:
            for (int x = 0; x < stride; x++) {
                int a = x >= bpp ? row[x - bpp] : 0;
                int b = prev ? prev[x] : 0;
                int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                int p = a + b - c;
                int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                row[x] = (uint8_t)(in[x] + pred);
            }
            break;
        default:
            return 1 + y;
        }
        prev = row;
    }
    return 0;
}
