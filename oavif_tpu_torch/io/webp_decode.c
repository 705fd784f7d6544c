/* WebP decoding work for the port's reader (oavif_tpu_torch/io/webp.py):
 * VP8L lossless image streams (RFC 9649), VP8 lossy key frames (RFC 6386)
 * to Y'UV 4:2:0 planes, their conversion to RGB by fancy upsampling, and
 * the ALPH chunk's alpha plane. Every stage follows libwebp's decoder
 * (vp8l_dec.c, lossless.c; vp8_dec.c, tree_dec.c, quant_dec.c,
 * frame_dec.c, dsp/dec.c; io_dec.c, dsp/upsampling.c, dsp/yuv.h;
 * alpha_dec.c, dsp/filters.c), so the samples are the ones libwebp
 * returns in MODE_RGBA with its default options (fancy upsampling, no
 * dithering). The tables are the formats' own (RFC 6386 sections 11.5,
 * 13 and 14.1; RFC 9649 section 4.2.2), in libwebp's order of the intra
 * modes.
 * It is built into the host library beside the tile coder
 * (av1/entropy/fast.py).
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { WEBP_OK = 0, WEBP_BAD = -1, WEBP_SHORT = -2, WEBP_NOMEM = -3 };

/* ---- tables ------------------------------------------------------------ */

static const uint8_t kBands[17] = {
    0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0,
};

static const uint8_t kZigzag[16] = {
    0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15,
};

static const uint8_t kCat3[4] = {
    173, 148, 140, 0,
};

static const uint8_t kCat4[5] = {
    176, 155, 140, 135, 0,
};

static const uint8_t kCat5[6] = {
    180, 157, 141, 134, 130, 0,
};

static const uint8_t kCat6[12] = {
    254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0,
};

static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};

static const int8_t kYModesIntra4[18] = {
    0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9,
};

static const uint8_t kBModesProba[10][10][9] = {
    {
        {231, 120, 48, 89, 115, 113, 120, 152, 112},
        {152, 179, 64, 126, 170, 118, 46, 70, 95},
        {175, 69, 143, 80, 85, 82, 72, 155, 103},
        {56, 58, 10, 171, 218, 189, 17, 13, 152},
        {114, 26, 17, 163, 44, 195, 21, 10, 173},
        {121, 24, 80, 195, 26, 62, 44, 64, 85},
        {144, 71, 10, 38, 171, 213, 144, 34, 26},
        {170, 46, 55, 19, 136, 160, 33, 206, 71},
        {63, 20, 8, 114, 114, 208, 12, 9, 226},
        {81, 40, 11, 96, 182, 84, 29, 16, 36}
    },
    {
        {134, 183, 89, 137, 98, 101, 106, 165, 148},
        {72, 187, 100, 130, 157, 111, 32, 75, 80},
        {66, 102, 167, 99, 74, 62, 40, 234, 128},
        {41, 53, 9, 178, 241, 141, 26, 8, 107},
        {74, 43, 26, 146, 73, 166, 49, 23, 157},
        {65, 38, 105, 160, 51, 52, 31, 115, 128},
        {104, 79, 12, 27, 217, 255, 87, 17, 7},
        {87, 68, 71, 44, 114, 51, 15, 186, 23},
        {47, 41, 14, 110, 182, 183, 21, 17, 194},
        {66, 45, 25, 102, 197, 189, 23, 18, 22}
    },
    {
        {88, 88, 147, 150, 42, 46, 45, 196, 205},
        {43, 97, 183, 117, 85, 38, 35, 179, 61},
        {39, 53, 200, 87, 26, 21, 43, 232, 171},
        {56, 34, 51, 104, 114, 102, 29, 93, 77},
        {39, 28, 85, 171, 58, 165, 90, 98, 64},
        {34, 22, 116, 206, 23, 34, 43, 166, 73},
        {107, 54, 32, 26, 51, 1, 81, 43, 31},
        {68, 25, 106, 22, 64, 171, 36, 225, 114},
        {34, 19, 21, 102, 132, 188, 16, 76, 124},
        {62, 18, 78, 95, 85, 57, 50, 48, 51}
    },
    {
        {193, 101, 35, 159, 215, 111, 89, 46, 111},
        {60, 148, 31, 172, 219, 228, 21, 18, 111},
        {112, 113, 77, 85, 179, 255, 38, 120, 114},
        {40, 42, 1, 196, 245, 209, 10, 25, 109},
        {88, 43, 29, 140, 166, 213, 37, 43, 154},
        {61, 63, 30, 155, 67, 45, 68, 1, 209},
        {100, 80, 8, 43, 154, 1, 51, 26, 71},
        {142, 78, 78, 16, 255, 128, 34, 197, 171},
        {41, 40, 5, 102, 211, 183, 4, 1, 221},
        {51, 50, 17, 168, 209, 192, 23, 25, 82}
    },
    {
        {138, 31, 36, 171, 27, 166, 38, 44, 229},
        {67, 87, 58, 169, 82, 115, 26, 59, 179},
        {63, 59, 90, 180, 59, 166, 93, 73, 154},
        {40, 40, 21, 116, 143, 209, 34, 39, 175},
        {47, 15, 16, 183, 34, 223, 49, 45, 183},
        {46, 17, 33, 183, 6, 98, 15, 32, 183},
        {57, 46, 22, 24, 128, 1, 54, 17, 37},
        {65, 32, 73, 115, 28, 128, 23, 128, 205},
        {40, 3, 9, 115, 51, 192, 18, 6, 223},
        {87, 37, 9, 115, 59, 77, 64, 21, 47}
    },
    {
        {104, 55, 44, 218, 9, 54, 53, 130, 226},
        {64, 90, 70, 205, 40, 41, 23, 26, 57},
        {54, 57, 112, 184, 5, 41, 38, 166, 213},
        {30, 34, 26, 133, 152, 116, 10, 32, 134},
        {39, 19, 53, 221, 26, 114, 32, 73, 255},
        {31, 9, 65, 234, 2, 15, 1, 118, 73},
        {75, 32, 12, 51, 192, 255, 160, 43, 51},
        {88, 31, 35, 67, 102, 85, 55, 186, 85},
        {56, 21, 23, 111, 59, 205, 45, 37, 192},
        {55, 38, 70, 124, 73, 102, 1, 34, 98}
    },
    {
        {125, 98, 42, 88, 104, 85, 117, 175, 82},
        {95, 84, 53, 89, 128, 100, 113, 101, 45},
        {75, 79, 123, 47, 51, 128, 81, 171, 1},
        {57, 17, 5, 71, 102, 57, 53, 41, 49},
        {38, 33, 13, 121, 57, 73, 26, 1, 85},
        {41, 10, 67, 138, 77, 110, 90, 47, 114},
        {115, 21, 2, 10, 102, 255, 166, 23, 6},
        {101, 29, 16, 10, 85, 128, 101, 196, 26},
        {57, 18, 10, 102, 102, 213, 34, 20, 43},
        {117, 20, 15, 36, 163, 128, 68, 1, 26}
    },
    {
        {102, 61, 71, 37, 34, 53, 31, 243, 192},
        {69, 60, 71, 38, 73, 119, 28, 222, 37},
        {68, 45, 128, 34, 1, 47, 11, 245, 171},
        {62, 17, 19, 70, 146, 85, 55, 62, 70},
        {37, 43, 37, 154, 100, 163, 85, 160, 1},
        {63, 9, 92, 136, 28, 64, 32, 201, 85},
        {75, 15, 9, 9, 64, 255, 184, 119, 16},
        {86, 6, 28, 5, 64, 255, 25, 248, 1},
        {56, 8, 17, 132, 137, 255, 55, 116, 128},
        {58, 15, 20, 82, 135, 57, 26, 121, 40}
    },
    {
        {164, 50, 31, 137, 154, 133, 25, 35, 218},
        {51, 103, 44, 131, 131, 123, 31, 6, 158},
        {86, 40, 64, 135, 148, 224, 45, 183, 128},
        {22, 26, 17, 131, 240, 154, 14, 1, 209},
        {45, 16, 21, 91, 64, 222, 7, 1, 197},
        {56, 21, 39, 155, 60, 138, 23, 102, 213},
        {83, 12, 13, 54, 192, 255, 68, 47, 28},
        {85, 26, 85, 85, 128, 128, 32, 146, 171},
        {18, 11, 7, 63, 144, 171, 4, 4, 246},
        {35, 27, 10, 146, 174, 171, 12, 26, 128}
    },
    {
        {190, 80, 35, 99, 180, 80, 126, 54, 45},
        {85, 126, 47, 87, 176, 51, 41, 20, 32},
        {101, 75, 128, 139, 118, 146, 116, 128, 85},
        {56, 41, 15, 176, 236, 85, 37, 9, 62},
        {71, 30, 17, 119, 118, 255, 17, 18, 138},
        {101, 38, 60, 138, 55, 70, 43, 26, 142},
        {146, 36, 19, 30, 171, 255, 97, 27, 20},
        {138, 45, 61, 62, 219, 1, 81, 188, 64},
        {32, 41, 20, 117, 151, 142, 20, 21, 163},
        {112, 19, 12, 61, 195, 128, 48, 4, 24}
    }
};

static const uint8_t CoeffsProba0[4][8][3][11] = {
    {
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
            {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
            {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}
        },
        {
            {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
            {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
            {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}
        },
        {
            {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
            {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
            {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}
        },
        {
            {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
            {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
            {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}
        },
        {
            {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
            {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
            {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}
        },
        {
            {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
            {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
            {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}
        },
        {
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}
        }
    },
    {
        {
            {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
            {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
            {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}
        },
        {
            {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
            {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
            {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}
        },
        {
            {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
            {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
            {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}
        },
        {
            {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
            {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
            {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}
        },
        {
            {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
            {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
            {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}
        },
        {
            {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
            {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
            {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}
        },
        {
            {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
            {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
            {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}
        },
        {
            {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
            {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}
        }
    },
    {
        {
            {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
            {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
            {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}
        },
        {
            {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
            {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
            {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}
        },
        {
            {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
            {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
            {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}
        },
        {
            {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
            {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
            {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}
        },
        {
            {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
            {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
            {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
            {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}
        }
    },
    {
        {
            {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
            {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
            {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}
        },
        {
            {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
            {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
            {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}
        },
        {
            {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
            {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
            {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}
        },
        {
            {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
            {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
            {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}
        },
        {
            {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
            {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
            {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}
        },
        {
            {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
            {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
            {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}
        },
        {
            {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
            {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
            {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}
        },
        {
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        }
    }
};

static const uint8_t CoeffsUpdateProba[4][8][3][11] = {
    {
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
            {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    },
    {
        {
            {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
            {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    },
    {
        {
            {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
            {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    },
    {
        {
            {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    }
};

static const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55,
    57, 21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59,
    70, 74, 36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86,
    90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119,
    121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110,
    48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

static const uint8_t kCodeLengthCodeOrder[19] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
};

/* ---- VP8L: bit reader and prefix codes (vp8l_dec.c, huffman_utils.c) --- */

typedef struct {
    const uint8_t *p, *end;
    uint64_t buf;
    int cnt;           /* bits held in buf */
    uint64_t consumed; /* bits taken from the stream */
    uint64_t limit;    /* 8 x its length */
} LBits;

static void lfill(LBits *b, int n)
{
    while (b->cnt < n) {
        uint64_t byte = b->p < b->end ? *b->p++ : 0;
        b->buf |= byte << b->cnt;
        b->cnt += 8;
    }
}

static uint32_t lbits(LBits *b, int n)
{
    if (n == 0)
        return 0;
    lfill(b, n);
    uint32_t v = (uint32_t)(b->buf & ((1ull << n) - 1));
    b->buf >>= n;
    b->cnt -= n;
    b->consumed += (uint64_t)n;
    return v;
}

/* past the end of the data: libwebp's end of stream */
static int leos(const LBits *b) { return b->consumed > b->limit; }

#define ROOT_BITS 8
#define MAX_LEN 15

/* A canonical prefix code: a one-symbol code takes no bits */
typedef struct {
    int single;               /* that symbol, or -1 */
    uint16_t count[MAX_LEN + 1];
    uint16_t *sorted;         /* symbols by length, then value */
    uint32_t root[1 << ROOT_BITS]; /* len << 16 | symbol for <= 8 bits */
} HCode;

/* VP8LBuildHuffmanTable's checks and codes: lengths up to 15, at least
 * one symbol, a complete code unless it has a single symbol. Returns 0
 * or WEBP_BAD. */
static int hcode_build(HCode *h, const int *lengths, int n, uint16_t *sorted)
{
    int offs[MAX_LEN + 2];
    memset(h->count, 0, sizeof h->count);
    memset(h->root, 0, sizeof h->root);
    h->sorted = sorted;
    int total = 0;
    for (int s = 0; s < n; s++) {
        if (lengths[s] > MAX_LEN)
            return WEBP_BAD;
        if (lengths[s]) {
            h->count[lengths[s]]++;
            total++;
        }
    }
    if (total == 0)
        return WEBP_BAD;
    offs[1] = 0;
    for (int len = 1; len <= MAX_LEN; len++)
        offs[len + 1] = offs[len] + h->count[len];
    for (int s = 0; s < n; s++)
        if (lengths[s])
            sorted[offs[lengths[s]]++] = (uint16_t)s;
    if (total == 1) {
        h->single = sorted[0];
        return 0;
    }
    h->single = -1;
    int left = 1;
    for (int len = 1; len <= MAX_LEN; len++) {
        left <<= 1;
        left -= h->count[len];
        if (left < 0)
            return WEBP_BAD;
    }
    if (left)
        return WEBP_BAD; /* incomplete */
    int code = 0, k = 0;
    for (int len = 1; len <= MAX_LEN; len++) {
        for (int i = 0; i < h->count[len]; i++, k++, code++) {
            if (len > ROOT_BITS)
                continue;
            int rev = 0;
            for (int j = 0; j < len; j++)
                rev |= ((code >> j) & 1) << (len - 1 - j);
            for (int r = rev; r < (1 << ROOT_BITS); r += 1 << len)
                h->root[r] = ((uint32_t)len << 16) | sorted[k];
        }
        code <<= 1;
    }
    return 0;
}

static int hread(LBits *b, const HCode *h)
{
    if (h->single >= 0)
        return h->single;
    lfill(b, ROOT_BITS);
    uint32_t e = h->root[b->buf & ((1u << ROOT_BITS) - 1)];
    if (e) {
        int len = (int)(e >> 16);
        b->buf >>= len;
        b->cnt -= len;
        b->consumed += (uint64_t)len;
        return (int)(e & 0xFFFF);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= MAX_LEN; len++) {
        code |= (int)lbits(b, 1);
        int cnt = h->count[len];
        if (code - first < cnt)
            return h->sorted[index + code - first];
        index += cnt;
        first = (first + cnt) << 1;
        code <<= 1;
    }
    return 0; /* not reached for a complete code */
}

static const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

/* ReadHuffmanCodeLengths: the code lengths through the code-length code */
static int read_code_lengths(LBits *b, const int *cl_lengths, int nsym,
                             int *lengths)
{
    HCode lc;
    uint16_t sorted[19];
    if (hcode_build(&lc, cl_lengths, 19, sorted))
        return WEBP_BAD;
    int max_symbol = nsym;
    if (lbits(b, 1)) {
        int length_nbits = 2 + 2 * (int)lbits(b, 3);
        max_symbol = 2 + (int)lbits(b, length_nbits);
        if (max_symbol > nsym)
            return WEBP_BAD;
    }
    int prev = 8, symbol = 0;
    while (symbol < nsym) {
        if (max_symbol-- == 0)
            break;
        if (leos(b))
            return WEBP_BAD;
        int len = hread(b, &lc);
        if (len < 16) {
            lengths[symbol++] = len;
            if (len)
                prev = len;
        } else {
            static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            int slot = len - 16;
            int repeat = (int)lbits(b, extra[slot]) + offset[slot];
            if (symbol + repeat > nsym)
                return WEBP_BAD;
            int v = len == 16 ? prev : 0;
            while (repeat-- > 0)
                lengths[symbol++] = v;
        }
    }
    return 0;
}

/* ReadHuffmanCode: a simple (one or two symbols) or a normal code */
static int read_code(LBits *b, int nsym, int *lengths, HCode *h,
                     uint16_t *sorted)
{
    memset(lengths, 0, sizeof(int) * (size_t)nsym);
    if (lbits(b, 1)) {
        int two = (int)lbits(b, 1);
        int s = (int)lbits(b, lbits(b, 1) ? 8 : 1);
        if (s < nsym)
            lengths[s] = 1;
        if (two) {
            s = (int)lbits(b, 8);
            if (s < nsym)
                lengths[s] = 1;
        }
    } else {
        int cl[19] = {0};
        int n = (int)lbits(b, 4) + 4;
        for (int i = 0; i < n; i++)
            cl[kCodeLengthCodeOrder[i]] = (int)lbits(b, 3);
        if (read_code_lengths(b, cl, nsym, lengths))
            return WEBP_BAD;
    }
    if (leos(b))
        return WEBP_BAD;
    return hcode_build(h, lengths, nsym, sorted);
}

/* ---- VP8L: image streams (RFC 9649 section 5) ---------------------------- */

typedef struct {
    int type, bits, xsize; /* xsize: the width the transform outputs */
    uint32_t *data;
} Transform;

typedef struct {
    LBits b;
    int ntransforms, seen;
    Transform tr[4];
} VP8L;

static inline int subsample(int size, int bits)
{
    return (size + (1 << bits) - 1) >> bits;
}

static int decode_stream(VP8L *d, int xsize, int ysize, int level0,
                         uint32_t **out, int *out_xsize);

static inline uint32_t add_pixels(uint32_t a, uint32_t b)
{
    uint32_t ag = (a & 0xFF00FF00u) + (b & 0xFF00FF00u);
    uint32_t rb = (a & 0x00FF00FFu) + (b & 0x00FF00FFu);
    return (ag & 0xFF00FF00u) | (rb & 0x00FF00FFu);
}

static int read_transform(VP8L *d, int *xsize, int ysize)
{
    int type = (int)lbits(&d->b, 2);
    if (d->seen & (1 << type))
        return WEBP_BAD;
    d->seen |= 1 << type;
    Transform *t = &d->tr[d->ntransforms++];
    t->type = type;
    t->xsize = *xsize;
    t->data = NULL;
    t->bits = 0;
    if (type == 0 || type == 1) { /* predictor, cross colour */
        t->bits = (int)lbits(&d->b, 3) + 2;
        return decode_stream(d, subsample(t->xsize, t->bits),
                             subsample(ysize, t->bits), 0, &t->data, NULL);
    }
    if (type == 3) { /* colour indexing: the palette, delta-coded */
        int ncolors = (int)lbits(&d->b, 8) + 1;
        int bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        *xsize = subsample(t->xsize, bits);
        t->bits = bits;
        uint32_t *pal;
        int rc = decode_stream(d, ncolors, 1, 0, &pal, NULL);
        if (rc)
            return rc;
        int final = 1 << (8 >> bits);
        t->data = (uint32_t *)calloc((size_t)final, sizeof(uint32_t));
        if (!t->data) {
            free(pal);
            return WEBP_NOMEM;
        }
        t->data[0] = pal[0];
        for (int i = 1; i < ncolors; i++)
            t->data[i] = add_pixels(pal[i], t->data[i - 1]);
        free(pal);
    }
    return 0; /* subtract green: no data */
}

/* The entropy-coded image: its prefix code groups, their meta image, the
 * colour cache, then LZ77-coded ARGB */
static int decode_stream(VP8L *d, int xsize, int ysize, int level0,
                         uint32_t **out, int *out_xsize)
{
    LBits *b = &d->b;
    int rc = 0;
    if (level0)
        while (lbits(b, 1)) {
            if (d->ntransforms >= 4 || leos(b))
                return WEBP_BAD;
            if ((rc = read_transform(d, &xsize, ysize)))
                return rc;
        }
    int cache_bits = 0;
    if (lbits(b, 1)) {
        cache_bits = (int)lbits(b, 4);
        if (cache_bits < 1 || cache_bits > 11)
            return WEBP_BAD;
    }
    uint32_t *meta = NULL;
    int meta_bits = 0, meta_xsize = 0, ngroups = 1;
    if (level0 && lbits(b, 1)) {
        meta_bits = (int)lbits(b, 3) + 2;
        meta_xsize = subsample(xsize, meta_bits);
        rc = decode_stream(d, meta_xsize, subsample(ysize, meta_bits), 0,
                           &meta, NULL);
        if (rc)
            return rc;
        size_t n = (size_t)meta_xsize * subsample(ysize, meta_bits);
        for (size_t i = 0; i < n; i++) {
            meta[i] = (meta[i] >> 8) & 0xFFFF;
            if ((int)meta[i] + 1 > ngroups)
                ngroups = (int)meta[i] + 1;
        }
    }
    if (leos(b)) {
        free(meta);
        return WEBP_BAD;
    }
    int cache_size = cache_bits ? 1 << cache_bits : 0;
    int nsym0 = kAlphabetSize[0] + cache_size;
    HCode *codes = (HCode *)calloc((size_t)ngroups * 5, sizeof(HCode));
    size_t sorted_per = (size_t)nsym0 + 256 * 3 + 40;
    uint16_t *sorted =
        (uint16_t *)malloc((size_t)ngroups * sorted_per * sizeof(uint16_t));
    int *lengths = (int *)malloc(sizeof(int) * (size_t)nsym0);
    uint32_t *cache = cache_size ? (uint32_t *)calloc((size_t)cache_size, 4)
                                 : NULL;
    uint32_t *px = (uint32_t *)malloc((size_t)xsize * ysize * 4 + 4);
    if (!codes || !sorted || !lengths || (cache_size && !cache) || !px) {
        rc = WEBP_NOMEM;
        goto done;
    }
    for (int g = 0; g < ngroups && !rc; g++) {
        uint16_t *s = sorted + (size_t)g * sorted_per;
        for (int j = 0; j < 5 && !rc; j++) {
            int nsym = j == 0 ? nsym0 : kAlphabetSize[j];
            rc = read_code(b, nsym, lengths, &codes[g * 5 + j], s);
            s += nsym;
        }
    }
    if (rc)
        goto done;
    size_t total = (size_t)xsize * ysize, pos = 0;
    size_t cached = 0; /* pixels already put into the colour cache */
    int col = 0, row = 0;
    int mask = meta ? (1 << meta_bits) - 1 : 0;
    const HCode *grp = codes;
    while (pos < total) {
        if (meta && (col & mask) == 0)
            grp = codes + 5 * meta[(row >> meta_bits) * meta_xsize
                                   + (col >> meta_bits)];
        if (b->consumed > b->limit + 64) { /* far past the data */
            rc = WEBP_BAD;
            goto done;
        }
        int code = hread(b, &grp[0]);
        if (code < 256) { /* literal */
            int red = hread(b, &grp[1]);
            int blue = hread(b, &grp[2]);
            int alpha = hread(b, &grp[3]);
            px[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16)
                        | ((uint32_t)code << 8) | (uint32_t)blue;
            if (++col >= xsize) {
                col = 0;
                row++;
            }
        } else if (code < 256 + 24) { /* backward reference */
            int sym = code - 256;
            int length, dist;
            if (sym < 4) {
                length = sym + 1;
            } else {
                int eb = (sym - 2) >> 1;
                length = ((2 + (sym & 1)) << eb) + (int)lbits(b, eb) + 1;
            }
            int dsym = hread(b, &grp[4]);
            int dcode;
            if (dsym < 4) {
                dcode = dsym + 1;
            } else {
                int eb = (dsym - 2) >> 1;
                dcode = ((2 + (dsym & 1)) << eb) + (int)lbits(b, eb) + 1;
            }
            if (dcode > 120) {
                dist = dcode - 120;
            } else {
                int c = kCodeToPlane[dcode - 1];
                dist = (c >> 4) * xsize + 8 - (c & 15);
                if (dist < 1)
                    dist = 1;
            }
            if (leos(b))
                break;
            if ((size_t)dist > pos || total - pos < (size_t)length) {
                rc = WEBP_BAD;
                goto done;
            }
            for (int i = 0; i < length; i++, pos++)
                px[pos] = px[pos - dist];
            col += length;
            while (col >= xsize) {
                col -= xsize;
                row++;
            }
            if (meta && (col & mask))
                grp = codes + 5 * meta[(row >> meta_bits) * meta_xsize
                                       + (col >> meta_bits)];
        } else if (code < 256 + 24 + cache_size) { /* colour cache */
            for (; cached < pos; cached++)
                cache[(0x1E35A7BDu * px[cached]) >> (32 - cache_bits)] =
                    px[cached];
            px[pos++] = cache[code - 256 - 24];
            if (++col >= xsize) {
                col = 0;
                row++;
            }
        } else {
            rc = WEBP_BAD;
            goto done;
        }
        if (cache)
            for (; cached < pos; cached++)
                cache[(0x1E35A7BDu * px[cached]) >> (32 - cache_bits)] =
                    px[cached];
    }
    if (leos(b))
        rc = WEBP_BAD;
done:
    free(meta);
    free(codes);
    free(sorted);
    free(lengths);
    free(cache);
    if (rc) {
        free(px);
        return rc;
    }
    *out = px;
    if (out_xsize)
        *out_xsize = xsize;
    return 0;
}

/* ---- VP8L: inverse transforms (lossless.c) ------------------------------ */

static inline uint32_t average2(uint32_t a, uint32_t b)
{
    return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}

static inline int clip255(int a) { return a < 0 ? 0 : (a > 255 ? 255 : a); }

static inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl)
{
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8) {
        int a = (int)(t >> s) & 255, b = (int)(l >> s) & 255,
            c = (int)(tl >> s) & 255;
        pa_minus_pb += abs(b - c) - abs(a - c);
    }
    return pa_minus_pb <= 0 ? t : l;
}

static inline uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c)
{
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= (uint32_t)clip255((int)((a >> s) & 255) + (int)((b >> s) & 255)
                                 - (int)((c >> s) & 255))
               << s;
    return out;
}

static inline uint32_t add_sub_half(uint32_t ave, uint32_t c)
{
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        int a = (int)((ave >> s) & 255), b = (int)((c >> s) & 255);
        out |= (uint32_t)clip255(a + (a - b) / 2) << s;
    }
    return out;
}

/* The prediction of mode m from the left pixel, and the row above at
 * the same column (top[-1], top[0], top[1]: TL, T, TR) */
static inline uint32_t predict(int m, uint32_t left, const uint32_t *top)
{
    switch (m) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return add_sub_full(left, top[0], top[-1]);
    case 13: return add_sub_half(average2(left, top[0]), top[-1]);
    default: return 0xFF000000u; /* 0, and 14 and 15 */
    }
}

/* Undo one transform of t->xsize x ysize pixels: in place, except colour
 * indexing, which widens its packed rows from `in` into `out` */
static void inverse_transform(const Transform *t, int ysize, uint32_t *in,
                              uint32_t *out)
{
    int w = t->xsize;
    size_t n = (size_t)w * ysize;
    if (t->type == 0) { /* predictor: the row above is already final */
        int tiles = subsample(w, t->bits);
        for (int y = 0; y < ysize; y++) {
            uint32_t *row = in + (size_t)y * w;
            const uint32_t *modes = t->data + (size_t)(y >> t->bits) * tiles;
            for (int x = 0; x < w; x++) {
                uint32_t pred;
                if (y == 0)
                    pred = x == 0 ? 0xFF000000u : row[x - 1];
                else if (x == 0)
                    pred = row[x - w];
                else
                    pred = predict((int)(modes[x >> t->bits] >> 8) & 15,
                                   row[x - 1], row + x - w);
                row[x] = add_pixels(row[x], pred);
            }
        }
    } else if (t->type == 1) { /* cross colour */
        int tiles = subsample(w, t->bits);
        for (int y = 0; y < ysize; y++) {
            uint32_t *row = in + (size_t)y * w;
            const uint32_t *codes = t->data + (size_t)(y >> t->bits) * tiles;
            for (int x = 0; x < w; x++) {
                uint32_t cc = codes[x >> t->bits];
                int8_t g2r = (int8_t)(cc & 255), g2b = (int8_t)((cc >> 8) & 255),
                       r2b = (int8_t)((cc >> 16) & 255);
                uint32_t argb = row[x];
                int8_t green = (int8_t)(argb >> 8);
                int red = (int)(argb >> 16) & 255, blue = (int)argb & 255;
                red = (red + (((int)g2r * green) >> 5)) & 255;
                blue += ((int)g2b * green) >> 5;
                blue += ((int)r2b * (int8_t)red) >> 5;
                blue &= 255;
                row[x] = (argb & 0xFF00FF00u) | ((uint32_t)red << 16)
                         | (uint32_t)blue;
            }
        }
    } else if (t->type == 2) { /* subtract green */
        for (size_t i = 0; i < n; i++) {
            uint32_t argb = in[i], g = (argb >> 8) & 255;
            uint32_t rb = ((argb & 0x00FF00FFu) + ((g << 16) | g)) & 0x00FF00FFu;
            in[i] = (argb & 0xFF00FF00u) | rb;
        }
    } else { /* colour indexing, with 2, 4 or 8 pixels to a packed one */
        int bpp = 8 >> t->bits, per = 1 << t->bits;
        int packed_w = subsample(w, t->bits);
        for (int y = ysize - 1; y >= 0; y--) { /* `out` may be `in` */
            const uint32_t *src = in + (size_t)y * packed_w;
            uint32_t *dst = out + (size_t)y * w;
            for (int x = w - 1; x >= 0; x--) {
                uint32_t idx = (src[x >> t->bits] >> 8) & 255;
                idx = (idx >> (bpp * (x & (per - 1)))) & ((1u << bpp) - 1);
                dst[x] = t->data[idx];
            }
        }
    }
}

/* A VP8L image stream of width x height (after the 5-byte header of a
 * VP8L chunk, or the ALPH chunk's data after its header byte): its ARGB
 * pixels into argb. Returns WEBP_OK or an error. */
int webp_vp8l_decode(const uint8_t *data, size_t size, int width, int height,
                     uint32_t *argb)
{
    VP8L d;
    memset(&d, 0, sizeof d);
    d.b.p = data;
    d.b.end = data + size;
    d.b.limit = 8 * (uint64_t)size;
    uint32_t *px = NULL;
    int xsize = width;
    int rc = decode_stream(&d, width, height, 1, &px, &xsize);
    if (!rc) {
        /* the transforms in reverse order; colour indexing widens rows,
         * so work in the output buffer, which is large enough */
        memcpy(argb, px, (size_t)xsize * height * 4);
        for (int i = d.ntransforms - 1; i >= 0; i--)
            inverse_transform(&d.tr[i], height, argb, argb);
    }
    free(px);
    for (int i = 0; i < d.ntransforms; i++)
        free(d.tr[i].data);
    return rc;
}

/* ---- VP8: boolean decoder (bit_reader_utils.c) ---------------------------- */

typedef struct {
    const uint8_t *p, *end;
    uint32_t value;
    uint32_t range; /* range - 1 */
    int bits;
    int eof;
} Bool;

static void bool_load(Bool *br)
{
    if (br->p < br->end) {
        br->bits += 8;
        br->value = (uint32_t)*br->p++ | (br->value << 8);
    } else if (!br->eof) {
        br->value <<= 8;
        br->bits += 8;
        br->eof = 1;
    } else {
        br->bits = 0;
    }
}

static void bool_init(Bool *br, const uint8_t *p, size_t size)
{
    br->p = p;
    br->end = p + size;
    br->value = 0;
    br->range = 255 - 1;
    br->bits = -8;
    br->eof = 0;
    bool_load(br);
}

static inline int get_bit(Bool *br, int prob)
{
    uint32_t range = br->range;
    if (br->bits < 0)
        bool_load(br);
    int pos = br->bits;
    uint32_t split = (range * (uint32_t)prob) >> 8;
    uint32_t value = br->value >> pos;
    int bit = value > split;
    if (bit) {
        range -= split;
        br->value -= (split + 1) << pos;
    } else {
        range = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    br->bits -= shift;
    br->range = range - 1;
    return bit;
}

static int get_value(Bool *br, int nbits)
{
    int v = 0;
    while (nbits-- > 0)
        v |= get_bit(br, 0x80) << nbits;
    return v;
}

static int get_signed_value(Bool *br, int nbits)
{
    int v = get_value(br, nbits);
    return get_value(br, 1) ? -v : v;
}

/* ---- VP8: frame ---------------------------------------------------------- */

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED };

#define BPS 32 /* the work buffer's stride, as in libwebp */
#define Y_OFF (BPS * 1 + 8)
#define U_OFF (Y_OFF + BPS * 16 + BPS)
#define V_OFF (U_OFF + 16)
#define YUV_SIZE (BPS * 17 + BPS * 9)

typedef struct {
    int y1[2], y2[2], uv[2]; /* DC and AC dequantization factors */
} Quant;

typedef struct {
    int limit, ilevel, hev, inner;
} FInfo;

typedef struct {
    int mb_w, mb_h;
    int nparts;
    Bool br, parts[8];
    int use_segment, update_map, absolute_delta;
    int seg_quant[4], seg_filter[4];
    uint8_t seg_proba[3];
    int filter_type, level, sharpness, use_lf_delta;
    int ref_lf_delta[4], mode_lf_delta[4];
    Quant dqm[4];
    uint8_t proba[4][8][3][11]; /* by band */
    int use_skip, skip_p;
    FInfo fstr[4][2];
} VP8;

static int clipi(int v, int m) { return v < 0 ? 0 : (v > m ? m : v); }

static int parse_header(VP8 *d, const uint8_t *buf, size_t size)
{
    Bool *br = &d->br;
    /* 9.3 segmentation */
    d->use_segment = get_value(br, 1);
    d->update_map = 0;
    d->absolute_delta = 1;
    memset(d->seg_quant, 0, sizeof d->seg_quant);
    memset(d->seg_filter, 0, sizeof d->seg_filter);
    memset(d->seg_proba, 255, sizeof d->seg_proba);
    if (d->use_segment) {
        d->update_map = get_value(br, 1);
        if (get_value(br, 1)) {
            d->absolute_delta = get_value(br, 1);
            for (int s = 0; s < 4; s++)
                d->seg_quant[s] = get_value(br, 1) ? get_signed_value(br, 7)
                                                   : 0;
            for (int s = 0; s < 4; s++)
                d->seg_filter[s] = get_value(br, 1) ? get_signed_value(br, 6)
                                                    : 0;
        }
        if (d->update_map)
            for (int s = 0; s < 3; s++)
                d->seg_proba[s] =
                    (uint8_t)(get_value(br, 1) ? get_value(br, 8) : 255);
    }
    if (br->eof)
        return WEBP_BAD;
    /* 9.6 filter */
    int simple = get_value(br, 1);
    d->level = get_value(br, 6);
    d->sharpness = get_value(br, 3);
    d->use_lf_delta = get_value(br, 1);
    memset(d->ref_lf_delta, 0, sizeof d->ref_lf_delta);
    memset(d->mode_lf_delta, 0, sizeof d->mode_lf_delta);
    if (d->use_lf_delta && get_value(br, 1)) {
        for (int i = 0; i < 4; i++)
            if (get_value(br, 1))
                d->ref_lf_delta[i] = get_signed_value(br, 6);
        for (int i = 0; i < 4; i++)
            if (get_value(br, 1))
                d->mode_lf_delta[i] = get_signed_value(br, 6);
    }
    d->filter_type = d->level == 0 ? 0 : simple ? 1 : 2;
    if (br->eof)
        return WEBP_BAD;
    /* 9.5 token partitions */
    d->nparts = 1 << get_value(br, 2);
    size_t last = (size_t)d->nparts - 1;
    if (size < 3 * last)
        return WEBP_SHORT;
    const uint8_t *sz = buf, *start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; p++) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > left)
            psize = left;
        bool_init(&d->parts[p], start, psize);
        start += psize;
        left -= psize;
        sz += 3;
    }
    bool_init(&d->parts[last], start, left);
    if (start >= buf + size)
        return WEBP_SHORT;
    /* 9.6 quantizers (VP8ParseQuant) */
    int base_q0 = get_value(br, 7);
    int dq[5];
    for (int i = 0; i < 5; i++)
        dq[i] = get_value(br, 1) ? get_signed_value(br, 4) : 0;
    for (int i = 0; i < 4; i++) {
        int q;
        if (d->use_segment) {
            q = d->seg_quant[i] + (d->absolute_delta ? 0 : base_q0);
        } else if (i > 0) {
            d->dqm[i] = d->dqm[0];
            continue;
        } else {
            q = base_q0;
        }
        Quant *m = &d->dqm[i];
        m->y1[0] = kDcTable[clipi(q + dq[0], 127)];
        m->y1[1] = kAcTable[clipi(q, 127)];
        m->y2[0] = kDcTable[clipi(q + dq[1], 127)] * 2;
        m->y2[1] = (kAcTable[clipi(q + dq[2], 127)] * 101581) >> 16;
        if (m->y2[1] < 8)
            m->y2[1] = 8;
        m->uv[0] = kDcTable[clipi(q + dq[3], 117)];
        m->uv[1] = kAcTable[clipi(q + dq[4], 127)];
    }
    get_value(br, 1); /* refresh_entropy_probs: no later frame */
    /* 13.4 coefficient probability updates */
    for (int t = 0; t < 4; t++)
        for (int b = 0; b < 8; b++)
            for (int c = 0; c < 3; c++)
                for (int p = 0; p < 11; p++)
                    d->proba[t][b][c][p] =
                        (uint8_t)(get_bit(br, CoeffsUpdateProba[t][b][c][p])
                                      ? get_value(br, 8)
                                      : CoeffsProba0[t][b][c][p]);
    d->use_skip = get_value(br, 1);
    d->skip_p = d->use_skip ? get_value(br, 8) : 0;
    /* the loop filter's strengths by segment and 4x4 (frame_dec.c) */
    for (int s = 0; s < 4; s++) {
        int base = d->level;
        if (d->use_segment)
            base = d->seg_filter[s] + (d->absolute_delta ? 0 : d->level);
        for (int i4 = 0; i4 <= 1; i4++) {
            FInfo *f = &d->fstr[s][i4];
            int level = base;
            if (d->use_lf_delta) {
                level += d->ref_lf_delta[0];
                if (i4)
                    level += d->mode_lf_delta[0];
            }
            level = level < 0 ? 0 : (level > 63 ? 63 : level);
            f->limit = 0;
            f->ilevel = f->hev = 0;
            if (level > 0) {
                int ilevel = level;
                if (d->sharpness > 0) {
                    ilevel >>= d->sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - d->sharpness)
                        ilevel = 9 - d->sharpness;
                }
                if (ilevel < 1)
                    ilevel = 1;
                f->ilevel = ilevel;
                f->limit = 2 * level + ilevel;
                f->hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            }
            f->inner = i4;
        }
    }
    return 0;
}

/* 13: one block's tokens from position n; returns the position after
 * the last nonzero coefficient (16 when the block runs to its end) */
static int get_coeffs(Bool *br, uint8_t (*bands)[3][11], int ctx,
                      const int *dq, int n, int16_t *out)
{
    const uint8_t *p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!get_bit(br, p[0]))
            return n;
        while (!get_bit(br, p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16)
                return 16;
        }
        const uint8_t(*next)[11] = bands[kBands[n + 1]];
        int v;
        if (!get_bit(br, p[2])) {
            v = 1;
            p = next[1];
        } else {
            if (!get_bit(br, p[3])) {
                v = !get_bit(br, p[4]) ? 2 : 3 + get_bit(br, p[5]);
            } else if (!get_bit(br, p[6])) {
                if (!get_bit(br, p[7])) {
                    v = 5 + get_bit(br, 159);
                } else {
                    v = 7 + 2 * get_bit(br, 165);
                    v += get_bit(br, 145);
                }
            } else {
                static const uint8_t *const cats[4] = {kCat3, kCat4, kCat5,
                                                       kCat6};
                int bit1 = get_bit(br, p[8]);
                int bit0 = get_bit(br, p[9 + bit1]);
                int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t *tab = cats[cat]; *tab; ++tab)
                    v += v + get_bit(br, *tab);
                v += 3 + (8 << cat);
            }
            p = next[2];
        }
        int sv = get_bit(br, 0x80) ? -v : v;
        out[kZigzag[n]] = (int16_t)(sv * dq[n > 0]);
    }
    return 16;
}

/* ---- VP8: prediction and inverse transforms (dsp/dec.c) ------------------ */

static inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

static void transform_one(const int16_t *in, uint8_t *dst)
{
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) { /* vertical pass */
        int a = in[0] + in[8];
        int b = in[0] - in[8];
        int c = MUL2(in[4]) - MUL1(in[12]);
        int d = MUL1(in[4]) + MUL2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) { /* horizontal pass */
        int dc = tmp[0] + 4;
        int a = dc + tmp[8];
        int b = dc - tmp[8];
        int c = MUL2(tmp[4]) - MUL1(tmp[12]);
        int d = MUL1(tmp[4]) + MUL2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
        tmp++;
        dst += BPS;
    }
}

static void transform_wht(const int16_t *in, int16_t *out)
{
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a0 = in[0 + i] + in[12 + i];
        int a1 = in[4 + i] + in[8 + i];
        int a2 = in[4 + i] - in[8 + i];
        int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        int dc = tmp[0 + i * 4] + 3;
        int a0 = dc + tmp[3 + i * 4];
        int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        int a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void true_motion(uint8_t *dst, int size)
{
    const uint8_t *top = dst - BPS;
    for (int y = 0; y < size; ++y) {
        int base = dst[-1] - top[-1];
        for (int x = 0; x < size; ++x)
            dst[x] = clip8(top[x] + base);
        dst += BPS;
    }
}

static void pred4(uint8_t *dst, int mode)
{
    const uint8_t *top = dst - BPS;
    int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
        L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
    int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
        F = top[5], G = top[6], H = top[7];
    switch (mode) {
    case B_DC_PRED: {
        uint32_t dc = 4;
        for (int i = 0; i < 4; ++i)
            dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc >>= 3;
        for (int i = 0; i < 4; ++i)
            memset(dst + i * BPS, (int)dc, 4);
        break;
    }
    case B_TM_PRED:
        true_motion(dst, 4);
        break;
    case B_VE_PRED: {
        uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                           AVG3(C, D, E)};
        for (int i = 0; i < 4; ++i)
            memcpy(dst + i * BPS, vals, 4);
        break;
    }
    case B_HE_PRED:
        memset(dst + 0 * BPS, AVG3(X, I, J), 4);
        memset(dst + 1 * BPS, AVG3(I, J, K), 4);
        memset(dst + 2 * BPS, AVG3(J, K, L), 4);
        memset(dst + 3 * BPS, AVG3(K, L, L), 4);
        break;
    case B_RD_PRED:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
    case B_LD_PRED:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
    case B_VR_PRED:
        DST(0, 0) = DST(1, 2) = (uint8_t)AVG2(X, A);
        DST(1, 0) = DST(2, 2) = (uint8_t)AVG2(A, B);
        DST(2, 0) = DST(3, 2) = (uint8_t)AVG2(B, C);
        DST(3, 0) = (uint8_t)AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
    case B_VL_PRED:
        DST(0, 0) = (uint8_t)AVG2(A, B);
        DST(1, 0) = DST(0, 2) = (uint8_t)AVG2(B, C);
        DST(2, 0) = DST(1, 2) = (uint8_t)AVG2(C, D);
        DST(3, 0) = DST(2, 2) = (uint8_t)AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
    case B_HD_PRED:
        DST(0, 0) = DST(2, 1) = (uint8_t)AVG2(I, X);
        DST(0, 1) = DST(2, 2) = (uint8_t)AVG2(J, I);
        DST(0, 2) = DST(2, 3) = (uint8_t)AVG2(K, J);
        DST(0, 3) = (uint8_t)AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    default: /* B_HU_PRED */
        DST(0, 0) = (uint8_t)AVG2(I, J);
        DST(2, 0) = DST(0, 1) = (uint8_t)AVG2(J, K);
        DST(2, 1) = DST(0, 2) = (uint8_t)AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = (uint8_t)L;
        break;
    }
}

/* 16x16 luma (size 16) or 8x8 chroma (size 8) prediction; the DC mode
 * takes what the frame's edges leave (libwebp's CheckMode) */
static void pred_block(uint8_t *dst, int size, int mode, int mb_x, int mb_y)
{
    int shift = size == 16 ? 4 : 3;
    if (mode == DC_PRED) {
        int dc = 0;
        if (mb_x > 0 && mb_y > 0) {
            for (int j = 0; j < size; ++j)
                dc += dst[-1 + j * BPS] + dst[j - BPS];
            dc = (dc + size) >> (shift + 1);
        } else if (mb_y > 0) { /* no left */
            for (int j = 0; j < size; ++j)
                dc += dst[j - BPS];
            dc = (dc + (size >> 1)) >> shift;
        } else if (mb_x > 0) { /* no top */
            for (int j = 0; j < size; ++j)
                dc += dst[-1 + j * BPS];
            dc = (dc + (size >> 1)) >> shift;
        } else {
            dc = 0x80;
        }
        for (int j = 0; j < size; ++j)
            memset(dst + j * BPS, dc, (size_t)size);
    } else if (mode == TM_PRED) {
        true_motion(dst, size);
    } else if (mode == V_PRED) {
        for (int j = 0; j < size; ++j)
            memcpy(dst + j * BPS, dst - BPS, (size_t)size);
    } else { /* H_PRED */
        for (int j = 0; j < size; ++j)
            memset(dst + j * BPS, dst[j * BPS - 1], (size_t)size);
    }
}

/* ---- VP8: loop filter (dsp/dec.c) ---------------------------------------- */

static inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
static inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

static inline void do_filter2(uint8_t *p, int step)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

static inline void do_filter4(uint8_t *p, int step)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

static inline void do_filter6(uint8_t *p, int step)
{
    int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7;
    int a2 = (18 * a + 63) >> 7;
    int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

static inline int hev(const uint8_t *p, int step, int thresh)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static inline int needs_filter(const uint8_t *p, int step, int t)
{
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static inline int needs_filter2(const uint8_t *p, int step, int t, int it)
{
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    int p0 = p[-step], q0 = p[0];
    int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t)
        return 0;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it
           && abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

/* one edge of `size` pixels: hstride across it, vstride along it */
static void simple_edge(uint8_t *p, int hstride, int vstride, int thresh)
{
    int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, t2))
            do_filter2(p, hstride);
}

static void complex_edge(uint8_t *p, int hstride, int vstride, int size,
                         int thresh, int ithresh, int hev_t, int mb_edge)
{
    int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh))
            continue;
        if (hev(p, hstride, hev_t))
            do_filter2(p, hstride);
        else if (mb_edge)
            do_filter6(p, hstride);
        else
            do_filter4(p, hstride);
    }
}

/* DoFilter: the macroblock's left edge, its inner vertical edges, its top
 * edge, its inner horizontal edges */
static void filter_mb(const VP8 *d, const FInfo *f, uint8_t *y, uint8_t *u,
                      uint8_t *v, int ys, int uvs, int mb_x, int mb_y)
{
    int limit = f->limit, il = f->ilevel, ht = f->hev;
    if (limit == 0)
        return;
    if (d->filter_type == 1) {
        if (mb_x > 0)
            simple_edge(y, 1, ys, limit + 4);
        if (f->inner)
            for (int k = 4; k < 16; k += 4)
                simple_edge(y + k, 1, ys, limit);
        if (mb_y > 0)
            simple_edge(y, ys, 1, limit + 4);
        if (f->inner)
            for (int k = 4; k < 16; k += 4)
                simple_edge(y + k * ys, ys, 1, limit);
        return;
    }
    if (mb_x > 0) {
        complex_edge(y, 1, ys, 16, limit + 4, il, ht, 1);
        complex_edge(u, 1, uvs, 8, limit + 4, il, ht, 1);
        complex_edge(v, 1, uvs, 8, limit + 4, il, ht, 1);
    }
    if (f->inner) {
        for (int k = 4; k < 16; k += 4)
            complex_edge(y + k, 1, ys, 16, limit, il, ht, 0);
        complex_edge(u + 4, 1, uvs, 8, limit, il, ht, 0);
        complex_edge(v + 4, 1, uvs, 8, limit, il, ht, 0);
    }
    if (mb_y > 0) {
        complex_edge(y, ys, 1, 16, limit + 4, il, ht, 1);
        complex_edge(u, uvs, 1, 8, limit + 4, il, ht, 1);
        complex_edge(v, uvs, 1, 8, limit + 4, il, ht, 1);
    }
    if (f->inner) {
        for (int k = 4; k < 16; k += 4)
            complex_edge(y + k * ys, ys, 1, 16, limit, il, ht, 0);
        complex_edge(u + 4 * uvs, uvs, 1, 8, limit, il, ht, 0);
        complex_edge(v + 4 * uvs, uvs, 1, 8, limit, il, ht, 0);
    }
}

/* ---- VP8: macroblocks (tree_dec.c, vp8_dec.c, frame_dec.c) --------------- */

typedef struct {
    int segment, skip, is_i4x4, uvmode;
    uint8_t imodes[16];
} MBHead;

static void parse_modes(VP8 *d, Bool *br, uint8_t *top, uint8_t *left,
                        MBHead *mb)
{
    if (d->update_map)
        mb->segment = !get_bit(br, d->seg_proba[0])
                          ? get_bit(br, d->seg_proba[1])
                          : get_bit(br, d->seg_proba[2]) + 2;
    else
        mb->segment = 0;
    mb->skip = d->use_skip ? get_bit(br, d->skip_p) : 0;
    mb->is_i4x4 = !get_bit(br, 145);
    if (!mb->is_i4x4) {
        int ymode = get_bit(br, 156) ? (get_bit(br, 128) ? TM_PRED : H_PRED)
                                     : (get_bit(br, 163) ? V_PRED : DC_PRED);
        mb->imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        uint8_t *modes = mb->imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t *prob = kBModesProba[top[x]][ymode];
                int i = kYModesIntra4[get_bit(br, prob[0])];
                while (i > 0)
                    i = kYModesIntra4[2 * i + get_bit(br, prob[i])];
                ymode = -i;
                top[x] = (uint8_t)ymode;
            }
            memcpy(modes, top, 4);
            modes += 4;
            left[y] = (uint8_t)ymode;
        }
    }
    mb->uvmode = !get_bit(br, 142)   ? DC_PRED
                 : !get_bit(br, 114) ? V_PRED
                 : get_bit(br, 183)  ? TM_PRED
                                     : H_PRED;
}

/* Non-zero contexts: 4 luma, 2 U and 2 V flags at the top of each
 * macroblock column and on the left of the row, and the Y2 flags */
typedef struct {
    uint8_t y[4], u[2], v[2], dc;
} Nz;

/* ParseResiduals: the macroblock's dequantized coefficients; returns
 * whether any is nonzero */
static int parse_residuals(VP8 *d, Bool *br, const MBHead *mb, Nz *top,
                           Nz *left, int16_t *coeffs)
{
    const Quant *q = &d->dqm[mb->segment];
    int16_t *dst = coeffs;
    int nonzero = 0;
    memset(coeffs, 0, 384 * sizeof(int16_t));
    int first;
    uint8_t(*ac)[3][11];
    if (!mb->is_i4x4) {
        int16_t dc[16] = {0};
        int ctx = top->dc + left->dc;
        int nz = get_coeffs(br, d->proba[1], ctx, q->y2, 0, dc);
        top->dc = left->dc = nz > 0;
        transform_wht(dc, dst);
        first = 1;
        ac = d->proba[0];
    } else {
        first = 0;
        ac = d->proba[3];
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
            int ctx = left->y[y] + top->y[x];
            int nz = get_coeffs(br, ac, ctx, q->y1, first, dst);
            left->y[y] = top->y[x] = nz > first;
            nonzero |= nz > 1 || dst[0] != 0; /* libwebp's NzCodeBits */
            dst += 16;
        }
    for (int ch = 0; ch < 2; ++ch) {
        uint8_t *t = ch ? top->v : top->u, *l = ch ? left->v : left->u;
        for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
                int ctx = l[y] + t[x];
                int nz = get_coeffs(br, d->proba[2], ctx, q->uv, 0, dst);
                l[y] = t[x] = nz > 0;
                nonzero |= nz > 1 || dst[0] != 0;
                dst += 16;
            }
    }
    return nonzero;
}

/* libwebp's work buffer for one macroblock: the samples above and on the
 * left as its ReconstructRow leaves them (127 above the frame, 129 on the
 * left of it, the unfiltered reconstruction elsewhere), then prediction
 * and residuals; copied into the planes (strides ys, uvs) */
static void reconstruct(const VP8 *d, const MBHead *mb, const int16_t *coeffs,
                        uint8_t *Y, uint8_t *U, uint8_t *V, int ys, int uvs,
                        int mb_x, int mb_y)
{
    uint8_t buf[YUV_SIZE];
    uint8_t *y = buf + Y_OFF, *u = buf + U_OFF, *v = buf + V_OFF;
    uint8_t *py = Y + (size_t)mb_y * 16 * ys + mb_x * 16;
    uint8_t *pu = U + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t *pv = V + (size_t)mb_y * 8 * uvs + mb_x * 8;
    for (int j = 0; j < 16; ++j)
        y[j * BPS - 1] = mb_x > 0 ? py[j * ys - 1] : 129;
    for (int j = 0; j < 8; ++j) {
        u[j * BPS - 1] = mb_x > 0 ? pu[j * uvs - 1] : 129;
        v[j * BPS - 1] = mb_x > 0 ? pv[j * uvs - 1] : 129;
    }
    if (mb_y > 0) {
        y[-1 - BPS] = mb_x > 0 ? py[-ys - 1] : 129;
        u[-1 - BPS] = mb_x > 0 ? pu[-uvs - 1] : 129;
        v[-1 - BPS] = mb_x > 0 ? pv[-uvs - 1] : 129;
        memcpy(y - BPS, py - ys, 16);
        memcpy(u - BPS, pu - uvs, 8);
        memcpy(v - BPS, pv - uvs, 8);
    } else {
        memset(y - BPS - 1, 127, 16 + 4 + 1);
        memset(u - BPS - 1, 127, 8 + 1);
        memset(v - BPS - 1, 127, 8 + 1);
    }
    if (mb->is_i4x4) {
        uint8_t *top_right = y - BPS + 16;
        if (mb_y > 0) {
            if (mb_x >= d->mb_w - 1)
                memset(top_right, py[-ys + 15], 4);
            else
                memcpy(top_right, py - ys + 16, 4);
        }
        for (int k = 1; k <= 3; k++)
            memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
            uint8_t *dst = y + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred4(dst, mb->imodes[n]);
            transform_one(coeffs + n * 16, dst);
        }
    } else {
        pred_block(y, 16, mb->imodes[0], mb_x, mb_y);
        for (int n = 0; n < 16; ++n)
            transform_one(coeffs + n * 16,
                          y + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    pred_block(u, 8, mb->uvmode, mb_x, mb_y);
    pred_block(v, 8, mb->uvmode, mb_x, mb_y);
    for (int n = 0; n < 4; ++n) {
        int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        transform_one(coeffs + 256 + n * 16, u + off);
        transform_one(coeffs + 320 + n * 16, v + off);
    }
    for (int j = 0; j < 16; ++j)
        memcpy(py + (size_t)j * ys, y + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
        memcpy(pu + (size_t)j * uvs, u + j * BPS, 8);
        memcpy(pv + (size_t)j * uvs, v + j * BPS, 8);
    }
}

/* A VP8 key frame (the payload of a "VP8 " chunk) of width x height:
 * its Y' plane (width x height) and U, V planes ((width + 1) / 2 x
 * (height + 1) / 2), exactly libwebp's. Returns WEBP_OK, WEBP_SHORT
 * where the data ends early, or WEBP_BAD. */
int webp_vp8_decode(const uint8_t *data, size_t size, int width, int height,
                    uint8_t *yo, uint8_t *uo, uint8_t *vo)
{
    if (size < 10)
        return WEBP_SHORT;
    uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1))
        return WEBP_BAD; /* not a shown key frame of profile 0-3 */
    size_t part0 = bits >> 5;
    if (data[3] != 0x9D || data[4] != 0x01 || data[5] != 0x2A)
        return WEBP_BAD;
    int w = ((data[7] << 8) | data[6]) & 0x3FFF;
    int h = ((data[9] << 8) | data[8]) & 0x3FFF;
    if (w != width || h != height)
        return WEBP_BAD;
    data += 10;
    size -= 10;
    if (part0 > size)
        return WEBP_SHORT;
    VP8 *d = (VP8 *)calloc(1, sizeof(VP8));
    if (!d)
        return WEBP_NOMEM;
    d->mb_w = (w + 15) >> 4;
    d->mb_h = (h + 15) >> 4;
    bool_init(&d->br, data, part0);
    get_value(&d->br, 1); /* colour space */
    get_value(&d->br, 1); /* clamping type: the decoder always clamps */
    int rc = parse_header(d, data + part0, size - part0);
    int ys = d->mb_w * 16, uvs = d->mb_w * 8;
    uint8_t *Y = NULL, *U = NULL, *V = NULL, *intra_t = NULL;
    Nz *nz_top = NULL;
    FInfo *finfo = NULL;
    int16_t coeffs[384];
    if (rc)
        goto done;
    Y = (uint8_t *)malloc((size_t)ys * d->mb_h * 16);
    U = (uint8_t *)malloc((size_t)uvs * d->mb_h * 8);
    V = (uint8_t *)malloc((size_t)uvs * d->mb_h * 8);
    intra_t = (uint8_t *)malloc((size_t)d->mb_w * 4);
    nz_top = (Nz *)calloc((size_t)d->mb_w, sizeof(Nz));
    finfo = (FInfo *)calloc((size_t)d->mb_w * d->mb_h, sizeof(FInfo));
    if (!Y || !U || !V || !intra_t || !nz_top || !finfo) {
        rc = WEBP_NOMEM;
        goto done;
    }
    memset(intra_t, B_DC_PRED, (size_t)d->mb_w * 4);
    for (int mb_y = 0; mb_y < d->mb_h; ++mb_y) {
        Bool *tokens = &d->parts[mb_y & (d->nparts - 1)];
        uint8_t intra_l[4];
        Nz nz_left;
        memset(intra_l, B_DC_PRED, 4);
        memset(&nz_left, 0, sizeof nz_left);
        for (int mb_x = 0; mb_x < d->mb_w; ++mb_x) {
            MBHead mb;
            parse_modes(d, &d->br, intra_t + 4 * mb_x, intra_l, &mb);
            Nz *top = nz_top + mb_x;
            int nonzero;
            if (!mb.skip) {
                nonzero = parse_residuals(d, tokens, &mb, top, &nz_left,
                                          coeffs);
            } else {
                memset(coeffs, 0, sizeof coeffs);
                uint8_t dc_t = top->dc, dc_l = nz_left.dc;
                memset(top, 0, sizeof *top);
                memset(&nz_left, 0, sizeof nz_left);
                if (mb.is_i4x4) { /* a skipped 4x4 macroblock keeps Y2's */
                    top->dc = dc_t;
                    nz_left.dc = dc_l;
                }
                nonzero = 0;
            }
            if (tokens->eof) {
                rc = WEBP_SHORT;
                goto done;
            }
            if (d->filter_type > 0) {
                FInfo *f = finfo + (size_t)mb_y * d->mb_w + mb_x;
                *f = d->fstr[mb.segment][mb.is_i4x4];
                f->inner |= nonzero;
            }
            reconstruct(d, &mb, coeffs, Y, U, V, ys, uvs, mb_x, mb_y);
        }
        if (d->br.eof) {
            rc = WEBP_SHORT;
            goto done;
        }
    }
    /* the loop filter over the whole frame, macroblocks in raster order:
     * the prediction above used the unfiltered samples */
    if (d->filter_type > 0)
        for (int mb_y = 0; mb_y < d->mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < d->mb_w; ++mb_x)
                filter_mb(d, finfo + (size_t)mb_y * d->mb_w + mb_x,
                          Y + (size_t)mb_y * 16 * ys + mb_x * 16,
                          U + (size_t)mb_y * 8 * uvs + mb_x * 8,
                          V + (size_t)mb_y * 8 * uvs + mb_x * 8, ys, uvs,
                          mb_x, mb_y);
    {
        int uvw = (w + 1) / 2, uvh = (h + 1) / 2;
        for (int j = 0; j < h; ++j)
            memcpy(yo + (size_t)j * w, Y + (size_t)j * ys, (size_t)w);
        for (int j = 0; j < uvh; ++j) {
            memcpy(uo + (size_t)j * uvw, U + (size_t)j * uvs, (size_t)uvw);
            memcpy(vo + (size_t)j * uvw, V + (size_t)j * uvs, (size_t)uvw);
        }
    }
done:
    free(Y);
    free(U);
    free(V);
    free(intra_t);
    free(nz_top);
    free(finfo);
    free(d);
    return rc;
}

/* ---- Y'UV 4:2:0 to RGBA (io_dec.c EmitFancyRGB, dsp/upsampling.c,
 * dsp/yuv.h) --------------------------------------------------------------- */

static inline int mult_hi(int v, int c) { return (v * c) >> 8; }

static inline uint8_t yuv_clip8(int v)
{
    return (uint8_t)((v & ~16383) == 0 ? v >> 6 : (v < 0 ? 0 : 255));
}

static inline void yuv_to_rgba(int y, int u, int v, uint8_t *rgba)
{
    rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419)
                        - mult_hi(v, 13320) + 8708);
    rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    rgba[3] = 0xFF;
}

#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))

/* UpsampleRgbaLinePair: two output rows from the chroma rows above and
 * below them, on packed u | v pairs as libwebp computes them */
static void upsample_pair(const uint8_t *top_y, const uint8_t *bottom_y,
                          const uint8_t *top_u, const uint8_t *top_v,
                          const uint8_t *cur_u, const uint8_t *cur_v,
                          uint8_t *top_dst, uint8_t *bottom_dst, int len)
{
    int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
    uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
    uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xFF, (int)(uv0 >> 16), top_dst);
    if (bottom_y) {
        uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgba(bottom_y[0], uv0 & 0xFF, (int)(uv0 >> 16), bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
        uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
        uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
        uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        uint32_t a = (diag_12 + tl_uv) >> 1, b = (diag_03 + t_uv) >> 1;
        yuv_to_rgba(top_y[2 * x - 1], a & 0xFF, (int)(a >> 16),
                    top_dst + (2 * x - 1) * 4);
        yuv_to_rgba(top_y[2 * x], b & 0xFF, (int)(b >> 16),
                    top_dst + (2 * x) * 4);
        if (bottom_y) {
            a = (diag_03 + l_uv) >> 1;
            b = (diag_12 + uv) >> 1;
            yuv_to_rgba(bottom_y[2 * x - 1], a & 0xFF, (int)(a >> 16),
                        bottom_dst + (2 * x - 1) * 4);
            yuv_to_rgba(bottom_y[2 * x], b & 0xFF, (int)(b >> 16),
                        bottom_dst + (2 * x) * 4);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgba(top_y[len - 1], uv0 & 0xFF, (int)(uv0 >> 16),
                    top_dst + (len - 1) * 4);
        if (bottom_y) {
            uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgba(bottom_y[len - 1], uv0 & 0xFF, (int)(uv0 >> 16),
                        bottom_dst + (len - 1) * 4);
        }
    }
}

/* The planes of webp_vp8_decode to RGBA rows of `stride` bytes, alpha
 * 255, in EmitFancyRGB's order: the first row from the first chroma row
 * alone, then rows 2k-1 and 2k from chroma rows k-1 and k, and the last
 * row of an even height from the last chroma row alone */
void webp_yuv_to_rgba(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                      int width, int height, uint8_t *rgba, size_t stride)
{
    int uvw = (width + 1) / 2;
    upsample_pair(y, NULL, u, v, u, v, rgba, NULL, width);
    int row = 1;
    for (; row + 1 < height; row += 2) {
        int k = (row + 1) / 2;
        upsample_pair(y + (size_t)row * width, y + (size_t)(row + 1) * width,
                      u + (size_t)(k - 1) * uvw, v + (size_t)(k - 1) * uvw,
                      u + (size_t)k * uvw, v + (size_t)k * uvw,
                      rgba + row * stride, rgba + (row + 1) * stride, width);
    }
    if (row < height) { /* even height: the last row */
        int k = (height - 1) / 2;
        upsample_pair(y + (size_t)row * width, NULL, u + (size_t)k * uvw,
                      v + (size_t)k * uvw, u + (size_t)k * uvw,
                      v + (size_t)k * uvw, rgba + row * stride, NULL, width);
    }
}

/* ---- ALPH (alpha_dec.c, dsp/filters.c) ----------------------------------- */

static void unfilter_row(int filter, const uint8_t *prev, const uint8_t *in,
                         uint8_t *out, int width)
{
    if (filter == 0) {
        if (in != out)
            memcpy(out, in, (size_t)width);
        return;
    }
    if (filter == 1 || prev == NULL) { /* horizontal, and every first row */
        uint8_t pred = prev == NULL ? 0 : prev[0];
        for (int i = 0; i < width; ++i) {
            out[i] = (uint8_t)(pred + in[i]);
            pred = out[i];
        }
    } else if (filter == 2) { /* vertical */
        for (int i = 0; i < width; ++i)
            out[i] = (uint8_t)(prev[i] + in[i]);
    } else { /* gradient */
        uint8_t top = prev[0], top_left = top, left = top;
        for (int i = 0; i < width; ++i) {
            top = prev[i];
            int g = left + top - top_left;
            g = (g & ~0xFF) == 0 ? g : (g < 0 ? 0 : 255);
            left = (uint8_t)(in[i] + g);
            top_left = top;
            out[i] = left;
        }
    }
}

/* The payload of an ALPH chunk (its header byte first) for a width x
 * height image: the alpha plane. Pre-processing (level reduction) needs
 * nothing at alpha dithering 0. Returns WEBP_OK or an error. */
int webp_alpha_decode(const uint8_t *data, size_t size, int width,
                      int height, uint8_t *alpha)
{
    if (size <= 1)
        return WEBP_BAD;
    int method = data[0] & 3, filter = (data[0] >> 2) & 3;
    int pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0)
        return WEBP_BAD;
    size_t n = (size_t)width * height;
    if (method == 0) {
        if (size - 1 < n)
            return WEBP_BAD;
        memcpy(alpha, data + 1, n);
    } else {
        uint32_t *argb = (uint32_t *)malloc(n * 4);
        if (!argb)
            return WEBP_NOMEM;
        int rc = webp_vp8l_decode(data + 1, size - 1, width, height, argb);
        for (size_t i = 0; !rc && i < n; i++)
            alpha[i] = (uint8_t)(argb[i] >> 8);
        free(argb);
        if (rc)
            return rc;
    }
    const uint8_t *prev = NULL;
    for (int r = 0; r < height; r++) {
        uint8_t *row = alpha + (size_t)r * width;
        unfilter_row(filter, prev, row, row, width);
        prev = row;
    }
    return WEBP_OK;
}
