// Native BC1/BC3/BC5 block decompression.
//
// The reference keeps DDS data GPU-compressed and lets the texture units
// decode (asset_import.cpp:42-53 + ddspp); a JAX program reaches no texture
// units, so decode happens at asset load.  assets/dds.py holds the numpy reference
// implementation; this C++ module is the fast path for the ~180-texture
// SunTemple-class loads (ctypes binding in assets/native_bcdec.py).
//
// Build: g++ -O3 -shared -fPIC -o libbcdec.so bcdec.cpp

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

inline void expand565(uint16_t c, float* rgb) {
    rgb[0] = ((c >> 11) & 31) / 31.0f;
    rgb[1] = ((c >> 5) & 63) / 63.0f;
    rgb[2] = (c & 31) / 31.0f;
}

// decode one BC1 color block (8 bytes) into 16 RGBA floats at out[16][4].
// four_color: BC3 color blocks always decode in 4-color mode (the c0<=c1
// comparison is ignored per the BC3 spec — ADVICE.md r1).
inline void decode_bc1_block(const uint8_t* b, float out[16][4],
                             bool four_color = false) {
    uint16_t c0 = uint16_t(b[0] | (b[1] << 8));
    uint16_t c1 = uint16_t(b[2] | (b[3] << 8));
    uint32_t bits = uint32_t(b[4]) | (uint32_t(b[5]) << 8) |
                    (uint32_t(b[6]) << 16) | (uint32_t(b[7]) << 24);
    float pal[4][4];
    expand565(c0, pal[0]);
    expand565(c1, pal[1]);
    pal[0][3] = pal[1][3] = 1.0f;
    if (c0 > c1 || four_color) {
        for (int k = 0; k < 3; k++) {
            pal[2][k] = (2.0f * pal[0][k] + pal[1][k]) / 3.0f;
            pal[3][k] = (pal[0][k] + 2.0f * pal[1][k]) / 3.0f;
        }
        pal[2][3] = pal[3][3] = 1.0f;
    } else {
        for (int k = 0; k < 3; k++) {
            pal[2][k] = 0.5f * (pal[0][k] + pal[1][k]);
            pal[3][k] = 0.0f;
        }
        pal[2][3] = 1.0f;
        pal[3][3] = 0.0f;
    }
    for (int t = 0; t < 16; t++) {
        const float* p = pal[(bits >> (2 * t)) & 3];
        out[t][0] = p[0]; out[t][1] = p[1]; out[t][2] = p[2]; out[t][3] = p[3];
    }
}

// decode one BC4 channel block (8 bytes) into 16 floats
inline void decode_bc4_block(const uint8_t* b, float out[16]) {
    float a0 = b[0], a1 = b[1];
    uint64_t bits = 0;
    for (int i = 0; i < 6; i++) bits |= uint64_t(b[2 + i]) << (8 * i);
    float interp[8];
    interp[0] = a0;
    interp[1] = a1;
    if (a0 > a1) {
        for (int i = 2; i < 8; i++)
            interp[i] = (a0 * (8 - i) + a1 * (i - 1)) / 7.0f;
    } else {
        for (int i = 2; i < 6; i++)
            interp[i] = (a0 * (6 - i) + a1 * (i - 1)) / 5.0f;
        interp[6] = 0.0f;
        interp[7] = 255.0f;
    }
    for (int t = 0; t < 16; t++)
        out[t] = interp[(bits >> (3 * t)) & 7] / 255.0f;
}

inline void scatter_block(float* dst, int w, int h, int bx, int by,
                          const float* texels, int nch, int tch) {
    for (int y = 0; y < 4; y++) {
        int py = by * 4 + y;
        if (py >= h) break;
        for (int x = 0; x < 4; x++) {
            int px = bx * 4 + x;
            if (px >= w) break;
            for (int c = 0; c < nch; c++)
                dst[(size_t(py) * w + px) * nch + c] = texels[(y * 4 + x) * tch + c];
        }
    }
}

}  // namespace

extern "C" {

// out: float32 [h, w, 4]
void bcdec_bc1(const uint8_t* src, float* out, int w, int h) {
    int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            float texels[16][4];
            decode_bc1_block(src + (size_t(by) * bw + bx) * 8, texels);
            scatter_block(out, w, h, bx, by, &texels[0][0], 4, 4);
        }
}

// out: float32 [h, w, 4]
void bcdec_bc3(const uint8_t* src, float* out, int w, int h) {
    int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            const uint8_t* blk = src + (size_t(by) * bw + bx) * 16;
            float a[16];
            float texels[16][4];
            decode_bc4_block(blk, a);
            decode_bc1_block(blk + 8, texels, /*four_color=*/true);
            for (int t = 0; t < 16; t++) texels[t][3] = a[t];
            scatter_block(out, w, h, bx, by, &texels[0][0], 4, 4);
        }
}

// out: float32 [h, w, 2]
void bcdec_bc5(const uint8_t* src, float* out, int w, int h) {
    int bw = (w + 3) / 4, bh = (h + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            const uint8_t* blk = src + (size_t(by) * bw + bx) * 16;
            float r[16], g[16];
            decode_bc4_block(blk, r);
            decode_bc4_block(blk + 8, g);
            float texels[16][2];
            for (int t = 0; t < 16; t++) { texels[t][0] = r[t]; texels[t][1] = g[t]; }
            scatter_block(out, w, h, bx, by, &texels[0][0], 2, 2);
        }
}

}  // extern "C"
