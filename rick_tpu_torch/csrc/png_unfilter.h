// PNG row unfiltering (PNG spec section 9, filter method 0), on the host.
//
// Sub, Average and Paeth make each byte depend on the reconstructed byte
// `bpp` to its left, so a row cannot be vectorized along its length in
// numpy, and a loop in Python costs tenths of a second per 256x256 image.
// Included by `png_unfilter.cpp` (the entry point of `data/png.py`) and by
// the batch decoder's PNG reader (`png_decode.h`).  No library is needed.

#pragma once

#include <cstdint>
#include <cstdlib>

namespace rick {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

// `src` holds `height` rows of 1 filter-type byte + `stride` filtered bytes
// (the inflated IDAT stream); `dst` receives `height` rows of `stride`
// bytes.  `bpp` is the bytes per pixel (>= 1).  Returns 0, or row + 1 of
// the first row whose filter type is not 0-4.
inline int png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height, int64_t stride, int bpp) {
    const uint8_t* prev = nullptr;  // the reconstructed row above; none for row 0
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t type = src[y * (stride + 1)];
        const uint8_t* in = src + y * (stride + 1) + 1;
        uint8_t* out = dst + y * stride;
        switch (type) {
            case 0:
                for (int64_t x = 0; x < stride; ++x) out[x] = in[x];
                break;
            case 1:
                for (int64_t x = 0; x < stride; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
                break;
            case 2:
                for (int64_t x = 0; x < stride; ++x) out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
                break;
            case 3:
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? out[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? out[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + paeth(a, b, c));
                }
                break;
            default:
                return static_cast<int>(y + 1);
        }
        prev = out;
    }
    return 0;
}

}  // namespace rick
