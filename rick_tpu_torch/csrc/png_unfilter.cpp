// The PNG row unfilter (`png_unfilter.h`) as the C entry point of
// `data/png.py`.
//
// Built with g++ into its own shared library and called through ctypes.

#include "png_unfilter.h"

// `src` holds `height` rows of 1 filter-type byte + `stride` filtered bytes
// (the inflated IDAT stream); `dst` receives `height` rows of `stride`
// bytes.  `bpp` is the bytes per pixel (>= 1).  Returns 0, or row + 1 of
// the first row whose filter type is not 0-4.
extern "C" int rick_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height, int64_t stride, int bpp) {
    return rick::png_unfilter(src, dst, height, stride, bpp);
}
