// The C entry point of `data/jpeg.py::decode_jpeg`: the markers parsed by
// `jpeg_parse.h`, the image decoded by `jpeg_core.h`.
//
// Built with g++ (`ops/_build.host_library`) into its own shared library and
// called through ctypes.

#include <cstdio>
#include <string>

#include "jpeg_parse.h"

// blob: the JPEG's bytes, its SOI checked by the caller.  hw receives
// (height, width) once the markers parse.  With out NULL nothing more is
// done and 2 is returned; else out (height x width x 3 bytes) is decoded
// and 0 returned.  A refusal returns 1 with the reason in err_buf.
extern "C" int rick_jpeg_decode(const uint8_t* blob, int64_t len, int32_t* hw, uint8_t* out, char* err_buf,
                                int32_t err_len) {
    std::string why;
    rick::JpegTables t;
    bool ok = rick::jpeg_parse(blob, static_cast<size_t>(len), &t, &why);
    if (ok) {
        hw[0] = t.frame[rick::kHeight];
        hw[1] = t.frame[rick::kWidth];
        if (out == nullptr) return 2;
        ok = rick::jpeg_decode_parsed(blob, static_cast<size_t>(len), t, out, &why);
    }
    if (ok) return 0;
    std::snprintf(err_buf, err_len, "%s", why.c_str());
    return 1;
}
