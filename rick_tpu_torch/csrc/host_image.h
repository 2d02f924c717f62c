// What the batch decoder's readers (`png_decode.h`, `jpeg_parse.h`) share:
// the decoded image and the way a refusal is worded.

#pragma once

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace rick {

// 8-bit RGB, HWC
struct RgbImage {
    std::vector<uint8_t> rgb;
    int h = 0, w = 0;
};

// printf into *err (the reason a blob is refused); returns false
__attribute__((format(printf, 2, 3))) inline bool refuse(std::string* err, const char* fmt, ...) {
    char buf[512];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof(buf), fmt, ap);
    va_end(ap);
    *err = buf;
    return false;
}

}  // namespace rick
