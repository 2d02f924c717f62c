// PNG decode on the host, for the batch decoder (`rickdata.cpp`): the C++
// form of `data/png.py::decode_png`, with the same pixels and the same
// refusals, and no interpreter.
//
// The chunks are walked and each CRC checked; IHDR, PLTE and the IDAT
// stream are read (other chunks skipped), the stream inflated by
// `inflate.h`, the rows of each pass (one, or Adam7's seven) unfiltered by
// `png_unfilter.h`, and the samples written as 8-bit RGB: gray repeated over
// the three channels, sub-byte gray scaled to 0-255, a palette looked up,
// alpha (and tRNS) dropped, a 16-bit sample's high byte kept, as libpng does
// under png_set_strip_16 / png_set_strip_alpha and as `decode_png` does.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host_image.h"
#include "inflate.h"
#include "png_unfilter.h"

namespace rick {

constexpr uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

struct CrcTable {
    uint32_t t[8][256];  // t[k][b]: byte b followed by k zero bytes
    CrcTable() {
        for (uint32_t n = 0; n < 256; ++n) {
            uint32_t c = n;
            for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            t[0][n] = c;
        }
        for (int k = 1; k < 8; ++k)
            for (int n = 0; n < 256; ++n) t[k][n] = (t[k - 1][n] >> 8) ^ t[0][t[k - 1][n] & 0xFF];
    }
};

// CRC-32 of ISO 3309 (PNG, zlib's crc32), eight bytes a step ("slicing by
// 8", several times a byte-at-a-time loop's rate)
inline uint32_t crc32(const uint8_t* p, size_t n) {
    static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "the 8-byte step reads little-endian words");
    static const CrcTable table;
    const auto& t = table.t;
    uint32_t c = 0xFFFFFFFFu;
    for (; n >= 8; n -= 8, p += 8) {
        uint32_t lo, hi;
        std::memcpy(&lo, p, 4);
        std::memcpy(&hi, p + 4, 4);
        lo ^= c;
        c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^
            t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    }
    for (; n > 0; --n, ++p) c = t[0][(c ^ *p) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// a chunk type as Python prints bytes: b'IDAT'
inline std::string chunk_name(const uint8_t* t) {
    std::string s = "b'";
    for (int i = 0; i < 4; ++i) {
        if (t[i] >= 32 && t[i] < 127 && t[i] != '\'' && t[i] != '\\') {
            s += static_cast<char>(t[i]);
        } else {
            char hex[5];
            std::snprintf(hex, sizeof(hex), "\\x%02x", t[i]);
            s += hex;
        }
    }
    return s + "'";
}

inline const char* png_color_name(int color) {
    switch (color) {
        case 0: return "gray";
        case 2: return "RGB";
        case 3: return "palette";
        case 4: return "gray+alpha";
        case 6: return "RGBA";
        default: return "an unknown color type";
    }
}

// PNG bytes (the signature checked by the caller) -> img; false with the
// reason in *err
inline bool decode_png(const uint8_t* blob, size_t len, RgbImage* img, std::string* err) {
    static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                     {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
    static const int kPlain[1][4] = {{0, 0, 1, 1}};
    bool have_header = false, ended = false;
    uint32_t width = 0, height = 0;
    int depth = 0, color = 0, compression = 0, filter = 0, interlace = 0;
    const uint8_t* palette = nullptr;
    int palette_n = -1;
    std::vector<uint8_t> idat;
    size_t pos = 8;
    while (pos < len) {
        if (pos + 8 > len) return refuse(err, "PNG truncated in a chunk header at byte %zu", pos);
        const uint32_t length = be32(blob + pos);
        const uint8_t* type = blob + pos + 4;
        const uint8_t* data = blob + pos + 8;
        const uint64_t end = pos + 8 + uint64_t(length);
        if (end + 4 > len)
            return refuse(err, "PNG truncated in chunk %s at byte %zu", chunk_name(type).c_str(), pos);
        if (crc32(type, 4 + size_t(length)) != be32(blob + end))
            return refuse(err, "PNG chunk %s at byte %zu fails its CRC", chunk_name(type).c_str(), pos);
        if (std::memcmp(type, "IHDR", 4) == 0) {
            if (length != 13) return refuse(err, "PNG IHDR chunk holds %u bytes, not 13", length);
            width = be32(data);
            height = be32(data + 4);
            depth = data[8];
            color = data[9];
            compression = data[10];
            filter = data[11];
            interlace = data[12];
            have_header = true;
        } else if (std::memcmp(type, "PLTE", 4) == 0) {
            if (length % 3) return refuse(err, "PNG PLTE chunk holds %u bytes, not a multiple of 3", length);
            palette = data;
            palette_n = static_cast<int>(length / 3);
        } else if (std::memcmp(type, "IDAT", 4) == 0) {
            idat.insert(idat.end(), data, data + length);
        } else if (std::memcmp(type, "IEND", 4) == 0) {
            ended = true;
            break;
        }
        pos = end + 4;
    }
    if (!ended) return refuse(err, "PNG has no IEND chunk");
    if (!have_header) return refuse(err, "PNG has no IHDR chunk");
    if (width == 0 || height == 0) return refuse(err, "PNG has %s 0 in its IHDR", width == 0 ? "width" : "height");
    if (width > 0x7FFFFFFFu || height > 0x7FFFFFFFu)
        return refuse(err, "PNG of %ux%u is wider or taller than PNG allows (2^31 - 1)", width, height);
    int samples = 0;
    bool depth_ok = false;
    switch (color) {
        case 0: samples = 1; depth_ok = depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16; break;
        case 2: samples = 3; depth_ok = depth == 8 || depth == 16; break;
        case 3: samples = 1; depth_ok = depth == 1 || depth == 2 || depth == 4 || depth == 8; break;
        case 4: samples = 2; depth_ok = depth == 8 || depth == 16; break;
        case 6: samples = 4; depth_ok = depth == 8 || depth == 16; break;
        default: break;
    }
    if (!depth_ok || compression != 0 || filter != 0 || interlace > 1)
        return refuse(err, "PNG of %d-bit %s (color type %d, compression %d, filter %d, interlace %d) is not a valid PNG",
                      depth, png_color_name(color), color, compression, filter, interlace);
    if (color == 3 && palette_n < 0) return refuse(err, "PNG palette image has no PLTE chunk");
    if (uint64_t(width) * height > (uint64_t(1) << 31))
        return refuse(err, "PNG of %ux%u is too large to decode", width, height);
    const int bits = depth * samples;
    const auto& passes = interlace ? kAdam7 : kPlain;
    const int npasses = interlace ? 7 : 1;
    uint64_t need = 0;  // the bytes the passes' filtered rows take
    for (int k = 0; k < npasses; ++k) {
        const int64_t pw = (int64_t(width) - passes[k][0] + passes[k][2] - 1) / passes[k][2];
        const int64_t ph = (int64_t(height) - passes[k][1] + passes[k][3] - 1) / passes[k][3];
        if (pw > 0 && ph > 0) need += uint64_t(ph) * ((pw * bits + 7) / 8 + 1);
    }
    const char* il = interlace ? " interlaced" : "";
    InflateOut raw;
    raw.reserve(need < (uint64_t(1) << 26) ? need + 1 : uint64_t(1) << 26);
    if (const char* why = zlib_inflate(idat.data(), idat.size(), raw, need)) {
        if (std::strcmp(why, "more output than expected") == 0)
            return refuse(err, "PNG image data holds more bytes than %ux%u %d-bit %s%s needs (%llu)", width, height,
                          depth, png_color_name(color), il, static_cast<unsigned long long>(need));
        return refuse(err, "PNG image data does not inflate: %s", why);
    }
    if (raw.size != need)
        return refuse(err, "PNG image data holds %zu bytes, too few for %ux%u %d-bit %s%s (%llu)", raw.size, width,
                      height, depth, png_color_name(color), il, static_cast<unsigned long long>(need));

    uint8_t lut[256][3] = {};  // the palette, zero past its entries
    for (int i = 0; i < palette_n && i < 256; ++i)
        for (int c = 0; c < 3; ++c) lut[i][c] = palette[3 * i + c];
    const uint8_t scale = depth < 8 ? static_cast<uint8_t>(255 / ((1 << depth) - 1)) : 1;
    const int mask = (1 << (depth < 8 ? depth : 8)) - 1;
    int max_index = 0;
    img->w = static_cast<int>(width);
    img->h = static_cast<int>(height);
    img->rgb.assign(size_t(width) * height * 3, 0);
    std::vector<uint8_t> rows;
    size_t at = 0;
    for (int k = 0; k < npasses; ++k) {
        const int x0 = passes[k][0], y0 = passes[k][1], dx = passes[k][2], dy = passes[k][3];
        const int64_t pw = (int64_t(width) - x0 + dx - 1) / dx, ph = (int64_t(height) - y0 + dy - 1) / dy;
        if (pw <= 0 || ph <= 0) continue;
        const int64_t stride = (pw * bits + 7) / 8;
        rows.resize(size_t(ph * stride));
        if (const int bad = png_unfilter(raw.data + at, rows.data(), ph, stride, bits / 8 > 1 ? bits / 8 : 1))
            return refuse(err, "PNG row %d has filter type %d, not 0-4", bad - 1,
                          raw.data[at + size_t(bad - 1) * (stride + 1)]);
        at += size_t(ph * (stride + 1));
        for (int64_t r = 0; r < ph; ++r) {
            const uint8_t* row = rows.data() + r * stride;
            uint8_t* o = img->rgb.data() + (size_t(y0 + r * dy) * width + x0) * 3;
            for (int64_t x = 0; x < pw; ++x, o += 3 * dx) {
                if (depth < 8) {  // gray or palette, 1/2/4 bits, most significant first
                    const int64_t bit = x * depth;
                    const int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
                    if (color == 3) {
                        max_index = v > max_index ? v : max_index;
                        o[0] = lut[v][0], o[1] = lut[v][1], o[2] = lut[v][2];
                    } else {
                        o[0] = o[1] = o[2] = static_cast<uint8_t>(v * scale);
                    }
                    continue;
                }
                const int step = depth / 8;  // a sample's bytes; its first is its high byte
                const uint8_t* s = row + x * samples * step;
                if (color == 3) {
                    max_index = s[0] > max_index ? s[0] : max_index;
                    o[0] = lut[s[0]][0], o[1] = lut[s[0]][1], o[2] = lut[s[0]][2];
                } else if (samples <= 2) {
                    o[0] = o[1] = o[2] = s[0];
                } else {
                    o[0] = s[0], o[1] = s[step], o[2] = s[2 * step];
                }
            }
        }
    }
    if (color == 3 && max_index >= palette_n)
        return refuse(err, "PNG pixel indexes entry %d of a %d-entry palette", max_index, palette_n);
    return true;
}

}  // namespace rick
