// WebP decoding on the host: the VP8L (lossless) bitstream and the VP8
// (lossy) key frame, to the RGB that Pillow's `Image.open(f).convert("RGB")`
// gives.  Pillow decodes through libwebp's WebPAnimDecoder in MODE_RGBA,
// which does not premultiply, so the RGB does not depend on the alpha
// channel and the alpha is not decoded here (`data/webp.py` parses the RIFF
// container and skips ALPH).
//
// VP8L (RFC 9649) is exact by construction.  VP8 (RFC 6386) is decoded as
// libwebp decodes it: the boolean decoder, the token and mode trees with the
// RFC's default probabilities, dequantization, the inverse WHT and DCT,
// intra prediction from the unfiltered reconstruction (libwebp's border
// values 127 above and 129 left), and the normal or simple loop filter over
// the whole frame in macroblock order.  The RGB is libwebp's: its "fancy"
// upsampler (a 9-3-3-1 bilinear chroma filter on row pairs) and its 14-bit
// fixed-point YUV->RGB, the arithmetic written out as libwebp's C does it,
// which its SIMD paths reproduce bit for bit.
//
// Built with g++ into its own shared library and called through ctypes.  No
// library is needed.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Error {
    const char* what;
};

[[noreturn]] void fail(const char* what) { throw Error{what}; }

// ---------------------------------------------------------------------------
// VP8L
// ---------------------------------------------------------------------------

struct BitReader {  // LSB first
    const uint8_t* p;
    int64_t n, pos = 0;  // pos in bits
    BitReader(const uint8_t* data, int64_t size) : p(data), n(size) {}
    uint32_t bits(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i, ++pos) {
            if ((pos >> 3) >= n) fail("VP8L data ends early");
            v |= static_cast<uint32_t>((p[pos >> 3] >> (pos & 7)) & 1) << i;
        }
        return v;
    }
    int bit() {
        if ((pos >> 3) >= n) fail("VP8L data ends early");
        const int b = (p[pos >> 3] >> (pos & 7)) & 1;
        ++pos;
        return b;
    }
};

// A canonical prefix code read bit by bit (deflate's packing: the code's
// first bit is its most significant).  One symbol of non-zero length is a
// code of zero bits.
struct Prefix {
    std::vector<int> count, symbols;  // count[len], symbols by (len, value)
    int single = -1;
    void build(const std::vector<int>& lengths) {
        count.assign(16, 0);
        int nonzero = 0, last = -1;
        for (size_t s = 0; s < lengths.size(); ++s) {
            if (lengths[s] > 15) fail("VP8L code length above 15");
            if (lengths[s]) ++nonzero, last = static_cast<int>(s), ++count[lengths[s]];
        }
        if (nonzero == 0) fail("VP8L prefix code without symbols");
        if (nonzero == 1) {
            single = last;
            return;
        }
        single = -1;
        int left = 1;  // the code must be complete
        for (int len = 1; len < 16; ++len) {
            left = 2 * left - count[len];
            if (left < 0) fail("VP8L prefix code over-subscribed");
        }
        if (left != 0) fail("VP8L prefix code incomplete");
        std::vector<int> offs(16, 0);
        for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
        symbols.assign(nonzero, 0);
        for (size_t s = 0; s < lengths.size(); ++s)
            if (lengths[s]) symbols[offs[lengths[s]]++] = static_cast<int>(s);
    }
    int read(BitReader& br) const {
        if (single >= 0) return single;
        int code = 0, first = 0, index = 0;
        for (int len = 1; len < 16; ++len) {
            code |= br.bit();
            const int c = count[len];
            if (code - first < c) return symbols[index + code - first];
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        fail("VP8L prefix code not matched");
    }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

void read_code(BitReader& br, int alphabet, Prefix& out) {
    std::vector<int> lengths(alphabet, 0);
    if (br.bit()) {  // simple code: one or two symbols
        const int num = br.bit() + 1;
        const int first8 = br.bit();
        const int s0 = static_cast<int>(br.bits(first8 ? 8 : 1));
        if (s0 >= alphabet) fail("VP8L simple code symbol out of range");
        lengths[s0] = 1;
        if (num == 2) {
            const int s1 = static_cast<int>(br.bits(8));
            if (s1 >= alphabet) fail("VP8L simple code symbol out of range");
            lengths[s1] = 1;
        }
        out.build(lengths);
        return;
    }
    std::vector<int> cl_lengths(19, 0);
    const int num_codes = static_cast<int>(br.bits(4)) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br.bits(3));
    Prefix cl;
    cl.build(cl_lengths);
    int max_symbol = alphabet;
    if (br.bit()) {
        const int length_nbits = 2 + 2 * static_cast<int>(br.bits(3));
        max_symbol = 2 + static_cast<int>(br.bits(length_nbits));
        if (max_symbol > alphabet) fail("VP8L max_symbol beyond the alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br);
        if (len < 16) {
            lengths[symbol++] = len;
            if (len) prev = len;
        } else {
            const int slot = len - 16;
            const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
            int repeat = static_cast<int>(br.bits(extra[slot])) + offset[slot];
            if (symbol + repeat > alphabet) fail("VP8L code lengths overflow the alphabet");
            const int v = slot == 0 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = v;
        }
    }
    out.build(lengths);
}

struct Group {
    Prefix green, red, blue, alpha, dist;
};

int prefix_value(BitReader& br, int prefix) {
    if (prefix < 4) return prefix + 1;
    const int extra = (prefix - 2) >> 1;
    const int offset = (2 + (prefix & 1)) << extra;
    return offset + static_cast<int>(br.bits(extra)) + 1;
}

const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

int64_t plane_distance(int64_t xsize, int code) {
    if (code > 120) return code - 120;
    const int dc = kCodeToPlane[code - 1];
    const int64_t d = (dc >> 4) * xsize + (8 - (dc & 15));
    return d >= 1 ? d : 1;
}

inline int64_t div_round_up(int64_t a, int bits) { return (a + (int64_t(1) << bits) - 1) >> bits; }

std::vector<uint32_t> decode_stream(BitReader& br, int64_t xsize, int64_t ysize, bool level0);

struct Transform {
    int type, bits;
    int64_t xsize;  // the image width when the transform was read
    std::vector<uint32_t> data;
};

std::vector<uint32_t> decode_entropy(BitReader& br, int64_t xsize, int64_t ysize, bool level0) {
    int cache_bits = 0;
    if (br.bit()) {
        cache_bits = static_cast<int>(br.bits(4));
        if (cache_bits < 1 || cache_bits > 11) fail("VP8L colour cache size out of range");
    }
    int meta_bits = 0;
    int64_t meta_xsize = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && br.bit()) {
        meta_bits = static_cast<int>(br.bits(3)) + 2;
        meta_xsize = div_round_up(xsize, meta_bits);
        meta = decode_stream(br, meta_xsize, div_round_up(ysize, meta_bits), false);
        for (uint32_t& m : meta) {
            m = (m >> 8) & 0xffff;
            if (static_cast<int>(m) + 1 > groups) groups = static_cast<int>(m) + 1;
        }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Group> g(groups);
    for (Group& grp : g) {
        read_code(br, 256 + 24 + cache_size, grp.green);
        read_code(br, 256, grp.red);
        read_code(br, 256, grp.blue);
        read_code(br, 256, grp.alpha);
        read_code(br, 40, grp.dist);
    }
    std::vector<uint32_t> cache(cache_size, 0);
    std::vector<uint32_t> px(static_cast<size_t>(xsize * ysize));
    const int64_t total = xsize * ysize;
    auto put = [&](int64_t i, uint32_t argb) {
        px[i] = argb;
        if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    int64_t i = 0;
    while (i < total) {
        const int64_t x = i % xsize, y = i / xsize;
        const Group& grp = meta.empty() ? g[0] : g[meta[(y >> meta_bits) * meta_xsize + (x >> meta_bits)]];
        const int s = grp.green.read(br);
        if (s < 256) {
            const uint32_t r = grp.red.read(br), b = grp.blue.read(br), a = grp.alpha.read(br);
            put(i++, (a << 24) | (r << 16) | (static_cast<uint32_t>(s) << 8) | b);
        } else if (s < 256 + 24) {
            const int64_t len = prefix_value(br, s - 256);
            const int64_t dist = plane_distance(xsize, prefix_value(br, grp.dist.read(br)));
            if (dist > i || i + len > total) fail("VP8L backward reference out of the image");
            for (int64_t k = 0; k < len; ++k, ++i) put(i, px[i - dist]);
        } else {
            const int key = s - 280;
            if (key >= cache_size) fail("VP8L colour cache index out of range");
            put(i++, cache[key]);
        }
    }
    return px;
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) | (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int ch(uint32_t v, int s) { return (v >> s) & 0xff; }
inline uint32_t select_px(uint32_t L, uint32_t T, uint32_t TL) {
    int pa_minus_pb = 0;  // sum |L - TL| - |T - TL| over the channels
    for (int s = 0; s < 32; s += 8) pa_minus_pb += std::abs(ch(L, s) - ch(TL, s)) - std::abs(ch(T, s) - ch(TL, s));
    return pa_minus_pb <= 0 ? T : L;
}
inline int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) out |= static_cast<uint32_t>(clamp255(ch(a, s) + ch(b, s) - ch(c, s))) << s;
    return out;
}
inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int x = ch(a, s), y = ch(b, s);
        out |= static_cast<uint32_t>(clamp255(x + (x - y) / 2)) << s;
    }
    return out;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
    switch (mode) {
        case 0: return 0xff000000u;
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return avg2(avg2(L, TR), T);
        case 6: return avg2(L, TL);
        case 7: return avg2(L, T);
        case 8: return avg2(TL, T);
        case 9: return avg2(T, TR);
        case 10: return avg2(avg2(L, TL), avg2(T, TR));
        case 11: return select_px(L, T, TL);
        case 12: return clamp_add_sub_full(L, T, TL);
        case 13: return clamp_add_sub_half(avg2(L, T), TL);
        default: return 0xff000000u;  // 14 and 15, as libwebp
    }
}

void inverse(const Transform& t, std::vector<uint32_t>& px, int64_t& xsize, int64_t ysize) {
    const int64_t w = xsize;
    if (t.type == 0) {  // predictor
        const int64_t bw = div_round_up(w, t.bits);
        for (int64_t y = 0; y < ysize; ++y) {
            for (int64_t x = 0; x < w; ++x) {
                uint32_t pred;
                const int64_t i = y * w + x;
                if (y == 0) {
                    pred = x == 0 ? 0xff000000u : px[i - 1];
                } else if (x == 0) {
                    pred = px[i - w];
                } else {
                    const int mode = (t.data[(y >> t.bits) * bw + (x >> t.bits)] >> 8) & 15;
                    pred = predict(mode, px[i - 1], px[i - w], px[i - w + 1], px[i - w - 1]);
                }
                px[i] = add_px(px[i], pred);
            }
        }
    } else if (t.type == 1) {  // cross colour
        const int64_t bw = div_round_up(w, t.bits);
        for (int64_t y = 0; y < ysize; ++y) {
            for (int64_t x = 0; x < w; ++x) {
                const uint32_t e = t.data[(y >> t.bits) * bw + (x >> t.bits)];
                const int g2r = static_cast<int8_t>(e & 0xff), g2b = static_cast<int8_t>((e >> 8) & 0xff);
                const int r2b = static_cast<int8_t>((e >> 16) & 0xff);
                uint32_t& p = px[y * w + x];
                const int green = static_cast<int8_t>((p >> 8) & 0xff);
                int red = (p >> 16) & 0xff, blue = p & 0xff;
                red = (red + ((g2r * green) >> 5)) & 0xff;
                blue = (blue + ((g2b * green) >> 5)) & 0xff;
                blue = (blue + ((r2b * static_cast<int8_t>(red)) >> 5)) & 0xff;
                p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
            }
        }
    } else if (t.type == 2) {  // subtract green
        for (uint32_t& p : px) {
            const uint32_t g = (p >> 8) & 0xff;
            p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) | (((p & 0xff) + g) & 0xff);
        }
    } else {  // colour indexing
        const int bits = t.bits;
        const int64_t full = t.xsize;
        std::vector<uint32_t> out(static_cast<size_t>(full * ysize));
        const int per = 1 << bits, width_bits = 8 >> bits, mask = (1 << width_bits) - 1;
        for (int64_t y = 0; y < ysize; ++y)
            for (int64_t x = 0; x < full; ++x) {
                const uint32_t packed = (px[y * w + (x >> bits)] >> 8) & 0xff;
                const int idx = (packed >> ((x & (per - 1)) * width_bits)) & mask;
                out[y * full + x] = t.data[idx];
            }
        px.swap(out);
        xsize = full;
    }
}

std::vector<uint32_t> decode_stream(BitReader& br, int64_t xsize, int64_t ysize, bool level0) {
    std::vector<Transform> transforms;
    int64_t width = xsize;
    if (level0) {
        int seen = 0;
        while (br.bit()) {
            Transform t;
            t.type = static_cast<int>(br.bits(2));
            if (seen & (1 << t.type)) fail("VP8L transform used twice");
            seen |= 1 << t.type;
            t.xsize = width;
            t.bits = 0;
            if (t.type == 0 || t.type == 1) {
                t.bits = static_cast<int>(br.bits(3)) + 2;
                t.data = decode_stream(br, div_round_up(width, t.bits), div_round_up(ysize, t.bits), false);
            } else if (t.type == 3) {
                const int num = static_cast<int>(br.bits(8)) + 1;
                t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
                std::vector<uint32_t> pal = decode_stream(br, num, 1, false);
                for (int k = 1; k < num; ++k) pal[k] = add_px(pal[k], pal[k - 1]);
                t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0u);  // indices beyond read 0
                for (int k = 0; k < num && k < static_cast<int>(t.data.size()); ++k) t.data[k] = pal[k];
                width = div_round_up(width, t.bits);
            }
            transforms.push_back(std::move(t));
        }
    }
    std::vector<uint32_t> px = decode_entropy(br, width, ysize, level0);
    for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) inverse(*it, px, width, ysize);
    return px;
}

}  // namespace

// VP8L bitstream (the chunk's payload, from its signature byte) -> RGB
// (height, width, 3).  Returns 0, or 1 with a message in `err`.
extern "C" int rick_webp_vp8l(const uint8_t* data, int64_t n, int width, int height, uint8_t* rgb, char* err,
                              int errlen) {
    try {
        BitReader br(data, n);
        if (br.bits(8) != 0x2f) fail("VP8L signature missing");
        const int w = static_cast<int>(br.bits(14)) + 1, h = static_cast<int>(br.bits(14)) + 1;
        br.bits(1);  // alpha_is_used: a hint only
        if (br.bits(3) != 0) fail("VP8L version is not 0");
        if (w != width || h != height) fail("VP8L size differs from the container's");
        std::vector<uint32_t> px = decode_stream(br, w, h, true);
        for (int64_t i = 0; i < int64_t(w) * h; ++i) {
            rgb[3 * i] = (px[i] >> 16) & 0xff;
            rgb[3 * i + 1] = (px[i] >> 8) & 0xff;
            rgb[3 * i + 2] = px[i] & 0xff;
        }
        return 0;
    } catch (const Error& e) {
        std::snprintf(err, errlen, "%s", e.what);
        return 1;
    } catch (const std::bad_alloc&) {
        std::snprintf(err, errlen, "out of memory");
        return 1;
    }
}

// ---------------------------------------------------------------------------
// VP8 (lossy key frames)
// ---------------------------------------------------------------------------

namespace {

// the RFC 6386 constants, in libwebp's order of the intra modes
// (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
static const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
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
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8,
                                  -B_HD, -B_HU};

// The boolean decoder of RFC 6386 section 7; reads past the end as zeros.
struct BoolDecoder {
    const uint8_t* p = nullptr;
    int64_t n = 0, pos = 0;
    uint32_t range = 255, value = 0;
    int bit_count = 0;
    void init(const uint8_t* data, int64_t size) {
        p = data, n = size, pos = 0, range = 255, bit_count = 0;
        value = (static_cast<uint32_t>(byte()) << 8) | byte();
    }
    uint8_t byte() { return pos < n ? p[pos++] : (++pos, 0); }
    int get(int prob) {
        const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
        const uint32_t big = split << 8;
        int ret;
        if (value >= big) {
            ret = 1;
            range -= split;
            value -= big;
        } else {
            ret = 0;
            range = split;
        }
        while (range < 128) {
            value <<= 1;
            range <<= 1;
            if (++bit_count == 8) {
                bit_count = 0;
                value |= byte();
            }
        }
        return ret;
    }
    int value_bits(int bits) {
        int v = 0;
        while (bits-- > 0) v |= get(0x80) << bits;
        return v;
    }
    int flag() { return get(0x80); }
    int signed_value(int bits) {
        const int v = value_bits(bits);
        return flag() ? -v : v;
    }
    bool overrun() const { return pos > n + 2; }
};

struct Quant {
    int y1[2], y2[2], uv[2];
};

struct FInfo {
    int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

struct MBInfo {
    int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
    uint8_t imodes[16];
    int16_t coeffs[384];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// --- inverse transforms (libwebp's TransformOne and TransformWHT) ---

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform(const int16_t* in, uint8_t* dst, int stride) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
        const int a = in[0] + in[8], b = in[0] - in[8];
        const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d, tmp[1] = b + c, tmp[2] = b - c, tmp[3] = a - d;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i, ++tmp, dst += stride) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8], b = dc - tmp[8];
        const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1, tmp[8 + i] = a0 - a1, tmp[4 + i] = a3 + a2, tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i, out += 64) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = static_cast<int16_t>((a0 + a1) >> 3);
        out[16] = static_cast<int16_t>((a3 + a2) >> 3);
        out[32] = static_cast<int16_t>((a0 - a1) >> 3);
        out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    }
}

// --- token parsing (libwebp's GetCoeffs) ---

typedef uint8_t ProbaArray[3][11];

int large_value(BoolDecoder& br, const uint8_t* p) {
    int v;
    if (!br.get(p[3])) {
        v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
    } else if (!br.get(p[6])) {
        if (!br.get(p[7])) {
            v = 5 + br.get(159);
        } else {
            v = 7 + 2 * br.get(165);
            v += br.get(145);
        }
    } else {
        const int bit1 = br.get(p[8]);
        const int bit0 = br.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
        v += 3 + (8 << cat);
    }
    return v;
}

// Returns the position after the last coefficient read (16 at most).
int get_coeffs(BoolDecoder& br, const ProbaArray* bands[17], int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = (*bands[n])[ctx];
    for (; n < 16; ++n) {
        if (!br.get(p[0])) return n;  // end of block
        while (!br.get(p[1])) {  // a zero
            p = (*bands[++n])[0];
            if (n == 16) return 16;
        }
        const ProbaArray& next = *bands[n + 1];
        int v;
        if (!br.get(p[2])) {
            v = 1;
            p = next[1];
        } else {
            v = large_value(br, p);
            p = next[2];
        }
        out[kZigzag[n]] = static_cast<int16_t>((br.get(0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
}

struct NZ {
    uint8_t nz = 0, nz_dc = 0;  // bits 0-3 Y, 4-5 U, 6-7 V
};

// libwebp's ParseResiduals; returns whether every coefficient is zero.
int parse_residuals(BoolDecoder& br, const ProbaArray* bands[4][17], const Quant& q, MBInfo& mb, NZ& top,
                    NZ& left) {
    int16_t* dst = mb.coeffs;
    std::memset(dst, 0, sizeof(mb.coeffs));
    const ProbaArray** ac;
    int first;
    if (!mb.is_i4x4) {
        int16_t dc[16] = {0};
        const int ctx = top.nz_dc + left.nz_dc;
        const int nz = get_coeffs(br, bands[1], ctx, q.y2, 0, dc);
        top.nz_dc = left.nz_dc = (nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
        }
        first = 1;
        ac = bands[0];
    } else {
        first = 0;
        ac = bands[3];
    }
    uint32_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f, non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        uint32_t nz_coeffs = 0;
        for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(br, ac, ctx, q.y1, first, dst);
            l = (nz > first);
            tnz = (tnz >> 1) | (l << 7);
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
        }
        tnz >>= 4;
        lnz = (lnz >> 1) | (l << 7);
        non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int c = 0; c < 4; c += 2) {
        uint32_t nz_coeffs = 0;
        tnz = top.nz >> (4 + c);
        lnz = left.nz >> (4 + c);
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                const int ctx = l + (tnz & 1);
                const int nz = get_coeffs(br, bands[2], ctx, q.uv, 0, dst);
                l = (nz > 0);
                tnz = (tnz >> 1) | (l << 3);
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
        }
        non_zero_uv |= nz_coeffs << (4 * c);
        out_t_nz |= (tnz << 4) << c;
        out_l_nz |= (lnz & 0xf0) << c;
    }
    top.nz = static_cast<uint8_t>(out_t_nz);
    left.nz = static_cast<uint8_t>(out_l_nz);
    mb.non_zero_y = non_zero_y;
    mb.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
}

// --- intra prediction (libwebp's, on a plane with stride `s`) ---

#define DST(x, y) dst[(x) + (y) * s]
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int s, int size) {
    const uint8_t* top = dst - s;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x) DST(x, y) = clip8(top[x] + dst[y * s - 1] - tl);
}

void pred4(uint8_t* dst, int s, int mode, const uint8_t* above_right) {
    const uint8_t* top = dst - s;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = above_right[0], F = above_right[1], G = above_right[2], H = above_right[3];
    const int I = dst[-1], J = dst[s - 1], K = dst[2 * s - 1], L = dst[3 * s - 1];
    switch (mode) {
        case B_DC: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * s - 1];
            dc >>= 3;
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = static_cast<uint8_t>(dc);
            break;
        }
        case B_TM: true_motion(dst, s, 4); break;
        case B_VE: {
            const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
            break;
        }
        case B_HE: {
            const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
            break;
        }
        case B_RD:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // B_HU
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
    }
}

// 16x16 luma and 8x8 chroma: DC (with libwebp's edge variants), TM, VE, HE
void pred_block(uint8_t* dst, int s, int size, int mode, bool has_top, bool has_left) {
    const int shift = size == 16 ? 4 : 3;
    if (mode == B_DC) {
        int dc = 0;
        if (has_top && has_left) {
            for (int i = 0; i < size; ++i) dc += dst[i - s] + dst[i * s - 1];
            dc = (dc + size) >> (shift + 1);
        } else if (has_left) {
            for (int i = 0; i < size; ++i) dc += dst[i * s - 1];
            dc = (dc + (size >> 1)) >> shift;
        } else if (has_top) {
            for (int i = 0; i < size; ++i) dc += dst[i - s];
            dc = (dc + (size >> 1)) >> shift;
        } else {
            dc = 0x80;
        }
        for (int y = 0; y < size; ++y) std::memset(dst + y * s, dc, size);
    } else if (mode == B_TM) {
        true_motion(dst, s, size);
    } else if (mode == B_VE) {
        for (int y = 0; y < size; ++y) std::memcpy(dst + y * s, dst - s, size);
    } else {  // B_HE
        for (int y = 0; y < size; ++y) std::memset(dst + y * s, dst[y * s - 1], size);
    }
}
#undef DST

// --- loop filter (libwebp's, RFC 6386 section 15) ---

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
    return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
    return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `hstride` across the edge, `vstride` along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, t2, ithresh)) continue;
        if (hev(p, hstride, hev_t)) {
            do_filter2(p, hstride);
        } else if (mb_edge) {
            do_filter6(p, hstride);
        } else {
            do_filter4(p, hstride);
        }
    }
}

struct Frame {  // planes with one border row above and column left; Y0/U0/V0 are pixel (0, 0)
    uint8_t *Y0, *U0, *V0;
    int ys, uvs;
};

void filter_mb(const Frame& fr, int mb_x, int mb_y, const FInfo& f, int filter_type) {
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = fr.ys, uvs = fr.uvs;
    uint8_t* yd = fr.Y0 + (mb_y * 16) * ys + mb_x * 16;
    if (filter_type == 1) {
        if (mb_x > 0) simple_edge(yd, 1, ys, limit + 4);
        if (f.inner)
            for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(yd, ys, 1, limit + 4);
        if (f.inner)
            for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k * ys, ys, 1, limit);
        return;
    }
    uint8_t* ud = fr.U0 + (mb_y * 8) * uvs + mb_x * 8;
    uint8_t* vd = fr.V0 + (mb_y * 8) * uvs + mb_x * 8;
    const int il = f.ilevel, hv = f.hev;
    if (mb_x > 0) {
        complex_edge(yd, 1, ys, 16, limit + 4, il, hv, true);
        complex_edge(ud, 1, uvs, 8, limit + 4, il, hv, true);
        complex_edge(vd, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
        for (int k = 1; k < 4; ++k) complex_edge(yd + 4 * k, 1, ys, 16, limit, il, hv, false);
        complex_edge(ud + 4, 1, uvs, 8, limit, il, hv, false);
        complex_edge(vd + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
        complex_edge(yd, ys, 1, 16, limit + 4, il, hv, true);
        complex_edge(ud, uvs, 1, 8, limit + 4, il, hv, true);
        complex_edge(vd, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
        for (int k = 1; k < 4; ++k) complex_edge(yd + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
        complex_edge(ud + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        complex_edge(vd + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
}

// --- YUV -> RGB (libwebp's yuv.h) and the fancy upsampler (upsampling.c) ---

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

#define LOAD_UV(u, v) ((u) | ((v) << 16))
void upsample_line_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                        const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
    const int last_pixel_pair = (len - 1) >> 1;
    uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
    uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
    {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pixel_pair; ++x) {
        const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
        const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
        const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
            const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
            const uint32_t uv1 = (diag_03 + t_uv) >> 1;
            yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
            yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
        }
        if (bottom_y) {
            const uint32_t uv0 = (diag_03 + l_uv) >> 1;
            const uint32_t uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
            yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 3);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        {
            const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
        }
        if (bottom_y) {
            const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
        }
    }
}
#undef LOAD_UV

void decode_vp8(const uint8_t* data, int64_t n, int width, int height, uint8_t* rgb) {
    if (n < 10) fail("VP8 data too short");
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    if (bits & 1) fail("VP8 frame is not a key frame");
    if (((bits >> 1) & 7) > 3) fail("VP8 profile above 3");
    if (!((bits >> 4) & 1)) fail("VP8 frame not shown");
    const int64_t part0 = bits >> 5;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8 start code missing");
    const int w = (data[6] | (data[7] << 8)) & 0x3fff, h = (data[8] | (data[9] << 8)) & 0x3fff;
    if (w != width || h != height) fail("VP8 size differs from the container's");
    if (10 + part0 > n) fail("VP8 first partition beyond the data");
    BoolDecoder br;
    br.init(data + 10, part0);
    br.flag();  // colour space
    br.flag();  // clamping type: libwebp always clamps
    // segment header
    int use_segment = br.flag(), update_map = 0, absolute_delta = 1;
    int seg_q[4] = {0}, seg_f[4] = {0}, seg_proba[3] = {255, 255, 255};
    if (use_segment) {
        update_map = br.flag();
        if (br.flag()) {  // update data
            absolute_delta = br.flag();
            for (int s = 0; s < 4; ++s) seg_q[s] = br.flag() ? br.signed_value(7) : 0;
            for (int s = 0; s < 4; ++s) seg_f[s] = br.flag() ? br.signed_value(6) : 0;
        }
        if (update_map)
            for (int s = 0; s < 3; ++s) seg_proba[s] = br.flag() ? br.value_bits(8) : 255;
    }
    // filter header
    const int simple = br.flag(), level = br.value_bits(6), sharpness = br.value_bits(3);
    const int use_lf_delta = br.flag();
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    if (use_lf_delta && br.flag()) {
        for (int i = 0; i < 4; ++i)
            if (br.flag()) ref_lf_delta[i] = br.signed_value(6);
        for (int i = 0; i < 4; ++i)
            if (br.flag()) mode_lf_delta[i] = br.signed_value(6);
    }
    const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // partitions
    const int num_parts = 1 << br.value_bits(2);
    const uint8_t* sizes = data + 10 + part0;
    const int64_t left_after = n - 10 - part0;
    if (left_after < 3 * (num_parts - 1)) fail("VP8 partition sizes beyond the data");
    std::vector<BoolDecoder> parts(num_parts);
    {
        const uint8_t* p = sizes + 3 * (num_parts - 1);
        int64_t left = left_after - 3 * (num_parts - 1);
        for (int i = 0; i < num_parts; ++i) {
            int64_t sz = left;
            if (i < num_parts - 1) {
                sz = sizes[3 * i] | (sizes[3 * i + 1] << 8) | (sizes[3 * i + 2] << 16);
                if (sz > left) fail("VP8 token partition beyond the data");
            }
            parts[i].init(p, sz);
            p += sz;
            left -= sz;
        }
    }
    // quantizers
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.flag() ? br.signed_value(4) : 0, dqy2_dc = br.flag() ? br.signed_value(4) : 0;
    const int dqy2_ac = br.flag() ? br.signed_value(4) : 0, dquv_dc = br.flag() ? br.signed_value(4) : 0;
    const int dquv_ac = br.flag() ? br.signed_value(4) : 0;
    Quant quant[4];
    auto clipq = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
        int q = base_q0;
        if (use_segment) {
            q = seg_q[s];
            if (!absolute_delta) q += base_q0;
        }
        Quant& m = quant[s];
        m.y1[0] = kDcTable[clipq(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clipq(q, 127)];
        m.y2[0] = kDcTable[clipq(q + dqy2_dc, 127)] * 2;
        m.y2[1] = (kAcTable[clipq(q + dqy2_ac, 127)] * 101581) >> 16;
        if (m.y2[1] < 8) m.y2[1] = 8;
        m.uv[0] = kDcTable[clipq(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clipq(q + dquv_ac, 127)];
    }
    br.flag();  // refresh entropy probabilities: ignored for a key frame, as libwebp
    // token probabilities
    static thread_local ProbaArray proba[4][8];
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    proba[t][b][c][p] = static_cast<uint8_t>(
                        br.get(kCoeffsUpdateProba[t][b][c][p]) ? br.value_bits(8) : kCoeffsProba0[t][b][c][p]);
    const ProbaArray* bands[4][17];
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 17; ++b) bands[t][b] = &proba[t][kBands[b]];
    const int use_skip = br.flag();
    const int skip_p = use_skip ? br.value_bits(8) : 0;
    // filter strengths per segment and intra-4x4 flag
    FInfo fstr[4][2];
    if (filter_type > 0) {
        for (int s = 0; s < 4; ++s) {
            int base = level;
            if (use_segment) {
                base = seg_f[s];
                if (!absolute_delta) base += level;
            }
            for (int i4 = 0; i4 <= 1; ++i4) {
                FInfo& f = fstr[s][i4];
                int lv = base;
                if (use_lf_delta) {
                    lv += ref_lf_delta[0];
                    if (i4) lv += mode_lf_delta[0];
                }
                lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
                if (lv > 0) {
                    int il = lv;
                    if (sharpness > 0) {
                        il >>= sharpness > 4 ? 2 : 1;
                        if (il > 9 - sharpness) il = 9 - sharpness;
                    }
                    if (il < 1) il = 1;
                    f.ilevel = il;
                    f.limit = 2 * lv + il;
                    f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
                } else {
                    f.limit = 0;
                }
                f.inner = i4;
            }
        }
    }

    const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
    Frame fr;
    fr.ys = mb_w * 16 + 1, fr.uvs = mb_w * 8 + 1;
    std::vector<uint8_t> ybuf(static_cast<size_t>(fr.ys) * (mb_h * 16 + 1));
    std::vector<uint8_t> ubuf(static_cast<size_t>(fr.uvs) * (mb_h * 8 + 1)), vbuf(ubuf.size());
    fr.Y0 = ybuf.data() + fr.ys + 1, fr.U0 = ubuf.data() + fr.uvs + 1, fr.V0 = vbuf.data() + fr.uvs + 1;
    // libwebp's prediction borders: 127 above the frame (its corner too), 129 left of it
    std::memset(ybuf.data(), 127, fr.ys);
    std::memset(ubuf.data(), 127, fr.uvs);
    std::memset(vbuf.data(), 127, fr.uvs);
    std::vector<uint8_t> intra_t(mb_w * 4, B_DC);
    std::vector<NZ> top_nz(mb_w);
    std::vector<FInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
    std::vector<MBInfo> row(mb_w);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        // modes of the row (first partition)
        uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MBInfo& mb = row[mb_x];
            mb.segment = update_map ? (!br.get(seg_proba[0]) ? br.get(seg_proba[1]) : br.get(seg_proba[2]) + 2) : 0;
            mb.skip = use_skip ? br.get(skip_p) : 0;
            mb.is_i4x4 = !br.get(145);
            uint8_t* top = &intra_t[4 * mb_x];
            if (!mb.is_i4x4) {
                const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
                mb.imodes[0] = static_cast<uint8_t>(ymode);
                std::memset(top, ymode, 4);
                std::memset(intra_l, ymode, 4);
            } else {
                uint8_t* modes = mb.imodes;
                for (int y = 0; y < 4; ++y) {
                    int ymode = intra_l[y];
                    for (int x = 0; x < 4; ++x) {
                        const uint8_t* prob = kBModesProba[top[x]][ymode];
                        int i = kYModesIntra4[br.get(prob[0])];
                        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
                        ymode = -i;
                        top[x] = static_cast<uint8_t>(ymode);
                    }
                    std::memcpy(modes, top, 4);
                    modes += 4;
                    intra_l[y] = static_cast<uint8_t>(ymode);
                }
            }
            mb.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
        }
        if (br.overrun()) fail("VP8 first partition ends early");
        // residuals (token partition) and reconstruction
        BoolDecoder& tb = parts[mb_y & (num_parts - 1)];
        NZ left_nz;
        const int ys = fr.ys, uvs = fr.uvs;
        uint8_t* yrow = fr.Y0 + mb_y * 16 * ys;
        uint8_t* urow = fr.U0 + mb_y * 8 * uvs;
        uint8_t* vrow = fr.V0 + mb_y * 8 * uvs;
        for (int j = 0; j < 16; ++j) yrow[j * ys - 1] = 129;
        for (int j = 0; j < 8; ++j) urow[j * uvs - 1] = vrow[j * uvs - 1] = 129;
        if (mb_y > 0) yrow[-ys - 1] = urow[-uvs - 1] = vrow[-uvs - 1] = 129;
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MBInfo& mb = row[mb_x];
            int skip = mb.skip;
            if (!skip) {
                skip = parse_residuals(tb, bands, quant[mb.segment], mb, top_nz[mb_x], left_nz);
            } else {
                left_nz.nz = top_nz[mb_x].nz = 0;
                if (!mb.is_i4x4) left_nz.nz_dc = top_nz[mb_x].nz_dc = 0;
                mb.non_zero_y = mb.non_zero_uv = 0;
                std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
            }
            if (filter_type > 0) {
                FInfo f = fstr[mb.segment][mb.is_i4x4];
                f.inner |= !skip;
                finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
            }
            uint8_t* yd = yrow + mb_x * 16;
            uint8_t* ud = urow + mb_x * 8;
            uint8_t* vd = vrow + mb_x * 8;
            if (mb.is_i4x4) {
                // the 4 pixels above-right of the macroblock, and of its
                // right column's lower sub-blocks (libwebp repeats them)
                uint8_t tr[4];
                if (mb_y == 0) {
                    std::memset(tr, 127, 4);
                } else if (mb_x == mb_w - 1) {
                    std::memset(tr, yd[-ys + 15], 4);
                } else {
                    std::memcpy(tr, yd - ys + 16, 4);
                }
                for (int k = 0; k < 16; ++k) {
                    const int bx = k & 3, by = k >> 2;
                    uint8_t* dst = yd + by * 4 * ys + bx * 4;
                    const uint8_t* ar = bx == 3 ? tr : dst - ys + 4;
                    pred4(dst, ys, mb.imodes[k], ar);
                    transform(mb.coeffs + k * 16, dst, ys);
                }
            } else {
                pred_block(yd, ys, 16, mb.imodes[0], mb_y > 0, mb_x > 0);
                for (int k = 0; k < 16; ++k)
                    transform(mb.coeffs + k * 16, yd + (k >> 2) * 4 * ys + (k & 3) * 4, ys);
            }
            pred_block(ud, uvs, 8, mb.uvmode, mb_y > 0, mb_x > 0);
            pred_block(vd, uvs, 8, mb.uvmode, mb_y > 0, mb_x > 0);
            for (int k = 0; k < 4; ++k) {
                transform(mb.coeffs + 256 + k * 16, ud + (k >> 1) * 4 * uvs + (k & 1) * 4, uvs);
                transform(mb.coeffs + 320 + k * 16, vd + (k >> 1) * 4 * uvs + (k & 1) * 4, uvs);
            }
        }
    }
    for (const BoolDecoder& p : parts)
        if (p.overrun()) fail("VP8 token partition ends early");
    if (filter_type > 0)  // over the whole frame, in macroblock order, as libwebp's delayed rows do
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x)
                filter_mb(fr, mb_x, mb_y, finfo[static_cast<size_t>(mb_y) * mb_w + mb_x], filter_type);
    // libwebp's EmitFancyRGB over the whole picture
    auto yr = [&](int y) { return fr.Y0 + static_cast<int64_t>(y) * fr.ys; };
    auto ur = [&](int y) { return fr.U0 + static_cast<int64_t>(y) * fr.uvs; };
    auto vr = [&](int y) { return fr.V0 + static_cast<int64_t>(y) * fr.uvs; };
    auto out = [&](int y) { return rgb + static_cast<int64_t>(y) * width * 3; };
    upsample_line_pair(yr(0), nullptr, ur(0), vr(0), ur(0), vr(0), out(0), nullptr, width);
    int y = 0;
    for (; y + 2 < height; y += 2)
        upsample_line_pair(yr(y + 1), yr(y + 2), ur(y / 2), vr(y / 2), ur(y / 2 + 1), vr(y / 2 + 1), out(y + 1),
                           out(y + 2), width);
    if (!(height & 1))
        upsample_line_pair(yr(height - 1), nullptr, ur(y / 2), vr(y / 2), ur(y / 2), vr(y / 2), out(height - 1),
                           nullptr, width);
}

}  // namespace

// VP8 key frame (the chunk's payload) -> RGB (height, width, 3).  Returns 0,
// or 1 with a message in `err`.
extern "C" int rick_webp_vp8(const uint8_t* data, int64_t n, int width, int height, uint8_t* rgb, char* err,
                             int errlen) {
    try {
        decode_vp8(data, n, width, height, rgb);
        return 0;
    } catch (const Error& e) {
        std::snprintf(err, errlen, "%s", e.what);
        return 1;
    } catch (const std::bad_alloc&) {
        std::snprintf(err, errlen, "out of memory");
        return 1;
    }
}
