// zlib inflate (RFC 1950 around RFC 1951) on the host: stored, fixed-Huffman
// and dynamic-Huffman blocks, the zlib header and the Adler-32 trailer
// checked.  What it accepts it decodes to the bytes of zlib's `inflate`
// (Python's `zlib.decompress`), which is deterministic; what zlib refuses it
// refuses, with zlib's words: a bad header, an over-subscribed or incomplete
// code (an incomplete literal/length or distance code is allowed only as a
// single code of one bit, as zlib allows it), a missing end-of-block code, a
// distance past the start of the output, a stored block whose lengths
// disagree, a truncated stream, a bad Adler-32.  Bytes after the trailer are
// ignored, as `zlib.decompress` ignores them.
//
// Header only; the batch decoder (`rickdata.cpp`) includes it.  No library is
// needed.

#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace rick {

// A growing output buffer: the whole output stays addressable, so a
// back-reference needs no separate window.
struct InflateOut {
    uint8_t* data = nullptr;
    size_t size = 0, cap = 0;
    ~InflateOut() { std::free(data); }
    bool reserve(size_t n) {
        if (n <= cap) return true;
        size_t c = cap ? cap : 4096;
        while (c < n) c *= 2;
        auto* p = static_cast<uint8_t*>(std::realloc(data, c));
        if (p == nullptr) return false;
        data = p;
        cap = c;
        return true;
    }
};

// LSB-first bits of the input.  Past the end it supplies zero bytes but
// counts them: consuming one means the stream was truncated.
struct InflateBits {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int nbits = 0;
    int over = 0;  // the top `over` bits of `buf` lie past the end of the input

    void refill() {
        static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "the 8-byte refill reads a little-endian word");
        if (end - p >= 8) {  // 8 bytes at once; bits above `nbits` are the next bytes, so OR-ing them again is exact
            uint64_t v;
            std::memcpy(&v, p, 8);
            buf |= v << nbits;
            p += (63 - nbits) >> 3;
            nbits |= 56;
            return;
        }
        while (nbits <= 56) {
            uint64_t byte = 0;
            if (p < end) {
                byte = *p++;
            } else {
                over += 8;
            }
            buf |= byte << nbits;
            nbits += 8;
        }
    }
    uint32_t peek(int n) {  // n <= 32
        if (nbits < n) refill();
        return static_cast<uint32_t>(buf & ((uint64_t(1) << n) - 1));
    }
    void drop(int n) {
        buf >>= n;
        nbits -= n;
    }
    uint32_t get(int n) {
        if (n == 0) return 0;
        const uint32_t v = peek(n);
        drop(n);
        return v;
    }
    bool overrun() const { return nbits < over; }
};

// A canonical Huffman code (RFC 1951 3.2.2) from code lengths: codes of up to
// kFastBits bits decode by one table lookup, longer ones by a canonical walk.
struct InflateHuffman {
    static constexpr int kFastBits = 10;
    uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0 where the code is longer or absent
    uint16_t count[16];             // codes of each length
    uint16_t symbol[288];           // the symbols in code order
    int max_len = 0;

    // 0, or zlib's reason.  `single_ok`: an incomplete code of one 1-bit
    // code is accepted (literal/length and distance codes, as zlib does).
    const char* build(const uint8_t* lengths, int n, bool single_ok) {
        std::memset(count, 0, sizeof(count));
        std::memset(fast, 0, sizeof(fast));
        for (int s = 0; s < n; ++s) ++count[lengths[s]];
        count[0] = 0;
        max_len = 0;
        for (int l = 15; l >= 1; --l) {
            if (count[l]) {
                max_len = l;
                break;
            }
        }
        if (max_len == 0) return nullptr;  // no codes at all: decoding any symbol fails
        int left = 1;
        for (int l = 1; l <= 15; ++l) {
            left = (left << 1) - count[l];
            if (left < 0) return "over-subscribed";
        }
        if (left > 0 && (!single_ok || max_len != 1)) return "incomplete";
        uint16_t offs[16];
        offs[1] = 0;
        for (int l = 1; l < 15; ++l) offs[l + 1] = static_cast<uint16_t>(offs[l] + count[l]);
        for (int s = 0; s < n; ++s)
            if (lengths[s]) symbol[offs[lengths[s]]++] = static_cast<uint16_t>(s);
        // the fast table: each code reversed (the stream sends a code's bits
        // from its most significant), repeated over the bits after it
        int code = 0, index = 0;
        for (int l = 1; l <= kFastBits; ++l) {
            for (int i = 0; i < count[l]; ++i, ++code, ++index) {
                int rev = 0;
                for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
                for (int j = rev; j < (1 << kFastBits); j += 1 << l)
                    fast[j] = static_cast<uint16_t>((l << 9) | symbol[index]);
            }
            code <<= 1;
        }
        return nullptr;
    }

    // the next symbol, or -1 for bits that no code matches
    int decode(InflateBits& b) const {
        const uint32_t bits = b.peek(15);
        const uint16_t e = fast[bits & ((1u << kFastBits) - 1)];
        if (e) {
            b.drop(e >> 9);
            return e & 511;
        }
        int code = 0, first = 0, index = 0;
        for (int l = 1; l <= max_len; ++l) {
            code |= (bits >> (l - 1)) & 1;
            const int c = count[l];
            if (code - c < first) {
                b.drop(l);
                return symbol[index + (code - first)];
            }
            index += c;
            first = (first + c) << 1;
            code <<= 1;
        }
        return -1;
    }
};

inline uint32_t adler32(const uint8_t* p, size_t n) {
    uint32_t a = 1, b = 0;
    while (n > 0) {
        const size_t k = n < 5552 ? n : 5552;  // the most bytes before b can overflow
        for (size_t i = 0; i < k; ++i) {
            a += p[i];
            b += a;
        }
        a %= 65521;
        b %= 65521;
        p += k;
        n -= k;
    }
    return (b << 16) | a;
}

// Inflate the zlib stream src[0:n] into `out`, refusing to write more than
// `max_out` bytes.  Returns 0, or zlib's reason (a static string).
inline const char* zlib_inflate(const uint8_t* src, size_t n, InflateOut& out, size_t max_out) {
    static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                          31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                          2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t kDistBase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
                                           193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                           6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

    if (n < 2) return "incomplete or truncated stream";
    if ((src[0] * 256u + src[1]) % 31) return "incorrect header check";
    if ((src[0] & 15) != 8) return "unknown compression method";
    if ((src[0] >> 4) + 8 > 15) return "invalid window size";
    if (src[1] & 0x20) return "need dictionary";
    InflateBits b{src + 2, src + n};
    InflateHuffman lit, dist;
    uint8_t lengths[320];
    bool last = false;
    while (!last) {
        last = b.get(1) != 0;
        const uint32_t type = b.get(2);
        if (b.overrun()) return "incomplete or truncated stream";
        if (type == 0) {  // stored: to a byte boundary, LEN, NLEN, the bytes
            b.drop(b.nbits & 7);
            const uint32_t len = b.get(16), nlen = b.get(16);
            if (b.overrun()) return "incomplete or truncated stream";
            if (len != (~nlen & 0xFFFF)) return "invalid stored block lengths";
            if (out.size + len > max_out) return "more output than expected";
            if (!out.reserve(out.size + len)) return "out of memory";
            uint32_t k = 0;
            for (; k < len && b.nbits >= 8 && b.nbits - 8 >= b.over; ++k) out.data[out.size++] = static_cast<uint8_t>(b.get(8));
            if (k < len) {  // the bit buffer holds no more real bytes: the rest comes from the input itself
                if (b.over) return "incomplete or truncated stream";
                const uint8_t* from = b.p - b.nbits / 8;
                if (static_cast<size_t>(b.end - from) < len - k) return "incomplete or truncated stream";
                std::memcpy(out.data + out.size, from, len - k);
                out.size += len - k;
                b.p = from + (len - k);
                b.buf = 0;
                b.nbits = 0;
            }
            continue;
        }
        if (type == 3) return "invalid block type";
        if (type == 1) {  // fixed codes (RFC 1951 3.2.6)
            int s = 0;
            for (; s < 144; ++s) lengths[s] = 8;
            for (; s < 256; ++s) lengths[s] = 9;
            for (; s < 280; ++s) lengths[s] = 7;
            for (; s < 288; ++s) lengths[s] = 8;
            lit.build(lengths, 288, true);
            for (s = 0; s < 32; ++s) lengths[s] = 5;  // 30 and 31 are codes that no distance has
            dist.build(lengths, 32, true);
        } else {  // dynamic codes (RFC 1951 3.2.7)
            const int nlen = static_cast<int>(b.get(5)) + 257, ndist = static_cast<int>(b.get(5)) + 1;
            const int ncode = static_cast<int>(b.get(4)) + 4;
            if (nlen > 286 || ndist > 30) return "too many length or distance symbols";
            uint8_t cl[19] = {0};
            for (int i = 0; i < ncode; ++i) cl[kOrder[i]] = static_cast<uint8_t>(b.get(3));
            if (b.overrun()) return "incomplete or truncated stream";
            InflateHuffman codes;
            if (codes.build(cl, 19, false)) return "invalid code lengths set";
            int i = 0;
            while (i < nlen + ndist) {
                const int sym = codes.decode(b);
                if (b.overrun()) return "incomplete or truncated stream";
                if (sym < 0) return "invalid code lengths set";
                if (sym < 16) {
                    lengths[i++] = static_cast<uint8_t>(sym);
                    continue;
                }
                int rep, val = 0;
                if (sym == 16) {
                    if (i == 0) return "invalid bit length repeat";
                    val = lengths[i - 1];
                    rep = 3 + static_cast<int>(b.get(2));
                } else if (sym == 17) {
                    rep = 3 + static_cast<int>(b.get(3));
                } else {
                    rep = 11 + static_cast<int>(b.get(7));
                }
                if (i + rep > nlen + ndist) return "invalid bit length repeat";
                while (rep--) lengths[i++] = static_cast<uint8_t>(val);
            }
            if (b.overrun()) return "incomplete or truncated stream";
            if (lengths[256] == 0) return "invalid code -- missing end-of-block";
            if (lit.build(lengths, nlen, true)) return "invalid literal/lengths set";
            if (dist.build(lengths + nlen, ndist, true)) return "invalid distances set";
        }
        for (;;) {
            const int sym = lit.decode(b);
            if (b.overrun()) return "incomplete or truncated stream";
            if (sym < 0) return "invalid literal/length code";
            if (sym < 256) {
                if (out.size + 1 > max_out) return "more output than expected";
                if (out.size == out.cap && !out.reserve(out.size + 1)) return "out of memory";
                out.data[out.size++] = static_cast<uint8_t>(sym);
                continue;
            }
            if (sym == 256) break;
            if (sym > 285) return "invalid literal/length code";
            const size_t len = kLenBase[sym - 257] + b.get(kLenExtra[sym - 257]);
            const int dsym = dist.decode(b);
            if (b.overrun()) return "incomplete or truncated stream";
            if (dsym < 0 || dsym > 29) return "invalid distance code";
            const size_t d = kDistBase[dsym] + b.get(kDistExtra[dsym]);
            if (b.overrun()) return "incomplete or truncated stream";
            if (d > out.size) return "invalid distance too far back";
            if (out.size + len > max_out) return "more output than expected";
            if (!out.reserve(out.size + len)) return "out of memory";
            uint8_t* to = out.data + out.size;
            const uint8_t* from = to - d;
            for (size_t k = 0; k < len; ++k) to[k] = from[k];  // may overlap: byte by byte
            out.size += len;
        }
    }
    b.drop(b.nbits & 7);
    uint32_t want = 0;
    for (int k = 0; k < 4; ++k) want = (want << 8) | b.get(8);
    if (b.overrun()) return "incomplete or truncated stream";
    if (want != adler32(out.data, out.size)) return "incorrect data check";
    return nullptr;
}

}  // namespace rick
