// The byte-serial decoders of the BMP and TIFF readers (`data/bmp.py`,
// `data/tiff.py`), on the host: TIFF's LZW and PackBits, and BMP's RLE8 and
// RLE4.  Each output byte depends on the codes before it, so none of them
// vectorizes in numpy, and a loop in Python costs seconds per image.
//
// Built with g++ into its own shared library and called through ctypes.
// No library is needed.

#include <cstdint>
#include <cstring>

// TIFF LZW (TIFF 6.0 section 13): MSB-first codes of 9 to 12 bits, 256
// clears the table, 257 ends the strip, and the code width grows one code
// early (at 511, 1023 and 2047 entries).  Decodes until EOI, the end of
// `src`, or `cap` bytes of `dst`.  Returns the bytes written, or -1 for a
// code that is not in the table or a strip that does not start with a clear
// (the old-style, LSB-first LZW starts otherwise).
extern "C" int64_t rick_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    static thread_local uint16_t prefix[4096];
    static thread_local uint8_t suffix[4096], first[4096];
    static thread_local uint16_t length[4096];
    if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -1;  // old-style LZW
    for (int i = 0; i < 256; ++i) {
        prefix[i] = 0xFFFF;
        suffix[i] = first[i] = static_cast<uint8_t>(i);
        length[i] = 1;
    }
    int64_t out = 0, bitpos = 0;
    const int64_t nbits = n * 8;
    int width = 9, next = 258, prev = -1;
    while (bitpos + width <= nbits) {
        int code = 0;
        for (int b = 0; b < width; ++b, ++bitpos) code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
        if (code == 257) break;
        if (code == 256) {
            width = 9;
            next = 258;
            prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code > 255) return -1;
            if (out < cap) dst[out++] = static_cast<uint8_t>(code);
            prev = code;
            continue;
        }
        int entry;
        if (code < next) {
            entry = code;
        } else if (code == next && next < 4096) {
            entry = -1;  // the KwKwK case: prev's string and its own first byte
        } else {
            return -1;
        }
        if (next < 4096) {  // a full table adds nothing until the next clear
            prefix[next] = static_cast<uint16_t>(prev);
            suffix[next] = entry < 0 ? first[prev] : first[entry];
            first[next] = first[prev];
            length[next] = static_cast<uint16_t>(length[prev] + 1);
            if (entry < 0) entry = next;
            ++next;
            if (next + 1 >= (1 << width) && width < 12) ++width;
        }
        // write the string of `entry` backwards into its place
        const int64_t end = out + length[entry];
        int c = entry;
        for (int64_t k = end - 1; k >= out; --k) {
            if (k < cap) dst[k] = suffix[c];
            c = prefix[c];
        }
        out = end < cap ? end : cap;
        prev = entry;
        if (out >= cap) break;
    }
    return out;
}

// PackBits (TIFF 6.0 section 9): a header byte n; 0..127 copies n + 1
// bytes, -127..-1 repeats the next byte 1 - n times, -128 is skipped.
// Returns the bytes written (at most `cap`).
extern "C" int64_t rick_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t i = 0, out = 0;
    while (i < n && out < cap) {
        const int h = static_cast<int8_t>(src[i++]);
        if (h >= 0) {
            for (int k = 0; k <= h && i < n && out < cap; ++k) dst[out++] = src[i++];
        } else if (h != -128) {
            if (i >= n) break;
            const uint8_t v = src[i++];
            for (int k = 0; k < 1 - h && out < cap; ++k) dst[out++] = v;
        }
    }
    return out;
}

// BMP RLE8 / RLE4, as Pillow's BmpRleDecoder reads them (the bar is its
// pixels): rows bottom-up as stored, one index byte per pixel.  `src` is the
// file from the pixel data's offset on, `offset` that offset (the word
// alignment after an absolute run is of the file position).  Runs are
// clipped to the row; an absolute run is not, and RLE4's reads count // 2
// bytes and emits two pixels per byte; a delta reads two bytes, then its
// (right, up) from the two after them, and skips right + up * width pixels.
// Stops at end of bitmap, the end of `src`, or `width * height` pixels.
// Returns the pixels written, or -1 for a delta cut short; `dst` must hold
// width * height + width + 256 bytes, the most one command can overshoot by.
extern "C" int64_t rick_bmp_rle(const uint8_t* src, int64_t n, int64_t offset, uint8_t* dst, int64_t width,
                                int64_t height, int rle4) {
    const int64_t want = width * height;
    int64_t i = 0, len = 0, x = 0;
    while (len < want) {
        if (i + 2 > n) break;
        int64_t count = src[i], byte = src[i + 1];
        i += 2;
        if (count) {
            if (x + count > width) count = width - x > 0 ? width - x : 0;
            for (int64_t k = 0; k < count; ++k) dst[len++] = rle4 ? ((k & 1) ? (byte & 15) : (byte >> 4)) : byte;
            x += count;
        } else if (byte == 0) {  // end of line
            while (len % width) dst[len++] = 0;
            x = 0;
        } else if (byte == 1) {  // end of bitmap
            break;
        } else if (byte == 2) {  // delta
            if (i + 2 > n) break;
            i += 2;
            if (i + 2 > n) return -1;  // Pillow fails to unpack a short read here
            const int64_t right = src[i], up = src[i + 1];
            i += 2;
            int64_t skip = right + up * width;
            if (skip > want - len) skip = want - len;  // the loop ends there
            std::memset(dst + len, 0, skip);
            len += skip;
            x = len % width;
        } else {  // absolute run
            const int64_t nbytes = rle4 ? byte / 2 : byte;
            const int64_t avail = n - i < nbytes ? n - i : nbytes;
            for (int64_t k = 0; k < avail; ++k) {
                if (rle4) {
                    dst[len++] = src[i + k] >> 4;
                    dst[len++] = src[i + k] & 15;
                } else {
                    dst[len++] = src[i + k];
                }
            }
            i += avail;
            if (avail < nbytes) break;
            x += byte;
            if ((offset + i) % 2) ++i;
        }
    }
    return len;
}
