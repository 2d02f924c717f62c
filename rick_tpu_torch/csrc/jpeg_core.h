// JPEG entropy decoding, dequantization, IDCT, upsampling and color
// conversion on the host: the core that `jpeg_decode.cpp` (the entry point
// of `data/jpeg.py`) and the batch decoder (`rickdata.cpp`) share, both
// after the marker parse of `jpeg_parse.h`.
//
// It receives the frame, the latched quantization tables, the Huffman
// tables and one record per scan (which components, which tables, the
// spectral band and the successive approximation bits, the restart interval
// and the byte range of the scan's entropy-coded data), and decodes the
// whole image in one call.
//
// The pixels are those of libjpeg-turbo as PIL and OpenCV call it, bit for
// bit: the slow integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) with
// the 16-bit arithmetic of its x86 SIMD versions (the dequantized
// coefficients, in0 +- in4 and the odd part's two sums wrap at 16 bits, each
// pass saturates to 16 bits, the output to [-128, 127] before the +128 level
// shift; inside those ranges this is jidctint.c exactly), the "fancy"
// triangle-filter upsampling of jdsample.c where the downsampled width
// exceeds 2 (box replication otherwise), and the fixed-point YCbCr->RGB of
// jdcolor.c.  A coefficient is a 16-bit JCOEF, as in libjpeg.
//
// No library is needed.

#pragma once

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace rick {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the fields of one scan record (int32 each), as jpeg_parse.h packs them
enum ScanField {
    kNcomp = 0,      // components in the scan, 1..4
    kComp = 1,       // 4 frame component indices
    kDcTable = 5,    // 4 DC table indices into the table array, -1 where none is read
    kAcTable = 9,    // 4 AC table indices, -1 where none is read
    kSs = 13,
    kSe = 14,
    kAh = 15,
    kAl = 16,
    kRestart = 17,   // restart interval in MCUs, 0 for none
    kOffset = 18,    // first byte of the entropy-coded data in the file
    kLength = 19,    // its length up to the marker that ends the scan
    kScanFields = 20,
};

// the frame record: width, height, component count, progressive,
// color (0 gray, 1 YCbCr, 2 RGB), then h, v of each component
enum FrameField { kWidth = 0, kHeight = 1, kComps = 2, kProgressive = 3, kColor = 4, kSampling = 5 };

struct Error {
    char* buf;
    int len;
    bool set = false;
    void operator()(const char* fmt, ...) {
        if (set) return;
        set = true;
        va_list ap;
        va_start(ap, fmt);
        vsnprintf(buf, len, fmt, ap);
        va_end(ap);
    }
};

// A Huffman table in canonical form (ITU T.81 annex C and F.2.2.3), with a
// 9-bit lookahead table for the common short codes.
struct Huffman {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t look[512];  // (length << 8) | symbol, or 0 where the code is longer than 9 bits

    void build(const uint8_t* counts, const uint8_t* symbols) {
        int p = 0, code = 0;
        std::memset(look, 0, sizeof(look));
        for (int l = 1; l <= 16; ++l) {
            const int n = counts[l - 1];
            valoffset[l] = p - code;
            for (int i = 0; i < n; ++i, ++p, ++code) {
                if (l <= 9) {
                    const int shift = 9 - l;
                    for (int j = 0; j < (1 << shift); ++j) look[(code << shift) | j] = (uint16_t)((l << 8) | symbols[p]);
                }
            }
            maxcode[l] = n ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        std::memcpy(vals, symbols, 256);
    }
};

// The bits of one scan's entropy-coded segment: stuffed 0xFF00 bytes read as
// 0xFF, fill bytes before a marker skipped.  At a marker (an RSTn, or the
// segment's end) the reader supplies zero bits, as libjpeg does, but counts
// them: consuming one is an error (the data ran out).
struct Bits {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int nbits = 0;
    int fake = 0;                       // the low `fake` bits of `buf` are zeros past a marker
    const uint8_t* marker = nullptr;    // the byte after the 0xFF of the marker reached, or null
    bool overrun = false;

    void fill() {
        while (nbits <= 56) {
            int byte = 0;
            if (marker == nullptr && p < end) {
                byte = *p++;
                if (byte == 0xFF) {
                    while (p < end && *p == 0xFF) ++p;
                    if (p < end && *p == 0x00) {
                        ++p;
                    } else {
                        marker = p;  // p == end: the marker that ends the segment
                        byte = 0;
                        fake += 8;
                    }
                }
            } else {
                if (marker == nullptr) marker = end;
                fake += 8;
            }
            buf = (buf << 8) | (uint64_t)byte;
            nbits += 8;
        }
    }
    void consume(int n) {
        nbits -= n;
        if (nbits < fake) overrun = true;
    }
    int get(int n) {  // n <= 16
        if (n == 0) return 0;
        if (nbits < n) fill();
        const int v = (int)((buf >> (nbits - n)) & ((1u << n) - 1));
        consume(n);
        return v;
    }
    int decode(const Huffman& h) {  // -1 for a code no table entry matches
        if (nbits < 16) fill();
        const int peek = (int)((buf >> (nbits - 9)) & 511);
        const int e = h.look[peek];
        if (e) {
            consume(e >> 8);
            return e & 255;
        }
        int code = peek, l = 9;
        while (l < 16 && code > h.maxcode[l]) {
            code = (code << 1) | (int)((buf >> (nbits - l - 1)) & 1);
            ++l;
        }
        if (code > h.maxcode[l]) return -1;
        consume(l);
        return h.vals[(code + h.valoffset[l]) & 255];
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
    int h, v;
    int ds_w, ds_h;       // downsampled width and height (libjpeg's downsampled_width/height)
    int bw, bh;           // the component's own block grid, ceil(ds / 8)
    int aw, ah;           // the allocated block grid: whole MCUs of the interleaved layout
    std::vector<int16_t> coef;  // aw * ah blocks of 64, natural order
    int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * aw + bx) * 64; }
};

struct Decoder {
    const uint8_t* file;
    int64_t file_len;
    int width, height, ncomp, max_h, max_v;
    bool progressive;
    std::vector<Component> comps;
    std::vector<Huffman> tables;
    Error& err;

    explicit Decoder(Error& e) : err(e) {}

    // one block of a sequential scan: DC difference and the AC run/size codes
    bool block_sequential(Bits& b, int16_t* blk, const Huffman& dc, const Huffman& ac, int& pred, int scan) {
        int s = b.decode(dc);
        if (s < 0 || s > 11) return bad_code(scan, "DC", s);
        int diff = s ? extend(b.get(s), s) : 0;
        pred += diff;
        blk[0] = (int16_t)pred;
        for (int k = 1; k < 64; ++k) {
            const int rs = b.decode(ac);
            if (rs < 0) return bad_code(scan, "AC", rs);
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                if (k > 63 || s > 10) return bad_code(scan, "AC", rs);
                blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        return true;
    }

    bool bad_code(int scan, const char* what, int sym) {
        if (sym < 0)
            err("corrupt entropy data in scan %d: a bit pattern that no %s Huffman code matches", scan, what);
        else
            err("corrupt entropy data in scan %d: %s symbol 0x%02x is out of range for 8-bit samples or runs past "
                "the band", scan, what, sym);
        return false;
    }

    bool scan(const int32_t* rec, int index) {
        const int n = rec[kNcomp];
        const int ss = rec[kSs], se = rec[kSe], ah = rec[kAh], al = rec[kAl];
        const int restart = rec[kRestart];
        if (rec[kOffset] < 0 || rec[kLength] < 0 || (int64_t)rec[kOffset] + rec[kLength] > file_len) {
            err("scan %d: its entropy-coded data lies outside the file", index);
            return false;
        }
        Bits b;
        b.p = file + rec[kOffset];
        b.end = b.p + rec[kLength];
        int mcus_x, mcus_y;
        if (n == 1) {
            const Component& c = comps[rec[kComp]];
            mcus_x = c.bw;
            mcus_y = c.bh;
        } else {
            mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
            mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
        }
        int pred[4] = {0, 0, 0, 0};
        int eobrun = 0;
        int next_rst = 0;
        const int64_t total = (int64_t)mcus_x * mcus_y;
        for (int64_t m = 0; m < total; ++m) {
            if (restart && m > 0 && m % restart == 0) {
                // the bits left over are padding; skip to the marker (libjpeg
                // discards stray bytes before it too) and check that it is the
                // RSTn due next
                b.buf = 0;
                b.nbits = b.fake = 0;
                if (b.marker == nullptr) {
                    while (b.p < b.end) {
                        if (*b.p++ != 0xFF) continue;
                        while (b.p < b.end && *b.p == 0xFF) ++b.p;
                        if (b.p < b.end && *b.p == 0x00) {
                            ++b.p;
                            continue;
                        }
                        break;
                    }
                    b.marker = b.p;
                }
                if (b.marker >= b.end || *b.marker != 0xD0 + next_rst) {
                    err("scan %d: expected restart marker RST%d after MCU %lld of %lld, found %s", index, next_rst,
                        (long long)m, (long long)total, b.marker >= b.end ? "the end of the scan" : "another marker");
                    return false;
                }
                b.p = b.marker + 1;
                b.marker = nullptr;
                next_rst = (next_rst + 1) & 7;
                pred[0] = pred[1] = pred[2] = pred[3] = 0;
                eobrun = 0;
            }
            const int my = (int)(m / mcus_x), mx = (int)(m % mcus_x);
            for (int ci = 0; ci < n; ++ci) {
                Component& c = comps[rec[kComp + ci]];
                const int bh = n == 1 ? 1 : c.v, bw = n == 1 ? 1 : c.h;
                for (int yy = 0; yy < bh; ++yy) {
                    for (int xx = 0; xx < bw; ++xx) {
                        int16_t* blk = c.block(my * bh + yy, mx * bw + xx);
                        bool ok;
                        if (!progressive) {
                            ok = block_sequential(b, blk, tables[rec[kDcTable + ci]], tables[rec[kAcTable + ci]],
                                                  pred[ci], index);
                        } else if (ss == 0) {
                            ok = ah == 0 ? dc_first(b, blk, tables[rec[kDcTable + ci]], pred[ci], al, index)
                                         : dc_refine(b, blk, al);
                        } else {
                            ok = ah == 0 ? ac_first(b, blk, tables[rec[kAcTable + ci]], ss, se, al, eobrun, index)
                                         : ac_refine(b, blk, tables[rec[kAcTable + ci]], ss, se, al, eobrun, index);
                        }
                        if (!ok) return false;
                        if (b.overrun) {
                            err("scan %d: the entropy-coded data ends inside MCU %lld of %lld (truncated or corrupt)",
                                index, (long long)m, (long long)total);
                            return false;
                        }
                    }
                }
            }
        }
        return true;
    }

    // jdphuff.c's four progressive decoders (decode_mcu_DC_first, ...)
    bool dc_first(Bits& b, int16_t* blk, const Huffman& dc, int& pred, int al, int scan) {
        const int s = b.decode(dc);
        if (s < 0 || s > 11) return bad_code(scan, "DC", s);
        pred += s ? extend(b.get(s), s) : 0;
        blk[0] = (int16_t)(uint32_t)((uint32_t)pred << al);
        return true;
    }

    bool dc_refine(Bits& b, int16_t* blk, int al) {
        if (b.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
        return true;
    }

    bool ac_first(Bits& b, int16_t* blk, const Huffman& ac, int ss, int se, int al, int& eobrun, int scan) {
        if (eobrun > 0) {
            --eobrun;
            return true;
        }
        for (int k = ss; k <= se; ++k) {
            const int rs = b.decode(ac);
            if (rs < 0) return bad_code(scan, "AC", rs);
            const int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                if (k > se || s > 10) return bad_code(scan, "AC", rs);
                blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)extend(b.get(s), s) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += b.get(r);
                --eobrun;
                break;
            }
        }
        return true;
    }

    bool ac_refine(Bits& b, int16_t* blk, const Huffman& ac, int ss, int se, int al, int& eobrun, int scan) {
        const int p1 = 1 << al, m1 = -(1 << al);
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                const int rs = b.decode(ac);
                if (rs < 0) return bad_code(scan, "AC", rs);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) return bad_code(scan, "AC refinement", rs);
                    s = b.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += b.get(r);
                    break;
                }
                do {
                    int16_t* c = blk + kNatural[k];
                    if (*c != 0) {
                        if (b.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) {
                    if (k > se) return bad_code(scan, "AC refinement", rs);
                    blk[kNatural[k]] = (int16_t)s;
                }
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t* c = blk + kNatural[k];
                if (*c != 0 && b.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
            }
            --eobrun;
        }
        return true;
    }
};

// ---- the IDCT: jidctint.c's algorithm with the arithmetic of libjpeg-turbo's
// jidctint-sse2/avx2 (see the top of the file)

constexpr int32_t F029 = 2446, F039 = 3196, F054 = 4433, F076 = 6270, F089 = 7373, F117 = 9633, F150 = 12299,
                  F184 = 15137, F196 = 16069, F205 = 16819, F256 = 20995, F307 = 25172;

inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) { return (int16_t)std::min(32767, std::max(-32768, x)); }
inline int32_t add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }

// one 1-D pass over 8 16-bit inputs: the 8 sums before the descale
inline void idct_1d(const int16_t* in, int32_t* out) {
    const int32_t z2 = in[2], z3 = in[6];
    const int32_t tmp3 = z2 * (F054 + F076) + z3 * F054;
    const int32_t tmp2 = z2 * F054 + z3 * (F054 - F184);
    const int32_t tmp0 = (int32_t)wrap16(in[0] + in[4]) * 8192;
    const int32_t tmp1 = (int32_t)wrap16(in[0] - in[4]) * 8192;
    const int32_t tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
    const int32_t tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);

    const int32_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
    const int32_t s3 = wrap16(i7 + i3), s4 = wrap16(i5 + i1);
    const int32_t zz3 = s3 * (F117 - F196) + s4 * F117;
    const int32_t zz4 = s3 * F117 + s4 * (F117 - F039);
    const int32_t o0 = add(i7 * (F029 - F089) + i1 * -F089, zz3);
    const int32_t o3 = add(i7 * -F089 + i1 * (F150 - F089), zz4);
    const int32_t o1 = add(i5 * (F205 - F256) + i3 * -F256, zz4);
    const int32_t o2 = add(i5 * -F256 + i3 * (F307 - F256), zz3);
    out[0] = add(tmp10, o3);
    out[7] = sub(tmp10, o3);
    out[1] = add(tmp11, o2);
    out[6] = sub(tmp11, o2);
    out[2] = add(tmp12, o1);
    out[5] = sub(tmp12, o1);
    out[3] = add(tmp13, o0);
    out[4] = sub(tmp13, o0);
}

// coef: 64 coefficients, natural order; quant: 64 multipliers (16-bit);
// writes 8 rows of 8 samples at out with stride `stride`
inline void idct_block(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride) {
    int16_t ws[64];  // ws[row * 8 + col]
    bool ac_zero = true;
    for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = coef[i] == 0;
    if (ac_zero) {
        for (int c = 0; c < 8; ++c) {
            const int16_t dc = wrap16((int32_t)wrap16(coef[c] * quant[c]) * 4);
            for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        }
    } else {
        for (int c = 0; c < 8; ++c) {
            int16_t col[8];
            int32_t sums[8];
            for (int r = 0; r < 8; ++r) col[r] = wrap16(coef[r * 8 + c] * quant[r * 8 + c]);
            idct_1d(col, sums);
            for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(add(sums[r], 1 << 10) >> 11);
        }
    }
    for (int r = 0; r < 8; ++r) {
        int32_t sums[8];
        idct_1d(ws + r * 8, sums);
        for (int c = 0; c < 8; ++c) {
            const int32_t v = add(sums[c], 1 << 17) >> 18;
            out[r * stride + c] = (uint8_t)(std::min(127, std::max(-128, v)) + 128);
        }
    }
}

// ---- upsampling (jdsample.c) of one component plane to the full size

// h2v1_fancy_upsample for one row of `n` samples (n > 2) into 2n
inline void h2v1_row(const uint8_t* in, int n, uint8_t* out) {
    int v = in[0];
    out[0] = (uint8_t)v;
    out[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < n - 1; ++i) {
        v = in[i] * 3;
        out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
    }
    v = in[n - 1];
    out[2 * n - 2] = (uint8_t)((v * 3 + in[n - 2] + 1) >> 2);
    out[2 * n - 1] = (uint8_t)v;
}

// h2v2_fancy_upsample for one output row: `near` the nearer input row,
// `far` the other (the row above for the upper output row, below for the
// lower); n > 2 samples into 2n
inline void h2v2_row(const uint8_t* near, const uint8_t* far, int n, uint8_t* out) {
    int last = 0, cur = near[0] * 3 + far[0], next = near[1] * 3 + far[1];
    out[0] = (uint8_t)((cur * 4 + 8) >> 4);
    out[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int i = 1; i < n - 1; ++i) {
        next = near[i + 1] * 3 + far[i + 1];
        out[2 * i] = (uint8_t)((cur * 3 + last + 8) >> 4);
        out[2 * i + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
    }
    out[2 * n - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
    out[2 * n - 1] = (uint8_t)((cur * 4 + 7) >> 4);
}

// plane: the IDCT output, `pitch` samples per row; fills full (height x
// width) at the frame's size.  rx, ry: the upsampling ratios (1 or 2).
inline void upsample(const uint8_t* plane, int pitch, const Component& c, int rx, int ry, int width, int height,
              uint8_t* full) {
    std::vector<uint8_t> row(2 * (size_t)pitch + 2);
    const bool fancy = c.ds_w > 2;
    for (int y = 0; y < height; ++y) {
        const uint8_t* src;
        if (rx == 1 && ry == 1) {
            src = plane + (size_t)y * pitch;
        } else if (ry == 1) {  // h2v1
            const uint8_t* in = plane + (size_t)y * pitch;
            if (fancy) {
                h2v1_row(in, c.ds_w, row.data());
            } else {
                for (int i = 0; i < c.ds_w; ++i) row[2 * i] = row[2 * i + 1] = in[i];
            }
            src = row.data();
        } else {  // h2v2
            const int j = y >> 1;
            const uint8_t* in = plane + (size_t)j * pitch;
            if (fancy) {
                const int k = (y & 1) ? std::min(j + 1, c.ds_h - 1) : std::max(j - 1, 0);
                h2v2_row(in, plane + (size_t)k * pitch, c.ds_w, row.data());
            } else {
                for (int i = 0; i < c.ds_w; ++i) row[2 * i] = row[2 * i + 1] = in[i];
            }
            src = row.data();
        }
        std::memcpy(full + (size_t)y * width, src, width);
    }
}

// jdcolor.c's ycc_rgb_convert tables
struct YccTables {
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    YccTables() {
        const int scalebits = 16;
        const int32_t one_half = 1 << (scalebits - 1);
        auto fix = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + one_half) >> scalebits);
            cb_b[i] = (int)((fix(1.77200) * x + one_half) >> scalebits);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + one_half;
        }
    }
};

inline uint8_t clamp255(int v) { return (uint8_t)std::min(255, std::max(0, v)); }

// Decode the whole image from the parsed markers.  frame: FrameField
// record; quant: ncomp x 64 multipliers, natural order; huff: ntables x (16
// counts + 256 symbols); scans: nscans x kScanFields; out: height x width x
// 3.  Returns false with a message in err.
inline bool jpeg_decode_tables(const uint8_t* file, int64_t file_len, const int32_t* frame, const uint16_t* quant,
                               const uint8_t* huff, int32_t ntables, const int32_t* scans, int32_t nscans,
                               uint8_t* out, Error& err) {
    Decoder d(err);
    d.file = file;
    d.file_len = file_len;
    d.width = frame[kWidth];
    d.height = frame[kHeight];
    d.ncomp = frame[kComps];
    d.progressive = frame[kProgressive] != 0;
    d.max_h = d.max_v = 1;
    for (int i = 0; i < d.ncomp; ++i) {
        d.max_h = std::max(d.max_h, (int)frame[kSampling + 2 * i]);
        d.max_v = std::max(d.max_v, (int)frame[kSampling + 2 * i + 1]);
    }
    const int mcus_x = (d.width + 8 * d.max_h - 1) / (8 * d.max_h);
    const int mcus_y = (d.height + 8 * d.max_v - 1) / (8 * d.max_v);
    d.comps.resize(d.ncomp);
    for (int i = 0; i < d.ncomp; ++i) {
        Component& c = d.comps[i];
        c.h = frame[kSampling + 2 * i];
        c.v = frame[kSampling + 2 * i + 1];
        c.ds_w = (int)(((int64_t)d.width * c.h + d.max_h - 1) / d.max_h);
        c.ds_h = (int)(((int64_t)d.height * c.v + d.max_v - 1) / d.max_v);
        c.bw = (c.ds_w + 7) / 8;
        c.bh = (c.ds_h + 7) / 8;
        c.aw = std::max(mcus_x * c.h, c.bw);
        c.ah = std::max(mcus_y * c.v, c.bh);
        c.coef.assign((size_t)c.aw * c.ah * 64, 0);
    }
    d.tables.resize(ntables);
    for (int t = 0; t < ntables; ++t) d.tables[t].build(huff + t * 272, huff + t * 272 + 16);
    for (int s = 0; s < nscans; ++s)
        if (!d.scan(scans + (size_t)s * kScanFields, s)) return false;

    // IDCT, upsampling to full planes, color conversion
    std::vector<std::vector<uint8_t>> full(d.ncomp);
    std::vector<uint8_t> plane;
    for (int i = 0; i < d.ncomp; ++i) {
        Component& c = d.comps[i];
        const int pitch = c.bw * 8;
        plane.assign((size_t)pitch * c.bh * 8, 0);
        int16_t q[64];
        for (int k = 0; k < 64; ++k) q[k] = (int16_t)quant[i * 64 + k];
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_block(c.block(by, bx), q, plane.data() + (size_t)by * 8 * pitch + bx * 8, pitch);
        full[i].resize((size_t)d.width * d.height);
        upsample(plane.data(), pitch, c, d.max_h / c.h, d.max_v / c.v, d.width, d.height, full[i].data());
    }
    const size_t npix = (size_t)d.width * d.height;
    if (d.ncomp == 1) {
        for (size_t p = 0; p < npix; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
    } else if (frame[kColor] == 2) {
        for (size_t p = 0; p < npix; ++p)
            for (int k = 0; k < 3; ++k) out[3 * p + k] = full[k][p];
    } else {
        static const YccTables t;
        for (size_t p = 0; p < npix; ++p) {
            const int y = full[0][p], cb = full[1][p], cr = full[2][p];
            out[3 * p] = clamp255(y + t.cr_r[cr]);
            out[3 * p + 1] = clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
            out[3 * p + 2] = clamp255(y + t.cb_b[cb]);
        }
    }
    return true;
}

}  // namespace rick
