// JPEG markers parsed on the host, for `data/jpeg.py::decode_jpeg` (through
// `jpeg_decode.cpp`) and the batch decoder (`rickdata.cpp`): the frame, the
// quantization tables each component latches, the Huffman tables as each
// scan reads them and one record per scan, which the decode core
// (`jpeg_core.h`) takes.
//
// Read: SOI, APPn (JFIF, and Adobe's APP14 with its transform flag; the rest
// skipped), COM, DQT, DHT, SOF0/SOF1/SOF2, DRI, SOS and EOI.  Refused:
// arithmetic coding, lossless and hierarchical modes, 12-bit samples, 4
// components (CMYK/YCCK), sampling other than 4:4:4, 4:2:2 and 4:2:0, a
// missing table, a truncated or corrupt file, and a progressive file whose
// scans leave any of a block's first 10 coefficients incomplete (libjpeg
// would smooth those blocks).

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host_image.h"
#include "jpeg_core.h"

namespace rick {

struct JpegTables {
    std::vector<int32_t> frame;   // FrameField record
    std::vector<uint16_t> quant;  // ncomp x 64, natural order
    std::vector<uint8_t> huff;    // ntables x (16 counts + 256 symbols)
    std::vector<int32_t> scans;   // nscans x kScanFields
};

inline const char* jpeg_sof_name(int marker) {
    switch (marker) {
        case 0xC3: return "lossless";
        case 0xC5: return "differential sequential (hierarchical)";
        case 0xC6: return "differential progressive (hierarchical)";
        case 0xC7: return "differential lossless (hierarchical)";
        case 0xC9: return "arithmetic-coded sequential";
        case 0xCA: return "arithmetic-coded progressive";
        case 0xCB: return "arithmetic-coded lossless";
        case 0xCD: return "arithmetic-coded differential sequential";
        case 0xCE: return "arithmetic-coded differential progressive";
        case 0xCF: return "arithmetic-coded differential lossless";
        default: return "an unknown frame type";
    }
}

inline bool jpeg_parse(const uint8_t* blob, size_t len, JpegTables* out, std::string* err) {
    constexpr int kSmoothed = 10;  // libjpeg smooths progressive blocks while one of these coefficients is incomplete
    constexpr int kMaxBlocksInMcu = 10;
    struct Table {
        bool set = false;
        uint8_t data[272] = {};  // 16 counts, then the symbols
    };
    struct Frame {
        int width = 0, height = 0, n = 0;
        int ids[4] = {}, h[4] = {}, v[4] = {}, tq[4] = {};
        bool progressive = false;
    };
    uint16_t quant[4][64] = {};
    bool quant_set[4] = {};
    Table huff[2][4];
    Frame f;
    bool have_frame = false, jfif = false;
    int adobe = -1, restart = 0;
    uint16_t latched[4][64] = {};
    bool is_latched[4] = {}, seen[4] = {};
    int coef_bits[4][64];
    std::memset(coef_bits, 0xFF, sizeof(coef_bits));  // -1: never sent
    if (len > 0x7FFFFFFF) return refuse(err, "JPEG of %zu bytes is too large to decode", len);
    out->huff.clear();
    out->scans.clear();
    int nscans = 0;
    size_t pos = 2;
    for (;;) {
        if (pos >= len) return refuse(err, "JPEG is truncated: the file ends before its EOI marker");
        if (blob[pos] != 0xFF)
            return refuse(err, "JPEG has 0x%02x at byte %zu where a marker should start (corrupt)", blob[pos], pos);
        while (pos < len && blob[pos] == 0xFF) ++pos;
        if (pos >= len) return refuse(err, "JPEG is truncated: the file ends before its EOI marker");
        const int marker = blob[pos++];
        if (marker == 0xD9) break;
        if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;  // RSTn or TEM outside a scan: skipped
        if (marker == 0xD8) return refuse(err, "JPEG has a second SOI marker at byte %zu", pos - 2);
        if (pos + 2 > len) return refuse(err, "JPEG is truncated inside marker 0x%02x at byte %zu", marker, pos - 2);
        const size_t length = (size_t(blob[pos]) << 8) | blob[pos + 1];
        if (length < 2 || pos + length > len)
            return refuse(err, "JPEG is truncated or corrupt: marker 0x%02x at byte %zu has length %zu, %zu bytes "
                               "remain", marker, pos - 2, length, len - pos);
        const uint8_t* seg = blob + pos + 2;
        const size_t n = length - 2;
        pos += length;
        if ((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE) {  // APPn, COM
            if (marker == 0xE0 && n >= 14 && std::memcmp(seg, "JFIF\0", 5) == 0) {
                jfif = true;
            } else if (marker == 0xEE && n >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
                adobe = seg[11];
            }
        } else if (marker == 0xDB) {  // DQT
            size_t p = 0;
            while (p < n) {
                const int pq = seg[p] >> 4, tq = seg[p] & 15;
                const size_t size = pq ? 128 : 64;
                if (pq > 1 || tq > 3 || p + 1 + size > n)
                    return refuse(err, "JPEG DQT at byte %zu is corrupt (precision %d, table %d)", pos - length - 2, pq,
                                  tq);
                for (int k = 0; k < 64; ++k)
                    quant[tq][kNatural[k]] = pq ? static_cast<uint16_t>((seg[p + 1 + 2 * k] << 8) | seg[p + 2 + 2 * k])
                                                : seg[p + 1 + k];
                quant_set[tq] = true;
                p += 1 + size;
            }
        } else if (marker == 0xC4) {  // DHT
            size_t p = 0;
            while (p < n) {
                if (p + 17 > n) return refuse(err, "JPEG DHT segment ends inside a table header");
                const int tc = seg[p] >> 4, th = seg[p] & 15;
                const uint8_t* counts = seg + p + 1;
                int total = 0, last = 0;
                for (int l = 0; l < 16; ++l) {
                    total += counts[l];
                    if (counts[l]) last = l + 1;
                }
                if (tc > 1 || th > 3)
                    return refuse(err, "JPEG DHT defines table class %d id %d; classes are 0-1 and ids 0-3", tc, th);
                if (total > 256 || p + 17 + total > n)
                    return refuse(err, "JPEG DHT table class %d id %d lists %d symbols, more than its segment holds",
                                  tc, th, total);
                const uint8_t* symbols = seg + p + 17;
                int code = 0;
                for (int l = 1; l <= last; ++l) {
                    code += counts[l - 1];
                    if (code >= (1 << l))
                        return refuse(err, "JPEG Huffman table class %d id %d has more codes of %d bits than fit (a "
                                           "corrupt DHT)", tc, th, l);
                    code <<= 1;
                }
                if (tc == 0)
                    for (int i = 0; i < total; ++i)
                        if (symbols[i] > 15)
                            return refuse(err, "JPEG DC Huffman table %d holds a symbol above 15 (a corrupt DHT)", th);
                Table& t = huff[tc][th];
                t.set = true;
                std::memset(t.data, 0, sizeof(t.data));
                std::memcpy(t.data, counts, 16);
                std::memcpy(t.data + 16, symbols, total);
                p += 17 + total;
            }
        } else if (marker == 0xDD) {  // DRI
            if (n != 2) return refuse(err, "JPEG DRI segment holds %zu bytes, not 2", n);
            restart = (seg[0] << 8) | seg[1];
        } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {  // SOFn
            if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2)
                return refuse(err, "JPEG is %s (SOF%d): only Huffman-coded baseline, extended sequential and "
                                   "progressive JPEG is decoded", jpeg_sof_name(marker), marker - 0xC0);
            if (have_frame) return refuse(err, "JPEG has a second SOF marker");
            if (n < 6) return refuse(err, "JPEG SOF segment is shorter than its header");
            const int precision = seg[0], nc = seg[5];
            f.height = (seg[1] << 8) | seg[2];
            f.width = (seg[3] << 8) | seg[4];
            if (precision != 8) return refuse(err, "JPEG has %d-bit samples: only 8-bit JPEG is decoded", precision);
            if (nc == 4)
                return refuse(err, "JPEG has 4 components (CMYK or YCCK): only gray and 3-component JPEG is decoded");
            if (nc != 1 && nc != 3)
                return refuse(err, "JPEG has %d components: only gray and 3-component JPEG is decoded", nc);
            if (n != size_t(6 + 3 * nc))
                return refuse(err, "JPEG SOF segment holds %zu bytes, %d for %d components", n, 6 + 3 * nc, nc);
            if (f.height == 0)
                return refuse(err, "JPEG has height 0 in its SOF (the height in a DNL marker is not decoded)");
            if (f.width == 0) return refuse(err, "JPEG has width 0");
            f.n = nc;
            f.progressive = marker == 0xC2;
            bool bad = false;
            for (int i = 0; i < nc; ++i) {
                f.ids[i] = seg[6 + 3 * i];
                f.h[i] = seg[7 + 3 * i] >> 4;
                f.v[i] = seg[7 + 3 * i] & 15;
                f.tq[i] = seg[8 + 3 * i];
                for (int j = 0; j < i; ++j)
                    if (f.ids[j] == f.ids[i]) return refuse(err, "JPEG has duplicate component ids");
                bad |= f.h[i] < 1 || f.h[i] > 4 || f.v[i] < 1 || f.v[i] > 4 || f.tq[i] > 3;
            }
            if (bad) return refuse(err, "JPEG SOF is corrupt: sampling factors or quantization tables out of range");
            if (nc == 3) {
                int hmax = 0, vmax = 0;
                for (int i = 0; i < 3; ++i) hmax = f.h[i] > hmax ? f.h[i] : hmax, vmax = f.v[i] > vmax ? f.v[i] : vmax;
                for (int i = 0; i < 3; ++i) {
                    const int rx = hmax / f.h[i], ry = vmax / f.v[i];
                    if (hmax % f.h[i] || vmax % f.v[i] || !((rx == 1 && ry == 1) || (rx == 2 && ry == 1) ||
                                                            (rx == 2 && ry == 2)))
                        return refuse(err, "JPEG has sampling factors %dx%d, %dx%d, %dx%d: only 4:4:4, 4:2:2 and "
                                           "4:2:0 are decoded", f.h[0], f.v[0], f.h[1], f.v[1], f.h[2], f.v[2]);
                }
            }
            have_frame = true;
        } else if (marker == 0xCC) {
            return refuse(err, "JPEG has a DAC marker (arithmetic coding is not decoded)");
        } else if (marker == 0xDA) {  // SOS, then the entropy-coded data up to the next marker other than RSTn
            if (!have_frame) return refuse(err, "JPEG has an SOS marker before any SOF");
            const int index = nscans;
            const int ns = n ? seg[0] : 0;
            if (ns < 1 || ns > 4 || n != size_t(4 + 2 * ns))
                return refuse(err, "JPEG SOS of scan %d is corrupt (%d components in %zu bytes)", index, ns, n);
            int comps[4], dc[4], ac[4];
            for (int i = 0; i < ns; ++i) {
                const int cid = seg[1 + 2 * i], tables = seg[2 + 2 * i];
                int c = -1;
                for (int j = 0; j < f.n; ++j)
                    if (f.ids[j] == cid) c = j;
                if (c < 0)
                    return refuse(err, "JPEG scan %d names component %d, which the SOF does not define", index, cid);
                for (int j = 0; j < i; ++j)
                    if (comps[j] == c) return refuse(err, "JPEG scan %d names component %d twice", index, cid);
                comps[i] = c;
                dc[i] = tables >> 4;
                ac[i] = tables & 15;
            }
            const int ss = seg[1 + 2 * ns], se = seg[2 + 2 * ns], ah = seg[3 + 2 * ns] >> 4, al = seg[3 + 2 * ns] & 15;
            if (ns > 1) {
                int blocks = 0;
                for (int i = 0; i < ns; ++i) blocks += f.h[comps[i]] * f.v[comps[i]];
                if (blocks > kMaxBlocksInMcu)
                    return refuse(err, "JPEG scan %d has more than %d blocks per MCU", index, kMaxBlocksInMcu);
            }
            bool need_dc, need_ac;
            if (!f.progressive) {
                if (ss != 0 || se != 63 || ah != 0 || al != 0)
                    return refuse(err, "JPEG sequential scan %d has Ss=%d Se=%d Ah=%d Al=%d, not 0, 63, 0, 0", index,
                                  ss, se, ah, al);
                need_dc = need_ac = true;
            } else {
                const bool dc_band = ss == 0;
                if ((dc_band && se != 0) || (!dc_band && (se < ss || se > 63 || ns != 1)) || (ah && al != ah - 1) ||
                    al > 13)
                    return refuse(err, "JPEG progressive scan %d has invalid parameters Ss=%d Se=%d Ah=%d Al=%d over "
                                       "%d components", index, ss, se, ah, al, ns);
                for (int i = 0; i < ns; ++i) {
                    const int c = comps[i];
                    if (!dc_band && coef_bits[c][0] < 0)
                        return refuse(err, "JPEG progressive scan %d sends AC coefficients of component %d before "
                                           "its DC", index, f.ids[c]);
                    for (int k = ss; k <= se; ++k)
                        if ((coef_bits[c][k] > 0 ? coef_bits[c][k] : 0) != ah)
                            return refuse(err, "JPEG progressive scan %d refines bits of component %d that its earlier "
                                               "scans did not send in order (Ah=%d)", index, f.ids[c], ah);
                    for (int k = ss; k <= se; ++k) coef_bits[c][k] = al;
                }
                need_dc = dc_band && ah == 0;
                need_ac = !dc_band;
            }
            int32_t rec[kScanFields];
            for (int k = 0; k < kScanFields; ++k) rec[k] = -1;
            rec[kNcomp] = ns;
            for (int i = 0; i < ns; ++i) {
                const int c = comps[i];
                if (!is_latched[c]) {
                    if (!quant_set[f.tq[c]])
                        return refuse(err, "JPEG component %d uses quantization table %d, which no DQT defines before "
                                           "its first scan", f.ids[c], f.tq[c]);
                    std::memcpy(latched[c], quant[f.tq[c]], sizeof(latched[c]));
                    is_latched[c] = true;
                }
                for (int cls = 0; cls < 2; ++cls) {
                    const int id = cls == 0 ? dc[i] : ac[i];
                    if (!(cls == 0 ? need_dc : need_ac)) continue;
                    if (id > 3 || !huff[cls][id].set)
                        return refuse(err, "JPEG scan %d reads %s Huffman table %d, which no DHT defines", index,
                                      cls == 0 ? "DC" : "AC", id);
                    // the table as it stands at this scan
                    rec[(cls == 0 ? kDcTable : kAcTable) + i] = static_cast<int32_t>(out->huff.size() / 272);
                    out->huff.insert(out->huff.end(), huff[cls][id].data, huff[cls][id].data + 272);
                }
                rec[kComp + i] = c;
            }
            // the scan ends at the first run of 0xFF followed by a byte other
            // than 0x00 (a stuffed 0xFF), RSTn or 0xFF
            size_t q = pos, stop = len;
            while (q < len) {
                const auto* ff = static_cast<const uint8_t*>(std::memchr(blob + q, 0xFF, len - q));
                if (ff == nullptr) break;
                size_t r = ff - blob;
                const size_t start = r;
                while (r < len && blob[r] == 0xFF) ++r;
                if (r >= len) break;
                if (blob[r] != 0x00 && !(blob[r] >= 0xD0 && blob[r] <= 0xD7)) {
                    stop = start;
                    break;
                }
                q = r + 1;
            }
            if (stop == len) return refuse(err, "JPEG is truncated: scan %d runs to the end of the file", index);
            rec[kSs] = ss, rec[kSe] = se, rec[kAh] = ah, rec[kAl] = al;
            rec[kRestart] = restart;
            rec[kOffset] = static_cast<int32_t>(pos);
            rec[kLength] = static_cast<int32_t>(stop - pos);
            out->scans.insert(out->scans.end(), rec, rec + kScanFields);
            for (int i = 0; i < ns; ++i) seen[comps[i]] = true;
            ++nscans;
            pos = stop;
        } else if (marker == 0xDC) {
            return refuse(err, "JPEG has a DNL marker (a height given after the first scan is not decoded)");
        } else if (marker == 0xDE || marker == 0xDF) {
            return refuse(err, "JPEG is hierarchical (DHP/EXP marker)");
        } else {
            return refuse(err, "JPEG has the unknown marker 0xff%02x at byte %zu", marker, pos - length - 2);
        }
    }
    if (!have_frame || nscans == 0) return refuse(err, "JPEG has no frame or no scan before its EOI");
    for (int c = 0; c < f.n; ++c)
        if (!seen[c]) return refuse(err, "JPEG never codes component %d in a scan", f.ids[c]);
    if (f.progressive)
        for (int c = 0; c < f.n; ++c)
            for (int k = 0; k < kSmoothed; ++k)
                if (coef_bits[c][k] != 0)
                    return refuse(err, "JPEG is progressive and its scans leave coefficient %d of component %d "
                                       "incomplete: libjpeg smooths such blocks, which is not decoded", k, f.ids[c]);
    int color = 0;  // libjpeg's guess for 3 components (jdapimin.c): 1 YCbCr, 2 RGB
    if (f.n == 3) {
        if (jfif) {
            color = 1;
        } else if (adobe >= 0) {
            color = adobe == 0 ? 2 : 1;
        } else {
            color = (f.ids[0] == 'R' && f.ids[1] == 'G' && f.ids[2] == 'B') ? 2 : 1;
        }
    }
    out->frame = {f.width, f.height, f.n, f.progressive ? 1 : 0, color};
    for (int c = 0; c < f.n; ++c) out->frame.insert(out->frame.end(), {f.h[c], f.v[c]});
    out->quant.assign(&latched[0][0], &latched[0][0] + 64 * f.n);
    return true;
}

// The image that `jpeg_parse` read into t, decoded into out (height x width
// x 3); false with the reason in *err
inline bool jpeg_decode_parsed(const uint8_t* blob, size_t len, const JpegTables& t, uint8_t* out, std::string* err) {
    char msg[256];
    Error e{msg, static_cast<int>(sizeof(msg))};
    if (!jpeg_decode_tables(blob, static_cast<int64_t>(len), t.frame.data(), t.quant.data(), t.huff.data(),
                            static_cast<int32_t>(t.huff.size() / 272), t.scans.data(),
                            static_cast<int32_t>(t.scans.size() / kScanFields), out, e))
        return refuse(err, "JPEG %s", msg);
    return true;
}

// JPEG bytes (the SOI checked by the caller) -> img, libjpeg-turbo's pixels
// as `data/jpeg.py::decode_jpeg` gives them; false with the reason in *err
inline bool decode_jpeg(const uint8_t* blob, size_t len, RgbImage* img, std::string* err) {
    JpegTables t;
    if (!jpeg_parse(blob, len, &t, err)) return false;
    img->w = t.frame[kWidth];
    img->h = t.frame[kHeight];
    img->rgb.resize(size_t(img->w) * img->h * 3);
    return jpeg_decode_parsed(blob, len, t, img->rgb.data(), err);
}

}  // namespace rick
