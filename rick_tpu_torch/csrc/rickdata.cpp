// The threaded batch decoder of `data/native.py`: the port of `rick_tpu`'s
// native data-loader runtime (`rick_tpu/data/cpp/rickdata.cpp`), with the
// same C ABI, over the port's own PNG and JPEG readers and inflate in place
// of libpng, libjpeg and zlib.
//
// An mmap'd record-store reader and a pool of threads that decode PNG or
// JPEG blobs, resize the shorter side to the output size (float bilinear,
// half-pixel centers), center-crop, optionally flip, and write
// px * (1 / 127.5) - 1 into a caller's float32 NCHW buffer: one call per
// batch, made through ctypes, which releases the GIL while it runs.  The
// resize and the normalization are `rick_tpu`'s, line for line; a blob that
// is neither PNG nor JPEG fails, as it does there.
//
// Includes only headers of this directory, the C++17 standard library and
// POSIX.  Built with g++ (`ops/_build.host_library`).
//
// Record-store layout (see data/store.py):
//   [8s magic "RICKRDB1"][u64 n][n x (u64 offset, u64 length)][blobs...]

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "host_image.h"
#include "inflate.h"
#include "jpeg_parse.h"
#include "png_decode.h"

namespace {

using rick::RgbImage;

struct Store {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t size = 0;
    uint64_t count = 0;
    const uint64_t* table = nullptr;  // (offset, length) pairs
};

constexpr char kMagic[8] = {'R', 'I', 'C', 'K', 'R', 'D', 'B', '1'};

bool decode_image(const uint8_t* data, size_t size, RgbImage* img, std::string* err) {
    if (size >= 8 && std::memcmp(data, rick::kPngSignature, 8) == 0) return rick::decode_png(data, size, img, err);
    if (size >= 2 && data[0] == 0xFF && data[1] == 0xD8) return rick::decode_jpeg(data, size, img, err);
    std::string head;
    for (size_t i = 0; i < size && i < 8; ++i) {
        char hex[5];
        std::snprintf(hex, sizeof(hex), "\\x%02x", data[i]);
        head += hex;
    }
    return rick::refuse(err, "not PNG or JPEG (starts with b'%s')", head.c_str());
}

// ---------------------------------------------------------------------------
// Resize (bilinear in float, half-pixel centers, as cv2.INTER_LINEAR
// samples), crop, flip, normalize to CHW float32 in [-1, 1]; rick_tpu's,
// unchanged
// ---------------------------------------------------------------------------

void resize_bilinear(const RgbImage& src, int nh, int nw, RgbImage* dst) {
    dst->h = nh;
    dst->w = nw;
    dst->rgb.resize(static_cast<size_t>(nh) * nw * 3);
    const float sy = static_cast<float>(src.h) / nh;
    const float sx = static_cast<float>(src.w) / nw;
    for (int y = 0; y < nh; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        int y0 = static_cast<int>(std::floor(fy));
        float wy = fy - y0;
        int y0c = y0 < 0 ? 0 : (y0 >= src.h ? src.h - 1 : y0);
        int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= src.h ? src.h - 1 : y0 + 1);
        const uint8_t* r0 = src.rgb.data() + static_cast<size_t>(y0c) * src.w * 3;
        const uint8_t* r1 = src.rgb.data() + static_cast<size_t>(y1c) * src.w * 3;
        uint8_t* out = dst->rgb.data() + static_cast<size_t>(y) * nw * 3;
        for (int x = 0; x < nw; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            int x0 = static_cast<int>(std::floor(fx));
            float wx = fx - x0;
            int x0c = x0 < 0 ? 0 : (x0 >= src.w ? src.w - 1 : x0);
            int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= src.w ? src.w - 1 : x0 + 1);
            for (int c = 0; c < 3; ++c) {
                float top = r0[x0c * 3 + c] * (1 - wx) + r0[x1c * 3 + c] * wx;
                float bot = r1[x0c * 3 + c] * (1 - wx) + r1[x1c * 3 + c] * wx;
                float v = top * (1 - wy) + bot * wy;
                out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

// Decode one blob into out (3*size*size floats, CHW, [-1,1]).
bool process_one(const uint8_t* blob, size_t len, int size, bool flip, float* out, std::string* err) {
    RgbImage img;
    if (!decode_image(blob, len, &img, err)) return false;

    RgbImage resized;
    const RgbImage* cur = &img;
    if (std::min(img.h, img.w) != size) {
        int nh, nw;
        if (img.h < img.w) {
            nh = size;
            nw = std::max(1, static_cast<int>(std::lround(static_cast<double>(img.w) * size / img.h)));
        } else {
            nw = size;
            nh = std::max(1, static_cast<int>(std::lround(static_cast<double>(img.h) * size / img.w)));
        }
        resize_bilinear(img, nh, nw, &resized);
        cur = &resized;
    }

    int top = (cur->h - size) / 2;
    int left = (cur->w - size) / 2;
    const float inv = 1.0f / 127.5f;
    for (int y = 0; y < size; ++y) {
        const uint8_t* row = cur->rgb.data() + (static_cast<size_t>(top + y) * cur->w + left) * 3;
        for (int x = 0; x < size; ++x) {
            int sx = flip ? (size - 1 - x) : x;
            const uint8_t* px = row + sx * 3;
            for (int c = 0; c < 3; ++c) {
                out[(static_cast<size_t>(c) * size + y) * size + x] = px[c] * inv - 1.0f;
            }
        }
    }
    return true;
}

}  // namespace

extern "C" {

void* rd_open(const char* path) {
    std::string file = std::string(path) + "/records.rdb";
    int fd = ::open(file.c_str(), O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        ::close(fd);
        return nullptr;
    }
    if (st.st_size < 16) {
        ::close(fd);
        return nullptr;
    }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (base == MAP_FAILED) {
        ::close(fd);
        return nullptr;
    }
    auto* s = new Store();
    s->fd = fd;
    s->base = static_cast<const uint8_t*>(base);
    s->size = st.st_size;
    std::memcpy(&s->count, s->base + 8, 8);
    if (std::memcmp(s->base, kMagic, 8) != 0 || s->count > (s->size - 16) / 16) {
        munmap(base, st.st_size);
        ::close(fd);
        delete s;
        return nullptr;
    }
    s->table = reinterpret_cast<const uint64_t*>(s->base + 16);
    return s;
}

void rd_close(void* handle) {
    auto* s = static_cast<Store*>(handle);
    if (!s) return;
    munmap(const_cast<uint8_t*>(s->base), s->size);
    ::close(s->fd);
    delete s;
}

int64_t rd_count(void* handle) {
    return static_cast<Store*>(handle)->count;
}

int rd_get(void* handle, int64_t idx, const uint8_t** ptr, uint64_t* len) {
    auto* s = static_cast<Store*>(handle);
    if (idx < 0 || static_cast<uint64_t>(idx) >= s->count) return -1;
    uint64_t off = s->table[2 * idx];
    uint64_t n = s->table[2 * idx + 1];
    if (off > s->size || n > s->size - off) return -2;
    *ptr = s->base + off;
    *len = n;
    return 0;
}

// Decode a batch: indices[n], flips[n] (0/1), out (n*3*size*size floats).
// Returns 0 on success, else the 1-based index of the first failed record
// (by position in the batch, among those the threads reached).
int rd_decode_batch(void* handle, const int64_t* indices, int n, int size,
                    const uint8_t* flips, float* out, int n_threads) {
    auto* s = static_cast<Store*>(handle);
    std::atomic<int> next(0);
    std::atomic<int> failed(0);
    const size_t stride = static_cast<size_t>(3) * size * size;

    auto worker = [&]() {
        std::string err;
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n || failed.load()) return;
            const uint8_t* blob;
            uint64_t len;
            if (rd_get(s, indices[i], &blob, &len) != 0 ||
                !process_one(blob, len, size, flips[i] != 0, out + stride * i, &err)) {
                int prior = failed.load();
                while ((prior == 0 || i + 1 < prior) && !failed.compare_exchange_weak(prior, i + 1)) {
                }
                return;
            }
        }
    };

    int nt = n_threads > 0 ? n_threads : 1;
    nt = std::min(nt, std::max(n, 1));
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }
    return failed.load();
}

// Why record `idx` does not decode at `size`: decodes it once more (the
// decoders are deterministic) and writes the reason to err.  Returns 0 if it
// decodes, else 1.
int rd_why(void* handle, int64_t idx, int size, char* err, int err_len) {
    auto* s = static_cast<Store*>(handle);
    const uint8_t* blob;
    uint64_t len;
    std::string why;
    const int got = rd_get(s, idx, &blob, &len);
    if (got != 0) {
        why = got == -1 ? "index out of range" : "record extends past the end of the store";
    } else {
        std::vector<float> out(static_cast<size_t>(3) * size * size);
        if (process_one(blob, len, size, false, out.data(), &why)) return 0;
    }
    std::snprintf(err, err_len, "%s", why.c_str());
    return 1;
}

// zlib.decompress of src[0:n] by the decoder's own inflate (`inflate.h`):
// the length of the output, of which the first min(length, cap) bytes are
// written to dst; or -1 with zlib's reason in err.
int64_t rd_inflate(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err, int err_len) {
    rick::InflateOut out;
    if (const char* why = rick::zlib_inflate(src, static_cast<size_t>(n), out, SIZE_MAX)) {
        std::snprintf(err, err_len, "%s", why);
        return -1;
    }
    if (cap > 0) std::memcpy(dst, out.data, std::min<size_t>(out.size, static_cast<size_t>(cap)));
    return static_cast<int64_t>(out.size);
}

}  // extern "C"
