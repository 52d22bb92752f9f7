// Native host-runtime components for cornelis_tpu_torch.
//
// The port's copy of cornelis_tpu/native/cornelis_native.cpp, kept
// byte-for-byte in its logic so that both packages write the same PNG
// bytes. The reference's host runtime is native C/C++: the PNG encoder is
// vendored stb_image_write (src/extern/stb_image_write.h, used via
// stbi_write_png at src/Render.cpp:263) and the tonemap/quantize pass is
// C++ std::transform over the framebuffer (src/Render.cpp:257-262,
// include/cornelis/FrameBuffer.hpp:91-107). This file is the from-scratch
// C++ equivalent of that image-output runtime, plus the film accumulator.
// It is strictly host-side (device -> film -> sRGB -> PNG bytes).
//
// Exposed C ABI (loaded with ctypes from native/__init__.py):
//   cn_srgb_quantize   linear float RGB -> sRGB uint8 (12.95-quirk or
//                      standard 12.92 slope, matching math/color.py)
//   cn_accumulate      dst += src over float buffers (film add_samples)
//   cn_film_average    image = sum / count (film.image())
//   cn_encode_png_size / cn_encode_png  two-phase PNG encode (zlib deflate)
//   cn_write_png       encode + write to a file path
//
// Built by native/__init__.py with: g++ -O3 -std=c++17 -shared -fPIC ... -lz

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// sRGB transfer (src/Color.cpp:64-78). `standard` selects the 12.92 slope;
// the reference uses 12.95 (src/Color.cpp:47,68).
inline float srgb_encode(float v, float slope) {
    if (v <= 0.0031308f) return v * slope;
    float base = v > 0.0f ? v : 0.0f;
    return 1.055f * std::pow(base, 1.0f / 2.4f) - 0.055f;
}

// round(255 x) clamp [0,255] (FrameBuffer.hpp:91-100). nearbyintf under the
// default FE_TONEAREST mode rounds half-to-even, matching numpy/jnp.round.
inline uint8_t quantize(float e) {
    float q = std::nearbyint(255.0f * e);
    if (q < 0.0f) q = 0.0f;
    if (q > 255.0f) q = 255.0f;
    return static_cast<uint8_t>(q);
}

// PNG scanline serialization: filter byte 0 (None) per row, matching the
// pure-Python encoder so outputs are byte-identical at equal zlib settings.
std::vector<uint8_t> filtered_scanlines(const uint8_t* rgb, int32_t w, int32_t h) {
    const size_t stride = static_cast<size_t>(w) * 3;
    std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
    for (int32_t y = 0; y < h; ++y) {
        uint8_t* row = raw.data() + static_cast<size_t>(y) * (stride + 1);
        row[0] = 0;
        std::memcpy(row + 1, rgb + static_cast<size_t>(y) * stride, stride);
    }
    return raw;
}

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
    out.push_back(static_cast<uint8_t>(v >> 24));
    out.push_back(static_cast<uint8_t>(v >> 16));
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v));
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4], const uint8_t* payload,
               size_t len) {
    put_be32(out, static_cast<uint32_t>(len));
    size_t tag_pos = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), payload, payload + len);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, out.data() + tag_pos, static_cast<uInt>(4 + len));
    put_be32(out, crc);
}

// Full encode into `out`; returns 0 on success.
int encode_png(const uint8_t* rgb, int32_t w, int32_t h, int compress_level,
               std::vector<uint8_t>& out) {
    if (w <= 0 || h <= 0 || rgb == nullptr) return -1;

    std::vector<uint8_t> raw = filtered_scanlines(rgb, w, h);
    uLongf bound = compressBound(static_cast<uLong>(raw.size()));
    std::vector<uint8_t> idat(bound);
    if (compress2(idat.data(), &bound, raw.data(), static_cast<uLong>(raw.size()),
                  compress_level) != Z_OK) {
        return -2;
    }
    idat.resize(bound);

    uint8_t ihdr[13];
    ihdr[0] = static_cast<uint8_t>(w >> 24);
    ihdr[1] = static_cast<uint8_t>(w >> 16);
    ihdr[2] = static_cast<uint8_t>(w >> 8);
    ihdr[3] = static_cast<uint8_t>(w);
    ihdr[4] = static_cast<uint8_t>(h >> 24);
    ihdr[5] = static_cast<uint8_t>(h >> 16);
    ihdr[6] = static_cast<uint8_t>(h >> 8);
    ihdr[7] = static_cast<uint8_t>(h);
    ihdr[8] = 8;   // bit depth
    ihdr[9] = 2;   // color type: truecolor RGB
    ihdr[10] = 0;  // compression
    ihdr[11] = 0;  // filter method
    ihdr[12] = 0;  // interlace

    static const uint8_t signature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    out.clear();
    out.reserve(idat.size() + 128);
    out.insert(out.end(), signature, signature + 8);
    put_chunk(out, "IHDR", ihdr, sizeof(ihdr));
    put_chunk(out, "IDAT", idat.data(), idat.size());
    put_chunk(out, "IEND", nullptr, 0);
    return 0;
}

}  // namespace

extern "C" {

// Linear float RGB (n floats) -> sRGB-encoded uint8. standard != 0 selects
// the spec 12.92 slope; 0 keeps the reference's 12.95 quirk.
void cn_srgb_quantize(const float* linear, uint8_t* out, int64_t n, int standard) {
    const float slope = standard ? 12.92f : 12.95f;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = quantize(srgb_encode(linear[i], slope));
    }
}

// dst += src over n floats (Film.add_samples inner loop).
void cn_accumulate(float* dst, const float* src, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

// out = sum / count over n floats (Film.image()).
void cn_film_average(const float* sum, float* out, int64_t n, double count) {
    const float inv = count > 0.0 ? static_cast<float>(1.0 / count) : 0.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = sum[i] * inv;
}

// Two-phase PNG encode so the caller owns the output buffer:
//   1. cn_encode_png_size -> required byte count (or < 0 on error)
//   2. cn_encode_png      -> fills caller buffer, returns bytes written
// The encode runs once per call; callers that want one pass use
// cn_write_png below.
int64_t cn_encode_png_size(const uint8_t* rgb, int32_t w, int32_t h,
                           int compress_level) {
    std::vector<uint8_t> out;
    if (encode_png(rgb, w, h, compress_level, out) != 0) return -1;
    return static_cast<int64_t>(out.size());
}

int64_t cn_encode_png(const uint8_t* rgb, int32_t w, int32_t h, int compress_level,
                      uint8_t* buffer, int64_t capacity) {
    std::vector<uint8_t> out;
    if (encode_png(rgb, w, h, compress_level, out) != 0) return -1;
    if (static_cast<int64_t>(out.size()) > capacity) return -2;
    std::memcpy(buffer, out.data(), out.size());
    return static_cast<int64_t>(out.size());
}

// Encode and write to `path`; returns 0 on success.
int cn_write_png(const char* path, const uint8_t* rgb, int32_t w, int32_t h,
                 int compress_level) {
    std::vector<uint8_t> out;
    int rc = encode_png(rgb, w, h, compress_level, out);
    if (rc != 0) return rc;
    FILE* f = std::fopen(path, "wb");
    if (f == nullptr) return -3;
    size_t written = std::fwrite(out.data(), 1, out.size(), f);
    if (std::fclose(f) != 0) return -4;
    return written == out.size() ? 0 : -5;
}

// ABI version for the ctypes loader to sanity-check.
int cn_abi_version(void) { return 1; }

}  // extern "C"
