// Block-floating-point codec for f32 wavefield snapshots / model vectors.
//
// The port's copy of jets_tpu/utils/_compress.cpp, the same bytes but for
// one repair: a block whose max |x| is below qmax / FLT_MAX (down to the
// subnormals a wavefield's quiet far side holds) overflows qmax / max to
// inf, and the copy in jets_tpu then rounds inf or NaN, which the native
// code and the numpy fallback do differently; here such a block scales as
// (x / max) * qmax in both. The reference family's wave propagators serialize forward
// wavefields through a lossy C++ compressor (CvxCompress) to trade
// memory/IO for recompute in adjoint-state imaging; this is the
// equivalent: fixed-rate block-float quantization, simple enough to be
// bit-reproducible from the pure-numpy fallback (tests pin byte equality),
// fast enough to keep up with host<->device snapshot traffic.
//
// Format (little endian), independent fixed-size blocks of 256 floats:
//   [f32 inv_scale][ceil(m*bits/8) bytes of offset-binary mantissas]
// where m is the block length (256, short last block), q in
// [-(2^(b-1)-1), +(2^(b-1)-1)] stored as u = q + bias, bias = 2^(b-1)-1,
// x_hat = q * inv_scale. bits in {4, 8, 12, 16}.
//
// Compiled with -ffp-contract=off so the float ops match numpy exactly.
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

static const int64_t BLK = 256;

int64_t jets_compress_bound(int64_t n, int bits) {
    int64_t nblk = (n + BLK - 1) / BLK;
    return nblk * (int64_t)sizeof(float) + (n * bits + 7) / 8 + nblk;
}

// returns bytes written, or -1 on bad bits
int64_t jets_compress_f32(const float* src, int64_t n, int bits,
                          uint8_t* dst) {
    if (bits != 4 && bits != 8 && bits != 12 && bits != 16) return -1;
    const int32_t qmax = (1 << (bits - 1)) - 1;
    uint8_t* p = dst;
    for (int64_t b0 = 0; b0 < n; b0 += BLK) {
        const int64_t m = (n - b0 < BLK) ? (n - b0) : BLK;
        const float* x = src + b0;
        float maxv = 0.0f;
        for (int64_t i = 0; i < m; ++i) {
            float a = std::fabs(x[i]);
            if (a > maxv) maxv = a;
        }
        const float scale = maxv > 0.0f ? (float)qmax / maxv : 0.0f;
        const float inv_scale = maxv > 0.0f ? maxv / (float)qmax : 0.0f;
        const bool tiny = std::isinf(scale);  // x * scale would be inf or NaN
        std::memcpy(p, &inv_scale, 4);
        p += 4;
        // quantize to offset binary
        uint32_t q[BLK];
        for (int64_t i = 0; i < m; ++i) {
            float v = tiny ? (x[i] / maxv) * (float)qmax : x[i] * scale;
            int32_t qi = (int32_t)std::lrintf(v);
            if (qi > qmax) qi = qmax;
            if (qi < -qmax) qi = -qmax;
            q[i] = (uint32_t)(qi + qmax);
        }
        // bit-pack little-endian
        if (bits == 8) {
            for (int64_t i = 0; i < m; ++i) p[i] = (uint8_t)q[i];
            p += m;
        } else if (bits == 16) {
            for (int64_t i = 0; i < m; ++i) {
                p[2 * i] = (uint8_t)(q[i] & 0xff);
                p[2 * i + 1] = (uint8_t)(q[i] >> 8);
            }
            p += 2 * m;
        } else if (bits == 4) {
            int64_t nb = (m + 1) / 2;
            for (int64_t i = 0; i < nb; ++i) {
                uint32_t lo = q[2 * i];
                uint32_t hi = (2 * i + 1 < m) ? q[2 * i + 1] : 0;
                p[i] = (uint8_t)(lo | (hi << 4));
            }
            p += nb;
        } else {  // 12
            int64_t nb = (m * 12 + 7) / 8;
            std::memset(p, 0, nb);
            for (int64_t i = 0; i < m; ++i) {
                int64_t bitpos = i * 12;
                int64_t byte = bitpos >> 3;
                int off = (int)(bitpos & 7);
                uint32_t v = q[i] << off;
                p[byte] |= (uint8_t)(v & 0xff);
                p[byte + 1] |= (uint8_t)((v >> 8) & 0xff);
                if (off > 4) p[byte + 2] |= (uint8_t)((v >> 16) & 0xff);
            }
            p += nb;
        }
    }
    return (int64_t)(p - dst);
}

void jets_decompress_f32(const uint8_t* src, int64_t n, int bits,
                         float* dst) {
    const int32_t qmax = (1 << (bits - 1)) - 1;
    const uint8_t* p = src;
    for (int64_t b0 = 0; b0 < n; b0 += BLK) {
        const int64_t m = (n - b0 < BLK) ? (n - b0) : BLK;
        float inv_scale;
        std::memcpy(&inv_scale, p, 4);
        p += 4;
        float* x = dst + b0;
        if (bits == 8) {
            for (int64_t i = 0; i < m; ++i)
                x[i] = (float)((int32_t)p[i] - qmax) * inv_scale;
            p += m;
        } else if (bits == 16) {
            for (int64_t i = 0; i < m; ++i) {
                uint32_t u = (uint32_t)p[2 * i]
                             | ((uint32_t)p[2 * i + 1] << 8);
                x[i] = (float)((int32_t)u - qmax) * inv_scale;
            }
            p += 2 * m;
        } else if (bits == 4) {
            int64_t nb = (m + 1) / 2;
            for (int64_t i = 0; i < m; ++i) {
                uint32_t byte = p[i >> 1];
                uint32_t u = (i & 1) ? (byte >> 4) : (byte & 0xf);
                x[i] = (float)((int32_t)u - qmax) * inv_scale;
            }
            p += nb;
        } else {  // 12
            int64_t nb = (m * 12 + 7) / 8;
            for (int64_t i = 0; i < m; ++i) {
                int64_t bitpos = i * 12;
                int64_t byte = bitpos >> 3;
                int off = (int)(bitpos & 7);
                uint32_t v = (uint32_t)p[byte]
                             | ((uint32_t)p[byte + 1] << 8);
                if (off > 4)  // value spans 3 bytes; byte+2 < nb then
                    v |= ((uint32_t)p[byte + 2] << 16);
                uint32_t u = (v >> off) & 0xfff;
                x[i] = (float)((int32_t)u - qmax) * inv_scale;
            }
            p += nb;
        }
    }
}

}  // extern "C"
