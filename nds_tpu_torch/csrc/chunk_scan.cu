// Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
//
// Fused chunk scan for Hopper (sm_90a): K4, the port of the Pallas kernel
// nds_tpu/engine/kernels.py fused_chunk_scan (body: _eval_entries +
// _fold_hash). Per row of one padded chunk it computes
//
//   mask[i] = AND of every lowered WHERE entry on the stored codes
//             & (i < n_dev)
//   hash[i] = the uint32 partition/shard routing hash over the key columns
//             (only when the pipeline partitions)
//
// Semantics kept bit for bit with the reference's _eval_entries (and with
// the plain version, kernels.py chunk_scan_plain):
//   * a FALSE entry clears the mask whatever came before it;
//   * the int lane widens stored codes to int64 with sign extension (uint8
//     and bool zero-extend; a float column truncates toward zero, as
//     .to(int64) does);
//   * the float lane decodes FOR (code + base, wrapping in int64), dict
//     (value table at the code clipped into range) or identity, then
//     divides by 10^scale with a true IEEE division (__ddiv_rn; this file
//     must not be built with fast math);
//   * NaN compares as IEEE does;
//   * the hash seed is 2166136261, the multipliers 2654435761 and
//     2246822519 with the shifts 16 and 13; a key hashes its value widened
//     to int64 (a float key its bit pattern, a float32 sign-extended through
//     int32), split into its low and high 32-bit words.
//
// What bounds it on an H100: bytes. Each referenced column is read once
// (1-8 B of code and 1 B of validity a row), the mask (1 B) and the hash
// (4 B) are written once: 4-25 B a row, 5-31 us for a 2^22-row chunk at
// 3.35 TB/s. Three things held the first version (one thread a row, the
// spec interpreted for every row and entry) at a fifth of that:
//   1. every row decoded the spec again: six entry words, the column's
//      pointers and tag by a runtime index, its decode metadata, and a
//      two-level switch, a dozen uniform loads and branches to move 1-4 B;
//   2. each thread issued one 1-4 B load per entry and 1 B + 4 B stores,
//      so an SM kept a few KB in flight where about 15-20 KB cover the
//      latency of device memory;
//   3. IN-lists and dict tables were walked in global memory per row, and a
//      column that two entries read was loaded and decoded twice.
//
// The design (chunk_scan_tiles):
//   * the packed spec (kernels.py pack_scan_spec: entries, per-column
//     decode metadata, IN-lists, dict tables, in that order) is staged once
//     a block into shared memory, as far as whole regions fit the budget
//     the host gives (kernels.py scan_staged_words: 48 KB less the static
//     column and key records, so that no launch has to opt in to more); a
//     region that does not fit is read from global memory through the
//     read-only path. The chunk's column pointers, tags and alignment go to
//     shared memory with it;
//   * each thread owns a tile of R = 16 consecutive rows and keeps their
//     mask bits in a register. Entries run entry-major: for each entry the
//     switch on opcode and tag is taken once a tile (the same for the
//     whole warp), the column's R codes come in with 16-byte vector loads,
//     are decoded once, compared, and ANDed into the bits. Codes of at
//     most 4 bytes compare in 32 bits (an int64 threshold past int32
//     decides the whole tile); wider ones in 64. The validity bytes become
//     bits four at a time;
//   * consecutive entries on one column reuse its validity and its decoded
//     int64 or float tile (the float decode, with its division, is the one
//     that costs);
//   * IN-list values are read once a tile, not once a row;
//   * the mask goes out as R bytes in one store, the hash is folded over
//     the same tile from vector key loads and stored four values to a
//     16-byte store;
//   * the float lane and the hash are template switches: a spec without
//     float entries, or a launch without keys, runs a kernel that carries
//     neither path (every real spec of the stream phase is int-lane only);
//   * a persistent grid walks the tiles; the threads a block and the
//     blocks an SM come from the host's plan (kernels.py scan_plan):
//     256 threads, 2 blocks an SM: the best at every real shape of
//     chip_smoke.py's k4 sweep and within 2 % of it on the synthetic spec
//     (the kernels take 109-128 registers, so two blocks of 256 is what an
//     SM holds; NVIDIA H100 80GB HBM3, 700.00 W);
//   * a tile past the last full one, and a column whose pointer is not
//     16-byte aligned (a view with a storage offset), take scalar loads and
//     stores inside the same kernel.
// Tried on the card and dropped: 4-, 8- and 32-row tiles (fewer bytes in
// flight a thread, or more registers; slower at every real shape) and an
// uncached int64 lane (more registers, not fewer).
// Not done: a kernel compiled per spec (what Pallas does by tracing the
// spec). On this card it means nvcc or NVRTC at the first sight of each
// spec, seconds that every streamed statement would pay, and the real
// specs have one or two entries (PERF.md section 6).
//
// Plain C interface (nvcc into a shared library, loaded with ctypes): the
// argument block is passed by pointer and copied into the launch by value;
// the function enqueues on the given stream, allocates nothing and returns
// the cudaGetLastError() code of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define NDS_SCAN_MAX_COLS 16
#define NDS_SCAN_MAX_KEYS 8

// dtype tags of the column and key buffers
enum {
    TAG_I8 = 1, TAG_I16 = 2, TAG_I32 = 3, TAG_I64 = 4,
    TAG_F32 = 5, TAG_F64 = 6, TAG_U8 = 7
};

// entry opcodes (engine/kernels.py _SCAN_OPS keeps the same numbers)
enum {
    OP_FALSE = 0, OP_TRUE = 1, OP_ISNULL = 2, OP_NOTNULL = 3,
    OP_IEQ = 4, OP_INE = 5, OP_ILE = 6, OP_IGE = 7,
    OP_IRANGE = 8, OP_NRANGE = 9, OP_IIN = 10, OP_INOTIN = 11,
    OP_FEQ = 12, OP_FNE = 13, OP_FLT = 14, OP_FLE = 15, OP_FGT = 16,
    OP_FGE = 17, OP_FIN = 18, OP_FNOTIN = 19, OP_FRANGE = 20,
    OP_FNRANGE = 21
};

// float-lane decode modes
enum { FM_ID = 0, FM_FOR = 1, FM_DICT = 2 };

// packed spec words (kernels.py SCAN_ENT_WORDS, SCAN_COL_WORDS):
//   entry:  op, col, a, b, fa bits, fb bits, list offset, list length
//           (the offset counts from the int or float IN-list region)
//   column: fmode, FOR base, 10^scale divisor bits, table offset (from the
//           table region), table length
constexpr int kEntWords = 8;
constexpr int kColWords = 5;

struct NdsScanArgs {
    const void* data[NDS_SCAN_MAX_COLS];
    const unsigned char* valid[NDS_SCAN_MAX_COLS];   // null: no mask
    const void* keys[NDS_SCAN_MAX_KEYS];
    int data_tag[NDS_SCAN_MAX_COLS];
    int key_tag[NDS_SCAN_MAX_KEYS];
    int ncols;
    int nentries;
    int nkeys;
    int float_lane;            // the spec has float-lane entries
    const long long* spec;     // packed words: entries, columns, int
                               // IN-lists, float IN-lists (bits), tables
    int off_cols;              // region starts, in words
    int off_ivals;
    int off_fvals;
    int off_tables;
    int total_words;
    int staged_words;          // the prefix a block copies to shared memory
    int threads;               // plan: threads a block
    int grid;                  // plan: blocks
    int smem;                  // plan: dynamic shared bytes (8 * staged)
    const long long* n_dev;    // live rows of the chunk (device scalar)
    long long plen;
    unsigned char* mask;       // [plen] bool
    unsigned int* hash;        // [plen] uint32, or null: no hash
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int R = 16;                     // rows a thread's tile
constexpr unsigned kAll = (1u << R) - 1u; // the mask bits of a whole tile

// one column of the chunk as a block sees it (shared memory; kernels.py
// SCAN_STATIC_SMEM counts these two arrays)
struct ColInfo {
    const void* data;
    const unsigned char* valid;
    const long long* tbl;      // dict values (shared or global memory)
    long long base;
    long long tbl_len;
    double sdiv;
    int tag;
    int fmode;
    int vec;                   // data 16-byte aligned: vector loads
    int vvec;                  // validity 16-byte aligned
};

struct KeyInfo {
    const void* data;
    int tag;
    int vec;
};

// the kernel's static shared memory (kernels.py SCAN_STATIC_SMEM), and the
// most static and dynamic shared memory a block takes without opting in to
// more (cudaFuncAttributeMaxDynamicSharedMemorySize)
constexpr int kStaticSmem = static_cast<int>(
    NDS_SCAN_MAX_COLS * sizeof(ColInfo) + NDS_SCAN_MAX_KEYS * sizeof(KeyInfo));
static_assert(kStaticSmem == 1152, "kernels.py SCAN_STATIC_SMEM");
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ double dval(long long b) {
    return __longlong_as_double(b);
}

__device__ __forceinline__ long long dbits(double v) {
    return __double_as_longlong(v);
}

// R elements of S bytes at p[row0 ..] as raw bit patterns, zero-extended:
// 16-byte vector loads when ``vec`` (a full tile of a 16-byte aligned
// buffer; row0 is a multiple of R, so the tile is aligned to R * S), else
// scalar loads of the first n and zeros after.
template <int S>
__device__ __forceinline__ void load_tile(const void* p, long long row0,
                                          int n, bool vec,
                                          unsigned long long (&raw)[R]) {
    if (vec) {
        unsigned w[R * S / 4];
        const char* q = static_cast<const char*>(p) + row0 * S;
#pragma unroll
        for (int k = 0; k < R * S / 16; ++k) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + k);
            w[4 * k] = v.x;
            w[4 * k + 1] = v.y;
            w[4 * k + 2] = v.z;
            w[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
            if constexpr (S == 8)
                raw[j] = w[2 * j] |
                         (static_cast<unsigned long long>(w[2 * j + 1]) << 32);
            else if constexpr (S == 4)
                raw[j] = w[j];
            else if constexpr (S == 2)
                raw[j] = (w[j / 2] >> (16 * (j % 2))) & 0xffffu;
            else
                raw[j] = (w[j / 4] >> (8 * (j % 4))) & 0xffu;
        }
    } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
            raw[j] = 0;
            if (j < n) {
                const long long i = row0 + j;
                if constexpr (S == 8)
                    raw[j] = __ldg(static_cast<const unsigned long long*>(p) +
                                   i);
                else if constexpr (S == 4)
                    raw[j] = __ldg(static_cast<const unsigned*>(p) + i);
                else if constexpr (S == 2)
                    raw[j] = __ldg(static_cast<const unsigned short*>(p) + i);
                else
                    raw[j] = __ldg(static_cast<const unsigned char*>(p) + i);
            }
        }
    }
}

// bit j set where byte j of the word is nonzero (j < 4): the high bit of
// each byte after (low 7 bits + 0x7f) | byte, gathered by one multiply
__device__ __forceinline__ unsigned nonzero_nibble(unsigned x) {
    const unsigned hi = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
    return ((hi >> 7) * 0x10204080u) >> 28;
}

// validity bits of the tile (bit j: row row0 + j is valid); no mask: all
__device__ __forceinline__ unsigned load_valid(const unsigned char* v,
                                               bool vec, long long row0,
                                               int n) {
    if (v == nullptr) return kAll;
    if (vec) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(v + row0));
        return nonzero_nibble(x.x) | nonzero_nibble(x.y) << 4 |
               nonzero_nibble(x.z) << 8 | nonzero_nibble(x.w) << 12;
    }
    unsigned b = 0;
#pragma unroll
    for (int j = 0; j < R; ++j)
        if (j < n) b |= (__ldg(v + row0 + j) != 0 ? 1u : 0u) << j;
    return b;
}

// the narrow int lane: R codes of a tag of at most 4 bytes (int8, uint8,
// int16, int32) widened to int32
__device__ __forceinline__ void load_ints32(const void* p, int tag, bool vec,
                                            long long row0, int n,
                                            int (&x)[R]) {
    unsigned long long raw[R];
    switch (tag) {
    case TAG_I8:
        load_tile<1>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            x[j] = static_cast<signed char>(static_cast<unsigned char>(raw[j]));
        break;
    case TAG_U8:
        load_tile<1>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j) x[j] = static_cast<int>(raw[j]);
        break;
    case TAG_I16:
        load_tile<2>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            x[j] = static_cast<short>(static_cast<unsigned short>(raw[j]));
        break;
    default:   // TAG_I32
        load_tile<4>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            x[j] = static_cast<int>(static_cast<unsigned>(raw[j]));
        break;
    }
}

__device__ __forceinline__ bool narrow_tag(int tag) {
    return tag == TAG_I8 || tag == TAG_U8 || tag == TAG_I16 ||
           tag == TAG_I32;
}

// the int lane: R codes widened to int64 (the switch on the tag is taken
// once a tile)
__device__ __forceinline__ void load_ints(const void* p, int tag, bool vec,
                                          long long row0, int n,
                                          long long (&t)[R]) {
    unsigned long long raw[R];
    switch (tag) {
    case TAG_I8:
        load_tile<1>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = static_cast<signed char>(static_cast<unsigned char>(raw[j]));
        break;
    case TAG_U8:
        load_tile<1>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j) t[j] = static_cast<long long>(raw[j]);
        break;
    case TAG_I16:
        load_tile<2>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = static_cast<short>(static_cast<unsigned short>(raw[j]));
        break;
    case TAG_I32:
        load_tile<4>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = static_cast<int>(static_cast<unsigned>(raw[j]));
        break;
    case TAG_F32:
        load_tile<4>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = static_cast<long long>(
                __uint_as_float(static_cast<unsigned>(raw[j])));
        break;
    case TAG_F64:
        load_tile<8>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = static_cast<long long>(
                dval(static_cast<long long>(raw[j])));
        break;
    default:   // TAG_I64
        load_tile<8>(p, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j) t[j] = static_cast<long long>(raw[j]);
        break;
    }
}

// the float lane: R decoded doubles (as bits in t), divided by 10^scale
__device__ __forceinline__ void load_floats(const ColInfo& c, bool full,
                                            bool tbl_sh, long long row0,
                                            int n, long long (&t)[R]) {
    const bool vec = full && c.vec;
    if (c.fmode == FM_ID && c.tag == TAG_F64) {
        unsigned long long raw[R];
        load_tile<8>(c.data, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j) t[j] = static_cast<long long>(raw[j]);
    } else if (c.fmode == FM_ID && c.tag == TAG_F32) {
        unsigned long long raw[R];
        load_tile<4>(c.data, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = dbits(static_cast<double>(
                __uint_as_float(static_cast<unsigned>(raw[j]))));
    } else {
        load_ints(c.data, c.tag, vec, row0, n, t);
        if (c.fmode == FM_FOR) {
            const unsigned long long base =
                static_cast<unsigned long long>(c.base);
#pragma unroll
            for (int j = 0; j < R; ++j)   // int64 wrap, like astype + add
                t[j] = dbits(static_cast<double>(static_cast<long long>(
                    static_cast<unsigned long long>(t[j]) + base)));
        } else if (c.fmode == FM_DICT) {
            const long long hi = c.tbl_len - 1;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                long long x = t[j];
                x = x < 0 ? 0 : x;
                x = x > hi ? hi : x;
                long long v = 0;
                if (hi >= 0) v = tbl_sh ? c.tbl[x] : __ldg(c.tbl + x);
                t[j] = dbits(static_cast<double>(v));
            }
        } else {
#pragma unroll
            for (int j = 0; j < R; ++j)
                t[j] = dbits(static_cast<double>(t[j]));
        }
    }
    if (c.sdiv != 1.0) {
#pragma unroll
        for (int j = 0; j < R; ++j) t[j] = dbits(__ddiv_rn(dval(t[j]), c.sdiv));
    }
}

// bits of an int-lane entry over the tile
__device__ __forceinline__ unsigned int_bits(int op, const long long* en,
                                             const long long (&t)[R],
                                             const long long* iv,
                                             bool iv_sh) {
    const long long A = en[2];
    const long long B = en[3];
    unsigned c = 0;
    switch (op) {
    case OP_IEQ:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (t[j] == A ? 1u : 0u) << j;
        break;
    case OP_INE:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (t[j] != A ? 1u : 0u) << j;
        break;
    case OP_ILE:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (t[j] <= A ? 1u : 0u) << j;
        break;
    case OP_IGE:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (t[j] >= A ? 1u : 0u) << j;
        break;
    case OP_IRANGE:
    case OP_NRANGE:
#pragma unroll
        for (int j = 0; j < R; ++j)
            c |= (t[j] >= A && t[j] <= B ? 1u : 0u) << j;
        if (op == OP_NRANGE) c = ~c & kAll;
        break;
    default: {   // OP_IIN, OP_INOTIN: each list value once a tile
        const long long* lst = iv + en[6];
        const long long len = en[7];
        for (long long k = 0; k < len; ++k) {
            const long long v = iv_sh ? lst[k] : __ldg(lst + k);
#pragma unroll
            for (int j = 0; j < R; ++j) c |= (t[j] == v ? 1u : 0u) << j;
        }
        if (op == OP_INOTIN) c = ~c & kAll;
    }
    }
    return c;
}

// bits of an int-lane entry over a narrow tile: the same answers as
// int_bits, with the int64 thresholds taken into int32 first (a threshold
// past either end of int32 decides the whole tile)
__device__ __forceinline__ unsigned int_bits32(int op, const long long* en,
                                               const int (&x)[R],
                                               const long long* iv,
                                               bool iv_sh) {
    constexpr long long kMin = -2147483648LL;
    constexpr long long kMax = 2147483647LL;
    const long long A = en[2];
    const long long B = en[3];
    const int a = static_cast<int>(A < kMin ? kMin : (A > kMax ? kMax : A));
    const int b = static_cast<int>(B < kMin ? kMin : (B > kMax ? kMax : B));
    unsigned c = 0;
    switch (op) {
    case OP_IEQ:
    case OP_INE:
        if (a == A) {
#pragma unroll
            for (int j = 0; j < R; ++j) c |= (x[j] == a ? 1u : 0u) << j;
        }
        if (op == OP_INE) c = ~c & kAll;
        break;
    case OP_ILE:
        if (A >= kMin) {
#pragma unroll
            for (int j = 0; j < R; ++j) c |= (x[j] <= a ? 1u : 0u) << j;
        }
        break;
    case OP_IGE:
        if (A <= kMax) {
#pragma unroll
            for (int j = 0; j < R; ++j) c |= (x[j] >= a ? 1u : 0u) << j;
        }
        break;
    case OP_IRANGE:
    case OP_NRANGE:
        if (A <= kMax && B >= kMin) {
#pragma unroll
            for (int j = 0; j < R; ++j)
                c |= (x[j] >= a && x[j] <= b ? 1u : 0u) << j;
        }
        if (op == OP_NRANGE) c = ~c & kAll;
        break;
    default: {   // OP_IIN, OP_INOTIN: a value past int32 matches no row
        const long long* lst = iv + en[6];
        const long long len = en[7];
        for (long long k = 0; k < len; ++k) {
            const long long v = iv_sh ? lst[k] : __ldg(lst + k);
            if (v < kMin || v > kMax) continue;
#pragma unroll
            for (int j = 0; j < R; ++j)
                c |= (x[j] == static_cast<int>(v) ? 1u : 0u) << j;
        }
        if (op == OP_INOTIN) c = ~c & kAll;
    }
    }
    return c;
}

// bits of a float-lane entry over the tile (t holds doubles as bits)
__device__ __forceinline__ unsigned flt_bits(int op, const long long* en,
                                             const long long (&t)[R],
                                             const long long* fv,
                                             bool fv_sh) {
    const double L = dval(en[4]);
    const double H = dval(en[5]);
    unsigned c = 0;
    switch (op) {
    case OP_FEQ:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (dval(t[j]) == L ? 1u : 0u) << j;
        break;
    case OP_FNE:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (dval(t[j]) != L ? 1u : 0u) << j;
        break;
    case OP_FLT:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (dval(t[j]) < L ? 1u : 0u) << j;
        break;
    case OP_FLE:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (dval(t[j]) <= L ? 1u : 0u) << j;
        break;
    case OP_FGT:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (dval(t[j]) > L ? 1u : 0u) << j;
        break;
    case OP_FGE:
#pragma unroll
        for (int j = 0; j < R; ++j) c |= (dval(t[j]) >= L ? 1u : 0u) << j;
        break;
    case OP_FRANGE:
    case OP_FNRANGE:
#pragma unroll
        for (int j = 0; j < R; ++j)
            c |= (dval(t[j]) >= L && dval(t[j]) <= H ? 1u : 0u) << j;
        if (op == OP_FNRANGE) c = ~c & kAll;
        break;
    default: {   // OP_FIN, OP_FNOTIN
        const long long* lst = fv + en[6];
        const long long len = en[7];
        for (long long k = 0; k < len; ++k) {
            const double v = dval(fv_sh ? lst[k] : __ldg(lst + k));
#pragma unroll
            for (int j = 0; j < R; ++j) c |= (dval(t[j]) == v ? 1u : 0u) << j;
        }
        if (op == OP_FNOTIN) c = ~c & kAll;
    }
    }
    return c;
}

// a key tile as the hash reads it: the value widened to int64, a float's
// bit pattern (float32 sign-extended through int32)
__device__ __forceinline__ void load_key_bits(const KeyInfo& k, bool full,
                                              long long row0, int n,
                                              long long (&t)[R]) {
    const bool vec = full && k.vec;
    if (k.tag == TAG_F64) {
        unsigned long long raw[R];
        load_tile<8>(k.data, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j) t[j] = static_cast<long long>(raw[j]);
    } else if (k.tag == TAG_F32) {
        unsigned long long raw[R];
        load_tile<4>(k.data, row0, n, vec, raw);
#pragma unroll
        for (int j = 0; j < R; ++j)
            t[j] = static_cast<int>(static_cast<unsigned>(raw[j]));
    } else {
        load_ints(k.data, k.tag, vec, row0, n, t);
    }
}

__device__ __forceinline__ void store_mask(unsigned char* out,
                                           long long row0, int n, bool full,
                                           unsigned m) {
    if (full) {
        unsigned w[R / 4];
#pragma unroll
        for (int k = 0; k < R / 4; ++k)   // 4 bits -> 4 bytes of 0/1
            w[k] = (((m >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u;
        *reinterpret_cast<uint4*>(out + row0) =
            make_uint4(w[0], w[1], w[2], w[3]);
    } else {
        for (int j = 0; j < n; ++j) out[row0 + j] = (m >> j) & 1u;
    }
}

__device__ __forceinline__ void store_hash(unsigned* out, long long row0,
                                           int n, bool full,
                                           const unsigned (&h)[R]) {
    if (full) {
        uint4* q = reinterpret_cast<uint4*>(out + row0);
#pragma unroll
        for (int k = 0; k < R / 4; ++k)
            q[k] = make_uint4(h[4 * k], h[4 * k + 1], h[4 * k + 2],
                              h[4 * k + 3]);
    } else {   // unrolled, so that h stays in registers
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (j < n) out[row0 + j] = h[j];
    }
}

// kFloat: the spec has float-lane entries; kHash: the launch folds the
// routing hash. A launch without them runs a kernel that carries neither
// path, with fewer registers.
template <bool kFloat, bool kHash>
__global__ void __launch_bounds__(kMaxThreads)
chunk_scan_tiles(const NdsScanArgs a) {
    extern __shared__ long long sh[];
    __shared__ ColInfo cols[NDS_SCAN_MAX_COLS];
    __shared__ KeyInfo keys[NDS_SCAN_MAX_KEYS];
    const int tid = threadIdx.x;

    // stage the spec: the prefix of whole regions that fits, once a block
    for (int w = tid; w < a.staged_words; w += blockDim.x)
        sh[w] = __ldg(a.spec + w);
    const bool tbl_sh = a.total_words <= a.staged_words;
    const long long* tbl = (tbl_sh ? sh : a.spec) + a.off_tables;
    if (tid < a.ncols) {
        const long long* cw = a.spec + a.off_cols + kColWords * tid;
        ColInfo& c = cols[tid];
        c.data = a.data[tid];
        c.valid = a.valid[tid];
        c.tag = a.data_tag[tid];
        c.fmode = static_cast<int>(__ldg(cw));
        c.base = __ldg(cw + 1);
        c.sdiv = dval(__ldg(cw + 2));
        c.tbl = tbl + __ldg(cw + 3);
        c.tbl_len = __ldg(cw + 4);
        c.vec = (reinterpret_cast<uintptr_t>(c.data) & 15) == 0;
        c.vvec = (reinterpret_cast<uintptr_t>(c.valid) & 15) == 0;
    }
    if (tid < a.nkeys) {
        keys[tid].data = a.keys[tid];
        keys[tid].tag = a.key_tag[tid];
        keys[tid].vec = (reinterpret_cast<uintptr_t>(a.keys[tid]) & 15) == 0;
    }
    __syncthreads();
    const long long* ent = a.off_cols <= a.staged_words ? sh : a.spec;
    const bool iv_sh = a.off_fvals <= a.staged_words;
    const bool fv_sh = a.off_tables <= a.staged_words;
    const long long* iv = (iv_sh ? sh : a.spec) + a.off_ivals;
    const long long* fv = (fv_sh ? sh : a.spec) + a.off_fvals;

    const long long n_live = __ldg(a.n_dev);
    const long long plen = a.plen;
    const long long ntiles = (plen + R - 1) / R;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long tile = static_cast<long long>(blockIdx.x) * blockDim.x +
                          tid;
         tile < ntiles; tile += stride) {
        const long long row0 = tile * R;
        const long long left = plen - row0;
        const int n = left < R ? static_cast<int>(left) : R;
        const bool full = n == R;
        unsigned m = kAll;
        long long t[R];
        int tcol = -1, tlane = -1, vcol = -1;
        unsigned vb = kAll;
        for (int e = 0; e < a.nentries; ++e) {
            const long long* en = ent + kEntWords * e;
            const int op = static_cast<int>(en[0]);
            const int ci = static_cast<int>(en[1]);
            if (op == OP_FALSE) {
                m = 0;
                continue;
            }
            const ColInfo& c = cols[ci];
            if (vcol != ci) {
                vb = load_valid(c.valid, full && c.vvec, row0, n);
                vcol = ci;
            }
            if (op == OP_TRUE || op == OP_NOTNULL) {
                m &= vb;
                continue;
            }
            if (op == OP_ISNULL) {
                m &= ~vb;
                continue;
            }
            const bool int_lane = op <= OP_INOTIN;
            unsigned cb;
            if (int_lane && narrow_tag(c.tag)) {
                int x[R];   // narrow codes compare in 32 bits, uncached
                load_ints32(c.data, c.tag, full && c.vec, row0, n, x);
                cb = int_bits32(op, en, x, iv, iv_sh);
            } else if (int_lane) {
                if (tcol != ci || tlane != 0) {
                    load_ints(c.data, c.tag, full && c.vec, row0, n, t);
                    tcol = ci;
                    tlane = 0;
                }
                cb = int_bits(op, en, t, iv, iv_sh);
            } else if constexpr (kFloat) {
                if (tcol != ci || tlane != 1) {
                    load_floats(c, full, tbl_sh, row0, n, t);
                    tcol = ci;
                    tlane = 1;
                }
                cb = flt_bits(op, en, t, fv, fv_sh);
            } else {
                cb = 0;   // not reached: the host sets float_lane for these
            }
            m &= cb & vb;
        }
        const long long live = n_live - row0;
        if (live < R) m &= live <= 0 ? 0u : (1u << live) - 1u;
        store_mask(a.mask, row0, n, full, m);
        if constexpr (kHash) {
            unsigned h[R];
#pragma unroll
            for (int j = 0; j < R; ++j) h[j] = 2166136261u;
            for (int k = 0; k < a.nkeys; ++k) {
                load_key_bits(keys[k], full, row0, n, t);
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    const unsigned lo = static_cast<unsigned>(t[j]);
                    const unsigned hi = static_cast<unsigned>(
                        static_cast<unsigned long long>(t[j]) >> 32);
                    unsigned x = (h[j] ^ lo) * 2654435761u;
                    x ^= x >> 16;
                    x = (x ^ hi) * 2246822519u;
                    h[j] = x ^ (x >> 13);
                }
            }
            store_hash(a.hash, row0, n, full, h);
        }
    }
}

template <bool kFloat, bool kHash>
int launch_tiles(const NdsScanArgs& a, cudaStream_t s) {
    chunk_scan_tiles<kFloat, kHash><<<a.grid, a.threads, a.smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// threads, grid and smem from the host plan (kernels.py scan_plan); the
// staged spec and the static records fit the shared memory a block takes
// without opting in to more; nothing is launched for an empty chunk
int nds_chunk_scan(const NdsScanArgs* args, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const NdsScanArgs& a = *args;
    if (a.plen <= 0) return static_cast<int>(cudaGetLastError());
    if (a.grid <= 0 || a.threads <= 0 || a.threads > kMaxThreads ||
        a.smem != 8 * a.staged_words || a.staged_words > a.total_words ||
        a.smem + kStaticSmem > kSmemDefault ||
        a.ncols > NDS_SCAN_MAX_COLS || a.nkeys > NDS_SCAN_MAX_KEYS ||
        a.threads < a.ncols || a.threads < a.nkeys)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool hash = a.hash != nullptr;
    if (a.float_lane)
        return hash ? launch_tiles<true, true>(a, s)
                    : launch_tiles<true, false>(a, s);
    return hash ? launch_tiles<false, true>(a, s)
                : launch_tiles<false, false>(a, s);
}

int nds_chunk_scan_sizeof() { return static_cast<int>(sizeof(NdsScanArgs)); }

}  // extern "C"
