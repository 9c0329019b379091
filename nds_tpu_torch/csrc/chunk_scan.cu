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
// The spec is INTERPRETED, not compiled per statement: a statement's lowered
// entries (opcode, column, int64 thresholds, float64 literals, IN-list slice)
// and per-column decode metadata (FOR base, dict table slice, 10^scale
// divisor) are flattened once per pipeline into device arrays, so a chunk
// costs one launch and no host-to-device copy. The per-chunk column
// pointers and dtype tags ride the launch's parameter block by value, and
// the live row count n_dev is read from device memory.
//
// Semantics kept bit for bit with the reference's _eval_entries:
//   * a FALSE entry clears the mask whatever came before it;
//   * stored codes widen to int64 with sign extension before comparing;
//   * the float lane decodes FOR (code + base), dict (value table at the
//     code clipped into range) or identity, then divides by 10^scale with a
//     true IEEE division (this file must not be built with fast math);
//   * NaN compares as IEEE does;
//   * the hash seed is 2166136261, the multipliers 2654435761 and
//     2246822519 with the shifts 16 and 13; a float key hashes its bit
//     pattern (a float32 sign-extends through int32), split into its low and
//     high 32-bit words.
//
// What bounds it on an H100: bytes. Every referenced column is read once
// (1-8 B of code + 1 B of validity a row) and the mask (1 B) and hash (4 B)
// are written once: about 10-20 B a row, 2^22 rows a chunk, some 15-25 us
// at 3.35 TB/s. The design: one thread per row in a grid-stride loop; the
// spec arrays are the same addresses for every thread and stay in L1.
// Staging the spec in shared memory and vector loads are later work.
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

struct NdsScanArgs {
    const void* data[NDS_SCAN_MAX_COLS];
    const unsigned char* valid[NDS_SCAN_MAX_COLS];   // null: no mask
    const void* keys[NDS_SCAN_MAX_KEYS];
    int data_tag[NDS_SCAN_MAX_COLS];
    int key_tag[NDS_SCAN_MAX_KEYS];
    int ncols;
    int nentries;
    int nkeys;
    int pad_;
    const long long* ent;      // [nentries][6]: op, col, a, b, list off, len
    const double* fent;        // [nentries][2]: float literals lo, hi
    const long long* colmeta;  // [ncols][4]: fmode, base, table off, len
    const double* sdiv;        // [ncols]: 10^scale divisor
    const long long* ivals;    // int IN-list values
    const double* fvals;       // float IN-list values
    const long long* tables;   // sorted dict value tables, concatenated
    const long long* n_dev;    // live rows of the chunk (device scalar)
    long long plen;
    unsigned char* mask;       // [plen] bool
    unsigned int* hash;        // [plen] uint32, or null: no hash
};

namespace {

constexpr int kThreads = 256;

int grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 132LL * 64;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

// value of row i widened to int64 with sign extension (float bits for the
// float tags: only the hash asks for those)
__device__ __forceinline__ long long load_i64(const void* p, int tag,
                                              long long i) {
    switch (tag) {
    case TAG_I8: return (long long)((const int8_t*)p)[i];
    case TAG_I16: return (long long)((const int16_t*)p)[i];
    case TAG_I32: return (long long)((const int32_t*)p)[i];
    case TAG_U8: return (long long)((const uint8_t*)p)[i];
    case TAG_F32:
        return (long long)(int32_t)__float_as_int(((const float*)p)[i]);
    case TAG_F64:
        return __double_as_longlong(((const double*)p)[i]);
    default: return ((const long long*)p)[i];
    }
}

__device__ __forceinline__ double load_f64(const void* p, int tag,
                                           long long i) {
    switch (tag) {
    case TAG_F64: return ((const double*)p)[i];
    case TAG_F32: return (double)((const float*)p)[i];
    default: return (double)load_i64(p, tag, i);
    }
}

__global__ void chunk_scan_kernel(const NdsScanArgs a) {
    const long long n_live = *a.n_dev;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < a.plen; i += stride) {
        bool m = true;
        for (int e = 0; e < a.nentries; ++e) {
            const long long* en = a.ent + 6 * e;
            const int op = (int)en[0];
            const int ci = (int)en[1];
            const bool v = a.valid[ci] == nullptr ? true
                                                  : a.valid[ci][i] != 0;
            if (op == OP_FALSE) { m = false; continue; }
            if (op == OP_TRUE || op == OP_NOTNULL) { m = m && v; continue; }
            if (op == OP_ISNULL) { m = m && !v; continue; }
            bool c;
            if (op <= OP_INOTIN) {
                const long long x = load_i64(a.data[ci], a.data_tag[ci], i);
                switch (op) {
                case OP_IEQ: c = x == en[2]; break;
                case OP_INE: c = x != en[2]; break;
                case OP_ILE: c = x <= en[2]; break;
                case OP_IGE: c = x >= en[2]; break;
                case OP_IRANGE: c = x >= en[2] && x <= en[3]; break;
                case OP_NRANGE: c = !(x >= en[2] && x <= en[3]); break;
                case OP_IIN:
                    c = false;
                    for (long long k = 0; k < en[5]; ++k)
                        c = c || x == a.ivals[en[4] + k];
                    break;
                default:   // OP_INOTIN
                    c = true;
                    for (long long k = 0; k < en[5]; ++k)
                        c = c && x != a.ivals[en[4] + k];
                    break;
                }
            } else {
                const long long* cm = a.colmeta + 4 * ci;
                double val;
                if (cm[0] == FM_FOR) {
                    const long long x =
                        load_i64(a.data[ci], a.data_tag[ci], i);
                    // int64 wrap like the reference's astype + add
                    val = (double)(long long)((unsigned long long)x +
                                              (unsigned long long)cm[1]);
                } else if (cm[0] == FM_DICT) {
                    long long x = load_i64(a.data[ci], a.data_tag[ci], i);
                    if (x < 0) x = 0;
                    if (x > cm[3] - 1) x = cm[3] - 1;
                    val = (double)a.tables[cm[2] + x];
                } else {
                    val = load_f64(a.data[ci], a.data_tag[ci], i);
                }
                const double sd = a.sdiv[ci];
                if (sd != 1.0) val = __ddiv_rn(val, sd);
                const double* fe = a.fent + 2 * e;
                switch (op) {
                case OP_FEQ: c = val == fe[0]; break;
                case OP_FNE: c = val != fe[0]; break;
                case OP_FLT: c = val < fe[0]; break;
                case OP_FLE: c = val <= fe[0]; break;
                case OP_FGT: c = val > fe[0]; break;
                case OP_FGE: c = val >= fe[0]; break;
                case OP_FRANGE: c = val >= fe[0] && val <= fe[1]; break;
                case OP_FNRANGE: c = !(val >= fe[0] && val <= fe[1]); break;
                default: {   // OP_FIN, OP_FNOTIN
                    bool hit = false;
                    for (long long k = 0; k < en[5]; ++k)
                        hit = hit || val == a.fvals[en[4] + k];
                    c = op == OP_FIN ? hit : !hit;
                }
                }
            }
            m = m && c && v;
        }
        a.mask[i] = (m && i < n_live) ? 1 : 0;
        if (a.hash != nullptr) {
            unsigned int h = 2166136261u;
            for (int k = 0; k < a.nkeys; ++k) {
                const long long x = load_i64(a.keys[k], a.key_tag[k], i);
                const unsigned int lo = (unsigned int)(x & 0xffffffffLL);
                const unsigned int hi =
                    (unsigned int)((x >> 32) & 0xffffffffLL);
                h = (h ^ lo) * 2654435761u;
                h = h ^ (h >> 16);
                h = (h ^ hi) * 2246822519u;
                h = h ^ (h >> 13);
            }
            a.hash[i] = h;
        }
    }
}

}  // namespace

extern "C" {

int nds_chunk_scan(const NdsScanArgs* args, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (args->plen > 0)
        chunk_scan_kernel<<<grid_for(args->plen), kThreads, 0, s>>>(*args);
    return (int)cudaGetLastError();
}

int nds_chunk_scan_sizeof() { return (int)sizeof(NdsScanArgs); }

}  // extern "C"
