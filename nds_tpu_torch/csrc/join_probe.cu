// Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
//
// Bound-bucket join probe for Hopper (sm_90a): K5, the port of the Pallas
// kernel nds_tpu/engine/kernels.py fused_probe (body: _probe_hash_tile and
// both searchsorted sides). Per probe row it computes
//
//   h        = the 64-bit key hash of ops._key_hash_impl with side salt 0:
//              start 0x243F6A8885A308D3, per key mix64(h ^ null marker)
//              then mix64(h ^ key * C1); a row with a null key, a pad row
//              (row >= n_valid) or an excluded row takes the unmatchable
//              sentinel 2 + (row << 3), every other row h | 4
//   lo, hi   = lower and upper bound of h in the sorted build-side hash
//              table rh_sorted
//   counts   = hi - lo (int64), lo (int64)
//
// Order: the port keeps 64-bit hashes in int64 tensors and sorts them in
// UNSIGNED order by flipping bit 63 and sorting signed (ops.unsigned_order).
// rh_sorted holds those flipped values, so the kernel flips its own hash the
// same way and compares signed int64 — exactly the order the table was
// sorted in.
//
// What bounds it on an H100: per probe row the key views, validity and
// exclusion bytes are read once and 16 B written, plus about 2 log2(r)
// dependent loads from the build table; for r up to a few hundred thousand
// rows the table stays in the 50 MB L2, so the loads cost latency, not
// device-memory bytes. The design: one thread per probe row in a
// grid-stride loop, binary search in global memory. The reference's 2^15-row
// VMEM gate does not carry over: the kernel takes any r. Staging the table
// in shared memory (227 KB a block) is later work.
//
// Plain C interface, like chunk_scan.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#define NDS_PROBE_MAX_KEYS 8

enum { TAG_I8 = 1, TAG_I16 = 2, TAG_I32 = 3, TAG_I64 = 4, TAG_U8 = 7 };

struct NdsProbeArgs {
    const void* views[NDS_PROBE_MAX_KEYS];
    const unsigned char* valid[NDS_PROBE_MAX_KEYS];   // null: no mask
    int view_tag[NDS_PROBE_MAX_KEYS];
    int nkeys;
    int pad_;
    const unsigned char* excluded;   // null: nothing excluded
    const long long* n_valid_ptr;    // device scalar, or null ...
    long long n_valid_host;          // ... then this host value
    const long long* rh_sorted;      // bit-63-flipped, ascending signed
    long long r;
    long long n;
    long long* counts;
    long long* lo;
};

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kC1 = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kC2 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kC3 = 0x94D049BB133111EBULL;
constexpr unsigned long long kSeed = 0x243F6A8885A308D3ULL;
constexpr unsigned long long kNullMark = 0xA5A5A5A5A5A5A5A5ULL;
constexpr unsigned long long kSignBit = 0x8000000000000000ULL;

int grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 132LL * 64;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
    x = (x ^ (x >> 30)) * kC2;
    x = (x ^ (x >> 27)) * kC3;
    return x ^ (x >> 31);
}

__device__ __forceinline__ long long load_i64(const void* p, int tag,
                                              long long i) {
    switch (tag) {
    case TAG_I8: return (long long)((const int8_t*)p)[i];
    case TAG_I16: return (long long)((const int16_t*)p)[i];
    case TAG_I32: return (long long)((const int32_t*)p)[i];
    case TAG_U8: return (long long)((const uint8_t*)p)[i];
    default: return ((const long long*)p)[i];
    }
}

__global__ void join_probe_kernel(const NdsProbeArgs a) {
    const long long n_valid =
        a.n_valid_ptr != nullptr ? *a.n_valid_ptr : a.n_valid_host;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < a.n; i += stride) {
        unsigned long long h = kSeed;
        bool any_null = false;
        for (int k = 0; k < a.nkeys; ++k) {
            unsigned long long w =
                (unsigned long long)load_i64(a.views[k], a.view_tag[k], i);
            unsigned long long marker = 0ULL;
            if (a.valid[k] != nullptr && a.valid[k][i] == 0) {
                w = 0ULL;
                marker = kNullMark;
                any_null = true;
            }
            h = mix64(h ^ marker);
            h = mix64(h ^ (w * kC1));
        }
        const bool unmatchable =
            any_null || i >= n_valid ||
            (a.excluded != nullptr && a.excluded[i] != 0);
        const unsigned long long u =
            unmatchable ? 2ULL + ((unsigned long long)i << 3) : (h | 4ULL);
        const long long key = (long long)(u ^ kSignBit);
        // lower bound: first position whose value is >= key
        long long b = 0, e = a.r;
        while (b < e) {
            const long long mid = b + ((e - b) >> 1);
            if (a.rh_sorted[mid] < key) b = mid + 1; else e = mid;
        }
        const long long lo = b;
        // upper bound: first position whose value is > key
        e = a.r;
        while (b < e) {
            const long long mid = b + ((e - b) >> 1);
            if (a.rh_sorted[mid] <= key) b = mid + 1; else e = mid;
        }
        a.counts[i] = b - lo;
        a.lo[i] = lo;
    }
}

}  // namespace

extern "C" {

int nds_join_probe(const NdsProbeArgs* args, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (args->n > 0)
        join_probe_kernel<<<grid_for(args->n), kThreads, 0, s>>>(*args);
    return (int)cudaGetLastError();
}

int nds_join_probe_sizeof() { return (int)sizeof(NdsProbeArgs); }

}  // extern "C"
