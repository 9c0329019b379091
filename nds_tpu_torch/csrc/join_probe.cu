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
// exclusion bytes are read once and 16 B written (26 B a row with one int64
// key), plus each build row's 8 B once. The search is what costs: two full
// binary searches over r take about 2 log2(r) dependent L2 loads a row (34
// at r = 102,000), and a table of 816 KB does not fit a block's 227 KB of
// shared memory. So the search is cut short by a radix directory instead:
//
//   directory  dir[0 .. 2^B] (int32): dir[b] is the first position whose
//              hash has top-B-bits bucket >= b (the hash unflipped, as
//              unsigned). B = ceil(log2 r) clamped to [10, 20] (kernels.py
//              probe_bits), so a bucket holds about one entry and the
//              directory (4 MB at most) stays in L2. One launch builds it
//              from rh_sorted on every call: entry t fills the buckets
//              between its predecessor's and its own (a gap of 32 or more,
//              which a sparse table among many sentinels leaves, by its
//              whole block), and bucket b itself fills the head (b <= the
//              first entry's bucket) and the tail (b > the last entry's).
//   probe      each row loads dir[b] and dir[b + 1] for its hash's bucket b,
//              binary-searches that range for the lower bound, then gallops
//              forward from it for the upper bound (both bounds lie inside
//              the bucket: an equal hash has the same bucket). About four
//              dependent loads a row.
//
// Build-side sentinels (null, excluded or pad build rows) sit in the lowest
// buckets; a crowded bucket costs a longer search, never a wrong bound.
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
    int* dir;                        // 2^bits + 1 entries of scratch
    int bits;
    int pad2_;
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

// the directory bucket of a bit-63-flipped hash: its unsigned top bits
__device__ __forceinline__ long long bucket_of(long long key, int bits) {
    return (long long)(((unsigned long long)key ^ kSignBit) >> (64 - bits));
}

__global__ void probe_directory_kernel(const long long* __restrict__ rh,
                                       long long r, int bits,
                                       int* __restrict__ dir) {
    // the wide gaps of this block's entries, filled by the whole block
    __shared__ long long wide_lo[kThreads], wide_hi[kThreads];
    __shared__ int wide_pos[kThreads];
    __shared__ int n_wide;
    const long long nb = 1LL << bits;
    const long long first = r > 0 ? bucket_of(rh[0], bits) : nb;
    const long long last = r > 0 ? bucket_of(rh[r - 1], bits) : -1;
    const long long total = r > nb + 1 ? r : nb + 1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    // the loop bound is the same for every thread of a block, so all take
    // part in the barriers below
    for (long long base = (long long)blockIdx.x * blockDim.x; base < total;
         base += stride) {
        const long long t = base + threadIdx.x;
        if (threadIdx.x == 0) n_wide = 0;
        __syncthreads();
        if (t <= nb) {
            if (t <= first) dir[t] = 0;              // head
            else if (t > last) dir[t] = (int)r;      // tail
        }
        if (t >= 1 && t < r) {
            // entry t fills the buckets after entry t - 1's, up to its own
            const long long b0 = bucket_of(rh[t - 1], bits) + 1;
            const long long b1 = bucket_of(rh[t], bits);
            if (b1 - b0 < 32) {
                for (long long b = b0; b <= b1; ++b) dir[b] = (int)t;
            } else {
                // a wide gap (a sparse table among many sentinels, whose
                // few real entries sit side by side once sorted)
                const int k = atomicAdd(&n_wide, 1);
                wide_lo[k] = b0;
                wide_hi[k] = b1;
                wide_pos[k] = (int)t;
            }
        }
        __syncthreads();
        for (int k = 0; k < n_wide; ++k)
            for (long long b = wide_lo[k] + threadIdx.x; b <= wide_hi[k];
                 b += blockDim.x)
                dir[b] = wide_pos[k];
        __syncthreads();
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
        const long long* __restrict__ rh = a.rh_sorted;
        const long long bk = bucket_of(key, a.bits);
        const long long end = a.dir[bk + 1];
        // lower bound inside the bucket: first position whose value >= key
        long long b = a.dir[bk], e = end;
        while (b < e) {
            const long long mid = b + ((e - b) >> 1);
            if (rh[mid] < key) b = mid + 1; else e = mid;
        }
        const long long lo = b;
        // upper bound: gallop from lo (lo, lo+1, lo+2, lo+4, ...) to the
        // first value > key, then bisect the last step; every position
        // before b holds a value <= key
        e = end;
        for (long long p = lo, step = 1; p < end; p = lo + step, step <<= 1) {
            if (rh[p] > key) { e = p; break; }
            b = p + 1;
        }
        while (b < e) {
            const long long mid = b + ((e - b) >> 1);
            if (rh[mid] <= key) b = mid + 1; else e = mid;
        }
        a.counts[i] = b - lo;
        a.lo[i] = lo;
    }
}

}  // namespace

extern "C" {

int nds_join_probe(const NdsProbeArgs* args, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (args->n <= 0) return (int)cudaGetLastError();
    if (args->bits < 1 || args->bits > 30 || args->r < 0 ||
        args->r > 0x7FFFFFFFLL || args->dir == nullptr)
        return (int)cudaErrorInvalidValue;
    const long long nb = 1LL << args->bits;
    probe_directory_kernel<<<grid_for(args->r > nb + 1 ? args->r : nb + 1),
                             kThreads, 0, s>>>(args->rh_sorted, args->r,
                                               args->bits, args->dir);
    join_probe_kernel<<<grid_for(args->n), kThreads, 0, s>>>(*args);
    return (int)cudaGetLastError();
}

int nds_join_probe_sizeof() { return (int)sizeof(NdsProbeArgs); }

}  // extern "C"
