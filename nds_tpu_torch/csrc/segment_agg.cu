// Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
//
// Grouped aggregation kernels for Hopper (sm_90a): the port of the three
// Pallas kernels that every GROUP BY of the device-resident path ends in.
//
//   seg_sum_i64      replaces nds_tpu/engine/kernels.py _segment_sum_exact_pallas
//                    (body _seg_exact_kernel): per group, the exact int64 SUM
//                    with two's-complement wrap, and the row count.
//   seg_sum_f64      replaces _segment_sum_pallas (body _seg_kernel): per
//                    group, the float64 sum of the values (optional) and the
//                    int64 count of rows.
//   seg_minmax_f64   replaces _segment_minmax_pallas (body
//                    _seg_minmax_kernel): per group, the float64 min and max.
//
// A row takes part when 0 <= gid < G; every other row (gid -1 for a null or
// filtered row, gid >= G for a pad row) is dropped.
//
// What bounds them on an H100: each row is read once (8 B of value + 8 B of
// group id), so the floor is n * 16 B over device-memory bandwidth
// (3.35 TB/s: about 14 us at the 2.88 M rows of SF1 store_sales). What holds
// a kernel above it is atomic contention: one global atomic per row on G
// addresses serialises when few groups take many rows (at G = 1 every row
// lands on one address in L2). The TPU kernels' one-hot matmul, f32 limbs
// and group-count gates were limits of the matrix unit and do not carry over.
//
// seg_sum_i64 has two hand-written paths; the host picks one by a fixed rule
// on G (nds_tpu_torch/engine/kernels.py segment_plan):
//   private (G <= 14,528, as many groups as 227 KB of shared memory holds at
//           16 B a group)  a persistent grid of two blocks an SM; each block
//           keeps every group's sum and count in dynamic shared memory and
//           reads its rows two at a time with 16-byte loads. At G = 1 each
//           thread sums in registers and a warp shuffle reduces at the end;
//           at G > 1 each in-range row adds itself to its group with native
//           32-bit shared atomics (a 64-bit shared atomicAdd is a CAS loop
//           on sm_90; the low half's old value gives the carry). Each block
//           then adds its non-empty groups to global memory: blocks x G
//           global atomics in all, against n for a row-per-atomic kernel.
//   global  (G > 14,528)  one thread per row, two global atomics a row.
// The sweep behind the rule (chip_smoke.py k1_sweep; PERF.md section 6):
// the private path beat the global one at every G up to the cap, two
// blocks an SM were within a few per cent of the best count at every G, and
// a variant that first summed a warp's rows of one group (__match_any_sync
// and a shuffle tree) was no faster than the direct shared atomics at any G
// from 2 up (a tie at G = 2, slower above).
// seg_sum_f64 and seg_minmax_f64 keep the one-thread-per-row global-atomic
// design.
//
// Exactness: 64-bit integer atomics wrap mod 2^64 and commute, so seg_sum_i64
// is bit-exact whatever the order. Float64 atomics add in no fixed order, so
// seg_sum_f64 sums agree with a sequential sum to rounding only. Min and max
// run on an order-preserving int64 key of the double (IEEE total order with
// -0.0 < +0.0; any NaN wins and yields NaN), so they are exact and
// independent of order.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): pointers and the stream are passed as void*, every function
// enqueues on the given stream, allocates nothing and returns the
// cudaGetLastError() code of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kKeyNan = (long long)0x8000000000000000ULL;   // min side
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;

int grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    // enough blocks to fill 132 SMs many times over; the grid-stride loop
    // covers the rest
    const long long cap = 132LL * 64;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

__global__ void seg_sum_i64_kernel(const long long* __restrict__ vals,
                                   const long long* __restrict__ gids,
                                   long long n, long long G,
                                   unsigned long long* __restrict__ sums,
                                   unsigned long long* __restrict__ counts) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const long long g = gids[i];
        if (g >= 0 && g < G) {
            atomicAdd(&sums[g], (unsigned long long)vals[i]);
            atomicAdd(&counts[g], 1ULL);
        }
    }
}

constexpr int kPrivThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Adds x to a 64-bit shared-memory word with native 32-bit shared atomics
// (sm_90 has no native 64-bit shared add: atomicAdd on a 64-bit shared word
// compiles to a compare-and-swap loop). The old low half says whether the
// add carried into the high half; the sum stays exact mod 2^64.
__device__ __forceinline__ void shared_add64(unsigned long long* w,
                                             unsigned long long x) {
    unsigned* half = reinterpret_cast<unsigned*>(w);   // [0] low, [1] high
    const unsigned lo = (unsigned)x;
    unsigned hi = (unsigned)(x >> 32);
    if (lo != 0u) {
        const unsigned old = atomicAdd(half, lo);
        hi += (old + lo < old) ? 1u : 0u;
    }
    if (hi != 0u) atomicAdd(half + 1, hi);
}

// One row into the block's partials. kOne (G == 1): summed in the thread's
// registers. Otherwise an in-range row adds itself to the group's shared
// sum and count.
template <bool kOne>
__device__ __forceinline__ void add_row(long long g, long long v, int G,
                                        unsigned long long* ssum,
                                        unsigned long long* scnt,
                                        unsigned long long& acc_s,
                                        unsigned long long& acc_c) {
    if (kOne) {
        if (g == 0) {
            acc_s += (unsigned long long)v;
            acc_c += 1ULL;
        }
    } else if (g >= 0 && g < G) {
        shared_add64(&ssum[g], (unsigned long long)v);
        shared_add64(&scnt[g], 1ULL);
    }
}

template <bool kOne, bool kVec>
__global__ void __launch_bounds__(kPrivThreads)
seg_sum_i64_priv_kernel(const long long* __restrict__ vals,
                        const long long* __restrict__ gids, long long n,
                        int G, unsigned long long* __restrict__ sums,
                        unsigned long long* __restrict__ counts) {
    extern __shared__ unsigned long long smem[];    // G sums, then G counts
    unsigned long long* ssum = smem;
    unsigned long long* scnt = smem + G;
    for (int g = threadIdx.x; g < 2 * G; g += blockDim.x) smem[g] = 0ULL;
    __syncthreads();
    unsigned long long acc_s = 0ULL, acc_c = 0ULL;
    // kVec: a unit is a pair of rows, read with one 16-byte load per array
    const long long units = kVec ? n >> 1 : n;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < units; u += stride) {
        if (kVec) {
            const longlong2 gg =
                __ldg(reinterpret_cast<const longlong2*>(gids) + u);
            const longlong2 vv =
                __ldg(reinterpret_cast<const longlong2*>(vals) + u);
            add_row<kOne>(gg.x, vv.x, G, ssum, scnt, acc_s, acc_c);
            add_row<kOne>(gg.y, vv.y, G, ssum, scnt, acc_s, acc_c);
        } else {
            add_row<kOne>(__ldg(gids + u), __ldg(vals + u), G, ssum, scnt,
                          acc_s, acc_c);
        }
    }
    if (kVec && (n & 1) && blockIdx.x == 0 && threadIdx.x == 0)
        add_row<kOne>(gids[n - 1], vals[n - 1], G, ssum, scnt, acc_s, acc_c);
    if (kOne) {
        // each warp's partials, by shuffle, into the block's one group
        for (int off = 16; off > 0; off >>= 1) {
            acc_s += __shfl_xor_sync(kFull, acc_s, off);
            acc_c += __shfl_xor_sync(kFull, acc_c, off);
        }
        if ((threadIdx.x & 31) == 0 && acc_c != 0ULL) {
            shared_add64(&ssum[0], acc_s);
            shared_add64(&scnt[0], acc_c);
        }
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        const unsigned long long c = scnt[g];
        if (c != 0ULL) {
            atomicAdd(&sums[g], ssum[g]);
            atomicAdd(&counts[g], c);
        }
    }
}

template <bool kOne, bool kVec>
int launch_priv(const long long* vals, const long long* gids, long long n,
                int G, unsigned long long* sums, unsigned long long* counts,
                int grid, int smem, cudaStream_t s) {
    // above 48 KB a block must ask for its dynamic shared memory; the
    // largest size asked for so far is kept per instance
    static int granted = 48 * 1024;
    if (smem > granted) {
        const cudaError_t e = cudaFuncSetAttribute(
            seg_sum_i64_priv_kernel<kOne, kVec>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        granted = smem;
    }
    seg_sum_i64_priv_kernel<kOne, kVec><<<grid, kPrivThreads, smem, s>>>(
        vals, gids, n, G, sums, counts);
    return (int)cudaGetLastError();
}

template <bool kOne>
int launch_priv_aligned(const void* vals, const void* gids, long long n,
                        int G, unsigned long long* sums,
                        unsigned long long* counts, int grid, int smem,
                        cudaStream_t s) {
    // 16-byte loads where both arrays allow them, 8-byte ones otherwise
    const bool vec = ((((uintptr_t)vals) | ((uintptr_t)gids)) & 15u) == 0;
    const long long* v = (const long long*)vals;
    const long long* g = (const long long*)gids;
    return vec ? launch_priv<kOne, true>(v, g, n, G, sums, counts, grid,
                                         smem, s)
               : launch_priv<kOne, false>(v, g, n, G, sums, counts, grid,
                                          smem, s);
}

__global__ void seg_sum_f64_kernel(const double* __restrict__ vals,
                                   const long long* __restrict__ gids,
                                   long long n, long long G,
                                   double* __restrict__ sums,
                                   unsigned long long* __restrict__ counts) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const long long g = gids[i];
        if (g >= 0 && g < G) {
            if (vals != nullptr) atomicAdd(&sums[g], vals[i]);
            atomicAdd(&counts[g], 1ULL);
        }
    }
}

// order-preserving int64 key of a non-NaN double: -inf < ... < -0.0 < +0.0
// < ... < +inf map to increasing keys strictly inside (INT64_MIN, INT64_MAX)
__device__ __forceinline__ long long f64_key(double x) {
    const long long b = __double_as_longlong(x);
    return b >= 0 ? b : (b ^ kKeyMax);
}

__device__ __forceinline__ double key_f64(long long k) {
    const long long b = k >= 0 ? k : (k ^ kKeyMax);
    return __longlong_as_double(b);
}

__global__ void seg_minmax_init_kernel(long long* __restrict__ kmin,
                                       long long* __restrict__ kmax,
                                       long long G) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < G; g += stride) {
        kmin[g] = kKeyMax;          // empty group: +inf after decoding
        kmax[g] = kKeyNan;          // empty group: -inf after decoding
    }
}

__global__ void seg_minmax_kernel(const double* __restrict__ vals,
                                  const long long* __restrict__ gids,
                                  long long n, long long G,
                                  long long* __restrict__ kmin,
                                  long long* __restrict__ kmax) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const long long g = gids[i];
        if (g >= 0 && g < G) {
            const double x = vals[i];
            long long lo, hi;
            if (isnan(x)) {
                lo = kKeyNan;       // NaN wins the min ...
                hi = kKeyMax;       // ... and the max
            } else {
                lo = hi = f64_key(x);
            }
            atomicMin(&kmin[g], lo);
            atomicMax(&kmax[g], hi);
        }
    }
}

__global__ void seg_minmax_final_kernel(const long long* __restrict__ kmin,
                                        const long long* __restrict__ kmax,
                                        long long G,
                                        double* __restrict__ mins,
                                        double* __restrict__ maxs) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < G; g += stride) {
        const long long lo = kmin[g], hi = kmax[g];
        mins[g] = lo == kKeyMax ? __longlong_as_double(0x7FF0000000000000LL)
                : lo == kKeyNan ? __longlong_as_double(0x7FF8000000000000LL)
                : key_f64(lo);
        maxs[g] = hi == kKeyNan ? __longlong_as_double((long long)0xFFF0000000000000ULL)
                : hi == kKeyMax ? __longlong_as_double(0x7FF8000000000000LL)
                : key_f64(hi);
    }
}

}  // namespace

extern "C" {

// path: 1 private, 2 global; grid and smem from the host plan (kernels.py
// segment_plan, _SEG_PATHS). Nothing is launched for an empty input (grid 0).
int nds_seg_sum_i64(const void* vals, const void* gids, long long n,
                    long long G, void* sums, void* counts, int path,
                    int grid, int smem, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= 0 || G <= 0 || grid <= 0) return (int)cudaGetLastError();
    unsigned long long* su = (unsigned long long*)sums;
    unsigned long long* co = (unsigned long long*)counts;
    if (path == 2) {
        seg_sum_i64_kernel<<<grid, kThreads, 0, s>>>(
            (const long long*)vals, (const long long*)gids, n, G, su, co);
        return (int)cudaGetLastError();
    }
    // the private path keeps 2 G words in shared memory
    if (path != 1 || G > (1LL << 30) || (long long)smem < 16 * G)
        return (int)cudaErrorInvalidValue;
    return G == 1
        ? launch_priv_aligned<true>(vals, gids, n, 1, su, co, grid, smem, s)
        : launch_priv_aligned<false>(vals, gids, n, (int)G, su, co, grid,
                                     smem, s);
}

int nds_seg_sum_f64(const void* vals, const void* gids, long long n,
                    long long G, void* sums, void* counts, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0 && G > 0) {
        seg_sum_f64_kernel<<<grid_for(n), kThreads, 0, s>>>(
            (const double*)vals, (const long long*)gids, n, G,
            (double*)sums, (unsigned long long*)counts);
    }
    return (int)cudaGetLastError();
}

int nds_seg_minmax_f64(const void* vals, const void* gids, long long n,
                       long long G, void* kmin, void* kmax, void* mins,
                       void* maxs, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (G <= 0) return (int)cudaGetLastError();
    seg_minmax_init_kernel<<<grid_for(G), kThreads, 0, s>>>(
        (long long*)kmin, (long long*)kmax, G);
    if (n > 0) {
        seg_minmax_kernel<<<grid_for(n), kThreads, 0, s>>>(
            (const double*)vals, (const long long*)gids, n, G,
            (long long*)kmin, (long long*)kmax);
    }
    seg_minmax_final_kernel<<<grid_for(G), kThreads, 0, s>>>(
        (const long long*)kmin, (const long long*)kmax, G,
        (double*)mins, (double*)maxs);
    return (int)cudaGetLastError();
}

}  // extern "C"
