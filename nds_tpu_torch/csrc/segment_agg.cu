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
// group id) and lands in one or two global atomics, so the floor is
// n * 16 B over device-memory bandwidth (3.35 TB/s: about 14 us at the 2.88 M
// rows of SF1 store_sales). The atomics add contention when few groups take
// many rows (G = 1 serialises every row on one address in L2). The design here
// is the simple correct one: one thread per row in a grid-stride loop, with
// global atomics. The TPU kernels' one-hot matmul, f32 limbs and group-count
// gates were limits of the matrix unit and do not carry over.
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

int nds_seg_sum_i64(const void* vals, const void* gids, long long n,
                    long long G, void* sums, void* counts, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0 && G > 0) {
        seg_sum_i64_kernel<<<grid_for(n), kThreads, 0, s>>>(
            (const long long*)vals, (const long long*)gids, n, G,
            (unsigned long long*)sums, (unsigned long long*)counts);
    }
    return (int)cudaGetLastError();
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
