// Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
//
// Grouped aggregation kernels for Hopper (sm_90a): the port of the three
// Pallas kernels that every GROUP BY of the device-resident path ends in.
//
//   seg_sum_i64      replaces nds_tpu/engine/kernels.py _segment_sum_exact_pallas
//                    (body _seg_exact_kernel): per group, the exact int64 SUM
//                    with two's-complement wrap, and the row count.
//   seg_sum_f64      replaces _segment_sum_pallas (body _seg_kernel): per
//                    group, the float64 sum of the values (optional: a
//                    count-only launch passes no values) and the int64 count
//                    of rows.
//   seg_minmax_f64   replaces _segment_minmax_pallas (body
//                    _seg_minmax_kernel): per group, the float64 min and max.
//
// A row takes part when 0 <= gid < G; every other row (gid -1 for a null or
// filtered row, gid >= G for a pad row) is dropped.
//
// What bounds them on an H100: each row is read once (8 B of value + 8 B of
// group id; 8 B for a count-only launch), so the floor is n * 16 B over
// device-memory bandwidth (3.35 TB/s: about 14 us at the 2.88 M rows of SF1
// store_sales). What holds a kernel above it is atomic contention: one
// global atomic per row on G addresses serialises when few groups take many
// rows (at G = 1 every row lands on one address in L2). The TPU kernels'
// one-hot matmul, f32 limbs and group-count gates were limits of the matrix
// unit and do not carry over.
//
// All three have the same two hand-written paths; the host picks one by a
// fixed rule on G and the bytes a group takes in shared memory
// (nds_tpu_torch/engine/kernels.py segment_plan):
//   private (as many groups as 227 KB of shared memory holds: 14,528 at 16 B
//           a group for the sums with values and for min/max, 58,112 at 4 B
//           for a count-only launch, whose counts are 32-bit)  a persistent
//           grid of blocks (two an SM where the shared memory allows); each
//           block keeps every
//           group's partials in dynamic shared memory and reads its rows two
//           at a time with 16-byte loads. At G = 1 each thread reduces in
//           registers and a warp shuffle combines them at the end; at G > 1
//           each in-range row updates its group in shared memory. Each block
//           then folds its non-empty groups into global memory with one
//           global atomic per (block, group, output) instead of one per row.
//   global  (above that)  one thread per row, global atomics per row.
// The per-kernel policies below (SumI64, SumF64, CountOnly, MinMax) say how
// a row, a register partial and a flush look; the row loop is shared.
//
// Atomics on sm_90, from the SASS of this file (cuobjdump -sass;
// chip_smoke.py prints them with the build):
//   - a 64-bit shared atomicAdd, a float64 shared atomicAdd and a 64-bit
//     shared atomicMin / atomicMax are all compare-and-swap loops
//     (ATOMS.CAST.SPIN.64); only 32-bit shared adds are native (ATOMS.ADD;
//     +1 is ATOMS.POPC.INC.32). So 64-bit integer sums and counts are two
//     32-bit adds with the carry taken from the old low half
//     (shared_add64), a count-only launch keeps 32-bit counts, MinMax reads
//     its group's shared key first and makes an atomic only when the row
//     improves it (in rows of no particular order a group's running min
//     improves about ln(rows the block sees of it) times), and the float
//     sum's CAS loop is the cost of K2 with values at a few groups > 1, where
//     many lanes of a warp retry on one shared word.
//   - the global flush is native: REDG.E.ADD.F64.RN, REDG.E.ADD.64,
//     REDG.E.MIN.S64 and REDG.E.MAX.S64.
//
// The sweep behind the rule (chip_smoke.py k1_sweep and k23_sweep, n =
// 2,880,404; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): the
// private path beats the global one at every G up to the shared-memory cap
// for every kernel (count-only at 58,112 groups: 0.0276 against 0.0364 ms).
// Two blocks an SM stay the rule; a count-only launch of 4,096 groups and
// more would be 16-30 % faster at one (half the flushes), which the rule
// does not take (PERF.md). K2 with values slows under the per-row CAS loop
// at few groups (G = 2: 0.208 ms, G = 16: 0.039, against 0.017 at G = 1 and
// 2.81 ms for index_add_ at G = 2); a warp-aggregated variant
// (__match_any_sync) took 0.026 ms at G = 2 but was dropped, since no launch
// of the Power Run takes K2 with values at 2 to 32 groups. K3's global path
// reads the key before each atomic too: 5-14 % faster than without the read
// at every G above the cap.
//
// Exactness: 64-bit integer atomics wrap mod 2^64 and commute, so seg_sum_i64
// and every count are bit-exact whatever the order. Float64 atomics add in no
// fixed order, so seg_sum_f64 sums agree with a sequential sum to rounding
// only. Min and max run on an order-preserving int64 key of the double (IEEE
// total order with -0.0 < +0.0; any NaN wins and yields NaN), so they are
// exact and independent of order and of how rows split into blocks.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): pointers and the stream are passed as void*, every function
// enqueues on the given stream, allocates nothing and returns the
// cudaGetLastError() code of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPrivThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kKeyNan = (long long)0x8000000000000000ULL;   // min side
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;
// path codes shared with kernels.py _SEG_PATHS (0 is an empty launch)
enum { kPathPrivate = 1, kPathGlobal = 2 };

int grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 132LL * 64;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

// Adds x to a 64-bit shared-memory word with native 32-bit shared atomics.
// The old low half says whether the add carried into the high half; the sum
// stays exact mod 2^64.
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

// a row's (min key, max key): a NaN takes the keys that win both
__device__ __forceinline__ void minmax_keys(double x, long long& lo,
                                            long long& hi) {
    if (isnan(x)) {
        lo = kKeyNan;
        hi = kKeyMax;
    } else {
        lo = hi = f64_key(x);
    }
}

__device__ __forceinline__ long long peek(const long long* p) {
    return *reinterpret_cast<const volatile long long*>(p);
}

// ---------------------------------------------------------------------------
// Policies of the private path. Each names its value type V (None for a
// count-only launch), its register partial Acc (fold a row, merge another
// lane's by shuffle, empty test), how a row updates the block's shared
// partials, and how a group flushes to the global outputs Out.
// ---------------------------------------------------------------------------

struct None {};

__device__ __forceinline__ None load1(const None*, long long) { return {}; }
__device__ __forceinline__ void load2(const None*, long long, None&, None&) {}
__device__ __forceinline__ long long load1(const long long* v, long long i) {
    return __ldg(v + i);
}
__device__ __forceinline__ void load2(const long long* v, long long u,
                                      long long& a, long long& b) {
    const longlong2 p = __ldg(reinterpret_cast<const longlong2*>(v) + u);
    a = p.x;
    b = p.y;
}
__device__ __forceinline__ double load1(const double* v, long long i) {
    return __ldg(v + i);
}
__device__ __forceinline__ void load2(const double* v, long long u, double& a,
                                      double& b) {
    const double2 p = __ldg(reinterpret_cast<const double2*>(v) + u);
    a = p.x;
    b = p.y;
}

// K1: exact int64 sum and count; 16 B a group
struct SumI64 {
    using V = long long;
    struct Out { unsigned long long* sums; unsigned long long* counts; };
    struct Acc {
        unsigned long long s = 0ULL, c = 0ULL;
        __device__ void fold(V v) { s += (unsigned long long)v; c += 1ULL; }
        __device__ void shfl_merge(int off) {
            s += __shfl_xor_sync(kFull, s, off);
            c += __shfl_xor_sync(kFull, c, off);
        }
        __device__ bool empty() const { return c == 0ULL; }
    };
    unsigned long long* ssum;
    unsigned long long* scnt;
    __device__ SumI64(void* smem, int G)
        : ssum((unsigned long long*)smem),
          scnt((unsigned long long*)smem + G) {}
    __device__ void init(int g) { ssum[g] = 0ULL; scnt[g] = 0ULL; }
    __device__ void row(int g, V v) {
        shared_add64(&ssum[g], (unsigned long long)v);
        shared_add64(&scnt[g], 1ULL);
    }
    __device__ void commit(const Acc& a) {
        shared_add64(&ssum[0], a.s);
        shared_add64(&scnt[0], a.c);
    }
    __device__ void flush(int g, const Out& o) const {
        const unsigned long long c = scnt[g];
        if (c != 0ULL) {
            atomicAdd(&o.sums[g], ssum[g]);
            atomicAdd(&o.counts[g], c);
        }
    }
};

// K2 with values: float64 sum and count; 16 B a group
struct SumF64 {
    using V = double;
    struct Out { double* sums; unsigned long long* counts; };
    struct Acc {
        double s = 0.0;
        unsigned long long c = 0ULL;
        __device__ void fold(V v) { s += v; c += 1ULL; }
        __device__ void shfl_merge(int off) {
            s += __shfl_xor_sync(kFull, s, off);
            c += __shfl_xor_sync(kFull, c, off);
        }
        __device__ bool empty() const { return c == 0ULL; }
    };
    double* ssum;
    unsigned long long* scnt;
    __device__ SumF64(void* smem, int G)
        : ssum((double*)smem), scnt((unsigned long long*)smem + G) {}
    __device__ void init(int g) { ssum[g] = 0.0; scnt[g] = 0ULL; }
    __device__ void row(int g, V v) {
        atomicAdd(&ssum[g], v);
        shared_add64(&scnt[g], 1ULL);
    }
    __device__ void commit(const Acc& a) {
        atomicAdd(&ssum[0], a.s);
        shared_add64(&scnt[0], a.c);
    }
    __device__ void flush(int g, const Out& o) const {
        const unsigned long long c = scnt[g];
        if (c != 0ULL) {
            atomicAdd(&o.sums[g], ssum[g]);
            atomicAdd(&o.counts[g], c);
        }
    }
};

// K2 count-only: the count alone, in 32 bits (4 B a group; the entry point
// refuses a launch in which a block could see 2^32 rows)
struct CountOnly {
    using V = None;
    struct Out { unsigned long long* counts; };
    struct Acc {
        unsigned long long c = 0ULL;
        __device__ void fold(V) { c += 1ULL; }
        __device__ void shfl_merge(int off) {
            c += __shfl_xor_sync(kFull, c, off);
        }
        __device__ bool empty() const { return c == 0ULL; }
    };
    unsigned* scnt;
    __device__ CountOnly(void* smem, int) : scnt((unsigned*)smem) {}
    __device__ void init(int g) { scnt[g] = 0u; }
    __device__ void row(int g, V) { atomicAdd(&scnt[g], 1u); }
    __device__ void commit(const Acc& a) { atomicAdd(&scnt[0], (unsigned)a.c); }
    __device__ void flush(int g, const Out& o) const {
        const unsigned long long c = scnt[g];
        if (c != 0ULL) atomicAdd(&o.counts[g], c);
    }
};

// K3: min and max keys; 16 B a group. Flushes into keys that the init
// kernel set to the identities before the launch.
struct MinMax {
    using V = double;
    struct Out { long long* kmin; long long* kmax; };
    struct Acc {
        long long lo = kKeyMax, hi = kKeyNan;
        __device__ void fold(V v) {
            long long a, b;
            minmax_keys(v, a, b);
            lo = min(lo, a);
            hi = max(hi, b);
        }
        __device__ void shfl_merge(int off) {
            lo = min(lo, __shfl_xor_sync(kFull, lo, off));
            hi = max(hi, __shfl_xor_sync(kFull, hi, off));
        }
        __device__ bool empty() const { return lo == kKeyMax && hi == kKeyNan; }
    };
    long long* smin;
    long long* smax;
    __device__ MinMax(void* smem, int G)
        : smin((long long*)smem), smax((long long*)smem + G) {}
    __device__ void init(int g) { smin[g] = kKeyMax; smax[g] = kKeyNan; }
    __device__ void row(int g, V v) {
        long long a, b;
        minmax_keys(v, a, b);
        if (a < peek(&smin[g])) atomicMin(&smin[g], a);
        if (b > peek(&smax[g])) atomicMax(&smax[g], b);
    }
    __device__ void commit(const Acc& a) {
        if (a.lo != kKeyMax) atomicMin(&smin[0], a.lo);
        if (a.hi != kKeyNan) atomicMax(&smax[0], a.hi);
    }
    __device__ void flush(int g, const Out& o) const {
        const long long lo = smin[g], hi = smax[g];
        if (lo != kKeyMax) atomicMin(&o.kmin[g], lo);
        if (hi != kKeyNan) atomicMax(&o.kmax[g], hi);
    }
};

// One row into the block's partials. kOne (G == 1): folded into the
// thread's registers. Otherwise an in-range row updates its group in
// shared memory.
template <class P, bool kOne>
__device__ __forceinline__ void add_row(P& p, typename P::Acc& acc,
                                        long long g, typename P::V v, int G) {
    if (kOne) {
        if (g == 0) acc.fold(v);
    } else if (g >= 0 && g < G) {
        p.row((int)g, v);
    }
}

// The private path: a persistent grid; kVec reads a pair of rows with one
// 16-byte load per array.
template <class P, bool kOne, bool kVec>
__global__ void __launch_bounds__(kPrivThreads)
seg_priv_kernel(const typename P::V* __restrict__ vals,
                const long long* __restrict__ gids, long long n, int G,
                typename P::Out out) {
    extern __shared__ unsigned long long smem[];
    P p(smem, G);
    for (int g = threadIdx.x; g < G; g += blockDim.x) p.init(g);
    __syncthreads();
    typename P::Acc acc;
    const long long units = kVec ? n >> 1 : n;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < units; u += stride) {
        if (kVec) {
            const longlong2 gg =
                __ldg(reinterpret_cast<const longlong2*>(gids) + u);
            typename P::V v0, v1;
            load2(vals, u, v0, v1);
            add_row<P, kOne>(p, acc, gg.x, v0, G);
            add_row<P, kOne>(p, acc, gg.y, v1, G);
        } else {
            add_row<P, kOne>(p, acc, __ldg(gids + u), load1(vals, u), G);
        }
    }
    if (kVec && (n & 1) && blockIdx.x == 0 && threadIdx.x == 0)
        add_row<P, kOne>(p, acc, gids[n - 1], load1(vals, n - 1), G);
    if (kOne) {
        // each warp's partials, by shuffle, into the block's one group
        for (int off = 16; off > 0; off >>= 1) acc.shfl_merge(off);
        if ((threadIdx.x & 31) == 0 && !acc.empty()) p.commit(acc);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) p.flush(g, out);
}

// above 48 KB a block must ask for its dynamic shared memory; the largest
// size asked for so far is kept per kernel instance
template <class K>
cudaError_t grant_smem(K kernel, int smem, int& granted) {
    if (smem <= granted) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) granted = smem;
    return e;
}

template <class P, bool kOne, bool kVec>
int launch_priv(const typename P::V* vals, const long long* gids,
                long long n, int G, typename P::Out out, int grid, int smem,
                cudaStream_t s) {
    static int granted = 48 * 1024;
    const cudaError_t e = grant_smem(seg_priv_kernel<P, kOne, kVec>, smem,
                                     granted);
    if (e != cudaSuccess) return (int)e;
    seg_priv_kernel<P, kOne, kVec><<<grid, kPrivThreads, smem, s>>>(
        vals, gids, n, G, out);
    return (int)cudaGetLastError();
}

// 16-byte loads where both arrays allow them (a count-only launch has no
// values), 8-byte ones otherwise; G == 1 reduces in registers
template <class P>
int launch_priv_aligned(const void* vals, const void* gids, long long n,
                        int G, typename P::Out out, int grid, int smem,
                        cudaStream_t s) {
    using V = typename P::V;
    const bool vec = ((((uintptr_t)vals) | ((uintptr_t)gids)) & 15u) == 0;
    const V* v = (const V*)vals;
    const long long* g = (const long long*)gids;
    if (G == 1)
        return vec ? launch_priv<P, true, true>(v, g, n, 1, out, grid, smem, s)
                   : launch_priv<P, true, false>(v, g, n, 1, out, grid, smem,
                                                 s);
    return vec ? launch_priv<P, false, true>(v, g, n, G, out, grid, smem, s)
               : launch_priv<P, false, false>(v, g, n, G, out, grid, smem, s);
}

// the private path's checks: G fits an int and smem holds `bytes` a group
bool priv_ok(long long G, int smem, long long bytes) {
    return G <= (1LL << 30) && (long long)smem >= bytes * G;
}

// ---------------------------------------------------------------------------
// The global path: one thread per row, global atomics per row.
// ---------------------------------------------------------------------------

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

// reads the group's global key first and makes an atomic only when the row
// improves it
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
            long long lo, hi;
            minmax_keys(vals[i], lo, hi);
            if (lo < peek(&kmin[g])) atomicMin(&kmin[g], lo);
            if (hi > peek(&kmax[g])) atomicMax(&kmax[g], hi);
        }
    }
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

// path: 1 private, 2 global (kernels.py _SEG_PATHS); grid and smem from the
// host plan (kernels.py segment_plan). Nothing is launched for an empty
// input (grid 0).
int nds_seg_sum_i64(const void* vals, const void* gids, long long n,
                    long long G, void* sums, void* counts, int path,
                    int grid, int smem, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= 0 || G <= 0 || grid <= 0) return (int)cudaGetLastError();
    SumI64::Out out{(unsigned long long*)sums, (unsigned long long*)counts};
    if (path == kPathGlobal) {
        seg_sum_i64_kernel<<<grid, kThreads, 0, s>>>(
            (const long long*)vals, (const long long*)gids, n, G, out.sums,
            out.counts);
        return (int)cudaGetLastError();
    }
    if (path != kPathPrivate || !priv_ok(G, smem, 16))
        return (int)cudaErrorInvalidValue;
    return launch_priv_aligned<SumI64>(vals, gids, n, (int)G, out, grid, smem,
                                       s);
}

// vals == nullptr: a count-only launch (sums are left as they are). Its
// private path keeps 4-byte counts, so it is refused where a block could
// see 2^32 rows: at most n / grid + 2 * kPrivThreads + 1 of the grid-stride
// loop's rows fall to one block.
int nds_seg_sum_f64(const void* vals, const void* gids, long long n,
                    long long G, void* sums, void* counts, int path,
                    int grid, int smem, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= 0 || G <= 0 || grid <= 0) return (int)cudaGetLastError();
    unsigned long long* co = (unsigned long long*)counts;
    if (path == kPathGlobal) {
        seg_sum_f64_kernel<<<grid, kThreads, 0, s>>>(
            (const double*)vals, (const long long*)gids, n, G,
            (double*)sums, co);
        return (int)cudaGetLastError();
    }
    if (vals == nullptr) {
        if (path != kPathPrivate || !priv_ok(G, smem, 4) ||
            n / grid + 2LL * kPrivThreads + 1 >= (1LL << 32))
            return (int)cudaErrorInvalidValue;
        return launch_priv_aligned<CountOnly>(nullptr, gids, n, (int)G, {co},
                                              grid, smem, s);
    }
    SumF64::Out out{(double*)sums, co};
    if (path != kPathPrivate || !priv_ok(G, smem, 16))
        return (int)cudaErrorInvalidValue;
    return launch_priv_aligned<SumF64>(vals, gids, n, (int)G, out, grid, smem,
                                       s);
}

// Three launches: the keys' identities, the rows (path 1 private, 2
// global), the decoding into doubles.
int nds_seg_minmax_f64(const void* vals, const void* gids, long long n,
                       long long G, void* kmin, void* kmax, void* mins,
                       void* maxs, int path, int grid, int smem,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (G <= 0) return (int)cudaGetLastError();
    MinMax::Out out{(long long*)kmin, (long long*)kmax};
    const bool rows = n > 0 && grid > 0;
    if (rows && path == kPathPrivate && !priv_ok(G, smem, 16))
        return (int)cudaErrorInvalidValue;
    if (rows && path != kPathPrivate && path != kPathGlobal)
        return (int)cudaErrorInvalidValue;
    seg_minmax_init_kernel<<<grid_for(G), kThreads, 0, s>>>(out.kmin,
                                                            out.kmax, G);
    if (rows) {
        const double* v = (const double*)vals;
        const long long* g = (const long long*)gids;
        if (path == kPathPrivate) {
            const int rc = launch_priv_aligned<MinMax>(v, g, n, (int)G, out,
                                                       grid, smem, s);
            if (rc != 0) return rc;
        } else {
            seg_minmax_kernel<<<grid, kThreads, 0, s>>>(v, g, n, G, out.kmin,
                                                         out.kmax);
        }
    }
    seg_minmax_final_kernel<<<grid_for(G), kThreads, 0, s>>>(
        out.kmin, out.kmax, G, (double*)mins, (double*)maxs);
    return (int)cudaGetLastError();
}

}  // extern "C"
