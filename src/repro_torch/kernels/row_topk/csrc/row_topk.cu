// Exact row top-k of a dense block in float64 or float32 (sm_90a):
//     for each row i of B (rows x n), its k largest entries as (column,
//     value), values descending and equal values by ascending column.
//
// Replaces no TPU kernel: the reference selects with `jax.lax.top_k` on the
// dense proximity block (src/repro/core/jax_ops.py, `swlc_topk`), which XLA
// lowers for the TPU.  It takes the place of `torch.topk`'s radix select, the
// candidate re-sort and the tie rule's host read in the engine's top-k
// (core/engine.py::ProximityEngine.topk): the radix select reads each block
// many times and `torch.topk` may take any of the columns tied at its last
// place, while this kernel keeps the whole order exact in one pass.
//
// Bound: one read of the block (rows * n * sizeof(V) bytes) and the k
// results a row written once; on the H100 at 3.35 TB/s a 320 x 100,000
// float64 block is 0.076 ms.  Design:
//   * order: (v, c) beats (u, d) when v > u, or v == u and c < d; every
//     column of a row is distinct, so a row's entries are totally ordered
//     and any split of the row gives the same answer.  The sentinel
//     (-inf, INT_MAX) beats nothing; NaN beats nothing either, so rows
//     holding NaN are outside the contract;
//   * stage 1 (`row_topk_lists`): a warp streams one slice (a "list") of a
//     row with 16-byte loads, four a lane in flight, and keeps the slice's
//     exact top-k sorted in registers (R = 1 or 2 entries a lane: k <= 32
//     or k <= 64).  An element is tested against the warp's k-th entry;
//     after the first few, almost none pass, so the common step is a load,
//     k compares and one vote.  Passers are appended to the warp's buffer
//     in shared memory (ballot and popc, no atomics); once 32 wait, they
//     are sorted by a warp bitonic network and merged into the top-k, and
//     the k-th entry (the threshold) rises.  Elements before a row's first
//     16-byte boundary and after its last whole vector are taken by the
//     row's first list one a lane;
//   * stage 2 (`row_topk_merge`): a warp a row streams its lists' k
//     entries through the same top-k and writes the columns (int64) and the
//     values (widened to float64) straight into the caller's row-strided
//     outputs;
//   * warps share nothing, so neither stage has a block barrier; lists a
//     row = the wrapper's plan (ops.py::lists_per_row): as many as keep the
//     first stage within four blocks an SM (one wave, for either R), no
//     list below 2,048 elements; 13 at 320 x 100,000, 48 at a tick.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "warp_topk.cuh"

#define RT_WARPS 8
#define RT_THREADS (RT_WARPS * 32)
#define RT_UNROLL 4             // 16-byte loads a lane in flight

template <typename V> struct Vec16;
template <> struct Vec16<double> {
    typedef double2 T;
    static constexpr int N = 2;
    static __device__ __forceinline__ double at(const double2& x, int e) {
        return e == 0 ? x.x : x.y;
    }
};
template <> struct Vec16<float> {
    typedef float4 T;
    static constexpr int N = 4;
    static __device__ __forceinline__ float at(const float4& x, int e) {
        return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
    }
};

// Stage 1: warp g takes list g % lists of row g / lists, and writes its k
// best (sentinels where the slice holds fewer) to sv/sc[g * k ...].
template <typename V, int R>
__global__ void __launch_bounds__(RT_THREADS, 4)
row_topk_lists(const V* __restrict__ B, long long ldb, int rows, int n,
               int k, int lists, V* __restrict__ sv, int* __restrict__ sc) {
    __shared__ V buf_v[RT_WARPS][RT_BUF];
    __shared__ int buf_c[RT_WARPS][RT_BUF];
    typedef typename Vec16<V>::T VT;
    constexpr int VN = Vec16<V>::N;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long g = (long long)blockIdx.x * RT_WARPS + warp;
    if (g >= (long long)rows * lists) return;      // the whole warp
    const int row = (int)(g / lists), list = (int)(g % lists);
    const V* p = B + (long long)row * ldb;
    // elements before the first 16-byte boundary, whole vectors, the rest
    const int mis = (int)(((uintptr_t)p & 15) / sizeof(V));
    const int head = min(n, mis ? VN - mis : 0);
    const long long nvec = (n - head) / VN;
    const int tail0 = head + (int)(nvec * VN);
    const long long per = (nvec + lists - 1) / lists;
    const long long v0 = min(nvec, (long long)list * per);
    const long long v1 = min(nvec, v0 + per);

    WarpTopK<V, R> top;
    top.init(buf_v[warp], buf_c[warp], k, lane);
    if (list == 0) {            // at most 2 (VN - 1) of them
        const int extra = head + (n - tail0);
        const int c = lane < head ? lane : tail0 + lane - head;
        const bool ok = lane < extra;
        top.push(ok ? p[c] : V(0), c, ok);
    }
    const VT* pv = reinterpret_cast<const VT*>(p + head);
    for (long long vb = v0; vb < v1; vb += 32 * RT_UNROLL) {
        VT x[RT_UNROLL];
#pragma unroll
        for (int u = 0; u < RT_UNROLL; ++u) {
            const long long vi = vb + u * 32 + lane;
            if (vi < v1) x[u] = __ldcs(pv + vi);
            else x[u] = VT{};
        }
        bool any = false;
#pragma unroll
        for (int u = 0; u < RT_UNROLL; ++u) {
            const long long vi = vb + u * 32 + lane;
#pragma unroll
            for (int e = 0; e < VN; ++e)
                any |= vi < v1 && top.passes(Vec16<V>::at(x[u], e),
                                             head + (int)(vi * VN) + e);
        }
        if (__any_sync(RT_FULL, any)) {
#pragma unroll
            for (int u = 0; u < RT_UNROLL; ++u) {
                const long long vi = vb + u * 32 + lane;
#pragma unroll
                for (int e = 0; e < VN; ++e)
                    top.push(Vec16<V>::at(x[u], e),
                             head + (int)(vi * VN) + e, vi < v1);
            }
        }
    }
    top.flush();
    V* ov = sv + g * k;
    int* oc = sc + g * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = r * 32 + lane;
        if (e < k) { ov[e] = top.tv[r]; oc[e] = top.tc[r]; }
    }
}

// Stage 2: warp `row` merges the row's lists and writes its k entries.
template <typename V, int R>
__global__ void __launch_bounds__(RT_THREADS)
row_topk_merge(const V* __restrict__ sv, const int* __restrict__ sc,
               int rows, int k, int lists, long long* __restrict__ idx,
               long long ldi, double* __restrict__ val, long long ldv) {
    __shared__ V buf_v[RT_WARPS][RT_BUF];
    __shared__ int buf_c[RT_WARPS][RT_BUF];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * RT_WARPS + warp;
    if (row >= rows) return;
    const long long m = (long long)lists * k;
    const V* cv = sv + row * m;
    const int* cc = sc + row * m;
    WarpTopK<V, R> top;
    top.init(buf_v[warp], buf_c[warp], k, lane);
    for (long long j0 = 0; j0 < m; j0 += 32) {
        const long long j = j0 + lane;
        const bool ok = j < m;
        top.push(ok ? cv[j] : V(0), ok ? cc[j] : RT_NONE, ok);
    }
    top.flush();
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = r * 32 + lane;
        if (e < k) {
            idx[row * ldi + e] = (long long)top.tc[r];
            val[row * ldv + e] = (double)top.tv[r];
        }
    }
}

template <typename V, int R>
static int launch(const void* B, long long ldb, int rows, int n, int k,
                  int lists, void* sv, void* sc, void* idx, long long ldi,
                  void* val, long long ldv, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long g1 = ((long long)rows * lists + RT_WARPS - 1) / RT_WARPS;
    const long long g2 = ((long long)rows + RT_WARPS - 1) / RT_WARPS;
    if (g1 > INT_MAX) return (int)cudaErrorInvalidValue;
    row_topk_lists<V, R><<<(unsigned)g1, RT_THREADS, 0, s>>>(
        (const V*)B, ldb, rows, n, k, lists, (V*)sv, (int*)sc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    row_topk_merge<V, R><<<(unsigned)g2, RT_THREADS, 0, s>>>(
        (const V*)sv, (const int*)sc, rows, k, lists, (long long*)idx, ldi,
        (double*)val, ldv);
    return (int)cudaGetLastError();
}

template <typename V>
static int dispatch(const void* B, long long ldb, int rows, int n, int k,
                    int lists, void* sv, void* sc, void* idx, long long ldi,
                    void* val, long long ldv, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (k < 1 || k > 64 || n < k || n >= RT_NONE || lists < 1 || ldb < n
        || ldi < k || ldv < k)
        return (int)cudaErrorInvalidValue;
    return k <= 32
        ? launch<V, 1>(B, ldb, rows, n, k, lists, sv, sc, idx, ldi, val, ldv,
                       stream)
        : launch<V, 2>(B, ldb, rows, n, k, lists, sv, sc, idx, ldi, val, ldv,
                       stream);
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// B (rows, n) f64 with row stride ldb (elements, each row contiguous); the
// scratch sv (rows * lists * k) f64 and sc (rows * lists * k) int32; idx
// (rows, k) int64 with row stride ldi and val (rows, k) f64 with row stride
// ldv.  1 <= k <= 64 and k <= n.
int row_topk_f64(const void* B, long long ldb, int rows, int n, int k,
                 int lists, void* sv, void* sc, void* idx, long long ldi,
                 void* val, long long ldv, void* stream) {
    return dispatch<double>(B, ldb, rows, n, k, lists, sv, sc, idx, ldi, val,
                            ldv, stream);
}

// The same with B and sv in f32 (val stays f64: the values widened).
int row_topk_f32(const void* B, long long ldb, int rows, int n, int k,
                 int lists, void* sv, void* sc, void* idx, long long ldi,
                 void* val, long long ldv, void* stream) {
    return dispatch<float>(B, ldb, rows, n, k, lists, sv, sc, idx, ldi, val,
                           ldv, stream);
}

}  // extern "C"
