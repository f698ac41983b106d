// Collision pairs to each row's top-k and squared sums (sm_90a), in float64
// or float32:
//     given one row block's products q_t(i) * w_t(j), sorted by the key
//     i * n_ref + j (a pair's products in ascending tree order), each row's
//     pair values P(i, j) = ((0 + p_0) + p_1) + ..., then either its k
//     largest (value descending, equal values by ascending column; a row
//     holding fewer than k pairs filled with value 0 at the smallest
//     columns it does not hold) or the sums of P(i, j)^2 by the class of
//     j, added in ascending column order from 0.
//
// Replaces no TPU kernel: the reference computes train-side top-k and
// squared row sums on dense blocks.  It takes the place of the collision
// path's plain torch steps after the sort (core/collide.py; the plain
// version is kernels/collide/ref.py): a rank loop over the products, two
// sorts for the top-k and one for the class sums, some twenty launches a
// block, in one launch that reads the sorted products once.
//
// Design: one thread a row, rows shared by nothing, so no barrier and no
// atomic.  A thread finds its row's products by binary search on the keys
// and walks them in order: the adds are unfused (__dadd_rn / __fadd_rn),
// so every value has the plain version's bits, and the top-k is a sorted
// list of k <= 64 entries in local memory that a pair enters only when its
// value is strictly larger than the k-th (pairs come by ascending column,
// so an equal value stays behind).  The class sums go straight to the
// row's own output, which the caller zeroed.  The walk is one loop over the
// products with the next load's address known ahead (unrolled), so a
// thread keeps several loads in flight.  Bound: one read of the keys
// and products (16 or 12 bytes a product) and the outputs written once.
#include <cuda_runtime.h>
#include <stdint.h>

#define CT_THREADS 128
#define CT_MAX_K 64

__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}

// first position of a sorted key at or past x
__device__ __forceinline__ long long lower_bound(const long long* a,
                                                 long long n, long long x) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        long long m = (lo + hi) >> 1;
        if (a[m] < x) lo = m + 1; else hi = m;
    }
    return lo;
}

template <typename V>
__global__ void __launch_bounds__(CT_THREADS)
collide_topk_kernel(const long long* __restrict__ key,
                    const V* __restrict__ prod, long long n_products,
                    long long n_ref, int rows, int k,
                    long long* __restrict__ idx, long long ldi,
                    double* __restrict__ val, long long ldv) {
    int r = blockIdx.x * CT_THREADS + threadIdx.x;
    if (r >= rows) return;
    long long base = (long long)r * n_ref;
    long long p = lower_bound(key, n_products, base);
    long long hi = lower_bound(key, n_products, base + n_ref);
    double tv[CT_MAX_K];
    long long tc[CT_MAX_K];
    int held = 0;
    // a pair enters when strictly larger than the k-th listed
    auto offer = [&](long long kv, V v) {
        double dv = (double)v;
        int j;
        if (held < k) {
            j = held++;
        } else if (dv > tv[k - 1]) {
            j = k - 1;
        } else {
            return;
        }
        for (; j > 0 && dv > tv[j - 1]; --j) {
            tv[j] = tv[j - 1];
            tc[j] = tc[j - 1];
        }
        tv[j] = dv;
        tc[j] = kv - base;
    };
    if (p < hi) {
        // one pass over the products, the loads' addresses known ahead
        long long kv = key[p];
        V v = prod[p];
#pragma unroll 4
        for (++p; p < hi; ++p) {
            long long kn = key[p];
            V pn = prod[p];
            if (kn == kv) {
                v = add_rn(v, pn);
            } else {
                offer(kv, v);
                kv = kn;
                v = pn;
            }
        }
        offer(kv, v);
    }
    // fewer than k pairs: all of them are listed; the smallest columns
    // that none of them holds follow, with value 0
    long long c = 0;
    for (int j = held; j < k; ++j, ++c) {
        for (bool taken = true; taken; ) {
            taken = false;
            for (int i = 0; i < held; ++i) {
                if (tc[i] == c) { taken = true; ++c; break; }
            }
        }
        tv[j] = 0.0;
        tc[j] = c;
    }
    for (int j = 0; j < k; ++j) {
        idx[(long long)r * ldi + j] = tc[j];
        val[(long long)r * ldv + j] = tv[j];
    }
}

template <typename V>
__global__ void __launch_bounds__(CT_THREADS)
collide_sums_kernel(const long long* __restrict__ key,
                    const V* __restrict__ prod, long long n_products,
                    long long n_ref, int rows,
                    const long long* __restrict__ class_of, int n_classes,
                    V* __restrict__ out) {
    int r = blockIdx.x * CT_THREADS + threadIdx.x;
    if (r >= rows) return;
    long long base = (long long)r * n_ref;
    long long p = lower_bound(key, n_products, base);
    long long hi = lower_bound(key, n_products, base + n_ref);
    V* o = out + (long long)r * n_classes;
    auto add = [&](long long kv, V v) {
        int cl = class_of == nullptr ? 0 : (int)class_of[kv - base];
        o[cl] = add_rn(o[cl], mul_rn(v, v));
    };
    if (p < hi) {
        long long kv = key[p];
        V v = prod[p];
#pragma unroll 4
        for (++p; p < hi; ++p) {
            long long kn = key[p];
            V pn = prod[p];
            if (kn == kv) {
                v = add_rn(v, pn);
            } else {
                add(kv, v);
                kv = kn;
                v = pn;
            }
        }
        add(kv, v);
    }
}

template <typename V>
static int topk(const void* key, const void* prod, long long n_products,
                long long n_ref, int rows, int k, void* idx, long long ldi,
                void* val, long long ldv, void* stream) {
    if (rows <= 0 || k <= 0) return 0;
    if (k > CT_MAX_K) return (int)cudaErrorInvalidValue;
    collide_topk_kernel<V><<<(rows + CT_THREADS - 1) / CT_THREADS,
                             CT_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)key, (const V*)prod, n_products, n_ref, rows, k,
        (long long*)idx, ldi, (double*)val, ldv);
    return (int)cudaGetLastError();
}

template <typename V>
static int sums(const void* key, const void* prod, long long n_products,
                long long n_ref, int rows, const void* class_of,
                int n_classes, void* out, void* stream) {
    if (rows <= 0) return 0;
    collide_sums_kernel<V><<<(rows + CT_THREADS - 1) / CT_THREADS,
                             CT_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)key, (const V*)prod, n_products, n_ref, rows,
        (const long long*)class_of, n_classes, (V*)out);
    return (int)cudaGetLastError();
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// key (n_products) int64 sorted, prod (n_products) f64; idx (rows, k)
// int64 with row stride ldi and val (rows, k) f64 with row stride ldv.
// 1 <= k <= 64.
int collide_topk_f64(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, int k, void* idx,
                     long long ldi, void* val, long long ldv, void* stream) {
    return topk<double>(key, prod, n_products, n_ref, rows, k, idx, ldi, val,
                        ldv, stream);
}

// The same with prod in f32 (val stays f64: the values widened).
int collide_topk_f32(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, int k, void* idx,
                     long long ldi, void* val, long long ldv, void* stream) {
    return topk<float>(key, prod, n_products, n_ref, rows, k, idx, ldi, val,
                       ldv, stream);
}

// key, prod as above; class_of (n_ref) int64 or null (one class); out
// (rows, n_classes) in prod's type, zeroed by the caller.
int collide_sums_f64(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, const void* class_of,
                     int n_classes, void* out, void* stream) {
    return sums<double>(key, prod, n_products, n_ref, rows, class_of,
                        n_classes, out, stream);
}

int collide_sums_f32(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, const void* class_of,
                     int n_classes, void* out, void* stream) {
    return sums<float>(key, prod, n_products, n_ref, rows, class_of,
                       n_classes, out, stream);
}

}  // extern "C"
