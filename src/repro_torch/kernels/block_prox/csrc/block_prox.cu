// SWLC proximity block in float64 (sm_90a):
//     P[i, j] = sum_t q[i, t] * w[j, t] * 1[gl_q[i, t] == gl_w[j, t]].
//
// Replaces the TPU kernel `block_prox_pallas` (src/repro/kernels/block_prox/
// block_prox.py, body `_block_prox_kernel`), which holds (256, T) tiles of
// both sides in VMEM and accumulates (256, 256, 8) masked broadcasts on the
// VPU in float32 (the TPU has no float64 vector unit).  Here the engine's
// float64 is kept end to end.  Two forms, with the same bits: every P[i, j]
// is fma(q, w, acc) over its colliding trees in ascending order from 0.0
// (a term skipped for a zero q or w, the other finite, leaves acc as it is).
//
// Leaf-collision form (`block_prox_leaf_kernel`).  The dense form pays
// Nq * Nw * T compares for the few per cent that collide; this one pays one
// FMA per collision with nonzero q and w, so where leaves are small the
// output write (Nq * Nw * 8 bytes, every element written once) sets the
// floor.  Design:
//   * the reference side comes as a leaf index (ops.py::build_leaf_index):
//     each leaf's member columns in ascending order with their w (zero
//     weights left out), and each leaf's first member in each of at most 16
//     column ranges;
//   * grid = (groups of 8 query rows, column ranges); a warp owns one query
//     row and walks its range in tiles of `tile` columns kept in shared
//     memory: zeroed, accumulated, written out coalesced, zeroed again;
//   * per (row, tree) a cursor into the leaf's members stays in shared
//     memory with the column of the next member, so a tree is live in a
//     tile only when that column falls inside it: a tile costs its
//     collisions, not its trees x columns;
//   * trees are taken 32 at a time, a lane a tree, and the live ones in
//     ascending order by ballot; the members of up to BP_GROUP live trees
//     are loaded before any is added, so their L2 latencies overlap;
//   * a leaf holds each column once, so within a tree no two lanes add to
//     one slot (no atomics); a __syncwarp between trees orders those that
//     share a column, which keeps the tree order of every sum;
//   * warps share nothing, so there is no block barrier.
// Its cost grows with the members a (row, tree) meets; past a few per cent
// of the columns (shallow trees, big leaves) the dense form is faster, and
// the engine picks by that share (ops.py::LEAF_DENSITY_MAX).
//
// Dense form (`block_prox_kernel`), for big leaves and for calls without
// an index: one block of 256 threads per 64 x 64 output tile; chunks of 16
// trees of both sides staged in shared memory, transposed and padded (no
// bank conflicts); a 4 x 4 register micro-tile of accumulators a thread,
// 8 shared loads for 16 compare-and-FMA; ragged edges masked while staging
// (query rows past Nq get leaf -1, reference rows past Nw -2, trees past T
// both, with zero weights).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define BP_ROWS 8
#define BP_THREADS (BP_ROWS * 32)
#define BP_GROUP 6              // 4 and 8 measured slower (PERF.md)
#define BP_NONE INT_MAX
#define BP_FULL 0xffffffffu

__global__ void __launch_bounds__(BP_THREADS, 3)   // 3 blocks an SM
block_prox_leaf_kernel(const int* __restrict__ gl_q,
                       const double* __restrict__ q, long long nq,
                       int n_trees, const int* __restrict__ offs,
                       int n_leaves, int n_ranges,
                       int range_w, const int* __restrict__ m_col,
                       const double* __restrict__ m_w,
                       double* __restrict__ out, long long nw, int tile) {
    extern __shared__ double smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long i = (long long)blockIdx.x * BP_ROWS + warp;
    const int r = blockIdx.y;
    const long long j0 = (long long)r * range_w;
    if (i >= nq || j0 >= nw) return;
    const long long j1 = min(j0 + (long long)range_w, nw);
    double* row = smem + warp * tile;
    int* s_cur = (int*)(smem + BP_ROWS * tile) + warp * 3 * n_trees;
    int* s_end = s_cur + n_trees;
    int* s_next = s_end + n_trees;
    const int* gq = gl_q + i * n_trees;
    const double* qi = q + i * n_trees;

    // cursors at the range's first member of each (row, tree) leaf; a tree
    // whose q is 0 or whose leaf has no member here never turns live
#pragma unroll 4
    for (int t = lane; t < n_trees; t += 32) {
        int cur = 0, end = 0;
        const int leaf = gq[t];
        if (qi[t] != 0.0 && (unsigned)leaf < (unsigned)n_leaves) {
            const long long e = (long long)leaf * (n_ranges + 1) + r;
            cur = offs[e];
            end = offs[e + 1];
        }
        s_cur[t] = cur;
        s_end[t] = end;
        s_next[t] = cur < end ? m_col[cur] : BP_NONE;
    }
    for (int c = lane; c < tile; c += 32) row[c] = 0.0;
    __syncwarp();

    for (long long a = j0; a < j1; a += tile) {
        const int cw = (int)min((long long)tile, j1 - a);
        const int a0 = (int)a;
        const int stop = a0 + cw;
        for (int t0 = 0; t0 < n_trees; t0 += 32) {
            const int t = t0 + lane;
            int cur = 0, end = 0, nxt = BP_NONE;
            if (t < n_trees) {
                cur = s_cur[t];
                end = s_end[t];
                nxt = s_next[t];
            }
            unsigned live = __ballot_sync(BP_FULL, nxt < stop);
            if (live == 0) continue;
            const double qv = nxt < stop ? qi[t] : 0.0;
            while (live) {
                int k[BP_GROUP], base[BP_GROUP], lim[BP_GROUP], c[BP_GROUP];
                double qk[BP_GROUP], wv[BP_GROUP];
#pragma unroll
                for (int u = 0; u < BP_GROUP; ++u) {
                    k[u] = __ffs(live) - 1;          // -1 once none is left
                    live &= live - 1u;
                }
                // the first 32 members of every tree of the group in flight
#pragma unroll
                for (int u = 0; u < BP_GROUP; ++u) {
                    const int src = k[u] & 31;
                    base[u] = __shfl_sync(BP_FULL, cur, src);
                    lim[u] = __shfl_sync(BP_FULL, end, src);
                    qk[u] = __shfl_sync(BP_FULL, qv, src);
                    const int p = base[u] + lane;
                    const bool ok = k[u] >= 0 && p < lim[u];
                    c[u] = ok ? __ldg(m_col + p) : BP_NONE;
                    wv[u] = ok ? __ldg(m_w + p) : 0.0;
                }
#pragma unroll
                for (int u = 0; u < BP_GROUP; ++u) {
                    if (k[u] < 0) break;
                    int cc = c[u], b = base[u];
                    double ww = wv[u];
                    for (;;) {
                        // members ascend, so the lanes inside the tile are
                        // a prefix of the warp
                        const bool in = cc < stop;
                        if (in) row[cc - a0] = fma(qk[u], ww, row[cc - a0]);
                        const int n_in =
                            __popc(__ballot_sync(BP_FULL, in));
                        if (n_in < 32) {
                            const int nx = __shfl_sync(BP_FULL, cc, n_in);
                            if (lane == k[u]) {
                                cur = b + n_in;
                                nxt = nx;
                            }
                            break;
                        }
                        b += 32;
                        const int p = b + lane;
                        cc = p < lim[u] ? __ldg(m_col + p) : BP_NONE;
                        ww = p < lim[u] ? __ldg(m_w + p) : 0.0;
                    }
                    __syncwarp();                   // tree order per slot
                }
            }
            if (t < n_trees) {
                s_cur[t] = cur;
                s_next[t] = nxt;
            }
        }
        __syncwarp();
        double* o = out + i * nw + a;
        for (int c = lane; c < cw; c += 32) {
            o[c] = row[c];
            row[c] = 0.0;
        }
        __syncwarp();
    }
}

// ---- dense form ----
#define BP_TILE 64
#define BP_TCH 16
#define BP_DTHREADS 256
#define BP_PAD (BP_TILE + 1)

__global__ void __launch_bounds__(BP_DTHREADS)
block_prox_kernel(const int* __restrict__ gl_q, const double* __restrict__ q,
                  const int* __restrict__ gl_w, const double* __restrict__ w,
                  double* __restrict__ out, long long nq, long long nw,
                  int n_trees) {
    __shared__ int s_gq[BP_TCH][BP_PAD];
    __shared__ int s_gw[BP_TCH][BP_PAD];
    __shared__ double s_q[BP_TCH][BP_PAD];
    __shared__ double s_w[BP_TCH][BP_PAD];

    const long long i0 = (long long)blockIdx.y * BP_TILE;
    const long long j0 = (long long)blockIdx.x * BP_TILE;
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;

    double acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;

    for (int t0 = 0; t0 < n_trees; t0 += BP_TCH) {
        for (int e = threadIdx.x; e < BP_TILE * BP_TCH; e += BP_DTHREADS) {
            const int r = e / BP_TCH, c = e % BP_TCH;
            const int t = t0 + c;
            const long long iq = i0 + r, jw = j0 + r;
            const bool okq = iq < nq && t < n_trees;
            const bool okw = jw < nw && t < n_trees;
            s_gq[c][r] = okq ? gl_q[iq * n_trees + t] : -1;
            s_q[c][r] = okq ? q[iq * n_trees + t] : 0.0;
            s_gw[c][r] = okw ? gl_w[jw * n_trees + t] : -2;
            s_w[c][r] = okw ? w[jw * n_trees + t] : 0.0;
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < BP_TCH; ++c) {
            int gq[4], gw[4];
            double qv[4], wv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                gq[a] = s_gq[c][ty + 16 * a];
                qv[a] = s_q[c][ty + 16 * a];
                gw[a] = s_gw[c][tx + 16 * a];
                wv[a] = s_w[c][tx + 16 * a];
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (gq[a] == gw[b]) acc[a][b] = fma(qv[a], wv[b], acc[a][b]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const long long i = i0 + ty + 16 * a;
        if (i >= nq) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const long long j = j0 + tx + 16 * b;
            if (j < nw) out[i * nw + j] = acc[a][b];
        }
    }
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// gl_q (nq, T) int32 global leaf ids and q (nq, T) f64, row-major and
// contiguous; the leaf index arrays of ops.py::LeafIndex; out (nq, nw) f64
// row-major.  `smem` is the dynamic shared memory of ops.py::leaf_plan for
// this `tile`.
int block_prox_leaf(const void* gl_q, const void* q, long long nq,
                    int n_trees, const void* offs, int n_leaves,
                    int n_ranges, int range_w, const void* m_col,
                    const void* m_w,
                    void* out, long long nw, int tile, int smem,
                    void* stream) {
    static int smem_set = 48 * 1024;
    if (nq <= 0 || nw <= 0 || n_trees <= 0) return (int)cudaSuccess;
    if (n_ranges <= 0 || n_ranges > 65535 || tile <= 0 || tile % 32)
        return (int)cudaErrorInvalidValue;
    const long long gx = (nq + BP_ROWS - 1) / BP_ROWS;
    if (gx > INT_MAX) return (int)cudaErrorInvalidValue;
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            block_prox_leaf_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = smem;
    }
    dim3 grid((unsigned)gx, (unsigned)n_ranges);
    block_prox_leaf_kernel<<<grid, BP_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)gl_q, (const double*)q, nq, n_trees, (const int*)offs,
        n_leaves, n_ranges, range_w, (const int*)m_col,
        (const double*)m_w, (double*)out, nw, tile);
    return (int)cudaGetLastError();
}

// Dense form: gl_w (nw, T) int32 and w (nw, T) f64 in place of the index.
int block_prox_dense(const void* gl_q, const void* q, const void* gl_w,
                     const void* w, void* out, long long nq, long long nw,
                     int n_trees, void* stream) {
    if (nq <= 0 || nw <= 0) return (int)cudaSuccess;
    const long long gy = (nq + BP_TILE - 1) / BP_TILE;
    const long long gx = (nw + BP_TILE - 1) / BP_TILE;
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy);
    block_prox_kernel<<<grid, BP_DTHREADS, 0, (cudaStream_t)stream>>>(
        (const int*)gl_q, (const double*)q, (const int*)gl_w,
        (const double*)w, (double*)out, nq, nw, n_trees);
    return (int)cudaGetLastError();
}

}  // extern "C"
