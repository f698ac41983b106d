// Batched root-to-leaf routing of samples through a tree ensemble (sm_90a).
//
// Replaces the TPU kernel `route_pallas` (src/repro/kernels/leaf_route/
// leaf_route.py, body `_route_kernel`).  That kernel runs `max_depth`
// branch-free gather/compare/select steps for every lane and compares in
// float32 (a TPU limit).  This one follows the reference's default host
// routing instead (`_route_batched_numpy`, `route_native`): each walk
// follows its own path and stops at its leaf, comparing the float64 sample
// value against the float32 threshold widened to float64 in a register,
// with `!(x <= thr)` going right so NaN goes right.  It is compiled without
// fast-math.
//
// Nodes come as one 16-byte record each (ops.py::pack_nodes): int4 {float32
// threshold bits, feature (-1 = leaf), left, right}, children as global ids
// g = t * M + n, a leaf's id in its left field.
//
// What bounds it on the H100: a dependent chain per walk (node record, then
// the sample's feature value, then the child's record), so latency, not
// bandwidth; the bytes that must move are X (N*D*8) read once, the node
// records, and the (N, T) int32 output.  Design:
//   * one 128-bit load a level brings a node's threshold, feature and both
//     children, where four arrays took four loads;
//   * the block's samples are staged once, transposed to [feature][sample]
//     in shared memory, so `x[f]` is a shared load and a warp's 32 samples
//     read 32 consecutive words whatever features they ask for (no bank
//     conflict); when D is too wide for 32 samples (ops.py::route_plan) the
//     STAGED=false instance reads the sample's row through L2 instead;
//   * a thread advances RT_U independent walks (one sample, RT_U trees) in
//     lock step, so their L2 loads overlap; each walk stops at its leaf and
//     all are capped at M steps like the reference;
//   * grid = (sample tiles, tree groups of up to RT_TREES); the leaf ids are
//     collected in a shared (tile x RT_TREES) table and written as rows of
//     consecutive int32, not one strided store per walk.
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_THREADS 256
#define RT_TREES 32
#define RT_U 4
#define RT_OUT_STRIDE (RT_TREES + 1)   // padded: no bank conflicts
#define RT_TILE_MAX 64

template <bool STAGED>
__global__ void __launch_bounds__(RT_THREADS)
leaf_route_kernel(const double* __restrict__ X,
                  const int4* __restrict__ nodes, int* __restrict__ out,
                  long long n, int d, int n_trees, int max_nodes,
                  int tile_log2, int tb) {
    extern __shared__ double s_x[];                 // [d][tile]
    __shared__ int s_out[RT_TILE_MAX * RT_OUT_STRIDE];

    const int tile = 1 << tile_log2;
    const int lanes = RT_THREADS >> tile_log2;      // threads a sample
    const long long n0 = (long long)blockIdx.x * tile;
    const int t0 = blockIdx.y * tb;
    const int nt = min(tb, n_trees - t0);
    const int s = threadIdx.x & (tile - 1);
    const int g = threadIdx.x >> tile_log2;
    const long long i = n0 + s;
    const bool active = i < n;

    if (STAGED) {
        for (int k = threadIdx.x; k < tile * d; k += RT_THREADS) {
            const long long row = n0 + (k & (tile - 1));
            s_x[k] = row < n ? X[row * d + (k >> tile_log2)] : 0.0;
        }
        __syncthreads();
    }
    const double* xs = STAGED ? s_x + s : X + (active ? i : 0) * (long long)d;
    const int xstep = STAGED ? tile : 1;
    const int4* roots = nodes + (long long)t0 * max_nodes;

    for (int k0 = g; k0 < nt; k0 += lanes * RT_U) {
        int4 nd[RT_U];
#pragma unroll
        for (int u = 0; u < RT_U; ++u) {
            const int tt = k0 + u * lanes;
            nd[u] = active && tt < nt
                ? __ldg(roots + (long long)tt * max_nodes)
                : make_int4(0, -1, 0, 0);
        }
        for (int step = 0; step < max_nodes; ++step) {
            bool more = false;
#pragma unroll
            for (int u = 0; u < RT_U; ++u) {
                if (nd[u].y >= 0) {
                    more = true;
                    const double xv = xs[nd[u].y * xstep];
                    const bool right =
                        !(xv <= (double)__int_as_float(nd[u].x));
                    nd[u] = __ldg(nodes + (right ? nd[u].w : nd[u].z));
                }
            }
            if (!more) break;
        }
#pragma unroll
        for (int u = 0; u < RT_U; ++u) {
            const int tt = k0 + u * lanes;
            if (tt < nt) s_out[s * RT_OUT_STRIDE + tt] = nd[u].z;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < tile * RT_TREES; k += RT_THREADS) {
        const int r = k / RT_TREES, c = k % RT_TREES;
        const long long row = n0 + r;
        if (row < n && c < nt)
            out[row * n_trees + t0 + c] = s_out[r * RT_OUT_STRIDE + c];
    }
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// X (n, d) f64 row-major; nodes (n_trees * max_nodes) int4 records; out
// (n, n_trees) int32.  tile_log2, tb and staged come from
// ops.py::route_plan (tile <= RT_TILE_MAX samples, tb <= RT_TREES trees).
int leaf_route(const void* X, const void* nodes, void* out, long long n,
               int d, int n_trees, int max_nodes, int tile_log2, int tb,
               int staged, void* stream) {
    if (n <= 0 || n_trees <= 0) return (int)cudaSuccess;
    const int tile = 1 << tile_log2;
    if (tile < 32 || tile > RT_TILE_MAX || tb < 1 || tb > RT_TREES)
        return (int)cudaErrorInvalidValue;
    const long long gy = (n_trees + tb - 1) / tb;
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((n + tile - 1) / tile), (unsigned)gy);
    if (staged) {
        // up to 48 KB of samples on top of the static leaf table
        static bool smem_set = false;
        const size_t smem = (size_t)tile * d * sizeof(double);
        if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
        if (!smem_set) {
            const cudaError_t e = cudaFuncSetAttribute(
                leaf_route_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, 48 * 1024);
            if (e != cudaSuccess) return (int)e;
            smem_set = true;
        }
        leaf_route_kernel<true><<<grid, RT_THREADS, smem,
                                  (cudaStream_t)stream>>>(
            (const double*)X, (const int4*)nodes, (int*)out, n, d, n_trees,
            max_nodes, tile_log2, tb);
    } else {
        leaf_route_kernel<false><<<grid, RT_THREADS, 0,
                                   (cudaStream_t)stream>>>(
            (const double*)X, (const int4*)nodes, (int*)out, n, d, n_trees,
            max_nodes, tile_log2, tb);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
