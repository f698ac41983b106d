// Batched root-to-leaf routing of samples through a tree ensemble (sm_90a).
//
// Replaces the TPU kernel `route_pallas` (src/repro/kernels/leaf_route/
// leaf_route.py, body `_route_kernel`).  That kernel runs `max_depth`
// branch-free gather/compare/select steps for every lane and compares in
// float32 (a TPU limit).  This one follows the reference's default host
// routing instead (`_route_batched_numpy`, `route_native`): each lane walks
// its own path and stops at its leaf, comparing the float64 sample value
// against the float64-widened float32 threshold, with `!(x <= thr)` going
// right so NaN goes right.  It is compiled without fast-math.
//
// Inputs are the flat node tables of `TreeArrays.flat()`: global node id
// g = t * M + n, `lr[2g] = left`, `lr[2g + 1] = right` (global ids).
//
// What bounds it on the H100: a dependent chain of loads per lane (node
// fields, then the sample's feature value), so latency, not bandwidth; the
// bytes that must move are X (N*D*8) read once, the node tables, and the
// (N, T) int32 output.  Design:
//   * grid = (sample tiles of 256, tree groups of 8); a block routes its 256
//     samples through its trees one tree at a time, so all lanes of a block
//     walk one tree's nodes together and share its L2 lines;
//   * node tables are read through L2 at every tree size: the acceptance
//     forest (X and all trees) fits the 50 MB L2, and staging a tree in
//     shared memory for each block measured slower (PERF.md), since a block
//     reloads the whole tree to route 256 samples through a few levels;
//   * each lane exits at its leaf (no fixed depth), capped at M steps like
//     the reference;
//   * leaf ids are collected in a shared (256 x 8) tile and written as rows
//     of 8 consecutive int32 (one 32-byte sector each), not one strided
//     4-byte store per lane.
#include <cuda_runtime.h>
#include <stdint.h>

#define ROUTE_TILE_N 256
#define ROUTE_TREES 8
#define ROUTE_OUT_STRIDE (ROUTE_TREES + 1)   // padded: no bank conflicts

__global__ void __launch_bounds__(ROUTE_TILE_N)
leaf_route_kernel(const double* __restrict__ X, const int* __restrict__ feature,
                  const double* __restrict__ threshold, const int* __restrict__ lr,
                  const int* __restrict__ leaf_id, int* __restrict__ out,
                  long long n, int d, int n_trees, int max_nodes) {
    __shared__ int s_out[ROUTE_TILE_N * ROUTE_OUT_STRIDE];

    const long long n0 = (long long)blockIdx.x * ROUTE_TILE_N;
    const int t0 = blockIdx.y * ROUTE_TREES;
    const int nt = min(ROUTE_TREES, n_trees - t0);
    const long long i = n0 + threadIdx.x;
    const bool active = i < n;
    const double* x = X + (active ? i : 0) * (long long)d;

    for (int tt = 0; tt < nt; ++tt) {
        int leaf = 0;
        if (active) {
            long long node = (long long)(t0 + tt) * max_nodes;
            int f = feature[node];
            for (int step = 0; f >= 0 && step < max_nodes; ++step) {
                const bool right = !(x[f] <= threshold[node]);
                node = lr[2 * node + (right ? 1 : 0)];
                f = feature[node];
            }
            leaf = leaf_id[node];
        }
        s_out[threadIdx.x * ROUTE_OUT_STRIDE + tt] = leaf;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < ROUTE_TILE_N * ROUTE_TREES; k += ROUTE_TILE_N) {
        const int r = k / ROUTE_TREES, c = k % ROUTE_TREES;
        const long long row = n0 + r;
        if (row < n && c < nt)
            out[row * n_trees + t0 + c] = s_out[r * ROUTE_OUT_STRIDE + c];
    }
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// out (n, n_trees) int32.
int leaf_route(const void* X, const void* feature, const void* threshold,
               const void* lr, const void* leaf_id, void* out, long long n,
               int d, int n_trees, int max_nodes, void* stream) {
    if (n <= 0 || n_trees <= 0) return (int)cudaSuccess;
    dim3 grid((unsigned)((n + ROUTE_TILE_N - 1) / ROUTE_TILE_N),
              (unsigned)((n_trees + ROUTE_TREES - 1) / ROUTE_TREES));
    leaf_route_kernel<<<grid, ROUTE_TILE_N, 0, (cudaStream_t)stream>>>(
        (const double*)X, (const int*)feature, (const double*)threshold,
        (const int*)lr, (const int*)leaf_id, (int*)out, n, d, n_trees,
        max_nodes);
    return (int)cudaGetLastError();
}

}  // extern "C"
