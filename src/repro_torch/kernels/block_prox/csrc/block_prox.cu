// Dense SWLC proximity block in float64 (sm_90a):
//     P[i, j] = sum_t q[i, t] * w[j, t] * 1[gl_q[i, t] == gl_w[j, t]].
//
// Replaces the TPU kernel `block_prox_pallas` (src/repro/kernels/block_prox/
// block_prox.py, body `_block_prox_kernel`), which holds (256, T) tiles of
// both sides in VMEM and accumulates (256, 256, 8) masked broadcasts on the
// VPU in float32 (the TPU has no float64 vector unit).  Here the engine's
// float64 is kept end to end.
//
// What bounds it on the H100: Nq * Nw * T integer compares with a float64
// multiply-add on each collision; the inputs are small ((Nq + Nw) * T * 12
// bytes) and the output is Nq * Nw * 8 bytes, so at T = 100 the compares,
// not the bytes, set the floor.  Design:
//   * one block of 256 threads per 64 x 64 output tile;
//   * a loop over chunks of 16 trees stages the chunk's leaf ids and weights
//     of the tile's 64 query rows and 64 reference rows in shared memory,
//     transposed to [tree][row] and padded by one so the staging stores and
//     the per-tree reads are free of bank conflicts;
//   * each thread keeps a 4 x 4 register micro-tile of float64 accumulators
//     (rows ty + 16a, columns tx + 16b), so one tree step costs it 8 shared
//     loads for 16 compare-and-FMA;
//   * ragged edges are masked while staging: query rows past Nq get leaf -1,
//     reference rows past Nw get -2, trees past T get both, with zero
//     weights, so padded entries never collide and nothing past the edges is
//     read or written.
// There is no (rows, cols, t_chunk) intermediate, so callers size row chunks
// by output bytes alone.
#include <cuda_runtime.h>
#include <stdint.h>

#define BP_TILE 64
#define BP_TCH 16
#define BP_THREADS 256
#define BP_PAD (BP_TILE + 1)

__global__ void __launch_bounds__(BP_THREADS)
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
        // stage: 64 rows x 16 trees per array, 4 elements per thread; a warp
        // reads 2 rows x 16 consecutive trees of each array
        for (int e = threadIdx.x; e < BP_TILE * BP_TCH; e += BP_THREADS) {
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

// gl_q (nq, T) int32, q (nq, T) f64, gl_w (nw, T) int32, w (nw, T) f64, all
// row-major and contiguous; out (nq, nw) f64 row-major.
int block_prox(const void* gl_q, const void* q, const void* gl_w,
               const void* w, void* out, long long nq, long long nw,
               int n_trees, void* stream) {
    if (nq <= 0 || nw <= 0) return (int)cudaSuccess;
    const long long gy = (nq + BP_TILE - 1) / BP_TILE;
    const long long gx = (nw + BP_TILE - 1) / BP_TILE;
    if (gy > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
    dim3 grid((unsigned)gx, (unsigned)gy);
    block_prox_kernel<<<grid, BP_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)gl_q, (const double*)q, (const int*)gl_w,
        (const double*)w, (double*)out, nq, nw, n_trees);
    return (int)cudaGetLastError();
}

}  // extern "C"
