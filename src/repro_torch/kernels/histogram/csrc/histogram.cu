// Split histograms of the level-wise tree trainer (sm_90a), float32:
//   classes  H[node, f, b, c] = sum_i w[i]     * 1[node_i = node, xb[i, f] = b, y_i = c]
//   moments  H[node, f, b, k] = sum_i wm[i, k] * 1[node_i = node, xb[i, f] = b]
//
// Replaces the TPU kernels `histogram_pallas` and `moments_pallas`
// (src/repro/kernels/histogram/histogram.py, bodies `_hist_kernel` and
// `_moments_kernel`).  Those turn the scatter into a one-hot x one-hot MXU
// product over 512-sample tiles and carry the (nodes*C, D*bins) accumulator
// across a sequential grid.  That form is a TPU adaptation; here the scatter
// is done directly, which moves each (sample, feature) code once.
//
// Contract (what the trainer's bit-identity rests on):
//   * float32 accumulation; zero weights add nothing; empty nodes give 0;
//   * exact on integer payloads below 2^24 a bin (any order is exact there);
//   * deterministic for every payload: each bin is summed in a fixed order
//     (sample order within a segment, then segment by segment) with no
//     atomics, so every launch gives the same bits.
//
// Input layout: samples sorted by node (the wrapper sorts when they are not)
// and cut into work items: item i covers samples `items[3i] .. items[3i+1]`
// of one node and writes its histogram to row `items[3i+2]` of `out`.  A
// node of up to a segment's worth of samples is one item writing its own
// output row; a larger node is cut into equal segments writing partial rows
// past the n_nodes output rows, which `histogram_reduce_kernel` then sums
// into the node's row in segment order.  Sample j's codes are row `rows[j]`
// of the (N, D) code matrix (row j when `rows` is null), so the trainer
// passes its frontier's row ids and the gathered (m, D) codes never exist
// in device memory.
//
// What bounds it on the H100: bytes.  Each (sample, feature) pair costs one
// add, but reads a code byte at a scattered row, so the floor is the codes,
// row ids, labels and payloads read once plus the output written once.
// Design:
//   * one block per (item, feature slice); warp f of the block owns feature
//     f0 + f of the slice and walks the item's samples in order, 32 at a
//     time, one lane per sample; cutting large nodes into segments gives
//     the card enough blocks when a level has few nodes (the roots, or a
//     gradient-boosting stage's single root);
//   * lanes of a warp whose samples hit the same bin are ranked by lane
//     (`__match_any_sync`) and add in rank order, one round per rank with a
//     `__syncwarp` between rounds: no two lanes touch one bin in a round, and
//     a bin's adds run in sample order;
//   * the slice's histogram (Ds * B * C floats) lives in shared memory and is
//     written out once, coalesced; the slice width Ds is the widest that fits
//     a block's shared memory (at most 32 warps), so any D works.  When not
//     even one feature's histogram fits (B * C * 4 bytes past the limit), the
//     warps accumulate straight into the zeroed output in device memory,
//     with the same ownership and order;
//   * the block stages 128 samples at a time: their codes for the slice
//     ([feature][sample], padded so the staging stores and the per-warp reads
//     are free of bank conflicts), labels and payloads, loaded by all threads.
// Codes outside [0, B) and labels outside [0, C) add nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#define HIST_TILE 128
#define HIST_TILE_PAD (HIST_TILE + 1)
#define HIST_MAX_WARPS 32

template <typename CodeT, bool CLASSES, bool SMEM>
__global__ void __launch_bounds__(HIST_MAX_WARPS * 32)
histogram_kernel(const CodeT* __restrict__ xb, const int* __restrict__ rows,
                 const int* __restrict__ y, const float* __restrict__ vals,
                 const long long* __restrict__ items, float* __restrict__ out,
                 int D, int B, int C, int K, int Ds, int n_slices) {
    extern __shared__ float smem[];
    const int item = blockIdx.x / n_slices;
    const int f0 = (blockIdx.x - item * n_slices) * Ds;
    const int ds = min(Ds, D - f0);
    const int BC = B * C;
    const long long lo = items[3 * item], hi = items[3 * item + 1];
    float* const dst = out + (items[3 * item + 2] * D + f0) * BC;
    float* const hist = SMEM ? smem : dst;
    int* const s_code = (int*)(smem + (SMEM ? Ds * BC : 0));
    int* const s_y = s_code + Ds * HIST_TILE_PAD;
    float* const s_val = (float*)(s_y + (CLASSES ? HIST_TILE : 0));

    const int tid = threadIdx.x, nthr = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    if (SMEM)
        for (int e = tid; e < ds * BC; e += nthr) hist[e] = 0.f;

    for (long long s0 = lo; s0 < hi; s0 += HIST_TILE) {
        const int n = (int)min((long long)HIST_TILE, hi - s0);
        __syncthreads();                       // the previous tile is consumed
#pragma unroll 4
        for (int e = tid; e < n * ds; e += nthr) {
            const int j = e / ds, f = e - j * ds;     // a row's codes together
            const long long r = rows ? (long long)rows[s0 + j] : s0 + j;
            s_code[f * HIST_TILE_PAD + j] = (int)xb[r * D + f0 + f];
        }
        if (CLASSES)
            for (int e = tid; e < n; e += nthr) s_y[e] = y[s0 + e];
        for (int e = tid; e < n * K; e += nthr) s_val[e] = vals[s0 * K + e];
        __syncthreads();
        if (warp < ds) {
            float* const h = hist + (long long)warp * BC;
            const int* const codes = s_code + warp * HIST_TILE_PAD;
            for (int j0 = 0; j0 < n; j0 += 32) {
                const int j = j0 + lane;
                int key = -1 - lane;           // unique: matches no other lane
                if (j < n) {
                    const int c = codes[j];
                    if (CLASSES) {
                        const int yy = s_y[j];
                        if (c >= 0 && c < B && yy >= 0 && yy < C)
                            key = c * C + yy;
                    } else if (c >= 0 && c < B) {
                        key = c * C;
                    }
                }
                const unsigned peers = __match_any_sync(0xffffffffu, key);
                const int rank = __popc(peers & ((1u << lane) - 1u));
                const int rounds = __reduce_max_sync(0xffffffffu, rank) + 1;
                for (int r = 0; r < rounds; ++r) {
                    if (rank == r && key >= 0) {
                        if (CLASSES) {
                            h[key] += s_val[j];
                        } else {
                            for (int k = 0; k < K; ++k)
                                h[key + k] += s_val[j * K + k];
                        }
                    }
                    __syncwarp();
                }
            }
        }
    }
    if (SMEM) {
        __syncthreads();
        for (int e = tid; e < ds * BC; e += nthr) dst[e] = hist[e];
    }
}

// out[node] = sum over s < count of out[first + s], in s order; one
// (node, first, count) triple per cut node, `row` floats a row.
__global__ void histogram_reduce_kernel(float* __restrict__ out,
                                        const long long* __restrict__ red,
                                        long long row) {
    const long long* r = red + 3 * blockIdx.x;
    const long long e = (long long)blockIdx.y * blockDim.x + threadIdx.x;
    if (e >= row) return;
    const float* part = out + r[1] * row + e;
    float acc = 0.f;
    for (long long s = 0; s < r[2]; ++s) acc += part[s * row];
    out[r[0] * row + e] = acc;
}

template <typename CodeT, bool CLASSES, bool SMEM>
static int launch_t(const void* xb, const void* rows, const void* y,
                    const void* vals, const void* items, void* out,
                    int n_items, int D, int B, int C, int K, int Ds,
                    cudaStream_t stream) {
    const int n_slices = (D + Ds - 1) / Ds;
    const long long blocks = (long long)n_items * n_slices;
    if (blocks > 0x7fffffffLL || Ds < 1 || Ds > HIST_MAX_WARPS)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (
        (SMEM ? (size_t)Ds * B * C : 0) + (size_t)Ds * HIST_TILE_PAD
        + (CLASSES ? HIST_TILE : 0) + (size_t)HIST_TILE * K);
    auto kern = histogram_kernel<CodeT, CLASSES, SMEM>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)blocks, Ds * 32, smem, stream>>>(
        (const CodeT*)xb, (const int*)rows, (const int*)y,
        (const float*)vals, (const long long*)items, (float*)out, D, B, C,
        K, Ds, n_slices);
    return (int)cudaGetLastError();
}

template <bool CLASSES>
static int launch(int code_bytes, int smem_acc, const void* xb,
                  const void* rows, const void* y, const void* vals,
                  const void* items, void* out, int n_items, int D, int B,
                  int C, int K, int Ds, void* stream) {
    if (n_items <= 0 || D <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
#define HIST_CASE(T)                                                        \
    return smem_acc                                                         \
        ? launch_t<T, CLASSES, true>(xb, rows, y, vals, items, out,         \
                                     n_items, D, B, C, K, Ds, s)            \
        : launch_t<T, CLASSES, false>(xb, rows, y, vals, items, out,        \
                                      n_items, D, B, C, K, Ds, s);
    switch (code_bytes) {
        case 1: HIST_CASE(uint8_t)
        case 2: HIST_CASE(int16_t)
        case 4: HIST_CASE(int32_t)
    }
#undef HIST_CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// xb (N, D) codes of `code_bytes` bytes (uint8, int16 or int32), row-major;
// rows (m,) int32 or null; y (m,) int32; w (m,) f32; items (n_items, 3)
// int64 (first sample, end sample, output row); out (rows, D, B, C) f32,
// zeroed by the caller when !smem_acc.
int histogram_classes(const void* xb, int code_bytes, const void* rows,
                      const void* y, const void* w, const void* items,
                      void* out, int n_items, int D, int B, int C, int Ds,
                      int smem_acc, void* stream) {
    return launch<true>(code_bytes, smem_acc, xb, rows, y, w, items, out,
                        n_items, D, B, C, 1, Ds, stream);
}

// As above with wm (m, K) f32 payload columns in place of y / w; out
// (rows, D, B, K) f32.
int histogram_moments(const void* xb, int code_bytes, const void* rows,
                      const void* wm, const void* items, void* out,
                      int n_items, int D, int B, int K, int Ds, int smem_acc,
                      void* stream) {
    return launch<false>(code_bytes, smem_acc, xb, rows, nullptr, wm, items,
                         out, n_items, D, B, K, K, Ds, stream);
}

// Sum the partial rows of each cut node into its output row: red (n_red, 3)
// int64 (node, first partial row, count), rows of `row` floats.
int histogram_reduce(void* out, const void* red, int n_red, long long row,
                     void* stream) {
    if (n_red <= 0 || row <= 0) return (int)cudaSuccess;
    const long long gy = (row + 255) / 256;
    if (gy > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
    dim3 grid((unsigned)n_red, (unsigned)gy);
    histogram_reduce_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (float*)out, (const long long*)red, row);
    return (int)cudaGetLastError();
}

}  // extern "C"
