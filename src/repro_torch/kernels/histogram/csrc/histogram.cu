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
//     (sample order within a segment, then segment by segment from 0) with
//     no float atomics, so every launch on every card, in either mode below,
//     gives the same bits: those of the ordered oracle
//     `ref.py::histogram_ordered` / `moments_ordered`.
//
// Input layout: samples sorted by node and cut into work items: item i
// covers samples `items[3i] .. items[3i+1]` of one node and writes its
// histogram to row `items[3i+2]` of `out`.  A node of up to a segment's worth
// of samples is one item writing its own output row; a larger node is cut
// into equal segments writing partial rows past the n_nodes output rows,
// which `histogram_reduce_kernel` then sums into the node's row in segment
// order.  Sample j's codes are row `rows[j]` (int32 or int64 ids) of the
// (N, D) code matrix (row j when `rows` is null), so the trainer passes its
// frontier's row ids and the gathered (m, D) codes never exist in device
// memory.  A work unit is (item, feature slice); a persistent grid of as
// many blocks as fit the card at once walks the units in a fixed stride.
// Which block takes a unit changes no sum.
//
// What bounds it on the H100: bytes, by the floor (codes, row ids, labels
// and payloads read once, the table written once).  In practice it is the
// fixed order: each (unit, feature) table takes its adds one sample after
// another.  Two modes, both staging through `cp.async`, so that the row id
// -> code row gathers of later samples are in flight while earlier ones
// are added (TMA does not serve: Hopper's tiled copies move boxes of a
// tensor and cannot gather rows by id), and both reading a sample's slice
// of codes as 32-bit words when rows and slices are 4-byte aligned (5
// words a row for 20 uint8 features; element by element otherwise):
//
//   * fold (`histogram_fold_kernel`, when the launch has enough units to
//     fill the card): a block is one warp, and lane f owns the table of feature
//     f0 + f (of one payload column of it, for the moments) and folds the
//     unit's samples into it in order.  No two lanes share a bin, so there
//     is nothing to rank and no barrier in the fold; each bin is read one
//     sample early, and a stale read (the previous sample on the same bin)
//     takes that sample's sum instead.  Batches of 32 samples, one a lane;
//     row ids, labels and payloads are issued 4 batches ahead, codes 2,
//     one `__syncwarp` a batch.  Concurrency is the units times the slice
//     width, so few units (a GBT stage's nodes) would leave the card idle;
//   * rank (`histogram_rank_kernel`, otherwise): a block is Ds warps,
//     warp f owns feature f0 + f and walks the unit's samples 32 at a
//     time, a lane a sample.  Lanes on one bin add in lane order: in each
//     round every waiting lane posts its lane id to a 128-slot tag table
//     with a shared `atomicMin` (the slot is a function of the bin, so
//     lanes on one bin meet there), the lowest lane of each slot adds and
//     leaves, the rest go again: one round when the 32 bins differ.
//     (Finding the groups with `__match_any_sync` instead, as the first
//     Hopper design did, spent most of the kernel's time in that
//     instruction.)  Tiles of 256 samples, one thread a sample; row ids,
//     labels and payloads 2 tiles ahead, codes 1, one `__syncthreads` a
//     tile.
//
// The slice's histogram (Ds * B * C floats) lives in shared memory and is
// written out once, coalesced; the slice width Ds is the widest that fits,
// so any D works.  When not even one feature's table fits, the rank mode
// accumulates straight into the zeroed output with the same ownership and
// order.  Codes outside [0, B) and labels outside [0, C) add nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define HIST_TILE 256        // rank: samples staged a step, one a thread
#define HIST_WARPS 32        // rank: features of a slice, one a warp
#define HIST_TAGS 128        // rank: tag slots of a warp
#define HIST_BATCH 32        // fold: samples staged a step, one a lane
#define HIST_LANES 32        // fold: (feature, column) tables, one a lane
#define HIST_MAX_DEVICES 64

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory of a block, in this order: row ids [META][STEP] (8 bytes
// each; int32 ids packed in the slot's first half), codes
// [CODE][STEP * words], labels [META][STEP] (classes only), payloads
// [META][STEP * K], then for rank the tag tables [Ds][TAGS] and the
// histogram [Ds][B * C], for fold the histogram [Ds][B * C | 1] (a
// feature's table at an odd stride, so lanes on equal bins hit different
// banks).  META, CODE, STEP: 3, 2, TILE for rank; 5, 3, BATCH for fold.
// `ops.py::smem_bytes` computes the same.
static size_t smem_size(bool fold, bool classes, bool smem_acc, int Ds,
                        int B, int C, int K, int words) {
    const size_t meta = fold ? 5 : 3, code = fold ? 3 : 2;
    const size_t step = fold ? HIST_BATCH : HIST_TILE;
    return step * (meta * (sizeof(long long) + sizeof(float) * K
                           + (classes ? sizeof(int) : 0))
                   + code * sizeof(unsigned) * words)
        + (fold ? 0 : sizeof(int) * HIST_TAGS * (size_t)Ds)
        + (smem_acc ? sizeof(float) * (size_t)Ds
                          * (fold ? ((B * C) | 1) : B * C) : 0);
}

template <typename CodeT, bool CLASSES, bool SMEM>
__global__ void __launch_bounds__(HIST_WARPS * 32, 2)
histogram_rank_kernel(const CodeT* __restrict__ xb,
                      const void* __restrict__ rows, int rows64,
                      const int* __restrict__ y,
                      const float* __restrict__ vals,
                      const long long* __restrict__ items,
                      float* __restrict__ out, int n_units, int D, int B,
                      int C, int K, int Ds, int n_slices, int words,
                      int vec) {
    constexpr int META = 3, CODE = 2;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    long long* const s_rows = (long long*)smem_raw;
    unsigned* const s_code = (unsigned*)(s_rows + META * HIST_TILE);
    int* const s_y = (int*)(s_code + CODE * HIST_TILE * words);
    float* const s_val = (float*)(s_y + (CLASSES ? META * HIST_TILE : 0));
    int* const s_tag = (int*)(s_val + META * HIST_TILE * K);
    float* const s_hist = (float*)(s_tag + HIST_TAGS * Ds);

    const int BC = B * C;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int elem = (int)sizeof(CodeT);
    for (int e = tid; e < HIST_TAGS * Ds; e += nthr) s_tag[e] = 32;

    for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
        const int item = unit / n_slices;
        const int f0 = (unit - item * n_slices) * Ds;
        const int ds = min(Ds, D - f0);
        const long long lo = items[3 * item], hi = items[3 * item + 1];
        float* const dst = out + (items[3 * item + 2] * D + f0) * BC;
        float* const hist = SMEM ? s_hist : dst;
        const int n_tiles = (int)((hi - lo + HIST_TILE - 1) / HIST_TILE);
        const int nw = (ds * elem + 3) >> 2;

        // row ids, labels and payloads of tile t into meta slot t % 3
        auto stage_meta = [&](int t) {
            if (t >= n_tiles) return;
            const long long s0 = lo + (long long)t * HIST_TILE;
            const int n = (int)min((long long)HIST_TILE, hi - s0);
            const int slot = (t % META) * HIST_TILE;
            if (rows) {
                for (int j = tid; j < n; j += nthr) {
                    if (rows64)
                        cp_async8(s_rows + slot + j,
                                  (const long long*)rows + s0 + j);
                    else
                        cp_async4((int*)(s_rows + slot) + j,
                                  (const int*)rows + s0 + j);
                }
            }
            if (CLASSES)
                for (int j = tid; j < n; j += nthr)
                    cp_async4(s_y + slot + j, y + s0 + j);
            for (int e = tid; e < n * K; e += nthr)
                cp_async4(s_val + slot * K + e, vals + s0 * K + e);
        };

        // the slice's codes of tile t into code slot t % 2, each row by the
        // thread that staged its row id
        auto gather = [&](int t) {
            if (t >= n_tiles) return;
            const long long s0 = lo + (long long)t * HIST_TILE;
            const int n = (int)min((long long)HIST_TILE, hi - s0);
            const long long* r64 = s_rows + (t % META) * HIST_TILE;
            unsigned* c = s_code + (t % CODE) * HIST_TILE * words;
            for (int j = tid; j < n; j += nthr) {
                const long long r = !rows ? s0 + j : rows64 ? r64[j]
                    : (long long)((const int*)r64)[j];
                const CodeT* src = xb + r * D + f0;
                unsigned* to = c + j * words;
                if (vec) {
                    for (int q = 0; q < nw; ++q)
                        cp_async4(to + q, (const unsigned*)src + q);
                } else {
                    CodeT* tc = (CodeT*)to;
                    for (int f = 0; f < ds; ++f) tc[f] = src[f];
                }
            }
        };

        // warp f adds tile t's samples to feature f0 + f's bins, in order
        auto rank = [&](int t) {
            if (warp >= ds) return;
            const long long s0 = lo + (long long)t * HIST_TILE;
            const int n = (int)min((long long)HIST_TILE, hi - s0);
            const int slot = (t % META) * HIST_TILE;
            const unsigned char* cb = (const unsigned char*)(
                s_code + (t % CODE) * HIST_TILE * words) + warp * elem;
            const float* v = s_val + slot * K;
            float* const h = hist + (long long)warp * BC;
            int* const tag = s_tag + warp * HIST_TAGS;
            for (int j0 = 0; j0 < n; j0 += 32) {
                const int j = j0 + lane;
                int key = -1, at = 0;
                if (j < n) {
                    const int c = (int)*(const CodeT*)(
                        cb + (size_t)j * words * 4);
                    if (CLASSES) {
                        const int yj = s_y[slot + j];
                        if (c >= 0 && c < B && yj >= 0 && yj < C)
                            key = c * C + yj;
                        at = key & (HIST_TAGS - 1);
                    } else if (c >= 0 && c < B) {
                        key = c * C;
                        at = c & (HIST_TAGS - 1);
                    }
                }
                // rounds: the lowest waiting lane of each tag slot adds; the
                // tag table is back to 32 everywhere when the loop ends
                unsigned wait = __ballot_sync(0xffffffffu, key >= 0);
                while (wait) {
                    const bool mine = (wait >> lane) & 1u;
                    if (mine) atomicMin(tag + at, lane);
                    __syncwarp();
                    const bool win = mine && tag[at] == lane;
                    __syncwarp();
                    if (win) {
                        if (CLASSES) {
                            h[key] += v[j];
                        } else {
                            for (int k = 0; k < K; ++k)
                                h[key + k] += v[j * K + k];
                        }
                        tag[at] = 32;
                    }
                    wait &= ~__ballot_sync(0xffffffffu, win);
                    __syncwarp();
                }
            }
        };

        if (SMEM)
            for (int e = tid; e < ds * BC; e += nthr) s_hist[e] = 0.f;
        stage_meta(0);
        stage_meta(1);
        cp_async_commit();
        cp_async_wait<0>();
        gather(0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int t = 0; t < n_tiles; ++t) {
            gather(t + 1);          // row ids of t+1 landed at the last wait
            stage_meta(t + 2);      // slot of t-1: consumed before the barrier
            cp_async_commit();
            rank(t);
            cp_async_wait<0>();
            __syncthreads();        // tile t consumed, tile t+1 visible
        }
        if (SMEM) {
            for (int e = tid; e < ds * BC; e += nthr) dst[e] = s_hist[e];
            __syncthreads();
        }
    }
}

// h[key[j]] += val[j] for j = 0, 1, ..., in that order (key -1: nothing).
// A plain loop would wait, each sample, for its store before the next
// sample's read of the table; here each bin is read one sample early, and
// a read that the previous sample's store made stale (the same bin) takes
// that store's sum instead, so the float adds and their order are the
// plain loop's.
__device__ __forceinline__ void fold(float* h, const int (&key)[HIST_BATCH],
                                     const float (&val)[HIST_BATCH]) {
    float pre = key[0] >= 0 ? h[key[0]] : 0.f, put = 0.f;
    int put_key = -1;
#pragma unroll
    for (int j = 0; j < HIST_BATCH; ++j) {
        const float ahead =
            (j + 1 < HIST_BATCH && key[j + 1] >= 0) ? h[key[j + 1]] : 0.f;
        if (key[j] >= 0) {
            const float cur = (put_key == key[j] ? put : pre) + val[j];
            h[key[j]] = cur;
            put = cur;
        }
        put_key = key[j];
        pre = ahead;
    }
}

template <typename CodeT, bool CLASSES, bool SMEM>
__global__ void __launch_bounds__(HIST_BATCH)
histogram_fold_kernel(const CodeT* __restrict__ xb,
                      const void* __restrict__ rows, int rows64,
                      const int* __restrict__ y,
                      const float* __restrict__ vals,
                      const long long* __restrict__ items,
                      float* __restrict__ out, int n_units, int D, int B,
                      int C, int K, int Ds, int n_slices, int words,
                      int vec) {
    constexpr int META = 5, CODE = 3;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    long long* const s_rows = (long long*)smem_raw;
    unsigned* const s_code = (unsigned*)(s_rows + META * HIST_BATCH);
    int* const s_y = (int*)(s_code + CODE * HIST_BATCH * words);
    float* const s_val = (float*)(s_y + (CLASSES ? META * HIST_BATCH : 0));
    float* const s_hist = s_val + META * HIST_BATCH * K;

    const int BC = B * C;
    const int stride = SMEM ? (BC | 1) : BC;     // a feature's table
    const int lane = threadIdx.x;
    // lane -> (feature, payload column): the moments give each column of a
    // feature its own lane (at most 32 a feature; more take turns)
    const int per = CLASSES ? 1 : min(K, HIST_LANES);
    const int lf = lane / per, lk = lane - lf * per;
    constexpr int elem = (int)sizeof(CodeT);

    for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
        const int item = unit / n_slices;
        const int f0 = (unit - item * n_slices) * Ds;
        const int ds = min(Ds, D - f0);
        const long long lo = items[3 * item], hi = items[3 * item + 1];
        float* const dst = out + (items[3 * item + 2] * D + f0) * BC;
        float* const hist = SMEM ? s_hist : dst;
        const int n_batches = (int)((hi - lo + HIST_BATCH - 1) / HIST_BATCH);
        const int nw = (ds * elem + 3) >> 2;

        // row id, label and payloads of batch b's sample `lane`
        auto stage_meta = [&](int b) {
            const long long s = lo + (long long)b * HIST_BATCH + lane;
            if (b >= n_batches || s >= hi) return;
            const int slot = (b % META) * HIST_BATCH;
            if (rows) {
                if (rows64)
                    cp_async8(s_rows + slot + lane, (const long long*)rows + s);
                else
                    cp_async4((int*)(s_rows + slot) + lane,
                              (const int*)rows + s);
            }
            if (CLASSES) cp_async4(s_y + slot + lane, y + s);
            for (int k = 0; k < K; ++k)
                cp_async4(s_val + (slot + lane) * K + k, vals + s * K + k);
        };

        // the slice's codes of batch b's sample `lane`, by the lane that
        // staged its row id
        auto gather = [&](int b) {
            const long long s = lo + (long long)b * HIST_BATCH + lane;
            if (b >= n_batches || s >= hi) return;
            const long long* r64 = s_rows + (b % META) * HIST_BATCH;
            const long long r = !rows ? s : rows64 ? r64[lane]
                : (long long)((const int*)r64)[lane];
            const CodeT* src = xb + r * D + f0;
            unsigned* to = s_code + ((b % CODE) * HIST_BATCH + lane) * words;
            if (vec) {
                for (int q = 0; q < nw; ++q)
                    cp_async4(to + q, (const unsigned*)src + q);
            } else {
                CodeT* tc = (CodeT*)to;
                for (int f = 0; f < ds; ++f) tc[f] = src[f];
            }
        };

        if (SMEM)
            for (int e = lane; e < ds * stride; e += HIST_BATCH)
                s_hist[e] = 0.f;
        // group g (committed in step g) holds the metadata of batch g + 4
        // and the codes of batch g + 2; step b waits for group b - 2, which
        // completes the codes of b and the row ids of b + 2
        stage_meta(0);
        stage_meta(1);
        cp_async_commit();
        cp_async_wait<0>();
        stage_meta(2);
        gather(0);
        cp_async_commit();
        stage_meta(3);
        gather(1);
        cp_async_commit();
        for (int b = 0; b < n_batches; ++b) {
            cp_async_wait<1>();
            __syncwarp();           // batch b visible; batch b-1 folded
            gather(b + 2);
            stage_meta(b + 4);
            cp_async_commit();
            if (lf < ds) {
                const int n = (int)min((long long)HIST_BATCH,
                                       hi - lo - (long long)b * HIST_BATCH);
                const int slot = (b % META) * HIST_BATCH;
                const unsigned char* cb = (const unsigned char*)(
                    s_code + (b % CODE) * HIST_BATCH * words) + lf * elem;
                float* const h = hist + (long long)lf * stride;
                for (int k = lk; k < (CLASSES ? 1 : K); k += per) {
                    int key[HIST_BATCH];
                    float val[HIST_BATCH];
#pragma unroll
                    for (int j = 0; j < HIST_BATCH; ++j) {
                        key[j] = -1;
                        val[j] = 0.f;
                        if (j < n) {
                            const int c = (int)*(const CodeT*)(
                                cb + j * words * 4);
                            if (CLASSES) {
                                const int yj = s_y[slot + j];
                                if (c >= 0 && c < B && yj >= 0 && yj < C)
                                    key[j] = c * C + yj;
                                val[j] = s_val[slot + j];
                            } else {
                                if (c >= 0 && c < B) key[j] = c * C + k;
                                val[j] = s_val[(slot + j) * K + k];
                            }
                        }
                    }
                    fold(h, key, val);
                }
            }
        }
        cp_async_wait<0>();
        __syncwarp();
        if (SMEM) {
            for (int f = 0; f < ds; ++f)
                for (int e = lane; e < BC; e += HIST_BATCH)
                    dst[(long long)f * BC + e] = s_hist[f * stride + e];
            __syncwarp();
        }
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

template <typename CodeT, bool CLASSES, bool SMEM, bool FOLD>
static int launch_t(const void* xb, const void* rows, int rows64,
                    const void* y, const void* vals, const void* items,
                    void* out, int n_items, int D, int B, int C, int K,
                    int Ds, cudaStream_t stream) {
    const int n_slices = (D + Ds - 1) / Ds;
    const long long units = (long long)n_items * n_slices;
    const int per = FOLD && !CLASSES ? (K < HIST_LANES ? K : HIST_LANES) : 1;
    if (units > 0x7fffffffLL || Ds < 1 || K < 1
        || (FOLD ? Ds * per > HIST_LANES : Ds > HIST_WARPS))
        return (int)cudaErrorInvalidValue;
    const int elem = (int)sizeof(CodeT);
    const int words = ((Ds * elem + 3) / 4) | 1;
    const int vec = (D * elem) % 4 == 0 && (Ds * elem) % 4 == 0
        && ((uintptr_t)xb & 3) == 0;
    const size_t smem = smem_size(FOLD, CLASSES, SMEM, Ds, B, C, K, words);
    const int threads = FOLD ? HIST_BATCH : Ds * 32;
    auto kern = FOLD ? histogram_fold_kernel<CodeT, CLASSES, SMEM>
                     : histogram_rank_kernel<CodeT, CLASSES, SMEM>;
    // Per device, the largest dynamic shared memory this kernel was allowed
    // so far and its last grid size query: a launch of the same shape pays
    // neither host call again.  (The grid size changes no result: the
    // blocks stride over the units.)
    static std::mutex mu;
    static size_t allowed[HIST_MAX_DEVICES];
    static int seen_threads[HIST_MAX_DEVICES];
    static size_t seen_smem[HIST_MAX_DEVICES];
    static long long seen_slots[HIST_MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= HIST_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    long long slots;
    {
        std::lock_guard<std::mutex> hold(mu);
        if (smem > allowed[dev]) {
            err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
            allowed[dev] = smem;
        }
        if (seen_threads[dev] != threads || seen_smem[dev] != smem) {
            int sms = 0, per_sm = 0;
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
            if (err != cudaSuccess) return (int)err;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kern, threads, smem);
            if (err != cudaSuccess) return (int)err;
            seen_threads[dev] = threads;
            seen_smem[dev] = smem;
            seen_slots[dev] = (long long)sms * (per_sm > 0 ? per_sm : 1);
        }
        slots = seen_slots[dev];
    }
    const unsigned grid = (unsigned)(units < slots ? units : slots);
    kern<<<grid, threads, smem, stream>>>(
        (const CodeT*)xb, rows, rows64, (const int*)y, (const float*)vals,
        (const long long*)items, (float*)out, (int)units, D, B, C, K, Ds,
        n_slices, words, vec);
    return (int)cudaGetLastError();
}

template <bool CLASSES>
static int launch(int code_bytes, int smem_acc, int fold, const void* xb,
                  const void* rows, int rows64, const void* y,
                  const void* vals, const void* items, void* out,
                  int n_items, int D, int B, int C, int K, int Ds,
                  void* stream) {
    if (n_items <= 0 || D <= 0) return (int)cudaSuccess;
    if (fold && !smem_acc) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define HIST_ARGS \
    xb, rows, rows64, y, vals, items, out, n_items, D, B, C, K, Ds, s
#define HIST_CASE(T)                                                        \
    return fold ? launch_t<T, CLASSES, true, true>(HIST_ARGS)               \
         : smem_acc ? launch_t<T, CLASSES, true, false>(HIST_ARGS)          \
                    : launch_t<T, CLASSES, false, false>(HIST_ARGS);
    switch (code_bytes) {
        case 1: HIST_CASE(uint8_t)
        case 2: HIST_CASE(int16_t)
        case 4: HIST_CASE(int32_t)
    }
#undef HIST_CASE
#undef HIST_ARGS
    return (int)cudaErrorInvalidValue;
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// xb (N, D) codes of `code_bytes` bytes (uint8, int16 or int32), row-major;
// rows (m,) int32 (rows64 = 0) or int64 (rows64 = 1) or null; y (m,) int32;
// w (m,) f32; items (n_items, 3) int64 (first sample, end sample, output
// row); out (rows, D, B, C) f32, zeroed by the caller when !smem_acc; Ds
// features a block; fold = 1 takes the fold mode (shared memory only), 0
// the rank mode.
int histogram_classes(const void* xb, int code_bytes, const void* rows,
                      int rows64, const void* y, const void* w,
                      const void* items, void* out, int n_items, int D,
                      int B, int C, int Ds, int smem_acc, int fold,
                      void* stream) {
    return launch<true>(code_bytes, smem_acc, fold, xb, rows, rows64, y, w,
                        items, out, n_items, D, B, C, 1, Ds, stream);
}

// As above with wm (m, K) f32 payload columns in place of y / w; out
// (rows, D, B, K) f32.
int histogram_moments(const void* xb, int code_bytes, const void* rows,
                      int rows64, const void* wm, const void* items,
                      void* out, int n_items, int D, int B, int K, int Ds,
                      int smem_acc, int fold, void* stream) {
    return launch<false>(code_bytes, smem_acc, fold, xb, rows, rows64,
                         nullptr, wm, items, out, n_items, D, B, K, K, Ds,
                         stream);
}

// The work plan of `ops.py::work_items` for the node offsets bounds[0..n]
// (the host copy: the Python function is the specification and the card
// tests hold the two equal).  With plan null, returns the number of items
// times 2^32 plus the number of cut nodes; otherwise writes the items
// (n_items, 3) and then the reduce triples (n_cut, 3) to plan and returns
// the same number.
long long histogram_plan(const long long* bounds, int n, long long* plan) {
    const long long total = bounds[n] - bounds[0];
    long long seg = (total + 511) / 512;          // _TARGET_ITEMS
    if (seg < 256) seg = 256;                      // _MIN_SEGMENT
    long long n_items = 0, n_cut = 0;
    for (int i = 0; i < n; ++i) {
        long long ns = (bounds[i + 1] - bounds[i] + seg - 1) / seg;
        ns = ns < 1 ? 1 : ns > 128 ? 128 : ns;     // _MAX_SEGMENTS
        n_items += ns;
        n_cut += ns > 1;
    }
    if (plan) {
        long long* item = plan;
        long long* red = plan + 3 * n_items;
        long long part = n;                        // next partial row
        for (int i = 0; i < n; ++i) {
            const long long s = bounds[i], c = bounds[i + 1] - s;
            long long ns = (c + seg - 1) / seg;
            ns = ns < 1 ? 1 : ns > 128 ? 128 : ns;
            for (long long k = 0; k < ns; ++k, item += 3) {
                item[0] = s + k * c / ns;
                item[1] = s + (k + 1) * c / ns;
                item[2] = ns > 1 ? part + k : i;
            }
            if (ns > 1) {
                red[0] = i;
                red[1] = part;
                red[2] = ns;
                red += 3;
                part += ns;
            }
        }
    }
    return (n_items << 32) + n_cut;
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
