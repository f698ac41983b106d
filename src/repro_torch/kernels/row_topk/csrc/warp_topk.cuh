// A warp's exact top-k under the strict total order of (value, column):
// (v, c) beats (u, d) when v > u, or v == u and c < d.  Shared by the row
// top-k kernel (row_topk.cu) and the collision-pair kernel
// (../../collide/csrc/collide.cu); row_topk.cu's header says how it works.
// The sentinel (-inf, RT_NONE) beats nothing; NaN beats nothing either.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define RT_BUF 64               // < 32 waiting + one step's 32
#define RT_NONE INT_MAX         // the sentinel's column
#define RT_FULL 0xffffffffu

template <typename V>
__device__ __forceinline__ bool rt_beats(V a, int ac, V b, int bc) {
    return a > b || (a == b && ac < bc);
}

// One compare-exchange of a bitonic network across lanes: this lane holds
// (v, c), its partner lane ^ stride; keep the better of the two when
// `better`, else the worse.
template <typename V>
__device__ __forceinline__ void rt_exchange(V& v, int& c, int stride,
                                            bool better) {
    const V ov = __shfl_xor_sync(RT_FULL, v, stride);
    const int oc = __shfl_xor_sync(RT_FULL, c, stride);
    if (rt_beats(ov, oc, v, c) == better) { v = ov; c = oc; }
}

// A bitonic sequence across the warp's lanes, sorted best first.
template <typename V>
__device__ __forceinline__ void rt_bitonic_merge(V& v, int& c, int lane) {
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
        rt_exchange(v, c, stride, (lane & stride) == 0);
}

// Any 32 entries, one a lane, sorted best first.
template <typename V>
__device__ __forceinline__ void rt_sort32(V& v, int& c, int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1)
            rt_exchange(v, c, stride,
                        ((lane & stride) == 0) == ((lane & size) == 0));
}

// A warp's exact top-k (k <= 32 R) of the entries pushed to it.  Entry e of
// the sorted list lives in register e / 32 of lane e % 32.  Every member is
// warp-uniform except the registers and `lane`.
template <typename V, int R>
struct WarpTopK {
    V tv[R];
    int tc[R];
    V thr_v;                    // entry k - 1: what a new entry must beat
    int thr_c;
    int count;                  // entries waiting in the buffer
    int k, lane;
    V* bv;
    int* bc;

    __device__ __forceinline__ void init(V* bv_, int* bc_, int k_,
                                         int lane_) {
#pragma unroll
        for (int r = 0; r < R; ++r) { tv[r] = -INFINITY; tc[r] = RT_NONE; }
        thr_v = -INFINITY;
        thr_c = RT_NONE;
        count = 0;
        k = k_;
        lane = lane_;
        bv = bv_;
        bc = bc_;
    }

    __device__ __forceinline__ bool passes(V v, int c) const {
        return rt_beats(v, c, thr_v, thr_c);
    }

    // Every lane calls it; lanes with `ok` false push nothing.
    __device__ __forceinline__ void push(V v, int c, bool ok) {
        const bool pass = ok && passes(v, c);
        const unsigned b = __ballot_sync(RT_FULL, pass);
        if (!b) return;
        if (pass) {
            const int pos = count + __popc(b & ((1u << lane) - 1u));
            bv[pos] = v;
            bc[pos] = c;
        }
        count += __popc(b);
        if (count >= 32) merge(32);
    }

    __device__ __forceinline__ void flush() {
        if (count) merge(count);
    }

    // Merge the buffer's first n (<= 32) entries into the list and move the
    // rest to the buffer's front.
    __device__ void merge(int n) {
        __syncwarp();
        V pv = -INFINITY;
        int pc = RT_NONE;
        if (lane < n) { pv = bv[lane]; pc = bc[lane]; }
        const int rest = count - n;
        V rv = 0;
        int rc = 0;
        if (lane < rest) { rv = bv[n + lane]; rc = bc[n + lane]; }
        __syncwarp();
        if (lane < rest) { bv[lane] = rv; bc[lane] = rc; }
        __syncwarp();
        count = rest;
        rt_sort32(pv, pc, lane);
        // the best 32 of the list's last 32 and the new ones: elementwise
        // the better of the list and the new ones reversed (a bitonic
        // sequence), then sorted
        V ov = __shfl_sync(RT_FULL, pv, 31 - lane);
        int oc = __shfl_sync(RT_FULL, pc, 31 - lane);
        if (rt_beats(ov, oc, tv[R - 1], tc[R - 1])) {
            tv[R - 1] = ov;
            tc[R - 1] = oc;
        }
        rt_bitonic_merge(tv[R - 1], tc[R - 1], lane);
        if (R == 2) {
            // entries 0-31 and the new 32-63, each sorted: 0-31 followed by
            // 32-63 reversed is bitonic; one exchange across the registers,
            // then each half sorted
            ov = __shfl_sync(RT_FULL, tv[R - 1], 31 - lane);
            oc = __shfl_sync(RT_FULL, tc[R - 1], 31 - lane);
            if (rt_beats(ov, oc, tv[0], tc[0])) {
                tv[R - 1] = tv[0];
                tc[R - 1] = tc[0];
                tv[0] = ov;
                tc[0] = oc;
            } else {
                tv[R - 1] = ov;
                tc[R - 1] = oc;
            }
            rt_bitonic_merge(tv[0], tc[0], lane);
            rt_bitonic_merge(tv[R - 1], tc[R - 1], lane);
        }
        const int e = k - 1;
        const V src_v = (R == 1 || e < 32) ? tv[0] : tv[R - 1];
        const int src_c = (R == 1 || e < 32) ? tc[0] : tc[R - 1];
        thr_v = __shfl_sync(RT_FULL, src_v, e & 31);
        thr_c = __shfl_sync(RT_FULL, src_c, e & 31);
    }
};
