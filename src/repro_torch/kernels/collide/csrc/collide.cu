// A row block's leaf collisions in key order, then the collision pairs to
// each row's top-k and squared sums (sm_90a), in float64 or float32.
//
// The enumeration (collide_enumerate_kernel): every product q_t(i) * w_t(j)
// of the block's rows, one rounding (__dmul_rn / __fmul_rn), with its key
// i * n_ref + j, written in key order with a pair's products in ascending
// tree order: the bits of the plain version's row-major enumeration and
// 64-bit stable sort (kernels/collide/ref.py::collide_enumerate_ref),
// without the sort.  Replaces no TPU kernel (the reference's train-side ops
// write dense blocks).  Each of a row's nonzero-weight trees t gives a list
// L_t of its leaf's members, columns ascending (the leaf index keeps them
// so), so key order is a merge of the row's lists and a product's place is
// its rank there: the row's first place (row_start, the rows' cumulative
// products on the device) plus, over every list L_u, its count of columns
// below c (u >= t) or at most c (u < t), which for u = t is the product's
// own place in its list.  Ranks are independent, so no product waits for
// another and nothing is written twice.
//
// Bound: one read of each product's column and weight (12 bytes in float64, 8
// in float32) and one write of its key and value (16 or 12 bytes).  Design: a
// warp a slice of a row's products in list order (tree, then member), lanes
// striding over them 32 at a time, so every lane has a product whatever the
// lists' lengths.  Lane j holds tree 32 g + j's list (its start, its length,
// zero where q is zero, and its first place in the row; a row of more than 32
// trees takes its lists 32 at a time, reading them again for each chunk); each
// lane finds its product's list among them and counts its column in every
// other list by a branch-free binary search, the same steps on every lane,
// through L1.  The lanes of a chunk hold neighbouring members of one list, so
// their searches share the first steps' reads.  Slices are short (`split`, the
// wrapper's ENUM_SPLIT products): a launch lasts as long as its longest warp,
// and a row in large pure leaves (30,821 products at 1,000,000 rows) searches
// long lists for every product, so at slices of 1,024 such warps set each
// launch's length (on the H100 an op's enumeration took 70 ms at 1,024, 47 at
// 512, 37 at 256 and 32 at 128).  Measured and dropped: staging a row's columns
// in shared memory (it takes room from L1), merging each chunk against the
// other lists in coalesced windows from a cursor a list, and issuing four
// lists' searches together.
//
// The pair kernels:
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
// block, in two launches (a stage for every row, one for the split rows)
// that read the sorted products once.
//
// Bound: one read of the keys and products (16 or 12 bytes a product) and
// the outputs written once.  Design: a warp a row, so a block launches
// about one warp for each of its rows (thousands) and every SM holds work;
// a launch then lasts as long as its longest warp, so a row of more than
// `split` products (the wrapper's split_products: at least 64 times a
// pair's most products) is cut into slices of `split`, a warp each, and a
// second launch finishes it (stage 2).  Warps share nothing within a
// launch, so no barrier and no atomic.
//   * a warp finds its row's products by binary search on the keys (lane 1
//     the row's end, the other lanes its start) and walks its slice 32 at
//     a time, lane l holding entry l of the chunk: each load of keys and
//     products is one coalesced read, and a ring of CT_AHEAD chunks keeps
//     three chunks' loads in flight while one is reduced;
//   * a pair's first product (its head: a key unlike the entry before)
//     owns the pair, in whatever slice or chunk its run ends: its lane
//     adds the run forward, unfused (__dadd_rn / __fadd_rn), from the
//     chunk's registers and the next chunk's by shuffle, past those (a
//     pair in more than 33 trees) from memory.  Run lengths come from a
//     ballot of equal neighbouring keys, so the adds' loop has no vote.
//     So every value has the plain version's bits;
//   * top-k: each chunk's pairs go by ballot into row_topk's WarpTopK
//     (../../row_topk/csrc/warp_topk.cuh): a pair passes when it beats the
//     k-th entry, passers wait in the warp's buffer in shared memory, and a
//     bitonic merge adds them to the list held in registers (R = 1 or 2
//     entries a lane, k <= 32 or k <= 64).  A whole row holding fewer than
//     k pairs takes the columns below k that none of its pairs holds,
//     ascending, by ballot.  A split row's slices keep their lists, and
//     stage 2 merges them as row_topk's stage 2 does: columns are distinct
//     in a row, so the order is total and any split gives the plain
//     version's answer;
//   * class sums: lane c % 32 holds class c's sum in register c / 32 (RC =
//     1, 2, 4 or 8 registers from the class count; past 256 classes the
//     row is walked once for each 256).  Each chunk's pairs are broadcast
//     in column order and each adds its square to its class's lane, so
//     each class adds in column order from 0, as the plain version does.
//     A split row's slices write their pairs' squares and classes in
//     column order, and in stage 2 one warp adds them the same way: the
//     same adds in the same order.  Each row's sums are written once,
//     every class, so the caller need not zero them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../row_topk/csrc/warp_topk.cuh"

#define CT_WARPS 4
#define CT_THREADS (CT_WARPS * 32)
#define CT_MAX_K 64
#define CT_CLASS_REGS 8         // at most 8 classes a lane: 256 a walk
#define CT_AHEAD 4              // chunks a warp holds: 3 loads in flight
#define CT_GROUP 8              // class adds' shuffles issued together
static_assert(CT_AHEAD >= 3, "a chunk's runs read the next two chunks");

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

// Consecutive set bits of x from bit b up.
__device__ __forceinline__ int ones_from(unsigned x, int b) {
    x >>= b;
    return x == RT_FULL ? 32 : __ffs(~x) - 1;
}

// Bit l: entry l of the chunk `k` (lane l's key) has the key of entry l + 1,
// the next chunk's first (`k_after` of lane 0) after entry 31.
__device__ __forceinline__ unsigned continues(long long k, long long k_after,
                                              int lane) {
    long long d = __shfl_down_sync(RT_FULL, k, 1);
    const long long f = __shfl_sync(RT_FULL, k_after, 0);
    if (lane == 31) d = f;
    return __ballot_sync(RT_FULL, k >= 0 && k == d);
}

// The pairs whose first products lie in [s0, s1), a slice of the row whose
// products end at hi and whose keys start at `base`; `prev` is the key
// before s0 (-1 at the row's start).  Every lane calls `visit(head, col,
// v, cls)` once a chunk of 32 products: `head` when its entry is a pair's
// first product, then `col` is the pair's column, `v` its value (its run
// added forward, up to hi) and `cls` class_of[col] (0 without class_of).
// Entries past hi read key -1, which no product has.
template <typename V, typename Visit>
__device__ __forceinline__ void walk_row(const long long* __restrict__ key,
                                         const V* __restrict__ prod,
                                         long long s0, long long s1,
                                         long long hi, long long prev,
                                         long long base,
                                         const long long* __restrict__
                                             class_of,
                                         int lane, Visit&& visit) {
    auto load = [&](long long p, long long& k, V& v) {
        k = p < hi ? __ldg(key + p) : -1;
        v = p < hi ? __ldg(prod + p) : V(0);
    };
    auto classes = [&](long long k) {
        return class_of != nullptr && k >= 0
            ? (int)__ldg(class_of + (k - base)) : 0;
    };
    // a ring of CT_AHEAD chunks in registers: slot a holds chunk a, a +
    // CT_AHEAD, ...; a chunk's slot is refilled once it is reduced, and
    // the chunk's run bits and classes are read a chunk ahead
    long long kr[CT_AHEAD];
    V vr[CT_AHEAD];
#pragma unroll
    for (int a = 0; a < CT_AHEAD; ++a)
        load(s0 + 32 * a + lane, kr[a], vr[a]);
    unsigned eq = continues(kr[0], kr[1], lane);
    int cls = classes(kr[0]);
    for (long long p00 = s0; p00 < s1; p00 += 32 * CT_AHEAD)
#pragma unroll
    for (int a = 0; a < CT_AHEAD; ++a) {
        const long long p0 = p00 + 32 * a;
        if (p0 >= s1) break;
        const long long kc = kr[a], kn = kr[(a + 1) % CT_AHEAD];
        const V vc = vr[a], vn = vr[(a + 1) % CT_AHEAD];
        const unsigned eq_next = continues(kn, kr[(a + 2) % CT_AHEAD], lane);
        const int cls_next = classes(kn);
        long long up = __shfl_up_sync(RT_FULL, kc, 1);
        if (lane == 0) up = prev;
        const bool head = kc >= 0 && kc != up && p0 + lane < s1;
        // the products after a head in its run: in this chunk, the next,
        // then (a pair in more than 33 trees) from memory
        int steps = 0;
        if (head) {
            steps = ones_from(eq, lane);
            if (lane + steps == 32) {
                const int more = ones_from(eq_next, 0);
                steps += more;
                for (long long p = p0 + 65; more == 32 && p < hi
                         && __ldg(key + p) == kc; ++p)
                    ++steps;
            }
        }
        const int most = (int)__reduce_max_sync(RT_FULL, (unsigned)steps);
        V v = vc;
        if (!__any_sync(RT_FULL, lane + steps >= 32)) {
#pragma unroll 4
            for (int d = 1; d <= most; ++d) {
                const V vq = __shfl_sync(RT_FULL, vc, (lane + d) & 31);
                if (d <= steps) v = add_rn(v, vq);
            }
        } else {
#pragma unroll 4
            for (int d = 1; d <= most; ++d) {
                const int q = lane + d;
                V vq = __shfl_sync(RT_FULL, vc, q & 31);
                const V v2 = __shfl_sync(RT_FULL, vn, q & 31);
                if (q >= 32) vq = v2;
                if (d <= steps) {
                    if (q >= 64) vq = __ldg(prod + p0 + q);
                    v = add_rn(v, vq);
                }
            }
        }
        visit(head, head ? (int)(kc - base) : 0, v, cls);
        prev = __shfl_sync(RT_FULL, kc, 31);
        eq = eq_next;
        cls = cls_next;
        load(p0 + 32 * CT_AHEAD + lane, kr[a], vr[a]);
    }
}

// The row's products: lane 1 finds the row's end, the others its start.
__device__ __forceinline__ void row_range(const long long* key,
                                          long long n_products,
                                          long long base, long long n_ref,
                                          int lane, long long& lo,
                                          long long& hi) {
    const long long b = lower_bound(key, n_products,
                                    base + (lane == 1 ? n_ref : 0));
    lo = __shfl_sync(RT_FULL, b, 0);
    hi = __shfl_sync(RT_FULL, b, 1);
}

// A warp's part of a row in stage 1 of either op: row r's products [lo,
// hi), the slice [s0, s1) whose pairs it walks.  Warp w < rows takes row
// w's first `split` products; warp rows + g, the products in [g split, (g +
// 1) split) of the row holding product g split, past that row's first
// `split`.  So a row of at most `split` products is its first warp's
// whole, and a longer row's slices are those of its first warp and of the
// segments g in (lo / split, (hi - 1) / split] (stage 2's slots, for_slots).
// False: the warp has no part.
struct Part {
    long long r, lo, hi, s0, s1;
};

__device__ __forceinline__ bool part_of(const long long* __restrict__ key,
                                        long long n_products,
                                        long long n_ref, int rows,
                                        long long split, long long w,
                                        int lane, Part& p) {
    long long x = 0;
    p.r = w;
    if (w >= rows) {                                // a segment's warp
        x = (w - rows) * split;
        if (x >= n_products) return false;
        p.r = __ldg(key + x) / n_ref;
    }
    row_range(key, n_products, p.r * n_ref, n_ref, lane, p.lo, p.hi);
    p.s0 = w < rows ? p.lo : max(x, p.lo + split);
    p.s1 = min(w < rows ? p.lo + split : x + split, p.hi);
    return w < rows || p.s0 < p.s1;
}

// A split row's slots in column order, each with its slice's first
// product: `f(slot, s0)`.
template <typename F>
__device__ __forceinline__ void for_slots(long long r, long long lo,
                                          long long hi, int rows,
                                          long long split, F&& f) {
    const long long g0 = lo / split;
    for (long long g = g0; g <= (hi - 1) / split; ++g)
        f(g == g0 ? r : rows + g, g == g0 ? lo : max(g * split, lo + split));
}

// Stage 1 of the top-k: a whole row's answer, or a split row's slice's k
// best (sentinels where the slice holds fewer) in slot w of sv/sc.  The
// caller's `split` is at least k times a pair's most products, so a split
// row holds at least k pairs.
template <typename V, int R>
__global__ void __launch_bounds__(CT_THREADS)
collide_topk_kernel(const long long* __restrict__ key,
                    const V* __restrict__ prod, long long n_products,
                    long long n_ref, int rows, int k, long long split,
                    V* __restrict__ sv, int* __restrict__ sc,
                    long long* __restrict__ idx, long long ldi,
                    double* __restrict__ val, long long ldv) {
    __shared__ V buf_v[CT_WARPS][RT_BUF];
    __shared__ int buf_c[CT_WARPS][RT_BUF];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * CT_WARPS + warp;
    Part p;
    if (!part_of(key, n_products, n_ref, rows, split, w, lane, p)) return;
    WarpTopK<V, R> top;
    top.init(buf_v[warp], buf_c[warp], k, lane);
    int held = 0;                                   // the slice's pairs
    walk_row<V>(key, prod, p.s0, p.s1, p.hi,
                p.s0 > p.lo ? __ldg(key + p.s0 - 1) : -1, p.r * n_ref,
                nullptr, lane, [&](bool head, int col, V v, int) {
                    held += __popc(__ballot_sync(RT_FULL, head));
                    top.push(v, col, head);
                });
    top.flush();
    if (p.hi - p.lo > split) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const int e = s * 32 + lane;
            if (e < k) {
                sv[w * k + e] = top.tv[s];
                sc[w * k + e] = top.tc[s];
            }
        }
        return;
    }
    long long* oi = idx + p.r * ldi;
    double* ov = val + p.r * ldv;
    if (held < k) {
        // every pair is listed (entries 0 .. held - 1); the smallest
        // columns none of them holds follow with value 0, all below k
        bool unheld[R];
#pragma unroll
        for (int s = 0; s < R; ++s) unheld[s] = s * 32 + lane < k;
        for (int e = 0; e < held; ++e) {
            const int c = __shfl_sync(RT_FULL,
                                      e < 32 ? top.tc[0] : top.tc[R - 1],
                                      e & 31);
#pragma unroll
            for (int s = 0; s < R; ++s) unheld[s] &= c != s * 32 + lane;
        }
        int at = held;
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const unsigned b = __ballot_sync(RT_FULL, unheld[s]);
            const int pos = at + __popc(b & ((1u << lane) - 1u));
            if (unheld[s] && pos < k) {
                oi[pos] = s * 32 + lane;
                ov[pos] = 0.0;
            }
            at += __popc(b);
        }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
        const int e = s * 32 + lane;
        if (e < k && e < held) {
            oi[e] = (long long)top.tc[s];
            ov[e] = (double)top.tv[s];
        }
    }
}

// Stage 2 of the top-k: warp r merges a split row's slots' lists, as
// row_topk's stage 2 merges a row's lists, and writes its k entries.
template <typename V, int R>
__global__ void __launch_bounds__(CT_THREADS)
collide_topk_merge(const long long* __restrict__ key, long long n_products,
                   long long n_ref, int rows, int k, long long split,
                   const V* __restrict__ sv, const int* __restrict__ sc,
                   long long* __restrict__ idx, long long ldi,
                   double* __restrict__ val, long long ldv) {
    __shared__ V buf_v[CT_WARPS][RT_BUF];
    __shared__ int buf_c[CT_WARPS][RT_BUF];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long r = (long long)blockIdx.x * CT_WARPS + warp;
    if (r >= rows) return;                          // the whole warp
    long long lo, hi;
    row_range(key, n_products, r * n_ref, n_ref, lane, lo, hi);
    if (hi - lo <= split) return;
    WarpTopK<V, R> top;
    top.init(buf_v[warp], buf_c[warp], k, lane);
    for_slots(r, lo, hi, rows, split, [&](long long w, long long) {
        for (int j = lane; j < ((k + 31) & ~31); j += 32)
            top.push(j < k ? sv[w * k + j] : V(0),
                     j < k ? sc[w * k + j] : RT_NONE, j < k);
    });
    top.flush();
#pragma unroll
    for (int s = 0; s < R; ++s) {
        const int e = s * 32 + lane;
        if (e < k) {
            idx[r * ldi + e] = (long long)top.tc[s];
            val[r * ldv + e] = (double)top.tv[s];
        }
    }
}

// Adds the squares `sq` of lanes 0..31 (in lane order) to their classes'
// sums: `at` is a pair's class less the window's first, or -1 for none.
template <typename V, int RC>
__device__ __forceinline__ void add_classes(V (&acc)[RC], V sq, int at,
                                            int lane) {
    // CT_GROUP lanes' shuffles issued together, then their adds: the adds
    // of a class are the chain, the shuffles' latency is not
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += CT_GROUP) {
        V s2[CT_GROUP];
        int a[CT_GROUP];
#pragma unroll
        for (int t = 0; t < CT_GROUP; ++t) {
            s2[t] = __shfl_sync(RT_FULL, sq, j0 + t);
            a[t] = __shfl_sync(RT_FULL, at, j0 + t);
        }
#pragma unroll
        for (int t = 0; t < CT_GROUP; ++t)
#pragma unroll
            for (int s = 0; s < RC; ++s)
                if (a[t] == s * 32 + lane) acc[s] = add_rn(acc[s], s2[t]);
    }
}

// Stage 1 of the class sums: a whole row's sums, a lane a class (classes
// c0 + 32 s + lane in acc[s], a walk a window of 32 RC classes), written
// once; or a split row's slice's pairs, their squares and classes in
// column order, from the slice's first product on in pv/pc, and their
// number in count[w].
template <typename V, int RC>
__global__ void __launch_bounds__(CT_THREADS)
collide_sums_kernel(const long long* __restrict__ key,
                    const V* __restrict__ prod, long long n_products,
                    long long n_ref, int rows,
                    const long long* __restrict__ class_of, int n_classes,
                    long long split, V* __restrict__ pv,
                    int* __restrict__ pc, int* __restrict__ count,
                    V* __restrict__ out) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const long long w = (long long)blockIdx.x * CT_WARPS + warp;
    Part p;
    if (!part_of(key, n_products, n_ref, rows, split, w, lane, p)) return;
    const long long base = p.r * n_ref;
    if (p.hi - p.lo > split) {
        int n = 0;
        walk_row<V>(key, prod, p.s0, p.s1, p.hi,
                    p.s0 > p.lo ? __ldg(key + p.s0 - 1) : -1, base,
                    class_of, lane, [&](bool head, int, V v, int cls) {
                        const unsigned m = __ballot_sync(RT_FULL, head);
                        if (head) {
                            const long long at = p.s0 + n + __popc(m & below);
                            pv[at] = mul_rn(v, v);
                            pc[at] = cls;
                        }
                        n += __popc(m);
                    });
        if (lane == 0) count[w] = n;
        return;
    }
    V* o = out + p.r * n_classes;
    for (int c0 = 0; c0 < n_classes; c0 += 32 * RC) {
        V acc[RC];
#pragma unroll
        for (int s = 0; s < RC; ++s) acc[s] = V(0);
        walk_row<V>(key, prod, p.lo, p.hi, p.hi, -1, base, class_of, lane,
                    [&](bool head, int, V v, int cls) {
                        add_classes<V, RC>(acc, mul_rn(v, v),
                                           head ? cls - c0 : -1, lane);
                    });
#pragma unroll
        for (int s = 0; s < RC; ++s) {
            const int c = c0 + s * 32 + lane;
            if (c < n_classes) o[c] = acc[s];
        }
    }
}

// Stage 2 of the class sums: warp r adds a split row's pairs, slot by slot
// in column order, a lane a class, and writes its sums once.
template <typename V, int RC>
__global__ void __launch_bounds__(CT_THREADS)
collide_sums_merge(const long long* __restrict__ key, long long n_products,
                   long long n_ref, int rows, int n_classes, long long split,
                   const V* __restrict__ pv, const int* __restrict__ pc,
                   const int* __restrict__ count, V* __restrict__ out) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long r = (long long)blockIdx.x * CT_WARPS + warp;
    if (r >= rows) return;                          // the whole warp
    long long lo, hi;
    row_range(key, n_products, r * n_ref, n_ref, lane, lo, hi);
    if (hi - lo <= split) return;
    V* o = out + r * n_classes;
    for (int c0 = 0; c0 < n_classes; c0 += 32 * RC) {
        V acc[RC];
#pragma unroll
        for (int s = 0; s < RC; ++s) acc[s] = V(0);
        for_slots(r, lo, hi, rows, split, [&](long long w, long long s0) {
            const int n = count[w];
            auto load = [&](int j, V& q, int& a) {
                q = j < n ? pv[s0 + j] : V(0);
                a = j < n ? pc[s0 + j] - c0 : -1;
            };
            // a ring of CT_AHEAD chunks of 32 pairs, as the walk's
            V sq[CT_AHEAD];
            int at[CT_AHEAD];
#pragma unroll
            for (int a = 0; a < CT_AHEAD; ++a)
                load(32 * a + lane, sq[a], at[a]);
            for (int j0 = 0; j0 < n; j0 += 32 * CT_AHEAD)
#pragma unroll
            for (int a = 0; a < CT_AHEAD; ++a) {
                if (j0 + 32 * a >= n) break;
                add_classes<V, RC>(acc, sq[a], at[a], lane);
                load(j0 + 32 * (a + CT_AHEAD) + lane, sq[a], at[a]);
            }
        });
#pragma unroll
        for (int s = 0; s < RC; ++s) {
            const int c = c0 + s * 32 + lane;
            if (c < n_classes) o[c] = acc[s];
        }
    }
}

// ---- the enumeration ----

// The members of l[0..n) below x (n >= 1): the same steps on every lane
// for one n, whatever x.
__device__ __forceinline__ int count_below(const int* __restrict__ l, int n,
                                           int x) {
    const int* b = l;
    while (n > 1) {
        const int h = n >> 1;
        b = __ldg(b + h) < x ? b + h : b;
        n -= h;
    }
    return (int)(b - l) + (__ldg(b) < x);
}

// Lane j's part of a group of 32 trees (tree 32 g + j of the row): its
// list's start in the index, its length (0 where q is 0 or past the trees),
// its first place among the row's products, and q.
template <typename V>
struct List {
    int start, n;
    long long at;
    V q;
};

// Group g's lists, the row's products before it being `before`; returns
// the products before the next group.
template <typename V>
__device__ __forceinline__ long long load_lists(
        const int* __restrict__ offs, int ow, const int* __restrict__ gl,
        const V* __restrict__ q, int T, int g, long long before, int lane,
        List<V>& L) {
    const int t = g * 32 + lane;
    L.start = 0;
    L.n = 0;
    L.q = V(0);
    if (t < T) {
        const long long o = (long long)__ldg(gl + t) * ow;
        L.q = __ldg(q + t);
        L.start = __ldg(offs + o);
        if (L.q != V(0)) L.n = __ldg(offs + o + ow - 1) - L.start;
    }
    long long s = L.n;                              // inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const long long u = __shfl_up_sync(RT_FULL, s, d);
        if (lane >= d) s += u;
    }
    L.at = before + s - L.n;
    return before + __shfl_sync(RT_FULL, s, 31);
}

// Warp w < rows takes row w's first `split` products (in list order);
// warp rows + g the products [g split, (g + 1) split) of the block (its
// places in list order) past their row's first `split`, as part_of cuts
// the pair kernels' rows.  Lane l takes product l of each chunk of 32.
template <typename V>
__global__ void __launch_bounds__(CT_THREADS)
collide_enumerate_kernel(const int* __restrict__ offs, int ow,
                         const int* __restrict__ col,
                         const V* __restrict__ wv,
                         const int* __restrict__ gl_q,
                         const V* __restrict__ q, int T, int rows,
                         const long long* __restrict__ row_start,
                         long long n_products, long long n_ref,
                         long long split, long long* __restrict__ key,
                         V* __restrict__ prod) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * CT_WARPS + warp;
    const long long first = __ldg(row_start);
    long long r = w, x = 0;
    if (w >= rows) {                                // a segment's warp
        x = (w - rows) * split;
        if (x >= n_products) return;
        // the last row whose first product is at or before x
        long long a = 0, b = rows;
        while (a < b) {
            const long long m = (a + b + 1) >> 1;
            if (__ldg(row_start + m) - first <= x) a = m; else b = m - 1;
        }
        r = a;
    }
    const long long lo = __ldg(row_start + r) - first;
    const long long n_row = __ldg(row_start + r + 1) - first - lo;
    const long long p0 = w < rows ? 0 : max(x - lo, split);
    const long long p1 = min(w < rows ? split : x - lo + split, n_row);
    if (p0 >= p1) return;                           // the whole warp
    const int* gl = gl_q + r * T;
    const V* qr = q + r * T;
    const int groups = (T + 31) / 32;
    List<V> L0;
    load_lists<V>(offs, ow, gl, qr, T, 0, 0, lane, L0);
    // f(u, start, n, at, q) for each of the row's lists that is not empty,
    // trees ascending (the arguments the same on every lane)
    auto each_list = [&](auto&& f) {
        long long before = 0;
        for (int g = 0; g < groups; ++g) {
            List<V> L = L0;
            if (groups > 1)
                before = load_lists<V>(offs, ow, gl, qr, T, g, before, lane,
                                       L);
            for (unsigned m = __ballot_sync(RT_FULL, L.n > 0); m;
                 m &= m - 1) {
                const int j = __ffs(m) - 1;
                f(g * 32 + j, __shfl_sync(RT_FULL, L.start, j),
                  __shfl_sync(RT_FULL, L.n, j), __shfl_sync(RT_FULL, L.at, j),
                  __shfl_sync(RT_FULL, L.q, j));
            }
        }
    };
    for (long long c0 = p0; c0 < p1; c0 += 32) {
        const long long p = c0 + lane;
        // the lane's product: its tree, its place in its list and in the
        // index, and its q
        int t = -1, m = 0, at = 0;
        V qp = V(0);
        each_list([&](int u, int s, int n, long long a, V qu) {
            if (p < p1 && p >= a && p < a + n) {
                t = u;
                m = (int)(p - a);
                at = s + m;
                qp = qu;
            }
        });
        const int c = __ldg(col + at);
        // its place: its own in its list, plus its count in every other
        // list (a lane past the slice, t < 0, counts nothing)
        long long rank = m;
        each_list([&](int u, int s, int n, long long, V) {
            if (u != t && t >= 0)
                rank += count_below(col + s, n, c + (u < t));
        });
        if (t >= 0) {
            key[lo + rank] = r * n_ref + c;
            prod[lo + rank] = mul_rn(qp, __ldg(wv + at));
        }
    }
}

// Stage 1, then stage 2, of an op over rows + ceil(n_products / split)
// warps.
static bool launchable(int rows, long long n_products, long long n_ref,
                       long long split) {
    return split >= CT_MAX_K && n_ref < RT_NONE
        && (long long)rows + (n_products + split - 1) / split
               <= (long long)INT_MAX * CT_WARPS;
}

static unsigned grid_of(long long warps) {
    return (unsigned)((warps + CT_WARPS - 1) / CT_WARPS);
}

template <typename V, int R>
static int topk_launch(const void* key, const void* prod,
                       long long n_products, long long n_ref, int rows,
                       int k, long long split, void* sv, void* sc,
                       void* idx, long long ldi, void* val, long long ldv,
                       cudaStream_t s) {
    const long long* kp = (const long long*)key;
    collide_topk_kernel<V, R><<<grid_of(rows + (n_products + split - 1)
                                        / split), CT_THREADS, 0, s>>>(
        kp, (const V*)prod, n_products, n_ref, rows, k, split, (V*)sv,
        (int*)sc, (long long*)idx, ldi, (double*)val, ldv);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    collide_topk_merge<V, R><<<grid_of(rows), CT_THREADS, 0, s>>>(
        kp, n_products, n_ref, rows, k, split, (const V*)sv, (const int*)sc,
        (long long*)idx, ldi, (double*)val, ldv);
    return (int)cudaGetLastError();
}

template <typename V>
static int topk(const void* key, const void* prod, long long n_products,
                long long n_ref, int rows, int k, long long split, void* sv,
                void* sc, void* idx, long long ldi, void* val, long long ldv,
                void* stream) {
    if (rows <= 0 || k <= 0) return 0;
    if (k > CT_MAX_K || k > n_ref || ldi < k || ldv < k
        || !launchable(rows, n_products, n_ref, split))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return k <= 32
        ? topk_launch<V, 1>(key, prod, n_products, n_ref, rows, k, split, sv,
                            sc, idx, ldi, val, ldv, s)
        : topk_launch<V, 2>(key, prod, n_products, n_ref, rows, k, split, sv,
                            sc, idx, ldi, val, ldv, s);
}

template <typename V, int RC>
static int sums_launch(const void* key, const void* prod,
                       long long n_products, long long n_ref, int rows,
                       const void* class_of, int n_classes, long long split,
                       void* pv, void* pc, void* count, void* out,
                       cudaStream_t s) {
    const long long* kp = (const long long*)key;
    collide_sums_kernel<V, RC><<<grid_of(rows + (n_products + split - 1)
                                         / split), CT_THREADS, 0, s>>>(
        kp, (const V*)prod, n_products, n_ref, rows,
        (const long long*)class_of, n_classes, split, (V*)pv, (int*)pc,
        (int*)count, (V*)out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    collide_sums_merge<V, RC><<<grid_of(rows), CT_THREADS, 0, s>>>(
        kp, n_products, n_ref, rows, n_classes, split, (const V*)pv,
        (const int*)pc, (const int*)count, (V*)out);
    return (int)cudaGetLastError();
}

template <typename V>
static int sums(const void* key, const void* prod, long long n_products,
                long long n_ref, int rows, const void* class_of,
                int n_classes, long long split, void* pv, void* pc,
                void* count, void* out, void* stream) {
    if (rows <= 0) return 0;
    if (n_classes < 1 || !launchable(rows, n_products, n_ref, split))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_classes <= 32)
        return sums_launch<V, 1>(key, prod, n_products, n_ref, rows,
                                 class_of, n_classes, split, pv, pc, count,
                                 out, s);
    if (n_classes <= 64)
        return sums_launch<V, 2>(key, prod, n_products, n_ref, rows,
                                 class_of, n_classes, split, pv, pc, count,
                                 out, s);
    if (n_classes <= 128)
        return sums_launch<V, 4>(key, prod, n_products, n_ref, rows,
                                 class_of, n_classes, split, pv, pc, count,
                                 out, s);
    return sums_launch<V, CT_CLASS_REGS>(key, prod, n_products, n_ref, rows,
                                         class_of, n_classes, split, pv, pc,
                                         count, out, s);
}

template <typename V>
static int enumerate(const void* offs, int ow, const void* col,
                     const void* w, const void* gl_q, const void* q, int T,
                     int rows, const void* row_start, long long n_products,
                     long long n_ref, long long split, void* key, void* prod,
                     void* stream) {
    if (rows <= 0 || n_products <= 0) return 0;
    if (T < 1 || ow < 1 || split < 1 || n_ref >= RT_NONE
        || (long long)rows + (n_products + split - 1) / split
               > (long long)INT_MAX * CT_WARPS)
        return (int)cudaErrorInvalidValue;
    collide_enumerate_kernel<V><<<grid_of(rows + (n_products + split - 1)
                                          / split), CT_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        (const int*)offs, ow, (const int*)col, (const V*)w,
        (const int*)gl_q, (const V*)q, T, rows,
        (const long long*)row_start, n_products, n_ref, split,
        (long long*)key, (V*)prod);
    return (int)cudaGetLastError();
}

extern "C" {

const char* repro_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The leaf index: offs (n_leaves, ow) int32, col (nnz) int32, w (nnz) f64;
// the block's query factors gl_q (rows, T) int32 and q (rows, T) f64, rows
// contiguous; row_start (rows + 1) int64, the rows' cumulative products
// (the block's first row's need not be 0), their total n_products; a warp
// takes `split` (at least 1) products.  Writes key (n_products) int64 and
// prod (n_products) f64 in key order.
int collide_enumerate_f64(const void* offs, int ow, const void* col,
                          const void* w, const void* gl_q, const void* q,
                          int T, int rows, const void* row_start,
                          long long n_products, long long n_ref,
                          long long split, void* key, void* prod,
                          void* stream) {
    return enumerate<double>(offs, ow, col, w, gl_q, q, T, rows, row_start,
                             n_products, n_ref, split, key, prod, stream);
}

// The same with w, q and prod in f32.
int collide_enumerate_f32(const void* offs, int ow, const void* col,
                          const void* w, const void* gl_q, const void* q,
                          int T, int rows, const void* row_start,
                          long long n_products, long long n_ref,
                          long long split, void* key, void* prod,
                          void* stream) {
    return enumerate<float>(offs, ow, col, w, gl_q, q, T, rows, row_start,
                            n_products, n_ref, split, key, prod, stream);
}

// key (n_products) int64 sorted, prod (n_products) f64; rows longer than
// `split` products (at least 64, and k times a pair's most products) are
// split, their slices' lists kept in the scratch sv ((rows + ceil(n_products
// / split)) * k, f64) and sc (the same, int32); idx (rows, k) int64 with
// row stride ldi and val (rows, k) f64 with row stride ldv.  1 <= k <= 64
// and k <= n_ref.
int collide_topk_f64(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, int k, long long split,
                     void* sv, void* sc, void* idx, long long ldi, void* val,
                     long long ldv, void* stream) {
    return topk<double>(key, prod, n_products, n_ref, rows, k, split, sv, sc,
                        idx, ldi, val, ldv, stream);
}

// The same with prod and sv in f32 (val stays f64: the values widened).
int collide_topk_f32(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, int k, long long split,
                     void* sv, void* sc, void* idx, long long ldi, void* val,
                     long long ldv, void* stream) {
    return topk<float>(key, prod, n_products, n_ref, rows, k, split, sv, sc,
                       idx, ldi, val, ldv, stream);
}

// key, prod as above; class_of (n_ref) int64 or null (one class); rows
// longer than `split` (at least 64) products are split, their pairs kept in
// the scratch pv (n_products, in prod's type), pc (n_products, int32) and
// count (rows + ceil(n_products / split), int32); out (rows, n_classes) in
// prod's type, every entry written.
int collide_sums_f64(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, const void* class_of,
                     int n_classes, long long split, void* pv, void* pc,
                     void* count, void* out, void* stream) {
    return sums<double>(key, prod, n_products, n_ref, rows, class_of,
                        n_classes, split, pv, pc, count, out, stream);
}

int collide_sums_f32(const void* key, const void* prod, long long n_products,
                     long long n_ref, int rows, const void* class_of,
                     int n_classes, long long split, void* pv, void* pc,
                     void* count, void* out, void* stream) {
    return sums<float>(key, prod, n_products, n_ref, rows, class_of,
                       n_classes, split, pv, pc, count, out, stream);
}

}  // extern "C"
