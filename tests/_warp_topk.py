"""``WarpTopK<V, R>`` (``kernels/row_topk/csrc/warp_topk.cuh``) lane by
lane in numpy, for the replays of the row top-k and collision-pair kernels
(``tests/test_torch_row_topk.py``, ``tests/test_torch_collide.py``)."""
import numpy as np

INT_MAX = 2 ** 31 - 1


def beats(a, ac, b, bc):
    return (a > b) | ((a == b) & (ac < bc))


class WarpTopK:
    """``WarpTopK<V, R>``, lane by lane in numpy."""

    def __init__(self, k, dtype):
        self.R = 1 if k <= 32 else 2
        self.k, self.dt = k, dtype
        self.tv = np.full((self.R, 32), -np.inf, dtype)
        self.tc = np.full((self.R, 32), INT_MAX, np.int64)
        self.thr = (dtype(-np.inf), INT_MAX)
        self.bv, self.bc = [], []

    def passes(self, v, c):
        return beats(v, c, *self.thr)

    def push(self, v, c, ok):
        p = ok & self.passes(v, c)
        if not p.any():
            return
        self.bv += list(v[p])           # in lane order, as ballot and popc
        self.bc += list(c[p])
        assert len(self.bv) < 64        # RT_BUF
        if len(self.bv) >= 32:
            self.merge(32)

    def flush(self):
        if self.bv:
            self.merge(len(self.bv))

    @staticmethod
    def _exchange(v, c, stride, better):
        lanes = np.arange(32)
        ov, oc = v[lanes ^ stride], c[lanes ^ stride]
        take = beats(ov, oc, v, c) == better
        return np.where(take, ov, v), np.where(take, oc, c)

    def _bitonic_merge(self, v, c):
        lanes = np.arange(32)
        for stride in (16, 8, 4, 2, 1):
            v, c = self._exchange(v, c, stride, (lanes & stride) == 0)
        return v, c

    def _sort32(self, v, c):
        lanes = np.arange(32)
        size = 2
        while size <= 32:
            stride = size >> 1
            while stride:
                v, c = self._exchange(
                    v, c, stride, ((lanes & stride) == 0) == ((lanes & size)
                                                               == 0))
                stride >>= 1
            size <<= 1
        return v, c

    def merge(self, n):
        pv = np.full(32, -np.inf, self.dt)
        pc = np.full(32, INT_MAX, np.int64)
        pv[:n], pc[:n] = self.bv[:n], self.bc[:n]
        self.bv, self.bc = self.bv[n:], self.bc[n:]
        pv, pc = self._sort32(pv, pc)
        rev = np.arange(32)[::-1]
        ov, oc = pv[rev], pc[rev]
        lo_v, lo_c = self.tv[-1], self.tc[-1]
        take = beats(ov, oc, lo_v, lo_c)
        lo_v, lo_c = self._bitonic_merge(np.where(take, ov, lo_v),
                                         np.where(take, oc, lo_c))
        if self.R == 1:
            self.tv[0], self.tc[0] = lo_v, lo_c
        else:
            ov, oc = lo_v[rev], lo_c[rev]
            hi_v, hi_c = self.tv[0], self.tc[0]
            take = beats(ov, oc, hi_v, hi_c)
            new_hi = (np.where(take, ov, hi_v), np.where(take, oc, hi_c))
            new_lo = (np.where(take, hi_v, ov), np.where(take, hi_c, oc))
            self.tv[0], self.tc[0] = self._bitonic_merge(*new_hi)
            self.tv[1], self.tc[1] = self._bitonic_merge(*new_lo)
        e = self.k - 1
        self.thr = (self.tv[e // 32][e % 32], self.tc[e // 32][e % 32])

    def entries(self):
        return (self.tv.reshape(-1)[:self.k].copy(),
                self.tc.reshape(-1)[:self.k].copy())
