"""Plain proximities P(i, j) = Σ_t q_t(i) w_t(j) [leaf_t(i) = leaf_t(j)],
the top-k with its tie rule, and class-bucketed squared sums.

Rows of P are computed whole, in float64, in one of two plain ways chosen
by size alone (the answers are the same):

- ``dense``: one-hot leaf matrices A (n, L) of q and B (N, L) of w, and
  P = A Bᵀ as a GEMM; taken where B fits ``dense_max_bytes`` (few leaves:
  shallow, boosted trees).
- ``pairs``: every collision enumerated from the references grouped by
  leaf, and its product q·w added into its (i, j) cell (many small leaves:
  deep forests).

TF32 is switched off for the GEMMs, so a float32 product is float32.
"""
from __future__ import annotations

from typing import Iterator, Tuple

DENSE_MAX_BYTES = 8 << 30


class Reference:
    """The reference side (N rows) of P, prepared once."""

    def __init__(self, torch, gl, w, n_leaves: int,
                 dense_max_bytes: int = DENSE_MAX_BYTES):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.torch = torch
        self.n, self.T = gl.shape
        self.L = int(n_leaves)
        self.dtype = w.dtype
        self.device = gl.device
        if self.n * self.L * w.element_size() <= dense_max_bytes:
            self.form = "dense"
            B = torch.zeros((self.n, self.L), dtype=w.dtype,
                            device=self.device)
            B.scatter_(1, gl.long(), w)
            self.Bt = B.t()
        else:
            self.form = "pairs"
            flat = gl.reshape(-1).long()
            keep = w.reshape(-1) != 0
            key = torch.where(keep, flat, self.L)
            key, order = torch.sort(key, stable=True)
            nnz = int(keep.sum())
            order = order[:nnz]
            self.col = order // self.T
            self.val = w.reshape(-1)[order]
            self.count = torch.bincount(key[:nnz], minlength=self.L)
            self.start = torch.cumsum(self.count, 0) - self.count

    def rows(self, glq, q):
        """Dense P for the query factors ``glq``/``q`` (n, T)."""
        torch = self.torch
        n = glq.shape[0]
        if self.form == "dense":
            A = torch.zeros((n, self.L), dtype=q.dtype, device=self.device)
            A.scatter_(1, glq.long(), q)
            return A @ self.Bt
        qi, qt = torch.nonzero(q != 0, as_tuple=True)
        leaf = glq[qi, qt].long()
        c = self.count[leaf]
        rep = torch.repeat_interleave(torch.arange(leaf.numel(),
                                                   device=self.device), c)
        first = torch.cumsum(c, 0) - c
        m = self.start[leaf][rep] + torch.arange(rep.numel(),
                                                 device=self.device) \
            - first[rep]
        P = torch.zeros(n * self.n, dtype=q.dtype, device=self.device)
        P.index_add_(0, qi[rep] * self.n + self.col[m],
                     q[qi[rep], qt[rep]] * self.val[m])
        return P.view(n, self.n)

    def blocks(self, glq, q, chunk: int = 1024
               ) -> Iterator[Tuple[int, int, object]]:
        for i0 in range(0, glq.shape[0], chunk):
            yield i0, min(i0 + chunk, glq.shape[0]), \
                self.rows(glq[i0:i0 + chunk], q[i0:i0 + chunk])


def topk(torch, P, k: int):
    """Each row's k largest values, equal values by ascending column."""
    v, i = torch.sort(P, dim=1, descending=True, stable=True)
    return i[:, :k], v[:, :k]


def onehot(torch, y, n_classes: int, dtype, device):
    yy = torch.as_tensor(y, device=device).long()
    out = torch.zeros((yy.numel(), n_classes), dtype=dtype, device=device)
    out[torch.arange(yy.numel(), device=device), yy] = 1.0
    return out


def class_sq_sums(P, Y):
    """Σ_{j: y_j = c} P(i, j)² for each row i and class c."""
    return (P * P) @ Y
