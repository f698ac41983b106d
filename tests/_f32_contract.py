"""The float32 acceptance rule of the port's float32 factors, in one place
for its CPU tests (``test_torch_float32``) and for ``chip_smoke.py``'s
phase 12 on the card.  It imports numpy only, never jax, so the card run
can use it.

Values: within ``RTOL_F32`` x the largest magnitude of the value compared
against (float32 sums in other orders).  Top-k ids: compared only on the
rows ``decided_rows`` picks; a row with two neighbouring values closer
than the tolerance may order them either way."""
import numpy as np

RTOL_F32 = 1e-5


def decided_rows(vals, k, tol):
    """Rows whose top k + 1 values (descending; an array or a tensor) each
    exceed the next by more than ``tol``: the order of their top k is
    decided, so two top-k's of them give the same ids."""
    v = vals.detach().cpu().numpy() if hasattr(vals, "detach") else vals
    return (-np.diff(v[:, :k + 1], axis=1) > tol).all(axis=1)
