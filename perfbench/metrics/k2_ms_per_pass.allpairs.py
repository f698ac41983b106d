"""``kernels/block_prox`` (K2, either form): device ms of its kernels in the
window, per pass."""
from pb.trace import seconds_of


def read(rec):
    t = rec.get("trace")
    if t is None or not rec.get("passes"):
        return None
    s = seconds_of(t, "block_prox")
    return None if s <= 0 else s / rec["passes"] * 1e3
