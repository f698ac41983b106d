"""``core/engine.py`` around K2 (block loop, ``torch.topk`` and the tie
rule, squares, class sums, copies): device ms of every operation of the
window that is not K2, per pass."""
from pb.trace import seconds_of


def read(rec):
    t = rec.get("trace")
    if t is None or not rec.get("passes") or not t["ops"]:
        return None
    return seconds_of(t, "block_prox", invert=True) / rec["passes"] * 1e3
