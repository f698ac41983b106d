"""Training rows whose all-pairs pass finished, over the time from the
window's start to the end of the last whole pass (synchronised)."""
from pb.stats import rate


def read(rec):
    if not rec.get("passes"):
        return None
    return rate(rec["rows"] * rec["passes"], rec["window_s"])
