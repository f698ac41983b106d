"""The device: the share of the traced window in which no operation ran on
it, from the union of the trace's operation intervals."""


def read(rec):
    t = rec.get("trace")
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
