"""The passes' device work against the least time their results need
(``pb/roofline.py::allpairs_work``): 100 × least time × passes over the
device seconds of every operation in the window."""
from pb.roofline import least_s
from pb.trace import seconds_of


def read(rec):
    t, w = rec.get("trace"), rec.get("work")
    if t is None or not w or not rec.get("passes"):
        return None
    dev = seconds_of(t, "")
    if dev <= 0:
        return None
    return 100.0 * least_s(w["pass_bytes"], w["pass_fmas"]) \
        * rec["passes"] / dev
