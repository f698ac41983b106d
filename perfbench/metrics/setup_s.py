"""Set-up: process start to the window's start (kernel libraries loaded or
built, rows made from the seed, the fit, the factors, the warm-up of the
cell's shapes)."""


def read(rec):
    return rec.get("setup_s")
