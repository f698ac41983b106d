"""The passes' device work against the least time their results need, as
``prox_roofline_pct.allpairs`` reads it (``pb/roofline.py::allpairs_work``
counts collisions, not a dense block): 100 × least time × passes over the
device seconds of every operation in the window."""
from pb.common import load_module

read = load_module("metrics", "prox_roofline_pct.allpairs").read
