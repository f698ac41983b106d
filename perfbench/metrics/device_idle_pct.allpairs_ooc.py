"""The device: the share of the traced window in which no operation ran on
it, as ``device_idle_pct.allpairs`` reads it (the union of the trace's
operation intervals)."""
from pb.common import load_module

read = load_module("metrics", "device_idle_pct.allpairs").read
