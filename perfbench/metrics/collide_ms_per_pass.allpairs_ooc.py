"""``core/collide.py``'s collision path: device ms of the operations
launched in the program's ``engine.collide``, ``engine.collide_select``
and ``engine.collide_sums`` spans over the window, per pass (from a window
traced with the program's regions on, ``pb/regions.py``)."""

SPANS = ("engine.collide", "engine.collide_select", "engine.collide_sums")


def read(rec):
    p = (rec.get("trace") or {}).get("program")
    if not p or not rec.get("passes"):
        return None
    s = sum(p["spans"].get(n, {}).get("device_s", 0.0) for n in SPANS)
    return None if s <= 0 else s / rec["passes"] * 1e3
