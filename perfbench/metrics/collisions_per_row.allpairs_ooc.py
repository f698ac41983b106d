"""``core/collide.py``'s collision path: the products it enumerated over
the query rows it served in the window, from the program's counters
``engine_collisions_total`` and ``engine_collide_rows_total`` read before
and after the window."""


def read(rec):
    c = rec.get("counters")
    if not c:
        return None
    rows = c["after"]["engine_collide_rows_total"] - \
        c["before"]["engine_collide_rows_total"]
    if rows <= 0:
        return None
    return (c["after"]["engine_collisions_total"]
            - c["before"]["engine_collisions_total"]) / rows
