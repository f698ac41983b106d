"""``core/engine.py``'s tie rule: 100 × the rows whose ties at the k-th
value spilled past the selection's spare candidates (redone exactly after a
host read) over the rows top-k selected from dense blocks, from the
program's process-wide counters ``engine_topk_spill_rows_total`` and
``engine_topk_rows_total``.  The counters hold every pass of the run, the
warm-up's too; each pass selects on the same blocks, so the share is the
window's."""
from repro_torch.obs.metrics import global_registry


def read(rec):
    if not rec.get("passes"):
        return None
    snap = global_registry().snapshot()
    try:
        rows = snap["engine_topk_rows_total"]["series"][""]
        spill = snap["engine_topk_spill_rows_total"]["series"][""]
    except KeyError:                 # a program without the counters
        return None
    return 100.0 * spill / rows if rows else None
