"""The factors (``ForestKernel.build_kernel_cache``: routing of the
training set by K1, ``core/context.py``, ``core/weights.py``, the engine and
its host CSR maps), host clock, ending in a synchronise."""


def read(rec):
    return rec.get("factor_s")
