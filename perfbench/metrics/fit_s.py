"""The forest's fit (``ForestKernel.fit_forest``: ``forest/ensemble.py``,
``forest/training.py``, K3/K4), host clock, ending in a synchronise."""


def read(rec):
    return rec.get("fit_s")
