"""Metric arithmetic: a rate over the whole window."""
from __future__ import annotations


def rate(count: float, seconds: float) -> float:
    """Work over the whole window: ``count`` units in ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return float(count) / float(seconds)
