"""Input checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

__all__ = ["require"]


def require(t, dtype: torch.dtype, name: str, device=None) -> None:
    """Raise unless ``t`` is a tensor of ``dtype`` (on ``device`` if given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if device is not None and t.device != torch.device(device):
        raise ValueError(f"{name} is on {t.device}, expected {device}")
