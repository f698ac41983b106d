"""Seeds of the benchmark's generators, derived from ``--seed``, and exact
shares of labels."""
from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)),
                                spawn_key=(zlib.crc32(stream.encode()),
                                           int(seed < 0)))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def device_generator(torch, device, seed: int, stream: str):
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, stream))
    return g


def stream(seed: int, key: int) -> np.random.Generator:
    """An independent host generator per (seed, key)."""
    return np.random.default_rng(np.random.SeedSequence(abs(int(seed)),
                                                        spawn_key=(key,)))


def exact_shares(n: int, shares: Dict) -> List:
    """``n`` labels in the given shares (largest remainders)."""
    names = list(shares)
    w = np.asarray([shares[k] for k in names], dtype=np.float64)
    w = w / w.sum() * n
    cnt = np.floor(w).astype(np.int64)
    rest = n - int(cnt.sum())
    cnt[np.argsort(-(w - cnt), kind="stable")[:rest]] += 1
    return [k for k, c in zip(names, cnt) for _ in range(int(c))]
