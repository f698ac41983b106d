"""Token data pipeline: synthetic corpus, deterministic skip-ahead batching.

The port's own copy of the JAX package's pipeline (numpy only): the same
seed gives the same tokens, bit for bit.

Offline container ⇒ the corpus is a synthetic Zipf-ish Markov stream with
enough structure that a ~100M model's loss drops visibly in a few hundred
steps.  The pipeline contract is what matters for the framework:

  - deterministic per-step batches (``batch_at(step)``) so a restarted run
    consumes exactly the batches it missed (checkpoint/restart skip-ahead),
  - host-sharded loading: each host materializes only its slice of the
    global batch (``host_slice``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["SyntheticCorpus", "TokenPipeline"]


@dataclasses.dataclass
class SyntheticCorpus:
    """Order-1 Markov chain with Zipf marginals + periodic template motifs."""
    vocab: int = 4096
    seed: int = 0
    n_motifs: int = 64
    motif_len: int = 16

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.motifs = rng.integers(1, self.vocab,
                                   size=(self.n_motifs, self.motif_len))

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        """Sequences = random concatenation of motifs with Zipf noise gaps."""
        out = np.empty((batch, seq + 1), dtype=np.int32)
        for b in range(batch):
            toks = []
            while sum(len(t) for t in toks) < seq + 1:
                if rng.random() < 0.7:
                    toks.append(self.motifs[rng.integers(self.n_motifs)])
                else:
                    gap = rng.zipf(1.5, size=rng.integers(1, 8)) % self.vocab
                    toks.append(gap.astype(np.int64))
            row = np.concatenate(toks)[: seq + 1]
            out[b] = row.astype(np.int32) % self.vocab
        return out


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    d_model_for_image: Optional[int] = None   # vlm stub frontend
    image_prefix: int = 0

    def __post_init__(self):
        self.corpus = SyntheticCorpus(vocab=self.vocab, seed=self.seed)
        assert self.global_batch % self.n_hosts == 0

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (host-sharded slice)."""
        rng = np.random.default_rng(
            (self.seed, step, self.host_id))
        toks = self.corpus.sample(rng, self.host_batch, self.seq_len)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.image_prefix:
            out["image_embed"] = rng.normal(
                0, 1, (self.host_batch, self.image_prefix,
                       self.d_model_for_image)).astype(np.float32)
        return out

    def __len__(self):
        return 1 << 30

    def __getitem__(self, step: int):
        return self.batch_at(step)
