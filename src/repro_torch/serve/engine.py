"""Continuous-batching LM serving engine.

A fixed pool of ``n_slots`` decode lanes shares one cache; requests are
admitted into free slots as they arrive and retired on completion, so the
one-token step always runs at full batch.  Per-slot position counters live
on the host and go to the device as a (n_slots,) vector each step, so lanes
at different offsets decode in one batched step.

Admission prefills a prompt token by token through the shared batched
step, exactly as the reference's engine does: each of those steps also
runs the other lanes at their current position with their current token.
That writes the same attention-cache values again, but it advances a
recurrent state (the SSM conv and state caches of ssm and hybrid models)
once more, and a recycled lane keeps its last request's recurrent state.
So on mamba2 and hymba a request's tokens can drift from its
single-request decode; the reference's engine drifts the same way, and
the two engines give the same tokens.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.lm import LM, decode_step, init_cache

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None

    # runtime
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


class ServingEngine:
    """Serves greedy decoding of ``params`` (an :class:`LM`) on the device
    that holds it."""

    def __init__(self, cfg: ArchConfig, params: LM, n_slots: int = 4,
                 max_seq: int = 256):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = params.device
        self.cache = init_cache(cfg, n_slots, max_seq, device=self.device)
        self.pos = np.zeros(n_slots, dtype=np.int64)      # per-slot position
        self.active: Dict[int, Request] = {}              # slot -> request
        self.queue: deque[Request] = deque()
        self.finished: List[Request] = []
        self._cur_token = np.zeros((n_slots, 1), dtype=np.int32)

    @torch.inference_mode()
    def _step(self) -> torch.Tensor:
        """One batched decode step at the host's tokens and positions;
        returns each lane's greedy next token (on the device)."""
        tok = torch.from_numpy(self._cur_token.copy()).to(self.device)
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        logits, self.cache = decode_step(self.params, self.cfg, tok,
                                         self.cache, pos)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    # ---------------- public API ----------------
    def submit(self, req: Request):
        req.submitted_at = time.time()
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.n_slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            req.slot = slot
            self.active[slot] = req
            # prefill: feed prompt tokens through the decode path
            for i, t in enumerate(req.prompt):
                self._cur_token[slot, 0] = t
                self.pos[slot] = i
                nxt = self._step()
            # read after the device has produced the token (the host copy
            # waits for it), so TTFT holds the prefill's device time
            self._cur_token[slot, 0] = int(nxt[slot])
            req.first_token_at = time.time()
            self.pos[slot] = len(req.prompt)

    def step(self):
        """One engine tick: admit, decode one token for every active slot."""
        self._admit()
        if not self.active:
            return
        nxt = self._step().cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.generated.append(int(self._cur_token[slot, 0]))
            self._cur_token[slot, 0] = tok
            self.pos[slot] += 1
            done = (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self.pos[slot] >= self.max_seq - 1)
            if done:
                req.done_at = time.time()
                self.finished.append(req)
                del self.active[slot]

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished

    def stats(self) -> Dict[str, float]:
        lat = [r.done_at - r.submitted_at for r in self.finished if r.done_at]
        ttft = [r.first_token_at - r.submitted_at
                for r in self.finished if r.first_token_at]
        toks = sum(len(r.generated) for r in self.finished)
        return {"requests": len(self.finished), "tokens": toks,
                "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
                "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0}
