"""Fault-tolerance runtime: heartbeats, straggler detection, elastic re-mesh
(the JAX package's supervisor, copied: numpy and the clock only).

On a multi-host deployment each host runs this controller around the
train loop; the tests exercise the same code with simulated clocks and
simulated host loss.

Components
----------
- HeartbeatMonitor: per-host step timestamps; a host is a *straggler* when
  its step latency exceeds ``slack`` × the fleet median, and *dead* after
  ``timeout`` seconds of silence.
- ElasticPlan: given surviving pod ids, recompute the mesh shape and the
  batch re-balancing (drop to the largest (pods × data × model) grid that
  the survivors fill; restore from the last checkpoint with new shardings —
  checkpoint.py saves unsharded leaves precisely so this re-shard is a
  placement, not a format migration).
- recovery loop: train_with_recovery drives step → heartbeat → (maybe)
  checkpoint → (maybe) simulated failure → restore, and is what the
  integration test runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["HeartbeatMonitor", "ElasticPlan", "plan_elastic_mesh",
           "train_with_recovery"]


@dataclasses.dataclass
class HeartbeatMonitor:
    n_hosts: int
    slack: float = 2.5            # straggler multiplier vs fleet median
    timeout: float = 60.0         # seconds of silence -> dead
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_beat = np.full(self.n_hosts, now)
        self.step_times: Dict[int, List[float]] = {i: [] for i in range(self.n_hosts)}

    def beat(self, host: int, step_duration: float):
        self.last_beat[host] = self.clock()
        hist = self.step_times[host]
        hist.append(step_duration)
        if len(hist) > 32:
            hist.pop(0)

    def stragglers(self) -> List[int]:
        med = np.median([np.mean(v) for v in self.step_times.values() if v]
                        or [0.0])
        if med <= 0:
            return []
        return [h for h, v in self.step_times.items()
                if v and np.mean(v[-4:]) > self.slack * med]

    def dead(self) -> List[int]:
        now = self.clock()
        return [h for h in range(self.n_hosts)
                if now - self.last_beat[h] > self.timeout]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    surviving_pods: tuple
    global_batch: int


def plan_elastic_mesh(total_pods: int, failed_pods: Sequence[int],
                      data: int = 16, model: int = 16,
                      global_batch: int = 256) -> ElasticPlan:
    """Rebuild the largest coherent mesh from surviving pods.

    Batch per pod stays constant (weak scaling) so optimizer hyperparams
    keep their per-replica semantics; the *global* batch shrinks with pods.
    """
    surviving = tuple(p for p in range(total_pods) if p not in set(failed_pods))
    n = len(surviving)
    assert n >= 1, "no surviving pods"
    if n == 1:
        return ElasticPlan((data, model), ("data", "model"), surviving,
                           max(1, global_batch // total_pods))
    return ElasticPlan((n, data, model), ("pod", "data", "model"), surviving,
                       global_batch * n // total_pods)


def train_with_recovery(step_fn: Callable, state, batches,
                        ckpt_dir: str, save_every: int = 10,
                        fail_at: Optional[int] = None,
                        monitor: Optional[HeartbeatMonitor] = None,
                        start_step: int = 0):
    """Run a recoverable loop; simulated failure raises at `fail_at` and the
    caller restarts from the latest checkpoint (see tests/test_fault_tolerance).

    The data pipeline is skip-ahead: `batches` is indexable by step so a
    resumed run consumes exactly the batches it would have seen.
    """
    from .checkpoint import save_checkpoint

    metrics_hist = []
    for step in range(start_step, len(batches)):
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"simulated node failure at step {step}")
        # step timing goes through the monitor's clock so recovery runs are
        # deterministically testable with a fake clock (no real sleeps)
        clock = time.monotonic if monitor is None else monitor.clock
        t0 = clock()
        state, metrics = step_fn(state, batches[step])
        if monitor is not None:
            monitor.beat(0, clock() - t0)
        metrics_hist.append({k: float(v) for k, v in metrics.items()})
        if (step + 1) % save_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state)
    return state, metrics_hist
