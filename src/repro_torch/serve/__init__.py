"""Proximity serving over the port's engines.

- :mod:`.proximity`   — ``ProximityServer`` (slot-batched serving of
  ``predict`` / ``topk`` / ``outlier`` / ``propagate`` / ``embed`` requests,
  one routed batch a tick) and ``TieredProximityServer`` (the shallow →
  compressed → full engine ladder with escalation, deadlines, budgets,
  spill and an async mode)
- :mod:`.reliability` — fault injection, retry with backoff, circuit
  breakers and result validation for the servers' engine calls
"""
from .proximity import (KINDS, ProximityServer, ProxRequest, Tier,
                        TieredProximityServer, TieredRequest)
from .reliability import (CircuitBreaker, CorruptedResult, FaultInjector,
                          InjectedFault, RetryPolicy, validate_finite)

__all__ = ["KINDS", "ProxRequest", "ProximityServer", "Tier",
           "TieredRequest", "TieredProximityServer", "CircuitBreaker",
           "CorruptedResult", "FaultInjector", "InjectedFault",
           "RetryPolicy", "validate_finite"]
