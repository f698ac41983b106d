"""Out-of-sample proximity serving end to end on the card (twin of the
reference's ``examples/serve_proximities.py``): fit a forest kernel, warm
the application states, prototype-compress it, then serve a mixed request
stream (predict / topk / outlier / propagate / embed) through the
continuous-batching ``ProximityServer`` and compare the full and compressed
models.  Ends with the observability layer: a per-tier latency table read
from the shared metrics registry, the Prometheus exposition, and, where
asked, a Chrome-trace JSON of each request's path through the tier ladder.

    PYTHONPATH=src python -m repro_torch.serve_proximities [--device cpu]
        [--n 4000] [--trees 30] [--slots 32] [--trace-out trace.json]
        [--metrics-out metrics.txt]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .applications.embed import ProximityEmbedding
from .applications.prototypes import compress
from .core.api import ForestKernel
from .data.synthetic import gaussian_classes, train_test_split
from .obs.metrics import parse_exposition


def main(n: int = 4000, d: int = 12, n_trees: int = 30, slots: int = 32,
         device: str = "cuda", trace_out: str = "",
         metrics_out: str = "") -> dict:
    X, y = gaussian_classes(n, d=d, n_classes=4, sep=3.0, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=0.2, seed=0)
    fk = ForestKernel(kernel_method="gap", n_trees=n_trees, seed=0,
                      device=device).fit(Xtr, ytr)
    print(f"fitted: {len(Xtr)} samples, {n_trees} trees, device "
          f"{fk.engine.device}")

    # serving-side application states: warm-started propagation + embedding
    rng = np.random.default_rng(0)
    labeled = rng.random(len(ytr)) < 0.1
    propagator = fk.propagate_labels(labeled, online=True)
    embedding = ProximityEmbedding(n_components=2).fit(fk.engine)

    # 1. full-engine server: mixed request stream
    srv = fk.serve(n_slots=slots, propagator=propagator,
                   embedding=embedding)
    reqs = [("predict", Xte[:16]), ("topk", Xte[16:24], 5),
            ("outlier", Xte[24:40]), ("propagate", Xte[40:56]),
            ("embed", Xte[56:72]), ("predict", Xte[72:88])]
    res = srv.serve(reqs)
    acc = float(np.mean(np.concatenate([res[0]["labels"], res[5]["labels"]])
                        == np.concatenate([yte[:16], yte[72:88]])))
    st = srv.stats()
    print(f"full engine: {st['requests']} requests / {st['rows']} rows in "
          f"{st['ticks']} ticks, predict acc {acc:.3f}")
    for kind, ks in sorted(st["kinds"].items()):
        print(f"  {kind:>9}: n={ks['requests']}  p50 {ks['p50_ms']:.2f}ms  "
              f"p95 {ks['p95_ms']:.2f}ms")
    if acc <= 0.9:
        raise RuntimeError(f"full-engine serving accuracy {acc:.3f} <= 0.9")

    # 2. prototype compression: low-memory serving model
    ce = compress(fk.engine, ytr, n_prototypes=10, k=60)
    ratio = fk.engine.memory_bytes()["total"] / ce.memory_bytes()["total"]
    print(f"compressed: {ce.W.shape[0]} prototype columns vs "
          f"{fk.engine.W.shape[0]} training columns "
          f"({ratio:.1f}x smaller factors, per-class coverage "
          f"{ {c: round(v, 2) for c, v in ce.coverage_.items()} })")

    # 3. compressed server agrees with the full model on what it serves
    srv_c = fk.serve(n_slots=slots, engine=ce)
    got = srv_c.serve([("predict", Xte[:32]), ("topk", Xte[:8], 3)])
    full_labels = srv.serve([("predict", Xte[:32])])[0]["labels"]
    agree = float((got[0]["labels"] == full_labels).mean())
    acc_c = float((got[0]["labels"] == yte[:32]).mean())
    print(f"compressed serving: predict agreement {agree:.3f} vs full, "
          f"accuracy {acc_c:.3f}; topk serves training-row ids "
          f"{got[1]['indices'][0]}")
    if agree < 0.85:
        raise RuntimeError(f"compressed agreement {agree:.3f} < 0.85")

    # 4. tiered serving: shallow -> compressed -> full ladder with
    #    confidence escalation, deadlines, and observability counters
    tsrv = fk.serve_tiered(prefix_depth=4, compressed_engine=ce,
                           n_slots=slots, escalate_margin=0.3,
                           propagator=propagator, embedding=embedding)
    tres = tsrv.serve([("predict", Xte[:32]), ("topk", Xte[:8], 5),
                       ("predict", Xte[32:64]), ("embed", Xte[64:80]),
                       ("outlier", Xte[80:96])])
    tacc = float(np.mean(np.concatenate([tres[0]["labels"],
                                         tres[2]["labels"]])
                         == np.concatenate([yte[:32], yte[32:64]])))
    ts = tsrv.stats()
    print(f"tiered serving: {ts['requests']} requests, predict acc "
          f"{tacc:.3f}, escalations {ts['escalations']} "
          f"(rate {ts['escalation_rate']:.2f}), shed {ts['shed']}, "
          f"timeouts {ts['timeouts']}")
    for name, tstat in ts["tiers"].items():
        qc = tstat["qs_cache"]
        print(f"  tier {name:>10}: routed={tstat['routed_requests']}  "
              f"shed={tstat['shed']}  qs-cache "
              f"{qc['hits']}/{qc['hits'] + qc['misses']} hits "
              f"(rate {qc['hit_rate']:.2f})")
    if tacc <= 0.9:
        raise RuntimeError(f"tiered serving accuracy {tacc:.3f} <= 0.9")

    # 5. observability: per-tier latency table from the shared registry,
    #    Prometheus exposition, and a Chrome-trace of the request spans
    print("per-tier latency (registry histograms):")
    print(f"  {'tier':>10} {'kind':>9} {'n':>5} {'p50 ms':>8} "
          f"{'p95 ms':>8} {'p99 ms':>8}")
    for name, tstat in ts["tiers"].items():
        for kind, ks in sorted(tstat["kinds"].items()):
            h = tsrv.registry.histogram(
                "serve_request_seconds",
                labels=("tier", "kind")).labels(tier=name, kind=kind)
            print(f"  {name:>10} {kind:>9} {ks['requests']:>5} "
                  f"{ks['p50_ms']:>8.2f} {ks['p95_ms']:>8.2f} "
                  f"{h.percentile(99) * 1e3:>8.2f}")
    text = tsrv.registry.exposition()
    series = parse_exposition(text)
    print(f"prometheus exposition: {len(text.splitlines())} lines, "
          f"{len(series)} series (round-trip parsed)")
    if metrics_out:
        with open(metrics_out, "w") as fh:
            fh.write(text)
        print(f"  wrote {metrics_out}")
    if trace_out:
        obj = tsrv.tracer.export(trace_out)
        n_spans = sum(1 for e in obj["traceEvents"] if e["ph"] == "X")
        print(f"chrome trace: {len(tsrv.tracer.spans())} requests, "
              f"{n_spans} spans, {len(obj['traceEvents'])} events "
              f"-> {trace_out}")
        with open(trace_out) as fh:          # well-formed JSON on disk
            json.load(fh)
    print("OK")
    return {"acc": acc, "agree": agree, "tiered_acc": tacc,
            "escalations": ts["escalations"], "series": len(series)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--trees", type=int, default=30)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--trace-out", default="",
                    help="Chrome-trace JSON output path ('' to skip)")
    ap.add_argument("--metrics-out", default="",
                    help="Prometheus exposition output path ('' to skip)")
    a = ap.parse_args()
    main(a.n, a.d, a.trees, a.slots, a.device, a.trace_out, a.metrics_out)
