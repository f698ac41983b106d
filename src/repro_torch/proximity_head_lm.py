"""Integration example: the paper's technique as an LM feature (twin of
the reference's ``examples/proximity_head_lm.py``).

A forest is trained on pooled LM outputs; the SWLC sparse leaf
factorization then gives task-aware nearest neighbours over the corpus and
a leaf-PCA embedding of the representation space.  On the card the LM runs
in torch and the forest through the port's kernels (K3 fits the trees, K1
routes the training set, K2 serves ``topk``).

    PYTHONPATH=src python -m repro_torch.proximity_head_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from .configs.base import get_config
from .core.api import ForestKernel
from .data.tokens import TokenPipeline
from .models import lm

N_TREES = 40


def lm_config():
    """A small LM of the granite family."""
    return dataclasses.replace(
        get_config("granite_8b"), n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, d_head=32)


def features(device: str = "cuda", seed: int = 0):
    """Pooled final-layer logits of 512 sequences of 64 tokens (host
    float32, (512, vocab)) and a binary label per sequence."""
    cfg = lm_config()
    params = lm.init_params(cfg, seed, device=device)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=512, seq_len=64,
                         seed=7)
    tokens = pipe.batch_at(0)["tokens"]
    logits, _ = lm.forward(params, cfg, tokens, attn_chunk=32)
    # final-layer logits as features (cheap stand-in), mean-pooled
    feats = logits.float().mean(dim=1).cpu().numpy()
    # supervised signal: does the sequence contain motif-heavy structure?
    spread = tokens[:, :8].std(axis=1)
    labels = (spread > np.median(spread)).astype(int)
    return feats, labels


def fit_head(feats, labels, device: str = "cuda") -> ForestKernel:
    return ForestKernel(kernel_method="gap", n_trees=N_TREES, seed=0,
                        device=device).fit(feats, labels)


def main(device: str = "cuda") -> dict:
    feats, labels = features(device)
    fk = fit_head(feats, labels, device)
    idx, val = fk.topk(k=4)
    idx, val = idx.cpu().numpy(), val.cpu().numpy()
    acc = float((fk.predict().cpu().numpy() == labels).mean())
    print(f"[prox-head] proximity-weighted label recovery: {acc:.3f}")
    print(f"[prox-head] sample 0 retrieves train neighbours {idx[0]} "
          f"(proximities {np.round(val[0], 3)})")
    pca = fk.leaf_pca(n_components=8)
    Z = pca.transform(fk.Q_)
    same = float((labels[idx[:, 1]] == labels).mean())
    print(f"[prox-head] top-1 neighbour label agreement: {same:.3f}")
    print(f"[prox-head] leaf-PCA of the LM representation space: {Z.shape} "
          f"(device {fk.engine.device})")
    return {"acc": acc, "neighbour_agreement": same, "embedding": Z.shape}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
