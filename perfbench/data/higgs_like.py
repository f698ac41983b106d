"""Rows in the shape of UCI HIGGS (Baldi, Sadowski & Whiteson 2014): 21
low-level kinematic features (lepton pT, η, φ; missing energy magnitude
and φ; four jets' pT, η, φ and b-tag) and 7 high-level invariant masses
computed from them, with a binary label (signal share as configured).  No
dataset ships with the benchmark, so this stands in (the configuration
lists it under ``assumed``).

Each label has its own distributions, fixed by ``structure_seed``:
log-normal transverse momenta, Gaussian pseudorapidities, uniform angles,
three-valued b-tags.  The masses are those of massless pairs,
m² = 2 pT_a pT_b (cosh Δη − cos Δφ), summed over the objects of each
system.  Rows come from ``--seed`` on the device; every seed has exactly
the same number of rows of each label, in its own order.
"""
from __future__ import annotations

import numpy as np

from pb.rng import device_generator, exact_shares

N_JETS = 4


def _structure(cfg: dict):
    rng = np.random.default_rng(cfg["structure_seed"])
    s = cfg["label_contrast"]
    # per label: log-pT location of lepton, MET, 4 jets; η widths; b-tag
    # probabilities of each jet
    base_pt = rng.uniform(-0.3, 0.3, size=6)
    pt = np.stack([base_pt, base_pt + s * rng.normal(size=6)])
    eta = np.stack([np.full(5, 1.0), 1.0 + s * rng.uniform(-0.5, 0.5, 5)])
    tag_base = rng.dirichlet(np.ones(3), size=N_JETS)
    tag_sig = np.stack([rng.dirichlet(1.0 + 4 * s * t) for t in tag_base])
    return pt, eta, np.stack([tag_base, tag_sig])


def generate(cfg: dict, seed: int, stream: str, n: int, device):
    import torch
    pt, eta, tag = _structure(cfg)
    g = device_generator(torch, device, seed, stream)
    f64 = dict(dtype=torch.float64, device=device)
    share = cfg["signal_share"]
    labels = exact_shares(n, {0: 1 - share, 1: share})
    y = torch.as_tensor(np.asarray(labels, np.int64), device=device)
    y = y[torch.randperm(n, generator=g, device=device)]
    z = torch.randn((n, 6), generator=g, **f64)
    p = torch.exp(torch.as_tensor(pt, **f64)[y] + 0.5 * z)      # l, v, j1-4
    e = torch.randn((n, 5), generator=g, **f64) * \
        torch.as_tensor(eta, **f64)[y]                           # l, j1-4
    f = (torch.rand((n, 6), generator=g, **f64) * 2 - 1) * np.pi
    cdf = torch.as_tensor(np.cumsum(tag, axis=2), **f64)[y]      # (n, 4, 3)
    u = torch.rand((n, N_JETS, 1), generator=g, **f64) * cdf[..., -1:]
    btag = torch.searchsorted(cdf, u).clamp_max(2)[..., 0].double() * 1.1
    lep = (p[:, 0], e[:, 0], f[:, 0])
    met = (p[:, 1], torch.zeros_like(p[:, 1]), f[:, 1])
    jets = [(p[:, 2 + j], e[:, 1 + j], f[:, 2 + j]) for j in range(N_JETS)]

    def m(*objs):
        tot = torch.zeros(n, **f64)
        for a in range(len(objs)):
            for b in range(a + 1, len(objs)):
                pa, ea, fa = objs[a]
                pb_, eb, fb = objs[b]
                tot = tot + 2 * pa * pb_ * (torch.cosh(ea - eb)
                                            - torch.cos(fa - fb))
        return torch.sqrt(tot)

    low = [lep[0], lep[1], lep[2], met[0], met[2]]
    for j in range(N_JETS):
        low += [jets[j][0], jets[j][1], jets[j][2], btag[:, j]]
    high = [m(jets[0], jets[1]), m(jets[0], jets[1], jets[2]),
            m(lep, met), m(jets[0], lep, met), m(jets[2], jets[3]),
            m(jets[0], jets[2], jets[3]),
            m(lep, met, jets[0], jets[2], jets[3])]
    X = torch.stack(low + high, dim=1)
    if X.shape[1] != cfg["n_features"]:
        raise ValueError(f"made {X.shape[1]} features, the configuration "
                         f"states {cfg['n_features']}")
    return X.cpu().numpy(), y.cpu().numpy()
