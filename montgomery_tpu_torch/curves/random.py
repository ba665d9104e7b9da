"""Fast random subgroup points for benchmarks.

Counterpart of `random_points_fast` in `montgomery_tpu/curves/random.py`,
with the same seed scheme, so a seed gives the same points in both packages:
`n_tables` bases from `random.Random(seed)`, table t holding the multiples
(j + 3) B_t for j < table_size, and table indices from
`numpy.random.default_rng(seed)`. Point i is sum_t (idx[t, i] + 3) B_t.
"""

from __future__ import annotations

import random as pyrandom
from pathlib import Path

import numpy as np
import torch

from ..bigint.weierstrass import WeierstrassCurve
from .projective import AffineBatch, ProjectiveBatch, ProjectiveOps, normalize_host


def table_indices(seed: int, N: int, n_tables: int = 8, table_size: int = 512) -> np.ndarray:
    """(n_tables, N) uniform table indices. The combination space must be
    large (72 bits by default): small spaces make partial sums inside one
    bucket collide."""
    if table_size ** n_tables < 1 << 64:
        raise ValueError("combination space too small")
    return np.random.default_rng(seed).integers(0, table_size, size=(n_tables, N))


def table_bases(params, seed: int, n_tables: int = 8) -> list:
    rng = pyrandom.Random(seed)
    C = WeierstrassCurve(params)
    return [C.random_point(rng) for _ in range(n_tables)]


def _build_tables(proj: ProjectiveOps, B: ProjectiveBatch, table_size: int) -> ProjectiveBatch:
    """Planes (n, n_tables, table_size) with entry j of table t = (j+3) B_t,
    in log2(table_size) levels: T <- [T, T + m B] with m doubling."""
    T = proj.add(proj.double(B), B)
    T = ProjectiveBatch(*[a[..., None] for a in T])
    Pm = ProjectiveBatch(*[a[..., None] for a in B])  # m B with m = 1
    while T.X.shape[-1] < table_size:
        shifted = proj.add(T, ProjectiveBatch(*[a.expand_as(t) for a, t in zip(Pm, T)]))
        T = ProjectiveBatch(*[torch.cat([a, b], -1) for a, b in zip(T, shifted)])
        Pm = proj.double(Pm)
    return ProjectiveBatch(*[a[..., :table_size] for a in T])


def random_points_fast(proj: ProjectiveOps, N: int, seed: int = 0, device="cuda",
                       n_tables: int = 8, table_size: int = 512,
                       cache_dir: str | Path | None = None) -> AffineBatch:
    """N random subgroup points as a Montgomery-form AffineBatch on `device`.
    The tables and their sums run on the device (kernel 2); the sums are
    normalised on the host with one inversion. With `cache_dir`, the
    canonical affine points are kept there between runs."""
    f = proj.f
    cache = None
    if cache_dir is not None:
        cache = Path(cache_dir) / f"points_{proj.params.label}_{N}_s{seed}_{n_tables}x{table_size}.npz"
        if cache.exists():
            z = np.load(cache)
            both = torch.from_numpy(np.concatenate([z["x"], z["y"]], axis=1)).to(device)
            both = f.to_montgomery(both)
            return AffineBatch(both[:, :N], both[:, N:],
                               torch.zeros(N, dtype=torch.bool, device=device))
    bases = table_bases(proj.params, seed, n_tables)
    B = proj.from_affine(proj.affine_to_device(bases, device))  # (n, n_tables)
    tab = _build_tables(proj, B, table_size)
    idx = torch.from_numpy(table_indices(seed, N, n_tables, table_size)).to(device)
    acc = None
    for t in range(n_tables):
        pick = ProjectiveBatch(*[a[:, t].index_select(-1, idx[t]) for a in tab])
        acc = pick if acc is None else proj.add(acc, pick)
    X, Y, Z = zip(*proj.to_host_raw(acc))
    pts = normalize_host(list(X), list(Y), list(Z), f.p)
    if any(P.is_zero for P in pts):
        raise RuntimeError("a random point summed to infinity")
    xs = f.host_planes([P.x for P in pts])
    ys = f.host_planes([P.y for P in pts])
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npz")
        np.savez(tmp, x=xs, y=ys)
        tmp.replace(cache)
    both = f.to_montgomery(torch.from_numpy(np.concatenate([xs, ys], axis=1)).to(device))
    return AffineBatch(both[:, :N], both[:, N:], torch.zeros(N, dtype=torch.bool, device=device))
