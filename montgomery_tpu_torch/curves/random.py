"""Fast random subgroup points for benchmarks.

Counterpart of `random_points_fast` and `random_points_fast_edwards` in
`montgomery_tpu/curves/random.py`, with the same seed scheme, so a seed gives
the same points in both packages: `n_tables` bases from
`random.Random(seed)`, table t holding the multiples (j + 3) B_t for
j < table_size, and table indices from `numpy.random.default_rng(seed)`.
Point i is sum_t (idx[t, i] + 3) B_t.
"""

from __future__ import annotations

import random as pyrandom
from pathlib import Path

import numpy as np
import torch

from ..bigint.twisted_edwards import EdwardsParams, TwistedEdwardsCurve
from ..bigint.weierstrass import WeierstrassCurve
from .edwards import EdwardsBatch, EdwardsOps
from .projective import AffineBatch, ProjectiveOps, normalize_host


def table_indices(seed: int, N: int, n_tables: int = 8, table_size: int = 512) -> np.ndarray:
    """(n_tables, N) uniform table indices. The combination space must be
    large (72 bits by default): small spaces make partial sums inside one
    bucket collide."""
    if table_size ** n_tables < 1 << 64:
        raise ValueError("combination space too small")
    return np.random.default_rng(seed).integers(0, table_size, size=(n_tables, N))


def table_bases(params, seed: int, n_tables: int = 8) -> list:
    """The table bases of `params`' curve (Weierstrass or Edwards)."""
    rng = pyrandom.Random(seed)
    C = TwistedEdwardsCurve(params) if isinstance(params, EdwardsParams) else WeierstrassCurve(params)
    return [C.random_point(rng) for _ in range(n_tables)]


def _build_tables(ops, B, table_size: int):
    """Planes (n, n_tables, table_size) with entry j of table t = (j+3) B_t,
    in log2(table_size) levels: T <- [T, T + m B] with m doubling. `ops` is
    a ProjectiveOps or an EdwardsOps, B a batch of its type."""
    kind = type(B)
    T = ops.add(ops.double(B), B)
    T = kind(*[a[..., None] for a in T])
    Pm = kind(*[a[..., None] for a in B])  # m B with m = 1
    while T.X.shape[-1] < table_size:
        shifted = ops.add(T, kind(*[a.expand_as(t) for a, t in zip(Pm, T)]))
        T = kind(*[torch.cat([a, b], -1) for a, b in zip(T, shifted)])
        Pm = ops.double(Pm)
    return kind(*[a[..., :table_size] for a in T])


def _table_sums(ops, B, N: int, seed: int, n_tables: int, table_size: int):
    """Point i = sum_t (idx[t, i] + 3) B_t, as a batch of `ops`' type."""
    tab = _build_tables(ops, B, table_size)
    idx = torch.from_numpy(table_indices(seed, N, n_tables, table_size)).to(B.X.device)
    acc = None
    for t in range(n_tables):
        pick = type(B)(*[a[:, t].index_select(-1, idx[t]) for a in tab])
        acc = pick if acc is None else ops.add(acc, pick)
    return acc


def _cache_path(cache_dir, label: str, N: int, seed: int, n_tables: int, table_size: int):
    if cache_dir is None:
        return None
    return Path(cache_dir) / f"points_{label}_{N}_s{seed}_{n_tables}x{table_size}.npz"


def _save(cache: Path | None, xs: np.ndarray, ys: np.ndarray) -> None:
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npz")
        np.savez(tmp, x=xs, y=ys)
        tmp.replace(cache)


def random_points_fast(proj: ProjectiveOps, N: int, seed: int = 0, device="cuda",
                       n_tables: int = 8, table_size: int = 512,
                       cache_dir: str | Path | None = None) -> AffineBatch:
    """N random subgroup points as a Montgomery-form AffineBatch on `device`.
    The tables and their sums run on the device (kernel 2); the sums are
    normalised on the host with one inversion. With `cache_dir`, the
    canonical affine points are kept there between runs."""
    f = proj.f
    cache = _cache_path(cache_dir, proj.params.label, N, seed, n_tables, table_size)
    if cache is not None and cache.exists():
        z = np.load(cache)
        both = torch.from_numpy(np.concatenate([z["x"], z["y"]], axis=1)).to(device)
        both = f.to_montgomery(both)
        return AffineBatch(both[:, :N], both[:, N:],
                           torch.zeros(N, dtype=torch.bool, device=device))
    bases = table_bases(proj.params, seed, n_tables)
    B = proj.from_affine(proj.affine_to_device(bases, device))  # (n, n_tables)
    acc = _table_sums(proj, B, N, seed, n_tables, table_size)
    X, Y, Z = zip(*proj.to_host_raw(acc))
    pts = normalize_host(list(X), list(Y), list(Z), f.p)
    if any(P.is_zero for P in pts):
        raise RuntimeError("a random point summed to infinity")
    xs = f.host_planes([P.x for P in pts])
    ys = f.host_planes([P.y for P in pts])
    _save(cache, xs, ys)
    both = f.to_montgomery(torch.from_numpy(np.concatenate([xs, ys], axis=1)).to(device))
    return AffineBatch(both[:, :N], both[:, N:], torch.zeros(N, dtype=torch.bool, device=device))


def random_points_fast_edwards(ed: EdwardsOps, N: int, seed: int = 0, device="cuda",
                               n_tables: int = 8, table_size: int = 512,
                               cache_dir: str | Path | None = None) -> EdwardsBatch:
    """N random Twisted Edwards subgroup points as a Montgomery-form
    EdwardsBatch (Z = 1) on `device`: the same points as montgomery_tpu's
    random_points_fast_edwards (which returns them unnormalised). The tables
    and their sums run on the device (kernel `ed_add`, `ed_dbl`), and so does
    the normalisation (one batch inversion). With `cache_dir`, the canonical
    affine coordinates are kept there between runs."""
    f = ed.f
    cache = _cache_path(cache_dir, ed.params.label, N, seed, n_tables, table_size)
    if cache is not None and cache.exists():
        z = np.load(cache)
        both = torch.from_numpy(np.concatenate([z["x"], z["y"]], axis=1)).to(device)
    else:
        B = ed.to_device(table_bases(ed.params, seed, n_tables), device)  # (n, n_tables)
        x, y = ed.to_affine(_table_sums(ed, B, N, seed, n_tables, table_size))
        both = f.from_montgomery(torch.cat([x, y], dim=-1))
        _save(cache, both[:, :N].cpu().numpy(), both[:, N:].cpu().numpy())
    both = f.to_montgomery(both)
    return ed.from_affine_arrays(both[:, :N], both[:, N:])
