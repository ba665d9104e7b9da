"""Random subgroup points on the device.

Counterpart of `montgomery_tpu/curves/random.py`, with the same seed schemes,
so a seed gives the same points in both packages.

- `random_points_fast` and `random_points_fast_edwards` (for benchmarks):
  `n_tables` bases from `random.Random(seed)`, table t holding the multiples
  (j + 3) B_t for j < table_size, and table indices from
  `numpy.random.default_rng(seed)`. Point i is sum_t (idx[t, i] + 3) B_t.
- `random_points_weierstrass` and `random_points_edwards` (points of full
  entropy, by sqrt trial): candidate x values drawn on the host from
  `numpy.random.default_rng(seed)`, the curve equation solved on the device
  with `FieldOps.sqrt` (kernels `exp_ladder`, `sqr_n`, `sqrt_win`), the
  first N successes kept in candidate order, the cofactor cleared with
  `scale`, and (Weierstrass) the points normalised with one batch inversion.
"""

from __future__ import annotations

import random as pyrandom
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from ..bigint.twisted_edwards import EdwardsParams, TwistedEdwardsCurve
from ..bigint.weierstrass import WeierstrassCurve
from .edwards import EdwardsBatch, EdwardsOps
from .projective import AffineBatch, ProjectiveOps


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
    """N random subgroup points as a Montgomery-form AffineBatch on `device`:
    the same points as montgomery_tpu's random_points_fast. The tables, their
    sums (the group's add: the RCB kernel for a = 0) and the normalisation
    (one batch inversion, `to_affine`) run on the device. With `cache_dir`,
    the canonical affine points are kept there between runs."""
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
    if bool(proj.is_zero(acc).any()):
        raise RuntimeError("a random point summed to infinity")
    A = proj.to_affine(acc)
    both = f.from_montgomery(torch.cat([A.x, A.y], dim=-1))  # canonical, as the cache keeps them
    _save(cache, both[:, :N].cpu().numpy(), both[:, N:].cpu().numpy())
    both = f.to_montgomery(both)
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


def _uniform_field_vals(rng: np.random.Generator, M: int, p: int) -> list[int]:
    """M statistically uniform field elements: random bytes with 64 bits of
    slack, reduced mod p (bias below 2^-64); the JAX package's draw."""
    nbytes = (p.bit_length() + 7) // 8 + 8
    raw = rng.bytes(M * nbytes)
    return [int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little") % p for i in range(M)]


def _candidates(f, N: int, seed: int, oversample: float, device) -> torch.Tensor:
    """(n, M) raw planes of M = int(N * oversample) + 16 candidate x values."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions")
    M = int(N * oversample) + 16
    return f.pack_raw(_uniform_field_vals(np.random.default_rng(seed), M, f.p), device)


def _first_successes(ok: torch.Tensor, N: int) -> torch.Tensor:
    """Indices of the first N set lanes of `ok`, in candidate order."""
    idx = torch.nonzero(ok).flatten()
    if idx.numel() < N:
        raise ValueError(f"only {idx.numel()} of {ok.numel()} candidates gave a point, {N} "
                         f"needed: raise the oversample")
    return idx[:N]


def solve_weierstrass(proj: ProjectiveOps, X: torch.Tensor):
    """Raw candidate planes X -> (x, y, ok) in Montgomery form: y a root of
    x^3 + a x + b where ok (y = 0 elsewhere); a x is one `mul_const`."""
    f = proj.f
    Xm = f.to_montgomery(X)
    rhs = f.mul(f.mul(Xm, Xm), Xm)
    if not proj.a_is_zero:
        rhs = f.add(rhs, f.mul_const(Xm, proj.a_mont))
    rhs = f.add(rhs, f.const_plane(proj.b_mont, Xm))
    Y, ok = f.sqrt(rhs)
    return Xm, Y, ok


def solve_edwards(ed: EdwardsOps, X: torch.Tensor):
    """Raw candidate planes X -> (x, y, ok) in Montgomery form: y a root of
    (1 + x^2) / (1 - d x^2) where ok; 1 - d x^2 = 0 is not ok."""
    f = ed.f
    xm = f.to_montgomery(X)
    one = f.const_plane(f.R_mod_p, xm)
    xx = f.mul(xm, xm)
    num = f.add(one, xx)
    den = f.sub(one, f.mul_const(xx, ed.d_mont))
    Y, ok = f.sqrt(f.mul(num, f.batch_inv(den, handle_zero=True)))
    return xm, Y, ok & ~f.is_zero(den)


def _phase(log, label: str, device):
    return log.phase(label, device) if log is not None else nullcontext()


def random_points_weierstrass(proj: ProjectiveOps, N: int, seed: int = 0, device="cuda",
                              oversample: float = 2.5, log=None) -> AffineBatch:
    """N random subgroup points of y^2 = x^3 + a x + b (cofactor cleared), as a
    Montgomery-form AffineBatch on `device`: the JAX package's
    random_points_weierstrass. With `log` (a utils.timing.PhaseLog), each
    stage is synchronised and timed into it."""
    f, params = proj.f, proj.params
    with _phase(log, "host draw", device):
        X = _candidates(f, N, seed, oversample, device)
    with _phase(log, "solve (sqrt)", device):
        Xm, Y, ok = solve_weierstrass(proj, X)
    with _phase(log, "compaction", device):
        idx = _first_successes(ok, N)
        A = AffineBatch(Xm.index_select(-1, idx), Y.index_select(-1, idx),
                        torch.zeros(N, dtype=torch.bool, device=X.device))
    if params.cofactor == 1:
        return A
    with _phase(log, "cofactor", device):
        P = proj.scale(params.cofactor, proj.from_affine(A))
    with _phase(log, "normalisation", device):
        return proj.to_affine(P)


def random_points_edwards(ed: EdwardsOps, N: int, seed: int = 0, device="cuda",
                          oversample: float = 2.5, log=None) -> EdwardsBatch:
    """N random Twisted Edwards subgroup points (a = -1), as a Montgomery-form
    EdwardsBatch on `device`, unnormalised: the JAX package's
    random_points_edwards. y^2 = (1 + x^2) / (1 - d x^2); a candidate with
    1 - d x^2 = 0 gives no point. With `log`, each stage is timed into it."""
    f = ed.f
    with _phase(log, "host draw", device):
        X = _candidates(f, N, seed, oversample, device)
    with _phase(log, "solve (sqrt)", device):
        xm, Y, ok = solve_edwards(ed, X)
    with _phase(log, "compaction", device):
        idx = _first_successes(ok, N)
        P = ed.from_affine_arrays(xm.index_select(-1, idx), Y.index_select(-1, idx))
    if ed.params.cofactor == 1:
        return P
    with _phase(log, "cofactor", device):
        return ed.scale(ed.params.cofactor, P)
