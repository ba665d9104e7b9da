"""State exchange with the JAX package, through canonical integers.

`montgomery_tpu` keeps a field element as (n_jax, N) int32 planes of w-bit
limbs (w = 13, n_jax = 30 for BLS12-377, 20 for ed-on-bls12-377's base
field) in Montgomery form with R_jax = 2^(w n_jax); this port keeps (n, N)
planes of 32-bit limbs with R = 2^(32 n). The functions here take numpy arrays (what `np.asarray` of a
JAX array gives) and return torch tensors, and back. Limb regrouping is
vectorised with numpy; only the Montgomery change of radix is per element.
Scalar limb planes use the same 13-bit limbs in both packages and pass
through unchanged. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.edwards import EdwardsBatch
from .curves.projective import AffineBatch, ProjectiveBatch
from .ops import limbs as codec
from .ops.field import FieldOps


def planes_to_ints(arr, w: int) -> list[int]:
    """(n, N) planes of non-negative w-bit limbs -> Python ints."""
    a = np.asarray(arr, dtype=np.int64)
    n, N = a.shape
    bits = ((a[:, :, None] >> np.arange(w)) & 1).transpose(1, 0, 2).reshape(N, n * w)
    pad = (-bits.shape[1]) % 8
    bits = np.pad(bits, ((0, 0), (0, pad))).astype(np.uint8)
    raw = np.packbits(bits, axis=1, bitorder="little")
    return [int.from_bytes(row.tobytes(), "little") for row in raw]


def ints_to_planes(values, w: int, n: int) -> np.ndarray:
    """Python ints in [0, 2^(w n)) -> (n, N) int32 planes of w-bit limbs."""
    nb = -(-(w * n) // 8)
    return codec.bytes_to_limbs(codec.ints_to_bytes(values, nb), nb, w, n)


def field_from_jax(arr, f: FieldOps, w: int = 13, device="cuda") -> torch.Tensor:
    """JAX Montgomery planes -> this port's Montgomery planes (canonical)."""
    a = np.asarray(arr)
    p = f.p
    rj_inv = pow(1 << (w * a.shape[0]), -1, p)
    vals = [v * rj_inv % p * f.R % p for v in planes_to_ints(a, w)]
    return torch.from_numpy(codec.pack(vals, f.n)).to(device)


def field_to_jax(t: torch.Tensor, f: FieldOps, n_jax: int, w: int = 13) -> np.ndarray:
    """This port's Montgomery planes -> JAX Montgomery planes (canonical)."""
    p = f.p
    rj = 1 << (w * n_jax)
    vals = [v * f.R_inv % p * rj % p for v in codec.unpack(t)]
    return ints_to_planes(vals, w, n_jax)


def affine_from_jax(x, y, inf, f: FieldOps, w: int = 13, device="cuda") -> AffineBatch:
    return AffineBatch(field_from_jax(x, f, w, device), field_from_jax(y, f, w, device),
                       torch.from_numpy(np.array(inf, dtype=bool)).to(device))


def projective_from_jax(X, Y, Z, f: FieldOps, w: int = 13, device="cuda") -> ProjectiveBatch:
    return ProjectiveBatch(*[field_from_jax(a, f, w, device) for a in (X, Y, Z)])


def edwards_from_jax(X, Y, Z, T, f: FieldOps, w: int = 13, device="cuda") -> EdwardsBatch:
    """JAX extended Twisted Edwards planes -> this port's EdwardsBatch."""
    return EdwardsBatch(*[field_from_jax(a, f, w, device) for a in (X, Y, Z, T)])


def scalars_from_jax(arr, device="cuda") -> torch.Tensor:
    """(ns, N) 13-bit scalar limb planes: the same in both packages."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, dtype=np.int32))).to(device)
