"""Limb codec: Python ints or packed bytes <-> (n, N) limb planes.

Counterpart of `montgomery_tpu/ops/limbs.py`. A batch of N field elements is
an (n, N) int32 tensor with the batch on the minor axis, so limb k of lane i
sits at flat offset k*N + i and a warp's loads are coalesced. Field elements
use 32-bit limbs stored as int32 bit patterns (W = 32, n = 12 for the 377-bit
BLS12-377 base field); scalars keep the JAX package's 13-bit limbs, because
the GLV decomposition's truncated products are defined on that limb grid.
"""

from __future__ import annotations

import numpy as np
import torch

W = 32


def bytes_to_limbs(data, n_bytes: int, w: int, n_limbs: int) -> np.ndarray:
    """Packed little-endian bytes (N elements of n_bytes each) -> (n_limbs, N)
    int32 planes of w-bit limbs, w <= 32 (vectorised over N). Limbs of
    w = 32 come back as int32 bit patterns."""
    B = np.frombuffer(bytes(data), dtype=np.uint8).reshape(-1, n_bytes)
    out = np.zeros((n_limbs, B.shape[0]), dtype=np.uint64)
    mask = np.uint64((1 << w) - 1)
    for j in range(n_limbs):
        off = j * w
        s, r = off // 8, off % 8
        if s >= n_bytes:
            break
        val = B[:, s].astype(np.uint64) >> np.uint64(r)
        have = 8 - r
        t = 1
        while have < w and s + t < n_bytes:
            val |= B[:, s + t].astype(np.uint64) << np.uint64(have)
            have += 8
            t += 1
        out[j] = val & mask
    return out.astype(np.uint32).view(np.int32)


def ints_to_bytes(values, n_bytes: int) -> bytes:
    return b"".join(int(v).to_bytes(n_bytes, "little") for v in values)


def pack(values, n: int) -> np.ndarray:
    """Python ints, each in [0, 2^(32n)), -> (n, N) int32 planes of 32-bit limbs."""
    return bytes_to_limbs(ints_to_bytes(values, 4 * n), 4 * n, W, n)


def unpack(arr) -> list[int]:
    """(n, N) planes of 32-bit limbs (numpy or tensor) -> Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int32).view(np.uint32).T)
    n = a.shape[1]
    raw = a.astype("<u4").tobytes()
    return [int.from_bytes(raw[4 * n * j: 4 * n * (j + 1)], "little")
            for j in range(a.shape[0])]


def pack_scalar(value: int, n: int) -> np.ndarray:
    """One int as an (n, 1) constant plane."""
    return pack([value], n)


def to_words(value: int, n: int) -> list[int]:
    """One int as n little-endian 32-bit words (kernel constant arguments)."""
    return [(value >> (W * k)) & 0xFFFFFFFF for k in range(n)]
