"""Limb codec: Python ints or packed bytes <-> (n, N) limb planes.

Counterpart of `montgomery_tpu/ops/limbs.py`. A batch of N field elements is
an (n, N) int32 tensor with the batch on the minor axis, so limb k of lane i
sits at flat offset k*N + i and a warp's loads are coalesced. Field elements
use 32-bit limbs stored as int32 bit patterns (W = 32; n = 12 for the 377-bit
BLS12-377 base field, 13 for BLS12-381's, 9 for Pallas's and
ed-on-bls12-377's); scalars keep the JAX package's 13-bit limbs, because
the GLV decomposition's truncated products are defined on that limb grid.
"""

from __future__ import annotations

import numpy as np
import torch

W = 32


def bytes_to_words(B: np.ndarray) -> np.ndarray:
    """(N, n_bytes) uint8 rows of little-endian elements -> (nw, N) uint64
    words, nw = ceil(n_bytes / 8)."""
    N, nb = B.shape
    nw = -(-nb // 8)
    P = np.zeros((N, 8 * nw), dtype=np.uint8)
    P[:, :nb] = B
    return np.ascontiguousarray(P.view("<u8").T)


def words_to_limbs(words: np.ndarray, w: int, n_limbs: int) -> np.ndarray:
    """(nw, N) uint64 words -> (n_limbs, N) int32 planes of w-bit limbs,
    w <= 32; limbs of w = 32 come back as int32 bit patterns."""
    nw, N = words.shape
    out = np.zeros((n_limbs, N), dtype=np.uint64)
    mask = np.uint64((1 << w) - 1)
    for j in range(n_limbs):
        k, s = divmod(w * j, 64)
        if k >= nw:
            break
        v = words[k] >> np.uint64(s)
        if s + w > 64 and k + 1 < nw:
            v |= words[k + 1] << np.uint64(64 - s)
        out[j] = v & mask
    return out.astype(np.uint32).view(np.int32)


def bytes_to_limbs(data, n_bytes: int, w: int, n_limbs: int) -> np.ndarray:
    """Packed little-endian bytes (N elements of n_bytes each) -> (n_limbs, N)
    int32 planes of w-bit limbs, w <= 32 (vectorised over N)."""
    B = np.frombuffer(data, dtype=np.uint8).reshape(-1, n_bytes)
    return words_to_limbs(bytes_to_words(B), w, n_limbs)


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


def n_packed_bytes(p: int) -> int:
    """Bytes of one packed element of F_p: ceil(bits(p) / 8)."""
    return -(-p.bit_length() // 8)


def pack_bytes(data, f, count: int) -> np.ndarray:
    """Packed little-endian bytes (count elements of ceil(bits(p) / 8)
    bytes each) -> (n, count) int32 planes of 32-bit limbs, unreduced (the
    reference's fromPackedBytes). f: the field's FieldOps (its p and n)."""
    nb = n_packed_bytes(f.p)
    if len(data) != count * nb:
        raise ValueError(f"{len(data)} bytes for {count} elements of {nb} bytes")
    return bytes_to_limbs(bytes(data), nb, W, f.n)


def to_bytes(arr, f) -> bytes:
    """(n, N) planes of 32-bit limbs -> packed little-endian bytes,
    ceil(bits(p) / 8) an element (the reference's toPackedBytes); raises
    OverflowError for a value that does not fit in them."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    nb = n_packed_bytes(f.p)
    B = np.ascontiguousarray(np.asarray(arr, dtype=np.int32).T).astype("<i4").view(np.uint8)
    if B[:, nb:].any():
        raise OverflowError(f"a value does not fit in {nb} bytes")
    return np.ascontiguousarray(B[:, :nb]).tobytes()


def pack_scalar(value: int, n: int) -> np.ndarray:
    """One int as an (n, 1) constant plane."""
    return pack([value], n)


def to_words(value: int, n: int) -> list[int]:
    """One int as n little-endian 32-bit words (kernel constant arguments)."""
    return [(value >> (W * k)) & 0xFFFFFFFF for k in range(n)]
