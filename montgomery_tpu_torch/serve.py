"""Serve-path API: `compute_msm` with byte or bigint ingestion.

Counterpart of `montgomery_tpu/serve.py`: points and scalars come as packed
little-endian bytes or Python ints, the whole MSM runs on the device, and the
affine result comes back as ints. Bytes go through numpy limb extraction and
one to-Montgomery launch, with no per-point Python; int inputs pay one
`int.to_bytes` per value. Weierstrass curves run the batched-affine engine
with the safe add (`WeierstrassMsm.msm_full`'s default), the Twisted Edwards
curve its packed extended-coordinate engine (`EdwardsMsm.msm_full`).

Curves, on the card and on the CPU: BLS12-377, BLS12-381 and Pallas (the
Weierstrass kernels are instantiated at their fields' 12, 13 and 9 limbs of
32 bits) and ed-on-bls12-377 (9 limbs).
"""

from __future__ import annotations

import torch

from .concrete import EDWARDS_CURVES, WEIERSTRASS_CURVES
from .msm.api import EdwardsMsm, WeierstrassMsm


def get_curve(label: str, device="cuda") -> WeierstrassMsm | EdwardsMsm:
    """The curve's MSM context on `device`; contexts are cached by their
    class, which inserts one only once it is built."""
    if label in EDWARDS_CURVES:
        return EdwardsMsm(EDWARDS_CURVES[label], device)
    if label not in WEIERSTRASS_CURVES:
        raise KeyError(f"unknown curve {label!r}; have "
                       f"{sorted(WEIERSTRASS_CURVES) + sorted(EDWARDS_CURVES)}")
    params = WEIERSTRASS_CURVES[label]
    if params.endomorphism is None:
        raise ValueError(f"{label}: compute_msm needs a GLV endomorphism, and the curve has none")
    return WeierstrassMsm(params, device)


def _points_to_batch(ctx, points):
    """Packed bytes, or a list of (x, y) tuples or oracle points -> the
    context's device batch through the byte path; a Weierstrass context reads
    (0, 0) as the point at infinity, an Edwards one (0, 1) as the identity."""
    if isinstance(points, (bytes, bytearray)):
        return ctx.points_from_bytes(points)
    if len(points) == 0:
        raise ValueError("empty point list")
    nb = -(-ctx.fops.p.bit_length() // 8)

    def xy(P):  # an oracle point (of this package or the JAX one) or a tuple
        if hasattr(P, "is_zero"):
            return ctx.identity_xy if P.is_zero else (P.x, P.y)
        return P

    blob = b"".join(int(x).to_bytes(nb, "little") + int(y).to_bytes(nb, "little")
                    for x, y in map(xy, points))
    return ctx.points_from_bytes(blob)


def compute_msm(points, scalars, curve: str = "bls12-377", c: int | None = None,
                validate: bool = True, device="cuda") -> tuple[int, int]:
    """S = sum_i scalars[i] points[i]; returns affine (x, y) as ints: (0, 0)
    for the point at infinity of a Weierstrass curve, (0, 1) for the identity
    of an Edwards curve.

    points: packed bytes (x || y per point, ceil(bits(p) / 8) bytes each
    coordinate) or a list of (x, y) tuples or oracle points; scalars:
    packed bytes (ceil(bits(q) / 8) each) or ints, reduced mod q.
    ValueError for empty input, misaligned bytes, a length mismatch and,
    with validate, off-curve points (one on-curve check on the device)."""
    ctx = get_curve(curve, device)
    batch = _points_to_batch(ctx, points)
    limbs = ctx.scalars_to_limbs(scalars)
    if limbs.shape[-1] != batch.count:
        raise ValueError(f"length mismatch: {batch.count} points vs {limbs.shape[-1]} scalars")
    if validate:
        bad = int(torch.count_nonzero(~ctx.is_on_curve(batch)))
        if bad:
            raise ValueError(f"{bad} input point(s) not on curve {curve!r}")
    R = ctx.msm_full(limbs, batch, c=c)
    return ctx.identity_xy if R.is_zero else (R.x, R.y)
