"""montgomery_tpu_torch.serve: compute_msm from ints and bytes, and its
negative paths, on the CPU (the kernels' plain versions).

Results are held against the bigint oracle of the JAX package, exact, on
inputs with duplicates, a negated duplicate, the point at infinity (0, 0)
and a zero scalar; Pallas (n = 9 limbs) mirrors
tests/test_serve.py. Malformed input raises the exception class that
montgomery_tpu.serve.compute_msm raises for it (tests/test_negative.py).
"""

import dataclasses
import random

import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377, PALLAS
from montgomery_tpu_torch import serve
from montgomery_tpu_torch.msm import EdwardsMsm, WeierstrassMsm, api

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

Q = BLS12_377.order
NB = 48  # bytes of a BLS12-377 coordinate


def _xy(P):
    return (0, 0) if P.is_zero else (P.x, P.y)


@pytest.fixture(scope="module")
def inputs():
    E = WeierstrassCurve(BLS12_377)
    rng = random.Random(29)
    b = [E.random_point(rng) for _ in range(3)]
    pts = [b[0], b[0], E.neg(b[0]), b[1], AffinePoint.zero(), b[2], b[1], b[2]]
    sc = [rng.randrange(Q) for _ in pts]
    sc[1] = sc[2] = sc[0]  # P, P, -P under one scalar: a doubling and a cancellation
    sc[5] = 0
    return E, pts, sc, oracle_msm(E, sc, pts)


def test_compute_msm_from_ints(inputs):
    E, pts, sc, want = inputs
    got = serve.compute_msm([_xy(P) for P in pts], sc, c=4, device="cpu")
    assert got == (want.x, want.y)
    # oracle points and (x, y) tuples make the same batch
    ctx = serve.get_curve("bls12-377", device="cpu")
    a, b = serve._points_to_batch(ctx, pts), serve._points_to_batch(ctx, [_xy(P) for P in pts])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a.inf.tolist() == [P.is_zero for P in pts]


def test_compute_msm_from_bytes(inputs):
    """Packed bytes; scalars at or above q are reduced."""
    E, pts, sc, want = inputs
    pbytes = b"".join(x.to_bytes(NB, "little") + y.to_bytes(NB, "little")
                      for x, y in map(_xy, pts))
    sbytes = b"".join((s + Q if s + Q < 1 << 256 else s).to_bytes(32, "little") for s in sc)
    assert serve.compute_msm(pbytes, sbytes, c=5, device="cpu") == (want.x, want.y)


def test_compute_msm_infinity_result():
    E = WeierstrassCurve(BLS12_377)
    P = E.random_point(random.Random(31))
    assert serve.compute_msm([_xy(P), _xy(E.neg(P))], [5, 5], c=3, device="cpu") == (0, 0)


def test_compute_msm_pallas(rng):
    """Pallas at N = 8, c = 4, from ints and from bytes (tests/test_serve.py)."""
    C = WeierstrassCurve(PALLAS)
    pts = C.random_points(8, rng)
    sc = [rng.randrange(PALLAS.order) for _ in range(8)]
    exp = oracle_msm(C, sc, pts)
    assert serve.compute_msm([(P.x, P.y) for P in pts], sc, curve="pallas", c=4,
                             device="cpu") == (exp.x, exp.y)
    nb, snb = 32, (PALLAS.order.bit_length() + 7) // 8
    pbytes = b"".join(P.x.to_bytes(nb, "little") + P.y.to_bytes(nb, "little") for P in pts)
    sbytes = b"".join(s.to_bytes(snb, "little") for s in sc)
    ctx = serve.get_curve("pallas", device="cpu")
    A, B = ctx.points_from_bytes(pbytes), serve._points_to_batch(ctx, [(P.x, P.y) for P in pts])
    assert all(torch.equal(u, v) for u, v in zip(A, B))
    assert torch.equal(ctx.scalars_to_limbs(sbytes), ctx.scalars_to_limbs(sc))


def test_empty_inputs_rejected():
    with pytest.raises(ValueError, match="empty|nonzero"):
        serve.compute_msm([], [], device="cpu")
    with pytest.raises(ValueError, match="nonzero multiple"):
        serve.compute_msm(b"", b"", device="cpu")


def test_misaligned_bytes_rejected(inputs):
    with pytest.raises(ValueError, match="nonzero multiple"):
        serve.compute_msm(b"\x00" * (2 * NB + 1), b"\x00" * 32, device="cpu")
    _, pts, _, _ = inputs
    with pytest.raises(ValueError, match="nonzero multiple"):
        serve.compute_msm([_xy(P) for P in pts[:1]], b"\x01" * 33, device="cpu")


def test_length_mismatch_rejected(inputs):
    _, pts, sc, _ = inputs
    with pytest.raises(ValueError, match="length mismatch"):
        serve.compute_msm([_xy(P) for P in pts[:4]], sc[:3], device="cpu")


def test_off_curve_point_rejected(inputs, monkeypatch):
    _, pts, sc, _ = inputs
    xy = [_xy(P) for P in pts]
    xy[3] = (xy[3][0], (xy[3][1] + 1) % BLS12_377.modulus)
    with pytest.raises(ValueError, match="1 input point"):
        serve.compute_msm(xy, sc, device="cpu")
    # validate=False skips the check and goes straight to the MSM
    calls = []
    monkeypatch.setattr(WeierstrassMsm, "msm_full",
                        lambda self, *a, **k: calls.append(a) or AffinePoint.zero())
    assert serve.compute_msm(xy, sc, validate=False, device="cpu") == (0, 0)
    assert len(calls) == 1


def test_curves(monkeypatch):
    with pytest.raises(KeyError):
        serve.get_curve("nope", device="cpu")
    assert isinstance(serve.get_curve("ed-on-bls12-377", device="cpu"), EdwardsMsm)
    no_endo = dict(serve.WEIERSTRASS_CURVES)
    no_endo["pallas"] = dataclasses.replace(no_endo["pallas"], endomorphism=None)
    monkeypatch.setattr(serve, "WEIERSTRASS_CURVES", no_endo)
    with pytest.raises(ValueError, match="endomorphism"):
        serve.get_curve("pallas", device="cpu")
    monkeypatch.undo()
    # on the card every Weierstrass curve's limb count has its kernels, and a
    # field of another count (a 448-bit prime: 15 limbs) raises (checked
    # before any device is touched)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(api, "_CTX_CACHE", {})  # the contexts built here leave with the patch
    for label, n in (("bls12-381", 13), ("pallas", 9)):
        assert serve.get_curve(label).fops.n == n
    wide = dict(serve.WEIERSTRASS_CURVES)
    wide["p448"] = dataclasses.replace(wide["pallas"], label="p448", modulus=(1 << 448) - (1 << 224) - 1)
    monkeypatch.setattr(serve, "WEIERSTRASS_CURVES", wide)
    with pytest.raises(NotImplementedError, match="this field needs 15"):
        serve.get_curve("p448")
