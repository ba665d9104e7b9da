"""montgomery_tpu_torch Twisted Edwards MSM slice as a whole: `EdwardsMsm`
and the Edwards branch of `serve.compute_msm`, against the JAX package's
bigint oracle (`montgomery_tpu.bigint.msm` over `TwistedEdwardsCurve`).

N = 16 (a pair round first) and N = 512 (the 8-way super-round first, read
from the engine's round log), both at c = 4, with zero
scalars, duplicated and negated points and the identity among the inputs;
compute_msm from ints and from bytes, scalar bytes >= q reduced, and its
ValueErrors. Port tensors live on the CPU, so the kernels' plain versions
run; the JAX package's own Edwards engine is not run (minutes on the CPU).
"""

import inspect
import random

import pytest
import torch

from montgomery_tpu.bigint import TwistedEdwardsCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.concrete import ED_ON_BLS12_377 as JAX_ED
from montgomery_tpu_torch import interop, serve
from montgomery_tpu_torch.concrete import ED_ON_BLS12_377
from montgomery_tpu_torch.curves.edwards import EdwardsOps
from montgomery_tpu_torch.curves.random import random_points_fast_edwards
from montgomery_tpu_torch.msm import EdwardsMsm, api

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = ED_ON_BLS12_377.modulus
Q = ED_ON_BLS12_377.order
CURVE = "ed-on-bls12-377"


@pytest.fixture(scope="module")
def ctx():
    E = TwistedEdwardsCurve(JAX_ED)
    rng = random.Random(23)
    return EdwardsMsm(ED_ON_BLS12_377, device="cpu"), E, [E.random_point(rng) for _ in range(24)]


def _inputs(E, base, N: int, seed: int):
    """Points with duplicates under one scalar (a bucket doubles), negated
    duplicates (it cancels) and the identity, and scalars 0, 1 and q - 1."""
    rng = random.Random(seed)
    pts = [base[(5 * i) % len(base)] for i in range(N)]
    sc = [rng.randrange(Q) for _ in range(N)]
    for i in range(8, N, 4):
        pts[i + 1], sc[i + 1] = (pts[i] if i % 8 else E.neg(pts[i])), sc[i]
    pts[1] = pts[6] = type(base[0]).zero()
    sc[0] = sc[3] = 0
    sc[2], sc[4] = 1, Q - 1
    return pts, sc


@pytest.mark.parametrize("N,first", [(16, ("pair", 2)), (512, ("super", 8))])
def test_msm_matches_oracle(ctx, N, first):
    """The MSM equals the oracle; the round log shows the first round (K = 63
    windows at c = 4; N = 512: M0 = 63 * 512 >= 64 G = 64 * 63 * 8, the
    super-round; N = 16: M0 < 64 G, a pair round). N = 16 runs through
    msm_full from oracle points, N = 512 by stages (msm_phases) from a
    device batch and scalar limbs."""
    msm, E, base = ctx
    pts, sc = _inputs(E, base, N, seed=N)
    if N == 16:
        got = msm.msm_full(sc, pts, c=4)
    else:
        S, log = msm.msm_phases(msm.to_device(pts), msm.scalars_to_limbs(sc), 4)
        assert [label for label, _ in log.entries] == [
            "digits (signed windows)", "pack rows", "accumulate", "reduce+combine"]
        (got,) = msm.ed.to_host(S)
    assert msm.digits_device(msm.scalars_to_limbs(sc), 4).shape == (msm.num_windows(4), N) == (63, N)
    rounds = msm.adapter.rounds
    assert rounds[0][:2] == first
    assert {kind for kind, _, _ in rounds[1:]} <= {"pair", "tail"}
    w = oracle_msm(E, sc, pts)
    assert (got.x, got.y) == (w.x, w.y)


@pytest.mark.parametrize("form", ["ints", "bytes"])
def test_compute_msm(ctx, form, monkeypatch):
    """compute_msm(curve="ed-on-bls12-377") from (x, y) ints or packed
    bytes equals the oracle; byte scalars at or above q are reduced; oracle
    points and tuples give the same batch, the identity (0, 1) included."""
    msm, E, base = ctx
    pts, sc = _inputs(E, base, 16, seed=5)
    w = oracle_msm(E, sc, pts)
    xy = [(p.x, p.y) for p in pts]
    if form == "ints":
        args = (xy, sc)
        ref = [a.tolist() for a in serve._points_to_batch(msm, pts)]
        assert [a.tolist() for a in serve._points_to_batch(msm, xy)] == ref
    else:
        pbytes = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little") for x, y in xy)
        # s + k q for the largest k that fits in 32 bytes
        sbytes = b"".join((s + ((1 << 256) - 1 - s) // Q * Q).to_bytes(32, "little") for s in sc)
        assert all(int.from_bytes(sbytes[32 * i:32 * i + 32], "little") >= Q for i in range(16))
        assert torch.equal(msm.scalars_to_limbs(sbytes), msm.scalars_to_limbs(sc))
        args = (pbytes, sbytes)
    assert serve.compute_msm(*args, curve=CURVE, c=8, device="cpu") == (w.x, w.y)
    assert isinstance(serve.get_curve(CURVE, device="cpu"), EdwardsMsm)
    # a sum that is the identity comes back as (0, 1), the identity's encoding
    monkeypatch.setattr(EdwardsMsm, "msm_full", lambda self, *a, **k: type(pts[1]).zero())
    assert serve.compute_msm(*args, curve=CURVE, device="cpu") == (0, 1)


@pytest.mark.parametrize("bad", ["off-curve point", "misaligned point bytes", "length mismatch"])
def test_compute_msm_rejects(ctx, bad):
    msm, E, base = ctx
    xy = [(p.x, p.y) for p in base[:8]]
    sc = list(range(1, 9))
    pbytes = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little") for x, y in xy)
    args, match = {
        "off-curve point": ((xy[:3] + [(xy[3][0], (xy[3][1] + 1) % P)] + xy[4:], sc),
                            "1 input point"),
        "misaligned point bytes": ((pbytes[:-1], sc), "nonzero multiple of 64"),
        "length mismatch": ((xy, sc[:-1]), "length mismatch"),
    }[bad]
    with pytest.raises(ValueError, match=match):
        serve.compute_msm(*args, curve=CURVE, device="cpu")
    with pytest.raises(ValueError, match="nonzero multiple of 64"):
        msm.points_from_bytes(b"")


def test_entry_points_default_to_the_card():
    """The Edwards entry points place data on the card unless asked for the
    CPU, and without a card they raise; nothing falls back to the CPU."""
    for fn in (EdwardsMsm.__new__, random_points_fast_edwards, EdwardsOps.to_device,
               interop.edwards_from_jax, serve.get_curve, serve.compute_msm):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EdwardsMsm(ED_ON_BLS12_377)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.get_curve(CURVE)
        assert all(k[2].type == "cpu" for k in api._CTX_CACHE)  # none half-built on the card
    assert EdwardsMsm(ED_ON_BLS12_377, device="cpu") is EdwardsMsm(ED_ON_BLS12_377, device="cpu")
