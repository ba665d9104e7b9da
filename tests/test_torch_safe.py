"""montgomery_tpu_torch safe batched-affine engine (affine=True, unsafe=False).

Module by module against montgomery_tpu, tolerance zero on canonical values:
`FieldOps.square` and `is_equal` (0, 1, p - 1 and the unreduced range
[p, 2p)), the safe packed add's pre and post stages over lanes of every flag
class (ordinary, doubling, cancellation through the sign planes, each
infinite operand, both infinite, an unpaired lane, and the order-2 point
T = (p - 1, 0) doubled, which hits y = 0), with the whole add also against
the oracle's E.add, and `is_on_curve`; the JAX side runs as one jitted
program in the suite's callback kernel mode. The slice as a whole is held against the
bigint oracle on inputs the unsafe engine cannot take (duplicates, negated
duplicates, infinity, zero scalars): N = 16 at the default c (a pair round
first) and N = 512 at c = 4 (the 8-way super-round first, read from the
round log). Port tensors live on the CPU, so the kernels' plain versions run.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377, BLS12_381, PALLAS
from montgomery_tpu.msm import WeierstrassMsm as JaxMsm
from montgomery_tpu.ops import kernels as jkernels
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.curves.affine import CANCEL, DBL, Y1_ZERO
from montgomery_tpu_torch.msm import WeierstrassMsm, api
from montgomery_tpu_torch.ops import kernels
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import MONT_MUL, FieldOps

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = BLS12_377.modulus
Q = BLS12_377.order
W_JAX = 13
T = AffinePoint(P - 1, 0)  # (-1)^3 + 1 = 0: the point of order 2 (not in the subgroup)
# 2^448 - 2^224 - 1, a 448-bit prime: 15 limbs of 32 bits, a count no kernel is built at
P448 = (1 << 448) - (1 << 224) - 1

# the add's lanes, one flag class each, twice (A's sign 0, then 1): ordinary,
# A == B (doubling), B = A with the other sign (cancel), A infinite, B
# infinite, both infinite, unpaired (hp = 0), T + T, T - T (= T + T, since
# -T = T), and an unpaired lane reading A twice (as the engine's pair rounds do)
CLASSES = ("ordinary", "double", "cancel", "inf_a", "inf_b", "inf_both", "unpaired",
           "t_double", "t_minus_t", "unpaired_same")
LANES = [c for c in CLASSES for _ in (0, 1)]
SA = [i % 2 for i in range(len(LANES))]
SB = [a if c in ("double", "t_double", "unpaired_same") else 1 - a for a, c in zip(SA, LANES)]
HP = [0 if c.startswith("unpaired") else 1 for c in LANES]


def _lane_points(pts):
    A, B = [], []
    for i, cls in enumerate(LANES):
        a, b = pts[2 * i], pts[2 * i + 1]
        if cls in ("double", "cancel", "unpaired_same"):
            b = a  # the signs decide: equal signs double, opposite ones cancel
        elif cls == "inf_a":
            a = AffinePoint.zero()
        elif cls == "inf_b":
            b = AffinePoint.zero()
        elif cls == "inf_both":
            a = b = AffinePoint.zero()
        elif cls in ("t_double", "t_minus_t"):
            a = b = T
        A.append(a)
        B.append(b)
    return A, B


def _plane(values) -> np.ndarray:
    return np.asarray([values], dtype=np.int32)


@pytest.fixture(scope="module")
def ctx():
    msm = WeierstrassMsm(BLS12_377, device="cpu")
    E = WeierstrassCurve(BLS12_377)
    rng = random.Random(17)
    pts = [E.random_point(rng) for _ in range(2 * len(SA))]
    return msm, E, pts


@pytest.fixture(scope="module")
def field_values():
    """Canonical values 0, 1, 2, p - 1 and random ones."""
    rng = np.random.default_rng(23)
    raw = rng.bytes(8 * 56)
    return [0, 1, 2, P - 1] + [int.from_bytes(raw[56 * i:56 * (i + 1)], "little") % P
                               for i in range(8)]


@pytest.fixture(scope="module")
def lanes(ctx):
    """The add's operands as halves of one packed array (as the engine
    passes them), their sign and pair planes, and the port's inverted
    denominators."""
    msm, _, pts = ctx
    aff = msm.affine
    A, B = _lane_points(pts)
    C = torch.cat([aff.pack_rows(msm.affine_to_device(v)) for v in (A, B)], dim=1)
    M = len(A)
    ops = (C[:, :M], C[:, M:], *(torch.from_numpy(_plane(v)) for v in (SA, SB, HP)))
    dinv = msm.fops.batch_inv(aff.pre_packed(*ops)[0])
    return A, B, ops, dinv


@pytest.fixture(scope="module")
def jax_side(ctx, field_values, lanes):
    """square, is_equal, the safe add's pre and post kernels and is_on_curve
    of the JAX package on the tests' inputs, in one jitted program. The post
    stage gets the port's inverted denominators (the batch inversion between
    the two is held against the JAX package in test_torch_divstep.py), so
    the program stays small."""
    msm, _, pts = ctx
    jctx = JaxMsm(BLS12_377)
    jf, jaff = jctx.fops, jctx.affine
    rj = 1 << (W_JAX * jf.n)
    mont = [v * rj % P for v in field_values]
    # x: the values, then their unreduced representatives in [p, 2p);
    # y: other values, then the same values reduced
    xs = jcodec.pack(mont + [m + P for m in mont], jf.mp)
    ys = jcodec.pack(mont[::-1] + mont, jf.mp)
    A, B, _, dinv = lanes
    JA, JB = (jctx.proj.affine_to_device(v) for v in (A, B))
    jdinv = interop.field_to_jax(dinv, msm.fops, jf.n)
    good = pts[:4] + [AffinePoint.zero()]
    off = [AffinePoint(pts[5].x, (pts[5].y + 1) % P), AffinePoint(pts[6].x, 0)]
    JC = jctx.proj.affine_to_device(good + off)
    flags = [_plane(v) for v in (SA, SB, HP)]
    n, R = jf.n, jaff.packed_rows

    def run(xs, ys, JA, JB, JC, a, b, v, dinv):
        PA, PB = jaff.pack_rows(JA), jaff.pack_rows(JB)
        pre = jkernels.fused("aff_pre_packed", jaff._pre_packed_f, [PA, PB, a, b, v], [n, n, 1])
        (out,) = jkernels.fused("aff_post_packed", jaff._post_packed_f,
                                [PA, PB, a, b, dinv, pre[1], pre[2], v], [R])
        return (jf.square(xs), jf.is_equal(xs, ys), pre, jaff.unpack_rows(out),
                jaff.is_on_curve(JC))

    sq, eq, pre, add, on = jax.jit(run)(xs, ys, JA, JB, JC, *flags, jdinv)
    return {"field": (jf, xs, ys, sq, eq), "pre": pre, "add": add,
            "on_curve": (good + off, on)}


def _to_port(msm, JA):
    return interop.affine_from_jax(np.asarray(JA.x), np.asarray(JA.y), np.asarray(JA.inf),
                                   msm.fops, device="cpu")


def _port_planes(f, jf, jplanes):
    """The same raw representatives in the port's Montgomery form: a JAX
    value m = v Rj (+ p) becomes v R (+ p)."""
    rj_inv = pow(1 << (W_JAX * jf.n), -1, P)
    raw = interop.planes_to_ints(np.asarray(jplanes), W_JAX)
    vals = [(m % P) * rj_inv % P * f.R % P + (P if m >= P else 0) for m in raw]
    return f.pack_raw(vals, "cpu")


def test_square_matches_jax(ctx, jax_side):
    msm, _, _ = ctx
    f = msm.fops
    jf, jxs, _, jsq, _ = jax_side["field"]
    x = _port_planes(f, jf, jxs)
    got = f.square(x)
    assert torch.equal(got, f.mul(x, x))  # bit for bit, as the kernel
    via_jax = f.unpack(interop.field_from_jax(np.asarray(jsq), f, device="cpu"), from_mont=True)
    assert f.unpack(got, from_mont=True) == via_jax
    assert via_jax == [v * v % P for v in f.unpack(x, from_mont=True)]
    assert all(v < 2 * P for v in codec.unpack(got))
    assert sum(v >= P for v in codec.unpack(x)) == x.shape[-1] // 2


def test_is_equal_matches_jax(ctx, jax_side):
    msm, _, _ = ctx
    f = msm.fops
    jf, jxs, jys, _, jeq = jax_side["field"]
    x, y = _port_planes(f, jf, jxs), _port_planes(f, jf, jys)
    got = f.is_equal(x, y)
    assert got.tolist() == np.asarray(jeq).tolist()
    half = x.shape[-1] // 2
    assert got[half:].all()  # v R + p against v R
    assert not got[:half].all()


def test_pre_packed_matches_jax(ctx, lanes, jax_side):
    """Denominators and numerators equal as field elements, flags equal."""
    msm, _, _ = ctx
    f = msm.fops
    denom, numer, flags = msm.affine.pre_packed(*lanes[2])
    jdenom, jnumer, jflags = jax_side["pre"]
    for got, want in ((denom, jdenom), (numer, jnumer)):
        via_jax = interop.field_from_jax(np.asarray(want), f, device="cpu")
        assert f.unpack(got, from_mont=True) == f.unpack(via_jax, from_mont=True)
    assert flags.tolist() == np.asarray(jflags).tolist()
    seen = dict(zip(LANES, flags[0].tolist()))
    assert seen["ordinary"] == 0 and seen["double"] == DBL and seen["cancel"] == CANCEL
    assert seen["t_double"] == seen["t_minus_t"] == DBL | Y1_ZERO
    assert seen["unpaired_same"] == DBL  # hp = 0 wins: denominator 1, pass-through
    one = f.unpack(denom, from_mont=True)
    poisoned = ("cancel", "inf_a", "inf_b", "inf_both", "unpaired", "t_double", "t_minus_t",
                "unpaired_same")
    assert all(v == 1 for v, c in zip(one, LANES) if c in poisoned)
    assert all(v != 0 for v in one)  # nothing brings a zero into the inversion


def test_add_packed_safe_matches_jax(ctx, lanes, jax_side):
    """The post stage against the JAX package's, and the whole safe add
    against the oracle's E.add, lane by lane."""
    msm, E, _ = ctx
    aff = msm.affine
    A, B, ops, dinv = lanes
    via_jax = msm.proj.affine_to_host(_to_port(msm, jax_side["add"]))
    out = aff.add_packed(*ops)
    got = msm.proj.affine_to_host(aff.unpack_rows(out))
    _, numer, flags = aff.pre_packed(*ops)
    assert torch.equal(out, aff.post_packed(*ops[:4], dinv, numer, flags, ops[4]))
    for i in range(len(A)):
        a = E.neg(A[i]) if SA[i] else A[i]
        b = E.neg(B[i]) if SB[i] else B[i]
        want = E.add(a, b) if HP[i] else a
        assert E.equal(got[i], want) and E.equal(via_jax[i], want), f"lane {i} ({LANES[i]})"
    # the unsafe add on the lanes that meet its contract gives the same sums
    idx = torch.tensor([i for i, c in enumerate(LANES) if c in ("ordinary", "unpaired")])
    u = aff.unpack_rows(aff.add_packed(*[t.index_select(1, idx) for t in ops], unsafe=True))
    s = aff.unpack_rows(out.index_select(1, idx))
    f = aff.f
    assert torch.equal(f.reduce(u.x), f.reduce(s.x)) and torch.equal(f.reduce(u.y), f.reduce(s.y))
    assert torch.equal(u.inf, s.inf)


def test_is_on_curve_matches_jax(ctx, jax_side):
    msm, E, _ = ctx
    pts, jon = jax_side["on_curve"]
    got = msm.affine.is_on_curve(msm.affine_to_device(pts))
    assert got.tolist() == np.asarray(jon).tolist() == [E.is_on_curve(p) for p in pts]
    assert got.tolist() == [True] * 5 + [False, False]


def test_batch_double_matches_oracle(ctx):
    msm, E, pts = ctx
    G = pts[:3] + [AffinePoint.zero(), T]
    got = msm.proj.affine_to_host(msm.affine.batch_double(msm.affine_to_device(G)))
    assert all(E.equal(a, E.add(g, g)) for a, g in zip(got, G))


@pytest.mark.parametrize("N,c,first", [(16, None, ("pair", 2)), (512, 4, ("super", 8))])
def test_safe_msm_matches_oracle(ctx, N, c, first):
    """msm_full's default (the safe engine) equals the bigint oracle on
    duplicates with equal scalars (doublings in a bucket), negated
    duplicates (cancellations), infinity and zero scalars."""
    msm, E, pts = ctx
    base = pts[:5]
    rng = np.random.default_rng(N)
    P_ = [base[int(i)] for i in rng.integers(0, len(base), size=N)]
    raw = rng.integers(0, 256, size=32 * N, dtype=np.uint8).tobytes()
    sc = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little") % Q for i in range(N)]
    for i in range(0, N, 4):  # pairs (P, s), (P, s) and (P, s), (-P, s)
        P_[i + 1], sc[i + 1] = (P_[i] if i % 8 else E.neg(P_[i])), sc[i]
    P_[2] = P_[11] = AffinePoint.zero()
    sc[3] = sc[6] = 0
    got = msm.msm_full(sc, P_, c=c)
    rounds = msm.aff_adapter.rounds
    assert rounds[0][:2] == first
    assert {kind for kind, _, _ in rounds[1:]} <= {"pair", "tail"}
    assert E.equal(got, oracle_msm(E, sc, P_))


def test_cuda_limb_guard(monkeypatch):
    """On the card, a field whose limb count no kernel is built for (a
    448-bit prime: 15 limbs) raises before any launch, while BLS12-381 (13)
    and Pallas (9) construct; checked without a device. (The field kernels
    also have the 1-3 limb example fields' counts.)"""
    with pytest.raises(NotImplementedError, match=r"compiled for \[1, 2, 3, 9, 12, 13\] limbs.*needs 15"):
        FieldOps(P448).field_words(MONT_MUL)
    for p in (P, BLS12_381.modulus, PALLAS.modulus):
        kernels.check_limbs(MONT_MUL, FieldOps(p).n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(api, "_CTX_CACHE", {})  # the contexts built here leave with the patch
    with pytest.raises(NotImplementedError, match="this field needs 15"):
        WeierstrassMsm(dataclasses.replace(BLS12_381, modulus=P448), device="cuda")
    assert WeierstrassMsm(BLS12_381, device="cuda").fops.n == 13
    assert WeierstrassMsm(PALLAS, device="cuda").fops.n == 9
    # the plain versions run any limb count on the CPU
    assert WeierstrassMsm(BLS12_381, device="cpu").fops.n == 13


def test_misaligned_scalar_bytes_rejected(ctx):
    msm, _, _ = ctx
    for blob in (b"\x01" * 33, b"", b"\x00" * 31):
        with pytest.raises(ValueError, match="nonzero multiple of 32"):
            msm.scalars_to_limbs(blob)
    # full-width byte scalars are reduced mod q
    vals = [(1 << 256) - 1, 16 * Q - 1 if 16 * Q <= 1 << 256 else Q, Q, 8 * Q + 5, 0, 1]
    blob = b"".join(v.to_bytes(32, "little") for v in vals)
    assert torch.equal(msm.scalars_to_limbs(blob), msm.scalars_to_limbs([v % Q for v in vals]))
