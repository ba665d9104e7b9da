"""montgomery_tpu_torch on curves with a != 0 against montgomery_tpu and its
bigint oracle.

The witnesses are NIST P-256 (9 limbs of 32 bits) and NIST P-384 (13), both
with a = -3 (`montgomery_tpu_torch.testing.curves`). On P-256, AffineOps'
batch_add, batch_double and is_on_curve, and ProjectiveOps' double, add,
add_mixed, sub_mixed and is_on_curve give the same canonical values as the
JAX package's on 8 lanes (chords, P + P, P + (-P), infinite operands, an
off-curve point), all from one jitted JAX program (about 40 s of compiles
here). On both curves the port's three MSM engines, double_n, the window
combine, is_in_subgroup and random_points_weierstrass equal the bigint
oracle. The JAX package's MSM is not run: on a = -3 it takes minutes here.
Inputs come from numpy seeds; port tensors live on the CPU, so the kernels'
plain versions run; comparisons are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.bigint.weierstrass import AffinePoint as JPoint
from montgomery_tpu.bigint.weierstrass import CurveParams as JCurveParams
from montgomery_tpu.curves import AffineBatch as JAffineBatch
from montgomery_tpu.curves import AffineOps as JAffineOps
from montgomery_tpu.curves import ProjectiveOps as JProjectiveOps
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.bigint.weierstrass import AffinePoint
from montgomery_tpu_torch.curves import random as rnd
from montgomery_tpu_torch.curves.projective import ProjectiveBatch
from montgomery_tpu_torch.msm import WeierstrassMsm
from montgomery_tpu_torch.testing.curves import P256, P384

torch.set_num_threads(1)

W_JAX = 13
CURVES = [P256, P384]
ENGINES = {"projective": (False, False), "affine_safe": (True, False), "affine_unsafe": (True, True)}
MSM_C = {1: 5, 5: 5, 16: 4}  # small windows: many windows, buckets shared at N = 16


def _jax_params(params) -> JCurveParams:
    return JCurveParams(**{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})


def _ints(rng: np.random.Generator, bound: int, n: int) -> list[int]:
    nb = (bound.bit_length() + 7) // 8 + 8
    raw = rng.bytes(n * nb)
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % bound for i in range(n)]


def _points(C, rng, n: int) -> list:
    """n multiples k G of the oracle's generator, k drawn from rng."""
    return [C.scale(k, C.generator) for k in _ints(rng, C.params.order, n)]


def _port(pts) -> list:
    return [AffinePoint.zero() if P.is_zero else AffinePoint(P.x, P.y) for P in pts]


def _canon(pts) -> list:
    return [None if P.is_zero else (P.x, P.y) for P in pts]


def _ctx(params) -> WeierstrassMsm:
    return WeierstrassMsm(params, device="cpu")


def _raw(ops, P) -> list:
    return [tuple(v % ops.f.p for v in t) for t in ops.to_host_raw(P)]


def _affine_ints(f, A) -> list:
    """Canonical (x, y, inf) of each lane of an AffineBatch."""
    xs, ys = f.unpack(A.x, from_mont=True), f.unpack(A.y, from_mont=True)
    return [(x % f.p, y % f.p, bool(i)) for x, y, i in zip(xs, ys, A.inf.tolist())]


# ------------------------------------------------------------------ the fault

def test_affine_ops_use_a():
    """AffineOps on P-256: is_on_curve, batch_double and batch_add(P, P)
    equal the oracle on every lane (an AffineOps that drops a fails each:
    3 x^2 for the tangent, x^3 + b for the curve)."""
    C = WeierstrassCurve(_jax_params(P256))
    rng = np.random.default_rng(81)
    pts = _points(C, rng, 4)
    ctx = _ctx(P256)
    A = ctx.affine_to_device(_port(pts))
    aff = ctx.affine
    assert aff.is_on_curve(A).tolist() == [True] * 4
    want = _canon([C.double(P) for P in pts])
    assert _canon(ctx.proj.affine_to_host(aff.batch_double(A))) == want
    assert _canon(ctx.proj.affine_to_host(aff.batch_add(A, A))) == want


# ------------------------------------------------------ op by op against JAX

@pytest.fixture(scope="module")
def p256_lanes():
    """The 8 lanes of the op-by-op comparison: two chords, P + P, P + (-P),
    O + Q, P + O, O + O, and an off-curve point (x + 1, y) plus R."""
    C = WeierstrassCurve(_jax_params(P256))
    rng = np.random.default_rng(82)
    P, Q, R = _points(C, rng, 3)
    O = JPoint.zero()
    bad = JPoint((P.x + 1) % C.field.p, P.y)
    return C, [P, Q, P, P, O, P, O, bad], [Q, R, P, C.neg(P), Q, O, O, R]


@pytest.fixture(scope="module")
def jax_bundle(p256_lanes):
    """One jitted JAX program with every op of the comparison; the outputs
    carried into the port's planes by `interop`, as canonical ints: affine
    (x, y, inf) triples, projective (X, Y, Z) triples, and the predicates'
    flags."""
    _, lhs, rhs = p256_lanes
    jp = _jax_params(P256)
    jf = jax_field_ops(jp.modulus, w=W_JAX)
    jproj, jaff = JProjectiveOps(jf, jp), JAffineOps(jf, jp)
    rj = 1 << (W_JAX * jf.n)

    def mont(values):
        return jnp.asarray(interop.ints_to_planes([v % jf.p * rj % jf.p for v in values], W_JAX, jf.n))

    def batch(pts):
        return JAffineBatch(mont([0 if P.is_zero else P.x for P in pts]),
                            mont([0 if P.is_zero else P.y for P in pts]),
                            jnp.asarray([P.is_zero for P in pts]))

    @jax.jit
    def run(a, b):
        pa, pb = jproj.from_affine(a), jproj.from_affine(b)
        return (jaff.batch_add(a, b), jaff.batch_double(a), jaff.is_on_curve(a),
                jproj.double(pa), jproj.add(pa, pb), jproj.add_mixed(pa, b), jproj.sub_mixed(pa, b),
                jproj.is_on_curve(pa), jproj.is_on_curve(jproj.add(pa, pb)))

    out = run(batch(lhs), batch(rhs))
    ctx = _ctx(P256)  # the JAX planes carried into the port's by `interop`

    def affine(A):
        return _affine_ints(ctx.fops, interop.affine_from_jax(A.x, A.y, A.inf, ctx.fops, W_JAX, "cpu"))

    def proj(P):
        return _raw(ctx.proj, interop.projective_from_jax(*P, ctx.fops, W_JAX, "cpu"))

    return {"batch_add": affine(out[0]), "batch_double": affine(out[1]),
            "aff_on_curve": np.asarray(out[2]).tolist(), "double": proj(out[3]), "add": proj(out[4]),
            "add_mixed": proj(out[5]), "sub_mixed": proj(out[6]),
            "on_curve": np.asarray(out[7]).tolist(), "sum_on_curve": np.asarray(out[8]).tolist()}


def _port_ops(lanes):
    _, lhs, rhs = lanes
    ctx = _ctx(P256)
    proj, aff, f = ctx.proj, ctx.affine, ctx.fops
    a, b = ctx.affine_to_device(_port(lhs)), ctx.affine_to_device(_port(rhs))
    pa, pb = proj.from_affine(a), proj.from_affine(b)
    return {"batch_add": _affine_ints(f, aff.batch_add(a, b)),
            "batch_double": _affine_ints(f, aff.batch_double(a)), "aff_on_curve": aff.is_on_curve(a).tolist(), "double": _raw(proj, proj.double(pa)),
            "add": _raw(proj, proj.add(pa, pb)), "add_mixed": _raw(proj, proj.add_mixed(pa, b)),
            "sub_mixed": _raw(proj, proj.sub_mixed(pa, b)), "on_curve": proj.is_on_curve(pa).tolist(),
            "sum_on_curve": proj.is_on_curve(proj.add(pa, pb)).tolist()}


@pytest.fixture(scope="module")
def port_bundle(p256_lanes):
    return _port_ops(p256_lanes)


@pytest.mark.parametrize("op", ["batch_add", "batch_double", "aff_on_curve", "double", "add", "add_mixed",
                                "sub_mixed", "on_curve", "sum_on_curve"])
def test_ops_equal_jax(op, jax_bundle, port_bundle):
    """Each op's canonical values on the 8 lanes equal the JAX package's
    (the projective ones coordinate by coordinate, without normalising)."""
    assert port_bundle[op] == jax_bundle[op]


def test_ops_equal_oracle(p256_lanes, port_bundle):
    """The same outputs against the oracle on the lanes of curve points:
    the sums and doublings (normalised), and the predicates' flags."""
    C, lhs, rhs = p256_lanes
    p = C.field.p

    def on(raw, pt):
        X, Y, Z = raw
        if pt.is_zero:
            return Z == 0
        return Z != 0 and X == pt.x * Z % p and Y == pt.y * Z % p

    good = range(len(lhs) - 1)
    for name, want in (("add", [C.add(lhs[i], rhs[i]) for i in good]),
                       ("add_mixed", [C.add(lhs[i], rhs[i]) for i in good]),
                       ("sub_mixed", [C.sub(lhs[i], rhs[i]) for i in good]),
                       ("double", [C.double(lhs[i]) for i in good])):
        assert all(on(port_bundle[name][i], want[i]) for i in good), name
    aff_add = [None if z else (x, y) for x, y, z in port_bundle["batch_add"][:-1]]
    assert aff_add == _canon([C.add(lhs[i], rhs[i]) for i in good])
    flags = [True] * (len(lhs) - 1) + [False]
    assert port_bundle["aff_on_curve"] == flags and port_bundle["on_curve"] == flags


# -------------------------------------------------------- against the oracle

def _msm_lanes(C, rng, clean: bool):
    """16 points and scalars: 0, 1, q - 1 and q + 3 first; unless `clean`, a
    duplicate (lane 5 = lane 4), a negation (lane 7 = -lane 6) and the
    identity (lane 9) among random subgroup points."""
    q = C.params.order
    pts = _points(C, rng, 16)
    if not clean:
        pts[5] = pts[4]
        pts[7] = C.neg(pts[6])
        pts[9] = JPoint.zero()
    sc = [0, 1, q - 1, q + 3] + _ints(rng, q, 12)
    return pts, sc


@pytest.mark.parametrize("N", [1, 5, 16])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("params", CURVES, ids=lambda c: c.label)
def test_msm_engines(params, engine, N):
    """`msm` (host digits, no GLV) on each engine at small c equals the
    oracle; the unsafe engine gets distinct finite points (its contract)."""
    C = WeierstrassCurve(_jax_params(params))
    rng = np.random.default_rng(83)
    affine, unsafe = ENGINES[engine]
    pts, sc = _msm_lanes(C, rng, clean=unsafe)
    if N == 1:
        pts, sc = pts[2:3], sc[2:3]  # q - 1
    pts, sc = pts[:N], sc[:N]
    got = _ctx(params).msm(sc, _port(pts), c=MSM_C[N], affine=affine, unsafe=unsafe)
    assert _canon([got]) == _canon([oracle_msm(C, sc, pts)])


def test_glv_entries_refuse(params=P256):
    """A curve without an endomorphism: the GLV digits raise ValueError."""
    ctx = _ctx(params)
    limbs = ctx.scalars_to_limbs([1, 2])
    with pytest.raises(ValueError, match="no endomorphism"):
        ctx.digits_device(limbs, 4)
    with pytest.raises(ValueError, match="no endomorphism"):
        ctx.digits_glv([1, 2], 4)


@pytest.mark.parametrize("params", CURVES, ids=lambda c: c.label)
def test_double_n_combine_subgroup(params):
    """double_n for k in 1 and 6, the Horner combine at K = 3 and c = 3
    (identity windows included), and is_in_subgroup (the identity, curve
    points, and off-curve points (x + 1, y)) against the oracle."""
    C = WeierstrassCurve(_jax_params(params))
    rng = np.random.default_rng(84)
    p = C.field.p
    pts = _points(C, rng, 5) + [JPoint.zero()]
    ctx = _ctx(params)
    proj = ctx.proj
    P = proj.from_affine(ctx.affine_to_device(_port(pts)))
    for k in (1, 6):
        got = proj.to_host(proj.double_n(P, k))
        assert _canon(got) == _canon([C.scale(1 << k, Q) for Q in pts])
    # windows: lane j holds (pts[j], pts[j + 1], pts[j + 2]) cyclically
    K, c = 3, 3
    W = ProjectiveBatch(*[torch.stack([a.roll(-k, -1) for k in range(K)], dim=-1) for a in P])
    S = proj.combine(W, c)
    got = proj.to_host(ProjectiveBatch(*[a[..., 0] for a in S]))
    want = []
    for j in range(len(pts)):
        acc = JPoint.zero()
        for k in range(K):
            acc = C.add(acc, C.scale(1 << (c * k), pts[(j + k) % len(pts)]))
        want.append(acc)
    assert _canon(got) == _canon(want)
    bad = [JPoint((Q.x + 1) % p, Q.y) for Q in pts[:2]]
    lanes = pts + bad
    A = ctx.affine_to_device(_port(lanes))
    flags = proj.is_in_subgroup(proj.from_affine(A)).tolist()
    assert flags == [C.is_in_subgroup(Q) for Q in lanes]
    assert flags == [True] * len(pts) + [False] * len(bad)


@pytest.mark.parametrize("params", CURVES, ids=lambda c: c.label)
def test_random_points_weierstrass(params):
    """random_points_weierstrass at N = 8: the first 8 candidates whose
    x^3 + a x + b is a square (Euler's criterion on the oracle, candidate
    order), each with y^2 = x^3 + a x + b, in the subgroup."""
    C = WeierstrassCurve(_jax_params(params))
    ctx = _ctx(params)
    N, seed, oversample = 8, 5, 2.5
    got = ctx.proj.affine_to_host(rnd.random_points_weierstrass(ctx.proj, N, seed=seed, device="cpu",
                                                                oversample=oversample))
    F = C.field
    xs = rnd._uniform_field_vals(np.random.default_rng(seed), int(N * oversample) + 16, F.p)
    rhs = [(x * x % F.p * x + C.a * x + C.b) % F.p for x in xs]
    want_x = [x for x, r in zip(xs, rhs) if pow(r, (F.p - 1) // 2, F.p) in (0, 1)][:N]
    assert [P.x for P in got] == want_x
    for P in got:
        Q = JPoint(P.x, P.y)
        assert C.is_on_curve(Q) and C.is_in_subgroup(Q)


# ------------------------------------- the field's carries, which it runs on

def _carry_loop(t):
    u = t.clone()
    for i in range(u.shape[0] - 1):
        u[i + 1] += u[i] >> 16
    return u & 0xFFFF, u[-1] >> 16


@pytest.mark.parametrize("params", CURVES, ids=lambda c: c.label)
def test_plain16_lookahead_carries(params):
    """Plain16's lookahead carry (`lookahead_carry`) and `carry_up`, which
    takes it up to LOOKAHEAD_LANES lanes, equal the limb-by-limb carry loop
    on 300 lanes of limbs biased to 0 and 2^16 - 1 (long ripples); add,
    sub, neg, reduce and the lazy ops, built on `carry_up`, equal the same
    ops on the loop on 100 and 300 lanes (both sides of the CPU's
    threshold) of field values with 0, p, 2p - 1 and 4p - 1."""
    from montgomery_tpu_torch.ops.field import create_field_ops, to16

    f = create_field_ops(params.modulus)
    F, p = f.plain, f.p
    g = torch.Generator().manual_seed(85)
    L = F.L
    sel = torch.randint(0, 4, (2, L, 300), generator=g)
    raw = torch.randint(0, 1 << 16, (2, L, 300), generator=g)
    limbs = torch.where(sel == 0, 0, torch.where(sel == 1, 0xFFFF, raw)).long()
    limbs[:, L - 1] = 0  # values below 2^(16L - 16)
    x, y = limbs
    b, cb = _carry_loop(x + y)
    for carry in (F.lookahead_carry, F.carry_up):
        a, ca = carry(x + y)
        assert torch.equal(a, b) and torch.equal(ca, cb)
    rng = np.random.default_rng(86)

    def lin(t, c=0):
        return _carry_loop(t + F.const(c, t))[0]

    for N in (100, 300):
        vals = [0, 1, p - 1, p, 2 * p - 1] + _ints(rng, 2 * p, N - 5)
        X = to16(f.pack_raw(vals, "cpu"))
        Y = to16(f.pack_raw(vals[::-1], "cpu"))
        Y4 = to16(f.pack_raw([4 * p - 1] + vals[1:], "cpu"))
        two = F.const(2 * p, X)
        z = lin(X + Y)
        d, c = _carry_loop(z - two)
        assert torch.equal(F.add(X, Y), torch.where((c < 0)[None], z, d))
        d, c = _carry_loop(X - Y)
        assert torch.equal(F.sub(X, Y), torch.where((c < 0)[None], lin(d, 2 * p), d))
        d, c = _carry_loop(X - F.const(p, X))
        assert torch.equal(F.reduce(X), torch.where((c < 0)[None], X, d))
        d = lin(two - X)
        d2, c = _carry_loop(d - two)
        assert torch.equal(F.neg(X), torch.where((c < 0)[None], d, d2))
        assert torch.equal(F.sub_lazy(X, Y4), lin(X - Y4, 4 * p))
        assert torch.equal(F.sub_positive(X, Y), lin(X - Y, 2 * p))
        assert torch.equal(F.add_lazy(X, Y), lin(X + Y))
