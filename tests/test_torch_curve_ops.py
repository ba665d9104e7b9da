"""montgomery_tpu_torch curve predicates and mixed adds against montgomery_tpu
and its bigint oracle.

`ProjectiveOps.eq`, `is_on_curve`, `add_mixed`, `sub_mixed` and
`EdwardsOps.sub` on the edge lanes of the JAX package's curve tests (zero
operands, P + P, P + (-P), an infinite affine operand, an off-curve point)
equal the oracle's, and on BLS12-377 and ed-on-bls12-377 the JAX
package's jitted functions; `is_in_subgroup`
equals the oracle's on BLS12-377 (with its order-2 point (p - 1, 0) and
points taken without cofactor clearing), BLS12-381, Pallas and
ed-on-bls12-377 (with its order-2 and order-4 points and cofactor-4
points). Inputs come from numpy seeds; port tensors live on the CPU, so the
kernels' plain versions run; comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu import concrete as jconcrete
from montgomery_tpu.bigint import TwistedEdwardsCurve, WeierstrassCurve
from montgomery_tpu.bigint.twisted_edwards import EdwardsPoint as JEdPoint
from montgomery_tpu.bigint.weierstrass import AffinePoint as JPoint
from montgomery_tpu.curves import AffineBatch as JAffineBatch
from montgomery_tpu.curves import EdwardsBatch as JEdwardsBatch
from montgomery_tpu.curves import EdwardsOps as JEdwardsOps
from montgomery_tpu.curves import ProjectiveOps as JProjectiveOps
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.bigint.twisted_edwards import EdwardsPoint
from montgomery_tpu_torch.bigint.weierstrass import AffinePoint
from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.curves.edwards import EdwardsOps
from montgomery_tpu_torch.curves.projective import ProjectiveOps
from montgomery_tpu_torch.ops.field import create_field_ops

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

W_JAX = 13
JAX_PARAMS = {c.label: c for c in (jconcrete.BLS12_377, jconcrete.BLS12_381, jconcrete.PALLAS,
                                  jconcrete.ED_ON_BLS12_377)}


def _ints(rng: np.random.Generator, bound: int, n: int) -> list[int]:
    nb = (bound.bit_length() + 7) // 8 + 8
    raw = rng.bytes(n * nb)
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % bound for i in range(n)]


def _subgroup_points(C, rng, n: int) -> list:
    """n multiples k G of the oracle's generator, k drawn from rng."""
    return [C.scale(k, C.generator) for k in _ints(rng, C.params.order, n)]


def _weierstrass_raw(C, rng, n: int) -> list:
    """n on-curve points (x, sqrt(x^3 + b)) without cofactor clearing."""
    F, out = C.field, []
    while len(out) < n:
        x = _ints(rng, F.p, 1)[0]
        y = F.sqrt(F.add(F.mul(F.square(x), x), C.b))
        if y is not None:
            out.append(JPoint(x, y))
    return out


def _edwards_raw(E, rng, n: int) -> list:
    """n on-curve points of -x^2 + y^2 = 1 + d x^2 y^2 without cofactor
    clearing (tests/test_negative.py's draw)."""
    F, out = E.field, []
    while len(out) < n:
        x = _ints(rng, F.p, 1)[0]
        den = F.sub(1, F.mul(E.d, F.square(x)))
        y = F.sqrt(F.mul(F.add(1, F.square(x)), F.inv(den))) if den else None
        if y is not None:
            out.append(JEdPoint(x, y))
    return out


def _port_points(pts, cls):
    return [cls.zero() if P.is_zero else cls(P.x, P.y) for P in pts]


def _jax_mont(jf, values):
    """Ints -> the JAX package's Montgomery planes, built on the host (its
    own packing runs a jitted conversion, seconds of compiles here)."""
    rj = 1 << (W_JAX * jf.n)
    return jnp.asarray(interop.ints_to_planes([v % jf.p * rj % jf.p for v in values], W_JAX, jf.n))


def _jax_affine(jf, pts) -> JAffineBatch:
    return JAffineBatch(_jax_mont(jf, [0 if P.is_zero else P.x for P in pts]),
                        _jax_mont(jf, [0 if P.is_zero else P.y for P in pts]),
                        jnp.asarray([P.is_zero for P in pts]))


def _jax_edwards(jf, pts) -> JEdwardsBatch:
    p = jf.p
    return JEdwardsBatch(*[_jax_mont(jf, v) for v in ([P.x for P in pts], [P.y for P in pts], [1] * len(pts),
                                                     [P.x * P.y % p for P in pts])])


def _on(C, raw, pt) -> bool:
    """JAX projective ints (X, Y, Z) are the point pt (cross-multiplied)."""
    p = C.field.p
    X, Y, Z = raw
    if pt.is_zero:
        return Z % p == 0
    return Z % p != 0 and X % p == pt.x * Z % p and Y % p == pt.y * Z % p


def _same(port_pts, jax_pts) -> bool:
    return all((a.is_zero and b.is_zero) or (not a.is_zero and not b.is_zero and (a.x, a.y) == (b.x, b.y))
               for a, b in zip(port_pts, jax_pts, strict=True))


@pytest.mark.parametrize("params", [PALLAS, BLS12_377], ids=lambda c: c.label)
def test_projective_predicates_and_mixed_adds(params):
    """eq, is_on_curve, add_mixed and sub_mixed on the edge lanes: the same
    points and flags as the oracle, and on BLS12-377 as the JAX package's
    functions (one jitted program: each JAX program costs seconds of
    compiles here)."""
    jparams = JAX_PARAMS[params.label]
    C = WeierstrassCurve(jparams)
    rng = np.random.default_rng(71)
    P, Q, R = _subgroup_points(C, rng, 3)
    Z0 = JPoint.zero()
    bad = JPoint((P.x + 1) % C.field.p, P.y)  # off the curve
    lhs = [P, Q, P, P, Z0, P, Z0, bad]
    rhs = [Q, P, P, C.neg(P), Q, Z0, Z0, R]
    sums = [C.add(a, b) for a, b in zip(lhs[:-1], rhs[:-1])]
    # eq's second operands: the sums from their affine form (another Z), and
    # the sums rolled by one lane
    sums_rolled = sums[1:] + sums[:1]
    proj = ProjectiveOps(create_field_ops(params.modulus), params)

    def port(points):
        return proj.affine_to_device(_port_points(points, AffinePoint), "cpu")

    A, B = proj.from_affine(port(lhs)), port(rhs)
    S, Sr = (proj.from_affine(port(v + [R])) for v in (sums, sums_rolled))
    madd, msub = proj.add_mixed(A, B), proj.sub_mixed(A, B)
    flags = [proj.eq(madd, S), proj.eq(madd, Sr), proj.eq(A, proj.from_affine(B)), proj.is_on_curve(A),
             proj.is_on_curve(madd)]
    flags = [f.tolist() for f in flags]
    got_add, got_sub = proj.to_host(madd)[:-1], proj.to_host(msub)[:-1]

    assert _same(got_add, sums)
    assert _same(got_sub, [C.sub(a, b) for a, b in zip(lhs[:-1], rhs[:-1])])
    assert flags[0][:-1] == [True] * len(sums)
    assert flags[1][:-1] == [C.equal(a, b) for a, b in zip(sums, sums_rolled)]
    assert flags[2] == [C.equal(a, b) for a, b in zip(lhs, rhs)]
    assert flags[3] == [True] * (len(lhs) - 1) + [False]
    assert flags[4][:-1] == [True] * len(sums)

    if params is BLS12_377:
        jproj = JProjectiveOps(jax_field_ops(jparams.modulus, w=W_JAX), jparams)
        jf = jproj.f

        @jax.jit
        def run(a, b, s, sr):
            a, s, sr = jproj.from_affine(a), jproj.from_affine(s), jproj.from_affine(sr)
            ma = jproj.add_mixed(a, b)
            return (ma, jproj.sub_mixed(a, b), jproj.eq(ma, s), jproj.eq(ma, sr),
                    jproj.eq(a, jproj.from_affine(b)), jproj.is_on_curve(a), jproj.is_on_curve(ma))

        jmadd, jmsub, *jflags = run(*[_jax_affine(jf, v) for v in (lhs, rhs, sums + [R], sums_rolled + [R])])
        assert all(_on(C, raw, a) for raw, a in zip(jproj.to_host_raw(jmadd), got_add))
        assert all(_on(C, raw, a) for raw, a in zip(jproj.to_host_raw(jmsub), got_sub))
        assert flags == [np.asarray(f).tolist() for f in jflags]


def test_edwards_sub():
    """EdwardsOps.sub on the edge lanes: the same points as the JAX
    package's jitted sub and the oracle's."""
    jparams = jconcrete.ED_ON_BLS12_377
    E = TwistedEdwardsCurve(jparams)
    rng = np.random.default_rng(72)
    P, Q = _subgroup_points(E, rng, 2)
    Z0 = JEdPoint.zero()
    lhs = [P, Q, P, P, Z0, P, Z0]
    rhs = [Q, P, P, E.neg(P), Q, Z0, Z0]
    ed = EdwardsOps(create_field_ops(ED_ON_BLS12_377.modulus), ED_ON_BLS12_377)
    jed = JEdwardsOps(jax_field_ops(jparams.modulus, w=W_JAX), jparams)
    got = ed.to_host(ed.sub(ed.to_device(_port_points(lhs, EdwardsPoint), "cpu"),
                            ed.to_device(_port_points(rhs, EdwardsPoint), "cpu")))
    raw = jed.to_host_raw(jax.jit(jed.sub)(_jax_edwards(jed.f, lhs), _jax_edwards(jed.f, rhs)))
    p = E.field.p
    assert all(Z % p and X % p == a.x * Z % p and Y % p == a.y * Z % p
               for (X, Y, Z, _), a in zip(raw, got, strict=True))
    assert [(a.x, a.y) for a in got] == [(b.x, b.y) for b in (E.sub(a, b) for a, b in zip(lhs, rhs))]


def _weierstrass_subgroup_lanes(params, rng):
    C = WeierstrassCurve(JAX_PARAMS[params.label])
    pts = _subgroup_points(C, rng, 2) + [JPoint.zero()] + _weierstrass_raw(C, rng, 3)
    if C.cofactor % 2 == 0:  # (p - 1, 0): x^3 + 1 = 0 for b = 1, order 2
        assert C.b == 1
        pts.append(JPoint(C.field.p - 1, 0))
    return C, pts


@pytest.mark.parametrize("params", [BLS12_377, BLS12_381, PALLAS], ids=lambda c: c.label)
def test_is_in_subgroup_weierstrass(params):
    """order P == 0 per lane, as the oracle decides it: subgroup points,
    infinity, points without cofactor clearing (all in the subgroup on
    Pallas, whose cofactor is 1), and on BLS12-377 the order-2 point, where
    the RCB add meets its exceptional case."""
    C, pts = _weierstrass_subgroup_lanes(params, np.random.default_rng(73))
    proj = ProjectiveOps(create_field_ops(params.modulus), params)
    A = proj.from_affine(proj.affine_to_device(_port_points(pts, AffinePoint), "cpu"))
    want = [C.is_in_subgroup(P) for P in pts]
    assert proj.is_on_curve(A).all()
    assert proj.is_in_subgroup(A).tolist() == want
    if params is PALLAS:
        assert all(want)
    else:
        assert want[:3] == [True] * 3 and not any(want[3:6])
    if params is BLS12_377:
        assert want[-1] is False


def test_is_in_subgroup_edwards():
    """ed-on-bls12-377 (cofactor 4): subgroup points, the identity, the
    order-2 point (0, -1), the order-4 points (+-1 / sqrt(-1), 0) and points
    without cofactor clearing (tests/test_negative.py's case)."""
    jparams = jconcrete.ED_ON_BLS12_377
    E = TwistedEdwardsCurve(jparams)
    rng = np.random.default_rng(74)
    F = E.field
    i = F.sqrt(F.p - 1)
    pts = (_subgroup_points(E, rng, 2) + [JEdPoint.zero(), JEdPoint(0, F.p - 1)]
           + [JEdPoint(F.inv(i), 0), JEdPoint(F.neg(F.inv(i)), 0)] + _edwards_raw(E, rng, 3))
    assert all(E.is_on_curve(P) for P in pts)
    want = [E.is_in_subgroup(P) for P in pts]
    assert want[:3] == [True] * 3 and not any(want[3:6])
    ed = EdwardsOps(create_field_ops(ED_ON_BLS12_377.modulus), ED_ON_BLS12_377)
    got = ed.is_in_subgroup(ed.to_device(_port_points(pts, EdwardsPoint), "cpu"))
    assert got.tolist() == want
