"""montgomery_tpu_torch projective curve ops against montgomery_tpu.

The same projective inputs (random Z, made from a numpy seed) go to both
packages through `montgomery_tpu_torch.interop`; results are compared as
affine points (tolerance zero) and against the bigint oracle. The JAX side
runs eagerly in the suite's callback kernel mode.
"""

import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu.curves.projective import AffineBatch as JAffineBatch
from montgomery_tpu.curves.projective import ProjectiveBatch as JProjectiveBatch
from montgomery_tpu.curves.projective import ProjectiveOps as JProjectiveOps
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.curves.projective import ProjectiveOps
from montgomery_tpu_torch.ops.field import create_field_ops

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = BLS12_377.modulus
W_JAX = 13


@pytest.fixture(scope="module")
def ctx():
    jf = jax_field_ops(P, w=W_JAX)
    jproj = JProjectiveOps(jf, BLS12_377)
    f = create_field_ops(P)
    proj = ProjectiveOps(f, BLS12_377)
    E = WeierstrassCurve(BLS12_377)
    rng = np.random.default_rng(2024)
    G = E.generator
    pts = [E.scale(int(k), G) for k in rng.integers(1, 1 << 62, size=4)]
    A, B, C, D = pts
    Z = AffinePoint.zero()
    # lanes: generic, P == Q, P == -Q, zero operands, generic
    lhs = [A, B, A, Z, A, Z, C, D]
    rhs = [B, B, E.neg(A), C, Z, Z, D, A]
    zs = [int(z) for z in rng.integers(1, 1 << 62, size=2 * len(lhs))]
    return jf, jproj, f, proj, E, lhs, rhs, zs


def _jax_projective(jf, pts, zs):
    """Montgomery-form JAX planes of (x z, y z, z); zero is (0, 1, 0)."""
    rj = 1 << (W_JAX * jf.n)
    cols = [[], [], []]
    for pt, z in zip(pts, zs):
        X, Y, Zc = (0, 1, 0) if pt.is_zero else (pt.x * z % P, pt.y * z % P, z)
        for c, v in zip(cols, (X, Y, Zc)):
            c.append(v * rj % P)
    return JProjectiveBatch(*[jcodec.pack(c, jf.mp) for c in cols])


def _to_port(f, JP):
    return interop.projective_from_jax(*[np.asarray(a) for a in JP], f, device="cpu")


def test_add_matches_jax_and_oracle(ctx):
    jf, jproj, f, proj, E, lhs, rhs, zs = ctx
    JA = _jax_projective(jf, lhs, zs[: len(lhs)])
    JB = _jax_projective(jf, rhs, zs[len(lhs):])
    got = proj.to_host(proj.add(_to_port(f, JA), _to_port(f, JB)))
    via_jax = proj.to_host(_to_port(f, jproj.add(JA, JB)))
    for g, j, a, b in zip(got, via_jax, lhs, rhs):
        exp = E.add(a, b)
        assert E.equal(g, exp) and E.equal(j, exp)


@pytest.mark.parametrize("k", [1, 5])
def test_double_n_matches_jax_and_oracle(ctx, k):
    jf, jproj, f, proj, E, lhs, _, zs = ctx
    JA = _jax_projective(jf, lhs, zs[: len(lhs)])
    got = proj.to_host(proj.double_n(_to_port(f, JA), k))
    via_jax = proj.to_host(_to_port(f, jproj.double_n(JA, k)))
    for g, j, a in zip(got, via_jax, lhs):
        exp = E.scale(1 << k, a)
        assert E.equal(g, exp) and E.equal(j, exp)
    if k == 1:
        assert proj.to_host(proj.double(_to_port(f, JA))) == got


def test_endomorphism_matches_jax(ctx):
    jf, jproj, f, proj, E, lhs, _, _ = ctx
    rj = 1 << (W_JAX * jf.n)
    xs = [0 if p.is_zero else p.x * rj % P for p in lhs]
    ys = [0 if p.is_zero else p.y * rj % P for p in lhs]
    JA = JAffineBatch(jcodec.pack(xs, jf.mp), jcodec.pack(ys, jf.mp),
                      np.array([p.is_zero for p in lhs]))
    JE = jproj.endomorphism_affine(JA)
    TA = interop.affine_from_jax(JA.x, JA.y, JA.inf, f, device="cpu")
    got = proj.affine_to_host(proj.endomorphism_affine(TA))
    via_jax = proj.affine_to_host(interop.affine_from_jax(np.asarray(JE.x), np.asarray(JE.y), JE.inf, f,
                                                              device="cpu"))
    for g, j, a in zip(got, via_jax, lhs):
        assert E.equal(g, E.endomorphism(a)) and E.equal(j, g)


def test_from_affine_and_host_io(ctx):
    _, _, f, proj, E, lhs, _, _ = ctx
    A = proj.affine_to_device(lhs, device="cpu")
    assert all(E.equal(a, p) for a, p in zip(proj.affine_to_host(A), lhs))
    raw = proj.to_host_raw(proj.from_affine(A))
    for (X, Y, Z), p in zip(raw, lhs):
        assert (Z == 0) if p.is_zero else (X, Y, Z) == (p.x, p.y, 1)
    zero = proj.to_host(proj.zero(3, "cpu"))
    assert all(z.is_zero for z in zero)
    negs = proj.to_host(proj.neg(proj.from_affine(A)))
    assert all(E.equal(a, E.neg(p)) for a, p in zip(negs, lhs))
