"""montgomery_tpu_torch on BLS12-381 (13 limbs of 32 bits) and Pallas (9 limbs).

The curves beside BLS12-377 run the same Weierstrass modules at their own
limb counts. Module by module against montgomery_tpu, on inputs made from a
numpy seed and compared as canonical values or affine points (tolerance
zero): `pack_rows_glv`, the unsafe and the safe packed add (doubling,
cancellation through the signs, infinite operands and unpaired lanes in the
safe one), `ProjectiveOps.add`, `double_n` (k = 1, 5) and the window combine,
and `FieldOps.square` on 0, 1, p - 1 and the unreduced range [p, 2p). The
JAX side runs as one jitted program per curve in the suite's callback kernel
mode. The slice as a whole: `msm_full` on every engine at N = 32 with
scalars 0, 1 and q - 1 and a duplicate point (the safe and projective
engines), equal to `montgomery_tpu.bigint.msm`. Port tensors live on the
CPU, so the kernels' plain versions run; the kernels themselves are held
against them on the card by chip_smoke.py. Without a card, the registry:
every symbol of every kernel is an entry point of its source, and every
Weierstrass kernel has one at 12, 13 and 9 limbs.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu import concrete as jconcrete
from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.curves.projective import ProjectiveBatch as JProjectiveBatch
from montgomery_tpu.msm import WeierstrassMsm as JaxMsm
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu_torch import concrete, interop, micro_bench  # noqa: F401  (registers every kernel)
from montgomery_tpu_torch.curves.projective import ProjectiveBatch
from montgomery_tpu_torch.msm import WeierstrassMsm
from montgomery_tpu_torch.ops import kernels

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

W_JAX = 13
# (the port's and the JAX package's parameters, the port's limb count)
CURVES = {"bls12-381": (concrete.BLS12_381, jconcrete.BLS12_381, 13),
          "pallas": (concrete.PALLAS, jconcrete.PALLAS, 9)}
# the packed adds' lanes: signs and pair flags; the safe add's lanes also
# hold a doubling (lane 1), a cancellation (lane 2: B = A, other sign),
# infinite operands (lanes 3-5) and an unpaired lane reading A twice (lane 6)
SA = [0, 1, 0, 1, 0, 1, 0, 1, 0, 1]
SB = [1, 1, 1, 0, 1, 0, 0, 0, 1, 1]
HP = [1, 1, 1, 1, 1, 1, 0, 0, 1, 1]
K_WIN, C_WIN = 4, 3  # the combine: K windows of c bits, identities among them
ROOT = Path(__file__).resolve().parents[1]
# kernels of the Twisted Edwards engine (9 limbs), the GLV digits (sizes fixed
# per curve at compile time) and the micro-benchmark's baselines (12 and 9):
# every other kernel is a Weierstrass one, built at 12, 13 and 9 limbs
NOT_WEIERSTRASS = {"ed_add", "ed_dbl", "ed_add_packed", "ed_combine", "glv_digits", "divstep_inv",
                   "barrett_mul"}
# built at every Weierstrass count and at the 1-3 limb example fields'
FIELD_KERNELS = {"mont_mul", "mont_sqr", "mul_const", "exp_ladder", "sqr_n", "sqrt_win", "divstep_inv_mont",
                 "divstep_inv", "barrett_mul"}


@pytest.fixture(scope="module", params=sorted(CURVES))
def curve(request):
    """The port's context on the CPU, the JAX package's, the oracle and
    distinct points k G with numpy-drawn k."""
    params, jparams, n = CURVES[request.param]
    msm = WeierstrassMsm(params, device="cpu")
    assert msm.fops.n == n
    E = WeierstrassCurve(jparams)
    rng = np.random.default_rng(381 if n == 13 else 255)
    pts = [E.scale(int(k), E.generator) for k in rng.integers(1, 1 << 62, size=40)]
    return msm, JaxMsm(jparams), E, pts, rng


def _lanes(E, pts):
    """The packed adds' operands: the unsafe add's distinct points, and the
    safe add's with its hazards."""
    A, B = pts[:len(SA)], pts[len(SA):2 * len(SA)]
    sA, sB = list(A), list(B)
    sB[1] = sA[1]  # equal signs: a doubling
    sB[2] = sA[2]  # other signs: a cancellation
    sA[3] = AffinePoint.zero()
    sB[4] = AffinePoint.zero()
    sA[5] = sB[5] = AffinePoint.zero()
    sB[6] = sA[6]
    return (A, B), (sA, sB)


def _projective(E, jf, p, pts, zs):
    """JAX Montgomery planes of (x z, y z, z); infinity is (0, 1, 0)."""
    rj = 1 << (W_JAX * jf.n)
    cols = [[], [], []]
    for pt, z in zip(pts, zs):
        X, Y, Z = (0, 1, 0) if pt.is_zero else (pt.x * z % p, pt.y * z % p, z)
        for col, v in zip(cols, (X, Y, Z)):
            col.append(v * rj % p)
    return JProjectiveBatch(*[jcodec.pack(col, jf.mp) for col in cols])


@pytest.fixture(scope="module")
def jax_side(curve):
    """The JAX package's results on the tests' inputs, in one jitted
    program: pack_rows_glv, both packed adds, the projective add, double_n
    (k = 1, 5), the Horner combine with that add and double_n, and
    square."""
    msm, jctx, E, pts, rng = curve
    jf, jaff, jproj = jctx.fops, jctx.affine, jctx.proj
    p = jf.p
    (uA, uB), (sA, sB) = _lanes(E, pts)
    glv = pts[20:27] + [AffinePoint.zero()]
    lhs = [pts[30], pts[31], pts[30], AffinePoint.zero(), pts[32], AffinePoint.zero()]
    rhs = [pts[33], pts[31], E.neg(pts[30]), pts[34], AffinePoint.zero(), AffinePoint.zero()]
    zs = [int(z) for z in rng.integers(1, 1 << 62, size=2 * len(lhs))]
    JP, JQ = _projective(E, jf, p, lhs, zs[:6]), _projective(E, jf, p, rhs, zs[6:12])
    # the combine's windows: window k of the six lanes is lhs rotated by k
    # (identities among them)
    win = [lhs[k:] + lhs[:k] for k in range(K_WIN)]
    JW = [_projective(E, jf, p, w, zs[2 * k:2 * k + 6]) for k, w in enumerate(win)]
    rj = 1 << (W_JAX * jf.n)
    vals = [0, 1, p - 1] + [int(v) % p for v in rng.integers(2, 1 << 62, size=5)]
    mont = [v * rj % p for v in vals]
    jx = jcodec.pack(mont + [m + p for m in mont], jf.mp)  # then the unreduced [p, 2p)
    flags = [np.asarray([v], dtype=np.int32) for v in (SA, SB, HP)]

    def horner(W):  # sum_k 2^(c k) W_k with the JAX package's add and double_n
        acc = W[-1]
        for k in range(K_WIN - 2, -1, -1):
            acc = jproj.add(jproj.double_n(acc, C_WIN), W[k])
        return acc

    def run(G, UA, UB, SA_, SB_, a, b, v, P, Q, W, x):
        packed = [jaff.pack_rows(X) for X in (UA, UB, SA_, SB_)]
        return (jaff.unpack_rows(jaff.pack_rows_glv(G)),
                jaff.unpack_rows(jaff.add_packed(packed[0], packed[1], a, b, v, unsafe=True)),
                jaff.unpack_rows(jaff.add_packed(packed[2], packed[3], a, b, v)),
                jproj.add(P, Q), jproj.double_n(P, 1), jproj.double_n(P, 5), horner(W), jf.square(x))

    ins = [jproj.affine_to_device(v) for v in (glv, uA, uB, sA, sB)]
    outs = jax.jit(run)(*ins, *flags, JP, JQ, JW, jx)
    keys = ("glv", "unsafe", "safe", "add", "dbl1", "dbl5", "combine", "square")
    return dict(zip(keys, outs)), dict(glv=glv, unsafe=(uA, uB), safe=(sA, sB), lhs=lhs, rhs=rhs,
                                       win=win, vals=vals, JP=JP, JQ=JQ, JW=JW, jx=jx)


def _affine(msm, JA):
    return interop.affine_from_jax(np.asarray(JA.x), np.asarray(JA.y), np.asarray(JA.inf), msm.fops,
                                   device="cpu")


def _proj(msm, JP):
    return interop.projective_from_jax(*[np.asarray(a) for a in JP], msm.fops, device="cpu")


def _signed_sum(E, a, b, i):
    a = E.neg(a) if SA[i] else a
    b = E.neg(b) if SB[i] else b
    return E.add(a, b) if HP[i] else a


def test_pack_rows_glv_matches_jax(curve, jax_side):
    msm, _, E, _, _ = curve
    out, ins = jax_side
    n = msm.fops.n
    rows = msm.affine.pack_rows_glv(msm.affine_to_device(ins["glv"]))
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (2 * n + 1, 2 * len(ins["glv"]))
    assert msm.affine.packed_rows == 2 * n + 1
    got = msm.proj.affine_to_host(msm.affine.unpack_rows(rows))
    via_jax = msm.proj.affine_to_host(_affine(msm, out["glv"]))
    want = ins["glv"] + [AffinePoint.zero() if p.is_zero else E.endomorphism(p) for p in ins["glv"]]
    for a, b, w in zip(got, via_jax, want, strict=True):
        assert E.equal(a, w) and E.equal(b, w)


@pytest.mark.parametrize("unsafe", [True, False], ids=["unsafe", "safe"])
def test_add_packed_matches_jax(curve, jax_side, unsafe):
    """The packed add against the JAX package's and the oracle, lane by
    lane; the safe add on lanes with its hazards."""
    msm, _, E, _, _ = curve
    out, ins = jax_side
    aff = msm.affine
    A, B = ins["unsafe" if unsafe else "safe"]
    C = torch.cat([aff.pack_rows(msm.affine_to_device(v)) for v in (A, B)], dim=1)
    M = len(A)
    flags = (torch.tensor([v], dtype=torch.int32) for v in (SA, SB, HP))
    res = aff.add_packed(C[:, :M], C[:, M:], *flags, unsafe=unsafe)
    got = msm.proj.affine_to_host(aff.unpack_rows(res))
    via_jax = msm.proj.affine_to_host(_affine(msm, out["unsafe" if unsafe else "safe"]))
    for i in range(M):
        want = _signed_sum(E, A[i], B[i], i)
        assert E.equal(got[i], want) and E.equal(via_jax[i], want), f"lane {i}"
    if not unsafe:
        assert [g.is_zero for g in got[2:6]] == [True, False, False, True]  # cancel, inf lanes


def test_projective_add_matches_jax(curve, jax_side):
    msm, _, E, _, _ = curve
    out, ins = jax_side
    proj = msm.proj
    got = proj.to_host(proj.add(_proj(msm, ins["JP"]), _proj(msm, ins["JQ"])))
    via_jax = proj.to_host(_proj(msm, out["add"]))
    for g, j, a, b in zip(got, via_jax, ins["lhs"], ins["rhs"], strict=True):
        want = E.add(a, b)
        assert E.equal(g, want) and E.equal(j, want)


@pytest.mark.parametrize("k", [1, 5])
def test_double_n_matches_jax(curve, jax_side, k):
    msm, _, E, _, _ = curve
    out, ins = jax_side
    proj = msm.proj
    got = proj.to_host(proj.double_n(_proj(msm, ins["JP"]), k))
    via_jax = proj.to_host(_proj(msm, out[f"dbl{k}"]))
    for g, j, a in zip(got, via_jax, ins["lhs"], strict=True):
        want = E.scale(1 << k, a)
        assert E.equal(g, want) and E.equal(j, want)


def test_combine_matches_jax(curve, jax_side):
    """The Horner combine (one launch on the card) of six lanes of K
    windows, identities among them, against the same order of the JAX
    package's add and double_n and against the oracle."""
    msm, _, E, _, _ = curve
    out, ins = jax_side
    proj, n = msm.proj, msm.fops.n
    W = [_proj(msm, JW) for JW in ins["JW"]]
    planes = ProjectiveBatch(*[torch.stack([w[i] for w in W], dim=-1) for i in range(3)])  # (n, 6, K)
    got = proj.to_host(proj.combine(planes, C_WIN))
    via_jax = proj.to_host(_proj(msm, out["combine"]))
    for lane, (g, j) in enumerate(zip(got, via_jax, strict=True)):
        want = AffinePoint.zero()
        for k, w in enumerate(ins["win"]):
            want = E.add(want, E.scale(1 << (C_WIN * k), w[lane]))
        assert E.equal(g, want) and E.equal(j, want), lane
    assert tuple(planes.X.shape) == (n, 6, K_WIN)


def test_square_matches_jax(curve, jax_side):
    msm, _, _, _, _ = curve
    out, ins = jax_side
    f = msm.fops
    p = f.p
    vals = ins["vals"]
    x = f.pack_raw([v * f.R % p for v in vals] + [v * f.R % p + p for v in vals], "cpu")
    got = f.square(x)
    assert torch.equal(got, f.mul(x, x))  # bit for bit, as the kernel
    via_jax = f.unpack(interop.field_from_jax(np.asarray(out["square"]), f, device="cpu"), from_mont=True)
    assert f.unpack(got, from_mont=True) == via_jax == [v * v % p for v in vals] * 2


@pytest.mark.parametrize("engine", ["affine_safe", "affine_unsafe", "projective"])
def test_msm_full_matches_oracle(curve, engine):
    """The slice as a whole at N = 32: scalars 0, 1 and q - 1 among numpy
    draws; the safe and projective engines also with a duplicate point
    under one scalar (a doubling in a bucket) and the point at infinity.
    The unsafe engine takes distinct points, its contract."""
    msm, jctx, E, pts, _ = curve
    q = E.params.order
    rng = np.random.default_rng(32)
    raw = rng.integers(0, 256, size=32 * 32, dtype=np.uint8).tobytes()
    sc = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little") % q for i in range(32)]
    sc[0], sc[1], sc[2] = 0, 1, q - 1
    P_ = list(pts[:32])
    if engine != "affine_unsafe":
        P_[5], sc[5] = P_[4], sc[4]
        P_[7] = AffinePoint.zero()
    kw = {"affine_safe": {}, "affine_unsafe": dict(unsafe=True), "projective": dict(affine=False)}[engine]
    got = msm.msm_full(sc, P_, **kw)
    assert E.equal(got, oracle_msm(E, sc, P_))


@pytest.mark.parametrize("name", sorted(kernels.REGISTRY))
def test_registry_symbols_are_entry_points(name):
    """Each C symbol the kernel's launches look up is defined by its source
    (`extern "C" int <symbol>(`), under MSM_AT(n) for its limb count n, so
    the per-count builds define it once; a Weierstrass curve kernel has all
    three counts, the field kernels (and divstep_inv, barrett_mul) those and
    the 1-3 limb example fields'."""
    k = kernels.REGISTRY[name]
    src = (ROOT / k.source).read_text()
    for n, sym in k.symbols.items():
        assert src.count(f'extern "C" int {sym}(') == 1, (name, sym)
        if n is not None and "MSM_AT(" in src:
            head = src[:src.index(f'extern "C" int {sym}(')]
            assert head.rstrip().endswith(f"#if MSM_AT({n})"), (name, sym)
    if name in FIELD_KERNELS:
        assert sorted(k.symbols) == [1, 2, 3, 9, 12, 13], name
    elif name not in NOT_WEIERSTRASS:
        assert sorted(k.symbols) == [9, 12, 13], name
