"""montgomery_tpu_torch MSM API entries against montgomery_tpu and its bigint
oracle: the host digits (`digits`, `digits_glv`), the host entries without
GLV (`WeierstrassMsm.msm` on every engine, `EdwardsMsm.msm`) and with host
GLV digits (`msm_glv`), `window_chunk` on every accumulation path and
through `msm_full_sharded`, and the size sweep N in {1, 2^5, 2^9} on the
safe and the unsafe engine through `msm` and `msm_full`.

The digits equal the JAX package's bit for bit (they are numpy there);
every MSM equals the JAX package's bigint oracle (`montgomery_tpu.bigint.msm`;
the JAX package's own jitted MSM costs minutes a case here). The MSM lanes
are tests/test_msm.py's: a zero scalar, scalar 1, a duplicated point and a
cancelling pair, the last two for the complete engines only (the unsafe
engine's contract excludes them). Inputs come from numpy seeds; port tensors
live on the CPU, so the kernels' plain versions run.
"""

import numpy as np
import pytest
import torch

from montgomery_tpu import concrete as jconcrete
from montgomery_tpu.bigint import TwistedEdwardsCurve, WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.msm import EdwardsMsm as JEdwardsMsm
from montgomery_tpu.msm import WeierstrassMsm as JWeierstrassMsm
from montgomery_tpu_torch.bigint.twisted_edwards import EdwardsPoint
from montgomery_tpu_torch.bigint.weierstrass import AffinePoint
from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.msm import EdwardsMsm, WeierstrassMsm
from montgomery_tpu_torch.parallel import make_mesh, msm_full_sharded, shard_points

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

JAX_PARAMS = {c.label: c for c in (jconcrete.BLS12_377, jconcrete.BLS12_381, jconcrete.PALLAS,
                                  jconcrete.ED_ON_BLS12_377)}
ENGINES = {"projective": {}, "affine": {"affine": True}, "affine_unsafe": {"affine": True, "unsafe": True}}
N, C_WIN, SB = 16, 4, 64


def _ints(rng: np.random.Generator, bound: int, n: int) -> list[int]:
    nb = (bound.bit_length() + 7) // 8 + 8
    raw = rng.bytes(n * nb)
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % bound for i in range(n)]


def _points(C, rng, n: int) -> list:
    """n multiples k G of the oracle's generator, 1 <= k < 2^62."""
    return [C.scale(k + 1, C.generator) for k in _ints(rng, 1 << 62, n)]


def _port(pts, cls):
    return [cls.zero() if P.is_zero else cls(P.x, P.y) for P in pts]


def _lanes(C, rng, complete: bool):
    """tests/test_msm.py's lanes at N = 16 with 62-bit scalars: a zero
    scalar, scalar 1 and scalar 2; with `complete` a duplicated point and a
    cancelling pair (5 P + 5 (-P))."""
    pts = _points(C, rng, N)
    sc = [k for k in _ints(rng, 1 << 62, N)]
    sc[0], sc[1], sc[4] = 0, 1, 2
    if complete:
        pts[3] = pts[2]
        pts[6], sc[5], sc[6] = C.neg(pts[5]), 5, 5
    return pts, sc


def _equal(C, got, want) -> bool:
    return (got.is_zero and want.is_zero) or (not got.is_zero and C.equal(want, type(want)(got.x, got.y)))


def test_digits_match_jax():
    """digits and digits_glv equal the JAX package's bit for bit on edge
    scalars (0, 1, q - 1, q, q + 5, 2^256 - 1) and random ones; a reduced
    scalar above scalar_bits raises ValueError (an assert there)."""
    rng = np.random.default_rng(81)
    for params in (BLS12_377, BLS12_381, PALLAS):
        jctx, ctx = JWeierstrassMsm(JAX_PARAMS[params.label]), WeierstrassMsm(params, device="cpu")
        q = params.order
        sc = [0, 1, q - 1, q, q + 5, (1 << 256) - 1] + _ints(rng, 1 << 256, 10)
        for c in (4, 13):
            assert np.array_equal(ctx.digits(sc, c), jctx.digits(sc, c))
            assert np.array_equal(ctx.digits_glv(sc, c), jctx.digits_glv(sc, c))
        small = [s % (1 << 64) for s in sc]
        assert np.array_equal(ctx.digits(small, C_WIN, scalar_bits=SB), jctx.digits(small, C_WIN, scalar_bits=SB))
        with pytest.raises(ValueError, match="scalar_bits"):
            ctx.digits([1 << 64], C_WIN, scalar_bits=SB)
    te, jte = EdwardsMsm(ED_ON_BLS12_377, device="cpu"), JEdwardsMsm(jconcrete.ED_ON_BLS12_377)
    sc = [0, 1, ED_ON_BLS12_377.order + 1] + _ints(rng, 1 << 256, 10)
    assert np.array_equal(te.digits(sc, 5), jte.digits(sc, 5))
    assert np.array_equal(te.digits(sc, C_WIN, scalar_bits=260), jte.digits(sc, C_WIN, scalar_bits=260))


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("params", [PALLAS, BLS12_377], ids=lambda c: c.label)
def test_msm_engines(params, engine):
    """WeierstrassMsm.msm (host digits, no GLV) on each engine at N = 16,
    c = 4, scalar_bits = 64 equals the oracle."""
    C = WeierstrassCurve(JAX_PARAMS[params.label])
    pts, sc = _lanes(C, np.random.default_rng(82), complete=engine != "affine_unsafe")
    ctx = WeierstrassMsm(params, device="cpu")
    got = ctx.msm(sc, _port(pts, AffinePoint), c=C_WIN, scalar_bits=SB, **ENGINES[engine])
    assert _equal(C, got, oracle_msm(C, sc, pts))


def test_msm_glv_and_edwards():
    """msm_glv (host GLV digits, the projective engine on [P, phi(P)]) on
    Pallas with full-width scalars, and EdwardsMsm.msm at N = 16, c = 4,
    scalar_bits = 64, equal the oracle; both default c from N."""
    rng = np.random.default_rng(83)
    C = WeierstrassCurve(jconcrete.PALLAS)
    pts, sc = _lanes(C, rng, complete=True)
    sc[7], sc[8] = PALLAS.order - 1, PALLAS.order + 3
    got = WeierstrassMsm(PALLAS, device="cpu").msm_glv(sc, _port(pts, AffinePoint))
    assert _equal(C, got, oracle_msm(C, [s % PALLAS.order for s in sc], pts))
    E = TwistedEdwardsCurve(jconcrete.ED_ON_BLS12_377)
    pts, sc = _lanes(E, rng, complete=True)
    pts[9] = type(pts[0]).zero()
    te = EdwardsMsm(ED_ON_BLS12_377, device="cpu")
    got = te.msm(sc, _port(pts, EdwardsPoint), c=C_WIN, scalar_bits=SB)
    assert _equal(E, got, oracle_msm(E, sc, pts))
    assert _equal(E, te.msm(sc, _port(pts, EdwardsPoint), scalar_bits=SB), oracle_msm(E, sc, pts))


@pytest.mark.parametrize("engine", ["projective", "affine", "edwards"])
def test_window_chunk(engine):
    """window_chunk in {None, 1, 3} gives the oracle's point through
    msm_device: Pallas with 16-bit scalars at c = 4 has K = 5 windows, so
    chunks of 3 pad to K_pad = 6 with a zero-digit window."""
    rng = np.random.default_rng(84)
    if engine == "edwards":
        C = TwistedEdwardsCurve(jconcrete.ED_ON_BLS12_377)
        ctx = EdwardsMsm(ED_ON_BLS12_377, device="cpu")
        pts, sc = _lanes(C, rng, complete=True)
        P = ctx.to_device(_port(pts, EdwardsPoint))
    else:
        C = WeierstrassCurve(jconcrete.PALLAS)
        ctx = WeierstrassMsm(PALLAS, device="cpu")
        pts, sc = _lanes(C, rng, complete=True)
        P = ctx.affine_to_device(_port(pts, AffinePoint))
    sc = [s % (1 << 16) for s in sc]
    d = torch.from_numpy(ctx.digits(sc, C_WIN, scalar_bits=16))
    assert d.shape[0] == 5
    want = oracle_msm(C, sc, pts)
    kw = {} if engine == "edwards" else {"affine": engine == "affine"}
    for wc in (None, 1, 3):
        S = ctx.msm_device(P, d, C_WIN, window_chunk=wc, **kw)
        got = (ctx.ed if engine == "edwards" else ctx.proj).to_host(S)[0]
        assert _equal(C, got, want), wc


def test_window_chunk_sharded():
    """msm_full_sharded at D = 2 with window_chunk in {None, 1, 3} (the
    projective engine, GLV digits at c = 8: K = 17 windows) equals the
    oracle."""
    rng = np.random.default_rng(85)
    C = WeierstrassCurve(jconcrete.PALLAS)
    pts, sc = _lanes(C, rng, complete=True)
    sc = [s * (1 << 190) + 7 for s in sc]  # full-width scalars
    ctx = WeierstrassMsm(PALLAS, device="cpu")
    mesh = make_mesh(2, devices=["cpu"] * 2)
    A, L = shard_points(ctx.affine_to_device(_port(pts, AffinePoint)), ctx.scalars_to_limbs(sc), mesh)
    want = oracle_msm(C, [s % PALLAS.order for s in sc], pts)
    for wc in (None, 1, 3):
        S = msm_full_sharded(ctx, A, L, 8, mesh, affine=False, window_chunk=wc)
        assert _equal(C, ctx.proj.to_host(S)[0], want), wc


@pytest.mark.parametrize("unsafe", [False, True], ids=["safe", "unsafe"])
@pytest.mark.parametrize("log2n", [0, 5, 9])
def test_size_sweep(log2n, unsafe):
    """The size sweep on Pallas: N = 2^log2n distinct points, full-width
    scalars through msm_full (GLV on the device) and 64-bit scalars through
    msm (host digits), on the safe or the unsafe batched-affine engine at
    the default c; both equal the oracle."""
    n = 1 << log2n
    rng = np.random.default_rng(86 + log2n)
    C = WeierstrassCurve(jconcrete.PALLAS)
    ctx = WeierstrassMsm(PALLAS, device="cpu")
    pts = _points(C, rng, n)
    A = ctx.affine_to_device(_port(pts, AffinePoint))
    sc = _ints(rng, PALLAS.order, n)
    got = ctx.msm_full(sc, A, unsafe=unsafe)
    assert _equal(C, got, oracle_msm(C, sc, pts))
    small = [s % (1 << SB) for s in sc]
    got = ctx.msm(small, A, affine=True, unsafe=unsafe, scalar_bits=SB)
    assert _equal(C, got, oracle_msm(C, small, pts))
