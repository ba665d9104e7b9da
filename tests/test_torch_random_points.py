"""montgomery_tpu_torch sqrt-trial random points against the bigint oracle
and montgomery_tpu's candidate draw.

`random_points_weierstrass` and `random_points_edwards` run on CPU tensors
here (the kernels' plain versions). The JAX package's generators take minutes
on this CPU, so each point is checked by rebuilding it on the host: the same
candidate draw as the JAX package's `_uniform_field_vals`, the first N
candidates whose right-hand side is a square (Euler's criterion), the port's
root of that right-hand side, and the oracle's cofactor multiple. The
point-for-point comparison with the JAX generators is marked slow.
"""

import contextlib
import random
import types

import numpy as np
import pytest
import torch

from montgomery_tpu.curves.random import _uniform_field_vals as jax_uniform_field_vals
from montgomery_tpu_torch.bigint import AffinePoint, EdwardsPoint, TwistedEdwardsCurve
from montgomery_tpu_torch.bigint import WeierstrassCurve
from montgomery_tpu_torch.bigint import msm as oracle_msm
from montgomery_tpu_torch.concrete import BLS12_377, ED_ON_BLS12_377
from montgomery_tpu_torch.curves.projective import ProjectiveBatch
from montgomery_tpu_torch.curves.random import (
    _uniform_field_vals,
    random_points_edwards,
    random_points_weierstrass,
)
from montgomery_tpu_torch.msm import EdwardsMsm, WeierstrassMsm
from montgomery_tpu_torch.ops import kernels
from montgomery_tpu_torch.ops.field import SQR_N

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wctx():
    return WeierstrassMsm(BLS12_377, device="cpu"), WeierstrassCurve(BLS12_377)


@pytest.fixture(scope="module")
def ectx():
    return EdwardsMsm(ED_ON_BLS12_377, device="cpu"), TwistedEdwardsCurve(ED_ON_BLS12_377)


def _rhs_weierstrass(params, x):
    p = params.modulus
    return (x * x * x + params.a * x + params.b) % p


def _rhs_edwards(params, x):
    p = params.modulus
    den = (1 - params.d * x * x) % p
    return (1 + x * x) * pow(den, -1, p) % p if den else None


def _is_square(v, p):
    return v == 0 or pow(v, (p - 1) // 2, p) == 1


def _rebuild(f, params, N, seed, rhs_of):
    """The first N candidates (x, rhs) whose rhs is a square, from the JAX
    package's draw, and each rhs's root by the port's sqrt."""
    p = params.modulus
    xs = jax_uniform_field_vals(np.random.default_rng(seed), int(N * 2.5) + 16, p)
    picked = []
    for x in xs:
        rhs = rhs_of(params, x)
        if rhs is not None and _is_square(rhs, p):
            picked.append((x, rhs))
    picked = picked[:N]
    root, ok = f.sqrt(f.pack([r for _, r in picked], device="cpu", to_mont=True))
    assert ok.all()
    ys = f.unpack(root, from_mont=True)
    assert all(y * y % p == r for y, (_, r) in zip(ys, picked))
    return [x for x, _ in picked], ys


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_candidate_draw_matches_jax(seed):
    for p in (BLS12_377.modulus, ED_ON_BLS12_377.modulus):
        M = 41
        got = _uniform_field_vals(np.random.default_rng(seed), M, p)
        assert got == jax_uniform_field_vals(np.random.default_rng(seed), M, p)
        assert all(0 <= v < p for v in got)


def test_random_points_weierstrass(wctx):
    ctx, C = wctx
    N, seed = 6, 3
    A = random_points_weierstrass(ctx.proj, N, seed=seed, device="cpu")
    pts = ctx.proj.affine_to_host(A)
    assert len(pts) == N and not A.inf.any()
    assert all(C.is_on_curve(P) and not P.is_zero for P in pts)
    assert len({(P.x, P.y) for P in pts}) == N
    xs, ys = _rebuild(ctx.fops, BLS12_377, N, seed, _rhs_weierstrass)
    for P, x, y in zip(pts, xs, ys):
        assert C.equal(P, C.scale(BLS12_377.cofactor, AffinePoint(x, y)))
    assert C.is_in_subgroup(pts[0])


def test_random_points_edwards(ectx):
    te, E = ectx
    N, seed = 6, 7
    P = random_points_edwards(te.ed, N, seed=seed, device="cpu")
    assert te.ed.is_on_curve(P).all()
    pts = te.ed.to_host(P)
    assert len({(Q.x, Q.y) for Q in pts}) == N
    assert all(E.is_on_curve(Q) for Q in pts)
    xs, ys = _rebuild(te.fops, ED_ON_BLS12_377, N, seed, _rhs_edwards)
    for Q, x, y in zip(pts, xs, ys):
        assert E.equal(Q, E.scale(ED_ON_BLS12_377.cofactor, EdwardsPoint(x, y)))
    assert E.is_in_subgroup(pts[0])


def test_too_few_successes_raise(ectx):
    te, _ = ectx
    with pytest.raises(ValueError, match="oversample"):
        random_points_edwards(te.ed, 40, seed=1, device="cpu", oversample=0.0)


@pytest.mark.parametrize("k", [0, 1, 2, 6, 37, -5])
def test_projective_scale_and_to_affine(wctx, k):
    ctx, C = wctx
    proj, f = ctx.proj, ctx.fops
    rng = random.Random(k + 100)
    pts = [C.random_point(rng) for _ in range(3)] + [AffinePoint.zero()]
    A = proj.affine_to_device(pts, "cpu")
    P = proj.from_affine(A)
    z = f.pack([5, 7, 11, 13], device="cpu", to_mont=True)  # (X z : Y z : z)
    P = ProjectiveBatch(f.mul(P.X, z), f.mul(P.Y, z), f.mul(P.Z, z))
    out = proj.to_affine(proj.scale(k, P))
    assert out.inf.tolist() == [C.scale(k, Q).is_zero for Q in pts]
    for got, Q in zip(proj.affine_to_host(out), pts):
        assert C.equal(got, C.scale(k, Q))
    assert proj.is_zero(proj.zero(2, "cpu")).all()


@pytest.mark.parametrize("k", [0, 1, 4, 9, -3])
def test_edwards_scale(ectx, k):
    te, E = ectx
    rng = random.Random(k + 200)
    pts = [E.random_point(rng) for _ in range(3)] + [EdwardsPoint.zero()]
    out = te.ed.to_host(te.ed.scale(k, te.ed.to_device(pts, "cpu")))
    for got, Q in zip(out, pts):
        assert E.equal(got, E.scale(k, Q))


def test_generated_points_through_msm(wctx, ectx):
    """The slice as a whole: generated points through msm_full on the CPU,
    equal to the bigint oracle at N = 8."""
    ctx, C = wctx
    te, E = ectx
    rng = random.Random(8)
    A = random_points_weierstrass(ctx.proj, 8, seed=21, device="cpu")
    pts = ctx.proj.affine_to_host(A)
    sc = [rng.randrange(BLS12_377.order) for _ in range(8)]
    sc[0] = 0
    assert C.equal(ctx.msm_full(sc, A), oracle_msm(C, sc, pts))
    P = random_points_edwards(te.ed, 8, seed=22, device="cpu")
    tpts = te.ed.to_host(P)
    sc = [rng.randrange(ED_ON_BLS12_377.order) for _ in range(8)]
    assert E.equal(te.msm_full(sc, P), oracle_msm(E, sc, tpts))


def test_launch_runs_on_the_tensors_device(monkeypatch):
    """Kernel.launch enters the tensors' device and takes that device's
    current stream, not the current device's (checked without a card: a
    fake library and recorders in place of torch.cuda)."""
    seen = {"device": [], "stream": []}

    def fake_entry(*args):
        seen["args"] = args
        return 0

    @contextlib.contextmanager
    def fake_device(dev):
        seen["device"].append(torch.device(dev))
        yield

    def fake_stream(dev=None):
        seen["stream"].append(dev)
        index = torch.device(dev).index if dev is not None else 0
        return types.SimpleNamespace(cuda_stream=1000 + index)

    monkeypatch.setattr(kernels.LIBRARY, "get",
                        lambda: types.SimpleNamespace(msm_sqr_n=fake_entry))
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_stream)
    monkeypatch.setattr(SQR_N, "_fns", {})
    monkeypatch.setattr(SQR_N, "launches", 0)
    monkeypatch.setattr(SQR_N, "launches_by_n", {})
    dev = torch.device("cuda:1")
    SQR_N.launch(None, None, 3, None, 16, n=12, device=dev)
    assert seen["device"] == [dev]
    assert [torch.device(d) for d in seen["stream"]] == [dev]
    assert seen["args"][-1] == 1001  # cuda:1's stream went to the kernel
    assert SQR_N.launches == 1


@pytest.mark.slow
@pytest.mark.parametrize("seed", [3, 7])
def test_generators_point_for_point_against_jax(wctx, ectx, seed):
    """Both generators against the JAX package's at N = 4 (minutes on a CPU:
    run by hand with -m slow)."""
    from montgomery_tpu.curves.random import random_points_edwards as jax_edwards
    from montgomery_tpu.curves.random import random_points_weierstrass as jax_weierstrass
    from montgomery_tpu.concrete import BLS12_377 as JAX_BLS
    from montgomery_tpu.concrete import ED_ON_BLS12_377 as JAX_ED
    from montgomery_tpu.msm import EdwardsMsm as JaxEdwardsMsm
    from montgomery_tpu.msm import WeierstrassMsm as JaxWeierstrassMsm

    ctx, C = wctx
    te, E = ectx
    jctx = JaxWeierstrassMsm(JAX_BLS)
    want = jctx.proj.affine_to_host(jax_weierstrass(jctx.proj, 4, seed=seed))
    got = ctx.proj.affine_to_host(random_points_weierstrass(ctx.proj, 4, seed=seed, device="cpu"))
    assert [(P.x, P.y) for P in got] == [(P.x, P.y) for P in want]
    jte = JaxEdwardsMsm(JAX_ED)
    want = jte.ed.to_host(jax_edwards(jte.ed, 4, seed=seed))
    got = te.ed.to_host(random_points_edwards(te.ed, 4, seed=seed, device="cpu"))
    assert [(P.x, P.y) for P in got] == [(P.x, P.y) for P in want]
