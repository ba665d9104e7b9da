"""montgomery_tpu_torch sharded MSM (`parallel/sharded.py`) on logical
meshes of CPU shards, against the bigint oracle and the port's single-device
engine (mirror of tests/test_sharded.py).

`msm_full_sharded` runs the safe, unsafe and projective engines at D = 1, 2
and 8 shards (N = 32, c = 4, BLS12-377) with the hazards of the JAX test
planted: a zero scalar (empty buckets everywhere) and one point with the
same scalar in two shards (equal bucket sums meet in the butterfly, which
must double). With one shard the duplicate would share a bucket inside the
unsafe engine, whose contract excludes it, so the unsafe engine at D = 1
takes distinct points. `msm_sharded` runs the projective adapter on Pallas
at D = 8 on the JAX test's digits, and the Twisted Edwards adapter at D = 2.
A fake mesh over two CUDA devices shows that each shard's work runs in its
own device's scope and its data goes to its own device. Port tensors live on
the CPU, so the kernels' plain versions run.
"""

import contextlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import TwistedEdwardsCurve, WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.concrete import ED_ON_BLS12_377 as J_ED
from montgomery_tpu.concrete import PALLAS as J_PALLAS
from montgomery_tpu.concrete import BLS12_377 as J_BLS12_377
from montgomery_tpu.msm import WeierstrassMsm as JaxMsm
from montgomery_tpu_torch.concrete import BLS12_377, ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.msm import EdwardsMsm, WeierstrassMsm
from montgomery_tpu_torch.msm.api import SCALAR_W
from montgomery_tpu_torch.parallel import make_mesh, msm_full_sharded, msm_sharded, shard_points
from montgomery_tpu_torch.parallel import sharded
from montgomery_tpu_torch.scalar.device import signed_digits_device

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

N, C_WIN = 32, 4
ENGINES = {"safe": dict(), "unsafe": dict(unsafe=True), "projective": dict(affine=False)}


def cpu_mesh(D):
    return make_mesh(D, devices=["cpu"] * D)


@pytest.fixture(scope="module")
def bls():
    """The JAX test's inputs: 32 multiples of the generator, random
    scalars, scalar 0 at 0, point 1 with its scalar again at N/2 + 1 (a
    different shard for every D >= 2); the oracle's sums, with and without
    the duplicate."""
    C = WeierstrassCurve(J_BLS12_377)
    rng = random.Random(0xC0FFEE)
    pts = [C.scale(rng.randrange(1, 1 << 62), C.generator) for _ in range(N)]
    sc = [rng.randrange(J_BLS12_377.order) for _ in range(N)]
    sc[0] = 0
    dup = list(pts)
    dup[N // 2 + 1] = pts[1]
    dsc = list(sc)
    dsc[N // 2 + 1] = sc[1]
    return dict(C=C, ctx=WeierstrassMsm(BLS12_377, device="cpu"),
                hazards=(dup, dsc, oracle_msm(C, dsc, dup)), distinct=(pts, sc, oracle_msm(C, sc, pts)))


@pytest.fixture(scope="module")
def single(bls):
    """The single-device safe engine's sum of the inputs with the hazards."""
    dup, dsc, _ = bls["hazards"]
    return bls["ctx"].msm_full(dsc, dup, c=C_WIN)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("D", [1, 2, 8])
def test_msm_full_sharded(bls, single, D, engine):
    C, ctx = bls["C"], bls["ctx"]
    pts, sc, want = bls["distinct" if D == 1 and engine == "unsafe" else "hazards"]
    mesh = cpu_mesh(D)
    A, L = shard_points(ctx.affine_to_device(pts), ctx.scalars_to_limbs(sc), mesh)
    assert [a.x.shape[-1] for a in A] == [N // D] * D
    S = msm_full_sharded(ctx, A, L, C_WIN, mesh, **ENGINES[engine])
    assert S.X.shape == (ctx.fops.n, 1)
    got = ctx.proj.to_host(S)[0]
    assert C.equal(got, want)
    if pts[N // 2 + 1] is pts[1]:
        assert C.equal(got, single)


def _pallas_case():
    """tests/test_sharded.py's Pallas inputs and digits (32 random points,
    scalar 0 at 0, point 2 = point 1)."""
    C = WeierstrassCurve(J_PALLAS)
    rng = random.Random(0xC0FFEE)
    pts = C.random_points(N, rng)
    sc = [rng.randrange(J_PALLAS.order) for _ in range(N)]
    sc[0] = 0
    pts[2] = pts[1]
    return C, pts, sc, JaxMsm(J_PALLAS).digits(sc, C_WIN)


def test_msm_sharded_projective_pallas_8dev():
    C, pts, sc, digits = _pallas_case()
    ctx = WeierstrassMsm(PALLAS, device="cpu")
    mesh = cpu_mesh(8)
    P, d = shard_points(ctx.adapter.from_points(ctx.affine_to_device(pts)),
                        torch.from_numpy(np.asarray(digits, dtype=np.int32)), mesh)
    got = ctx.proj.to_host(msm_sharded(ctx.adapter, P, d, C_WIN, mesh))[0]
    assert C.equal(got, oracle_msm(C, sc, pts))


@pytest.mark.slow
def test_msm_sharded_matches_jax_2dev():
    """The JAX package's msm_sharded on the same inputs at D = 2 (its
    shard_map compile takes minutes here)."""
    from montgomery_tpu.ops import kernels as jkernels
    from montgomery_tpu.parallel import make_mesh as jax_mesh
    from montgomery_tpu.parallel import msm_sharded as jax_msm_sharded
    from montgomery_tpu.parallel import shard_points as jax_shard

    C, pts, sc, digits = _pallas_case()
    jctx = JaxMsm(J_PALLAS)
    jm = jax_mesh(2)
    A, d = jax_shard(jctx.adapter.from_points(jctx.proj.affine_to_device(pts)), jnp.asarray(digits), jm)
    with jkernels.force_pallas(True, callback=True):
        want = jctx.proj.to_host(jax.jit(lambda a, dg: jax_msm_sharded(jctx.adapter, a, dg, C_WIN, jm))(A, d))[0]
    ctx = WeierstrassMsm(PALLAS, device="cpu")
    mesh = cpu_mesh(2)
    P, dd = shard_points(ctx.adapter.from_points(ctx.affine_to_device(pts)),
                         torch.from_numpy(np.asarray(digits, dtype=np.int32)), mesh)
    got = ctx.proj.to_host(msm_sharded(ctx.adapter, P, dd, C_WIN, mesh))[0]
    assert C.equal(got, want) and C.equal(got, oracle_msm(C, sc, pts))


def test_msm_sharded_edwards_2dev():
    """tests/test_sharded.py's Twisted Edwards case: 62-bit scalars (64-bit
    digits), scalar 0 at 0, point 9 = point 1 with the same scalar; the
    packed accumulation and the reduction both in extended coordinates."""
    E = TwistedEdwardsCurve(J_ED)
    rng = random.Random(0xC0FFEE)
    pts = [E.scale(rng.randrange(1, 1 << 62), E.generator) for _ in range(N)]
    sc = [rng.randrange(1 << 62) for _ in range(N)]
    sc[0] = 0
    pts[9] = pts[1]
    sc[9] = sc[1]
    te = EdwardsMsm(ED_ON_BLS12_377, device="cpu")
    digits = signed_digits_device(te.scalars_to_limbs(sc), SCALAR_W, 64, C_WIN)
    mesh = cpu_mesh(2)
    P, d = shard_points(te.to_device(pts), digits, mesh)
    got = te.ed.to_host(msm_sharded(te.adapter, P, d, C_WIN, mesh))[0]
    assert E.equal(got, oracle_msm(E, sc, pts))


def test_butterfly_allreduce_and_reduce_scatter(bls):
    """Four shards' (n, 4, 2) grids of random points: the all-reduce leaves
    every shard the lane-wise sum of all four, the reduce-scatter leaves
    shard d window d of it (the halves it keeps follow bit (d // s) % 2)."""
    C, ctx = bls["C"], bls["ctx"]
    pts = bls["distinct"][0]
    mesh = cpu_mesh(4)
    grids = []
    for d in range(4):
        A = ctx.affine_to_device([pts[(5 * d + j) % N] for j in range(8)])
        grids.append(type(ctx.proj.from_affine(A))(*[a.reshape(ctx.fops.n, 4, 2)
                                                      for a in ctx.proj.from_affine(A)]))

    def host(P):
        return ctx.proj.to_host(type(P)(*[a.reshape(ctx.fops.n, -1) for a in P]))

    want = [pts[(5 * 0 + j) % N] for j in range(8)]
    for d in range(1, 4):
        want = [C.add(w, pts[(5 * d + j) % N]) for j, w in enumerate(want)]
    for G in sharded._butterfly_allreduce(ctx.adapter, grids, mesh):
        assert all(C.equal(g, w) for g, w in zip(host(G), want))
    for d, G in enumerate(sharded._butterfly_reduce_scatter(ctx.adapter, grids, mesh, 4)):
        assert all(C.equal(g, w) for g, w in zip(host(G), want[2 * d:2 * d + 2]))


@pytest.mark.parametrize("case", ["ragged", "three", "unsharded", "no_card"])
def test_bad_meshes_raise(bls, case):
    ctx = bls["ctx"]
    pts, sc, _ = bls["distinct"]
    A, L = ctx.affine_to_device(pts[:6]), ctx.scalars_to_limbs(sc[:6])
    if case == "ragged":  # 6 points over 4 shards
        with pytest.raises(ValueError, match="equal shards"):
            shard_points(A, L, cpu_mesh(4))
    elif case == "three":
        mesh = cpu_mesh(3)
        with pytest.raises(ValueError, match="power of two"):
            shard_points(A, L, mesh)
        with pytest.raises(ValueError, match="power of two"):
            msm_full_sharded(ctx, [A] * 3, [L] * 3, C_WIN, mesh)
    elif case == "unsharded":  # one batch where the shards' list belongs
        with pytest.raises(ValueError, match="per shard"):
            msm_full_sharded(ctx, A, L, C_WIN, cpu_mesh(2))
    else:
        with pytest.raises(ValueError, match="2 given"):
            make_mesh(4, devices=["cpu"] * 2)
        if not torch.cuda.is_available():  # no CUDA mesh without cards, no CPU fallback
            with pytest.raises(RuntimeError, match="CUDA devices"):
                make_mesh(2)


def test_each_shard_runs_on_its_own_device(bls, monkeypatch):
    """A mesh over two CUDA devices, faked on the CPU: every copy goes to the
    shard it is for (shard d's points and scalars to device d, a butterfly
    half to the partner, the window sums to device 0), and each shard's
    accumulation, butterfly add and window sums run in its device's scope,
    the combine in device 0's (so each shard's launches reach its own card);
    the sum still equals the oracle's."""
    C, ctx = bls["C"], bls["ctx"]
    pts, sc, want = bls["hazards"]
    scope, copies, ran = [], [], []

    @contextlib.contextmanager
    def fake_device(dev):
        scope.append(torch.device(dev))
        yield
        scope.pop()

    def fake_to(P, dev):  # the tensors stay on the CPU
        copies.append(str(dev))
        return P

    def recorded(name, fn):
        def run(*a, **k):
            ran.append((name, str(scope[-1]) if scope else None))
            return fn(*a, **k)
        return run

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(sharded, "_to", fake_to)
    for name in ("bucket_accumulate", "window_sums", "combine_windows"):
        monkeypatch.setattr(sharded, name, recorded(name, getattr(sharded, name)))
    monkeypatch.setattr(ctx.adapter, "add", recorded("add", ctx.adapter.add))
    mesh = make_mesh(devices=["cuda:0", "cuda:1"])
    A, L = shard_points(ctx.affine_to_device(pts), ctx.scalars_to_limbs(sc), mesh)
    assert copies == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    copies.clear()
    S = msm_full_sharded(ctx, A, L, C_WIN, mesh, affine=False)
    # the butterfly's one step: shard 1's half to cuda:0, shard 0's to cuda:1;
    # then both shards' window sums to cuda:0
    assert copies == ["cuda:0", "cuda:1", "cuda:0", "cuda:0"]
    stages = [(n, d) for n, d in ran if n != "add"]
    assert stages == [("bucket_accumulate", "cuda:0"), ("bucket_accumulate", "cuda:1"),
                      ("window_sums", "cuda:0"), ("window_sums", "cuda:1"),
                      ("combine_windows", "cuda:0")]
    # the butterfly's adds, one a shard, just before the first window sums;
    # every other add in the scope of the stage that makes it
    i = ran.index(("window_sums", "cuda:0"))
    assert ran[i - 2:i] == [("add", "cuda:0"), ("add", "cuda:1")]
    stage = None
    for j, (n, d) in enumerate(ran):
        if n != "add":
            stage = d
        elif j not in (i - 2, i - 1):
            assert d == stage, (j, n, d)
    assert C.equal(ctx.proj.to_host(S)[0], want)
