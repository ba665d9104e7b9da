"""montgomery_tpu_torch window combine against montgomery_tpu.

`ProjectiveOps.combine` (on CPU tensors its plain Horner: `double_n_plain`
and `add_plain` in the kernel's order) against the JAX package's log-depth
`combine_windows` and the bigint oracle, with identity windows among the
sums; `reduce_buckets` end to end against the JAX package's; and, with a
fake library and recorders in place of the card, which body of
`proj_dbl_rcb` a launch of N lanes takes and what `proj_combine_rcb` is
given, and which body of `proj_add_rcb` an add of N lanes takes. The two
combines give other projective coordinates, so results are
compared as affine points (tolerance zero). The JAX side runs jitted, in one
program, in the suite's callback kernel mode; inputs come from numpy seeds.
"""

import contextlib
import types

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu.curves.projective import ProjectiveBatch as JProjectiveBatch
from montgomery_tpu.curves.projective import ProjectiveOps as JProjectiveOps
from montgomery_tpu.msm import pippenger as jpippenger
from montgomery_tpu.msm.adapters import ProjectiveAdapter as JProjectiveAdapter
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.curves import projective
from montgomery_tpu_torch.curves.projective import ProjectiveBatch, ProjectiveOps
from montgomery_tpu_torch.msm import pippenger
from montgomery_tpu_torch.msm.adapters import ProjectiveAdapter
from montgomery_tpu_torch.ops import kernels
from montgomery_tpu_torch.ops.field import create_field_ops
from montgomery_tpu_torch.ops.limbs import to_words

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
    return jf, jproj, f, proj, WeierstrassCurve(BLS12_377)


def _points(E, rng, count: int, ident) -> list:
    G = E.generator
    return [AffinePoint.zero() if i in ident else E.scale(int(k), G)
            for i, k in enumerate(rng.integers(1, 1 << 62, size=count))]


def _both(jf, f, pts, rng, shape):
    """The points with random Z as JAX planes and as the port's CPU planes,
    each reshaped to (n, *shape); the identity is (0 : 1 : 0)."""
    rj = 1 << (W_JAX * jf.n)
    cols = [[], [], []]
    for pt, z in zip(pts, rng.integers(1, 1 << 62, size=len(pts))):
        X, Y, Z = (0, 1, 0) if pt.is_zero else (pt.x * int(z) % P, pt.y * int(z) % P, int(z))
        for c, v in zip(cols, (X, Y, Z)):
            c.append(v * rj % P)
    J = JProjectiveBatch(*[jcodec.pack(c, jf.mp).reshape(jf.n, *shape) for c in cols])
    T = interop.projective_from_jax(*[np.asarray(a).reshape(jf.n, -1) for a in J], f, device="cpu")
    return J, ProjectiveBatch(*[a.reshape(f.n, *shape) for a in T])


def _oracle_combine(E, W, c):
    acc = AffinePoint.zero()
    for k, pt in enumerate(W):
        acc = E.add(acc, E.scale(1 << (c * k), pt))
    return acc


# (K, c, identity windows) of the combine cases; c is small so that the
# JAX side's doublings come in few distinct counts (2, 4, 8: one callback
# executable each)
COMBINE_CASES = [(1, 2, ()), (2, 2, (1,)), (3, 2, (0,)), (10, 1, (0, 4, 9)), (12, 1, (5, 11))]
# reduce_buckets: K windows of L = 2^(c-1) buckets, empty ones among them
# (L = 2: the window sums need no doubling, so the JAX side compiles no
# formula beyond the combine's)
RK, RC, R_EMPTY = 3, 2, (0, 3)


@pytest.fixture(scope="module")
def cases(ctx):
    """key -> (c, oracle points, JAX planes, port planes) of every combine
    case (key K) and of the reduce_buckets case (key "reduce")."""
    jf, _, f, _, E = ctx
    out = {}
    for K, c, ident in COMBINE_CASES:
        rng = np.random.default_rng(100 + K)
        pts = _points(E, rng, K, ident)
        out[K] = (c, pts, *_both(jf, f, pts, rng, (K,)))
    rng = np.random.default_rng(5)
    L = 1 << (RC - 1)
    pts = _points(E, rng, RK * L, R_EMPTY)
    out["reduce"] = (RC, pts, *_both(jf, f, pts, rng, (RK, L)))
    return out


def _jax_results(jproj, cases):
    """The JAX package's combine_windows of every combine case and its
    reduce_buckets, in one jitted program (one compile of each formula)."""
    group = JProjectiveAdapter(jproj)

    def run(ws, B):
        combined = [jpippenger.combine_windows(group, W, cases[K][0], K)
                    for (K, _, _), W in zip(COMBINE_CASES, ws)]
        return combined, jpippenger.reduce_buckets(group, B, RC, RK, 1 << (RC - 1))

    combined, reduced = jax.jit(run)([cases[K][2] for K, _, _ in COMBINE_CASES], cases["reduce"][2])
    return {**{K: combined[i] for i, (K, _, _) in enumerate(COMBINE_CASES)}, "reduce": reduced}


def _from_jax(f, J):
    return interop.projective_from_jax(*[np.asarray(a).reshape(a.shape[0], -1) for a in J], f,
                                       device="cpu")


@pytest.mark.parametrize("K", [K for K, _, _ in COMBINE_CASES])
def test_combine_matches_oracle(ctx, cases, K):
    """The Horner combine (plain) equals sum_k 2^(ck) W_k by the oracle,
    the halving combine and, bit for bit, `combine_plain`."""
    _, _, f, proj, E = ctx
    c, pts, _, W = cases[K]
    got = proj.combine(W, c)
    assert got.X.shape == (f.n, 1)
    want = _oracle_combine(E, pts, c)
    assert E.equal(proj.to_host(got)[0], want)
    assert all(torch.equal(a, b) for a, b in zip(got, proj.combine_plain(W, c)))
    half = pippenger.combine_halving(ProjectiveAdapter(proj), W, c, K)
    assert E.equal(proj.to_host(half)[0], want)


def test_combine_and_reduce_match_jax(ctx, cases):
    """The port's combine and the JAX package's combine_windows give the
    same points for every case, and so do the two reduce_buckets (the only
    test of this file that runs the JAX package)."""
    _, jproj, f, proj, E = ctx
    jres = _jax_results(jproj, cases)
    for K, _, _ in COMBINE_CASES:
        c, pts, _, W = cases[K]
        got = proj.to_host(proj.combine(W, c))[0]
        assert E.equal(got, proj.to_host(_from_jax(f, jres[K]))[0]), K
        assert E.equal(got, _oracle_combine(E, pts, c)), K
    c, _, _, B = cases["reduce"]
    got = pippenger.reduce_buckets(ProjectiveAdapter(proj), B, c, RK, 1 << (c - 1))
    assert E.equal(proj.to_host(got)[0], proj.to_host(_from_jax(f, jres["reduce"]))[0])


def test_combine_batches_and_adapter(ctx):
    """Planes (n, B, K) combine B lanes at once; the adapter and
    `combine_windows` route the complete projective group to it."""
    jf, _, f, proj, E = ctx
    rng = np.random.default_rng(7)
    B, K, c = 3, 4, 2
    pts = _points(E, rng, B * K, (2, 7))
    _, W = _both(jf, f, pts, rng, (B, K))
    got = proj.combine(W, c)
    assert got.X.shape == (f.n, B, 1)
    hosted = proj.to_host(ProjectiveBatch(*[a.reshape(f.n, B) for a in got]))
    for b in range(B):
        assert E.equal(hosted[b], _oracle_combine(E, pts[b * K:(b + 1) * K], c))
    flat = ProjectiveBatch(*[a[:, 0] for a in W])
    via = pippenger.combine_windows(ProjectiveAdapter(proj), flat, c, K)
    assert all(torch.equal(a, b) for a, b in zip(via, proj.combine(flat, c)))
    with pytest.raises(ValueError):
        proj.combine(flat, 0)


def test_reduce_buckets_matches_oracle(ctx, cases):
    """Bucket reduction and window combine end to end (K = 3 windows of
    L = 2 buckets, c = 2, empty buckets among them) against the oracle
    sum_k 2^(ck) sum_j (j+1) B_kj."""
    _, _, f, proj, E = ctx
    c, pts, _, B = cases["reduce"]
    L = 1 << (c - 1)
    got = pippenger.reduce_buckets(ProjectiveAdapter(proj), B, c, RK, L)
    want = AffinePoint.zero()
    for k in range(RK):
        for j in range(L):
            want = E.add(want, E.scale((j + 1) << (c * k), pts[k * L + j]))
    assert E.equal(proj.to_host(got)[0], want)


@pytest.fixture
def recorded(monkeypatch):
    """Launches reach a fake library (no card): every kernel wrapper takes
    its kernel path on CPU tensors, and the fake entries record their
    arguments."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    lib = types.SimpleNamespace(msm_proj_dbl_rcb=entry("dbl"), msm_proj_combine_rcb=entry("combine"),
                                msm_proj_add_rcb=entry("add"))
    monkeypatch.setattr(kernels.LIBRARY, "get", lambda: lib)
    monkeypatch.setattr(kernels, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    for k in (projective.PROJ_DBL_RCB, projective.PROJ_COMBINE_RCB, projective.PROJ_ADD_RCB):
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    return calls


def test_double_n_body_by_lanes(ctx, recorded):
    """Below FEW_LANES lanes `double_n` asks for the few-lane body (one block
    a lane), from it on for the one-thread body: the main path's window-sum
    doublings (K = 10 lanes) take the first, the wide launches (the timed
    65,536-lane call, the cofactor scale's 2.6 M lanes) the second; `few`
    picks the body by name. One registry count either way."""
    _, _, f, proj, _ = ctx
    few = ProjectiveOps.FEW_LANES
    assert 10 < few <= 65536
    for N, want in ((1, 1), (10, 1), (few - 1, 1), (few, 0), (65536, 0)):
        z = torch.zeros((f.n, N), dtype=torch.int32)
        proj.double_n(ProjectiveBatch(z, z, z), 6)
        name, args = recorded[-1]
        assert name == "dbl" and args[6] == 6 and args[-3] == N and args[-2] == want, (N, args[-3:])
        assert args[-1] == 7  # the tensors' device's stream
    for N, few in ((10, False), (65536, True)):  # the body asked for by name
        z = torch.zeros((f.n, N), dtype=torch.int32)
        proj.double_n(ProjectiveBatch(z, z, z), 6, few=few)
        assert recorded[-1][1][-3:-1] == (N, int(few))
    assert projective.PROJ_DBL_RCB.launches == 7


def test_add_body_by_lanes(ctx, recorded):
    """Below FEW_ADD_LANES lanes `add` asks for the few-lane body (one block
    a lane), from it on for the six-threads-a-lane body: the main path's
    smallest window-sum levels (10 and 20 lanes) take the first, its wider
    levels (40 to 20,480 lanes) and the projective engine's rounds the
    second; `few` picks the body by name. Each launch carries 3b, mu =
    -p^-1 mod R (the warp product's) and the field words; one registry
    count a launch."""
    _, _, f, proj, _ = ctx
    few = ProjectiveOps.FEW_ADD_LANES
    assert 10 < few <= 40 < 2560
    mu = [w % (1 << 32) for w in to_words(-pow(P, -1, f.R) % f.R, f.n)]
    b3 = [w % (1 << 32) for w in to_words(proj.b3_mont, f.n)]
    cases = [(1, 1), (10, 1), (20, 1), (few - 1, 1), (few, 0), (640, 0), (20480, 0)]
    for N, want in cases:
        z = torch.zeros((f.n, N), dtype=torch.int32)
        proj.add(ProjectiveBatch(z, z, z), ProjectiveBatch(z, z, z))
        name, args = recorded[-1]
        assert name == "add" and args[-3] == N and args[-2] == want, (N, args[-3:])
        assert list(args[10]) == mu and list(args[9]) == b3
        assert args[-1] == 7  # the tensors' device's stream
    for N, body in ((10, False), (640, True)):  # the body asked for by name
        z = torch.zeros((f.n, N), dtype=torch.int32)
        proj.add(ProjectiveBatch(z, z, z), ProjectiveBatch(z, z, z), few=body)
        assert recorded[-1][1][-3:-1] == (N, int(body))
    assert projective.PROJ_ADD_RCB.launches == len(cases) + 2


def test_combine_launch_arguments(ctx, recorded):
    """One proj_combine_rcb launch a combine: the windows as (n, B K)
    planes, K and c, the constants, B lanes; planes (n, B, 1) back."""
    _, _, f, proj, _ = ctx
    z = torch.zeros((f.n, 2, 10), dtype=torch.int32)
    out = proj.combine(ProjectiveBatch(z, z, z), 13)
    assert out.X.shape == (f.n, 2, 1)
    name, args = recorded[-1]
    assert name == "combine" and args[6:8] == (10, 13) and args[-2] == 2
    assert projective.PROJ_COMBINE_RCB.launches == 1
