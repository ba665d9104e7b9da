"""montgomery_tpu_torch planar batched-affine adds (AffineOps.batch_add,
batch_add_unsafe, batch_double) and AffineAccumAdapter's planar members.

The same inputs, made by the JAX package and carried across with
`montgomery_tpu_torch.interop`, go through the JAX package's AffineOps (one
jitted program per case, in the suite's callback kernel mode) and through the
port; both are compared with the bigint oracle as canonical affine points,
tolerance zero. Cases: the lanes of tests/test_curve_ops.py
(test_batch_affine_add: P + Q, P + P, P + (-P), each operand infinite, both
infinite) on Pallas and BLS12-377, with the order-2 point T = (p - 1, 0) of
BLS12-377 added (T + T hits y = 0) and the port also fed unreduced
representatives [p, 2p) of the same operands; the 640-lane grids of
tests/test_grid_combine.py (wider than the 512-lane batch-inversion stop: the
safe add, and the masked unsafe add with the hazard lanes excluded and passed
through), also as a batch shape (n, 5, 128); the adapter's members against
the JAX adapter's. Port tensors live on the CPU, so the kernels' plain
versions run; a fake library checks what each wrapper would hand its kernel.
"""

import contextlib
import functools
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377 as J_BLS12_377
from montgomery_tpu.concrete import PALLAS as J_PALLAS
from montgomery_tpu.msm import WeierstrassMsm as JaxMsm
from montgomery_tpu.msm.adapters import AffineAccumAdapter as JaxAffineAdapter
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.concrete import BLS12_377, PALLAS
from montgomery_tpu_torch.curves.projective import AffineBatch
from montgomery_tpu_torch.msm import WeierstrassMsm
from montgomery_tpu_torch.ops import kernels

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

CURVES = {"pallas": (PALLAS, J_PALLAS), "bls12-377": (BLS12_377, J_BLS12_377)}
GRID_W = 640  # > FieldOps.BATCH_INV_STOP = 512: the inversion tree folds
PLANAR = ("aff_pre", "aff_post", "aff_pre_unsafe", "aff_post_unsafe")


def _key(P):
    return None if P.is_zero else (P.x, P.y)


def _keys(points):
    return [_key(P) for P in points]


def _port(ctx, JA, lo=0, hi=None) -> AffineBatch:
    """Lanes [lo, hi) of a JAX batch as a port batch on the CPU."""
    x, y, inf = (np.ascontiguousarray(np.asarray(a)[..., lo:hi]) for a in (JA.x, JA.y, JA.inf))
    return interop.affine_from_jax(x, y, inf, ctx.fops, device="cpu")


def _host(ctx, A: AffineBatch):
    flat = AffineBatch(A.x.reshape(A.x.shape[0], -1), A.y.reshape(A.y.shape[0], -1), A.inf.reshape(-1))
    return ctx.proj.affine_to_host(flat)


def _unreduced(ctx, A: AffineBatch) -> AffineBatch:
    """The same points with every coordinate as its representative v + p."""
    f = ctx.fops
    x, y = (f.pack_raw([v + f.p for v in f.unpack(a)], "cpu") for a in (A.x, A.y))
    return AffineBatch(x, y, A.inf)


# ------------------------------------------------- the JAX package's runs


@functools.cache
def _contexts(curve):
    """The port's CPU context and the JAX package's context of one curve."""
    params, jparams = CURVES[curve]
    return WeierstrassMsm(params, device="cpu"), JaxMsm(jparams)


def _grid_points(C):
    """test_grid_combine's 640-lane grid: empty + empty, empty + P, P +
    empty, P + P, two cancellations, then generic pairs; the validity mask
    that excludes the six hazard lanes."""
    rng = random.Random(0xC0FFEE)
    zero = AffinePoint.zero()
    base = [C.scale(rng.randrange(1, 1 << 62), C.generator) for _ in range(8)]
    g = [zero, zero, base[1], base[2], base[3], base[4]]
    h = [zero, base[0], zero, base[2], C.neg(base[3]), C.neg(base[4])]
    while len(g) < GRID_W:
        s = rng.randrange(1, 1 << 30)
        g.append(C.scale(s, base[len(g) % 8]))
        h.append(C.scale(s + 1, base[(len(g) + 3) % 8]))
    valid = np.ones(GRID_W, dtype=bool)
    valid[:6] = False
    return g, h, valid


@functools.cache
def _curve_case(curve):
    """test_batch_affine_add's lanes on one curve (plus T + T and T + Q on
    BLS12-377), the generic lanes of its unsafe add with one excluded
    doubling lane, and on BLS12-377 the grid; the JAX package's outputs of
    all of them in ONE jitted program per curve (the grid's lanes follow the
    test lanes in the safe and in the masked unsafe add)."""
    params, jparams = CURVES[curve]
    C = WeierstrassCurve(jparams)
    rng = random.Random(0xC0FFEE)
    pts = C.random_points(8, rng)
    P, Q, R, S = pts[:4]
    Z0 = AffinePoint.zero()
    lhs = [P, Q, P, P, Z0, P, Z0, R]
    rhs = [Q, R, P, C.neg(P), Q, Z0, Z0, S]
    g, h, gvalid = [], [], np.ones(0, dtype=bool)
    if params is BLS12_377:
        T = AffinePoint(jparams.modulus - 1, 0)
        lhs, rhs = lhs + [T, T, Q], rhs + [T, Q, T]
        g, h, gvalid = _grid_points(C)
    # unsafe lanes: distinct finite points, and one doubling lane excluded
    ulhs, urhs = pts[:4] + [P], pts[4:8] + [P]
    valid = np.array([True, True, True, True, False])
    ctx, jctx = _contexts(curve)
    jaff = jctx.affine
    G, UG, UH, SG, SH, MG, MH = (jctx.proj.affine_to_device(v)
                                 for v in (lhs, ulhs, urhs, lhs + g, rhs + h, ulhs + g, urhs + h))
    vm = jnp.asarray(np.concatenate([valid, gvalid]))

    def ops(G, UG, UH, SG, SH, MG, MH, vm):
        masked = jaff.batch_add_unsafe(MG, MH, valid=vm)
        return (jaff.batch_add(SG, SH), jaff.batch_double(G), jaff.batch_add_unsafe(UG, UH),
                jaff.select(vm, masked, MG), masked)

    out = [_keys(jctx.proj.affine_to_host(o)) for o in jax.jit(ops)(G, UG, UH, SG, SH, MG, MH, vm)]
    nl, nu = len(lhs), len(ulhs)
    safe, dbl, unsafe, passed, masked = out
    case = dict(C=C, ctx=ctx, lhs=lhs, rhs=rhs, ulhs=ulhs, urhs=urhs, valid=valid,
                G=_port(ctx, G), H=_port(ctx, SH, 0, nl), UG=_port(ctx, UG), UH=_port(ctx, UH),
                jout=[safe[:nl], dbl, unsafe, passed[:nu], masked[:nu]])
    if g:
        sums = _keys([C.add(a, b) for a, b in zip(g, h)])
        case["grid"] = dict(ctx=ctx, G=_port(ctx, SG, nl, None), H=_port(ctx, SH, nl, None),
                            valid=gvalid, sums=sums,
                            passed=[s if v else _key(a) for s, v, a in zip(sums, gvalid, g)],
                            jsafe=safe[nl:], jmasked=passed[nu:])
    return case


# ------------------------------------------------- lanes of test_curve_ops


@pytest.fixture(params=list(CURVES))
def lanes_case(request):
    return _curve_case(request.param)


def test_batch_add_matches_jax_and_oracle(lanes_case):
    k = lanes_case
    C, ctx, aff = k["C"], k["ctx"], k["ctx"].affine
    want = _keys([C.add(a, b) for a, b in zip(k["lhs"], k["rhs"])])
    before = kernels.launch_counts()
    got = _keys(_host(ctx, aff.batch_add(k["G"], k["H"])))
    assert got == want and k["jout"][0] == want
    # unreduced representatives [p, 2p) of the same operands: same sums
    G2, H2 = _unreduced(ctx, k["G"]), _unreduced(ctx, k["H"])
    assert _keys(_host(ctx, aff.batch_add(G2, H2))) == want
    # the adapter's add is the safe add (the JAX adapter's is AffineOps.batch_add)
    assert _keys(_host(ctx, ctx.aff_adapter.add(k["G"], k["H"]))) == k["jout"][0]
    # CPU tensors take the plain versions: no kernel launched
    assert {n: kernels.launch_counts()[n] for n in PLANAR} == {n: before[n] for n in PLANAR}


def test_batch_double_matches_jax_and_oracle(lanes_case):
    k = lanes_case
    C, ctx = k["C"], k["ctx"]
    want = _keys([C.double(a) for a in k["lhs"]])
    assert _keys(_host(ctx, ctx.affine.batch_double(k["G"]))) == want == k["jout"][1]


def test_batch_add_unsafe_matches_jax_and_oracle(lanes_case):
    k = lanes_case
    C, ctx, aff = k["C"], k["ctx"], k["ctx"].affine
    UG, UH, valid = k["UG"], k["UH"], k["valid"]
    sums = _keys([C.add(a, b) for a, b in zip(k["ulhs"], k["urhs"])])
    n = len(valid) - 1
    plain = aff.batch_add_unsafe(AffineBatch(*[a[..., :n] for a in UG]),
                                 AffineBatch(*[a[..., :n] for a in UH]))
    assert not plain.inf.any()
    assert _keys(_host(ctx, plain)) == sums[:n] == k["jout"][2][:n]
    vm = torch.from_numpy(valid)
    passed = _keys(_host(ctx, aff.select(vm, aff.batch_add_unsafe(UG, UH, valid=vm), UG)))
    want = [s if v else _key(a) for s, v, a in zip(sums, valid, k["ulhs"])]
    assert passed == want == k["jout"][3]
    # the unsafe adapter's add with the same mask (the JAX adapter's is
    # batch_add_unsafe(valid=...)): the valid lanes' sums
    via_adapter = _keys(_host(ctx, ctx.aff_adapter_unsafe.add(UG, UH, valid=vm)))
    assert [g for g, v in zip(via_adapter, valid) if v] == sums[:n]
    assert [g for g, v in zip(k["jout"][4], valid) if v] == sums[:n]


# ------------------------------------------------- grids of test_grid_combine


@pytest.fixture
def grid_case():
    """test_grid_combine's two 640-lane grids and the JAX package's safe
    and masked-unsafe adds of them (from BLS12-377's one JAX program)."""
    return _curve_case("bls12-377")["grid"]


@pytest.mark.parametrize("batch", [(GRID_W,), (5, 128)], ids=["flat", "grid"])
def test_grid_combine_safe_wide(grid_case, batch):
    """The safe add above the 512-lane inversion stop: the edge lanes'
    denominators must not poison the tree for the generic lanes."""
    k = grid_case
    ctx = k["ctx"]
    G, H = (AffineBatch(a.x.reshape(-1, *batch), a.y.reshape(-1, *batch), a.inf.reshape(batch))
            for a in (k["G"], k["H"]))
    out = ctx.affine.batch_add(G, H)
    assert out.x.shape == G.x.shape and out.inf.shape == batch
    assert _keys(_host(ctx, out)) == k["sums"] == k["jsafe"]


@pytest.mark.parametrize("batch", [(GRID_W,), (5, 128)], ids=["flat", "grid"])
def test_grid_combine_masked_unsafe(grid_case, batch):
    """The masked unsafe add with the hazard lanes excluded, then the
    pass-through select of the pair-halving engine."""
    k = grid_case
    ctx, aff = k["ctx"], k["ctx"].affine
    G, H = (AffineBatch(a.x.reshape(-1, *batch), a.y.reshape(-1, *batch), a.inf.reshape(batch))
            for a in (k["G"], k["H"]))
    vm = torch.from_numpy(k["valid"]).reshape(batch)
    out = aff.select(vm, aff.batch_add_unsafe(G, H, valid=vm), G)
    assert out.x.shape == G.x.shape and out.inf.shape == batch
    assert _keys(_host(ctx, out)) == k["passed"] == k["jmasked"]


@pytest.fixture(scope="module")
def small():
    """The port's BLS12-377 context and 80 random points (oracle and port
    batch): inputs of the tests that need no JAX program."""
    C = WeierstrassCurve(J_BLS12_377)
    pts = C.random_points(80, random.Random(7))
    ctx = _contexts("bls12-377")[0]
    return ctx, pts, ctx.affine_to_device(pts)


def test_batch_add_rejects_mismatched_shapes(small):
    ctx, _, A = small
    aff = ctx.affine
    G, H = (AffineBatch(*[a[..., s] for a in A]) for s in (slice(0, 40), slice(40, 80)))
    short = AffineBatch(*[a[..., :-1] for a in H])
    with pytest.raises(ValueError, match="different shapes"):
        aff.batch_add(G, short)
    with pytest.raises(ValueError, match="different shapes"):
        aff.batch_add_unsafe(G, short)


@pytest.mark.parametrize("case", ["valid_shape", "valid_dtype", "inf_shape", "inf_dtype"])
def test_masks_are_checked(small, case):
    """A mask the kernels would misread raises on every device: a validity
    mask of another batch shape (a (L,) mask for a (K, L) grid), an int32
    mask (read byte by byte it would disagree with the plain version), an
    infinity mask of the wrong length or dtype."""
    ctx, _, A = small
    aff = ctx.affine
    G, H = (AffineBatch(*[a[..., s] for a in A]) for s in (slice(0, 40), slice(40, 80)))
    if case == "valid_shape":
        grid = [AffineBatch(B.x.reshape(-1, 4, 10), B.y.reshape(-1, 4, 10), B.inf.reshape(4, 10)) for B in (G, H)]
        with pytest.raises(ValueError, match="validity mask"):
            aff.batch_add_unsafe(*grid, valid=torch.ones(10, dtype=torch.bool))
        with pytest.raises(ValueError, match="bool"):
            aff.pre_unsafe(G.x, H.x, torch.ones(39, dtype=torch.bool))
    elif case == "valid_dtype":
        with pytest.raises(ValueError, match="bool"):
            aff.pre_unsafe(G.x, H.x, torch.ones(40, dtype=torch.int32))
    else:
        bad = G.inf[:-1] if case == "inf_shape" else G.inf.to(torch.int32)
        Gb = AffineBatch(G.x, G.y, bad)
        with pytest.raises(ValueError, match="bool"):
            aff.pre(Gb, H)
        denom, numer, flags = aff.pre(G, H)
        with pytest.raises(ValueError, match="bool"):
            aff.post(Gb, H, denom, numer, flags)


# ---------------------------------------------------------- adapter members


def test_adapter_members_match_jax(small):
    """zero_like, from_points, select, gather and neg_where of
    AffineAccumAdapter against the JAX adapter's on the same points (one
    lane of G at infinity)."""
    ctx, pts, _ = small
    jctx = _contexts("bls12-377")[1]
    jad = JaxAffineAdapter(jctx.affine, jctx.proj)
    ad = ctx.aff_adapter
    m = 16
    g, h = [AffinePoint.zero()] + pts[1:m], pts[m:2 * m]
    JG, JH = (jctx.proj.affine_to_device(v) for v in (g, h))
    G, H = _port(ctx, JG), _port(ctx, JH)
    mask = np.arange(m) % 3 == 1
    idx = np.array([5, 0, 15, 3, 3, 9])

    def both(port_out, jax_out):
        assert _keys(_host(ctx, port_out)) == _keys(jctx.proj.affine_to_host(jax_out))

    z = ad.zero_like((2, 3), "cpu")
    jz = jad.zero_like((2, 3))
    assert tuple(z.x.shape[1:]) == np.asarray(jz.x).shape[1:] == (2, 3) and z.inf.shape == (2, 3)
    assert bool(z.inf.all()) and bool(np.asarray(jz.inf).all())
    assert ad.from_points(G) is G
    tm = torch.from_numpy(mask)
    both(ad.select(tm, G, H), jad.select(jnp.asarray(mask), JG, JH))
    both(ad.gather(G, torch.from_numpy(idx)), jad.gather(JG, jnp.asarray(idx)))
    both(ad.neg_where(G, tm), jad.neg_where(JG, jnp.asarray(mask)))
    both(ctx.affine.neg(G), jctx.affine.neg(JG))
    assert _keys(_host(ctx, ctx.affine.zero(4, "cpu"))) == [None] * 4


# ------------------------------------------------- what a kernel is handed


def test_wrappers_hand_their_kernels_every_argument(monkeypatch, small):
    """Each planar wrapper on tensors it takes for the card's: one argument
    per C parameter plus the stream, planes by pointer with their row
    strides (a column slice keeps its parent's), the masks as bool bytes,
    and a null validity pointer when no mask is given (checked without a
    card: a fake library and a stand-in for the device test)."""
    seen = {}

    def entry(name):
        def fn(*args):
            seen.setdefault(name, []).append(args)
            return 0
        return fn

    lib = types.SimpleNamespace(**{f"msm_{n}": entry(n) for n in PLANAR})
    monkeypatch.setattr(kernels.LIBRARY, "get", lambda: lib)
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    for n in PLANAR:
        k = kernels.REGISTRY[n]
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    ctx, _, A = small
    aff = ctx.affine
    G = AffineBatch(*[a[..., 3:67] for a in A])  # column slices of 80-lane planes
    H = AffineBatch(*[a[..., 16:80] for a in A])
    M, W = 64, 160  # affine_to_device's x and y are halves of one (n, 160) plane
    denom, numer, flags = aff.pre(G, H)
    aff.post(G, H, denom, numer, flags)
    aff.pre_unsafe(G.x, H.x)
    aff.pre_unsafe(G.x, H.x, G.inf)
    aff.post_unsafe(G, H, denom)
    for n in PLANAR:
        assert kernels.REGISTRY[n].launches == len(seen[n])
        for args in seen[n]:
            assert len(args) == len(kernels.REGISTRY[n].argtypes) + 1 and args[-1] == 7
            assert args[-2] == M
    pre, = seen["aff_pre"]
    assert [pre[i] for i in (4, 6, 8, 10)] == [W, W, W, W]  # the parents' row strides
    assert pre[3].value == G.x.data_ptr() and pre[7].value == H.x.data_ptr()
    post, = seen["aff_post"]
    assert [post[i] for i in (4, 6, 8, 10, 12, 14)] == [W, W, W, W, M, M]
    nomask, masked = seen["aff_pre_unsafe"]
    assert nomask[5] is None and masked[5].value == G.inf.data_ptr()
    assert G.inf.dtype == torch.bool  # read as bytes, no conversion
