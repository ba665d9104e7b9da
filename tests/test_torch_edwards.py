"""montgomery_tpu_torch Twisted Edwards slice, module by module, against
montgomery_tpu.

ed-on-bls12-377's base field needs 9 limbs of 32 bits in the port (20 of 13
bits in the JAX package). Inputs are drawn from numpy with a fixed seed and
carried into both packages (`interop.edwards_from_jax`); results are compared
as canonical integers and affine points (tolerance zero). The JAX side of the
curve tests runs in one jitted program (the suite's callback kernel mode).
Port tensors live on the CPU, so the kernels' plain versions run; the launch
guard of the card is checked without a device.
"""

import contextlib
import dataclasses
import random
import types

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import TwistedEdwardsCurve
from montgomery_tpu.concrete import ED_ON_BLS12_377 as JAX_ED
from montgomery_tpu.curves.edwards import EdwardsBatch as JaxEdwardsBatch
from montgomery_tpu.curves.edwards import EdwardsOps as JaxEdwardsOps
from montgomery_tpu.msm.adapters import EdwardsAdapter as JaxEdwardsAdapter
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu.scalar.device import signed_digits_device as jax_signed_digits
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.concrete import ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.curves import affine, edwards, projective
from montgomery_tpu_torch.curves.edwards import EdwardsBatch, EdwardsOps
from montgomery_tpu_torch.curves.random import random_points_fast_edwards, table_bases, table_indices
from montgomery_tpu_torch.msm import WeierstrassMsm, api
from montgomery_tpu_torch.ops import alt_mul, divstep, kernels
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import MONT_MUL, MONT_SQR, MUL_CONST, create_field_ops
from montgomery_tpu_torch.ops.limbs import to_words
from montgomery_tpu_torch.scalar.device import ints_to_limbs_np, signed_digits_device

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = ED_ON_BLS12_377.modulus
Q = ED_ON_BLS12_377.order
W_JAX = 13

# twelve lanes of (A, B): ordinary, doubling, A + (-A), the identity on
# either side and both, and unreduced lanes; signs and pair flags mixed
CASES = ["ord", "dbl", "neg", "id_a", "id_b", "id_both", "ord", "dbl", "neg", "ord", "id_a", "ord"]
SA = [i % 2 for i in range(12)]
SB = [(i // 2) % 2 for i in range(12)]
HP = [0 if i in (4, 9, 11) else 1 for i in range(12)]
UNREDUCED = (6, 7)  # lanes whose port planes hold v + p for canonical v


@pytest.fixture(scope="module")
def ctx():
    f = create_field_ops(P)
    jf = jax_field_ops(P, w=W_JAX)
    ed, jed = EdwardsOps(f, ED_ON_BLS12_377), JaxEdwardsOps(jf, JAX_ED)
    E = TwistedEdwardsCurve(JAX_ED)
    rng = random.Random(7)
    pts = [E.random_point(rng) for _ in range(4)]
    Z0 = type(pts[0]).zero()
    A, B = [], []
    for i, case in enumerate(CASES):
        a, b = pts[i % 4], pts[(i + 1) % 4]
        b = {"dbl": a, "neg": E.neg(a), "id_b": Z0, "id_both": Z0}.get(case, b)
        a = Z0 if case in ("id_a", "id_both") else a
        A.append(a)
        B.append(b)
    return f, jf, ed, jed, E, A, B


def pt_xy(pt):
    return pt.x, pt.y


def _extended(jf, points, seed):
    """JAX Montgomery planes of (x z : y z : z : x y z), z random per lane."""
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(points)).tolist()
    rj = 1 << (W_JAX * jf.n)
    cols = [[pt.x * z % P, pt.y * z % P, z, pt.x * pt.y % P * z % P] for pt, z in zip(points, zs)]
    return [jcodec.pack([c[k] * rj % P for c in cols], jf.mp) for k in range(4)]


def _to_port(f, planes, unreduced=()):
    """JAX Montgomery planes -> the port's EdwardsBatch on the CPU, lanes in
    `unreduced` moved to the representative v + p."""
    X = interop.edwards_from_jax(*[np.asarray(a) for a in planes], f, device="cpu")
    if not unreduced:
        return X
    out = []
    for plane in X:
        vals = codec.unpack(plane)
        vals = [v + P if i in unreduced else v for i, v in enumerate(vals)]
        out.append(torch.from_numpy(codec.pack(vals, f.n)))
    return EdwardsBatch(*out)


def _affine(f, batch):
    """Canonical affine points of an EdwardsBatch, with T Z == X Y checked."""
    out = []
    for X, Y, Z, T in zip(*[f.unpack(a, from_mont=True) for a in batch]):
        assert T * Z % P == X * Y % P
        zi = pow(Z, -1, P)
        out.append((X * zi % P, Y * zi % P))
    return out


@pytest.fixture(scope="module")
def jax_side(ctx):
    """The JAX package's add, packed add, 13 doublings (EdwardsAdapter's
    fori_loop) and on-curve check on the tests' inputs, in one jitted
    program."""
    f, jf, ed, jed, E, A, B = ctx
    JA, JB = _extended(jf, A, 1), _extended(jf, B, 2)
    bad = list(JA)
    bad[1] = jcodec.pack([(v + 1) % P for v in interop.planes_to_ints(np.asarray(JA[1]), W_JAX)],
                         jf.mp)
    flags = [np.asarray([v], dtype=np.int32) for v in (SA, SB, HP)]

    def program(a, b, bad, sA, sB, hp):
        P_, Q_, Bad = JaxEdwardsBatch(*a), JaxEdwardsBatch(*b), JaxEdwardsBatch(*bad)
        packed = jed.unpack_rows(jed.add_packed(jed.pack_rows(P_), jed.pack_rows(Q_), sA, sB, hp))
        return (jed.add(P_, Q_), packed, JaxEdwardsAdapter(jed).double_n(P_, 13),
                jed.is_on_curve(P_), jed.is_on_curve(Bad))

    out = jax.jit(program)(JA, JB, bad, *flags)
    return {"JA": JA, "JB": JB, "bad": bad, "add": out[0], "packed": out[1], "dbl": out[2],
            "on_curve": np.asarray(out[3]), "bad_on_curve": np.asarray(out[4])}


def test_add_matches_jax(ctx, jax_side):
    f, jf, ed, _, E, A, B = ctx
    PA = _to_port(f, jax_side["JA"], UNREDUCED)
    PB = _to_port(f, jax_side["JB"], UNREDUCED)
    got = _affine(f, ed.add(PA, PB))
    via_jax = _affine(f, _to_port(f, jax_side["add"]))
    want = [pt_xy(E.add(a, b)) for a, b in zip(A, B)]
    assert got == via_jax == want
    # the planar add equals the packed one with no signs, all lanes paired
    n, z = f.n, torch.zeros((1, len(A)), dtype=torch.int32)
    packed = ed.add_packed(ed.pack_rows(PA), ed.pack_rows(PB), z, z, z + 1)
    assert _affine(f, ed.unpack_rows(packed)) == want


def test_add_packed_matches_jax(ctx, jax_side):
    f, jf, ed, _, E, A, B = ctx
    assert ed.packed_rows == 36 and f.n == 9
    PA = _to_port(f, jax_side["JA"], UNREDUCED)
    PB = _to_port(f, jax_side["JB"], UNREDUCED)
    rows = torch.cat([ed.pack_rows(PA), ed.pack_rows(PB)], dim=-1)  # one gathered array
    assert tuple(rows.shape) == (36, 2 * len(A))
    sA, sB, hp = (torch.tensor([v], dtype=torch.int32) for v in (SA, SB, HP))
    out = ed.add_packed(rows[:, :len(A)], rows[:, len(A):], sA, sB, hp)
    assert out.dtype == torch.int32 and tuple(out.shape) == (36, len(A))
    got = _affine(f, ed.unpack_rows(out))
    via_jax = _affine(f, _to_port(f, jax_side["packed"]))
    for i in range(len(A)):
        a = E.neg(A[i]) if SA[i] else A[i]
        b = E.neg(B[i]) if SB[i] else B[i]
        want = pt_xy(E.add(a, b) if HP[i] else a)
        assert got[i] == via_jax[i] == want, f"lane {i}"


def test_double_n_matches_jax(ctx, jax_side):
    f, jf, ed, _, E, A, _ = ctx
    PA = _to_port(f, jax_side["JA"], UNREDUCED)
    got = _affine(f, ed.double_n(PA, 13))
    via_jax = _affine(f, _to_port(f, jax_side["dbl"]))
    assert got == via_jax == [pt_xy(E.scale(1 << 13, a)) for a in A]
    assert _affine(f, ed.double(PA)) == _affine(f, ed.add(PA, PA)) == [pt_xy(E.double(a)) for a in A]
    assert ed.double_n(PA, 0) is PA


def test_is_on_curve_matches_jax(ctx, jax_side):
    f, jf, ed, _, _, A, _ = ctx
    PA = _to_port(f, jax_side["JA"], UNREDUCED)
    assert ed.is_on_curve(PA).tolist() == jax_side["on_curve"].tolist() == [True] * len(A)
    bad = ed.is_on_curve(_to_port(f, jax_side["bad"])).tolist()
    assert bad == jax_side["bad_on_curve"].tolist() == [False] * len(A)
    assert ed.is_zero(PA).tolist() == [a.is_zero for a in A]
    Z = ed.zero(len(A), "cpu")
    assert ed.is_zero(Z).all() and ed.is_on_curve(Z).all()
    assert ed.is_zero(ed.add(PA, ed.neg(PA))).all()  # P + (-P) is the identity
    # eq: the same points under another Z, and a doubled one
    PB = _to_port(f, _extended(jf, A, 9))
    assert ed.eq(PA, PB).all() and not ed.eq(PA, ed.double(PA))[0]


def test_to_host_matches_jax(ctx, jax_side):
    """to_host normalises on the device (batch inversion of Z, then one
    product); the JAX side's raw coordinates are divided on the host (its
    to_host runs the same batch inversion, held against the port's in
    test_field_n9_matches_jax[inv_root])."""
    f, _, ed, jed, E, A, _ = ctx
    PA = _to_port(f, jax_side["JA"], UNREDUCED)
    got = ed.to_host(PA)
    via_jax = [(X * pow(Z, -1, P) % P, Y * pow(Z, -1, P) % P)
               for X, Y, Z, _ in jed.to_host_raw(JaxEdwardsBatch(*jax_side["JA"]))]
    assert [pt_xy(p) for p in got] == via_jax == [pt_xy(a) for a in A]
    raw = ed.to_host_raw(PA)
    assert [(X * pow(Z, -1, P) % P, Y * pow(Z, -1, P) % P) for X, Y, Z, _ in raw] == via_jax
    back = ed.to_host(ed.to_device(got, "cpu"))
    assert back == got


K2D = ED_ON_BLS12_377.d * 2 % P  # the constant of the Edwards add


@pytest.fixture(scope="module")
def field_side():
    """Inputs of the 9-limb field tests and the JAX package's product,
    product by 2d and divstep inverse on them, in one jitted program."""
    f = create_field_ops(P)
    jf = jax_field_ops(P, w=W_JAX)
    rng = np.random.default_rng(99)
    boundary = [0, 1, 2, P - 1, P, P + 1, 2 * P - 1, f.R_mod_p]
    raw = rng.integers(0, 1 << 62, size=(8, 6)).tolist()
    xs = boundary + [sum(v << (62 * k) for k, v in enumerate(r)) % (2 * P) for r in raw]
    ys = xs[::-1]
    rj = 1 << (W_JAX * jf.n)
    jx = jcodec.pack([x % P * rj % P for x in xs], jf.mp)
    jy = jcodec.pack([y % P * rj % P for y in ys], jf.mp)
    kc = jcodec.pack_scalar(K2D * rj % P, jf.mp)
    out = jax.jit(lambda x, y: (jf.mul(x, y), jf.mul_const(x, kc), jf.inv_root(x)))(jx, jy)
    return f, xs, ys, jy, dict(zip(("mul", "mul_const", "inv_root"), out))


@pytest.mark.parametrize("op", ["mul", "mul_const", "inv_root"])
def test_field_n9_matches_jax(field_side, op):
    """The 9-limb Montgomery product, product by a constant and divstep
    inverse (the three field kernels the TE path runs at n = 9) against the
    JAX package's 20 x 13-bit field."""
    f, xs, ys, jy, jax_out = field_side
    assert f.n == 9 and f.R == 1 << 288 and f.R > 64 * P
    # every third lane holds the unreduced representative v + p
    tx = torch.from_numpy(codec.pack([x % P * f.R % P + (P if i % 3 == 0 else 0)
                                      for i, x in enumerate(xs)], f.n))
    ty = interop.field_from_jax(jy, f, device="cpu")
    if op == "mul":
        tz, want = f.mul(tx, ty), [x * y % P for x, y in zip(xs, ys)]
    elif op == "mul_const":
        tz, want = f.mul_const(tx, K2D * f.R % P), [x * K2D % P for x in xs]
    else:
        tz, want = f.inv_root(tx), [pow(x, -1, P) if x % P else 0 for x in xs]
    via_jax = f.unpack(interop.field_from_jax(np.asarray(jax_out[op]), f, device="cpu"),
                       from_mont=True)
    assert f.unpack(tz, from_mont=True) == via_jax == want
    assert all(v < 2 * P for v in codec.unpack(tz))


def test_divstep_constants_n9():
    f = create_field_ops(P)
    dp = divstep.divstep_params(f)
    assert divstep.iterations(P.bit_length()) == dp.iters == 733
    assert dp.n_batches == 25 and divstep.kernel_limbs(9) == 10 and divstep.kernel_limbs(12) == 13
    assert len(dp.kernel_words) == 10 * (1 + divstep.SHIFTS) + f.n + 2


@pytest.mark.parametrize("c", [4, 11, 13])
def test_signed_digits_match_jax(c):
    """Non-GLV signed digits, integer for integer, on scalars 0, 1, q - 1
    and random ones (K = ceil(252 / c) windows for the 251-bit order)."""
    rng = np.random.default_rng(c)
    raw = rng.integers(0, 256, size=(13, 32), dtype=np.uint8)
    vals = [0, 1, Q - 1] + [int.from_bytes(r.tobytes(), "little") % Q for r in raw]
    bq = Q.bit_length()
    limbs = ints_to_limbs_np(vals, bq, 13, 20)
    got = signed_digits_device(torch.from_numpy(limbs), 13, bq, c)
    want = np.asarray(jax_signed_digits(limbs, 13, bq, c))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (-(-(bq + 1) // c), len(vals))
    assert (got.numpy() == want).all()
    assert [sum(int(d) << (c * k) for k, d in enumerate(col)) for col in got.T.tolist()] == vals
    assert got.abs().max() <= 1 << (c - 1)


def test_random_points_fast_edwards():
    """The bases are those of the JAX package's random_points_fast_edwards
    (random.Random(seed) through TwistedEdwardsCurve.random_point), and point
    i is sum_t (idx[t, i] + 3) B_t, on the curve."""
    from montgomery_tpu.curves.random import _table_indices as jax_table_indices

    seed, N = 42, 16
    E = TwistedEdwardsCurve(JAX_ED)
    rng = random.Random(seed)
    bases = [E.random_point(rng) for _ in range(8)]
    assert [pt_xy(b) for b in table_bases(ED_ON_BLS12_377, seed)] == [pt_xy(b) for b in bases]
    idx = table_indices(seed, N)
    assert (idx == jax_table_indices(np.random.default_rng(seed), N, 8, 512)).all()
    ed = EdwardsOps(create_field_ops(P), ED_ON_BLS12_377)
    pts = random_points_fast_edwards(ed, N, seed=seed, device="cpu")
    assert isinstance(pts, EdwardsBatch) and pts.count == N
    got = ed.to_host(pts)
    for i in range(N):
        acc = type(bases[0]).zero()
        for t in range(8):
            acc = E.add(acc, E.scale(int(idx[t, i]) + 3, bases[t]))
        assert pt_xy(got[i]) == pt_xy(acc) and E.is_on_curve(acc)


def test_launch_guard_by_kernel():
    """kernels.field_params accepts 9 limbs for the kernels the TE path runs
    and for every Weierstrass kernel (Pallas), 12 and 13 (BLS12-381) for
    every kernel but the Edwards ones, 1, 2 and 3 (the example fields small,
    babybear, goldilocks) for the field kernels, divstep_inv and barrett_mul
    alone, and 15 for none: no launch can hand planes of another width to a
    kernel."""
    nine = {"mont_mul", "mul_const", "divstep_inv_mont", "ed_add", "ed_dbl", "ed_add_packed", "ed_combine",
            "exp_ladder", "sqr_n", "sqrt_win", divstep.DIVSTEP_INV.name, alt_mul.BARRETT_MUL.name}
    small = {"mont_mul", "mont_sqr", "mul_const", "exp_ladder", "sqr_n", "sqrt_win", "divstep_inv_mont",
             divstep.DIVSTEP_INV.name, alt_mul.BARRETT_MUL.name}
    field_kernels = {k for k in kernels.REGISTRY.values() if None not in k.symbols}
    assert {k.name for k in field_kernels} >= nine | {"proj_add_rcb", "aff_pre_packed", "mont_sqr"}
    for k in field_kernels:
        edwards_only = k.name.startswith("ed_")
        for n in (1, 2, 3, 9, 12, 13, 15):
            ok = (n == 9 or n in (12, 13) and not edwards_only or n in (1, 2, 3) and k.name in small)
            if ok:
                assert len(kernels.field_params(k, P, n, 1)) == 3 * n + 1
            else:
                with pytest.raises(NotImplementedError, match=f"this field needs {n}"):
                    kernels.field_params(k, P, n, 1)
    for k in (projective.PROJ_ADD_RCB, projective.PROJ_DBL_RCB, affine.AFF_PRE_PACKED,
              affine.AFF_POST_PACKED, affine.PACK_GLV, MONT_SQR):
        with pytest.raises(NotImplementedError):
            k.launch(n=15, device=torch.device("cuda"))  # refused before the library is touched
    assert set(edwards.ED_ADD.symbols) == {9}
    assert set(MONT_MUL.symbols) == set(MUL_CONST.symbols) == set(MONT_SQR.symbols) == {1, 2, 3, 9, 12, 13}


def test_weierstrass_guard_on_cuda(monkeypatch):
    """WeierstrassMsm on the card takes Pallas (9 limbs: its curve kernels
    exist at 9 beside the Edwards ones) and refuses a field of a limb count
    no kernel is built at (a 448-bit prime: 15) before any launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(api, "_CTX_CACHE", {})  # the context built here leaves with the patch
    assert WeierstrassMsm(PALLAS, device="cuda").fops.n == 9
    with pytest.raises(NotImplementedError, match="this field needs 15"):
        WeierstrassMsm(dataclasses.replace(PALLAS, modulus=(1 << 448) - (1 << 224) - 1), device="cuda")

@pytest.fixture
def ed_recorded(monkeypatch):
    """ed_add and ed_dbl launches reach a fake library (no card): the
    wrappers take their kernel path on CPU tensors and the fake entries
    record their arguments."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    lib = types.SimpleNamespace(msm_ed_add_n9=entry("add"), msm_ed_dbl_n9=entry("dbl"))
    monkeypatch.setattr(kernels.LIBRARY, "get", lambda: lib)
    monkeypatch.setattr(kernels, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    for k in (edwards.ED_ADD, edwards.ED_DBL):
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    return calls


def test_add_and_double_n_body_by_lanes(ed_recorded):
    """Below FEW_ADD_LANES / FEW_DBL_LANES lanes `add` / `double_n` ask
    for the kernel's narrow-launch body (four threads a lane), from there on
    for the one-thread body: the Twisted Edwards MSM's window-sum launches
    from 20 to 20,480 lanes and its doubling (20 lanes) take the first, its
    two 40,960-lane adds and the cofactor's 2^20-lane doubling the second;
    `few` picks the body by name. Each launch carries k = 2d, the field
    words and the lane count; one registry count a launch."""
    f = create_field_ops(P)
    ed = EdwardsOps(f, ED_ON_BLS12_377)
    k2d = [w % (1 << 32) for w in to_words(ed.k_mont, f.n)]
    field = [w % (1 << 32) for w in to_words(P, f.n) + to_words(2 * P, f.n) + to_words(4 * P, f.n) + [f.mu]]
    fa, fd = EdwardsOps.FEW_ADD_LANES, EdwardsOps.FEW_DBL_LANES
    assert 20480 < fa <= 40960 and 20480 < fd <= 40960
    widths = (1, 20, 640, 20480, fa - 1, fa, 40960, 1 << 20)
    for N in widths:
        z = torch.zeros((f.n, N), dtype=torch.int32)
        Pz = EdwardsBatch(z, z, z, z)
        ed.add(Pz, Pz)
        name, args = ed_recorded[-1]
        assert name == "add" and args[-3:] == (N, int(N < fa), 7), (N, args[-3:])
        assert list(args[12]) == k2d and list(args[13]) == field
        ed.double_n(Pz, 6)
        name, args = ed_recorded[-1]
        assert name == "dbl" and args[8] == 6 and args[-3:] == (N, int(N < fd), 7), (N, args[-3:])
        assert list(args[9]) == k2d and list(args[10]) == field
    for N, few in ((20, False), (1 << 20, True)):  # the body asked for by name
        z = torch.zeros((f.n, N), dtype=torch.int32)
        Pz = EdwardsBatch(z, z, z, z)
        ed.add(Pz, Pz, few=few)
        assert ed_recorded[-1][1][-3:-1] == (N, int(few))
        ed.double_n(Pz, 2, few=few)
        assert ed_recorded[-1][1][-3:-1] == (N, int(few))
    assert edwards.ED_ADD.launches == edwards.ED_DBL.launches == len(widths) + 2
    ed.double_n(Pz, 0)  # no doubling: no launch
    assert edwards.ED_DBL.launches == len(widths) + 2
