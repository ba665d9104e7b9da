"""montgomery_tpu_torch batched-affine engine (affine=True, unsafe=True).

Module by module against montgomery_tpu: the packed GLV expansion
(`pack_rows_glv`) and the unsafe packed add (`add_packed`), with inputs
carried across by `montgomery_tpu_torch.interop` and compared as affine
points (tolerance zero); the JAX side runs jitted in the suite's callback
kernel mode. The slice as a whole is held against the bigint oracle and,
bucket by bucket, the port's projective engine: N = 16 at the default c (a
pair round first) and N = 512 at c = 4 (the 8-way super-round first, read
from the engine's round log). Points are distinct and random
(`random_points_fast`), as the unsafe contract asks; scalars include zeros.
Port tensors live on the CPU, so the kernels' plain versions run.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu.msm import WeierstrassMsm as JaxMsm
from montgomery_tpu_torch import interop, serve
from montgomery_tpu_torch.curves.projective import ProjectiveBatch, ProjectiveOps
from montgomery_tpu_torch.curves.random import random_points_fast
from montgomery_tpu_torch.msm import WeierstrassMsm
from montgomery_tpu_torch.msm.pippenger import bucket_accumulate
from montgomery_tpu_torch.ops.field import FieldOps

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

Q = BLS12_377.order


@pytest.fixture(scope="module")
def ctx():
    msm = WeierstrassMsm(BLS12_377, device="cpu")
    pts = msm.proj.affine_to_host(random_points_fast(msm.proj, 512, seed=11, device="cpu"))
    return msm, WeierstrassCurve(BLS12_377), pts


def _to_port(msm, JA):
    return interop.affine_from_jax(np.asarray(JA.x), np.asarray(JA.y), np.asarray(JA.inf),
                                   msm.fops, device="cpu")


def _plane(values) -> tuple[np.ndarray, torch.Tensor]:
    a = np.asarray([values], dtype=np.int32)
    return a, torch.from_numpy(a)


# the add's lanes: mixed signs and pair flags over 12 lanes; lane 4 passes an
# infinite A through (hp = 0), lane 7 passes a negated A through
SA = [0, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0, 0]
SB = [0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1]
HP = [1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 1, 0]


@pytest.fixture(scope="module")
def jax_side(ctx):
    """The JAX package's pack_rows_glv and unsafe add_packed on the tests'
    inputs, in one jitted program (one compile for both tests)."""
    _, _, pts = ctx
    jctx = JaxMsm(BLS12_377)
    jaff = jctx.affine
    g = pts[:7] + [AffinePoint.zero()]
    G, H = pts[20:32], pts[40:52]
    G[4] = AffinePoint.zero()
    JA, JG, JH = (jctx.proj.affine_to_device(v) for v in (g, G, H))
    flags = [_plane(v)[0] for v in (SA, SB, HP)]

    def both(A, G, H, a, b, v):
        return (jaff.unpack_rows(jaff.pack_rows_glv(A)),
                jaff.unpack_rows(jaff.add_packed(jaff.pack_rows(G), jaff.pack_rows(H), a, b, v,
                                                 unsafe=True)))

    glv, add = jax.jit(both)(JA, JG, JH, *flags)
    return {"glv": (g, JA, glv), "add": (G, H, JG, JH, add)}


def test_pack_rows_glv_matches_jax(ctx, jax_side):
    msm, E, _ = ctx
    g, JA, jglv = jax_side["glv"]
    via_jax = msm.proj.affine_to_host(_to_port(msm, jglv))
    rows = msm.affine.pack_rows_glv(_to_port(msm, JA))
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (2 * 12 + 1, 2 * len(g))
    assert msm.affine.packed_rows == 25
    got = msm.proj.affine_to_host(msm.affine.unpack_rows(rows))
    want = g + [AffinePoint.zero() if p.is_zero else E.endomorphism(p) for p in g]
    for a, b, w in zip(got, via_jax, want):
        assert E.equal(a, w) and E.equal(b, w)
    # pack_rows / unpack_rows round trip
    back = msm.proj.affine_to_host(msm.affine.unpack_rows(msm.affine.pack_rows(msm.affine_to_device(g))))
    assert all(E.equal(a, b) for a, b in zip(back, g))


def test_add_packed_unsafe_matches_jax(ctx, jax_side):
    msm, E, _ = ctx
    g, h, JG, JH, jadd = jax_side["add"]
    via_jax = msm.proj.affine_to_host(_to_port(msm, jadd))
    aff = msm.affine
    tA, tB, th = (_plane(v)[1] for v in (SA, SB, HP))
    A, B = aff.pack_rows(_to_port(msm, JG)), aff.pack_rows(_to_port(msm, JH))
    out = aff.add_packed(A, B, tA, tB, th, unsafe=True)
    got = msm.proj.affine_to_host(aff.unpack_rows(out))
    for i in range(len(g)):
        a = E.neg(g[i]) if SA[i] else g[i]
        b = E.neg(h[i]) if SB[i] else h[i]
        want = E.add(a, b) if HP[i] else a
        assert E.equal(got[i], want) and E.equal(via_jax[i], want), f"lane {i}"
    # the safe add on the same lanes gives the same sums
    safe = aff.unpack_rows(aff.add_packed(A, B, tA, tB, th))
    unsafe, f = aff.unpack_rows(out), aff.f
    assert torch.equal(f.reduce(safe.x), f.reduce(unsafe.x))
    assert torch.equal(f.reduce(safe.y), f.reduce(unsafe.y))
    assert torch.equal(safe.inf, unsafe.inf)


# widths of the unsafe add around the batch inversion's stop (512 lanes: no
# tree, so the post takes the root's inverses as they are) and odd widths
# (the tree carries the last lane through)
WIDTHS = (1, 2, 511, 512, 513, 1025)


def _wide_operands(msm, pts, M: int, seed: int):
    """Packed A and B as the two column halves of one (25, 2M) array (the
    engine's layout), with numpy-drawn signs and pair flags: lane i adds
    point i % 512 and point (7 i + 3) % 512 (never the same x); lane 0's A
    is infinite and unpaired where M > 1. Returns (A, B, sA, sB, hp, the
    oracle's operand points, the numpy flags)."""
    rng = np.random.default_rng(seed)
    ga = [pts[i % len(pts)] for i in range(M)]
    gb = [pts[(7 * i + 3) % len(pts)] for i in range(M)]
    flags = rng.integers(0, 2, size=(3, M), dtype=np.int32)
    flags[2, -1] = 1
    if M > 1:
        ga[0], flags[2, 0] = AffinePoint.zero(), 0
    aff = msm.affine
    C = aff.pack_rows(msm.affine_to_device(ga + gb))
    sA, sB, hp = (torch.from_numpy(flags[k:k + 1].copy()) for k in range(3))
    return C[:, :M], C[:, M:], sA, sB, hp, ga, gb, flags


def test_add_packed_unsafe_widths_match_jax(ctx):
    """The unsafe packed add (pre kernel, `batch_inv_parent`, the post that
    forms the last descent level) at every width of WIDTHS against the JAX
    package's add_packed and against the oracle lane by lane. The JAX side
    adds the lanes of every width in one call of sum(WIDTHS) lanes (a lane's
    sum does not depend on the width; one jitted program)."""
    msm, E, pts = ctx
    aff = msm.affine
    jctx = JaxMsm(BLS12_377)
    jaff = jctx.affine
    inputs = [_wide_operands(msm, pts, M, seed=M) for M in WIDTHS]
    ga_all = [p for *_, ga, _, _ in inputs for p in ga]
    gb_all = [p for *_, gb, _ in inputs for p in gb]
    fl = np.concatenate([flags for *_, flags in inputs], axis=1)

    def jax_add(G, H, a, b, v):
        return jaff.unpack_rows(jaff.add_packed(jaff.pack_rows(G), jaff.pack_rows(H), a, b, v,
                                                unsafe=True))

    jo = jax.jit(jax_add)(jctx.proj.affine_to_device(ga_all), jctx.proj.affine_to_device(gb_all),
                          *fl[:, None])
    via_jax_all = msm.proj.affine_to_host(_to_port(msm, jo))
    start = 0
    for M, (A, B, sA, sB, hp, ga, gb, flags) in zip(WIDTHS, inputs):
        got = msm.proj.affine_to_host(aff.unpack_rows(aff.add_packed(A, B, sA, sB, hp, unsafe=True)))
        via_jax, start = via_jax_all[start:start + M], start + M
        for i in range(M):
            a = E.neg(ga[i]) if flags[0, i] else ga[i]
            b = E.neg(gb[i]) if flags[1, i] else gb[i]
            want = E.add(a, b) if flags[2, i] else a
            assert E.equal(got[i], want) and E.equal(via_jax[i], want), (M, i)


@pytest.mark.parametrize("M", WIDTHS)
def test_batch_inv_parent_and_fused_post(ctx, M):
    """`batch_inv_parent` plus the post's plain version (the lanes'
    inverses from the parent level) equal the full `batch_inv` plus the old
    formula (the chord on the given inverses) bit for bit; the parent level
    is ceil(M / 2) wide with h = M // 2 above the 512-lane stop, the root
    itself (h = 0) up to it."""
    msm, _, pts = ctx
    aff, f = msm.affine, msm.fops
    A, B, sA, sB, hp, *_ = _wide_operands(msm, pts, M, seed=M + 1)
    denom = aff.pre_packed_u(A, B, hp)
    inv1, h = f.batch_inv_parent(denom)
    assert (h, inv1.shape[-1]) == ((M // 2, (M + 1) // 2) if M > f.BATCH_INV_STOP else (0, M))
    full = f.batch_inv(denom)
    fused = aff.post_packed_u(A, B, sA, sB, inv1, denom, h, hp)
    old = aff.post_packed_u_plain(A, B, sA, sB, full, denom, 0, hp)
    assert torch.equal(fused, old)
    assert torch.equal(f.reduce(f.mul(full, denom)), f.const_plane(f.R_mod_p, denom))
    with pytest.raises(ValueError):
        aff.post_packed_u(A, B, sA, sB, inv1, denom, h + 1, hp)


@pytest.mark.parametrize("N,c,first", [(16, None, ("pair", 2)), (512, 4, ("super", 8))])
def test_affine_unsafe_msm_matches_oracle(ctx, N, c, first):
    """msm_full(affine=True, unsafe=True) equals the bigint oracle; the round
    log shows which first round ran (at N = 512, c = 4: M0 = 33 * 1024 >=
    64 G = 64 * 33 * 8, so the super-round). Against the projective engine
    the comparison is bucket by bucket, which is stricter than comparing the
    MSMs and cheaper here: both engines share the projective reduction."""
    msm, E, pts = ctx
    P = pts[:N]
    rng = np.random.default_rng(N)
    raw = rng.integers(0, 256, size=32 * N, dtype=np.uint8).tobytes()
    sc = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little") % Q for i in range(N)]
    sc[0] = sc[5] = 0
    sc[1], sc[2] = 1, Q - 1
    got = msm.msm_full(sc, P, c=c, affine=True, unsafe=True)
    rounds = msm.aff_adapter_unsafe.rounds
    assert rounds[0][:2] == first
    assert {kind for kind, _, _ in rounds[1:]} <= {"pair", "tail"}
    assert E.equal(got, oracle_msm(E, sc, P))

    c = c or msm.default_c(N)
    A, digits = msm.affine_to_device(P), msm.digits_device(msm.scalars_to_limbs(sc), c)
    aff, K, L = bucket_accumulate(msm.aff_adapter_unsafe, msm.affine.pack_rows_glv(A), digits, c)
    proj, _, _ = bucket_accumulate(msm.adapter, msm.adapter.from_points(msm.expand_points_glv(A)),
                                   digits, c)
    flat = lambda B: ProjectiveBatch(*[a.reshape(a.shape[0], K * L) for a in B])  # noqa: E731
    got_b = msm.proj.to_host(flat(msm.aff_adapter_unsafe.to_projective(aff)))
    want_b = msm.proj.to_host(flat(proj))
    assert all(E.equal(a, b) for a, b in zip(got_b, want_b))


def test_entry_points_default_to_the_card():
    """Every entry point that places data takes device='cuda' by default (the
    CPU is asked for explicitly); checked without touching a device."""
    entry = [WeierstrassMsm.__new__, random_points_fast, ProjectiveOps.affine_to_device,
             FieldOps.pack, FieldOps.pack_raw, interop.field_from_jax, interop.affine_from_jax,
             interop.projective_from_jax, interop.scalars_from_jax, serve.get_curve,
             serve.compute_msm]
    for fn in entry:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    # the engine defaults are the JAX package's (montgomery_tpu/msm/api.py)
    for name, affine in (("msm_full", True), ("msm_device_full", False), ("msm_phases", True)):
        params = inspect.signature(getattr(WeierstrassMsm, name)).parameters
        assert params["affine"].default is affine and params["unsafe"].default is False, name
        jparams = inspect.signature(getattr(JaxMsm, name)).parameters
        assert jparams["affine"].default is affine and jparams["unsafe"].default is False, name
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WeierstrassMsm(BLS12_377)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.compute_msm(b"", b"")
