"""montgomery_tpu_torch MSM slice as a whole, on the CPU (plain versions).

The projective MSM (`msm_full(..., affine=False)`) is held against the JAX
package's bigint oracle (`montgomery_tpu.bigint.msm`), exact; inputs come
from numpy with fixed seeds and include full-width scalars, zero scalars,
duplicate points and the point at infinity.
"""

import dataclasses
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import WeierstrassCurve
from montgomery_tpu.bigint import msm as oracle_msm
from montgomery_tpu.bigint.weierstrass import AffinePoint
from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu_torch.curves.random import random_points_fast, table_bases, table_indices
from montgomery_tpu_torch.msm import WeierstrassMsm
from montgomery_tpu_torch.ops import alt_mul, kernels

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

Q = BLS12_377.order


@pytest.fixture(scope="module")
def ctx():
    return WeierstrassMsm(BLS12_377, device="cpu"), WeierstrassCurve(BLS12_377)


def _inputs(E, N: int, seed: int):
    rng = np.random.default_rng(seed)
    base = [E.scale(int(k), E.generator) for k in rng.integers(1, 1 << 62, size=min(N, 6))]
    pts = [base[int(i)] for i in rng.integers(0, len(base), size=N)]  # duplicates
    raw = rng.integers(0, 256, size=32 * N, dtype=np.uint8).tobytes()
    sc = [int.from_bytes(raw[32 * i:32 * (i + 1)], "little") % Q for i in range(N)]
    if N >= 8:
        sc[0] = sc[5] = 0
        sc[1], sc[2] = 1, Q - 1
        pts[3] = AffinePoint.zero()
    return sc, pts


@pytest.mark.parametrize("N", [1, 32, 512])
def test_msm_full_matches_oracle(ctx, N):
    msm, E = ctx
    sc, pts = _inputs(E, N, seed=N)
    got = msm.msm_full(sc, pts, affine=False)
    assert E.equal(got, oracle_msm(E, sc, pts))


def test_msm_device_full_from_bytes(ctx):
    """Packed-byte points and scalars (scalars >= q are reduced)."""
    msm, E = ctx
    sc, pts = _inputs(E, 8, seed=3)
    nb = 48
    data = b"".join((0).to_bytes(2 * nb, "little") if p.is_zero
                    else p.x.to_bytes(nb, "little") + p.y.to_bytes(nb, "little") for p in pts)
    A = msm.points_from_bytes(data)
    assert [p.is_zero for p in msm.proj.affine_to_host(A)] == [p.is_zero for p in pts]
    blob = b"".join((s + Q if s < (1 << 256) - Q else s).to_bytes(32, "little") for s in sc)
    limbs = msm.scalars_to_limbs(blob)
    assert torch.equal(limbs, msm.scalars_to_limbs(sc))
    S = msm.msm_device_full(A, limbs, c=4)
    assert E.equal(msm.proj.to_host(S)[0], oracle_msm(E, sc, pts))


def test_random_points_fast_closed_form():
    """Point i = sum_t (idx[t, i] + 3) B_t, with the JAX package's seed scheme:
    bases from random.Random(seed), indices from numpy default_rng(seed)."""
    E = WeierstrassCurve(BLS12_377)
    msm = WeierstrassMsm(BLS12_377, device="cpu")
    N, seed = 16, 42
    got = msm.proj.affine_to_host(random_points_fast(msm.proj, N, seed=seed, device="cpu"))
    rng = random.Random(seed)
    bases = [E.random_point(rng) for _ in range(8)]
    assert [(b.x, b.y) for b in bases] == [(b.x, b.y) for b in table_bases(BLS12_377, seed)]
    idx = np.random.default_rng(seed).integers(0, 512, size=(8, N))
    assert (idx == table_indices(seed, N)).all()
    for i in range(N):
        acc = AffinePoint.zero()
        for t in range(8):
            acc = E.add(acc, E.scale(int(idx[t, i]) + 3, bases[t]))
        assert E.equal(got[i], acc)


def test_import_leaves_jax_out():
    code = ("import sys, montgomery_tpu_torch.msm, montgomery_tpu_torch.interop, "
            "montgomery_tpu_torch.ops.field, montgomery_tpu_torch.curves.projective, "
            "montgomery_tpu_torch.curves.random, montgomery_tpu_torch.serve, "
            "montgomery_tpu_torch.curves.edwards, montgomery_tpu_torch.bigint.twisted_edwards, "
            "montgomery_tpu_torch.concrete, montgomery_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'montgomery_tpu' or m.startswith('montgomery_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_launch_no_kernel(ctx):
    msm, E = ctx
    kernels.reset_launch_counts()
    sc, pts = _inputs(E, 4, seed=9)
    msm.msm_full(sc, pts, c=3, affine=False)
    distinct = [E.scale(k, E.generator) for k in (3, 5, 7, 11)]
    msm.msm_full(sc, distinct, c=5, affine=True, unsafe=True)
    msm.msm_full(sc, pts, c=4)  # the safe batched-affine engine
    assert msm.affine.is_on_curve(msm.affine_to_device(pts)).all()  # mont_sqr
    counts = kernels.launch_counts()
    assert set(counts) == {"mul_const", "proj_add_rcb", "proj_dbl_rcb", "proj_combine_rcb",
                           "glv_digits", "mont_mul",
                           "divstep_inv_mont", "pack_glv", "aff_pre_packed_u", "aff_post_packed_u",
                           "mont_sqr", "aff_pre_packed", "aff_post_packed", "ed_add", "ed_dbl",
                           "ed_add_packed", "ed_combine", "exp_ladder", "sqr_n", "sqrt_win", "aff_pre",
                           "aff_post",
                           "aff_pre_unsafe", "aff_post_unsafe", "divstep_inv", alt_mul.BARRETT_MUL.name}
    assert all(v == 0 for v in counts.values()), counts


def test_no_fallback_for_other_devices(ctx):
    msm, _ = ctx
    x = torch.empty((12, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        msm.fops.mul_const(x, 1)
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(1), x)


def test_affine_engine_raises(ctx):
    """The safe batched-affine engine (affine=True, unsafe=False), which used
    to raise, runs at every entry point and equals the oracle at N = 2 on a
    duplicated point: `msm_full`'s default, `msm_device_full` and
    `msm_phases`."""
    msm, E = ctx
    sc, pts = _inputs(E, 2, seed=1)
    pts = [pts[0], pts[0]]
    want = oracle_msm(E, sc, pts)
    assert E.equal(msm.msm_full(sc, pts), want)
    assert msm.aff_adapter.rounds  # the safe adapter ran
    A, limbs = msm.affine_to_device(pts), msm.scalars_to_limbs(sc)
    S = msm.msm_device_full(A, limbs, 3, affine=True, unsafe=False)
    S2, log = msm.msm_phases(A, limbs, 3, affine=True, unsafe=False)
    for R in (S, S2):
        assert E.equal(msm.proj.to_host(R)[0], want)
    assert [label for label, _ in log.entries] == [
        "digits (GLV+slice)", "expand (pack_glv)", "accumulate", "reduce+combine"]


def test_failed_context_is_not_cached(monkeypatch):
    """A context whose build raises leaves no entry in the cache: the next
    call builds it anew (curves with a != 0 build since the general-a group
    law, so the failure is a field whose construction raises)."""
    from montgomery_tpu_torch.msm import api

    bad = dataclasses.replace(BLS12_377, label="bls12-377-refused")

    def refuse(p):
        raise NotImplementedError(f"no field for {p}")

    with monkeypatch.context() as m:
        m.setattr(api, "create_field_ops", refuse)
        for _ in range(2):
            with pytest.raises(NotImplementedError):
                WeierstrassMsm(bad, device="cpu")
    assert WeierstrassMsm(bad, device="cpu").params is bad
