"""The 1-, 2- and 3-limb example fields (small, p = 101; babybear, 2^31 - 1;
goldilocks, 2^64 - 2^32 + 1) in montgomery_tpu_torch against montgomery_tpu,
and the build of their kernels.

The field ops (`mul`, `square`, `left_shift`, `inv`, `batch_inv`, `sqr_n`,
`sqrt`) run on the same canonical values in both packages: the JAX side in
one jitted program a field (the suite's callback kernel mode, as the JAX
package's own CPU tests run it), its Montgomery planes carried into the port
by `interop.field_from_jax`, with unreduced [p, 2p) representatives on some
lanes. The plain divstep inverses are held against the JAX `inv_divstep`
(the fields of `tests/test_divstep.py`), `barrett_mul_plain` against the JAX
`barrett_mul` (small and BLS12-381, as `tests/test_alt_mul.py`). Results are
compared as canonical integers (tolerance zero). Port tensors live on the
CPU, so the plain versions run; the kernels themselves run on the card
(`chip_smoke.py` phase 7 and phase 1's baselines). A fake `nvcc` checks
that the build makes one object a source and limb count.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu.ops import alt_mul as jalt
from montgomery_tpu.ops import kernels as jkernels
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.divstep import divstep_params as jax_divstep_params
from montgomery_tpu.ops.divstep import inv_divstep as jax_inv_divstep
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.concrete import example_fields
from montgomery_tpu_torch.ops import alt_mul, divstep, kernels
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import create_field_ops

torch.set_num_threads(1)

W_JAX = 13
FIELDS = {name: example_fields()[name].p for name in ("small", "babybear", "goldilocks")}
SHIFTS = (0, 1, 31, 255)
SQR_M = 5


def _values(p: int, seed: int, count: int = 24) -> list[int]:
    """Canonical values: 0, 1, 2, p - 1, p - 2, then seeded random ones."""
    rng = np.random.default_rng(seed)
    return [0, 1, 2, p - 1, p - 2] + [int(v) % p for v in rng.integers(0, 1 << 62, size=count - 5)]


@pytest.mark.parametrize("name", list(FIELDS))
def test_field_ops_match_jax(name):
    """mul, square, left_shift (k = 0, 1, 31, 255), inv, batch_inv (zeros
    handled), sqr_n (m = 5) and sqrt (root and flag) equal the JAX package's
    jitted create_field_ops(p, w=13), as canonical values; the port's inputs
    come through interop.field_from_jax, every third lane moved to its
    [p, 2p) representative."""
    p = FIELDS[name]
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    assert f.n == {"small": 1, "babybear": 2, "goldilocks": 3}[name]
    xs, ys = _values(p, 191), _values(p, 192)[::-1]
    rj = 1 << (W_JAX * jf.n)
    jx, jy = (jnp.asarray(jcodec.pack([v * rj % p for v in vs], jf.mp)) for vs in (xs, ys))

    def program(x, y):
        root, ok = jf.sqrt(x)
        return (jf.mul(x, y), jf.square(x), *[jf.left_shift(x, k) for k in SHIFTS], jf.inv(x),
                jf.batch_inv(x, handle_zero=True), jf.sqr_n(x, SQR_M), root, ok)

    jout = jax.jit(program)(jx, jy)
    X, Y = (interop.field_from_jax(a, f, W_JAX, device="cpu") for a in (jx, jy))
    up = torch.arange(len(xs)) % 3 == 1
    X, Y = (torch.where(up, f.add_lazy(a, f.const_plane(p, a)), a) for a in (X, Y))
    assert codec.unpack(X)[1::3] == [v * f.R % p + p for v in xs[1::3]]
    root, ok = f.sqrt(X)
    tout = (f.mul(X, Y), f.square(X), *[f.left_shift(X, k) for k in SHIFTS], f.inv(X),
            f.batch_inv(X, handle_zero=True), f.sqr_n(X, SQR_M), root)
    for label, t, j in zip(("mul", "square", *[f"left_shift {k}" for k in SHIFTS], "inv", "batch_inv",
                            "sqr_n", "sqrt"), tout, jout, strict=False):
        assert f.unpack(t, from_mont=True) == jf.unpack(j, from_mont=True), label
        assert all(v < 2 * p for v in codec.unpack(t)), label
    assert ok.tolist() == np.asarray(jout[-1]).tolist()
    inv = f.unpack(tout[-4], from_mont=True)
    assert inv == [pow(v, -1, p) if v else 0 for v in xs]
    assert any(ok.tolist()) and not all(ok.tolist())


@pytest.mark.parametrize("name", ["small", "babybear"])
def test_divstep_plain_matches_jax(name):
    """The safegcd core's plain version (`inv_plain`, the kernels' limb
    layout: 2 and 3 limbs of 30 bits) against the JAX package's
    `inv_divstep` and Python's pow, and the Montgomery inverse
    (`inv_mont_plain`) on canonical and [p, 2p) representatives."""
    p = FIELDS[name]
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    assert f.inv_params.limbs == f.n + 1
    xs = _values(p, 193, 32)
    want = [pow(x, -1, p) if x else 0 for x in xs]
    got = codec.unpack(divstep.inv_plain(f.inv_params, f.pack_raw(xs, "cpu")))
    jz = jax.jit(lambda a: jax_inv_divstep(jax_divstep_params(jf), a))(jnp.asarray(jcodec.pack(xs, jf.mp)))
    assert got == interop.planes_to_ints(np.asarray(jz), W_JAX) == want
    for t in (f.pack(xs, device="cpu", to_mont=True), f.pack_raw([x * f.R % p + p for x in xs], "cpu")):
        out = divstep.inv_mont_plain(f, t)
        assert f.unpack(out, from_mont=True) == want
        assert all(v < 2 * p for v in codec.unpack(out))


@pytest.mark.parametrize("name", ["small", "bls12381"])
def test_barrett_plain_matches_jax(name):
    """barrett_mul_plain (the kernel's word-level steps; at one word the
    shifts start at bit 0) against the JAX package's barrett_mul on its
    plain path and Python's ints, operands in [0, p) with the largest
    squares below p^2."""
    p = example_fields()[name].p
    f, jf = create_field_ops(p), jax_field_ops(p, w=12)
    bp = alt_mul.barrett_params(f)
    assert list(bp.kernel_words)[2 * f.n:] == [bp.K - 1 - alt_mul.barrett_base(f.n),
                                              bp.K + 1 - alt_mul.barrett_base(f.n)]
    xs = _values(p, 194, 32) + [p - 1 - k for k in range(8)]
    ys = _values(p, 195, 32)[::-1] + [p - 1 - k for k in range(8)]
    with jkernels.force_pallas(False):
        jz = jax.jit(lambda a, b: jalt.barrett_mul(jalt.barrett_params(jf), a, b))(
            jnp.asarray(jcodec.pack(xs, jf.mp)), jnp.asarray(jcodec.pack(ys, jf.mp)))
    got = codec.unpack(alt_mul.barrett_mul_plain(bp, f.pack_raw(xs, "cpu"), f.pack_raw(ys, "cpu")))
    assert got == jcodec.unpack(np.asarray(jz), jf.mp) == [x * y % p for x, y in zip(xs, ys)]


def test_compile_queues_every_source_and_count(monkeypatch, tmp_path):
    """`_compile` (a fake nvcc in place of the real one) runs one process a
    source and limb count that the source names under MSM_AT(n), with
    -DMSM_LIMBS=n (mont_mul.cu at n = 1, 2, 3, 9, 12, 13; divstep_inv.cu and
    barrett_mul.cu too; a source without MSM_AT once, without it), then one
    link of every object."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "w").close()
        return types.SimpleNamespace(stdout="", stderr="", returncode=0)

    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", run)
    cus = [p for p in kernels._sources() if p.suffix == ".cu"]
    lib = tmp_path / kernels.LIB_NAME
    kernels._Library._compile(tmp_path, cus, lib)
    assert lib.exists()
    *jobs, link = calls
    assert "-shared" in link and len([a for a in link if a.endswith(".o")]) == len(jobs)
    built = {}
    for cmd in jobs:
        src = cmd[-1].rsplit("/", 1)[-1]
        defs = [a for a in cmd if a.startswith("-DMSM_LIMBS=")]
        built.setdefault(src, []).append(int(defs[0].split("=")[1]) if defs else None)
    for cu in cus:
        text = cu.read_text()
        want = [n for n in kernels.BUILT_LIMBS if f"MSM_AT({n})" in text] or [None]
        assert sorted(built[cu.name], key=str) == sorted(want, key=str), cu.name
    for stem in ("mont_mul", "mont_sqr", "mul_const", "exp_ladder", "sqr_n", "sqrt_win", "divstep_inv_mont",
                 "divstep_inv", "barrett_mul"):
        assert sorted(built[f"{stem}.cu"]) == [1, 2, 3, 9, 12, 13], stem
    assert built["glv_digits.cu"] == [None] and sorted(built["proj_add_rcb.cu"]) == [9, 12, 13]
