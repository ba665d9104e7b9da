"""montgomery_tpu_torch exponentiation and square roots against montgomery_tpu.

`FieldOps.exp_const`, `inv`, `sqr_n` and `sqrt` run the kernels
`exp_ladder`, `sqr_n` and `sqrt_win` on the card; here, on CPU tensors, their
plain versions run. The JAX package's generators and its eager sqrt are slow
on this CPU at the curve fields (tens of seconds a call), so the whole-op
comparisons with it run at Goldilocks (p = 2^64 - 2^32 + 1, M = 32: every
window of the discrete log is full) and the per-window formula is compared at
the two curve fields, first and last window. Inputs are drawn from numpy
with a fixed seed and handed to both packages as the Montgomery forms of the
same canonical values; results are compared as canonical integers, with
tolerance zero (the root itself, not only its square).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.concrete import BLS12_377, ED_ON_BLS12_377
from montgomery_tpu_torch.ops import kernels
from montgomery_tpu_torch.ops.field import SQRT_WINDOW, create_field_ops

torch.set_num_threads(1)

W_JAX = 13
GOLDILOCKS = 2**64 - 2**32 + 1
FIELDS = {"bls12-377": BLS12_377.modulus, "ed-on-bls12-377": ED_ON_BLS12_377.modulus,
          "goldilocks": GOLDILOCKS}
# (M, bits of q) for p - 1 = 2^M q
SYLOW = {"bls12-377": (46, 331), "ed-on-bls12-377": (47, 206), "goldilocks": (32, 32)}


def _rand_below(rng: np.random.Generator, bound: int, n: int) -> list[int]:
    nb = (bound.bit_length() + 7) // 8 + 8
    raw = rng.bytes(n * nb)
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % bound for i in range(n)]


def _values(p: int, seed: int) -> tuple[list[int], list[bool]]:
    """Canonical values (0, 1, p - 1, 2, squares, random) and which lanes
    hold the unreduced representative (+ p) of their Montgomery form."""
    rng = np.random.default_rng(seed)
    sq = [v * v % p for v in _rand_below(rng, p, 5)]
    vals = [0, 1, p - 1, 2, 4] + sq + _rand_below(rng, p, 6)
    return vals, [i % 3 == 2 for i in range(len(vals))]


def _port_planes(f, vals, up):
    return f.pack_raw([v * f.R % f.p + (f.p if u else 0) for v, u in zip(vals, up)], "cpu")


def _jax_planes(jf, vals, up):
    p = jf.p
    return jnp.asarray(jcodec.pack([v * jf.mp.R % p + (p if u else 0) for v, u in zip(vals, up)],
                                   jf.mp))


def _jax_canon(jf, arr) -> list[int]:
    rinv = pow(jf.mp.R, -1, jf.p)
    return [v * rinv % jf.p for v in interop.planes_to_ints(np.asarray(arr), W_JAX)]


@pytest.fixture(scope="module")
def gold():
    f, jf = create_field_ops(GOLDILOCKS), jax_field_ops(GOLDILOCKS, w=W_JAX)
    vals, up = _values(GOLDILOCKS, 11)
    return f, jf, vals, _port_planes(f, vals, up), _jax_planes(jf, vals, up)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_sqrt_constants(field):
    p = FIELDS[field]
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    assert (f.sqrt_M, f.sqrt_q_odd.bit_length()) == SYLOW[field]
    assert (f.sqrt_M, f.sqrt_q_odd) == (jf.sqrt_M, jf.sqrt_q_odd)
    jpows = [_jax_canon(jf, plane)[0] for plane in np.asarray(jf.sqrt_g_inv_pows)]
    assert [v * f.R_inv % p for v in f.sqrt_g_inv_pows] == jpows
    g = pow(jpows[0], -1, p)  # the 2-Sylow generator has order exactly 2^M
    assert pow(g, 1 << f.sqrt_M, p) == 1 and pow(g, 1 << (f.sqrt_M - 1), p) == p - 1


@pytest.mark.parametrize("e", [0, 1, 2, 5, "sqrt", "p-2"])
def test_exp_const_goldilocks(gold, e):
    f, jf, vals, x, jx = gold
    p = f.p
    e = {"sqrt": (f.sqrt_q_odd - 1) // 2, "p-2": p - 2}.get(e, e)
    got = f.unpack(f.exp_const(x, e), from_mont=True)
    assert got == _jax_canon(jf, jf.exp_const(jx, e)) == [pow(v, e, p) for v in vals]


def test_inv_goldilocks(gold):
    f, jf, vals, x, jx = gold
    out = f.inv(x)
    assert all(v < 2 * f.p for v in interop.planes_to_ints(out.numpy(), 32))
    got = f.unpack(out, from_mont=True)
    assert got == _jax_canon(jf, jf.inv(jx)) == [pow(v, -1, f.p) if v else 0 for v in vals]


@pytest.mark.parametrize("m", [0, 1, 7])
def test_sqr_n_goldilocks(gold, m):
    f, jf, vals, x, jx = gold
    got = f.unpack(f.sqr_n(x, m), from_mont=True)
    assert got == _jax_canon(jf, jf.sqr_n(jx, m)) == [pow(v, 1 << m, f.p) for v in vals]


def test_sqrt_goldilocks(gold):
    """The same root (not only the same square) and the same flag."""
    f, jf, vals, x, jx = gold
    p = f.p
    root, ok = f.sqrt(x)
    jroot, jok = jf.sqrt(jx)
    got = f.unpack(root, from_mont=True)
    assert got == _jax_canon(jf, jroot)
    assert ok.tolist() == np.asarray(jok).tolist()
    for v, r, sq in zip(vals, got, ok.tolist()):
        assert sq == (v == 0 or pow(v, (p - 1) // 2, p) == 1)
        assert r * r % p == v if sq else r == 0
    assert not all(ok.tolist()) and any(ok.tolist())


def _window_state(f, k: int, lk: int, seed: int):
    """Canonical (t, r, s) for window k: t = g^a in the 2-Sylow subgroup,
    with a drawn so the window's bits vary (for the last window, t in the
    subgroup of order 2^lk), s = t^(2^(M - 4k - lk)); some lanes are plain
    random values and 0."""
    p, M = f.p, f.sqrt_M
    g = pow(f.sqrt_g_inv_pows[0] * f.R_inv % p, -1, p)
    rng = random.Random(seed)
    last = SQRT_WINDOW * k + lk >= M
    ts, rs = [], []
    for i in range(12):
        a = rng.randrange(1 << lk) << (M - lk) if last else rng.randrange(1 << M)
        ts.append(pow(g, a, p) if i < 10 else (0 if i == 10 else rng.randrange(p)))
        rs.append(rng.randrange(p))
    chain = M - SQRT_WINDOW * k - lk
    return ts, rs, [pow(t, 1 << chain, p) for t in ts]


@pytest.mark.parametrize("field,window", [("bls12-377", "first"), ("bls12-377", "last"),
                                          ("ed-on-bls12-377", "first"),
                                          ("ed-on-bls12-377", "last")])
def test_sqrt_window_plain_against_jax(field, window):
    """sqrt_window_plain and the JAX package's _sqrt_window_formula on the
    same (t, r, s): the last window has lk = 2 at BLS12-377 (M = 46) and
    lk = 3 at ed-on-bls12-377 (M = 47) and leaves t alone."""
    p = FIELDS[field]
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    M = f.sqrt_M
    k = 0 if window == "first" else (M - 1) // SQRT_WINDOW
    lk = min(SQRT_WINDOW, M - SQRT_WINDOW * k)
    last = window == "last"
    assert lk == {"first": 4, "last": M - 44}[window]
    ts, rs, ss = _window_state(f, k, lk, seed=k + lk)
    up = [i % 4 == 1 for i in range(len(ts))]
    t2, r2, dig = f.sqrt_window_plain(*[_port_planes(f, v, up) for v in (ts, rs, ss)], k, lk, last)
    jt, jr, jd = jf._sqrt_window_formula(k, lk, M, last)(*[_jax_planes(jf, v, up)
                                                           for v in (ts, rs, ss)])
    assert f.unpack(t2, from_mont=True) == _jax_canon(jf, jt)
    assert f.unpack(r2, from_mont=True) == _jax_canon(jf, jr)
    assert dig.tolist() == np.asarray(jd).tolist()
    assert len(set(dig[0].tolist())) > 1  # the window's bits vary over the lanes
    if last:
        assert f.unpack(t2, from_mont=True) == ts


@pytest.mark.parametrize("field", ["bls12-377", "ed-on-bls12-377"])
def test_exp_inv_sqrt_against_pow(field):
    """At the curve fields (the plain versions alone): exp_const, inv and
    sqrt against pow() and Euler's criterion, on [0, 2p) representatives."""
    p = FIELDS[field]
    f = create_field_ops(p)
    vals, up = _values(p, 5)
    x = _port_planes(f, vals, up)
    e = (f.sqrt_q_odd - 1) // 2
    assert f.unpack(f.exp_const(x, e), from_mont=True) == [pow(v, e, p) for v in vals]
    assert f.unpack(f.exp_const(x, 0), from_mont=True) == [1] * len(vals)
    assert f.unpack(f.inv(x), from_mont=True) == [pow(v, -1, p) if v else 0 for v in vals]
    root, ok = f.sqrt(x)
    for v, r, sq in zip(vals, f.unpack(root, from_mont=True), ok.tolist()):
        assert sq == (v == 0 or pow(v, (p - 1) // 2, p) == 1)
        assert r * r % p == v if sq else r == 0
    assert sum(ok.tolist()) not in (0, len(vals))
    assert all(v < 2 * p for v in interop.planes_to_ints(root.numpy(), 32))


def test_cpu_tensors_launch_no_kernel():
    f = create_field_ops(ED_ON_BLS12_377.modulus)
    kernels.reset_launch_counts()
    x = _port_planes(f, *_values(f.p, 2))
    f.inv(x)
    f.sqr_n(x, 3)
    f.sqrt(x)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError):
        f.exp_const(x, -1)
    with pytest.raises(ValueError):
        f.exp_ladder(x, 0)
