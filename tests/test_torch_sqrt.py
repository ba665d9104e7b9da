"""montgomery_tpu_torch exponentiation and square roots against montgomery_tpu.

`FieldOps.exp_const`, `inv`, `sqr_n` and `sqrt` run the kernels
`exp_ladder`, `sqr_n` and `sqrt_win` on the card; here, on CPU tensors, their
plain versions run. The JAX package's generators and its eager sqrt are slow
on this CPU at the curve fields (tens of seconds a call), so the whole-op
comparisons with it run at Goldilocks (p = 2^64 - 2^32 + 1, M = 32: every
window of the discrete log is full) and the per-window formula is compared at
every window of the four curve fields (eagerly: the first window of a field
compiles the JAX side's operations, 7-21 s, every later one runs in about a
second). Inputs are drawn from numpy
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
from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.ops import kernels
from montgomery_tpu_torch.ops.field import (SQRT_WINDOW, create_field_ops, ladder_entries, ladder_products,
                                            ladder_schedule, ladder_steps)

torch.set_num_threads(1)

W_JAX = 13
GOLDILOCKS = 2**64 - 2**32 + 1
FIELDS = {"bls12-377": BLS12_377.modulus, "ed-on-bls12-377": ED_ON_BLS12_377.modulus,
          "goldilocks": GOLDILOCKS}
ALL_FIELDS = {"bls12-377": BLS12_377.modulus, "ed-on-bls12-377": ED_ON_BLS12_377.modulus,
              "pallas": PALLAS.modulus, "bls12-381": BLS12_381.modulus}
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


@pytest.mark.parametrize("e", [0, 1, 2, 5, "sqrt", "p-2", "3R+5"])
def test_exp_const_goldilocks(gold, e):
    f, jf, vals, x, jx = gold
    p = f.p
    e = {"sqrt": (f.sqrt_q_odd - 1) // 2, "p-2": p - 2, "3R+5": 3 * f.R + 5}.get(e, e)
    got = f.unpack(f.exp_const(x, e), from_mont=True)
    assert got == _jax_canon(jf, jf.exp_const(jx, e)) == [pow(v, e, p) for v in vals]


@pytest.mark.parametrize("e", ["R", "3R+5", "2^300", "p-2", "R-1"])
def test_exp_const_any_exponent_pallas(e):
    """exp_const takes any e >= 0 (R = 2^288 at Pallas's 9 limbs): e >= p
    runs as (e - 1) mod (p - 1) + 1, equal to pow() on 0, 1, 2, 12345 and
    p - 1 with [p, 2p) representatives; an e below p keeps its own schedule,
    exp_ladder's words."""
    f = create_field_ops(PALLAS.modulus)
    p, R = f.p, f.R
    assert R == 1 << 288
    e = {"R": R, "3R+5": 3 * R + 5, "2^300": 1 << 300, "p-2": p - 2, "R-1": R - 1}[e]
    vals = [0, 1, 2, 12345, p - 1]
    x = _port_planes(f, vals, [i % 2 == 1 for i in range(len(vals))])
    got = f.exp_const(x, e)
    assert f.unpack(got, from_mont=True) == [pow(v, e, p) for v in vals]
    if e < p:
        assert torch.equal(got, f.exp_ladder(x, e))
    elif e >= R:
        with pytest.raises(ValueError):
            f.exp_ladder(x, e)


def _exponents(f) -> dict:
    """The ladder's exponents: small ones, 2^k and 2^k - 1 (a long zero
    tail, a run of ones), p - 2 (inv), (q - 1) / 2 (sqrt's first launch)
    and q."""
    p, q = f.p, f.sqrt_q_odd
    return {"1": 1, "2": 2, "3": 3, "2^k": 1 << (p.bit_length() - 2), "2^k-1": (1 << (p.bit_length() - 2)) - 1,
            "p-2": p - 2, "(q-1)/2": (q - 1) // 2, "q": q}


@pytest.mark.parametrize("w", [2, 3, 4, 5])
@pytest.mark.parametrize("field", ["goldilocks", "bls12-377"])
def test_ladder_schedule_against_pow(field, w):
    """ladder_schedule(e, w) rebuilds e (e = e 2^s + d over its steps), its
    first step squares nothing, every digit is odd and below 2^w but a
    trailing 0, each window's squarings cover its digit; the kernel's step
    words hold the same steps; exp_ladder_plain on it equals pow() on 0, 1,
    p - 1, squares and random values with [p, 2p) representatives."""
    p = FIELDS[field]
    f = create_field_ops(p)
    vals, up = _values(p, 7)
    x = _port_planes(f, vals, up)
    for tag, e in _exponents(f).items():
        sched = ladder_schedule(e, w)
        acc = 0
        for s, d in sched:
            assert d < 1 << w and (d % 2 == 1 or (d == 0 and (s, d) == sched[-1]))
            assert d < 1 << s or (s, d) == sched[0]
            acc = (acc << s) + d
        assert acc == e and sched[0][0] == 0, tag
        assert ladder_steps(sched) == [s << 5 | d for s, d in sched]
        assert ladder_entries(sched) == (max(d for _, d in sched) + 1) // 2
        got = f.unpack(f.exp_ladder(x, e, w=w), from_mont=True)
        assert got == [pow(v, e, p) for v in vals], tag
    assert ladder_schedule(1 << 40, w) == ((0, 1), (40, 0))
    assert ladder_products(1 << 40, w) == 40


def test_exp_ladder_window_against_jax_goldilocks(gold):
    """The port's ladder at every window against the JAX package's
    exp_ladder (2-bit digits) on the same values: equal canonical values
    (tolerance zero) for every exponent of _exponents."""
    f, jf, vals, x, jx = gold
    for tag, e in _exponents(f).items():
        want = _jax_canon(jf, jf.exp_ladder(jx, e))
        assert want == [pow(v, e, f.p) for v in vals], tag
        for w in (2, 3, 4, 5):
            assert f.unpack(f.exp_ladder(x, e, w=w), from_mont=True) == want, (tag, w)


def test_ladder_schedule_refuses():
    with pytest.raises(ValueError):
        ladder_schedule(0, 4)
    for w in (1, 6):
        with pytest.raises(ValueError):
            ladder_schedule(5, w)


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


def _generator(f) -> int:
    """g = z^q for the least non-residue z, from Python's ints alone."""
    p, z = f.p, 2
    while pow(z, (p - 1) // 2, p) == 1:
        z += 1
    return pow(z, f.sqrt_q_odd, p)


def _window_state(f, k: int, lk: int, seed: int, lanes: int = 12):
    """Canonical (t, r, s) for window k in the state the earlier windows
    leave: t = g^a with the low 4k bits of a zero, s = t^(2^(M - 4k - lk)) =
    zeta^d for the window's digit d; lane 0 has d = 0, lane 1 d = 2^lk - 1,
    lane 2 d = 1 (at k = 0 an odd exponent: a non-square), the rest random
    bits above and in the window; r random."""
    p, M = f.p, f.sqrt_M
    g = _generator(f)
    rng = random.Random(seed)
    lo, hi = SQRT_WINDOW * k, SQRT_WINDOW * k + lk
    ts, rs = [], []
    for i in range(lanes):
        d = {0: 0, 1: (1 << lk) - 1, 2: 1}.get(i, rng.randrange(1 << lk))
        a = (rng.randrange(1 << (M - hi)) << hi) | (d << lo)
        ts.append(pow(g, a, p))
        rs.append(rng.randrange(p))
    return ts, rs, [pow(t, 1 << (M - hi), p) for t in ts]


def _windows(M: int):
    """(k, lk, last) of every window of a discrete log of M bits."""
    return [(k, min(SQRT_WINDOW, M - SQRT_WINDOW * k), SQRT_WINDOW * (k + 1) >= M)
            for k in range(-(-M // SQRT_WINDOW))]


@pytest.mark.parametrize("field", ["bls12-377", "ed-on-bls12-377", "pallas", "bls12-381"])
def test_sqrt_window_plain_against_jax(field):
    """sqrt_window_plain (the table lookup) and the JAX package's
    _sqrt_window_formula (bit by bit) on the same (t, r, s), at every window
    of the field's discrete log: 12 at BLS12-377 (M = 46, the last of
    lk = 2), 12 at ed-on-bls12-377 (M = 47, lk = 3), 8 at Pallas (M = 32),
    and BLS12-381's one window (M = 1, lk = 1). Equal t', r' as canonical
    values and equal digits, d = 0 and d = 2^lk - 1 among them; a quarter
    of the lanes hold [p, 2p) representatives; the last window leaves t as
    it was."""
    p = ALL_FIELDS[field]
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    M = f.sqrt_M
    wins = _windows(M)
    assert (M, len(wins), wins[-1][1]) == {"bls12-377": (46, 12, 2), "ed-on-bls12-377": (47, 12, 3),
                                          "pallas": (32, 8, 4), "bls12-381": (1, 1, 1)}[field]
    for k, lk, last in wins:
        ts, rs, ss = _window_state(f, k, lk, seed=100 * k + lk)
        up = [i % 4 == 1 for i in range(len(ts))]
        t2, r2, dig = f.sqrt_window_plain(*[_port_planes(f, v, up) for v in (ts, rs, ss)], k, lk, last)
        jt, jr, jd = jf._sqrt_window_formula(k, lk, M, last)(*[_jax_planes(jf, v, up)
                                                               for v in (ts, rs, ss)])
        assert f.unpack(t2, from_mont=True) == _jax_canon(jf, jt), k
        assert f.unpack(r2, from_mont=True) == _jax_canon(jf, jr), k
        assert dig.tolist() == np.asarray(jd).tolist(), k
        assert dig[0, :3].tolist() == [0, (1 << lk) - 1, 1], k
        if last:
            assert f.unpack(t2, from_mont=True) == ts


@pytest.mark.parametrize("field", ["bls12-377", "ed-on-bls12-377", "pallas", "bls12-381"])
def test_sqrt_window_rows_against_pow(field):
    """Every window's rows against pow() on Python's ints: the t rows
    g^(-d 2^(4k)), the r rows g^(-floor(d 2^(4k) / 2)) and the compare values
    zeta^d, zeta = g^(2^(M - lk)) of order exactly 2^lk (so 2^lk distinct
    values), all canonical Montgomery forms; the launch's buffer holds them
    row by row."""
    p = ALL_FIELDS[field]
    f = create_field_ops(p)
    M, g = f.sqrt_M, _generator(f)
    assert pow(g, 1 << M, p) == 1 and pow(g, 1 << (M - 1), p) == p - 1
    for k, lk, _ in _windows(M):
        rows = f.sqrt_window_rows(k, lk)
        assert all(v < p for v in rows)
        canon = [v * f.R_inv % p for v in rows]
        ds, sh = range(1 << lk), SQRT_WINDOW * k
        assert canon[:1 << lk] == [pow(g, -(d << sh), p) for d in ds]
        assert canon[1 << lk:2 << lk] == [pow(g, -((d << sh) >> 1), p) for d in ds]
        zeta = pow(g, 1 << (M - lk), p)
        assert pow(zeta, 1 << (lk - 1), p) == p - 1
        assert canon[2 << lk:] == [pow(zeta, d, p) for d in ds] and len(set(canon[2 << lk:])) == 1 << lk
        buf = f.sqrt_window_table(k, lk, "cpu")
        assert buf.dtype == torch.int32 and tuple(buf.shape) == (3 * f.n << lk,)
        assert interop.planes_to_ints(buf.reshape(3 << lk, f.n).T.numpy(), 32) == list(rows)
    with pytest.raises(ValueError):
        f.sqrt_window_rows(len(_windows(M)), 1)


def test_sqrt_window_plain_no_matching_row():
    """A lane whose s matches no compare value (not the state the earlier
    windows leave: here 0, a random value, and a root of unity of order 32,
    which no 4-bit window holds) gets digit -1 and t, r back bit for bit;
    the other lanes of the same call are solved as usual."""
    f = create_field_ops(BLS12_377.modulus)
    p, k, lk = f.p, 2, 4
    ts, rs, ss = _window_state(f, k, lk, seed=3)
    bad = {3: 0, 5: random.Random(5).randrange(p), 7: pow(_generator(f), 1 << (f.sqrt_M - 5), p)}
    for i, v in bad.items():
        ss[i] = v
    t, r, s = [_port_planes(f, v, [i % 4 == 1 for i in range(len(v))]) for v in (ts, rs, ss)]
    t2, r2, dig = f.sqrt_window_plain(t, r, s, k, lk, False)
    miss = sorted(i for i, d in enumerate(dig[0].tolist()) if d < 0)
    assert miss == sorted(bad)
    for out, inp in ((t2, t), (r2, r)):
        assert torch.equal(out[:, miss], inp[:, miss])
    good = [i for i in range(len(ts)) if i not in bad]
    want, _, _ = f.sqrt_window_plain(t[:, good], r[:, good], s[:, good], k, lk, False)
    assert torch.equal(t2[:, good], want)
    assert all(0 <= d < 1 << lk for d in dig[0, good].tolist())


@pytest.mark.parametrize("field", ["bls12-377", "ed-on-bls12-377", "pallas", "bls12-381"])
def test_exp_inv_sqrt_against_pow(field):
    """At the curve fields (the plain versions alone): exp_const, inv and
    sqrt against pow() and Euler's criterion, on [0, 2p) representatives."""
    p = ALL_FIELDS[field]
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
