"""montgomery_tpu_torch field layer against montgomery_tpu and the oracle.

Inputs are drawn from numpy with a fixed seed and passed to both packages
through `montgomery_tpu_torch.interop`, so both see the same canonical
values; results are compared as canonical integers (tolerance zero). The
JAX side runs eagerly in the suite's callback kernel mode.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu.scalar.device import ints_to_limbs_np as jax_ints_to_limbs
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.concrete import example_fields
from montgomery_tpu_torch.ops import alt_mul, divstep, kernels
from montgomery_tpu_torch.ops.field import (EXP_LADDER, MONT_MUL, MONT_SQR, MUL_CONST, SQR_N, SQRT_WIN,
                                            SQRT_WINDOW, Plain16, create_field_ops, ladder_schedule,
                                            ladder_steps)
from montgomery_tpu_torch.scalar.device import ints_to_limbs_np

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = BLS12_377.modulus
W_JAX = 13
# the field kernels (every one with FieldParams but divstep_inv_mont's mu),
# instantiated at 1, 2 and 3 limbs too
SMALL_FIELD_KERNELS = (MONT_MUL, MONT_SQR, MUL_CONST, EXP_LADDER, SQR_N, SQRT_WIN)


def _rand_below(rng: np.random.Generator, bound: int, n: int) -> list[int]:
    nb = (bound.bit_length() + 7) // 8 + 8
    raw = rng.bytes(n * nb)
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % bound for i in range(n)]


@pytest.fixture(scope="module")
def ctx():
    jf = jax_field_ops(P, w=W_JAX)
    f = create_field_ops(P)
    rng = np.random.default_rng(1234)
    boundary = [0, 1, 2, P - 1, P, P + 1, 2 * P - 1]
    xs = boundary + _rand_below(rng, 2 * P, 9)
    ys = _rand_below(rng, 2 * P, len(boundary)) + boundary[::-1] + _rand_below(rng, 2 * P, 2)
    return jf, f, xs, ys[: len(xs)]


def _jax_planes(jf, values):
    return jcodec.pack(values, jf.mp)


def _jax_ints(arr):
    return interop.planes_to_ints(np.asarray(arr), W_JAX)


def test_codec_roundtrip(ctx):
    _, f, xs, _ = ctx
    planes = codec.pack(xs, f.n)
    assert planes.dtype == np.int32 and planes.shape == (12, len(xs))
    assert codec.unpack(planes) == xs
    assert codec.unpack(torch.from_numpy(planes)) == xs
    blob = codec.ints_to_bytes(xs, 48)
    assert (codec.bytes_to_limbs(blob, 48, 32, 12) == planes).all()


def test_scalar_limbs_match_jax():
    rng = np.random.default_rng(5)
    q = BLS12_377.order
    vals = [0, 1, q - 1] + _rand_below(rng, q, 13)
    bq = q.bit_length()
    assert (ints_to_limbs_np(vals, bq, 13, 20) == jax_ints_to_limbs(vals, bq, 13, 20)).all()


def test_interop_roundtrip(ctx):
    jf, f, xs, _ = ctx
    rj = 1 << (W_JAX * jf.n)
    jplanes = _jax_planes(jf, [x % P * rj % P for x in xs])  # JAX Montgomery form
    t = interop.field_from_jax(jplanes, f, device="cpu")
    assert f.unpack(t, from_mont=True) == [x % P for x in xs]
    back = interop.field_to_jax(t, f, jf.n)
    assert [v * pow(rj, -1, P) % P for v in _jax_ints(back)] == [x % P for x in xs]
    assert interop.ints_to_planes(xs, W_JAX, jf.n).tolist() == _jax_planes(jf, xs).tolist()


@pytest.mark.parametrize("op", ["add", "sub", "neg", "reduce", "add_lazy", "sub_lazy"])
def test_add_sub_family(ctx, op):
    """Raw (non-Montgomery) planes, values in [0, 2p): the same canonical
    result in both packages, within the same bounds."""
    jf, f, xs, ys = ctx
    one = op in ("neg", "reduce")
    jargs = [_jax_planes(jf, xs)] + ([] if one else [_jax_planes(jf, ys)])
    targs = [torch.from_numpy(codec.pack(xs, f.n))] + ([] if one else [torch.from_numpy(codec.pack(ys, f.n))])
    got_j = _jax_ints(getattr(jf, op)(*jargs))
    got_t = codec.unpack(getattr(f, op)(*targs))
    expect = {
        "add": lambda x, y: x + y, "sub": lambda x, y: x - y, "neg": lambda x, y: -x,
        "reduce": lambda x, y: x, "add_lazy": lambda x, y: x + y,
        "sub_lazy": lambda x, y: x - y + 4 * P,
    }[op]
    bound = {"reduce": P, "add_lazy": 4 * P, "sub_lazy": 6 * P}.get(op, 2 * P)
    for x, y, a, b in zip(xs, ys, got_t, got_j):
        assert a % P == b % P == expect(x, y) % P
        assert a < bound
        if op in ("add_lazy", "sub_lazy", "reduce"):
            assert a == b == expect(x, y) % (1 << 384) or op == "reduce"


def test_mul_montgomery(ctx):
    """x*y in Montgomery form in both packages -> the same canonical x*y."""
    jf, f, xs, ys = ctx
    rj = 1 << (W_JAX * jf.n)
    jx = _jax_planes(jf, [x % P * rj % P for x in xs])
    jy = _jax_planes(jf, [y % P * rj % P for y in ys])
    tx, ty = interop.field_from_jax(jx, f, device="cpu"), interop.field_from_jax(jy, f, device="cpu")
    jz = np.asarray(jf.mul(jx, jy))
    tz = f.mul(tx, ty)
    via_jax = f.unpack(interop.field_from_jax(jz, f, device="cpu"), from_mont=True)
    assert f.unpack(tz, from_mont=True) == via_jax == [x * y % P for x, y in zip(xs, ys)]
    assert all(v < 2 * P for v in codec.unpack(tz))
    (tz2,) = f.mul_list([(tx, ty)])
    assert torch.equal(tz2, tz)


def test_mul_raw_boundary(ctx):
    """Unreduced raw planes up to 6p: x*y/R mod p, output below 2p."""
    _, f, xs, ys = ctx
    big = [x + 4 * P if x < 2 * P else x for x in xs]
    t = f.mul(torch.from_numpy(codec.pack(big, f.n)), torch.from_numpy(codec.pack(ys, f.n)))
    out = codec.unpack(t)
    assert [v % P for v in out] == [x * y * f.R_inv % P for x, y in zip(big, ys)]
    assert all(v < 2 * P for v in out)


@pytest.mark.parametrize("const", ["beta", "R2", "one"])
def test_mul_const(ctx, const):
    jf, f, xs, _ = ctx
    rj = 1 << (W_JAX * jf.n)
    beta = BLS12_377.endomorphism.beta
    jx = _jax_planes(jf, xs)
    tx = torch.from_numpy(codec.pack(xs, f.n))
    if const == "beta":  # x times beta's Montgomery form: x * beta in both
        jres = jf.mul_const(jx, jcodec.pack_scalar(beta * rj % P, jf.mp))
        tres = f.mul_const(tx, beta * f.R % P)
        got_j = [v % P for v in _jax_ints(jres)]
        got_t = [v % P for v in codec.unpack(tres)]
        expect = [x * beta % P for x in xs]
    elif const == "R2":  # to_montgomery
        got_j = [v * pow(rj, -1, P) % P for v in _jax_ints(jf.to_montgomery(jx))]
        got_t = f.unpack(f.to_montgomery(tx), from_mont=True)
        expect = [x % P for x in xs]
    else:  # from_montgomery: mul_const by 1, then reduce
        got_j = [v * rj % P for v in _jax_ints(jf.from_montgomery(jx))]
        tres = f.from_montgomery(tx)
        assert all(v < P for v in codec.unpack(tres))
        got_t = [v * f.R % P for v in codec.unpack(tres)]
        expect = [x % P for x in xs]
    assert got_t == got_j == expect


# ---------------------------------------------------------------- example fields

EXAMPLE_FIELDS = example_fields()
SHIFTS = (0, 1, 31, 255)


def _example_inputs(p: int, seed: int) -> tuple[list[int], list[int]]:
    """x and y in [0, 2p): 0, 1, p - 1 and the unreduced range [p, 2p)
    (p, p + 1, 2p - 1 and random values there), then random values below p."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 1]
    xs = edge + [p + v for v in _rand_below(rng, p, 4)] + _rand_below(rng, p, 6)
    ys = edge[::-1] + _rand_below(rng, 2 * p, 10)
    return xs, ys


@pytest.mark.parametrize("name", list(EXAMPLE_FIELDS))
def test_example_field_ops(name):
    """add_no_reduce, sub_positive and left_shift on each of the thirteen
    example fields (n = 1 to 13 limbs), against Python ints: exact values
    for the unreduced sums and differences, canonical values below 2p for
    the shifts."""
    p = EXAMPLE_FIELDS[name].p
    f = create_field_ops(p)
    assert f.n == -(-(p.bit_length() + 6) // 32)
    xs, ys = _example_inputs(p, 97)
    X, Y = (torch.from_numpy(codec.pack(v, f.n)) for v in (xs, ys))
    assert codec.unpack(f.add_no_reduce(X, Y)) == [x + y for x, y in zip(xs, ys)]
    assert codec.unpack(f.sub_positive(X, Y)) == [x - y + 2 * p for x, y in zip(xs, ys)]
    assert all(v < 4 * p for v in codec.unpack(f.sub_positive(X, Y)))
    for k in SHIFTS:
        out = codec.unpack(f.left_shift(X, k))
        assert [v % p for v in out] == [x * pow(2, k, p) % p for x in xs], k
        assert all(v < 2 * p for v in out)
    with pytest.raises(ValueError):
        f.left_shift(X, -1)


@pytest.mark.parametrize("name", ["small", "secp256k1", "bls12377"])
def test_example_field_ops_match_jax(name):
    """The same ops equal, as canonical values, the JAX package's jitted
    create_field_ops(p, w=13) functions (one program a field: each compiles
    its own kernels)."""
    import jax

    p = EXAMPLE_FIELDS[name].p
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    xs, ys = _example_inputs(p, 98)
    run = jax.jit(lambda x, y: (jf.add_no_reduce(x, y), jf.sub_positive(x, y),
                                *[jf.left_shift(x, k) for k in SHIFTS]))
    jout = run(jcodec.pack(xs, jf.mp), jcodec.pack(ys, jf.mp))
    X, Y = (torch.from_numpy(codec.pack(v, f.n)) for v in (xs, ys))
    tout = [f.add_no_reduce(X, Y), f.sub_positive(X, Y), *[f.left_shift(X, k) for k in SHIFTS]]
    for t, j in zip(tout, jout, strict=True):
        assert [v % p for v in codec.unpack(t)] == [v % p for v in _jax_ints(j)]


@pytest.mark.parametrize("name", ["small", "goldilocks", "f25519", "bls12381"])
def test_byte_codec_matches_jax(name):
    """pack_bytes / to_bytes: the reference's packed little-endian bytes,
    ceil(bits(p) / 8) an element, round-trip and agree with the JAX codec;
    a wrong length and a value too wide for the bytes raise."""
    p = EXAMPLE_FIELDS[name].p
    f, jf = create_field_ops(p), jax_field_ops(p, w=W_JAX)
    nb = f.n_packed_bytes
    assert nb == jf.mp.n_packed_bytes == -(-p.bit_length() // 8)
    vals = [0, 1, p - 1] + _rand_below(np.random.default_rng(99), p, 9)
    data = b"".join(v.to_bytes(nb, "little") for v in vals)
    planes = codec.pack_bytes(data, f, len(vals))
    assert planes.shape == (f.n, len(vals)) and codec.unpack(planes) == vals
    assert _jax_ints(jcodec.pack_bytes(data, jf.mp, len(vals))) == vals
    assert codec.to_bytes(planes, f) == codec.to_bytes(torch.from_numpy(planes), f) == data
    assert jcodec.to_bytes(jcodec.pack_bytes(data, jf.mp, len(vals)), jf.mp) == data
    with pytest.raises(ValueError):
        codec.pack_bytes(data[:-1], f, len(vals))
    with pytest.raises(OverflowError):
        codec.to_bytes(codec.pack([1 << (8 * nb)], f.n), f)


@pytest.mark.parametrize("lanes", [1, 5, 512, 513])
def test_plain_product_int_path(lanes):
    """Plain16.mul runs CPU products of up to INT_LANES lanes on Python ints:
    bit for bit the row loop's values (which wider products and CUDA tensors
    take), on random limbs and all-ones limbs, for 1 to 13 limbs."""
    rng = np.random.default_rng(lanes)
    for name in ("small", "goldilocks", "pastaFp", "bls12377", "bls12381"):
        F = create_field_ops(EXAMPLE_FIELDS[name].p).plain
        x = torch.from_numpy(rng.integers(0, 1 << 16, size=(F.L, lanes)))
        y = torch.from_numpy(rng.integers(0, 1 << 16, size=(F.L, lanes)))
        x[:, 0] = y[:, 0] = 0xFFFF
        row_loop = Plain16(F.p, F.L)
        row_loop.INT_LANES = 0
        assert torch.equal(F.mul(x, y), row_loop.mul(x, y))
        assert torch.equal(F.mul(x[:, :1], y), row_loop.mul(x[:, :1], y))  # broadcast
        assert F.mul(x, y).is_contiguous()


def test_kernels_refuse_small_fields():
    """A field whose limb count no kernel was built for (2^127 - 1 at 5
    limbs, a 100-bit prime at 4) gets no launch parameters: a CUDA tensor of
    such a field raises NotImplementedError before any launch instead of
    running elsewhere. The 1-3 limb example fields have their kernels."""
    for p in ((1 << 127) - 1, (1 << 100) - 15):
        f = create_field_ops(p)
        assert f.n in (4, 5)
        for kernel in SMALL_FIELD_KERNELS:
            with pytest.raises(NotImplementedError):
                f.field_words(kernel)
        with pytest.raises(NotImplementedError):
            kernels.check_limbs(divstep.DIVSTEP_INV, f.n)
        with pytest.raises(NotImplementedError):
            kernels.check_limbs(alt_mul.BARRETT_MUL, f.n)
    for name in ("small", "babybear", "goldilocks"):
        f = create_field_ops(EXAMPLE_FIELDS[name].p)
        assert f.n in kernels.FIELD_LIMBS and all(f.n in k.symbols for k in SMALL_FIELD_KERNELS)


@pytest.fixture
def fake_card(monkeypatch):
    """Tensors taken for CUDA ones, a fake kernel library that records each
    entry point's name and arguments, and recorders in place of torch.cuda's
    device scope and stream; launch counts start at 0."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels.LIBRARY, "get", lambda: Library())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=66))
    for k in kernels.REGISTRY.values():
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    return calls


@pytest.mark.parametrize("name", ["small", "babybear", "goldilocks"])
def test_small_field_launches_reach_their_entry_points(fake_card, name):
    """On a 1-3 limb field each of the nine kernels' launches reaches
    msm_<stem>_n<n> with its planes, the field's FieldParams (p, 2p, 4p and
    mu: 3n + 1 words) where the kernel takes them, its other constants
    (mul_const's c, the ladder's steps, sqr_n's m, the sqrt window's lk,
    divstep's and Barrett's configs), the lane count and the stream; each
    launch is counted under n limbs."""
    p = EXAMPLE_FIELDS[name].p
    f = create_field_ops(p)
    n, N = f.n, 7
    fw = codec.to_words(p, n) + codec.to_words(2 * p, n) + codec.to_words(4 * p, n) + [f.mu]
    x = f.pack_raw([1, 2, 3, p - 1, p, p + 1, 2 * p - 1], "cpu")
    y = f.pack_raw([5] * N, "cpu")
    sched = ladder_schedule(p - 2, f.ladder_window)
    lk = min(SQRT_WINDOW, f.sqrt_M)
    bp = alt_mul.barrett_params(f)
    xp = x.data_ptr()
    runs = [
        ("mont_mul", lambda: f.mul(x, y), lambda a: (a[1].value, a[2], a[3].value, a[4]) == (xp, N, y.data_ptr(), N)),
        ("mont_sqr", lambda: f.square(x), lambda a: (a[1].value, a[2]) == (xp, N)),
        ("mul_const", lambda: f.left_shift(x, 3), lambda a: list(a[2]) == codec.to_words(8 * f.R % p, n)),
        ("exp_ladder", lambda: f.inv(x), lambda a: list(a[2])[:a[3]] == ladder_steps(sched)),
        ("sqr_n", lambda: f.sqr_n(x, 5), lambda a: a[2] == 5),
        ("sqrt_win", lambda: f.sqrt_window(x, x, x, 0, lk, lk >= f.sqrt_M),
         lambda a: (a[7], a[8]) == (lk, int(lk >= f.sqrt_M))),
        ("divstep_inv_mont", lambda: f.inv_root(x), lambda a: a[3] is f.inv_params.kernel_words),
        ("divstep_inv", lambda: divstep.inv_divstep(f.inv_params, x), lambda a: a[3] is f.inv_params.kernel_words),
        ("barrett_mul", lambda: alt_mul.barrett_mul(bp, x, y), lambda a: a[5] is bp.kernel_words),
    ]
    field_arg = {"mont_mul": 5, "mont_sqr": 3, "mul_const": 3, "exp_ladder": 5, "sqr_n": 3, "sqrt_win": 9,
                 "divstep_inv_mont": 4}
    for stem, run, check in runs:
        fake_card.clear()
        run()
        ((symbol, args),) = fake_card
        assert symbol == f"msm_{stem}_n{n}", stem
        assert args[-1] == 66 and args[-2 if stem != "divstep_inv_mont" else -3] == N, stem
        if stem in field_arg:
            assert len(args[field_arg[stem]]) == 3 * n + 1 and list(args[field_arg[stem]]) == fw, stem
        assert check(args), stem
        assert kernels.REGISTRY[stem].launches_by_n == {n: 1}, stem
