"""montgomery_tpu_torch inversion chain against montgomery_tpu: the Montgomery
product (`mont_mul`), the batch inversion tree, the divstep root and the
public divstep inverses (`inv_divstep`, `inv_mont_divstep`); then the 32-bit
safegcd core's plain version on BLS12-377, BLS12-381, Pallas and
ed-on-bls12-377, the bounds its limbs and sums keep, and its exit once g = 0.

Inputs come from numpy with fixed seeds plus the edge values 0, 1, p - 1 and
unreduced representatives in [p, 2p); both packages get the same canonical
values through `montgomery_tpu_torch.interop` and results are compared as
canonical integers (tolerance zero). The JAX side runs eagerly in the suite's
callback kernel mode. Port tensors live on the CPU, so the plain versions run.
"""

import contextlib
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu.concrete import BLS12_377
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.divstep import divstep_params as jax_divstep_params
from montgomery_tpu.ops.divstep import inv_divstep as jax_inv_divstep
from montgomery_tpu.ops.divstep import inv_mont_divstep as jax_inv_mont_divstep
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.concrete import BLS12_381, ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.ops import divstep, kernels
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import MUL_CONST, create_field_ops

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = BLS12_377.modulus
W_JAX = 13


def _rand_below(rng: np.random.Generator, bound: int, n: int) -> list[int]:
    nb = (bound.bit_length() + 7) // 8 + 8
    raw = rng.bytes(n * nb)
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % bound for i in range(n)]


WIDTHS = (1, 17, 513)  # 513 crosses the tree's 512 stop with an odd level


@pytest.fixture(scope="module")
def fields():
    return jax_field_ops(P, w=W_JAX), create_field_ops(P)


def _jax_mont(jf, values):
    """JAX Montgomery planes of the given canonical values."""
    rj = 1 << (W_JAX * jf.n)
    return jcodec.pack([v % P * rj % P for v in values], jf.mp)


def _from_jax(jf, f, arr) -> list[int]:
    return f.unpack(interop.field_from_jax(np.asarray(arr), f, device="cpu"), from_mont=True)


@pytest.fixture(scope="module")
def cases(fields):
    """Per width: inputs xs, ys and the JAX package's mul(xs, ys) and
    batch_inv(xs) on them. The JAX side runs once, jitted, over all widths'
    lanes side by side (531 lanes: its tree crosses the 512 stop too), since
    its CPU root inversion is a slow Fermat ladder; the products and
    inverses are lane-wise, so each width reads its own lanes."""
    jf, _ = fields
    out = {}
    for width in WIDTHS:
        rng = np.random.default_rng(width)
        xs = ([1, P - 1, 2] + _rand_below(rng, P - 1, width))[:width]
        out[width] = ([x or 1 for x in xs], _rand_below(rng, P, width))
    X = _jax_mont(jf, [x for xs, _ in out.values() for x in xs])
    Y = _jax_mont(jf, [y for _, ys in out.values() for y in ys])
    jz, jinv = [np.asarray(a) for a in jax.jit(lambda x, y: (jf.mul(x, y), jf.batch_inv(x)))(X, Y)]
    res, off = {}, 0
    for width, (xs, ys) in out.items():
        res[width] = (xs, ys, jz[:, off:off + width], jinv[:, off:off + width])
        off += width
    return res


@pytest.mark.parametrize("width", WIDTHS)
def test_mul_matches_jax(fields, cases, width):
    jf, f = fields
    xs, ys, jz, _ = cases[width]
    xs = [0, *xs[1:]]  # a zero lane (the JAX product of lane 0 is 1 * y)
    tx = f.pack(xs, device="cpu", to_mont=True)
    ty = f.pack(ys, device="cpu", to_mont=True)
    tz = f.mul(tx, ty)
    want = [x * y % P for x, y in zip(xs, ys)]
    assert f.unpack(tz, from_mont=True) == want
    assert _from_jax(jf, f, jz)[1:] == want[1:]
    assert torch.equal(tz, f.mul_plain(tx, ty))
    assert all(v < 2 * P for v in codec.unpack(tz))
    # a broadcast operand (one constant plane) gives the same products
    c = f.const_plane(f.R2, tx)
    assert f.unpack(f.mul(tx, c), from_mont=True) == f.unpack(f.to_montgomery(tx), from_mont=True)


@pytest.mark.parametrize("width", [*WIDTHS, 1031])
def test_batch_inv_matches_jax(fields, cases, width):
    """Widths across the 512 stop, with odd levels (513 -> 257; 1031 ->
    515 -> 258); every third input an unreduced representative in [p, 2p)."""
    jf, f = fields
    if width in cases:
        xs, _, _, jinv = cases[width]
    else:
        xs = [x or 1 for x in _rand_below(np.random.default_rng(width), P, width)]
    tx = f.pack_raw([x * f.R % P + (P if i % 3 == 0 else 0) for i, x in enumerate(xs)], "cpu")
    got = f.unpack(f.batch_inv(tx), from_mont=True)
    want = [pow(x, -1, P) for x in xs]
    assert got == want
    if width in cases:
        assert _from_jax(jf, f, jinv) == want


def test_batch_inv_handle_zero(fields):
    _, f = fields
    xs = [0, 5, 0, 0, 7, P - 1]
    raw = [x * f.R % P for x in xs]
    raw[2] = P  # an unreduced zero
    raw[5] += P
    got = f.unpack(f.batch_inv(f.pack_raw(raw, "cpu"), handle_zero=True), from_mont=True)
    assert got == [pow(x, -1, P) if x else 0 for x in xs]


def test_divstep_constants():
    f = create_field_ops(P)
    dp = divstep.divstep_params(f)
    assert divstep.iterations(P.bit_length()) == dp.iters == 1091
    assert dp.n_batches == -(-1091 // divstep.BATCH) == 37
    assert (dp.pinv * P + 1) % (1 << divstep.LIMB_BITS) == 0
    assert len(dp.kernel_words) == divstep.kernel_limbs(f.n) * (1 + divstep.SHIFTS) + f.n + 2


@pytest.fixture(scope="module")
def divstep_cases(fields):
    """Inputs of the two divstep tests and the JAX package's `inv_divstep`
    (plain values) and `inv_mont_divstep` (Montgomery values) on them, from
    one jitted program."""
    jf, _ = fields
    rng = np.random.default_rng(7)
    plain = [0, 1, 2, P - 1, P - 2, P // 2, 1 << 255] + _rand_below(rng, P, 9)
    mont = [0, 1, P - 1] + _rand_below(rng, P, 13)
    jdp = jax_divstep_params(jf)
    zp, zm = jax.jit(lambda a, b: (jax_inv_divstep(jdp, a), jax_inv_mont_divstep(jdp, b)))(
        jcodec.pack(plain, jf.mp), _jax_mont(jf, mont))
    return plain, np.asarray(zp), mont, np.asarray(zm)


def test_divstep_plain_matches_jax(fields, divstep_cases):
    """Plain-domain inverse: 0 -> 0, 1, p - 1 and random values, against the
    JAX package's `inv_divstep` and Python's pow."""
    _, f = fields
    xs, jz, _, _ = divstep_cases
    got = codec.unpack(divstep.inv_plain(f.inv_params, f.pack_raw(xs, "cpu")))
    want = [pow(x, -1, P) if x else 0 for x in xs]
    assert got == interop.planes_to_ints(jz, W_JAX) == want


def test_divstep_montgomery_matches_jax(fields, divstep_cases):
    """Montgomery-form inverse (the batch-inversion root) on [0, 2p) inputs:
    zero and its unreduced representative p map to 0."""
    jf, f = fields
    _, _, xs, jz = divstep_cases
    tx = f.pack(xs, device="cpu", to_mont=True)
    unreduced = f.pack_raw([x * f.R % P + P for x in xs], "cpu")
    want = [pow(x, -1, P) if x else 0 for x in xs]
    assert _from_jax(jf, f, jz) == want
    for t in (tx, unreduced):
        out = f.inv_root(t)
        assert f.unpack(out, from_mont=True) == want
        assert all(v < 2 * P for v in codec.unpack(out))
        assert torch.equal(out, divstep.inv_mont_plain(f, t))


def test_inv_divstep_matches_jax(fields, divstep_cases):
    """The public plain-domain inverse (kernel `divstep_inv` on the card,
    `inv_plain` here) against the JAX package's `inv_divstep`, also on a
    batch of two axes."""
    _, f = fields
    xs, jz, _, _ = divstep_cases
    dp = f.inv_params
    x = f.pack_raw(xs, "cpu")
    out = divstep.inv_divstep(dp, x)
    want = [pow(v, -1, P) if v else 0 for v in xs]
    assert codec.unpack(out) == interop.planes_to_ints(jz, W_JAX) == want
    assert torch.equal(divstep.inv_divstep(dp, x.reshape(f.n, 4, 4)), out.reshape(f.n, 4, 4))


def test_inv_mont_divstep_matches_jax(fields, divstep_cases):
    """The public Montgomery-form inverse, composed as the JAX package's
    `inv_mont_divstep` (out of Montgomery form, `inv_divstep`, back), on
    canonical and unreduced [p, 2p) inputs."""
    jf, f = fields
    _, _, xs, jz = divstep_cases
    want = [pow(x, -1, P) if x else 0 for x in xs]
    assert _from_jax(jf, f, jz) == want
    for t in (f.pack(xs, device="cpu", to_mont=True),
              f.pack_raw([x * f.R % P + P for x in xs], "cpu")):
        out = divstep.inv_mont_divstep(f.inv_params, t)
        assert f.unpack(out, from_mont=True) == want
        assert all(v < 2 * P for v in codec.unpack(out))


@pytest.fixture
def fake_card(monkeypatch):
    """Tensors taken for CUDA ones, a fake kernel library that records each
    entry point's name and arguments, and recorders in place of torch.cuda's
    device scope and stream."""
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
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=55))
    for k in (divstep.DIVSTEP_INV, divstep.DIVSTEP_INV_MONT, MUL_CONST):
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    return calls


def test_divstep_inv_kernel_branch_arguments(fake_card):
    """A CUDA tensor goes to msm_divstep_inv (12 limbs), msm_divstep_inv_n13
    (BLS12-381), msm_divstep_inv_n1, _n2, _n3 (the example fields small,
    babybear, goldilocks) or msm_divstep_inv_n9 (9 limbs) with out, x and its
    row stride (a column slice passes its parent's), the DivstepConst words,
    the lane count and the stream; `inv_mont_divstep` launches mul_const,
    divstep_inv, mul_const; a 5-limb field (2^127 - 1) raises
    NotImplementedError."""
    cases = ((P, "msm_divstep_inv"), (BLS12_381.modulus, "msm_divstep_inv_n13"), (101, "msm_divstep_inv_n1"),
             ((1 << 31) - 1, "msm_divstep_inv_n2"), ((1 << 64) - (1 << 32) + 1, "msm_divstep_inv_n3"),
             (ED_ON_BLS12_377.modulus, "msm_divstep_inv_n9"))
    for p, symbol in cases:
        f = create_field_ops(p)
        wide = f.pack_raw(list(range(1, 31)), "cpu")
        x = wide[:, 10:]
        fake_card.clear()
        out = divstep.inv_divstep(f.inv_params, x)
        ((name, (out_p, x_p, sx, cfg, M, stream)),) = fake_card
        assert name == symbol and out.shape == (f.n, 20) and out_p.value == out.data_ptr()
        # one row: its lanes are the plane, the stride is the lane count
        assert (x_p.value, sx, M, stream) == (x.data_ptr(), 30 if f.n > 1 else 20, 20, 55)
        assert cfg is f.inv_params.kernel_words
    fake_card.clear()
    divstep.inv_mont_divstep(f.inv_params, x)
    assert [name for name, _ in fake_card] == ["msm_mul_const_n9", "msm_divstep_inv_n9",
                                               "msm_mul_const_n9"]
    assert divstep.DIVSTEP_INV.launches_by_n == {12: 1, 13: 1, 1: 1, 2: 1, 3: 1, 9: 2}
    f5 = create_field_ops((1 << 127) - 1)
    with pytest.raises(NotImplementedError):
        divstep.inv_divstep(f5.inv_params, f5.pack_raw([3], "cpu"))


def test_divstep_inv_mont_kernel_branch_arguments(fake_card):
    """A CUDA tensor goes to divstep_inv_mont's entry point at its limb count
    (msm_divstep_inv_mont, _n13, _n9, _n1, _n2, _n3) with out, x and its row stride (a
    column slice passes its parent's), the DivstepConst words, the field's
    FieldParams, mu = -p^-1 mod R for the warp products, the lane count, and
    the grid: one warp a lane, INV_MONT_LANES_PER_BLOCK lanes a block, the
    source's INV_WARPS (blocks of 32 INV_WARPS threads)."""
    src = (Path(divstep.__file__).parents[1] / "csrc" / "divstep_inv_mont.cu").read_text()
    assert re.search(r"#define INV_WARPS (\d+)", src).group(1) == str(divstep.INV_MONT_LANES_PER_BLOCK)
    assert "<<<blocks, 32 * INV_WARPS," in src
    cases = ((P, "msm_divstep_inv_mont"), (BLS12_381.modulus, "msm_divstep_inv_mont_n13"),
             (PALLAS.modulus, "msm_divstep_inv_mont_n9"), (101, "msm_divstep_inv_mont_n1"),
             ((1 << 31) - 1, "msm_divstep_inv_mont_n2"), ((1 << 64) - (1 << 32) + 1, "msm_divstep_inv_mont_n3"))
    for p, symbol in cases:
        f = create_field_ops(p)
        wide = f.pack_raw([v % p for v in range(1, 531)], "cpu")
        for x in (wide[:, 10:523], wide[:, 7:8]):  # 513 lanes and 1, column slices
            fake_card.clear()
            out = f.inv_root(x)
            ((name, (out_p, x_p, sx, cfg, field, mu, M, blocks, stream)),) = fake_card
            lanes = x.shape[1]
            assert name == symbol and out.shape == (f.n, lanes) and out_p.value == out.data_ptr()
            assert (x_p.value, sx, M, stream) == (x.data_ptr(), 530 if f.n > 1 else lanes, lanes, 55)
            assert cfg is f.inv_params.kernel_words
            assert list(field) == codec.to_words(p, f.n) + codec.to_words(2 * p, f.n) + \
                codec.to_words(4 * p, f.n) + [f.mu]
            assert list(mu) == codec.to_words(-pow(p, -1, f.R) % f.R, f.n)
            assert blocks == -(-lanes // divstep.INV_MONT_LANES_PER_BLOCK)
    assert divstep.DIVSTEP_INV_MONT.launches_by_n == {12: 2, 13: 2, 9: 2, 1: 2, 2: 2, 3: 2}


# ------------------------------------------- the 32-bit core's plain version

CORE_FIELDS = {"bls12-377": P, "bls12-381": BLS12_381.modulus, "pallas": PALLAS.modulus,
               "ed-on-bls12-377": ED_ON_BLS12_377.modulus}
# per field, the first input among 2^14 drawn (`_rand_below`, numpy seed 1)
# that needs the most batches before g = 0 (`divstep.batches_needed`), and
# that count
MOST_BATCHES = {
    "bls12-377": (0x13c54ee97dedb8e57e5238dfa2b2283bb758a6d05d0f940044322269b8e9b39c775828a0a76dee54d28d257a203cb71,
                  28),
    "bls12-381": (0x9ae3da85fa18546301add601e9c82f5471cb6cea6367b1b00c7fa4a906d5bdfe870b2dbc3bc811c0d1f74448f03226a,
                  28),
    "pallas": (0x35c6439ebd27fa7e25071b832d0526ee176397024751929f59af03774ee6fe9, 19),
    "ed-on-bls12-377": (0x6dd215c321c242fd4cfa67a4ccf4efdda20f0ee0fb24993fad62f4c0fc3eb8f, 19),
}


def _core_inputs(f, field: str) -> list[int]:
    """0, 1, 2, p - 1, (p + 1) / 2, 2^k near bits(p), R mod p, the
    most-batches input, and random values."""
    p = f.p
    b = p.bit_length()
    rnd = _rand_below(np.random.default_rng(b), p, 6)
    return [0, 1, 2, p - 1, (p + 1) // 2, *[(1 << k) % p for k in (b - 2, b - 1, b, b + 1)], f.R_mod_p,
            MOST_BATCHES[field][0], *rnd]


@pytest.mark.parametrize("field", CORE_FIELDS)
def test_core_plain_matches_jax(field):
    """The 32-bit core's plain version (`inv_plain`, the limb layout of the
    field's kernels) against the JAX package's `inv_divstep` and Python's
    pow; the Montgomery inverse (`inv_mont_plain`) on canonical and [p, 2p)
    representatives; the most-batches input's stored count."""
    p = CORE_FIELDS[field]
    f = create_field_ops(p)
    jf = jax_field_ops(p, w=W_JAX)
    xs = _core_inputs(f, field)
    want = [pow(x, -1, p) if x else 0 for x in xs]
    got = codec.unpack(divstep.inv_plain(f.inv_params, f.pack_raw(xs, "cpu")))
    jz = np.asarray(jax_inv_divstep(jax_divstep_params(jf), jcodec.pack(xs, jf.mp)))
    assert got == interop.planes_to_ints(jz, W_JAX) == want
    for t in (f.pack(xs, device="cpu", to_mont=True), f.pack_raw([x * f.R % p + p for x in xs], "cpu")):
        out = divstep.inv_mont_plain(f, t)
        assert f.unpack(out, from_mont=True) == want
        assert all(v < 2 * p for v in codec.unpack(out))
    value, batches = MOST_BATCHES[field]
    assert int(divstep.batches_needed(f.inv_params, f.pack_raw([value], "cpu"))[0]) == batches


def _check_limbs(L: torch.Tensor, top: int) -> None:
    """Limbs below the top in [LIMB_LO, LIMB_HI], limb 0 in [0, 2^30), the
    top within +-top."""
    assert int(L[:-1].min()) >= divstep.LIMB_LO and int(L[:-1].max()) <= divstep.LIMB_HI
    assert int(L[0].min()) >= 0 and int(L[0].max()) < 1 << divstep.LIMB_BITS
    assert int(L[-1].abs().max()) < top


T30 = 1 << divstep.LIMB_BITS
# (u, v, q, r): |u| + |v| = |q| + |r| = 2^30 at the extremes
EXTREME_MATRICES = ((T30, 0, 0, T30), (-T30, 0, 0, -T30), (0, T30, T30, 0), (0, -T30, -T30, 0),
                    (T30 // 2, T30 // 2, -T30 // 2, -T30 // 2), (T30 - 1, -1, 1, 1 - T30),
                    (-T30 // 2, T30 // 2, T30 // 2, -T30 // 2))
EXTREME_LIMBS = ("high", "low", "alternating", "high-low")


@pytest.mark.parametrize("n", (12, 13, 9, 1, 2, 3))
@pytest.mark.parametrize("matrix", EXTREME_MATRICES)
def test_batch_bounds(n, matrix):
    """One matrix application (`_shift` of the limb sums u a + v b + m p,
    divstep_inv_mont's carry scheme) at the extremes: limbs below the top at
    LIMB_HI and LIMB_LO in every pattern, tops at +-2^24, the digit m at
    2^30 - 1 (and 0), p of every field of that limb count. Every sum fits
    int64 (torch's equals Python's), every new limb lands in the range, and
    the value is the sum's over 2^30 (the low limb's 30 bits dropped)."""
    u, v, q, r = matrix
    assert abs(u) + abs(v) <= T30 and abs(q) + abs(r) <= T30
    dl = divstep.kernel_limbs(n)
    ps = {12: [P], 13: [BLS12_381.modulus], 9: [PALLAS.modulus, ED_ON_BLS12_377.modulus], 1: [101],
          2: [(1 << 31) - 1], 3: [(1 << 64) - (1 << 32) + 1]}[n]
    hi, lo, top = divstep.LIMB_HI, divstep.LIMB_LO, 1 << 24
    cols = {"high": [hi] * dl, "low": [lo] * dl, "alternating": [hi, lo] * dl,
            "high-low": [hi] * (dl // 2) + [lo] * dl}
    a = torch.tensor([cols[k][:dl - 1] + [s * top] for k in EXTREME_LIMBS for s in (1, -1)],
                     dtype=torch.int64).T
    a[0] = a[0].clamp(0, T30 - 1)  # limb 0 lies in [0, 2^30)
    b = a.flip(1)
    for p in ps:
        pl = torch.tensor(divstep._limbs30(p, dl), dtype=torch.int64)[:, None]
        for m in (T30 - 1, 0):
            for x, y in ((u, v), (q, r)):
                s = x * a + y * b + m * pl
                ints = [[x * int(a[j, i]) + y * int(b[j, i]) + m * int(pl[j, 0]) for i in range(a.shape[1])]
                        for j in range(dl)]
                assert max(abs(w) for row in ints for w in row) < 1 << 62
                assert s.tolist() == ints
                out = divstep._shift(s)
                _check_limbs(out, top + int(pl[-1, 0]) + 4)  # the top: (x a + y b + m p) / 2^30 + carry
                for i in range(a.shape[1]):
                    S = sum(row[i] << (30 * j) for j, row in enumerate(ints))
                    val = sum(int(w) << (30 * j) for j, w in enumerate(out[:, i].tolist()))
                    assert val == (S - (ints[0][i] & (T30 - 1))) >> 30


@pytest.mark.parametrize("form", ("constant", "variable"))
def test_divsteps_matrix(form):
    """The 30 divsteps on 2,048 random word pairs, in the one-thread
    kernel's branch-free form (`_divsteps`) and in the warp kernel's
    variable-time one (`_divsteps_var`): |u| + |v| <= 2^30, |q| + |r| <=
    2^30, u f + v g = q f + r g = 0 mod 2^30, both forms equal, and 64 lanes
    as the divstep recurrence on Python ints (the matrix applied to the
    full values)."""
    rng = np.random.default_rng(30)
    fw = torch.from_numpy(rng.integers(0, 1 << 32, 2048, dtype=np.int64) | 1)
    gw = torch.from_numpy(rng.integers(0, 1 << 32, 2048, dtype=np.int64))
    zeta0 = torch.from_numpy(rng.integers(-40, 40, 2048, dtype=np.int64))
    steps = divstep._divsteps if form == "constant" else divstep._divsteps_var
    zeta, u, v, q, r = steps(zeta0, fw, gw)
    other = (divstep._divsteps_var if form == "constant" else divstep._divsteps)(zeta0, fw, gw)
    assert all(torch.equal(a, b) for a, b in zip((zeta, u, v, q, r), other))
    assert int((u.abs() + v.abs()).max()) <= T30 and int((q.abs() + r.abs()).max()) <= T30
    assert not ((u * fw + v * gw) % T30).any() and not ((q * fw + r * gw) % T30).any()
    big = _rand_below(rng, 1 << 300, 128)
    for i in range(64):
        d, f, g = -int(zeta0[i]), int(fw[i]) + (big[2 * i] << 32), int(gw[i]) + (big[2 * i + 1] << 32)
        f0, g0 = f, g
        for _ in range(divstep.BATCH):
            if d > 0 and g & 1:
                d, f, g = 1 - d, g, (g - f) // 2
            else:
                d, f, g = 1 + d, f, (g + (g & 1) * f) // 2
        assert -int(zeta[i]) == d
        assert (int(u[i]) * f0 + int(v[i]) * g0, int(q[i]) * f0 + int(r[i]) * g0) == (f << 30, g << 30)


@pytest.mark.parametrize("field", ("bls12-377", "pallas"))
def test_exit_once_g_is_zero(field):
    """512 seeded lanes (0, 1, p - 1 and the most-batches input first): the
    batch loop with the exit once g = 0 on every lane and the one that runs
    all n_batches give the same inverses; no lane needs more than n_batches,
    the exit saves batches, and every limb stays in the kernels' range at
    every batch of the full run."""
    p = CORE_FIELDS[field]
    f = create_field_ops(p)
    dp = f.inv_params
    xs = [0, 1, p - 1, MOST_BATCHES[field][0], *_rand_below(np.random.default_rng(512), p, 508)]
    x = f.pack_raw(xs, "cpu")
    g = divstep._words_to_l30(x.to(torch.int64) & 0xFFFFFFFF, dp.limbs)
    f1, d1, b1 = divstep._safegcd(dp, g)
    out = divstep._finish(dp, f1, d1, f.n)
    assert codec.unpack(out.to(torch.int32)) == [pow(v, -1, p) if v else 0 for v in xs]
    assert int(b1[0]) == 0 and int(b1.max()) == MOST_BATCHES[field][1] < dp.n_batches
    # all n_batches, batch by batch: the limbs in range, g = 0 from each
    # lane's count on, and the same inverses
    top = 1 << 24
    pl = divstep._const(p, dp.limbs, g)
    state = (torch.full_like(g[0], -1), pl.expand_as(g), g, torch.zeros_like(g), torch.zeros_like(g))
    state[4][0] = 1
    for b in range(dp.n_batches):
        assert torch.equal((divstep._normalize(state[2]) != 0).any(dim=0), b < b1)
        state = divstep._batch(dp, *state, pl)
        for L in state[1:]:
            _check_limbs(L, top)
    assert torch.equal(divstep._finish(dp, state[1], state[3], f.n), out)
