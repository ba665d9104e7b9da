"""montgomery_tpu_torch inversion chain against montgomery_tpu: the Montgomery
product (`mont_mul`), the batch inversion tree, the divstep root and the
public divstep inverses (`inv_divstep`, `inv_mont_divstep`).

Inputs come from numpy with fixed seeds plus the edge values 0, 1, p - 1 and
unreduced representatives in [p, 2p); both packages get the same canonical
values through `montgomery_tpu_torch.interop` and results are compared as
canonical integers (tolerance zero). The JAX side runs eagerly in the suite's
callback kernel mode. Port tensors live on the CPU, so the plain versions run.
"""

import contextlib
import types

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
from montgomery_tpu_torch.concrete import BLS12_381, ED_ON_BLS12_377
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
    assert len(dp.kernel_words) == divstep.N_LIMBS * (1 + divstep.SHIFTS) + f.n + 2


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
    for k in (divstep.DIVSTEP_INV, MUL_CONST):
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    return calls


def test_divstep_inv_kernel_branch_arguments(fake_card):
    """A CUDA tensor goes to msm_divstep_inv (12 limbs) or
    msm_divstep_inv_n9 (9 limbs) with out, x and its row stride (a column
    slice passes its parent's), the DivstepConst words, the lane count and
    the stream; `inv_mont_divstep` launches mul_const, divstep_inv,
    mul_const; 13 limbs (BLS12-381) raise NotImplementedError."""
    for p, symbol in ((P, "msm_divstep_inv"), (ED_ON_BLS12_377.modulus, "msm_divstep_inv_n9")):
        f = create_field_ops(p)
        wide = f.pack_raw(list(range(1, 31)), "cpu")
        x = wide[:, 10:]
        fake_card.clear()
        out = divstep.inv_divstep(f.inv_params, x)
        ((name, (out_p, x_p, sx, cfg, M, stream)),) = fake_card
        assert name == symbol and out.shape == (f.n, 20) and out_p.value == out.data_ptr()
        assert (x_p.value, sx, M, stream) == (x.data_ptr(), 30, 20, 55)
        assert cfg is f.inv_params.kernel_words
    fake_card.clear()
    divstep.inv_mont_divstep(f.inv_params, x)
    assert [name for name, _ in fake_card] == ["msm_mul_const_n9", "msm_divstep_inv_n9",
                                               "msm_mul_const_n9"]
    assert divstep.DIVSTEP_INV.launches_by_n == {12: 1, 9: 2}
    f381 = create_field_ops(BLS12_381.modulus)
    with pytest.raises(NotImplementedError):
        divstep.inv_divstep(f381.inv_params, f381.pack_raw([3], "cpu"))
