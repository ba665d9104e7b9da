"""montgomery_tpu_torch alternative multipliers (`ops/alt_mul.py`: the
schoolbook product, the Barrett reduction and `barrett_mul`) against
montgomery_tpu and Python ints.

BLS12-377 inputs come from numpy with a fixed seed plus the edge values 0,
1, 2, p - 1 and p - 2; both packages get the same plain values, and the JAX
side runs once, jitted, in the suite's kernel mode. Results are compared as
integers (tolerance zero: every value is a canonical integer). Other fields
(Pallas, BLS12-381, small primes, and primes whose bit length K sits exactly
at a 32-bit word boundary, where the Barrett shifts straddle words
differently) are held against Python ints on the inputs of the port's
`testing.generators`, as the JAX package's test does. Port tensors live on
the CPU, so `barrett_mul` runs its plain version; the kernel branch's C
arguments are checked with a fake library.
"""

import contextlib
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montgomery_tpu.concrete import BLS12_377 as JAX_BLS12_377
from montgomery_tpu.ops import alt_mul as jalt
from montgomery_tpu.ops import kernels as jkernels
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, PALLAS
from montgomery_tpu_torch.ops import alt_mul, kernels
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import create_field_ops
from montgomery_tpu_torch.testing.generators import sample_field_elements

torch.set_num_threads(1)

P = BLS12_377.modulus
W_JAX = 12  # the JAX package's alt_mul test grid


def _edge(p: int) -> list[int]:
    """The JAX test's extremes of the double-width range (test_alt_mul.py)."""
    return [0, 1, p - 1, p, 2 * p, (p - 1) * (p - 1), p * (p - 1)]


def _edge_factors(p: int) -> list[tuple[int, int]]:
    """Factor pairs whose products are `_edge(p)`."""
    return [(0, 0), (1, 1), (p - 1, 1), (p, 1), (2 * p, 1), (p - 1, p - 1), (p, p - 1)]


@pytest.fixture(scope="module")
def bls():
    """Seeded BLS12-377 inputs and the JAX package's schoolbook_product and
    barrett_mul on them, from one jitted program on the package's plain
    path (no Pallas off the TPU: there `barrett_mul` is
    `barrett_reduce(schoolbook_product(...))`). The last lanes multiply the
    factors of the edge values, so their `barrett_mul` is the JAX
    `barrett_reduce` of the edge values (one reduction to compile)."""
    assert JAX_BLS12_377.modulus == P
    jf = jax_field_ops(P, w=W_JAX)
    jbp = jalt.barrett_params(jf)
    rng = np.random.default_rng(8)
    edges = [0, 1, 2, P - 1, P - 2]
    xs = edges + [int(v) % P for v in rng.integers(0, 1 << 62, size=3)] + [
        int.from_bytes(rng.bytes(56), "little") % P for _ in range(24)]
    ys = edges[::-1] + [int.from_bytes(rng.bytes(56), "little") % P for _ in range(len(xs) - 5)]
    fx, fy = zip(*_edge_factors(P))
    with jkernels.force_pallas(False):
        T, Z = jax.jit(lambda a, b: (jalt.schoolbook_product(jf, a, b), jalt.barrett_mul(jbp, a, b)))(
            jnp.asarray(jcodec.pack(xs + list(fx), jf.mp)), jnp.asarray(jcodec.pack(ys + list(fy), jf.mp)))
    T, Z, k = np.asarray(T), jcodec.unpack(np.asarray(Z), jf.mp), len(xs)
    prods = [sum(int(T[i, j]) << (jf.w * i) for i in range(T.shape[0])) for j in range(k)]
    return xs, ys, prods, Z[:k], Z[k:]


def test_schoolbook_matches_jax(bls):
    xs, ys, jprods, _, _ = bls
    f = create_field_ops(P)
    T = alt_mul.schoolbook_product(f, f.pack_raw(xs, "cpu"), f.pack_raw(ys, "cpu"))
    assert T.dtype == torch.int32 and T.shape == (2 * f.n, len(xs))
    assert codec.unpack(T) == jprods == [x * y for x, y in zip(xs, ys)]


def test_barrett_mul_matches_jax(bls):
    xs, ys, _, jz, _ = bls
    f = create_field_ops(P)
    bp = alt_mul.barrett_params(f)
    X, Y = f.pack_raw(xs, "cpu"), f.pack_raw(ys, "cpu")
    Z = alt_mul.barrett_mul(bp, X, Y)
    assert codec.unpack(Z) == jz == [x * y % P for x, y in zip(xs, ys)]
    assert torch.equal(Z, alt_mul.barrett_mul_plain(bp, X, Y))
    # the Montgomery route gives the same plain product
    mont = f.from_montgomery(f.mul(f.to_montgomery(X), f.to_montgomery(Y)))
    assert torch.equal(Z, mont)


def test_barrett_reduce_matches_jax(bls):
    *_, jr = bls
    f = create_field_ops(P)
    bp = alt_mul.barrett_params(f)
    T = torch.from_numpy(codec.pack(_edge(P), 2 * f.n))
    assert codec.unpack(alt_mul.barrett_reduce(bp, T)) == jr == [v % P for v in _edge(P)]


FIELDS = {
    "small": 101,
    "babybear": (1 << 31) - 1,
    "k32": (1 << 32) - 5,  # K = 32: the cuts at bits 31 and 33 straddle word 1
    "goldilocks": (1 << 64) - (1 << 32) + 1,  # K = 64, a word boundary too
    "pallas": PALLAS.modulus,
    "bls12381": BLS12_381.modulus,
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_alt_mul_against_ints(name):
    """The three functions against Python ints on the generators' inputs
    (uniform values and 0, 1, 2, p - 1, p - 2, powers of two) and the JAX
    test's edge values through barrett_reduce."""
    p = FIELDS[name]
    f = create_field_ops(p)
    bp = alt_mul.barrett_params(f)
    assert bp.K == p.bit_length()
    assert sum(w << (32 * k) for k, w in enumerate(bp.mu_limbs)) == (1 << (2 * bp.K)) // p
    rng = random.Random(0xC0FFEE)
    xs = sample_field_elements(p, 64, rng)
    ys = sample_field_elements(p, 64, rng)
    X, Y = f.pack_raw(xs, "cpu"), f.pack_raw(ys, "cpu")
    assert codec.unpack(alt_mul.schoolbook_product(f, X, Y)) == [x * y for x, y in zip(xs, ys)]
    assert codec.unpack(alt_mul.barrett_mul(bp, X, Y)) == [x * y % p for x, y in zip(xs, ys)]
    T = torch.from_numpy(codec.pack(_edge(p), 2 * f.n))
    assert codec.unpack(alt_mul.barrett_reduce(bp, T)) == [v % p for v in _edge(p)]


@pytest.mark.parametrize("p", [BLS12_377.modulus, PALLAS.modulus, (1 << 64) - (1 << 32) + 1, BLS12_381.modulus,
                               101, (1 << 31) - 1])
def test_barrett_kernel_shift_counts(p):
    """The kernel's shift counts K -+ 1 - 32 (n - 2) (at n = 1 from bit 0:
    `barrett_base`) lie in [0, 64) and its config is p, mu and the two
    counts as 2n + 2 words."""
    f = create_field_ops(p)
    bp = alt_mul.barrett_params(f)
    words = list(bp.kernel_words)
    assert len(words) == 2 * f.n + 2
    assert words[:f.n] == list(bp.p_limbs) and words[f.n:2 * f.n] == list(bp.mu_limbs)
    t1, t2 = words[2 * f.n:]
    base = 32 * max(f.n - 2, 0)
    assert alt_mul.barrett_base(f.n) == base
    assert (t1, t2) == (bp.K - 1 - base, bp.K + 1 - base)
    assert 0 <= t1 < t2 < 64


def test_barrett_kernel_branch_arguments(monkeypatch):
    """A tensor taken for a CUDA one goes to entry point msm_barrett_mul
    with the C arguments it expects: out, x and its row stride, y and its
    row stride (a column slice passes its parent's), the config words, the
    lane count and the stream of the tensors' device; BLS12-381's 13 limbs go
    to msm_barrett_mul_n13; a field of a limb count without an entry point
    (2^127 - 1, 5 limbs) raises NotImplementedError (checked with a fake
    library and recorders in place of torch.cuda)."""
    seen = {}

    def entry(*args):
        seen["args"] = args
        return 0

    @contextlib.contextmanager
    def fake_device(dev):
        seen["device"] = torch.device(dev)
        yield

    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels.LIBRARY, "get",
                        lambda: types.SimpleNamespace(msm_barrett_mul=entry, msm_barrett_mul_n13=entry))
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(alt_mul.BARRETT_MUL, "_fns", {})
    monkeypatch.setattr(alt_mul.BARRETT_MUL, "launches", 0)
    monkeypatch.setattr(alt_mul.BARRETT_MUL, "launches_by_n", {})
    f = create_field_ops(P)
    bp = alt_mul.barrett_params(f)
    wide = f.pack_raw(list(range(1, 41)), "cpu")
    x, y = wide[:, :20], wide[:, 20:]
    out = alt_mul.barrett_mul(bp, x, y)
    out_p, x_p, sx, y_p, sy, cfg, N, stream = seen["args"]
    assert out.shape == (f.n, 20) and out_p.value == out.data_ptr()
    assert (x_p.value, sx) == (x.data_ptr(), 40) and (y_p.value, sy) == (y.data_ptr(), 40)
    assert cfg is bp.kernel_words and N == 20 and stream == 77 and seen["device"] == out.device
    assert alt_mul.BARRETT_MUL.launches_by_n == {12: 1}
    f381 = create_field_ops(BLS12_381.modulus)
    bp381 = alt_mul.barrett_params(f381)
    alt_mul.barrett_mul(bp381, *[f381.pack_raw([1, 2], "cpu")] * 2)
    assert seen["args"][5] is bp381.kernel_words and seen["args"][6] == 2
    assert alt_mul.BARRETT_MUL.launches_by_n == {12: 1, 13: 1}
    f5 = create_field_ops((1 << 127) - 1)
    with pytest.raises(NotImplementedError):
        alt_mul.barrett_mul(alt_mul.barrett_params(f5), *[f5.pack_raw([1, 2], "cpu")] * 2)
