"""Alternative multipliers: a schoolbook product and a Barrett reduction.

Counterpart of `montgomery_tpu/ops/alt_mul.py`: the reference's baselines
(wasm/multiply-schoolbook.ts:12-72, wasm/barrett.ts:7-78) that the
micro-benchmark's `altmul` section (`montgomery_tpu_torch/micro_bench.py`)
times against the Montgomery product. Every function works on PLAIN-domain
planes of 32-bit words, not Montgomery form: (n, *B) int32 for a field
element, (2n, *B) for a double-width product (the JAX package's planes were
12-bit limbs).

`schoolbook_product` and `barrett_reduce` are plain torch on every device,
as they are plain XLA in the JAX package. `barrett_mul` runs kernel
`barrett_mul` (`csrc/barrett_mul.cu`) on CUDA tensors and
`barrett_mul_plain` on CPU tensors: the kernel's word-level steps on 16-bit
halves held in int64 (as `Plain16`), so that no intermediate value
overflows; the result is unique, so both agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import kernels
from .field import FieldOps, Plain16, from16, to16
from .limbs import to_words

_M16 = 0xFFFF

BARRETT_MUL = kernels.Kernel(
    "barrett_mul", kernels.symbols("barrett_mul", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/barrett_mul.cu",
    "montgomery_tpu/ops/alt_mul.py:150",
    [kernels.VP, kernels.VP, kernels.INT, kernels.VP, kernels.INT, kernels.U32P, kernels.INT],
)


@dataclass(frozen=True, eq=False)
class BarrettParams:
    """Barrett constants for x mod p with x < p^2 (reference
    barrettReduction, wasm/barrett.ts:7-78: mu = floor(2^(2K) / p),
    q = floor(floor(x / 2^(K - 1)) mu / 2^(K + 1)), error <= 2)."""

    f: FieldOps
    K: int  # bit length of p
    mu_limbs: tuple  # floor(2^(2K) / p) in n 32-bit words (K + 1 bits)
    p_limbs: tuple  # p in n 32-bit words
    kernel_words: ctypes.Array  # the BarrettConst<n> struct of the kernel

    @property
    def n(self) -> int:
        return self.f.n


def barrett_base(n: int) -> int:
    """The bit at which the kernel's shifts start reading (32 times the word
    index barrett_base of csrc/barrett_mul.cu): 32 (n - 2), clamped to 0 for
    a one-word field."""
    return 32 * max(n - 2, 0)


def barrett_params(f: FieldOps) -> BarrettParams:
    """Constants for the field `f`. FieldOps sizes n so that
    32 (n - 1) < K + 6 <= 32 n, so mu fits n words and both of the
    kernel's shift counts, K -+ 1 - `barrett_base(n)`, lie in [0, 64) (at
    n = 1, K <= 26: 6 and 8 at p = 101)."""
    n, K = f.n, f.p.bit_length()
    mu = (1 << (2 * K)) // f.p
    mu_limbs, p_limbs = tuple(to_words(mu, n)), tuple(to_words(f.p, n))
    base = barrett_base(n)
    cfg = [*p_limbs, *mu_limbs, (K - 1 - base) & 0xFFFFFFFF, (K + 1 - base) & 0xFFFFFFFF]
    return BarrettParams(f=f, K=K, mu_limbs=mu_limbs, p_limbs=p_limbs,
                         kernel_words=kernels.words(cfg))


# ------------------------------------------------- 16-bit limb helpers


def _mul16(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """a b mod 2^(16 out_len) of int64 16-bit limb planes (b may broadcast
    over the batch), carried into limbs in [0, 2^16): row i adds a_i b at
    limb offset i (a column sums at most 2n products below 2^32)."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    T = torch.zeros((out_len, *shape), dtype=torch.int64, device=a.device)
    for i in range(min(a.shape[0], out_len)):
        w = min(b.shape[0], out_len - i)
        T[i:i + w] += a[i:i + 1] * b[:w]
    return Plain16.carry(T)[0]


def _words16(words: tuple, ref: torch.Tensor) -> torch.Tensor:
    """32-bit words as an int64 16-bit limb plane that broadcasts over
    `ref`'s batch."""
    w = torch.tensor(words, dtype=torch.int64, device=ref.device)
    return to16(w.reshape(len(words), *([1] * (ref.dim() - 1))))


def _shr16(t: torch.Tensor, s: int, out_len: int) -> torch.Tensor:
    """floor(t / 2^s) mod 2^(16 out_len) of a carried 16-bit limb plane."""
    d, b = divmod(s, 16)
    zero = torch.zeros_like(t[0])
    rows = []
    for i in range(out_len):
        lo = t[i + d] if i + d < t.shape[0] else zero
        hi = t[i + d + 1] if i + d + 1 < t.shape[0] else zero
        rows.append(((lo >> b) | (hi << (16 - b))) & _M16)
    return torch.stack(rows)


# ------------------------------------------------------------ functions


def schoolbook_product(f: FieldOps, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The whole product x y of (n, *B) planes as (2n, *B) int32 planes of
    32-bit words (reference multiply-schoolbook.ts:12-72); plain torch on
    every device."""
    return from16(_mul16(to16(x), to16(y), 4 * f.n))


def barrett_reduce(bp: BarrettParams, T: torch.Tensor) -> torch.Tensor:
    """T mod p in [0, p) of (2n, *B) planes of 32-bit words with T < p^2
    (reference wasm/barrett.ts:7-78), as (n, *B) planes: q1 = T >> (K - 1)
    and q = (q1 mu) >> (K + 1), each n words, from the whole product q1 mu;
    r = T - q p mod 2^(32n), which lies in [0, 3p); two conditional
    subtractions of p. Plain torch on every device, the steps of kernel
    `barrett_mul` after its product."""
    n = bp.n
    T16 = to16(T)
    q1 = _shr16(T16, bp.K - 1, 2 * n)
    mu, p16 = _words16(bp.mu_limbs, q1), _words16(bp.p_limbs, q1)
    q = _shr16(_mul16(q1, mu, 4 * n), bp.K + 1, 2 * n)
    r = Plain16.carry(T16[:2 * n] - _mul16(q, p16, 2 * n))[0]
    for _ in range(2):
        d, c = Plain16.carry(r - p16)
        r = torch.where((c < 0)[None], r, d)
    return from16(r)


def barrett_mul_plain(bp: BarrettParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x y mod p by the schoolbook product and the Barrett reduction
    (plain torch, any device)."""
    return barrett_reduce(bp, schoolbook_product(bp.f, x, y))


def barrett_mul(bp: BarrettParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain-domain x y mod p in [0, p) for x, y in [0, p) (the reference
    benchmarked Montgomery against Barrett, doc/zprize22.md:199): kernel
    `barrett_mul` on CUDA tensors, `barrett_mul_plain` on CPU tensors.
    Inputs outside [0, p) are outside the contract, as in the JAX package:
    the product may reach past p^2 and the result is then not x y mod p
    (kernel and plain version still agree). Operands of one shape; a
    broadcast operand is expanded (and copied where its lanes are not
    contiguous)."""
    if not kernels.on_cuda(x, y):
        return barrett_mul_plain(bp, x, y)
    n = bp.n
    x, y = torch.broadcast_tensors(x, y)
    shape = x.shape
    N = x[0].numel()
    xv, sx = kernels.lane_view(x.reshape(n, N), n, N)
    yv, sy = kernels.lane_view(y.reshape(n, N), n, N)
    out = torch.empty((n, N), dtype=torch.int32, device=x.device)
    if N:
        BARRETT_MUL.launch(kernels.ptr(out), kernels.ptr(xv), sx, kernels.ptr(yv), sy,
                           bp.kernel_words, N, n=n, device=out.device)
    return out.reshape(shape)
