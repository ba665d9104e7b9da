"""Safegcd (Bernstein-Yang divstep) modular inverse.

Counterpart of `montgomery_tpu/ops/divstep.py`. The algorithm is the same:
state (delta, f, g) with f = p and g = x, each divstep

    if delta > 0 and g odd: (delta, f, g) <- (1 - delta, g, (g - f) / 2)
    else:                   (delta, f, g) <- (1 + delta, f, (g + (g & 1) f) / 2)

batched into transition matrices of BATCH steps that are applied to the
full-width (f, g) (exact division by 2^BATCH) and to the mod-p coefficients
(d, e) (a Montgomery-style shift: add m p so that the low bits vanish). Once
g = 0, f = +-1 and sign(f) d = x^-1 mod p; `iterations(bits(p))` steps
always reach it.

The batch size and the limb grid differ from the JAX package's (16 steps on
13-bit int32 limbs): here BATCH = 30 steps on the low 32-bit words, with the
matrix in 32 bits, act on signed 30-bit limbs that fit int32, each product
of two int32 summed in int64 (the core of `csrc/divstep.cuh`, whose header
states every bound). The plain version below runs the kernels' arithmetic
in torch int64 on `kernel_limbs(n)` limbs for a field of n 32-bit words:
divstep_inv_mont's branch-free divsteps, its carry scheme (a limb a warp
lane, two carry rounds, limbs below the top in [LIMB_LO, LIMB_HI] between
batches) and its exit once g = 0, here once it holds on every lane, capped
at n_batches. Kernel `divstep_inv` runs the same divsteps in variable time
(`_divsteps_var`, the same matrices) and carries fully in one thread
(limbs below the top in [0, 2^30), inside that range). The inverse is
unique, so the plain version, both kernels and the JAX package agree
exactly.

Entry points: `inv_divstep` (plain values, kernel `divstep_inv`) and
`inv_mont_divstep` (Montgomery form, `mul_const` around `divstep_inv`), the
JAX package's public inverses; `inv_mont` (kernel `divstep_inv_mont`, the
two Montgomery products fused in) is the root of `FieldOps.batch_inv`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels
from . import limbs as codec

LIMB_BITS = 30
BATCH = 30  # divsteps per transition matrix
SHIFTS = 7  # DS_SHIFTS: the end value is brought into [0, p) by 2^j p, j < SHIFTS
VAR_BITS = 6  # DS_VAR_BITS: odd steps at once in the variable-time divsteps
_MASK = (1 << LIMB_BITS) - 1
_W32 = (1 << 32) - 1
# the range of every limb below the top between batches (limb 0: [0, 2^30));
# the kernels hold the limbs in int32
LIMB_LO, LIMB_HI = -2, (1 << LIMB_BITS) + 1
# warps (one a lane) in a block of divstep_inv_mont (INV_WARPS of its source)
INV_MONT_LANES_PER_BLOCK = 4

DIVSTEP_INV_MONT = kernels.Kernel(
    "divstep_inv_mont", kernels.symbols("divstep_inv_mont", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/divstep_inv_mont.cu",
    "montgomery_tpu/ops/field.py:761",
    [kernels.VP, kernels.VP, kernels.INT, ctypes.POINTER(ctypes.c_int32), kernels.U32P, kernels.U32P,
     kernels.INT, kernels.INT],
)
DIVSTEP_INV = kernels.Kernel(
    "divstep_inv", kernels.symbols("divstep_inv", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/divstep_inv.cu",
    "montgomery_tpu/ops/divstep.py:245",
    [kernels.VP, kernels.VP, kernels.INT, ctypes.POINTER(ctypes.c_int32), kernels.INT],
)
# Montgomery products of divstep_inv_mont (out of and back into Montgomery
# form), for MulCounter
INV_MONT_MULS = 2


def iterations(d: int) -> int:
    """Proven sufficient divstep count for d-bit inputs (BY19 Thm 11.2)."""
    return (49 * d + 57) // 17 if d < 46 else (49 * d + 80) // 17


def kernel_limbs(n: int) -> int:
    """30-bit limbs of the numbers for a field of n 32-bit words (ds_limbs
    of csrc/divstep.cuh): 13 at n = 12, 14 at n = 13, 10 at n = 9; 2, 3
    and 4 at n = 1, 2, 3."""
    return -(-32 * n // LIMB_BITS)


def _limbs30(value: int, count: int) -> list[int]:
    return [(value >> (LIMB_BITS * i)) & _MASK for i in range(count)]


@dataclass(frozen=True, eq=False)
class DivstepParams:
    f: object  # the FieldOps
    p: int
    iters: int
    n_batches: int
    pinv: int  # -p^-1 mod 2^30
    limbs: int  # kernel_limbs(f.n)
    kernel_words: ctypes.Array  # the DivstepConst<n> struct of the kernel
    mu_words: ctypes.Array  # -p^-1 mod R in n words: divstep_inv_mont's warp products


def divstep_params(f) -> DivstepParams:
    """Constants for the field `f` (a FieldOps). Raises ValueError where
    the end value (|d| < (n_batches + 1) p) does not fit the bias 2^(SHIFTS-1) p
    or 2^SHIFTS p does not fit the signed limbs."""
    p = f.p
    it = iterations(p.bit_length())
    nb = -(-it // BATCH)
    dl = kernel_limbs(f.n)
    if nb + 1 >= 1 << (SHIFTS - 1) or (p << SHIFTS).bit_length() >= LIMB_BITS * dl:
        raise ValueError(f"divstep limbs too narrow for a {p.bit_length()}-bit modulus")
    pinv = (-pow(p, -1, 1 << LIMB_BITS)) & _MASK
    words = _limbs30(p, dl)
    for j in range(SHIFTS):
        words += _limbs30(p << j, dl)
    words += codec.to_words(f.R2, f.n) + [pinv, nb]
    arr = np.asarray([w & 0xFFFFFFFF for w in words], dtype=np.uint32).view(np.int32)
    return DivstepParams(f=f, p=p, iters=it, n_batches=nb, pinv=pinv, limbs=dl,
                         kernel_words=(ctypes.c_int32 * len(arr))(*arr.tolist()),
                         mu_words=kernels.words(codec.to_words(-pow(p, -1, f.R) % f.R, f.n)))


# ------------------------------------------------------------ plain version


def _normalize(L: torch.Tensor) -> torch.Tensor:
    """Signed limbs -> limbs below the top in [0, 2^30), the top limb signed."""
    out = []
    c = torch.zeros_like(L[0])
    for i in range(L.shape[0] - 1):
        v = L[i] + c
        out.append(v & _MASK)
        c = v >> LIMB_BITS
    out.append(L[-1] + c)
    return torch.stack(out)


def _const(value: int, dl: int, ref: torch.Tensor) -> torch.Tensor:
    """The (dl, 1) limbs of a constant."""
    return torch.tensor(_limbs30(value, dl), dtype=torch.int64, device=ref.device).reshape(dl, 1)


def _words_to_l30(w: torch.Tensor, dl: int) -> torch.Tensor:
    """(n, M) int64 32-bit words (canonical) -> (dl, M) 30-bit limbs."""
    n = w.shape[0]
    out = []
    for i in range(dl):
        k, s = divmod(LIMB_BITS * i, 32)
        v = w[k] >> s
        if k + 1 < n:
            v = v | (w[k + 1] << (32 - s))
        out.append(v & _MASK)
    return torch.stack(out)


def _l30_to_words(L: torch.Tensor, n: int) -> torch.Tensor:
    """(dl, M) non-negative 30-bit limbs -> (n, M) int64 32-bit words."""
    out = []
    for k in range(n):
        i, s = divmod(32 * k, LIMB_BITS)
        v = L[i] >> s
        if i + 1 < L.shape[0]:
            v = v | (L[i + 1] << (LIMB_BITS - s))
        out.append(v & 0xFFFFFFFF)
    return torch.stack(out)


def _divsteps(zeta, fw, gw):
    """BATCH divsteps on the low words fw (odd) and gw, zeta = -delta, in
    divstep_inv_mont's branch-free form (ds_divsteps): (zeta, u, v, q, r) with
    2^BATCH (f', g') = (u f + v g, q f + r g). The words wrap mod 2^32; the
    matrix stays within +-2^30, so int64 holds it exactly."""
    u, v = torch.ones_like(fw), torch.zeros_like(fw)
    q, r = torch.zeros_like(fw), torch.ones_like(fw)
    for _ in range(BATCH):
        neg = zeta < 0  # delta > 0
        odd = (gw & 1) == 1
        gw = torch.where(odd, gw + torch.where(neg, -fw, fw), gw)
        q = torch.where(odd, q + torch.where(neg, -u, u), q)
        r = torch.where(odd, r + torch.where(neg, -v, v), r)
        swap = neg & odd
        zeta = torch.where(swap, -zeta - 1, zeta - 1)
        fw = torch.where(swap, fw + gw, fw) & _W32
        u = torch.where(swap, u + q, u) * 2
        v = torch.where(swap, v + r, v) * 2
        gw = (gw & _W32) >> 1
    return zeta, u, v, q, r


def _divsteps_var(zeta, fw, gw):
    """`_divsteps` in divstep_inv's variable-time form (ds_divsteps_var),
    lane by lane under masks: a run of zeros of g at
    once; a swap as (f, g) <- (g, -f) with zeta negated; then up to VAR_BITS
    odd non-swap steps at once, g += w f with w = -g f^-1 mod 2^limit,
    limit = min(zeta + 1, steps left, VAR_BITS). The same matrix and zeta."""
    u, v = torch.ones_like(fw), torch.zeros_like(fw)
    q, r = torch.zeros_like(fw), torch.ones_like(fw)
    left = torch.full_like(fw, BATCH)
    f, g = fw, gw
    while True:
        s = g | ((_W32 << left) & _W32)  # a sentinel bit at `left`
        zeros = torch.log2((s & -s).double()).round().long()  # exact: a power of two; log2 may miss by an ulp
        g, u, v = g >> zeros, u << zeros, v << zeros
        zeta, left = zeta - zeros, left - zeros
        live = left > 0
        if not live.any():
            return zeta, u, v, q, r
        swap = live & (zeta < 0)
        zeta = torch.where(swap, -zeta, zeta)
        f, g = torch.where(swap, g, f), torch.where(swap, -f & _W32, g)
        u, q = torch.where(swap, q, u), torch.where(swap, -u, q)
        v, r = torch.where(swap, r, v), torch.where(swap, -v, r)
        limit = torch.minimum(torch.minimum(zeta + 1, left), torch.full_like(left, VAR_BITS))
        f6 = f & 63
        w = torch.where(live, (-(g & 63) * (f6 * (2 - f6 * f6))) & ((1 << limit.clamp(min=0)) - 1), 0)
        g, q, r = (g + f * w) & _W32, q + u * w, r + v * w


def _shift(s: torch.Tensor) -> torch.Tensor:
    """(dl, M) int64 limb sums -> the limbs of their value / 2^30 as
    divstep_inv_mont forms them (ds_shift_warp, a limb a lane): each limb
    takes the low 30 bits of the one above and keeps its own high part, then
    hands its bits above 30 up; the top keeps its sign, the low 30 bits of
    limb 0 are dropped."""
    zero = torch.zeros_like(s[:1])
    t = (s >> LIMB_BITS) + torch.cat([s[1:] & _MASK, zero])
    cin = torch.cat([zero, t[:-1] >> LIMB_BITS])
    return torch.cat([t[:-1] & _MASK, t[-1:]]) + cin


def _digit(s0: torch.Tensor, pinv: int) -> torch.Tensor:
    """m < 2^30 with s + m p = 0 mod 2^30, from s's low limb."""
    return ((s0 & _MASK) * pinv) & _MASK


def _batch(dp: DivstepParams, zeta, f, g, d, e, pl):
    """One batch: the divsteps on limb 0 of f and g, the matrix applied to
    (f, g) and (d, e) (p's limbs pl); returns (zeta, f, g, d, e)."""
    zeta, u, v, q, r = _divsteps(zeta, f[0], g[0])
    md, me = _digit(u * d[0] + v * e[0], dp.pinv), _digit(q * d[0] + r * e[0], dp.pinv)
    return (zeta, _shift(u * f + v * g), _shift(q * f + r * g),
            _shift(u * d + v * e + md * pl), _shift(q * d + r * e + me * pl))


def _safegcd(dp: DivstepParams, g: torch.Tensor):
    """The batches on (dl, M) limbs g (values in [0, p)), f = p: (f, d,
    batches), batches[i] the batches lane i ran before its g = 0 (as a
    value: the limbs may write 0 as a carry chain). The loop ends once g = 0
    on every lane (the kernels' exit: later batches leave f and d as they
    are), at most n_batches."""
    pl = _const(dp.p, dp.limbs, g)
    f = pl.expand_as(g)
    d = torch.zeros_like(g)
    e = torch.zeros_like(g)
    e[0] = 1
    zeta = torch.full_like(g[0], -1)  # delta = 1
    batches = torch.zeros_like(g[0])
    for _ in range(dp.n_batches):
        live = (_normalize(g) != 0).any(dim=0)
        if not live.any():
            break
        batches += live
        zeta, f, g, d, e = _batch(dp, zeta, f, g, d, e, pl)
    return f, d, batches


def _finish(dp: DivstepParams, f: torch.Tensor, d: torch.Tensor, n: int) -> torch.Tensor:
    """sign(f) d (f = +-1: its low limb is 1 or 2^30 - 1) brought into
    [0, p) by 2^(SHIFTS-1) p up and 2^j p down, as (n, M) int64 words."""
    fneg = (f[0] != 1)
    d = _normalize(torch.where(fneg, -d, d) + _const(dp.p << (SHIFTS - 1), dp.limbs, d))
    for j in range(SHIFTS - 1, -1, -1):
        s = _normalize(d - _const(dp.p << j, dp.limbs, d))
        d = torch.where(s[-1] >= 0, s, d)
    return _l30_to_words(d, n)


def batches_needed(dp: DivstepParams, x: torch.Tensor) -> torch.Tensor:
    """The batches each lane of (n, M) int32 planes of canonical values in
    [0, p) runs before its g = 0 (0 for a zero lane), as int64 (M,)."""
    return _safegcd(dp, _words_to_l30(x.to(torch.int64) & _W32, dp.limbs))[2]


def inv_plain(dp: DivstepParams, x: torch.Tensor) -> torch.Tensor:
    """(n, M) int32 planes of canonical values in [0, p) -> x^-1 mod p in
    [0, p) (plain domain); 0 -> 0 (g = 0 from the start, so d = 0)."""
    n = x.shape[0]
    f, d, _ = _safegcd(dp, _words_to_l30(x.to(torch.int64) & _W32, dp.limbs))
    out = _finish(dp, f, d, n)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def inv_divstep(dp: DivstepParams, x: torch.Tensor) -> torch.Tensor:
    """x^-1 mod p in [0, p) of plain (n, *B) planes of canonical values in
    [0, p); 0 -> 0: kernel `divstep_inv` on a CUDA tensor, `inv_plain` on a
    CPU tensor."""
    n = dp.f.n
    shape = x.shape
    M = x[0].numel()
    if not kernels.on_cuda(x):
        return inv_plain(dp, x.reshape(n, M)).reshape(shape)
    xv, sx = kernels.lane_view(x.reshape(n, M), n, M)
    out = torch.empty((n, M), dtype=torch.int32, device=x.device)
    if M:
        DIVSTEP_INV.launch(kernels.ptr(out), kernels.ptr(xv), sx, dp.kernel_words, M, n=n,
                           device=out.device)
    return out.reshape(shape)


def inv_mont_divstep(dp: DivstepParams, x_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery-form inverse as the JAX package composes it: out of
    Montgomery form (`mul_const` by 1, reduced into [0, p)), the plain
    inverse (`inv_divstep`), back into Montgomery form (`mul_const` by R^2);
    x_mont in [0, 2p), result in [0, 2p), 0 -> 0."""
    f = dp.f
    return f.to_montgomery(inv_divstep(dp, f.from_montgomery(x_mont)))


def inv_mont_plain(f, x_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery x in [0, 2p) -> the Montgomery form of x^-1, in [0, 2p);
    0 -> 0 (plain torch: the field `f`'s plain products around `inv_plain`)."""
    plain = f.reduce(f.mul_const_plain(x_mont, 1))
    return f.mul_const_plain(inv_plain(f.inv_params, plain), f.R2)


def inv_mont(f, x_mont: torch.Tensor) -> torch.Tensor:
    """As `inv_mont_plain`: kernel `divstep_inv_mont` on a CUDA tensor (one
    warp a lane, INV_MONT_LANES_PER_BLOCK lanes a block), the plain version
    on a CPU tensor. x_mont: (n, M) int32."""
    from .field import MulCounter

    MulCounter.record(x_mont.shape, INV_MONT_MULS)
    if not kernels.on_cuda(x_mont):
        return inv_mont_plain(f, x_mont)
    M = x_mont.shape[-1]
    xv, sx = kernels.lane_view(x_mont, f.n, M)
    out = torch.empty((f.n, M), dtype=torch.int32, device=x_mont.device)
    if M:
        dp = f.inv_params
        DIVSTEP_INV_MONT.launch(kernels.ptr(out), kernels.ptr(xv), sx, dp.kernel_words,
                                f.field_words(DIVSTEP_INV_MONT), dp.mu_words, M,
                                -(-M // INV_MONT_LANES_PER_BLOCK), n=f.n, device=out.device)
    return out
