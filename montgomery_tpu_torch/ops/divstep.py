"""Constant-iteration safegcd (Bernstein-Yang divstep) modular inverse.

Counterpart of `montgomery_tpu/ops/divstep.py`. The algorithm is the same:
state (delta, f, g) with f = p and g = x, each divstep

    if delta > 0 and g odd: (delta, f, g) <- (1 - delta, g, (g - f) / 2)
    else:                   (delta, f, g) <- (1 + delta, f, (g + (g & 1) f) / 2)

batched into transition matrices of BATCH steps that are applied to the
full-width (f, g) (exact division by 2^BATCH) and to the mod-p coefficients
(d, e) (a Montgomery-style shift: add m p so that the low bits vanish). After
`iterations(bits(p))` steps f = +-1, and sign(f) d = x^-1 mod p.

The batch size and the limb grid differ from the JAX package's (16 steps on
13-bit int32 limbs): here BATCH = 30 steps act on signed 30-bit limbs in int64,
where a matrix entry times a limb and their 3-term sums stay below 2^62. The
plain version below (torch int64, vectorised over lanes, N_LIMBS limbs for
every field) and the kernels (the safegcd core of `csrc/divstep.cuh`,
`kernel_limbs(n)` limbs for a field of n 32-bit words) run this same
algorithm; the inverse is unique, so both agree with the JAX package
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
N_LIMBS = 13  # limbs of the plain version: 390 signed bits, enough for p up to 382 bits
BATCH = 30  # divsteps per transition matrix
SHIFTS = 7  # DS_SHIFTS: the end value is brought into [0, p) by 2^j p, j < SHIFTS
_MASK = (1 << LIMB_BITS) - 1

DIVSTEP_INV_MONT = kernels.Kernel(
    "divstep_inv_mont", kernels.symbols("divstep_inv_mont", *kernels.WEIERSTRASS_LIMBS),
    "montgomery_tpu_torch/csrc/divstep_inv_mont.cu",
    "montgomery_tpu/ops/field.py:761",
    [kernels.VP, kernels.VP, kernels.INT, ctypes.POINTER(ctypes.c_int32), kernels.U32P, kernels.INT],
)
DIVSTEP_INV = kernels.Kernel(
    "divstep_inv", {12: "msm_divstep_inv", 9: "msm_divstep_inv_n9"},
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
    """30-bit limbs of the kernel's numbers for a field of n 32-bit words
    (ds_limbs of csrc/divstep_inv_mont.cu): 13 at n = 12, 14 at n = 13, 10
    at n = 9."""
    return -(-32 * n // LIMB_BITS)


def _limbs30(value: int, count: int = N_LIMBS) -> list[int]:
    return [(value >> (LIMB_BITS * i)) & _MASK for i in range(count)]


@dataclass(frozen=True, eq=False)
class DivstepParams:
    f: object  # the FieldOps
    p: int
    iters: int
    n_batches: int
    pinv: int  # -p^-1 mod 2^30
    kernel_words: ctypes.Array  # the DivstepConst<n> struct of the kernel


def divstep_params(f) -> DivstepParams:
    """Constants for the field `f` (a FieldOps). Raises ValueError where
    the end value (|d| < (n_batches + 1) p) does not fit the bias 2^(SHIFTS-1) p
    or 2^SHIFTS p does not fit the signed limbs of the plain version or the
    kernel."""
    p = f.p
    it = iterations(p.bit_length())
    nb = -(-it // BATCH)
    dl = kernel_limbs(f.n)
    if nb + 1 >= 1 << (SHIFTS - 1) or (p << SHIFTS).bit_length() >= LIMB_BITS * min(N_LIMBS, dl):
        raise ValueError(f"divstep limbs too narrow for a {p.bit_length()}-bit modulus")
    pinv = (-pow(p, -1, 1 << LIMB_BITS)) & _MASK
    words = _limbs30(p, dl)
    for j in range(SHIFTS):
        words += _limbs30(p << j, dl)
    words += codec.to_words(f.R2, f.n) + [pinv, nb]
    arr = np.asarray([w & 0xFFFFFFFF for w in words], dtype=np.uint32).view(np.int32)
    return DivstepParams(f=f, p=p, iters=it, n_batches=nb, pinv=pinv,
                         kernel_words=(ctypes.c_int32 * len(arr))(*arr.tolist()))


# ------------------------------------------------------------ plain version


def _normalize(L: torch.Tensor) -> torch.Tensor:
    """Signed limbs -> limbs below the top in [0, 2^30), the top limb signed."""
    out = []
    c = torch.zeros_like(L[0])
    for i in range(N_LIMBS - 1):
        v = L[i] + c
        out.append(v & _MASK)
        c = v >> LIMB_BITS
    out.append(L[N_LIMBS - 1] + c)
    return torch.stack(out)


def _const(values: list[int], ref: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=ref.device).reshape(N_LIMBS, 1)


def _words_to_l30(w: torch.Tensor) -> torch.Tensor:
    """(n, M) int64 32-bit words (canonical) -> (N_LIMBS, M) 30-bit limbs."""
    n = w.shape[0]
    out = []
    for i in range(N_LIMBS):
        k, s = divmod(LIMB_BITS * i, 32)
        if k >= n:  # a field narrower than the limbs (n = 9 for Pallas)
            out.append(torch.zeros_like(w[0]))
            continue
        v = w[k] >> s
        if k + 1 < n:
            v = v | (w[k + 1] << (32 - s))
        out.append(v & _MASK)
    return torch.stack(out)


def _l30_to_words(L: torch.Tensor, n: int) -> torch.Tensor:
    """(N_LIMBS, M) non-negative 30-bit limbs -> (n, M) int64 32-bit words."""
    out = []
    for k in range(n):
        i, s = divmod(32 * k, LIMB_BITS)
        v = L[i] >> s
        if i + 1 < N_LIMBS:
            v = v | (L[i + 1] << (LIMB_BITS - s))
        out.append(v & 0xFFFFFFFF)
    return torch.stack(out)


def _divsteps(delta, fw, gw):
    """BATCH divsteps on the low words: (delta, u, v, q, r) with
    2^BATCH (f', g') = (u f + v g, q f + r g)."""
    u, v = torch.ones_like(fw), torch.zeros_like(fw)
    q, r = torch.zeros_like(fw), torch.ones_like(fw)
    for _ in range(BATCH):
        odd = (gw & 1) == 1
        swap = (delta > 0) & odd
        u, v, q, r = (
            torch.where(swap, 2 * q, 2 * u),
            torch.where(swap, 2 * r, 2 * v),
            torch.where(swap, q - u, torch.where(odd, q + u, q)),
            torch.where(swap, r - v, torch.where(odd, r + v, r)),
        )
        fw, gw = (torch.where(swap, gw, fw),
                  torch.where(swap, gw - fw, torch.where(odd, gw + fw, gw)) >> 1)
        delta = torch.where(swap, 1 - delta, 1 + delta)
    return delta, u, v, q, r


def _drop_low(t: torch.Tensor) -> torch.Tensor:
    """Normalized limbs whose low limb is 0 -> the value / 2^30, normalized."""
    return _normalize(torch.cat([t[1:], torch.zeros_like(t[:1])]))


def inv_plain(dp: DivstepParams, x: torch.Tensor) -> torch.Tensor:
    """(n, M) int32 planes of canonical values in [0, p) -> x^-1 mod p in
    [0, p) (plain domain); 0 -> 0."""
    n = x.shape[0]
    w = x.to(torch.int64) & 0xFFFFFFFF
    g = _words_to_l30(w)
    f = _const(_limbs30(dp.p), g).expand_as(g)
    d = torch.zeros_like(g)
    e = torch.zeros_like(g)
    e[0] = 1
    pl = _const(_limbs30(dp.p), g)
    delta = torch.ones_like(g[0])
    for _ in range(dp.n_batches):
        fw = f[0] | (f[1] << LIMB_BITS)
        gw = g[0] | (g[1] << LIMB_BITS)
        delta, u, v, q, r = _divsteps(delta, fw, gw)
        f, g = (_drop_low(_normalize(u * f + v * g)),
                _drop_low(_normalize(q * f + r * g)))
        td, te = u * d + v * e, q * d + r * e
        md = ((td[0] & _MASK) * dp.pinv) & _MASK
        me = ((te[0] & _MASK) * dp.pinv) & _MASK
        d = _drop_low(_normalize(td + md * pl))
        e = _drop_low(_normalize(te + me * pl))
    fneg = f[N_LIMBS - 1] < 0
    d = _normalize(torch.where(fneg, -d, d) + _const(_limbs30(dp.p << (SHIFTS - 1)), d))
    for j in range(SHIFTS - 1, -1, -1):
        s = _normalize(d - _const(_limbs30(dp.p << j), d))
        d = torch.where(s[N_LIMBS - 1] >= 0, s, d)
    out = _l30_to_words(d, n)
    out = torch.where((w == 0).all(dim=0), 0, out)
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
    """As `inv_mont_plain`: kernel `divstep_inv_mont` on a CUDA tensor, the
    plain version on a CPU tensor. x_mont: (n, M) int32."""
    from .field import MulCounter

    MulCounter.record(x_mont.shape, INV_MONT_MULS)
    if not kernels.on_cuda(x_mont):
        return inv_mont_plain(f, x_mont)
    M = x_mont.shape[-1]
    xv, sx = kernels.lane_view(x_mont, f.n, M)
    out = torch.empty((f.n, M), dtype=torch.int32, device=x_mont.device)
    if M:
        DIVSTEP_INV_MONT.launch(kernels.ptr(out), kernels.ptr(xv), sx, f.inv_params.kernel_words,
                                f.field_words(DIVSTEP_INV_MONT), M, n=f.n, device=out.device)
    return out
