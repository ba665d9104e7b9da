"""Device scalar pipeline: scalar limbs -> GLV halves -> signed window digits.

Counterpart of `montgomery_tpu/scalar/device.py`. Scalars keep that
package's w = 13 limb planes (ns = 20 limbs for the 253-bit BLS12-377 group
order), because the truncated most-significant-limb product that yields the
lattice coefficients is defined on that limb grid: with the same limbs the
digits equal the JAX digits integer for integer.

`digits_glv_device` runs kernel 4 (`csrc/glv_digits.cu`, instantiated at the
limb counts of BLS12-377, BLS12-381 and Pallas at w = 13: `GLV_SHAPES`) on a
CUDA tensor and its plain version, `digits_glv_plain`, in int64 on a CPU
tensor. The non-GLV digits of the Twisted Edwards MSM (`extract_windows`,
`signed_digits_device`) are plain torch on every device, as they were plain
XLA in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..bigint.util import ceil_div, to_limbs
from ..ops import kernels
from ..ops.limbs import bytes_to_limbs
from .glv import GlvParams

GLV_DIGITS = kernels.Kernel(
    "glv_digits", {None: "msm_glv_digits"}, "montgomery_tpu_torch/csrc/glv_digits.cu",
    "montgomery_tpu/scalar/device.py:355",
    [kernels.VP, kernels.VP, ctypes.POINTER(ctypes.c_int32), kernels.INT],
)
_MAXL = 24  # GLV_MAXL of csrc/glv_digits.cu
# the limb counts glv_digits.cu is instantiated at (its GlvShape list):
# (ns, ng, nu, nw, the lengths of a0, b0, a1, b1) -> the curve at w = 13
GLV_SHAPES = {
    (20, 12, 10, 10, (1, 10, 10, 1)): "BLS12-377",
    (20, 12, 11, 11, (10, 1, 1, 10)): "BLS12-381",
    (20, 12, 11, 11, (10, 10, 10, 10)): "Pallas",
}


def bytes_to_limbs_np(data, n_bytes: int, w: int, n_limbs: int) -> np.ndarray:
    """Packed little-endian bytes -> (n_limbs, N) int32 planes of w-bit limbs."""
    return bytes_to_limbs(data, n_bytes, w, n_limbs)


def ints_to_limbs_np(values, bits: int, w: int, n_limbs: int | None = None) -> np.ndarray:
    """Python ints -> (n_limbs, N) int32 planes of w-bit limbs."""
    if n_limbs is None:
        n_limbs = ceil_div(bits, w)
    nb = ceil_div(bits, 8)
    blob = b"".join(int(v).to_bytes(nb, "little") for v in values)
    return bytes_to_limbs_np(blob, nb, w, n_limbs)


@dataclass(frozen=True)
class GlvDevice:
    """Constants of the device GLV decomposition at limb size w."""

    g: GlvParams
    w: int
    ns: int  # limbs of an input scalar
    m_limbs: int  # fixed-point shift in limbs (m = m_limbs * w)
    k0: int  # truncated product's first limb (m_limbs - 2 guard limbs)
    nu: int  # limbs of the lattice coefficients u1, u2
    nw: int  # limbs of the two's-complement residuals
    g1_limbs: tuple  # floor(2^m |v11| / |det|)
    g2_limbs: tuple  # floor(2^m |v10| / |det|)
    coef0: tuple  # s0 = s + coef0[0] u1 + coef0[1] u2
    coef1: tuple  # s1 = coef1[0] u1 + coef1[1] u2
    max_bits_eff: int  # bound on |s0|, |s1| including the truncation slack

    @property
    def khi(self) -> int:
        return self.m_limbs + self.nu

    def num_windows(self, c: int) -> int:
        return ceil_div(self.max_bits_eff + 1, c)

    def coef_limbs(self) -> list[list[int]]:
        """w-bit limbs of |a0|, |b0|, |a1|, |b1| (one zero limb for 0)."""
        return [to_limbs(abs(q), self.w, ceil_div(abs(q).bit_length(), self.w) or 1)
                for q in (*self.coef0, *self.coef1)]

    @property
    def kernel_shape(self) -> tuple:
        """(ns, ng, nu, nw, coefficient lengths): a key of GLV_SHAPES."""
        return (self.ns, len(self.g1_limbs), self.nu, self.nw,
                tuple(len(x) for x in self.coef_limbs()))

    def column_bounds(self) -> tuple[int, int]:
        """The largest column sums that glv_digits.cu's 32-bit accumulators
        hold at these constants, every input limb at 2^w - 1 and every
        carry at its largest: (the truncated product's, unsigned, carry
        included; the residuals' magnitude, signed: the two coefficient
        columns, s and the carry)."""
        top = (1 << self.w) - 1
        msb = carry = 0
        for k in range(self.k0, self.khi):
            col = carry + sum(top * max(g1, g2) for j, (g1, g2)
                              in enumerate(zip(self.g1_limbs, self.g2_limbs)) if 0 <= k - j < self.ns)
            msb, carry = max(msb, col), col >> self.w
        limbs, res = self.coef_limbs(), 0
        for pair, with_s in (((0, 1), True), ((2, 3), False)):
            carry = 0
            for t in range(self.nw):
                col = carry + (top if with_s and t < self.ns else 0)
                col += sum(top * x for h in pair for j, x in enumerate(limbs[h]) if 0 <= t - j < self.nu)
                res, carry = max(res, col), -(-col >> self.w)
        return msb, res

    def kernel_words(self, c: int) -> np.ndarray:
        """The GlvConst struct of csrc/glv_digits.cu as int32 words. Raises
        NotImplementedError for limb counts the kernel is not instantiated
        at (GLV_SHAPES), and ValueError where a column could overflow the
        kernel's 32-bit accumulators (`column_bounds`)."""
        if self.w != 13 or self.k0 != self.ns - 1 or self.khi - self.k0 != self.nu + 2 \
                or self.kernel_shape not in GLV_SHAPES:
            raise NotImplementedError(
                f"glv_digits is instantiated for {sorted(GLV_SHAPES.values())} at w = 13; these "
                f"constants need w = {self.w}, (ns, ng, nu, nw, lengths) = {self.kernel_shape}")
        msb, res = self.column_bounds()
        if msb >= 1 << 32 or res >= 1 << 31:
            raise ValueError(f"GLV columns overflow 32 bits: {msb} (unsigned), {res} (signed)")
        pad = lambda xs: list(xs) + [0] * (_MAXL - len(xs))  # noqa: E731
        coefs = [*self.coef0, *self.coef1]
        limbs = self.coef_limbs()
        words = [self.ns, self.k0, self.khi, self.nu, self.nw, len(self.g1_limbs),
                 self.w, c, self.num_windows(c), self.max_bits_eff]
        words += pad(self.g1_limbs) + pad(self.g2_limbs)
        words += [(q > 0) - (q < 0) for q in coefs]
        words += [len(x) for x in limbs]
        for x in limbs:
            words += pad(x)
        return np.asarray(words, dtype=np.int32)


def glv_device(g: GlvParams, w: int = 13) -> GlvDevice:
    """As `montgomery_tpu.scalar.device.glv_device` (same constants)."""
    bq = g.q.bit_length()
    ns = ceil_div(bq, w)
    m_limbs = ns + 1
    m = m_limbs * w
    det = abs(g.det)
    r1_num, r2_num = g.v11, -g.v10
    if g.det < 0:
        r1_num, r2_num = -r1_num, -r2_num
    sgn1 = 1 if r1_num >= 0 else -1
    sgn2 = 1 if r2_num >= 0 else -1
    g1 = (1 << m) * abs(r1_num) // det
    g2 = (1 << m) * abs(r2_num) // det
    nu = ceil_div(g.max_bits + 4, w)
    ng = ceil_div(max(g1.bit_length(), g2.bit_length(), 1), w)
    b0 = (1 << g.max_bits) + 2 * (abs(g.v00) + abs(g.v01))
    b1 = (1 << g.max_bits) + 2 * (abs(g.v10) + abs(g.v11))
    max_bits_eff = max(b0.bit_length(), b1.bit_length())
    nw = ceil_div(max_bits_eff + 2, w)
    return GlvDevice(
        g=g, w=w, ns=ns, m_limbs=m_limbs, k0=m_limbs - 2, nu=nu, nw=nw,
        g1_limbs=tuple(to_limbs(g1, w, ng)),
        g2_limbs=tuple(to_limbs(g2, w, ng)),
        coef0=(-sgn1 * g.v00, -sgn2 * g.v01),
        coef1=(-sgn1 * g.v10, -sgn2 * g.v11),
        max_bits_eff=max_bits_eff,
    )


# ------------------------------------------------------------ plain version


def _carry_mod(T: torch.Tensor, w: int) -> torch.Tensor:
    """Signed int64 limbs -> limbs in [0, 2^w), value mod 2^(len w)."""
    T = T.clone()
    mask = (1 << w) - 1
    for t in range(T.shape[0] - 1):
        T[t + 1] += T[t] >> w
        T[t] &= mask
    T[-1] &= mask
    return T


def _conv(x: torch.Tensor, y_limbs, k_lo: int, k_hi: int) -> torch.Tensor:
    """Limbs [k_lo, k_hi) of the schoolbook product of x (a, N) and constant
    limbs y, before carrying; carries from below k_lo are dropped."""
    a = x.shape[0]
    T = torch.zeros((k_hi - k_lo, *x.shape[1:]), dtype=torch.int64, device=x.device)
    for j, yj in enumerate(y_limbs):
        i0, i1 = max(0, k_lo - j), min(a, k_hi - j)
        if yj and i0 < i1:
            T[i0 + j - k_lo: i1 + j - k_lo] += x[i0:i1] * int(yj)
    return T


def decompose_device(gd: GlvDevice, s_limbs: torch.Tensor):
    """(ns, N) scalar limbs -> (|s0|, s0 < 0, |s1|, s1 < 0), magnitudes as
    (nw, N) int64 limbs, with s0 + s1 lambda = s (mod q) (plain torch)."""
    w, nw = gd.w, gd.nw
    s = s_limbs.to(torch.int64)

    def msb_mul(g):
        T = _carry_mod(_conv(s, g, gd.k0, gd.khi), w)
        return T[gd.m_limbs - gd.k0:]

    u1, u2 = msb_mul(gd.g1_limbs), msb_mul(gd.g2_limbs)

    def residual(coefs, include_s):
        acc = torch.zeros((nw, *s.shape[1:]), dtype=torch.int64, device=s.device)
        if include_s:
            m = min(nw, gd.ns)
            acc[:m] = s[:m]
        for coef, u in zip(coefs, (u1, u2)):
            if coef == 0:
                continue
            limbs = to_limbs(abs(coef), w, ceil_div(abs(coef).bit_length(), w) or 1)
            T = _carry_mod(_conv(u, limbs, 0, nw), w)
            acc += T if coef > 0 else -T
        acc = _carry_mod(acc, w)
        neg = (acc[-1] >> (w - 1)) > 0
        comp = (1 << w) - 1 - acc
        comp[0] += 1
        return torch.where(neg[None], _carry_mod(comp, w), acc), neg

    a0, n0 = residual(gd.coef0, True)
    a1, n1 = residual(gd.coef1, False)
    return a0, n0, a1, n1


def _signed_windows(mag: torch.Tensor, neg: torch.Tensor, w: int, c: int, K: int) -> torch.Tensor:
    """(nl, N) magnitude limbs -> (K, N) signed digits in [-2^(c-1), 2^(c-1)],
    negated where `neg`."""
    nl = mag.shape[0]
    half, full = 1 << (c - 1), 1 << c
    sgn = torch.where(neg, -1, 1)
    carry = torch.zeros_like(mag[0])
    rows = []
    for k in range(K):
        off = k * c
        l0, sh = off // w, off % w
        acc = torch.zeros_like(mag[0])
        for t in range(4):
            if l0 + t < nl:
                acc |= mag[l0 + t] << (t * w)
        dk = ((acc >> sh) & (full - 1)) + carry
        over = (dk > half).to(torch.int64)
        rows.append((dk - over * full) * sgn)
        carry = over
    return torch.stack(rows)


def digits_glv_plain(gd: GlvDevice, s_limbs: torch.Tensor, c: int) -> torch.Tensor:
    a0, n0, a1, n1 = decompose_device(gd, s_limbs)
    K = gd.num_windows(c)
    d0 = _signed_windows(a0, n0, gd.w, c, K)
    d1 = _signed_windows(a1, n1, gd.w, c, K)
    return torch.cat([d0, d1], dim=-1).to(torch.int32)


def digits_glv_device(gd: GlvDevice, s_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """(ns, N) int32 scalar limbs -> (K, 2N) int32 signed digits for the
    GLV-expanded point list [P..., phi(P)...]: column i holds the digits of
    s0_i, column N + i those of s1_i. Kernel 4 on a CUDA tensor, for the
    limb counts it is instantiated at (GLV_SHAPES; others raise
    NotImplementedError, and the kernel itself refuses them)."""
    if not 1 <= c <= 16:
        raise ValueError("window size c must be in [1, 16]")
    if not kernels.on_cuda(s_limbs):
        return digits_glv_plain(gd, s_limbs, c)
    s = s_limbs.contiguous()
    N = kernels.check_planes(gd.ns, s)
    out = torch.empty((gd.num_windows(c), 2 * N), dtype=torch.int32, device=s.device)
    if N:
        GLV_DIGITS.launch(kernels.ptr(out), kernels.ptr(s), _launch_words(gd, c), N, device=out.device)
    return out


@functools.lru_cache(maxsize=None)
def _launch_words(gd: GlvDevice, c: int) -> ctypes.Array:
    """`kernel_words` as the launch's C array, built and checked once."""
    words = gd.kernel_words(c)
    return (ctypes.c_int32 * len(words))(*words.tolist())


# ------------------------------------------------- non-GLV signed digits


def extract_windows(limbs: torch.Tensor, w: int, b_bits: int, c: int) -> torch.Tensor:
    """(nl, N) w-bit limbs -> (K, N) unsigned c-bit windows, K = ceil((b+1)/c)
    (montgomery_tpu's extract_windows)."""
    nl = limbs.shape[0]
    K = ceil_div(b_bits + 1, c)
    cmask = (1 << c) - 1
    rows = []
    for k in range(K):
        l0, sh = divmod(k * c, w)
        if l0 >= nl:
            rows.append(torch.zeros_like(limbs[0]))
            continue
        val = limbs[l0] >> sh
        have, t = w - sh, 1
        while have < c and l0 + t < nl:
            val = val | ((limbs[l0 + t] & ((1 << min(w, c - have)) - 1)) << have)
            have += w
            t += 1
        rows.append(val & cmask)
    return torch.stack(rows)


def signed_digits_device(limbs: torch.Tensor, w: int, b_bits: int, c: int) -> torch.Tensor:
    """(nl, N) int32 w-bit scalar limbs -> (K, N) int32 signed digits in
    [-2^(c-1), 2^(c-1)] (montgomery_tpu's signed_digits_device, the digits of
    the non-GLV MSM): a digit above 2^(c-1) becomes d - 2^c and carries one
    into the next window; K = ceil((b+1)/c) windows leave no carry for
    b-bit scalars. Plain torch on any device."""
    if not 1 <= c <= 16:
        raise ValueError("window size c must be in [1, 16]")
    d = extract_windows(limbs.to(torch.int32), w, b_bits, c)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(d[0])
    rows = []
    for dk in d:
        dk = dk + carry
        carry = (dk > half).to(dk.dtype)
        rows.append(dk - carry * full)
    return torch.stack(rows)
