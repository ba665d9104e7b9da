"""Montgomery field arithmetic over (n, N) planes of 32-bit limbs.

Counterpart of the subset of `montgomery_tpu/ops/field.py` that the
MSM slices use. Elements live lazily reduced in [0, 2p) in
Montgomery form with R = 2^(32n) > 64p (the rule of the JAX package's
`create_field_ops`), so the lazy sums of the curve formulas, up to 8p, may
feed `mul` and still give a result in [0, 2p) ((xy + mp)/R < xy/R + p).

The plain versions work on 16-bit halves held in int64 (`Plain16`): a 32x32
bit product does not fit torch's signed int64, a 16x16 bit one does with room
for a whole row of accumulation. The radix changes, R does not, and a
Montgomery product (xy + mp)/R is unique for given x and y, so the plain
versions and the CUDA kernels agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import divstep, kernels
from . import limbs as codec

_M16 = 0xFFFF

MUL_CONST = kernels.Kernel(
    "mul_const", {12: "msm_mul_const", 9: "msm_mul_const_n9"},
    "montgomery_tpu_torch/csrc/mul_const.cu",
    "montgomery_tpu/ops/field.py:581",
    [kernels.VP, kernels.VP, kernels.U32P, kernels.U32P, kernels.INT],
)
MONT_MUL = kernels.Kernel(
    "mont_mul", {12: "msm_mont_mul", 9: "msm_mont_mul_n9"}, "montgomery_tpu_torch/csrc/mont_mul.cu",
    "montgomery_tpu/ops/field.py:443",
    [kernels.VP, kernels.VP, kernels.INT, kernels.VP, kernels.INT, kernels.U32P, kernels.INT],
)
MONT_SQR = kernels.Kernel(
    "mont_sqr", {12: "msm_mont_sqr"}, "montgomery_tpu_torch/csrc/mont_sqr.cu",
    "montgomery_tpu/ops/field.py:533",
    [kernels.VP, kernels.VP, kernels.INT, kernels.U32P, kernels.INT],
)


def to16(x: torch.Tensor) -> torch.Tensor:
    """(n, *B) int32 planes of 32-bit limbs -> (2n, *B) int64 16-bit limbs."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((u & _M16, u >> 16), dim=1).reshape(2 * x.shape[0], *x.shape[1:])


def from16(t: torch.Tensor) -> torch.Tensor:
    """(2n, *B) int64 limbs in [0, 2^16) -> (n, *B) int32 planes."""
    t = t.reshape(t.shape[0] // 2, 2, *t.shape[1:])
    v = t[:, 0] | (t[:, 1] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


class Plain16:
    """Field arithmetic on (L, *B) int64 tensors of 16-bit limbs (L = 2n).
    Values are taken mod R = 2^(16L); bounds as in `FieldOps`."""

    def __init__(self, p: int, L: int):
        self.p, self.L = p, L
        self.mu = (-pow(p, -1, 1 << 16)) & _M16
        self._consts: dict = {}

    def const(self, value: int, ref: torch.Tensor) -> torch.Tensor:
        key = (value, ref.device, ref.dim())
        c = self._consts.get(key)
        if c is None:
            limbs = [(value >> (16 * k)) & _M16 for k in range(self.L)]
            c = torch.tensor(limbs, dtype=torch.int64, device=ref.device)
            c = c.reshape(self.L, *([1] * (ref.dim() - 1)))
            self._consts[key] = c
        return c

    @staticmethod
    def carry(t: torch.Tensor):
        """Propagate carries of signed limbs: (limbs in [0, 2^16), carry out).
        The value is kept mod 2^(16L); a negative carry out means it was < 0."""
        t = t.clone()
        for i in range(t.shape[0] - 1):
            t[i + 1] += t[i] >> 16
        return t & _M16, t[-1] >> 16

    def add_lazy(self, x, y):
        return self.carry(x + y)[0]

    def sub_lazy(self, x, y):
        """x - y + 4p, for y < 4p."""
        return self.carry(x + self.const(4 * self.p, x) - y)[0]

    def add(self, x, y):
        z = self.carry(x + y)[0]
        d, c = self.carry(z - self.const(2 * self.p, z))
        return torch.where((c < 0)[None], z, d)

    def sub(self, x, y):
        d, c = self.carry(x - y)
        d2 = self.carry(d + self.const(2 * self.p, d))[0]
        return torch.where((c < 0)[None], d2, d)

    def neg(self, x):
        p2 = self.const(2 * self.p, x)
        d = self.carry(p2 - x)[0]
        d2, c = self.carry(d - p2)
        return torch.where((c < 0)[None], d, d2)

    def reduce(self, x):
        d, c = self.carry(x - self.const(self.p, x))
        return torch.where((c < 0)[None], x, d)

    def mul(self, x, y):
        """CIOS Montgomery product (x y + m p) / R, radix 2^16: row i adds
        x_i y and m_i p at limb offset i and carries limb i into limb i+1
        (a limb sums at most 2L products below 2^32, far below 2^63)."""
        L = self.L
        x, y = torch.broadcast_tensors(x, y)
        pl = self.const(self.p, x)
        T = torch.zeros((2 * L, *x.shape[1:]), dtype=torch.int64, device=x.device)
        for i in range(L):
            row = T[i:i + L]
            row.addcmul_(x[i:i + 1], y)
            m = ((T[i] & _M16) * self.mu) & _M16
            row.addcmul_(m[None], pl)
            T[i + 1] += T[i] >> 16
        return self.carry(T[L:])[0]

    def mul_const(self, x, value: int):
        return self.mul(x, self.const(value, x))


class FieldOps:
    """Field arithmetic for a fixed modulus over int32 (n, *B) planes of
    32-bit limbs, values in [0, 2p) unless noted, Montgomery form."""

    def __init__(self, p: int):
        n = -(-(p.bit_length() + 6) // codec.W)  # R > 64p: 6 bits of slack
        self.p, self.n = p, n
        self.R = 1 << (codec.W * n)
        if self.R <= 64 * p:
            raise ValueError("need R > 64p for the lazy bounds")
        self.mu = (-pow(p, -1, 1 << 32)) & 0xFFFFFFFF
        self.R2 = self.R * self.R % p
        self.R_mod_p = self.R % p
        self.R_inv = pow(self.R, -1, p)
        self.plain = Plain16(p, 2 * n)

    def field_words(self, kernel: kernels.Kernel):
        """The FieldParams that `kernel` takes; raises NotImplementedError
        unless the kernel was instantiated at this field's limb count."""
        return kernels.field_params(kernel, self.p, self.n, self.mu)

    # -------------------------------------------------------------- structure

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros((self.n, *shape), dtype=torch.int32, device=device)

    def const_plane(self, value: int, ref: torch.Tensor) -> torch.Tensor:
        """A constant broadcast to the shape of `ref` (n, *B)."""
        c = torch.from_numpy(codec.pack_scalar(value, self.n)).to(ref.device)
        return c.reshape(self.n, *([1] * (ref.dim() - 1))).expand(ref.shape)

    @staticmethod
    def _sel(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(cond[None], a, b)

    def _apply(self, fn, *xs):
        return from16(fn(*[to16(x) for x in xs]))

    # ------------------------------------------------------------ add/sub/cmp

    def add(self, x, y):
        """x + y reduced into [0, 2p)."""
        return self._apply(self.plain.add, x, y)

    def add_lazy(self, x, y):
        """x + y, no reduction: bound(x) + bound(y)."""
        return self._apply(self.plain.add_lazy, x, y)

    def sub_lazy(self, x, y):
        """x - y + 4p, no reduction; y < 4p."""
        return self._apply(self.plain.sub_lazy, x, y)

    def sub(self, x, y):
        """x - y mod 2p, in [0, 2p)."""
        return self._apply(self.plain.sub, x, y)

    def neg(self, x):
        """2p - x reduced into [0, 2p); zero stays zero."""
        return self._apply(self.plain.neg, x)

    def reduce(self, x):
        """[0, 2p) -> [0, p)."""
        return self._apply(self.plain.reduce, x)

    def is_equal(self, x, y) -> torch.Tensor:
        """Bool over the batch: x == y as field elements (x, y in [0, 2p))."""
        return (self.reduce(x) == self.reduce(y)).all(dim=0)

    def is_zero(self, x) -> torch.Tensor:
        return (self.reduce(x) == 0).all(dim=0)

    # --------------------------------------------------- montgomery multiply

    def mul(self, x, y):
        """x y / R mod p, in [0, 2p) for x, y < 8p: kernel `mont_mul` on CUDA
        tensors, `mul_plain` on CPU tensors. As in the JAX package the kernel
        takes operands of one shape; a broadcast operand is expanded (and
        copied where its lanes are not contiguous)."""
        if not kernels.on_cuda(x, y):
            return self.mul_plain(x, y)
        x, y = torch.broadcast_tensors(x, y)
        shape = x.shape
        N = x[0].numel()
        xv, sx = kernels.lane_view(x.reshape(self.n, N), self.n, N)
        yv, sy = kernels.lane_view(y.reshape(self.n, N), self.n, N)
        out = torch.empty((self.n, N), dtype=torch.int32, device=x.device)
        if N:
            MONT_MUL.launch(kernels.ptr(out), kernels.ptr(xv), sx, kernels.ptr(yv), sy,
                            self.field_words(MONT_MUL), N, n=self.n)
        return out.reshape(shape)

    def mul_plain(self, x, y):
        """x y / R mod p (plain torch, any device)."""
        return self._apply(self.plain.mul, x, y)

    def square(self, x):
        """x^2 / R mod p, in [0, 2p) for x < 8p, equal to mul(x, x) bit for
        bit: kernel `mont_sqr` on CUDA tensors, `square_plain` on CPU tensors."""
        if not kernels.on_cuda(x):
            return self.square_plain(x)
        shape = x.shape
        N = x[0].numel()
        xv, sx = kernels.lane_view(x.reshape(self.n, N), self.n, N)
        out = torch.empty((self.n, N), dtype=torch.int32, device=x.device)
        if N:
            MONT_SQR.launch(kernels.ptr(out), kernels.ptr(xv), sx, self.field_words(MONT_SQR), N,
                            n=self.n)
        return out.reshape(shape)

    def square_plain(self, x):
        """x^2 / R mod p (plain torch, any device)."""
        return self.mul_plain(x, x)

    def mul_list(self, pairs):
        """Several independent products as one batched product."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        xs = torch.cat([a for a, _ in pairs], dim=-1)
        ys = torch.cat([b for _, b in pairs], dim=-1)
        z = self.mul(xs, ys)
        return list(torch.split(z, [a.shape[-1] for a, _ in pairs], dim=-1))

    def mul_const_plain(self, x, c_mont: int):
        return self._apply(lambda t: self.plain.mul_const(t, c_mont), x)

    def mul_const(self, x: torch.Tensor, c_mont: int) -> torch.Tensor:
        """x c / R mod p for a constant c in [0, p): kernel 1 on a CUDA
        tensor, `mul_const_plain` on a CPU tensor."""
        if not kernels.on_cuda(x):
            return self.mul_const_plain(x, c_mont)
        shape = x.shape
        xf = x.reshape(self.n, -1).contiguous()
        N = kernels.check_planes(self.n, xf)
        out = torch.empty_like(xf)
        if N:
            MUL_CONST.launch(kernels.ptr(out), kernels.ptr(xf),
                             kernels.words(codec.to_words(c_mont, self.n)),
                             self.field_words(MUL_CONST), N, n=self.n)
        return out.reshape(shape)

    def to_montgomery(self, x):
        """x -> x R mod p (a product by R^2 mod p)."""
        return self.mul_const(x, self.R2)

    def from_montgomery(self, x):
        """x R -> x, in [0, p)."""
        return self.reduce(self.mul_const(x, 1))

    # -------------------------------------------------------------- inversion

    def inv_root(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery-form inverse of every lane of (n, M) planes, 0 -> 0:
        kernel `divstep_inv_mont` on CUDA tensors (the root of `batch_inv`,
        at most 512 lanes), its plain version on CPU tensors."""
        return divstep.inv_mont(self, x)

    @functools.cached_property
    def inv_params(self) -> divstep.DivstepParams:
        return divstep.divstep_params(self)

    # the tree stops at this width and inverts it in one root launch (the JAX
    # package's value, kept for parity)
    BATCH_INV_STOP = 512

    def batch_inv(self, x: torch.Tensor, handle_zero: bool = False) -> torch.Tensor:
        """Inverse of every lane of (n, M) Montgomery planes: a product tree
        over contiguous halves (an odd level carries its last element
        through), one root inversion of at most BATCH_INV_STOP lanes, and the
        descent; one `mul` launch per level each way. With handle_zero, zeros
        map to zero; without it a zero lane poisons every lane."""
        if x.dim() != 2:
            raise ValueError("batch_inv expects (n, M) planes")
        zmask = None
        if handle_zero:
            zmask = self.is_zero(x)
            x = self._sel(zmask, self.const_plane(self.R_mod_p, x), x)
        levels = [x]
        while levels[-1].shape[-1] > self.BATCH_INV_STOP:
            v = levels[-1]
            h = v.shape[-1] // 2
            prod = self.mul(v[:, :h], v[:, h:2 * h])
            if v.shape[-1] & 1:
                prod = torch.cat([prod, v[:, 2 * h:]], dim=-1)
            levels.append(prod)
        inv = self.inv_root(levels[-1])
        for v in reversed(levels[:-1]):
            h = v.shape[-1] // 2
            # inverse of the left half = parent inverse * right half, and back
            swapped = torch.cat([v[:, h:2 * h], v[:, :h]], dim=-1)
            out = self.mul(inv[:, :h].repeat(1, 2), swapped)
            if v.shape[-1] & 1:
                out = torch.cat([out, inv[:, h:h + 1]], dim=-1)
            inv = out
        if handle_zero:
            inv = self._sel(zmask, torch.zeros_like(inv), inv)
        return inv

    # -------------------------------------------------------------------- I/O

    def pack(self, values, device="cuda", to_mont: bool = False) -> torch.Tensor:
        """Ints -> planes of their values mod p (optionally to Montgomery form)."""
        x = self.pack_raw([v % self.p for v in values], device)
        return self.to_montgomery(x) if to_mont else x

    def pack_raw(self, values, device="cuda") -> torch.Tensor:
        """Ints in [0, R) -> planes, unreduced."""
        return torch.from_numpy(codec.pack(values, self.n)).to(device)

    def unpack(self, arr: torch.Tensor, from_mont: bool = False) -> list[int]:
        """Planes -> canonical ints mod p (Montgomery form undone on the host)."""
        vals = codec.unpack(arr)
        if from_mont:
            return [v * self.R_inv % self.p for v in vals]
        return [v % self.p for v in vals]

    def host_planes(self, values) -> np.ndarray:
        return codec.pack(values, self.n)


@functools.lru_cache(maxsize=None)
def create_field_ops(p: int) -> FieldOps:
    """One FieldOps per modulus (its constants are built once)."""
    return FieldOps(p)
