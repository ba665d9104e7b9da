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
    "mul_const", kernels.symbols("mul_const", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/mul_const.cu",
    "montgomery_tpu/ops/field.py:581",
    [kernels.VP, kernels.VP, kernels.U32P, kernels.U32P, kernels.INT],
)
MONT_MUL = kernels.Kernel(
    "mont_mul", kernels.symbols("mont_mul", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/mont_mul.cu",
    "montgomery_tpu/ops/field.py:443",
    [kernels.VP, kernels.VP, kernels.INT, kernels.VP, kernels.INT, kernels.U32P, kernels.INT],
)
MONT_SQR = kernels.Kernel(
    "mont_sqr", kernels.symbols("mont_sqr", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/mont_sqr.cu",
    "montgomery_tpu/ops/field.py:533",
    [kernels.VP, kernels.VP, kernels.INT, kernels.U32P, kernels.INT],
)
# out, x, the schedule's steps (`ladder_steps`) and their count, the table's
# entries, the field words, the lane count
EXP_LADDER = kernels.Kernel(
    "exp_ladder", kernels.symbols("exp_ladder", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/exp_ladder.cu",
    "montgomery_tpu/ops/field.py:668",
    [kernels.VP, kernels.VP, kernels.U32P, kernels.INT, kernels.INT, kernels.U32P, kernels.INT],
)
# the most steps one exp_ladder launch takes (csrc/exp_ladder.cu
# LADDER_MAX_STEPS): e < R <= 2^416 at w >= 2 needs at most 210
LADDER_MAX_STEPS = 256
# one run-time-m kernel for both of the JAX package's call sites: sqr_n_dyn
# (:839) and the static-m sqr_n_{m} (:850)
SQR_N = kernels.Kernel(
    "sqr_n", kernels.symbols("sqr_n", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/sqr_n.cu",
    "montgomery_tpu/ops/field.py:839,850",
    [kernels.VP, kernels.VP, kernels.INT, kernels.U32P, kernels.INT],
)
SQRT_WIN = kernels.Kernel(
    "sqrt_win", kernels.symbols("sqrt_win", *kernels.BUILT_LIMBS),
    "montgomery_tpu_torch/csrc/sqrt_win.cu",
    "montgomery_tpu/ops/field.py:955",
    [kernels.VP] * 7 + [kernels.INT] * 2 + [kernels.U32P, kernels.INT],
)

# bits of the 2-Sylow discrete log that one sqrt_win launch extracts (the
# JAX package's _SQRT_WINDOW)
SQRT_WINDOW = 4


class MulCounter:
    """Field-multiplication cost model: counts Montgomery products and their
    lanes (counterpart of `montgomery_tpu/ops/field.py` MulCounter, the
    reference's `multiplyCount`).

    The JAX package counts at trace time. Here the count is taken at call
    time, in the dispatching wrapper before the device split, so the CPU and
    the card count the same: `FieldOps.mul`, `square` and `mul_const` record
    one call each, and a kernel that runs several field products in one
    launch records its JAX formula's count (the `*_MULS` constant beside its
    `Kernel`: 14 for the RCB add, 9 for the RCB doubling and the Edwards
    adds, 1 or 3 for the batched-affine kernels). One difference is real: a
    JAX loop body (`fori_loop`: the ladder, k doublings) counts once per
    trace, while here every iteration counts.

    Usage:  with MulCounter() as mc: fn(*args)
            print(mc.calls, mc.lanes)
    """

    _active: list = []

    def __init__(self):
        self.calls = 0
        self.lanes = 0

    def __enter__(self):
        MulCounter._active.append(self)
        return self

    def __exit__(self, *exc):
        MulCounter._active.remove(self)
        return False

    @classmethod
    def record(cls, shape, times: int = 1):
        """`times` products over planes of `shape` (n, *B): calls += times,
        lanes += times * prod(B)."""
        if not cls._active or times <= 0:
            return
        lanes = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        for c in cls._active:
            c.calls += times
            c.lanes += times * lanes


def to16(x: torch.Tensor) -> torch.Tensor:
    """(n, *B) int32 planes of 32-bit limbs -> (2n, *B) int64 16-bit limbs."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((u & _M16, u >> 16), dim=1).reshape(2 * x.shape[0], *x.shape[1:])


def from16(t: torch.Tensor) -> torch.Tensor:
    """(2n, *B) int64 limbs in [0, 2^16) -> (n, *B) int32 planes."""
    t = t.reshape(t.shape[0] // 2, 2, *t.shape[1:])
    v = t[:, 0] | (t[:, 1] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _carry_pass(t: torch.Tensor):
    """One carry pass over signed limbs: (limbs t & (2^16 - 1) plus the carry
    of the limb below, the top limb's carry out)."""
    c = t >> 16
    u = t & _M16
    u[1:] += c[:-1]
    return u, c[-1]


_LIMB_INDEX: dict = {}  # (L, device, rank) -> the limb indices, shaped to broadcast


def _resolve(u: torch.Tensor, gen: torch.Tensor, prop: torch.Tensor, cout: torch.Tensor):
    """The last carries of `carry` after a pass that left each limb's carry
    out either `gen` (where the limb does not propagate) or its carry in
    (where `prop`): limb i's carry in is `gen` at the last limb below i
    that does not propagate, 0 if none. Returns (limbs, carry out + cout)."""
    L = u.shape[0]
    idx = _LIMB_INDEX.get((L, u.device, u.dim()))
    if idx is None:
        idx = torch.arange(L, device=u.device).reshape(L, *([1] * (u.dim() - 1)))
        _LIMB_INDEX[L, u.device, u.dim()] = idx
    last = torch.cummax(torch.where(prop, -1, idx), dim=0).values
    out = torch.where(last >= 0, torch.gather(gen, 0, last.clamp(min=0)), 0)
    u[1:] += out[:-1]
    return u & _M16, cout + out[-1]


class Plain16:
    """Field arithmetic on (L, *B) int64 tensors of 16-bit limbs (L = 2n).
    Values are taken mod R = 2^(16L); bounds as in `FieldOps`."""

    # CPU products of at most this many lanes run on Python ints (`_mul_ints`;
    # the two are equally fast near 900 lanes on one core):
    # the row loop's hundred-odd tensor operations cost about a millisecond at
    # any width, a lane's ints a few microseconds
    INT_LANES = 512

    def __init__(self, p: int, L: int):
        self.p, self.L = p, L
        self.mu = (-pow(p, -1, 1 << 16)) & _M16
        self.mu_R = -pow(p, -1, 1 << (16 * L)) % (1 << (16 * L))
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

    @staticmethod
    def lookahead_carry(t: torch.Tensor):
        """`carry` of non-negative limbs below 3 * 2^16 (a sum of at most
        three canonical values) in a fixed number of tensor operations,
        whatever L: one pass leaves limbs in [0, 2^16 + 1] and carries of 1
        that ripple only through limbs 2^16 - 1; the carry into a limb is
        then the generate bit (limb >= 2^16) of the last limb below it that
        does not propagate (cummax over their indices). The same limbs and
        carry out as `carry`."""
        u, c = _carry_pass(t)
        return _resolve(u, u >> 16, u == _M16, c)

    # `carry_up` resolves carries of at most this many lanes by lookahead
    # (about fifteen tensor operations, whatever L) and wider ones by
    # `carry`'s loop (two small operations a limb, fewer bytes): the widths
    # where the two take equal time (`micro_bench.py carry`), by device
    LOOKAHEAD_LANES = {"cuda": 1 << 18, "cpu": 256}

    @staticmethod
    def carry_up(t: torch.Tensor):
        """`carry` of non-negative limbs below 3 * 2^16: `lookahead_carry` up
        to LOOKAHEAD_LANES lanes, else the loop."""
        if t[0].numel() > Plain16.LOOKAHEAD_LANES.get(t.device.type, 0):
            return Plain16.carry(t)
        return Plain16.lookahead_carry(t)

    def _carry_both(self, t1, t2):
        """`carry_up` of t1 and t2 (one shape) in one call, side by side on
        the last axis: (limbs of t1, carry out of t1, limbs of t2, carry out
        of t2)."""
        N = t1.shape[-1]
        r, c = self.carry_up(torch.cat([t1, t2], dim=-1))
        return r[..., :N], c[..., :N], r[..., N:], c[..., N:]

    def _minus(self, x, y):
        """x - y + 2^(16L) as limbs in [0, 2^17) before their carries: x plus
        the complement 2^16 - 1 - y of each limb, and 1."""
        return x + (_M16 - y) + self.const(1, x)

    def add_lazy(self, x, y):
        return self.carry_up(x + y)[0]

    def sub_lazy(self, x, y):
        """x - y + 4p, for y < 4p."""
        return self.carry_up(self._minus(x, y) + self.const(4 * self.p, x))[0]

    def sub_positive(self, x, y):
        """x - y + 2p, for y < 2p."""
        return self.carry_up(self._minus(x, y) + self.const(2 * self.p, x))[0]

    def add(self, x, y):
        """x + y, less 2p where x + y >= 2p: both candidates in one carry;
        x + y + (2^(16L) - 2p) carries out exactly where x + y >= 2p."""
        z = x + y
        r1, _, r2, c2 = self._carry_both(z, z + self.const((1 << 16 * self.L) - 2 * self.p, z))
        return torch.where((c2 > 0)[None], r2, r1)

    def sub(self, x, y):
        """x - y, plus 2p where x < y: both candidates in one carry;
        x - y + 2^(16L) carries out exactly where x >= y."""
        t = self._minus(x, y)
        r1, c1, r2, _ = self._carry_both(t, t + self.const(2 * self.p, t))
        return torch.where((c1 > 0)[None], r1, r2)

    def neg(self, x):
        """2p - x for x in (0, 2p], 0 for x = 0: `sub` from 0."""
        return self.sub(torch.zeros_like(x), x)

    def reduce(self, x):
        """x - p where x >= p: x + (2^(16L) - p) carries out exactly there."""
        d, c = self.carry_up(x + self.const((1 << 16 * self.L) - self.p, x))
        return torch.where((c > 0)[None], d, x)

    def mul(self, x, y):
        """CIOS Montgomery product (x y + m p) / R, radix 2^16: row i adds
        x_i y and m_i p at limb offset i and carries limb i into limb i+1
        (a limb sums at most 2L products below 2^32, far below 2^63)."""
        L = self.L
        x, y = torch.broadcast_tensors(x, y)
        if x.device.type == "cpu" and x[0].numel() <= self.INT_LANES:
            out = self._mul_ints(x, y)
            if out is not None:
                return out
        pl = self.const(self.p, x)
        T = torch.zeros((2 * L, *x.shape[1:]), dtype=torch.int64, device=x.device)
        for i in range(L):
            row = T[i:i + L]
            row.addcmul_(x[i:i + 1], y)
            m = ((T[i] & _M16) * self.mu) & _M16
            row.addcmul_(m[None], pl)
            T[i + 1] += T[i] >> 16
        return self.carry(T[L:])[0]

    def _mul_ints(self, x, y):
        """`mul` on Python ints, lane by lane: (x y + m p) / R mod R with
        m = -x y p^-1 mod R, the one value the row loop computes (it keeps
        limb i of x y + m p at 0 for every i < L). None where a limb lies
        outside [0, 2^16)."""
        L = self.L
        xa, ya = x.reshape(L, -1).numpy(), y.reshape(L, -1).numpy()
        if xa.min() < 0 or ya.min() < 0 or xa.max() > _M16 or ya.max() > _M16:
            return None
        xb = xa.T.astype("<u2").tobytes()
        yb = ya.T.astype("<u2").tobytes()
        w, mask, p, mu = 2 * L, (1 << (16 * L)) - 1, self.p, self.mu_R
        out = bytearray()
        for j in range(0, len(xb), w):
            t = int.from_bytes(xb[j:j + w], "little") * int.from_bytes(yb[j:j + w], "little")
            r = (t + (t * mu & mask) * p) >> (16 * L) & mask
            out += r.to_bytes(w, "little")
        limbs = np.ascontiguousarray(np.frombuffer(bytes(out), dtype="<u2").reshape(-1, L).T, dtype=np.int64)
        return torch.from_numpy(limbs).reshape(x.shape)

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
        self.sqrt_M, self.sqrt_q_odd, self.sqrt_g_inv_pows = sqrt_constants(p, self.R)
        self._sqrt_tables: dict = {}
        self._const_planes: dict = {}

    def field_words(self, kernel: kernels.Kernel):
        """The FieldParams that `kernel` takes; raises NotImplementedError
        unless the kernel was instantiated at this field's limb count."""
        return kernels.field_params(kernel, self.p, self.n, self.mu)

    # -------------------------------------------------------------- structure

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros((self.n, *shape), dtype=torch.int32, device=device)

    def const_plane(self, value: int, ref: torch.Tensor) -> torch.Tensor:
        """A constant broadcast to the shape of `ref` (n, *B): an expanded
        view of one column, built once per value, device and rank (a copy
        to the card each call would wait for the card's queue)."""
        key = (value, ref.device, ref.dim())
        c = self._const_planes.get(key)
        if c is None:
            c = torch.from_numpy(codec.pack_scalar(value, self.n)).to(ref.device)
            c = self._const_planes[key] = c.reshape(self.n, *([1] * (ref.dim() - 1)))
        return c.expand(ref.shape)

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

    def add_no_reduce(self, x, y):
        """x + y, no reduction: the JAX package's name for `add_lazy`."""
        return self.add_lazy(x, y)

    def sub_lazy(self, x, y):
        """x - y + 4p, no reduction; y < 4p."""
        return self._apply(self.plain.sub_lazy, x, y)

    def sub_positive(self, x, y):
        """x - y + 2p, no reduction: in [0, 4p) for x, y in [0, 2p), and no
        underflow for any y < 2p."""
        return self._apply(self.plain.sub_positive, x, y)

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
        F = self.plain
        return (F.reduce(to16(x)) == F.reduce(to16(y))).all(dim=0)

    def is_zero(self, x) -> torch.Tensor:
        return (self.plain.reduce(to16(x)) == 0).all(dim=0)

    # --------------------------------------------------- montgomery multiply

    def _flat(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(n, *B) planes -> contiguous (n, N) planes for a kernel, and N."""
        xf = x.reshape(self.n, -1).contiguous()
        return xf, kernels.check_planes(self.n, xf)

    def mul(self, x, y):
        """x y / R mod p, in [0, 2p) for x, y < 8p: kernel `mont_mul` on CUDA
        tensors, `mul_plain` on CPU tensors. As in the JAX package the kernel
        takes operands of one shape; a broadcast operand is expanded (and
        copied where its lanes are not contiguous)."""
        if MulCounter._active:
            MulCounter.record(torch.broadcast_shapes(x.shape, y.shape))
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
                            self.field_words(MONT_MUL), N, n=self.n, device=out.device)
        return out.reshape(shape)

    def mul_plain(self, x, y):
        """x y / R mod p (plain torch, any device)."""
        return self._apply(self.plain.mul, x, y)

    def square(self, x):
        """x^2 / R mod p, in [0, 2p) for x < 8p, equal to mul(x, x) bit for
        bit: kernel `mont_sqr` on CUDA tensors, `square_plain` on CPU tensors."""
        MulCounter.record(x.shape)
        if not kernels.on_cuda(x):
            return self.square_plain(x)
        shape = x.shape
        N = x[0].numel()
        xv, sx = kernels.lane_view(x.reshape(self.n, N), self.n, N)
        out = torch.empty((self.n, N), dtype=torch.int32, device=x.device)
        if N:
            MONT_SQR.launch(kernels.ptr(out), kernels.ptr(xv), sx, self.field_words(MONT_SQR), N,
                            n=self.n, device=out.device)
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
        MulCounter.record(x.shape)
        if not kernels.on_cuda(x):
            return self.mul_const_plain(x, c_mont)
        shape = x.shape
        xf, N = self._flat(x)
        out = torch.empty_like(xf)
        if N:
            MUL_CONST.launch(kernels.ptr(out), kernels.ptr(xf),
                             kernels.words(codec.to_words(c_mont, self.n)),
                             self.field_words(MUL_CONST), N, n=self.n, device=out.device)
        return out.reshape(shape)

    def left_shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """x 2^k mod p for any k >= 0, in [0, 2p): a `mul_const` by the
        Montgomery form of 2^k mod p (kernel `mul_const` on a CUDA tensor)."""
        if k < 0:
            raise ValueError("left_shift needs k >= 0")
        return self.mul_const(x, pow(2, k, self.p) * self.R % self.p)

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
        zmask = None
        if handle_zero:
            zmask = self.is_zero(x)
            x = self._sel(zmask, self.const_plane(self.R_mod_p, x), x)
        inv, h = self.batch_inv_parent(x)
        if h:
            inv = self._descend(x, inv)
        if handle_zero:
            inv = self._sel(zmask, torch.zeros_like(inv), inv)
        return inv

    def batch_inv_parent(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """`batch_inv` without its last descent level: (inv1, h) with h =
        M // 2 and inv1 the inverses of the tree's first product level (width
        ceil(M / 2)), from which lane i's inverse is inv1[i] x[i + h] (i < h),
        inv1[i - h] x[i - h] (h <= i < 2h) or inv1[h] (i = 2h, M odd), as
        `_descend` forms it. Up to BATCH_INV_STOP lanes there is no tree:
        (inv_root(x), 0). A consumer that needs each inverse once forms it
        itself (the unsafe packed add's post kernel) and saves the level's
        round trip through device memory. No zero handling."""
        if x.dim() != 2:
            raise ValueError("batch_inv expects (n, M) planes")
        levels = [x]
        while levels[-1].shape[-1] > self.BATCH_INV_STOP:
            v = levels[-1]
            h = v.shape[-1] // 2
            prod = self.mul(v[:, :h], v[:, h:2 * h])
            if v.shape[-1] & 1:
                prod = torch.cat([prod, v[:, 2 * h:]], dim=-1)
            levels.append(prod)
        inv = self.inv_root(levels[-1])
        for v in reversed(levels[1:-1]):
            inv = self._descend(v, inv)
        return inv, (x.shape[-1] // 2 if len(levels) > 1 else 0)

    def _descend(self, v: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
        """Inverses of tree level v from those of its parent: the left half's
        is the parent's times the right half, and back; an odd level's
        carried element keeps its parent's."""
        h = v.shape[-1] // 2
        swapped = torch.cat([v[:, h:2 * h], v[:, :h]], dim=-1)
        out = self.mul(inv[:, :h].repeat(1, 2), swapped)
        if v.shape[-1] & 1:
            out = torch.cat([out, inv[:, h:h + 1]], dim=-1)
        return out

    # ------------------------------------------------------------------- exp

    # exp_ladder's sliding window (bits) by limb count, from the sweep over
    # w = 2..5 at the random points' width on the card (PERF.md row 22); the
    # 1-3 limb fields keep 4 unswept (their ladders are short and bytes-bound)
    LADDER_WINDOW = {1: 4, 2: 4, 3: 4, 9: 4, 12: 4, 13: 4}

    @property
    def ladder_window(self) -> int:
        return self.LADDER_WINDOW.get(self.n, 4)

    def exp_ladder(self, x: torch.Tensor, e: int, *, w: int | None = None) -> torch.Tensor:
        """x^e in Montgomery form for e >= 1, in [0, 2p): kernel
        `exp_ladder` on CUDA tensors, `exp_ladder_plain` on CPU tensors, both
        on `ladder_schedule(e, w)` (w: `ladder_window` unless given). The
        schedule rides in the launch's parameters, so one binary serves every
        e (the JAX package built one kernel per exponent)."""
        if e < 1 or e >= self.R:
            raise ValueError("exp_ladder needs 1 <= e < R")
        sched = ladder_schedule(e, w or self.ladder_window)
        MulCounter.record(x.shape, schedule_products(sched))
        if not kernels.on_cuda(x):
            return self.exp_ladder_plain(x, e, w=w)
        xf, N = self._flat(x)
        out = torch.empty_like(xf)
        if N:
            steps = ladder_steps(sched)
            EXP_LADDER.launch(kernels.ptr(out), kernels.ptr(xf), kernels.words(steps), len(steps),
                              ladder_entries(sched), self.field_words(EXP_LADDER), N, n=self.n,
                              device=out.device)
        return out.reshape(x.shape)

    def exp_ladder_plain(self, x: torch.Tensor, e: int, *, w: int | None = None) -> torch.Tensor:
        """The kernel's sequence on 16-bit limbs: the table of odd powers
        x, x^3, ... up to the schedule's largest digit (x^2 once, then each
        entry the one before times x^2), acc = the first step's entry, then
        per step its squarings and, unless its digit is 0, a product by the
        digit's entry (the JAX package ran fixed 2-bit digits and multiplied
        by one at a digit 0: the same value, another representative)."""
        F = self.plain
        sched = ladder_schedule(e, w or self.ladder_window)
        table = [to16(x)]
        if ladder_entries(sched) > 1:
            x2 = F.mul(table[0], table[0])
            while len(table) < ladder_entries(sched):
                table.append(F.mul(table[-1], x2))
        acc = table[sched[0][1] >> 1]
        for squarings, d in sched[1:]:
            for _ in range(squarings):
                acc = F.mul(acc, acc)
            if d:
                acc = F.mul(acc, table[d >> 1])
        return from16(acc)

    def exp_const(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x^e for a constant e >= 0 (x^0 = one, in Montgomery form). An
        e >= p runs as (e - 1) mod (p - 1) + 1: x^(p - 1) = 1 for x != 0, and
        the exponent stays at least 1, so 0 still gives 0; every e < p runs
        its own schedule."""
        if e < 0:
            raise ValueError("negative exponent")
        if e == 0:
            return self.const_plane(self.R_mod_p, x).contiguous()
        if e >= self.p:
            e = (e - 1) % (self.p - 1) + 1
        return self.exp_ladder(x, e)

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """1/x in Montgomery form by Fermat, x^(p - 2); 0 -> 0."""
        return self.exp_ladder(x, self.p - 2)

    # ------------------------------------------------------------------ sqrt

    def sqr_n(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """x^(2^m) by m Montgomery squarings in one launch (m at run time):
        kernel `sqr_n` on CUDA tensors, `sqr_n_plain` on CPU tensors."""
        if m <= 0:
            return x
        MulCounter.record(x.shape, m)
        if not kernels.on_cuda(x):
            return self.sqr_n_plain(x, m)
        xf, N = self._flat(x)
        out = torch.empty_like(xf)
        if N:
            SQR_N.launch(kernels.ptr(out), kernels.ptr(xf), int(m), self.field_words(SQR_N), N,
                         n=self.n, device=out.device)
        return out.reshape(x.shape)

    def sqr_n_plain(self, x: torch.Tensor, m: int) -> torch.Tensor:
        F = self.plain
        a = to16(x)
        for _ in range(m):
            a = F.mul(a, a)
        return from16(a)

    def sqrt_window_rows(self, k: int, lk: int) -> tuple[int, ...]:
        """The 3 * 2^lk rows of window k (lk bits) in Montgomery form, for
        d < 2^lk: the t rows g^(-d 2^(4k)), the r rows g^(-floor(d 2^(4k) / 2))
        and the canonical compare values zeta^d, zeta = g^(2^(M - lk)) (a
        primitive 2^lk-th root of unity), where g generates the 2-Sylow
        subgroup. Built once per window (`sqrt_window_table`)."""
        return sqrt_window_rows(self.p, self.R, self.sqrt_M, self.sqrt_g_inv_pows[0], k, lk)

    def sqrt_window_table(self, k: int, lk: int, device) -> torch.Tensor:
        """`sqrt_window_rows` as one int32 buffer on `device`, row by row (row
        j's n words at j n): the table one `sqrt_win` launch reads."""
        key = (k, lk, torch.device(device))
        t = self._sqrt_tables.get(key)
        if t is None:
            rows = codec.pack(self.sqrt_window_rows(k, lk), self.n)  # (n, rows)
            t = torch.from_numpy(rows.T.copy().reshape(-1)).to(device)
            self._sqrt_tables[key] = t
        return t

    def sqrt_window(self, t, r, s, k: int, lk: int, last: bool):
        """Window k of the 2-Sylow discrete log (lk <= SQRT_WINDOW bits),
        given s = t^(2^(M - 4k - lk)): (t', r', digit) with the digit an int32
        (1, *B) plane. Kernel `sqrt_win` on CUDA tensors, `sqrt_window_plain`
        on CPU tensors; both read the window's rows (`sqrt_window_rows`)."""
        MulCounter.record(t.shape, sqrt_window_products(last))
        if not kernels.on_cuda(t, r, s):
            return self.sqrt_window_plain(t, r, s, k, lk, last)
        tf, rf, sf = [a.reshape(self.n, -1).contiguous() for a in (t, r, s)]
        N = kernels.check_planes(self.n, tf, rf, sf)
        t2, r2 = torch.empty_like(tf), torch.empty_like(rf)
        digit = torch.empty((1, N), dtype=torch.int32, device=tf.device)
        if N:
            planes = (t2, r2, digit, tf, rf, sf, self.sqrt_window_table(k, lk, tf.device))
            SQRT_WIN.launch(*[kernels.ptr(a) for a in planes], int(lk), int(bool(last)),
                            self.field_words(SQRT_WIN), N, n=self.n, device=t2.device)
        return t2.reshape(t.shape), r2.reshape(r.shape), digit.reshape(1, *t.shape[1:])

    def sqrt_window_plain(self, t, r, s, k: int, lk: int, last: bool):
        """The kernel's table lookup on 16-bit limbs. Once the earlier
        windows have corrected t, s = zeta^d for this window's digit d (the
        JAX package's _sqrt_window_formula finds the same d bit by bit): s
        made canonical by one conditional subtraction of p is compared with
        every row's zeta^d, then t (unless this is the last window) and r
        take one product each by the rows d selects. The values are the JAX
        formula's (t' = t g^(-d 2^(4k)), r' = r g^(-floor(d 2^(4k) / 2))),
        each in [0, 2p). A lane whose s matches no row (not the state the
        earlier windows leave) gets digit -1 and t, r unchanged."""
        F, L = self.plain, 2 * self.n
        nrow = 1 << lk
        rows = self.sqrt_window_rows(k, lk)
        table = torch.tensor([[(v >> (16 * j)) & _M16 for j in range(L)] for v in rows],
                             dtype=torch.int64, device=s.device)  # (3 nrow, L)
        s16 = F.reduce(to16(s))
        digit = torch.full(s.shape[1:], -1, dtype=torch.int32, device=s.device)
        for d in range(nrow):
            hit = (s16 == table[2 * nrow + d].reshape(L, *([1] * (s.dim() - 1)))).all(dim=0)
            digit = torch.where(hit, d, digit)
        miss = digit < 0
        row = digit.clamp(min=0).to(torch.int64)

        def by_digit(base):  # (L, *B): the row base + d of every lane
            return table[base:base + nrow].T[:, row]

        t16, r16 = to16(t), to16(r)
        t2 = t16 if last else torch.where(miss[None], t16, F.mul(t16, by_digit(0)))
        r2 = torch.where(miss[None], r16, F.mul(r16, by_digit(nrow)))
        return from16(t2), from16(r2), digit[None]

    def sqrt(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Square roots of Montgomery-form x in [0, 2p) over the batch:
        (root, is_square). The JAX package's windowed Pohlig-Hellman sqrt
        (the same steps, so the same root): u = x^q and r = x^((q+1)/2)
        from one ladder, then per 4-bit window of the 2-Sylow discrete log of
        u one `sqr_n` (the chain down to the window) and one `sqrt_win`. Zero
        gives root 0 and is_square; a non-square gives root 0 and not
        is_square."""
        M, q = self.sqrt_M, self.sqrt_q_odd
        zmask = self.is_zero(x)
        one = self.const_plane(self.R_mod_p, x)
        x_safe = self._sel(zmask, one, x).contiguous()
        w_half = self.exp_const(x_safe, (q - 1) // 2)
        u = self.mul(x_safe, self.mul(w_half, w_half))  # x^q
        r = self.mul(x_safe, w_half)  # x^((q + 1) / 2)
        t, done, k, parity = u, 0, 0, None
        while done < M:
            lk = min(SQRT_WINDOW, M - done)
            s = self.sqr_n(t, M - done - lk)
            t, r, digit = self.sqrt_window(t, r, s, k, lk, done + lk >= M)
            if k == 0:
                parity = (digit[0] & 1) != 0
            done += lk
            k += 1
        is_square = ~parity
        return self._sel(is_square & ~zmask, r, torch.zeros_like(r)), is_square | zmask

    # -------------------------------------------------------------------- I/O

    def pack(self, values, device="cuda", to_mont: bool = False) -> torch.Tensor:
        """Ints -> planes of their values mod p (optionally to Montgomery form)."""
        x = self.pack_raw([v % self.p for v in values], device)
        return self.to_montgomery(x) if to_mont else x

    def pack_raw(self, values, device="cuda") -> torch.Tensor:
        """Ints in [0, R) -> planes, unreduced."""
        return torch.from_numpy(codec.pack(values, self.n)).to(device)

    @property
    def n_packed_bytes(self) -> int:
        """Bytes of one element in the packed byte codec (`limbs.pack_bytes`)."""
        return codec.n_packed_bytes(self.p)

    def unpack(self, arr: torch.Tensor, from_mont: bool = False) -> list[int]:
        """Planes -> canonical ints mod p (Montgomery form undone on the host)."""
        vals = codec.unpack(arr)
        if from_mont:
            return [v * self.R_inv % self.p for v in vals]
        return [v % self.p for v in vals]

    def host_planes(self, values) -> np.ndarray:
        return codec.pack(values, self.n)


@functools.lru_cache(maxsize=None)
def ladder_schedule(e: int, w: int) -> tuple[tuple[int, int], ...]:
    """The left-to-right sliding-window schedule of x^e for e >= 1 and a
    window of w bits: steps (squarings, digit). The first step is (0, d)
    with acc = x^d; each later one squares acc that many times and, unless
    its digit is 0 (only a last step of trailing zeros), multiplies by x^d.
    Every digit but that 0 is odd and below 2^w: a window starts at the
    highest unread set bit and ends at the lowest set bit within w bits of
    it. `exp_ladder` (kernel and plain version), `ladder_products` and the
    chip smoke's bound all walk this one schedule."""
    if e < 1:
        raise ValueError("ladder_schedule needs e >= 1")
    if not 2 <= w <= 5:
        raise ValueError(f"ladder window of {w} bits: the kernel takes 2 to 5")
    steps, i, zeros = [], e.bit_length() - 1, 0
    while i >= 0:
        if not (e >> i) & 1:
            zeros, i = zeros + 1, i - 1
            continue
        j = max(i - w + 1, 0)
        while not (e >> j) & 1:
            j += 1
        d = (e >> j) & ((1 << (i - j + 1)) - 1)
        steps.append((zeros + i - j + 1 if steps else 0, d))
        zeros, i = 0, j - 1
    if zeros:
        steps.append((zeros, 0))
    return tuple(steps)


def ladder_entries(sched) -> int:
    """Entries x, x^3, ... of the table a schedule reads: up to its largest
    digit."""
    return max(d for _, d in sched) + 1 >> 1


def ladder_steps(sched) -> list[int]:
    """A schedule as the kernel's step words, squarings << 5 | digit."""
    if len(sched) > LADDER_MAX_STEPS:
        raise ValueError(f"{len(sched)} ladder steps: the kernel takes at most {LADDER_MAX_STEPS}")
    return [s << 5 | d for s, d in sched]


def schedule_products(sched) -> int:
    """Montgomery products (squarings among them) of `exp_ladder` on a
    schedule: the table's (x^2 and one product an entry after x), then each
    step's squarings and its product unless its digit is 0."""
    entries = ladder_entries(sched)
    return (entries if entries > 1 else 0) + sum(s + bool(d) for s, d in sched[1:])


def ladder_products(e: int, w: int) -> int:
    """Montgomery products of `exp_ladder` for e at a window of w bits."""
    return schedule_products(ladder_schedule(e, w))


def sqrt_window_products(last: bool) -> int:
    """Montgomery products of one `sqrt_win` launch: one by the r row, and
    one by the t row unless this is the last window."""
    return 1 + (not last)


def sqrt_constants(p: int, R: int) -> tuple[int, int, list[int]]:
    """The 2-Sylow structure of F_p^* that sqrt needs, as the JAX package's
    create_field_ops computes it for an odd prime p: p - 1 = 2^M q with q
    odd, and g^(-2^j) in Montgomery form for j < M, where g = z^q generates
    the 2-Sylow subgroup for the least non-residue z."""
    M, q = 0, p - 1
    while q % 2 == 0:
        q //= 2
        M += 1
    z = 2
    while pow(z, (p - 1) // 2, p) == 1:
        z += 1
    cur = pow(pow(z, q, p), -1, p)
    pows = []
    for _ in range(M):
        pows.append(cur * R % p)
        cur = cur * cur % p
    return M, q, pows


@functools.lru_cache(maxsize=None)
def sqrt_window_rows(p: int, R: int, M: int, g_inv_mont: int, k: int, lk: int) -> tuple[int, ...]:
    """`FieldOps.sqrt_window_rows` from p, R, M and g^(-1) in Montgomery
    form (`sqrt_constants`' first power): t rows, r rows, compare rows."""
    if not 1 <= lk <= SQRT_WINDOW or SQRT_WINDOW * k + lk > M:
        raise ValueError(f"window k={k} of lk={lk} bits lies outside M={M}")
    g = pow(g_inv_mont * pow(R, -1, p) % p, -1, p)
    zeta = pow(g, 1 << (M - lk), p)
    ds = range(1 << lk)
    t_rows = [pow(g, -(d << (SQRT_WINDOW * k)), p) for d in ds]
    r_rows = [pow(g, -((d << (SQRT_WINDOW * k)) >> 1), p) for d in ds]
    cmp = [pow(zeta, d, p) for d in ds]
    return tuple(v * R % p for v in t_rows + r_rows + cmp)


@functools.lru_cache(maxsize=None)
def create_field_ops(p: int) -> FieldOps:
    """One FieldOps per modulus (its constants are built once)."""
    return FieldOps(p)
