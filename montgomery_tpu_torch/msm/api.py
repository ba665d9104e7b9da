"""MSM API: curve contexts holding the field, curve and scalar constants.

Counterpart of `WeierstrassMsm` and `EdwardsMsm` in
`montgomery_tpu/msm/api.py`. `WeierstrassMsm` has the JAX package's engines:
the complete projective engine (affine=False) and the batched-affine engine,
with the safe packed add (affine=True, unsafe=False: `msm_full`'s default, as
in the JAX package) or the unsafe one (affine=True, unsafe=True: `bench.py`'s
configuration). `EdwardsMsm` is the Twisted Edwards engine: non-GLV signed
digits, packed accumulation rounds of the unified add, and the bucket
reduction in extended coordinates.

Both contexts have the JAX package's host entries: `digits` (numpy signed
digits of Python ints, no GLV), `msm` (those digits, one copy to the
device, then `msm_device`), and on `WeierstrassMsm` `digits_glv` and
`msm_glv`; `digits_device` computes the digits on the device from scalar
limbs. `window_chunk` accumulates that many windows at a time.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..bigint.twisted_edwards import EdwardsParams, EdwardsPoint
from ..bigint.weierstrass import AffinePoint, CurveParams
from ..curves.affine import AffineOps
from ..curves.edwards import ED_ADD_PACKED, EdwardsBatch, EdwardsOps
from ..curves.projective import PROJ_ADD_RCB, AffineBatch, ProjectiveBatch, ProjectiveOps
from ..ops import kernels
from ..ops.field import MONT_MUL, FieldOps, create_field_ops
from ..ops.limbs import bytes_to_words, words_to_limbs
from ..scalar.device import digits_glv_device, glv_device, ints_to_limbs_np, signed_digits_device
from ..scalar.glv import glv_params, signed_digits_glv
from ..scalar.slicing import num_windows, signed_digits
from ..utils.timing import PhaseLog
from .adapters import AffineAccumAdapter, EdwardsAdapter, ProjectiveAdapter
from .pippenger import bucket_accumulate, msm_digits, msm_digits_affine, reduce_buckets, window_size

SCALAR_W = 13  # scalar limb size, as montgomery_tpu's (api.py:159)


# one context per (class, params, device); an entry is added only once built
_CTX_CACHE: dict = {}


def _context(cls, params, device, kernel: kernels.Kernel):
    """The cached context of `cls` for `params` on `device`, built on first
    use. On a CUDA device there must be a card, and `kernel` (one that the
    engine launches on every MSM) must be instantiated at the field's limb
    count; no context falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions")
        kernels.check_limbs(kernel, create_field_ops(params.modulus).n)
    key = (cls, params, device)
    inst = _CTX_CACHE.get(key)
    if inst is None:
        inst = object.__new__(cls)
        inst._build(params, device)
        _CTX_CACHE[key] = inst
    return inst


def _scalars_to_limbs(q: int, scalars, device) -> torch.Tensor:
    """Python ints or packed little-endian bytes (ceil(bits(q) / 8) a
    scalar) -> (ns, N) int32 planes of 13-bit limbs on `device`. Scalars are
    reduced mod q, bytes included (vectorised: conditional subtractions of
    2^j q on the limb planes)."""
    bq = q.bit_length()
    ns = -(-bq // SCALAR_W)
    if not isinstance(scalars, (bytes, bytearray)):
        L = ints_to_limbs_np([s % q for s in scalars], bq, SCALAR_W, ns)
        return torch.from_numpy(L).to(device)
    nb = -(-bq // 8)
    if len(scalars) == 0 or len(scalars) % nb:
        raise ValueError(f"scalar bytes must be a nonzero multiple of {nb}; "
                         f"got {len(scalars)}")
    words = bytes_to_words(np.frombuffer(scalars, dtype=np.uint8).reshape(-1, nb))
    # raw < (top + 1) q <= 2^k q with k = bits(top): subtracting 2^j q
    # where it fits, j = k-1 .. 0, leaves raw mod q
    top = (1 << (8 * nb)) // q
    for j in range(top.bit_length() - 1, -1, -1):
        words = _sub_if_ge(words, q << j)
    return torch.from_numpy(words_to_limbs(words, SCALAR_W, ns)).to(device)


def _point_planes(f: FieldOps, data) -> tuple[np.ndarray, np.ndarray]:
    """Packed little-endian bytes (x || y per point, ceil(bits(p) / 8)
    bytes each) -> (n, N) int32 planes of the raw x and y; ValueError unless
    the length is a nonzero multiple of a point's bytes."""
    nb = -(-f.p.bit_length() // 8)
    if len(data) == 0 or len(data) % (2 * nb):
        raise ValueError(f"point bytes must be a nonzero multiple of {2 * nb} "
                         f"(2 coordinates x {nb} bytes); got {len(data)}")
    B = np.frombuffer(data, dtype=np.uint8).reshape(-1, 2 * nb)
    xl, yl = (words_to_limbs(bytes_to_words(h), 32, f.n) for h in (B[:, :nb], B[:, nb:]))
    return xl, yl


class WeierstrassMsm:
    """MSM context for a short-Weierstrass curve y^2 = x^3 + a x + b, on
    `device` (the card unless the caller asks for the CPU). On the card the
    field must have a limb count the Weierstrass kernels are instantiated
    at: 12 (BLS12-377), 13 (BLS12-381, NIST P-384) or 9 (Pallas, NIST
    P-256). A curve without an endomorphism (P-256, P-384) takes the engines
    through `msm_device` on non-GLV digits (`scalar.device.
    signed_digits_device`, or `digits` on the host) and `msm`; the GLV
    entries `digits_device`, `msm_device_full` and `msm_full` raise
    ValueError for it."""

    identity_xy = (0, 0)  # the affine encoding of the point at infinity

    def __new__(cls, params: CurveParams, device="cuda"):
        # the kernel every MSM launches: the RCB add for a = 0, the field
        # product of the general-a group law otherwise
        guard = PROJ_ADD_RCB if params.a % params.modulus == 0 else MONT_MUL
        return _context(cls, params, device, guard)

    def _build(self, params: CurveParams, device: torch.device):
        self.params, self.device = params, device
        self.fops = create_field_ops(params.modulus)
        self.proj = ProjectiveOps(self.fops, params)
        self.adapter = ProjectiveAdapter(self.proj)
        self.affine = AffineOps(self.fops, params)
        self.aff_adapter = AffineAccumAdapter(self.affine, self.proj)
        self.aff_adapter_unsafe = AffineAccumAdapter(self.affine, self.proj, unsafe=True)
        self.scalar_bits = params.order.bit_length()
        self.glv = None
        self.glv_dev = None
        if params.endomorphism is not None:
            self.glv = glv_params(params.order, params.endomorphism.lam)
            self.glv_dev = glv_device(self.glv, w=SCALAR_W)

    # ---------------------------------------------------------------- ingest

    def scalars_to_limbs(self, scalars) -> torch.Tensor:
        """Python ints or packed little-endian bytes (ceil(bits(q) / 8) a
        scalar) -> (ns, N) int32 planes of 13-bit limbs on the context's
        device, reduced mod the group order q."""
        return _scalars_to_limbs(self.params.order, scalars, self.device)

    def points_from_bytes(self, data) -> AffineBatch:
        """Packed little-endian bytes (x || y per point) -> Montgomery-form
        AffineBatch; one to-Montgomery launch over both coordinates.
        (0, 0) encodes the point at infinity."""
        f = self.fops
        xl, yl = _point_planes(f, data)
        N = xl.shape[1]
        inf = ~((xl != 0).any(axis=0) | (yl != 0).any(axis=0))
        both = torch.from_numpy(np.concatenate([xl, yl], axis=1)).to(self.device)
        both = f.to_montgomery(both)
        return AffineBatch(both[:, :N], both[:, N:], torch.from_numpy(inf).to(self.device))

    def affine_to_device(self, points: list[AffinePoint]) -> AffineBatch:
        return self.proj.affine_to_device(points, self.device)

    def is_on_curve(self, A: AffineBatch) -> torch.Tensor:
        """Bool (N,): each point is on the curve or at infinity."""
        return self.affine.is_on_curve(A)

    # ------------------------------------------------------------- pipeline

    def expand_points_glv(self, A: AffineBatch) -> AffineBatch:
        """AffineBatch (N) -> AffineBatch (2N): [P..., phi(P)...]."""
        E = self.proj.endomorphism_affine(A)
        return AffineBatch(*[torch.cat([a, e], dim=-1) for a, e in zip(A, E)])

    def digits_device(self, scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
        """(ns, N) scalar limbs -> (K, 2N) GLV signed digits (kernel 4)."""
        if self.glv_dev is None:
            raise ValueError("curve has no endomorphism")
        return digits_glv_device(self.glv_dev, scalar_limbs, c)

    def digits(self, scalars, c: int, scalar_bits: int | None = None) -> np.ndarray:
        """Host digits without GLV: Python ints -> (K, N) int32 signed c-bit
        digits of the scalars mod q, K = ceil((b + 1) / c) for b = scalar_bits
        (the order's bits unless given); ValueError if a reduced scalar has
        more than b bits."""
        return _host_digits(self.params.order, scalars, c, scalar_bits or self.scalar_bits)

    def digits_glv(self, scalars, c: int) -> np.ndarray:
        """Host GLV digits: Python ints -> (K, 2N) int32 signed digits of
        [k1..., k2...] (`scalar.glv.signed_digits_glv`)."""
        if self.glv is None:
            raise ValueError("curve has no endomorphism")
        return signed_digits_glv(self.glv, scalars, c)

    def msm_device(self, points_affine: AffineBatch, digits: torch.Tensor, c: int,
                   window_chunk: int | None = None, affine: bool = False,
                   unsafe: bool = False) -> ProjectiveBatch:
        """sum_i s_i P_i from affine points and their signed digits (K, N):
        the projective engine, or with affine the batched-affine one on the
        points' packed rows, with the safe add or with unsafe the unsafe one
        (whose contract is the caller's: within a bucket no two operands share
        x, and no point is infinite). `window_chunk` accumulates that many
        windows at a time."""
        if affine:
            group = self.aff_adapter_unsafe if unsafe else self.aff_adapter
            return msm_digits_affine(group, self.adapter, points_affine, digits, c, window_chunk)
        P = self.adapter.from_points(points_affine)
        return msm_digits(self.adapter, P, digits, c, window_chunk)

    def msm_device_full(self, points_affine: AffineBatch, scalar_limbs: torch.Tensor, c: int,
                        affine: bool = False, window_chunk: int | None = None,
                        unsafe: bool = False) -> ProjectiveBatch:
        """GLV digits, GLV point expansion and the MSM, all on the device.
        points_affine: AffineBatch (N); scalar_limbs: (ns, N). With affine,
        the expansion is fused with the packed-row layout (kernel `pack_glv`)
        and the buckets accumulate with the batched-affine add: the safe one
        (any input), or with unsafe the unsafe one, whose contract is the
        caller's: within a bucket no two operands share x, and no point is
        infinite (distinct random points meet it). `window_chunk`
        accumulates that many windows at a time."""
        return self._stages(points_affine, scalar_limbs, c, affine, unsafe, window_chunk=window_chunk)

    def msm_phases(self, points_affine: AffineBatch, scalar_limbs: torch.Tensor, c: int,
                   affine: bool = True, unsafe: bool = False):
        """msm_device_full as four separately synchronized stages; returns
        (result, PhaseLog)."""
        log = PhaseLog()
        return self._stages(points_affine, scalar_limbs, c, affine, unsafe, log), log

    def _stages(self, points_affine: AffineBatch, scalar_limbs: torch.Tensor, c: int,
                affine: bool, unsafe: bool, log: PhaseLog | None = None,
                window_chunk: int | None = None) -> ProjectiveBatch:
        """The MSM's four stages; each is synchronized and timed into `log`
        when one is given."""
        dev = self.device

        def phase(label):
            return log.phase(label, dev) if log is not None else nullcontext()

        group = self.adapter
        if affine:
            group = self.aff_adapter_unsafe if unsafe else self.aff_adapter
        with phase("digits (GLV+slice)"):
            digits = self.digits_device(scalar_limbs, c)
        if affine:
            with phase("expand (pack_glv)"):
                P = self.affine.pack_rows_glv(points_affine)
        else:
            with phase("expand (endo) + from_affine"):
                P = self.adapter.from_points(self.expand_points_glv(points_affine))
        with phase("accumulate"):
            buckets, K, L = bucket_accumulate(group, P, digits, c, window_chunk)
        with phase("reduce+combine"):
            if affine:
                buckets = group.to_projective(buckets)
            return reduce_buckets(self.adapter, buckets, c, K, L)

    def default_c(self, N: int) -> int:
        return window_size(max(1, N.bit_length() - 1))

    def msm_full(self, scalars, points, c: int | None = None, affine: bool = True,
                 unsafe: bool = False) -> AffinePoint:
        """Host entry: scalars (ints, bytes or an (ns, N) limb tensor) and
        points (oracle points or an AffineBatch) -> sum s_i P_i. The default
        is the JAX package's: the batched-affine engine with the safe add,
        which takes any input; affine=False is the projective engine,
        unsafe=True the unsafe add under its contract (see
        `msm_device_full`)."""
        A, N = self._host_points(points)
        if N == 0:
            raise ValueError("empty MSM")
        limbs = scalars if isinstance(scalars, torch.Tensor) else self.scalars_to_limbs(scalars)
        if limbs.shape[-1] != N:
            raise ValueError(f"{limbs.shape[-1]} scalars for {N} points")
        S = self.msm_device_full(A, limbs, c or self.default_c(N), affine=affine, unsafe=unsafe)
        return self.proj.to_host(S)[0]

    def _host_points(self, points) -> tuple[AffineBatch, int]:
        """Oracle points or an AffineBatch -> (AffineBatch on the device, N)."""
        if isinstance(points, AffineBatch):
            return points, points.count
        return self.affine_to_device(points), len(points)

    def msm(self, scalars, points, c: int | None = None, affine: bool = False,
            unsafe: bool = False, scalar_bits: int | None = None) -> AffinePoint:
        """Host entry without GLV: Python ints and points (oracle points or an
        AffineBatch) -> sum s_i P_i, from host digits (`digits`, one copy to
        the device) through `msm_device`'s engines (projective by default;
        affine, unsafe as there)."""
        A, N = self._host_points(points)
        if N == 0 or len(scalars) != N:
            raise ValueError(f"{len(scalars)} scalars for {N} points (N > 0)")
        c = c or self.default_c(N)
        d = torch.from_numpy(self.digits(scalars, c, scalar_bits=scalar_bits)).to(self.device)
        return self.proj.to_host(self.msm_device(A, d, c, affine=affine, unsafe=unsafe))[0]

    def msm_glv(self, scalars, points, c: int | None = None) -> AffinePoint:
        """Host entry with GLV digits from the host (`digits_glv`): the
        projective engine on the expanded points [P..., phi(P)...]."""
        A, N = self._host_points(points)
        if N == 0 or len(scalars) != N:
            raise ValueError(f"{len(scalars)} scalars for {N} points (N > 0)")
        c = c or self.default_c(N)
        d = torch.from_numpy(self.digits_glv(scalars, c)).to(self.device)
        return self.proj.to_host(self.msm_device(self.expand_points_glv(A), d, c))[0]


class EdwardsMsm:
    """MSM context for a twisted Edwards curve with a = -1 (reference
    createTwistedEdwards), on `device` (the card unless the caller asks for
    the CPU). On the card the field must have the Edwards kernels' limb count
    (ed-on-bls12-377: 9 limbs of 32 bits). The curve has no endomorphism
    here, so the digits are plain signed c-bit windows of the full scalar."""

    identity_xy = (0, 1)  # the affine identity, an ordinary point

    def __new__(cls, params: EdwardsParams, device="cuda"):
        return _context(cls, params, device, ED_ADD_PACKED)

    def _build(self, params: EdwardsParams, device: torch.device):
        self.params, self.device = params, device
        self.fops = create_field_ops(params.modulus)
        self.ed = EdwardsOps(self.fops, params)
        self.adapter = EdwardsAdapter(self.ed)
        self.scalar_bits = params.order.bit_length()

    # ---------------------------------------------------------------- ingest

    def scalars_to_limbs(self, scalars) -> torch.Tensor:
        """Python ints or packed little-endian bytes (ceil(bits(q) / 8) = 32
        a scalar) -> (ns, N) int32 planes of 13-bit limbs on the context's
        device, reduced mod the group order q (the JAX package's serve path
        left byte scalars >= q unreduced)."""
        return _scalars_to_limbs(self.params.order, scalars, self.device)

    def points_from_bytes(self, data) -> EdwardsBatch:
        """Packed little-endian affine bytes (x || y per point, 32 bytes each)
        -> Montgomery-form extended points: one to-Montgomery launch over both
        coordinates, then T = x y (one `mul`)."""
        xl, yl = _point_planes(self.fops, data)
        N = xl.shape[1]
        both = torch.from_numpy(np.concatenate([xl, yl], axis=1)).to(self.device)
        both = self.fops.to_montgomery(both)
        return self.ed.from_affine_arrays(both[:, :N], both[:, N:])

    def to_device(self, points: list[EdwardsPoint]) -> EdwardsBatch:
        return self.ed.to_device(points, self.device)

    def is_on_curve(self, P: EdwardsBatch) -> torch.Tensor:
        """Bool (N,): each point is on the curve (T Z == X Y included)."""
        return self.ed.is_on_curve(P)

    # ------------------------------------------------------------- pipeline

    def num_windows(self, c: int) -> int:
        return num_windows(self.scalar_bits, c)

    def digits_device(self, scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
        """(ns, N) scalar limbs -> (K, N) signed c-bit digits (no GLV)."""
        return signed_digits_device(scalar_limbs, SCALAR_W, self.scalar_bits, c)

    def digits(self, scalars, c: int, scalar_bits: int | None = None) -> np.ndarray:
        """Host digits: Python ints -> (K, N) int32 signed c-bit digits of the
        scalars mod q (see `WeierstrassMsm.digits`)."""
        return _host_digits(self.params.order, scalars, c, scalar_bits or self.scalar_bits)

    def msm_device(self, points: EdwardsBatch, digits: torch.Tensor, c: int,
                   window_chunk: int | None = None) -> EdwardsBatch:
        """sum_i s_i P_i from extended points and their signed digits;
        `window_chunk` accumulates that many windows at a time."""
        return msm_digits(self.adapter, self.adapter.pack_rows(points), digits, c, window_chunk)

    def msm_device_full(self, points: EdwardsBatch, scalar_limbs: torch.Tensor,
                        c: int) -> EdwardsBatch:
        """Digits and the MSM, all on the device. points: EdwardsBatch (N);
        scalar_limbs: (ns, N). Returns an EdwardsBatch of one point."""
        return self._stages(points, scalar_limbs, c)

    def msm_phases(self, points: EdwardsBatch, scalar_limbs: torch.Tensor, c: int):
        """msm_device_full as four separately synchronized stages; returns
        (result, PhaseLog)."""
        log = PhaseLog()
        return self._stages(points, scalar_limbs, c, log=log), log

    def _stages(self, points: EdwardsBatch, scalar_limbs: torch.Tensor, c: int,
                log: PhaseLog | None = None) -> EdwardsBatch:
        """The MSM's four stages; each is synchronized and timed into `log`
        when one is given."""
        def phase(label):
            return log.phase(label, self.device) if log is not None else nullcontext()

        with phase("digits (signed windows)"):
            digits = self.digits_device(scalar_limbs, c)
        with phase("pack rows"):
            rows = self.adapter.pack_rows(points)
        with phase("accumulate"):
            buckets, K, L = bucket_accumulate(self.adapter, rows, digits, c)
        with phase("reduce+combine"):
            return reduce_buckets(self.adapter, buckets, c, K, L)

    def default_c(self, N: int) -> int:
        return window_size(max(1, N.bit_length() - 1))

    def msm_full(self, scalars, points, c: int | None = None) -> EdwardsPoint:
        """Host entry: scalars (ints, bytes or an (ns, N) limb tensor) and
        points (oracle points or an EdwardsBatch) -> sum s_i P_i, normalised
        on the device."""
        if isinstance(points, EdwardsBatch):
            P, N = points, points.count
        else:
            N = len(points)
            P = self.to_device(points)
        if N == 0:
            raise ValueError("empty MSM")
        limbs = scalars if isinstance(scalars, torch.Tensor) else self.scalars_to_limbs(scalars)
        if limbs.shape[-1] != N:
            raise ValueError(f"{limbs.shape[-1]} scalars for {N} points")
        S = self.msm_device_full(P, limbs, c or self.default_c(N))
        return self.ed.to_host(S)[0]

    def msm(self, scalars, points, c: int | None = None,
            scalar_bits: int | None = None) -> EdwardsPoint:
        """Host entry: Python ints and points (oracle points or an
        EdwardsBatch) -> sum s_i P_i, from host digits (`digits`, one copy to
        the device) through `msm_device`."""
        if isinstance(points, EdwardsBatch):
            P, N = points, points.count
        else:
            P, N = self.to_device(points), len(points)
        if N == 0 or len(scalars) != N:
            raise ValueError(f"{len(scalars)} scalars for {N} points (N > 0)")
        c = c or self.default_c(N)
        d = torch.from_numpy(self.digits(scalars, c, scalar_bits=scalar_bits)).to(self.device)
        return self.ed.to_host(self.msm_device(P, d, c))[0]


def _host_digits(q: int, scalars, c: int, bits: int) -> np.ndarray:
    """Signed c-bit digits (K, N) of the scalars mod q on the host; the
    JAX package asserts where this raises ValueError (a reduced scalar above
    `bits` bits)."""
    sc = [s % q for s in scalars]
    if any(v.bit_length() > bits for v in sc):
        raise ValueError(f"a scalar mod q exceeds scalar_bits = {bits}")
    return signed_digits(sc, bits, c)


def _sub_if_ge(words: np.ndarray, v: int) -> np.ndarray:
    """words - v where words >= v, else words, lane by lane; words: (nw, N)
    uint64, v below 2^(64 nw)."""
    out = np.empty_like(words)
    borrow = np.zeros(words.shape[1], dtype=bool)
    for k, a in enumerate(words):
        vk = np.uint64((v >> (64 * k)) & 0xFFFFFFFFFFFFFFFF)
        out[k] = a - vk - borrow.astype(np.uint64)
        borrow = (a < vk) | ((a == vk) & borrow)
    return np.where(borrow[None], words, out)
