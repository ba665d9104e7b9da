"""The carry-chain Montgomery product and square of `csrc/madc.cuh`
(`fe_mul_cc`, `fe_sqr_cc`), modelled op by op in Python ints: the even and
odd accumulators, the carry flag as PTX sets it, the row shift with its fold
and the top word X; for the square the cross-product rows with their live
extents, the doubling, the diagonal and the reduction rows that take T's
high words in. Each op that the header issues without a carry out asserts
that none was lost. The product model is held bit for bit against `fe_mul`'s
plain version (`FieldOps.mul_plain`, the CIOS product on 16-bit halves that
the card's kernels are held to) and against (a b + m p) / R in Python ints,
at 2, 3, 9, 12 and 13 limbs (babybear and goldilocks beside the curves; at
one limb the header runs field.cuh's CIOS product instead): 0, 1, p - 1,
values in [p, 2p) and up to 8p, pairs at
the a b < R p limit with either operand near R, and seeded random operands;
the square model against `mul_plain(a, a)` and (a^2 + m p) / R on 0, 1,
p - 1, [p, 2p), up to 8p, the largest a with a^2 < R p and seeded random
values. Tolerance zero. CPU only: the CUDA header itself is checked on the card by
`chip_smoke.py` through the kernels that use it.
"""

import math

import numpy as np
import pytest
import torch

from montgomery_tpu_torch.concrete import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import create_field_ops

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
CURVES = {"ed-on-bls12-377": ED_ON_BLS12_377, "pallas": PALLAS, "bls12-377": BLS12_377,
          "bls12-381": BLS12_381}
# the moduli the product and square models run at: the curves' base fields
# and the example fields of 2 and 3 limbs
MODULI = {**{name: c.modulus for name, c in CURVES.items()}, "babybear": (1 << 31) - 1,
          "goldilocks": (1 << 64) - (1 << 32) + 1}
LIMBS = {"ed-on-bls12-377": 9, "pallas": 9, "bls12-377": 12, "bls12-381": 13, "babybear": 2, "goldilocks": 3}
BY_LIMBS = {2: "babybear", 3: "goldilocks", 9: "pallas", 12: "bls12-377", 13: "bls12-381"}


class Ptx:
    """The 32-bit PTX integer ops of madc.cuh with the carry flag CC;
    `ops` counts each op by its PTX name."""

    def __init__(self):
        self.cc = 0
        self.ops: dict[str, int] = {}

    def _count(self, name):
        self.ops[name] = self.ops.get(name, 0) + 1

    def mul_lo(self, a, b):
        self._count("mul.lo")
        return a * b & M32

    def mul_hi(self, a, b):
        self._count("mul.hi")
        return a * b >> 32

    def _set(self, name, s):
        self._count(name)
        self.cc = s >> 32
        return s & M32

    def mad_lo(self, a, b, c):
        return self._set("mad.lo.cc", (a * b & M32) + c)

    def madc_lo(self, a, b, c):
        return self._set("madc.lo.cc", (a * b & M32) + c + self.cc)

    def madc_hi(self, a, b, c):
        return self._set("madc.hi.cc", (a * b >> 32) + c + self.cc)

    def mad_hi(self, a, b, c):
        return self._set("mad.hi.cc", (a * b >> 32) + c)

    def madc_hi_end(self, a, b, c):
        """madc.hi.u32 keeps no carry: the header relies on there being none."""
        self._count("madc.hi")
        s = (a * b >> 32) + c + self.cc
        assert s >> 32 == 0, "madc.hi.u32 dropped a carry"
        return s

    def add(self, a, b):
        return self._set("add.cc", a + b)

    def addc_cc(self, a, b):
        return self._set("addc.cc", a + b + self.cc)

    def addc(self, a, b):
        """addc.u32 keeps no carry: the header relies on there being none."""
        self._count("addc")
        s = a + b + self.cc
        assert s >> 32 == 0, "addc.u32 dropped a carry"
        return s


def odd_chain(P, H, X, v, s, carry_in):
    n = len(H)
    for j in range(1, n, 2):
        H[j - 1] = P.madc_lo(v[j], s, H[j - 1]) if carry_in or j > 1 else P.mad_lo(v[j], s, H[j - 1])
        H[j] = P.madc_hi(v[j], s, H[j])
    if n % 2:
        H[n - 1] = P.addc_cc(H[n - 1], 0)
    return P.addc(X, 0)


def even_chain(P, L, H, X, v, s):
    n = len(L)
    for j in range(0, n - 1, 2):
        L[j] = P.mad_lo(v[j], s, L[j]) if j == 0 else P.madc_lo(v[j], s, L[j])
        L[j + 1] = P.madc_hi(v[j], s, L[j + 1])
    if n % 2:
        L[n - 1] = P.madc_lo(v[n - 1], s, L[n - 1])
        H[n - 1] = P.madc_hi(v[n - 1], s, H[n - 1])
    else:
        H[n - 1] = P.addc_cc(H[n - 1], 0)
    return P.addc(X, 0)


def fe_mul_cc_model(a, b, p, mu, P=None):
    """fe_mul_cc of csrc/madc.cuh on word lists (little-endian, n words),
    in the header's order of ops. Returns the n result words."""
    P = P or Ptx()
    n = len(a)
    L, H, X = [0] * n, [0] * n, 0
    for j in range(0, n - 1, 2):
        L[j], L[j + 1] = P.mul_lo(a[j], b[0]), P.mul_hi(a[j], b[0])
    for j in range(1, n, 2):
        H[j - 1], H[j] = P.mul_lo(a[j], b[0]), P.mul_hi(a[j], b[0])
    if n % 2:
        L[n - 1], H[n - 1] = P.mul_lo(a[n - 1], b[0]), P.mul_hi(a[n - 1], b[0])
    for i in range(n):
        if i > 0:
            fold = L[1]
            L, H, X = H, L[2:] + [0, X], 0
            L[0] = P.add(L[0], fold)
            X = odd_chain(P, H, X, a, b[i], True)
            X = even_chain(P, L, H, X, a, b[i])
        m = L[0] * mu & M32
        X = odd_chain(P, H, X, p, m, False)
        X = even_chain(P, L, H, X, p, m)
        assert L[0] == 0, "the row's quotient left a nonzero low word"
    r = [P.add(H[0], L[1])]
    r += [P.addc_cc(H[k], L[k + 1]) for k in range(1, n - 1)]
    r.append(P.addc(H[n - 1], 0))
    assert X == 0
    return r


def sqr_top(n, q, i):
    """Top position of row i's cross-product chain in accumulator q (1: the
    products a_i a_j with j - i odd, 0: even), as madc.cuh's sqr_top."""
    return i + (n - 1 if (n - 1 - i) % 2 == q else n - 2) + 1


def fe_sqr_cc_model(a, p, mu, P=None):
    """fe_sqr_cc of csrc/madc.cuh on word lists, in the header's order of
    ops. Returns the n result words."""
    P = P or Ptx()
    n = len(a)
    acc = {1: [0] * (2 * n), 0: [0] * (2 * n)}
    live = {}
    for i in range(n - 1):
        for q in (1, 0):
            A, js = acc[q], list(range(i + 2 - q, n, 2))
            if not js:
                continue
            if i == 0:  # the first row's words do not overlap: plain products
                for j in js:
                    A[j], A[j + 1] = P.mul_lo(a[0], a[j]), P.mul_hi(a[0], a[j])
                live[q] = sqr_top(n, q, 0)
                continue
            for j in js:
                A[i + j] = (P.mad_lo if j == js[0] else P.madc_lo)(a[i], a[j], A[i + j])
                A[i + j + 1] = P.madc_hi(a[i], a[j], A[i + j + 1])
            top = sqr_top(n, q, i)
            assert top == i + js[-1] + 1
            for k in range(top + 1, live[q] + 1):
                A[k] = P.addc_cc(A[k], 0)
            live[q] = max(top, live[q]) + 1
            assert acc[q][live[q]] == 0, "the carry word held data"
            A[live[q]] = P.addc(0, 0)
    O, E = acc[1], acc[0]
    assert E[:2] == [0, 0] and O[0] == 0
    D = [0, O[1], P.add(O[2], E[2])]
    D += [P.addc_cc(O[k], E[k]) for k in range(3, 2 * n - 1)]
    D.append(P.addc(O[2 * n - 1], E[2 * n - 1]))
    T = [0] + [((D[k] << 1) | (D[k - 1] >> 31)) & M32 for k in range(1, 2 * n)]
    assert D[2 * n - 1] >> 31 == 0, "the doubling lost the top bit"
    T[0] = P.mul_lo(a[0], a[0])
    T[1] = P.mad_hi(a[0], a[0], T[1])
    for k in range(1, n):
        T[2 * k] = P.madc_lo(a[k], a[k], T[2 * k])
        T[2 * k + 1] = (P.madc_hi if k < n - 1 else P.madc_hi_end)(a[k], a[k], T[2 * k + 1])
    L, H, X = T[:n], [0] * n, 0
    for i in range(n):
        if i > 0:
            fold = L[1]
            L, H, X = H, L[2:] + [T[n + i - 1], X], 0
            m = (L[0] + fold) * mu & M32
            L[0] = P.add(L[0], fold)
            X = odd_chain(P, H, X, p, m, True)
        else:
            m = L[0] * mu & M32
            X = odd_chain(P, H, X, p, m, False)
        X = even_chain(P, L, H, X, p, m)
        assert L[0] == 0, "the row's quotient left a nonzero low word"
        assert X == 0, "the square's window reached position NL + 1"
    r = [P.add(H[0], L[1])]
    r += [P.addc_cc(H[k], L[k + 1]) for k in range(1, n - 1)]
    r.append(P.addc(H[n - 1], T[2 * n - 1]))
    return r


def _words(v, n):
    return [(v >> (32 * k)) & M32 for k in range(n)]


def _value(words):
    return sum(w << (32 * k) for k, w in enumerate(words))


def _operands(f, rng: np.random.Generator, count: int):
    """(a, b) pairs: edge values, [p, 2p) and up to 8p, the a b < R p limit
    with either operand near R, then seeded random values below 8p."""
    p, R = f.p, f.R
    edge = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, 8 * p - 1, f.R_mod_p, R // 2]
    pairs = [(x, y) for x in edge for y in edge if x * y < R * p]
    for big in (R - 1, R - 2, R - p, R - p - 1, R // 2 + 1, 64 * p):
        small = (R * p - 1) // big  # the largest partner with big * small < R p
        pairs += [(big, small), (small, big), (big, small - 1), (small // 3, big)]
    # a big operand against a partner whose low words are all ones
    for k in range(1, f.n):
        ones = (1 << (32 * k)) - 1
        if (R - 1) * ones < R * p:
            pairs += [(R - 1, ones), (ones, R - 1)]
    nb = (8 * p).bit_length() // 8 + 8
    raw = rng.bytes(2 * count * nb)
    vals = [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") % (8 * p) for i in range(2 * count)]
    pairs += list(zip(vals[::2], vals[1::2]))
    for x, y in pairs:
        assert 0 <= x < R and 0 <= y < R and x * y < R * p
    return pairs


@pytest.mark.parametrize("curve", list(MODULI))
def test_model_equals_plain_product(curve):
    """fe_mul_cc's word order gives fe_mul's words: against mul_plain on
    the same planes and against (a b + m p) / R."""
    f = create_field_ops(MODULI[curve])
    n, p, R = f.n, f.p, f.R
    assert n == LIMBS[curve]
    pairs = _operands(f, np.random.default_rng(14), 300)
    pw, mu = _words(p, n), f.mu
    got = [_value(fe_mul_cc_model(_words(x, n), _words(y, n), pw, mu)) for x, y in pairs]
    plain = f.mul_plain(f.pack_raw([x for x, _ in pairs], "cpu"), f.pack_raw([y for _, y in pairs], "cpu"))
    assert got == codec.unpack(plain)
    minv = -pow(p, -1, R) % R
    for (x, y), g in zip(pairs, got):
        m = x * y * minv % R
        assert g == (x * y + m * p) // R
        assert g < 2 * p


@pytest.mark.parametrize("n", (2, 3, 9, 12, 13))
def test_model_issues_the_products_of_fe_mul(n):
    """One product issues the 2 n^2 32x32 products of fe_mul (each as its
    lo and hi half) and n quotient digits; the chains' extra adds are the
    fold and the tails: at most 3 a chain."""
    f = create_field_ops(MODULI[BY_LIMBS[n]])
    P = Ptx()
    fe_mul_cc_model(_words(f.p - 1, n), _words(f.p - 2, n), _words(f.p, n), f.mu, P)
    lo = P.ops["mul.lo"] + P.ops["mad.lo.cc"] + P.ops["madc.lo.cc"]
    hi = P.ops["mul.hi"] + P.ops["madc.hi.cc"]
    assert lo == hi == 2 * n * n
    adds = P.ops["add.cc"] + P.ops["addc.cc"] + P.ops["addc"]
    assert adds <= 4 * n * 2 + n


def _square_operands(f, rng: np.random.Generator, count: int) -> list[int]:
    """Edge values, the largest a with a^2 < R p and its neighbours below,
    then seeded random values below 8p and below that largest a."""
    p, R = f.p, f.R
    top = math.isqrt(R * p - 1)
    vals = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, 8 * p - 1, f.R_mod_p, top, top - 1, top - (1 << 32)]
    vals += [top >> k for k in (1, 32, 33)] + [v for v in [(1 << (32 * f.n // 2 + 16)) - 1] if v * v < R * p]
    nb = (top.bit_length() + 7) // 8 + 8
    raw = rng.bytes(2 * count * nb)
    draws = [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") for i in range(2 * count)]
    vals += [v % (8 * p) for v in draws[:count]] + [v % (top + 1) for v in draws[count:]]
    assert all(0 <= v and v * v < R * p for v in vals)
    return vals


@pytest.mark.parametrize("curve", list(MODULI))
def test_square_model_equals_plain_square(curve):
    """fe_sqr_cc's word order gives fe_sqr's (and fe_mul's) words: against
    mul_plain(a, a) on the same planes and against (a^2 + m p) / R, with no
    carry lost on any op."""
    f = create_field_ops(MODULI[curve])
    n, p, R = f.n, f.p, f.R
    vals = _square_operands(f, np.random.default_rng(15), 200)
    pw = _words(p, n)
    got = [_value(fe_sqr_cc_model(_words(x, n), pw, f.mu)) for x in vals]
    x = f.pack_raw(vals, "cpu")
    assert got == codec.unpack(f.mul_plain(x, x))
    minv = -pow(p, -1, R) % R
    for v, g in zip(vals, got):
        assert g == (v * v + (v * v * minv % R) * p) // R
        assert g < 2 * p


@pytest.mark.parametrize("n", (2, 3, 9, 12, 13))
def test_square_model_issues_fewer_products(n):
    """One square issues n (n - 1) / 2 cross products, n diagonal squares
    and n^2 reduction products (each as its lo and hi half): 222 at 12
    limbs against the product's 288."""
    f = create_field_ops(MODULI[BY_LIMBS[n]])
    P = Ptx()
    fe_sqr_cc_model(_words(f.p - 1, n), _words(f.p, n), f.mu, P)
    lo = P.ops["mul.lo"] + P.ops["mad.lo.cc"] + P.ops["madc.lo.cc"]
    hi = P.ops["mul.hi"] + P.ops["madc.hi.cc"] + P.ops["mad.hi.cc"] + P.ops["madc.hi"]
    assert lo == hi == n * (n - 1) // 2 + n + n * n


# ------------------------------------------------------------------- chord
#
# affine.cuh's aff_chord on CarryChainMul, and aff_post_packed_u.cu's fused
# last descent level, composed from the two models: every operand held to
# the range the header states ([0, 2p)) and every product to a b < R p.


class ChordModel:
    """The unsafe chord and the fused post of csrc/affine.cuh and
    csrc/aff_post_packed_u.cu on Python ints, each product and square by the
    op-by-op models; `products` records every product's operands."""

    def __init__(self, f):
        self.f, self.n, self.p, self.R = f, f.n, f.p, f.R
        self.pw = _words(f.p, f.n)
        self.products: list[tuple[int, int]] = []

    def _check(self, *vals):
        assert all(0 <= v < 2 * self.p for v in vals), "an operand left [0, 2p)"

    def mul(self, a, b):
        self._check(a, b)
        self.products.append((a, b))
        r = _value(fe_mul_cc_model(_words(a, self.n), _words(b, self.n), self.pw, self.f.mu))
        self._check(r)
        return r

    def sqr(self, a):
        self._check(a)
        self.products.append((a, a))
        r = _value(fe_sqr_cc_model(_words(a, self.n), self.pw, self.f.mu))
        self._check(r)
        return r

    def sub(self, x, y):
        """fe_sub: x - y mod R, plus 2p mod R on a borrow."""
        self._check(x, y)
        d = x - y
        r = (d + 2 * self.p) % self.R if d < 0 else d
        self._check(r)
        return r

    def neg(self, y):
        """fe_neg: 2p - y, less 2p where that does not borrow."""
        self._check(y)
        d = 2 * self.p - y
        return d - 2 * self.p if d >= 2 * self.p else d

    def chord(self, x1, y1, x2, y2, dinv):
        lam = self.mul(self.sub(y2, y1), dinv)
        x3 = self.sub(self.sub(self.sqr(lam), x1), x2)
        return x3, self.sub(self.mul(lam, self.sub(x1, x3)), y1)

    def post_packed_u(self, A, B, sA, sB, inv1, denom, h, hp):
        """Lane by lane as the kernel: the lane's inverse (one product with
        the partner's denominator below 2h), the signs folded into y, the
        chord, the sum where hp, the signed A elsewhere; packed columns."""
        out = []
        for i, ((x1, y1, inf1), (x2, y2, _)) in enumerate(zip(A, B)):
            if h == 0 or i >= 2 * h:
                d = inv1[h if h else i]
            else:
                d = self.mul(inv1[i if i < h else i - h], denom[i + h if i < h else i - h])
            y1 = self.neg(y1) if sA[i] else y1
            y2 = self.neg(y2) if sB[i] else y2
            x3, y3 = self.chord(x1, y1, x2, y2, d)
            out.append((x3, y3, 0) if hp[i] else (x1, y1, inf1))
        return out


def _below(rng: np.random.Generator, bound: int):
    """Seeded random ints in [0, bound), without end."""
    nb = bound.bit_length() // 8 + 8
    while True:
        yield int.from_bytes(rng.bytes(nb), "little") % bound


def _chord_lanes(f, rng: np.random.Generator, count: int) -> list[tuple[int, int, int, int, int]]:
    """(x1, y1, x2, y2, dinv) lanes: every edge value (0, 1, p - 1, p,
    p + 1, 2p - 1, R mod p) in each position, y2 = y1 (with x2 = x1 too),
    then seeded random values in [0, 2p)."""
    p = f.p
    edge = [0, 1, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p]
    vals = _below(rng, 2 * p)
    lanes = []
    for k, v in enumerate(edge):
        for pos in range(5):
            lane = [next(vals) for _ in range(5)]
            lane[pos] = v
            lanes.append(tuple(lane))
        x, y = next(vals), edge[(k + 3) % len(edge)]
        lanes += [(x, y, next(vals), y, v), (x, y, x, y, v)]
    lanes += [tuple(next(vals) for _ in range(5)) for _ in range(count)]
    return lanes


@pytest.mark.parametrize("curve", ["pallas", "bls12-377", "bls12-381"])
def test_chord_model_equals_plain(curve):
    """The carry-chain chord equals AffineOps' plain chord (`post_unsafe_plain`,
    `_chord16` on 16-bit limbs) and the fused post equals `post_packed_u_plain`
    bit for bit at 9, 12 and 13 limbs, on edge and seeded random lanes with
    both signs, paired and unpaired lanes, an odd width (the carried lane
    i = 2h) and the h = 0 form; every operand stays in [0, 2p) and every
    product takes a b < R p."""
    from montgomery_tpu_torch.curves.affine import AffineOps
    from montgomery_tpu_torch.curves.projective import AffineBatch

    params = CURVES[curve]
    f = create_field_ops(params.modulus)
    n, p, R = f.n, f.p, f.R
    assert n == {"pallas": 9, "bls12-377": 12, "bls12-381": 13}[curve]
    aff = AffineOps(f, params)
    rng = np.random.default_rng(16)
    lanes = _chord_lanes(f, rng, 24)
    model = ChordModel(f)

    # the planar chord
    x1, y1, x2, y2, dinv = (f.pack_raw(list(col), "cpu") for col in zip(*lanes))
    inf = torch.zeros(len(lanes), dtype=torch.bool)
    got = [model.chord(*lane) for lane in lanes]
    want = aff.post_unsafe_plain(AffineBatch(x1, y1, inf), AffineBatch(x2, y2, inf), dinv)
    assert [g[0] for g in got] == codec.unpack(want[0])
    assert [g[1] for g in got] == codec.unpack(want[1])

    # the fused post, h = M // 2 on an odd width and h = 0
    M = len(lanes) | 1
    lanes = lanes[:M] if len(lanes) >= M else lanes + lanes[:M - len(lanes)]
    vals = _below(rng, 2 * p)
    A = [(x, y, int(i % 5 == 0)) for i, (x, y, _, _, _) in enumerate(lanes)]
    B = [(x, y, 0) for _, _, x, y, _ in lanes]
    sA, sB, hp = ([int(v) for v in rng.integers(0, 2, M)] for _ in range(3))
    denom = [next(vals) for _ in range(M)]
    denom[:3] = [f.R_mod_p, 0, 2 * p - 1]

    def packed(cols):
        return torch.cat([f.pack_raw([c[0] for c in cols], "cpu"), f.pack_raw([c[1] for c in cols], "cpu"),
                          torch.tensor([[c[2] for c in cols]], dtype=torch.int32)])

    def row(v):
        return torch.tensor([v], dtype=torch.int32)

    for h in (M // 2, 0):
        inv1 = [lane[4] for lane in lanes[:(M + 1) // 2 if h else M]]
        got = model.post_packed_u(A, B, sA, sB, inv1, denom, h, hp)
        want = aff.post_packed_u_plain(packed(A), packed(B), row(sA), row(sB), f.pack_raw(inv1, "cpu"),
                                       f.pack_raw(denom, "cpu"), h, row(hp))
        assert torch.equal(packed(got), want), f"h = {h}"
    assert len(model.products) > 4 * len(lanes)
    assert all(a * b < R * p for a, b in model.products)
    assert max(a * b for a, b in model.products) < 4 * p * p <= R * p // 16
