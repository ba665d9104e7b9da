"""montgomery_tpu_torch Twisted Edwards window combine against montgomery_tpu.

`EdwardsOps.combine` (on CPU tensors its plain Horner `combine_plain` over
the unified add) against the bigint oracle, the port's halving combine and
the JAX package's log-depth `combine_windows` on its Edwards adapter, with
identity windows (0 : 1 : 1 : 0) among the sums; the adapter's route through
`combine_windows`; and, with a fake library in place of the card, what
`ed_combine` is given and which kernels the bucket reduction launches. The
combines give other extended coordinates, so results are compared as affine
points (tolerance zero); the JAX side runs jitted, in one program. Inputs
come from numpy and `random` seeds.
"""

import contextlib
import random
import types

import jax
import numpy as np
import pytest
import torch

from montgomery_tpu.bigint import TwistedEdwardsCurve
from montgomery_tpu.bigint.twisted_edwards import EdwardsPoint
from montgomery_tpu.concrete import ED_ON_BLS12_377 as JAX_ED
from montgomery_tpu.curves.edwards import EdwardsBatch as JaxEdwardsBatch
from montgomery_tpu.curves.edwards import EdwardsOps as JaxEdwardsOps
from montgomery_tpu.msm import pippenger as jpippenger
from montgomery_tpu.msm.adapters import EdwardsAdapter as JaxEdwardsAdapter
from montgomery_tpu.ops import limbs as jcodec
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu_torch import interop
from montgomery_tpu_torch.concrete import ED_ON_BLS12_377
from montgomery_tpu_torch.curves import edwards
from montgomery_tpu_torch.curves.edwards import EdwardsBatch, EdwardsOps
from montgomery_tpu_torch.msm import pippenger
from montgomery_tpu_torch.msm.adapters import EdwardsAdapter
from montgomery_tpu_torch.ops import kernels
from montgomery_tpu_torch.ops.field import MulCounter, Plain16, create_field_ops
from montgomery_tpu_torch.ops.limbs import to_words

# several test workers share few cores; these small tensors gain nothing
# from intra-op threads
torch.set_num_threads(1)

P = ED_ON_BLS12_377.modulus
W_JAX = 13
# (K, c) of the combine cases: every K of {1, 2, 5} with every c of {1, 3, 4}
CASES = [(K, c) for K in (1, 2, 5) for c in (1, 3, 4)]


@pytest.fixture(scope="module")
def ctx():
    f, jf = create_field_ops(P), jax_field_ops(P, w=W_JAX)
    return f, jf, EdwardsOps(f, ED_ON_BLS12_377), JaxEdwardsOps(jf, JAX_ED), TwistedEdwardsCurve(JAX_ED)


def _points(E, K: int, seed: int) -> list:
    """K window sums: random points with the identity at every third window
    (window 0 of K = 1, windows 0 and 3 of K = 5) and the last window of
    every even seed."""
    rng = random.Random(seed)
    return [EdwardsPoint.zero() if k % 3 == 0 and K > 1 or (k == K - 1 and seed % 2 == 0 and K > 1)
            else E.random_point(rng) for k in range(K)]


def _jax_planes(jf, points, seed: int):
    """JAX Montgomery planes (n, K) of (x z : y z : z : x y z), z random."""
    zs = np.random.default_rng(seed).integers(1, 1 << 62, size=len(points)).tolist()
    rj = 1 << (W_JAX * jf.n)
    cols = [[pt.x * z % P, pt.y * z % P, z, pt.x * pt.y % P * z % P] for pt, z in zip(points, zs)]
    return [jcodec.pack([c[k] * rj % P for c in cols], jf.mp) for k in range(4)]


def _port(f, planes) -> EdwardsBatch:
    return interop.edwards_from_jax(*[np.asarray(a) for a in planes], f, device="cpu")


def _affine(f, batch) -> list:
    """Canonical affine points of an EdwardsBatch, T Z == X Y checked."""
    out = []
    for X, Y, Z, T in zip(*[f.unpack(a.reshape(f.n, -1), from_mont=True) for a in batch]):
        assert T * Z % P == X * Y % P
        zi = pow(Z, -1, P)
        out.append((X * zi % P, Y * zi % P))
    return out


def _oracle(E, points, c: int):
    acc = EdwardsPoint.zero()
    for k, pt in enumerate(points):
        acc = E.add(acc, E.scale(1 << (c * k), pt))
    return acc.x, acc.y


@pytest.fixture(scope="module")
def cases(ctx):
    """(K, c) -> (oracle points, JAX planes, port planes)."""
    f, jf, _, _, E = ctx
    out = {}
    for i, (K, c) in enumerate(CASES):
        pts = _points(E, K, 10 + i)
        J = _jax_planes(jf, pts, 20 + i)
        out[K, c] = (pts, J, _port(f, J))
    return out


@pytest.mark.parametrize("K,c", CASES)
def test_combine_plain_matches_oracle(ctx, cases, K, c):
    """The Horner combine (plain) equals sum_k 2^(ck) W_k by the oracle and
    the halving combine; combine on CPU tensors is combine_plain bit for
    bit, as (n, 1) planes."""
    f, _, ed, _, E = ctx
    pts, _, W = cases[K, c]
    got = ed.combine(W, c)
    assert got.X.shape == (f.n, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, ed.combine_plain(W, c)))
    want = _oracle(E, pts, c)
    assert _affine(f, got) == [want]
    half = pippenger.combine_halving(EdwardsAdapter(ed), W, c, K)
    assert _affine(f, half) == [want]


def test_combine_matches_jax(ctx, cases):
    """The JAX package's combine_windows on its Edwards adapter (log-depth
    halves, a fori_loop of doublings) gives the port's points for every
    case, in one jitted program."""
    f, _, ed, jed, E = ctx
    group = JaxEdwardsAdapter(jed)

    def run(ws):
        return [jpippenger.combine_windows(group, JaxEdwardsBatch(*w), c, K) for (K, c), w in zip(CASES, ws)]

    jres = jax.jit(run)([cases[key][1] for key in CASES])
    for key, jw in zip(CASES, jres):
        pts, _, W = cases[key]
        via_jax = _affine(f, _port(f, [np.asarray(a)[:, :1] for a in jw]))
        assert _affine(f, ed.combine(W, key[1])) == via_jax == [_oracle(E, pts, key[1])], key


def test_combine_at_the_te_shape(ctx):
    """The 2^20 MSM's shape, K = 20 windows of c = 13 bits (247 doublings and
    19 adds), identity windows among them, against the oracle."""
    f, jf, ed, _, E = ctx
    pts = _points(E, 20, 4)
    assert sum(pt == EdwardsPoint.zero() for pt in pts) == 8
    W = _port(f, _jax_planes(jf, pts, 5))
    assert _affine(f, ed.combine(W, 13)) == [_oracle(E, pts, 13)]


def test_combine_batches_and_adapter(ctx, monkeypatch):
    """Planes (n, B, K) combine B lanes at once; the adapter and
    `combine_windows` route the Edwards group to `combine`; MulCounter
    records the Horner's products, the plain version's own count."""
    f, jf, ed, _, E = ctx
    B, K, c = 3, 4, 2
    pts = [p for b in range(B) for p in _points(E, K, 30 + b)]
    flat = _port(f, _jax_planes(jf, pts, 6))
    W = EdwardsBatch(*[a.reshape(f.n, B, K) for a in flat])
    got = ed.combine(W, c)
    assert got.X.shape == (f.n, B, 1)
    assert _affine(f, got) == [_oracle(E, pts[b * K:(b + 1) * K], c) for b in range(B)]
    one = EdwardsBatch(*[a[:, 0] for a in W])
    via = pippenger.combine_windows(EdwardsAdapter(ed), one, c, K)
    assert all(torch.equal(a, b) for a, b in zip(via, ed.combine(one, c)))
    ran, mul = [], Plain16.mul
    monkeypatch.setattr(Plain16, "mul", lambda self, a, b: ran.append(1) or mul(self, a, b))
    with MulCounter() as mc:
        ed.combine(one, c)
    assert mc.calls == (K - 1) * (c + 1) * edwards.ADD_MULS == len(ran)
    with pytest.raises(ValueError):
        ed.combine(one, 0)


@pytest.fixture
def recorded(monkeypatch):
    """Launches reach a fake library (no card): every wrapper takes its
    kernel path on CPU tensors, and the fake entries record their
    arguments."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    lib = types.SimpleNamespace(msm_ed_combine_n9=entry("ed_combine"), msm_ed_dbl_n9=entry("ed_dbl"),
                                msm_ed_add_n9=entry("ed_add"))
    monkeypatch.setattr(kernels.LIBRARY, "get", lambda: lib)
    monkeypatch.setattr(kernels, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    for k in (edwards.ED_COMBINE, edwards.ED_DBL, edwards.ED_ADD):
        monkeypatch.setattr(k, "_fns", {})
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "launches_by_n", {})
    return calls


def test_combine_launch_arguments(ctx, recorded):
    """One ed_combine launch a combine: the windows as (n, B K) planes, K and
    c, k = 2d and mu = -p^-1 mod R (the warp product's), B lanes; planes
    (n, B, 1) back."""
    f, _, ed, _, _ = ctx
    z = torch.zeros((f.n, 2, 20), dtype=torch.int32)
    out = ed.combine(EdwardsBatch(z, z, z, z), 13)
    assert out.X.shape == (f.n, 2, 1)
    name, args = recorded[-1]
    assert name == "ed_combine" and args[8:10] == (20, 13) and args[-2] == 2 and args[-1] == 7
    assert list(args[10]) == [w % (1 << 32) for w in to_words(ed.k_mont, f.n)]
    assert list(args[11]) == [w % (1 << 32) for w in to_words(-pow(P, -1, f.R) % f.R, f.n)]
    assert edwards.ED_COMBINE.launches == 1


def test_reduce_buckets_launches(ctx, recorded):
    """The Edwards bucket reduction with c = 13 at K = 20 windows: one
    ed_combine, one ed_dbl (the window sums' 2^(log2 S) of the row part) and
    the window sums' adds: 37, where the halving combine took 5 more ed_dbl
    and 5 more ed_add (5 levels at K padded to 32)."""
    f, _, ed, _, _ = ctx
    K, c = 20, 13
    L = 1 << (c - 1)
    z = torch.zeros((f.n, K, L), dtype=torch.int32)
    pippenger.reduce_buckets(EdwardsAdapter(ed), EdwardsBatch(z, z, z, z), c, K, L)
    names = [name for name, _ in recorded]
    assert (names.count("ed_combine"), names.count("ed_dbl"), names.count("ed_add")) == (1, 1, 37)
    assert names[-1] == "ed_combine"
