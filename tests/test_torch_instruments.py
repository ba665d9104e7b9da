"""montgomery_tpu_torch instruments against montgomery_tpu: `MulCounter`,
`utils/memory.py`, `utils/timing.py`, the `testing/` helpers and the
micro-benchmark (`micro_bench.main`).

MulCounter: the JAX package counts products while it traces a formula; the
port counts them at call time. Each operation runs on the CPU in the port
and under `jax.eval_shape` in the JAX package, the latter as the formula
records while its kernel traces it (nested products inline, one record
each; a fresh trace every time, so no cache hides a count). Both must give
the same calls and lanes at one width.
"""

import contextlib
import random

import jax
import jax.numpy as jnp
import pytest
import torch

from montgomery_tpu.concrete import BLS12_377 as JAX_BLS12_377
from montgomery_tpu.concrete import ED_ON_BLS12_377 as JAX_ED
from montgomery_tpu.curves.edwards import EdwardsBatch as JaxEdwardsBatch
from montgomery_tpu.curves.edwards import EdwardsOps as JaxEdwardsOps
from montgomery_tpu.curves.projective import ProjectiveBatch as JaxProjectiveBatch
from montgomery_tpu.curves.projective import ProjectiveOps as JaxProjectiveOps
from montgomery_tpu.ops import kernels as jkernels
from montgomery_tpu.ops.field import MulCounter as JaxMulCounter
from montgomery_tpu.ops.field import create_field_ops as jax_field_ops
from montgomery_tpu.testing import generators as jgenerators
from montgomery_tpu_torch import micro_bench
from montgomery_tpu_torch.concrete import BLS12_377, ED_ON_BLS12_377
from montgomery_tpu_torch.curves.edwards import EdwardsBatch, EdwardsOps
from montgomery_tpu_torch.curves.projective import ProjectiveBatch, ProjectiveOps
from montgomery_tpu_torch.ops import alt_mul
from montgomery_tpu_torch.ops import limbs as codec
from montgomery_tpu_torch.ops.field import (MulCounter, Plain16, create_field_ops, ladder_products,
                                            sqrt_window_products)
from montgomery_tpu_torch.testing import equivalence, generators
from montgomery_tpu_torch.utils import memory, timing

torch.set_num_threads(1)

WIDTH = 8


@contextlib.contextmanager
def _inside_kernel():
    """As while `kernels.fused` traces a formula: nested fused calls run
    inline and `mul_list` multiplies pair by pair."""
    jkernels._TLS.in_kernel = True
    try:
        yield
    finally:
        jkernels._TLS.in_kernel = False


def _jax_counts(fn, *shapes):
    """Trace fn in a fresh wrapper: a bound method that the JAX package has
    jitted elsewhere (`FieldOps.jitted`, kept alive in its cache) would
    otherwise hit that trace, and its products would go uncounted."""
    with _inside_kernel(), JaxMulCounter() as mc:
        jax.eval_shape(lambda *args: fn(*args), *shapes)
    return mc.calls, mc.lanes


def _port_counts(fn, *args):
    with MulCounter() as mc:
        fn(*args)
    return mc.calls, mc.lanes


@pytest.fixture(scope="module")
def curves():
    jw = JaxProjectiveOps(jax_field_ops(JAX_BLS12_377.modulus, w=13), JAX_BLS12_377)
    je = JaxEdwardsOps(jax_field_ops(JAX_ED.modulus, w=13), JAX_ED)
    fw, fe = create_field_ops(BLS12_377.modulus), create_field_ops(ED_ON_BLS12_377.modulus)
    return jw, je, ProjectiveOps(fw, BLS12_377), EdwardsOps(fe, ED_ON_BLS12_377)


def _cases(jw, je, pw, pe):
    """name -> (JAX fn, its argument shapes, port fn, its CPU arguments)."""
    jf, f = jw.f, pw.f
    S = jax.ShapeDtypeStruct((jf.n, WIDTH), jnp.int32)
    Se = jax.ShapeDtypeStruct((je.f.n, WIDTH), jnp.int32)
    x = f.pack(list(range(3, 3 + WIDTH)), "cpu", to_mont=True)
    xe = pe.f.pack(list(range(5, 5 + WIDTH)), "cpu", to_mont=True)
    P = ProjectiveBatch(x, x, x)
    E = EdwardsBatch(xe, xe, xe, xe)
    JP, JE = JaxProjectiveBatch(S, S, S), JaxEdwardsBatch(Se, Se, Se, Se)
    return {
        "mul": (jf.mul, (S, S), f.mul, (x, x)),
        "square": (jf.square, (S,), f.square, (x,)),
        "mul_const": (jf.to_montgomery, (S,), f.to_montgomery, (x,)),
        "proj_add": (jw.add, (JP, JP), pw.add, (P, P)),
        "proj_double": (jw.double, (JP,), pw.double, (P,)),
        "ed_add": (je.add, (JE, JE), pe.add, (E, E)),
    }


@pytest.mark.parametrize("op", ["mul", "square", "mul_const", "proj_add", "proj_double", "ed_add"])
def test_mul_counter_matches_jax(curves, op):
    jfn, shapes, fn, args = _cases(*curves)[op]
    want = _jax_counts(jfn, *shapes)
    assert want[0] >= 1 and want[1] == want[0] * WIDTH
    assert _port_counts(fn, *args) == want


def test_mul_counter_nesting_and_loops(curves):
    """Counters nest (each active one counts), count nothing once closed,
    and count every iteration of a multi-product kernel (k doublings)."""
    _, _, pw, _ = curves
    f = pw.f
    x = f.pack([7] * WIDTH, "cpu", to_mont=True)
    with MulCounter() as outer:
        f.mul(x, x)
        with MulCounter() as inner:
            pw.double_n(ProjectiveBatch(x, x, x), 3)
    assert (inner.calls, inner.lanes) == (27, 27 * WIDTH)
    assert (outer.calls, outer.lanes) == (28, 28 * WIDTH)
    f.mul(x, x)
    assert outer.calls == 28 and not MulCounter._active
    # the plain-domain inverse and Barrett multiply run no Montgomery product
    bp = alt_mul.barrett_params(f)
    assert _port_counts(lambda: alt_mul.barrett_mul(bp, x, x)) == (0, 0)


def _plain_products(monkeypatch, fn):
    """(MulCounter calls, Montgomery products the plain version ran) of fn()
    on CPU tensors: every product of Plain16 goes through its `mul`."""
    ran = []
    mul = Plain16.mul
    monkeypatch.setattr(Plain16, "mul", lambda self, a, b: ran.append(1) or mul(self, a, b))
    calls, _ = _port_counts(fn)
    return calls, len(ran)


@pytest.mark.parametrize("e", [1, 2, 3, 4, 0b1001101, (1 << 20) - 3, BLS12_377.modulus - 2])
def test_ladder_products_count_the_plain_ladder(monkeypatch, e):
    """`ladder_products(e, w)`, which MulCounter records for one exp_ladder
    launch, is the count of products the kernel's plain sequence runs on the
    sliding-window schedule, at the field's window and at every other."""
    f = create_field_ops(BLS12_377.modulus)
    x = f.pack([3, 5], "cpu", to_mont=True)
    calls, ran = _plain_products(monkeypatch, lambda: f.exp_ladder(x, e))
    assert calls == ladder_products(e, f.ladder_window) == ran
    for w in (2, 3, 5):
        calls, ran = _plain_products(monkeypatch, lambda w=w: f.exp_ladder(x, e, w=w))
        assert calls == ladder_products(e, w) == ran


@pytest.mark.parametrize("k,lk,last", [(0, 4, False), (1, 4, False), (0, 1, True), (11, 2, True)])
def test_sqrt_window_products_count_the_plain_window(monkeypatch, k, lk, last):
    """`sqrt_window_products`, which MulCounter records for one sqrt_win
    launch, is the count of products the kernel's plain window runs."""
    f = create_field_ops(BLS12_377.modulus)
    t = f.pack([3, 5], "cpu", to_mont=True)
    calls, ran = _plain_products(monkeypatch, lambda: f.sqrt_window(t, t, t, k, lk, last))
    assert calls == sqrt_window_products(last) == ran


def test_memory_report_on_cpu():
    cpu = torch.device("cpu")
    assert memory.device_memory_stats(cpu) == {}
    lines = []
    msg = memory.print_max_size_used(cpu, log=lines.append)
    assert lines == [msg] == ["device memory: no stats on the CPU"]


def test_memory_report_needs_a_device_on_cuda():
    """Without a device argument the current CUDA device is read: on a host
    without one that raises, as the other entry points do."""
    if torch.cuda.is_available():
        st = memory.device_memory_stats()
        assert set(st) == {"peak_bytes_in_use", "bytes_in_use", "bytes_limit"}
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            memory.device_memory_stats()


def test_tic_toc_and_timeit():
    t0 = timing.tic()
    med, ts = timing.timeit(lambda a: a + 1, torch.ones(4), device="cpu", reps=3)
    assert timing.toc(t0) >= sum(ts) >= 0 and len(ts) == 3 and min(ts) <= med <= max(ts)
    # CUDA events are asked for, but a CPU device has none: the host clock
    med, ts = timing.timeit(lambda a: a + 1, torch.ones(4), device="cpu", reps=2, events=True)
    assert len(ts) == 2 and min(ts) <= med <= max(ts)


def test_generators_match_jax():
    """The copied generators draw the same values from the same seed."""
    p = BLS12_377.modulus
    for unreduced in (False, True):
        assert generators.sample_field_elements(p, 50, random.Random(3), unreduced) == \
            jgenerators.sample_field_elements(p, 50, random.Random(3), unreduced)
    q = BLS12_377.order
    assert generators.sample_scalars(q, 40, random.Random(4)) == \
        jgenerators.sample_scalars(q, 40, random.Random(4))


def test_equivalence_round_trip():
    f = create_field_ops(BLS12_377.modulus)
    p = f.p
    xs = generators.sample_field_elements(p, 24, random.Random(5), unreduced=True)
    ys = generators.sample_field_elements(p, 24, random.Random(6), unreduced=True)
    assert equivalence.run_unop(f, lambda t: t, xs, "cpu") == [x % p for x in xs]
    assert equivalence.run_binop(f, f.add, xs, ys, "cpu") == [(x + y) % p for x, y in zip(xs, ys)]
    mont = [x * f.R % p for x in xs]
    assert equivalence.run_unop(f, lambda t: t, mont, "cpu", from_mont=True) == [x % p for x in xs]
    equivalence.assert_in_range(f, f.pack_raw(xs, "cpu"), 2 * p, "unreduced")
    with pytest.raises(AssertionError):
        equivalence.assert_in_range(f, f.pack_raw(xs, "cpu"), p, "canonical")


def test_micro_bench_runs_on_cpu():
    """The multiply sections at a small width return their keys, and the
    Barrett chain's planes equal the plain chain's and Python's."""
    lines = []
    out = micro_bench.main(["mul", "altmul"], "cpu", log2n=5, log=lines.append)
    assert out["N"] == 32 and out["device"].startswith("cpu")
    assert set(out["mul"]) >= {"elementwise_lanes_per_s", "mont_mul_per_s", "mont_sqr_per_s",
                               "field_add_per_s", "batch_inv_per_s"}
    alt = out["altmul"]
    assert set(alt) >= {"mont_mul_per_s", "barrett_mul_per_s", "schoolbook_per_s"}
    assert all(v > 0 for r in (out["mul"], alt) for k, v in r.items() if k.endswith("_per_s"))
    f = create_field_ops(BLS12_377.modulus)
    bp = alt_mul.barrett_params(f)
    z = alt["x"]
    for _ in range(alt["chain"]):
        z = alt_mul.barrett_mul_plain(bp, z, alt["y"])
    assert torch.equal(alt["barrett_chain"], z)
    xs, ys = codec.unpack(alt["x"]), codec.unpack(alt["y"])
    p = f.p
    assert max(xs + ys) < p
    assert codec.unpack(z) == [x * pow(y, alt["chain"], p) % p for x, y in zip(xs, ys)]
    assert len(lines) == 9 and lines[0] == "device=cpu (host clock)"
    with pytest.raises(ValueError):
        micro_bench.main(["inverse"], "cpu")


def test_micro_bench_carry_section_on_cpu():
    """The carry sweep times both carries at every width 2^0 .. 2^(log2n+4)
    for each limb count and names the first width where the loop is as
    fast (or None)."""
    lines = []
    out = micro_bench.main(["carry"], "cpu", log2n=1, log=lines.append)
    assert set(out["carry"]) == {f"L{L}" for L in micro_bench.CARRY_LIMBS}
    for r in out["carry"].values():
        assert r["widths"] == [1, 2, 4, 8, 16, 32]
        assert len(r["loop_s"]) == len(r["lookahead_s"]) == 6
        assert all(t > 0 for t in r["loop_s"] + r["lookahead_s"])
        assert r["crossover"] is None or r["crossover"] in r["widths"]
    assert len(lines) == 1 + 2 * len(micro_bench.CARRY_LIMBS)
