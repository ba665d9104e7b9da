"""Micro-benchmarks of the card's primitives: the measurements behind the
engine's design choices (counterpart of `scripts/micro_bench.py`, the JAX
package's TPU micro-benchmark): the host round trip, the cost of a chain of
small ops, Montgomery product and square rates against elementwise int32
arithmetic, the alternative multipliers (Barrett, schoolbook), gathers in
both layouts, and sorts. The reference chose its multiplier from such a
sweep (doc/zprize22.md:199).

    python -m montgomery_tpu_torch.micro_bench [section ...] [--device cpu] [--log2n 18]

Sections: rtt launch mul altmul gather sort carry (default: all), at the
JAX script's sizes: BLS12-377, N = 2^18 lanes, operands from numpy's
default_rng(1). `carry` (the port's own) times `Plain16`'s two carries of
a sum of two canonical values, the limb loop and the lookahead, at 18 and
24 limbs of 16 bits (P-256, BLS12-377) and every width 2^0 ... 2^(log2n+4)
lanes: where they cross is `Plain16.LOOKAHEAD_LANES`. The operands are drawn below p: the JAX script fed its
Barrett multiply raw 12-bit limbs, values up to 2^384, outside Barrett's
contract. Gathers, sorts and the round trip are PyTorch's own calls
(`index_select`, `torch.sort`, `.item()`), as they were XLA's in the JAX
script. On the card every time is the median of CUDA-event times
(`utils.timing.timeit(..., events=True)`); with --device cpu it is the host clock and measures
PyTorch's CPU kernels, no device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from .concrete import BLS12_377
from .ops.alt_mul import barrett_mul, barrett_params, schoolbook_product
from .ops.field import Plain16, create_field_ops
from .utils.timing import sync, timeit

SECTIONS = ("rtt", "launch", "mul", "altmul", "gather", "sort", "carry")
CARRY_LIMBS = (18, 24)  # 16-bit limbs of P-256 and BLS12-377
SEED = 1


def operands(f, N: int, device, rng: np.random.Generator) -> torch.Tensor:
    """(n, N) planes of values below p: words from `rng` with the top ones
    cut to bits(p) bits (values below 2^bits(p) < 2p), then reduced."""
    w = rng.integers(0, 1 << 32, size=(f.n, N), dtype=np.uint64)
    bits = f.p.bit_length()
    for k in range(f.n):
        keep = bits - 32 * k
        if keep < 32:
            w[k] &= (1 << max(keep, 0)) - 1
    t = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)
    return f.reduce(t)


def _chain(op, k: int):
    def run(x, y):
        z = x
        for _ in range(k):
            z = op(z, y)
        return z
    return run


def main(sections=None, device="cuda", log2n: int = 18, log=print) -> dict:
    """Run the sections on `device` and print their lines; returns the
    numbers (seconds, rates per second) by section, and under "altmul" also
    the Barrett chain's final planes ("barrett_chain") with its operands
    ("x", "y")."""
    sections = list(sections or SECTIONS)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; choose from {SECTIONS}")
    dev = torch.device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"
    log(f"device={where}")
    f = create_field_ops(BLS12_377.modulus)
    n, N = f.n, 1 << log2n
    rng = np.random.default_rng(SEED)
    X, Y = operands(f, N, dev, rng), operands(f, N, dev, rng)
    out: dict = {"device": where, "N": N}

    def tm(fn, *args, reps=5):
        return timeit(fn, *args, device=dev, reps=reps, events=True)[0]

    if "rtt" in sections:
        tiny = torch.ones(1, dtype=torch.int32, device=dev) + 1
        sync(dev)
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            tiny.item()
            ts.append(time.perf_counter() - t0)
        out["rtt"] = {"s": statistics.median(ts)}
        log(f"host<->device RTT (1 elem fetch): {out['rtt']['s'] * 1e3:.4f} ms")

    if "launch" in sections:
        # k chained field adds (each a few PyTorch ops) -> the slope is the
        # cost of one add
        t1 = tm(_chain(f.add, 1), X, X)
        t20 = tm(_chain(f.add, 20), X, X)
        out["launch"] = {"add_1_s": t1, "add_20_s": t20, "per_add_s": (t20 - t1) / 19}
        log(f"add chain: 1 -> {t1 * 1e3:.4f} ms, 20 -> {t20 * 1e3:.4f} ms, "
            f"per-op {(t20 - t1) / 19 * 1e3:.4f} ms @N=2^{log2n}")

    if "mul" in sections:
        k = 30
        t = tm(_chain(lambda a, b: (a * b + a) & 0x7FFFFFF, k), X, Y)
        r = {"elementwise_lanes_per_s": k * N / t, "elementwise_i32_mul_per_s": k * n * N / t}
        log(f"elementwise i32 mul+add+and: {k * N / t / 1e6:.0f} M lanes/s "
            f"({k * n * N / t / 1e9:.1f} G i32-mul/s)")
        t = tm(_chain(f.mul, k), X, Y)
        r.update(mont_mul_per_s=k * N / t, mont_mul_chain_s=t)
        log(f"mont mul:    {k * N / t / 1e6:.1f} M muls/s  ({t * 1e3:.4f} ms/chain)")
        t = tm(_chain(lambda a, _: f.square(a), k), X, Y)
        r["mont_sqr_per_s"] = k * N / t
        log(f"mont square: {k * N / t / 1e6:.1f} M sqrs/s")
        t = tm(_chain(f.add, k), X, Y)
        r["field_add_per_s"] = k * N / t
        log(f"field add:   {k * N / t / 1e6:.1f} M adds/s")
        t = tm(f.batch_inv, X, reps=3)
        r.update(batch_inv_per_s=N / t, batch_inv_s=t)
        log(f"batch_inv:   {N / t / 1e6:.1f} M inv/s ({t * 1e3:.4f} ms @2^{log2n})")
        out["mul"] = r

    if "altmul" in sections:
        # alternative multipliers (reference field-benchmark.ts:28-120:
        # Montgomery against Barrett and the schoolbook product)
        bp = barrett_params(f)
        k = 10
        t = tm(_chain(f.mul, k), X, Y)
        r = {"mont_mul_per_s": k * N / t}
        log(f"montgomery mul:   {k * N / t / 1e6:8.1f} M muls/s")
        barrett_chain = _chain(lambda a, b: barrett_mul(bp, a, b), k)
        t = tm(barrett_chain, X, Y)
        r["barrett_mul_per_s"] = k * N / t
        log(f"barrett mul:      {k * N / t / 1e6:8.1f} M muls/s")
        t = tm(_chain(lambda a, b: schoolbook_product(f, a, b)[:n], k), X, Y)
        r["schoolbook_per_s"] = k * N / t
        log(f"schoolbook (low): {k * N / t / 1e6:8.1f} M prods/s")
        r.update(barrett_chain=barrett_chain(X, Y), x=X, y=Y, chain=k)
        out["altmul"] = r

    if "gather" in sections:
        M = 4 * N  # 2^20 at the default N, the JAX script's count
        idx = torch.from_numpy(rng.integers(0, N, size=M)).to(dev)
        idx_sorted = torch.sort(idx).values
        planes = torch.from_numpy(rng.integers(0, 1 << 12, size=(96, N), dtype=np.int32)).to(dev)
        rows = torch.from_numpy(rng.integers(0, 1 << 12, size=(N, 128), dtype=np.int32)).to(dev)
        r = {}
        for tag, i in (("random", idx), ("sorted", idx_sorted)):
            t = tm(lambda p, i: p.index_select(1, i), planes, i)
            r[f"lanes_{tag}_s"] = t
            log(f"gather lanes  (96,N) index_select[{M}] {tag}: {t * 1e3:8.4f} ms "
                f"({M * 96 * 4 / t / 1e9:.1f} GB/s)")
        for tag, i in (("random", idx), ("sorted", idx_sorted)):
            t = tm(lambda p, i: p.index_select(0, i), rows, i)
            r[f"rows_{tag}_s"] = t
            log(f"gather rows   (N,128) index_select[{M}] {tag}: {t * 1e3:8.4f} ms "
                f"({M * 128 * 4 / t / 1e9:.1f} GB/s)")
        t = tm(lambda p: p.T.contiguous(), rows)
        r["transpose_s"] = t
        log(f"transpose (N,128)->(128,N): {t * 1e3:8.4f} ms")
        out["gather"] = r

    if "sort" in sections:
        r = {}
        for log2m in (17, 20):
            M = 1 << log2m
            keys = torch.from_numpy(rng.integers(0, 1 << 31, size=M, dtype=np.int32)).to(dev)
            vals = torch.from_numpy(rng.integers(0, 1 << 31, size=M, dtype=np.int32)).to(dev)
            keys17 = keys & ((1 << 17) - 1)

            def kv(k, v):
                s = torch.sort(k)
                return s.values, v[s.indices]

            for tag, fn, args in (("keys", lambda k: torch.sort(k), (keys,)),
                                  ("k+v", kv, (keys, vals)), ("17bit+v", kv, (keys17, vals))):
                t = tm(fn, *args)
                r[f"{tag}_2^{log2m}_s"] = t
                log(f"torch.sort {tag:<8s} 2^{log2m}: {t * 1e3:8.4f} ms")
        keys2d = torch.from_numpy(rng.integers(0, 1 << 30, size=(10, 131072), dtype=np.int32)).to(dev)
        t = tm(lambda k: torch.sort(k, dim=1), keys2d)
        r["rows_10x2^17_s"] = t
        log(f"torch.sort (10,2^17) rows:   {t * 1e3:8.4f} ms")
        out["sort"] = r

    if "carry" in sections:
        r = {}
        for L in CARRY_LIMBS:
            widths, loop, ahead = [], [], []
            for k in range(log2n + 5):
                w = 1 << k
                t = torch.from_numpy(rng.integers(0, 1 << 17, size=(L, w), dtype=np.int64)).to(dev)
                widths.append(w)
                loop.append(tm(Plain16.carry, t))
                ahead.append(tm(Plain16.lookahead_carry, t))
            cross = next((w for w, a, b in zip(widths, loop, ahead) if a <= b), None)
            r[f"L{L}"] = {"widths": widths, "loop_s": loop, "lookahead_s": ahead, "crossover": cross}
            log(f"Plain16 carry, {L} limbs: loop / lookahead ms by width: " + ", ".join(
                f"2^{k} {a * 1e3:.4f}/{b * 1e3:.4f}" for k, (a, b) in enumerate(zip(loop, ahead))))
            log(f"Plain16 carry, {L} limbs: the loop first as fast at {cross} lanes "
                f"(LOOKAHEAD_LANES[{dev.type!r}] = {Plain16.LOOKAHEAD_LANES.get(dev.type)})")
        out["carry"] = r
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", help=f"any of {' '.join(SECTIONS)} (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--log2n", type=int, default=18, help="lanes of the field sections, log2")
    args = ap.parse_args()
    main(args.sections, args.device, args.log2n)
