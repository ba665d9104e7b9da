#!/usr/bin/env python3
"""GPU smoke run of montgomery_tpu_torch on one CUDA card.

Builds the CUDA kernels from `montgomery_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card, runs BLS12-377 MSMs against
the bigint oracle and against a closed form, and times the MSM.

    python3 chip_smoke.py

Phases, each printed as it runs:
  0. environment: torch, CUDA, nvcc, triton, card name and power limit,
     kernel build time and register counts;
  1. each kernel against its plain version at 2^16 and 2^16 + 17 lanes on
     adversarial inputs (canonical values must be equal), with both times;
  2. the MSM at N = 16 and N = 2^9 against the bigint oracle, with zero
     scalars, duplicate points and the point at infinity;
  3. the MSM at N = 2^16 and 2^20 (c from window_size) on
     random_points_fast(seed=42) points, checked at full N against
     S = sum_t (sum_i s_i (idx[t, i] + 3) mod q) B_t; launch counts of the
     main-path run, median time of 5 runs, phase split and peak memory.
The last two lines are a JSON object of per-kernel results and a JSON
object {"ok": true, "device": {...}}. Any failure raises; without a CUDA
device the script exits 1 before printing a result.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED_POINTS = 42
SEED_SCALARS = 7
KERNEL_LANES = (1 << 16, (1 << 16) + 17)  # main-path width, and a ragged edge
MSM_LOG2N = (16, 20)
KERNEL_REPS = 200  # back-to-back launches per kernel timing (tens of ms on the card)


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "nvidia-smi unavailable"


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ----------------------------------------------------------------- phase 0


def phase_env():
    import torch

    from montgomery_tpu_torch.ops import kernels

    say("== phase 0: environment")
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    nv = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True)
    say("nvcc:", nv.stdout.strip().splitlines()[-1] if nv.stdout else nv.stderr.strip())
    try:
        import triton  # noqa: F401

        say(f"triton importable ({triton.__version__})")
    except ImportError:
        say("triton not importable")
    say("card:", smi_line())
    kernels.LIBRARY.get()
    say(f"kernel build: {kernels.LIBRARY.build_seconds:.1f} s -> {kernels.LIBRARY.path}")
    for line in kernels.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip())


# ----------------------------------------------------------------- phase 1


def _canon(f, t):
    """Canonical values (reduced mod p) of int32 planes, as int64 words."""
    import torch

    return f.reduce(t).to(torch.int64) & 0xFFFFFFFF


def _field_inputs(f, N: int, rng: random.Random) -> list[int]:
    p = f.p
    adv = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, f.R_mod_p, f.R2]
    return adv + [rng.randrange(2 * p) for _ in range(N - len(adv))]


def _point_inputs(ctx, pts, N: int, rng: random.Random):
    """Two projective batches (P, Q) in Montgomery form with random Z and
    adversarial lanes: P == Q, P == -Q, zero operands, unreduced [p, 2p)."""
    f = ctx.fops
    p, R = f.p, f.R
    cols = ([], [], []), ([], [], [])
    for i in range(N):
        a, b = pts[i % len(pts)], pts[(7 * i + 3) % len(pts)]
        k = i % 512
        if k < 64:
            b = a
        for side, pt in enumerate((a, b)):
            z = rng.randrange(1, p)
            X, Y, Z = pt.x * z % p, pt.y * z % p, z
            if side == 1 and 64 <= k < 128:
                Y = (-Y) % p  # Q = -P
            if (side == 0 and 128 <= k < 192) or (side == 1 and 192 <= k < 256) or 256 <= k < 288:
                X, Y, Z = 0, 1, 0  # point at infinity
            vals = [v * R % p for v in (X, Y, Z)]
            if 288 <= k < 400:  # unreduced representatives in [p, 2p)
                vals = [v + p for v in vals]
            for c in range(3):
                cols[side][c].append(vals[c])
    from montgomery_tpu_torch.curves.projective import ProjectiveBatch

    dev = ctx.device
    return [ProjectiveBatch(*[f.pack_raw(c, dev) for c in side]) for side in cols]


def _scalar_inputs(q: int, N: int, rng: random.Random) -> list[int]:
    adv = [0, 1, 2, q - 1, q - 2, (q - 1) // 2] + [(1 << k) % q for k in (63, 127, 128, 200, 252)]
    return adv + [rng.randrange(q) for _ in range(N - len(adv))]


def phase_kernels(ctx, pts):
    import torch

    from montgomery_tpu_torch.scalar.device import digits_glv_plain

    say("== phase 1: kernels against their plain versions")
    f, proj = ctx.fops, ctx.proj
    rng = random.Random(1)
    results = {}

    def record(name, err, ms, plain_ms):
        r = results.setdefault(name, {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def diff(a, b):
        return int((a - b).abs().max()) if a.numel() else 0

    for N in KERNEL_LANES:
        timed = N == KERNEL_LANES[0]
        # kernel 1: mul_const by beta, R^2, 1 and 3b
        x = f.pack_raw(_field_inputs(f, N, rng), ctx.device)
        for name, cst in (("beta", proj.beta_mont), ("R^2", f.R2), ("1", 1), ("3b", proj.b3_mont)):
            k_out = _canon(f, f.mul_const(x, cst))
            p_out = _canon(f, f.mul_const_plain(x, cst))
            err = diff(k_out, p_out)
            say(f"mul_const[{name}] N={N}: max_abs_err {err}")
            if err:
                raise AssertionError(f"mul_const[{name}] disagrees with its plain version")
        ms = cuda_time_ms(lambda: f.mul_const(x, proj.beta_mont), KERNEL_REPS) if timed else None
        pms = cuda_time_ms(lambda: f.mul_const_plain(x, proj.beta_mont), 5, 1) if timed else None
        record("mul_const", 0, ms, pms)

        # kernel 2: RCB add
        P, Q = _point_inputs(ctx, pts, N, rng)
        k_out = proj.add(P, Q)
        p_out = proj.add_plain(P, Q)
        err = max(diff(_canon(f, a), _canon(f, b)) for a, b in zip(k_out, p_out))
        say(f"proj_add_rcb N={N}: max_abs_err {err}")
        if err:
            raise AssertionError("proj_add_rcb disagrees with its plain version")
        ms = cuda_time_ms(lambda: proj.add(P, Q), KERNEL_REPS) if timed else None
        pms = cuda_time_ms(lambda: proj.add_plain(P, Q), 3, 1) if timed else None
        record("proj_add_rcb", err, ms, pms)

        # kernel 3: k doublings, k = 1 (double) and k = 13 (a combine level)
        for k in (1, 13):
            k_out = proj.double_n(P, k)
            p_out = proj.double_n_plain(P, k)
            err = max(diff(_canon(f, a), _canon(f, b)) for a, b in zip(k_out, p_out))
            say(f"proj_dbl_rcb k={k} N={N}: max_abs_err {err}")
            if err:
                raise AssertionError(f"proj_dbl_rcb k={k} disagrees with its plain version")
            record("proj_dbl_rcb", err, None, None)
        if timed:
            results["proj_dbl_rcb"]["ms"] = cuda_time_ms(lambda: proj.double_n(P, 1), KERNEL_REPS)
            results["proj_dbl_rcb"]["plain_ms"] = cuda_time_ms(lambda: proj.double_n_plain(P, 1), 3, 1)

        # kernel 4: GLV digits at the main path's window sizes
        sl = ctx.scalars_to_limbs(_scalar_inputs(ctx.params.order, N, rng))
        for c in (11, 13):
            k_out = ctx.digits(sl, c)
            p_out = digits_glv_plain(ctx.glv_dev, sl, c)
            err = diff(k_out.to(torch.int64), p_out.to(torch.int64))
            say(f"glv_digits c={c} N={N}: shape {tuple(k_out.shape)} max_abs_err {err}")
            if err or k_out.shape != p_out.shape:
                raise AssertionError(f"glv_digits c={c} disagrees with its plain version")
            record("glv_digits", err, None, None)
        if timed:
            results["glv_digits"]["ms"] = cuda_time_ms(lambda: ctx.digits(sl, 13), KERNEL_REPS)
            results["glv_digits"]["plain_ms"] = cuda_time_ms(
                lambda: digits_glv_plain(ctx.glv_dev, sl, 13), 3, 1)
    for name, r in results.items():
        say(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms per call at {KERNEL_LANES[0]} lanes")
    return results


# ----------------------------------------------------------------- phase 2


def phase_oracle(ctx):
    from montgomery_tpu_torch.bigint import AffinePoint, WeierstrassCurve, msm as oracle_msm

    say("== phase 2: MSM against the bigint oracle")
    E = WeierstrassCurve(ctx.params)
    q = ctx.params.order
    rng = random.Random(2)
    base = [E.random_point(rng) for _ in range(24)]
    for N in (16, 1 << 9):
        pts = [base[(5 * i) % len(base)] for i in range(N)]  # duplicates
        pts[1] = AffinePoint.zero()
        sc = [rng.randrange(q) for _ in range(N)]
        sc[0] = sc[3] = 0
        sc[2], sc[4] = 1, q - 1
        t0 = time.perf_counter()
        got = ctx.msm_full(sc, pts)
        dt = time.perf_counter() - t0
        exp = oracle_msm(E, sc, pts)
        if not E.equal(got, exp):
            raise AssertionError(f"MSM at N={N} differs from the oracle")
        say(f"N={N}: equal to the oracle ({dt:.2f} s incl. first calls)")


# ----------------------------------------------------------------- phase 3


def closed_form(params, scalars, seed: int, n_drawn: int):
    """sum_t (sum_i s_i (idx[t, i] + 3) mod q) B_t with Python ints, for the
    first len(scalars) of n_drawn points of random_points_fast(seed)."""
    from montgomery_tpu_torch.bigint import WeierstrassCurve
    from montgomery_tpu_torch.curves.random import table_bases, table_indices

    E = WeierstrassCurve(params)
    q = params.order
    idx = table_indices(seed, n_drawn)[:, :len(scalars)]
    acc = E.scale(0, E.generator)
    for t, B in enumerate(table_bases(params, seed)):
        per = [0] * 512
        for s, j in zip(scalars, idx[t].tolist()):
            per[j] += s
        coef = sum(v * (j + 3) for j, v in enumerate(per)) % q
        acc = E.add(acc, E.scale(coef, B))
    return acc


def bench_scalars(q: int, N: int) -> list[int]:
    import numpy as np

    raw = np.random.default_rng(SEED_SCALARS).integers(0, 256, size=N * 32, dtype=np.uint8).tobytes()
    return [int.from_bytes(raw[32 * i: 32 * (i + 1)], "little") % q for i in range(N)]


def phase_msm(ctx, log2n: int, pts_full):
    import torch

    from montgomery_tpu_torch.bigint import WeierstrassCurve
    from montgomery_tpu_torch.curves.projective import AffineBatch
    from montgomery_tpu_torch.ops import kernels
    from montgomery_tpu_torch.scalar.slicing import num_windows
    from montgomery_tpu_torch.utils.timing import timeit

    N = 1 << log2n
    c = ctx.default_c(N)
    K = num_windows(ctx.glv_dev.max_bits_eff, c)
    say(f"== phase 3: BLS12-377 MSM N=2^{log2n}, c={c}, K={K} (GLV halves), "
        f"projective engine, n={ctx.fops.n} limbs of 32 bits")
    A = AffineBatch(*[a[..., :N] for a in pts_full])
    scalars = bench_scalars(ctx.params.order, N)
    limbs = ctx.scalars_to_limbs(scalars)
    dev = ctx.device

    def run():
        return ctx.msm_device_full(A, limbs, c)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    S = run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.launch_counts()
    say(f"main-path launches: {counts} (first run {first:.3f} s)")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    got = ctx.proj.to_host(S)[0]
    E = WeierstrassCurve(ctx.params)
    t0 = time.perf_counter()
    exp = closed_form(ctx.params, scalars, SEED_POINTS, pts_full.count)
    if got.is_zero or not E.equal(got, exp):
        raise AssertionError(f"MSM at N=2^{log2n} differs from the closed form")
    say(f"full-N check: equal to the closed form ({time.perf_counter() - t0:.1f} s on the host)")

    med, times = timeit(run, device=dev, reps=5, warmup=1)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    _, log = ctx.msm_phases(A, limbs, c)
    say(f"msm N=2^{log2n}: median {med:.6f} s over 5 runs {['%.6f' % t for t in times]}; "
        f"peak memory {peak / 2**20:.1f} MiB")
    say("phase split:\n" + log.report())
    return counts, med


def main() -> int:
    try:
        import torch
    except ImportError:
        say("torch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("no CUDA device: this run needs one GPU")
        return 1
    from montgomery_tpu_torch.concrete import BLS12_377
    from montgomery_tpu_torch.curves.random import random_points_fast
    from montgomery_tpu_torch.msm import WeierstrassMsm
    from montgomery_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    phase_env()
    ctx = WeierstrassMsm(BLS12_377, device=dev)
    t0 = time.perf_counter()
    pts = random_points_fast(ctx.proj, 1 << max(MSM_LOG2N), seed=SEED_POINTS, device=dev,
                             cache_dir=ROOT / "build" / "points")
    torch.cuda.synchronize()
    say(f"points: 2^{max(MSM_LOG2N)} from random_points_fast(seed={SEED_POINTS}) in {time.perf_counter() - t0:.1f} s")
    host_pts = ctx.proj.affine_to_host(type(pts)(*[a[..., :4096] for a in pts]))
    kres = phase_kernels(ctx, host_pts)
    phase_oracle(ctx)
    counts = {}
    for log2n in MSM_LOG2N:
        counts, _ = phase_msm(ctx, log2n, pts)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": counts[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]}
        for name, k in kernels.REGISTRY.items()]}
    say(json.dumps(line))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
