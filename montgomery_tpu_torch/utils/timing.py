"""Phase timing: tic/toc pairs collected into a log (counterpart of
`montgomery_tpu/utils/timing.py`). `PhaseLog` and `timeit` time with the
host clock around work that ends in a device synchronize; `timeit(...,
events=True)` brackets each run with CUDA events instead (the
micro-benchmark's timer).

The JAX module's `enable_compilation_cache` turns on XLA's persistent
compile cache. Its counterpart here is the kernels' build cache
(`build/kernels/<hash>/`, `ops/kernels.py`), so it has no copy in this
module."""

from __future__ import annotations

import statistics
import time
from contextlib import contextmanager

import torch


class PhaseLog:
    def __init__(self):
        self.entries: list[tuple[str, float]] = []

    @contextmanager
    def phase(self, label: str, device=None):
        """Time a block; synchronizes `device` (if CUDA) before and after."""
        sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(device)
            self.entries.append((label, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(t for _, t in self.entries)
        lines = [f"{label:<32s} {t * 1e3:9.2f} ms" for label, t in self.entries]
        lines.append(f"{'total':<32s} {total * 1e3:9.2f} ms")
        return "\n".join(lines)


def sync(device=None) -> None:
    """Wait for the CUDA device's queued work (no-op for the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tic() -> float:
    return time.perf_counter()


def toc(t0: float) -> float:
    """Host seconds since `tic()` returned t0."""
    return time.perf_counter() - t0


def timeit(fn, *args, device=None, reps: int = 5, warmup: int = 1,
           events: bool = False) -> tuple[float, list[float]]:
    """Median time of fn(*args) over `reps` runs after `warmup` runs, one
    synchronize per run, by the host clock; with `events` on a CUDA device,
    between CUDA events recorded on its current stream just before and after
    the run (the device's clock, from the enqueue of the first event, so
    host work inside fn counts). Returns (median, all times) in seconds."""
    for _ in range(warmup):
        fn(*args)
        sync(device)
    events = events and device is not None and torch.device(device).type == "cuda"
    ts = []
    for _ in range(reps):
        sync(device)
        if events:
            stream = torch.cuda.current_stream(device)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record(stream)
            fn(*args)
            t1.record(stream)
            sync(device)
            ts.append(t0.elapsed_time(t1) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            sync(device)
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts
