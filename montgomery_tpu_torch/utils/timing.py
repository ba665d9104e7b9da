"""Phase timing: tic/toc pairs collected into a log (counterpart of
`montgomery_tpu/utils/timing.py`). Times are host clock around work that
ends in a device synchronize."""

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


def timeit(fn, *args, device=None, reps: int = 5, warmup: int = 1) -> tuple[float, list[float]]:
    """Median host time of fn(*args) over `reps` runs after `warmup` runs,
    one synchronize per run. Returns (median, all times) in seconds."""
    for _ in range(warmup):
        fn(*args)
        sync(device)
    ts = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts
