"""Utilities: phase timing and device memory reports."""

from .memory import device_memory_stats, print_max_size_used
from .timing import PhaseLog, sync, tic, timeit, toc
