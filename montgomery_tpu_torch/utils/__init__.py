"""Utilities: phase timing."""

from .timing import PhaseLog, sync, timeit
