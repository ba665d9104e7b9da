"""torch <-> bigint equivalence harness (counterpart of
`montgomery_tpu/testing/equivalence.py`, the reference's WasmSpec harness,
src/testing/equivalent-wasm.ts:97-144): pack Python ints into (n, N) planes
of 32-bit words on an explicit device, run the function, unpack, and
compare against the oracle mod p."""

from __future__ import annotations

from ..ops import limbs as codec
from ..ops.field import FieldOps


def run_unop(ops: FieldOps, fn, xs, device, from_mont: bool = False) -> list[int]:
    """Apply an (n, N) -> (n, N) function to packed xs; Python ints mod p."""
    out = fn(ops.pack_raw(xs, device))
    if from_mont:
        out = ops.from_montgomery(out)
    return [v % ops.p for v in codec.unpack(out)]


def run_binop(ops: FieldOps, fn, xs, ys, device) -> list[int]:
    out = fn(ops.pack_raw(xs, device), ops.pack_raw(ys, device))
    return [v % ops.p for v in codec.unpack(out)]


def assert_in_range(ops: FieldOps, arr, hi: int, label: str = "") -> None:
    """Every lane of an (n, N) plane holds a value in [0, hi)."""
    bad = [v for v in codec.unpack(arr) if not 0 <= v < hi]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} values out of [0, {hi}): max={max(bad):x}")
