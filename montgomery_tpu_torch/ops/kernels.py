"""Hand-written Hopper kernels: build, load, launch and count.

Counterpart of `montgomery_tpu/ops/kernels.py` (`fused`, `pallas_map`,
`_build_call`), which ran each limb-plane formula as one Pallas kernel on the
TPU. Here every kernel is CUDA C++ under `montgomery_tpu_torch/csrc/`, built
by `nvcc` for sm_90a into a shared library with a plain C interface, keyed by
a hash of the sources, and called through `ctypes`.

Dispatch rule, shared by every wrapper: tensors on the CPU go to the kernel's
plain PyTorch version (which lives beside the wrapper); tensors on a CUDA
device go to the kernel, or the call raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmsm_kernels.so"


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class _Library:
    """The kernels' shared library, built at first use and loaded once."""

    def __init__(self):
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self.build_seconds: float | None = None
        self.build_log = ""
        self.path: Path | None = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        lib_path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   *[str(s) for s in srcs if s.suffix == ".cu"]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
            os.replace(tmp, lib_path)
        self.build_seconds = time.perf_counter() - t0
        log = out_dir / "build.log"
        self.build_log = log.read_text() if log.exists() else ""
        self.path = lib_path
        return ctypes.CDLL(str(lib_path))


LIBRARY = _Library()

# every Kernel registers here, so a run can list kernels and reset counts
REGISTRY: dict[str, "Kernel"] = {}


class Kernel:
    """One CUDA kernel's C entry point plus its launch count.

    `argtypes` lists the C arguments before the trailing stream argument;
    every entry point returns `cudaGetLastError()` of its launch."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str,
                 argtypes: list):
        self.name, self.symbol = name, symbol
        self.source, self.replaces = source, replaces
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        REGISTRY[name] = self

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(LIBRARY.get(), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"kernel {self.name}: launch failed, CUDA error {rc}")
        self.launches += 1


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in REGISTRY.items()}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """False if every tensor is on the CPU (plain version), True if all are
    on one CUDA device (kernel); anything else raises."""
    devs = {t.device for t in tensors}
    types = {d.type for d in devs}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len(devs) == 1:
        return True
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {devs}")


def check_planes(rows: int, *tensors: torch.Tensor) -> int:
    """Validate contiguous int32 (rows, N) planes sharing N; returns N."""
    N = tensors[0].shape[-1]
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != (rows, N):
            raise ValueError(f"expected int32 ({rows}, {N}), got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel planes must be contiguous")
    if N >= 1 << 31:
        raise ValueError("lane count exceeds the kernels' int range")
    return N


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def words(values) -> ctypes.Array:
    """Host array of uint32 words (constants passed by value to a kernel)."""
    return (ctypes.c_uint32 * len(values))(*values)


U32P = ctypes.POINTER(ctypes.c_uint32)
VP, INT = ctypes.c_void_p, ctypes.c_int
