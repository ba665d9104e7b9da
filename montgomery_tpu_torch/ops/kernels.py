"""Hand-written Hopper kernels: build, load, launch and count.

Counterpart of `montgomery_tpu/ops/kernels.py` (`fused`, `pallas_map`,
`_build_call`), which ran each limb-plane formula as one Pallas kernel on the
TPU. Here every kernel is CUDA C++ under `montgomery_tpu_torch/csrc/`, built
by `nvcc` for sm_90a into a shared library with a plain C interface, keyed by
a hash of the sources, and called through `ctypes`. Each `.cu` file compiles
in its own `nvcc` process per limb count it instantiates, as many at a time
as there are CPUs, and one link joins them.

Dispatch rule, shared by every wrapper: tensors on the CPU go to the kernel's
plain PyTorch version (which lives beside the wrapper); tensors on a CUDA
device go to the kernel, or the call raises. Nothing falls back.

The device code is templated over the limb count of a field element
(`csrc/field.cuh`), and each kernel's source instantiates the counts its
callers need: every Weierstrass kernel 12 limbs of 32 bits (BLS12-377's base
field), 13 (BLS12-381's) and 9 (Pallas's), the Twisted Edwards kernels 9
(ed-on-bls12-377's), and the field kernels (and the baselines `divstep_inv`,
`barrett_mul`) also 1, 2 and 3, the example fields small, babybear and
goldilocks. A `Kernel` maps each limb count it was built for to its C symbol,
and a launch at any other count raises `NotImplementedError` before it
reaches the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .limbs import to_words

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmsm_kernels.so"
# sources whose kernels take ptxas longest (one thread carrying nine or more
# products: the RCB doubling, the Edwards add and doubling; the ladder): their
# processes start first
SLOW_SOURCES = ("proj_dbl_rcb.cu", "ed_add.cu", "exp_ladder.cu")


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
            self._compile(out_dir, [s for s in srcs if s.suffix == ".cu"], lib_path)
        self.build_seconds = time.perf_counter() - t0
        log = out_dir / "build.log"
        self.build_log = log.read_text() if log.exists() else ""
        self.path = lib_path
        return ctypes.CDLL(str(lib_path))

    @staticmethod
    def _compile(out_dir: Path, cus: list[Path], lib_path: Path) -> None:
        """One nvcc process per source and limb count, then one link. A
        source whose entry points sit under MSM_AT(n) (csrc/field.cuh)
        compiles once per such n, with -DMSM_LIMBS=n, so no process builds
        more than one count's kernels. At most one process a CPU runs at a
        time, those of SLOW_SOURCES first, so that the longest ones do not
        share their CPUs with the rest. The log gives each process's end
        and run time."""
        nvcc, tag = _nvcc(), os.getpid()
        jobs = []
        for cu in cus:
            text = cu.read_text()
            for n in [n for n in BUILT_LIMBS if f"MSM_AT({n})" in text] or [None]:
                label = cu.name if n is None else f"{cu.name} n={n}"
                obj = out_dir / f"{cu.stem}{'' if n is None else f'.n{n}'}.{tag}.o"
                defs = [] if n is None else [f"-DMSM_LIMBS={n}"]
                cmd = [nvcc, *NVCC_FLAGS, *defs, "-c", "-I", str(CSRC), "-o", str(obj), str(cu)]
                slow = SLOW_SOURCES.index(cu.name) if cu.name in SLOW_SOURCES else len(SLOW_SOURCES)
                jobs.append({"label": label, "obj": obj, "cmd": cmd, "order": (slow, -(n or 0))})
        queue = sorted(jobs, key=lambda job: job["order"])
        lock, t0 = threading.Lock(), time.perf_counter()

        def worker():  # runs every process it takes, failed or not
            while True:
                with lock:
                    if not queue:
                        return
                    job = queue.pop(0)
                start = time.perf_counter()
                res = subprocess.run(job["cmd"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                job["out"], job["rc"] = res.stdout, res.returncode
                job["end"], job["ran"] = time.perf_counter() - t0, time.perf_counter() - start

        workers = [threading.Thread(target=worker) for _ in range(min(len(jobs), os.cpu_count() or 1))]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        logs = [f"== {job['label']} (ended {job['end']:.1f} s, ran {job['ran']:.1f} s)\n{job['out']}"
                for job in jobs]
        failed = [f"{job['label']} ({job['rc']}):\n{job['out'][-4000:]}" for job in jobs if job["rc"] != 0]
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        if not failed:
            res = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", str(tmp), *[str(job["obj"]) for job in jobs]],
                capture_output=True, text=True)
            logs.append(f"== link\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
        (out_dir / "build.log").write_text("\n".join(logs))
        for job in jobs:
            job["obj"].unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, lib_path)


LIBRARY = _Library()

# the limb counts of the Weierstrass curves' base fields, at which every
# Weierstrass kernel is instantiated: BLS12-377 (12), BLS12-381 (13), Pallas (9)
WEIERSTRASS_LIMBS = (12, 13, 9)
# the limb counts of the small example fields, at which the field kernels
# (and divstep_inv, barrett_mul) are instantiated too: small (p = 101, 1),
# babybear (2^31 - 1, 2), goldilocks (2^64 - 2^32 + 1, 3)
FIELD_LIMBS = (1, 2, 3)
# every count a source may instantiate under MSM_AT(n): `_compile` builds
# each source once per count it names
BUILT_LIMBS = WEIERSTRASS_LIMBS + FIELD_LIMBS


def symbols(stem: str, *counts: int) -> dict:
    """{n: C symbol} of a kernel's entry points at the limb counts `counts`:
    msm_<stem> at 12 limbs, msm_<stem>_n<n> at any other count."""
    return {n: f"msm_{stem}" if n == 12 else f"msm_{stem}_n{n}" for n in counts}


# every Kernel registers here, so a run can list kernels and reset counts
REGISTRY: dict[str, "Kernel"] = {}


class Kernel:
    """One CUDA kernel's C entry points plus its launch counts.

    `symbols` maps each limb count the kernel was instantiated at to its C
    symbol (None for a kernel without field elements); `argtypes` lists the
    C arguments before the trailing stream argument, the same at every
    count; every entry point returns `cudaGetLastError()` of its launch.
    `launches` counts every launch, `launches_by_n` splits them by limb
    count."""

    def __init__(self, name: str, symbols: dict, source: str, replaces: str,
                 argtypes: list):
        self.name, self.symbols = name, dict(symbols)
        self.source, self.replaces = source, replaces
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by_n: dict = {}
        self._fns: dict = {}
        REGISTRY[name] = self

    def launch(self, *args, n: int | None = None, device: torch.device) -> None:
        """Launch the entry point for n limbs on `device`, the CUDA device
        that holds the launch's tensors, and on that device's current
        stream (not the current device's: a tensor on another card must not
        reach a kernel on this one)."""
        check_limbs(self, n)
        fn = self._fns.get(n)
        if fn is None:
            fn = getattr(LIBRARY.get(), self.symbols[n])
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fns[n] = fn
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel {self.name}: launch failed, CUDA error {rc}")
        self.launches += 1
        self.launches_by_n[n] = self.launches_by_n.get(n, 0) + 1


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0
        k.launches_by_n = {}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in REGISTRY.items()}


def launch_counts_by_n() -> dict[str, dict]:
    """Each kernel's launches split by limb count (kernels that launched)."""
    return {name: dict(k.launches_by_n) for name, k in REGISTRY.items() if k.launches}


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


def lane_view(t: torch.Tensor, rows: int, N: int) -> tuple[torch.Tensor, int]:
    """An int32 (rows, N) plane whose lanes are contiguous, as (view, row
    stride in elements). Column slices of a wider plane pass without a copy;
    anything else (a broadcast, a transposed view) is copied."""
    if t.dtype != torch.int32 or t.dim() != 2 or tuple(t.shape) != (rows, N):
        raise ValueError(f"expected int32 ({rows}, {N}), got {t.dtype} {tuple(t.shape)}")
    if N > 1 and t.stride(1) != 1 or rows > 1 and t.stride(0) < N:
        t = t.contiguous()
    stride = t.stride(0) if rows > 1 else N
    if N >= 1 << 31 or stride >= 1 << 31:
        raise ValueError("lane count exceeds the kernels' int range")
    return t, stride


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def words(values) -> ctypes.Array:
    """Host array of uint32 words (constants passed by value to a kernel)."""
    return (ctypes.c_uint32 * len(values))(*values)


def check_limbs(kernel: Kernel, n: int | None) -> None:
    """Raise unless `kernel` was instantiated for field elements of n limbs."""
    if n not in kernel.symbols:
        have = sorted(k for k in kernel.symbols if k is not None)
        raise NotImplementedError(
            f"kernel {kernel.name} is compiled for {have} limbs of 32 bits; this field needs "
            f"{n} (on the CPU, pass device='cpu' to run the plain versions, which take any "
            f"limb count)")


@functools.lru_cache(maxsize=None)
def _field_words(p: int, n: int, mu: int) -> ctypes.Array:
    return words(to_words(p, n) + to_words(2 * p, n) + to_words(4 * p, n) + [mu])


def field_params(kernel: Kernel, p: int, n: int, mu: int) -> ctypes.Array:
    """FieldParams<n> of csrc/field.cuh (p, 2p, 4p, mu), which every field
    kernel's launch takes; raises unless `kernel` was instantiated at n
    limbs, so no launch hands planes of another width to a kernel."""
    check_limbs(kernel, n)
    return _field_words(p, n, mu)


U32P = ctypes.POINTER(ctypes.c_uint32)
VP, INT = ctypes.c_void_p, ctypes.c_int
