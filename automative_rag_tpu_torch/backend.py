"""Device choice, the CUDA check, and the kernel build.

Every entry point of the package takes ``device=`` and defaults to
``"cuda"``. ``resolve_device`` raises when the card is asked for and no
card is present, so nothing carries on silently on the CPU; the tests pass
``device="cpu"`` explicitly.

Kernels are CUDA C++ sources under ``csrc/``. Each source is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface and loaded with ``ctypes`` (pointers and the stream travel as
``c_void_p``). The build happens at first use, into ``_build/`` beside this
file (listed in ``.gitignore``); the library name carries a hash of the
source and the flags, so an edited source is never served by a stale
library. All missing libraries are compiled together, one ``nvcc`` process
per source. A failed build raises: there is no fallback to a plain version
for a tensor on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: one shared library per source file
KERNEL_SOURCES = ("maxsim", "sparse_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (pass ``device="cpu"`` to run on the CPU on purpose)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: where the CUDA toolkit's compiler usually lives when it is not on PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), NVCC_FALLBACK):
        if cand and Path(cand).exists():
            return cand
    raise KernelBuildError(
        "nvcc not found (set NVCC or put the CUDA toolkit's bin on PATH)")


_LIBS: Dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": build time or 0.0 when reused, "ptxas": [...]}
BUILD_INFO: Dict[str, dict] = {}
_LOCK = threading.Lock()


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _ptxas_summary(log: str) -> List[str]:
    """Registers, shared memory and spills per kernel from ``-Xptxas -v``."""
    keep = re.compile(r"Compiling entry function|Used \d+ registers|spill")
    return [ln.strip() for ln in log.splitlines() if keep.search(ln)]


def build_kernels(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Compile (where missing) and load the named kernel libraries; returns
    ``BUILD_INFO`` for them. One ``nvcc`` per source, all started at once."""
    names = list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            for name in todo:
                out = _lib_path(name)
                if out.exists():
                    BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": []})
                    continue
                tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), tmp, out, time.perf_counter())
            for name, (proc, tmp, out, t0) in procs.items():
                stdout, stderr = proc.communicate()
                if proc.returncode != 0:
                    raise KernelBuildError(
                        f"nvcc failed for csrc/{name}.cu "
                        f"(rc {proc.returncode}):\n{stdout}\n{stderr}")
                os.replace(tmp, out)
                BUILD_INFO[name] = {
                    "seconds": time.perf_counter() - t0,
                    "ptxas": _ptxas_summary(stdout + "\n" + stderr),
                }
            for name in todo:
                _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return {n: BUILD_INFO.get(n, {}) for n in names}


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    if name not in _LIBS:
        build_kernels([name])
    return _LIBS[name]


def current_stream(device: torch.device) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """Copy a small host array to ``device`` without stalling the host: a
    pageable copy waits for all queued work, a pinned one is queued
    behind it (PyTorch's caching host allocator keeps the pinned block
    alive until the copy has run)."""
    t = torch.as_tensor(array)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def check_launch(lib: ctypes.CDLL, prefix: str, err: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        getter = getattr(lib, f"{prefix}_error_string")
        getter.restype = ctypes.c_char_p
        getter.argtypes = [ctypes.c_int]
        raise KernelLaunchError(
            f"{prefix}: CUDA error {err}: {getter(err).decode()}")
