"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` source has a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds) and becomes one shared library for ``sm_90a``. A
library's file name carries a hash of its source, the shared header and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. The first use of any kernel compiles every missing library at
once, one ``nvcc`` process per source, all started together. A failed
build raises; nothing falls back.
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

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/, which .gitignore lists
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# ptxas's report (registers, shared memory, spills) per source, from the
# builds this process ran
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "compiled from csrc/ at first use"
    )


def _target(src: Path) -> Path:
    digest = hashlib.sha256()
    for part in sorted(CSRC.glob("*.cuh")) + [src]:
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is missing, all in parallel.
    Returns the seconds spent (0.0 when everything was built already)."""
    pending = [
        (src, _target(src))
        for src in sorted(CSRC.glob("*.cu"))
        if not _target(src).exists()
    ]
    if not pending:
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src, out in pending:
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def function(stem: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry ``name`` of library ``csrc/<stem>.cu``, building it first if
    needed. Every entry returns the launch's ``cudaGetLastError()``."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(CSRC / f"{stem}.cu")))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[stem] = lib
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(stem: str, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        text = _LIBS[stem].repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {text}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, where every kernel launches."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
