"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own
shared library, compiled for Hopper (``sm_90a``) on first use into
``build/kernels/`` at the repository root, under a file name keyed on a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. ``build_all`` starts one nvcc per source,
all at the same time. Nothing here runs at import: the CPU tests import
every module of the port on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("short_attention", "flash_attention", "roi_align")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel source in parallel (one nvcc each) and
    load them. Returns each kernel's compiler log (ptxas resource usage);
    empty for a library that was already built."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        logs = {}
        for n, (out, proc) in started.items():
            logs[n] = _finish(n, out, proc)
            lib = ctypes.CDLL(str(out))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[n] = lib
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError right
    after the launch, or a rejected argument)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
