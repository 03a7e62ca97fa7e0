"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into ``_build/lib<name>.so``, a shared library with a plain C interface
that the op wrappers load with ``ctypes``. A library builds at first use
when it is missing or older than its source; ``build`` compiles several
at once, one ``nvcc`` process each. There is no fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("dense_fold", "hist_fold")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names=KERNELS) -> dict:
    """Compile ``names`` in parallel. Returns {name: (seconds, ptxas
    report)}; raises ``KernelBuildError`` with the compiler's output if
    any build fails."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        # Build beside the target and rename into place, so a process
        # loading the library never sees a half-written file.
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, time.perf_counter(),
        )
    out, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(name))
        out[name] = (secs, log)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name)
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        build((name,))
    return ctypes.CDLL(str(lib))


def check_launch(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
