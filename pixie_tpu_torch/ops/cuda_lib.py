"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into ``_build/lib<name>.so``, a shared library with a plain C interface
that the op wrappers load with ``ctypes``. A library builds at first use
when it is missing or older than its source or a ``csrc/*.cuh`` header;
``build`` compiles several at once, one ``nvcc`` process each. There is
no fallback: a failed build raises.

Each library is a ``cuda_library`` record of the program registry
(``exec/programs.py``): its build's wall time (0 when the ``.so`` was
already built) and, as hits, its kernel's launches (``count_launch``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("dense_fold", "hist_fold", "int_fold")

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
        _registry().record_build("cuda_library", name, secs)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    sources = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    newest = max(p.stat().st_mtime for p in sources)
    lib = library_path(name)
    if not lib.exists() or lib.stat().st_mtime < newest:
        build((name,))
    else:
        _registry().record_build("cuda_library", name, 0.0)
    return ctypes.CDLL(str(lib))


_REGISTRY = None


def _registry():
    """The process program registry, looked up once (``count_launch``
    reaches it on every launch)."""
    global _REGISTRY
    if _REGISTRY is None:
        from ..exec.programs import default_program_registry

        _REGISTRY = default_program_registry()
    return _REGISTRY


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library ``name`` (``load``), with the return and
    argument types of each function in ``signatures`` ({C name: (ctypes
    restype, argtypes)}) set."""
    lib = load(name)
    for fn_name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


@functools.cache
def sm_count(device_index: int) -> int:
    """The streaming-multiprocessor count of card ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_launch(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``,
    by the launching thread's name in ``wrapper.launches_by_thread`` (an
    agent runs each fragment on a bus thread named for it), and as a hit
    of its library's program record. Locked: agents launch from several
    threads."""
    name = threading.current_thread().name
    with _COUNT_LOCK:
        wrapper.launches += 1
        by_thread = wrapper.launches_by_thread
        by_thread[name] = by_thread.get(name, 0) + 1
    library = getattr(wrapper, "__name__", None)  # the kernel's library
    if library is not None:
        _registry().hit("cuda_library", library, library)
