"""Native (C++) host components of the port, built at first use with g++.

The port's own copies of the JAX package's ring and join sources:

- ``table_ring.cc``: the host slab ring behind every ``Table``
  (``table_store/table.py`` ``_NativeBackend``): append, compaction,
  ``drop_before`` (the cold tier's demotion handoff), the time index,
  copy-out reads and the stats buffer;
- ``hash_join.cc``: the build + probe hash join of a CPU engine's N:M
  joins (``exec/joins.py`` ``host_hash``);
- ``pxclient.cc``: the native netbus client, a program of its own
  (``build_executable("pxclient")`` builds
  ``pixie_tpu_torch/_build/pxclient``).

``load(name)`` compiles ``<name>.cc`` with ``g++`` into
``pixie_tpu_torch/_build/lib<name>.so`` when the library is missing or
older than its source, and loads it with ctypes; ``build`` compiles
several at once. Each library is a ``native_library`` record of the
program registry (``exec/programs.py``) with its build's wall time (0
when the ``.so`` was already built). A build that fails raises
``NativeBuildError`` with the compiler's stderr; nothing falls back to a
Python form on its own. The
JAX package's multi-core CPU fold (``seg_fold``, with its t-digest
histogram) serves XLA's CPU backend and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
LIBRARIES = ("table_ring", "hash_join")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = library_path(name)
    src = SRC_DIR / f"{name}.cc"
    return not out.exists() or out.stat().st_mtime < src.stat().st_mtime


def build(names=LIBRARIES) -> dict:
    """Compile ``names`` with g++, one process each, all started
    together. Returns {name: seconds}; raises ``NativeBuildError`` with
    the compiler's stderr if any build fails. Each compiler writes
    beside its target and the result is renamed into place, so a process
    loading the library never sees a half-written file (test workers
    build at once)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            f"g++ not found on PATH; cannot build {', '.join(names)}"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.{threading.get_ident()}.tmp.so"
        src = SRC_DIR / f"{name}.cc"
        procs[name] = (
            subprocess.Popen([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True),
            tmp, src, time.perf_counter(),
        )
    out, failed = {}, []
    for name, (proc, tmp, src, t0) in procs.items():
        _stdout, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"g++ failed to build {src} (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, library_path(name))
        out[name] = time.perf_counter() - t0
        _registry().record_build("native_library", name, out[name])
    if failed:
        raise NativeBuildError("\n".join(failed))
    return out


#: g++ flags of a program (not a library) built by ``build_executable``.
EXE_FLAGS = ("-O3", "-std=c++17", "-pthread")


def build_executable(name: str) -> str:
    """The path of the program built from ``<name>.cc`` into
    ``pixie_tpu_torch/_build/``, compiled first with ``g++`` when it is
    missing or older than its source. Raises ``NativeBuildError`` when
    ``g++`` is missing or the compile fails: no caller skips or degrades
    on its own."""
    out = BUILD_DIR / name
    src = SRC_DIR / f"{name}.cc"
    with _LOCK:
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            return str(out)
        cxx = shutil.which("g++")
        if cxx is None:
            raise NativeBuildError(f"g++ not found on PATH; cannot build {src}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([cxx, *EXE_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, out)
        return str(out)


def load(name: str) -> ctypes.CDLL:
    """The native library ``name``, built first if missing or stale.
    Raises ``NativeBuildError`` when the build fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            else:
                _registry().record_build("native_library", name, 0.0)
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def _registry():
    from ..exec.programs import default_program_registry

    return default_program_registry()


def np_view(a) -> np.ndarray:
    """A numpy view of a host array or CPU tensor, sharing its memory
    (callers only read through it). A device tensor raises: its planes
    must be copied to the host by the caller, never here."""
    if isinstance(a, np.ndarray):
        return a
    import torch

    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"np_view of a {a.device} tensor")
        if a.dtype == torch.uint64:
            return a.detach().view(torch.int64).numpy().view(np.uint64)
        return a.detach().numpy()
    return np.asarray(a)


def hash_join_call(build_keys, probe_keys, left_outer: bool):
    """(l_idx, r_idx) i32 arrays for an N:M equijoin over packed i64
    keys: every (probe row, build row) pair with equal keys, in probe
    row order and, within a probe row, in build row order. ``r_idx`` is
    -1 for an unmatched probe kept by ``left_outer``. None when a side
    has more rows than an i32 row index can hold."""
    bk = np.ascontiguousarray(build_keys, dtype=np.int64)
    pk = np.ascontiguousarray(probe_keys, dtype=np.int64)
    if len(bk) > (1 << 31) - 2 or len(pk) > (1 << 31) - 2:
        return None
    lib = load("hash_join")
    lib.hash_join.restype = ctypes.c_longlong
    args = [
        bk.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.c_longlong(len(bk)),
        pk.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.c_longlong(len(pk)),
        ctypes.c_int(1 if left_outer else 0),
    ]
    # Speculative capacity: 1:1 and N:1 joins fit in len(pk) pairs and
    # finish in one build + probe; only a fan-out pays a second call at
    # the exact size.
    cap = max(len(pk), 1)
    l_idx = np.empty(cap, dtype=np.int32)
    r_idx = np.empty(cap, dtype=np.int32)
    total = lib.hash_join(
        *args,
        l_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(cap),
    )
    if total > cap:
        l_idx = np.empty(total, dtype=np.int32)
        r_idx = np.empty(total, dtype=np.int32)
        lib.hash_join(
            *args,
            l_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            r_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_longlong(total),
        )
    return l_idx[:total], r_idx[:total]
