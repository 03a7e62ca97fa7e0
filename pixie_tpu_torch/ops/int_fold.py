"""Exact INT64 dense-domain group-by fold: (count, sum, max, min) per slot.

The JAX package has no kernel for it: its INT64 aggregates fold with
XLA (``udf/builtins/math_ops.py``). On a CUDA tensor ``int_fold`` launches
the hand-written Hopper kernel in ``csrc/int_fold.cu``; on a CPU tensor
it takes ``int_fold_reference``, the same function in plain PyTorch, the
``index_add_``/``scatter_reduce_`` arithmetic of the UDAs. Results are
exact int64: the sum wraps in two's complement as ``index_add_`` does,
and an empty slot reports count 0, sum 0, max INT64_MIN and min
INT64_MAX, the neutral values of the ``max`` and ``min`` UDAs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

#: Largest slot count the kernel takes (its workspace holds 2048 slots;
#: the same bound as ``dense_fold``'s).
MAX_SLOTS = 2048

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


def _check(slots, values, g: int) -> None:
    if slots.dtype != torch.int32 or values.dtype != torch.int64:
        raise TypeError(
            f"int_fold wants int32 slots and int64 values, got "
            f"{slots.dtype} and {values.dtype}"
        )
    if slots.dim() != 1 or values.shape != slots.shape:
        raise ValueError(
            f"int_fold wants equal 1-D slots/values, got "
            f"{tuple(slots.shape)} and {tuple(values.shape)}"
        )
    if slots.device != values.device:
        raise ValueError("int_fold: slots and values on different devices")
    if not (slots.is_contiguous() and values.is_contiguous()):
        raise ValueError("int_fold wants contiguous slots and values")
    if not (0 < g <= MAX_SLOTS):
        raise ValueError(f"int_fold: g={g} outside (0, {MAX_SLOTS}]")


def int_fold_reference(slots, values, g: int, want_min: bool = False):
    """``int_fold`` in plain PyTorch, on any device: ids outside [0, g)
    go to a trash slot g, then one ``index_add_`` each for the count and
    the sum and one ``scatter_reduce_`` each for the max and the min."""
    _check(slots, values, g)
    keep = (slots >= 0) & (slots < g)
    idx = torch.where(keep, slots, g).long()
    i64 = dict(dtype=torch.int64, device=slots.device)
    cnt = torch.zeros(g + 1, **i64).index_add_(0, idx, torch.ones_like(values))
    s = torch.zeros(g + 1, **i64).index_add_(0, idx, values)

    def extreme(fill, reduce):
        return torch.full((g + 1,), fill, **i64).scatter_reduce_(
            0, idx, values, reduce, include_self=True
        )[:g]

    mn = extreme(_I64_MAX, "amin") if want_min else None
    return cnt[:g], s[:g], extreme(_I64_MIN, "amax"), mn


#: The C interface of ``csrc/int_fold.cu`` ({name: (restype, argtypes)}).
#: Launch: slots, values, n, g, want_min, workspace, out, SM count,
#: device, stream; it and setup return the CUDA error code.
C_SIGNATURES = {
    "int_fold_copies": (ctypes.c_int, (ctypes.c_int, ctypes.c_int)),
    "int_fold_setup": (ctypes.c_int, ()),
    "int_fold_launch": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    )),
}


@functools.cache
def _library():
    return cuda_lib.bind("int_fold", C_SIGNATURES)


def copies(g: int, want_min: bool = False) -> int:
    """The copies of the accumulators a block keeps in shared memory at
    ``g`` slots, as ``csrc/int_fold.cu`` chooses them: one per warp (16)
    or one per block (builds the library)."""
    return _library().int_fold_copies(g, int(want_min))


@functools.cache
def _setup(device_index: int) -> None:
    """Lets the kernel take its shared memory on the card, once."""
    with torch.cuda.device(device_index):
        cuda_lib.check_launch("int_fold setup", _library().int_fold_setup())


#: The kernel's workspace: count | sum | max | min, each int64[MAX_SLOTS]
#: at its resting value, then a zero ticket. The kernel's last block
#: leaves it as it found it.
_WS_REST = (0, 0, _I64_MIN, _I64_MAX)
_workspaces: dict = {}


def _workspace(dev, stream: int):
    """The workspace of (device, stream): 64 KB on the card, made once and
    kept for the life of the process. Calls on one stream run in order,
    so each finds it at rest; calls on two streams use two workspaces.
    Threads that race to make one keep the first (``setdefault``); the
    other was never used."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        rest = torch.tensor(_WS_REST, dtype=torch.int64)
        ws = _workspaces.setdefault(key, torch.cat([
            rest.repeat_interleave(MAX_SLOTS),
            torch.zeros(1, dtype=torch.int64),
        ]).to(dev))
    return ws


def _fold_cuda(slots, values, g: int, want_min: bool):
    dev = slots.device
    _setup(dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream)
    out = torch.empty((4 if want_min else 3, g), dtype=torch.int64,
                      device=dev)
    err = _library().int_fold_launch(
        slots.data_ptr(), values.data_ptr(), slots.numel(), g, int(want_min),
        ws.data_ptr(), out.data_ptr(), cuda_lib.sm_count(dev.index),
        dev.index, stream,
    )
    cuda_lib.check_launch("int_fold", err)
    cuda_lib.count_launch(int_fold)
    return out[0], out[1], out[2], (out[3] if want_min else None)


def int_fold(slots, values, g: int, want_min: bool = False):
    """(count, sum, max, min | None) int64[g] over packed slot ids.

    ``slots`` int32[n]: ids in [0, g) fold, any other id is dropped;
    ``values`` int64[n]; both contiguous. ``want_min=False`` skips the
    min and returns None in its place. A CUDA tensor launches the kernel
    (and counts the launch in ``int_fold.launches`` and, by thread, in
    ``int_fold.launches_by_thread``); a CPU tensor takes the plain
    version.
    """
    _check(slots, values, g)
    if slots.is_cuda:
        return _fold_cuda(slots, values, g, want_min)
    if slots.device.type == "cpu":
        return int_fold_reference(slots, values, g, want_min)
    raise ValueError(f"int_fold: no kernel for device {slots.device}")


int_fold.launches = 0
int_fold.launches_by_thread = {}
