"""t-digest histogram fold: per-slot (weight, value sum) over flat ids.

Counterpart of the JAX package's ``ops/pallas_tdigest.py``
(``hist_fold``). On a CUDA tensor ``hist_fold`` launches the hand-written
Hopper kernel in ``csrc/hist_fold.cu``; on a CPU tensor it takes
``hist_fold_reference``, the same function in plain PyTorch. Weights are
f32 row counts (exact below 2^24 per slot); sums are f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib


def _check(ids, values, n_slots: int) -> None:
    if ids.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(
            f"hist_fold wants int32 ids and float32 values, got "
            f"{ids.dtype} and {values.dtype}"
        )
    if ids.dim() != 1 or values.shape != ids.shape:
        raise ValueError(
            f"hist_fold wants equal 1-D ids/values, got "
            f"{tuple(ids.shape)} and {tuple(values.shape)}"
        )
    if ids.device != values.device:
        raise ValueError("hist_fold: ids and values on different devices")
    if not (0 < n_slots < 2**31):
        raise ValueError(f"hist_fold: n_slots={n_slots} out of range")


def hist_fold_reference(ids, values, n_slots: int):
    """``hist_fold`` in plain PyTorch, on any device. Sums accumulate in
    f64 and round once to f32."""
    _check(ids, values, n_slots)
    keep = (ids >= 0) & (ids < n_slots)
    idx = torch.where(keep, ids, n_slots).long()  # trash slot n_slots
    z = torch.zeros(n_slots + 1, dtype=torch.float64, device=ids.device)
    w = z.clone().index_add_(0, idx, torch.ones_like(values, dtype=torch.float64))
    mw = z.index_add_(0, idx, values.double())
    return w[:n_slots].float(), mw[:n_slots].float()


#: The C interface of ``csrc/hist_fold.cu`` ({name: (restype, argtypes)}).
#: The library chooses the route from the slot count, and
#: ``hist_fold_route`` names it. Launch: ids, values, n, n_slots, out, SM
#: count, device, stream; it and setup return the CUDA error code.
C_SIGNATURES = {
    "hist_fold_route": (ctypes.c_char_p, (ctypes.c_int,)),
    "hist_fold_setup": (ctypes.c_int, ()),
    "hist_fold_launch": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    )),
}


@functools.cache
def _library():
    return cuda_lib.bind("hist_fold", C_SIGNATURES)


def route(n_slots: int) -> str:
    """The kernel route that folds ``n_slots`` slots, "ranges" or
    "global", as ``csrc/hist_fold.cu`` chooses it (builds the library)."""
    return _library().hist_fold_route(n_slots).decode()


@functools.cache
def _setup(device_index: int) -> None:
    """Lets the kernel take its shared memory on the card, once."""
    with torch.cuda.device(device_index):
        cuda_lib.check_launch("hist_fold setup", _library().hist_fold_setup())


def hist_fold(ids, values, n_slots: int):
    """(weights, value sums) f32[n_slots] over flat slot ids.

    ``ids`` int32[n]: ids in [0, n_slots) fold, any other id is dropped;
    ``values`` float32[n]. A CUDA tensor launches the kernel of
    ``route(n_slots)`` (and counts the launch in ``hist_fold.launches``
    and, by thread, in ``hist_fold.launches_by_thread``)
    after one memset of the outputs; the two results are the columns of
    one f32[n_slots, 2] tensor. A CPU tensor takes the plain version.
    """
    _check(ids, values, n_slots)
    if ids.device.type == "cpu":
        return hist_fold_reference(ids, values, n_slots)
    if not ids.is_cuda:
        raise ValueError(f"hist_fold: no kernel for device {ids.device}")
    if not (ids.is_contiguous() and values.is_contiguous()):
        raise ValueError("hist_fold: the kernel wants contiguous inputs")
    dev = ids.device
    _setup(dev.index)
    out = torch.empty((n_slots, 2), dtype=torch.float32, device=dev)
    err = _library().hist_fold_launch(
        ids.data_ptr(), values.data_ptr(), ids.numel(), n_slots,
        out.data_ptr(), cuda_lib.sm_count(dev.index), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_lib.check_launch("hist_fold", err)
    cuda_lib.count_launch(hist_fold)
    return out[:, 0], out[:, 1]


hist_fold.launches = 0
hist_fold.launches_by_thread = {}
