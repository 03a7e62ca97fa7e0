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


@functools.cache
def _launch_fn():
    fn = cuda_lib.load("hist_fold").hist_fold_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def hist_fold(ids, values, n_slots: int):
    """(weights, value sums) f32[n_slots] over flat slot ids.

    ``ids`` int32[n]: ids in [0, n_slots) fold, any other id is dropped;
    ``values`` float32[n]. A CUDA tensor launches the kernel (and counts
    the launch in ``hist_fold.launches``); a CPU tensor takes the plain
    version.
    """
    _check(ids, values, n_slots)
    if ids.device.type == "cpu":
        return hist_fold_reference(ids, values, n_slots)
    if not ids.is_cuda:
        raise ValueError(f"hist_fold: no kernel for device {ids.device}")
    if not (ids.is_contiguous() and values.is_contiguous()):
        raise ValueError("hist_fold: the kernel wants contiguous inputs")
    dev = ids.device
    w = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    mw = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    err = _launch_fn()(
        ids.data_ptr(), values.data_ptr(), ids.numel(), n_slots,
        w.data_ptr(), mw.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_lib.check_launch("hist_fold", err)
    hist_fold.launches += 1
    return w, mw


hist_fold.launches = 0
