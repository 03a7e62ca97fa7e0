"""Dense-domain group-by fold: (count, sum, max, min) per slot.

Counterpart of the JAX package's ``ops/pallas_groupby.py``
(``dense_group_fold``). On a CUDA tensor ``dense_fold`` launches the
hand-written Hopper kernel in ``csrc/dense_fold.cu``; on a CPU tensor it
takes ``dense_fold_reference``, the same function in plain PyTorch. The
numeric contract is the TPU kernel's: f32 throughout, counts exact below
2^24 per slot, non-finite values kept out of the sum and restored into
their own group afterwards, empty slots reporting count 0, sum 0 and
NaN max/min.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

#: Largest slot count the kernel takes (its shared-memory accumulators
#: are 20 B per slot); the same bound as the TPU kernel's VMEM one-hot.
MAX_SLOTS = 2048


def _check(slots, values, g: int) -> None:
    if slots.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(
            f"dense_fold wants int32 slots and float32 values, got "
            f"{slots.dtype} and {values.dtype}"
        )
    if slots.dim() != 1 or values.shape != slots.shape:
        raise ValueError(
            f"dense_fold wants equal 1-D slots/values, got "
            f"{tuple(slots.shape)} and {tuple(values.shape)}"
        )
    if slots.device != values.device:
        raise ValueError("dense_fold: slots and values on different devices")
    if not (0 < g <= MAX_SLOTS):
        raise ValueError(f"dense_fold: g={g} outside (0, {MAX_SLOTS}]")


def _fold_reference(slots, values, g: int, want_min: bool):
    """Raw kernel outputs in plain PyTorch: count, finite-value sum, max
    (-inf when empty), and min (+inf when empty) or the count of -inf
    values. A slot holding a NaN reports NaN max/min. Sums accumulate in
    f64 and round once to f32, so the kernel's f32 sums (added in another
    order) are held against a near-exact reference."""
    keep = (slots >= 0) & (slots < g)
    idx = torch.where(keep, slots, g).long()  # trash slot g
    f32 = dict(dtype=torch.float32, device=slots.device)

    def slot_sum(x):
        acc = torch.zeros(g + 1, dtype=torch.float64, device=slots.device)
        return acc.index_add_(0, idx, x.double())[:g].float()

    def slot_extreme(fill, reduce):
        return torch.full((g + 1,), fill, **f32).scatter_reduce_(
            0, idx, values, reduce, include_self=True
        )[:g]

    cnt = slot_sum(torch.ones_like(values))
    s = slot_sum(torch.where(torch.isfinite(values), values, 0.0))
    has_nan = slot_sum(torch.isnan(values).float()) > 0
    mx = torch.where(has_nan, torch.nan, slot_extreme(-torch.inf, "amax"))
    if want_min:
        aux = torch.where(has_nan, torch.nan, slot_extreme(torch.inf, "amin"))
    else:
        aux = slot_sum((values == -torch.inf).float())
    return cnt, s, mx, aux


@functools.cache
def _launch_fn():
    fn = cuda_lib.load("dense_fold").dense_fold_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _fold_cuda(slots, values, g: int, want_min: bool):
    if not (slots.is_contiguous() and values.is_contiguous()):
        raise ValueError("dense_fold: the kernel wants contiguous inputs")
    fn = _launch_fn()
    dev = slots.device
    ws = torch.empty(5 * g, dtype=torch.int32, device=dev)
    out = torch.empty((4, g), dtype=torch.float32, device=dev)
    err = fn(
        slots.data_ptr(), values.data_ptr(), slots.numel(), g, int(want_min),
        ws.data_ptr(), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_lib.check_launch("dense_fold", err)
    dense_fold.launches += 1
    return out[0], out[1], out[2], out[3]


def _restore(cnt, s, mx, aux, want_min: bool):
    """Restore per-group non-finite sums from the max/aux evidence (the
    fold zeroed them so they could not leak across groups): NaN anywhere
    -> NaN; +inf and -inf together -> NaN; else +/-inf. Empty slots get
    sum 0 and NaN max/min (``pallas_groupby.py:117-133``)."""
    has_nan = torch.isnan(mx)
    if want_min:
        has_nan = has_nan | torch.isnan(aux)
    has_pos = mx == torch.inf
    has_neg = (aux == -torch.inf) if want_min else (aux > 0)
    s = torch.where(
        has_nan | (has_pos & has_neg), torch.nan,
        torch.where(has_pos, torch.inf, torch.where(has_neg, -torch.inf, s)),
    )
    live = cnt > 0
    return (
        cnt,
        torch.where(live, s, 0.0),
        torch.where(live, mx, torch.nan),
        torch.where(live, aux, torch.nan) if want_min else None,
    )


def dense_fold_reference(slots, values, g: int, want_min: bool = False):
    """``dense_fold`` in plain PyTorch, on any device."""
    _check(slots, values, g)
    return _restore(*_fold_reference(slots, values, g, want_min), want_min)


def dense_fold(slots, values, g: int, want_min: bool = False):
    """(count, sum, max, min | None) f32[g] over packed slot ids.

    ``slots`` int32[n]: ids in [0, g) fold, any other id is dropped;
    ``values`` float32[n]. ``want_min=False`` skips the min and returns
    None in its place. A CUDA tensor launches the kernel (and counts the
    launch in ``dense_fold.launches``); a CPU tensor takes the plain
    version.
    """
    _check(slots, values, g)
    if slots.is_cuda:
        raw = _fold_cuda(slots, values, g, want_min)
    elif slots.device.type == "cpu":
        raw = _fold_reference(slots, values, g, want_min)
    else:
        raise ValueError(f"dense_fold: no kernel for device {slots.device}")
    return _restore(*raw, want_min)


dense_fold.launches = 0
