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


#: The C interface of ``csrc/dense_fold.cu`` ({name: (restype, argtypes)}).
#: Launch: slots, values, n, g, want_min, workspace, out, SM count,
#: device, stream; returns the CUDA error code.
C_SIGNATURES = {
    "dense_fold_launch": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    )),
}


@functools.cache
def _library():
    return cuda_lib.bind("dense_fold", C_SIGNATURES)


#: The kernel's workspace: count | sum | max | min | -inf count | NaN flag,
#: each u32[MAX_SLOTS] at its resting value (max and min hold the ordered
#: bits of -inf and +inf), then a zero ticket. The kernel's last block
#: leaves it as it found it.
_WS_REST = (0, 0, 0x007FFFFF, 0xFF800000 - (1 << 32), 0, 0)  # as int32
_workspaces: dict = {}


def _workspace(dev, stream: int):
    """The workspace of (device, stream): 48 KB on the card, made once at
    the largest g and kept for the life of the process. Calls on one
    stream run in order, so each finds it at rest; calls on two streams
    use two workspaces. Threads that race to make one keep the first
    (``setdefault``); the other was never used."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        rest = torch.tensor(_WS_REST, dtype=torch.int32)
        ws = _workspaces.setdefault(key, torch.cat([
            rest.repeat_interleave(MAX_SLOTS),
            torch.zeros(1, dtype=torch.int32),
        ]).to(dev))
    return ws


def _fold_cuda(slots, values, g: int, want_min: bool):
    if not (slots.is_contiguous() and values.is_contiguous()):
        raise ValueError("dense_fold: the kernel wants contiguous inputs")
    dev = slots.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream)
    out = torch.empty((4 if want_min else 3, g), dtype=torch.float32,
                      device=dev)
    err = _library().dense_fold_launch(
        slots.data_ptr(), values.data_ptr(), slots.numel(), g, int(want_min),
        ws.data_ptr(), out.data_ptr(), cuda_lib.sm_count(dev.index),
        dev.index, stream,
    )
    cuda_lib.check_launch("dense_fold", err)
    cuda_lib.count_launch(dense_fold)
    return out[0], out[1], out[2], (out[3] if want_min else None)


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
    launch in ``dense_fold.launches`` and, by thread, in
    ``dense_fold.launches_by_thread``); a CPU tensor takes the plain
    version. The kernel applies the non-finite restore and the empty-slot
    rules itself, in the same launch.
    """
    _check(slots, values, g)
    if slots.is_cuda:
        return _fold_cuda(slots, values, g, want_min)
    if slots.device.type == "cpu":
        return _restore(*_fold_reference(slots, values, g, want_min), want_min)
    raise ValueError(f"dense_fold: no kernel for device {slots.device}")


dense_fold.launches = 0
dense_fold.launches_by_thread = {}
