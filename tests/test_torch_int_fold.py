"""The exact INT64 fold (``ops/int_fold.py``, ``csrc/int_fold.cu``).

On the CPU: ``int_fold_reference`` against the UDAs' own scatter chain
(``_seg_count``, ``_seg_sum``, ``_seg_extreme`` of
``udf/builtins/math_ops.py``) and against numpy, bit for bit, at the
edges of int64 (sums that wrap), with negative ids, ids at and past g,
empty slots, all-trash windows and ragged lengths; the wrapper's checks;
and that a CPU tensor makes no launch. On the card (marker ``cuda``):
the kernel against ``int_fold_reference`` at the main path's shape, at
g = 2048, on misaligned views and back to back, and px/http_stats on an
engine on the card folding every window through one launch and no
library scatter. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pixie_tpu_torch.ops import int_fold as int_fold_mod
from pixie_tpu_torch.ops.int_fold import MAX_SLOTS, int_fold, int_fold_reference
from pixie_tpu_torch.udf.builtins.math_ops import (
    _seg_count,
    _seg_extreme,
    _seg_sum,
)

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max


def _values(kind: str, n: int, rng) -> np.ndarray:
    if kind == "latency":  # px/http_stats' latency_ns
        return rng.integers(1_000, 100_000_000, n)
    if kind == "negative":
        return rng.integers(-(1 << 40), 1 << 40, n)
    if kind == "time":  # TIME64NS planes: nanoseconds since the epoch
        return 1_700_000_000_000_000_000 + rng.integers(0, 1 << 40, n)
    if kind == "edges":  # sums that wrap both ways, the extremes themselves
        v = rng.choice(np.array([I64_MAX, I64_MIN, I64_MAX - 1, I64_MIN + 1,
                                 -1, 0, 1]), n)
        return v.astype(np.int64)
    raise AssertionError(kind)


def _slots(kind: str, n: int, g: int, rng) -> np.ndarray:
    if kind == "dense":  # every slot, a share of trash rows at g
        s = rng.integers(0, g, n)
        s[rng.random(n) < 0.3] = g
    elif kind == "few_live":  # 15 live slots of g, as the main path
        live = rng.choice(g, size=min(g, 15), replace=False)
        s = live[rng.integers(0, len(live), n)]
        s[rng.random(n) < 0.3] = g
    elif kind == "out_of_range":  # negative ids and ids past g dropped
        s = rng.integers(-3, g + 3, n)
    elif kind == "all_trash":
        s = np.full(n, g)
    else:
        raise AssertionError(kind)
    return s.astype(np.int32)


def _uda_chain(slots, values, g: int, want_min: bool):
    """The port's UDA updates for count, sum, max and min over one window,
    as the fragment ran them before int_fold: masked rows (ids outside
    [0, g)) go to the trash slot."""
    keep = (slots >= 0) & (slots < g)
    gids = torch.where(keep, slots, g)
    zeros = torch.zeros(g, dtype=torch.int64)
    cnt = _seg_count(zeros, gids, keep)
    s = _seg_sum(zeros, gids, keep, values)
    mx = _seg_extreme(torch.full((g,), I64_MIN), gids, keep, values, I64_MIN,
                      "amax")
    mn = (_seg_extreme(torch.full((g,), I64_MAX), gids, keep, values, I64_MAX,
                       "amin") if want_min else None)
    return cnt, s, mx, mn


def _numpy_fold(slots, values, g: int):
    keep = (slots >= 0) & (slots < g)
    s, v = slots[keep].astype(np.int64), values[keep]
    cnt = np.bincount(s, minlength=g).astype(np.int64)
    total = np.zeros(g, np.int64)
    mx = np.full(g, I64_MIN, np.int64)
    mn = np.full(g, I64_MAX, np.int64)
    with np.errstate(over="ignore"):
        np.add.at(total, s, v)  # wraps in two's complement
    np.maximum.at(mx, s, v)
    np.minimum.at(mn, s, v)
    return cnt, total, mx, mn


CASES = {
    # name: (n, g, slots kind, values kind)
    "n0": (0, 15, "dense", "latency"),
    "n1": (1, 15, "dense", "latency"),
    "g1": (1000, 1, "dense", "negative"),
    "main_path": ((1 << 21) + 3, 160, "few_live", "latency"),
    "g15": (5000, 15, "dense", "negative"),
    "g160": (5000, 160, "dense", "time"),
    "cap": (20_000, MAX_SLOTS, "dense", "negative"),
    "wrap": (4096, 15, "dense", "edges"),
    "wrap_one_slot": (4096, 1, "dense", "edges"),
    "out_of_range": (5000, 15, "out_of_range", "negative"),
    "all_trash": (3000, 15, "all_trash", "latency"),
    "empty_slots": (40, 160, "dense", "time"),
}


def _case(name: str, seed: int = 0):
    n, g, skind, vkind = CASES[name]
    rng = np.random.default_rng([seed, sorted(CASES).index(name)])
    return _slots(skind, n, g, rng), _values(vkind, n, rng), g


def _assert_same(got, want, what: str):
    for k, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, f"{what}: output {k} should be None"
            continue
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        assert a.dtype == np.int64, f"{what}: output {k} is {a.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: output {k}")


@pytest.mark.parametrize("want_min", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_uda_chain(case, want_min):
    """``int_fold_reference`` is the UDAs' scatter chain, bit for bit,
    and numpy's fold (``np.add.at`` wraps like ``index_add_``)."""
    slots, values, g = _case(case)
    ts, tv = torch.from_numpy(slots), torch.from_numpy(values)
    got = int_fold_reference(ts, tv, g, want_min)
    _assert_same(got, _uda_chain(ts, tv, g, want_min), f"{case} vs UDAs")
    cnt, total, mx, mn = _numpy_fold(slots, values, g)
    _assert_same(got, (cnt, total, mx, mn if want_min else None),
                 f"{case} vs numpy")
    if case == "all_trash":
        assert not got[0].any() and not got[1].any()
    if case == "empty_slots":  # empty slots report the neutral values
        empty = (got[0] == 0).numpy()
        assert empty.any()
        assert (got[2].numpy()[empty] == I64_MIN).all()


def test_reference_sum_wraps():
    """Two INT64_MAX rows in one slot sum to -2, as index_add_ wraps."""
    slots = torch.zeros(2, dtype=torch.int32)
    values = torch.full((2,), I64_MAX, dtype=torch.int64)
    cnt, s, mx, mn = int_fold_reference(slots, values, 1, want_min=True)
    assert cnt.tolist() == [2] and s.tolist() == [-2]
    assert mx.tolist() == [I64_MAX] and mn.tolist() == [I64_MAX]


def test_cpu_tensor_takes_plain_version_without_launch():
    slots, values, g = _case("g15")
    ts, tv = torch.from_numpy(slots), torch.from_numpy(values)
    before = int_fold.launches
    got = int_fold(ts, tv, g, want_min=True)
    assert int_fold.launches == before
    _assert_same(got, int_fold_reference(ts, tv, g, True), "cpu wrapper")


@pytest.mark.parametrize("slots_dtype,values_dtype", [
    (torch.int64, torch.int64), (torch.int32, torch.int32),
    (torch.int32, torch.float32),
])
def test_wrapper_checks_dtypes(slots_dtype, values_dtype):
    with pytest.raises(TypeError, match="int_fold wants int32"):
        int_fold(torch.zeros(8, dtype=slots_dtype),
                 torch.zeros(8, dtype=values_dtype), 15)


@pytest.mark.parametrize("slots_shape,values_shape", [
    ((8,), (9,)), ((8, 2), (8, 2)),
], ids=["lengths_differ", "two_dims"])
def test_wrapper_checks_shapes(slots_shape, values_shape):
    with pytest.raises(ValueError, match="1-D"):
        int_fold(torch.zeros(slots_shape, dtype=torch.int32),
                 torch.zeros(values_shape, dtype=torch.int64), 15)


@pytest.mark.parametrize("which", ["slots", "values"])
def test_wrapper_refuses_non_contiguous(which):
    slots = torch.zeros(16, dtype=torch.int32)
    values = torch.zeros(16, dtype=torch.int64)
    if which == "slots":
        slots = slots[::2]
        values = values[:8]
    else:
        values = values[::2]
        slots = slots[:8]
    with pytest.raises(ValueError, match="contiguous"):
        int_fold(slots, values, 15)
    with pytest.raises(ValueError, match="contiguous"):
        int_fold_reference(slots, values, 15)


@pytest.mark.parametrize("g", [0, -1, MAX_SLOTS + 1])
def test_wrapper_checks_slot_count(g):
    with pytest.raises(ValueError, match="outside"):
        int_fold(torch.zeros(4, dtype=torch.int32),
                 torch.zeros(4, dtype=torch.int64), g)


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a card gets no silent fallback."""
    slots = torch.zeros(8, dtype=torch.int32, device="meta")
    values = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        int_fold(slots, values, 15)


# -- on the card -----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: int_fold is a CUDA "
                    "kernel with no interpret mode")
    return torch.device("cuda", torch.cuda.current_device())


def _on_card_matches(slots, values, g, want_min, what):
    got = int_fold(slots, values, g, want_min)
    torch.cuda.synchronize()
    want = int_fold_reference(slots.cpu().contiguous(),
                              values.cpu().contiguous(), g, want_min)
    _assert_same(got, want, what)


@pytest.mark.cuda
@pytest.mark.parametrize("want_min", [False, True])
@pytest.mark.parametrize("case", ["main_path", "cap", "wrap", "out_of_range",
                                  "all_trash", "n0", "n1", "g1", "g160"])
def test_kernel_matches_reference(case, want_min):
    dev = _card()
    slots, values, g = _case(case, seed=1)
    before = int_fold.launches
    _on_card_matches(torch.from_numpy(slots).to(dev),
                     torch.from_numpy(values).to(dev), g, want_min, case)
    assert int_fold.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["ragged", "misaligned", "offsets_differ",
                                  "values_off_by_one"])
def test_kernel_on_views(view):
    """Views whose bases lie off a 16-byte boundary and a ragged n: the
    scalar head and tail of the row walk. ``[1:]`` of both leaves 3 rows
    before the slots' boundary, where the values' lies too (rows of 4 and
    8 bytes); ``[1:]`` beside ``[2:]``, and the values alone one row in,
    never meet one, so every row goes alone."""
    dev = _card()
    slots, values, g = _case("main_path", seed=2)
    s = torch.from_numpy(slots).to(dev)
    v = torch.from_numpy(values).to(dev)
    n = s.numel() - 8
    ss, vv = {
        "ragged": (s[:n + 3], v[:n + 3]),
        "misaligned": (s[1:n + 1], v[1:n + 1]),
        "offsets_differ": (s[1:n + 1], v[2:n + 2]),
        "values_off_by_one": (s[:n], v[1:n + 1]),
    }[view]
    for want_min in (False, True):
        _on_card_matches(ss, vv, g, want_min, f"{view},want_min={want_min}")


@pytest.mark.cuda
def test_kernel_back_to_back_reuses_workspace():
    """Calls on one stream with no synchronisation between them, at other
    slot counts and with and without the min: each finds the workspace
    and ticket at rest."""
    dev = _card()
    calls = []
    for k, case in enumerate(["main_path", "cap", "g1", "wrap", "g160"]):
        slots, values, g = _case(case, seed=3 + k)
        calls.append((torch.from_numpy(slots).to(dev),
                      torch.from_numpy(values).to(dev), g, k % 2 == 1))
    outs = [int_fold(s, v, g, m) for s, v, g, m in calls]
    torch.cuda.synchronize()
    for k, (out, (s, v, g, m)) in enumerate(zip(outs, calls)):
        _assert_same(out, int_fold_reference(s.cpu(), v.cpu(), g, m),
                     f"back_to_back[{k}]")


@pytest.mark.cuda
@pytest.mark.parametrize("g,want_min,copies", [
    (1, False, 16), (160, True, 16), (219, True, 16), (220, True, 1),
    (307, False, 16), (308, False, 1), (MAX_SLOTS, True, 1),
])
def test_copies_follow_slot_count(g, want_min, copies):
    """One copy of the accumulators per warp while 16 of them fit 96 KB,
    else one per block; the choice lives in csrc/int_fold.cu."""
    _card()
    assert int_fold_mod.copies(g, want_min) == copies


@pytest.mark.cuda
def test_http_stats_folds_each_window_in_one_launch():
    """px/http_stats on an engine on the card: one int_fold launch per
    window, no index_add_ or scatter_reduce_ anywhere in the query, and
    the answer equal to numpy's."""
    from torch.profiler import ProfilerActivity, profile

    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.scripts import load_script
    from pixie_tpu_torch.types import host_batch_from_numpy

    dev = _card()
    window, windows = 1 << 16, 4
    n = window * windows
    rng = np.random.default_rng(11)
    svc = rng.integers(0, 9, n).astype(np.int32)
    path = rng.integers(0, 15, n).astype(np.int32)
    lat = rng.integers(1_000, 100_000_000, n)
    status = np.array([200, 200, 200, 200, 404, 500])[rng.integers(0, 6, n)]
    eng = Engine(window_rows=window, device=dev)
    rel = [("time_", "TIME64NS"), ("latency_ns", "INT64"),
           ("resp_status", "INT64"), ("service", "STRING"),
           ("req_path", "STRING")]
    dicts = {"service": [f"svc-{i}" for i in range(9)],
             "req_path": [f"/ep{i}" for i in range(15)]}
    for off in range(0, n, window):
        s = slice(off, off + window)
        eng.append_data("http_events", host_batch_from_numpy(rel, {
            "time_": (np.arange(off, off + window, dtype=np.int64),),
            "latency_ns": (lat[s],), "resp_status": (status[s],),
            "service": (svc[s],), "req_path": (path[s],),
        }, dicts))
    query = load_script("px/http_stats").pxl
    eng.execute_query(query)  # warm: kernel build and first compile
    before = int_fold.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = eng.execute_query(query)["output"]
    torch.cuda.synchronize()
    assert int_fold.launches - before == windows
    assert eng.last_stats.fragments[0].uses_int_fold
    ops = {e.key for e in prof.key_averages()}
    assert not {o for o in ops if "index_add" in o or "scatter_reduce" in o}
    got = out.to_pydict(decode_strings=False)
    ok = status < 400
    key = svc[ok].astype(np.int64) * 15 + path[ok]
    want_n = np.bincount(key, minlength=9 * 15)
    want_max = np.full(9 * 15, I64_MIN)
    np.maximum.at(want_max, key, lat[ok])
    got_key = np.asarray(got["service"]).astype(np.int64) * 15 + np.asarray(
        got["req_path"])
    np.testing.assert_array_equal(np.asarray(got["n"]), want_n[got_key])
    np.testing.assert_array_equal(np.asarray(got["lat_max"]),
                                  want_max[got_key])
    assert int(np.asarray(got["n"]).sum()) == int(ok.sum())
