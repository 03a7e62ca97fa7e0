"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode. Inputs are made with
numpy from a seed and handed to both.

Tolerances: counts and weights are exact (integers in f32); max and min
are exact with NaN in the same places (order does not matter to an
extremum); f32 sums are compared at rtol 1e-5 (dense fold) and at the
JAX package's own rtol 1e-4 / atol 1e-3 (histogram fold,
tests/test_pallas.py), because the two add the same values in another
order.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pixie_tpu.config import set_flag
from pixie_tpu.ops import tdigest as jax_tdigest
from pixie_tpu.ops.pallas_groupby import dense_group_fold
from pixie_tpu.ops.pallas_tdigest import hist_fold as jax_hist_fold
from pixie_tpu_torch.ops import dense_fold as dense_fold_mod
from pixie_tpu_torch.ops import hist_fold as hist_fold_mod
from pixie_tpu_torch.ops import int_fold as int_fold_mod
from pixie_tpu_torch.ops import tdigest
from pixie_tpu_torch.ops.dense_fold import dense_fold, dense_fold_reference
from pixie_tpu_torch.ops.hist_fold import hist_fold, hist_fold_reference
from pixie_tpu_torch.ops.hist_fold import route as hist_route


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and timing-based tests in other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matches_numpy_inputs():
    rng = np.random.default_rng(0)
    n, g = 8192, 128
    slots = rng.integers(0, g, n).astype(np.int32)
    slots[::7] = g  # masked rows land in the trash id
    vals = rng.random(n).astype(np.float32) * 100
    return slots, vals, g, 1024


def _all_masked_inputs():
    return (np.full(2048, 64, dtype=np.int32), np.ones(2048, dtype=np.float32),
            64, 1024)


def _nonfinite_inputs():
    slots = np.array([0, 0, 1, 1, 2, 2, 3, 3] * 16, dtype=np.int32)
    vals = np.ones(128, dtype=np.float32)
    vals[0] = np.nan
    vals[2] = np.inf
    vals[4] = -np.inf
    return slots, vals, 128, 64


def _neg_inf_inputs():
    slots = np.array([0, 0, 1, 1] * 32, dtype=np.int32)
    vals = np.ones(128, dtype=np.float32)
    vals[0] = -np.inf
    return slots, vals, 128, 64


def _mixed_nonfinite_inputs():
    """NaN, both infinities in one group, negative and out-of-range ids."""
    rng = np.random.default_rng(3)
    n, g = 4096, 256
    slots = rng.integers(-5, g + 40, n).astype(np.int32)
    vals = ((rng.random(n) - 0.5) * 1e4).astype(np.float32)
    vals[slots == 7] = np.nan
    vals[np.flatnonzero(slots == 9)[:2]] = [np.inf, -np.inf]
    vals[np.flatnonzero(slots == 11)[:1]] = np.inf
    return slots, vals, g, 512


def _ragged_inputs():
    """n neither a multiple of the kernel's 4-row loads nor of the Pallas
    chunk (the JAX side gets trash rows up to a chunk multiple)."""
    rng = np.random.default_rng(5)
    n, g = 4099, 256
    slots = rng.integers(0, g + 16, n).astype(np.int32)
    vals = (rng.random(n) * 1e3).astype(np.float32)
    vals[slots == 5] = np.nan
    vals[np.flatnonzero(slots == 6)[:1]] = -np.inf
    return slots, vals, g, 512


def _widest_inputs():
    """g = 2048, the largest slot count the kernel takes. Values of one
    sign, like the main path's latencies: sums that cancel would hold the
    f32 contraction's rounding to a relative tolerance of a near-zero
    sum."""
    rng = np.random.default_rng(6)
    n, g = 8192, 2048
    slots = rng.integers(0, g, n).astype(np.int32)
    slots[::11] = g
    vals = (rng.random(n) * 100).astype(np.float32)
    return slots, vals, g, 1024


DENSE_CASES = {
    "matches_numpy": _matches_numpy_inputs,
    "all_masked": _all_masked_inputs,
    "nonfinite": _nonfinite_inputs,
    "neg_inf_without_min": _neg_inf_inputs,
    "mixed_nonfinite": _mixed_nonfinite_inputs,
    "ragged_n": _ragged_inputs,
    "g_2048": _widest_inputs,
}


@pytest.mark.parametrize("want_min", [True, False])
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_fold_matches_pallas(case, want_min):
    slots, vals, g, chunk = DENSE_CASES[case]()
    pad = -len(slots) % chunk  # trash rows up to a chunk multiple
    ref = dense_group_fold(
        np.concatenate([slots, np.full(pad, g, np.int32)]),
        np.concatenate([vals, np.ones(pad, np.float32)]),
        g, chunk=chunk, interpret=True, want_min=want_min,
    )
    got = dense_fold(torch.from_numpy(slots), torch.from_numpy(vals), g,
                     want_min=want_min)
    cnt, s, mx, mn = (None if x is None else np.asarray(x) for x in ref)
    np.testing.assert_array_equal(got[0].numpy(), cnt)
    np.testing.assert_allclose(got[1].numpy(), s, rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), mx)
    if want_min:
        np.testing.assert_array_equal(got[3].numpy(), mn)
    else:
        assert got[3] is None


def test_dense_fold_cpu_takes_plain_version():
    slots, vals, g, _ = _matches_numpy_inputs()
    before = dense_fold.launches
    a = dense_fold(torch.from_numpy(slots), torch.from_numpy(vals), g, True)
    b = dense_fold_reference(torch.from_numpy(slots), torch.from_numpy(vals),
                             g, True)
    assert dense_fold.launches == before  # no kernel launch on the CPU
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, equal_nan=True)


def test_hist_fold_matches_pallas():
    rng = np.random.default_rng(4)
    n, n_slots = 8192, 3000  # non-tile-multiple slot count
    bins = rng.integers(0, n_slots, n).astype(np.int32)
    bins[::5] = 4096  # trash (>= the Pallas kernel's padded range)
    vals = (rng.random(n).astype(np.float32) - 0.5) * 50
    w_ref, mw_ref = jax_hist_fold(bins, vals, n_slots, chunk=1024,
                                  interpret=True)
    before = hist_fold.launches
    w, mw = hist_fold(torch.from_numpy(bins), torch.from_numpy(vals), n_slots)
    assert hist_fold.launches == before
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    np.testing.assert_allclose(mw.numpy(), np.asarray(mw_ref), rtol=1e-4,
                               atol=1e-3)
    w2, mw2 = hist_fold_reference(torch.from_numpy(bins),
                                  torch.from_numpy(vals), n_slots)
    torch.testing.assert_close(w, w2)
    torch.testing.assert_close(mw, mw2)


def _hist_edge_inputs(case):
    """(ids, values, n_slots) of each edge case: a ragged n with ids out
    of range on both sides; a window of trash ids only; most rows on five
    hot slots (as t-digest bins on skewed values take them), some on the
    first and last slot, at 1, 1000 and 3000 slots."""
    rng = np.random.default_rng(8 if case in ("ragged_n", "all_trash") else 9)
    if case in ("ragged_n", "all_trash"):
        n, n_slots = 8195, 3000
        bins = rng.integers(-3, n_slots + 50, n).astype(np.int32)
        if case == "all_trash":
            bins[:] = n_slots
        return bins, (rng.random(n).astype(np.float32) - 0.5) * 50, n_slots
    n, n_slots = 6000, int(case.rsplit("_", 1)[1])
    hot = rng.integers(0, n_slots, 5)
    bins = np.where(rng.random(n) < 0.8, hot[rng.integers(0, 5, n)],
                    rng.integers(0, n_slots, n)).astype(np.int32)
    bins[:7] = 0
    bins[7:13] = n_slots - 1
    bins[::13] = -1  # dropped
    return bins, (rng.random(n) * 1e3).astype(np.float32), n_slots


@pytest.mark.parametrize("case", ["ragged_n", "all_trash", "hot_bins_1",
                                  "hot_bins_1000", "hot_bins_3000"])
def test_hist_fold_edges_match_pallas(case):
    """Weights exact and sums at the JAX package's tolerance on each edge
    case (the JAX side gets trash rows up to a chunk multiple)."""
    bins, vals, n_slots = _hist_edge_inputs(case)
    chunk, trash = 1024, 4096  # trash >= the Pallas kernel's padded range
    jbins = np.where((bins >= 0) & (bins < n_slots), bins, trash)
    pad = -len(bins) % chunk
    w_ref, mw_ref = jax_hist_fold(
        np.concatenate([jbins, np.full(pad, trash, np.int32)]),
        np.concatenate([vals, np.zeros(pad, np.float32)]), n_slots,
        chunk=chunk, interpret=True,
    )
    w, mw = hist_fold(torch.from_numpy(bins), torch.from_numpy(vals), n_slots)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    np.testing.assert_allclose(mw.numpy(), np.asarray(mw_ref), rtol=1e-4,
                               atol=1e-3)
    if case == "all_trash":
        assert not w.any() and not mw.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,want", [
    (1, "ranges"), (3 * 8192, "ranges"), (33 * 8192, "ranges"),
    (16 * 28_672, "ranges"), (16 * 28_672 + 1, "global"),
    (64 * 8192, "global"), (1 << 25, "global"),
])
def test_hist_route_by_slot_count(n_slots, want):
    """The route the kernel library chooses from the slot count alone. The
    choice lives in ``csrc/hist_fold.cu``, so this needs the built library
    (a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the route is chosen "
                    "in csrc/hist_fold.cu")
    assert hist_route(n_slots) == want


@pytest.mark.parametrize("fn", [dense_fold, hist_fold])
@pytest.mark.parametrize("ids_shape,vals_shape", [((8,), (9,)),
                                                  ((8, 2), (8, 2))],
                         ids=["lengths_differ", "two_dims"])
def test_wrappers_check_shapes(fn, ids_shape, vals_shape):
    """Ids and values of other lengths, or not 1-D, raise."""
    ids = torch.zeros(ids_shape, dtype=torch.int32)
    vals = torch.zeros(vals_shape, dtype=torch.float32)
    with pytest.raises(ValueError, match="1-D"):
        fn(ids, vals, 128)


@pytest.mark.parametrize("fn", [dense_fold, hist_fold])
def test_wrappers_refuse_other_devices(fn):
    """A tensor on neither the CPU nor a card gets no silent fallback."""
    ids = torch.zeros(8, dtype=torch.int32, device="meta")
    vals = torch.zeros(8, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fn(ids, vals, 128)


def test_wrappers_check_dtypes():
    with pytest.raises(TypeError):
        dense_fold(torch.zeros(4, dtype=torch.int64), torch.zeros(4), 128)
    with pytest.raises(TypeError):
        hist_fold(torch.zeros(4, dtype=torch.int32),
                  torch.zeros(4, dtype=torch.float64), 128)
    with pytest.raises(ValueError):
        dense_fold(torch.zeros(4, dtype=torch.int32), torch.zeros(4), 4096)


def _digest_inputs(num_groups):
    rng = np.random.default_rng(11)
    n = 8192
    vals = rng.integers(1_000, 100_000_000, n).astype(np.float32)
    vals[::97] = np.nan  # non-finite rows stay out of the sketch
    vals[::89] = -vals[::89]
    gids = rng.integers(0, num_groups, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    return vals, gids, mask


@pytest.mark.parametrize("num_groups", [3, 33])
def test_batch_to_digest_matches_jax(num_groups):
    """G = 3 reaches the JAX package's Pallas histogram kernel (in
    interpret mode); G = 33, the main path's service count, its XLA
    scatters. Centroid weights are sums of exact counts; means are f32
    sums in another order (rtol 1e-5)."""
    import jax.numpy as jnp

    vals, gids, mask = _digest_inputs(num_groups)
    set_flag("pallas_tdigest", "interpret")
    try:
        jm, jw = jax_tdigest.batch_to_digest(
            jnp.asarray(vals), jnp.asarray(gids), jnp.asarray(mask), num_groups
        )
    finally:
        set_flag("pallas_tdigest", "auto")
    tm, tw = tdigest.batch_to_digest(
        torch.from_numpy(vals), torch.from_numpy(gids),
        torch.from_numpy(mask), num_groups,
    )
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    merged = tdigest.digest_merge((tm, tw), (tm, tw))
    jmerged = jax_tdigest.digest_merge((jm, jw), (jm, jw))
    np.testing.assert_array_equal(merged[1].numpy(), np.asarray(jmerged[1]))
    np.testing.assert_allclose(merged[0].numpy(), np.asarray(jmerged[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("num_groups", [3, 33])
def test_digest_quantile_matches_jax(num_groups):
    """The same digest through both estimators: only f32 rounding of the
    interpolation differs (rtol 1e-5). Group 0 is left empty (NaN)."""
    import jax.numpy as jnp

    vals, gids, mask = _digest_inputs(num_groups)
    mask &= gids != 0
    jm, jw = jax_tdigest.batch_to_digest(
        jnp.asarray(vals), jnp.asarray(gids), jnp.asarray(mask), num_groups
    )
    qs = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)
    ref = np.asarray(jax_tdigest.digest_quantile((jm, jw), qs))
    got = tdigest.digest_quantile(
        (torch.from_numpy(np.array(jm)), torch.from_numpy(np.array(jw))), qs
    ).numpy()
    assert np.isnan(got[0]).all() and np.isnan(ref[0]).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


# -- the C interfaces, read from the sources ---------------------------------
# There is no nvcc on the CPU, so a wrapper whose ctypes argtypes or
# constants disagree with its .cu would first show on the card. These
# tests read the sources instead.

CSRC = Path(dense_fold_mod.__file__).resolve().parent.parent / "csrc"
_CTYPE_KINDS = {
    ctypes.c_void_p: "pointer", ctypes.c_longlong: "long long",
    ctypes.c_int: "int", ctypes.c_char_p: "string",
}


def _c_kind(param: str) -> str:
    param = " ".join(param.split())
    if param.startswith("const char*"):
        return "string"
    if "*" in param:
        return "pointer"
    if param.startswith("long long"):
        return "long long"
    if param.startswith("int"):
        return "int"
    raise AssertionError(f"no ctypes kind for C type {param!r}")


def _extern_c_functions(src: str) -> dict:
    """{name: (return kind, [parameter kinds])} of each ``extern "C"``
    function in ``src``."""
    found = re.findall(
        r'extern "C" (int|long long|const char\*) (\w+)\(([^)]*)\)', src)
    return {name: (_c_kind(ret),
                   [_c_kind(p) for p in params.split(",") if p.strip()])
            for ret, name, params in found}


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _enum(src: str, first: str) -> list:
    body = re.search(rf"enum[^{{]*\{{\s*({first}[^}}]*)\}}", src).group(1)
    return [m.split("=")[0].strip() for m in body.split(",")]


@pytest.mark.parametrize("name,module", [
    ("dense_fold", dense_fold_mod), ("hist_fold", hist_fold_mod),
    ("int_fold", int_fold_mod),
])
def test_c_interfaces_match_wrappers(name, module):
    """Each ``extern "C"`` function of ``csrc/<name>.cu`` has a signature
    in its wrapper, with the same return kind and parameter count and
    kinds (pointer, long long, int, string), and the wrapper binds
    nothing the source lacks."""
    funcs = _extern_c_functions((CSRC / f"{name}.cu").read_text())
    assert funcs and set(funcs) == set(module.C_SIGNATURES)
    for fn, (ret, kinds) in funcs.items():
        restype, argtypes = module.C_SIGNATURES[fn]
        got = (_CTYPE_KINDS[restype], [_CTYPE_KINDS[t] for t in argtypes])
        assert got == (ret, kinds), f"{fn}: wrapper {got} vs source {ret, kinds}"


def test_c_constants_match_wrappers():
    """The slot limit and workspace layout that ``dense_fold`` and its
    kernel share."""
    dense = (CSRC / "dense_fold.cu").read_text()
    assert _constexpr(dense, "kMaxSlots") == dense_fold_mod.MAX_SLOTS
    arrays = _enum(dense, "kCnt")
    assert arrays == ["kCnt", "kSum", "kMax", "kMin", "kNinf", "kNan",
                      "kWsArrays"]
    rest = np.array(dense_fold_mod._WS_REST, dtype=np.int64) & 0xFFFFFFFF
    # The ordered u32 of -inf (max's rest) and +inf (min's rest).
    inf_bits = np.array([-np.inf, np.inf], np.float32).view(np.uint32)
    order = np.where(inf_bits >> 31, ~inf_bits, inf_bits | 0x80000000)
    assert rest.tolist() == [0, 0, int(order[0]), int(order[1]), 0, 0]
    assert f"0x{int(order[0]):08X}u" in dense
    assert f"0x{int(order[1]):08X}u" in dense


def test_int_fold_constants_match_wrapper():
    """The slot limit and workspace layout that ``int_fold`` and its
    kernel share: count | sum | max | min at rest 0, 0, INT64_MIN,
    INT64_MAX."""
    src = (CSRC / "int_fold.cu").read_text()
    assert _constexpr(src, "kMaxSlots") == int_fold_mod.MAX_SLOTS
    assert _enum(src, "kCnt") == ["kCnt", "kSum", "kMax", "kMin",
                                  "kWsArrays"]
    info = np.iinfo(np.int64)
    assert int_fold_mod._WS_REST == (0, 0, info.min, info.max)
    assert "k == kMax ? LLONG_MIN : k == kMin ? LLONG_MAX : 0LL" in src



def test_launch_counts_survive_concurrent_launchers():
    """Agents launch from several bus threads at once: the counter and
    its per-thread tally lose no update (a shortened switch interval
    makes a lost read-modify-write likely if the count were unlocked)."""
    import sys
    import threading
    import types

    from pixie_tpu_torch.ops import cuda_lib

    fake = types.SimpleNamespace(launches=0, launches_by_thread={})
    n_threads, per = 16, 2000

    def launch():
        for _ in range(per):
            cuda_lib.count_launch(fake)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, name=f"launcher-{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fake.launches == n_threads * per
    assert fake.launches_by_thread == {
        f"launcher-{i}": per for i in range(n_threads)}
