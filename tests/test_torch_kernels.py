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

import numpy as np
import pytest
import torch

from pixie_tpu.config import set_flag
from pixie_tpu.ops import tdigest as jax_tdigest
from pixie_tpu.ops.pallas_groupby import dense_group_fold
from pixie_tpu.ops.pallas_tdigest import hist_fold as jax_hist_fold
from pixie_tpu_torch.ops import tdigest
from pixie_tpu_torch.ops.dense_fold import dense_fold, dense_fold_reference
from pixie_tpu_torch.ops.hist_fold import hist_fold, hist_fold_reference


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


DENSE_CASES = {
    "matches_numpy": _matches_numpy_inputs,
    "all_masked": _all_masked_inputs,
    "nonfinite": _nonfinite_inputs,
    "neg_inf_without_min": _neg_inf_inputs,
    "mixed_nonfinite": _mixed_nonfinite_inputs,
}


@pytest.mark.parametrize("want_min", [True, False])
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_fold_matches_pallas(case, want_min):
    slots, vals, g, chunk = DENSE_CASES[case]()
    ref = dense_group_fold(slots, vals, g, chunk=chunk, interpret=True,
                           want_min=want_min)
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
