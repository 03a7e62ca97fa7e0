"""The port's bench (``pixie_tpu_torch/bench.py``) against the repo
root's ``bench.py``, on the CPU at small sizes (2^14 rows per shape,
2^12-row windows; two shapes take smaller windows of their own).

- each of the ten shapes' replays is bit-identical to bench.py's: its
  tables' relations, dictionaries and every column array (bench.py's
  shape functions are run until they push their tables, and the pushed
  column functions are compared over all their rows);
- each shape runs through ``run_shape(..., device="cpu")`` with
  ``checked: True`` (bench.py's numpy assertions), the A/B pass
  included;
- the http_stats and service_stats answers equal the JAX engine's over
  the same replay (counts and INT64 aggregates exact, error rate rtol
  1e-12, p50/p99 rtol 0.05);
- ``python -m pixie_tpu_torch.bench --device cpu`` prints one parseable
  line, and without a card and without ``--device cpu`` it exits
  non-zero with the no-CUDA error.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu_torch import bench
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services.observability import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
ROWS, WINDOW = 1 << 14, 1 << 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _head(shape: str) -> int:
    """Head rows giving the shape ROWS rows after its divisor."""
    return ROWS * bench.SHAPE_DEFS[shape][1]


class _Captured(Exception):
    pass


def _jax_tables(shape: str, monkeypatch) -> dict:
    """Run bench.py's shape function until it has pushed every table of
    the shape; return {table: (relation, col_fn, rows, dicts)}."""
    want = len(bench.REPLAYS[shape](ROWS, WINDOW).tables)
    got: dict = {}

    def capture(eng, name, rel, col_fn, n, window, dicts):
        got[name] = (rel, col_fn, n, dicts)
        if len(got) == want:
            raise _Captured

    monkeypatch.setattr(jax_bench, "_push_encoded", capture)
    fn_name, div = jax_bench.SHAPE_DEFS[shape]
    with pytest.raises(_Captured):
        getattr(jax_bench, fn_name)(_head(shape) // div, WINDOW)
    return got


@pytest.mark.parametrize("shape", bench.ALL_SHAPES)
def test_replay_is_bit_identical_to_bench_py(shape, monkeypatch):
    assert tuple(jax_bench.SHAPE_DEFS) == bench.ALL_SHAPES
    assert jax_bench.SHAPE_DEFS[shape][1] == bench.SHAPE_DEFS[shape][1]
    ref = _jax_tables(shape, monkeypatch)
    rp = bench.REPLAYS[shape](_head(shape) // bench.SHAPE_DEFS[shape][1],
                              WINDOW)
    assert set(rp.tables) == set(ref)
    for name, src in rp.tables.items():
        rel, col_fn, n, dicts = ref[name]
        assert src.rows == n
        assert [(c, t.name) for c, t in src.relation.items()] == [
            (c, t.name) for c, t in rel.items()]
        assert set(src.dicts) == set(dicts)
        for c, d in src.dicts.items():
            assert list(d.strings) == list(dicts[c].strings)
        # Every row the shape ever appends (dashboard_repeat appends one
        # more window after its first n rows).
        total = n + (rp.window if shape == "dashboard_repeat" else 0)
        want, have = col_fn(0, total), src.cols(0, total)
        assert set(have) == set(want)
        for c in want:
            assert len(have[c]) == len(want[c]) == 1
            a, b = have[c][0], want[c][0]
            assert a.dtype == b.dtype and len(a) == len(b) == total, c
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c}")


@pytest.mark.parametrize("shape", bench.ALL_SHAPES)
def test_run_shape_checked_on_cpu(shape):
    res = bench.run_shape(shape, _head(shape), WINDOW, device="cpu", ab=True)
    assert res["checked"] is True
    assert res["rows_per_sec"] > 0 and res["secs"] > 0
    assert res["launches"] == {"dense_fold": 0, "hist_fold": 0}  # CPU
    if "pipeline" in res:
        assert res["pipeline"]["windows"] > 0
        assert res["pipeline"]["ab"]["checked"] is True
        assert res["pipeline"]["ab"]["bit_identical"] is True  # the CPU
        assert res["latency"]["query_seconds"]["p50"] > 0
    if shape == "http_stats":
        assert res["profile"]["windows"] == ROWS // WINDOW
    if shape in ("device_join", "device_join_skew", "device_join_select"):
        assert res["join"]["retries_total"] >= res["join"].get("retries", 0)
    if shape == "dashboard_repeat":
        assert res["repeat"]["dispositions"] == {"hit": 10}
        assert res["view"]["bit_identical"] is True
    if shape == "cold_scan":
        assert res["selective"]["skip_rate"] >= 0.9


@pytest.mark.parametrize("script", ["http_stats", "service_stats"])
def test_answers_equal_the_jax_engine(script):
    """The port bench's engine and bench.py's over the same replay."""
    rp = bench._http_replay(ROWS, WINDOW)
    run = bench._Run(device=torch.device("cpu"), ab=False,
                     registry=MetricsRegistry())
    eng = bench._load(run, rp)
    jax_eng, _warm, _arrays = jax_bench._http_replay(ROWS, WINDOW)
    query = load_script(f"px/{script}").pxl
    keys = ["service", "req_path"] if script == "http_stats" else ["service"]

    def rows(hb):
        d = {k: np.asarray(v) for k, v in hb.to_pydict().items()}
        order = np.lexsort([d[k] for k in reversed(keys)])
        return {k: v[order] for k, v in d.items()}

    got = rows(bench._to_host(eng.execute_query(query, materialize=False))[
        "output"])
    with jax_override_flag("cpu_fold_threads", 1), \
            jax_override_flag("pallas_tdigest", "interpret"):
        out = jax_eng.execute_query(query, materialize=False)["output"]
        ref = rows(out.to_host())
    assert set(got) == set(ref)
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k])
    if script == "http_stats":
        assert len(got["n"]) == 32 * 8
        for c in ("n", "lat_mean", "lat_max"):
            np.testing.assert_array_equal(got[c], ref[c])
    else:
        assert len(got["throughput"]) == 32
        np.testing.assert_array_equal(got["throughput"], ref["throughput"])
        np.testing.assert_allclose(got["error_rate"], ref["error_rate"],
                                   rtol=1e-12)
        np.testing.assert_allclose(got["p50"], ref["p50"], rtol=0.05)
        np.testing.assert_allclose(got["p99"], ref["p99"], rtol=0.05)


def _cli_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIXIE_TPU_BENCH")}
    env.update(extra)
    return env


def test_cli_on_the_cpu_prints_one_line():
    env = _cli_env(PIXIE_TPU_BENCH_ROWS=str(ROWS),
                   PIXIE_TPU_BENCH_WINDOW=str(WINDOW),
                   PIXIE_TPU_BENCH_SHAPES="http_stats",
                   PIXIE_TPU_BENCH_AB="0")
    proc = subprocess.run(
        [sys.executable, "-m", "pixie_tpu_torch.bench", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "http_stats_rows_per_sec"
    assert line["unit"] == "rows/s" and line["device"] == "cpu"
    assert line["card"] is None
    assert line["baseline"] == bench.BASELINE
    shape = line["shapes"]["http_stats"]
    assert shape["checked"] is True and shape["rows"] == ROWS
    assert line["value"] == shape["rows_per_sec"] > 0
    assert line["vs_baseline"] == shape["vs_baseline"] > 0
    assert "pipeline" in shape and "latency" in shape and "profile" in shape


def test_cli_without_a_card_exits_non_zero():
    """No CUDA device here, and no ``--device cpu``: resolve_device's
    error, no result line."""
    assert not torch.cuda.is_available()
    proc = subprocess.run(
        [sys.executable, "-m", "pixie_tpu_torch.bench"],
        cwd=REPO, env=_cli_env(PIXIE_TPU_BENCH_SHAPES="http_stats"),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device available" in proc.stderr
    assert not proc.stdout.strip()
