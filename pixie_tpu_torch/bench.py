"""The port's benchmark: bench.py's ten query shapes on the card.

    python -m pixie_tpu_torch.bench                 # on the card (cuda)
    python -m pixie_tpu_torch.bench --device cpu    # on the CPU

Each shape replays bench.py's synthetic tables (the same recipes, seeds
and row divisors, so the arrays are bit-identical), pushes them through
``Engine.append_data`` in window-sized batches, runs the same shipped
PxL script (or bench.py's inline query) through ``Engine.execute_query``
and checks the answer against bench.py's vectorized numpy replay, whose
time is the ``vs_baseline`` denominator. A shape whose check fails has
no rate. It prints ONE JSON line:

  {"metric": "http_stats_rows_per_sec", "value": rows/s, "unit": "rows/s",
   "vs_baseline": x, "baseline": ..., "device": "cuda"|"cpu",
   "card": "<nvidia-smi name, power.limit>", "shapes": {per-shape results}}

Each shape carries ``pipeline`` (windows, stall and, with the A/B pass,
serial against pipelined staging), ``latency`` (p50/p95/p99 from the
shape's own metrics registry), ``launches`` (each CUDA kernel's launches
in the timed run) and, for http_stats, ``profile`` (an attribution
run's stage seconds).

Timing: the warm-up runs with ``materialize=False`` and
``DeviceResult.block_until_ready()``; the table's one-time staging is
fenced with ``torch.cuda.synchronize`` before the timer starts; the
timed run ends at ``to_host()``, the readback, so work still queued on
the card cannot end it early.

Process model: the launcher runs each shape in a subprocess of its own
(``PIXIE_TPU_BENCH_INNER=1``), so one shape's allocations and threads
never reach the next. ``run_shape`` runs one shape in the calling
process. The device is ``cuda`` unless ``--device cpu`` or
``PIXIE_TPU_BENCH_DEVICE=cpu`` asks for the CPU; without a card the
bench exits non-zero. It exits non-zero too when any shape fails its
check or does not finish.

Environment knobs:
  PIXIE_TPU_BENCH_ROWS     head rows (default 2^24 on cuda, 2^21 on cpu)
  PIXIE_TPU_BENCH_WINDOW   window rows per device dispatch (default 2^21)
  PIXIE_TPU_BENCH_BUDGET   launcher wall-clock budget in seconds (default 1800)
  PIXIE_TPU_BENCH_SHAPES   comma list of shapes to run (default all ten)
  PIXIE_TPU_BENCH_AB       0 skips the serial-vs-pipelined A/B pass
  PIXIE_TPU_BENCH_DEVICE   cuda (default) or cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable

import numpy as np

# Shape registry: name -> (shape fn attr, rows divisor vs the head rows).
SHAPE_DEFS = {
    "http_stats": ("_shape_http_stats", 1),
    "service_stats": ("_shape_service_stats", 1),
    "net_flow_graph": ("_shape_net_flow_graph", 2),
    "sql_stats": ("_shape_sql_stats", 4),
    "perf_flamegraph": ("_shape_perf_flamegraph", 4),
    "device_join": ("_shape_device_join", 4),
    # Skewed (zipf) and selective clustered join keys; both group on
    # columns from both sides, so they measure the N:M join path.
    "device_join_skew": ("_shape_device_join_skew", 4),
    "device_join_select": ("_shape_device_join_select", 4),
    # One dashboard script repeated: cold rescan, result-cache hit and
    # incremental materialized-view fold.
    "dashboard_repeat": ("_shape_dashboard_repeat", 2),
    # Selective and full scans over a mostly-cold (tiered) table.
    "cold_scan": ("_shape_cold_scan", 4),
}
ALL_SHAPES = tuple(SHAPE_DEFS)

DEVICE_ENV = "PIXIE_TPU_BENCH_DEVICE"
CUDA_ROWS = 1 << 24
CPU_ROWS = 1 << 21
DEFAULT_WINDOW = 1 << 21
DEFAULT_BUDGET_S = 1800.0
MIN_SHAPE_S = 60.0  # the least a shape is started with
BASELINE = "in-process numpy replay (see BASELINE.md)"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _script(name: str) -> str:
    """PxL source of a shipped library script."""
    from .scripts import load_script

    return load_script(name).pxl


def card_line() -> str | None:
    """``nvidia-smi``'s "name, power.limit" line for the current card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"[bench] nvidia-smi: {e}")
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def _env_device() -> str:
    return os.environ.get(DEVICE_ENV, "cuda")


def _ab_enabled() -> bool:
    return os.environ.get("PIXIE_TPU_BENCH_AB", "1") not in ("0", "false")


# ---------------------------------------------------------------------------
# Replays: bench.py's table recipes, the arrays bit-identical to its own.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Source:
    """One replayed table: ``cols(off, m)`` gives rows [off, off + m) as
    {column: (plane,)}; ``rows`` of them are appended up front."""

    relation: object
    cols: Callable[[int, int], dict]
    rows: int
    dicts: dict


@dataclasses.dataclass
class Replay:
    """A shape's tables and the arrays its numpy check reads. ``n`` and
    ``window`` are the shape's own (two shapes adjust them)."""

    tables: dict
    data: dict
    n: int
    window: int


def _codes(rng, n, vocab_len):
    return rng.integers(0, vocab_len, n).astype(np.int32)


def _rel(items):
    from .types.dtypes import DataType
    from .types.relation import Relation

    return Relation([(n, DataType[t]) for n, t in items])


def _dict(strings):
    from .types.strings import StringDictionary

    return StringDictionary(strings)


_HTTP_RELATION = (
    ("time_", "TIME64NS"), ("latency_ns", "INT64"), ("resp_status", "INT64"),
    ("service", "STRING"), ("req_path", "STRING"),
)


def _http_cols(lat, status, svc_codes, path_codes):
    def cols(off, m):
        s = slice(off, off + m)
        return {
            "time_": (np.arange(off, off + m, dtype=np.int64),),
            "latency_ns": (lat[s],),
            "resp_status": (status[s],),
            "service": (svc_codes[s],),
            "req_path": (path_codes[s],),
        }

    return cols


def _http_replay(n, window, rng_seed=7, extra=0) -> Replay:
    """The http_events replay of http_stats and service_stats (and, with
    ``extra`` rows drawn after the first n, of dashboard_repeat)."""
    rng = np.random.default_rng(rng_seed)
    services = [f"svc-{i}" for i in range(32)]
    paths = [f"/api/v1/ep{i}" for i in range(8)]
    statuses = np.array([200, 200, 200, 200, 404, 500])
    total = n + extra
    svc_codes = _codes(rng, total, len(services))
    path_codes = _codes(rng, total, len(paths))
    lat = rng.integers(1_000, 100_000_000, total)
    status = statuses[rng.integers(0, len(statuses), total)].astype(np.int64)
    dicts = {"service": _dict(services), "req_path": _dict(paths)}
    return Replay(
        tables={"http_events": Source(
            _rel(_HTTP_RELATION),
            _http_cols(lat, status, svc_codes, path_codes), n, dicts,
        )},
        data={"lat": lat, "status": status, "svc": svc_codes,
              "path": path_codes},
        n=n, window=window,
    )


def _dashboard_replay(n, window) -> Replay:
    """http_events with one more window drawn after the n rows (appended
    once the view registers), in windows of at most n / 64 rows."""
    window = max(min(window, n // 64), 1024)
    return _http_replay(n, window, extra=window)


def _net_flow_replay(n, window) -> Replay:
    rng = np.random.default_rng(11)
    n_pods = 48
    pods = [f"ns/pod-{i}" for i in range(n_pods)]
    addrs = [f"10.1.{i // 250}.{i % 250}" for i in range(n_pods)]
    pod_dict, addr_dict = _dict(pods), _dict(addrs)
    src = _codes(rng, n, n_pods)
    dst = _codes(rng, n, n_pods)
    sent = rng.integers(64, 1 << 20, n)
    recv = rng.integers(64, 1 << 20, n)

    def cols(off, m):
        s = slice(off, off + m)
        return {
            "time_": (np.arange(off, off + m, dtype=np.int64),),
            "src_addr": (src[s],),   # pod i owns addr i
            "src_pod": (src[s],),
            "remote_addr": (dst[s],),
            "bytes_sent": (sent[s],),
            "bytes_recv": (recv[s],),
        }

    rel = _rel((
        ("time_", "TIME64NS"), ("src_addr", "STRING"), ("src_pod", "STRING"),
        ("remote_addr", "STRING"), ("bytes_sent", "INT64"),
        ("bytes_recv", "INT64"),
    ))
    dicts = {"src_addr": addr_dict, "src_pod": pod_dict,
             "remote_addr": addr_dict}
    return Replay(
        tables={"conn_stats": Source(rel, cols, n, dicts)},
        data={"src": src, "dst": dst, "sent": sent, "recv": recv,
              "n_pods": n_pods},
        n=n, window=window,
    )


def _sql_replay(n, window) -> Replay:
    rng = np.random.default_rng(13)
    tables = ["users", "orders", "items", "carts", "sessions"]
    raw = []
    for i in range(400):  # 400 raw strings -> ~10 normalized shapes
        t = tables[i % len(tables)]
        raw.append(f"SELECT * FROM {t} WHERE id = {i} AND name = 'u{i}'")
        raw.append(f"UPDATE {t} SET v = {i * 3} WHERE id IN ({i}, {i + 1})")
    qc = _codes(rng, n, len(raw))
    lat = rng.integers(10_000, 50_000_000, n)
    # ~64 one-second windows across the replay.
    tns = ((np.arange(n, dtype=np.int64) * 64) // max(n, 1)) * 1_000_000_000

    def cols(off, m):
        s = slice(off, off + m)
        return {"time_": (tns[s],), "query_str": (qc[s],),
                "latency_ns": (lat[s],)}

    rel = _rel((("time_", "TIME64NS"), ("query_str", "STRING"),
                ("latency_ns", "INT64")))
    return Replay(
        tables={"mysql_events": Source(rel, cols, n,
                                       {"query_str": _dict(raw)})},
        data={"raw": raw, "qc": qc, "lat": lat, "tns": tns},
        n=n, window=window,
    )


def _flamegraph_replay(n, window) -> Replay:
    rng = np.random.default_rng(17)
    frames = ["main", "run", "poll", "parse", "exec", "gc", "alloc", "read"]
    stacks = []
    for i in range(2000):
        depth = 2 + i % 6
        stacks.append(";".join(
            frames[(i + d) % len(frames)] + f"_{(i * 7 + d) % 97}"
            for d in range(depth)
        ))
    sc = _codes(rng, n, len(stacks))
    cnt = rng.integers(1, 50, n)

    def cols(off, m):
        s = slice(off, off + m)
        return {
            "time_": (np.arange(off, off + m, dtype=np.int64),),
            "stack_trace": (sc[s],),
            "count": (cnt[s],),
        }

    rel = _rel((("time_", "TIME64NS"), ("stack_trace", "STRING"),
                ("count", "INT64")))
    return Replay(
        tables={"stack_traces.beta": Source(
            rel, cols, n, {"stack_trace": _dict(stacks)}
        )},
        data={"sc": sc, "cnt": cnt, "n_stacks": len(stacks)},
        n=n, window=window,
    )


def _join_sources(lk, lb, rk, v_cols: dict) -> dict:
    """conn_l(time_, k, b) and conn_r(time_, k, <v_cols>) over the given
    key and value arrays."""
    rel_l = _rel((("time_", "TIME64NS"), ("k", "INT64"), ("b", "INT64")))
    rel_r = _rel((("time_", "TIME64NS"), ("k", "INT64"))
                 + tuple((c, "INT64") for c in v_cols))

    def cols_l(off, m):
        s = slice(off, off + m)
        return {"time_": (np.arange(off, off + m, dtype=np.int64),),
                "k": (lk[s],), "b": (lb[s],)}

    def cols_r(off, m):
        s = slice(off, off + m)
        out = {"time_": (np.arange(off, off + m, dtype=np.int64),),
               "k": (rk[s],)}
        out.update({c: (a[s],) for c, a in v_cols.items()})
        return out

    return {"conn_l": Source(rel_l, cols_l, len(lk), {}),
            "conn_r": Source(rel_r, cols_r, len(rk), {})}


def _device_join_replay(n, window) -> Replay:
    rng = np.random.default_rng(19)
    n_keys = max(n // 2, 1)
    lk = rng.integers(0, n_keys, n)
    lb = rng.integers(0, 16, n)
    rk = rng.integers(0, n_keys, n)
    rv = rng.integers(0, 1000, n)
    return Replay(
        tables=_join_sources(lk, lb, rk, {"v": rv}),
        data={"n_keys": n_keys, "lk": lk, "lb": lb, "rk": rk, "rv": rv},
        n=n, window=window,
    )


def _join_skew_replay(n, window) -> Replay:
    rng = np.random.default_rng(23)
    n_keys = max(n // 2, 1)
    lk = rng.integers(0, n_keys, n)
    lb = rng.integers(0, 16, n)
    # Zipf build keys spread over the id space by a fixed odd multiplier
    # (keeps skew, decorrelates hot ids from zone ranges).
    rk = (np.minimum(rng.zipf(1.5, n), n_keys) - 1) * 2654435761 % n_keys
    rc = rng.integers(0, 8, n)
    rv = rng.integers(0, 1000, n)
    return Replay(
        tables=_join_sources(lk, lb, rk, {"c": rc, "v": rv}),
        data={"n_keys": n_keys, "lk": lk, "lb": lb, "rk": rk, "rc": rc,
              "rv": rv},
        n=n, window=window,
    )


def _join_select_replay(n, window) -> Replay:
    rng = np.random.default_rng(29)
    n_keys = max(n // 2, 2)
    lk = (np.arange(n, dtype=np.int64) * n_keys) // n + rng.integers(
        0, max(n_keys // 256, 1), n
    )
    np.minimum(lk, n_keys - 1, out=lk)
    lb = rng.integers(0, 16, n)
    n_r = max(n // 4, 1)
    rk = rng.integers(n_keys - n_keys // 8, n_keys, n_r)
    rc = rng.integers(0, 8, n_r)
    rv = rng.integers(0, 1000, n_r)
    return Replay(
        tables=_join_sources(lk, lb, rk, {"c": rc, "v": rv}),
        data={"n_keys": n_keys, "lk": lk, "lb": lb, "rk": rk, "rc": rc,
              "rv": rv},
        n=n, window=window,
    )


def _cold_scan_replay(n, window) -> Replay:
    """Many windows (skip-rate resolution), whole windows only (window k
    holds exactly shard k)."""
    window = max(min(window, n // 64), 1024)
    n = max((n // window) * window, window)
    rng = np.random.default_rng(31)
    services = [f"svc-{i}" for i in range(16)]
    shard = np.arange(n, dtype=np.int64) // window
    lat = rng.integers(1_000, 100_000_000, n)
    svc_codes = _codes(rng, n, len(services))

    def cols(off, m):
        s = slice(off, off + m)
        return {
            "time_": (np.arange(off, off + m, dtype=np.int64),),
            "shard": (shard[s],),
            "latency_ns": (lat[s],),
            "service": (svc_codes[s],),
        }

    rel = _rel((("time_", "TIME64NS"), ("shard", "INT64"),
                ("latency_ns", "INT64"), ("service", "STRING")))
    return Replay(
        tables={"events": Source(rel, cols, n,
                                 {"service": _dict(services)})},
        data={"shard": shard, "lat": lat, "svc": svc_codes,
              "n_services": len(services)},
        n=n, window=window,
    )


#: shape -> its replay builder (n and window after the row divisor).
REPLAYS = {
    "http_stats": _http_replay,
    "service_stats": _http_replay,
    "net_flow_graph": _net_flow_replay,
    "sql_stats": _sql_replay,
    "perf_flamegraph": _flamegraph_replay,
    "device_join": _device_join_replay,
    "device_join_skew": _join_skew_replay,
    "device_join_select": _join_select_replay,
    "dashboard_repeat": _dashboard_replay,
    "cold_scan": _cold_scan_replay,
}


# ---------------------------------------------------------------------------
# Engines and timing.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Run:
    """One shape's settings: the device, the A/B pass and the metrics
    registry its engines' tracers record into (the shape's own, so its
    latency quantiles hold only its queries)."""

    device: object
    ab: bool
    registry: object


def _push_encoded(eng, name, src: Source, off: int, rows: int, window: int):
    """Push pre-encoded windows through the ingest path (append_data).
    String columns arrive as dictionary ids sharing the replay's
    dictionaries, as a collector's staging produces them."""
    from .types.batch import HostBatch

    for o in range(off, off + rows, window):
        m = min(window, off + rows - o)
        eng.append_data(name, HostBatch(
            relation=src.relation, cols=src.cols(o, m), length=m,
            dicts=src.dicts,
        ))


def _engine(run: _Run, window: int):
    from .exec.engine import Engine
    from .exec.trace import Tracer

    eng = Engine(window_rows=window, device=run.device)
    eng.tracer = Tracer(registry=run.registry)
    return eng


def _load(run: _Run, rp: Replay, rows: int | None = None, **create_kw):
    """An engine holding the replay's tables (the first ``rows`` rows of
    each when given)."""
    eng = _engine(run, rp.window)
    for name, src in rp.tables.items():
        eng.create_table(name, **create_kw)
        n = src.rows if rows is None else min(src.rows, rows)
        _push_encoded(eng, name, src, 0, n, rp.window)
    return eng


def _build_engines(run: _Run, rp: Replay):
    """(full engine, single-window warm engine) over the same replay."""
    return _load(run, rp), _load(run, rp, rows=rp.window)


def _fence(device) -> None:
    """Wait for all work queued on the card (nothing on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _settle(out: dict) -> None:
    """Wait for a warm-up's device-resident results without reading
    them back."""
    from .exec.engine import DeviceResult

    for v in out.values():
        if isinstance(v, DeviceResult):
            v.block_until_ready()


def _to_host(out: dict) -> dict:
    from .exec.engine import DeviceResult

    return {k: v.to_host() if isinstance(v, DeviceResult) else v
            for k, v in out.items()}


def _launch_counts() -> dict:
    """Each CUDA kernel's launches so far in this process."""
    from .ops.dense_fold import dense_fold
    from .ops.hist_fold import hist_fold

    return {"dense_fold": dense_fold.launches, "hist_fold": hist_fold.launches}


def _launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launch_counts().items()}


def _latency_report(registry) -> dict | None:
    """p50/p95/p99 from the shape's trace histograms
    (pixie_query_duration_seconds, pixie_window_stage_seconds): its
    warm-ups, timed run and A/B arms."""
    out: dict = {}

    def pcts(name, **labels):
        q = registry.quantiles(name, (0.5, 0.95, 0.99), **labels)
        if not q:
            return None
        return {"p50": q[0.5], "p95": q[0.95], "p99": q[0.99]}

    p = pcts("pixie_query_duration_seconds")
    if p:
        out["query_seconds"] = p
    for stage in ("compute", "stage", "stall"):
        p = pcts("pixie_window_stage_seconds", stage=stage)
        if p:
            out[f"window_{stage}_seconds"] = p
    return out or None


def _host_equal(a: dict, b: dict) -> bool:
    """Exact equality of two {name: HostBatch} query outputs."""
    if set(a) != set(b):
        return False
    for k in a:
        da, db = a[k].to_pydict(), b[k].to_pydict()
        if set(da) != set(db):
            return False
        for c in da:
            if not np.array_equal(da[c], db[c]):
                return False
    return True


def _flag_override(name, value):
    from .config import override_flag

    return override_flag(name, value)


def _pipeline_ab(eng, query, host_ref) -> tuple[dict, list]:
    """Serial (depth 1) against pipelined (depth >= 2) with device
    residency off, so every window pays the host slicing, packing and
    copy the prefetch thread exists to hide. Returns the report and the
    two arms' answers, which the shape holds to its numpy check
    (``checked``). ``bit_identical``: both arms equal each other and the
    resident run's answer bit for bit (not so where a kernel adds f32
    values with atomics, in an order that varies from run to run)."""
    from .config import get_flag

    saved_depth = eng.pipeline_depth
    depth = max(2, saved_depth or int(get_flag("pipeline_depth")))
    secs, host, pl = {}, {}, {}
    try:
        with _flag_override("device_residency", False):
            for label, d in (("serial", 1), ("pipelined", depth)):
                eng.pipeline_depth = d
                t0 = time.perf_counter()
                host[label] = _to_host(
                    eng.execute_query(query, materialize=False)
                )
                secs[label] = time.perf_counter() - t0
                pl[label] = dict(eng.last_stats.pipeline)
    finally:
        eng.pipeline_depth = saved_depth
    stage = pl["pipelined"].get("stage_secs", 0.0)
    stall = pl["pipelined"].get("stall_secs", 0.0)
    return {
        "depth": depth,
        "serial_secs": secs["serial"],
        "pipelined_secs": secs["pipelined"],
        "speedup": secs["serial"] / max(secs["pipelined"], 1e-9),
        "stage_secs": stage,
        "stall_secs": stall,
        # Fraction of staging time hidden behind compute.
        "overlap_frac": (
            max(0.0, min(1.0, 1.0 - stall / stage)) if stage > 0 else 1.0
        ),
        "bit_identical": bool(
            _host_equal(host["serial"], host["pipelined"])
            and _host_equal(host["pipelined"], host_ref)
        ),
    }, [host["serial"], host["pipelined"]]


@dataclasses.dataclass
class Timed:
    """The steady-state run of one query: rows/s, seconds, the host
    answers (the timed run's, then the A/B arms'), and the report merged
    into the shape's result. The shape checks every answer."""

    rows_per_sec: float
    secs: float
    outs: list
    report: dict


def _time_query(eng, query, n_rows, run: _Run, warm_eng=None,
                profile=False) -> Timed:
    """Warm up (the single-window clone, then the full engine, with
    ``materialize=False``; with the A/B pass also with residency off),
    fence the card, then time one query from ``execute_query`` to its
    ``to_host()``. Then the A/B pass and, with ``profile``, an
    attribution run (``analyze=True``: fenced per stage)."""
    engines = ([warm_eng] if warm_eng is not None else []) + [eng]
    for e in engines:
        _settle(e.execute_query(query, materialize=False))
    if run.ab:
        with _flag_override("device_residency", False):
            for e in engines:
                _settle(e.execute_query(query, materialize=False))
    # The resident windows were staged at append time on a side stream:
    # the timed run must not pay for their copies.
    _fence(run.device)
    before = _launch_counts()
    t0 = time.perf_counter()
    host = _to_host(eng.execute_query(query, materialize=False))
    dt = time.perf_counter() - t0
    launches = _launch_delta(before)
    pl = dict(eng.last_stats.pipeline)
    pipeline = {
        "depth": pl.get("depth"),
        "windows": pl.get("windows", 0),
        "stall_secs": pl.get("stall_secs", 0.0),
    }
    outs = [host]
    if run.ab:
        pipeline["ab"], arms = _pipeline_ab(eng, query, host)
        outs += arms
        # Stall and overlap come from the host-staged arm (the resident
        # run stages nothing).
        pipeline["overlap_frac"] = pipeline["ab"]["overlap_frac"]
        pipeline["stall_secs"] = pipeline["ab"]["stall_secs"]
    report = {"pipeline": pipeline, "latency": _latency_report(run.registry),
              "launches": launches}
    if profile:
        eng.execute_query(query, analyze=True)
        prof = eng.last_stats.to_dict()
        report["profile"] = {
            "stage_totals": prof["stage_totals"],
            "windows": sum(f["windows"] for f in prof["fragments"]),
            "analyzed_seconds": prof["total_seconds"],
        }
    return Timed(n_rows / dt, dt, outs, report)


def _result(rows: int, t: Timed, base_dt: float, **extra) -> dict:
    """A shape's result, once every answer of ``t`` passed its check."""
    if "ab" in t.report["pipeline"]:
        t.report["pipeline"]["ab"]["checked"] = True
    return {
        "rows": rows, "rows_per_sec": t.rows_per_sec, "secs": t.secs,
        "vs_baseline": t.rows_per_sec / (rows / base_dt), "checked": True,
        **t.report, **extra,
    }


# ---------------------------------------------------------------------------
# The shapes: replay, run, check against numpy.
# ---------------------------------------------------------------------------


def _shape_http_stats(n, window, run: _Run) -> dict:
    """configs[0]: filter + groupby-agg over http_events."""
    rp = _http_replay(n, window)
    eng, warm = _build_engines(run, rp)
    t = _time_query(eng, _script("px/http_stats"), n, run, warm_eng=warm,
                    profile=True)
    lat, status = rp.data["lat"], rp.data["status"]
    svc_codes, path_codes = rp.data["svc"], rp.data["path"]

    # numpy baseline (timed: this is the vs_baseline denominator).
    t0 = time.perf_counter()
    ok = status < 400
    key = svc_codes[ok].astype(np.int64) * 64 + path_codes[ok]
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    mean = np.bincount(inv, weights=lat[ok].astype(np.float64)) / cnt
    mx = np.full(len(uniq), -np.inf)
    np.maximum.at(mx, inv, lat[ok])
    base_dt = time.perf_counter() - t0

    for out in t.outs:
        got = out["output"].to_pydict(decode_strings=False)
        gkey = got["service"].astype(np.int64) * 64 + got["req_path"]
        order = np.argsort(gkey)
        assert np.array_equal(np.sort(uniq), gkey[order]), \
            "http_stats keys mismatch"
        ro = np.argsort(uniq)
        assert np.array_equal(got["n"][order], cnt[ro].astype(got["n"].dtype))
        np.testing.assert_allclose(got["lat_mean"][order], mean[ro],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["lat_max"][order], mx[ro])
    return _result(n, t, base_dt)


def _expect_service_stats(lat, status, svc_codes) -> dict:
    ref = {}
    for s in np.unique(svc_codes):
        m = svc_codes == s
        ref[int(s)] = (
            np.quantile(lat[m], 0.5), np.quantile(lat[m], 0.99),
            float(np.mean(status[m] >= 400)), int(m.sum()),
        )
    return ref


def _check_service_stats(out, ref: dict) -> None:
    got = out["output"].to_pydict(decode_strings=False)
    for s, p50, p99, err, thr in zip(
        got["service"], got["p50"], got["p99"], got["error_rate"],
        got["throughput"],
    ):
        r50, r99, rerr, rthr = ref[int(s)]
        assert abs(p50 - r50) / r50 < 0.15, f"p50 off: {p50} vs {r50}"
        assert abs(p99 - r99) / r99 < 0.15, f"p99 off: {p99} vs {r99}"
        np.testing.assert_allclose(err, rerr, rtol=1e-4)
        assert thr == rthr


def _shape_service_stats(n, window, run: _Run) -> dict:
    """configs[1]: p50/p99 t-digest + error-rate agg per service."""
    rp = _http_replay(n, window)
    eng, warm = _build_engines(run, rp)
    t = _time_query(eng, _script("px/service_stats"), n, run, warm_eng=warm)
    t0 = time.perf_counter()
    ref = _expect_service_stats(rp.data["lat"], rp.data["status"],
                                rp.data["svc"])
    base_dt = time.perf_counter() - t0
    for out in t.outs:
        _check_service_stats(out, ref)
    return _result(n, t, base_dt)


def _shape_dashboard_repeat(n, window, run: _Run) -> dict:
    """The same library scripts repeated over a growing http_events
    replay by one engine: px/service_stats cold (the headline rows/s),
    then answered from the watermark-validated result cache; px/http_stats
    (manifest ``materialize: true``) as a materialized view that, after
    one more window lands, folds only that window and must be
    bit-identical to a rescan. The cold answer is checked like
    service_stats, the view's like http_stats."""
    from .types.batch import HostBatch

    rp = _dashboard_replay(n, window)
    window = rp.window
    src = rp.tables["http_events"]
    total = n + window
    eng, warm_eng = _build_engines(run, rp)
    q_cache = _script("px/service_stats")
    q_view = _script("px/http_stats")

    for e in (warm_eng, eng):
        for q in (q_cache, q_view):
            _settle(e.execute_query(q, materialize=False))
    _fence(run.device)

    # -- cold vs cache-hit (px/service_stats: budgeted, not a view) ----
    repeats = 10
    before = _launch_counts()
    with _flag_override("result_cache_mb", 64):
        t0 = time.perf_counter()
        cold_out = eng.execute_query(q_cache)
        cold_s = time.perf_counter() - t0
        launches = _launch_delta(before)
        dispositions: dict = {}
        hit_times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            hot_out = eng.execute_query(q_cache)
            hit_times.append(time.perf_counter() - t0)
            d = eng.tracer.last().cache or ""
            dispositions[d] = dispositions.get(d, 0) + 1
        assert _host_equal(cold_out, hot_out), "cache hit result drifted"

        # -- view fold vs rescan (px/http_stats: materialize: true) ----
        eng.execute_query(q_view)  # registers the view (full first fold)
        assert eng.tracer.last().cache == "view", "manifest view not served"
        for off in range(n, total, window):
            m = min(window, total - off)
            eng.append_data("http_events", HostBatch(
                relation=src.relation, cols=src.cols(off, m), length=m,
                dicts=src.dicts,
            ))
        t0 = time.perf_counter()
        view_out = eng.execute_query(q_view)  # folds ONLY the new windows
        fold_s = time.perf_counter() - t0
        assert eng.tracer.last().cache == "view"
    eng.views.close()
    t0 = time.perf_counter()
    rescan_out = eng.execute_query(q_view)  # flags off: the plain path
    rescan_s = time.perf_counter() - t0

    lat, status = rp.data["lat"], rp.data["status"]
    svc_codes, path_codes = rp.data["svc"], rp.data["path"]
    # Checked numpy replay: the cold answer as service_stats'.
    _check_service_stats(
        cold_out, _expect_service_stats(lat[:n], status[:n], svc_codes[:n])
    )
    # View result: bit-identical to the rescan AND exact vs numpy.
    assert _host_equal(view_out, rescan_out), "view fold != full rescan"
    ok = status < 400
    key = svc_codes[ok].astype(np.int64) * 64 + path_codes[ok]
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    gv = view_out["output"].to_pydict(decode_strings=False)
    gkey = gv["service"].astype(np.int64) * 64 + gv["req_path"]
    order = np.argsort(gkey)
    assert np.array_equal(np.sort(uniq), gkey[order])
    assert np.array_equal(gv["n"][order], cnt[np.argsort(uniq)].astype(
        gv["n"].dtype))

    hit_p50 = float(np.median(hit_times))
    return {
        "rows": n, "rows_per_sec": n / cold_s, "secs": cold_s,
        "checked": True,
        "launches": launches,
        "latency": _latency_report(run.registry),
        "repeat": {
            "count": repeats,
            "dispositions": dispositions,
            "hit_rate": (
                dispositions.get("hit", 0) + dispositions.get("view", 0)
            ) / repeats,
            "cold_ms": cold_s * 1e3,
            "hit_p50_ms": hit_p50 * 1e3,
            "speedup": cold_s / max(hit_p50, 1e-9),
        },
        "view": {
            "appended_rows": window,
            "fold_ms": fold_s * 1e3,
            "rescan_ms": rescan_s * 1e3,
            "speedup": rescan_s / max(fold_s, 1e-9),
            "bit_identical": True,
        },
    }


def _shape_net_flow_graph(n, window, run: _Run) -> dict:
    """configs[2]: conn_stats self-join + groupby over src/dst pod pairs."""
    rp = _net_flow_replay(n, window)
    eng, warm = _build_engines(run, rp)
    t = _time_query(eng, _script("px/net_flow_graph"), n, run, warm_eng=warm)
    src, dst = rp.data["src"], rp.data["dst"]
    sent, recv, n_pods = rp.data["sent"], rp.data["recv"], rp.data["n_pods"]

    t0 = time.perf_counter()
    # Inner-join semantics: flows whose dst pod never appears as a source
    # are dropped by the query; mirror that (matters at tiny row counts).
    m = np.isin(dst, np.unique(src))
    key = src[m].astype(np.int64) * n_pods + dst[m]
    uniq, inv = np.unique(key, return_inverse=True)
    ref_sent = np.bincount(inv, weights=sent[m].astype(np.float64))
    ref_recv = np.bincount(inv, weights=recv[m].astype(np.float64))
    base_dt = time.perf_counter() - t0

    for out in t.outs:
        got = out["output"].to_pydict(decode_strings=False)
        gkey = got["src_pod"].astype(np.int64) * n_pods + got["src_pod_dst"]
        order = np.argsort(gkey)
        assert np.array_equal(np.sort(uniq), gkey[order]), \
            "net_flow keys mismatch"
        ro = np.argsort(uniq)
        np.testing.assert_allclose(got["bytes_sent"][order], ref_sent[ro],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["bytes_recv"][order], ref_recv[ro],
                                   rtol=1e-6)
    return _result(n, t, base_dt)


def _shape_sql_stats(n, window, run: _Run) -> dict:
    """configs[3]: SQL-normalize (dictionary-side regex UDF) + windowed agg."""
    from .udf.builtins.sql_ops import normalize_sql

    rp = _sql_replay(n, window)
    eng, warm = _build_engines(run, rp)
    t = _time_query(eng, _script("px/sql_stats"), n, run, warm_eng=warm)
    raw, qc, lat, tns = (rp.data[k] for k in ("raw", "qc", "lat", "tns"))

    t0 = time.perf_counter()
    norm_vocab = np.array([normalize_sql(s) for s in raw])
    norms, norm_inv = np.unique(norm_vocab, return_inverse=True)
    nq = norm_inv[qc].astype(np.int64)
    win = tns // 1_000_000_000
    key = nq * 1_000 + win
    uniq, inv = np.unique(key, return_inverse=True)
    ref_n = np.bincount(inv)
    ref_mean = np.bincount(inv, weights=lat.astype(np.float64)) / ref_n
    base_dt = time.perf_counter() - t0

    for out in t.outs:
        got = out["output"].to_pydict()
        g_nq = np.array(
            [np.searchsorted(norms, s) for s in got["query_norm"]],
            dtype=np.int64)
        gkey = g_nq * 1_000 + got["window"] // 1_000_000_000
        order = np.argsort(gkey)
        assert np.array_equal(np.sort(uniq), gkey[order]), \
            "sql_stats keys mismatch"
        ro = np.argsort(uniq)
        assert np.array_equal(got["n"][order],
                              ref_n[ro].astype(got["n"].dtype))
        np.testing.assert_allclose(got["lat_mean"][order], ref_mean[ro],
                                   rtol=1e-5)
    return _result(n, t, base_dt)


def _shape_perf_flamegraph(n, window, run: _Run) -> dict:
    """configs[4]: stack-trace groupby-count (continuous profiler shape)."""
    rp = _flamegraph_replay(n, window)
    eng, warm = _build_engines(run, rp)
    t = _time_query(eng, _script("px/perf_flamegraph"), n, run,
                    warm_eng=warm)
    sc, cnt = rp.data["sc"], rp.data["cnt"]

    t0 = time.perf_counter()
    ref = np.bincount(sc, weights=cnt.astype(np.float64),
                      minlength=rp.data["n_stacks"])
    base_dt = time.perf_counter() - t0

    present = np.nonzero(ref)[0]
    for out in t.outs:
        got = out["output"].to_pydict(decode_strings=False)
        order = np.argsort(got["stack_trace"])
        assert np.array_equal(got["stack_trace"][order], present), \
            "stack keys mismatch"
        np.testing.assert_allclose(got["count"][order], ref[present],
                                   rtol=1e-6)
    return _result(n, t, base_dt)


def _join_report(eng) -> dict:
    """The timed query's join routing (strategy, build-side swap, its
    capacity retries, zone-skipped windows) and ``retries_total``: the
    capacity retries of every query of this shape's engine (warm-ups,
    timed run, A/B arms), read from its tracer's finished traces."""
    retries_total = sum(
        int(t["usage"].get("retries", 0)) for t in eng.tracer.recent()
    )
    d = eng.last_join_decision
    if d is None:
        return {"retries_total": retries_total}
    return {
        "strategy": d.strategy, "swap": bool(d.swap),
        "retries": int(d.retries), "retries_total": retries_total,
        "skipped_windows": int(d.skipped_windows),
    }


_DEVICE_JOIN_QUERY = """
import px
l = px.DataFrame(table='conn_l')
r = px.DataFrame(table='conn_r')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('v', px.count), s=('v', px.sum))
px.display(out)
"""

_JOIN_BOTH_SIDES_QUERY = """
import px
l = px.DataFrame(table='conn_l')
r = px.DataFrame(table='conn_r')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby(['b', 'c']).agg(n=('v', px.count), s=('v', px.sum))
px.display(out)
"""


def _check_join_both_sides(outs, n_keys, lk, lb, rk, rc, rv):
    """groupby(b from the left, c from the right) counts and sums of each
    answer against the numpy replay (per-key histograms contracted over
    the key axis). Returns the baseline seconds."""
    t0 = time.perf_counter()
    nb_, nc_ = 16, 8
    m_l = np.bincount(lk * nb_ + lb, minlength=n_keys * nb_).reshape(
        n_keys, nb_
    ).astype(np.float64)
    cnt_r = np.bincount(rk * nc_ + rc, minlength=n_keys * nc_).reshape(
        n_keys, nc_
    ).astype(np.float64)
    sum_r = np.bincount(rk * nc_ + rc, weights=rv.astype(np.float64),
                        minlength=n_keys * nc_).reshape(n_keys, nc_)
    ref_n = m_l.T @ cnt_r  # [b, c]
    ref_s = m_l.T @ sum_r
    base_dt = time.perf_counter() - t0

    present = np.nonzero(ref_n.reshape(-1))[0]
    for out in outs:
        got = out["output"].to_pydict()
        gkey = got["b"].astype(np.int64) * nc_ + got["c"]
        order = np.argsort(gkey)
        assert np.array_equal(gkey[order], present), "join_both keys mismatch"
        np.testing.assert_allclose(
            got["n"][order], ref_n.reshape(-1)[present], rtol=1e-9
        )
        np.testing.assert_allclose(
            got["s"][order], ref_s.reshape(-1)[present], rtol=1e-9
        )
    return base_dt


def _shape_join_both_sides(rp: Replay, run: _Run) -> dict:
    eng, warm = _build_engines(run, rp)
    rows = sum(s.rows for s in rp.tables.values())
    t = _time_query(eng, _JOIN_BOTH_SIDES_QUERY, rows, run, warm_eng=warm)
    d = rp.data
    base_dt = _check_join_both_sides(t.outs, d["n_keys"], d["lk"], d["lb"],
                                     d["rk"], d["rc"], d["rv"])
    return _result(rows, t, base_dt, join=_join_report(eng))


def _shape_device_join_skew(n, window, run: _Run) -> dict:
    """Skewed-key N:M join: zipf build keys (per-probe fan-out varies by
    orders of magnitude), uniform probe keys, group keys from both
    sides."""
    return _shape_join_both_sides(_join_skew_replay(n, window), run)


def _shape_device_join_select(n, window, run: _Run) -> dict:
    """Selective clustered join: probe keys ascend with time while the
    build side covers only the top eighth of the key space, so zone maps
    prove ~7/8 of probe windows cannot match."""
    return _shape_join_both_sides(_join_select_replay(n, window), run)


def _shape_device_join(n, window, run: _Run) -> dict:
    """A raw N:M self-join before any aggregate, then a small aggregate
    so the output stays bounded."""
    rp = _device_join_replay(n, window)
    eng, warm = _build_engines(run, rp)
    t = _time_query(eng, _DEVICE_JOIN_QUERY, 2 * n, run, warm_eng=warm)
    d = rp.data
    lk, lb, rk, rv, n_keys = d["lk"], d["lb"], d["rk"], d["rv"], d["n_keys"]

    t0 = time.perf_counter()
    cnt_r = np.bincount(rk, minlength=n_keys)
    sum_r = np.bincount(rk, weights=rv.astype(np.float64), minlength=n_keys)
    ref_n = np.bincount(lb, weights=cnt_r[lk].astype(np.float64),
                        minlength=16)
    ref_s = np.bincount(lb, weights=sum_r[lk], minlength=16)
    base_dt = time.perf_counter() - t0

    present = np.nonzero(ref_n)[0]
    for out in t.outs:
        got = out["output"].to_pydict()
        order = np.argsort(got["b"])
        assert np.array_equal(got["b"][order], present), "join keys mismatch"
        np.testing.assert_allclose(got["n"][order], ref_n[present],
                                   rtol=1e-9)
        np.testing.assert_allclose(got["s"][order], ref_s[present],
                                   rtol=1e-9)
    return _result(2 * n, t, base_dt, join=_join_report(eng))


def _shape_cold_scan(n, window, run: _Run) -> dict:
    """Scans over a mostly-cold table: the hot ring holds ~1/8 of the
    replay, the rest was demoted into the encoded cold store at append
    time.

    - selective: ``shard == k`` where shard ascends with time (each
      window holds one shard value), so zone maps prove every other
      window cannot match and the scan skips it before decode. Run on
      the tiered and an all-hot engine, zone skipping on and off (2x2);
      all four arms bit-identical, the tiered skip arm skipping >= 90%
      of windows.
    - full: group-by over every row with residency off (every cold
      window really decodes). The tiered run must stay within 1.5x the
      all-hot one; ``decode_ms`` against ``stall_ms`` says how much of
      the decode the prefetch thread hid.

    The headline rows/s is the full tiered scan, decode included; numpy
    checks both answers exactly."""
    rp = _cold_scan_replay(n, window)
    n, window = rp.n, rp.window
    n_win = n // window
    shard, lat, svc_codes = rp.data["shard"], rp.data["lat"], rp.data["svc"]
    n_services = rp.data["n_services"]
    src = rp.tables["events"]

    row_bytes = 8 + 8 + 8 + 4  # time + shard + latency + svc codes
    hot_budget = max(row_bytes * n // 8, row_bytes * window + 1)
    cold_mb = (row_bytes * n >> 20) + 64  # never evict: bit-identity

    pick = n_win // 3
    q_sel = f"""
import px
df = px.DataFrame(table='events')
df = df[df.shard == {pick}]
out = df.groupby('shard').agg(
    n=('latency_ns', px.count), s=('latency_ns', px.sum))
px.display(out)
"""
    q_full = """
import px
df = px.DataFrame(table='events')
out = df.groupby('service').agg(
    n=('latency_ns', px.count), s=('latency_ns', px.sum))
px.display(out)
"""

    with _flag_override("cold_tier_mb", cold_mb):
        cold_eng = _engine(run, window)
        cold_eng.create_table("events", max_bytes=hot_budget)
        _push_encoded(cold_eng, "events", src, 0, n, window)
    hot_eng = _engine(run, window)
    hot_eng.create_table("events")
    _push_encoded(hot_eng, "events", src, 0, n, window)

    st = cold_eng.tables["events"].stats()
    cold_frac = st.cold_rows / max(st.cold_rows + st.hot_rows, 1)
    assert cold_frac >= 0.75, f"replay not mostly cold ({cold_frac:.2f})"
    compression = st.cold_raw_bytes / max(st.cold_bytes, 1)

    def timed(engines, q, repeats=3, min_total_s=0.0, max_turns=50):
        """[(answer, best seconds, usage, launches of one run)] per
        engine, after a warm-up. The engines take turns, so a burst of
        load on the host falls on all of them; at least ``repeats``
        turns, and more (up to ``max_turns``) until every engine has run
        ``min_total_s`` in all, so a short scan's best is taken over
        enough runs to reach a quiet moment of the host."""
        import gc

        for eng in engines:
            _settle(eng.execute_query(q, materialize=False))  # warm
        _fence(run.device)
        gc.collect()  # no collection of earlier garbage inside a run
        res = [None] * len(engines)
        total = [0.0] * len(engines)
        turns = 0
        while turns < repeats or (
                min(total) < min_total_s and turns < max_turns):
            turns += 1
            for i, eng in enumerate(engines):
                before = _launch_counts()
                t0 = time.perf_counter()
                out = eng.execute_query(q)
                dt = time.perf_counter() - t0
                total[i] += dt
                best = dt if res[i] is None else min(res[i][1], dt)
                res[i] = (out, best, eng.tracer.last().usage,
                          _launch_delta(before))
        return res

    # 2x2 A/B arms for the selective scan: tier x zone skipping.
    arms, outs = {}, {}
    for skip_label, flag in (("skip", True), ("noskip", False)):
        with _flag_override("scan_zone_skip", flag):
            turns = timed((cold_eng, hot_eng), q_sel, repeats=2)
        for tier_label, (out, dt, u, _) in zip(("cold", "hot"), turns):
            outs[f"{tier_label}_{skip_label}"] = out
            arms[f"{tier_label}_{skip_label}"] = {
                "secs": dt,
                "skipped_windows": int(u.skipped_windows),
                "decode_ms": u.decode_ms,
            }
    for k in ("cold_noskip", "hot_skip", "hot_noskip"):
        assert _host_equal(outs["cold_skip"], outs[k]), f"A/B drift: {k}"
    skip_rate = arms["cold_skip"]["skipped_windows"] / n_win
    assert skip_rate >= 0.9, f"skip rate {skip_rate:.2f} < 0.9"

    # Full scan, host-staged: every cold window decodes for real.
    with _flag_override("device_residency", False):
        (full_cold, cold_s, u_cold, launches), (full_hot, hot_s, _, _) = (
            timed((cold_eng, hot_eng), q_full, repeats=3, min_total_s=0.25)
        )
    assert _host_equal(full_cold, full_hot), "tiered full scan drifted"
    assert cold_s <= 1.5 * hot_s, (
        f"cold full scan {cold_s:.3f}s > 1.5x hot {hot_s:.3f}s"
    )
    decode_ms = float(u_cold.decode_ms)
    stall_ms = float(u_cold.stall_ms)

    # numpy replay (bit-exact: int64 counts/sums).
    t0 = time.perf_counter()
    msk = shard == pick
    ref_n, ref_s = int(msk.sum()), int(lat[msk].sum())
    cnt = np.bincount(svc_codes, minlength=n_services)
    sums = np.bincount(svc_codes, weights=lat.astype(np.float64),
                       minlength=n_services)
    base_dt = time.perf_counter() - t0
    g = outs["cold_skip"]["output"].to_pydict()
    assert int(g["shard"][0]) == pick and len(g["shard"]) == 1
    assert int(g["n"][0]) == ref_n and int(g["s"][0]) == ref_s
    gf = full_cold["output"].to_pydict(decode_strings=False)
    order = np.argsort(gf["service"])
    present = np.nonzero(cnt)[0]
    assert np.array_equal(np.sort(gf["service"]), present)
    np.testing.assert_array_equal(gf["n"][order], cnt[present])
    np.testing.assert_allclose(gf["s"][order], sums[present], rtol=1e-12)

    return {
        "rows": n, "rows_per_sec": n / cold_s, "secs": cold_s,
        "checked": True,
        "vs_baseline": (n / cold_s) / (n / base_dt),
        "launches": launches,
        "latency": _latency_report(run.registry),
        "tier": {
            "cold_frac": cold_frac,
            "compression": compression,
            "demotions": int(st.demotions),
            "evictions": int(st.evictions),
        },
        "selective": dict(arms, **{
            "skip_rate": skip_rate,
            "speedup_vs_noskip": (
                arms["cold_noskip"]["secs"]
                / max(arms["cold_skip"]["secs"], 1e-9)
            ),
        }),
        "full": {
            "cold_secs": cold_s,
            "hot_secs": hot_s,
            "cold_vs_hot": cold_s / max(hot_s, 1e-9),
            "decode_ms": decode_ms,
            "stall_ms": stall_ms,
            # Fraction of decode wall the prefetch thread hid behind
            # compute (decode runs on the producer thread).
            "decode_hidden_frac": (
                max(0.0, 1.0 - stall_ms / decode_ms)
                if decode_ms > 0 else 1.0
            ),
        },
    }


def run_shape(name: str, n: int, window: int = DEFAULT_WINDOW, device=None,
              ab: bool | None = None) -> dict:
    """Run one shape in this process at ``n`` head rows (the shape's
    divisor applies) and return its result; a failed check raises.
    ``device`` defaults to ``cuda``; ``ab`` (default: the
    ``PIXIE_TPU_BENCH_AB`` knob) runs the serial-vs-pipelined pass."""
    from .exec.engine import resolve_device
    from .services.observability import MetricsRegistry

    if name not in SHAPE_DEFS:
        raise ValueError(f"unknown shape {name!r}")
    fn_name, rows_div = SHAPE_DEFS[name]
    run = _Run(
        device=resolve_device(device),
        ab=_ab_enabled() if ab is None else bool(ab),
        registry=MetricsRegistry(),
    )
    # Tables stage their windows at append time at the window size the
    # queries read.
    with _flag_override("window_rows", window):
        return globals()[fn_name](n // rows_div, window, run)


# ---------------------------------------------------------------------------
# Launcher: one subprocess per shape.
# ---------------------------------------------------------------------------


def inner() -> int:
    """One shape (``PIXIE_TPU_BENCH_SHAPES``) in this process: print its
    ``{"shape", "device", "result"}`` line; 1 when its check failed."""
    from .exec.engine import resolve_device

    shape = os.environ.get("PIXIE_TPU_BENCH_SHAPES", "http_stats").strip()
    if shape not in SHAPE_DEFS:
        log(f"[bench] unknown shape {shape!r}")
        return 1
    device = resolve_device(_env_device())
    default_rows = CUDA_ROWS if device.type == "cuda" else CPU_ROWS
    n = int(os.environ.get("PIXIE_TPU_BENCH_ROWS", default_rows))
    window = int(os.environ.get("PIXIE_TPU_BENCH_WINDOW", DEFAULT_WINDOW))
    log(f"[bench] {shape} @ {n // SHAPE_DEFS[shape][1]:,} rows on {device}")
    rc = 0
    try:
        res = run_shape(shape, n, window, device)
        log(f"[bench] {shape}: {json.dumps(res, default=str)}")
    except Exception as e:  # noqa: BLE001 — the shape's failure is its result
        import traceback

        traceback.print_exc()
        log(f"[bench] {shape} FAILED: {e!r}")
        res = {"error": repr(e)[:400]}
        rc = 1
    print(json.dumps({"shape": shape, "device": device.type,
                      "result": res}, default=str), flush=True)
    return rc


def _run_shape_proc(shape: str, device: str, timeout_s: float):
    """Run one shape in a subprocess; return its parsed result dict (None
    when it timed out or printed none)."""
    env = dict(os.environ)
    env.update({"PIXIE_TPU_BENCH_INNER": "1",
                "PIXIE_TPU_BENCH_SHAPES": shape, DEVICE_ENV: device})
    log(f"[bench] {shape} ({device}, timeout {timeout_s:.0f}s)")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pixie_tpu_torch.bench"],
            env=env, stdout=subprocess.PIPE, stderr=None, text=True,
            timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        log(f"[bench] {shape} timed out after {timeout_s:.0f}s")
        return None
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if parsed.get("shape") == shape:
                return parsed["result"]
    log(f"[bench] {shape} rc={proc.returncode}, no JSON line")
    return None


def launcher(device_name: str) -> int:
    from .exec.engine import resolve_device

    try:
        device = resolve_device(device_name)
    except RuntimeError as e:
        log(f"[bench] {e}")
        return 2
    budget = float(os.environ.get("PIXIE_TPU_BENCH_BUDGET", DEFAULT_BUDGET_S))
    t0 = time.monotonic()
    want = [
        s.strip()
        for s in os.environ.get(
            "PIXIE_TPU_BENCH_SHAPES", ",".join(ALL_SHAPES)
        ).split(",")
        if s.strip()
    ]
    unknown = [s for s in want if s not in SHAPE_DEFS]
    if unknown:
        log(f"[bench] unknown shapes {unknown}")
        return 2
    card = card_line() if device.type == "cuda" else None
    shapes: dict = {}
    for i, shape in enumerate(want):
        # Leave each shape after this one at least MIN_SHAPE_S.
        left = budget - (time.monotonic() - t0)
        timeout = left - MIN_SHAPE_S * (len(want) - i - 1)
        if timeout < MIN_SHAPE_S:
            shapes[shape] = {"skipped": "deadline"}
            continue
        res = _run_shape_proc(shape, device.type, timeout)
        shapes[shape] = (
            res if res is not None
            else {"error": "subprocess failed or timed out"}
        )
    head_shape = want[0] if want else "http_stats"
    head = shapes.get(head_shape) or {}
    print(json.dumps({
        "metric": f"{head_shape}_rows_per_sec",
        "value": head.get("rows_per_sec", 0),
        "unit": "rows/s",
        "vs_baseline": head.get("vs_baseline", 0.0),
        "baseline": BASELINE,
        "device": device.type,
        "card": card,
        "shapes": shapes,
    }, default=str), flush=True)
    failed = [s for s, r in shapes.items() if r.get("checked") is not True]
    if failed:
        log(f"[bench] shapes without a checked result: {failed}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pixie_tpu_torch.bench",
        description="bench.py's ten query shapes on the port "
                    "(rows/s, checked against numpy)",
    )
    ap.add_argument("--device", default=None,
                    help=f"cuda (default) or cpu; also ${DEVICE_ENV}")
    args = ap.parse_args(argv)
    if args.device is not None:
        os.environ[DEVICE_ENV] = args.device
    if os.environ.get("PIXIE_TPU_BENCH_INNER"):
        return inner()
    return launcher(_env_device())


if __name__ == "__main__":
    sys.exit(main())
