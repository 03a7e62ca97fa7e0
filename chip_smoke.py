#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pixie_tpu_torch``) on one card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA card and ``nvcc``, and fails (exit code other than 0)
without them. In order it:

1. prints the card's name and power limit and builds both CUDA kernels
   from ``pixie_tpu_torch/csrc/`` (one ``nvcc`` per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (2^21-row windows; 297 dense slots padded to
   384, with and without the min, plus non-finite values; 33 groups x
   8192 histogram bins) and times kernel, plain version and a PyTorch
   library yardstick with CUDA events (and the kernels' device time
   from a torch.profiler trace);
3. runs px/http_stats, its FLOAT64 variant and px/service_stats through
   ``Engine.execute_query`` over a 16M-row http_events replay (bench.py's
   recipe, seed 7) in 2^21-row windows, checks each result against numpy
   with bench.py's assertions, and reads the kernels' launch counters;
4. prints one ``{"kernels": [...]}`` line and, last, the device line.

Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS = 1 << 24  # bench.py's TPU default replay size
WINDOW = 1 << 21
SEED = 7
N_SERVICES, N_PATHS = 32, 8

# H100 SXM peaks (NVIDIA's data sheet): device memory rate and float32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

HTTP_STATS_F64 = """import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status < 400]
df.latency_ms = df.latency_ns / 1000000.0
df = df.groupby(['service', 'req_path']).agg(
    n=('latency_ms', px.count), lat_mean=('latency_ms', px.mean),
    lat_max=('latency_ms', px.max))
px.display(df)
"""


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def make_replay(n: int, seed: int = SEED):
    """bench.py's http_events replay (``_http_replay``): 32 services,
    8 paths, statuses [200,200,200,200,404,500], latency in [1e3, 1e8)."""
    rng = np.random.default_rng(seed)
    statuses = np.array([200, 200, 200, 200, 404, 500])
    svc = rng.integers(0, N_SERVICES, n).astype(np.int32)
    path = rng.integers(0, N_PATHS, n).astype(np.int32)
    lat = rng.integers(1_000, 100_000_000, n)
    status = statuses[rng.integers(0, len(statuses), n)].astype(np.int64)
    return svc, path, lat, status


def load_engine(replay, window: int, device):
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    svc, path, lat, status = replay
    rel = Relation([
        ("time_", DataType.TIME64NS),
        ("latency_ns", DataType.INT64),
        ("resp_status", DataType.INT64),
        ("service", DataType.STRING),
        ("req_path", DataType.STRING),
    ])
    dicts = {
        "service": StringDictionary([f"svc-{i}" for i in range(N_SERVICES)]),
        "req_path": StringDictionary([f"/api/v1/ep{i}" for i in range(N_PATHS)]),
    }
    eng = Engine(window_rows=window, device=device)
    eng.create_table("http_events")
    n = len(svc)
    for off in range(0, n, window):
        s = slice(off, min(off + window, n))
        m = s.stop - s.start
        eng.append_data("http_events", HostBatch(relation=rel, cols={
            "time_": (np.arange(off, off + m, dtype=np.int64),),
            "latency_ns": (lat[s],),
            "resp_status": (status[s],),
            "service": (svc[s],),
            "req_path": (path[s],),
        }, length=m, dicts=dicts))
    return eng


# -- result checks (bench.py:547-551 and :580-583) ----------------------------
def check_http_stats(out, replay, float64: bool) -> None:
    svc, path, lat, status = replay
    ok = status < 400
    key = svc[ok].astype(np.int64) * 64 + path[ok]
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    if float64:
        vals = lat[ok].astype(np.float32) / np.float32(1e6)
        mx = np.full(len(uniq), -np.inf, dtype=np.float32)
    else:
        vals = lat[ok]
        mx = np.full(len(uniq), np.iinfo(np.int64).min, dtype=np.int64)
    mean = np.bincount(inv, weights=vals.astype(np.float64)) / cnt
    np.maximum.at(mx, inv, vals)
    got = out.to_pydict(decode_strings=False)
    gkey = got["service"].astype(np.int64) * 64 + got["req_path"]
    order = np.argsort(gkey)
    assert np.array_equal(uniq, gkey[order]), "http_stats keys mismatch"
    assert np.array_equal(got["n"][order], cnt), "http_stats counts mismatch"
    np.testing.assert_allclose(got["lat_mean"][order], mean, rtol=1e-5)
    np.testing.assert_array_equal(got["lat_max"][order], mx)


def check_service_stats(out, replay) -> None:
    svc, _path, lat, status = replay
    got = out.to_pydict(decode_strings=False)
    assert len(got["service"]) == N_SERVICES, "service_stats group count"
    for s, p50, p99, err, thr in zip(
        got["service"], got["p50"], got["p99"], got["error_rate"],
        got["throughput"],
    ):
        m = svc == s
        r50, r99 = np.quantile(lat[m], [0.5, 0.99])
        assert abs(p50 - r50) / r50 < 0.15, f"p50 off: {p50} vs {r50}"
        assert abs(p99 - r99) / r99 < 0.15, f"p99 off: {p99} vs {r99}"
        np.testing.assert_allclose(err, np.mean(status[m] >= 400), rtol=1e-4)
        assert thr == int(m.sum()), f"throughput {thr} vs {int(m.sum())}"


# -- kernel checks ------------------------------------------------------------
def event_ms(fn, inputs, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events around the run.
    ``inputs`` rotates through copies that together exceed the 50 MB L2,
    so each call reads its inputs from device memory as the engine's
    fold does."""
    import torch

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, inputs, names=None, iters: int = 10):
    """Device time per call of the CUDA kernels whose names contain one
    of ``names`` (all of the call's device work when None), read from a
    torch.profiler (CUPTI) trace; None when the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if names is None or any(n in evt.key for n in names):
            total_us += getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0))
    return total_us / iters / 1e3 if total_us > 0 else None


def _rotating(tensors, copies: int = 4):
    return [tuple(t.clone() for t in tensors) for _ in range(copies)]


def _max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def _same(a, b, rtol: float, what: str) -> None:
    import torch

    torch.testing.assert_close(a, b, rtol=rtol, atol=0.0, equal_nan=True,
                               msg=lambda m: f"{what}: {m}")


def dense_fold_inputs(replay, device, nonfinite: bool):
    """One window of the FLOAT64 http_stats fold: slot = service x 9 +
    path (297 slots; g padded to 384, trash rows at 384), values =
    latency_ns / 1e6 in f32."""
    import torch

    svc, path, lat, status = (x[:WINDOW] for x in replay)
    g, g_pad = (N_SERVICES + 1) * (N_PATHS + 1), 384
    slots = np.where(status < 400, svc * (N_PATHS + 1) + path, g_pad)
    vals = lat.astype(np.float32) / np.float32(1e6)
    if nonfinite:
        vals = vals.copy()
        vals[slots == 0] = np.nan
        vals[np.flatnonzero(slots == 1)[:3]] = [np.inf, -np.inf, 1.0]
        vals[np.flatnonzero(slots == 2)[:1]] = np.inf
        vals[np.flatnonzero(slots == 3)[:1]] = -np.inf
    assert g <= g_pad
    return (torch.from_numpy(slots.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device), g_pad)


def check_dense_fold(replay, device) -> dict:
    import torch
    from pixie_tpu_torch.ops.dense_fold import dense_fold, dense_fold_reference

    cases, err = [], 0.0
    timing = None
    for nonfinite in (False, True):
        slots, vals, g = dense_fold_inputs(replay, device, nonfinite)
        for want_min in (False, True):
            got = dense_fold(slots, vals, g, want_min)
            ref = dense_fold_reference(slots, vals, g, want_min)
            torch.cuda.synchronize()
            name = f"nonfinite={nonfinite},want_min={want_min}"
            _same(got[0], ref[0], 0.0, f"dense_fold count [{name}]")
            _same(got[1], ref[1], 1e-5, f"dense_fold sum [{name}]")
            _same(got[2], ref[2], 0.0, f"dense_fold max [{name}]")
            if want_min:
                _same(got[3], ref[3], 0.0, f"dense_fold min [{name}]")
            err = max(err, *(_max_abs_err(a, b) for a, b in zip(got, ref)
                             if a is not None))
            cases.append(name)
        if not nonfinite:
            timing = (slots, vals, g)
    slots, vals, g = timing
    n = slots.numel()
    inputs = _rotating((slots, vals))
    idx = [(s.long(), v) for s, v in inputs]

    def library(i, v):
        # index_add_ for count and sum, scatter_reduce_ for max: the
        # PyTorch calls that compute the fold's outputs (no NaN restore).
        z = torch.zeros(g + 1, dtype=torch.float32, device=v.device)
        z.clone().index_add_(0, i, torch.ones_like(v))
        z.clone().index_add_(0, i, v)
        torch.full((g + 1,), -torch.inf, device=v.device).scatter_reduce_(
            0, i, v, "amax", include_self=True)

    bytes_moved = n * 8 + 4 * g * 4
    return {
        "name": "dense_fold",
        "route": "cuda",
        "source": "pixie_tpu_torch/csrc/dense_fold.cu",
        "replaces": "pixie_tpu/ops/pallas_groupby.py:93",
        "shape": {"rows": n, "slots": g, "want_min": False},
        "checked": cases,
        "max_abs_err": err,
        "ms": event_ms(lambda s, v: dense_fold(s, v, g), inputs),
        "plain_ms": event_ms(lambda s, v: dense_fold_reference(s, v, g), inputs),
        "library_ms": event_ms(library, idx),
        "device_ms": profiled_device_ms(
            lambda s, v: dense_fold(s, v, g), inputs,
            ("init_workspace", "fold_rows", "decode_workspace")),
        "plain_device_ms": profiled_device_ms(
            lambda s, v: dense_fold_reference(s, v, g), inputs),
        **_bound(bytes_moved, n * 4),
    }


def hist_fold_inputs(replay, device, num_groups: int):
    """One window of service_stats' t-digest fold, made as
    ``ops/tdigest.batch_to_digest`` makes it: flat id = group x B + bin,
    every 97th row trash (id = the slot count)."""
    import torch
    from pixie_tpu_torch.ops.tdigest import _hist_bins

    svc, _path, lat, _status = (x[:WINDOW] for x in replay)
    b = _hist_bins(num_groups)
    vals = lat.astype(np.float32)
    bits = vals.view(np.uint32).astype(np.int64)
    bins = (bits | 0x80000000) >> (32 - b.bit_length() + 1)
    n_slots = num_groups * b
    ids = (svc % num_groups).astype(np.int64) * b + bins
    ids[::97] = n_slots
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device), n_slots)


def check_hist_fold(replay, device) -> dict:
    import torch
    from pixie_tpu_torch.ops.hist_fold import hist_fold, hist_fold_reference

    cases, err = [], 0.0
    # 33 groups (service_stats, global atomics); 3 groups (24,576 slots,
    # the shared-memory path).
    for num_groups in (3, N_SERVICES + 1):
        ids, vals, n_slots = hist_fold_inputs(replay, device, num_groups)
        w, mw = hist_fold(ids, vals, n_slots)
        rw, rmw = hist_fold_reference(ids, vals, n_slots)
        torch.cuda.synchronize()
        _same(w, rw, 0.0, f"hist_fold weights [G={num_groups}]")
        _same(mw, rmw, 1e-5, f"hist_fold sums [G={num_groups}]")
        err = max(err, _max_abs_err(w, rw), _max_abs_err(mw, rmw))
        cases.append(f"groups={num_groups},slots={n_slots}")
    n = ids.numel()
    inputs = _rotating((ids, vals))
    lib_inputs = [(i.long(), v) for i, v in inputs]

    def library(i, v):
        # bincount for weights and weighted sums (the trash id is n_slots).
        torch.bincount(i, minlength=n_slots + 1)
        torch.bincount(i, weights=v, minlength=n_slots + 1)

    return {
        "name": "hist_fold",
        "route": "cuda",
        "source": "pixie_tpu_torch/csrc/hist_fold.cu",
        "replaces": "pixie_tpu/ops/pallas_tdigest.py:64",
        "shape": {"rows": n, "slots": n_slots},
        "checked": cases,
        "max_abs_err": err,
        "ms": event_ms(lambda i, v: hist_fold(i, v, n_slots), inputs),
        "plain_ms": event_ms(
            lambda i, v: hist_fold_reference(i, v, n_slots), inputs),
        "library_ms": event_ms(library, lib_inputs),
        "device_ms": profiled_device_ms(
            lambda i, v: hist_fold(i, v, n_slots), inputs,
            ("fold_global", "fold_shared")),
        "plain_device_ms": profiled_device_ms(
            lambda i, v: hist_fold_reference(i, v, n_slots), inputs),
        **_bound(n * 8 + n_slots * 8, n * 2),
    }


def _bound(bytes_moved: int, ops: int) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return {
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
    }


# -- the main path --------------------------------------------------------------
def run_scripts(eng, replay, rows: int) -> dict:
    """Each script: one warm-up run, then the launch counters set to 0,
    one measured run, the counters read, the result checked."""
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold
    from pixie_tpu_torch.scripts import load_script

    scripts = [
        ("px/http_stats", load_script("px/http_stats"),
         lambda o: check_http_stats(o, replay, float64=False)),
        ("http_stats_float64", HTTP_STATS_F64,
         lambda o: check_http_stats(o, replay, float64=True)),
        ("px/service_stats", load_script("px/service_stats"),
         lambda o: check_service_stats(o, replay)),
    ]
    launches = {}
    for name, query, check in scripts:
        eng.execute_query(query)  # ends in a device -> host read
        dense_fold.launches = 0
        hist_fold.launches = 0
        t0 = time.perf_counter()
        out = eng.execute_query(query)["output"]
        secs = time.perf_counter() - t0
        counts = {"dense_fold": dense_fold.launches,
                  "hist_fold": hist_fold.launches}
        st = eng.last_stats
        check(out)
        launches[name] = (counts, st.windows)
        print(json.dumps({
            "script": name, "rows": st.rows, "windows": st.windows,
            "secs": secs, "rows_per_s": rows / secs, "read_s": st.read_s,
            "stage_s": st.stage_s, "fold_s": st.fold_s,
            "finalize_s": st.finalize_s, "launches": counts, "checked": True,
        }))
    counts, windows = launches["http_stats_float64"]
    assert counts["dense_fold"] >= windows, (
        f"dense_fold ran {counts['dense_fold']} times over {windows} windows")
    counts, windows = launches["px/service_stats"]
    assert counts["hist_fold"] >= 2 * windows, (
        f"hist_fold ran {counts['hist_fold']} times over {windows} windows")
    return {
        "dense_fold": launches["http_stats_float64"][0]["dense_fold"],
        "hist_fold": launches["px/service_stats"][0]["hist_fold"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pixie_tpu_torch.ops import cuda_lib

    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(device)}")

    t0 = time.perf_counter()
    built = cuda_lib.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          + ", ".join(f"{k} {v[0]:.2f} s" for k, v in built.items()))
    for name, (_secs, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    replay = make_replay(ROWS)
    eng = load_engine(replay, WINDOW, device)
    print(f"replay: {ROWS} rows appended in {time.perf_counter() - t0:.2f} s")

    kernels = [check_dense_fold(replay, device), check_hist_fold(replay, device)]
    for k in kernels:
        print(f"kernel {k['name']}: ms {k['ms']:.4f} (device "
              f"{k['device_ms']}) plain_ms {k['plain_ms']:.4f} (device "
              f"{k['plain_device_ms']}) library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.4f} max_abs_err {k['max_abs_err']}")

    launches = run_scripts(eng, replay, ROWS)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    print(card)  # nvidia-smi's "name, power.limit" line, as it gave it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
