#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pixie_tpu_torch``) on one card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --kernels`` stops after step 1 and the kernel
checks of step 3, under a minute on an H100.) It needs a CUDA card and
``nvcc``, and fails (exit code other than 0) without them. In order it:

1. prints the card's name and power limit, builds the three CUDA kernels
   from ``pixie_tpu_torch/csrc/`` (one ``nvcc`` per source, in parallel)
   and prints their registers;
2. appends a 16M-row http_events replay (bench.py's recipe, seed 7) in
   2^21-row batches through ``Engine.append_data``, which stages each
   completed window onto the card (512 MiB at 32 bytes a row), and
   checks every resident window against the replay;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (2^21-row windows; 297 dense slots padded to
   384, with and without the min, plus non-finite values; 33 groups x
   8192 histogram bins; int_fold exactly, over 15 live slots of 160 and
   sums that wrap), at the edges of their designs (a ragged n,
   misaligned views, calls back to back, g = 2048, an all-trash window)
   and on each histogram route (3, 33 and 64 groups; 32768 groups x
   1024 bins for the group_by phase), and times kernel,
   plain version and a PyTorch library yardstick with CUDA events, and
   all device work of one call from a torch.profiler trace, and
   profiles one t-digest window update (``batch_to_digest``) by kernel;
4. the main path, the steady state: px/http_stats, its FLOAT64 variant
   and px/service_stats through ``Engine.execute_query`` over the
   resident windows (all 8 resident, none staged), each checked against
   numpy with bench.py's assertions, with the kernels' launch counters
   set to 0 before each measured query and read after it (int_fold once
   a window of px/http_stats);
5. the window path's phases, each answer checked against numpy: an
   attribution run (read, stage, fold and finalize seconds); residency
   off at pipeline depth 1 and 2 (the staging the prefetch thread
   hides); the row chains px/http_errors and px/http_data in row order;
   a tail of 2^20 + 3 appended rows (only the tail window is staged by
   the next query); the group-by without a dense key domain (below); a
   256 MiB device_cache_bytes budget (resident bytes and the allocator's
   growth stay inside it); and 2^27 rows, 4 GiB resident, under one
   px/http_stats query;
6. the cluster phase (agent mode, before the tail is appended): one
   in-process MessageBus, an AgentTracker, 4 PEMAgents and a KelvinAgent,
   each with its own Engine on the card, and a QueryBroker. The replay
   is dealt to the PEMs as contiguous quarters of 2^22 rows (2 resident
   windows each, every PEM's dictionaries in an order of its own, 512
   MiB in all). px/http_stats, http_stats_float64 (dense_fold on every
   PEM), px/service_stats (hist_fold on every PEM), px/http_errors (a
   row-gather bridge) and px/agent_status (5 agents, each heard from
   within 3 heartbeat intervals) run through
   ``broker.execute_script``: a warm-up, three timed turns and one
   under torch.profiler, each answer held to the steady-state engine's
   over the same rows (keys, strings and integers exact, FLOAT64 rtol
   1e-5, t-digest quantiles rtol 0.05), with the seconds per query and
   their split (compile and plan, dispatch, the slowest PEM fragment,
   the Kelvin's merge), the bridge bytes and each kernel's launches per
   PEM (counted by the bus thread that runs the PEM's fragments). Then
   one PEM dies and is expired: px/service_stats replans onto 3 PEMs and
   equals numpy over their quarters; a live px/service_stats over the 3
   (``execute_script_streaming``), one more window appended on each,
   ends at the one-shot answer. Then ``mesh``: a ``DistributedEngine``
   over 4 virtual PEMs on the card (``agent_mesh(4, devices=[card] *
   4)``) loads the same replay in 2^21-row resident windows, and
   px/http_stats, http_stats_float64 and px/service_stats (a warm-up,
   three timed turns, one under torch.profiler) each equal numpy and the
   single engine, every window resident and each kernel launched once
   per shard per window (dense_fold 32, hist_fold 64 per query); then a
   2 x 2 (kelvin x agents) mesh on px/service_stats, and a degraded
   mesh of 3 live PEMs of 4 on http_stats_float64 (8 windows staged, 24
   dense_fold launches, equal to numpy). Then the same cluster across processes
   (``processes``): the broker (bus, BusServer, tracker, QueryBroker) in
   this process, 4 PEM workers (this script run with ``--pem-worker``,
   each regenerating the replay from SEED and appending its own quarter
   in its own dictionary order) and one ``python -m
   pixie_tpu_torch.deploy kelvin``, each with its own engine on the
   card, on the framed-TCP netbus: the 5 scripts in 3 turns after a
   warm-up, each answer held to the single engine's, beside the
   in-process cluster's seconds, the slowest PEM fragment, the Kelvin's
   merge (its ``/debug/queryz``), the bridge bytes, the BusServer's
   frames and bytes, the netbus's round trip with and without Nagle's
   algorithm, each process's largest query peak on the card and the
   bytes its allocator holds, and each PEM process's
   launches of both kernels (> 0 on http_stats_float64 and
   px/service_stats); then one PEM process is killed (SIGKILL), and once
   the tracker has expired it px/service_stats replans onto 3 PEMs and
   equals numpy over their quarters. Then ``failover``: the same layout
   (4 PEMs holding the quarters, a Kelvin, each engine on the card)
   under 2 ``BrokerReplica``s on one bus with the soak's lease clock
   (0.1 s, expiry 0.5 s, reconcile 0.4 s), every engine, bus and
   replica built under the port's lockdep; px/service_stats and
   px/http_stats through ``chaos.failover_executor``, a warm-up and
   three turns, each held to the single engine's answer, with 4
   hist_fold launches per PEM per px/service_stats; 8 queries in flight
   (half of each script) and the leader killed at the first bridge
   message (a ``FaultInjector.on_match`` trigger): the standby leads
   within the lease expiry plus two intervals, every in-flight query
   resolves complete and equal or ``partial`` with ``broker_failover``
   (the outcome counts and the epoch-fenced dispatches printed), the new
   leader's next answer of each script is complete and equal; one more
   turn under duplicated execute dispatches and dropped acks, equal; no
   lockdep violation, and after teardown the threads and the card's
   allocated bytes (within one window, 2^21 x 32 bytes) back; the
   seconds per query with lockdep on beside the cluster phase's with
   it off. Then the chaos soak (``run_chaos_soak``, 16 agents on the
   card, 2 brokers, seed 0): ``ok``, 0 lost, 0 leaked threads, 1 leader
   kill. Then ``deploy``: ``python -m pixie_tpu_torch.deploy broker``
   (as an HA replica, ``PIXIE_TPU_BROKER_HA=1``, under
   ``PIXIE_TPU_LOCKDEP=1``), two ``pem`` roles with the seq-gen
   source and a ``kelvin``, each a process on the card; ``python -m
   pixie_tpu_torch.cli run --broker`` answers the sequences group-by,
   its counts over a fixed set of rows summing to the count of the same
   rows without it; ``cli agents`` lists the 3 agents; ``api.Client``
   returns the CLI's table through a record handler; the broker's
   ``/healthz`` and ``/metrics`` answer 200 and its ``/statusz`` carries
   the ``ha`` block (leader, epoch at least 1); every role and client
   shares one bus secret, and the native client (``native/pxclient.cc``,
   built with g++ beside the kernels) prints the CLI's table for the
   bounded group-by, lists the scripts, prints two live updates with
   ``--stream --updates 2`` and is refused with a wrong secret. Every
   child's output goes to a file, every wait is bounded, every child is
   stopped at the end, and a child that dies or prints a traceback fails
   the phase. Then ``operator``: ``services.operator.Reconciler`` in
   this process keeps a broker, two seq-gen PEMs and a Kelvin running
   as role processes on the card while queries run back to back over
   the netbus for 30 s (tests/test_soak.py's 90 s, cut); one PEM is
   SIGKILLed, the operator restarts it within its backoff, and every
   query after it re-registers answers over both PEMs; at the end no
   child is left and the card's used bytes are back at the base. Then
   ``tracepoints``: the cluster layout (4 PEMs and a Kelvin on the card)
   with a ``TracepointRegistry`` on the broker; one pxtrace script
   through ``broker.execute_script`` upserts ``app_tp`` on each PEM's
   ``app.handle``, 2^18 seeded calls per PEM (drained every 2^15 calls,
   none dropped) fill ``app_calls``, and one script's FLOAT64 count,
   mean and max of ``size_kb`` by service (``dense_fold``) and quantiles
   of ``latency_ns`` by service (``hist_fold``) are held to numpy; then
   a script that mutates and queries, a redeploy (one row per call), an
   unknown symbol (refused), ``DeleteTracepoint`` (the handlers
   restored) and ``native_probe_plan`` over a ``g++ -g`` fixture. Then
   ``capture``: 32 capture taps on one collector, 2^19 HTTP/1 exchanges
   and 2^16 of each of the ten other protocols, parsed with no error
   into an engine on the card, and twelve scripts (px/http_stats,
   px/service_stats, http_stats_float64 and the nine protocols' stats
   scripts) held to the CPU engine over the same rows, px/http_stats
   also to numpy over the exchanges;
7. the group_by phase: which uint64 ops the card's PyTorch has; a
   2^23-row process_stats replay (20,000 upids in 2,000 pods, UINT128
   keys, 0.9 GB resident); a filtered row chain that carries the upid
   to the host; then px/upids, px/pods, px/pid_memory_usage and rss
   p50/p99 by upid, each checked against numpy, in three turns per
   groupby_impl form (sort, hash), with the rebuckets, the host syncs
   per window (by the line that made them), the hist_fold launches and
   the card's idle share of each; then the metadata phase over the same
   resident rows: a MetadataState (the 2,000 pods in 200 services and
   20 namespaces on 50 nodes, 1% of the upids unknown) attached with
   ``Engine.set_metadata_state``, and ``df.ctx['service']``, ``['pod']``
   and ``['namespace']`` group-bys, each checked against numpy over the
   same mapping, timed in three turns with the card's idle share;
8. the joins phase, each answer checked against numpy with bench.py's
   assertions: px/http_request_stats over the resident main replay
   (after the tail phase), px/service_resource_usage over the group_by
   phase's process_stats and a small http_events table of its pods,
   px/net_flow_graph over 2^23 conn_stats rows (bench.py's recipe, seed
   11, 48 pods), bench.py's three join shapes at 2^22 rows a side
   (device_join: the fused lookup join; device_join_skew: radix;
   device_join_select: zone-skipped probe windows) and the skew shape
   forced to single and sorted; each query prints its JoinDecision,
   three timed turns after a warm-up (one when forced), the host syncs
   per probe window and the card's idle share (not for the forced turns,
   for the time limit);
9. the library phase: ``init_schemas`` on a fresh engine with the
   default budgets, every Stirling table filled to its 32 MiB budget
   (http_events cut to 2^21 rows, the telemetry tables 4096 rows) from
   a seeded generator with the vocabularies of the JAX package's script
   harness, and each of the 80 shipped scripts but px/agent_status (it
   runs in the cluster phase) run on the card (a warm-up, three timed turns, one under torch.profiler)
   and checked against the port's CPU engine over the same rows, with
   each kernel's launches per script;
10. the analysis phase (the plan verifier and the bounds pass that every
   compile runs): a 2^23-row table of 20,000 INT64 keys in [0, 2^40)
   (no dense domain) in 2^21-row resident windows with ingest sketches
   on, grouped with ``bounds_presize`` on (32768 groups at once) and off
   (the 4096-group ladder), both answers equal to numpy's, with the
   rebuckets, windows folded and seconds per query; the table joined to
   its own group-by (the plan's join capacity beside the join's
   decision and retries); and, in the library phase, two bad scripts
   refused before anything reaches the card, every script verified
   clean with its compile timed cold and warm, and each query's folded
   rows, groups and allocation peak held against its report;
11. the serving phase (after the window path; ingest sketches off),
   each answer held to a fresh untiered engine with no cache over the
   same rows (keys, counts and integers exact, FLOAT64 rtol 1e-5,
   t-digest quantiles rtol 0.05): ``ring`` (the replay appended on the
   native ring and on the numpy ring); ``tier`` (the replay under a
   256 MiB hot budget and a 512 MiB cold tier: half the rows demoted,
   none expired; px/http_stats and px/service_stats resident and with
   residency off, when cold windows decode on the prefetch thread);
   ``result_cache`` (a miss, then a hit with no kernel launch, then one
   more window: http_stats_float64 stale, px/service_stats against its
   manifest's 5000 ms budget); ``views`` (the third run after one more
   window folds that window alone) and ``streaming`` (px/service_stats
   and a filtered row chain, eight rounds of one window and a poll, each
   poll folding exactly the new window); at the end every table of the
   run is checked to be on the native ring but the ring check's one;
12. the device_result phase (on the resident main replay, after the
   row chains): px/http_stats and px/service_stats with
   ``execute_query(materialize=False)``, each ``DeviceResult.to_host()``
   held to the materialized answer (px/http_stats bit-identical,
   px/service_stats within the serving checks' tolerances) and to numpy,
   with the device-to-host copies made before ``execute_query`` returns
   and inside ``to_host()`` (torch.profiler); a result kept on the card
   left out of the next query's peak; and one rebucket forced inside
   ``to_host()`` (px/http_stats' AggOp cut to 64 groups, dense key
   domains off, through ``execute_plan(materialize=False)``); then the
   otel phase on the same windows: px/service_stats with ``px.export``
   of a per-service OTel Summary (count, p50, p99) and Gauge (error
   rate), with the hist_fold launches counted, the payload held to the
   answer and to numpy; the same through an ``OTLPHttpExporter`` to a
   loopback receiver (what it got equals the payload); a span per row of
   a filtered row chain, held to numpy; and ``trace_export_url`` set to
   the receiver (the trace arrives with a span per window; with the
   receiver stopped the query answers and the failed push is counted).
   The cluster phase runs the export through its broker too: the sink
   runs on the Kelvin and no PEM holds an export. Between the two, the
   concurrency phase on the same engine and windows: the three scripts
   solo (answers, seconds, each kernel's launches by the query's thread),
   then 2 and 4 threads each running them mixed for 3 turns (timed under
   torch.profiler): every answer against the solo one, every query's launches against the solo
   query's, ``max_inflight`` equal to the threads, every trace over all
   16,777,216 rows and none left in flight; one of two concurrent
   px/service_stats queries cancelled; a 2-thread turn with residency
   off (every window through the one stager); 2^17-row appends racing 10
   count queries on an engine of their own (counts never fall); and the
   load tester's sweep at 1, 2 and 4 clients over its local executor on
   the card (no errors, its histogram's count exact);
13. the bench phase (at the end): ``pixie_tpu_torch.bench.run_shape``
   for bench.py's ten shapes at 2^22 head rows (each shape's divisor
   applies), the A/B pass off, each checked with bench.py's numpy
   assertions; then the gates phase: ``check_bench_shapes``,
   ``check_obs_scripts`` and ``check_bounds`` on the card, each 0;
14. prints one ``{"kernels": [...]}`` line and, last, the device line.

Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS = 1 << 24  # bench.py's TPU default replay size
WINDOW = 1 << 21
ROW_BYTES = 32  # on the card: time_, latency_ns, resp_status i64; two i32 ids
TAIL_ROWS = (1 << 20) + 3
EVICTION_BUDGET = 256 << 20  # half the main replay's 512 MiB
FULL_ROWS = 1 << 27  # 4 GiB resident, inside the default 6 GiB budget
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


RELATION = [("time_", "TIME64NS"), ("latency_ns", "INT64"),
            ("resp_status", "INT64"), ("service", "STRING"),
            ("req_path", "STRING")]


def append_replay(eng, replay, window: int, start: int = 0) -> float:
    """Append ``replay`` to ``eng``'s http_events in ``window``-row
    batches, ``time_`` counting from ``start``; returns the seconds the
    appends took (with residency on, the staging of every completed
    window included)."""
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    svc, path, lat, status = replay
    rel = Relation([(n, getattr(DataType, t)) for n, t in RELATION])
    dicts = {
        "service": StringDictionary([f"svc-{i}" for i in range(N_SERVICES)]),
        "req_path": StringDictionary([f"/api/v1/ep{i}" for i in range(N_PATHS)]),
    }
    n = len(svc)
    t0 = time.perf_counter()
    for off in range(0, n, window):
        s = slice(off, min(off + window, n))
        m = s.stop - s.start
        eng.append_data("http_events", HostBatch(relation=rel, cols={
            "time_": (np.arange(start + off, start + off + m, dtype=np.int64),),
            "latency_ns": (lat[s],),
            "resp_status": (status[s],),
            "service": (svc[s],),
            "req_path": (path[s],),
        }, length=m, dicts=dicts))
    return time.perf_counter() - t0


def load_engine(replay, window: int, device, **engine_kw):
    """An Engine holding the replay as http_events (created through the
    engine, so it stages at ``window`` rows onto ``device``)."""
    from pixie_tpu_torch import Engine

    eng = Engine(window_rows=window, device=device, **engine_kw)
    eng.create_table("http_events")
    eng.append_secs = append_replay(eng, replay, window)
    return eng


# -- result checks (bench.py's assertions, on dense keys) ----------------------
def expect_http_stats(replay, float64: bool) -> dict:
    """count, mean and max of latency per (service, path) over rows with
    status < 400, keyed service x N_PATHS + path."""
    svc, path, lat, status = replay
    ok = status < 400
    key = svc[ok].astype(np.int64) * N_PATHS + path[ok]
    g = N_SERVICES * N_PATHS
    if float64:
        vals = lat[ok].astype(np.float32) / np.float32(1e6)
        mx = np.full(g, -np.inf, dtype=np.float32)
    else:
        vals = lat[ok]
        mx = np.full(g, np.iinfo(np.int64).min, dtype=np.int64)
    cnt = np.bincount(key, minlength=g)
    mean = np.bincount(key, weights=vals.astype(np.float64), minlength=g)
    np.maximum.at(mx, key, vals)
    live = cnt > 0
    return {"key": np.flatnonzero(live), "n": cnt[live],
            "mean": mean[live] / cnt[live], "max": mx[live]}


def check_http_stats(out, want: dict) -> None:
    got = out.to_pydict(decode_strings=False)
    gkey = got["service"].astype(np.int64) * N_PATHS + got["req_path"]
    order = np.argsort(gkey)
    assert np.array_equal(want["key"], gkey[order]), "http_stats keys mismatch"
    assert np.array_equal(got["n"][order], want["n"]), "http_stats counts mismatch"
    np.testing.assert_allclose(got["lat_mean"][order], want["mean"], rtol=1e-5)
    np.testing.assert_array_equal(got["lat_max"][order], want["max"])


def expect_service_stats(replay) -> dict:
    svc, _path, lat, status = replay
    out = {}
    for s in range(N_SERVICES):
        m = svc == s
        r50, r99 = np.quantile(lat[m], [0.5, 0.99])
        out[s] = (r50, r99, float(np.mean(status[m] >= 400)), int(m.sum()))
    return out


def check_service_stats(out, want: dict) -> None:
    got = out.to_pydict(decode_strings=False)
    assert len(got["service"]) == N_SERVICES, "service_stats group count"
    for s, p50, p99, err, thr in zip(
        got["service"], got["p50"], got["p99"], got["error_rate"],
        got["throughput"],
    ):
        r50, r99, rerr, rthr = want[int(s)]
        assert abs(p50 - r50) / r50 < 0.15, f"p50 off: {p50} vs {r50}"
        assert abs(p99 - r99) / r99 < 0.15, f"p99 off: {p99} vs {r99}"
        np.testing.assert_allclose(err, rerr, rtol=1e-4)
        assert thr == rthr, f"throughput {thr} vs {rthr}"


def check_rows(out, replay, idx, cols) -> None:
    """A row chain's answer: the replay's rows ``idx``, in row order."""
    svc, path, lat, status = replay
    want = {"time_": idx.astype(np.int64), "latency_ns": lat[idx],
            "resp_status": status[idx], "service": svc[idx],
            "req_path": path[idx]}
    got = out.to_pydict(decode_strings=False)
    assert list(got) == list(cols), f"row columns {list(got)} vs {cols}"
    assert out.length == len(idx), f"{out.length} rows vs {len(idx)}"
    for c in cols:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def check_resident_windows(table, replay) -> None:
    """Every window staged at append time (through two pinned buffers
    reused back to back, copies in flight) holds the replay's rows,
    read on the consumer's stream after its hand-off."""
    import torch

    svc, path, lat, status = replay
    cache = table._device_cache
    keys = sorted(cache.keys())
    assert len(keys) == ROWS // WINDOW, keys
    for key in keys:
        win = cache.get(key)
        win.handoff()
        s = slice(win.row0, win.row0 + win.n)
        for col, want in (("latency_ns", lat[s]), ("resp_status", status[s]),
                          ("service", svc[s]), ("req_path", path[s]),
                          ("time_", np.arange(s.start, s.stop))):
            got = win.cols[col][0][:win.n]
            ok = torch.equal(got, torch.from_numpy(
                np.ascontiguousarray(want)).to(got.device, got.dtype))
            assert ok, f"resident window {key} column {col} differs"


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


def profiled_device_ms(fn, inputs, iters: int = 10):
    """Device time per call of all the call's device work (kernels,
    memsets, copies), read from a torch.profiler (CUPTI) trace; None when
    the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    total_us = sum(
        getattr(evt, "self_device_time_total",
                getattr(evt, "self_cuda_time_total", 0.0))
        for evt in prof.key_averages()
    )
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


def _edge_views(ids, vals, n: int):
    """The edge cases every kernel route is held to, as (label, ids,
    values) over ``n`` + 5 rows: a ragged n (n + 3), both bases 4 bytes
    past a 16-byte boundary (the views ``[1:]``), and the two bases at
    different offsets (``ids[1:]`` beside ``vals[2:]``)."""
    assert ids.numel() >= n + 5
    return [
        ("ragged", ids[:n + 3], vals[:n + 3]),
        ("misaligned", ids[1:n + 4], vals[1:n + 4]),
        ("offsets_differ", ids[1:n + 2], vals[2:n + 3]),
    ]


def dense_fold_inputs(replay, device, nonfinite: bool = False,
                      rows: int = WINDOW, start: int = 0, wide: bool = False):
    """One window of the FLOAT64 http_stats fold: slot = service x 9 +
    path (297 slots; g padded to 384, trash rows at 384), values =
    latency_ns / 1e6 in f32. ``wide`` spreads the rows over g = 2048
    slots instead (service x 64 + path x 8 + latency % 8)."""
    import torch

    svc, path, lat, status = (x[start:start + rows] for x in replay)
    if wide:
        g_pad = 2048
        slots = svc * 64 + path * 8 + lat % 8
    else:
        g_pad = 384
        assert (N_SERVICES + 1) * (N_PATHS + 1) <= g_pad
        slots = svc * (N_PATHS + 1) + path
    slots = np.where(status < 400, slots, g_pad)
    vals = lat.astype(np.float32) / np.float32(1e6)
    if nonfinite:
        vals[slots == 0] = np.nan
        vals[np.flatnonzero(slots == 1)[:3]] = [np.inf, -np.inf, 1.0]
        vals[np.flatnonzero(slots == 2)[:1]] = np.inf
        vals[np.flatnonzero(slots == 3)[:1]] = -np.inf
    return (torch.from_numpy(slots.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device), g_pad)


def check_dense_fold(replay, device) -> dict:
    """dense_fold against its plain version: the main path's window with
    and without non-finite values and min; the edge views; three calls
    back to back on other inputs, the last at a larger g (the reused
    workspace and ticket); g = 2048; an all-trash window. Counts, max
    and min exact (NaN in the same places), sums rtol 1e-5 (f32 atomics
    in run-dependent order against an f64 reference)."""
    import torch
    from pixie_tpu_torch.ops.dense_fold import dense_fold, dense_fold_reference

    checked, errs = [], [0.0]

    def compare(got, slots, vals, g, want_min, name):
        ref = dense_fold_reference(slots, vals, g, want_min)
        torch.cuda.synchronize()
        _same(got[0], ref[0], 0.0, f"dense_fold count [{name}]")
        _same(got[1], ref[1], 1e-5, f"dense_fold sum [{name}]")
        _same(got[2], ref[2], 0.0, f"dense_fold max [{name}]")
        if want_min:
            _same(got[3], ref[3], 0.0, f"dense_fold min [{name}]")
        else:
            assert got[3] is None, f"dense_fold [{name}]: min without want_min"
        errs.append(max(_max_abs_err(a, b) for a, b in zip(got, ref)
                        if a is not None))
        checked.append(name)

    def check(slots, vals, g, want_min, name):
        compare(dense_fold(slots, vals, g, want_min), slots, vals, g,
                want_min, name)

    for nonfinite in (False, True):
        slots, vals, g = dense_fold_inputs(replay, device, nonfinite,
                                           rows=WINDOW + 5)
        for want_min in (False, True):
            check(slots[:WINDOW], vals[:WINDOW], g, want_min,
                  f"nonfinite={nonfinite},want_min={want_min}")
            for label, s, v in _edge_views(slots, vals, WINDOW):
                check(s, v, g, want_min,
                      f"{label},nonfinite={nonfinite},want_min={want_min}")

    # Back to back on one stream, no synchronisation between the calls.
    calls = [
        dense_fold_inputs(replay, device, False, start=WINDOW) + (False,),
        dense_fold_inputs(replay, device, True, start=2 * WINDOW) + (True,),
        dense_fold_inputs(replay, device, True, start=3 * WINDOW,
                          wide=True) + (True,),
    ]
    outs = [dense_fold(s, v, g, m) for s, v, g, m in calls]
    for i, (out, (s, v, g, m)) in enumerate(zip(outs, calls)):
        compare(out, s, v, g, m, f"back_to_back[{i}],g={g},want_min={m}")

    wide = dense_fold_inputs(replay, device, wide=True)
    check(*wide, False, "g=2048,want_min=False")
    check(torch.full_like(wide[0], 384), wide[1], 384, True, "all_trash")

    main_inputs = dense_fold_inputs(replay, device)
    shapes = []
    for label, (slots, vals, g) in (("main", main_inputs), ("g=2048", wide)):
        inputs = _rotating((slots, vals))
        n = slots.numel()
        shapes.append({
            "label": label, "rows": n, "slots": g, "want_min": False,
            "ms": event_ms(lambda s, v: dense_fold(s, v, g), inputs),
            "device_ms": profiled_device_ms(
                lambda s, v: dense_fold(s, v, g), inputs),
            **_bound(n * 8 + 3 * g * 4, n * 4),
        })
    main = shapes[0]
    slots, vals, g = main_inputs
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

    return {
        "name": "dense_fold",
        "route": "cuda",
        "source": "pixie_tpu_torch/csrc/dense_fold.cu",
        "replaces": "pixie_tpu/ops/pallas_groupby.py:93",
        "shape": {"rows": main["rows"], "slots": g, "want_min": False},
        "checked": checked,
        "max_abs_err": max(errs),
        "ms": main["ms"],
        "plain_ms": event_ms(lambda s, v: dense_fold_reference(s, v, g),
                             inputs),
        "library_ms": event_ms(library, idx),
        "device_ms": main["device_ms"],
        "plain_device_ms": profiled_device_ms(
            lambda s, v: dense_fold_reference(s, v, g), inputs),
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bytes": main["bytes"],
        "shapes": shapes,
    }


#: The benchmark's dense domain for px/http_stats: (9 services + NULL) x
#: (15 paths + NULL) slots, 15 of them live (Online Boutique's methods,
#: path k under the service that serves it).
INT_FOLD_G = 10 * 16
INT_FOLD_LIVE = np.array([0, 0, 0, 1, 2, 2, 2, 3, 3, 4, 4, 5, 6, 7, 8]) * 16 \
    + np.arange(15)


def int_fold_inputs(replay, device, rows: int = WINDOW, start: int = 0,
                    shape: str = "main", wrap: bool = False):
    """One window of the INT64 http_stats fold. ``shape`` "main": the
    benchmark's, each row's (service, path) on one of 15 live slots of
    g = 160; "replay": this replay's own 33 x 9 = 297 slots; "wide":
    g = 2048 (service x 64 + path x 8 + latency % 8). Rows with status
    >= 400 go to the trash slot g. Values are latency_ns, or with
    ``wrap`` near INT64_MAX and INT64_MIN so that sums wrap."""
    import torch

    svc, path, lat, status = (x[start:start + rows] for x in replay)
    if shape == "main":
        g = INT_FOLD_G
        slots = INT_FOLD_LIVE[(svc * N_PATHS + path) % len(INT_FOLD_LIVE)]
    elif shape == "replay":
        g = (N_SERVICES + 1) * (N_PATHS + 1)
        slots = svc * (N_PATHS + 1) + path
    else:
        g = 2048
        slots = svc * 64 + path * 8 + lat % 8
    slots = np.where(status < 400, slots, g)
    info = np.iinfo(np.int64)
    vals = np.where(lat % 2 == 1, info.max - lat, info.min + lat) if wrap else lat
    return (torch.from_numpy(slots.astype(np.int32)).to(device),
            torch.from_numpy(vals.astype(np.int64)).to(device), g)


def check_int_fold(replay, device) -> dict:
    """int_fold against its plain version, exactly: the main path's
    window with and without the min; the edge views; sums that wrap;
    this replay's g = 297 and g = 2048; three calls back to back on other
    inputs and slot counts (the reused workspace and ticket); an
    all-trash window. Then times the kernel, its plain version and the
    UDAs' four library scatters it replaces (count, mean's sum and
    count, max: ``_seg_count``, ``_seg_sum``, ``_seg_extreme``)."""
    import torch
    from pixie_tpu_torch.ops.int_fold import copies, int_fold, int_fold_reference
    from pixie_tpu_torch.udf.builtins.math_ops import (
        _seg_count, _seg_extreme, _seg_sum,
    )

    checked = []

    def check(slots, vals, g, want_min, name, got=None):
        if got is None:
            got = int_fold(slots, vals, g, want_min)
        ref = int_fold_reference(slots, vals, g, want_min)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, ref)):
            if b is None:
                assert a is None, f"int_fold [{name}]: min without want_min"
                continue
            assert a.dtype == torch.int64 and torch.equal(a, b), (
                f"int_fold [{name}] output {k}: {a.tolist()[:8]} vs "
                f"{b.tolist()[:8]}")
        checked.append(name)

    for wrap in (False, True):
        slots, vals, g = int_fold_inputs(replay, device, rows=WINDOW + 5,
                                         wrap=wrap)
        for want_min in (False, True):
            check(slots[:WINDOW], vals[:WINDOW], g, want_min,
                  f"main,wrap={wrap},want_min={want_min}")
            for label, s, v in _edge_views(slots, vals, WINDOW):
                check(s, v, g, want_min,
                      f"{label},wrap={wrap},want_min={want_min}")

    # Back to back on one stream, no synchronisation between the calls.
    calls = [
        int_fold_inputs(replay, device, start=WINDOW, shape="replay") + (False,),
        int_fold_inputs(replay, device, start=2 * WINDOW, shape="wide",
                        wrap=True) + (True,),
        int_fold_inputs(replay, device, start=3 * WINDOW) + (True,),
    ]
    outs = [int_fold(s, v, g, m) for s, v, g, m in calls]
    for i, (out, (s, v, g, m)) in enumerate(zip(outs, calls)):
        check(s, v, g, m, f"back_to_back[{i}],g={g},want_min={m}", got=out)

    main_inputs = int_fold_inputs(replay, device)
    wide = int_fold_inputs(replay, device, shape="wide")
    check(*wide, True, "g=2048,want_min=True")
    check(torch.full_like(wide[0], 2048), wide[1], 2048, True, "all_trash")

    def uda_chain(gids, v, g):
        # The fragment's updates for count, mean and max before int_fold.
        mask = gids < g
        zeros = torch.zeros(g, dtype=torch.int64, device=v.device)
        i64_min = torch.iinfo(torch.int64).min
        lo = torch.full((g,), i64_min, device=v.device)
        _seg_count(zeros, gids, mask)
        _seg_sum(zeros, gids, mask, v)
        _seg_count(zeros, gids, mask)
        _seg_extreme(lo, gids, mask, v, i64_min, "amax")

    shapes = []
    for label, (slots, vals, g) in (
            ("main", main_inputs),
            ("replay", int_fold_inputs(replay, device, shape="replay")),
            ("g=2048", wide)):
        inputs = _rotating((slots, vals))
        n = slots.numel()
        fold = lambda s, v, g=g: int_fold(s, v, g)  # noqa: E731
        lib = lambda s, v, g=g: uda_chain(s, v, g)  # noqa: E731
        shapes.append({
            "label": label, "rows": n, "slots": g, "want_min": False,
            "copies": copies(g),
            "ms": event_ms(fold, inputs),
            "device_ms": profiled_device_ms(fold, inputs),
            "library_ms": event_ms(lib, inputs),
            "library_device_ms": profiled_device_ms(lib, inputs),
            **_bound(n * 12 + 3 * g * 8, n),
        })
    main = shapes[0]
    slots, vals, g = main_inputs
    inputs = _rotating((slots, vals))
    plain = lambda s, v: int_fold_reference(s, v, g)  # noqa: E731
    return {
        "name": "int_fold",
        "route": "cuda",
        "source": "pixie_tpu_torch/csrc/int_fold.cu",
        "replaces": "none (the UDAs' index_add_/scatter_reduce_ chain)",
        "shape": {"rows": main["rows"], "slots": g, "want_min": False},
        "checked": checked,
        "max_abs_err": 0,
        "ms": main["ms"],
        "plain_ms": event_ms(plain, inputs),
        "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "device_ms": main["device_ms"],
        "plain_device_ms": profiled_device_ms(plain, inputs),
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bytes": main["bytes"],
        "shapes": shapes,
    }


def hist_fold_inputs(replay, device, num_groups: int, rows: int = WINDOW,
                     start: int = 0):
    """One window of service_stats' t-digest fold, made as
    ``ops/tdigest.batch_to_digest`` makes it: flat id = group x B + bin,
    every 97th row trash (id = the slot count)."""
    import torch
    from pixie_tpu_torch.ops.tdigest import _hist_bins

    svc, _path, lat, _status = (x[start:start + rows] for x in replay)
    b = _hist_bins(num_groups)
    vals = lat.astype(np.float32)
    bits = vals.view(np.uint32).astype(np.int64)
    bins = (bits | 0x80000000) >> (32 - b.bit_length() + 1)
    n_slots = num_groups * b
    ids = (svc % num_groups).astype(np.int64) * b + bins
    ids[::97] = n_slots
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device), n_slots)


def hist_fold_group_by_inputs(device, rows: int = WINDOW):
    """One window of the group_by phase's t-digest fold at its last rung:
    20,000 upids' group ids at G = 32768 groups of B = 1024 bins (2^25
    slots, the global route), RSS-like values, every 97th row trash."""
    import torch
    from pixie_tpu_torch.ops.tdigest import _hist_bins

    rng = np.random.default_rng(SEED + 3)
    groups = 32768
    b = _hist_bins(groups)
    vals = np.exp(rng.uniform(np.log(1 << 24), np.log(1 << 32), rows)
                  ).astype(np.float32)
    bits = vals.view(np.uint32).astype(np.int64)
    bins = (bits | 0x80000000) >> (32 - b.bit_length() + 1)
    n_slots = groups * b
    ids = rng.integers(0, GB_UPIDS, rows) * b + bins
    ids[::97] = n_slots
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device), n_slots)


#: Group counts whose slot counts (G x 8192) cover the histogram kernel's
#: routes: 3 the ranges route with one range (a private copy of every
#: slot per block), 33 (service_stats) the ranges route with 10 ranges,
#: 64 the global route.
HIST_ROUTE_GROUPS = (("ranges", 3), ("ranges", N_SERVICES + 1),
                     ("global", 64))


def check_hist_fold(replay, device) -> dict:
    """hist_fold against its plain version on each route: the window and
    the edge views, also at the group_by phase's shape (2^25 slots); on
    the main path's route also two calls back to back and an all-trash
    window. Weights exact, sums rtol 1e-5."""
    import torch
    from pixie_tpu_torch.ops.hist_fold import (
        hist_fold, hist_fold_reference, route,
    )

    checked, errs = [], [0.0]

    def compare(got, ids, vals, n_slots, name):
        rw, rmw = hist_fold_reference(ids, vals, n_slots)
        torch.cuda.synchronize()
        _same(got[0], rw, 0.0, f"hist_fold weights [{name}]")
        _same(got[1], rmw, 1e-5, f"hist_fold sums [{name}]")
        errs.append(max(_max_abs_err(got[0], rw), _max_abs_err(got[1], rmw)))
        checked.append(name)

    shapes = []
    for want_route, groups in HIST_ROUTE_GROUPS:
        ids, vals, n_slots = hist_fold_inputs(replay, device, groups,
                                              rows=WINDOW + 5)
        assert route(n_slots) == want_route, (n_slots, want_route)
        tag = f"{want_route},groups={groups},slots={n_slots}"
        cases = [("main", ids[:WINDOW], vals[:WINDOW])]
        cases += _edge_views(ids, vals, WINDOW)
        for label, i, v in cases:
            compare(hist_fold(i, v, n_slots), i, v, n_slots, f"{label},{tag}")
        inputs = _rotating((ids[:WINDOW], vals[:WINDOW]))
        shapes.append({
            "label": f"{want_route},groups={groups}", "route": want_route,
            "rows": WINDOW,
            "slots": n_slots,
            "ms": event_ms(lambda i, v: hist_fold(i, v, n_slots), inputs),
            "device_ms": profiled_device_ms(
                lambda i, v: hist_fold(i, v, n_slots), inputs),
            **_bound(WINDOW * 8 + n_slots * 8, WINDOW * 2),
        })

    # The group_by phase's shape (quantiles by upid, 2^25 slots).
    ids, vals, n_slots = hist_fold_group_by_inputs(device, rows=WINDOW + 5)
    assert route(n_slots) == "global", n_slots
    tag = f"global,group_by,slots={n_slots}"
    for label, i, v in ([("main", ids[:WINDOW], vals[:WINDOW])]
                        + _edge_views(ids, vals, WINDOW)):
        compare(hist_fold(i, v, n_slots), i, v, n_slots, f"{label},{tag}")
    inputs = _rotating((ids[:WINDOW], vals[:WINDOW]))
    shapes.append({
        "label": "global,group_by", "route": "global", "rows": WINDOW,
        "slots": n_slots,
        "ms": event_ms(lambda i, v: hist_fold(i, v, n_slots), inputs),
        "device_ms": profiled_device_ms(
            lambda i, v: hist_fold(i, v, n_slots), inputs),
        "plain_ms": event_ms(
            lambda i, v: hist_fold_reference(i, v, n_slots), inputs),
        # index_add_ of the same weights and weighted sums into the
        # [slots + 1, 2] output (the trash row included).
        "library_ms": event_ms(
            lambda i, wv: torch.zeros(n_slots + 1, 2, device=i.device)
            .index_add_(0, i, wv),
            [(i.long(), torch.stack([torch.ones_like(v), v], 1))
             for i, v in inputs]),
        **_bound(WINDOW * 8 + n_slots * 8, WINDOW * 2),
    })
    del ids, vals, inputs

    groups = N_SERVICES + 1
    calls = [hist_fold_inputs(replay, device, groups, start=k * WINDOW)
             for k in (1, 2)]
    outs = [hist_fold(i, v, s) for i, v, s in calls]
    for k, (out, (i, v, s)) in enumerate(zip(outs, calls)):
        compare(out, i, v, s, f"back_to_back[{k}],groups={groups}")
    ids, vals, n_slots = hist_fold_inputs(replay, device, groups)
    trash = torch.full_like(ids, n_slots)
    compare(hist_fold(trash, vals, n_slots), trash, vals, n_slots,
            f"all_trash,groups={groups}")

    main = next(s for s in shapes if s["slots"] == n_slots)
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
        "shape": {"rows": WINDOW, "slots": n_slots,
                  "kernel_route": main["route"]},
        "checked": checked,
        "max_abs_err": max(errs),
        "ms": main["ms"],
        "plain_ms": event_ms(
            lambda i, v: hist_fold_reference(i, v, n_slots), inputs),
        "library_ms": event_ms(library, lib_inputs),
        "device_ms": main["device_ms"],
        "plain_device_ms": profiled_device_ms(
            lambda i, v: hist_fold_reference(i, v, n_slots), inputs),
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bytes": main["bytes"],
        "shapes": shapes,
    }


def profile_digest(replay, device, iters: int = 10) -> dict:
    """Device time of one ``ops/tdigest.batch_to_digest`` call, the
    layer above ``hist_fold``, at the main path's shape (one window, 33
    groups), with its largest kernels (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pixie_tpu_torch.ops.tdigest import batch_to_digest

    svc, _path, lat, _status = (x[:WINDOW] for x in replay)
    vals = torch.from_numpy(lat.astype(np.float32)).to(device)
    gids = torch.from_numpy(svc.astype(np.int32)).to(device)
    mask = torch.ones(len(svc), dtype=torch.bool, device=device)
    groups = N_SERVICES + 1
    batch_to_digest(vals, gids, mask, groups)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            batch_to_digest(vals, gids, mask, groups)
        torch.cuda.synchronize()
    per_call = sorted(
        ((getattr(e, "self_device_time_total", 0.0) / iters / 1e3, e.key)
         for e in prof.key_averages()),
        reverse=True,
    )
    return {
        "device_ms": sum(ms for ms, _k in per_call),
        "top": [{"kernel": k[:80], "ms": ms} for ms, k in per_call[:4]],
    }


def _bound(bytes_moved: int, ops: int) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return {
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
    }


# -- the main path and the window path's phases ---------------------------------
AGG_SCRIPTS = ("px/http_stats", "http_stats_float64", "px/service_stats")


class Expect:
    """numpy's answer to each aggregate script over one replay, computed
    once and checked against every phase that runs the script."""

    def __init__(self, replay):
        self.replay = replay
        self._cache = {}

    def check(self, name: str, out) -> None:
        if name not in self._cache:
            self._cache[name] = (
                expect_service_stats(self.replay) if name == "px/service_stats"
                else expect_http_stats(self.replay,
                                       float64=name == "http_stats_float64"))
        want = self._cache[name]
        if name == "px/service_stats":
            check_service_stats(out, want)
        else:
            check_http_stats(out, want)


def query_text(name: str) -> str:
    from pixie_tpu_torch.scripts import load_script

    return HTTP_STATS_F64 if name == "http_stats_float64" else load_script(name).pxl


def run_checked(eng, name: str, expect: Expect, **kw) -> dict:
    """One query, checked against numpy; its counters and host times."""
    t0 = time.perf_counter()
    out = eng.execute_query(query_text(name), **kw)["output"]
    secs = time.perf_counter() - t0
    st = eng.last_stats
    expect.check(name, out)
    return {
        "script": name, "rows": st.rows, "windows": st.windows,
        "secs": secs, "rows_per_s": st.rows / secs,
        "resident_windows": st.resident_windows,
        "staged_windows": st.staged_windows,
        "skipped_windows": st.skipped_windows,
        "pipeline": dict(st.pipeline), "checked": True,
    }


def phase_steady_state(eng, expect: Expect) -> dict:
    """The main path: each aggregate script over resident windows, one
    warm-up query, then the launch counters set to 0, one measured
    query, the counters read. Every window must be resident."""
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold
    from pixie_tpu_torch.ops.int_fold import int_fold

    launches = {}
    for name in AGG_SCRIPTS:
        eng.execute_query(query_text(name))
        dense_fold.launches = 0
        hist_fold.launches = 0
        int_fold.launches = 0
        rec = run_checked(eng, name, expect)
        rec["launches"] = {"dense_fold": dense_fold.launches,
                           "hist_fold": hist_fold.launches,
                           "int_fold": int_fold.launches}
        launches[name] = rec["launches"]
        print(json.dumps({"phase": "steady_state", **rec}))
        windows = rec["windows"]
        assert (rec["resident_windows"], rec["staged_windows"]) == (windows, 0), (
            f"{name}: {rec['resident_windows']} resident / "
            f"{rec['staged_windows']} staged of {windows} windows")
        print(json.dumps({"phase": "steady_state_turns", "script": name,
                          **depth_turns(eng, name), **device_busy(eng, name)}))
    counts = launches["http_stats_float64"]
    assert counts["dense_fold"] == ROWS // WINDOW, (
        f"dense_fold ran {counts['dense_fold']} times per query")
    counts = launches["px/http_stats"]
    assert counts["int_fold"] == ROWS // WINDOW, (
        f"int_fold ran {counts['int_fold']} times per query")
    counts = launches["px/service_stats"]
    assert counts["hist_fold"] == 2 * ROWS // WINDOW, (
        f"hist_fold ran {counts['hist_fold']} times per query")
    return {
        "dense_fold": launches["http_stats_float64"]["dense_fold"],
        "hist_fold": launches["px/service_stats"]["hist_fold"],
        "int_fold": launches["px/http_stats"]["int_fold"],
    }


def depth_turns(eng, name: str) -> dict:
    """Seconds per query at pipeline depth 2 and 1 over resident
    windows, in turns 2, 1, 1, 2, 2, 1 (medians)."""
    saved = eng.pipeline_depth
    secs = {1: [], 2: []}
    try:
        for depth in (2, 1, 1, 2, 2, 1):
            eng.pipeline_depth = depth
            t0 = time.perf_counter()
            eng.execute_query(query_text(name))
            secs[depth].append(time.perf_counter() - t0)
    finally:
        eng.pipeline_depth = saved
    return {"depth2_secs": float(np.median(secs[2])),
            "depth1_secs": float(np.median(secs[1])),
            "turns": {str(d): v for d, v in secs.items()}}


def device_busy(eng, name: str) -> dict:
    """One query under torch.profiler: the device time of its kernels,
    copies and memsets against its wall time; the rest is the share of
    the query the card sat idle (the profiler's own host cost adds to
    the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.execute_query(query_text(name))
        wall = time.perf_counter() - t0
    busy_us = sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
        for e in prof.key_averages()
    )
    torch.cuda.synchronize()
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall)}


def phase_attribution(eng, expect: Expect) -> None:
    """An attribution run (serial, the card fenced after each stage):
    where a resident query's time goes."""
    for name in AGG_SCRIPTS:
        rec = run_checked(eng, name, expect, analyze=True)
        st = eng.last_stats
        print(json.dumps({"phase": "attribution", **rec,
                          "read_s": st.read_s, "stage_s": st.stage_s,
                          "fold_s": st.fold_s, "finalize_s": st.finalize_s}))


def phase_host_staged(replay, expect: Expect, device) -> None:
    """Residency off: the same replay appended with nothing staged, then
    each script at pipeline depth 1 and 2. stage_secs is the prefetch
    producer's staging time, stall_secs the consumer's wait for it; the
    share of staging hidden behind the fold is 1 - stall / stage
    (bench.py's ``_pipeline_ab``)."""
    from pixie_tpu_torch.config import clear_flag, set_flag

    set_flag("device_residency", False)
    try:
        eng = load_engine(replay, WINDOW, device)
        print(json.dumps({"phase": "append", "residency": False,
                          "rows": ROWS, "secs": eng.append_secs,
                          "resident_bytes": eng.tables["http_events"].resident_bytes}))
        assert eng.tables["http_events"].resident_bytes == 0
        for name in AGG_SCRIPTS:
            rec = run_checked(eng, name, expect, analyze=True)
            st = eng.last_stats
            print(json.dumps({"phase": "host_staged_attribution", **rec,
                              "read_s": st.read_s, "stage_s": st.stage_s,
                              "fold_s": st.fold_s,
                              "finalize_s": st.finalize_s}))
        for name in AGG_SCRIPTS:
            eng.pipeline_depth = 1
            eng.execute_query(query_text(name))  # warm-up
            recs = {}
            for depth in (1, 2, 2, 1):
                eng.pipeline_depth = depth
                rec = run_checked(eng, name, expect)
                assert rec["staged_windows"] == rec["windows"]
                recs.setdefault(depth, []).append(rec)
            for depth, rs in recs.items():
                stage = sum(r["pipeline"]["stage_secs"] for r in rs)
                stall = sum(r["pipeline"]["stall_secs"] for r in rs)
                print(json.dumps({
                    "phase": "host_staged", "script": name, "depth": depth,
                    "secs": [r["secs"] for r in rs],
                    "rows_per_s": [r["rows_per_s"] for r in rs],
                    "stage_secs": [r["pipeline"]["stage_secs"] for r in rs],
                    "stall_secs": [r["pipeline"]["stall_secs"] for r in rs],
                    "hidden_share": (max(0.0, min(1.0, 1.0 - stall / stage))
                                     if depth > 1 and stage > 0 else None),
                    "checked": True,
                }))
    finally:
        clear_flag("device_residency")


def phase_row_chains(eng, replay) -> None:
    """The raw-row scripts over resident windows, against numpy in row
    order: each stops at its limit after the first window."""
    from pixie_tpu_torch.scripts import load_script

    _svc, _path, lat, status = replay
    cases = {
        "px/http_errors": (np.flatnonzero(status >= 400)[:100],
                           ["time_", "service", "req_path", "resp_status",
                            "latency_ns"]),
        "px/http_data": (np.arange(128), [n for n, _t in RELATION]),
    }
    for name, (idx, cols) in cases.items():
        eng.execute_query(load_script(name).pxl)
        t0 = time.perf_counter()
        out = eng.execute_query(load_script(name).pxl)["output"]
        secs = time.perf_counter() - t0
        check_rows(out, replay, idx, cols)
        st = eng.last_stats
        print(json.dumps({"phase": "row_chains", "script": name,
                          "rows_out": out.length, "secs": secs,
                          "windows": st.windows,
                          "resident_windows": st.resident_windows,
                          "staged_windows": st.staged_windows,
                          "pipeline": st.pipeline, "checked": True}))


def phase_tail(eng, replay) -> None:
    """Append 2^20 + 3 rows, then query: only the new tail window is
    staged by the query; the next query finds it resident too."""
    extra = make_replay(TAIL_ROWS, seed=SEED + 1)
    secs = append_replay(eng, extra, WINDOW, start=ROWS)
    both = tuple(np.concatenate([a, b]) for a, b in zip(replay, extra))
    expect = Expect(both)
    first = run_checked(eng, "px/http_stats", expect)
    second = run_checked(eng, "px/http_stats", expect)
    print(json.dumps({"phase": "tail", "appended_rows": len(extra[0]),
                      "append_secs": secs, "first": first, "second": second}))
    windows = ROWS // WINDOW + 1
    assert (first["resident_windows"], first["staged_windows"]) == (windows - 1, 1)
    assert (second["resident_windows"], second["staged_windows"]) == (windows, 0)


def phase_eviction(replay, expect: Expect, device) -> None:
    """device_cache_bytes = 256 MiB under a 512 MiB table: the answers
    hold, and neither the caches' bytes nor the allocator's growth ever
    exceed the budget (plus one window in flight)."""
    import torch
    from pixie_tpu_torch.config import clear_flag, set_flag
    from pixie_tpu_torch.table_store.device_cache import total_resident_bytes

    budget = EVICTION_BUDGET
    window_bytes = WINDOW * ROW_BYTES
    set_flag("device_cache_bytes", budget)
    try:
        base = torch.cuda.memory_allocated(device)
        eng = load_engine(replay, WINDOW, device)
        peaks = [total_resident_bytes()]
        alloc = [torch.cuda.memory_allocated(device) - base]
        recs = []
        for name in AGG_SCRIPTS:
            recs.append(run_checked(eng, name, expect))
            peaks.append(total_resident_bytes())
            alloc.append(torch.cuda.memory_allocated(device) - base)
        print(json.dumps({"phase": "eviction", "budget": budget,
                          "append_secs": eng.append_secs,
                          "resident_bytes": peaks,
                          "allocated_over_base": alloc, "queries": recs}))
        assert max(peaks) <= budget, f"resident {max(peaks)} > {budget}"
        assert max(alloc) <= budget + window_bytes, (
            f"allocated {max(alloc)} over the base > budget + one window")
    finally:
        clear_flag("device_cache_bytes")


def phase_full_budget(device) -> None:
    """2^27 rows, 4 GiB resident inside the default 6 GiB budget: one
    px/http_stats query checked against numpy, after one warm-up."""
    rows = FULL_ROWS
    replay = make_replay(rows, seed=SEED + 2)
    eng = load_engine(replay, WINDOW, device)
    t = eng.tables["http_events"]
    assert t.resident_bytes == rows * ROW_BYTES, t.resident_bytes
    expect = Expect(replay)
    eng.execute_query(query_text("px/http_stats"))
    rec = run_checked(eng, "px/http_stats", expect)
    print(json.dumps({"phase": "full_budget", "rows": rows,
                      "append_secs": eng.append_secs,
                      "resident_bytes": t.resident_bytes, **rec}))
    assert (rec["resident_windows"], rec["staged_windows"]) == (rows // WINDOW, 0)


# -- the group-by without a dense key domain ---------------------------------
GB_ROWS = 1 << 23
GB_UPIDS, GB_NODES, GB_PODS = 20_000, 100, 2_000
GB_ROW_BYTES = 108  # time_, 10 INT64 counters, UINT128 upid (16), pod id (4)
GB_FORMS = ("sort", "hash")
GB_TURNS = ("sort", "hash", "hash", "sort", "sort", "hash")

# The JAX package's process_stats relation (its ``ingest/schemas.py``).
PROCESS_STATS = [
    ("time_", "TIME64NS"), ("upid", "UINT128"), ("major_faults", "INT64"),
    ("minor_faults", "INT64"), ("cpu_utime_ns", "INT64"),
    ("cpu_ktime_ns", "INT64"), ("rss_bytes", "INT64"),
    ("vsize_bytes", "INT64"), ("rchar_bytes", "INT64"),
    ("wchar_bytes", "INT64"), ("read_bytes", "INT64"),
    ("write_bytes", "INT64"), ("pod", "STRING"),
]

RSS_QUANTILES = """import px
df = px.DataFrame(table='process_stats')
q = df.groupby('upid').agg(rss_q=('rss_bytes', px.quantiles))
q.p50 = px.pluck_float64(q.rss_q, 'p50')
q.p99 = px.pluck_float64(q.rss_q, 'p99')
px.display(q[['upid', 'p50', 'p99']])
"""

GB_QUERIES = ("px/upids", "px/pods", "px/pid_memory_usage", "rss_quantiles")

# A row chain that carries the UINT128 upid through a filter to the host.
BIG_PROCESSES = """import px
df = px.DataFrame(table='process_stats')
df = df[df.rss_bytes > 4000000000]
px.display(df.head(1000))
"""


def make_process_stats(n: int, seed: int = SEED) -> dict:
    """A process_stats replay: GB_UPIDS processes, 200 on each of
    GB_NODES nodes (upid hi = asid << 32 | pid, lo = start ticks), each
    in one of GB_PODS pods (10 per pod), sampled uniformly row by row.
    RSS is a per-process base (16 MiB to 4 GiB, log-uniform) times 1 to
    1.1; vsize 2-6x the RSS."""
    rng = np.random.default_rng(seed)
    asid = np.repeat(np.arange(GB_NODES, dtype=np.uint64), GB_UPIDS // GB_NODES)
    pid = rng.integers(1, 1 << 22, GB_UPIDS).astype(np.uint64)
    hi = (asid << np.uint64(32)) | pid
    lo = rng.integers(1 << 30, 1 << 44, GB_UPIDS).astype(np.uint64)
    assert len(np.unique(np.stack([hi, lo], 1), axis=0)) == GB_UPIDS
    pod_of = rng.permutation(np.arange(GB_UPIDS) % GB_PODS).astype(np.int32)
    rss_base = np.exp(rng.uniform(np.log(1 << 24), np.log(1 << 32), GB_UPIDS))
    u = rng.integers(0, GB_UPIDS, n)
    rss = (rss_base[u] * (1.0 + 0.1 * rng.random(n))).astype(np.int64)
    cols = {
        "time_": np.arange(n, dtype=np.int64),
        "upid": (hi[u], lo[u]),
        "rss_bytes": rss,
        "vsize_bytes": rss * rng.integers(2, 7, n),
        "pod": pod_of[u],
    }
    for c, _t in PROCESS_STATS:
        if c not in cols:
            cols[c] = rng.integers(0, 1 << 40, n)
    return {"u": u, "hi": hi, "lo": lo, "pod_of": pod_of, "cols": cols,
            "pods": [f"ns-{i % 50}/pod-{i}" for i in range(GB_PODS)]}


def load_process_stats(ps: dict, device):
    """An Engine holding the replay as process_stats, appended in
    WINDOW-row batches through ``Engine.append_data`` with the
    reference's defaults (residency and ingest sketches on)."""
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    rel = Relation([(c, getattr(DataType, t)) for c, t in PROCESS_STATS])
    dicts = {"pod": StringDictionary(ps["pods"])}
    cols, n = ps["cols"], len(ps["u"])
    eng = Engine(window_rows=WINDOW, device=device)
    eng.create_table("process_stats")
    t0 = time.perf_counter()
    for off in range(0, n, WINDOW):
        s = slice(off, min(off + WINDOW, n))
        eng.append_data("process_stats", HostBatch(relation=rel, cols={
            c: tuple(p[s] for p in (v if isinstance(v, tuple) else (v,)))
            for c, v in cols.items()
        }, length=s.stop - s.start, dicts=dicts))
    eng.append_secs = time.perf_counter() - t0
    return eng


def _group_quantiles(u, vals, qs):
    """numpy's linear quantiles of ``vals`` per group id ``u``."""
    order = np.lexsort((vals, u))
    sv = vals[order].astype(np.float64)
    cnt = np.bincount(u, minlength=GB_UPIDS)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    out = []
    for q in qs:
        pos = (cnt - 1) * q
        k = np.floor(pos).astype(np.int64)
        frac = pos - k
        a = sv[start + k]
        b = sv[start + np.minimum(k + 1, cnt - 1)]
        out.append(a + frac * (b - a))
    return out


class GroupByExpect:
    """numpy's answer to each group_by query over the replay, per upid
    index (every upid has rows)."""

    def __init__(self, ps: dict):
        u, cols = ps["u"], ps["cols"]
        self.ps = ps
        self.cnt = np.bincount(u, minlength=GB_UPIDS)
        assert (self.cnt > 0).all()
        self.max = {}
        for c in ("rss_bytes", "vsize_bytes", "cpu_utime_ns"):
            m = np.full(GB_UPIDS, np.iinfo(np.int64).min, dtype=np.int64)
            np.maximum.at(m, u, cols[c])
            self.max[c] = m
        self.p50, self.p99 = _group_quantiles(u, cols["rss_bytes"],
                                              (0.5, 0.99))
        key = ps["hi"].astype(object) * (1 << 64) + ps["lo"].astype(object)
        self.index = {k: i for i, k in enumerate(key)}

    def upid_index(self, upid) -> np.ndarray:
        """Result rows' upids -> upid indices (each exactly once)."""
        idx = np.array([
            self.index[int(h) * (1 << 64) + int(l)] for h, l in upid
        ])
        assert len(idx) == GB_UPIDS, f"{len(idx)} upids of {GB_UPIDS}"
        assert len(np.unique(idx)) == GB_UPIDS, "a upid appears twice"
        return idx

    def check(self, name: str, out) -> None:
        got = out.to_pydict(decode_strings=False)
        pod_of = self.ps["pod_of"]
        if name == "px/pods":
            assert np.array_equal(np.sort(got["pod"]), np.arange(GB_PODS)), (
                "pods key set")
            per_pod_rss = np.zeros(GB_PODS, dtype=np.int64)
            np.add.at(per_pod_rss, pod_of, self.max["rss_bytes"])
            procs = np.bincount(pod_of, minlength=GB_PODS)
            np.testing.assert_array_equal(got["processes"], procs[got["pod"]])
            np.testing.assert_array_equal(got["rss"], per_pod_rss[got["pod"]])
            return
        i = self.upid_index(got["upid"])
        if name == "px/upids":
            np.testing.assert_array_equal(got["pod"], pod_of[i])
            np.testing.assert_array_equal(got["samples"], self.cnt[i])
            np.testing.assert_array_equal(got["rss"], self.max["rss_bytes"][i])
            np.testing.assert_array_equal(got["vsize"],
                                          self.max["vsize_bytes"][i])
            np.testing.assert_array_equal(got["cpu_utime_ns"],
                                          self.max["cpu_utime_ns"][i])
        elif name == "px/pid_memory_usage":
            np.testing.assert_array_equal(got["rss"], self.max["rss_bytes"][i])
            np.testing.assert_array_equal(got["vsize"],
                                          self.max["vsize_bytes"][i])
            np.testing.assert_array_equal(got["pod"], pod_of[i])  # px.any
        else:
            for q, want in (("p50", self.p50), ("p99", self.p99)):
                err = np.abs(got[q] - want[i]) / want[i]
                assert err.max() < 0.15, f"{q} off by {err.max():.3f}"


def gb_query_text(name: str) -> str:
    from pixie_tpu_torch.scripts import load_script

    return RSS_QUANTILES if name == "rss_quantiles" else load_script(name).pxl


def _run_form(eng, name: str, form: str):
    from pixie_tpu_torch.config import clear_flag, set_flag

    set_flag("groupby_impl", form)
    try:
        t0 = time.perf_counter()
        # Every upid in the output: the display limit's default is 10,000.
        out = eng.execute_query(gb_query_text(name),
                                max_output_rows=GB_UPIDS)["output"]
        return out, time.perf_counter() - t0
    finally:
        clear_flag("groupby_impl")


def sync_sites(run, fold_fns=("window_state", "merge_states")):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: each
    host sync the card's PyTorch flags is one warning, from any thread
    (the final reads of the result included). Each is attributed to the
    innermost line of the port that made it; ``fold`` counts those made
    inside one of ``fold_fns``. Returns (total, fold, sites)."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    in_fold = [0]

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()
        port = [f for f in stack if "pixie_tpu_torch" in f.filename]
        where = "?"
        if port:
            f = port[-1]
            where = (f.filename.split("pixie_tpu_torch/")[-1]
                     + f":{f.lineno}")
        sites[where] += 1
        in_fold[0] += any(f.name in fold_fns for f in stack)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(sites.values()), in_fold[0], sites


def count_syncs(eng, name: str, form: str) -> dict:
    """One query's host syncs (``sync_sites``); ``fold_syncs`` counts
    those made inside a window's fold or merge (``window_state``,
    ``merge_states``), the rest are finalize reads."""
    total, fold, sites = sync_sites(lambda: _run_form(eng, name, form))
    windows = eng.last_stats.windows
    return {"syncs": total, "fold_syncs": fold, "windows_folded": windows,
            "syncs_per_window": total / windows,
            "fold_syncs_per_window": fold / windows,
            "sync_sites": dict(sites.most_common(8))}


def busy_share(run) -> dict:
    """``run()`` under torch.profiler: device busy time against wall time
    (the idle share), and the four largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    per_op = sorted(
        ((getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0)), e.key)
         for e in prof.key_averages()),
        reverse=True,
    )
    busy_us = sum(us for us, _k in per_op)
    torch.cuda.synchronize()
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
            "top_device_ops": [{"op": k[:70], "s": us / 1e6}
                               for us, k in per_op[:4]]}


def form_busy(eng, name: str, form: str) -> dict:
    """One query's idle share and top device ops (``busy_share``)."""
    return busy_share(lambda: _run_form(eng, name, form))


def probe_uint64(device) -> dict:
    """Which PyTorch ops this card's build has for torch.uint64 (the
    planes of a UINT128 column). The port uses none of them on the
    card: it gathers, scatters, sorts and shifts through int64 views."""
    import torch

    u = torch.tensor([1, 2, 3, 5], dtype=torch.int64, device=device).view(
        torch.uint64)
    i = torch.tensor([0, 2], device=device)
    ops = {
        "index_select": lambda: u.index_select(0, i),
        "getitem": lambda: u[i],
        "index_put": lambda: u.clone().index_put_((i,), u[:2]),
        "scatter": lambda: u.clone().scatter_(0, i, u[:2]),
        "rshift": lambda: u >> 32,
        "bitwise_and": lambda: u & u,
        "eq": lambda: u == u,
        "lt": lambda: u < u,
        "argsort": lambda: torch.argsort(u, stable=True),
        "cat": lambda: torch.cat([u, u]),
        "where": lambda: torch.where(u == u, u, u),
        "maximum": lambda: torch.maximum(u, u),
        "full": lambda: torch.full((4,), 7, dtype=torch.uint64, device=device),
    }
    res = {}
    for k, f in ops.items():
        try:  # a missing kernel raises before any launch
            f()
            torch.cuda.synchronize(device)
            res[k] = "ok"
        except (RuntimeError, NotImplementedError, TypeError) as e:
            res[k] = f"{type(e).__name__}: {str(e)[:60]}"
    return res


def phase_group_by(device) -> dict:
    """The group-by without a dense key domain: a 2^23-row process_stats
    replay (20,000 upids in 2,000 pods) resident in 4 windows, and the
    upid-keyed scripts plus rss p50/p99 by upid, each checked against
    numpy. Per query: seconds in three turns per groupby_impl form,
    rows/s, rebuckets (the planner's 4096 groups climb to 32768), host
    syncs per window, hist_fold launches (counters set to 0 just before
    the measured query, read just after) and the card's idle share."""
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    print(json.dumps({"phase": "group_by_uint64_ops",
                      "ops": probe_uint64(device)}))
    t0 = time.perf_counter()
    ps = make_process_stats(GB_ROWS)
    expect = GroupByExpect(ps)
    make_secs = time.perf_counter() - t0
    eng = load_process_stats(ps, device)
    table = eng.tables["process_stats"]
    print(json.dumps({"phase": "group_by_append", "rows": GB_ROWS,
                      "replay_and_numpy_secs": make_secs,
                      "secs": eng.append_secs,
                      "resident_bytes": table.resident_bytes}))
    assert table.resident_bytes == GB_ROWS * GB_ROW_BYTES, table.resident_bytes

    # The upid through a filter to the host, in row order, bit for bit.
    eng.execute_query(BIG_PROCESSES)
    t0 = time.perf_counter()
    out = eng.execute_query(BIG_PROCESSES)["output"].to_pydict(
        decode_strings=False)
    secs = time.perf_counter() - t0
    idx = np.flatnonzero(ps["cols"]["rss_bytes"] > 4_000_000_000)[:1000]
    assert len(idx) == 1000 and out["upid"].dtype == np.uint64
    np.testing.assert_array_equal(out["upid"][:, 0], ps["hi"][ps["u"][idx]])
    np.testing.assert_array_equal(out["upid"][:, 1], ps["lo"][ps["u"][idx]])
    for c, _t in PROCESS_STATS:
        if c != "upid":
            np.testing.assert_array_equal(out[c], ps["cols"][c][idx],
                                          err_msg=c)
    print(json.dumps({"phase": "group_by_rows", "rows_out": len(idx),
                      "secs": secs, "checked": True}))

    launches = {}
    for name in GB_QUERIES:
        for form in GB_FORMS:  # warm-up, checked
            out, _secs = _run_form(eng, name, form)
            expect.check(name, out)
        secs = {f: [] for f in GB_FORMS}
        rec = {"phase": "group_by", "query": name}
        for form in GB_TURNS:
            dense_fold.launches = 0
            hist_fold.launches = 0
            out, t = _run_form(eng, name, form)
            counts = {"dense_fold": dense_fold.launches,
                      "hist_fold": hist_fold.launches}
            expect.check(name, out)
            st = eng.last_stats
            secs[form].append(t)
            rec[form] = {
                "rebuckets": st.rebuckets, "windows_folded": st.windows,
                "resident_windows": st.resident_windows,
                "staged_windows": st.staged_windows, "launches": counts,
            }
            # Four folds of the 4 resident windows; px/pods stages its
            # second aggregate's input (the first one's 20,000 rows).
            assert (st.resident_windows, st.staged_windows) == (
                16, int(name == "px/pods")), rec[form]
        for form in GB_FORMS:
            med = float(np.median(secs[form]))
            rec[form].update({
                "secs": secs[form], "median_secs": med,
                "rows_per_s": GB_ROWS / med,
                **count_syncs(eng, name, form), **form_busy(eng, name, form),
            })
        rec["checked"] = True
        print(json.dumps(rec))
        launches[name] = {f: rec[f]["launches"] for f in GB_FORMS}
        for form in GB_FORMS:  # 4096 -> 8192 -> 16384 -> 32768 groups
            assert rec[form]["rebuckets"] == 3, (name, form, rec[form])
    for form in GB_FORMS:
        assert launches["rss_quantiles"][form]["hist_fold"] > 0, launches
    # The joins phase's query over this phase's resident process_stats.
    rec = service_resource_usage(eng, ps)
    print(json.dumps({"phase": "joins", "query": "px/service_resource_usage",
                      "http_rows": SRU_HTTP_ROWS, **rec}))
    # The metadata phase over this phase's resident process_stats.
    phase_metadata(eng, ps)
    return {f: launches["rss_quantiles"][f]["hist_fold"] for f in GB_FORMS}


# -- joins and unions -----------------------------------------------------------
JOIN_ROWS = 1 << 22  # bench.py's 16M / 4, each side of its join shapes
NFG_ROWS = 1 << 23  # bench.py's 16M / 2 conn_stats rows
NFG_PODS = 48
SRU_HTTP_ROWS = 1 << 16
# px/http_request_stats's table: 2^24 requests over 5 minutes (Pixie's
# scripts default to start_time '-5m'), about 56k requests/s, a share of
# them kubelet /healthz probes.
HTTP_ROWS = 1 << 24
HTTP_SPAN_S = 300
HTTP_T0 = 1_760_000_000 * 1_000_000_000  # October 2025, in ns
HEALTHZ_SHARE = 0.05

# bench.py's ``_JOIN_BOTH_SIDES_QUERY``: group keys from both sides, so
# eager aggregation cannot remove the join.
JOIN_BOTH_SIDES = """import px
l = px.DataFrame(table='conn_l')
r = px.DataFrame(table='conn_r')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby(['b', 'c']).agg(n=('v', px.count), s=('v', px.sum))
px.display(out)
"""

# bench.py's device_join query: rewritten by eager aggregation into the
# fused lookup join.
JOIN_FUSED = """import px
l = px.DataFrame(table='conn_l')
r = px.DataFrame(table='conn_r')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('v', px.count), s=('v', px.sum))
px.display(out)
"""


def join_query(eng, query: str, check, max_rows: int = 10_000,
               strategy: str | None = None, turns: int = 3,
               traced: bool = True) -> dict:
    """One join query: a checked warm-up, ``turns`` timed turns (each
    checked), and with ``traced`` one turn counting host syncs by line
    and one under torch.profiler. The kernels' launch counters are set
    to 0 before the
    timed turns and read after them. ``driver_syncs`` are the syncs made
    inside the device join drivers; per probe window (each dispatch read
    back) they are the join drivers' readbacks and staging copies, the rest
    are the aggregates' finalize reads and the joins' materializations.
    ``windows_folded`` counts the scans' windows and, since the windowed
    join became a trace fragment of its own, each of its live probe
    windows."""
    from pixie_tpu_torch.config import clear_flag, set_flag
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    def run():
        return eng.execute_query(query, max_output_rows=max_rows)["output"]

    if strategy is not None:
        set_flag("join_strategy", strategy)
    try:
        check(run())
        secs = []
        dense_fold.launches = hist_fold.launches = 0
        for _ in range(turns):
            t0 = time.perf_counter()
            out = run()
            secs.append(time.perf_counter() - t0)
            check(out)
        launches = {"dense_fold": dense_fold.launches / turns,
                    "hist_fold": hist_fold.launches / turns}
        jd = eng.last_join_decision
        st = eng.last_stats
        total, in_driver, sites, busy = None, None, {}, {}
        if traced:
            total, in_driver, sites = sync_sites(
                run, fold_fns=("_join_device", "_join_device_windowed"))
            sites = dict(sites.most_common(8))
            busy = busy_share(run)
    finally:
        if strategy is not None:
            clear_flag("join_strategy")
    windows = jd.windows if jd is not None else 0
    return {
        "decision": dataclasses.asdict(jd) if jd is not None else None,
        "secs": secs, "median_secs": float(np.median(secs)),
        "launches_per_query": launches,
        "join_retries": st.join_retries, "rebuckets": st.rebuckets,
        "windows_folded": st.windows,
        "syncs": total, "probe_windows": windows,
        "driver_syncs": in_driver,
        "syncs_per_probe_window": (
            in_driver / windows if windows and traced else None),
        "sync_sites": sites,
        **busy, "checked": True,
    }


def make_http_traffic(n: int, seed: int = SEED + 2):
    """The joins phase's own http_events: bench.py's replay columns, plus
    /healthz probes (path id N_PATHS) on HEALTHZ_SHARE of the rows and
    ``time_`` drawn over HTTP_SPAN_S seconds from HTTP_T0 (sorted), so
    px/http_request_stats sees many 1 s bins and a filter that drops
    rows."""
    svc, path, lat, status = make_replay(n, seed)
    rng = np.random.default_rng(seed)
    path = np.where(rng.random(n) < HEALTHZ_SHARE, N_PATHS, path).astype(np.int32)
    time_ = HTTP_T0 + np.sort(rng.integers(0, HTTP_SPAN_S * 1_000_000_000, n))
    return svc, path, lat, status, time_


def load_http_traffic(traffic, device):
    """An Engine holding ``traffic`` as http_events, appended in
    WINDOW-row batches; its req_path dictionary ends with /healthz."""
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    svc, path, lat, status, time_ = traffic
    rel = Relation([(n, getattr(DataType, t)) for n, t in RELATION])
    dicts = {
        "service": StringDictionary([f"svc-{i}" for i in range(N_SERVICES)]),
        "req_path": StringDictionary(
            [f"/api/v1/ep{i}" for i in range(N_PATHS)] + ["/healthz"]),
    }
    eng = Engine(window_rows=WINDOW, device=device)
    eng.create_table("http_events")
    t0 = time.perf_counter()
    for off in range(0, len(svc), WINDOW):
        s = slice(off, off + WINDOW)
        eng.append_data("http_events", HostBatch(relation=rel, cols={
            "time_": (time_[s],), "latency_ns": (lat[s],),
            "resp_status": (status[s],), "service": (svc[s],),
            "req_path": (path[s],),
        }, length=len(svc[s]), dicts=dicts))
    eng.append_secs = time.perf_counter() - t0
    return eng


def check_http_request_stats(traffic):
    """numpy's px/http_request_stats over ``traffic``: /healthz rows
    dropped, then per (service, 1 s bin) count and mean latency, joined
    to the service's count; frac = count / total."""
    svc, path, lat, _status, time_ = traffic
    keep = path != N_PATHS
    assert 0 < int((~keep).sum()) < len(svc), "no /healthz rows to drop"
    svc, lat, sec = svc[keep], lat[keep], time_[keep] // 1_000_000_000
    sec0 = int(sec.min())
    n_win = int(sec.max()) - sec0 + 1
    assert n_win > 1, "one 1 s bin"
    key = svc.astype(np.int64) * n_win + (sec - sec0)
    cnt = np.bincount(key, minlength=N_SERVICES * n_win)
    mean = np.bincount(key, weights=lat.astype(np.float64),
                       minlength=N_SERVICES * n_win) / np.maximum(cnt, 1)
    total = np.bincount(svc, minlength=N_SERVICES)
    live = np.flatnonzero(cnt)

    def check(out):
        got = out.to_pydict(decode_strings=False)
        assert np.all(got["window"] % 1_000_000_000 == 0), "bin edges"
        gkey = got["service"].astype(np.int64) * n_win + (
            got["window"] // 1_000_000_000 - sec0)
        order = np.argsort(gkey)
        assert np.array_equal(gkey[order], live), "http_request_stats keys"
        np.testing.assert_array_equal(got["n"][order], cnt[live])
        np.testing.assert_allclose(got["lat_mean"][order], mean[live],
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["total"][order],
                                      total[live // n_win])
        np.testing.assert_allclose(got["frac"][order],
                                   cnt[live] / total[live // n_win], rtol=1e-6)
    check.groups = len(live)
    return check


def make_conn_stats(n: int):
    """bench.py's conn_stats recipe (``_shape_net_flow_graph``): seed 11,
    48 pods, pod i owns address i."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, NFG_PODS, n).astype(np.int32)
    dst = rng.integers(0, NFG_PODS, n).astype(np.int32)
    sent = rng.integers(64, 1 << 20, n)
    recv = rng.integers(64, 1 << 20, n)
    return src, dst, sent, recv


def load_conn_stats(cs, device):
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    src, dst, sent, recv = cs
    rel = Relation([("time_", DataType.TIME64NS),
                    ("src_addr", DataType.STRING),
                    ("src_pod", DataType.STRING),
                    ("remote_addr", DataType.STRING),
                    ("bytes_sent", DataType.INT64),
                    ("bytes_recv", DataType.INT64)])
    pods = StringDictionary([f"ns/pod-{i}" for i in range(NFG_PODS)])
    addrs = StringDictionary([f"10.1.{i // 250}.{i % 250}"
                              for i in range(NFG_PODS)])
    eng = Engine(window_rows=WINDOW, device=device)
    eng.create_table("conn_stats")
    t0 = time.perf_counter()
    for off in range(0, len(src), WINDOW):
        s = slice(off, off + WINDOW)
        m = len(src[s])
        eng.append_data("conn_stats", HostBatch(relation=rel, cols={
            "time_": (np.arange(off, off + m, dtype=np.int64),),
            "src_addr": (src[s],), "src_pod": (src[s],),
            "remote_addr": (dst[s],), "bytes_sent": (sent[s],),
            "bytes_recv": (recv[s],),
        }, length=m, dicts={"src_addr": addrs, "src_pod": pods,
                            "remote_addr": addrs}))
    eng.append_secs = time.perf_counter() - t0
    return eng


def check_net_flow_graph(cs):
    src, dst, sent, recv = cs
    key = src.astype(np.int64) * NFG_PODS + dst
    g = NFG_PODS * NFG_PODS
    cnt = np.bincount(key, minlength=g)
    s_sent = np.bincount(key, weights=sent.astype(np.float64), minlength=g)
    s_recv = np.bincount(key, weights=recv.astype(np.float64), minlength=g)

    def check(out):
        got = out.to_pydict(decode_strings=False)
        gkey = got["src_pod"].astype(np.int64) * NFG_PODS + got["src_pod_dst"]
        order = np.argsort(gkey)
        live = np.flatnonzero(cnt)
        assert np.array_equal(gkey[order], live), "net_flow_graph keys"
        np.testing.assert_array_equal(got["bytes_sent"][order],
                                      s_sent[live].astype(np.int64))
        np.testing.assert_array_equal(got["bytes_recv"][order],
                                      s_recv[live].astype(np.int64))
    return check


def service_resource_usage(eng, ps: dict) -> dict:
    """px/service_resource_usage on the group_by phase's engine: a small
    http_events table whose pods are drawn from that phase's 2,000 pods
    (service = pod mod 32, its own dictionary of the same names), joined
    to the resident process_stats."""
    from pixie_tpu_torch.scripts import load_script
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    rng = np.random.default_rng(SEED + 5)
    n = SRU_HTTP_ROWS
    pod = rng.integers(0, GB_PODS, n).astype(np.int32)
    svc = (pod % N_SERVICES).astype(np.int32)
    rel = Relation([("time_", DataType.TIME64NS),
                    ("latency_ns", DataType.INT64),
                    ("service", DataType.STRING), ("pod", DataType.STRING)])
    eng.append_data("http_events", HostBatch(relation=rel, cols={
        "time_": (np.arange(n, dtype=np.int64),),
        "latency_ns": (rng.integers(1_000, 100_000_000, n),),
        "service": (svc,), "pod": (pod,),
    }, length=n, dicts={
        "service": StringDictionary([f"svc-{i}" for i in range(N_SERVICES)]),
        "pod": StringDictionary(ps["pods"]),
    }))
    u, cols, pod_of = ps["u"], ps["cols"], ps["pod_of"]
    row_pod = pod_of[u]
    ut = np.bincount(row_pod, weights=cols["cpu_utime_ns"].astype(np.float64),
                     minlength=GB_PODS)
    kt = np.bincount(row_pod, weights=cols["cpu_ktime_ns"].astype(np.float64),
                     minlength=GB_PODS)
    rss = np.full(GB_PODS, np.iinfo(np.int64).min, dtype=np.int64)
    np.maximum.at(rss, row_pod, cols["rss_bytes"])
    reqs = np.bincount(pod, minlength=GB_PODS)
    seen = reqs > 0
    psvc = np.arange(GB_PODS) % N_SERVICES
    want = {
        "cpu_utime_ns": np.bincount(psvc[seen], weights=ut[seen],
                                    minlength=N_SERVICES),
        "cpu_ktime_ns": np.bincount(psvc[seen], weights=kt[seen],
                                    minlength=N_SERVICES),
        "rss": np.bincount(psvc[seen], weights=rss[seen].astype(np.float64),
                           minlength=N_SERVICES),
        "requests": np.bincount(psvc, weights=reqs, minlength=N_SERVICES),
    }

    def check(out):
        got = out.to_pydict(decode_strings=False)
        order = np.argsort(got["service"])
        assert np.array_equal(got["service"][order], np.arange(N_SERVICES))
        for c, w in want.items():
            # float64 numpy sums of int64 values up to ~1e19: compare in
            # float64 (the card's int64 sums are exact).
            np.testing.assert_allclose(got[c][order].astype(np.float64), w,
                                       rtol=1e-12, err_msg=c)

    rec = join_query(eng, load_script("px/service_resource_usage").pxl, check)
    assert rec["decision"]["strategy"] == "host_dict", rec["decision"]
    return rec


def make_join_shape(shape: str, n: int):
    """bench.py's join replays: ``device_join`` (seed 19), ``skew``
    (``device_join_skew``, seed 23, zipf build keys) and ``select``
    (``device_join_select``, seed 29, ascending probe keys, the build
    side over the top eighth of the key space)."""
    if shape == "device_join":
        rng = np.random.default_rng(19)
        n_keys = max(n // 2, 1)
        lk = rng.integers(0, n_keys, n)
        lb = rng.integers(0, 16, n)
        rk = rng.integers(0, n_keys, n)
        rv = rng.integers(0, 1000, n)
        rc = np.zeros(n, dtype=np.int64)
    elif shape == "skew":
        rng = np.random.default_rng(23)
        n_keys = max(n // 2, 1)
        lk = rng.integers(0, n_keys, n)
        lb = rng.integers(0, 16, n)
        rk = (np.minimum(rng.zipf(1.5, n), n_keys) - 1) * 2654435761 % n_keys
        rc = rng.integers(0, 8, n)
        rv = rng.integers(0, 1000, n)
    else:
        rng = np.random.default_rng(29)
        n_keys = max(n // 2, 2)
        lk = (np.arange(n, dtype=np.int64) * n_keys) // n + rng.integers(
            0, max(n_keys // 256, 1), n)
        np.minimum(lk, n_keys - 1, out=lk)
        lb = rng.integers(0, 16, n)
        n_r = max(n // 4, 1)
        rk = rng.integers(n_keys - n_keys // 8, n_keys, n_r)
        rc = rng.integers(0, 8, n_r)
        rv = rng.integers(0, 1000, n_r)
    return {"n_keys": n_keys, "lk": lk, "lb": lb, "rk": rk, "rc": rc,
            "rv": rv}


def load_join_tables(js: dict, device):
    """conn_l(time_, k, b) and conn_r(time_, k, c, v) in WINDOW-row
    appends (bench.py's ``_join_two_table_engines``)."""
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.types import DataType, HostBatch, Relation

    eng = Engine(window_rows=WINDOW, device=device)
    t0 = time.perf_counter()
    for name, cols in (
        ("conn_l", {"k": js["lk"], "b": js["lb"]}),
        ("conn_r", {"k": js["rk"], "c": js["rc"], "v": js["rv"]}),
    ):
        rel = Relation([("time_", DataType.TIME64NS)]
                       + [(c, DataType.INT64) for c in cols])
        eng.create_table(name)
        n = len(cols["k"])
        for off in range(0, n, WINDOW):
            m = min(WINDOW, n - off)
            planes = {"time_": (np.arange(off, off + m, dtype=np.int64),)}
            planes.update({c: (v[off:off + m],) for c, v in cols.items()})
            eng.append_data(name, HostBatch(relation=rel, cols=planes,
                                            length=m))
    eng.append_secs = time.perf_counter() - t0
    return eng


def check_join_fused(js: dict):
    """bench.py's device_join check: per b, the count and sum of the
    build rows each probe row meets."""
    lk, lb, rk, rv, n_keys = (js[k] for k in ("lk", "lb", "rk", "rv",
                                                "n_keys"))
    cnt_r = np.bincount(rk, minlength=n_keys)
    sum_r = np.bincount(rk, weights=rv.astype(np.float64), minlength=n_keys)
    ref_n = np.bincount(lb, weights=cnt_r[lk].astype(np.float64), minlength=16)
    ref_s = np.bincount(lb, weights=sum_r[lk], minlength=16)

    def check(out):
        got = out.to_pydict()
        order = np.argsort(got["b"])
        present = np.nonzero(ref_n)[0]
        assert np.array_equal(got["b"][order], present), "join keys mismatch"
        np.testing.assert_allclose(got["n"][order], ref_n[present], rtol=1e-9)
        np.testing.assert_allclose(got["s"][order], ref_s[present], rtol=1e-9)
    return check


def check_join_both_sides(js: dict):
    """bench.py's ``_check_join_both_sides``: per (b, c), the count and
    sum of the joined rows, from per-key histograms contracted over the
    key axis."""
    lk, lb, rk, rc, rv, n_keys = (js[k] for k in ("lk", "lb", "rk", "rc",
                                                    "rv", "n_keys"))
    nb_, nc_ = 16, 8
    m_l = np.bincount(lk * nb_ + lb, minlength=n_keys * nb_).reshape(
        n_keys, nb_).astype(np.float64)
    cnt_r = np.bincount(rk * nc_ + rc, minlength=n_keys * nc_).reshape(
        n_keys, nc_).astype(np.float64)
    sum_r = np.bincount(rk * nc_ + rc, weights=rv.astype(np.float64),
                        minlength=n_keys * nc_).reshape(n_keys, nc_)
    ref_n = (m_l.T @ cnt_r).reshape(-1)
    ref_s = (m_l.T @ sum_r).reshape(-1)
    present = np.nonzero(ref_n)[0]

    def check(out):
        got = out.to_pydict()
        gkey = got["b"].astype(np.int64) * nc_ + got["c"]
        order = np.argsort(gkey)
        assert np.array_equal(gkey[order], present), "join_both keys mismatch"
        np.testing.assert_allclose(got["n"][order], ref_n[present], rtol=1e-9)
        np.testing.assert_allclose(got["s"][order], ref_s[present], rtol=1e-9)
    return check


def phase_joins_http(device) -> None:
    """px/http_request_stats over its own HTTP_ROWS-row http_events:
    HTTP_SPAN_S seconds of traffic (HTTP_SPAN_S 1 s bins per service)
    with /healthz probes for the script's filter to drop."""
    from pixie_tpu_torch.scripts import load_script

    traffic = make_http_traffic(HTTP_ROWS)
    eng = load_http_traffic(traffic, device)
    print(json.dumps({"phase": "joins_append", "table": "http_events",
                      "rows": HTTP_ROWS, "span_s": HTTP_SPAN_S,
                      "secs": eng.append_secs}))
    check = check_http_request_stats(traffic)
    rec = join_query(eng, load_script("px/http_request_stats").pxl, check,
                     max_rows=2 * N_SERVICES * HTTP_SPAN_S)
    print(json.dumps({"phase": "joins", "query": "px/http_request_stats",
                      "rows": HTTP_ROWS, "groups": check.groups, **rec}))
    assert rec["decision"]["strategy"] == "host_dict", rec["decision"]


def phase_joins(device) -> None:
    """The joins phase's own tables: px/http_request_stats over 2^24
    http_events rows, px/net_flow_graph over 2^23 conn_stats rows, then bench.py's three join shapes at 2^22 rows a
    side (device_join -> fused, skew -> radix, select -> sorted or radix
    with zone-skipped probe windows), and the skew shape again forced to
    single and sorted (one timed turn each)."""
    import gc

    import torch
    from pixie_tpu_torch.scripts import load_script

    phase_joins_http(device)
    gc.collect()
    cs = make_conn_stats(NFG_ROWS)
    eng = load_conn_stats(cs, device)
    print(json.dumps({"phase": "joins_append", "table": "conn_stats",
                      "rows": NFG_ROWS, "secs": eng.append_secs}))
    rec = join_query(eng, load_script("px/net_flow_graph").pxl,
                     check_net_flow_graph(cs))
    print(json.dumps({"phase": "joins", "query": "px/net_flow_graph",
                      "rows": NFG_ROWS, **rec}))
    assert rec["decision"]["strategy"] == "host_dict", rec["decision"]
    del eng, cs
    gc.collect()

    expect = {"device_join": ("fused",), "skew": ("radix",),
              "select": ("sorted", "radix")}
    for shape in ("device_join", "skew", "select"):
        js = make_join_shape(shape, JOIN_ROWS)
        eng = load_join_tables(js, device)
        print(json.dumps({"phase": "joins_append", "shape": shape,
                          "rows": [len(js["lk"]), len(js["rk"])],
                          "secs": eng.append_secs}))
        if shape == "device_join":
            query, check = JOIN_FUSED, check_join_fused(js)
        else:
            query, check = JOIN_BOTH_SIDES, check_join_both_sides(js)
        rec = join_query(eng, query, check)
        print(json.dumps({"phase": "joins", "shape": shape, **rec}))
        d = rec["decision"]
        assert d["strategy"] in expect[shape], d
        if shape == "select":
            assert d["skipped_windows"] > 0, d
        if shape == "skew":
            # auto routes it radix (asserted above); one timed turn each,
            # untraced (the auto route's syncs and idle share are above).
            for forced in ("single", "sorted"):
                rec = join_query(eng, query, check, strategy=forced, turns=1,
                                 traced=False)
                print(json.dumps({"phase": "joins", "shape": shape,
                                  "forced": forced, **rec}))
                assert rec["decision"]["strategy"] == forced, rec["decision"]
        del eng, js
        gc.collect()
        torch.cuda.empty_cache()

# -- the plan analysis layer ------------------------------------------------------
AN_ROWS = 1 << 23
AN_KEYS = 20_000  # distinct INT64 keys in [0, 2^40): no dense domain
AN_MAX_ROWS = 1 << 20  # max_output_rows: every group of the answer
AN_TURNS = 3
AN_AGG = """import px
df = px.DataFrame(table='keyed')
px.display(df.groupby('key').agg(n=('value', px.count), mx=('value', px.max)))
"""
# The N:1 eager-aggregate shape: the build side is the table's own
# group-by on the join key, which the run-time sketches cannot see.
AN_JOIN = """import px
df = px.DataFrame(table='keyed')
agg = df.groupby('key').agg(n=('value', px.count))
j = df.merge(agg, how='inner', left_on='key', right_on='key',
             suffixes=['', '_a'])
px.display(j.groupby('key').agg(rows=('value', px.count), n=('n', px.max)))
"""
AN_BAD = {
    # The frontend binds every column it is given: an unbound column
    # fails there (PxLError), in both packages, before the verifier.
    "unbound_column": ("import px\ndf = px.DataFrame(table='http_events')\n"
                       "df = df[df.nope > 1]\npx.display(df)\n", "PxLError"),
    # A host-dict UDF with a column where a literal belongs passes the
    # frontend; the verifier refuses it (udf-signature).
    "host_dict_column_arg": (
        "import px\ndf = px.DataFrame(table='http_events')\n"
        "df.x = px.pluck(df.req_path, df.req_method)\npx.display(df)\n",
        "PlanCheckError"),
}


def make_keyed(n: int, keys: int, seed: int = SEED + 6) -> dict:
    """``n`` rows of an INT64 key drawn uniformly from ``keys`` distinct
    values in [0, 2^40), an INT64 value, and ``time_``; with numpy's
    answers to AN_AGG (sorted keys, counts, max value per key)."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, 1 << 40, keys + 64))[:keys]
    assert len(pool) == keys
    rng.shuffle(pool)
    key = pool[rng.integers(0, keys, n)].astype(np.int64)
    value = rng.integers(0, 1 << 40, n).astype(np.int64)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    mx = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, value)
    return {"key": key, "value": value, "uniq": uniq, "counts": counts,
            "max": mx}


def load_keyed(kd: dict, device, window: int = WINDOW):
    """An Engine holding ``kd`` as the table ``keyed``, appended in
    ``window``-row batches (residency and ingest sketches on)."""
    from pixie_tpu_torch import Engine

    n = len(kd["key"])
    eng = Engine(window_rows=window, device=device)
    t0 = time.perf_counter()
    for off in range(0, n, window):
        s = slice(off, min(off + window, n))
        eng.append_data("keyed", {
            "time_": np.arange(s.start, s.stop, dtype=np.int64),
            "key": kd["key"][s], "value": kd["value"][s]})
    eng.append_secs = time.perf_counter() - t0
    return eng


def _sorted_out(out, by: str) -> dict:
    d = out.to_pydict()
    order = np.argsort(d[by], kind="stable")
    return {c: np.asarray(v)[order] for c, v in d.items()}


def _compiled_max_groups(eng, query: str) -> list:
    """The max_groups of each AggOp of ``query`` as the engine compiles
    it (its schemas, registry and sketch snapshot)."""
    from pixie_tpu_torch.exec.plan import AggOp
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    plan = compile_pxl(query, CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, max_output_rows=AN_MAX_ROWS,
        table_stats=eng._compile_table_stats())).plan
    return [plan.nodes[nid].op.max_groups for nid in plan.topo_order()
            if isinstance(plan.nodes[nid].op, AggOp)]


def phase_analysis(device, rows: int = AN_ROWS, keys: int = AN_KEYS,
                   window: int = WINDOW, turns: int = AN_TURNS) -> dict:
    """(a) Group presizing: ``rows`` rows of ``keys`` distinct INT64 keys
    in ``window``-row resident windows, AN_AGG with ``bounds_presize`` on
    and off, each answer equal to numpy's, with the compiled max_groups,
    the rebuckets, the windows folded and the seconds per query (median
    of ``turns`` after a warm-up). (b) Planned join capacity: AN_JOIN,
    checked against numpy, with the plan's join capacity beside the
    join's decision and retries. Returns the printed records."""
    from pixie_tpu_torch.config import override_flag

    t0 = time.perf_counter()
    kd = make_keyed(rows, keys)
    eng = load_keyed(kd, device, window)
    sk = eng._compile_table_stats()["keyed"]
    print(json.dumps({"phase": "analysis_append", "rows": rows,
                      "keys": keys, "secs": eng.append_secs,
                      "make_secs": time.perf_counter() - t0 - eng.append_secs,
                      "sketch_rows": sk["rows"], "key_ndv": sk["ndv"]["key"]}))

    def check_agg(out):
        got = _sorted_out(out, "key")
        np.testing.assert_array_equal(got["key"], kd["uniq"])
        np.testing.assert_array_equal(got["n"], kd["counts"])
        np.testing.assert_array_equal(got["mx"], kd["max"])

    def check_join(out):
        got = _sorted_out(out, "key")
        np.testing.assert_array_equal(got["key"], kd["uniq"])
        np.testing.assert_array_equal(got["rows"], kd["counts"])
        np.testing.assert_array_equal(got["n"], kd["counts"])

    def timed(query, check):
        check(eng.execute_query(query, max_output_rows=AN_MAX_ROWS)["output"])
        secs = []
        for _ in range(turns):
            t1 = time.perf_counter()
            out = eng.execute_query(query, max_output_rows=AN_MAX_ROWS)
            secs.append(time.perf_counter() - t1)
            check(out["output"])
        return secs

    recs = {}
    for presize in (True, False):
        with override_flag("bounds_presize", presize):
            secs = timed(AN_AGG, check_agg)
            st, rep = eng.last_stats, eng.last_resource_report
            rec = {"phase": "analysis_presize", "bounds_presize": presize,
                   "max_groups": _compiled_max_groups(eng, AN_AGG),
                   "agg_groups_bound": list(rep.agg_groups.values()),
                   "rebuckets": st.rebuckets, "windows_folded": st.windows,
                   "resident_windows": st.resident_windows,
                   "rows_folded": st.rows, "secs": secs,
                   "median_secs": float(np.median(secs)), "checked": True}
        print(json.dumps(rec))
        recs[presize] = rec
    on, off = recs[True], recs[False]
    # 20,000 keys x 1.25 -> 32768 groups at once; the ladder climbs
    # 4096 -> 8192 -> 16384 -> 32768 without the sketches' bound.
    assert on["rebuckets"] == 0 and off["rebuckets"] > 0, (on, off)
    assert on["max_groups"][0] > off["max_groups"][0] == 4096, (on, off)

    secs = timed(AN_JOIN, check_join)
    st, rep, jd = eng.last_stats, eng.last_resource_report, eng.last_join_decision
    rec = {"phase": "analysis_join_capacity",
           "planned_join_capacity": {str(k): v
                                     for k, v in rep.join_capacity.items()},
           "decision": dataclasses.asdict(jd) if jd is not None else None,
           "join_retries": st.join_retries, "rebuckets": st.rebuckets,
           "windows_folded": st.windows, "secs": secs,
           "median_secs": float(np.median(secs)), "checked": True}
    print(json.dumps(rec))
    recs["join"] = rec
    assert rep.join_capacity, rep
    return recs


def check_verifier_on_card(eng) -> dict:
    """Each AN_BAD script raises its error from ``execute_query`` before
    anything runs: ``last_stats`` is not replaced (no plan executed), no
    window is staged (every table's device cache keeps its windows) and
    the card's allocation does not move."""
    import torch

    from pixie_tpu_torch.planner import PxLError

    cuda = eng.device.type == "cuda"
    out = {}
    for name, (q, error) in AN_BAD.items():
        before = eng.last_stats
        cached = {n: list(t._device_cache.keys())
                  for n, t in eng.tables.items()}
        if cuda:
            torch.cuda.synchronize()
            mem = torch.cuda.memory_allocated()
        try:
            eng.execute_query(q)
        except PxLError as e:
            assert type(e).__name__ == error, (name, type(e).__name__, e)
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[-1].strip()}"
        else:
            raise AssertionError(f"{name}: the bad script ran")
        assert eng.last_stats is before, name
        assert {n: list(t._device_cache.keys())
                for n, t in eng.tables.items()} == cached, name
        if cuda:
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() <= mem, name
    return out


def compile_costs(eng, pxl: str) -> dict:
    """``compile_pxl`` on the engine's schemas, registry and sketch
    snapshot, as ``Engine.execute_query`` calls it: cold (both analysis
    memos cleared) and the median of three warm compiles, in ms, each
    with the snapshot taken (``stats_ms`` alone); and one uncached run
    each of the verifier's walk and the bounds walk over the compiled
    plan."""
    from pixie_tpu_torch.analysis import bounds, verifier
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    def compile_once():
        return compile_pxl(pxl, CompilerState(
            schemas={n: t.relation for n, t in eng.tables.items()},
            registry=eng.registry, now_ns=0, max_output_rows=10_000,
            table_stats=eng._compile_table_stats()))

    verifier._VERIFY_CACHE.clear()
    bounds._BOUNDS_CACHE.clear()
    verifier._UDA_PROTOCOL_CACHE.clear()
    t0 = time.perf_counter()
    compiled = compile_once()
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        compile_once()
        warm.append(time.perf_counter() - t0)
    schemas = {n: t.relation for n, t in eng.tables.items()}
    t0 = time.perf_counter()
    stats = eng._compile_table_stats()
    snapshot = time.perf_counter() - t0
    t0 = time.perf_counter()
    diags = verifier.verify_plan(compiled.plan, schemas, eng.registry)
    verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    bounds.plan_bounds(compiled.plan, schemas, eng.registry, stats)
    walk = time.perf_counter() - t0
    errors = [d.render() for d in diags
              if d.severity == verifier.Severity.ERROR]
    assert not errors, errors
    return {"compile_cold_ms": cold * 1e3,
            "compile_warm_ms": float(np.median(warm)) * 1e3,
            "stats_ms": snapshot * 1e3, "verify_ms": verify * 1e3,
            "bounds_ms": walk * 1e3, "verify_warnings": len(diags)}


def observed_groups(eng, plan, nids) -> dict:
    """The groups each AggOp ``nid`` of ``plan`` really makes: the plan
    cut after the node, with a result sink on it, run on the engine."""
    from pixie_tpu_torch.exec.plan import Plan, ResultSinkOp

    out = {}
    for nid in nids:
        keep, stack = set(), [nid]
        while stack:
            i = stack.pop()
            if i not in keep:
                keep.add(i)
                stack.extend(plan.nodes[i].inputs)
        sub = Plan()
        sub.nodes = {i: plan.nodes[i] for i in sorted(keep)}
        sink = max(plan.nodes) + 1
        sub.nodes[sink] = type(plan.nodes[nid])(
            id=sink, op=ResultSinkOp(name="groups"), inputs=[nid])
        out[nid] = eng.execute_plan(sub)["groups"].length
    return out


def bounds_against_observation(eng, pxl: str, peak_bytes: int) -> dict:
    """For the last query the engine ran (``pxl``, its report bounded):
    the rows it folded against ``rows_in_hi`` x ``bounds_safety``, each
    aggregate's groups against its ``agg_groups`` bound x
    ``bounds_safety`` (the NDV bound is an HLL estimate, ~3% either
    way, so the raw ratio is printed too), and the card's allocation
    peak during the query against ``peak_node_bytes_hi`` (printed, not
    held)."""
    from pixie_tpu_torch.config import get_flag
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    rep, st = eng.last_resource_report, eng.last_stats
    safety = float(get_flag("bounds_safety"))
    rec = {"rows": st.rows, "rows_in_hi": rep.rows_in_hi,
           "peak_bytes": peak_bytes,
           "peak_node_bytes_hi": rep.peak_node_bytes_hi,
           "peak_ratio": (peak_bytes / rep.peak_node_bytes_hi
                          if rep.peak_node_bytes_hi and peak_bytes is not None
                          else None)}
    if rep.rows_in_hi is not None:
        rec["rows_ratio"] = st.rows / rep.rows_in_hi
        assert st.rows <= rep.rows_in_hi * safety, rec
    if rep.agg_groups:
        plan = compile_pxl(pxl, CompilerState(
            schemas={n: t.relation for n, t in eng.tables.items()},
            registry=eng.registry, now_ns=0, max_output_rows=10_000,
            table_stats=eng._compile_table_stats())).plan
        assert plan.resource_report.agg_groups == rep.agg_groups
        seen = observed_groups(eng, plan, list(rep.agg_groups))
        rec["groups"] = {str(nid): [seen[nid], bound]
                         for nid, bound in rep.agg_groups.items()}
        rec["groups_ratio_max"] = max(
            seen[nid] / bound for nid, bound in rep.agg_groups.items())
        for nid, bound in rep.agg_groups.items():
            assert seen[nid] <= bound * safety, (nid, seen[nid], bound)
    return rec


# -- the shipped library ----------------------------------------------------------
LIB_HTTP_ROWS = 1 << 21  # cut from 2^22 for the time limit; http_events'
# 512 MiB budget would hold 7.9M rows
LIB_TELEMETRY_ROWS = 4096
LIB_VOCAB = 3000  # _seed_all_tables' n: its per-row strings take this many values
LIB_APPEND_ROWS = 1 << 20
LIB_SKIP = {"px/agent_status": "GetAgentStatus asks the agent tracker: "
                               "it runs in the cluster phase"}
LIB_FLOAT_RTOL, LIB_QUANTILE_RTOL = 1e-5, 0.05
LIB_QUANTILE_UDAS = ("quantiles",) + tuple(
    f"_quantile_{f}" for f in ("p01", "p10", "p25", "p50", "p75", "p90", "p99"))


def _lib_tables(n_of, seed: int = SEED + 4) -> dict:
    """Every canonical table's rows in the vocabularies of the JAX
    package's script harness (``tests/test_scripts.py``
    ``_seed_all_tables``), at ``n_of(table)`` rows each: {table: {col:
    array}}, a STRING column as (ids, vocabulary). Its per-row strings
    (``SELECT ... id={i}``) cycle through LIB_VOCAB values, the number
    the harness makes; times are 1 ms apart."""
    rng = np.random.default_rng(seed)
    out = {}

    def table(name, cols):
        out[name] = cols

    for name in ("http_events", "conn_stats", "stack_traces.beta",
                 "mysql_events", "pgsql_events", "redis_events",
                 "kafka_events.beta", "cql_events", "nats_events.beta",
                 "mux_events", "amqp_events", "process_stats",
                 "network_stats", "dns_events", "proc_stat",
                 "bcc_pid_cpu_usage", "proc_exit_events", "stirling_error",
                 "__queries__", "__tables__", "__spans__", "__agents__",
                 "__programs__", "__stacks__", "__bus__"):
        n = n_of(name)
        i = np.arange(n)

        def ints(lo, hi):
            return rng.integers(lo, hi, n)

        def pick(vals):
            vals = list(vals)
            idx = rng.integers(0, len(vals), n)
            if isinstance(vals[0], str):
                return idx.astype(np.int32), vals
            return np.asarray(vals)[idx]

        def cyc(fmt, k, key=lambda j: (j,)):
            """Row i takes string i % k (duplicates share one id)."""
            k = min(k, n)
            strs = [fmt.format(*key(j)) for j in range(k)]
            vocab = list(dict.fromkeys(strs))
            pos = {v: x for x, v in enumerate(vocab)}
            code = np.array([pos[v] for v in strs], dtype=np.int32)
            return code[i % k], vocab

        def const(s):
            return np.zeros(n, np.int32), [s]

        def lat(lo, hi):
            return ints(lo, hi).astype(np.int64)

        t = i.astype(np.int64) * 10**6
        upid = (np.ones(n, np.uint64), ints(1, 50).astype(np.uint64))
        pods, svcs = cyc("ns/pod-{}", 6), cyc("svc-{}", 4)
        if name == "http_events":
            table(name, {
                "time_": t, "upid": upid, "remote_addr": cyc("10.0.0.{}", 9),
                "req_method": cyc("{}", 2, lambda j: (("GET", "POST")[j],)),
                "req_path": cyc("/ep{}", 6),
                "resp_status": pick([200, 200, 200, 404, 500]),
                "resp_body_size": ints(1, 4096), "latency_ns": lat(10**5, 10**9),
                "service": svcs, "pod": pods})
        elif name == "conn_stats":
            table(name, {
                "time_": t, "upid": upid, "remote_addr": cyc("10.0.1.{}", 7),
                "remote_port": ints(1024, 65535), "trace_role": pick([1, 2]),
                "addr_family": np.full(n, 2, np.int64), "protocol": pick([0, 1]),
                "ssl": pick([True, False]), "conn_open": ints(0, 3),
                "conn_close": ints(0, 3), "conn_active": ints(0, 5),
                "bytes_sent": ints(0, 10**6), "bytes_recv": ints(0, 10**6),
                "src_addr": cyc("10.0.1.{}", 7), "src_pod": pods})
        elif name == "stack_traces.beta":
            table(name, {
                "time_": t, "upid": upid, "stack_trace_id": ints(0, 40),
                "stack_trace": cyc("main;f{};g{}", 65, lambda j: (j % 5, j % 13)),
                "count": ints(1, 30), "pod": pods})
        elif name == "mysql_events":
            table(name, {
                "time_": t, "upid": upid, "req_cmd": np.full(n, 3, np.int64),
                "query_str": cyc("SELECT * FROM t WHERE id={}", LIB_VOCAB),
                "resp_status": pick([2, 2, 2, 3]),
                "latency_ns": lat(10**4, 10**8), "service": svcs})
        elif name == "pgsql_events":
            table(name, {
                "time_": t, "upid": upid,
                "req_cmd": cyc("{}", 2, lambda j: (("QUERY", "EXECUTE")[j],)),
                "req": cyc("SELECT {};", LIB_VOCAB), "resp": const("SELECT 1"),
                "latency_ns": lat(10**4, 10**8), "service": svcs})
        elif name == "redis_events":
            table(name, {
                "time_": t, "upid": upid,
                "req_cmd": cyc("{}", 4, lambda j: (
                    ("GET", "SET", "HGETALL", "INCR")[j],)),
                "req_args": cyc("key{}", 40), "resp": const("OK"),
                "latency_ns": lat(10**3, 10**7), "service": svcs})
        elif name == "kafka_events.beta":
            table(name, {
                "time_": t, "upid": upid, "req_cmd": pick([0, 1, 3, 12]),
                "client_id": cyc("client-{}", 5), "req_body": const("Produce v9"),
                "resp": const("bytes=12"), "latency_ns": lat(10**4, 10**8),
                "service": svcs})
        elif name == "cql_events":
            table(name, {
                "time_": t, "upid": upid, "req_op": pick([7, 9, 10, 13]),
                "req_body": cyc("SELECT * FROM ks.t WHERE id={}", 20),
                "resp_op": pick([8, 8, 8, 0]), "resp_body": const("Rows cols=2"),
                "latency_ns": lat(10**4, 10**8), "service": svcs})
        elif name == "nats_events.beta":
            table(name, {
                "time_": t, "upid": upid,
                "cmd": cyc("{}", 4, lambda j: (("PUB", "MSG", "SUB", "PING")[j],)),
                "body": const('{"subject": "orders"}'),
                "resp": cyc("{}", 2, lambda j: (("OK", "")[j],)),
                "latency_ns": lat(10**3, 10**6), "service": svcs})
        elif name == "mux_events":
            table(name, {
                "time_": t, "upid": upid, "req_type": pick([1, 2, 65]),
                "latency_ns": lat(10**4, 10**8), "service": svcs})
        elif name == "amqp_events":
            table(name, {
                "time_": t, "upid": upid, "channel": ints(1, 8),
                "method": cyc("{}", 3, lambda j: (
                    ("basic.publish", "basic.deliver", "queue.declare")[j],)),
                "resp": const(""), "latency_ns": lat(0, 10**6), "service": svcs})
        elif name == "process_stats":
            table(name, {
                "time_": t, "upid": upid, "major_faults": ints(0, 5),
                "minor_faults": ints(0, 500), "cpu_utime_ns": ints(0, 10**7),
                "cpu_ktime_ns": ints(0, 10**6), "rss_bytes": ints(10**6, 10**9),
                "vsize_bytes": ints(10**7, 10**10), "rchar_bytes": ints(0, 10**6),
                "wchar_bytes": ints(0, 10**6), "read_bytes": ints(0, 10**6),
                "write_bytes": ints(0, 10**6), "pod": pods})
        elif name == "network_stats":
            table(name, {
                "time_": t, "pod_id": cyc("id-{}", 6), "rx_bytes": ints(0, 10**6),
                "rx_packets": ints(0, 10**4), "rx_errors": ints(0, 10),
                "rx_drops": ints(0, 10), "tx_bytes": ints(0, 10**6),
                "tx_packets": ints(0, 10**4), "tx_errors": ints(0, 10),
                "tx_drops": ints(0, 10), "pod": pods})
        elif name == "dns_events":
            table(name, {
                "time_": t, "upid": upid, "req_header": const('{"txid": 1}'),
                "req_body": cyc('{{"queries": ["d{}.example.com"]}}', 8),
                "resp_header": const('{"rcode": 0}'),
                "resp_body": const('{"answers": []}'),
                "latency_ns": lat(10**4, 10**7), "pod": pods})
        elif name == "proc_stat":
            table(name, {
                "time_": t, "system_percent": rng.uniform(0, 30, n),
                "user_percent": rng.uniform(0, 60, n),
                "idle_percent": rng.uniform(10, 100, n)})
        elif name == "bcc_pid_cpu_usage":
            table(name, {
                "time_": t, "pid": ints(1, 50), "runtime_ns": ints(0, 10**10),
                "cmd": cyc("proc-{}", 12)})
        elif name == "proc_exit_events":
            table(name, {
                "time_": t, "upid": upid, "exit_code": pick([-1, 0, 1, 137]),
                "signal": pick([-1, 9, 15]), "comm": cyc("proc-{}", 12)})
        elif name == "stirling_error":
            table(name, {
                "time_": t, "upid": upid,
                "source_connector": cyc("{}", 3, lambda j: (
                    ("seq_gen", "proc_stat", "tap")[j],)),
                "status": pick([0, 0, 0, 2]),
                "error": cyc("{}", 2, lambda j: (("", "RuntimeError('boom')")[j],))})
        elif name == "__queries__":
            table(name, {
                "time_": t, "trace_id": cyc("{:032x}", LIB_VOCAB),
                "qid": cyc("{}", 10, lambda j: (("", f"q{j % 5}")[j % 2],)),
                "tenant": cyc("{}", 3, lambda j: (("", "shared", "dash")[j],)),
                "agent_id": cyc("pem-{}", 3),
                "kind": cyc("{}", 3, lambda j: (("query", "fragment", "merge")[j],)),
                "script_hash": cyc("hash-{}", 4), "script": const("import px"),
                "status": cyc("{}", 4, lambda j: (("ok", "ok", "ok", "error")[j],)),
                "duration_ms": rng.uniform(1, 500, n), "rows_in": ints(0, 10**6),
                "rows_out": ints(0, 10**4), "windows": ints(0, 64),
                "bytes_staged": ints(0, 10**8), "device_ms": rng.uniform(0, 100, n),
                "compile_ms": rng.uniform(0, 50, n),
                "stall_ms": rng.uniform(0, 20, n), "wire_bytes": ints(0, 10**6),
                "retries": ints(0, 3), "skipped_windows": ints(0, 8),
                "device_peak_bytes": ints(0, 10**9),
                "predicted_bytes": ints(0, 10**8) * 2,
                "predicted_rows": np.where(i % 4 > 0, ints(1, 10**6) * 2, 0),
                "freshness_lag_ms": rng.uniform(0, 2000, n),
                "cache": cyc("{}", 6, lambda j: (
                    ("", "hit", "miss", "stale", "bypass", "view")[j],))})
        elif name == "__tables__":
            step = (i // 4).astype(np.int64)
            wm0 = np.where(i % 2 == 0, 10**9, 2 * 10**9)
            table(name, {
                "time_": t, "agent_id": cyc("pem-{}", 4, lambda j: (j // 2,)),
                "table": cyc("{}", 2, lambda j: (("http_events", "conn_stats")[j],)),
                "rows": 1000 * (step + 1), "bytes": 64_000 * (step + 1),
                "hot_bytes": 32_000 * (step + 1), "cold_bytes": 32_000 * (step + 1),
                "hot_rows": 500 * (step + 1), "cold_rows": 500 * (step + 1),
                "cold_raw_bytes": 96_000 * (step + 1),
                "cold_demotions_total": 4 * (step + 1),
                "cold_evictions_total": step, "device_bytes": 16_000 * step,
                "rows_total": 2000 * (step + 1), "bytes_total": 128_000 * (step + 1),
                "expired_rows_total": 1000 * step,
                "expired_bytes_total": 64_000 * step,
                "watermark": wm0 + step * 10**8, "min_time": wm0,
                "last_append": wm0 + step * 10**8,
                "ingest_rows_per_s": 1000.0 + 10 * step})
        elif name == "__spans__":
            table(name, {
                "time_": t, "trace_id": cyc("{:032x}", 8),
                "span_id": cyc("{:016x}", LIB_VOCAB),
                "parent_id": cyc("{}", 2 * LIB_VOCAB, lambda j: (
                    ("", f"{j - 1:016x}")[j % 2],)),
                "name": cyc("{}", 4, lambda j: (
                    ("query", "compile", "fragment", "window.compute")[j],)),
                "agent_id": cyc("pem-{}", 3),
                "duration_ms": rng.uniform(0, 100, n)})
        elif name == "__agents__":
            table(name, {
                "time_": t, "agent_id": cyc("pem-{}", 3), "kind": const("pem"),
                "queries_total": i.astype(np.int64) + 1,
                "errors_total": ints(0, 3), "bytes_staged_total": ints(0, 10**9),
                "device_ms_total": rng.uniform(0, 1000, n),
                "wire_bytes_total": ints(0, 10**7)})
        elif name == "__programs__":
            table(name, {
                "time_": t, "agent_id": cyc("pem-{}", 3),
                "program_id": cyc("{:016x}", 6),
                "kind": cyc("{}", 3, lambda j: (
                    ("fragment_update", "fragment_finalize",
                     "join_probe_sorted")[j],)),
                "label": const("MapOp,AggOp"),
                "compiles": np.minimum(i.astype(np.int64) // 6 + 1, 3),
                "hits": i.astype(np.int64), "compile_ms": rng.uniform(1, 500, n),
                "flops": rng.uniform(0, 10**9, n),
                "bytes_accessed": rng.uniform(0, 10**9, n),
                "argument_bytes": ints(0, 10**8), "temp_bytes": ints(0, 10**7),
                "peak_bytes": ints(0, 10**8)})
        elif name == "__stacks__":
            table(name, {
                "time_": t, "agent_id": cyc("pem-{}", 3),
                "stack_trace_id": (i % 9).astype(np.int64),
                "stack_trace": cyc("main;f{};g{}", 65, lambda j: (j % 5, j % 13)),
                "count": ints(1, 30),
                "qid": cyc("{}", 10, lambda j: (("", f"q{j % 5}")[j % 2],)),
                "script_hash": cyc("{}", 12, lambda j: (
                    ("", f"hash-{j % 4}")[j % 3 > 0],)),
                "tenant": cyc("{}", 3, lambda j: (("", "shared", "dash")[j],)),
                "phase": cyc("{}", 4, lambda j: (
                    ("host", "device_dispatch", "stall", "stage")[j],))})
        elif name == "__bus__":
            kinds = [("bus", "agent.heartbeat", "deliver"), ("bus", "query.ack", "pub"),
                     ("rpc", "local", "request"), ("rpc", "127.0.0.1:6100", "request")]
            table(name, {
                "time_": t, "agent_id": cyc("pem-{}", 3),
                "kind": cyc("{}", 4, lambda j: (kinds[j][0],)),
                "topic_class": cyc("{}", 4, lambda j: (kinds[j][1],)),
                "direction": cyc("{}", 4, lambda j: (kinds[j][2],)),
                "msgs": i.astype(np.int64) + 10,
                "bytes": (i.astype(np.int64) + 10) * 128, "errors": ints(0, 3),
                "lag_p50_ms": rng.uniform(0.1, 2, n),
                "lag_p99_ms": rng.uniform(2, 50, n),
                "service_p50_ms": rng.uniform(0.1, 5, n),
                "service_p99_ms": rng.uniform(5, 100, n),
                "queue_high_water": ints(0, 16)})
    return out


def _lib_rows(eng, name: str) -> int:
    """Rows of ``name`` for the library phase: LIB_HTTP_ROWS for
    http_events, LIB_TELEMETRY_ROWS for a telemetry (``__``) table, and
    every other table's budget over its bytes per row as the ring counts
    them, so the table is full and nothing has expired."""
    if name == "http_events":
        return LIB_HTTP_ROWS
    if name.startswith("__"):
        return LIB_TELEMETRY_ROWS
    t = eng.tables[name]
    return t.max_bytes // t._backend.row_bytes


def load_library_tables(engines, n_of) -> dict:
    """``init_schemas`` on each engine (the default budgets), then every
    table's rows appended in LIB_APPEND_ROWS-row batches through
    ``Engine.append_data``; returns {table: rows}."""
    from pixie_tpu_torch.ingest.schemas import init_schemas
    from pixie_tpu_torch.types import DataType, HostBatch, StringDictionary
    from pixie_tpu_torch.types.dtypes import host_dtypes

    for eng in engines:
        init_schemas(eng)
    data = _lib_tables(lambda name: n_of(engines[0], name))
    rows = {}
    for name, cols in data.items():
        rel = engines[0].tables[name].relation
        assert set(cols) == set(rel.column_names), (name, set(rel.column_names) ^ set(cols))
        n = len(cols["time_"])
        dicts = {c: StringDictionary(v[1]) for c, v in cols.items()
                 if rel.col_type(c) == DataType.STRING}
        planes = {}
        for c, dt in rel.items():
            v = cols[c]
            if dt == DataType.STRING:
                planes[c] = (v[0],)
            elif dt == DataType.UINT128:
                planes[c] = v
            else:
                planes[c] = (np.asarray(v).astype(host_dtypes(dt)[0]),)
        for off in range(0, n, LIB_APPEND_ROWS):
            s = slice(off, min(off + LIB_APPEND_ROWS, n))
            hb = HostBatch(relation=rel, cols={
                c: tuple(p[s] for p in ps) for c, ps in planes.items()
            }, length=s.stop - s.start, dicts=dicts)
            for eng in engines:
                eng.append_data(name, hb)
        for eng in engines:
            assert eng.tables[name].num_rows == n, (name, eng.tables[name].num_rows)
            assert eng.tables[name].stats().batches_expired == 0, name
        rows[name] = n
    return rows


def _quantile_columns(plan):
    """(sink name -> the columns derived from a t-digest quantile, whether
    the plan keeps row order: no aggregate, join or union)."""
    from pixie_tpu_torch.exec.plan import AggOp, JoinOp, MapOp, ResultSinkOp, UnionOp
    from pixie_tpu_torch.planner.rules import _expr_columns

    tainted, sinks, ordered = {}, {}, True
    for nid in plan.topo_order():
        node = plan.nodes[nid]
        op = node.op
        t = set().union(*(tainted.get(i, set()) for i in node.inputs))
        if isinstance(op, AggOp):
            ordered = False
            t = {a.out_name for a in op.aggs if a.uda_name in LIB_QUANTILE_UDAS}
        elif isinstance(op, MapOp):
            t = {n for n, e in op.exprs if _expr_columns(e, set()) & t}
        elif isinstance(op, (JoinOp, UnionOp)):
            ordered = False
            t = t | {n + getattr(op, "suffix", "") for n in t}
        elif isinstance(op, ResultSinkOp):
            sinks[op.name] = t
        tainted[nid] = t
    return sinks, ordered


def _row_order(d, rel, loose):
    from pixie_tpu_torch.types import DataType

    keys = []
    for c, dt in rel.items():
        if dt == DataType.UINT128:
            keys += [d[c][:, 0], d[c][:, 1]]
        elif c not in loose and dt != DataType.FLOAT64:
            keys.append(d[c].astype(str) if dt == DataType.STRING else d[c])
    n = len(next(iter(d.values()))) if d else 0
    return np.lexsort(list(reversed(keys))) if keys else np.arange(n)


def check_library_output(what: str, got, ref, loose: set, ordered: bool):
    """One output of a script against the same output of a reference
    engine (the card's against the CPU engine's here; the CPU engine's
    against the JAX package's in ``tests/test_torch_scripts.py``): keys,
    strings and integers exact (count_distinct included), FLOAT64 at
    rtol 1e-5, t-digest-derived columns (and their JSON) at rtol 0.05;
    rows in order for row scripts, else as sets sorted by the exact
    columns. ``loose`` and ``ordered`` come from ``_quantile_columns``."""
    from pixie_tpu_torch.types import DataType

    assert list(got.relation.column_names) == list(ref.relation.column_names), what
    assert got.length == ref.length, (what, got.length, ref.length)
    g, r = got.to_pydict(), ref.to_pydict()
    if not ordered:
        og, orr = (_row_order(g, got.relation, loose),
                   _row_order(r, got.relation, loose))
        g = {k: np.asarray(v)[og] for k, v in g.items()}
        r = {k: np.asarray(v)[orr] for k, v in r.items()}
    for c, dt in got.relation.items():
        assert dt.name == ref.relation.col_type(c).name, f"{what}.{c}"
        if dt == DataType.FLOAT64:
            np.testing.assert_allclose(
                np.asarray(g[c], np.float64), np.asarray(r[c], np.float64),
                rtol=LIB_QUANTILE_RTOL if c in loose else LIB_FLOAT_RTOL,
                equal_nan=True, err_msg=f"{what}.{c}")
        elif dt == DataType.STRING and c in loose:
            for x, y in zip(g[c], r[c]):
                if x != y:
                    dx, dy = json.loads(x), json.loads(y)
                    assert sorted(dx) == sorted(dy), f"{what}.{c}"
                    np.testing.assert_allclose(
                        [dx[k] for k in sorted(dx)], [dy[k] for k in sorted(dy)],
                        rtol=LIB_QUANTILE_RTOL, equal_nan=True,
                        err_msg=f"{what}.{c}")
        else:
            assert np.array_equal(np.asarray(g[c]), np.asarray(r[c])), f"{what}.{c}"


def phase_library(device, n_of=_lib_rows, turns: int = 3) -> dict:
    """The shipped library on a fresh engine with the canonical schemas
    and default budgets: every Stirling table full to its budget (32 MiB
    each; http_events cut to LIB_HTTP_ROWS), the telemetry tables at
    LIB_TELEMETRY_ROWS rows. Each of the 80 scripts (not px/agent_status)
    runs once on a CPU engine over the same rows, then on the card: a
    warm-up and ``turns`` timed turns, each checked against the CPU
    answer, with the kernels' launch counters set to 0 before the timed
    turns and read after them, and one more turn under torch.profiler
    (the card's idle share). The plan analysis on the card's engine:
    the verifier refuses the AN_BAD scripts before anything runs, each
    script verifies clean and its compile is timed (``compile_costs``),
    and the warm-up's folded rows, groups and allocation peak are held
    against its report (``bounds_against_observation``). Returns
    {kernel: {script: launches per query}}."""
    import torch

    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold
    from pixie_tpu_torch.planner import CompilerState, compile_pxl
    from pixie_tpu_torch.scripts import list_scripts, load_script

    t0 = time.perf_counter()
    eng, cpu = Engine(device=device), Engine(device="cpu")
    rows = load_library_tables([eng, cpu], n_of)
    print(json.dumps({"phase": "library_append", "rows": rows,
                      "secs": time.perf_counter() - t0,
                      "resident_bytes": sum(t.resident_bytes
                                            for t in eng.tables.values())}))
    names = [n for n in list_scripts() if n not in LIB_SKIP]
    assert len(names) == 80, len(names)
    print(json.dumps({"phase": "analysis_verifier",
                      "refused": check_verifier_on_card(eng)}))
    launches = {"dense_fold": {}, "hist_fold": {}}
    totals = {"cpu_secs": 0.0, "card_secs": 0.0}
    analysis = []
    for name in names:
        pxl = load_script(name).pxl
        costs = compile_costs(eng, pxl)
        compiled = compile_pxl(pxl, CompilerState(
            schemas={n: t.relation for n, t in eng.tables.items()},
            registry=eng.registry, now_ns=0, max_output_rows=10_000))
        loose, ordered = _quantile_columns(compiled.plan)
        t1 = time.perf_counter()
        ref = cpu.execute_query(pxl)
        cpu_secs = time.perf_counter() - t1

        def run_checked_lib():
            out = eng.execute_query(pxl)
            assert sorted(out) == sorted(ref), name
            for k in out:
                check_library_output(f"{name}:{k}", out[k], ref[k], loose[k],
                                     ordered)
            return out

        if device.type == "cuda":
            mem0 = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        run_checked_lib()
        peak = (torch.cuda.max_memory_allocated(device) - mem0
                if device.type == "cuda" else None)
        observed = bounds_against_observation(eng, pxl, peak)
        secs = []
        dense_fold.launches = hist_fold.launches = 0
        for _ in range(turns):
            t1 = time.perf_counter()
            out = eng.execute_query(pxl)
            secs.append(time.perf_counter() - t1)
        counts = {"dense_fold": dense_fold.launches / turns,
                  "hist_fold": hist_fold.launches / turns}
        for k, v in out.items():
            check_library_output(f"{name}:{k}", v, ref[k], loose[k], ordered)
        busy = busy_share(lambda: eng.execute_query(pxl))
        for k, v in counts.items():
            if v:
                launches[k][name] = v
        med = float(np.median(secs))
        totals["cpu_secs"] += cpu_secs
        totals["card_secs"] += med
        jd = eng.last_join_decision
        analysis.append({**costs, **observed, "median_secs": med})
        print(json.dumps({
            "phase": "library", "script": name, "median_secs": med,
            "secs": secs, "rows_out": {k: v.length for k, v in out.items()},
            "launches": counts, "cpu_engine_secs": cpu_secs,
            "join_strategy": jd.strategy if jd is not None else None,
            "idle_share": busy["idle_share"],
            "device_busy_s": busy["device_busy_s"], "checked": True,
            "analysis": {**costs, **observed}}))
    print(json.dumps({"phase": "library_total", "scripts": len(names),
                      "checked": len(names), **totals,
                      "secs": time.perf_counter() - t0,
                      "scripts_with_dense_fold": len(launches["dense_fold"]),
                      "scripts_with_hist_fold": len(launches["hist_fold"])}))
    assert launches["dense_fold"] and launches["hist_fold"], launches
    print(json.dumps({"phase": "analysis_library",
                      **analysis_summary(analysis)}))
    return launches


def analysis_summary(recs) -> dict:
    """The library's compile costs (median and max, ms, and as a share
    of each script's median query seconds) and its bound ratios."""
    out = {"scripts": len(recs)}
    for k in ("compile_cold_ms", "compile_warm_ms", "stats_ms",
              "verify_ms", "bounds_ms"):
        v = np.array([r[k] for r in recs])
        share = v / 1e3 / np.array([r["median_secs"] for r in recs])
        out[k] = {"median": float(np.median(v)), "max": float(v.max()),
                  "share_median": float(np.median(share)),
                  "share_max": float(share.max())}
    for k in ("rows_ratio", "groups_ratio_max", "peak_ratio"):
        v = [r[k] for r in recs if r.get(k) is not None]
        out[k] = ({"n": len(v), "median": float(np.median(v)),
                   "max": float(max(v))} if v else {"n": 0})
    out["peak_ratio_over_1"] = sum(
        1 for r in recs if (r.get("peak_ratio") or 0) > 1)
    return out


# -- the k8s metadata context ------------------------------------------------------
MD_SERVICES, MD_NAMESPACES, MD_NODES = 200, 20, 50
MD_UNKNOWN_SHARE = 0.01
MD_QUERIES = {
    "service": """import px
df = px.DataFrame(table='process_stats')
df.service = df.ctx['service']
df.rss_mb = df.rss_bytes / 1000000.0
df = df.groupby('service').agg(n=('rss_mb', px.count), rss=('rss_mb', px.mean))
px.display(df)
""",
    "pod": """import px
df = px.DataFrame(table='process_stats')
df.pod_name = df.ctx['pod']
df = df.groupby('pod_name').agg(n=('rss_bytes', px.count))
px.display(df)
""",
    "namespace": """import px
df = px.DataFrame(table='process_stats')
df.ns = df.ctx['namespace']
df.rss_mb = df.rss_bytes / 1000000.0
df = df.groupby('ns').agg(n=('rss_mb', px.count), rss=('rss_mb', px.max))
px.display(df)
""",
}


def metadata_state(ps: dict, seed: int = SEED + 5):
    """A MetadataState over the group_by phase's processes: its GB_PODS
    pods in MD_SERVICES services and MD_NAMESPACES namespaces on
    MD_NODES nodes, every process but a MD_UNKNOWN_SHARE of them known.
    Returns (state, pod of each upid index or -1)."""
    from pixie_tpu_torch.metadata import MetadataState, UPID

    rng = np.random.default_rng(seed)
    md = MetadataState()
    for s in range(MD_SERVICES):
        md.add_service(f"s-{s}", f"svc-{s}", f"ns-{s % MD_NAMESPACES}")
    for p in range(GB_PODS):
        s = p % MD_SERVICES
        md.add_pod(f"p-{p}", f"pod-{p}", f"ns-{s % MD_NAMESPACES}",
                   node_name=f"node-{p % MD_NODES}", service_uids=(f"s-{s}",))
    known = rng.random(GB_UPIDS) >= MD_UNKNOWN_SHARE
    pod_of = np.where(known, ps["pod_of"], -1)
    for u in np.flatnonzero(known):
        hi, lo = int(ps["hi"][u]), int(ps["lo"][u])
        md.add_process(UPID(hi >> 32, hi & 0xFFFFFFFF, lo), f"p-{pod_of[u]}")
    return md, pod_of


def expect_metadata(ps: dict, pod_of, name: str) -> dict:
    """numpy over the same mapping: {key: (count, rss aggregate)}."""
    u = ps["u"]
    pod = pod_of[u]
    svc = np.where(pod >= 0, pod % MD_SERVICES, -1)
    if name == "pod":
        key = pod
        label = lambda k: f"ns-{(k % MD_SERVICES) % MD_NAMESPACES}/pod-{k}"
    elif name == "service":
        key = svc
        label = lambda k: f"ns-{k % MD_NAMESPACES}/svc-{k}"
    else:
        key = np.where(svc >= 0, svc % MD_NAMESPACES, -1)
        label = lambda k: f"ns-{k}"
    rss = ps["cols"]["rss_bytes"].astype(np.float32) / np.float32(1e6)
    out = {}
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    if name == "service":
        agg = np.bincount(inv, weights=rss.astype(np.float64)) / cnt
    elif name == "namespace":
        agg = np.full(len(uniq), -np.inf)
        np.maximum.at(agg, inv, rss)
    else:
        agg = np.zeros(len(uniq))
    for k, c, a in zip(uniq, cnt, agg):
        out["" if k < 0 else label(int(k))] = (int(c), float(a))
    return out


def phase_metadata(eng, ps: dict) -> None:
    """df.ctx['service'], ['pod'] and ['namespace'] group-bys over the
    group_by phase's resident process_stats, each checked against numpy
    over the same mapping: a checked warm-up, three timed turns and one
    turn under torch.profiler (the card's idle share)."""
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    t_phase = t0 = time.perf_counter()
    md, pod_of = metadata_state(ps)
    eng.set_metadata_state(md)
    setup = time.perf_counter() - t0
    for name, q in MD_QUERIES.items():
        want = expect_metadata(ps, pod_of, name)

        def check(out):
            d = out.to_pydict()
            key = next(iter(d))
            got = dict(zip(d[key].tolist(), d["n"].tolist()))
            assert got == {k: v[0] for k, v in want.items()}, name
            if "rss" in d:
                for k, v in zip(d[key].tolist(), d["rss"].tolist()):
                    np.testing.assert_allclose(v, want[k][1], rtol=1e-5,
                                               err_msg=f"{name} {k}")

        check(eng.execute_query(q)["output"])
        secs = []
        dense_fold.launches = hist_fold.launches = 0
        for _ in range(3):
            t1 = time.perf_counter()
            out = eng.execute_query(q)["output"]
            secs.append(time.perf_counter() - t1)
            check(out)
        launches = {"dense_fold": dense_fold.launches / 3,
                    "hist_fold": hist_fold.launches / 3}
        st = eng.last_stats
        print(json.dumps({
            "phase": "metadata", "ctx": name, "rows": len(ps["u"]),
            "groups": len(want), "unknown_rows": want.get("", (0, 0))[0],
            "state_secs": setup, "secs": secs,
            "median_secs": float(np.median(secs)),
            "rows_per_s": len(ps["u"]) / float(np.median(secs)),
            "resident_windows": st.resident_windows,
            "staged_windows": st.staged_windows, "launches": launches,
            **busy_share(lambda: eng.execute_query(q)), "checked": True}))
    print(json.dumps({"phase": "metadata_total",
                      "secs": time.perf_counter() - t_phase}))


# -- repeat serving and the storage tiers -------------------------------------------
SV_ROUNDS = 8
SV_COLD_MB = 512
SV_SCRIPTS = ("px/service_stats", "http_stats_float64")
SV_TIER_SCRIPTS = ("px/http_stats", "px/service_stats")
# A selective row chain (latency below 0.1 ms: about 0.1% of the rows).
SV_ROWS_Q = """import px
df = px.DataFrame(table='http_events')
df = df[df.latency_ns < 100000]
px.display(df['time_', 'service', 'latency_ns'])
"""
SV_ROWS_CAP = 1 << 22  # max_output_rows of the row chain's one-shot
SV_KERNEL_SYMBOLS = ("dense_fold_kernel", "fold_ranges", "fold_global")


class RingCensus:
    """The ring every table of the run is created on: wraps
    ``Table._init_backend`` and counts the backend classes, so the run
    can assert that no table but the ring check's own fell to the numpy
    ring."""

    def __init__(self):
        from pixie_tpu_torch.table_store import table as table_mod

        self.counts: dict = {}
        self.numpy_expected = 0
        real = table_mod.Table._init_backend

        def init_backend(t):
            real(t)
            name = type(t._backend).__name__
            self.counts[name] = self.counts.get(name, 0) + 1

        table_mod.Table._init_backend = init_backend

    def check(self) -> dict:
        got = {"native_tables": self.counts.get("_NativeBackend", 0),
               "numpy_tables": self.counts.get("_PyBackend", 0),
               "numpy_expected": self.numpy_expected}
        assert set(self.counts) <= {"_NativeBackend", "_PyBackend"}, self.counts
        assert got["numpy_tables"] == self.numpy_expected, got
        assert got["native_tables"] > 0, got
        return got


def _launch_counts() -> dict:
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    return {"dense_fold": dense_fold.launches, "hist_fold": hist_fold.launches}


def _zero_launches() -> None:
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    dense_fold.launches = 0
    hist_fold.launches = 0
    dense_fold.launches_by_thread.clear()
    hist_fold.launches_by_thread.clear()


def _sv_loose(name: str) -> set:
    return {"p50", "p99"} if name == "px/service_stats" else set()


def sv_check(what: str, name: str, got, want) -> None:
    """An answer of a serving path against the reference engine's
    one-shot answer over the same rows: keys, counts and integers exact,
    FLOAT64 rtol 1e-5, t-digest quantiles rtol 0.05 (the two CUDA
    kernels add f32 values with atomics, and a poll that splits a
    window adds in another order than a rescan)."""
    check_library_output(what, got, want, _sv_loose(name),
                         ordered=name == "rows")


def sv_timed(eng, query: str, **kw):
    """(output, seconds, stats) of one execute_query."""
    t0 = time.perf_counter()
    out = eng.execute_query(query, **kw)["output"]
    return out, time.perf_counter() - t0, eng.last_stats


def sv_append(engines, window: int, start: int, seed: int) -> None:
    """One more window of the replay's recipe, appended to each engine."""
    extra = make_replay(window, seed=seed)
    for e in engines:
        append_replay(e, extra, window, start=start)


def sv_ring(replay, window: int, device, census: RingCensus):
    """The replay appended on the native ring and on the numpy ring
    (selected by patching ``load_native``, as the tests do), in turns
    native, numpy, numpy, native, ingest sketches off; the last native
    engine is the one the other checks hold their answers to."""
    import gc

    from pixie_tpu_torch import native
    from pixie_tpu_torch.table_store import table as table_mod

    native.load("table_ring")  # built already: the turns time appends only
    secs = {"native": [], "numpy": []}
    real = table_mod.load_native
    for ring in ("native", "numpy", "numpy", "native"):
        if ring == "numpy":
            table_mod.load_native = lambda name: None
            census.numpy_expected += 1
        try:
            eng = load_engine(replay, window, device)
        finally:
            table_mod.load_native = real
        backend = eng.tables["http_events"]._backend
        assert isinstance(backend, table_mod._NativeBackend if ring == "native"
                          else table_mod._PyBackend), (ring, backend)
        secs[ring].append(eng.append_secs)
        if ring == "numpy":
            numpy_eng = eng
        else:
            ref = eng
        del eng
        gc.collect()
    want, _s, _st = sv_timed(ref, query_text("px/http_stats"))
    got, _s, _st = sv_timed(numpy_eng, query_text("px/http_stats"))
    sv_check("ring numpy http_stats", "px/http_stats", got, want)
    print(json.dumps({"phase": "serving", "check": "ring",
                      "rows": len(replay[0]), "native_append_secs": secs["native"],
                      "numpy_append_secs": secs["numpy"], "checked": True}))
    return ref


def sv_tier(replay, window: int, device, ref, hot_budget: int,
            cold_mb: int) -> dict:
    """The replay in a tiered table (``hot_budget`` hot, ``cold_mb``
    cold): about half the rows demote and none expires. px/http_stats and
    px/service_stats resident (demoted windows keep their staged device
    windows) and with residency off (cold windows decode on the prefetch
    thread), each equal to the untiered engine's answer."""
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.config import override_flag

    rows = len(replay[0])
    with override_flag("cold_tier_mb", cold_mb):
        eng = Engine(window_rows=window, device=device)
        eng.create_table("http_events", max_bytes=hot_budget)
        secs = append_replay(eng, replay, window)
    t = eng.tables["http_events"]
    st = t.stats()
    assert t._tier is not None
    assert st.rows_expired == 0 and st.evictions == 0, st
    assert st.num_rows == rows and st.cold_rows > 0 and st.hot_rows > 0, st
    rec = {"phase": "serving", "check": "tier", "rows": rows,
           "hot_budget": hot_budget, "cold_tier_mb": cold_mb,
           "append_secs": secs, "hot_rows": st.hot_rows,
           "cold_rows": st.cold_rows, "cold_bytes": st.cold_bytes,
           "cold_raw_bytes": st.cold_raw_bytes,
           "compression": st.cold_raw_bytes / st.cold_bytes,
           "demotions": st.demotions, "queries": []}
    for name in SV_TIER_SCRIPTS:
        q = query_text(name)
        want, ref_secs, _st = sv_timed(ref, q)
        for resident in (True, False):
            with override_flag("device_residency", resident):
                if resident:
                    eng.execute_query(q)  # warm-up
                got, qsecs, qst = sv_timed(eng, q)
            sv_check(f"tier {name} resident={resident}", name, got, want)
            if resident:
                assert (qst.resident_windows, qst.staged_windows,
                        qst.decode_s) == (rows // window, 0, 0.0), qst
            else:
                assert qst.decode_s > 0 and qst.decode_bytes > 0, qst
            rec["queries"].append({
                "script": name, "resident": resident, "secs": qsecs,
                "rows_per_s": qst.rows / qsecs, "decode_s": qst.decode_s,
                "decode_bytes": qst.decode_bytes,
                "resident_windows": qst.resident_windows,
                "staged_windows": qst.staged_windows,
                "untiered_secs": ref_secs, "checked": True})
    print(json.dumps(rec))
    return rec


def sv_result_cache(eng, ref, window: int, start: int, on_card: bool) -> dict:
    """result_cache_mb = 64 on the serving engine: a first run misses, a
    repeat hits without a kernel launch (torch.profiler sees none of
    their symbols), and after one more window http_stats_float64 (no
    manifest, budget 0) is stale while px/service_stats (manifest budget
    5000 ms) is stale exactly when the rows' event time advanced past
    it."""
    from pixie_tpu_torch.config import override_flag
    from pixie_tpu_torch.exec import result_cache as rc

    out = {"phase": "serving", "check": "result_cache", "scripts": {}}
    before = {}
    for name in SV_SCRIPTS:
        q = query_text(name)
        want, ref_secs, _st = sv_timed(ref, q)
        with override_flag("result_cache_mb", 64):
            got, miss_secs, st = sv_timed(eng, q)
            assert st.cache == rc.MISS, st.cache
            sv_check(f"cache miss {name}", name, got, want)
            _zero_launches()
            hit, first_hit_secs, st = sv_timed(eng, q)
            assert st.cache == rc.HIT, st.cache
            hit_secs = []
            for _turn in range(3):
                _o, secs, st = sv_timed(eng, q)
                assert st.cache == rc.HIT, st.cache
                hit_secs.append(secs)
            launches = _launch_counts()
            symbols = []
            if on_card:
                import torch
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    eng.execute_query(q)
                    torch.cuda.synchronize()
                assert eng.last_stats.cache == rc.HIT
                symbols = [e.key for e in prof.key_averages()
                           if any(s in e.key for s in SV_KERNEL_SYMBOLS)]
        assert launches == {"dense_fold": 0, "hist_fold": 0}, launches
        assert symbols == [], symbols
        sv_check(f"cache hit {name}", name, hit, want)
        sha = rc.script_sha(q)[:12]
        entry = next(e for e in eng.result_cache.cachez()["entries"]
                     if e["script_hash"] == sha)
        before[name] = (want, entry)
        out["scripts"][name] = {
            "miss_secs": miss_secs, "first_hit_secs": first_hit_secs,
            "hit_secs": hit_secs, "hit_secs_median": float(np.median(hit_secs)),
            "one_shot_secs": ref_secs, "hit_launches": launches,
            "hit_kernel_symbols": symbols,
            "staleness_budget_ms": entry["staleness_budget_ms"]}
    old_wm = eng._table_watermark_ns("http_events")
    sv_append([eng, ref], window, start, SEED + 30)
    new_wm = eng._table_watermark_ns("http_events")
    for name in SV_SCRIPTS:
        q = query_text(name)
        want_old, entry = before[name]
        advance_ms = (new_wm - entry["watermarks"]["http_events"]) / 1e6
        expect = (rc.STALE if advance_ms > entry["staleness_budget_ms"]
                  else rc.HIT)
        with override_flag("result_cache_mb", 64):
            got, secs, st = sv_timed(eng, q)
        assert st.cache == expect, (name, st.cache, expect, advance_ms)
        if name == "http_stats_float64":
            assert st.cache == rc.STALE, st.cache
        want = want_old if expect == rc.HIT else sv_timed(ref, q)[0]
        sv_check(f"cache after append {name}", name, got, want)
        out["scripts"][name].update({
            "after_append": st.cache, "after_append_secs": secs,
            "event_time_advance_ms": advance_ms,
            "stored_watermark": entry["watermarks"]["http_events"],
            "old_watermark": old_wm, "new_watermark": new_wm})
    with override_flag("result_cache_mb", 64):
        out["cachez"] = {k: v for k, v in eng.result_cache.cachez().items()
                         if k != "entries"}
    out["checked"] = True
    print(json.dumps(out))
    return out


def sv_views(eng, ref, window: int, start: int, on_card: bool) -> dict:
    """view_auto_min_runs = 2, result_cache_mb = 0: the second run of
    each script registers a view (one full fold), and after one more
    window the third run folds that window only (1 dense_fold launch, or
    2 hist_fold) and equals the untiered engine's rescan."""
    from pixie_tpu_torch.config import override_flag
    from pixie_tpu_torch.exec import result_cache as rc

    out = {"phase": "serving", "check": "views", "scripts": {}}
    try:
        for name in SV_SCRIPTS:
            q = query_text(name)
            want, _s, _st = sv_timed(ref, q)
            with override_flag("view_auto_min_runs", 2):
                _got, first_secs, st = sv_timed(eng, q)
                assert st.cache == "", st.cache
                got, reg_secs, st = sv_timed(eng, q)
                assert st.cache == rc.VIEW, st.cache
            sv_check(f"view registration {name}", name, got, want)
            out["scripts"][name] = {"first_secs": first_secs,
                                    "register_secs": reg_secs,
                                    "register_windows": st.windows}
        sv_append([eng, ref], window, start, SEED + 31)
        for name in SV_SCRIPTS:
            q = query_text(name)
            _zero_launches()
            with override_flag("view_auto_min_runs", 2):
                got, refresh_secs, st = sv_timed(eng, q)
            launches = _launch_counts()
            assert st.cache == rc.VIEW, st.cache
            assert (st.windows, st.rows) == (1, window), (st.windows, st.rows)
            if on_card:
                want_launches = ({"dense_fold": 1, "hist_fold": 0}
                                 if name == "http_stats_float64"
                                 else {"dense_fold": 0, "hist_fold": 2})
                assert launches == want_launches, (name, launches)
            want, rescan_secs, rst = sv_timed(ref, q)
            sv_check(f"view refresh {name}", name, got, want)
            out["scripts"][name].update({
                "refresh_secs": refresh_secs, "refresh_windows": st.windows,
                "refresh_rows": st.rows, "refresh_launches": launches,
                "rescan_secs": rescan_secs, "rescan_windows": rst.windows,
                "checked": True})
        out["views"] = eng.views.viewz()
        # Each registered view's stream is a trace in flight.
        open_views = [t["kind"] for t in eng.tracer.in_flight()]
        assert open_views == ["stream"] * len(out["views"]), open_views
    finally:
        eng.views.close()
    left = eng.tracer.in_flight()
    assert left == [], left
    print(json.dumps({"phase": "serving", "check": "view_traces",
                      "open_before_close": len(open_views),
                      "in_flight_after_close": len(left), "checked": True}))
    print(json.dumps(out))
    return out


def sv_streaming(eng, ref, window: int, start: int, rounds: int,
                 on_card: bool) -> dict:
    """stream_query over the serving engine's table: px/service_stats
    (replace) and a filtered row chain (append). Each of ``rounds``
    rounds appends one window and polls both; each poll folds exactly
    the new window, and the last updates equal the reference engine's
    one-shot answers."""
    from pixie_tpu_torch.exec.streaming import stream_query

    streams = {}
    for kind, q in (("px/service_stats", query_text("px/service_stats")),
                    ("rows", SV_ROWS_Q)):
        ups: list = []
        sq = stream_query(eng, q, emit=ups.append)
        t0 = time.perf_counter()
        sq.poll()
        streams[kind] = {"sq": sq, "ups": ups, "query": q,
                         "first_poll_secs": time.perf_counter() - t0,
                         "first_poll_windows": sq.last_stats.windows,
                         "first_poll_rows": sq.last_stats.rows,
                         "polls": []}
    # Both streams' lifecycle traces are in flight while they run.
    in_flight = eng.tracer.in_flight()
    assert sorted((t["kind"], t["id"]) for t in in_flight) == sorted(
        ("stream", s["sq"].trace.trace_id) for s in streams.values()
    ), in_flight
    for r in range(rounds):
        sv_append([eng, ref], window, start + r * window, SEED + 40 + r)
        for kind, s in streams.items():
            _zero_launches()
            t0 = time.perf_counter()
            s["sq"].poll()
            secs = time.perf_counter() - t0
            st = s["sq"].last_stats
            launches = _launch_counts()
            assert (st.windows, st.rows) == (1, window), (kind, st.windows, st.rows)
            if on_card and kind == "px/service_stats":
                assert launches == {"dense_fold": 0, "hist_fold": 2}, launches
            s["polls"].append({"secs": secs, "launches": launches,
                               "windows": st.windows, "rows": st.rows,
                               "resident_windows": st.resident_windows,
                               "staged_windows": st.staged_windows})
    out = {"phase": "serving", "check": "streaming", "rounds": rounds,
           "streams": {}}
    for kind, s in streams.items():
        ups = s["ups"]
        if kind == "rows":
            assert all(u.mode == "append" for u in ups)
            from pixie_tpu_torch.exec.stream import _concat_host

            got = _concat_host([u.batch for u in ups], ups[0].batch.relation)
            want, _s, _st = sv_timed(ref, s["query"], max_output_rows=SV_ROWS_CAP)
            assert want.length < SV_ROWS_CAP
        else:
            assert all(u.mode == "replace" for u in ups)
            got = ups[-1].batch
            want, _s, _st = sv_timed(ref, s["query"])
        sv_check(f"stream {kind}", kind, got, want)
        polls = s["polls"]
        out["streams"][kind] = {
            "updates": len(ups), "rows_out": got.length,
            "first_poll_secs": s["first_poll_secs"],
            "first_poll_windows": s["first_poll_windows"],
            "poll_secs": [p["secs"] for p in polls],
            "poll_secs_median": float(np.median([p["secs"] for p in polls])),
            "launches_per_poll": [p["launches"] for p in polls],
            "windows_per_poll": [p["windows"] for p in polls],
            "rows_per_poll": [p["rows"] for p in polls],
            "staged_per_poll": [p["staged_windows"] for p in polls],
            "checked": True}
    # Closed, each stream's trace ends ok and holds every poll's windows.
    traces = {}
    for kind, s in streams.items():
        s["sq"].close()
        tr = eng.tracer.last()
        windows = s["first_poll_windows"] + sum(p["windows"] for p in s["polls"])
        rows = s["first_poll_rows"] + sum(p["rows"] for p in s["polls"])
        assert (tr.kind, tr.status) == ("stream", "ok"), (tr.kind, tr.status)
        assert (tr.windows, tr.rows_in) == (windows, rows), (
            kind, tr.windows, tr.rows_in, windows, rows)
        traces[kind] = {"windows": tr.windows, "rows_in": tr.rows_in,
                        "fragments": len(tr.stats.fragments),
                        "freshness_lag_ms": tr.usage.freshness_lag_ms}
    assert eng.tracer.in_flight() == [], eng.tracer.in_flight()
    print(json.dumps({"phase": "serving", "check": "stream_traces",
                      "in_flight_while_open": len(in_flight),
                      "traces": traces, "in_flight_after_close": 0,
                      "checked": True}))
    print(json.dumps(out))
    return out


def phase_serving(device, census: RingCensus, rows: int = ROWS,
                  window: int = WINDOW, rounds: int = SV_ROUNDS,
                  hot_budget: int | None = None,
                  cold_mb: int = SV_COLD_MB) -> dict:
    """Repeat serving and the storage tiers over the replay (ingest
    sketches off): the ring, the tier, the result cache, the views and
    the streaming cursors, in that order, every answer held to a fresh
    untiered engine with no cache over the same rows. Returns each
    kernel's launches in the phase's serving runs (view refreshes and
    polls)."""
    from pixie_tpu_torch.config import override_flag

    on_card = device.type == "cuda"
    hot_budget = rows * ROW_BYTES // 2 if hot_budget is None else hot_budget
    t_phase = time.perf_counter()
    with override_flag("ingest_sketches", False):
        replay = make_replay(rows)
        ref = sv_ring(replay, window, device, census)
        sv_tier(replay, window, device, ref, hot_budget, cold_mb)
        eng = load_engine(replay, window, device)
        end = rows
        sv_result_cache(eng, ref, window, end, on_card)
        end += window
        views = sv_views(eng, ref, window, end, on_card)
        end += window
        streaming = sv_streaming(eng, ref, window, end, rounds, on_card)
    launches = {"dense_fold": 0, "hist_fold": 0}
    for rec in views["scripts"].values():
        for k, v in rec["refresh_launches"].items():
            launches[k] += v
    for s in streaming["streams"].values():
        for p in s["launches_per_poll"]:
            for k, v in p.items():
                launches[k] += v
    print(json.dumps({"phase": "serving", "check": "total",
                      "secs": time.perf_counter() - t_phase,
                      "launches": launches}))
    return launches


# -- the cluster phase: agent mode on one card ----------------------------------
CL_PEMS = 4
CL_QUARTER = ROWS // CL_PEMS  # 2^22 rows: 2 resident windows per PEM
CL_HEARTBEAT_S = 1.0
CL_TURNS = 3
CL_SCRIPTS = ("px/http_stats", "http_stats_float64", "px/service_stats",
              "px/http_errors", "px/agent_status")
CL_KERNEL_OF = {"http_stats_float64": "dense_fold",
                "px/service_stats": "hist_fold"}
CL_POLL_S = 0.25


def cl_batches(replay, i: int, lo: int, hi: int, window: int, start: int):
    """Rows [lo, hi) of ``replay`` as PEM ``i``'s append batches: its
    service and path dictionaries list the names in an order of its own
    (rotated by i), so every PEM encodes the same strings to other ids
    and the Kelvin's canonical remap has work to do. ``time_`` counts
    from ``start``."""
    from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

    svc, path, lat, status = replay
    svc_order = np.roll(np.arange(N_SERVICES), 7 * i)
    path_order = np.roll(np.arange(N_PATHS), 3 * i)
    svc_id = np.argsort(svc_order).astype(np.int32)
    path_id = np.argsort(path_order).astype(np.int32)
    rel = Relation([(n, getattr(DataType, t)) for n, t in RELATION])
    dicts = {
        "service": StringDictionary([f"svc-{k}" for k in svc_order]),
        "req_path": StringDictionary([f"/api/v1/ep{k}" for k in path_order]),
    }
    for off in range(lo, hi, window):
        s = slice(off, min(off + window, hi))
        m = s.stop - s.start
        t0 = start + off - lo
        yield HostBatch(relation=rel, cols={
            "time_": (np.arange(t0, t0 + m, dtype=np.int64),),
            "latency_ns": (lat[s],),
            "resp_status": (status[s],),
            "service": (svc_id[svc[s]],),
            "req_path": (path_id[path[s]],),
        }, length=m, dicts=dicts)


def cl_expect_service_stats(replay, rows: slice) -> dict:
    """numpy's px/service_stats over ``rows``, by service name."""
    svc, path, lat, status = replay
    part = (svc[rows], path[rows], lat[rows], status[rows])
    return {f"svc-{s}": v for s, v in expect_service_stats(part).items()}


def cl_check_service_stats(out, want: dict) -> None:
    """A cluster's px/service_stats against numpy: throughput exact,
    error rate rtol 1e-5, p50/p99 rtol 0.05."""
    got = out.to_pydict()
    assert sorted(got["service"]) == sorted(want), "service_stats groups"
    for s, p50, p99, err, thr in zip(got["service"], got["p50"], got["p99"],
                                     got["error_rate"], got["throughput"]):
        r50, r99, rerr, rthr = want[s]
        assert thr == rthr, f"{s} throughput {thr} vs {rthr}"
        np.testing.assert_allclose(err, rerr, rtol=LIB_FLOAT_RTOL)
        np.testing.assert_allclose([p50, p99], [r50, r99],
                                   rtol=LIB_QUANTILE_RTOL, err_msg=s)


def cl_check_agent_status(out, agent_ids) -> None:
    d = out.to_pydict()
    assert sorted(d["agent_id"]) == sorted(agent_ids), d["agent_id"]
    kinds = dict(zip(d["agent_id"], d["kind"]))
    assert all(kinds[a] == ("kelvin" if a.startswith("kelvin") else "pem")
               for a in agent_ids), kinds
    ages = dict(zip(d["agent_id"], d["last_heartbeat_s"]))
    assert all(0 <= a < 3 * CL_HEARTBEAT_S for a in ages.values()), ages


def cl_reference(eng, name: str) -> tuple:
    """The single engine's answer to ``name`` over the same rows, and
    ``check_library_output``'s loose columns and row order."""
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    pxl = query_text(name)
    compiled = compile_pxl(pxl, CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, now_ns=0, max_output_rows=10_000))
    loose, ordered = _quantile_columns(compiled.plan)
    return eng.execute_query(pxl), loose, ordered


def cl_query(c, name: str) -> dict:
    """One broker query and its split: compile and plan (the broker
    trace's start to its dispatch span), the dispatch span, the slowest
    PEM fragment, the Kelvin's merge trace and the bridge bytes."""
    from pixie_tpu_torch.scripts import load_script

    pxl = (load_script(name).pxl if name == "px/agent_status"
           else query_text(name))
    t0 = time.perf_counter()
    res = c.broker.execute_script(pxl, timeout_s=120.0)
    secs = time.perf_counter() - t0
    tr = c.broker.tracer.last()
    disp = next(s for s in tr.spans if s.name == "dispatch")
    frags = {a: st["exec_time_s"] for a, st in res["agent_stats"].items()}
    merge = c.kelvin.engine.tracer.last()
    wire = sum(int(st["usage"]["wire_bytes"])
               for st in res["agent_stats"].values())
    return {
        "res": res, "secs": secs,
        "compile_plan_s": (disp.start_unix_nano - tr.start_unix_nano) / 1e9,
        "dispatch_s": (disp.end_unix_nano - disp.start_unix_nano) / 1e9,
        "slowest_fragment_s": max(frags.values()) if frags else 0.0,
        "merge_s": merge.duration_s if merge.qid == res["qid"] else None,
        "wire_bytes": wire,
    }


def cl_launches(c) -> dict:
    """Kernel launches per PEM (by the bus thread that runs its
    fragments) and in total since the counters were set to 0."""
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    out = {}
    for k, fn in (("dense_fold", dense_fold), ("hist_fold", hist_fold)):
        out[k] = {
            "per_pem": {p.agent_id: fn.launches_by_thread.get(
                f"bus-sub-agent.{p.agent_id}.execute", 0) for p in c.pems},
            "total": fn.launches,
        }
    return out


class Cluster:
    """One in-process bus, an AgentTracker, CL_PEMS PEMAgents and one
    KelvinAgent, each with its own Engine on ``device``, and a
    QueryBroker. ``close`` stops every agent, the tracker and the
    broker and closes the bus."""

    def __init__(self, device, window: int = WINDOW,
                 heartbeat_s: float = CL_HEARTBEAT_S, pems: int = CL_PEMS):
        from pixie_tpu_torch import Engine
        from pixie_tpu_torch.services import (
            AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)

        self.bus = MessageBus()
        self.tracker = AgentTracker(self.bus, expiry_s=60.0,
                                    check_interval_s=60.0)
        self.agents, self.broker = [], None
        try:
            self.pems = []
            for i in range(pems):
                self.pems.append(PEMAgent(
                    self.bus, f"pem-{i}",
                    engine=Engine(window_rows=window, device=device),
                    heartbeat_interval_s=heartbeat_s,
                ))
                self.agents.append(self.pems[-1].start())
            self.kelvin = KelvinAgent(
                self.bus, "kelvin-0",
                engine=Engine(window_rows=window, device=device),
                heartbeat_interval_s=heartbeat_s,
            )
            self.agents.append(self.kelvin.start())
            self.broker = QueryBroker(self.bus, self.tracker)
        except BaseException:
            self.close()
            raise

    def registered(self, table: str, timeout_s: float = 10.0) -> None:
        for p in self.pems:
            p._register()
        deadline = time.monotonic() + timeout_s
        while table not in self.tracker.schemas():
            assert time.monotonic() < deadline, "schemas never registered"
            time.sleep(0.01)

    def close(self) -> None:
        if self.broker is not None:
            self.broker.close()
        for a in self.agents:
            a.stop()
        self.tracker.close()
        self.bus.close()


def cl_check(c, name: str, res, ref) -> None:
    """One cluster answer against the single engine's (``ref`` from
    ``cl_reference``; None for px/agent_status, held to the agents)."""
    if ref is None:
        (hb,) = res["tables"].values()
        cl_check_agent_status(hb, [a.agent_id for a in c.agents])
        return
    ref, loose, ordered = ref
    assert sorted(res["tables"]) == sorted(ref), name
    for k in ref:
        check_library_output(f"cluster {name}:{k}", res["tables"][k], ref[k],
                             loose[k], ordered)
    assert res["distributed_plan"].n_data_shards == len(c.pems)


def cl_enable_telemetry(c) -> None:
    """Self-telemetry on every agent's engine, as a deployed agent starts
    it (the ``self_telemetry`` flag)."""
    from pixie_tpu_torch.services import enable_self_telemetry

    for a in c.agents:
        a.telemetry = enable_self_telemetry(
            a.engine, agent_id=a.agent_id,
            kind="pem" if a.processes_data else "kelvin", bus=c.bus)


def cl_enable_profiling(c) -> None:
    """A self-sampling profiler on every agent's collector, as the
    deployed roles run it (the ``self_profiling`` flag). In one process
    each of the five samples every thread of the process."""
    from pixie_tpu_torch.ingest.profiler import PerfProfilerConnector

    for a in c.agents:
        a.collector.register_source(PerfProfilerConnector(pod=a.agent_id))


def phase_cluster(eng, replay, device, window: int = WINDOW,
                  quarter: int = CL_QUARTER, turns: int = CL_TURNS,
                  profile: bool = True) -> dict:
    """Agent mode on one card: 4 PEMs and a Kelvin, each with its own
    Engine, a tracker and a broker on one bus. The replay is dealt to the
    PEMs as contiguous quarters (each in its own dictionary order); each
    script runs through ``broker.execute_script`` (a warm-up, ``turns``
    timed turns) and is held to the single engine ``eng``'s answer over
    the same rows, first with the agents' self-telemetry and profilers
    off, then with self-telemetry, then with both (as deployed agents
    run): the A/B of their cost. Then
    one PEM dies and is expired, the next px/service_stats replans onto
    3 PEMs (held to numpy over their quarters), and a live
    px/service_stats over the 3 with one more window appended on each
    ends at the one-shot answer. Returns the kernels' launches per PEM
    and in total."""
    from pixie_tpu_torch.config import override_flag

    with override_flag("self_telemetry", False), \
            override_flag("self_profiling", False):
        c = Cluster(device, window=window)
    out = {}
    try:
        t0 = time.perf_counter()
        for i, pem in enumerate(c.pems):
            for hb in cl_batches(replay, i, i * quarter, (i + 1) * quarter,
                                 window, i * quarter):
                pem.append_data("http_events", hb)
        append_s = time.perf_counter() - t0
        c.registered("http_events")
        resident = [p.engine.tables["http_events"].resident_bytes
                    for p in c.pems]
        print(json.dumps({"phase": "cluster_append", "pems": len(c.pems),
                          "rows_per_pem": quarter, "secs": append_s,
                          "resident_bytes": resident}))
        if device.type == "cuda":
            assert resident == [quarter * ROW_BYTES] * len(c.pems), resident
        refs = {name: None if name == "px/agent_status"
                else cl_reference(eng, name) for name in CL_SCRIPTS}
        # The agents' self-observability, turned on step by step: off,
        # then self-telemetry, then the profilers too (as deployed
        # agents run; the phase's main numbers).
        ab = {}
        for variant in ("off", "telemetry"):
            if variant == "telemetry":
                cl_enable_telemetry(c)
            for name in CL_SCRIPTS:
                cl_query(c, name)  # warm-up
                secs = []
                for _ in range(turns):
                    rec = cl_query(c, name)
                    cl_check(c, name, rec["res"], refs[name])
                    secs.append(rec["secs"])
                ab.setdefault(name, {})[variant] = secs
        cl_enable_profiling(c)
        for name in CL_SCRIPTS:
            cl_query(c, name)  # warm-up
            _zero_launches()
            recs = []
            for _ in range(turns):
                recs.append(cl_query(c, name))
                cl_check(c, name, recs[-1]["res"], refs[name])
            launches = cl_launches(c)
            kernel = CL_KERNEL_OF.get(name)
            if kernel is not None and device.type == "cuda":
                per = launches[kernel]["per_pem"]
                assert all(n > 0 for n in per.values()), (name, per)
                out.setdefault(kernel, {})[name] = {
                    "per_pem_per_query": {a: n // turns for a, n in per.items()},
                    "per_query": launches[kernel]["total"] // turns,
                }
            rec = {"phase": "cluster", "script": name, "checked": True,
                   "turns": [r["secs"] for r in recs],
                   "secs": float(np.median([r["secs"] for r in recs]))}
            for k in ("compile_plan_s", "dispatch_s", "slowest_fragment_s",
                      "merge_s", "wire_bytes"):
                vals = [r[k] for r in recs if r[k] is not None]
                rec[k] = float(np.median(vals)) if vals else None
            rec["launches"] = launches
            out.setdefault("turns", {})[name] = {
                k: rec[k] for k in ("secs", "slowest_fragment_s", "merge_s",
                                    "wire_bytes")}
            if profile and device.type == "cuda":
                rec.update(busy_share(lambda: cl_query(c, name)))
            print(json.dumps(rec))
        print(json.dumps({
            "phase": "cluster_telemetry_ab", "turns": turns,
            "scripts": {n: {
                "off_secs": float(np.median(ab[n]["off"])),
                "telemetry_secs": float(np.median(ab[n]["telemetry"])),
                "telemetry_profiling_secs": out["turns"][n]["secs"],
                "off_turns": ab[n]["off"],
                "telemetry_turns": ab[n]["telemetry"]}
                for n in CL_SCRIPTS}}))
        out["off_secs"] = {n: float(np.median(ab[n]["off"])) for n in CL_SCRIPTS}
        out["otel"] = cl_otel(c, replay)
        live = cl_expiry_and_live(c, replay, window, quarter)
        if device.type == "cuda":
            assert live > 0, "the live query launched no hist_fold"
            out["hist_fold"]["live px/service_stats"] = {"total": live}
    finally:
        c.close()
    return out


def cl_expiry_and_live(c, replay, window: int, quarter: int) -> int:
    """The last PEM dies and is expired: px/service_stats replans onto
    the 3 survivors and equals numpy over their quarters. Then a live
    px/service_stats over them; one more window on each live PEM; its
    last update equals the one-shot answer. Returns the live query's
    hist_fold launches."""
    dead = c.pems[-1]
    dead.stop()
    assert c.tracker.force_expire(dead.agent_id)
    live = c.pems[:-1]
    name = "px/service_stats"
    rec = cl_query(c, name)
    assert rec["res"]["distributed_plan"].n_data_shards == len(live)
    assert set(rec["res"]["agent_stats"]) == {p.agent_id for p in live}
    (hb,) = rec["res"]["tables"].values()
    cl_check_service_stats(
        hb, cl_expect_service_stats(replay, slice(0, len(live) * quarter)))
    print(json.dumps({"phase": "cluster_expiry", "script": name,
                      "expired": dead.agent_id, "pems": len(live),
                      "secs": rec["secs"], "wire_bytes": rec["wire_bytes"],
                      "checked": True}))

    from pixie_tpu_torch.exec import tracectx

    ups = []
    _zero_launches()
    # Dispatched inside a broker trace's context: each live PEM's stream
    # trace is a child of it.
    btr = c.broker.tracer.begin_query(script=query_text(name), kind="stream")
    with tracectx.bound(btr.ctx()):
        handle = c.broker.execute_script_streaming(
            query_text(name), ups.append, poll_interval_s=CL_POLL_S)
    try:
        def through(rows: int, timeout_s: float = 60.0):
            deadline = time.monotonic() + timeout_s
            while True:
                errs = [u for u in ups if "error" in u]
                assert not errs, errs[0]["error"]
                batches = [u for u in ups if "batch" in u]
                if batches and int(np.sum(
                        batches[-1]["batch"].to_pydict()["throughput"])) == rows:
                    return batches[-1]
                assert time.monotonic() < deadline, f"no update at {rows} rows"
                time.sleep(0.01)

        t0 = time.perf_counter()
        through(len(live) * quarter)
        first_s = time.perf_counter() - t0
        extra = make_replay(window * len(live), seed=SEED + 20)
        t0 = time.perf_counter()
        for i, pem in enumerate(live):
            lo, hi = i * window, (i + 1) * window
            for b in cl_batches(extra, i, lo, hi, window, ROWS + lo):
                pem.append_data("http_events", b)
        last = through(len(live) * (quarter + window))
        update_s = time.perf_counter() - t0
        launches = cl_launches(c)
        parents = {pem.agent_id: [t.get("parent") for t in
                                  pem.engine.tracer.in_flight()
                                  if t["kind"] == "stream"]
                   for pem in live}
    finally:
        handle.cancel()
    want_parent = btr.ctx()
    assert all(ps == [want_parent] for ps in parents.values()), parents

    def stream_ends():
        ends = {}
        for pem in live:
            if any(t["kind"] == "stream" for t in pem.engine.tracer.in_flight()):
                return None
            ends[pem.agent_id] = next(
                t["status"] for t in pem.engine.tracer.recent()
                if t["kind"] == "stream")
        return ends

    deadline = time.monotonic() + 30.0
    while (ends := stream_ends()) is None:
        assert time.monotonic() < deadline, "stream traces still in flight"
        time.sleep(0.05)
    c.broker.tracer.end_query(btr)
    assert set(ends.values()) == {"cancelled"}, ends
    print(json.dumps({"phase": "cluster_live", "check": "stream_traces",
                      "broker_trace_id": btr.trace_id,
                      "pems_with_child_trace": len(parents),
                      "ends": ends, "checked": True}))
    one_shot = cl_query(c, name)
    (want,) = one_shot["res"]["tables"].values()
    check_library_output(f"cluster live {name}", last["batch"], want,
                         {"p50", "p99"}, False)
    print(json.dumps({"phase": "cluster_live", "script": name,
                      "pems": len(live), "updates": len(ups),
                      "first_update_s": first_s,
                      "append_to_last_update_s": update_s,
                      "hist_fold_launches": launches["hist_fold"]["total"],
                      "one_shot_secs": one_shot["secs"], "checked": True}))
    return launches["hist_fold"]["total"]


ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE_ENV = "PIXIE_TPU_TORCH_DEVICE"  # pixie_tpu_torch.deploy.DEVICE_ENV
PR_EXPIRY_S = 8.0  # the tracker's silence window: above the deployed
#                    Kelvin's 5 s heartbeat, 8 of the workers' 1 s beats
PR_START_S = 180.0  # a child's start: torch, a CUDA context, the replay
PR_WARMUP_S = 120.0  # a script's first query across the cold children
PR_CTL_S = 30.0  # a worker's answer to a counter request


class Children:
    """The processes a phase starts, each with its stdout and stderr in
    files of one temporary directory (never a pipe: an undrained pipe
    blocks a child before it registers). ``check`` fails when one has
    died or printed a traceback; ``close`` stops every one (SIGTERM, then
    SIGKILL after 20 s) and returns their exit codes."""

    def __init__(self, tag: str):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
        self.procs: dict = {}
        self.killed: set = set()

    def start(self, name: str, argv: list, env: dict) -> None:
        out = open(os.path.join(self.dir, f"{name}.out"), "w")
        err = open(os.path.join(self.dir, f"{name}.err"), "w")
        self.procs[name] = subprocess.Popen(
            argv, env=env, cwd=self.dir, stdin=subprocess.DEVNULL,
            stdout=out, stderr=err)
        out.close()
        err.close()

    def text(self, name: str, which: str) -> str:
        with open(os.path.join(self.dir, f"{name}.{which}")) as f:
            return f.read()

    def check(self) -> None:
        for name, p in self.procs.items():
            if name in self.killed:
                continue
            err = self.text(name, "err")
            assert p.poll() is None and "Traceback" not in err, (
                f"child {name} rc={p.poll()}: {err[-3000:]}")

    def wait_for(self, pred, what: str, timeout_s: float):
        """Poll ``pred`` (children checked each round) until it returns
        something true, at most ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            got = pred()
            if got:
                return got
            self.check()
            assert time.monotonic() < deadline, f"{what}: no answer in {timeout_s} s"
            time.sleep(0.05)

    def line(self, name: str, pattern: str, timeout_s: float) -> str:
        """The first stdout line of ``name`` matching ``pattern``."""
        import re

        def find():
            for ln in self.text(name, "out").splitlines():
                if re.search(pattern, ln):
                    return ln
            return None

        return self.wait_for(find, f"{name} {pattern!r}", timeout_s)

    def kill(self, name: str) -> None:
        import signal

        self.procs[name].send_signal(signal.SIGKILL)
        self.procs[name].wait(timeout=30)
        self.killed.add(name)

    def close(self) -> dict:
        import signal

        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = {}
        for name, p in self.procs.items():
            try:
                rcs[name] = p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[name] = p.wait(timeout=20)
        return rcs

    def verify_exits(self, rcs: dict) -> None:
        """Every child but the killed ones ended with 0 and no traceback."""
        for name, rc in rcs.items():
            if name in self.killed:
                continue
            err = self.text(name, "err")
            assert rc == 0 and "Traceback" not in err, (
                f"child {name} rc={rc}: {err[-3000:]}")


def child_env(device, **extra) -> dict:
    """A child's environment: this checkout first on PYTHONPATH, and the
    device variable only when the run is not on the card."""
    env = {k: v for k, v in os.environ.items() if k != DEVICE_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    if device.type != "cuda":
        env[DEVICE_ENV] = device.type
    env.update({k: str(v) for k, v in extra.items()})
    return env


def pem_worker(argv) -> int:
    """``chip_smoke.py --pem-worker PORT I ROWS WINDOW QUARTER``: one PEM
    in a process of its own on the card (or the device the device
    variable names). It regenerates the ROWS-row replay from SEED,
    appends its quarter [I * QUARTER, (I + 1) * QUARTER) in the order of
    its own dictionaries (``cl_batches``, as the cluster phase deals
    them), starts a PEMAgent on a RemoteBus to the broker's BusServer at
    PORT (with self-telemetry and, as the deployed PEM role runs it, the
    self-sampling profiler on its collector), and answers
    ``smoke.pem-I.ctl`` requests: ``zero`` sets the kernels' launch
    counters to 0, ``read`` returns them, their totals since the process
    began (``lifetime``) and the bytes the torch allocator holds on the
    card. It prints one JSON line when it serves and one with its counts
    when it ends (SIGTERM, or its parent gone)."""
    import signal
    import threading

    import torch

    sys.path.insert(0, ROOT)
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.config import get_flag
    from pixie_tpu_torch.deploy import env_device
    from pixie_tpu_torch.ingest.profiler import PerfProfilerConnector
    from pixie_tpu_torch.services.agent import PEMAgent
    from pixie_tpu_torch.services.netbus import RemoteBus

    port, i, rows, window, quarter = (int(a) for a in argv[:5])
    aid = f"pem-{i}"
    device = env_device()
    parent = os.getppid()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    def reserved():
        return (torch.cuda.memory_reserved(device)
                if device.type == "cuda" else None)

    eng = Engine(window_rows=window, device=device)
    eng.create_table("http_events")
    replay = make_replay(rows)
    t0 = time.perf_counter()
    for hb in cl_batches(replay, i, i * quarter, (i + 1) * quarter, window,
                         i * quarter):
        eng.append_data("http_events", hb)
    append_s = time.perf_counter() - t0
    del replay
    bus = RemoteBus("127.0.0.1", port)

    lifetime = {"dense_fold": 0, "hist_fold": 0}  # launches before zeroing

    def on_ctl(msg):
        if msg.get("op") == "zero":
            for k, n in _launch_counts().items():
                lifetime[k] += n
            _zero_launches()
        now = _launch_counts()
        bus.publish(msg["_reply_to"], {
            "launches": now,
            "lifetime": {k: lifetime[k] + n for k, n in now.items()},
            "reserved_bytes": reserved()})

    bus.subscribe(f"smoke.{aid}.ctl", on_ctl)
    pem = PEMAgent(bus, aid, engine=eng, heartbeat_interval_s=CL_HEARTBEAT_S)
    if get_flag("self_profiling"):
        pem.collector.register_source(PerfProfilerConnector(pod=aid))
    pem.start()
    print(json.dumps({"worker": aid, "serving": True, "append_s": append_s,
                      "resident_bytes":
                          eng.tables["http_events"].resident_bytes,
                      "device": str(device)}), flush=True)
    while not stop.wait(0.5):
        if os.getppid() != parent:
            break  # the smoke is gone: never outlive it
    pem.stop()
    bus.close()
    print(json.dumps({"worker": aid, "launches": _launch_counts(),
                      "reserved_bytes": reserved()}), flush=True)
    return 0


def pr_scrape(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def pr_reserved_from_metrics(body: str):
    """The bytes the torch allocator holds on the card, from a role's
    ``/metrics`` (``pixie_device_memory_bytes{kind="bytes_reserved"}``)."""
    for ln in body.splitlines():
        if (ln.startswith("pixie_device_memory_bytes{")
                and 'kind="bytes_reserved"' in ln):
            return int(float(ln.rsplit(" ", 1)[1]))
    return None


def pr_query(broker, name: str, kelvin_obs: int, timeout_s: float = 120.0):
    """One broker query across the processes and its split: the slowest
    PEM fragment (the agents' ``exec_time_s``), the Kelvin's merge (its
    trace for the query id on the Kelvin role's ``/debug/queryz``) and
    the bridge bytes."""
    from pixie_tpu_torch.scripts import load_script

    pxl = (load_script(name).pxl if name == "px/agent_status"
           else query_text(name))
    t0 = time.perf_counter()
    res = broker.execute_script(pxl, timeout_s=timeout_s)
    secs = time.perf_counter() - t0
    frags = {a: st["exec_time_s"] for a, st in res["agent_stats"].items()}
    _, body = pr_scrape(kelvin_obs, "/debug/queryz")
    merges = [t for t in json.loads(body)["recent"]
              if t.get("qid") == res["qid"]]
    # Each query's allocator peak on the card (the engine resets the
    # peak when a query starts), by process.
    peaks = {a: st["usage"].get("device_peak_bytes")
             for a, st in res["agent_stats"].items()}
    peaks["kelvin-0"] = max(
        (t["usage"].get("device_peak_bytes") or 0 for t in merges),
        default=None)
    return {
        "res": res, "secs": secs, "trace_id": broker.tracer.last().trace_id,
        "slowest_fragment_s": max(frags.values()) if frags else 0.0,
        "fragments_s": frags,
        "merge_s": (max(t["duration_ms"] for t in merges) / 1e3
                    if merges else None),
        "device_peaks": peaks,
        "wire_bytes": sum(int(st["usage"]["wire_bytes"])
                          for st in res["agent_stats"].values()),
    }


#: The shipped scripts that read the agents' self-telemetry tables.
PR_TELEMETRY_SCRIPTS = (
    "px/program_cost",  # first: before the others' own kernel launches
    "px/agent_health", "px/bound_accuracy", "px/bus_health",
    "px/cache_stats", "px/flame_diff", "px/ingest_lag", "px/query_cost",
    "px/query_cpu", "px/rpc_latency", "px/slow_queries", "px/table_health",
    "px/tenant_cpu",
)
PR_TELEMETRY_TABLES = ("__queries__", "__spans__", "__agents__",
                       "__programs__", "__tables__", "__bus__", "__stacks__")
PR_FRAGMENT_HASHES = """import px
df = px.DataFrame(table='__queries__')
df = df[df.kind == 'fragment']
df = df.groupby(['qid', 'script_hash', 'agent_id']).agg(
    n=('rows_out', px.count))
px.display(df)
"""


def pr_trace_split(obs_port: int, trace_id: str, participants: int,
                   timeout_s: float = 30.0) -> dict:
    """One distributed query's split from the broker's
    ``/debug/tracez/<id>``, once every participant's spans are in:
    compile (the broker's compile span), plan (compile's end to the
    dispatch span: distributed planning, predicted cost, admission and
    registration), dispatch (the dispatch span), the slowest PEM
    fragment and the Kelvin's merge (the agents' root spans under the
    dispatch span: the merge is the one that starts after every other
    ends), in ms."""
    import urllib.error

    deadline = time.monotonic() + timeout_s
    while True:
        try:
            _, body = pr_scrape(obs_port, f"/debug/tracez/{trace_id}")
            one = json.loads(body)
            if len(one["agents"]) >= participants:
                break
        except urllib.error.HTTPError:
            pass
        assert time.monotonic() < deadline, f"trace {trace_id} incomplete"
        time.sleep(0.05)
    spans = one["spans"]

    def ms(sp):
        return (sp["end_unix_nano"] - sp["start_unix_nano"]) / 1e6

    root = next(sp for sp in spans if not sp["parent_id"])
    compile_ = next(sp for sp in spans if sp["name"] == "compile"
                    and sp["parent_id"] == root["span_id"])
    dispatch = next(sp for sp in spans if sp["name"] == "dispatch")
    roots = sorted((sp for sp in spans
                    if sp["parent_id"] == dispatch["span_id"]),
                   key=lambda sp: sp["start_unix_nano"])
    merge, frags = roots[-1], roots[:-1]
    assert len(roots) == participants - 1, (len(roots), participants)
    assert merge["start_unix_nano"] >= max(
        sp["end_unix_nano"] for sp in frags), "merge began before a fragment"
    return {
        "query_ms": ms(root), "compile_ms": ms(compile_),
        "plan_ms": (dispatch["start_unix_nano"]
                    - compile_["end_unix_nano"]) / 1e6,
        "dispatch_ms": ms(dispatch),
        "slowest_fragment_ms": max(ms(sp) for sp in frags),
        "merge_ms": ms(merge),
        "agents": one["agents"],
    }


def pr_telemetry(broker, tracker, pems, ctl: dict, data_qids: dict,
                 kernels: bool, timeout_s: float = 60.0) -> dict:
    """The 13 telemetry scripts through the broker over the PEM
    processes' own tables, each checked: px/slow_queries and
    px/query_cost hold every data script's fragment hash (the hash of
    each phase query's PEM fragments, read from ``__queries__`` by qid)
    on every PEM; px/program_cost lists dense_fold and hist_fold (when
    ``kernels``: the PEMs run on the card) with hits equal to the
    largest PEM process's launches since it began (``ctl``'s
    ``lifetime``, read before these scripts launch any);
    px/table_health, px/bus_health and px/agent_health have a row per
    PEM; px/query_cpu has samples. Returns each script's seconds and
    rows."""
    from pixie_tpu_torch.scripts import load_script

    def tel_ready():
        return set(PR_TELEMETRY_TABLES) <= set(tracker.schemas())

    deadline = time.monotonic() + timeout_s
    while not tel_ready():
        assert time.monotonic() < deadline, (
            "telemetry tables never registered",
            sorted(set(PR_TELEMETRY_TABLES) - set(tracker.schemas())))
        time.sleep(0.1)
    out, got = {}, {}
    for name in PR_TELEMETRY_SCRIPTS:
        t0 = time.perf_counter()
        res = broker.execute_script(load_script(name).pxl, timeout_s=120.0,
                                    max_output_rows=100_000)
        (hb,) = res["tables"].values()
        got[name] = hb.to_pydict()
        out[name] = {"secs": time.perf_counter() - t0, "rows": hb.length}
    frag = broker.execute_script(PR_FRAGMENT_HASHES, timeout_s=120.0,
                                 max_output_rows=100_000)
    d = frag["tables"]["output"].to_pydict()
    hashes: dict = {}
    for q, h, a in zip(d["qid"], d["script_hash"], d["agent_id"]):
        hashes.setdefault(q, set()).add((h, a))
    for name, qids in data_qids.items():
        for q in qids:
            pairs = hashes.get(q, set())
            assert {a for _h, a in pairs} == set(pems), (name, q, pairs)
            (h,) = {h for h, _a in pairs}
            assert h in set(got["px/slow_queries"]["script_hash"]), (name, h)
            cost = set(zip(got["px/query_cost"]["script_hash"],
                           got["px/query_cost"]["agent_id"]))
            assert {(h, p) for p in pems} <= cost, (name, h)
    pc = got["px/program_cost"]
    for k in ("dense_fold", "hist_fold") if kernels else ():
        rows = [i for i, lab in enumerate(pc["label"]) if lab == k]
        assert len(rows) == 1, (k, pc["label"])
        want = max(ctl[p]["lifetime"][k] for p in pems)
        assert int(pc["hits"][rows[0]]) == want > 0, (k, pc["hits"][rows[0]],
                                                       want)
        out["px/program_cost"][f"{k}_launches"] = want
    th = got["px/table_health"]
    i = list(th["table"]).index("http_events")
    assert int(th["agents"][i]) == len(pems), th["agents"]
    for name in ("px/bus_health", "px/agent_health"):
        assert set(got[name]["agent_id"]) == set(pems), (
            name, set(got[name]["agent_id"]))
    qc = got["px/query_cpu"]
    assert len(qc["samples"]) and int(np.sum(qc["samples"])) > 0, qc
    out["px/query_cpu"]["samples"] = int(np.sum(qc["samples"]))
    return out


def netbus_rtt(sizes=(1 << 10, 1 << 16, 1 << 20), n: int = 30) -> dict:
    """Median ms of one request and its reply through a BusServer and a
    RemoteBus in this process (the netbus's two hops each way), by
    payload size, with Nagle's algorithm off on both sockets and on
    again (as the netbus leaves them, like the JAX package's)."""
    import socket

    from pixie_tpu_torch.services import MessageBus
    from pixie_tpu_torch.services.netbus import BusServer, RemoteBus

    bus = MessageBus()
    server = BusServer(bus)
    rb = RemoteBus("127.0.0.1", server.port)
    out = {}
    try:
        bus.subscribe("smoke.echo", lambda m: bus.publish(
            m["_reply_to"], {"b": m["b"]}))
        rb.request("smoke.echo", {"b": b""}, timeout_s=10.0)
        for nodelay in (1, 0):
            for sock in [rb.sock] + [c.sock for c in server._clients]:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                nodelay)
            for size in sizes:
                payload = b"x" * size
                rb.request("smoke.echo", {"b": payload}, timeout_s=10.0)
                ms = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    rb.request("smoke.echo", {"b": payload}, timeout_s=10.0)
                    ms.append((time.perf_counter() - t0) * 1e3)
                out[f"{'nodelay' if nodelay else 'nagle'}_{size}B_ms"] = (
                    float(np.median(ms)))
    finally:
        rb.close()
        server.close()
        bus.close()
    return out


def pr_ctl(bus, pems, op: str) -> dict:
    return {p: bus.request(f"smoke.{p}.ctl", {"op": op}, timeout_s=PR_CTL_S)
            for p in pems}


MESH_PEMS = 4
MESH_TURNS = 3


def mesh_turns(dist, name: str, expect: Expect, ref, turns: int) -> dict:
    """A warm-up, then ``turns`` timed queries of ``name`` on the mesh
    engine with the launch counters set to 0 before them, each answer
    held to numpy and to the single engine's ``ref`` (cl_reference's
    triple). Returns the turns' seconds, counters and launches."""
    dist.execute_query(query_text(name))  # warm-up
    _zero_launches()
    secs = []
    for _ in range(turns):
        t0 = time.perf_counter()
        out = dist.execute_query(query_text(name))["output"]
        secs.append(time.perf_counter() - t0)
        expect.check(name, out)
        check_library_output(f"mesh {name}", out, ref[0]["output"],
                             ref[1]["output"], ref[2])
    st = dist.last_stats
    return {"script": name, "checked": True, "turns": secs,
            "secs": float(np.median(secs)), "windows": st.windows,
            "resident_windows": st.resident_windows,
            "staged_windows": st.staged_windows,
            "launches": _launch_counts(), "per_query": {
                k: v // turns for k, v in _launch_counts().items()}}


def phase_mesh(eng, replay, expect: Expect, device, single: dict,
               window: int = WINDOW, turns: int = MESH_TURNS,
               profile: bool = True) -> dict:
    """The mesh executor (``pixie_tpu_torch/parallel/``): a
    ``DistributedEngine`` over 4 virtual PEMs on ``device``
    (``agent_mesh(4, devices=[device] * 4)``) loads the replay in
    ``window``-row resident windows; px/http_stats, http_stats_float64
    and px/service_stats each run a warm-up and ``turns`` timed turns,
    every answer held to numpy and to the single engine ``eng``'s (keys,
    strings and integers exact, FLOAT64 rtol 1e-5, quantiles rtol 0.05),
    every window resident, each kernel launched 4 times as often per
    query as on ``eng`` (``single``: its launches per query), and one
    more turn under torch.profiler (the idle share). Then a 2 x 2
    (kelvin x agents) mesh on px/service_stats, and a degraded mesh: a
    DistributedState with 3 live PEMs of 4, on http_stats_float64 (every
    window staged, 3 dense_fold launches per window). Both read the
    first mesh engine's tables. Returns the launches per query."""
    from pixie_tpu_torch.parallel import DistributedEngine, agent_mesh
    from pixie_tpu_torch.planner.distributed import AgentInfo, DistributedState

    on_card = device.type == "cuda"
    n_windows = -(-len(replay[0]) // window)
    slots = [device] * MESH_PEMS
    dist = DistributedEngine(window_rows=window,
                             mesh=agent_mesh(MESH_PEMS, devices=slots))
    dist.create_table("http_events")
    append_s = append_replay(dist, replay, window)
    resident = dist.tables["http_events"].resident_bytes
    print(json.dumps({"phase": "mesh_append", "pems": MESH_PEMS,
                      "rows": len(replay[0]), "secs": append_s,
                      "resident_bytes": resident}))
    if on_card:
        assert resident == len(replay[0]) * ROW_BYTES, resident
    out = {"dense_fold": {}, "hist_fold": {}}
    refs = {}
    for name in AGG_SCRIPTS:
        t0 = time.perf_counter()
        refs[name] = cl_reference(eng, name)
        single_s = time.perf_counter() - t0
        rec = mesh_turns(dist, name, expect, refs[name], turns)
        rec = {"phase": "mesh", "mesh": "1x4", **rec,
               "single_secs": single_s}
        assert (rec["resident_windows"], rec["staged_windows"]) == (
            n_windows, 0), rec
        if on_card:
            kernel = CL_KERNEL_OF.get(name)
            if kernel is not None:
                n = rec["per_query"][kernel]
                assert n == MESH_PEMS * single[kernel], (name, n, single)
                out[kernel][name] = n
            if profile:
                rec.update(device_busy(dist, name))
        print(json.dumps(rec))
    two_d = DistributedEngine(window_rows=window, mesh=agent_mesh(
        MESH_PEMS // 2, n_kelvin=2, devices=slots))
    two_d.table_store = dist.table_store
    name = "px/service_stats"
    rec = mesh_turns(two_d, name, expect, refs[name], turns)
    rec = {"phase": "mesh", "mesh": "2x2", **rec}
    assert rec["resident_windows"] == n_windows, rec
    if on_card:
        n = rec["per_query"]["hist_fold"]
        assert n == MESH_PEMS * single["hist_fold"], (n, single)
        out["hist_fold"]["2x2 " + name] = n
    print(json.dumps(rec))
    state = DistributedState(agents=[
        AgentInfo(agent_id=f"pem-{i}", processes_data=True,
                  tables=frozenset({"http_events"}))
        for i in range(MESH_PEMS - 1)
    ] + [AgentInfo(agent_id="kelvin-0", processes_data=False,
                   accepts_remote_sources=True)])
    degraded = DistributedEngine(window_rows=window, mesh=dist.mesh,
                                 distributed_state=state)
    degraded.table_store = dist.table_store
    name = "http_stats_float64"
    rec = mesh_turns(degraded, name, expect, refs[name], turns)
    rec = {"phase": "mesh", "mesh": "degraded 1x3", **rec,
           "n_data_shards": degraded.last_distributed_plan.n_data_shards}
    assert rec["n_data_shards"] == MESH_PEMS - 1, rec
    assert (rec["resident_windows"], rec["staged_windows"]) == (
        0, n_windows), rec
    if on_card:
        n = rec["per_query"]["dense_fold"]
        assert n == (MESH_PEMS - 1) * n_windows, n
        out["dense_fold"]["degraded " + name] = n
    print(json.dumps(rec))
    return out


def phase_processes(eng, replay, device, in_process: dict,
                    window: int = WINDOW, quarter: int = CL_QUARTER,
                    turns: int = CL_TURNS) -> dict:
    """The cluster phase across processes: the broker (MessageBus,
    BusServer, AgentTracker, QueryBroker) in this process, CL_PEMS PEM
    workers (``--pem-worker``) and one ``python -m
    pixie_tpu_torch.deploy kelvin``, each with its own engine on the one
    card, all on the framed-TCP netbus. After a warm-up each of
    CL_SCRIPTS runs ``turns`` times through ``broker.execute_script``,
    held to the single engine ``eng``'s answer (the cluster phase's
    tolerances), beside the in-process cluster's seconds
    (``in_process``, from ``phase_cluster``). Then the last PEM process
    is killed (SIGKILL); once the tracker has expired it,
    px/service_stats replans onto the others and is held to numpy over
    their quarters. Returns each kernel's launches per PEM process."""
    import torch

    from pixie_tpu_torch.exec.programs import default_program_registry
    from pixie_tpu_torch.services import AgentTracker, MessageBus, QueryBroker
    from pixie_tpu_torch.services.netbus import BusServer
    from pixie_tpu_torch.services.observability import ObservabilityServer

    refs = {n: cl_reference(eng, n) for n in CL_SCRIPTS
            if n != "px/agent_status"}
    rows = len(replay[0])
    pems = [f"pem-{i}" for i in range(CL_PEMS)]
    t_phase = time.perf_counter()
    bus = MessageBus()
    server = BusServer(bus)
    tracker = AgentTracker(bus, expiry_s=PR_EXPIRY_S, check_interval_s=0.25)
    kids = Children("processes")
    broker, obs, out, rcs = None, None, {}, {}
    try:
        for i, aid in enumerate(pems):
            kids.start(aid, [sys.executable, os.path.abspath(__file__),
                             "--pem-worker", str(server.port), str(i),
                             str(rows), str(window), str(quarter)],
                       child_env(device))
        kids.start("kelvin-0", [sys.executable, "-m", "pixie_tpu_torch.deploy",
                                "kelvin"],
                   child_env(device, PIXIE_TPU_BROKER=f"127.0.0.1:{server.port}",
                             PIXIE_TPU_AGENT_ID="kelvin-0",
                             PIXIE_TPU_OBS_PORT=0))
        kelvin_obs = int(kids.line("kelvin-0", r"obs :\d+", PR_START_S)
                         .split("obs :")[1].split()[0])
        kids.wait_for(lambda: len(tracker.agent_ids()) == len(pems) + 1
                      and "http_events" in tracker.schemas(),
                      "registration", PR_START_S)
        start_s = time.perf_counter() - t_phase
        served = {aid: json.loads(kids.line(aid, r'"serving"', 5.0))
                  for aid in pems}
        print(json.dumps({"phase": "processes_start", "pems": len(pems),
                          "rows_per_pem": quarter, "secs": start_s,
                          "kelvin_obs_port": kelvin_obs,
                          "workers": served}))
        if device.type == "cuda":
            assert all(w["resident_bytes"] == quarter * ROW_BYTES
                       for w in served.values()), served
        broker = QueryBroker(bus, tracker)
        # The broker's HTTP surface, as the deployed broker role serves
        # it: its stitched traces back /debug/tracez.
        obs = ObservabilityServer(tracer=broker.tracer,
                                  trace_view=broker.trace_view,
                                  programs=default_program_registry())
        obs_port = obs.start(0)
        data_qids: dict = {}  # script -> the qids of its timed turns
        splits: list = []  # px/service_stats' turns from /debug/tracez
        peaks: dict = {}  # process -> the largest query peak on the card

        def note_peaks(rec):
            for a, b in rec["device_peaks"].items():
                if b is not None:
                    peaks[a] = max(peaks.get(a, 0), int(b))

        for name in CL_SCRIPTS:
            t0 = time.perf_counter()
            pr_query(broker, name, kelvin_obs, timeout_s=PR_WARMUP_S)
            warm_s = time.perf_counter() - t0
            pr_ctl(bus, pems, "zero")
            recs = []
            for _ in range(turns):
                recs.append(pr_query(broker, name, kelvin_obs))
                note_peaks(recs[-1])
                res = recs[-1]["res"]
                kids.check()
                if name == "px/agent_status":
                    (hb,) = res["tables"].values()
                    d = hb.to_pydict()
                    assert sorted(d["agent_id"]) == sorted(pems + ["kelvin-0"])
                    continue
                assert set(res["agent_stats"]) == set(pems), res["agent_stats"]
                data_qids.setdefault(name, []).append(res["qid"])
                if name == "px/service_stats":
                    splits.append(pr_trace_split(
                        obs_port, recs[-1]["trace_id"], len(pems) + 2))
                ref, loose, ordered = refs[name]
                assert sorted(res["tables"]) == sorted(ref), name
                for k in ref:
                    check_library_output(f"processes {name}:{k}",
                                         res["tables"][k], ref[k], loose[k],
                                         ordered)
            ctl = pr_ctl(bus, pems, "read")
            kernel = CL_KERNEL_OF.get(name)
            per_pem = {k: {p: ctl[p]["launches"][k] for p in pems}
                       for k in ("dense_fold", "hist_fold")}
            if kernel is not None and device.type == "cuda":
                assert all(n > 0 for n in per_pem[kernel].values()), (
                    name, per_pem)
                out.setdefault(kernel, {})[name] = {
                    "per_pem_process_per_query": {
                        p: n // turns for p, n in per_pem[kernel].items()},
                    "per_query": sum(per_pem[kernel].values()) // turns,
                }
            rec = {"phase": "processes", "script": name, "checked": True,
                   "warm_up_s": warm_s, "turns": [r["secs"] for r in recs],
                   "secs": float(np.median([r["secs"] for r in recs]))}
            for k in ("slowest_fragment_s", "merge_s", "wire_bytes"):
                vals = [r[k] for r in recs if r[k] is not None]
                rec[k] = float(np.median(vals)) if vals else None
            rec["fragments_s"] = recs[-1]["fragments_s"]
            ip = in_process.get(name, {})
            rec["in_process"] = ip
            rec["wire_bytes_equal_in_process"] = (
                ip.get("wire_bytes") == rec["wire_bytes"] if ip else None)
            rec["launches_per_pem"] = per_pem
            print(json.dumps(rec))
        print(json.dumps({
            "phase": "processes_trace_split", "script": "px/service_stats",
            "source": "/debug/tracez", "turns": splits,
            **{k: float(np.median([sp[k] for sp in splits]))
               for k in ("query_ms", "compile_ms", "plan_ms", "dispatch_ms",
                         "slowest_fragment_ms", "merge_ms")}}))
        # The agents' own telemetry, queried as a user would.
        t0 = time.perf_counter()
        tel = pr_telemetry(broker, tracker, pems, ctl, data_qids,
                           kernels=device.type == "cuda")
        kids.check()
        print(json.dumps({"phase": "processes_telemetry", "checked": True,
                          "scripts": tel,
                          "secs": time.perf_counter() - t0}))
        conns = server.busz()
        reserved = {p: ctl[p]["reserved_bytes"] for p in pems}
        _, metrics = pr_scrape(kelvin_obs, "/metrics")
        reserved["kelvin-0"] = pr_reserved_from_metrics(metrics)
        # This process holds the broker and the single engine's tables.
        reserved["smoke (broker, single engine)"] = (
            torch.cuda.memory_reserved(device) if device.type == "cuda"
            else None)
        print(json.dumps({
            "phase": "processes_wire",
            "round_trip_ms": netbus_rtt(),
            "connections": conns,
            "frames": sum(c["frames_sent"] + c["frames_recv"] for c in conns),
            "bytes": sum(c["bytes_sent"] + c["bytes_recv"] for c in conns),
            "query_peak_bytes": peaks,
            "reserved_bytes": reserved}))
        # One PEM process dies: the tracker expires it, the next query
        # replans onto the others.
        dead = pems[-1]
        t0 = time.perf_counter()
        kids.kill(dead)
        kids.wait_for(lambda: dead not in tracker.agent_ids(), "expiry",
                      PR_EXPIRY_S + 10.0)
        expiry_s = time.perf_counter() - t0
        live = pems[:-1]
        rec = pr_query(broker, "px/service_stats", kelvin_obs)
        res = rec["res"]
        assert res["distributed_plan"].n_data_shards == len(live)
        assert set(res["agent_stats"]) == set(live)
        (hb,) = res["tables"].values()
        cl_check_service_stats(
            hb, cl_expect_service_stats(replay, slice(0, len(live) * quarter)))
        kids.check()
        print(json.dumps({"phase": "processes_expiry",
                          "script": "px/service_stats", "killed": dead,
                          "signal": "SIGKILL", "expired_after_s": expiry_s,
                          "pems": len(live), "secs": rec["secs"],
                          "wire_bytes": rec["wire_bytes"], "checked": True}))
    finally:
        if obs is not None:
            obs.stop()
        if broker is not None:
            broker.close()
        rcs = kids.close()
        tracker.close()
        server.close()
        bus.close()
    kids.verify_exits(rcs)
    ends = {aid: json.loads(kids.line(aid, r'"launches"', 5.0))
            for aid in pems if aid not in kids.killed}
    print(json.dumps({"phase": "processes_end", "exit_codes": rcs,
                      "worker_totals": ends,
                      "secs": time.perf_counter() - t_phase}))
    return out


DP_SEQ_BOUND = 64  # seq-gen rows with x below this: one transfer per PEM
DP_START_S = 120.0
DP_SECRET = "chip-smoke-deploy"  # the bus secret every role and client shares


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _client_rows(text: str, table: str = "output") -> list:
    """The rows ``pxclient`` printed for ``table``: its header line names
    the columns, each row line holds tab-separated integers."""
    lines = text.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if ln.startswith(f"[{table}] "))
    n = int(lines[at].split()[1])
    cols = lines[at + 1].rstrip("\t").split("\t")
    return [dict(zip(cols, map(int, ln.rstrip("\t").split("\t"))))
            for ln in lines[at + 2:at + 2 + n]]


def phase_deploy(device, pxclient: str) -> None:
    """The system started the way its users start it:
    ``python -m pixie_tpu_torch.deploy broker`` (one broker-HA replica,
    under lockdep: its ``/statusz`` shows the leader at epoch 1 or
    more), two ``pem`` roles with
    the seq-gen source (``PIXIE_TPU_SEQGEN=1``) and one ``kelvin``, each
    a process on the card. ``python -m pixie_tpu_torch.cli run --broker``
    answers the sequences group-by of ``tests/test_cli.py``'s deploy
    test; over the seq-gen rows with x < DP_SEQ_BOUND (one transfer per
    PEM, fixed once pushed) the group-by's counts sum to the count of
    the same rows without it, run right after; ``cli agents`` lists both
    PEMs and the Kelvin; ``cli profile`` names the broker's and both
    PEMs' samplers; ``api.Client.execute_script`` returns the CLI's table
    through a record handler; the broker's ``/healthz``, ``/metrics`` and
    ``/debug/programz`` answer 200. Every role and client shares one bus
    secret (``PIXIE_TPU_BUS_SECRET``). The native client ``pxclient``
    (``native/pxclient.cc``, built with g++ at the start of the run)
    prints for the bounded group-by the table ``cli run`` printed, lists
    the scripts, prints two updates of the live sequences group-by with
    ``--stream --updates 2`` and exits 0, and is refused with a wrong
    secret. Every wait is bounded."""
    from pixie_tpu_torch.api import Client, TableRecordHandler
    from pixie_tpu_torch.config import clear_flag, set_flag
    from pixie_tpu_torch.scripts import list_scripts

    t_phase = time.perf_counter()
    netbus, obs = _free_port(), _free_port()
    addr = f"127.0.0.1:{netbus}"
    env = child_env(device, PIXIE_TPU_NETBUS_PORT=netbus,
                    PIXIE_TPU_OBS_PORT=obs, PIXIE_TPU_BROKER=addr,
                    PIXIE_TPU_BUS_SECRET=DP_SECRET)
    kids = Children("deploy")
    timings, rcs = {}, {}
    seq = ("import px\ndf = px.DataFrame(table='sequences')\n"
           "s = df.groupby('modulo10').agg(n=('x', px.count))\n"
           "px.display(s)\n")
    bounded = seq.replace(
        "df = px.DataFrame(table='sequences')\n",
        f"df = px.DataFrame(table='sequences')\ndf = df[df.x < {DP_SEQ_BOUND}]\n")
    whole = bounded.replace("df.groupby('modulo10').agg", "df.agg")
    for name, text in (("seq.pxl", seq), ("bounded.pxl", bounded)):
        with open(os.path.join(kids.dir, name), "w") as f:
            f.write(text)
    pems = ["pem-deploy-0", "pem-deploy-1"]

    def cli(*argv):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pixie_tpu_torch.cli", *argv],
            env=env, cwd=kids.dir, capture_output=True, text=True,
            timeout=120)
        assert r.returncode == 0, (argv, r.stdout[-2000:], r.stderr[-2000:])
        timings.setdefault("cli_s", []).append(time.perf_counter() - t0)
        return r.stdout

    def native(*argv, secret=DP_SECRET, ok=True):
        t0 = time.perf_counter()
        r = subprocess.run(
            [pxclient, "--port", str(netbus), "--secret", secret, *argv],
            cwd=kids.dir, capture_output=True, text=True, timeout=120)
        assert (r.returncode == 0) == ok, (argv, r.returncode,
                                           r.stdout[-2000:], r.stderr[-2000:])
        timings.setdefault("pxclient_s", []).append(time.perf_counter() - t0)
        return r

    set_flag("bus_secret", DP_SECRET)  # this process's api.Client
    try:
        # The broker as one replica of an HA control plane, its locks
        # under lockdep.
        kids.start("broker", [sys.executable, "-m", "pixie_tpu_torch.deploy",
                              "broker"],
                   {**env, "PIXIE_TPU_BROKER_HA": "1",
                    "PIXIE_TPU_LOCKDEP": "1"})
        for aid in pems:
            kids.start(aid, [sys.executable, "-m", "pixie_tpu_torch.deploy",
                             "pem"],
                       {**env, "PIXIE_TPU_AGENT_ID": aid,
                        "PIXIE_TPU_OBS_PORT": "0", "PIXIE_TPU_SEQGEN": "1"})
        kids.start("kelvin", [sys.executable, "-m", "pixie_tpu_torch.deploy",
                              "kelvin"],
                   {**env, "PIXIE_TPU_AGENT_ID": "kelvin-deploy",
                    "PIXIE_TPU_OBS_PORT": "0"})
        kids.line("broker", r"\[broker\] netbus", DP_START_S)

        def dial():
            try:
                return Client("127.0.0.1", netbus, connect_timeout_s=2.0)
            except OSError:
                return None

        client = kids.wait_for(dial, "dial the broker", DP_START_S)
        with client:
            def count():
                if "sequences" not in client.schemas():
                    return None
                n = client.execute_script(whole, timeout_s=30.0)["output"]["n"]
                return len(n) and int(n[0]) == DP_SEQ_BOUND * len(pems)

            kids.wait_for(count, "seq-gen rows from both PEMs", DP_START_S)
            timings["ready_s"] = time.perf_counter() - t_phase
            text = cli("run", "--broker", addr, "--timeout", "60",
                       os.path.join(kids.dir, "seq.pxl"))
            assert "== output (10 rows) ==" in text, text
            rows = json.loads(cli("run", "--broker", addr, "-o", "json",
                                  os.path.join(kids.dir, "bounded.pxl")))
            n_whole = int(client.execute_script(
                whole, timeout_s=30.0)["output"]["n"][0])
            assert sorted(r["modulo10"] for r in rows["rows"]) == list(range(10))
            assert sum(r["n"] for r in rows["rows"]) == n_whole == (
                DP_SEQ_BOUND * len(pems)), (rows, n_whole)
            agents = cli("agents", "--broker", addr)
            assert all(a in agents for a in pems + ["kelvin-deploy"]), agents
            # The cluster's CPU profile: the broker's own sampler and the
            # PEMs' heartbeat summaries.
            prof = json.loads(cli("profile", "--broker", addr, "-o", "json"))
            assert {"broker", *pems} <= set(prof["agents"]), prof["agents"]
            assert prof["stacks"], "px profile returned no stacks"
            timings["profile"] = {"agents": prof["agents"],
                                  "stacks": len(prof["stacks"])}

            class Recorder(TableRecordHandler):
                def __init__(self):
                    self.rows = []

                def handle_record(self, record):
                    self.rows.append(record)

            rec = Recorder()
            client.execute_script(bounded, timeout_s=30.0,
                                  handler_factory=lambda t: rec)
            key = lambda r: r["modulo10"]
            assert sorted(rec.rows, key=key) == sorted(rows["rows"], key=key)
            # The native client: the same table as the CLI's, the
            # scripts, two live updates, and a wrong secret refused.
            got = _client_rows(native(
                "--script", os.path.join(kids.dir, "bounded.pxl")).stdout)
            assert sorted(got, key=key) == sorted(rows["rows"], key=key), (
                got, rows["rows"])
            listed = native("--list").stdout.splitlines()
            assert listed == list_scripts(), listed[:5]
            live = native("--stream", "--updates", "2", "--script",
                          os.path.join(kids.dir, "seq.pxl")).stdout
            heads = [ln for ln in live.splitlines()
                     if ln.startswith("-- update")]
            assert len(heads) == 2, live[-2000:]
            assert live.count("[output] 10 rows") == 2, live[-2000:]
            bad = native("--script", os.path.join(kids.dir, "bounded.pxl"),
                         secret="wrong", ok=False)
            assert "auth" in bad.stderr.lower(), bad.stderr
            timings["pxclient"] = {"rows": len(got), "scripts": len(listed),
                                   "updates": heads}
        for path in ("/healthz", "/metrics"):
            code, _body = pr_scrape(obs, path)
            assert code == 200, (path, code)
        code, body = pr_scrape(obs, "/statusz")
        assert code == 200, code
        ha = json.loads(body)["ha"]
        assert ha["role"] == "leader" and ha["epoch"] >= 1, ha
        timings["ha"] = ha
        code, body = pr_scrape(obs, "/debug/programz")
        assert code == 200, code
        pz = json.loads(body)
        timings["programz"] = {k: pz[k] for k in ("count", "hits",
                                                   "compiles", "compile_ms")}
        kids.check()
    finally:
        clear_flag("bus_secret")
        rcs = kids.close()
    kids.verify_exits(rcs)
    print(json.dumps({"phase": "deploy", "roles": ["broker"] + pems
                      + ["kelvin-deploy"], "checked": True,
                      "ready_s": timings.get("ready_s"),
                      "cli_s": timings.get("cli_s"),
                      "profile": timings.get("profile"),
                      "broker_programz": timings.get("programz"),
                      "broker_ha": timings.get("ha"),
                      "pxclient": timings.get("pxclient"),
                      "pxclient_s": timings.get("pxclient_s"),
                      "exit_codes": rcs,
                      "secs": time.perf_counter() - t_phase,
                      "card": card_line() if device.type == "cuda" else None}))


# -- the failover phase: broker HA, faults and lockdep on one card -------------
FO_BROKERS = 2
FO_LEASE_FLAGS = {"broker_lease_interval_s": 0.1, "broker_lease_expiry_s": 0.5,
                  "broker_reconcile_wait_s": 0.4,
                  "broker_reattach_timeout_s": 8.0}
FO_SCRIPTS = ("px/service_stats", "px/http_stats")
FO_INFLIGHT = 8  # queries in flight at the leader kill, half of each script
FO_TIMEOUT_S = 20.0  # the soak's query timeout
FO_SOAK_AGENTS = 16
FO_HIST_PER_PEM = 4  # hist_fold launches per PEM per px/service_stats


def fo_check(pems, name: str, res, ref) -> None:
    """A served answer (``broker.execute``'s reply) against the single
    engine's: complete, every PEM a data shard (a query the successor
    adopted may have lost its agents' stats in the takeover gap: its
    merged tables are what it is held to), each output held as the
    cluster phase holds it."""
    ref, loose, ordered = ref
    assert res.get("ok") and res["partial"] is False, (name, res)
    if not res.get("failover"):
        assert sorted(res["agent_stats"]) == sorted(
            p.agent_id for p in pems), (name, sorted(res["agent_stats"]))
    assert sorted(res["tables"]) == sorted(ref), name
    for k in ref:
        check_library_output(f"failover {name}:{k}", res["tables"][k], ref[k],
                             loose[k], ordered)


def fo_hist_per_pem(pems) -> dict:
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    return {p.agent_id: hist_fold.launches_by_thread.get(
        f"bus-sub-agent.{p.agent_id}.execute", 0) for p in pems}


def phase_failover(eng, replay, device, window: int = WINDOW,
                   quarter: int = CL_QUARTER, turns: int = CL_TURNS,
                   off_secs: dict | None = None,
                   soak_agents: int = FO_SOAK_AGENTS) -> dict:
    """The cluster phase's layout at full size (4 PEMs holding the main
    replay in quarters, a Kelvin) under 2 ``BrokerReplica``s on one bus,
    with the soak's fast lease clock, every lock built under the port's
    lockdep. A warm-up and ``turns`` healthy turns of px/service_stats
    and px/http_stats through ``chaos.failover_executor``, each held to
    the single engine ``eng``; then FO_INFLIGHT queries in flight and
    the leader killed at the first bridge message (a
    ``FaultInjector.on_match`` trigger): the standby's takeover inside
    the lease bound, every in-flight answer complete and equal or
    ``partial`` with ``broker_failover``, the epoch-fenced dispatches,
    the new leader's next answer of each script, and hist_fold's
    launches per PEM; then one more turn under duplicated execute
    dispatches and dropped acks. After teardown: no lockdep violation,
    the threads and the card's allocated bytes back. Then the chaos
    soak with ``soak_agents`` agents on ``device``. Returns the kernels'
    launches and the phase's numbers."""
    import contextlib
    import gc
    import threading

    import torch

    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.analysis import lockdep
    from pixie_tpu_torch.config import override_flag
    from pixie_tpu_torch.services import FaultInjector, KelvinAgent, MessageBus, PEMAgent
    from pixie_tpu_torch.services.broker_ha import BrokerReplica
    from pixie_tpu_torch.services.chaos import (
        _Ledger, failover_executor, run_chaos_soak)
    from pixie_tpu_torch.services.observability import default_counter

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    refs = {name: cl_reference(eng, name) for name in FO_SCRIPTS}
    gc.collect()
    threads_before = threading.active_count()
    mem_before = torch.cuda.memory_allocated(device) if on_card else 0
    fenced = default_counter("pixie_epoch_fenced_total")
    out = {"phase": "failover", "brokers": FO_BROKERS, "pems": CL_PEMS,
           "rows_per_pem": quarter}
    st = lockdep.enable()  # before any engine, bus or replica is built
    bus, replicas, agents = None, [], []
    try:
        with contextlib.ExitStack() as flags:
            for flag, value in {"self_telemetry": False,
                                "self_profiling": False,
                                **FO_LEASE_FLAGS}.items():
                flags.enter_context(override_flag(flag, value))
            bus = MessageBus()
            replicas = [BrokerReplica(
                bus, f"broker-{i}", leader=i == 0,
                tracker_kw=dict(expiry_s=60.0, check_interval_s=60.0))
                for i in range(FO_BROKERS)]
            pems = []
            for i in range(CL_PEMS):
                pems.append(PEMAgent(
                    bus, f"pem-{i}", engine=Engine(window_rows=window,
                                                   device=device),
                    heartbeat_interval_s=CL_HEARTBEAT_S))
                agents.append(pems[-1].start())
            kelvin = KelvinAgent(bus, "kelvin-0",
                                 engine=Engine(window_rows=window, device=device),
                                 heartbeat_interval_s=CL_HEARTBEAT_S)
            agents.append(kelvin.start())
            t0 = time.perf_counter()
            for i, pem in enumerate(pems):
                for hb in cl_batches(replay, i, i * quarter, (i + 1) * quarter,
                                     window, i * quarter):
                    pem.append_data("http_events", hb)
                pem._register()
            pem = hb = None  # the teardown's memory check counts references
            out["append_s"] = time.perf_counter() - t0
            r0, r1 = replicas
            deadline = time.monotonic() + 30.0
            while not ("http_events" in r0.tracker.schemas()
                       and len(r0.tracker.agent_ids()) == len(agents)
                       and r1.epoch >= r0.epoch):
                assert time.monotonic() < deadline, "HA cluster never converged"
                time.sleep(0.01)
            execute = failover_executor(bus)

            def run(name, **kw):
                t = time.perf_counter()
                res = execute(query_text(name), FO_TIMEOUT_S, **kw)
                return res, time.perf_counter() - t

            # Warm-up, then the healthy turns.
            secs = {}
            for name in FO_SCRIPTS:
                run(name)
                _zero_launches()
                secs[name] = []
                for _ in range(turns):
                    res, s = run(name)
                    fo_check(pems, name, res, refs[name])
                    secs[name].append(s)
                if on_card and name == "px/service_stats":
                    per = fo_hist_per_pem(pems)
                    assert per == {p.agent_id: FO_HIST_PER_PEM * turns
                                   for p in pems}, per
                    out["peak_bytes_healthy"] = {
                        a: st_["usage"].get("device_peak_bytes")
                        for a, st_ in res["agent_stats"].items()}
            out["healthy_secs"] = {n: float(np.median(v)) for n, v in secs.items()}
            out["healthy_turns"] = secs
            if off_secs:
                out["cluster_off_secs"] = {n: off_secs.get(n) for n in FO_SCRIPTS}

            # The leader kill with FO_INFLIGHT queries in flight.
            first_bridge = threading.Event()
            inj = FaultInjector(seed=0)
            inj.on_match("agent.*.bridge", lambda _t, _m: first_bridge.set())
            bus.fault_injector = inj
            ledger = _Ledger()
            counted = failover_executor(bus, ledger)
            fenced_before = fenced.value()
            _zero_launches()
            names = [FO_SCRIPTS[i % 2] for i in range(FO_INFLIGHT)]
            results = [None] * FO_INFLIGHT

            def submit(i):
                try:
                    results[i] = counted(query_text(names[i]), FO_TIMEOUT_S)
                except Exception as e:  # judged below, never swallowed
                    results[i] = e

            workers = [threading.Thread(target=submit, args=(i,))
                       for i in range(FO_INFLIGHT)]
            for w in workers:
                w.start()
            assert first_bridge.wait(60.0), "no bridge message"
            t_kill = time.monotonic()
            r0.kill()
            while r1.role != "leader":
                assert time.monotonic() - t_kill < 10.0, "no takeover"
                time.sleep(0.005)
            takeover_s = time.monotonic() - t_kill
            bound_s = (FO_LEASE_FLAGS["broker_lease_expiry_s"]
                       + 2 * FO_LEASE_FLAGS["broker_lease_interval_s"])
            for w in workers:
                w.join(timeout=4 * FO_TIMEOUT_S)
            assert not any(w.is_alive() for w in workers), "a query hung"
            outcomes = {"complete": 0, "broker_failover": 0}
            for name, res in zip(names, results):
                assert isinstance(res, dict), (name, res)
                if res["partial"]:
                    assert set(res["missing_reasons"].values()) == {
                        "broker_failover"}, (name, res["missing_reasons"])
                    outcomes["broker_failover"] += 1
                else:
                    fo_check(pems, name, res, refs[name])
                    outcomes["complete"] += 1
            kill_hist = fo_hist_per_pem(pems)
            if on_card:
                assert all(n > 0 and n % FO_HIST_PER_PEM == 0
                           for n in kill_hist.values()), kill_hist
            out.update({
                "takeover_s": takeover_s, "takeover_bound_s": bound_s,
                "epoch": r1.epoch, "outcomes": outcomes,
                "adopted": sum(bool(r.get("failover")) for r in results),
                "failover_retries": ledger.snapshot()["failover_retries"],
                "epoch_fenced": fenced.value() - fenced_before,
                "kill_hist_fold_per_pem": kill_hist,
            })
            print(json.dumps({"phase": "failover_kill", **{
                k: out[k] for k in ("takeover_s", "takeover_bound_s", "epoch",
                                    "outcomes", "adopted", "failover_retries",
                                    "epoch_fenced", "kill_hist_fold_per_pem")}}))
            assert takeover_s <= bound_s, (takeover_s, bound_s)
            assert r1.epoch > 1
            bus.fault_injector = None

            # The new leader's next answer of each script.
            after = {}
            for name in FO_SCRIPTS:
                _zero_launches()
                res, s = run(name)
                fo_check(pems, name, res, refs[name])
                after[name] = s
                if on_card and name == "px/service_stats":
                    per = fo_hist_per_pem(pems)
                    assert per == {p.agent_id: FO_HIST_PER_PEM
                                   for p in pems}, per
                    # The abandoned queries' bytes are not charged to the
                    # new leader's first query (DeviceMemoryMonitor).
                    out["peak_bytes_after"] = {
                        a: st_["usage"].get("device_peak_bytes")
                        for a, st_ in res["agent_stats"].items()}
                    for a, peak in out["peak_bytes_after"].items():
                        assert peak <= out["peak_bytes_healthy"][a] + (
                            WINDOW * ROW_BYTES), (a, out["peak_bytes_after"],
                                                  out["peak_bytes_healthy"])
            out["new_leader_secs"] = after
            assert bus.request("broker.agents", {},
                               timeout_s=5.0)["broker"] == "broker-1"

            # Bus faults: duplicated execute dispatches and dropped acks
            # (the dispatch retry re-sends, the agents' dedup re-acks).
            inj2 = FaultInjector(seed=0)
            inj2.duplicate("agent.*.execute")
            inj2.drop("query.*.ack", count=2)
            bus.fault_injector = inj2
            _zero_launches()
            for name in FO_SCRIPTS:
                res, _s = run(name)
                fo_check(pems, name, res, refs[name])
            bus.fault_injector = None
            out["bus_faults"] = {"duplicated": inj2.fired("duplicate"),
                                 "acks_dropped": inj2.fired("drop")}
            assert inj2.fired("drop") == 2 and inj2.fired("duplicate") > 0
            if on_card:
                per = fo_hist_per_pem(pems)
                assert per == {p.agent_id: FO_HIST_PER_PEM for p in pems}, per
                out["bus_faults"]["hist_fold_per_pem"] = per
    finally:
        if bus is not None:
            bus.fault_injector = None
        for a in agents:
            a.stop()
        for r in replicas:
            if not r._dead:
                r.close()
        if bus is not None:
            bus.close()
        lockdep.disable()
    out["lockdep"] = {"tracked_locks": st.tracked_locks, "edges": len(st.edges),
                      "violations": len(st.violations)}
    assert st.violations == [], "\n---\n".join(str(v) for v in st.violations)
    del agents, pems, kelvin, replicas, bus, results
    deadline = time.monotonic() + 12.0
    while threading.active_count() > threads_before:
        assert time.monotonic() < deadline, [t.name for t in threading.enumerate()]
        time.sleep(0.2)
    gc.collect()
    out["threads"] = {"before": threads_before,
                      "after": threading.active_count()}
    if on_card:
        mem_after = torch.cuda.memory_allocated(device)
        out["allocated"] = {"before": mem_before, "after": mem_after}
        assert mem_after <= mem_before + WINDOW * ROW_BYTES, out["allocated"]
    out["secs"] = time.perf_counter() - t_phase
    print(json.dumps(out))

    t0 = time.perf_counter()
    report = run_chaos_soak(n_agents=soak_agents, n_brokers=2, seed=0,
                            device=device)
    d = report.to_dict()
    print(json.dumps({"phase": "failover_soak", "secs": time.perf_counter() - t0,
                      "report": d}))
    assert report.ok and report.lost == [] and not report.thread_leak, d
    assert report.leader_kills == 1 and report.failovers >= 1, d
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"hist_fold": {"per_pem_per_query": FO_HIST_PER_PEM,
                          "leader_kill": out["kill_hist_fold_per_pem"]},
            "takeover_s": out["takeover_s"], "outcomes": out["outcomes"],
            "epoch_fenced": out["epoch_fenced"]}


# -- device-resident results, the port's bench and its gates --------------------
DR_SCRIPTS = ("px/http_stats", "px/service_stats")
DR_MAX_GROUPS = 64  # the forced rebucket: 256 groups climb 64 -> 128 -> 256
BENCH_HEAD_ROWS = 1 << 22  # pixie_tpu_torch.bench's head rows in this run


def d2h_copies(prof) -> int:
    """Device-to-host copies in a torch.profiler trace."""
    return sum(1 for e in prof.events() if "DtoH" in e.name)


def _sorted_columns(hb, keys) -> dict:
    d = {k: np.asarray(v) for k, v in hb.to_pydict().items()}
    order = np.lexsort([d[k] for k in reversed(keys)])
    return {k: v[order] for k, v in d.items()}


def phase_device_result(eng, expect: Expect) -> None:
    """``execute_query(materialize=False)`` on the resident main replay:
    the DeviceResult's ``to_host()`` against the materialized answer
    (px/http_stats exact, px/service_stats within the serving checks'
    tolerances) and numpy's; the device-to-host copies made before
    ``execute_query`` returns and inside ``to_host()`` (torch.profiler);
    then one rebucket forced inside ``to_host()``: px/http_stats compiled,
    its AggOp cut to 64 groups, dense key domains off, run through
    ``execute_plan(materialize=False)``."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pixie_tpu_torch.config import override_flag
    from pixie_tpu_torch.exec.engine import DeviceResult
    from pixie_tpu_torch.exec.plan import AggOp
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name in DR_SCRIPTS:
        q = query_text(name)
        t0 = time.perf_counter()
        mat = eng.execute_query(q)["output"]
        mat_s = time.perf_counter() - t0
        expect.check(name, mat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute_query(q, materialize=False)["output"]
        return_s = time.perf_counter() - t0
        assert isinstance(res, DeviceResult), type(res)
        assert res.block_until_ready() is res
        ready_s = time.perf_counter() - t0
        host = res.to_host()
        total_s = time.perf_counter() - t0
        assert res.to_host() is host
        expect.check(name, host)
        if name == "px/http_stats":  # exact int64 folds: bit-identical
            keys = ["service", "req_path"]
            got, want = _sorted_columns(host, keys), _sorted_columns(mat, keys)
            assert set(got) == set(want)
            for c in got:
                assert np.array_equal(got[c], want[c]), f"device_result {c}"
        else:
            sv_check(f"device_result {name}", name, host, mat)
        # The copies: before execute_query returns, and in to_host.
        with profile(activities=acts) as before:
            res = eng.execute_query(q, materialize=False)["output"]
        with profile(activities=acts) as inside:
            res.to_host()
        copies = {"before_return": d2h_copies(before),
                  "in_to_host": d2h_copies(inside)}
        assert copies["in_to_host"] > 0, copies
        print(json.dumps({
            "phase": "device_result", "script": name,
            "materialized_s": mat_s, "return_s": return_s,
            "block_until_ready_s": ready_s, "to_host_total_s": total_s,
            "d2h_copies": copies, "checked": True,
        }))

    # A result kept on the card is not part of the next query's peak.
    q = query_text("px/http_stats")
    eng.execute_query(q)
    alone = eng.tracer.last().usage.device_peak_bytes
    kept = eng.execute_query(q, materialize=False)["output"]
    eng.execute_query(q)
    beside = eng.tracer.last().usage.device_peak_bytes
    kept.to_host()
    print(json.dumps({"phase": "device_result", "check": "peak",
                      "alone": alone, "beside_a_kept_result": beside}))
    assert beside == alone, (alone, beside)

    # A rebucket inside to_host: with dense domains off, the 256
    # (service, path) groups overflow a 64-group fold twice.
    state = CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, table_stats=eng._compile_table_stats(),
    )
    plan = compile_pxl(q, state).plan
    for node in plan.nodes.values():
        if isinstance(node.op, AggOp):
            node.op = dataclasses.replace(node.op, max_groups=DR_MAX_GROUPS)
    with override_flag("dense_domain_limit", 1):
        t0 = time.perf_counter()
        res = eng.execute_plan(plan, materialize=False)["output"]
        return_s = time.perf_counter() - t0
        st = eng.last_stats
        assert isinstance(res, DeviceResult) and st.rebuckets == 0
        host = res.to_host()
        total_s = time.perf_counter() - t0
    expect.check("px/http_stats", host)
    marked = sum("rebucket" in f.ops for f in st.fragments)
    assert st.rebuckets == marked == 2, (st.rebuckets, marked)
    print(json.dumps({
        "phase": "device_result", "check": "rebucket_in_to_host",
        "max_groups": DR_MAX_GROUPS, "rebuckets": st.rebuckets,
        "windows": st.windows, "return_s": return_s,
        "to_host_total_s": total_s, "groups": host.length, "checked": True,
    }))


# -- the concurrency phase: queries from several threads on one engine ---------
CC_THREADS = (2, 4)
CC_TURNS = 3
CC_SOLO_TURNS = 3
CC_INGEST_BASE = 1 << 20
CC_INGEST_ROWS = 1 << 17
CC_INGEST_QUERIES = 10
CC_SWEEP = (1, 2, 4)
CC_SWEEP_PER_WORKER = 5
CC_SOLO_LAUNCHES = {
    "px/http_stats": {"dense_fold": 0, "hist_fold": 0},
    "http_stats_float64": {"dense_fold": ROWS // WINDOW, "hist_fold": 0},
    "px/service_stats": {"dense_fold": 0, "hist_fold": 2 * ROWS // WINDOW},
}
CC_COUNT = """import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('latency_ns', px.count))
px.display(df)
"""
CC_SWEEP_QUERY = """import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('latency_ns', px.count),
                               m=('latency_ns', px.mean))
px.display(df)
"""


def cc_thread_launches() -> dict:
    """Each kernel's launches so far by the calling thread (the counters
    are kept per thread name, and a query folds on its caller's
    thread)."""
    import threading

    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    name = threading.current_thread().name
    return {"dense_fold": dense_fold.launches_by_thread.get(name, 0),
            "hist_fold": hist_fold.launches_by_thread.get(name, 0)}


def cc_query(eng, name: str, **kw):
    """(output, seconds, this query's launches) of one query run on the
    calling thread."""
    before = cc_thread_launches()
    t0 = time.perf_counter()
    out = eng.execute_query(query_text(name), **kw)["output"]
    secs = time.perf_counter() - t0
    after = cc_thread_launches()
    return out, secs, {k: after[k] - before[k] for k in after}


def cc_rendezvous(eng, n: int):
    """Hold the first window of the first ``n`` scans on ``eng`` until
    all ``n`` have reached it, so the queries that own them are in
    flight at once. Returns the undo."""
    import threading

    orig = eng._staged_windows
    barrier = threading.Barrier(n, timeout=60.0)
    lock = threading.Lock()
    calls = [0]

    def synced(stream, stats, cancel):
        with lock:
            calls[0] += 1
            first = calls[0] <= n
        if first:
            barrier.wait()
        yield from orig(stream, stats, cancel)

    eng._staged_windows = synced
    return lambda: eng.__dict__.pop("_staged_windows", None)


def cc_threads(n: int, work, tag: str) -> float:
    """Run ``work(i)`` on ``n`` named threads; the wall seconds. Any
    exception on a thread fails the phase."""
    import threading

    errors: list = []

    def run(i):
        try:
            work(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(f"thread {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,), name=f"{tag}-{i}")
               for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    assert not errors, errors
    return wall


def cc_check_traces(eng, n_queries: int, what: str) -> list:
    """The last ``n_queries`` traces: each finished ok over every row of
    the replay, and none is left in flight."""
    traces = eng.tracer.recent()[:n_queries]
    assert len(traces) == n_queries, (what, len(traces))
    bad = [(t["status"], t["usage"]["rows_in"]) for t in traces
           if t["status"] != "ok" or t["usage"]["rows_in"] != ROWS]
    assert not bad, (what, bad)
    assert not eng.tracer.in_flight(), (what, eng.tracer.in_flight())
    return traces


def device_busy_s(prof) -> float:
    """Seconds in which the card ran at least one kernel, copy or set
    recorded by ``prof``: the union of their device intervals, so work
    that overlaps (several queries' streams, the stager's copy stream)
    counts once."""
    from torch.autograd import DeviceType

    # The profiler's raw records: its event tree (``prof.events()``) costs
    # seconds to build for a turn of many queries.
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy_ns, lo, hi = 0, None, None
    for start, end in spans:
        if hi is None or start > hi:
            if hi is not None:
                busy_ns += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        busy_ns += hi - lo
    return busy_ns / 1e9


def cc_turn(eng, solo: dict, n: int) -> dict:
    """``n`` threads on ``eng``, each running the three scripts, rotated
    per thread, for CC_TURNS turns under torch.profiler: every answer
    against the serial one, every query's launches against the solo
    query's, ``max_inflight`` equal to ``n``, each trace over all
    16,777,216 rows; the wall and the card's idle share over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    records: list = []

    def work(i):
        for turn in range(CC_TURNS):
            for j in range(len(AGG_SCRIPTS)):
                name = AGG_SCRIPTS[(i + j + turn) % len(AGG_SCRIPTS)]
                records.append((name, *cc_query(eng, name)))

    eng.max_inflight = 0
    undo = cc_rendezvous(eng, n)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cc_threads(n, work, f"cc{n}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        undo()
    busy_s = device_busy_s(prof)
    assert 0.0 < busy_s <= wall, (busy_s, wall)
    n_queries = n * CC_TURNS * len(AGG_SCRIPTS)
    assert len(records) == n_queries, len(records)
    for name, out, _secs, launches in records:
        sv_check(f"concurrency {n} threads {name}", name, out,
                 solo[name]["out"])
        assert launches == solo[name]["launches"], (name, launches)
    assert eng.max_inflight == n, (n, eng.max_inflight)
    cc_check_traces(eng, n_queries, f"{n} threads")
    serial_s = n * CC_TURNS * sum(solo[s]["secs"] for s in AGG_SCRIPTS)
    return {"threads": n, "queries": n_queries,
            "wall_s": wall, "serial_equivalent_s": serial_s,
            "wall_over_serial": wall / serial_s,
            "max_inflight": eng.max_inflight,
            "query_secs": {s: float(np.median([r[2] for r in records
                                               if r[0] == s]))
                           for s in AGG_SCRIPTS},
            "launches_per_query": {s: solo[s]["launches"]
                                   for s in AGG_SCRIPTS},
            "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall,
            "checked": True}


def cc_cancel(eng, solo: dict) -> dict:
    """Two concurrent px/service_stats queries (each window held 20 ms);
    once both have a window, one is cancelled: it raises QueryCancelled
    and its trace ends ``cancelled``, and the other's answer and launches
    equal the serial ones."""
    import threading

    from pixie_tpu_torch.exec.stream import QueryCancelled

    name = "px/service_stats"
    cancel, both = threading.Event(), threading.Event()
    orig = eng._staged_windows
    lock = threading.Lock()
    scans = [0]
    out: dict = {}

    def slow(stream, stats, cancel_):
        first = True
        for w in orig(stream, stats, cancel_):
            if first:
                first = False
                with lock:
                    scans[0] += 1
                    if scans[0] == 2:
                        both.set()
            time.sleep(0.02)
            yield w

    def work(i):
        if i == 0:
            try:
                eng.execute_query(query_text(name), cancel=cancel)
                out["cancelled"] = "completed"
            except QueryCancelled:
                out["cancelled"] = "cancelled"
        elif i == 1:
            out["free"] = cc_query(eng, name)
        else:
            assert both.wait(60.0), "the two queries never overlapped"
            cancel.set()

    eng._staged_windows = slow
    try:
        cc_threads(3, work, "cc-cancel")
    finally:
        eng.__dict__.pop("_staged_windows", None)
    assert out["cancelled"] == "cancelled", out["cancelled"]
    free, secs, launches = out["free"]
    sv_check("concurrency cancel", name, free, solo[name]["out"])
    assert launches == solo[name]["launches"], launches
    status = [t["status"] for t in eng.tracer.recent()[:2]]
    assert sorted(status) == ["cancelled", "ok"], status
    assert not eng.tracer.in_flight()
    return {"cancelled": out["cancelled"], "free_secs": secs,
            "statuses": status, "checked": True}


def cc_residency_off(eng, solo: dict) -> dict:
    """Two threads with residency off: every window of both queries
    stages through the card's one ``_Stager`` (its lock over the pinned
    copy, its copy stream); answers and launches as the serial ones,
    each query's staging seconds."""
    from pixie_tpu_torch.config import override_flag

    records: list = []

    def work(i):
        for j in range(len(AGG_SCRIPTS)):
            name = AGG_SCRIPTS[(i + j) % len(AGG_SCRIPTS)]
            records.append((name, *cc_query(eng, name)))

    eng.max_inflight = 0
    undo = cc_rendezvous(eng, 2)
    try:
        with override_flag("device_residency", False):
            wall = cc_threads(2, work, "cc-staged")
    finally:
        undo()
    for name, out, _secs, launches in records:
        sv_check(f"concurrency residency off {name}", name, out,
                 solo[name]["out"])
        assert launches == solo[name]["launches"], (name, launches)
    assert eng.max_inflight == 2, eng.max_inflight
    traces = cc_check_traces(eng, len(records), "residency off")
    by_text = {query_text(s)[:200]: s for s in AGG_SCRIPTS}  # as traced
    per_query = [{
        "script": by_text.get(t["query"], t["query"][:40]),
        "stage_secs": t["pipeline"]["stage_secs"],
        "stall_secs": t["pipeline"]["stall_secs"],
        "bytes_staged": t["usage"]["bytes_staged"],
        "duration_ms": t["duration_ms"],
    } for t in traces]
    assert all(q["bytes_staged"] > 0 for q in per_query), per_query
    return {"wall_s": wall, "queries": per_query, "checked": True}


def cc_ingest(replay, device) -> dict:
    """Appends of 2^17 rows race 10 count queries on an engine on the
    card: each count is no lower than the one before, and the last
    query after the appends counts every row."""
    import threading

    from pixie_tpu_torch import Engine

    ing = Engine(window_rows=WINDOW, device=device)
    ing.create_table("http_events")
    append_replay(ing, tuple(a[:CC_INGEST_BASE] for a in replay), WINDOW)
    ing.execute_query(CC_COUNT)
    stop = threading.Event()
    appended = [CC_INGEST_BASE]

    def ingest():
        lo = CC_INGEST_BASE
        while not stop.is_set() and lo + CC_INGEST_ROWS <= ROWS:
            hi = lo + CC_INGEST_ROWS
            append_replay(ing, tuple(a[lo:hi] for a in replay), WINDOW,
                          start=lo)
            appended[0] = lo = hi

    t = threading.Thread(target=ingest, name="cc-ingest")
    counts = []
    t0 = time.perf_counter()
    t.start()
    try:
        for _ in range(CC_INGEST_QUERIES):
            out = ing.execute_query(CC_COUNT)["output"].to_pydict()
            counts.append(int(np.sum(out["n"])))
            time.sleep(0.05)  # an append's time: the appends interleave
    finally:
        stop.set()
        t.join()
    secs = time.perf_counter() - t0
    assert all(b >= a for a, b in zip(counts, counts[1:])), counts
    assert counts[0] >= CC_INGEST_BASE, counts
    final = int(np.sum(ing.execute_query(CC_COUNT)["output"]
                       .to_pydict()["n"]))
    assert final == appended[0], (final, appended[0])
    torn = sum((c - CC_INGEST_BASE) % CC_INGEST_ROWS != 0 for c in counts)
    return {"counts": counts, "final": final, "appends": (
        appended[0] - CC_INGEST_BASE) // CC_INGEST_ROWS,
        "counts_inside_an_append": torn, "secs": secs, "checked": True}


def cc_sweep(device) -> dict:
    """The load tester's concurrency sweep over its local executor on
    ``device``: no errors, the serving histogram's delta equal to the
    queries sent, two queries in flight at once at least. A pass or a
    failure only: the executor's own 200,000-row table and a few requests
    per client give no throughput or tail worth printing."""
    from pixie_tpu_torch.services.load_tester import (
        local_executor, run_concurrency_sweep)

    execute = local_executor(device=device)
    reports = run_concurrency_sweep(
        execute, CC_SWEEP_QUERY, concurrencies=CC_SWEEP,
        per_worker=CC_SWEEP_PER_WORKER)
    counts = {}
    for n, rep in sorted(reports.items()):
        d = rep.to_dict()
        assert rep.errors == 0, d
        assert d.get("hist_count", 0) == n * CC_SWEEP_PER_WORKER, d
        counts[n] = d["hist_count"]
    assert execute.engine.max_inflight >= 2, execute.engine.max_inflight
    return {"errors": 0, "hist_count": counts,
            "max_inflight": execute.engine.max_inflight, "checked": True}


def phase_concurrency(eng, replay, expect: Expect, device) -> None:
    """Queries from several threads on the main engine over the resident
    16M-row replay: the serial baseline, 2 and 4 threads running the
    three scripts mixed (timed under torch.profiler), a cancel, a turn
    with residency off, appends racing queries (on an engine of its own)
    and the load tester's sweep. Each check prints its own seconds."""
    import gc

    t_phase = time.perf_counter()

    def report(check: str, step) -> None:
        t0 = time.perf_counter()
        rec = step()
        print(json.dumps({"phase": "concurrency", "check": check, **rec,
                          "check_secs": time.perf_counter() - t0}))

    solo: dict = {}

    def run_solo() -> dict:
        for name in AGG_SCRIPTS:
            eng.execute_query(query_text(name))
            runs = [cc_query(eng, name) for _ in range(CC_SOLO_TURNS)]
            out, _secs, launches = runs[-1]
            expect.check(name, out)
            assert launches == CC_SOLO_LAUNCHES[name], (name, launches)
            solo[name] = {"out": out, "launches": launches,
                          "secs": float(np.median([r[1] for r in runs]))}
        return {"scripts": {s: {"secs": v["secs"], "launches": v["launches"]}
                            for s, v in solo.items()}, "checked": True}

    report("solo", run_solo)
    for n in CC_THREADS:
        report("turn", lambda: cc_turn(eng, solo, n))
    report("cancel", lambda: cc_cancel(eng, solo))
    report("residency_off", lambda: cc_residency_off(eng, solo))
    report("ingest", lambda: cc_ingest(replay, device))
    gc.collect()
    report("load_tester_sweep", lambda: cc_sweep(device))
    print(json.dumps({"phase": "concurrency", "check": "seconds",
                      "secs": time.perf_counter() - t_phase}))


# -- the otel phase: px.export and the OTLP trace push on the card -------------
OT_SPAN_BELOW = 13_000  # latency_ns under this: about 2,000 of 2^24 rows
OT_EXPORT = """
px.export(per_svc, px.otel.Data(
    endpoint=px.otel.Endpoint(url='{url}'),
    resource={{'service.name': per_svc.service,
              'k8s.cluster.name': 'chip-smoke'}},
    data=[
        px.otel.metric.Summary(name='http.latency', unit='ns',
            count=per_svc.throughput,
            quantile_values={{0.5: per_svc.p50, 0.99: per_svc.p99}}),
        px.otel.metric.Gauge(name='http.error_rate', value=per_svc.error_rate),
    ],
))
"""
OT_SPANS = f"""import px
df = px.DataFrame(table='http_events')
df = df[df.latency_ns < {OT_SPAN_BELOW}]
df.end_time = df.time_ + px.int64_to_time(df.latency_ns)
px.export(df, px.otel.Data(
    resource={{'service.name': df.service}},
    data=[px.otel.trace.Span(name=df.req_path, start_time=df.time_,
        end_time=df.end_time, attributes={{'http.status': df.resp_status}})],
))
"""


def ot_export_query(url: str = "") -> str:
    """px/service_stats, its per-service table also exported as an OTel
    Summary (count, p50, p99) and a Gauge (error rate) per service."""
    return query_text("px/service_stats") + OT_EXPORT.format(url=url)


class OtlpReceiver:
    """An OTLP/HTTP receiver on 127.0.0.1 (a stdlib ``http.server``
    thread): records (path, JSON body) and answers 200."""

    def __init__(self):
        import http.server
        import threading

        self.received = []
        rec = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                rec.received.append((self.path, json.loads(body)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="otlp-receiver", daemon=True)
        self.thread.start()

    def stop(self) -> None:
        if self.thread.is_alive():
            self.httpd.shutdown()
            self.httpd.server_close()
            self.thread.join(timeout=10)


def ot_check_summary(payload: dict, out, want: dict) -> None:
    """An export of ``ot_export_query`` against the query's own table
    (counts exact; values at rtol 1e-6: the export reads the folded
    batch, the display reads it after its limit ran on the card, where
    FLOAT64 is f32) and numpy (``expect_service_stats``: counts exact,
    p50/p99 within 15%, the error rate at rtol 1e-4, as
    ``check_service_stats``)."""
    got = out.to_pydict()
    row = {s: i for i, s in enumerate(got["service"])}
    rms = payload["resourceMetrics"]
    assert len(rms) == N_SERVICES == len(row), len(rms)
    assert "resourceSpans" not in payload
    for rm in rms:
        attrs = {kv["key"]: kv["value"]["stringValue"]
                 for kv in rm["resource"]["attributes"]}
        assert attrs["k8s.cluster.name"] == "chip-smoke", attrs
        svc = attrs["service.name"]
        i, (r50, r99, rerr, rthr) = row[svc], want[int(svc[len("svc-"):])]
        gauge, summary = rm["scopeMetrics"][0]["metrics"]
        assert (gauge["name"], summary["name"]) == (
            "http.error_rate", "http.latency")
        (gp,) = gauge["gauge"]["dataPoints"]
        (sp,) = summary["summary"]["dataPoints"]
        np.testing.assert_allclose(gp["asDouble"], got["error_rate"][i],
                                   rtol=1e-6)
        np.testing.assert_allclose(gp["asDouble"], rerr, rtol=1e-4)
        assert sp["count"] == int(got["throughput"][i]) == rthr, (svc, sp)
        q = sp["quantileValues"]
        assert [v["quantile"] for v in q] == [0.5, 0.99]
        np.testing.assert_allclose([v["value"] for v in q],
                                   [got["p50"][i], got["p99"][i]], rtol=1e-6)
        assert abs(q[0]["value"] - r50) / r50 < 0.15, (svc, q, r50)
        assert abs(q[1]["value"] - r99) / r99 < 0.15, (svc, q, r99)


def ot_check_spans(payload: dict, replay) -> int:
    """A span per row of the filtered row chain ``OT_SPANS``: start and
    end times, names and the status attribute exactly numpy's."""
    svc, path, lat, status = replay
    idx = np.flatnonzero(lat < OT_SPAN_BELOW)
    spans = []
    for rs in payload["resourceSpans"]:
        (name,) = [kv["value"]["stringValue"]
                   for kv in rs["resource"]["attributes"]]
        for sp in rs["scopeSpans"][0]["spans"]:
            spans.append((sp["startTimeUnixNano"], sp["endTimeUnixNano"],
                          name, sp["name"],
                          sp["attributes"][0]["value"]["stringValue"]))
    spans.sort()
    assert len(spans) == len(idx) > 0, (len(spans), len(idx))
    want = [(int(i), int(i + lat[i]), f"svc-{svc[i]}", f"/api/v1/ep{path[i]}",
             str(int(status[i]))) for i in idx]
    assert spans == want, "OTel spans differ from numpy's rows"
    return len(spans)


def _counter(registry, name: str) -> float:
    return sum(registry.values(name).values())


def phase_otel(eng, expect: Expect) -> dict:
    """OTel export on the resident main replay. ``ot_export_query``
    (px/service_stats and its export) with the engine's default
    in-memory egress: the answer held to numpy, the payload to the
    answer and to numpy, hist_fold's launches counted; then with an
    ``OTLPHttpExporter`` to a loopback receiver bound as the engine's
    ``export_otel`` (what the receiver got equals the payload the engine
    made); ``OT_SPANS`` (a span per row of a filtered row chain) through
    the same exporter, held to numpy. Then the ``trace_export_url`` flag
    set to the receiver: the query's trace arrives on ``/v1/traces``
    with a span per window; with the receiver stopped the query still
    answers and ``pixie_trace_export_errors_total`` counts the failed
    push. Returns the kernels' launches of the in-memory export query."""
    from pixie_tpu_torch.config import override_flag
    from pixie_tpu_torch.exec.otel import OTLPHttpExporter

    t_phase = time.perf_counter()
    want = expect_service_stats(expect.replay)
    out = {"phase": "otel"}
    eng.otel_exports.clear()
    eng.execute_query(ot_export_query())  # warm-up
    eng.otel_exports.clear()
    _zero_launches()
    t0 = time.perf_counter()
    res = eng.execute_query(ot_export_query())["output"]
    out["export_secs"] = time.perf_counter() - t0
    launches = _launch_counts()
    expect.check("px/service_stats", res)
    (exp,) = eng.otel_exports
    ot_check_summary(exp["payload"], res, want)
    eng.otel_exports.clear()
    out["launches"] = launches
    out["windows"] = eng.last_stats.windows
    t0 = time.perf_counter()
    res = eng.execute_query(query_text("px/service_stats"))["output"]
    out["display_only_secs"] = time.perf_counter() - t0
    expect.check("px/service_stats", res)
    if eng.device.type == "cuda":
        assert launches["hist_fold"] > 0, launches

    rx = OtlpReceiver()
    try:
        pusher = OTLPHttpExporter(rx.url)
        made = []

        def push(payload, endpoint):
            made.append(payload)
            pusher(payload, endpoint)

        eng.export_otel = push
        try:
            t0 = time.perf_counter()
            res = eng.execute_query(ot_export_query(rx.url))["output"]
            out["push_secs"] = time.perf_counter() - t0
            expect.check("px/service_stats", res)
            assert rx.received == [("/v1/metrics", {
                "resourceMetrics": made[0]["resourceMetrics"]})], rx.received
            ot_check_summary(rx.received[0][1], res, want)
            rx.received.clear()
            t0 = time.perf_counter()
            eng.execute_query(OT_SPANS)
            out["spans_secs"] = time.perf_counter() - t0
            assert rx.received == [("/v1/traces", {
                "resourceSpans": made[1]["resourceSpans"]})]
            out["spans"] = ot_check_spans(rx.received[0][1], expect.replay)
            assert (pusher.pushed, pusher.errors) == (2, 0)
        finally:
            del eng.export_otel  # back to the in-memory egress
        assert not eng.otel_exports

        rx.received.clear()
        q = query_text("px/service_stats")
        with override_flag("trace_export_url", rx.url), \
                override_flag("trace_window_sample", 1):
            t0 = time.perf_counter()
            res = eng.execute_query(q)["output"]
            out["traced_secs"] = time.perf_counter() - t0
            expect.check("px/service_stats", res)
            tr = eng.tracer.last()
            ((path, body),) = rx.received
            assert path == "/v1/traces" and tr.exported
            spans = body["resourceSpans"][0]["scopeSpans"][0]["spans"]
            assert {s["traceId"] for s in spans} == {tr.trace_id}
            names = [s["name"] for s in spans]
            assert names[0] == "query" and "fragment" in names, names
            assert names.count("window.compute") == eng.last_stats.windows
            out["trace_spans"] = len(spans)
            rx.stop()
            before = _counter(eng.tracer.registry,
                              "pixie_trace_export_errors_total")
            t0 = time.perf_counter()
            res = eng.execute_query(q)["output"]
            out["collector_down_secs"] = time.perf_counter() - t0
            expect.check("px/service_stats", res)
            after = _counter(eng.tracer.registry,
                             "pixie_trace_export_errors_total")
            assert after == before + 1 and not eng.tracer.last().exported
            out["export_errors"] = after - before
    finally:
        rx.stop()
    out["checked"] = True
    out["secs"] = time.perf_counter() - t_phase
    out["card"] = card_line() if eng.device.type == "cuda" else None
    print(json.dumps(out))
    return launches


def cl_otel(c, replay) -> dict:
    """The export through the broker (agent mode): the sink runs on the
    Kelvin, no PEM's engine holds an export, and the payload equals the
    merged answer and numpy."""
    for a in c.agents:
        a.engine.otel_exports.clear()
    t0 = time.perf_counter()
    res = c.broker.execute_script(ot_export_query(), timeout_s=120.0)
    secs = time.perf_counter() - t0
    assert len(c.kelvin.engine.otel_exports) == 1
    assert not any(p.engine.otel_exports for p in c.pems)
    ot_check_summary(c.kelvin.engine.otel_exports[0]["payload"],
                     res["tables"]["output"], expect_service_stats(replay))
    rec = {"phase": "cluster_otel", "checked": True, "secs": secs,
           "sink": c.kelvin.agent_id, "pem_exports": 0}
    print(json.dumps(rec))
    return rec


# -- the operator phase: the roles kept alive by the Reconciler ----------------
OP_RUN_S = 30.0  # tests/test_soak.py queries for 90 s; cut to 30 s here
OP_KILL_AT_S = 5.0
OP_AFTER = 5  # queries that must succeed after the killed PEM is back
OP_LIMIT_S = 150.0
OP_PEMS = ("pem-op-0", "pem-op-1")


def phase_operator(device) -> None:
    """``tests/test_soak.py``'s scenario on the card, through
    ``services.operator.Reconciler`` in this process (not YAML): it
    starts ``python -m pixie_tpu_torch.deploy broker``, two ``pem`` roles
    with the seq-gen source and a ``kelvin``, each a process on the
    card. Queries run back to back over the netbus (``api.Client``)
    for OP_RUN_S; OP_KILL_AT_S in, one PEM is SIGKILLed. The operator
    restarts it within its backoff, and every query after the restarted
    PEM re-registers (the broker lists it under a new ASID with its
    tables) succeeds and covers both PEMs (the count of seq-gen rows with
    x < DP_SEQ_BOUND is one transfer per PEM, and the answer's agent
    stats name both). At the end ``Reconciler.stop`` leaves no child,
    and the card's used bytes are back at the phase's base."""
    import signal
    import tempfile

    import torch

    from pixie_tpu_torch.api import Client
    from pixie_tpu_torch.services import Reconciler, RoleSpec

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"

    def used() -> int:
        free, total = torch.cuda.mem_get_info(device)
        return total - free

    base = used() if on_card else None
    netbus = _free_port()
    logs = tempfile.mkdtemp(prefix="chip_smoke_operator_")
    env = child_env(device, PIXIE_TPU_NETBUS_PORT=netbus,
                    PIXIE_TPU_OBS_PORT=0,
                    PIXIE_TPU_BROKER=f"127.0.0.1:{netbus}")
    role = [sys.executable, "-m", "pixie_tpu_torch.deploy"]

    def spec(name, argv, **extra):
        e = {**env, "PIXIE_TPU_CRASH_LOG": os.path.join(logs, f"{name}.crash"),
             **{k: str(v) for k, v in extra.items()}}
        return RoleSpec(name=name, command=tuple(argv), env=tuple(e.items()))

    specs = {"broker": spec("broker", role + ["broker"])}
    for aid in OP_PEMS:
        specs[aid] = spec(aid, role + ["pem"], PIXIE_TPU_AGENT_ID=aid,
                          PIXIE_TPU_SEQGEN=1)
    specs["kelvin"] = spec("kelvin", role + ["kelvin"],
                           PIXIE_TPU_AGENT_ID="kelvin-op")
    bounded = ("import px\ndf = px.DataFrame(table='sequences')\n"
               f"df = df[df.x < {DP_SEQ_BOUND}]\n"
               "s = df.agg(n=('x', px.count))\npx.display(s)\n")
    full = DP_SEQ_BOUND * len(OP_PEMS)
    rec = Reconciler(specs, check_interval_s=0.5, base_backoff_s=0.5,
                     max_backoff_s=4.0)
    seen: set = set()

    def note_pids():
        for st in rec.status():
            if st["pid"] is not None:
                seen.add(st["pid"])

    def registration(aid):
        """(asid, tables) the broker lists for ``aid``, None if none."""
        with Client("127.0.0.1", netbus, connect_timeout_s=2.0) as c:
            for a in c.agents():
                if a["agent_id"] == aid:
                    return a["asid"], a["num_tables"]
        return None

    def one_query():
        t0 = time.perf_counter()
        try:
            with Client("127.0.0.1", netbus, connect_timeout_s=2.0) as c:
                res = c.execute_script(bounded, timeout_s=15.0)
            n = int(res["output"]["n"][0]) if len(res["output"]["n"]) else 0
            return {"t": t0 - t_phase, "ok": True, "n": n,
                    "agents": sorted(res.agent_stats),
                    "secs": time.perf_counter() - t0}
        except Exception as e:
            return {"t": t0 - t_phase, "ok": False,
                    "error": f"{type(e).__name__}: {e}"[:200],
                    "secs": time.perf_counter() - t0}

    results = []
    kill = {}
    rec.run_as_thread()
    try:
        deadline = time.perf_counter() + DP_START_S
        while True:
            note_pids()
            r = one_query()
            if r["ok"] and r["n"] == full:
                break
            assert time.perf_counter() < deadline, (
                f"the operator's roles never answered: {r}, {rec.status()}")
            time.sleep(0.5)
        ready_s = time.perf_counter() - t_phase
        t_run = time.perf_counter()
        while True:
            now = time.perf_counter() - t_run
            note_pids()
            if not kill and now >= OP_KILL_AT_S:
                (st,) = [s for s in rec.status() if s["role"] == OP_PEMS[0]]
                old = registration(OP_PEMS[0])
                os.kill(st["pid"], signal.SIGKILL)
                kill = {"pid": st["pid"], "t": time.perf_counter(),
                        "asid": old[0], "tables": old[1]}
            if kill and "restart_s" not in kill:
                (st,) = [s for s in rec.status() if s["role"] == OP_PEMS[0]]
                if st["alive"] and st["pid"] != kill["pid"]:
                    kill["restart_s"] = time.perf_counter() - kill["t"]
            if "restart_s" in kill and "back_s" not in kill:
                reg = registration(OP_PEMS[0])
                if reg and reg[0] != kill["asid"] and reg[1] >= kill["tables"]:
                    kill["back_s"] = time.perf_counter() - kill["t"]
                    kill["back_at"] = len(results)
                    kill["new_asid"] = reg[0]
            r = one_query()
            r["after_kill"] = bool(kill)
            results.append(r)
            after = (len(results) - 1 - kill["back_at"]
                     if "back_at" in kill else 0)
            if now >= OP_RUN_S and after >= OP_AFTER:
                break
            assert now < OP_LIMIT_S, (
                f"the killed PEM never came back: {kill}, {results[-3:]}")
    finally:
        note_pids()
        t0 = time.perf_counter()
        rec.stop()
        stop_s = time.perf_counter() - t0
    alive = [p for p in seen if _pid_alive(p)]
    assert not alive, f"children left after Reconciler.stop: {alive}"
    events = [e[1] for e in rec.events]
    assert "crashed" in events and "restarted" in events, events
    assert kill["restart_s"] < rec.base_backoff_s + 2 * rec.check_interval_s + 2.0, kill
    before = [r for r in results if not r["after_kill"]]
    assert before and all(r["ok"] and r["n"] == full for r in before), before
    back = results[kill["back_at"]:]
    bad = [r for r in back
           if not (r["ok"] and r["n"] == full and r["agents"] == sorted(OP_PEMS))]
    assert not bad, (f"queries after the PEM came back failed: {bad[:3]}",
                     [(round(r["t"], 2), r.get("n"), r.get("agents"),
                       r.get("error")) for r in results], kill)
    gap = results[len(before):kill["back_at"]]
    freed = None
    if on_card:
        deadline = time.perf_counter() + 30.0
        while used() > base and time.perf_counter() < deadline:
            time.sleep(0.2)
        freed = used() - base
        assert freed <= 0, f"the card holds {freed} bytes more than before"
    print(json.dumps({
        "phase": "operator", "checked": True, "roles": sorted(specs),
        "ready_s": ready_s, "queries": len(results),
        "before_kill": len(before), "in_gap": len(gap),
        "gap_failed": sum(not r["ok"] for r in gap),
        "gap_partial": sum(r["ok"] and r["n"] != full for r in gap),
        "after_back": len(back),
        "query_secs_median": float(np.median([r["secs"] for r in results
                                              if r["ok"]])),
        "restart_s": kill["restart_s"], "back_s": kill["back_s"],
        "events": events, "children_seen": len(seen), "stop_s": stop_s,
        "used_bytes_base": base, "used_bytes_after_minus_base": freed,
        "cut": f"{OP_RUN_S:.0f} s of queries (tests/test_soak.py: 90 s)",
        "secs": time.perf_counter() - t_phase,
        "card": card_line() if on_card else None}))


def _pid_alive(pid: int) -> bool:
    """True while ``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


TP_PEMS = 4
TP_CALLS = 1 << 18  # handler calls per PEM (2^19 before, cut for the time
# limit): 2^20 tracepoint rows in all
TP_POLL = 1 << 15  # calls between drains: half the connector's 2^16-row ring
TP_SERVICES = 32
TP_STATUSES = (200,) * 92 + (404,) * 4 + (500,) * 3 + (503,)
TP_TURNS = 3
TP_DEPLOY = """import pxtrace
import px

@pxtrace.probe('app.handle')
def probe_fn():
    return [{
        'latency_ns': pxtrace.FunctionLatency(),
        'service': pxtrace.ArgExpr('service', type='string'),
        'status': pxtrace.ArgExpr('status'),
        'size_kb': pxtrace.ArgExpr('size_kb', type='float64'),
    }]

pxtrace.UpsertTracepoint('app_tp', 'app_calls', probe_fn, ttl='10m')
"""
TP_QUERY_BODY = """df = px.DataFrame(table='app_calls')
sizes = df.groupby('service').agg(
    n=('size_kb', px.count),
    size_mean=('size_kb', px.mean),
    size_max=('size_kb', px.max),
)
px.display(sizes, 'sizes')
lat = df.groupby('service').agg(lat_q=('latency_ns', px.quantiles))
lat.p50 = px.pluck_float64(lat.lat_q, 'p50')
lat.p99 = px.pluck_float64(lat.lat_q, 'p99')
px.display(lat[['service', 'p50', 'p99']], 'latency')
"""
TP_QUERY = "import px\n" + TP_QUERY_BODY
#: tests/test_dwarf.py's fixture: a function whose arguments the
#: dwarvifier step (``native_probe_plan``) resolves from DWARF.
TP_DWARF_SRC = """
struct conn_info { long id; int port; char proto; double rtt; };
typedef long duration_ns;
extern "C" __attribute__((noinline))
long process_request(struct conn_info* conn, int status, duration_ns latency) {
  return conn->id + status + latency;
}
int main() {
  struct conn_info c = {1, 80, 't', 0.5};
  return (int)process_request(&c, 200, 5);
}
"""


class TpApp:
    """The traced program: a request handler that each PEM registers as
    its ``app.handle`` symbol. Its work grows with ``size_kb``, so the
    traced latencies spread over a continuous range."""

    def handle(self, service, status, size_kb):
        for _ in range(int(size_kb)):
            pass
        return status < 400


def tp_args(i: int, n: int):
    """PEM ``i``'s handler arguments: service index, status, size_kb."""
    rng = np.random.default_rng([SEED, 15, i])
    return (rng.integers(0, TP_SERVICES, n),
            np.asarray(TP_STATUSES)[rng.integers(0, len(TP_STATUSES), n)],
            rng.lognormal(2.0, 1.0, n))


def tp_call(app, args, lo: int, hi: int) -> float:
    """Calls ``app.handle`` with arguments [lo, hi); returns seconds."""
    svc, status, size = (a[lo:hi].tolist() for a in args)
    names = [f"svc-{s}" for s in range(TP_SERVICES)]
    handle = app.handle
    t0 = time.perf_counter()
    for s, st, kb in zip(svc, status, size):
        handle(names[s], st, kb)
    return time.perf_counter() - t0


def tp_wait(pred, what: str, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def tp_landed(pem, rows: int) -> None:
    """Drains ``pem`` until its ``app_calls`` table holds ``rows`` rows,
    then holds it to exactly that. The agent's collector thread drains
    the same connector on its own cadence, and a batch it has taken from
    the ring lands in the table only once that thread has built its
    columns, so one drain right after the calls can come up short."""
    table = pem.engine.tables["app_calls"]

    def landed():
        pem.poll_tracepoints()
        return table.num_rows >= rows

    tp_wait(landed, f"{pem.agent_id}: {table.num_rows} of {rows} rows")
    assert table.num_rows == rows, (pem.agent_id, table.num_rows, rows)
    assert not pem.collector.errors, pem.collector.errors


def tp_check(res, want: dict, lat: dict) -> None:
    """The group-bys against numpy: count exact, size mean and max rtol
    1e-5 (``sizes``); p50 and p99 rtol 0.05 against the table's own
    latencies (``latency``)."""
    sizes = res["tables"]["sizes"].to_pydict()
    assert sorted(sizes["service"]) == sorted(want), sizes["service"]
    for s, n, mean, mx in zip(sizes["service"], sizes["n"],
                              sizes["size_mean"], sizes["size_max"]):
        wn, wmean, wmax = want[s]
        assert n == wn, f"{s} count {n} vs {wn}"
        np.testing.assert_allclose([mean, mx], [wmean, wmax],
                                   rtol=LIB_FLOAT_RTOL, err_msg=s)
    q = res["tables"]["latency"].to_pydict()
    assert sorted(q["service"]) == sorted(lat), q["service"]
    for s, p50, p99 in zip(q["service"], q["p50"], q["p99"]):
        np.testing.assert_allclose([p50, p99], np.quantile(lat[s], [0.5, 0.99]),
                                   rtol=LIB_QUANTILE_RTOL, err_msg=s)


def tp_dwarf() -> dict:
    """``native_probe_plan`` over tests/test_dwarf.py's fixture built
    with ``g++ -g`` (host code), checked against its known layout."""
    import shutil
    import tempfile

    from pixie_tpu_torch.ingest.dynamic import native_probe_plan

    if shutil.which("g++") is None:
        return {"skipped": "no g++"}
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "fix.cc"), os.path.join(d, "fix")
        with open(src, "w") as fh:
            fh.write(TP_DWARF_SRC)
        subprocess.run(["g++", "-g", "-O0", "-o", out, src], check=True,
                       capture_output=True)
        plan = native_probe_plan(out, "process_request")
    args = plan["args"]
    assert plan["address"] > 0
    assert list(args) == ["conn", "status", "latency"], args
    assert (args["conn"]["type"], args["conn"]["size"]) == ("struct conn_info*", 8)
    assert (args["status"]["type"], args["status"]["size"]) == ("int", 4)
    assert (args["latency"]["type"], args["latency"]["size"]) == ("duration_ns", 8)
    assert all(a["frame_offset"] is not None for a in args.values())
    return {"function": plan["function"], "args": args}


def phase_tracepoints(device, calls: int = TP_CALLS, poll: int = TP_POLL,
                      turns: int = TP_TURNS, profile: bool = True) -> dict:
    """Dynamic tracing through the cluster path: the cluster layout (4
    PEMs and a Kelvin, each engine on ``device``, a tracker) and a broker
    with a ``TracepointRegistry``. Each PEM registers ``app.handle`` on a
    ``TpApp`` of its own; one pxtrace script through
    ``broker.execute_script`` upserts ``app_tp`` on it (outputs
    ``latency_ns``, ``service``, ``status``, ``size_kb``), then each
    handler is called ``calls`` times with seeded arguments, its PEM
    drained (``poll_tracepoints``) every ``poll`` calls so the 2^16-row
    ring never drops a row, and each PEM's table must hold exactly its
    calls. The group-by of ``TP_QUERY`` (a warm-up, ``turns`` timed
    turns with the launch counters set to 0 first and read after, one
    under torch.profiler): one script, its FLOAT64 count, mean and max of
    ``size_kb`` by service (``dense_fold``) and its quantiles of
    ``latency_ns`` by service (``hist_fold``), held to numpy
    (``tp_check``); both kernels must have launched on the card. Then a script that both
    mutates and queries, a redeploy under the same name (one row per
    call after it), a deploy on an unknown symbol (refused with
    ``tracepoint deploy failed``) and ``DeleteTracepoint`` (the handlers
    restored); and ``native_probe_plan`` over a ``g++ -g`` fixture.
    Returns {kernel: launches per query}."""
    from pixie_tpu_torch.exec.engine import QueryError
    from pixie_tpu_torch.services.tracepoints import TracepointRegistry

    t_phase = time.perf_counter()
    c = Cluster(device, pems=TP_PEMS)
    reg = None
    try:
        reg = c.broker.tracepoints = TracepointRegistry(c.bus, c.tracker)
        apps = [TpApp() for _ in c.pems]
        for p, app in zip(c.pems, apps):
            p.trace_targets.register("app.handle", app, "handle")
        tp_wait(lambda: len(c.tracker.distributed_state().pems) == TP_PEMS,
                "PEMs never registered")
        args = [tp_args(i, calls) for i in range(TP_PEMS)]
        plain = tp_call(apps[0], args[0], 0, poll) / poll
        t0 = time.perf_counter()
        res = c.broker.execute_script(TP_DEPLOY, mutation_timeout_s=60.0)
        deploy_s = time.perf_counter() - t0
        assert res["mutations"] == {"app_tp": "RUNNING"}, res
        tp_wait(lambda: all("app_tp" in p._tracepoints for p in c.pems),
                "a PEM never attached app_tp")
        tp_wait(lambda: sum(a.has_table("app_calls") for a in
                            c.tracker.distributed_state().pems) == TP_PEMS,
                "a PEM's app_calls never reached the tracker")
        call_s, drains = 0.0, []
        for lo in range(0, calls, poll):
            for p, app, a in zip(c.pems, apps, args):
                call_s += tp_call(app, a, lo, min(lo + poll, calls))
                t1 = time.perf_counter()
                p.poll_tracepoints()
                drains.append(time.perf_counter() - t1)
        for p in c.pems:
            tp_landed(p, calls)
        lat: dict = {}
        for p in c.pems:
            d = p.engine.tables["app_calls"].read_all().to_pydict()
            for s in np.unique(d["service"]):
                lat.setdefault(s, []).append(d["latency_ns"][d["service"] == s])
        lat = {s: np.concatenate(v) for s, v in lat.items()}
        svc = np.concatenate([a[0] for a in args])
        size = np.concatenate([a[2] for a in args])
        want = {}
        for s in range(TP_SERVICES):
            m = svc == s
            want[f"svc-{s}"] = (int(m.sum()), float(size[m].mean()),
                                float(size[m].max()))
        tp_check(c.broker.execute_script(TP_QUERY, timeout_s=120.0), want, lat)
        _zero_launches()
        secs = []
        for _ in range(turns):
            t1 = time.perf_counter()
            res = c.broker.execute_script(TP_QUERY, timeout_s=120.0)
            secs.append(time.perf_counter() - t1)
            tp_check(res, want, lat)
        launches = cl_launches(c)
        busy = (busy_share(lambda: c.broker.execute_script(TP_QUERY,
                                                           timeout_s=120.0))
                if profile else {})
        if device.type == "cuda":
            assert launches["dense_fold"]["total"] > 0, launches
            assert launches["hist_fold"]["total"] > 0, launches
        print(json.dumps({
            "phase": "tracepoints", "pems": TP_PEMS, "calls_per_pem": calls,
            "rows": calls * TP_PEMS, "dropped": 0,
            "deploy_to_running_s": deploy_s,
            "ns_per_call_traced": call_s / (calls * TP_PEMS) * 1e9,
            "ns_per_call_plain": plain * 1e9,
            "drain_s_per_2^15_rows": {
                "median": float(np.median(drains)) * (1 << 15) / poll,
                "max": float(np.max(drains)) * (1 << 15) / poll},
            "query_median_s": float(np.median(secs)), "query_secs": secs,
            "idle_share": busy.get("idle_share"),
            "device_busy_s": busy.get("device_busy_s"),
            "launches": launches, "checked": True}))

        # A script that both mutates and queries: the same deployment (a
        # TTL refresh) and the same answer.
        t1 = time.perf_counter()
        both = c.broker.execute_script(TP_DEPLOY + TP_QUERY_BODY,
                                       timeout_s=120.0)
        both_s = time.perf_counter() - t1
        assert both["mutations"] == {"app_tp": "RUNNING"}, both["mutations"]
        tp_check(both, want, lat)
        # A redeploy under the same name (a new TTL): each call records
        # one row, not two.
        old = [p._tracepoints["app_tp"] for p in c.pems]
        res = c.broker.execute_script(TP_DEPLOY.replace("'10m'", "'20m'"),
                                      mutation_timeout_s=60.0)
        assert res["mutations"] == {"app_tp": "RUNNING"}, res
        tp_wait(lambda: all(p._tracepoints.get("app_tp") not in (None, o)
                            for p, o in zip(c.pems, old)),
                "a PEM never took the redeploy")
        for p, app, a in zip(c.pems, apps, args):
            tp_call(app, a, 0, 1000)
            tp_landed(p, calls + 1000)
            assert len(p._tracepoints) == 1
        # An unknown symbol is refused.
        try:
            c.broker.execute_script(
                TP_DEPLOY.replace("app.handle", "app.missing")
                .replace("'app_tp'", "'bad_tp'"), mutation_timeout_s=60.0)
        except QueryError as e:
            assert "tracepoint deploy failed" in str(e), e
            refused = str(e)[:200]
        else:
            raise AssertionError("a deploy on an unknown symbol was accepted")
        # DeleteTracepoint detaches every PEM's connector.
        res = c.broker.execute_script(
            "import pxtrace\npxtrace.DeleteTracepoint('app_tp')\n")
        tp_wait(lambda: not any("app_tp" in p._tracepoints for p in c.pems),
                "a PEM kept app_tp after the delete")
        assert all(app.handle.__func__ is TpApp.handle for app in apps)
        dwarf = tp_dwarf()
        print(json.dumps({
            "phase": "tracepoints_mutations", "mutate_and_query_s": both_s,
            "redeploy_rows_per_call": 1, "unknown_symbol": refused,
            "deleted": res["mutations"], "handlers_restored": True,
            "native_probe_plan": dwarf,
            "secs": time.perf_counter() - t_phase}))
    finally:
        if reg is not None:
            reg.close()
        c.close()
    return {k: v["total"] / turns for k, v in launches.items()}


CP_TAPS = 32  # one capture tap per service
# Half of the 2^20 HTTP/1 and 2^17 other exchanges first planned for the
# phase: at those counts it took 106 s, and the whole script 1,062 s of
# its 1,200 (NVIDIA H100 80GB HBM3, 700.00 W).
CP_HTTP = 1 << 14  # HTTP/1 exchanges per tap: 2^19 in all
CP_OTHER = 1 << 11  # exchanges of each other protocol per tap: 2^16 in all
CP_SCRIPTS = ("px/http_stats", "px/service_stats", "http_stats_float64",
              "px/dns_latency", "px/mysql_stats", "px/pgsql_stats",
              "px/redis_stats", "px/kafka_stats", "px/cql_stats",
              "px/nats_stats", "px/mux_stats", "px/amqp_stats")
CP_TURNS = 3


def cp_expect_http_stats(truth: list) -> dict:
    """numpy's px/http_stats over every HTTP/1 and HTTP/2 exchange fed:
    (service, path) -> (count, mean, max) of latency over status < 400."""
    svc = np.concatenate([np.full(len(t["path"]), s, dtype=object)
                          for s, t in truth])
    path = np.concatenate([t["path"] for _s, t in truth])
    lat = np.concatenate([t["latency_ns"] for _s, t in truth])
    ok = np.concatenate([t["status"] for _s, t in truth]) < 400
    out = {}
    for s, p in set(zip(svc[ok], path[ok])):
        v = lat[ok & (svc == s) & (path == p)]
        out[(s, p)] = (len(v), float(v.mean()), int(v.max()))
    return out


def cp_check_http_stats(out, want: dict) -> None:
    got = out.to_pydict()
    keys = list(zip(got["service"], got["req_path"]))
    assert sorted(keys) == sorted(want), "http_stats groups"
    for k, n, mean, mx in zip(keys, got["n"], got["lat_mean"], got["lat_max"]):
        wn, wmean, wmax = want[k]
        assert (n, mx) == (wn, wmax), (k, n, mx, wn, wmax)
        np.testing.assert_allclose(mean, wmean, rtol=LIB_FLOAT_RTOL, err_msg=str(k))


def phase_capture(device, taps: int = CP_TAPS, http: int = CP_HTTP,
                  other: int = CP_OTHER, turns: int = CP_TURNS,
                  profile: bool = True) -> dict:
    """The capture tap on one engine on ``device``: ``taps``
    ``CaptureTapConnector``s (one per service and pod) on one
    ``Collector``, each fed an in-memory capture
    (``ingest/capture_gen.py``, seeded per tap) of ``http`` HTTP/1
    exchanges and ``other`` of each other protocol (HTTP/2 with HPACK,
    DNS, MySQL, PgSQL, Redis, Kafka, CQL, NATS, Mux, AMQP). Each
    protocol's run is parsed by one budgeted transfer (its exchanges/s),
    and each tap's rows pushed into the card's engine (the append's
    seconds) and into a CPU engine. Every stitcher must end with 0
    ``parse_errors`` and every table hold the exchanges fed. Then the
    twelve scripts of CP_SCRIPTS run on the card (a warm-up and ``turns``
    timed turns, the launch counters set to 0 first and read after),
    each answer held to the CPU engine's (the library tolerances), and
    px/http_stats also to numpy over the exchanges. Returns the
    hist_fold launches of px/service_stats and the dense_fold launches of
    http_stats_float64, per query."""
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.ingest.capture_gen import PROTOCOLS, gen_capture
    from pixie_tpu_torch.ingest.collector import Collector
    from pixie_tpu_torch.ingest.schemas import init_schemas
    from pixie_tpu_torch.ingest.tap import CaptureTapConnector
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    t_phase = time.perf_counter()
    eng, cpu = Engine(device=device), Engine(device="cpu")
    init_schemas(eng)
    init_schemas(cpu)
    append_s = [0.0]

    def push(name, _relation, records):
        t0 = time.perf_counter()
        eng.append_data(name, records)
        append_s[0] += time.perf_counter() - t0
        cpu.append_data(name, records)

    coll = Collector()
    coll.register_data_push_callback(push)
    counts = {p: other for p in PROTOCOLS} | {"http": http}
    parse_s = dict.fromkeys(PROTOCOLS, 0.0)
    gen_s, truth = 0.0, []
    for i in range(taps):
        t0 = time.perf_counter()
        cap = gen_capture(np.random.default_rng([SEED, 16, i]), counts,
                          conns=64)
        gen_s += time.perf_counter() - t0
        service = f"svc-{i}"
        tap = CaptureTapConnector(feed=cap.events, service=service,
                                  pod=f"ns/pod-{i}")
        coll.register_source(tap)
        for proto in PROTOCOLS:
            t0 = time.perf_counter()
            tap.transfer_data(None, coll._data_tables, budget=cap.runs[proto])
            parse_s[proto] += time.perf_counter() - t0
        coll.flush()
        errors = {p: getattr(tap, p).parse_errors for p in PROTOCOLS}
        assert not any(errors.values()), (service, errors)
        truth += [(service, cap.truth["http"]), (service, cap.truth["http2"])]
        del cap, tap
    assert coll.stats["pushes"] > 0 and not coll.errors, coll.errors
    tables = {"http_events": ("http", "http2"), "dns_events": ("dns",),
              "mysql_events": ("mysql",), "pgsql_events": ("pgsql",),
              "redis_events": ("redis",), "kafka_events.beta": ("kafka",),
              "cql_events": ("cql",), "nats_events.beta": ("nats",),
              "mux_events": ("mux",), "amqp_events": ("amqp",)}
    rows = {}
    for t, protos in tables.items():
        rows[t] = eng.tables[t].num_rows
        assert rows[t] == cpu.tables[t].num_rows == taps * sum(
            counts[p] for p in protos), (t, rows[t])
    print(json.dumps({
        "phase": "capture", "taps": taps,
        "exchanges": {p: taps * n for p, n in counts.items()},
        "exchanges_per_s": {p: taps * counts[p] / s for p, s in parse_s.items()},
        "parse_s": sum(parse_s.values()), "gen_s": gen_s,
        "append_s": append_s[0], "rows": rows, "parse_errors": 0}))
    want_http = cp_expect_http_stats(truth)
    launches, out = {}, {}
    for name in CP_SCRIPTS:
        pxl = query_text(name)
        compiled = compile_pxl(pxl, CompilerState(
            schemas={n: t.relation for n, t in eng.tables.items()},
            registry=eng.registry, now_ns=0, max_output_rows=10_000))
        loose, ordered = _quantile_columns(compiled.plan)
        ref = cpu.execute_query(pxl)

        def checked(out_):
            assert sorted(out_) == sorted(ref), name
            for k in out_:
                check_library_output(f"capture {name}:{k}", out_[k], ref[k],
                                     loose[k], ordered)
            if name == "px/http_stats":
                cp_check_http_stats(out_["output"], want_http)

        checked(eng.execute_query(pxl))
        _zero_launches()
        secs = []
        for _ in range(turns):
            t0 = time.perf_counter()
            res = eng.execute_query(pxl)
            secs.append(time.perf_counter() - t0)
            checked(res)
        launches[name] = {k: v / turns for k, v in _launch_counts().items()}
        busy = (busy_share(lambda: eng.execute_query(pxl))
                if profile and name in ("px/service_stats", "http_stats_float64")
                else {})
        out[name] = float(np.median(secs))
        print(json.dumps({
            "phase": "capture_script", "script": name, "median_s": out[name],
            "secs": secs, "rows_out": {k: v.length for k, v in res.items()},
            "launches": launches[name], "idle_share": busy.get("idle_share"),
            "checked": True}))
    got = {"dense_fold": launches["http_stats_float64"]["dense_fold"],
           "hist_fold": launches["px/service_stats"]["hist_fold"]}
    if device.type == "cuda":
        assert got["dense_fold"] > 0 and got["hist_fold"] > 0, got
    print(json.dumps({"phase": "capture_total", "scripts": len(CP_SCRIPTS),
                      "checked": len(CP_SCRIPTS),
                      "script_secs": sum(out.values()),
                      "launches": got, "secs": time.perf_counter() - t_phase}))
    return got


def phase_bench(device) -> dict:
    """``pixie_tpu_torch.bench.run_shape`` in this process for bench.py's
    ten shapes at 2^22 head rows (each shape's divisor applies), the A/B
    pass off; each shape checked with bench.py's numpy assertions (a
    failed check raises). Returns the kernels' launches over the phase."""
    import gc

    import torch

    from pixie_tpu_torch import bench

    _zero_launches()
    for shape in bench.ALL_SHAPES:
        res = bench.run_shape(shape, BENCH_HEAD_ROWS, WINDOW, device, ab=False)
        assert res["checked"] is True, (shape, res)
        print(json.dumps({"phase": "bench", "shape": shape, **res},
                         default=str))
        gc.collect()
        torch.cuda.empty_cache()
    return _launch_counts()


def phase_gates(device) -> None:
    """The bench-shape gates on the card: every bench shape's plan
    verifies clean (``check_bench_shapes``), so do the 13 self-monitoring
    scripts (``check_obs_scripts``), and every bench shape and script
    replayed on the card stays within its predicted bounds, an
    over-budget query is refused at compile, and the memoized bounds
    pass stays under 5% of a compile (``check_bounds``). Their reports
    are printed here."""
    import contextlib
    import io

    from pixie_tpu_torch.analysis.bench_check import check_bench_shapes
    from pixie_tpu_torch.analysis.bound_check import check_bounds
    from pixie_tpu_torch.analysis.obs_check import check_obs_scripts

    failures = {}
    for name, gate in (("bench_check", check_bench_shapes),
                       ("obs_check", check_obs_scripts),
                       ("bound_check", lambda: check_bounds(device=device))):
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            failures[name] = gate()
        secs = time.perf_counter() - t0
        for line in err.getvalue().splitlines():
            print(f"  {name}: {line}")
        print(json.dumps({"phase": "gates", "gate": name,
                          "failures": failures[name], "secs": secs}))
    assert not any(failures.values()), failures


def kernel_checks(replay, device) -> list:
    """Each kernel held to its plain version and timed (``check_*``),
    with a line per kernel and per timed shape."""
    kernels = [check_dense_fold(replay, device), check_hist_fold(replay, device),
               check_int_fold(replay, device)]
    for k in kernels:
        print(f"kernel {k['name']}: ms {k['ms']:.4f} (device "
              f"{k['device_ms']}) plain_ms {k['plain_ms']:.4f} (device "
              f"{k['plain_device_ms']}) library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.4f} max_abs_err {k['max_abs_err']} "
              f"checked {len(k['checked'])} cases")
        for sh in k["shapes"]:
            print(f"  {k['name']} [{sh['label']}] slots {sh['slots']}: ms "
                  f"{sh['ms']:.4f} device_ms {sh['device_ms']} bound_ms "
                  f"{sh['bound_ms']:.4f} library_ms "
                  f"{sh.get('library_ms', 'not measured')}")
    return kernels


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def elapsed(after: str) -> None:
        print(json.dumps({"elapsed_s": time.perf_counter() - t_start,
                          "after": after}))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor

    from pixie_tpu_torch import native
    from pixie_tpu_torch.config import clear_flag, set_flag
    from pixie_tpu_torch.ops import cuda_lib

    census = RingCensus()

    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(device)}")

    t0 = time.perf_counter()
    # The native ring and hash join (g++) build beside the kernels (nvcc).
    with ThreadPoolExecutor(2) as pool:
        native_built = pool.submit(native.build)
        client_built = pool.submit(native.build_executable, "pxclient")
        built = cuda_lib.build()
        native_secs = native_built.result()
        pxclient = client_built.result()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          + ", ".join(f"{k} {v[0]:.2f} s" for k, v in built.items())
          + ", " + ", ".join(f"{k} (g++) {v:.2f} s"
                             for k, v in native_secs.items()))
    for name, (_secs, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    replay = make_replay(ROWS)
    if sys.argv[1:] == ["--kernels"]:
        kernels = kernel_checks(replay, device)
        print(card)  # nvidia-smi's "name, power.limit" line, as it gave it
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "kernels_only": True}))
        return 0
    expect = Expect(replay)
    eng = load_engine(replay, WINDOW, device)
    table = eng.tables["http_events"]
    print(json.dumps({"phase": "append", "residency": True, "rows": ROWS,
                      "secs": eng.append_secs,
                      "resident_bytes": table.resident_bytes,
                      "allocated": torch.cuda.memory_allocated(device)}))
    assert table.resident_bytes == ROWS * ROW_BYTES, table.resident_bytes
    check_resident_windows(table, replay)
    set_flag("ingest_sketches", False)
    try:
        secs = load_engine(replay, WINDOW, device).append_secs
    finally:
        clear_flag("ingest_sketches")
    gc.collect()
    print(json.dumps({"phase": "append", "residency": True,
                      "ingest_sketches": False, "rows": ROWS, "secs": secs}))

    # int_fold's launches are counted in the steady state alone; the
    # other phases count the two kernels the JAX package has.
    kernels = kernel_checks(replay, device)
    int_k = kernels.pop()

    print(json.dumps({"batch_to_digest": profile_digest(replay, device)}))

    elapsed("kernel checks")
    launches = phase_steady_state(eng, expect)
    for k in kernels + [int_k]:
        k["launches"] = launches[k["name"]]
    phase_attribution(eng, expect)
    phase_host_staged(replay, expect, device)
    phase_row_chains(eng, replay)
    _zero_launches()
    phase_device_result(eng, expect)
    device_result = _launch_counts()
    for k in kernels:
        k["launches_device_result"] = device_result[k["name"]]
    elapsed("window path and device results")
    # Several threads' queries on the same engine and resident windows.
    _zero_launches()
    phase_concurrency(eng, replay, expect, device)
    concurrency = _launch_counts()
    for k in kernels:
        k["launches_concurrency"] = concurrency[k["name"]]
    gc.collect()
    elapsed("concurrency")
    # px.export and the OTLP trace push over the same resident windows.
    otel = phase_otel(eng, expect)
    for k in kernels:
        k["launches_otel"] = otel[k["name"]]
    elapsed("otel")
    hist = next(k for k in kernels if k["name"] == "hist_fold")
    # Agent mode, held to ``eng`` before the tail grows its table.
    cluster = phase_cluster(eng, replay, device)
    for k in kernels:
        k["launches_cluster"] = cluster[k["name"]]
    gc.collect()
    elapsed("cluster")
    # The mesh executor: 4 virtual PEMs on the card, held to ``eng``.
    mesh = phase_mesh(eng, replay, expect, device, launches)
    for k in kernels:
        k["launches_mesh"] = mesh[k["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("mesh")
    # The same cluster with its PEMs and Kelvin in processes of their
    # own, then the roles started as users start them.
    processes = phase_processes(eng, replay, device, cluster["turns"])
    for k in kernels:
        k["launches_processes"] = processes[k["name"]]
    elapsed("processes")
    # The same layout under two broker replicas, lockdep and faults, the
    # leader killed mid-flight; then the chaos soak.
    failover = phase_failover(eng, replay, device,
                              off_secs=cluster["off_secs"])
    hist["launches_failover"] = failover["hist_fold"]
    elapsed("failover")
    phase_deploy(device, pxclient)
    elapsed("deploy")
    # The roles kept alive by the operator's Reconciler, a PEM killed.
    phase_operator(device)
    elapsed("operator")
    # Dynamic tracing through the broker's mutation phase, then the
    # capture tap's eleven protocols into an engine on the card.
    tracepoints = phase_tracepoints(device)
    capture = phase_capture(device)
    for k in kernels:
        k["launches_tracepoints"] = tracepoints[k["name"]]
        k["launches_capture"] = capture[k["name"]]
    gc.collect()
    elapsed("tracepoints and capture")
    phase_tail(eng, replay)
    del eng, table
    gc.collect()
    serving = phase_serving(device, census)
    for k in kernels:
        k["launches_serving"] = serving[k["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("serving")
    # hist_fold's launches in the group_by phase's quantile query, per
    # groupby_impl form (``launches`` stays the steady state's count).
    hist["launches_group_by"] = phase_group_by(device)
    elapsed("group_by and metadata")
    gc.collect()
    torch.cuda.empty_cache()
    phase_joins(device)
    elapsed("joins")
    gc.collect()
    torch.cuda.empty_cache()
    phase_analysis(device)
    elapsed("analysis")
    gc.collect()
    torch.cuda.empty_cache()
    library = phase_library(device)
    elapsed("library")
    for k in kernels:
        k["launches_library"] = library[k["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    phase_eviction(replay, expect, device)
    gc.collect()
    torch.cuda.empty_cache()
    phase_full_budget(device)
    elapsed("eviction and full budget")
    gc.collect()
    torch.cuda.empty_cache()
    bench_launches = phase_bench(device)
    for k in kernels:
        k["launches_bench"] = bench_launches[k["name"]]
    elapsed("bench")
    gc.collect()
    torch.cuda.empty_cache()
    phase_gates(device)
    elapsed("gates")

    print(json.dumps({"phase": "serving", "check": "ring_census",
                      **census.check()}))
    print(card)  # nvidia-smi's "name, power.limit" line, as it gave it
    print(json.dumps({"kernels": kernels + [int_k]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pem-worker"]:
        sys.exit(pem_worker(sys.argv[2:]))
    sys.exit(main())
