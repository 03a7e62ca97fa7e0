"""The load tester on the port (``services/load_tester.py``) against the
JAX package's.

- ``LoadReport``: percentiles, ``failure_rate``, ``cache_hit_rate`` and
  ``to_dict`` equal the JAX report's on the same latencies and outcomes.
- ``run_load``, ``run_mixed_load`` and ``run_concurrency_sweep`` through
  ``broker_executor`` over a port cluster of CPU engines, and the repeat
  axis through ``local_executor`` on the CPU.
- ``main``: ``--local --device cpu`` exits 0 with the JAX CLI's report
  keys; without a card and without ``--device cpu`` it exits 1.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

import numpy as np
import pytest

import pixie_tpu.services.load_tester as jax_lt
import pixie_tpu_torch.services.load_tester as lt
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.services import (
    AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)

AGG_Q = lt._LOCAL_QUERY


def _report(mod, seed: int):
    rng = np.random.default_rng(seed)
    r = mod.LoadReport()
    n = int(rng.integers(1, 60))
    r.latencies_s = list(rng.exponential(0.05, n))
    r.queries = n + int(rng.integers(0, 5))
    r.errors = r.queries - n
    r.partials = int(rng.integers(0, n + 1))
    r.sheds = int(rng.integers(0, r.errors + 1))
    r.errors_by_type = {"AgentLost": r.errors} if r.errors else {}
    r.max_freshness_lag_ms = float(rng.uniform(0, 500))
    r.wall_s = float(rng.uniform(0.5, 3.0))
    if seed % 2:
        r.cache_counts = {"hit": int(rng.integers(5)), "miss": 1,
                          "view": int(rng.integers(3))}
        r.hist_quantiles_s = {0.5: 0.01, 0.95: 0.02, 0.99: 0.03}
        r.hist_count = n
        r.bus_lag_p99_ms = 0.25
        r.bus_queue_high_water = 3
        r.cpu_seconds_by_tenant = {"dash": 0.12}
    return r


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_report_equals_jax(seed):
    port, jax = _report(lt, seed), _report(jax_lt, seed)
    assert port.to_dict() == jax.to_dict()
    assert port.failure_rate == jax.failure_rate
    assert port.cache_hit_rate == jax.cache_hit_rate
    for p in (0, 1, 50, 95, 99, 100):
        assert port.percentile(p) == jax.percentile(p)


def test_empty_report_equals_jax():
    port, jax = lt.LoadReport(), jax_lt.LoadReport()
    assert json.dumps(port.to_dict()) == json.dumps(jax.to_dict())
    assert np.isnan(port.percentile(99)) and port.failure_rate == 0.0
    assert port.cache_hit_rate == 0.0


def test_tenant_stream_fields_equal_jax():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(lt.TenantStream)] \
        == [(f.name, f.default) for f in dataclasses.fields(
            jax_lt.TenantStream)]


@contextlib.contextmanager
def _cluster():
    bus = MessageBus()
    tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    rng = np.random.default_rng(11)
    try:
        for i in range(2):
            pem = PEMAgent(bus, f"pem-{i}",
                           engine=Engine(window_rows=1 << 10, device="cpu"),
                           heartbeat_interval_s=0.05).start()
            agents.append(pem)
            n = 800 + 200 * i
            pem.append_data("http_events", {
                "time_": np.arange(n, dtype=np.int64),
                "latency_ns": rng.integers(1000, 10**6, n),
                "resp_status": rng.choice(np.array([200, 500]), n),
                "service": [f"svc-{j % 8}" for j in range(n)],
            })
            pem._register()
        agents.append(KelvinAgent(
            bus, "kelvin-0", engine=Engine(window_rows=1 << 10, device="cpu"),
            heartbeat_interval_s=0.05).start())
        deadline = time.monotonic() + 5.0
        while len(tracker.agent_ids()) < 3 or sum(
                a.has_table("http_events")
                for a in tracker.distributed_state().pems) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        broker = QueryBroker(bus, tracker)
        yield broker
    finally:
        for a in agents:
            a.stop()
        if broker is not None:
            broker.close()
        tracker.close()
        bus.close()


def test_run_load_and_mixed_load_through_a_port_cluster():
    with _cluster() as broker:
        ex = lt.broker_executor(broker)
        ex(AGG_Q, 30.0)  # warm
        rep = lt.run_load(ex, AGG_Q, workers=2, per_worker=3,
                          timeout_s=30.0, tenant="dash")
        d = rep.to_dict()
        assert d["queries"] == 6 and d["errors"] == 0
        assert d["partials"] == 0 and len(rep.latencies_s) == 6
        assert d["qps"] > 0 and d["p99_ms"] >= d["p50_ms"] > 0
        # The broker's tracer observes every finished query in the
        # serving histogram: the run's delta counts them.
        assert rep.hist_quantiles_s is not None and rep.hist_count >= 6
        reports = lt.run_mixed_load(ex, [
            lt.TenantStream(tenant="dash", query=AGG_Q, workers=2,
                            per_worker=2, priority=1),
            lt.TenantStream(tenant="dash", query=AGG_Q, workers=1,
                            per_worker=2),
            lt.TenantStream(tenant="batch", query=AGG_Q, workers=1,
                            per_worker=2),
        ])
        assert sorted(reports) == ["batch", "dash", "dash#1"]
        assert [reports[k].queries for k in ("dash", "dash#1", "batch")] \
            == [4, 2, 2]
        assert all(r.errors == 0 for r in reports.values())
        assert len({r.wall_s for r in reports.values()}) == 1
        sweep = lt.run_concurrency_sweep(ex, AGG_Q, concurrencies=(1, 2),
                                         per_worker=2, timeout_s=30.0)
        assert sorted(sweep) == [1, 2]
        assert [sweep[n].queries for n in (1, 2)] == [2, 4]


def test_mixed_load_until_keeps_workers_firing():
    """The port's ``until``: every worker fires its count, then more
    until the event is set (the chaos soak's open load); without it the
    count is exact, as in the JAX package."""
    calls = []

    def execute(query, timeout_s, **kw):
        calls.append(kw["tenant"])
        time.sleep(0.01)
        return {"ok": True}

    until = threading.Event()
    threading.Timer(0.3, until.set).start()
    reps = lt.run_mixed_load(execute, [
        lt.TenantStream(tenant="dash", query="q", workers=2, per_worker=2)],
        until=until)
    assert until.is_set() and reps["dash"].queries > 4
    assert reps["dash"].queries == len(calls) and reps["dash"].errors == 0
    calls.clear()
    reps = lt.run_mixed_load(execute, [
        lt.TenantStream(tenant="dash", query="q", workers=2, per_worker=2)])
    assert reps["dash"].queries == 4 == len(calls)


def test_repeat_axis_on_a_local_cpu_engine():
    ex = lt.local_executor(rows=4096, window_rows=1 << 10, device="cpu")
    assert ex.engine.device.type == "cpu"
    eng = ex.engine
    ab = lt.run_repeat_ab(
        ex, AGG_Q, qps=0, count=4, cache_mb=16,
        status_fn=lambda res: getattr(eng.tracer.last(), "cache", ""))
    off, on = ab["cache_off"], ab["cache_on"]
    assert off.queries == on.queries == 4 and off.errors == on.errors == 0
    assert off.cache_hit_rate == 0.0
    assert on.cache_counts.get("hit", 0) >= 3, on.cache_counts


def test_main_local_on_the_cpu_has_the_jax_report_keys(capsys):
    argv = ["--local", "--rows", "4096", "--concurrency", "1,2",
            "--per-worker", "2"]
    assert lt.main(argv + ["--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert jax_lt.main(argv) == 0
    jax = json.loads(capsys.readouterr().out)
    assert sorted(port) == sorted(jax) == ["1", "2"]
    # The bus and histogram keys depend on what the process ran before
    # (each package has its own registry, and the queue high-water
    # gauge never falls): the report's own keys must agree.
    base = set(lt.LoadReport().to_dict())
    for n in port:
        assert base <= set(port[n]) and base <= set(jax[n])
        assert {k: type(port[n][k]) for k in base} == {
            k: type(jax[n][k]) for k in base}
        assert port[n]["queries"] == jax[n]["queries"] == 2 * int(n)
        assert port[n]["errors"] == 0


def test_main_repeat_script_on_the_cpu(capsys):
    assert lt.main(["--local", "--device", "cpu", "--rows", "4096",
                    "--repeat-script", "--qps", "0", "--count", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert sorted(out)[:2] == ["cache_off", "cache_on"]
    assert out["cache_on"]["cache_counts"].get("hit", 0) >= 2


def test_main_without_a_card_exits_non_zero(monkeypatch, capsys):
    import torch

    monkeypatch.delenv("PIXIE_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lt.main(["--local", "--rows", "100"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setenv("PIXIE_TPU_TORCH_DEVICE", "cpu")
    ex = lt.local_executor(rows=100)
    assert ex.engine.device.type == "cpu"


def test_device_needs_local(capsys):
    with pytest.raises(SystemExit):
        lt.main(["--broker", "127.0.0.1:1", "--script", "x.pxl",
                 "--device", "cpu"])
