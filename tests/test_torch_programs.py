"""The port's program registry and device-memory monitor
(``pixie_tpu_torch/exec/programs.py``) against the JAX package's.

Eager PyTorch compiles no XLA executable, so the port's registry records
what it binds and builds: fragment binds (keyed by the chain's
structural key, the input schema as the shape signature), device join
dispatches, and the nvcc and g++ libraries (a kernel launch is a hit).
Each case holds it to the contract of ``tests/test_programs.py``: a
repeated plan is a hit with no new compile, a new shape is a miss, LRU
eviction counts and resumes, ``rows(since_seq)`` drains monotonically,
the ``__programs__`` table and ``px/bound_accuracy`` fill on both
packages, and the broker's admission floor follows the observed history.
Everything runs on the CPU at a small size.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.programs import (
    default_program_registry as jax_default_registry,
)
from pixie_tpu.exec.trace import Tracer as JaxTracer
from pixie_tpu.services.observability import (
    MetricsRegistry as JaxMetricsRegistry,
)
from pixie_tpu.services.telemetry import (
    ObservedCostIndex as JaxObservedCostIndex,
    enable_self_telemetry as jax_enable_self_telemetry,
)
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.programs import (
    DeviceMemoryMonitor,
    ProgramRegistry,
    _program_id,
    default_program_registry,
)
from pixie_tpu_torch.exec.trace import QueryResourceUsage, Tracer
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services.observability import (
    MetricsRegistry,
    ObservabilityServer,
)
from pixie_tpu_torch.services.telemetry import (
    ObservedCostIndex,
    enable_self_telemetry,
)

AGG_QUERY = """import px
df = px.DataFrame(table='{table}')
df = df.groupby(['k']).agg(n=('v', px.count), s=('v', px.sum))
px.display(df)
"""

PROGRAMS_Q = (
    "import px\n"
    "df = px.DataFrame(table='__programs__')\n"
    "df = df.groupby(['program_id']).agg(\n"
    "    compiles=('compiles', px.max), hits=('hits', px.max))\n"
    "px.display(df)\n"
)


def _data(n: int = 2000, mod: int = 5) -> dict:
    return {
        "time_": np.arange(n, dtype=np.int64),
        "k": np.arange(n, dtype=np.int64) % mod,
        "v": np.arange(n, dtype=np.int64),
    }


def _engines(table: str, n: int = 2000, mod: int = 5):
    """(port, jax) engines holding the same seeded table."""
    port, jax = Engine(device="cpu"), JaxEngine()
    for eng in (port, jax):
        eng.append_data(table, _data(n, mod))
    return port, jax


class TestRegistryCore:
    def test_repeat_key_hits_without_recompile(self):
        mreg = MetricsRegistry()
        reg = ProgramRegistry(mreg)
        sig = (("k", "INT64"),)
        assert reg.observe("fragment_update", ("t", 1), "AggOp", sig,
                           compile_s=0.01) is False
        assert reg.observe("fragment_update", ("t", 1), "AggOp",
                           sig) is True
        assert reg.stats() == {"programs": 1, "hits": 1, "compiles": 1}
        out = mreg.render()
        assert "pixie_program_cache_hits_total 1" in out, out
        assert "pixie_program_cache_misses_total 1" in out, out

    def test_schema_change_is_a_miss(self):
        reg = ProgramRegistry(MetricsRegistry())
        for dt in ("INT64", "FLOAT64", "STRING"):
            reg.observe("fragment_update", ("t", 2), "", (("v", dt),))
        st = reg.stats()
        assert st["programs"] == 3 and st["compiles"] == 3
        assert st["hits"] == 0

    def test_cost_memory_fields_none(self):
        """The XLA analyses stay None, as the JAX record leaves them on a
        backend without them; the telemetry rows read them as 0."""
        reg = ProgramRegistry(MetricsRegistry())
        reg.observe("fragment_update", ("t", 3), "MapOp", compile_s=0.002)
        reg.observe("fragment_update", ("t", 3), "MapOp")
        (rec,) = reg.programz()["programs"]
        assert rec["cached"] is False
        assert rec["compiles"] == 1 and rec["hits"] == 1
        assert rec["compile_ms"] == 2.0
        for f in ("flops", "bytes_accessed", "argument_bytes",
                  "output_bytes", "temp_bytes", "peak_bytes"):
            assert rec[f] is None
        _c, rows = reg.rows(0)
        assert rows[0]["flops"] == 0.0 and rows[0]["peak_bytes"] == 0

    def test_lru_eviction_counts(self):
        mreg = MetricsRegistry()
        reg = ProgramRegistry(mreg, size=2)
        for n in (4, 8, 16):
            reg.observe("test", ("t", 5), "", (n,))
        assert reg.stats()["programs"] == 2  # oldest evicted
        ev = mreg.counter("pixie_program_cache_evictions_total")
        assert ev.value() == 1.0
        # The evicted program compiles again (a miss) and RESUMES its
        # pre-eviction counters: the per-program_id stream is monotonic.
        reg.observe("test", ("t", 5), "", (4,))
        misses = mreg.counter("pixie_program_cache_misses_total")
        assert misses.value() == 4.0
        resumed = [r for r in reg.programz()["programs"]
                   if r["compiles"] == 2]
        assert len(resumed) == 1, reg.programz()["programs"]
        # The drain sees every program's final state, the evicted and
        # not re-created one included.
        _cursor, rows = reg.rows(0)
        assert len({r["program_id"] for r in rows}) == 3

    def test_disabled_registry_records_nothing(self):
        reg = ProgramRegistry(MetricsRegistry(), size=0)
        assert reg.observe("test", ("t", 6), "") is False
        reg.record_build("cuda_library", "k", 1.0)
        reg.hit("cuda_library", "k")
        assert reg.stats() == {"programs": 0, "hits": 0, "compiles": 0}
        with override_flag("program_registry_size", 0):
            assert not default_program_registry().enabled()

    def test_rows_drain_monotonically(self):
        reg = ProgramRegistry(MetricsRegistry())
        reg.observe("a", ("t", 7), "a")
        reg.observe("b", ("t", 7), "b")
        c1, rows = reg.rows(0)
        assert {r["kind"] for r in rows} == {"a", "b"}
        c2, rows = reg.rows(c1)
        assert c2 == c1 and rows == []
        reg.observe("a", ("t", 7), "a")  # a hit changes only "a"
        c3, rows = reg.rows(c2)
        assert c3 > c2 and [r["kind"] for r in rows] == ["a"]
        assert rows[0]["hits"] == 1 and rows[0]["compiles"] == 1

    def test_program_ids_stable_across_processes(self):
        """Ids are content hashes, not Python's salted hash(): the same
        program has one id in every process, so px/program_cost merges
        the agents' rows."""
        key = ("dense_fold",)
        code = (
            "from pixie_tpu_torch.exec.programs import _program_id\n"
            "print(_program_id('cuda_library', ('dense_fold',), ()))\n"
        )
        ids = set()
        for seed in ("1", "2"):
            r = subprocess.run(
                [sys.executable, "-c", code], capture_output=True,
                text=True, timeout=120,
                env={**os.environ, "PYTHONHASHSEED": seed},
            )
            assert r.returncode == 0, r.stderr[-2000:]
            ids.add(r.stdout.strip())
        assert ids == {_program_id("cuda_library", key, ())}

    def test_build_records(self):
        reg = ProgramRegistry(MetricsRegistry())
        reg.record_build("cuda_library", "dense_fold", 4.5)
        reg.record_build("cuda_library", "dense_fold", 0.0)  # a later load
        (rec,) = reg.programz()["programs"]
        assert rec["compiles"] == 1 and rec["compile_ms"] == 4500.0
        reg.hit("cuda_library", "dense_fold", "dense_fold")
        reg.hit("cuda_library", "dense_fold", "dense_fold")
        reg.record_build("cuda_library", "dense_fold", 1.5)  # a rebuild
        (rec,) = reg.programz()["programs"]
        assert (rec["compiles"], rec["hits"]) == (2, 2)
        assert rec["compile_ms"] == 6000.0

    def test_prebuilt_library_records_zero_compile_time(self):
        reg = ProgramRegistry(MetricsRegistry())
        reg.record_build("native_library", "table_ring", 0.0)
        (rec,) = reg.programz()["programs"]
        assert rec["compiles"] == 1 and rec["compile_ms"] == 0.0

    def test_kernel_launch_is_a_hit(self):
        from pixie_tpu_torch.ops import cuda_lib

        def smoke_kernel_for_registry():
            pass

        smoke_kernel_for_registry.launches = 0
        smoke_kernel_for_registry.launches_by_thread = {}
        reg = default_program_registry()
        for _ in range(3):
            cuda_lib.count_launch(smoke_kernel_for_registry)
        (rec,) = [r for r in reg.programz()["programs"]
                  if r["label"] == "smoke_kernel_for_registry"]
        assert rec["kind"] == "cuda_library" and rec["hits"] == 3
        assert smoke_kernel_for_registry.launches == 3

    def test_native_ring_load_is_recorded(self):
        eng = Engine(device="cpu")
        eng.append_data("t_native_rec", _data(16))
        kinds = {(r["kind"], r["label"])
                 for r in default_program_registry().programz()["programs"]}
        assert ("native_library", "table_ring") in kinds


class TestEnginePath:
    def test_repeated_query_zero_recompiles(self):
        """A repeated plan compiles nothing new and hits, on both
        packages, and ``__programs__`` shows a program with one compile
        and hits."""
        port, jax = _engines("t_prog_accept")
        enable_self_telemetry(port, agent_id="test-engine")
        jax_enable_self_telemetry(jax, agent_id="test-engine")
        q = AGG_QUERY.format(table="t_prog_accept")
        for eng, reg in ((port, default_program_registry()),
                         (jax, jax_default_registry())):
            eng.execute_query(q)
            s1 = reg.stats()
            eng.execute_query(q)
            s2 = reg.stats()
            assert s2["compiles"] == s1["compiles"], "second run recompiled"
            assert s2["hits"] > s1["hits"]
            rows = eng.execute_query(PROGRAMS_Q)["output"].to_pydict()
            assert any(h > 0 and c == 1
                       for c, h in zip(rows["compiles"], rows["hits"])), rows

    def test_fragment_records_name_the_chain(self):
        port, _jax = _engines("t_prog_label")
        port.execute_query(AGG_QUERY.format(table="t_prog_label"))
        recs = default_program_registry().programz()["programs"]
        kinds = {r["kind"] for r in recs}
        assert {"fragment_update", "fragment_finalize"} <= kinds
        agg = [r for r in recs if r["kind"] == "fragment_finalize"]
        assert any("AggOp" in r["label"] for r in agg)
        assert any("k:INT64" in r["shape"] for r in recs), recs

    def test_programz_surface(self):
        port, _jax = _engines("t_programz")
        port.execute_query(AGG_QUERY.format(table="t_programz"))
        obs = ObservabilityServer(programs=default_program_registry())
        code, ctype, body = obs.handle("/debug/programz")
        assert code == 200 and "application/json" in ctype
        pz = json.loads(body)
        assert pz["count"] >= 1
        assert all("compile_ms" in r for r in pz["programs"])
        code, _, _ = ObservabilityServer().handle("/debug/programz")
        assert code == 404

    @pytest.mark.parametrize("strategy", ["single", "sorted", "radix"])
    def test_join_driver_programs_tracked(self, strategy):
        eng = Engine(device="cpu")
        n = 1 << 12
        # Keys spread past any dense domain: no fused lookup join.
        eng.append_data("t_join_l", {
            "time_": np.arange(n, dtype=np.int64),
            "k": (np.arange(n, dtype=np.int64) % 251) << 32,
            "v": np.arange(n, dtype=np.int64),
        })
        eng.append_data("t_join_r", {
            "time_": np.arange(251, dtype=np.int64),
            "k": np.arange(251, dtype=np.int64) << 32,
            "w": np.arange(251, dtype=np.int64) * 3,
        })
        q = """import px
l = px.DataFrame(table='t_join_l')
r = px.DataFrame(table='t_join_r')
j = l.merge(r, how='inner', left_on='k', right_on='k')
j = j.groupby(['k']).agg(n=('w', px.count))
px.display(j)
"""
        reg = default_program_registry()
        kind = {"single": "join_single_shot", "sorted": "join_probe_sorted",
                "radix": "join_probe_radix"}[strategy]

        def uses():
            return sum(r["compiles"] + r["hits"]
                       for r in reg.programz()["programs"]
                       if r["kind"] == kind)

        before = uses()
        with override_flag("join_strategy", strategy), \
                override_flag("device_join_min_rows", 0), \
                override_flag("join_probe_window_rows", 1 << 10):
            out = eng.execute_query(q)
        assert out["output"].length == 251
        assert eng.last_join_decision.strategy == strategy
        assert uses() - before == eng.last_join_decision.windows


class TestProgramsTable:
    def test_ring_respects_byte_budget(self):
        from pixie_tpu_torch.ingest.schemas import PROGRAMS_RELATION

        eng = Engine(device="cpu")
        budget = 16 << 10
        t = eng.create_table("__programs__", PROGRAMS_RELATION,
                             max_bytes=budget)
        row = {
            "time_": [time.time_ns()], "agent_id": ["a"],
            "program_id": ["0123456789abcdef"], "kind": ["fragment_update"],
            "label": ["MapOp,AggOp"], "compiles": [1], "hits": [100],
            "compile_ms": [12.5], "flops": [0.0], "bytes_accessed": [0.0],
            "argument_bytes": [0], "temp_bytes": [0], "peak_bytes": [0],
        }
        for i in range(800):
            row["hits"] = [i]
            eng.append_data("__programs__", row)
        st = t.stats()
        assert st.bytes <= budget * 1.5, st.bytes  # ring expired oldest
        assert st.num_rows < 800

    def test_collector_folds_program_rows(self):
        port, jax = _engines("t_fold_prog")
        for eng, enable in ((port, enable_self_telemetry),
                            (jax, jax_enable_self_telemetry)):
            enable(eng, agent_id="fold-test")
            eng.execute_query(AGG_QUERY.format(table="t_fold_prog"))
        cols = {}
        for name, eng in (("port", port), ("jax", jax)):
            rel = eng.table_store.relation("__programs__")
            assert sum(t.stats().num_rows
                       for t in eng.table_store.tablets("__programs__")) >= 1
            cols[name] = [n for n, _ in rel.items()]
        assert cols["port"] == cols["jax"]


class TestCalibration:
    def test_bound_accuracy_finite_ratio_per_script(self):
        """px/bound_accuracy returns a finite calibration ratio of at
        least 1 for every executed script hash, on both packages."""
        port, jax = _engines("t_calib", n=3000, mod=7)
        q1 = AGG_QUERY.format(table="t_calib")
        q2 = (
            "import px\n"
            "df = px.DataFrame(table='t_calib')\n"
            "df = df[df.v > 10]\n"
            "df = df.groupby(['k']).agg(m=('v', px.max))\n"
            "px.display(df)\n"
        )
        hashes = {hashlib.sha256(q.encode()).hexdigest()[:12]
                  for q in (q1, q2)}
        for eng, enable in ((port, enable_self_telemetry),
                            (jax, jax_enable_self_telemetry)):
            enable(eng, agent_id="calib-test")
            for q in (q1, q1, q2):
                eng.execute_query(q)
            rows = eng.execute_query(
                load_script("px/bound_accuracy").pxl)["output"].to_pydict()
            got = dict(zip(rows["script_hash"], rows["calib_mean"]))
            for h in hashes:
                assert h in got, (h, sorted(got))
                assert np.isfinite(got[h]) and got[h] >= 1.0, got[h]

    def test_queries_rows_carry_predicted(self):
        port, jax = _engines("t_pred_cols")
        q = (
            "import px\n"
            "df = px.DataFrame(table='__queries__')\n"
            "df = df[df.predicted_rows > 0]\n"
            "df = df.groupby(['script_hash']).agg(\n"
            "    pr=('predicted_rows', px.max), ri=('rows_in', px.max))\n"
            "px.display(df)\n"
        )
        got = {}
        for name, eng, enable in (("port", port, enable_self_telemetry),
                                  ("jax", jax, jax_enable_self_telemetry)):
            enable(eng)
            eng.execute_query(AGG_QUERY.format(table="t_pred_cols"))
            rows = eng.execute_query(q)["output"].to_pydict()
            assert rows["pr"] and all(p > 0 for p in rows["pr"])
            got[name] = dict(zip(rows["script_hash"], rows["ri"]))
        assert got["port"] == got["jax"]


class TestObservedFloor:
    @staticmethod
    def _floors(tracer, idx):
        tr = tracer.begin_query(script="q-floor")
        tr.usage.bytes_staged = 5000
        tracer.end_query(tr)
        h = tr.script_hash
        src = {"bytes_staged_hi": 10, "origin": "sketch"}
        high = {"bytes_staged_hi": 9999999}
        return (idx.observed(h), idx.floor_predicted(None, h),
                idx.floor_predicted(src, h), src,
                idx.floor_predicted(high, h) is high,
                idx.floor_predicted(None, "nohistory"))

    def test_floor_predicted_semantics_equal_jax(self):
        tracer = Tracer(registry=MetricsRegistry())
        port = self._floors(tracer, ObservedCostIndex(tracer=tracer))
        jtracer = JaxTracer(registry=JaxMetricsRegistry())
        jax = self._floors(jtracer, JaxObservedCostIndex(tracer=jtracer))
        assert port == jax
        observed, unknown, low, src, high_same, none = port
        assert observed["bytes_staged"] == 5000
        assert unknown["origin"] == "observed"
        assert unknown["bytes_staged_hi"] == unknown["observed_floor"] == 5000
        assert low["origin"] == "sketch+observed"
        assert src["bytes_staged_hi"] == 10  # the input is never mutated
        assert high_same and none is None

    def test_error_traces_not_indexed(self):
        tracer = Tracer(registry=MetricsRegistry())
        idx = ObservedCostIndex(tracer=tracer)
        tr = tracer.begin_query(script="q-err")
        tr.usage.bytes_staged = 777
        tracer.end_query(tr, status="error", error="boom")
        assert idx.observed(tr.script_hash) is None

    def test_broker_admits_against_observed_floor(self):
        """A sketch-less script with observed history is admitted against
        the observed floor: a budget below it rejects (floor on), admits
        (floor off), and a budget above it admits with the floored
        prediction stamped."""
        from pixie_tpu_torch.services import (
            AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)
        from pixie_tpu_torch.services.query_broker import AdmissionError

        def ready() -> bool:
            # The PEM's own table and a registered Kelvin: the agents'
            # self-telemetry tables fill the schemas' union before the
            # PEM's http_events arrives.
            st = tracker.distributed_state()
            return bool(st.pems_with_table("http_events") and st.kelvins)

        bus = MessageBus()
        tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
        pem = PEMAgent(bus, "pem-0", engine=Engine(device="cpu"),
                       heartbeat_interval_s=30.0)
        kelvin = KelvinAgent(bus, "kelvin-0", engine=Engine(device="cpu"),
                             heartbeat_interval_s=30.0)
        broker = None
        try:
            with override_flag("ingest_sketches", False), \
                    override_flag("device_residency", False):
                n = 3000
                # The rows land before the PEM starts, so its first
                # registration already names the table.
                pem.append_data("http_events", {
                    "time_": np.arange(n, dtype=np.int64),
                    "latency_ns": np.arange(n, dtype=np.int64),
                    "resp_status": np.full(n, 200, dtype=np.int64),
                    "service": [f"s-{i % 3}" for i in range(n)],
                })
                pem.start()
                kelvin.start()
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and not ready():
                    time.sleep(0.01)
                assert ready(), tracker.agents_info()
                broker = QueryBroker(bus, tracker)
                q = (
                    "import px\n"
                    "df = px.DataFrame(table='http_events')\n"
                    "df = df.groupby('service').agg("
                    "n=('latency_ns', px.count))\n"
                    "px.display(df)\n"
                )
                res = broker.execute_script(q, timeout_s=20)
                assert res["tables"]["output"].length == 3
                tr1 = broker.tracer.last()
                obs = broker.observed_costs.observed(tr1.script_hash)
                assert obs is not None and obs["bytes_staged"] > 0
                floor = obs["bytes_staged"]
                tiny_mb = floor / 2 / (1 << 20)
                with override_flag("admission_bytes_budget_mb", tiny_mb):
                    with pytest.raises(AdmissionError) as ei:
                        broker.execute_script(q, timeout_s=20)
                assert "observed" in str(ei.value)
                with override_flag("admission_bytes_budget_mb", tiny_mb), \
                        override_flag("admission_observed_floor", False):
                    res = broker.execute_script(q, timeout_s=20)
                    assert res["tables"]["output"].length == 3
                big_mb = floor * 4 / (1 << 20)
                with override_flag("admission_bytes_budget_mb", big_mb):
                    res = broker.execute_script(q, timeout_s=20)
                assert res["tables"]["output"].length == 3
                assert res["predicted_cost"]["origin"] == "observed"
                assert res["predicted_cost"]["bytes_staged_hi"] >= floor
        finally:
            if broker is not None:
                broker.close()
            pem.stop()
            kelvin.stop()
            tracker.close()
            bus.close()


class TestDeviceMemory:
    def test_cpu_snapshot_and_bracket(self):
        import torch

        mon = DeviceMemoryMonitor(MetricsRegistry())
        assert isinstance(mon.snapshot(), dict)  # {} without a card
        tok = mon.query_begin(torch.device("cpu"))
        assert tok is None and mon.query_end(tok) is None

    def test_collector_renders_without_devices(self):
        reg = MetricsRegistry()
        mon = DeviceMemoryMonitor(reg)
        mon.install_collector()
        out = reg.render()
        assert "pixie_collector_errors_total" not in out

    def test_poll_thread_start_stop(self):
        import torch

        mon = DeviceMemoryMonitor(MetricsRegistry())
        mon.start(poll_s=0.01)
        try:
            tok = mon.query_begin(torch.device("cpu"))
            time.sleep(0.05)
            assert mon.query_end(tok) is None
        finally:
            mon.stop()
        assert mon._thread is None

    def test_engine_stamps_no_peak_on_cpu(self):
        """A CPU engine has no allocator statistics: the peak stays None
        (the JAX CPU engine's is 0) and the telemetry row reads 0."""
        port, jax = _engines("t_devpeak")
        for eng in (port, jax):
            eng.execute_query(AGG_QUERY.format(table="t_devpeak"))
        assert port.tracer.last().usage.device_peak_bytes is None
        assert jax.tracer.last().usage.device_peak_bytes == 0
        assert "device_peak_bytes" in port.tracer.last().usage.to_dict()

    def test_usage_merge_takes_max_of_peaks(self):
        u = QueryResourceUsage(device_peak_bytes=100)
        u.merge({"device_peak_bytes": 500, "bytes_staged": 10})
        u.merge({"device_peak_bytes": 200})
        assert u.device_peak_bytes == 500
        assert u.bytes_staged == 10


@pytest.mark.cuda
def test_overlapping_queries_share_the_busy_period_peak():
    """On the card: a query's peak is the allocator's high-water mark over
    the busy period it ran in; an overlapping query's begin never resets
    the first one's peak."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    mon = DeviceMemoryMonitor(MetricsRegistry())
    a = mon.query_begin(dev)
    big = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    del big
    b = mon.query_begin(dev)  # must not reset a's peak
    peak_a = mon.query_end(a)
    peak_b = mon.query_end(b)
    assert peak_a >= 64 << 20 and peak_b >= 64 << 20
