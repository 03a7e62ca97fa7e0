"""The port's continuous profiler (``pixie_tpu_torch/ingest/profiler.py``)
and profile helpers (``services/telemetry.py``) against the JAX
package's.

The folded stacks, stack ids and the profile math (``profile_counts``,
``counts_delta``, ``collapsed_text``, ``profile_diff``, ``flame_html``)
give the JAX functions' output on the same input; the cases of
``tests/test_profiling.py`` hold on the port: sampler attribution,
cross-tenant isolation, the tenant CPU counter, a clean stop, the
``__stacks__`` table, the two-agent merge served at ``/debug/pprof`` and
``/debug/flamez``, and ``px/query_cpu`` naming the hot script and tenant
through a live broker. The sampler overhead A/B of the JAX file is
measured on the card (``chip_smoke.py`` ``cluster``), not here.
"""

from __future__ import annotations

import sys
import threading
import time
import types

import numpy as np
import pytest

from pixie_tpu.ingest import profiler as jax_profiler
from pixie_tpu.services import telemetry as jax_telemetry
from pixie_tpu_torch import config
from pixie_tpu_torch.exec import threadmap
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.ingest import profiler as port_profiler
from pixie_tpu_torch.ingest.collector import Collector
from pixie_tpu_torch.ingest.profiler import (
    TRUNCATED_MARKER,
    PerfProfilerConnector,
    _fold_stack,
    profile_summary,
    stack_id,
)
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services import telemetry
from pixie_tpu_torch.services.observability import (
    ObservabilityServer,
    default_counter,
)


def _trace(qid="", script_hash="", tenant=""):
    """A stand-in for QueryTrace: the attribution reader touches only
    these three attributes."""
    return types.SimpleNamespace(qid=qid, script_hash=script_hash,
                                 tenant=tenant)


def _spin_alpha_marker(stop):
    while not stop.is_set():
        sum(range(200))


def _spin_beta_marker(stop):
    while not stop.is_set():
        sum(range(200))


class _AttributedSpin:
    """A worker thread spinning in a uniquely named function with its
    attribution bound around the spin."""

    def __init__(self, fn, trace, phase="host"):
        self.stop = threading.Event()
        self._fn, self._trace, self._phase = fn, trace, phase
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        tok = threadmap.bind(trace=self._trace, phase=self._phase)
        try:
            self._fn(self.stop)
        finally:
            threadmap.unbind(tok)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=5)


def _sweep(conn, n=25, dt=0.002):
    for _ in range(n):
        conn.sample()
        time.sleep(dt)


def _conn(agent_id):
    c = PerfProfilerConnector(
        pod=f"test/{agent_id}", agent_id=agent_id,
        sampling_period_s=0.0, push_period_s=0.0,
    )
    c.init()
    return c


def _deep(n):
    if n:
        return _deep(n - 1)
    return sys._getframe()


def _seeded_counts(seed: int, n: int = 40) -> dict:
    rng = np.random.default_rng(seed)
    frames = [f"m{i}.py:f{i}" for i in range(10)]
    out = {}
    for _ in range(n):
        stack = ";".join(rng.choice(frames, int(rng.integers(1, 6))))
        out[stack] = out.get(stack, 0) + int(rng.integers(1, 100))
    return out


def _seeded_rows(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    frames = [f"m{i}.py:f{i}" for i in range(10)]
    return [
        {"stack": ";".join(rng.choice(frames, int(rng.integers(1, 6)))),
         "count": int(rng.integers(1, 100)),
         "qid": f"q{int(rng.integers(0, 3))}",
         "script_hash": ("h1", "h2", "")[int(rng.integers(0, 3))],
         "tenant": ("alpha", "beta", "")[int(rng.integers(0, 3))],
         "phase": ("host", "device_dispatch")[int(rng.integers(0, 2))]}
        for _ in range(n)
    ]


class TestEqualToJax:
    @pytest.mark.parametrize("depth,max_depth", [(0, 64), (10, 3),
                                                 (80, 64), (5, 6)])
    def test_fold_stack(self, depth, max_depth):
        frame = _deep(depth)
        assert _fold_stack(frame, max_depth) == jax_profiler._fold_stack(
            frame, max_depth)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_stack_id(self, seed):
        for stack in _seeded_counts(seed):
            assert stack_id(stack) == jax_profiler.stack_id(stack)
            assert 0 <= stack_id(stack) < 1 << 63

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_profile_counts(self, seed):
        rows = _seeded_rows(seed)
        for kw in ({}, {"tenant": "alpha"}, {"script_hash": "h2"},
                   {"phase": "device_dispatch"},
                   {"tenant": "", "script_hash": "h1"}):
            assert telemetry.profile_counts(rows, **kw) == (
                jax_telemetry.profile_counts(rows, **kw)), kw

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_counts_delta(self, seed):
        a, b = _seeded_counts(seed), _seeded_counts(seed + 10)
        assert telemetry.counts_delta(a, b) == jax_telemetry.counts_delta(
            a, b)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_profile_diff(self, seed):
        a, b = _seeded_counts(seed), _seeded_counts(seed + 10)
        assert telemetry.profile_diff(a, b) == jax_telemetry.profile_diff(
            a, b)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_collapsed_text(self, seed):
        c = _seeded_counts(seed)
        assert telemetry.collapsed_text(c) == jax_telemetry.collapsed_text(c)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_flame_html(self, seed):
        c = _seeded_counts(seed)
        assert telemetry.flame_html(c, title=f"t{seed}") == (
            jax_telemetry.flame_html(c, title=f"t{seed}"))

    def test_summary_keys_equal(self):
        """One sampler of each package over the same attributed spin
        (each bound with its package's thread map) keys the spin's
        stacks with the same attribution."""
        from pixie_tpu.exec import threadmap as jax_threadmap

        got = {}
        for name, prof, tm in (("port", port_profiler, threadmap),
                               ("jax", jax_profiler, jax_threadmap)):
            conn = prof.PerfProfilerConnector(
                pod="test/eq", agent_id=f"eq-{name}",
                sampling_period_s=0.0, push_period_s=0.0)
            stop = threading.Event()

            def run(tm=tm, stop=stop):
                tok = tm.bind(trace=_trace("q", "h", "alpha"), phase="host")
                try:
                    _spin_alpha_marker(stop)
                finally:
                    tm.unbind(tok)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            try:
                _sweep(conn, n=10)
            finally:
                stop.set()
                t.join(5)
            got[name] = {k[1:] for k, _ in conn.summary_items()
                         if "_spin_alpha_marker" in k[0]}
        assert got["port"] == got["jax"] == {("q", "h", "alpha", "host")}


class TestFoldStack:
    def test_truncated_marker_lands_at_root(self):
        trunc = _fold_stack(_deep(10), max_depth=3)
        parts = trunc.split(";")
        assert parts[0] == TRUNCATED_MARKER
        assert len(parts) == 4  # marker + the 3 innermost frames
        assert parts[-1].endswith(":_deep")

    def test_marker_disambiguates_deep_from_shallow(self):
        trunc = _fold_stack(_deep(10), max_depth=3)
        assert trunc != ";".join(trunc.split(";")[1:])
        assert trunc.startswith(TRUNCATED_MARKER + ";")

    def test_shallow_stack_has_no_marker(self):
        s = _fold_stack(sys._getframe())
        assert TRUNCATED_MARKER not in s
        assert s.endswith(
            "test_torch_profiling.py:test_shallow_stack_has_no_marker")


class TestSamplerAttribution:
    def test_attribution_majority(self):
        conn = _conn("attr-major")
        try:
            tr = _trace(qid="q-a", script_hash="hash-a", tenant="alpha")
            with _AttributedSpin(_spin_alpha_marker, tr):
                _sweep(conn)
            rows = profile_summary(agent_id="attr-major", top=0)
            marked = [r for r in rows if "_spin_alpha_marker" in r["stack"]]
            assert marked, "sampler never caught the spin thread"
            for r in marked:
                assert (r["tenant"], r["script_hash"], r["qid"],
                        r["phase"]) == ("alpha", "hash-a", "q-a", "host")
            by_hash: dict = {}
            for r in rows:
                if r["script_hash"]:
                    by_hash[r["script_hash"]] = (
                        by_hash.get(r["script_hash"], 0) + r["count"])
            assert max(by_hash, key=by_hash.get) == "hash-a"
        finally:
            conn.stop()

    def test_cross_tenant_isolation(self):
        conn = _conn("attr-iso")
        try:
            with _AttributedSpin(_spin_alpha_marker,
                                 _trace("qa", "ha", "alpha")), \
                    _AttributedSpin(_spin_beta_marker,
                                    _trace("qb", "hb", "beta")):
                _sweep(conn)
            rows = profile_summary(agent_id="attr-iso", top=0)
            a_rows = [r for r in rows if "_spin_alpha_marker" in r["stack"]]
            b_rows = [r for r in rows if "_spin_beta_marker" in r["stack"]]
            assert a_rows and b_rows
            assert all(r["tenant"] == "alpha" for r in a_rows)
            assert all(r["tenant"] == "beta" for r in b_rows)
        finally:
            conn.stop()

    def test_per_tenant_cpu_counter(self):
        with config.override_flag("admission_tenant_weights", "alpha:1"):
            from pixie_tpu_torch.services.tenancy import resolve_tenant

            tenant = resolve_tenant("alpha")
            assert tenant == "alpha"
            counter = default_counter(
                "pixie_cpu_samples_total",
                "Profiler stack samples attributed to each tenant "
                "(samples * sampling period = CPU-seconds)",
            )
            before = counter.labels(tenant=tenant).value()
            conn = _conn("attr-counter")
            try:
                with _AttributedSpin(_spin_alpha_marker,
                                     _trace("q", "h", "alpha")):
                    _sweep(conn, n=15)
            finally:
                conn.stop()
            assert counter.labels(tenant=tenant).value() > before

    def test_unregistered_tenant_folds_to_shared_label(self):
        from pixie_tpu_torch.services.tenancy import (
            DEFAULT_TENANT, resolve_tenant)

        tenant = resolve_tenant(DEFAULT_TENANT)
        counter = default_counter(
            "pixie_cpu_samples_total",
            "Profiler stack samples attributed to each tenant "
            "(samples * sampling period = CPU-seconds)",
        )
        before = counter.labels(tenant=tenant).value()
        conn = _conn("attr-unreg")
        try:
            with _AttributedSpin(_spin_alpha_marker,
                                 _trace("q", "h", "not-registered-x")):
                _sweep(conn, n=10)
        finally:
            conn.stop()
        assert counter.labels(tenant=tenant).value() > before

    def test_sampler_stop_leaves_no_threads_or_roster_entries(self):
        eng = Engine(device="cpu")
        before_threads = threading.active_count()
        coll = Collector()
        coll.wire_to(eng)
        conn = PerfProfilerConnector(
            pod="test/leak", agent_id="leak-check",
            sampling_period_s=0.0, push_period_s=0.0,
        )
        coll.register_source(conn)
        coll.run_as_thread()
        time.sleep(0.05)
        assert profile_summary(agent_id="leak-check", top=1) is not None
        coll.stop()
        deadline = time.time() + 5
        while (time.time() < deadline
               and threading.active_count() > before_threads):
            time.sleep(0.01)
        assert threading.active_count() <= before_threads
        assert profile_summary(agent_id="leak-check", top=0) == []


def _stacks_engine(agent_id: str, trace) -> Engine:
    """A CPU engine whose collector drained a sampler over an attributed
    spin into ``__stacks__`` and ``stack_traces.beta``."""
    eng = Engine(device="cpu")
    coll = Collector()
    coll.wire_to(eng)
    conn = PerfProfilerConnector(
        pod=f"test/{agent_id}", agent_id=agent_id,
        sampling_period_s=0.0, push_period_s=0.0,
    )
    coll.register_source(conn)
    try:
        with _AttributedSpin(_spin_alpha_marker, trace):
            for _ in range(15):
                conn.transfer_data(coll, coll._data_tables)
                time.sleep(0.002)
        coll.flush()
    finally:
        coll.stop()
    return eng


class TestStacksTable:
    def test_attributed_rows_reach_stacks_table(self):
        eng = _stacks_engine("tbl-agent", _trace("q-t", "hash-t", "alpha"))
        out = eng.execute_query(
            "import px\ndf = px.DataFrame(table='__stacks__')\n"
            "px.display(df)\n", max_output_rows=10_000,
        )["output"].to_pydict()
        assert len(out["stack_trace"]), "no __stacks__ rows landed"
        assert set(out["agent_id"]) == {"tbl-agent"}
        idx = [i for i, s in enumerate(out["stack_trace"])
               if "_spin_alpha_marker" in s]
        assert idx, "spin thread missing from __stacks__"
        for i in idx:
            assert (out["tenant"][i], out["script_hash"][i], out["qid"][i],
                    out["phase"][i]) == ("alpha", "hash-t", "q-t", "host")
            assert out["stack_trace_id"][i] == jax_profiler.stack_id(
                out["stack_trace"][i])
        legacy = eng.execute_query(
            "import px\ndf = px.DataFrame(table='stack_traces.beta')\n"
            "px.display(df)\n", max_output_rows=10_000,
        )["output"].to_pydict()
        assert any("_spin_alpha_marker" in s for s in legacy["stack_trace"])

    def test_tenant_cpu_script_runs_on_real_rows(self):
        eng = _stacks_engine("pxl-agent", _trace("q", "h", "alpha"))
        out = eng.execute_query(
            load_script("px/tenant_cpu").pxl, max_output_rows=10_000,
        )["output"].to_pydict()
        assert "alpha" in set(out["tenant"])
        for i in range(len(out["tenant"])):
            assert out["cpu_seconds"][i] == pytest.approx(
                out["samples"][i] / 100.0)


class TestDiffMath:
    BASE = {"a;b;c": 10, "a;b;d": 5}
    CMP = {"a;b;c": 10, "a;b;d": 20, "x;y": 3}

    def test_profile_diff_golden(self):
        rows = telemetry.profile_diff(self.BASE, self.CMP)
        by_frame = {r["frame"]: r for r in rows}
        d = by_frame["d"]
        assert (d["self_base"], d["self_cmp"], d["self_delta"]) == (5, 20, 15)
        assert (d["total_base"], d["total_cmp"], d["total_delta"]) == (
            5, 20, 15)
        b = by_frame["b"]
        assert b["self_delta"] == 0
        assert (b["total_base"], b["total_cmp"], b["total_delta"]) == (
            15, 30, 15)
        assert (by_frame["y"]["self_base"], by_frame["y"]["self_delta"]) == (
            0, 3)
        assert by_frame["c"]["self_delta"] == 0
        assert by_frame["c"]["total_delta"] == 0
        assert rows[0]["frame"] == "d"

    def test_counts_delta_clamps_evictions(self):
        assert telemetry.counts_delta({"s": 5, "t": 3}, {"s": 7}) == {"s": 2}
        assert telemetry.counts_delta({"s": 7}, {"s": 7}) == {}

    def test_collapsed_text_format(self):
        assert telemetry.collapsed_text({"a;b": 2, "c": 9}) == "c 9\na;b 2\n"
        assert telemetry.collapsed_text({}) == ""

    def test_flame_html_smoke(self):
        html = telemetry.flame_html({"a;b;c": 10, "a;d": 5}, title="t<est>")
        assert html.startswith("<!doctype html>")
        assert "t&lt;est&gt;" in html
        assert "total samples: 15" in html


class TestClusterMergeAndPprof:
    def test_two_agent_merge_served_from_broker_endpoints(self):
        from pixie_tpu_torch.services import (
            AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)

        bus = MessageBus()
        tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
        agents = [
            PEMAgent(bus, f"pem-{i}", engine=Engine(device="cpu"),
                     heartbeat_interval_s=0.05).start() for i in range(2)
        ] + [KelvinAgent(bus, "kelvin-0", engine=Engine(device="cpu"),
                         heartbeat_interval_s=0.05).start()]
        conn0, conn1 = _conn("pem-0"), _conn("pem-1")
        broker = None
        try:
            tr_a = _trace(qid="q0", script_hash="h0", tenant="alpha")
            with _AttributedSpin(_spin_alpha_marker, tr_a):
                _sweep(conn0, n=10)
            with _AttributedSpin(_spin_beta_marker,
                                 _trace("q1", "h1", "beta")):
                _sweep(conn1, n=10)
            deadline = time.time() + 5
            while time.time() < deadline and not (
                    {"pem-0", "pem-1"} <= set(tracker.profile_agents())):
                time.sleep(0.01)
            broker = QueryBroker(bus, tracker)
            assert {"pem-0", "pem-1"} <= set(broker.profile_agents())
            stacks = "\n".join(r["stack"] for r in broker.profile_rows())
            assert "_spin_alpha_marker" in stacks  # from pem-0
            assert "_spin_beta_marker" in stacks   # from pem-1

            obs = ObservabilityServer(profilez_fn=broker.profile_rows)
            code, ctype, body = obs.handle("/debug/pprof")
            assert code == 200 and ctype.startswith("text/plain")
            assert "_spin_alpha_marker" in body
            assert "_spin_beta_marker" in body
            for line in body.strip().splitlines():
                stack, _, count = line.rpartition(" ")
                assert stack and int(count) > 0
            _, _, alpha_only = obs.handle("/debug/pprof?tenant=alpha")
            assert "_spin_alpha_marker" in alpha_only
            assert "_spin_beta_marker" not in alpha_only
            _, _, h1_only = obs.handle("/debug/pprof?script=h1")
            assert "_spin_beta_marker" in h1_only
            assert "_spin_alpha_marker" not in h1_only
            code, ctype, page = obs.handle("/debug/flamez")
            assert code == 200 and ctype == "text/html"
            assert "_spin_alpha_marker" in page
            # Windowed pprof: the delta holds the still-hot stack.
            with _AttributedSpin(_spin_alpha_marker, tr_a):
                stop = threading.Event()

                def bg():
                    while not stop.is_set():
                        conn0.sample()
                        time.sleep(0.002)

                t = threading.Thread(target=bg, daemon=True)
                t.start()
                try:
                    _, _, windowed = obs.handle("/debug/pprof?seconds=0.3")
                finally:
                    stop.set()
                    t.join(timeout=5)
            assert "_spin_alpha_marker" in windowed
            # The bus API: broker.profile, as `px profile` asks it.
            broker.serve()
            reply = bus.request("broker.profile", {"tenant": "beta"},
                                timeout_s=5.0)
            assert reply["ok"] and {"pem-0", "pem-1"} <= set(reply["agents"])
            assert all(r["tenant"] == "beta" for r in reply["stacks"])
        finally:
            conn0.stop()
            conn1.stop()
            if broker is not None:
                broker.close()
            for a in agents:
                a.stop()
            tracker.close()
            bus.close()

    def test_unwired_profile_endpoint_404s(self):
        code, _, body = ObservabilityServer().handle("/debug/pprof")
        assert code == 404 and "no profiler wired" in body


HEAVY_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum),"
    " mn=('v', px.min), mx=('v', px.max))\n"
    "px.display(df)\n"
)


class TestQueryCpuEndToEnd:
    def test_query_cpu_names_the_hot_script_and_tenant(self):
        """A script run through a live broker under a registered tenant,
        with the profiler sampling, is the top attributed consumer in
        px/query_cpu with the admitting tenant on its row."""
        from pixie_tpu_torch.services import (
            AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)

        with config.override_flag("admission_tenant_weights", "alpha:1"):
            bus = MessageBus()
            tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
            pem = PEMAgent(bus, "pem-e2e", engine=Engine(device="cpu"),
                           heartbeat_interval_s=0.05)
            kelvin = KelvinAgent(bus, "kelvin-e2e",
                                 engine=Engine(device="cpu"),
                                 heartbeat_interval_s=0.05)
            coll = pem.collector
            conn = PerfProfilerConnector(
                pod="test/e2e", agent_id="pem-e2e",
                sampling_period_s=0.0, push_period_s=0.0,
            )
            coll.register_source(conn)
            pem.start()
            kelvin.start()
            broker = None
            try:
                n = 60_000
                rng = np.random.default_rng(11)
                pem.append_data("t", {
                    "time_": np.arange(n, dtype=np.int64),
                    "k": rng.integers(0, 13, n),
                    "v": rng.integers(0, 1000, n),
                })
                conn.transfer_data(coll, coll._data_tables)
                coll.flush()
                pem._register()
                deadline = time.time() + 5
                while time.time() < deadline and not (
                        {"t", "__stacks__", "__queries__"}
                        <= set(tracker.schemas())):
                    time.sleep(0.01)
                broker = QueryBroker(bus, tracker)
                stop = threading.Event()

                def sampler():
                    while not stop.is_set():
                        conn.sample()
                        time.sleep(0.002)

                st = threading.Thread(target=sampler, daemon=True)
                st.start()
                try:
                    for _ in range(5):
                        res = broker.execute_script(HEAVY_Q, timeout_s=60,
                                                    tenant="alpha")
                        assert res["tables"]["output"].length == 13
                        rows = profile_summary(agent_id="pem-e2e", top=0)
                        if any(r["tenant"] == "alpha" for r in rows):
                            break
                finally:
                    stop.set()
                    st.join(timeout=5)
                conn.transfer_data(coll, coll._data_tables)
                coll.flush()
                frag_hashes = {
                    t["script_hash"] for t in pem.engine.tracer.recent()
                    if t.get("kind") == "fragment"
                    and t.get("tenant") == "alpha"
                }
                assert frag_hashes
                out = broker.execute_script(
                    load_script("px/query_cpu").pxl, timeout_s=60,
                )["tables"]["output"].to_pydict()
                assert len(out["script_hash"]), "px/query_cpu returned no rows"
                top = max(range(len(out["samples"])),
                          key=lambda i: out["samples"][i])
                assert out["script_hash"][top] in frag_hashes
                assert out["tenant"][top] == "alpha"
                assert out["cpu_seconds"][top] == pytest.approx(
                    out["samples"][top] / 100.0)
                assert out["queries"][top] >= 1
            finally:
                conn.stop()
                if broker is not None:
                    broker.close()
                pem.stop()
                kelvin.stop()
                tracker.close()
                bus.close()
