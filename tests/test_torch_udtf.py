"""The UDTF framework and introspection: the port against the JAX
package, case by case from ``tests/test_udtf.py``.

Each case runs on a JAX engine and on a port engine on the CPU over the
same rows, checks the JAX case's assertions on both, and the two
packages' answers must be equal: the tables and their row counts, the
schemas, the registry listings (every UDF, UDA and UDTF name and the
first UDF's signature), a UDTF composed with a filter, the debug table
info, a custom UDTF with arguments, the compile-time refusals (same
messages), an empty source, and, through a broker with two PEMs and a
Kelvin, ``GetAgentStatus`` and the all-agents ``GetTables``. The
cluster cases wait until the tracker holds every PEM's table and the
Kelvin (the agents' self-telemetry tables reach the schemas' union
first).
"""

from __future__ import annotations

import json
import re
import time
import types

import numpy as np
import pytest

import pixie_tpu.services as jax_services
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.planner.objects import PxLError as JaxPxLError
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.udf.udtf import UDTFExecutor as JaxUDTFExecutor
import pixie_tpu_torch.services as port_services
from pixie_tpu_torch.exec import Engine
from pixie_tpu_torch.exec import plan as port_plan
from pixie_tpu_torch.planner.objects import PxLError
from pixie_tpu_torch.types.dtypes import DataType
from pixie_tpu_torch.udf.udtf import UDTFExecutor

PKGS = {
    "jax": types.SimpleNamespace(
        engine=lambda: JaxEngine(), services=jax_services, plan=jax_plan,
        PxLError=JaxPxLError, DataType=JaxDataType,
        UDTFExecutor=JaxUDTFExecutor),
    "port": types.SimpleNamespace(
        engine=lambda: Engine(device="cpu"), services=port_services,
        plan=port_plan, PxLError=PxLError, DataType=DataType,
        UDTFExecutor=UDTFExecutor),
}


def _both(case):
    """Run ``case(p)`` on each package; the observations must agree."""
    got = {name: case(p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _engine_with_data(p):
    e = p.engine()
    e.append_data("http_events", {
        "time_": np.arange(100, dtype=np.int64),
        "resp_status": np.full(100, 200, dtype=np.int64),
    })
    return e


def _q(e, script: str, name: str = "o") -> dict:
    return e.execute_query(script)[name].to_pydict()


class TestUDTFEngine:
    def test_get_tables(self):
        def case(p):
            out = _q(_engine_with_data(p),
                     "import px\npx.display(px.GetTables(), 'o')\n")
            assert list(out["table_name"]) == ["http_events"]
            assert out["num_rows"][0] == 100
            return list(out["table_name"]), out["num_rows"].tolist()

        _both(case)

    def test_get_table_schemas(self):
        def case(p):
            out = _q(_engine_with_data(p),
                     "import px\npx.display(px.GetTableSchemas(), 'o')\n")
            cols = dict(zip(out["column_name"], out["column_type"]))
            assert cols == {"time_": "TIME64NS", "resp_status": "INT64"}
            return cols

        _both(case)

    def test_registry_listings(self):
        def case(p):
            out = _engine_with_data(p).execute_query(
                "import px\n"
                "px.display(px.GetUDFList(), 'udfs')\n"
                "px.display(px.GetUDAList(), 'udas')\n"
                "px.display(px.GetUDTFList(), 'udtfs')\n"
            )
            udfs = out["udfs"].to_pydict()
            assert "add" in list(udfs["name"])
            sig = json.loads(udfs["signature"][0])
            assert {"args", "return", "executor"} <= set(sig)
            udas = out["udas"].to_pydict()
            assert "mean" in list(udas["name"])
            udtfs = out["udtfs"].to_pydict()
            assert "GetTables" in list(udtfs["name"])
            return (sorted(set(udfs["name"])), sorted(set(udas["name"])),
                    sorted(set(udtfs["name"])), sig)

        _both(case)

    def test_udtf_composes_with_ops(self):
        def case(p):
            out = _q(_engine_with_data(p),
                     "import px\n"
                     "df = px.GetTableSchemas()\n"
                     "df = df[df.column_type == 'INT64']\n"
                     "px.display(df, 'o')\n")
            assert list(out["column_name"]) == ["resp_status"]
            return list(out["column_name"])

        _both(case)

    def test_debug_table_info(self):
        def case(p):
            e = _engine_with_data(p)
            e.tables["http_events"].compact()
            out = _q(e, "import px\npx.display(px.GetDebugTableInfo(), 'o')\n")
            assert out["compacted_batches"][0] >= 1
            return int(out["compacted_batches"][0])

        _both(case)

    def test_custom_udtf_with_args(self):
        def case(p):
            e = p.engine()
            e.registry = e.registry.clone("t")
            e.registry.udtf(
                "Range",
                [("x", p.DataType.INT64)],
                lambda engine, n=5: {"x": list(range(n))},
                executor=p.UDTFExecutor.ONE_KELVIN,
                init_args=(("n", p.DataType.INT64),),
            )
            out = _q(e, "import px\npx.display(px.Range(n=3), 'o')\n")
            assert list(out["x"]) == [0, 1, 2]
            return out["x"].tolist()

        _both(case)

    def test_unknown_udtf_arg_rejected(self):
        def case(p):
            e = _engine_with_data(p)
            with pytest.raises(p.PxLError) as ei:
                e.execute_query(
                    "import px\npx.display(px.GetTables(bogus=1), 'o')\n")
            return str(ei.value)

        _both(case)

    def test_missing_required_arg_and_bad_type_rejected_at_compile(self):
        def case(p):
            e = p.engine()
            e.registry = e.registry.clone("t")
            e.registry.udtf(
                "NeedsArg",
                [("x", p.DataType.INT64)],
                lambda engine, n: {"x": list(range(n))},  # no default
                init_args=(("n", p.DataType.INT64),),
            )
            with pytest.raises(p.PxLError, match="missing required") as e1:
                e.execute_query("import px\npx.display(px.NeedsArg(), 'o')\n")
            with pytest.raises(p.PxLError, match="must be INT64") as e2:
                e.execute_query(
                    "import px\npx.display(px.NeedsArg(n='x'), 'o')\n")
            return str(e1.value), str(e2.value)

        _both(case)


class TestEmptySource:
    def test_empty_source_yields_zero_rows(self):
        def case(p):
            e = p.engine()
            plan = p.plan.Plan()
            src = plan.add(p.plan.EmptySourceOp(relation_items=(
                ("time_", p.DataType.TIME64NS), ("v", p.DataType.INT64))))
            plan.add(p.plan.ResultSinkOp("o"), [src])
            out = e.execute_plan(plan)["o"]
            assert out.length == 0
            assert out.relation.column_names == ("time_", "v")
            return out.length, out.relation.column_names

        _both(case)


def _cluster(p, rows_per_pem):
    """Two PEMs (rows appended before they start) and a Kelvin behind a
    broker, returned once the tracker holds the PEMs' tables and the
    Kelvin."""
    s = p.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60, check_interval_s=60)
    agents = []
    for i, n in enumerate(rows_per_pem):
        pem = s.PEMAgent(bus, f"pem-{i}", engine=p.engine(),
                         heartbeat_interval_s=0.05)
        if n:
            pem.append_data(
                "http_events", {"time_": np.arange(n, dtype=np.int64)})
        agents.append(pem.start())
    agents.append(s.KelvinAgent(bus, "kelvin-0", engine=p.engine(),
                                heartbeat_interval_s=0.05).start())
    want = sum(1 for n in rows_per_pem if n)

    def ready():
        st = tracker.distributed_state()
        return (len(st.pems_with_table("http_events")) == want
                and len(st.kelvins) == 1
                and len(tracker.agent_ids()) == len(agents))

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not ready():
        time.sleep(0.01)
    assert ready(), tracker.agents_info()
    return bus, tracker, agents, s.QueryBroker(bus, tracker)


def _close(bus, tracker, agents, broker):
    broker.close()
    for a in agents:
        a.stop()
    tracker.close()
    bus.close()


class TestUDTFCluster:
    def test_agent_status_over_bus(self):
        def case(p):
            parts = _cluster(p, [10, 0])
            try:
                res = parts[3].execute_script(
                    "import px\npx.display(px.GetAgentStatus(), 'o')\n")
                out = res["tables"]["o"].to_pydict()
                assert set(out["agent_id"]) == {"pem-0", "pem-1", "kelvin-0"}
                kinds = dict(zip(out["agent_id"], out["kind"]))
                assert kinds["kelvin-0"] == "kelvin"
                assert kinds["pem-0"] == "pem"
                # A ONE_KELVIN UDTF dispatches no data fragment.
                assert res["distributed_plan"].n_data_shards == 0
                return sorted(kinds.items())
            finally:
                _close(*parts)

        _both(case)

    def test_all_agents_udtf_gathers_from_pems(self):
        def case(p):
            parts = _cluster(p, [10, 20])
            try:
                res = parts[3].execute_script(
                    "import px\npx.display(px.GetTables(), 'o')\n")
                out = res["tables"]["o"].to_pydict()
                # One http_events row per PEM, gathered on the merge tier
                # (the agents' self-telemetry tables are filtered out).
                rows = sorted(
                    int(r) for t, r in zip(out["table_name"], out["num_rows"])
                    if t == "http_events"
                )
                assert rows == [10, 20]
                return rows
            finally:
                _close(*parts)

        _both(case)


class TestGetVersion:
    def test_version_udtf(self):
        def case(p):
            out = _q(p.engine(),
                     "import px\npx.display(px.GetVersion(), 'output')",
                     "output")
            kv = dict(zip(out["key"], out["value"]))
            assert "version" in kv and "git_commit" in kv
            assert kv["git_commit"] == "unknown" or re.fullmatch(
                r"[0-9a-f]{40}", kv["git_commit"]), kv["git_commit"]
            return sorted(kv), kv["git_commit"]

        _both(case)
