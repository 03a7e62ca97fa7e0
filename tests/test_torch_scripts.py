"""The shipped script library on the port against the JAX package.

Every script of ``pixie_tpu_torch/scripts`` is a copy of the JAX
package's (source, manifest and vis spec), compiles to the JAX
package's plan against the canonical schemas, and executes on the
port's CPU engine over the rows of ``tests/test_scripts.py``'s
``_seed_all_tables`` to the JAX engine's answer over the same rows.

The comparison is ``chip_smoke.check_library_output``, the one the card's
library phase holds the card to the CPU engine with. Tolerances: keys,
strings, integers and times are exact, so are the ``count_distinct``
estimates (equal dictionary ids hash to equal HLL registers); FLOAT64
values are rtol 1e-5 (f32 window sums in another order); values derived
from a t-digest quantile (traced through the plan from a
``quantiles``/``_quantile_*`` aggregate) are rtol 0.05, the JAX
package's own Pallas-vs-XLA tolerance (tests/test_pallas.py). Row
scripts (no aggregate, join or union) compare in row order; the others
compare as row sets, sorted by their exactly-compared columns.
``px/agent_status`` reads the agent tracker over the service bus: it
compiles against registries bound to a bus, and runs on a one-PEM port
cluster against the JAX one (agent ids and kinds exact, heartbeat ages
under three intervals).
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from pixie_tpu.config import set_flag as jax_set_flag
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.ingest.schemas import CANONICAL_SCHEMAS as JAX_SCHEMAS
from pixie_tpu.ingest.schemas import init_schemas as jax_init_schemas
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.scripts import list_scripts as jax_list_scripts
from pixie_tpu.scripts import load_script as jax_load_script
from pixie_tpu.udf.registry import default_registry as jax_registry
import pixie_tpu.services as jax_services
from pixie_tpu.services.vizier_funcs import (
    bind_service_registry as jax_bind_service_registry,
)
from chip_smoke import _quantile_columns, check_library_output
from pixie_tpu_torch import Engine
from pixie_tpu_torch.ingest.schemas import CANONICAL_SCHEMAS, init_schemas
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.scripts import list_scripts, load_script
from pixie_tpu_torch.udf.registry import default_registry
import pixie_tpu_torch.services as port_services
from pixie_tpu_torch.services.vizier_funcs import bind_service_registry

from test_scripts import _seed_all_tables
from test_torch_planner import _plan_shape

WINDOW = 1 << 11
AGENT_STATUS = "px/agent_status"
HEARTBEAT_S = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(window_rows=WINDOW)
    jax_init_schemas(jax_eng)
    _seed_all_tables(jax_eng)
    eng = Engine(window_rows=WINDOW, device="cpu")
    init_schemas(eng)
    _seed_all_tables(eng)
    return jax_eng, eng


def _registries(name):
    """(port, JAX) registries to compile ``name`` with: bound to a bus
    for ``px/agent_status`` (its UDTF asks the agent tracker)."""
    if name != AGENT_STATUS:
        return default_registry(), jax_registry()
    return (
        bind_service_registry(default_registry(), port_services.MessageBus(),
                              "test"),
        jax_bind_service_registry(jax_registry(),
                                  jax_services.MessageBus(), "test"),
    )


@contextlib.contextmanager
def _one_pem_cluster(services, engine):
    """A PEM with ``http_events`` rows and a Kelvin, a tracker and a
    broker on one bus; stopped and closed on exit."""
    bus = services.MessageBus()
    tracker = services.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    try:
        pem = services.PEMAgent(bus, "pem-0", engine=engine(),
                                heartbeat_interval_s=HEARTBEAT_S)
        agents.append(pem.start())
        agents.append(services.KelvinAgent(
            bus, "kelvin-0", engine=engine(),
            heartbeat_interval_s=HEARTBEAT_S,
        ).start())
        pem.append_data("http_events", {
            "time_": np.arange(100, dtype=np.int64),
            "latency_ns": np.arange(100, dtype=np.int64),
        })
        pem._register()
        deadline = time.monotonic() + 5.0
        while ("http_events" not in tracker.schemas()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        broker = services.QueryBroker(bus, tracker)
        yield broker
    finally:
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def _agent_status_rows(services, engine):
    with _one_pem_cluster(services, engine) as broker:
        res = broker.execute_script(load_script(AGENT_STATUS).pxl)
    (hb,) = res["tables"].values()
    d = hb.to_pydict()
    order = sorted(range(hb.length), key=lambda i: d["agent_id"][i])
    return {k: [v[i] for i in order] for k, v in d.items()}


def _check_agent_status():
    got = _agent_status_rows(
        port_services, lambda: Engine(window_rows=WINDOW, device="cpu"))
    ref = _agent_status_rows(
        jax_services, lambda: JaxEngine(window_rows=WINDOW))
    assert got["agent_id"] == ref["agent_id"] == ["kelvin-0", "pem-0"]
    assert got["kind"] == ref["kind"]
    # Both packages' agents hold their self-telemetry tables too.
    assert got["num_tables"] == ref["num_tables"]
    assert all(0 <= a < 3 * HEARTBEAT_S + 1.0 for a in got["last_heartbeat_s"])


def test_library_is_the_jax_packages():
    assert list_scripts() == jax_list_scripts()
    assert len(list_scripts()) == 81


@pytest.mark.parametrize("name", list_scripts())
def test_script_copy_matches_jax_package(name):
    got, ref = load_script(name), jax_load_script(name)
    assert (got.pxl, got.manifest, got.vis, got.tables) == (
        ref.pxl, ref.manifest, ref.vis, ref.tables)


def test_canonical_schemas_match_jax_package():
    assert list(CANONICAL_SCHEMAS) == list(JAX_SCHEMAS)
    for name, rel in CANONICAL_SCHEMAS.items():
        assert [(c, t.name) for c, t in rel.items()] == [
            (c, t.name) for c, t in JAX_SCHEMAS[name].items()], name


@pytest.mark.parametrize("name", list_scripts())
def test_compiles_like_jax(name):
    reg, jax_reg = _registries(name)
    pxl = load_script(name).pxl
    got = compile_pxl(pxl, CompilerState(
        schemas=dict(CANONICAL_SCHEMAS), registry=reg,
        now_ns=10**18, max_output_rows=10_000,
    ))
    ref = jax_compile_pxl(pxl, JaxCompilerState(
        schemas=dict(JAX_SCHEMAS), registry=jax_reg,
        now_ns=10**18, max_output_rows=10_000,
    ))
    assert _plan_shape(got.plan) == _plan_shape(ref.plan)
    assert got.outputs == ref.outputs


@pytest.mark.parametrize("name", list_scripts())
def test_executes_like_jax(name, engines):
    if name == AGENT_STATUS:
        _check_agent_status()
        return
    jax_eng, eng = engines
    pxl = load_script(name).pxl
    compiled = compile_pxl(pxl, CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, now_ns=0, max_output_rows=10_000,
    ))
    loose, ordered = _quantile_columns(compiled.plan)
    jax_set_flag("cpu_fold_threads", 1)
    try:
        ref = jax_eng.execute_query(pxl, max_output_rows=10_000)
    finally:
        jax_set_flag("cpu_fold_threads", 0)
    got = eng.execute_query(pxl, max_output_rows=10_000)
    assert sorted(got) == sorted(ref)
    assert sum(hb.length for hb in got.values()) > 0, name
    for out in got:
        check_library_output(f"{name}:{out}", got[out], ref[out], loose[out],
                             ordered)
