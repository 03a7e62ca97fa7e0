"""The port's wire codec (``pixie_tpu_torch/services/wire.py``) against
the JAX package's, byte for byte.

Every shipped script's plan (compiled by each package), seeded
relations, dictionaries and batches (with the ``eow``/``eos`` stream
markers) and the bus's control messages encode to the same bytes in
both packages; the port decodes the JAX package's bytes back to its own
types; an ``AggStatePayload`` shipped by a real CPU PEM fragment
round-trips exactly (and through the JAX decoder to the same bytes); a
``torch.Tensor`` anywhere in a message raises ``WireError``; and the
JAX file's corruption fuzz and recursion bomb hold for the port's
decoder.
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest
import torch

import pixie_tpu.services as jax_services
from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.ingest.schemas import CANONICAL_SCHEMAS as JAX_SCHEMAS
from pixie_tpu.services import wire as jax_wire
from pixie_tpu.services.vizier_funcs import (
    bind_service_registry as jax_bind_service_registry,
)
from pixie_tpu.types import batch as jax_batch
from pixie_tpu.types import dtypes as jax_dtypes
from pixie_tpu.types import relation as jax_relation
from pixie_tpu.types import strings as jax_strings
from pixie_tpu.udf.registry import default_registry as jax_registry

import pixie_tpu_torch.services as port_services
from pixie_tpu_torch import Engine
from pixie_tpu_torch.exec import plan as port_plan
from pixie_tpu_torch.exec.bridge import AggStatePayload, RowsPayload
from pixie_tpu_torch.ingest.schemas import CANONICAL_SCHEMAS
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.scripts import list_scripts, load_script
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.services.vizier_funcs import bind_service_registry
from pixie_tpu_torch.types import batch as port_batch
from pixie_tpu_torch.types import dtypes as port_dtypes
from pixie_tpu_torch.types import relation as port_relation
from pixie_tpu_torch.types import strings as port_strings
from pixie_tpu_torch.udf.registry import default_registry

AGENT_STATUS = "px/agent_status"
SEEDS = (0, 1, 2)

PORT = dict(plan=port_plan, batch=port_batch, dtypes=port_dtypes,
            relation=port_relation, strings=port_strings, wire=wire)
JAX = dict(plan=jax_plan, batch=jax_batch, dtypes=jax_dtypes,
           relation=jax_relation, strings=jax_strings, wire=jax_wire)


def test_type_tables_match_entry_for_entry():
    port_types, _ = wire._tables()
    jax_types, _ = jax_wire._tables()
    assert [t.__name__ for t in port_types] == [t.__name__ for t in jax_types]
    for p, j in zip(port_types, jax_types):
        if hasattr(p, "__dataclass_fields__"):
            assert list(p.__dataclass_fields__) == list(j.__dataclass_fields__), p
    assert wire.WIRE_VERSION == jax_wire.WIRE_VERSION == 4


def _registries(name):
    if name != AGENT_STATUS:
        return default_registry(), jax_registry()
    return (
        bind_service_registry(default_registry(), port_services.MessageBus(),
                              "wire"),
        jax_bind_service_registry(jax_registry(), jax_services.MessageBus(),
                                  "wire"),
    )


@pytest.mark.parametrize("name", list_scripts())
def test_script_plan_bytes_equal(name):
    """Each shipped script, compiled by both packages over the canonical
    schemas: the same bytes, and the port decodes the JAX bytes into its
    own plan types, which encode back to the same bytes."""
    reg, jreg = _registries(name)
    plan = compile_pxl(load_script(name).pxl, CompilerState(
        schemas=dict(CANONICAL_SCHEMAS), registry=reg, now_ns=0)).plan
    jplan = jax_compile_pxl(load_script(name).pxl, JaxCompilerState(
        schemas=dict(JAX_SCHEMAS), registry=jreg, now_ns=0)).plan
    buf = wire.encode(plan)
    jbuf = jax_wire.encode(jplan)
    assert buf == jbuf
    got = wire.decode(jbuf)
    assert isinstance(got, port_plan.Plan)
    assert all(type(n.op).__module__ == port_plan.__name__
               for n in got.nodes.values())
    assert got.topo_order() == plan.topo_order()
    assert wire.encode(got) == jbuf


def _seeded_values(pkg: dict, seed: int):
    """A relation of every logical type, a dictionary and a batch with
    the stream markers set, from one numpy seed, in ``pkg``'s types."""
    rng = np.random.default_rng(seed)
    DT = pkg["dtypes"].DataType
    n = int(rng.integers(5, 40))
    rel = pkg["relation"].Relation([
        ("time_", DT.TIME64NS), ("u", DT.UINT128), ("s", DT.STRING),
        ("v", DT.FLOAT64), ("i", DT.INT64), ("b", DT.BOOLEAN),
    ])
    words = [f"w{int(k)}" for k in rng.integers(0, 9, n)]
    sd = pkg["strings"].StringDictionary(sorted(set(words)))
    hb = pkg["batch"].HostBatch.from_pydict({
        "time_": np.sort(rng.integers(0, 1 << 40, n)),
        "u": rng.integers(0, 1 << 62, (n, 2)).astype(np.uint64),
        "s": words,
        "v": rng.standard_normal(n),
        "i": rng.integers(-(1 << 40), 1 << 40, n),
        "b": rng.integers(0, 2, n).astype(bool),
    }, relation=rel)
    hb.eow = bool(seed % 2)
    hb.eos = bool(seed % 3 == 0)
    return rel, sd, hb


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("what", ["relation", "dictionary", "batch"])
def test_seeded_values_bytes_equal(what, seed):
    k = ("relation", "dictionary", "batch").index(what)
    port = _seeded_values(PORT, seed)[k]
    jax = _seeded_values(JAX, seed)[k]
    buf = wire.encode(port)
    assert buf == jax_wire.encode(jax)
    got = wire.decode(buf)
    assert wire.encode(got) == buf
    if what == "batch":
        assert isinstance(got, port_batch.HostBatch)
        assert (got.eow, got.eos) == (port.eow, port.eos)
        assert got.to_pydict()["s"].tolist() == port.to_pydict()["s"].tolist()


def _control_messages(pkg: dict, seed: int) -> list:
    """The bus's control messages, shaped as the agents, tracker and
    broker publish them, in ``pkg``'s types."""
    rel, sd, hb = _seeded_values(pkg, seed)
    P = pkg["plan"]
    DT = pkg["dtypes"].DataType
    plan = P.Plan()
    src = plan.add(P.MemorySourceOp(table="http_events",
                                    columns=("service", "latency_ns")))
    agg = plan.add(P.AggOp(
        ("service",),
        (P.AggExpr("n", "count", (P.ColumnRef("latency_ns"),)),),
        max_groups=64), [src])
    plan.add(P.BridgeSinkOp(bridge_id=1), [agg])
    qid = f"q-{seed}"
    return [
        {"agent_id": "pem-0", "processes_data": True,
         "accepts_remote_sources": False, "schemas": {"http_events": rel},
         "table_stats": {"http_events": {"rows": 7, "ndv": {"s": 3}}}},
        {"agent_id": "pem-0", "asid": seed + 1},
        {"qid": qid, "plan": plan, "bridge_targets": {1: "kelvin-0"},
         "epoch": 0, "_reply_to": "_inbox.abc", "timeout_s": 30.0},
        {"qid": qid, "agent": "pem-0", "kind": "execute", "ok": True},
        {"qid": qid, "agent_id": "pem-0", "tables": {"output": hb},
         "stats": {"exec_time_s": 0.25, "rows": 2**40, "big": 2**100},
         "dicts": {"s": sd}, "dtype": DT.STRING, "none": None},
        {"qid": qid, "reason": "cancelled"},
        {"op": "deploy", "deployment": None, "name": "tp"},
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_control_messages_bytes_equal(seed):
    for msg, jmsg in zip(_control_messages(PORT, seed),
                         _control_messages(JAX, seed)):
        buf = wire.encode(msg)
        assert buf == jax_wire.encode(jmsg), sorted(msg)
        assert wire.encode(wire.decode(buf)) == buf


def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.fixture(scope="module")
def shipped_payloads():
    """The bridge messages a real CPU PEM fragment ships to the Kelvin
    for a service_stats-like query (t-digest, dense keys) and a row
    chain, captured off the bus."""
    s = port_services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker, got = [], None, []
    try:
        pem = s.PEMAgent(bus, "pem-0", heartbeat_interval_s=0.05,
                         engine=Engine(window_rows=1024, device="cpu"))
        agents.append(pem.start())
        agents.append(s.KelvinAgent(bus, "kelvin-0", heartbeat_interval_s=0.05,
                                    engine=Engine(device="cpu")).start())
        sub = bus.subscribe("agent.kelvin-0.bridge", got.append)
        rng = np.random.default_rng(5)
        n = 3000
        pem.append_data("http_events", {
            "time_": np.arange(n, dtype=np.int64),
            "latency_ns": rng.integers(1000, 10**8, n),
            "resp_status": rng.choice(np.array([200, 404, 500]), n),
            "service": [f"svc-{k}" for k in rng.integers(0, 5, n)],
        })
        pem._register()
        assert _wait_for(lambda: "http_events" in tracker.schemas())
        broker = s.QueryBroker(bus, tracker)
        broker.execute_script(
            "import px\ndf = px.DataFrame(table='http_events')\n"
            "df.lat = df.latency_ns / 1000000.0\n"
            "s = df.groupby('service').agg(n=('lat', px.count),"
            " q=('lat', px.quantiles), m=('lat', px.mean))\n"
            "px.display(s)\n")
        broker.execute_script(
            "import px\ndf = px.DataFrame(table='http_events')\n"
            "px.display(df[df.resp_status == 500].head(20))\n")
        assert _wait_for(lambda: len(got) >= 2)
        sub.unsubscribe()
    finally:
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()
    return got


def _leaves_equal(a, b) -> None:
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f")


@pytest.mark.parametrize("kind", ["agg_state", "rows"])
def test_shipped_payload_round_trips_exactly(shipped_payloads, kind):
    cls = AggStatePayload if kind == "agg_state" else RowsPayload
    payloads = [m["payload"] for m in shipped_payloads
                if isinstance(m.get("payload"), cls)]
    assert payloads, [sorted(m) for m in shipped_payloads]
    for msg in shipped_payloads:
        if not isinstance(msg.get("payload"), cls):
            continue
        buf = wire.encode(msg)
        back = wire.decode(buf)
        assert type(back["payload"]) is cls
        if cls is AggStatePayload:
            p, q = msg["payload"], back["payload"]
            assert q.chain == p.chain
            assert list(q.input_relation.items()) == list(p.input_relation.items())
            assert ({k: list(d.strings) for k, d in q.input_dicts.items()}
                    == {k: list(d.strings) for k, d in p.input_dicts.items()})
            assert (q.dense_domains, q.dense_offsets, q.dense_strides) == (
                p.dense_domains, p.dense_offsets, p.dense_strides)
            _leaves_equal(p.state, q.state)
        else:
            for c, planes in msg["payload"].batch.cols.items():
                _leaves_equal(planes, back["payload"].batch.cols[c])
        assert wire.encode(back) == buf
        # The JAX decoder reads the port's bytes into its own types,
        # which encode back to the same bytes.
        assert jax_wire.encode(jax_wire.decode(buf)) == buf


_TENSOR_CASES = {
    "bare": lambda t: t,
    "list": lambda t: [1, t],
    "dict_value": lambda t: {"a": {"b": t}},
    "tuple": lambda t: ("x", (t,)),
    "batch_plane": lambda t: port_batch.HostBatch(
        relation=port_relation.Relation([("v", port_dtypes.DataType.INT64)]),
        cols={"v": (t,)}, length=3),
    "agg_state_leaf": lambda t: AggStatePayload(
        chain=(), input_relation=port_relation.Relation([]), input_dicts={},
        state={"carries": {"n": t}}),
}


@pytest.mark.parametrize("case", sorted(_TENSOR_CASES))
def test_torch_tensor_anywhere_raises(case):
    msg = _TENSOR_CASES[case](torch.arange(3))
    with pytest.raises(wire.WireError, match="torch.Tensor"):
        wire.encode(msg)


def test_version_and_errors():
    buf = wire.encode({"x": 1})
    assert buf[0] == wire.WIRE_VERSION
    with pytest.raises(wire.WireError, match="version"):
        wire.decode(b"\x63" + buf[1:])
    with pytest.raises(wire.WireError):
        wire.decode(buf + b"junk")
    with pytest.raises(wire.WireError, match="not wire-registered"):
        wire.encode(object())
    with pytest.raises(wire.WireError, match="sets"):
        wire.encode({1, 2})
    with pytest.raises(wire.WireError):
        wire.decode(b"")


def _fuzz_message():
    hb = port_batch.HostBatch.from_pydict({
        "time_": np.arange(50, dtype=np.int64),
        "v": np.random.default_rng(0).standard_normal(50),
        "s": [f"x{i % 5}" for i in range(50)],
    })
    return {"op": "msg", "sid": 3,
            "msg": {"table": "t", "batch": hb, "seq": 7,
                    "nested": [1, 2.5, None, True, ("a", b"bytes")]}}


@pytest.mark.parametrize("seed", [7, 8, 9, 10])
def test_corruption_only_raises_wire_error(seed):
    """The transport contract (the JAX file's fuzz, 2000 trials split in
    four seeded cases): any corrupted frame decodes to WireError or a
    valid value, never another exception, and never a giant allocation
    from a corrupted length or shape."""
    buf = bytearray(wire.encode(_fuzz_message()))
    rng = random.Random(seed)
    for _trial in range(500):
        b = bytearray(buf)
        for _ in range(rng.randint(1, 4)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        try:
            wire.decode(bytes(b))
        except wire.WireError:
            pass


@pytest.mark.parametrize("depth", [3000, 20000])
def test_recursion_bomb_is_wire_error(depth):
    bomb = bytes([wire.WIRE_VERSION]) + b"U\x01\x00\x00\x00" * depth + b"N"
    with pytest.raises(wire.WireError, match="Recursion"):
        wire.decode(bomb)
