"""Agent-mode state shipping (``exec/bridge.py``) against the JAX
package's ``merge_agg_bridge``.

The same seeded rows are split across k data engines of each package;
the distributed planner splits the script; each data engine runs its
fragment (its ``BridgeSinkOp`` ships the partial state or the rows) and
a merge engine runs the merge fragment over the payloads
(``execute_plan(bridge_inputs=...)``). The port's merged answer is held
to the JAX package's over the same splits and to one port engine over
all the rows: keys, strings and integers exactly, FLOAT64 at rtol 1e-5,
t-digest quantiles at rtol 0.05. The cases: dense and non-dense keys,
string keys whose per-agent dictionaries were built in different
orders, UINT128 keys, t-digest quantiles, ``count_distinct``, a merge
that overflows ``max_groups``, the string-carry refusal, an agent with
no rows, a row-gather bridge, and the payload's one-copy round trip.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.stream import QueryError as JaxQueryError
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.planner.distributed import DistributedPlanner as JaxPlanner
from pixie_tpu.planner.distributed import DistributedState as JaxState
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.strings import StringDictionary as JaxDictionary
from pixie_tpu_torch.exec.bridge import (
    AggStatePayload,
    RowsPayload,
    payload_nbytes,
    state_to_device,
    state_to_host,
)
from pixie_tpu_torch.exec.engine import Engine, QueryError
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.planner.distributed import DistributedPlanner, DistributedState
from pixie_tpu_torch.types import host_batch_from_numpy

W = 1 << 10
SEED = 11
T = "events"
RELATION = [
    ("time_", "TIME64NS"), ("service", "STRING"), ("key", "INT64"),
    ("upid", "UINT128"), ("lat", "FLOAT64"), ("v", "INT64"),
    ("status", "INT64"),
]


def _shard(rng, i, n, keys=None):
    """One agent's rows: services in an agent-specific first-seen order
    (so the string dictionaries differ per agent), INT64 keys far apart
    (no dense domain), UINT128 upids with the top bit set on some."""
    svc = [f"svc-{(i + j) % 5}" for j in range(n)]
    if keys is None:
        keys = rng.integers(0, 40, n) * (1 << 34) + 7
    hi = rng.integers(0, 30, n).astype(np.uint64) << np.uint64(32)
    hi[::7] |= np.uint64(1 << 63)
    lo = rng.integers(0, 3, n).astype(np.uint64)
    return {
        "time_": (np.arange(n, dtype=np.int64) + 10_000 * i,),
        "service": svc,
        "key": (np.asarray(keys, dtype=np.int64),),
        "upid": (hi, lo),
        "lat": (rng.gamma(2.0, 1e5, n),),
        "v": (rng.integers(0, 1000, n),),
        "status": (rng.choice(np.array([200, 200, 404, 500]), n),),
    }


def _shards(n_agents=3, rows=(2500, 1800, 3100), seed=SEED):
    rng = np.random.default_rng(seed)
    return [_shard(rng, i, rows[i]) for i in range(n_agents)]


def _port_batch(cols):
    svc = cols["service"]
    strings = list(dict.fromkeys(svc))
    ids = {s: k for k, s in enumerate(strings)}
    planes = {c: p for c, p in cols.items() if c != "service"}
    planes["service"] = (np.asarray([ids[s] for s in svc], np.int32),)
    return host_batch_from_numpy(RELATION, planes, {"service": strings})


def _jax_batch(cols):
    rel = JaxRelation([(n, JaxDataType[t]) for n, t in RELATION])
    d = JaxDictionary()
    ids = np.asarray([d.get_or_add(s) for s in cols["service"]], np.int32)
    planes = {c: tuple(p) for c, p in cols.items() if c != "service"}
    planes["service"] = (ids,)
    return JaxHostBatch(relation=rel, cols=planes, length=len(ids),
                        dicts={"service": d})


def _engines(pkg, shards):
    """(data engines, merge engine) of one package, each data engine
    holding its shard (an empty shard: the table with no rows)."""
    new = (lambda: Engine(window_rows=W, device="cpu")) if pkg == "port" \
        else (lambda: JaxEngine(window_rows=W))
    batch = _port_batch if pkg == "port" else _jax_batch
    data = []
    for cols in shards:
        e = new()
        if len(cols["v"][0]):
            e.append_data(T, batch(cols))
        else:
            e.create_table(T, batch(_shard(np.random.default_rng(0), 0, 1)).relation)
        data.append(e)
    return data, new()


def _distributed_run(pkg, query, shards):
    """The merged answer and the payloads, through the package's
    splitter, data fragments and merge fragment."""
    data, merge = _engines(pkg, shards)
    if pkg == "port":
        state_cls, planner_cls = CompilerState, DistributedPlanner
        dstate, compile_ = DistributedState, compile_pxl
    else:
        state_cls, planner_cls = JaxCompilerState, JaxPlanner
        dstate, compile_ = JaxState, jax_compile_pxl
    schemas = {T: data[0].tables[T].relation}
    compiled = compile_(query, state_cls(
        schemas=schemas, registry=data[0].registry, max_output_rows=1 << 20,
    ))
    dplan = planner_cls(data[0].registry).plan(
        compiled.plan, dstate.homogeneous(len(data))
    )
    by_bridge: dict = {}
    for e in data:
        out = e.execute_plan(dplan.split.before_blocking)
        for k, payload in out.items():
            assert isinstance(k, tuple) and k[0] == "bridge"
            by_bridge.setdefault(k[1], []).append(payload)
    merged = merge.execute_plan(dplan.merge_plan, bridge_inputs=by_bridge)
    return merged["out"], by_bridge, merge


def _single_run(query, shards):
    e = Engine(window_rows=W, device="cpu")
    for cols in shards:
        if len(cols["v"][0]):
            e.append_data(T, _port_batch(cols))
    return e.execute_query(query, max_output_rows=1 << 20)["out"]


def _by_key(batch, keys):
    d = {k: np.asarray(v) for k, v in batch.to_pydict().items()}
    kcols = [d[k] if d[k].ndim == 1 else [tuple(r) for r in d[k]] for k in keys]
    order = sorted(range(len(kcols[0])),
                   key=lambda r: tuple(str(kc[r]) for kc in kcols))
    return {c: (v[order] if v.ndim == 1 else v[order]) for c, v in d.items()}


def _hold(got, ref, keys, exact=(), close=(), quant=()):
    a, b = _by_key(got, keys), _by_key(ref, keys)
    assert len(a[keys[0]]) == len(b[keys[0]])
    for c in tuple(keys) + tuple(exact):
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)
    for c in close:
        np.testing.assert_allclose(a[c], b[c], rtol=1e-5, err_msg=c)
    for c in quant:
        qa = [json.loads(s) for s in a[c]]
        qb = [json.loads(s) for s in b[c]]
        for f in ("p50", "p90", "p99"):
            np.testing.assert_allclose(
                [q[f] for q in qa], [q[f] for q in qb], rtol=0.05, err_msg=c
            )


def _script(body):
    return f"import px\ndf = px.DataFrame(table='{T}')\n{body}\npx.display(df, 'out')\n"


CASES = {
    # name: (script body, keys, exact, close, quant)
    "dense_string_keys": (
        "df = df.groupby('service').agg(n=('v', px.count), s=('v', px.sum),\n"
        "    avg=('lat', px.mean), hi=('lat', px.max))",
        ("service",), ("n", "s"), ("avg", "hi"), (),
    ),
    "dense_two_keys": (
        "df = df.groupby(['service', 'status']).agg(n=('v', px.count))",
        ("service", "status"), ("n",), (), (),
    ),
    "non_dense_int_keys": (
        "df = df.groupby('key').agg(n=('v', px.count), s=('v', px.sum))",
        ("key",), ("n", "s"), (), (),
    ),
    "uint128_keys": (
        "df = df.groupby('upid').agg(n=('v', px.count), s=('v', px.sum))",
        ("upid",), ("n", "s"), (), (),
    ),
    "tdigest_quantiles": (
        "df = df.groupby('service').agg(p=('lat', px.quantiles))",
        ("service",), (), (), ("p",),
    ),
    "count_distinct": (
        "df = df.groupby('service').agg(d=('key', px.count_distinct))",
        ("service",), ("d",), (), (),
    ),
    "whole_table": (
        "df = df.agg(n=('v', px.count), avg=('lat', px.mean))",
        ("n",), ("n",), ("avg",), (),
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_matches_jax_and_one_engine(case):
    body, keys, exact, close, quant = CASES[case]
    query = _script(body)
    shards = _shards()
    got, payloads, merge = _distributed_run("port", query, shards)
    ref, jax_payloads, _ = _distributed_run("jax", query, shards)
    assert sorted(payloads) == sorted(jax_payloads)
    assert all(isinstance(p, AggStatePayload)
               for ps in payloads.values() for p in ps)
    _hold(got, ref, keys, exact, close, quant)
    _hold(got, _single_run(query, shards), keys, exact, close, quant)
    assert merge.last_stats.fragments  # the merge ran as a traced fragment


def test_string_dictionaries_built_in_different_orders():
    shards = _shards()
    firsts = [list(dict.fromkeys(s["service"]))[:2] for s in shards]
    assert firsts[0] != firsts[1] != firsts[2]
    got, payloads, _ = _distributed_run(
        "port", _script(CASES["dense_string_keys"][0]), shards
    )
    orders = [list(p.input_dicts["service"].strings) for p in payloads[
        next(iter(payloads))]]
    assert orders[0] != orders[1]
    # One canonical dictionary: each service once, every count right.
    d = got.to_pydict()
    assert sorted(d["service"]) == [f"svc-{i}" for i in range(5)]
    assert int(np.sum(d["n"])) == sum(len(s["v"][0]) for s in shards)


def test_agent_with_no_rows():
    shards = _shards()
    empty = _shard(np.random.default_rng(1), 1, 0)
    shards = [shards[0], empty, shards[2]]
    query = _script(CASES["dense_string_keys"][0])
    got, payloads, _ = _distributed_run("port", query, shards)
    ref, _, _ = _distributed_run("jax", query, shards)
    assert len(next(iter(payloads.values()))) == 3
    _hold(got, ref, ("service",), ("n", "s"), ("avg", "hi"))
    _hold(got, _single_run(query, shards), ("service",), ("n", "s"),
          ("avg", "hi"))


def test_merge_overflow_doubles_max_groups():
    # Each agent's 3000 keys fit its 4096 groups; their union does not.
    rng = np.random.default_rng(SEED)
    shards = [
        _shard(rng, i, 3000, keys=(np.arange(3000) + 3000 * i) * (1 << 20))
        for i in range(2)
    ]
    query = _script(CASES["non_dense_int_keys"][0])
    got, payloads, merge = _distributed_run("port", query, shards)
    ref, _, _ = _distributed_run("jax", query, shards)
    assert all(len(p.state["valid"]) == 4096
               for ps in payloads.values() for p in ps)
    assert merge.last_stats.rebuckets == 1
    assert got.length == 6000
    _hold(got, ref, ("key",), ("n", "s"))
    _hold(got, _single_run(query, shards), ("key",), ("n", "s"))


def test_merge_overflow_past_the_cap_is_refused():
    from pixie_tpu_torch.config import override_flag

    rng = np.random.default_rng(SEED)
    shards = [
        _shard(rng, i, 3000, keys=(np.arange(3000) + 3000 * i) * (1 << 20))
        for i in range(2)
    ]
    with override_flag("max_groups_limit", 4096):
        with pytest.raises(QueryError, match="rebucketing past the 4096 cap"):
            _distributed_run("port", _script(CASES["non_dense_int_keys"][0]),
                             shards)


def test_string_carry_refused_like_jax():
    query = _script("df = df.groupby('status').agg(s=('service', px.any))")
    shards = _shards()
    with pytest.raises(JaxQueryError) as jax_err:
        _distributed_run("jax", query, shards)
    with pytest.raises(QueryError) as err:
        _distributed_run("port", query, shards)
    assert str(err.value) == str(jax_err.value)
    assert "carries string ids of column 'service'" in str(err.value)


def test_row_gather_bridge_matches_jax():
    query = _script("df = df[df.status == 500]\ndf = df['time_', 'service', 'v']")
    shards = _shards()
    got, payloads, _ = _distributed_run("port", query, shards)
    ref, _, _ = _distributed_run("jax", query, shards)
    assert all(isinstance(p, RowsPayload)
               for ps in payloads.values() for p in ps)
    _hold(got, ref, ("time_",), ("service", "v"))
    _hold(got, _single_run(query, shards), ("time_",), ("service", "v"))


def test_state_round_trip_is_one_copy_each_way():
    state = {
        "keys": (torch.arange(5, dtype=torch.int32),
                 torch.tensor([1, 2, 3, 4, 2 ** 63 + 5], dtype=torch.uint64)),
        "valid": torch.tensor([True, False, True, True, False]),
        "carries": {"m": (torch.ones(5, dtype=torch.float64),
                          torch.arange(5, dtype=torch.int64)),
                    "q": torch.rand(5, 3, dtype=torch.float32)},
        "overflow": torch.tensor(False),
    }
    host = state_to_host(state)
    assert host["keys"][1].dtype == np.uint64
    assert int(host["keys"][1][4]) == 2 ** 63 + 5
    # One buffer underneath every leaf.
    bases = {id(a.base if a.base is not None else a)
             for a in [*host["keys"], host["valid"], *host["carries"]["m"],
                       host["carries"]["q"], host["overflow"]]}
    assert len(bases) == 1
    back = state_to_device(host, torch.device("cpu"))
    for a, b in zip(torch.utils._pytree.tree_leaves(state),
                    torch.utils._pytree.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.uint64 else a,
                           b.view(torch.int64) if b.dtype == torch.uint64 else b)
    p = AggStatePayload(chain=(), input_relation=None, input_dicts={},
                        state=host)
    assert payload_nbytes(p) == 5 * 4 + 5 * 8 + 5 + 5 * 8 * 2 + 5 * 3 * 4 + 1


def test_wire_bytes_are_the_payload_bytes():
    query = _script(CASES["dense_string_keys"][0])
    shards = _shards()
    data, _ = _engines("port", shards)
    compiled = compile_pxl(query, CompilerState(
        schemas={T: data[0].tables[T].relation}, registry=data[0].registry,
    ))
    dplan = DistributedPlanner(data[0].registry).plan(
        compiled.plan, DistributedState.homogeneous(3)
    )
    for e in data:
        out = e.execute_plan(dplan.split.before_blocking)
        (payload,) = out.values()
        trace = e.tracer.last()
        assert trace.usage.wire_bytes == payload_nbytes(payload) > 0
        assert trace.usage.rows_in == e.tables[T].num_rows
