"""The port's mesh executor (``pixie_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

Every case of ``tests/test_parallel.py`` runs on the JAX
``DistributedEngine`` over ``agent_mesh(8)`` (the 8 virtual CPU devices
of ``tests/conftest.py``) and on the port's over ``agent_mesh(8,
devices=[cpu] * 8)`` (8 virtual PEMs on the CPU), with the same seeded
numpy data (``_http_events``). Each case holds the port's mesh answer
to the JAX mesh's and to the port's single engine, at
``test_parallel.py``'s tolerances: keys and counts exact, INT64
aggregates rtol 1e-9, the p50 sketch rtol 0.1. Added here: a FLOAT64
mean/max group-by and ``px/service_stats`` over the mesh (the plain
forms of the ``dense_fold`` and ``hist_fold`` kernels; FLOAT64 sums
fold in f32 there, so rtol 1e-5, and quantiles rtol 0.05), a degraded
3-slot mesh with uneven shards, resident windows read as views by
every shard, ``agent_mesh`` refusing too few devices, and one case that
runs the mesh on the card when one is present.
"""

import collections

import numpy as np
import pytest
import torch

from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.parallel import DistributedEngine as JaxDistributedEngine
from pixie_tpu.parallel import agent_mesh as jax_agent_mesh
from pixie_tpu.planner.distributed import distributed_state as jax_dstate
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu_torch import Engine
from pixie_tpu_torch.exec import plan
from pixie_tpu_torch.parallel import DistributedEngine, agent_mesh
from pixie_tpu_torch.parallel import executor, mesh as mesh_mod
from pixie_tpu_torch.planner.distributed import distributed_state as dstate
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.types.dtypes import DataType

from test_torch_planner import HTTP_STATS_F64

CPU = torch.device("cpu")
W = 4096
PKGS = {
    "jax": (jax_plan, JaxDataType),
    "port": (plan, DataType),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _http_events(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64).astype("datetime64[ns]"),
        "latency_ns": rng.integers(1000, 10_000_000, n),
        "resp_status": rng.choice([200, 200, 200, 404, 500], n),
        "service": rng.choice(["cart", "checkout", "frontend", "db"], n),
        "req_path": rng.choice(["/a", "/b", "/c"], n),
    }


def _cpu_mesh(n_agents=8, n_kelvin=1, slots=8):
    return agent_mesh(n_agents, n_kelvin, devices=[CPU] * slots)


def _http_stats_plan(pkg, table="http_events"):
    """filter(status>=200) -> groupby(service).agg(count, mean, max)."""
    P, DT = PKGS[pkg]
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table=table))
    flt = p.add(
        P.FilterOp(predicate=P.FuncCall(
            "greaterThanEqual",
            (P.ColumnRef("resp_status"), P.Literal(200, DT.INT64)),
        )),
        [src],
    )
    agg = p.add(
        P.AggOp(
            group_cols=("service",),
            aggs=(
                P.AggExpr("n", "count", (P.ColumnRef("latency_ns"),)),
                P.AggExpr("lat_mean", "mean", (P.ColumnRef("latency_ns"),)),
                P.AggExpr("lat_max", "max", (P.ColumnRef("latency_ns"),)),
            ),
        ),
        [flt],
    )
    p.add(P.ResultSinkOp("out"), [agg])
    return p


def _sorted_rows(hb, key="service"):
    d = hb.to_pydict()
    order = np.argsort(np.asarray(d[key]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_rows_close(r1, r2, rtol=1e-9, approx=()):
    assert list(r1) == list(r2)
    for k in r1:
        if r1[k].dtype.kind in "OUS":
            assert r1[k].tolist() == r2[k].tolist(), k
        else:
            np.testing.assert_allclose(
                r1[k], r2[k], rtol=approx[k] if k in approx else rtol,
                err_msg=k,
            )


def _three_way(engines, run, key="service", rtol=1e-9, approx=None):
    """The port's mesh answer against the JAX mesh's and the port's single
    engine's. ``run(engine, pkg)`` returns a HostBatch."""
    got = _sorted_rows(run(engines["port"], "port"), key)
    _assert_rows_close(_sorted_rows(run(engines["jax"], "jax"), key), got,
                       rtol, approx or {})
    _assert_rows_close(_sorted_rows(run(engines["single"], "port"), key),
                       got, rtol, approx or {})
    return got


@pytest.fixture(scope="module")
def engines():
    """The JAX mesh engine, the port's mesh engine and the port's single
    engine, each holding the same 10,000 rows."""
    out = {
        "jax": JaxDistributedEngine(window_rows=W, mesh=jax_agent_mesh(8)),
        "port": DistributedEngine(window_rows=W, mesh=_cpu_mesh()),
        "single": Engine(window_rows=W, device="cpu"),
    }
    data = _http_events(10_000)
    for e in out.values():
        e.append_data("http_events", data)
    return out


def _plan_run(make_plan):
    def run(eng, pkg):
        return eng.execute_plan(make_plan(pkg))["out"]
    return run


def _query_run(query):
    def run(eng, pkg):
        return eng.execute_query(query)["output"]
    return run


def test_distributed_agg_matches_single_chip(engines):
    _three_way(engines, _plan_run(_http_stats_plan))


def test_distributed_agg_2d_mesh(engines):
    two_d = {
        "jax": JaxDistributedEngine(window_rows=W,
                                    mesh=jax_agent_mesh(4, n_kelvin=2)),
        "port": DistributedEngine(window_rows=W,
                                  mesh=_cpu_mesh(4, n_kelvin=2)),
        "single": engines["single"],
    }
    assert two_d["port"].mesh.devices.shape == (2, 4)
    for k in ("jax", "port"):
        two_d[k].append_data("http_events", _http_events(10_000))
    _three_way(two_d, _plan_run(_http_stats_plan))


def _rows_plan(pkg):
    P, DT = PKGS[pkg]
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="http_events"))
    flt = p.add(
        P.FilterOp(predicate=P.FuncCall(
            "equal", (P.ColumnRef("resp_status"), P.Literal(500, DT.INT64))
        )),
        [src],
    )
    m = p.add(
        P.MapOp(exprs=(
            ("service", P.ColumnRef("service")),
            ("lat_ms", P.FuncCall(
                "divide",
                (P.ColumnRef("latency_ns"), P.Literal(1e6, DT.FLOAT64)),
            )),
        )),
        [flt],
    )
    p.add(P.ResultSinkOp("out"), [m])
    return p


def test_distributed_rows_fragment(engines):
    """Row chains come out in the single engine's row order: the shards'
    rows concatenate in shard order. Equal to the port's single engine;
    the FLOAT64 quotient within one f32 ulp of the JAX engine's."""
    got = {k: e.execute_plan(_rows_plan("jax" if k == "jax" else "port"))
           ["out"].to_pydict() for k, e in engines.items()}
    assert len(got["port"]["service"]) > 0
    for ref in ("jax", "single"):
        assert got[ref]["service"].tolist() == got["port"]["service"].tolist()
    np.testing.assert_array_equal(got["single"]["lat_ms"],
                                  got["port"]["lat_ms"])
    # The quotients are f32 on both devices, and XLA:CPU divides by the
    # reciprocal: within one f32 ulp of the JAX engine's.
    np.testing.assert_array_max_ulp(
        got["jax"]["lat_ms"].astype(np.float32),
        got["port"]["lat_ms"].astype(np.float32), maxulp=1)


def _p50_plan(pkg):
    P, _DT = PKGS[pkg]
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="http_events"))
    agg = p.add(
        P.AggOp(group_cols=("service",), aggs=(
            P.AggExpr("lat_p50", "_quantile_p50", (P.ColumnRef("latency_ns"),)),
        )),
        [src],
    )
    p.add(P.ResultSinkOp("out"), [agg])
    return p


def test_distributed_quantiles_sketch(engines):
    """t-digest partial states merge across the slots (approximately:
    the merge order differs from one window's)."""
    _three_way(engines, _plan_run(_p50_plan), rtol=0.1)


def _join_limit_plan(pkg):
    P, _DT = PKGS[pkg]
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="http_events"))
    agg1 = p.add(
        P.AggOp(group_cols=("service", "req_path"),
                aggs=(P.AggExpr("n", "count", (P.ColumnRef("latency_ns"),)),)),
        [src],
    )
    src2 = p.add(P.MemorySourceOp(table="http_events"))
    agg2 = p.add(
        P.AggOp(group_cols=("service",),
                aggs=(P.AggExpr("total", "count",
                                (P.ColumnRef("latency_ns"),)),)),
        [src2],
    )
    j = p.add(P.JoinOp(left_on=("service",), right_on=("service",)),
              [agg1, agg2])
    lim = p.add(P.LimitOp(5), [j])
    p.add(P.ResultSinkOp("out"), [lim])
    return p


def test_distributed_join_and_limit(engines):
    out = {k: e.execute_plan(_join_limit_plan("jax" if k == "jax" else "port"))
           ["out"] for k, e in engines.items()}
    assert out["jax"].length == out["port"].length == out["single"].length == 5
    d = {k: v.to_pydict() for k, v in out.items()}
    assert set(d["jax"]) == set(d["port"]) == set(d["single"])
    # Each joined row carries its service's full count.
    totals = collections.Counter(_http_events(10_000)["service"].tolist())
    for s, t in zip(d["port"]["service"], d["port"]["total"]):
        assert int(t) == totals[s]


def test_mesh_uses_all_devices():
    jm, pm = jax_agent_mesh(8), _cpu_mesh()
    assert pm.devices.size == jm.devices.size == 8
    assert pm.axis_names == tuple(jm.axis_names) == ("kelvin", "agents")
    assert pm.devices.shape == jm.devices.shape == (1, 8)
    assert list(pm.devices.flatten()) == [CPU] * 8


FUSED_JOIN = """
import px
l = px.DataFrame(table='http_events')
r = px.DataFrame(table='http_events')
ra = r.groupby('service').agg(total=('latency_ns', px.count))
g = l.merge(ra, how='inner', left_on=['service'], right_on=['service'],
            suffixes=['', '_r'])
out = g.groupby('req_path').agg(n=('total', px.count),
                                s=('total', px.sum))
px.display(out)
"""


PRE_GROUPED = """
import px
r = px.DataFrame(table='R')
ra = r.groupby('k').agg(cnt=('v', px.count))
l = px.DataFrame(table='L')
g = l.merge(ra, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('cnt', px.sum))
px.display(out)
"""


def test_distributed_fused_lookup_join(engines):
    """The JAX case's join of an aggregate on ``service`` (the port routes
    its small unique-key build through the host dict), then an N:1 join
    on an INT64 key that fuses into the probe stream: every slot reads
    the side tables put on the device once per query."""
    _three_way(engines, _query_run(FUSED_JOIN), key="req_path")
    rng = np.random.default_rng(5)
    n, n_keys = 3 * W + 100, 500
    left = {"time_": np.arange(n, dtype=np.int64),
            "k": rng.integers(0, n_keys, n), "b": rng.integers(0, 8, n)}
    right = {"time_": np.arange(n, dtype=np.int64),
             "k": rng.integers(0, n_keys, n), "v": rng.integers(0, 99, n)}
    fused = {
        "jax": JaxDistributedEngine(window_rows=W, mesh=jax_agent_mesh(8)),
        "port": DistributedEngine(window_rows=W, mesh=_cpu_mesh()),
        "single": Engine(window_rows=W, device="cpu"),
    }
    for e in fused.values():
        e.append_data("L", left)
        e.append_data("R", right)
    got = _three_way(fused, _query_run(PRE_GROUPED), key="b")
    assert fused["port"].last_join_decision.strategy == "fused"
    cnt = collections.Counter(right["k"].tolist())
    want = collections.Counter()
    for k, b in zip(left["k"].tolist(), left["b"].tolist()):
        want[b] += cnt.get(k, 0)
    assert dict(zip(got["b"].tolist(), got["n"].tolist())) == {
        b: v for b, v in want.items() if v}


UNION = """
import px
a = px.DataFrame(table='http_events')
b = px.DataFrame(table='http_events_b')
u = a.append(b)
out = u.groupby('service').agg(n=('latency_ns', px.count),
                               mx=('latency_ns', px.max))
px.display(out)
"""


def test_distributed_union(engines):
    for e in engines.values():
        if "http_events_b" not in e.tables:
            e.append_data("http_events_b", _http_events(4_000, seed=7))
    _three_way(engines, _query_run(UNION))


COUNT_BY_SERVICE = (
    "import px\ndf = px.DataFrame(table='http_events')\n"
    "s = df.groupby('service').agg(n=('latency_ns', px.count))\n"
    "px.display(s)"
)


def test_mesh_resident_windows():
    """Resident windows on the base mesh: the query reads every window
    from the device cache (none staged), and each shard a slot folds is a
    view of the resident plane, sharing its storage. (The JAX engine's
    ``stage_sharding`` asserts have no counterpart: windows are staged
    as for a single engine.)"""
    n = 3 * W  # whole windows: no partial tail to stage on demand
    data = _http_events(n)
    dist = DistributedEngine(window_rows=W, mesh=_cpu_mesh())
    jdist = JaxDistributedEngine(window_rows=W, mesh=jax_agent_mesh(8))
    for e in (dist, jdist):
        e.append_data("http_events", data)
    assert dist.device_residency is True
    t = dist.tables["http_events"]
    resident = [win for win, _lo, _hi in t.device_scan(window_rows=W)]
    assert len(resident) == 3
    storages = {win.cols["latency_ns"][0].untyped_storage().data_ptr()
                for win in resident}
    seen = []
    real = mesh_mod.row_shards

    def spy(plane, m):
        parts = real(plane, m)
        seen.append((plane, parts))
        return parts

    orig = executor.row_shards
    executor.row_shards = spy
    try:
        out = dist.execute_query(COUNT_BY_SERVICE)["output"].to_pydict()
    finally:
        executor.row_shards = orig
    st = dist.last_stats
    assert (st.resident_windows, st.staged_windows, st.windows) == (3, 0, 3)
    want = dict(collections.Counter(data["service"].tolist()))
    assert dict(zip(out["service"], out["n"].tolist())) == want
    jout = jdist.execute_query(COUNT_BY_SERVICE)["output"].to_pydict()
    assert dict(zip(jout["service"], jout["n"].tolist())) == want
    lat = [(p, parts) for p, parts in seen
           if p.untyped_storage().data_ptr() in storages]
    assert len(lat) == 3  # the latency plane of each window
    for plane, parts in lat:
        assert len(parts) == 8
        assert sum(x.shape[0] for x in parts) == plane.shape[0]
        for x in parts:
            assert x._base is plane or x._is_view()
            assert (x.untyped_storage().data_ptr()
                    == plane.untyped_storage().data_ptr())


def _state(pkg, n_pems):
    mod = jax_dstate if pkg == "jax" else dstate
    return mod.DistributedState(agents=[
        mod.AgentInfo(agent_id=f"pem-{i}", processes_data=True,
                      tables=frozenset({"http_events"}))
        for i in range(n_pems)
    ] + [mod.AgentInfo(agent_id="kelvin-0", processes_data=False,
                       accepts_remote_sources=True)])


def _degraded(n_pems=3):
    """Mesh engines of 8 slots whose distributed state has ``n_pems``
    live data agents: each query runs on a degraded (1, n_pems) mesh."""
    data = _http_events(10_000)
    out = {
        "jax": JaxDistributedEngine(window_rows=W, mesh=jax_agent_mesh(8),
                                    distributed_state=_state("jax", n_pems)),
        "port": DistributedEngine(window_rows=W, mesh=_cpu_mesh(),
                                  distributed_state=_state("port", n_pems)),
    }
    for e in out.values():
        e.append_data("http_events", data)
    return out


def test_degraded_mesh_agent_loss_mid_stream(engines):
    """Agent loss: a query replanned onto a sub-mesh of 3 slots (the
    coordinator kept 3 live data agents) still answers correctly; its
    windows are staged per query, as in the JAX engine."""
    deg = _degraded(3)
    deg["single"] = engines["single"]
    _three_way(deg, _plan_run(_http_stats_plan))
    port = deg["port"]
    assert port.last_distributed_plan is not None
    assert deg["jax"].last_distributed_plan is not None
    assert (port.last_distributed_plan.n_data_shards
            == deg["jax"].last_distributed_plan.n_data_shards == 3)
    st = port.last_stats
    assert st.resident_windows == 0 and st.staged_windows == st.windows == 3
    # Outside a query the engine is back on its base mesh.
    assert port.mesh.devices.size == 8 and port.device_residency


def test_degraded_mesh_uneven_shards_float64(engines):
    """A degraded 3-slot mesh cuts each 4096-row window into uneven
    shards (1366, 1365, 1365 rows): the FLOAT64 group-by (the
    ``dense_fold`` route) equals numpy and the JAX mesh's answer."""
    deg = _degraded(3)
    seen = []
    real = mesh_mod.row_shards

    def spy(plane, m):
        parts = real(plane, m)
        seen.append([x.shape[0] for x in parts])
        return parts

    orig = executor.row_shards
    executor.row_shards = spy
    try:
        got = _by_keys(deg["port"].execute_query(HTTP_STATS_F64)["output"])
    finally:
        executor.row_shards = orig
    assert [1366, 1365, 1365] in seen
    ref = _by_keys(deg["jax"].execute_query(HTTP_STATS_F64)["output"])
    _assert_f64(ref, got)
    _assert_f64(_numpy_http_stats_f64(_http_events(10_000)), got)
    assert deg["port"].last_stats.staged_windows == 3


def _by_keys(hb, keys=("service", "req_path")):
    d = hb.to_pydict()
    order = np.lexsort([np.asarray(d[k]).astype(str) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_f64(ref, got):
    """Keys and counts exact, the FLOAT64 mean and max rtol 1e-5 (the
    dense route sums in f32)."""
    assert list(ref) == list(got)
    for k in ref:
        if ref[k].dtype.kind in "OUS":
            assert ref[k].tolist() == got[k].tolist(), k
        elif k == "n":
            np.testing.assert_array_equal(ref[k], got[k])
        else:
            np.testing.assert_allclose(ref[k], got[k], rtol=1e-5, err_msg=k)


def _numpy_http_stats_f64(data):
    keep = data["resp_status"] < 400
    ms = data["latency_ns"][keep] / 1e6
    svc, path = data["service"][keep], data["req_path"][keep]
    groups: dict = {}
    for s, p, v in zip(svc, path, ms):
        groups.setdefault((s, p), []).append(v)
    keys = sorted(groups)
    return {
        "service": np.array([k[0] for k in keys], dtype=object),
        "req_path": np.array([k[1] for k in keys], dtype=object),
        "n": np.array([len(groups[k]) for k in keys]),
        "lat_mean": np.array([np.mean(groups[k]) for k in keys]),
        "lat_max": np.array([np.max(groups[k]) for k in keys]),
    }


def test_float64_group_by_over_the_mesh(engines):
    """``HTTP_STATS_F64`` (FLOAT64 count/mean/max, the ``dense_fold``
    route) over 8 slots: equal to the JAX mesh, the port's single engine
    and numpy."""
    port = engines["port"]
    assert port._compile_steps  # the mesh seam
    got = _by_keys(port.execute_query(HTTP_STATS_F64)["output"])
    _assert_f64(_by_keys(engines["jax"].execute_query(HTTP_STATS_F64)
                         ["output"]), got)
    _assert_f64(_by_keys(engines["single"].execute_query(HTTP_STATS_F64)
                         ["output"]), got)
    _assert_f64(_numpy_http_stats_f64(_http_events(10_000)), got)


def test_service_stats_over_the_mesh(engines):
    """``px/service_stats`` (t-digest quantiles, the ``hist_fold``
    route) over 8 slots: throughput exact, error rate rtol 1e-9,
    quantiles rtol 0.05 against the JAX mesh and the single engine."""
    q = load_script("px/service_stats").pxl
    _three_way(engines, _query_run(q),
               approx={"p50": 0.05, "p99": 0.05})
    out = _sorted_rows(engines["port"].execute_query(q)["output"])
    data = _http_events(10_000)
    for s, n, p50 in zip(out["service"], out["throughput"], out["p50"]):
        lat = data["latency_ns"][data["service"] == s]
        assert int(n) == len(lat)
        np.testing.assert_allclose(p50, np.quantile(lat, 0.5), rtol=0.05)


@pytest.mark.parametrize("n_agents,n_kelvin", [(8, 1), (4, 2), (3, 1)])
def test_n_devices_matches_jax(n_agents, n_kelvin):
    """``DistributedEngine.n_devices`` counts the mesh's slots, as the
    JAX engine's does."""
    slots = n_agents * n_kelvin
    jax_eng = JaxDistributedEngine(
        window_rows=W, mesh=jax_agent_mesh(n_agents, n_kelvin))
    eng = DistributedEngine(
        window_rows=W, mesh=_cpu_mesh(n_agents, n_kelvin, slots))
    assert eng.n_devices == jax_eng.n_devices == slots


def test_agent_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError) as jerr:
        jax_agent_mesh(16)
    with pytest.raises(ValueError) as perr:
        agent_mesh(16, devices=[CPU] * 8)
    assert str(perr.value) == str(jerr.value) == (
        "mesh 16x1 needs 16 devices, have 8")
    with pytest.raises(ValueError, match="mesh 4x3 needs 12 devices, have 8"):
        agent_mesh(4, 3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 1 devices, have 8"):
        agent_mesh(0, devices=[CPU] * 8)


def test_agent_mesh_without_devices_needs_a_card(monkeypatch):
    """The default mesh is every visible CUDA card; with none it raises
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agent_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedEngine(window_rows=W)


def test_bridge_merge_realistic_group_counts():
    """The bridge path at realistic cardinality: three agents ship
    partial-agg states with ~50K string groups and divergent
    dictionaries through the wire codec; the Kelvin merge realigns the
    ids. Both packages give the exact counts."""
    import pixie_tpu.services.wire as jax_wire
    import pixie_tpu_torch.services.wire as port_wire

    n_per_agent, n_keys = 200_000, 50_000
    datas, totals = [], collections.Counter()
    for a in range(3):
        rng = np.random.default_rng(100 + a)
        keys = [f"user-{(i * 7 + a * 13) % n_keys}" for i in
                rng.integers(0, n_keys, n_per_agent)]
        totals.update(keys)
        datas.append({
            "time_": np.arange(n_per_agent, dtype=np.int64),
            "k": keys,
            "v": np.ones(n_per_agent, dtype=np.int64),
        })
    got = {}
    for pkg, make, wire in (
        ("jax", lambda: JaxEngine(window_rows=1 << 15), jax_wire),
        ("port", lambda: Engine(window_rows=1 << 15, device="cpu"),
         port_wire),
    ):
        P, _DT = PKGS[pkg]
        aggs = (P.AggExpr("n", "count", (P.ColumnRef("v"),)),)
        payloads = []
        for d in datas:
            eng = make()
            eng.append_data("events", d)
            p = P.Plan()
            src = p.add(P.MemorySourceOp(table="events"))
            agg = p.add(P.AggOp(("k",), aggs, mode="partial"), [src])
            p.add(P.BridgeSinkOp(bridge_id=1), [agg])
            out = eng.execute_plan(p)
            payloads.append(wire.decode(wire.encode(out[("bridge", 1)])))
        mp = P.Plan()
        bsrc = mp.add(P.BridgeSourceOp(bridge_id=1))
        fin = mp.add(P.AggOp(("k",), aggs, mode="finalize"), [bsrc])
        mp.add(P.ResultSinkOp("out"), [fin])
        d = make().execute_plan(mp, bridge_inputs={1: payloads})["out"]
        d = d.to_pydict()
        got[pkg] = dict(zip(d["k"], d["n"].tolist()))
    assert len(got["port"]) == len(totals)
    assert got["port"] == got["jax"] == dict(totals)


def test_distributed_engine_streaming_live_query():
    """A live query over the mesh engine: each poll's replace update
    matches the table as rows arrive, in both packages."""
    from pixie_tpu.exec.streaming import stream_query as jax_stream_query
    from pixie_tpu_torch.exec.streaming import stream_query

    q = ("import px\ndf = px.DataFrame(table='s')\n"
         "out = df.groupby('v').agg(n=('v', px.count))\npx.display(out)")
    rng = np.random.default_rng(2)
    n0 = 6000
    d0 = {"time_": np.arange(n0, dtype=np.int64), "v": rng.integers(0, 5, n0)}
    extra = {"time_": np.arange(n0, n0 + 2000, dtype=np.int64),
             "v": rng.integers(0, 5, 2000)}
    want0 = collections.Counter(d0["v"].tolist())
    want1 = want0 + collections.Counter(extra["v"].tolist())
    for eng, sq in (
        (JaxDistributedEngine(window_rows=W, mesh=jax_agent_mesh(8)),
         jax_stream_query),
        (DistributedEngine(window_rows=W, mesh=_cpu_mesh()), stream_query),
    ):
        updates = []
        eng.append_data("s", d0)
        lq = sq(eng, q, updates.append)
        lq.poll()
        assert updates, "no initial update"
        got = updates[-1].batch.to_pydict()
        assert dict(zip(got["v"].tolist(), got["n"].tolist())) == dict(want0)
        eng.append_data("s", extra)
        lq.poll()
        got = updates[-1].batch.to_pydict()
        assert dict(zip(got["v"].tolist(), got["n"].tolist())) == dict(want1)


def test_axis_fold_merge_is_a_balanced_tree():
    """The per-axis merge pairs neighbours level by level and carries an
    odd tail over unmerged: 5 states merge as ((0+1)+(2+3))+4."""
    calls = []

    def merge(a, b):
        calls.append((a, b))
        return f"({a}+{b})"

    assert executor._axis_fold_merge(list("01234"), merge) == "(((0+1)+(2+3))+4)"
    assert calls[:2] == [("0", "1"), ("2", "3")]
    assert executor._axis_fold_merge(["x"], merge) == "x"


def test_shard_valid_splits_a_global_row_range():
    """A resident window's global (lo, hi) becomes each shard's own range,
    clamped to the shard: rows [1000, 3000) of a 4096-row window over 3
    uneven shards."""
    m = agent_mesh(3, devices=[CPU] * 3)
    assert mesh_mod.shard_bounds(4096, 3) == [(0, 1366), (1366, 2731),
                                              (2731, 4096)]
    assert executor.shard_valid((1000, 3000), 4096, m) == [
        (1000, 1366), (0, 1365), (0, 269)]
    assert executor.shard_valid((0, 0), 4096, m) == [(0, 0)] * 3
    mask = torch.arange(10) % 2 == 0
    parts = executor.shard_valid(mask, 10, m)
    assert [p.tolist() for p in parts] == [
        [True, False, True, False], [True, False, True], [False, True, False]]


@pytest.mark.cuda
def test_mesh_on_the_card():
    """On the card: 4 virtual PEMs on one device give the single engine's
    FLOAT64 group-by, with ``dense_fold`` launched once per shard per
    window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pixie_tpu_torch.ops import dense_fold

    dev = torch.device("cuda", torch.cuda.current_device())
    data = _http_events(4 * W)
    dist = DistributedEngine(window_rows=W,
                             mesh=agent_mesh(4, devices=[dev] * 4))
    single = Engine(window_rows=W)
    for e in (dist, single):
        e.append_data("http_events", data)
    dense_fold.dense_fold.launches = 0
    got = _by_keys(dist.execute_query(HTTP_STATS_F64)["output"])
    assert dense_fold.dense_fold.launches == 4 * dist.last_stats.windows
    _assert_f64(_by_keys(single.execute_query(HTTP_STATS_F64)["output"]), got)
    _assert_f64(_numpy_http_stats_f64(data), got)


def test_mesh_over_two_devices_compiles_a_fragment_per_device(engines):
    """Slots on two devices (``cpu`` and ``cpu:0`` compare unequal, so the
    mesh has two): the fragment is compiled once per device against one
    column-stats snapshot, each slot folds with its device's fragment,
    the states gather onto the merging slot's device, and the fused
    join's side tables are copied once per query. The answers equal the
    single engine's."""
    slots = [CPU] * 4 + [torch.device("cpu", 0)] * 4
    dist = DistributedEngine(window_rows=W,
                             mesh=agent_mesh(8, devices=slots))
    assert dist.mesh.distinct_devices() == [CPU, torch.device("cpu", 0)]
    dist.append_data("http_events", _http_events(10_000))
    devices = []
    real = executor.compile_fragment

    def spy(*args, **kw):
        devices.append(args[4])
        return real(*args, **kw)

    executor.compile_fragment = spy
    try:
        two = {"jax": engines["jax"], "port": dist,
               "single": engines["single"]}
        _three_way(two, _plan_run(_http_stats_plan))
        got = dist.execute_plan(_rows_plan("port"))["out"].to_pydict()
    finally:
        executor.compile_fragment = real
    assert devices[:2] == [CPU, torch.device("cpu", 0)]
    ref = engines["single"].execute_plan(_rows_plan("port"))["out"]
    ref = ref.to_pydict()
    assert got["service"].tolist() == ref["service"].tolist()
    np.testing.assert_array_equal(got["lat_ms"], ref["lat_ms"])


def test_planning_error_is_a_query_error():
    """A distributed state none of whose PEMs holds the scanned table
    cannot be planned: both mesh engines raise their QueryError."""
    from pixie_tpu.exec.engine import QueryError as JaxQueryError
    from pixie_tpu_torch.exec.engine import QueryError

    errors = {}
    for pkg, make, err in (
        ("jax", lambda st: JaxDistributedEngine(
            window_rows=W, mesh=jax_agent_mesh(8), distributed_state=st),
         JaxQueryError),
        ("port", lambda st: DistributedEngine(
            window_rows=W, mesh=_cpu_mesh(), distributed_state=st),
         QueryError),
    ):
        mod = jax_dstate if pkg == "jax" else dstate
        st = mod.DistributedState(agents=[
            mod.AgentInfo(agent_id="pem-0", processes_data=True,
                          tables=frozenset({"other"})),
            mod.AgentInfo(agent_id="kelvin-0", processes_data=False,
                          accepts_remote_sources=True)])
        eng = make(st)
        eng.append_data("http_events", _http_events(100))
        with pytest.raises(err) as e:
            eng.execute_plan(_http_stats_plan(pkg))
        errors[pkg] = str(e.value)
    assert errors["port"] == errors["jax"]
