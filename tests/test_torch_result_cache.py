"""The port's repeat serving (``exec/result_cache.py``, ``exec/views.py``
and ``Engine.execute_query``) against the JAX package's.

The local-engine cases of ``tests/test_result_cache.py`` on the same
seeded rows in both packages. After every run the port's disposition
(``Engine.last_stats.cache``) must equal the JAX engine's
(``tracer.last().cache``): the result cache off by default, a miss then
a hit, a watermark advance that stales at a zero budget and serves
within a larger one, attribution runs and pxtrace scripts never served,
the key's ``max_output_rows`` and not its ``now_ns``. The cache unit
cases (LRU, oversize, regression, bypass, the counters) run on the
port's class alone. Views register after ``view_auto_min_runs`` runs
and answer exactly what a rescan gives, across appends, a rebucket and
ring expiry. Every shipped manifest's staleness budget and
``materialize`` hint read through the port's loader equals the JAX
package's. Answers are compared exactly: integer aggregates, folded in
order on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec import result_cache as jax_rc
from pixie_tpu.exec import views as jax_views
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.scripts import load_script as jax_load_script
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec import result_cache as rc
from pixie_tpu_torch.exec import views
from pixie_tpu_torch.exec.plan import MemorySourceOp, Plan, ResultSinkOp
from pixie_tpu_torch.exec.result_cache import ResultCache, result_nbytes
from pixie_tpu_torch.scripts import list_scripts, load_script

W = 1 << 10

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum))\n"
    "px.display(df)\n"
)

HEAD_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "px.display(df.head(5))\n"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Both:
    """A CPU port engine and a JAX engine fed the same rows."""

    def __init__(self, n=3 * W + 7, keys=11, max_bytes=-1):
        self.eng = Engine(window_rows=W, device="cpu")
        self.ref = JaxEngine(window_rows=W)
        if max_bytes >= 0:
            self.eng.create_table("t", max_bytes=max_bytes)
            self.ref.create_table("t", max_bytes=max_bytes)
        self.push(0, n, keys, seed=3)

    def push(self, off, n, keys=11, seed=None):
        rng = np.random.default_rng(off if seed is None else seed)
        cols = {
            "time_": np.arange(off, off + n, dtype=np.int64),
            "k": rng.integers(0, keys, n),
            "v": rng.integers(0, 1000, n),
        }
        self.eng.append_data("t", cols)
        self.ref.append_data("t", cols)

    def run(self, query=AGG_Q, **kw):
        """Both answers and both dispositions (asserted equal)."""
        got = self.eng.execute_query(query, **kw)
        want = self.ref.execute_query(query, **kw)
        cache, jcache = self.eng.last_stats.cache, self.ref.tracer.last().cache
        assert cache == jcache, (cache, jcache)
        return got, want, cache


def _pydicts(out):
    return {k: v.to_pydict() for k, v in out.items()}


def _same(a, b) -> bool:
    a, b = _pydicts(a), _pydicts(b)
    if a.keys() != b.keys():
        return False
    for name in a:
        if a[name].keys() != b[name].keys():
            return False
        for col in a[name]:
            x, y = np.asarray(a[name][col]), np.asarray(b[name][col])
            if x.shape != y.shape:
                return False
            if "k" in a[name]:  # group order is the engine's; compare sorted
                ox = np.argsort(np.asarray(a[name]["k"]), kind="stable")
                oy = np.argsort(np.asarray(b[name]["k"]), kind="stable")
                x, y = x[ox], y[oy]
            if not np.array_equal(x, y):
                return False
    return True


def _flags(**kw):
    """A context setting the same flags in both packages."""
    import contextlib

    stack = contextlib.ExitStack()
    for k, v in kw.items():
        stack.enter_context(override_flag(k, v))
        stack.enter_context(jax_override_flag(k, v))
    return stack


# -- dispositions against the JAX engine ------------------------------------------------
def test_disabled_by_default():
    b = _Both()
    for _ in range(2):
        got, want, cache = b.run()
        assert cache == "" and _same(got, want)
    z = b.eng.result_cache.cachez()
    assert z["enabled"] is False and z["entries"] == []


def test_miss_then_hit_same_result():
    b = _Both()
    with _flags(result_cache_mb=64):
        first, want, cache = b.run()
        assert cache == rc.MISS and _same(first, want)
        second, _w, cache = b.run()
        assert cache == rc.HIT
        assert b.eng.last_stats.windows == 0  # nothing executed
    assert _same(first, second)
    z = b.eng.result_cache.cachez()
    assert (z["hits"], z["misses"], z["stale"]) == (1, 1, 0)


def test_watermark_advance_stales_at_zero_budget():
    b = _Both(n=2000)
    with _flags(result_cache_mb=64):
        old, _w, _c = b.run()
        b.push(2000, 500)
        fresh, want, cache = b.run()
        assert cache == rc.STALE
        assert not _same(old, fresh) and _same(fresh, want)
        again, _w, cache = b.run()
        assert cache == rc.HIT
    assert _same(fresh, again)


def test_budget_allows_bounded_staleness():
    b = _Both(n=2000)
    with _flags(result_cache_mb=64, result_cache_staleness_ms=1e9):
        old, _w, _c = b.run()
        b.push(2000, 500)
        served, _w, cache = b.run()
        assert cache == rc.HIT
    assert _same(old, served)


@pytest.mark.parametrize("how", ["analyze", "pxtrace"])
def test_attribution_runs_and_pxtrace_never_served(how):
    b = _Both()
    query = AGG_Q + ("# pxtrace\n" if how == "pxtrace" else "")
    kw = {"analyze": True} if how == "analyze" else {}
    with _flags(result_cache_mb=64):
        b.run(query)
        b.run(query)
        got, want, cache = b.run(query, **kw)
    assert cache == ""  # executed for real, as in the JAX engine
    assert b.eng.last_stats.windows > 0 and _same(got, want)


def test_key_includes_max_output_rows():
    b = _Both()
    with _flags(result_cache_mb=64):
        b.run(max_output_rows=10_000)
        assert b.run(max_output_rows=100)[2] == rc.MISS
        assert b.run(max_output_rows=100)[2] == rc.HIT


def test_key_excludes_now_ns_for_time_free_scripts():
    b = _Both()
    with _flags(result_cache_mb=64):
        b.run(now_ns=1_000)
        assert b.run(now_ns=2_000_000_000)[2] == rc.HIT


def test_hit_restamps_freshness_lag():
    b = _Both()
    with _flags(result_cache_mb=64):
        b.run()
        t0 = b.eng.last_stats.freshness_lag_ms
        assert t0 > 0
        time.sleep(0.02)
        b.run()
        st = b.eng.last_stats
        assert st.cache == rc.HIT and st.freshness_lag_ms >= t0


TIME_Q = (
    "import px\n"
    "df = px.DataFrame(table='t', start_time='-5s')\n"
    "df = df.groupby('k').agg(n=('v', px.count))\n"
    "px.display(df)\n"
)

#: Sequences of runs and appends; each step's disposition must equal the
#: JAX engine's.
SEQUENCES = {
    "zero_budget": ({"result_cache_mb": 64},
                    ["run", "run", "append", "run", "run", "run:100", "run:100"]),
    "large_budget": ({"result_cache_mb": 64, "result_cache_staleness_ms": 1e9},
                     ["run", "append", "run", "append", "run", "analyze", "run"]),
    "views_and_cache": ({"result_cache_mb": 64, "view_auto_min_runs": 2},
                        ["run", "run", "append", "run", "run", "append", "run"]),
    "views_only": ({"view_auto_min_runs": 1},
                   ["run", "append", "run", "run", "head", "head", "run"]),
    "time_bounded": ({"result_cache_mb": 64},
                     ["time:10", "time:10", "time:1500", "append",
                      "time:1500", "time:1500"]),
}


#: What each sequence gives (the same in both packages, asserted per step).
SEQUENCE_DISPOSITIONS = {
    "zero_budget": ["miss", "hit", "stale", "hit", "miss", "hit"],
    "large_budget": ["miss", "hit", "hit", "", "hit"],
    "views_and_cache": ["miss", "hit", "view", "view", "view"],
    "views_only": ["view", "view", "view", "", "", "view"],
    "time_bounded": ["miss", "hit", "stale", "stale", "hit"],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_dispositions_follow_jax_over_a_sequence(name):
    flags, steps = SEQUENCES[name]
    b = _Both(n=2000)
    off = 2000
    trail = []
    with _flags(**flags):
        for step in steps:
            if step == "append":
                b.push(off, 300)
                off += 300
                continue
            kw = {}
            query = AGG_Q
            if step == "analyze":
                kw["analyze"] = True
            elif step == "head":
                query = HEAD_Q
            elif step.startswith("run:"):
                kw["max_output_rows"] = int(step[4:])
            elif step.startswith("time:"):
                query = TIME_Q
                # start_time is now - 5 s: the scan starts at this row.
                kw["now_ns"] = 5_000_000_000 + int(step[5:])
            got, want, cache = b.run(query, **kw)
            assert _same(got, want), step
            trail.append(cache)
    b.eng.views.close()
    b.ref.views.close()
    assert trail == SEQUENCE_DISPOSITIONS[name]


# -- the cache's own behaviour ------------------------------------------------------------
def _plan_for(table="t"):
    p = Plan()
    src = p.add(MemorySourceOp(table=table))
    p.add(ResultSinkOp("output"), [src])
    return p


def test_lru_evicts_oldest_within_byte_budget():
    cache = ResultCache()
    big = {"output": b"x" * 600_000}
    with override_flag("result_cache_mb", 1):
        cache.store("script-a", 1, 10_000, _plan_for(), big, lambda t: 1)
        cache.store("script-b", 1, 10_000, _plan_for(), big, lambda t: 1)
        sa, _, _ = cache.lookup("script-a", 1, 10_000, lambda t: 1)
        sb, eb, _ = cache.lookup("script-b", 1, 10_000, lambda t: 1)
        z = cache.cachez()
    assert sa == rc.MISS  # evicted: 2 x 600 KB > 1 MB
    assert sb == rc.HIT and eb.result is big
    assert z["bytes"] <= z["budget_bytes"]
    assert [e["script_hash"] for e in z["entries"]] == [rc.script_sha("script-b")[:12]]


def test_oversized_result_never_stored():
    cache = ResultCache()
    with override_flag("result_cache_mb", 1):
        assert cache.store("big", 1, 10_000, _plan_for(),
                           {"output": b"x" * (2 << 20)}, lambda t: 1) == rc.MISS
    assert cache.cachez()["entries"] == []


def test_watermark_regression_drops_entry():
    cache = ResultCache()
    with override_flag("result_cache_mb", 64):
        cache.store("s", 1, 10_000, _plan_for(), {"output": b"y"}, lambda t: 100)
        status, _, _ = cache.lookup("s", 1, 10_000, lambda t: 50)
        assert status == rc.MISS
        assert cache.cachez()["entries"] == []


def test_bypass_when_no_watermark():
    cache = ResultCache()
    with override_flag("result_cache_mb", 64):
        got = cache.store("s", 1, 10_000, _plan_for(), {"output": b"y"},
                          lambda t: None)
    assert got == rc.BYPASS and cache.cachez()["entries"] == []


def test_counters_and_bytes():
    cache = ResultCache()
    with override_flag("result_cache_mb", 64):
        cache.lookup("s", 1, 10_000, lambda t: 1)  # miss
        cache.store("s", 1, 10_000, _plan_for(), {"output": b"y" * 100},
                    lambda t: 1)
        cache.lookup("s", 1, 10_000, lambda t: 1)  # hit
        cache.lookup("s", 1, 10_000, lambda t: 10**12)  # stale
        z = cache.cachez()
    assert (z["misses"], z["hits"], z["stale"]) == (1, 1, 1) and z["bytes"] > 0
    cache.clear()
    assert cache.cachez()["bytes"] == 0


def test_result_nbytes_counts_batches():
    assert result_nbytes({"a": b"xx", "b": "yyy"}) >= 5
    assert result_nbytes(np.zeros(100, np.int64)) == 800
    for obj in ({"a": b"xx", "b": "yyy"}, np.zeros(7, np.int32), [b"ab", "c"], 5):
        assert result_nbytes(obj) == jax_rc.result_nbytes(obj)


def test_bypass_for_a_table_without_a_watermark():
    """A scanned table with no time index gives no validity check: the
    run is marked bypass and nothing is stored."""
    eng, ref = Engine(window_rows=W, device="cpu"), JaxEngine(window_rows=W)
    cols = {"k": np.arange(50) % 3, "v": np.arange(50)}
    eng.append_data("t", cols, time_cols=())
    ref.append_data("t", cols, time_cols=())
    with _flags(result_cache_mb=64):
        eng.execute_query(AGG_Q)
        ref.execute_query(AGG_Q)
    assert eng.last_stats.cache == ref.tracer.last().cache == rc.BYPASS
    assert eng.result_cache.cachez()["entries"] == []


def test_cache_valid_across_demotion():
    """A cached result over a tiered table stays exact when the rows it
    covered demote: new appends invalidate it, and the refreshed answer
    over the mostly cold table is exact."""
    n = 512
    with override_flag("cold_tier_mb", 64):
        eng = Engine(window_rows=n, device="cpu")
        eng.create_table("t", max_bytes=4 * n * 24)
        for i in range(8):
            eng.append_data("t", {"time_": np.arange(i * n, (i + 1) * n),
                                  "k": np.zeros(n, np.int64),
                                  "v": np.arange(n)})
    with override_flag("result_cache_mb", 64):
        r1 = eng.execute_query(AGG_Q)
        eng.execute_query(AGG_Q)
        assert eng.last_stats.cache == rc.HIT
        for i in range(8, 12):
            eng.append_data("t", {"time_": np.arange(i * n, (i + 1) * n),
                                  "k": np.zeros(n, np.int64),
                                  "v": np.arange(n)})
        r3 = eng.execute_query(AGG_Q)
        assert eng.last_stats.cache == rc.STALE
    assert eng.tables["t"].stats().cold_rows > 0
    d1, d3 = r1["output"].to_pydict(), r3["output"].to_pydict()
    assert int(d1["n"][0]) == 8 * n and int(d3["n"][0]) == 12 * n
    assert int(d3["s"][0]) == 12 * sum(range(n))


# -- materialized views ------------------------------------------------------------------
def test_auto_registration_after_min_runs():
    b = _Both()
    with _flags(view_auto_min_runs=2):
        plain, _w, cache = b.run()
        assert cache == ""
        served, _w, cache = b.run()
        assert cache == rc.VIEW
    assert _same(plain, served)
    assert [v["table"] for v in b.eng.views.viewz()] == ["t"]
    b.eng.views.close()
    b.ref.views.close()


def test_view_fold_equals_rescan_after_appends():
    b = _Both(n=3000)
    with _flags(view_auto_min_runs=1):
        b.run()
        b.push(3000, 1500)
        b.push(4500, 700)
        view_out, want, cache = b.run()
        assert cache == rc.VIEW
        assert b.eng.last_stats.rows == 2200  # only the new rows folded
    b.eng.views.close()
    b.ref.views.close()
    rescan, _w, cache = b.run()
    assert cache == ""
    assert _same(view_out, rescan) and _same(view_out, want)


def test_view_survives_group_rebucket():
    b = _Both(n=2000, keys=3)
    with _flags(view_auto_min_runs=1):
        b.run(max_output_rows=1 << 20)
        b.push(2000, 2000, keys=6000)  # past the domain rounded to 4096
        view_out, want, cache = b.run(max_output_rows=1 << 20)
        assert cache == rc.VIEW and b.eng.last_stats.rebuckets >= 1
    b.eng.views.close()
    b.ref.views.close()
    rescan, _w, _c = b.run(max_output_rows=1 << 20)
    assert _same(view_out, rescan) and _same(view_out, want)
    assert len(view_out["output"].to_pydict()["k"]) > 100


def test_view_survives_ring_expiry_churn():
    b = _Both(n=1500, max_bytes=2000 * 24)
    with _flags(view_auto_min_runs=1):
        b.run()
        for off in range(1500, 6000, 1500):
            b.push(off, 1500)  # expires earlier batches
        view_out, want, cache = b.run()
        assert cache == rc.VIEW
    b.eng.views.close()
    b.ref.views.close()
    rescan, _w, _c = b.run()
    assert _same(view_out, rescan) and _same(view_out, want)
    assert b.eng.tables["t"].num_rows < 6000


def test_non_streamable_script_falls_back_to_execution():
    b = _Both()
    with _flags(view_auto_min_runs=1):
        for _ in range(2):
            out, want, cache = b.run(HEAD_Q)
            assert cache == ""
            assert len(out["output"].to_pydict()["v"]) == 5 and _same(out, want)
        assert b.eng.views.viewz() == []


def test_manifest_views_inert_without_serving_tier():
    hot = load_script("px/http_stats").pxl
    assert not views.view_candidates_enabled(AGG_Q)
    assert not views.view_candidates_enabled(hot)
    with override_flag("result_cache_mb", 64):
        assert views.view_candidates_enabled(hot)
        assert not views.view_candidates_enabled(AGG_Q)
    with override_flag("view_auto_min_runs", 1):
        assert views.view_candidates_enabled(AGG_Q)
        assert not views.view_candidates_enabled(AGG_Q + "# pxtrace\n")


# -- one freshness sweep per hit and per poll -----------------------------------------------
class _SweepCounter:
    """Counts max_watermark_ns sweeps over one engine's tablets."""

    def __init__(self, monkeypatch, eng):
        from pixie_tpu_torch.table_store import table as table_mod

        self.calls = 0
        mine = {id(t) for t in eng.table_store.tablets("t")}
        real = table_mod.max_watermark_ns

        def counting(tablets):
            tablets = list(tablets)
            if any(id(t) in mine for t in tablets):
                self.calls += 1
            return real(tablets)

        monkeypatch.setattr(table_mod, "max_watermark_ns", counting)


def test_cache_hit_is_one_sweep(monkeypatch):
    b = _Both()
    with override_flag("result_cache_mb", 64):
        b.eng.execute_query(AGG_Q)
        sweeps = _SweepCounter(monkeypatch, b.eng)
        b.eng.execute_query(AGG_Q)
        assert b.eng.last_stats.cache == rc.HIT
    assert sweeps.calls == 1


def test_streaming_poll_is_one_sweep(monkeypatch):
    from pixie_tpu_torch.exec.streaming import stream_query

    b = _Both(n=2000)
    sq = stream_query(b.eng, AGG_Q, emit=lambda u: None)
    sweeps = _SweepCounter(monkeypatch, b.eng)
    sq.poll()
    assert sweeps.calls == 1
    b.push(2000, 500)
    sq.poll()
    assert sweeps.calls == 2


def test_rebucket_retry_does_not_resweep(monkeypatch):
    from pixie_tpu_torch.exec.streaming import stream_query

    b = _Both(n=2000, keys=3)
    sq = stream_query(b.eng, AGG_Q, emit=lambda u: None)
    sq.poll()
    b.push(2000, 2000, keys=6000)
    sweeps = _SweepCounter(monkeypatch, b.eng)
    sq.poll()
    assert sq.last_stats.rebuckets >= 1 and sweeps.calls == 1


# -- the manifests ------------------------------------------------------------------------------
SCRIPTS = list_scripts()


def test_every_shipped_script_is_listed():
    assert len(SCRIPTS) == 81


@pytest.mark.parametrize("name", SCRIPTS)
def test_manifest_budget_and_view_hint_match_jax(name):
    """Each manifest's staleness_budget_ms and materialize hint, read by
    the port's YAML subset, equal the JAX package's (keyed by the same
    sha256 of the same script text)."""
    pxl = load_script(name).pxl
    assert pxl == jax_load_script(name).pxl
    sha = rc.script_sha(pxl)
    assert sha == jax_rc.script_sha(pxl)
    assert rc.manifest_budgets().get(sha) == jax_rc.manifest_budgets().get(sha)
    assert rc.ResultCache.staleness_budget_ms(sha) == \
        jax_rc.ResultCache.staleness_budget_ms(sha)
    assert (sha in views.manifest_materialized()) == \
        (sha in jax_views.manifest_materialized())
