"""The port's table store (``table_store/``) against the JAX package's.

Each case of ``tests/test_table_store.py`` runs here on both packages:
the same seeded batches go into a JAX ``Table`` or ``TableStore`` and a
port one, each run checks the JAX case's own assertions, and the two
runs' observations (row counts, times, strings, counters, ids) must be
equal exactly. The cases cover the hot/cold ring, cursors across
compaction and expiry, tailing cursors (``StopSpec.never()``), the numpy
ring, tablets, table ids and ``compact_all``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import pixie_tpu.table_store as jax_ts
import pixie_tpu.table_store.table as jax_table_mod
import pixie_tpu_torch.table_store as port_ts
import pixie_tpu_torch.table_store.table as port_table_mod
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu_torch.exec import Engine as PortEngine
from pixie_tpu_torch.types.batch import HostBatch as PortHostBatch
from pixie_tpu_torch.types.dtypes import DataType as PortDataType
from pixie_tpu_torch.types.relation import Relation as PortRelation


def _pkg(ts, table_mod, relation, dtype, host_batch, engine):
    rel = relation([
        ("time_", dtype.TIME64NS),
        ("latency", dtype.INT64),
        ("service", dtype.STRING),
    ])
    return types.SimpleNamespace(
        Table=ts.Table, TableStore=ts.TableStore, StartSpec=ts.StartSpec,
        StopSpec=ts.StopSpec, table_mod=table_mod, REL=rel,
        HostBatch=host_batch, engine=engine,
    )


PKGS = {
    "jax": _pkg(jax_ts, jax_table_mod, JaxRelation, JaxDataType,
                JaxHostBatch, lambda: JaxEngine()),
    "port": _pkg(port_ts, port_table_mod, PortRelation, PortDataType,
                 PortHostBatch, lambda: PortEngine(device="cpu")),
}


def _batch(t0, n, svc="a"):
    return {
        "time_": np.arange(t0, t0 + n, dtype=np.int64),
        "latency": np.arange(n, dtype=np.int64),
        "service": [svc] * n,
    }


def _mk(p, max_bytes=-1, compacted_rows=1 << 16):
    return p.Table("t", p.REL, max_bytes=max_bytes, compacted_rows=compacted_rows)


def _times(hb) -> list:
    return [int(x) for x in hb.cols["time_"][0]]


def case_round_trip(p, mp):
    t = _mk(p)
    t.append(_batch(0, 100))
    t.append(_batch(100, 50, svc="b"))
    hb = t.read_all()
    assert hb.length == 150
    d = hb.to_pydict()
    assert d["time_"][0] == 0 and d["time_"][-1] == 149
    assert d["service"][0] == "a" and d["service"][-1] == "b"
    assert t.num_rows == 150
    return {"times": [int(x) for x in d["time_"]],
            "service": list(d["service"]),
            "latency": [int(x) for x in d["latency"]]}


def case_scan_time_bounds(p, mp):
    t = _mk(p)
    t.append(_batch(0, 100))
    got = list(t.scan(start_time=10, stop_time=20))
    total = sum(b.length for b in got)
    assert total == 10
    times = np.concatenate([b.cols["time_"][0] for b in got])
    assert times.min() == 10 and times.max() == 19
    return {"times": [int(x) for x in times]}


def case_cursor_stable_across_compaction(p, mp):
    t = _mk(p, compacted_rows=64)
    for i in range(8):
        t.append(_batch(i * 32, 32))
    cur = t.cursor(p.StartSpec(), p.StopSpec.current_end())
    first = cur.next_batch(100)
    assert first.length == 100
    t.compact()  # moves everything hot -> cold mid-read
    rest = []
    while not cur.done():
        b = cur.next_batch(100)
        if b is None:
            break
        rest.append(b)
    total = first.length + sum(b.length for b in rest)
    assert total == 256
    all_times = np.concatenate(
        [first.cols["time_"][0]] + [b.cols["time_"][0] for b in rest]
    )
    assert np.array_equal(all_times, np.arange(256))
    return {"lengths": [first.length] + [b.length for b in rest]}


def case_infinite_cursor_sees_new_data(p, mp):
    t = _mk(p)
    t.append(_batch(0, 10))
    cur = t.cursor(stop=p.StopSpec.never())
    first = cur.next_batch(100)
    assert first.length == 10
    assert not cur.done()
    ready_dry = cur.next_batch_ready()
    assert cur.next_batch(100) is None  # dry, but not done
    t.append(_batch(10, 5))
    assert cur.next_batch_ready()
    second = cur.next_batch(100)
    assert second.length == 5
    return {"first": _times(first), "second": _times(second),
            "ready_dry": ready_dry, "done": cur.done()}


def case_expiry_drops_oldest(p, mp):
    row_bytes = 8 + 8 + 4  # time + latency + service id
    t = _mk(p, max_bytes=100 * row_bytes)
    t.append(_batch(0, 60))
    t.append(_batch(60, 60))  # exceeds budget -> first batch expires
    st = t.stats()
    assert st.batches_expired == 1
    hb = t.read_all()
    assert hb.length == 60
    assert hb.cols["time_"][0][0] == 60
    return {"batches_expired": st.batches_expired, "times": _times(hb),
            "num_batches": st.num_batches}


def case_cursor_skips_expired(p, mp):
    row_bytes = 20
    t = _mk(p, max_bytes=100 * row_bytes)
    cur = t.cursor(stop=p.StopSpec.never())
    t.append(_batch(0, 60))
    t.append(_batch(60, 60))  # expires rows [0, 60)
    b = cur.next_batch(1000)
    assert b.cols["time_"][0][0] == 60  # resumed at first live row
    return {"times": _times(b), "after": cur.next_batch(1000)}


def case_compaction_stats(p, mp):
    t = _mk(p, compacted_rows=128)
    for i in range(4):
        t.append(_batch(i * 100, 100))
    created = t.compact()
    st = t.stats()
    assert created == st.compacted_batches == created
    assert st.hot_bytes == 0 and st.cold_bytes > 0
    assert t.read_all().length == 400
    return {"created": created, "cold_bytes": st.cold_bytes,
            "num_batches": st.num_batches}


def case_start_at_time(p, mp):
    t = _mk(p)
    t.append(_batch(0, 100))
    cur = t.cursor(p.StartSpec.at_time(42), p.StopSpec.at_time(50))
    b = cur.next_batch(1000)
    times = b.cols["time_"][0]
    assert times[0] == 42 and times[-1] == 50
    assert cur.done()
    return {"times": _times(b)}


def case_dict_merge_on_foreign_append(p, mp):
    t = _mk(p)
    t.append(_batch(0, 3, svc="a"))
    foreign = p.HostBatch.from_pydict(_batch(3, 3, svc="zzz"), relation=p.REL)
    t.append(foreign)
    d = t.read_all().to_pydict()
    assert list(d["service"]) == ["a"] * 3 + ["zzz"] * 3
    return {"service": list(d["service"])}


def case_py_backend_parity(p, mp):
    mp.setattr(p.table_mod, "load_native", lambda name: None)
    t = _mk(p, compacted_rows=64)
    assert isinstance(t._backend, p.table_mod._PyBackend)
    for i in range(4):
        t.append(_batch(i * 50, 50))
    created = t.compact()
    assert t.read_all().length == 200
    got = list(t.scan(start_time=25, stop_time=75))
    assert sum(b.length for b in got) == 50
    return {"created": created,
            "times": [x for b in got for x in _times(b)]}


def case_cursor_never_passes_stop_after_expiry(p, mp):
    row_bytes = 20
    t = _mk(p, max_bytes=100 * row_bytes)
    t.append(_batch(0, 100))
    cur = t.cursor(p.StartSpec(), p.StopSpec.current_end())  # stop at row 100
    t.append(_batch(100, 100))  # expires rows [0, 100)
    assert cur.next_batch(1000) is None
    assert cur.done()
    return {"done": cur.done(), "ready": cur.next_batch_ready()}


def case_append_does_not_mutate_caller_batch(p, mp):
    t = _mk(p)
    t.append(_batch(0, 2, svc="a"))
    hb = p.HostBatch.from_pydict(_batch(2, 2, svc="y"), relation=p.REL)
    t.append(hb)
    got = list(hb.dicts["service"].decode(hb.cols["service"][0]))
    assert got == ["y", "y"]
    return {"caller": got, "table": list(t.read_all().to_pydict()["service"])}


def case_zero_row_append(p, mp):
    rows = []
    for native in (True, False):
        if not native:
            mp.setattr(p.table_mod, "load_native", lambda name: None)
        t = _mk(p)
        t.append({"time_": [], "latency": [], "service": []})
        assert t.num_rows == 0
        t.append(_batch(0, 3))
        assert t.num_rows == 3
        rows.append(_times(t.read_all()))
    return {"rows": rows}


def case_query_sees_all_tablets(p, mp):
    e = p.engine()
    e.create_table("t", p.REL)
    e.table_store.append_data("t", _batch(0, 5), tablet_id="tab1")
    e.table_store.append_data("t", _batch(5, 7, svc="b"), tablet_id="tab2")
    out = e.execute_query(
        "import px\n"
        "df = px.DataFrame(table='t')\n"
        "df = df.groupby('service').agg(n=('latency', px.count))\n"
        "px.display(df, 'o')\n"
    )
    d = out["o"].to_pydict()
    got = sorted(zip(d["service"], (int(x) for x in d["n"])))
    assert got == [("a", 5), ("b", 7)]
    return {"groups": got}


def case_tablet_inherits_budget_and_dicts(p, mp):
    ts = p.TableStore()
    ts.add_table("cap", p.REL, max_bytes=12345, compacted_rows=99)
    ts.append_data("cap", _batch(0, 2), tablet_id="x")
    tab = ts.get_table("cap", "x")
    assert tab.max_bytes == 12345 and tab.compacted_rows == 99
    assert tab.dicts["service"] is ts.get_table("cap").dicts["service"]
    return {"max_bytes": tab.max_bytes, "compacted_rows": tab.compacted_rows,
            "id": ts.get_table_id("cap"), "ids": ts.table_ids()}


def case_name_and_id_addressing(p, mp):
    ts = p.TableStore()
    ts.add_table("http_events", p.REL, table_id=7)
    assert ts.get_table_id("http_events") == 7
    assert ts.get_table_name(7) == "http_events"
    ts.append_data(7, _batch(0, 10))
    assert ts.get_table("http_events").num_rows == 10
    # The next table takes the id after the largest one given.
    ts.add_table("conn_stats", p.REL)
    return {"by_id": ts.get_table(7).num_rows,
            "ids": ts.table_ids(),
            "names": [ts.get_table_name(i) for i in ts.table_ids()],
            "unknown_name": ts.get_table_name(99),
            "unknown_id": ts.get_table_id("nope"),
            "unknown_table": ts.get_table(99)}


def case_tablets(p, mp):
    ts = p.TableStore()
    ts.add_table("t", p.REL)
    ts.append_data("t", _batch(0, 5), tablet_id="tablet-1")
    ts.append_data("t", _batch(5, 7), tablet_id="tablet-2")
    tablets = ts.tablets("t")
    assert [t.num_rows for t in tablets] == [0, 5, 7]
    return {"rows": [t.num_rows for t in tablets], "ids": ts.table_ids()}


def case_append_unknown_id_raises(p, mp):
    ts = p.TableStore()
    with pytest.raises(KeyError) as ei:
        ts.append_data(99, _batch(0, 1))
    return {"error": str(ei.value), "names": ts.table_names()}


def case_compact_all(p, mp):
    ts = p.TableStore()
    ts.add_table("a", p.REL)
    ts.append_data("a", _batch(0, 10))
    ts.append_data("a", _batch(10, 10), tablet_id="b")
    n = ts.compact_all()
    assert n >= 1
    return {"made": n, "again": ts.compact_all(),
            "hot_bytes": [t.stats().hot_bytes for t in ts.tablets("a")]}


CASES = {
    f.__name__[len("case_"):]: f
    for f in (
        case_round_trip, case_scan_time_bounds,
        case_cursor_stable_across_compaction,
        case_infinite_cursor_sees_new_data, case_expiry_drops_oldest,
        case_cursor_skips_expired, case_compaction_stats, case_start_at_time,
        case_dict_merge_on_foreign_append, case_py_backend_parity,
        case_cursor_never_passes_stop_after_expiry,
        case_append_does_not_mutate_caller_batch, case_zero_row_append,
        case_query_sees_all_tablets, case_tablet_inherits_budget_and_dicts,
        case_name_and_id_addressing, case_tablets,
        case_append_unknown_id_raises, case_compact_all,
    )
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_store_matches_jax(case, monkeypatch):
    """The JAX case's assertions hold on both packages, and the two
    packages observe the same values."""
    got = {}
    for name, p in PKGS.items():
        with monkeypatch.context() as mp:
            got[name] = CASES[case](p, mp)
    assert got["port"] == got["jax"]


def test_stop_spec_never_is_the_only_infinite_form():
    for p in PKGS.values():
        assert p.StopSpec.never().infinite
        assert not p.StopSpec.current_end().infinite
        assert not p.StopSpec.at_time(5).infinite
        assert p.StopSpec.never() == p.StopSpec(infinite=True)


def test_tailing_cursor_follows_many_appends():
    """A tailing cursor over 40 seeded appends returns every row once, in
    order, on both packages, with expiry dropping rows it never read."""
    rng = np.random.default_rng(17)
    sizes = [int(x) for x in rng.integers(1, 50, 40)]
    out = {}
    for name, p in PKGS.items():
        t = _mk(p, max_bytes=300 * 20)
        cur = t.cursor(stop=p.StopSpec.never())
        seen, t0 = [], 0
        for i, n in enumerate(sizes):
            t.append(_batch(t0, n))
            t0 += n
            if i % 3 == 2:
                while cur.next_batch_ready():
                    seen.extend(_times(cur.next_batch(64)))
        while cur.next_batch_ready():
            seen.extend(_times(cur.next_batch(64)))
        assert seen == sorted(set(seen)) and seen[-1] == t0 - 1
        assert not cur.done() and cur.next_batch(64) is None
        out[name] = seen
    assert out["port"] == out["jax"]
