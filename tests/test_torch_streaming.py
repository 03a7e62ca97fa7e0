"""The port's live queries (``exec/streaming.py``) against the JAX
package's ``StreamingQuery`` on the same seeded appends.

The cases of ``tests/test_streaming.py`` that need no cluster, and the
cursor's edge cases: an aggregate stream emits the JAX stream's
``replace`` updates (same seqs, same groups, same values); a row chain
emits only the new rows, in the JAX stream's order; a poll folds exactly
the rows appended since the one before; cancel ends the run loop; a
time-bounded source, a join and two aggregates are refused by both
packages; a zone-pruned tail commits the watermark; a rebucket in the
middle of a stream and a refold after true expiry both end at the
one-shot answer; demotion into the cold tier never refolds. On the CPU
the plain folds add in order, so every comparison is exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.streaming import stream_query as jax_stream_query
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.plan import BridgeSinkOp, MemorySourceOp, Plan
from pixie_tpu_torch.exec.streaming import StreamingQuery, stream_query
from pixie_tpu_torch.types import DataType, Relation

W = 1 << 10

AGG_Q = """
import px
df = px.DataFrame(table='http_events')
out = df.groupby('service').agg(n=('latency_ns', px.count),
                                s=('latency_ns', px.sum))
px.display(out)
"""

ROWS_Q = """
import px
df = px.DataFrame(table='http_events')
df = df[df.latency_ns >= 500]
out = df['time_', 'latency_ns']
px.display(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _push(engines, off, n, seed=None, keys=3):
    rng = np.random.default_rng(seed if seed is not None else off)
    cols = {
        "time_": np.arange(off, off + n, dtype=np.int64),
        "latency_ns": rng.integers(0, 1000, n),
        "service": [f"svc-{j % keys}" for j in rng.integers(0, keys, n)],
    }
    for e in engines:
        e.append_data("http_events", cols)


def _engines(max_bytes=-1):
    eng = Engine(window_rows=W, device="cpu")
    ref = JaxEngine(window_rows=W)
    eng.create_table("http_events", max_bytes=max_bytes)
    ref.create_table("http_events", max_bytes=max_bytes)
    return eng, ref


def _streams(engines, query, **kw):
    eng, ref = engines
    ups, jups = [], []
    sq = stream_query(eng, query, emit=ups.append, **kw)
    jsq = jax_stream_query(ref, query, emit=jups.append, **kw)
    return sq, jsq, ups, jups


def _rows(batch, key=None):
    d = batch.to_pydict()
    if key is not None:
        o = np.argsort(np.asarray(d[key]).astype(str), kind="stable")
        d = {k: np.asarray(v)[o] for k, v in d.items()}
    return {k: np.asarray(v) for k, v in d.items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for c in a:
        assert np.array_equal(a[c], b[c]), c


def _same_updates(ups, jups, key=None):
    assert [(u.seq, u.mode) for u in ups] == [(u.seq, u.mode) for u in jups]
    for u, j in zip(ups, jups):
        _same(_rows(u.batch, key), _rows(j.batch, key))


def test_incremental_agg_replace_matches_jax():
    engines = _engines()
    _push(engines, 0, 2000)
    sq, jsq, ups, jups = _streams(engines, AGG_Q)
    assert sq.poll() == jsq.poll() == 2000
    assert sq.poll() == jsq.poll() == 0  # an idle poll emits nothing
    for off, n in ((2000, 500), (2500, 100), (2600, 3 * W)):
        _push(engines, off, n)
        assert sq.poll() == jsq.poll() == n
        assert sq.last_stats.rows == n
    assert [u.seq for u in ups] == [0, 1, 2, 3]
    _same_updates(ups, jups, key="service")
    assert int(np.sum(ups[-1].batch.to_pydict()["n"])) == 2600 + 3 * W
    one_shot = engines[0].execute_query(AGG_Q)["output"]
    _same(_rows(ups[-1].batch, "service"), _rows(one_shot, "service"))


def test_append_stream_emits_only_new_rows_like_jax():
    engines = _engines()
    _push(engines, 0, 1000)
    sq, jsq, ups, jups = _streams(engines, ROWS_Q)
    sq.poll()
    jsq.poll()
    n1 = len(ups)
    _push(engines, 1000, 400)
    sq.poll()
    jsq.poll()
    assert all(u.mode == "append" for u in ups)
    assert all(u.batch.to_pydict()["time_"].min() >= 1000 for u in ups[n1:])
    got = np.concatenate([u.batch.to_pydict()["time_"] for u in ups])
    want = np.concatenate([u.batch.to_pydict()["time_"] for u in jups])
    assert np.array_equal(got, want)
    assert len(got) == len(set(got.tolist()))  # nothing delivered twice


@pytest.mark.parametrize("appends", [(W,), (300, 300, 300), (W + 5, 2 * W - 5)])
def test_poll_folds_exactly_the_new_rows(appends):
    """A poll starts at a watermark inside a window: it folds the tail's
    new rows only (the tail is staged again as it grows), and ends at
    the one-shot answer."""
    engines = _engines()
    _push(engines, 0, 777)
    sq, jsq, ups, jups = _streams(engines, AGG_Q)
    sq.poll()
    jsq.poll()
    off = 777
    for n in appends:
        _push(engines, off, n)
        off += n
        sq.poll()
        jsq.poll()
        assert sq.last_stats.rows == n
        assert sq.last_stats.windows == (off - 1) // W - (off - n) // W + 1
    _same_updates(ups, jups, key="service")
    one_shot = engines[0].execute_query(AGG_Q)["output"]
    _same(_rows(ups[-1].batch, "service"), _rows(one_shot, "service"))


def test_cancel_stops_run_loop():
    engines = _engines()
    _push(engines, 0, 500)
    cancel = threading.Event()
    ups = []
    sq = stream_query(engines[0], AGG_Q, emit=ups.append, cancel=cancel)
    t = threading.Thread(target=lambda: sq.run(poll_interval_s=0.02), daemon=True)
    t.start()
    deadline = time.time() + 5
    while not ups and time.time() < deadline:
        time.sleep(0.01)
    assert ups
    cancel.set()
    t.join(timeout=5)
    assert not t.is_alive()


REFUSED = {
    "time_bounded": """
import px
df = px.DataFrame(table='http_events', start_time=0, end_time=5)
px.display(df)
""",
    "join": """
import px
a = px.DataFrame(table='http_events')
b = px.DataFrame(table='http_events')
g = a.merge(b, how='inner', left_on=['service'], right_on=['service'],
            suffixes=['', '_r'])
px.display(g)
""",
    "two_aggregates": """
import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('latency_ns', px.count))
df = df.groupby('n').agg(c=('service', px.count))
px.display(df)
""",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unstreamable_plans_refused_like_jax(case):
    engines = _engines()
    _push(engines, 0, 10)
    with pytest.raises(Exception) as jax_err:
        jax_stream_query(engines[1], REFUSED[case], emit=lambda u: None)
    with pytest.raises(Exception) as err:
        stream_query(engines[0], REFUSED[case], emit=lambda u: None)
    assert type(err.value).__name__ == type(jax_err.value).__name__
    assert str(err.value) == str(jax_err.value)


def test_bridge_sink_waits_for_the_distributed_executor():
    """A BridgeSinkOp terminal (the per-agent half of a distributed live
    query) ships each poll's new rows as a row payload, as the JAX
    stream does: same seqs, modes, bridge ids and rows."""
    from pixie_tpu.exec.plan import BridgeSinkOp as JaxBridgeSinkOp
    from pixie_tpu.exec.plan import MemorySourceOp as JaxMemorySourceOp
    from pixie_tpu.exec.plan import Plan as JaxPlan
    from pixie_tpu.exec.streaming import StreamingQuery as JaxStreamingQuery

    engines = _engines()
    _push(engines, 0, 10)
    p, jp = Plan(), JaxPlan()
    p.add(BridgeSinkOp(bridge_id=1), [p.add(MemorySourceOp(table="http_events"))])
    jp.add(JaxBridgeSinkOp(bridge_id=1),
           [jp.add(JaxMemorySourceOp(table="http_events"))])
    ups, jups = [], []
    sq = StreamingQuery(engines[0], p, emit=ups.append)
    jsq = JaxStreamingQuery(engines[1], jp, emit=jups.append)
    assert sq.poll() == jsq.poll() == 10
    _push(engines, 10, 5)
    assert sq.poll() == jsq.poll() == 5
    assert [(u.seq, u.mode, u.bridge_id, u.table) for u in ups] == [
        (u.seq, u.mode, u.bridge_id, u.table) for u in jups
    ] == [(0, "rows", 1, None), (1, "rows", 1, None)]
    for u, j in zip(ups, jups):
        _same(_rows(u.batch.batch), _rows(j.batch.batch))


SHARD_Q = """
import px
df = px.DataFrame(table='t')
df = df[df.shard == 0]
px.display(df['time_', 'v'])
"""

SHARD_AGG_Q = """
import px
df = px.DataFrame(table='t')
df = df[df.shard == 0]
px.display(df.groupby('shard').agg(n=('v', px.count)))
"""


@pytest.mark.parametrize("query", [SHARD_Q, SHARD_AGG_Q], ids=["rows", "agg"])
def test_zone_pruned_tail_commits_the_watermark(query):
    """Windows whose zone maps rule the filter out are never staged; a
    pruned tail still moves the watermark (and an aggregate stream still
    emits, as progress), so later polls do not prune it again."""
    eng, ref = Engine(window_rows=W, device="cpu"), JaxEngine(window_rows=W)
    rel = Relation([("time_", DataType.TIME64NS), ("shard", DataType.INT64),
                    ("v", DataType.INT64)])

    def push(i):
        cols = {"time_": np.arange(i * W, (i + 1) * W, dtype=np.int64),
                "shard": np.full(W, i, dtype=np.int64),
                "v": np.arange(W, dtype=np.int64)}
        eng.append_data("t", cols)
        ref.append_data("t", cols)

    eng.create_table("t", relation=rel)
    push(0)
    ups, jups = [], []
    sq = stream_query(eng, query, emit=ups.append)
    jsq = jax_stream_query(ref, query, emit=jups.append)
    sq.poll()
    jsq.poll()
    for i in (1, 2, 3):
        push(i)
    sq.poll()
    jsq.poll()
    assert sq.last_stats.skipped_windows == 3 and sq.last_stats.windows == 0
    (t,) = eng.table_store.tablets("t")
    (jt,) = ref.table_store.tablets("t")
    assert sq._wm[id(t)] == jsq._wm[id(jt)] == 4 * W
    sq.poll()
    jsq.poll()
    assert sq.last_stats.skipped_windows == 0  # nothing left to prune
    _same_updates(ups, jups)


KEY_Q = """
import px
df = px.DataFrame(table='t')
df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum))
px.display(df)
"""


def test_rebucket_mid_stream_matches_jax():
    """INT64 keys past the state's stats-derived dense domain overflow
    it: the stream doubles its capacity, refolds from the start, and
    ends at the JAX stream's answer and the one-shot's."""
    eng, ref = Engine(window_rows=W, device="cpu"), JaxEngine(window_rows=W)

    def push(off, n, keys):
        rng = np.random.default_rng(off)
        cols = {"time_": np.arange(off, off + n, dtype=np.int64),
                "k": rng.integers(0, keys, n), "v": rng.integers(0, 1000, n)}
        eng.append_data("t", cols)
        ref.append_data("t", cols)

    push(0, 2000, 3)
    sq, jsq, ups, jups = _streams((eng, ref), KEY_Q)
    sq.poll()
    jsq.poll()
    push(2000, 2000, 6000)  # past the domain rounded to 4096
    sq.poll()
    jsq.poll()
    assert sq.last_stats.rebuckets >= 1
    _same_updates(ups, jups, key="k")
    assert len(ups[-1].batch.to_pydict()["k"]) > 100
    one_shot = eng.execute_query(KEY_Q, max_output_rows=1 << 20)["output"]
    _same(_rows(ups[-1].batch, "k"), _rows(one_shot, "k"))


def test_refold_after_expiry_matches_jax():
    """A byte-capped ring expires rows already folded: the state refolds
    from the live rows, as a one-shot rescan counts them."""
    engines = _engines(max_bytes=2000 * 20)
    _push(engines, 0, 1500)
    sq, jsq, ups, jups = _streams(engines, AGG_Q)
    sq.poll()
    jsq.poll()
    for off in range(1500, 6000, 1500):
        _push(engines, off, 1500)
        sq.poll()
        jsq.poll()
    assert engines[0].tables["http_events"].num_rows < 6000
    _same_updates(ups, jups, key="service")
    one_shot = engines[0].execute_query(AGG_Q)["output"]
    _same(_rows(ups[-1].batch, "service"), _rows(one_shot, "service"))


def test_demotion_never_refolds():
    """Demotion into the cold tier moves no first row id: a stream over
    a tiered table folds only the new rows, and stays exact."""
    with override_flag("cold_tier_mb", 64):
        eng = Engine(window_rows=W, device="cpu")
        eng.create_table("http_events", max_bytes=2 * W * 20)
        _push([eng], 0, 2 * W)
        ups = []
        sq = stream_query(eng, AGG_Q, emit=ups.append)
        sq.poll()
        for off in range(2 * W, 6 * W, W):
            _push([eng], off, W)
            sq.poll()
            assert (sq.last_stats.rows, sq.last_stats.windows) == (W, 1)
    st = eng.tables["http_events"].stats()
    assert st.demotions > 0 and st.rows_expired == 0
    one_shot = eng.execute_query(AGG_Q)["output"]
    _same(_rows(ups[-1].batch, "service"), _rows(one_shot, "service"))


def test_prefetched_polls_leak_no_thread():
    eng = Engine(window_rows=W, device="cpu", pipeline_depth=2)
    _push([eng], 0, 5 * W)
    ups = []
    sq = stream_query(eng, ROWS_Q, emit=ups.append)
    sq.poll()
    _push([eng], 5 * W, 3 * W)
    sq.poll()
    assert sq.last_stats.pipeline["depth"] == 2
    assert sq.last_stats.windows == 3
    deadline = time.time() + 5
    while time.time() < deadline and any(
        t.name.startswith("pixie-window-prefetch") for t in threading.enumerate()
    ):
        time.sleep(0.01)
    assert not any(
        t.name.startswith("pixie-window-prefetch") for t in threading.enumerate()
    )


def test_row_limit_ends_the_stream():
    """A row cap on the sink caps the append stream's total rows, as in
    the JAX package; run() ends itself once it is met."""
    engines = _engines()
    _push(engines, 0, 3 * W)
    sq, jsq, ups, jups = _streams(engines, ROWS_Q, max_output_rows=700)
    assert sq.run(poll_interval_s=0.01, max_rounds=5) == jsq.run(
        poll_interval_s=0.01, max_rounds=5)
    assert sum(u.batch.length for u in ups) == 700
    _same_updates(ups, jups)
