"""The port's native ring (``pixie_tpu_torch/native/table_ring.cc``) and
native hash join (``native/hash_join.cc``) against the JAX package's.

Each case drives the same seeded operations through the port's native
ring, the port's numpy ring and the JAX package's native ring
(``pixie_tpu.table_store.table._NativeBackend``): appends of uneven
sizes, compaction, ``drop_before`` (the cold tier's demotion handoff),
byte-budget expiry, the time index and reads from every position. Every
answer must be equal, bit for bit (the rings copy bytes; nothing is
computed). The join cases hold ``hash_join_call`` and a CPU engine's
``host_hash`` join to the JAX package's, pair for pair and in order.
The loader builds into ``pixie_tpu_torch/_build/`` with g++ and raises
with the compiler's output when a build fails.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.native import hash_join_call as jax_hash_join_call
from pixie_tpu.native import load as jax_load_native
from pixie_tpu.table_store.table import Table as JaxTable
from pixie_tpu.table_store.table import _NativeBackend as JaxNativeBackend
from pixie_tpu_torch import Engine
from pixie_tpu_torch import native
from pixie_tpu_torch.table_store import Table
from pixie_tpu_torch.table_store import table as table_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Plane layouts (time plane first, as Table lays them out): the time
#: plane, an INT64, a UINT128's two u64 planes, a STRING id plane, a
#: BOOLEAN and a FLOAT64.
LAYOUTS = {
    "time_i64": [np.int64, np.int64],
    "all_types": [np.int64, np.int64, np.uint64, np.uint64, np.int32,
                  np.bool_, np.float64],
    "no_time": [np.int64, np.int32, np.float64],
}

#: (ring max_bytes in rows, compacted_rows).
BUDGETS = {"unbounded": (None, 1 << 16), "bounded": (700, 64),
           "small_compaction": (None, 100)}


def _planes(rng, dtypes, t0, n):
    out = []
    for i, d in enumerate(dtypes):
        d = np.dtype(d)
        if i == 0 and d == np.int64:
            out.append(np.arange(t0, t0 + n, dtype=np.int64) * 3)
        elif d == np.uint64:
            out.append(rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
                       + np.uint64(2**63))
        elif d == np.bool_:
            out.append(rng.integers(0, 2, n).astype(bool))
        elif d == np.float64:
            out.append(rng.standard_normal(n))
        else:
            out.append(rng.integers(-1000, 1000, n).astype(d))
    return out


def _rings(dtypes, has_time, budget):
    rows, compacted = BUDGETS[budget]
    row_bytes = sum(np.dtype(d).itemsize for d in dtypes)
    max_bytes = -1 if rows is None else rows * row_bytes
    args = ([np.dtype(d) for d in dtypes], has_time, compacted, max_bytes)
    return {
        "port_native": table_mod._NativeBackend(
            native.load("table_ring"), *args),
        "port_numpy": table_mod._PyBackend(*args),
        "jax_native": JaxNativeBackend(jax_load_native("table_ring"), *args),
    }


def _script(rng, dtypes, has_time):
    """The seeded operation sequence: (op, args) tuples."""
    ops, t = [], 0
    for n in (37, 300, 1, 129, 64, 211, 5, 400):
        ops.append(("append", _planes(rng, dtypes, t, n)))
        t += n
        ops.append(("read", (int(rng.integers(0, t)), int(rng.integers(1, 500)))))
        if n in (129, 5):
            ops.append(("compact", ()))
        if n == 64:
            ops.append(("drop_before", (int(rng.integers(t // 4, t // 2)),)))
    for probe in (-1, 0, 3 * 150, 3 * t // 2 + 1, 3 * t + 10):
        for strict in (False, True):
            ops.append(("row_id_for_time", (probe, strict)))
    ops.append(("read", (0, 10_000)))
    return ops


def _apply(ring, op, args, has_time):
    if op == "append":
        return ring.append(args, args[0] if has_time else None)
    if op == "read":
        planes, first, n = ring.read(*args)
        return [p.tobytes() for p in planes], first, n
    if op == "compact":
        return ring.compact()
    if op == "drop_before":
        return ring.drop_before(*args)
    return ring.row_id_for_time(*args)


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ring_matches_jax_native_ring(layout, budget):
    dtypes = LAYOUTS[layout]
    has_time = layout != "no_time"
    rings = _rings(dtypes, has_time, budget)
    ops = _script(np.random.default_rng(5), dtypes, has_time)
    for op, args in ops:
        got = {k: _apply(r, op, args, has_time) for k, r in rings.items()}
        ref = got.pop("jax_native")
        for k, v in got.items():
            assert v == ref, (k, op)
        stats = {k: r.stats() for k, r in rings.items()}
        for k in ("port_native", "port_numpy"):
            assert stats[k] == stats["jax_native"], (k, op, stats)
        ends = {(r.first_row_id(), r.end_row_id()) for r in rings.values()}
        assert len(ends) == 1, (op, ends)


def test_drop_before_is_not_expiry():
    """drop_before splits the straddling batch, keeps its tail and moves
    none of the expiry counters (the demotion handoff)."""
    dtypes = LAYOUTS["time_i64"]
    for name, ring in _rings(dtypes, True, "unbounded").items():
        rng = np.random.default_rng(1)
        ring.append(_planes(rng, dtypes, 0, 100), np.arange(100) * 3)
        ring.append(_planes(rng, dtypes, 100, 100), np.arange(100, 200) * 3)
        assert ring.drop_before(150) == 150, name
        st = ring.stats()
        assert st[5] == 0, name  # batches_expired
        assert st[9] == 50, name  # live rows
        planes, first, n = ring.read(0, 1000)
        assert (first, n) == (150, 50), name
        assert np.array_equal(planes[0], np.arange(150, 200) * 3), name
        # The tail's time summary was recomputed: the index finds it.
        assert ring.row_id_for_time(3 * 160, False) == 160, name


@pytest.mark.parametrize("ring", ["native", "numpy"])
def test_table_all_dtypes_match_jax_table(ring, monkeypatch):
    """Table.append on each ring reads back, as a whole and by time, what
    the JAX Table holds after the same appends, with the same stats."""
    if ring == "numpy":
        monkeypatch.setattr(table_mod, "load_native", lambda name: None)
    rng = np.random.default_rng(3)
    port, ref = Table("t", max_bytes=40 * 1024), JaxTable("t", max_bytes=40 * 1024)
    for r in range(9):
        n = 100 + 37 * r
        hi = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
        lo = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
        batch = {
            "time_": np.arange(1000 * r, 1000 * r + n, dtype=np.int64),
            "flag": rng.integers(0, 2, n).astype(bool),
            "i": rng.integers(-(2**62), 2**62, n),
            "u": np.stack([hi, lo], axis=1),
            "f": rng.random(n),
            "s": [f"s{j % 7}" for j in range(n)],
        }
        port.append(batch)
        ref.append(batch)
    want = type(port._backend).__name__
    assert want == ("_NativeBackend" if ring == "native" else "_PyBackend")
    a, b = port.read_all().to_pydict(), ref.read_all().to_pydict()
    assert a.keys() == b.keys()
    for c in a:
        assert np.array_equal(np.asarray(a[c]), np.asarray(b[c])), c
    sp, sr = port.stats(), ref.stats()
    for f in ("bytes", "num_batches", "batches_added", "batches_expired",
              "bytes_added", "min_time", "num_rows", "rows_added",
              "rows_expired", "bytes_expired", "watermark"):
        assert getattr(sp, f) == getattr(sr, f), f
    for t in (0, 4100, 5000, 8200, 99999):
        assert port.row_id_for_time(t, False) == ref.row_id_for_time(t, False)
    assert port.compact() == ref.compact()
    assert port.stats().compacted_batches == ref.stats().compacted_batches
    a = port.read_all().to_pydict()
    assert np.array_equal(a["i"], b["i"])


def test_tables_take_the_native_ring_by_default():
    eng = Engine(window_rows=1024, device="cpu")
    eng.append_data("t", {"time_": np.arange(10), "v": np.arange(10)})
    assert isinstance(eng.tables["t"]._backend, table_mod._NativeBackend)


def test_library_builds_into_the_port_build_dir():
    lib = native.load("table_ring")
    path = native.library_path("table_ring")
    assert path.parent == native.BUILD_DIR
    assert str(path).startswith(os.path.join(REPO, "pixie_tpu_torch", "_build"))
    assert path.exists() and isinstance(lib, ctypes.CDLL)
    assert native.load("table_ring") is lib  # loaded once per process


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "table_ring.cc").write_text(
        "extern \"C\" int pxt_table_create( { this is not C++\n"
    )
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(native.NativeBuildError) as ei:
        native.load("table_ring")
    assert "table_ring.cc" in str(ei.value) and "error" in str(ei.value)
    assert not (tmp_path / "build" / "libtable_ring.so").exists()
    assert list((tmp_path / "build").glob("*.tmp.so")) == []
    # A table cannot come up on a ring that did not build: the error
    # reaches the caller instead of a quiet numpy ring.
    with pytest.raises(native.NativeBuildError):
        Table("t", max_bytes=-1).append({"time_": np.arange(3)})


def test_missing_compiler_raises(tmp_path, monkeypatch):
    (tmp_path / "hash_join.cc").write_text("int x;\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        native.load("hash_join")


def test_np_view_shares_host_memory():
    a = np.arange(5)
    assert native.np_view(a) is a
    t = torch.arange(6, dtype=torch.int64)
    v = native.np_view(t)
    v_ptr = v.__array_interface__["data"][0]
    assert v_ptr == t.data_ptr() and v.tolist() == list(range(6))
    u = torch.tensor([1, 2], dtype=torch.int64).view(torch.uint64)
    assert native.np_view(u).dtype == np.uint64


# -- the hash join -----------------------------------------------------------------
JOIN_CASES = {
    # name: (build rows, probe rows, key range, left_outer)
    "unique_inner": (500, 2000, 10_000, False),
    "fan_out_inner": (3000, 2000, 100, False),
    "fan_out_left": (3000, 2000, 150, True),
    "sparse_left": (200, 5000, 1 << 40, True),
    "single_key": (50, 70, 1, False),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_hash_join_call_matches_jax(case):
    nb, npr, span, left = JOIN_CASES[case]
    rng = np.random.default_rng(len(case))
    bk = rng.integers(0, span, nb)
    pk = rng.integers(0, span, npr)
    got = native.hash_join_call(bk, pk, left_outer=left)
    ref = jax_hash_join_call(bk, pk, left_outer=left)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    # Every pair joins equal keys; unmatched probes only for a left join.
    matched = got[1] >= 0
    assert np.array_equal(bk[got[1][matched]], pk[got[0][matched]])
    assert left or matched.all()


def test_cpu_engine_host_hash_join_matches_jax():
    """A CPU engine's N:M join routes to host_hash, now the native join,
    and gives the JAX engine's rows in the JAX engine's order."""
    q = (
        "import px\n"
        "a = px.DataFrame(table='a')\n"
        "b = px.DataFrame(table='b')\n"
        "j = a.merge(b, how='inner', left_on=['k'], right_on=['k'],"
        " suffixes=['', '_b'])\n"
        "px.display(j[['k', 'v', 'w']])\n"
    )
    rng = np.random.default_rng(9)
    tables = {
        "a": {"time_": np.arange(6000), "k": rng.integers(0, 40, 6000),
              "v": rng.integers(0, 1 << 30, 6000)},
        "b": {"time_": np.arange(900), "k": rng.integers(0, 40, 900),
              "w": rng.integers(0, 1 << 30, 900)},
    }
    eng, ref = Engine(window_rows=1024, device="cpu"), JaxEngine(window_rows=1024)
    for name, cols in tables.items():
        eng.append_data(name, cols)
        ref.append_data(name, cols)
    got = eng.execute_query(q, max_output_rows=1 << 20)["output"].to_pydict()
    assert eng.last_join_decision.strategy == "host_hash"
    want = ref.execute_query(q, max_output_rows=1 << 20)["output"].to_pydict()
    assert len(got["k"]) == len(want["k"]) > 6000
    for c in ("k", "v", "w"):
        assert np.array_equal(got[c], want[c]), c


@pytest.mark.parametrize("ring", ["native", "numpy"])
def test_concurrent_appends_to_a_new_table(ring, monkeypatch):
    """Threads pushing into one table created without a relation (a
    collector's thread and a flush from another thread) all land: the
    first append builds the ring while the others wait for it."""
    import threading

    if ring == "numpy":
        monkeypatch.setattr(table_mod, "load_native", lambda name: None)
    for trial in range(20):
        t = Table(f"t{trial}")
        start = threading.Barrier(4)
        errors = []

        def push(i):
            start.wait()
            try:
                t.append({"time_": np.arange(i * 8, i * 8 + 8, dtype=np.int64),
                          "s": [f"v{i}"] * 8})
            except Exception as e:  # an append that lost the race
                errors.append(e)

        threads = [threading.Thread(target=push, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert errors == []
        assert t.num_rows == 32
        assert sorted(set(t.dicts["s"].strings)) == ["v0", "v1", "v2", "v3"]
