"""``px.to_table`` on the port (the engine's ``TableSinkOp`` branch)
against the JAX engine.

Both cases of ``tests/test_aux.py`` (``TestTableSink``): a group-by
written back with ``px.to_table`` beside its ``px.display`` returns only
the displayed table, records ``last_table_sinks``, and a later script
reads the written table; a script whose only sink is ``px.to_table``
returns no client table. Then the live form: a streaming cursor over a
``px.to_table`` script emits its updates under the table's name, as the
JAX stream does. The same seeded rows go to a CPU port engine and to the
JAX engine.
"""

from __future__ import annotations

import numpy as np
import pytest

from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.exec.streaming import stream_query as jax_stream_query
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.streaming import stream_query

ROLLUP = (
    "import px\ndf = px.DataFrame(table='t')\n"
    "agg = df.groupby('v').agg(n=('v', px.count))\n"
    "px.to_table(agg, 'rollup')\npx.display(agg)"
)
READ_ROLLUP = (
    "import px\ndf = px.DataFrame(table='rollup')\n"
    "s = df.groupby('v').agg(total=('n', px.sum))\npx.display(s)"
)
COPY = "import px\ndf = px.DataFrame(table='t')\npx.to_table(df, 'copy')"


def _engines(n: int, mod: int | None):
    v = np.arange(n, dtype=np.int64)
    data = {"time_": np.arange(n, dtype=np.int64),
            "v": v % mod if mod else v}
    port, jax = Engine(device="cpu"), JaxEngine()
    for eng in (port, jax):
        eng.append_data("t", data)
    return port, jax


def _sorted(hb, key):
    d = hb.to_pydict()
    o = np.argsort(np.asarray(d[key]), kind="stable")
    return {k: np.asarray(v)[o] for k, v in d.items()}


def test_px_to_table_write_back():
    n = 5000
    port, jax = _engines(n, 10)
    outs = {}
    for name, eng in (("port", port), ("jax", jax)):
        out = eng.execute_query(ROLLUP)
        assert list(out) == ["output"]  # sinks never pollute client tables
        assert eng.last_table_sinks == {"rollup": 10}
        out2 = eng.execute_query(READ_ROLLUP)["output"]
        assert int(out2.to_pydict()["total"].sum()) == n
        outs[name] = (_sorted(out["output"], "v"), _sorted(out2, "v"),
                      _sorted(eng.tables["rollup"].read_all(), "v"))
    for p, j in zip(outs["port"], outs["jax"]):
        assert p.keys() == j.keys()
        for c in p:
            np.testing.assert_array_equal(p[c], j[c], c)


def test_to_table_only_script_is_valid():
    port, jax = _engines(10, None)
    for eng in (port, jax):
        assert eng.execute_query(COPY) == {}
        assert eng.last_table_sinks == {"copy": 10}
    p = port.tables["copy"].read_all().to_pydict()
    j = jax.tables["copy"].read_all().to_pydict()
    for c in ("time_", "v"):
        np.testing.assert_array_equal(p[c], j[c], c)


def test_sinks_are_per_query():
    """A later query without a sink clears ``last_table_sinks``, and
    repeated writes append to the table."""
    port, jax = _engines(100, 4)
    for eng in (port, jax):
        eng.execute_query(COPY)
        eng.execute_query(COPY)
        assert eng.tables["copy"].read_all().length == 200
        eng.execute_query("import px\npx.display(px.DataFrame(table='t'))")
        assert eng.last_table_sinks == {}


@pytest.mark.parametrize("query,table", [(COPY, "copy"),
                                         (ROLLUP.replace(
                                             "\npx.display(agg)", ""),
                                          "rollup")])
def test_stream_emits_under_the_table_name(query, table):
    """The streaming terminal takes a TableSinkOp as the JAX stream does:
    updates carry the table's name, and nothing is written."""
    port, jax = _engines(300, 7)
    got = {}
    for name, eng, sq_fn in (("port", port, stream_query),
                             ("jax", jax, jax_stream_query)):
        ups = []
        sq = sq_fn(eng, query, emit=ups.append)
        assert sq.poll() == 300
        got[name] = [(u.table, u.mode, u.batch.length) for u in ups]
        assert table not in eng.tables
    assert got["port"] == got["jax"]
    assert got["port"] and all(t == table for t, _m, _n in got["port"])
