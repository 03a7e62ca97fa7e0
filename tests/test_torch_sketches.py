"""The ingest sketches and their consumers: the port against the JAX
package, case by case from ``tests/test_sketches.py``.

- the HLL registers: the port's device ``hll_update`` (on the CPU here)
  equals its own numpy ``hll_update_np`` and the JAX ``hll_update_np``
  bit for bit, and the JAX device kernel's registers too; estimates and
  incremental folds are equal across packages;
- ``ColumnSketch`` zone maps, NDV and its bounded zone ring;
- an append maintains the table's sketches (and the flag disables
  them), and the engine's compile-time table stats read them;
- the consumers: join routing stats from sketches (through renames in
  reverse), the join capacity estimate, and the planner's partial
  aggregate sized from NDV.

Every case checks the JAX case's own assertions on both packages, and
the two packages' observations must be equal.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixie_tpu.ops.hll as jax_hll
import pixie_tpu_torch.ops.hll as port_hll
from pixie_tpu import config as jax_config
from pixie_tpu.exec import joins as jax_joins
from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.exec import stream as jax_stream
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.table_store import Table as JaxTable
from pixie_tpu.table_store import sketches as jax_sketches
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.udf.registry import default_registry as jax_registry
from pixie_tpu_torch import config as port_config
from pixie_tpu_torch.exec import joins as port_joins
from pixie_tpu_torch.exec import plan as port_plan
from pixie_tpu_torch.exec import stream as port_stream
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.table_store import Table
from pixie_tpu_torch.table_store import sketches as port_sketches
from pixie_tpu_torch.types.dtypes import DataType
from pixie_tpu_torch.types.relation import Relation
from pixie_tpu_torch.udf.registry import default_registry

PKGS = {
    "jax": types.SimpleNamespace(
        hll=jax_hll, sketches=jax_sketches, config=jax_config,
        joins=jax_joins, plan=jax_plan, stream=jax_stream, Table=JaxTable,
        engine=lambda: JaxEngine(window_rows=1 << 12),
        CompilerState=JaxCompilerState, compile_pxl=jax_compile_pxl,
        DataType=JaxDataType, Relation=JaxRelation, registry=jax_registry),
    "port": types.SimpleNamespace(
        hll=port_hll, sketches=port_sketches, config=port_config,
        joins=port_joins, plan=port_plan, stream=port_stream, Table=Table,
        engine=lambda: Engine(window_rows=1 << 12, device="cpu"),
        CompilerState=CompilerState, compile_pxl=compile_pxl,
        DataType=DataType, Relation=Relation, registry=default_registry),
}


def _both(case):
    """Run ``case(p)`` on each package; the observations must agree."""
    got = {name: case(p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


class TestNumpyHLLMirror:
    def test_registers_bit_identical_to_device_kernel(self):
        rng = np.random.default_rng(7)
        vals = rng.integers(-(1 << 40), 1 << 40, 5000)
        n = len(vals)
        jax_host = jax_hll.hll_update_np(jax_hll.hll_init_np(), vals)
        jax_dev = np.asarray(jax_hll.hll_update(
            jax_hll.hll_init(1), jnp.zeros(n, dtype=jnp.int32),
            jnp.ones(n, dtype=bool), jnp.asarray(vals),
        ))[0]
        np.testing.assert_array_equal(jax_host, jax_dev)
        cpu = torch.device("cpu")
        port_host = port_hll.hll_update_np(port_hll.hll_init_np(), vals)
        port_dev = port_hll.hll_update(
            port_hll.hll_init(1, cpu), torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool), torch.from_numpy(vals),
        ).numpy()[0]
        np.testing.assert_array_equal(port_dev, port_host)
        np.testing.assert_array_equal(port_dev, jax_host)

    def test_estimate_accuracy(self):
        def case(p):
            rng = np.random.default_rng(11)
            ests = []
            for true_n in (50, 5_000, 200_000):
                vals = rng.integers(0, true_n, 4 * true_n)
                est = p.hll.hll_estimate_np(
                    p.hll.hll_update_np(p.hll.hll_init_np(), vals))
                assert abs(est - true_n) / true_n < 0.12, (true_n, est)
                ests.append(float(est))
            return ests

        _both(case)

    def test_incremental_equals_one_shot(self):
        def case(p):
            rng = np.random.default_rng(13)
            vals = rng.integers(0, 10_000, 30_000)
            one = p.hll.hll_update_np(p.hll.hll_init_np(), vals)
            inc = p.hll.hll_init_np()
            for chunk in np.array_split(vals, 7):
                p.hll.hll_update_np(inc, chunk)
            np.testing.assert_array_equal(one, inc)
            return one.tolist()

        _both(case)


class TestColumnSketch:
    def test_zone_maps_and_ndv(self):
        def case(p):
            s = p.sketches.ColumnSketch()
            s.update(np.arange(100, 200, dtype=np.int64), row0=0)
            s.update(np.arange(500, 600, dtype=np.int64), row0=100)
            assert (s.lo, s.hi) == (100, 599)
            assert s.rows == 200
            assert abs(s.ndv - 200) <= 20
            assert s.window_zone(0, 100) == (100, 199)
            assert s.window_zone(100, 200) == (500, 599)
            assert s.window_zone(50, 150) == (100, 599)  # spans both
            assert s.window_zone(200, 300) is None  # unsketched range
            return s.lo, s.hi, s.rows, int(s.ndv)

        _both(case)

    def test_zone_ring_bounded(self):
        def case(p):
            cap = p.sketches.MAX_ZONE_ENTRIES
            s = p.sketches.ColumnSketch()
            for i in range(2 * cap + 10):
                s.update(np.array([i], dtype=np.int64), row0=i)
            assert len(s.zones) <= cap + 1
            # Coverage stays total after merges.
            assert s.window_zone(0, 2 * cap) is not None
            return cap, len(s.zones), s.window_zone(0, 2 * cap)

        _both(case)


class TestTableIngest:
    def test_append_maintains_sketches(self):
        def case(p):
            eng = p.engine()
            rng = np.random.default_rng(3)
            n = 20_000
            eng.append_data("t", {
                "time_": np.arange(n, dtype=np.int64),
                "k": rng.integers(0, 700, n),
                "s": [f"x{i % 40}" for i in range(n)],
            })
            sk = eng.tables["t"].sketches
            assert sk.rows == n
            assert abs(sk.ndv("k") - 700) < 70
            assert abs(sk.ndv("s") - 40) <= 4  # dictionary code plane
            assert sk.col("time_") is None  # time_ is not sketched
            stats = eng._compile_table_stats()
            assert stats["t"]["rows"] == n
            assert "k" in stats["t"]["ndv"]
            return sk.rows, int(sk.ndv("k")), int(sk.ndv("s")), \
                sorted(stats["t"]["ndv"])

        _both(case)

    def test_flag_disables_sketches(self):
        def case(p):
            with p.config.override_flag("ingest_sketches", False):
                t = p.Table("t")
                t.append({"k": np.arange(10, dtype=np.int64)}, time_cols=())
            assert t.sketches is None
            return t.num_rows

        _both(case)


class TestRoutingConsumers:
    def test_stream_join_stats_from_sketches(self):
        def case(p):
            eng = p.engine()
            rng = np.random.default_rng(5)
            n = 10_000
            eng.append_data("t", {
                "time_": np.arange(n, dtype=np.int64),
                "k": rng.integers(50, 450, n),
            })
            t = eng.tables["t"]
            st = p.stream._Stream(t.relation, dict(t.dicts), [], [t],
                                  p.plan.MemorySourceOp(table="t"))
            stats = p.joins.stream_join_stats(st, ("k",))
            assert stats is not None and stats.origin == "sketch"
            assert stats.rows == n
            assert (stats.lo, stats.hi) == (50, 449)
            assert abs(stats.ndv - 400) < 40
            return stats.origin, stats.rows, stats.lo, stats.hi, \
                int(stats.ndv)

        _both(case)

    def test_stream_join_stats_traces_renames_in_reverse(self):
        """Chains are in application order; tracing an output key back to
        its source column walks them newest map first (k <- a <- b)."""
        def case(p):
            eng = p.engine()
            n = 5_000
            eng.append_data("t", {
                "time_": np.arange(n, dtype=np.int64),
                "a": np.arange(n, dtype=np.int64) % 10,  # ndv 10
                "b": np.arange(n, dtype=np.int64) % 1000,  # ndv 1000
            })
            t = eng.tables["t"]
            ref = p.plan.ColumnRef
            chain = [
                p.plan.MapOp(exprs=(("a", ref("b")),)),  # a carries b
                p.plan.MapOp(exprs=(("k", ref("a")),)),  # k <- a (<- b)
            ]
            st = p.stream._Stream(t.relation, dict(t.dicts), chain, [t],
                                  p.plan.MemorySourceOp(table="t"))
            stats = p.joins.stream_join_stats(st, ("k",))
            assert stats is not None
            # k's values are column b's: NDV ~1000, zone [0, 999].
            assert abs(stats.ndv - 1000) < 100
            assert (stats.lo, stats.hi) == (0, 999)
            return int(stats.ndv), stats.lo, stats.hi

        _both(case)

    def test_capacity_estimate_math(self):
        def case(p):
            jss, est = p.joins.JoinSideStats, p.joins.estimate_join_capacity
            build = jss(rows=10_000, lo=0, hi=999, ndv=1_000)
            probe = jss(rows=4_096, lo=0, hi=999)
            cap = est(4_096, build, probe, "inner")
            # fanout 10 x 4096 x 2.0 safety -> 82k -> bucketed pow2.
            assert cap == 131_072
            probe_far = jss(rows=4_096, lo=5_000, hi=9_999)
            far = est(4_096, build, probe_far, "inner")
            # Non-overlapping zones floor out at the minimum bucket.
            assert far <= 2_048
            # Left joins emit every probe row even when nothing matches.
            left = est(4_096, build, probe_far, "left")
            assert left >= 4_096
            return cap, far, left

        _both(case)

    def test_planner_partial_agg_sized_from_ndv(self):
        q = """
import px
l = px.DataFrame(table='t')
r = px.DataFrame(table='t')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('v_r', px.count))
px.display(out)
"""

        def case(p):
            DT = p.DataType
            rel = p.Relation([
                ("time_", DT.TIME64NS), ("k", DT.INT64),
                ("b", DT.INT64), ("v", DT.INT64),
            ])

            def partial_groups(**kw):
                state = p.CompilerState(schemas={"t": rel},
                                        registry=p.registry(), **kw)
                plan = p.compile_pxl(q, state).plan
                return [
                    n.op.max_groups for n in plan.nodes.values()
                    if isinstance(n.op, p.plan.AggOp)
                    and n.op.group_cols == ("k",)
                ]

            sized = partial_groups(
                table_stats={"t": {"rows": 50_000, "ndv": {"k": 3_000}}})
            assert sized, "eager-agg rewrite did not fire"
            # 3000 * 1.25 slack -> next pow2 = 4096 (not the blind 64K).
            assert sized[0] == 4_096
            # Without stats the 64K default stands.
            blind = partial_groups()
            assert blind[0] == 1 << 16
            return sized, blind

        _both(case)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_registers_match_numpy_per_group(seed):
    """Grouped and masked: each group's row of the port's device
    registers equals the numpy fold of that group's unmasked values, and
    the JAX device kernel's registers."""
    rng = np.random.default_rng(seed)
    n, g = 4000, 5
    vals = rng.integers(-(1 << 50), 1 << 50, n)
    gids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    port = port_hll.hll_update(
        port_hll.hll_init(g, torch.device("cpu")), torch.from_numpy(gids),
        torch.from_numpy(mask), torch.from_numpy(vals),
    ).numpy()
    jax_dev = np.asarray(jax_hll.hll_update(
        jax_hll.hll_init(g), jnp.asarray(gids), jnp.asarray(mask),
        jnp.asarray(vals),
    ))
    np.testing.assert_array_equal(port, jax_dev)
    for k in range(g):
        sel = vals[(gids == k) & mask]
        np.testing.assert_array_equal(
            port[k], port_hll.hll_update_np(port_hll.hll_init_np(), sel))
