"""The ML ops and UDAs: the port against the JAX package, case by case
from ``tests/test_ml.py``.

- reservoirs: a bottom-k sample of 8192 rows is uniform-ish and counts
  every row, and its sampled values equal the JAX package's (both rank
  rows by the same value hash); the merge is associative on both;
- k-means: three separated 2-D clusters are found by both, and the 1-D
  per-group k-means finds the same two centres (atol 0.2);
- the UDAs through each engine over the same seeded table:
  ``px.kmeans`` per service within the JAX case's tolerances and equal
  across packages to 1e-4, ``px.reservoir_sample`` bit-exact on an INT64
  value f32 cannot hold, and a sample drawn from each service's values.

The port's ops run on CPU tensors here.
"""

from __future__ import annotations

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.ops import ml as jax_ml
from pixie_tpu_torch.exec import Engine
from pixie_tpu_torch.ops import ml as port_ml

PKGS = {
    "jax": types.SimpleNamespace(
        ml=jax_ml, asarray=jnp.asarray, zeros_i32=lambda n: jnp.zeros(
            n, dtype=jnp.int32), ones=lambda n: jnp.ones(n, dtype=bool),
        tolist=lambda x: np.asarray(x).tolist(),
        engine=lambda: JaxEngine()),
    "port": types.SimpleNamespace(
        ml=port_ml, asarray=torch.as_tensor, zeros_i32=lambda n: torch.zeros(
            n, dtype=torch.int32), ones=lambda n: torch.ones(
            n, dtype=torch.bool),
        tolist=lambda x: x.tolist(),
        engine=lambda: Engine(device="cpu")),
}


def _both(case):
    """Run ``case(p)`` on each package; returns {package: observation}."""
    return {name: case(p) for name, p in PKGS.items()}


class TestReservoir:
    def test_bottom_k_is_uniformish(self):
        def case(p):
            g, c, n = 1, 64, 8192
            vals = np.arange(n, dtype=np.float64)
            carry = p.ml.reservoir_update(
                p.ml.reservoir_init(g, c), p.zeros_i32(n), p.ones(n),
                p.asarray(vals),
            )
            sampled = np.asarray(p.tolist(carry[0][0]))
            assert float(carry[2][0]) == n
            # A uniform sample of 64 from [0, 8192): mean near 4096.
            assert 2500 < sampled.mean() < 5700
            return sorted(sampled.tolist())

        got = _both(case)
        assert got["port"] == got["jax"]

    def test_merge_associative(self):
        def case(p):
            g, c = 2, 8
            rng = np.random.default_rng(0)

            def mk(seed):
                n = 500
                v = p.asarray(rng.normal(seed, 1, n).astype(np.float32))
                gid = p.asarray(rng.integers(0, g, n).astype(np.int32))
                return p.ml.reservoir_update(
                    p.ml.reservoir_init(g, c), gid, p.ones(n), v)

            a, b, d = mk(0), mk(5), mk(10)
            left = p.ml.reservoir_merge(p.ml.reservoir_merge(a, b), d)
            right = p.ml.reservoir_merge(a, p.ml.reservoir_merge(b, d))
            np.testing.assert_allclose(
                np.sort(np.asarray(p.tolist(left[1]))),
                np.sort(np.asarray(p.tolist(right[1]))), rtol=1e-6)
            np.testing.assert_array_equal(np.asarray(p.tolist(left[2])),
                                          np.asarray(p.tolist(right[2])))
            return (np.sort(np.asarray(p.tolist(left[0])), axis=-1),
                    p.tolist(left[2]))

        got = _both(case)
        np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-6)
        assert got["port"][1] == got["jax"][1]


class TestKMeans:
    def test_kmeans_fit_separated_clusters(self):
        def case(p):
            rng = np.random.default_rng(1)
            pts = np.concatenate([
                rng.normal([0, 0], 0.1, (100, 2)),
                rng.normal([5, 5], 0.1, (100, 2)),
                rng.normal([0, 5], 0.1, (100, 2)),
            ]).astype(np.float32)
            arg = pts if p is PKGS["jax"] else torch.from_numpy(pts)
            cent = np.asarray(p.tolist(p.ml.kmeans_fit(arg, k=3)))
            found = {tuple(np.round(c).astype(int)) for c in cent}
            assert found == {(0, 0), (5, 5), (0, 5)}
            return found

        got = _both(case)
        assert got["port"] == got["jax"]

    def test_kmeans_groups_1d(self):
        def case(p):
            samples = p.asarray(np.array(
                [[1.0, 1.1, 0.9, 10.0, 10.1, 9.9, 0, 0]], dtype=np.float32))
            mask = p.asarray(np.array([[1, 1, 1, 1, 1, 1, 0, 0]], dtype=bool))
            cent = np.asarray(p.tolist(p.ml.kmeans_groups(
                samples, mask, 4, p.asarray(np.array([2])))))
            real = sorted(cent[0][~np.isnan(cent[0])])
            np.testing.assert_allclose(real, [1.0, 10.0], atol=0.2)
            return real

        got = _both(case)
        np.testing.assert_allclose(got["port"], got["jax"], atol=1e-5)


def _events(p):
    e = p.engine()
    rng = np.random.default_rng(2)
    n = 5000
    svc = np.array([f"s{i % 2}" for i in range(n)])
    lat = np.where(
        svc == "s0",
        rng.choice([10.0, 100.0], n),
        rng.choice([1000.0, 5000.0], n),
    )
    e.append_data("events", {
        "time_": np.arange(n, dtype=np.int64),
        "service": list(svc),
        "lat": lat,
    })
    return e


class TestMLUdas:
    def test_kmeans_uda(self):
        def case(p):
            out = _events(p).execute_query(
                "import px\n"
                "df = px.DataFrame(table='events')\n"
                "df = df.groupby('service').agg(c=('lat', px.kmeans, 2))\n"
                "px.display(df, 'o')\n"
            )["o"].to_pydict()
            by_svc = dict(zip(out["service"], out["c"]))
            cents = {}
            for s, want, atol in (("s0", [10.0, 100.0], 5),
                                  ("s1", [1000.0, 5000.0], 200)):
                c = json.loads(by_svc[s])
                got = sorted(v for v in c.values() if v == v)  # drop NaN
                np.testing.assert_allclose(got, want, atol=atol)
                cents[s] = got
            return cents

        got = _both(case)
        for s in ("s0", "s1"):
            np.testing.assert_allclose(got["port"][s], got["jax"][s],
                                       rtol=1e-4)

    def test_reservoir_sample_int64_bit_exact(self):
        big = 10**15 + 7  # not representable in float32

        def case(p):
            e = p.engine()
            e.append_data("t", {"time_": np.arange(4, dtype=np.int64),
                                "v": np.full(4, big, dtype=np.int64)})
            out = e.execute_query(
                "import px\n"
                "df = px.DataFrame(table='t')\n"
                "df = df.agg(s=('v', px.reservoir_sample))\n"
                "px.display(df, 'o')\n"
            )["o"].to_pydict()
            assert int(out["s"][0]) == big
            return int(out["s"][0])

        got = _both(case)
        assert got["port"] == got["jax"] == big

    @pytest.mark.parametrize("pkg", list(PKGS))
    def test_reservoir_sample_uda(self, pkg):
        out = _events(PKGS[pkg]).execute_query(
            "import px\n"
            "df = px.DataFrame(table='events')\n"
            "df = df.groupby('service').agg(s=('lat', px.reservoir_sample))\n"
            "px.display(df, 'o')\n"
        )["o"].to_pydict()
        by_svc = dict(zip(out["service"], out["s"]))
        assert by_svc["s0"] in (10.0, 100.0)
        assert by_svc["s1"] in (1000.0, 5000.0)
