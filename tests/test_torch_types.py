"""The type system and columnar core (``types/``): the port against the
JAX package, case by case from ``tests/test_types.py``.

Each case runs on both packages with the same inputs, checks the JAX
case's own assertions on each, and the two packages' observations
(column names, types, ids, decoded strings, planes) must be equal. The
port's ``HostBatch.to_device`` takes its capacity and device explicitly
(the CPU here); the JAX one defaults both. ``test_pytree_through_jit`` is
JAX-only by nature (the pytree protocol through ``jax.jit``); its
counterpart passes the port's ``DeviceBatch`` through a plain function
and back.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixie_tpu.types as jax_types
import pixie_tpu_torch.types as port_types

CPU = torch.device("cpu")

PKGS = {
    "jax": types.SimpleNamespace(
        t=jax_types, to_device=lambda hb: hb.to_device(),
        asnumpy=np.asarray),
    "port": types.SimpleNamespace(
        t=port_types,
        to_device=lambda hb: hb.to_device(
            port_types.bucket_capacity(hb.length), CPU),
        asnumpy=lambda x: x.numpy()),
}


def _both(case):
    """Run ``case(p)`` on each package; the observations must agree."""
    got = {name: case(p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _cols(hb) -> dict:
    return {c: [p.tolist() for p in ps] for c, ps in hb.cols.items()}


class TestRelation:
    def test_basic(self):
        def case(p):
            DT = p.t.DataType
            r = p.t.Relation({"time_": DT.TIME64NS, "latency": DT.FLOAT64})
            assert r.column_names == ("time_", "latency")
            assert r.col_type("latency") == DT.FLOAT64
            assert r.col_index("latency") == 1
            assert len(r) == 2
            return r.column_names, r.col_type("latency").name

        _both(case)

    def test_duplicate_rejected(self):
        def case(p):
            DT = p.t.DataType
            with pytest.raises(ValueError) as ei:
                p.t.Relation([("a", DT.INT64), ("a", DT.INT64)])
            return str(ei.value)

        _both(case)

    def test_select_add_merge(self):
        def case(p):
            DT = p.t.DataType
            r = p.t.Relation({"a": DT.INT64, "b": DT.STRING})
            assert r.select(["b"]).column_names == ("b",)
            r2 = r.add("c", DT.FLOAT64)
            assert r2.column_names == ("a", "b", "c")
            merged = r.merge(p.t.Relation({"a": DT.INT64, "d": DT.BOOLEAN}))
            assert merged.column_names == ("a", "b", "a_y", "d")
            return r2.column_names, merged.column_names

        _both(case)

    def test_hash_eq(self):
        def case(p):
            DT = p.t.DataType
            r1 = p.t.Relation({"a": DT.INT64})
            r2 = p.t.Relation({"a": DT.INT64})
            assert r1 == r2 and hash(r1) == hash(r2)
            return r1 == r2

        _both(case)


class TestStringDictionary:
    def test_encode_decode_roundtrip(self):
        def case(p):
            d = p.t.StringDictionary()
            ids = d.encode(["GET", "POST", "GET", "PUT"])
            assert ids.dtype == np.int32
            assert list(ids) == [0, 1, 0, 2]
            out = list(d.decode(ids))
            assert out == ["GET", "POST", "GET", "PUT"]
            return ids.tolist(), out

        _both(case)

    def test_lookup_missing(self):
        def case(p):
            d = p.t.StringDictionary(["a"])
            assert d.lookup("a") == 0
            assert d.lookup("zz") == -1
            return d.lookup("a"), d.lookup("zz")

        _both(case)

    def test_transform(self):
        def case(p):
            d = p.t.StringDictionary(
                ["/api/v1/users/123", "/api/v1/users/456", "/health"])
            new, remap = d.transform(
                lambda s: s.rsplit("/", 1)[0] if s[-1].isdigit() else s)
            assert new.strings == ["/api/v1/users", "/health"]
            assert list(remap) == [0, 0, 1]
            return new.strings, list(remap)

        _both(case)

    def test_union(self):
        def case(p):
            a = p.t.StringDictionary(["x", "y"])
            b = p.t.StringDictionary(["y", "z"])
            merged, ra, rb = a.union(b)
            assert merged.strings == ["x", "y", "z"]
            assert list(ra) == [0, 1]
            assert list(rb) == [1, 2]
            return merged.strings, list(ra), list(rb)

        _both(case)


class TestHostBatch:
    def test_infer_relation(self):
        def case(p):
            DT = p.t.DataType
            hb = p.t.HostBatch.from_pydict({
                "time_": np.arange(5, dtype=np.int64),
                "latency": np.linspace(0, 1, 5),
                "service": ["a", "b", "a", "c", "b"],
                "ok": np.array([True, False, True, True, False]),
            })
            assert hb.relation.col_type("time_") == DT.TIME64NS
            assert hb.relation.col_type("latency") == DT.FLOAT64
            assert hb.relation.col_type("service") == DT.STRING
            assert hb.relation.col_type("ok") == DT.BOOLEAN
            assert hb.length == 5
            out = hb.to_pydict()
            assert list(out["service"]) == ["a", "b", "a", "c", "b"]
            return ([(c, t.name) for c, t in hb.relation.items()],
                    _cols(hb))

        _both(case)

    def test_uint128(self):
        vals = [(1 << 70) + 5, 7]

        def case(p):
            hb = p.t.HostBatch.from_pydict(
                {"upid": vals},
                relation=p.t.Relation({"upid": p.t.DataType.UINT128}),
            )
            hi, lo = hb.cols["upid"]
            assert hi.dtype == np.uint64 and lo.dtype == np.uint64
            assert int(hi[0]) == (vals[0] >> 64)
            assert int(lo[0]) == vals[0] & ((1 << 64) - 1)
            assert int(hi[1]) == 0 and int(lo[1]) == 7
            return _cols(hb)

        _both(case)


class TestDeviceBatch:
    def test_bucket_capacity(self):
        def case(p):
            bc = p.t.bucket_capacity
            assert bc(0) == p.t.MIN_CAPACITY
            assert bc(1024) == 1024
            assert bc(1025) == 2048
            return p.t.MIN_CAPACITY, [bc(n) for n in (0, 1, 1024, 1025)]

        _both(case)

    def test_roundtrip(self):
        def case(p):
            hb = p.t.HostBatch.from_pydict({
                "time_": np.arange(10, dtype=np.int64),
                "latency": np.arange(10, dtype=np.float64),
                "service": ["s%d" % (i % 3) for i in range(10)],
            })
            db = p.to_device(hb)
            assert db.capacity == p.t.MIN_CAPACITY
            assert int(db.n_valid()) == 10
            back = db.to_host(dicts=hb.dicts)
            np.testing.assert_array_equal(back.cols["time_"][0],
                                          hb.cols["time_"][0])
            assert (list(back.to_pydict()["service"])
                    == list(hb.to_pydict()["service"]))
            return db.capacity, _cols(back)

        _both(case)

    def test_pytree_through_jit(self):
        """JAX: the batch is a pytree through ``jax.jit``. Port: the same
        function on the port's ``DeviceBatch``, eagerly, with the same
        planes and mask out."""
        def double(b):
            return b.with_cols({"x": (b.plane("x") * 2,)}, b.relation)

        def case(p):
            hb = p.t.HostBatch.from_pydict({"x": np.arange(8, dtype=np.int64)})
            db = p.to_device(hb)
            fn = jax.jit(double) if p is PKGS["jax"] else double
            out = fn(db)
            got = p.asnumpy(out.plane("x"))[:8]
            np.testing.assert_array_equal(got, np.arange(8) * 2)
            assert int(out.n_valid()) == 8  # the mask survives
            return got.tolist(), int(out.n_valid())

        _both(case)

    def test_mask_semantics(self):
        def case(p):
            hb = p.t.HostBatch.from_pydict({"x": np.arange(6, dtype=np.int64)})
            db = p.to_device(hb)
            filtered = db.with_valid(db.valid & (db.plane("x") % 2 == 0))
            back = filtered.to_host()
            np.testing.assert_array_equal(back.cols["x"][0], [0, 2, 4])
            return back.cols["x"][0].tolist()

        _both(case)

    def test_int64_preserved(self):
        big = np.array([2**40 + 1, -(2**50)], dtype=np.int64)

        def case(p):
            db = p.to_device(
                p.t.HostBatch.from_pydict({"t": big}, time_cols=()))
            want = jnp.int64 if p is PKGS["jax"] else torch.int64
            assert db.plane("t").dtype == want
            got = p.asnumpy(db.plane("t"))[:2]
            np.testing.assert_array_equal(got, big)
            return got.tolist()

        _both(case)


class TestReviewRegressions:
    def test_shared_empty_dict_is_used(self):
        def case(p):
            shared = p.t.StringDictionary()
            b1 = p.t.HostBatch.from_pydict({"s": ["a", "b"]},
                                           dicts={"s": shared})
            b2 = p.t.HostBatch.from_pydict({"s": ["b", "a"]},
                                           dicts={"s": shared})
            assert b1.dicts["s"] is shared and b2.dicts["s"] is shared
            np.testing.assert_array_equal(b1.cols["s"][0], [0, 1])
            np.testing.assert_array_equal(b2.cols["s"][0], [1, 0])
            return _cols(b1), _cols(b2), shared.strings

        _both(case)

    def test_pre_encoded_int64_ids(self):
        def case(p):
            d = p.t.StringDictionary(["x", "y"])
            hb = p.t.HostBatch.from_pydict(
                {"s": np.array([0, 1], dtype=np.int64)},
                relation=p.t.Relation({"s": p.t.DataType.STRING}),
                dicts={"s": d},
            )
            assert hb.cols["s"][0].dtype == np.int32
            assert list(hb.to_pydict()["s"]) == ["x", "y"]
            assert d.strings == ["x", "y"]  # not polluted with "0"/"1"
            return _cols(hb), d.strings

        _both(case)

    def test_eos_passthrough(self):
        def case(p):
            hb = p.t.HostBatch.from_pydict({"x": [1, 2]})
            out = p.to_device(hb).to_host(eow=True, eos=True)
            assert out.eow and out.eos
            return out.eow, out.eos, _cols(out)

        _both(case)

    def test_merge_suffix_collision(self):
        def case(p):
            DT = p.t.DataType
            r = p.t.Relation({"a": DT.INT64, "a_y": DT.INT64})
            merged = r.merge(p.t.Relation({"a": DT.INT64}))
            assert merged.column_names == ("a", "a_y", "a_y_y")
            return merged.column_names

        _both(case)

    def test_encode_generator(self):
        def case(p):
            d = p.t.StringDictionary()
            ids = d.encode(s for s in ["a", "b", "a"])
            assert list(ids) == [0, 1, 0]
            return ids.tolist()

        _both(case)

    def test_decode_vectorized_null(self):
        def case(p):
            d = p.t.StringDictionary(["a"])
            out = list(d.decode(np.array([0, -1, 5], dtype=np.int32)))
            assert out == ["a", None, None]
            return out

        _both(case)
