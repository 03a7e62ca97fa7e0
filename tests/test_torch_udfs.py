"""The port's remaining builtins against the JAX package's.

- every dictionary-side (HOST_DICT) scalar UDF over one seeded string
  vocabulary: equal results, string for string (``nslookup``'s resolver
  stubbed, so no test depends on a network);
- ``select`` and the protocol tables (codes in and out of range, and
  codes that wrap when truncated to int32): equal dictionary ids and
  equal output dictionaries;
- the device HLL: registers bit-identical to the JAX package's
  ``hll_update`` and to the port's own numpy mirror, estimates equal;
- the bottom-k reservoir and k-means: priorities exact; reservoirs
  compared as sets of priorities per group, and by value where the
  priorities are distinct (tie order in ``top_k`` may differ); k-means
  centroids at rtol 1e-5 (f32 sums in another order);
- ``count_distinct``, ``reservoir_sample``, ``kmeans`` and
  ``select`` through queries on both engines (distinct counts and
  samples exact, centroids rtol 1e-5);
- the seven introspection UDTFs: equal rows on two engines with the
  same tables (``GetVersion``'s uptime aside).
"""

import json
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.ops import hll as jax_hll
from pixie_tpu.ops import ml as jax_ml
from pixie_tpu.udf.builtins import net_ops as jax_net_ops
from pixie_tpu.udf.registry import default_registry as jax_registry
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu_torch import Engine
from pixie_tpu_torch.ops import hll, ml
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.builtins import net_ops
from pixie_tpu_torch.udf.registry import default_registry


def _vocab(seed=3, n=120):
    """Strings the dictionary-side UDFs care about: paths with ids, SQL,
    PII, JSON, addresses, namespaced pod names, padded numbers."""
    rng = np.random.default_rng(seed)
    out = [
        "", "  42 ", "-7", "abc", "ns/pod-1", "pod-2", "a/b/c",
        "/api/v1/users/12345/orders", "/api/v1/users/9f86d081884c7d65/x",
        "/api/items/3fa85f64-5717-4562-b3fc-2c963f66afa6?x=1", "api/v2/ab12cd34ef",
        "SELECT * FROM t WHERE id = 42 AND name = 'bob'",
        "select a from b where c in (1, 2, 3)", 'UPDATE t SET x="y" WHERE z=3.5',
        "mail bob@example.com from 10.1.2.3", "mac 00:1a:2b:3c:4d:5e ok",
        "card 4111 1111 1111 1111 and 1234 5678 9012 3456",
        "ipv6 2001:db8::1 and fe80::1%eth0", "imei 49-015420-323751-8",
        '{"a": 1, "b": "x", "c": [1, 2], "d": {"e": 2.5}}', "[1, \"two\", {\"t\": 3}]",
        "not json", "10.0.0.7", "192.168.1.300", "10.20.30.40", "::1",
    ]
    words = ["svc", "GET", "POST", "/healthz", "id", "42", "x", "Ns"]
    for _ in range(n - len(out)):
        k = int(rng.integers(1, 4))
        out.append("/".join(str(rng.choice(words)) for _ in range(k))
                   + str(int(rng.integers(0, 10**6))) * int(rng.integers(0, 2)))
    return out


# name -> (arg types, literal args around the string column, which arg
# is the string)
HOST_DICT_CASES = {
    "contains": (("STRING", "STRING"), ["/"]),
    "length": (("STRING",), []),
    "find": (("STRING", "STRING"), ["i"]),
    "substring": (("STRING", "INT64", "INT64"), [1, 3]),
    "tolower": (("STRING",), []),
    "toupper": (("STRING",), []),
    "trim": (("STRING",), []),
    "strip_prefix": (("STRING", "STRING"), ["/api"]),
    "atoi": (("STRING",), []),
    "startswith": (("STRING", "STRING"), ["/"]),
    "endswith": (("STRING", "STRING"), ["42"]),
    "pod_name_to_namespace": (("STRING",), []),
    "regex_match": (("STRING", "STRING"), [r"/api/v\d/.*"]),
    "replace": (("STRING", "STRING", "STRING"), [r"\d+", "N"]),
    "normalize_mysql": (("STRING",), []),
    "normalize_pgsql": (("STRING",), []),
    "_predict_request_path_cluster": (("STRING",), []),
    "cluster_request_path": (("STRING",), []),
    "_match_endpoint": (("STRING", "STRING"), ["/api/v1/users/*/orders"]),
    "redact_pii_best_effort": (("STRING",), []),
    "nslookup": (("STRING",), []),
    "ip_to_int": (("STRING",), []),
    "cidr_contains": (("STRING", "STRING"), ["10.0.0.0/8"]),
    "pluck": (("STRING", "STRING"), ["c"]),
    "pluck_int64": (("STRING", "STRING"), ["a"]),
    "pluck_float64": (("STRING", "STRING"), ["d"]),
    "pluck_array": (("STRING", "INT64"), [2]),
}


@pytest.fixture()
def stub_resolver(monkeypatch):
    """Reverse DNS with no network: two names known, the rest fail."""
    known = {"10.0.0.7": "pod-7.cluster.local", "::1": "localhost"}

    def gethostbyaddr(addr):
        if addr in known:
            return known[addr], [], [addr]
        raise OSError("no resolver")

    monkeypatch.setattr(socket, "gethostbyaddr", gethostbyaddr)
    net_ops._NSLOOKUP_CACHE.clear()
    jax_net_ops._NSLOOKUP_CACHE.clear()
    yield
    net_ops._NSLOOKUP_CACHE.clear()
    jax_net_ops._NSLOOKUP_CACHE.clear()


@pytest.mark.parametrize("name", sorted(HOST_DICT_CASES))
def test_host_dict_udf_matches_jax(name, stub_resolver):
    types, literals = HOST_DICT_CASES[name]
    got = default_registry().get_scalar(name, [DataType[t] for t in types])
    ref = jax_registry().get_scalar(name, [JaxDataType[t] for t in types])
    assert got.executor.name == ref.executor.name == "HOST_DICT"
    assert got.dict_arg == ref.dict_arg
    assert got.return_type.name == ref.return_type.name
    assert got.semantic_type == ref.semantic_type
    for s in _vocab():
        args = list(literals)
        args.insert(got.dict_arg, s)
        a = got.fn(*args)
        try:
            b = ref.fn(*args)
        except KeyError:
            # The JAX package's pluck_array raises on a JSON object (an
            # uncaught KeyError); the port's gives "" as for any other
            # value that has no such index.
            assert name == "pluck_array" and s.startswith("{"), (name, s)
            b = ""
        if isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), (name, s)
        else:
            assert a == b, (name, s, a, b)


PROTOCOL_UDFS = ("protocol_name", "http_resp_message", "mysql_command_name",
                 "kafka_api_key_name")
CODES = np.array([0, 1, 2, 3, 7, 13, 14, 31, 32, 51, 52, 100, 200, 404, 418,
                  499, 503, 511, 598, 599, 600, 10**6, -1, -200,
                  (1 << 32) + 3, (1 << 32) + 200, -(1 << 40), 2**63 - 1,
                  -(2**63)], dtype=np.int64)


@pytest.mark.parametrize("name", PROTOCOL_UDFS)
def test_protocol_table_matches_jax(name):
    got = default_registry().get_scalar(name, [DataType.INT64])
    ref = jax_registry().get_scalar(name, [JaxDataType.INT64])
    assert got.out_dict.strings == ref.out_dict.strings
    ids = got.fn(torch.from_numpy(CODES))
    assert ids.dtype == torch.int32
    assert np.array_equal(ids.numpy(), np.asarray(ref.fn(jnp.asarray(CODES))))
    # Literal codes give the same ids as a plane of them.
    assert [got.fn(int(c)) for c in CODES] == ids.tolist()


def test_protocol_names_of_known_codes():
    reg = default_registry()
    fn = reg.get_scalar("http_resp_message", [DataType.INT64])
    d = fn.out_dict
    names = d.decode(fn.fn(torch.tensor([200, 404, 599, 700, -1])).numpy())
    assert list(names) == ["OK", "Not Found", "Unknown", "Unknown", "Unknown"]


HLL_VALUES = np.array(
    [0, -1, 1, 2**62, -(2**62), 2**63 - 1, -(2**63), 12345, 2**32, 2**32 - 1],
    dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hll_registers_bit_identical(seed):
    rng = np.random.default_rng(seed)
    n, g = 5000, 7
    vals = np.concatenate([
        HLL_VALUES,
        rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True),
        rng.integers(0, 300, n),  # many duplicates
    ]).astype(np.int64)
    gids = rng.integers(0, g, len(vals)).astype(np.int32)
    mask = rng.random(len(vals)) < 0.9
    regs = hll.hll_update(hll.hll_init(g, "cpu"), torch.from_numpy(gids),
                          torch.from_numpy(mask), torch.from_numpy(vals))
    ref = jax_hll.hll_update(jax_hll.hll_init(g), jnp.asarray(gids),
                             jnp.asarray(mask), jnp.asarray(vals))
    assert np.array_equal(regs.numpy(), np.asarray(ref))
    for k in range(g):
        mirror = hll.hll_update_np(hll.hll_init_np(), vals[mask & (gids == k)])
        assert np.array_equal(regs[k].numpy(), mirror)
    est = hll.hll_estimate(regs)
    assert est.dtype == torch.int64
    assert est.tolist() == np.asarray(jax_hll.hll_estimate(ref)).tolist()
    # Merge is an elementwise max, associative with the update.
    half = len(vals) // 2
    a = hll.hll_update(hll.hll_init(g, "cpu"), torch.from_numpy(gids[:half]),
                       torch.from_numpy(mask[:half]), torch.from_numpy(vals[:half]))
    b = hll.hll_update(hll.hll_init(g, "cpu"), torch.from_numpy(gids[half:]),
                       torch.from_numpy(mask[half:]), torch.from_numpy(vals[half:]))
    assert torch.equal(torch.maximum(a, b), regs)


def test_hll_string_ids_and_large_counts():
    """STRING count_distinct hashes int32 dictionary ids (NULL = -1)."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 200_000, 150_000).astype(np.int32)
    gids = np.zeros(len(ids), np.int32)
    mask = np.ones(len(ids), bool)
    regs = hll.hll_update(hll.hll_init(1, "cpu"), torch.from_numpy(gids),
                          torch.from_numpy(mask), torch.from_numpy(ids))
    ref = jax_hll.hll_update(jax_hll.hll_init(1), jnp.asarray(gids),
                             jnp.asarray(mask), jnp.asarray(ids))
    assert np.array_equal(regs.numpy(), np.asarray(ref))
    est = int(hll.hll_estimate(regs)[0])
    assert est == int(jax_hll.hll_estimate(ref)[0])
    true = len(np.unique(ids))
    assert abs(est - true) / true < 0.1


@pytest.mark.parametrize("kind", ["int", "float"])
def test_row_priorities_exact(kind):
    rng = np.random.default_rng(4)
    if kind == "int":
        v = np.concatenate([HLL_VALUES, rng.integers(-(2**40), 2**40, 3000)])
    else:
        v = np.concatenate([[0.0, -0.0, np.inf, -np.inf, np.nan, 1e-30],
                            rng.normal(0, 1e6, 3000)]).astype(np.float32)
    got = ml.row_priorities(torch.from_numpy(v))
    ref = np.asarray(jax_ml.row_priorities(jnp.asarray(v)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert (got >= 0).all() and (got < 1).all()


def _reservoirs_match(got, ref):
    """Same row counts; per group the same set of priorities, and the
    same values where a priority is unique in the group."""
    gv, gp, gc = (t.numpy() for t in got)
    rv, rp, rc = (np.asarray(t) for t in ref)
    assert np.array_equal(gc, rc)
    assert gv.dtype == rv.dtype
    for k in range(len(gc)):
        assert np.array_equal(np.sort(gp[k]), np.sort(rp[k])), k
        for p in np.unique(gp[k][np.isfinite(gp[k])]):
            if (gp[k] == p).sum() == 1:
                assert gv[k][gp[k] == p][0] == rv[k][rp[k] == p][0]


@pytest.mark.parametrize("dtype", ["int64", "float32"])
def test_reservoir_matches_jax(dtype):
    rng = np.random.default_rng(6)
    g, c, n = 5, 16, 4096
    vals = (rng.integers(-1000, 10**9, n) if dtype == "int64"
            else rng.normal(0, 50, n)).astype(dtype)
    gids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    tdt = torch.int64 if dtype == "int64" else torch.float64
    jdt = jnp.int64 if dtype == "int64" else jnp.float64
    got, ref = ml.reservoir_init(g, c, tdt), jax_ml.reservoir_init(g, c, jdt)
    for lo in range(0, n, 1024):  # four windows, merged as they come
        s = slice(lo, lo + 1024)
        got = ml.reservoir_update(got, torch.from_numpy(gids[s]),
                                  torch.from_numpy(mask[s]),
                                  torch.from_numpy(vals[s]))
        ref = jax_ml.reservoir_update(ref, jnp.asarray(gids[s]),
                                      jnp.asarray(mask[s]), jnp.asarray(vals[s]))
    _reservoirs_match(got, ref)
    assert np.array_equal(got[2].numpy(),
                          np.bincount(gids[mask], minlength=g).astype(np.float32))


def test_kmeans_groups_matches_jax():
    rng = np.random.default_rng(8)
    g, c = 6, 256
    centers = np.array([-50.0, 0.0, 40.0, 100.0], np.float32)
    samples = (centers[rng.integers(0, 4, (g, c))]
               + rng.normal(0, 2, (g, c))).astype(np.float32)
    mask = rng.random((g, c)) < 0.7
    mask[5] = False  # an empty group: all NaN
    k = np.array([1, 2, 3, 4, 8, 3], np.int32)
    got = ml.kmeans_groups(torch.from_numpy(samples), torch.from_numpy(mask), 8,
                           torch.from_numpy(k))
    ref = np.asarray(jax_ml.kmeans_groups(jnp.asarray(samples),
                                          jnp.asarray(mask), 8, jnp.asarray(k)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4,
                               equal_nan=True)
    got = got.numpy()
    assert np.isnan(got[5]).all() and np.isnan(got[0, 1:]).all()


def test_kmeans_fit_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(m, 0.5, (200, 2)) for m in (0, 5, 10)])
    pts = pts.astype(np.float32)
    got = ml.kmeans_fit(torch.from_numpy(pts), 3).numpy()
    ref = np.asarray(jax_ml.kmeans_fit(jnp.asarray(pts), 3))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    w = rng.random(len(pts)).astype(np.float32)
    got = ml.kmeans_fit(torch.from_numpy(pts), 3, weights=w).numpy()
    ref = np.asarray(jax_ml.kmeans_fit(jnp.asarray(pts), 3, weights=w))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _both_engines(tables: dict):
    jax_eng, eng = JaxEngine(window_rows=1024), Engine(window_rows=1024,
                                                       device="cpu")
    for name, data in tables.items():
        jax_eng.append_data(name, data)
        eng.append_data(name, data)
    return jax_eng, eng


@pytest.fixture(scope="module")
def uda_engines():
    rng = np.random.default_rng(12)
    n = 6000
    return _both_engines({"t": {
        "time_": np.arange(n, dtype=np.int64),
        "svc": rng.choice(["a", "b", "c", "d"], n),
        "user": [f"u{i}" for i in rng.integers(0, 900, n)],
        "v": rng.integers(-(2**62), 2**62, n),
        "x": np.concatenate([rng.normal(m, 1.0, n // 3) for m in (0, 20, 50)]),
        "code": rng.choice([0, 1, 3, 6, 13, 99, -4], n).astype(np.int64),
    }})


UDA_QUERIES = {
    "count_distinct": """
import px
df = px.DataFrame(table='t')
df = df.groupby('svc').agg(users=('user', px.count_distinct),
                           vals=('v', px.count_distinct),
                           n=('v', px.count))
px.display(df)
""",
    "reservoir_sample": """
import px
df = px.DataFrame(table='t')
df = df.groupby('svc').agg(v=('v', px.reservoir_sample),
                           x=('x', px.reservoir_sample))
px.display(df)
""",
    "kmeans": """
import px
df = px.DataFrame(table='t')
df = df.groupby('svc').agg(c=('x', px.kmeans, 3))
px.display(df)
""",
    "select_protocol": """
import px
df = px.DataFrame(table='t')
df.proto = px.protocol_name(df.code)
df.big = px.select(df.x > 10.0, df.svc, 'small')
df = df.groupby(['proto', 'big']).agg(n=('v', px.count))
px.display(df)
""",
}


@pytest.mark.parametrize("name", sorted(UDA_QUERIES))
def test_udas_through_queries_match_jax(uda_engines, name):
    jax_eng, eng = uda_engines
    q = UDA_QUERIES[name]
    try:
        ref = jax_eng.execute_query(q)["output"].to_pydict()
    except Exception as e:  # the JAX package must run every query here
        raise AssertionError(f"JAX package failed on {name}: {e}")
    got = eng.execute_query(q)["output"].to_pydict()
    assert list(got) == list(ref)
    keys = [c for c in got if got[c].dtype == object and c != "c"]
    og = np.lexsort([got[k].astype(str) for k in reversed(keys)])
    orr = np.lexsort([ref[k].astype(str) for k in reversed(keys)])
    for col in got:
        a, b = np.asarray(got[col])[og], np.asarray(ref[col])[orr]
        if col == "c":  # kmeans centroids, a JSON object per group
            for x, y in zip(a, b):
                dx, dy = json.loads(x), json.loads(y)
                assert sorted(dx) == sorted(dy)
                np.testing.assert_allclose(
                    [dx[f] for f in sorted(dx)], [dy[f] for f in sorted(dy)],
                    rtol=1e-5, equal_nan=True)
        else:
            assert np.array_equal(a, b), (name, col, a, b)


UDTFS = ("GetTables", "GetTableSchemas", "GetUDFList", "GetUDAList",
         "GetUDTFList", "GetDebugTableInfo", "GetVersion")


@pytest.fixture(scope="module")
def udtf_engines():
    from pixie_tpu.ingest.schemas import init_schemas as jax_init
    from pixie_tpu_torch.ingest.schemas import init_schemas

    rng = np.random.default_rng(1)
    jax_eng, eng = JaxEngine(window_rows=1024), Engine(window_rows=1024,
                                                       device="cpu")
    jax_init(jax_eng, memory_limit_mb=4)
    init_schemas(eng, memory_limit_mb=4)
    for e in (jax_eng, eng):
        for i in range(12):  # enough batches to expire the oldest
            n = 4000
            e.append_data("proc_stat", {
                "time_": np.arange(i * n, (i + 1) * n, dtype=np.int64),
                "system_percent": np.full(n, 1.0),
                "user_percent": np.full(n, 2.0),
                "idle_percent": np.full(n, 3.0),
            })
        e.append_data("extra", {"time_": np.arange(10, dtype=np.int64),
                                "s": [f"x{i}" for i in range(10)]})
    return jax_eng, eng


@pytest.mark.parametrize("name", UDTFS)
def test_introspection_udtf_rows_match_jax(udtf_engines, name):
    jax_eng, eng = udtf_engines
    q = f"import px\npx.display(px.{name}())\n"
    got = eng.execute_query(q)["output"].to_pydict()
    ref = jax_eng.execute_query(q)["output"].to_pydict()
    assert list(got) == list(ref)
    if name == "GetVersion":  # uptime_s is each process clock's own
        keep = got["key"] != "uptime_s"
        assert got["key"].tolist() == ref["key"].tolist()
        assert got["value"][keep].tolist() == ref["value"][keep].tolist()
        return
    for col in got:
        assert got[col].tolist() == ref[col].tolist(), (name, col)
    if name == "GetDebugTableInfo":
        row = got["table_name"].tolist().index("proc_stat")
        assert got["batches_expired"][row] > 0


@pytest.mark.cuda
def test_device_ops_on_the_card_match_the_cpu():
    """On a card: the HLL registers and estimates, the priorities, the
    reservoir, k-means and the protocol tables give the CPU's results
    (registers, ids and priorities exactly; reservoirs as sets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(np.concatenate([
        HLL_VALUES, rng.integers(-(2**63), 2**63 - 1, 20000, dtype=np.int64)]))
    gids = torch.from_numpy(rng.integers(0, 9, len(vals)).astype(np.int32))
    mask = torch.from_numpy(rng.random(len(vals)) < 0.9)
    cpu = hll.hll_update(hll.hll_init(9, "cpu"), gids, mask, vals)
    card = hll.hll_update(hll.hll_init(9, dev), gids.to(dev), mask.to(dev),
                          vals.to(dev))
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(hll.hll_estimate(card).cpu(), hll.hll_estimate(cpu))
    fv = torch.from_numpy(rng.normal(0, 1e3, 4096).astype(np.float32))
    for v in (vals, fv):
        assert torch.equal(ml.row_priorities(v.to(dev)).cpu(),
                           ml.row_priorities(v))
    g = gids[:4096] % 4
    m = mask[:4096]
    res_cpu = ml.reservoir_update(ml.reservoir_init(4, 32, torch.float64), g,
                                  m, fv)
    res_card = ml.reservoir_update(
        ml.reservoir_init(4, 32, torch.float64, dev), g.to(dev), m.to(dev),
        fv.to(dev))
    _reservoirs_match(tuple(t.cpu() for t in res_card),
                      tuple(t.numpy() for t in res_cpu))
    samples = res_cpu[0].to(torch.float32)
    smask = res_cpu[1] < ml._EMPTY
    k = torch.tensor([1, 2, 3, 8], dtype=torch.int32)
    np.testing.assert_allclose(
        ml.kmeans_groups(samples.to(dev), smask.to(dev), 8, k.to(dev)).cpu(),
        ml.kmeans_groups(samples, smask, 8, k), rtol=1e-5, atol=1e-4,
        equal_nan=True)
    codes = torch.from_numpy(CODES)
    for name in PROTOCOL_UDFS:
        fn = default_registry().get_scalar(name, [DataType.INT64]).fn
        assert torch.equal(fn(codes.to(dev)).cpu(), fn(codes))
