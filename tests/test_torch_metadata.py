"""The port's k8s metadata context against the JAX package's.

Both packages build their ``MetadataState`` from one feed of
ResourceUpdate dicts through their own ``MetadataWatcher.apply_all``,
and the two states are asserted equal. Then:

- ``build_table`` and ``device_lookup`` against the JAX package's, for
  found and missing keys, duplicate keys and UINT128 keys with the top
  bit set: the host tables are equal array for array and the lookups
  equal exactly;
- the ``df.ctx`` queries of ``tests/test_planner.py``'s
  ``test_ctx_metadata`` and ``tests/test_udf.py``'s semantic-type tests
  (service, pod, namespace, node, the id keys, a custom function
  annotated with a semantic type, an unknown key) on both engines over
  the same rows. Counts and names are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.metadata.watcher import MetadataWatcher as JaxWatcher
from pixie_tpu.ops.hashtable import build_table as jax_build_table
from pixie_tpu.ops.hashtable import device_lookup as jax_device_lookup
from pixie_tpu.planner import PxLError as JaxPxLError
from pixie_tpu_torch import Engine
from pixie_tpu_torch.metadata.watcher import MetadataWatcher
from pixie_tpu_torch.ops.hashtable import build_table, device_lookup
from pixie_tpu_torch.planner import PxLError

NOW = 1_700_000_000_000_000_000
N = 4000


def _feed(n_pods=6, n_services=3, n_upids=40, seed=5):
    """ResourceUpdate dicts: services, pods (some without a service),
    containers and processes, with resource versions and one stale
    replay the watcher must skip."""
    rng = np.random.default_rng(seed)
    feed, rv = [], 0

    def add(**u):
        nonlocal rv
        rv += 1
        feed.append({"rv": rv, **u})

    for s in range(n_services):
        add(kind="service", uid=f"s-{s}", name=f"svc{s}",
            namespace=f"ns{s % 2}", cluster_ip=f"10.96.0.{s}")
    for p in range(n_pods):
        svc = () if p == n_pods - 1 else (f"s-{p % n_services}",)
        add(kind="pod", uid=f"p-{p}", name=f"pod{p}", namespace=f"ns{p % 2}",
            node_name=f"node-{p % 3}", ip=f"10.0.0.{p}", service_uids=svc)
        add(kind="container", cid=f"c-{p}", name=f"ctr{p}", pod_uid=f"p-{p}")
    for u in range(n_upids):
        pod = int(rng.integers(0, n_pods))
        add(kind="process", upid=f"{u % 3}:{100 + u}:{7 + u}",
            pod_uid=f"p-{pod}", container_id=f"c-{pod}", cmdline=f"/bin/app{u}")
    feed.append(dict(feed[0]))  # a replayed (stale) version
    return feed


def _state_view(st):
    """Package-neutral form of a MetadataState."""
    def rec(x):
        return tuple(sorted(dataclasses.asdict(x).items()))

    return {
        "asid": st.asid,
        "pods": {k: rec(v) for k, v in st.pods.items()},
        "services": {k: rec(v) for k, v in st.services.items()},
        "containers": {k: rec(v) for k, v in st.containers.items()},
        "namespaces": sorted(st.namespaces),
        "pids": {k: (str(v.upid), v.pod_uid, v.container_id, v.cmdline)
                 for k, v in st.pids.items()},
        "ip_to_pod": dict(st.ip_to_pod),
        "epoch": st.epoch,
        "snapshot": st.snapshot_entries(),
    }


@pytest.fixture(scope="module")
def states():
    jw, w = JaxWatcher(), MetadataWatcher()
    feed = _feed()
    assert jw.apply_all(feed) == w.apply_all(feed) == len(feed) - 1
    assert jw.updates_skipped == w.updates_skipped == 1
    return jw.state, w.state


def test_watchers_build_the_same_state(states):
    jax_state, state = states
    assert _state_view(state) == _state_view(jax_state)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 63, n, dtype=np.uint64) | np.uint64(1 << 63)
    hi[: n // 2] = rng.integers(0, 1 << 20, n // 2).astype(np.uint64)
    lo = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2)
    lo[::7] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return hi, lo


@pytest.mark.parametrize("n", [0, 1, 37, 2000])
def test_hash_table_matches_jax(n):
    hi, lo = _keys(n, seed=n)
    vals = np.arange(n, dtype=np.int32)
    if n > 2:  # a duplicate key keeps the last value
        hi[-1], lo[-1] = hi[0], lo[0]
    tbl, ref = build_table((hi, lo), vals), jax_build_table((hi, lo), vals)
    assert tbl.max_probes == ref.max_probes
    for a, b in zip(tbl.key_planes + (tbl.values, tbl.occupied),
                    ref.key_planes + (ref.values, ref.occupied)):
        assert np.array_equal(a, b)
    # Every key, then as many missing ones (a flipped low bit).
    mhi, mlo = _keys(max(n, 8), seed=n + 1000)
    qhi = np.concatenate([hi, mhi, hi[: n // 2]])
    qlo = np.concatenate([lo, mlo, lo[: n // 2] ^ np.uint64(1)])
    q = tuple(torch.from_numpy(p.view(np.int64)).view(torch.uint64)
              for p in (qhi, qlo))
    got_v, got_f = device_lookup(tbl, q)
    ref_v, ref_f = jax_device_lookup(ref, (qhi, qlo))
    assert np.array_equal(got_f.numpy(), np.asarray(ref_f))
    assert np.array_equal(got_v.numpy(), np.asarray(ref_v))
    assert got_f[:n].all() and (got_v[got_f.logical_not()] == -1).all()


def _http_events(n=N, seed=3):
    """tests/test_planner.py's rows, with upids taken from the feed's
    processes and 10% unknown ones."""
    rng = np.random.default_rng(seed)
    known = [(int(a) << 32 | int(p), int(t)) for a, p, t in (
        u["upid"].split(":") for u in _feed() if u["kind"] == "process")]
    pick = rng.integers(0, len(known), n)
    hi = np.array([known[i][0] for i in pick], dtype=np.uint64)
    lo = np.array([known[i][1] for i in pick], dtype=np.uint64)
    unknown = rng.random(n) < 0.1
    lo[unknown] += np.uint64(1 << 40)
    return {
        "time_": NOW - np.arange(n, dtype=np.int64)[::-1] * 1_000_000,
        "upid": np.stack([hi, lo], axis=1),
        "service": rng.choice(["cart", "checkout", "frontend", ""], n),
        "resp_status": rng.choice([200, 200, 200, 404, 500], n),
        "latency": rng.integers(10_000, 50_000_000, n),
    }


@pytest.fixture(scope="module")
def engines(states):
    jax_state, state = states
    jax_eng = JaxEngine(window_rows=1024)
    eng = Engine(window_rows=1024, device="cpu")
    for e, st in ((jax_eng, jax_state), (eng, state)):
        e.append_data("http_events", _http_events())
        e.set_metadata_state(st)
    return jax_eng, eng


def _rows(out, keys):
    d = out.to_pydict()
    cols = list(d)
    return sorted(zip(*(
        d[c].tolist() if c not in keys else [str(v) for v in d[c]]
        for c in cols)))


CTX_QUERIES = {
    "service_pod": """
import px
df = px.DataFrame(table='http_events')
df.service = df.ctx['service']
df.pod = df.ctx['pod']
df = df.groupby(['service', 'pod']).agg(n=('latency', px.count))
px.display(df)
""",
    "namespace_node": """
import px
df = px.DataFrame(table='http_events')
df.ns = df.ctx['namespace']
df.node = df.ctx['node']
df = df.groupby(['ns', 'node']).agg(n=('latency', px.count),
                                    lat=('latency', px.max))
px.display(df)
""",
    "ids": """
import px
df = px.DataFrame(table='http_events')
df.pod_id = df.ctx['pod_id']
df.svc_id = df.ctx['service_id']
df.ctr = df.ctx['container']
df.cmd = df.ctx['cmdline']
df = df.groupby(['pod_id', 'svc_id', 'ctr', 'cmd']).agg(
    n=('latency', px.count))
px.display(df)
""",
    "host_dict_funcs": """
import px
df = px.DataFrame(table='http_events')
df.pod_id = df.ctx['pod_id']
df.name = px.pod_id_to_pod_name(df.pod_id)
df.svc = px.pod_id_to_service_name(df.pod_id)
df.ns = px.pod_name_to_namespace(df.name)
df = df.groupby(['name', 'svc', 'ns']).agg(n=('latency', px.count))
px.display(df)
""",
    "filter_rows": """
import px
df = px.DataFrame(table='http_events')
df.svc = df.ctx['service']
df = df[df.svc == 'ns1/svc1']
df = df[['time_', 'svc', 'latency']]
px.display(df.head(200))
""",
}

# A ctx lookup that overwrites the table's own ``service`` column, then a
# filter on it. The zone maps describe the table's column, not the
# lookup's: the JAX package prunes every window here (its zoneskip reads
# the literal against the overwritten column's dictionary), so the port
# is held to numpy.
FILTER_OVERWRITTEN = """
import px
df = px.DataFrame(table='http_events')
df.service = df.ctx['service']
df = df[df.service == 'ns1/svc1']
df = df[['time_', 'service', 'latency']]
px.display(df)
"""


@pytest.mark.parametrize("name", sorted(CTX_QUERIES))
def test_ctx_queries_match_jax(engines, name):
    jax_eng, eng = engines
    q = CTX_QUERIES[name]
    got = eng.execute_query(q, now_ns=NOW)["output"]
    ref = jax_eng.execute_query(q, now_ns=NOW)["output"]
    assert got.length == ref.length > 0
    assert _rows(got, ()) == _rows(ref, ())


def test_ctx_service_pod_counts_numpy(engines, states):
    """tests/test_planner.py's check: counts per (service, pod) equal
    numpy's over the snapshot's own mapping; unknown upids give ''."""
    _jax_eng, eng = engines
    _, state = states
    out = eng.execute_query(CTX_QUERIES["service_pod"], now_ns=NOW)["output"]
    got = {(s, p): n for s, p, n in zip(*(
        out.to_pydict()[c].tolist() for c in ("service", "pod", "n")))}
    data = _http_events()
    want: dict = {}
    for hi, lo in data["upid"]:
        pod = state.pod_of_upid(int(hi), int(lo))
        svc = state.service_of_pod(pod) if pod else None
        key = (svc.qualified_name if svc else "",
               pod.qualified_name if pod else "")
        want[key] = want.get(key, 0) + 1
    assert got == want
    assert ("", "") in got


def test_ctx_filter_on_overwritten_column(engines, states):
    _jax_eng, eng = engines
    _, state = states
    out = eng.execute_query(FILTER_OVERWRITTEN, now_ns=NOW)["output"]
    data = _http_events()
    keep = []
    for hi, lo in data["upid"]:
        pod = state.pod_of_upid(int(hi), int(lo))
        svc = state.service_of_pod(pod) if pod else None
        keep.append(svc is not None and svc.qualified_name == "ns1/svc1")
    keep = np.array(keep)
    d = out.to_pydict()
    assert keep.sum() > 0
    assert d["time_"].tolist() == data["time_"][keep].tolist()
    assert d["latency"].tolist() == data["latency"][keep].tolist()
    assert set(d["service"]) == {"ns1/svc1"}


def test_custom_semantic_function_answers_ctx():
    """tests/test_udf.py's custom metadata function: annotated
    ST_NODE_NAME, it answers ctx['node'] with no resolver change."""
    from pixie_tpu_torch.types import DataType, StringDictionary
    from pixie_tpu_torch.types.semantic import SemanticType
    from pixie_tpu_torch.udf.registry import default_registry

    eng = Engine(device="cpu")
    reg = default_registry().clone("sem-test")
    d = StringDictionary()
    d.encode(["zone-a", "zone-b"])
    reg.scalar(
        "upid_to_zone", (DataType.UINT128,), DataType.STRING,
        lambda upid: (upid[1].view(torch.int64) % 2).to(torch.int32),
        out_dict=d, semantic_type=int(SemanticType.ST_NODE_NAME),
    )
    eng.registry = reg
    n = 64
    eng.append_data("t", {
        "time_": np.arange(n, dtype=np.int64),
        "upid": np.stack([np.full(n, 1, np.uint64),
                          np.arange(n, dtype=np.uint64)], axis=1),
        "v": np.ones(n, dtype=np.int64),
    })
    out = eng.execute_query(
        "import px\ndf = px.DataFrame(table='t')\n"
        "df.node = df.ctx['node']\n"
        "s = df.groupby('node').agg(n=('v', px.count))\npx.display(s)"
    )["output"].to_pydict()
    assert sorted(zip(out["node"], out["n"].tolist())) == [
        ("zone-a", 32), ("zone-b", 32)]


@pytest.mark.parametrize("key, attached, match", [
    ("nope", True, "service"),
    ("service", False, "no metadata state attached"),
    ("pod", False, "no metadata state attached"),
])
def test_ctx_errors_match_jax(states, key, attached, match):
    jax_state, state = states
    q = ("import px\ndf = px.DataFrame(table='t')\n"
         f"df.x = df.ctx['{key}']\npx.display(df)")
    rows = {"time_": np.arange(4, dtype=np.int64),
            "upid": np.stack([np.ones(4, np.uint64),
                              np.arange(4, dtype=np.uint64)], axis=1)}
    for eng, st, err in ((JaxEngine(), jax_state, JaxPxLError),
                         (Engine(device="cpu"), state, PxLError)):
        eng.append_data("t", rows)
        if attached:
            eng.set_metadata_state(st)
        with pytest.raises(err, match=match):
            eng.execute_query(q)


def test_docgen_renders_semantic_types(states):
    from pixie_tpu.metadata.funcs import register_metadata_funcs as jax_reg_md
    from pixie_tpu.udf.docgen import generate_markdown as jax_markdown
    from pixie_tpu.udf.registry import default_registry as jax_registry
    from pixie_tpu_torch.metadata.funcs import register_metadata_funcs
    from pixie_tpu_torch.udf.docgen import generate_markdown
    from pixie_tpu_torch.udf.registry import default_registry

    jax_state, state = states
    reg = default_registry().clone("docs-test")
    register_metadata_funcs(reg, state)
    ref = jax_registry().clone("docs-test")
    jax_reg_md(ref, jax_state)
    md = generate_markdown(reg)
    for tag in ("[ST_SERVICE_NAME]", "[ST_POD_NAME]", "[ST_QUANTILES]",
                "[ST_NAMESPACE_NAME]"):
        assert tag in md
    assert md == jax_markdown(ref)


@pytest.mark.cuda
def test_lookup_and_ctx_on_the_card_match_the_cpu(states):
    """On a card: ``device_lookup`` (top-bit-set keys, missing keys) and
    the ctx queries give the CPU engine's answers exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    hi, lo = _keys(3000, seed=4)
    tbl = build_table((hi, lo), np.arange(3000, dtype=np.int32))
    mhi, mlo = _keys(500, seed=44)
    q = tuple(torch.from_numpy(np.concatenate([a, b]).view(np.int64)).view(
        torch.uint64) for a, b in ((hi, mhi), (lo, mlo)))
    cpu_v, cpu_f = device_lookup(tbl, q)
    card_v, card_f = device_lookup(tbl, tuple(p.to(dev) for p in q))
    assert torch.equal(card_v.cpu(), cpu_v) and torch.equal(card_f.cpu(), cpu_f)
    _, state = states
    cpu, card = Engine(window_rows=1024, device="cpu"), Engine(window_rows=1024)
    for e in (cpu, card):
        e.append_data("http_events", _http_events())
        e.set_metadata_state(state)
    for name, q in sorted(CTX_QUERIES.items()):
        got = card.execute_query(q, now_ns=NOW)["output"]
        ref = cpu.execute_query(q, now_ns=NOW)["output"]
        assert _rows(got, ()) == _rows(ref, ()), name
