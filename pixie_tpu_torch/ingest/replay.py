"""Replay loader: stream a recorded http_events trace into the engine.

The benchmark ingest path (SURVEY.md §6): the north star
replays ~1B http_events rows through the query engine. This module
generates (or loads from .npz) the replay and streams it through the
push-callback surface in table-store-sized chunks, so the benchmark
exercises the same ingest path a live collector uses.
"""

from __future__ import annotations

import numpy as np

from ..types.dtypes import DataType
from ..types.relation import Relation

HTTP_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("remote_addr", DataType.STRING),
        ("req_method", DataType.STRING),
        ("req_path", DataType.STRING),
        ("resp_status", DataType.INT64),
        ("resp_body_size", DataType.INT64),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
        ("pod", DataType.STRING),
    ]
)


def gen_http_events(
    n: int,
    chunk: int = 1 << 20,
    seed: int = 7,
    n_services: int = 32,
    n_pods: int = 128,
    n_paths: int = 64,
    t0: int = 0,
):
    """Yield {col: np.ndarray} chunks of a synthetic http_events trace.

    Value distributions mirror the reference's protocol-loadtest shape:
    mostly-200 statuses, log-normal-ish latencies, service/pod/path drawn
    from small vocabularies (dictionary-encodable).
    """
    rng = np.random.default_rng(seed)
    methods = np.array(["GET", "GET", "GET", "POST", "PUT", "DELETE"])
    statuses = np.array([200] * 92 + [404] * 4 + [500] * 3 + [503])
    off = 0
    while off < n:
        m = min(chunk, n - off)
        svc_ids = rng.integers(0, n_services, m)
        yield {
            "time_": t0 + np.arange(off, off + m, dtype=np.int64) * 1000,
            "upid": np.stack(
                [
                    rng.integers(1, 1 << 30, m).astype(np.uint64),
                    rng.integers(1, 1 << 62, m).astype(np.uint64),
                ],
                axis=1,
            ),
            "remote_addr": [f"10.0.{i % 256}.{i % 251}" for i in svc_ids],
            "req_method": methods[rng.integers(0, len(methods), m)],
            "req_path": [f"/api/v1/ep{i}" for i in rng.integers(0, n_paths, m)],
            "resp_status": statuses[rng.integers(0, len(statuses), m)].astype(
                np.int64
            ),
            "resp_body_size": rng.integers(64, 1 << 20, m),
            "latency_ns": np.exp(rng.normal(15.0, 1.2, m)).astype(np.int64),
            "service": [f"svc-{i}" for i in svc_ids],
            "pod": [f"svc-{i}/pod-{j}" for i, j in zip(svc_ids, rng.integers(0, n_pods, m))],
        }
        off += m


def replay_into(target, n: int, chunk: int = 1 << 20, table: str = "http_events", **kw):
    """Stream a generated trace into an engine/agent via the push path.
    Returns total rows pushed."""
    total = 0
    for records in gen_http_events(n, chunk=chunk, **kw):
        target.append_data(table, records)
        total += len(records["resp_status"])
    return total


def save_npz(path: str, n: int, **kw) -> None:
    """Materialize a replay to disk for repeated benchmarking."""
    chunks = list(gen_http_events(n, **kw))
    keys = chunks[0].keys()
    np.savez_compressed(
        path,
        **{
            k: np.concatenate([np.asarray(c[k]) for c in chunks]) for k in keys
        },
    )


def load_npz(path: str, chunk: int = 1 << 20):
    """Yield chunks from a saved replay."""
    data = np.load(path, allow_pickle=False)
    n = len(data["resp_status"])
    for off in range(0, n, chunk):
        yield {k: data[k][off : off + chunk] for k in data.files}
