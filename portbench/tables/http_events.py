"""http_events as a PEM's socket tracer fills it, from a configuration.

Each row is one request to one endpoint, a (service, req_path) pair of
the configuration's ``endpoints``, drawn uniformly. Its pod is one of
its service's ``pods_per_service`` (one process, so one upid, each);
the client address, method, status, body size and latency are uniform
over the configuration's lists and ranges; the time steps evenly.

``make`` returns {"cols": {column: planes}, "dicts": {column: [str]},
"rows": n}: the planes as the program's ``HostBatch`` takes them
(strings as dictionary ids, UINT128 as (hi, lo)), beside each
dictionary's strings. The reference reads the same arrays.
"""

from __future__ import annotations

import numpy as np


def make(cfg: dict, rng: np.random.Generator, n: int) -> dict:
    pairs = cfg["endpoints"]
    services = list(dict.fromkeys(s for s, _ in pairs))
    paths = list(dict.fromkeys(p for _, p in pairs))
    pair_svc = np.array([services.index(s) for s, _ in pairs], dtype=np.int32)
    pair_path = np.array([paths.index(p) for _, p in pairs], dtype=np.int32)
    per_svc = int(cfg["pods_per_service"])
    addrs = int(cfg["remote_addrs"])

    which = rng.integers(0, len(pairs), n, dtype=np.int32)
    svc, path = pair_svc[which], pair_path[which]
    pod = svc * per_svc + rng.integers(0, per_svc, n, dtype=np.int32)
    addr = rng.integers(0, addrs, n, dtype=np.int32)
    method = rng.integers(0, len(cfg["req_methods"]), n, dtype=np.int32)
    statuses = np.asarray(cfg["resp_status"], dtype=np.int64)
    status = statuses[rng.integers(0, len(statuses), n)]
    body = rng.integers(*cfg["resp_body_size"], n, dtype=np.int64)
    lat = rng.integers(*cfg["latency_ns"], n, dtype=np.int64)
    time_ = np.int64(cfg["time_base_ns"]) + np.arange(n, dtype=np.int64) * np.int64(
        cfg["time_step_ns"]
    )
    # One process per pod: upid = (asid 1 << 32 | pid, start time ticks).
    upid_hi = (np.uint64(1) << np.uint64(32)) | (np.uint64(1000) + pod.astype(np.uint64))
    upid_lo = np.uint64(1_000_000) + pod.astype(np.uint64)
    return {
        "rows": n,
        "cols": {
            "time_": (time_,),
            "upid": (upid_hi, upid_lo),
            "remote_addr": (addr,),
            "req_method": (method,),
            "req_path": (path,),
            "resp_status": (status,),
            "resp_body_size": (body,),
            "latency_ns": (lat,),
            "service": (svc,),
            "pod": (pod,),
        },
        "dicts": {
            "remote_addr": [f"10.{i // 256}.{i % 256}.1" for i in range(addrs)],
            "req_method": list(cfg["req_methods"]),
            "req_path": paths,
            "service": services,
            "pod": [f"{s}-{k}" for s in services for k in range(per_svc)],
        },
    }
