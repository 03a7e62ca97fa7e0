"""Plain numpy answers of px/http_stats, and the numbers that judge one.

The script keeps the rows with ``resp_status < 400`` and, per (service,
req_path), counts them and takes the mean and the max of their INT64
``latency_ns``. ``answer`` works that out again from the generated
columns; ``compare`` holds the program's answers to it. This file
imports nothing of the program.

Numbers, each the worst over every answer compared:

- ``exact_mismatch``: groups missing or extra, or whose count or max
  differs. The count and the max are exact integers: limit 0.
- ``mean_rel_err``: the largest relative gap of a group's mean. The
  configuration states an INT64 sum over FLOAT64 division, so a sound
  run reads rounding alone; the float32 control reads far more
  (PERF.md gives both readings and the limit).
"""

from __future__ import annotations

import numpy as np

LIMITS = {"exact_mismatch": 0.0, "mean_rel_err": 1e-9}


def worst(a: float, b: float) -> float:
    """The larger of two gaps; a gap that is not a number (a NaN
    answer) is infinite."""
    return max(a, b) if b == b else float("inf")


def answer(data: dict, dtype=np.float64) -> dict:
    """{(service, req_path): (count, mean, max)}. ``dtype`` float32 is
    the control: the values, sums, means and maxes in float32."""
    c, d = data["cols"], data["dicts"]
    svc, path = c["service"][0], c["req_path"][0]
    ok = c["resp_status"][0] < 400
    n_path = len(d["req_path"])
    key = svc[ok].astype(np.int64) * n_path + path[ok]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    lat = c["latency_ns"][0][ok][order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    cnt = np.diff(np.r_[starts, len(ks)])
    if np.dtype(dtype) == np.float64:
        sums = np.add.reduceat(lat, starts)  # exact in int64
        mean = sums / cnt
        mx = np.maximum.reduceat(lat, starts)
    else:
        v = lat.astype(dtype)
        mean = np.add.reduceat(v, starts) / cnt.astype(dtype)
        mx = np.maximum.reduceat(v, starts)
    out = {}
    for k, n, m, x in zip(ks[starts], cnt, mean, mx):
        out[(d["service"][k // n_path], d["req_path"][k % n_path])] = (int(n), float(m), float(x))
    return out


def as_program_output(ans: dict) -> dict:
    """An answer of ``answer`` in the program's output columns (the
    control is the reference put in the program's place)."""
    keys = list(ans)
    return {
        "service": np.array([k[0] for k in keys], dtype=object),
        "req_path": np.array([k[1] for k in keys], dtype=object),
        "n": np.array([ans[k][0] for k in keys]),
        "lat_mean": np.array([ans[k][1] for k in keys]),
        "lat_max": np.array([ans[k][2] for k in keys]),
    }


def prepare(data: dict):
    """What ``compare`` needs of the reference, worked out once: the
    answer's rows by group, so its length is the result's rows."""
    return answer(data)


def compare(outputs: list, ref: dict) -> dict:
    """The numbers over ``outputs`` (each the ``to_pydict()`` of one
    answer's output table)."""
    mismatch, rel = 0.0, 0.0
    for out in outputs:
        got = {
            (s, p): (n, m, x)
            for s, p, n, m, x in zip(
                out["service"], out["req_path"], out["n"], out["lat_mean"], out["lat_max"]
            )
        }
        bad = len(out["n"]) - len(got) + len(set(got) ^ set(ref))  # duplicates too
        for k in set(got) & set(ref):
            n, m, x = got[k]
            rn, rm, rx = ref[k]
            bad += int(n) != rn or float(x) != rx
            rel = worst(rel, abs(float(m) - rm) / abs(rm))
        mismatch = max(mismatch, float(bad))
    return {"exact_mismatch": mismatch, "mean_rel_err": float(rel)}
