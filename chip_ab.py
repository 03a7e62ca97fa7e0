#!/usr/bin/env python3
"""Times the port's two kernel wrappers, and optionally the t-digest
script's fold, of this checkout and others on one card.

    python3 chip_ab.py OTHER_ROOT [OTHER_ROOT ...] [--rounds N] [--engine]

Each OTHER_ROOT is another checkout of this repository (for example the
parent commit, unpacked with ``git archive``). Each round runs one
process per turn: the other checkouts in the order given, this one
twice, then the others in reverse order (with one other: OTHER, THIS,
THIS, OTHER). Each process puts its checkout first on ``sys.path``,
imports that checkout's ``dense_fold``, ``hist_fold`` and ``Engine``,
and measures them with this checkout's ``chip_smoke.py`` helpers on the
same inputs: one 2^21-row window of the 16M-row replay at the main
path's shapes (384 dense slots without min; 33 x 8192 histogram slots).
Per wrapper it reports ``ms`` (CUDA events over 20 calls on inputs
rotated through copies larger than L2: what the engine pays per call),
``device_ms`` (all device work of one call in a torch.profiler trace)
and ``host_ms`` (the host's time per call over 100 calls that are not
waited for, the card running behind). With ``--engine`` it also loads the
replay into the checkout's ``Engine``, runs ``px/service_stats`` once to
warm up and three more times (as attribution runs where the checkout has
them, so ``fold_s`` is fenced per window in every checkout), and reports
each run's seconds and ``fold_s``, the host time of one ``batch_to_digest`` call waited for,
and the host ops with the most self time in one run (torch.profiler).
Each process prints one JSON line; the last line gives the median per
checkout. Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn, inputs, calls: int = 100) -> float:
    """Host ms per call of ``calls`` calls that are not waited for."""
    import torch

    fn(*inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*inputs[i % len(inputs)])
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e3


def time_engine(cs, replay, device) -> dict:
    """px/service_stats through the checkout's Engine, and its t-digest
    window update alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pixie_tpu_torch.ops.tdigest import batch_to_digest
    from pixie_tpu_torch.scripts import load_script

    eng = cs.load_engine(replay, cs.WINDOW, device)
    query = load_script("px/service_stats")
    # A checkout whose default query is not fenced per window keeps
    # fold_s's meaning only in an attribution run.
    kw = ({"analyze": True}
          if "analyze" in inspect.signature(eng.execute_query).parameters
          else {})
    eng.execute_query(query, **kw)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.execute_query(query, **kw)
        runs.append({"secs": time.perf_counter() - t0,
                     "fold_s": eng.last_stats.fold_s})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.execute_query(query)
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]

    svc, _path, lat, _status = (x[:cs.WINDOW] for x in replay)
    vals = torch.from_numpy(lat.astype("float32")).to(device)
    gids = torch.from_numpy(svc.astype("int32")).to(device)
    mask = torch.ones(len(svc), dtype=torch.bool, device=device)

    def digest():
        batch_to_digest(vals, gids, mask, cs.N_SERVICES + 1)
        torch.cuda.synchronize()

    digest()
    t0 = time.perf_counter()
    for _ in range(20):
        digest()
    return {
        "runs": runs,
        "digest_ms": (time.perf_counter() - t0) / 20 * 1e3,
        "host_top": [{"op": e.key[:60], "calls": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in top],
    }


def time_checkout(root: str, engine: bool) -> dict:
    """The checkout at ``root``, measured in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from pixie_tpu_torch.ops.dense_fold import dense_fold
    from pixie_tpu_torch.ops.hist_fold import hist_fold

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA card")
    device = torch.device("cuda", torch.cuda.current_device())
    replay = cs.make_replay(cs.ROWS)
    slots, vals, g = cs.dense_fold_inputs(replay, device)
    ids, hvals, n_slots = cs.hist_fold_inputs(replay, device,
                                              cs.N_SERVICES + 1)
    out = {"root": os.path.abspath(root), "card": cs.card_line()}
    for name, fn, inputs in (
        ("dense_fold", lambda s, v: dense_fold(s, v, g),
         cs._rotating((slots, vals))),
        ("hist_fold", lambda i, v: hist_fold(i, v, n_slots),
         cs._rotating((ids, hvals))),
    ):
        out[name] = {"ms": cs.event_ms(fn, inputs),
                     "device_ms": cs.profiled_device_ms(fn, inputs),
                     "host_ms": host_ms(fn, inputs)}
    if engine:
        out["service_stats"] = time_engine(cs, replay, device)
    return out


def _median(runs: list) -> dict:
    med = {
        k: {m: statistics.median(r[k][m] for r in runs)
            for m in ("ms", "device_ms", "host_ms")}
        for k in ("dense_fold", "hist_fold")
    }
    if "service_stats" in runs[0]:
        med["service_stats"] = {
            m: statistics.median(x[m] for r in runs
                                 for x in r["service_stats"]["runs"])
            for m in ("secs", "fold_s")
        }
        med["service_stats"]["digest_ms"] = statistics.median(
            r["service_stats"]["digest_ms"] for r in runs)
    return med


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--engine", action="store_true",
                    help="also time px/service_stats through the Engine")
    ap.add_argument("--one", action="store_true",
                    help="measure the one root given in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_checkout(args.other_roots[0], args.engine)))
        return 0
    order = args.other_roots + [HERE, HERE] + args.other_roots[::-1]
    runs = {}
    for _ in range(args.rounds):
        for root in order:
            cmd = [sys.executable, os.path.abspath(__file__), root, "--one"]
            res = subprocess.run(cmd + (["--engine"] if args.engine else []),
                                 capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                sys.stderr.write(res.stdout + res.stderr)
                return res.returncode
            line = json.loads(res.stdout.strip().splitlines()[-1])
            runs.setdefault(os.path.abspath(root), []).append(line)
            print(json.dumps(line), flush=True)
    print(json.dumps({"median": {root: _median(rs)
                                 for root, rs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
