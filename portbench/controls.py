"""The readings the limits of ``reference/*.py`` are set from.

    python3 -m portbench.controls --config pem_default \
        --traffic http_stats --seeds 1,2,3 --seconds 3

In one process on the card, for each seed: the configuration's data on
one engine and, for each traffic mix, the program's numbers over a
short closed-loop window at the cell's own load (the lower readings),
then the control's numbers over the same data (the upper readings):
``float32``, the reference put in the program's place and computed in
float32, the precision below the FLOAT64 and INT64 that the
configuration states.

One JSON line per seed and mix, then one line of the worst program
reading and the least control reading of each number. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import run


def program_readings(eng, cell, seconds: float, sync) -> dict:
    """The numbers of a short closed-loop window of the program."""
    for _ in range(int(cell.traffic["warmup_queries"])):
        eng.execute_query(cell.script)
    sync()
    win = run.drive(eng, cell, seconds, trace=False)
    bad = [q.error for q in win.queries if q.error]
    if bad:
        raise RuntimeError(f"{len(bad)} queries failed: {bad[0]}")
    out = cell.traffic.get("output", "output")
    return {"outputs": [q.out[out].to_pydict() for q in win.queries], "queries": len(win.queries)}


def float32_outputs(cell, data) -> list:
    ref = cell.reference
    return [ref.as_program_output(ref.answer(data, dtype=np.float32))]


def readings(config: str, traffics: list, seeds: list, seconds: float, device: str = "cuda",
             rows: int | None = None, window_rows: int | None = None, emit=print) -> dict:
    """{traffic: {"program": {number: worst}, "float32": {number: least}}}."""
    import torch

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cells = {t: run.load_cell(f"{config}.{t}", config, t) for t in traffics}
    summary: dict = {t: {} for t in traffics}
    for seed in seeds:
        data = run.make_data(cells[traffics[0]], seed, rows)
        eng = run.load_engine(cells[traffics[0]], data, dev, window_rows)
        for t, cell in cells.items():
            ref = cell.reference.prepare(data)
            prog = program_readings(eng, cell, seconds, sync)
            line = {"config": config, "traffic": t, "seed": seed, "queries": prog["queries"],
                    "program": cell.reference.compare(prog["outputs"], ref),
                    "float32": cell.reference.compare(float32_outputs(cell, data), ref)}
            emit(json.dumps(line))
            for kind in ("program", "float32"):
                agg = summary[t].setdefault(kind, {})
                pick = max if kind == "program" else min
                for k, v in line[kind].items():
                    agg[k] = pick(agg.get(k, v), v)
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True, help="comma list")
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.set_cache_env()
    summary = readings(args.config, args.traffic.split(","),
                       [int(s) for s in args.seeds.split(",")], args.seconds)
    print(json.dumps({"config": args.config, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
