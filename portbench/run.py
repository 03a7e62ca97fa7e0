"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload pem_default.http_stats \
        --seed 7 --seconds 20 --trace 0

From the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration and traffic mix, and everything else is found
by name: ``portbench/configs/<config>.json`` (the deployment and its
data), ``portbench/tables/<table>.py`` (the generator of the table the
configuration names), ``portbench/traffic/<traffic>.json`` (the script,
a frozen copy of its PxL beside it, the loop),
``portbench/reference/<reference>.py`` (the plain numpy answers and the
limits) and ``portbench/metrics/<metric>.py`` (one reader per metric).

A run makes its table from ``--seed`` on the host, loads it through the
program's ingest path (``Engine.create_table`` with the table's byte
budget, then ``append_data``) into an engine on the card, warms up the
cell's own script, and drives it from one closed-loop client for
``--seconds``. Set-up (``setup_s``) is the time from the start of this
module to the first timed query. With ``--trace 1`` the first seconds
of the window are profiled: the device metrics come from that stretch,
and the idle gaps from a second, shorter one that records host ops
too. Once the window has closed, every answer it produced is compared
with the reference. The last line of standard output is the result.

Exit codes: 0 with a result; 2 without a card, or with a cell the files
do not describe; 3 when a JAX module is loaded once the window closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# Fixed paths inside the checkout: the program's kernels build into its
# own ``pixie_tpu_torch/_build/``; these take whatever else would cache.
CACHE_DIR = CHECKOUT / ".portbench_cache"
# Top-level module names no run may load; whole names, since the port's
# own name begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pixie_tpu"})
PROFILE_S = 3.0  # the stretch the device metrics come from
GAPS_S = 1.0  # the stretch that also records host ops, for the idle gaps


class CellError(Exception):
    """The cell, its files or the machine do not allow a run."""


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise CellError(f"missing {path.relative_to(CHECKOUT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell and everything found for it by name."""

    name: str
    chips: int
    config: dict
    table: object  # the generator module of the configuration's table
    traffic: dict
    script: str
    reference: object
    end_to_end: list
    per_layer: list


def load_cell(name: str, config: str, traffic: str, chips: int = 1, end_to_end=(),
              per_layer=(), config_file: str | None = None) -> Cell:
    """A cell from its files: ``configs/<config>.json`` (or
    ``config_file``, relative to the checkout), ``tables/<table>.py``
    for the table it names, ``traffic/<traffic>.json`` with the PxL it
    names, and ``reference/<reference>.py``."""
    path = CHECKOUT / config_file if config_file else HERE / "configs" / f"{config}.json"
    if not path.is_file():
        raise CellError(f"missing {path.relative_to(CHECKOUT)}")
    cfg = load_json(path)
    table = load_module(HERE / "tables" / f"{cfg['table']}.py", f"portbench_table_{cfg['table']}")
    tdir = HERE / "traffic"
    if not (tdir / f"{traffic}.json").is_file():
        raise CellError(f"missing portbench/traffic/{traffic}.json")
    mix = load_json(tdir / f"{traffic}.json")
    if mix["loop"] != "closed" or int(mix["clients"]) != 1:
        raise CellError(f"traffic {traffic!r}: the harness drives one closed-loop client only")
    reference = load_module(HERE / "reference" / f"{mix['reference']}.py",
                            f"portbench_reference_{mix['reference']}")
    return Cell(name, int(chips), cfg, table, mix, (tdir / mix["script"]).read_text(),
                reference, list(end_to_end), list(per_layer))


def find_cell(workload: str, bench_path: Path = CHECKOUT / "BENCHMARK.json") -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, with its metrics."""
    if not bench_path.is_file():
        raise CellError(f"no {bench_path.name}")
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise CellError(f"no workload {workload!r} in {bench_path.name}")
    cfg_entry = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if cfg_entry is None:
        raise CellError(f"no configuration {entry['config']!r} in {bench_path.name}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return load_cell(workload, entry["config"], entry["traffic"], entry["chips"], e2e,
                     per_layer, cfg_entry["file"])


def set_cache_env() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)


def make_data(cell: Cell, seed: int, rows: int | None = None) -> dict:
    """The configuration's table from ``seed`` (any whole number: it is
    taken modulo 2^64), by its generator; the same seed gives the same
    columns, and every seed the same sizes. ``rows`` shrinks it for the
    CPU tests."""
    import numpy as np

    rng = np.random.default_rng(int(seed) & ((1 << 64) - 1))
    return cell.table.make(cell.config, rng, int(cell.config["rows"] if rows is None else rows))


def load_engine(cell: Cell, data: dict, device, window_rows: int | None = None):
    """An engine on ``device`` holding the generated table, appended
    through the program's ingest path at the configuration's budget,
    under the program's own relation of that table."""
    import numpy as np

    from pixie_tpu_torch.config import set_flag
    from pixie_tpu_torch.exec.engine import Engine
    from pixie_tpu_torch.ingest.schemas import CANONICAL_SCHEMAS, table_budgets
    from pixie_tpu_torch.types.batch import HostBatch
    from pixie_tpu_torch.types.dtypes import host_dtypes
    from pixie_tpu_torch.types.strings import StringDictionary

    cfg = cell.config
    for flag, value in cfg["flags"].items():
        set_flag(flag, value)
    if cfg["table"] not in CANONICAL_SCHEMAS:
        raise CellError(f"the program has no table {cfg['table']!r}")
    rel = CANONICAL_SCHEMAS[cfg["table"]]
    widths = {c: sum(np.dtype(d).itemsize for d in host_dtypes(t)) for c, t in rel.items()}
    if widths != cfg["columns"] or sum(widths.values()) != cfg["row_bytes"]:
        raise CellError(f"the program's {cfg['table']} relation {widths} is not the configuration's")
    budget = table_budgets()[cfg["table"]]
    if budget != cfg["table_bytes"] or budget // cfg["row_bytes"] != cfg["rows"]:
        raise CellError(f"budget {budget} B does not hold the configuration's {cfg['rows']} rows")

    eng = Engine(window_rows=window_rows or cfg["window_rows"], device=device)
    eng.create_table(cfg["table"], rel, max_bytes=budget)
    dicts = {c: StringDictionary(v) for c, v in data["dicts"].items()}
    n, step = data["rows"], int(cfg["append_batch_rows"])
    for o in range(0, n, step):
        m = min(step, n - o)
        cols = {c: tuple(p[o:o + m] for p in planes) for c, planes in data["cols"].items()}
        eng.append_data(cfg["table"], HostBatch(relation=rel, cols=cols, length=m, dicts=dicts))
    held = eng.tables[cfg["table"]].num_rows
    if held != n:
        raise RuntimeError(f"the table holds {held} rows of the {n} appended")
    return eng


@dataclass
class Query:
    start: float
    end: float
    out: object  # {table: HostBatch}, None when it raised
    error: str = ""


@dataclass
class Window:
    """What a window recorded, for the metric readers."""

    queries: list
    seconds: float
    stretch: object = None  # trace.Stretch of the profiled stretch
    gaps: list = field(default_factory=list)
    compile_ms: list = field(default_factory=list)  # [(host time, ms)]


def drive(eng, cell: Cell, seconds: float, trace: bool, sync=None, on_card: bool = True) -> Window:
    """The closed loop: one client, on the calling thread, sends its next
    query as soon as the last has answered, until ``seconds`` have
    passed. With ``trace`` it profiles its own queries: from the
    window's start for ``PROFILE_S`` (the device), then for ``GAPS_S``
    with host ops too (the idle gaps)."""
    from portbench import trace as tr

    queries: list = []
    compile_ms: list = []
    prof = None
    if trace:
        prof = tr.Profiler([(tr.DEVICE, min(PROFILE_S, 0.6 * seconds)),
                            (tr.GAPS, min(GAPS_S, 0.25 * seconds))], sync, on_card)

        def on_trace(qt):
            for s in qt.spans:
                if s.name == "compile":
                    compile_ms.append((time.perf_counter(),
                                       (s.end_unix_nano - s.start_unix_nano) / 1e6))
        eng.tracer.add_listener(on_trace)

    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        if prof is not None:
            prof.tick()
        t0 = time.perf_counter()
        try:
            out, err = eng.execute_query(cell.script), ""
        except Exception as e:  # a failed query is counted, not fatal
            out, err = None, f"{type(e).__name__}: {e}"
        queries.append(Query(t0, time.perf_counter(), out, err))
    if prof is not None:
        prof.close()
    end = max((q.end for q in queries), default=start)
    win = Window(queries, end - start, compile_ms=compile_ms)
    if prof is not None and tr.DEVICE in prof.done:
        a, b, (dev, _) = prof.done[tr.DEVICE]
        win.stretch = tr.Stretch(a, b, tr.queries_within([(q.start, q.end) for q in queries], a, b),
                                 tr.busy_s(dev), [(n, (e - s) / 1e9) for n, s, e in dev])
        if tr.GAPS in prof.done:
            win.gaps = tr.idle_gaps(*prof.done[tr.GAPS][2])
    return win


@dataclass
class RunView:
    """What a metric reader reads: one argument, these fields."""

    cell: Cell
    rows: int  # rows each query scans
    result_rows: int  # rows of the reference's answer
    query_s: list  # every query's seconds, from execute_query to the host answer
    window_s: float
    setup_s: float
    stretch: object  # trace.Stretch, or None without --trace 1
    compile_ms: list  # the compile span of each query in the stretch
    peak_bytes_per_s: float | None  # the card's published HBM bandwidth, None if unknown


def read_metrics(view: RunView, entries: list) -> dict:
    out = {}
    for m in entries:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}")
        value = reader.read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def log_quarters(win: Window) -> None:
    """Queries and their median seconds in each quarter of the window: a
    window that speeds up or slows down as it goes shows here."""
    if not win.queries:
        return
    t0 = win.queries[0].start
    parts = []
    for k in range(4):
        qs = sorted(q.end - q.start for q in win.queries
                    if k <= 4 * (q.start - t0) / win.seconds < k + 1)
        parts.append(f"{len(qs)} x {qs[len(qs) // 2]:.5f} s" if qs else "0")
    log("[portbench] quarters: " + ", ".join(parts))


def finite(x):
    """A number for the result line: one that is not finite as text."""
    return x if x is None or abs(x) < float("inf") else str(x)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             rows: int | None = None, window_rows: int | None = None, engine_hook=None,
             t0: float = T0) -> dict:
    """One run; returns the result object. ``rows`` and ``window_rows``
    shrink the configuration for the CPU tests; ``engine_hook(eng)``
    lets a test break the timed path underneath."""
    import torch

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t = time.perf_counter()
    data = make_data(cell, seed, rows)
    log(f"[portbench] data {data['rows']} rows in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    eng = load_engine(cell, data, dev, window_rows)
    sync()
    log(f"[portbench] append in {time.perf_counter() - t:.3f} s")
    if engine_hook is not None:
        engine_hook(eng)
    t = time.perf_counter()
    for _ in range(int(cell.traffic["warmup_queries"])):
        eng.execute_query(cell.script)
    sync()
    if trace:
        from portbench.trace import warm_profiler

        warm_profiler(dev.type == "cuda")
    log(f"[portbench] warm-up in {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t0

    win = drive(eng, cell, seconds, trace, sync, dev.type == "cuda")
    sync()
    # The cards the run used are those that hold memory it allocated.
    peaks = ([torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [0])
    used = [p for p in peaks if p > 0] or [0]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out_name = cell.traffic.get("output", "output")
    outputs = [q.out[out_name].to_pydict() for q in win.queries if q.out is not None]
    errors = [q.error for q in win.queries if q.error]
    for q in win.queries:
        q.out = None
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = cell.reference.prepare(data)
    numbers = cell.reference.compare(outputs, ref)
    limits = cell.reference.LIMITS
    log(f"[portbench] {len(win.queries)} queries in {win.seconds:.3f} s; "
        f"{len(outputs)} answers compared in {time.perf_counter() - t:.3f} s")
    for e in errors[:5]:
        log(f"[portbench] query failed: {e}")
    log_quarters(win)
    correct = (bool(outputs) and not errors and set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in limits))

    st = win.stretch
    view = RunView(
        cell=cell, rows=data["rows"], result_rows=len(ref), query_s=[q.end - q.start for q in win.queries],
        window_s=win.seconds, setup_s=setup_s, stretch=st,
        compile_ms=[ms for at, ms in win.compile_ms if st is not None and st.t0 <= at <= st.t1],
        peak_bytes_per_s=load_json(HERE / "peaks.json")["hbm_bytes_per_s"].get(kind),
    )
    result = {
        "correct": correct,
        "attempted": len(win.queries),
        "failed": len(errors),
        "metrics": read_metrics(view, cell.per_layer if trace else cell.end_to_end),
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": len(used), "memory_peak_bytes": int(max(used))},
    }
    if trace and st is not None:
        from portbench import trace as tr

        result["device"].update(busy_s=st.busy_s, window_s=st.wall_s)
        result["breakdown"] = {"device_ops": tr.top(st.ops), "idle_gaps": win.gaps}
    result["check"] = {k: {"value": finite(numbers.get(k)), "limit": limits[k]} for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    try:
        cell = find_cell(args.workload)
        import pixie_tpu_torch  # noqa: F401  (the program under test)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise CellError(f"the cell needs {cell.chips} CUDA card(s); "
                            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
    except (CellError, ImportError, OSError, KeyError, ValueError) as e:
        log(f"[portbench] cannot run: {type(e).__name__}: {e}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"[portbench] loaded once the window closed: {', '.join(found)}")
        return 3
    for k, v in result["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
