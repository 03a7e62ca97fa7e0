"""A configuration, a traffic mix or a metric is added by new files and
new BENCHMARK.json entries alone: the harness finds each by name."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import CHECKOUT

ROOT = Path(CHECKOUT)


def _checkout(tmp_path: Path) -> Path:
    """A copy of what the benchmark needs: BENCHMARK.json and its paths."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _python(cwd: Path, code: str, program: bool = False) -> subprocess.CompletedProcess:
    """``code`` run in ``cwd``; with ``program`` the program under test is
    importable too (from this checkout, after ``cwd``'s own files)."""
    env = dict(os.environ)
    if program:
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH"), str(ROOT)]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_every_entry_has_its_files():
    from portbench import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = run.find_cell(w["name"])
        assert cell.script.strip() and hasattr(cell.reference, "LIMITS")
        for m in cell.end_to_end + cell.per_layer:
            assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


# A configuration on another table: its generator, a mix with its PxL
# and reference, all new files.
CONN_TABLE = """
import numpy as np

def make(cfg, rng, n):
    i64 = lambda hi: rng.integers(0, hi, n, dtype=np.int64)
    pod = rng.integers(0, cfg["pods"], n, dtype=np.int32)
    return {"rows": n, "dicts": {
                "remote_addr": [f"10.0.0.{i}" for i in range(cfg["remote_addrs"])],
                "src_addr": ["10.1.0.1"], "src_pod": [f"pod-{i}" for i in range(cfg["pods"])]},
            "cols": {"time_": (np.arange(n, dtype=np.int64),),
                     "upid": (pod.astype(np.uint64) + np.uint64(1), np.zeros(n, np.uint64)),
                     "remote_addr": (rng.integers(0, cfg["remote_addrs"], n, dtype=np.int32),),
                     "remote_port": (i64(65536),), "trace_role": (i64(2) + 1,),
                     "addr_family": (i64(2),), "protocol": (i64(3),),
                     "ssl": (rng.random(n) < 0.5,), "conn_open": (i64(3),),
                     "conn_close": (i64(3),), "conn_active": (i64(3),),
                     "bytes_sent": (i64(1 << 20),), "bytes_recv": (i64(1 << 20),),
                     "src_addr": (np.zeros(n, np.int32),), "src_pod": (pod,)}}
"""
CONN_PXL = """import px
df = px.DataFrame(table='conn_stats')
df = df[df.trace_role == 1]
out = df.groupby(['src_pod', 'remote_addr']).agg(bytes_sent=('bytes_sent', px.sum))
px.display(out)
"""
CONN_REFERENCE = """
import numpy as np

LIMITS = {"mismatch": 0.0}

def prepare(data):
    c, d = data["cols"], data["dicts"]
    keep = c["trace_role"][0] == 1
    out = {}
    for p, a, b in zip(c["src_pod"][0][keep], c["remote_addr"][0][keep], c["bytes_sent"][0][keep]):
        k = (d["src_pod"][p], d["remote_addr"][a])
        out[k] = out.get(k, 0) + int(b)
    return out

def compare(outputs, ref):
    bad = 0
    for o in outputs:
        got = {(p, a): int(b) for p, a, b in zip(o["src_pod"], o["remote_addr"], o["bytes_sent"])}
        bad = max(bad, sum(got.get(k) != v for k, v in ref.items()) + len(set(got) - set(ref)))
    return {"mismatch": float(bad)}
"""


def test_a_new_cell_and_metric_need_new_files_only(tmp_path):
    from pixie_tpu_torch.ingest.schemas import CONN_STATS_RELATION, table_budgets
    from pixie_tpu_torch.types.dtypes import host_dtypes

    co = _checkout(tmp_path)
    before = {p: p.read_bytes() for p in (co / "portbench").rglob("*") if p.is_file()}
    pb = co / "portbench"
    # Another deployment of http_events: a configuration file alone.
    cfg = json.loads((pb / "configs" / "pem_default.json").read_text())
    cfg["endpoints"] = cfg["endpoints"][:4]
    (pb / "configs" / "pem_small.json").write_text(json.dumps(cfg))
    # A deployment of conn_stats: its configuration, generator, mix and reference.
    cols = {c: sum(__import__("numpy").dtype(d).itemsize for d in host_dtypes(t))
            for c, t in CONN_STATS_RELATION.items()}
    budget = table_budgets(1280)["conn_stats"]
    conn = {"source": "x", "flags": cfg["flags"], "table": "conn_stats", "table_bytes": budget,
            "columns": cols, "row_bytes": sum(cols.values()),
            "rows": budget // sum(cols.values()), "window_rows": 1 << 10,
            "append_batch_rows": 1 << 10, "pods": 6, "remote_addrs": 5, "reduced": []}
    (pb / "configs" / "pem_conn.json").write_text(json.dumps(conn))
    (pb / "tables" / "conn_stats.py").write_text(CONN_TABLE)
    (pb / "traffic" / "conn_bytes.pxl").write_text(CONN_PXL)
    (pb / "traffic" / "conn_bytes.json").write_text(json.dumps(
        {"script": "conn_bytes.pxl", "loop": "closed", "clients": 1, "warmup_queries": 1,
         "reference": "conn_bytes", "reads": ["trace_role", "src_pod", "remote_addr", "bytes_sent"],
         "result_row_bytes": 16}))
    (pb / "reference" / "conn_bytes.py").write_text(CONN_REFERENCE)
    (pb / "metrics" / "queries_per_s.py").write_text(
        "def read(run):\n    return len(run.query_s) / run.window_s\n")
    bench = json.loads((co / "BENCHMARK.json").read_text())
    for name in ("pem_small", "pem_conn"):
        bench["configs"].append({"name": name, "source": "x", "reduced": [], "why": "x",
                                 "file": f"portbench/configs/{name}.json"})
    bench["workloads"] += [
        {"name": "pem_small.http_stats", "config": "pem_small", "traffic": "http_stats",
         "chips": 1, "why": "x"},
        {"name": "pem_conn.conn_bytes", "config": "pem_conn", "traffic": "conn_bytes",
         "chips": 1, "why": "x"},
    ]
    bench["end_to_end"].append({"name": "queries_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["pem_conn.conn_bytes"]})
    (co / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, pathlib; from portbench import run\n"
        "assert run.CHECKOUT == pathlib.Path.cwd().resolve(), run.CHECKOUT\n"
        "out = {}\n"
        "for name in ('pem_small.http_stats', 'pem_conn.conn_bytes'):\n"
        "    r = run.run_cell(run.find_cell(name), 5, 0.5, False, device='cpu', rows=4096,\n"
        "                     window_rows=1024)\n"
        "    out[name] = [r['correct'], r['attempted'], sorted(r['metrics']), r['check']]\n"
        "print(json.dumps(out))\n"
    )
    out = _python(co, code, program=True)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    small, conn = got["pem_small.http_stats"], got["pem_conn.conn_bytes"]
    assert small[0] is True and small[1] > 0, small
    assert small[2] == ["query_p95_s", "rows_per_s", "setup_s"]
    assert conn[0] is True and conn[1] > 0, conn
    assert conn[2] == ["queries_per_s", "query_p95_s", "rows_per_s", "setup_s"]
    assert conn[3] == {"mismatch": {"value": 0.0, "limit": 0.0}}
    for p, data in before.items():  # no file that was there changed
        assert p.read_bytes() == data, p


def test_a_checkout_of_the_benchmark_alone_refuses_to_run(tmp_path):
    co = _checkout(tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "pem_default.http_stats",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=co, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("name", ["no_such.cell"])
def test_an_unknown_cell_is_refused(name):
    from portbench import run

    with pytest.raises(run.CellError):
        run.find_cell(name)
