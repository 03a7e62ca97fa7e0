"""Builtin source connectors.

Reference parity:
- ``SeqGenConnector`` (``source_connectors/seq_gen``): deterministic
  synthetic sequences — the reference test strategy's stand-in for real
  eBPF sources (SURVEY.md §4).
- ``ProcessStatsConnector`` (``source_connectors/process_stats``):
  per-process CPU/memory counters scraped from procfs.
- ``NetworkStatsConnector`` (``source_connectors/network_stats``):
  per-interface rx/tx counters from /proc/net/dev.
- ``ProcStatConnector`` (``source_connectors/proc_stat``): system-wide
  CPU utilization split sampled from /proc/stat.
- ``PIDRuntimeConnector`` (``source_connectors/pid_runtime``):
  per-process cumulative CPU runtime gauge.
- ``ProcExitConnector`` (``source_connectors/proc_exit``): process-exit
  events detected by procfs diffing.
- ``StirlingErrorConnector`` (``source_connectors/stirling_error``):
  connector install status + runtime collection errors.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..types.dtypes import DataType
from ..types.relation import Relation
from ..utils.upid import UPID
from .core import SourceConnector
from .schemas import (
    NETWORK_STATS_RELATION,
    PID_RUNTIME_RELATION,
    PROC_EXIT_EVENTS_RELATION,
    PROC_STAT_RELATION,
    STIRLING_ERROR_RELATION,
)

I, F, S, T = DataType.INT64, DataType.FLOAT64, DataType.STRING, DataType.TIME64NS


class SeqGenConnector(SourceConnector):
    """Deterministic sequence generator, one table of counters.

    Reference: ``seq_gen_connector.h`` — linear/modulo/square sequences
    keyed off a monotone counter, used to validate the push path without
    kernel probes.
    """

    name = "seq_gen"
    tables = [
        (
            "sequences",
            Relation(
                [
                    ("time_", T),
                    ("x", I),
                    ("linear", I),
                    ("modulo10", I),
                    ("square", I),
                    ("fibonacci", I),
                ]
            ),
        )
    ]

    def __init__(self, rows_per_transfer: int = 64, **kw):
        super().__init__(**kw)
        self.rows_per_transfer = rows_per_transfer
        self._x = 0
        self._fib = (0, 1)

    def transfer_data(self, ctx, data_tables) -> None:
        n = self.rows_per_transfer
        xs = np.arange(self._x, self._x + n, dtype=np.int64)
        fibs = np.empty(n, dtype=np.int64)
        a, b = self._fib
        for i in range(n):
            fibs[i] = a
            a, b = b, (a + b) % (1 << 62)
        self._fib = (a, b)
        self._x += n
        now = time.time_ns()
        data_tables["sequences"].append(
            {
                "time_": np.full(n, now, dtype=np.int64),
                "x": xs,
                "linear": 2 * xs + 1,
                "modulo10": xs % 10,
                "square": xs * xs,
                "fibonacci": fibs,
            }
        )


class ProcessStatsConnector(SourceConnector):
    """Per-process CPU/memory from /proc (``process_stats`` parity)."""

    name = "process_stats"
    tables = [
        (
            "process_stats",
            Relation(
                [
                    ("time_", T),
                    ("pid", I),
                    ("cmd", S),
                    ("utime_ticks", I),
                    ("stime_ticks", I),
                    ("vsize_bytes", I),
                    ("rss_bytes", I),
                ]
            ),
        )
    ]

    def __init__(self, max_procs: int = 256, **kw):
        super().__init__(**kw)
        self.max_procs = max_procs
        self._page = os.sysconf("SC_PAGE_SIZE")

    def transfer_data(self, ctx, data_tables) -> None:
        rows = {k: [] for k, _ in self.tables[0][1].items()}
        now = time.time_ns()
        count = 0
        for pid_s in os.listdir("/proc"):
            if not pid_s.isdigit():
                continue
            if count >= self.max_procs:
                break
            parsed = _read_pid_stat(pid_s)
            if parsed is None:
                continue  # process exited mid-scan (or truncated read)
            comm, fields = parsed
            rows["time_"].append(now)
            rows["pid"].append(int(pid_s))
            rows["cmd"].append(comm)
            rows["utime_ticks"].append(int(fields[11]))
            rows["stime_ticks"].append(int(fields[12]))
            rows["vsize_bytes"].append(int(fields[20]))
            rows["rss_bytes"].append(int(fields[21]) * self._page)
            count += 1
        data_tables["process_stats"].append(rows)


class NetworkStatsConnector(SourceConnector):
    """Per-interface network counters from /proc/net/dev.

    Reference parity: the network_stats source
    (``src/stirling/source_connectors/network_stats/
    network_stats_connector.h`` — per-pod rx/tx byte/packet/error/drop
    counters from the netns). Without k8s netns access, interfaces stand
    in for pods; the schema is the canonical ``network_stats`` table.
    """

    name = "network_stats"
    tables = [("network_stats", NETWORK_STATS_RELATION)]

    def __init__(self, pod: str = "default/self", **kw):
        super().__init__(**kw)
        self.pod = pod

    def transfer_data(self, ctx, data_tables) -> None:
        try:
            with open("/proc/net/dev") as f:
                lines = f.readlines()[2:]  # skip the two header lines
        except OSError:
            return
        rows = {k: [] for k, _ in self.tables[0][1].items()}
        now = time.time_ns()
        for line in lines:
            if ":" not in line:
                continue
            iface, rest = line.split(":", 1)
            fields = rest.split()
            if len(fields) < 12:
                continue
            rows["time_"].append(now)
            rows["pod_id"].append(iface.strip())
            rows["rx_bytes"].append(int(fields[0]))
            rows["rx_packets"].append(int(fields[1]))
            rows["rx_errors"].append(int(fields[2]))
            rows["rx_drops"].append(int(fields[3]))
            rows["tx_bytes"].append(int(fields[8]))
            rows["tx_packets"].append(int(fields[9]))
            rows["tx_errors"].append(int(fields[10]))
            rows["tx_drops"].append(int(fields[11]))
            rows["pod"].append(self.pod)
        data_tables["network_stats"].append(rows)


def _read_pid_stat(pid_s: str):
    """(comm, post-comm fields) from /proc/<pid>/stat, or None if the
    process exited mid-read. comm may contain spaces/parens, so split
    around the LAST ')'."""
    try:
        with open(f"/proc/{pid_s}/stat") as f:
            stat = f.read()
    except OSError:
        return None
    lpar, rpar = stat.find("("), stat.rfind(")")
    if lpar < 0 or rpar < 0:
        return None
    return stat[lpar + 1 : rpar], stat[rpar + 2 :].split()


class ProcStatConnector(SourceConnector):
    """System-wide CPU utilization from /proc/stat.

    Reference parity: ``proc_stat/proc_stat_connector.h`` kElements —
    {time_, system_percent, user_percent, idle_percent} gauges computed
    by diffing the aggregate ``cpu`` jiffies line between samples (the
    reference's GetProcStat does the same two-sample delta).
    """

    name = "proc_stat"
    tables = [("proc_stat", PROC_STAT_RELATION)]

    def __init__(self, **kw):
        super().__init__(**kw)
        self._prev = None

    @staticmethod
    def _cpu_jiffies():
        with open("/proc/stat") as f:
            parts = f.readline().split()
        if not parts or parts[0] != "cpu" or len(parts) < 5:
            return None
        vals = [int(x) for x in parts[1:]]
        user = vals[0] + vals[1]  # user + nice
        system = vals[2]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
        # guest/guest_nice (fields 9-10) are already folded into
        # user/nice by the kernel — summing them would double-count.
        return user, system, idle, sum(vals[:8])

    def transfer_data(self, ctx, data_tables) -> None:
        try:
            cur = self._cpu_jiffies()
        except OSError:
            return
        if cur is None:
            return
        prev, self._prev = self._prev, cur
        if prev is None:
            return  # percentages need a two-sample delta
        total = cur[3] - prev[3]
        if total <= 0:
            return
        data_tables["proc_stat"].append(
            {
                "time_": np.array([time.time_ns()], dtype=np.int64),
                "system_percent": np.array([100.0 * (cur[1] - prev[1]) / total]),
                "user_percent": np.array([100.0 * (cur[0] - prev[0]) / total]),
                "idle_percent": np.array([100.0 * (cur[2] - prev[2]) / total]),
            }
        )


class PIDRuntimeConnector(SourceConnector):
    """Per-process cumulative CPU runtime gauge.

    Reference parity: ``pid_runtime/pid_runtime_connector.h`` kTable
    ("bcc_pid_cpu_usage": {time_, pid, runtime_ns, cmd}). The reference
    sums sched-switch deltas in a BPF map; without kernel probes the
    same cumulative gauge comes from /proc/<pid>/stat utime+stime
    (ticks -> ns).
    """

    name = "pid_runtime"
    tables = [("bcc_pid_cpu_usage", PID_RUNTIME_RELATION)]

    def __init__(self, max_procs: int = 256, **kw):
        super().__init__(**kw)
        self.max_procs = max_procs
        self._ns_per_tick = 1_000_000_000 // os.sysconf("SC_CLK_TCK")

    def transfer_data(self, ctx, data_tables) -> None:
        rows = {k: [] for k, _ in PID_RUNTIME_RELATION.items()}
        now = time.time_ns()
        count = 0
        for pid_s in os.listdir("/proc"):
            if not pid_s.isdigit():
                continue
            if count >= self.max_procs:
                break
            parsed = _read_pid_stat(pid_s)
            if parsed is None:
                continue
            comm, fields = parsed
            rows["time_"].append(now)
            rows["pid"].append(int(pid_s))
            # utime+stime are post-comm fields 11/12 (overall 14/15).
            rows["runtime_ns"].append(
                (int(fields[11]) + int(fields[12])) * self._ns_per_tick
            )
            rows["cmd"].append(comm)
            count += 1
        data_tables["bcc_pid_cpu_usage"].append(rows)


class ProcExitConnector(SourceConnector):
    """Process-exit events, procfs edition.

    Reference parity: ``proc_exit/proc_exit_events_table.h``
    kProcExitEventsTable ({time_, upid, exit_code, signal, comm}). The
    reference hooks the sched_process_exit tracepoint; without kernel
    probes (SCOPING.md) an exit is a (pid, start_ticks) incarnation that
    vanishes between two /proc scans. exit_code/signal are tracepoint-
    only — procfs does not expose another process's exit status — so
    both report -1 (unknown).
    """

    name = "proc_exit"
    tables = [("proc_exit_events", PROC_EXIT_EVENTS_RELATION)]

    def __init__(self, asid: int = 1, **kw):
        super().__init__(**kw)
        self.asid = asid
        self._seen: dict = {}  # pid -> (start_ticks, comm)

    def _scan(self) -> dict:
        out = {}
        for pid_s in os.listdir("/proc"):
            if not pid_s.isdigit():
                continue
            parsed = _read_pid_stat(pid_s)
            if parsed is None:
                continue
            comm, fields = parsed
            # starttime is post-comm field 19 (overall field 22).
            out[int(pid_s)] = (int(fields[19]), comm)
        return out

    def transfer_data(self, ctx, data_tables) -> None:
        cur = self._scan()
        prev, self._seen = self._seen, cur
        if not prev:
            return  # first scan only establishes the baseline
        now = time.time_ns()
        hi, lo, rows = [], [], {"time_": [], "exit_code": [], "signal": [], "comm": []}
        for pid, (start, comm) in prev.items():
            if cur.get(pid, (None, None))[0] == start:
                continue  # same incarnation still running
            u = UPID(self.asid, pid, start)
            hi.append(u.hi)
            lo.append(u.lo)
            rows["time_"].append(now)
            rows["exit_code"].append(-1)
            rows["signal"].append(-1)
            rows["comm"].append(comm)
        if not rows["time_"]:
            return
        rows["upid"] = np.stack(
            [np.array(hi, np.uint64), np.array(lo, np.uint64)], axis=1
        )
        data_tables["proc_exit_events"].append(rows)


#: stirling_error status codes (reference px::statuspb::Code subset).
ERROR_STATUS_OK = 0
ERROR_STATUS_FAILED = 2  # UNKNOWN: generic runtime collection failure


class StirlingErrorConnector(SourceConnector):
    """Self-observability: connector install status + runtime errors.

    Reference parity: ``stirling_error/stirling_error_table.h``
    kStirlingErrorElements ({time_, upid, source_connector, status,
    error}). ``ctx`` is the Collector: each registered connector gets
    one status row when first observed (0 = OK), and every entry
    appended to ``Collector.errors`` since the previous transfer
    becomes a status-2 row carrying the message.
    """

    name = "stirling_error"
    tables = [("stirling_error", STIRLING_ERROR_RELATION)]

    def __init__(self, asid: int = 1, **kw):
        super().__init__(**kw)
        self.asid = asid
        self._reported: set = set()
        self._err_cursor = 0

    def transfer_data(self, ctx, data_tables) -> None:
        rows = {"time_": [], "source_connector": [], "status": [], "error": []}
        now = time.time_ns()
        for c in list(getattr(ctx, "_connectors", [])):
            if c.name in self._reported:
                continue
            self._reported.add(c.name)
            rows["time_"].append(now)
            rows["source_connector"].append(c.name)
            rows["status"].append(ERROR_STATUS_OK)
            rows["error"].append("")
        errors = getattr(ctx, "errors", [])
        fresh, self._err_cursor = errors[self._err_cursor :], len(errors)
        for src, msg in fresh:
            rows["time_"].append(now)
            rows["source_connector"].append(src)
            rows["status"].append(ERROR_STATUS_FAILED)
            rows["error"].append(msg)
        n = len(rows["time_"])
        if n == 0:
            return
        u = UPID(self.asid, os.getpid(), 0)
        rows["upid"] = np.stack(
            [np.full(n, u.hi, np.uint64), np.full(n, u.lo, np.uint64)], axis=1
        )
        data_tables["stirling_error"].append(rows)
