"""What a profiled stretch of a run's window shows of the device.

Read from torch.profiler's raw records (``kineto_results.events()``):
building the profiler's event tree costs seconds for a stretch of many
queries. The busy time is the union of the card's kernel, copy and set
intervals, so work that overlaps counts once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

NOT_KERNELS = ("Memcpy", "Memset")
DEVICE, GAPS = "device", "gaps"  # the two stretches a traced run profiles


class Profiler:
    """Profiles stretches of the window one after another, from the
    thread that runs the queries: ``tick`` before each query starts or
    ends a stretch once its seconds have passed, so a stretch holds whole
    queries. ``DEVICE`` records device activity only; ``GAPS`` host ops
    too. Without a card (the CPU tests) the host is profiled instead, and
    no device op is found. ``done[kind]`` is (host-clock start, end,
    ``records``)."""

    def __init__(self, plan: list, sync, on_card: bool):
        self.plan = list(plan)  # [(kind, seconds)]
        self.sync = sync
        self.on_card = on_card
        self.cur = None
        self.done: dict = {}

    def _activities(self, kind: str) -> list:
        from torch.profiler import ProfilerActivity

        card = [ProfilerActivity.CUDA] if self.on_card else []
        if kind == DEVICE and card:
            return card
        return [ProfilerActivity.CPU, *card]

    def _stop(self) -> None:
        kind, prof, a, _ = self.cur
        self.sync()
        b = time.perf_counter()
        prof.stop()
        self.done[kind] = (a, b, records(prof))
        self.cur = None

    def tick(self) -> None:
        if self.cur is not None:
            if time.perf_counter() - self.cur[2] < self.cur[3]:
                return
            self._stop()
        if self.plan:
            from torch.profiler import profile

            kind, seconds = self.plan.pop(0)
            prof = profile(activities=self._activities(kind))
            prof.start()
            self.cur = (kind, prof, time.perf_counter(), seconds)

    def close(self) -> None:
        if self.cur is not None:
            self._stop()


@dataclass
class Stretch:
    """One profiled stretch: its wall time by the host clock, the
    queries in it (those cut by its edges count by the share of them
    inside), the union of device intervals, and each device op."""

    t0: float  # host clock (time.perf_counter) at its start and its end
    t1: float
    queries: float
    busy_s: float
    ops: list = field(default_factory=list)  # [(name, seconds)], each device op

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> list:
        """The device ops that are kernels, not copies or sets."""
        return [(n, s) for n, s in self.ops if not n.startswith(NOT_KERNELS)]


def warm_profiler(on_card: bool) -> None:
    """Start and stop the profiler once, so that its first start (about
    two seconds) falls in the set-up of a traced run, not its stretch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]):
        pass


def records(prof):
    """(device [(name, start_ns, end_ns)], host [(name, start_ns, end_ns)])
    of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            dev.append(rec)
        elif e.device_type() == DeviceType.CPU:
            host.append(rec)
    return dev, host


def merged(spans) -> list:
    """Sorted, disjoint [start, end] intervals covering ``spans``."""
    out: list = []
    for _, start, end in sorted(spans, key=lambda r: r[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def busy_s(dev) -> float:
    return sum(b - a for a, b in merged(dev)) / 1e9


def queries_within(spans, lo: float, hi: float) -> float:
    """Queries ([start, end] on the host clock) inside [lo, hi], each
    counted by the share of it that lies inside."""
    n = 0.0
    for a, b in spans:
        if b > a:
            n += max(0.0, min(b, hi) - max(a, lo)) / (b - a)
    return n


NAME_CHARS = 120  # a kernel's name is cut there: its template arguments run on


def top(pairs, k: int = 10) -> list:
    """[[name, seconds]] of the ``k`` names with the most seconds."""
    tot: dict = {}
    for name, s in pairs:
        name = name[:NAME_CHARS]
        tot[name] = tot.get(name, 0.0) + s
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(dev, host, k: int = 10) -> list:
    """The device's idle gaps inside the stretch, summed by the host op
    that was running at each gap's middle (the innermost, the one that
    started last; "host" where none was), the ``k`` largest."""
    busy = merged(dev)
    ops = sorted(host, key=lambda r: r[1])
    gaps = []
    i, open_ops = 0, []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        while i < len(ops) and ops[i][1] <= mid:
            open_ops.append(ops[i])
            i += 1
        open_ops = [o for o in open_ops if o[2] >= mid]
        name = max(open_ops, key=lambda o: o[1])[0] if open_ops else "host"
        gaps.append((name, (start - end) / 1e9))
    return top(gaps, k)
