"""What a traced run records, and the arithmetic the metric readers share.

A traced run profiles a few of its window's jobs with ``torch.profiler``
and keeps a plain record of them (a JSON-able dict, so the readers can be
tested on a small recorded one):

- ``window_s``: the traced jobs' wall time, host clock, ending in a sync;
- ``input_mb``: their input, in MB of 10**6 bytes; ``jobs``: how many;
- ``device``: every device activity (kernel, copy, memset) as
  ``[start_us, end_us, name]``, without the host ranges that the profiler
  mirrors onto the device's timeline;
- ``host_ranges``: the ``corpus.*`` ranges of the program and the
  ``portbench.*`` spans of the harness, ``{name: [[start_us, end_us], ...]}``;
- ``launches``: the program's kernel counters over the traced jobs;
- ``cards``: ``[{"busy_s", "window_s"}, ...]``, one a card (the ranks form);
- ``serial_ms``: rank 0's gather and packed splice, a job (the ranks form);
- ``config``: the cell's configuration (the kernels' operand shapes).
"""

from __future__ import annotations

import re
import time

# Host ranges the harness reads; the profiler mirrors them onto the device.
RANGE_PREFIXES = ("corpus.", "portbench.")


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end, ...)`` intervals."""
    busy, lo, hi = 0.0, None, None
    for start, end, *_ in sorted(intervals):
        if hi is None or start > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        busy += hi - lo
    return busy


def merged(intervals) -> list:
    """The union of ``(start, end, ...)`` intervals as sorted disjoint pairs."""
    out = []
    for start, end, *_ in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def kernel_base(name: str) -> str:
    """A kernel's qualified name without its return type, anonymous
    namespaces, template and argument list: ``void (anonymous
    namespace)::f<true>(int*)`` gives ``f``."""
    m = re.match(r"(?:void\s+)?([A-Za-z_][\w:]*)", name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def record(prof, *, window_s: float, input_bytes: int, jobs: int, launches: dict,
           config: dict) -> dict:
    """The plain record of one ``torch.profiler`` trace (see the module
    docstring)."""
    from torch.autograd import DeviceType

    device, ranges = [], {}
    for e in prof.events():
        name = e.name
        if name.startswith(RANGE_PREFIXES):
            if e.device_type == DeviceType.CPU:
                ranges.setdefault(name, []).append([e.time_range.start, e.time_range.end])
        elif e.device_type == DeviceType.CUDA:
            device.append([e.time_range.start, e.time_range.end, name])
    return {"window_s": window_s, "input_mb": input_bytes / 1e6, "jobs": jobs,
            "device": device, "host_ranges": ranges, "launches": launches, "config": config}


class Traced:
    """The profiler over a window's jobs 2 to ``1 + n`` (none where ``n`` is
    0): the first job is left out, so that the trace starts in a steady
    window.  ``record`` is set once the traced jobs are done."""

    def __init__(self, n: int, device, job_bytes: int, config: dict):
        self.n, self.device, self.job_bytes, self.config = n, device, job_bytes, config
        self.prof = self.record = None
        self.open = False

    def pending(self, started: int) -> bool:
        """Whether the window must run on for the traced jobs."""
        return started < 1 + self.n if self.n else False

    def before(self, started: int) -> None:
        """Called before each job with the count of jobs started."""
        from . import program

        if self.n and started == 1:
            program.sync(self.device)
            self._launches, self.prof = program.launches(), program.profiler(self.device)
            self.prof.__enter__()
            self.open = True
            self._t = time.perf_counter()

    def after(self, started: int) -> None:
        """Called after each job that answered."""
        from . import program

        if self.open and started == 1 + self.n:
            program.sync(self.device)
            wall = time.perf_counter() - self._t
            self.close()
            self.record = record(self.prof, window_s=wall, input_bytes=self.n * self.job_bytes,
                                 jobs=self.n, launches=program.launches_since(self._launches),
                                 config=self.config)

    def close(self) -> None:
        """Stop the profiler if it runs (a window cut short by a failure)."""
        if self.open:
            self.open = False
            self.prof.__exit__(None, None, None)


def device_seconds(trace: dict) -> float:
    """Seconds in which any activity ran on the device."""
    return busy_us(trace["device"]) / 1e6


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by the host range the host was in (innermost), each list
    longest first."""
    ops = {}
    for start, end, name in trace["device"]:
        key = kernel_base(name)[:96]
        ops[key] = ops.get(key, 0.0) + (end - start) / 1e6
    busy = merged(trace["device"])
    spans = sorted((s, e, n) for n, rs in trace["host_ranges"].items() for s, e in rs)
    # The traced span of time runs from the first thing the host or the
    # device did to the last: idle edges count as gaps too.
    if busy and spans:
        lo, hi = min(busy[0][0], spans[0][0]), max(busy[-1][1], max(e for _, e, _ in spans))
        busy = [[lo, lo]] + busy + [[hi, hi]]
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [(s, n) for s, e, n in spans if s <= mid <= e]
        key = max(inner)[1] if inner else "outside any span"
        gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:top]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
