"""The traced part of a window: ``torch.profiler`` over the first units of
the window, reduced to device intervals and host events.

- :func:`union_seconds`: the length of the union of intervals, so that
  kernels and copies that overlap on several streams count once; the busy
  time of the device, and ``1 - busy / window`` its idle share.
- :class:`Trace`: device events (kernels, copies, sets) and host events of
  the traced window, with the window's host start and end.
- :func:`breakdown`: the device operations that took most time, and the
  longest gaps between device intervals, each named by the innermost host
  event that covers the gap's midpoint (what the host was doing).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


MARK = "perfbench.traced"


@dataclass
class Trace:
    window: tuple[float, float]  # the traced window, in the profiler's clock (seconds)
    device: list = field(default_factory=list)  # (name, start_s, end_s)
    host: list = field(default_factory=list)  # (name, start_s, end_s)
    units: int = 0  # units of work the traced window held

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device])

    def kernels(self, pattern: str) -> list[tuple[str, float, float]]:
        rx = re.compile(pattern)
        return [ev for ev in self.device if rx.search(ev[0])]


def device_work(device: list, host: list) -> list:
    """The events of the card's timeline that are its work (kernels, copies,
    sets): the profiler also puts each host annotation's range there (such
    as :data:`MARK`'s), under the host event's own name, which no kernel or
    copy bears."""
    annotations = {name for name, _, _ in host}
    return [ev for ev in device if ev[0] not in annotations]


def short_name(name: str) -> str:
    """A kernel's name without its argument list, return type and anonymous
    namespaces."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):  # cut the argument list at its matching parenthesis
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].strip()
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


class Profiler:
    """``torch.profiler`` (host and device activity) for the traced units:
    :meth:`start` it in set-up, run one unit under it so that the tracer's
    own start-up falls outside the window, :meth:`open` the window (a host
    event named :data:`MARK`), and :meth:`stop` after the traced units. The
    window is that event's span, in the profiler's clock; device intervals
    are clipped to it."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self._prof = profile(activities=acts)
        self._device = device
        self._mark = None

    def start(self) -> None:
        self._prof.__enter__()

    def open(self) -> None:
        from torch.profiler import record_function
        self._mark = record_function(MARK)
        self._mark.__enter__()

    def stop(self, units: int) -> Trace:
        import torch
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        device, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            start = ev.start_ns() / 1e9
            end = start + ev.duration_ns() / 1e9
            on_card = str(ev.device_type()).endswith("CUDA")
            (device if on_card else host).append((ev.name(), start, end))
        device = device_work(device, host)
        marks = [(s, e) for n, s, e in host if n == MARK]
        if not marks:
            raise RuntimeError(f"the trace holds no {MARK!r} event")
        lo, hi = marks[0]
        trace = Trace(window=(lo, hi), units=units)
        trace.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
        trace.host = [(n, s, e) for n, s, e in host if e > lo and s < hi and n != MARK]
        return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    by_name: dict[str, float] = {}
    for name, s, e in trace.device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    holes = sorted(gaps([(s, e) for _, s, e in trace.device], lo, hi),
                   key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in holes:
        mid = (s + e) / 2
        cover = [(he - hs, n) for n, hs, he in trace.host if hs <= mid <= he]
        named.append([min(cover)[1] if cover else "host between traced calls (Python)", e - s])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}
