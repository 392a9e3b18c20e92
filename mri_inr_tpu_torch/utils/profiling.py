"""Profiling helpers (counterpart of ``mri_inr_tpu/utils/profiling.py``): a
wall-clock section timer that is also the program's span recorder, an
opt-in ``torch.profiler`` trace and a timer for one call.

- :class:`SectionTimer`: wall-clock seconds and entries per named section;
  while a ``torch.profiler`` records, each section is also a
  ``record_function`` range, so it lands on the profiler's clock beside the
  card's kernels (nesting gives the parent span by containment).
- :data:`SPANS`: the process-wide recorder the program's spans use
  (``mri.epoch.*``, ``mri.train.*``, ``mri.data.*``, ``mri.sweep.*``),
  :func:`span`, its ``section``, and :func:`span_report`, its table.
- :func:`device_trace`: a ``torch.profiler`` trace (CPU activity, and the
  card's kernels where one is present) written as a Chrome trace
  (``chrome://tracing``, Perfetto) under ``log_dir``; nothing for ``None``.
- :func:`time_fn`: the median time of a call; with CUDA events after a
  warm-up when its result lies on the card, with ``perf_counter`` on the CPU.
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import time

import torch


class _Section:
    """One entry of a section: a context manager whose ``seconds`` holds the
    entry's host seconds once it has left."""

    __slots__ = ("timer", "name", "seconds", "_t0", "_range")

    def __init__(self, timer: "SectionTimer", name: str):
        self.timer, self.name, self.seconds, self._range = timer, name, 0.0, None

    def __enter__(self) -> "_Section":
        # the cheap flag first: a record_function costs tens of microseconds
        # with no profiler to take it
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.timer._add(self.name, self.seconds)


class SectionTimer:
    """Host seconds (``sections``) and entries (``counts``) per named
    section. ``with timer.section(name) as s:`` times the block, also when
    it raises; ``s.seconds`` is the entry's own time."""

    def __init__(self):
        self.sections: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def section(self, name: str) -> _Section:
        return _Section(self, name)

    def _add(self, name: str, secs: float) -> None:
        self.sections[name] = self.sections.get(name, 0.0) + secs
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.sections.clear()
        self.counts.clear()

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [f"{'section':<30}{'seconds':>10}{'share':>8}"]
        for name, secs in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<30}{secs:>10.3f}{secs / total:>7.1%}")
        return "\n".join(lines)


#: the program's spans: one recorder a process (``SPANS.reset()`` to start
#: a new table)
SPANS = SectionTimer()
span = SPANS.section


def span_report() -> str:
    """:data:`SPANS`' host seconds and entries per span, the longest first.
    No share: the spans nest, so a parent's seconds hold its children's."""
    lines = [f"{'span':<30}{'seconds':>10}{'entries':>9}"]
    for name, secs in sorted(SPANS.sections.items(), key=lambda kv: -kv[1]):
        lines.append(f"{name:<30}{secs:>10.3f}{SPANS.counts[name]:>9}")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path | None):
    """Trace the block with ``torch.profiler`` and write
    ``{log_dir}/trace_{timestamp}.json`` when ``log_dir`` is set; yields the
    profiler (``key_averages()`` for sums by operation), or None without a
    ``log_dir``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.strftime('%Y%m%d-%H%M%S')}.json"))


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(o) for o in out)
    if isinstance(out, dict):
        return any(_on_card(o) for o in out.values())
    return False


def time_fn(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median seconds of ``fn(*args)``. Where the warm-up's result holds a
    tensor on the card, each call is timed by CUDA events around it (the
    device's time for the work the call enqueues); else by the host clock."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    times = []
    if _on_card(out):
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)
