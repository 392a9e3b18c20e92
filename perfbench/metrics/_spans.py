"""Shared by the readers of the program's spans: the ``mri.*`` ranges that
``mri_inr_tpu_torch/utils/profiling.py`` records while a profiler records,
which the trace holds among its host events, on the clock of the card's
kernels.

- :func:`per_entry_ms`: the host milliseconds of one span inside each entry
  of another (its parent by containment), the median over the parent's
  entries that lie in the traced window;
- :func:`idle_under_ms`: the card's idle milliseconds under a set of spans
  a traced unit: the union of the idle gaps (``core/trace.py:gaps`` over
  the device intervals) met with the union of the spans, clipped to the
  window, over ``trace.units``.

Each returns None when the trace holds no such span (a program that
records none)."""

import statistics

from perfbench.core.trace import gaps


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_seconds(a, b) -> float:
    """The length of the meeting of two unions of intervals."""
    a, b = _merged(a), _merged(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def per_entry_ms(ctx, name: str, parent: str):
    tr = ctx.trace
    if tr is None:
        return None
    lo, hi = tr.window
    kids = [(s, e) for n, s, e in tr.host if n == name]
    parents = [(s, e) for n, s, e in tr.host if n == parent and s >= lo and e <= hi]
    if not kids or not parents:
        return None
    per = [sum(ke - ks for ks, ke in kids if ks >= ps and ke <= pe) for ps, pe in parents]
    return 1e3 * statistics.median(per)


def idle_under_ms(ctx, match):
    """``match(name)`` picks the spans."""
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    lo, hi = tr.window
    cover = [(max(s, lo), min(e, hi)) for n, s, e in tr.host if match(n) and e > lo and s < hi]
    if not cover:
        return None
    idle = gaps([(s, e) for _, s, e in tr.device], lo, hi)
    return 1e3 * overlap_seconds(idle, cover) / tr.units
