"""Host milliseconds in which ``evaluate_files_device`` enqueues a sweep's
work (its ``dispatch_seconds``), the median over the window's sweeps."""

import statistics


def read(ctx):
    spans = ctx.spans.get("sweep_dispatch_s")
    return 1e3 * statistics.median(spans) if spans else None
