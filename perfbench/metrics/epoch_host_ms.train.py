"""Host milliseconds of a train epoch's call (``ScanEpoch.launch_seconds``:
staging the permutation and the dropout draws, and the graph replay up to
its return), the median over the window's train epochs."""

import statistics


def read(ctx):
    spans = ctx.spans.get("epoch_host_s")
    return 1e3 * statistics.median(spans) if spans else None
