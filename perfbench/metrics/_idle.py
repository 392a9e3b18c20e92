"""Shared by the ``device_idle_pct.*`` readers: the share of the traced
window in which no kernel, copy or set ran on the card, from the union of
the device intervals (overlapping streams count once)."""


def idle_pct(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
