"""Shared by the ``*_roofline`` readers: the least time the card could take
for the traced calls (the largest of their bf16 tensor operations at 989
TFLOP/s, their float32 operations at 67 TFLOP/s and their bytes at 3.35
TB/s, each input byte once and each output byte once), over the device
time of the kernels that make up the call, from the trace, in percent."""


def share(ctx, pattern: str, bound_s: float) -> float | None:
    tr = ctx.trace
    if tr is None:
        return None
    busy = sum(e - s for _, s, e in tr.kernels(pattern))
    if busy <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / busy

