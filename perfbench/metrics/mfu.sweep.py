"""The whole sweep's share of the card's bf16 peak: model forward FLOP of
every patch the window's untraced sweeps scored, over their seconds, over
989 TFLOP/s."""


def read(ctx):
    units, secs = ctx.counts.get("units_untraced"), ctx.counts.get("seconds_untraced")
    if not units or not secs:
        return None
    patches = units * ctx.counts["slices_per_unit"] * ctx.counts["patches_per_slice"]
    flops = ctx.work.model_forward_flops(ctx.config["model"]) * patches
    return 100.0 * flops / secs / ctx.work.PEAK_BF16_FLOPS
