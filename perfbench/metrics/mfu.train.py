"""The whole train step's share of the card's bf16 peak: model FLOP (three
forward passes a patch, nothing recomputed counted) times the patches
stepped in the window's untraced epochs, over their seconds, over 989
TFLOP/s. Bounded by the tensor-core peak: no step can pass it."""


def read(ctx):
    steps, secs = ctx.counts.get("steps_untraced"), ctx.counts.get("seconds_untraced")
    if not steps or not secs:
        return None
    flops = 3 * ctx.work.model_forward_flops(ctx.config["model"]) * ctx.counts["batch"] * steps
    return 100.0 * flops / secs / ctx.work.PEAK_BF16_FLOPS
