"""The module route's dropout mask kernel (``ops/csrc/threefry_dropout.cu``,
one launch a hidden layer and step, a (B, S, H) keep mask of one byte an
element) against its integer work, 85 operations an element counted at the
67 TFLOP/s float32 rate (no integer unit of the card is faster, so the share
cannot pass 100%), and its bytes (the key in, the mask out). The operation
term bounds it."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric__roofline", pathlib.Path(__file__).with_name("_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)

PATTERN = r"threefry_keep_mask_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls = len(tr.kernels(PATTERN))
    if not calls:
        return None
    m, w = ctx.config["model"], ctx.work
    numel = ctx.counts["batch"] * m["siren_patch_size"] ** 2 * m["dim_hidden"]
    bound, _ = w.bound_seconds(0, w.THREEFRY_OPS_PER_ELEMENT * numel, numel + 8)
    return _r.share(ctx, PATTERN, calls * bound)
