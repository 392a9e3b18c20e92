"""The eval forward kernel (``ops/csrc/siren_forward.cu`` on
``siren_fwd.cuh``, one launch a sweep piece) against 2 B S H^2 (L-1) bf16
FLOP over the patches the traced sweeps scored, its float32 epilogue work
and its bytes (the calls' weights once each). The tensor term bounds it."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric__roofline", pathlib.Path(__file__).with_name("_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)

PATTERN = r"forward_kernel.*EvalEpilogue"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls = len(tr.kernels(PATTERN))
    if not calls or not tr.units:
        return None
    m, w = ctx.config["model"], ctx.work
    s, h, l = m["siren_patch_size"] ** 2, m["dim_hidden"], m["num_layers"]
    patches = tr.units * ctx.counts["slices_per_unit"] * ctx.counts["patches_per_slice"]
    per_call = patches / calls
    bound, _ = w.bound_seconds(w.chain_products(per_call, s, h, l),
                               w.chain_f32_ops(per_call, s, h, l, "eval"),
                               w.chain_bytes(per_call, s, h, l, grads=False))
    return _r.share(ctx, PATTERN, calls * bound)
