"""The train forward kernel (``ops/csrc/siren_train_fwd.cu`` on
``siren_fwd.cuh``, one launch a step) against 2 B S H^2 (L-1) bf16 FLOP,
its float32 epilogue work (degree-5 sine, dropout hash, modulation) and its
bytes. At the flagship's shapes the tensor term bounds it."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric__roofline", pathlib.Path(__file__).with_name("_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)

PATTERN = r"forward_kernel.*TrainEpilogue"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls = len(tr.kernels(PATTERN))
    if not calls:
        return None
    m, w = ctx.config["model"], ctx.work
    b, s, h, l = ctx.counts["batch"], m["siren_patch_size"] ** 2, m["dim_hidden"], m["num_layers"]
    bound, _ = w.bound_seconds(w.chain_products(b, s, h, l),
                               w.chain_f32_ops(b, s, h, l, "train_fwd"),
                               w.chain_bytes(b, s, h, l, grads=False))
    return _r.share(ctx, PATTERN, calls * bound)
