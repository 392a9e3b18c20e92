"""The train backward (``ops/csrc/siren_train_bwd.cu``: the chain kernel,
the split-K dW kernel and the ordered sums, one wrapper call a step) against
the work the gradients need: the dX and dW products of the hidden layers,
4 B S H^2 (L-1) bf16 FLOP (the forward the chain kernel recomputes is not
counted), the reverse sweep's float32 epilogue work, the call's bytes. At
the flagship's shapes the tensor term bounds it."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "perfbench_metric__roofline", pathlib.Path(__file__).with_name("_roofline.py"))
_r = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_r)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls = len(tr.kernels(r"chain_kernel"))
    if not calls:
        return None
    m, w = ctx.config["model"], ctx.work
    b, s, h, l = ctx.counts["batch"], m["siren_patch_size"] ** 2, m["dim_hidden"], m["num_layers"]
    bound, _ = w.bound_seconds(2 * w.chain_products(b, s, h, l),
                               w.chain_f32_ops(b, s, h, l, "train_bwd"),
                               w.chain_bytes(b, s, h, l, grads=True))
    return _r.share(ctx, r"chain_kernel|dw_kernel|ordered_sum_kernel", calls * bound)
