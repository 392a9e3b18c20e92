#!/usr/bin/env python3
"""Time the port's SIREN kernels from two checkouts of the repository in
turns, on one card: this tree's wrappers and another tree's (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, such as ``proof/``), each at its main path's shape.

    python3 scripts/torch_kernel_ab.py OTHER_TREE [KERNEL ...]

KERNEL is ``siren_forward`` (the eval forward, B=1024, degree-5 / degree-7
sines), ``siren_forward_int8`` (B=1024), ``siren_train_fwd`` or
``siren_train_bwd`` (B=400, dropout 0.1, degree-5 sines); all four by
default. Every turn is a process of its own that imports the package of its
tree, so each tree runs its own wrappers and kernels; the turns go other,
this, this, other (a tree's first turn builds its kernels into that tree's
``_build/``, its second reuses them). The inputs are ``chip_smoke.py``'s
(seeded, full width); each wrapper gets its weights as the main path hands
them over (W^T, or the int8 weight pack, made once). Times are CUDA-event
medians of 20 calls, printed with the card's name and power limit. Needs
the CUDA toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent.parent
KERNELS = ("siren_forward", "siren_forward_int8", "siren_train_fwd", "siren_train_bwd")


def one_turn(tree: pathlib.Path, kernels: list[str]) -> dict:
    """Build and time ``kernels`` with the package of ``tree``."""
    import torch

    sys.path.insert(0, str(tree))
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.ops import _build
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk

    if not pathlib.Path(sk.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {sk.__file__}, not the package of {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.build, kernels))
    dev = torch.device("cuda")
    calls = {}
    if "siren_forward" in kernels:
        mods, kp = cs.kernel_inputs(sk, ms, "sine", dev)
        s_wt = kp.s_w.transpose(1, 2).contiguous()
        calls["siren_forward"] = lambda: sk.siren_forward_cuda(
            mods, kp.base, kp.s_w, kp.s_b, kp.last_b, num_layers=5, sin7=True, sin5=True,
            s_wt=s_wt)
    if "siren_forward_int8" in kernels:
        iargs = cs.int8_inputs(sk, ms, "sine", dev)
        pack = getattr(sk, "int8_kernel_weights", None)  # a tree before it: (out, in)
        swq_k = pack(iargs[4]) if pack else iargs[4].transpose(1, 2).contiguous()
        calls["siren_forward_int8"] = lambda: sk.siren_forward_int8_cuda(
            *iargs, num_layers=5, swq_t=swq_k)
    if {"siren_train_fwd", "siren_train_bwd"} & set(kernels):
        targs, cot = cs.train_kernel_inputs(sk, ms, "sine", dev)
        tkw = dict(num_layers=5, dropout_rate=0.1, sin5=True)
        t_wt = targs[3].transpose(1, 2).contiguous()
        calls["siren_train_fwd"] = lambda: stk.siren_chain_train_fwd_cuda(*targs, **tkw,
                                                                         s_wt=t_wt)
        calls["siren_train_bwd"] = lambda: stk.siren_chain_train_bwd_cuda(*targs, cot, **tkw,
                                                                         s_wt=t_wt)
    return {k: cs.cuda_median_ms(calls[k]) for k in kernels}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--turn":
        print(json.dumps(one_turn(pathlib.Path(sys.argv[2]), sys.argv[3:])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    other = pathlib.Path(sys.argv[1]).resolve()
    kernels = sys.argv[2:] or list(KERNELS)
    unknown = [k for k in kernels if k not in KERNELS]
    if unknown:
        raise SystemExit(f"unknown kernel(s) {unknown}; known: {KERNELS}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = {"this": [], "other": []}
    for which in ("other", "this", "this", "other"):
        tree = REPO if which == "this" else other
        proc = subprocess.run([sys.executable, __file__, "--turn", str(tree), *kernels],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"turn in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for k in kernels:
        this = " / ".join(f"{r[k]:.4f}" for r in runs["this"])
        was = " / ".join(f"{r[k]:.4f}" for r in runs["other"])
        print(f"{k}: this tree {this} ms/call, {other.name} {was} ms/call (two turns each, "
              f"in the order other, this, this, other) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
