#!/usr/bin/env python3
"""Phase 13's fp32 witness of ``chip_smoke.py`` on the CPU, at the card's
widths: one process stepping on the two ranks' halves of every batch
(``tests/torch_port_ranks.halves_step_body``) against one process on the
whole batch, through the kernels' plain versions; and the phase's one fp32
step, halves against whole, by parameter group.

    python3 scripts/torch_halves_witness.py [--epochs 3] [--set model.dim_hidden=32 ...] \\
        [--out F.json]

The corpus is phase 13's: ``chip_smoke.preprocess_volumes`` of the smoke's
phantom volumes (2 x 8 slices at 320x320 for training, one of 4 for
validation) on the CPU's DFT route. The model is ``configs/train.yaml``'s
(H=256, latent 256, L=5, batch 400: 16 steps an epoch) in fp32, dropout
off, Adam at lr 1e-4, ``training.device_data=true``; ``--set`` overrides
follow. Prints
each epoch's train and validation losses of both runs and their largest
relative gap (``chip_smoke.loss_gap``), which on the card reads 9.413e-4 in
fp32 and ``tests/test_torch_port_parallel_cli.py`` reads 1.221e-5 on the
CPU at H=32. Then ``chip_smoke.halves_gradient_gap`` on the CPU: one fp32
step's gradients on phase 13's global batch of 400 against the mean of its
two halves', per parameter group (the phase prints the card's). With
``--epochs 0`` only the step. About 20 minutes for one epoch on an 8-core
CPU shared with other work, 40 s for the step.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from mri_inr_tpu_torch.cli import train as cli_train  # noqa: E402
from mri_inr_tpu_torch.configuration import config  # noqa: E402
from mri_inr_tpu_torch.data import preprocessing, synthetic  # noqa: E402
from mri_inr_tpu_torch.ops import siren_train_kernel as stk  # noqa: E402
from mri_inr_tpu_torch.ops import tiling  # noqa: E402
from mri_inr_tpu_torch.train import losses, trainer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--set", dest="sets", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    pkg = dict(config=config, synthetic=synthetic, preprocessing=preprocessing,
               cli_train=cli_train, trainer=trainer, stk=stk, losses=losses, tiling=tiling)
    t0 = time.perf_counter()
    report = {"command": sys.argv, "precision": "fp32", "epochs": args.epochs,
              "sets": args.sets}
    if args.epochs:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            meta, _ = cs.preprocess_volumes(pkg, tmp / "processed", range(cs.VOLUMES), "cpu",
                                            cs.SLICES_PER_VOLUME)
            val_meta, _ = cs.preprocess_volumes(pkg, tmp / "val", [100], "cpu", 4)
            train_argv = ["--config", str(REPO / "configs" / "train.yaml"), "--device", "cpu",
                          "--set", f"data.train.dataset={meta}",
                          "--set", f"data.val.dataset={val_meta}",
                          "--set", "training.save_interval=1000",
                          "--set", "training.device_data=true", "--set", "model.dropout=0.0",
                          "--set", "training.precision=fp32"]
            for s in args.sets:
                train_argv += ["--set", s]
            runs = cs.witness_runs(pkg, tmp, train_argv, "fp32", epochs=args.epochs)
        gap = cs.loss_gap(runs["halves"], runs["whole"])
        for e, (whole, halves) in enumerate(zip(runs["whole"], runs["halves"])):
            print(f"epoch {e}: whole batch train {whole[0]:.8f} val {whole[1]:.8f}; two halves "
                  f"train {halves[0]:.8f} val {halves[1]:.8f}")
        print(f"fp32, {args.epochs} epoch(s), sets {args.sets}: the halves lie "
              f"{gap:.3e} (relative, largest over epochs) from the whole batch "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        report.update(whole=runs["whole"], halves=runs["halves"], gap=gap,
                      seconds=time.perf_counter() - t0)
    t1 = time.perf_counter()
    report["step_gradient_gap"] = cs.halves_gradient_gap(pkg, "cpu")
    print("one fp32 step, the two halves' mean gradient against the whole batch's: " + "; ".join(
        f"{g} {v['relative']:.3e} relative, max |diff| {v['max_abs']:.3e}"
        for g, v in report["step_gradient_gap"].items()) + f" ({time.perf_counter() - t1:.1f} s)")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
