#!/usr/bin/env python3
"""Why the residual quality row trains slower on the port than on the JAX
package: the row's first epochs under variants of the module path.

    python3 scripts/torch_residual_probe.py [--epochs 30] [--variants ...]
    python3 scripts/torch_residual_probe.py --device cpu --size 96 --files 4 \\
        --set model.dim_hidden=64 --set model.latent_dim=32 --set training.batch_size=64

The residual row (``cli/results_run.py``, ``model.residual=true``) trains
through the module path. Each variant trains the row's model from the same
seed, on the protocol's splits (``quality_run.make_splits``; 24 / 4 train /
validation volumes x 4 slices at 256x256 by default) with the row's conv
autoencoder spliced in, and prints its train / validation losses by epoch.
A variant is ``MODE:MASK[:OPTION]``:

- MODE ``graphed`` (``training.device_data``: an epoch is one CUDA graph on
  the card) or ``eager`` (step by step);
- MASK ``hash`` (the port's counter-hash dropout, the fused kernels' masks)
  or ``rand`` (independent masks from a seeded ``torch.Generator``, as a
  framework's dropout draws them; eager only: the draw reads the seed on the
  host);
- OPTION ``nobf16red`` (cuBLAS's reduced-precision bf16 reductions off),
  ``fp32`` (``training.precision=fp32``) or ``nodrop`` (``model.dropout=0``).

The JAX row's log (``runs/results/residual/*/progress_log.csv``) reads a
validation loss of 0.0075 at epoch 5 and 0.0024 at epoch 30.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from mri_inr_tpu_torch.cli import quality_run as qr  # noqa: E402
from mri_inr_tpu_torch.cli import train as cli_train  # noqa: E402
from mri_inr_tpu_torch.configuration import config as config_lib  # noqa: E402
from mri_inr_tpu_torch.ops import siren_train_kernel as stk  # noqa: E402
from mri_inr_tpu_torch.utils.device import resolve_device  # noqa: E402

HASH_MASK = stk.dropout_mask


def rand_mask(seed: torch.Tensor, layer: int, keep: float, shape) -> torch.Tensor:
    """{0, 1/keep} masks drawn independently per (step seed, layer)."""
    gen = torch.Generator(seed.device).manual_seed(int(seed.reshape(()).item()) * 131 + layer)
    return (torch.rand(shape, generator=gen, device=seed.device) < keep).float() / keep


def run(variant: str, meta: dict, ae_file, args, device, out: pathlib.Path) -> list:
    mode, mask, *option = variant.split(":")
    stk.dropout_mask = HASH_MASK if mask == "hash" else rand_mask
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "nobf16red" not in option
    sets = ["model.residual=true", f"model.encoder_path={ae_file}",
            f"training.device_data={str(mode == 'graphed').lower()}", *args.overrides]
    sets += {"fp32": ["training.precision=fp32"], "nodrop": ["model.dropout=0.0"]}.get(
        option[0] if option else "", [])
    name = variant.replace(":", "_")
    cfg = config_lib.load_train_configuration(
        None, qr.train_sets(meta, out, name, args.epochs, *sets))
    train_ds = cli_train._dataset(cfg.data.train, cfg.data, cfg.model)
    val_ds = cli_train._dataset(cfg.data.val, cfg.data, cfg.model)
    (out / name).mkdir(parents=True)
    trainer = cli_train.make_trainer(cfg, train_ds, val_ds, out / name, device,
                                     log=lambda *_: None)
    t0 = time.perf_counter()
    trainer.initial_errors()
    trainer.train(args.epochs, 0)
    losses = [(p["train_loss"], p["val_loss"]) for p in trainer._progress]
    show = sorted({0, 1, 2, 3, 5, 10, 20, args.epochs - 1} & set(range(args.epochs)))
    print(f"{variant}: {time.perf_counter() - t0:.1f} s; train / val loss by epoch: "
          + ", ".join(f"{e}: {losses[e][0]:.5f} / {losses[e][1]:.5f}" for e in show),
          flush=True)
    return losses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--variants", default="graphed:hash,eager:hash,eager:rand,"
                    "graphed:hash:nobf16red,graphed:hash:fp32,graphed:hash:nodrop")
    ap.add_argument("--device", default=None)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--files", type=int, default=24)
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    args = ap.parse_args()
    device = resolve_device(args.device)
    card = qr.card_name() if device.type == "cuda" else "cpu"
    print(f"residual probe on {card}, torch {torch.__version__}", flush=True)
    proto = argparse.Namespace(slices=4, size=args.size, phase=False, snr_db=None,
                               texture=0.0, train_files=args.files, val_files=4,
                               eval_files=1)
    latent = config_lib.load_train_configuration(None, args.overrides).model.latent_dim
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if device.type == "cuda":
            qr.build_kernels()
        meta = qr.make_splits(tmp, proto, device)
        ae_file, _ = qr.pretrain(tmp / "encoder", "conv", meta, 30, 1024, latent,
                                 ["--device", device.type])
        for variant in args.variants.split(","):
            run(variant, meta, ae_file, args, device, tmp / "out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
