"""End-to-end quality run of the port (counterpart of the repository's
``scripts/quality_run.py``): phantom volumes -> preprocessing -> conv
autoencoder pretraining -> modulated-SIREN training -> the metric sweep,
each stage through the port's own entry point.

    python -m mri_inr_tpu_torch.cli.quality_run [--root runs/quality_torch] \\
        [--epochs 600] [--ae-epochs 30] [--device cpu|cuda]

The defaults are the protocol of the JAX package's baseline row: 24 / 4 /
12 volumes (phantom seeds 0 / 1000 / 2000) x 4 slices at 256x256 for the
train / validation / eval splits; a conv autoencoder for 30 epochs at
batch 1024; 600 epochs at batch 400 (``max_slice_num=100``,
``device_data=true``, ``save_interval=100``) with its encoder spliced in;
then the test CLI over the eval split with ``batch_patches=512``.

The splits are built without ``h5py``: ``synthetic.synthetic_kspace`` ->
``preprocessing.process_kspace_volume`` -> ``write_metadata`` (the k-space
``write_synthetic_h5`` would store). A split whose ``metadata.csv`` exists
and an autoencoder file that exists are reused. Visual samples are left out
where ``matplotlib`` is not installed. ``run_info.json`` under ``--root``
records the protocol, each stage's wall seconds, the card and the metrics.
The autoencoder's own reconstruction of three eval slices goes to
``encoder/ae_metrics.csv``. Keep ``run_info.json``, the progress logs and the
metric files; the
checkpoints and slices stay out of git (``.gitignore``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.cli import train_encoder
from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.utils import visualization
from mri_inr_tpu_torch.utils.device import resolve_device

#: the kernels the run launches: preprocessing, training, the sweep
KERNELS = ("dft2c", "siren_train_fwd", "siren_train_bwd", "siren_forward")


def card_name() -> str:
    """``name, power limit`` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    """Build the run's CUDA kernels side by side (one nvcc each) before the
    first launch would build them one after another."""
    from mri_inr_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))


def make_split(directory: pathlib.Path, num: int, seed: int, args,
               device: torch.device) -> pathlib.Path:
    """Phantom volumes ``seed .. seed + num - 1`` preprocessed into
    ``directory/processed``; returns its ``metadata.csv``."""
    out = directory / "processed"
    meta = out / "metadata.csv"
    if meta.exists():
        return meta
    rows = []
    for i in range(num):
        k = synthetic.synthetic_kspace(seed + i, args.slices, args.size, args.size,
                                       phase=args.phase, snr_db=args.snr_db,
                                       texture=args.texture)
        rows += preprocessing.process_kspace_volume(k, synthetic.synthetic_stem(seed + i), out,
                                                    device=device)
    return preprocessing.write_metadata(rows, out)


def _sets(*items: str) -> list[str]:
    return [x for item in items for x in ("--set", item)]


def _summary(rows) -> dict:
    out = {}
    for key in ("psnr", "ssim", "nrmse"):
        v = np.array([getattr(r, key) for r in rows], np.float64)
        out[key.upper()] = {"mean": float(v.mean()), "std": float(v.std()),
                            "min": float(v.min()), "max": float(v.max())}
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="runs/quality_torch")
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--ae-epochs", type=int, default=30)
    ap.add_argument("--train-files", type=int, default=24)
    ap.add_argument("--val-files", type=int, default=4)
    ap.add_argument("--eval-files", type=int, default=12)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--phase", action="store_true")
    ap.add_argument("--snr-db", type=float, default=None)
    ap.add_argument("--texture", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="extra train CLI override (repeatable); model.* ones also go to "
                         "the test CLI and model.latent_dim to the autoencoder")
    args = ap.parse_args(argv)
    latent = config_lib.load_train_configuration(None, args.overrides).model.latent_dim
    model_sets = [o for o in args.overrides if o.startswith("model.")]
    device = resolve_device(args.device)
    dev = ["--device", device.type]
    root = pathlib.Path(args.root).resolve()
    root.mkdir(parents=True, exist_ok=True)
    card = card_name() if device.type == "cuda" else "cpu"
    print(f"quality run on {card}", flush=True)
    stages = {}
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    if device.type == "cuda":
        build_kernels()
        stages["kernel_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    splits = {"train": (args.train_files, 0), "val": (args.val_files, 1000),
              "eval": (args.eval_files, 2000)}
    meta = {name: make_split(root / "data" / name, num, seed, args, device)
            for name, (num, seed) in splits.items()}
    stages["data"] = time.perf_counter() - t0
    print(f"data ready ({stages['data']:.1f}s)", flush=True)

    t0 = time.perf_counter()
    ae_dir = root / "encoder"
    ae_file, ae_full = train_encoder.checkpoint_paths(ae_dir, "conv", args.ae_epochs - 1)
    if not ae_file.exists():
        train_encoder.main(["--dataset", str(meta["train"]), "--output", str(ae_dir),
                            "--model", "conv", "--epochs", str(args.ae_epochs),
                            "--batch-size", "1024",
                            "--latent-dim", str(latent), *dev])
        # the autoencoder's own reconstruction of three eval slices (ae_metrics.csv)
        train_encoder.main(["--dataset", str(meta["eval"]), "--output", str(ae_dir),
                            "--model", "conv", "--latent-dim", str(latent),
                            "--evaluate", str(ae_full), *dev])
    stages["autoencoder"] = time.perf_counter() - t0
    print(f"autoencoder ready ({stages['autoencoder']:.1f}s)", flush=True)

    t0 = time.perf_counter()
    trainer = cli_train.main(dev + _sets(
        f"data.train.dataset={meta['train']}", f"data.val.dataset={meta['val']}",
        "data.train.max_slice_num=100", "data.val.max_slice_num=100",
        f"model.encoder_path={ae_file}", f"training.epochs={args.epochs}",
        "training.batch_size=400", "training.save_interval=100", "training.device_data=true",
        f"training.output_dir={root / 'train'}", "training.output_name=quality",
        *args.overrides))
    run_dir = trainer.run_dir
    stages["train"] = time.perf_counter() - t0
    print(f"train done: {run_dir} ({stages['train']:.1f}s)", flush=True)

    t0 = time.perf_counter()
    visual = 3 if visualization.have_matplotlib() else 0
    if not visual:
        print("matplotlib is not installed: no visual samples")
    rows = cli_test.main(dev + _sets(
        f"data.dataset={meta['eval']}", f"data.model_path={run_dir}",
        f"data.visual_samples={visual}", "data.batch_patches=512",
        f"data.output_dir={root / 'eval'}", "data.output_name=quality",
        *model_sets))
    stages["eval"] = time.perf_counter() - t0
    print((root / "eval" / "quality" / "metrics_summary.txt").read_text(), flush=True)

    info = {
        "epochs": args.epochs,
        "ae_epochs": args.ae_epochs,
        "train_files": args.train_files,
        "val_files": args.val_files,
        "eval_files": args.eval_files,
        "slices_per_file": args.slices,
        "image_size": args.size,
        "run_dir": str(run_dir.relative_to(pathlib.Path.cwd())
                       if run_dir.is_relative_to(pathlib.Path.cwd()) else run_dir),
        "device": card,
        "torch": torch.__version__,
        "stage_seconds": stages,
        "wall_seconds": time.perf_counter() - t_start,
        "slices": len(rows),
        "metrics": _summary(rows),
    }
    (root / "run_info.json").write_text(json.dumps(info, indent=2) + "\n")
    print(f"total {info['wall_seconds']:.1f}s", flush=True)
    return info


if __name__ == "__main__":
    main()
