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
``write_synthetic_h5`` would store). A split whose ``metadata.csv`` and
slices exist and an autoencoder file that exists are reused; so the first
build under a root writes ``protocol.json`` there (corpus flags, size,
slices, file counts, autoencoder epochs, the draws, the module dropout),
and a later call whose protocol differs raises before it touches any file
(:func:`guard_protocol`):
rows of the port's earlier numpy and torch draws (``"draws": "torch"``, every
root built before the JAX package's draws were ported) never share a root
with rows of the JAX package's draws (``"jax"``), and rows whose module path
dropped with the fused path's counter hash (``"module_dropout": "hash"``)
never share one with rows of Flax's masks (``"flax"``). Visual
samples are left out where ``matplotlib`` is not installed.
``run_info.json`` under ``--root`` records the protocol, each stage's wall
seconds, the card and the metrics.
The autoencoder's own reconstruction of three eval slices goes to
``encoder/ae_metrics.csv``. Keep ``run_info.json``, the progress logs and the
metric files; the
checkpoints and slices stay out of git (``.gitignore``). The stage functions
(splits, autoencoder, train, eval, summary) also serve ``cli/results_run``.
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
from mri_inr_tpu_torch.data.dataset import read_metadata
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


#: phantom seeds of the train / validation / eval splits (``RESULTS.md:16-21``)
SPLIT_SEEDS = {"train": 0, "val": 1000, "eval": 2000}


def add_protocol_args(ap: argparse.ArgumentParser, root: str, corpus: bool = True) -> None:
    """The protocol's options, shared with ``cli/results_run``; without
    ``corpus`` the phantoms' flags (``--phase``, ``--snr-db``,
    ``--texture``) are left to the caller."""
    ap.add_argument("--root", default=root)
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--ae-epochs", type=int, default=30)
    ap.add_argument("--train-files", type=int, default=24)
    ap.add_argument("--val-files", type=int, default=4)
    ap.add_argument("--eval-files", type=int, default=12)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    if corpus:
        ap.add_argument("--phase", action="store_true")
        ap.add_argument("--snr-db", type=float, default=None)
        ap.add_argument("--texture", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="extra train CLI override (repeatable); model.* ones also go to "
                         "the test CLI and model.latent_dim to the autoencoder")


#: ``run_info.json`` keys of ``quality_run`` -> protocol keys
_RUN_INFO_KEYS = {"image_size": "size", "slices_per_file": "slices", "train_files": "train_files",
                  "val_files": "val_files", "eval_files": "eval_files", "ae_epochs": "ae_epochs"}


#: how the port draws its seeded values: ``"jax"``, the JAX package's own
#: draws (``jax.random`` masks, Flax's initial weights, the fused dropout
#: seeds); a root built before it drew them from numpy and torch generators
#: and reads as ``"torch"``
DRAWS = "jax"

#: how the module path (``training.use_pallas=false``, residual models)
#: drops: ``"flax"``, Flax's ``bernoulli`` masks (``ops/dropout.py``); a
#: root built before it dropped with the fused path's counter hash and
#: reads as ``"hash"``
MODULE_DROPOUT = "flax"

#: protocol keys a render-only call is not held to: how the rows were drawn
_DRAW_KEYS = ("draws", "module_dropout")


def protocol_of(args) -> dict:
    """The corpus, scale and draws a call builds its splits, autoencoders
    and rows from."""
    return {"phase": bool(args.phase), "snr_db": args.snr_db, "texture": float(args.texture),
            "size": args.size, "slices": args.slices, "train_files": args.train_files,
            "val_files": args.val_files, "eval_files": args.eval_files,
            "ae_epochs": args.ae_epochs, "draws": DRAWS, "module_dropout": MODULE_DROPOUT}


def default_protocol() -> dict:
    """The protocol at the defaults of :func:`add_protocol_args`: the smooth
    corpus of ``RESULTS.md:16-21``."""
    ap = argparse.ArgumentParser()
    add_protocol_args(ap, "")
    return protocol_of(ap.parse_args([]))


def _legacy_protocol(root: pathlib.Path) -> dict | None:
    """The protocol of a root that holds splits or rows but no
    ``protocol.json``: :func:`default_protocol` with the counts its
    ``run_info.json`` records, the ``"torch"`` draws and the ``"hash"``
    module dropout; None for a root that holds neither."""
    info = root / "run_info.json"
    if not (info.is_file() or (root / "rows.json").is_file()
            or any((root / "data").glob("*/*/metadata.csv"))):
        return None
    out = {**default_protocol(), "draws": "torch", "module_dropout": "hash"}
    if info.is_file():
        recorded = json.loads(info.read_text())
        out.update({v: recorded[k] for k, v in _RUN_INFO_KEYS.items() if k in recorded})
    return out


def root_protocol(root: pathlib.Path) -> dict | None:
    """The protocol ``root`` was built with: its ``protocol.json`` (one
    written before the draws were recorded drew ``"torch"``, one written
    before the module dropout was recorded dropped by the ``"hash"``), else
    :func:`_legacy_protocol`."""
    path = root / "protocol.json"
    if not path.is_file():
        return _legacy_protocol(root)
    return {"draws": "torch", "module_dropout": "hash", **json.loads(path.read_text())}


def guard_protocol(root: pathlib.Path, args, building: bool = True) -> dict:
    """Hold the call's protocol against the one ``root`` was built with
    (:func:`root_protocol`) and write it there when the root has none. A
    different protocol raises ``ValueError`` naming both, before any split,
    autoencoder or row under ``root`` is touched. A call that builds nothing
    (``building=False``: every row it names is there, it only renders) is
    not held to the root's draws and module dropout, and leaves an older
    root's files as they are."""
    want = protocol_of(args)
    path = root / "protocol.json"
    have = root_protocol(root)
    def held(p: dict) -> dict:
        return {k: v for k, v in p.items() if building or k not in _DRAW_KEYS}

    if have is not None and held(have) != held(want):
        raise ValueError(f"{root} holds the protocol {json.dumps(have, sort_keys=True)} but "
                         f"this call asks for {json.dumps(want, sort_keys=True)}: pass the "
                         "root's own options or another --root")
    if not path.is_file() and (building or have is None):
        root.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(want, indent=2) + "\n")
    return want


def phantom_kspace(seed: int, args) -> np.ndarray:
    """The complex (slices, size, size) k-space of phantom volume ``seed``."""
    return synthetic.synthetic_kspace(seed, args.slices, args.size, args.size,
                                      phase=args.phase, snr_db=args.snr_db,
                                      texture=args.texture)


def split_ready(meta: pathlib.Path) -> bool:
    """Whether the split's ``metadata.csv`` and every slice it lists exist."""
    return meta.exists() and all(pathlib.Path(row[col]).is_file()
                                 for row in read_metadata(meta)
                                 for col in row if col.startswith("path_"))


def make_split(directory: pathlib.Path, num: int, seed: int, args, device: torch.device,
               processed: str = "processed",
               masks=preprocessing.DEFAULT_MASKS) -> pathlib.Path:
    """Phantom volumes ``seed .. seed + num - 1`` preprocessed with the
    ``(cf, acc)`` pairs ``masks`` into ``directory / processed``; returns its
    ``metadata.csv``. A split whose ``metadata.csv`` and every slice it lists
    exist is reused."""
    out = directory / processed
    meta = out / "metadata.csv"
    if split_ready(meta):
        return meta
    rows = []
    for i in range(num):
        rows += preprocessing.process_kspace_volume(
            phantom_kspace(seed + i, args), synthetic.synthetic_stem(seed + i), out,
            undersample_params=masks, device=device)
    return preprocessing.write_metadata(rows, out)


def make_splits(root: pathlib.Path, args, device: torch.device, processed: str = "processed",
                masks=preprocessing.DEFAULT_MASKS) -> dict[str, pathlib.Path]:
    """The train / validation / eval splits' ``metadata.csv`` under
    ``root/data``."""
    nums = {"train": args.train_files, "val": args.val_files, "eval": args.eval_files}
    return {name: make_split(root / "data" / name, nums[name], seed, args, device, processed,
                             masks)
            for name, seed in SPLIT_SEEDS.items()}


def pretrain(ae_dir: pathlib.Path, model: str, meta: dict, epochs: int, batch: int,
             latent: int, dev: list[str], seed: int = 0) -> tuple[pathlib.Path, pathlib.Path]:
    """The ``model`` autoencoder's files under ``ae_dir`` (trained from
    ``train_encoder --seed seed`` on the train split unless they exist, then
    scored on three eval slices into ``ae_metrics.csv``)."""
    ae_file, ae_full = train_encoder.checkpoint_paths(ae_dir, model, epochs - 1)
    if ae_file.exists():
        return ae_file, ae_full
    common = ["--output", str(ae_dir), "--model", model, "--latent-dim", str(latent),
              "--seed", str(seed), *dev]
    train_encoder.main(["--dataset", str(meta["train"]), "--epochs", str(epochs),
                        "--batch-size", str(batch), *common])
    train_encoder.main(["--dataset", str(meta["eval"]), "--evaluate", str(ae_full), *common])
    return ae_file, ae_full


def train_sets(meta: dict, out_dir: pathlib.Path, name: str, epochs: int,
               *overrides: str) -> list[str]:
    """The train CLI's overrides at the protocol's budget (batch 400,
    ``max_slice_num`` 100, ``device_data``), ``overrides`` last."""
    return [f"data.train.dataset={meta['train']}", f"data.val.dataset={meta['val']}",
            "data.train.max_slice_num=100", "data.val.max_slice_num=100",
            f"training.epochs={epochs}", "training.batch_size=400",
            "training.save_interval=100", "training.device_data=true",
            f"training.output_dir={out_dir}", f"training.output_name={name}", *overrides]


def train_stage(meta: dict, out_dir: pathlib.Path, name: str, epochs: int, dev: list[str],
                *overrides: str, datasets=None):
    """The train CLI on :func:`train_sets`; ``datasets`` replaces the CLI's
    own (train, validation) pair."""
    return cli_train.main(dev + _sets(*train_sets(meta, out_dir, name, epochs, *overrides)),
                          datasets=datasets)


def eval_stage(meta: dict, run_dir: pathlib.Path, out_dir: pathlib.Path, name: str,
               dev: list[str], *overrides: str) -> list:
    """The test CLI's sweep over the eval split at ``batch_patches=512``
    (three visual samples where ``matplotlib`` is installed)."""
    visual = 3 if visualization.have_matplotlib() else 0
    if not visual:
        print("matplotlib is not installed: no visual samples")
    return cli_test.main(dev + _sets(
        f"data.dataset={meta['eval']}", f"data.model_path={run_dir}",
        f"data.visual_samples={visual}", "data.batch_patches=512",
        f"data.output_dir={out_dir}", f"data.output_name={name}", *overrides))


def _sets(*items: str) -> list[str]:
    return [x for item in items for x in ("--set", item)]


def summary(rows) -> dict:
    """Mean, std, min and max of PSNR / SSIM / NRMSE over the rows."""
    out = {}
    for key in ("psnr", "ssim", "nrmse"):
        v = np.array([getattr(r, key) for r in rows], np.float64)
        out[key.upper()] = {"mean": float(v.mean()), "std": float(v.std()),
                            "min": float(v.min()), "max": float(v.max())}
    return out


def cwd_relative(path: pathlib.Path) -> str:
    """``path`` relative to the working directory where it lies below it."""
    cwd = pathlib.Path.cwd()
    return str(path.relative_to(cwd) if path.is_relative_to(cwd) else path)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_protocol_args(ap, "runs/quality_torch")
    args = ap.parse_args(argv)
    latent = config_lib.load_train_configuration(None, args.overrides).model.latent_dim
    model_sets = [o for o in args.overrides if o.startswith("model.")]
    device = resolve_device(args.device)
    dev = ["--device", device.type]
    root = pathlib.Path(args.root).resolve()
    protocol = guard_protocol(root, args)
    card = card_name() if device.type == "cuda" else "cpu"
    print(f"quality run on {card}", flush=True)
    stages = {}
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    if device.type == "cuda":
        build_kernels()
        stages["kernel_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    meta = make_splits(root, args, device)
    stages["data"] = time.perf_counter() - t0
    print(f"data ready ({stages['data']:.1f}s)", flush=True)

    t0 = time.perf_counter()
    ae_file, _ = pretrain(root / "encoder", "conv", meta, args.ae_epochs, 1024, latent, dev)
    stages["autoencoder"] = time.perf_counter() - t0
    print(f"autoencoder ready ({stages['autoencoder']:.1f}s)", flush=True)

    t0 = time.perf_counter()
    trainer = train_stage(meta, root / "train", "quality", args.epochs, dev,
                          f"model.encoder_path={ae_file}", *args.overrides)
    run_dir = trainer.run_dir
    stages["train"] = time.perf_counter() - t0
    print(f"train done: {run_dir} ({stages['train']:.1f}s)", flush=True)

    t0 = time.perf_counter()
    rows = eval_stage(meta, run_dir, root / "eval", "quality", dev, *model_sets)
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
        "corpus": protocol,
        "run_dir": cwd_relative(run_dir),
        "device": card,
        "torch": torch.__version__,
        "stage_seconds": stages,
        "wall_seconds": time.perf_counter() - t_start,
        "slices": len(rows),
        "metrics": summary(rows),
    }
    (root / "run_info.json").write_text(json.dumps(info, indent=2) + "\n")
    print(f"total {info['wall_seconds']:.1f}s", flush=True)
    return info


if __name__ == "__main__":
    main()
