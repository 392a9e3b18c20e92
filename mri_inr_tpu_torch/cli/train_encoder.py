"""Autoencoder pretraining CLI (counterpart of the repository's
``train_encoder.py``): identity reconstruction of fully sampled tiles, which
gives the pretrained encoders the modulated SIREN takes.

- ``--model conv``: the 32x32 ``ConvAutoencoder``; its file is
  ``model.encoder_path`` for the SIREN's ``custom`` encoder;
- ``--model vgg``: the 32x32 ``VGGAutoencoder``; its file is
  ``model.encoder_path`` for ``encoder_type=vgg`` (the trunk is spliced, the
  latent head stays fresh);
- ``--model perceptual``: the 24x24 ``PerceptualAutoencoderV2`` on the centre
  24x24 of each tile; its file (the encoder's weights and running
  statistics) is ``training.perceptual_encoder_path`` for
  ``criterion=perceptual``.

    python -m mri_inr_tpu_torch.cli.train_encoder --dataset <metadata.csv> \\
        --output <dir> [--model conv|vgg|perceptual] [--epochs 50] \\
        [--batch-size 256] [--lr 1e-3] [--seed 0] [--device cpu|cuda]

Adam at ``--lr``, MSE, batches in ``MRIDataset.batches(batch, seed=epoch)``'s
composition, gathered on the device from tiles uploaded once. Every 10
epochs and at the last it saves torch state dicts
``{model}_autoencoder_epoch_{epoch:05d}.pt`` (what the train CLI reads) and
``..._full.pt`` (the whole autoencoder, for ``--evaluate``).

Evaluation: reconstruct ``--num-samples`` slices patchwise through a
``_full`` file (tiles of the model's size, stride half of it, the plain
average fold), score them with PSNR / SSIM / NRMSE and write
``ae_metrics.csv``, plus comparison PNGs where ``matplotlib`` is installed:

    python -m mri_inr_tpu_torch.cli.train_encoder --dataset <metadata.csv> \\
        --output <dir> [--model ...] --evaluate <..._full.pt> [--num-samples 3]

The default device is ``cuda`` and a missing card raises; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from mri_inr_tpu_torch.data.dataset import MRIDataset, MRISampler
from mri_inr_tpu_torch.eval.metrics import image_metrics
from mri_inr_tpu_torch.models import flax_init
from mri_inr_tpu_torch.models.encoder import ConvAutoencoder, VGGAutoencoder
from mri_inr_tpu_torch.models.perceptual import PerceptualAutoencoderV2
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.train.trainer import make_epoch_perm, make_optimizer
from mri_inr_tpu_torch.utils import visualization
from mri_inr_tpu_torch.utils.device import resolve_device

MODELS = ("conv", "vgg", "perceptual")


def build_autoencoder(name: str, latent_dim: int = 256, seed: int = 0,
                      device: torch.device | str = "cpu") -> tuple[torch.nn.Module, int]:
    """(autoencoder on ``device`` with the JAX package's initial weights at
    ``seed``, :func:`~mri_inr_tpu_torch.models.flax_init.seeded`; its patch
    size)."""
    if name == "conv":
        model, patch = ConvAutoencoder(latent_dim), 32
    elif name == "vgg":
        model, patch = VGGAutoencoder(), 32
    elif name == "perceptual":
        model, patch = PerceptualAutoencoderV2(latent_dim=latent_dim), 24
    else:
        raise ValueError(f"Unknown autoencoder {name!r}; expected one of {MODELS}")
    return flax_init.seeded(model, seed).to(device), patch


def checkpoint_paths(output: str | pathlib.Path, name: str,
                     epoch: int) -> tuple[pathlib.Path, pathlib.Path]:
    """(the file the train CLI reads, the ``_full`` file) of ``epoch``."""
    stem = f"{name}_autoencoder_epoch_{epoch:05d}"
    out = pathlib.Path(output)
    return out / f"{stem}.pt", out / f"{stem}_full.pt"


def _cpu_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One pretraining step (``train_encoder.py``'s ``train_step``): the MSE
    of the reconstruction of ``x``, its gradient, one optimizer step;
    returns (loss, reconstruction), both detached."""
    optimizer.zero_grad(set_to_none=True)
    out = model(x)
    loss = torch.mean(torch.square(out - x))
    loss.backward()
    optimizer.step()
    return loss.detach(), out.detach()


def train(args, model: torch.nn.Module, patch: int, device: torch.device,
          on_step=None) -> dict:
    """The pretraining loop; returns the per-epoch mean losses, the epochs'
    seconds, the steps an epoch and the files saved. ``on_step(epoch, x,
    loss, out)``, where given, sees every step's batch, loss and
    reconstruction."""
    dataset = MRIDataset(args.dataset)
    print(f"dataset: {len(dataset)} patches")
    tiles = torch.from_numpy(dataset.fully_tiles).to(device)
    if patch != tiles.shape[-1]:
        tiles = tiling.extract_center_batch(tiles, tiles.shape[-1], patch).contiguous()
    optimizer = make_optimizer("adam", args.lr, model.parameters())
    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"losses": [], "epoch_seconds": [], "files": [],
              "steps_per_epoch": -(-len(dataset) // args.batch_size)}
    model.train()
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = torch.from_numpy(make_epoch_perm(len(dataset), args.batch_size, epoch,
                                                shuffle=True).astype(np.int64)).to(device)
        losses = []
        for idx in perm:
            x = tiles.index_select(0, idx)
            loss, out = train_step(model, optimizer, x)
            if on_step is not None:
                on_step(epoch, x, loss, out)
            losses.append(loss)
        mean = float(torch.stack(losses).mean())
        secs = time.perf_counter() - t0
        result["losses"].append(mean)
        result["epoch_seconds"].append(secs)
        print(f"epoch {epoch}: loss={mean:.6f} ({secs:.2f}s)")
        if (epoch + 1) % 10 == 0 or epoch == args.epochs - 1:
            path, full = checkpoint_paths(out_dir, args.model, epoch)
            # conv / vgg: the whole autoencoder (the SIREN takes its encoder.
            # or trunk. subtree); perceptual: the encoder with its running
            # statistics, which the perceptual loss runs
            torch.save(_cpu_state(model.encoder if args.model == "perceptual" else model),
                       path)
            torch.save(_cpu_state(model), full)
            result["files"] += [path, full]
            print(f"saved {path}")
    return result


def evaluate(args, model: torch.nn.Module, patch: int, device: torch.device) -> list:
    """Patchwise reconstruction of sample slices through a ``_full`` file,
    the plain fold and the image metrics; returns ``(slice_id, metrics)``
    rows and writes ``ae_metrics.csv``."""
    state = torch.load(args.evaluate, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    model.eval()
    print(f"restored {args.evaluate}")
    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    plots = visualization.have_matplotlib()
    if not plots:
        print("matplotlib is not installed: comparison PNGs left out")
    sampler = MRISampler(args.dataset)
    inner = patch // 2
    rows = []
    for _ in range(args.num_samples):
        pair = sampler.next_sample()
        img = torch.from_numpy(pair.fully_sampled).to(device)
        patches = tiling.image_to_patches(img, patch, inner)
        grid = tiling.grid_shape(*img.shape, inner)
        with torch.no_grad():
            out = model(patches)
        recon = tiling.patches_to_image(out, grid, patch, inner)[: img.shape[0], : img.shape[1]]
        m = {k: float(v) for k, v in image_metrics(img, recon).items()}
        rows.append((pair.slice_id, m))
        print(f"{pair.slice_id}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if plots:
            visualization.save_image_comparison(
                [pair.fully_sampled, recon.cpu().numpy()], ["fully_sampled", "ae_reconstruction"],
                f"{pair.slice_id}_ae", out_dir)
    with open(out_dir / "ae_metrics.csv", "w") as f:
        f.write("FILENAME,PSNR,SSIM,NRMSE\n")
        for slice_id, m in rows:
            f.write(f"{slice_id},{m['psnr']},{m['ssim']},{m['nrmse']}\n")
    return rows


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", required=True, help="metadata.csv path")
    parser.add_argument("--output", required=True)
    parser.add_argument("--model", choices=MODELS, default="conv")
    parser.add_argument("--latent-dim", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--evaluate", default=None, metavar="CKPT",
                        help="evaluate a trained *_full.pt autoencoder instead of training")
    parser.add_argument("--num-samples", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model, patch = build_autoencoder(args.model, args.latent_dim, args.seed, device)
    if args.evaluate:
        return evaluate(args, model, patch, device)
    return train(args, model, patch, device)


if __name__ == "__main__":
    main()
