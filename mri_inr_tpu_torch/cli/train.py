"""Training CLI for the modulated SIREN (counterpart of the repository's
``train_mod_siren.py``): resume-vs-fresh run resolution, a timestamped run
directory with a config copy and the data manifest, dataset / model /
optimizer / trainer assembly, training with periodic checkpoints and
snapshots.

    python -m mri_inr_tpu_torch.cli.train --config configs/train.yaml \\
        [--set training.epochs=10] [--set training.lr=3e-4] [--device cpu|cuda]

The default device is ``cuda`` and a missing card raises; ``--device cpu``
runs the kernels' plain PyTorch versions. ``model.encoder_path`` takes a file
of ``python -m mri_inr_tpu_torch.cli.train_encoder`` (``--model conv`` for
the ``custom`` encoder, ``--model vgg`` for ``encoder_type=vgg``, whose trunk
only is spliced); ``criterion=perceptual`` takes ``--model perceptual``'s
file as ``training.perceptual_encoder_path``. ``data.low_memory`` trains on
``MRIDatasetLowMemory``, step by step. ``data.train.online`` takes a
directory of raw ``.h5`` k-space volumes (``configs/train_online.yaml``):
the ``OnlineKspaceDataset`` remasks each epoch on the device when
``remask_each_epoch``; the validation split is online too when asked, or
when it names no dataset and the train split is online, always with its
masks fixed.

Data-parallel training: start N ranks, each running this same command,

    torchrun --nproc-per-node N -m mri_inr_tpu_torch.cli.train --config ...

or with ``MRI_INR_COORDINATOR=host:port MRI_INR_NUM_PROCESSES=N
MRI_INR_PROCESS_ID=i`` set for rank ``i`` (``parallel/distributed.py``).
``training.data_axis_size`` is the number of ranks the step spans (None:
all of them; any other count than the ranks started raises), and
``training.batch_size`` the global batch, which the ranks split evenly.
The primary's clock names the one run directory; only the primary writes
``config.yaml``, the manifest, checkpoints, snapshots, logs and
TensorBoard scalars (``training.logging``).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import pathlib

import torch
import yaml

from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.data.dataset import MRIDataset, MRIDatasetLowMemory
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset
from mri_inr_tpu_torch.models import flax_init
from mri_inr_tpu_torch.models import modulated_siren as ms
from mri_inr_tpu_torch.parallel import distributed
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.train import losses
from mri_inr_tpu_torch.train.trainer import (Trainer, create_train_state,
                                             splice_pretrained_encoder)
from mri_inr_tpu_torch.utils.profiling import SPANS, device_trace, span_report


def resolve_data_axis(data_axis_size: int | None, batch_size: int) -> int:
    """The ranks a train step spans: ``training.data_axis_size``, None for
    all ranks started; another count than those ranks, or a global batch
    they cannot split evenly, raises."""
    world = distributed.process_count()
    if data_axis_size not in (None, world):
        raise ValueError(
            f"training.data_axis_size={data_axis_size} but {world} rank(s) were started: "
            f"start {data_axis_size} (torchrun --nproc-per-node {data_axis_size} -m "
            "mri_inr_tpu_torch.cli.train ..., or MRI_INR_NUM_PROCESSES="
            f"{data_axis_size} with MRI_INR_COORDINATOR and MRI_INR_PROCESS_ID per rank)")
    if batch_size % world:
        raise ValueError(f"training.batch_size={batch_size} is not divisible by the {world} "
                         "ranks")
    return world


def _load_state(path: str, key: str) -> dict:
    """A state dict saved by ``torch.save`` (``train_encoder``'s files)."""
    p = pathlib.Path(path)
    if p.is_dir():
        raise NotImplementedError(
            f"{key}={path!r} is a directory (an Orbax checkpoint of the JAX package); "
            "convert it first: python scripts/torch_checkpoint_interop.py jax-to-torch "
            f"encoder --path {path} --model conv|vgg|perceptual --out <file.pt>")
    # weights_only: an encoder checkpoint is a state dict of tensors
    state = torch.load(p, map_location="cpu", weights_only=True)
    return state.get("model", state)


def _dataset(split, dcfg, mcfg, device: torch.device | None = None, online: bool = False,
             remask: bool = False):
    """The split's dataset: online (on ``device``) or from ``metadata.csv``."""
    kw = dict(center_fraction=dcfg.center_fraction, acceleration=dcfg.acceleration,
              mri_type=split.mri_type, max_slice_num=split.max_slice_num,
              num_samples=split.num_samples, seed=split.seed,
              outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size)
    if online:
        return OnlineKspaceDataset(split.dataset, remask_each_epoch=remask, device=device, **kw)
    cls = MRIDatasetLowMemory if dcfg.low_memory else MRIDataset
    return cls(split.dataset, **kw)


def build_model(cfg, device: torch.device, log=print):
    """The model of ``cfg`` on ``device`` with the JAX package's initial
    weights at ``training.seed`` (``model.init(jax.random.key(seed), ...)``,
    :func:`~mri_inr_tpu_torch.models.flax_init.seeded`), and the pretrained
    encoder of ``model.encoder_path`` spliced in."""
    mcfg, tcfg = cfg.model, cfg.training
    model = flax_init.seeded(ms.from_config(mcfg, tcfg.precision, device=device), tcfg.seed)
    if mcfg.encoder_path:
        splice_pretrained_encoder(model, _load_state(mcfg.encoder_path, "model.encoder_path"))
        log(f"loaded pretrained {mcfg.encoder_type} encoder from {mcfg.encoder_path}")
    return model


def build_loss_fn(cfg, device: torch.device):
    """The criterion of ``cfg``; ``perceptual`` with the frozen encoder of
    ``training.perceptual_encoder_path`` on ``device``."""
    tcfg = cfg.training
    state = None
    if tcfg.criterion == "perceptual":
        if not tcfg.perceptual_encoder_path:
            raise ValueError("criterion=perceptual requires training.perceptual_encoder_path")
        state = _load_state(tcfg.perceptual_encoder_path, "training.perceptual_encoder_path")
    return losses.make_loss_fn(tcfg.criterion, state, cfg.model.siren_patch_size, device)


def make_trainer(cfg, train_ds, val_ds, run_dir, device: torch.device, log=print,
                 group=None) -> Trainer:
    """The seeded model, optimizer state, criterion and :class:`Trainer` of
    ``cfg`` over the two datasets (over the ranks of ``group``, if any)."""
    tcfg, mcfg = cfg.training, cfg.model
    model = build_model(cfg, device, log)
    state = create_train_state(model, tcfg.optimizer, tcfg.lr)
    loss_fn = build_loss_fn(cfg, device)
    use_pallas = tcfg.use_pallas if tcfg.use_pallas is not None else mcfg.use_pallas
    if use_pallas and not mcfg.residual:
        log("training with the fused forward and backward kernels "
            f"({'CUDA' if device.type == 'cuda' else 'plain PyTorch versions on the CPU'})")
    return Trainer(
        model, state, loss_fn, train_ds, val_ds, run_dir,
        batch_size=tcfg.batch_size, save_interval=tcfg.save_interval,
        outer_patch_size=mcfg.outer_patch_size, siren_patch_size=mcfg.siren_patch_size,
        base_seed=tcfg.seed + 1, tensorboard=tcfg.logging, use_pallas=use_pallas,
        device_data=tcfg.device_data, sin5=tcfg.sin5, freeze_encoder=tcfg.freeze_encoder,
        device=device, log=log, group=group)


def main(argv: list[str] | None = None, datasets=None) -> Trainer:
    """Run the CLI on ``argv``; ``datasets``, a (train, validation) pair of
    datasets built by the caller (``cli/results_run``'s online row: k-space
    volumes made in memory), replaces the ones the config names."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", "-c", default=None)
    parser.add_argument("--set", dest="overrides", action="append", default=[])
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = distributed.initialize(args.device)
    primary = distributed.is_primary()

    cfg = config_lib.load_train_configuration(args.config, args.overrides)
    tcfg, mcfg, dcfg = cfg.training, cfg.model, cfg.data
    world = resolve_data_axis(tcfg.data_axis_size, tcfg.batch_size)
    if tcfg.debug_nans and tcfg.device_data and device.type == "cuda":
        raise ValueError(
            "training.debug_nans (anomaly detection) cannot run inside the CUDA graph of a "
            "training.device_data epoch on the card; set one of the two to false")

    # resume-vs-fresh: an explicit training.model_path pins the run dir,
    # otherwise the newest {name}_{timestamp} dir with its highest step
    # the primary decides, and its clock names a new run dir, for every rank
    resume = None
    if tcfg.continue_training and primary:
        if tcfg.model_path:
            run = pathlib.Path(tcfg.model_path)
            step = ckpt_lib.find_latest_step(run)
            resume = (run, step) if step is not None else None
        else:
            resume = ckpt_lib.resolve_resume(tcfg.output_dir, tcfg.output_name)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    resume, stamp = distributed.broadcast_from_primary((resume, stamp))
    if resume:
        print(f"resuming from {resume[0]} at step {resume[1]}")
        run_dir = resume[0]
    elif primary:
        run_dir = ckpt_lib.new_run_dir(tcfg.output_dir, tcfg.output_name, stamp)
    else:
        run_dir = pathlib.Path(tcfg.output_dir) / f"{tcfg.output_name}_{stamp}"
    if primary:
        with open(run_dir / "config.yaml", "w") as f:
            yaml.safe_dump(config_lib.to_dict(cfg), f, sort_keys=False)
    print(f"run dir: {run_dir}")

    val_split = dcfg.val
    # an online train split makes the val split online when it names no
    # dataset of its own (the train split's is an .h5 directory); its masks
    # stay fixed, so the validation curve compares across epochs
    val_online = dcfg.val.online or (not val_split.dataset and dcfg.train.online)
    if not val_split.dataset:
        val_split = dataclasses.replace(val_split, dataset=dcfg.train.dataset)
    if datasets is not None:
        train_ds, val_ds = datasets
    else:
        train_ds = _dataset(dcfg.train, dcfg, mcfg, device, online=dcfg.train.online,
                            remask=dcfg.train.remask_each_epoch)
        val_ds = _dataset(val_split, dcfg, mcfg, device, online=val_online)
    print(f"train patches: {len(train_ds)}, val patches: {len(val_ds)}")
    if primary:
        train_ds.write_manifest(run_dir / "processed_files.txt")

    trainer = make_trainer(cfg, train_ds, val_ds, run_dir, device,
                           group=distributed.collective_group() if world > 1 else None)
    initial_epoch = 0
    if resume:
        distributed.sync_hosts("resume")
        ckpt_lib.restore_state(resume[0], resume[1], trainer.state)
        # an epoch runs ceil(n / batch) steps (epoch_index_batches)
        steps_per_epoch = max(1, -(-len(train_ds) // tcfg.batch_size))
        initial_epoch = trainer.state.step // steps_per_epoch
        print(f"restored step {resume[1]}; continuing at epoch {initial_epoch}")

    if tcfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    trainer.initial_errors()
    profile_dir = tcfg.profile_dir
    if profile_dir and world > 1:  # a trace a rank
        profile_dir = pathlib.Path(profile_dir) / f"rank{distributed.process_index()}"
    SPANS.reset()
    with device_trace(profile_dir):
        trainer.train(tcfg.epochs, initial_epoch)
    print("host time by span over the training epochs:\n" + span_report())
    print(f"done; final step {trainer.state.step}; artifacts in {run_dir}")
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
