"""Evaluation CLI (counterpart of the repository's ``test_mod_siren.py``):
visual samples + the metric sweep over the selected slices.

Loads a checkpoint (a run directory of the train CLI, whose newest step is
restored, or one of its step directories), renders ``data.visual_samples``
slices (reconstruction / undersampled / fully sampled / difference PNGs, a
comparison panel and an error file each), scores ``data.metric_samples``
slices (default: every selected slice) and writes ``metrics_error.csv``,
``metrics_summary.txt``, boxplots and density plots.

    python -m mri_inr_tpu_torch.cli.test --config configs/test.yaml \\
        [--set data.metric_samples=50] [--device cpu|cuda] \\
        [--shard 0:4] [--merge-shards]

``--shard I:N`` scores every N-th slice from I into ``metrics_shardI_N/``;
``--merge-shards`` merges those directories into the single-run artifacts.
The default device is ``cuda`` and a missing card raises; ``--device cpu``
runs the kernels' plain PyTorch versions. ``data.quantized=true`` takes the
int8 kernel. Where ``matplotlib`` is not installed the two plots are left
out (and ``data.visual_samples`` must be 0). ``data.online=true`` reads a
directory of raw ``.h5`` k-space volumes as ``data.dataset`` and scores the
slices the ``OnlineKspaceDataset`` reconstructs on the device with the
offline pipeline's fixed masks (no ``.npy`` files; ``data.test_files`` is
refused); with ``data.device_sweep`` no image data crosses to the host.
A caller may pass its own ``sampler`` to :func:`main` (an
:class:`OnlineSampler` over k-space made in memory, where no ``.h5`` file
can be read): it replaces the one ``data.*`` would build, for the visual
and the metric pass, and ``--shard`` takes its ``shard(i, n)``.

Over N ranks (``torchrun --nproc-per-node N -m mri_inr_tpu_torch.cli.test
...`` or the ``MRI_INR_*`` triple, ``parallel/distributed.py``) rank ``i``
scores the sampler's shard ``i:N`` and the rows are gathered, so the
primary writes the artifacts a one-process run writes, visual samples
included; ``--devices`` is the number of ranks the sweep spans (None: all
started). With ``data.halo_fold=true`` the ranks split each slice's patch
rows instead of the files (``SliceReconstructor(halo=True)``).
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.data.dataset import MRISampler
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset, OnlineSampler
from mri_inr_tpu_torch.eval import evaluate as ev
from mri_inr_tpu_torch.models import modulated_siren as ms
from mri_inr_tpu_torch.ops.siren_kernel import make_apply_fn
from mri_inr_tpu_torch.parallel import distributed
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.utils import visualization


def resolve_devices(devices: int | None) -> int:
    """The ranks the sweep spans: ``--devices``, None for all ranks started;
    another count than those ranks raises."""
    world = distributed.process_count()
    if devices not in (None, world):
        raise ValueError(
            f"--devices {devices} but {world} rank(s) were started: start {devices} "
            f"(torchrun --nproc-per-node {devices} -m mri_inr_tpu_torch.cli.test ..., or "
            f"MRI_INR_NUM_PROCESSES={devices} with MRI_INR_COORDINATOR and "
            "MRI_INR_PROCESS_ID per rank)")
    return world


def _restore(model: torch.nn.Module, model_path: pathlib.Path) -> str:
    """Load the model weights of a run directory's newest step, or of a step
    directory; returns a description of what was restored."""
    if (model_path / "checkpoints").is_dir():
        step = ckpt_lib.find_latest_step(model_path)
        if step is None:
            raise FileNotFoundError(f"no step_* checkpoint under {model_path}/checkpoints")
        what = f"{model_path} step {step}"
        model_path = ckpt_lib.checkpoint_path(model_path, step)
    elif (model_path / ckpt_lib.STATE_FILE).is_file():
        what = str(model_path)
    else:
        raise NotImplementedError(
            f"data.model_path={str(model_path)!r} holds no {ckpt_lib.STATE_FILE}; if it is "
            "a run directory of the JAX package (Orbax), convert it first: python "
            f"scripts/torch_checkpoint_interop.py jax-to-torch run --run-dir {model_path} "
            "--out <port run dir>")
    # weights_only: a checkpoint holds tensors and plain containers only
    payload = torch.load(model_path / ckpt_lib.STATE_FILE, map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"])
    return what


def _write_artifacts(results: list[ev.SliceResult], metrics_dir: pathlib.Path) -> dict:
    summary = ev.write_metrics_artifacts(results, metrics_dir)
    if visualization.have_matplotlib():
        values = {"PSNR": np.array([r.psnr for r in results]),
                  "SSIM": np.array([r.ssim for r in results]),
                  "NRMSE": np.array([r.nrmse for r in results])}
        visualization.metrics_boxplot(values, metrics_dir)
        visualization.metrics_density_plot(values, metrics_dir)
    else:
        print("matplotlib is not installed: boxplots and density plots left out")
    return summary


def _render_visual_sample(reconstructor, pair, output_dir: pathlib.Path) -> None:
    recon, fully, under, m = reconstructor(pair.fully_sampled, pair.undersampled)
    recon, fully, under = (t.cpu().numpy() for t in (recon, fully, under))
    sid = pair.slice_id
    vis_dir = output_dir / sid
    diff = np.abs(fully - recon)
    visualization.save_image(recon, f"{sid}_reconstructed", vis_dir)
    visualization.save_image(under, f"{sid}_undersampled", vis_dir)
    visualization.save_image(fully, f"{sid}_fully_sampled", vis_dir)
    visualization.save_image(diff, f"{sid}_difference", vis_dir)
    visualization.save_image_comparison(
        [fully, under, recon, diff],
        ["fully sampled", "undersampled", "reconstruction", "difference"],
        f"{sid}_comparison", vis_dir)
    (vis_dir / f"{sid}_error.txt").write_text(
        "".join(f"{k}: {float(v):.6f}\n" for k, v in m.items()))
    print(f"visual sample {sid}: " + " ".join(f"{k}={float(v):.4f}" for k, v in m.items()))


def evaluate(cfg, device: torch.device, shard: str | None = None, sampler=None,
             timings: dict | None = None) -> tuple[list[ev.SliceResult], pathlib.Path]:
    """Everything up to the metric rows: restore, visual pass (the primary
    rank's), metric pass (every rank's shard, or with ``data.halo_fold``
    every rank's rows of every slice), the rows gathered. ``sampler``
    replaces the one ``cfg.data`` names; ``timings``, a dict, receives the
    metric pass's seconds and slices, and the device sweep's stage /
    dispatch / execute seconds. Returns (rows, output directory); every
    rank returns every row."""
    ecfg, mcfg = cfg.data, cfg.model
    model = ms.from_config(mcfg, generator=torch.Generator().manual_seed(0), device=device)
    t_restore = time.perf_counter()
    what = _restore(model, pathlib.Path(ecfg.model_path))
    print(f"restored {what} ({time.perf_counter() - t_restore:.1f}s)")

    output_dir = pathlib.Path(ecfg.output_dir) / ecfg.output_name
    primary, world = distributed.is_primary(), distributed.process_count()
    if primary:
        output_dir.mkdir(parents=True, exist_ok=True)

    if sampler is not None:
        visual_sampler = sampler
    elif ecfg.online:
        if ecfg.test_files:
            raise ValueError("data.test_files needs the offline sampler (data.online=false)")
        online_ds = OnlineKspaceDataset(
            ecfg.dataset, center_fraction=ecfg.center_fraction,
            acceleration=ecfg.acceleration, mri_type=ecfg.mri_type,
            max_slice_num=ecfg.max_slice_num, outer_patch_size=mcfg.outer_patch_size,
            inner_patch_size=mcfg.inner_patch_size, remask_each_epoch=False, device=device)
        # the device sweep reads the stacks on the device: no bulk copy to the host
        sampler = OnlineSampler(online_ds, num_samples=ecfg.num_samples,
                                host_prefetch=False if ecfg.device_sweep else None)
        visual_sampler = sampler
    else:
        sampler_kwargs = dict(center_fraction=ecfg.center_fraction,
                              acceleration=ecfg.acceleration, mri_type=ecfg.mri_type,
                              max_slice_num=ecfg.max_slice_num, num_samples=ecfg.num_samples)
        sampler = MRISampler(ecfg.dataset, **sampler_kwargs)
        # an explicit file list serves the visual pass only; the metric sweep
        # keeps the full selection
        visual_sampler = sampler
        if ecfg.test_files:
            visual_sampler = MRISampler(ecfg.dataset, test_files=list(ecfg.test_files),
                                        **sampler_kwargs)
    if shard and world > 1:
        raise ValueError("--shard I:N is one process's share; over ranks each rank takes "
                         "its shard itself")
    if shard:
        i, n = (int(x) for x in shard.split(":"))
        sampler = sampler.shard(i, n)
        print(f"shard {i}/{n}: {len(sampler)} slices")
    elif world > 1 and not ecfg.halo_fold:
        i = distributed.process_index()
        sampler = sampler.shard(i, world)
        print(f"rank shard {i}/{world}: {len(sampler)} slices")

    reconstructor = ev.SliceReconstructor(
        make_apply_fn(model, use_pallas=mcfg.use_pallas, sin_bf16=ecfg.sin_bf16,
                      sin5=ecfg.sin5, ksplit=ecfg.ksplit, quantized=ecfg.quantized,
                      device=device),
        outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size,
        siren_patch_size=mcfg.siren_patch_size, patch_bucket=ecfg.batch_patches,
        device=device, halo=ecfg.halo_fold,
        group=distributed.collective_group() if world > 1 else None)

    # in halo mode every rank takes part in each slice (and advances the
    # sampler alike); the primary alone writes the visual artifacts
    takes_part = primary or (ecfg.halo_fold and world > 1)
    for _ in range(ecfg.visual_samples if takes_part else 0):
        pair = visual_sampler.next_sample()
        if primary:
            _render_visual_sample(reconstructor, pair, output_dir)
        else:
            reconstructor(pair.fully_sampled, pair.undersampled)

    t_metric = time.perf_counter()
    sweep_timings = {}
    if ecfg.device_sweep:
        results, sweep_timings = ev.evaluate_files_device(reconstructor, sampler,
                                                          num_samples=ecfg.metric_samples)
    elif ecfg.eval_chunk > 1:
        results = ev.evaluate_files_chunked(reconstructor, sampler,
                                            num_samples=ecfg.metric_samples,
                                            chunk=ecfg.eval_chunk)
    else:
        results = ev.evaluate_files(reconstructor, sampler, num_samples=ecfg.metric_samples)
    metric_secs = time.perf_counter() - t_metric
    print(f"metric pass: {len(results)} slices in {metric_secs:.1f}s "
          f"({len(results) / max(metric_secs, 1e-9):.1f} slices/s)")
    if timings is not None:
        timings.update(sweep_timings, metric_seconds=metric_secs, slices=len(results))
    if not ecfg.halo_fold:  # in halo mode every rank scored every slice
        results = ev.gather_shard_results(results)
    return results, output_dir


def main(argv: list[str] | None = None, sampler=None,
         timings: dict | None = None) -> list[ev.SliceResult]:
    """Run the CLI on ``argv``; ``sampler`` and ``timings`` go to
    :func:`evaluate`."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", "-c", default=None)
    parser.add_argument("--set", dest="overrides", action="append", default=[])
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--devices", type=int, default=None,
                        help="ranks the sweep spans (default: all ranks started)")
    parser.add_argument("--shard", default=None, metavar="I:N",
                        help="evaluate file shard I of N into metrics_shardI_N/")
    parser.add_argument("--merge-shards", action="store_true",
                        help="merge metrics_shard*/ CSVs from prior --shard runs into the "
                        "single-run metrics_error.csv / summary / plots, then exit")
    args = parser.parse_args(argv)

    cfg = config_lib.load_test_configuration(args.config, args.overrides)

    if args.merge_shards:
        output_dir = pathlib.Path(cfg.data.output_dir) / cfg.data.output_name
        results = ev.merge_shard_csvs(output_dir)
        _write_artifacts(results, output_dir)
        print(f"merged {len(results)} rows into {output_dir}")
        return results

    device = distributed.initialize(args.device)
    resolve_devices(args.devices)
    results, output_dir = evaluate(cfg, device, args.shard, sampler, timings)
    if not distributed.is_primary():
        return results
    suffix = f"_shard{args.shard.replace(':', '_')}" if args.shard else ""
    metrics_dir = output_dir / f"metrics{suffix}" if suffix else output_dir
    summary = _write_artifacts(results, metrics_dir)
    for name, stats in summary.items():
        print(f"{name}: mean={stats['mean']:.4f} std={stats['std']:.4f} "
              f"min={stats['min']:.4f} max={stats['max']:.4f}")
    return results


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
