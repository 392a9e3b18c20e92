"""The 940-file validation sweep at the reference's scale, with its headline
model (counterpart of the repository's ``scripts/sweep940.py`` and
``scripts/r5_train_and_sweep.sh``), through the port's own entry points, in
this process.

    python -m mri_inr_tpu_torch.cli.sweep940 [--root runs/results_torch/sweep940] \\
        [--device cpu|cuda] [--files 235] [--slices 4] [--size 320] \\
        [--train-files 60] [--val-files 2] [--epochs 300] [--resume-epochs 700] \\
        [--encoder FILE|none] [--protocol-root runs/results_torch] [--ae-epochs 30] \\
        [--model-dir RUN_DIR] [--set model.key=value ...]

1. **The evaluation set**: phantom volumes ``synthetic_kspace(5000 + i,
   slices, size, size)`` for i < ``--files`` (what the JAX package's
   ``write_synthetic_h5(seed=5000)`` writes for file i), preprocessed on the
   device (``process_kspace_volume``: the DFT kernel on the card) into
   ``data/processed/metadata.csv``. No ``h5py`` is needed.
2. **The headline model** (``runs/results/train320``'s config): phantom
   volumes 7000 .. 7000 + ``--train-files`` - 1 at ``--size``, online with
   new masks each epoch (``OnlineKspaceDataset.from_volumes``, acceleration
   6, centre fraction 0.05), validated on ``--val-files`` volumes from 7000
   + ``--train-files`` with fixed masks (the JAX run's validation stems are
   not recorded: this is a choice of the port); H=256, latent 256, L=5,
   batch 400, Adam 1e-4, bf16, degree-5 train sines, ``device_data``; the
   quality protocol's conv autoencoder spliced in (``--encoder``; by default
   ``cli/results_run``'s under ``--protocol-root``, the file of its epoch
   ``--ae-epochs`` - 1, pretrained by that protocol when it is missing).
   ``--epochs`` through the train CLI, then resumed to ``--resume-epochs``
   through ``training.continue_training``; the resumed run's mask epochs
   must continue where the first run stopped.
   ``--model-dir`` scores an existing run directory instead.
3. **The legs**, each a call of the test CLI's ``main`` at
   ``batch_patches=512`` through the device sweep: (a) offline, unsharded,
   from ``metadata.csv``; (b) online, the volumes' k-space held in memory
   and passed as an ``OnlineSampler`` with the offline masks (no image read
   from disk); (c) ``--shard 0:2``, ``--shard 1:2``, ``--merge-shards``.
4. **The checks**: (c)'s merged summary equals (a)'s on every statistic
   (1e-9) and the sorted rows equal (``scripts/sweep940.py:180-205``),
   exactly on the CPU; on the card the shard rows are held within 1e-5 of
   (a)'s where they are not equal, and ``piece_invariance`` records which
   stage sees a slice's piece. (b) within 1e-4 of (a) on every statistic
   (``RESULTS.md:171-173``). A failed check raises after the record is
   written. (a) against the JAX sweep's summary
   (``runs/results/sweep940/sweep940.json``) at 0.3 dB / 0.01 / 0.01 is
   recorded, not held: one seed on each side.

``sweep940.json`` under ``--root`` holds the three summaries, each leg's
wall, metric-pass, stage, dispatch and execute seconds, its device-sweep
rate and peak device memory, the headline run's losses and seconds, the
kernels' launches per stage, the checks, the card and the torch version.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mri_inr_tpu_torch.cli import quality_run as qr
from mri_inr_tpu_torch.cli import results_run as rr
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.cli import train_encoder
from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.data.dataset import MRISampler, read_metadata
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset, OnlineSampler
from mri_inr_tpu_torch.eval import evaluate as ev
from mri_inr_tpu_torch.models import modulated_siren as ms
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.ops.siren_kernel import make_apply_fn
from mri_inr_tpu_torch.utils.device import resolve_device

REPO = rr.REPO
#: the JAX package's committed sweep (``scripts/sweep940.py``)
JAX_SWEEP = REPO / "runs" / "results" / "sweep940" / "sweep940.json"
#: first phantom seed of the evaluation set (``write_synthetic_h5(seed=5000)``)
EVAL_SEED = 5000
#: first phantom seed of the headline model's volumes (``train320``'s manifest)
TRAIN_SEED = 7000
#: the shard merge's bar on the summary (``scripts/sweep940.py:184``), the
#: online leg's on every statistic (``RESULTS.md:171-173``), and the card's
#: bar on shard rows that differ from the unsharded ones (PR 10's, 1e-5)
SHARD_SUMMARY_BAR, ONLINE_BAR, CARD_SHARD_ROW_BAR = 1e-9, 1e-4, 1e-5
STATS = ("mean", "std", "min", "max")


def phantom(seed: int, args) -> np.ndarray:
    return synthetic.synthetic_kspace(seed, args.slices, args.size, args.size)


def phantoms(seeds, args) -> tuple[list[str], list[np.ndarray]]:
    """(stems, complex k-space volumes) of the phantom ``seeds``, made by
    8 threads."""
    seeds = list(seeds)
    with ThreadPoolExecutor(8) as pool:
        volumes = list(pool.map(lambda s: phantom(s, args), seeds))
    return [synthetic.synthetic_stem(s) for s in seeds], volumes


def eval_split(root: pathlib.Path, stems, volumes, device) -> pathlib.Path:
    """The evaluation volumes preprocessed into ``<--root>/data/processed``
    (reused when its ``metadata.csv`` lists these stems and their slices
    exist)."""
    out = root / "data" / "processed"
    meta = out / "metadata.csv"
    if meta.exists():
        rows = read_metadata(meta)
        if ({r["stem"] for r in rows} == set(stems)
                and len(rows) == sum(len(v) for v in volumes)
                and all(pathlib.Path(r[c]).is_file() for r in rows for c in r
                        if c.startswith("path_"))):
            return meta
    rows = []
    for stem, vol in zip(stems, volumes):
        rows += preprocessing.process_kspace_volume(vol, stem, out, device=device)
    return preprocessing.write_metadata(rows, out)


def headline_sets(args, root: pathlib.Path, encoder: pathlib.Path | None,
                  epochs: int) -> list[str]:
    """The train CLI's overrides of the headline model (``train320``'s
    config) at ``epochs``; ``--set`` overrides last."""
    return [f"data.train.dataset={root / 'train'}", f"data.val.dataset={root / 'val'}",
            "data.train.online=true", "data.train.remask_each_epoch=true",
            "data.val.online=true", "data.train.max_slice_num=100",
            "data.val.max_slice_num=100", f"data.val.num_samples={args.val_files * args.slices}",
            "data.acceleration=6", "data.center_fraction=0.05",
            "training.batch_size=400", "training.lr=1e-4", "training.optimizer=adam",
            "training.precision=bf16", "training.sin5=true", "training.device_data=true",
            "training.save_interval=100", f"training.epochs={epochs}",
            f"training.output_dir={root}", "training.output_name=train320",
            *([f"model.encoder_path={encoder}"] if encoder else []), *args.overrides]


def headline_datasets(cfg, args, device) -> tuple[OnlineKspaceDataset, OnlineKspaceDataset]:
    """(train, validation): the headline model's volumes online, the train
    set remasked each epoch, the validation set's masks fixed."""
    dcfg, mcfg = cfg.data, cfg.model
    common = dict(center_fraction=dcfg.center_fraction, acceleration=dcfg.acceleration,
                  outer_patch_size=mcfg.outer_patch_size,
                  inner_patch_size=mcfg.inner_patch_size, device=device)
    val_seed = TRAIN_SEED + args.train_files
    sets = []
    for split, seeds, remask in ((dcfg.train, range(TRAIN_SEED, val_seed), True),
                                 (dcfg.val, range(val_seed, val_seed + args.val_files), False)):
        stems, volumes = phantoms(seeds, args)
        sets.append(OnlineKspaceDataset.from_volumes(
            stems, volumes, max_slice_num=split.max_slice_num, num_samples=split.num_samples,
            seed=split.seed, remask_each_epoch=remask, **common))
    return sets[0], sets[1]


def conv_encoder(args, device) -> pathlib.Path | None:
    """The conv autoencoder spliced into the headline model: ``--encoder``
    (None for ``none``), by default the quality protocol's under
    ``--protocol-root``, pretrained for ``--ae-epochs`` when it is missing."""
    if args.encoder == "none":
        return None
    if args.encoder:
        path = pathlib.Path(args.encoder)
        if not path.is_file():
            raise FileNotFoundError(f"--encoder {args.encoder}: no such file")
        return path
    root = pathlib.Path(args.protocol_root).resolve()
    path = train_encoder.checkpoint_paths(root / rr.AUTOENCODERS["conv"][0], "conv",
                                          args.ae_epochs - 1)[0]
    if path.is_file():
        return path
    ap = argparse.ArgumentParser()
    qr.add_protocol_args(ap, args.protocol_root)
    pargs = ap.parse_args(["--ae-epochs", str(args.ae_epochs), "--device", device.type,
                           *[x for o in args.overrides if o.startswith("model.")
                             for x in ("--set", o)]])
    return rr.Protocol(pargs, root, device).autoencoder("conv")[0]


def train_headline(args, root: pathlib.Path, device, launches) -> tuple[pathlib.Path, dict]:
    """Train the headline model to ``--epochs``, then resume it to
    ``--resume-epochs``; returns (run directory, record)."""
    dev = ["--device", device.type]
    encoder = conv_encoder(args, device)
    cfg = config_lib.load_train_configuration(None, headline_sets(args, root, encoder,
                                                                  args.epochs))
    train_ds, val_ds = headline_datasets(cfg, args, device)
    record = {"train_seeds": [TRAIN_SEED, TRAIN_SEED + args.train_files - 1],
              "val_seeds": [TRAIN_SEED + args.train_files,
                            TRAIN_SEED + args.train_files + args.val_files - 1],
              "val_seeds_note": "a choice of the port: the JAX run's validation stems "
                                "are not recorded",
              "encoder": qr.cwd_relative(encoder) if encoder else None,
              "runs": []}
    run_dir = None
    for epochs, resume in ((args.epochs, False), (args.resume_epochs, True)):
        sets = headline_sets(args, root, encoder, epochs)
        if resume:
            sets.append("training.continue_training=true")
        start = len(train_ds.mask_epochs)
        with launches.stage(f"train_to_{epochs}"):
            t0 = time.perf_counter()
            trainer = cli_train.main(dev + qr._sets(*sets), datasets=(train_ds, val_ds))
            seconds = time.perf_counter() - t0
        run_dir = trainer.run_dir
        last = trainer._progress[-1]
        first = last["epoch"] + 1 - len(trainer._progress)
        # the mask epochs this run materialised past the initial losses'
        # epoch 0: one a train epoch from the first (a resumed run's
        # continue where the earlier run stopped)
        raw = train_ds.mask_epochs[start:]
        seen = [e for e in raw if e]
        want = [e for e in range(first, epochs) if e]
        record["runs"].append({
            "epochs": [first, epochs], "seconds": seconds,
            "steps": trainer.state.step, "initial_losses": list(trainer.initial_losses),
            "train_loss": last["train_loss"], "val_loss": last["val_loss"],
            # the first three and last three mask epochs materialised, and their count
            "mask_epochs": {"ends": raw[:3] + raw[3:][-3:], "count": len(raw)}})
        check(seen == want, f"mask epochs of the run to {epochs}: {seen[:3]} ... "
              f"{seen[-3:]}, want {want[:3]} ... {want[-3:]}")
        # keep each run's progress log: the resumed run rewrites the file
        shutil.copy(run_dir / "progress_log.csv", run_dir / f"progress_log_to_{epochs}.csv")
        del trainer
    record["run_dir"] = qr.cwd_relative(run_dir)
    (root / "run_info.json").write_text(json.dumps(record, indent=2) + "\n")
    return run_dir, record


class Launches:
    """The kernels' launches per stage of the run."""

    def __init__(self):
        self.by_stage: dict[str, dict[str, int]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        before = {k: f.launches for k, f in rr.COUNTERS.items()}
        try:
            yield
        finally:
            self.by_stage[name] = {k: f.launches - before[k] for k, f in rr.COUNTERS.items()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"sweep940 check failed: {what}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_leg(name: str, argv: list[str], device, launches, sampler=None) -> tuple[list, dict]:
    """One call of the test CLI's ``main``: its rows and its record."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    with launches.stage(name):
        t0 = time.perf_counter()
        rows = cli_test.main(argv, sampler=sampler, timings=timings)
        _sync(device)
        wall = time.perf_counter() - t0
    execute = timings.get("dispatch_seconds", 0.0) + timings.get("execute_fetch_seconds", 0.0)
    return rows, {
        "wall_seconds": wall,
        "metric_pass_seconds": timings.get("metric_seconds"),
        "stage_seconds": timings.get("stage_seconds"),
        "dispatch_seconds": timings.get("dispatch_seconds"),
        "execute_fetch_seconds": timings.get("execute_fetch_seconds"),
        # the device sweep's rate once the stacks are on the device
        "steady_slices_per_sec": len(rows) / execute if execute else None,
        "peak_device_mib": (torch.cuda.max_memory_allocated() / 2**20
                            if device.type == "cuda" else None),
        "slices": len(rows),
    }


def row_tuples(rows) -> list[tuple]:
    return sorted((r.slice_id, r.psnr, r.ssim, r.nrmse) for r in rows)


def max_row_gap(a, b) -> float:
    """The largest |difference| of PSNR, SSIM and NRMSE over rows sorted
    by slice; the slices must match."""
    ta, tb = row_tuples(a), row_tuples(b)
    check([t[0] for t in ta] == [t[0] for t in tb], "the legs scored different slices")
    if not ta:
        return 0.0
    return float(np.max(np.abs(np.array([t[1:] for t in ta]) - np.array([t[1:] for t in tb]))))


def max_stat_gap(a: dict, b: dict) -> float:
    return max(abs(a[m][s] - b[m][s]) for m in rr.BARS for s in STATS)


@torch.no_grad()
def piece_invariance(run_dir: pathlib.Path, meta: pathlib.Path, overrides: list[str],
                     device) -> dict:
    """Which stage of the sweep's forward sees the piece a slice is scored
    in: the first two evaluation slices scored together and the first one
    alone, compared on its rows after the encoder, after the whole forward
    and after the metrics (max |difference|; 0 where the stage is
    independent of the other slices in its batch)."""
    cfg = config_lib.load_test_configuration(None, overrides)
    mcfg = cfg.model
    model = ms.from_config(mcfg, generator=torch.Generator().manual_seed(0), device=device)
    cli_test._restore(model, run_dir)
    apply_fn = make_apply_fn(model, use_pallas=mcfg.use_pallas, sin5=cfg.data.sin5,
                             device=device)
    recon = ev.SliceReconstructor(
        apply_fn, outer_patch_size=mcfg.outer_patch_size,
        inner_patch_size=mcfg.inner_patch_size, siren_patch_size=mcfg.siren_patch_size,
        patch_bucket=512, device=device)
    sampler = MRISampler(meta, max_slice_num=100)
    pairs = [sampler.next_sample() for _ in range(2)]
    fully = torch.from_numpy(np.stack([p.fully_sampled for p in pairs])).to(device)
    under = torch.from_numpy(np.stack([p.undersampled for p in pairs])).to(device)
    tiles = tiling.image_to_patches(under, mcfg.outer_patch_size, mcfg.inner_patch_size)
    n = tiles.shape[1]
    tiles = tiles.reshape(-1, *tiles.shape[2:])
    gap = lambda a, b: float((a.float() - b.float()).abs().max())
    return {
        "slice": pairs[0].slice_id,
        "patches": n,
        "encoder": gap(model.encode(tiles)[:n], model.encode(tiles[:n])),
        "forward": gap(apply_fn(tiles)[:n], apply_fn(tiles[:n])),
        "metrics": gap(recon.metrics_stack(fully, under)[:, :1],
                       recon.metrics_stack(fully[:1], under[:1])),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="runs/results_torch/sweep940")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--files", type=int, default=235)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--train-files", type=int, default=60)
    ap.add_argument("--val-files", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--resume-epochs", type=int, default=700)
    ap.add_argument("--encoder", default=None,
                    help="conv autoencoder file spliced into the headline model, or none "
                         "(default: the quality protocol's under --protocol-root)")
    ap.add_argument("--protocol-root", default="runs/results_torch",
                    help="the quality protocol's root, whose conv autoencoder is the default")
    ap.add_argument("--ae-epochs", type=int, default=30)
    ap.add_argument("--model-dir", default=None,
                    help="score this train CLI run directory instead of training one")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="train CLI override (repeatable); model.* ones also reach the "
                         "test CLI")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dev = ["--device", device.type]
    root = pathlib.Path(args.root).resolve()
    root.mkdir(parents=True, exist_ok=True)
    card = qr.card_name() if device.type == "cuda" else "cpu"
    print(f"sweep940 on {card}", flush=True)
    launches, out = Launches(), {}
    t_start = time.perf_counter()
    if device.type == "cuda":
        t0 = time.perf_counter()
        qr.build_kernels()
        out["kernel_build_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with launches.stage("data"):
        stems, volumes = phantoms(range(EVAL_SEED, EVAL_SEED + args.files), args)
        meta = eval_split(root, stems, volumes, device)
    out["data_seconds"] = time.perf_counter() - t0
    n = args.files * args.slices
    print(f"data ready: {n} slices ({out['data_seconds']:.1f}s)", flush=True)

    if args.model_dir:
        run_dir, headline = pathlib.Path(args.model_dir).resolve(), None
    else:
        run_dir, headline = train_headline(args, root, device, launches)
        # the trainer's CUDA graphs and tiles go before the legs measure memory
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"model: {run_dir}", flush=True)

    model_sets = [o for o in args.overrides if o.startswith("model.")]
    common = [f"data.dataset={meta}", f"data.model_path={run_dir}", "data.max_slice_num=100",
              "data.batch_patches=512", "data.visual_samples=0",
              f"data.output_dir={root / 'eval'}", *model_sets]
    cli = lambda name, *extra: dev + qr._sets(*common, f"data.output_name={name}") + list(extra)
    legs = {}
    full, legs["offline"] = run_leg("offline", cli("full"), device, launches)
    ds = OnlineKspaceDataset.from_volumes(stems, volumes, max_slice_num=100,
                                          remask_each_epoch=False, device=device)
    online, legs["online"] = run_leg("online", cli("online_full"), device, launches,
                                     sampler=OnlineSampler(ds, host_prefetch=False))
    del ds
    for i in range(2):
        _, legs[f"shard{i}"] = run_leg(f"shard{i}", cli("sharded", "--shard", f"{i}:2"),
                                       device, launches)
    t0 = time.perf_counter()
    cli_test.main(cli("sharded", "--merge-shards"))
    legs["merge"] = {"wall_seconds": time.perf_counter() - t0}

    eval_dir = root / "eval"
    merged_rows = ev.read_metrics_csv(eval_dir / "sharded" / "metrics_error.csv")
    full_csv = ev.read_metrics_csv(eval_dir / "full" / "metrics_error.csv")
    stat = lambda rows: {m: {s: float(getattr(np, s)(v)) for s in STATS}
                         for m, v in (("PSNR", [r.psnr for r in rows]),
                                      ("SSIM", [r.ssim for r in rows]),
                                      ("NRMSE", [r.nrmse for r in rows]))}
    full_stats, merged_stats, online_stats = stat(full), stat(merged_rows), stat(online)

    row_gap = max_row_gap(full_csv, merged_rows)
    exact = row_gap == 0.0 and max_stat_gap(full_stats, merged_stats) < SHARD_SUMMARY_BAR
    row_bar = 0.0 if device.type == "cpu" else CARD_SHARD_ROW_BAR
    checks = {
        "shards": {"exact": exact, "max_row_gap": row_gap,
                   "max_summary_gap": max_stat_gap(full_stats, merged_stats),
                   "row_bar": row_bar, "held": exact or (
                       row_gap <= row_bar
                       and max_stat_gap(full_stats, merged_stats) <= max(row_bar, 1e-9))},
        "online": {"max_stat_gap": max_stat_gap(full_stats, online_stats), "bar": ONLINE_BAR,
                   "max_row_gap": max_row_gap(full, online)},
    }
    checks["online"]["held"] = checks["online"]["max_stat_gap"] <= ONLINE_BAR
    checks["shards"]["piece_invariance"] = piece_invariance(
        run_dir, meta, [f"data.dataset={meta}", *model_sets], device)
    jax = json.loads(JAX_SWEEP.read_text())["summary"]
    deltas = {m: full_stats[m]["mean"] - jax[m]["mean"] for m in rr.BARS}
    checks["jax"] = {"summary": jax, "deltas": deltas,
                     "within_bar": {m: abs(d) <= rr.BARS[m] for m, d in deltas.items()},
                     "bar": rr.BARS, "held": "recorded, not held (one seed each side)"}

    out.update({
        "slices": n, "image_size": args.size, "eval_volumes": args.files,
        "eval_seeds": [EVAL_SEED, EVAL_SEED + args.files - 1],
        "model_dir": qr.cwd_relative(run_dir), "headline": headline,
        "legs": legs, "summary": full_stats, "online_summary": online_stats,
        "sharded_summary": merged_stats, "checks": checks,
        "launches": launches.by_stage, "wall_seconds": time.perf_counter() - t_start,
        "device": card, "torch": torch.__version__,
    })
    (root / "sweep940.json").write_text(json.dumps(out, indent=2) + "\n")
    for name, leg in legs.items():
        print(f"leg {name}: {json.dumps(leg)}", flush=True)
    print(f"checks: {json.dumps(checks)}", flush=True)
    print(f"wrote {root / 'sweep940.json'}", flush=True)
    check(checks["shards"]["held"],
          f"sharded + merged rows against the unsharded run: {checks['shards']}")
    check(checks["online"]["held"], f"online leg against offline: {checks['online']}")
    return out


if __name__ == "__main__":
    main()
