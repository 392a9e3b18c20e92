"""The quality protocol's ablation and acceleration rows on the port
(counterpart of the repository's ``scripts/results_run.py``): each row
trains the modulated SIREN under one changed setting and scores it with the
metric sweep, through the port's own entry points, in this process.

    python -m mri_inr_tpu_torch.cli.results_run [--root runs/results_torch] \\
        [--rows a,b,...] [--seed K] [--epochs 600] [--ae-epochs 30] \\
        [--device cpu|cuda] [--render]

The protocol is ``cli/quality_run``'s (``RESULTS.md:16-21``): phantom seeds
0 / 1000 / 2000, 24 / 4 / 12 volumes x 4 slices at 256x256; a conv
autoencoder (30 epochs, batch 1024) shared by every row but the VGG ones; 600
epochs at batch 400 (``max_slice_num=100``, ``device_data``); the sweep at
``batch_patches=512``. The splits and the autoencoders are built under
``--root`` when a row first needs them and reused after.

Rows (the JAX runner's names; :data:`ROWS`): ``baseline``, ``morlet``,
``edge``, ``residual`` (module path), ``vgg`` (its own VGG autoencoder, 30
epochs at batch 256 and lr 1e-3), ``perceptual`` (a perceptual autoencoder,
30 epochs at batch 1024), ``acc_005_8``, ``acc_01_6``, ``acc_02_4`` (the
acceleration rows; 8 / 0.05 and 4 / 0.2 on splits preprocessed again with
four mask pairs), ``online_remask`` (the train split's k-space in memory, new
masks each epoch on the device; validation and eval offline),
``train_sin5`` (``training.sin5=false``: the port trains with degree-5 sines
by default, so this row pairs with the JAX baseline and the port's
``baseline`` with the JAX ``train_sin5``), ``vgg_frozen_rand`` and
``vgg_frozen_corpus`` (a frozen VGG trunk, random or the VGG autoencoder's),
``vgg_frozen_rand_sin9`` (the random control with ``training.sin5=false``,
as the JAX row trained its sines), ``vgg_frozen_rand_module`` (the random
control on the module path, ``training.use_pallas=false``: exact sines and
the module's dropout, the route the JAX row took), and
``vgg_frozen_corpus_module`` (the same for the corpus-pretrained trunk:
the row's own VGG autoencoder, as ``vgg_frozen_corpus``). The VGG rows
record the trunk's feature mean over the train split's undersampled tiles (a mean
above about 1 leaves the spliced SIREN ill-posed).

``--seed K`` (K > 0) repeats the rows at another seed: ``training.seed=K``
(the model's init, a random VGG trunk's too, and the dropout stream), and a
row's own VGG or perceptual autoencoder pretrained by ``train_encoder --seed
K`` under ``encoder_vgg_seedK/`` (the conv autoencoder stays shared, as in
the JAX package's seed runs). Such a row is ``<row>@seed<K>`` in
``rows.json`` and under ``--root``; ``baseline@seed1`` and
``online_remask@seed1`` are held against the JAX ``seed1_offline`` and
``seed1_online`` runs (``runs/results/seed1_*``), every other against its
seed-0 JAX row. ``--seed 0`` (the default) is the rows as they were.

``rows.json`` under ``--root`` is rewritten after every row; each row holds
its overrides, the corpus and scale of ``--root`` (``protocol.json``, which
a call with another protocol raises on: ``quality_run.guard_protocol``), its
autoencoder files, the mean / std / min / max of PSNR,
SSIM and NRMSE, the seconds of each stage, the kernels' launches, the card
and the torch version; ``<row>/run_info.json`` holds the same. A row already
in ``rows.json`` is skipped, so a run continues where an earlier one
stopped. A row that fails is reported with its traceback and the later rows
run; the process then exits nonzero naming the failed rows. ``--render``
writes ``TABLE.md``: each row against its JAX row (read from the committed
``runs/results/rows.json`` and ``runs/quality``) with the bar of 0.3 dB /
0.01 / 0.01 and each side's training route (``fused``: the SIREN kernels;
``module``: the plain modules, as ``training.use_pallas=false`` and the
residual model train), the orderings ``RESULTS.md:41-48`` reads, and for
each row run at more than one seed its value at each seed, their mean and
range beside the JAX readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import time
import traceback
from collections.abc import Callable

import numpy as np
import torch
import yaml

from mri_inr_tpu_torch.cli import quality_run as qr
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.data.dataset import MRIDataset
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset
from mri_inr_tpu_torch.ops import dropout, fft_kernel, siren_kernel, siren_train_kernel
from mri_inr_tpu_torch.utils.device import resolve_device

REPO = pathlib.Path(__file__).resolve().parents[2]
#: the JAX package's rows (``scripts/results_run.py``) and its baseline row's
#: summary (``scripts/quality_run.py``), committed data files
JAX_ROWS = REPO / "runs" / "results" / "rows.json"
JAX_BASELINE = REPO / "runs" / "quality" / "eval" / "quality" / "metrics_summary.txt"
#: the JAX package's seed repeats (``RESULTS.md:53-54``): (port row, seed) ->
#: the JAX run, whose ``eval/metrics_summary.txt`` lies under ``runs/results``
JAX_SEED_RUNS = {("baseline", 1): "seed1_offline", ("online_remask", 1): "seed1_online"}
#: the mask pairs of the acceleration rows' splits (``scripts/results_run.py:48-70``)
ACC_MASKS = ((0.05, 6), (0.05, 8), (0.1, 6), (0.2, 4))
#: bars of a row's means against its JAX row (the baseline row's own bar)
BARS = {"PSNR": 0.3, "SSIM": 0.01, "NRMSE": 0.01}
#: the kernels whose launches each row records
COUNTERS = {"dft2c": fft_kernel.dft2c_ri_cuda,
            "siren_train_fwd": siren_train_kernel.siren_chain_train_fwd_cuda,
            "siren_train_bwd": siren_train_kernel.siren_chain_train_bwd_cuda,
            "siren_forward": siren_kernel.siren_forward_cuda,
            "threefry_dropout": dropout.threefry_keep_mask_cuda}
#: autoencoder -> (directory under --root, train_encoder model, batch); each
#: trains at train_encoder's default lr of 1e-3
AUTOENCODERS = {"conv": ("encoder", "conv", 1024),
                "vgg": ("encoder_vgg", "vgg", 256),
                "perceptual": ("encoder_perceptual", "perceptual", 1024)}


@dataclasses.dataclass(frozen=True)
class Row:
    jax: str  # the JAX row it is held against ("baseline": runs/quality)
    train: tuple[str, ...] = ()  # train CLI overrides
    eval: tuple[str, ...] = ()  # test CLI overrides
    encoder: str | None = "conv"  # the autoencoder spliced in (AUTOENCODERS)
    splits: str = "processed"  # "processed_acc": the four mask pairs
    online: bool = False  # the train split online, remasked each epoch
    perceptual: bool = False  # criterion=perceptual on the perceptual autoencoder
    note: str = ""


_VGG = ("model.encoder_type=vgg",)
_FROZEN = (*_VGG, "training.freeze_encoder=true")
#: every row, in the order a full run takes them: the new routes first, the
#: module path last
ROWS = {
    "online_remask": Row("online_remask", ("data.train.online=true",
                                           "data.train.remask_each_epoch=true"), online=True),
    "vgg": Row("vgg", _VGG, _VGG, encoder="vgg"),
    "perceptual": Row("perceptual", ("training.criterion=perceptual",), perceptual=True),
    "acc_005_8": Row("acc_005_8", ("data.acceleration=8",), ("data.acceleration=8",),
                     splits="processed_acc"),
    "acc_02_4": Row("acc_02_4", ("data.acceleration=4", "data.center_fraction=0.2"),
                    ("data.acceleration=4", "data.center_fraction=0.2"),
                    splits="processed_acc"),
    "vgg_frozen_corpus": Row("vgg_frozen_corpus", _FROZEN, _VGG, encoder="vgg"),
    "vgg_frozen_rand": Row("vgg_frozen_rand", _FROZEN, _VGG, encoder=None),
    "edge": Row("edge", ("training.criterion=edge",)),
    "morlet": Row("morlet", ("model.activation=morlet",), ("model.activation=morlet",)),
    "acc_01_6": Row("acc_01_6", ("data.center_fraction=0.1",), ("data.center_fraction=0.1",)),
    "train_sin5": Row("baseline", ("training.sin5=false",),
                      note="degree-5 train sines off; the JAX baseline trained without them"),
    "baseline": Row("train_sin5", note="degree-5 train sines on (the port's default), as the "
                    "JAX train_sin5 row"),
    "residual": Row("residual", ("model.residual=true",), ("model.residual=true",)),
    "vgg_frozen_rand_sin9": Row("vgg_frozen_rand", (*_FROZEN, "training.sin5=false"), _VGG,
                                encoder=None, note="degree-5 train sines off, as the JAX "
                                "row trained through the Flax path"),
    "vgg_frozen_rand_module": Row("vgg_frozen_rand", (*_FROZEN, "training.use_pallas=false"),
                                  _VGG, encoder=None, note="trained on the module path "
                                  "(exact sines, the module's dropout), the JAX row's "
                                  "recorded route"),
    "vgg_frozen_corpus_module": Row("vgg_frozen_corpus",
                                    (*_FROZEN, "training.use_pallas=false"), _VGG,
                                    encoder="vgg", note="trained on the module path (exact "
                                    "sines, the module's dropout), the JAX row's recorded "
                                    "route"),
}


def route(overrides) -> str:
    """``module`` where train overrides (``k=v`` items, a ``--set`` between
    them ignored) put training on the plain modules (``use_pallas`` off, or
    the residual model, which has no kernel), else ``fused``."""
    kv = dict(o.lower().split("=", 1) for o in overrides if "=" in o)
    use = kv.get("training.use_pallas", "none")
    use = kv.get("model.use_pallas", "true") if use in ("none", "null") else use
    return "module" if use == "false" or kv.get("model.residual") == "true" else "fused"


def row_key(name: str, seed: int) -> str:
    """The name of row ``name`` at ``seed`` in ``rows.json`` and under
    ``--root``: the row's own at seed 0, ``<row>@seed<K>`` else."""
    return name if seed == 0 else f"{name}@seed{seed}"


def jax_pair(name: str, seed: int) -> str:
    """The JAX run row ``name`` at ``seed`` is held against."""
    return JAX_SEED_RUNS.get((name, seed), ROWS[name].jax)


class Protocol:
    """The splits, phantom volumes and autoencoders shared by the rows,
    built when a row first asks for them, under a root whose protocol
    matches ``args`` (``quality_run.guard_protocol``)."""

    def __init__(self, args, root: pathlib.Path, device: torch.device):
        self.protocol = qr.guard_protocol(root, args)
        self.args, self.root, self.device = args, root, device
        self.dev = ["--device", device.type]
        self.latent = config_lib.load_train_configuration(None, args.overrides).model.latent_dim
        self._splits: dict[str, dict] = {}
        self._autoencoders: dict[str, tuple] = {}

    def splits(self, processed: str) -> dict[str, pathlib.Path]:
        if processed not in self._splits:
            masks = ACC_MASKS if processed == "processed_acc" else preprocessing.DEFAULT_MASKS
            self._splits[processed] = qr.make_splits(self.root, self.args, self.device,
                                                     processed, masks)
        return self._splits[processed]

    def autoencoder(self, kind: str, seed: int = 0) -> tuple[pathlib.Path, pathlib.Path]:
        """The ``kind`` autoencoder's files; at ``seed`` > 0 a VGG or
        perceptual one is pretrained from that seed into its own directory,
        the conv one stays the shared seed-0 file."""
        seed = 0 if kind == "conv" else seed
        if (kind, seed) not in self._autoencoders:
            directory, model, batch = AUTOENCODERS[kind]
            self._autoencoders[kind, seed] = qr.pretrain(
                self.root / (directory + (f"_seed{seed}" if seed else "")), model,
                self.splits("processed"), self.args.ae_epochs, batch, self.latent, self.dev,
                seed)
        return self._autoencoders[kind, seed]

    def online_train_set(self, cfg, remask: bool = True) -> OnlineKspaceDataset:
        """The train split as the online route sees it: the phantom k-space
        of seeds 0 .. train_files - 1 (the volumes behind the offline split)
        on the device, new masks each epoch with ``remask``."""
        seeds = range(qr.SPLIT_SEEDS["train"], qr.SPLIT_SEEDS["train"] + self.args.train_files)
        dcfg, mcfg, split = cfg.data, cfg.model, cfg.data.train
        return OnlineKspaceDataset.from_volumes(
            [synthetic.synthetic_stem(s) for s in seeds],
            [qr.phantom_kspace(s, self.args) for s in seeds],
            center_fraction=dcfg.center_fraction, acceleration=dcfg.acceleration,
            max_slice_num=split.max_slice_num, num_samples=split.num_samples, seed=split.seed,
            outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size,
            remask_each_epoch=remask, device=self.device)


def trunk_features(cfg, meta: pathlib.Path, device: torch.device, chunk: int = 4096) -> dict:
    """Mean, largest value and share of zeros of the spliced VGG trunk's
    features over the undersampled tiles of the split ``meta``, as
    ``scripts/torch_vgg_splice_probe.py`` reads them (the model the train
    CLI builds, before any step)."""
    model = cli_train.build_model(cfg, device, log=lambda *_: None)
    trunk = model.encoder.encoder.trunk
    dcfg, split = cfg.data, cfg.data.train
    tiles = MRIDataset(meta, center_fraction=dcfg.center_fraction,
                       acceleration=dcfg.acceleration, mri_type=split.mri_type,
                       max_slice_num=split.max_slice_num).under_tiles
    total, top, zeros, count = 0.0, -np.inf, 0, 0
    with torch.no_grad():
        for i in range(0, len(tiles), chunk):
            f = trunk(torch.from_numpy(tiles[i:i + chunk]).to(device)).float()
            total += float(f.double().sum())
            top = max(top, float(f.max()))
            zeros += int((f == 0).sum())
            count += f.numel()
    return {"tiles": len(tiles), "mean": total / count, "max": top, "zero_share": zeros / count}


def run_row(name: str, proto: Protocol, card: str, seed: int = 0,
            jax_row: str | None = None, note: str | None = None) -> dict:
    """Train and score row ``name`` under ``proto``'s root; its record, held
    against ``jax_row`` (by default :func:`jax_pair`'s), with ``note`` (by
    default the row's own)."""
    spec, args, dev = ROWS[name], proto.args, proto.dev
    note = spec.note if note is None else note
    key = row_key(name, seed)
    row_dir = proto.root / key
    stages, info = {}, {}
    before = {k: f.launches for k, f in COUNTERS.items()}

    t0 = time.perf_counter()
    meta = proto.splits(spec.splits)
    stages["data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sets = list(spec.train) + ([f"training.seed={seed}"] if seed else [])
    if spec.encoder:
        enc_file, _ = proto.autoencoder(spec.encoder, seed)
        sets.append(f"model.encoder_path={enc_file}")
        info["autoencoder"] = qr.cwd_relative(enc_file)
    if spec.perceptual:
        perc_file, _ = proto.autoencoder("perceptual", seed)
        sets.append(f"training.perceptual_encoder_path={perc_file}")
        info["perceptual_autoencoder"] = qr.cwd_relative(perc_file)
    sets += args.overrides
    stages["autoencoder"] = time.perf_counter() - t0

    cfg = config_lib.load_train_configuration(
        None, qr.train_sets(meta, row_dir, name, args.epochs, *sets))
    if cfg.model.encoder_type == "vgg":
        info["trunk_features"] = trunk_features(cfg, meta["train"], proto.device)
        print(f"row {key}: VGG trunk features over the train split: {info['trunk_features']}",
              flush=True)
    datasets = None
    if spec.online:
        t0 = time.perf_counter()
        datasets = (proto.online_train_set(cfg), cli_train._dataset(cfg.data.val, cfg.data,
                                                                    cfg.model))
        stages["data"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    trainer = qr.train_stage(meta, row_dir, key, args.epochs, dev, *sets, datasets=datasets)
    run_dir = trainer.run_dir
    del trainer, datasets
    stages["train"] = time.perf_counter() - t0

    return score_row(proto, spec, meta, run_dir, row_dir, "eval", card, stages, before, {
        "row": key,
        **({"base_row": name, "seed": seed} if seed else {}),
        "jax_row": jax_row or jax_pair(name, seed),
        **({"note": note} if note else {}),
        "epochs": args.epochs,
        "ae_epochs": args.ae_epochs,
        "corpus": proto.protocol,
        "run_dir": qr.cwd_relative(run_dir),
        "eval_dir": qr.cwd_relative(row_dir / "eval"),
        "train_overrides": sets}, info)


def score_row(proto: Protocol, spec: Row, meta: dict, run_dir: pathlib.Path,
              out_dir: pathlib.Path, eval_name: str, card: str, stages: dict, before: dict,
              record: dict, info: dict) -> dict:
    """The eval stage of a trained row: the test CLI's sweep of ``run_dir``
    into ``out_dir / eval_name``; returns ``record`` and ``info`` completed
    with the metrics, stage seconds, kernel launches since ``before`` and
    the card, as written to ``<root>/<row>/run_info.json``."""
    t0 = time.perf_counter()
    model_sets = [o for o in proto.args.overrides if o.startswith("model.")]
    rows = qr.eval_stage(meta, run_dir, out_dir, eval_name, proto.dev, *spec.eval, *model_sets)
    stages["eval"] = time.perf_counter() - t0
    # the row's CUDA graphs and device buffers go before the next row's
    gc.collect()
    if proto.device.type == "cuda":
        torch.cuda.empty_cache()

    out = {
        **record,
        "eval_overrides": [*spec.eval, *model_sets],
        "splits": spec.splits,
        **info,
        "slices": len(rows),
        **qr.summary(rows),
        "stage_seconds": stages,
        "train_seconds": stages["train"],
        "eval_seconds": stages["eval"],
        "launches": {k: f.launches - before[k] for k, f in COUNTERS.items()},
        "device": card,
        "torch": torch.__version__,
    }
    row_dir = proto.root / record["row"]
    row_dir.mkdir(parents=True, exist_ok=True)
    (row_dir / "run_info.json").write_text(json.dumps(out, indent=2) + "\n")
    return out


# ------------------------------------------------------------------ the table
def read_summary(path: pathlib.Path) -> dict[str, dict]:
    """``metrics_summary.txt`` as ``{"PSNR": {"mean": ..., "std": ...}, ...}``."""
    out = {}
    for line in path.read_text().splitlines():
        metric, rest = line.split(":", 1)
        out[metric.strip()] = {kv.split("=")[0]: float(kv.split("=")[1]) for kv in rest.split()}
    return out


def _run_config(eval_dir: pathlib.Path) -> dict | None:
    """The ``config.yaml`` of the run scored into ``eval_dir``: a run
    directory beside it (``<row>/<row>_<stamp>``) or, for a quality run's
    ``eval/<name>``, under ``train/``."""
    found = (sorted(eval_dir.parent.glob("*/config.yaml"))
             + sorted(eval_dir.parent.parent.glob("train/*/config.yaml")))
    return yaml.safe_load(found[0].read_text()) if found else None


def _config_route(eval_dir: pathlib.Path) -> str:
    cfg = _run_config(eval_dir)
    if cfg is None:
        return "n/a"
    return route([f"training.use_pallas={cfg['training'].get('use_pallas')}",
                  f"model.use_pallas={cfg['model'].get('use_pallas', True)}",
                  f"model.residual={cfg['model'].get('residual', False)}"])


def jax_rows(rows_json: pathlib.Path, baseline_summary: pathlib.Path,
             runs: dict[str, str] | None = None) -> dict[str, dict]:
    """The JAX package's rows by name, each with its training ``route``:
    ``rows_json`` (``scripts/results_run.py``'s file; the route from its
    recorded overrides), the baseline row from its ``metrics_summary.txt``,
    and each row of ``runs`` (JAX row -> the directory of its
    ``metrics_summary.txt`` under ``rows_json``'s) that ``rows_json`` lacks,
    where that file exists (the route from its run's ``config.yaml``). By
    default ``runs`` holds the seed repeats of :data:`JAX_SEED_RUNS`."""
    if runs is None:
        runs = {run: f"{run}/eval" for run in JAX_SEED_RUNS.values()}
    rows = {r["row"]: {**r, "route": route(r.get("train_overrides", []))}
            for r in json.loads(rows_json.read_text())}
    summaries = {"baseline": baseline_summary}
    summaries.update({name: rows_json.parent / path / "metrics_summary.txt"
                      for name, path in runs.items() if name not in rows})
    for name, summary in summaries.items():
        if summary.is_file():
            rows[name] = {"row": name, **read_summary(summary),
                          "route": _config_route(summary.parent)}
    return rows


@dataclasses.dataclass(frozen=True)
class Table:
    """What a corpus's ``TABLE.md`` holds its rows against and reads."""
    command: str  # the module whose --render writes it
    heading: str
    jax_files: str  # the JAX files, as TABLE.md names them
    rows_json: pathlib.Path
    baseline: pathlib.Path
    runs: dict[str, str] | None  # jax_rows' runs
    orderings: Callable[[dict], list]
    orderings_source: str
    #: port row -> JAX row where the JAX orderings read the rows by the port
    #: row each pairs with; None: by the JAX rows' own names
    pairs: dict[str, str] | None = None
    ssim_min: bool = False  # a column of each side's SSIM minimum

    def jax(self) -> dict[str, dict]:
        return jax_rows(self.rows_json, self.baseline, self.runs)


def _mean(row: dict | None, metric: str) -> float | None:
    return None if row is None else row[metric]["mean"]


def orderings(rows: dict[str, dict], baseline: str = "baseline") -> list[tuple[str, str, bool]]:
    """(what is read, the values, whether it holds) for the orderings of
    ``RESULTS.md:41-48``, over the rows present."""
    psnr = {k: _mean(r, "PSNR") for k, r in rows.items()}
    ssim = {k: _mean(r, "SSIM") for k, r in rows.items()}
    out = []
    if {"edge", baseline} <= psnr.keys():
        out.append(("edge >= baseline (PSNR)",
                    f"{psnr['edge']:.4f} vs {psnr[baseline]:.4f}", psnr["edge"] >= psnr[baseline]))
    if {"residual", baseline} <= psnr.keys():
        d = psnr["residual"] - psnr[baseline]
        out.append(("residual ~= baseline (PSNR within 0.3 dB)", f"{d:+.4f} dB",
                    abs(d) <= BARS["PSNR"]))
    ablations = [k for k in (baseline, "edge", "morlet", "residual", "vgg", "perceptual")
                 if k in ssim]
    if "perceptual" in ssim and len(ablations) > 1:
        worst = min(ablations, key=ssim.get)
        out.append(("perceptual has the worst SSIM of the ablations",
                    ", ".join(f"{k} {ssim[k]:.4f}" for k in ablations), worst == "perceptual"))
    acc = [k for k in ("acc_005_8", baseline, "acc_01_6", "acc_02_4") if k in psnr]
    if len(acc) == 4:
        vals = [psnr[k] for k in acc]
        out.append(("acc8/.05 < acc6/.05 < acc6/.10 < acc4/.20 (PSNR)",
                    " < ".join(f"{v:.4f}" for v in vals),
                    all(a < b for a, b in zip(vals, vals[1:]))))
    if {"online_remask", baseline} <= psnr.keys():
        dp = psnr["online_remask"] - psnr[baseline]
        ds = ssim["online_remask"] - ssim[baseline]
        out.append(("online remask >= baseline (PSNR)", f"{dp:+.4f} dB, SSIM {ds:+.4f}",
                    dp >= 0))
    return out


def render(port_rows: list[dict], jax: dict[str, dict], table: Table | None = None,
           extra: list[str] = ()) -> str:
    """``TABLE.md``: each port row against its JAX row, then the orderings,
    the seed section, ``extra`` lines and the notes."""
    table = table or SMOOTH
    cards = sorted({r.get("device", "?") for r in port_rows})
    ssim_min = ["SSIM min (port / JAX)"] if table.ssim_min else []
    head = ["Row", "JAX row", "Route (port / JAX)", "PSNR", "JAX", "d", "SSIM", "JAX", "d",
            *ssim_min, "NRMSE", "JAX", "d", "Within bar", "Train s", "Slices"]
    lines = [
        table.heading,
        "",
        f"Written by `python -m {table.command} --render` from this "
        f"directory's `rows.json`. JAX rows: {table.jax_files} (TPU v5e quality readings). Bar: "
        + " / ".join(f"{k} {v}" for k, v in BARS.items())
        + " on the means. Port rows on: " + "; ".join(cards) + ".",
        "",
        "| " + " | ".join(head) + " |",
        "|" + "---|" * len(head),
    ]
    for r in port_rows:
        ref = jax.get(r["jax_row"])
        cells = [r["row"], r["jax_row"], f"{route(r.get('train_overrides', []))} / "
                 + (ref.get("route", "n/a") if ref else "n/a")]
        verdict = []
        for m in BARS:
            p, j = _mean(r, m), _mean(ref, m)
            if j is None:
                cells += [f"{p:.4f}", "n/a", "n/a"]
            else:
                d = p - j
                cells += [f"{p:.4f}", f"{j:.4f}", f"{d:+.4f}"]
                verdict.append(f"{m} {'yes' if abs(d) <= BARS[m] else 'NO'}")
            if m == "SSIM" and table.ssim_min:
                cells.append(f"{r['SSIM']['min']:.4f} / "
                             + (f"{ref['SSIM']['min']:.4f}" if ref else "n/a"))
        cells += [", ".join(verdict) or "no JAX row", f"{r['stage_seconds']['train']:.1f}",
                  str(r["slices"])]
        lines.append("| " + " | ".join(cells) + " |")
    lines += ["", f"## Orderings (`{table.orderings_source}`)", "",
              "| Reads | Port | Holds | JAX | Holds |", "|---|---|---|---|---|"]
    port = {r["row"]: r for r in port_rows}
    jax_view = (jax if table.pairs is None else
                {k: jax[v] for k, v in table.pairs.items() if v in jax})
    got = {what: (vals, ok) for what, vals, ok in table.orderings(port)}
    want = {what: (vals, ok) for what, vals, ok in table.orderings(jax_view)}
    for what in want:
        p = got.get(what)
        lines.append(f"| {what} | {p[0] if p else 'rows missing'} | "
                     f"{('yes' if p[1] else 'no') if p else 'n/a'} | {want[what][0]} | "
                     f"{'yes' if want[what][1] else 'no'} |")
    lines += seed_section(port_rows, jax)
    lines += list(extra)
    notes = [r for r in port_rows if r.get("note") or "trunk_features" in r]
    if notes:
        lines += ["", "## Notes", ""]
        for r in notes:
            trunk = r.get("trunk_features")
            lines.append(f"- `{r['row']}`: " + "; ".join(filter(None, [
                r.get("note"),
                trunk and (f"VGG trunk features over {trunk['tiles']} train tiles: mean "
                           f"{trunk['mean']:.4g}, max {trunk['max']:.4g}")])))
    return "\n".join(lines) + "\n"


def seed_section(port_rows: list[dict], jax: dict[str, dict]) -> list[str]:
    """``TABLE.md``'s seed section: each row run at more than one seed, its
    value per seed, mean and range beside the JAX readings of every run it
    is paired with (the range over the finite values, a diverged run's NaN
    counted apart); then whether the seed-0 JAX row's PSNR lies inside the
    port's range and which seeds lie inside the bar on all three means."""
    groups: dict[str, dict[int, dict]] = {}
    for r in port_rows:
        groups.setdefault(r.get("base_row", r["row"]), {})[r.get("seed", 0)] = r
    groups = {k: v for k, v in groups.items() if len(v) > 1}
    if not groups:
        return []
    lines = ["", "## Seeds", "",
             "| Row | Metric | Port by seed | Mean | Min - max | JAX readings |",
             "|---|---|---|---|---|---|"]
    verdicts = []
    for base, by_seed in groups.items():
        seeds = sorted(by_seed)
        pairs = list(dict.fromkeys(by_seed[k]["jax_row"] for k in seeds))
        for m in BARS:
            vals = [_mean(by_seed[k], m) for k in seeds]
            finite = [v for v in vals if np.isfinite(v)]
            span = f"{min(finite):.4f} - {max(finite):.4f}" if finite else "n/a"
            if len(finite) < len(vals):
                span += f" ({len(vals) - len(finite)} not finite)"
            readings = "; ".join(f"{j} {_mean(jax[j], m):.4f}" for j in pairs if j in jax)
            lines.append(f"| {base} | {m} | " + ", ".join(
                f"{k}: {v:.4f}" for k, v in zip(seeds, vals))
                + f" | {np.mean(vals):.4f} | {span} | {readings or 'n/a'} |")
        ref = jax.get(by_seed[seeds[0]]["jax_row"])
        if ref is None:
            continue
        psnr = [v for v in (_mean(by_seed[k], "PSNR") for k in seeds) if np.isfinite(v)]
        inside = bool(psnr) and min(psnr) <= _mean(ref, "PSNR") <= max(psnr)
        in_bar = [k for k in seeds if all(abs(_mean(by_seed[k], m) - _mean(ref, m)) <= b
                                         for m, b in BARS.items())]
        verdicts.append(
            f"- `{base}` against `{by_seed[seeds[0]]['jax_row']}`: its PSNR "
            f"{_mean(ref, 'PSNR'):.4f} {'lies' if inside else 'does not lie'} inside the "
            f"port's range; seeds inside the bar on all three means: "
            f"{', '.join(map(str, in_bar)) or 'none'}")
    return lines + [""] + verdicts


SMOOTH = Table(
    command="mri_inr_tpu_torch.cli.results_run",
    heading="# The port's quality rows against the JAX package's",
    jax_files="`runs/results/rows.json` and, for its baseline, "
              "`runs/quality/eval/quality/metrics_summary.txt`",
    rows_json=JAX_ROWS, baseline=JAX_BASELINE, runs=None, orderings=orderings,
    orderings_source="RESULTS.md:41-48")


def run_rows(args, wanted: list[str], known: dict, run_one: Callable[..., dict],
             key: Callable[[str], str] = lambda name: name) -> tuple[dict, list, pathlib.Path]:
    """The runners' loop: hold ``args``' protocol against ``--root``'s, then
    run each row of ``wanted`` (``run_one(name, protocol, card)``) that
    ``rows.json`` lacks under ``key(name)``, rewriting ``rows.json`` after
    each. Returns the rows by key, the rows that failed (a traceback printed
    for each) and the root."""
    root = pathlib.Path(args.root).resolve()
    rows_path = root / "rows.json"
    done = ({r["row"]: r for r in json.loads(rows_path.read_text())}
            if rows_path.exists() else {})
    todo = [r for r in wanted if key(r) not in done]
    qr.guard_protocol(root, args, building=bool(todo))
    failed = []
    if todo:
        device = resolve_device(args.device)
        card = qr.card_name() if device.type == "cuda" else "cpu"
        print(f"results run on {card}: rows {todo}", flush=True)
        proto = Protocol(args, root, device)
        if device.type == "cuda":
            t0 = time.perf_counter()
            qr.build_kernels()
            print(f"kernels built ({time.perf_counter() - t0:.1f}s)", flush=True)
    for name in wanted:
        k = key(name)
        if k in done:
            print(f"row {k}: already in {rows_path}, skipped", flush=True)
            continue
        if name not in known:
            print(f"row {name}: unknown (known: {', '.join(known)})", flush=True)
            failed.append(name)
            continue
        t0 = time.perf_counter()
        try:
            done[k] = run_one(name, proto, card)
        except Exception:
            traceback.print_exc()
            print(f"row {k} FAILED after {time.perf_counter() - t0:.1f}s", flush=True)
            failed.append(k)
            continue
        rows_path.write_text(json.dumps(list(done.values()), indent=2) + "\n")
        r = done[k]
        print(f"row {k} done in {time.perf_counter() - t0:.1f}s: PSNR "
              f"{r['PSNR']['mean']:.4f} SSIM {r['SSIM']['mean']:.4f} NRMSE "
              f"{r['NRMSE']['mean']:.4f}", flush=True)
    return done, failed, root


def main(argv: list[str] | None = None) -> dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    qr.add_protocol_args(ap, "runs/results_torch")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help=f"comma-separated rows, run in this order (known: {', '.join(ROWS)})")
    ap.add_argument("--seed", type=int, default=0,
                    help="run the rows at this seed (> 0: rows <row>@seed<K>)")
    ap.add_argument("--render", action="store_true", help="write TABLE.md under --root")
    args = ap.parse_args(argv)
    done, failed, root = run_rows(
        args, [r for r in args.rows.split(",") if r], ROWS,
        lambda name, proto, card: run_row(name, proto, card, args.seed),
        lambda name: row_key(name, args.seed))
    if args.render:
        (root / "TABLE.md").write_text(render(list(done.values()), SMOOTH.jax()))
        print(f"wrote {root / 'TABLE.md'}", flush=True)
    if failed:
        raise SystemExit(f"results_run: rows failed: {', '.join(failed)}")
    return done


if __name__ == "__main__":
    main()
