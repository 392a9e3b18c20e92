"""The hard-corpus ablation table on the port (counterpart of the
repository's ``scripts/r5_hard_table.sh``): the quality protocol's rows
again on phantoms with complex phase maps, k-space noise at SNR 32 dB and
tissue texture 0.18, through ``cli/results_run``'s stage functions.

    python -m mri_inr_tpu_torch.cli.hard_table [--root runs/results_hard_torch] \\
        [--rows a,b,...] [--seed K] [--epochs 600] [--resume-epochs 1200] \\
        [--ae-epochs 30] [--device cpu|cuda] [--render]

The corpus is fixed here (:data:`HARD`); the rest is ``RESULTS.md:16-21``'s
protocol as ``cli/quality_run`` has it: phantom seeds 0 / 1000 / 2000, 24 /
4 / 12 volumes x 4 slices at 256x256, a 30-epoch conv autoencoder (and the
VGG and perceptual ones for their rows), 600 epochs at batch 400. Splits,
autoencoders and rows are built under ``--root``, whose ``protocol.json``
holds the corpus: a root built with another corpus raises before any file
is touched (``quality_run.guard_protocol``), so a hard call never reuses a
smooth split or autoencoder, nor the reverse.

Rows (:data:`PAIRS`, each beside the JAX hard row it is held against, under
``runs/results_hard``): ``baseline`` (degree-5 train sines, the port's
default, as the JAX hard baseline of ``runs/quality_hard`` trained),
``train_sin5`` (``training.sin5=false``, against ``train_sin9``), ``edge``,
``morlet``, the three acceleration rows, ``online_remask`` (the hard
k-space in memory, remasked each epoch), ``vgg``, ``perceptual`` (the JAX
rows trained these two on the module path, the port's on the kernels; the
table states each side's route), ``residual`` (module path) and
``residual_1200``: the ``residual`` row's run directory resumed to
``--resume-epochs`` and scored into ``residual/eval1200`` (the resumed run
rewrites ``progress_log.*`` from its first epoch on; the residual row's own
log is kept beside it as ``progress_log_to<epochs>.*``). The module-path
rows run last. ``rows.json`` is rewritten after every row and a row in it is
skipped, as in ``cli/results_run``.

``--seed K`` (K > 0) runs the rows as ``<row>@seed<K>``, as
``cli/results_run --seed`` does (``training.seed=K``; a VGG or perceptual
autoencoder pretrained at seed K under ``encoder_vgg_seedK/``, the conv one
shared), each held against its JAX hard row (one seed on the JAX side);
``residual_1200@seed<K>`` resumes ``residual@seed<K>``.

``--render`` writes ``TABLE.md``: each row against its JAX row at the bar of
0.3 dB / 0.01 / 0.01 with each side's SSIM minimum and training route, the
orderings ``RESULTS.md:118-148`` reads on the hard corpus (on the JAX rows
and on the port's), and the zero-filled PSNR of the eval split on both
corpora (``zero_filled.json``, a reading beside ``RESULTS.md:98-100``'s,
not a bar).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from mri_inr_tpu_torch.cli import quality_run as qr
from mri_inr_tpu_torch.cli import results_run as rr
from mri_inr_tpu_torch.data import dataset as ds
from mri_inr_tpu_torch.eval import metrics
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.utils.device import resolve_device

#: the hard corpus (``scripts/r5_hard_table.sh``)
HARD = {"phase": True, "snr_db": 32.0, "texture": 0.18}
JAX_HARD = rr.REPO / "runs" / "results_hard"
#: port row -> the JAX hard row it is held against, in the order a full run
#: takes them: the module path last
PAIRS = {"baseline": "baseline", "train_sin5": "train_sin9", "edge": "edge",
         "morlet": "morlet", "acc_005_8": "acc_005_8", "acc_01_6": "acc_01_6",
         "acc_02_4": "acc_02_4", "online_remask": "online_remask", "vgg": "vgg",
         "perceptual": "perceptual", "residual": "residual", "residual_1200": "residual_1200"}
#: notes where a row's pairing differs from the smooth table's
NOTES = {"baseline": "degree-5 train sines on (the port's default), as the JAX hard "
                     "baseline trained (runs/quality_hard: sin5 true)",
         "train_sin5": "degree-5 train sines off, as the JAX train_sin9 row",
         "residual_1200": "the residual row's run resumed from its last checkpoint"}
#: a resumed row -> the row whose run directory it resumes, and the name of
#: its eval directory under that row's
RESUMED = {"residual_1200": ("residual", "eval1200")}
#: the mask pair the rows train and score on (the config's default)
ZERO_FILLED_MASK = (0.05, 6)


def hard_orderings(rows: dict[str, dict], baseline: str = "baseline") -> list:
    """(what is read, the values, whether it holds) for the orderings
    ``RESULTS.md:118-148`` reads on the hard corpus, over the rows present
    with finite means (a diverged row orders nothing): ``cli/results_run``'s
    edge, acceleration and online reads, then Morlet, perceptual, VGG, the
    degree-5 sines and the residual rows."""
    rows = {k: r for k, r in rows.items()
            if all(np.isfinite(rr._mean(r, m)) for m in ("PSNR", "SSIM"))}
    psnr = {k: rr._mean(r, "PSNR") for k, r in rows.items()}
    ssim = {k: rr._mean(r, "SSIM") for k, r in rows.items()}
    shared = ("edge >= baseline (PSNR)", "acc8/.05 < acc6/.05 < acc6/.10 < acc4/.20 (PSNR)",
              "online remask >= baseline (PSNR)")
    out = [o for o in rr.orderings(rows, baseline) if o[0] in shared]
    if {"morlet", baseline} <= psnr.keys():
        dp, ds_ = psnr["morlet"] - psnr[baseline], ssim["morlet"] - ssim[baseline]
        out.append(("morlet PSNR < baseline, SSIM within 0.01", f"{dp:+.4f} dB, SSIM {ds_:+.4f}",
                    dp < 0 and abs(ds_) <= rr.BARS["SSIM"]))
    others = [k for k in (baseline, "edge", "morlet", "vgg") if k in ssim]
    if "perceptual" in ssim and others:
        out.append(("perceptual has the worst SSIM of the ablations but residual",
                    ", ".join(f"{k} {ssim[k]:.4f}" for k in [*others, "perceptual"]),
                    all(ssim["perceptual"] < ssim[k] for k in others)))
    for row in ("vgg", "train_sin5"):
        if {row, baseline} <= psnr.keys():
            d = psnr[row] - psnr[baseline]
            out.append((f"{row} ~= baseline (PSNR within 0.3 dB)", f"{d:+.4f} dB",
                        abs(d) <= rr.BARS["PSNR"]))
    if {"residual", baseline} <= psnr.keys():
        d = psnr["residual"] - psnr[baseline]
        out.append(("residual more than 3 dB below baseline (PSNR)", f"{d:+.4f} dB", d < -3.0))
    if {"residual", "residual_1200"} <= psnr.keys():
        d = psnr["residual_1200"] - psnr["residual"]
        out.append(("residual_1200 > residual (PSNR)", f"{d:+.4f} dB", d > 0))
    return out


TABLE = rr.Table(
    command="mri_inr_tpu_torch.cli.hard_table",
    heading="# The port's hard-corpus rows against the JAX package's",
    jax_files="`runs/results_hard/rows.json`, for the rows it lacks their "
              "`metrics_summary.txt` under `runs/results_hard` (`online_remask/eval`, "
              "`train_sin9/eval`, `residual/eval1200`) and, for its baseline, "
              "`runs/quality_hard/eval/quality/metrics_summary.txt`",
    rows_json=JAX_HARD / "rows.json",
    baseline=rr.REPO / "runs" / "quality_hard" / "eval" / "quality" / "metrics_summary.txt",
    runs={"online_remask": "online_remask/eval", "train_sin9": "train_sin9/eval",
          "residual_1200": "residual/eval1200"},
    orderings=hard_orderings, orderings_source="RESULTS.md:118-148", pairs=PAIRS,
    ssim_min=True)


def run_resumed(name: str, proto: rr.Protocol, card: str, seed: int = 0) -> dict:
    """Row ``name`` of :data:`RESUMED` at ``seed``: its parent row's run
    directory at that seed (as ``rows.json`` records it) resumed by the
    train CLI to ``--resume-epochs``, then scored into ``<parent>/<eval
    name>``."""
    base_parent, eval_name = RESUMED[name]
    parent = rr.row_key(base_parent, seed)
    args, spec = proto.args, rr.ROWS[base_parent]
    rows_path = proto.root / "rows.json"
    done = ({r["row"]: r for r in json.loads(rows_path.read_text())}
            if rows_path.is_file() else {})
    run_dir = pathlib.Path(done[parent]["run_dir"]) if parent in done else proto.root / parent
    step = ckpt_lib.find_latest_step(run_dir) if run_dir.is_dir() else None
    if parent not in done or step is None:
        raise FileNotFoundError(
            f"row {name} resumes the {parent} row's run directory, and {run_dir} holds no "
            f"checkpoint of it: run the {parent} row under {proto.root} first")
    before = {k: f.launches for k, f in rr.COUNTERS.items()}
    t0 = time.perf_counter()
    meta = proto.splits(spec.splits)
    stages = {"data": time.perf_counter() - t0, "autoencoder": 0.0}
    sets = [*done[parent]["train_overrides"], "training.continue_training=true",
            f"training.model_path={run_dir}"]
    # the resumed run rewrites the progress log from its first epoch on: keep
    # the parent row's beside it
    for log in ("progress_log.csv", "progress_log.txt"):
        kept = run_dir / log.replace("progress_log", f"progress_log_to{args.epochs}")
        if (run_dir / log).is_file() and not kept.exists():
            shutil.copyfile(run_dir / log, kept)
    t0 = time.perf_counter()
    trainer = qr.train_stage(meta, run_dir.parent, parent, args.resume_epochs, proto.dev, *sets)
    del trainer
    stages["train"] = time.perf_counter() - t0
    record = {"row": rr.row_key(name, seed), **({"base_row": name, "seed": seed} if seed else {}),
              "jax_row": PAIRS[name], "note": NOTES[name], "resumes_row": parent,
              "epochs": args.resume_epochs, "resumed_from_epochs": args.epochs,
              "ae_epochs": args.ae_epochs, "corpus": proto.protocol,
              "run_dir": qr.cwd_relative(run_dir),
              "eval_dir": qr.cwd_relative(proto.root / parent / eval_name),
              "train_overrides": sets}
    return rr.score_row(proto, spec, meta, run_dir, proto.root / parent, eval_name, card,
                        stages, before, record, {})


def run_one(name: str, proto: rr.Protocol, card: str, seed: int = 0) -> dict:
    if name in RESUMED:
        return run_resumed(name, proto, card, seed)
    return rr.run_row(name, proto, card, seed, jax_row=PAIRS[name], note=NOTES.get(name))


# ------------------------------------------------------- zero-filled reading
def zero_filled(meta: pathlib.Path) -> dict:
    """Mean, std, min and max of the zero-filled PSNR (the undersampled slice
    of :data:`ZERO_FILLED_MASK` against the fully sampled one, joint data
    range) over the slices of split ``meta``."""
    col = ds.undersample_column(*ZERO_FILLED_MASK)
    rows = ds.read_metadata(meta)
    full = torch.from_numpy(np.stack([np.load(r["path_fullysampled"]) for r in rows]))
    under = torch.from_numpy(np.stack([np.load(r[col]) for r in rows]))
    v = metrics.psnr(full.float(), under.float()).double().numpy()
    return {"slices": len(rows), "mean": float(v.mean()), "std": float(v.std()),
            "min": float(v.min()), "max": float(v.max())}


def zero_filled_readings(root: pathlib.Path, args, device: torch.device) -> dict:
    """The eval split's zero-filled PSNR on the hard corpus (``root``'s own
    split) and on the smooth one (the same volumes preprocessed without the
    hard flags, in a temporary directory)."""
    out = {"mask": list(ZERO_FILLED_MASK),
           "hard": zero_filled(root / "data" / "eval" / "processed" / "metadata.csv")}
    smooth = argparse.Namespace(**{**vars(args), "phase": False, "snr_db": None,
                                   "texture": 0.0})
    with tempfile.TemporaryDirectory() as tmp:
        out["smooth"] = zero_filled(qr.make_split(pathlib.Path(tmp), args.eval_files,
                                                  qr.SPLIT_SEEDS["eval"], smooth, device))
    return out


def zero_filled_lines(readings: dict | None) -> list[str]:
    if readings is None:
        return ["", "## Zero-filled PSNR of the eval split", "",
                "Not measured: `zero_filled.json` is written when `--render` finds the eval "
                "split under this directory."]
    lines = ["", "## Zero-filled PSNR of the eval split (a reading, not a bar)", "",
             f"The undersampled slices of mask (cf, acc) = {tuple(readings['mask'])} against "
             "the fully sampled ones, joint data range; `RESULTS.md:98-100` (the JAX package's "
             "corpora): std 1.50 -> 2.55, floor 21.7 -> 16.9 dB from smooth to hard.", "",
             "| Corpus | Slices | Mean | Std | Min | Max |", "|---|---|---|---|---|---|"]
    for corpus in ("smooth", "hard"):
        r = readings[corpus]
        lines.append(f"| {corpus} | {r['slices']} | {r['mean']:.4f} | {r['std']:.4f} | "
                     f"{r['min']:.4f} | {r['max']:.4f} |")
    return lines


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The command's options, with the corpus of :data:`HARD`."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    qr.add_protocol_args(ap, "runs/results_hard_torch", corpus=False)
    ap.add_argument("--resume-epochs", type=int, default=1200,
                    help="the epochs residual_1200 resumes the residual row's run to")
    ap.add_argument("--rows", default=",".join(PAIRS),
                    help=f"comma-separated rows, run in this order (known: {', '.join(PAIRS)})")
    ap.add_argument("--seed", type=int, default=0,
                    help="run the rows at this seed (> 0: rows <row>@seed<K>)")
    ap.add_argument("--render", action="store_true", help="write TABLE.md under --root")
    args = ap.parse_args(argv)
    vars(args).update(HARD)
    return args


def main(argv: list[str] | None = None) -> dict[str, dict]:
    args = parse_args(argv)
    done, failed, root = rr.run_rows(
        args, [r for r in args.rows.split(",") if r], PAIRS,
        lambda name, proto, card: run_one(name, proto, card, args.seed),
        lambda name: rr.row_key(name, args.seed))
    if args.render:
        readings_path = root / "zero_filled.json"
        split = root / "data" / "eval" / "processed" / "metadata.csv"
        if not readings_path.is_file() and qr.split_ready(split):
            readings = zero_filled_readings(root, args, resolve_device(args.device))
            readings_path.write_text(json.dumps(readings, indent=2) + "\n")
        readings = json.loads(readings_path.read_text()) if readings_path.is_file() else None
        (root / "TABLE.md").write_text(rr.render(list(done.values()), TABLE.jax(), TABLE,
                                                 zero_filled_lines(readings)))
        print(f"wrote {root / 'TABLE.md'}", flush=True)
    if failed:
        raise SystemExit(f"hard_table: rows failed: {', '.join(failed)}")
    return done


if __name__ == "__main__":
    main()
