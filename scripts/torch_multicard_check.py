#!/usr/bin/env python3
"""Data parallelism with one card a rank, where NCCL carries the collectives:

    python3 scripts/torch_multicard_check.py

on a machine with two or more NVIDIA cards; every visible card is a rank.
The ranks run the scenarios of ``tests/torch_port_ranks.py``, started
through the ``MRI_INR_*`` route, each on ``cuda:LOCAL_RANK``, and are held
against one process on cuda:0 (TF32 off on both sides):

- NCCL is chosen; after every step case the ranks hold one model, and each
  counts its own train-kernel launches;
- a dropout step with SGD equals the mean of the ranks' local steps
  emulated in one process (1e-6); with Adam the gap is printed only (an
  element whose mean gradient is rounding noise moves by about ``lr``
  either way, and NCCL sums the ranks in an order of its own);
- SGD steps without dropout equal the one-process steps (loss 1e-4
  relative, parameters 1e-5: the JAX package's bars);
- the validation loss is one value on every rank;
- the halo fold over the cards equals the one-card fold, and a halo-mode
  reconstructor's slice the one-card slice (1e-6), one eval-kernel launch a
  rank;
- the train CLI through ``torchrun --standalone`` at configs/train.yaml's
  width on phantom volumes preprocessed here: NCCL, one run directory,
  every rank to the last step; the steps/s of its epochs are printed.

Prints the card's name and power limit; exits 1 if a check fails.
"""

from __future__ import annotations

import csv
import os
import pathlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import torch_port_ranks as ranks  # noqa: E402
from mri_inr_tpu_torch.data import preprocessing, synthetic  # noqa: E402
from mri_inr_tpu_torch.eval.evaluate import SliceReconstructor  # noqa: E402
from mri_inr_tpu_torch.ops import _build, tiling  # noqa: E402
from mri_inr_tpu_torch.ops import siren_kernel as sk  # noqa: E402
from mri_inr_tpu_torch.train import losses, trainer  # noqa: E402

FAILED: list[str] = []


def check(cond: bool, msg: str) -> None:
    print(("ok    " if cond else "FAIL  ") + msg)
    if not cond:
        FAILED.append(msg)


def steps(world: int, card, tmp: pathlib.Path) -> None:
    out = tmp / "steps"
    out.mkdir()
    logs = ranks.launch([str(REPO / "tests" / "torch_port_ranks.py"), "steps", str(out), "cuda"],
                        world, tmp / "steps_ranks", timeout=600)
    check("collectives over nccl" in logs[0], "NCCL carries the collectives")
    got = [dict(np.load(out / f"steps_rank{r}.npz")) for r in range(world)]
    for case, (_, fused, _, _, n) in ranks.STEP_CASES.items():
        check(all(np.array_equal(g[f"{case}_params"], got[0][f"{case}_params"]) for g in got),
              f"{case}: {world} ranks hold one model")
        counts = [[int(c) for c in g[f"{case}_launches"]] for g in got]
        check(counts == [[n, n] if fused else [0, 0]] * world,
              f"{case}: train fwd/bwd launches a rank {counts}")
    for case in ("dropout_sgd1", "dropout1"):
        want, _ = ranks.emulate_step(case, card, world)
        err = float(np.abs(got[0][f"{case}_params"] - want).max())
        if case == "dropout_sgd1":
            check(err <= 1e-6, f"{case}: the mean of {world} local steps, max |diff| {err:.3e}")
        else:
            print(f"      {case} (Adam): the mean of {world} local steps, max |diff| {err:.3e}, "
                  f"{int((np.abs(got[0][f'{case}_params'] - want) > 1e-6).sum())} elements "
                  "past 1e-6 (not held)")
    fully, under = (torch.from_numpy(a).to(card) for a in ranks.global_batch())
    for case in ("sgd3", "sgd1", "module2"):
        dropout, fused, opt, lr, n = ranks.STEP_CASES[case]
        model = ranks.small_model(dropout, card)
        state = trainer.create_train_state(model, opt, lr)
        step = trainer.make_train_step(model, losses.mse, 32, 24, use_pallas=fused,
                                       sin5=case != "sgd1")
        want = np.array([float(step(state, fully, under, ranks.BASE_SEED)) for _ in range(n)])
        rel = float(np.max(np.abs(got[0][f"{case}_loss"] - want) / want))
        err = float(np.abs(got[0][f"{case}_params"] - ranks.flat_params(model)).max())
        check(rel <= 1e-4 and err <= 1e-5,
              f"{case} against one process: loss relative {rel:.3e}, parameters {err:.3e}")
    check(len({float(g["eval_loss"]) for g in got}) == 1, "one validation loss on every rank")


def halo(world: int, card, tmp: pathlib.Path) -> None:
    out = tmp / "halo"
    out.mkdir()
    ranks.launch([str(REPO / "tests" / "torch_port_ranks.py"), "halo", str(out), "cuda"], world,
                 tmp / "halo_ranks", timeout=600)
    got = [dict(np.load(out / f"halo_rank{r}.npz")) for r in range(world)]
    for nv, nh in ranks.HALO_CASES:
        if nv % world:
            continue
        patches = torch.from_numpy(ranks.halo_patches(nv, nh)).to(card)
        want = tiling.patches_to_image_weighted_average(patches, (nv, nh), ranks.SIREN,
                                                        ranks.INNER).cpu().numpy()
        err = max(float(np.abs(g[f"image_{nv}x{nh}"] - want).max()) for g in got)
        check(err <= 1e-6, f"halo fold {nv}x{nh} over {world} cards: max |diff| {err:.3e}")
    model = ranks.small_model(0.0, card)
    rec = SliceReconstructor(sk.make_apply_fn(model, use_pallas=True, sin5=True, device=card),
                             patch_bucket=16, device=card)
    fully, under = np.random.default_rng(7).uniform(size=(2, 128, 80)).astype(np.float32)
    recon = rec(fully, under)[0].cpu().numpy()
    err = max(float(np.abs(g["slice_recon"] - recon).max()) for g in got)
    launches = [int(g["slice_launches"]) for g in got]
    check(err <= 1e-6 and launches == [1] * world,
          f"halo reconstructor: max |diff| {err:.3e}, eval-kernel launches {launches}")


def torchrun_train(world: int, card, tmp: pathlib.Path, label: str) -> None:
    rows = []
    for v in range(2):
        rows += preprocessing.process_kspace_volume(
            synthetic.synthetic_kspace(v, 8, 320, 320, texture=0.2), synthetic.synthetic_stem(v),
            tmp / "data", device=card)
    meta = preprocessing.write_metadata(rows, tmp / "data")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MRI_INR_")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(world), "-m", "mri_inr_tpu_torch.cli.train", "--config", "configs/train.yaml",
         "--set", f"data.train.dataset={meta}", "--set", f"data.val.dataset={meta}",
         "--set", "training.epochs=3", "--set", f"training.output_dir={tmp / 'train'}",
         "--set", "training.device_data=true", "--set", f"training.data_axis_size={world}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    ok = proc.returncode == 0
    check(ok and "collectives over nccl" in proc.stdout
          and proc.stdout.count("done; final step 48") == world,
          f"torchrun train CLI over {world} cards (exit {proc.returncode})")
    if not ok:
        print(proc.stderr[-4000:])
        return
    (run,) = (tmp / "train").iterdir()
    with open(run / "progress_log.csv", newline="") as f:
        secs = [float(r["epoch_seconds"]) for r in csv.DictReader(f)]
    print(f"      train CLI over {world} cards, 16 global steps of 400 an epoch (a local "
          f"batch of {400 // world}), eager step by step: "
          + ", ".join(f"{16 / s:.2f}" for s in secs) + f" steps/s by epoch [{label}]")


def main() -> int:
    world = torch.cuda.device_count()
    if world < 2:
        print("torch_multicard_check: needs two or more cards", file=sys.stderr)
        return 1
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(label)
    label = label.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(4) as pool:  # built once, before the ranks load them
        list(pool.map(_build.build, ["siren_forward", "siren_train_fwd", "siren_train_bwd",
                                     "dft2c"]))
    card = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        steps(world, card, tmp)
        halo(world, card, tmp)
        torchrun_train(world, card, tmp, label)
    print(f"{len(FAILED)} check(s) failed" if FAILED else f"all checks passed on {world} cards")
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
