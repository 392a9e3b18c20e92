#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``mri_inr_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. It imports nothing of JAX. Phases:

1. the card's name and power limit, torch and CUDA versions; TF32 off for
   matmuls and cuDNN so every comparison below is in full f32;
2. build every CUDA kernel from ``mri_inr_tpu_torch/ops/csrc`` (one nvcc
   per source, started together), with registers and spills per kernel;
3. each kernel against its plain PyTorch version at full width (H=256, L=5,
   S=576), seeded weights: the eval forward at B=1024 (one 320x320 slice's
   patch bucket), the train forward and backward at B=400 (one train batch)
   with dropout 0.1;
4. the eval path end to end through the user entry points: 16 phantom
   slices (320x320, .npy + metadata.csv), the model from configs/test.yaml
   with seeded init, MRISampler -> SliceReconstructor on one slice, then
   evaluate_files_device on all 16 and write_metrics_artifacts; the kernel
   launch counts are reset just before and read just after; two slices are
   scored again on the CPU through the plain versions and must agree;
5. the training path through the train CLI's ``main``: configs/train.yaml
   (only paths, epochs, save_interval and device_data overridden) on the 16
   slices (6,400 patches, 16 steps of batch 400 an epoch) with 4 more as
   validation set: initial errors, two epochs, final checkpoint, then a
   resumed third epoch; launch counts reset just before, read just after;
   then, uncounted, the same command resumed for five more epochs, whose
   ``epoch_seconds`` in ``progress_log.csv`` give the steady epoch rate;
6. times with CUDA events (warm-up, then the median): every kernel and its
   plain version per call, the steady sweep rate, and one whole train step
   (fused, with its host enqueue time and its device time by kernel, and on
   the module path under autograd for comparison).

Prints one JSON line of kernel records, then as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is non-zero and that last line is not printed. Without a CUDA device, or
without the package beside this file, it exits 1 before doing anything.
"""

from __future__ import annotations

import copy
import csv
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
SEED = 0
REPS = 20
SLICE_SIZE = 320
VOLUMES, SLICES_PER_VOLUME = 2, 8
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- phase 2
def build_kernels(build_mod, names: list[str]) -> None:
    if build_mod.BUILD_DIR.is_dir():  # build from the checkout's sources, never a leftover
        for lib in build_mod.BUILD_DIR.glob("lib*.so"):
            lib.unlink()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        outs = list(pool.map(lambda n: build_mod.build(n)[1], names))
    print(f"build: {len(names)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    logs = dict(zip(names, outs))
    for name, log in logs.items():
        entry, spill = "", ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                print(f"  ptxas {name} {entry[-32:]}: {line.split(':', 1)[1].strip()}; "
                      f"{spill}")


# ---------------------------------------------------------------- phase 3
def kernel_inputs(sk, ms, activation: str, device, batch: int = 1024):
    """Full-width seeded model -> (mods with modproj folded, kernel params)."""
    g = torch.Generator().manual_seed(SEED)
    model = ms.ModulatedSiren(dim_hidden=256, latent_dim=256, num_layers=5,
                              activation=activation, generator=g, device=device).eval()
    tiles = torch.rand((batch, 32, 32), generator=g).to(device)
    with torch.no_grad():
        kp = sk.extract_kernel_params(model, ms.coordinate_grid(24, device))
        mods = sk.compute_modulations(kp, model.encode(tiles), num_layers=5)
        cut = 4 * 256
        mods = torch.cat([mods[:, :cut], mods[:, cut:] * kp.last_w], 1).contiguous()
    return mods, kp


def compare_kernel(sk, ms, device) -> dict:
    # Bars: same bf16 inputs, f32 sums in another order, so a pre-activation
    # can round to the neighbouring bf16 value; measured on an H100 max
    # 5.7e-6 / mean 1.5e-9 (sin_bf16: 4.5e-5 / 7e-9), bars >= 17x above.
    cases = [
        ("sine, hidden deg 5 / out deg 7 (eval default)", "sine",
         dict(sin7=True, sin5=True), 1e-4, 1e-6),
        ("sine, degree 9", "sine", dict(), 1e-4, 1e-6),
        ("morlet, hidden deg 5 / out deg 7", "morlet", dict(sin7=True, sin5=True), 1e-4, 1e-6),
        ("sine, sin_bf16", "sine", dict(sin_bf16=True), 1e-3, 1e-5),
    ]
    inputs = {}
    errs = {}
    for label, activation, knobs, tol_max, tol_mean in cases:
        if activation not in inputs:
            inputs[activation] = kernel_inputs(sk, ms, activation, device)
        mods, kp = inputs[activation]
        args = (mods, kp.base, kp.s_w, kp.s_b, kp.last_b)
        kw = dict(num_layers=5, activation=activation, **knobs)
        got = sk.siren_forward_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = sk.siren_forward_reference(*args, **kw)
        check(got.shape == want.shape == (1024, 576), f"{label}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output")
        err = (got - want).abs()
        mx, mean = err.max().item(), err.mean().item()
        print(f"kernel vs plain [{label}]: max |diff| {mx:.3e} (<= {tol_max:g}), "
              f"mean {mean:.3e} (<= {tol_mean:g})")
        check(mx <= tol_max and mean <= tol_mean, f"{label}: kernel disagrees")
        errs[label] = mx
    return {"inputs": inputs["sine"], "max_abs_err": errs[cases[0][0]]}


# ---------------------------------------------------------------- phase 4
def write_dataset(root: pathlib.Path, undersample_column, phantom_volume,
                  volumes: int = VOLUMES, slices: int = SLICES_PER_VOLUME,
                  first_volume: int = 0) -> pathlib.Path:
    """Phantom slices + undersampled copies (centred FFT, column mask with
    centre fraction 0.05 and acceleration 6) + metadata.csv."""
    root.mkdir(parents=True, exist_ok=True)
    col = undersample_column(0.05, 6)
    rng = np.random.default_rng(SEED + first_volume)
    size = SLICE_SIZE
    rows = []
    for v in range(first_volume, first_volume + volumes):
        stem = f"file_brain_AXFLAIR_{v:06d}"
        vol = phantom_volume(v, num_slices=slices, height=size, width=size,
                             texture=0.2)
        for s, img in enumerate(vol):
            low = int(round(size * 0.05))
            mask = rng.uniform(size=size) < (size / 6 - low) / (size - low)
            start = (size - low + 1) // 2
            mask[start : start + low] = True
            k = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(img), norm="ortho"))
            under = np.abs(np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(k * mask),
                                                        norm="ortho")))
            sid = f"{stem}_{s}"
            full_p, under_p = root / f"{sid}_full.npy", root / f"{sid}_under.npy"
            np.save(full_p, img)
            np.save(under_p, (under / under.max()).astype(np.float32))
            rows.append({"path_fullysampled": str(full_p), "stem": stem,
                         "slice_id": sid, "slice_num": s, "width": size,
                         "height": size, "mri_type": "Flair", "mri_area": "Brain",
                         col: str(under_p)})
    meta = root / "metadata.csv"
    with open(meta, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return meta


def end_to_end(pkg, tmp: pathlib.Path, device) -> dict:
    cfg = pkg["config"].load_test_configuration(REPO / "configs" / "test.yaml")
    mcfg, ecfg = cfg.model, cfg.data
    meta = write_dataset(tmp, pkg["dataset"].undersample_column,
                         pkg["synthetic"].phantom_volume)
    model = pkg["ms"].from_config(mcfg, generator=torch.Generator().manual_seed(SEED),
                                  device=device)
    print(f"model from configs/test.yaml: H={mcfg.dim_hidden} latent={mcfg.latent_dim} "
          f"L={mcfg.num_layers} encoder={mcfg.encoder_type} activation={mcfg.activation} "
          f"bucket={ecfg.batch_patches} sin5={ecfg.sin5} sin_bf16={ecfg.sin_bf16}")

    def pipeline(m, dev):
        apply_fn = pkg["sk"].make_apply_fn(
            m, use_pallas=mcfg.use_pallas, sin_bf16=ecfg.sin_bf16, sin5=ecfg.sin5,
            ksplit=ecfg.ksplit, quantized=ecfg.quantized, device=dev)
        return pkg["ev"].SliceReconstructor(
            apply_fn, outer_patch_size=mcfg.outer_patch_size,
            inner_patch_size=mcfg.inner_patch_size,
            siren_patch_size=mcfg.siren_patch_size,
            patch_bucket=ecfg.batch_patches, device=dev)

    def sampler(**kw):
        return pkg["dataset"].MRISampler(
            meta, center_fraction=ecfg.center_fraction, acceleration=ecfg.acceleration,
            mri_type=ecfg.mri_type, max_slice_num=ecfg.max_slice_num, **kw)

    recon = pipeline(model, device)
    kernel = pkg["sk"].siren_forward_cuda

    # ---- the main path, counted
    kernel.launches = 0
    pair = sampler().next_sample()
    r, f, u, m = recon(pair.fully_sampled, pair.undersampled)
    results, timings = pkg["ev"].evaluate_files_device(recon, sampler())
    torch.cuda.synchronize()
    launches = kernel.launches
    print(f"main path: 1 visual slice + {len(results)}-slice device sweep -> "
          f"siren_forward launches {launches}")
    check(launches == 1 + len(results), f"expected {1 + len(results)} kernel launches")

    check(tuple(r.shape) == tuple(f.shape) == tuple(u.shape) == (SLICE_SIZE,) * 2,
          f"recon shape {tuple(r.shape)}")
    check(bool(torch.isfinite(r).all()), "non-finite reconstruction")
    check(r.device.type == "cuda", "reconstruction not on the card")
    check(all(np.isfinite(v.item()) for v in m.values()), "non-finite metrics")
    total = VOLUMES * SLICES_PER_VOLUME
    check(len(results) == total, f"{len(results)} sweep rows, expected {total}")
    check(all(np.isfinite([x.psnr, x.ssim, x.nrmse]).all() for x in results),
          "non-finite sweep metrics")
    summary = pkg["ev"].write_metrics_artifacts(results, tmp / "eval")
    with open(tmp / "eval" / "metrics_error.csv") as fh:
        check(len(fh.read().splitlines()) == total + 1, "metrics_error.csv rows")
    print("sweep summary: " + " ".join(
        f"{k} {v['mean']:.4f}+-{v['std']:.4f}" for k, v in summary.items()))
    print("sweep timings (first run): " + " ".join(
        f"{k}={v:.4f}" for k, v in timings.items()))

    # ---- CPU cross-check through the plain versions
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_rows = pkg["ev"].evaluate_files(pipeline(cpu_model, "cpu"), sampler(num_samples=2),
                                        progress_every=0)
    by_id = {x.slice_id: x for x in results}
    for c in cpu_rows:
        g = by_id[c.slice_id]
        dp, ds, dn = abs(g.psnr - c.psnr), abs(g.ssim - c.ssim), abs(g.nrmse - c.nrmse)
        print(f"cpu vs card [{c.slice_id}]: PSNR {c.psnr:.4f} vs {g.psnr:.4f} "
              f"(|d| {dp:.2e} <= 0.05), SSIM |d| {ds:.2e}, NRMSE |d| {dn:.2e} (<= 1e-3)")
        check(dp <= 0.05 and ds <= 1e-3 and dn <= 1e-3, "CPU cross-check")

    def sweep():
        return pkg["ev"].evaluate_files_device(recon, sampler(), log=lambda *_: None)[1]

    sweep()
    steady = [sweep() for _ in range(REPS)]
    med = {k: statistics.median(t[k] for t in steady) for k in steady[0]}
    print("sweep timings (steady, median of {}): ".format(REPS) + " ".join(
        f"{k}={v:.4f}" for k, v in med.items()))
    rates = [total / (t["dispatch_seconds"] + t["execute_fetch_seconds"]) for t in steady]
    return {"launches": launches, "slices_per_sec": statistics.median(rates)}


# ------------------------------------------------- phase 3, train kernels
TRAIN_BATCH = 400
STEADY_EPOCHS = 5
TRAIN_CASES = [
    # label, activation, sin5
    ("sine, sin5 (training default)", "sine", True),
    ("sine, degree 9", "sine", False),
    ("morlet, sin5", "morlet", True),
]
# Bars for |kernel - plain| <= bar * max(|plain|, 1): sums over up to B*S =
# 230,400 rows in another order (atomics for the weight-space gradients) on
# top of rare bf16 rounding flips. The first run on an H100 held 2e-3 for
# all six and showed 3.4e-8 (dmods), 6.5e-10 (dbase), 6.6e-8 (dsw), 7.6e-8
# (dsb), 1.1e-6 (dlw), 6.9e-7 (dlb); the bars are about ten times that. The
# seeded cotangent is scaled like an MSE gradient, so the gradients are far
# below 1 and a second bar holds the gap relative to max |plain| itself
# (dbase, a cancelling sum over patches, showed 8e-4).
BWD_BARS = {"dmods": 5e-7, "dbase": 1e-8, "dsw": 1e-6, "dsb": 1e-6, "dlw": 1e-5,
            "dlb": 1e-5}
BWD_REL_BAR = 1e-2


def train_kernel_inputs(sk, ms, activation: str, device):
    """Full-width seeded model and one train batch -> the chain op's inputs
    (seed, mods, base, s_w, s_b, last_w, last_b) and a seeded cotangent."""
    g = torch.Generator().manual_seed(SEED + 1)
    model = ms.ModulatedSiren(dim_hidden=256, latent_dim=256, num_layers=5, dropout=0.1,
                              activation=activation, generator=g, device=device)
    tiles = torch.rand((TRAIN_BATCH, 32, 32), generator=g).to(device)
    cot = (torch.randn((TRAIN_BATCH, 576), generator=g) / 576).to(device)
    with torch.no_grad():
        kp = sk.extract_kernel_params(model, ms.coordinate_grid(24, device))
        mods = sk.compute_modulations(kp, model.encode(tiles), num_layers=5).contiguous()
    seed = torch.tensor([float(SEED + 1234)], device=device)
    return (seed, mods, kp.base, kp.s_w, kp.s_b, kp.last_w, kp.last_b), cot


def compare_train_kernels(sk, stk, ms, device) -> dict:
    inputs, first = {}, {}
    for label, activation, sin5 in TRAIN_CASES:
        if activation not in inputs:
            inputs[activation] = train_kernel_inputs(sk, ms, activation, device)
        args, cot = inputs[activation]
        kw = dict(num_layers=5, activation=activation, dropout_rate=0.1, sin5=sin5)
        got = stk.siren_chain_train_fwd_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = stk.siren_chain_train_fwd_reference(*args, **kw)
        check(got.shape == want.shape == (TRAIN_BATCH, 576), f"{label}: fwd shape")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite train forward")
        err = (got - want).abs()
        mx, mean = err.max().item(), err.mean().item()
        print(f"train fwd kernel vs plain [{label}]: max |diff| {mx:.3e} (<= 1e-4), "
              f"mean {mean:.3e} (<= 1e-6)")
        check(mx <= 1e-4 and mean <= 1e-6, f"{label}: train forward kernel disagrees")

        got_b = stk.siren_chain_train_bwd_cuda(*args, cot, **kw)
        torch.cuda.synchronize()
        want_b = stk.siren_chain_train_bwd_reference(*args, cot, **kw)
        worst = 0.0
        for name, a, b in zip(BWD_BARS, got_b, want_b):
            check(a.shape == b.shape, f"{label}: {name} shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite {name}")
            gap, top = (a - b).abs().max().item(), b.abs().max().item()
            worst = max(worst, gap)
            print(f"train bwd kernel vs plain [{label}] {name}: max |diff| {gap:.3e} "
                  f"(<= {BWD_BARS[name]:g} * max(|plain|, 1)), max |plain| {top:.3e}, "
                  f"relative {gap / top:.2e} (<= {BWD_REL_BAR:g})")
            check(gap <= BWD_BARS[name] * max(top, 1.0) and gap <= BWD_REL_BAR * top,
                  f"{label}: {name} disagrees")
        if not first:
            again = stk.siren_chain_train_bwd_cuda(*args, cot, **kw)
            same = [bool(torch.equal(x, y)) for x, y in zip(got_b, again)]
            print("train bwd, two runs bit for bit: " + " ".join(
                f"{n}={'same' if v else 'differs'}" for n, v in zip(BWD_BARS, same)))
            first = {"fwd_err": mx, "bwd_err": worst}
    return {"inputs": inputs["sine"], **first}


# ---------------------------------------------------------------- phase 5
def train_path(pkg, tmp: pathlib.Path, device) -> dict:
    """The training main path through the train CLI's ``main``."""
    stk, sk, cli = pkg["stk"], pkg["sk"], pkg["cli_train"]
    train_meta = tmp / "metadata.csv"  # the 16 slices of the eval phase
    val_meta = write_dataset(tmp / "val", pkg["dataset"].undersample_column,
                             pkg["synthetic"].phantom_volume, volumes=1, slices=4,
                             first_volume=100)
    argv = ["--config", str(REPO / "configs" / "train.yaml"),
            "--set", f"data.train.dataset={train_meta}",
            "--set", f"data.val.dataset={val_meta}",
            "--set", f"training.output_dir={tmp / 'train_out'}",
            "--set", "training.save_interval=1000",
            "--set", "training.device_data=true"]
    kernels = (stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda,
               sk.siren_forward_cuda)
    for k in kernels:
        k.launches = 0
    trainer = cli.main(argv + ["--set", "training.epochs=2"])
    steps = trainer.state.step
    resumed = cli.main(argv + ["--set", "training.epochs=3",
                               "--set", "training.continue_training=true"])
    torch.cuda.synchronize()
    fwd_n, bwd_n, eval_n = (k.launches for k in kernels)

    per_epoch = -(-len(trainer.train_dataset) // trainer.batch_size)
    val_batches = -(-len(trainer.val_dataset) // trainer.batch_size)
    print(f"train path: {len(trainer.train_dataset)} train patches, "
          f"{len(trainer.val_dataset)} val patches, {per_epoch} steps an epoch; "
          f"2 epochs + 1 resumed -> train fwd launches {fwd_n}, train bwd launches "
          f"{bwd_n}, eval forward launches {eval_n}")
    check(per_epoch == 16 and steps == 32, f"expected 32 steps, got {steps}")
    check(resumed.state.step == 48, f"resumed run ended at step {resumed.state.step}")
    check(resumed.run_dir == trainer.run_dir, "the resumed run picked another run dir")
    check(fwd_n == 48 and bwd_n == 48, "train kernel launches != train steps")
    # validation: initial errors (train + val sets) of both runs, val per epoch
    check(eval_n == 2 * (per_epoch + val_batches) + 3 * val_batches,
          f"eval forward launches {eval_n}")
    logs = trainer._progress + resumed._progress
    check([r["epoch"] for r in logs] == [0, 1, 2], f"epochs {[r['epoch'] for r in logs]}")
    vals = [*trainer.initial_losses, *resumed.initial_losses,
            *(r[k] for r in logs for k in ("train_loss", "val_loss"))]
    check(bool(np.isfinite(vals).all()), f"non-finite loss in {vals}")
    print("losses: initial train {:.6f} val {:.6f}; ".format(*trainer.initial_losses)
          + "; ".join(f"epoch {r['epoch']} train {r['train_loss']:.6f} val "
                      f"{r['val_loss']:.6f}" for r in logs))
    check(logs[1]["train_loss"] < trainer.initial_losses[0],
          "train loss after epoch 1 is not below the initial train loss")
    check(all(p.is_cuda for p in resumed.model.parameters()), "parameters not on the card")
    run = trainer.run_dir
    for name in ("config.yaml", "processed_files.txt", "progress_log.csv",
                 "progress_log.txt"):
        check((run / name).is_file(), f"{name} missing")
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    check(ckpts == ["step_00000032", "step_00000048"], f"checkpoints {ckpts}")
    with open(run / "progress_log.csv") as fh:
        check(len(fh.read().splitlines()) == 2, "progress_log.csv of the resumed run")

    # steady epochs, after the counts were read: the same command resumed for
    # STEADY_EPOCHS more; an epoch's seconds (its 16 train steps and its 4
    # validation batches) are the trainer's own, read from progress_log.csv
    cli.main(argv + ["--set", f"training.epochs={3 + STEADY_EPOCHS}",
                     "--set", "training.continue_training=true"])
    with open(run / "progress_log.csv") as fh:
        secs = [float(r["epoch_seconds"]) for r in csv.DictReader(fh)]
    check(len(secs) == STEADY_EPOCHS, f"{len(secs)} steady epochs logged")
    return {"fwd": fwd_n, "bwd": bwd_n, "eval": eval_n, "epoch_seconds": secs,
            "steps_per_epoch": per_epoch, "val_batches": val_batches}


def time_train_steps(pkg, device) -> dict:
    """One whole train step at the width and batch of configs/train.yaml:
    fused kernels, and the module path under autograd for comparison."""
    cfg = pkg["config"].load_train_configuration(REPO / "configs" / "train.yaml")
    g = torch.Generator().manual_seed(SEED)
    fully = torch.rand((cfg.training.batch_size, 32, 32), generator=g).to(device)
    under = torch.rand((cfg.training.batch_size, 32, 32), generator=g).to(device)
    out = {}
    for label, fused in (("fused", True), ("module", False)):
        model = pkg["ms"].from_config(cfg.model, cfg.training.precision,
                                      generator=torch.Generator().manual_seed(SEED),
                                      device=device)
        tr = pkg["trainer"]
        state = tr.create_train_state(model, cfg.training.optimizer, cfg.training.lr)
        step = tr.make_train_step(model, pkg["losses"].mse, 32, 24, use_pallas=fused,
                                  sin5=cfg.training.sin5)
        out[label] = cuda_median_ms(lambda: step(state, fully, under, 1), reps=10)
        if fused:
            out["host_enqueue"] = host_enqueue_ms(lambda: step(state, fully, under, 1))
            out["profile"] = profile_device(lambda: step(state, fully, under, 1))
    return out


def host_enqueue_ms(fn, reps: int = 10) -> float:
    """Host time to enqueue one call (no wait for the device inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def profile_device(fn, reps: int = 5) -> dict | None:
    """Device time by kernel over ``reps`` calls, from torch.profiler: (wall
    ms per call, device-busy ms per call, [(kernel name, ms per call)]), or
    None where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    # device rows only, and no annotated range (Optimizer.step#...), whose
    # time is its kernels' over again
    rows = [(e.key, e.device_time_total / 1e3 / reps) for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower() and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall, "busy_ms": sum(ms for _, ms in rows), "kernels": rows}


def kernel_record(name, replaces, launches, err, ms, plain_ms, flops, nbytes,
                  card, executed_flops=None, **extra) -> dict:
    """``flops``: the operations the function needs on these inputs (the
    bound's); ``executed_flops``: those the kernel runs, where recomputation
    makes them more."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    rate = f"{flops / ms / 1e9:.1f} TFLOP/s of needed work"
    if executed_flops is not None:
        rate += f", {executed_flops / ms / 1e9:.1f} TFLOP/s of the {executed_flops:.3e} executed"
    print(f"{name} kernel: {ms:.4f} ms/call ({rate}), plain version "
          f"{plain_ms:.4f} ms/call; bound {flops:.3e} bf16 FLOP -> {ops_ms:.4f} ms, "
          f"{nbytes} B -> {bytes_ms:.4f} ms; kernel at {bound_ms / ms:.1%} of bound [{card}]")
    return {"name": name, "route": "cuda",
            "source": f"mri_inr_tpu_torch/ops/csrc/{name}.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, **extra}


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if not (REPO / "mri_inr_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the mri_inr_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mri_inr_tpu_torch.cli import train as cli_train
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.data import dataset, synthetic
    from mri_inr_tpu_torch.eval import evaluate as ev
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.ops import _build
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.train import losses, trainer

    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: comparisons run in full f32")

    build_kernels(_build, ["siren_forward", "siren_train_fwd", "siren_train_bwd"])
    cmp = compare_kernel(sk, ms, device)
    cmp_train = compare_train_kernels(sk, stk, ms, device)

    pkg = dict(config=config, dataset=dataset, synthetic=synthetic, ev=ev, ms=ms, sk=sk,
               stk=stk, cli_train=cli_train, losses=losses, trainer=trainer)
    with tempfile.TemporaryDirectory() as tmp:
        e2e = end_to_end(pkg, pathlib.Path(tmp), device)
        trn = train_path(pkg, pathlib.Path(tmp), device)
    step_ms = time_train_steps(pkg, device)

    # ---- eval forward kernel
    mods, kp = cmp["inputs"]
    args = (mods, kp.base, kp.s_w, kp.s_b, kp.last_b)
    kw = dict(num_layers=5, sin7=True, sin5=True)
    batch, seq, hidden, layers = mods.shape[0], kp.base.shape[0], kp.base.shape[1], 5
    records = [kernel_record(
        "siren_forward", "mri_inr_tpu/ops/siren_kernel.py:156", e2e["launches"],
        cmp["max_abs_err"],
        cuda_median_ms(lambda: sk.siren_forward_cuda(*args, **kw)),
        cuda_median_ms(lambda: sk.siren_forward_reference(*args, **kw)),
        2 * batch * seq * hidden * hidden * (layers - 1),
        nbytes_of(*args) + batch * seq * 4, card, launches_train_path=trn["eval"])]
    print(f"evaluate_files_device steady: {e2e['slices_per_sec']:.2f} slices/s "
          f"({VOLUMES * SLICES_PER_VOLUME} slices, bucket 1024, median of {REPS}) [{card}]")

    # ---- train kernels, B=400, dropout 0.1, sin5 (the training default)
    targs, cot = cmp_train["inputs"]
    tkw = dict(num_layers=5, dropout_rate=0.1, sin5=True)
    chain = TRAIN_BATCH * seq * hidden * hidden * (layers - 1)
    records.append(kernel_record(
        "siren_train_fwd", "mri_inr_tpu/ops/siren_train_kernel.py:140", trn["fwd"],
        cmp_train["fwd_err"],
        cuda_median_ms(lambda: stk.siren_chain_train_fwd_cuda(*targs, **tkw)),
        cuda_median_ms(lambda: stk.siren_chain_train_fwd_reference(*targs, **tkw), reps=5,
                       warmup=1),
        2 * chain, nbytes_of(*targs) + TRAIN_BATCH * seq * 4, card))
    grads = stk.siren_chain_train_bwd_cuda(*targs, cot, **tkw)
    # the gradient needs the forward's product, dW and dx per hidden layer:
    # 6 * chain; the kernel recomputes, 4(L-1) - 1 products in all
    records.append(kernel_record(
        "siren_train_bwd", "mri_inr_tpu/ops/siren_train_kernel.py:199", trn["bwd"],
        cmp_train["bwd_err"],
        cuda_median_ms(lambda: stk.siren_chain_train_bwd_cuda(*targs, cot, **tkw)),
        cuda_median_ms(lambda: stk.siren_chain_train_bwd_reference(*targs, cot, **tkw),
                       reps=5, warmup=1),
        6 * chain, nbytes_of(*targs, cot, *grads), card,
        executed_flops=2 * chain * (4 * (layers - 1) - 1) // (layers - 1)))
    print(f"train step, batch {TRAIN_BATCH}, configs/train.yaml (bf16, Adam): fused "
          f"{step_ms['fused']:.4f} ms, module path under autograd {step_ms['module']:.4f} ms "
          f"(median of 10) [{card}]")
    prof = step_ms["profile"]
    print(f"fused train step: host enqueues it in {step_ms['host_enqueue']:.4f} ms [{card}]")
    if prof is None:
        print("fused train step, device time by kernel: not measured (the profiler "
              "recorded no device activity)")
    else:
        print(f"fused train step under the profiler: wall {prof['wall_ms']:.4f} ms, device "
              f"busy {prof['busy_ms']:.4f} ms (idle share "
              f"{max(0.0, 1 - prof['busy_ms'] / prof['wall_ms']):.1%}) [{card}]")
        for name, ms_ in prof["kernels"][:12]:
            print(f"  {ms_:8.4f} ms  {name[:100]}")
        rest = sum(ms_ for _, ms_ in prof["kernels"][12:])
        print(f"  {rest:8.4f} ms  ({len(prof['kernels']) - 12} more kernels)")
        groups = {"backward kernel": "siren_train_bwd", "forward kernel": "siren_train_fwd",
                  "Adam (multi_tensor_apply kernels)": "multi_tensor_apply"}
        share = {g: sum(ms_ for n, ms_ in prof["kernels"] if key in n)
                 for g, key in groups.items()}
        share["encoder, modulator, repack, loss under autograd (all other kernels)"] = (
            prof["busy_ms"] - sum(share.values()))
        print("fused train step, device time: " + "; ".join(
            f"{g} {ms_:.4f} ms" for g, ms_ in share.items()) + f" [{card}]")
    secs = trn["epoch_seconds"]
    med, n = statistics.median(secs), trn["steps_per_epoch"]
    print(f"steady train epochs through the CLI (device_data, {n} steps of batch "
          f"{TRAIN_BATCH} and {trn['val_batches']} validation batches an epoch, "
          f"{len(secs)} epochs): median {med:.4f} s an epoch (min {min(secs):.4f}, max "
          f"{max(secs):.4f}) = {n / med:.2f} steps/s (min {n / max(secs):.2f}, max "
          f"{n / min(secs):.2f}), {n * TRAIN_BATCH / med:.1f} patches/s [{card}]")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
