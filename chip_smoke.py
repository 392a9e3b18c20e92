#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``mri_inr_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. It imports nothing of JAX. Phases:

1. the card's name and power limit, torch and CUDA versions; TF32 off for
   matmuls and cuDNN so every comparison below is in full f32;
2. build every CUDA kernel from ``mri_inr_tpu_torch/ops/csrc`` (one nvcc
   per source, started together), with registers and spills per kernel; the
   host tile helpers (g++) must build too;
3. each kernel against its plain PyTorch version at full width, seeded
   inputs: the eval forward (bf16 and int8) at H=256, L=5, S=576, B=1024 (one
   320x320 slice's patch bucket), the train forward and backward at B=400
   (one train batch) with dropout 0.1 (the backward also called twice: all
   six gradients must repeat bit for bit), and at phase 13's shapes on each
   rank (the train kernels at a local batch of 200 with each rank's
   dropout seed, the eval forward at 200 and 3,200), each called twice, bit
   for bit; the centred DFT (an FFT) at (16,
   640, 320), (16, 320, 320), (8, 320, 320), fastMRI's knee widths (2, 640, 368)
   and (2, 640, 372), and the odd and prime sizes (3, 63, 33) and (2, 37,
   41), also against ``torch.fft``;
4. the preprocessing path: phantom volumes (320x320, texture 0.2) ->
   synthetic.volume_to_kspace -> preprocessing.process_kspace_volume on the
   card with the preprocess CLI's default masks -> the ``metadata.csv`` files
   the next phases read, and one volume at fastMRI's own 16 x 640 x 320;
   slices in [0, 1], the fully sampled ones against their phantoms, two
   volumes against the ``torch.fft`` route on the CPU; the preprocess CLI's
   ``.h5`` route too where ``h5py`` is installed;
5. the eval path end to end through the user entry points: the model from
   configs/test.yaml with seeded init, MRISampler -> SliceReconstructor on
   one slice, then evaluate_files_device on the 16 slices (one batched
   forward per piece of a shape group) and write_metrics_artifacts, with
   the sweep's peak device memory; two slices are scored again on the CPU
   through the plain versions and must agree;
6. one eager train step at configs/train.yaml's width and batch, before any
   CUDA graph: its time (fused, and the module path), the host ops that
   make up its enqueue time (torch.profiler, CPU time), its device time by
   kernel and the device's idle share; Adam's update alone, fused (the
   port's) and multi-tensor, both capturable;
7. the graphed epoch against the per-step loop (Trainer with and without
   ``device_data``, two per-step runs for their own repeatability): losses
   and parameters, bit for bit where the per-step runs repeat; then a
   graphed and a per-step epoch timed (wall, the host's time up to the
   replay) and under torch.profiler (the device's idle share, the kernels
   counted by name against the launch counters); the same comparison on the
   module path (``model.use_pallas=false``) and on a residual model, whose
   epochs are graphed too (their dropout is Flax's masks, drawn on the card
   by the dropout kernel from keys in a device buffer), with their steps/s
   graphed and per-step;
8. the training path through the train CLI's ``main``: configs/train.yaml
   (only paths, epochs, save_interval and device_data overridden) on the 16
   slices (6,400 patches, 16 steps of batch 400 an epoch) with 4 more as
   validation set: initial errors, two epochs, final checkpoint, then a
   resumed third epoch (each run's first train epoch eager, then one graph
   replay an epoch; validation epochs replayed); then, uncounted, the same
   command resumed for more epochs, whose ``epoch_seconds`` in
   ``progress_log.csv`` give the graphed epoch rate;
9. the quantised eval path through the test CLI's ``main`` on the run
   directory phase 8 left: ``data.quantized=true`` over the 16 slices, its
   rows against a bf16 run of the same command and two slices against the
   CPU run through the plain int8 version;
10. the autoencoder-pretraining path on the phase-4 slices at
   configs/train.yaml's width (H=256, L=5, latent 256, batch 400):
   ``train_encoder --model conv`` for 2 epochs, ``--evaluate`` on its
   ``_full`` file (one slice again on the CPU); the train CLI with that
   ``model.encoder_path`` (the spliced encoder equals the autoencoder's
   before the first step, then 2 graphed epochs whose loss falls);
   ``train_encoder --model vgg`` (at ``--lr 1e-4``, see ``AE_LR``) and
   ``--model perceptual`` for 1 epoch each, the train CLI with ``encoder_type=vgg`` on the VGG file and with
   ``criterion=perceptual`` on the perceptual file for 2 epochs each, and
   with ``data.low_memory=true`` for 1 epoch (step by step); each run's
   initial validation loss against the same model's on the CPU through the
   plain versions (1e-3 relative; where bf16 rounding alone parts them
   further, as in the VGG run, 1e-3 in fp32 on both sides and 1e-2 in
   bf16); autoencoder epochs/s and the VGG and perceptual runs' steps/s;
11. the online k-space path (``data/online.py``) on phantom k-space
   (320x320, texture 0.2, 16 slices a volume, made in memory: this machine
   has no ``h5py``, so ``OnlineKspaceDataset.from_volumes``):
   configs/train_online.yaml at its width through the train CLI's
   ``make_trainer`` (8 train volumes, 88 slices, 88 steps an epoch, remask
   on; 2 validation volumes, 5 slices, masks fixed) for 3 epochs: one
   capture per dataset and mode although the undersampled tiles change each
   epoch, ``dft2c`` once per dataset for the fully sampled tiles and once
   per mask epoch, the graphed run against two per-step runs over host
   batches of the same tiles (bit for bit where they repeat), new
   undersampled tiles each epoch, the loss falling; online against offline
   tiles on the card (2e-6); the online device sweep of configs/test.yaml's
   model over 940 slices of 60 stems (one ``dft2c`` per image stack, no image
   data to the host) against the offline device sweep of the same volumes
   and two slices on the CPU;
13. data parallelism (``parallel/``): two ranks sharing the one card (gloo,
   so every collective crosses the host), each a process of this script
   (``--rank``) started through the ``MRI_INR_*`` route on cuda:0, running
   the CLI's ``main`` as a user's rank does: the train CLI at
   configs/train.yaml's width with ``data_axis_size=2``, dropout off and
   ``training.logging``, for two epochs and a resumed third (one run
   directory written by rank 0 alone, the checkpoint restored on both
   ranks, each rank's train-kernel launches equal to its steps, the
   TensorBoard losses against a one-process run on the ranks' two halves
   of every batch (1e-5) and one on the whole batch (9e-3, a bar that a
   one-process run with every rank on rank 0's rows, a planted fault, must
   exceed)); one fp32 step's gradients on the whole batch against the mean
   of its two halves', printed by parameter group and checked against
   nothing (``halves_gradient_gap``); one
   data-parallel step with dropout against Adam on the mean of the two
   ranks' local steps emulated here; the test CLI with ``--devices 2``
   against the one-process, ``--shard`` and ``--merge-shards`` files, and
   with ``data.halo_fold=true`` against the one-process rows; the ranks'
   steps/s, the gradient all-reduce's ms a step on the host's clock (the
   wait for the peer rank apart from the reduction, and the reduction's
   copies alone) and the halo exchange's ms a slice, labelled as two ranks
   sharing one card (phase 3 holds the three kernels these ranks run
   against their plain versions at the ranks' shapes);
14. the quality protocol's runner (``cli/results_run``) at configs/train.yaml's
   width on 2 / 1 / 1 phantom volumes x 4 slices of 256x256, two epochs a
   row and one autoencoder epoch, for the rows no other phase drives (online
   remask, VGG, perceptual, acc 4 / 0.2, edge, the frozen corpus-pretrained
   VGG trunk): each row's train and eval kernel launches, the DFT kernel's
   for the splits and each remask epoch, ``rows.json`` (finite means, this
   card), a second call that skips every row, and one volume's (0.2, 4) acc
   slices against the ``torch.fft`` route on the CPU; also the frozen random
   and corpus-pretrained VGG trunks on the module path
   (``vgg_frozen_rand_module``, ``vgg_frozen_corpus_module``), which launch
   no train kernel;
15. the 940-file sweep's runner (``cli/sweep940``) at configs/test.yaml's
   width and 320x320, its depth cut to 24 evaluation volumes x 4 slices and
   a headline model of 4 volumes trained one epoch and resumed to a second
   on the quality protocol's conv autoencoder (one epoch): its three legs
   (offline, online through the test CLI's sampler seam, two shards merged)
   and their checks, each stage's kernel launches; then ``cli/results_run
   --seed 1`` for phase 14's edge row, named ``edge@seed1``, whose losses
   differ from seed 0's;
16. the hard-corpus table's runner (``cli/hard_table``) at configs/train.yaml's
   width on phase 14's depth with the hard corpus (complex phase maps,
   k-space noise at SNR 32 dB, texture 0.18), two epochs a row: the
   baseline, the online remask (``dft2c`` on complex, noisy k-space each
   epoch), the residual row on the module path and ``residual_1200``
   resumed from its run directory to a third epoch; each row's launches,
   ``dft2c`` counted as in phase 14, finite means and this card in
   ``rows.json``, one hard volume's slices against the ``torch.fft`` route
   on the CPU, a hard call into phase 14's smooth root refused by the
   protocol guard before any file changes, and a second call that skips
   every row; then ``cli/hard_table --seed 1`` for the baseline row, named
   ``baseline@seed1``, on the same splits (no DFT launch), whose losses
   differ from seed 0's; the phase's wall time;
17. the seeded draws (before phase 4, on the CPU of the card's machine): the
   initial weights the train CLI's ``build_model`` (configs/train.yaml's
   model) and ``train_encoder``'s conv, VGG and perceptual autoencoders
   draw at seeds 0 and 1, every leaf's float64 sum and sum of squares,
   against the JAX package's ``init(jax.random.key(seed))``, and three
   phantom stems' column masks against the JAX package's, both recorded
   once on the CPU (``tests/data/jax_draws.json``): the draws are the JAX
   package's under this machine's torch too; every later phase runs on them;
18. the module path's dropout (after phase 7): the dropout kernel
   (``csrc/threefry_dropout.cu``) against its plain version, bit for bit, at
   the train batch (400 x 576 x 256) for the five hidden layers of two
   steps, and against the masks the JAX package draws there, recorded once
   on the CPU (``tests/data/jax_dropout_masks.json``: keys, kept counts,
   SHA-256 of the packed bits), the keys also against the port's
   ``epoch_dropout_keys``; then the graphed module epoch
   (configs/train.yaml with ``model.use_pallas=false``, ``device_data``) for
   an eager epoch, a captured one and a second replay: in each replay every
   step's masks differ from the step before and equal the plain version's
   of the keys staged for it, and the kernel's launches are the epochs'
   steps times five; the kernel's time and the module epoch's steps/s
   (phase 7's);
12. times with CUDA events (warm-up, then the median): every kernel and its
   plain version per call, for the DFT also the ``torch.fft`` route, for the
   backward also its chain and weight-gradient kernels apart (device time
   from ``torch.profiler``), one volume's preprocessing, the steady bf16 and
   int8 sweep rates.

Every path's launch counts are set to 0 just before it is driven and read
just after. Prints one JSON line of kernel records, then as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is non-zero and that last line is not printed. Without a CUDA device, or
without the package beside this file, it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import hashlib
import importlib.util
import json
import math
import os
import pathlib
import re
import socket
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
STEADY_EPOCHS = 7  # the first eager, the second captures, then five replays
GRAPH_EPOCHS = 3  # of each run of the graphed-against-per-step comparison
MASKS = [(0.05, 6), (0.1, 6)]  # the preprocess CLI's defaults
# card (DFT kernel) against CPU (torch.fft) slices, both in [0, 1]; the first H100
# run showed 2.0e-6
PREPROCESS_BAR = 2e-5
FASTMRI_SHAPE = (16, 640, 320)  # one fastMRI brain volume
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
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
def warpgroup_registers(build_mod) -> str:
    """The register split of the forward kernels' warpgroups (setmaxnreg),
    as siren_fwd.cuh sets it."""
    text = (build_mod.SRC_DIR / "siren_fwd.cuh").read_text()
    regs = {k: re.search(rf"{k} = (\d+)", text).group(1)
            for k in ("PRODUCER_REGS", "CONSUMER_REGS")}
    return (f"producer warpgroup {regs['PRODUCER_REGS']}, two consumer warpgroups "
            f"{regs['CONSUMER_REGS']} registers a thread (setmaxnreg)")


def kernel_label(entry: str) -> str:
    """A mangled kernel name, shortened; the forward kernels' template
    arguments spelled out."""
    act = {"0": "sine", "1": "morlet"}
    if "threefry_keep_mask_kernel" in entry:
        return "threefry_keep_mask_kernel"
    m = re.search(r"siren_forward_int8_kernelILi(\d+)ELb([01])E", entry)
    if m is not None:
        return f"siren_forward_int8_kernel<H={m[1]}, {act[m[2]]}>"
    m = re.search(r"chain_kernelILi(\d+)ELi(\d+)ELb([01])E", entry)
    if m is not None:
        return f"chain_kernel<H={m[1]}, degree {m[2]}, {act[m[3]]}>"
    m = re.search(r"dw_kernelILi(\d+)E", entry)
    if m is not None:
        return f"dw_kernel<H={m[1]}>"
    m = re.search(r"forward_kernelILi(\d+)E.*?(Eval|Train)EpilogueILi(\d+)ELb([01])E", entry)
    if m is None:
        return entry[-32:]
    h, kind, deg, morlet = m.groups()
    sine = "bf16 degree 7" if deg == "0" else f"degree {deg}"
    return (f"forward_kernel<H={h}, {kind.lower()}, {sine}, "
            f"{'morlet' if morlet == '1' else 'sine'}>")


def build_kernels(build_mod, names: list[str]) -> None:
    if build_mod.BUILD_DIR.is_dir():  # build from the checkout's sources, never a leftover
        for lib in build_mod.BUILD_DIR.glob("lib*.so"):
            lib.unlink()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        outs = list(pool.map(lambda n: build_mod.build(n)[1], names))
    print(f"build: {len(names)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    logs = dict(zip(names, outs))
    roles = warpgroup_registers(build_mod)
    for name, log in logs.items():
        entry, spill = "", ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "warning" in line.lower() or "Performance Loss" in line:
                print(f"  ptxas {name} {kernel_label(entry)}: {line.strip()}")
            elif "Used" in line and "registers" in line:
                # the forward kernels' entries: the launch's count, then the
                # warpgroups' own split
                split = f"; {roles}" if re.search("forward_(int8_)?kernel", entry) else ""
                print(f"  ptxas {name} {kernel_label(entry)}: "
                      f"{line.split(':', 1)[1].strip()}; {spill}{split}")


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


# ------------------------------------------- phase 3, int8 and DFT kernels
def int8_inputs(sk, ms, activation: str, device, batch: int = 1024):
    """Full-width seeded model -> the int8 chain op's inputs."""
    g = torch.Generator().manual_seed(SEED + 2)
    model = ms.ModulatedSiren(dim_hidden=256, latent_dim=256, num_layers=5,
                              activation=activation, generator=g, device=device).eval()
    tiles = torch.rand((batch, 32, 32), generator=g).to(device)
    with torch.no_grad():
        kp = sk.extract_kernel_params(model, ms.coordinate_grid(24, device))
        ikp = sk.quantize_kernel_params(model, kp)
        fq, gd, ls = sk.compute_quant_factors(kp, ikp, model.encode(tiles), num_layers=5)
    return (fq.contiguous(), gd.contiguous(), ls, ikp.base, ikp.swq, ikp.s_b, ikp.last_w,
            ikp.last_b)


# Bars: both versions multiply the same int8 operands exactly; they differ
# where the kernel's fused multiply-adds inside a sine (or its expf) move a
# floor across an integer: one quantum in one pre-activation. The first run
# on an H100 held 1e-3 / 1e-5 and showed max 1.5e-8 / mean 1.7e-9 for sine and
# for Morlet: no floor moved in 6e8 of them. The max bar leaves room for one
# that does (about 1e-4 at the output), the mean bar is sixty times the reading.
INT8_BARS = (1e-4, 1e-7)


def compare_int8_kernel(sk, ms, device) -> dict:
    inputs, errs = {}, {}
    for activation in ("sine", "morlet"):
        args = inputs[activation] = int8_inputs(sk, ms, activation, device)
        kw = dict(num_layers=5, activation=activation)
        got = sk.siren_forward_int8_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = sk.siren_forward_int8_reference(*args, **kw)
        check(got.shape == want.shape == (1024, 576), f"int8 {activation}: shape")
        check(bool(torch.isfinite(got).all()), f"int8 {activation}: non-finite output")
        err = (got - want).abs()
        mx, mean = err.max().item(), err.mean().item()
        print(f"int8 kernel vs plain [{activation}, degree 9]: max |diff| {mx:.3e} "
              f"(<= {INT8_BARS[0]:g}), mean {mean:.3e} (<= {INT8_BARS[1]:g})")
        check(mx <= INT8_BARS[0] and mean <= INT8_BARS[1],
              f"int8 {activation}: kernel disagrees")
        errs[activation] = mx
    return {"inputs": inputs["sine"], "max_abs_err": errs["sine"]}


def fft_route(x: torch.Tensor, inverse: bool = True, magnitude: bool = True) -> torch.Tensor:
    """The library route for the same function: ``torch.fft`` with the two
    shifts (and ``abs``). A yardstick here; the port's card path never calls
    it."""
    c = torch.fft.ifftshift(torch.view_as_complex(x), dim=(-2, -1))
    c = (torch.fft.ifft2 if inverse else torch.fft.fft2)(c, norm="ortho")
    c = torch.fft.fftshift(c, dim=(-2, -1))
    return c.abs() if magnitude else torch.view_as_real(c)


# Bar for |kernel - other| <= bar * max(|other|, 1): the same FFT stages in
# f32 with fused multiply-adds and written-out butterflies where the plain
# version multiplies by its length-R DFT matrices; torch.fft is another FFT.
# 2e-5 is the JAX package's bar against its FFT; on an H100 the FFT kernel
# read at most 1.4e-6 against the plain version and 1.9e-6 against torch.fft
# over these shapes, so the bar is about ten times the reading.
DFT_BAR = 2e-5


def compare_dft_kernel(fk, synthetic, kspace, device) -> dict:
    g = torch.Generator().manual_seed(SEED + 3)
    phantom_k = kspace.to_ri(synthetic.synthetic_kspace(0, SLICES_PER_VOLUME, SLICE_SIZE,
                                                        SLICE_SIZE, texture=0.2))
    data = {
        FASTMRI_SHAPE: torch.randn((*FASTMRI_SHAPE, 2), generator=g),
        (16, 320, 320): torch.randn((16, 320, 320, 2), generator=g),
        (SLICES_PER_VOLUME, SLICE_SIZE, SLICE_SIZE): torch.from_numpy(phantom_k),
        (2, 640, 368): torch.randn((2, 640, 368, 2), generator=g),  # fastMRI knee widths
        (2, 640, 372): torch.randn((2, 640, 372, 2), generator=g),
        (3, 63, 33): torch.randn((3, 63, 33, 2), generator=g),
        (2, 37, 41): torch.randn((2, 37, 41, 2), generator=g),  # primes: generic stages
    }
    modes = [("inverse, magnitude (the preprocessing call)", True, True),
             ("inverse", True, False), ("forward", False, False)]
    first = None
    for shape, x in data.items():
        x = x.to(device)
        for label, inverse, magnitude in modes:
            got = fk.dft2c_ri_cuda(x, inverse=inverse, magnitude=magnitude)
            torch.cuda.synchronize()
            want = fk.dft2c_ri_reference(x, inverse=inverse, magnitude=magnitude)
            lib = fft_route(x, inverse, magnitude)
            check(got.shape == want.shape == lib.shape, f"dft {shape} {label}: shape")
            check(bool(torch.isfinite(got).all()), f"dft {shape} {label}: non-finite")
            top = max(want.abs().max().item(), 1.0)
            gap, gap_lib = (got - want).abs().max().item(), (got - lib).abs().max().item()
            print(f"dft kernel {shape} [{label}]: max |diff| vs plain {gap:.3e}, vs torch.fft "
                  f"{gap_lib:.3e} (<= {DFT_BAR:g} * max(|plain|, 1) = {DFT_BAR * top:.3e})")
            check(gap <= DFT_BAR * top and gap_lib <= DFT_BAR * top,
                  f"dft {shape} {label}: kernel disagrees")
            if first is None:
                first = gap
    return {"inputs": {k: v.to(device) for k, v in data.items()}, "max_abs_err": first}


# ---------------------------------------------------------------- phase 4
def preprocess_volumes(pkg, out_dir: pathlib.Path, volumes, device, slices: int,
                       shape=None) -> tuple[pathlib.Path, dict]:
    """Phantom volumes -> k-space -> the port's preprocessing -> metadata.csv.
    Returns the metadata path and the phantoms by stem."""
    syn, pre = pkg["synthetic"], pkg["preprocessing"]
    shape = shape or (SLICE_SIZE, SLICE_SIZE)
    rows, phantoms = [], {}
    for v in volumes:
        stem = syn.synthetic_stem(v)
        phantoms[stem] = syn.phantom_volume(v, slices, *shape, texture=0.2)
        rows += pre.process_kspace_volume(syn.volume_to_kspace(phantoms[stem]), stem, out_dir,
                                          MASKS, device=device)
    return pre.write_metadata(rows, out_dir), phantoms


def preprocess_path(pkg, tmp: pathlib.Path, device) -> dict:
    """The preprocessing main path: the train/eval set, the validation set and
    one fastMRI-sized volume, all through the DFT kernel."""
    kernel = pkg["fk"].dft2c_ri_cuda
    kernel.launches = 0
    t0 = time.perf_counter()
    meta, phantoms = preprocess_volumes(pkg, tmp / "processed", range(VOLUMES), device,
                                        SLICES_PER_VOLUME)
    val_meta, val_phantoms = preprocess_volumes(pkg, tmp / "val", [100], device, 4)
    big_meta, _ = preprocess_volumes(pkg, tmp / "fastmri", [200], device, FASTMRI_SHAPE[0],
                                     FASTMRI_SHAPE[1:])
    torch.cuda.synchronize()
    launches = kernel.launches
    n_vol = VOLUMES + 2
    print(f"preprocessing path: {n_vol} volumes x (1 fully sampled + {len(MASKS)} masks) in "
          f"{time.perf_counter() - t0:.2f} s (phantoms and k-space made on the host "
          f"included) -> dft2c launches {launches}")
    check(launches == n_vol * (1 + len(MASKS)), f"expected {n_vol * 3} dft2c launches")

    rows = pkg["dataset"].read_metadata(meta) + pkg["dataset"].read_metadata(val_meta)
    check(len(rows) == VOLUMES * SLICES_PER_VOLUME + 4, f"{len(rows)} metadata rows")
    cols = [c for c in rows[0] if c.startswith("path_")]
    check(len(cols) == 1 + len(MASKS), f"path columns {cols}")
    worst = 0.0
    for row in rows:
        for col in cols:
            img = np.load(row[col])
            check(img.dtype == np.float32 and img.shape == (SLICE_SIZE, SLICE_SIZE),
                  f"{row[col]}: {img.dtype} {img.shape}")
            check(bool(np.isfinite(img).all()) and img.min() >= 0.0 and img.max() <= 1.0,
                  f"{row[col]} is not in [0, 1]")
        want = {**phantoms, **val_phantoms}[row["stem"]][int(row["slice_num"])]
        worst = max(worst, float(np.abs(np.load(row["path_fullysampled"]) - want).max()))
    print(f"fully sampled slices vs their phantoms: max |diff| {worst:.3e} (<= 1e-4)")
    check(worst <= 1e-4, "fully sampled reconstruction is not the phantom")
    big = pkg["dataset"].read_metadata(big_meta)
    check(len(big) == FASTMRI_SHAPE[0] and np.load(big[0][cols[1]]).shape == FASTMRI_SHAPE[1:],
          "fastMRI-sized volume rows")

    # the same two volumes through the torch.fft route on the CPU. Bar: two
    # f32 transforms of a volume whose maximum is 1, then the same min-max;
    # 2e-5 held on the first H100 run, which showed 4.8e-7
    cpu_meta, _ = preprocess_volumes(pkg, tmp / "processed_cpu", range(VOLUMES), "cpu",
                                     SLICES_PER_VOLUME)
    gap = 0.0
    for a, b in zip(pkg["dataset"].read_metadata(meta), pkg["dataset"].read_metadata(cpu_meta)):
        check(a["slice_id"] == b["slice_id"], "row order of the CPU run")
        for col in cols:
            gap = max(gap, float(np.abs(np.load(a[col]) - np.load(b[col])).max()))
    print(f"card (DFT kernel) vs cpu (torch.fft) preprocessing, {VOLUMES} volumes: "
          f"max |diff| {gap:.3e} (<= {PREPROCESS_BAR:g})")
    check(gap <= PREPROCESS_BAR, "card and CPU preprocessing disagree")

    if importlib.util.find_spec("h5py") is None:
        print("preprocess CLI: no h5py on this machine, .h5 route not run")
    else:
        preprocess_cli(pkg, tmp, device)
    return {"launches": launches, "meta": meta, "val_meta": val_meta}


def preprocess_cli(pkg, tmp: pathlib.Path, device) -> None:
    """``cli.preprocess.main --synthetic``: .h5 files written and read back,
    the same arrays as the array route."""
    syn, pre = pkg["synthetic"], pkg["preprocessing"]
    meta = pkg["cli_preprocess"].main(["--path", str(tmp / "h5"), "--synthetic", "2",
                                       "--texture", "0.2"])
    rows = pkg["dataset"].read_metadata(meta)
    check(len(rows) == 24, f"preprocess CLI wrote {len(rows)} rows")
    for v in range(2):
        pre.process_kspace_volume(syn.synthetic_kspace(v, texture=0.2), syn.synthetic_stem(v),
                                  tmp / "h5_check", MASKS, device=device)
    for path in sorted((tmp / "h5_check").glob("*.npy")):
        check(np.array_equal(np.load(path), np.load(meta.parent / path.name)),
              f"preprocess CLI: {path.name} differs from the array route")
    print("preprocess CLI: 2 synthetic .h5 volumes -> the array route's slices, bit for bit")


DRAWS_FILE = REPO / "tests" / "data" / "jax_draws.json"  # tests/jax_draws_constants.py
#: a lecun-normal leaf's float64 sum of values (of squares) against the JAX
#: package's: within 1e-6 of std * sqrt(n) (std^2 * sqrt(n)); measured 3.4e-8
#: (5.7e-8) on the CPU: an ulp or two of erfinv on about one value in a hundred
DRAW_SUM_BAR = 1e-6


def leaf_sums(tree, prefix=()) -> dict:
    """``"a/b/kernel"`` -> [size, sum, sum of squares] of a Flax-layout tree,
    the sums in float64 by ``math.fsum`` (exactly rounded: the same values
    give the same numbers on any machine)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(leaf_sums(v, prefix + (k,)))
        else:
            a = np.asarray(v, np.float64).reshape(-1)
            out["/".join(prefix + (k,))] = [int(a.size), math.fsum(a), math.fsum(a * a)]
    return out


def draw_mismatches(recorded: dict, got: dict) -> list[str]:
    """The leaves where the port's draw (``leaf_sums``) misses the JAX
    package's (``recorded``: size, sums, initializer): the uniform, zero and
    one leaves must be equal, the lecun-normal ones within DRAW_SUM_BAR."""
    bad = [f"leaves only on one side: {sorted(set(got) ^ set(recorded))}"] if (
        set(got) != set(recorded)) else []
    for leaf, (n, s, q, kind) in sorted(recorded.items()):
        if leaf not in got:
            continue
        gn, gs, gq = got[leaf]
        if kind == "lecun_normal":
            std = math.sqrt(max(q / n - (s / n) ** 2, 0.0))
            ok = (gn == n and abs(gs - s) <= DRAW_SUM_BAR * std * math.sqrt(n)
                  and abs(gq - q) <= DRAW_SUM_BAR * std * std * math.sqrt(n))
        else:
            ok = [gn, gs, gq] == [n, s, q]
        if not ok:
            bad.append(f"{leaf} ({kind}): size {gn}, sums {gs!r} {gq!r}; JAX {n}, {s!r} {q!r}")
    return bad


def drawn_model(pkg, name: str, seed: int) -> torch.nn.Module:
    """The model a user's entry point builds at ``seed``, on the CPU: the
    train CLI's ``build_model`` at configs/train.yaml's width, and
    ``train_encoder``'s three autoencoders at latent 256."""
    if name == "modulated_siren":
        cfg = pkg["config"].load_train_configuration(REPO / "configs" / "train.yaml",
                                                     [f"training.seed={seed}"])
        return pkg["cli_train"].build_model(cfg, torch.device("cpu"), log=lambda *_: None)
    model, _ = pkg["train_encoder"].build_autoencoder(name.split("_")[0], latent_dim=256,
                                                      seed=seed, device="cpu")
    return model


def draws_path(pkg, card: str) -> dict:
    """The seeded draws on this machine's torch and numpy against the JAX
    package's, recorded once on the CPU (``DRAWS_FILE``): every leaf of the
    initial weights of four models at two seeds, and the column masks of
    three phantom stems under each preprocessing mask pair."""
    t0 = time.perf_counter()
    rec = json.loads(DRAWS_FILE.read_text())
    leaves = 0
    for name, seeds in rec["models"].items():
        for seed, recorded in seeds.items():
            model = drawn_model(pkg, name, int(seed))
            got = leaf_sums(pkg["interop"].variables_to_flax(model.state_dict())["params"])
            for leaf, (n, s, q, kind) in sorted(recorded.items()):
                g = got.get(leaf, [None] * 3)
                print(f"draw {name}@{seed} {leaf} ({kind}, {n}): sum {g[1]!r} sumsq {g[2]!r}; "
                      f"JAX {s!r} {q!r}")
            bad = draw_mismatches(recorded, got)
            check(not bad, f"{name} at seed {seed} is not the JAX package's draw: {bad[:3]}")
            leaves += len(recorded)
    jr, pre, kspace = pkg["jax_random"], pkg["preprocessing"], pkg["kspace"]
    width = rec["mask_width"]
    for key, want in sorted(rec["masks"].items()):
        stem, cf, acc = key.split("|")
        mask = kspace.random_mask(jr.key(pre._stable_seed(stem, float(cf), int(acc))), width,
                                  float(cf), int(acc))
        got = np.packbits(mask).tobytes().hex()
        print(f"draw mask {stem} ({cf}, {acc}): {int(mask.sum())} of {width} columns, "
              f"{'equal to' if got == want else 'NOT'} the JAX package's")
        check(got == want, f"the mask of {key} is not the JAX package's")
    secs = time.perf_counter() - t0
    print(f"draws: {leaves} leaves of {len(rec['models'])} models at seeds "
          f"{sorted({s for v in rec['models'].values() for s in v})} and {len(rec['masks'])} "
          f"masks equal the JAX package's (uniform, zero, one leaves and masks bit for bit; "
          f"lecun-normal leaves within {DRAW_SUM_BAR} of std * sqrt(n)) under torch "
          f"{torch.__version__}, numpy {np.__version__} ({secs:.1f}s) [{card}]")
    return {"leaves": leaves, "masks": len(rec["masks"]), "seconds": secs}


def time_preprocessing(pkg, tmp: pathlib.Path, device, card: str) -> None:
    """One volume's preprocessing end to end (host clock, device finished)."""
    syn, pre = pkg["synthetic"], pkg["preprocessing"]
    for label, k in (
            (f"{SLICES_PER_VOLUME} x {SLICE_SIZE} x {SLICE_SIZE}",
             syn.synthetic_kspace(0, SLICES_PER_VOLUME, SLICE_SIZE, SLICE_SIZE, texture=0.2)),
            ("16 x 640 x 320 (fastMRI brain)",
             syn.synthetic_kspace(200, FASTMRI_SHAPE[0], *FASTMRI_SHAPE[1:], texture=0.2))):
        for dev in (device, "cpu"):
            secs = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pre.process_kspace_volume(k, "timed", tmp / "timed", MASKS, device=dev)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            route = "DFT kernel on the card" if dev != "cpu" else "torch.fft on the CPU"
            print(f"process_kspace_volume {label}, {len(MASKS)} masks, {route}: median "
                  f"{statistics.median(secs[1:]) * 1e3:.2f} ms a volume (3 runs after a "
                  f"warm-up; upload, reconstructions, min-max, copies back, np.save) [{card}]")


def sweep_pieces(ev, slices: int) -> int:
    """Batched forwards of a sweep over ``slices`` slices of SLICE_SIZE^2:
    pieces of whole slices of at most ``evaluate.PIECE_PATCHES`` patches."""
    per = max(1, ev.PIECE_PATCHES // (SLICE_SIZE // 16) ** 2)
    return -(-slices // per)


def end_to_end(pkg, tmp: pathlib.Path, device, meta: pathlib.Path, card: str) -> dict:
    cfg = pkg["config"].load_test_configuration(REPO / "configs" / "test.yaml")
    mcfg, ecfg = cfg.model, cfg.data
    model = pkg["ms"].from_config(mcfg, generator=torch.Generator().manual_seed(SEED),
                                  device=device)
    print(f"model from configs/test.yaml: H={mcfg.dim_hidden} latent={mcfg.latent_dim} "
          f"L={mcfg.num_layers} encoder={mcfg.encoder_type} activation={mcfg.activation} "
          f"bucket={ecfg.batch_patches} sin5={ecfg.sin5} sin_bf16={ecfg.sin_bf16}")

    def pipeline(m, dev, quantized=ecfg.quantized):
        apply_fn = pkg["sk"].make_apply_fn(
            m, use_pallas=mcfg.use_pallas, sin_bf16=ecfg.sin_bf16, sin5=ecfg.sin5,
            ksplit=ecfg.ksplit, quantized=quantized, device=dev)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    results, timings = pkg["ev"].evaluate_files_device(recon, sampler())
    torch.cuda.synchronize()
    launches = kernel.launches
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    pieces = sweep_pieces(pkg["ev"], len(results))
    print(f"main path: 1 visual slice + {len(results)}-slice device sweep in {pieces} "
          f"batched piece(s) -> siren_forward launches {launches}; the sweep's peak device "
          f"memory {peak_mb:.1f} MiB above the {base_mem / 2**20:.1f} MiB held before it")
    check(launches == 1 + pieces, f"expected {1 + pieces} kernel launches")

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

    # steady sweeps, bf16 and int8 chains in turns within this one call
    recons = {"bf16": recon, "int8": pipeline(model, device, quantized=True)}

    def sweep(which):
        return pkg["ev"].evaluate_files_device(recons[which], sampler(),
                                               log=lambda *_: None)[1]

    steady = {"bf16": [], "int8": []}
    for which in steady:
        sweep(which)
    for _ in range(REPS // 2):
        for which in ("bf16", "int8", "int8", "bf16"):
            steady[which].append(sweep(which))
    out = {"launches": launches, "pieces": pieces, "peak_mb": peak_mb}
    for which, runs in steady.items():
        med = {k: statistics.median(t[k] for t in runs) for k in runs[0]}
        print(f"{which} sweep timings (steady, median of {len(runs)}): " + " ".join(
            f"{k}={v:.4f}" for k, v in med.items()) + f" [{card}]")
        rates = [total / (t["dispatch_seconds"] + t["execute_fetch_seconds"]) for t in runs]
        out[f"{which}_slices_per_sec"] = statistics.median(rates)
    return out


# ------------------------------------------------- phase 3, train kernels
TRAIN_BATCH = 400
TRAIN_CASES = [
    # label, activation, sin5
    ("sine, sin5 (training default)", "sine", True),
    ("sine, degree 9", "sine", False),
    ("morlet, sin5", "morlet", True),
]
# Bars for |kernel - plain| <= bar * max(|plain|, 1): sums over up to B*S =
# 230,400 rows in another order (split-K partials, per-tile records and
# per-block partials, each summed in a fixed order) on top of rare bf16
# rounding flips. The first run on an H100 held 2e-3 for all six and
# showed 3.4e-8 (dmods), 6.5e-10 (dbase), 6.6e-8 (dsw), 7.6e-8
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
            check(all(same), "a gradient differs between two backward calls")
            first = {"fwd_err": mx, "bwd_err": worst}
    return {"inputs": inputs["sine"], **first}


def compare_local_kernels(sk, stk, ms, trainer, cmp: dict, cmp_train: dict, device) -> dict:
    """The three kernels phase 13 runs on every rank, at that phase's shapes,
    against their plain versions with the bars above, and called twice, bit
    for bit: the train forward and backward on each rank's LOCAL_BATCH rows
    of the train batch with that rank's dropout seed (``step_seed`` with the
    rank folded in, dropout 0.1), the eval forward at LOCAL_BATCH and at
    BAND_PATCHES. Returns the largest errors."""
    targs, cot = cmp_train["inputs"]
    kw = dict(num_layers=5, dropout_rate=0.1, sin5=True)
    out = {"fwd_err": 0.0, "bwd_err": 0.0}
    for r in range(RANKS):
        rows = slice(r * LOCAL_BATCH, (r + 1) * LOCAL_BATCH)
        seed = trainer.step_seed(DP_SEED, 0, r)
        args = (torch.tensor([float(seed)], device=device), targs[1][rows].contiguous(),
                *targs[2:])
        label = f"rank {r}'s rows, B={LOCAL_BATCH}, seed {seed}"
        got, again = (stk.siren_chain_train_fwd_cuda(*args, **kw) for _ in range(2))
        torch.cuda.synchronize()
        want = stk.siren_chain_train_fwd_reference(*args, **kw)
        check(got.shape == want.shape == (LOCAL_BATCH, 576), f"{label}: fwd shape")
        err = (got - want).abs()
        mx, mean = err.max().item(), err.mean().item()
        print(f"train fwd kernel vs plain [{label}]: max |diff| {mx:.3e} (<= 1e-4), mean "
              f"{mean:.3e} (<= 1e-6); two calls bit for bit: {torch.equal(got, again)}")
        check(bool(torch.isfinite(got).all()) and mx <= 1e-4 and mean <= 1e-6,
              f"{label}: train forward kernel disagrees")
        check(torch.equal(got, again), f"{label}: train forward differs between two calls")
        out["fwd_err"] = max(out["fwd_err"], mx)

        rcot = cot[rows].contiguous()
        got_b, again_b = (stk.siren_chain_train_bwd_cuda(*args, rcot, **kw) for _ in range(2))
        torch.cuda.synchronize()
        want_b = stk.siren_chain_train_bwd_reference(*args, rcot, **kw)
        gaps = []
        for name, a, b, c in zip(BWD_BARS, got_b, want_b, again_b):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"{label}: {name}")
            gap, top = (a - b).abs().max().item(), b.abs().max().item()
            gaps.append(f"{name} {gap:.3e} (relative {gap / top:.2e})")
            check(gap <= BWD_BARS[name] * max(top, 1.0) and gap <= BWD_REL_BAR * top,
                  f"{label}: {name} disagrees")
            check(torch.equal(a, c), f"{label}: {name} differs between two backward calls")
            out["bwd_err"] = max(out["bwd_err"], gap)
        print(f"train bwd kernel vs plain [{label}]: max |diff| " + ", ".join(gaps)
              + " (bars as at B=400); two calls bit for bit: all six")

    ekw = dict(num_layers=5, sin7=True, sin5=True)
    mods, kp = cmp["inputs"]
    band_mods, band_kp = kernel_inputs(sk, ms, "sine", device, batch=BAND_PATCHES)
    for key, m, p in (("eval_local_err", mods[:LOCAL_BATCH].contiguous(), kp),
                      ("eval_band_err", band_mods, band_kp)):
        args = (m, p.base, p.s_w, p.s_b, p.last_b)
        got, again = (sk.siren_forward_cuda(*args, **ekw) for _ in range(2))
        torch.cuda.synchronize()
        want = sk.siren_forward_reference(*args, **ekw)
        check(got.shape == want.shape == (m.shape[0], 576), f"eval B={m.shape[0]}: shape")
        err = (got - want).abs()
        mx, mean = err.max().item(), err.mean().item()
        print(f"kernel vs plain [eval default, B={m.shape[0]}]: max |diff| {mx:.3e} (<= "
              f"1e-4), mean {mean:.3e} (<= 1e-6); two calls bit for bit: "
              f"{torch.equal(got, again)}")
        check(bool(torch.isfinite(got).all()) and mx <= 1e-4 and mean <= 1e-6,
              f"eval B={m.shape[0]}: kernel disagrees")
        check(torch.equal(got, again), f"eval B={m.shape[0]}: differs between two calls")
        out[key] = mx
    out["band_inputs"] = (band_mods, band_kp)
    return out


# ---------------------------------------------------------------- phase 5
def train_path(pkg, tmp: pathlib.Path, device, train_meta: pathlib.Path,
               val_meta: pathlib.Path) -> dict:
    """The training main path through the train CLI's ``main`` (the 16 slices
    of the eval phase, 4 more as validation set)."""
    stk, sk, cli = pkg["stk"], pkg["sk"], pkg["cli_train"]
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
    graphs = [(t.scan_epoch.captures, t.scan_epoch.replays) for t in (trainer, resumed)]
    print(f"train path: {len(trainer.train_dataset)} train patches, "
          f"{len(trainer.val_dataset)} val patches, {per_epoch} steps an epoch; "
          f"2 epochs + 1 resumed -> train fwd launches {fwd_n}, train bwd launches "
          f"{bwd_n}, eval forward launches {eval_n} (replays count what their graph "
          f"launches); CUDA graphs (captures, replays): first run {graphs[0]}, resumed run "
          f"{graphs[1]}")
    check(per_epoch == 16 and steps == 32, f"expected 32 steps, got {steps}")
    # first run: train epoch 0 eager, epoch 1 replayed; validation (eager at
    # the initial losses) replayed both epochs. Resumed: epoch 2 eager, its
    # validation replayed
    check(graphs == [(2, 3), (1, 1)], f"graph captures and replays {graphs}")
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
    # validation batches) are the trainer's own, read from progress_log.csv;
    # the first is eager, the second captures its train graph, the rest are
    # one replay each
    steady = cli.main(argv + ["--set", f"training.epochs={3 + STEADY_EPOCHS}",
                              "--set", "training.continue_training=true"])
    with open(run / "progress_log.csv") as fh:
        secs = [float(r["epoch_seconds"]) for r in csv.DictReader(fh)]
    check(len(secs) == STEADY_EPOCHS, f"{len(secs)} steady epochs logged")
    check(steady.scan_epoch.replays == 2 * STEADY_EPOCHS - 1, "steady epochs not replayed")
    return {"fwd": fwd_n, "bwd": bwd_n, "eval": eval_n, "epoch_seconds": secs[2:],
            "eager_epoch_seconds": secs[0], "capture_epoch_seconds": secs[1],
            "steps_per_epoch": per_epoch,
            "val_batches": val_batches, "run_dir": run}


# ---------------------------------------------------------------- phase 7
@contextlib.contextmanager
def scan_seeds(tr):
    """The per-step route on the graphed epoch's dropout seeds. The JAX
    package's fused per-step (mesh) step folds the axis index into each
    step's key and its scan epoch does not; the port draws as each route
    does. A comparison of the graphed epoch with the per-step loop holds
    both to one stream inside this context."""
    kept = tr.epoch_seeds
    tr.epoch_seeds = lambda base, step0, n, rank=None: kept(base, step0, n)
    try:
        yield
    finally:
        tr.epoch_seeds = kept


def graph_path(pkg, tmp: pathlib.Path, device, meta: pathlib.Path, val_meta: pathlib.Path,
               card: str, label: str = "fused path", overrides: tuple = ()) -> dict:
    """The graphed epoch (Trainer with ``device_data``: the first epoch
    eager, then one graph replay a train and a validation epoch) against the
    per-step loop (Trainer without, batches from the host), from one seeded
    init on the train path's data; two per-step runs show how far the loop
    repeats itself. Then a graphed and a per-step epoch timed, and on the
    fused path each under torch.profiler. ``overrides``: ``--set`` items of
    configs/train.yaml (the module path: ``model.use_pallas=false``, or a
    residual model)."""
    cfg = pkg["config"].load_train_configuration(REPO / "configs" / "train.yaml",
                                                 list(overrides))
    tcfg, mcfg, dcfg = cfg.training, cfg.model, cfg.data
    tr = pkg["trainer"]
    use_pallas = mcfg.use_pallas if tcfg.use_pallas is None else tcfg.use_pallas
    fused = use_pallas and not mcfg.residual

    def dataset(path):
        return pkg["dataset"].MRIDataset(
            path, center_fraction=dcfg.center_fraction, acceleration=dcfg.acceleration,
            mri_type=dcfg.train.mri_type, max_slice_num=dcfg.train.max_slice_num,
            outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size)

    data = (dataset(meta), dataset(val_meta))

    def run(name, device_data):
        model = pkg["ms"].from_config(mcfg, tcfg.precision,
                                      generator=torch.Generator().manual_seed(tcfg.seed),
                                      device=device)
        run_dir = tmp / label.replace(" ", "_") / name
        t = tr.Trainer(model, tr.create_train_state(model, tcfg.optimizer, tcfg.lr),
                       pkg["losses"].make_loss_fn(tcfg.criterion), *data, run_dir,
                       batch_size=tcfg.batch_size, save_interval=1000,
                       base_seed=tcfg.seed + 1, use_pallas=use_pallas, sin5=tcfg.sin5,
                       device_data=device_data, device=device, log=lambda *_: None)
        t.initial_errors()
        t.train(GRAPH_EPOCHS)
        curve = list(t.initial_losses) + [r[k] for r in t._progress
                                          for k in ("train_loss", "val_loss")]
        flat = torch.cat([q.detach().reshape(-1) for q in model.parameters()])
        return np.array(curve), flat, t

    with scan_seeds(tr):
        (la, pa, ta), (lb, pb, _) = run("per_step_a", False), run("per_step_b", False)
    lc, pc, tc = run("graphed", True)
    spread = (float(np.abs(la - lb).max()), (pa - pb).abs().max().item())
    gap = (float(np.abs(lc - la).max()), (pc - pa).abs().max().item())
    repeats = spread == (0.0, 0.0)
    print(f"{label}: per-step loop, two runs of {GRAPH_EPOCHS} epochs from one seed: max "
          f"|d loss| {spread[0]:.3e}, max |d parameter| {spread[1]:.3e} "
          f"({'bit for bit' if repeats else 'not bit for bit'})")
    print(f"{label}: graphed epochs vs the per-step loop: max |d loss| {gap[0]:.3e}, max |d "
          f"parameter| {gap[1]:.3e} (bar: {'0, bit for bit' if repeats else 'twice the '
          'per-step runs\' own gap'}); graphs (captures, replays) "
          f"({tc.scan_epoch.captures}, {tc.scan_epoch.replays})")
    check(tc.scan_epoch.fused == fused, f"{label}: the fused flag")
    check(tc.scan_epoch.replays == 2 * GRAPH_EPOCHS - 1, "graphed run did not replay")
    if repeats:
        check(gap == (0.0, 0.0), "the graphed run differs from a per-step loop that repeats")
    else:
        check(gap[0] <= 2 * spread[0] and gap[1] <= 2 * spread[1],
              "the graphed run is further from the per-step loop than its own repeatability")

    # one more graphed epoch and one more per-step epoch, profiled
    counters = (pkg["stk"].siren_chain_train_fwd_cuda, pkg["stk"].siren_chain_train_bwd_cuda)
    out = {"spread": spread, "gap": gap}
    n = -(-len(data[0]) // tcfg.batch_size)
    epoch = GRAPH_EPOCHS
    for kind, t in (("graphed", tc), ("per-step", ta)):
        # unprofiled: the epoch's wall time and the host's share of it
        walls, hosts = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._epoch_loss(data[0], train=True, epoch=epoch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            # the graphed epoch's host time up to its replay's return; the
            # per-step loop's ends in fetching its loss: its wall time
            hosts.append(t.scan_epoch.launch_seconds if t.scan_epoch else walls[-1])
            epoch += 1
        wall, host = statistics.median(walls), statistics.median(hosts)
        out[kind] = {"wall_ms": wall * 1e3, "host_ms": host * 1e3}
        if not fused:
            continue
        # profiled: device busy time, idle share, kernels by name
        before = [k.launches for k in counters]
        torch.cuda.synchronize()
        with pkg["profiling"].device_trace(tmp / f"trace_{kind}") as prof:
            t0 = time.perf_counter()
            t._epoch_loss(data[0], train=True, epoch=epoch)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        epoch += 1
        counted = [k.launches - b for k, b in zip(counters, before)]
        rows = device_rows(prof, 1)
        busy = sum(ms for _, ms, _ in rows)
        seen = [sum(c for name, _, c in rows if key in name)
                for key in ("TrainEpilogue", "chain_kernel")]
        idle = max(0.0, 1 - busy / (pwall * 1e3))
        print(f"{kind} train epoch ({n} steps of {tcfg.batch_size}), median of 3: wall "
              f"{wall * 1e3:.4f} ms = {n / wall:.2f} steps/s, {n * tcfg.batch_size / wall:.1f} "
              f"patches/s; host {host * 1e3:.4f} ms {'up to the replay' if t.scan_epoch else ''}"
              f"; under the profiler: wall {pwall * 1e3:.4f} ms, device busy {busy:.4f} ms, "
              f"idle share {idle:.1%}; train fwd / bwd launches counted {counted[0]} / "
              f"{counted[1]}, kernels seen by the profiler {seen[0]} / {seen[1]} [{card}]")
        check(counted == seen, f"{kind}: launch counters {counted}, profiler {seen}")
        check(counted == [n, n], f"{kind}: {counted} launches for {n} steps")
        out[kind] |= {"busy_ms": busy, "idle": idle}
    if not fused:
        g, p = out["graphed"]["wall_ms"], out["per-step"]["wall_ms"]
        print(f"{label} train epoch ({n} steps of {tcfg.batch_size}), median of 3: graphed "
              f"{g:.4f} ms = {n / g * 1e3:.2f} steps/s (host {out['graphed']['host_ms']:.4f} "
              f"ms up to the replay), per-step {p:.4f} ms = {n / p * 1e3:.2f} steps/s "
              f"[{card}]")
    return out


# ---------------------------------------------------------------- phase 9
# |dPSNR| per slice of the int8 rows against the bf16 rows of the same
# command, on the run directory phase 6 leaves (8 epochs from a seeded init,
# PSNR near 24 dB). The bf16 run takes data.sin5=false (degree-7 hidden
# sines), the nearest neighbour of the int8 chain's degree-9 sines: the bf16
# default's degree-5 sine is 0.18 dB from that on so short a training, a gap
# that is not the quantisation's. Read on an H100: 6.9e-3 to 1.2e-2 dB (the
# trained model differs from run to run); the bar is eight times the largest
# reading.
QUANT_PSNR_BAR = 0.1


def quantized_path(pkg, tmp: pathlib.Path, device, meta: pathlib.Path,
                   run_dir: pathlib.Path) -> dict:
    """The quantised eval main path through the test CLI's ``main``."""
    sk, cli = pkg["sk"], pkg["cli_test"]
    total = VOLUMES * SLICES_PER_VOLUME
    plots = pkg["visualization"].have_matplotlib()
    visual = 1 if plots else 0
    if not plots:
        print("test CLI: no matplotlib on this machine, visual_samples=0 and plots left out")

    def argv(name, *extra):
        sets = [f"data.dataset={meta}", f"data.model_path={run_dir}",
                f"data.output_dir={tmp / 'test_out'}", f"data.output_name={name}",
                f"data.visual_samples={visual}", *extra]
        return ["--config", str(REPO / "configs" / "test.yaml")] + [
            x for item in sets for x in ("--set", item)]

    int8_kernel, bf16_kernel = sk.siren_forward_int8_cuda, sk.siren_forward_cuda
    int8_kernel.launches = bf16_kernel.launches = 0
    rows = cli.main(argv("int8", "data.quantized=true"))
    torch.cuda.synchronize()
    n_int8, n_bf16 = int8_kernel.launches, bf16_kernel.launches
    print(f"quantised eval path: test CLI on {run_dir.name}, {len(rows)} slices + {visual} "
          f"visual -> siren_forward_int8 launches {n_int8}, siren_forward launches {n_bf16}")
    check(len(rows) == total, f"{len(rows)} int8 rows, expected {total}")
    pieces = sweep_pieces(pkg["ev"], total)
    check(n_int8 == pieces + visual and n_bf16 == 0,
          f"int8 path launch counts: expected {pieces} batched piece(s) + {visual} visual")
    check(all(np.isfinite([r.psnr, r.ssim, r.nrmse]).all() for r in rows),
          "non-finite int8 metrics")
    out = tmp / "test_out" / "int8"
    for name in ("metrics_error.csv", "metrics_summary.txt"):
        check((out / name).is_file(), f"{name} missing")
    check(pkg["ev"].read_metrics_csv(out / "metrics_error.csv") == rows,
          "metrics_error.csv is not the rows main() returned")
    check((out / "psnr_boxplot.png").is_file() == plots, "plots")

    # the same command through the bf16 chain with data.sin5=false: the gate;
    # and with its degree-5 default, printed only (that gap is the sine's)
    by_id = lambda rs: {r.slice_id: r.psnr for r in rs}
    int8, bf16 = by_id(rows), by_id(cli.main(argv("bf16", "data.sin5=false")))
    sin5 = by_id(cli.main(argv("bf16_sin5")))
    gap = lambda a, b: max(abs(a[k] - b[k]) for k in a)
    print(f"test CLI rows, mean PSNR: int8 {np.mean(list(int8.values())):.4f}, bf16 with "
          f"sin5=false {np.mean(list(bf16.values())):.4f} dB; max |dPSNR| per slice "
          f"{gap(int8, bf16):.3e} (<= {QUANT_PSNR_BAR:g}) dB; not held: the bf16 default "
          f"(sin5=true) is {gap(sin5, bf16):.3e} dB from its sin5=false rows")
    check(gap(int8, bf16) <= QUANT_PSNR_BAR, "int8 and bf16 rows disagree")

    # two slices on the CPU through the plain int8 version
    cpu_rows = cli.main(argv("int8_cpu", "data.quantized=true", "data.metric_samples=2",
                             "data.visual_samples=0") + ["--device", "cpu"])
    by_id = {r.slice_id: r for r in rows}
    for c in cpu_rows:
        g = by_id[c.slice_id]
        dp, ds, dn = abs(g.psnr - c.psnr), abs(g.ssim - c.ssim), abs(g.nrmse - c.nrmse)
        print(f"int8 cpu vs card [{c.slice_id}]: PSNR {c.psnr:.4f} vs {g.psnr:.4f} "
              f"(|d| {dp:.2e} <= 0.05), SSIM |d| {ds:.2e}, NRMSE |d| {dn:.2e} (<= 1e-3)")
        check(dp <= 0.05 and ds <= 1e-3 and dn <= 1e-3, "int8 CPU cross-check")
    return {"launches": n_int8}


# --------------------------------------------------------------- phase 10
AE_EPOCHS = {"conv": 2, "vgg": 1, "perceptual": 1}
# The VGG autoencoder's rate. One epoch of its 13 ReLU convs (no
# normalisation) at train_encoder's default 1e-3 left trunk features of mean
# 3e-4 to 2.4e8 over seeds 0-7, and 0.16 to 1.27 over six runs of seed 0
# (cuDNN's backward does not repeat bit for bit). Above a mean of about 1 the
# SIREN's modulations reach 60 to 110, where its forward is ill-posed (the
# plain version moves by up to 2 when the modulations move by 1e-6), and the
# spliced run does not train in its 32 steps, through the kernels and
# through their plain versions alike: 5 of those 14 runs
# (scripts/torch_vgg_splice_probe.py). At 1e-4 the features of seeds 0-7
# kept a mean of at most 0.12 and every spliced run trained.
AE_LR = {"vgg": "1e-4"}
# each train run's initial validation loss, card (CUDA kernels, cuDNN) against
# the CPU (plain versions), relative; TF32 is off. A run whose bf16 rounding
# alone puts the two further apart (the VGG run: its 13 bf16 convs put the
# latent 6.3e-3 from float64 on the CPU, and one run's loss read 2.55e-3 from
# the CPU's on an H100) is held at the bar in fp32 on both sides, and its
# bf16 gap at BF16_DEEP_BAR
INITIAL_LOSS_BAR = 1e-3
BF16_DEEP_BAR = 1e-2


def initial_val_loss(pkg, argv: list[str], device, *extra: str) -> float:
    """The validation half of ``Trainer.initial_errors`` for the train CLI
    command ``argv`` (and ``extra`` overrides), with the same seeded model,
    splice, loss and data, on ``device`` (the CPU: the plain versions)."""
    cli, tr = pkg["cli_train"], pkg["trainer"]
    sets = [argv[i + 1] for i, a in enumerate(argv) if a == "--set"] + list(extra)
    cfg = pkg["config"].load_train_configuration(REPO / "configs" / "train.yaml", sets)
    tcfg, mcfg, dcfg = cfg.training, cfg.model, cfg.data
    dev = torch.device(device)
    model = cli.build_model(cfg, dev, log=lambda *_: None)
    use_pallas = tcfg.use_pallas if tcfg.use_pallas is not None else mcfg.use_pallas
    with tempfile.TemporaryDirectory() as run:
        t = tr.Trainer(model, tr.create_train_state(model, tcfg.optimizer, tcfg.lr),
                       cli.build_loss_fn(cfg, dev), None, cli._dataset(dcfg.val, dcfg, mcfg),
                       run, batch_size=tcfg.batch_size, use_pallas=use_pallas, sin5=tcfg.sin5,
                       device=dev, log=lambda *_: None)
        return t._epoch_loss(t.val_dataset, train=False, epoch=0)


def pretraining_path(pkg, tmp: pathlib.Path, device, meta: pathlib.Path,
                     val_meta: pathlib.Path, card: str) -> dict:
    """The autoencoder-pretraining path and the train CLI runs its files
    feed, the low-memory dataset beside them."""
    te, cli, stk, sk = pkg["train_encoder"], pkg["cli_train"], pkg["stk"], pkg["sk"]
    t_phase = time.perf_counter()
    counters = (stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda,
                sk.siren_forward_cuda)
    for k in counters:
        k.launches = 0
    files, ae = {}, {}
    for name, epochs in AE_EPOCHS.items():
        out = tmp / "ae" / name
        lr = ["--lr", AE_LR[name]] if name in AE_LR else []
        res = te.main(["--dataset", str(meta), "--output", str(out), "--model", name,
                       "--epochs", str(epochs), *lr])
        check(bool(np.isfinite(res["losses"]).all()), f"{name} autoencoder loss {res['losses']}")
        files[name] = te.checkpoint_paths(out, name, epochs - 1)
        check(all(f.is_file() for f in files[name]), f"{name} autoencoder files")
        ae[name] = res
    vgg_ae = te.build_autoencoder("vgg", device=device)[0]
    vgg_ae.load_state_dict(torch.load(files["vgg"][1], map_location=device, weights_only=True))
    tiles = torch.from_numpy(pkg["dataset"].MRIDataset(meta).fully_tiles[:TRAIN_BATCH])
    with torch.no_grad():
        feats = vgg_ae.trunk(tiles.to(device))
    print(f"vgg autoencoder's trunk features on {TRAIN_BATCH} train tiles: mean "
          f"{float(feats.mean()):.6f}, max {float(feats.max()):.6f} (a mean above about 1 "
          "puts the spliced SIREN where it cannot train; see AE_LR)")
    del vgg_ae, feats
    conv_losses = ae["conv"]["losses"]
    check(conv_losses[1] < conv_losses[0], f"conv autoencoder loss did not fall: {conv_losses}")
    rows = te.main(["--dataset", str(meta), "--output", str(tmp / "ae_eval"), "--model", "conv",
                    "--evaluate", str(files["conv"][1]), "--num-samples", "2"])
    cpu_rows = te.main(["--dataset", str(meta), "--output", str(tmp / "ae_eval_cpu"),
                        "--model", "conv", "--evaluate", str(files["conv"][1]),
                        "--num-samples", "1", "--device", "cpu"])
    check((tmp / "ae_eval" / "ae_metrics.csv").is_file(), "ae_metrics.csv missing")
    check(all(np.isfinite(list(m.values())).all() for _, m in rows), "non-finite AE metrics")
    dpsnr = abs(rows[0][1]["psnr"] - cpu_rows[0][1]["psnr"])
    print("train_encoder --evaluate (conv, 2 epochs): " + "; ".join(
        f"{sid} PSNR {m['psnr']:.4f} SSIM {m['ssim']:.4f} NRMSE {m['nrmse']:.4f}"
        for sid, m in rows) + f"; card vs CPU on {cpu_rows[0][0]}: |dPSNR| {dpsnr:.2e} "
        "(<= 1e-3) dB")
    check(dpsnr <= 1e-3, "autoencoder evaluation: card and CPU disagree")

    base = ["--config", str(REPO / "configs" / "train.yaml"),
            "--set", f"data.train.dataset={meta}", "--set", f"data.val.dataset={val_meta}",
            "--set", "training.save_interval=1000", "--set", "training.device_data=true"]

    def argv(name, epochs, *extra):
        sets = [f"training.output_dir={tmp / 'pretrain_out'}", f"training.output_name={name}",
                f"training.epochs={epochs}", *extra]
        return base + [x for item in sets for x in ("--set", item)]

    runs = {
        "conv": (2, f"model.encoder_path={files['conv'][0]}"),
        "vgg": (2, "model.encoder_type=vgg", f"model.encoder_path={files['vgg'][0]}"),
        "perceptual": (2, "training.criterion=perceptual",
                       f"training.perceptual_encoder_path={files['perceptual'][0]}"),
        "low_memory": (1, "data.low_memory=true"),
    }
    # the CPU's initial validation losses, in a thread beside the card's runs
    # (they need only the autoencoders' files)
    cpu_pool = ThreadPoolExecutor(1)
    cpu_futures = {name: cpu_pool.submit(initial_val_loss, pkg, argv(name, epochs, *extra), "cpu")
                   for name, (epochs, *extra) in runs.items()}
    # the splice, before the first step: the SIREN's encoder is the autoencoder's
    spliced = cli.main(argv("conv_splice", 0, *runs["conv"][1:]))
    want = torch.load(files["conv"][0], map_location="cpu", weights_only=True)
    for k, v in spliced.model.encoder.encoder.state_dict().items():
        check(torch.equal(v.cpu(), want[f"encoder.{k}"]), f"spliced encoder {k}")
    trainers = {name: cli.main(argv(name, epochs, *extra))
                for name, (epochs, *extra) in runs.items()}
    torch.cuda.synchronize()
    fwd_n, bwd_n, eval_n = (k.launches for k in counters)
    steps = sum(t.state.step for t in trainers.values())
    print(f"pretraining path: autoencoders {', '.join(f'{n} {e} epoch(s)' for n, e in AE_EPOCHS.items())}"
          f"; train CLI runs {', '.join(f'{n} {t.state.step} steps' for n, t in trainers.items())}"
          f" -> train fwd launches {fwd_n}, train bwd launches {bwd_n}, eval forward launches "
          f"{eval_n}; CUDA graphs (captures, replays): " + ", ".join(
              f"{n} ({t.scan_epoch.captures}, {t.scan_epoch.replays})"
              for n, t in trainers.items()))
    check(fwd_n == bwd_n == steps, f"train kernel launches {fwd_n} / {bwd_n} for {steps} steps")
    check(eval_n > 0, "no eval forward launch on the pretraining path")
    for name in ("conv", "vgg", "perceptual"):
        t = trainers[name]
        check(t.scan_epoch.replays > 0, f"{name}: no graph replay")
        first, last = t.initial_losses[0], t._progress[-1]["train_loss"]
        check(last < first, f"{name}: train loss {last} not below the initial {first}")
    check(trainers["low_memory"].scan_epoch.replays == 0 and
          type(trainers["low_memory"].train_dataset).__name__ == "MRIDatasetLowMemory",
          "the low-memory run did not run step by step")
    enc = trainers["vgg"].model.encoder.encoder
    check(type(enc).__name__ == "VGGEncoder", "vgg run without a VGG encoder")

    # each run's initial validation loss against the CPU's (the splice run and
    # the conv run start from the same model)
    cpu_val = {name: f.result() for name, f in cpu_futures.items()}
    cpu_pool.shutdown()
    relative = lambda a, b: abs(a - b) / abs(b)
    for name, t in [("conv_splice", spliced), *trainers.items()]:
        run = name.replace("_splice", "")
        card_val, want_val = t.initial_losses[1], cpu_val[run]
        rel = relative(card_val, want_val)
        print(f"{name}: initial validation loss card {card_val:.8f}, CPU {want_val:.8f}, "
              f"relative {rel:.2e} (<= {INITIAL_LOSS_BAR:g}); losses " + "; ".join(
                  f"epoch {r['epoch']} train {r['train_loss']:.6f} val {r['val_loss']:.6f}"
                  for r in t._progress))
        if rel > INITIAL_LOSS_BAR and name != "conv_splice":
            fp32 = argv(run, runs[run][0], *runs[run][1:])
            card32, cpu32 = (initial_val_loss(pkg, fp32, d, "training.precision=fp32")
                             for d in (device, "cpu"))
            print(f"{name} in fp32: card {card32:.8f}, CPU {cpu32:.8f}, relative "
                  f"{relative(card32, cpu32):.2e} (<= {INITIAL_LOSS_BAR:g}); the bf16 gap "
                  f"{rel:.2e} (<= {BF16_DEEP_BAR:g}); the CPU's bf16 loss is "
                  f"{relative(want_val, cpu32):.2e} from its fp32 loss")
            check(relative(card32, cpu32) <= INITIAL_LOSS_BAR and rel <= BF16_DEEP_BAR,
                  f"{name}: initial validation loss card vs CPU")
        else:
            check(rel <= INITIAL_LOSS_BAR, f"{name}: initial validation loss card vs CPU")
    pretrain_seconds = time.perf_counter() - t_phase

    # rates, after the counts were read
    for name, res in ae.items():
        secs = res["epoch_seconds"]
        print(f"train_encoder --model {name}: {len(secs)} epoch(s) of "
              f"{res['steps_per_epoch']} steps at batch 256, last epoch {secs[-1]:.4f} s = "
              f"{1 / secs[-1]:.3f} epochs/s (the first epoch includes cuDNN's first calls) "
              f"[{card}]")
    for name in ("vgg", "perceptual"):
        t = trainers[name]
        n = -(-len(t.train_dataset) // t.batch_size)
        secs = []
        for epoch in range(2, 5):  # replays of the run's train graph
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._epoch_loss(t.train_dataset, train=True, epoch=epoch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs)
        print(f"train CLI run {name}: a graphed train epoch ({n} steps of {t.batch_size}) "
              f"{med * 1e3:.4f} ms, median of 3 = {n / med:.2f} steps/s; its CLI epochs "
              f"(eager; capture + replay, with validation) " + ", ".join(
                  f"{r['epoch_seconds']:.4f} s" for r in t._progress) + f" [{card}]")
        # where a step's device time goes: one more replayed epoch, profiled
        prof = profile_device(lambda: t._epoch_loss(t.train_dataset, train=True, epoch=5),
                              reps=1)
        if prof is None:
            print(f"train CLI run {name}: device time by kernel not measured (no device "
                  "activity recorded)")
            continue
        print(f"train CLI run {name}, a graphed epoch under the profiler: wall "
              f"{prof['wall_ms']:.4f} ms, device busy {prof['busy_ms']:.4f} ms; top kernels "
              f"per step [{card}]:")
        for kname, ms_ in prof["kernels"][:6]:
            print(f"  {ms_ / n:8.4f} ms  {kname[:110]}")
    print(f"pretraining phase: {pretrain_seconds:.1f} s up to the checks, "
          f"{time.perf_counter() - t_phase:.1f} s with the rates")
    return {"fwd": fwd_n, "bwd": bwd_n, "eval": eval_n}


# ---------------------------------------------------------------- phase 11
ONLINE_VOLUMES, ONLINE_VAL_VOLUMES, ONLINE_SLICES = 8, 2, 16
ONLINE_EPOCHS = 3  # the first eager, the second captured and replayed, the third replayed
SWEEP_STEMS, SWEEP_SLICES = 60, 940  # the reference's 940-slice sweep
# online tiles against the offline pipeline's on the card: the same masks,
# the same kernel, the same normalisation, so 0 is expected; 2e-6 is the
# JAX package's bar for the same comparison
ONLINE_PARITY_BAR = 2e-6


def phantom_kspace(pkg, indices) -> list:
    """Complex (ONLINE_SLICES, SLICE_SIZE, SLICE_SIZE) phantom volumes, made
    in threads."""
    syn = pkg["synthetic"]
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda v: syn.synthetic_kspace(v, ONLINE_SLICES, SLICE_SIZE,
                                                            SLICE_SIZE, texture=0.2), indices))


def online_datasets(pkg, cfg, device, train, val):
    """The train and validation splits of ``cfg`` as the train CLI makes them
    online (the train split remasks as configured, validation never), from
    in-memory (stems, volumes) pairs: this machine has no ``h5py``."""
    dcfg, mcfg = cfg.data, cfg.model

    def make(split, stems_vols, remask):
        return pkg["online"].OnlineKspaceDataset.from_volumes(
            *stems_vols, center_fraction=dcfg.center_fraction, acceleration=dcfg.acceleration,
            max_slice_num=split.max_slice_num, num_samples=split.num_samples, seed=split.seed,
            outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size,
            remask_each_epoch=remask, device=device)

    return make(dcfg.train, train, dcfg.train.remask_each_epoch), make(dcfg.val, val, False)


def online_path(pkg, tmp: pathlib.Path, device, card: str) -> dict:
    """The online k-space path: configs/train_online.yaml's training through
    the graphed epoch, offline parity on the card, and the 940-slice online
    device sweep of configs/test.yaml's model."""
    t_phase = time.perf_counter()
    syn = pkg["synthetic"]
    t0 = time.perf_counter()
    vols = phantom_kspace(pkg, range(300, 300 + ONLINE_VOLUMES + ONLINE_VAL_VOLUMES))
    stems = [syn.synthetic_stem(v) for v in range(300, 300 + len(vols))]
    train = (stems[:ONLINE_VOLUMES], vols[:ONLINE_VOLUMES])
    val = (stems[ONLINE_VOLUMES:], vols[ONLINE_VOLUMES:])
    print(f"online phase: {len(vols)} phantom volumes of {ONLINE_SLICES} x {SLICE_SIZE} x "
          f"{SLICE_SIZE} k-space made on the host in {time.perf_counter() - t0:.2f} s")
    out = online_train(pkg, tmp, device, card, train, val)
    out["parity"] = online_parity(pkg, tmp, device, train)
    out["sweep"] = online_sweep(pkg, tmp, device, card, train[1])
    print(f"online phase: {time.perf_counter() - t_phase:.1f} s wall [{card}]")
    return out


def online_train(pkg, tmp: pathlib.Path, device, card: str, train, val) -> dict:
    fk, stk, sk = pkg["fk"], pkg["stk"], pkg["sk"]
    cfg = pkg["config"].load_train_configuration(
        REPO / "configs" / "train_online.yaml",
        [f"training.epochs={ONLINE_EPOCHS}", f"training.output_dir={tmp / 'online_out'}"])
    tcfg, mcfg = cfg.training, cfg.model
    print(f"online training, configs/train_online.yaml: H={mcfg.dim_hidden} latent="
          f"{mcfg.latent_dim} L={mcfg.num_layers} dropout={mcfg.dropout} batch "
          f"{tcfg.batch_size} {tcfg.optimizer} {tcfg.lr:g} {tcfg.criterion} {tcfg.precision} "
          f"device_data={tcfg.device_data} remask={cfg.data.train.remask_each_epoch}")

    def run(name, device_data, record=None):
        train_ds, val_ds = online_datasets(pkg, cfg, device, train, val)
        if record is not None:  # keep each mask epoch's tiles as the trainer got them
            materialize = train_ds.materialize

            def recording(epoch):
                fully, under = materialize(epoch)
                if int(epoch) not in record:
                    record[int(epoch)] = (fully.data_ptr(), under.data_ptr(), under.clone())
                return fully, under

            train_ds.materialize = recording
        run_cfg = copy.deepcopy(cfg)
        run_cfg.training.device_data = device_data
        t = pkg["cli_train"].make_trainer(run_cfg, train_ds, val_ds, tmp / "online" / name,
                                          device, log=lambda *_: None)
        t.initial_errors()
        t.train(ONLINE_EPOCHS)
        curve = list(t.initial_losses) + [r[k] for r in t._progress
                                          for k in ("train_loss", "val_loss")]
        flat = torch.cat([q.detach().reshape(-1) for q in t.model.parameters()])
        return np.array(curve), flat, t

    # ---- the main path, counted
    counters = (fk.dft2c_ri_cuda, stk.siren_chain_train_fwd_cuda,
                stk.siren_chain_train_bwd_cuda, sk.siren_forward_cuda)
    seen: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    lc, pc, tc = run("graphed", True, record=seen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dft_n, fwd_n, bwd_n, eval_n = (k.launches for k in counters)
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    train_ds, val_ds = tc.train_dataset, tc.val_dataset
    del train_ds.materialize  # the recording wrapper: the class's method again
    per_epoch = -(-len(train_ds) // tcfg.batch_size)
    val_batches = -(-len(val_ds) // tcfg.batch_size)
    graphs = (tc.scan_epoch.captures, tc.scan_epoch.replays)
    print(f"online training: {len(train_ds.slice_ids)} train slices ({len(train_ds)} patches, "
          f"{per_epoch} steps an epoch), {len(val_ds.slice_ids)} val slices ({val_batches} "
          f"batches); initial errors + {ONLINE_EPOCHS} epochs in {secs:.2f} s -> dft2c "
          f"launches {dft_n}, train fwd {fwd_n}, train bwd {bwd_n}, eval forward {eval_n}; "
          f"CUDA graphs (captures, replays) {graphs}; peak device memory {peak_mb:.1f} MiB "
          f"above the {base_mem / 2**20:.1f} MiB held before [{card}]")
    check(per_epoch == 88 and val_batches == 5, f"{per_epoch} steps, {val_batches} val batches")
    # (a) one capture per (dataset, mode): the train set's train epochs and the
    # val set's eval epochs; the train set's one eval epoch (the initial
    # error) runs eagerly, as does each mode's first epoch
    check(graphs == (2, ONLINE_EPOCHS - 1 + ONLINE_EPOCHS), f"graphs {graphs}")
    # (c) fully sampled once per dataset, undersampled once per mask epoch:
    # the train set's epochs 0-2, the val set's fixed masks once
    want_dft = 2 + ONLINE_EPOCHS + 1
    check(dft_n == want_dft, f"dft2c launches {dft_n}, expected {want_dft}")
    check(fwd_n == bwd_n == ONLINE_EPOCHS * per_epoch, "train kernel launches != train steps")
    check(eval_n == per_epoch + val_batches * (1 + ONLINE_EPOCHS), f"eval launches {eval_n}")
    # (d) the tiles: one buffer, new undersampled tiles each epoch
    check(sorted(seen) == list(range(ONLINE_EPOCHS)), f"mask epochs {sorted(seen)}")
    check(len({(f, u) for f, u, _ in seen.values()}) == 1, "the tiles moved between epochs")
    for e in range(1, ONLINE_EPOCHS):
        check(not torch.equal(seen[e][2], seen[e - 1][2]),
              f"epoch {e}'s undersampled tiles equal epoch {e - 1}'s")
    fully0 = train_ds._fully.clone()
    _, again = train_ds.materialize(0)
    check(torch.equal(again, seen[0][2]), "materialising epoch 0 again differs")
    check(torch.equal(train_ds.materialize(1)[0], fully0), "the fully sampled tiles moved")
    # (e) the loss falls
    logs = tc._progress
    check(bool(np.isfinite(lc).all()), f"non-finite loss in {lc}")
    check(logs[-1]["train_loss"] < tc.initial_losses[0], "the online train loss did not fall")
    print("online losses: initial train {:.6f} val {:.6f}; ".format(*tc.initial_losses)
          + "; ".join(f"epoch {r['epoch']} train {r['train_loss']:.6f} val "
                      f"{r['val_loss']:.6f}" for r in logs))

    # (b) the per-step loop over the same materialised tiles (host batches)
    with scan_seeds(pkg["trainer"]):
        (la, pa, _), (lb, pb, _) = run("per_step_a", False), run("per_step_b", False)
    spread = (float(np.abs(la - lb).max()), (pa - pb).abs().max().item())
    gap = (float(np.abs(lc - la).max()), (pc - pa).abs().max().item())
    repeats = spread == (0.0, 0.0)
    print(f"online training, graphed vs the per-step loop: max |d loss| {gap[0]:.3e}, max |d "
          f"parameter| {gap[1]:.3e}; two per-step runs apart {spread[0]:.3e} / "
          f"{spread[1]:.3e} ({'bit for bit' if repeats else 'not bit for bit'})")
    if repeats:
        check(gap == (0.0, 0.0), "online: the graphed run differs from a repeating loop")
    else:
        check(gap[0] <= 2 * spread[0] and gap[1] <= 2 * spread[1],
              "online: the graphed run is further from the loop than its repeatability")

    # steady: graphed epochs (materialisation + 88-step train replay) and the
    # materialisation alone, after the counts were read
    walls = []
    epoch = ONLINE_EPOCHS
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tc._epoch_loss(train_ds, train=True, epoch=epoch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        epoch += 1
    fresh = iter(range(100, 1000))
    mat_ms = cuda_median_ms(lambda: train_ds.materialize(next(fresh)), reps=5, warmup=1)
    dft_ms = cuda_median_ms(lambda: pkg["fk"].reconstruct_magnitude_ri_dft(train_ds._k),
                            reps=5, warmup=1)
    wall = statistics.median(walls)
    nsl = train_ds._k.shape[0] * train_ds._k.shape[1]
    print(f"online train epoch, graphed ({per_epoch} steps of {tcfg.batch_size}, its mask "
          f"epoch materialised first), median of 3: {wall * 1e3:.4f} ms = "
          f"{per_epoch / wall:.2f} steps/s; materialisation alone (masks drawn and uploaded, "
          f"one dft2c over {nsl} slices, min-max, select, tiles into the buffer) "
          f"{mat_ms:.4f} ms, of which dft2c {dft_ms:.4f} ms (CUDA events, median of 5) "
          f"[{card}]")
    return {"dft": dft_n, "fwd": fwd_n, "bwd": bwd_n, "eval": eval_n, "peak_mb": peak_mb,
            "epoch_ms": wall * 1e3, "steps_per_sec": per_epoch / wall, "mat_ms": mat_ms,
            "dft_ms": dft_ms}


def online_parity(pkg, tmp: pathlib.Path, device, train) -> float:
    """Remask off, two 16-slice volumes with max_slice_num 10 (the filter
    after the normalisation): the online tiles against MRIDataset over the
    port's offline preprocessing of the same volumes, both on the card."""
    cf, acc = MASKS[0]
    stems, vols = train[0][:2], train[1][:2]
    online = pkg["online"].OnlineKspaceDataset.from_volumes(
        stems, vols, center_fraction=cf, acceleration=acc, max_slice_num=10,
        remask_each_epoch=False, device=device)
    fully, under = (t.cpu().numpy() for t in online.materialize(0))
    rows = []
    for stem, vol in zip(stems, vols):
        rows += pkg["preprocessing"].process_kspace_volume(vol, stem, tmp / "online_parity",
                                                           [(cf, acc)], device=device)
    offline = pkg["dataset"].MRIDataset(
        pkg["preprocessing"].write_metadata(rows, tmp / "online_parity"), center_fraction=cf,
        acceleration=acc, max_slice_num=10)
    check(fully.shape == offline.fully_tiles.shape, f"{fully.shape} vs offline")
    gap = max(float(np.abs(fully - offline.fully_tiles).max()),
              float(np.abs(under - offline.under_tiles).max()))
    print(f"online vs offline tiles on the card, 2 volumes of {ONLINE_SLICES} slices, "
          f"max_slice_num 10 ({len(online.slice_ids)} slices kept after the volume "
          f"min-max): max |diff| {gap:.3e} (<= {ONLINE_PARITY_BAR:g})")
    check(gap <= ONLINE_PARITY_BAR, "online and offline tiles disagree")
    return gap


def online_sweep(pkg, tmp: pathlib.Path, device, card: str, vols) -> dict:
    """configs/test.yaml's model through OnlineSampler -> evaluate_files_device
    over 940 of 60 x 16 slices (the stems cycle through the 8 train volumes'
    k-space; each stem's masks are its own), against the offline device
    sweep of the same volumes and two slices on the CPU."""
    ev, fk, sk, syn = pkg["ev"], pkg["fk"], pkg["sk"], pkg["synthetic"]
    cfg = pkg["config"].load_test_configuration(REPO / "configs" / "test.yaml",
                                                ["data.max_slice_num=null"])
    mcfg, ecfg = cfg.model, cfg.data
    model = pkg["ms"].from_config(mcfg, generator=torch.Generator().manual_seed(SEED),
                                  device=device)

    def pipeline(m, dev):
        apply_fn = sk.make_apply_fn(m, use_pallas=mcfg.use_pallas, sin_bf16=ecfg.sin_bf16,
                                    sin5=ecfg.sin5, ksplit=ecfg.ksplit, device=dev)
        return ev.SliceReconstructor(apply_fn, outer_patch_size=mcfg.outer_patch_size,
                                     inner_patch_size=mcfg.inner_patch_size,
                                     siren_patch_size=mcfg.siren_patch_size,
                                     patch_bucket=ecfg.batch_patches, device=dev)

    recon = pipeline(model, device)
    stems = [syn.synthetic_stem(500 + i) for i in range(SWEEP_STEMS)]
    sweep_vols = [vols[i % len(vols)] for i in range(SWEEP_STEMS)]
    cf, acc = ecfg.center_fraction, ecfg.acceleration

    # ---- the main path, counted: k-space upload, epoch-0 image stacks (one
    # dft2c each), the sweep
    counters = (fk.dft2c_ri_cuda, sk.siren_forward_cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    ds = pkg["online"].OnlineKspaceDataset.from_volumes(
        stems, sweep_vols, center_fraction=cf, acceleration=acc, max_slice_num=None,
        outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size,
        remask_each_epoch=False, device=device)
    upload_s = time.perf_counter() - t0
    sampler = pkg["online"].OnlineSampler(ds, num_samples=SWEEP_SLICES, host_prefetch=False)
    rows, timings = ev.evaluate_files_device(recon, sampler, log=lambda *_: None)
    torch.cuda.synchronize()
    dft_n, fwd_n = (k.launches for k in counters)
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    pieces = sweep_pieces(ev, SWEEP_SLICES)
    print(f"online sweep: {SWEEP_STEMS} stems x {ONLINE_SLICES} slices, k-space "
          f"{ds._k.numel() * 4 / 2**30:.2f} GiB packed and uploaded in {upload_s:.2f} s; "
          f"{len(rows)} slices scored in {pieces} batched pieces -> dft2c launches {dft_n}, "
          f"siren_forward launches {fwd_n}; stage {timings['stage_seconds']:.4f} s (the two "
          f"image stacks made on the card), dispatch {timings['dispatch_seconds']:.4f} s, "
          f"execute+fetch {timings['execute_fetch_seconds']:.4f} s; peak device memory "
          f"{peak_mb:.1f} MiB above the {base_mem / 2**20:.1f} MiB held before [{card}]")
    check(dft_n == 2 and fwd_n == pieces, f"launches {dft_n}, {fwd_n}")
    order = pkg["dataset"].sampler_order(len(ds.slice_ids), 42, SWEEP_SLICES)
    check([r.slice_id for r in rows] == [ds.slice_id(i) for i in order],
          "rows not in sampler order")
    check(ds._imgs_np is None and not ds._slice_cache, "image data crossed to the host")
    check(all(np.isfinite([r.psnr, r.ssim, r.nrmse]).all() for r in rows), "non-finite rows")

    # the offline device sweep over the same slices
    off_dir = tmp / "online_sweep_offline"
    meta_rows = []
    for stem, vol in zip(stems, sweep_vols):
        meta_rows += pkg["preprocessing"].process_kspace_volume(vol, stem, off_dir, [(cf, acc)],
                                                                device=device)
    meta = pkg["preprocessing"].write_metadata(meta_rows, off_dir)
    off_sampler = pkg["dataset"].MRISampler(meta, center_fraction=cf, acceleration=acc,
                                            mri_type=ecfg.mri_type, max_slice_num=None,
                                            num_samples=SWEEP_SLICES)
    off_rows, _ = ev.evaluate_files_device(recon, off_sampler, log=lambda *_: None)
    check([r.slice_id for r in off_rows] == [r.slice_id for r in rows],
          "offline and online sweeps score other slices")
    worst = np.max([[abs(a.psnr - b.psnr), abs(a.ssim - b.ssim), abs(a.nrmse - b.nrmse)]
                    for a, b in zip(rows, off_rows)], axis=0)
    print(f"online vs offline device sweep, {len(rows)} rows in the same order: max |d PSNR| "
          f"{worst[0]:.3e} (<= 0.05), |d SSIM| {worst[1]:.3e}, |d NRMSE| {worst[2]:.3e} "
          f"(<= 1e-3)")
    check(worst[0] <= 0.05 and worst[1] <= 1e-3 and worst[2] <= 1e-3,
          "online and offline sweeps disagree")

    # two slices on the CPU through the plain versions
    cpu_recon = pipeline(copy.deepcopy(model).to("cpu"), "cpu")
    for r in rows[:2]:
        pair = ds.get_slice(order[rows.index(r)])
        check(pair.slice_id == r.slice_id, "get_slice order")
        m = {k: float(v) for k, v in cpu_recon(pair.fully_sampled, pair.undersampled)[3].items()}
        dp, ds_, dn = abs(m["psnr"] - r.psnr), abs(m["ssim"] - r.ssim), abs(m["nrmse"] - r.nrmse)
        print(f"online sweep, cpu vs card [{r.slice_id}]: PSNR {m['psnr']:.4f} vs {r.psnr:.4f} "
              f"(|d| {dp:.2e} <= 0.05), SSIM |d| {ds_:.2e}, NRMSE |d| {dn:.2e} (<= 1e-3)")
        check(dp <= 0.05 and ds_ <= 1e-3 and dn <= 1e-3, "online sweep CPU cross-check")

    # steady sweeps (the image stacks cached), stage excluded
    rates = []
    for _ in range(5):
        s = pkg["online"].OnlineSampler(ds, num_samples=SWEEP_SLICES, host_prefetch=False)
        t = ev.evaluate_files_device(recon, s, log=lambda *_: None)[1]
        rates.append(SWEEP_SLICES / (t["dispatch_seconds"] + t["execute_fetch_seconds"]))
    dft_ms = cuda_median_ms(lambda: fk.reconstruct_magnitude_ri_dft(ds._k), reps=5, warmup=1)
    mat_ms = cuda_median_ms(lambda: ds._images(0), reps=5, warmup=1)
    nsl = ds._k.shape[0] * ds._k.shape[1]
    print(f"online sweep steady: median {statistics.median(rates):.2f} slices/s (min "
          f"{min(rates):.2f}, max {max(rates):.2f}; 5 sweeps, stage excluded); dft2c over the "
          f"{nsl}-slice corpus {dft_ms:.4f} ms, the undersampled image stack's whole "
          f"materialisation {mat_ms:.4f} ms (CUDA events, median of 5) [{card}]")
    return {"dft": dft_n, "eval": fwd_n, "peak_mb": peak_mb,
            "slices_per_sec": statistics.median(rates), "dft_ms": dft_ms, "mat_ms": mat_ms,
            "worst": worst.tolist()}


# --------------------------------------------------------------- phase 13
RANKS = 2  # processes sharing the one card
RANK_CARD = "cuda:0"
# The shapes phase 13 gives the kernels on each rank: a local train (and
# validation) batch of TRAIN_BATCH / RANKS, and one eval piece of 3,200
# patches (the halo fold: 16 slices' bands of 10 x 20 patch rows; --devices
# 2: 8 whole slices of 20 x 20).
LOCAL_BATCH = TRAIN_BATCH // RANKS
BAND_PATCHES = VOLUMES * SLICES_PER_VOLUME * (SLICE_SIZE // 16) ** 2 // RANKS
RANK_TIMEOUT = 600  # seconds a launch of the ranks may take
DP_SEED = 11  # the base seed of phase 13's data-parallel steps
DP_STEP_BAR = 1e-6  # the 2-rank dropout step against its emulation
# one 2-rank SGD step (lr 1e-2, dropout off) against the one-process step,
# the JAX package's own bars (tests/test_sharding.py): loss relative, params
DP_SGD_LOSS_BAR, DP_SGD_PARAM_BAR = 1e-4, 1e-5
# three epochs of Adam through the CLI, per-epoch losses relative: the 2
# ranks against one process stepping on the ranks' two halves of every batch
# (the ranks' own arithmetic, tests/torch_port_ranks.halves_step_body)
MULTIRANK_HALVES_BAR = 1e-5
# and against one process on the whole batch, whose sum runs in another
# order: each half's bf16 gradient is rounded apart and Adam carries the
# rounding on. A bar between the sound reading and that of a planted fault
# the ranks could share with their witness, every rank stepping on rank 0's
# rows, both read on an H100 (700 W) by scripts/torch_multirank_probe.py:
# 2.754e-3 and 2.966e-2 (the sound gap 6.2e-4 on the torch generator's
# earlier weights); the fault is run again here and must exceed the bar
MULTIRANK_WHOLE_BAR = 9e-3
# the test CLI's rows against the one-process rows (PSNR dB, SSIM, NRMSE):
# --devices 2 (libraries' kernels at another batch) and the halo fold
DP_ROW_BAR = 1e-5
HALO_ROW_BAR = 1e-6


def launch_ranks(tmp: pathlib.Path, tag: str, job: str, argv: list[str],
                 rank_args: dict | None = None) -> list[dict]:
    """Start RANKS processes of ``python chip_smoke.py --rank JOB REPORT
    ARGV``, joined through the ``MRI_INR_*`` route (rank 0 serving the
    rendezvous on a free local port), each on cuda:0, and return their
    reports (with their stdout). A rank that fails, or a launch that
    outlives RANK_TIMEOUT, fails the phase with every rank's stderr; no rank
    is left running."""
    d = tmp / f"ranks_{tag}"
    d.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    with socket.socket() as s:  # a free port, which rank 0 binds next
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env.update(MRI_INR_COORDINATOR=f"127.0.0.1:{port}",
               MRI_INR_NUM_PROCESSES=str(RANKS), MRI_INR_DIST_TIMEOUT="300")
    procs = []
    for r in range(RANKS):
        cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--rank", job,
               str(d / f"report{r}.json"), *argv, *(rank_args or {}).get(r, [])]
        with open(d / f"rank{r}.out", "w") as out, open(d / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=err,
                                          env={**env, "MRI_INR_PROCESS_ID": str(r)}))
    deadline, codes = time.monotonic() + RANK_TIMEOUT, []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * RANKS:
        tails = "\n".join(f"--- rank {r}:\n" + (d / f"rank{r}.err").read_text()[-4000:]
                          for r in range(RANKS))
        raise RuntimeError(f"check failed: {tag}: rank exit codes {codes}\n{tails}")
    reports = []
    for r in range(RANKS):
        rep = json.loads((d / f"report{r}.json").read_text())
        rep["stdout"] = (d / f"rank{r}.out").read_text()
        reports.append(rep)
    return reports


def dp_state(config, cli_train, trainer, device, dropout: str, optimizer: str, lr: str,
             precision: str = "bf16"):
    """configs/train.yaml's seeded model (with this dropout and precision)
    and a train state with this optimizer and learning rate."""
    cfg = config.load_train_configuration(REPO / "configs" / "train.yaml",
                                          [f"model.dropout={dropout}",
                                           f"training.precision={precision}"])
    model = cli_train.build_model(cfg, device, log=lambda *_: None)
    return cfg, trainer.create_train_state(model, optimizer, float(lr))


def flat_params(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()


def dp_batch(device) -> tuple:
    """The global batch of phase 13's dropout step (seeded)."""
    g = torch.Generator().manual_seed(DP_SEED)
    return tuple(torch.rand((TRAIN_BATCH, 32, 32), generator=g).to(device) for _ in range(2))


def rank_worker(args: list[str]) -> int:
    """One rank of phase 13: ``--rank JOB REPORT [ARGS...]``. JOB ``train`` and
    ``test`` call the CLI's ``main`` with ARGS (the entry point a user's
    rank runs, here on cuda:0), ``step DROPOUT OPTIMIZER LR [PRECISION]`` one
    data-parallel train step of configs/train.yaml's model with those
    settings; every launch counter starts at 0. Times each
    gradient all-reduce on the host's clock in two parts (the wait for the
    peer, the reduction proper), the reduction's two copies alone at its
    size, and each epoch with the trainer's own clock, and writes REPORT
    (JSON; ``step`` also the parameters)."""
    job, report, argv = args[0], pathlib.Path(args[1]), args[2:]
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from mri_inr_tpu_torch.cli import test as cli_test
    from mri_inr_tpu_torch.cli import train as cli_train
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.parallel import distributed, halo_fold
    from mri_inr_tpu_torch.train import losses, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"siren_train_fwd": stk.siren_chain_train_fwd_cuda,
               "siren_train_bwd": stk.siren_chain_train_bwd_cuda,
               "siren_forward": sk.siren_forward_cuda}
    for k in kernels.values():
        k.launches = 0
    waits, reduces, sizes, epochs = [], [], [], []
    reduce, post = distributed.all_reduce_mean_, trainer.Trainer._post_epoch

    def timed_reduce(t, group):
        if t.numel() == 1:  # a validation loss, not a step's gradients
            return reduce(t, group)
        # on the host's clock: the wait for the peer rank (its step's
        # compute on the shared card, then a barrier), then the reduction
        # proper once both have arrived (copy to the host, gloo's
        # all-reduce, division, copy back)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.barrier(group=group)
        t1 = time.perf_counter()
        out = reduce(t, group)
        torch.cuda.synchronize()
        waits.append(1e3 * (t1 - t0))
        reduces.append(1e3 * (time.perf_counter() - t1))
        sizes.append(t.numel())
        return out

    def timed_epoch(self, epoch, train_loss, val_loss, secs):
        epochs.append((epoch, secs, -(-len(self.train_dataset) // self.batch_size)))
        return post(self, epoch, train_loss, val_loss, secs)

    distributed.all_reduce_mean_, trainer.Trainer._post_epoch = timed_reduce, timed_epoch
    out: dict = {}
    try:
        if job == "train":
            t = cli_train.main(argv + ["--device", RANK_CARD])
            out["steps"] = t.state.step
        elif job == "test":
            out["rows"] = len(cli_test.main(argv + ["--device", RANK_CARD]))
        else:
            device = distributed.initialize(RANK_CARD)
            cfg, state = dp_state(config, cli_train, trainer, device, *argv)
            step = trainer.make_train_step(state.model, losses.mse, 32, 24, use_pallas=True,
                                           sin5=cfg.training.sin5,
                                           group=distributed.collective_group())
            out["loss"] = float(step(state, *dp_batch(device), DP_SEED))
            np.save(report.with_suffix(".npy"), flat_params(state.model))
        torch.cuda.synchronize()
        out.update(rank=distributed.process_index(),
                   launches={n: k.launches for n, k in kernels.items()}, epochs=epochs,
                   wait_ms=waits, reduce_ms=reduces, exchange=dict(halo_fold.exchange_stats))
        if sizes:  # the reduction's two copies alone, at its size, after the run
            flat, copies = torch.zeros(sizes[0], device=RANK_CARD), []
            for _ in range(20):
                t0 = time.perf_counter()
                flat.copy_(flat.cpu())
                torch.cuda.synchronize()
                copies.append(1e3 * (time.perf_counter() - t0))
            out.update(copy_ms=statistics.median(copies), reduce_floats=sizes[0])
    finally:
        distributed.shutdown()
    report.write_text(json.dumps(out))
    return 0


def witness_runs(pkg, tmp: pathlib.Path, train_argv: list[str], tag: str,
                 fault: bool = False, epochs: int = 3) -> dict:
    """Phase 13's one-process runs of the train CLI for ``epochs`` epochs, as
    (train loss, validation loss) an epoch: ``whole``, on the whole batch;
    ``halves``, every step's gradients computed on the ranks' two halves of
    the batch and averaged as the collective does
    (``tests/torch_port_ranks.halves_step_body``); and where ``fault`` is
    set, ``fault``: the same, but every rank taking rank 0's rows."""
    cli_train, trainer = pkg["cli_train"], pkg["trainer"]
    sys.path.insert(0, str(REPO / "tests"))
    import torch_port_ranks

    def run(name: str):
        return [(r["train_loss"], r["val_loss"]) for r in cli_train.main(train_argv + [
            "--set", f"training.output_dir={tmp / f'dp_{name}_{tag}'}",
            "--set", f"training.epochs={epochs}"])._progress]

    out = {"whole": run("whole")}
    make_body = trainer._make_step_body
    try:
        for name, rows_of in (("halves", None), ("fault", lambda r: 0))[:1 + fault]:
            trainer._make_step_body = torch_port_ranks.halves_step_body(RANKS, rows_of)
            out[name] = run(name)
    finally:
        trainer._make_step_body = make_body
    return out


GRAD_GROUPS = (("encoder", lambda n: n.startswith("encoder.")),
               ("modulator", lambda n: n.startswith("modulator.")),
               ("SIREN weights", lambda n: n.startswith("net.") and n.endswith("weight")),
               ("SIREN biases", lambda n: n.startswith("net.") and n.endswith("bias")))


def halves_gradient_gap(pkg, device) -> dict:
    """One fp32 step's gradients of configs/train.yaml's seeded model (dropout
    off, the fused route) on phase 13's global batch, against the mean of
    the gradients of its ranks' two halves, summed in rank order as the
    all-reduce sums them: per parameter group the relative gap
    ``|halves - whole| / |whole|`` (norms over the group) and the largest
    element's gap. A reading only: it checks nothing."""
    cli_train, trainer, stk, losses = pkg["cli_train"], pkg["trainer"], pkg["stk"], pkg["losses"]
    cfg, state = dp_state(pkg["config"], cli_train, trainer, device, "0.0", "sgd", "1e-2", "fp32")
    model = state.model
    fully, under = dp_batch(device)

    def grads(f, u) -> dict:
        model.zero_grad(set_to_none=True)
        pred = stk.fused_train_apply(model, u, DP_SEED, sin5=cfg.training.sin5)
        losses.mse(pred.float(), pkg["tiling"].extract_center_batch(f, 32, 24).float()).backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()
                if p.grad is not None}

    whole = grads(fully, under)
    rows = TRAIN_BATCH // RANKS
    halves = [grads(fully[r * rows : (r + 1) * rows], under[r * rows : (r + 1) * rows])
              for r in range(RANKS)]
    out = {}
    for group, member in GRAD_GROUPS:
        names = [n for n in whole if member(n)]
        w = torch.cat([whole[n].reshape(-1) for n in names]).double()
        h = torch.cat([sum(g[n] for g in halves).reshape(-1) / RANKS for n in names]).double()
        out[group] = {"relative": float((h - w).norm() / w.norm()),
                      "max_abs": float((h - w).abs().max())}
    return out


def loss_gap(got: list, want: list) -> float:
    """The largest relative difference of per-epoch (train, validation) losses."""
    check(len(got) == len(want), f"{len(got)} epochs against {len(want)}")
    return max(abs(a - b) / abs(b) for g, w in zip(got, want) for a, b in zip(g, w))


def multirank_path(pkg, tmp: pathlib.Path, device, meta: pathlib.Path,
                   val_meta: pathlib.Path, card: str) -> dict:
    """Phase 13: data parallelism over two ranks sharing the one card
    (gloo; every collective crosses the host), each rank one process started
    through the ``MRI_INR_*`` route: the train CLI (dropout off, TensorBoard
    on) for two epochs and a resumed third against a one-process run; one
    data-parallel step with dropout against its emulation here; the test
    CLI with ``--devices 2`` against the one-process, ``--shard`` and
    ``--merge-shards`` files; the test CLI's halo fold."""
    cli_train, cli_test, ev, stk = pkg["cli_train"], pkg["cli_test"], pkg["ev"], pkg["stk"]
    losses, trainer, tb = pkg["losses"], pkg["trainer"], pkg["tensorboard"]
    label = f"two ranks sharing one card [{card}]"
    train_argv = ["--config", str(REPO / "configs" / "train.yaml"),
                  "--set", f"data.train.dataset={meta}", "--set", f"data.val.dataset={val_meta}",
                  "--set", "training.save_interval=1000", "--set", "training.device_data=true",
                  "--set", "model.dropout=0.0"]
    out, elsewhere = tmp / "dp_train", tmp / "dp_rank1_never_writes"
    dp = train_argv + ["--set", f"training.output_dir={out}",
                       "--set", "training.data_axis_size=2", "--set", "training.logging=true"]
    rank1 = {1: ["--set", f"training.output_dir={elsewhere}"]}
    first = launch_ranks(tmp, "train", "train", dp + ["--set", "training.epochs=2"], rank1)
    resumed = launch_ranks(tmp, "resume", "train", dp + ["--set", "training.epochs=3", "--set",
                                                         "training.continue_training=true"],
                           rank1)
    runs = list(out.iterdir())
    check(len(runs) == 1, f"the two ranks made {len(runs)} run directories")
    run = runs[0]
    check(not elsewhere.exists(), "rank 1 wrote artifacts")
    check(sorted(p.name for p in (run / "checkpoints").iterdir())
          == ["step_00000032", "step_00000048"], "2-rank checkpoints")
    check(all("restored step 32; continuing at epoch 2" in r["stdout"] for r in resumed),
          "the checkpoint was not restored on every rank")
    check(all("data-parallel over 2 ranks" in r["stdout"] for r in first + resumed),
          "the per-step epoch of a data-parallel run was not logged")
    check([r["steps"] for r in first] == [32, 32] and [r["steps"] for r in resumed] == [48, 48],
          "steps of the 2-rank runs")
    launches = {}
    for r in range(RANKS):
        got = {k: first[r]["launches"][k] + resumed[r]["launches"][k]
               for k in first[r]["launches"]}
        print(f"2-rank train CLI, rank {r}: launches {got} (2 epochs + 1 resumed of 16 steps "
              "of a local batch of 200)")
        check(first[r]["launches"]["siren_train_fwd"] == 32
              and first[r]["launches"]["siren_train_bwd"] == 32
              and resumed[r]["launches"]["siren_train_fwd"] == 16
              and resumed[r]["launches"]["siren_train_bwd"] == 16,
              f"rank {r}: train kernel launches != its steps")
        # validation at a local 200: the initial errors (16 + 4 batches) and
        # 4 batches an epoch, in both runs
        check(got["siren_forward"] == 2 * (16 + 4) + 3 * 4, f"rank {r}: eval forward launches")
        launches[r] = got

    bf16 = witness_runs(pkg, tmp, train_argv, "bf16", fault=True)
    scalars = tb.read_scalars(run / "tensorboard")
    check(sorted(scalars) == ["training_loss", "validation_loss"]
          and [s for s, _ in scalars["training_loss"]] == [0, 1, 2]
          and [s for s, _ in scalars["validation_loss"]] == [0, 1, 2],
          f"TensorBoard scalars {scalars}")
    ranked = [(t, v) for (_, t), (_, v) in zip(scalars["training_loss"],
                                               scalars["validation_loss"])]
    for e, (two, one, halves) in enumerate(zip(ranked, bf16["whole"], bf16["halves"])):
        for i, key in enumerate(("train_loss", "val_loss")):
            print(f"epoch {e} {key}: 2 ranks (TensorBoard, float32) {two[i]:.7f}, one "
                  f"process {one[i]:.7f}, one process on the two halves {halves[i]:.7f}")
    gap = {"halves": loss_gap(ranked, bf16["halves"]), "whole": loss_gap(ranked, bf16["whole"]),
           "fault": loss_gap(bf16["fault"], bf16["whole"])}
    print(f"2-rank train CLI, dropout off, bf16, Adam, 3 epochs: max relative per-epoch loss "
          f"difference from one process on the two halves of every batch {gap['halves']:.3e} "
          f"(<= {MULTIRANK_HALVES_BAR:g}), from one process on the whole batch "
          f"{gap['whole']:.3e} (<= {MULTIRANK_WHOLE_BAR:g}); one process with every rank "
          f"stepping on rank 0's rows (a planted fault) lies {gap['fault']:.3e} from the whole "
          f"batch (> {MULTIRANK_WHOLE_BAR:g})")
    check(gap["halves"] <= MULTIRANK_HALVES_BAR,
          "2-rank losses disagree with one process on the two halves")
    check(gap["whole"] <= MULTIRANK_WHOLE_BAR,
          "2-rank losses disagree with one process on the whole batch")
    check(gap["fault"] > MULTIRANK_WHOLE_BAR,
          "the whole-batch bar does not see half of the batch left out")
    grad_gap = halves_gradient_gap(pkg, device)
    print("one fp32 step, one process, the two halves' mean gradient against the whole "
          "batch's (a reading, no check): " + "; ".join(
              f"{g} {v['relative']:.3e} relative, max |diff| {v['max_abs']:.3e}"
              for g, v in grad_gap.items()) + f" [{label}]")
    for r, rep in enumerate(first + resumed):
        if rep is resumed[0]:
            print("  (resumed run)")
        secs = [f"epoch {e}: {n / s:.2f} steps/s" for e, s, n in rep["epochs"]]
        wait, red = statistics.median(rep["wait_ms"]), statistics.median(rep["reduce_ms"])
        print(f"rank {rep['rank']}: {'; '.join(secs)}; a step's gradient all-reduce "
              f"{wait + red:.4f} ms (medians of {len(rep['reduce_ms'])} steps, host clock): "
              f"waiting for the peer rank {wait:.4f} ms, then the reduction "
              f"{red:.4f} ms (of {rep['reduce_floats']} floats, through the host; its two "
              f"copies alone {rep['copy_ms']:.4f} ms) [{label}]")

    # one step with dropout: each rank its own stream; Adam on the mean of
    # the two local gradients, emulated here with the rank seeds
    step_reports = launch_ranks(tmp, "step", "step", ["0.1", "adam", "1e-4"])
    got = [np.load(tmp / "ranks_step" / f"report{r}.npy") for r in range(RANKS)]
    check(np.array_equal(got[0], got[1]), "the ranks' parameters differ after the step")
    cfg, state = dp_state(pkg["config"], cli_train, trainer, device, "0.1", "adam", "1e-4")
    start = flat_params(state.model)
    fully, under = dp_batch(device)
    grads = []
    for r in range(RANKS):
        state.model.zero_grad(set_to_none=True)
        rows = [t[r * TRAIN_BATCH // RANKS : (r + 1) * TRAIN_BATCH // RANKS]
                for t in (fully, under)]
        pred = stk.fused_train_apply(state.model, rows[1], trainer.step_seed(DP_SEED, 0, r),
                                     sin5=cfg.training.sin5)
        losses.mse(pred.float(), pkg["tiling"].extract_center_batch(rows[0], 32, 24).float()
                   ).backward()
        grads.append([p.grad.clone() for p in state.model.parameters()])
    for p, g0, g1 in zip(state.model.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    state.optimizer.step()
    want = flat_params(state.model)
    err, moved = float(np.abs(got[0] - want).max()), float(np.abs(want - start).max())
    print(f"2-rank train step, dropout 0.1, Adam: parameters against Adam on the mean of the "
          f"two ranks' local steps emulated in one process: max |diff| {err:.3e} (<= "
          f"{DP_STEP_BAR:g}); the step moved them by up to {moved:.3e}; launches "
          f"{[r['launches'] for r in step_reports]}")
    check(err <= DP_STEP_BAR and moved > 1e-5, "the 2-rank dropout step disagrees")

    # one SGD step without dropout against the one-process step at B=400:
    # the JAX package's test of its sharded step, at full width
    sgd_reports = launch_ranks(tmp, "sgd", "step", ["0.0", "sgd", "1e-2"])
    got = np.load(tmp / "ranks_sgd" / "report0.npy")
    cfg, state = dp_state(pkg["config"], cli_train, trainer, device, "0.0", "sgd", "1e-2")
    step = trainer.make_train_step(state.model, losses.mse, 32, 24, use_pallas=True,
                                   sin5=cfg.training.sin5)
    start = flat_params(state.model)
    loss = float(step(state, *dp_batch(device), DP_SEED))
    want = flat_params(state.model)
    rel = abs(sgd_reports[0]["loss"] - loss) / loss
    err, moved = float(np.abs(got - want).max()), float(np.abs(want - start).max())
    print(f"2-rank SGD step (lr 1e-2, dropout off) against the one-process step at batch "
          f"{TRAIN_BATCH}: loss {sgd_reports[0]['loss']:.7f} vs {loss:.7f} (relative "
          f"{rel:.3e} <= {DP_SGD_LOSS_BAR:g}), parameters max |diff| {err:.3e} (<= "
          f"{DP_SGD_PARAM_BAR:g}; the step moved them by up to {moved:.3e})")
    check(rel <= DP_SGD_LOSS_BAR and err <= DP_SGD_PARAM_BAR and moved > 1e-4,
          "the 2-rank step disagrees with the one-process step")
    step_reports = [{"launches": {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}}
                    for a, b in zip(step_reports, sgd_reports)]

    # the test CLI over the two ranks, its rows gathered; one process, and
    # --shard / --merge-shards beside it
    def test_argv(out_dir, *extra):
        sets = [f"data.dataset={meta}", f"data.model_path={run}", f"data.output_dir={out_dir}",
                "data.output_name=dp", "data.visual_samples=0", *extra]
        return ["--config", str(REPO / "configs" / "test.yaml")] + [
            x for item in sets for x in ("--set", item)]

    rows_of = lambda d: ev.read_metrics_csv(d / "dp" / "metrics_error.csv")
    sweep = launch_ranks(tmp, "test", "test", test_argv(tmp / "dp_eval") + ["--devices", "2"],
                         {1: ["--set", f"data.output_dir={elsewhere}"]})
    check(not elsewhere.exists(), "rank 1 of the test CLI wrote artifacts")
    for i in range(RANKS):
        cli_test.main(test_argv(tmp / "dp_shards") + ["--shard", f"{i}:{RANKS}"])
    cli_test.main(test_argv(tmp / "dp_shards") + ["--merge-shards"])
    cli_test.main(test_argv(tmp / "dp_one"))
    ranked, merged, one = (rows_of(tmp / d) for d in ("dp_eval", "dp_shards", "dp_one"))
    total = VOLUMES * SLICES_PER_VOLUME
    by_id = {r.slice_id: r for r in one}
    row_gap = lambda rows: max(max(abs(h.psnr - by_id[h.slice_id].psnr),
                                   abs(h.ssim - by_id[h.slice_id].ssim),
                                   abs(h.nrmse - by_id[h.slice_id].nrmse)) for h in rows)
    gap = row_gap(ranked)
    print(f"test CLI --devices 2: {len(ranked)} rows gathered on every rank "
          f"({[r['rows'] for r in sweep]}); equal to the --shard + --merge-shards file "
          f"row for row: {ranked == merged}; against the one-process rows max |diff| "
          f"{gap:.3e} (<= {DP_ROW_BAR:g}: one piece of 16 slices there, of 8 a rank here, "
          f"so cuDNN and cuBLAS run the encoder and modulator at another batch); launches "
          f"{[r['launches'] for r in sweep]}")
    check(len(ranked) == total and ranked == merged, "gathered rows != merged shard rows")
    check(sorted(by_id) == sorted(r.slice_id for r in ranked) and gap <= DP_ROW_BAR,
          "gathered rows disagree with the one-process rows")

    # the halo fold: each rank reconstructs half the patch rows of every slice
    halo = launch_ranks(tmp, "halo", "test",
                        test_argv(tmp / "dp_halo", "data.halo_fold=true") + ["--devices", "2"])
    hrows = rows_of(tmp / "dp_halo")
    worst = row_gap(hrows)
    ex = [r["exchange"] for r in halo]
    print(f"test CLI halo fold over 2 ranks: {len(hrows)} rows, max |diff| against the "
          f"one-process rows {worst:.3e} (<= {HALO_ROW_BAR:g}); halo exchanges "
          f"{[e['calls'] for e in ex]}, "
          + ", ".join(f"rank {r}: {1e3 * e['seconds'] / total:.4f} ms a slice "
                      f"({1e3 * e['seconds'] / max(e['calls'], 1):.4f} ms an exchange)"
                      for r, e in enumerate(ex))
          + f"; launches {[r['launches'] for r in halo]} [{label}]")
    check(len(hrows) == total and worst <= HALO_ROW_BAR, "halo-fold rows disagree")
    for r in range(RANKS):
        for rep in (step_reports[r], sweep[r], halo[r]):
            for k, n in rep["launches"].items():
                launches[r][k] += n
    return {"launches": launches}


# --------------------------------------------------------------- phase 14
# cli/results_run's rows that no other phase drives, at configs/train.yaml's
# width; the protocol's depth cut to 2 / 1 / 1 volumes x 4 slices of 256 x
# 256, RESULTS_EPOCHS a row, one autoencoder epoch. The residual and Morlet
# routes are phases 7 and 3's; vgg_frozen_rand_module and
# vgg_frozen_corpus_module train a frozen VGG trunk on the module path (no
# train kernel; the sweep's forward is the kernel).
RESULTS_ROWS = ("online_remask", "vgg", "perceptual", "acc_02_4", "edge", "vgg_frozen_corpus",
                "vgg_frozen_rand_module", "vgg_frozen_corpus_module")
RESULTS_EPOCHS = 2
RESULTS_SLICES, RESULTS_SIZE = 4, 256  # the protocol's
RESULTS_ARGV = ["--epochs", str(RESULTS_EPOCHS), "--ae-epochs", "1", "--train-files", "2",
                "--val-files", "1", "--eval-files", "1", "--slices", str(RESULTS_SLICES),
                "--size", str(RESULTS_SIZE), "--rows", ",".join(RESULTS_ROWS)]


def run_losses(r: dict) -> list:
    """A row's train and validation losses, epoch by epoch, from its run's
    ``progress_log.csv`` (the timing columns left out)."""
    with open(pathlib.Path(r["run_dir"]) / "progress_log.csv") as fh:
        return [(float(e["train_loss"]), float(e["val_loss"])) for e in csv.DictReader(fh)]


def check_row_route(rr, r: dict) -> None:
    """A row trained on its route: the fused rows launch both train kernels
    and no dropout kernel, the module rows the dropout kernel (Flax's masks,
    configs/train.yaml's dropout 0.1) and neither train kernel; the sweep's
    eval forward is the kernel but for the residual model, which has none."""
    train = [r["launches"][k] for k in ("siren_train_fwd", "siren_train_bwd")]
    drops = r["launches"]["threefry_dropout"]
    if rr.route(r["train_overrides"]) == "fused":
        check(all(train) and not drops, f"results row {r['row']} (fused) launches {r['launches']}")
    else:
        check(not any(train) and drops > 0,
              f"results row {r['row']} (module path) launches {r['launches']}")
    residual = "model.residual=true" in r["train_overrides"]
    check((r["launches"]["siren_forward"] > 0) != residual,
          f"results row {r['row']}: siren_forward launches {r['launches']['siren_forward']}")


def results_path(pkg, tmp: pathlib.Path, device, card: str) -> dict:
    """Phase 14: the quality protocol's runner on the card. Every row trains
    on its route (the fused kernels, or the module path for the two
    ``_module`` rows) and lands in rows.json with finite means and
    this card's name; the splits and the online row's remask epochs go
    through the DFT kernel; a second call skips every row; the acc split's
    (0.2, 4) slices of one volume equal the torch.fft route's on the CPU."""
    rr, qr = pkg["results_run"], pkg["quality_run"]
    t_phase = time.perf_counter()
    root = tmp / "results"
    counters = rr.COUNTERS  # the four kernels' wrappers, by kernel name
    for k in counters.values():
        k.launches = 0
    done = rr.main(["--root", str(root), *RESULTS_ARGV])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    wall = time.perf_counter() - t_phase
    volumes, eval_slices = 2 + 1 + 1, 1 * RESULTS_SLICES
    for name in RESULTS_ROWS:
        r = done[name]
        means = [r[m]["mean"] for m in ("PSNR", "SSIM", "NRMSE")]
        print(f"results row {name}: PSNR / SSIM / NRMSE {means[0]:.4f} / {means[1]:.4f} / "
              f"{means[2]:.4f} over {r['slices']} slices; stages "
              + ", ".join(f"{k} {v:.1f} s" for k, v in r["stage_seconds"].items())
              + f"; launches {r['launches']}"
              + (f"; VGG trunk feature mean {r['trunk_features']['mean']:.4g}"
                 if "trunk_features" in r else ""))
        check(all(np.isfinite(means)) and r["slices"] == eval_slices and r["device"] == card,
              f"results row {name}: {means}, {r['slices']} slices on {r['device']}")
        check_row_route(rr, r)
    # the default splits (built for the first row), 1 fully sampled + 2 masks a
    # volume; the online set's fully sampled tiles once and one mask epoch
    # each epoch; the acc splits, 1 + 4 masks a volume
    want_dft = {"online_remask": volumes * 3 + 1 + RESULTS_EPOCHS, "acc_02_4": volumes * 5}
    for name, n in want_dft.items():
        check(done[name]["launches"]["dft2c"] == n,
              f"results row {name}: {done[name]['launches']['dft2c']} dft2c launches, not {n}")
    check(sum(r["launches"]["siren_train_fwd"] for r in done.values())
          == launches["siren_train_fwd"], "per-row train launches do not add up")
    written = json.loads((root / "rows.json").read_text())
    check([r["row"] for r in written] == list(RESULTS_ROWS), "rows.json rows")

    before = (root / "rows.json").read_bytes()
    for k in counters.values():
        k.launches = 0
    again = rr.main(["--root", str(root), *RESULTS_ARGV])
    check(again == done and (root / "rows.json").read_bytes() == before
          and not any(k.launches for k in counters.values()),
          "a second call of the runner did not skip every row")

    # one volume's (0.2, 4) acc slices against the torch.fft route on the CPU
    args = argparse.Namespace(slices=RESULTS_SLICES, size=RESULTS_SIZE, phase=False, snr_db=None,
                              texture=0.0)
    stem = pkg["synthetic"].synthetic_stem(0)
    cpu_rows = pkg["preprocessing"].process_kspace_volume(
        qr.phantom_kspace(0, args), stem, tmp / "acc_cpu", undersample_params=((0.2, 4),),
        device="cpu")
    col = pkg["dataset"].undersample_column(0.2, 4)
    card_rows = [r for r in pkg["dataset"].read_metadata(
        root / "data" / "train" / "processed_acc" / "metadata.csv") if r["stem"] == stem]
    check(len(card_rows) == len(cpu_rows) == RESULTS_SLICES, "acc split rows of one volume")
    gap = max(float(np.abs(np.load(a[col]) - np.load(b[col])).max())
              for a, b in zip(card_rows, cpu_rows))
    print(f"acc split (0.2, 4) of {stem}, card (DFT kernel) vs cpu (torch.fft): max |diff| "
          f"{gap:.3e} (<= {PREPROCESS_BAR:g})")
    check(gap <= PREPROCESS_BAR, "the acc split disagrees with the CPU route")
    print(f"results phase: {len(RESULTS_ROWS)} rows at configs/train.yaml's width, "
          f"{RESULTS_EPOCHS} epochs each, launches {launches}; {wall:.1f} s for the rows, "
          f"{time.perf_counter() - t_phase:.1f} s wall with the checks [{card}]")
    return {"launches": launches, "rows": done}


# --------------------------------------------------------------- phase 15
# cli/sweep940 at full width and 320x320, the depth cut: the evaluation set
# to 24 volumes x 4 slices, the headline model to 4 volumes, one epoch and a
# resumed second, the protocol's autoencoder to one epoch.
SWEEP_VOLUMES, SWEEP_SLICES_940, SWEEP_SIZE = 24, 4, 320
SWEEP_TRAIN_VOLUMES = 4
SWEEP940_ARGV = ["--files", str(SWEEP_VOLUMES), "--slices", str(SWEEP_SLICES_940), "--size",
                 str(SWEEP_SIZE), "--train-files", str(SWEEP_TRAIN_VOLUMES), "--val-files", "1",
                 "--epochs", "1", "--resume-epochs", "2", "--ae-epochs", "1"]
SEED_ROW = "edge"


def sweep940_path(pkg, tmp: pathlib.Path, device, card: str) -> dict:
    """Phase 15: the 940-file sweep's runner at a cut depth (its own checks
    raise), every on-path kernel launched in the stage that runs it; then a
    seeded row of the quality protocol's runner beside phase 14's."""
    sw, rr = pkg["sweep940"], pkg["results_run"]
    t_phase = time.perf_counter()
    counters = rr.COUNTERS
    for k in counters.values():
        k.launches = 0
    out = sw.main(["--root", str(tmp / "sweep940"), "--protocol-root",
                   str(tmp / "sweep940_protocol"), *SWEEP940_ARGV])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    wall = time.perf_counter() - t_phase
    slices = SWEEP_VOLUMES * SWEEP_SLICES_940
    check(out["slices"] == slices and out["device"] == card, "sweep940 record")
    for name in ("summary", "online_summary", "sharded_summary"):
        means = [out[name][m]["mean"] for m in ("PSNR", "SSIM", "NRMSE")]
        check(all(np.isfinite(means)), f"sweep940 {name}: {means}")
    checks = out["checks"]
    check(checks["shards"]["held"] and checks["online"]["held"], f"sweep940 checks {checks}")
    by_stage = out["launches"]
    wanted = {"data": ["dft2c"], "train_to_1": ["dft2c", "siren_train_fwd", "siren_train_bwd",
                                                "siren_forward"],
              "train_to_2": ["dft2c", "siren_train_fwd", "siren_train_bwd", "siren_forward"],
              "offline": ["siren_forward"], "online": ["dft2c", "siren_forward"],
              "shard0": ["siren_forward"], "shard1": ["siren_forward"]}
    for stage, kernels in wanted.items():
        for k in kernels:
            check(by_stage[stage][k] > 0, f"sweep940 stage {stage} launched no {k}")
    # 1 fully sampled + 2 masks a volume
    check(by_stage["data"]["dft2c"] == 3 * SWEEP_VOLUMES,
          f"sweep940 data: {by_stage['data']['dft2c']} dft2c launches")
    runs = out["headline"]["runs"]
    check([r["epochs"] for r in runs] == [[0, 1], [1, 2]], f"sweep940 runs {runs}")
    for name, leg in out["legs"].items():
        if name != "merge":
            print(f"sweep940 leg {name}: {leg['slices']} slices, wall {leg['wall_seconds']:.3f} "
                  f"s, metric pass {leg['metric_pass_seconds']:.3f} s (stage "
                  f"{leg['stage_seconds']:.3f}, dispatch {leg['dispatch_seconds']:.3f}, "
                  f"execute+fetch {leg['execute_fetch_seconds']:.3f}), "
                  f"{leg['steady_slices_per_sec']:.1f} slices/s past staging, peak "
                  f"{leg['peak_device_mib'] or 0:.1f} MiB [{card}]")
    print(f"sweep940 checks: shards exact {checks['shards']['exact']} (max row gap "
          f"{checks['shards']['max_row_gap']:.3e}, piece invariance "
          f"{checks['shards']['piece_invariance']}), online max stat gap "
          f"{checks['online']['max_stat_gap']:.3e}; headline runs "
          + "; ".join(f"epochs {r['epochs']} {r['seconds']:.1f} s, losses "
                      f"{r['train_loss']:.5f} / {r['val_loss']:.5f}" for r in runs))

    # a seeded row beside phase 14's: its own name, the seed in its run
    t0 = time.perf_counter()
    root = tmp / "results"
    rows_argv = RESULTS_ARGV[:RESULTS_ARGV.index("--rows")]
    done = rr.main(["--root", str(root), *rows_argv, "--rows", SEED_ROW, "--seed", "1"])
    torch.cuda.synchronize()
    seeded, base = done[f"{SEED_ROW}@seed1"], done[SEED_ROW]
    check(seeded["row"] == f"{SEED_ROW}@seed1" and seeded["seed"] == 1
          and "training.seed=1" in seeded["train_overrides"], f"seeded row {seeded['row']}")
    check(run_losses(seeded) != run_losses(base), "the seed-1 row's losses equal seed 0's")
    for k in ("siren_train_fwd", "siren_train_bwd", "siren_forward"):
        check(seeded["launches"][k] > 0, f"seeded row launched no {k}")
    print(f"results row {seeded['row']}: PSNR {seeded['PSNR']['mean']:.4f} against seed 0's "
          f"{base['PSNR']['mean']:.4f}, launches {seeded['launches']} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"sweep940 phase: {slices} slices at {SWEEP_SIZE}x{SWEEP_SIZE}, launches "
          f"{launches}; {wall:.1f} s for the runner, {time.perf_counter() - t_phase:.1f} s "
          f"wall with the seeded row [{card}]")
    return {"launches": launches, "out": out}


# --------------------------------------------------------------- phase 16
# cli/hard_table at configs/train.yaml's width on the hard corpus (complex
# phase, SNR 32 dB noise, texture 0.18), the depth cut as phase 14's; the
# resumed residual row cut to a third epoch.
HARD_ROWS = ("baseline", "online_remask", "residual", "residual_1200")
HARD_ARGV = [*RESULTS_ARGV[:RESULTS_ARGV.index("--rows")], "--resume-epochs",
             str(RESULTS_EPOCHS + 1), "--rows", ",".join(HARD_ROWS)]
HARD_SEED_ROW = "baseline"


def hard_path(pkg, tmp: pathlib.Path, device, card: str) -> dict:
    """Phase 16: the hard-corpus runner on the card. The fused rows launch
    the train kernels, the residual rows run the module path (the resumed
    one from the residual row's run directory); the hard splits and the
    online row's remask epochs go through the DFT kernel on complex, noisy
    k-space and one volume's slices equal the torch.fft route's on the CPU;
    a call into phase 14's smooth root raises the protocol error before any
    file changes; a second call skips every row; then a seed-1 row beside
    them."""
    ht, qr = pkg["hard_table"], pkg["quality_run"]
    t_phase = time.perf_counter()
    root = tmp / "results_hard"
    counters = pkg["results_run"].COUNTERS
    for k in counters.values():
        k.launches = 0
    done = ht.main(["--root", str(root), *HARD_ARGV])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    wall = time.perf_counter() - t_phase
    volumes, eval_slices = 2 + 1 + 1, 1 * RESULTS_SLICES
    for name in HARD_ROWS:
        r = done[name]
        means = [r[m]["mean"] for m in ("PSNR", "SSIM", "NRMSE")]
        print(f"hard row {name}: PSNR / SSIM / NRMSE {means[0]:.4f} / {means[1]:.4f} / "
              f"{means[2]:.4f} over {r['slices']} slices; stages "
              + ", ".join(f"{k} {v:.1f} s" for k, v in r["stage_seconds"].items())
              + f"; launches {r['launches']}")
        check(all(np.isfinite(means)) and r["slices"] == eval_slices and r["device"] == card
              and r["corpus"]["phase"] and r["corpus"]["snr_db"] == ht.HARD["snr_db"],
              f"hard row {name}: {means}, {r['slices']} slices on {r['device']}, "
              f"{r.get('corpus')}")
        check_row_route(pkg["results_run"], r)
    # the default splits (built for the first row), 1 fully sampled + 2 masks a
    # volume; the online set's fully sampled tiles once and one mask epoch
    # each epoch; the module rows none
    want_dft = {"baseline": volumes * 3, "online_remask": 1 + RESULTS_EPOCHS, "residual": 0,
                "residual_1200": 0}
    for name, n in want_dft.items():
        check(done[name]["launches"]["dft2c"] == n,
              f"hard row {name}: {done[name]['launches']['dft2c']} dft2c launches, not {n}")
    resumed, parent = done["residual_1200"], done["residual"]
    run_dir = pathlib.Path(resumed["run_dir"])
    logs = [len((run_dir / f).read_text().splitlines())
            for f in ("progress_log.csv", f"progress_log_to{RESULTS_EPOCHS}.csv")]
    check(resumed["run_dir"] == parent["run_dir"] and resumed["epochs"] == RESULTS_EPOCHS + 1
          and logs == [1 + 1, 1 + RESULTS_EPOCHS]
          and (root / "residual" / "eval1200" / "metrics_summary.txt").is_file(),
          f"residual_1200: {resumed['run_dir']} against {parent['run_dir']}, log lines {logs}")
    written = json.loads((root / "rows.json").read_text())
    check([r["row"] for r in written] == list(HARD_ROWS)
          and all(r["device"] == card for r in written), "hard rows.json rows and card")

    # a hard call into phase 14's smooth root raises before touching it
    smooth = tmp / "results"
    files = {p: p.stat().st_mtime_ns for p in smooth.rglob("*") if p.is_file()}
    try:
        ht.main(["--root", str(smooth), *HARD_ARGV])
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    check("this call asks for" in raised
          and files == {p: p.stat().st_mtime_ns for p in smooth.rglob("*") if p.is_file()},
          f"a hard call into the smooth root: {raised or 'no error'}")
    print(f"hard call into the smooth root refused: {raised[:160]}...")

    before = (root / "rows.json").read_bytes()
    for k in counters.values():
        k.launches = 0
    again = ht.main(["--root", str(root), *HARD_ARGV])
    check(again == done and (root / "rows.json").read_bytes() == before
          and not any(k.launches for k in counters.values()),
          "a second call of the hard runner did not skip every row")

    # one hard volume's slices against the torch.fft route on the CPU
    args = argparse.Namespace(slices=RESULTS_SLICES, size=RESULTS_SIZE, **ht.HARD)
    stem = pkg["synthetic"].synthetic_stem(0)
    cpu_rows = pkg["preprocessing"].process_kspace_volume(
        qr.phantom_kspace(0, args), stem, tmp / "hard_cpu", device="cpu")
    card_rows = [r for r in pkg["dataset"].read_metadata(
        root / "data" / "train" / "processed" / "metadata.csv") if r["stem"] == stem]
    check(len(card_rows) == len(cpu_rows) == RESULTS_SLICES, "hard split rows of one volume")
    cols = [c for c in cpu_rows[0] if c.startswith("path_")]
    gap = max(float(np.abs(np.load(a[c]) - np.load(b[c])).max())
              for a, b in zip(card_rows, cpu_rows) for c in cols)
    print(f"hard split of {stem} ({', '.join(cols)}), card (DFT kernel) vs cpu (torch.fft): "
          f"max |diff| {gap:.3e} (<= {PREPROCESS_BAR:g})")
    check(gap <= PREPROCESS_BAR, "the hard split disagrees with the CPU route")

    # a seeded row beside them: its own name, the seed in its run, the same splits
    t0 = time.perf_counter()
    rows_argv = HARD_ARGV[:HARD_ARGV.index("--rows")]
    seeded_all = ht.main(["--root", str(root), *rows_argv, "--rows", HARD_SEED_ROW,
                          "--seed", "1"])
    torch.cuda.synchronize()
    key = f"{HARD_SEED_ROW}@seed1"
    seeded, base = seeded_all[key], done[HARD_SEED_ROW]
    means = [seeded[m]["mean"] for m in ("PSNR", "SSIM", "NRMSE")]
    check(seeded["row"] == key and seeded["seed"] == 1 and seeded["jax_row"] == HARD_SEED_ROW
          and "training.seed=1" in seeded["train_overrides"] and seeded["device"] == card
          and all(np.isfinite(means)), f"hard seeded row {seeded['row']}: {means}")
    check(run_losses(seeded) != run_losses(base), "the hard seed-1 row's losses equal seed 0's")
    check(seeded["launches"]["dft2c"] == 0, f"hard seeded row: {seeded['launches']}")
    check_row_route(pkg["results_run"], seeded)
    print(f"hard row {key}: PSNR {means[0]:.4f} against seed 0's {base['PSNR']['mean']:.4f}, "
          f"launches {seeded['launches']} ({time.perf_counter() - t0:.1f} s)")
    print(f"hard phase: {len(HARD_ROWS)} rows at configs/train.yaml's width, "
          f"{RESULTS_EPOCHS} epochs each (residual_1200 resumed to {RESULTS_EPOCHS + 1}) "
          f"and {key}, launches {launches}; {wall:.1f} s for the rows, "
          f"{time.perf_counter() - t_phase:.1f} s wall with the checks [{card}]")
    return {"launches": launches, "rows": done}


# --------------------------------------------------------------- phase 18
DROPOUT_FILE = REPO / "tests" / "data" / "jax_dropout_masks.json"  # tests/jax_dropout_constants.py
# 32-bit integer operations an element of the dropout kernel
# (csrc/threefry_dropout.cu): 20 rounds of add, rotate and xor, ten
# key-injection adds, the counter's split, the float, the compare and the
# byte's place in its word. The guide's table has no integer rate: they are
# counted at the f32 rate of the CUDA cores, which no integer unit exceeds,
# so the bound is a least time.
DROPOUT_INT_OPS = 85


def packed_sha256(mask: torch.Tensor) -> str:
    return hashlib.sha256(np.packbits(mask.cpu().numpy()).tobytes()).hexdigest()


def dropout_masks(pkg, device, card) -> dict:
    """Phase 18, first part: the dropout kernel against its plain version
    and the JAX package's recorded masks at the train batch's shape, every
    hidden layer of two steps; its time and its plain version's."""
    dr, tr = pkg["dropout"], pkg["trainer"]
    rec = json.loads(DROPOUT_FILE.read_text())
    cfg = pkg["config"].load_train_configuration(REPO / "configs" / "train.yaml")
    model = pkg["ms"].from_config(cfg.model, cfg.training.precision, device=device)
    shape, keep = tuple(rec["shape"]), rec["keep"]
    check(keep == 1.0 - cfg.model.dropout and shape == (cfg.training.batch_size, 576,
                                                         cfg.model.dim_hidden),
          f"the recorded masks' shape {shape} and keep {keep}")
    wrong = 0
    for m in rec["masks"]:
        keys = tr.epoch_dropout_keys(rec["base_seed"], m["step"], 1, model)[0][m["layer"]]
        check(keys.tolist() == m["key"], f"step {m['step']} layer {m['layer']}: the port's key "
              f"{keys.tolist()}, the JAX package's {m['key']}")
        kt = dr.keys_tensor(keys, device)
        got = dr.threefry_keep_mask_cuda(kt, shape, keep)
        want = dr.threefry_keep_mask_reference(kt, shape, keep)
        differ = int((got != want).sum())
        wrong += differ
        check(differ == 0, f"step {m['step']} layer {m['layer']}: the kernel's mask differs "
              f"from the plain version's in {differ} elements")
        check(int(got.sum()) == m["kept"] and packed_sha256(got) == m["sha256"],
              f"step {m['step']} layer {m['layer']}: the mask is not the JAX package's")
    print(f"dropout kernel at {shape}, keep {keep}: {len(rec['masks'])} masks (5 layers x "
          f"{len(rec['masks']) // 5} steps) equal the plain version's and the JAX package's "
          f"recorded masks bit for bit ({DROPOUT_FILE.name}: keys, kept counts, SHA-256) [{card}]")
    kt = dr.keys_tensor(np.array(rec["masks"][0]["key"], np.uint32), device)
    return {"wrong": wrong, "numel": math.prod(shape), "masks": len(rec["masks"]),
            "ms": cuda_median_ms(lambda: dr.threefry_keep_mask_cuda(kt, shape, keep)),
            "plain_ms": cuda_median_ms(lambda: dr.threefry_keep_mask_reference(kt, shape, keep),
                                       reps=5, warmup=1)}


def dropout_graph_path(pkg, tmp: pathlib.Path, device, meta: pathlib.Path,
                       val_meta: pathlib.Path, card: str) -> dict:
    """Phase 18, second part: the graphed module epoch (configs/train.yaml
    with ``model.use_pallas=false``, ``device_data``) for three train
    epochs: eager, captured and replayed, replayed. Each mask the steps
    draw is also copied inside the graph; after each replay every step's
    masks equal the plain version's of the keys staged for that step, and
    differ from the step before's and from the last replay's. The kernel's
    launch count is set to 0 before the three epochs and read after."""
    dr, tr = pkg["dropout"], pkg["trainer"]
    cfg = pkg["config"].load_train_configuration(REPO / "configs" / "train.yaml",
                                                 ["model.use_pallas=false"])
    tcfg, mcfg, dcfg = cfg.training, cfg.model, cfg.data
    train = pkg["dataset"].MRIDataset(
        meta, center_fraction=dcfg.center_fraction, acceleration=dcfg.acceleration,
        mri_type=dcfg.train.mri_type, max_slice_num=dcfg.train.max_slice_num,
        outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size)
    model = pkg["ms"].from_config(mcfg, tcfg.precision, device=device)
    t = tr.Trainer(model, tr.create_train_state(model, tcfg.optimizer, tcfg.lr),
                   pkg["losses"].make_loss_fn(tcfg.criterion), train, train,
                   tmp / "dropout_graph", batch_size=tcfg.batch_size, save_interval=1000,
                   base_seed=tcfg.seed + 1, use_pallas=False, sin5=tcfg.sin5,
                   device_data=True, device=device, log=lambda *_: None)
    check(not t.scan_epoch.fused, "the module epoch is not on the module path")
    keep = 1.0 - mcfg.dropout
    layers = len(pkg["flax_init"].dropout_layers(model))
    steps = -(-len(train) // tcfg.batch_size)
    real = dr.threefry_keep_mask
    drawn: list = []

    def spy(keys, shape, keep_, offset=0):
        mask = real(keys, shape, keep_, offset)
        drawn.append((keys, mask.clone()))  # inside a capture: a copy the graph makes
        return mask

    dr.threefry_keep_mask_cuda.launches = 0
    dr.threefry_keep_mask = spy
    last = None  # the last replay's first step's masks
    try:
        for epoch in range(3):
            if epoch == 1:  # the capture: the copies it records are refilled by every replay
                drawn.clear()
            step0 = t.state.step
            t._epoch_loss(train, train=True, epoch=epoch)
            torch.cuda.synchronize()
            if epoch == 0:  # eager: the capture's warm-up
                continue
            check(len(drawn) == steps * layers, f"{len(drawn)} masks for {steps} steps")
            want_keys = tr.epoch_dropout_keys(tcfg.seed + 1, step0, steps, model)
            before = None
            for i in range(steps):
                row = drawn[i * layers:(i + 1) * layers]
                check(np.array_equal(np.stack([k.cpu().numpy().view(np.uint32) for k, _ in row]),
                                     want_keys[i]), f"epoch {epoch} step {i}: staged keys")
                for j, (k, m) in enumerate(row):
                    check(torch.equal(m, dr.threefry_keep_mask_reference(k, m.shape, keep)),
                          f"epoch {epoch} step {i} layer {j}: the graph's mask differs from "
                          "the plain version's")
                masks = [m for _, m in row]
                check(before is None or not any(torch.equal(a, b) for a, b in zip(masks, before)),
                      f"epoch {epoch} step {i}: a mask of the step before")
                before = masks
            first = [m.clone() for _, m in drawn[:layers]]
            check(last is None or not any(torch.equal(a, b) for a, b in zip(first, last)),
                  "a replay drew the last replay's masks")
            last = first
    finally:
        dr.threefry_keep_mask = real
    launches = dr.threefry_keep_mask_cuda.launches
    check(t.scan_epoch.captures == 1 and t.scan_epoch.replays == 2,
          f"graphs {t.scan_epoch.captures} captured, {t.scan_epoch.replays} replays")
    check(launches == 3 * steps * layers,
          f"{launches} dropout launches in 3 epochs of {steps} steps x {layers} layers")
    print(f"graphed module epoch ({steps} steps of {tcfg.batch_size}, {layers} dropping layers): "
          f"eager, captured and replayed, replayed; in each replay every step's masks equal the "
          f"plain version's of its staged keys and differ from the step before's; dropout "
          f"launches {launches} [{card}]")
    return {"launches": launches, "steps": steps, "layers": layers}


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
            # Adam's update alone, over this model's parameters and gradients
            params = list(model.parameters())
            for label_, opt in (
                    ("adam_fused", state.optimizer),
                    ("adam_foreach", torch.optim.Adam(params, lr=cfg.training.lr,
                                                      capturable=True))):
                out[label_] = cuda_median_ms(opt.step)
                out[label_ + "_device"] = device_ms(opt.step)
    return out


def report_train_step(step_ms: dict, card: str) -> None:
    print(f"train step, batch {TRAIN_BATCH}, configs/train.yaml (bf16, Adam): fused "
          f"{step_ms['fused']:.4f} ms, module path under autograd {step_ms['module']:.4f} ms "
          f"(median of 10, eager, before any CUDA graph) [{card}]")
    print(f"Adam's update alone, capturable (CUDA events around the call, median of {REPS}; "
          f"device time by torch.profiler): fused, the port's {step_ms['adam_fused']:.4f} ms "
          f"(device {step_ms['adam_fused_device']:.4f} ms), multi-tensor "
          f"{step_ms['adam_foreach']:.4f} ms (device {step_ms['adam_foreach_device']:.4f} ms) "
          f"[{card}]")
    prof = step_ms["profile"]
    print(f"fused train step: host enqueues it in {step_ms['host_enqueue']:.4f} ms [{card}]")
    if prof is None:
        print("fused train step, device time by kernel: not measured (the profiler "
              "recorded no device activity)")
        return
    host = prof["host"]
    print(f"fused train step, host side (torch.profiler, own CPU time per step; the "
          f"profiler's own cost included), top 15 of {len(host)} ops, "
          f"{sum(ms for _, ms, _ in host):.4f} ms in all [{card}]:")
    for name, ms_, calls in host[:15]:
        print(f"  {ms_:8.4f} ms  {calls:4d} calls  {name[:90]}")
    print(f"fused train step under the profiler: wall {prof['wall_ms']:.4f} ms, device "
          f"busy {prof['busy_ms']:.4f} ms (idle share "
          f"{max(0.0, 1 - prof['busy_ms'] / prof['wall_ms']):.1%}) [{card}]")
    for name, ms_ in prof["kernels"][:12]:
        print(f"  {ms_:8.4f} ms  {name[:100]}")
    rest = sum(ms_ for _, ms_ in prof["kernels"][12:])
    print(f"  {rest:8.4f} ms  ({len(prof['kernels']) - 12} more kernels)")
    groups = {"backward chain kernel": ("chain_kernel",),
              "backward dW kernel and the dW and dbase sums": ("dw_", "ordered_sum"),
              "forward kernel": ("TrainEpilogue",),
              "Adam (multi_tensor_apply kernels)": ("multi_tensor_apply",)}
    share = {g: sum(ms_ for n, ms_ in prof["kernels"] if any(k in n for k in keys))
             for g, keys in groups.items()}
    share["encoder, modulator, repack, loss under autograd (all other kernels)"] = (
        prof["busy_ms"] - sum(share.values()))
    print("fused train step, device time: " + "; ".join(
        f"{g} {ms_:.4f} ms" for g, ms_ in share.items()) + f" [{card}]")


def device_ms(fn, reps: int = 5) -> float | None:
    """Device time per call (torch.profiler), or None where it sees none."""
    prof = profile_device(fn, reps)
    return None if prof is None else prof["busy_ms"]


def host_enqueue_ms(fn, reps: int = 10) -> float:
    """Host time to enqueue one call (no wait for the device inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def device_rows(prof, reps: int) -> list:
    """(kernel name, device ms per call, launches per call) of a profile's
    device rows, but annotated ranges (Optimizer.step#...), whose time is
    their kernels' over again."""
    return [(e.key, e.device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower() and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]


def profile_device(fn, reps: int = 5) -> dict | None:
    """Device time by kernel over ``reps`` calls, from torch.profiler: (wall
    ms per call, device-busy ms per call, [(kernel name, ms per call)]) and
    the host ops by their own CPU time per call, or None where the profiler
    sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    rows = [(name, ms) for name, ms, _ in device_rows(prof, reps)]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / reps, e.count // reps)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda r: -r[1])
    return {"wall_ms": wall, "busy_ms": sum(ms for _, ms in rows), "kernels": rows,
            "host": host}


def bwd_parts_ms(fn, card: str) -> dict:
    """Device time per call of the backward's kernels (chain, weight
    gradient, the fixed-order sums of dW and dbase), from torch.profiler."""
    prof = profile_device(fn)
    if prof is None:
        print("train bwd kernels apart: not measured (the profiler recorded no device "
              "activity)")
        return {}
    keys = {"chain_ms": "chain_kernel", "dw_ms": "dw_kernel", "sums_ms": "ordered_sum_kernel"}
    out = {k: sum(ms_ for n, ms_ in prof["kernels"] if key in n) for k, key in keys.items()}
    print("train bwd kernels apart (torch.profiler, device ms per call): " + ", ".join(
        f"{k[:-3]} {v:.4f}" for k, v in out.items()) + f" [{card}]")
    return out


# f32 operations outside the tensor cores (an FMA counted as two, as the
# 67 TFLOP/s peak counts it), per activation, from the kernel sources. A
# sine: its range reduction (mul, add, floor, mul, sub) and its odd
# polynomial of degree d (v * v, (d - 1) / 2 FMAs, v * p).
SIN_F32 = {d: 5 + 1 + 2 * (d - 1) // 2 + 1 for d in (5, 7, 9)}


def siren_f32_ops(rows: int, hidden: int, layers: int, kind: str) -> int:
    """The f32 operations of a SIREN kernel's epilogues on ``rows`` (B*S)
    coordinate rows, at the main path's sines (eval: degree 5; int8:
    degree 9; train: degree 5, dropout on): per activation of the L-1 hidden
    layers, plus per element of x_0 (and, for the backward, of dbase)."""
    acts = rows * hidden * (layers - 1)
    elems = rows * hidden
    if kind == "eval":  # bias, w0, sine, modulation, bf16 rounding (last: row sum); x_0
        return acts * (4 + SIN_F32[5]) + elems * 2
    if kind == "int8":  # dequantise (float(acc), x gd, + b), w0, sine, quantise
        # (x fq, + 0.5, floor; last: x fq, x last_w and sum); x_0 quantised
        return acts * (3 + 1 + SIN_F32[9] + 3) + elems * 3
    if kind == "train_fwd":  # bias, w0, sine, dropout, modulation, bf16 rounding;
        # the last layer's x last_w and sum; x_0: dropout, modulation, rounding
        return acts * (5 + SIN_F32[5]) + elems * (2 + 3)
    if kind == "train_bwd":
        # recomputed forward as train_fwd, the last layer's dlw (FMA) and dx
        # (mul) too; reverse: bias, w0, sine, cosine (a sine at x + pi/2),
        # w0 * cos, dmods (dropout, FMA), dpre (mul, dropout, mul), dsb, bf16
        # rounding; layer 0: dmods (dropout, FMA), dbase (mul, dropout, sum)
        fwd = acts * (5 + SIN_F32[5]) + elems * (2 + 3 + 3)
        rev = acts * (1 + 1 + SIN_F32[5] + SIN_F32[5] + 1 + 1 + 3 + 3 + 1 + 1)
        return fwd + rev + elems * (3 + 3)
    raise ValueError(kind)


def kernel_record(name, replaces, launches, err, ms, plain_ms, flops, nbytes,
                  card, executed_flops=None, peak=PEAK_BF16_FLOPS, unit="bf16 FLOP",
                  library_ms=None, f32_ops=0, ops_term=None, **extra) -> dict:
    """``flops``: the operations the function needs on these inputs (the
    bound's), at the card's ``peak`` rate for their type (named
    ``ops_term``); ``f32_ops``: the f32 operations it needs outside the
    tensor cores besides, at the f32 rate; ``executed_flops``: those the
    kernel runs, where recomputation makes them more. The bound is the
    largest of the three times."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    f32_ms = f32_ops / PEAK_F32_FLOPS * 1e3
    ops_term = ops_term or ("f32 operations" if peak == PEAK_F32_FLOPS else "tensor operations")
    terms = {ops_term: ops_ms, "bytes": bytes_ms}
    if f32_ops:
        terms["f32 operations"] = f32_ms
    bound_term = max(terms, key=terms.get)
    bound_ms = terms[bound_term]
    rate = f"{flops / ms / 1e9:.1f} T{unit.split()[-1]}/s of needed work"
    if executed_flops is not None:
        rate += f", {executed_flops / ms / 1e9:.1f} TFLOP/s of the {executed_flops:.3e} executed"
    lib = "" if library_ms is None else f", library call {library_ms:.4f} ms/call"
    f32 = f", {f32_ops:.3e} f32 FLOP outside the tensor cores -> {f32_ms:.4f} ms" if f32_ops else ""
    print(f"{name} kernel: {ms:.4f} ms/call ({rate}), plain version "
          f"{plain_ms:.4f} ms/call{lib}; bound {flops:.3e} {unit} at {peak / 1e12:g} T/s -> "
          f"{ops_ms:.4f} ms{f32}, {nbytes} B -> {bytes_ms:.4f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_term}; kernel at {bound_ms / ms:.1%} of bound [{card}]")
    return {"name": name, "route": "cuda",
            "source": f"mri_inr_tpu_torch/ops/csrc/{name}.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if bound_term == "bytes" else "operations",
            "bound_term": bound_term, "library_ms": library_ms, **extra}


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
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 13
        return rank_worker(sys.argv[2:])
    sys.path.insert(0, str(REPO))
    from mri_inr_tpu_torch import interop, native
    from mri_inr_tpu_torch.cli import preprocess as cli_preprocess
    from mri_inr_tpu_torch.cli import hard_table, quality_run, results_run, sweep940
    from mri_inr_tpu_torch.cli import test as cli_test
    from mri_inr_tpu_torch.cli import train as cli_train
    from mri_inr_tpu_torch.cli import train_encoder
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.data import dataset, kspace, online, preprocessing, synthetic
    from mri_inr_tpu_torch.eval import evaluate as ev
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.models import flax_init
    from mri_inr_tpu_torch.ops import _build
    from mri_inr_tpu_torch.ops import dropout
    from mri_inr_tpu_torch.ops import fft_kernel as fk
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.ops import tiling
    from mri_inr_tpu_torch.train import losses, trainer
    from mri_inr_tpu_torch.utils import jax_random, profiling, tensorboard, visualization

    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: comparisons run in full f32")

    build_kernels(_build, ["siren_forward", "siren_forward_int8", "siren_train_fwd",
                           "siren_train_bwd", "dft2c", "threefry_dropout"])
    print(f"host tile helpers (g++, OpenMP): have_native() = {native.have_native()}")
    check(native.have_native(), "the native tile helpers did not build")
    cmp = compare_kernel(sk, ms, device)
    cmp_int8 = compare_int8_kernel(sk, ms, device)
    cmp_train = compare_train_kernels(sk, stk, ms, device)
    cmp_local = compare_local_kernels(sk, stk, ms, trainer, cmp, cmp_train, device)
    cmp_dft = compare_dft_kernel(fk, synthetic, kspace, device)

    pkg = dict(config=config, dataset=dataset, synthetic=synthetic, preprocessing=preprocessing,
               ev=ev, ms=ms, sk=sk, stk=stk, fk=fk, cli_train=cli_train, cli_test=cli_test,
               cli_preprocess=cli_preprocess, train_encoder=train_encoder, losses=losses,
               trainer=trainer, online=online, tiling=tiling, tensorboard=tensorboard,
               visualization=visualization, profiling=profiling, quality_run=quality_run,
               results_run=results_run, sweep940=sweep940, hard_table=hard_table,
               interop=interop, jax_random=jax_random, kspace=kspace, dropout=dropout,
               flax_init=flax_init)
    draws_path(pkg, card)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        pre = preprocess_path(pkg, tmp, device)
        e2e = end_to_end(pkg, tmp, device, pre["meta"], card)
        step_ms = time_train_steps(pkg, device)
        report_train_step(step_ms, card)
        graph_path(pkg, tmp, device, pre["meta"], pre["val_meta"], card)
        module_epochs = {
            label: graph_path(pkg, tmp, device, pre["meta"], pre["val_meta"], card, label,
                              overrides)
            for label, overrides in (("module path", ("model.use_pallas=false",)),
                                     ("residual model", ("model.residual=true",)))}
        drop_masks = dropout_masks(pkg, device, card)
        drop_graph = dropout_graph_path(pkg, tmp, device, pre["meta"], pre["val_meta"], card)
        trn = train_path(pkg, tmp, device, pre["meta"], pre["val_meta"])
        qnt = quantized_path(pkg, tmp, device, pre["meta"], trn["run_dir"])
        ptr = pretraining_path(pkg, tmp, device, pre["meta"], pre["val_meta"], card)
        onl = online_path(pkg, tmp, device, card)
        mr = multirank_path(pkg, tmp, device, pre["meta"], pre["val_meta"], card)
        res = results_path(pkg, tmp, device, card)
        swp = sweep940_path(pkg, tmp, device, card)
        hrd = hard_path(pkg, tmp, device, card)
        time_preprocessing(pkg, tmp, device, card)
    per_rank = lambda name: [mr["launches"][r][name] for r in range(RANKS)]

    # ---- eval forward kernel
    mods, kp = cmp["inputs"]
    band_mods, band_kp = cmp_local.pop("band_inputs")
    args = (mods, kp.base, kp.s_w, kp.s_b, kp.last_b)
    # W^T as the main path hands it over (packed once by make_apply_fn)
    kw = dict(num_layers=5, sin7=True, sin5=True, s_wt=kp.s_w.transpose(1, 2).contiguous())
    batch, seq, hidden, layers = mods.shape[0], kp.base.shape[0], kp.base.shape[1], 5
    records = [kernel_record(
        "siren_forward", "mri_inr_tpu/ops/siren_kernel.py:156", e2e["launches"],
        cmp["max_abs_err"],
        cuda_median_ms(lambda: sk.siren_forward_cuda(*args, **kw)),
        cuda_median_ms(lambda: sk.siren_forward_reference(
            *args, **{k: v for k, v in kw.items() if k != "s_wt"})),
        2 * batch * seq * hidden * hidden * (layers - 1),
        nbytes_of(*args) + batch * seq * 4, card,
        f32_ops=siren_f32_ops(batch * seq, hidden, layers, "eval"),
        launches_train_path=trn["eval"], launches_pretraining_path=ptr["eval"],
        launches_online_path=onl["eval"] + onl["sweep"]["eval"],
        launches_multirank_path_per_rank=per_rank("siren_forward"),
        launches_results_path=res["launches"]["siren_forward"],
        launches_sweep940_path=swp["launches"]["siren_forward"],
        launches_hard_path=hrd["launches"]["siren_forward"],
        ms_per_rank_at_local_batch=cuda_median_ms(lambda: sk.siren_forward_cuda(
            mods[:LOCAL_BATCH].contiguous(), *args[1:], **kw)), local_batch=LOCAL_BATCH,
        max_abs_err_at_local_batch=cmp_local["eval_local_err"],
        ms_per_rank_at_band=cuda_median_ms(lambda: sk.siren_forward_cuda(
            band_mods, band_kp.base, band_kp.s_w, band_kp.s_b, band_kp.last_b, **kw)),
        band_patches=BAND_PATCHES, max_abs_err_at_band=cmp_local["eval_band_err"])]
    print(f"evaluate_files_device steady: bf16 chain {e2e['bf16_slices_per_sec']:.2f} "
          f"slices/s, int8 chain {e2e['int8_slices_per_sec']:.2f} slices/s "
          f"({VOLUMES * SLICES_PER_VOLUME} slices in {e2e['pieces']} batched piece(s), median "
          f"of {REPS} each, in turns; peak memory of the first sweep {e2e['peak_mb']:.1f} "
          f"MiB) [{card}]")

    # ---- int8 eval forward kernel, with the weight pack as the main path
    # hands it over (made once by make_apply_fn)
    iargs = cmp_int8["inputs"]
    swq_k = sk.int8_kernel_weights(iargs[4])
    records.append(kernel_record(
        "siren_forward_int8", "mri_inr_tpu/ops/siren_kernel.py:496", qnt["launches"],
        cmp_int8["max_abs_err"],
        cuda_median_ms(lambda: sk.siren_forward_int8_cuda(*iargs, num_layers=5, swq_t=swq_k)),
        cuda_median_ms(lambda: sk.siren_forward_int8_reference(*iargs, num_layers=5), reps=5,
                       warmup=1),
        2 * batch * seq * hidden * hidden * (layers - 1),
        nbytes_of(*iargs) + batch * seq * 4, card, peak=PEAK_INT8_OPS, unit="int8 OP",
        f32_ops=siren_f32_ops(batch * seq, hidden, layers, "int8")))

    # ---- train kernels, B=400, dropout 0.1, sin5 (the training default)
    targs, cot = cmp_train["inputs"]
    tkw = dict(num_layers=5, dropout_rate=0.1, sin5=True)
    # W^T as the train op hands it to the forward (made once a step)
    s_wt = targs[3].transpose(1, 2).contiguous()
    local_targs = (targs[0], targs[1][:LOCAL_BATCH].contiguous(), *targs[2:])
    chain = TRAIN_BATCH * seq * hidden * hidden * (layers - 1)
    records.append(kernel_record(
        "siren_train_fwd", "mri_inr_tpu/ops/siren_train_kernel.py:140", trn["fwd"],
        cmp_train["fwd_err"],
        cuda_median_ms(lambda: stk.siren_chain_train_fwd_cuda(*targs, **tkw, s_wt=s_wt)),
        cuda_median_ms(lambda: stk.siren_chain_train_fwd_reference(*targs, **tkw), reps=5,
                       warmup=1),
        2 * chain, nbytes_of(*targs) + TRAIN_BATCH * seq * 4, card,
        f32_ops=siren_f32_ops(TRAIN_BATCH * seq, hidden, layers, "train_fwd"),
        launches_pretraining_path=ptr["fwd"], launches_online_path=onl["fwd"],
        launches_multirank_path_per_rank=per_rank("siren_train_fwd"),
        launches_results_path=res["launches"]["siren_train_fwd"],
        launches_sweep940_path=swp["launches"]["siren_train_fwd"],
        launches_hard_path=hrd["launches"]["siren_train_fwd"],
        ms_per_rank_at_local_batch=cuda_median_ms(lambda: stk.siren_chain_train_fwd_cuda(
            *local_targs, **tkw, s_wt=s_wt)), local_batch=LOCAL_BATCH,
        max_abs_err_at_local_batch=cmp_local["fwd_err"]))
    grads = stk.siren_chain_train_bwd_cuda(*targs, cot, **tkw)
    parts = bwd_parts_ms(lambda: stk.siren_chain_train_bwd_cuda(*targs, cot, **tkw), card)
    # the gradient needs the forward's product, dW and dx per hidden layer:
    # 6 * chain; the chain kernel recomputes, 3L - 4 products, and the dW
    # kernel runs L - 1
    records.append(kernel_record(
        "siren_train_bwd", "mri_inr_tpu/ops/siren_train_kernel.py:199", trn["bwd"],
        cmp_train["bwd_err"],
        cuda_median_ms(lambda: stk.siren_chain_train_bwd_cuda(*targs, cot, **tkw)),
        cuda_median_ms(lambda: stk.siren_chain_train_bwd_reference(*targs, cot, **tkw),
                       reps=5, warmup=1),
        6 * chain, nbytes_of(*targs, cot, *grads), card,
        executed_flops=2 * chain * (3 * layers - 4 + layers - 1) // (layers - 1),
        f32_ops=siren_f32_ops(TRAIN_BATCH * seq, hidden, layers, "train_bwd"),
        launches_pretraining_path=ptr["bwd"], launches_online_path=onl["bwd"],
        launches_multirank_path_per_rank=per_rank("siren_train_bwd"),
        launches_results_path=res["launches"]["siren_train_bwd"],
        launches_sweep940_path=swp["launches"]["siren_train_bwd"],
        launches_hard_path=hrd["launches"]["siren_train_bwd"],
        ms_per_rank_at_local_batch=cuda_median_ms(lambda: stk.siren_chain_train_bwd_cuda(
            *local_targs, cot[:LOCAL_BATCH].contiguous(), **tkw)), local_batch=LOCAL_BATCH,
        max_abs_err_at_local_batch=cmp_local["bwd_err"], **parts))

    # ---- dropout kernel: one hidden layer's mask at the train batch, the
    # launches of phase 18's graphed module epoch
    records.append(kernel_record(
        "threefry_dropout",
        "none: the JAX module path's dropout bits come from XLA (mri_inr_tpu/models/siren.py:80 "
        "nn.Dropout -> jax.random.bernoulli)", drop_graph["launches"],
        float(drop_masks["wrong"]), drop_masks["ms"], drop_masks["plain_ms"],
        DROPOUT_INT_OPS * drop_masks["numel"], drop_masks["numel"] + 8, card,
        peak=PEAK_F32_FLOPS, unit="int32 OP", ops_term="int32 operations",
        launches_per_step=drop_graph["layers"],
        launches_results_path=res["launches"]["threefry_dropout"],
        launches_hard_path=hrd["launches"]["threefry_dropout"]))
    for label, out in module_epochs.items():
        g = out["graphed"]["wall_ms"]
        print(f"{label} epoch, graphed (phase 7, Flax's masks by the dropout kernel, "
              f"{drop_graph['layers']} launches a step): {drop_graph['steps'] / g * 1e3:.2f} "
              f"steps/s ({g:.4f} ms an epoch of {drop_graph['steps']} steps) [{card}]")

    # ---- DFT kernel: the preprocessing call (inverse, magnitude) at one
    # fastMRI brain volume; the other shapes beside it
    def dft_times(x):
        return (cuda_median_ms(lambda: fk.dft2c_ri_cuda(x, magnitude=True)),
                cuda_median_ms(lambda: fk.dft2c_ri_reference(x, magnitude=True)),
                cuda_median_ms(lambda: fft_route(x)))

    # The function (a centred 2-D DFT with magnitude) needs an FFT's operations,
    # about 5 * N * HW * log2(HW), and reads its input once and writes its
    # output once: it is bound by those bytes.
    for shape, x in cmp_dft["inputs"].items():
        n, h, w = shape
        t_kernel, t_plain, t_lib = dft_times(x)
        fft_ops = 5 * n * h * w * math.log2(h * w)
        nbytes = nbytes_of(x) + n * h * w * 4
        if shape != FASTMRI_SHAPE:
            bound_ms = max(fft_ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
            print(f"dft2c {shape}, inverse + magnitude: kernel {t_kernel:.4f} ms/call, plain "
                  f"version {t_plain:.4f}, torch.fft route {t_lib:.4f}; bound {bound_ms:.4f} "
                  f"ms [{card}]")
            continue
        records.append(kernel_record(
            "dft2c", "mri_inr_tpu/ops/fft_kernel.py:50", pre["launches"],
            cmp_dft["max_abs_err"], t_kernel, t_plain, fft_ops, nbytes, card,
            peak=PEAK_F32_FLOPS, unit="f32 FLOP", library_ms=t_lib,
            launches_online_path=onl["dft"] + onl["sweep"]["dft"],
            launches_results_path=res["launches"]["dft2c"],
            launches_sweep940_path=swp["launches"]["dft2c"],
        launches_hard_path=hrd["launches"]["dft2c"]))
        print(f"dft2c {shape}: the FFT kernel takes {t_kernel / t_lib:.2f}x the torch.fft "
              f"route's time [{card}]")
    for rec in records:
        if "ms_per_rank_at_local_batch" in rec:
            band = ("" if "band_patches" not in rec else
                    f"; at a piece of {rec['band_patches']} patches "
                    f"{rec['ms_per_rank_at_band']:.4f} ms/call, max |diff| "
                    f"{rec['max_abs_err_at_band']:.3e}")
            print(f"{rec['name']} at a rank's local batch of {rec['local_batch']} (phase 13): "
                  f"{rec['ms_per_rank_at_local_batch']:.4f} ms/call, timed alone, max |diff| "
                  f"from the plain version {rec['max_abs_err_at_local_batch']:.3e}{band}; "
                  f"launches per rank on the 2-rank path "
                  f"{rec['launches_multirank_path_per_rank']} [{card}]")
    secs = trn["epoch_seconds"]
    med, n = statistics.median(secs), trn["steps_per_epoch"]
    print(f"steady graphed train epochs through the CLI (device_data, {n} steps of batch "
          f"{TRAIN_BATCH} and {trn['val_batches']} validation batches an epoch, one replay "
          f"each, {len(secs)} epochs): median {med:.4f} s an epoch (min {min(secs):.4f}, max "
          f"{max(secs):.4f}) = {n / med:.2f} steps/s (min {n / max(secs):.2f}, max "
          f"{n / min(secs):.2f}), {n * TRAIN_BATCH / med:.1f} patches/s; the run's first "
          f"epoch (eager, the capture's warm-up, then the validation graph's capture) "
          f"{trn['eager_epoch_seconds']:.4f} s, its second (the train graph's capture, "
          f"then its first replay) {trn['capture_epoch_seconds']:.4f} s; one eager train "
          f"step {step_ms['fused']:.4f} ms [{card}]")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
