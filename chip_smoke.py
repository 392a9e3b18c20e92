#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``mri_inr_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. It imports nothing of JAX. Phases:

1. the card's name and power limit, torch and CUDA versions; TF32 off for
   matmuls and cuDNN so every comparison below is in full f32;
2. build every CUDA kernel of the eval path from ``mri_inr_tpu_torch/ops/
   csrc`` (one nvcc per source, started together);
3. each kernel against its plain PyTorch version at full width (H=256, L=5,
   S=576, B=1024 = one 320x320 slice's patch bucket), seeded weights;
4. the eval path end to end through the user entry points: 16 phantom
   slices (320x320, .npy + metadata.csv), the model from configs/test.yaml
   with seeded init, MRISampler -> SliceReconstructor on one slice, then
   evaluate_files_device on all 16 and write_metrics_artifacts; the kernel
   launch counts are reset just before and read just after; two slices are
   scored again on the CPU through the plain versions and must agree;
5. times with CUDA events (warm-up, 20 reps, median): the kernel and its
   plain version per call at B=1024, and the steady sweep rate.

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
    for name in names:  # build from the checkout's sources, never a leftover
        (build_mod.BUILD_DIR / f"lib{name}.so").unlink(missing_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(lambda n: build_mod.build(n)[1], names)))
    print(f"build: {len(names)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
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
def write_dataset(root: pathlib.Path, undersample_column, phantom_volume) -> pathlib.Path:
    """Phantom slices + undersampled copies (centred FFT, column mask with
    centre fraction 0.05 and acceleration 6) + metadata.csv."""
    col = undersample_column(0.05, 6)
    rng = np.random.default_rng(SEED)
    size = SLICE_SIZE
    rows = []
    for v in range(VOLUMES):
        stem = f"file_brain_AXFLAIR_{v:06d}"
        vol = phantom_volume(v, num_slices=SLICES_PER_VOLUME, height=size, width=size,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if not (REPO / "mri_inr_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the mri_inr_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.data import dataset, synthetic
    from mri_inr_tpu_torch.eval import evaluate as ev
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.ops import _build
    from mri_inr_tpu_torch.ops import siren_kernel as sk

    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: comparisons run in full f32")

    build_kernels(_build, ["siren_forward"])
    cmp = compare_kernel(sk, ms, device)

    pkg = dict(config=config, dataset=dataset, synthetic=synthetic, ev=ev, ms=ms, sk=sk)
    with tempfile.TemporaryDirectory() as tmp:
        e2e = end_to_end(pkg, pathlib.Path(tmp), device)

    mods, kp = cmp["inputs"]
    args = (mods, kp.base, kp.s_w, kp.s_b, kp.last_b)
    kw = dict(num_layers=5, sin7=True, sin5=True)
    kernel_ms = cuda_median_ms(lambda: sk.siren_forward_cuda(*args, **kw))
    plain_ms = cuda_median_ms(lambda: sk.siren_forward_reference(*args, **kw))
    batch, seq, hidden, layers = mods.shape[0], kp.base.shape[0], kp.base.shape[1], 5
    flops = 2 * batch * seq * hidden * hidden * (layers - 1)
    nbytes = sum(t.numel() * t.element_size() for t in args) + batch * seq * 4
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"siren_forward kernel B={batch}: {kernel_ms:.4f} ms/call median of {REPS} "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s) [{card}]")
    print(f"siren_forward plain version B={batch}: {plain_ms:.4f} ms/call median of "
          f"{REPS} [{card}]")
    print(f"siren_forward bound: {flops:.3e} bf16 FLOP -> {ops_ms:.4f} ms, {nbytes} B -> "
          f"{bytes_ms:.4f} ms; kernel at {bound_ms / kernel_ms:.1%} of bound [{card}]")
    print(f"evaluate_files_device steady: {e2e['slices_per_sec']:.2f} slices/s "
          f"({VOLUMES * SLICES_PER_VOLUME} slices, bucket 1024, median of {REPS}) [{card}]")

    print(json.dumps({"kernels": [{
        "name": "siren_forward",
        "route": "cuda",
        "source": "mri_inr_tpu_torch/ops/csrc/siren_forward.cu",
        "replaces": "mri_inr_tpu/ops/siren_kernel.py:156",
        "launches": e2e["launches"],
        "max_abs_err": cmp["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
