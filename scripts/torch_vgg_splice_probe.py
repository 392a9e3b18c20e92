#!/usr/bin/env python3
"""How often, and why, a SIREN with a spliced VGG trunk fails to train in
``chip_smoke.py``'s pretraining phase: the phase-4 slices, a VGG
autoencoder pretrained for one epoch (``train_encoder --model vgg``), then
the train CLI with ``model.encoder_type=vgg`` and that file for two epochs at
``configs/train.yaml``'s width (graphed, ``training.device_data=true``).

    python3 scripts/torch_vgg_splice_probe.py [--case LR:SEED,SEED,...]... \
        [--cpu-steps 4]

Each ``--case`` pretrains one autoencoder per seed at the rate LR (the
card's cuDNN backward is not bit-repeatable, so a seed given twice gives two
autoencoders); the default is ``1e-3:0,1,2,3,4,5,6,7``, ``train_encoder``'s
default rate. Each run prints: the autoencoder's loss, the trunk's
features on the first train batch (mean, largest, share of zeros), the
latent's RMS, the graphed run's initial and per-epoch losses, and the
per-step losses of the same two epochs run step by step (the fused kernels
without a graph). For the first run whose train loss does not fall, the
first ``--cpu-steps`` steps run once more on the CPU (the plain versions),
from the same file.

``--grads``: instead, pretrain autoencoders at 1e-3 until one gives trunk
features of mean above 1 (the regime where the runs above stall), and for
that file compare, on the first train batch: the train kernels against
their plain versions on the card at the step's own inputs, and one step's
gradients on the card against the CPU's, parameter by parameter. Needs the
CUDA toolkit and a card; imports no JAX.

``--plain-card N``: instead, find N such autoencoders and train each
spliced SIREN for two epochs step by step twice on the card: through the
kernels, and through the kernels' plain versions (same order of operations
in the forward and in the backward's recomputed forward).

``--plain-row ROW``: instead, the ``cli/results_run`` row ROW at the first
of ``--seeds`` for ``--epochs`` epochs on the card twice, from one set of
splits and one autoencoder: through the train kernels, and through their
plain versions (the same operations in PyTorch, as ``--plain-card``). The
arguments this script does not know go to ``results_run`` (e.g. ``--set
training.sin5=false``). Writes both runs' per-epoch train and validation
losses, metrics and launches to ``--out`` (JSON). On the CPU both runs take
the plain versions.

``--ae-draws``: instead, the VGG autoencoder's pretraining alone, as
``cli/results_run`` runs it (``train_encoder --model vgg``, batch 256, lr
1e-3), on the quality protocol's train split of each ``--corpus`` (24
phantom volumes x 4 slices at 256x256; ``hard``: ``cli/hard_table``'s
corpus), for each of ``--seeds`` and ``--epochs`` epochs, twice: with
cuDNN's TF32 convolutions (torch's default, as the port runs) and with TF32
off. Per step: the loss and the standard deviations of the reconstruction
and of the batch; per run: the first step whose reconstruction is not
flat (its std at least a tenth of the batch's), the step from which it
stays flat to the end, and the sum of the initial weights (the torch
generator draws them on the CPU at the seed, by this torch's
``trunc_normal_``), against which ``tests/vgg_ae_cross_package.py`` checks
that it starts the JAX package's step from the same weights. Writes
``--out`` (JSON). Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--case", action="append", default=[],
                        help="LR:SEED,SEED,... (repeatable)")
    parser.add_argument("--cpu-steps", type=int, default=4)
    parser.add_argument("--grads", action="store_true")
    parser.add_argument("--plain-card", type=int, default=0, metavar="N")
    parser.add_argument("--plain-row", default=None, metavar="ROW")
    parser.add_argument("--ae-draws", action="store_true")
    parser.add_argument("--corpus", default="smooth,hard", help="--ae-draws: smooth, hard or both")
    parser.add_argument("--seeds", default="0,1,2,3,4,5,6,7",
                        help="--ae-draws: the autoencoders' seeds")
    parser.add_argument("--epochs", type=int, default=3,
                        help="--ae-draws, --plain-row: epochs a run")
    parser.add_argument("--out", default=None, help="--ae-draws, --plain-row: a JSON file")
    args, rest = parser.parse_known_args()
    if rest and not args.plain_row:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    sys.path.insert(0, str(REPO))
    if args.ae_draws:
        return autoencoder_draws(args)
    if args.plain_row:
        return plain_row(args, rest)
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mri_inr_tpu_torch.cli import train as cli
    from mri_inr_tpu_torch.cli import train_encoder as te
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.data import preprocessing, synthetic
    from mri_inr_tpu_torch.ops import _build
    from mri_inr_tpu_torch.train import trainer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    cs.build_kernels(_build, ["siren_forward", "siren_train_fwd", "siren_train_bwd", "dft2c"])
    pkg = dict(synthetic=synthetic, preprocessing=preprocessing)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        meta, _ = cs.preprocess_volumes(pkg, tmp / "processed", range(cs.VOLUMES), dev,
                                        cs.SLICES_PER_VOLUME)
        val_meta, _ = cs.preprocess_volumes(pkg, tmp / "val", [100], dev, 4)
        if args.grads:
            return grads(cli, te, config, tr, meta, val_meta, tmp, dev)
        if args.plain_card:
            return plain_card(cli, te, config, tr, meta, val_meta, tmp, dev, args.plain_card)
        cpu_done = False
        runs = [(lr, int(seed)) for case in (args.case or ["1e-3:0,1,2,3,4,5,6,7"])
                for lr, seeds in [case.split(":")] for seed in seeds.split(",")]
        for r, (lr, seed) in enumerate(runs):
            out = tmp / f"ae{r}"
            res = te.main(["--dataset", str(meta), "--output", str(out), "--model", "vgg",
                           "--epochs", "1", "--seed", str(seed), "--lr", lr])
            ae_file = te.checkpoint_paths(out, "vgg", 0)[0]
            sets = [f"data.train.dataset={meta}", f"data.val.dataset={val_meta}",
                    "training.save_interval=1000", "training.device_data=true",
                    f"training.output_dir={tmp / 'out'}", f"training.output_name=vgg{r}",
                    "training.epochs=2", "model.encoder_type=vgg",
                    f"model.encoder_path={ae_file}"]
            argv = ["--config", str(REPO / "configs" / "train.yaml")]
            argv += [x for s in sets for x in ("--set", s)]
            cfg = config.load_train_configuration(REPO / "configs" / "train.yaml", sets)
            # the spliced model before any step: features and latents
            model = cli.build_model(cfg, dev, log=lambda *_: None)
            train_ds = cli._dataset(cfg.data.train, cfg.data, cfg.model)
            fully, under = next(train_ds.batches(cfg.training.batch_size, seed=0))
            under_t = torch.from_numpy(under).to(dev)
            with torch.no_grad():
                feats = model.encoder.encoder.trunk(under_t).float()
                latent = model.encoder(under_t).float()
            t = cli.main(argv)
            graphed = [t.initial_losses[0]] + [p["train_loss"] for p in t._progress]
            # the same two epochs step by step, from a fresh copy of the model
            step_losses = per_step(cli, tr, cfg, dev, train_ds, epochs=2)
            fell = graphed[-1] < graphed[0]
            print(f"run {r} (lr {lr}, seed {seed}): AE loss {res['losses'][-1]:.6f}; trunk "
                  f"features mean {feats.mean():.4f} max {feats.max():.4f} zeros {(feats == 0).float().mean():.3f}"
                  f"; latent RMS {latent.square().mean().sqrt():.4f}; graphed train loss "
                  f"initial {graphed[0]:.6f} epochs {', '.join(f'{x:.6f}' for x in graphed[1:])}"
                  f" ({'falls' if fell else 'DOES NOT FALL'}); step by step on the card: "
                  + " ".join(f"{x:.4f}" for x in step_losses))
            if not fell and not cpu_done and args.cpu_steps:
                cpu_losses = per_step(cli, tr, cfg, torch.device("cpu"), train_ds, epochs=1,
                                      limit=args.cpu_steps)
                print(f"run {r} on the CPU (plain versions), first {args.cpu_steps} steps: "
                      + " ".join(f"{x:.4f}" for x in cpu_losses))
                cpu_done = True
    return 0


def vgg_config(config, meta, val_meta, tmp, ae_file, name):
    sets = [f"data.train.dataset={meta}", f"data.val.dataset={val_meta}",
            f"training.output_dir={tmp / 'out'}", f"training.output_name={name}",
            "model.encoder_type=vgg", f"model.encoder_path={ae_file}"]
    return config.load_train_configuration(REPO / "configs" / "train.yaml", sets)


def grads(cli, te, config, tr, meta, val_meta, tmp, dev) -> int:
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.ops import tiling

    for k in range(12):
        out = tmp / f"g{k}"
        te.main(["--dataset", str(meta), "--output", str(out), "--model", "vgg", "--epochs", "1"])
        cfg = vgg_config(config, meta, val_meta, tmp, te.checkpoint_paths(out, "vgg", 0)[0],
                         f"g{k}")
        model = cli.build_model(cfg, dev, log=lambda *_: None)
        train_ds = cli._dataset(cfg.data.train, cfg.data, cfg.model)
        fully, under = next(train_ds.batches(cfg.training.batch_size, seed=0))
        with torch.no_grad():
            feats = model.encoder.encoder.trunk(torch.from_numpy(under).to(dev))
        mean = float(feats.float().mean())
        print(f"autoencoder {k}: trunk features mean {mean:.4f}")
        if mean > 1.0:
            break
    seed = tr.step_seed(cfg.training.seed + 1, 0)
    mcfg = cfg.model
    res = {}
    for d in (dev, torch.device("cpu")):
        m = cli.build_model(cfg, d, log=lambda *_: None)
        f, u = torch.from_numpy(fully).to(d), torch.from_numpy(under).to(d)
        latent = m.encode(u)
        kp = sk.extract_kernel_params(m, sk.coordinate_grid(24, d))
        mods = sk.compute_modulations(kp, latent.float(), num_layers=mcfg.num_layers)
        target = tiling.extract_center_batch(f, 32, 24).float()
        pred = stk.fused_train_apply(m, u, seed, sin5=cfg.training.sin5)
        loss = cli.build_loss_fn(cfg, d)(pred.float(), target)
        loss.backward()
        res[d.type] = dict(loss=float(loss.detach()), latent=latent.detach().float().cpu(),
                           mods=mods.detach().cpu(), pred=pred.detach().float().cpu(),
                           grads={n: p.grad.detach().float().cpu()
                                  for n, p in m.named_parameters() if p.grad is not None})
        if d.type == "cuda":
            # the kernels against their plain versions, on the card, at these inputs
            knobs = dict(num_layers=mcfg.num_layers, w0=float(m.w0), activation=m.activation,
                         dropout_rate=float(m.dropout), sin5=cfg.training.sin5)
            st = stk.seed_tensor(seed, d)
            args_ = [x.detach().contiguous() for x in
                     (mods, kp.base, kp.s_w, kp.s_b, kp.last_w, kp.last_b)]
            yk = stk.siren_chain_train_fwd_cuda(st, *args_, **knobs)
            yr = stk.siren_chain_train_fwd_reference(st, *args_, **knobs)
            g = torch.randn(yk.shape, generator=torch.Generator(d).manual_seed(0), device=d)
            bk = stk.siren_chain_train_bwd_cuda(st, *args_, g, **knobs)
            br = stk.siren_chain_train_bwd_reference(st, *args_, g, **knobs)
            print(f"card kernels at the step's inputs: |mods| max {mods.abs().max():.4f}, "
                  f"mean {mods.abs().mean():.4f}; forward max |diff| "
                  f"{(yk - yr).abs().max():.3e} (|y| max {yr.abs().max():.3f})")
            for name, a, b in zip(("dmods", "dbase", "dsw", "dsb", "dlw", "dlb"), bk, br):
                print(f"  {name}: max |diff| {(a - b).abs().max():.3e}, relative norm "
                      f"{float((a - b).norm() / b.norm().clamp_min(1e-30)):.3e}, |plain| max "
                      f"{b.abs().max():.3e}")
            # how well posed the forward is at these modulations, and at 1/20 of them:
            # the plain version on the CPU, and on the card with mods 1e-6 apart
            for scale in (1.0, 0.05):
                a0 = [args_[0] * scale, *args_[1:]]
                ref = stk.siren_chain_train_fwd_reference(st, *a0, **knobs)
                cpu = stk.siren_chain_train_fwd_reference(
                    st.cpu(), *[x.cpu() for x in a0], **knobs).to(d)
                nudged = stk.siren_chain_train_fwd_reference(
                    st, a0[0] * (1 + 1e-6), *a0[1:], **knobs)
                kern = stk.siren_chain_train_fwd_cuda(st, *a0, **knobs)
                print(f"  mods x {scale:g} (|mods| mean {a0[0].abs().mean():.4f}): plain card vs "
                      f"plain CPU max |diff| {(ref - cpu).abs().max():.3e}, mean "
                      f"{(ref - cpu).abs().mean():.3e}; plain with mods x (1 + 1e-6) max "
                      f"|diff| {(ref - nudged).abs().max():.3e}, mean "
                      f"{(ref - nudged).abs().mean():.3e}; kernel vs plain max |diff| "
                      f"{(kern - ref).abs().max():.3e}, mean {(kern - ref).abs().mean():.3e}")
    c, g = res["cpu"], res["cuda"]
    print(f"loss card {g['loss']:.6f} CPU {c['loss']:.6f}; latent relative "
          f"{float((g['latent'] - c['latent']).norm() / c['latent'].norm()):.3e}; mods relative "
          f"{float((g['mods'] - c['mods']).norm() / c['mods'].norm()):.3e}; pred max |diff| "
          f"{(g['pred'] - c['pred']).abs().max():.3e}")
    for n, gc in c["grads"].items():
        gg = g["grads"][n]
        big = gc.abs() > 1e-3 * gc.abs().max()
        agree = float((torch.sign(gg) == torch.sign(gc))[big].float().mean()) if big.any() else 1.0
        print(f"  grad {n} {tuple(gc.shape)}: relative norm "
              f"{float((gg - gc).norm() / gc.norm().clamp_min(1e-30)):.3e}, signs agree "
              f"{agree:.4f} (of |g| > 1e-3 max), |g| max {gc.abs().max():.3e}")
    return 0


def plain_card(cli, te, config, tr, meta, val_meta, tmp, dev, want: int) -> int:
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk

    kernels = (stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda)
    plain = (lambda *a, s_wt=None, **k: stk.siren_chain_train_fwd_reference(*a, **k),
             lambda *a, s_wt=None, **k: stk.siren_chain_train_bwd_reference(*a, **k))
    found = 0
    for k in range(16):
        out = tmp / f"p{k}"
        te.main(["--dataset", str(meta), "--output", str(out), "--model", "vgg", "--epochs", "1"])
        cfg = vgg_config(config, meta, val_meta, tmp, te.checkpoint_paths(out, "vgg", 0)[0],
                         f"p{k}")
        model = cli.build_model(cfg, dev, log=lambda *_: None)
        train_ds = cli._dataset(cfg.data.train, cfg.data, cfg.model)
        _, under = next(train_ds.batches(cfg.training.batch_size, seed=0))
        with torch.no_grad():
            mean = float(model.encoder.encoder.trunk(torch.from_numpy(under).to(dev))
                         .float().mean())
        if not 1.0 < mean < 1e3:
            print(f"autoencoder {k}: trunk features mean {mean:.4f}, skipped")
            continue
        runs = {}
        for label, (fwd, bwd) in (("kernels", kernels), ("plain", plain)):
            stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda = fwd, bwd
            try:
                runs[label] = per_step(cli, tr, cfg, dev, train_ds, epochs=2)
            finally:
                stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda = kernels
        print(f"autoencoder {k}: trunk features mean {mean:.4f}")
        for label, losses in runs.items():
            print(f"  {label:8s} first 4 mean {np.mean(losses[:4]):.4f}, last 4 mean "
                  f"{np.mean(losses[-4:]):.4f}: " + " ".join(f"{x:.4f}" for x in losses))
        found += 1
        if found == want:
            break
    return 0


def plain_row(args, rest: list[str]) -> int:
    import csv
    import json

    from mri_inr_tpu_torch.cli import results_run as rr
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk

    def counted(fn):  # a graph's replay advances the wrapper's launches
        def call(*a, s_wt=None, **k):
            call.launches += 1
            return fn(*a, **k)

        call.launches = 0
        return call

    kernels = (stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda)
    plain = (counted(stk.siren_chain_train_fwd_reference),
             counted(stk.siren_chain_train_bwd_reference))
    seed = int(args.seeds.split(",")[0])
    argv = ["--seed", str(seed), "--rows", args.plain_row, "--epochs", str(args.epochs), *rest]
    report = {"row": args.plain_row, "results_run": argv, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        first = pathlib.Path(tmp) / "kernels"
        for label, (fwd, bwd) in (("kernels", kernels), ("plain", plain)):
            root = pathlib.Path(tmp) / label
            if root != first:  # the first run's protocol, splits and autoencoders
                root.mkdir()
                for entry in first.iterdir():
                    if entry.name == "protocol.json":
                        (root / entry.name).write_text(entry.read_text())
                    elif entry.name == "data" or entry.name.startswith("encoder"):
                        (root / entry.name).symlink_to(entry)
            stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda = fwd, bwd
            try:
                rec = next(iter(rr.main(["--root", str(root), *argv]).values()))
            finally:
                stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda = kernels
            with open(pathlib.Path(rec["run_dir"]) / "progress_log.csv") as fh:
                log = list(csv.DictReader(fh))
            run = {k: [float(e[k]) for e in log] for k in ("train_loss", "val_loss")}
            run.update({m: rec[m]["mean"] for m in ("PSNR", "SSIM", "NRMSE")},
                       launches=rec["launches"], plain_launches=[f.launches for f in plain],
                       trunk_features=rec.get("trunk_features"),
                       train_seconds=rec["train_seconds"], device=rec["device"])
            report["runs"][label] = run
            print(f"{label}: train loss " + " ".join(f"{x:.4f}" for x in run["train_loss"])
                  + f"; PSNR {run['PSNR']:.4f}; launches {run['launches']}, plain "
                  f"{run['plain_launches']}; {run['train_seconds']:.1f} s", flush=True)
            if args.out:
                pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                pathlib.Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


CORPORA = {"smooth": {"phase": False, "snr_db": None, "texture": 0.0}}
FLAT = 0.1  # a reconstruction is flat while its std is below FLAT x the batch's


def flat_from(out_std: list, x_std: list) -> int | None:
    """The first step from which the reconstruction stays flat to the end
    (None: it is not flat at the last step)."""
    step = None
    for i, (o, x) in enumerate(zip(out_std, x_std)):
        if o >= FLAT * x:
            step = None
        elif step is None:
            step = i
    return step


def structured_from(out_std: list, x_std: list) -> int | None:
    """The first step whose reconstruction is not flat (None: none is; an
    autoencoder's reconstruction starts flat, a constant)."""
    return next((i for i, (o, x) in enumerate(zip(out_std, x_std)) if o >= FLAT * x), None)


def train_split(corpus: str, root: pathlib.Path, dev: torch.device) -> pathlib.Path:
    """The quality protocol's train split of ``corpus`` (24 phantom volumes x
    4 slices at 256x256), preprocessed on ``dev`` under ``root`` (reused
    where it is there)."""
    from mri_inr_tpu_torch.cli import hard_table as ht
    from mri_inr_tpu_torch.cli import quality_run as qr

    pargs = argparse.Namespace(size=256, slices=4, **{**CORPORA, "hard": ht.HARD}[corpus])
    return qr.make_split(root / corpus, 24, qr.SPLIT_SEEDS["train"], pargs, dev)


def weight_sum(model: torch.nn.Module) -> float:
    return float(sum(p.detach().double().sum().cpu() for p in model.parameters()))


def autoencoder_draws(args) -> int:
    import json
    import time

    from mri_inr_tpu_torch.cli import quality_run as qr
    from mri_inr_tpu_torch.cli import train_encoder as te

    seeds = [int(x) for x in args.seeds.split(",")]
    dev = torch.device("cuda")
    report = {"batch": 256, "lr": 1e-3, "flat_below": FLAT, "torch": torch.__version__,
              "device": qr.card_name(), "runs": []}
    print(report["device"], flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for corpus in args.corpus.split(","):
            t0 = time.perf_counter()
            meta = train_split(corpus, pathlib.Path(tmp) / "data", dev)
            print(f"{corpus} train split: {meta} ({time.perf_counter() - t0:.1f}s)", flush=True)
            for seed in seeds:
                for tf32 in (True, False):
                    torch.backends.cudnn.allow_tf32 = tf32
                    report["runs"].append(draw(args, te, meta, corpus, seed, tf32, dev,
                                               pathlib.Path(tmp) / "ae"))
                torch.backends.cudnn.allow_tf32 = True
                if args.out:
                    pathlib.Path(args.out).write_text(json.dumps(report) + "\n")
    return 0


def draw(args, te, meta, corpus: str, seed: int, tf32: bool, dev, out: pathlib.Path) -> dict:
    """One VGG autoencoder pretrained by ``train_encoder.train`` at ``seed``,
    every step's loss and stds recorded."""
    import shutil

    model, patch = te.build_autoencoder("vgg", seed=seed, device=dev)
    init = weight_sum(model)
    rec = {"loss": [], "out_std": [], "x_std": []}

    def on_step(epoch, x, loss, y):
        rec["loss"].append(loss)
        rec["out_std"].append(y.std())
        rec["x_std"].append(x.std())

    ns = argparse.Namespace(dataset=str(meta), batch_size=256, lr=1e-3, epochs=args.epochs,
                            output=str(out), model="vgg")
    res = te.train(ns, model, patch, dev, on_step)
    shutil.rmtree(out, ignore_errors=True)
    rec = {k: [float(x) for x in torch.stack(v).cpu()] for k, v in rec.items()}
    flat = flat_from(rec["out_std"], rec["x_std"])
    structured = structured_from(rec["out_std"], rec["x_std"])
    run = {"corpus": corpus, "seed": seed, "numerics": "tf32" if tf32 else "fp32",
           "initial_weight_sum": init, "steps_per_epoch": res["steps_per_epoch"],
           "epoch_losses": res["losses"], "structured_from_step": structured,
           "flat_from_step": flat, **rec}
    print(f"{corpus} seed {seed} {run['numerics']}: initial weight sum {init:.10g}; epoch "
          f"losses {', '.join(f'{x:.6f}' for x in res['losses'])}; reconstruction std at the "
          f"last step {rec['out_std'][-1]:.4g} (batch {rec['x_std'][-1]:.4g}); structured from "
          f"step {structured}, flat from step {flat}; losses at steps 0, 10, 20, 40, 80: "
          + " ".join(f"{rec['loss'][i]:.5f}" for i in (0, 10, 20, 40, 80)
                     if i < len(rec["loss"])), flush=True)
    return run


def per_step(cli, tr, cfg, dev, train_ds, epochs: int, limit: int | None = None) -> list:
    """Train losses of the CLI's model, step by step on ``dev`` (host
    batches; on the card the fused kernels, without a graph)."""
    model = cli.build_model(cfg, dev, log=lambda *_: None)
    state = tr.create_train_state(model, cfg.training.optimizer, cfg.training.lr)
    step = tr.make_train_step(model, cli.build_loss_fn(cfg, dev), 32, 24, use_pallas=True,
                              sin5=cfg.training.sin5)
    losses = []
    for epoch in range(epochs):
        for fully, under in train_ds.batches(cfg.training.batch_size, seed=epoch):
            losses.append(step(state, torch.from_numpy(fully).to(dev),
                               torch.from_numpy(under).to(dev), cfg.training.seed + 1))
            if limit is not None and len(losses) == limit:
                return [float(x) for x in losses]
    return [float(x) for x in np.asarray(torch.stack(losses).cpu())]


if __name__ == "__main__":
    sys.exit(main())
