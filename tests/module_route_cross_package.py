#!/usr/bin/env python3
"""A row's first train steps in the port and in the JAX package on the CPU,
side by side, from the same draws: the counterpart, across packages, of
``cli/results_run --rows residual`` or ``--rows vgg_frozen_corpus`` (which
run the port alone on the card). It imports the JAX package, so it lives
with the tests; pytest does not collect it.

    python tests/module_route_cross_package.py [--steps 120] [--dropouts 0.1,0] \\
        [--trunk residual|vgg] [--ill-posed SCALE] [--route fused|module|both] \\
        [--set model.dim_hidden=64 ...] [--batch 64] [--data-root DIR] [--out F.json]

The model is ``configs/train.yaml``'s in fp32 with the row's settings and
``--set`` overrides: run here at a cut size (the defaults: H=64, latent 64,
batch 64; the card runs H=256, batch 400). ``--trunk residual`` (the
default) is the smooth ``residual`` row's model (``model.residual=true``);
``--trunk vgg`` is ``vgg_frozen_corpus``'s (``model.encoder_type=vgg``,
``training.freeze_encoder=true``), and ``--ill-posed SCALE`` multiplies
every trunk kernel of the drawn VGG by SCALE, as
``tests/test_torch_port_frozen_trunk.py`` builds its ill-posed trunk (the
trunk's feature mean and max over the split are reported). Both sides
start from the JAX package's ``init(jax.random.key(seed))``, transplanted
into the port; with ``--encoder F`` the port's conv autoencoder file is
spliced into the port's model and the whole tree then copied into Flax.

Each ``--route`` steps with ``training.optimizer`` at ``training.lr`` over
the same batches (``make_epoch_perm(n, batch, epoch, shuffle=True)`` of the
protocol's smooth train split, ``--train-files`` phantom volumes of
``--slices`` slices at ``--size``, preprocessed on the CPU under
``--data-root``), the dropout base key ``training.seed + 1`` as the train
CLI's:

- module: the JAX package's ``make_train_step(use_pallas=False)`` (Flax's
  masks under ``fold_in(key(seed + 1), step)``) against the port's module
  path (the same masks, ``ops/dropout.py``);
- fused: ``make_train_step(use_pallas=True, interpret=True, sin5=...)``
  against the port's fused path (the kernels' plain versions, the seeds of
  ``train/trainer.py:epoch_seeds``).

The port steps through its scan epoch (``make_scan_epoch``, one batch a
call), the route a row's ``training.device_data`` epoch takes. Per step:
every stepper's loss, the relative gap between the packages on each route
and, with ``--route both``, between the routes within each package; every
``--gap-every`` steps the largest parameter gap between the packages on
each route; per dropout rate each stepper's first non-finite step (a
stepper stops there) and each route's first step whose loss gap exceeds
1e-3. About 0.2 s a step on each side for the residual model at the
defaults.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from mri_inr_tpu.configuration import config as jconfig  # noqa: E402
from mri_inr_tpu.models import modulated_siren as jms  # noqa: E402
from mri_inr_tpu.train import losses as jlosses  # noqa: E402
from mri_inr_tpu.train import trainer as jtrainer  # noqa: E402
from mri_inr_tpu_torch import interop  # noqa: E402
from mri_inr_tpu_torch.cli import quality_run as qr  # noqa: E402
from mri_inr_tpu_torch.cli import train as cli_train  # noqa: E402
from mri_inr_tpu_torch.configuration import config as tconfig  # noqa: E402
from mri_inr_tpu_torch.models import modulated_siren as tms  # noqa: E402
from mri_inr_tpu_torch.train import losses as tlosses  # noqa: E402
from mri_inr_tpu_torch.train import trainer as ttrainer  # noqa: E402

GAP_BAR = 1e-3  # the relative loss gap whose first crossing is reported
CUT = ("model.dim_hidden=64", "model.latent_dim=64")
TRUNKS = {"residual": ("model.residual=true",),
          "vgg": ("model.encoder_type=vgg", "training.freeze_encoder=true")}


def train_split(data_root: pathlib.Path, args) -> pathlib.Path:
    """The protocol's smooth train split (phantom seeds from 0)."""
    ap = argparse.ArgumentParser()
    qr.add_protocol_args(ap, str(data_root))
    proto = ap.parse_args(["--train-files", str(args.train_files), "--slices",
                           str(args.slices), "--size", str(args.size)])
    return qr.make_split(data_root / "data" / "train", proto.train_files, 0, proto,
                         torch.device("cpu"))


def initial_params(jm, tm, tcfg, args) -> dict:
    """The JAX package's draw (numpy), every VGG trunk kernel times
    ``--ill-posed``, or with ``--encoder`` the port's spliced tree."""
    jstate = jtrainer.create_train_state(jm, jax.random.key(args.seed), jnp.zeros((4, 32, 32)),
                                         tcfg.training.optimizer, tcfg.training.lr)
    params = jax.tree.map(np.asarray, jax.device_get(jstate.params))
    if args.ill_posed is not None:
        for layer in params["encoder"]["encoder"]["trunk"].values():
            layer["kernel"] = layer["kernel"] * np.float32(args.ill_posed)
    if args.encoder:
        interop.load_flax_params(tm, params)
        ttrainer.splice_pretrained_encoder(tm, torch.load(args.encoder, map_location="cpu"))
        params = interop.params_to_flax(dict(tm.named_parameters()))
    return params


class Stepper:
    """One package's train step on one route, from ``params``: ``step(batch
    indices) -> loss``, and its parameters in the port's names."""

    def __init__(self, package: str, route: str, jm, tcfg, params, tiles, args):
        self.first_nonfinite, self.seconds = None, 0.0
        fused, tr = route == "fused", tcfg.training
        sin5, freeze = fused and tr.sin5, tr.freeze_encoder
        self.base = args.seed + 1  # the train CLI's dropout key (training.seed + 1)
        if package == "jax":
            self.jstep = jtrainer.make_train_step(jm, jlosses.mse, 32, 24, use_pallas=fused,
                                                  interpret=fused, sin5=sin5,
                                                  freeze_encoder=freeze)
            state = jtrainer.create_train_state(jm, jax.random.key(args.seed),
                                                jnp.zeros((4, 32, 32)), tr.optimizer, tr.lr)
            p = jax.tree.map(jnp.asarray, params)
            self.jstate = state.replace(params=p, opt_state=state.tx.init(p))
            self.tiles = tiles
        else:
            self.model = interop.load_flax_params(
                tms.from_config(tcfg.model, "fp32", device="cpu"), params)
            self.tstate = ttrainer.create_train_state(self.model, tr.optimizer, tr.lr)
            self.epoch = ttrainer.make_scan_epoch(self.model, tlosses.mse, 32, 24,
                                                  use_pallas=fused, sin5=sin5,
                                                  freeze_encoder=freeze)
            self.tiles = tuple(torch.from_numpy(t) for t in tiles)

    def step(self, perm_row: np.ndarray, i: int) -> float | None:
        if self.first_nonfinite is not None:
            return None
        t0 = time.perf_counter()
        if hasattr(self, "jstep"):
            fully, under = (jnp.asarray(t[perm_row]) for t in self.tiles)
            self.jstate, loss = self.jstep(self.jstate, fully, under, jax.random.key(self.base))
        else:
            loss = self.epoch(self.tstate, *self.tiles, perm_row[None], self.base, True)
        loss = float(loss)
        self.seconds += time.perf_counter() - t0
        if not np.isfinite(loss):
            self.first_nonfinite = i
        return loss

    def params(self) -> dict[str, torch.Tensor]:
        if hasattr(self, "jstep"):
            return interop.params_from_flax(jax.device_get(self.jstate.params))
        return {n: p.detach() for n, p in self.model.named_parameters()}


def _rel(a, b):
    return None if a is None or b is None else abs(a - b) / abs(b)


def trunk_features(tm, under: np.ndarray) -> dict:
    """The frozen trunk's features over the split (``results_run``'s record)."""
    with torch.no_grad():
        feats = torch.cat([tm.encoder.encoder.trunk(torch.from_numpy(under[i:i + 256]))
                           for i in range(0, len(under), 256)])
    return {"tiles": len(under), "mean": feats.mean().item(), "max": feats.max().item(),
            "zero_share": (feats == 0).float().mean().item()}


def run(meta: pathlib.Path, dropout: float, args) -> dict:
    sets = [*TRUNKS[args.trunk], f"model.dropout={dropout}", f"training.seed={args.seed}",
            f"data.train.dataset={meta}", "data.train.max_slice_num=100", *args.sets]
    tcfg = tconfig.load_train_configuration(REPO / "configs" / "train.yaml", sets)
    jcfg = jconfig.load_train_configuration(REPO / "configs" / "train.yaml",
                                            [s for s in sets if not s.startswith("data.")])
    data = cli_train._dataset(tcfg.data.train, tcfg.data, tcfg.model)
    tiles = (data.fully_tiles, data.under_tiles)
    jm = jms.from_config(jcfg.model, "fp32")
    tm = tms.from_config(tcfg.model, "fp32", device="cpu")
    params = initial_params(jm, tm, tcfg, args)
    routes = ("fused", "module") if args.route == "both" else (args.route,)
    steppers = {f"{pkg}_{r}": Stepper(pkg, r, jm, tcfg, params, tiles, args)
                for r in routes for pkg in ("jax", "port")}
    out = {"dropout": dropout, "tiles": len(data), "batch": args.batch, "routes": list(routes),
           "optimizer": tcfg.training.optimizer, "lr": tcfg.training.lr,
           "freeze_encoder": tcfg.training.freeze_encoder, "sin5": tcfg.training.sin5}
    if args.trunk == "vgg":
        out["trunk_features"] = trunk_features(
            interop.load_flax_params(tm, params), data.under_tiles)
        print(f"dropout {dropout}: trunk features {out['trunk_features']}", flush=True)

    steps, epoch, t0 = [], 0, time.perf_counter()
    while len(steps) < args.steps:
        for idx in ttrainer.make_epoch_perm(len(data), args.batch, epoch, shuffle=True):
            i = len(steps)
            if i == args.steps:
                break
            row = {"step": i, "epoch": epoch}
            row.update({n: s.step(idx, i) for n, s in steppers.items()})
            for r in routes:
                row[f"pkg_gap_{r}"] = _rel(row[f"port_{r}"], row[f"jax_{r}"])
            if len(routes) == 2:
                for pkg in ("jax", "port"):
                    row[f"route_gap_{pkg}"] = _rel(row[f"{pkg}_module"], row[f"{pkg}_fused"])
            if i % args.gap_every == 0 or i == args.steps - 1:
                for r in routes:
                    want, got = steppers[f"jax_{r}"].params(), steppers[f"port_{r}"].params()
                    row[f"param_gap_{r}"] = max((p - want[n]).abs().max().item()
                                                for n, p in got.items())
            steps.append(row)
            if i % args.gap_every == 0:
                print(f"  step {i}: " + ", ".join(
                    f"{n} {row[n]:.6f}" for n in steppers if row[n] is not None), flush=True)
        epoch += 1

    def tail(name):
        vals = [r[name] for r in steps[-10:] if r[name] is not None]
        return float(np.mean(vals)) if vals else None

    out.update(epochs=epoch, bar=GAP_BAR, seconds=time.perf_counter() - t0)
    out["stepper_seconds"] = {n: s.seconds for n, s in steppers.items()}
    out["first_nonfinite"] = {n: s.first_nonfinite for n, s in steppers.items()}
    out["first_loss"] = {n: steps[0][n] for n in steppers}
    out["last10_mean_loss"] = {n: tail(n) for n in steppers}
    out["min_loss"] = {n: min((r[n] for r in steps if r[n] is not None), default=None)
                       for n in steppers}
    out["first_step_over_bar"] = {
        r: next((x["step"] for x in steps
                 if x[f"pkg_gap_{r}"] is None or x[f"pkg_gap_{r}"] > GAP_BAR), None)
        for r in routes}
    out["max_pkg_gap"] = {r: max((x[f"pkg_gap_{r}"] for x in steps
                                  if x[f"pkg_gap_{r}"] is not None), default=None)
                          for r in routes}
    out["steps"] = steps
    last = steps[-1]
    print(f"dropout {dropout}: {len(steps)} steps over {epoch} epoch(s) of {len(data)} tiles "
          f"({out['seconds']:.1f} s; {', '.join(f'{n} {t:.1f}' for n, t in out['stepper_seconds'].items())})", flush=True)
    for r in routes:
        print(f"  {r}: loss {steps[0][f'jax_{r}']:.6f} -> JAX {last[f'jax_{r}']}, port "
              f"{last[f'port_{r}']}; last-10 mean JAX {out['last10_mean_loss'][f'jax_{r}']}, "
              f"port {out['last10_mean_loss'][f'port_{r}']}; relative loss gap max "
              f"{out['max_pkg_gap'][r]}, first over {GAP_BAR:g} at step "
              f"{out['first_step_over_bar'][r]}; parameter gap at the end "
              f"{last.get(f'param_gap_{r}')}; first non-finite JAX "
              f"{out['first_nonfinite'][f'jax_{r}']}, port "
              f"{out['first_nonfinite'][f'port_{r}']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--dropouts", default="0.1,0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--set", dest="sets", action="append", default=list(CUT))
    ap.add_argument("--trunk", choices=sorted(TRUNKS), default="residual")
    ap.add_argument("--ill-posed", type=float, default=None, metavar="SCALE",
                    help="every VGG trunk kernel times SCALE (with --trunk vgg)")
    ap.add_argument("--route", choices=("fused", "module", "both"), default="module")
    ap.add_argument("--encoder", default=None, help="a port conv autoencoder file to splice")
    ap.add_argument("--train-files", type=int, default=2)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--gap-every", type=int, default=10)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.ill_posed is not None and args.trunk != "vgg":
        ap.error("--ill-posed scales a VGG trunk: pass --trunk vgg")
    if args.route != "module" and args.trunk == "residual":
        ap.error("a residual model trains on the module route only")
    torch.manual_seed(0)
    report = {"command": sys.argv, "model": f"configs/train.yaml + {' '.join(TRUNKS[args.trunk])}"
              f", fp32", "ill_posed": args.ill_posed, "sets": args.sets, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(args.data_root or tmp)
        meta = train_split(root, args)
        for d in args.dropouts.split(","):
            report["runs"].append(run(meta, float(d), args))
            if args.out:  # after each rate, so a cut run keeps what it finished
                pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                pathlib.Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
