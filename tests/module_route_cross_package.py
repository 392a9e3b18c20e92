#!/usr/bin/env python3
"""The smooth ``residual`` row's first train steps in the port and in the JAX
package on the CPU, side by side, from the same draws: the counterpart,
across packages, of ``cli/results_run --rows residual`` (which runs the port
alone on the card). It imports the JAX package, so it lives with the tests;
pytest does not collect it.

    python tests/module_route_cross_package.py [--steps 120] [--dropouts 0.1,0] \\
        [--set model.dim_hidden=64 ...] [--batch 64] [--data-root DIR] [--out F.json]

The model is ``configs/train.yaml``'s with ``model.residual=true`` (the
row's), in fp32, with ``--set`` overrides: run here at a cut size (the
defaults: H=64, latent 64, batch 64; the card runs H=256, batch 400). Both
sides start from the JAX package's ``init(jax.random.key(seed))``,
transplanted into the port; with ``--encoder F`` the port's conv
autoencoder file is spliced into the port's model and the whole tree then
copied into Flax. Both step with Adam at ``training.lr`` on the module path
(``make_train_step(use_pallas=False)`` of each package, the dropout key
``fold_in(key(seed + 1), step)``, Flax's masks on both sides) over the same
batches (``make_epoch_perm(n, batch, epoch, shuffle=True)`` of the
protocol's smooth train split, ``--train-files`` phantom volumes of
``--slices`` slices at ``--size``, preprocessed on the CPU under
``--data-root``). Per step: both losses and their relative gap; every
``--gap-every`` steps the largest parameter gap; per dropout rate the first
step whose loss gap exceeds 1e-3. About 0.2 s a step on each side at the
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


def train_split(data_root: pathlib.Path, args) -> pathlib.Path:
    """The protocol's smooth train split (phantom seeds from 0)."""
    ap = argparse.ArgumentParser()
    qr.add_protocol_args(ap, str(data_root))
    proto = ap.parse_args(["--train-files", str(args.train_files), "--slices",
                           str(args.slices), "--size", str(args.size)])
    return qr.make_split(data_root / "data" / "train", proto.train_files, 0, proto,
                         torch.device("cpu"))


def run(meta: pathlib.Path, dropout: float, args) -> dict:
    sets = ["model.residual=true", f"model.dropout={dropout}", f"training.seed={args.seed}",
            f"data.train.dataset={meta}", "data.train.max_slice_num=100", *args.sets]
    tcfg = tconfig.load_train_configuration(REPO / "configs" / "train.yaml", sets)
    jcfg = jconfig.load_train_configuration(REPO / "configs" / "train.yaml",
                                            [s for s in sets if not s.startswith("data.")])
    data = cli_train._dataset(tcfg.data.train, tcfg.data, tcfg.model)
    jm = jms.from_config(jcfg.model, "fp32")
    tm = tms.from_config(tcfg.model, "fp32", device="cpu")
    jstate = jtrainer.create_train_state(jm, jax.random.key(args.seed), jnp.zeros((4, 32, 32)),
                                         tcfg.training.optimizer, tcfg.training.lr)
    interop.load_flax_params(tm, jax.device_get(jstate.params))
    if args.encoder:
        ttrainer.splice_pretrained_encoder(tm, torch.load(args.encoder, map_location="cpu"))
        jstate = jstate.replace(params=jax.tree.map(
            jnp.asarray, interop.params_to_flax(dict(tm.named_parameters()))))
    tstate = ttrainer.create_train_state(tm, tcfg.training.optimizer, tcfg.training.lr)
    jstep = jtrainer.make_train_step(jm, jlosses.mse, 32, 24, use_pallas=False)
    tstep = ttrainer.make_train_step(tm, tlosses.mse, 32, 24, use_pallas=False)
    rng = jax.random.key(args.seed + 1)  # the train CLI's dropout key (training.seed + 1)

    fully_all, under_all = data.fully_tiles, data.under_tiles
    steps, epoch, t0 = [], 0, time.perf_counter()
    while len(steps) < args.steps:
        for idx in ttrainer.make_epoch_perm(len(data), args.batch, epoch, shuffle=True):
            if len(steps) == args.steps:
                break
            fully, under = fully_all[idx], under_all[idx]
            jstate, jloss = jstep(jstate, jnp.asarray(fully), jnp.asarray(under), rng)
            tloss = tstep(tstate, torch.from_numpy(fully), torch.from_numpy(under),
                          args.seed + 1)
            j, t = float(jloss), float(tloss)
            row = {"step": len(steps), "epoch": epoch, "jax": j, "port": t,
                   "rel_gap": abs(t - j) / abs(j)}
            if len(steps) % args.gap_every == 0 or len(steps) == args.steps - 1:
                want = interop.params_from_flax(jax.device_get(jstate.params))
                row["param_gap"] = max((p.detach() - want[n]).abs().max().item()
                                       for n, p in tm.named_parameters())
            steps.append(row)
        epoch += 1
    first = next((r["step"] for r in steps if r["rel_gap"] > GAP_BAR), None)
    out = {"dropout": dropout, "tiles": len(data), "batch": args.batch, "epochs": epoch,
           "first_step_over_bar": first, "bar": GAP_BAR,
           "max_rel_gap": max(r["rel_gap"] for r in steps),
           "seconds": time.perf_counter() - t0, "steps": steps}
    print(f"dropout {dropout}: {len(steps)} steps over {epoch} epoch(s) of {len(data)} tiles; "
          f"loss {steps[0]['jax']:.6f} -> JAX {steps[-1]['jax']:.6f}, port "
          f"{steps[-1]['port']:.6f}; relative loss gap max {out['max_rel_gap']:.3e}, first over "
          f"{GAP_BAR:g} at step {first}; parameter gap at the end "
          f"{steps[-1]['param_gap']:.3e} ({out['seconds']:.1f} s)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--dropouts", default="0.1,0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--set", dest="sets", action="append", default=list(CUT))
    ap.add_argument("--encoder", default=None, help="a port conv autoencoder file to splice")
    ap.add_argument("--train-files", type=int, default=2)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--gap-every", type=int, default=10)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(args.data_root or tmp)
        meta = train_split(root, args)
        runs = [run(meta, float(d), args) for d in args.dropouts.split(",")]
    report = {"command": sys.argv, "model": "configs/train.yaml + model.residual=true, fp32",
              "sets": args.sets, "runs": runs}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
