#!/usr/bin/env python3
"""The VGG autoencoder's pretraining step of the port against the JAX
package's on the CPU, side by side from the same initial weights: the
counterpart, across packages, of ``scripts/torch_vgg_splice_probe.py
--ae-draws`` (which runs the port alone on the card). It imports the JAX
package, so it lives with the tests; pytest does not collect it.

    python tests/vgg_ae_cross_package.py --corpus hard --seeds 4,5 --steps 12 \
        [--draw jax|torch2.11] [--data-root DIR] [--out F.json]

For each seed K: the port's VGG autoencoder at K, by default the JAX
package's own draw, ``init(jax.random.key(K))`` (``train_encoder.
build_autoencoder``, within an ulp or two of Flax's), with ``--draw
torch2.11`` the weights the card's runs of the earlier draw started from,
a torch 2.11 generator's draw (:func:`card_autoencoder`; ``--ae-draws``
recorded the sum of its weights); carried into Flax by ``interop.params_to_flax``, so both
sides start from the same values; then ``--steps`` steps of the port's
``train_encoder.train_step`` and of ``train_encoder.py``'s step (Flax
``VGGAutoencoder``, ``optax.adam``, lr 1e-3, batch 256) on the same
batches (``make_epoch_perm`` against the JAX ``MRIDataset.batches(seed=
epoch)``, held equal), on the quality protocol's train split of
``--corpus`` preprocessed on the CPU (within 2e-5 of the card's). Per step:
both losses and reconstruction stds; every fourth step the largest
parameter gap; per seed the steps from which each reconstruction is
structured and stays flat, as ``--ae-draws`` reads them. About 3 + 25 s a
step on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "scripts")]

from mri_inr_tpu.data.dataset import MRIDataset as JaxDataset  # noqa: E402
from mri_inr_tpu.models.encoder import VGGAutoencoder as JaxVGG  # noqa: E402
from mri_inr_tpu_torch import interop  # noqa: E402
from mri_inr_tpu_torch.cli import train_encoder as te  # noqa: E402
from mri_inr_tpu_torch.data.dataset import MRIDataset  # noqa: E402
from mri_inr_tpu_torch.models.encoder import VGGAutoencoder  # noqa: E402
from mri_inr_tpu_torch.train.trainer import make_epoch_perm, make_optimizer  # noqa: E402
from torch_vgg_splice_probe import (flat_from, structured_from, train_split,  # noqa: E402
                                    weight_sum)

GAP_EVERY = 4  # steps between two readings of the parameter gap


def _inverse_cdf_trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
    """``nn.init.trunc_normal_`` as torch computed it up to 2.12 (the card's
    torch 2.11 among them): the inverse CDF of a uniform draw, clamped.
    From 2.13 torch draws it by rejection, which gives other weights for the
    same generator."""
    cdf = lambda x: (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0
    with torch.no_grad():
        tensor.uniform_(2 * cdf((a - mean) / std) - 1, 2 * cdf((b - mean) / std) - 1,
                        generator=generator)
        tensor.erfinv_()
        tensor.mul_(std * math.sqrt(2.0))
        tensor.add_(mean)
        return tensor.clamp_(min=a, max=b)


def card_autoencoder(seed: int) -> torch.nn.Module:
    """The VGG autoencoder the card's runs of the earlier draw pretrained
    from at ``seed`` (``train_encoder.build_autoencoder`` drew it from a
    torch generator then): the card's torch 2.11 draw, on the CPU, whatever
    torch runs here."""
    kept = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = _inverse_cdf_trunc_normal_
    try:
        return VGGAutoencoder(generator=torch.Generator().manual_seed(seed))
    finally:
        torch.nn.init.trunc_normal_ = kept


def cross_package(meta: pathlib.Path, corpus: str, seed: int, steps: int,
                  draw: str = "jax") -> dict:
    """Both packages' pretraining steps from one set of initial weights at
    ``seed`` (``draw``: the JAX package's, or the card's earlier draw), every
    step's readings."""
    model = (te.build_autoencoder("vgg", seed=seed, device="cpu")[0] if draw == "jax"
             else card_autoencoder(seed))
    init = weight_sum(model)
    params = jax.tree.map(jnp.asarray, interop.params_to_flax(model.state_dict()))
    jm, tx = JaxVGG(), optax.adam(1e-3)
    opt_state = tx.init(params)
    opt = make_optimizer("adam", 1e-3, model.parameters())

    @jax.jit
    def jstep(params, opt_state, x):  # train_encoder.py's train_step, with the output
        def loss_of(p):
            out = jm.apply({"params": p}, x)
            return jnp.mean(jnp.square(out - x)), out

        (loss, out), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, jnp.std(out)

    tiles = torch.from_numpy(MRIDataset(meta).fully_tiles)
    jds = JaxDataset(str(meta))
    run = {"corpus": corpus, "seed": seed, "draw": draw, "initial_weight_sum": init,
           "port_loss": [],
           "jax_loss": [], "port_out_std": [], "jax_out_std": [], "x_std": [], "param_gap": []}
    step, epoch = 0, 0
    while step < steps:
        perm = make_epoch_perm(len(tiles), 256, epoch, shuffle=True)
        for idx, (fully, _) in zip(perm, jds.batches(256, seed=epoch)):
            x = tiles[torch.from_numpy(idx.astype(np.int64))]
            if not np.array_equal(x.numpy(), fully):
                raise AssertionError(f"step {step}: the two packages' batches differ")
            t0 = time.perf_counter()
            loss, out = te.train_step(model, opt, x)
            t1 = time.perf_counter()
            params, opt_state, jloss, jstd = jstep(params, opt_state, jnp.asarray(fully))
            jloss = float(jloss)
            t2 = time.perf_counter()
            vals = (float(loss), jloss, float(out.std()), float(jstd), float(x.std()))
            for k, v in zip(("port_loss", "jax_loss", "port_out_std", "jax_out_std", "x_std"),
                            vals):
                run[k].append(v)
            line = (f"{corpus} seed {seed} step {step}: loss port {vals[0]:.6f} JAX "
                    f"{vals[1]:.6f} (gap {vals[0] - vals[1]:+.2e}); reconstruction std port "
                    f"{vals[2]:.4g} JAX {vals[3]:.4g} (batch {vals[4]:.4g}); "
                    f"{t1 - t0:.1f} + {t2 - t1:.1f} s")
            if step % GAP_EVERY == GAP_EVERY - 1 or step == steps - 1:
                want = interop.params_from_flax(jax.device_get(params))
                gap = max(float((p.detach() - want[n]).abs().max())
                          for n, p in model.named_parameters())
                run["param_gap"].append([step, gap])
                line += f"; largest parameter gap {gap:.3e}"
            print(line, flush=True)
            step += 1
            if step == steps:
                break
        epoch += 1
    for side in ("port", "jax"):
        run[f"{side}_structured_from_step"] = structured_from(run[f"{side}_out_std"],
                                                              run["x_std"])
        run[f"{side}_flat_from_step"] = flat_from(run[f"{side}_out_std"], run["x_std"])
    print(f"{corpus} seed {seed}: initial weight sum {init:.10g}; structured from step port "
          f"{run['port_structured_from_step']} JAX {run['jax_structured_from_step']}, flat "
          f"from step port {run['port_flat_from_step']} JAX {run['jax_flat_from_step']}; "
          f"largest loss gap "
          f"{max(abs(a - b) for a, b in zip(run['port_loss'], run['jax_loss'])):.3e}",
          flush=True)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", default="hard", choices=("smooth", "hard"))
    ap.add_argument("--seeds", default="4,5")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--draw", default="jax", choices=("jax", "torch2.11"),
                    help="the initial weights: the JAX package's init at key(K), or the "
                         "torch 2.11 generator draw of the card's earlier runs")
    ap.add_argument("--data-root", default=None,
                    help="where the split is built (kept; default: a temporary one)")
    ap.add_argument("--out", default=None, help="a JSON file of every step's readings")
    args = ap.parse_args()
    report = {"device": "cpu", "torch": torch.__version__, "jax": jax.__version__,
              "batch": 256, "lr": 1e-3, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        meta = train_split(args.corpus, pathlib.Path(args.data_root or tmp) / "data",
                           torch.device("cpu"))
        print(f"{args.corpus} train split: {meta} ({time.perf_counter() - t0:.1f}s)", flush=True)
        for seed in (int(s) for s in args.seeds.split(",")):
            report["runs"].append(cross_package(meta, args.corpus, seed, args.steps,
                                                args.draw))
            if args.out:
                pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                pathlib.Path(args.out).write_text(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
