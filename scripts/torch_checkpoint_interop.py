#!/usr/bin/env python3
"""Convert checkpoints between the JAX package (Orbax directories) and the
PyTorch port (``torch.save`` files), in both directions.

    # a run directory: the newest step (or --step N) of params, Adam's
    # mu / nu / count and the step, read with the run's config.yaml
    python scripts/torch_checkpoint_interop.py jax-to-torch run \\
        --run-dir <JAX run dir> --out <port run dir> [--step N] [--config <yaml>]
    python scripts/torch_checkpoint_interop.py torch-to-jax run \\
        --run-dir <port run dir> --out <JAX run dir> [--step N] [--config <yaml>]

    # a pretrained encoder: what model.encoder_path (conv, vgg) and
    # training.perceptual_encoder_path (perceptual, perceptual_v1) read,
    # with BatchNorm statistics; a path ending in _full is the whole
    # autoencoder, for train_encoder --evaluate
    python scripts/torch_checkpoint_interop.py jax-to-torch encoder \\
        --model conv|vgg|perceptual|perceptual_v1 --path <Orbax dir> --out <file.pt>
    python scripts/torch_checkpoint_interop.py torch-to-jax encoder \\
        --model conv|vgg|perceptual|perceptual_v1 --path <file.pt> --out <Orbax dir>

The output run directory gets the step's checkpoint under
``checkpoints/step_<N>/`` and the config copied beside it, so either
package's test CLI scores it and its train CLI resumes it. The layouts map
through ``mri_inr_tpu_torch.interop``; every converted tree is loaded
strictly into the target package's model, so a mismatch raises here.

A script beside both packages: it imports ``jax``, ``flax``, ``optax`` and
``orbax``, which the port itself never does. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

MODELS = ("conv", "vgg", "perceptual", "perceptual_v1")
# a perceptual encoder's latent width: the first dimension of this weight
LATENT_KEYS = {"perceptual": "fc_block.fc.weight", "perceptual_v1": "fc_block_1.fc.weight"}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _port_model(mcfg, precision: str):
    import torch

    from mri_inr_tpu_torch.models import modulated_siren as tms

    return tms.from_config(mcfg, precision, generator=torch.Generator().manual_seed(0),
                           device="cpu")


def _jax_state(cfg):
    """A JAX train state of ``cfg``'s model and optimizer: the restore target
    and the template of a converted one."""
    jax = _jax()
    import jax.numpy as jnp

    from mri_inr_tpu.models import modulated_siren as jms
    from mri_inr_tpu.train.trainer import create_train_state

    mcfg, tcfg = cfg.model, cfg.training
    model = jms.from_config(mcfg, tcfg.precision)
    sample = jnp.zeros((2, mcfg.outer_patch_size, mcfg.outer_patch_size))
    return create_train_state(model, jax.random.key(tcfg.seed), sample, tcfg.optimizer, tcfg.lr)


def _configs(run_dir: pathlib.Path, config: str | None):
    """(JAX config, port config, the yaml file) of a run directory."""
    from mri_inr_tpu.configuration import config as jconfig
    from mri_inr_tpu_torch.configuration import config as tconfig

    path = pathlib.Path(config) if config else run_dir / "config.yaml"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: the run's config (name another with --config)")
    return jconfig.load_train_configuration(path), tconfig.load_train_configuration(path), path


def _adam(opt_state):
    """The ``ScaleByAdamState`` of an ``optax.adam`` state, or None."""
    import optax

    found = [s for s in opt_state if isinstance(s, optax.ScaleByAdamState)]
    return found[0] if found else None


def run_jax_to_torch(run_dir: pathlib.Path, out: pathlib.Path, step: int | None,
                     config: str | None) -> pathlib.Path:
    jax = _jax()
    from mri_inr_tpu.train import checkpoint as jckpt
    from mri_inr_tpu_torch import interop
    from mri_inr_tpu_torch.train import checkpoint as tckpt
    from mri_inr_tpu_torch.train.trainer import create_train_state

    jcfg, tcfg, cfg_path = _configs(run_dir, config)
    step = jckpt.find_latest_step(run_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no step_* checkpoint under {run_dir}/checkpoints")
    jstate = jckpt.restore_state(run_dir, step, _jax_state(jcfg))
    model = _port_model(tcfg.model, tcfg.training.precision)
    interop.load_flax_params(model, jax.device_get(jstate.params))
    state = create_train_state(model, tcfg.training.optimizer, tcfg.training.lr)
    adam = _adam(jstate.opt_state)
    if adam is not None:
        state.optimizer.load_state_dict(interop.adam_state_from_optax(
            model, state.optimizer, int(adam.count), jax.device_get(adam.mu),
            jax.device_get(adam.nu)))
    state.step = int(jstate.step)
    out.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(cfg_path, out / "config.yaml")
    return tckpt.save_state(out, state.step, state)


def run_torch_to_jax(run_dir: pathlib.Path, out: pathlib.Path, step: int | None,
                     config: str | None) -> pathlib.Path:
    jax = _jax()
    import jax.numpy as jnp

    from mri_inr_tpu.train import checkpoint as jckpt
    from mri_inr_tpu_torch import interop
    from mri_inr_tpu_torch.train import checkpoint as tckpt
    from mri_inr_tpu_torch.train.trainer import create_train_state

    jcfg, tcfg, cfg_path = _configs(run_dir, config)
    step = tckpt.find_latest_step(run_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no step_* checkpoint under {run_dir}/checkpoints")
    model = _port_model(tcfg.model, tcfg.training.precision)
    state = tckpt.restore_state(run_dir, step, create_train_state(
        model, tcfg.training.optimizer, tcfg.training.lr))
    like = lambda template, tree: jax.tree.map(
        lambda t, v: jnp.asarray(v, dtype=t.dtype), template, tree)
    jstate = _jax_state(jcfg)
    jstate = jstate.replace(step=jnp.asarray(state.step, jnp.asarray(jstate.step).dtype),
                            params=like(jstate.params, interop.params_to_flax(
                                model.state_dict())))
    adam = _adam(jstate.opt_state)
    if adam is not None:
        count, mu, nu = interop.adam_state_to_optax(model, state.optimizer)
        new = adam._replace(count=jnp.asarray(count, adam.count.dtype),
                            mu=like(adam.mu, mu), nu=like(adam.nu, nu))
        jstate = jstate.replace(opt_state=tuple(new if s is adam else s
                                                for s in jstate.opt_state))
    out.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(cfg_path, out / "config.yaml")
    return jckpt.save_state(out, state.step, jstate)


def _port_module(kind: str, state: dict):
    """The port's module a converted state dict must load into (strictly)."""
    from mri_inr_tpu_torch.models import encoder, perceptual

    if kind == "conv":
        return encoder.ConvAutoencoder(state["encoder.fc.weight"].shape[0])
    if kind == "vgg":
        return encoder.VGGAutoencoder()
    whole = any(k.startswith("encoder.") for k in state)  # the whole autoencoder
    latent = state[("encoder." if whole else "") + LATENT_KEYS[kind]].shape[0]
    cls = {("perceptual", False): perceptual.PerceptualEncoderV2,
           ("perceptual", True): perceptual.PerceptualAutoencoderV2,
           ("perceptual_v1", False): perceptual.PerceptualEncoderV1,
           ("perceptual_v1", True): perceptual.PerceptualAutoencoderV1}[kind, whole]
    return cls(latent_dim=latent)


def encoder_jax_to_torch(path: pathlib.Path, out: pathlib.Path, kind: str) -> pathlib.Path:
    jax = _jax()
    import orbax.checkpoint as ocp
    import torch

    from mri_inr_tpu_torch import interop

    with ocp.StandardCheckpointer() as ckptr:
        tree = jax.device_get(ckptr.restore(path.absolute()))
    state = (interop.variables_from_flax(tree) if "params" in tree
             else interop.params_from_flax(tree))
    _port_module(kind, state).load_state_dict(state, strict=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    return out


def encoder_torch_to_jax(path: pathlib.Path, out: pathlib.Path, kind: str) -> pathlib.Path:
    _jax()
    import orbax.checkpoint as ocp
    import torch

    from mri_inr_tpu_torch import interop

    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("model", state)
    _port_module(kind, state).load_state_dict(state, strict=True)
    if kind.startswith("perceptual"):
        tree = interop.variables_to_flax(state)
    else:  # conv / vgg files hold the autoencoder's params; _full wraps them
        tree = interop.params_to_flax(state)
        if out.name.endswith("_full"):
            tree = {"params": tree}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(out.absolute(), tree, force=True)
    return out


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("direction", choices=["jax-to-torch", "torch-to-jax"])
    parser.add_argument("what", choices=["run", "encoder"])
    parser.add_argument("--out", required=True)
    parser.add_argument("--run-dir", help="run: the run directory to convert")
    parser.add_argument("--step", type=int, default=None, help="run: default the newest")
    parser.add_argument("--config", default=None, help="run: default <run-dir>/config.yaml")
    parser.add_argument("--path", help="encoder: the file or directory to convert")
    parser.add_argument("--model", choices=MODELS, help="encoder: its autoencoder")
    args = parser.parse_args(argv)
    out = pathlib.Path(args.out)
    if args.what == "run":
        if not args.run_dir:
            parser.error("run needs --run-dir")
        convert = run_jax_to_torch if args.direction == "jax-to-torch" else run_torch_to_jax
        done = convert(pathlib.Path(args.run_dir), out, args.step, args.config)
    else:
        if not (args.path and args.model):
            parser.error("encoder needs --path and --model")
        convert = (encoder_jax_to_torch if args.direction == "jax-to-torch"
                   else encoder_torch_to_jax)
        done = convert(pathlib.Path(args.path), out, args.model)
    print(f"wrote {done}")
    return done


if __name__ == "__main__":
    main()
