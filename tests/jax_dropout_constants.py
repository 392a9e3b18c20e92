"""Record the dropout masks the JAX package's module path draws at
``configs/train.yaml``'s width, which ``chip_smoke.py``'s dropout phase holds
the card's kernel against: ``tests/data/jax_dropout_masks.json``.

    JAX_PLATFORMS=cpu python tests/jax_dropout_constants.py

For the train CLI's dropout seed (``training.seed`` 0, so ``key(1)``) and
steps 0 and 1: the key of each hidden layer's ``nn.Dropout``, read by a spy
on ``flax.linen.stochastic.random.bernoulli`` during a train-mode ``apply``
of the model ``configs/train.yaml`` configures, under ``rngs={"dropout":
fold_in(key(1), step)}`` (the JAX train step's); then the mask
``jax.random.bernoulli(key, 0.9, (400, 576, 256))`` at the train batch, as
its count of kept elements and the SHA-256 of ``numpy.packbits`` of it.
It imports JAX, so it sits with the tests;
``tests/test_torch_port_dropout.py`` holds the file against JAX and the
port's keys.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "tests" / "data" / "jax_dropout_masks.json"
BASE_SEED = 1  # the train CLI's: training.seed + 1
STEPS = (0, 1)
SHAPE = (400, 576, 256)  # (batch, coordinates, hidden) of configs/train.yaml


def layer_keys(step: int) -> list[list[int]]:
    """The keys Flax's dropout draws under in each hidden layer at ``step``
    (one sample, so the apply is cheap: the keys do not depend on the
    batch)."""
    import flax.linen.stochastic as fstochastic

    from mri_inr_tpu.configuration import config
    from mri_inr_tpu.models import modulated_siren as jms

    cfg = config.load_train_configuration(REPO / "configs" / "train.yaml")
    model = jms.from_config(cfg.model, "fp32")
    sample = jnp.zeros((1, 32, 32))
    params = model.init(jax.random.key(0), sample)
    seen = []
    real = fstochastic.random.bernoulli

    def spy(key, p, shape):
        seen.append([int(v) for v in np.asarray(jax.random.key_data(key))])
        return real(key, p, shape)

    fstochastic.random.bernoulli = spy
    try:
        model.apply(params, sample, deterministic=False,
                    rngs={"dropout": jax.random.fold_in(jax.random.key(BASE_SEED), step)})
    finally:
        fstochastic.random.bernoulli = real
    return seen


def mask_record(key: list[int], keep: float) -> dict:
    mask = np.asarray(jax.random.bernoulli(
        jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32)), keep, SHAPE))
    return {"key": key, "kept": int(mask.sum()),
            "sha256": hashlib.sha256(np.packbits(mask).tobytes()).hexdigest()}


def records() -> dict:
    from mri_inr_tpu.configuration import config

    keep = 1.0 - config.load_train_configuration(REPO / "configs" / "train.yaml").model.dropout
    masks = [{"step": s, "layer": i, **mask_record(k, keep)}
             for s in STEPS for i, k in enumerate(layer_keys(s))]
    return {"base_seed": BASE_SEED, "shape": list(SHAPE), "keep": keep, "masks": masks}


def main() -> None:
    OUT.write_text(json.dumps(records(), indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
