"""Record the JAX package's seeded draws that ``chip_smoke.py``'s draws phase
checks on the card: ``tests/data/jax_draws.json``.

    JAX_PLATFORMS=cpu python tests/jax_draws_constants.py

For seeds 0 and 1, each leaf of ``model.init(jax.random.key(seed),
sample)["params"]`` of the smoke's ``ModulatedSiren`` (``configs/train.yaml``'s
model) and of the three autoencoders ``train_encoder.py`` pretrains: its size,
the float64 sums of its values and of their squares (``math.fsum``, exactly
rounded, so any machine gets the same numbers from the same values) and
the initializer the port's layer names for it; and the column masks
``jax.random`` draws for three phantom stems under each of the preprocess
CLI's mask pairs at 320 columns, as hex of ``numpy.packbits``. It imports
JAX, so it sits with the tests; ``tests/test_torch_port_flax_init.py``
holds the file against JAX and against the port's draws.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "tests" / "data" / "jax_draws.json"
SEEDS = (0, 1)
MASK_STEMS = 3
MASK_WIDTH = 320
MASK_PAIRS = ((0.05, 6), (0.1, 6))


def models():
    """name -> (Flax model, its init sample, the port's model)."""
    from mri_inr_tpu.models import encoder as jenc
    from mri_inr_tpu.models import modulated_siren as jms
    from mri_inr_tpu.models import perceptual as jperc
    from mri_inr_tpu_torch.models import encoder as tenc
    from mri_inr_tpu_torch.models import modulated_siren as tms
    from mri_inr_tpu_torch.models import perceptual as tperc

    widths = dict(dim_hidden=256, latent_dim=256, num_layers=5)
    x32, x24 = jnp.zeros((2, 32, 32)), jnp.zeros((2, 24, 24))
    return {
        "modulated_siren": (jms.ModulatedSiren(**widths), x32,
                            lambda: tms.ModulatedSiren(**widths, device="cpu")),
        "conv_autoencoder": (jenc.ConvAutoencoder(latent_dim=256), x32,
                             lambda: tenc.ConvAutoencoder(256)),
        "vgg_autoencoder": (jenc.VGGAutoencoder(), x32, tenc.VGGAutoencoder),
        "perceptual_autoencoder": (jperc.PerceptualAutoencoderV2(latent_dim=256), x24,
                                   lambda: tperc.PerceptualAutoencoderV2(latent_dim=256)),
    }


def leaf_sums(tree, prefix=()) -> dict:
    """"a/b/kernel" -> [size, fsum, fsum of squares] of a params tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(leaf_sums(v, prefix + (k,)))
        else:
            a = np.asarray(v, np.float64).reshape(-1)
            out["/".join(prefix + (k,))] = [int(a.size), math.fsum(a), math.fsum(a * a)]
    return out


def initializers(model) -> dict:
    """"a/b/kernel" -> the initializer the port's layer names for it."""
    from mri_inr_tpu_torch import interop

    params = dict(model.named_parameters())
    out = {}
    for name, module in model.named_modules():
        for leaf, spec in getattr(module, "flax_init", {}).items():
            key = f"{name}.{leaf}" if name else leaf
            if key in params:
                path, _ = interop.flax_leaf(key, params[key].detach().numpy())
                out["/".join(path)] = spec[0]
    return out


def stems() -> list[str]:
    from mri_inr_tpu_torch.data import synthetic

    return [synthetic.synthetic_stem(i) for i in range(MASK_STEMS)]


def main() -> None:
    from mri_inr_tpu.data import kspace as jk
    from mri_inr_tpu.data import preprocessing as jpre

    out = {"models": {}, "masks": {}, "mask_width": MASK_WIDTH}
    for name, (jmodel, sample, port) in models().items():
        kinds = initializers(port())
        out["models"][name] = {}
        for seed in SEEDS:
            sums = leaf_sums(jax.device_get(jmodel.init(jax.random.key(seed), sample)["params"]))
            out["models"][name][str(seed)] = {k: [*v, kinds[k]] for k, v in sums.items()}
    for stem in stems():
        for cf, acc in MASK_PAIRS:
            mask = np.asarray(jk.random_mask(jax.random.key(jpre._stable_seed(stem, cf, acc)),
                                             MASK_WIDTH, cf, acc))
            out["masks"][f"{stem}|{cf}|{acc}"] = np.packbits(mask).tobytes().hex()
    OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
