"""The module path's dropout against Flax's (``ops/dropout.py``,
``models/flax_init.py:dropout_keys``, ``models/siren.py:flax_dropout``,
``train/trainer.py:epoch_dropout_keys``), on the CPU, bit for bit:

- the plain Threefry bits equal ``jax.random.bits`` and ``jax_random``'s
  numpy bits for random keys, at sizes up to 3e5 elements and at offsets;
  the keep mask equals ``jax.random.bernoulli``;
- every hidden layer's mask at three steps of a small ``ModulatedSiren``,
  plain and residual, drawn by the port's module-path train step, equals
  the mask Flax's ``nn.Dropout`` draws under the JAX package's step key
  (a spy on ``flax.linen.stochastic.random.bernoulli``), and the key too;
- two ranks of that step draw their rows of the one global mask;
- a kept value is scaled as Flax's dropout scales it, in bf16 and fp32.
"""

import functools

import flax.linen as fnn
import flax.linen.stochastic as fstochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.configuration import config as jconfig
from mri_inr_tpu.models import modulated_siren as jms
from mri_inr_tpu_torch.configuration import config as tconfig
from mri_inr_tpu_torch.models import flax_init
from mri_inr_tpu_torch.models import modulated_siren as tms
from mri_inr_tpu_torch.models.siren import flax_dropout
from mri_inr_tpu_torch.ops import dropout as drop_ops
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train import trainer as ttrainer
from mri_inr_tpu_torch.utils import jax_random

BASE_SEED = 5
BATCH = 4


def _jax_key(k: np.ndarray):
    return jax.random.wrap_key_data(jnp.asarray(k, jnp.uint32))


def _random_key(rng) -> np.ndarray:
    return rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("case", range(6))
def test_plain_bits_equal_jax_random_bits(case):
    rng = np.random.default_rng(100 + case)
    key = _random_key(rng)
    numel = int(rng.integers(1, 300_001)) if case else 300_000
    offset = int(rng.integers(0, 100_000)) if case % 2 else 0
    got = drop_ops.threefry_bits_reference(drop_ops.keys_tensor(key), numel, offset).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    want = np.asarray(jax.random.bits(_jax_key(key), (offset + numel,), jnp.uint32))[offset:]
    assert np.array_equal(got.astype(np.uint32), want)
    assert np.array_equal(want, jax_random.random_bits(key, (offset + numel,))[offset:])


def test_plain_bits_take_the_high_word_of_the_counter():
    """Counters at and beyond 2^32 hash as ``(hi, lo)``: the bits of
    ``jax_random`` for those counters, hashed directly."""
    key = _random_key(np.random.default_rng(7))
    offset = 2**32 - 3
    got = drop_ops.threefry_bits_reference(drop_ops.keys_tensor(key), 6, offset).numpy()
    idx = np.arange(offset, offset + 6, dtype=np.uint64)
    x0, x1 = jax_random.threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                                     (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal(got.astype(np.uint32), x0 ^ x1)


@pytest.mark.parametrize("keep", [0.9, 0.5, 0.999])
def test_keep_mask_equals_jax_bernoulli(keep):
    rng = np.random.default_rng(int(keep * 1000))
    key = _random_key(rng)
    shape = (3, 576, 17)
    got = drop_ops.threefry_keep_mask(drop_ops.keys_tensor(key), shape, keep)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    want = np.asarray(jax.random.bernoulli(_jax_key(key), keep, shape))
    assert np.array_equal(got.numpy(), want)
    # at an offset: the same draw's later elements
    tail = drop_ops.threefry_keep_mask(drop_ops.keys_tensor(key), (2, 576, 17), keep,
                                       offset=576 * 17)
    assert np.array_equal(tail.numpy(), want[1:])


def test_keys_tensor_keeps_the_bits():
    keys = np.array([[0xFFFFFFFF, 0x80000000], [1, 2]], np.uint32)
    t = drop_ops.keys_tensor(keys)
    assert t.dtype == torch.int32 and tuple(t.shape) == (2, 2)
    assert np.array_equal(t.numpy().view(np.uint32), keys)


def test_the_wrapper_refuses_a_key_of_another_type():
    with pytest.raises(ValueError, match="int32"):
        drop_ops.threefry_keep_mask(torch.zeros(2, dtype=torch.int64), (4,), 0.9)


# ------------------------------------------------- against Flax's Dropout
def _models(residual: bool):
    sets = ["model.dim_hidden=16", "model.latent_dim=16", "model.num_layers=3",
            "model.dropout=0.1", f"model.residual={str(residual).lower()}"]
    jm = jms.from_config(jconfig.load_train_configuration(None, sets).model, "fp32")
    tm = tms.from_config(tconfig.load_train_configuration(None, sets).model, "fp32",
                         device="cpu")
    return jm, tm


def _batch():
    data = np.random.default_rng(3)
    return (data.uniform(size=(BATCH, 32, 32)).astype(np.float32),
            data.uniform(size=(BATCH, 32, 32)).astype(np.float32))


def flax_masks(jm, under, steps) -> list[list[tuple[np.ndarray, np.ndarray]]]:
    """Per step, the (key data, mask) of every ``bernoulli`` Flax's dropout
    draws in one train-mode ``apply`` under the JAX step's key
    ``fold_in(key(BASE_SEED), step)``."""
    params = jm.init(jax.random.key(0), jnp.asarray(under))
    seen: list = []
    real = fstochastic.random.bernoulli

    def spy(key, p, shape):
        mask = real(key, p, shape)
        seen.append((np.asarray(jax.random.key_data(key)), np.asarray(mask)))
        return mask

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fstochastic.random, "bernoulli", spy)
        for s in steps:
            seen.clear()
            jm.apply(params, jnp.asarray(under), deterministic=False,
                     rngs={"dropout": jax.random.fold_in(jax.random.key(BASE_SEED), s)})
            out.append(list(seen))
    return out


def port_masks(tm, fully, under, steps: int, monkeypatch, group=None) -> list[list]:
    """Per step of the port's module-path train step, the (keys, mask) of
    every layer's mask."""
    seen: list = []
    real = drop_ops.threefry_keep_mask

    def spy(keys, shape, keep, offset=0):
        mask = real(keys, shape, keep, offset)
        seen.append((keys.numpy().view(np.uint32).copy(), mask.numpy().copy(), offset))
        return mask

    monkeypatch.setattr(drop_ops, "threefry_keep_mask", spy)
    step = ttrainer.make_train_step(tm, tlosses.mse, 32, 24, use_pallas=False, group=group)
    state = ttrainer.create_train_state(tm, "sgd", 1e-2)
    out = []
    for _ in range(steps):
        seen.clear()
        step(state, torch.from_numpy(fully), torch.from_numpy(under), BASE_SEED)
        out.append(list(seen))
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_module_path_masks_equal_flax_bernoulli(residual, monkeypatch):
    jm, tm = _models(residual)
    fully, under = _batch()
    want = flax_masks(jm, under, range(3))
    got = port_masks(tm, fully, under, 3, monkeypatch)
    assert [len(w) for w in want] == [len(g) for g in got] == [3, 3, 3]
    for s, (w_step, g_step) in enumerate(zip(want, got)):
        for i, ((wk, wm), (gk, gm, offset)) in enumerate(zip(w_step, g_step)):
            assert np.array_equal(gk, wk), (s, i)
            assert offset == 0 and gm.shape == wm.shape == (BATCH, 576, 16)
            assert np.array_equal(gm, wm), (s, i)
    # the layers and the steps draw different masks
    flat = [m.tobytes() for step in got for _, m, _ in step]
    assert len(set(flat)) == len(flat)


def test_dropout_keys_fold_each_layers_scope(monkeypatch):
    """``dropout_keys`` is ``fold_in_static(k, "net", "layer_i",
    "Dropout_0", 1)`` of each hidden layer, the output layer left out;
    ``epoch_dropout_keys`` folds the step in first."""
    _, tm = _models(True)
    assert [p for _, p in flax_init.dropout_layers(tm)] == [
        ("net", f"layer_{i}") for i in range(3)]
    steps = jax_random.fold_in(jax_random.key(BASE_SEED), np.arange(4, 6))
    got = ttrainer.epoch_dropout_keys(BASE_SEED, 4, 2, tm)
    assert got.shape == (2, 3, 2) and got.dtype == np.uint32
    for s in range(2):
        for i in range(3):
            want = flax_init.fold_in_static(steps[s], "net", f"layer_{i}", "Dropout_0", 1)
            assert np.array_equal(got[s, i], want)


def test_two_ranks_draw_their_rows_of_the_global_mask(monkeypatch):
    """The module path over two ranks (GSPMD in the JAX package: one global
    mask): each rank's masks at two steps are its rows of the masks one
    process draws over the whole batch, with the same keys."""
    jm, tm = _models(True)
    fully, under = _batch()
    whole = port_masks(tm, fully, under, 2, monkeypatch)
    group = object()
    real_rank_world, real_mean = ttrainer.distributed.rank_world, ttrainer.distributed.all_reduce_mean_
    half = BATCH // 2
    for rank in range(2):
        _, tm_r = _models(True)
        monkeypatch.setattr(ttrainer.distributed, "rank_world",
                            lambda g, r=rank: (r, 2) if g is group else real_rank_world(g))
        monkeypatch.setattr(ttrainer.distributed, "all_reduce_mean_", lambda t, g: t)
        local = port_masks(tm_r, fully, under, 2, monkeypatch, group=group)
        for s in range(2):
            for (wk, wm, _), (gk, gm, offset) in zip(whole[s], local[s]):
                assert np.array_equal(gk, wk)
                assert offset == rank * half * 576 * 16
                assert np.array_equal(gm, wm[rank * half:(rank + 1) * half])
    assert ttrainer.distributed.all_reduce_mean_ is real_mean


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kept_values_are_scaled_as_flax_dropout_scales_them(dtype):
    """``flax_dropout`` against ``nn.Dropout(0.1)`` on the same values and
    mask, bit for bit, forward and gradient, under ``jit``. In bf16 Flax
    divides by bf16(0.9) = 0.8984375; in both types XLA on the CPU
    multiplies by the float32 reciprocal."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, size=(2, 576, 64)).astype(np.float32)
    co = rng.normal(size=x.shape).astype(np.float32)
    key = _random_key(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def flax_out(v):
        y = fnn.Dropout(rate=0.1).apply({}, v, deterministic=False,
                                        rngs={"dropout": _jax_key(key)})
        return jnp.sum(y.astype(jnp.float32) * co), y

    # jitted, as the JAX package's train step is: XLA then sees keep_prob
    # as a constant (op by op, a float32 divide stays a divide)
    (_, want), grad = jax.jit(jax.value_and_grad(flax_out, has_aux=True))(
        jnp.asarray(x).astype(jdt))
    # Flax's Dropout module draws under its own make_rng("dropout")
    mask_key = flax_init.fold_in_static(key, 1)
    keep = drop_ops.threefry_keep_mask(drop_ops.keys_tensor(mask_key), x.shape, 0.9)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = flax_dropout(xt, keep, 0.1)
    (got.float() * torch.from_numpy(co)).sum().backward()
    assert got.dtype == tdt
    assert np.array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert np.array_equal(xt.grad.float().numpy(), np.asarray(grad.astype(jnp.float32)))
    assert 0.05 < float((~keep).float().mean()) < 0.15
    if dtype == "bfloat16":  # the old scale, an f32 multiply by 1/0.9, misses many
        old = (xt.detach().float() * float(np.float32(1 / 0.9))).to(tdt)
        kept = keep.numpy()
        assert (old.float().numpy()[kept] != np.asarray(want.astype(jnp.float32))[kept]).mean() > 0.2


def test_layer_forward_drops_through_its_mask_fn():
    """``SirenLayer`` in train mode with ``dropout_mask_fn`` set: the
    elements its mask drops are zero, the rest its eval output scaled."""
    _, tm = _models(False)
    layer = tm.net.layers[1]
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 576, 16)).astype(np.float32))
    keys = drop_ops.keys_tensor(np.array([3, 4], np.uint32))
    layer.dropout_mask_fn = functools.partial(drop_ops.threefry_keep_mask, keys, keep=0.9)
    layer.train()
    got = layer(x)
    layer.eval()
    plain = layer(x)
    keep = drop_ops.threefry_keep_mask(keys, (2, 576, 16), 0.9)
    assert torch.equal(got == 0, ~keep | (plain == 0))
    assert torch.equal(got[keep], plain[keep] * float(np.float32(1) / np.float32(0.9)))


# -------------------------------------------- chip_smoke.py's dropout phase
def test_the_recorded_full_width_masks_are_the_jax_packages():
    """``tests/data/jax_dropout_masks.json``, which ``chip_smoke.py`` holds
    the card's kernel against at (400, 576, 256), is what the JAX package
    draws here (keys by the spy on Flax's dropout, masks by
    ``jax.random.bernoulli``), and the port's keys for the train CLI's
    model are the recorded ones."""
    import importlib.util
    import json
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "jax_dropout_constants.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    recorded = json.loads(rec.OUT.read_text())
    assert recorded == rec.records()
    assert len(recorded["masks"]) == 2 * 5 and recorded["keep"] == 0.9
    cfg = tconfig.load_train_configuration(rec.REPO / "configs" / "train.yaml")
    model = tms.from_config(cfg.model, "fp32", device="cpu")
    for m in recorded["masks"]:
        keys = ttrainer.epoch_dropout_keys(recorded["base_seed"], m["step"], 1, model)[0]
        assert keys[m["layer"]].tolist() == m["key"]
        assert 0.89 < m["kept"] / np.prod(recorded["shape"]) < 0.91
    assert len({m["sha256"] for m in recorded["masks"]}) == 10
