"""The port's training runtime on the CPU (``device="cpu"``: the kernels'
plain PyTorch versions) against the JAX package's, and its artifacts.

- train step: from transplanted weights, dropout off, ``optimizer: sgd``,
  three steps at lr 1e-3; losses within 1e-5 and parameters within 1e-6 of
  JAX's ``make_train_step(use_pallas=True, interpret=True)`` (measured 2.4e-6
  and 9e-8 over three data seeds; at lr 1e-2 one bf16 rounding of a layer
  input that falls the other way grows to 3.7e-5 and 1.7e-5 by step three,
  with the first step, before any update, at 2.3e-6 either way). Adam is
  held apart, on one numpy gradient sequence (1e-7): its first steps move
  every element by about ``lr`` whatever the gradient's size, so an element
  whose gradient is rounding noise would differ by ``2 * lr`` with nothing
  wrong.
- the device-resident epoch equals the host loop (the JAX bar, 1e-6).
- ``Trainer`` artifacts, the SIGTERM contract, checkpoint round trip, resume
  discovery equal to the JAX package's on one directory tree, the train CLI.
"""

import csv
import os
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.preprocessing import process_files
from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.train import checkpoint as jckpt
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu.train import trainer as jtrainer
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data.dataset import MRIDataset
from mri_inr_tpu_torch.interop import load_flax_params, params_from_flax
from mri_inr_tpu_torch.models import flax_init
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.models.siren import flax_dropout
from mri_inr_tpu_torch.ops import dropout as tdrop
from mri_inr_tpu_torch.models.perceptual import PerceptualEncoderV2
from mri_inr_tpu_torch.ops import siren_train_kernel as tstk
from mri_inr_tpu_torch.ops import tiling as ttiling
from mri_inr_tpu_torch.train import checkpoint as tckpt
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train import trainer as ttrainer
from mri_inr_tpu_torch.utils import tensorboard

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
WIDTHS = dict(dim_hidden=64, latent_dim=32, num_layers=3)


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    jsyn.write_synthetic_h5(d, num_files=2, num_slices=2, height=64, width=64)
    return process_files(d)


@pytest.fixture(scope="module")
def datasets(metadata):
    return MRIDataset(metadata, max_slice_num=10), MRIDataset(metadata, max_slice_num=0)


def _model(seed=0, **kw):
    return ModulatedSiren(**{**WIDTHS, **kw}, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("sin5", [True, False], ids=["sin5", "deg9"])
def test_three_sgd_steps_match_jax(sin5):
    data = np.random.default_rng(0)
    fully = data.uniform(size=(16, 32, 32)).astype(np.float32)
    under = data.uniform(size=(16, 32, 32)).astype(np.float32)
    jm = JaxModel(dropout=0.0, **WIDTHS)
    jstate = jtrainer.create_train_state(jm, jax.random.key(0), jnp.zeros((4, 32, 32)),
                                         "sgd", 1e-3)
    tm = _model(dropout=0.0)
    load_flax_params(tm, jax.device_get(jstate.params))
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tstate = ttrainer.create_train_state(tm, "sgd", 1e-3)

    jstep = jtrainer.make_train_step(jm, jlosses.mse, 32, 24, use_pallas=True,
                                     interpret=True, sin5=sin5)
    tstep = ttrainer.make_train_step(tm, tlosses.mse, 32, 24, use_pallas=True, sin5=sin5)
    rng = jax.random.key(1)
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(fully), jnp.asarray(under), rng)
        tloss = tstep(tstate, torch.from_numpy(fully), torch.from_numpy(under), 1)
        assert abs(float(tloss) - float(jloss)) <= 1e-5, i
    assert tstate.step == int(jstate.step) == 3
    want = params_from_flax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    # the three steps moved the weights far more than the bar they are held to
    assert max((p.detach() - start[n]).abs().max().item()
               for n, p in tm.named_parameters()) > 1e-4


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizers_match_optax_on_one_gradient_sequence(name):
    rng = np.random.default_rng(0)
    # weights of a layer's size (|p| < 0.5), where 1e-7 is a few f32 ulps; at
    # |p| in [1, 2) one ulp alone is 1.19e-7
    p0 = rng.uniform(-0.5, 0.5, size=(7, 5)).astype(np.float32)
    grads = [(rng.normal(size=(7, 5)) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
             for _ in range(10)]
    tx = jtrainer.make_optimizer(name, 1e-3)
    jp, jst = jnp.asarray(p0), None
    jst = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrainer.make_optimizer(name, 1e-3, [tp])
    for g in grads:
        upd, jst = tx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        ttrainer.make_optimizer("lion", 1e-3, [tp])


def test_the_card_tests_adam_reference_is_optax():
    """tests/test_torch_port_graph_cuda.py holds Adam on the card (where no
    JAX is installed) to optax's update written out in float32 numpy; here
    that transcription is held to optax itself on the same gradient
    sequence, within 1e-7 (measured 6e-8)."""
    import test_torch_port_graph_cuda as graph_cuda

    p0, grads = graph_cuda.gradient_sequence()
    tx = jtrainer.make_optimizer("adam", 1e-3)
    jp = jnp.asarray(p0)
    jst = tx.init(jp)
    for g in grads:
        upd, jst = tx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(graph_cuda.optax_adam_f32(p0, grads), np.asarray(jp), rtol=0,
                               atol=1e-7)


def _jax_seeds(base, steps, rank=None):
    """The JAX package's fused dropout seeds: ``randint(fold_in(key(base),
    step), (1,), 0, 2**23)``, the mesh step's with ``fold_in(., rank)``."""
    def one(step):
        key = jax.random.fold_in(jax.random.key(base), step)
        if rank is not None:
            key = jax.random.fold_in(key, rank)
        return jax.random.randint(key, (1,), 0, 2**23)[0]
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(steps)))


@pytest.mark.parametrize("rank", [None, 0, 1], ids=["scan", "rank0", "rank1"])
def test_step_seed_is_a_pure_function_in_range(rank):
    """Steps 0-2,000 of each route equal the JAX package's draws (the scan
    epoch's without a rank, the mesh step's of ranks 0 and 1)."""
    steps = np.arange(2001)
    seeds = [ttrainer.step_seed(1, s, rank) for s in range(200)]
    assert seeds == [ttrainer.step_seed(1, s, rank) for s in range(200)]
    assert all(0 <= s < 2**23 for s in seeds)
    assert len(set(seeds)) > 190
    assert ttrainer.step_seed(2, 0, rank) != ttrainer.step_seed(1, 0, rank)
    for base in (1, 31416):
        got = ttrainer.epoch_seeds(base, 0, len(steps), rank)
        np.testing.assert_array_equal(got, _jax_seeds(base, steps, rank).astype(np.float32))
        assert [ttrainer.step_seed(base, s, rank) for s in (0, 7, 2000)] == list(got[[0, 7, 2000]])


def test_each_step_route_draws_its_jax_routes_seed(datasets, monkeypatch):
    """The fused per-step route draws the mesh step's seed (rank 0 folded in,
    as ``train_mod_siren.py``'s one-device mesh does), the fused scan epoch
    the unfolded seed; the module path, per step and in the scan epoch,
    draws Flax's masks under the unfolded step key (its mesh step is GSPMD):
    the draw each route's dropout sees."""
    train, _ = datasets
    fully, under = (torch.from_numpy(a) for a in next(train.batches(32, seed=0)))
    seen = set()
    seed_tensor = tstk.seed_tensor
    monkeypatch.setattr(tstk, "seed_tensor",
                        lambda seed, device: seen.add(int(seed)) or seed_tensor(seed, device))
    keep_mask = tdrop.threefry_keep_mask
    monkeypatch.setattr(tdrop, "threefry_keep_mask", lambda keys, *a, **k: seen.add(
        tuple(keys.numpy().view(np.uint32))) or keep_mask(keys, *a, **k))

    def draws(use_pallas, scan):
        seen.clear()
        model = _model(dropout=0.1)
        state = ttrainer.create_train_state(model, "sgd", 1e-3)
        state.step = 5
        if scan:
            epoch = ttrainer.make_scan_epoch(model, tlosses.mse, 32, 24, use_pallas=use_pallas)
            epoch(state, fully, under, np.arange(32, dtype=np.int32)[None], 9, True)
        else:
            step = ttrainer.make_train_step(model, tlosses.mse, 32, 24, use_pallas=use_pallas)
            step(state, fully, under, 9)
        return set(seen)

    mesh_seed, scan_seed = _jax_seeds(9, [5], rank=0)[0], _jax_seeds(9, [5])[0]
    assert mesh_seed != scan_seed
    assert draws(True, scan=False) == {mesh_seed}
    assert draws(True, scan=True) == {scan_seed}
    step_key = jax.random.key_data(jax.random.fold_in(jax.random.key(9), 5))
    layer_keys = {tuple(flax_init.fold_in_static(np.asarray(step_key), "net", f"layer_{i}",
                                                 "Dropout_0", 1)) for i in range(3)}
    assert draws(False, scan=False) == draws(False, scan=True) == layer_keys


def test_fused_train_step_reduces_loss_with_dropout(datasets):
    train, _ = datasets
    model = _model(dropout=0.1)
    state = ttrainer.create_train_state(model, "adam", 1e-3)
    step = ttrainer.make_train_step(model, tlosses.mse, 32, 24, use_pallas=True, sin5=True)
    fully, under = (torch.from_numpy(a) for a in next(train.batches(32, seed=0)))
    first = float(step(state, fully, under, 1))
    for _ in range(19):
        loss = float(step(state, fully, under, 1))
    assert loss < first * 0.9
    assert state.step == 20


@pytest.mark.parametrize("kw", [dict(), dict(residual=True)], ids=["plain", "residual"])
def test_module_path_step_draws_dropout_from_the_step_seed(datasets, kw):
    """``use_pallas=False`` (and every residual model): dropout masks come
    from the step's key (Flax's masks, ``ops/dropout.py``), so two runs
    repeat, the global stream is untouched and the model is left in eval
    mode."""
    train, _ = datasets
    fully, under = (torch.from_numpy(a) for a in next(train.batches(32, seed=0)))

    def run(use_pallas):
        model = _model(dropout=0.1, **kw)
        state = ttrainer.create_train_state(model, "sgd", 1e-2)
        step = ttrainer.make_train_step(model, tlosses.mse, 32, 24, use_pallas=use_pallas)
        before = torch.get_rng_state()
        ls = [float(step(state, fully, under, 3)) for _ in range(3)]
        assert torch.equal(before, torch.get_rng_state())  # global stream untouched
        assert not model.training
        return ls, _flat(model)

    (l1, p1), (l2, p2) = run(False), run(False)
    assert l1 == l2 and np.array_equal(p1, p2)
    assert l1[0] != l1[1]
    if kw:  # residual models are never fused, whatever use_pallas says
        l3, p3 = run(True)
        assert l3 == l1 and np.array_equal(p3, p1)


@pytest.mark.parametrize("kw", [dict(), dict(residual=True)], ids=["plain", "residual"])
def test_module_path_masks_are_the_fused_paths_hash(datasets, kw):
    """The module path no longer drops with the fused path's counter hash:
    its hidden layer i keeps Flax's ``bernoulli`` mask of the layer's key
    (``epoch_dropout_keys``, ``ops/dropout.py``), scaled as Flax's dropout
    scales it. Its first step's loss equals a forward with those masks
    applied by hand, and the masks differ from the hash's
    ``dropout_mask(seed, i, keep, (B, S, H))``."""
    train, _ = datasets
    fully, under = (torch.from_numpy(a) for a in next(train.batches(32, seed=0)))
    model = _model(dropout=0.1, **kw)
    seen = []
    for i, layer in enumerate(model.net.layers):
        layer.register_forward_hook(lambda m, args, out, i=i: seen.append((i, out.detach())))
    ref = _model(dropout=0.0, **kw)
    ref.load_state_dict(model.state_dict())
    keys = ttrainer.epoch_dropout_keys(3, 0, 1, model)[0]
    seed = ttrainer.step_seed(3, 0)
    hand = {}
    for i, layer in enumerate(ref.net.layers):
        keep = tdrop.threefry_keep_mask(tdrop.keys_tensor(keys[i]), (32, 576, 64), 0.9)
        hash_mask = tstk.dropout_mask(torch.tensor([float(seed)]), i, 0.9, (32, 576, 64))
        assert not torch.equal(keep, hash_mask != 0)
        hand[i] = keep
        layer.register_forward_hook(lambda m, args, out, i=i: flax_dropout(out, hand[i], 0.1))
    step = ttrainer.make_train_step(model, tlosses.mse, 32, 24, use_pallas=False)
    loss = float(step(ttrainer.create_train_state(model, "sgd", 1e-2), fully, under, 3))
    with torch.no_grad():
        want = float(tlosses.mse(ref(under).float(),
                                 ttiling.extract_center_batch(fully, 32, 24).float()))
    assert loss == want
    assert [i for i, _ in seen] == list(range(len(model.net.layers)))
    for i, out in seen:  # each layer's output holds zeros exactly where its mask does
        assert torch.equal(out == 0, ~hand[i])
        assert 0.05 < float((~hand[i]).float().mean()) < 0.15
    assert all(layer.dropout_mask_fn is None for layer in model.net.layers)


def test_freeze_encoder_keeps_the_conv_stack(datasets):
    train, _ = datasets
    fully, under = (torch.from_numpy(a) for a in next(train.batches(32, seed=0)))
    model = _model(dropout=0.0)
    enc0 = [p.detach().clone() for p in model.encoder.encoder.parameters()]
    net0 = model.net.layers[1].weight.detach().clone()
    state = ttrainer.create_train_state(model, "adam", 1e-3)
    step = ttrainer.make_train_step(model, tlosses.mse, 32, 24, use_pallas=True,
                                    freeze_encoder=True)
    for _ in range(2):
        step(state, fully, under, 1)
    for a, b in zip(enc0, model.encoder.encoder.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(net0, model.net.layers[1].weight)


def test_freeze_encoder_keeps_the_vgg_trunk_and_trains_its_head(datasets):
    """For ``encoder_type=vgg`` only the trunk is frozen; the latent head
    trains, as the JAX package's ``_freeze_encoder_grads`` does."""
    train, _ = datasets
    fully, under = (torch.from_numpy(a[:8]) for a in next(train.batches(32, seed=0)))
    model = _model(dropout=0.0, encoder_type="vgg")
    enc = model.encoder.encoder
    trunk0 = [p.detach().clone() for p in enc.trunk.parameters()]
    fc0 = enc.fc.weight.detach().clone()
    state = ttrainer.create_train_state(model, "adam", 1e-3)
    step = ttrainer.make_train_step(model, tlosses.mse, 32, 24, use_pallas=True,
                                    freeze_encoder=True)
    step(state, fully, under, 1)
    for a, b in zip(trunk0, enc.trunk.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(fc0, enc.fc.weight)


def test_splice_pretrained_encoder():
    donor, model = _model(seed=5), _model(seed=0)
    ae_state = {f"encoder.{k}": v for k, v in donor.encoder.encoder.state_dict().items()}
    ae_state["decoder.fc.weight"] = torch.zeros(3, 3)
    ttrainer.splice_pretrained_encoder(model, ae_state)
    for a, b in zip(donor.encoder.encoder.parameters(), model.encoder.encoder.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(donor.net.layers[1].weight, model.net.layers[1].weight)
    # a VGG autoencoder's trunk: only into a vgg encoder, whose fc stays
    with pytest.raises(ValueError, match="encoder_type=vgg"):
        ttrainer.splice_pretrained_encoder(model, {"trunk.conv_0.weight": torch.zeros(1)})
    vgg_donor, vgg = _model(seed=5, encoder_type="vgg"), _model(seed=0, encoder_type="vgg")
    fc0 = vgg.encoder.encoder.fc.weight.detach().clone()
    trunk = {f"trunk.{k}": v for k, v in vgg_donor.encoder.encoder.trunk.state_dict().items()}
    ttrainer.splice_pretrained_encoder(vgg, {**trunk, "decoder.out.weight": torch.zeros(1)})
    for a, b in zip(vgg_donor.encoder.encoder.trunk.parameters(),
                    vgg.encoder.encoder.trunk.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(fc0, vgg.encoder.encoder.fc.weight)
    with pytest.raises(ValueError):
        ttrainer.splice_pretrained_encoder(model, {"decoder.w": torch.zeros(1)})


def test_eval_step_follows_sin5_and_runs_without_dropout(datasets):
    train, _ = datasets
    fully, under = (torch.from_numpy(a) for a in next(train.batches(32, seed=0)))
    model = _model(dropout=0.1)
    state = ttrainer.create_train_state(model, "adam", 1e-3)
    ev5 = ttrainer.make_eval_step(model, tlosses.mse, 32, 24, use_pallas=True, sin5=True,
                                  device="cpu")
    ev9 = ttrainer.make_eval_step(model, tlosses.mse, 32, 24, use_pallas=True, sin5=False,
                                  device="cpu")
    evm = ttrainer.make_eval_step(model, tlosses.mse, 32, 24, use_pallas=False, device="cpu")
    a, b = float(ev5(state, fully, under)), float(ev5(state, fully, under))
    assert a == b
    assert a != float(ev9(state, fully, under))
    assert abs(float(evm(state, fully, under)) - float(ev9(state, fully, under))) < 1e-2
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------------ make_scan_epoch
def _tiles(dataset):
    return torch.from_numpy(dataset.fully_tiles), torch.from_numpy(dataset.under_tiles)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
def test_scan_epoch_equals_the_per_step_loop(datasets, use_pallas, monkeypatch):
    """The epoch's CPU loop (the body a CUDA graph captures on the card) and
    the per-step functions over the same batches: two train epochs with
    dropout 0.1 and Adam, then a validation epoch; losses and parameters
    bit for bit (the same operations on the same values: the seed buffer
    holds the per-step seeds exactly, and the eval body packs the weights as
    ``WeightPack`` does). The fused per-step route draws the JAX mesh step's
    seeds, the epoch the scan epoch's (the JAX package's two routes); here
    the per-step functions draw the epoch's, so the rest is compared."""
    scan_seeds = ttrainer.epoch_seeds
    monkeypatch.setattr(ttrainer, "epoch_seeds",
                        lambda base, step0, n, rank=None: scan_seeds(base, step0, n))
    train, val = datasets

    def state_of():
        model = _model(dropout=0.1)
        return model, ttrainer.create_train_state(model, "adam", 1e-3)

    model_a, state_a = state_of()
    epoch = ttrainer.make_scan_epoch(model_a, tlosses.mse, 32, 24, use_pallas=use_pallas,
                                     sin5=True)
    model_b, state_b = state_of()
    step = ttrainer.make_train_step(model_b, tlosses.mse, 32, 24, use_pallas=use_pallas,
                                    sin5=True)
    ev = ttrainer.make_eval_step(model_b, tlosses.mse, 32, 24, use_pallas=use_pallas, sin5=True,
                                 device="cpu")
    got, want = [], []
    for e, (dataset, is_train) in enumerate([(train, True), (train, True), (val, False)]):
        fully_all, under_all = _tiles(dataset)
        perm = ttrainer.make_epoch_perm(len(dataset), 32, e, shuffle=is_train)
        got.append(float(epoch(state_a, fully_all, under_all, perm, 7, is_train)))
        losses = []
        for idx in torch.from_numpy(perm).long():
            f, u = fully_all[idx], under_all[idx]
            losses.append(step(state_b, f, u, 7) if is_train else ev(state_b, f, u))
        want.append(float(torch.stack(losses).mean()))
    assert got == want
    assert state_a.step == state_b.step == 2 * -(-len(train) // 32)
    assert np.array_equal(_flat(model_a), _flat(model_b))
    assert epoch.captures == epoch.replays == 0  # no graph on the CPU


@pytest.mark.parametrize("sin5", [True, False], ids=["sin5", "deg9"])
def test_scan_epoch_matches_jax(sin5):
    """One 3-step epoch (48 tiles, batch 16, shuffled) against the JAX
    package's ``make_scan_epoch(use_pallas=True, interpret=True)``, dropout
    0, SGD at lr 1e-3: the bars of test_three_sgd_steps_match_jax (mean loss
    1e-5, parameters 1e-6)."""
    data = np.random.default_rng(1)
    fully = data.uniform(size=(48, 32, 32)).astype(np.float32)
    under = data.uniform(size=(48, 32, 32)).astype(np.float32)
    perm = ttrainer.make_epoch_perm(48, 16, 0, shuffle=True)
    assert perm.shape == (3, 16)
    jm = JaxModel(dropout=0.0, **WIDTHS)
    jstate = jtrainer.create_train_state(jm, jax.random.key(0), jnp.zeros((4, 32, 32)),
                                         "sgd", 1e-3)
    tm = _model(dropout=0.0)
    load_flax_params(tm, jax.device_get(jstate.params))
    tstate = ttrainer.create_train_state(tm, "sgd", 1e-3)
    jepoch = jtrainer.make_scan_epoch(jm, jlosses.mse, 32, 24, use_pallas=True,
                                      interpret=True, sin5=sin5)
    jstate, jloss = jepoch(jstate, jnp.asarray(fully), jnp.asarray(under), jnp.asarray(perm),
                           jax.random.key(1), True)
    tepoch = ttrainer.make_scan_epoch(tm, tlosses.mse, 32, 24, use_pallas=True, sin5=sin5)
    tloss = tepoch(tstate, torch.from_numpy(fully), torch.from_numpy(under), perm, 1, True)
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert tstate.step == int(jstate.step) == 3
    want = params_from_flax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_epoch_seed_buffer_follows_step_seed_across_a_resume(datasets, tmp_path):
    """The seed buffer of each train epoch holds ``step_seed(base, s)`` for
    its steps; a run restored from a checkpoint continues the stream where
    it stopped, and ends where a straight run ends (bit for bit)."""
    train, _ = datasets
    nb = -(-len(train) // 32)
    assert np.array_equal(ttrainer.epoch_seeds(5, 3, 4),
                          np.array([ttrainer.step_seed(5, s) for s in range(3, 7)], np.float32))

    def seeds_of(trainer):
        (bufs,) = [b for k, b in trainer.scan_epoch._buffers.items() if k[-1]]
        return bufs.seeds.tolist()

    straight = _trainer(datasets, tmp_path / "a", device_data=True)
    seen = []
    for e in range(2):
        straight._epoch_loss(train, train=True, epoch=e)
        seen.append(seeds_of(straight))
    base = straight.base_seed
    assert seen == [[ttrainer.step_seed(base, s) for s in range(e * nb, (e + 1) * nb)]
                    for e in range(2)]

    first = _trainer(datasets, tmp_path / "b", device_data=True)
    first._epoch_loss(train, train=True, epoch=0)
    tckpt.save_state(tmp_path / "b", first.state.step, first.state)
    resumed = _trainer(datasets, tmp_path / "c", device_data=True)
    tckpt.restore_state(tmp_path / "b", nb, resumed.state)
    resumed._epoch_loss(train, train=True, epoch=1)
    assert seeds_of(resumed) == seen[1]
    assert resumed.state.step == straight.state.step == 2 * nb
    assert np.array_equal(_flat(resumed.model), _flat(straight.model))


def test_post_epoch_invalidation_repacks_after_an_update_that_keeps_versions(datasets,
                                                                            tmp_path):
    """A CUDA graph's replay updates the parameters in place without moving
    their ``_version``, as ``p.data.add_`` does. ``WeightPack`` then keeps
    the old packed weights; the trainer's invalidation after a train epoch
    makes validation (and the snapshots) repack: the validation loss equals
    a fresh ``make_apply_fn``'s, bit for bit."""
    _, val = datasets
    t = _trainer(datasets, tmp_path / "run")
    fully, under = (torch.from_numpy(a) for a in next(val.batches(32, seed=0)))
    before = float(t.eval_step(t.state, fully, under))
    versions = [p._version for p in t.model.parameters()]
    with torch.no_grad():  # the packed weights: the SIREN's and the modulator's
        for p in [*t.model.net.parameters(), *t.model.modulator.parameters()]:
            p.data.add_(0.01)
    assert [p._version for p in t.model.parameters()] == versions
    fresh = ttrainer.make_eval_step(t.model, tlosses.mse, 32, 24, use_pallas=True, sin5=True,
                                    device="cpu")
    want = float(fresh(t.state, fully, under))
    assert float(t.eval_step(t.state, fully, under)) != want  # stale without it
    t.invalidate_packs()
    after = float(t.eval_step(t.state, fully, under))
    assert after == want and after != before
    pack = t.reconstructor.apply_fn.pack
    assert pack._key is None  # the snapshots repack too


# ---------------------------------------------------------------- Trainer
def _trainer(datasets, run_dir, **kw):
    train, val = datasets
    model = _model(dropout=0.1)
    args = dict(batch_size=32, save_interval=1000, use_pallas=True, sin5=True, device="cpu",
                log=lambda *_: None)
    args.update(kw)
    return ttrainer.Trainer(model, ttrainer.create_train_state(model, "adam", 1e-3),
                            tlosses.mse, train, val, run_dir, **args)


def test_device_resident_epoch_equals_host_loop(datasets, tmp_path, monkeypatch):
    """The Trainer with and without ``device_data``: the same losses and
    parameters. The fused host loop draws the JAX mesh step's seeds, the
    device-resident epoch the scan epoch's; here the host loop draws the
    epoch's, so the rest of the two routes is compared."""
    scan_seeds = ttrainer.epoch_seeds
    monkeypatch.setattr(ttrainer, "epoch_seeds",
                        lambda base, step0, n, rank=None: scan_seeds(base, step0, n))
    train, val = datasets

    def run(device_data, tmp):
        t = _trainer(datasets, tmp, device_data=device_data)
        ls = (t._epoch_loss(train, train=True, epoch=0),
              t._epoch_loss(train, train=True, epoch=1),
              t._epoch_loss(val, train=False, epoch=0))
        return ls, _flat(t.model)

    (lh, ph), (ld, pd) = run(False, tmp_path / "a"), run(True, tmp_path / "b")
    for a, b in zip(lh, ld):
        assert b == pytest.approx(a, rel=1e-5)
    np.testing.assert_allclose(pd, ph, rtol=0, atol=1e-6)


def test_trainer_writes_the_artifacts(datasets, tmp_path):
    logs = []
    t = _trainer(datasets, tmp_path / "run", save_interval=1, snapshot_slices=1,
                 log=logs.append)
    init = t.initial_errors()
    assert t.initial_losses == init and all(np.isfinite(init))
    state = t.train(2)
    steps = 2 * (-(-len(datasets[0]) // 32))
    assert state.step == steps
    run = tmp_path / "run"
    with open(run / "progress_log.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert list(rows[0]) == ["epoch", "train_loss", "val_loss", "epoch_seconds",
                             "time_since_start"]
    assert (run / "progress_log.txt").read_text().splitlines()[0].split() == [
        "epoch", "train_loss", "val_loss", "t_total"]
    assert tckpt.find_latest_step(run) == steps
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        f"step_{steps // 2:08d}", f"step_{steps:08d}"]
    assert sorted(p.name for p in (run / "snapshots").iterdir()) == [
        "train_0_epoch_00000.png", "train_0_epoch_00001.png",
        "val_0_epoch_00000.png", "val_0_epoch_00001.png"]
    assert any(m.startswith("initial losses") for m in logs)
    assert float(rows[1]["train_loss"]) < init[0]


def test_trainer_without_matplotlib_saves_and_leaves_the_renders_out(datasets, tmp_path,
                                                                     monkeypatch):
    """A machine without matplotlib (the card's) trains through a
    save_interval epoch: the checkpoint is written, the renders are left
    out and the log says so once."""
    monkeypatch.setattr(ttrainer.visualization, "have_matplotlib", lambda: False)
    logs = []
    t = _trainer(datasets, tmp_path / "run", save_interval=1, snapshot_slices=1,
                 log=logs.append)
    state = t.train(2)
    assert tckpt.find_latest_step(tmp_path / "run") == state.step
    assert len(list((tmp_path / "run" / "checkpoints").iterdir())) == 2
    assert not list((tmp_path / "run" / "snapshots").iterdir())
    assert logs.count("matplotlib is not installed: snapshot renders left out") == 1


def test_sigterm_finishes_the_epoch_and_saves(datasets, tmp_path):
    t = _trainer(datasets, tmp_path / "run")
    real = t._epoch_loss
    calls = []

    def epoch_loss(dataset, train, epoch):
        if train and not calls:
            os.kill(os.getpid(), signal.SIGTERM)
        calls.append((train, epoch))
        return real(dataset, train, epoch)

    t._epoch_loss = epoch_loss
    previous = signal.getsignal(signal.SIGTERM)
    state = t.train(5)
    assert signal.getsignal(signal.SIGTERM) == previous  # handler restored
    assert calls == [(True, 0), (False, 0)]  # the epoch ran to its end, no second one
    assert state.step == -(-len(datasets[0]) // 32)
    assert tckpt.find_latest_step(tmp_path / "run") == state.step
    assert (tmp_path / "run" / "progress_log.csv").is_file()


def test_tensorboard_and_wrong_device_raise(datasets, tmp_path):
    """TensorBoard, once refused, opens its event file in the run directory
    (``tests/test_torch_port_tensorboard.py`` reads the scalars back); a
    trainer without a device raises where there is no card."""
    t = _trainer(datasets, tmp_path / "run", tensorboard=True)
    t._tb.flush()
    (events,) = (tmp_path / "run" / "tensorboard").glob("events.out.tfevents.*")
    assert events.is_file()
    with pytest.raises(RuntimeError):
        _trainer(datasets, tmp_path / "run", device=None)  # cuda by default: no card here


# ------------------------------------------------------------ checkpoints
def test_checkpoint_round_trip(datasets, tmp_path):
    t = _trainer(datasets, tmp_path / "run")
    t._epoch_loss(datasets[0], train=True, epoch=0)
    path = tckpt.save_state(tmp_path / "run", t.state.step, t.state)
    assert path == tckpt.checkpoint_path(tmp_path / "run", t.state.step)
    assert path.name == f"step_{t.state.step:08d}" and (path / tckpt.STATE_FILE).is_file()

    other = _trainer(datasets, tmp_path / "other")
    assert not np.array_equal(_flat(other.model), _flat(t.model))
    tckpt.restore_state(tmp_path / "run", t.state.step, other.state)
    assert other.state.step == t.state.step
    assert np.array_equal(_flat(other.model), _flat(t.model))
    # the optimizer's moments came along: one more identical step agrees
    fully, under = (torch.from_numpy(a) for a in next(datasets[0].batches(32, seed=9)))
    la = t.train_step(t.state, fully, under, t.base_seed)
    lb = other.train_step(other.state, fully, under, other.base_seed)
    assert float(la) == float(lb)
    assert np.array_equal(_flat(other.model), _flat(t.model))


def test_resume_discovery_matches_jax(tmp_path):
    out = tmp_path / "output"
    for name, steps in [("base_2026-01-01_00-00-00", [5, 50]),
                        ("base_2026-03-01_10-00-00", [7, 12, 9]),
                        ("base_2026-02-01_00-00-00", [999]),
                        ("base_x_2026-12-01_00-00-00", [3]),
                        ("other_2026-12-31_00-00-00", [1]),
                        ("base_2026-04-01_00-00-00", []),  # newest, nothing saved
                        ("base_notatimestamp", [4])]:
        for s in steps:
            (out / name / "checkpoints" / f"step_{s:08d}").mkdir(parents=True)
        (out / name / "checkpoints").mkdir(parents=True, exist_ok=True)
    (out / "base_2026-05-01_00-00-00").write_text("a file, not a run dir")
    for name in ("base", "base_x", "other", "missing"):
        assert tckpt.find_latest_run_dir(out, name) == jckpt.find_latest_run_dir(out, name)
        assert tckpt.resolve_resume(out, name) == jckpt.resolve_resume(out, name)
    assert tckpt.resolve_resume(out, "base") is None  # the newest run has no step
    (out / "base_2026-04-01_00-00-00" / "checkpoints" / "step_00000002").mkdir()
    assert tckpt.resolve_resume(out, "base") == jckpt.resolve_resume(out, "base") == (
        out / "base_2026-04-01_00-00-00", 2)
    run = out / "base_2026-03-01_10-00-00"
    assert tckpt.find_latest_step(run) == jckpt.find_latest_step(run) == 12
    assert tckpt.checkpoint_path(run, 12) == jckpt.checkpoint_path(run, 12)
    assert tckpt.resolve_resume(tmp_path / "nowhere", "base") is None
    assert (tckpt.RUN_DIR_RE, tckpt.STEP_DIR_RE) == (jckpt.RUN_DIR_RE, jckpt.STEP_DIR_RE)
    made = tckpt.new_run_dir(out, "fresh", "2026-06-01_00-00-00")
    assert made == jckpt.new_run_dir(out, "fresh", "2026-06-01_00-00-00") and made.is_dir()


# -------------------------------------------------------------------- CLI
def _cli_args(metadata, out, *extra):
    sets = [f"data.train.dataset={metadata}", f"data.val.dataset={metadata}",
            "data.val.max_slice_num=0", "model.dim_hidden=64", "model.latent_dim=32",
            "model.num_layers=3", "training.batch_size=32", "training.save_interval=1000",
            f"training.output_dir={out}", "training.output_name=tiny", *extra]
    argv = ["--config", str(CONFIGS / "train.yaml"), "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_train_cli_seeded_equals_the_jax_scan_epoch(metadata, tmp_path):
    """No weights transplanted: the train CLI at ``training.seed=3`` draws
    the JAX package's initial weights and dropout seeds, so its first epoch
    (three steps of the device-resident epoch, dropout 0.1, fp32, SGD at lr
    1e-3) equals the JAX ``make_scan_epoch(use_pallas=True, interpret=True)``
    from ``key(3)`` and ``key(4)`` on the same split, to the bars of
    test_three_sgd_steps_match_jax (loss 1e-5, parameters 1e-6)."""
    from mri_inr_tpu.data.dataset import MRIDataset as JaxDataset

    jds = JaxDataset(metadata, mri_type="Flair", max_slice_num=None)
    n = len(jds)
    batch = -(-n // 3)
    trainer = cli_train.main(_cli_args(
        metadata, tmp_path / "out", "training.epochs=1", "training.seed=3",
        "training.optimizer=sgd", "training.lr=1e-3", "training.precision=fp32",
        "training.device_data=true", "data.train.max_slice_num=null",
        f"training.batch_size={batch}"))
    assert trainer.state.step == 3 and len(trainer.train_dataset) == n
    np.testing.assert_array_equal(trainer.train_dataset.under_tiles, jds.under_tiles)

    jm = JaxModel(dropout=0.1, **WIDTHS)
    jstate = jtrainer.create_train_state(jm, jax.random.key(3), jnp.zeros((2, 32, 32)),
                                         "sgd", 1e-3)
    jepoch = jtrainer.make_scan_epoch(jm, jlosses.mse, 32, 24, use_pallas=True,
                                      interpret=True, sin5=True)
    perm = jtrainer.make_epoch_perm(n, batch, 0, shuffle=True)
    jstate, jloss = jepoch(jstate, jnp.asarray(jds.fully_tiles), jnp.asarray(jds.under_tiles),
                           jnp.asarray(perm), jax.random.key(4), True)
    assert abs(trainer._progress[0]["train_loss"] - float(jloss)) <= 1e-5
    want = params_from_flax(jax.device_get(jstate.params))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_train_cli_two_epochs_then_a_resumed_third(metadata, tmp_path, capsys):
    out = tmp_path / "out"
    before = (tstk.siren_chain_train_fwd_cuda.launches,
              tstk.siren_chain_train_bwd_cuda.launches)
    first = cli_train.main(_cli_args(metadata, out, "training.epochs=2"))
    per_epoch = -(-len(first.train_dataset) // 32)
    assert first.state.step == 2 * per_epoch
    run = first.run_dir
    assert run.parent == out and run.name.startswith("tiny_")
    for name in ("config.yaml", "processed_files.txt", "progress_log.csv",
                 "progress_log.txt"):
        assert (run / name).is_file(), name
    assert tckpt.resolve_resume(out, "tiny") == (run, 2 * per_epoch)

    capsys.readouterr()
    again = cli_train.main(_cli_args(metadata, out, "training.epochs=3",
                                     "training.continue_training=true",
                                     "training.device_data=true"))
    text = capsys.readouterr().out
    assert f"resuming from {run} at step {2 * per_epoch}" in text
    assert "continuing at epoch 2" in text
    assert again.run_dir == run and again.state.step == 3 * per_epoch
    assert [r["epoch"] for r in again._progress] == [2]
    # the restored model starts where the first run's validation ended
    assert again.initial_losses[1] == pytest.approx(first._progress[-1]["val_loss"], rel=1e-5)
    assert tckpt.find_latest_step(run) == 3 * per_epoch
    # on the CPU no kernel is launched
    assert before == (tstk.siren_chain_train_fwd_cuda.launches,
                      tstk.siren_chain_train_bwd_cuda.launches)


@pytest.fixture(scope="module")
def metadata_100(tmp_path_factory):
    """Four 80 x 80 slices: 100 patches, not a multiple of the batch of 32."""
    d = tmp_path_factory.mktemp("data100")
    jsyn.write_synthetic_h5(d, num_files=2, num_slices=2, height=80, width=80)
    return process_files(d)


def test_train_cli_resumes_at_the_epoch_a_ragged_set_reached(metadata_100, tmp_path, capsys):
    """n = 100 at batch 32 runs ceil(100 / 32) = 4 steps an epoch: three
    epochs end at step 12, and the resume continues at epoch 3 (not at
    12 // (100 // 32) = 4), ending where a straight four-epoch run ends."""
    out = tmp_path / "out"
    first = cli_train.main(_cli_args(metadata_100, out, "training.epochs=3"))
    assert len(first.train_dataset) == 100
    assert first.state.step == 12
    capsys.readouterr()
    again = cli_train.main(_cli_args(metadata_100, out, "training.epochs=4",
                                     "training.continue_training=true"))
    text = capsys.readouterr().out
    assert f"resuming from {first.run_dir} at step 12" in text
    assert "continuing at epoch 3" in text
    assert [r["epoch"] for r in again._progress] == [3]
    straight = cli_train.main(_cli_args(metadata_100, tmp_path / "straight", "training.epochs=4"))
    assert again.state.step == straight.state.step == 16


def test_train_cli_pinned_model_path_and_fresh_start(metadata, tmp_path):
    out = tmp_path / "out"
    first = cli_train.main(_cli_args(metadata, out, "training.epochs=1"))
    pinned = cli_train.main(_cli_args(metadata, tmp_path / "elsewhere", "training.epochs=2",
                                      "training.continue_training=true",
                                      f"training.model_path={first.run_dir}"))
    assert pinned.run_dir == first.run_dir and pinned._progress[0]["epoch"] == 1
    # continue_training with nothing to resume starts fresh
    fresh = cli_train.main(_cli_args(metadata, tmp_path / "new", "training.epochs=1",
                                     "training.continue_training=true"))
    assert fresh.run_dir.parent == tmp_path / "new" and fresh._progress[0]["epoch"] == 0


@pytest.mark.parametrize("override,match", [
    pytest.param("training.logging=true", None, id="training.logging=true-item 17"),
    pytest.param("training.data_axis_size=4", "torchrun --nproc-per-node 4",
                 id="training.data_axis_size=4-item 17"),
])
def test_train_cli_names_what_is_not_ported(metadata, tmp_path, override, match):
    """Item 17's keys, once refused: ``training.logging`` writes the two
    scalars of every epoch; a ``data_axis_size`` other than the ranks
    started (one here) raises, naming the launch command."""
    argv = _cli_args(metadata, tmp_path / "out", "training.epochs=1", override)
    if match:
        with pytest.raises(ValueError, match=match):
            cli_train.main(argv)
        return
    t = cli_train.main(argv)
    row = t._progress[0]
    assert tensorboard.read_scalars(t.run_dir / "tensorboard") == {
        "training_loss": [(0, float(np.float32(row["train_loss"])))],
        "validation_loss": [(0, float(np.float32(row["val_loss"])))]}


@pytest.mark.parametrize("override", ["data.low_memory=true", "model.encoder_type=vgg",
                                      "training.criterion=perceptual", "data.train.online=true"])
def test_train_cli_runs_what_it_once_refused(metadata, tmp_path, override):
    """The low-memory dataset, the vgg encoder, the perceptual loss (with
    a perceptual encoder's state dict) and an online train split (the
    ``.h5`` directory the metadata was made from) train through the CLI."""
    extra = [override]
    if "online" in override:
        extra.append(f"data.train.dataset={metadata.parent.parent}")
    if "perceptual" in override:
        path = tmp_path / "perceptual.pt"
        torch.save(PerceptualEncoderV2(generator=torch.Generator().manual_seed(0)).state_dict(),
                   path)
        extra.append(f"training.perceptual_encoder_path={path}")
    batch = "training.batch_size=8" if "vgg" in override else "training.batch_size=32"
    t = cli_train.main(_cli_args(metadata, tmp_path / "out", "training.epochs=1", batch,
                                 *extra))
    assert t.state.step == -(-len(t.train_dataset) // int(batch.rsplit("=", 1)[1]))
    assert np.isfinite([t._progress[0]["train_loss"], t._progress[0]["val_loss"]]).all()
    if "vgg" in override:
        assert type(t.model.encoder.encoder).__name__ == "VGGEncoder"
    if "low_memory" in override:
        assert type(t.train_dataset).__name__ == "MRIDatasetLowMemory"
    if "online" in override:
        assert type(t.train_dataset).__name__ == "OnlineKspaceDataset"
        assert type(t.val_dataset).__name__ == "MRIDataset"  # it names its own dataset


def test_train_cli_encoder_path(metadata, tmp_path):
    donor = _model(seed=5)
    path = tmp_path / "ae.pt"
    torch.save({f"encoder.{k}": v for k, v in donor.encoder.encoder.state_dict().items()},
               path)
    t = cli_train.main(_cli_args(metadata, tmp_path / "out", "training.epochs=0",
                                 f"model.encoder_path={path}"))
    for a, b in zip(donor.encoder.encoder.parameters(), t.model.encoder.encoder.parameters()):
        assert torch.equal(a, b)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError, match="torch_checkpoint_interop.py jax-to-torch"):
        cli_train.main(_cli_args(metadata, tmp_path / "out", "training.epochs=0",
                                 f"model.encoder_path={tmp_path / 'orbax_dir'}"))


def test_train_cli_defaults_to_the_card(metadata, tmp_path):
    argv = [a for a in _cli_args(metadata, tmp_path / "out", "training.epochs=1")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(argv)
