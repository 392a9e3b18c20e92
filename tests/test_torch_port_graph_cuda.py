"""The graphed training epoch (``train/trainer.py:make_scan_epoch`` on the
card: one CUDA graph replay an epoch) against the per-step loop, on the
card. Skips without one.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_port_graph_cuda.py -q

- The graphed run (device-resident tiles; its first epoch eager, then one
  replay a train and a validation epoch) against the per-step loop
  (batches from the host, one step at a time): two per-step runs show how
  far the loop repeats itself. Where they agree bit for bit, the graphed
  run must too; where they do not (a cuDNN convolution gradient that sums
  with atomics), the graphed run is held to twice their gap, since each of
  the three runs scatters around the same values.
- Adam on the card (``fused`` and ``capturable``, as ``make_optimizer``
  makes it, and the multi-tensor ``capturable`` one) against optax's update
  written out in float32
  (:func:`optax_adam_f32`, itself held to optax within 1e-7 on the CPU by
  tests/test_torch_port_trainer.py) within 1e-7, on the gradient sequence of
  ``test_optimizers_match_optax_on_one_gradient_sequence``.
- A checkpoint written by a graphed run resumes a per-step run, and the
  reverse, with Adam's ``step`` a device tensor.
- The launch counters, which a replay advances by what its capture
  recorded, against torch.profiler's count of the kernels by name.
- ``training.debug_nans`` with ``training.device_data`` on the card raises,
  and a restore of the optimizer's state drops the graphs.
"""

import numpy as np
import pytest
import torch

from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.data.dataset import MRIDataset
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.ops import siren_kernel as sk
from mri_inr_tpu_torch.ops import siren_train_kernel as stk
from mri_inr_tpu_torch.train import checkpoint as ckpt
from mri_inr_tpu_torch.train import losses
from mri_inr_tpu_torch.train import trainer as tr

pytestmark = pytest.mark.cuda

WIDTHS = dict(dim_hidden=64, latent_dim=32, num_layers=3)
BATCH = 32


def optax_adam_f32(p0: np.ndarray, grads, lr: float = 1e-3) -> np.ndarray:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8) applied to ``p0``
    over ``grads``, its operations written out in float32 numpy in optax's
    order (``scale_by_adam``, then ``-lr``, then ``apply_updates``)."""
    f = np.float32
    b1, b2, eps = f(0.9), f(0.999), f(1e-8)
    p, mu, nu = p0.astype(f), np.zeros_like(p0, f), np.zeros_like(p0, f)
    for t, g in enumerate(grads, 1):
        mu = (f(1) - b1) * g + b1 * mu
        nu = (f(1) - b2) * (g * g) + b2 * nu
        mu_hat = mu / (f(1) - b1 ** f(t))
        nu_hat = nu / (f(1) - b2 ** f(t))
        p = p + (-f(lr)) * (mu_hat / (np.sqrt(nu_hat) + eps))
    return p


def gradient_sequence():
    """The CPU test's: weights of a layer's size, 10 gradients of magnitudes
    1e-4 to 10."""
    rng = np.random.default_rng(0)
    p0 = rng.uniform(-0.5, 0.5, size=(7, 5)).astype(np.float32)
    grads = [(rng.normal(size=(7, 5)) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
             for _ in range(10)]
    return p0, grads


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    """Two 3-slice 64 x 64 phantom volumes, preprocessed on the CPU."""
    d = tmp_path_factory.mktemp("graph_data")
    rows = []
    for v in range(2):
        k = synthetic.synthetic_kspace(v, 3, 64, 64, texture=0.2)
        rows += preprocessing.process_kspace_volume(k, synthetic.synthetic_stem(v), d,
                                                    device="cpu")
    return preprocessing.write_metadata(rows, d)


@pytest.fixture(scope="module")
def datasets(metadata):
    # 6 slices of 16 patches: 3 train steps of 32; validation: 2 slices, 1 batch
    return MRIDataset(metadata, max_slice_num=10), MRIDataset(metadata, max_slice_num=0)


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()


def _trainer(datasets, run_dir, device, device_data, optimizer="adam"):
    model = ModulatedSiren(**WIDTHS, dropout=0.1, device=device,
                           generator=torch.Generator().manual_seed(0))
    return tr.Trainer(model, tr.create_train_state(model, optimizer, 1e-3), losses.mse,
                      *datasets, run_dir, batch_size=BATCH, save_interval=1000,
                      use_pallas=True, sin5=True, device_data=device_data, device=device,
                      log=lambda *_: None)


def _run(datasets, run_dir, device, device_data, epochs=4):
    t = _trainer(datasets, run_dir, device, device_data)
    t.initial_errors()
    t.train(epochs)
    curve = [t.initial_losses[0], t.initial_losses[1]] + [
        r[k] for r in t._progress for k in ("train_loss", "val_loss")]
    return np.array(curve), _flat(t.model), t


def test_graphed_epochs_equal_the_per_step_loop_to_its_repeatability(datasets, tmp_path,
                                                                     device):
    la, pa, _ = _run(datasets, tmp_path / "a", device, False)
    lb, pb, _ = _run(datasets, tmp_path / "b", device, False)
    lc, pc, t = _run(datasets, tmp_path / "c", device, True)
    # epoch 0 eager, epochs 1-3 replayed; validation replayed from epoch 0 on
    # (its first epoch, the initial loss, ran eagerly)
    assert (t.scan_epoch.captures, t.scan_epoch.replays) == (2, 3 + 4)
    assert t.state.step == 4 * 3
    spread = (np.abs(la - lb).max(), (pa - pb).abs().max().item())
    gap = (np.abs(lc - la).max(), (pc - pa).abs().max().item())
    print(f"per-step runs apart: loss {spread[0]:.3e}, parameters {spread[1]:.3e}; "
          f"graphed from per-step: loss {gap[0]:.3e}, parameters {gap[1]:.3e}")
    if spread == (0.0, 0.0):
        assert np.array_equal(lc, la) and torch.equal(pc, pa)
    else:
        assert gap[0] <= 2 * spread[0] and gap[1] <= 2 * spread[1]
    assert lc[-2] < lc[0]  # the loss fell


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "foreach"])
def test_adam_on_the_card_follows_optax(device, fused):
    p0, grads = gradient_sequence()
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(device))
    if fused:
        opt = tr.make_optimizer("adam", 1e-3, [tp])
        assert opt.defaults["fused"] and opt.defaults["capturable"]
    else:
        opt = torch.optim.Adam([tp], lr=1e-3, capturable=True)
    version = tp._version
    for g in grads:
        tp.grad = torch.from_numpy(g.copy()).to(device)
        opt.step()
    print(f"{'fused' if fused else 'multi-tensor'} Adam moves the parameter's _version: "
          f"{tp._version != version}")
    assert opt.state[tp]["step"].is_cuda
    np.testing.assert_allclose(tp.detach().cpu().numpy(), optax_adam_f32(p0, grads), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("first,second", [(True, False), (False, True)],
                         ids=["graphed-then-per-step", "per-step-then-graphed"])
def test_checkpoint_round_trip_between_graphed_and_per_step_runs(datasets, tmp_path, device,
                                                                 first, second):
    """Two epochs of one kind, a checkpoint, then two epochs of the other
    kind from it: the parameters and the last losses of four straight
    per-step epochs, to the repeatability of the per-step loop (as above)."""
    a = _trainer(datasets, tmp_path / "a", device, first)
    a.train(2)
    assert a.state.optimizer.state_dict()["state"][0]["step"].is_cuda
    b = _trainer(datasets, tmp_path / "b", device, second)
    ckpt.restore_state(tmp_path / "a", a.state.step, b.state)
    assert b.state.step == 6 and b.state.optimizer.state[next(b.model.parameters())][
        "step"].is_cuda
    b.train(4, initial_epoch=2)
    _, p_ref, _ = _run(datasets, tmp_path / "r1", device, False)
    _, p_ref2, _ = _run(datasets, tmp_path / "r2", device, False)
    spread = (p_ref - p_ref2).abs().max().item()
    gap = (_flat(b.model) - p_ref).abs().max().item()
    print(f"resumed from per-step: parameters {gap:.3e} (per-step runs apart {spread:.3e})")
    assert gap <= 2 * spread if spread else gap == 0.0
    if second:  # the resumed graphed run replayed its second epoch
        assert b.scan_epoch.replays >= 1


def test_launch_counters_match_the_profiler(datasets, tmp_path, device):
    """One replayed train epoch: the counters grow by what the capture
    recorded, and torch.profiler sees that many of the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    t = _trainer(datasets, tmp_path / "run", device, True)
    train = datasets[0]
    for e in range(2):  # eager, then captured and replayed
        t._epoch_loss(train, train=True, epoch=e)
    kernels = (stk.siren_chain_train_fwd_cuda, stk.siren_chain_train_bwd_cuda)
    before = [k.launches for k in kernels]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t._epoch_loss(train, train=True, epoch=2)
        torch.cuda.synchronize()
    counted = [k.launches - b for k, b in zip(kernels, before)]
    seen = {"fwd": 0, "bwd": 0}
    for e in prof.key_averages():
        if "TrainEpilogue" in e.key:
            seen["fwd"] += e.count
        elif "chain_kernel" in e.key:
            seen["bwd"] += e.count
    assert counted == [3, 3]
    assert [seen["fwd"], seen["bwd"]] == counted
    assert t.scan_epoch.replays == 2


def test_debug_nans_with_device_data_on_the_card_raises(metadata, tmp_path, device):
    argv = ["--config", "configs/train.yaml"]
    for s in (f"data.train.dataset={metadata}", f"data.val.dataset={metadata}",
              "training.device_data=true", "training.debug_nans=true", "training.epochs=1",
              f"training.output_dir={tmp_path}"):
        argv += ["--set", s]
    with pytest.raises(ValueError, match="training.debug_nans.*training.device_data"):
        cli_train.main(argv)


def test_a_restored_optimizer_state_drops_the_graphs(datasets, tmp_path, device):
    t = _trainer(datasets, tmp_path / "run", device, True)
    train = datasets[0]
    for e in range(2):
        t._epoch_loss(train, train=True, epoch=e)
    assert (t.scan_epoch.captures, t.scan_epoch.replays) == (1, 1)
    ckpt.save_state(tmp_path / "run", t.state.step, t.state)
    ckpt.restore_state(tmp_path / "run", t.state.step, t.state)  # new Adam state tensors
    t._epoch_loss(train, train=True, epoch=2)  # eager again
    t._epoch_loss(train, train=True, epoch=3)  # captured anew, replayed
    assert (t.scan_epoch.captures, t.scan_epoch.replays) == (2, 2)
    assert t.state.step == 12
    packs = t.eval_step.apply_fn.pack.packs
    t._epoch_loss(datasets[1], train=False, epoch=0)
    t.eval_step(t.state, *(torch.from_numpy(a).to(device)
                           for a in next(datasets[1].batches(BATCH, seed=0))))
    assert t.eval_step.apply_fn.pack.packs == packs + 1  # repacked after the replay
    assert sk.siren_forward_cuda.launches > 0
