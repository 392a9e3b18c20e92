"""The online k-space pipeline and the module path's graphed epoch on the
card. Skips without one. Imports no JAX and needs no ``h5py`` (the volumes
come in memory through ``OnlineKspaceDataset.from_volumes``):

    python -m pytest --noconftest tests/test_torch_port_online_cuda.py -q

- Materialisation on the card (the DFT kernel, one launch per
  materialisation over every slice of every volume) against the CPU's
  plain route (``torch.fft``) within 2e-5, the preprocessing bar.
- Remask training through the graphed epoch: one capture per (dataset,
  mode) across three epochs whose undersampled tiles change, because the
  tiles are rewritten in place; the losses and parameters equal a per-step
  run over host batches of the same tiles to the per-step loop's own
  repeatability.
- The module path (``use_pallas: false``, and a residual model) graphed
  against its per-step loop, held the same way; its hash masks on the card
  equal the CPU's bit for bit.
"""

import numpy as np
import pytest
import torch

from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.data.dataset import MRIDataset
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.ops import fft_kernel
from mri_inr_tpu_torch.train import losses
from mri_inr_tpu_torch.train import trainer as tr

pytestmark = pytest.mark.cuda

WIDTHS = dict(dim_hidden=64, latent_dim=32, num_layers=3)
BATCH = 32
BAR = 2e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def volumes():
    """Three 4-slice 64 x 64 phantom volumes' k-space."""
    stems = [synthetic.synthetic_stem(v) for v in range(3)]
    return stems, [synthetic.synthetic_kspace(v, 4, 64, 64, texture=0.2) for v in range(3)]


def _online(volumes, device, **kw):
    stems, vols = volumes
    return OnlineKspaceDataset.from_volumes(stems, vols, device=device, **kw)


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()


def test_materialisation_on_the_card_matches_the_cpu(volumes, device):
    card = _online(volumes, device, remask_each_epoch=True, max_slice_num=2)
    cpu = _online(volumes, "cpu", remask_each_epoch=True, max_slice_num=2)
    before = fft_kernel.dft2c_ri_cuda.launches
    for epoch in (0, 1):
        for got, want in zip(card.materialize(epoch), cpu.materialize(epoch)):
            assert got.is_cuda
            gap = (got.cpu() - want).abs().max().item()
            print(f"epoch {epoch}: card vs cpu tiles {gap:.3e}")
            assert gap <= BAR
    fully, under = card.device_image_stacks()
    cfully, cunder = cpu.device_image_stacks()
    assert (fully.cpu() - cfully).abs().max().item() <= BAR
    assert (under.cpu() - cunder).abs().max().item() <= BAR
    # fully once, under for epochs 0 and 1, the epoch-0 under images once
    assert fft_kernel.dft2c_ri_cuda.launches - before == 4


def _trainer(train, val, run_dir, device, device_data, use_pallas=True, **model_kw):
    model = ModulatedSiren(**WIDTHS, dropout=0.1, device=device,
                           generator=torch.Generator().manual_seed(0), **model_kw)
    return tr.Trainer(model, tr.create_train_state(model, "adam", 1e-3), losses.mse, train,
                      val, run_dir, batch_size=BATCH, save_interval=1000,
                      use_pallas=use_pallas, sin5=True,
                      device_data=device_data, device=device, log=lambda *_: None)


def _run(make_data, run_dir, device, device_data, epochs=3, **kw):
    t = _trainer(*make_data(), run_dir, device, device_data, **kw)
    t.initial_errors()
    t.train(epochs)
    curve = list(t.initial_losses) + [r[k] for r in t._progress
                                      for k in ("train_loss", "val_loss")]
    return np.array(curve), _flat(t.model), t


def _held(runs):
    """Graphed against per-step, to the per-step loop's repeatability."""
    (la, pa, _), (lb, pb, _), (lc, pc, _) = runs
    spread = (np.abs(la - lb).max(), (pa - pb).abs().max().item())
    gap = (np.abs(lc - la).max(), (pc - pa).abs().max().item())
    print(f"per-step runs apart {spread}, graphed from per-step {gap}")
    if spread == (0.0, 0.0):
        assert np.array_equal(lc, la) and torch.equal(pc, pa)
    else:
        assert gap[0] <= 2 * spread[0] and gap[1] <= 2 * spread[1]


def test_remask_training_is_one_capture_per_dataset_and_mode(volumes, tmp_path, device):
    def data():
        return (_online(volumes, device, remask_each_epoch=True),
                _online(volumes, device, remask_each_epoch=False, num_samples=2))

    runs = [_run(data, tmp_path / name, device, dd)
            for name, dd in (("a", False), ("b", False), ("c", True))]
    t = runs[2][2]
    # train: epoch 0 eager, epoch 1 captured and replayed, epoch 2 replayed;
    # validation: eager at the initial losses, then replayed every epoch
    assert (t.scan_epoch.captures, t.scan_epoch.replays) == (2, 2 + 3)
    _held(runs)
    assert runs[2][0][-2] < runs[2][0][0]  # the loss fell


@pytest.mark.parametrize("seed,layer", [(0, 0), (2**23 - 1, 2), (4242, 4)])
def test_hash_masks_on_the_card_equal_the_cpus(device, seed, layer):
    """The module path's masks (``dropout_mask``, int32 arithmetic that
    wraps) at a train step's shape, on the card and on the CPU."""
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk

    shape = (400, 576, 256)
    got = stk.dropout_mask(torch.tensor([float(seed)], device=device), layer, 0.9, shape)
    want = stk.dropout_mask(torch.tensor([float(seed)]), layer, 0.9, shape)
    assert torch.equal(got.cpu(), want)


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    d = tmp_path_factory.mktemp("module_graph")
    rows = []
    for v in range(2):
        k = synthetic.synthetic_kspace(v, 3, 64, 64, texture=0.2)
        rows += preprocessing.process_kspace_volume(k, synthetic.synthetic_stem(v), d,
                                                    device="cpu")
    meta = preprocessing.write_metadata(rows, d)
    return MRIDataset(meta, max_slice_num=10), MRIDataset(meta, max_slice_num=0)


@pytest.mark.parametrize("kw", [dict(use_pallas=False), dict(residual=True)],
                         ids=["module", "residual"])
def test_module_path_graph_equals_its_per_step_loop(offline, tmp_path, device, kw):
    runs = [_run(lambda: offline, tmp_path / name, device, dd, epochs=4, **kw)
            for name, dd in (("a", False), ("b", False), ("c", True))]
    t = runs[2][2]
    assert not t.scan_epoch.fused
    assert (t.scan_epoch.captures, t.scan_epoch.replays) == (2, 3 + 4)
    _held(runs)
