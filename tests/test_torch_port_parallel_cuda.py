"""Data parallelism on the card: two ranks sharing one card (``cuda:0``
named for both, so gloo, the bands and gradients crossing the host),
started by ``tests/torch_port_ranks.py``. Skips without a card; imports no
JAX:

    python -m pytest --noconftest tests/test_torch_port_parallel_cuda.py -q

- the sharded fused train step (both CUDA train kernels on each rank's
  local batch) keeps the ranks on one model, equals Adam on the mean of
  the two ranks' local steps emulated here with the rank seeds (1e-6), and
  without dropout the one-process step (loss 1e-4 relative, parameters
  1e-5); each rank's launch counters count its own steps;
- the sharded eval step, one eval-kernel launch a rank;
- the halo fold on the card against the one-process fold (1e-6), and a
  halo-mode reconstructor whose ranks each launch the eval kernel once, on
  a band of patch rows (a batch that is a multiple of ``nh`` and not of the
  kernel's tile), within 1e-6 of the one-process slice.
"""

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from mri_inr_tpu_torch.eval.evaluate import SliceReconstructor
from mri_inr_tpu_torch.ops import siren_kernel as sk
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.train import losses, trainer

pytestmark = pytest.mark.cuda

CARD = "cuda:0"


@pytest.fixture(scope="module")
def card():
    """cuda:0, with TF32 off in cuBLAS and cuDNN while this module runs, as
    the ranks run (``torch_port_ranks.main``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device(CARD)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.fixture(scope="module")
def steps(card, tmp_path_factory):
    return ranks.run_scenario("steps", 2, tmp_path_factory.mktemp("steps"), CARD, timeout=600)


@pytest.fixture(scope="module")
def halo(card, tmp_path_factory):
    return ranks.run_scenario("halo", 2, tmp_path_factory.mktemp("halo"), CARD, timeout=600)


def _batch(card):
    return tuple(torch.from_numpy(a).to(card) for a in ranks.global_batch())


@pytest.mark.parametrize("case", list(ranks.STEP_CASES))
def test_ranks_hold_one_model_and_count_their_own_launches(steps, case):
    n = ranks.STEP_CASES[case][4]
    fused = ranks.STEP_CASES[case][1]
    for r in range(2):
        np.testing.assert_array_equal(steps[r][f"{case}_params"], steps[0][f"{case}_params"])
        assert list(steps[r][f"{case}_launches"]) == ([n, n] if fused else [0, 0])
    assert [int(s["eval_launches"]) for s in steps] == [1, 1]


@pytest.mark.parametrize("case", ["dropout1", "dropout_sgd1"])
def test_dropout_step_is_the_mean_of_the_local_steps(steps, card, case):
    want, _ = ranks.emulate_step(case, card, 2)
    np.testing.assert_allclose(steps[0][f"{case}_params"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["sgd3", "sgd1", "module2"])
def test_sharded_step_matches_one_process_without_dropout(steps, card, case):
    dropout, fused, opt, lr, n = ranks.STEP_CASES[case]
    model = ranks.small_model(dropout, card)
    state = trainer.create_train_state(model, opt, lr)
    step = trainer.make_train_step(model, losses.mse, 32, 24, use_pallas=fused,
                                   sin5=case != "sgd1")
    fully, under = _batch(card)
    want = [float(step(state, fully, under, ranks.BASE_SEED)) for _ in range(n)]
    np.testing.assert_allclose(steps[0][f"{case}_loss"], want, rtol=1e-4)
    np.testing.assert_allclose(steps[0][f"{case}_params"], ranks.flat_params(model), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("nv,nh", ranks.HALO_CASES)
def test_halo_fold_on_the_card(halo, card, nv, nh):
    patches = torch.from_numpy(ranks.halo_patches(nv, nh)).to(card)
    want = tiling.patches_to_image_weighted_average(patches, (nv, nh), ranks.SIREN,
                                                    ranks.INNER).cpu().numpy()
    for h in halo:
        np.testing.assert_allclose(h[f"image_{nv}x{nh}"], want, rtol=0, atol=1e-6)


def test_halo_reconstructor_runs_the_eval_kernel_on_each_band(halo, card):
    model = ranks.small_model(0.0, card)
    rec = SliceReconstructor(sk.make_apply_fn(model, use_pallas=True, sin5=True, device=card),
                             patch_bucket=16, device=card)
    fully, under = np.random.default_rng(7).uniform(size=(2, 128, 80)).astype(np.float32)
    recon, _, _, m = rec(fully, under)
    for h in halo:
        assert int(h["slice_launches"]) == 1  # 4 patch rows x 5 columns: B = 20 a rank
        np.testing.assert_allclose(h["slice_recon"], recon.cpu().numpy(), rtol=0, atol=1e-6)
