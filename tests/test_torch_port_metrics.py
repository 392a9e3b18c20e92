"""The port's PSNR / SSIM / NRMSE against the JAX package's (1e-6) and
against the skimage pipeline rebuilt on scipy in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

from mri_inr_tpu.eval import metrics as jm
from mri_inr_tpu_torch.eval import metrics as tm

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)


def _pairs():
    rng = np.random.default_rng(7)
    gt = rng.uniform(size=(96, 80)).astype(np.float32)
    yield "noisy", gt, (gt + 0.05 * rng.normal(size=gt.shape)).astype(np.float32)
    yield "contrast", gt, (0.9 * gt + 0.02).astype(np.float32)
    yy, xx = np.mgrid[0:320, 0:320]
    smooth = (0.5 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 13.0)).astype(np.float32)
    yield "slice", smooth, (smooth + 0.01 * rng.normal(size=smooth.shape)).astype(np.float32)


PAIRS = list(_pairs())


@pytest.mark.parametrize("name,gt,pred", PAIRS, ids=[p[0] for p in PAIRS])
def test_metrics_match_jax(name, gt, pred):
    want = jm.image_metrics(jnp.asarray(gt), jnp.asarray(pred))
    got = tm.image_metrics(torch.from_numpy(gt), torch.from_numpy(pred))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    dr = float(tm.joint_data_range(torch.from_numpy(gt), torch.from_numpy(pred)))
    assert dr == pytest.approx(float(jm.joint_data_range(jnp.asarray(gt), jnp.asarray(pred))))


def test_ssim_matches_skimage_pipeline():
    _, gt, pred = PAIRS[0]
    dr = max(gt.max(), pred.max()) - min(gt.min(), pred.min())
    x, y = gt.astype(np.float64), pred.astype(np.float64)
    u = lambda a: uniform_filter(a, size=7)
    ux, uy = u(x), u(y)
    vx = 49 / 48 * (u(x * x) - ux * ux)
    vy = 49 / 48 * (u(y * y) - uy * uy)
    vxy = 49 / 48 * (u(x * y) - ux * uy)
    c1, c2 = (0.01 * dr) ** 2, (0.03 * dr) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    want = s[3:-3, 3:-3].mean()
    got = float(tm.ssim(torch.from_numpy(gt), torch.from_numpy(pred)))
    assert got == pytest.approx(want, abs=1e-5)


def test_identical_images():
    img = torch.from_numpy(PAIRS[0][1])
    m = tm.image_metrics(img, img)
    assert float(m["ssim"]) == pytest.approx(1.0, abs=1e-6)
    assert float(m["nrmse"]) == 0.0
    assert torch.isinf(m["psnr"])
