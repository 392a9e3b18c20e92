"""Operation and byte counts against hand counts at both configurations'
widths."""

import pytest

from perfbench.core import harness, work

SPEC = harness.load_spec()


def model(name):
    return next(harness.resolve(SPEC, w["name"]).config["model"]
                for w in SPEC["workloads"] if w["config"] == name)


def test_encoder_by_hand():
    # conv 3x3/2 1->16 on 32x32 -> 16x16; 3x3/2 16->32 -> 8x8; 8x8 valid 32->64 -> 1x1; dense
    hand = 2 * (16 * 16 * 16 * 9 + 8 * 8 * 32 * 16 * 9 + 64 * 32 * 64 + 64 * 256)
    assert work.encoder_flops(32, 256) == hand == 958_464


@pytest.mark.parametrize("name, per_patch", [
    # SIREN: 2*576*(2*256 + 4*256*256 + 256); modulator 2*(256*256 + 4*512*256); encoder
    ("flagship", 2 * 576 * (2 * 256 + 4 * 65536 + 256) + 2 * (65536 + 4 * 512 * 256) + 958_464),
    # 10 layers, latent 128: 2*576*(512 + 9*65536 + 256); 2*(128*256 + 9*384*256)
    ("residual", 2 * 576 * (512 + 9 * 65536 + 256) + 2 * (128 * 256 + 9 * 384 * 256)
     + 2 * (16 * 16 * 16 * 9 + 8 * 8 * 32 * 16 * 9 + 64 * 32 * 64 + 64 * 128)),
])
def test_model_forward_by_hand(name, per_patch):
    assert work.model_forward_flops(model(name)) == per_patch


def test_train_step_flops():
    # three forward passes' worth a patch, 400 patches a step: 3.66e11 (flagship)
    step = 3 * work.model_forward_flops(model("flagship")) * 400
    assert abs(step - 3.66e11) / 3.66e11 < 0.01


def test_backward_counts_the_gradient_products_only():
    b, s, h, l = 400, 576, 256, 5
    assert 2 * work.chain_products(b, s, h, l) == 4 * b * s * h * h * (l - 1) == 241_591_910_400
    bound, term = work.bound_seconds(2 * work.chain_products(b, s, h, l),
                                     work.chain_f32_ops(b, s, h, l, "train_bwd"),
                                     work.chain_bytes(b, s, h, l, grads=True))
    assert term == "bf16 tensor operations"
    assert abs(bound - 241_591_910_400 / 989e12) < 1e-12


def test_chain_bytes_by_hand():
    b, s, h, l = 400, 576, 256, 5
    ins = 4 + b * l * h * 4 + s * h * 4 + (l - 1) * h * h * 2 + (l - 1) * h * 4 + h * 4 + 4
    assert work.chain_bytes(b, s, h, l, grads=False) == ins + b * s * 4
    outs = b * l * h * 4 + s * h * 4 + (l - 1) * h * h * 4 + (l - 1) * h * 4 + h * 4 + 4
    assert work.chain_bytes(b, s, h, l, grads=True) == ins + b * s * 4 + outs


def test_threefry_bound_is_the_operation_term():
    numel = 400 * 576 * 256
    bound, term = work.bound_seconds(0, work.THREEFRY_OPS_PER_ELEMENT * numel, numel + 8)
    assert term == "f32 operations" and abs(bound - 85 * numel / 67e12) < 1e-12
