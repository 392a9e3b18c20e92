"""Three training steps of the reference: mean squared error of the model's
24x24 output against the centre of the fully sampled patch, Adam (lr, betas
0.9 / 0.999, eps 1e-8, bias-corrected), in float32, a batch at a time in
blocks of rows so that the activations fit beside what is left on the card.

Dropout (``rate`` 0.1) is drawn as the configuration's route draws it:

- ``hash`` (the fused route): element ``idx = (b * S + s) * H + col`` of
  hidden layer ``l`` is kept where the int32 ``h = m ^ (m >>> 16)``, ``m =
  (idx + seed + l * 1315423911) * 0x9E3779B1`` mod 2^32, lies below
  ``round(keep * 2^32 - 2^31)``; a kept value is scaled by float32(1 / keep).
  Step ``s``'s seed is ``randint(fold_in(key(base), s), 0, 2^23)``.
- ``flax`` (the module route): hidden layer ``i`` keeps element ``n`` of the
  flat (B, S, H) mask where ``uniform < keep`` under ``fold_in(fold_in(
  key(base), s), static("net", "layer_i", "Dropout_0", 1))``; a kept value
  is scaled by float32(1) / keep rounded to the compute type.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model, threefry

_HASH_M, _LAYER_STRIDE = 0x9E3779B1, 1315423911
_M32 = 0xFFFFFFFF


def hash_drop(seed: int, keep: float, row0: int, seq: int, hidden: int):
    thresh = int(round(keep * 2.0**32 - 2.0**31))
    inv = float(np.float32(1.0 / keep))

    def drop(x: torch.Tensor, layer: int) -> torch.Tensor:
        b = x.shape[0]
        idx = torch.arange(row0 * seq * hidden, (row0 + b) * seq * hidden, dtype=torch.int64,
                           device=x.device)
        m = (((idx + seed + layer * _LAYER_STRIDE) & _M32) * _HASH_M) & _M32
        h = m ^ (m >> 16)
        h = torch.where(h >= 2**31, h - 2**32, h)
        return x * torch.where(h < thresh, inv, 0.0).reshape(b, seq, hidden)

    return drop


def flax_drop(step_key: np.ndarray, keep: float, scale: float, row0: int, rows: int,
              seq: int, hidden: int, layers: int, device):
    masks = {}
    for i in range(layers):
        k = threefry.fold_in(step_key, threefry.flax_static("net", f"layer_{i}", "Dropout_0", 1))
        bits = threefry.bits_torch(k, rows * seq * hidden, row0 * seq * hidden, device)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        masks[i] = (floats < float(np.float32(keep))).reshape(rows, seq, hidden)

    def drop(x: torch.Tensor, layer: int) -> torch.Tensor:
        return torch.where(masks[layer], x * scale, 0.0)

    return drop


def step_drops(route: str, base_seed: int, step: int, keep: float, scale: float, seq: int,
               hidden: int, layers: int, device):
    """``make(row0, rows) -> drop`` for train step ``step``."""
    step_key = threefry.fold_in(threefry.key(base_seed), step)
    if route == "hash":
        seed = int(threefry.randint(step_key, 0, 2**23))
        return lambda row0, rows: hash_drop(seed, keep, row0, seq, hidden)
    return lambda row0, rows: flax_drop(step_key, keep, scale, row0, rows, seq, hidden,
                                        layers, device)


def three_steps(params: dict, batches: list, drops: list, *, lr: float, block: int,
                quant: bool = False, **fwd) -> dict:
    """``batches``: (under, target) pairs of (B, 32, 32) and (B, 24, 24);
    ``drops``: per step, :func:`step_drops`'s ``make``. Returns each step's
    loss, the first step's gradient per leaf (on the host) and its norm, and
    each leaf's change norm after the last step."""
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad0, grad0_t = [], None, None
    with model.exact_float32():
        for t, ((under, target), make) in enumerate(zip(batches, drops), start=1):
            n = under.shape[0]
            for g in p.values():
                g.grad = None
            total = 0.0
            for r0 in range(0, n, block):
                r1 = min(n, r0 + block)
                pred = model.forward(p, under[r0:r1], drop=make(r0, r1 - r0), quant=quant,
                                     **fwd)
                part = torch.sum((pred - target[r0:r1].float()) ** 2) / (n * target[0].numel())
                part.backward()
                total += float(part.detach())
            losses.append(total)
            grads = {k: v.grad.detach() for k, v in p.items()}
            if grad0 is None:
                grad0_t = {k: g.double().cpu() for k, g in grads.items()}
                grad0 = {k: float(g.norm()) for k, g in grad0_t.items()}
            with torch.no_grad():
                for k, w in p.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1**t)
                    vhat = v2[k] / (1 - b2**t)
                    w.sub_(lr * mhat / (vhat.sqrt() + eps))
    change = {k: float((p[k].detach() - start[k]).double().norm()) for k in p}
    return {"losses": losses, "grad0": grad0, "grad0_t": grad0_t, "change": change}
