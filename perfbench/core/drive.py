"""What every driver (``drivers/<kind>.py``) shares: the measured window,
the context per-layer metrics read, the weights and inputs drawn from the
seed, the port's configuration object, the reference's eval metrics, and
the comparison that decides ``correct``.

A driver's ``drive`` returns an :class:`Outcome`; the numbers compared are
``(name, value, limit)``, the limits the mix's ``limits``.
"""

from __future__ import annotations

import gc
import json
import math
import pathlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.core import phantom, work
from perfbench.core.trace import Trace


@dataclass
class Context:
    """What a per-layer metric reads (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    trace: Trace | None = None
    spans: dict = field(default_factory=dict)  # name -> list of host seconds
    counts: dict = field(default_factory=dict)
    work = work


@dataclass
class Outcome:
    end_to_end: dict
    correct: bool
    attempted: int
    failed: int
    checks: list
    context: Context
    first_unit: float  # wall clock of the first timed unit's start
    memory_peak_bytes: int = 0
    numbers: dict = field(default_factory=dict)  # every number worked out, compared or not


class Stop(Exception):
    """Raised from the trainer's progress hook to end a run of epochs."""


class Window:
    """The measured window. :meth:`unit` marks the end of each unit of work
    with a running count (steps, sweeps, requests); with a profiler the
    first ``trace_units`` units are traced, and the time its stop takes is
    left out of the window (``paused``)."""

    def __init__(self, seconds: float, prof, trace_units: int, ctx: Context):
        self.seconds, self.prof, self.trace_units, self.ctx = seconds, prof, trace_units, ctx
        self.marks: list = []  # (host seconds less pauses, count, traced)
        self.paused = 0.0
        self.traced = prof is not None
        self.stopped_now = False

    def begin(self, count: int = 0) -> None:
        self.first_unit = time.time()
        self.count0 = count
        self.t0 = time.perf_counter()
        if self.prof:
            self.prof.open()

    def unit(self, count: int) -> bool:
        """Mark a unit's end; True once the window has run its seconds."""
        now = time.perf_counter()
        self.marks.append((now - self.paused, count, self.traced))
        self.stopped_now = False
        if self.traced and len(self.marks) >= self.trace_units:
            self.ctx.trace = self.prof.stop(len(self.marks))
            self.traced, self.stopped_now = False, True
            self.paused += time.perf_counter() - now
        return now - self.t0 - self.paused >= self.seconds

    def finish(self) -> None:
        if self.traced:
            self.ctx.trace = self.prof.stop(len(self.marks))
            self.traced = False
        ends = [m[0] for m in self.marks]
        self.ctx.spans["unit_s"] = [b - a for a, b in zip([self.t0] + ends, ends)]

    @property
    def elapsed(self) -> float:
        return self.marks[-1][0] - self.t0

    @property
    def done(self) -> int:
        return self.marks[-1][1] - self.count0

    def untraced(self) -> tuple[int, float]:
        """(count, seconds) of the units after the traced ones."""
        traced = [m for m in self.marks if m[2]]
        t, c = (traced[-1][0], traced[-1][1]) if traced else (self.t0, self.count0)
        return self.marks[-1][1] - c, self.marks[-1][0] - t


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0


def release_memory(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def gap(prog: float, ref: float, floor: float = 0.0) -> float:
    return abs(prog - ref) / max(abs(ref), floor, 1e-30)


# ---------------------------------------------------------------- inputs
def make_weights(named_shapes: list[tuple[str, tuple]], model_cfg: dict, seed: int,
                 device) -> dict:
    """Float32 weights for every parameter, drawn on the device in two calls:
    SIREN layers (``net.*``) ``U(-s, s)``, ``s = 1 / fan_in`` for the first
    layer and ``sqrt(6 / fan_in) / w0`` after it (weights and biases); every
    other weight normal with std ``sqrt(1 / fan_in)`` cut at two std, every
    other bias zero."""
    gen = phantom.generator(seed * 2 + 1, device)
    total = sum(math.prod(s) for _, s in named_shapes)
    uni = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    fan = {}
    for name, shape in named_shapes:
        if name.endswith("weight"):
            fan[name.rsplit(".", 1)[0]] = math.prod(shape[1:])
    out, off = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        layer = name.rsplit(".", 1)[0]
        if name.startswith("net."):
            first = layer == "net.layers.0"
            s = 1.0 / fan[layer] if first else math.sqrt(6.0 / fan[layer]) / model_cfg["w0"]
            out[name] = (uni[off : off + n] * s).reshape(shape)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = (nrm[off : off + n] * math.sqrt(1.0 / fan[layer])).reshape(shape)
        off += n
    return out


def load_weights(model, weights: dict) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])


def stems(seed: int, count: int) -> list[str]:
    return [f"file_brain_AXFLAIR_{seed % 1_000_003:07d}{i:04d}" for i in range(count)]


def kspace_host(traffic: dict, count: int, seed: int, device) -> np.ndarray:
    """(count, slices, size, size) complex64 phantom k-space, made on the
    device and copied to the host once."""
    gen = phantom.generator(seed, device)
    k = phantom.volumes(count, traffic["slices"], traffic["size"], gen,
                        texture=traffic.get("texture", 0.0), phase=traffic.get("phase", False))
    host = k.cpu().numpy()
    del k
    return host


def port_config(config: dict, seed: int, tmp: pathlib.Path | None, *, test: bool = False):
    """The port's configuration object: the file's ``port`` sections as
    ``--set`` overrides over the port's defaults, ``training.seed`` from the
    run's seed."""
    from mri_inr_tpu_torch.configuration import config as config_lib
    sets = []
    for section, values in config["port"].items():
        if (section == "eval") != test and section != "model":
            continue
        for k, v in values.items():
            target = "data" if section == "eval" else section
            sets.append(f"{target}.{k}={json.dumps(v)}")
    if test:
        return config_lib.load_test_configuration(None, sets)
    sets.append(f"training.seed={seed % 2**31}")
    sets.append(f"training.output_dir={tmp}")
    return config_lib.load_train_configuration(None, sets)


def fwd_kwargs(config: dict, mode: str) -> dict:
    m = config["model"]
    return dict(layers=m["num_layers"], residual=m["residual"], w0=m["w0"],
                w0_initial=m["w0_initial"], siren=m["siren_patch_size"],
                sines=tuple(config["sines"][mode]), cosine_grad=config["sine_grad"] == "cosine",
                first_in_compute_type=config["first_layer"] == "compute_type")


def reference_images(k: np.ndarray, mask: np.ndarray | None, device) -> torch.Tensor:
    """One volume's (S, H, W) normalised magnitude images, masked or not."""
    from perfbench.reference import data as ref
    kt = torch.from_numpy(np.ascontiguousarray(k)).to(device)
    if mask is not None:
        kt = kt * torch.from_numpy(mask.astype(np.float32)).to(device)[None, None, :]
    return ref.minmax(ref.magnitude(kt))


@torch.no_grad()
def reference_metrics(params: dict, config: dict, fully: torch.Tensor, under: torch.Tensor,
                      *, block: int, quant: bool = False) -> torch.Tensor:
    """(K, H, W) image pairs -> (3, K) PSNR / SSIM / NRMSE of the reference
    reconstruction: tiles of ``under``, the eval forward in blocks of rows,
    black patches zeroed, the weighted fold."""
    from perfbench.reference import data as ref
    from perfbench.reference import model as ref_model
    m = config["model"]
    kk, h, w = under.shape
    patches = ref.tiles(under, m["outer_patch_size"], m["inner_patch_size"])
    valid = ref.valid_patches(patches)
    flat = patches.reshape(-1, m["outer_patch_size"], m["outer_patch_size"])
    outs = []
    with ref_model.exact_float32():
        for r0 in range(0, flat.shape[0], block):
            outs.append(ref_model.forward(params, flat[r0 : r0 + block], quant=quant,
                                          **fwd_kwargs(config, "eval")))
    pred = torch.cat(outs).reshape(kk, -1, m["siren_patch_size"], m["siren_patch_size"])
    pred = pred * valid[..., None, None]
    grid = ref.grid_of(h, w, m["inner_patch_size"])
    recon = ref.weighted_fold(pred, grid, m["inner_patch_size"])
    return ref.image_metrics(fully, recon)


def metric_numbers(prog: np.ndarray, refm: np.ndarray) -> dict:
    """(3, K) program rows against the reference's: the widest PSNR gap in
    dB, SSIM gap, and NRMSE gap relative to the reference's."""
    prog, refm = np.asarray(prog, np.float64), np.asarray(refm, np.float64)
    return {"psnr_gap_db": float(np.max(np.abs(prog[0] - refm[0]))),
            "ssim_gap": float(np.max(np.abs(prog[1] - refm[1]))),
            "nrmse_rel_gap": float(np.max(np.abs(prog[2] - refm[2]) / np.abs(refm[2])))}


def compare(numbers: dict, limits: dict) -> list:
    """``(name, value, limit)`` of each number the mix gives a limit, in the
    mix's order; the other numbers are readings only."""
    return [(name, numbers[name], limit) for name, limit in limits.items()]


def passes(checks: list) -> bool:
    return all(np.isfinite(v) and v <= lim for _, v, lim in checks)


def param_shapes(config: dict) -> list:
    """The parameters' names and shapes of the configuration's model, as the
    port names them (what the weights drawn from the seed are shaped by)."""
    from mri_inr_tpu_torch.models import modulated_siren as ms
    c = port_config(config, 0, None, test=True)
    model = ms.from_config(c.model, device="cpu")
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def reconstructor(config: dict, seed: int, device):
    """The port's ``SliceReconstructor`` over the eval forward of the
    configuration's model, its weights drawn from ``seed``: (reconstructor,
    weights)."""
    from mri_inr_tpu_torch.eval import evaluate as ev
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.ops.siren_kernel import make_apply_fn
    cfg = port_config(config, seed, None, test=True)
    mcfg, ecfg = cfg.model, cfg.data
    model = ms.from_config(mcfg, config["port"]["training"]["precision"], device=device)
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    weights = make_weights(named, config["model"], seed, device)
    load_weights(model, weights)
    recon = ev.SliceReconstructor(
        make_apply_fn(model, use_pallas=mcfg.use_pallas, sin_bf16=ecfg.sin_bf16, sin5=ecfg.sin5,
                      ksplit=ecfg.ksplit, quantized=ecfg.quantized, device=device),
        outer_patch_size=mcfg.outer_patch_size, inner_patch_size=mcfg.inner_patch_size,
        siren_patch_size=mcfg.siren_patch_size, patch_bucket=ecfg.batch_patches, device=device)
    return recon, weights
