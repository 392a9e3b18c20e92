"""The ``sweep`` kind: repeated device sweeps (``eval/evaluate.py:
evaluate_files_device``) of an ``OnlineSampler`` over the mix's volumes
under fixed masks; a sample of the scored rows, drawn from the seed, is
compared.

A mix of this kind gives ``volumes``, ``slices``, ``size``,
``acceleration``, ``center_fraction``, ``texture``, ``phase``,
``warmup_units``, ``trace_units``, ``check_sample``, ``ref_block`` and
``limits``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core.drive import (Context, Outcome, Window, compare, kspace_host, make_weights,
                                  memory_peak, metric_numbers, param_shapes, passes,
                                  reconstructor, reference_images, reference_metrics,
                                  release_memory, stems, sync)
from perfbench.core.trace import Profiler


def drive(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
          device: torch.device, fault=None) -> Outcome:
    from mri_inr_tpu_torch.data.online import OnlineKspaceDataset, OnlineSampler
    from mri_inr_tpu_torch.eval import evaluate as ev

    nv = traffic["volumes"]
    k = kspace_host(traffic, nv, seed, device)
    names = stems(seed, nv)
    m = config["model"]
    ds = OnlineKspaceDataset.from_volumes(
        names, list(k), center_fraction=traffic["center_fraction"],
        acceleration=traffic["acceleration"], max_slice_num=None, remask_each_epoch=False,
        outer_patch_size=m["outer_patch_size"], inner_patch_size=m["inner_patch_size"],
        device=device)
    sampler = OnlineSampler(ds, host_prefetch=False)
    recon, weights = reconstructor(config, seed, device)
    if fault is not None:
        fault(recon)
    quiet = lambda *_: None
    ctx = Context(config, traffic)
    prof = Profiler(device) if trace else None
    for i in range(traffic["warmup_units"] + bool(prof)):
        if prof and i == traffic["warmup_units"]:  # the tracer starts up over one more sweep
            prof.start()
        ev.evaluate_files_device(recon, sampler, log=quiet)
    sync(device)

    win = Window(seconds, prof, traffic["trace_units"], ctx)
    sweeps, dispatch = [], []
    win.begin()
    while True:
        results, timings = ev.evaluate_files_device(recon, sampler, log=quiet)
        sweeps.append(results)
        dispatch.append(timings["dispatch_seconds"])
        if win.unit(len(sweeps)):
            break
    win.finish()
    per_sweep = len(sweeps[0])
    peak = memory_peak(device)
    units, secs = win.untraced()
    ctx.counts.update(slices_per_unit=per_sweep, units_untraced=units, seconds_untraced=secs,
                      patches_per_slice=ds.patches_per_slice)
    ctx.spans["sweep_dispatch_s"] = dispatch
    slice_ids = {ds.slice_id(i): ds.slice_ids[i] for i in range(len(ds.slice_ids))}
    del ds, sampler, recon
    release_memory(device)

    rng = np.random.default_rng(seed)
    picks = [(int(rng.integers(len(sweeps))), int(rng.integers(per_sweep)))
             for _ in range(traffic["check_sample"])]
    rows = [sweeps[s][r] for s, r in picks]
    prog = np.array([[r.psnr for r in rows], [r.ssim for r in rows], [r.nrmse for r in rows]])
    refm = reference_eval_rows(config, traffic, k, names, [slice_ids[r.slice_id] for r in rows],
                               weights, device)
    numbers = metric_numbers(prog, refm)
    checks = compare(numbers, traffic["limits"])
    total = per_sweep * win.done
    return Outcome({"eval_slices_per_s": total / win.elapsed}, passes(checks), total, 0, checks,
                   ctx, win.first_unit, peak, numbers)


def reference_eval_rows(config: dict, traffic: dict, k: np.ndarray, names: list,
                        ids: list, params: dict, device, *, quant: bool = False) -> np.ndarray:
    """(3, len(ids)) reference metrics of the slices ``ids`` ((volume,
    slice) pairs) under each volume's fixed mask."""
    from perfbench.reference import data as ref
    size = traffic["size"]
    cols = {}
    for v in sorted({v for v, _ in ids}):
        mask = ref.column_mask(names[v], size, traffic["center_fraction"],
                               traffic["acceleration"], None)
        fully = reference_images(k[v], None, device)
        under = reference_images(k[v], mask, device)
        sl = sorted({s for vv, s in ids if vv == v})
        got = reference_metrics(params, config, fully[sl], under[sl], block=traffic["ref_block"],
                                quant=quant).cpu().numpy()
        for j, s in enumerate(sl):
            cols[(v, s)] = got[:, j]
    return np.stack([cols[i] for i in ids], axis=1)


def control_numbers(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control's numbers for one seed: the reference a precision below
    the configuration's against the float32 reference, on a sample of rows
    drawn as a run draws it, with the weights a run draws from ``seed``."""
    w = make_weights(param_shapes(config), config["model"], seed, device)
    rng = np.random.default_rng(seed)
    k = kspace_host(traffic, traffic["volumes"], seed, device)
    names = stems(seed, traffic["volumes"])
    ids = [(int(rng.integers(traffic["volumes"])), int(rng.integers(traffic["slices"])))
           for _ in range(traffic["check_sample"])]
    ref = reference_eval_rows(config, traffic, k, names, ids, w, device)
    low = reference_eval_rows(config, traffic, k, names, ids, w, device, quant=True)
    return metric_numbers(low, ref)


def plant(mode: str):
    """A fault of the timed path: ``fault:answer``, every output of the model
    off by 0.05 where it is produced (a hook on the built reconstructor)."""
    if mode == "fault:answer":
        def hook(recon):
            inner = recon.apply_fn
            recon.apply_fn = lambda tiles: inner(tiles) + 0.05
        return None, hook
    raise LookupError(f"the sweep kind plants no {mode!r}")


FAULTS = ("fault:answer",)
