"""The ``train`` kind: the train CLI's trainer (``cli/train.py:make_trainer``
-> ``Trainer.train``) over ``OnlineKspaceDataset.from_volumes`` data sets,
whole epochs (training, validation, mask epochs) in the window; its first
three optimizer steps, taken through the trainer's own epoch call on rows
that all differ, are what is compared.

A mix of this kind gives ``volumes``, ``val_volumes``, ``slices``, ``size``,
``acceleration``, ``center_fraction``, ``remask``, ``texture``, ``phase``,
``check_steps``, ``warmup_epochs``, ``trace_units``, ``ref_block`` and
``limits``.
"""

from __future__ import annotations

import pathlib
import shutil
import statistics
import tempfile

import numpy as np
import torch

from perfbench.core.drive import (Context, Outcome, Stop, Window, compare, fwd_kwargs, gap,
                                  kspace_host, load_weights, make_weights, memory_peak,
                                  param_shapes, passes, port_config, reference_images,
                                  release_memory, stems, sync)
from perfbench.core.trace import Profiler


class _EpochSpy:
    """Stands in for the trainer's ``scan_epoch``: records the host time of
    each train epoch's call (``ScanEpoch.launch_seconds``)."""

    def __init__(self, inner, record: list):
        self.inner, self.record = inner, record

    def __call__(self, state, fully, under, perm, base_seed, train):
        out = self.inner(state, fully, under, perm, base_seed, train)
        if train:
            self.record.append(self.inner.launch_seconds)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _train_sets(traffic: dict, config: dict, k: np.ndarray, names: list, device):
    from mri_inr_tpu_torch.data.online import OnlineKspaceDataset
    m = config["model"]
    common = dict(center_fraction=traffic["center_fraction"],
                  acceleration=traffic["acceleration"], max_slice_num=None,
                  outer_patch_size=m["outer_patch_size"],
                  inner_patch_size=m["inner_patch_size"], device=device)
    nv = traffic["volumes"]
    train_ds = OnlineKspaceDataset.from_volumes(names[:nv], list(k[:nv]),
                                                remask_each_epoch=traffic["remask"], **common)
    val_ds = OnlineKspaceDataset.from_volumes(names[nv:], list(k[nv:]),
                                              remask_each_epoch=False, **common)
    return train_ds, val_ds


def _program_steps(trainer, train_ds, rows: np.ndarray, batch: int, steps: int) -> dict:
    """The first ``steps`` optimizer steps, each one call of the trainer's
    epoch over one batch of ``rows``: each step's loss, the first step's
    gradient per leaf and its norm (Adam's first moment after one step is
    ``(1 - beta1) g``; on the host), each leaf's change norm after the last
    step."""
    fully, under = train_ds.materialize(0)
    state = trainer.state
    named = list(trainer.model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    losses, grad0, grad0_t = [], None, None
    for i in range(steps):
        perm = rows[i * batch : (i + 1) * batch].reshape(1, batch).astype(np.int32)
        losses.append(float(trainer.scan_epoch(state, fully, under, perm, trainer.base_seed,
                                               True)))
        trainer.invalidate_packs()
        if grad0 is None:  # an optimizer that did not step holds no moment: nought
            moments = {n: state.optimizer.state.get(p, {}).get("exp_avg") for n, p in named}
            grad0_t = {n: torch.zeros(p.shape, dtype=torch.float64) if moments[n] is None
                       else moments[n].double().cpu() / (1 - beta1) for n, p in named}
            grad0 = {n: float(g.norm()) for n, g in grad0_t.items()}
    change = {n: float((p.detach() - start[n]).double().norm()) for n, p in named}
    return {"losses": losses, "grad0": grad0, "grad0_t": grad0_t, "change": change}


def train_numbers(prog: dict, ref: dict) -> dict:
    """Each step's loss against the reference's (relative, the worst step),
    the first gradient's and the parameter change's norms leaf by leaf,
    each gap against the larger of the leaf's reference norm and the median
    leaf's: the worst leaf (``*_norm_gap``) and the median leaf
    (``*_norm_gap_median``). Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change (round-off
    moves them under Adam). ``grad_diff`` / ``grad_diff_median``: the norm
    of the first gradient's difference, leaf by leaf, over the same
    denominator; a norm moves with rounding noise only at second order, the
    difference at first."""
    g_med = statistics.median(ref["grad0"].values())
    grads = [gap(prog["grad0"][n], r, g_med) for n, r in ref["grad0"].items()]
    diffs = [float((prog["grad0_t"][n] - ref["grad0_t"][n]).norm()) / max(r, g_med, 1e-30)
             for n, r in ref["grad0"].items()]
    moved = [n for n, g in ref["grad0"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moved)
    changes = [gap(prog["change"][n], ref["change"][n], c_med) for n in moved]
    return {"loss_rel_gap": max(gap(p, r) for p, r in zip(prog["losses"], ref["losses"])),
            "grad_norm_gap": max(grads), "grad_norm_gap_median": statistics.median(grads),
            "grad_diff": max(diffs), "grad_diff_median": statistics.median(diffs),
            "change_norm_gap": max(changes),
            "change_norm_gap_median": statistics.median(changes)}


def reference_train(config: dict, traffic: dict, k: np.ndarray, names: list, rows: np.ndarray,
                    params: dict, seed: int, device, *, quant: bool = False) -> dict:
    """The reference's three steps on the same rows: tiles worked out again
    from the k-space and the masks of mask epoch 0."""
    from perfbench.reference import data as ref
    from perfbench.reference import train as ref_train
    m, t = config["model"], config["port"]["training"]
    slices, size = traffic["slices"], traffic["size"]
    per_slice = ref.grid_of(size, size, m["inner_patch_size"])
    per_slice = per_slice[0] * per_slice[1]
    batch, steps = t["batch_size"], traffic["check_steps"]
    rows = rows[: batch * steps]
    epoch = 0 if traffic["remask"] else None
    need = sorted({int(r) // (per_slice * slices) for r in rows})
    fully_t, under_t = {}, {}
    for v in need:
        mask = ref.column_mask(names[v], size, traffic["center_fraction"],
                               traffic["acceleration"], epoch)
        fully_t[v] = ref.tiles(reference_images(k[v], None, device), m["outer_patch_size"],
                               m["inner_patch_size"])
        under_t[v] = ref.tiles(reference_images(k[v], mask, device), m["outer_patch_size"],
                               m["inner_patch_size"])

    def pick(store, r):
        v, rest = divmod(int(r), per_slice * slices)
        return store[v][rest // per_slice, rest % per_slice]

    batches = []
    for i in range(steps):
        idx = rows[i * batch : (i + 1) * batch]
        under = torch.stack([pick(under_t, r) for r in idx])
        fully = torch.stack([pick(fully_t, r) for r in idx])
        batches.append((under, ref.centre(fully, m["outer_patch_size"], m["siren_patch_size"])))
    keep = 1.0 - m["dropout"]
    scale = float(np.float32(1.0) / np.float32(config["dropout_keep_as_stored"]))
    base = seed % 2**31 + 1
    seq, hidden = m["siren_patch_size"] ** 2, m["dim_hidden"]
    drops = [ref_train.step_drops(config["dropout_route"], base, s, keep, scale, seq, hidden,
                                  m["num_layers"], device) for s in range(steps)]
    return ref_train.three_steps(params, batches, drops, lr=t["lr"], block=traffic["ref_block"],
                                 quant=quant, **fwd_kwargs(config, "train"))


def drive(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
          device: torch.device, fault=None) -> Outcome:
    from mri_inr_tpu_torch.cli import train as cli_train

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="perfbench-train-"))
    try:
        cfg = port_config(config, seed, tmp)
        nv, nval = traffic["volumes"], traffic["val_volumes"]
        k = kspace_host(traffic, nv + nval, seed, device)
        names = stems(seed, nv + nval)
        train_ds, val_ds = _train_sets(traffic, config, k, names, device)
        holder: dict = {}

        def hook(msg: str) -> None:
            t = holder.get("trainer")
            if t is None or t.state.step == holder["last_step"]:
                return
            holder["last_step"] = t.state.step
            holder["on_epoch"](t.state.step)

        trainer = cli_train.make_trainer(cfg, train_ds, val_ds, tmp / "run", device, log=hook)
        holder.update(trainer=trainer, last_step=trainer.state.step)
        named = [(n, tuple(p.shape)) for n, p in trainer.model.named_parameters()]
        weights = make_weights(named, config["model"], seed, device)
        load_weights(trainer.model, weights)
        trainer.invalidate_packs()
        if fault is not None:
            fault(trainer)

        batch, steps = cfg.training.batch_size, traffic["check_steps"]
        rng = np.random.default_rng(seed)
        rows = rng.permutation(len(train_ds))[: batch * steps]
        prog = _program_steps(trainer, train_ds, rows, batch, steps)

        epoch_host: list = []
        trainer.scan_epoch = _EpochSpy(trainer.scan_epoch, epoch_host)

        def run_epochs(first: int, on_epoch) -> None:
            holder["on_epoch"] = on_epoch
            holder["last_step"] = trainer.state.step
            try:
                trainer.train(first + 10**9, first)
            except Stop:
                pass

        warm = traffic["warmup_epochs"]
        done = []

        def warm_epoch(step):
            done.append(step)
            if len(done) >= warm:
                raise Stop

        def stop_now(step):
            raise Stop

        run_epochs(0, warm_epoch)
        ctx = Context(config, traffic)
        prof = Profiler(device) if trace else None
        if prof:  # the tracer starts up over one more epoch of set-up
            prof.start()
            run_epochs(warm, stop_now)
            warm += 1
        sync(device)
        del epoch_host[:]
        win = Window(seconds, prof, traffic["trace_units"], ctx)
        win.begin(trainer.state.step)

        def window_epoch(step):
            if win.unit(step):
                raise Stop

        run_epochs(warm, window_epoch)
        win.finish()
        peak = memory_peak(device)
        ctx.counts["steps_untraced"], ctx.counts["seconds_untraced"] = win.untraced()
        ctx.counts["batch"] = batch
        ctx.spans["epoch_host_s"] = list(epoch_host)
        rate = win.done * batch / win.elapsed
        attempted, first_unit = win.done, win.first_unit

        del trainer, train_ds, val_ds, holder
        release_memory(device)
        refr = reference_train(config, traffic, k, names, rows, weights, seed, device)
        numbers = train_numbers(prog, refr)
        checks = compare(numbers, traffic["limits"])
        return Outcome({"train_patches_per_s": rate}, passes(checks),
                       attempted, 0, checks, ctx, first_unit, peak, numbers)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def control_numbers(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control's numbers for one seed: the reference a precision below
    the configuration's (``quant``) against the float32 reference, on the
    weights, tiles, rows and dropout draws a run makes from ``seed``."""
    m = config["model"]
    nv = traffic["volumes"]
    k = kspace_host(traffic, nv + traffic["val_volumes"], seed, device)
    names = stems(seed, nv + traffic["val_volumes"])
    per = (traffic["size"] // m["inner_patch_size"]) ** 2
    rows = np.random.default_rng(seed).permutation(nv * traffic["slices"] * per)
    rows = rows[: config["port"]["training"]["batch_size"] * traffic["check_steps"]]
    w = make_weights(param_shapes(config), m, seed, device)
    ref = reference_train(config, traffic, k, names, rows, w, seed, device)
    low = reference_train(config, traffic, k, names, rows, w, seed, device, quant=True)
    return train_numbers(low, ref)


def plant(mode: str):
    """A fault of the timed path: (a patch of the program to make before
    set-up as (module, name, value), or None; a hook on the built trainer,
    or None). ``fault:unchanged``: the optimizer's step does nothing;
    ``fault:half``: the loss is the mean over the first half of the batch."""
    from mri_inr_tpu_torch.train import losses

    if mode == "fault:unchanged":
        def hook(trainer):
            trainer.state.optimizer.step = lambda *a, **k: None
        return None, hook
    if mode == "fault:half":
        def half(pred, target):
            n = pred.shape[0] // 2
            return torch.mean(torch.square(pred[:n] - target[:n]))
        return (losses, "mse", half), None
    raise LookupError(f"the train kind plants no {mode!r}")


FAULTS = ("fault:unchanged", "fault:half")
