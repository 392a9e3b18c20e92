"""Ranks for the port's multi-process tests: a launcher and the scenarios
each rank runs (torch and the port only, so the card's machine, which has
no JAX, runs them too).

    python tests/torch_port_ranks.py SCENARIO OUT_DIR DEVICE

runs SCENARIO on one rank, which :func:`launch` starts ``world`` times
through the ``MRI_INR_*`` route, rank 0 serving the rendezvous on a free
local port; each rank writes ``OUT_DIR/<scenario>_rank<r>.npz``.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: hard limit on a launch: a rank that hangs fails its test, not the suite
RANK_TIMEOUT = 120
#: the ranks' own rendezvous and collective timeout (seconds)
DIST_TIMEOUT = "60"
WIDTHS = dict(dim_hidden=32, latent_dim=32, num_layers=2)
# the CUDA kernels take H in (64, 128, 192, 256)
CARD_WIDTHS = dict(dim_hidden=64, latent_dim=32, num_layers=2)
BATCH = 16
BASE_SEED = 7
HALO_CASES = [(8, 5), (16, 3), (8, 1)]  # (nv, nh), the JAX package's cases
#: name -> (dropout, fused, optimizer, lr, steps) of the ``steps`` scenario.
#: ``dropout_sgd1`` holds the rank streams where more than two ranks sum in
#: an order of the collective's own: Adam's first step moves an element whose
#: gradient is rounding noise by about ``lr`` either way
STEP_CASES = {"sgd3": (0.0, True, "sgd", 1e-3, 3), "sgd1": (0.0, True, "sgd", 1e-2, 1),
              "dropout1": (0.1, True, "adam", 1e-3, 1), "module2": (0.0, False, "sgd", 1e-3, 2),
              "dropout_sgd1": (0.1, True, "sgd", 1e-2, 1)}
SIREN, INNER = 24, 16


def free_port() -> int:
    """A local TCP port nothing listens on now (rank 0 binds it next). A
    file rendezvous is avoided: its store locks the file at every step, and
    the store has hung on those locks in its teardown when ranks left."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args: list[str], world: int, tmp: pathlib.Path, env: dict | None = None,
           timeout: float = RANK_TIMEOUT, rank_args: dict | None = None) -> list[str]:
    """Run ``python args...`` as ``world`` ranks (rank ``r`` with
    ``rank_args[r]`` appended); every rank must exit 0 within ``timeout``
    seconds. Returns each rank's stdout; a failure carries every rank's
    stderr."""
    tmp.mkdir(parents=True, exist_ok=True)
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    base.update({"MRI_INR_COORDINATOR": f"127.0.0.1:{free_port()}",
                 "MRI_INR_NUM_PROCESSES": str(world), "MRI_INR_DIST_TIMEOUT": DIST_TIMEOUT,
                 "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT), **(env or {})})
    procs, logs = [], []
    for rank in range(world):
        out, err = tmp / f"rank{rank}.out", tmp / f"rank{rank}.err"
        logs.append((out, err))
        with open(out, "w") as fo, open(err, "w") as fe:
            argv = [sys.executable, *args, *(rank_args or {}).get(rank, [])]
            procs.append(subprocess.Popen(argv, cwd=ROOT, stdout=fo,
                                          stderr=fe,
                                          env={**base, "MRI_INR_PROCESS_ID": str(rank)}))
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * world:
        tails = "\n".join(f"--- rank {r} (exit {codes[r] if r < len(codes) else 'killed'}):\n"
                          + err.read_text()[-3000:] for r, (_, err) in enumerate(logs))
        raise AssertionError(f"{' '.join(args)} over {world} ranks: {codes}\n{tails}")
    return [out.read_text() for out, _ in logs]


def run_scenario(name: str, world: int, tmp: pathlib.Path, device: str = "cpu",
                 timeout: float = RANK_TIMEOUT) -> list[dict]:
    """:func:`launch` a scenario of this file; every rank's saved arrays."""
    out = tmp / "out"
    out.mkdir(parents=True, exist_ok=True)
    launch([__file__, name, str(out), device], world, tmp / "ranks", timeout=timeout)
    return [dict(np.load(out / f"{name}_rank{r}.npz", allow_pickle=False))
            for r in range(world)]


# ---------------------------------------------------------------- inputs
def small_model(dropout: float, device: str | torch.device, seed: int = 0, **kw):
    """A seeded small model: :data:`WIDTHS` on the CPU, :data:`CARD_WIDTHS`
    on the card."""
    from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren

    widths = CARD_WIDTHS if torch.device(device).type == "cuda" else WIDTHS
    return ModulatedSiren(**widths, dropout=dropout, device=device, **kw,
                          generator=torch.Generator().manual_seed(seed))


def global_batch(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(size=(BATCH, 32, 32)).astype(np.float32) for _ in range(2))


def halo_patches(nv: int, nh: int) -> np.ndarray:
    return np.random.default_rng(nv * 100 + nh).uniform(
        size=(nv * nh, SIREN, SIREN)).astype(np.float32)


def flat_params(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()


def emulate_step(case: str, device, world: int) -> tuple[np.ndarray, float]:
    """One data-parallel step of a one-step fused ``steps`` case done in one
    process: each rank's local gradient with that rank's dropout seed, their
    mean, one optimizer step. Returns (flat parameters, mean loss)."""
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.ops import tiling
    from mri_inr_tpu_torch.parallel import mesh
    from mri_inr_tpu_torch.train import losses, trainer

    dropout, _, opt, lr, _ = STEP_CASES[case]
    model = small_model(dropout, device)
    state = trainer.create_train_state(model, opt, lr)
    fully, under = (torch.from_numpy(a).to(device) for a in global_batch())
    grads, local = [], []
    for r in range(world):
        model.zero_grad(set_to_none=True)
        rows = [mesh.local_rows(t, r, world) for t in (fully, under)]
        pred = stk.fused_train_apply(model, rows[1], trainer.step_seed(BASE_SEED, 0, r),
                                     sin5=True)
        loss = losses.mse(pred.float(), tiling.extract_center_batch(rows[0], 32, 24).float())
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        local.append(float(loss.detach()))
    for p, *gs in zip(model.parameters(), *grads):
        p.grad = sum(gs) / world
    state.optimizer.step()
    return flat_params(model), sum(local) / world


def halves_step_body(world: int, rows_of=None):
    """A stand-in for ``trainer._make_step_body`` (fused path, one process):
    every step computes the gradients of each rank's rows of the batch
    (``mesh.local_rows``) apart and averages them as the ranks' all-reduce
    does (the sum in rank order, then the division), the loss likewise,
    before the one optimizer step. A one-process run through it follows the
    ranks' arithmetic; one at the whole batch sums in another order.

    ``rows_of(r)`` names the rank whose rows rank ``r`` takes (itself by
    default). ``rows_of=lambda r: 0`` plants a fault the ranks could share
    with this witness: every rank steps on rank 0's rows, so the rest of
    the batch is left out (as it is where each rank steps on its own
    gradients, unreduced); only a comparison with the whole batch sees it."""
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.ops import tiling
    from mri_inr_tpu_torch.parallel import mesh

    def make(model, loss_fn, outer, siren, *, fused, sin5, freeze_encoder, group=None):
        if not fused or freeze_encoder or group is not None:
            raise ValueError("halves_step_body: the fused path of one process only")

        def body(state, fully, under, seed):
            total = None
            for r in range(world):
                src = r if rows_of is None else rows_of(r)
                f, u = (mesh.local_rows(t, src, world) for t in (fully, under))
                state.optimizer.zero_grad(set_to_none=True)
                pred = stk.fused_train_apply(model, u, seed, sin5=sin5)
                loss = loss_fn(pred.float(), tiling.extract_center_batch(f, outer, siren).float())
                loss.backward()
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
                total = flat if total is None else total + flat
            total = total / world
            offset = 0
            for g in grads:
                g.copy_(total[offset : offset + g.numel()].view_as(g))
                offset += g.numel()
            state.optimizer.step()
            return total[-1]

        return body

    return make


# ------------------------------------------------------------- scenarios
def steps(device, group) -> dict:
    """The data-parallel train and eval steps (``trainer.make_train_step``
    and ``make_eval_step`` with the group), on the fused path and the
    module path."""
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.ops import siren_train_kernel as stk
    from mri_inr_tpu_torch.train import losses, trainer

    fully, under = (torch.from_numpy(a).to(device) for a in global_batch())
    out = {}
    for name, (dropout, fused, opt, lr, n) in STEP_CASES.items():
        model = small_model(dropout, device)
        state = trainer.create_train_state(model, opt, lr)
        step = trainer.make_train_step(model, losses.mse, 32, 24, use_pallas=fused,
                                       sin5=name != "sgd1", group=group)
        fwd0 = stk.siren_chain_train_fwd_cuda.launches
        bwd0 = stk.siren_chain_train_bwd_cuda.launches
        out[f"{name}_loss"] = np.array([float(step(state, fully, under, BASE_SEED))
                                        for _ in range(n)])
        out[f"{name}_launches"] = np.array([stk.siren_chain_train_fwd_cuda.launches - fwd0,
                                            stk.siren_chain_train_bwd_cuda.launches - bwd0])
        out[f"{name}_params"] = flat_params(model)
    model = small_model(0.0, device)
    eval_step = trainer.make_eval_step(model, losses.mse, 32, 24, use_pallas=True, sin5=True,
                                       device=device, group=group)
    before = sk.siren_forward_cuda.launches
    out["eval_loss"] = np.array(float(eval_step(None, fully, under)))
    out["eval_launches"] = np.array(sk.siren_forward_cuda.launches - before)
    return out


def gather(device, group) -> dict:
    """``gather_shard_results`` of unequal row counts: rank r holds shard
    r:N of five rows."""
    from mri_inr_tpu_torch.eval import evaluate as ev
    from mri_inr_tpu_torch.parallel import distributed

    rows = [ev.SliceResult(f"slice_{i}", 20.0 + i / 3, 0.5 + i / 7, 0.1 / (i + 1))
            for i in range(5)]
    mine = rows[distributed.process_index()::distributed.process_count()]
    got = ev.gather_shard_results(mine)
    return {"rows": np.array(json.dumps([[r.slice_id, r.psnr, r.ssim, r.nrmse]
                                         for r in got]))}


def halo(device, group) -> dict:
    """The halo fold of each case's rows, gathered; the indivisible grid's
    error; the eval forward of a halo-mode reconstructor on one slice."""
    from mri_inr_tpu_torch.eval.evaluate import SliceReconstructor
    from mri_inr_tpu_torch.ops import siren_kernel as sk
    from mri_inr_tpu_torch.parallel import distributed, halo_fold

    rank, world = distributed.rank_world(group)
    out = {}
    for nv, nh in HALO_CASES:
        patches = torch.from_numpy(halo_patches(nv, nh)).to(device)
        local = halo_fold.local_patch_rows(patches, (nv, nh), rank, world)
        band = halo_fold.sharded_patches_to_image_weighted_average(local, (nv, nh), SIREN,
                                                                   INNER, group)
        out[f"band_{nv}x{nh}"] = band.cpu().numpy()
        out[f"image_{nv}x{nh}"] = halo_fold.gather_bands(band, group).cpu().numpy()
    try:
        halo_fold.sharded_patches_to_image_weighted_average(
            torch.zeros(3 * 2, SIREN, SIREN, device=device), (3, 2), SIREN, INNER, group)
        out["indivisible"] = np.array("no error")
    except ValueError as err:
        out["indivisible"] = np.array(str(err))
    model = small_model(0.0, device)
    rec = SliceReconstructor(sk.make_apply_fn(model, use_pallas=True, sin5=True, device=device),
                             patch_bucket=16, device=device, halo=True, group=group)
    fully, under = np.random.default_rng(7).uniform(size=(2, 128, 80)).astype(np.float32)
    before = sk.siren_forward_cuda.launches
    recon, _, _, m = rec(fully, under)
    out["slice_recon"] = recon.cpu().numpy()
    out["slice_metrics"] = np.array([float(m[k]) for k in ("psnr", "ssim", "nrmse")])
    out["slice_launches"] = np.array(sk.siren_forward_cuda.launches - before)
    out["exchange_calls"] = np.array(halo_fold.exchange_stats["calls"])
    return out


SCENARIOS = {"steps": steps, "gather": gather, "halo": halo}


def main(argv: list[str]) -> None:
    from mri_inr_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    # full f32 in cuDNN's and cuBLAS's products, as the tests that compare
    # with these ranks set it (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    name, out_dir, device = argv
    dev = distributed.initialize(device)
    try:
        result = SCENARIOS[name](dev, distributed.collective_group())
        np.savez(pathlib.Path(out_dir) / f"{name}_rank{distributed.process_index()}.npz",
                 **result)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
