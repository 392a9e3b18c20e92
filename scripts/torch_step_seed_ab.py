#!/usr/bin/env python3
"""Time the fused per-step train route and its dropout seeds from two
checkouts of the repository in turns, on one card: this tree's and another
tree's (an earlier commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, such as ``proof/``).

    python3 scripts/torch_step_seed_ab.py OTHER_TREE

Each turn is a process of its own that imports the package of its tree and
builds that tree's train kernels into its ``_build/``; the turns go other,
this, this, other. A turn reads, on the host's clock:

- ``step_seed``: one step's dropout seed drawn alone (``trainer.step_seed``,
  median of 256 steps);
- ``block``: the seeds of 256 steps drawn at once (``trainer.epoch_seeds``,
  median of 20);
- ``steps_per_s``: configs/train.yaml's model (bf16, dropout 0.1) and batch
  (400 seeded random tiles), Adam, MSE, through the tree's
  ``make_train_step`` with the fused kernels: 256 steps in a row after 3
  warm-up steps, wall time to the last step's end, median of 3 runs.

Printed with the card's name and power limit. Needs the CUDA toolkit and a
card; imports no JAX.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent.parent
STEPS = 256


def one_turn(tree: pathlib.Path) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.ops import _build
    from mri_inr_tpu_torch.train import losses, trainer

    if not pathlib.Path(trainer.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {trainer.__file__}, not the package of {tree}")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, ["siren_train_fwd", "siren_train_bwd"]))
    out = {}
    alone = []
    for s in range(STEPS):
        t0 = time.perf_counter()
        trainer.step_seed(1, s)
        alone.append(1e3 * (time.perf_counter() - t0))
    out["step_seed_ms"] = statistics.median(alone)
    block = []
    for _ in range(20):
        t0 = time.perf_counter()
        trainer.epoch_seeds(1, 0, STEPS)
        block.append(1e3 * (time.perf_counter() - t0))
    out["block_ms"] = statistics.median(block)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    fully = torch.rand((400, 32, 32), generator=g).to(dev)
    under = torch.rand((400, 32, 32), generator=g).to(dev)
    cfg = config.load_train_configuration(REPO / "configs" / "train.yaml")
    model = ms.from_config(cfg.model, cfg.training.precision,
                           generator=torch.Generator().manual_seed(0), device=dev)
    state = trainer.create_train_state(model, cfg.training.optimizer, cfg.training.lr)
    step = trainer.make_train_step(model, losses.mse, 32, 24, use_pallas=True,
                                   sin5=cfg.training.sin5)
    for _ in range(3):
        step(state, fully, under, 1)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, fully, under, 1)
        torch.cuda.synchronize()
        rates.append(STEPS / (time.perf_counter() - t0))
    out["steps_per_s"] = statistics.median(rates)
    out["steps_per_s_runs"] = rates
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(one_turn(pathlib.Path(sys.argv[2]))))
        return 0
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = pathlib.Path(sys.argv[1]).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for which in ("other", "this", "this", "other"):
        tree = other if which == "other" else REPO
        proc = subprocess.run([sys.executable, __file__, "--turn", str(tree)], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{which} ({tree.name}): one step's seed alone {r['step_seed_ms']:.4f} ms, "
              f"{STEPS} steps' seeds at once {r['block_ms']:.4f} ms (host clock); fused "
              f"per-step route {r['steps_per_s']:.2f} steps/s (median of "
              f"{', '.join(f'{x:.2f}' for x in r['steps_per_s_runs'])}; {STEPS} steps of 400 "
              f"a run) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
