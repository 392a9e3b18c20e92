#!/usr/bin/env python3
"""Time an eager train step of the module path (``use_pallas: false``, the
SIREN under autograd) from two checkouts of the repository in turns, on one
card: this tree's and another tree's (an earlier commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists, such as ``proof/``).

    python3 scripts/torch_module_step_ab.py OTHER_TREE

configs/train.yaml's model (H=256, latent 256, L=5, dropout 0.1, bf16) and
batch (400 seeded random tiles), Adam, MSE, through each tree's
``make_train_step``; also the residual model. Each turn is a process of its
own that imports the package of its tree; the turns go other, this, this,
other. Times are CUDA-event medians of 10 steps after 3 warm-up steps,
printed with the card's name and power limit. Needs a card; builds no kernel
and imports no JAX.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def one_turn(tree: pathlib.Path) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.models import modulated_siren as ms
    from mri_inr_tpu_torch.train import losses, trainer

    if not pathlib.Path(trainer.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {trainer.__file__}, not the package of {tree}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    fully = torch.rand((400, 32, 32), generator=g).to(dev)
    under = torch.rand((400, 32, 32), generator=g).to(dev)
    out = {}
    for label, sets in (("module", []), ("residual", ["model.residual=true"])):
        cfg = config.load_train_configuration(REPO / "configs" / "train.yaml", sets)
        model = ms.from_config(cfg.model, cfg.training.precision,
                               generator=torch.Generator().manual_seed(0), device=dev)
        state = trainer.create_train_state(model, "adam", 1e-4)
        step = trainer.make_train_step(model, losses.mse, 32, 24, use_pallas=False)
        times = []
        for i in range(13):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, fully, under, 1)
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        out[label] = statistics.median(times)
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
    runs: dict = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        tree = other if which == "other" else REPO
        proc = subprocess.run([sys.executable, __file__, "--turn", str(tree)], cwd=tree,
                              capture_output=True, text=True, check=True, timeout=600)
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{which} ({tree.name}): " + ", ".join(
            f"{k} {v:.4f} ms a step" for k, v in runs[which][-1].items()) + f" [{card}]")
    for label in runs["this"][0]:
        a = [r[label] for r in runs["other"]]
        b = [r[label] for r in runs["this"]]
        print(f"{label} path eager train step: other {a[0]:.4f} / {a[1]:.4f} ms, this "
              f"{b[0]:.4f} / {b[1]:.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
