#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone, on one card, with its checks
reported instead of raised, and the precision's share of its gaps:

    python3 scripts/torch_multirank_probe.py

Builds the kernels, preprocesses the smoke's phantom volumes
(``chip_smoke.preprocess_path``), runs ``chip_smoke.multirank_path`` (two
ranks sharing the card), then the same comparisons in fp32: one 2-rank SGD
step against the one-process step, and three epochs of the 2-rank train
CLI against a one-process run (relative per-epoch losses, from the ranks'
TensorBoard scalars). Prints whether TensorBoard packages are installed.
About 4 minutes on an H100.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mri_inr_tpu_torch.cli import test as cli_test  # noqa: E402
from mri_inr_tpu_torch.cli import train as cli_train  # noqa: E402
from mri_inr_tpu_torch.configuration import config  # noqa: E402
from mri_inr_tpu_torch.data import dataset, preprocessing, synthetic  # noqa: E402
from mri_inr_tpu_torch.eval import evaluate as ev  # noqa: E402
from mri_inr_tpu_torch.ops import _build, tiling  # noqa: E402
from mri_inr_tpu_torch.ops import fft_kernel as fk  # noqa: E402
from mri_inr_tpu_torch.ops import siren_train_kernel as stk  # noqa: E402
from mri_inr_tpu_torch.train import losses, trainer  # noqa: E402
from mri_inr_tpu_torch.utils import tensorboard  # noqa: E402

FAILED: list[str] = []


def report(cond: bool, msg: str) -> None:
    if not cond:
        print("CHECK FAILED:", msg)
        FAILED.append(msg)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_multirank_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.check = report
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__)
    for mod in ("tensorboard", "tensorboardX"):
        try:
            __import__(mod)
            print(mod, "installed")
        except ImportError:
            print(mod, "not installed")
    cs.build_kernels(_build, ["siren_forward", "siren_forward_int8", "siren_train_fwd",
                              "siren_train_bwd", "dft2c"])
    device = torch.device("cuda", 0)
    pkg = dict(config=config, dataset=dataset, synthetic=synthetic,
               preprocessing=preprocessing, fk=fk, ev=ev, stk=stk, cli_train=cli_train,
               cli_test=cli_test, losses=losses, trainer=trainer, tiling=tiling,
               tensorboard=tensorboard)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        pre = cs.preprocess_path(pkg, tmp, device)
        cs.multirank_path(pkg, tmp, device, pre["meta"], pre["val_meta"], card)

        reports = cs.launch_ranks(tmp, "sgd_fp32", "step", ["0.0", "sgd", "1e-2", "fp32"])
        got = np.load(tmp / "ranks_sgd_fp32" / "report0.npy")
        cfg, state = cs.dp_state(config, cli_train, trainer, device, "0.0", "sgd", "1e-2", "fp32")
        step = trainer.make_train_step(state.model, losses.mse, 32, 24, use_pallas=True,
                                       sin5=cfg.training.sin5)
        loss = float(step(state, *cs.dp_batch(device), cs.DP_SEED))
        print(f"fp32 SGD step: loss relative {abs(reports[0]['loss'] - loss) / loss:.3e}, "
              f"parameters max |diff| "
              f"{float(np.abs(got - cs.flat_params(state.model)).max()):.3e} [{card}]")

        argv = ["--config", str(REPO / "configs" / "train.yaml"),
                "--set", f"data.train.dataset={pre['meta']}",
                "--set", f"data.val.dataset={pre['val_meta']}",
                "--set", "training.save_interval=1000", "--set", "training.device_data=true",
                "--set", "model.dropout=0.0", "--set", "training.precision=fp32",
                "--set", "training.epochs=3"]
        cs.launch_ranks(tmp, "fp32", "train", argv + [
            "--set", f"training.output_dir={tmp / 'fp32'}", "--set", "training.data_axis_size=2",
            "--set", "training.logging=true"])
        single = cli_train.main(argv + ["--set", f"training.output_dir={tmp / 'fp32_single'}"])
        scalars = tensorboard.read_scalars(next((tmp / "fp32").iterdir()) / "tensorboard")
        for tag, key in (("training_loss", "train_loss"), ("validation_loss", "val_loss")):
            for (epoch, value), row in zip(scalars[tag], single._progress):
                print(f"fp32 epoch {epoch} {key}: 2 ranks {value:.8f}, one process "
                      f"{row[key]:.8f}, relative {abs(value - row[key]) / row[key]:.3e}")
    print("failed checks:", FAILED)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
