#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell, many
seeds in one process: one JSON line a seed, with every number worked out,
compared or not, and ``correct`` as the cell's limits judge them.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --mode <mode> [--seconds 2]

- ``program``: a run of the cell as ``run.py`` makes it (a short window):
  the lower readings.
- ``control``: the reference put in the program's place at the next
  precision below the configuration's (bf16 -> float8 e4m3, one scale a
  tensor, every tensor a layer hands on: ``reference/model.py``), held
  against the float32 reference by the same comparison, on the same inputs,
  at the cell's own size: the upper readings.
- a fault the cell's driver plants in the timed path (its ``FAULTS``:
  ``fault:unchanged``, the optimizer's step does nothing, and
  ``fault:half``, the loss over the first half of the batch, for ``train``;
  ``fault:answer``, every output of the model off by 0.05 where it is
  produced, for ``sweep``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers for one seed of ``cell``."""
    from perfbench.core import harness
    return harness.driver(cell.traffic["kind"]).control_numbers(cell.config, cell.traffic, seed,
                                                                device)


def run_with_fault(cell, mode: str, seed: int, seconds: float, trace: bool, device):
    """One run of ``cell`` with the fault ``mode`` planted: the driver's
    :class:`Outcome`."""
    from perfbench.core import harness
    drv = harness.driver(cell.traffic["kind"])
    patch, hook = drv.plant(mode) if mode != "program" else (None, None)
    saved = getattr(patch[0], patch[1]) if patch else None
    if patch:
        setattr(patch[0], patch[1], patch[2])
    try:
        return drv.drive(cell.config, cell.traffic, seed, seconds, trace, device, fault=hook)
    finally:
        if patch:
            setattr(patch[0], patch[1], saved)


def main(argv: list[str] | None = None) -> int:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from perfbench.core import drive, harness
    cell = harness.resolve(harness.load_spec(), args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "control":
            numbers = control_numbers(cell, seed, device)
            extra = {"correct": drive.passes(drive.compare(numbers, cell.traffic["limits"]))}
        else:
            out = run_with_fault(cell, args.mode, seed, args.seconds, False, device)
            numbers, extra = out.numbers, {"correct": out.correct, **out.end_to_end,
                                           "unit_s": out.context.spans.get("unit_s")}
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed, **extra,
                          "numbers": numbers}), flush=True)
        drive.release_memory(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
