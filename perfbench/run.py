#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the program's set-up, warm-up of
every shape the window uses) runs first; then the window measures for
``--seconds``; then what the timed path produced is held against the plain
reference. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and last ``checks``, each
compared number beside its limit; the same numbers are the last lines of
standard error. Without a card, with fewer cards than the cell asks for,
without the port beside this folder, or with JAX loaded once the window has
closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    sys.path.insert(0, str(ROOT))
    from perfbench.core import harness

    start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        cell = harness.resolve(harness.load_spec(), args.workload)
    except LookupError as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import mri_inr_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as err:
        print(f"perfbench: the port is not beside this folder: {err}", file=sys.stderr)
        return 4

    drive = harness.driver(cell.traffic["kind"]).drive
    outcome = drive(cell.config, cell.traffic, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {', '.join(bad)} after the window", file=sys.stderr)
        return 5
    outcome.end_to_end["setup_s"] = outcome.first_unit - start
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = harness.result_line(cell, outcome, bool(args.trace), device)
    for name, value, limit in outcome.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
