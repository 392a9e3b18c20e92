#!/usr/bin/env python3
"""What one of the program's spans (``utils/profiling.py``'s
``SectionTimer.section``) costs the host: a loop of empty spans with no
profiler, the same loop while a ``torch.profiler`` records (CPU activity,
and CUDA's where a card is present), and a bare ``record_function`` with no
profiler, which is what the span's guard saves.

    python3 scripts/span_cost.py [--n 100000]

Prints one JSON object: microseconds a span (three loops each way), the
empty loop's, the torch version. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mri_inr_tpu_torch.utils import profiling  # noqa: E402


def per_entry_us(n: int, body) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        body()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000, help="entries a loop")
    n = ap.parse_args(argv).n

    def span_loop():
        timer = profiling.SectionTimer()

        def body():
            with timer.section("mri.bench.span"):
                pass

        return per_entry_us(n, body)

    def bare():
        r = torch.profiler.record_function("mri.bench.bare")
        r.__enter__()
        r.__exit__(None, None, None)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    res = {"n": n, "empty_loop_us": per_entry_us(n, lambda: None)}
    span_loop()  # warm
    res["off_us"] = [span_loop() for _ in range(3)]
    with profile(activities=acts):
        res["on_us"] = [span_loop() for _ in range(3)]
    res["bare_record_function_no_profiler_us"] = per_entry_us(n, bare)
    res["torch"] = torch.__version__
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
