"""``run.py`` started from the root of a checkout: without a card, or without the port
beside it, it exits non-zero and prints no result; on the card (the ``cuda``
marker) a short run of a cell is correct and prints its line."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def start(cwd, seconds="1", workload="flagship.sweep320"):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 5), "--seconds", seconds, "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = start(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA device" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = start(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_unknown_cell_is_refused():
    out = start(ROOT, workload="no.such_cell")
    assert out.returncode == 2 and "no workload named" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = start(ROOT, seconds="3")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"setup_s", "eval_slices_per_s"}
