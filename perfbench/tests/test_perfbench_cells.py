"""Each cell driven end to end on the CPU at a tiny size (the kernels' plain
versions): the program comes out correct; its control, the reference a
precision below the configuration's, does not; and nor does a run with the
timed path broken underneath, once for each fault the cell can have (a step
that leaves the state unchanged, the loss over half the batch, an answer
altered where it is produced). The look for a card is skipped, the rest of
a run is the benchmark's own."""

import copy

import pytest
import torch

from perfbench import control
from perfbench.core import drive, harness
from perfbench.tests import tiny

CPU = torch.device("cpu")
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
FAULTS = [(c, f) for c in CELLS
          for f in harness.driver(harness.resolve(harness.load_spec(), c).traffic["kind"]).FAULTS]


def run(cell, seed, mode="program", trace=False):
    return control.run_with_fault(cell, mode, seed, 1.0, trace, CPU)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(workload):
    out = run(tiny.cell(workload), 2**31 + 101)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert all(v > 0 for v in out.end_to_end.values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = tiny.cell(workload)
    numbers = control.control_numbers(cell, 2**31 + 102, CPU)
    checks = drive.compare(numbers, cell.traffic["limits"])
    assert not drive.passes(checks), checks


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    out = run(tiny.cell(workload), 2**31 + 103, fault)
    assert not out.correct, out.checks


@pytest.mark.parametrize("workload", ["flagship.train_online320", "flagship.sweep320"])
def test_result_line(workload):
    spec = harness.load_spec()
    cell = tiny.cell(workload)
    cell.end_to_end = harness.resolve(spec, workload).end_to_end
    cell.per_layer = harness.resolve(spec, workload).per_layer
    out = run(cell, 2**31 + 104)
    out.end_to_end["setup_s"] = 1.0
    line = harness.result_line(cell, out, False, {"platform": "cpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(line["checks"]) == set(cell.traffic["limits"])
    traced = harness.result_line(cell, run(copy.deepcopy(cell), 2**31 + 104, trace=True), True,
                                 {"platform": "cpu"})
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
