"""The port's profiling helpers (``mri_inr_tpu_torch/utils/profiling.py``)
on the CPU: the section timer against the JAX package's (same report for the
same sections), ``device_trace`` (nothing for None, a Chrome trace of the
block under a directory), ``time_fn`` on the host clock, and the train
CLI's ``training.profile_dir``."""

import json
import pathlib

import numpy as np
import pytest
import torch

from mri_inr_tpu.utils import profiling as jprofiling
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.utils import profiling

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def test_section_timer_sums_sections_and_reports_as_the_jax_one():
    timer = profiling.SectionTimer()
    for _ in range(2):
        with timer.section("load"):
            pass
    with pytest.raises(KeyError), timer.section("step"):
        raise KeyError("a section that raises is still timed")
    assert set(timer.sections) == {"load", "step"}
    assert all(v >= 0.0 for v in timer.sections.values())
    jtimer = jprofiling.SectionTimer()
    timer.sections = jtimer.sections = {"load": 0.25, "step": 0.75, "save": 0.0}
    assert timer.report() == jtimer.report()
    assert timer.report().splitlines()[1].startswith("step")


def test_device_trace_of_none_does_nothing(tmp_path):
    with profiling.device_trace(None) as prof:
        assert prof is None
    with profiling.device_trace("") as prof:
        assert prof is None


def test_device_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    out = tmp_path / "trace"
    x = torch.ones(64, 64)
    with profiling.device_trace(out) as prof:
        y = x @ x
    assert float(y[0, 0]) == 64.0
    assert any("mm" in e.key for e in prof.key_averages())
    (trace,) = out.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_time_fn_times_a_host_call_by_the_host_clock():
    calls = []
    secs = profiling.time_fn(lambda n: calls.append(n) or torch.zeros(n), 8, warmup=2,
                             iters=5)
    assert calls == [8] * 7
    assert 0.0 <= secs < 1.0


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    d = tmp_path_factory.mktemp("profile_data")
    rows = []
    for v in range(2):
        k = synthetic.synthetic_kspace(v, 2, 64, 64, texture=0.2)
        rows += preprocessing.process_kspace_volume(k, synthetic.synthetic_stem(v),
                                                    d / "processed", device="cpu")
    return preprocessing.write_metadata(rows, d / "processed")


@pytest.mark.parametrize("device_data", [False, True], ids=["host-batches", "device-data"])
def test_train_cli_profile_dir_writes_a_trace(metadata, tmp_path, device_data):
    """``training.profile_dir`` traces the training epochs (not the initial
    losses) with torch.profiler, as the JAX train CLI does with
    jax.profiler: the trace holds the train step's backward."""
    prof_dir = tmp_path / "prof"
    sets = [f"data.train.dataset={metadata}", f"data.val.dataset={metadata}",
            "data.val.max_slice_num=0", "model.dim_hidden=64", "model.latent_dim=32",
            "model.num_layers=3", "training.batch_size=32", "training.save_interval=1000",
            "training.epochs=1", f"training.output_dir={tmp_path / 'out'}",
            f"training.profile_dir={prof_dir}", f"training.device_data={device_data}"]
    argv = ["--config", str(CONFIGS / "train.yaml"), "--device", "cpu"]
    trainer = cli_train.main(argv + [x for s in sets for x in ("--set", s)])
    assert trainer.state.step == -(-len(trainer.train_dataset) // 32)
    assert np.isfinite(trainer._progress[0]["train_loss"])
    (trace,) = prof_dir.glob("trace_*.json")
    names = {str(e.get("name", "")) for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("backward" in n.lower() for n in names)
