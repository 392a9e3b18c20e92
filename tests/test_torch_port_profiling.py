"""The port's profiling helpers (``mri_inr_tpu_torch/utils/profiling.py``)
on the CPU: the section timer against the JAX package's (same report for the
same sections), the span recorder (entries counted, a ``torch.profiler``
range only while a profiler records, ``reset``), ``device_trace`` (nothing
for None, a Chrome trace of the block under a directory), ``time_fn`` on the
host clock, and the train CLI's ``training.profile_dir`` (the program's
spans in its trace, their table printed)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from mri_inr_tpu.utils import profiling as jprofiling
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset
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


def test_span_sums_and_counts_entries_also_when_the_block_raises():
    timer = profiling.SectionTimer()
    entries = []
    for _ in range(3):
        with timer.section("mri.test.load") as s:
            pass
        entries.append(s.seconds)
    with pytest.raises(KeyError), timer.section("mri.test.step") as raised:
        raise KeyError("a span that raises is still timed and counted")
    assert timer.counts == {"mri.test.load": 3, "mri.test.step": 1}
    assert all(e >= 0.0 for e in entries) and raised.seconds >= 0.0
    assert timer.sections["mri.test.load"] == pytest.approx(sum(entries))
    assert timer.sections["mri.test.step"] == raised.seconds
    assert len(timer.report().splitlines()[1].split()) == 3  # the JAX package's columns


def test_span_reset_clears_sections_and_counts():
    timer = profiling.SectionTimer()
    with timer.section("mri.test.a"):
        pass
    timer.reset()
    assert timer.sections == {} and timer.counts == {}
    with timer.section("mri.test.a"):
        pass
    assert timer.counts == {"mri.test.a": 1}


def test_span_is_a_profiler_range_only_while_a_profiler_records(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    timer = profiling.SectionTimer()
    with timer.section("mri.test.outer"), timer.section("mri.test.inner"):
        torch.ones(8, 8).sum()
    assert entered == [] and timer.counts == {"mri.test.outer": 1, "mri.test.inner": 1}

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.section("mri.test.outer"):
            with timer.section("mri.test.inner"):
                torch.ones(8, 8).sum()
    assert entered == ["mri.test.outer", "mri.test.inner"]
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("mri.test."):
            spans[ev.name()] = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
    (o0, o1), (i0, i1) = spans["mri.test.outer"], spans["mri.test.inner"]
    assert o0 <= i0 <= i1 <= o1  # the parent holds its child
    assert timer.counts == {"mri.test.outer": 2, "mri.test.inner": 2}


def test_the_programs_spans_share_one_recorder():
    profiling.SPANS.reset()
    with profiling.span("mri.test.shared") as s:
        pass
    with profiling.span("mri.test.outer"), profiling.span("mri.test.shared"):
        pass
    assert profiling.SPANS.counts == {"mri.test.shared": 2, "mri.test.outer": 1}
    assert profiling.SPANS.sections["mri.test.shared"] >= s.seconds
    table = profiling.span_report().splitlines()
    assert table[0].split() == ["span", "seconds", "entries"]  # no share: spans nest
    assert {line.split()[0]: int(line.split()[-1]) for line in table[1:]} == profiling.SPANS.counts
    profiling.SPANS.reset()


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


def _online_sets():
    """A (train, validation) pair of online k-space sets of two 64 x 64
    volumes, remasked each epoch for training."""
    k = [synthetic.synthetic_kspace(v, 2, 64, 64, texture=0.2) for v in range(2)]
    stems = [synthetic.synthetic_stem(v) for v in range(2)]
    return (OnlineKspaceDataset.from_volumes(stems, k, max_slice_num=None, device="cpu"),
            OnlineKspaceDataset.from_volumes(stems[:1], k[:1], max_slice_num=0,
                                             remask_each_epoch=False, device="cpu"))


@pytest.mark.parametrize("device_data, online", [(False, False), (True, False), (True, True)],
                         ids=["host-batches", "device-data", "device-data-online"])
def test_train_cli_profile_dir_writes_a_trace(metadata, tmp_path, capsys, device_data, online):
    """``training.profile_dir`` traces the training epochs (not the initial
    losses) with torch.profiler, as the JAX train CLI does with
    jax.profiler: the trace holds the train step's backward and the
    program's spans (the epochs, their bookkeeping, the plain epoch loop of
    a device-resident epoch, an online set's materialisation); the CLI
    prints the spans' table. The online run takes a second epoch, whose
    new masks are drawn inside the trace."""
    prof_dir = tmp_path / "prof"
    epochs = 2 if online else 1
    sets = [f"data.train.dataset={metadata}", f"data.val.dataset={metadata}",
            "data.val.max_slice_num=0", "model.dim_hidden=64", "model.latent_dim=32",
            "model.num_layers=3", "training.batch_size=32", "training.save_interval=1000",
            f"training.epochs={epochs}", f"training.output_dir={tmp_path / 'out'}",
            f"training.profile_dir={prof_dir}", f"training.device_data={device_data}"]
    argv = ["--config", str(CONFIGS / "train.yaml"), "--device", "cpu"]
    trainer = cli_train.main(argv + [x for s in sets for x in ("--set", s)],
                             datasets=_online_sets() if online else None)
    assert trainer.state.step == epochs * -(-len(trainer.train_dataset) // 32)
    assert np.isfinite(trainer._progress[0]["train_loss"])
    (trace,) = prof_dir.glob("trace_*.json")
    names = {str(e.get("name", "")) for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("backward" in n.lower() for n in names)
    spans = {"mri.epoch.train", "mri.epoch.val", "mri.train.post_epoch"}
    if device_data:
        spans |= {"mri.epoch.call", "mri.epoch.perm", "mri.epoch.run", "mri.epoch.fetch"}
    if online:
        spans |= {"mri.data.materialize", "mri.data.masks", "mri.data.images"}
    assert spans <= names, spans - names
    out = capsys.readouterr().out
    table = out[out.index("host time by span"):].splitlines()[1:]
    counts = {line.split()[0]: int(line.split()[-1]) for line in table if line.startswith("mri.")}
    assert counts["mri.epoch.train"] == counts["mri.epoch.val"] == epochs
    assert spans <= set(counts)
