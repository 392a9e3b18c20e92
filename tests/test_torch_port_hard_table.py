"""The port's hard-corpus table (``python -m mri_inr_tpu_torch.cli.hard_table``)
and the protocol guard it shares with ``cli/quality_run`` and
``cli/results_run``, on the CPU at a tiny size: H=32, latent 16, L=2, 64x64
phantom slices, 2 / 1 / 1 volumes x 2 slices.

- The hard splits the runner builds (complex phase, SNR 32 dB noise,
  texture 0.18) equal the JAX package's ``process_volume`` on its own hard
  k-space, each drawing the same masks, within 2e-5 (the preprocessing
  bar).
- A hard call into a smooth root raises before any file changes, and the
  reverse; a matching call proceeds; an older root without
  ``protocol.json`` is taken as the smooth protocol with the counts its
  ``run_info.json`` records, gets its ``protocol.json`` and keeps its splits.
- The committed ``runs/results_hard`` files give the 12 JAX readings the
  port's rows pair with (``train_sin5`` with ``train_sin9``, ``residual_1200``
  with ``residual/eval1200``), with each side's training route, and the
  orderings ``RESULTS.md:118-148`` states hold on them.
- The smooth table re-renders from the committed ``rows.json``: equal to the
  committed ``TABLE.md`` byte for byte, and, without the route column and
  the rows added since, to the table as it was before the column.
- ``baseline``, ``residual`` and ``residual_1200`` run end to end at 2
  epochs (resumed to 3) and a second call skips every row; without its
  parent's run directory ``residual_1200`` fails naming it. With ``--seed
  1`` they run as ``<row>@seed1`` beside nothing else, ``training.seed=1``
  in each run, each held against its JAX hard row, and
  ``residual_1200@seed1`` resumes ``residual@seed1``'s run.
"""

import argparse
import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from mri_inr_tpu.data import preprocessing as jpre
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu_torch.cli import hard_table as ht
from mri_inr_tpu_torch.cli import quality_run as qr
from mri_inr_tpu_torch.cli import results_run as rr
from mri_inr_tpu_torch.data import dataset as tds
from mri_inr_tpu_torch.data import preprocessing as tpre
from mri_inr_tpu_torch.eval import metrics
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(1)

SCALE = ["--ae-epochs", "1", "--train-files", "2", "--val-files", "1", "--eval-files", "1",
         "--slices", "2", "--size", "64", "--device", "cpu"]
MODEL = ["--set", "model.dim_hidden=32", "--set", "model.latent_dim=16",
         "--set", "model.num_layers=2", "--set", "training.batch_size=32"]
TINY = ["--epochs", "2", "--resume-epochs", "3", *SCALE, *MODEL]
PREPROCESS_BAR = 2e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _rows(root):
    return {r["row"]: r for r in json.loads((root / "rows.json").read_text())}


def _files(root):
    return {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()}


# ------------------------------------------------------------ the hard splits
def test_hard_splits_match_jax_preprocessing(tmp_path):
    """Each split the runner builds holds the JAX package's preprocessing of
    its hard phantom volumes (seeds 0 / 1000 / 2000, the corpus flags of
    ``scripts/r5_hard_table.sh``), each package drawing its own masks (the
    same ``jax.random`` draws)."""
    masks = tpre.DEFAULT_MASKS
    args = ht.parse_args(["--root", str(tmp_path / "hard"), *SCALE])
    meta = rr.Protocol(args, tmp_path / "hard", torch.device("cpu")).splits("processed")
    counts = {"train": 2, "val": 1, "eval": 1}
    for split, seed in qr.SPLIT_SEEDS.items():
        h5 = jsyn.write_synthetic_h5(tmp_path / "h5" / split, num_files=counts[split],
                                     num_slices=2, height=64, width=64, seed=seed,
                                     phase=True, snr_db=32.0, texture=0.18)
        out = tmp_path / "jax" / split
        out.mkdir(parents=True)
        want = [row for path in h5 for row in jpre.process_volume(path, out, list(masks))]
        got = tds.read_metadata(meta[split])
        assert [r["slice_id"] for r in got] == [r["slice_id"] for r in want]
        cols = [c for c in got[0] if c.startswith("path_")]
        assert len(cols) == 3
        for g, w in zip(got, want):
            for c in cols:
                np.testing.assert_allclose(np.load(g[c]), np.load(w[c]), rtol=0,
                                           atol=PREPROCESS_BAR)
    info = json.loads((tmp_path / "hard" / "protocol.json").read_text())
    assert (info["phase"], info["snr_db"], info["texture"]) == (True, 32.0, 0.18)


def qr_args(root):
    """The smooth protocol's options at the tests' scale."""
    ap = argparse.ArgumentParser()
    qr.add_protocol_args(ap, str(root))
    return ap.parse_args(["--root", str(root), *SCALE, *MODEL])


def test_zero_filled_reading_matches_the_jax_pipeline(tmp_path):
    """The eval split's zero-filled PSNR, read through the port's split and
    metrics, equals the JAX package's preprocessing of the same volumes with
    the same masks (each package's own draw), each slice's PSNR from the
    port's metric."""
    args = ht.parse_args(["--root", str(tmp_path / "hard"), *SCALE])
    rr.Protocol(args, tmp_path / "hard", torch.device("cpu")).splits("processed")
    got = ht.zero_filled_readings(tmp_path / "hard", args, torch.device("cpu"))
    for corpus, flags in (("hard", ht.HARD), ("smooth", {})):
        h5 = jsyn.write_synthetic_h5(tmp_path / "h5" / corpus, num_files=1, num_slices=2,
                                     height=64, width=64, seed=qr.SPLIT_SEEDS["eval"], **flags)
        out = tmp_path / "jax" / corpus
        out.mkdir(parents=True)
        rows = jpre.process_volume(h5[0], out, [ht.ZERO_FILLED_MASK])
        col = tds.undersample_column(*ht.ZERO_FILLED_MASK)
        load = lambda c: torch.from_numpy(np.stack([np.load(r[c]) for r in rows]))
        want = metrics.psnr(load("path_fullysampled"), load(col)).double().numpy()
        assert got[corpus]["slices"] == 2
        for stat, v in (("mean", want.mean()), ("std", want.std()), ("min", want.min())):
            assert got[corpus][stat] == pytest.approx(v, abs=1e-3), (corpus, stat)


# ---------------------------------------------------------- the protocol guard
def test_hard_call_into_a_smooth_root_raises_before_touching_it(tmp_path):
    smooth = tmp_path / "smooth"
    proto = rr.Protocol(qr_args(smooth), smooth, torch.device("cpu"))
    proto.splits("processed")
    before = _files(smooth)
    with pytest.raises(ValueError, match="this call asks for") as exc:
        ht.main(["--root", str(smooth), "--rows", "baseline", *TINY])
    assert '"phase": false' in str(exc.value) and '"phase": true' in str(exc.value)
    assert _files(smooth) == before
    # the matching call proceeds: every row already there is skipped
    rr.main(["--root", str(smooth), "--rows", "", "--epochs", "2", *SCALE, *MODEL])
    assert _files(smooth) == before


def test_smooth_call_into_a_hard_root_raises(tmp_path):
    hard = tmp_path / "hard"
    ht.main(["--root", str(hard), "--rows", "", *TINY])
    protocol = json.loads((hard / "protocol.json").read_text())
    assert protocol == {**qr.protocol_of(qr_args(hard)), **ht.HARD}
    before = _files(hard)
    for call in (lambda: rr.main(["--root", str(hard), "--rows", "edge", "--epochs", "2",
                                  *SCALE, *MODEL]),
                 lambda: qr.main(["--root", str(hard), "--epochs", "2", *SCALE, *MODEL])):
        with pytest.raises(ValueError, match="this call asks for"):
            call()
    assert _files(hard) == before
    ht.main(["--root", str(hard), "--rows", "", *TINY])  # the same protocol proceeds
    # another scale under the same corpus raises too
    with pytest.raises(ValueError, match='"size": 64'):
        ht.main(["--root", str(hard), "--rows", "", *TINY[:-len(MODEL)], "--size", "32"])


def test_a_root_without_protocol_json_is_the_smooth_protocol_it_records(tmp_path,
                                                                        monkeypatch):
    """An older root (splits and ``run_info.json``, no ``protocol.json``):
    the smooth corpus with the counts ``run_info.json`` records, drawn by
    the earlier numpy and torch draws; a hard call raises, and so does a
    call of the JAX package's draws; a call of the earlier draws matches,
    writes its ``protocol.json`` and rebuilds nothing."""
    root = tmp_path / "legacy"
    qr.make_splits(root, qr_args(root), torch.device("cpu"))
    (root / "run_info.json").write_text(json.dumps({
        "epochs": 2, "ae_epochs": 1, "train_files": 2, "val_files": 1, "eval_files": 1,
        "slices_per_file": 2, "image_size": 64}))
    before = _files(root)
    with pytest.raises(ValueError, match="this call asks for"):
        ht.main(["--root", str(root), "--rows", "", *TINY])
    assert _files(root) == before
    with pytest.raises(ValueError, match='"draws": "jax"'):
        qr.guard_protocol(root, qr_args(root))
    assert _files(root) == before
    with pytest.raises(ValueError, match='"draws": "torch"'):
        rr.main(["--root", str(root), "--rows", "edge", "--epochs", "2", *SCALE, *MODEL])
    rr.main(["--root", str(root), "--rows", "", "--epochs", "2", *SCALE, *MODEL])  # builds nothing
    assert _files(root) == before
    assert qr._legacy_protocol(root) == {**qr.protocol_of(qr_args(root)), "draws": "torch",
                                         "module_dropout": "hash"}
    monkeypatch.setattr(qr, "DRAWS", "torch")
    monkeypatch.setattr(qr, "MODULE_DROPOUT", "hash")
    assert qr.guard_protocol(root, qr_args(root)) == qr.protocol_of(qr_args(root))
    assert json.loads((root / "protocol.json").read_text()) == qr.protocol_of(qr_args(root))
    assert {p: t for p, t in _files(root).items() if p.name != "protocol.json"} == before


def test_the_guard_keeps_hash_and_flax_module_dropout_apart(tmp_path, monkeypatch):
    """A root of the JAX package's draws whose ``protocol.json`` predates the
    module dropout (``runs/results_torch_jaxdraw``'s) reads as the
    ``"hash"`` dropout: a call that builds rows there raises naming it, a
    render-only call does not; a ``"flax"`` root refuses a ``"hash"`` call
    in turn. No file changes on a refusal."""
    for committed in ("runs/results_torch_jaxdraw", "runs/results_hard_torch_jaxdraw"):
        assert qr.root_protocol(REPO / committed)["module_dropout"] == "hash"
    old = tmp_path / "jaxdraw"
    old.mkdir()
    legacy = {k: v for k, v in qr.protocol_of(qr_args(old)).items() if k != "module_dropout"}
    (old / "protocol.json").write_text(json.dumps(legacy))
    before = _files(old)
    with pytest.raises(ValueError, match='"module_dropout": "hash"'):
        qr.guard_protocol(old, qr_args(old))
    with pytest.raises(ValueError, match='"module_dropout": "flax"'):
        rr.main(["--root", str(old), "--rows", "residual", "--epochs", "2", *SCALE, *MODEL])
    assert _files(old) == before
    qr.guard_protocol(old, qr_args(old), building=False)  # a render-only call
    assert _files(old) == before

    new = tmp_path / "flaxdrop"
    assert qr.guard_protocol(new, qr_args(new))["module_dropout"] == "flax"
    assert json.loads((new / "protocol.json").read_text())["module_dropout"] == "flax"
    before = _files(new)
    monkeypatch.setattr(qr, "MODULE_DROPOUT", "hash")
    with pytest.raises(ValueError, match='"module_dropout": "flax"'):
        qr.guard_protocol(new, qr_args(new))
    assert _files(new) == before


@pytest.mark.parametrize("root", ["runs/quality_torch", "runs/results_torch"])
def test_committed_smooth_roots_hold_the_default_protocol(root):
    """The committed roots of the smooth protocol: their ``protocol.json``,
    or for a root built before it, what the guard takes them to hold, is
    the default smooth protocol of the earlier numpy and torch draws and of
    the module path's counter-hash dropout."""
    have = qr.root_protocol(REPO / root)
    assert have == {**qr.default_protocol(), "draws": "torch", "module_dropout": "hash"}
    assert have == {"phase": False, "snr_db": None, "texture": 0.0, "size": 256, "slices": 4,
                    "train_files": 24, "val_files": 4, "eval_files": 12, "ae_epochs": 30,
                    "draws": "torch", "module_dropout": "hash"}
    assert qr.default_protocol()["draws"] == "jax"
    assert qr.default_protocol()["module_dropout"] == "flax"


# ------------------------------------------------------------- the JAX rows
def test_pairing_reads_twelve_jax_hard_rows():
    jax_rows = ht.TABLE.jax()
    readings = {port: jax_rows[j] for port, j in ht.PAIRS.items()}
    assert len(readings) == 12 and list(ht.PAIRS) == list(readings)
    assert ht.PAIRS["train_sin5"] == "train_sin9" and ht.PAIRS["baseline"] == "baseline"
    means = lambda r: tuple(r[m]["mean"] for m in ("PSNR", "SSIM", "NRMSE"))
    assert means(readings["residual_1200"]) == (22.4000, 0.6811, 0.2385)
    assert means(readings["baseline"]) == (27.7377, 0.7974, 0.1291)
    assert means(readings["train_sin5"]) == (27.7556, 0.7968, 0.1284)
    assert means(readings["online_remask"]) == (27.7474, 0.8017, 0.1278)
    assert readings["residual"]["PSNR"]["mean"] == 20.7662
    assert readings["baseline"]["SSIM"]["min"] == 0.7204
    routes = {port: r["route"] for port, r in readings.items()}
    assert {k for k, v in routes.items() if v == "module"} == {
        "vgg", "perceptual", "residual", "residual_1200"}


def test_jax_hard_orderings_hold():
    jax_rows = ht.TABLE.jax()
    reads = ht.hard_orderings({port: jax_rows[j] for port, j in ht.PAIRS.items()})
    assert len(reads) == 9
    assert all(ok for _, _, ok in reads), [r for r in reads if not r[2]]


def test_smooth_table_rerenders_unchanged_but_for_routes_and_new_rows():
    root = REPO / "runs" / "results_torch"
    rows = json.loads((root / "rows.json").read_text())
    jax_rows = rr.SMOOTH.jax()
    assert rr.render(rows, jax_rows) == (root / "TABLE.md").read_text()
    old = (pathlib.Path(__file__).parent / "data"
           / "results_torch_table_without_routes.md").read_text()
    old_rows = {ln.split("|")[1].strip() for ln in old.split("## Orderings")[0].splitlines()
                if ln.startswith("| ") and not ln.startswith("| Row ")}
    text = rr.render([r for r in rows if r["row"] in old_rows], jax_rows)
    head, rest = text.split("\n## Orderings", 1)
    route = head.splitlines()[4].split("|").index(" Route (port / JAX) ")
    stripped = ["|".join(c for i, c in enumerate(ln.split("|")) if i != route)
                if ln.startswith("|") else ln for ln in head.splitlines()]
    assert "\n".join(stripped) + "\n\n## Orderings" + rest == old


def test_render_states_each_sides_route(tmp_path):
    rows = [{"row": name, "jax_row": jax, "slices": 48, "device": "fixture card",
             "train_overrides": list(overrides),
             "stage_seconds": {"train": 1.0},
             **{m: {"mean": 1.0, "std": 0.0, "min": 1.0, "max": 1.0}
                for m in ("PSNR", "SSIM", "NRMSE")}}
            for name, jax, overrides in [
                ("vgg", "vgg", rr.ROWS["vgg"].train),
                ("vgg_frozen_rand_module", "vgg_frozen_rand",
                 rr.ROWS["vgg_frozen_rand_module"].train),
                ("residual", "residual", rr.ROWS["residual"].train)]]
    line = {ln.split("|")[1].strip(): ln.split("|")[3].strip()
            for ln in rr.render(rows, rr.SMOOTH.jax()).splitlines()
            if ln.startswith("| ") and "JAX row" not in ln and "Reads" not in ln}
    assert line["vgg"] == "fused / module"
    assert line["vgg_frozen_rand_module"] == "module / module"
    assert line["residual"] == "module / module"
    assert rr.route(["model.use_pallas=false", "training.use_pallas=true"]) == "fused"
    assert rr.route(["--set", "training.use_pallas=False"]) == "module"


# ------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def hard_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("hard") / "rows"
    ht.main(["--root", str(root), "--rows", "baseline,residual,residual_1200", "--render",
             *TINY])
    return root


def test_rows_run_end_to_end(hard_root):
    rows = _rows(hard_root)
    assert list(rows) == ["baseline", "residual", "residual_1200"]
    for name, r in rows.items():
        assert r["slices"] == 2 and r["device"] == "cpu", name
        assert r["jax_row"] == ht.PAIRS[name], name
        assert r["corpus"] == json.loads((hard_root / "protocol.json").read_text()), name
        assert (r["corpus"]["phase"], r["corpus"]["snr_db"], r["corpus"]["texture"]) \
            == (True, 32.0, 0.18)
        for m in ("PSNR", "SSIM", "NRMSE"):
            assert all(np.isfinite(r[m][k]) for k in ("mean", "std", "min", "max")), name
        assert json.loads((hard_root / name / "run_info.json").read_text()) == r
    assert rr.route(rows["residual"]["train_overrides"]) == "module"
    assert rr.route(rows["baseline"]["train_overrides"]) == "fused"
    assert "training.sin5=false" not in rows["baseline"]["train_overrides"]


def test_residual_1200_resumes_the_residual_run(hard_root):
    rows = _rows(hard_root)
    resumed, parent = rows["residual_1200"], rows["residual"]
    run_dir = pathlib.Path(resumed["run_dir"])
    assert resumed["run_dir"] == parent["run_dir"] and resumed["resumes_row"] == "residual"
    assert (resumed["epochs"], resumed["resumed_from_epochs"], parent["epochs"]) == (3, 2, 2)
    assert "training.continue_training=true" in resumed["train_overrides"]
    assert (hard_root / "residual" / "eval1200" / "metrics_summary.txt").is_file()
    assert resumed["eval_dir"].endswith("residual/eval1200")
    assert ckpt_lib.find_latest_step(run_dir) == 3 * 2  # 64 patches at batch 32
    epochs = lambda f: [ln.split(",")[0] for ln in (run_dir / f).read_text().splitlines()[1:]]
    assert epochs("progress_log.csv") == ["2"]
    assert epochs("progress_log_to2.csv") == ["0", "1"]
    assert resumed["PSNR"]["mean"] != parent["PSNR"]["mean"]


def test_render_writes_the_hard_table(hard_root):
    table = (hard_root / "TABLE.md").read_text()
    assert "SSIM min (port / JAX)" in table and "## Orderings (`RESULTS.md:118-148`)" in table
    lines = {ln.split("|")[1].strip(): ln for ln in table.splitlines() if ln.startswith("| ")}
    assert "| baseline | baseline | fused / fused |" in lines["baseline"]
    assert "| residual_1200 | residual_1200 | module / module |" in lines["residual_1200"]
    assert "/ 0.7204 |" in lines["baseline"]  # the JAX hard baseline's SSIM minimum
    assert lines["residual more than 3 dB below baseline (PSNR)"].endswith("| -6.9715 dB | yes |")
    # a diverged row orders nothing: the reads that need it say so
    nan = {m: {"mean": float("nan")} for m in ("PSNR", "SSIM", "NRMSE")}
    reads = {what: vals for what, vals, _ in ht.hard_orderings(
        {"baseline": _rows(hard_root)["baseline"], "vgg": nan})}
    assert "vgg ~= baseline (PSNR within 0.3 dB)" not in reads
    readings = json.loads((hard_root / "zero_filled.json").read_text())
    assert readings["hard"]["slices"] == readings["smooth"]["slices"] == 2
    # the hard corpus lowers the zero-filled floor (RESULTS.md:98-100: 21.7 -> 16.9 dB)
    assert readings["hard"]["min"] < readings["smooth"]["min"]
    assert "| hard | 2 |" in table and "| smooth | 2 |" in table


def test_second_call_skips_every_row(hard_root, capsys):
    before = (hard_root / "rows.json").read_bytes()
    capsys.readouterr()
    ht.main(["--root", str(hard_root), "--rows", "baseline,residual,residual_1200", *TINY])
    out = capsys.readouterr().out
    assert out.count("skipped") == 3 and "epoch" not in out
    assert (hard_root / "rows.json").read_bytes() == before


def test_resumed_row_without_its_parent_fails_naming_the_directory(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        ht.main(["--root", str(tmp_path / "h"), "--rows", "residual_1200", *TINY])
    assert exc.value.code == "hard_table: rows failed: residual_1200"
    err = capsys.readouterr().err
    assert f"{tmp_path / 'h' / 'residual'} holds no checkpoint" in err
    assert not (tmp_path / "h" / "rows.json").exists()


def test_seed_rows_are_named_seeded_and_resume_their_own_parent(tmp_path):
    root = tmp_path / "h"
    ht.main(["--root", str(root), "--seed", "1", "--rows", "baseline,residual,residual_1200",
             *TINY])
    rows = _rows(root)
    assert list(rows) == ["baseline@seed1", "residual@seed1", "residual_1200@seed1"]
    for name in ("baseline", "residual", "residual_1200"):
        r = rows[f"{name}@seed1"]
        assert (r["base_row"], r["seed"], r["jax_row"]) == (name, 1, ht.PAIRS[name])
        assert "training.seed=1" in r["train_overrides"], name
        run_dir = pathlib.Path(r["run_dir"])
        assert run_dir.parent == root / ("residual@seed1" if name == "residual_1200"
                                         else f"{name}@seed1")
        assert yaml.safe_load((run_dir / "config.yaml").read_text())["training"]["seed"] == 1
        assert json.loads((root / f"{name}@seed1" / "run_info.json").read_text()) == r
        assert all(np.isfinite(r[m]["mean"]) for m in ("PSNR", "SSIM", "NRMSE")), name
    resumed, parent = rows["residual_1200@seed1"], rows["residual@seed1"]
    assert resumed["run_dir"] == parent["run_dir"]
    assert resumed["resumes_row"] == "residual@seed1"
    assert resumed["eval_dir"].endswith("residual@seed1/eval1200")
    assert (root / "residual@seed1" / "eval1200" / "metrics_summary.txt").is_file()
    assert ckpt_lib.find_latest_step(pathlib.Path(parent["run_dir"])) == 3 * 2
