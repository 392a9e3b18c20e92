"""Boundaries of the port: it imports no JAX and nothing of the JAX package,
its entry points refuse to run on the CPU unless asked, and its own copies
of numpy helpers give the JAX package's results."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mri_inr_tpu.data import dataset as jds
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.preprocessing import undersample_column as jax_undersample_column
from mri_inr_tpu_torch.data import dataset as tds
from mri_inr_tpu_torch.data import synthetic as tsyn
from mri_inr_tpu_torch.eval.evaluate import SliceReconstructor
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.cli import preprocess as cli_preprocess
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.data import preprocessing as tpre
from mri_inr_tpu_torch.ops import siren_kernel
from mri_inr_tpu_torch.utils.device import resolve_device

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "mri_inr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mri_inr_tpu")

IMPORT_ALL = """
import importlib, pkgutil, sys
import mri_inr_tpu_torch as pkg

for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("mri_inr_tpu_torch")]))
"""


def test_importing_the_port_loads_no_jax():
    code = IMPORT_ALL.format(forbidden=set(FORBIDDEN))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


BLOCKED_IMPORT = """
import sys

sys.modules["h5py"] = sys.modules["matplotlib"] = None  # importing either now raises
import importlib, pkgutil
import mri_inr_tpu_torch as pkg
import mri_inr_tpu_torch.data.preprocessing

for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
assert not any(m.split(".")[0] in ("h5py", "matplotlib") and sys.modules[m] is not None
               for m in sys.modules)

import numpy as np, tempfile
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.utils import visualization
assert not visualization.have_matplotlib()
with tempfile.TemporaryDirectory() as d:
    rows = preprocessing.process_kspace_volume(
        synthetic.synthetic_kspace(0, 2, 32, 32), "file_brain_AXFLAIR_000000", d,
        device="cpu")
    assert len(rows) == 2
    try:
        preprocessing.load_h5(d + "/x.h5")
    except ImportError:
        print("ok")
"""


def test_port_imports_and_preprocesses_without_h5py_and_matplotlib():
    """``h5py`` and ``matplotlib`` are imported inside the functions that need
    them: every module imports, and a k-space array is preprocessed, on a
    machine that has neither."""
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_the_source_checks_cover_the_parallel_modules():
    """``parallel/*.py`` and ``utils/tensorboard.py`` are among the files
    the two import checks above walk (``PACKAGE.rglob``, ``walk_packages``)."""
    import pkgutil

    import mri_inr_tpu_torch as pkg

    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for name in ("parallel", "parallel.distributed", "parallel.mesh", "parallel.halo_fold",
                 "utils.tensorboard"):
        assert f"mri_inr_tpu_torch.{name}" in walked, name
        assert PACKAGE / (name.replace(".", "/") + ".py") in set(PACKAGE.rglob("*.py")) or \
            PACKAGE / name / "__init__.py" in set(PACKAGE.rglob("*.py")), name


def test_only_the_interop_tool_imports_jax_and_it_is_outside_the_package():
    """Of the files the port added (the package, ``chip_smoke.py``, the
    ``scripts/torch_*.py`` tools and the tests' rank helper), the
    checkpoint interop tool alone imports JAX, and it lives in ``scripts/``;
    the rank helper, which the card's machine runs, imports none."""
    added = (sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "tests" / "torch_port_ranks.py"])
    importing = [p.relative_to(ROOT).as_posix() for p in added
                 if any(m.split(".")[0] in FORBIDDEN for m in _imports(p))]
    assert importing == ["scripts/torch_checkpoint_interop.py"]
    assert not (ROOT / "scripts" / "torch_checkpoint_interop.py").is_relative_to(PACKAGE)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        ModulatedSiren(dim_hidden=64, latent_dim=32, num_layers=3)
    with pytest.raises(RuntimeError):
        SliceReconstructor(lambda tiles: tiles)
    model = ModulatedSiren(dim_hidden=64, latent_dim=32, num_layers=3, device="cpu")
    with pytest.raises(RuntimeError):
        siren_kernel.make_apply_fn(model)
    assert resolve_device("cpu") == torch.device("cpu")


def test_new_entry_points_raise_without_cuda(no_cuda, tmp_path):
    k = tsyn.synthetic_kspace(0, 1, 32, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpre.process_kspace_volume(k, "stem", tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_preprocess.main(["--path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_test.main(["--set", f"data.dataset={tmp_path}/metadata.csv"])


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        siren_kernel.siren_forward_cuda(torch.zeros(2, 3 * 64), torch.zeros(576, 64),
                                        torch.zeros(2, 64, 64), torch.zeros(2, 1, 64),
                                        torch.zeros(1, 1), num_layers=3)


def test_own_copies_match_the_jax_package():
    for seed in (0, 7):
        np.testing.assert_array_equal(tsyn.phantom_volume(seed, 3, 64, 48, texture=0.3),
                                      jsyn.phantom_volume(seed, 3, 64, 48, texture=0.3))
    assert tds.undersample_column(0.05, 6) == jax_undersample_column(0.05, 6)
    assert tds.sampler_order(50, 42, 10) == jds.sampler_order(50, 42, 10)
