"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: ``mri_inr_tpu_torch`` is not ``mri_inr_tpu``), and the plain
reference loads nothing of the program."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "orbax", "mri_inr_tpu"]


def loaded_after(imports: list[str]) -> set[str]:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import {m}\n" for m in imports)
            + "import json; print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("modules", [
    ["perfbench.core.harness", "perfbench.core.drive", "perfbench.core.trace",
     "perfbench.control", "perfbench.drivers.train", "perfbench.drivers.sweep",
     "mri_inr_tpu_torch.cli.train", "mri_inr_tpu_torch.eval.evaluate",
     "mri_inr_tpu_torch.data.online"],
    ["perfbench.reference.model", "perfbench.reference.data", "perfbench.reference.train",
     "perfbench.reference.threefry"],
])
def test_no_jax(modules):
    assert not loaded_after(modules) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    got = loaded_after(["perfbench.reference.model", "perfbench.reference.data",
                        "perfbench.reference.train", "perfbench.reference.threefry"])
    assert "mri_inr_tpu_torch" not in got


def test_metric_readers_load_no_jax():
    names = [p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")]
    code = ("import sys; sys.path.insert(0, %r)\nfrom perfbench.core import harness\n"
            "for n in %r: harness.metric_reader(n)\n"
            "import json; print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))"
            % (str(ROOT), [n for n in names if not n.startswith("_")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & set(FORBIDDEN)


def test_no_benchmark_file_of_the_jax_package_is_read():
    for path in (ROOT / "perfbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert not re.search(r"\bbench\.py|BENCH_\w*\.json|\bbenchmarks/", path.read_text()), path
