"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
into ``_build/lib<name>.so`` (listed in ``.gitignore``), again whenever the
source or a ``csrc/*.cuh`` header it includes is newer than the library, then
loaded with ``ctypes``. No PyTorch
headers and no ``ninja`` are involved, so a build takes seconds. A failed
build raises; nothing falls back to the plain PyTorch versions.

``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

SRC_DIR = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes by name
    (``#include "x.cuh"``), headers of headers too."""
    found, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            if (SRC_DIR / inc).is_file():
                todo.append(SRC_DIR / inc)
    return found


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` if the library is missing or older than the
    source or one of its headers. Returns the library's path and the
    compiler's output (ptxas register / shared-memory report; empty when
    nothing was rebuilt)."""
    src = SRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in sources(name))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cuda_lib = pathlib.Path(nvcc).resolve().parent.parent / "lib64"
    # write next to the target and rename, so a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc, "-O3", "-std=c++17", "-gencode", ARCH, "-shared",
        "-Xcompiler", "-fPIC", "--cudart", "shared", "-Xptxas", "-v",
        "-Xlinker", f"-rpath,{cuda_lib}", "-o", tmp, str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed building {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>.so`` (once per process)."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
