#!/usr/bin/env python3
"""Where the SIREN forward kernels' time goes: build one of their CUDA
sources as it is and with named parts cut out, and time each build at its
main path's shape, on one card.

    python3 scripts/torch_fwd_cut_probe.py SOURCE CUT [CUT ...]
    python3 scripts/torch_fwd_cut_probe.py SOURCE --trace

SOURCE is ``mri_inr_tpu_torch/ops/csrc/siren_forward.cu`` (the eval
forward, timed at B=1024, S=576, H=256, L=5 with the eval default's degree-5
hidden and degree-7 output sines), ``.../siren_train_fwd.cu`` (the train
forward, B=400, dropout 0.1, degree-5 sines), both built on
``siren_fwd.cuh``, or ``.../siren_forward_int8.cu`` (the int8 eval forward,
B=1024, degree-9 sines), which keeps its own copy of that block. The cuts
are text substitutions in a copy of ``csrc/`` (a cut whose text is missing
stops the script):

- ``products``: the wgmma instructions (the ring is still filled and waited
  on, the accumulators keep what they hold);
- ``weight-loads``: the producer's TMA loads of the weight slabs (each stage
  is marked full at once; the products read whatever the ring holds);
- ``sines``: the hidden sine polynomials, range reduction included
  (identity);
- ``epilogue``: every epilogue: the accumulators are packed back to bf16 (the
  last layer summed) untouched; in the int8 kernel, packed as they are into
  the next A fragments;
- ``fma-floor``: not a cut but a variant: the range reduction's ``floorf``
  replaced by an exact floor on the FMA pipe, ``r = (y + 1.5 * 2^23) - 1.5 *
  2^23``, less one where ``r > y`` (exact for ``|y| < 2^22``; the variant
  does not handle larger ``|y|``); the bf16 kernels only;
- ``cvt-unit``: a variant of the int8 kernel: its exact conversions on the
  FMA pipe (int32 to float, the quantising floor to int8) replaced by the
  conversion unit's ``I2F`` and ``F2I`` (the same values);
- ``unit-w0``: a variant of the int8 kernel without the multiply by w0 in
  the hidden sines (the same values at the probe's w0 = 1).

``--trace`` builds the source with ``-DSIREN_FWD_TRACE``: the first thread
of each consumer warpgroup of each block marks ``clock64`` at each tile's
start, after its modulations and x_0, and, for every layer, before and after
waiting for its turn at the tensor cores, after issuing its products (the
ring's full-barrier waits included), after they complete, and after its
epilogue. It prints the mean cycles of each segment over the first tiles of
every consumer.

Times are CUDA-event medians of 20 calls of the port's wrapper, taken in
turns (as is, each cut, each cut again, as is), with the card's name and
power limit beside them. Cut builds compute wrong outputs; only their times
mean anything. Needs the CUDA toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mri_inr_tpu_torch.models import modulated_siren as ms  # noqa: E402
from mri_inr_tpu_torch.ops import _build  # noqa: E402
from mri_inr_tpu_torch.ops import siren_kernel as sk  # noqa: E402
from mri_inr_tpu_torch.ops import siren_train_kernel as stk  # noqa: E402

LAYERS, HIDDEN, SIREN = 5, 256, 24
HEADER, COMMON = "siren_fwd.cuh", "siren_common.cuh"
# cut -> [(file, pattern, replacement)]; "SOURCE" is the .cu given
CUTS = {
    "products": [(HEADER, r"wgmma_rs<H>\(acc,[^;]*;", ";")],
    "weight-loads": [(HEADER, r"mbar_expect_tx\(&full\[st\], G::STAGE\);",
                      "mbar_arrive(&full[st]);"),
                     (HEADER, r"for \(int q = 0; q < KB; \+\+q\)\s*tma_load_2d\([^;]*;", "")],
    "sines": [("SOURCE", r"hidden_sin<MODE>\(|poly_sin<DEG>\(", "(")],
    "epilogue": [(HEADER, r"xa\[m\] = pack_bf16\(epi\.hidden\([^;]*;",
                  "xa[m] = pack_bf16(acc[2 * m], acc[2 * m + 1]);"),
                 (HEADER, r"part\[m & 1\] \+= epi\.last\([^;]*;",
                  "part[m & 1] += acc[2 * m] + acc[2 * m + 1];")],
    "fma-floor": [(COMMON, r"float k = floorf\(([^;]*)\);",
                   r"float k = __fsub_rn(__fadd_rn(\1, 12582912.f), 12582912.f);\n"
                   r"  k = k > (\1) ? __fsub_rn(k, 1.f) : k;")],
}
# the same cuts in siren_forward_int8.cu
INT8 = "siren_forward_int8.cu"
INT8_CUTS = {
    "products": [("SOURCE", r"wgmma_rs_s8<H>\(acc,[^;]*;", ";")],
    "weight-loads": [("SOURCE", r"mbar_expect_tx\(&full\[st\], G::STAGE\);",
                      "mbar_arrive(&full[st]);"),
                     ("SOURCE", r"tma_load_2d\(ring[^;]*;", ";")],
    "sines": [("SOURCE", r"sin9\(w0 \* pre\)", "(w0 * pre)")],
    "cvt-unit": [("SOURCE", r"const float a = __fsub_rn\(__int_as_float\(acc \+ MAGIC_I\), MAGIC_F\);",
                  "const float a = (float)acc;"),
                 ("SOURCE", r"return __float_as_uint\(__fadd_rd\(([^;]*), MAGIC_F\)\);",
                  r"return (uint32_t)(int)floorf(\1);")],
    "unit-w0": [("SOURCE", r"sin9\(w0 \* pre\)", "sin9(pre)")],
    "epilogue": [("SOURCE", r"xa\[4 \* kk \+ h \+ 2 \* u\] = pack4\([^;]*;",
                  "xa[4 * kk + h + 2 * u] = pack4(acc[i], acc[i + 1], acc[i + 4], acc[i + 5]);"),
                 ("SOURCE", r"const float s0 = activation[^;]*;\s*const float s1 = activation[^;]*;"
                  r"\s*part\[h\] \+=[^;]*;",
                  "part[h] += (float)(acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1]);")],
}
TRACE_BLOCKS, TRACE_MARKS = 256, 256  # as siren_fwd.cuh


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def build(src: pathlib.Path, out_dir: pathlib.Path, name: str, cut: str | None) -> ctypes.CDLL:
    """A copy of csrc/ with the cut applied, compiled into lib<name>.so."""
    tree = out_dir / name
    shutil.copytree(src.parent, tree)
    for fname, pattern, repl in (INT8_CUTS if src.name == INT8 else CUTS).get(cut, []):
        path = tree / (src.name if fname == "SOURCE" else fname)
        text, n = re.subn(pattern, repl, path.read_text())
        if n == 0:
            raise SystemExit(f"{path.name}: cut {cut}: no match for {pattern!r}")
        path.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), "-O3", "-std=c++17", "-gencode", _build.ARCH, "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(tree / src.name)]
    if cut == "--trace":
        cmd.insert(1, "-DSIREN_FWD_TRACE")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def target(src: pathlib.Path, dev):
    """(kernel name, batch, the wrapper's module, the name of its library
    loader, a call of the wrapper at the main path's shape)."""
    train = src.name == "siren_train_fwd.cu"
    batch = 400 if train else 1024
    g = torch.Generator().manual_seed(1)
    if src.name == INT8:
        model = ms.ModulatedSiren(dim_hidden=HIDDEN, latent_dim=HIDDEN, num_layers=LAYERS,
                                  generator=g, device=dev).eval()
        tiles = torch.rand((batch, 32, 32), generator=g).to(dev)
        with torch.no_grad():
            kp = sk.extract_kernel_params(model, ms.coordinate_grid(SIREN, dev))
            ikp = sk.quantize_kernel_params(model, kp)
            fq, gd, ls = sk.compute_quant_factors(kp, ikp, model.encode(tiles),
                                                  num_layers=LAYERS)
        args = (fq.contiguous(), gd.contiguous(), ls, ikp.base, ikp.swq, ikp.s_b, ikp.last_w,
                ikp.last_b)
        return "siren_forward_int8", batch, sk, "_library_int8", \
            lambda: sk.siren_forward_int8_cuda(*args, num_layers=LAYERS, swq_t=ikp.swq_t)
    model = ms.ModulatedSiren(dim_hidden=HIDDEN, latent_dim=HIDDEN, num_layers=LAYERS,
                              dropout=0.1, generator=g, device=dev)
    tiles = torch.rand((batch, 32, 32), generator=g).to(dev)
    with torch.no_grad():
        kp = sk.extract_kernel_params(model, ms.coordinate_grid(SIREN, dev))
        mods = sk.compute_modulations(kp, model.encode(tiles), num_layers=LAYERS)
    s_wt = kp.s_w.transpose(1, 2).contiguous()
    if train:
        args = (torch.tensor([1234.0], device=dev), mods.contiguous(), kp.base, kp.s_w,
                kp.s_b, kp.last_w, kp.last_b)
        kw = dict(num_layers=LAYERS, dropout_rate=0.1, sin5=True, s_wt=s_wt)
        return "siren_train_fwd", batch, stk, "_fwd_library", \
            lambda: stk.siren_chain_train_fwd_cuda(*args, **kw)
    cut = (LAYERS - 1) * HIDDEN
    mods = torch.cat([mods[:, :cut], mods[:, cut:] * kp.last_w], 1).contiguous()
    args = (mods, kp.base, kp.s_w, kp.s_b, kp.last_b)
    kw = dict(num_layers=LAYERS, sin7=True, sin5=True, s_wt=s_wt)
    return "siren_forward", batch, sk, "_library", lambda: sk.siren_forward_cuda(*args, **kw)


def bind(module, loader: str, lib, call):
    """The port's wrapper, pointed at this build."""
    real = module._build.load
    module._build.load = lambda name: lib
    try:
        configured = getattr(module, loader).__wrapped__()  # argument types as the port sets them
    finally:
        module._build.load = real

    def run():
        setattr(module, loader, lambda: configured)
        call()

    return run


def median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def trace(src: pathlib.Path, card: str) -> int:
    import numpy as np

    dev = torch.device("cuda")
    name, batch, module, loader, call = target(src, dev)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(src, pathlib.Path(tmp), "fwd_trace", "--trace")
        run = bind(module, loader, lib, call)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (TRACE_BLOCKS * 2 * TRACE_MARKS))()
        lib.siren_fwd_trace_copy.argtypes = [ctypes.c_void_p]
        if lib.siren_fwd_trace_copy(buf):
            raise SystemExit("siren_fwd_trace_copy failed")
    t = np.frombuffer(buf, dtype=np.int64).reshape(TRACE_BLOCKS * 2, TRACE_MARKS).astype(float)
    per_tile = 2 + 5 * (LAYERS - 1)
    tiles = TRACE_MARKS // per_tile
    rows = t[(t[:, per_tile * tiles - 1] > 0)]  # consumers that marked `tiles` whole tiles
    if len(rows) == 0:
        raise SystemExit("no consumer marked a whole run of tiles")
    marks = rows[:, :per_tile * tiles].reshape(len(rows), tiles, per_tile)
    seg = {"modulations + x_0": marks[:, :, 1] - marks[:, :, 0]}
    for i in range(LAYERS - 1):
        a = 2 + 5 * i
        seg[f"layer {i}: wait for the turn"] = marks[:, :, a + 1] - marks[:, :, a]
        seg[f"layer {i}: ring waits + issue"] = marks[:, :, a + 2] - marks[:, :, a + 1]
        seg[f"layer {i}: products complete"] = marks[:, :, a + 3] - marks[:, :, a + 2]
        seg[f"layer {i}: epilogue"] = marks[:, :, a + 4] - marks[:, :, a + 3]
    whole = np.diff(marks[:, :, 0], axis=1)  # tile start to the next tile's start
    print(f"{name} consumer timeline at B={batch} ({len(rows)} consumers, first {tiles} "
          f"tiles each, clock64 cycles): {whole.mean():.0f} cycles a tile (tile start to "
          f"the next) [{card}]")
    total = sum(v.mean() for v in seg.values())
    for key, v in seg.items():
        print(f"  {key:34s} mean {v.mean():8.0f}  max {v.max():8.0f}  "
              f"({v.mean() / total:6.1%} of the marked time)")
    first, later = seg["layer 1: epilogue"][:, 0].mean(), seg["layer 1: epilogue"][:, 1:].mean()
    print(f"  layer 1 epilogue, first tile {first:.0f} cycles against {later:.0f} after it")
    for kind in ("wait for the turn", "ring waits + issue", "products complete", "epilogue"):
        s = sum(v.mean() for k, v in seg.items() if k.endswith(kind))
        print(f"  all layers, {kind:20s} {s:8.0f} cycles a tile ({s / total:6.1%})")
    return 0


def main() -> int:
    if len(sys.argv) < 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    src = pathlib.Path(sys.argv[1]).resolve()
    if src.name not in ("siren_forward.cu", "siren_train_fwd.cu", INT8):
        raise SystemExit(f"{src.name}: this probe takes siren_forward.cu, siren_train_fwd.cu "
                         f"or {INT8}")
    card = card_line()
    cuts = sys.argv[2:]
    if cuts == ["--trace"]:
        return trace(src, card)
    known = INT8_CUTS if src.name == INT8 else CUTS
    unknown = [c for c in cuts if c not in known]
    if unknown:
        raise SystemExit(f"unknown cut(s) {unknown}; known: {sorted(known)}")
    dev = torch.device("cuda")
    name, batch, module, loader, call = target(src, dev)
    with tempfile.TemporaryDirectory() as tmp:
        keys = ["as is", *cuts]
        with ThreadPoolExecutor(len(keys)) as pool:  # one nvcc per build, all at once
            libs = list(pool.map(lambda k: build(src, pathlib.Path(tmp), f"fwd{keys.index(k)}",
                                                 None if k == "as is" else k), keys))
        runs_of = {k: bind(module, loader, lib, call) for k, lib in zip(keys, libs)}
        runs = {k: [] for k in keys}
        for key in ["as is", *cuts, *cuts, "as is"]:
            runs[key].append(median_ms(runs_of[key]))
    for key, ms_ in runs.items():
        label = "as is" if key == "as is" else f"{key} cut"
        print(f"{name} ({label}) at B={batch}: {' / '.join(f'{t:.4f}' for t in ms_)} ms/call "
              f"(median of 20, two turns) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
