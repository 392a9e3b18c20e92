#!/usr/bin/env python3
"""Where the SIREN training backward's time goes: build its CUDA source as it
is and with named parts cut out, and time each build at the training shape,
on one card.

    python3 scripts/torch_bwd_cut_probe.py SOURCE CUT [CUT ...]
    python3 scripts/torch_bwd_cut_probe.py SOURCE --trace

SOURCE is a ``siren_train_bwd.cu`` whose C entry point matches the one the
port's wrapper (``mri_inr_tpu_torch/ops/siren_train_kernel.py``) calls, or,
for the cut ``old-dw-atomics``, the first one-kernel design of that file
(keep a copy with ``git show <commit>:mri_inr_tpu_torch/ops/csrc/
siren_train_bwd.cu``), which is called as that design's wrapper called it.
Cuts (each a text substitution of the source; a cut whose text is missing
stops the script):

- ``old-dw-atomics``: every ``add2(dw ...)`` statement of the first design
  (the compiler then also drops the dW products that only they used);
- ``dbase-partials``: the chain kernel's loads and stores of its dbase
  partial and the kernel that sums the partials;
- ``chain-products``: the wgmma instructions of the chain kernel (the ring
  is still filled and waited on);
- ``weight-loads``: the chain producer's weight-slab TMA loads (each stage
  is marked full at once; the products read whatever the slab holds);
- ``sines``: the sine and cosine polynomials of the epilogues (identity);
- ``dw-kernel``: the weight-gradient kernel and its sum.

``--trace`` builds the source with a ``%globaltimer`` mark by thread 0 of
every chain block before and after each product and at the start and end of
its consumer path, calls the wrapper once and prints the mean time per
segment over all blocks: where a block's time goes between products.

Times are CUDA-event medians of 20 calls of the whole wrapper (its buffers
included) at B=400, S=576, H=256, L=5, dropout 0.1, degree-5 sines, taken in
turns (as is, each cut, each cut again, as is), with the card's name and
power limit beside them. Cut builds compute wrong gradients; only their
times mean anything. Needs the CUDA toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
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

BATCH, LAYERS, HIDDEN = 400, 5, 256
CUTS = {
    "old-dw-atomics": [(r"add2\(dw\b[^;]*;", ";")],
    "dbase-partials": [(r"if \(b > b0\) \{[^}]*\}\s*\*db = d;", "(void)d;"),
                       (r"ordered_sum_kernel<<<[^;]*dbase_part[^;]*;", ";")],
    "chain-products": [(r"wgmma<C::NW, 0, 0>\([^;]*;", ";")],
    "weight-loads": [(r"mbar_expect_tx\(&full\[st\], Chain<H>::STAGE\);", "mbar_arrive(&full[st]);"),
                     (r"for \(int q = 0; q < KB; \+\+q\)\s*tma_load_2d\([^;]*;", "")],
    "sines": [(r"poly_sin<DEG>\(", "("), (r"poly_cos<DEG>\(", "(")],
    "dw-kernel": [(r"dw_kernel<H><<<[^;]*;", ";"),
                  (r"ordered_sum_kernel<<<[^;]*\(partial\)[^;]*;", ";")],
}


TRACE_HEAD = r"""
__device__ unsigned long long g_trace[8192 * 64];
__device__ __forceinline__ void trace_mark(int& k) {
  if (threadIdx.x == 0 && blockIdx.x < 8192 && k < 64) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[blockIdx.x * 64 + k] = t;
  }
  ++k;
}
"""
TRACE_TAIL = r"""
extern "C" int trace_copy(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
"""


def add_trace(text: str) -> str:
    """Marks in execution order: each patch's start, around every chain
    product, between the steps of the last layer's and each reverse
    epilogue, before layer 0's epilogue and before the record is written
    (a block's later patches overwrite its earlier patches' marks)."""
    text = text.replace('#include "siren_common.cuh"\n',
                        '#include "siren_common.cuh"\n' + TRACE_HEAD, 1)
    text = text.replace("  for (int b = b0; b < b0 + np; ++b) {",
                        "  for (int b = b0; b < b0 + np; ++b) {\n    int trace_k = 0;", 1)
    text = text.replace("    // x_0 = bf16(drop_0(base)",
                        "    trace_mark(trace_k);\n    // x_0 = bf16(drop_0(base)", 1)
    text = re.sub(r"(\n\s*)(chain_product<H>\([^;]*;)",
                  r"\1trace_mark(trace_k);\1\2\1trace_mark(trace_k);", text)
    for anchor in ("      for (int h = 0; h < 2; ++h) {\n        float p = part[h];",
                   "      if (tid < TM) {\n        float dpl",
                   "      // dlw += sum_rows dpl * x_{L-1};",
                   "      if (tid == 0) {\n        float s = 0.f;",
                   "      if (i < L - 2) {  // pre_{i+1} again",
                   "      const float* bias = bias_s + i * H;",
                   "      fence_async_shared();\n      bar_sync(CONSUMER_BAR, CHAIN_THREADS);\n"
                   "      tile_to_global<H>(ap"):
        if anchor not in text:
            raise SystemExit(f"trace anchor missing: {anchor!r}")
        text = text.replace(anchor, "      trace_mark(trace_k);\n" + anchor, 1)
    text = text.replace("    // ---- layer 0", "    trace_mark(trace_k);\n    // ---- layer 0", 1)
    return text + TRACE_TAIL


def build(src: pathlib.Path, out_dir: pathlib.Path, name: str, cut: str | None) -> ctypes.CDLL:
    text = src.read_text()
    if cut == "--trace":
        text = add_trace(text)
    for pattern, repl in CUTS.get(cut, []):
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise SystemExit(f"{src}: cut {cut}: no match for {pattern!r}")
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), "-O3", "-std=c++17", "-gencode", _build.ARCH, "-shared",
           "-Xcompiler", "-fPIC", "-I", str(src.parent), "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def inputs(dev):
    g = torch.Generator().manual_seed(1)
    model = ms.ModulatedSiren(dim_hidden=HIDDEN, latent_dim=HIDDEN, num_layers=LAYERS,
                              dropout=0.1, generator=g, device=dev)
    tiles = torch.rand((BATCH, 32, 32), generator=g).to(dev)
    cot = (torch.randn((BATCH, 576), generator=g) / 576).to(dev)
    with torch.no_grad():
        kp = sk.extract_kernel_params(model, ms.coordinate_grid(24, dev))
        mods = sk.compute_modulations(kp, model.encode(tiles), num_layers=LAYERS).contiguous()
    seed = torch.tensor([1234.0], device=dev)
    return (seed, mods, kp.base, kp.s_w, kp.s_b, kp.last_w, kp.last_b), cot


def old_design_call(lib, args, cot):
    """The first design's C interface: one kernel adding dW into a zeroed
    buffer."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_train_bwd_launch.argtypes = [p] * 14 + [i, i, i, i, f, i, i, i, i, f, p]
    seed, mods, base, s_w, s_b, last_w, last_b = args
    seq = base.shape[0]
    on, thresh, inv_keep = stk._dropout_args(0.1)
    f32 = dict(dtype=torch.float32, device=mods.device)
    dmods_part = torch.empty((BATCH, -(-seq // 64), LAYERS * HIDDEN), **f32)
    work = [torch.zeros(s, **f32) for s in ((LAYERS - 1, HIDDEN, HIDDEN), (seq, HIDDEN),
                                             (LAYERS - 1, HIDDEN), (HIDDEN,), (1,))]

    def call():
        for w in work:
            w.zero_()
        err = lib.siren_train_bwd_launch(
            seed.data_ptr(), mods.data_ptr(), base.data_ptr(), s_w.data_ptr(), s_b.data_ptr(),
            last_w.data_ptr(), last_b.data_ptr(), cot.data_ptr(), dmods_part.data_ptr(),
            work[1].data_ptr(), work[0].data_ptr(), work[2].data_ptr(), work[3].data_ptr(),
            work[4].data_ptr(), BATCH, seq, HIDDEN, LAYERS, 1.0, 0, 5, on, thresh, inv_keep,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")

    return call


def wrapper_call(lib, args, cot):
    """The port's wrapper, pointed at this build."""
    real = stk._build.load
    stk._build.load = lambda name: lib
    try:
        configured = stk._bwd_library.__wrapped__()  # argument types set as the port sets them
    finally:
        stk._build.load = real
    kw = dict(num_layers=LAYERS, dropout_rate=0.1, sin5=True)

    def call():
        stk._bwd_library = lambda: configured
        stk.siren_chain_train_bwd_cuda(*args, cot, **kw)

    return call


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


def trace(src: pathlib.Path) -> int:
    import numpy as np

    dev = torch.device("cuda")
    args, cot = inputs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(src, pathlib.Path(tmp), "bwd_trace", "--trace")
        call = wrapper_call(lib, args, cot)
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8192 * 64))()
        lib.trace_copy.argtypes = [ctypes.c_void_p]
        if lib.trace_copy(buf):
            raise SystemExit("trace_copy failed")
    t = np.frombuffer(buf, dtype=np.uint64).reshape(8192, 64).astype(np.float64)
    t = t[t[:, 0] > 0]  # the blocks of the grid (a block marks its last patch)
    blocks = len(t)
    marks = int((t[0] > 0).sum())
    seg = np.diff(t[:, :marks], axis=1) / 1e3  # microseconds
    total = (t[:, marks - 1] - t[:, 0]) / 1e3
    print(f"chain block timeline over {blocks} blocks, {marks} marks: mean {total.mean():.2f} us "
          f"from the first to the last mark (min {total.min():.2f}, max {total.max():.2f})")
    for k in range(marks - 1):
        print(f"  segment {k:2d}: mean {seg[:, k].mean():8.3f} us, max {seg[:, k].max():8.3f}")
    span = (t[:, marks - 1].max() - t[:, 0].min()) / 1e6
    print(f"  first mark to last mark over all blocks: {span:.4f} ms")
    return 0


def main() -> int:
    if len(sys.argv) < 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    src = pathlib.Path(sys.argv[1]).resolve()
    cuts = sys.argv[2:]
    if cuts == ["--trace"]:
        return trace(src)
    unknown = [c for c in cuts if c not in CUTS]
    if unknown:
        raise SystemExit(f"unknown cut(s) {unknown}; known: {sorted(CUTS)}")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    args, cot = inputs(dev)
    make_call = old_design_call if "old-dw-atomics" in cuts else wrapper_call
    with tempfile.TemporaryDirectory() as tmp:
        keys = ["as is", *cuts]
        with ThreadPoolExecutor(len(keys)) as pool:  # one nvcc per build, all at once
            libs = list(pool.map(lambda k: build(src, pathlib.Path(tmp), f"bwd{keys.index(k)}",
                                                 None if k == "as is" else k), keys))
        calls = {k: make_call(lib, args, cot) for k, lib in zip(keys, libs)}
        runs = {k: [] for k in calls}
        for key in ["as is", *cuts, *cuts, "as is"]:
            runs[key].append(median_ms(calls[key]))
    for key, ms_ in runs.items():
        label = "as is" if key == "as is" else f"{key} cut"
        print(f"siren_train_bwd ({label}) at B={BATCH}: "
              f"{' / '.join(f'{t:.4f}' for t in ms_)} ms/call (median of 20, two turns) "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
