#!/usr/bin/env python3
"""Time build variants of the all-valid delta restore (`huffman_restore_delta`
in lerc_tpu_torch/kernels/huffman.cu) on one GPU, in turns, beside
torch.cumsum.

    python3 chip_tune_h4.py

Each variant is huffman.cu with one text edit (the CTA size, the launch
bounds' minimum of resident CTAs), compiled by nvcc with the package's own
flags into .tree_check/h4_variants/ and loaded with ctypes. Every variant is
first held byte for byte to symbols_to_image_ref on four shapes (2048^2 x 3,
3x4099x5 int8 on a view at offset 3, 5x17x2 int8 at offset 1, 7x1x8), then
timed on the same 2048^2 x 3 uint8 symbols: 5 rounds of one torch.profiler
window of 20 launches per variant (the order reversed every other round),
and torch.cumsum(s, 2, dtype=torch.uint8) in each round. Prints each
variant's ptxas line, median and spread in ms per launch, and its share of
the bytes bound (2n + D*H over 3.35 TB/s).
"""
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_huffman as dh

SRC = (build.SRC_DIR / "huffman.cu").read_text()
LB = "__global__ void __launch_bounds__(RST_THREADS) huffman_restore_delta_kernel("
T128, T256 = "constexpr int RST_THREADS = 128;", "constexpr int RST_THREADS = 256;"


def with_min_ctas(src, n):
    return src.replace(LB, LB.replace("(RST_THREADS)", f"(RST_THREADS, {n})"))


VARIANTS = {
    "128 threads": SRC,
    "128 threads, >= 8 CTAs": with_min_ctas(SRC, 8),
    "128 threads, >= 12 CTAs": with_min_ctas(SRC, 12),
    "256 threads": SRC.replace(T128, T256),
    "256 threads, >= 4 CTAs": with_min_ctas(SRC.replace(T128, T256), 4),
}
OUT = Path(".tree_check/h4_variants")
P, I = ctypes.c_void_p, ctypes.c_int


def build_variants():
    assert LB in SRC and T128 in SRC, "huffman.cu no longer has the edited lines"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(VARIANTS.items()):
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "huffman_restore_delta_kernelILi3E" in line and "Compiling" in line:
                print(f"{name}: ptxas (D = 3): {lines[i + 3].strip()}", flush=True)
        fn = ctypes.CDLL(str(so)).huffman_restore_delta
        fn.argtypes = [P, P, I, I, I, I, P, P]
        fns[name] = fn
    return fns


def main():
    card = cs.card_line()
    print(card, flush=True)
    fns = build_variants()
    col0_fn = build.library("huffman").huffman_restore_col0
    col0_fn.argtypes = [P, I, I, I, I, P, P]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def inputs(h, w, d, off, at):
        buf = torch.from_numpy(rng.integers(0, 256, h * w * d + 16, dtype=np.uint8)).to(dev)
        sym = buf[at:at + h * w * d]
        col0 = torch.empty(d, h, dtype=torch.uint8, device=dev)
        cs.require(col0_fn(sym.data_ptr(), h, w, d, off, col0.data_ptr(),
                           build.launch_stream(sym)) == 0, "huffman_restore_col0 launch failed")
        return sym, col0, torch.empty(h, w, d, dtype=torch.uint8, device=dev)

    def run(fn, sym, col0, img, h, w, d, off):
        err = fn(sym.data_ptr(), col0.data_ptr(), h, w, d, off, img.data_ptr(),
                 build.launch_stream(sym))
        cs.require(err == 0, f"huffman_restore_delta launch failed: cudaError {err}")

    for (h, w, d), off, at in (((2048, 2048, 3), 0, 0), ((3, 4099, 5), 128, 3),
                               ((5, 17, 2), 128, 1), ((7, 1, 8), 0, 0)):
        sym, col0, img = inputs(h, w, d, off, at)
        dt = DataType.CHAR if off else DataType.BYTE
        ref = dh.symbols_to_image_ref(sym, h, w, d, dt, True).view(torch.uint8)
        for name, fn in fns.items():
            run(fn, sym, col0, img, h, w, d, off)
            torch.cuda.synchronize()
            cs.require(torch.equal(img, ref), f"{name} != plain at {h}x{w}x{d}")
        print(f"every variant equal to plain at {h}x{w}x{d}, offset {off}, view +{at}", flush=True)

    h, w, d = 2048, 2048, 3
    sym, col0, img = inputs(h, w, d, 0, 0)
    match = "huffman_restore_delta_kernel"
    times = {name: [] for name in fns}
    lib = []
    for rnd in range(5):
        order = list(fns.items())
        for name, fn in (order if rnd % 2 == 0 else order[::-1]):
            rows = cs.profiled_rows([lambda fn=fn: run(fn, sym, col0, img, h, w, d, 0)], 20,
                                    (match,))
            cs.require(rows is not None, f"no device time for {name}")
            times[name].append(sum(r[2] for r in rows if match in r[0]) / 1e3 / 20)
        rows = cs.profiled_rows([lambda: torch.cumsum(sym.view(d, h, w), 2, dtype=torch.uint8)],
                                20)
        cs.require(rows is not None, "no device time for torch.cumsum")
        lib.append(sum(r[2] for r in rows) / 1e3 / 20)
    bound = (2 * h * w * d + d * h) / cs.HBM_BYTES_PER_S * 1e3
    for name, t in times.items():
        m = float(np.median(t))
        print(f"{name}: median {m:.4f} ms ({min(t):.4f}-{max(t):.4f}), {bound / m:.1%} of the "
              f"{bound:.4f} ms bound [{card}]", flush=True)
    print(f"torch.cumsum(s, 2, dtype=torch.uint8): median {float(np.median(lib)):.4f} ms "
          f"({min(lib):.4f}-{max(lib):.4f}) [{card}]", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_h4.py needs a CUDA GPU")
    main()
