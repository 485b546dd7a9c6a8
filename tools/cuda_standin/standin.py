#!/usr/bin/env python3
"""Run the CUDA kernels of lerc_tpu_torch/kernels on the CPU, at small
shapes, before a first call on the card.

    python3 tools/cuda_standin/standin.py [CHECK ...]

Each `.cu` source (decode and encode by default, or those named by
--sources) is rewritten -- every `__shared__` declaration into a
per-CTA box of include/cuda_runtime.h, every `K<<<g, b, s, st>>>(` into a
call of its launcher -- and compiled with g++ (C++20, -ffp-contract=off)
into .torch_ext_build/standin/. The launcher runs each CUDA thread as a
std::thread, STANDIN_SLOTS CTAs at once, shared memory filled with 0xA5
before each batch (a read of an unwritten word shows), warp collectives
through a 32-thread barrier. The wrappers of the kernels named by
--kernels (by default the mosaic K4 decode_records_lut and K2
write_records) then run the stand-in kernel on CPU tensors; every other
wrapper keeps its plain version. CHECK names functions of chip_smoke.py
that take the device as their first argument (default: k4lut_edge_check
k2int_edge_check); each runs with the CPU as its device and must return.
"""
import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ROOT / "lerc_tpu_torch" / "kernels"
OUT = ROOT / ".torch_ext_build" / "standin"


def rewrite(text: str) -> str:
    """A CUDA source for the stand-in runtime."""
    n = [0]

    def shared(m):
        typ, out = m.group(2), []
        for dcl in m.group(3).split(","):
            dcl = dcl.strip()
            name = re.match(r"(\w+)", dcl).group(1)
            n[0] += 1
            out.append(f"auto& {name} = standin_shared<{typ}{dcl[len(name):]}, {n[0]}>();")
        return " ".join(out)

    text = re.sub(r"__shared__\s+(__align__\(\d+\)\s+)?((?:unsigned\s+long\s+long|long\s+long"
                  r"|unsigned|typename\s+[\w:]+|[\w:]+))\s+([^;]+);", shared, text)
    return re.sub(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\(",
                  lambda m: f"standin_launch(standin_cfg({m.group(2)}), {m.group(1)}, ", text,
                  flags=re.S)


def build(sources, src_dir=KERNELS, out=OUT, opt="-O1") -> dict:
    """{source: library path}, each compiled against include/, all at once
    (-O0 builds encode.cu in a third of -O1's time; its kernels run slower)."""
    out.mkdir(parents=True, exist_ok=True)
    for h in src_dir.glob("*.cuh"):
        (out / h.name).write_text(rewrite(h.read_text()))
    procs = {}
    for name in sources:
        cpp = out / f"{name}.cpp"
        cpp.write_text(rewrite((src_dir / f"{name}.cu").read_text()))
        lib = out / f"lib{name}.so"
        cmd = ["g++", "-std=c++20", opt, "-ffp-contract=off", "-pthread", "-shared", "-fPIC",
               "-w", "-I", str(Path(__file__).parent / "include"), "-I", str(out), "-o",
               str(lib), str(cpp)]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"{name}.cu does not build for the stand-in:\n{err[-8000:]}")
        libs[name] = lib
    return libs


def install(libs, kernels):
    """Point lerc_tpu_torch's build at the stand-in libraries and make the
    wrappers named by `kernels` launch them on CPU tensors."""
    import torch

    from lerc_tpu_torch.kernels import build as B
    from lerc_tpu_torch.ops import device_decode, device_encode, device_fpl

    for name, lib in libs.items():
        B._libs[name] = ctypes.CDLL(str(lib))
    on = [False]
    real_on_cuda = B.on_cuda
    B.on_cuda = lambda *t: (on[0] and all(x.device.type == "cpu" for x in t)) or real_on_cuda(*t)
    B.launch_stream = lambda t: ctypes.c_void_p(0)
    torch.cuda.device = lambda d: contextlib.nullcontext()
    for mod in (device_decode, device_encode, device_fpl):
        for k in kernels:
            if hasattr(mod, k):
                real = getattr(mod, k)

                def wrapped(*a, _real=real, **kw):
                    on[0] = True
                    try:
                        return _real(*a, **kw)
                    finally:
                        on[0] = False
                setattr(mod, k, wrapped)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checks", nargs="*", default=["k4lut_edge_check", "k2int_edge_check"])
    ap.add_argument("--sources", nargs="+", default=["decode", "encode"])
    ap.add_argument("--kernels", nargs="+", default=["decode_records_lut", "write_records"])
    ap.add_argument("--src-dir", type=Path, default=KERNELS,
                    help="kernel sources to build (a mutated copy, say)")
    ap.add_argument("--out", type=Path, default=OUT, help="the build directory")
    ap.add_argument("--dtypes", nargs="+", help="numpy dtype names, for the edge checks")
    ap.add_argument("--depths", nargs="+", type=int, help="depths, for the edge checks")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    import chip_smoke

    install(build(args.sources, args.src_dir, args.out), args.kernels)
    kw = {}
    if args.dtypes:
        import numpy as np
        kw["dtypes"] = [np.dtype(t).type for t in args.dtypes]
    if args.depths:
        kw["depths"] = tuple(args.depths)
    for check in args.checks:
        t0 = time.perf_counter()
        n = getattr(chip_smoke, check)(torch.device("cpu"), **kw)
        print(f"{check}: {n} cases equal ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
