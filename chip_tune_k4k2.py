#!/usr/bin/env python3
"""Time build variants of the mosaic's K4 (`decode_records_lut`,
kernels/decode.cu) and the integer K2 (`write_records_int`,
kernels/encode.cu) on one GPU, in turns.

    python3 chip_tune_k4k2.py [decode] [encode]

(both sources when none is named). Each variant is the source with a text
edit: K4 with its CTAs' launch bounds asking for no CTA count, 4 or 8 CTAs
an SM (the kernel asks 6), and, for timing only, without its pixel loop
(the parse, staging and stores alone); K2 with 256-thread CTAs (the
kernel's: 128), with launch bounds asking for 8 CTAs an SM, and, for
timing only, without its payload rows. Each is compiled by nvcc with the package's own
flags in a folder of its own under .tree_check/k4k2_variants/ and put in
the package's place (`build._libs`), so the wrappers launch it. Every
variant but the timing-only ones is first held to the plain version (K4 on
each micro-block group of the uint8 three-band mosaic cell, K2 on the first
tile of each of chip_compare.py's k2int sets), then timed round-robin: K4
on the groups of chip_compare.py's k4lut cells, K2 over the four tiles of
each k2int set, 5 rounds of one torch.profiler window of 10 calls of each
input per variant, the order reversed every other round. Prints each
variant's median and spread in ms per call.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_compare as cc
import chip_smoke as cs
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_decode as dec
from lerc_tpu_torch.ops import device_encode as enc

K4_HEAD = "__global__ void __launch_bounds__(STRIP_THREADS, 6) decode_records_lut_kernel("
K2_HEAD = "__global__ void __launch_bounds__(K2S_THREADS) write_records_int_kernel("
EDITS = {
    "decode": {
        "the kernel": [],
        "no launch bounds' CTA count": [(K4_HEAD, K4_HEAD.replace(", 6)", ")"))],
        "4 CTAs an SM": [(K4_HEAD, K4_HEAD.replace(", 6)", ", 4)"))],
        "8 CTAs an SM": [(K4_HEAD, K4_HEAD.replace(", 6)", ", 8)"))],
        "no pixel loop (timing only)": [
            ("            V prev = k == 0 ? carry : V(0);\n            const int4* rrow",
             "            if (dlo >= 0) break;\n"
             "            V prev = k == 0 ? carry : V(0);\n            const int4* rrow")],
    },
    "encode": {
        "the kernel": [],
        "256-thread CTAs": [("constexpr int K2S_THREADS = 128;", "constexpr int K2S_THREADS = 256;")],
        "8 CTAs an SM": [(K2_HEAD, K2_HEAD.replace("(K2S_THREADS)", "(K2S_THREADS, 8)"))],
        "no payload rows (timing only)": [
            ("                if (mode != 0 && mode != 1) continue;\n                const int bl = t / dn, di",
             "                if (mode >= 0) continue;\n                const int bl = t / dn, di")],
    },
}
OUT = Path(".tree_check/k4k2_variants")


def build_variants(sources):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src_name in sources:
        base = (build.SRC_DIR / f"{src_name}.cu").read_text()
        for i, (name, edits) in enumerate(EDITS[src_name].items()):
            src = base
            for old, new in edits:
                assert src.count(old) == 1, f"{src_name}.cu no longer has {old!r} once"
                src = src.replace(old, new)
            vdir = OUT / f"{src_name}{i}"
            vdir.mkdir(exist_ok=True)
            cu, so = vdir / f"{src_name}.cu", vdir / f"{src_name}.so"
            cu.write_text(src)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(so),
                   str(cu)]
            procs[(src_name, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling" in line and ("decode_records_lut_kernelIhLb1ELi8ELb0" in line
                                        or "write_records_int_kernelIhLb0ELi3" in line):
                used = [x.strip() for x in lines[i + 1:i + 5] if "Used" in x or "spill" in x]
                print(f"{key[0]} {key[1]}: ptxas: {' '.join(used)}", flush=True)
        libs[key] = ctypes.CDLL(str(so))
    return libs


def timed(label, libs, src, calls, match, card):
    times = {name: [] for name in libs}
    for rnd in range(5):
        order = list(libs.items())
        for name, lib in (order if rnd % 2 == 0 else order[::-1]):
            build._libs[src] = lib
            rows = cs.profiled_rows(calls, 10, match)
            cs.require(rows is not None, f"no device time for {name}")
            times[name].append(sum(r[2] for r in rows if any(m in r[0] for m in match)) / 1e3
                               / (10 * len(calls)))
    for name, t in times.items():
        print(f"{label} {name}: median {float(np.median(t)):.4f} ms ({min(t):.4f}-{max(t):.4f}) "
              f"[{card}]", flush=True)


def main():
    from lerc_tpu_torch.parallel import sharding as S

    card = cs.card_line()
    print(card, flush=True)
    sources = sys.argv[1:] or list(EDITS)
    if any(x not in EDITS for x in sources):
        raise SystemExit(__doc__)
    build.build_all()
    libs = build_variants(sources)
    dev = torch.device("cuda")
    if "decode" in sources:
        tiles = cs.make_tiles(4, 2048, dev)
        t = cs.MOSAIC_TILE
        groups = {}
        for label, raster, mze in (("u8x3", cs.raster_of(cs.int_cell_tiles(tiles, np.uint8, 3)), 0.5),
                                   ("grid", cs.raster_of([cs.class_grid(x) for x in tiles]), 0.5),
                                   ("dem", cs.raster_of(tiles), 0.001)):
            blob = S.MosaicEncoder(None, t, t, raster.dtype, n_depth=raster.shape[2]).encode(
                raster, None, mze)
            if label == "u8x3":
                u8x3_blob = blob
            for mb, units in sorted(cs.k4_groups(blob).items()):
                groups[f"{label} mb {mb}, {len(units)} units"] = cs.k4_inputs(blob, mb, units, dev)
        k4_libs = {n: lib for (s, n), lib in libs.items() if s == "decode"}
        for name, lib in k4_libs.items():
            if "timing only" not in name:
                build._libs["decode"] = lib
                cs.check_k4(u8x3_blob, f"variant {name}")
        print("every K4 variant but the timing-only one equal to plain", flush=True)
        for label, (args, kw, _hd, _) in groups.items():
            timed(f"K4 {label}", k4_libs, "decode",
                  [lambda a=args, k=kw: dec.decode_tiles_fast(*a, **k)],
                  ("decode_records_lut",), card)
    if "encode" in sources:
        k2_libs = {n: lib for (s, n), lib in libs.items() if s == "encode"}
        sets = {k: v for k, v in cc.k1int_inputs(cs, dev).items() if not k.startswith("f32")}
        calls = {}
        for label, args in sets.items():
            calls[label] = []
            for x, p, valid in args:
                ri = enc.encode_blocks(x, p, valid)[0]
                length = ri[:, 0]
                starts = torch.cumsum(length, 0, dtype=torch.int32) - length
                cap_w = (int(length.sum()) + 4096) // 4
                calls[label].append((x, ri, starts, cap_w, p, valid))
        for name, lib in k2_libs.items():
            if "timing only" in name:
                continue
            build._libs["encode"] = lib
            for label, cl in calls.items():
                cs.require(torch.equal(enc.write_records(*cl[0]), enc.write_records_ref(*cl[0])),
                           f"K2 variant {name} != plain ({label})")
        print("every K2 variant but the timing-only one equal to plain", flush=True)
        for label, cl in calls.items():
            timed(f"K2 {label}", k2_libs, "encode",
                  [lambda a=a: enc.write_records(*a) for a in cl], ("write_records",), card)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_k4k2.py needs a CUDA GPU")
    main()
