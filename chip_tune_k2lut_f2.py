#!/usr/bin/env python3
"""Time build variants of the LUT K2 (`write_records_lut_kernel`,
kernels/encode.cu) and of F2 (`fpl_finalize_kernel`, kernels/fpl.cu) on
one GPU, in turns, and split each kernel's time into its parts.

    python3 chip_tune_k2lut_f2.py [k2] [f2]

Each variant is the source with a text edit, compiled by nvcc with the
package's own flags in a folder of its own under .tree_check/k2lut_f2/ and
put in the package's place (`build._libs[...]`), so that the wrappers
launch it. Set `k2` (encode.cu): the parts, for timing only -- no LUT
record's payload (the LUT warps' work), no plain payload rows, no span
stores, no staging of the image (then nothing of the payloads either: the
front, i.e. the records' reads, zeroing, headers and the span's stores);
and real variants -- the bitmap up to nb 8 only, the ordered path alone
(no bitmap), 64 threads a CTA (the kernel's: 128; 256 pass the static
shared memory at 16x16). The inputs are chip_compare.py's k1lut sets (band
and mosaic path calls; K2's rows alone counted): the band DEM 8x8, the
band class grid 16x16, the mosaic DEM 8x8, class grid 16x16 and uint8 x 3
8x8 stacks. Set `f2` (fpl.cu): for timing only, no histograms (the count),
no histograms and no stores (then the loads and levels are dead code too:
what is left is the launch and the bins), and the same with no byte
levels; real variants -- no warp-uniform histogram shortcut, half and
twice the CTAs the card holds at once (the kernel's grid), 6 CTAs an SM by
launch bounds (at most 85 registers), 256 threads a CTA (the kernel's:
128), each thread's counts merged over its runs of equal bytes (a chain of
adds; the kernel's adds are independent). The inputs are chip_compare.py's
f2 sets (four tiles round-robin, and one tile again and again: in the L2).
Every variant but the timing-only ones is first held to the unedited
kernel on every set (the calls' whole outputs equal); then the variants
are timed round-robin: 3 rounds of one torch.profiler window of 10 calls
of each set's inputs per variant, the order reversed every other round,
the kernel's rows alone counted. Prints each variant's median and spread
in ms per launch beside the card.
"""
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
K2_STORES = ("c += K2L_THREADS) {\n                const long long gw = gw0 + 4 * c;")
K2_STAGE = "for (int t = tid; t < rows * nch; t += K2L_THREADS) {"
F2_COUNT = "            // the counts of the plane's live bytes: one add where they are one\n"
F2_STORE = "            if (act)\n                *reinterpret_cast<uint4*>"
F2_LEVELS = "                if (l > top) break;"
F2_GRID = "resident = (long long)max(per_sm, 1) * sms;"
F2_BYTES = """#pragma unroll
                for (int m = 0; m < FIN_RUN; ++m)
                    if (m < live)
                        atomicAdd(&bins[b * 256 + ((pl[b][m >> 2] >> (8 * (m & 3))) & 0xFFu)], 1u);"""
F2_RUNS = """                unsigned cur = v0, run = 0;
#pragma unroll
                for (int m = 0; m < FIN_RUN; ++m) {
                    if (m >= live) break;
                    const unsigned v = (pl[b][m >> 2] >> (8 * (m & 3))) & 0xFFu;
                    if (v != cur) {
                        atomicAdd(&bins[b * 256 + cur], run);
                        cur = v, run = 0;
                    }
                    ++run;
                }
                if (run) atomicAdd(&bins[b * 256 + cur], run);"""
EDITS = {
    "k2": ("encode", "write_records_lut_kernel", {
        "the kernel": [],
        "no LUT payload (timing only)": [(
            "for (int i = warp; i < s_nlut; i += K2L_WARPS) {",
            "for (int i = warp; i < 0; i += K2L_WARPS) {")],
        "no plain payload rows (timing only)": [(
            "for (int it = tid; it < MB * (gb - ga); it += K2L_THREADS) {",
            "for (int it = tid; it < 0; it += K2L_THREADS) {")],
        "no span stores (timing only)": [(K2_STORES, K2_STORES + "\n                continue;")],
        "front: no staging, no payloads (timing only)": [
            (K2_STAGE, "for (int t = tid; t < 0; t += K2L_THREADS) {"),
            ("for (int i = warp; i < s_nlut; i += K2L_WARPS) {",
             "for (int i = warp; i < 0; i += K2L_WARPS) {"),
            ("for (int it = tid; it < MB * (gb - ga); it += K2L_THREADS) {",
             "for (int it = tid; it < 0; it += K2L_THREADS) {")],
        "bitmap up to nb 8": [("constexpr int K2L_BITMAP_NB = 12;",
                               "constexpr int K2L_BITMAP_NB = 8;")],
        "ordered path alone": [("constexpr int K2L_BITMAP_NB = 12;",
                                "constexpr int K2L_BITMAP_NB = 0;")],
        "64 threads a CTA": [("constexpr int K2L_THREADS = 128;", "constexpr int K2L_THREADS = 64;")],
    }),
    "f2": ("fpl", "fpl_finalize_kernel", {
        "the kernel": [],
        "no histograms (timing only)": [(F2_COUNT, "            continue;\n")],
        "no histograms, no stores (timing only)": [
            (F2_COUNT, "            continue;\n"),
            (F2_STORE, "            if (false)\n                *reinterpret_cast<uint4*>")],
        "front: no histograms, stores, levels (timing only)": [
            (F2_COUNT, "            continue;\n"),
            (F2_STORE, "            if (false)\n                *reinterpret_cast<uint4*>"),
            (F2_LEVELS, "                break;")],
        "no warp-uniform histogram shortcut": [("if (__all_sync(FULL, one && v0 == lane0)) {",
                                                "if (__all_sync(FULL, false)) {")],
        "counts merged over runs (chained)": [(F2_BYTES, F2_RUNS)],
        "half the resident CTAs": [(F2_GRID, F2_GRID.replace("* sms;", "* sms / 2;"))],
        "twice the resident CTAs": [(F2_GRID, F2_GRID.replace("* sms;", "* sms * 2;"))],
        "6 CTAs an SM (launch bounds)": [("__launch_bounds__(FIN_NT) fpl_finalize_kernel",
                                          "__launch_bounds__(FIN_NT, 6) fpl_finalize_kernel")],
        "256 threads a CTA": [("constexpr int FIN_NT = 128,", "constexpr int FIN_NT = 256,")],
    }),
}
K2_SETS = ("band_dem_mb8", "band_grid_mb16", "mosaic_dem_mb8", "mosaic_grid_mb16",
           "mosaic_u8x3_mb8")
OUT = Path(".tree_check/k2lut_f2")


def build_variants(build, which):
    source, kernel, edits = EDITS[which]
    OUT.mkdir(parents=True, exist_ok=True)
    base = (build.SRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for i, (name, ed) in enumerate(edits.items()):
        src = base
        for old, new in ed:
            assert src.count(old) == 1, f"{source}.cu no longer has {old!r} once"
            src = src.replace(old, new)
        vdir = OUT / f"{which}{i}"
        vdir.mkdir(exist_ok=True)
        cu, so = vdir / f"{source}.cu", vdir / f"{source}.so"
        cu.write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling" in line and kernel in line:
                used = [x.strip() for x in lines[i + 1:i + 5] if "Used" in x or "spill" in x]
                inst = line.split("'")[1] if "'" in line else line
                print(f"{name}: ptxas {inst}: {' '.join(used)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def sets_of(which, cs, cc, torch):
    dev = torch.device("cuda")
    if which == "k2":
        sets = cc.k1lut_sets(cs, dev)
        return {k: sets[k] for k in K2_SETS}, cc.K2LUT[0]
    from lerc_tpu_torch.ops import device_fpl as F

    return {label: [lambda t=t, p=pred, lv=levels: F.fpl_finalize(t, p, lv) for t in tiles]
            for label, (tiles, pred, levels) in cc.f2_sets(cs, dev).items()}, "fpl_finalize"


def main():
    which_all = sys.argv[1:] or ["k2", "f2"]
    if any(w not in EDITS for w in which_all):
        raise SystemExit(__doc__)
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_k2lut_f2.py needs a CUDA GPU")
    import chip_smoke as cs
    from lerc_tpu_torch.kernels import build

    spec = importlib.util.spec_from_file_location("chip_compare_here", HERE / "chip_compare.py")
    cc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc)
    card = cs.card_line()
    build.build_all()
    for which in which_all:
        source = EDITS[which][0]
        print(f"{card} | set {which}", flush=True)
        libs = build_variants(build, which)
        sets, match = sets_of(which, cs, cc, torch)
        base = next(iter(libs))
        build._libs[source] = libs[base]
        want = {label: [c() for c in calls] for label, calls in sets.items()}
        for name, lib in libs.items():
            if name == base or "timing only" in name:
                continue
            build._libs[source] = lib
            for label, calls in sets.items():
                for c, w in zip(calls, want[label]):
                    got = c()
                    cs.require(all(torch.equal(a, b) for a, b in zip(got, w)),
                               f"variant {name} != the unedited kernel ({label})")
        print("every variant but the timing-only ones equal to the unedited kernel", flush=True)
        del want
        for label, calls in sets.items():
            times = {name: [] for name in libs}
            for rnd in range(3):
                order = list(libs.items())
                for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                    build._libs[source] = lib
                    rows = cs.profiled_rows(calls, 10, (match,))
                    cs.require(rows is not None, f"no device time for {name}")
                    times[name].append(sum(r[2] for r in rows if match in r[0]) / 1e3
                                       / (10 * len(calls)))
            for name, t in times.items():
                print(f"{which} {label} {name}: median {float(np.median(t)):.4f} ms "
                      f"({min(t):.4f}-{max(t):.4f}) [{card}]", flush=True)
        build._libs[source] = libs[base]


if __name__ == "__main__":
    main()
