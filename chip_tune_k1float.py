#!/usr/bin/env python3
"""Time build variants of the float K1 (`encode_blocks_float_kernel`,
kernels/encode.cu: the float32 `encode_blocks` / `_masked` and the float64
`encode_blocks_f64` / `_masked_f64` / the mosaic's `encode_tiles_f64`) on
one GPU, in turns.

    python3 chip_tune_k1float.py

Each variant is encode.cu with a text edit, compiled by nvcc with the
package's own flags in a folder of its own under .tree_check/k1f_variants/
and put in the package's place (`build._libs["encode"]`), so that the
wrappers launch it: every record's quanta counted by the pass and every
float64 offset found by its scan (settled_q off: the kernel before the
settled maximum), the min/max pass's loop over row pairs not unrolled, the
range merge's group scan as a loop with a modulo a record in place of bit
masks, a strip's global range atomics only where a read of the range
shows they move it, float64 records of two lanes (a CTA of one warp; the
kernel's: four lanes, two warps), and, for timing only, no global range
atomics, no range merge at all, and the staging alone. Prints each
variant's ptxas lines (registers, spills). The
inputs are chip_compare.py's k1f32 and k1f64 sets (the four DEM tiles all-valid
and with the bench mask, float32 and float64, and the float64 DEM as the
mosaic's 64-tile stack). Every variant but the timing-only ones is first
held to the unedited kernel on every set (rec_info, ranges, fits equal),
then the variants are timed round-robin: 5 rounds of one torch.profiler
window of 10 calls of each set's inputs per variant, the order reversed
every other round, the K1 rows alone counted. Prints each variant's median
and spread in ms per launch and its share of the bytes bound.
"""
import ctypes
import importlib.util
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_encode as enc

HERE = Path(__file__).resolve().parent
BOUNDS = "__launch_bounds__(K1F<T>::THREADS) encode_blocks_float_kernel("
SETTLED = "const bool settled = settled_q(zmin, zmax, P, q_set);"
SCAN = "const bool scan = LPR > 1 && !(zmin != (T)0 && z_finite(zmin));"
PAIRS = "#pragma unroll\n        for (int pr = 0; pr < 4; ++pr) {"
LIVE = "        __syncthreads();\n        const int step"
LPR4 = "    static constexpr int LPR = 4;"
GLOBAL = ("            atomic_min_z(zr, z_of(s_lo[lane]));\n"
          "            atomic_max_z(zr + d, z_of(s_hi[lane]));")
MERGE = "if (lane < nq && (has >> lane & 1u)) {"
STORE = "if (lane < dn && (s_has >> lane & 1u)) {"
MASKS = """            const int dl = ONE ? 0 : lane % dn;
            unsigned at_dl = ~0u;  // the chunk's records at depth dl, as bits
            if (!ONE) {
                at_dl = 0;
                for (int k = dl; k < nq; k += dn) at_dl |= 1u << k;
            }
            const unsigned mine = has & at_dl;
            if (!(mine & ((1u << lane) - (1u << g0)))) {  // the group's first at this depth
                T l = s_zl[lane], hh = s_zh[lane];
                // the group's later records at this depth, in record order
                for (unsigned m = mine & (low_bits(g1) & ~low_bits(lane + 1)); m; m &= m - 1) {
                    const int k = __ffs((int)m) - 1;
                    l = zmin2(l, s_zl[k]), hh = zmax2(hh, s_zh[k]);
                }
"""
LOOPS = """            const int dl = lane % dn;
            bool first = true;
            for (int k = g0; k < lane; ++k) first &= !(k % dn == dl && (has >> k & 1u));
            if (first) {
                T l = s_zl[lane], hh = s_zh[lane];
                for (int k = lane + 1; k < g1; ++k) {
                    if (k % dn == dl && (has >> k & 1u))
                        l = zmin2(l, s_zl[k]), hh = zmax2(hh, s_zh[k]);
                }
"""
EDITS = {
    "the kernel": [],
    "every record counted (no settled maximum)": [(SETTLED, "const bool settled = false;"),
                                                  (SCAN, "const bool scan = LPR > 1;")],
    "min/max pass not unrolled": [(PAIRS, PAIRS.replace("unroll", "unroll 1"))],
    "range merge by a loop with a modulo a record": [(MASKS, LOOPS)],
    "a global atomic only where it moves the range": [(GLOBAL, (
        "            if (s_lo[lane] < z_key(*(volatile T*)zr)) atomic_min_z(zr, z_of(s_lo[lane]));\n"
        "            if (s_hi[lane] > z_key(*(volatile T*)(zr + d)))\n"
        "                atomic_max_z(zr + d, z_of(s_hi[lane]));"))],
    "float64: 2 lanes a record (a warp a strip)": [(LPR4, LPR4.replace("LPR = 4", "LPR = 2"))],
    "no global range atomics (timing only)": [(STORE, "if (false) {")],
    "no ranges (timing only)": [(MERGE, "if (false) {")],
    "staging alone (timing only)": [(LIVE, LIVE.replace("        const int step",
                                                        "        if (dn > 0) continue;\n"
                                                        "        const int step"))],
}
TIMING_ONLY = {"no global range atomics (timing only)", "no ranges (timing only)",
               "staging alone (timing only)"}
OUT = Path(".tree_check/k1f_variants")


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    base = (build.SRC_DIR / "encode.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(EDITS.items()):
        src = base
        for old, new in edits:
            assert src.count(old) == 1, f"encode.cu no longer has {old!r} once"
            src = src.replace(old, new)
        vdir = OUT / f"v{i}"
        vdir.mkdir(exist_ok=True)
        cu, so = vdir / "encode.cu", vdir / "encode.so"
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
            if "Compiling" in line and "encode_blocks_float_kernel" in line:
                used = [x.strip() for x in lines[i + 1:i + 5] if "Used" in x or "spill" in x]
                inst = line.split("'")[1] if "'" in line else line
                print(f"{name}: ptxas {inst}: {' '.join(used)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main():
    spec = importlib.util.spec_from_file_location("chip_compare_here", HERE / "chip_compare.py")
    cc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc)
    card = cs.card_line()
    print(card, flush=True)
    build.build_all()
    libs = build_variants()
    dev = torch.device("cuda")
    tiles = cs.make_tiles(4, 2048, dev)
    tiles64 = cs.make_tiles64(4, 2048, dev)
    valid = enc.block_valid_words(torch.from_numpy(cs.bench_mask()).to(dev))
    p, p64 = enc.encode_params(0.001, 6, 0), enc.encode_params_f64(0.001, 6)
    raster = torch.cat([torch.cat(tiles64[:2], 1), torch.cat(tiles64[2:], 1)], 0)
    stack = raster.reshape(8, 512, 8, 512, 1).permute(0, 2, 1, 3, 4).reshape(64 * 512, 512, 1)
    stack = stack.contiguous()
    ones = enc.block_valid_words(torch.ones(64 * 512, 512, dtype=torch.bool, device=dev))
    mb = cs.HBM_BYTES_PER_S / 1e3  # bytes a ms
    n, n_rec, v_bytes = 2048 * 2048, 256 * 256, 4 * valid.numel()
    sets = {  # label: (calls, bytes bound ms)
        "K1": ([lambda t=t: enc.encode_blocks(t, p) for t in tiles], (4 * n + 16 * n_rec) / mb),
        "K1m": ([lambda t=t: enc.encode_blocks(t, p, valid) for t in tiles],
                (4 * int(cs.bench_mask().sum()) + v_bytes + 16 * n_rec) / mb),
        "K1 f64": ([lambda t=t: enc.encode_blocks_f64(t, p64) for t in tiles64],
                   (8 * n + 16 * n_rec) / mb),
        "K1m f64": ([lambda t=t: enc.encode_blocks_f64(t, p64, valid) for t in tiles64],
                    (8 * n + v_bytes + 16 * n_rec) / mb),
        "mosaic f64": ([lambda: enc.encode_blocks_f64(stack, p64, ones, 4096)],
                       (8 * 4 * n + 4 * ones.numel() + 16 * 4 * n_rec) / mb),
    }
    base = next(iter(libs))
    want = {}
    for name, lib in libs.items():
        build._libs["encode"] = lib
        for label, (calls, _b) in sets.items():
            got = calls[0]()
            if name == base:
                want[label] = got
            elif name not in TIMING_ONLY:
                cs.require(all(torch.equal(a, b) for a, b in zip(got, want[label])),
                           f"{name}: {label} != the kernel's")
    print(f"every variant but {sorted(TIMING_ONLY)} equal to the kernel on every set", flush=True)
    for label, (calls, bound) in sets.items():
        times = {name: [] for name in libs}
        for rnd in range(5):
            order = list(libs.items())
            for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                build._libs["encode"] = lib
                rows = cs.profiled_rows(calls, 10, ("encode_blocks_float",))
                cs.require(rows is not None, f"no device time for {name}")
                times[name].append(sum(r[2] for r in rows if "encode_blocks_float" in r[0])
                                   / 1e3 / (10 * len(calls)))
        for name, t in times.items():
            m = float(np.median(t))
            print(f"{label} {name}: median {m:.4f} ms ({min(t):.4f}-{max(t):.4f}), "
                  f"{bound / m:.1%} of the {bound:.4f} ms bound [{card}]", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_k1float.py needs a CUDA GPU")
    main()
