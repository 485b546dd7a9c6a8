#!/usr/bin/env python3
"""Time build variants of the LUT K1 (`encode_blocks_lut_kernel`,
kernels/encode.cu) on one GPU, in turns.

    python3 chip_tune_k1lut.py [SET] [--tree DIR]

Each variant is a tree's encode.cu with a text edit, compiled by nvcc with
the package's own flags in a folder of its own under
.tree_check/k1lut_variants/ and put in the package's place
(`build._libs["encode"]`), so that the paths' wrappers launch it. SET
`kernel` (the default) edits this tree's kernel: lanes a record (8x8
blocks: 8, the kernel's, 16 or 32; 16x16 blocks: 16, the kernel's, or 32),
8 or 2 warps a CTA (the kernel's: 4; 16 would pass the static shared
memory of a 16x16 CTA), the hash set alone (no bitmap), no early stop of
the count, one checked at every k or at every 2nd k (the kernel's: every k
at 8x8, every 2nd at 16x16), a bitmap of 32 words at least, the groups'
sets G words apart (other banks for the same word), and, for timing only,
the kernel with its distinct counts removed. SET `parent` edits the
kernel of a checkout whose K1 sorts each block with a warp bitonic network
(name the checkout with --tree, whose own modules then run): its
count removed and its validity words not read (timing only), 4 and 16
warps a CTA. The inputs are chip_compare.py's k1lut sets (every instance a
path launches, through the path's call). Every variant but the timing-only
ones is first held to the unedited kernel on every set (the calls' whole
outputs equal), then the variants are timed round-robin: 5 rounds of one
torch.profiler window of 10 calls of each set's inputs per variant, the
order reversed every other round, the K1 rows alone counted. Prints each
variant's median and spread in ms per launch beside the card.
"""
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
EDITS = {
    "kernel": {
        "the kernel": [],
        "8x8: 16 lanes a record": [("constexpr int K1L_LANES8 = 8;",
                                    "constexpr int K1L_LANES8 = 16;")],
        "8x8: 32 lanes a record": [("constexpr int K1L_LANES8 = 8;",
                                    "constexpr int K1L_LANES8 = 32;")],
        "16x16: 32 lanes a record": [("constexpr int K1L_LANES16 = 16;",
                                      "constexpr int K1L_LANES16 = 32;")],
        "8 warps a CTA": [("constexpr int K1L_WARPS = 4;", "constexpr int K1L_WARPS = 8;")],
        "2 warps a CTA": [("constexpr int K1L_WARPS = 4;", "constexpr int K1L_WARPS = 2;")],
        "hash set alone (no bitmap)": [("const bool bitmap = max_q < 32u * C::SLOTS;",
                                        "const bool bitmap = false;")],
        "no early stop": [("            done = done || !lut_shorter(n, nb, cnt);", "            ;")],
        "early stop checked at every k": [("if (C::VPL <= 8 || k % 2 == 1)", "if (true)")],
        "early stop checked at every 2nd k": [("if (C::VPL <= 8 || k % 2 == 1)", "if (k % 2 == 1)")],
        "bitmap of 32 words at least": [(
            "const int lw = bitmap ? bit_len(max_q >> 5) : 0;",
            "const int lw = bitmap ? max(bit_len(max_q >> 5), 5) : 0;")],
        "groups' sets G words apart (other banks)": [
            ("uint32_t s_set[C::RPC * C::SLOTS];", "uint32_t s_set[C::RPC * (C::SLOTS + C::G)];"),
            ("uint32_t* set = s_set + slot * C::SLOTS;",
             "uint32_t* set = s_set + slot * (C::SLOTS + C::G);")],
        "no distinct count (timing only)": [(
            "    __syncwarp();  // the set's last count is over",
            "    need = false;\n    __syncwarp();")],
    },
    "parent": {
        "the kernel": [],
        "no count (timing only)": [
            ("const int n_lut = lut_count(q, lane);", "const int n_lut = 0;"),
            ("n_lut_d = lut_count(qd, lane);", "n_lut_d = 0;")],
        "no validity words (timing only)": [
            ("        cnt = block_valid<VPL>(valid, b, vw);",
             "        for (int k = 0; k < VPL; ++k) vw[k] = FULL;\n        cnt = MB * MB;")],
        "4 warps a CTA": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
        "16 warps a CTA": [("constexpr int WARPS = 8;", "constexpr int WARPS = 16;")],
    },
}
OUT = Path(".tree_check/k1lut_variants")


def build_variants(build, which):
    OUT.mkdir(parents=True, exist_ok=True)
    base = (build.SRC_DIR / "encode.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(EDITS[which].items()):
        src = base
        for old, new in edits:
            assert src.count(old) == 1, f"encode.cu no longer has {old!r} once"
            src = src.replace(old, new)
        vdir = OUT / f"{which}{i}"
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
            if "Compiling" in line and "encode_blocks_lut_kernel" in line:
                used = [x.strip() for x in lines[i + 1:i + 5] if "Used" in x or "spill" in x]
                inst = line.split("'")[1] if "'" in line else line
                print(f"{name}: ptxas {inst}: {' '.join(used)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main():
    args = sys.argv[1:]
    tree = HERE
    if "--tree" in args:
        i = args.index("--tree")
        tree = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    which = args[0] if args else "kernel"
    if which not in EDITS or len(args) > 1:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_k1lut.py needs a CUDA GPU")
    import chip_smoke as cs
    from lerc_tpu_torch.kernels import build

    if not build.__file__.startswith(str(tree)):
        raise SystemExit(f"imported {build.__file__}, not the tree {tree}")
    spec = importlib.util.spec_from_file_location("chip_compare_here", HERE / "chip_compare.py")
    cc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc)
    card = cs.card_line()
    print(f"{card} | tree {tree} | set {which}", flush=True)
    build.build_all()
    libs = build_variants(build, which)
    sets = cc.k1lut_sets(cs, torch.device("cuda"))
    base = next(iter(libs))
    build._libs["encode"] = libs[base]
    want = {label: [c() for c in calls] for label, calls in sets.items()}
    for name, lib in libs.items():
        if name == base or "timing only" in name:
            continue
        build._libs["encode"] = lib
        for label, calls in sets.items():
            for c, w in zip(calls, want[label]):
                got = c()
                cs.require(all(torch.equal(a, b) for a, b in zip(got, w)),
                           f"variant {name} != the unedited kernel ({label})")
    print("every variant but the timing-only ones equal to the unedited kernel", flush=True)
    del want
    for label, calls in sets.items():
        times = {name: [] for name in libs}
        for rnd in range(5):
            order = list(libs.items())
            for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                build._libs["encode"] = lib
                rows = cs.profiled_rows(calls, 10, cc.K1LUT)
                cs.require(rows is not None, f"no device time for {name}")
                times[name].append(sum(r[2] for r in rows if cc.K1LUT[0] in r[0]) / 1e3
                                   / (10 * len(calls)))
        for name, t in times.items():
            print(f"K1 {label} {name}: median {float(np.median(t)):.4f} ms ({min(t):.4f}-"
                  f"{max(t):.4f}) [{card}]", flush=True)


if __name__ == "__main__":
    main()
