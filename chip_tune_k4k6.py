#!/usr/bin/env python3
"""Time build variants of the strip kernels -- the integer K4
(`decode_records_int`) and K6 (`decode_scanned`) in
lerc_tpu_torch/kernels/decode.cu -- on one GPU, in turns.

    python3 chip_tune_k4k6.py

Each variant is decode.cu with a text edit or two: the CTA size (512
threads), smaller strips (1,024 pixels), the loop over a thread's pixels
unrolled (K4, K6), launch bounds asking for more CTAs an SM (K4 8, K6 6),
no staged fast path (every value read through the checked path, staged
bytes or the stream), no staging (every record read from global memory, as
before the redesign), and, for timing only, the kernels with their values
skipped (what is left is the index or descriptors, the staging, the parse
and the image's stores). Each is compiled by nvcc with the package's own
flags into .tree_check/k4k6_variants/ and loaded with ctypes. Every variant
but the timing-only one is first held to the plain versions on the first tile
(K4's image and flags, K6's image and ok), then timed on the four uint8
three-band tiles of chip_compare.py's k4int (v6) round-robin: 5 rounds of
one torch.profiler window of 10 calls of each tile per variant, the order
reversed every other round. Prints each variant's ptxas lines, median and
spread in ms per call, and its share of the bytes bound.
"""
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_compare as cc
import chip_smoke as cs
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_decode as dec
from lerc_tpu_torch.ops import device_scan as scan

SRC = (build.SRC_DIR / "decode.cu").read_text()
EDITS = {  # name: text edits of decode.cu (none: the kernels as they are)
    "the kernels": [],
    "512 threads": [("constexpr int STRIP_THREADS = 256;", "constexpr int STRIP_THREADS = 512;")],
    "1,024-pixel strips": [("constexpr int STRIP_PX = 2048;", "constexpr int STRIP_PX = 1024;")],
    "no fast path": [("const bool staged = pay >= sp.vlo", "const bool staged = false && pay >= sp.vlo"),
                     ("if ((m8 == 1 || (m8 == 0 && SIZE <= 4)) && pp >= sp.vlo",
                      "if (false && pp >= sp.vlo")],
    "K4 k-loop unrolled": [("#pragma unroll 1\n        for (int k = 0; k < STRIP_PPT; ++k) {\n"
                            "            const int bl = bl0 + k * KB;\n            if (bl >= n_s) break;\n"
                            "            int rank = j;",
                            "#pragma unroll\n        for (int k = 0; k < STRIP_PPT; ++k) {\n"
                            "            const int bl = bl0 + k * KB;\n            if (bl >= n_s) break;\n"
                            "            int rank = j;")],
    "K6 k-loop unrolled": [("#pragma unroll 1\n        for (int k = 0; k < STRIP_PPT; ++k) {\n"
                            "            const int bl = bl0 + k * KB;\n            if (bl >= n_s) break;\n"
                            "            V prev",
                            "#pragma unroll\n        for (int k = 0; k < STRIP_PPT; ++k) {\n"
                            "            const int bl = bl0 + k * KB;\n            if (bl >= n_s) break;\n"
                            "            V prev")],
    "K4 at 8 CTAs an SM": [("__launch_bounds__(STRIP_THREADS) decode_records_strip_kernel(",
                            "__launch_bounds__(STRIP_THREADS, 8) decode_records_strip_kernel(")],
    "K6 at 6 CTAs an SM": [("__launch_bounds__(STRIP_THREADS) decode_scanned_kernel(",
                            "__launch_bounds__(STRIP_THREADS, 6) decode_scanned_kernel(")],
    "no staging": [("const long long len = end > lo ? min((long long)STRIP_IN, end - sp.gb) : 0;",
                    "const long long len = 0;")],
    # not a decoder: every value skipped
    "no values (timing only)": [("if (bl >= n_s) break;", "break;")],
}
TIMING_ONLY = {"no values (timing only)"}
OUT = Path(".tree_check/k4k6_variants")
P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double


def build_variants(variants=EDITS, out=OUT,
                   show=("decode_records_strip_kernelIhLb0E", "decode_scanned_kernelIhLb1ELi8ELb0")):
    """{name: the loaded library} of each variant of decode.cu; prints the
    ptxas lines of the kernels whose mangled names hold a string of `show`."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = SRC
        for old, new in edits:
            assert old in src, f"decode.cu no longer has {old!r}"
            src = src.replace(old, new)
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
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
            if "Compiling" in line and any(s in line for s in show):
                print(f"{name}: ptxas: {line.split(chr(39))[1][35:80]}: "
                      f"{' '.join(x.strip() for x in lines[i + 2:i + 4])}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.decode_records.argtypes = [P, L, P, P, P, D] + [I] * 6 + [P] * 3
        lib.decode_records_int.argtypes = [P, L, P, P, P] + [I] * 10 + [P] * 3
        lib.decode_scanned.argtypes = [P, L] + [P] * 10 + [D] + [I] * 8 + [P] * 3
        libs[name] = lib
    return libs


def k4(lib, a):
    """The wrapper's K4 launch (decode_records_int, all-valid) with a variant."""
    stream, starts, zmax, inv_i, h, w, d, dt, version = a[:9]
    img = torch.empty(h, w, d, dtype=torch.uint8, device=stream.device)
    flags = torch.ones(2, dtype=torch.int32, device=stream.device)
    err = lib.decode_records_int(stream.data_ptr(), 4 * stream.numel(), starts.data_ptr(), None,
                                 zmax.data_ptr(), inv_i, h, w, d, int(dt), 1, 0, int(version >= 5),
                                 32, 0, img.data_ptr(), flags.data_ptr(),
                                 build.launch_stream(stream))
    cs.require(err == 0, f"decode_records_int launch failed: cudaError {err}")
    return img, flags


def k6(lib, a):
    """The wrapper's K6 launch (decode_scanned, all-valid, 8x8) with a variant."""
    s, mode, ppos, off, nb, ne, lpos, nlut, nbl, _v, mze, zmax, h, w, d, dt = a[:16]
    img = torch.empty(h, w, d, dtype=torch.uint8, device=s.device)
    ok = torch.ones(1, dtype=torch.int32, device=s.device)
    err = lib.decode_scanned(s.data_ptr(), 4 * s.numel(), *(t.data_ptr() for t in (
        mode, ppos, off, nb, ne, lpos, nlut, nbl)), None, zmax.data_ptr(), 2.0 * mze,
        dec._inv_i(mze), h, w, d, 8, int(dt), 1, 0, img.data_ptr(), ok.data_ptr(),
        build.launch_stream(s))
    cs.require(err == 0, f"decode_scanned launch failed: cudaError {err}")
    return img, ok[0] != 0


def main():
    card = cs.card_line()
    print(card, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    codec, _tiles, outs = cc.u8x3_sets(cs, dev, 6)
    a4 = [(o[1], o[3], codec._zmax_vec(o[0]), dec._inv_i(0.5), 2048, 2048, 3, codec.dt, 6)
          for o in outs]
    a6 = []
    for o in outs:
        k = scan.scan_records(o[1], codec.n_rec, codec.dt, 6, o[2][0].reshape(1))
        a6.append((o[1], k[1], k[5], k[2], k[3], k[4], k[6], k[7], k[8], None, 0.5,
                   codec._zmax_vec(o[0]), 2048, 2048, 3, codec.dt))
    want4 = dec.decode_records_int_ref(*a4[0], 32, False)
    want6 = dec.decode_scanned_ref(*a6[0][:10], 1.0, dec._inv_i(0.5), a6[0][11], 2048, 2048, 3,
                                   codec.dt)
    for name, lib in libs.items():
        if name in TIMING_ONLY:
            continue
        got4, got6 = k4(lib, a4[0]), k6(lib, a6[0])
        cs.require(torch.equal(got4[0], want4[0]) and torch.equal(got4[1], want4[1]),
                   f"{name}: K4 != plain")
        cs.require(torch.equal(got6[0], want6[0]) and bool(got6[1]) == bool(want6[1]),
                   f"{name}: K6 != plain")
    print(f"every variant but {sorted(TIMING_ONLY)} equal to plain on tile 0", flush=True)
    total = float(np.mean([int(o[2][0]) for o in outs]))
    n_rec, n_px = codec.n_rec, 2048 * 2048 * 3
    bounds = {"K4": (total + 4 * n_rec + 12 + n_px + 8) / cs.HBM_BYTES_PER_S * 1e3,
              "K6": (total + 16 * n_rec + 12 + n_px) / cs.HBM_BYTES_PER_S * 1e3}
    for label, fn, args, match in (("K4", k4, a4, "decode_records_strip"),
                                   ("K6", k6, a6, "decode_scanned")):
        times = {name: [] for name in libs}
        for rnd in range(5):
            order = list(libs.items())
            for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                rows = cs.profiled_rows([lambda lib=lib, a=a: fn(lib, a) for a in args], 10,
                                        (match,))
                cs.require(rows is not None, f"no device time for {name}")
                times[name].append(sum(r[2] for r in rows if match in r[0]) / 1e3
                                   / (10 * len(args)))
        for name, t in times.items():
            m = float(np.median(t))
            print(f"{label} {name}: median {m:.4f} ms ({min(t):.4f}-{max(t):.4f}), "
                  f"{bounds[label] / m:.1%} of the {bounds[label]:.4f} ms bound [{card}]",
                  flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_k4k6.py needs a CUDA GPU")
    main()
