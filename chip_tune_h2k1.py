#!/usr/bin/env python3
"""Time build variants of H2 (`huffman_encode`, kernels/huffman.cu) and the
integer K1 (`encode_blocks_int`, kernels/encode.cu) on one GPU, in turns.

    python3 chip_tune_h2k1.py [huffman] [encode]

(both sources when none is named). Each variant is the source with a text
edit: H2 with tiles of 4,096 and 2,048 symbols (256 and 128 threads; the
kernel's: 8,192), with 4-byte table entries (length and code, codes past 26
bits from the 8-byte table), and, for timing only, without its look-back
walk (tile t takes t times its own bits as its first bit), without its
pack, or without its stores to the stream; the integer K1 with strips of
1,024 and 512 pixels (record.cuh's STRIP_PX), a thread a record at every
depth (the kernel takes a thread a block at D = 1 and 3), its first pass
two rows at a time, its lossy pass unrolled, and, for timing only, without
the lossy second pass or without the record decisions. Each is compiled by
nvcc with the package's own flags in a folder of its own under
.tree_check/h2k1_variants/, beside its copy of record.cuh, and loaded with
ctypes. Every variant but the timing-only ones is first held to the plain
version (H2's words, total and sbits on the first uint8 three-band delta
stream; K1's rec_info, zrange and fits on the first tile of each cell),
then timed round-robin over the four tiles' inputs of chip_compare.py's h2
and k1int sets: 5 rounds of one torch.profiler window of 10 calls of each
input per variant, the order reversed every other round; H2 counts its
memset and kernel, K1 its kernel. Prints each variant's median and spread
in ms per call.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_compare as cc
import chip_smoke as cs
from lerc_tpu_torch.constants import DT_SIZE
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_encode as enc
from lerc_tpu_torch.ops import device_huffman as dh

EDITS = {
    "huffman": {
        "the kernel": [],
        "4,096-symbol tiles": [("constexpr int ENC_THREADS = 512,", "constexpr int ENC_THREADS = 256,")],
        "2,048-symbol tiles": [("constexpr int ENC_THREADS = 512,", "constexpr int ENC_THREADS = 128,")],
        "4-byte table entries": [
            ("    __shared__ uint2 lc[256];                       // (length, the code MSB-aligned)\n",
             "    __shared__ uint2 lc[256];                       // (length, the code MSB-aligned)\n"
             "    __shared__ unsigned lc32[256];\n"),
            ("        lc[i] = make_uint2((unsigned)L, L <= 0 ? 0u : c << (32 - min(L, 32)));  // L bits kept\n",
             "        lc[i] = make_uint2((unsigned)L, L <= 0 ? 0u : c << (32 - min(L, 32)));  // L bits kept\n"
             "        lc32[i] = (unsigned)L | (L > 0 && L <= 26 ? (c & ((1u << L) - 1u)) << 6 : 0u);\n"),
            ("            const uint2 e = lc[__byte_perm(sw[j >> 2], 0, 0x4440 | (j & 3))];\n"
             "            len[j] = e.x;\n            top[j] = e.y;\n",
             "            const unsigned sj = __byte_perm(sw[j >> 2], 0, 0x4440 | (j & 3));\n"
             "            const unsigned e = lc32[sj];\n            len[j] = e & 63u;\n"
             "            top[j] = len[j] > 26 ? lc[sj].y : __funnelshift_l(0u, e >> 6, 32 - len[j]);\n")],
        "no walk (timing only)": [("const unsigned long long pre = lookback_walk<H2Look>(lb, t, tot);",
                                   "const unsigned long long pre = (unsigned long long)t * tot;")],
        "no pack (timing only)": [("for (int j = 0; j < 16; ++j) {\n                hi |=",
                                   "for (int j = 0; j < 0; ++j) {\n                hi |=")],
        "no stores (timing only)": [("        if (tot > 0) {\n            // out word x", "        if (tot > 1u << 30) {\n            // out word x")],
    },
    "encode": {
        "the kernel": [],
        "1,024-pixel strips": [("constexpr int STRIP_PX = 2048;", "constexpr int STRIP_PX = 1024;")],
        "512-pixel strips": [("constexpr int STRIP_PX = 2048;", "constexpr int STRIP_PX = 512;")],
        "a thread a record at D = 1 and 3": [
            ("if (g.dc == d && d == 1)\n", "if (false)\n"),
            ("else if (g.dc == d && d == 3)\n", "else if (false)\n")],
        "pass-1 rows two at a time": [("#pragma unroll\n                for (int r = 0; r < 8; ++r) {\n                    uint32_t wd",
                                       "#pragma unroll 2\n                for (int r = 0; r < 8; ++r) {\n                    uint32_t wd")],
        "lossy pass unrolled": [("#pragma unroll 1\n                    for (int r = 0; r < 8; ++r) {  // a row",
                                 "#pragma unroll\n                    for (int r = 0; r < 8; ++r) {  // a row")],
        "no lossy pass (timing only)": [("if (!P.lossless) {  // lossy: the quanta",
                                         "if (false) {  // lossy: the quanta")],
        "no decisions (timing only)": [("int_decide<MASKED>(P, flip, cnt, a[k], mq[k]",
                                        "if (P.dt < 0) int_decide<MASKED>(P, flip, cnt, a[k], mq[k]")],
    },
}
OUT = Path(".tree_check/h2k1_variants")
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def build_variants(sources):
    OUT.mkdir(parents=True, exist_ok=True)
    header = (build.SRC_DIR / "record.cuh").read_text()
    procs = {}
    for src_name in sources:
        base = (build.SRC_DIR / f"{src_name}.cu").read_text()
        for i, (name, edits) in enumerate(EDITS[src_name].items()):
            src, hdr = base, header
            for old, new in edits:
                assert old in src or old in hdr, f"{src_name}.cu no longer has {old!r}"
                if old in src:
                    src = src.replace(old, new)
                else:
                    hdr = hdr.replace(old, new)
            vdir = OUT / f"{src_name}{i}"
            vdir.mkdir(exist_ok=True)
            cu, so = vdir / f"{src_name}.cu", vdir / f"{src_name}.so"
            cu.write_text(src)
            (vdir / "record.cuh").write_text(hdr)  # found before the package's, beside the .cu
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
            if "Compiling" in line and ("huffman_encode_kernel" in line
                                        or "encode_blocks_int_kernelIhLb0ELi3" in line):
                used = [x.strip() for x in lines[i + 1:i + 5] if "Used" in x or "spill" in x]
                print(f"{key[0]} {key[1]}: ptxas: {' '.join(used)}", flush=True)
        lib = ctypes.CDLL(str(so))
        if key[0] == "huffman":
            lib.huffman_encode.argtypes = [P, L, P, L, L, L, P, L, P, L, P]
            lib.huffman_encode_scratch.argtypes = [L, L]
            lib.huffman_encode_scratch.restype = L
        else:
            lib.encode_blocks_int.argtypes = [P, I, P] + [I] * 5 + [F, F, I, I, F] + [I] * 4 + [P] * 4
        libs[key] = lib
    return libs


def h2(lib, a):
    """encode_stream_device's launch with a variant: (words, total, sbits)."""
    sym, table, (n_total, plane, n_live), cap = a
    n_buf = lib.huffman_encode_scratch(sym.numel(), cap)
    buf = torch.empty(n_buf, dtype=torch.uint8, device=sym.device)
    sbits = torch.empty(sym.numel() // 64, dtype=torch.int32, device=sym.device)
    err = lib.huffman_encode(sym.data_ptr(), sym.numel(), table.data_ptr(), n_total, plane,
                             n_live, buf.data_ptr(), n_buf, sbits.data_ptr(), cap,
                             build.launch_stream(sym))
    cs.require(err == 0, f"huffman_encode launch failed: cudaError {err}")
    return buf[16:16 + 4 * cap].view(torch.int32), buf[:4].view(torch.int32)[0], sbits


def k1(lib, a):
    """encode_blocks's integer launch (all-valid) with a variant."""
    x, p, _valid = a
    h, w, d = x.shape
    rec_info, zrange, fits = enc._k1_outputs(x, p, 8)
    err = lib.encode_blocks_int(x.data_ptr(), enc._in_type(x), None, h, w, d, int(p.dt),
                                DT_SIZE[p.dt], p.mze, p.scale, p.inv_i, int(p.lossless),
                                p.maxq_cap, p.integ_mask, p.cap_nb, int(p.raw_ok),
                                int(p.diff_ok and d > 1), rec_info.data_ptr(), zrange.data_ptr(),
                                fits.data_ptr(), build.launch_stream(x))
    cs.require(err == 0, f"encode_blocks_int launch failed: cudaError {err}")
    return rec_info, zrange, fits


def timed(label, libs, fn, args, match, card):
    times = {name: [] for name in libs}
    for rnd in range(5):
        order = list(libs.items())
        for name, lib in (order if rnd % 2 == 0 else order[::-1]):
            rows = cs.profiled_rows([lambda lib=lib, a=a: fn(lib, a) for a in args], 10, match)
            cs.require(rows is not None, f"no device time for {name}")
            times[name].append(sum(r[2] for r in rows if any(m in r[0] for m in match)) / 1e3
                               / (10 * len(args)))
    for name, t in times.items():
        print(f"{label} {name}: median {float(np.median(t)):.4f} ms ({min(t):.4f}-{max(t):.4f}) "
              f"[{card}]", flush=True)


def main():
    card = cs.card_line()
    print(card, flush=True)
    sources = sys.argv[1:] or list(EDITS)
    if any(x not in EDITS for x in sources):
        raise SystemExit(__doc__)
    libs = build_variants(sources)
    dev = torch.device("cuda")
    h2_sets = cc.h2_inputs(cs, dev) if "huffman" in sources else {}
    for (src, name), lib in libs.items():
        if src != "huffman" or "timing only" in name:
            continue
        a = h2_sets["u8x3"][0]
        got, want = h2(lib, a), dh.encode_stream_device_ref(*a)
        cs.require(torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
                   and torch.equal(got[2], want[2]), f"H2 {name} != plain")
    k1_sets = ({k: v for k, v in cc.k1int_inputs(cs, dev).items() if not k.startswith("f32")}
               if "encode" in sources else {})
    for (src, name), lib in libs.items():
        if src != "encode" or "timing only" in name:
            continue
        for label, args in k1_sets.items():
            got, want = k1(lib, args[0]), enc.encode_blocks_ref(*args[0])
            cs.require(all(torch.equal(g, w) for g, w in zip(got, want)),
                       f"K1 {name} != plain ({label})")
    print("every variant but the timing-only ones equal to plain", flush=True)
    h2_libs = {n: lib for (s, n), lib in libs.items() if s == "huffman"}
    k1_libs = {n: lib for (s, n), lib in libs.items() if s == "encode"}
    for label, args in h2_sets.items():
        timed(f"H2 {label}", h2_libs, h2, args, ("huffman_encode", "Memset"), card)
    for label, args in k1_sets.items():
        timed(f"K1 {label}", k1_libs, k1, args, ("encode_blocks_int",), card)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_h2k1.py needs a CUDA GPU")
    main()
