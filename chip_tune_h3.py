#!/usr/bin/env python3
"""Time build variants of H3 (`huffman_decode` in
lerc_tpu_torch/kernels/huffman.cu) on one GPU, in turns.

    python3 chip_tune_h3.py

Each variant is huffman.cu with a text edit or two: the decode table's
prefix bits (11, 12, 13), a part removed (no fast path: every group
through the checked loop; no table: the canonical search over every
length; no staging: the stream read from global memory; direct stores:
each thread stores its group's 64 bytes itself), or the CTA size (64, 256
groups); and, for timing only, the kernel with every symbol skipped (its
table, staging and stores). Each is compiled by nvcc with the package's
own flags into .tree_check/h3_variants/ and loaded with ctypes. Every
variant but the timing-only one is first held to decode_stream_device_ref
(symbols, used bits, ok) on the first input of each set, on a sidecar with
one group's start moved and on a code of lengths 1..32, then timed on
chip_compare.py's h3 inputs (the four uint8 three-band tiles' delta
streams, plane 2 of the four float32 fpl tiles), round-robin: 5 rounds of
one torch.profiler window of 10 calls of each input per variant, the order
reversed every other round, the time of both its kernels (the table's and
the decode). Prints each variant's ptxas line, median and spread in ms per
call, and its share of the bytes bound (total / 8 + 8 g + n over 3.35
TB/s).
"""
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_compare as cc
import chip_smoke as cs
from lerc_tpu_torch.codec import huffman
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_huffman as dh

SRC = (build.SRC_DIR / "huffman.cu").read_text()
EDITS = {  # name: text edits of huffman.cu (none: the kernel as it is)
    "K 12 (the kernel)": [],
    "K 11": [("constexpr int DEC_K = 12;", "constexpr int DEC_K = 11;")],
    "K 13": [("constexpr int DEC_K = 12;", "constexpr int DEC_K = 13;")],
    "no fast path": [("if (tab.n_long == 0 && !bad", "if (false && !bad")],
    "no table": [("const bool is_long = lim > f && L > DEC_K;", "const bool is_long = lim > f;"),
                 ("for (int L = 1; L <= DEC_K; ++L) {", "for (int L = 1; L <= 0; ++L) {")],
    "no staging": [("const int n_stage = (int)((span + 3) & ~3ll);", "const int n_stage = 0;")],
    "direct stores": [
        ("unsigned* out = obuf + tid * DEC_OUT_ROW;",
         "unsigned* out = reinterpret_cast<unsigned*>(syms + g * GROUP);"),
        ("for (int i = tid; i < n_out * (GROUP / 16); i += DEC_THREADS) {",
         "for (int i = tid; i < 0; i += DEC_THREADS) {")],
    "64 groups a CTA": [("constexpr int DEC_THREADS = 128;", "constexpr int DEC_THREADS = 64;")],
    "256 groups a CTA": [("constexpr int DEC_THREADS = 128;",
                          "constexpr int DEC_THREADS = 256;")],
    # not a decoder: every symbol skipped, what is left is the table, the staging and the stores
    "no symbols (timing only)": [("if (tab.n_long == 0 && !bad", "if (false && !bad"),
                                 ("if (bad || !(lc & (1u << j))) continue;", "continue;")],
}
TIMING_ONLY = {"no symbols (timing only)"}
OUT = Path(".tree_check/h3_variants")
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(EDITS.items()):
        src = SRC
        for old, new in edits:
            assert old in src, f"huffman.cu no longer has {old!r}"
            src = src.replace(old, new)
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
            if "huffman_decode_kernel" in line and "Compiling" in line:
                print(f"{name}: ptxas: {' '.join(x.strip() for x in lines[i + 1:i + 4])}",
                      flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.huffman_decode
        fn.argtypes = [P, L, L, P, I, P, P, L, L, L, P, L, P, P, P, P]
        lib.huffman_decode_scratch.restype = L
        fns[name] = (fn, lib.huffman_decode_scratch())
    return fns


def run(variant, words, n_bits, sbits, consts, sorted_syms, layout):
    """The wrapper's launch with a variant's entry point."""
    fn, n_scratch = variant
    g = sbits.numel()
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=words.device)
    syms = torch.empty(g * dh.GROUP, dtype=torch.uint8, device=words.device)
    used = torch.empty(g, dtype=torch.int32, device=words.device)
    ok = torch.ones(1, dtype=torch.int32, device=words.device)
    err = fn(words.data_ptr(), words.numel(), n_bits, sbits.data_ptr(), g, consts.data_ptr(),
             sorted_syms.data_ptr(), *layout, scratch.data_ptr(), n_scratch, syms.data_ptr(),
             used.data_ptr(), ok.data_ptr(), build.launch_stream(words))
    cs.require(err == 0, f"huffman_decode launch failed: cudaError {err}")
    return syms, used, ok[0] != 0


def deep_code(dev):
    """H3 args of a canonical code with lengths 1..31, 32, 32 over 1,000 symbols."""
    lengths = np.zeros(256, np.int32)
    order = np.random.default_rng(3).permutation(256)[:33]
    lengths[order[:31]] = np.arange(1, 32)
    lengths[order[31:]] = 32
    codes = huffman.canonical_codes(lengths)
    n = 1000
    sym = torch.zeros(-(-n // dh.GROUP) * dh.GROUP, dtype=torch.uint8, device=dev)
    sym[:n] = torch.from_numpy(np.random.default_rng(4).choice(order, n).astype(np.uint8))
    words, tb, sbits = dh.encode_stream_device(sym, dh.code_table(lengths, codes, dev),
                                               (n, n, n), 1000 + 1)
    consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
    return (torch.cat([words, words.new_zeros(1)]), int(tb), sbits,
            torch.from_numpy(consts).to(dev), torch.from_numpy(sorted_syms).to(dev), (n, n, n))


def main():
    card = cs.card_line()
    print(card, flush=True)
    fns = build_variants()
    dev = torch.device("cuda")
    sets = cc.h3_inputs(cs, dev)
    checks = [a[0] for a in sets.values()] + [deep_code(dev)]
    moved = list(checks[0])
    moved[2] = checks[0][2].clone()
    moved[2][moved[2].numel() // 2] += 1
    checks.append(tuple(moved))
    for a in checks:
        want = dh.decode_stream_device_ref(*a)
        for name, fn in fns.items():
            got = run(fn, *a)
            cs.require(name in TIMING_ONLY or all(torch.equal(x, y) for x, y in zip(got, want)),
                       f"{name} != plain")
    print(f"every variant but {sorted(TIMING_ONLY)} equal to plain on {len(checks)} inputs",
          flush=True)
    for label, args in sets.items():
        times = {name: [] for name in fns}
        for rnd in range(5):
            order = list(fns.items())
            for name, fn in (order if rnd % 2 == 0 else order[::-1]):
                rows = cs.profiled_rows([lambda fn=fn, a=a: run(fn, *a) for a in args], 10,
                                        ("huffman_decode_kernel",))
                cs.require(rows is not None, f"no device time for {name}")
                times[name].append(sum(r[2] for r in rows if "huffman_decode" in r[0])
                                   / 1e3 / (10 * len(args)))  # the table's kernel and the decode
        _w, _nb, sbits, _c, _s, layout = args[0]
        total = int(sbits[-1]) + int(dh.decode_stream_device(*args[0])[1][-1])  # the bits
        bound = (total / 8 + 8 * sbits.numel() + layout[0]) / cs.HBM_BYTES_PER_S * 1e3
        for name, t in times.items():
            m = float(np.median(t))
            print(f"{label} {name}: median {m:.4f} ms ({min(t):.4f}-{max(t):.4f}), "
                  f"{bound / m:.1%} of the {bound:.4f} ms bound [{card}]", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_h3.py needs a CUDA GPU")
    main()
