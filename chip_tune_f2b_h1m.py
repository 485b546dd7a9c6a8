#!/usr/bin/env python3
"""Time build variants of F2b (`fpl_packbits_size` in
lerc_tpu_torch/kernels/fpl.cu) and of the masked H1
(`huffman_symbols_masked` in lerc_tpu_torch/kernels/huffman.cu) on one
GPU, in turns.

    python3 chip_tune_f2b_h1m.py

Each variant is the source with a text edit or two: the kernel as it is,
and, for timing only, a part skipped (F2b: the join; the masked H1: the
histogram, the global stores) or the masked H1 traced (globaltimer stamps
of each tile's phases, its timeline printed after the times). Each is
compiled by nvcc with the package's own flags into
.tree_check/f2b_h1m_variants/ and loaded with ctypes. Every variant but
the timing-only ones is first held to its plain version on every input.
Inputs: F2b on the planes of the four float32 DEM tiles (predictor 1,
levels (2, 1, 0, 0)) and of the four float64 tiles
(predictor 0, levels (0, 1, 1, 3, 3, 2, 1, 1)), each set round-robin past
the L2; the masked H1 on the uint8 three-band tile with the bench mask.
Timing: 5 rounds of one torch.profiler window of 10 calls of each input
per variant, the order reversed every other round, the time of the
kernel and its memset. Prints each variant's ptxas line and its median
and spread in ms per call against the bytes bound.
"""
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from lerc_tpu_torch.constants import DataType
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_fpl as F
from lerc_tpu_torch.ops import device_huffman as dh

HIST = ("atomicAdd(&hist[a], 1u);", "atomicAdd(&hist[256 + e], 1u);")


def stamp(k):
    """The traced build's stamp k of tile t: globaltimer, by thread 0."""
    return ('{ unsigned long long g_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_)); '
            f'if (threadIdx.x == 0) h1m_trace[(long long)t * 8 + {k}] = g_; }}')


# the traced build: six stamps a tile and its SM, into a device array read
# back by h1m_trace_copy
TRACE = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long h1m_trace[4096 * 8];\n"),
    ("        if (t >= n_tiles) break;\n", "        if (t >= n_tiles) break;\n" + stamp(0) + "\n"),
    ("        const int nvt = __popc(vb);\n", stamp(1) + "\n        const int nvt = __popc(vb);\n"),
    ("        svb[tid] = vb;\n        __syncthreads();\n",
     "        svb[tid] = vb;\n        __syncthreads();\n" + stamp(2) + "\n"),
    ("        for (int k0 = 0; k0 < (D ? D : d); k0 += DS) {\n",
     stamp(3) + "\n        for (int k0 = 0; k0 < (D ? D : d); k0 += DS) {\n"),
    ("            __syncthreads();\n            const long long gap = tp0 - R, inv = tpx - c;",
     "            __syncthreads();\n" + stamp(4)
     + "\n            const long long gap = tp0 - R, inv = tpx - c;"),
    ("            __syncthreads();  // the buffers and sh_t are the next group's or tile's\n",
     "            __syncthreads();  // the buffers and sh_t are the next group's or tile's\n"
     + stamp(5) + '\n            { unsigned s_; asm volatile("mov.u32 %0, %%smid;" : "=r"(s_)); '
     "if (threadIdx.x == 0) h1m_trace[(long long)t * 8 + 6] = s_; }\n"),
    ("}  // namespace\n", "}  // namespace\n\nextern \"C\" int h1m_trace_copy(void* dst) {\n"
     "    return (int)cudaMemcpyFromSymbol(dst, h1m_trace, sizeof(h1m_trace));\n}\n"),
]
TRACED = "H1m, traced (timing only)"
VARIANTS = {  # name: (source, text edits, timing only)
    "F2b, the kernel": ("fpl", [], False),
    "F2b, no join (timing only)": ("fpl", [("    if (!sh_last) return;", "    return;")], True),
    "H1m, the kernel": ("huffman", [], False),
    "H1m, no histogram (timing only)": ("huffman", [(x, ";") for x in HIST], True),
    "H1m, no global stores (timing only)": (
        "huffman", [("store_tile<H1M_THREADS>(", "if (false) store_tile<H1M_THREADS>("),
                    ("zero_bytes<H1M_THREADS>(", "if (false) zero_bytes<H1M_THREADS>(")], True),
    TRACED: ("huffman", TRACE, True),
}
OUT = Path(".tree_check/f2b_h1m_variants")
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (source, edits, _t)) in enumerate(VARIANTS.items()):
        src = (build.SRC_DIR / f"{source}.cu").read_text()
        for old, new in edits:
            assert old in src, f"{source}.cu no longer has {old!r}"
            src = src.replace(old, new, 1 if name == TRACED else -1)
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so, source)
    fns = {}
    for name, (proc, so, source) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        kernel = ("fpl_packbits_size_kernel" if source == "fpl"
                  else "huffman_symbols_masked_kernelILi3")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if kernel in line and "Compiling" in line:
                print(f"{name}: ptxas: {' '.join(x.strip() for x in lines[i + 1:i + 4])}",
                      flush=True)
        lib = ctypes.CDLL(str(so))
        if source == "fpl":
            fn = lib.fpl_packbits_size
            fn.argtypes = [P, I, L, L, P, L, P, P]
            lib.fpl_packbits_scratch.restype = L
            lib.fpl_packbits_scratch.argtypes = [L, I]
        else:
            fn = lib.huffman_symbols_masked
            fn.argtypes = [P, P, I, I, I, I, P, L, P, P, L, P]
            lib.huffman_symbols_masked_scratch.restype = L
            lib.huffman_symbols_masked_scratch.argtypes = [I, I]
        fns[name] = (lib, fn)
    return fns


def run_f2b(variant, planes, n):
    lib, fn = variant
    n_pl = planes.shape[0]
    n_scratch = lib.fpl_packbits_scratch(n, n_pl)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=planes.device)
    sizes = torch.empty(n_pl, dtype=torch.int32, device=planes.device)
    err = fn(planes.data_ptr(), n_pl, planes.shape[1], n, scratch.data_ptr(), n_scratch,
             sizes.data_ptr(), build.launch_stream(planes))
    cs.require(err == 0, f"fpl_packbits_size launch failed: cudaError {err}")
    return sizes


def run_h1m(variant, data, mask):
    lib, fn = variant
    h, w, d = data.shape
    n_pad = -(-h * w * d // dh.GROUP) * dh.GROUP
    n_scratch = lib.huffman_symbols_masked_scratch(h, w)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=data.device)
    direct = torch.empty(n_pad, dtype=torch.uint8, device=data.device)
    delta = torch.empty(n_pad, dtype=torch.uint8, device=data.device)
    err = fn(data.data_ptr(), mask.data_ptr(), h, w, d, 0, scratch.data_ptr(), n_scratch,
             direct.data_ptr(), delta.data_ptr(), n_pad, build.launch_stream(data))
    cs.require(err == 0, f"huffman_symbols_masked launch failed: cudaError {err}")
    return direct, delta, scratch[:2048].view(torch.int32).view(2, 256)


def main():
    card = cs.card_line()
    print(card, flush=True)
    fns = build_variants()
    dev = torch.device("cuda")
    n = cs.TILE * cs.TILE
    tiles = cs.make_tiles(4, cs.TILE, dev)
    sets = {
        "F2b float32 (4 planes)": [F.fpl_finalize(t, 1, (2, 1, 0, 0))[0] for t in tiles],
        "F2b float64 (8 planes)": [F.fpl_finalize(t, 0, (0, 1, 1, 3, 3, 2, 1, 1))[0]
                                   for t in cs.make_tiles64(4, cs.TILE, dev)],
    }
    u8 = cs.int_cell_tiles(tiles[:1], np.uint8, 3)[0].to(torch.int32).contiguous()
    mask = torch.from_numpy(cs.bench_mask()).to(dev)
    nv = int(mask.sum())
    bounds = {"F2b float32 (4 planes)": 4 * n + 16, "F2b float64 (8 planes)": 8 * n + 32,
              "H1m uint8 x 3, bench mask": 4 * 3 * nv + n + 2 * 3 * nv + 2048}
    calls = {}
    for label, planes in sets.items():
        want = [F.fpl_packbits_size_ref(q, n) for q in planes]
        calls[label] = {}
        for name, fn in fns.items():
            if not name.startswith("F2b"):
                continue
            if not VARIANTS[name][2]:
                cs.require(all(torch.equal(run_f2b(fn, q, n), x) for q, x in zip(planes, want)),
                           f"{name} != plain ({label})")
            calls[label][name] = [lambda fn=fn, q=q: run_f2b(fn, q, n) for q in planes]
    want = dh.symbol_streams_device_ref(u8, mask, DataType.BYTE)
    calls["H1m uint8 x 3, bench mask"] = {}
    for name, fn in fns.items():
        if not name.startswith("H1m"):
            continue
        if not VARIANTS[name][2]:
            got = run_h1m(fn, u8, mask)
            cs.require(all(torch.equal(a, b) for a, b in zip(got, want)), f"{name} != plain")
        calls["H1m uint8 x 3, bench mask"][name] = [lambda fn=fn: run_h1m(fn, u8, mask)]
    print("every variant but the timing-only ones equal to its plain version", flush=True)
    for label, per in calls.items():
        pat = "fpl_packbits_size_kernel" if label.startswith("F2b") else "huffman_symbols_masked"
        times = {name: [] for name in per}
        for rnd in range(5):
            order = list(per.items())
            for name, fs in (order if rnd % 2 == 0 else order[::-1]):
                rows = cs.profiled_rows(fs, 10, (pat,))
                cs.require(rows is not None, f"no device time for {name}")
                times[name].append(sum(r[2] for r in rows if pat in r[0] or "Memset" in r[0])
                                   / 1e3 / (10 * len(fs)))
        bound = bounds[label] / cs.HBM_BYTES_PER_S * 1e3
        for name, t in times.items():
            m = float(np.median(t))
            print(f"{label} {name}: median {m:.4f} ms ({min(t):.4f}-{max(t):.4f}), "
                  f"{bound / m:.1%} of the {bound:.4f} ms bound [{card}]", flush=True)
    phases(fns[TRACED], u8, mask, card)


def phases(variant, u8, mask, card):
    """The traced build's timeline of one call: per tile, the time of each
    phase (the loads, to the pixels' bytes; the scan and look-back; the
    symbols; the barrier before the stores; the stores), and when the
    tiles start."""
    lib, _fn = variant
    for _ in range(3):
        run_h1m(variant, u8, mask)
    torch.cuda.synchronize()
    buf = np.zeros(4096 * 8, np.uint64)
    cs.require(lib.h1m_trace_copy(ctypes.c_void_p(buf.ctypes.data)) == 0, "trace copy failed")
    n_tiles = -(-u8.shape[0] * u8.shape[1] // 2048)
    tr = buf.reshape(4096, 8)[:n_tiles].astype(np.int64)
    t0 = tr[:, 0].min()
    print(f"H1m traced call: {n_tiles} tiles over {(tr[:, 5].max() - t0) / 1e3:.2f} us [{card}]")
    names = ("loads", "scan and look-back", "symbols", "barrier", "stores")
    for name, col in zip(names, np.diff(tr[:, :6], axis=1).T):
        print(f"  {name}: mean {col.mean() / 1e3:.2f} us a tile, median "
              f"{np.median(col) / 1e3:.2f}, p90 {np.percentile(col, 90) / 1e3:.2f}")
    span = tr[:, 5] - tr[:, 0]
    print(f"  a tile: mean {span.mean() / 1e3:.2f} us; tiles an SM {np.bincount(tr[:, 6]).min()}"
          f"-{np.bincount(tr[:, 6]).max()}")
    starts = np.sort(tr[:, 0] - t0) / 1e3
    print("  tile starts, us (every 128th):", " ".join(f"{x:.1f}" for x in starts[::128]),
          flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_f2b_h1m.py needs a CUDA GPU")
    main()
