#!/usr/bin/env python3
"""Time build variants of the float32 K4 (`decode_records`,
`decode_records_masked`: decode_records_strip_f32_kernel in
lerc_tpu_torch/kernels/decode.cu) on one GPU, in turns.

    python3 chip_tune_k4f32.py

Each variant is decode.cu with a text edit (built as chip_tune_k4k6.py
builds its own, into .tree_check/k4f32_variants/): launch bounds asking for
no minimum of CTAs an SM (the compiler's choice of registers), a minimum
of 1, 6 and 7 instead of the kernel's 8, the loop over a thread's pixels
unrolled (at 8 CTAs and at the compiler's choice), no staged fast path
(every value read through the checked path), and, for timing only, no
values (what is left is the index, the staging, the parse and the image's
stores) and, under a mask, no ranks (each valid position read at its own
index: the mask's per-pixel cost). Every variant but the timing-only ones
is first held to decode_records_ref on tile 0, all-valid and masked, then
timed on the four 2048^2 DEM tiles encoded by FusedResidentCodec at
maxZError 0.001, nb_cap 0, all-valid and with the bench mask, round-robin:
5 rounds of one torch.profiler window of 10 calls of each tile per
variant, the order reversed every other round. Prints each variant's
ptxas lines, median and spread in ms per call, and its share of the bytes
bound.
"""
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import chip_tune_k4k6 as tk
from lerc_tpu_torch import FusedResidentCodec
from lerc_tpu_torch.kernels import build
from lerc_tpu_torch.ops import device_decode as dec

LOOP = ("#pragma unroll 1\n        for (int k = 0; k < STRIP_PPT; ++k) {\n"
        "            const int bl = bl0 + k * KB;\n            if (bl >= n_s) break;\n"
        "            int rank = j;")
MIN = "(STRIP_THREADS, 8) decode_records_strip_f32_kernel("  # the float32 launch bounds
UNROLL = (LOOP, LOOP.replace("#pragma unroll 1", "#pragma unroll"))
EDITS = {  # name: text edits of decode.cu (none: the kernel as it is)
    "the kernel": [],
    "the compiler's registers": [(MIN, MIN.replace(", 8)", ")"))],
    "a minimum of 1 CTA an SM": [(MIN, MIN.replace(", 8)", ", 1)"))],
    "6 CTAs an SM": [(MIN, MIN.replace(", 8)", ", 6)"))],
    "7 CTAs an SM": [(MIN, MIN.replace(", 8)", ", 7)"))],
    "k-loop unrolled": [UNROLL],
    "the compiler's registers, k-loop unrolled": [(MIN, MIN.replace(", 8)", ")")), UNROLL],
    "no fast path": [("const bool staged = pay >= sp.vlo", "const bool staged = false && pay >= sp.vlo")],
    # not decoders: every value skipped; the masked positions' ranks skipped
    "no values (timing only)": [(LOOP, LOOP.replace("if (bl >= n_s) break;", "break;"))],
    "no ranks (timing only)": [("rank = j < 32 ? __popc(w0 & lt) : __popc(w0) + __popc(w1 & lt);\n"
                                "                v = ((j < 32 ? w0 : w1) >> (j & 31)) & 1u;\n"
                                "            }\n            TS*",
                                "(void)lt;\n            }\n            TS*")],
}
TIMING_ONLY = {"no values (timing only)", "no ranks (timing only)"}
OUT = Path(".tree_check/k4f32_variants")


def k4(lib, a):
    """The wrapper's float32 K4 launch (all-valid, or masked with validity
    words) with a variant."""
    stream, starts, zmax, inv, h, w, d, version, cap_nb, lut_unfit, valid = a
    img = torch.empty(h, w, d, dtype=torch.float32, device=stream.device)
    flags = torch.ones(2, dtype=torch.int32, device=stream.device)
    err = lib.decode_records(stream.data_ptr(), 4 * stream.numel(), starts.data_ptr(),
                             None if valid is None else valid.data_ptr(), zmax.data_ptr(), inv,
                             h, w, d, int(version >= 5), cap_nb, int(lut_unfit), img.data_ptr(),
                             flags.data_ptr(), build.launch_stream(stream))
    cs.require(err == 0, f"decode_records launch failed: cudaError {err}")
    return img, flags


def main():
    card = cs.card_line()
    print(card, flush=True)
    libs = tk.build_variants(EDITS, OUT, ("decode_records_strip_f32_kernel",))
    dev = torch.device("cuda")
    tiles = cs.make_tiles(4, 2048, dev)
    sets = {}
    for label, m in (("K4", None), ("K4m", cs.bench_mask())):
        codec = FusedResidentCodec(2048, 2048, 1, np.float32, 0.001, mask=m)
        outs = [codec.encode_fast(t) for t in tiles]
        args = [(o[1], o[3], codec._zmax_vec(o[0]), 0.002, 2048, 2048, 1, codec.version, 32, False,
                 codec.valid) for o in outs]
        v_bytes = 0 if codec.valid is None else 4 * codec.valid.numel()
        n_bytes = float(np.mean([int(o[2][0]) for o in outs])) + 4 * codec.n_rec + 4 + v_bytes \
            + 4 * 2048 * 2048 + 8
        sets[label] = (args, n_bytes / cs.HBM_BYTES_PER_S * 1e3)
        want = dec.decode_records_ref(*args[0])
        for name, lib in libs.items():
            if name in TIMING_ONLY:
                continue
            got = k4(lib, args[0])
            cs.require(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                       and torch.equal(got[1], want[1]), f"{name}: {label} != plain")
    print(f"every variant but {sorted(TIMING_ONLY)} equal to plain on tile 0", flush=True)
    for label, (args, bound) in sets.items():
        times = {name: [] for name in libs}
        for rnd in range(5):
            order = list(libs.items())
            for name, lib in (order if rnd % 2 == 0 else order[::-1]):
                rows = cs.profiled_rows([lambda lib=lib, a=a: k4(lib, a) for a in args], 10,
                                        ("decode_records_strip",))
                cs.require(rows is not None, f"no device time for {name}")
                times[name].append(sum(r[2] for r in rows if "decode_records_strip" in r[0])
                                   / 1e3 / (10 * len(args)))
        for name, t in times.items():
            m = float(np.median(t))
            print(f"{label} {name}: median {m:.4f} ms ({min(t):.4f}-{max(t):.4f}), "
                  f"{bound / m:.1%} of the {bound:.4f} ms bound [{card}]", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("chip_tune_k4f32.py needs a CUDA GPU")
    main()
