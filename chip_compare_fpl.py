#!/usr/bin/env python3
"""Time the float32 fpl kernels (F1, F2, F2b, F3) and the Huffman kernels
H2 and H3 of two checkouts on one GPU, in turns: parent, change, change,
parent. The kernels of `kernels/fpl.cu` and `kernels/block_scan.cuh` serve
float32 and float64 from one template; this holds the float32 instances to
an older checkout's.

    python3 chip_compare_fpl.py PARENT_DIR

PARENT_DIR is an unpacked checkout of the older commit (`git archive`).
Each turn runs in its own process (both trees name their package
lerc_tpu_torch) and builds that tree's kernels on first use. Inputs: four
2048^2 float32 DEM tiles round-robin (past the 50 MB L2), predictor 1,
levels (2, 1, 0, 0), H2/H3 on plane 2; CUDA events over 20 rounds (10 for
F3 and H3), launch gaps included. Prints one line per turn, ms per call.
"""
import subprocess
import sys
from pathlib import Path


def turn(tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from lerc_tpu_torch.codec import huffman
    from lerc_tpu_torch.kernels import build
    from lerc_tpu_torch.ops import device_fpl as F
    from lerc_tpu_torch.ops import device_huffman as dh

    if not F.__file__.startswith(tree):
        raise SystemExit(f"imported {F.__file__}, not the tree {tree}")
    build.build_all()
    dev = torch.device("cuda")
    tiles = cs.make_tiles(4, 2048, dev)
    n, pred, levels = 2048 * 2048, 1, (2, 1, 0, 0)
    fin = [F.fpl_finalize(t, pred, levels) for t in tiles]

    def ev(fns, reps=20):
        for f in fns:
            f()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            for f in fns:
                f()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / (reps * len(fns))

    out = {
        "F1": ev([lambda t=t: F.fpl_sample_histograms(t) for t in tiles]),
        "F2": ev([lambda t=t: F.fpl_finalize(t, pred, levels) for t in tiles]),
        "F2b": ev([lambda p=p: F.fpl_packbits_size(p, n) for p, _ in fin]),
        "F3": ev([lambda p=p: F.fpl_restore(p, 2048, 2048, 1, pred, levels) for p, _ in fin], 10),
    }
    h2, h3 = [], []
    for planes, histos in fin:
        hst = histos[2].cpu().numpy().astype(np.int64)
        lengths = huffman.compute_code_lengths(hst)
        codes = huffman.canonical_codes(lengths)
        table = dh.code_table(lengths, codes, dev)
        n_words = -(-int((hst * lengths).sum()) // 32) + 1
        words, _tb, sbits = dh.encode_stream_device(planes[2], table, (n, n, n), n_words)
        consts, syms = huffman.canonical_decode_consts(lengths, codes)
        h2.append((planes[2], table, (n, n, n), n_words))
        h3.append((torch.cat([words, words.new_zeros(1)]), 32 * n_words, sbits,
                   torch.from_numpy(consts).to(dev), torch.from_numpy(syms).to(dev), (n, n, n)))
    out["H2"] = ev([lambda a=a: dh.encode_stream_device(*a) for a in h2])
    out["H3"] = ev([lambda a=a: dh.decode_stream_device(*a) for a in h3], 10)
    print(label, " ".join(f"{k}={v:.4f}" for k, v in out.items()), flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        turn(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    here = str(Path(__file__).resolve().parent)
    parent = str(Path(sys.argv[1]).resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for label, tree in (("parent", parent), ("change", here), ("change", here), ("parent", parent)):
        subprocess.run([sys.executable, __file__, "--turn", tree, label], check=True)


if __name__ == "__main__":
    main()
