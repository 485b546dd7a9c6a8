#!/usr/bin/env python3
"""Time kernels of two checkouts on one GPU, in turns: parent, change,
change, parent.

    python3 chip_compare.py MEASURE PARENT_DIR

PARENT_DIR is an unpacked checkout of the older commit (`git archive`).
Each turn runs in its own process (both trees name their package
lerc_tpu_torch), builds that tree's kernels and prints one line of ms per
call. The measurement code is this file's, the same for both trees;
inputs are chip_smoke.py's four 2048^2 float32 DEM tiles of the tree
measured. MEASURE is one of:

  fpl  the float32 fpl kernels F1, F2, F2b, F3 and the Huffman kernels H2
       and H3 (the kernels of `kernels/fpl.cu` and `kernels/block_scan.cuh`
       serve float32 and float64 from one template; this holds the float32
       instances to an older checkout's): the tiles round-robin (past the
       50 MB L2), predictor 1, levels (2, 1, 0, 0), H2/H3 on plane 2; CUDA
       events over 20 rounds (10 for F3 and H3), launch gaps included.
  k5   K5 (the index-free record scan) per tile, the index-free decode
       round (every kernel of decode_fast(header, stream) on the four
       tiles, encoded by FusedResidentCodec at maxZError 0.001, nb_cap 0)
       per round, and H4's column-0 scan on the delta symbols of the uint8
       three-band tile (its kernel and, where the tree zeroes its CTA
       totals per call, that memset) beside torch.cumsum on its [D, H]
       view, per call: device time from torch.profiler windows (the tree's
       chip_smoke.profiled_rows), summed over the device work whose name
       holds a pattern.
  undelta  H4's masked un-delta (undelta_masked_device) on H1's delta
       symbols of the uint8 three-band tile with the bench mask, per call:
       the device time of its kernels and memsets, and of all the call's
       device work (torch.profiler windows, as k5).
  f3   F3 (fpl_restore) per call, float32 (predictor 1, levels (2, 1, 0, 0),
       as fpl) and float64 (the lossless DEM cell's choice: predictor 0,
       levels (0, 1, 1, 3, 3, 2, 1, 1)), each round-robin over the four
       tiles' planes (past the L2): the device time of the kernels and
       memsets, and of all the call's device work (a tree that clones the
       planes first counts the copy there).
  k3   K3 (fletcher32_parts) per call on the four resident float32 streams
       (FusedResidentCodec at maxZError 0.001: header parts, static
       partials, stream, total) and on the fpl sections as the band
       codec's tail (each blob after its checksum field, an empty stream,
       total 0, as device_codec._checksum passes it) of the four float32
       and the four float64 tiles, lossless: each set round-robin, every
       result first held to fletcher32_parts_ref and a tail's to its
       blob's checksum; the device time of the kernel, and of all the
       call's device work (the zeroed accumulator's fill beside it).
  h3   H3 (huffman_decode) per call on the delta symbols of the four uint8
       three-band tiles (the all-valid layout: H1, then H2 with the
       histogram's code) and on plane 2 of the four float32 fpl tiles
       (predictor 1, levels (2, 1, 0, 0), as fpl), each set round-robin
       past the L2, every output (symbols, used bits, ok) first held to
       decode_stream_device_ref: the device time of the kernel.
  f2b  F2b (fpl_packbits_size) per call on the planes of the four float32
       tiles (predictor 1, levels (2, 1, 0, 0), as fpl) and on the eight
       planes of the four float64 tiles (the lossless DEM cell's choice, as
       f3), each set round-robin past the L2, every result first held to
       fpl_packbits_size_ref: the device time of F2b's kernels and memsets
       (names holding "fpl_p"), and of all the call's device work (a tree
       that zeroes its sums with a fill kernel counts it there).
  h1m  the masked H1 (symbol_streams_device with a mask) per call on the
       uint8 three-band tile with the bench mask, its outputs first held to
       symbol_streams_device_ref: the device time of its kernel and memsets
       (names holding "huffman_symbols"), and of all the call's device work
       (a tree with rank-chunk glue counts its torch ops there).
  k4f32  the float32 K4 (decode_records, decode_records_masked) per call on
       the four DEM tiles encoded by FusedResidentCodec at maxZError 0.001,
       nb_cap 0 and 16, all-valid and with the bench mask, as the resident
       decode_fast passes them (the codec's starts, zMax and validity words;
       nb_cap 16 with lut_unfit), each set round-robin past the L2, every
       output (image, flags) first held to decode_records_ref: the device
       time of the kernel (names holding "decode_records") and a sha256 of
       each set's outputs, equal in every turn where they are byte-equal;
       then the resident all-valid round (encode_fast and the indexed
       decode_fast of the four tiles, nb_cap 0): its device busy time, K4's
       share and its CUDA-event time, and the four decode_fast calls alone
       on CUDA events (each the median of 9 timings of 3 rounds).
  k4int  the integer K4 (decode_records_int) per call on the four uint8
       three-band tiles of chip_smoke's int cell (FusedResidentCodec at
       maxZError 0.5), encoded at v6 (depth-diff records: index_ok drops,
       the image is still the records' parse) and at v4 (no diff records:
       the image is the decode), and on the int16 and int32 cells' four
       tiles, each set round-robin past the L2, every output first held to
       decode_records_int_ref: the device time of the kernel; then the
       resident uint8 three-band round (encode_fast, the indexed attempt and
       the index-free decode of the four v6 tiles): its device busy time,
       the K4, K5 and K6 kernels in it, and its CUDA-event time.
  k6int  K6 (decode_scanned) per call on K5's descriptors of the same v6
       uint8 three-band, int16 and int32 tiles and of the four float32 DEM
       tiles (FusedResidentCodec at maxZError 0.001), each set round-robin
       past the L2, every output first held to decode_scanned_ref: the
       device time of the kernel.
  h2   H2 (encode_stream_device) per call on the delta streams of the four
       uint8 three-band tiles (H1's all-valid layout, the histogram's code)
       and on plane 2 of the four float32 fpl tiles (predictor 1, levels
       (2, 1, 0, 0), as fpl), each set round-robin past the L2, every output
       (words, total bits, sbits) first held to encode_stream_device_ref:
       the device time of all the call's device work (a tree of two
       kernels counts their cumsum, subtraction and zeroed output there),
       and of its kernels alone (names holding "huffman"); then chip_smoke's
       uint8 three-band Huffman cell round (encode_band_device with the
       index and decode_band_device of the four tiles): its device busy
       time, H2's share of it and its CUDA-event time.
  k1int  the integer K1 (encode_blocks) per call on the four tiles of
       chip_smoke's uint8 three-band (v6, depth-diff candidates), int16 and
       int32 cells (FusedResidentCodec's parameters: maxZError 0.5, 0.5 and
       2, version 6, nb_cap 0), and the float K1 on the four float32 DEM
       tiles at maxZError 0.001, all-valid and with the bench mask, each set
       round-robin past the L2, every output (rec_info, zrange, fits) first
       held to encode_blocks_ref: the device time of the kernel; then the
       resident uint8 three-band encode (FusedResidentCodec.encode_fast of
       the four tiles): its device busy time, K1's share and its CUDA-event
       time.
  k4lut  the mosaic's K4 (decode_records_lut) per launch on each micro-block
       group of three of chip_smoke's mosaic cells, encoded by
       MosaicEncoder (one rank, no mesh, 512^2 tiles): the uint8 three-band
       4096^2 image (depth-diff units), the uint16 class grid and the
       float32 DEM at maxZError 0.001, all-valid and with the bench mask on
       each quarter: the device time of the kernel
       (names holding "decode_records_lut"); then the uint8 three-band
       cell's whole decode_mosaic_device on the host clock (best of 3, a
       synchronize after it) and its device time in a torch.profiler window
       of 3 decodes: busy (every device item), K4, K3 and K6 (the scanned
       decode), copies.
  k2int  the integer K2 (write_records) per call on the four tiles of
       chip_smoke's uint8 three-band, int16 and int32 cells, and the float
       K2 on the four float32 DEM tiles all-valid and with the bench mask
       as a control (k1int's inputs; each tile's records from K1, starts
       by cumsum), each set round-robin past the L2: the device time of
       the kernel (names holding "write_records").
  k1lut  every instance of the LUT K1 (encode_blocks_lut_kernel) that a path
       launches, on the inputs the path gives it, through the path's own
       call (the kernel's rows alone counted): the band codec's encode_tiles
       on the four float32 DEM tiles at maxZError 0.001, all-valid and with
       the bench mask, and on their uint16 class grids (maxZError 0.5, int32
       input), each round-robin past the L2, 8x8 and 16x16 blocks; the
       mosaic's encode_tiles_batched on the 64-tile stacks of 512^2 that
       MosaicEncoder (one rank) hands it -- the DEM all-valid and with the
       bench mask on each quarter, the class grid and the uint8 three-band
       image -- at both block sizes (the tree's own all-valid hint where it
       takes one), each also in one cold-L2 window (a 256 MB fill before
       every call, the fill not counted); a sha256 of every call's whole
       outputs (the streams, starts, ranges and fits), equal in every turn
       where the blobs are byte-equal.
  k2lut  every instance of the LUT K2 (write_records_lut_kernel) that a path
       launches, through the same path calls as k1lut (the band codec's
       encode_tiles, the mosaic's encode_tiles_batched), only K2's rows
       counted, the mosaic stacks also in one cold-L2 window; the same
       sha256 of every call's whole outputs.
  f2   F2 (fpl_finalize) per call on the four float32 tiles (predictor 1,
       levels (2, 1, 0, 0), as fpl; and predictor 2, levels (1, 1, 0, 0))
       and the four float64 tiles (the lossless DEM cell's choice,
       predictor 0, levels (0, 1, 1, 3, 3, 2, 1, 1); and predictor 2,
       levels (2, 2, 1, 1, 1, 1, 1, 1)), each set round-robin past the L2,
       and on the first tile of each alone at the choice (its words in the
       L2: `_l2`),
       every output (planes with their zero tail, histograms) first held to
       fpl_finalize_ref: the device time of the kernel (names holding
       "fpl_finalize"), and of all the call's device work (a tree that
       zeroes the planes first counts the fill there); a sha256 of every
       output.
  instances  the tree's own chip_smoke phases 5b and 13b on one DEM tile:
       every integer instance of K1, K2, K4 and K6 no timed path takes and
       K6's masked, 16x16 and float64 instances, each held to its plain
       version and timed once (one `instance` line each).
  k1f32  the float32 K1 (encode_blocks, encode_blocks_masked) per call on the
       four DEM tiles at maxZError 0.001 (FusedResidentCodec's parameters),
       all-valid and with the bench mask, and on two of them made to show
       the picks among -0.0/+0.0 and NaN (k1_quirk_tiles: zero minima of
       both signs within and across strips, all-NaN and half-NaN blocks,
       +-inf), each set round-robin past the L2, every output but the
       quirks' first held to encode_blocks_ref: the device time of the
       kernel (names holding "encode_blocks") and a sha256 of each set's
       outputs (rec_info, ranges, fits), equal in every turn where they
       are bit-equal; then the resident all-valid round (encode_fast and the
       indexed decode_fast of the four tiles, nb_cap 0): its device busy
       time, K1's share, and its CUDA-event time (the median of 9 timings of
       3 rounds).
  k1f64  the float64 K1 (encode_blocks_f64, _masked_f64, and the mosaic's
       encode_tiles_f64) per call on the four float64 DEM tiles at maxZError
       0.001, all-valid and with the bench mask, on the 4096^2 float64 DEM
       as the mosaic's stack of 64 tiles of 512^2 (validity words all set,
       per-tile ranges), and on k1_quirk_tiles of the float64 tiles; as
       k1f32 (device time, sha256 of each set's outputs); then the float64
       lossy band round (encode_band_device with the index and
       decode_band_device of the four tiles): its device busy time, K1's
       share and its CUDA-event time.
  windows  the parent's whole chip_smoke.py, one turn only, its profiler
       windows counted: those taken and those that came back with no
       kernel row (this tree's chip_smoke.py prints its own count).
"""
import os
import subprocess
import sys
from pathlib import Path


def fpl_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch.codec import huffman
    from lerc_tpu_torch.ops import device_fpl as F
    from lerc_tpu_torch.ops import device_huffman as dh

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
    return out


def k5_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_huffman as dh
    from lerc_tpu_torch.ops import device_scan as scan

    tiles = cs.make_tiles(4, 2048, dev)
    codec = FusedResidentCodec(2048, 2048, 1, np.float32, 0.001)
    outs = [codec.encode_fast(t) for t in tiles]
    n_rec = codec.n_rec

    out = {
        "K5": dev_ms(cs, [lambda o=o: scan.scan_records(o[1], n_rec, codec.dt, codec.version,
                                                        o[2][0].reshape(1)) for o in outs],
                     ("scan_records",)),
        "index_free_round": 4 * dev_ms(cs, [lambda o=o: codec.decode_fast(o[0], o[1])
                                            for o in outs], (None,)),
    }
    u8 = cs.int_cell_tiles(tiles[:1], np.uint8, 3)[0]
    h, w, d = u8.shape
    _direct, sym, _hist = dh.symbol_streams_device(u8.to(torch.int32).contiguous(), None,
                                                   DataType.BYTE)
    out["col0"] = dev_ms(cs, [lambda: dh.symbols_to_image(sym, h, w, d, DataType.BYTE, True)],
                         ("huffman_restore_col0", "Memset"), reps=20)
    col = sym[:h * w * d].view(d, h, w)[:, :, 0]
    out["torch.cumsum"] = dev_ms(cs, [lambda: torch.cumsum(col, 1, dtype=torch.uint8)], (None,),
                                 reps=20)
    return out


def dev_ms(cs, fns, pats, reps=5):
    """Device ms per call of the work matching any of pats (None: all); the
    first pattern must show."""
    rows = cs.profiled_rows(fns, reps, pats[:1])
    if rows is None:
        raise SystemExit(f"profiler shows no device time for {pats[0]}")
    hit = [r for r in rows if any(p is None or p in r[0] for p in pats)]
    return sum(r[2] for r in hit) / 1e3 / (reps * len(fns))


def undelta_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_huffman as dh

    tiles = cs.make_tiles(1, 2048, dev)
    u8 = cs.int_cell_tiles(tiles, np.uint8, 3)[0]
    mask = torch.from_numpy(cs.bench_mask()).to(dev)
    _direct, sym, _hist = dh.symbol_streams_device(u8.to(torch.int32).contiguous(), mask,
                                                   DataType.BYTE)
    call = [lambda: dh.undelta_masked_device(sym, mask, 3, DataType.BYTE)]
    return {"kernels": dev_ms(cs, call, ("huffman_restore_delta_masked", "Memset"), reps=20),
            "all": dev_ms(cs, call, (None,), reps=20)}


def f3_turn(cs, dev) -> dict:
    from lerc_tpu_torch.ops import device_fpl as F

    out = {}
    for label, tiles, pred, levels in (
            ("f32", cs.make_tiles(4, 2048, dev), 1, (2, 1, 0, 0)),
            ("f64", cs.make_tiles64(4, 2048, dev), 0, (0, 1, 1, 3, 3, 2, 1, 1))):
        planes = [F.fpl_finalize(t, pred, levels)[0] for t in tiles]
        calls = [lambda q=q: F.fpl_restore(q, 2048, 2048, 1, pred, levels) for q in planes]
        out[f"{label}_kernels"] = dev_ms(cs, calls, ("fpl_restore_", "Memset"))
        out[f"{label}_all"] = dev_ms(cs, calls, (None,))
    return out


def k3_inputs(cs, dev) -> dict:
    """{set: [(K3 args, checksum or None)]}: the resident streams, and the
    float32 and float64 fpl sections as tails."""
    import numpy as np
    import torch

    from lerc_tpu_torch import FusedResidentCodec, encode_band_device
    from lerc_tpu_torch.codec import header as hdr

    tiles = cs.make_tiles(4, 2048, dev)
    codec = FusedResidentCodec(2048, 2048, 1, np.float32, 0.001, device=dev)
    sk, hl = codec._skip, codec._head_len
    resident = []
    for t in tiles:
        header, stream, meta, _ = codec.encode_fast(t)
        resident.append(((header[sk:hl], codec._static_ab, header[hl:], stream,
                          meta[0].reshape(1)), None))
    out = {"resident": resident}
    for label, ts in (("f32_tail", tiles), ("f64_tail", cs.make_tiles64(4, 2048, dev))):
        sets = []
        for t in ts:
            blob = encode_band_device(t, None, 0.0, device=dev)
            head, _ = hdr.read_header(blob)
            tail = torch.frombuffer(bytearray(blob[hdr.checksum_skip(head.version):]),
                                    dtype=torch.uint8).to(dev)
            args = (tail[:0], (0, 0, 0), tail, torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
            sets.append((args, head.checksum))
        out[label] = sets
    return out


def k3_turn(cs, dev) -> dict:
    from lerc_tpu_torch.ops import device_scan as scan

    out = {}
    for label, sets in k3_inputs(cs, dev).items():
        for args, checksum in sets:
            got = int(scan.fletcher32_parts(*args))
            if got != int(scan.fletcher32_parts_ref(*args)) or \
                    (checksum is not None and got & 0xFFFFFFFF != checksum):
                raise SystemExit(f"K3 != its plain version or the blob's checksum ({label})")
        calls = [lambda a=a: scan.fletcher32_parts(*a) for a, _ in sets]
        out[label] = dev_ms(cs, calls, ("fletcher32_parts",))
        out[f"{label}_all"] = dev_ms(cs, calls, (None,))
    return out


def h3_inputs(cs, dev) -> dict:
    """{set: [H3 args]}: the uint8 three-band tiles' delta streams and the
    float32 fpl tiles' plane 2."""
    import numpy as np
    import torch

    from lerc_tpu_torch.codec import huffman
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_fpl as F
    from lerc_tpu_torch.ops import device_huffman as dh

    def args_of(sym, hist, layout):
        hst = hist.cpu().numpy().astype(np.int64)
        lengths = huffman.compute_code_lengths(hst)
        codes = huffman.canonical_codes(lengths)
        n_words = -(-int((hst * lengths).sum()) // 32) + 1
        words, _tb, sbits = dh.encode_stream_device(sym, dh.code_table(lengths, codes, dev),
                                                    layout, n_words)
        consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
        return (torch.cat([words, words.new_zeros(1)]), 32 * n_words, sbits,
                torch.from_numpy(consts).to(dev), torch.from_numpy(sorted_syms).to(dev), layout)

    tiles = cs.make_tiles(4, 2048, dev)
    u8 = []
    for t in cs.int_cell_tiles(tiles, np.uint8, 3):
        _direct, delta, hist = dh.symbol_streams_device(t.to(torch.int32).contiguous(), None,
                                                        DataType.BYTE)
        n = t.numel()
        u8.append(args_of(delta, hist[1], (n, n, n)))
    n = 2048 * 2048
    fpl = []
    for t in tiles:
        planes, histos = F.fpl_finalize(t, 1, (2, 1, 0, 0))
        fpl.append(args_of(planes[2], histos[2], (n, n, n)))
    return {"u8x3": u8, "fpl_plane2": fpl}


def h3_turn(cs, dev) -> dict:
    import torch

    from lerc_tpu_torch.ops import device_huffman as dh

    out = {}
    for label, sets in h3_inputs(cs, dev).items():
        for a in sets:
            k, r = dh.decode_stream_device(*a), dh.decode_stream_device_ref(*a)
            if not (all(torch.equal(x, y) for x, y in zip(k, r)) and bool(k[2])):
                raise SystemExit(f"H3 != its plain version ({label})")
        out[label] = dev_ms(cs, [lambda a=a: dh.decode_stream_device(*a) for a in sets],
                            ("huffman_decode",), reps=10)
    return out


def f2b_turn(cs, dev) -> dict:
    import torch

    from lerc_tpu_torch.ops import device_fpl as F

    out = {}
    for label, tiles, pred, levels in (
            ("f32", cs.make_tiles(4, 2048, dev), 1, (2, 1, 0, 0)),
            ("f64", cs.make_tiles64(4, 2048, dev), 0, (0, 1, 1, 3, 3, 2, 1, 1))):
        n = 2048 * 2048
        planes = [F.fpl_finalize(t, pred, levels)[0] for t in tiles]
        for q in planes:
            if not torch.equal(F.fpl_packbits_size(q, n), F.fpl_packbits_size_ref(q, n)):
                raise SystemExit(f"F2b != its plain version ({label})")
        calls = [lambda q=q: F.fpl_packbits_size(q, n) for q in planes]
        out[f"{label}_kernels"] = dev_ms(cs, calls, ("fpl_p", "Memset"), reps=10)
        out[f"{label}_all"] = dev_ms(cs, calls, (None,), reps=10)
    return out


def h1m_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_huffman as dh

    tiles = cs.make_tiles(1, 2048, dev)
    u8 = cs.int_cell_tiles(tiles, np.uint8, 3)[0].to(torch.int32).contiguous()
    mask = torch.from_numpy(cs.bench_mask()).to(dev)
    k = dh.symbol_streams_device(u8, mask, DataType.BYTE)
    r = dh.symbol_streams_device_ref(u8, mask, DataType.BYTE)
    if not all(torch.equal(a, b) for a, b in zip(k, r)):
        raise SystemExit("H1 masked != its plain version")
    call = [lambda: dh.symbol_streams_device(u8, mask, DataType.BYTE)]
    return {"kernels": dev_ms(cs, call, ("huffman_symbols", "Memset"), reps=20),
            "all": dev_ms(cs, call, (None,), reps=20)}


def u8x3_sets(cs, dev, version):
    """chip_smoke's four uint8 three-band tiles encoded by
    FusedResidentCodec at maxZError 0.5 and `version`: (codec, tiles,
    [(header, stream, meta, starts)])."""
    import numpy as np

    from lerc_tpu_torch import FusedResidentCodec

    tiles = cs.int_cell_tiles(cs.make_tiles(4, 2048, dev), np.uint8, 3)
    codec = FusedResidentCodec(2048, 2048, 3, np.uint8, 0.5, version)
    return codec, tiles, [codec.encode_fast(t) for t in tiles]


def int_sets(cs, dev):
    """{label: (codec, tiles, encodes)}: the uint8 three-band tiles at v6
    and v4 (u8x3_sets), and chip_smoke's int16 and int32 cells (the four
    DEM tiles in whole metres at maxZError 0.5, at maxZError 2)."""
    import numpy as np

    from lerc_tpu_torch import FusedResidentCodec

    out = {"u8x3_v6": u8x3_sets(cs, dev, 6), "u8x3_v4": u8x3_sets(cs, dev, 4)}
    dem = cs.make_tiles(4, 2048, dev)
    for label, npdt, mze in (("i16", np.int16, 0.5), ("i32", np.int32, 2.0)):
        tiles = cs.int_cell_tiles(dem, npdt, 1)
        codec = FusedResidentCodec(2048, 2048, 1, npdt, mze)
        out[label] = (codec, tiles, [codec.encode_fast(t) for t in tiles])
    return out


def k4f32_turn(cs, dev) -> dict:
    import hashlib

    import numpy as np
    import torch

    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.ops import device_decode as dec

    tiles = cs.make_tiles(4, 2048, dev)
    out = {}
    for masked in (False, True):
        for nb_cap in (0, 16):
            label = f"{'masked' if masked else 'all_valid'}_cap{nb_cap}"
            codec = FusedResidentCodec(2048, 2048, 1, np.float32, 0.001, nb_cap=nb_cap,
                                       mask=cs.bench_mask() if masked else None)
            args = []
            for t in tiles:
                header, stream, _meta, starts = codec.encode_fast(t)
                args.append((stream, starts, codec._zmax_vec(header), 2.0 * codec.mze, 2048,
                             2048, 1, codec.version, 32 if nb_cap <= 0 else nb_cap,
                             0 < nb_cap <= 16, codec.valid))
            digest = hashlib.sha256()
            for a in args:
                (ik, fk), (ir, fr) = dec.decode_records(*a), dec.decode_records_ref(*a)
                if not (torch.equal(ik.view(torch.int32), ir.view(torch.int32))
                        and torch.equal(fk, fr) and int(fk[0]) == 1):
                    raise SystemExit(f"the float32 K4 != its plain version ({label})")
                for x in (ik, fk):
                    digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            print(f"outputs sha256 {label} {digest.hexdigest()}", flush=True)
            out[label] = dev_ms(cs, [lambda a=a: dec.decode_records(*a) for a in args],
                                ("decode_records",), reps=10)
            if masked or nb_cap:
                continue

            outs = [codec.encode_fast(t) for t in tiles]

            def round_():
                for t in tiles:
                    o = codec.encode_fast(t)
                    codec.decode_fast(o[0], o[1], o[3])

            def decodes():
                for o in outs:
                    codec.decode_fast(o[0], o[1], o[3])

            rows = cs.profiled_rows([round_], 3, ("decode_records",))
            if rows is None:
                raise SystemExit("profiler shows no device time for the resident round")
            out["round_busy"] = sum(r[2] for r in rows) / 1e3 / 3
            out["round_K4"] = sum(r[2] for r in rows if "decode_records" in r[0]) / 1e3 / 3
            out["round_events"] = float(np.median([cs.cuda_ms([round_], reps=3)
                                                   for _ in range(9)]))
            out["decodes_events"] = float(np.median([cs.cuda_ms([decodes], reps=3)
                                                     for _ in range(9)]))
    return out


def k1_quirk_tiles(tiles):
    """Two of the DEM tiles (float32 or float64, 2048^2 x 1) made to show
    the float K1's picks among -0.0/+0.0 and NaN: tile 0 as |x| with, in
    block rows 0-3, blocks whose minimum is a zero -- +0.0 then -0.0, -0.0
    then +0.0, all -0.0, all +0.0, in turn -- so that the tile's range meets
    zeros of both signs in one strip and across strips; tile 1 with, in
    block row 10, blocks all NaN, blocks whose rows 0-3 are NaN, and
    blocks holding +inf and -inf, in turn."""
    a = tiles[0].abs()
    v = a.view(256, 8, 256, 8)  # block row, row, block column, column
    for c in range(256):
        blk = v[:4, :, c, :]
        if c % 4 == 0:
            blk[:, 0, 0], blk[:, 0, 5] = 0.0, -0.0
        elif c % 4 == 1:
            blk[:, 0, 0], blk[:, 4, 1] = -0.0, 0.0
        else:
            blk.fill_(-0.0 if c % 4 == 2 else 0.0)
    b = tiles[1].clone()
    u = b.view(256, 8, 256, 8)
    for c in range(256):
        blk = u[10, :, c, :]
        if c % 3 == 0:
            blk.fill_(float("nan"))
        elif c % 3 == 1:
            blk[:4] = float("nan")
        else:
            blk[2, 3], blk[6, 6] = float("inf"), float("-inf")
    return [a.contiguous(), b.contiguous()]


def k1_sets_turn(cs, sets, plain) -> dict:
    """Each set's K1 outputs first held to plain, the plain version on the
    same device (except the quirk sets),
    a sha256 of each set's outputs (rec_info, ranges, fits), and the device
    time of the kernel per call (names holding "encode_blocks"), round-robin
    past the L2."""
    import hashlib

    import torch

    out = {}
    for label, (fn, args) in sets.items():
        digest = hashlib.sha256()
        for a in args:
            k = fn(*a)
            if not label.endswith("quirks"):
                r = plain(*a)
                if not all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                       y.view(torch.int32) if y.dtype == torch.float32 else y)
                           for x, y in zip(k, r)):
                    raise SystemExit(f"the float K1 != its plain version ({label})")
            for x in k:
                digest.update(x.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
        print(f"outputs sha256 {label} {digest.hexdigest()}", flush=True)
        out[label] = dev_ms(cs, [lambda a=a: fn(*a) for a in args], ("encode_blocks",), reps=10)
    return out


def k1f32_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.ops import device_encode as enc

    tiles = cs.make_tiles(4, 2048, dev)
    p = enc.encode_params(0.001, 6, 0)
    valid = enc.block_valid_words(torch.from_numpy(cs.bench_mask()).to(dev))
    out = k1_sets_turn(cs, {"all_valid": (enc.encode_blocks, [(t, p, None) for t in tiles]),
                            "masked": (enc.encode_blocks, [(t, p, valid) for t in tiles]),
                            "quirks": (enc.encode_blocks,
                                       [(t, p, None) for t in k1_quirk_tiles(tiles)])},
                       enc.encode_blocks_ref)
    codec = FusedResidentCodec(2048, 2048, 1, np.float32, 0.001)

    def round_():
        for t in tiles:
            o = codec.encode_fast(t)
            codec.decode_fast(o[0], o[1], o[3])

    r = round_ms(cs, round_, ("encode_blocks",))
    out.update(round_busy=r["round_busy"], round_K1=r["round_part"])
    out["round_events"] = float(np.median([cs.cuda_ms([round_], reps=3) for _ in range(9)]))
    return out


def k1f64_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch import decode_band_device, encode_band_device
    from lerc_tpu_torch.ops import device_encode as enc

    tiles = cs.make_tiles64(4, 2048, dev)
    p = enc.encode_params_f64(0.001, 6)
    valid = enc.block_valid_words(torch.from_numpy(cs.bench_mask()).to(dev))
    raster = torch.cat([torch.cat(tiles[:2], 1), torch.cat(tiles[2:], 1)], 0)
    stack = raster.reshape(8, 512, 8, 512, 1).permute(0, 2, 1, 3, 4).reshape(64 * 512, 512, 1)
    stack = stack.contiguous()
    ones = enc.block_valid_words(torch.ones(64 * 512, 512, dtype=torch.bool, device=dev))
    out = k1_sets_turn(cs, {
        "all_valid": (enc.encode_blocks_f64, [(t, p, None) for t in tiles]),
        "masked": (enc.encode_blocks_f64, [(t, p, valid) for t in tiles]),
        "mosaic": (enc.encode_blocks_f64, [(stack, p, ones, 4096)]),
        "quirks": (enc.encode_blocks_f64, [(t, p, None) for t in k1_quirk_tiles(tiles)])},
        enc.encode_blocks_f64_ref)

    def round_():
        enc_ = [encode_band_device(t, None, 0.001, return_index=True) for t in tiles]
        return [decode_band_device(b, index=i) for b, i in enc_]

    r = round_ms(cs, round_, ("encode_blocks",))
    out.update(band_round_busy=r["round_busy"], band_round_K1=r["round_part"],
               band_round_events=r["round_events"])
    return out


def k4int_turn(cs, dev) -> dict:
    import torch

    from lerc_tpu_torch.ops import device_decode as dec

    out = {}
    for label, (codec, tiles, outs) in int_sets(cs, dev).items():
        args = [(o[1], o[3], codec._zmax_vec(o[0]), dec._inv_i(codec.mze), codec.h, codec.w,
                 codec.d, codec.dt, codec.version, 32, False, None) for o in outs]
        for a in args:
            (ik, fk), (ir, fr) = dec.decode_records_int(*a), dec.decode_records_int_ref(*a)
            if not (torch.equal(ik, ir) and torch.equal(fk, fr)):
                raise SystemExit(f"the integer K4 != its plain version ({label})")
        out[label] = dev_ms(cs, [lambda a=a: dec.decode_records_int(*a) for a in args],
                            ("decode_records",), reps=10)
        if label == "u8x3_v6":
            def round_():
                for t in tiles:
                    o = codec.encode_fast(t)
                    codec.decode_fast(o[0], o[1], o[3])
                    codec.decode_fast(o[0], o[1])

            rows = cs.profiled_rows([round_], 3, ("decode_records",))
            if rows is None:
                raise SystemExit("profiler shows no device time for the uint8 round")
            for key, pats in (("round_busy", (None,)), ("round_K4", ("decode_records",)),
                              ("round_K5", ("scan_records",)), ("round_K6", ("decode_scanned",))):
                out[key] = sum(r[2] for r in rows if any(p is None or p in r[0] for p in pats)
                               ) / 1e3 / 3
            out["round_events"] = cs.cuda_ms([round_], reps=3)
    return out


def k6int_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_scan as scan

    f32 = FusedResidentCodec(2048, 2048, 1, np.float32, 0.001)
    sets = {label: s[::2] for label, s in int_sets(cs, dev).items() if label != "u8x3_v4"}
    sets["f32"] = (f32, [f32.encode_fast(t) for t in cs.make_tiles(4, 2048, dev)])
    out = {}
    for label, (codec, outs) in sets.items():
        args = []
        for o in outs:
            k = scan.scan_records(o[1], codec.n_rec, codec.dt, codec.version, o[2][0].reshape(1))
            args.append((o[1], k[1], k[5], k[2], k[3], k[4], k[6], k[7], k[8], None, codec.mze,
                         codec._zmax_vec(o[0]), codec.h, codec.w, codec.d, codec.dt, True, False))
        for a in args:
            ik, ok_k = dec.decode_scanned(*a)
            ir, ok_r = dec.decode_scanned_ref(*a[:10], 2.0 * a[10], dec._inv_i(a[10]), a[11],
                                              *a[12:16])
            if not (torch.equal(ik.reshape(-1).view(torch.uint8), ir.reshape(-1).view(torch.uint8))
                    and bool(ok_k) and bool(ok_r)):
                raise SystemExit(f"K6 != its plain version ({label})")
        out[label] = dev_ms(cs, [lambda a=a: dec.decode_scanned(*a) for a in args],
                            ("decode_scanned",), reps=10)
    return out


def instances_turn(cs, dev) -> dict:
    """The tree's chip_smoke phases 5b and 13b on one DEM tile: each integer
    instance of K1, K2, K4 and K6 that no timed path takes, and K6's masked,
    16x16 and float64 instances, held to its plain version and timed once
    (their `instance` lines)."""
    tile = cs.make_tiles(1, 2048, dev)[0]
    mask = cs.bench_mask()
    card = cs.card_line()
    cs.resident_instance_times(tile, mask, card)
    cs.k6_instance_times(tile, mask, card, set())
    return {}

def h2_inputs(cs, dev) -> dict:
    """{set: [H2 args]}: the uint8 three-band tiles' delta streams and the
    float32 fpl tiles' plane 2, each with its histogram's code and the words
    sized ceil(bits / 32) + 1."""
    import numpy as np
    import torch

    from lerc_tpu_torch.codec import huffman
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_fpl as F
    from lerc_tpu_torch.ops import device_huffman as dh

    def args_of(sym, hist, layout):
        hst = hist.cpu().numpy().astype(np.int64)
        lengths = huffman.compute_code_lengths(hst)
        table = dh.code_table(lengths, huffman.canonical_codes(lengths), dev)
        return sym, table, layout, -(-int((hst * lengths).sum()) // 32) + 1

    tiles = cs.make_tiles(4, 2048, dev)
    u8 = []
    for t in cs.int_cell_tiles(tiles, np.uint8, 3):
        _direct, delta, hist = dh.symbol_streams_device(t.to(torch.int32).contiguous(), None,
                                                        DataType.BYTE)
        n = t.numel()
        u8.append(args_of(delta, hist[1], (n, n, n)))
    n = 2048 * 2048
    fpl = []
    for t in tiles:
        planes, histos = F.fpl_finalize(t, 1, (2, 1, 0, 0))
        fpl.append(args_of(planes[2], histos[2], (n, n, n)))
    return {"u8x3": u8, "fpl_plane2": fpl}


def h2_turn(cs, dev) -> dict:
    import torch

    from lerc_tpu_torch.ops import device_huffman as dh

    out = {}
    for label, sets in h2_inputs(cs, dev).items():
        for a in sets:
            k, r = dh.encode_stream_device(*a), dh.encode_stream_device_ref(*a)
            if not (torch.equal(k[0], r[0]) and int(k[1]) == int(r[1]) and torch.equal(k[2], r[2])):
                raise SystemExit(f"H2 != its plain version ({label})")
        calls = [lambda a=a: dh.encode_stream_device(*a) for a in sets]
        out[f"{label}_all"] = dev_ms(cs, calls, (None,), reps=10)
        out[f"{label}_kernels"] = dev_ms(cs, calls, ("huffman",), reps=10)
    out.update(round_ms(cs, huffman_round(cs, dev), ("huffman_encode", "huffman_group_bits",
                                                     "huffman_pack")))
    return out


def huffman_round(cs, dev):
    """chip_smoke's uint8 three-band Huffman cell round: encode_band_device
    (with the index) and decode_band_device of the four tiles."""
    import numpy as np

    from lerc_tpu_torch import decode_band_device, encode_band_device

    tiles = cs.int_cell_tiles(cs.make_tiles(4, 2048, dev), np.uint8, 3)

    def round_():
        enc = [encode_band_device(t, None, 0.5, return_index=True) for t in tiles]
        return [decode_band_device(b, index=i) for b, i in enc]

    return round_


def round_ms(cs, fn, pats, reps=3):
    """A round's device busy ms (every device item in a torch.profiler window,
    copies included), the share of the kernels matching pats, and its
    CUDA-event ms."""
    rows = cs.profiled_rows([fn], reps, (None,))
    if rows is None:
        raise SystemExit("profiler shows no device time for the round")
    busy = sum(r[2] for r in rows) / 1e3 / reps
    part = sum(r[2] for r in rows if any(p in r[0] for p in pats)) / 1e3 / reps
    return {"round_busy": busy, "round_part": part, "round_events": cs.cuda_ms([fn], reps=reps)}


def k1int_inputs(cs, dev) -> dict:
    """{cell: [(tile, EncodeParams, validity words or None)]}: the four
    tiles of chip_smoke's uint8 three-band, int16 and int32 cells with
    FusedResidentCodec's parameters, and the four float32 DEM tiles at
    maxZError 0.001, all-valid and with the bench mask (the float K1)."""
    import numpy as np
    import torch

    from lerc_tpu_torch.constants import NUMPY_TO_DT, DataType
    from lerc_tpu_torch.ops import device_encode as enc

    dem = cs.make_tiles(4, 2048, dev)
    out = {}
    for label, npdt, d, mze in (("u8x3", np.uint8, 3, 0.5), ("i16", np.int16, 1, 0.5),
                                ("i32", np.int32, 1, 2.0)):
        p = enc.encode_params(mze, 6, 0, NUMPY_TO_DT[np.dtype(npdt)])
        out[label] = [(t, p, None) for t in cs.int_cell_tiles(dem, npdt, d)]
    p = enc.encode_params(0.001, 6, 0, DataType.FLOAT)
    valid = enc.block_valid_words(torch.from_numpy(cs.bench_mask()).to(dev))
    out["f32"] = [(t, p, None) for t in dem]
    out["f32_masked"] = [(t, p, valid) for t in dem]
    return out


def k1int_turn(cs, dev) -> dict:
    import numpy as np
    import torch

    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.ops import device_encode as enc

    out = {}
    for label, sets in k1int_inputs(cs, dev).items():
        for a in sets:
            k, r = enc.encode_blocks(*a), enc.encode_blocks_ref(*a)
            if not all(torch.equal(x, y) for x, y in zip(k, r)):
                raise SystemExit(f"the integer K1 != its plain version ({label})")
        out[label] = dev_ms(cs, [lambda a=a: enc.encode_blocks(*a) for a in sets],
                            ("encode_blocks",), reps=10)
    codec = FusedResidentCodec(2048, 2048, 3, np.uint8, 0.5)
    tiles = cs.int_cell_tiles(cs.make_tiles(4, 2048, dev), np.uint8, 3)
    out.update(round_ms(cs, lambda: [codec.encode_fast(t) for t in tiles], ("encode_blocks",)))
    return out


def k4lut_turn(cs, dev) -> dict:
    import numpy as np

    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.parallel import sharding as S

    tiles = cs.make_tiles(4, 2048, dev)
    t = cs.MOSAIC_TILE
    dem = cs.raster_of(tiles)
    cells = {"u8x3": (cs.raster_of(cs.int_cell_tiles(tiles, np.uint8, 3)), None, 0.5),
             "grid": (cs.raster_of([cs.class_grid(x) for x in tiles]), None, 0.5),
             "dem": (dem, None, 0.001),
             "dem_mask": (dem, np.tile(cs.bench_mask(), (2, 2)), 0.001)}
    out = {}
    for label, (raster, mask, mze) in cells.items():
        blob = S.MosaicEncoder(None, t, t, raster.dtype, n_depth=raster.shape[2]).encode(
            raster, mask, mze)
        for mb, units in sorted(cs.k4_groups(blob).items()):
            args, kw, _hd, _ = cs.k4_inputs(blob, mb, units, dev)
            out[f"{label}_mb{mb}_{len(units)}u"] = dev_ms(
                cs, [lambda: dec.decode_tiles_fast(*args, **kw)], ("decode_records_lut",),
                reps=10)
        if label == "u8x3":
            S.decode_mosaic_device(blob)
            out["u8x3_decode_host"] = min(cs._wall_ms(lambda: S.decode_mosaic_device(blob))
                                          for _ in range(3))
            rows = cs.profiled_rows([lambda: S.decode_mosaic_device(blob)], 3, (None,))
            if rows is None:
                raise SystemExit("profiler shows no device time for the uint8 x 3 decode")
            for key, pats in (("busy", ("",)), ("K4", ("decode_records_lut",)),
                              ("K3_K6", ("fletcher32", "decode_scanned")),
                              ("copies", ("Memcpy", "memcpy"))):
                out[f"u8x3_round_{key}"] = sum(r[2] for r in rows if any(p in r[0] for p in pats)
                                               ) / 1e3 / 3
    return out


def k2int_turn(cs, dev) -> dict:
    import torch

    from lerc_tpu_torch.ops import device_encode as enc

    out = {}
    for label, sets in k1int_inputs(cs, dev).items():
        calls = []
        for x, p, valid in sets:
            ri = enc.encode_blocks(x, p, valid)[0]
            length = ri[:, 0]
            starts = torch.cumsum(length, 0, dtype=torch.int32) - length
            cap_w = (int(length.sum()) + 4096) // 4
            calls.append(lambda x=x, p=p, v=valid, ri=ri, s=starts, c=cap_w:
                         enc.write_records(x, ri, s, c, p, v))
        out[label] = dev_ms(cs, calls, ("write_records",), reps=10)
    return out


K1LUT = ("encode_blocks_lut_kernel",)
K2LUT = ("write_records_lut_kernel",)


def k1lut_sets(cs, dev) -> dict:
    """{label: [calls]}: each LUT K1 instance a path launches, through the
    path's own call (the band codec's encode_tiles on four tiles, the
    mosaic's encode_tiles_batched on one 64-tile stack). The calls also
    launch K2 and glue; only K1's rows are to be counted."""
    import inspect

    import numpy as np
    import torch

    from lerc_tpu_torch.constants import NUMPY_TO_DT, DataType
    from lerc_tpu_torch.ops import device_encode as enc
    from lerc_tpu_torch.parallel import sharding as S

    tiles = cs.make_tiles(4, 2048, dev)
    mask = cs.bench_mask()
    mask_t = torch.from_numpy(mask).to(dev)
    grids = [cs.class_grid(t).to(torch.int32).contiguous() for t in tiles]
    h, w, _ = tiles[0].shape
    out = {}
    for label, xs, dt, mze, m in (("band_dem", tiles, DataType.FLOAT, 0.001, None),
                                  ("band_dem_mask", tiles, DataType.FLOAT, 0.001, mask),
                                  ("band_grid", grids, DataType.USHORT, 0.5, None)):
        n_valid = int(m.sum()) if m is not None else h * w
        cap = -(-(n_valid * 4 + (h * w // 64) * 12 + 4096) // 4) * 4
        for mb in (8, 16):
            valid = None if m is None else enc.block_valid_words(mask_t, mb)
            out[f"{label}_mb{mb}"] = [
                lambda x=x, v=valid, mb=mb, dt=dt, mze=mze, cap=cap: enc.encode_tiles(
                    x, v, mze, h, w, 1, dt, v is None, 6, cap, enable_lut=True, mb=mb)
                for x in xs]
    takes_hint = "all_valid" in inspect.signature(enc.encode_tiles_batched).parameters
    dem = cs.raster_of(tiles)
    for label, raster, m, mze in (
            ("mosaic_dem", dem, None, 0.001),
            ("mosaic_dem_mask", dem, np.tile(mask, (2, 2)), 0.001),
            ("mosaic_grid", cs.raster_of([cs.class_grid(x) for x in tiles]), None, 0.5),
            ("mosaic_u8x3", cs.raster_of(cs.int_cell_tiles(tiles, np.uint8, 3)), None, 0.5)):
        dt = NUMPY_TO_DT[raster.dtype]
        ts, ms, _ = S.split_into_tiles(raster, m, cs.MOSAIC_TILE, cs.MOSAIC_TILE)
        t = torch.from_numpy(np.ascontiguousarray(ts)).to(dev)
        mk = torch.from_numpy(np.ascontiguousarray(ms)).to(dev)
        kw = {"all_valid": bool(ms.all())} if takes_hint else {}
        for mb in (8, 16):
            out[f"{label}_mb{mb}"] = [lambda t=t, mk=mk, mb=mb, dt=dt, mze=mze, kw=kw:
                                      enc.encode_tiles_batched(t, mk, mze, dt, 6, mb, **kw)]
    return out


def k1lut_turn(cs, dev, pats=K1LUT) -> dict:
    import hashlib

    import torch

    out = {}
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB, past the 50 MB L2
    digest = hashlib.sha256()
    for label, calls in k1lut_sets(cs, dev).items():
        for c in calls:  # every output of the path's call: streams, starts, ranges, fits
            for t in c():
                raw = t.reshape(-1).contiguous().view(torch.uint8)
                digest.update(raw.cpu().numpy().tobytes())
        out[label] = dev_ms(cs, calls, pats, reps=10)
        if label.startswith("mosaic"):
            out[f"{label}_cold"] = dev_ms(cs, [lambda: (flush.zero_(), calls[0]())], pats,
                                          reps=5)
    print(f"outputs sha256 {digest.hexdigest()}", flush=True)
    return out


def k2lut_turn(cs, dev) -> dict:
    return k1lut_turn(cs, dev, K2LUT)


def f2_sets(cs, dev) -> dict:
    """{label: (tiles, predictor, levels)}: the four float32 and the four
    float64 DEM tiles, each at the fpl cells' choice and at predictor 2,
    round-robin past the L2; and the first tile alone at the choice, again
    and again (in the L2, as chip_smoke.py times F2 and as the band codec
    calls it on a tile just copied in)."""
    t32, t64 = cs.make_tiles(4, 2048, dev), cs.make_tiles64(4, 2048, dev)
    l32, l64 = (2, 1, 0, 0), (0, 1, 1, 3, 3, 2, 1, 1)
    return {"f32": (t32, 1, l32), "f32_p2": (t32, 2, (1, 1, 0, 0)), "f32_l2": (t32[:1], 1, l32),
            "f64": (t64, 0, l64), "f64_p2": (t64, 2, (2, 2, 1, 1, 1, 1, 1, 1)),
            "f64_l2": (t64[:1], 0, l64)}


def f2_turn(cs, dev) -> dict:
    import hashlib

    import torch

    from lerc_tpu_torch.ops import device_fpl as F

    out = {}
    digest = hashlib.sha256()
    for label, (tiles, pred, levels) in f2_sets(cs, dev).items():
        for t in tiles:
            got, ref = F.fpl_finalize(t, pred, levels), F.fpl_finalize_ref(t, pred, levels)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"F2 != its plain version ({label})")
            for a in got:
                digest.update(a.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        calls = [lambda t=t, pred=pred, levels=levels: F.fpl_finalize(t, pred, levels)
                 for t in tiles]
        out[f"{label}_kernel"] = dev_ms(cs, calls, ("fpl_finalize",), reps=10)
        out[f"{label}_all"] = dev_ms(cs, calls, (None,), reps=10)
    print(f"outputs sha256 {digest.hexdigest()}", flush=True)
    return out


def windows_turn(cs, dev) -> dict:
    """The tree's whole chip_smoke.py (its main()) with every profiler
    window it reads counted: those taken, and those that came back with no
    kernel row (the tree's _kernel_rows wrapped). A run that fails still
    gives its counts."""
    counts = {"windows": 0, "empty": 0}
    rows_of = cs._kernel_rows

    def counted(prof):
        rows = rows_of(prof)
        counts["windows"] += 1
        counts["empty"] += not rows
        return rows

    cs._kernel_rows = counted
    os.chdir(Path(cs.__file__).parent)
    try:
        cs.main()
    except SystemExit as e:
        print(f"chip_smoke.py exited: {e}", flush=True)
    return counts


MEASURES = {"fpl": fpl_turn, "k5": k5_turn, "undelta": undelta_turn, "f3": f3_turn,
            "k3": k3_turn, "h3": h3_turn, "f2b": f2b_turn, "h1m": h1m_turn,
            "k4f32": k4f32_turn, "k4int": k4int_turn, "k6int": k6int_turn,
            "instances": instances_turn,
            "h2": h2_turn, "k1int": k1int_turn, "k4lut": k4lut_turn, "k2int": k2int_turn,
            "k1lut": k1lut_turn, "k2lut": k2lut_turn, "f2": f2_turn, "k1f32": k1f32_turn,
            "k1f64": k1f64_turn, "windows": windows_turn}


LAZY = ("k2lut", "f2")  # measures of one source each (encode.cu, fpl.cu)


def turn(measure: str, tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from lerc_tpu_torch.kernels import build

    if not build.__file__.startswith(tree) or not cs.__file__.startswith(tree):
        raise SystemExit(f"imported {build.__file__}, not the tree {tree}")
    if measure not in LAZY:  # else each source builds at its first call
        build.build_all()
    out = MEASURES[measure](cs, torch.device("cuda"))
    print(label, " ".join(f"{k}={v:.4f}" for k, v in out.items()), "ms", flush=True)


def main() -> None:
    if len(sys.argv) == 5 and sys.argv[1] == "--turn":
        turn(*sys.argv[2:])
        return
    if len(sys.argv) != 3 or sys.argv[1] not in MEASURES:
        raise SystemExit(__doc__)
    measure = sys.argv[1]
    here = str(Path(__file__).resolve().parent)
    parent = str(Path(sys.argv[2]).resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    turns = (("parent", parent), ("change", here), ("change", here), ("parent", parent))
    if measure == "windows":  # a turn is a whole smoke run; this tree's prints its own count
        turns = turns[:1]
    for label, tree in turns:
        subprocess.run([sys.executable, __file__, "--turn", measure, tree, label], check=True)


if __name__ == "__main__":
    main()
