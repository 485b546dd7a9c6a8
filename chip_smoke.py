#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lerc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from the sources in this checkout (nvcc, parallel);
  3. hold each kernel against its plain PyTorch version on the same CUDA
     tensors (outputs equal: bytes, starts, flags, descriptors; images
     bit-equal): K1 encode_blocks, K2 write_records, K3 fletcher32_parts,
     K4 decode_records and the masked K1m/K2m/K4m at 64x64, 2048x2048 and
     on small edge tiles; then K5 scan_records (its sizes, doubling and
     describe kernels, step by step) and K6 decode_scanned on float32
     streams at 64x64 and 2048x2048 (nb_cap 0 and 16) and on the edge
     tiles, and every integer instance of K1, K2, K4 (all-valid and
     masked) and K6 on 64x64 tiles of each integer dtype (lossless v6 with
     depth-diff records, v4, lossy under nb_cap 16, masked);
  4. the paths, each run with every launch count at 0 before it and read
     after it -- a kernel of the path launched no time, or a kernel of
     another path launched, fails:
     a. FusedResidentCodec on the bench's 4096^2 float32 DEM as four 2048^2
        tiles at maxZError 0.001, nb_cap 0 and 16 (bench.py:209-298),
        all-valid and then with the bench's mask (a 500x1000 hole plus 2%
        speckle, bench.py:242-298): encode_fast, decode_fast with the
        record index, ok True, max error over the valid pixels <= 1.1 *
        maxZError, invalid pixels +0.0, each blob byte-equal to the plain
        path's (device="cpu"), each header parsed back;
     b. the same all-valid blobs decoded without the index
        (decode_fast(header, stream): K3, K5, K6 and not K4), ok True and
        bit-equal to the indexed decode;
     c. three integer cells on the same DEM: int16 in whole metres at
        maxZError 0.5, int32 at maxZError 2, and an 8-bit three-band image
        (bands following the DEM, so depth-diff records occur; their count
        is printed), each through encode_fast, both decodes and
        ResidentCodec.encode/decode: lossless exact, lossy within
        maxZError, blobs byte-equal to the plain path's, the indexed decode
        over depth-diff records ok False;
  5. timings: encode/decode MB/s of each path (CUDA events; the masked
     pass counts the full tiles' raw bytes, as bench.py:295), the
     index-free decode beside the indexed one, compression ratios, each
     kernel's device time per launch (torch.profiler) beside its plain
     version's time (CUDA events), its launches and its bound;
  6. where the time goes: device time per round by kernel, and the
     device's busy and idle shares, for each path;
  7. the band codec's kernels against their plain versions: the LUT
     instances of K1/K2 on 8x8 and 16x16 blocks (float32 and int32 input)
     and K6 (masked, edge, LUT, 16x16) on 64x64, 61x47 and 130x77 crops of
     the DEM, of a 12-zone class grid and of an int16 three-band image,
     all-valid and with the bench mask's crop; K6 on a hand-built float32
     depth-diff blob; the host scanner against tile_scan_ref and the LUT
     instances on 2048^2 tiles, and the scanner and K6 on the 2048^2
     masked and the 2047x1999 edge-crop blobs of the band cells below;
  8-11. the band cells through encode_band_device -> bytes ->
     decode_band_device, each counted: the float32 DEM (four 2048^2 tiles,
     maxZError 0.001) all-valid and with the bench mask, a 2047x1999 crop
     with the mask's crop, a uint16 class grid (must take 16x16 blocks and
     LUT records) and an int16 three-band image (depth-diff records); blobs
     byte-equal to the plain path's (device="cpu") on the first tiles,
     decodes within 1.1 * maxZError (exact when lossless), invalid pixels
     0, masks round-tripped;
  12. the masked ResidentCodec decoded without its index (the host
     scanner and the masked K6), bit-equal to the indexed decode;
  13. times: band encode/decode MB/s, host-scanner and analyses ms per
     tile, copies each way, the bench mask's RLE each way beside the
     masked cell's extra time, each new instance's ms against its bound
     and plain ms, device busy share of a band round;
  14. 8-bit whole-image Huffman: H1 symbols/histograms, H2 group bits and
     pack, H3 decode, H4 restores (direct, column 0 + rows, masked direct,
     masked delta) and the host lengths-only scan against their plain
     versions, byte for byte, on 48x41 and 61x47 crops of the cells' data
     (depth 1 and 3, uint8 and int8, no mask, a random and a stripes mask,
     both modes), on a 24-row strip wider than a row tile, and at 2048^2;
  15. four Huffman band cells, lossless v6, through
     encode_band_device(return_index=True) -> decode_band_device with the
     index and without it (the host scan), counted: a uint8 three-band
     image (four 2048^2 tiles, delta Huffman asserted), the same with the
     bench mask, a uint8 quality-flag band (four tiles, direct Huffman
     asserted) and one flag tile with the bench mask as its fill (masked
     direct); tile 0's blob equal to the plain path's, every decode equal
     to the input;
  16. their MB/s, ratios and host-scan ms, and H1-H4's device ms per
     launch at 2048^2 x 3 beside their plain ms, bounds and, for H1 and the
     row scan, torch.bincount / torch.cumsum;
  17. lossless float32 (fpl): F1 sampled histograms, F2 planes, F2b PackBits
     sizes and F3 restore against their plain versions, bit for bit, on
     48x41 and 61x47 crops of the DEM (depth 1 and 3, every predictor, every
     level 0..5) and at 2048^2 (phase 7 also holds 30- and 31-bit blocks
     through the LUT K1/K2 against their plain versions);
  18. three fpl band cells, lossless v6, through
     encode_band_device(return_index=True) -> decode_band_device with the
     index and without it (the host scan), counted: the four 2048^2 DEM
     tiles (fpl asserted taken; tile 0's blob equal to the plain path's),
     the same with the bench mask (every pixel rides the wire and decodes
     equal; the mask round-trips), and one 4096^2 x 3 band of the tiles,
     more values than 2^25;
  19. their MB/s and ratios, F1-F3's device ms per launch at 2048^2 beside
     their plain ms, bounds and, for F3, the level undo's torch.cumsum; H2
     and H3 on a Huffman plane; host PackBits and host-scan ms per plane;
     the device's busy share over an fpl round;
  20. float64: K1/K2 f64 (all-valid, masked, edge blocks, a tile of every
     record mode), K6 f64 (the port's blobs, their records edited on the
     card into depth-diff and LUT records, and for its 16x16 instances a
     float32 class grid's 16x16 blob read as float64) and F1-F3 over u64 words (every
     predictor and level, eight planes) against their plain versions, bit
     for bit, on 48x41, 61x47 and 64x64 crops of the DEM rendered in
     float64 (depth 1 and 3, all-valid and with the bench mask's crop), on
     the 2047x1999 edge crop and at 2048^2;
  21. three lossy float64 band cells through encode_band_device(
     return_index=True) -> decode_band_device, counted: the four 2048^2
     float64 DEM tiles at maxZError 0.001 all-valid and with the bench mask,
     and at maxZError 1e-6; every valid pixel within maxZError (invalid
     pixels 0), tile 0's blob equal to the plain path's;
  22. two lossless float64 cells (v6 fpl over eight planes): the same four
     tiles all-valid and with the bench mask, decoded with and without the
     index, bit-equal to the input; tile 0's predictor, levels, methods and
     size; then the float64 kernels' device ms per launch beside their
     plain ms and bounds, the cells' MB/s (best of 3) and the device's busy
     share over a lossy and a lossless round;
  23-26. the tile mosaic on a one-rank NCCL DeviceMesh: the tile-batched
     K1/K2 against their plain versions on the whole 64-tile stack of each
     raster (512^2 tiles) that MosaicEncoder hands encode_tiles_batched;
     the cells (the 4096^2 DEM all-valid and with the bench mask, the
     uint16 class grid, the uint8 three-band image, the float64 DEM)
     encoded and decoded through decode_mosaic_device, counted (one K4
     launch per micro-block group), bit-equal to the per-tile
     decode_band_device; regions and decode_mosaic of four tiles; the
     mosaic's K4 against its plain version on every cell's groups; the
     kernels' times and the DEM round's busy share;
  27. the public API (lerc_tpu_torch.encode / decode, compress / decompress,
     encode_4D, encodeForVersion), each case counted: a band routed to the
     band codec launches what encode_band_device / decode_band_device
     launch on it (the same kernels, the same counts), a band on the host
     codec launches nothing. The bench's 4096^2 float32 DEM as one band at
     maxZError 0.001, all-valid and with the bench mask on each quarter; a
     uint8 three-band 512^2 image with one shared mask (bands 2-3 carry no
     mask section); a float32 1024^2 x 2 band with NaN holes and a noData
     value (host encode); v5 and v2 encodes of a 512^2 crop (host encode;
     the v5 blob decodes on the card, the v2 blob on the host). Every routed
     band's bytes equal encode_band_device's, every decode is bit-equal to
     the host codec's decode of the same blob and within maxZError; the
     API's encode and decode MB/s (host clock ending in a synchronize, best
     of 3) and the host ms of filter_no_data_and_nan on the DEM;
  28. Q1-Q3, the Pallas probes of tools/profile_pallas.py
     (lerc_tpu_torch/ops/probes.py), at the probe's shapes: the probe path
     counted, each kernel against its plain version on the same CUDA
     tensors, their device ms (torch.profiler), bounds and, for Q1, the
     torch index_add_ call.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

TILE = 2048
N_TILES = 4          # 2 x 2 tiles = the 4096^2 DEM
MAX_Z_ERROR = 0.001
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12      # H100 SXM f64 outside the tensor cores
ROUNDS = 5
ALL_VALID = ("encode_blocks", "write_records", "fletcher32_parts", "decode_records")
MASKED = ("encode_blocks_masked", "write_records_masked", "fletcher32_parts",
          "decode_records_masked")
# kernel -> (source, the TPU kernel it replaces)
SOURCES = {
    "encode_blocks": ("lerc_tpu_torch/kernels/encode.cu", "lerc_tpu/ops/device_encode.py:486"),
    "write_records": ("lerc_tpu_torch/kernels/encode.cu", "lerc_tpu/ops/device_encode.py:486"),
    "fletcher32_parts": ("lerc_tpu_torch/kernels/fletcher32.cu",
                         "lerc_tpu/ops/device_scan.py:306"),
    "decode_records": ("lerc_tpu_torch/kernels/decode.cu", "lerc_tpu/ops/device_decode.py:64"),
    "encode_blocks_masked": ("lerc_tpu_torch/kernels/encode.cu",
                             "lerc_tpu/ops/device_encode.py:486"),
    "write_records_masked": ("lerc_tpu_torch/kernels/encode.cu",
                             "lerc_tpu/ops/device_encode.py:303"),
    "decode_records_masked": ("lerc_tpu_torch/kernels/decode.cu",
                              "lerc_tpu/ops/device_encode.py:357"),
}

SOURCES.update({name: ("lerc_tpu_torch/kernels/scan.cu", "lerc_tpu/ops/device_scan.py:35")
                for name in ("scan_records_sizes", "scan_records_double", "scan_records_describe")})
# the band codec's LUT instances of K1/K2 (8x8 and 16x16, float32 and int32)
SOURCES.update({f"{k}{m}{t}": ("lerc_tpu_torch/kernels/encode.cu",
                               "lerc_tpu/ops/device_encode.py:407" if k == "encode_blocks"
                               else "lerc_tpu/ops/device_encode.py:440")
                for k in ("encode_blocks", "write_records") for m in ("_lut", "_lut16")
                for t in ("", "_int")})
SOURCES["tile_scan"] = ("lerc_tpu_torch/kernels/tile_scan.cpp",
                        "lerc_tpu/native/lerc_native.cpp:70")
for _sfx in ("", "_i8", "_u8", "_i16", "_u16", "_i32", "_u32"):
    for _k6 in ("decode_scanned", "decode_scanned_masked", "decode_scanned16",
                "decode_scanned16_masked"):
        SOURCES[_k6 + _sfx] = ("lerc_tpu_torch/kernels/decode.cu",
                               "lerc_tpu/ops/device_decode.py:493")
    if _sfx:  # the integer instances of K1, K2 and K4
        SOURCES["encode_blocks" + _sfx] = ("lerc_tpu_torch/kernels/encode.cu",
                                           "lerc_tpu/ops/device_encode.py:591")
        SOURCES["write_records" + _sfx] = ("lerc_tpu_torch/kernels/encode.cu",
                                           "lerc_tpu/ops/device_encode.py:677")
        SOURCES["decode_records" + _sfx] = ("lerc_tpu_torch/kernels/decode.cu",
                                            "lerc_tpu/ops/device_decode.py:189")
# 8-bit whole-image Huffman: H1-H4 (kernels/huffman.cu) and the host scan
SOURCES.update({name: ("lerc_tpu_torch/kernels/huffman.cu", f"lerc_tpu/ops/device_huffman.py:{line}")
                for name, line in (("huffman_symbols", 50), ("huffman_symbols_masked", 72),
                                   ("huffman_group_bits", 160), ("huffman_pack", 160),
                                   ("huffman_decode", 278), ("huffman_restore", 477),
                                   ("huffman_restore_col0", 477), ("huffman_restore_delta", 477),
                                   ("huffman_restore_masked", 389),
                                   ("huffman_restore_delta_masked", 432))})
SOURCES["huffman_scan"] = ("lerc_tpu_torch/kernels/huffman_scan.cpp",
                           "lerc_tpu/native/lerc_native.cpp:604")
# lossless float32 (fpl): F1-F3 (kernels/fpl.cu)
SOURCES.update({name: ("lerc_tpu_torch/kernels/fpl.cu", f"lerc_tpu/ops/device_fpl.py:{line}")
                for name, line in (("fpl_sample_histograms", 123), ("fpl_finalize", 168),
                                   ("fpl_packbits_size", 88), ("fpl_restore", 235))})
# float64: K1/K2 f64 (kernels/encode.cu), K6 f64 (kernels/decode.cu), F1-F3
# over u64 words (kernels/fpl.cu)
SOURCES.update({f"{k}{m}_f64": ("lerc_tpu_torch/kernels/encode.cu", "lerc_tpu/ops/device_f64.py:95")
                for k in ("encode_blocks", "write_records") for m in ("", "_masked")})
SOURCES.update({f"decode_scanned{m}_f64": ("lerc_tpu_torch/kernels/decode.cu",
                                           "lerc_tpu/ops/device_decode.py:716")
                for m in ("", "_masked")})
SOURCES.update({name: ("lerc_tpu_torch/kernels/fpl.cu", f"lerc_tpu/ops/device_fpl.py:{line}")
                for name, line in (("fpl_sample_histograms_f64", 300), ("fpl_finalize_f64", 344),
                                   ("fpl_restore_f64", 407))})

# the tile mosaic: K4 with LUT records over n units (8x8 and 16x16, every
# dtype but float64, all-valid and masked) and the tile-batched K1 (per-tile
# ranges: the LUT instances and float64)
for _sfx in ("", "_i8", "_u8", "_i16", "_u16", "_i32", "_u32"):
    for _k4 in ("decode_records_lut", "decode_records_lut_masked", "decode_records_lut16",
                "decode_records_lut16_masked"):
        SOURCES[_k4 + _sfx] = ("lerc_tpu_torch/kernels/decode.cu",
                               "lerc_tpu/ops/device_decode.py:64")
SOURCES.update({f"encode_tiles{m}": ("lerc_tpu_torch/kernels/encode.cu",
                                     "lerc_tpu/parallel/sharding.py:53")
                for m in ("_lut", "_lut16", "_lut_int", "_lut16_int")})
SOURCES["encode_tiles_f64"] = ("lerc_tpu_torch/kernels/encode.cu",
                               "lerc_tpu/parallel/sharding.py:137")
# the Pallas probes of tools/profile_pallas.py (Q1-Q3)
SOURCES.update({name: ("lerc_tpu_torch/kernels/probes.cu", f"tools/profile_pallas.py:{line}")
                for name, line in (("probe_write", 36), ("probe_window", 63),
                                   ("probe_asm", 103))})


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def make_tiles(n, tile, device):
    """bench.py:91-117 on the device: smooth DEM structure plus xxhash-style
    integer-hash noise, u32 arithmetic in int64 masked to 32 bits."""
    x = torch.linspace(0, 20, tile, device=device)[None, :]
    y = torch.linspace(0, 15, tile, device=device)[:, None]
    m32 = 0xFFFFFFFF
    tiles = []
    for seed in range(n):
        i = (torch.arange(tile * tile, dtype=torch.int64, device=device).reshape(tile, tile)
             + ((seed * 0x9E3779B9) & m32)) & m32
        i = ((i ^ (i >> 16)) * 0x45D9F3B) & m32
        i = ((i ^ (i >> 16)) * 0x45D9F3B) & m32
        i = i ^ (i >> 16)
        noise = i.to(torch.float32) * 2.0**-32 - 0.5
        dem = (1500 * torch.exp(-((x - 10) ** 2 + (y - 7) ** 2) / 20)
               + 50 * torch.sin(x + seed) * torch.cos(y) + noise).to(torch.float32)
        tiles.append(dem[:, :, None].contiguous())
    return tiles


def cuda_ms(fns, reps=3):
    """Mean ms per call of fns on the device timeline (CUDA events), called
    round-robin so that inputs larger than the 50 MB L2 rotate out, after a
    warm-up pass. Includes any wait of the device on the host."""
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


def _kernel_rows(prof):
    """(key, calls, device us) of the CUDA kernel rows of a profile (the
    operator rows repeat their kernels' time)."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, e.count, dev_us))
    return rows


def profiled_rows(fns, reps, matches=(None,), tries=3):
    """The CUDA kernel rows of a torch.profiler window over `reps` rounds of
    fns (after a warm-up pass). The profiler's trace has come back empty
    now and then on the card; the window is taken again, up to `tries`
    times, until every pattern of `matches` (None: any kernel) has a row.
    Returns the rows, or None when it never does."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for f in fns:
                    f()
            torch.cuda.synchronize()
        rows = _kernel_rows(prof)
        if all(any(m is None or m in r[0] for r in rows) for m in matches):
            return rows
    return None


def device_ms(fns, match=None, reps=5):
    """Mean device ms per call of fns from torch.profiler: the time of the
    kernels whose name contains `match` (all kernels when None), free of the
    host's launch overhead. Calls round-robin as cuda_ms. Where the profiler
    shows no device time, the CUDA-event time of the calls stands in (and
    says so)."""
    rows = profiled_rows(fns, reps, (match,))
    if rows is None:
        print(f"profiler shows no device time for {match or 'the calls'}: CUDA events instead",
              flush=True)
        return cuda_ms(fns, reps)
    rows = [r for r in rows if match is None or match in r[0]]
    return sum(r[2] for r in rows) / 1e3 / (reps * len(fns))


def max_abs(a, b):
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def kernel_inputs(codec, tile):
    """Every kernel's inputs on the main path for one tile, from the
    kernels themselves."""
    from lerc_tpu_torch.ops import device_encode as enc

    p = enc.encode_params(codec.mze, codec.version, codec.nb_cap)
    rec_info, zrange, _ = enc.encode_blocks(tile, p, codec.valid)
    length = rec_info[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    header, stream, meta, starts2 = codec.encode_fast(tile)
    return dict(p=p, rec_info=rec_info, zrange=zrange, starts=starts, header=header,
                stream=stream, meta=meta, total=meta[0].reshape(1), starts_enc=starts2)


def check_kernels(codec, tiles, timed):
    """Phase 3 for one codec configuration: each kernel vs its plain version
    on the same CUDA tensors -- the masked kernels when the codec has a
    mask. With `timed`, also each one's ms and plain ms over all tiles (K3
    only on an all-valid codec: the masked path runs the same K3)."""
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_encode as enc
    from lerc_tpu_torch.ops import device_scan as scan

    h, w, d = tiles[0].shape
    v = codec.valid
    k1, k2, k3, k4 = ALL_VALID if v is None else MASKED
    sk, hl = codec._skip, codec._head_len
    cap_nb = 32 if codec.nb_cap <= 0 else min(codec.nb_cap, 32)
    lut = 0 < codec.nb_cap <= 16
    ins = [kernel_inputs(codec, t) for t in tiles]
    err = {}
    for t, k in zip(tiles, ins):
        ri, zr, fi = enc.encode_blocks_ref(t, k["p"], v)
        require(torch.equal(ri, k["rec_info"]) and torch.equal(zr, k["zrange"])
                and int(fi) == int(k["meta"][2]), f"K1 {k1} != plain at {h}x{w}x{d}")
        err[k1] = max(err.get(k1, 0.0), max_abs(ri, k["rec_info"]), max_abs(zr, k["zrange"]))
        require(torch.equal(k["starts"], k["starts_enc"]), "starts differ between runs")
        s_k = enc.write_records(t, k["rec_info"], k["starts"], codec.cap // 4, k["p"], v)
        s_r = enc.write_records_ref(t, k["rec_info"], k["starts"], codec.cap // 4, k["p"], v)
        require(torch.equal(s_k, s_r) and torch.equal(s_k, k["stream"]),
                f"K2 {k2} != plain at {h}x{w}x{d}")
        err[k2] = max(err.get(k2, 0.0), max_abs(s_k, s_r))
        args = (k["header"][sk:hl], codec._static_ab, k["header"][hl:], k["stream"], k["total"])
        c_k, c_r = scan.fletcher32_parts(*args), scan.fletcher32_parts_ref(*args)
        require(int(c_k) == int(c_r) == int(k["meta"][1]), f"K3 {k3} != plain at {h}x{w}x{d}")
        err[k3] = max(err.get(k3, 0.0), max_abs(c_k, c_r))
        dargs = (k["stream"], k["starts"], k["zrange"][d:], 2.0 * codec.mze, h, w, d, cap_nb,
                 lut, v)
        (i_k, f_k), (i_r, f_r) = dec.decode_records(*dargs), dec.decode_records_ref(*dargs)
        require(torch.equal(i_k.view(torch.int32), i_r.view(torch.int32)) and torch.equal(f_k, f_r)
                and int(f_k[0]) == 1 and int(f_k[1]) == int(k["meta"][2]),
                f"K4 {k4} != plain at {h}x{w}x{d}")
        err[k4] = max(err.get(k4, 0.0), max_abs(i_k, i_r))
    if not timed:
        return err, None
    p = ins[0]["p"]
    cw = codec.cap // 4

    def dargs(k):
        return (k["stream"], k["starts"], k["zrange"][d:], 2.0 * codec.mze, h, w, d, cap_nb,
                lut, v)

    def fargs(k):
        return (k["header"][sk:hl], codec._static_ab, k["header"][hl:], k["stream"], k["total"])

    fns = {
        k1: ([lambda t=t: enc.encode_blocks(t, p, v) for t in tiles],
             [lambda t=t: enc.encode_blocks_ref(t, p, v) for t in tiles]),
        k2: ([lambda t=t, k=k: enc.write_records(t, k["rec_info"], k["starts"], cw, p, v)
              for t, k in zip(tiles, ins)],
             [lambda t=t, k=k: enc.write_records_ref(t, k["rec_info"], k["starts"], cw, p, v)
              for t, k in zip(tiles, ins)]),
        k3: ([lambda k=k: scan.fletcher32_parts(*fargs(k)) for k in ins],
             [lambda k=k: scan.fletcher32_parts_ref(*fargs(k)) for k in ins]),
        k4: ([lambda k=k: dec.decode_records(*dargs(k)) for k in ins],
             [lambda k=k: dec.decode_records_ref(*dargs(k)) for k in ins]),
    }
    if v is not None:
        del fns[k3]
    times = {name: (device_ms(kf, f"{name}_kernel"), cuda_ms(rf, reps=1))
             for name, (kf, rf) in fns.items()}
    scan_ms = device_ms([lambda k=k: torch.cumsum(k["rec_info"][:, 0], 0, dtype=torch.int32)
                         for k in ins])
    return err, (times, scan_ms, ins)


def bounds(codec, ins):
    """Least time of each kernel for this run's inputs (mean over the
    tiles): bytes each input read once and each output written once over
    HBM bandwidth, against the operations over the peak rate of their type;
    the larger of the two. With a mask the kernels need only the valid
    values and read 8 B of validity words per block."""
    from lerc_tpu_torch.ops import device_encode as enc

    h, w, d = codec.h, codec.w, codec.d
    n_px, n_rec = h * w * d, codec.n_rec
    v = codec.valid
    if v is None:
        cnt = torch.full((n_rec,), 64, device=ins[0]["rec_info"].device)
        v_bytes = 0
    else:
        cnt = enc.valid_lanes(v).sum(1).repeat_interleave(d)  # values per record
        v_bytes = 8 * v.shape[0]
    n_val = int(cnt.sum())
    k1, k2, k3, k4 = ALL_VALID if v is None else MASKED
    out = {}
    for_k = {name: [] for name in (k1, k2, k3, k4)}
    for k in ins:
        total = int(k["meta"][0])
        mode = (k["rec_info"][:, 1] >> 8) & 3
        coded = int(cnt[(mode == 0) | (mode == 1)].sum())  # values K2 reads
        hdr_b = k["header"].numel()
        for_k[k1].append((4 * n_val + v_bytes + 16 * n_rec + 8 * d + 4,
                          20 * n_val / F32_OPS_PER_S))
        for_k[k2].append((4 * coded + v_bytes + 16 * n_rec + 4 * n_rec + total,
                          12 * coded / F32_OPS_PER_S))
        for_k[k3].append((total + hdr_b + 4, 6 * (total + hdr_b) / F32_OPS_PER_S))
        for_k[k4].append((total + v_bytes + 4 * n_rec + 4 * d + 4 * n_px + 8,
                          2 * n_val / F64_OPS_PER_S))
    for name, rows in for_k.items():
        b = float(np.mean([r[0] for r in rows])) / HBM_BYTES_PER_S * 1e3
        o = float(np.mean([r[1] for r in rows])) * 1e3
        out[name] = (max(b, o), "bytes" if b >= o else "operations")
    return out


def small_dem(rng):
    """A 64x64x1 float32 DEM patch: hill, sinusoid and Gaussian noise."""
    x = np.linspace(0, 8, 64)[None, :, None]
    y = np.linspace(0, 5, 64)[:, None, None]
    return (900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
            + 0.3 * rng.standard_normal((64, 64, 1))).astype(np.float32)


def bench_mask():
    """The JAX bench's mask (bench.py:249-252): a 500x1000 hole plus 2%
    speckle, from seed 0."""
    rng = np.random.default_rng(0)
    mask = np.ones((TILE, TILE), bool)
    mask[300:800, 500:1500] = False
    mask[rng.random((TILE, TILE)) > 0.98] = False
    return mask


def hole_speckle(h, w, rng, speckle=0.1):
    """The bench mask's shape at a small size: a hole plus speckle."""
    mask = np.ones((h, w), bool)
    mask[h // 8 : h // 3, w // 4 : 3 * w // 4] = False
    mask[rng.random((h, w)) > 1 - speckle] = False
    return mask


def edge_tiles(seed=0):
    """Small tiles that reach the record modes and fields the DEM does not:
    (name, [H, W, D] float32, maxZError, nb_cap)."""
    from lerc_tpu_torch.ops import device_encode as enc

    rng = np.random.default_rng(seed)
    dem = small_dem(rng)
    raw = dem.copy()  # raw records: block range / (2 maxZError) > 2^30 - 1
    raw[0:8, 0:16] = np.where(np.arange(16) % 2, 3.0e6, -1.0)[None, :, None]
    mixed = dem.copy()  # const-0, const-offset, byte/short integer offsets
    mixed[0:8, 0:8] = 0.0
    mixed[8:16, 0:8] = -12.0
    mixed[16:32] = np.round(mixed[16:32]) - 500
    # values a few ulps around quantization-grid midpoints where a fused and
    # an unfused fixup pick different quants (the FMA question)
    p = enc.encode_params(0.01, 6)
    zmin = torch.from_numpy(rng.uniform(-500, 900, (64, 1)).astype(np.float32))
    k = torch.from_numpy(rng.integers(1, 4000, (64, 4096)).astype(np.float64))
    cand = (zmin.double() + (k + 0.5) * p.inv).float()
    cand = (cand.view(torch.int32)
            + torch.from_numpy(rng.integers(-3, 4, cand.shape).astype(np.int32))).view(torch.float32)
    scale, inv = torch.tensor(p.scale), torch.tensor(p.inv)
    q0 = torch.round((cand - zmin) * scale)
    resid = cand - (zmin + q0 * inv)
    qc = torch.clamp_min(q0 + torch.sign(resid), 0.0)
    unfused = torch.where((cand - (zmin + qc * inv)).abs() < resid.abs(), qc, q0).to(torch.int64)
    differ = enc.quantize_ref(cand, zmin, p) != unfused
    order = torch.argsort(differ.to(torch.int8), dim=1, descending=True, stable=True)
    blocks = torch.cat([zmin, cand.gather(1, order[:, :63])], 1)
    tie = blocks.reshape(8, 8, 8, 8).permute(0, 2, 1, 3).reshape(64, 64, 1).contiguous().numpy()
    return [
        ("raw", raw, 0.001, 0), ("raw", raw, 0.001, 16), ("mixed", mixed, 0.003, 0),
        ("tie", tie, 0.01, 0), ("constant", np.full((32, 32, 1), 7.25, np.float32), 0.01, 0),
        ("depth-3", np.repeat(dem[:32, :32], 3, axis=2) + np.arange(3, dtype=np.float32), 0.001, 0),
        ("72x72", np.pad(dem, ((0, 8), (0, 8), (0, 0)), mode="edge"), 0.005, 0),
        ("unfit", rng.normal(0, 150, (64, 64, 1)).astype(np.float32), 0.001, 16),
        ("maxZError 0", dem, 0.0, 0),
    ]


def masked_edge_tiles(seed=1):
    """Small masked tiles that reach what the bench mask does not: (name,
    [H, W, D] float32, [H, W] bool mask, maxZError, nb_cap)."""
    from lerc_tpu_torch.codec import bitmask, rle

    rng = np.random.default_rng(seed)
    dem = small_dem(rng)
    sparse = hole_speckle(64, 64, rng, speckle=0.2)
    sparse[0:16, 0:24] = False  # block (0, 1) stays empty: a const-0 record
    sparse[3, 5] = True         # one non-integer value: raw, 5 B ties the stuff record
    sparse[9, 2] = True         # one integer value: const offset, byte offset
    sparse[1, 17] = sparse[6, 22] = True  # two values
    sdata = dem.copy()
    sdata[9, 2] = 17.0
    raw = dem.copy()  # raw records among the valid values
    raw[0:8, 0:16] = np.where(np.arange(16) % 2, 3.0e6, -1.0)[None, :, None]
    nan_mask = hole_speckle(64, 64, rng)
    nan = dem.copy()  # invalid pixels may hold anything
    nan[~nan_mask] = np.nan
    by_parity = {}  # masks whose section length (4 + RLE) is odd and even
    while len(by_parity) < 2:
        m = hole_speckle(48, 48, rng)
        by_parity.setdefault((4 + len(rle.compress(bitmask.bool_to_bits(m)))) % 2, m)
    dem48 = np.ascontiguousarray(dem[:48, :48])
    depth3 = np.repeat(dem[:32, :32], 3, axis=2) + np.arange(3, dtype=np.float32)
    return [
        ("sparse-block", sdata, sparse, 0.001, 0), ("sparse-block", sdata, sparse, 0.001, 16),
        ("depth-3", depth3, hole_speckle(32, 32, rng), 0.001, 0),
        ("depth-3-no-speckle", depth3, hole_speckle(32, 32, rng, speckle=0.0), 0.01, 16),
        ("odd-RLE", dem48, by_parity[1], 0.002, 0), ("even-RLE", dem48, by_parity[0], 0.002, 0),
        ("raw", raw, hole_speckle(64, 64, rng), 0.001, 0),
        ("NaN-under-the-mask", nan, nan_mask, 0.001, 0),
        ("72x72", np.pad(dem, ((0, 8), (0, 8), (0, 0)), mode="edge"), hole_speckle(72, 72, rng),
         0.005, 0),
        ("maxZError-0", dem, hole_speckle(64, 64, rng), 0.0, 0),
    ]


def check_blobs(codec, plain, tiles, outs, decs, mask, label):
    """Every tile of one run: decode ok, fits, max error over the valid
    pixels <= 1.1 * maxZError, invalid pixels +0.0, blob byte-equal to the
    plain path's (device="cpu"), header parsed back with the shape, the
    blob size and the valid-pixel count. Returns the blobs' bytes."""
    from lerc_tpu_torch.codec import header as hdr

    h, w, d = tiles[0].shape
    valid = None if mask is None else torch.from_numpy(mask).to(tiles[0].device)
    n_valid = h * w if mask is None else int(mask.sum())
    blob_bytes = 0
    for i, ((header, stream, meta, _), (img, ok)) in enumerate(zip(outs, decs)):
        require(bool(ok), f"{label}: decode ok False on tile {i}")
        require(int(meta[2]) == 1, f"{label}: tile {i} does not fit")
        diff = (img - tiles[i]).abs()
        if valid is not None:
            require(not img.view(torch.int32)[~valid].any(),
                    f"{label}: invalid pixels of tile {i} are not +0.0")
            diff = diff[valid]
        err = float(diff.max())
        require(err <= codec.mze * 1.1, f"{label}: error bound violated on tile {i}: {err}")
        blob = codec.blob_to_bytes(header, stream, meta)
        ref = plain.blob_to_bytes(*plain.encode_fast(tiles[i].cpu())[:3])
        require(blob == ref, f"{label}: blob of tile {i} differs from the plain path's")
        head, _ = hdr.read_header(blob)
        require((head.n_rows, head.n_cols, head.n_depth, head.blob_size, head.num_valid_pixel)
                == (h, w, d, len(blob), n_valid), f"{label}: header of tile {i} does not parse back")
        blob_bytes += len(blob)
    return blob_bytes


def main_path(tiles, mask, card):
    """Phases 4 and 5 for one mask (None: all valid) at nb_cap 0 and 16:
    the counted run, its checks, and the timed rounds. Returns (launches of
    the path's kernels, {nb_cap: (encode MB/s, decode MB/s, compression
    ratio, encode ms, decode ms)})."""
    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.kernels import build

    label = "main path" if mask is None else "masked main path"
    names = ALL_VALID if mask is None else MASKED
    mb = N_TILES * TILE * TILE * 4 / 1e6  # full tiles' raw bytes, masked or not
    launches = dict.fromkeys(names, 0)
    results = {}
    for nb_cap in (0, 16):
        codec = FusedResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR, nb_cap=nb_cap,
                                   mask=mask)
        plain = FusedResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR, nb_cap=nb_cap,
                                   mask=mask, device="cpu")
        torch.cuda.synchronize()
        build.reset_launches()
        outs = [codec.encode_fast(t) for t in tiles]
        decs = [codec.decode_fast(o[0], o[1], o[3]) for o in outs]
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        for name, n in counts.items():
            if name in names:
                require(n > 0, f"kernel {name} was not launched on the {label} (nb_cap={nb_cap})")
                launches[name] += n
            else:
                require(n == 0, f"kernel {name} was launched on the {label} (nb_cap={nb_cap})")
        blob_bytes = check_blobs(codec, plain, tiles, outs, decs, mask,
                                 f"{label} nb_cap={nb_cap}")
        print(f"{label} nb_cap={nb_cap}: 4 tiles ok, launches {counts}, "
              f"blobs equal to the plain path", flush=True)

        # ---- 5. timings (CUDA events; warm-up, best of ROUNDS)
        best_enc = best_dec = float("inf")
        for _ in range(ROUNDS + 1):
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            e0.record()
            outs = [codec.encode_fast(t) for t in tiles]
            e1.record()
            decs = [codec.decode_fast(o[0], o[1], o[3]) for o in outs]
            e2.record()
            e2.synchronize()
            best_enc = min(best_enc, e0.elapsed_time(e1))
            best_dec = min(best_dec, e1.elapsed_time(e2))
        require(all(bool(ok) for _, ok in decs), f"{label}: decode ok False in the timed rounds")
        results[nb_cap] = (mb / (best_enc / 1e3), mb / (best_dec / 1e3), mb * 1e6 / blob_bytes,
                           best_enc, best_dec)
        print(f"{label} nb_cap={nb_cap}: encode {results[nb_cap][0]:.1f} MB/s "
              f"({best_enc:.3f} ms / 4096^2 DEM), decode {results[nb_cap][1]:.1f} MB/s "
              f"({best_dec:.3f} ms), compression ratio {results[nb_cap][2]:.4f} "
              f"[{card}]", flush=True)
    return launches, results


def where_the_time_goes(codec, tiles, round_ms, card, label, rounds=3, round_fn=None):
    """Phase 6: torch.profiler over `rounds` rounds of a path (by default
    encode + indexed decode of the four tiles, nb_cap 0). Prints the device
    time per round by operator and its share of `round_ms`, the unprofiled
    CUDA-event time of one round; the rest is the device waiting on the
    host."""
    from torch.profiler import ProfilerActivity, profile

    def one_round():
        outs = [codec.encode_fast(t) for t in tiles]
        [codec.decode_fast(o[0], o[1], o[3]) for o in outs]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            (round_fn or one_round)()
        torch.cuda.synchronize()
    rows = [(us / rounds / 1e3, n // rounds, key) for key, n, us in _kernel_rows(prof)]
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile ({label}): device busy {busy:.4f} ms of {round_ms:.4f} ms per round of the "
          f"four tiles ({busy / round_ms:.1%} busy, {1 - busy / round_ms:.1%} idle) [{card}]")
    for ms, n, name in rows[:10]:
        print(f"  profile ({label}): {ms:.4f} ms/round  {n:4d} calls/round  {name[:70]}")


# ---------------------------------------------------------------------------
# The index-free decode (K5 scan_records, K6 decode_scanned) and the integer
# instances of K1, K2, K4 and K6
# ---------------------------------------------------------------------------


def int_name(base, dt, masked=False):
    from lerc_tpu_torch.constants import DT_SUFFIX

    return base + ("_masked" if masked else "") + DT_SUFFIX[dt]


def check_scan(stream, total, n_rec, dt, version, mze, zmax, shape):
    """K5's three kernels step by step and K6 against their plain versions
    on one all-valid stream. Returns ({kernel: max_abs_err}, the kernel
    scan's outputs)."""
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_scan as scan

    h, w, d = shape
    tag = f"{h}x{w}x{d} {dt.name} v{version}"
    j_k = scan.scan_records_sizes(stream, dt, version)
    j_r = scan.scan_records_sizes_ref(stream, dt, version)
    require(torch.equal(j_k, j_r), f"K5 scan_records_sizes != plain ({tag})")
    rp_k = torch.zeros(n_rec, dtype=torch.int32, device=stream.device)
    rp_r = rp_k.clone()
    filled = 1
    while filled < n_rec:
        take = min(filled, n_rec - filled)
        square = filled + take < n_rec
        j_k, rp_k = scan.scan_records_double(j_k, rp_k, filled, take, square)
        j_r, rp_r = scan.scan_records_double_ref(j_r, rp_r, filled, take, square)
        require(torch.equal(j_k, j_r) and torch.equal(rp_k, rp_r),
                f"K5 scan_records_double != plain at step {filled} ({tag})")
        filled += take
    d_k = scan.scan_records_describe(stream, rp_k, dt, version, total)
    d_r = scan.scan_records_describe_ref(stream, rp_r, dt, version, total)
    bits = [t.view(torch.int32) if t.dtype == torch.float32 else t for t in (*d_k[:8], *d_r[:8])]
    require(all(torch.equal(a, b) for a, b in zip(bits[:8], bits[8:]))
            and bool(d_k[8]) == bool(d_r[8]), f"K5 scan_records_describe != plain ({tag})")
    require(bool(d_k[8]), f"K5: the record chain does not end at total ({tag})")
    full = scan.scan_records(stream, n_rec, dt, version, total)
    mode, offset, nb = full[1], full[2], full[3]
    ppos = full[5]
    img_k, ok_k = dec.decode_scanned(stream, mode, ppos, offset, nb, full[4], full[6], full[7],
                                     full[8], None, mze, zmax, h, w, d, dt, True, False)
    img_r, ok_r = dec.decode_scanned_ref(stream, mode, ppos, offset, nb, full[4], full[6], full[7],
                                         full[8], None, 2.0 * mze, dec._inv_i(mze), zmax, h, w,
                                         d, dt)
    same = (torch.equal(img_k.view(torch.int32), img_r.view(torch.int32))
            if img_k.dtype == torch.float32 else torch.equal(img_k, img_r))
    require(same and bool(ok_k) == bool(ok_r) and bool(ok_k), f"K6 decode_scanned != plain ({tag})")
    err = {n: 0.0 for n in ("scan_records_sizes", "scan_records_double", "scan_records_describe")}
    err[int_name("decode_scanned", dt)] = max_abs(img_k, img_r)
    return err, full


def check_int_kernels(codec, tiles):
    """The integer K1, K2, K4 instances (the masked ones when the codec has
    a mask) against their plain versions on the same CUDA tensors, and on
    all-valid codecs K5 and K6 on the streams. Returns ({kernel:
    max_abs_err}, per-tile inputs)."""
    from lerc_tpu_torch.constants import DEC_MAX_NB, DT_SIZE
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_encode as enc

    h, w, d = tiles[0].shape
    dt, v = codec.dt, codec.valid
    k1, k2, k4 = (int_name(b, dt, v is not None)
                  for b in ("encode_blocks", "write_records", "decode_records"))
    max_nb = DEC_MAX_NB[DT_SIZE[dt]]
    eff = max_nb if codec.nb_cap <= 0 else min(codec.nb_cap, max_nb)
    cap_nb, lut = (32 if eff >= max_nb else eff), 0 < codec.nb_cap <= 16
    p = enc.encode_params(codec.mze, codec.version, codec.nb_cap, dt)
    tag = f"{h}x{w}x{d} {dt.name} maxZError {codec.mze} v{codec.version} nb_cap {codec.nb_cap}"
    err, ins = {}, []
    for t in tiles:
        ri, zr, fi = enc.encode_blocks(t, p, v)
        ri_r, zr_r, fi_r = enc.encode_blocks_ref(t, p, v)
        require(torch.equal(ri, ri_r) and torch.equal(zr, zr_r) and torch.equal(fi, fi_r),
                f"K1 {k1} != plain ({tag})")
        length = ri[:, 0]
        starts = torch.cumsum(length, 0, dtype=torch.int32) - length
        s_k = enc.write_records(t, ri, starts, codec.cap // 4, p, v)
        s_r = enc.write_records_ref(t, ri, starts, codec.cap // 4, p, v)
        require(torch.equal(s_k, s_r), f"K2 {k2} != plain ({tag})")
        zmax = zr[d:].contiguous()
        args = (s_k, starts, zmax, dec._inv_i(codec.mze), h, w, d, dt, codec.version, cap_nb,
                lut, v)
        (i_k, f_k), (i_r, f_r) = dec.decode_records_int(*args), dec.decode_records_int_ref(*args)
        # (over depth-diff records index_ok drops and the image is
        # meaningless, but it is the same bytes' parse in both versions)
        require(torch.equal(f_k, f_r) and torch.equal(i_k, i_r), f"K4 {k4} != plain ({tag})")
        err[k4] = max(err.get(k4, 0.0), max_abs(i_k, i_r))
        err[k1] = max(err.get(k1, 0.0), max_abs(ri, ri_r), max_abs(zr, zr_r))
        err[k2] = max(err.get(k2, 0.0), max_abs(s_k, s_r))
        total = (starts[-1] + length[-1]).reshape(1)
        ins.append(dict(p=p, rec_info=ri, starts=starts, stream=s_k, total=total, zmax=zmax,
                        fits=int(fi)))
        if v is None and int(fi):
            e, _ = check_scan(s_k, total, codec.n_rec, dt, codec.version, codec.mze, zmax,
                              (h, w, d))
            for k, x in e.items():
                err[k] = max(err.get(k, 0.0), x)
    return err, ins


def int_tile_small(npdt, h, w, d, seed=0):
    """A small integer tile: band-correlated slices (depth-diff records),
    block minima at the offset reduction boundaries, a constant block, a
    raw block, lossy-quantization ties and, for 4-byte types, a block
    spanning the dtype (int32 wrap-around)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(npdt)
    lo, hi = max(info.min, -40000), min(info.max, 70000)
    x = np.linspace(0, 6, w)[None, :]
    y = np.linspace(0, 4, h)[:, None]
    base = (np.sin(x + y) * 0.5 + 0.5) * (hi - lo) * 0.3 + lo + (hi - lo) * 0.2
    bands = [base + rng.integers(-2, 3, (h, w))]
    for _ in range(1, d):
        bands.append(bands[-1] + rng.integers(-3, 2, (h, w)))
    z = np.stack(bands, -1)
    marks = [b for b in (-129, -128, 127, 255, 256, 32767, 65535, 0, 7) if lo <= b <= hi - 10]
    for i, v in enumerate(marks):
        r, c = divmod(i, w // 8)
        z[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = v + rng.integers(0, 10, (8, 8, d))
    z[-8:, -8:] = z[-8, -8, 0]
    z[-16:-8, :8] = rng.integers(lo, hi, (8, 8, d))
    z[-8:, 8:16] = (lo + 10 + 2 * np.arange(64).reshape(8, 8))[:, :, None]
    if info.bits == 32:
        z[-16:-8, 8:16] = rng.integers(info.min, info.max, (8, 8, d), dtype=np.int64)
    return np.clip(z, info.min, info.max).astype(npdt)


def int_edge_configs():
    """(dtype, depth, maxZError, version, nb_cap, masked) of the integer
    edge tiles: every dtype lossless with depth-diff records (v6) and at v4,
    lossy at depth 1 under nb_cap 16, and masked."""
    out = []
    for npdt in (np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32):
        out += [(npdt, 3, 0.5, 6, 0, False), (npdt, 3, 0.5, 4, 0, False),
                (npdt, 1, 2.0, 6, 16, False), (npdt, 3, 0.5, 6, 0, True),
                (npdt, 1, 2.0, 5, 0, True)]
    return out


def int_cell_tiles(dem_tiles, npdt, d):
    """The bench DEM as an integer raster: rounded to whole metres (int16,
    int32), or an 8-bit three-band image whose bands follow the DEM (the
    second a few levels above the first, the third a few below, each with
    0..2 levels of the DEM's hash noise), so that depth-diff records occur."""
    out = []
    for dem in dem_tiles:
        if d == 1:
            out.append(torch.round(dem).to(torch.int32 if npdt == np.int32 else torch.int16))
            continue
        r = torch.clamp(torch.round(dem[:, :, 0] / 6.5), 0, 255)
        frac = dem[:, :, 0] - torch.floor(dem[:, :, 0])  # the hash noise, in [0, 1)
        n1, n2 = torch.floor(frac * 3), torch.floor((frac * 7) % 1 * 3)
        g = torch.clamp(r + 4 + n1, 0, 255)
        b = torch.clamp(r - 6 + n2, 0, 255)
        out.append(torch.stack([r, g, b], -1).to(torch.uint8).contiguous())
    return out


INT_CELLS = (  # (label, dtype, depth, maxZError)
    ("int16 DEM in whole metres", np.int16, 1, 0.5),
    ("int32 DEM", np.int32, 1, 2.0),
    ("uint8 three-band", np.uint8, 3, 0.5),
)
SCAN = ("scan_records_sizes", "scan_records_double", "scan_records_describe")


def run_counted(names, label, fn):
    """Drive one path with every launch count at 0 before it; require each
    kernel in `names` launched and no other. Returns the counts."""
    from lerc_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: n for k, n in build.LAUNCHES.items() if n}
    for name in names:
        require(counts.get(name, 0) > 0, f"kernel {name} was not launched on the {label}")
    extra = sorted(set(counts) - set(names))
    require(not extra, f"kernels {extra} were launched on the {label}")
    return counts, out


def best_ms(fn, rounds=ROUNDS):
    """Best CUDA-event ms of fn() over `rounds` after a warm-up."""
    best = float("inf")
    for _ in range(rounds + 1):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def index_free_path(tiles, card):
    """Phase 4b: decode_fast(header, stream) -- no index -- on the four
    2048^2 float32 tiles at nb_cap 0 and 16: ok True, bit-equal to the
    indexed decode, K3, K5 and K6 launched and K4 not. Returns (launches,
    {nb_cap: (index-free MB/s, indexed MB/s, ms, ms)}, the nb_cap-0 codec
    and blobs)."""
    from lerc_tpu_torch import FusedResidentCodec

    names = ("fletcher32_parts", *SCAN, "decode_scanned")
    mb = N_TILES * TILE * TILE * 4 / 1e6
    launches, results, keep = {}, {}, None
    for nb_cap in (0, 16):
        codec = FusedResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR, nb_cap=nb_cap)
        outs = [codec.encode_fast(t) for t in tiles]
        label = f"index-free decode path (nb_cap={nb_cap})"
        counts, decs = run_counted(names, label,
                                   lambda: [codec.decode_fast(o[0], o[1]) for o in outs])
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        for i, ((img, ok), o, t) in enumerate(zip(decs, outs, tiles)):
            ref, ref_ok = codec.decode_fast(o[0], o[1], o[3])
            require(bool(ok) and bool(ref_ok), f"{label}: ok False on tile {i}")
            require(torch.equal(img.view(torch.int32), ref.view(torch.int32)),
                    f"{label}: tile {i} differs from the indexed decode")
            require(float((img - t).abs().max()) <= MAX_Z_ERROR * 1.1,
                    f"{label}: error bound violated on tile {i}")
        ms_free = best_ms(lambda: [codec.decode_fast(o[0], o[1]) for o in outs])
        ms_idx = best_ms(lambda: [codec.decode_fast(o[0], o[1], o[3]) for o in outs])
        results[nb_cap] = (mb / (ms_free / 1e3), mb / (ms_idx / 1e3), ms_free, ms_idx)
        print(f"{label}: 4 tiles ok, bit-equal to the indexed decode, launches {counts}; "
              f"index-free {results[nb_cap][0]:.1f} MB/s ({ms_free:.3f} ms / 4096^2 DEM) vs "
              f"indexed {results[nb_cap][1]:.1f} MB/s ({ms_idx:.3f} ms) [{card}]", flush=True)
        if nb_cap == 0:
            keep = (codec, outs)
    return launches, results, keep


def int_cell(label, npdt, d, mze, dem_tiles, card):
    """Phase 4c: one integer cell on four 2048^2 tiles: encode_fast, decode
    with and without the index, ResidentCodec.encode/decode, counted as one
    path; lossless exact / lossy within maxZError, blobs byte-equal to the
    plain path's (device="cpu"). Returns (launches, the codec, its tiles,
    the fused blobs, the ms of an encode + index-free decode round)."""
    from lerc_tpu_torch import FusedResidentCodec, ResidentCodec
    from lerc_tpu_torch.constants import NUMPY_TO_DT

    dt = NUMPY_TO_DT[np.dtype(npdt)]
    tiles = int_cell_tiles(dem_tiles, npdt, d)
    args = (TILE, TILE, d, npdt, mze)
    codec, rcodec = FusedResidentCodec(*args), ResidentCodec(*args)
    plain = FusedResidentCodec(*args, device="cpu")
    names = (int_name("encode_blocks", dt), int_name("write_records", dt), "fletcher32_parts",
             int_name("decode_records", dt), *SCAN, int_name("decode_scanned", dt))

    def path():
        outs = [codec.encode_fast(t) for t in tiles]
        idx = [codec.decode_fast(o[0], o[1], o[3]) for o in outs]
        free = [codec.decode_fast(o[0], o[1]) for o in outs]
        rblobs = [rcodec.encode(t) for t in tiles]
        r_idx = []
        for b in rblobs:
            try:
                r_idx.append(rcodec.decode(b))
            except ValueError as e:  # an index over depth-diff records
                r_idx.append(e)
        starts = [b.starts for b in rblobs]
        for b in rblobs:
            b.starts = None
        r_free = [rcodec.decode(b) for b in rblobs]
        for b, s in zip(rblobs, starts):
            b.starts = s
        return outs, idx, free, rblobs, r_idx, r_free

    counts, (outs, idx, free, rblobs, r_idx, r_free) = run_counted(names, f"{label} cell", path)
    bound = 0 if mze == 0.5 else int(np.floor(mze))
    n_diff = blob_bytes = 0
    for i, t in enumerate(tiles):
        header, stream, meta, starts = outs[i]
        require(int(meta[2]) == 1, f"{label}: tile {i} does not fit")
        flags = stream.view(torch.uint8)[starts.long()]
        diff = int(((flags & 4) != 0).sum())
        n_diff += diff
        err = lambda img: int((img.to(torch.int64) - t.to(torch.int64)).abs().max())  # noqa: E731
        img, ok = free[i]
        require(bool(ok) and err(img) <= bound, f"{label}: index-free decode of tile {i} wrong")
        require(torch.equal(r_free[i], img), f"{label}: ResidentCodec decode of tile {i} differs")
        img_i, ok_i = idx[i]
        if diff:
            require(not bool(ok_i), f"{label}: indexed decode ok over depth-diff records")
            require(isinstance(r_idx[i], ValueError),
                    f"{label}: ResidentCodec indexed decode over depth-diff records did not raise")
        else:
            require(bool(ok_i) and torch.equal(img_i, img), f"{label}: indexed decode of tile {i}")
            require(torch.equal(r_idx[i], img), f"{label}: ResidentCodec indexed decode of tile {i}")
        blob = codec.blob_to_bytes(header, stream, meta)
        ref = plain.blob_to_bytes(*plain.encode_fast(t.cpu())[:3])
        require(blob == ref, f"{label}: blob of tile {i} differs from the plain path's")
        require(rblobs[i].to_bytes() == blob, f"{label}: ResidentCodec blob of tile {i} differs")
        blob_bytes += len(blob)
    if d > 1:
        require(n_diff > 0, f"{label}: no depth-diff record in the cell")
    raw_mb = N_TILES * tiles[0].numel() * tiles[0].element_size() / 1e6
    enc_ms = best_ms(lambda: [codec.encode_fast(t) for t in tiles])
    free_ms = best_ms(lambda: [codec.decode_fast(o[0], o[1]) for o in outs])
    idx_ms = best_ms(lambda: [codec.decode_fast(o[0], o[1], o[3]) for o in outs])
    ratio = raw_mb * 1e6 / blob_bytes
    idx_txt = (f"indexed {raw_mb / (idx_ms / 1e3):.1f} MB/s ({idx_ms:.3f} ms)" if not n_diff else
               f"indexed decode not ok over the depth-diff records ({idx_ms:.3f} ms)")
    print(f"{label} cell ({d} x {np.dtype(npdt).name}, maxZError {mze}): 4 tiles ok, "
          f"{n_diff} depth-diff records, launches {counts}; encode {raw_mb / (enc_ms / 1e3):.1f} "
          f"MB/s ({enc_ms:.3f} ms), index-free decode {raw_mb / (free_ms / 1e3):.1f} MB/s "
          f"({free_ms:.3f} ms), {idx_txt}, compression ratio {ratio:.4f} [{card}]", flush=True)
    return counts, codec, tiles, outs, enc_ms + free_ms


def timed_scan_kernels(stream_sets, dt, version, mze, shape):
    """Device ms per launch of K5's three kernels and of K6 over the given
    (stream, total, zmax) sets (one torch.profiler window of full scan +
    decode calls), the plain versions' ms on the first set (CUDA events),
    and the doubling steps per scan."""
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_scan as scan

    h, w, d = shape
    n_rec = (h // 8) * (w // 8) * d
    steps = int(np.ceil(np.log2(n_rec)))
    k6 = int_name("decode_scanned", dt)

    def call(s, total, zmax):
        out = scan.scan_records(s, n_rec, dt, version, total)
        return dec.decode_scanned(s, out[1], out[5], out[2], out[3], out[4], out[6], out[7],
                                  out[8], None, mze, zmax, h, w, d, dt, True, False)

    fns = [lambda a=a: call(*a) for a in stream_sets]
    reps = 3
    kernels = ("scan_records_sizes_kernel", "scan_records_double_kernel",
               "scan_records_describe_kernel", "decode_scanned_kernel")
    rows = profiled_rows(fns, reps, kernels)
    require(rows is not None, "profiler shows no device time for the scan's kernels")
    calls = reps * len(fns)
    per = {}
    for name, match, n in ((SCAN[0], "scan_records_sizes_kernel", 1),
                           (SCAN[1], "scan_records_double_kernel", steps),
                           (SCAN[2], "scan_records_describe_kernel", 1),
                           (k6, "decode_scanned_kernel", 1)):
        us = sum(r[2] for r in rows if match in r[0])
        require(us > 0, f"profiler shows no device time for {match}")
        per[name] = us / 1e3 / (calls * n)
    s0, t0, z0 = stream_sets[0]
    j = scan.scan_records_sizes(s0, dt, version)
    rp = torch.zeros(n_rec, dtype=torch.int32, device=s0.device)
    half = 1 << (steps - 1)  # a middle doubling step: half the starts known
    out = scan.scan_records(s0, n_rec, dt, version, t0)
    plain = {
        SCAN[0]: cuda_ms([lambda: scan.scan_records_sizes_ref(s0, dt, version)], reps=1),
        SCAN[1]: cuda_ms([lambda: scan.scan_records_double_ref(j, rp, half // 2, half // 2,
                                                                True)], reps=1),
        SCAN[2]: cuda_ms([lambda: scan.scan_records_describe_ref(s0, out[0], dt, version, t0)],
                         reps=1),
        k6: cuda_ms([lambda: dec.decode_scanned_ref(
            s0, out[1], out[5], out[2], out[3], out[4], out[6], out[7], out[8], None, 2.0 * mze,
            dec._inv_i(mze), z0, h, w, d, dt)], reps=1),
    }
    return per, plain, steps


def scan_bounds(totals, shape, size, steps):
    """Least time of K5 and of K6 for this run's streams (mean over the
    tiles): the bytes each function needs, each input read once and each
    output written once, over HBM bandwidth (the operations bound is far
    below). Streams count their `total` bytes, the part a record lives in.

    K5's bound (stream in, nine [nRec] fields out) is shared out among its
    kernels by who does that part of the work: the sizes kernel reads the
    stream, the doubling steps write the record starts, the describe kernel
    writes the other eight fields. A scan's launches' bounds thus add up to
    K5's, and the jump table that the sizes and doubling kernels write and
    read counts as their excess, not as their bound."""
    h, w, d = shape
    n_rec = (h // 8) * (w // 8) * d
    s = float(np.mean(totals))
    ms = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    return {
        SCAN[0]: ms(s),                                   # the stream, read once
        SCAN[1]: ms(4 * (n_rec - 1) / steps),             # one step's share of the starts
        SCAN[2]: ms(32 * n_rec + 4),                      # 8 fields and the first start
        "K5": ms(s + 36 * n_rec),                         # the whole scan: stream in, 9 fields out
        "K6": ms(s + 16 * n_rec + 4 * d + h * w * d * size),
    }


def int_kernel_times(codec, tiles, ins):
    """Device ms per launch of one cell's K1, K2, K4 instances (profiler),
    their plain ms (CUDA events) and bounds."""
    from lerc_tpu_torch.constants import DT_SIZE
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_encode as enc

    h, w, d = tiles[0].shape
    dt, size = codec.dt, DT_SIZE[codec.dt]
    p, cw = ins[0]["p"], codec.cap // 4
    inv_i = dec._inv_i(codec.mze)
    k1, k2, k4 = (int_name(b, dt) for b in ("encode_blocks", "write_records", "decode_records"))

    def dargs(k):
        return (k["stream"], k["starts"], k["zmax"], inv_i, h, w, d, dt, codec.version, 32,
                False, None)

    fns = {
        k1: ([lambda t=t: enc.encode_blocks(t, p) for t in tiles],
             [lambda t=t: enc.encode_blocks_ref(t, p) for t in tiles],
             "encode_blocks_int_kernel"),
        k2: ([lambda t=t, k=k: enc.write_records(t, k["rec_info"], k["starts"], cw, p)
              for t, k in zip(tiles, ins)],
             [lambda t=t, k=k: enc.write_records_ref(t, k["rec_info"], k["starts"], cw, p)
              for t, k in zip(tiles, ins)], "write_records_int_kernel"),
        k4: ([lambda k=k: dec.decode_records_int(*dargs(k)) for k in ins],
             [lambda k=k: dec.decode_records_int_ref(*dargs(k)) for k in ins],
             "decode_records_int_kernel"),
    }
    n_rec, n_px = codec.n_rec, h * w * d
    bnd = {}
    for name in (k1, k2, k4):
        rows = []
        for k in ins:
            total = int(k["total"])
            mode = (k["rec_info"][:, 1] >> 8) & 3
            coded = 64 * int(((mode == 0) | (mode == 1)).sum())
            rows.append({k1: (size * n_px + 16 * n_rec + 8 * d + 4, 20 * n_px),
                         k2: (size * coded + 20 * n_rec + total, 12 * coded),
                         k4: (total + 4 * n_rec + 4 * d + size * n_px + 8, 4 * n_px)}[name])
        b = float(np.mean([r[0] for r in rows])) / HBM_BYTES_PER_S * 1e3
        o = float(np.mean([r[1] for r in rows])) / F32_OPS_PER_S * 1e3
        bnd[name] = (max(b, o), "bytes" if b >= o else "operations")
    return {name: (device_ms(kf, match), cuda_ms(rf, reps=1), *bnd[name])
            for name, (kf, rf, match) in fns.items()}

# ---------------------------------------------------------------------------
# The band codec (encode_band_device / decode_band_device): the LUT and 16x16
# instances of K1/K2, K6 with masks, edge blocks, LUT records, 16x16 blocks
# and the f32 depth-diff chain, and the host record scanner
# ---------------------------------------------------------------------------


def lut_name(base, mb, is_int):
    return base + ("_lut16" if mb == 16 else "_lut") + ("_int" if is_int else "")


def k6_name(mb, masked, dt):
    from lerc_tpu_torch.constants import DT_SUFFIX

    return "decode_scanned" + ("16" if mb == 16 else "") + ("_masked" if masked else "") \
        + DT_SUFFIX[dt]


def band_inputs(data, mask, mze, mb, version=6):
    """The LUT instances' inputs for one band at block size mb: (data as
    int32 or float32, params, validity words, dtype)."""
    from lerc_tpu_torch.constants import NUMPY_TO_DT, dt_is_int
    from lerc_tpu_torch.ops import device_encode as enc

    h, w, d = data.shape
    dt = NUMPY_TO_DT[np.dtype(str(data.dtype).removeprefix("torch."))]
    x = data.to(torch.int32 if dt_is_int(dt) else torch.float32).contiguous()
    m = torch.ones(h, w, dtype=torch.bool, device=data.device) if mask is None else \
        torch.from_numpy(mask).to(data.device)
    return x, enc.encode_params(mze, version, 0, dt, mb), enc.block_valid_words(m, mb), dt


def check_lut_kernels(data, mask, mze, mb, tag):
    """The LUT instances of K1 and K2 at block size mb against their plain
    versions on the same CUDA tensors. Returns ({kernel: max_abs_err},
    LUT records, records)."""
    from lerc_tpu_torch.constants import dt_is_int
    from lerc_tpu_torch.ops import device_encode as enc

    x, p, valid, dt = band_inputs(data, mask, mze, mb)
    k1, k2 = (lut_name(b, mb, dt_is_int(dt)) for b in ("encode_blocks", "write_records"))
    rk, zk, fk = enc.encode_blocks(x, p, valid, mb, True)
    rr, zr, fr = enc.encode_blocks_ref(x, p, valid, mb, True)
    require(torch.equal(rk, rr) and torch.equal(zk, zr) and torch.equal(fk, fr),
            f"K1 {k1} != plain ({tag})")
    length = rk[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    cap_w = (int(length.sum()) + 4096) // 4
    sk = enc.write_records(x, rk, starts, cap_w, p, valid, mb, True)
    sr = enc.write_records_ref(x, rk, starts, cap_w, p, valid, mb, True)
    require(torch.equal(sk, sr), f"K2 {k2} != plain ({tag})")
    n_lut = int(((rk[:, 1] >> 11) & 1).sum())
    return {k1: max(max_abs(rk, rr), max_abs(zk, zr)), k2: max_abs(sk, sr)}, n_lut, rk.shape[0]


def band_z_max(blob, head, pos):
    """The [D] zMax ranges of a v4+ tiling blob whose tile stream starts at
    pos (right after the one-sweep flag)."""
    from lerc_tpu_torch.constants import DT_SIZE, DT_TO_NUMPY

    size = DT_SIZE[head.dt]
    return np.frombuffer(blob, DT_TO_NUMPY[head.dt], head.n_depth,
                         pos - 1 - head.n_depth * size).astype(np.float64)


def tile_section(blob):
    """(tile stream uint8, mask, header, stream offset) of a tiling blob;
    None for a blob without a tile stream (empty, constant, one-sweep)."""
    import struct

    from lerc_tpu_torch.codec import header as hdr
    from lerc_tpu_torch.codec import rle
    from lerc_tpu_torch.codec.bitmask import bits_to_bool
    from lerc_tpu_torch.constants import DT_SIZE

    head, pos = hdr.read_header(blob)
    n_mask = struct.unpack_from("<i", blob, pos)[0]
    pos += 4
    h, w = head.n_rows, head.n_cols
    mask = np.ones((h, w), bool)
    if 0 < head.num_valid_pixel < h * w:
        mask = bits_to_bool(rle.decompress(blob[pos:pos + n_mask], (h * w + 7) // 8), w, h)
    pos += n_mask + 2 * head.n_depth * DT_SIZE[head.dt] + 1
    if head.z_min == head.z_max or pos > head.blob_size or blob[pos - 1] != 0:
        return None
    if head.try_huffman_int() or head.try_huffman_flt():
        pos += 1
    return np.frombuffer(blob[pos:head.blob_size], np.uint8), mask, head, pos


def scanned_band(blob):
    """One tiling blob's records on the card: (the host scanner's arguments,
    its descriptors, the bytes it used, K6's arguments, the header)."""
    from lerc_tpu_torch.codec import device_codec as band
    from lerc_tpu_torch.codec import header as hdr
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_encode as enc
    from lerc_tpu_torch.ops import tile_scan as ts

    stream, mask, head, pos = tile_section(blob)
    cnts, j0s, n = ts.block_scan_inputs(mask, head.micro_block_size)
    scan_args = (stream, cnts, j0s, n, head.n_depth, int(head.dt), head.version)
    recs, used = ts.tile_scan(*scan_args)
    skip = hdr.checksum_skip(head.version)
    words = band._words(torch.frombuffer(bytearray(blob[skip:head.blob_size]),
                                         dtype=torch.uint8).cuda())
    valid = None if mask.all() else enc.block_valid_words(torch.from_numpy(mask).cuda(),
                                                          head.micro_block_size)
    a = dec.scanned_args(words, pos - skip, recs, valid, head, band_z_max(blob, head, pos))
    return scan_args, recs, used, a, head


def k6_plain(a, head):
    """K6's plain version on K6's arguments `a` (``scanned_args``)."""
    from lerc_tpu_torch.ops import device_decode as dec

    return dec.decode_scanned_ref(*a[:10], 2.0 * head.max_z_error, dec._inv_i(head.max_z_error),
                                  a[11], *a[12:16], a[18])


def check_scanned_band(blob, tag):
    """The host scanner against tile_scan_ref, then K6 against its plain
    version, on one band blob's records (CUDA tensors). Returns ({kernel:
    max_abs_err}, modes)."""
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import tile_scan as ts

    if tile_section(blob) is None:
        return {}, np.zeros(0, np.int32)
    scan_args, recs, used, a, head = scanned_band(blob)
    recs_r, used_r = ts.tile_scan_ref(*scan_args)
    require(used == used_r == scan_args[0].size and recs.tobytes() == recs_r.tobytes(),
            f"host scanner != tile_scan_ref ({tag})")
    img_k, ok_k = dec.decode_scanned(*a)
    img_r, ok_r = k6_plain(a, head)
    same = torch.equal(img_k.view(torch.uint8) if img_k.dtype != torch.float32
                       else img_k.view(torch.int32),
                       img_r.view(torch.uint8) if img_r.dtype != torch.float32
                       else img_r.view(torch.int32))
    require(same and bool(ok_k) and bool(ok_r), f"K6 != plain ({tag})")
    name = k6_name(head.micro_block_size, a[9] is not None, head.dt)
    return {name: max_abs(img_k, img_r), "tile_scan": 0.0}, recs["mode"]


def float_diff_blob(tile, mask, mze):
    """A float32 depth-2 band (slice 1 = slice 0 plus a small wave, const
    and LUT-sized blocks) whose slice-1 records (const-0, const-offset,
    stuffed, LUT) are rewritten as depth-diff records (flag bit 2) with the
    checksum refixed: slice 1 then decodes as offset (+ q * invScale) +
    slice 0 (Lerc2.cpp:2026-2230), K6's exact f32 chain."""
    import struct

    from lerc_tpu_torch import encode_band_device
    from lerc_tpu_torch.codec import fletcher32
    from lerc_tpu_torch.codec import header as hdr
    from lerc_tpu_torch.ops import tile_scan as ts

    h, w = tile.shape[:2]
    s1 = tile[:, :, 0] + 0.25 * torch.sin(torch.arange(w, device=tile.device))[None, :]
    data = torch.stack([tile[:, :, 0], s1], -1).contiguous()
    data[8:16, 8:24, 1] = 5.0
    data[24:32, 0:8, :] = 0.0
    data[32:40, 16:24, 1] = torch.where(torch.arange(8, device=tile.device) % 2 == 1, 1.0, 9.0)
    blob = bytearray(encode_band_device(data, mask, mze))
    stream, m, head, base = tile_section(bytes(blob))
    cnts, j0s, n = ts.block_scan_inputs(m, 8)
    recs = ts.tile_scan(stream, cnts, j0s, n, 2, int(head.dt), head.version)[0]
    pos, flipped = 0, set()
    for r, rec in enumerate(recs):
        flag, mode = int(stream[pos]), int(rec["mode"]) % 8
        if r % 2 == 1 and mode != 0:
            blob[base + pos] = flag | 4
            flipped.add(mode)
        if mode == 2:
            pos += 1
        elif mode == 3:
            pos += 1 + {2: 1, 1: 2}.get(flag >> 6, 4)
        elif mode == 0:
            pos = int(rec["payload_pos"]) + int(cnts[r // 2]) * 4
        else:
            nbits = rec["nbits_lut"] if mode == 4 else rec["num_bits"]
            pos = int(rec["payload_pos"]) + (int(rec["num_elements"]) * int(nbits) + 7) // 8
    require(pos == stream.size and {1, 2, 3} <= flipped, "float diff blob: records not rewritten")
    skip = hdr.checksum_skip(head.version)
    struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:head.blob_size])))
    return bytes(blob)


def class_grid(dem):
    """The DEM binned into 12 elevation zones coded 5000*k + 100, uint16 (a
    classified raster stored at 16 bits)."""
    lo, hi = float(dem.min()), float(dem.max())
    k = torch.clamp(((dem - lo) / (hi - lo) * 12).floor(), 0, 11)
    return (5000 * k + 100).to(torch.int32).to(torch.uint16).contiguous()


def int16_three_band(dem):
    """The DEM in whole metres, +4 and -6, each with 0..2 levels of its hash
    noise (as the uint8 cell, at 16 bits): depth-diff records."""
    r = torch.round(dem[:, :, 0])
    frac = dem[:, :, 0] - torch.floor(dem[:, :, 0])
    n1, n2 = torch.floor(frac * 3), torch.floor((frac * 7) % 1 * 3)
    return torch.stack([r, r + 4 + n1, r - 6 + n2], -1).to(torch.int16).contiguous()


def run_counted_band(required, optional, label, fn):
    """run_counted for a band path: every kernel of `required` launched, the
    ones of `optional` (the 16x16 retrial, where its gate opens) allowed, no
    other. Returns (counts, fn's result)."""
    from lerc_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: n for k, n in build.LAUNCHES.items() if n}
    for name in required:
        require(counts.get(name, 0) > 0, f"kernel {name} was not launched on the {label}")
    extra = sorted(set(counts) - set(required) - set(optional))
    require(not extra, f"kernels {extra} were launched on the {label}")
    return counts, out


def band_cell(label, tiles, mask, mze, required, optional, card, n_plain=1, lossless=False):
    """One band cell: encode_band_device -> bytes -> decode_band_device on
    each tile, counted; the first n_plain blobs byte-equal to the plain
    path's (device="cpu"); decode within 1.1 * maxZError (exact when
    lossless), invalid pixels 0, the mask round-trips. Returns (counts,
    blobs, encode ms, decode ms per round of the tiles, raw MB)."""
    from lerc_tpu_torch import decode_band_device, encode_band_device

    def path():
        blobs = [encode_band_device(t, mask, mze) for t in tiles]
        return blobs, [decode_band_device(b) for b in blobs]

    counts, (blobs, decs) = run_counted_band(required, optional, label, path)
    sel = None if mask is None else torch.from_numpy(mask).cuda()
    for i, (t, b, dband) in enumerate(zip(tiles, blobs, decs)):
        err = (dband.data.to(torch.float64) - t.to(torch.float64)).abs()
        if sel is not None:
            require(np.array_equal(dband.mask, mask), f"{label}: mask of tile {i} differs")
            require(not dband.data.view(torch.uint8).reshape(*t.shape[:2], -1)[~sel].any(),
                    f"{label}: invalid pixels of tile {i} are not 0")
            err = err[sel]
        limit = 0.0 if lossless else dband.hd.max_z_error * 1.1
        require(float(err.max()) <= limit, f"{label}: error bound violated on tile {i}")
        if i < n_plain:
            require(encode_band_device(t.cpu(), mask, mze, device="cpu") == b,
                    f"{label}: blob of tile {i} differs from the plain path's")
    raw_mb = len(tiles) * tiles[0].numel() * tiles[0].element_size() / 1e6

    def timed(fn):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    enc_ms = timed(lambda: [encode_band_device(t, mask, mze) for t in tiles])
    dec_ms = timed(lambda: [decode_band_device(b) for b in blobs])
    ratio = raw_mb * 1e6 / sum(len(b) for b in blobs)
    print(f"band cell {label}: {len(tiles)} tiles ok, micro blocks {decs[0].hd.micro_block_size}, "
          f"launches {counts}; encode {raw_mb / (enc_ms / 1e3):.1f} MB/s ({enc_ms:.3f} ms), "
          f"decode {raw_mb / (dec_ms / 1e3):.1f} MB/s ({dec_ms:.3f} ms), compression ratio "
          f"{ratio:.4f} [{card}]", flush=True)
    return counts, blobs, enc_ms, dec_ms, raw_mb


def lut_kernel_times(data, mask, mze, mb, is_int):
    """Device ms per launch of one LUT instance pair of K1/K2 at block size
    mb (profiler), their plain ms (CUDA events) and bounds, on one band."""
    from lerc_tpu_torch.constants import DT_SIZE
    from lerc_tpu_torch.ops import device_encode as enc

    x, p, valid, dt = band_inputs(data, mask, mze, mb)
    k1, k2 = (lut_name(b, mb, is_int) for b in ("encode_blocks", "write_records"))
    rk, _, _ = enc.encode_blocks(x, p, valid, mb, True)
    length = rk[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    total = int(length.sum())
    cap_w = (total + 4096) // 4
    h, w, d = x.shape
    bs = mb * mb
    n_rec, size = rk.shape[0], DT_SIZE[dt]
    n_val = int(enc.valid_lanes(valid).sum()) * d
    mode = (rk[:, 1] >> 8) & 3
    n_lut_rec = int(((rk[:, 1] >> 11) & 1).sum())
    coded = int((((mode == 0) | (mode == 1)).sum()) * bs)
    v_bytes = valid.numel() * 4
    s = int(np.log2(bs))
    sort_ops = (bs // 2) * s * (s + 1) // 2 * 2  # bitonic compare-exchanges, min + max
    k1_b = size * n_val + v_bytes + 16 * n_rec + 8 * d + 4
    k1_o = 20 * n_val + n_rec * sort_ops * (2 if (p.diff_ok and d > 1) else 1)
    k2_b = size * coded + v_bytes + 20 * n_rec + total
    k2_o = 12 * coded + n_lut_rec * sort_ops
    rows = {}
    for name, kf, rf, b, o, match in (
            (k1, lambda: enc.encode_blocks(x, p, valid, mb, True),
             lambda: enc.encode_blocks_ref(x, p, valid, mb, True), k1_b, k1_o,
             "encode_blocks_lut_kernel"),
            (k2, lambda: enc.write_records(x, rk, starts, cap_w, p, valid, mb, True),
             lambda: enc.write_records_ref(x, rk, starts, cap_w, p, valid, mb, True), k2_b, k2_o,
             "write_records_lut_kernel")):
        bms, oms = b / HBM_BYTES_PER_S * 1e3, o / F32_OPS_PER_S * 1e3
        rows[name] = (device_ms([kf], match), cuda_ms([rf], reps=1), max(bms, oms),
                      "bytes" if bms >= oms else "operations")
    return rows, n_lut_rec, n_rec


def k6_times(blob):
    """Device ms per launch of K6 (profiler) on one band blob's records,
    its plain ms (CUDA events) and its bound; the scanner's ms and plain
    ms."""
    from lerc_tpu_torch.constants import DT_SIZE
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import tile_scan as ts

    scan_args, recs, _used, a, head = scanned_band(blob)
    stream, valid = scan_args[0], a[9]
    ms = device_ms([lambda: dec.decode_scanned(*a)], "decode_scanned_kernel")
    plain = cuda_ms([lambda: k6_plain(a, head)], reps=1)
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    n_rec = recs.size
    bound = (stream.size + 32 * n_rec + (0 if valid is None else valid.numel() * 4) + 4 * d
             + h * w * d * DT_SIZE[head.dt]) / HBM_BYTES_PER_S * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        ts.tile_scan(*scan_args)
    scan_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    ts.tile_scan_ref(*scan_args)
    scan_plain = (time.perf_counter() - t0) * 1e3
    scan_bound = (stream.size + 40 * n_rec + 8 * scan_args[3]) / HBM_BYTES_PER_S * 1e3
    return (ms, plain, bound), (scan_ms, scan_plain, scan_bound), n_rec


def band_phases(tiles, mask, card, launches, add_row, rows_done):
    """Phases 7-13: the band codec's kernel checks, its five cells (float32
    all-valid and masked, the edge crop, the uint16 class grid, the int16
    three-band image), the masked index-free resident decode, and their
    times. add_row adds a kernel's record unless its name is in
    rows_done."""
    from lerc_tpu_torch import ResidentCodec, decode_band_device, encode_band_device
    from lerc_tpu_torch.codec import lerc2_encode
    from lerc_tpu_torch.constants import DataType

    dev = tiles[0].device
    err = {}

    def merge(e):
        for k, x in e.items():
            err[k] = max(err.get(k, 0.0), x)

    # ---- 7. the new instances against their plain versions
    cls_tile = class_grid(tiles[0])
    i16_tile = int16_three_band(tiles[0])
    small = [("64x64", (slice(0, 64), slice(0, 64))), ("61x47", (slice(3, 64), slice(5, 52))),
             ("130x77", (slice(100, 230), slice(450, 527)))]
    mask_full = mask
    for name, crop in small:
        for t, mze, kind in ((tiles[0], MAX_Z_ERROR, "float32"), (cls_tile, 0.5, "uint16 classes"),
                             (i16_tile, 0.5, "int16 x 3")):
            for m in (None, mask_full[crop]):
                data = t[crop].contiguous()
                for mb in (8, 16):
                    e, n_lut, n_rec = check_lut_kernels(data, m, mze, mb, f"{name} {kind}")
                    merge(e)
                blob = encode_band_device(data, m, mze)
                e, modes = check_scanned_band(blob, f"{name} {kind}")
                merge(e)
        print(f"check: K1/K2 LUT instances (8x8, 16x16) and K6 equal to their plain versions on "
              f"the {name} crops (float32, uint16 classes, int16 x 3; all-valid and masked)",
              flush=True)
    # blocks of 30 and 31 bits: a non-LUT record's LUT fields lie past its
    # payload there (the plain K2 once wrote them out of bounds)
    from lerc_tpu_torch.ops import device_encode as enc

    rng = np.random.default_rng(2)
    for data, mze, kind in (
            (rng.normal(0, 40, (24, 24, 1)).astype(np.float32), 1e-7, "float32"),
            (rng.integers(0, 2**30, (24, 19, 1)).astype(np.int32), 0.5, "int32")):
        data = torch.from_numpy(data).to(dev)
        x, p, valid, _ = band_inputs(data, None, mze, 8)
        nb_max = int(((enc.encode_blocks(x, p, valid, 8, True)[0][:, 1] >> 16) & 0xFF).max())
        require(nb_max >= 30, f"the {kind} wide-block band has no block of 30 bits or more")
        e, _, _ = check_lut_kernels(data, None, mze, 8, f"{kind} {nb_max}-bit blocks")
        merge(e)
        print(f"check: {', '.join(sorted(e))} equal to their plain versions on a "
              f"{data.shape[0]}x{data.shape[1]} {kind} band of {nb_max}-bit blocks", flush=True)
    diff_blob = float_diff_blob(tiles[0][:64, :64].contiguous(), mask_full[:64, :64], 0.01)
    e, modes = check_scanned_band(diff_blob, "hand-built float depth-diff")
    merge(e)
    require((modes >= 8).sum() > 10, "the float diff blob has no diff records")
    dref = decode_band_device(diff_blob, device="cpu").data
    require(torch.equal(decode_band_device(diff_blob).data.cpu().view(torch.int32),
                        dref.view(torch.int32)), "float diff blob: decode != plain decode")
    print(f"check: K6 equal to its plain version on the hand-built float depth-diff blob "
          f"({int((modes >= 8).sum())} diff records)", flush=True)
    for t, mze, kind, mb in ((tiles[0], MAX_Z_ERROR, "float32", 8), (cls_tile, 0.5, "uint16", 8),
                             (cls_tile, 0.5, "uint16", 16)):
        e, n_lut, n_rec = check_lut_kernels(t, None, mze, mb, f"{TILE}^2 {kind}")
        merge(e)
        print(f"check: {', '.join(sorted(e))} equal to their plain versions on the {TILE}^2 "
              f"{kind} tile ({n_lut} LUT records of {n_rec})", flush=True)
    blob0 = encode_band_device(tiles[0], None, MAX_Z_ERROR)
    e, _ = check_scanned_band(blob0, f"{TILE}^2 float32")
    merge(e)
    print(f"check: the host scanner equals tile_scan_ref, K6 its plain version, on the {TILE}^2 "
          f"float32 band", flush=True)

    # ---- 8-11. the band cells, counted then timed
    core = ("fletcher32_parts", "tile_scan")
    f_lut = (lut_name("encode_blocks", 8, False), lut_name("write_records", 8, False))
    f_16 = (lut_name("encode_blocks", 16, False), lut_name("write_records", 16, False))
    i_lut = (lut_name("encode_blocks", 8, True), lut_name("write_records", 8, True))
    i_16 = (lut_name("encode_blocks", 16, True), lut_name("write_records", 16, True))
    cells = []
    cells.append(("float32 DEM", band_cell(
        f"float32 DEM {N_TILES} x {TILE}^2, maxZError 0.001", tiles, None, MAX_Z_ERROR,
        (*f_lut, *core, "decode_scanned"), (*f_16, "decode_scanned16"), card, n_plain=2)))
    cells.append(("float32 DEM, bench mask", band_cell(
        f"float32 DEM {N_TILES} x {TILE}^2 with the bench mask, maxZError 0.001", tiles, mask, MAX_Z_ERROR,
        (*f_lut, *core, "decode_scanned_masked"), (*f_16, "decode_scanned16_masked"), card,
        n_plain=2)))
    crop = (slice(0, TILE - 1), slice(0, TILE - 49))  # 2047 x 1999
    edge_mask = np.ascontiguousarray(mask[crop])
    cells.append(("float32 edge crop", band_cell(
        f"float32 {TILE - 1}x{TILE - 49} crop with the bench mask's crop",
        [tiles[0][crop].contiguous()],
        edge_mask, MAX_Z_ERROR, (*f_lut, *core, "decode_scanned_masked"),
        (*f_16, "decode_scanned16_masked"), card)))
    for (label, c), size in zip(cells[1:3], (f"{TILE}^2", f"{TILE - 1}x{TILE - 49}")):
        e, _ = check_scanned_band(c[1][0], f"{label}, tile 0")
        merge(e)
        print(f"check: the host scanner equals tile_scan_ref, K6 "
              f"{', '.join(k for k in sorted(e) if k != 'tile_scan')} its plain version, on the "
              f"{size} {label} blob of the cell", flush=True)
    cls_counts = band_cell(f"uint16 class grid {TILE}^2, maxZError 0.5", [cls_tile], None, 0.5,
                           (*i_lut, *i_16, *core, "decode_scanned16_u16"), (), card,
                           lossless=True)
    cells.append(("uint16 class grid", cls_counts))
    cls_blob = cls_counts[1][0]
    _, cls_modes = check_scanned_band(cls_blob, "class grid")
    from lerc_tpu_torch.codec import header as hdr

    require(hdr.read_header(cls_blob)[0].micro_block_size == 16,
            "class grid: the 16x16 retrial was not taken")
    n_lut_cls = int((cls_modes % 8 == 4).sum())
    require(n_lut_cls > 0, "class grid: no LUT record")
    print(f"band cell uint16 class grid: 16x16 blocks, {n_lut_cls} LUT records of "
          f"{cls_modes.size}", flush=True)
    i16_cell = band_cell(f"int16 three-band {TILE}^2, lossless v6", [i16_tile], None, 0.5,
                         (*i_lut, *core, "decode_scanned_i16"), (*i_16, "decode_scanned16_i16"),
                         card, lossless=True)
    cells.append(("int16 three-band", i16_cell))
    _, i16_modes = check_scanned_band(i16_cell[1][0], "int16 three-band")
    n_diff, n_lut_diff = int((i16_modes >= 8).sum()), int((i16_modes == 12).sum())
    require(n_diff > 0, "int16 three-band: no depth-diff record")
    print(f"band cell int16 three-band: {n_diff} depth-diff records ({n_lut_diff} of them LUT) "
          f"of {i16_modes.size}", flush=True)
    for _label, c in cells:
        for k, n in c[0].items():
            launches[k] = launches.get(k, 0) + n

    # ---- 12. the masked index-free resident decode
    rcodec = ResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR, mask=mask)
    rblobs = [rcodec.encode(t) for t in tiles]
    indexed = [rcodec.decode(b) for b in rblobs]
    for b in rblobs:
        b.starts = None
    counts, free = run_counted_band(("tile_scan", "fletcher32_parts", "decode_scanned_masked"),
                                    (), "masked index-free resident decode",
                                    lambda: [rcodec.decode(b) for b in rblobs])
    for i, (a, b) in enumerate(zip(free, indexed)):
        require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                f"masked index-free decode of tile {i} differs from the indexed decode")
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    free_ms = best_ms(lambda: [rcodec.decode(b) for b in rblobs], rounds=3)
    print(f"masked index-free resident decode: 4 tiles bit-equal to the indexed decode, "
          f"launches {counts}, {N_TILES * TILE * TILE * 4 / 1e6 / (free_ms / 1e3):.1f} MB/s "
          f"({free_ms:.3f} ms) [{card}]", flush=True)

    # ---- 13. times
    m_t = torch.ones(TILE, TILE, dtype=torch.bool, device=dev)

    def host_ms(fn, reps=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    ana_ms = host_ms(lambda: lerc2_encode.try_raise_max_z_error(tiles[0], m_t, MAX_Z_ERROR))
    bp_ms = host_ms(lambda: lerc2_encode.try_bit_plane_compression(
        i16_tile, m_t, DataType.SHORT, 3, TILE * TILE, 0.01), reps=1)
    blob_t = torch.frombuffer(bytearray(blob0), dtype=torch.uint8)
    h2d = host_ms(lambda: blob_t.to(dev))
    dev_blob = blob_t.to(dev)
    d2h = host_ms(lambda: dev_blob.cpu())
    from lerc_tpu_torch.codec import rle
    from lerc_tpu_torch.codec.bitmask import bits_to_bool, bool_to_bits

    packed = rle.compress(bool_to_bits(mask))
    # best of 3, as the band cells' times it is set against
    rle_enc = min(host_ms(lambda: rle.compress(bool_to_bits(mask)), reps=1) for _ in range(3))
    rle_dec = min(host_ms(lambda: bits_to_bool(rle.decompress(packed, (TILE * TILE + 7) // 8),
                                               TILE, TILE), reps=1) for _ in range(3))
    more_enc, more_dec = ((cells[1][1][i] - cells[0][1][i]) / N_TILES for i in (2, 3))
    print(f"mask section of the bench mask ({len(packed)} B of RLE), host: bits + RLE compress "
          f"{rle_enc:.3f} ms, RLE decompress + bits {rle_dec:.3f} ms per {TILE}^2 band; the "
          f"masked float32 band cell over the all-valid one, per tile: encode +{more_enc:.3f} ms, "
          f"decode +{more_dec:.3f} ms [{card}]", flush=True)
    print(f"band analyses: maxZError auto-raise {ana_ms:.3f} ms per 2048^2 float32 tile, "
          f"bit-plane cut {bp_ms:.3f} ms per 2048^2 x 3 int16 tile (off the cells' path); copies "
          f"of a {len(blob0)} B blob: host to device {h2d:.3f} ms, device to host {d2h:.3f} ms "
          f"[{card}]", flush=True)
    rows = {}
    for t, m, mze, mb, is_int in ((tiles[0], None, MAX_Z_ERROR, 8, False),
                                  (tiles[0], None, MAX_Z_ERROR, 16, False),
                                  (cls_tile, None, 0.5, 8, True), (cls_tile, None, 0.5, 16, True)):
        r, _n_lut, _n = lut_kernel_times(t, m, mze, mb, is_int)
        rows.update(r)
    for name, (ms, plain_ms, bound_ms, bound_by) in rows.items():
        add_row(name, err.get(name, 0.0), ms, plain_ms, bound_ms, bound_by)
    scan_rows = {}
    for label, blob in (("float32 all-valid", blob0), ("float32 masked", cells[1][1][1][0]),
                        ("uint16 class grid, 16x16", cls_blob),
                        ("int16 three-band", i16_cell[1][0])):
        (ms, plain_ms, bound_ms), (scan_ms, scan_plain, scan_bound), n_rec = k6_times(blob)
        _, mask_b, head, _ = tile_section(blob)
        name = k6_name(head.micro_block_size, not mask_b.all(), head.dt)
        print(f"band K6 {name} ({label}): {ms:.4f} ms/launch; host scanner {scan_ms:.3f} ms per "
              f"tile ({n_rec} records) [{card}]", flush=True)
        if name not in rows_done:
            add_row(name, err.get(name, 0.0), ms, plain_ms, bound_ms, "bytes")
        scan_rows[label] = (scan_ms, scan_plain, scan_bound)
    add_row("tile_scan", 0.0, *scan_rows["float32 all-valid"], "bytes")

    # ---- where the time goes in a band round
    where_the_time_goes(
        None, tiles, cells[0][1][2] + cells[0][1][3], card,
        "float32 band cell, encode_band_device + decode_band_device",
        round_fn=lambda: [decode_band_device(encode_band_device(t, None, MAX_Z_ERROR))
                          for t in tiles])
    where_the_time_goes(
        None, [cls_tile], cls_counts[2] + cls_counts[3], card,
        "uint16 class grid cell, encode_band_device + decode_band_device",
        round_fn=lambda: [decode_band_device(encode_band_device(cls_tile, None, 0.5))])



# ---------------------------------------------------------------------------
# 8-bit whole-image Huffman through the band codec: H1 symbols and
# histograms, H2 group pack, H3 group-parallel decode, H4 image restore, and
# the host lengths-only scan of foreign blobs
# ---------------------------------------------------------------------------

FLAG_CODES = (0, 1, 2, 4, 8, 16, 64, 128)  # clear, cloud, shadow, snow, water, haze, fill, saturated
FLAG_CUM = (0.55, 0.75, 0.85, 0.91, 0.95, 0.975, 0.99)  # their cumulative frequencies


def quality_flags(n, tile, device):
    """uint8 quality-flag bands, [tile, tile, 1] each: the bench's integer
    hash of each pixel (bench.py:91-117, another seed) picks one of 8 codes
    with skewed frequencies, 55% down to 1%, as a cloud or QA mask band
    holds them: no spatial order, so the direct Huffman mode's data."""
    m32 = 0xFFFFFFFF
    cum = torch.tensor(FLAG_CUM, dtype=torch.float64, device=device)
    codes = torch.tensor(FLAG_CODES, dtype=torch.uint8, device=device)
    out = []
    for seed in range(n):
        i = (torch.arange(tile * tile, dtype=torch.int64, device=device).reshape(tile, tile)
             + ((seed * 0x9E3779B9 + 0x51ED27) & m32)) & m32
        i = ((i ^ (i >> 16)) * 0x45D9F3B) & m32
        i = ((i ^ (i >> 16)) * 0x45D9F3B) & m32
        i = i ^ (i >> 16)
        k = torch.searchsorted(cum, i.to(torch.float64) * 2.0**-32, right=True)
        out.append(codes[k][:, :, None].contiguous())
    return out


def stripes_mask(h, w):
    """Every other column valid: each valid pixel below row 0 deltas against
    the pixel above (the masked un-delta's worst case for segments)."""
    m = np.ones((h, w), bool)
    m[:, ::2] = False
    return m


def restore_name(masked, delta):
    return "huffman_restore" + ("_delta" if delta else "") + ("_masked" if masked else "")


def huffman_check(data, mask, tag, scan_ref=True):
    """H1-H4 against their plain versions on one 8-bit band (CUDA tensors):
    H1's streams and histograms, then in each mode H2's words, total bits
    and sidecar, H3's symbols, used bits and ok, H4's image (equal to the
    input at the valid pixels), and the host scan (against its plain version
    with scan_ref) equal to H2's sidecar. Returns {kernel: max_abs_err}."""
    from lerc_tpu_torch.codec import huffman
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_huffman as dh
    from lerc_tpu_torch.ops import huffman_scan as hs

    h, w, d = data.shape
    dt = DataType.CHAR if data.dtype == torch.int8 else DataType.BYTE
    x = data.to(torch.int32).contiguous()
    m = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask)).cuda()
    k1 = dh.symbol_streams_device(x, m, dt)
    r1 = dh.symbol_streams_device_ref(x, m, dt)
    require(all(torch.equal(a, b) for a, b in zip(k1, r1)), f"H1 != plain ({tag})")
    err = {"huffman_symbols" + ("" if m is None else "_masked"): 0.0}
    nv = None if mask is None else int(mask.sum())
    sel = torch.ones(h, w, dtype=torch.bool, device=x.device) if m is None else m
    hist = k1[2].cpu().numpy().astype(np.int64)
    for delta in (False, True):
        how = f"{tag}, {'delta' if delta else 'direct'}"
        lengths = huffman.compute_code_lengths(hist[int(delta)])
        if lengths is None:  # one symbol: no code, the encoder takes another mode
            continue
        codes = huffman.canonical_codes(lengths)
        table = dh.code_table(lengths, codes, x.device)
        layout = dh.live_layout(h * w, d, nv, delta)
        total = int((hist[int(delta)] * lengths).sum())
        n_words = -(-total // 32) + 1
        sym = k1[1] if delta else k1[0]
        wk, tk, sk = dh.encode_stream_device(sym, table, layout, n_words)
        wr, tr, sr = dh.encode_stream_device_ref(sym, table, layout, n_words)
        require(torch.equal(wk, wr) and int(tk) == int(tr) == total and torch.equal(sk, sr),
                f"H2 != plain ({how})")
        consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
        args = (torch.cat([wk, wk.new_zeros(1)]), 32 * n_words, sk, torch.from_numpy(consts).cuda(),
                torch.from_numpy(sorted_syms).cuda(), layout)
        sk3, uk, ok_k = dh.decode_stream_device(*args)
        sr3, ur, ok_r = dh.decode_stream_device_ref(*args)
        require(torch.equal(sk3, sr3) and torch.equal(uk, ur) and bool(ok_k) and bool(ok_r),
                f"H3 != plain ({how})")
        if m is None:
            ik = dh.symbols_to_image(sk3, h, w, d, dt, delta)
            ir = dh.symbols_to_image_ref(sk3, h, w, d, dt, delta)
        elif delta:
            ik, ir = dh.undelta_masked_device(sk3, m, d, dt), dh.undelta_masked_device_ref(sk3, m, d, dt)
        else:
            ik = dh.expand_compacted_device(sk3, m, d, dt)
            ir = dh.expand_compacted_device_ref(sk3, m, d, dt)
        require(torch.equal(ik, ir) and torch.equal(ik[sel], data[sel])
                and not ik.view(torch.uint8)[~sel].any(), f"H4 != plain or input ({how})")
        stream = wk.cpu().numpy().view(np.uint8)
        counts = dh.live_counts(sk.numel(), layout)
        offs = hs.huffman_group_offsets(stream, lengths, codes, counts)
        require(np.array_equal(offs, sk.cpu().numpy()), f"host scan != H2's sidecar ({how})")
        if scan_ref:
            require(np.array_equal(hs.huffman_group_offsets_ref(stream, lengths, codes, counts),
                                   offs), f"host scan != plain ({how})")
        err.update(dict.fromkeys(("huffman_group_bits", "huffman_pack", "huffman_decode",
                                  "huffman_scan", restore_name(m is not None, delta)), 0.0))
        if m is None and delta:
            err["huffman_restore_col0"] = 0.0
    return err  # every comparison above is exact


def tiling_bytes(t, mask):
    """The 8x8 tiling candidate's payload bytes of a lossless 8-bit band
    (what the Huffman blob beat)."""
    from lerc_tpu_torch.codec.device_codec import _round_cap
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_encode as enc

    h, w, d = t.shape
    nv = h * w if mask is None else int(mask.sum())
    valid = None if mask is None else enc.block_valid_words(torch.from_numpy(mask).cuda(), 8)
    cap = _round_cap(nv * d + (-(-h // 8)) * (-(-w // 8)) * d * 12 + 4096)
    dt = DataType.CHAR if t.dtype == torch.int8 else DataType.BYTE
    return int(enc.encode_tiles(t.to(torch.int32).contiguous(), valid, 0.5, h, w, d, dt,
                                mask is None, 6, cap, enable_lut=True)[1])


def huffman_cell(label, tiles, mask, mode, card):
    """One Huffman band cell, lossless v6: encode_band_device(...,
    return_index=True) -> decode_band_device with the index and without it
    (the host scan), counted; the image-mode byte asserted; tile 0's blob
    byte-equal to the plain path's (device="cpu"); every decode equal to the
    input at the valid pixels, 0 elsewhere. Returns (counts, blobs, indexes,
    times)."""
    from lerc_tpu_torch import decode_band_device, encode_band_device
    from lerc_tpu_torch.codec.device_codec import huffman_section
    from lerc_tpu_torch.ops import device_huffman as dh
    from lerc_tpu_torch.ops import huffman_scan as hs

    masked = mask is not None
    required = ("encode_blocks_lut_int", "write_records_lut_int", "fletcher32_parts",
                "huffman_symbols" + ("_masked" if masked else ""), "huffman_group_bits",
                "huffman_pack", "huffman_decode", "huffman_scan")
    required += ((restore_name(masked, True),) if mode == 1 else (restore_name(masked, False),))
    if mode == 1 and not masked:
        required += ("huffman_restore_col0",)
    optional = ("encode_blocks_lut16_int", "write_records_lut16_int")

    def path():
        enc = [encode_band_device(t, mask, 0.5, return_index=True) for t in tiles]
        return enc, [decode_band_device(b, index=i) for b, i in enc], \
            [decode_band_device(b) for b, _ in enc]

    counts, (enc, decs, frees) = run_counted_band(required, optional, label, path)
    sel = None if mask is None else torch.from_numpy(mask).cuda()
    for i, (t, (b, idx), a, f) in enumerate(zip(tiles, enc, decs, frees)):
        sec = huffman_section(b)
        require(sec.mode == mode, f"{label}: tile {i} took image mode {sec.mode}, not {mode}")
        require(idx is not None and idx["huffman_sbits"].shape == (sec.n_groups,),
                f"{label}: tile {i} has no Huffman index")
        for what, dband in (("with the index", a), ("without the index", f)):
            got = dband.data
            if sel is not None:
                require(np.array_equal(dband.mask, mask), f"{label}: mask of tile {i} differs")
                require(not got.view(torch.uint8)[~sel].any(),
                        f"{label}: invalid pixels of tile {i} are not 0")
                got, want = got[sel], t[sel]
            else:
                want = t
            require(torch.equal(got, want), f"{label}: tile {i} decoded {what} != input")
    require(encode_band_device(tiles[0].cpu(), mask, 0.5, device="cpu") == enc[0][0],
            f"{label}: blob of tile 0 differs from the plain path's")
    raw_mb = len(tiles) * tiles[0].numel() / 1e6
    blobs = [b for b, _ in enc]

    def timed(fn):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    enc_ms = timed(lambda: [encode_band_device(t, mask, 0.5, return_index=True) for t in tiles])
    dec_ms = timed(lambda: [decode_band_device(b, index=i) for b, i in enc])
    free_ms = timed(lambda: [decode_band_device(b) for b in blobs])
    secs = [huffman_section(b) for b in blobs]
    scan_ms = timed(lambda: [hs.huffman_group_offsets(s.stream, s.lengths, s.codes,
                                                      dh.live_counts(s.n_groups, s.layout))
                             for s in secs]) / len(tiles)
    ratio = raw_mb * 1e6 / sum(len(b) for b in blobs)
    tiling = tiling_bytes(tiles[0], mask)
    print(f"huffman cell {label}: {len(tiles)} tiles ok, image mode {mode} "
          f"({'delta' if mode == 1 else 'direct'} Huffman), blob 0 equal to the plain path's, "
          f"launches {counts}; encode {raw_mb / (enc_ms / 1e3):.1f} MB/s ({enc_ms:.3f} ms), "
          f"decode {raw_mb / (dec_ms / 1e3):.1f} MB/s with the index ({dec_ms:.3f} ms), "
          f"{raw_mb / (free_ms / 1e3):.1f} MB/s without ({free_ms:.3f} ms; host scan "
          f"{scan_ms:.3f} ms per tile), compression ratio {ratio:.4f}; tile 0: Huffman blob "
          f"{len(blobs[0])} B, the tiling candidate's payload {tiling} B [{card}]", flush=True)
    return counts, blobs, [i for _, i in enc], (enc_ms, dec_ms, free_ms, scan_ms)


def huffman_kernel_times(u8x3, mask, flags, card):
    """Device ms per launch of H1-H4 (torch.profiler) at 2048^2 x 3 (the
    uint8 three-band tile; the direct restores on the flag band), their
    plain ms (CUDA events), bounds (bytes, each input read once and each
    output written once, over the HBM rate) and, beside H1 and H4, the one
    PyTorch call that computes the same function. The masked H1 and masked
    direct H4 rows time the whole wrapper (the kernel and its rank-chunk
    glue); the kernel alone is printed beside them. Returns {kernel: (ms,
    plain ms, bound ms, library ms or None)}."""
    from lerc_tpu_torch.codec import huffman
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_huffman as dh

    rows = {}
    m = torch.from_numpy(mask).cuda()
    nv = int(mask.sum())
    mb = HBM_BYTES_PER_S / 1e3  # bytes per ms

    def add(name, kf, rf, n_bytes, match, lib=None, alone=None):
        rows[name] = (device_ms([kf], match), cuda_ms([rf], reps=1), n_bytes / mb,
                      None if lib is None else device_ms([lib]))
        if alone is not None:
            print(f"{name}: {rows[name][0]:.4f} ms per call with its rank-chunk glue, the kernel "
                  f"alone {device_ms([kf], alone):.4f} ms [{card}]", flush=True)

    for data, mk, delta in ((u8x3, None, True), (u8x3, m, True), (flags, None, False),
                            (flags, m, False)):
        h, w, d = data.shape
        n, npx = h * w * d, h * w
        x = data.to(torch.int32).contiguous()
        direct, dl, hist = dh.symbol_streams_device(x, mk, DataType.BYTE)
        h1 = "huffman_symbols" + ("" if mk is None else "_masked")
        if h1 not in rows:
            live = n if mk is None else nv * d
            kern = "huffman_symbols_kernel"
            add(h1, lambda x=x, mk=mk: dh.symbol_streams_device(x, mk, DataType.BYTE),
                lambda x=x, mk=mk: dh.symbol_streams_device_ref(x, mk, DataType.BYTE),
                4 * live + (0 if mk is None else npx) + 2 * live + 2048,
                kern if mk is None else None,
                lib=lambda s=direct[:n]: torch.bincount(s, minlength=256),
                alone=None if mk is None else kern)
        hst = hist[int(delta)].cpu().numpy().astype(np.int64)
        lengths = huffman.compute_code_lengths(hst)
        codes = huffman.canonical_codes(lengths)
        table = dh.code_table(lengths, codes, x.device)
        layout = dh.live_layout(npx, d, None if mk is None else nv, delta)
        total = int((hst * lengths).sum())
        n_words = -(-total // 32) + 1
        sym = dl if delta else direct
        g = sym.numel() // dh.GROUP
        words, _tb, sbits = dh.encode_stream_device(sym, table, layout, n_words)
        live = layout[2] * (n // layout[1])
        if mk is None and delta:  # H2 and H3 at their main-path shape
            add("huffman_group_bits", lambda: dh.encode_stream_device(sym, table, layout, n_words),
                lambda: dh.encode_stream_device_ref(sym, table, layout, n_words),
                n + 2048 + 4 * g, "huffman_group_bits_kernel")
            add("huffman_pack", lambda: dh.encode_stream_device(sym, table, layout, n_words),
                lambda: dh.encode_stream_device_ref(sym, table, layout, n_words),
                n + 4 * g + total / 8 + 2048, "huffman_pack_kernel")
        consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
        args = (torch.cat([words, words.new_zeros(1)]), 32 * n_words, sbits,
                torch.from_numpy(consts).cuda(), torch.from_numpy(sorted_syms).cuda(), layout)
        if mk is None and delta:
            add("huffman_decode", lambda: dh.decode_stream_device(*args),
                lambda: dh.decode_stream_device_ref(*args),
                total / 8 + 8 * g + n, "huffman_decode_kernel")
        syms = dh.decode_stream_device(*args)[0]
        name = restore_name(mk is not None, delta)
        if mk is None and delta:
            add("huffman_restore_col0", lambda: dh.symbols_to_image(syms, h, w, d, DataType.BYTE, True),
                lambda: dh.symbols_to_image_ref(syms, h, w, d, DataType.BYTE, True),
                2 * d * h, "huffman_restore_col0_kernel",
                lib=lambda s=syms[:n].view(d, h, w)[:, :, 0]: torch.cumsum(s, 1, dtype=torch.uint8))
            add(name, lambda: dh.symbols_to_image(syms, h, w, d, DataType.BYTE, True),
                lambda: dh.symbols_to_image_ref(syms, h, w, d, DataType.BYTE, True),
                2 * n + d * h, "huffman_restore_delta_kernel",
                lib=lambda s=syms[:n].view(d, h, w): torch.cumsum(s, 2, dtype=torch.uint8))
        elif mk is None:
            add(name, lambda: dh.symbols_to_image(syms, h, w, d, DataType.BYTE, False),
                lambda: dh.symbols_to_image_ref(syms, h, w, d, DataType.BYTE, False),
                2 * n, "huffman_restore_kernel",
                lib=lambda s=syms[:n]: torch.sub(s, 0))  # uint8: offset 0, wraps mod 256
        elif delta:
            add(name, lambda: dh.undelta_masked_device(syms, mk, d, DataType.BYTE),
                lambda: dh.undelta_masked_device_ref(syms, mk, d, DataType.BYTE),
                live + npx + n, "huffman_restore_delta_masked_kernel")
        else:
            add(name, lambda: dh.expand_compacted_device(syms, mk, d, DataType.BYTE),
                lambda: dh.expand_compacted_device_ref(syms, mk, d, DataType.BYTE),
                live + npx + n + 4 * (-(-npx // dh.CHUNK)), None,
                alone="huffman_restore_masked_kernel")
    return rows


def huffman_phases(tiles, mask, card, launches, add_row):
    """Phases 14-16: H1-H4 and the host scan against their plain versions
    (48x41 and 61x47 crops of the cells' data, depth 1 and 3, uint8 and
    int8, no mask, a random and a stripes mask, both modes; then at 2048^2),
    the four Huffman band cells, and the kernels' times."""
    from lerc_tpu_torch import decode_band_device, encode_band_device
    from lerc_tpu_torch.codec.device_codec import huffman_section
    from lerc_tpu_torch.ops import device_huffman as dh
    from lerc_tpu_torch.ops import huffman_scan as hs

    u8x3 = int_cell_tiles(tiles, np.uint8, 3)
    flags = quality_flags(N_TILES, TILE, tiles[0].device)
    err = {}

    def merge(e):
        for k, x in e.items():
            err[k] = max(err.get(k, 0.0), x)

    # ---- 14. each kernel against its plain version
    rng = np.random.default_rng(14)
    for (ch, cw), (r0, c0) in (((48, 41), (300, 470)), ((61, 47), (1000, 1010))):
        crop = (slice(r0, r0 + ch), slice(c0, c0 + cw))
        masks = {"no mask": None, "random mask": rng.random((ch, cw)) > 0.3,
                 "stripes mask": stripes_mask(ch, cw)}
        for kind, data in (("uint8 x 3", u8x3[0][crop]), ("uint8 band 0", u8x3[0][crop][:, :, :1]),
                           ("quality flags", flags[0][crop])):
            for dtname, dd in (("uint8", data.contiguous()), ("int8", data.contiguous().view(torch.int8))):
                for mname, mk in masks.items():
                    merge(huffman_check(dd, mk, f"{ch}x{cw} {kind} {dtname}, {mname}"))
        print(f"check: H1-H4 and the host scan equal to their plain versions on the {ch}x{cw} crops "
              f"(uint8 x 3, one band, quality flags; uint8 and int8; no, random and stripes "
              f"masks; direct and delta)", flush=True)
    # rows wider than one CTA's tile (the row scans carry across tiles)
    wide = torch.cat([u8x3[0][:24], u8x3[-1][:24], u8x3[0][:24, :500]], 1).contiguous()
    for mname, mk in (("no mask", None), ("random mask", rng.random(wide.shape[:2]) > 0.3),
                      ("stripes mask", stripes_mask(*wide.shape[:2]))):
        merge(huffman_check(wide, mk, f"24x{wide.shape[1]} uint8 x 3, {mname}"))
    print(f"check: H1-H4 and the host scan equal to their plain versions on a 24x{wide.shape[1]} "
          f"uint8 x 3 strip (no, random and stripes masks; direct and delta)", flush=True)
    for data, mk, what in ((u8x3[0], None, "uint8 x 3"), (u8x3[0], mask, "uint8 x 3, bench mask"),
                           (flags[0], None, "quality flags"),
                           (flags[0], mask, "quality flags, bench mask")):
        merge(huffman_check(data, mk, f"{TILE}^2 {what}", scan_ref=False))
        print(f"check: H1-H4 equal to their plain versions, the host scan to H2's sidecar, on the "
              f"{TILE}^2 {what} band (both modes)", flush=True)

    # ---- 15. the Huffman band cells, counted then timed
    cells = [huffman_cell(f"uint8 three-band {N_TILES} x {TILE}^2, lossless v6", u8x3, None, 1,
                          card),
             huffman_cell(f"uint8 three-band {N_TILES} x {TILE}^2 with the bench mask, lossless v6",
                          u8x3, mask, 1, card),
             huffman_cell(f"uint8 quality flags {N_TILES} x {TILE}^2, lossless v6", flags, None, 2,
                          card),
             huffman_cell(f"uint8 quality flags {TILE}^2 with the bench mask (fill), lossless v6",
                          flags[:1], mask, 2, card)]
    for c in cells:
        for k, n in c[0].items():
            launches[k] = launches.get(k, 0) + n

    # ---- 16. times
    rows = huffman_kernel_times(u8x3[0], mask, flags[0], card)
    for name, (ms, plain_ms, bound_ms, lib_ms) in rows.items():
        add_row(name, err.get(name, 0.0), ms, plain_ms, bound_ms, "bytes", lib_ms)
    s = huffman_section(cells[0][1][0])
    counts = dh.live_counts(s.n_groups, s.layout)
    t0 = time.perf_counter()
    for _ in range(3):
        hs.huffman_group_offsets(s.stream, s.lengths, s.codes, counts)
    scan_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    require(np.array_equal(hs.huffman_group_offsets_ref(s.stream, s.lengths, s.codes, counts),
                           cells[0][2][0]["huffman_sbits"]),
            "host scan plain version != the encoder's sidecar on the uint8 three-band blob")
    scan_plain = (time.perf_counter() - t0) * 1e3
    print(f"host scan: {scan_ms:.3f} ms per {TILE}^2 x 3 uint8 blob ({s.stream.size} B of stream, "
          f"{s.n_groups} groups), its plain numpy version {scan_plain:.1f} ms [{card}]", flush=True)
    add_row("huffman_scan", err.get("huffman_scan", 0.0), scan_ms, scan_plain,
            (s.stream.size + 4 * s.n_groups) / (HBM_BYTES_PER_S / 1e3), "bytes", None)

    def cell_round():
        enc = [encode_band_device(t, None, 0.5, return_index=True) for t in u8x3]
        return [decode_band_device(b, index=i) for b, i in enc]

    where_the_time_goes(None, u8x3, cells[0][3][0] + cells[0][3][1], card,
                        "uint8 three-band Huffman cell, encode_band_device + decode_band_device",
                        round_fn=cell_round)


# ---------------------------------------------------------------------------
# lossless float32 (fpl) through the band codec: F1 sampled histograms, F2
# planes, F2b PackBits sizes, F3 restore, the Huffman planes through H2/H3
# ---------------------------------------------------------------------------

FPL = ("fpl_sample_histograms", "fpl_finalize", "fpl_packbits_size", "fpl_restore")
FPL64 = ("fpl_sample_histograms_f64", "fpl_finalize_f64", "fpl_packbits_size", "fpl_restore_f64")
FPL_LEVELS = ((0, 1, 2, 3), (4, 5, 5, 0))  # every level 0..5 over the two
FPL_LEVELS64 = ((0, 1, 2, 3, 4, 5, 0, 1), (5, 4, 3, 2, 1, 0, 5, 5))  # every level on every plane


def bits_of(t):
    """A float tensor's bits as integers of its width (exact comparisons)."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def fpl_check(data, tag, level_sets=FPL_LEVELS):
    """F1-F3 against their plain versions on one float32 or float64 band (a
    CUDA tensor): F1's histograms; for each predictor and level set, F2's
    planes and histograms, F2b's sizes and F3's image, which also equals the
    input. Returns {kernel: max_abs_err}."""
    from lerc_tpu_torch.ops import device_fpl as F

    h, w, d = data.shape
    n = h * w * d
    require(torch.equal(F.fpl_sample_histograms(data), F.fpl_sample_histograms_ref(data)),
            f"F1 != plain ({tag})")
    for pred in (0, 1, 2):
        for levels in level_sets:
            how = f"{tag}, predictor {pred}, levels {levels}"
            pk, hk = F.fpl_finalize(data, pred, levels)
            pr, hr = F.fpl_finalize_ref(data, pred, levels)
            require(torch.equal(pk, pr) and torch.equal(hk, hr), f"F2 != plain ({how})")
            require(torch.equal(F.fpl_packbits_size(pk, n), F.fpl_packbits_size_ref(pk, n)),
                    f"F2b != plain ({how})")
            rk = bits_of(F.fpl_restore(pk, h, w, d, pred, levels))
            rr = bits_of(F.fpl_restore_ref(pk, h, w, d, pred, levels))
            require(torch.equal(rk, rr) and torch.equal(rk, bits_of(data)),
                    f"F3 != plain or input ({how})")
    # every comparison above is exact
    return dict.fromkeys(FPL64 if data.dtype == torch.float64 else FPL, 0.0)


def fpl_section(blob):
    """(predictor, levels, plane methods) of an fpl blob (4 planes, or 8 for
    float64)."""
    import struct

    from lerc_tpu_torch.codec.device_codec import band_sections

    sec = band_sections(blob)
    require(sec.kind == "fpl", f"the blob's data section is {sec.kind}, not fpl")
    n_pl = 8 if sec.head.dt == 7 else 4
    src, pos = memoryview(blob), sec.pos
    pred, pos, levels, methods = src[pos], pos + 1, [0] * n_pl, [None] * n_pl
    for _ in range(n_pl):
        b, csize = src[pos], struct.unpack_from("<I", src, pos + 2)[0]
        levels[b], methods[b] = src[pos + 1], src[pos + 6]
        pos += 6 + csize
    return pred, tuple(levels), tuple(methods)


FPL_METHODS = {0: "Huffman", 1: "RLE-const", 2: "raw", 3: "PackBits"}


def numpy_tile0():
    """Tile 0 of bench.py:91-117 rendered in numpy in float32, as the jnp
    code computes it: [TILE, TILE, 1] float32."""
    f32 = np.float32
    x = np.linspace(0, 20, TILE, dtype=f32)[None, :]
    y = np.linspace(0, 15, TILE, dtype=f32)[:, None]
    m32 = np.uint64(0xFFFFFFFF)
    i = np.arange(TILE * TILE, dtype=np.uint64).reshape(TILE, TILE)
    for _ in range(2):
        i = ((i ^ (i >> np.uint64(16))) * np.uint64(0x45D9F3B)) & m32
    i = i ^ (i >> np.uint64(16))
    noise = i.astype(f32) * f32(2.0**-32) - f32(0.5)
    dem = f32(1500) * np.exp(-((x - 10) ** 2 + (y - 7) ** 2) / f32(20)) \
        + f32(50) * np.sin(x) * np.cos(y) + noise
    return dem.astype(f32)[:, :, None]


def fpl_cell(label, tiles, mask, card, plain_tile0=True, rounds=3):
    """One fpl band cell, lossless v6: encode_band_device(...,
    return_index=True) -> decode_band_device with the index and without it,
    counted; fpl asserted taken on every tile; every pixel (fpl codes them
    all, valid or not) decoded bit-equal to the input, the mask
    round-tripped; tile 0's blob byte-equal to the plain path's
    (device="cpu") with plain_tile0. Returns (counts, blobs, indexes,
    (encode, decode, no-index decode ms, raw MB), tile 0's section)."""
    from lerc_tpu_torch import decode_band_device, encode_band_device

    required = ("encode_blocks_lut", "write_records_lut", "fletcher32_parts", *FPL)
    huffman = ("huffman_group_bits", "huffman_pack", "huffman_decode", "huffman_scan")

    def path():
        enc = [encode_band_device(t, mask, 0.0, return_index=True) for t in tiles]
        return enc, [decode_band_device(b, index=i) for b, i in enc], \
            [decode_band_device(b) for b, _ in enc]

    counts, (enc, decs, frees) = run_counted_band(required, huffman, label, path)
    if any(i["fpl_sbits"] for _, i in enc):  # a Huffman plane: H2, H3 and the host scan ran
        for name in huffman:
            require(counts.get(name, 0) > 0, f"kernel {name} was not launched on the {label}")
    for i, (t, (b, idx), a, f) in enumerate(zip(tiles, enc, decs, frees)):
        fpl_section(b)
        require(idx is not None and set(idx) == {"fpl_sbits"}, f"{label}: tile {i} has no fpl index")
        for what, dband in (("with the index", a), ("without the index", f)):
            require(torch.equal(dband.data.view(torch.int32), t.view(torch.int32)),
                    f"{label}: tile {i} decoded {what} != input")
            require(np.array_equal(dband.mask, np.ones(t.shape[:2], bool) if mask is None
                                   else mask), f"{label}: mask of tile {i} differs")
    if plain_tile0:
        require(encode_band_device(tiles[0].cpu(), mask, 0.0, device="cpu") == enc[0][0],
                f"{label}: blob of tile 0 differs from the plain path's")
    raw_mb = len(tiles) * tiles[0].numel() * 4 / 1e6
    blobs, indexes = [b for b, _ in enc], [i for _, i in enc]

    def timed(fn):
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    enc_ms = timed(lambda: [encode_band_device(t, mask, 0.0, return_index=True) for t in tiles])
    dec_ms = timed(lambda: [decode_band_device(b, index=i) for b, i in enc])
    free_ms = timed(lambda: [decode_band_device(b) for b in blobs])
    ratio = raw_mb * 1e6 / sum(len(b) for b in blobs)
    sec0 = fpl_section(blobs[0])
    print(f"fpl cell {label}: {len(tiles)} tiles ok, fpl taken on every tile"
          f"{', blob 0 equal to the plain path' if plain_tile0 else ''}, launches {counts}; "
          f"encode {raw_mb / (enc_ms / 1e3):.1f} MB/s ({enc_ms:.3f} ms), decode "
          f"{raw_mb / (dec_ms / 1e3):.1f} MB/s with the index ({dec_ms:.3f} ms), "
          f"{raw_mb / (free_ms / 1e3):.1f} MB/s without ({free_ms:.3f} ms), compression ratio "
          f"{ratio:.4f}; tile 0: predictor {sec0[0]}, levels {sec0[1]}, methods "
          f"{tuple(FPL_METHODS[m] for m in sec0[2])}, blob {len(blobs[0])} B [{card}]", flush=True)
    return counts, blobs, indexes, (enc_ms, dec_ms, free_ms, raw_mb), sec0


def fpl_kernel_times(tile, blob, index, card):
    """Device ms per launch of F1-F3 (torch.profiler) on one 2048^2 tile
    with its blob's predictor and levels, their plain ms (CUDA events),
    bounds (bytes: each input read once, each output written once, over the
    HBM rate) and, beside F3, torch.cumsum(dtype=uint8) of the four planes
    (one level of the undo); H2 and H3 on one of its Huffman planes; the
    host PackBits and scan. Returns {kernel: (ms, plain ms, bound ms,
    library ms or None)}."""
    from lerc_tpu_torch.codec import fpl_impl, huffman
    from lerc_tpu_torch.ops import device_fpl as F
    from lerc_tpu_torch.ops import device_huffman as dh
    from lerc_tpu_torch.ops import huffman_scan as hs

    h, w, d = tile.shape
    n = h * w * d
    pred, levels, methods = fpl_section(blob)
    rows, cols = fpl_impl.slice_shape(h, w, d)
    m = -(-rows // F.sample_stride(n)) * cols  # F1's sampled words
    planes, histos = F.fpl_finalize(tile, pred, levels)
    mb = HBM_BYTES_PER_S / 1e3  # bytes per ms
    out = {
        "fpl_sample_histograms": (
            device_ms([lambda: F.fpl_sample_histograms(tile)], "fpl_sample_histograms_kernel"),
            cuda_ms([lambda: F.fpl_sample_histograms_ref(tile)], reps=1),
            (4 * m + 4 * 3 * 4 * 6 * 256) / mb, None),
        "fpl_finalize": (
            device_ms([lambda: F.fpl_finalize(tile, pred, levels)], "fpl_finalize_kernel"),
            cuda_ms([lambda: F.fpl_finalize_ref(tile, pred, levels)], reps=1),
            (8 * n + 4 * 4 * 256) / mb, None),
        "fpl_packbits_size": (
            device_ms([lambda: F.fpl_packbits_size(planes, n)], "fpl_pb_"),
            cuda_ms([lambda: F.fpl_packbits_size_ref(planes, n)], reps=1), (4 * n + 16) / mb, None),
        "fpl_restore": (
            device_ms([lambda: F.fpl_restore(planes, h, w, d, pred, levels)], "fpl_restore_"),
            cuda_ms([lambda: F.fpl_restore_ref(planes, h, w, d, pred, levels)], reps=1),
            8 * n / mb,
            device_ms([lambda: torch.cumsum(planes[:, :n], 1, dtype=torch.uint8)])),
    }
    print(f"fpl kernels at {h}x{w}x{d} (predictor {pred}, levels {levels}): F3 "
          f"{out['fpl_restore'][0]:.4f} ms a call, one level of its undo as "
          f"torch.cumsum(dtype=uint8) of the four planes {out['fpl_restore'][3]:.4f} ms [{card}]",
          flush=True)
    planes_h = planes[:, :n].cpu().numpy()
    for b, meth in enumerate(methods):
        if meth == 3:  # PackBits, on the host
            t0 = time.perf_counter()
            packed = fpl_impl.encode_packbits(planes_h[b])
            t1 = time.perf_counter()
            fpl_impl.decode_packbits(memoryview(packed), n)
            t2 = time.perf_counter()
            print(f"host PackBits, plane {b} ({len(packed)} B of {n}): encode "
                  f"{(t1 - t0) * 1e3:.3f} ms, decode {(t2 - t1) * 1e3:.3f} ms [{card}]", flush=True)
    for b in sorted(index["fpl_sbits"]):
        hst = histos[b].cpu().numpy().astype(np.int64)
        lengths = huffman.compute_code_lengths(hst)
        codes = huffman.canonical_codes(lengths)
        table = dh.code_table(lengths, codes, tile.device)
        total = int((hst * lengths).sum())
        n_words = -(-total // 32) + 1
        layout = (n, n, n)
        words, _tb, sbits = dh.encode_stream_device(planes[b], table, layout, n_words)
        consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
        args = (torch.cat([words, words.new_zeros(1)]), 32 * n_words, sbits,
                torch.from_numpy(consts).cuda(), torch.from_numpy(sorted_syms).cuda(), layout)
        gb = device_ms([lambda: dh.encode_stream_device(planes[b], table, layout, n_words)],
                       "huffman_group_bits_kernel")
        pk = device_ms([lambda: dh.encode_stream_device(planes[b], table, layout, n_words)],
                       "huffman_pack_kernel")
        dc = device_ms([lambda: dh.decode_stream_device(*args)], "huffman_decode_kernel")
        stream = words.cpu().numpy().view(np.uint8)
        counts = dh.live_counts(sbits.numel(), layout)
        t0 = time.perf_counter()
        offs = hs.huffman_group_offsets(stream, lengths, codes, counts)
        scan_ms = (time.perf_counter() - t0) * 1e3
        require(np.array_equal(offs, sbits.cpu().numpy()), f"host scan != H2's sidecar, plane {b}")
        g4 = 4 * sbits.numel()
        print(f"fpl Huffman plane {b} ({n} symbols, {total} bits): H2 group bits {gb:.4f} + pack "
              f"{pk:.4f} ms, H3 {dc:.4f} ms per launch (bounds {(n + g4) / mb:.4f}, "
              f"{(n + g4 + total / 8) / mb:.4f}, {(total / 8 + 2 * g4 + n) / mb:.4f} ms); host "
              f"scan {scan_ms:.3f} ms [{card}]", flush=True)
        break  # one plane is enough for the times
    return out


def fpl_phases(tiles, mask, card, launches, add_row):
    """Phases 17-19: F1-F3 against their plain versions (crops, then 2048^2),
    the three fpl band cells, and their times."""
    from lerc_tpu_torch import decode_band_device, encode_band_device

    err = {}
    # ---- 17. each kernel against its plain version
    for (ch, cw), (r0, c0) in (((48, 41), (300, 470)), ((61, 47), (1000, 1010))):
        crop = tiles[0][r0:r0 + ch, c0:c0 + cw]
        for d, data in ((1, crop.contiguous()),
                        (3, torch.cat([crop, crop + 0.25, crop * 0.5], 2).contiguous())):
            err.update(fpl_check(data, f"{ch}x{cw}x{d} DEM crop"))
        print(f"check: F1-F3 equal to their plain versions on the {ch}x{cw} DEM crops (depth 1 "
              f"and 3, predictors 0-2, levels 0-5)", flush=True)
    err.update(fpl_check(tiles[0], f"{TILE}^2 DEM tile", level_sets=((0, 0, 0, 0), (4, 1, 0, 0),
                                                                     (5, 5, 5, 5))))
    print(f"check: F1-F3 equal to their plain versions on the {TILE}^2 DEM tile (predictors 0-2, "
          f"levels 0, (4, 1, 0, 0) and 5)", flush=True)

    # ---- 18. the fpl band cells, counted then timed
    cells = [fpl_cell(f"float32 DEM {N_TILES} x {TILE}^2, lossless v6", tiles, None, card),
             fpl_cell(f"float32 DEM {N_TILES} x {TILE}^2 with the bench mask, lossless v6",
                      tiles, mask, card)]
    big = torch.cat([torch.cat([tiles[0], tiles[1]], 1), torch.cat([tiles[2], tiles[3]], 1)], 0)
    big = torch.cat([big, big + 0.25, big * 0.5], 2).contiguous()
    require(big.numel() > 1 << 25, "the 4096^2 x 3 band holds no more than 2^25 values")
    cells.append(fpl_cell(f"float32 {2 * TILE}^2 x 3 band ({big.numel()} values), lossless v6",
                          [big], None, card, plain_tile0=False, rounds=1))
    for c in cells:
        for k, v in c[0].items():
            launches[k] = launches.get(k, 0) + v
    # tile 0 as numpy renders it (the card's exp/sin differ by ulps), through the card
    t0_np = torch.from_numpy(numpy_tile0()).cuda()
    blob = encode_band_device(t0_np, None, 0.0)
    require(torch.equal(decode_band_device(blob).data.view(torch.int32), t0_np.view(torch.int32)),
            "numpy's tile 0: decode != input")
    sec = fpl_section(blob)
    same = (sec[0], sec[1], len(blob)) == (1, (4, 1, 0, 0), 10510117)
    print(f"fpl numpy-rendered tile 0 through the card: predictor {sec[0]}, levels {sec[1]}, "
          f"methods {tuple(FPL_METHODS[m] for m in sec[2])}, blob {len(blob)} B, ratio "
          f"{t0_np.numel() * 4 / len(blob):.4f}; equal to JAX's on the CPU (predictor 1, levels "
          f"(4, 1, 0, 0), 10,510,117 B): {same} [{card}]", flush=True)

    # ---- 19. times
    rows = fpl_kernel_times(tiles[0], cells[0][1][0], cells[0][2][0], card)
    for name, (ms, plain_ms, bound_ms, lib_ms) in rows.items():
        add_row(name, err.get(name, 0.0), ms, plain_ms, bound_ms, "bytes", lib_ms)

    def cell_round():
        enc = [encode_band_device(t, None, 0.0, return_index=True) for t in tiles]
        return [decode_band_device(b, index=i) for b, i in enc]

    where_the_time_goes(None, tiles, cells[0][3][0] + cells[0][3][1], card,
                        "float32 DEM fpl cell, encode_band_device + decode_band_device",
                        round_fn=cell_round)


# ---------------------------------------------------------------------------
# float64 through the band codec: K1/K2 f64 (lossy tiling), K6 f64 (its
# decode), F1-F3 over u64 words (lossless fpl, eight planes)
# ---------------------------------------------------------------------------

F64_LOSSY = ("fletcher32_parts", "tile_scan")  # with K1/K2/K6 f64, all-valid or masked


def make_tiles64(n, tile, device):
    """make_tiles' DEM rendered in float64 (the hash noise at full
    precision): [tile, tile, 1] float64 tiles."""
    x = torch.linspace(0, 20, tile, dtype=torch.float64, device=device)[None, :]
    y = torch.linspace(0, 15, tile, dtype=torch.float64, device=device)[:, None]
    m32 = 0xFFFFFFFF
    tiles = []
    for seed in range(n):
        i = (torch.arange(tile * tile, dtype=torch.int64, device=device).reshape(tile, tile)
             + ((seed * 0x9E3779B9) & m32)) & m32
        i = ((i ^ (i >> 16)) * 0x45D9F3B) & m32
        i = ((i ^ (i >> 16)) * 0x45D9F3B) & m32
        i = i ^ (i >> 16)
        noise = i.to(torch.float64) * 2.0**-32 - 0.5
        dem = (1500 * torch.exp(-((x - 10) ** 2 + (y - 7) ** 2) / 20)
               + 50 * torch.sin(x + seed) * torch.cos(y) + noise)
        tiles.append(dem[:, :, None].contiguous())
    return tiles


def f64_modes_tile(device):
    """A 64x61x1 float64 tile whose records take every mode: const-0,
    const-offset, raw (a block past 2^30 - 1 quanta at maxZError 1e-4) and
    stuffed, with edge blocks."""
    rng = np.random.default_rng(7)
    t = 1000 + np.cumsum(rng.standard_normal((64, 61)), 1)[:, :, None]
    t[0:8, 0:8] = 0.0
    t[8:16, 8:16] = 7.25
    t[16:24, 0:8] = np.linspace(-1e6, 1e6, 64).reshape(8, 8, 1)
    return torch.from_numpy(t).to(device)


def f64_encode_check(data, mask, mze, tag):
    """K1/K2 f64 against their plain versions on one float64 band (a CUDA
    tensor; masks and edge blocks through validity words). Returns
    ({kernel: max_abs_err}, mode counts [4])."""
    from lerc_tpu_torch.ops import device_encode as E

    h, w, d = data.shape
    valid = None
    if mask is not None or h % 8 or w % 8:
        m = np.ones((h, w), bool) if mask is None else mask
        valid = E.block_valid_words(torch.from_numpy(m).to(data.device))
    sfx = "" if valid is None else "_masked"
    p = E.encode_params_f64(mze, 6)
    rk, zk = E.encode_blocks_f64(data, p, valid)
    rr, zr = E.encode_blocks_f64_ref(data, p, valid)
    require(torch.equal(rk, rr) and torch.equal(bits_of(zk), bits_of(zr)),
            f"K1 encode_blocks{sfx}_f64 != plain ({tag})")
    length = rk[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    cap_w = (int(length.sum()) + 4096) // 4
    sk = E.write_records_f64(data, rk, starts, cap_w, p, valid)
    sr = E.write_records_f64_ref(data, rk, starts, cap_w, p, valid)
    require(torch.equal(sk, sr), f"K2 write_records{sfx}_f64 != plain ({tag})")
    modes = torch.bincount((rk[:, 1] >> 8) & 3, minlength=4).cpu().numpy()
    return {f"encode_blocks{sfx}_f64": max_abs(rk, rr), f"write_records{sfx}_f64": max_abs(sk, sr)}, modes


def k6_edited(a, head, depth_diff):
    """K6's arguments `a` with records edited on the card: depth_diff turns
    every stuffed, const-0 and const-offset record of slices >= 1 into a
    depth-diff record; else every stuffed record is read as a LUT record
    (its own payload as LUT and indices, numBits-wide, a LUT as long as
    the widest index), as tests/test_torch_scan.py edits K6's records."""
    a = list(a)
    mode, d = a[1].clone(), head.n_depth
    m8 = mode % 8
    if depth_diff:
        r = torch.arange(mode.numel(), device=mode.device)
        mode = torch.where((r % d > 0) & ((m8 == 1) | (m8 == 2) | (m8 == 3)), mode + 8, mode)
    else:
        stuffed = m8 == 1
        nb = a[4]
        mode = torch.where(stuffed, 4, mode)
        a[6] = torch.where(stuffed, a[2], a[6])                        # lut_pos
        a[7] = torch.where(stuffed, ((1 << nb.clamp(max=30)) - 1).to(torch.int32), a[7])
        a[8] = torch.where(stuffed, nb, a[8])                          # nbits_lut
        a[17] = True
    a[1] = mode
    return tuple(a)


def check_k6_f64(blob, tag, edits=True):
    """The host scanner and K6 f64 against their plain versions on one
    float64 tiling blob, then on its records edited into depth-diff (depth
    > 1) and LUT records. Returns {kernel: max_abs_err}."""
    from lerc_tpu_torch.ops import device_decode as dec

    err, _modes = check_scanned_band(blob, tag)
    if not edits:
        return err
    _scan, _recs, _used, a, head = scanned_band(blob)
    for depth_diff in ((True, False) if head.n_depth > 1 else (False,)):
        e = k6_edited(a, head, depth_diff)
        img_k, ok_k = dec.decode_scanned(*e)
        img_r, ok_r = k6_plain(e, head)
        what = "depth-diff" if depth_diff else "LUT"
        require(torch.equal(bits_of(img_k), bits_of(img_r)) and bool(ok_k) == bool(ok_r)
                and bool(ok_k), f"K6 f64 != plain on {what} records ({tag})")
    return err


def check_k6_f64_16(tile, mask):
    """K6's 16x16 float64 instances against their plain versions. float64
    takes no 16x16 retrial, so no band path writes such a blob: the 16x16
    blob of a float32 class grid (12 zones of whole numbers, LUT records),
    all-valid and with the bench mask, is read as float64 -- its f32 offsets
    and zMax widened, exactly -- and must also decode to the float32 decode's
    values. Returns {kernel: max_abs_err}."""
    from lerc_tpu_torch import decode_band_device, encode_band_device
    from lerc_tpu_torch.constants import DataType
    from lerc_tpu_torch.ops import device_decode as dec

    cls = class_grid(tile).to(torch.float32).contiguous()
    err = {}
    for m in (None, mask):
        blob = encode_band_device(cls, m, 0.5)
        _scan, recs, _used, a, head = scanned_band(blob)
        require(head.micro_block_size == 16 and (recs["mode"] % 8 == 4).any()
                and not (recs["mode"] % 8 == 0).any(), "class grid: not a 16x16 LUT blob")
        a = list(a)
        a[3], a[11], a[15] = a[3].double(), a[11].double(), DataType.DOUBLE
        img_k, ok_k = dec.decode_scanned(*a)
        img_r, ok_r = k6_plain(a, head)
        want = decode_band_device(blob).data.double()
        require(bool(ok_k) and bool(ok_r) and torch.equal(bits_of(img_k), bits_of(img_r))
                and torch.equal(img_k, want), "K6 16x16 f64 != plain or the float32 decode")
        err[k6_name(16, m is not None, DataType.DOUBLE)] = max_abs(img_k, img_r)
    print("check: K6's 16x16 float64 instances equal to their plain versions and to the float32 "
          "decode on a 16x16 class-grid blob read as float64 (all-valid and masked)", flush=True)
    return err


def f64_cell(label, tiles, mask, mze, card, plain_tile0=True, rounds=3):
    """One float64 band cell: encode_band_device(..., return_index=True) ->
    decode_band_device with the index and without it, counted; lossy
    decodes within maxZError at every valid pixel (invalid pixels 0, the
    mask round-tripped), lossless ones bit-equal to the input at every
    pixel; tile 0's blob byte-equal to the plain path's (device="cpu").
    Returns (counts, blobs, indexes, (encode ms, decode ms, raw MB), record
    mode counts of tile 0 or its fpl section)."""
    from lerc_tpu_torch import decode_band_device, encode_band_device

    masked = mask is not None
    if mze > 0:
        sfx = "_masked" if masked else ""
        required = (f"encode_blocks{sfx}_f64", f"write_records{sfx}_f64", f"decode_scanned{sfx}_f64",
                    *F64_LOSSY)
        optional = ()
    else:  # F3 and the Huffman planes' H2/H3 where a tile takes fpl (checked below)
        required = ("fletcher32_parts", *FPL64[:3])
        optional = ("huffman_group_bits", "huffman_pack", "huffman_decode", "huffman_scan",
                    "fpl_restore_f64")

    def path():
        enc = [encode_band_device(t, mask, mze, return_index=True) for t in tiles]
        return enc, [decode_band_device(b, index=i) for b, i in enc], \
            [decode_band_device(b) for b, _ in enc]

    counts, (enc, decs, frees) = run_counted_band(required, optional, label, path)
    if any(i for _, i in enc):  # an fpl tile: F3 ran
        require(counts.get("fpl_restore_f64", 0) > 0, f"kernel fpl_restore_f64 was not launched "
                f"on the {label}")
    if any(i and i["fpl_sbits"] for _, i in enc):  # a Huffman plane: H2, H3 and the host scan ran
        for name in optional:
            require(counts.get(name, 0) > 0, f"kernel {name} was not launched on the {label}")
    from lerc_tpu_torch.codec.device_codec import band_sections

    sel = None if mask is None else torch.from_numpy(mask).cuda()
    for i, (t, (b, idx), a, f) in enumerate(zip(tiles, enc, decs, frees)):
        kind = band_sections(b).kind  # lossless and masked: fpl codes every pixel, one-sweep the valid
        require(kind == ("fpl" if mze == 0 and mask is None else kind) and kind != "empty",
                f"{label}: tile {i} is a {kind} blob")
        require((idx is None) == (kind != "fpl"), f"{label}: tile {i}'s index {idx}")
        for what, dband in (("with the index", a), ("without the index", f)):
            require(dband.data.dtype == torch.float64, f"{label}: tile {i} decoded as {dband.data.dtype}")
            require(np.array_equal(dband.mask, np.ones(t.shape[:2], bool) if mask is None
                                   else mask), f"{label}: mask of tile {i} differs")
            if kind == "fpl":
                require(torch.equal(bits_of(dband.data), bits_of(t)),
                        f"{label}: tile {i} decoded {what} != input")
                continue
            err = (dband.data - t).abs()
            if sel is not None:
                require(not bits_of(dband.data)[~sel].any(), f"{label}: invalid pixels of tile {i} != 0")
                err = err[sel]
            require(float(err.max()) <= dband.hd.max_z_error,
                    f"{label}: tile {i} decoded {what}: error {float(err.max())} > maxZError")
    if plain_tile0:
        require(encode_band_device(tiles[0].cpu(), mask, mze, device="cpu") == enc[0][0],
                f"{label}: blob of tile 0 differs from the plain path's")
    raw_mb = len(tiles) * tiles[0].numel() * 8 / 1e6
    blobs, indexes = [b for b, _ in enc], [i for _, i in enc]

    def timed(fn):
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    enc_ms = timed(lambda: [encode_band_device(t, mask, mze, return_index=True) for t in tiles])
    dec_ms = timed(lambda: [decode_band_device(b, index=i) for b, i in enc])
    ratio = raw_mb * 1e6 / sum(len(b) for b in blobs)
    if mze > 0:
        recs = scanned_band(blobs[0])[1]
        shape = torch.bincount(torch.from_numpy(recs["mode"] % 8).long(), minlength=4).tolist()
        nbs = recs["num_bits"][recs["mode"] % 8 == 1]
        what = (f"tile 0 records by mode (raw, stuffed, const-0, const-offset) {shape[:4]}, "
                f"numBits {int(nbs.min())}-{int(nbs.max())}")
    elif band_sections(blobs[0]).kind == "fpl":
        shape = fpl_section(blobs[0])
        what = (f"tile 0: predictor {shape[0]}, levels {shape[1]}, methods "
                f"{tuple(FPL_METHODS[m] for m in shape[2])}")
    else:
        shape, what = None, f"tile 0: {band_sections(blobs[0]).kind}"
    print(f"float64 cell {label}: {len(tiles)} tiles ok"
          f"{', blob 0 equal to the plain path' if plain_tile0 else ''}, launches {counts}; "
          f"encode {raw_mb / (enc_ms / 1e3):.1f} MB/s ({enc_ms:.3f} ms), decode "
          f"{raw_mb / (dec_ms / 1e3):.1f} MB/s ({dec_ms:.3f} ms) best of {rounds}, compression "
          f"ratio {ratio:.4f}, blob 0 {len(blobs[0])} B; {what} [{card}]", flush=True)
    return counts, blobs, indexes, (enc_ms, dec_ms, raw_mb), shape


def f64_kernel_times(tiles, mask, lossy_blobs, lossless_blob, card):
    """Device ms per launch (torch.profiler) of the float64 kernels over the
    2048^2 tiles round-robin (four tiles, 134 MB: past the 50 MB L2, as a
    stream of tiles finds them), their plain ms on tile 0 (CUDA events) and
    bytes bounds per tile (each input read once, each output written once,
    over the HBM rate). lossy_blobs: the all-valid and the masked cell's
    blobs of the tiles. Returns {kernel: (ms, plain ms, bound ms)}."""
    from lerc_tpu_torch.ops import device_decode as dec
    from lerc_tpu_torch.ops import device_encode as E
    from lerc_tpu_torch.ops import device_fpl as F

    h, w, d = tiles[0].shape
    n = h * w * d
    n_rec = (h // 8) * (w // 8) * d
    mb = HBM_BYTES_PER_S / 1e3  # bytes per ms
    p = E.encode_params_f64(MAX_Z_ERROR, 6)
    out = {}
    for m, blobs in zip((None, mask), lossy_blobs):
        valid = None if m is None else E.block_valid_words(torch.from_numpy(m).cuda())
        sfx = "" if m is None else "_masked"
        vbytes = 0 if valid is None else valid.numel() * 4
        recs = [E.encode_blocks_f64(t, p, valid)[0] for t in tiles]
        starts = [torch.cumsum(r[:, 0], 0, dtype=torch.int32) - r[:, 0] for r in recs]
        totals = [int(r[:, 0].sum()) for r in recs]
        caps = [(t + 4096) // 4 for t in totals]
        out[f"encode_blocks{sfx}_f64"] = (
            device_ms([lambda t=t: E.encode_blocks_f64(t, p, valid) for t in tiles],
                      "encode_blocks_f64_kernel"),
            cuda_ms([lambda: E.encode_blocks_f64_ref(tiles[0], p, valid)], reps=1),
            (8 * n + vbytes + 16 * n_rec + 16 * d) / mb)
        out[f"write_records{sfx}_f64"] = (
            device_ms([lambda a=a: E.write_records_f64(*a, p, valid)
                       for a in zip(tiles, recs, starts, caps)], "write_records_f64_kernel"),
            cuda_ms([lambda: E.write_records_f64_ref(tiles[0], recs[0], starts[0], caps[0], p,
                                                     valid)], reps=1),
            (8 * n + vbytes + 20 * n_rec + sum(totals) / len(totals)) / mb)
        args = [scanned_band(b)[3] for b in blobs]
        head = scanned_band(blobs[0])[4]
        total = sum(len(b) for b in blobs) / len(blobs)  # the tile streams, within a few hundred B
        out[f"decode_scanned{sfx}_f64"] = (
            device_ms([lambda a=a: dec.decode_scanned(*a) for a in args], "decode_scanned_kernel"),
            cuda_ms([lambda: k6_plain(args[0], head)], reps=1),
            (total + 36 * n_rec + vbytes + 8 * d + 8 * n) / mb)
        (_k6, _plain, _bound), scan, _n = k6_times(blobs[0])
        print(f"host record scanner on the {'masked ' if m is not None else ''}float64 tile: "
              f"{scan[0]:.3f} ms (plain {scan[1]:.3f} ms, bound {scan[2]:.4f} ms) [{card}]",
              flush=True)
    pred, levels, _methods = fpl_section(lossless_blob)
    planes = [F.fpl_finalize(t, pred, levels)[0] for t in tiles]
    m = -(-h // F.sample_stride(n)) * w  # F1's sampled words
    out["fpl_sample_histograms_f64"] = (
        device_ms([lambda t=t: F.fpl_sample_histograms(t) for t in tiles],
                  "fpl_sample_histograms_kernel"),
        cuda_ms([lambda: F.fpl_sample_histograms_ref(tiles[0])], reps=1),
        (8 * m + 4 * 3 * 8 * 6 * 256) / mb)
    out["fpl_finalize_f64"] = (
        device_ms([lambda t=t: F.fpl_finalize(t, pred, levels) for t in tiles],
                  "fpl_finalize_kernel"),
        cuda_ms([lambda: F.fpl_finalize_ref(tiles[0], pred, levels)], reps=1),
        (16 * n + 8 * 4 * 256) / mb)
    out["fpl_restore_f64"] = (
        device_ms([lambda q=q: F.fpl_restore(q, h, w, d, pred, levels) for q in planes],
                  "fpl_restore_"),
        cuda_ms([lambda: F.fpl_restore_ref(planes[0], h, w, d, pred, levels)], reps=1),
        16 * n / mb)
    pb = device_ms([lambda q=q: F.fpl_packbits_size(q, n) for q in planes], "fpl_pb_")
    pb_plain = cuda_ms([lambda: F.fpl_packbits_size_ref(planes[0], n)], reps=1)
    print(f"fpl F2b over the eight planes of a float64 tile: {pb:.4f} ms a call (plain "
          f"{pb_plain:.3f} ms, bound {(8 * n + 32) / mb:.4f} ms) [{card}]", flush=True)
    return out


def f64_phases(dev, mask, card, launches, add_row):
    """Phases 20-22 on device `dev`: K1/K2 f64, K6 f64 and F1-F3 over u64
    words against their plain versions, the lossy and lossless float64 band
    cells, and their times."""
    tiles = make_tiles64(N_TILES, TILE, dev)
    err = {}

    def merge(e):
        for k, x in e.items():
            err[k] = max(err.get(k, 0.0), x)

    # ---- 20. each kernel against its plain version
    from lerc_tpu_torch import encode_band_device

    crops = [((48, 41), (300, 470)), ((61, 47), (1000, 1010)), ((64, 64), (256, 512))]
    for (ch, cw), (r0, c0) in crops:
        crop = tiles[0][r0:r0 + ch, c0:c0 + cw]
        mcrop = mask[r0:r0 + ch, c0:c0 + cw]
        for d, data in ((1, crop.contiguous()),
                        (3, torch.cat([crop, crop + 0.25, crop * 0.5], 2).contiguous())):
            for m in (None, mcrop):
                e, _modes = f64_encode_check(data, m, MAX_Z_ERROR, f"{ch}x{cw}x{d} crop")
                merge(e)
                merge(check_k6_f64(encode_band_device(data, m, MAX_Z_ERROR), f"{ch}x{cw}x{d}"))
            merge(fpl_check(data, f"{ch}x{cw}x{d} float64 DEM crop", FPL_LEVELS64))
        print(f"check: K1/K2 f64, K6 f64 (with depth-diff and LUT record edits) and F1-F3 over "
              f"u64 words equal to their plain versions on the {ch}x{cw} float64 crops (depth 1 "
              f"and 3, all-valid and masked; predictors 0-2, levels 0-5)", flush=True)
    merge(check_k6_f64_16(tiles[0], mask))
    e, modes = f64_encode_check(f64_modes_tile(dev), None, 1e-4, "modes tile")
    merge(e)
    require(all(modes > 0), f"the modes tile lacks a record mode: {modes}")
    print(f"check: K1/K2 f64 equal to their plain versions on the 64x61 modes tile (records by "
          f"mode raw/stuffed/const-0/const-offset {modes.tolist()})", flush=True)
    edge = tiles[1][:2047, :1999].contiguous()
    for m in (None, mask[:2047, :1999]):
        e, _modes = f64_encode_check(edge, m, MAX_Z_ERROR, "2047x1999 edge crop")
        merge(e)
    for m in (None, mask):
        e, modes = f64_encode_check(tiles[0], m, MAX_Z_ERROR, f"{TILE}^2 tile")
        merge(e)
        merge(check_k6_f64(encode_band_device(tiles[0], m, MAX_Z_ERROR), f"{TILE}^2 tile"))
    band3 = torch.cat([tiles[0], tiles[1], tiles[0] + 0.25], 2).contiguous()
    merge(check_k6_f64(encode_band_device(band3, None, MAX_Z_ERROR), f"{TILE}^2 x 3 band"))
    merge(fpl_check(tiles[0], f"{TILE}^2 float64 DEM tile",
                    ((0,) * 8, (4, 1, 0, 0, 2, 3, 5, 0), (5,) * 8)))
    print(f"check: K1/K2 f64 on the 2047x1999 edge crop and the {TILE}^2 tile (all-valid and "
          f"with the bench mask; records by mode {modes.tolist()}), K6 f64 on their blobs and on "
          f"a {TILE}^2 x 3 band with depth-diff and LUT record edits, F1-F3 over u64 words on "
          f"the {TILE}^2 tile: equal to their plain versions", flush=True)

    # ---- 21. the lossy float64 cells; 22. the lossless ones
    lossy = [f64_cell(f"float64 DEM {N_TILES} x {TILE}^2, maxZError {MAX_Z_ERROR}", tiles, None,
                      MAX_Z_ERROR, card),
             f64_cell(f"float64 DEM {N_TILES} x {TILE}^2 with the bench mask, maxZError "
                      f"{MAX_Z_ERROR}", tiles, mask, MAX_Z_ERROR, card),
             f64_cell(f"float64 DEM {N_TILES} x {TILE}^2, maxZError 1e-06", tiles, None, 1e-6, card)]
    lossless = [f64_cell(f"float64 DEM {N_TILES} x {TILE}^2, lossless v6", tiles, None, 0.0, card),
                f64_cell(f"float64 DEM {N_TILES} x {TILE}^2 with the bench mask, lossless v6",
                         tiles, mask, 0.0, card)]
    for c in lossy + lossless:
        for k, v in c[0].items():
            launches[k] = launches.get(k, 0) + v

    # ---- times
    rows = f64_kernel_times(tiles, mask, (lossy[0][1], lossy[1][1]), lossless[0][1][0], card)
    for name, (ms, plain_ms, bound_ms) in rows.items():
        add_row(name, err.get(name, 0.0), ms, plain_ms, bound_ms, "bytes", None)
    from lerc_tpu_torch import decode_band_device

    for label, mze, cell in (("lossy float64 cell (maxZError 0.001)", MAX_Z_ERROR, lossy[0]),
                             ("lossless float64 cell", 0.0, lossless[0])):
        def one_round(mze=mze):
            enc = [encode_band_device(t, None, mze, return_index=True) for t in tiles]
            return [decode_band_device(b, index=i) for b, i in enc]

        where_the_time_goes(None, tiles, cell[3][0] + cell[3][1], card,
                            f"{label}, encode_band_device + decode_band_device",
                            round_fn=one_round)


# ---------------------------------------------------------------------------
# The tile mosaic (phases 23-26): lerc_tpu_torch.parallel.sharding on a
# one-rank NCCL DeviceMesh
# ---------------------------------------------------------------------------

MOSAIC_TILE = 512
CARD = torch.device("cuda")  # the device of the mosaic phases' own calls


def raster_of(tiles):
    """Four [T, T, D] tiles -> the [2T, 2T, D] raster (host numpy)."""
    return torch.cat([torch.cat(tiles[:2], 1), torch.cat(tiles[2:4], 1)], 0).cpu().numpy()


def k4_name(mb, masked, dt):
    from lerc_tpu_torch.constants import DT_SUFFIX

    return "decode_records_lut" + ("16" if mb == 16 else "") + ("_masked" if masked else "") \
        + DT_SUFFIX[dt]


def k1_tiles_names(dt, mb):
    """(batched K1, K2) launch names of a dtype at block size mb."""
    from lerc_tpu_torch.constants import DataType, dt_is_int

    if dt == DataType.DOUBLE:
        return "encode_tiles_f64", "write_records_masked_f64"
    sfx = ("_lut16" if mb == 16 else "_lut") + ("_int" if dt_is_int(dt) else "")
    return "encode_tiles" + sfx, "write_records" + sfx


def mosaic_units(blob):
    """(info, views, layouts, sections) of a container's units."""
    from lerc_tpu_torch.parallel import sharding as S

    info, views = S.read_mosaic(blob)
    layouts = S._tile_band_layouts(views, info["n_bands"])
    units = [(t, b) for t in range(len(views)) for b in range(info["n_bands"])]
    return info, views, layouts, S._unit_sections(views, layouts, units, info["n_bands"])


def k4_groups(blob):
    """{mb: units} of the K4-decodable (tiling, not float64) units."""
    _info, _views, layouts, secs = mosaic_units(blob)
    out = {}
    for (t, b), sec in secs.items():
        hd = layouts[t][b][1]
        if sec.kind == "tiling" and hd.dt != 7:
            out.setdefault(hd.micro_block_size, []).append((t, b))
    return out


def lut_records(blob):
    """LUT records of a single-band container: stuffed records whose numBits
    byte has bit 5 set, found through the record index."""
    info, views, layouts, secs = mosaic_units(blob)
    from lerc_tpu_torch.constants import DataType

    n = 0
    for (t, b), sec in secs.items():
        so = int(info["stream_offs"][t])
        if sec.kind != "tiling" or so < 0:
            continue
        dt = layouts[t][b][1].dt
        for st in info["starts"][t]:
            if st < 0:
                break
            flag = views[t][so + st]
            b67 = flag >> 6
            if dt in (DataType.CHAR, DataType.BYTE):
                off_w = 1
            elif dt in (DataType.SHORT, DataType.USHORT):
                off_w = 1 if b67 else 2
            elif dt == DataType.INT:
                off_w = 1 if b67 == 3 else 2 if b67 else 4
            else:
                off_w = 1 if b67 == 2 else 2 if b67 == 1 else 4
            n += flag & 3 == 1 and views[t][so + st + 1 + off_w] & 32 != 0
    return n


def check_tiles_encode(raster, mask, mze, mb, tag):
    """The tile-batched K1 and K2 against their plain versions on the whole
    tile stack that MosaicEncoder (one rank) hands encode_tiles_batched:
    every output equal. Returns ({kernel: err}, the kernel timing row
    inputs)."""
    from lerc_tpu_torch.constants import NUMPY_TO_DT
    from lerc_tpu_torch.ops import device_encode as enc
    from lerc_tpu_torch.parallel import sharding as S

    dt = NUMPY_TO_DT[raster.dtype]
    tiles, masks, _ = S.split_into_tiles(raster, mask, MOSAIC_TILE, MOSAIC_TILE)
    if raster.dtype == np.uint32:
        tiles = tiles.view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(tiles)).to(CARD)
    m = torch.from_numpy(np.ascontiguousarray(masks)).to(CARD)
    k = enc.encode_tiles_batched(t, m, mze, dt, 6, mb)
    r = enc.encode_tiles_batched(t.cpu(), m.cpu(), mze, dt, 6, mb)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(k, r)):
        require(torch.equal(a.cpu(), b), f"tile-batched K1/K2 output {i} != plain ({tag}, mb {mb})")
    k1, k2 = k1_tiles_names(dt, mb)
    return {k1: max(max_abs(k[4].cpu(), r[4]), max_abs(k[5].cpu(), r[5])),
            k2: max_abs(k[0].cpu(), r[0])}, (t, m, mze, dt, mb)


def k4_inputs(blob, mb, units, dev):
    from lerc_tpu_torch.ops import device_encode as enc
    from lerc_tpu_torch.parallel import sharding as S

    info, views, layouts, secs = mosaic_units(blob)
    stream, starts, zmax, masks = S._group_inputs(info, views, layouts, secs, units, mb)
    hd = layouts[units[0][0]][units[0][1]][1]
    valid = None if masks is None else enc.block_valid_words(torch.from_numpy(masks).to(dev), mb)
    th, tw = info["tile"]
    args = (torch.from_numpy(stream).to(dev), torch.from_numpy(starts).to(dev), hd.max_z_error,
            torch.from_numpy(zmax).to(dev), th, tw, hd.n_depth, hd.dt, hd.version)
    kw = dict(mask=valid, mb=mb, n_tiles=len(units), enable_lut=True)
    return args, kw, hd, (stream.nbytes, masks is not None)


def check_k4(blob, tag):
    """Each micro-block group's K4 instance against its plain version on
    the card's and the CPU's copies of the same inputs: images bit-equal,
    flags equal. Returns {kernel: err}."""
    from lerc_tpu_torch.ops import device_decode as dec

    errs = {}
    for mb, units in sorted(k4_groups(blob).items()):
        args, kw, hd, (_nb, masked) = k4_inputs(blob, mb, units, CARD)
        cargs, ckw, _hd, _ = k4_inputs(blob, mb, units, torch.device("cpu"))
        k = dec.decode_tiles_fast(*args, **kw)
        r = dec.decode_tiles_fast(*cargs, **ckw)
        for i, (a, b) in enumerate(zip(k, r)):
            require(torch.equal(a.cpu(), b), f"K4 {k4_name(mb, masked, hd.dt)} output {i} != "
                    f"plain ({tag}, {len(units)} units)")
        errs[k4_name(mb, masked, hd.dt)] = max_abs(k[0].cpu(), r[0])
    return errs


def k4_times(blob):
    """{kernel: (device ms per launch, plain ms, bound ms)} of each micro-block
    group's K4 launch on a container's units."""
    from lerc_tpu_torch.constants import DT_SIZE
    from lerc_tpu_torch.ops import device_decode as dec

    rows = {}
    for mb, units in sorted(k4_groups(blob).items()):
        args, kw, hd, (n_bytes, masked) = k4_inputs(blob, mb, units, CARD)
        cargs, ckw, _hd, _ = k4_inputs(blob, mb, units, torch.device("cpu"))
        th, tw, d = args[4], args[5], args[6]
        n_rec = args[1].numel()
        bound = (n_bytes + 4 * n_rec + (kw["mask"].numel() * 4 if masked else 0) + 4 * d
                 * len(units) + len(units) * th * tw * d * DT_SIZE[hd.dt]) / HBM_BYTES_PER_S * 1e3
        rows[k4_name(mb, masked, hd.dt)] = (
            device_ms([lambda: dec.decode_tiles_fast(*args, **kw)], "decode_records_lut_kernel"),
            cuda_ms([lambda: dec.decode_tiles_fast(*cargs, **ckw)], reps=1), bound, len(units))
    return rows


def tiles_encode_times(t, m, mze, dt, mb):
    """Device ms per launch of the tile-batched K1 and of K2 on a tile
    group, their plain ms and bounds (as lut_kernel_times)."""
    from lerc_tpu_torch.constants import DT_SIZE, DataType
    from lerc_tpu_torch.ops import device_encode as enc

    f64 = dt == DataType.DOUBLE
    hp, wp, d = t.shape[1], t.shape[2], t.shape[3]
    n_t = t.shape[0]
    x = t.to(torch.float64 if f64 else torch.float32 if dt == DataType.FLOAT
             else torch.int32).reshape(n_t * hp, wp, d).contiguous()
    valid = enc.block_valid_words(m.reshape(n_t * hp, wp), mb)
    tile_rec = (hp // mb) * (wp // mb) * d
    if f64:
        p = enc.encode_params_f64(mze, 6)
        k1 = lambda: enc.encode_blocks_f64(x, p, valid, tile_rec)  # noqa: E731
        rk = k1()[0]
    else:
        p = enc.encode_params(mze, 6, 0, dt, mb)
        k1 = lambda: enc.encode_blocks(x, p, valid, mb, True, tile_rec)  # noqa: E731
        rk = k1()[0]
    length = rk[:, 0]
    starts = torch.cumsum(length, 0, dtype=torch.int32) - length
    total = int(length.sum())
    cap_w = (total + 4096) // 4
    if f64:
        k2 = lambda: enc.write_records_f64(x, rk, starts, cap_w, p, valid)  # noqa: E731
        k1r = lambda: enc.encode_blocks_f64_ref(x.cpu(), p, valid.cpu(), tile_rec)  # noqa: E731
    else:
        k2 = lambda: enc.write_records(x, rk, starts, cap_w, p, valid, mb, True)  # noqa: E731
        k1r = lambda: enc.encode_blocks_ref(x.cpu(), p, valid.cpu(), mb, True,  # noqa: E731
                                            tile_rec)
    bs, n_rec, size = mb * mb, rk.shape[0], DT_SIZE[dt]
    n_val = int(m.sum()) * d
    mode = (rk[:, 1] >> 8) & 3
    coded = int((((mode == 0) | (mode == 1)).sum()) * bs)
    v_bytes = valid.numel() * 4
    s = int(np.log2(bs))
    sort_ops = 0 if f64 else (bs // 2) * s * (s + 1) // 2 * 2
    k1_b = size * n_val + v_bytes + 16 * n_rec + 8 * d * n_t
    k1_o = 20 * n_val + n_rec * sort_ops * (2 if (p.diff_ok and d > 1) else 1)
    k2_b = size * coded + v_bytes + 20 * n_rec + total
    k2_o = 12 * coded + int(((rk[:, 1] >> 11) & 1).sum()) * sort_ops
    ops_rate = F64_OPS_PER_S if f64 else F32_OPS_PER_S
    k1n, k2n = k1_tiles_names(dt, mb)
    xc, rkc, stc = x.cpu(), rk.cpu(), starts.cpu()
    vc = valid.cpu()
    k2r = ((lambda: enc.write_records_f64_ref(xc, rkc, stc, cap_w, p, vc)) if f64 else
           (lambda: enc.write_records_ref(xc, rkc, stc, cap_w, p, vc, mb, True)))
    rows = {}
    for name, kf, rf, b, o, match in (
            (k1n, k1, k1r, k1_b, k1_o, "encode_blocks_f64_kernel" if f64
             else "encode_blocks_lut_kernel"),
            (k2n, k2, k2r, k2_b, k2_o, "write_records_f64_kernel" if f64
             else "write_records_lut_kernel")):
        bms, oms = b / HBM_BYTES_PER_S * 1e3, o / ops_rate * 1e3
        rows[name] = (device_ms([kf], match), cuda_ms([rf], reps=1), max(bms, oms),
                      "bytes" if bms >= oms else "operations")
    return rows


def mosaic_cell(label, raster, mask, mze, mesh, card, rounds=2, tile=MOSAIC_TILE, try_16=True,
                scanned_ok=False):
    """One mosaic cell on the card: MosaicEncoder(mesh).encode, then
    decode_mosaic_device, each counted: the batched K1/K2 of each block size
    launched (no other kernel on the encode), one K4 launch per micro-block
    group; the decode bit-equal to the per-tile decode_band_device
    (decode_mosaic; float64 both within maxZError of the input), lossless
    exact, lossy within 1.1 * maxZError at the valid pixels (0 elsewhere).
    Returns (counts, blob, encode ms, decode ms, raw MB, decode)."""
    from lerc_tpu_torch.constants import NUMPY_TO_DT, DataType, dt_is_int
    from lerc_tpu_torch.kernels import build
    from lerc_tpu_torch.parallel import sharding as S

    dt = NUMPY_TO_DT[raster.dtype]
    h, w, d = raster.shape
    enc = S.MosaicEncoder(mesh, tile, tile, raster.dtype, n_depth=d, try_16=try_16)
    mbs = (8, 16) if try_16 and dt != DataType.DOUBLE else (8,)
    need = [n for mb in mbs for n in k1_tiles_names(dt, mb)]
    counts, blob = run_counted(need, f"{label} mosaic encode", lambda: enc.encode(raster, mask,
                                                                                   mze))
    groups = k4_groups(blob)
    torch.cuda.synchronize()
    build.reset_launches()
    out = S.decode_mosaic_device(blob, mesh)
    torch.cuda.synchronize()
    dcounts = {k: n for k, n in build.LAUNCHES.items() if n}
    info, views, layouts, secs = mosaic_units(blob)
    for mb, units in groups.items():
        masked = any(not secs[u].mask.all() for u in units)
        name = k4_name(mb, masked, dt)
        require(dcounts.get(name, 0) == 1,
                f"{label}: K4 {name} launched {dcounts.get(name, 0)} times for one group")
    k4 = {k4_name(mb, m, dt) for mb in (8, 16) for m in (False, True)}
    extra = sorted(set(dcounts) - k4)
    require(scanned_ok or not extra, f"{label}: kernels {extra} launched on the indexed decode")
    for k, n in dcounts.items():
        counts[k] = counts.get(k, 0) + n
    ref = S.decode_mosaic(blob, device=CARD)
    sel = np.ones((h, w), bool) if mask is None else mask
    err = float(np.abs(out.astype(np.float64) - raster.astype(np.float64))[sel].max())
    if dt == DataType.DOUBLE:
        require(float(np.abs(ref - raster)[sel].max()) <= mze, f"{label}: per-tile decode error")
        require(err <= mze, f"{label}: decode error {err} > maxZError")
    else:
        require(np.array_equal(out, ref), f"{label}: decode != the per-tile decode_band_device")
        require(err <= (0 if dt_is_int(dt) else 1.1 * mze), f"{label}: decode error {err}")
    require((out[~sel] == 0).all(), f"{label}: invalid pixels not 0")
    enc_ms = min(_wall_ms(lambda: enc.encode(raster, mask, mze)) for _ in range(rounds))
    dec_ms = min(_wall_ms(lambda: S.decode_mosaic_device(blob, mesh)) for _ in range(rounds))
    raw_mb = raster.nbytes / 1e6
    ty, tx = info["grid"]
    n16 = sum(1 for lay in layouts for _b, hd in lay if hd.micro_block_size == 16)
    print(f"mosaic cell {label}: {ty}x{tx} tiles of {tile}^2, {len(blob)} B (ratio "
          f"{raster.nbytes / len(blob):.4f}), {n16} tiles of 16x16 blocks, K4 groups "
          f"{ {mb: len(u) for mb, u in groups.items()} }, max error {err}; encode {enc_ms:.1f} ms "
          f"({raw_mb / enc_ms * 1e3:.1f} MB/s), decode {dec_ms:.1f} ms "
          f"({raw_mb / dec_ms * 1e3:.1f} MB/s) [{card}]", flush=True)
    return counts, blob, enc_ms, dec_ms, raw_mb, out


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mosaic_phases(tiles, mask, card, launches, add_row):
    """Phases 23-26: the tile mosaic on a one-rank NCCL DeviceMesh."""
    import torch.distributed as dist

    from lerc_tpu_torch.parallel import sharding as S

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        _mosaic_phases(S.make_mesh(1), tiles, mask, card, launches, add_row)
    finally:
        dist.destroy_process_group()


def _mosaic_phases(mesh, tiles, mask, card, launches, add_row):
    from lerc_tpu_torch.constants import NUMPY_TO_DT
    from lerc_tpu_torch.parallel import sharding as S

    err = {}

    def merge(e):
        for k, x in e.items():
            err[k] = max(err.get(k, 0.0), x)

    def count(c):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n

    dem = raster_of(tiles)
    mmask = np.tile(mask, (2, 2))  # the bench mask on each 2048^2 quarter, as bench.py
    grid16 = raster_of([class_grid(t) for t in tiles])
    u8x3 = raster_of(int_cell_tiles(tiles, np.uint8, 3))
    dem64 = raster_of(make_tiles64(N_TILES, TILE, tiles[0].device))
    print(f"mosaic: one-rank DeviceMesh {mesh}; rasters {dem.shape} float32, "
          f"{grid16.shape} uint16, {u8x3.shape} uint8, {dem64.shape} float64", flush=True)

    # ---- 23. the tile-batched K1/K2 and K4 against their plain versions
    timing = {}
    for raster, m, mze, mbs, tag in ((dem, None, MAX_Z_ERROR, (8, 16), "DEM"),
                                     (dem, mmask, MAX_Z_ERROR, (8, 16), "DEM, bench mask"),
                                     (grid16, None, 0.5, (8, 16), "uint16 class grid"),
                                     (u8x3, None, 0.5, (8,), "uint8 x3"),
                                     (dem64, None, MAX_Z_ERROR, (8,), "float64 DEM")):
        names = []
        for mb in mbs:
            e, ins = check_tiles_encode(raster, m, mze, mb, tag)
            merge(e)
            names += sorted(e)
            timing.setdefault(k1_tiles_names(NUMPY_TO_DT[raster.dtype], mb)[0], ins)
        print(f"check: the tile-batched K1/K2 ({', '.join(names)}) equal to their plain "
              f"versions on all {ins[0].shape[0]} {MOSAIC_TILE}^2 tiles of the {tag} (blocks "
              f"{mbs})", flush=True)

    # ---- 24. the cells, counted
    cells = {}
    cells["dem"] = mosaic_cell(f"float32 DEM {2 * TILE}^2, maxZError {MAX_Z_ERROR}", dem, None,
                               MAX_Z_ERROR, mesh, card)
    cells["dem_mask"] = mosaic_cell(f"float32 DEM {2 * TILE}^2 with the bench mask, maxZError "
                                    f"{MAX_Z_ERROR}", dem, mmask, MAX_Z_ERROR, mesh, card)
    cells["grid"] = mosaic_cell(f"uint16 class grid {2 * TILE}^2, lossless", grid16, None, 0.5, mesh,
                                card)
    n16 = len(k4_groups(cells["grid"][1]).get(16, []))
    n_lut = lut_records(cells["grid"][1])
    print(f"mosaic: the class grid has {n16} tiles of 16x16 blocks and {n_lut} LUT records",
          flush=True)
    if not n16:  # test_mosaic_16x16_tiles_device_decode's raster at 512^2 tiles
        rng = np.random.default_rng(3)
        quads = np.full((1024, 1024, 1), 100.0, np.float32)
        for r0 in range(0, 1024, MOSAIC_TILE):
            for c0 in range(0, 1024, MOSAIC_TILE):
                quads[r0:r0 + 16, c0:c0 + 16, 0] += rng.integers(0, 2, (16, 16))
        cells["quads"] = mosaic_cell("float32 16x16 noise quads 1024^2", quads, None, 0.5, mesh,
                                     card)
        require(len(k4_groups(cells["quads"][1]).get(16, [])) > 0, "no 16x16 tiles")
    if not n_lut:  # test_mosaic_lut_tiles_device_decode's raster at 512^2 tiles
        rng = np.random.default_rng(11)
        base = rng.integers(0, 40, (128, 128)).astype(np.float32) * 500
        lut = np.repeat(np.repeat(base, 8, 0), 8, 1)[:, :, None] + rng.choice(
            [0, 200.0, 450.0], (1024, 1024, 1), p=[0.8, 0.1, 0.1]).astype(np.float32)
        cells["lut"] = mosaic_cell("float32 LUT raster 1024^2", lut, None, 0.001, mesh, card,
                                   try_16=False)
        require(lut_records(cells["lut"][1]) > 0, "no LUT records")
    cells["u8x3"] = mosaic_cell(f"uint8 three-band {2 * TILE}^2 (depth-diff), lossless", u8x3, None, 0.5,
                                mesh, card, scanned_ok=True)
    n_k6 = cells["u8x3"][0].get("decode_scanned_u8", 0)
    require(n_k6 > 0, "the depth-diff cell sent no unit to the scanned decode")
    print(f"mosaic: {n_k6} depth-diff units of the uint8 three-band cell went through K6 "
          f"(decode_band_device), the others through K4", flush=True)
    cells["f64"] = mosaic_cell(f"float64 DEM {2 * TILE}^2, maxZError {MAX_Z_ERROR}", dem64, None,
                               MAX_Z_ERROR, mesh, card, scanned_ok=True)
    for c in cells.values():
        count(c[0])

    # ---- 25. region decodes and decode_mosaic of four tiles
    from lerc_tpu_torch.kernels import build

    blob, full = cells["dem"][1], cells["dem"][5]
    for (r0, r1, c0, c1), what in (((600, 700, 600, 700), "inside one tile"),
                                   ((400, 700, 400, 700), "over 2x2 tiles")):
        c, reg = run_counted(["decode_records_lut"], f"region {what}",
                             lambda: S.decode_mosaic_region(blob, r0, r1, c0, c1, device=CARD))
        require(c.get("decode_records_lut") == 1, "a region decode took more than one K4 launch")
        require(np.array_equal(reg, full[r0:r1, c0:c1]), f"region {what} != the full decode")
        count(c)
        print(f"check: decode_mosaic_region {what} ({r0}:{r1}, {c0}:{c1}) equal to the full "
              f"decode, one K4 launch", flush=True)
    four = dem[:1024, :1024]
    blob4 = S.MosaicEncoder(mesh, MOSAIC_TILE, MOSAIC_TILE, np.float32).encode(four, None,
                                                                              MAX_Z_ERROR)
    c, out4 = run_counted_band(["fletcher32_parts", "tile_scan", "decode_scanned"],
                               ["decode_scanned16"], "decode_mosaic of four tiles",
                               lambda: S.decode_mosaic(blob4, device=CARD))
    count(c)
    require(np.array_equal(out4, S.decode_mosaic_device(blob4, mesh)),
            "decode_mosaic != decode_mosaic_device on four tiles")
    print("check: decode_mosaic of four 512^2 tiles (K3, the host scanner, K6) equal to "
          "decode_mosaic_device", flush=True)
    build.reset_launches()

    # ---- K4 against its plain version on each cell's groups
    for key, c in cells.items():
        merge(check_k4(c[1], key))
    print(f"check: K4 ({', '.join(sorted(k for k in err if k.startswith('decode_records_lut')))}) "
          f"equal to its plain version on every cell's micro-block groups", flush=True)

    # ---- 26. times
    for name, ins in timing.items():
        n_t = ins[0].shape[0]
        for kname, (ms, plain_ms, bound_ms, bound_by) in tiles_encode_times(*ins).items():
            if kname.startswith("encode_tiles"):
                add_row(kname, err.get(kname, 0.0), ms, plain_ms, bound_ms, bound_by, None)
            print(f"kernel {kname} (tile-batched) on {n_t} {MOSAIC_TILE}^2 tiles: {ms:.4f} "
                  f"ms/launch (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}) "
                  f"[{card}]", flush=True)
    done = set()
    for key, c in cells.items():
        for kname, (ms, plain_ms, bound_ms, n_units) in k4_times(c[1]).items():
            if kname in done:
                continue
            done.add(kname)
            print(f"K4 {kname}: one launch over {n_units} units of the {key} cell", flush=True)
            add_row(kname, err.get(kname, 0.0), ms, plain_ms, bound_ms, "bytes", None)
    c = cells["dem"]

    def one_round():
        blob = S.MosaicEncoder(mesh, MOSAIC_TILE, MOSAIC_TILE, np.float32).encode(
            dem, None, MAX_Z_ERROR)
        S.decode_mosaic_device(blob, mesh)

    where_the_time_goes(None, None, c[2] + c[3], card,
                        "mosaic DEM cell, MosaicEncoder.encode + decode_mosaic_device",
                        round_fn=one_round)

# ---------------------------------------------------------------------------
# 27. the public API; 28. the Pallas probes
# ---------------------------------------------------------------------------


def _counts_of(fn):
    """(launch counts of fn(), fn's result), every count at 0 before it."""
    from lerc_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return {k: n for k, n in build.LAUNCHES.items() if n}, out


def _band_blobs(blob):
    """A multi-band blob -> its band blobs (the header's blob sizes)."""
    from lerc_tpu_torch.codec.orchestrator import get_lerc_info

    info = get_lerc_info(blob)
    ends = info.band_offsets[1:] + [info.blob_size]
    return [blob[a:b] for a, b in zip(info.band_offsets, ends)]


def _host_result(blob):
    """The host codec's decode of a blob (acceleration off)."""
    from lerc_tpu_torch.codec import encode_orchestrator as E
    from lerc_tpu_torch.codec import orchestrator as O

    E.set_acceleration(False)
    try:
        return O.decode_blob(blob, device="cpu")
    finally:
        E.set_acceleration(None)


def _bits_np(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.itemsize]) if a.dtype.kind == "f" else a


def api_case(label, encode, decode, data, masks, mze, routed, nodata=None):
    """One API case, counted. encode() -> blob, decode(blob) -> (data
    [nBands, H, W, D], masks [nBands, H, W]). data [nBands, H, W, D] and
    masks ([nBands or 1, H, W] or None) are the inputs. routed: whether the
    bands go to the band codec on encode (decode routes by the blob). The
    encode launches exactly what encode_band_device launches on the same
    bands (nothing on the host route), the decode what decode_band_device
    launches on the routed bands; routed bands' bytes equal
    encode_band_device's; the decode is bit-equal to the host codec's and
    within maxZError at the valid pixels (noData pixels exact). Returns
    (blob, its decode, encode counts, decode counts)."""
    from lerc_tpu_torch import decode_band_device, encode_band_device
    from lerc_tpu_torch.codec import header as hdr
    from lerc_tpu_torch.codec import lerc2_decode
    from lerc_tpu_torch.codec.orchestrator import _routed_to_device

    enc_counts, blob = _counts_of(encode)
    bands = _band_blobs(blob)
    n_bands = data.shape[0]
    require(len(bands) == n_bands, f"{label}: {len(bands)} bands, {n_bands} given")
    mk = [None if masks is None else masks[min(i, masks.shape[0] - 1)] for i in range(n_bands)]
    if routed:
        def direct():
            return [encode_band_device(data[i], mk[i], mze, 6, i == 0, n_blobs_more=n_bands - 1 - i)
                    for i in range(n_bands)]  # one mask, shared: sent with band 1 only
        want_counts, want = _counts_of(direct)
        require(want == bands, f"{label}: a routed band's bytes differ from encode_band_device's")
        require(want_counts and enc_counts == want_counts,
                f"{label}: API encode launched {enc_counts}, encode_band_device {want_counts}")
    else:
        require(not enc_counts, f"{label}: the host encode launched {enc_counts}")
    dec_counts, (got, got_masks) = _counts_of(lambda: decode(blob))

    def direct_decode():
        prev = None
        for b in bands:
            if _routed_to_device(memoryview(b), data.shape[1] * data.shape[2]):
                prev = decode_band_device(b, prev).mask
            else:
                prev = lerc2_decode.decode_band(b, prev).mask
    want_counts, _ = _counts_of(direct_decode)
    require(dec_counts == want_counts,
            f"{label}: API decode launched {dec_counts}, decode_band_device {want_counts}")
    host = _host_result(blob)
    require(np.array_equal(_bits_np(got), _bits_np(host.data)),
            f"{label}: decode differs from the host codec's")
    require(np.array_equal(got_masks, host.masks), f"{label}: masks differ from the host codec's")
    for i, b in enumerate(bands):
        head, _ = hdr.read_header(memoryview(b))
        valid = np.broadcast_to(host.masks[i][:, :, None], data[i].shape).copy()
        valid &= ~np.isnan(data[i].astype(np.float64))
        x = data[i].astype(np.float64)
        if nodata is not None:
            nd = valid & (x == nodata)
            require(np.array_equal(got[i][nd], data[i][nd]), f"{label}: noData values lost")
            valid &= ~nd
        err = float(np.abs(got[i].astype(np.float64) - x)[valid].max()) if valid.any() else 0.0
        require(err <= head.max_z_error * 1.1 + 1e-12,
                f"{label}: band {i} error {err} over maxZError {head.max_z_error}")
    return blob, (got, got_masks), enc_counts, dec_counts


def api_phase(tiles, mask, card):
    """Phase 27: the public API on the card."""
    import lerc_tpu_torch as lerc
    from lerc_tpu_torch.codec.encode_orchestrator import filter_no_data_and_nan

    dem = raster_of(tiles)[:, :, 0]  # [4096, 4096] float32
    mask4 = np.tile(mask, (2, 2))
    raw_mb = dem.nbytes / 1e6

    def unsqueeze(arr, m):
        return arr[None, :, :, None], None if m is None else m[None]

    for label, m in (("DEM all-valid", None), ("DEM masked", mask4)):
        blob, _, enc_c, dec_c = api_case(
            f"API {label}", lambda m=m: lerc.encode(dem, 1, m is not None, m, MAX_Z_ERROR, 1)[2],
            lambda b: (lambda r: (r[1][None, :, :, None], np.ones((1,) + dem.shape, bool)
                                  if r[2] is None else r[2][None]))(lerc.decode(b)),
            *unsqueeze(dem, m), MAX_Z_ERROR, True)
        cblob = lerc.compress(dem, MAX_Z_ERROR, m)
        require(cblob == blob, f"API {label}: compress differs from encode")
        cdata, _cmask = lerc.decompress(cblob)
        require(np.array_equal(_bits_np(cdata), _bits_np(lerc.decode(blob)[1])),
                f"API {label}: decompress differs from decode")

        def timed(fn):
            best = float("inf")
            for _ in range(3):
                best = min(best, _wall_ms(fn))
            return best

        enc_ms = timed(lambda: lerc.encode(dem, 1, m is not None, m, MAX_Z_ERROR, 1))
        dec_ms = timed(lambda: lerc.decode(blob))
        print(f"API {label} ({dem.shape[0]}^2 float32, one band, maxZError {MAX_Z_ERROR}): encode "
              f"{raw_mb / (enc_ms / 1e3):.1f} MB/s ({enc_ms:.3f} ms), decode "
              f"{raw_mb / (dec_ms / 1e3):.1f} MB/s ({dec_ms:.3f} ms), ratio "
              f"{dem.nbytes / len(blob):.4f}; launches encode {enc_c}, decode {dec_c} [{card}]",
              flush=True)
    filt = []
    for _ in range(3):
        band, mm = dem[:, :, None].copy(), np.ones(dem.shape, bool)
        t0 = time.perf_counter()
        filter_no_data_and_nan(band, mm, MAX_Z_ERROR, False, 0.0)
        filt.append((time.perf_counter() - t0) * 1e3)
    print(f"API host filter_no_data_and_nan on the {dem.shape[0]}^2 DEM: {min(filt):.3f} ms (best of 3; "
          f"part of every float32 encode at v6) [{card}]", flush=True)

    # a uint8 three-band image, one shared mask: bands 2-3 carry no mask section
    crop = (slice(280, 792), slice(480, 992))  # 512^2 over a corner of the bench hole
    u8 = int_cell_tiles(tiles[:1], np.uint8, 3)[0][crop].permute(2, 0, 1).cpu().numpy().copy()
    m512 = mask[crop]
    blob, _, enc_c, dec_c = api_case(
        "API uint8 x 3 bands, shared mask", lambda: lerc.encode(u8, 1, True, m512, 0, 1)[2],
        lambda b: (lambda r: (r[1][:, :, :, None], np.broadcast_to(r[2], u8.shape)))(lerc.decode(b)),
        u8[:, :, :, None], m512[None], 0, True)
    from lerc_tpu_torch.codec import header as hdr
    sizes = []
    for b in _band_blobs(blob):
        _, pos = hdr.read_header(memoryview(b))
        sizes.append(int.from_bytes(b[pos:pos + 4], "little"))
    require(sizes[0] > 0 and sizes[1:] == [0, 0],
            f"API uint8 x 3: mask sections {sizes}, want one for band 1 only")
    print(f"API uint8 x 3 bands 512^2, shared mask: mask sections {sizes} B, blob {len(blob)} B, "
          f"launches encode {enc_c}, decode {dec_c} [{card}]", flush=True)

    # uint32 across 2^31 (repair P6), routed at maxZError 2: blocks below,
    # across and above 2^31, and blocks of values near 0 and near 2^32 (raw)
    rng = np.random.default_rng(9)
    u32 = (2**31 - 600 + rng.integers(0, 1000, (512, 512))).astype(np.uint32)
    u32[:, 256:] += 1000
    u32[:64:2, :64], u32[1:64:2, :64] = 5, 2**32 - 5
    blob, _, enc_c, dec_c = api_case(
        "API uint32 across 2^31", lambda: lerc.encode(u32, 1, False, None, 2.0, 1)[2],
        lambda b: (lerc.decode(b)[1][None, :, :, None], np.ones((1, 512, 512), bool)),
        u32[None, :, :, None], None, 2.0, True)
    print(f"API uint32 512^2 across 2^31, maxZError 2: blob {len(blob)} B, launches encode "
          f"{enc_c}, decode {dec_c} [{card}]", flush=True)
    # masked uint16 / uint32 bands of random values go one-sweep (the valid
    # values raw; CUDA has no uint16/uint32 boolean index): the card's blob
    # equals the plain version's and the host decoder reads it exactly
    from lerc_tpu_torch import encode_band_device
    from lerc_tpu_torch.codec import lerc2_decode
    for npdt in (np.uint16, np.uint32):
        a = rng.integers(0, np.iinfo(npdt).max, (24, 19, 1), dtype=np.uint64).astype(npdt)
        mk = rng.random((24, 19)) > 0.3
        b = encode_band_device(a, mk, 0.5, device="cuda")
        require(b == encode_band_device(a, mk, 0.5, device="cpu")
                and np.array_equal(lerc2_decode.decode_band(b).data[mk], a[mk]),
                f"API one-sweep {np.dtype(npdt).name} band")

    # float32 with NaN holes and a noData value (noData in one slice: header fields, host encode)
    x = np.stack([dem[:1024, :1024], dem[:1024, :1024] + 1.5], -1).copy()
    rng = np.random.default_rng(7)
    x[200:260, 300:420, :] = np.nan
    x[rng.random((1024, 1024)) > 0.995, 0] = -9999.0
    nd = np.ma.array([-9999.0], mask=[False])
    blob, _, enc_c, dec_c = api_case(
        "API float32 NaN + noData (encode_4D)",
        lambda: lerc.encode_4D(x, 2, None, 0.01, 1, nd)[2],
        lambda b: (lambda r: (r[1][None], np.broadcast_to(r[2], (1, 1024, 1024))))(
            lerc.decode_4D(b)), x[None], None, 0.01, False, nodata=-9999.0)
    print(f"API float32 1024^2 x 2 with NaN holes and noData: host encode, blob {len(blob)} B, "
          f"launches decode {dec_c} [{card}]", flush=True)

    # v5 and v2 encodes of a 512^2 crop: host encodes; v5 decodes on the card, v2 on the host
    c512 = dem[:512, :512].copy()
    for v in (5, 2):
        blob, _, enc_c, dec_c = api_case(
            f"API v{v} 512^2", lambda v=v: lerc.encodeForVersion(c512, v, 1, False, None,
                                                                 MAX_Z_ERROR, 1)[2],
            lambda b: (lambda r: (r[1][None, :, :, None], np.ones((1, 512, 512), bool)))(
                lerc.decode(b)), c512[None, :, :, None], None, MAX_Z_ERROR, False)
        require(bool(dec_c) == (v >= 3), f"API v{v}: decode launches {dec_c}")
        print(f"API v{v} 512^2 float32: host encode, blob {len(blob)} B, decode launches "
              f"{dec_c} [{card}]", flush=True)


def probe_phase(card, add_row, launches):
    """Phase 28: Q1-Q3 at the probe's shapes, counted, held to their plain
    versions on the same CUDA tensors, timed."""
    from lerc_tpu_torch.ops import probes as P

    names = {"write": "probe_write", "window": "probe_window", "asm": "probe_asm"}
    inputs = P.probe_inputs(torch.device("cuda"))
    counts, outs = run_counted(tuple(names.values()), "probe path", lambda: P.run_probes(inputs))
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    lanes = P.LANES
    n = inputs["window"][0].numel()
    nbytes = {  # each input read once, each output written once
        "write": 512 * 4 + 1024 * lanes * 4 + P.WRITE_ROWS * lanes * 4,
        "window": n * 4 + 1024 * lanes * 4 + 2 * n * lanes * 4,
        # the last program's slabs and offsets reach the output; JAX's kernel reads all 67 MB
        "asm": P.PROGRAM * 4 + 2 * P.PROGRAM * lanes * 4 + P.ASM_ROWS * lanes * 4,
    }
    match = {"write": "slab_accumulate<false>", "window": "window_kernel",
             "asm": "slab_accumulate<true>"}
    for key, got in outs.items():
        kernel, plain = P.CALLS[key]
        args = inputs[key]
        want = plain(*args)
        err = float((P._i64(got) - P._i64(want)).abs().max())
        require(err == 0, f"{names[key]}: differs from its plain version by {err}")
        ms = device_ms([lambda: kernel(*args)], match[key])
        plain_ms = cuda_ms([lambda: plain(*args)])
        library_ms = None
        if key == "write":
            offs, vals = args
            rows = (offs.to(torch.int64)[:, None] + torch.arange(2, device=offs.device)).reshape(-1)
            library_ms = cuda_ms([lambda: torch.zeros(P.WRITE_ROWS, lanes, dtype=torch.int32,
                                                      device=offs.device).index_add_(0, rows, vals)])
        add_row(names[key], err, ms, plain_ms, nbytes[key] / HBM_BYTES_PER_S * 1e3, "bytes",
                library_ms)
    print(f"probes Q1-Q3 at the probe's shapes: equal to their plain versions, launches {counts}"
          f" [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    from lerc_tpu_torch import FusedResidentCodec
    from lerc_tpu_torch.kernels import build

    # ---- 1. the card
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda")

    # ---- 2. build
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {len(reports)} sources compiled in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS[:2])} --fmad=false)", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 3. each kernel against its plain version
    tiles = make_tiles(N_TILES, TILE, dev)
    mask = bench_mask()
    crop = (slice(280, 344), slice(480, 544))  # a corner of the bench mask's hole
    small = [tiles[0][:64, :64].contiguous()]
    small_masked = [tiles[0][crop].contiguous()]
    for nb_cap in (0, 16):
        for shape_tiles, m in ((small, None), (tiles[:1], None),
                               (small_masked, mask[crop]), (tiles[:1], mask)):
            h, w, _ = shape_tiles[0].shape
            codec = FusedResidentCodec(h, w, 1, np.float32, MAX_Z_ERROR, nb_cap=nb_cap, mask=m)
            check_kernels(codec, shape_tiles, timed=False)
            which = "K1-K4" if m is None else "K1m, K2m, K3, K4m (masked)"
            print(f"check: {which} equal to their plain versions at {h}x{w}, nb_cap={nb_cap}",
                  flush=True)
    for name, data, mze, nb_cap in edge_tiles():
        h, w, d = data.shape
        codec = FusedResidentCodec(h, w, d, np.float32, mze, nb_cap=nb_cap)
        check_kernels(codec, [torch.from_numpy(data).to(dev)], timed=False)
        print(f"check: K1-K4 equal to their plain versions on the {name} tile "
              f"({h}x{w}x{d}, maxZError {mze}, nb_cap={nb_cap})", flush=True)
    for name, data, m, mze, nb_cap in masked_edge_tiles():
        h, w, d = data.shape
        args = (h, w, d, np.float32, mze)
        codec = FusedResidentCodec(*args, nb_cap=nb_cap, mask=m)
        plain = FusedResidentCodec(*args, nb_cap=nb_cap, mask=m, device="cpu")
        tile = torch.from_numpy(data).to(dev)
        check_kernels(codec, [tile], timed=False)
        out = codec.encode_fast(tile)
        dec = codec.decode_fast(out[0], out[1], out[3])
        if int(out[2][2]):
            check_blobs(codec, plain, [tile], [out], [dec], m, f"masked {name} tile")
            how = "decode ok, blob equal to the plain path's"
        else:  # a raw or wider record under a bit cap: the caller re-encodes uncapped
            require(nb_cap > 0 and not bool(dec[1]), f"masked {name} tile: unfit but decoded ok")
            how = "does not fit the cap, decode not ok, as with the JAX encoder"
        print(f"check: K1m, K2m, K3, K4m equal to their plain versions on the masked {name} "
              f"tile ({h}x{w}x{d}, {int(m.sum())} valid, maxZError {mze}, nb_cap={nb_cap}); "
              f"{how}", flush=True)

    # ---- 3b. K5, K6 and the integer instances against their plain versions
    for nb_cap in (0, 16):
        for t in (small[0], tiles[0]):
            h, w, _ = t.shape
            codec = FusedResidentCodec(h, w, 1, np.float32, MAX_Z_ERROR, nb_cap=nb_cap)
            header, stream, meta, _ = codec.encode_fast(t)
            check_scan(stream, meta[0].reshape(1), codec.n_rec, codec.dt, codec.version,
                       codec.mze, codec._zmax_vec(header), (h, w, 1))
            print(f"check: K5 (3 kernels) and K6 equal to their plain versions on the float32 "
                  f"{h}x{w} stream, nb_cap={nb_cap}", flush=True)
    for name, data, mze, nb_cap in edge_tiles():
        h, w, d = data.shape
        codec = FusedResidentCodec(h, w, d, np.float32, mze, nb_cap=nb_cap)
        header, stream, meta, _ = codec.encode_fast(torch.from_numpy(data).to(dev))
        if not int(meta[2]):  # an unfit capped stream is invalid by contract
            continue
        check_scan(stream, meta[0].reshape(1), codec.n_rec, codec.dt, codec.version, codec.mze,
                   codec._zmax_vec(header), (h, w, d))
        print(f"check: K5 and K6 equal to their plain versions on the {name} tile "
              f"({h}x{w}x{d}, maxZError {mze}, nb_cap={nb_cap})", flush=True)
    for npdt, d, mze, version, nb_cap, masked in int_edge_configs():
        m = hole_speckle(64, 64, np.random.default_rng(3)) if masked else None
        codec = FusedResidentCodec(64, 64, d, npdt, mze, version, nb_cap, mask=m)
        tile = torch.from_numpy(int_tile_small(npdt, 64, 64, d)).to(dev)
        err, _ = check_int_kernels(codec, [tile])
        print(f"check: {', '.join(sorted(err))} equal to their plain versions on the 64x64x{d} "
              f"{np.dtype(npdt).name} tile (maxZError {mze}, v{version}, nb_cap={nb_cap}"
              f"{', masked' if masked else ''})", flush=True)

    # ---- 4, 5. the main paths, counted, then timed
    launches, results = main_path(tiles, None, card)
    m_launches, m_results = main_path(tiles, mask, card)
    f_launches, f_results, (fcodec, fouts) = index_free_path(tiles, card)
    cells = [int_cell(label, npdt, d, mze, tiles, card) for label, npdt, d, mze in INT_CELLS]
    for counts in (m_launches, f_launches, *(c[0] for c in cells)):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    kernels = []

    def add_row(name, err, ms, plain_ms, bound_ms, bound_by, library_ms=None):
        lib = "" if library_ms is None else f", library call {library_ms:.4f} ms"
        print(f"kernel {name}: {ms:.4f} ms/launch (plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of bound{lib}, "
              f"{launches.get(name, 0)} launches on the paths) [{card}]")
        src, replaces = SOURCES[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches.get(name, 0), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))

    for m, res in ((None, results), (mask, m_results)):
        codec = FusedResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR, mask=m)
        err, (times, scan_ms, ins) = check_kernels(codec, tiles, timed=True)
        bnd = bounds(codec, ins)
        for name, (ms, plain_ms) in times.items():
            add_row(name, err[name], ms, plain_ms, *bnd[name])
        label = "all-valid" if m is None else "masked"
        print(f"exclusive scan torch.cumsum (65536 int32 lengths, {label}): {scan_ms:.4f} ms/tile "
              f"[{card}]")
        where_the_time_goes(codec, tiles, sum(res[0][3:]), card, label)

    # K5 and K6: the float32 index-free path at nb_cap 0, then each integer cell
    sets = [(o[1], o[2][0].reshape(1), fcodec._zmax_vec(o[0])) for o in fouts]
    scan_err = {}
    for s, t, z in sets:
        e, _ = check_scan(s, t, fcodec.n_rec, fcodec.dt, fcodec.version, fcodec.mze, z,
                          (TILE, TILE, 1))
        for k, x in e.items():
            scan_err[k] = max(scan_err.get(k, 0.0), x)
    per, plain, steps = timed_scan_kernels(sets, fcodec.dt, fcodec.version, fcodec.mze,
                                           (TILE, TILE, 1))
    bnd = scan_bounds([int(o[2][0]) for o in fouts], (TILE, TILE, 1), 4, steps)
    for name in (*SCAN, "decode_scanned"):
        b = bnd["K6"] if name == "decode_scanned" else bnd[name]
        add_row(name, scan_err[name], per[name], plain[name], b, "bytes")
    k5_ms = per[SCAN[0]] + steps * per[SCAN[1]] + per[SCAN[2]]
    print(f"K5 scan_records, whole (sizes + {steps} doubling steps + describe) on a {TILE}^2 "
          f"float32 tile at nb_cap 0: {k5_ms:.4f} ms (bound {bnd['K5']:.4f} ms by bytes: "
          f"stream read once, 9 descriptor fields written) [{card}]")
    where_the_time_goes(fcodec, tiles, f_results[0][2], card, "index-free decode, float32",
                        round_fn=lambda: [fcodec.decode_fast(o[0], o[1]) for o in fouts])
    for _counts, codec, ctiles, _outs, round_ms in cells:
        err, ins = check_int_kernels(codec, ctiles)
        h, w, d = ctiles[0].shape
        for name, (ms, plain_ms, bound_ms, bound_by) in int_kernel_times(codec, ctiles,
                                                                          ins).items():
            add_row(name, err[name], ms, plain_ms, bound_ms, bound_by)
        sets = [(k["stream"], k["total"], k["zmax"]) for k in ins]
        per, plain, steps = timed_scan_kernels(sets, codec.dt, codec.version, codec.mze, (h, w, d))
        size = ctiles[0].element_size()
        bnd = scan_bounds([int(k["total"]) for k in ins], (h, w, d), size, steps)
        k6 = int_name("decode_scanned", codec.dt)
        add_row(k6, err[k6], per[k6], plain[k6], bnd["K6"], "bytes")
        print(f"K5 on the {h}x{w}x{d} {codec.dt.name} cell: sizes {per[SCAN[0]]:.4f}, doubling "
              f"{per[SCAN[1]]:.4f} x {steps}, describe {per[SCAN[2]]:.4f} ms/launch (bounds "
              f"{bnd[SCAN[0]]:.4f}, {bnd[SCAN[1]]:.4f}, {bnd[SCAN[2]]:.4f} ms; whole scan "
              f"{bnd['K5']:.4f} ms) [{card}]")
        where_the_time_goes(
            codec, ctiles, round_ms, card, f"{codec.dt.name} x {d} cell, encode + index-free decode",
            round_fn=lambda c=codec, ts=ctiles: [c.decode_fast(*c.encode_fast(t)[:2]) for t in ts])

    # ---- 7-13. the band codec
    band_phases(tiles, mask, card, launches, add_row, {k["name"] for k in kernels})
    # ---- 14-16. 8-bit whole-image Huffman through the band codec
    huffman_phases(tiles, mask, card, launches, add_row)
    # ---- 17-19. lossless float32 (fpl) through the band codec
    fpl_phases(tiles, mask, card, launches, add_row)
    # ---- 20-22. float64 through the band codec
    f64_phases(dev, mask, card, launches, add_row)
    # ---- 23-26. the tile mosaic on a one-rank NCCL DeviceMesh
    mosaic_phases(tiles, mask, card, launches, add_row)
    # ---- 27. the public API
    t0 = time.perf_counter()
    api_phase(tiles, mask, card)
    # ---- 28. the Pallas probes Q1-Q3
    probe_phase(card, add_row, launches)
    print(f"phases 27-28: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
