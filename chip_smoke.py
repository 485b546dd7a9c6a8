#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lerc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from the sources in this checkout (nvcc, parallel);
  3. hold each kernel (K1 encode_blocks, K2 write_records, K3
     fletcher32_parts, K4 decode_records, and the masked K1m
     encode_blocks_masked, K2m write_records_masked, K4m
     decode_records_masked) against its plain PyTorch version on the same
     CUDA tensors, at 64x64, at 2048x2048 and on small edge tiles: outputs
     must be equal (bytes, starts, flags; images bit-equal);
  4. the main path: FusedResidentCodec on the bench's 4096^2 float32 DEM as
     four 2048^2 tiles at maxZError 0.001, nb_cap 0 and 16 (bench.py:209-298),
     all-valid and then with the bench's mask (a 500x1000 hole plus 2%
     speckle, bench.py:242-298) on every tile: encode_fast, decode_fast with
     the record index, ok True, max error over the valid pixels <= 1.1 *
     maxZError, invalid pixels +0.0, each blob byte-equal to the plain
     path's (device="cpu"), each header parsed by read_header with its
     valid-pixel count; launch counts show every kernel of each path ran on
     it and no kernel of the other path did;
  5. timings: encode/decode MB/s of the whole DEM (CUDA events; the masked
     pass counts the full tiles' raw bytes, as bench.py:295), the
     compression ratio, each kernel's device time per launch
     (torch.profiler) beside its plain version's time (CUDA events) and
     its bound;
  6. where the time goes: device time per encode + decode round by
     kernel, and the device's busy and idle shares, for each path.
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


def device_ms(fns, match=None, reps=5):
    """Mean device ms per call of fns from torch.profiler: the time of the
    kernels whose name contains `match` (all kernels when None), free of the
    host's launch overhead. Calls round-robin as cuda_ms."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for f in fns:
                f()
        torch.cuda.synchronize()
    rows = [r for r in _kernel_rows(prof) if match is None or match in r[0]]
    require(rows, f"profiler shows no device time for {match or 'the calls'}")
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


def where_the_time_goes(codec, tiles, round_ms, card, label, rounds=3):
    """Phase 6: torch.profiler over `rounds` encode + decode rounds of a
    main path (nb_cap 0). Prints the device time per round by operator and
    its share of `round_ms`, the unprofiled CUDA-event time of one round;
    the rest is the device waiting on the host."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            outs = [codec.encode_fast(t) for t in tiles]
            [codec.decode_fast(o[0], o[1], o[3]) for o in outs]
        torch.cuda.synchronize()
    rows = [(us / rounds / 1e3, n // rounds, key) for key, n, us in _kernel_rows(prof)]
    if not rows:
        print("profile: no device time in the trace (not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile ({label}): device busy {busy:.4f} ms of {round_ms:.4f} ms per encode+decode "
          f"round of the 4096^2 DEM ({busy / round_ms:.1%} busy, {1 - busy / round_ms:.1%} idle) "
          f"[{card}]")
    for ms, n, name in rows[:10]:
        print(f"  profile ({label}): {ms:.4f} ms/round  {n:4d} calls/round  {name[:70]}")


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

    # ---- 4, 5. the main paths, counted, then timed
    launches, results = main_path(tiles, None, card)
    m_launches, m_results = main_path(tiles, mask, card)
    for name, n in m_launches.items():
        launches[name] = launches.get(name, 0) + n

    kernels = []
    for m, res in ((None, results), (mask, m_results)):
        codec = FusedResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR, mask=m)
        err, (times, scan_ms, ins) = check_kernels(codec, tiles, timed=True)
        bnd = bounds(codec, ins)
        for name, (ms, plain_ms) in times.items():
            bound_ms, bound_by = bnd[name]
            print(f"kernel {name}: {ms:.4f} ms/tile (plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of bound) [{card}]")
            src, replaces = SOURCES[name]
            kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                                launches=launches[name], max_abs_err=err[name], ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None))
        label = "all-valid" if m is None else "masked"
        print(f"exclusive scan torch.cumsum (65536 int32 lengths, {label}): {scan_ms:.4f} ms/tile "
              f"[{card}]")
        where_the_time_goes(codec, tiles, sum(res[0][3:]), card, label)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
