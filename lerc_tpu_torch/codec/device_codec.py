"""The band codec: one Lerc2 band encoded on the device, and decoded from its
wire bytes on the device.

Port of the tiling, 8-bit Huffman, fpl and float64 paths of
``lerc_tpu/codec/device_codec.py``: ``encode_band_device`` (:55-277) with
``_round_cap`` (:41), ``supports_encode`` (:47), ``_verify_device_encode``
(:280), ``_encode_huffman_device`` (:520-578), ``_fpl_assemble`` (:299),
``_encode_fpl_device`` (:375) and ``_encode_fpl_device_f64`` (:394), and
``decode_band_device`` (:829-1015) with ``_scan_huffman_offsets``
(:581-615), ``_decode_huffman_band_device`` (:618-747),
``_decode_fpl_band_device`` (:415-517) and ``_decode_f64_tiles_device``
(:779-825).

Encode: the maxZError analyses (``lerc2_encode``, torch operations on the
band's device), the 8x8 tiling encode with the LUT candidate (K1/K2 LUT
instances; edge blocks and masks through validity words), the host header
and mask section, the constant and empty shortcuts; on 8-bit lossless bands
the whole-image Huffman candidate (H1 symbols and histograms, the tree on
the host, H2 group pack; direct mode from version 4); on float32 bands at
maxZError 0 and version 6 the fpl candidate of every pixel, valid or not
(F1 sampled histograms, the predictor and levels chosen on the host, F2
planes, F2b PackBits sizes, each plane's method on the host, the Huffman
planes through H2), taken when 10% smaller than tiling (Lerc2.cpp:322); on
float64 bands the 8x8 tiling through K1/K2 f64 (lossy: no LUT, no 16x16
retrial, quanta within maxZError under the decoder's arithmetic) or, at
maxZError 0 and version 6, the fpl section over eight planes (F1-F3 over
u64 words); the 16x16 retrial at low bit rates (Lerc2.cpp:333-357, its gate
fed by the Huffman or fpl candidate's size, taken when it is no larger), the one-sweep
rule (raw valid values when they are no larger than the payload; the mode
byte counts), and the Fletcher32 checksum through K3 over the payload where
it lies.

Decode: the blob's bytes after the checksum field go to the device once;
K3 checks the checksum there; the host parses the header, mask and ranges.
Tiling blobs: the host record scanner (``ops/tile_scan``) walks the tile
stream, and K6 decodes every record from its descriptor: masks, edge
blocks, LUT records, 16x16 blocks and the depth-diff chains. Huffman blobs:
the code table on the host, the group start bits from the encoder's index or
the host lengths-only scan (``ops/huffman_scan``), H3 decodes the groups in
parallel and H4 restores the image. fpl blobs: each plane's bytes on the
device (RLE-const filled, raw sliced from the blob, PackBits decoded on the
host, Huffman through H3 from the index's or the host scan's group start
bits), then F3 restores the image (float32 from four planes, float64 from
eight). Float64 tiling blobs take K6's f64 instance. One-sweep blobs are a
masked scatter of the valid values on the device.

Refused before any work with NotImplementedError: versions below 3 (the
legacy bit order) and micro blocks other than 8 and 16. The host codec
takes them (``orchestrator.decode_blob`` routes them to
``lerc2_decode.decode_band``, ``encode_orchestrator.encode_blob`` encodes
versions below 3 with ``lerc2_encode.BandEncoder``). Nothing falls back to a
host decoder: where JAX's ``decode_band_device`` returns None for the host
path (one-sweep blobs; codes of 31-32 bits; fpl sections of more than 2^25
values or foreign ones without the native library; float64 tiling blobs
outside its softfloat's range), this one decodes or raises.

uint32 bands: K1 orders the values as int32. The band's ranges come from
the band in int64 (P6); a band with a micro block that holds valid values on
both sides of 2^31 and that K1 would quantize (not write raw) is encoded by
the host ``BandEncoder``, whose f64 arithmetic orders it right.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..constants import (DT_SIZE, DT_TO_NUMPY, DT_TO_TORCH, NUMPY_TO_DT, DataType,
                         ImageEncodeMode, as_signed, dt_is_int)
from ..ops import (device_decode, device_encode, device_fpl, device_huffman, device_scan,
                   huffman_scan)
from ..ops import tile_scan as scanner
from . import fpl_impl, huffman, lerc2_encode, rle
from . import header as hdr
from .bitmask import bits_to_bool, bool_to_bits
from .resident import resolve_device

_NO_STATIC = (0, 0, 0)  # Fletcher32 partials of an empty static segment


@dataclasses.dataclass
class DecodedBand:
    """One decoded band (the fields of ``lerc2_decode.DecodedBand``); data
    is a tensor on the decode device."""

    hd: hdr.HeaderInfo
    mask: np.ndarray  # [nRows, nCols] bool
    data: torch.Tensor  # [nRows, nCols, nDepth]
    z_min_vec: np.ndarray | None
    z_max_vec: np.ndarray | None
    consumed: int


@dataclasses.dataclass
class BandSections:
    """The host parse of a band blob after its header (Lerc2.cpp:961-1060):
    the mask, the per-depth ranges and what the data section holds."""

    head: hdr.HeaderInfo
    mask: np.ndarray  # [nRows, nCols] bool
    z_min_vec: np.ndarray | None
    z_max_vec: np.ndarray | None
    kind: str  # "empty", "constant", "one_sweep", "huffman", "fpl" or "tiling"
    mode: int | None  # the image-encode-mode byte, None where the blob has none
    pos: int  # the data's first byte: raw values, code table or tile stream


@dataclasses.dataclass
class HuffmanSection:
    """A whole-image Huffman blob's code table and stream."""

    sections: BandSections
    mode: ImageEncodeMode
    lengths: np.ndarray  # [256] code lengths
    codes: np.ndarray  # [256] codes
    stream_pos: int  # the stream's first byte
    stream: np.ndarray  # uint8, to the end of the blob
    layout: tuple[int, int, int]  # the live symbols' layout (device_huffman.live_layout)
    n_groups: int  # 64-symbol groups of the sidecar


def _round_cap(n: int) -> int:
    """Capacity rounded up to a power of two (as JAX, which compiles once
    per size)."""
    return 1 << max(12, (n - 1).bit_length())


def supports_encode(dt: DataType, max_z_error: float, n_depth: int, all_valid: bool = True,
                    version: int = 6) -> bool:
    """Whether the port encodes the configuration: every dtype at version >= 3."""
    return version >= 3


def _unported(head: hdr.HeaderInfo) -> None:
    """Raise for the versions the band codec leaves to the host codec."""
    if head.version < 3:
        raise NotImplementedError(
            "versions < 3 (legacy bit order) are the host codec's: codec/orchestrator.decode_blob "
            "decodes such blobs, codec/encode_orchestrator.encode_blob encodes them")


def _words(payload: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> int32 u32 words (zero-padded), on the same device."""
    pad = -payload.numel() % 4
    if pad:
        payload = torch.cat([payload, payload.new_zeros(pad)])
    return payload.view(torch.int32)


def _checksum(prefix: bytes, words: torch.Tensor, total: int) -> int:
    """Fletcher32 of prefix || words[:total] bytes through K3 on the words'
    device."""
    tail = torch.frombuffer(bytearray(prefix), dtype=torch.uint8).to(words.device)
    total_t = torch.tensor([total], dtype=torch.int32, device=words.device)
    return int(device_scan.fletcher32_parts(tail[:0], _NO_STATIC, tail, words, total_t)) & 0xFFFFFFFF


def encode_band_device(data, mask, max_z_error: float, version: int = 6,
                       encode_mask: bool = True, n_blobs_more: int = 0, verify: bool = False,
                       return_index: bool = False, *, device="cuda"):
    """Encode one [H, W, D] band (numpy array or tensor, float32, float64 or
    an integer dtype) with an optional [H, W] bool validity mask -> the Lerc2
    blob's bytes, byte-equal to JAX's ``encode_band_device`` (float64: where
    JAX's double-single quanta are within maxZError, ROADMAP queue 3; a
    lossless float64 band below version 6 goes one-sweep). verify decodes
    the fresh blob and holds it to 1.1 * maxZError (0 when lossless) and the
    mask. return_index returns (blob, index), as JAX's: {"huffman_sbits":
    int32 array, each 64-symbol group's first bit} for a Huffman blob,
    {"fpl_sbits": {plane: int32 array}} for an fpl blob (its Huffman-coded
    planes), else None (tiling and one-sweep blobs carry no acceleration
    index)."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        data_t = data.to(dev)
        np_dtype = np.dtype(str(data.dtype).removeprefix("torch."))
    else:
        np_dtype = np.dtype(data.dtype)
        data_t = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    if data_t.dim() != 3:
        raise ValueError(f"data must be [H, W, D], got shape {tuple(data_t.shape)}")
    dt = NUMPY_TO_DT[np_dtype]
    h, w, d = data_t.shape
    if version < 4 and d > 1:
        raise ValueError("depth > 1 needs version >= 4 (no nDepth field before)")
    all_valid = mask is None or bool(np.asarray(mask).all())
    if all_valid:
        num_valid = h * w
        mask_np = np.ones((h, w), dtype=bool)
    else:
        mask_np = np.ascontiguousarray(np.asarray(mask, dtype=bool))
        num_valid = int(mask_np.sum())
    if version < 3:
        _unported(hdr.HeaderInfo(version=version, dt=dt))
    mask_t = (torch.ones(h, w, dtype=torch.bool, device=dev) if all_valid
              else torch.from_numpy(mask_np).to(dev))

    # maxZError analyses (Lerc2.cpp:210-218 cheat code, :1071-1339)
    mze = float(max_z_error)
    if mze == 777:
        mze = -0.01
    if dt_is_int(dt):
        if mze < 0:
            ok, new_mze = lerc2_encode.try_bit_plane_compression(data_t, mask_t, dt, d, num_valid,
                                                                 -mze)
            mze = new_mze if ok else 0
        mze = max(0.5, float(np.floor(mze)))
    else:
        if mze < 0:
            raise ValueError("negative maxZError not allowed for float types")
        if mze > 0:
            ok, new_mze = lerc2_encode.try_raise_max_z_error(data_t, mask_t, mze)
            if ok:
                mze = new_mze
    head = hdr.HeaderInfo(
        version=version, n_rows=h, n_cols=w, n_depth=d, num_valid_pixel=num_valid,
        micro_block_size=8, dt=dt, max_z_error=mze,
        n_blobs_more=n_blobs_more if version >= 6 else 0,
    )

    need_mask = 0 < num_valid < h * w
    if need_mask and encode_mask:
        mask_rle = rle.compress(bool_to_bits(mask_np))
        mask_section = struct.pack("<i", len(mask_rle)) + mask_rle
    else:
        mask_section = struct.pack("<i", 0)
    np_dt = DT_TO_NUMPY[dt]
    skip = hdr.checksum_skip(version)

    def assemble(ranges: bytes, body: bytes, payload=None, n_payload: int = 0) -> bytes:
        """The blob: header, mask section, ranges, body bytes, then
        n_payload bytes of the payload words on the device."""
        head.blob_size = (hdr.header_size(version) + len(mask_section) + len(ranges) + len(body)
                          + n_payload)
        blob = bytearray(hdr.write_header(head)) + mask_section + ranges + body
        if payload is None:
            payload = torch.zeros(1, dtype=torch.int32, device=dev)
        head.checksum = _checksum(bytes(blob[skip:]), payload, n_payload)
        struct.pack_into("<I", blob, skip - 4, head.checksum)
        blob += payload.view(torch.uint8)[:n_payload].cpu().numpy().tobytes()
        result = bytes(blob)
        if verify:
            _verify_device_encode(result, data_t, mask_np, mze, dt, dev)
        return (result, None) if return_index else result

    if num_valid == 0:
        return assemble(b"", b"")

    f64 = dt == DataType.DOUBLE
    enc_data = data_t.to(torch.float64 if f64 else torch.int32 if dt_is_int(dt)
                         else torch.float32).contiguous()
    n_rec = -(-h // 8) * -(-w // 8) * d
    cap = _round_cap(num_valid * DT_SIZE[dt] * d + n_rec * 12 + 4096)  # raw: 1 + size * cnt B
    valid8 = None if all_valid else device_encode.block_valid_words(mask_t, 8)
    if f64 and mze == 0:  # no lossless float64 tiling candidate (JAX's :111-116): fpl or one-sweep
        vals = (enc_data if all_valid else enc_data[mask_t]).reshape(-1, d)
        stream, total, zminv, zmaxv = None, 1 << 60, vals.amin(0), vals.amax(0)
    else:  # (float64: K1/K2 f64 on 8x8 blocks, no LUT candidate)
        stream, total, zminv, zmaxv, _starts, _fits = device_encode.encode_tiles(
            enc_data, valid8, mze, h, w, d, dt, all_valid, version, cap, enable_lut=not f64)
        total = int(total)
        if total > cap:
            raise ValueError("device encode capacity exceeded")
        zminv, zmaxv = (device_encode.range_values(z, dt) for z in (zminv, zmaxv))
    zmin_vec = zminv.cpu().numpy().astype(np.float64)
    zmax_vec = zmaxv.cpu().numpy().astype(np.float64)
    head.z_min = float(zmin_vec.min())
    head.z_max = float(zmax_vec.max())
    if head.z_min == head.z_max:
        return assemble(b"", b"")
    ranges = b""
    if version >= 4:
        ranges = zmin_vec.astype(np_dt).tobytes() + zmax_vec.astype(np_dt).tobytes()
        if np.array_equal(zmin_vec, zmax_vec):
            return assemble(ranges, b"")

    payload, n_bytes_data = stream, total
    n_bytes_huffman = 0
    image_mode = ImageEncodeMode.TILING
    try_huffman = head.try_huffman_int() or head.try_huffman_flt()
    table = b""  # host bytes of the body before the payload words
    index = None
    if head.try_huffman_int():  # the whole-image Huffman candidate (lossless 8-bit)
        hm = _encode_huffman_device(enc_data, None if all_valid else mask_t, num_valid, dt,
                                    version)
        if hm is not None:
            mode, h_table, h_words, h_stream_bytes, h_sbits = hm
            n_bytes_huffman = len(h_table) + h_stream_bytes
            if n_bytes_huffman < n_bytes_data:
                image_mode, table, payload = mode, h_table, h_words
                n_bytes_data = n_bytes_huffman
                index = {"huffman_sbits": h_sbits.cpu().numpy().astype(np.int32)}
    elif head.try_huffman_flt():  # fpl (lossless float at v6): all pixels, mask or not
        section, sidecar = _encode_fpl_device(enc_data)
        # its size feeds the 16x16 gate even when it loses (lerc2_encode.py:229);
        # it is taken when >= 10% smaller than tiling (Lerc2.cpp:322), always for float64
        n_bytes_huffman = len(section)
        if n_bytes_huffman < n_bytes_data * 0.9:
            image_mode, table, payload = ImageEncodeMode.DELTA_DELTA_HUFFMAN, section, None
            n_bytes_data = n_bytes_huffman
            index = {"fpl_sbits": sidecar}

    # 16x16 micro-block retrial at low bit rates (Lerc2.cpp:333-357): half
    # the per-block header overhead when blocks compress below ~1.5 bpp
    n_one_sweep = DT_SIZE[dt] * d * num_valid
    if (total * 8 < h * w * d * 1.5 and total < 4 * n_one_sweep and not f64
            and (n_bytes_huffman == 0 or total < 2 * n_bytes_huffman) and (h > 8 or w > 8)):
        valid16 = None if all_valid else device_encode.block_valid_words(mask_t, 16)
        s16, t16, *_ = device_encode.encode_tiles(
            enc_data, valid16, mze, h, w, d, dt, all_valid, version, cap, enable_lut=True, mb=16)
        t16 = int(t16)
        if t16 <= n_bytes_data:
            head.micro_block_size = 16
            image_mode, table, payload, n_bytes_data = ImageEncodeMode.TILING, b"", s16, t16
            index = None

    # the valid values raw, in pixel order, when no larger (the mode byte counts)
    if n_one_sweep <= n_bytes_data + (1 if try_huffman else 0):
        vals = as_signed(data_t.to(DT_TO_TORCH[dt]))[mask_t].contiguous()  # (CUDA: no uint index)
        return assemble(ranges, b"\x01", _words(vals.view(torch.uint8).reshape(-1)), n_one_sweep)
    body = b"\x00" + (bytes([image_mode]) if try_huffman else b"") + table
    blob = assemble(ranges, body, payload, n_bytes_data - len(table))
    return (blob[0], index) if return_index else blob


def _encode_huffman_device(enc_data: torch.Tensor, mask_t: torch.Tensor | None, num_valid: int,
                           dt: DataType, version: int):
    """The whole-image Huffman candidate of an 8-bit band (int32 [H, W, D] on
    the device, mask None when all-valid), as the host BandEncoder picks it
    (Lerc2.cpp:2384-2468): H1's histograms to the host, the code-length trees
    there, direct mode (version >= 4) when no larger than delta, then H2.
    Returns (mode, code table bytes, stream words on the device, stream
    bytes, sidecar sbits) or None when neither mode has a code."""
    h, w, d = enc_data.shape
    direct, delta, histos = device_huffman.symbol_streams_device(enc_data, mask_t, dt)
    histo, dhisto = histos.cpu().numpy().astype(np.int64)

    def size_of(hst):
        lengths = huffman.compute_code_lengths(hst)
        if lengths is None:
            return None, None
        nb = huffman.compute_compressed_size(hst, lengths)
        return (nb if nb > 0 else None), lengths

    nb0, len0 = size_of(histo) if version >= 4 else (None, None)
    nb1, len1 = size_of(dhisto)
    if nb0 is None and nb1 is None:
        return None
    if nb0 is not None and (nb1 is None or nb0 <= nb1):
        mode, lengths, syms, hst = ImageEncodeMode.HUFFMAN, len0, direct, histo
    else:
        mode, lengths, syms, hst = ImageEncodeMode.DELTA_HUFFMAN, len1, delta, dhisto
    codes = huffman.canonical_codes(lengths)
    table = huffman.write_code_table(lengths, codes, version)
    total_bits = int((hst * lengths.astype(np.int64)).sum())
    if total_bits >= 2**31:
        raise ValueError("Huffman stream of 2^31 bits or more")
    n_words = -(-total_bits // 32) + 1  # + the read-ahead pad word (Lerc2.cpp:2464)
    layout = device_huffman.live_layout(h * w, d, None if mask_t is None else num_valid,
                                        mode == ImageEncodeMode.DELTA_HUFFMAN)
    words, tb, sbits = device_huffman.encode_stream_device(
        syms, device_huffman.code_table(lengths, codes, enc_data.device), layout, n_words)
    if int(tb) != total_bits:
        raise RuntimeError("Huffman pack: stream length differs from the histogram's")
    return mode, table, words, 4 * n_words, sbits


def _encode_fpl_device(enc_data: torch.Tensor) -> tuple[bytes, dict]:
    """The fpl section of a float32 or float64 [H, W, D] band on the device,
    as JAX's ``_encode_fpl_device`` (:375) and ``_encode_fpl_device_f64``
    (:394) write it: F1's sampled histograms to the host, the predictor and
    levels chosen there, F2's planes and histograms and F2b's PackBits sizes
    (4 planes, or 8 for float64), then ``_fpl_assemble``. Returns (the
    section's bytes, the Huffman planes' group start bits: {plane: int32
    array})."""
    h, w, d = enc_data.shape
    n = h * w * d
    pred, levels, _ests = device_fpl.fpl_choose(
        device_fpl.fpl_sample_histograms(enc_data).cpu().numpy())
    planes, histos = device_fpl.fpl_finalize(enc_data, pred, levels)
    pb_sizes = device_fpl.fpl_packbits_size(planes, n)
    return _fpl_assemble(pred, levels, histos.cpu().numpy().astype(np.int64), planes,
                         pb_sizes.cpu().numpy(), n)


def _fpl_assemble(pred: int, levels, histos: np.ndarray, planes: torch.Tensor,
                  pb_sizes: np.ndarray, n: int) -> tuple[bytes, dict]:
    """The section from the device's planes (JAX's ``_fpl_assemble``, :299,
    its unit size the planes' count): per plane RLE-const below 2 live
    symbols, else the least of Huffman, PackBits (JAX's size formula;
    encoded exactly on the host) and raw (fpl_EsriHuffman.cpp:319-451); the
    Huffman planes packed by H2, their code tables written at version 5."""
    metas, tables = [], {}
    for b in range(planes.shape[0]):
        hst = histos[b]
        if np.count_nonzero(hst) < 2:
            metas.append("rle")
            continue
        lengths = huffman.compute_code_lengths(hst)
        hb = huffman.compute_compressed_size(hst, lengths) if lengths is not None else -1
        if lengths is None or hb <= 0:
            hb = 1 << 60
        pb = int(pb_sizes[b])
        if pb < hb and pb < n:
            metas.append("packbits")
        elif hb >= n:
            metas.append("raw")
        else:
            metas.append("huff")
            tables[b] = (lengths, huffman.canonical_codes(lengths),
                         int((hst * lengths.astype(np.int64)).sum()))
    packed = device_fpl.fpl_pack_planes(planes, n, tables)
    planes_h = planes[:, :n].cpu().numpy() if {"packbits", "raw"} & set(metas) else None
    out = bytearray([pred])
    sidecar = {}
    for b, kind in enumerate(metas):
        if kind == "rle":
            payload = bytes([fpl_impl.M_RLE, int(np.argmax(histos[b]))]) + struct.pack("<I", n)
        elif kind == "packbits":
            payload = bytes([fpl_impl.M_PACKBITS]) + fpl_impl.encode_packbits(planes_h[b])
        elif kind == "raw":
            payload = bytes([fpl_impl.M_RAW]) + planes_h[b].tobytes()
        else:
            lengths, codes, _bits = tables[b]
            words, sbits = packed[b]
            payload = (bytes([fpl_impl.M_HUFFMAN]) + huffman.write_code_table(lengths, codes, 5)
                       + words.cpu().numpy().tobytes())
            sidecar[b] = sbits.cpu().numpy().astype(np.int32)
        out += bytes([b, int(levels[b])]) + struct.pack("<I", len(payload)) + payload
    return bytes(out), sidecar


def _read_sections(src: memoryview, head: hdr.HeaderInfo, pos: int,
                   prev_mask: np.ndarray | None) -> BandSections:
    """Parse the mask section, the ranges and the flag bytes that follow a
    header ending at byte pos."""
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    num_bytes_mask = int.from_bytes(src[pos : pos + 4], "little", signed=True)
    pos += 4
    if num_bytes_mask < 0 or num_bytes_mask > len(src) - pos:
        raise ValueError("bad mask section size")
    num_total = h * w
    if head.num_valid_pixel in (0, num_total) and num_bytes_mask != 0:
        raise ValueError("unexpected mask bytes")
    if head.num_valid_pixel == 0:
        mask = np.zeros((h, w), dtype=bool)
    elif head.num_valid_pixel == num_total:
        mask = np.ones((h, w), dtype=bool)
    elif num_bytes_mask > 0:
        bits = rle.decompress(src[pos : pos + num_bytes_mask], (num_total + 7) >> 3)
        mask = bits_to_bool(bits, w, h)
        pos += num_bytes_mask
    else:
        if prev_mask is None:
            raise ValueError("mask reuse requested but no previous mask")
        mask = np.array(prev_mask, dtype=bool)
    sec = BandSections(head, mask, None, None, "empty", None, pos)
    if head.num_valid_pixel == 0:
        return sec
    sec.kind = "constant"
    if head.z_min == head.z_max:
        return sec
    if head.version >= 4:
        np_dt = DT_TO_NUMPY[head.dt]
        nb = d * DT_SIZE[head.dt]
        sec.z_min_vec = np.frombuffer(src[pos : pos + nb], dtype=np_dt).astype(np.float64)
        sec.z_max_vec = np.frombuffer(src[pos + nb : pos + 2 * nb], dtype=np_dt).astype(np.float64)
        pos += 2 * nb
        sec.pos = pos
        if np.array_equal(sec.z_min_vec, sec.z_max_vec):
            return sec
    if pos >= len(src):
        raise ValueError("truncated blob: missing flag bytes")
    one_sweep = src[pos]
    pos += 1
    sec.kind, sec.pos = "one_sweep", pos
    if one_sweep:
        return sec
    sec.kind = "tiling"
    if head.try_huffman_int() or head.try_huffman_flt():
        if pos >= len(src):
            raise ValueError("truncated blob: missing image-mode byte")
        flag = src[pos]
        pos += 1
        if (flag > ImageEncodeMode.DELTA_DELTA_HUFFMAN
                or (flag > ImageEncodeMode.HUFFMAN and head.version < 6)
                or (flag > ImageEncodeMode.DELTA_HUFFMAN and head.version < 4)):
            raise ValueError("bad image encode mode flag")
        sec.mode, sec.pos = flag, pos
        if flag != ImageEncodeMode.TILING:
            if head.try_huffman_flt():
                if flag != ImageEncodeMode.DELTA_DELTA_HUFFMAN:
                    raise ValueError("bad image encode mode")
                sec.kind = "fpl"
            elif flag == ImageEncodeMode.DELTA_DELTA_HUFFMAN:
                raise ValueError("bad huffman mode")
            else:
                sec.kind = "huffman"
    return sec


def band_sections(buf, prev_mask: np.ndarray | None = None) -> BandSections:
    """Where a band blob's parts lie: its header, mask, ranges, the kind of
    its data section and the image-encode-mode byte. Raises ValueError on a
    malformed blob."""
    src = memoryview(buf).cast("B")
    head, pos = hdr.read_header(src)
    return _read_sections(src, head, pos, prev_mask)


def _read_huffman_table(src: memoryview, sec: BandSections) -> HuffmanSection:
    """The code table of a Huffman blob's sections, and the stream after it.
    The live layout's valid count comes from the decoded mask, as the host
    decoder's, not from the header."""
    head = sec.head
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    npx = h * w
    lengths, codes, used = huffman.read_code_table(src[sec.pos:head.blob_size], head.version)
    if int(lengths.max(initial=0)) == 0:
        raise ValueError("empty huffman code table")
    if lengths.size > 256 and lengths[256:].any():
        raise ValueError("huffman code table with symbols past 255 on 8-bit data")
    mode = ImageEncodeMode(sec.mode)
    masked = head.num_valid_pixel != npx
    layout = device_huffman.live_layout(npx, d, int(np.count_nonzero(sec.mask)) if masked else None,
                                        mode == ImageEncodeMode.DELTA_HUFFMAN)
    pos = sec.pos + used
    return HuffmanSection(sec, mode, lengths[:256], codes[:256], pos,
                          np.frombuffer(src[pos:head.blob_size], np.uint8), layout,
                          -(-npx * d // device_huffman.GROUP))


def huffman_section(buf, prev_mask: np.ndarray | None = None) -> HuffmanSection:
    """The code table, stream and symbol layout of a whole-image Huffman
    blob. Raises ValueError on a blob of another kind."""
    src = memoryview(buf).cast("B")
    sec = band_sections(src, prev_mask)
    if sec.kind != "huffman":
        raise ValueError(f"not a Huffman blob: its data section is {sec.kind}")
    return _read_huffman_table(src, sec)


def _decode_huffman_band_device(hs: HuffmanSection, mask_t: torch.Tensor, words: torch.Tensor,
                                skip: int, sbits) -> torch.Tensor:
    """The [H, W, D] image of a whole-image Huffman blob. The table is read
    from the wire (never from the index); the group start bits come from the
    encoder's sidecar `sbits`, or for a foreign blob from the host
    lengths-only scan over the live symbols' layout; H3 decodes the groups,
    checking the start bits against the decoded lengths, and H4 restores the
    image."""
    head = hs.sections.head
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    dev = words.device
    consts, sorted_syms = huffman.canonical_decode_consts(hs.lengths, hs.codes)
    masked = head.num_valid_pixel != h * w
    delta = hs.mode == ImageEncodeMode.DELTA_HUFFMAN
    if sbits is None:
        sbits = huffman_scan.huffman_group_offsets(
            hs.stream, hs.lengths, hs.codes, device_huffman.live_counts(hs.n_groups, hs.layout))
    sbits = np.asarray(sbits)
    if sbits.shape != (hs.n_groups,) or sbits.dtype.kind not in "iu":
        raise ValueError("Huffman sidecar inconsistent with stream")
    # the stream's words from its own first byte, with a zero word past its end
    pos, n_stream = hs.stream_pos, hs.stream.size
    stream = words.view(torch.uint8)[pos - skip : pos - skip + n_stream]
    stream = _words(torch.cat([stream, stream.new_zeros(4)]))
    syms, _used, ok = device_huffman.decode_stream_device(
        stream, n_stream // 4 * 32, torch.from_numpy(sbits.astype(np.int32)).to(dev),
        torch.from_numpy(consts).to(dev), torch.from_numpy(sorted_syms).to(dev), hs.layout)
    if not bool(ok):
        raise ValueError("Huffman sidecar inconsistent with stream")
    if not masked:
        return device_huffman.symbols_to_image(syms, h, w, d, head.dt, delta)
    if delta:
        return device_huffman.undelta_masked_device(syms, mask_t, d, head.dt)
    return device_huffman.expand_compacted_device(syms, mask_t, d, head.dt)


def _fpl_huffman_plane(src: memoryview, start: int, end: int, n: int, words: torch.Tensor,
                       skip: int, sbits) -> torch.Tensor:
    """The n bytes of a Huffman fpl plane whose payload after its method
    byte is src[start:end]: the code table (version 5) on the host; the
    group start bits from the encoder's sidecar, or, where it has none or
    another group count, from the host lengths-only scan; H3 decodes the
    groups and checks the start bits against the decoded lengths."""
    lengths, codes, used = huffman.read_code_table(src[start:end], 5)
    if int(lengths.max(initial=0)) == 0:
        raise ValueError("empty huffman code table")
    if lengths.size > 256 and lengths[256:].any():
        raise ValueError("huffman code table with symbols past 255 in an fpl plane")
    lengths, codes = lengths[:256], codes[:256]
    s0 = start + used
    n_groups = -(-n // device_huffman.GROUP)
    layout = (n, n, n)  # every position of a plane is live
    if sbits is None or np.shape(sbits) != (n_groups,):
        sbits = huffman_scan.huffman_group_offsets(
            np.frombuffer(src[s0:end], np.uint8), lengths, codes,
            device_huffman.live_counts(n_groups, layout))
    sbits = np.asarray(sbits)
    if sbits.dtype.kind not in "iu":
        raise ValueError("fpl Huffman sidecar inconsistent with stream")
    dev = words.device
    consts, sorted_syms = huffman.canonical_decode_consts(lengths, codes)
    stream = words.view(torch.uint8)[s0 - skip : end - skip]
    syms, _used, ok = device_huffman.decode_stream_device(
        _words(torch.cat([stream, stream.new_zeros(4)])), (end - s0) // 4 * 32,
        torch.from_numpy(sbits.astype(np.int32)).to(dev), torch.from_numpy(consts).to(dev),
        torch.from_numpy(sorted_syms).to(dev), layout)
    if not bool(ok):
        raise ValueError("fpl Huffman sidecar inconsistent with stream")
    return syms[:n]


def _decode_fpl_band_device(src: memoryview, sec: BandSections, words: torch.Tensor, skip: int,
                            sidecar) -> torch.Tensor:
    """The [H, W, D] float32 or float64 image of an fpl blob (JAX's
    ``_decode_fpl_band_device``, :415, both halves, with no 2^25-value limit,
    and fpl_impl.decode_slice's checks): each plane's bytes on the device
    (RLE-const filled, raw bytes sliced from the blob, PackBits decoded on
    the host, Huffman through H3), then F3 undoes the levels, the predictor
    and the transform. Four planes for float32, eight for float64. Every
    pixel rides the wire, valid or not, as the host decoder reads it.
    sidecar is the index's {plane: group start bits} or None."""
    head = sec.head
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    n = h * w * d
    n_pl = device_fpl.N_PLANES64 if head.dt == DataType.DOUBLE else device_fpl.N_PLANES
    end, pos = head.blob_size, sec.pos
    if end - pos < 1:
        raise ValueError("truncated fpl section")
    pred = src[pos]
    if pred > 2:
        raise ValueError("bad fpl predictor code")
    pos += 1
    planes = torch.zeros(n_pl, device_fpl.padded(n), dtype=torch.uint8,
                         device=words.device)  # a plane the section lacks stays 0
    levels = [0] * n_pl
    for _ in range(n_pl):
        if end - pos < 6:
            raise ValueError("truncated fpl plane header")
        b, level = src[pos], src[pos + 1]
        if b >= n_pl or level > fpl_impl.MAX_DELTA:
            raise ValueError("corrupt fpl plane header")
        csize = int.from_bytes(src[pos + 2 : pos + 6], "little")
        pos += 6
        if csize < 1 or end - pos < csize:
            raise ValueError("truncated fpl plane payload")
        levels[b] = level
        method, body = src[pos], pos + 1
        if method == fpl_impl.M_RLE:
            if csize < 6:
                raise ValueError("truncated RLE-const plane")
            if int.from_bytes(src[pos + 2 : pos + 6], "little") != n:
                raise ValueError("RLE-const size mismatch")
            planes[b, :n] = src[body]
        elif method == fpl_impl.M_RAW:
            if csize - 1 < n:
                raise ValueError("truncated raw plane")
            planes[b, :n] = words.view(torch.uint8)[body - skip : body - skip + n]
        elif method == fpl_impl.M_PACKBITS:
            plane = fpl_impl.decode_packbits(src[body : pos + csize], n)
            planes[b, :n] = torch.from_numpy(plane).to(words.device)
        elif method == fpl_impl.M_HUFFMAN:
            planes[b, :n] = _fpl_huffman_plane(src, body, pos + csize, n, words, skip,
                                               None if sidecar is None else sidecar.get(int(b)))
        else:
            raise ValueError("unknown fpl plane method")
        pos += csize
    return device_fpl.fpl_restore(planes, h, w, d, pred, levels)


def _verify_device_encode(blob: bytes, data: torch.Tensor, mask_np: np.ndarray, mze: float,
                          dt: DataType, dev) -> None:
    """ENCODE_VERIFY (reference Lerc.cpp:1081-1211): decode the fresh blob
    and compare with the input at the valid pixels, within maxZError * 1.1
    (exactly when lossless); the mask must round-trip."""
    res = decode_band_device(blob, device=dev)
    if not np.array_equal(res.mask, mask_np):
        raise ValueError("ENCODE_VERIFY: mask mismatch")
    if mask_np.any():
        sel = torch.from_numpy(mask_np).to(dev)
        err = float((res.data.to(torch.float64) - data.to(torch.float64)).abs()[sel].max())
        lossless = mze == 0 or (dt_is_int(dt) and mze == 0.5)
        limit = 0 if lossless else mze * 1.1
        if err > limit:
            raise ValueError(f"ENCODE_VERIFY: error {err} exceeds {limit}")


def decode_band_device(buf, prev_mask: np.ndarray | None = None, verify_checksum: bool = True,
                       index: dict | None = None, *, device="cuda") -> DecodedBand:
    """Decode one Lerc2 band blob (bytes-like) on the device -> DecodedBand,
    its data a tensor on the decode device, bit-equal to the host decoder
    ``lerc2_decode.decode_band``. prev_mask is the previous band's mask, for
    a blob that reuses it (mask section of length 0). index is the
    acceleration index of ``encode_band_device(..., return_index=True)``
    (JAX's and the port's are the same plain dict): its "huffman_sbits" give
    a Huffman blob's group start bits, its "fpl_sbits" an fpl blob's Huffman
    planes', checked against the decoded code lengths; without them (or, for
    an fpl plane, with another group count) the host lengths-only scan finds
    them. Raises ValueError on a corrupt blob or an index that does not fit
    it."""
    dev = resolve_device(device)
    src = memoryview(buf).cast("B")
    head, pos = hdr.read_header(src)
    if len(src) < head.blob_size:
        raise ValueError("buffer shorter than blobSize")
    if head.version < 3:
        _unported(head)
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    np_dt = DT_TO_NUMPY[head.dt]

    # the bytes after the checksum field, on the device once
    skip = hdr.checksum_skip(head.version)
    words = _words(torch.frombuffer(bytearray(src[skip:head.blob_size]), dtype=torch.uint8).to(dev))
    if verify_checksum:
        total_t = torch.tensor([head.blob_size - skip], dtype=torch.int32, device=dev)
        empty = torch.zeros(0, dtype=torch.uint8, device=dev)
        if int(device_scan.fletcher32_parts(empty, _NO_STATIC, empty, words, total_t)) & 0xFFFFFFFF \
                != head.checksum:
            raise ValueError("Lerc2 checksum mismatch")

    sec = _read_sections(src, head, pos, prev_mask)
    mask, pos = sec.mask, sec.pos
    out = DecodedBand(head, mask, torch.zeros(h, w, d, dtype=DT_TO_TORCH[head.dt], device=dev),
                      sec.z_min_vec, sec.z_max_vec, head.blob_size)
    if sec.kind == "empty":
        return out
    mask_t = torch.from_numpy(np.ascontiguousarray(mask)).to(dev)
    if sec.kind == "constant":
        vals = (sec.z_min_vec.astype(np_dt) if sec.z_min_vec is not None and d > 1
                else np.full(d, np_dt(head.z_min)))
        as_signed(out.data)[mask_t] = as_signed(torch.from_numpy(vals).to(dev))
        return out
    if sec.kind == "one_sweep":  # the valid values raw, in pixel order
        n_valid = int(np.count_nonzero(mask))
        nbytes = n_valid * d * DT_SIZE[head.dt]
        if len(src) - pos < nbytes:
            raise ValueError("truncated one-sweep data")
        vals = words.view(torch.uint8)[pos - skip : pos - skip + nbytes].clone().view(out.data.dtype)
        as_signed(out.data)[mask_t] = as_signed(vals).reshape(n_valid, d)
        return out
    if sec.kind == "fpl":
        out.data = _decode_fpl_band_device(src, sec, words, skip,
                                           None if index is None else index.get("fpl_sbits"))
        return out
    if sec.kind == "huffman":
        out.data = _decode_huffman_band_device(
            _read_huffman_table(src, sec), mask_t, words, skip,
            None if index is None else index.get("huffman_sbits"))
        return out

    mb = head.micro_block_size
    if mb not in (8, 16):
        raise NotImplementedError(
            f"micro blocks of {mb} are the host codec's: codec/orchestrator.decode_blob decodes "
            "such blobs")
    cnts, j0s, n_blocks = scanner.block_scan_inputs(mask, mb)
    stream_np = np.frombuffer(src[pos : head.blob_size], dtype=np.uint8)
    scan = scanner.tile_scan if dev.type == "cuda" else scanner.tile_scan_ref
    recs, _used = scan(stream_np, cnts, j0s, n_blocks, d, int(head.dt), head.version)
    z_max = out.z_max_vec if out.z_max_vec is not None else np.full(d, head.z_max)
    valid = None if mask.all() else device_encode.block_valid_words(mask_t, mb)
    out.data = device_decode.decode_tiles(words, pos - skip, recs, valid, head, z_max)
    return out
