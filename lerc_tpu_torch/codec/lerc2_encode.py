"""Single-band Lerc2 encoder on the host (writes v2..v6), and the encoder's
maxZError analyses.

The port's own copy of ``lerc_tpu/codec/lerc2_encode.py``: ``BandEncoder``
(:115-575) with its helpers (:37-112), the semantics of
Lerc2::ComputeNumBytesNeededToWrite + Encode (Lerc2.cpp:179-480) with
vectorized numpy per-block statistics and quantization: the 8x8 tiling with
the LUT candidate and the depth-diff candidate, the 16x16 retrial, the
whole-image Huffman candidate of 8-bit data, the fpl section of lossless
floats at v6, one-sweep, the noData header fields. Its tie-breaks (the
Huffman heap order, f64 quantization, LUT ordering) are JAX's, so its blobs
are byte-equal to JAX's.

``try_raise_max_z_error`` (:576-597) and ``try_bit_plane_compression``
(:600-637) are torch operations, run where the band lies: on the band
codec's device, and on CPU tensors for ``BandEncoder``. They compute in
float64 and int64, where numpy's arithmetic and torch's are the same (one
rounding per f64 operation, exact integer bit counts), so the answers are
JAX's.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..constants import (DT_SIZE, DT_TO_NUMPY, NUMPY_TO_DT, DataType, ImageEncodeMode, dt_is_int,
                         max_val_to_quantize)
from . import bitstuffer, fletcher32, fpl_impl, huffman, rle
from . import header as hdr
from .bitmask import bool_to_bits

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _blockize(arr2d: np.ndarray, mb: int, pad_val=0) -> tuple[np.ndarray, int, int]:
    """[H, W] -> [nBlocks, mb*mb] row-major within block; blocks scan
    left-to-right, top-to-bottom. Padded area filled with pad_val."""
    h, w = arr2d.shape
    nbv, nbh = -(-h // mb), -(-w // mb)
    out = np.full((nbv * mb, nbh * mb), pad_val, dtype=arr2d.dtype)
    out[:h, :w] = arr2d
    blocks = out.reshape(nbv, mb, nbh, mb).transpose(0, 2, 1, 3).reshape(nbv * nbh, mb * mb)
    return blocks, nbv, nbh


def _reduce_data_type(z: float, dt: DataType) -> tuple[int, DataType]:
    """(type code for comprFlag bits 6-7, reduced DataType). Lerc2.h:457-515."""
    zb = int(z) if (0 <= z <= 255 and z == int(z)) else None
    if dt == DataType.SHORT:
        if -128 <= z <= 127 and z == int(z):
            tc = 2
        elif zb is not None:
            tc = 1
        else:
            tc = 0
        return tc, DataType(dt - tc)
    if dt == DataType.USHORT:
        tc = 1 if zb is not None else 0
        return tc, DataType(dt - 2 * tc)
    if dt == DataType.INT:
        if zb is not None:
            tc = 3
        elif -32768 <= z <= 32767 and z == int(z):
            tc = 2
        elif 0 <= z <= 65535 and z == int(z):
            tc = 1
        else:
            tc = 0
        return tc, DataType(dt - tc)
    if dt == DataType.UINT:
        if zb is not None:
            tc = 2
        elif 0 <= z <= 65535 and z == int(z):
            tc = 1
        else:
            tc = 0
        return tc, DataType(dt - 2 * tc)
    if dt == DataType.FLOAT:
        if zb is not None:
            tc = 2
        elif -32768 <= z <= 32767 and z == int(z):
            tc = 1
        else:
            tc = 0
        return tc, (dt if tc == 0 else (DataType.SHORT if tc == 1 else DataType.BYTE))
    if dt == DataType.DOUBLE:
        if -32768 <= z <= 32767 and z == int(z):
            tc = 3
        elif -2147483648 <= z <= 2147483647 and z == int(z):
            tc = 2
        elif float(np.float32(z)) == z:
            tc = 1
        else:
            tc = 0
        return tc, (dt if tc == 0 else DataType(dt - 2 * tc + 1))
    return 0, dt  # char, byte


def _write_variable_value(z: float, dt_used: DataType) -> bytes:
    np_dt = DT_TO_NUMPY[dt_used]
    return np.array([z]).astype(np_dt).tobytes()


# ---------------------------------------------------------------------------
# encoder parameters per band
# ---------------------------------------------------------------------------

class BandEncoder:
    """One [nRows, nCols, nDepth] band and its validity mask -> its Lerc2
    blob (``encode()``), at codec versions 2..6, byte-equal to JAX's
    ``BandEncoder``. The noData fields are the orchestrator's
    (``encode_orchestrator.encode_blob``): they reach the header at v6."""

    def __init__(
        self,
        data: np.ndarray,  # [nRows, nCols, nDepth]
        mask: np.ndarray | None,  # [nRows, nCols] bool, None = all valid
        max_z_error: float,
        version: int = 6,
        encode_mask: bool = True,
        n_blobs_more: int = 0,
        b_pass_no_data: bool = False,
        no_data_val: float = 0.0,
        no_data_val_orig: float = 0.0,
        b_is_all_int: bool = False,
        min_max: tuple[float, float] | None = None,
    ):
        if data.ndim != 3:
            raise ValueError("data must be [nRows, nCols, nDepth]")
        self.data = data
        self.n_rows, self.n_cols, self.n_depth = data.shape
        self.dt = NUMPY_TO_DT[data.dtype]
        self.np_dt = DT_TO_NUMPY[self.dt]
        self.version = version
        if version < 2 or version > 6:
            raise ValueError("codec version must be in [2, 6]")
        if self.n_depth > 1 and version < 4:
            raise ValueError("nDepth > 1 requires codec version >= 4")
        self.mask = np.ones((self.n_rows, self.n_cols), dtype=bool) if mask is None else mask.astype(bool)
        self.all_valid = bool(self.mask.all())
        self.num_valid = int(np.count_nonzero(self.mask))
        self.encode_mask = encode_mask
        self.hd = hdr.HeaderInfo(
            version=version, n_rows=self.n_rows, n_cols=self.n_cols, n_depth=self.n_depth,
            num_valid_pixel=self.num_valid, micro_block_size=8, dt=self.dt,
            n_blobs_more=n_blobs_more if version >= 6 else 0,
            b_pass_no_data_values=1 if (b_pass_no_data and version >= 6) else 0,
            b_is_int=1 if (b_is_all_int and version >= 6) else 0,
            no_data_val=no_data_val if (b_pass_no_data and version >= 6) else 0.0,
            no_data_val_orig=no_data_val_orig if (b_pass_no_data and version >= 6) else 0.0,
        )
        self.max_z_error_in = max_z_error
        self.min_max = min_max
        self.max_val_quant = max_val_to_quantize(self.dt)

    # -- top level ----------------------------------------------------------

    def encode(self) -> bytes:
        hd = self.hd
        mze = self.max_z_error_in
        if mze == 777:  # cheat code
            mze = -0.01
        if dt_is_int(self.dt):
            if mze < 0:
                ok, new_mze = self._try_bit_plane_compression(-mze)
                mze = new_mze if ok else 0
            mze = max(0.5, np.floor(mze))
        else:
            if mze < 0:
                raise ValueError("negative maxZError not allowed for float types")
            if mze > 0:
                ok, new_mze = self._try_raise_max_z_error(mze)
                if ok:
                    mze = new_mze
        hd.max_z_error = float(mze)

        mask_section = self._build_mask_section()

        if self.num_valid == 0:
            return self._assemble(mask_section, b"", b"")

        # per-depth ranges
        valid3 = self.mask[:, :, None]
        if self.min_max is not None and self.n_depth == 1:
            z_min_vec = np.array([self.min_max[0]])
            z_max_vec = np.array([self.min_max[1]])
        else:
            vals = self.data[self.mask]  # [numValid, nDepth]
            z_min_vec = vals.min(axis=0).astype(np.float64)
            z_max_vec = vals.max(axis=0).astype(np.float64)
        self.z_min_vec, self.z_max_vec = z_min_vec, z_max_vec
        hd.z_min = float(z_min_vec.min())
        hd.z_max = float(z_max_vec.max())

        if hd.z_min == hd.z_max:  # const image
            return self._assemble(mask_section, b"", b"")

        ranges_section = b""
        if self.version >= 4:
            ranges_section = (
                z_min_vec.astype(self.np_dt).tobytes() + z_max_vec.astype(self.np_dt).tobytes()
            )
            if np.array_equal(z_min_vec, z_max_vec):
                return self._assemble(mask_section, ranges_section, b"")

        # --- candidate encodings
        tiling_payload = self._write_tiles(8)
        n_bytes_tiling = len(tiling_payload)
        image_mode = ImageEncodeMode.TILING
        payload = tiling_payload
        n_bytes_data = n_bytes_tiling
        n_bytes_huffman = 0

        if hd.try_huffman_int():
            hm = self._encode_huffman_int()
            if hm is not None:
                mode, hbytes = hm
                n_bytes_huffman = len(hbytes)
                if n_bytes_huffman < n_bytes_tiling:
                    image_mode = mode
                    payload = hbytes
                    n_bytes_data = n_bytes_huffman
        elif hd.try_huffman_flt():
            fbytes = fpl_impl.encode_flt(self.data, self.n_cols, self.n_rows, self.n_depth)
            n_bytes_huffman = len(fbytes)
            if n_bytes_huffman < n_bytes_tiling * 0.9:  # demand >= 10% win
                image_mode = ImageEncodeMode.DELTA_DELTA_HUFFMAN
                payload = fbytes
                n_bytes_data = n_bytes_huffman

        n_one_sweep = DT_SIZE[self.dt] * self.n_depth * self.num_valid

        # 16x16 retrial to cut block header overhead at low bit rates
        num_total = self.n_rows * self.n_cols
        if (
            n_bytes_tiling * 8 < num_total * self.n_depth * 1.5
            and n_bytes_tiling < 4 * n_one_sweep
            and (n_bytes_huffman == 0 or n_bytes_tiling < 2 * n_bytes_huffman)
            and (self.n_rows > 8 or self.n_cols > 8)
        ):
            payload16 = self._write_tiles(16)
            if len(payload16) <= n_bytes_data:
                hd.micro_block_size = 16
                image_mode = ImageEncodeMode.TILING
                payload = payload16
                n_bytes_data = len(payload16)
            else:
                hd.micro_block_size = 8

        try_huffman = hd.try_huffman_int() or hd.try_huffman_flt()
        # flag byte(s) + data
        if n_one_sweep <= n_bytes_data + (1 if try_huffman else 0):
            body = b"\x01" + self._write_one_sweep()
        else:
            body = b"\x00"
            if try_huffman:
                body += bytes([int(image_mode)])
            body += payload
        return self._assemble(mask_section, ranges_section, body)

    # -- sections -----------------------------------------------------------

    def _build_mask_section(self) -> bytes:
        need_mask = 0 < self.num_valid < self.n_rows * self.n_cols
        if need_mask and self.encode_mask:
            mask_rle = rle.compress(bool_to_bits(self.mask))
            return struct.pack("<i", len(mask_rle)) + mask_rle
        return struct.pack("<i", 0)

    def _assemble(self, mask_section: bytes, ranges_section: bytes, body: bytes) -> bytes:
        hd = self.hd
        hd.blob_size = hdr.header_size(self.version) + len(mask_section) + len(ranges_section) + len(body)
        blob = bytearray(hdr.write_header(hd))
        blob += mask_section
        blob += ranges_section
        blob += body
        if self.version >= 3:
            skip = hdr.checksum_skip(self.version)
            checksum = fletcher32.fletcher32(bytes(blob[skip:]))
            struct.pack_into("<I", blob, skip - 4, checksum)
            hd.checksum = checksum
        return bytes(blob)

    def _write_one_sweep(self) -> bytes:
        return self.data[self.mask].tobytes()

    # -- tiling path --------------------------------------------------------

    def _write_tiles(self, mb: int) -> bytes:
        hd = self.hd
        mze = hd.max_z_error
        int_type = dt_is_int(self.dt)
        mbsq = mb * mb
        vmask_b, nbv, nbh = _blockize(self.mask, mb, pad_val=False)
        n_blocks = nbv * nbh
        # j0 per block for the integrity bits
        j0s = (np.arange(n_blocks) % nbh) * mb
        integrity = ((j0s >> 3) & 15) << 2
        if self.version >= 5:
            integrity &= 0b111000  # bit 2 reserved for diff encoding

        cnt = vmask_b.sum(axis=1).astype(np.int64)

        out = bytearray()
        size_t = DT_SIZE[self.dt]
        scale = 1.0 / (2 * mze) if mze > 0 else 0.0
        int_lossless = int_type and mze == 0.5

        per_depth = []  # vectorized per-depth block arrays; emission is block-major
        for d in range(self.n_depth):
            xb, _, _ = _blockize(self.data[:, :, d], mb)
            xf = xb.astype(np.float64)
            big = np.where(vmask_b, xf, np.inf)
            small = np.where(vmask_b, xf, -np.inf)
            zmin = np.where(cnt > 0, big.min(axis=1), 0.0)
            zmax = np.where(cnt > 0, small.max(axis=1), 0.0)

            # cntSameVal: consecutive equal values over the valid sequence
            pos = np.arange(mbsq)
            idx = np.where(vmask_b, pos[None, :], -1)
            runmax = np.maximum.accumulate(idx, axis=1)
            prev_idx = np.empty_like(runmax)
            prev_idx[:, 0] = -1
            prev_idx[:, 1:] = runmax[:, :-1]
            if self.all_valid:
                prev_vals = np.where(
                    prev_idx >= 0, np.take_along_axis(xf, np.maximum(prev_idx, 0), axis=1), 0.0
                )
                same = vmask_b & (xf == prev_vals)
            else:
                has_prev = prev_idx >= 0
                prev_vals = np.take_along_axis(xf, np.maximum(prev_idx, 0), axis=1)
                same = vmask_b & has_prev & (xf == prev_vals)
            cnt_same = same.sum(axis=1)

            try_lut = (cnt > 4) & (zmax > zmin + 3 * mze) & (2 * cnt_same > cnt)

            # quantization (f64, matches Lerc2.h:358-376); invalid lanes are
            # never emitted but can hold NaN/inf from masked-out pixels --
            # sanitize them so the int casts stay warning-free
            xq = np.where(vmask_b, xf, zmin[:, None])
            # blocks with non-finite values are forced raw / const-offset
            # below and never consume quant, but the vectorized pass still
            # computes their lanes (inf - inf = NaN): suppress the numpy
            # warning the serial reference cannot emit
            with np.errstate(invalid="ignore", over="ignore"):
                if int_lossless:
                    quant = (xq - zmin[:, None]).astype(np.int64).astype(np.uint32)
                elif mze > 0:
                    quant = np.floor((xq - zmin[:, None]) * scale + 0.5).astype(np.int64).astype(np.uint32)
                else:
                    quant = np.zeros_like(xb, dtype=np.uint32)

            # empty blocks carry ±inf stats and inf/NaN data can make
            # max_val non-finite: clip BEFORE the int cast (the cast of a
            # non-finite is a numpy RuntimeWarning + garbage); force_raw
            # below still compares the unclipped value, so inf-valued
            # blocks keep forcing raw mode
            with np.errstate(invalid="ignore", over="ignore"):
                max_val = (zmax - zmin) * scale if mze > 0 else np.zeros(n_blocks)
                max_elem = np.floor(
                    np.nan_to_num(max_val, nan=0.0, posinf=1e18, neginf=0.0) + 0.5
                ).astype(np.int64)

            # block classification
            is_empty = cnt == 0
            is_const0 = (~is_empty) & (zmin == 0) & (zmax == 0)
            force_raw = ((mze == 0) & (zmax > zmin)) | ((mze > 0) & (max_val > self.max_val_quant))
            per_depth.append((xb, zmin, try_lut, quant, max_elem, is_empty | is_const0, force_raw))

        # depth-diff candidates: int lossless, v5+, nDepth > 1 (Lerc2.cpp:1495)
        try_diff = (
            self.version >= 5 and self.n_depth > 1 and int_lossless
        )
        per_depth_diff = []
        if try_diff:
            check_overflow = self.dt in (DataType.INT, DataType.UINT) and (
                hd.z_max - hd.z_min >= 0x7FFFFFFF
            )
            prev_xb = None
            for d in range(self.n_depth):
                xb = per_depth[d][0]
                if d == 0:
                    per_depth_diff.append(None)
                    prev_xb = xb
                    continue
                diff = xb.astype(np.int64) - prev_xb.astype(np.int64)
                overflow = np.zeros(n_blocks, dtype=bool)
                if check_overflow:
                    bad = (diff > 0x7FFFFFFF) | (diff < -0x7FFFFFFF - 1)
                    overflow = (bad & vmask_b).any(axis=1)
                diff = diff.astype(np.int64)
                big = np.where(vmask_b, diff, 2**62)
                small = np.where(vmask_b, diff, -(2**62))
                zmin_d = np.where(cnt > 0, big.min(axis=1), 0)
                zmax_d = np.where(cnt > 0, small.max(axis=1), 0)
                # cntSameVal over the valid diff sequence (masked rule)
                pos = np.arange(mbsq)
                idx = np.where(vmask_b, pos[None, :], -1)
                runmax = np.maximum.accumulate(idx, axis=1)
                prev_i = np.empty_like(runmax)
                prev_i[:, 0] = -1
                prev_i[:, 1:] = runmax[:, :-1]
                has_prev = prev_i >= 0
                prev_vals = np.take_along_axis(diff, np.maximum(prev_i, 0), axis=1)
                same = vmask_b & has_prev & (diff == prev_vals)
                cnt_same = same.sum(axis=1)
                try_lut_d = (cnt > 4) & (zmax_d > zmin_d + 3 * mze) & (2 * cnt_same > cnt)
                quant_d = (diff - zmin_d[:, None]).astype(np.int64)
                max_elem_d = zmax_d - zmin_d
                per_depth_diff.append((zmin_d, zmax_d, try_lut_d, quant_d, max_elem_d, overflow))
                prev_xb = xb

        def candidate(z0, dt_base, qv, me, want_lut, n_valid, n_bytes_raw):
            """(n_bytes, payload or None). payload excludes the flag byte;
            None means raw wins. Mirrors NumBytesTile (Lerc2.h:417-453)."""
            tc, dt_red = _reduce_data_type(z0, dt_base)
            n_bytes = 1 + DT_SIZE[dt_red]
            use_lut = False
            if me > 0:
                if want_lut:
                    sorted_q = np.sort(qv)
                    lut_bytes, use_lut = bitstuffer.compute_bytes_lut(sorted_q, n_valid)
                    n_bytes += lut_bytes
                    if use_lut:
                        n_lut = int(np.count_nonzero(sorted_q[1:] != sorted_q[:-1]))
                        if not (0 < n_lut < 255) or sorted_q[0] != 0:
                            use_lut = False
                            n_bytes = 1 + DT_SIZE[dt_red] + bitstuffer.compute_bytes_simple(
                                n_valid, int(qv.max())
                            )
                else:
                    n_bytes += bitstuffer.compute_bytes_simple(n_valid, me)
            if n_bytes >= n_bytes_raw:
                return n_bytes_raw, None
            payload = bytearray()
            payload += _write_variable_value(z0, dt_red)
            if me > 0:
                if use_lut:
                    payload += bitstuffer.encode_lut(qv, self.version)
                else:
                    payload += bitstuffer.encode_simple(qv, self.version)
            mode_bits = (3 if me == 0 else 1) | (tc << 6)
            return n_bytes, (mode_bits, bytes(payload))

        for b in range(n_blocks):
            flag = int(integrity[b])
            n_valid = int(cnt[b])
            valid_row = vmask_b[b]
            for d in range(self.n_depth):
                xb, zmin, try_lut, quant, max_elem, is_const0, force_raw = per_depth[d]
                if is_const0[b]:
                    out.append(flag | 2)
                    continue
                n_bytes_raw = 1 + n_valid * size_t
                if force_raw[b]:
                    out.append(flag | 0)
                    out += xb[b][valid_row].tobytes()
                    continue
                qv = quant[b][valid_row]
                abs_nb, abs_rec = candidate(
                    float(zmin[b]), self.dt, qv, int(max_elem[b]),
                    bool(try_lut[b]), n_valid, n_bytes_raw,
                )
                # diff candidate (strictly smaller wins, Lerc2.cpp:1640)
                diff_choice = None
                if try_diff and d > 0 and n_valid > 0 and per_depth_diff[d] is not None:
                    zmin_d, zmax_d, try_lut_d, quant_d, max_elem_d, overflow = per_depth_diff[d]
                    if not overflow[b]:
                        z0d, zxd = int(zmin_d[b]), int(zmax_d[b])
                        if z0d == 0 and zxd == 0:
                            if 1 < abs_nb:
                                diff_choice = (1, bytes([flag | 2 | 4]))
                        else:
                            med = int(max_elem_d[b])
                            if not (mze > 0 and med > self.max_val_quant):
                                qvd = quant_d[b][valid_row].astype(np.uint32)
                                dnb, drec = candidate(
                                    float(z0d), DataType.INT, qvd, med,
                                    bool(try_lut_d[b]), n_valid, n_bytes_raw,
                                )
                                if drec is not None and dnb < abs_nb:
                                    mode_bits, payload = drec
                                    diff_choice = (
                                        dnb, bytes([flag | 4 | mode_bits]) + payload
                                    )
                if diff_choice is not None:
                    out += diff_choice[1]
                elif abs_rec is None:
                    out.append(flag | 0)
                    out += xb[b][valid_row].tobytes()
                else:
                    mode_bits, payload = abs_rec
                    out.append(flag | mode_bits)
                    out += payload
        return bytes(out)

    # -- whole-image Huffman (8-bit types) ----------------------------------

    def _huffman_symbol_streams(self) -> tuple[np.ndarray, np.ndarray]:
        """(direct symbols pixel-major, delta symbols depth-major), with the
        char offset applied (Lerc2.cpp:2311-2380)."""
        offset = 128 if self.dt == DataType.CHAR else 0
        h, w, nd = self.n_rows, self.n_cols, self.n_depth
        mask = self.mask
        vals = self.data[mask]  # [numValid, nDepth] pixel-major
        # kBin = offset + (int)val: uint8 -> val, int8 -> val + 128
        direct = (vals.astype(np.int16) + offset).astype(np.uint8).reshape(-1)

        # delta symbols, per depth over valid pixels in scan order
        deltas = []
        left_ok = np.zeros((h, w), dtype=bool)
        left_ok[:, 1:] = mask[:, 1:] & mask[:, :-1]
        above_ok = np.zeros((h, w), dtype=bool)
        above_ok[1:, :] = mask[1:, :] & mask[:-1, :]
        use_above = ((~left_ok) & above_ok & mask)[mask]
        for d in range(nd):
            plane = self.data[:, :, d]
            vseq = plane[mask]
            scan_prev = np.zeros_like(vseq)
            scan_prev[1:] = vseq[:-1]
            above_vals = np.zeros_like(plane)
            above_vals[1:, :] = plane[:-1, :]
            prev = np.where(use_above, above_vals[mask], scan_prev)
            # delta = (T)(val - prev) with native wraparound, then + offset
            delta_t = (vseq.astype(np.int16) - prev.astype(np.int16)).astype(self.np_dt)
            deltas.append((delta_t.astype(np.int16) + offset).astype(np.uint8))
        return direct, np.concatenate(deltas)

    def _encode_huffman_int(self) -> tuple[ImageEncodeMode, bytes] | None:
        direct, delta = self._huffman_symbol_streams()
        histo = np.bincount(direct, minlength=256).astype(np.int64)
        dhisto = np.bincount(delta, minlength=256).astype(np.int64)

        def size_of(h):
            lengths = huffman.compute_code_lengths(h)
            if lengths is None:
                return None, None
            nb = huffman.compute_compressed_size(h, lengths)
            return (nb if nb > 0 else None), lengths

        nb0, len0 = (size_of(histo) if self.version >= 4 else (None, None))
        nb1, len1 = size_of(dhisto)
        if nb0 is None and nb1 is None:
            return None
        if nb0 is not None and (nb1 is None or nb0 <= nb1):
            mode, lengths, syms = ImageEncodeMode.HUFFMAN, len0, direct
        else:
            mode, lengths, syms = ImageEncodeMode.DELTA_HUFFMAN, len1, delta
        codes = huffman.canonical_codes(lengths)
        table = huffman.write_code_table(lengths, codes, self.version)
        stream = huffman.encode_symbols(syms.astype(np.int64), lengths, codes)
        return mode, table + stream

    # -- maxZError auto-raise for floats (Lerc2.cpp:1233-1339) --------------

    def _try_raise_max_z_error(self, mze: float) -> tuple[bool, float]:
        return try_raise_max_z_error(torch.from_numpy(np.require(self.data, requirements=["C", "W"])),
                                     torch.from_numpy(self.mask), mze)

    # -- integer bit-plane noise cut (Lerc2.cpp:1071-1229) ------------------

    def _try_bit_plane_compression(self, eps: float) -> tuple[bool, float]:
        return try_bit_plane_compression(
            torch.from_numpy(self.data.astype(np.int64)), torch.from_numpy(self.mask), self.dt,
            self.n_depth, self.num_valid, eps)


_Z_ERR_CAND = (1, 0.5, 0.1, 0.05, 0.01, 0.005, 0.001, 0.0005, 0.0001)
_Z_FAC_CAND = (1, 2, 10, 20, 100, 200, 1000, 2000, 10000)


def try_raise_max_z_error(data: torch.Tensor, mask: torch.Tensor, mze: float) -> tuple[bool, float]:
    """Float maxZError auto-raise for pre-truncated data (Lerc2.cpp:1233-1339):
    if every valid value lies within mze/2 of a 1/zFac grid, the bound rises
    to that candidate's zErr/2. data [H, W, D], mask [H, W] bool, on one
    device. NaN deltas (from non-finite values) are skipped, as the
    reference's std::max tracking skips them."""
    cands = [(e / 2, f) for e, f in zip(_Z_ERR_CAND, _Z_FAC_CAND) if e / 2 > mze]
    if not cands:
        return False, mze
    vals = data[mask].to(torch.float64).reshape(-1)
    for z_err, z_fac in cands:
        z = vals * z_fac
        dz = (torch.floor(z + 0.5) - z).abs()
        dz = dz[~torch.isnan(dz)]
        round_err = float(dz.max()) if dz.numel() else 0.0
        if round_err / z_fac <= mze / 2:
            return True, z_err
    return False, mze


def try_bit_plane_compression(data: torch.Tensor, mask: torch.Tensor, dt: DataType,
                              n_depth: int, num_valid: int, eps: float) -> tuple[bool, float]:
    """Integer bit-plane noise cut for a negative maxZError
    (Lerc2.cpp:1071-1229): per bit plane and depth, the share of horizontal
    and vertical neighbour pairs (both valid) whose bits differ; random low
    planes are cut by raising maxZError. Returns (ok, new maxZError)."""
    if eps <= 0 or num_valid < 5000 or not dt_is_int(dt):
        return False, 0.0
    max_shift = 8 * DT_SIZE[dt]
    x = data.to(torch.int64)  # sign-extended: xor on two's complement bits
    cnt_diff = torch.zeros(n_depth, max_shift, dtype=torch.int64, device=x.device)
    cnt = 0
    for a, b, pair in ((x[:, :-1], x[:, 1:], mask[:, :-1] & mask[:, 1:]),
                       (x[:-1], x[1:], mask[:-1] & mask[1:])):
        v = (a ^ b)[pair]  # [nPairs, nDepth]
        cnt += v.shape[0]
        for s in range(max_shift):
            cnt_diff[:, s] += ((v >> s) & 1).sum(0)
    if cnt < 5000:
        return False, 0.0
    cnt_diff = cnt_diff.cpu().tolist()
    n_cut_found = 0
    last_plane_kept = 0
    for s in range(max_shift - 1, -1, -1):
        b_crit = all(abs(1 - 2 * (cnt_diff[d][s] / cnt)) < eps for d in range(n_depth))
        if b_crit and n_cut_found < 2:
            if n_cut_found == 0:
                last_plane_kept = s
            if n_cut_found == 1 and s < last_plane_kept - 1:
                last_plane_kept = s
                n_cut_found = 0
            n_cut_found += 1
    last_plane_kept = max(0, last_plane_kept)
    return True, float((1 << last_plane_kept) >> 1)
