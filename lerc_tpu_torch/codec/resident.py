"""Device-resident codecs: the blob stays on the device end to end.

Port of ``lerc_tpu/codec/resident.py``: ``ResidentCodec`` (:43-267) and
``FusedResidentCodec`` (:327-569), for float32 and every integer dtype,
all-valid or with a validity mask (:76-102, :343-377).

``ResidentCodec.encode`` runs the record stream on the device (kernels K1,
K2; an unfit ``nb_cap`` tile is re-encoded uncapped) and builds the header
on the host; ``decode`` verifies the Fletcher32 checksum (K3) and decodes
through the encoder's record-offset index (K4) or, without it, through the
device record scan (K5) and the scanned-record decode (K6).

``FusedResidentCodec.encode_fast`` builds the whole blob on the device --
the record stream, the header with its blobSize, zMin/zMax and ranges
fields, and the checksum -- and ``decode_fast`` verifies the checksum and
decodes through the index (K4) or the scan (K5, K6). Neither reads anything
back to the host.

The header layout and the Fletcher32 split carry over: the device builds
only the small dynamic header (fixed head + ranges + flags); the static
mask section (4 zero bytes for all-valid data, else the int32 length and
the RLE of the bit mask) folds into the checksum as two host constants,
and ``blob_to_bytes`` splices it back for the wire. An odd section's last
byte rides at the front of the dynamic tail, so the static part stays
even.

A mask is turned once per codec into two u32 validity words per 8x8 block
(``device_encode.block_valid_words``) on the codec's device; the masked
kernels read those. An all-True mask takes the all-valid wire and kernels.
Without the index a masked blob's records are found by the host record
scanner (``ops/tile_scan``; a masked record's size depends on its block's
valid count, which the device scan K5 cannot know) and decoded by the masked
K6, depth-diff records included (:269-315, where JAX refuses those).

Integer dtypes use maxZError max(0.5, floor(maxZError)) (:58-59); 1- and
2-byte ranges are the low bytes of the int32 range values.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..constants import (DT_SIZE, DT_TO_NUMPY, DT_TO_TORCH, FILE_KEY_LERC2, NUMPY_TO_DT,
                         DataType, as_signed, dt_is_int, dt_is_signed)
from ..ops import device_decode, device_encode, device_scan, tile_scan
from . import header as hdr
from . import rle
from .bitmask import bool_to_bits
from .fletcher32 import fletcher32_partials

_NO_STATIC = (0, 0, 0)  # Fletcher32 partials of an empty static segment


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises (the
    codec never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class ResidentBlob:
    """A resident blob: the header on the host, the payload on the device."""

    header: bytes                  # header + mask + ranges + flag bytes
    stream: torch.Tensor           # [cap/4] int32 u32 words (zero past total)
    total: int
    checksum: int
    hd: hdr.HeaderInfo
    starts: torch.Tensor | None = None  # [nRec] int32 record-offset index

    def to_bytes(self) -> bytes:
        """The standard Lerc2 blob on the host (synchronizes)."""
        return self.header + self.stream.cpu().numpy().tobytes()[: self.total]


class ResidentCodec:
    """Encode/decode of [H, W, D] tiles (float32 or any integer dtype) as
    device-resident Lerc2 blobs (8x8 micro blocks). `mask` is an optional
    [H, W] bool validity mask (numpy or tensor) shared by every depth;
    invalid pixels decode to 0."""

    def __init__(self, h: int, w: int, d: int = 1, dtype=np.float32,
                 max_z_error: float = 0.001, version: int = 6, nb_cap: int = 0,
                 mask=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.dt = NUMPY_TO_DT[np.dtype(dtype)]
        if self.dt == DataType.DOUBLE:
            raise NotImplementedError(
                "float64 has no resident codec (JAX's ResidentCodec has none either): use "
                "encode_band_device / decode_band_device")
        if h % 8 or w % 8:
            raise ValueError("resident codec requires H, W multiples of 8")
        self.h, self.w, self.d = h, w, d
        self.version = version
        self.nb_cap = int(nb_cap)
        self.mze = float(max_z_error)
        if dt_is_int(self.dt):
            self.mze = max(0.5, float(np.floor(self.mze)))
        self._mask_section = self._set_mask(mask)
        n_rec = (h // 8) * (w // 8) * d
        self.n_rec = n_rec
        raw = h * w * DT_SIZE[self.dt] * d + n_rec * 12 + 4096
        self.cap = -(-raw // 1024) * 1024
        self.cap_full = self.cap  # the uncapped re-encode's capacity
        if self.nb_cap:
            # under a bit-width cap raw records flip `fits`, so the widest
            # record is the capped stuff record: a tighter capacity
            per_rec = 1 + 4 + 1 + 2 + (64 * min(self.nb_cap, 8 * DT_SIZE[self.dt]) + 7) // 8
            tight = n_rec * per_rec + 4096
            self.cap = min(self.cap, -(-tight // 1024) * 1024)
        probe = hdr.HeaderInfo(version=version, dt=self.dt, max_z_error=self.mze)
        self._try_huffman = probe.try_huffman_int() or probe.try_huffman_flt()

    def _set_mask(self, mask) -> bytes:
        """Sets num_valid and the block validity words `valid` (None: all
        valid); returns the wire's mask section."""
        h, w = self.h, self.w
        self.num_valid, self.valid, self._mask_np = h * w, None, None
        if mask is None:
            return struct.pack("<i", 0)
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        mask_np = np.ascontiguousarray(mask, dtype=bool)
        if mask_np.shape != (h, w):
            raise ValueError(f"mask shape {mask_np.shape} does not match ({h}, {w})")
        self.num_valid = int(mask_np.sum())
        if self.num_valid == 0:
            raise ValueError("resident codec requires >= 1 valid pixel")
        if self.num_valid == h * w:  # an all-True mask: the all-valid wire
            return struct.pack("<i", 0)
        self.valid = device_encode.block_valid_words(torch.from_numpy(mask_np).to(self.device))
        self._mask_np = mask_np
        mask_rle = rle.compress(bool_to_bits(mask_np))
        return struct.pack("<i", len(mask_rle)) + mask_rle

    def _check_data(self, data: torch.Tensor) -> None:
        if data.device.type != self.device.type:
            raise ValueError(f"data is on {data.device}, the codec on {self.device}")

    def _encode_tiles(self, data, cap: int, nb_cap: int):
        return device_encode.encode_tiles(
            data, self.valid, self.mze, self.h, self.w, self.d, self.dt, self.valid is None,
            self.version, cap, nb_cap=nb_cap)

    def _tail_checksum(self, prefix: bytes, stream: torch.Tensor, total: int) -> int:
        """Fletcher32 of prefix || stream[:total] on the stream's device."""
        tail = torch.frombuffer(bytearray(prefix), dtype=torch.uint8).to(stream.device)
        empty = tail[:0]
        total_t = torch.tensor([total], dtype=torch.int32, device=stream.device)
        cs = device_scan.fletcher32_parts(empty, _NO_STATIC, tail, stream, total_t)
        return int(cs) & 0xFFFFFFFF

    # ---- encode -----------------------------------------------------------

    def encode(self, data: torch.Tensor) -> ResidentBlob:
        """[H, W, D] tile (float32, or the codec's integer dtype or int32)
        on the codec's device -> ResidentBlob (synchronizes: the header is
        built on the host)."""
        self._check_data(data)
        stream, total, zminv, zmaxv, starts, fits = self._encode_tiles(data, self.cap, self.nb_cap)
        if self.nb_cap and not bool(fits):
            stream, total, zminv, zmaxv, starts, fits = self._encode_tiles(
                data, self.cap_full, 0)
        total_i = int(total)
        zmin_vec = zminv.cpu().numpy().astype(np.float64)
        zmax_vec = zmaxv.cpu().numpy().astype(np.float64)
        head = hdr.HeaderInfo(
            version=self.version, n_rows=self.h, n_cols=self.w, n_depth=self.d,
            num_valid_pixel=self.num_valid, micro_block_size=8, dt=self.dt,
            max_z_error=self.mze, z_min=float(zmin_vec.min()), z_max=float(zmax_vec.max()),
        )
        np_dt = DT_TO_NUMPY[self.dt]
        ranges = flags = b""
        if head.z_min != head.z_max:
            ranges = zmin_vec.astype(np_dt).tobytes() + zmax_vec.astype(np_dt).tobytes()
            flags = b"\x00" + (b"\x00" if self._try_huffman else b"")
        else:
            total_i = 0  # constant image: no payload section
        head.blob_size = (hdr.header_size(self.version) + len(self._mask_section) + len(ranges)
                          + len(flags) + total_i)
        header_bytes = bytearray(hdr.write_header(head))
        header_bytes += self._mask_section + ranges + flags
        skip = hdr.checksum_skip(self.version)
        checksum = self._tail_checksum(bytes(header_bytes[skip:]), stream, total_i)
        struct.pack_into("<I", header_bytes, skip - 4, checksum)
        head.checksum = checksum
        return ResidentBlob(bytes(header_bytes), stream, total_i, checksum, head, starts)

    # ---- decode -----------------------------------------------------------

    def decode(self, blob: ResidentBlob, verify_checksum: bool = True) -> torch.Tensor:
        """[H, W, D] in the native dtype on the blob's device; raises
        ValueError on a checksum mismatch, an index that disagrees with the
        stream, or a record chain that does not end at the blob's total."""
        head, pos = hdr.read_header(blob.header)
        if verify_checksum:
            skip = hdr.checksum_skip(head.version)
            if self._tail_checksum(blob.header[skip:], blob.stream, blob.total) != head.checksum:
                raise ValueError("Lerc2 checksum mismatch")
        mlen = struct.unpack_from("<i", blob.header, pos)[0]
        pos += 4 + max(mlen, 0)
        np_dt = DT_TO_NUMPY[head.dt]
        d = head.n_depth
        dev = blob.stream.device
        shape = (head.n_rows, head.n_cols, d)
        if head.z_min == head.z_max:  # the constant at the valid pixels, 0 elsewhere
            img = torch.zeros(shape, dtype=DT_TO_TORCH[head.dt], device=dev)
            sel = (torch.ones(shape[:2], dtype=torch.bool, device=dev) if self._mask_np is None
                   else torch.from_numpy(self._mask_np).to(dev))
            const = torch.from_numpy(np.full(d, head.z_min).astype(np_dt)).to(dev)
            as_signed(img)[sel] = as_signed(const)
            return img
        z_max_vec = np.full(d, head.z_max)
        if head.version >= 4:
            nb = d * DT_SIZE[head.dt]
            pos += nb
            z_max_vec = np.frombuffer(blob.header[pos : pos + nb], dtype=np_dt).astype(np.float64)
        if dt_is_int(head.dt):
            zmax_arg = torch.from_numpy(np.round(z_max_vec).astype(np.int32)).to(dev)
        else:
            zmax_arg = torch.from_numpy(z_max_vec.astype(np.float32)).to(dev)
        if blob.starts is not None:
            img, index_ok, fits = self._decode_indexed(blob, head, zmax_arg, self.nb_cap)
            if self.nb_cap and not bool(fits):  # too narrow a cap: uncapped, still exact
                img, index_ok, fits = self._decode_indexed(blob, head, zmax_arg, 0)
            if not bool(index_ok):
                raise ValueError("record-offset index inconsistent with stream")
            return img
        if self.valid is not None:
            return self._decode_masked_scan(blob, head, z_max_vec)
        total = torch.tensor([blob.total], dtype=torch.int32, device=dev)
        img, ok = self._decode_scanned(blob.stream, total, head.max_z_error, zmax_arg, head)
        if not bool(ok):
            raise ValueError("Lerc2 record chain inconsistent with the blob's payload size")
        return img

    def _decode_masked_scan(self, blob: ResidentBlob, head: hdr.HeaderInfo,
                            z_max_vec: np.ndarray) -> torch.Tensor:
        """A masked blob without the index (resident.py:269-315): the host
        record scanner over the stream's bytes (one copy to the host), then
        the masked K6 on the device."""
        stream_np = blob.stream.view(torch.uint8)[: blob.total].cpu().numpy()
        cnts, j0s, n_blocks = tile_scan.block_scan_inputs(self._mask_np, 8)
        scan = tile_scan.tile_scan if blob.stream.is_cuda else tile_scan.tile_scan_ref
        recs, _used = scan(stream_np, cnts, j0s, n_blocks, head.n_depth, int(head.dt),
                           head.version)
        return device_decode.decode_tiles(blob.stream, 0, recs, self.valid, head, z_max_vec)

    def _decode_indexed(self, blob: ResidentBlob, head: hdr.HeaderInfo, zmax_arg, nb_cap: int):
        return device_decode.decode_tiles_fast(
            blob.stream, blob.starts, head.max_z_error, zmax_arg, head.n_rows, head.n_cols,
            head.n_depth, head.dt, head.version, nb_cap=nb_cap, mask=self.valid)

    def _decode_scanned(self, stream, total, max_z_error, zmax_vec, head):
        """K5 then K6 on an all-valid stream -> (img, ok = the chain ends at
        `total` and every record decoded); no host synchronization."""
        h, w, d, dt = head.n_rows, head.n_cols, head.n_depth, head.dt
        (_rp, mode, offset, nb, ne, payload_pos, lut_pos, n_lut, nbits_lut,
         chain_ok) = device_scan.scan_records(stream, (h // 8) * (w // 8) * d, dt,
                                              head.version, total)
        img, ok = device_decode.decode_scanned(
            stream, mode, payload_pos, offset, nb, ne, lut_pos, n_lut, nbits_lut, None,
            max_z_error, zmax_vec, h, w, d, dt, True, False)
        return img, chain_ok & ok


class FusedResidentCodec(ResidentCodec):
    """ResidentCodec whose encode/decode run on the device with no host
    synchronization, returning device tensors only (version >= 4)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.version < 4:
            raise ValueError("fused resident codec requires version >= 4")
        version, d, size = self.version, self.d, DT_SIZE[self.dt]
        head = hdr.HeaderInfo(
            version=version, n_rows=self.h, n_cols=self.w, n_depth=d,
            num_valid_pixel=self.num_valid, micro_block_size=8, dt=self.dt,
            max_z_error=self.mze,
        )
        head_bytes = hdr.write_header(head)
        self._head_len = len(head_bytes)
        self._skip = hdr.checksum_skip(version)
        # the static mask section's even part folds into the checksum; an
        # odd last byte is the first byte of the dynamic tail
        mask_section = self._mask_section
        odd = len(mask_section) % 2
        self._static_mid = mask_section[: len(mask_section) - odd]
        self._static_ab = fletcher32_partials(
            self._static_mid, (self._head_len - self._skip) // 2) + (len(self._static_mid),)
        template = bytearray(head_bytes) + mask_section[len(mask_section) - odd :]
        self._ranges_off = len(template)
        template += b"\x00" * (2 * d * size)  # ranges
        template += b"\x00"  # one-sweep flag
        if self._try_huffman:
            template += b"\x00"  # image encode mode: tiling
        self._template = torch.tensor(list(template), dtype=torch.uint8, device=self.device)
        self._hdr_small_len = len(template)
        self._hdr_len = len(template) + len(self._static_mid)
        # field offsets of this version's layout (hdr.write_header): JAX
        # hard-codes the v6 ones, which at v4/v5 put zMin/zMax 8 bytes past
        # their fields, over zMax and the mask section (ROADMAP queue 3)
        self._blob_size_off = len(FILE_KEY_LERC2) + 4 + 4 + 5 * 4
        n_dbl = 5 if version >= 6 else 3
        self._zmin_off = self._head_len - 8 * n_dbl + 8

    # ---- encode -----------------------------------------------------------

    def encode_fast(self, data: torch.Tensor):
        """-> (header [hdrLen] uint8, stream [cap/4] int32 u32 words,
        meta [3] int32 = {total, checksum, fits}, starts [nRec] int32)."""
        self._check_data(data)
        d_ = self.d
        stream, total, zminv, zmaxv, starts, fits = self._encode_tiles(data, self.cap, self.nb_cap)
        dev = data.device
        header = self._template.to(dev, copy=True)
        bs = self._blob_size_off
        header[bs : bs + 4] = _u32_bytes(total.to(torch.int64) + self._hdr_len)
        zz = torch.stack([zminv.to(torch.float32).min(),
                          zmaxv.to(torch.float32).max()]).to(torch.float64)
        header[self._zmin_off : self._zmin_off + 16] = zz.view(torch.uint8)
        # ranges: the native dtype's bytes (the low bytes of int32 values)
        size = DT_SIZE[self.dt]
        rbytes = torch.cat([zminv, zmaxv]).view(torch.uint8).reshape(2 * d_, 4)[:, :size]
        ro = self._ranges_off
        header[ro : ro + 2 * d_ * size] = rbytes.reshape(-1)
        checksum = device_scan.fletcher32_parts(
            header[self._skip : self._head_len], self._static_ab,
            header[self._head_len :], stream, total.reshape(1))
        header[self._skip - 4 : self._skip] = _u32_bytes(checksum.to(torch.int64))
        meta = torch.stack([total, checksum, fits.to(torch.int32)])
        return header, stream, meta, starts

    # ---- decode -----------------------------------------------------------

    def decode_fast(self, header: torch.Tensor, stream: torch.Tensor,
                    starts: torch.Tensor | None = None):
        """-> (img [H, W, D], ok 0-d bool). With the encoder's record-offset
        index `starts`: ok = checksum ok & index ok & fits (K3, K4). Without
        it (all-valid codecs): ok = checksum ok & the record chain ends at
        the blob's total & every record decoded (K3, K5, K6)."""
        if header.shape != (self._hdr_small_len,) or header.dtype != torch.uint8:
            raise ValueError(
                "header length does not match this codec's configuration "
                "(different mask/shape/dtype/version?)")
        if starts is None and self.valid is not None:
            raise ValueError("masked resident decode requires the record-offset index")
        total = (_rd_u32(header, self._blob_size_off) - self._hdr_len).to(torch.int32)
        stored = _rd_u32(header, self._skip - 4)
        computed = device_scan.fletcher32_parts(
            header[self._skip : self._head_len], self._static_ab,
            header[self._head_len :], stream, total.reshape(1))
        ok = (computed.to(torch.int64) & 0xFFFFFFFF) == stored
        zmax_vec = self._zmax_vec(header)
        if starts is None:
            head = hdr.HeaderInfo(version=self.version, n_rows=self.h, n_cols=self.w,
                                  n_depth=self.d, dt=self.dt)
            img, scan_ok = self._decode_scanned(stream, total.reshape(1), self.mze, zmax_vec, head)
            return img, ok & scan_ok
        img, index_ok, fits = device_decode.decode_tiles_fast(
            stream, starts, self.mze, zmax_vec, self.h, self.w, self.d, self.dt,
            self.version, nb_cap=self.nb_cap, mask=self.valid)
        return img, ok & index_ok & fits

    def _zmax_vec(self, header: torch.Tensor) -> torch.Tensor:
        """[D] zMax per depth from the header's ranges: float32, or int32
        for integer dtypes (1/2-byte values sign- or zero-extended)."""
        size = DT_SIZE[self.dt]
        nbytes = size * self.d
        zb = header[self._ranges_off + nbytes : self._ranges_off + 2 * nbytes]
        if size == 4:
            return zb.clone().view(torch.float32 if self.dt == DataType.FLOAT else torch.int32)
        zb = zb.reshape(self.d, size).to(torch.int64)
        acc = zb[:, 0] | (zb[:, 1] << 8 if size == 2 else 0)
        if dt_is_signed(self.dt):
            top = 1 << (8 * size - 1)
            acc = (acc ^ top) - top
        return acc.to(torch.int32)

    def blob_to_bytes(self, header: torch.Tensor, stream: torch.Tensor,
                      meta: torch.Tensor) -> bytes:
        """The standard Lerc2 blob on the host (synchronizes)."""
        total = int(meta[0])
        hb = header.cpu().numpy().tobytes()
        return (hb[: self._head_len] + self._static_mid + hb[self._head_len :]
                + stream.cpu().numpy().tobytes()[:total])


def _u32_bytes(x: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of a u32 held in a 0-d int64 tensor."""
    return ((x.reshape(1) >> torch.arange(0, 32, 8, device=x.device)) & 0xFF).to(torch.uint8)


def _rd_u32(header: torch.Tensor, off: int) -> torch.Tensor:
    b = header[off : off + 4].to(torch.int64)
    return b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24
