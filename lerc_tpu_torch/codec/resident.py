"""Device-resident fused codec: the blob stays on the device end to end.

Port of ``lerc_tpu/codec/resident.py::FusedResidentCodec`` (:327-569) for
float32 rasters, all-valid or with a validity mask (:76-102, :343-377).
``encode_fast`` builds the whole blob on the
device -- the record stream (kernels K1, K2), the header with its blobSize,
zMin/zMax and ranges fields, and the Fletcher32 checksum (K3) -- and
``decode_fast`` verifies the checksum and decodes through the encoder's
record-offset index (K4). Neither reads anything back to the host.

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
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..constants import DT_SIZE, FILE_KEY_LERC2, NUMPY_TO_DT, DataType, dt_is_int
from ..ops import device_decode, device_encode, device_scan
from . import header as hdr
from . import rle
from .bitmask import bool_to_bits
from .fletcher32 import fletcher32_partials


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


class FusedResidentCodec:
    """Encode/decode of [H, W, D] float32 tiles as device-resident Lerc2
    blobs (version >= 4, 8x8 micro blocks). `mask` is an optional [H, W]
    bool validity mask (numpy or tensor) shared by every depth; invalid
    pixels decode to +0.0."""

    def __init__(self, h: int, w: int, d: int = 1, dtype=np.float32,
                 max_z_error: float = 0.001, version: int = 6, nb_cap: int = 0,
                 mask=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.dt = NUMPY_TO_DT[np.dtype(dtype)]
        if dt_is_int(self.dt):
            raise NotImplementedError("integer dtypes: ROADMAP queue 1 item 5 (ResidentCodec)")
        if self.dt != DataType.FLOAT:
            raise NotImplementedError("float64: ROADMAP queue 1 item 9")
        if version < 4:
            raise ValueError("fused resident codec requires version >= 4")
        if h % 8 or w % 8:
            raise ValueError("resident codec requires H, W multiples of 8")
        self.h, self.w, self.d = h, w, d
        self.version = version
        self.mze = float(max_z_error)
        self.nb_cap = int(nb_cap)
        mask_section = self._set_mask(mask)
        n_rec = (h // 8) * (w // 8) * d
        self.n_rec = n_rec
        raw = h * w * DT_SIZE[self.dt] * d + n_rec * 12 + 4096
        self.cap = -(-raw // 1024) * 1024
        if self.nb_cap:
            # under a bit-width cap raw records flip `fits`, so the widest
            # record is the capped stuff record: a tighter capacity
            per_rec = 1 + 4 + 1 + 2 + (64 * min(self.nb_cap, 8 * DT_SIZE[self.dt]) + 7) // 8
            tight = n_rec * per_rec + 4096
            self.cap = min(self.cap, -(-tight // 1024) * 1024)

        head = hdr.HeaderInfo(
            version=version, n_rows=h, n_cols=w, n_depth=d,
            num_valid_pixel=self.num_valid, micro_block_size=8, dt=self.dt,
            max_z_error=self.mze,
        )
        head_bytes = hdr.write_header(head)
        self._head_len = len(head_bytes)
        self._skip = hdr.checksum_skip(version)
        # the static mask section's even part folds into the checksum; an
        # odd last byte is the first byte of the dynamic tail
        odd = len(mask_section) % 2
        self._static_mid = mask_section[: len(mask_section) - odd]
        self._static_ab = fletcher32_partials(
            self._static_mid, (self._head_len - self._skip) // 2) + (len(self._static_mid),)
        template = bytearray(head_bytes) + mask_section[len(mask_section) - odd :]
        self._ranges_off = len(template)
        template += b"\x00" * (2 * d * DT_SIZE[self.dt])  # ranges
        template += b"\x00"  # one-sweep flag
        if version >= 6 and self.mze == 0:  # Huffman is tried: image encode mode byte
            template += b"\x00"  # tiling
        self._template = torch.tensor(list(template), dtype=torch.uint8, device=self.device)
        self._hdr_small_len = len(template)
        self._hdr_len = len(template) + len(self._static_mid)
        self._blob_size_off = len(FILE_KEY_LERC2) + 4 + 4 + 5 * 4
        self._zmin_off = len(FILE_KEY_LERC2) + 4 + 4 + 8 * 4 + 4 + 8

    def _set_mask(self, mask) -> bytes:
        """Sets num_valid and the block validity words `valid` (None: all
        valid); returns the wire's mask section."""
        h, w = self.h, self.w
        self.num_valid, self.valid = h * w, None
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
        mask_rle = rle.compress(bool_to_bits(mask_np))
        return struct.pack("<i", len(mask_rle)) + mask_rle

    # ---- encode -----------------------------------------------------------

    def encode_fast(self, data: torch.Tensor):
        """-> (header [hdrLen] uint8, stream [cap/4] int32 u32 words,
        meta [3] int32 = {total, checksum, fits}, starts [nRec] int32)."""
        if data.device.type != self.device.type:
            raise ValueError(f"data is on {data.device}, the codec on {self.device}")
        d_ = self.d
        stream, total, zminv, zmaxv, starts, fits = device_encode.encode_tiles(
            data, self.valid, self.mze, self.h, self.w, d_, self.dt, self.valid is None,
            self.version, self.cap, nb_cap=self.nb_cap)
        dev = data.device
        header = self._template.to(dev, copy=True)
        bs = self._blob_size_off
        header[bs : bs + 4] = _u32_bytes(total.to(torch.int64) + self._hdr_len)
        zz = torch.stack([zminv.min(), zmaxv.max()]).to(torch.float64)
        header[self._zmin_off : self._zmin_off + 16] = zz.view(torch.uint8)
        ro = self._ranges_off
        header[ro : ro + 8 * d_] = torch.cat([zminv, zmaxv]).view(torch.uint8)
        checksum = device_scan.fletcher32_parts(
            header[self._skip : self._head_len], self._static_ab,
            header[self._head_len :], stream, total.reshape(1))
        header[self._skip - 4 : self._skip] = _u32_bytes(checksum.to(torch.int64))
        meta = torch.stack([total, checksum, fits.to(torch.int32)])
        return header, stream, meta, starts

    # ---- decode -----------------------------------------------------------

    def decode_fast(self, header: torch.Tensor, stream: torch.Tensor,
                    starts: torch.Tensor | None = None):
        """-> (img [H, W, D] float32, ok 0-d bool = checksum ok & index ok &
        fits), scan-free through the encoder's record-offset index."""
        if starts is None:
            if self.valid is not None:
                raise ValueError("masked resident decode requires the record-offset index")
            raise NotImplementedError(
                "decode without the record-offset index: ROADMAP queue 1 item 5 "
                "(device record scan)")
        if header.shape != (self._hdr_small_len,) or header.dtype != torch.uint8:
            raise ValueError(
                "header length does not match this codec's configuration "
                "(different mask/shape/dtype/version?)")
        total = (_rd_u32(header, self._blob_size_off) - self._hdr_len).to(torch.int32)
        stored = _rd_u32(header, self._skip - 4)
        computed = device_scan.fletcher32_parts(
            header[self._skip : self._head_len], self._static_ab,
            header[self._head_len :], stream, total.reshape(1))
        ok = (computed.to(torch.int64) & 0xFFFFFFFF) == stored
        nbytes = 4 * self.d
        zmax_vec = header[self._ranges_off + nbytes : self._ranges_off + 2 * nbytes]
        zmax_vec = zmax_vec.clone().view(torch.float32)
        img, index_ok, fits = device_decode.decode_tiles_fast(
            stream, starts, self.mze, zmax_vec, self.h, self.w, self.d, self.dt,
            self.version, nb_cap=self.nb_cap, mask=self.valid)
        return img, ok & index_ok & fits

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
