"""Carry a resident blob and its codec configuration between the JAX
package and the port.

The codec has no weights: its state is the configuration and the blob. On
the JAX side the fused blob is four device arrays (``header`` u8, ``stream``
u32 words, ``meta`` i32, ``starts`` i32) that ``numpy.asarray`` brings to
the host; on the port's side the same four are tensors, with the u32 words
held in an int32 tensor. A ``ResidentBlob`` carries its header as host
bytes, the stream, total, checksum and the optional index. A band codec's
``DecodedBand`` holds its data as a tensor on the decode device;
``decoded_band_to_numpy`` gives its fields as JAX's ``DecodedBand`` holds
them, float64 bands included. The band codec's acceleration index needs no
conversion: in both packages ``encode_band_device(..., return_index=True)``
returns the same plain dict, ``{"huffman_sbits": int32 numpy array}`` for a
Huffman blob, ``{"fpl_sbits": {plane: int32 numpy array}}`` for an fpl blob
(one entry per Huffman-coded byte plane, possibly none: planes 0-3 of a
float32 band, 0-7 of a float64 one), None otherwise; either package's
``decode_band_device(blob, index=...)`` takes the other's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .codec import header as hdr
from .codec.resident import ResidentBlob


def blob_from_numpy(header, stream, meta, starts, device="cuda"):
    """numpy (header u8, stream u32, meta i32, starts i32) -> the port's
    tensors on `device`."""
    header = np.ascontiguousarray(header, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint32)
    return (torch.from_numpy(header.copy()).to(device),
            torch.from_numpy(stream.view(np.int32).copy()).to(device),
            torch.from_numpy(np.asarray(meta, dtype=np.int32).copy()).to(device),
            torch.from_numpy(np.asarray(starts, dtype=np.int32).copy()).to(device))


def blob_to_numpy(header, stream, meta, starts):
    """The port's blob tensors -> numpy (header u8, stream u32, meta i32,
    starts i32), as the JAX codec takes them."""
    return (header.cpu().numpy().astype(np.uint8),
            stream.cpu().numpy().view(np.uint32),
            meta.cpu().numpy().astype(np.int32),
            starts.cpu().numpy().astype(np.int32))


def resident_blob_from_numpy(header: bytes, stream, total: int, checksum: int,
                             starts=None, device="cuda") -> ResidentBlob:
    """A JAX ``ResidentBlob``'s fields (header bytes, stream u32 or u8
    array, total, checksum, starts i32 array or None) -> the port's
    ``ResidentBlob`` on `device` (its header parsed again by the port)."""
    stream = np.ascontiguousarray(stream)
    if stream.dtype == np.uint8:
        stream = np.concatenate([stream, np.zeros(-stream.size % 4, np.uint8)]).view(np.uint32)
    words = torch.from_numpy(np.asarray(stream, dtype=np.uint32).view(np.int32).copy()).to(device)
    idx = None if starts is None else torch.from_numpy(
        np.asarray(starts, dtype=np.int32).copy()).to(device)
    head, _ = hdr.read_header(bytes(header))
    head.checksum = int(checksum)
    return ResidentBlob(bytes(header), words, int(total), int(checksum), head, idx)


def resident_blob_to_numpy(blob: ResidentBlob) -> dict:
    """The port's ``ResidentBlob`` -> plain fields (header bytes, stream u32
    array, total, checksum, starts i32 array or None), from which the JAX
    ``ResidentBlob(header, jnp.asarray(stream), total, checksum, hd,
    starts)`` is built."""
    return dict(header=blob.header, stream=blob.stream.cpu().numpy().view(np.uint32),
                total=blob.total, checksum=blob.checksum,
                starts=None if blob.starts is None else blob.starts.cpu().numpy().astype(np.int32))


def codec_kwargs(h: int, w: int, d: int, dtype, max_z_error: float, version: int,
                 nb_cap: int, mask=None) -> dict:
    """Keyword arguments of the port's ``ResidentCodec`` and
    ``FusedResidentCodec`` matching the JAX ``ResidentCodec(h, w, d, dtype,
    max_z_error, version, nb_cap, mask=mask)`` (any float32 or integer
    dtype); plain values only (the mask as a numpy bool array). Use as
    ``FusedResidentCodec(**codec_kwargs(...), device=...)``."""
    return dict(h=int(h), w=int(w), d=int(d), dtype=np.dtype(dtype),
                max_z_error=float(max_z_error), version=int(version), nb_cap=int(nb_cap),
                mask=None if mask is None else np.array(mask, dtype=bool))


def decoded_band_to_numpy(band) -> dict:
    """The port's ``DecodedBand`` -> plain fields (the header's fields as a
    dict, mask bool array, data array in the native dtype -- float64 for a
    float64 band --, z_min_vec,
    z_max_vec, consumed), to compare field by field with JAX's
    ``DecodedBand`` (whose ``hd`` is the JAX HeaderInfo)."""
    return dict(hd=dataclasses.asdict(band.hd), mask=np.asarray(band.mask, dtype=bool),
                data=band.data.cpu().numpy(), z_min_vec=band.z_min_vec,
                z_max_vec=band.z_max_vec, consumed=int(band.consumed))
