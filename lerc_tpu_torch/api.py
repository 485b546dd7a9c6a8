"""Public numpy-facing API, drop-in compatible with the reference `lerc`
Python package (its _lerc.py).

The port's own copy of ``lerc_tpu/api.py``: every function with JAX's
signature and return tuples. Those that encode or decode pixels take a
keyword-only ``device`` (default "cuda"): where the orchestrators route
large bands (``encode_orchestrator.encode_blob``,
``orchestrator.decode_blob``); "cuda" without a card raises RuntimeError,
``device="cpu"`` runs the band codec's plain PyTorch versions.

Shape convention: [nBands, nRows, nCols, nDepth] with 2D/3D/4D auto-detect
(`getLercShape`). All functions return `(result, ...)` tuples with result 0
on success, matching the reference binding; richer pythonic entry points
(`compress`/`decompress`) raise exceptions instead.
"""
from __future__ import annotations

import numpy as np

from .codec import header as hdr
from .codec import lerc1 as _l1
from .codec import lerc2_decode
from .codec.encode_orchestrator import LercEncodeError, encode_blob
from .codec.orchestrator import decode_blob, get_lerc_info
from .constants import NUMPY_TO_DT, ErrCode


# ---------------------------------------------------------------------------
# shape and dtype helpers (mirror _lerc.py:148-186)
# ---------------------------------------------------------------------------

def getLercDatatype(np_dtype) -> int:
    try:
        return int(NUMPY_TO_DT[np.dtype(np_dtype)])
    except KeyError:
        return -1


def getLercShape(np_arr: np.ndarray, n_values_per_pixel: int):
    n_bands = 1
    dim = np_arr.ndim
    shape = np_arr.shape
    if n_values_per_pixel == 1:
        if dim == 2:
            n_rows, n_cols = shape
        elif dim == 3:
            n_bands, n_rows, n_cols = shape
        else:
            return (0, 0, 0)
    elif n_values_per_pixel > 1:
        if dim == 3:
            n_rows, n_cols, nvpp = shape
        elif dim == 4:
            n_bands, n_rows, n_cols, nvpp = shape
        else:
            return (0, 0, 0)
        if nvpp != n_values_per_pixel:
            return (0, 0, 0)
    else:
        return (0, 0, 0)
    return (n_bands, n_rows, n_cols)


def _to_4d(np_arr: np.ndarray, n_values_per_pixel: int):
    n_bands, n_rows, n_cols = getLercShape(np_arr, n_values_per_pixel)
    if n_bands == 0:
        raise LercEncodeError(ErrCode.WRONG_PARAM, "unsupported array shape")
    return np.ascontiguousarray(np_arr).reshape(n_bands, n_rows, n_cols, n_values_per_pixel)


def findMaxZError(np_arr1, np_arr2):
    diff = np_arr2 - np_arr1
    return max(abs(float(diff.min())), abs(float(diff.max())))


def findMaxZError_4D(np_data_orig, np_data_dec, np_valid_mask_dec, n_bands):
    diff = np_data_dec - np_data_orig
    if np_valid_mask_dec is None:
        z_min, z_max = diff.min(), diff.max()
    else:
        if not np_valid_mask_dec.any():
            return 0
        if n_bands == 1 or np_valid_mask_dec.ndim == 3:
            z_min, z_max = diff[np_valid_mask_dec].min(), diff[np_valid_mask_dec].max()
        else:
            z_min, z_max = np.inf, -np.inf
            for m in range(n_bands):
                z_min = min(diff[m][np_valid_mask_dec].min(), z_min)
                z_max = max(diff[m][np_valid_mask_dec].max(), z_max)
    return max(abs(float(z_min)), abs(float(z_max)))


def findMaxZError_ma(npma_orig, npma_dec):
    diff = npma_dec - npma_orig
    return max(abs(float(diff.min())), abs(float(diff.max())))


def findDataRange(np_arr, b_has_mask, np_valid_mask, n_bands, printInfo=False):
    if not b_has_mask or np_valid_mask is None:
        return (float(np_arr.min()), float(np_arr.max()))
    if not np_valid_mask.any():
        return (-1, -1)
    if n_bands == 1 or np_valid_mask.ndim == 3:
        return (float(np_arr[np_valid_mask].min()), float(np_arr[np_valid_mask].max()))
    z_min, z_max = np.inf, -np.inf
    for m in range(n_bands):
        z_min = min(np_arr[m][np_valid_mask].min(), z_min)
        z_max = max(np_arr[m][np_valid_mask].max(), z_max)
    return (float(z_min), float(z_max))


def findDataRange_ma(npma_arr):
    if not npma_arr.any():
        return (-1, -1)
    return (float(npma_arr.min()), float(npma_arr.max()))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _prep_masks(np_valid_mask, n_bands, n_rows, n_cols):
    if np_valid_mask is None:
        return None
    n_masks, r2, c2 = getLercShape(np_valid_mask, 1)
    if not (n_masks in (0, 1, n_bands)) or r2 != n_rows or c2 != n_cols:
        raise LercEncodeError(ErrCode.WRONG_PARAM, "unsupported mask array shape")
    return np.ascontiguousarray(np_valid_mask).reshape(n_masks, n_rows, n_cols)


def _nodata_arrays(npma_no_data, n_bands):
    if npma_no_data is None:
        return None, None
    if len(npma_no_data) != n_bands:
        raise LercEncodeError(ErrCode.WRONG_PARAM, "noData array must be of size nBands")
    uses = np.zeros(n_bands, dtype=np.uint8)
    vals = np.zeros(n_bands, dtype=np.float64)
    mask = np.ma.getmaskarray(npma_no_data)
    for m in range(n_bands):
        if not mask[m]:
            uses[m] = 1
            vals[m] = npma_no_data[m]
    if not uses.any():
        return None, None
    return uses, vals


def encode(np_arr, n_values_per_pixel, b_has_mask, np_valid_mask, max_z_err, n_bytes_hint,
           printInfo=False, *, device="cuda"):
    return _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, n_bytes_hint, None,
                       device=device)


def encode_4D(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, n_bytes_hint,
              npma_no_data_per_band=None, printInfo=False, *, device="cuda"):
    return _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, n_bytes_hint,
                       npma_no_data_per_band, device=device)


def _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, n_bytes_hint,
                npma_no_data, version=-1, *, device="cuda"):
    try:
        data4 = _to_4d(np_arr, n_values_per_pixel)
        n_bands = data4.shape[0]
        masks = _prep_masks(np_valid_mask, n_bands, data4.shape[1], data4.shape[2])
        uses, vals = _nodata_arrays(npma_no_data, n_bands)
        blob = encode_blob(data4, masks, max_z_err, version=version,
                           uses_no_data=uses, no_data_values=vals, device=device)
    except LercEncodeError as e:
        return (int(e.code), 0)
    except ValueError:
        return (int(ErrCode.FAILED), 0)
    if n_bytes_hint == 0:
        return (0, len(blob))
    return (0, len(blob), blob)


def encodeForVersion(np_arr, version, n_values_per_pixel, b_has_mask,
                     np_valid_mask, max_z_err, n_bytes_hint, printInfo=False, *, device="cuda"):
    """lerc_encodeForVersion (Lerc_c_api.h:139-160): encode targeting a
    specific codec version (2..6, or -1 for the current one). Same tuple
    returns as encode()."""
    return _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err,
                       n_bytes_hint, None, version=version, device=device)


def computeCompressedSizeForVersion(np_arr, version, n_values_per_pixel,
                                    b_has_mask, np_valid_mask, max_z_err,
                                    printInfo=False, *, device="cuda"):
    """lerc_computeCompressedSizeForVersion (Lerc_c_api.h:162-176)."""
    rv = _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, 0,
                     None, version=version, device=device)
    return rv[:2]


def computeCompressedSize(np_arr, n_values_per_pixel, b_has_mask, np_valid_mask,
                          max_z_err, printInfo=False, *, device="cuda"):
    """Exact compressed blob size in bytes, without returning the blob
    (lerc_computeCompressedSize, Lerc_c_api.h:126-160: "size accurate to
    the byte"). Returns (result, nBytes). The encoder pipeline runs the
    same deterministic two-pass layout as encode(), so
    computeCompressedSize(x) == len(encode(x)) always holds."""
    rv = _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, 0, None,
                     device=device)
    return rv[:2]


def computeCompressedSize_4D(np_arr, n_values_per_pixel, np_valid_mask, max_z_err,
                             npma_no_data_per_band=None, printInfo=False, *, device="cuda"):
    rv = _encode_ext(np_arr, n_values_per_pixel, np_valid_mask, max_z_err, 0,
                     npma_no_data_per_band, device=device)
    return rv[:2]


def encode_ma(npma_arr, n_values_per_pixel, max_z_err, n_bytes_hint,
              npma_no_data_per_band=None, printInfo=False, *, device="cuda"):
    """Encode a numpy masked array (mirrors _lerc.py:467-521)."""
    if n_values_per_pixel == 1:
        return _encode_ext(npma_arr.data, n_values_per_pixel,
                           np.logical_not(np.ma.getmaskarray(npma_arr)),
                           max_z_err, n_bytes_hint, npma_no_data_per_band, device=device)
    np_arr = np.array(npma_arr.data, copy=True)
    amask = np.ma.getmaskarray(npma_arr)
    if npma_no_data_per_band is not None:
        nd_mask = np.ma.getmaskarray(npma_no_data_per_band)
        if npma_arr.ndim == 3:
            if not nd_mask[0]:
                filled = np.ma.filled(npma_arr, npma_no_data_per_band[0])
                return _encode_ext(filled, n_values_per_pixel, None, max_z_err, n_bytes_hint,
                                   npma_no_data_per_band, device=device)
        elif npma_arr.ndim == 4:
            n_bands = npma_no_data_per_band.size
            for m in range(n_bands):
                if not nd_mask[m]:
                    np_arr[m] = np.ma.filled(npma_arr[m], npma_no_data_per_band[m])
            if not np.any(nd_mask):
                return _encode_ext(np_arr, n_values_per_pixel, None, max_z_err, n_bytes_hint,
                                   npma_no_data_per_band, device=device)
    # at least one band without noData: mask must have no mixed case there
    int_mask = np.sum(amask, axis=amask.ndim - 1, dtype=int)
    nd_mask = (np.ma.getmaskarray(npma_no_data_per_band)
               if npma_no_data_per_band is not None else None)

    def mixed(uv):
        return not set(np.asarray(uv).tolist()) <= {0, n_values_per_pixel}

    if int_mask.ndim == 2:
        if nd_mask is None or nd_mask[0]:
            if mixed(np.unique(int_mask)):
                return (int(ErrCode.HAS_NO_DATA), 0)
    else:
        for m in range(int_mask.shape[0]):
            if nd_mask is None or nd_mask[m]:
                if mixed(np.unique(int_mask[m])):
                    return (int(ErrCode.HAS_NO_DATA), 0)
    bool_mask = int_mask.astype(bool)
    return _encode_ext(np_arr, n_values_per_pixel, np.logical_not(bool_mask),
                       max_z_err, n_bytes_hint, npma_no_data_per_band, device=device)


# ---------------------------------------------------------------------------
# blob info / data ranges
# ---------------------------------------------------------------------------

def getLercBlobInfo(lerc_blob, printInfo=False):
    return _blob_info_ext(lerc_blob, 0)


def getLercBlobInfo_4D(lerc_blob, printInfo=False):
    return _blob_info_ext(lerc_blob, 1)


def _blob_info_ext(lerc_blob, n_support_no_data):
    zeros = (0,) * (13 if n_support_no_data else 12)
    try:
        info = get_lerc_info(lerc_blob)
    except ValueError:
        return (int(ErrCode.FAILED),) + zeros
    if info.n_uses_no_data and not n_support_no_data:
        return (int(ErrCode.HAS_NO_DATA),) + zeros
    out = (
        0, info.version, int(info.dt), info.n_depth, info.n_cols, info.n_rows,
        info.n_bands, info.num_valid_pixel, info.blob_size, info.n_masks,
        info.z_min, info.z_max, info.max_z_error,
    )
    if n_support_no_data:
        out = out + (info.n_uses_no_data,)
    return out


def getLercDataRanges(lerc_blob, n_depth, n_bands, printInfo=False):
    """Per band/depth [min, max] without pixel decode (header + ranges reads)."""
    mins = np.zeros(n_depth * n_bands, dtype=np.float64)
    maxs = np.zeros(n_depth * n_bands, dtype=np.float64)
    try:
        info = get_lerc_info(lerc_blob)
        if info.is_lerc1:
            raise ValueError("Lerc1 has no fast ranges")
        src = memoryview(bytes(lerc_blob) if not isinstance(lerc_blob, (bytes, bytearray, memoryview)) else lerc_blob)
        for i_band, off in enumerate(info.band_offsets[:n_bands]):
            hd, pos = hdr.read_header(src[off:])
            if n_depth == 1:
                mins[i_band], maxs[i_band] = hd.z_min, hd.z_max
                continue
            if hd.b_pass_no_data_values:
                return (int(ErrCode.HAS_NO_DATA), None, None)
            # header + mask-skip + ranges-section read only (no pixel
            # decode), like the reference Lerc2::GetRanges
            _hd, (z_mins, z_maxs) = lerc2_decode.read_band_ranges(src[off:])
            mins[i_band * n_depth : (i_band + 1) * n_depth] = z_mins
            maxs[i_band * n_depth : (i_band + 1) * n_depth] = z_maxs
    except ValueError:
        return (int(ErrCode.FAILED), None, None)
    shape = (n_bands, n_depth)
    return (0, mins.reshape(shape), maxs.reshape(shape))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode(lerc_blob, printInfo=False, *, device="cuda"):
    return _decode_ext(lerc_blob, 0, device=device)


def decode_4D(lerc_blob, printInfo=False, *, device="cuda"):
    return _decode_ext(lerc_blob, 1, device=device)


def decodeToDouble(lerc_blob, printInfo=False, *, device="cuda"):
    """Decode any stored dtype and widen the pixels to float64
    (lerc_decodeToDouble, Lerc_c_api.h:351-380: the caller gets doubles
    regardless of the blob's data type; exact for every LERC dtype since
    f64 holds all int32/float32 values)."""
    return _decode_to_double_ext(lerc_blob, 0, device=device)


def decodeToDouble_4D(lerc_blob, printInfo=False, *, device="cuda"):
    """4D variant of decodeToDouble (lerc_decodeToDouble_4D,
    Lerc_c_api_impl.cpp:286-301 decode-then-widen semantics)."""
    return _decode_to_double_ext(lerc_blob, 1, device=device)


def _decode_to_double_ext(lerc_blob, n_support_no_data, *, device="cuda"):
    rv = _decode_ext(lerc_blob, n_support_no_data, device=device)
    if not isinstance(rv, tuple) or rv[0] != 0 or rv[1] is None:
        return rv
    return (rv[0], rv[1].astype(np.float64)) + rv[2:]


def _decode_ext(lerc_blob, n_support_no_data, *, device="cuda"):
    try:
        info = get_lerc_info(lerc_blob)
    except ValueError:
        return int(ErrCode.FAILED)
    if info.n_uses_no_data and not n_support_no_data:
        return (int(ErrCode.HAS_NO_DATA), None, None)
    try:
        res = decode_blob(lerc_blob, device=device)
    except ValueError:
        return int(ErrCode.FAILED)

    n_bands, n_depth = info.n_bands, info.n_depth
    data = res.data
    if n_bands == 1:
        np_arr = data[0, :, :, 0] if n_depth == 1 else data[0]
    else:
        np_arr = data[:, :, :, 0] if n_depth == 1 else data

    np_valid_mask = None
    if info.n_masks > 0:
        if info.n_masks == 1:
            np_valid_mask = res.masks[0]
        else:
            np_valid_mask = res.masks[: info.n_masks]

    if not n_support_no_data:
        return (0, np_arr, np_valid_mask)
    npma_no_data = None
    if info.n_uses_no_data:
        npma_no_data = np.ma.array(res.no_data_values, mask=~res.uses_no_data)
    return (0, np_arr, np_valid_mask, npma_no_data)


def decode_ma(lerc_blob, printInfo=False, *, device="cuda"):
    try:
        info = get_lerc_info(lerc_blob)
    except ValueError:
        return int(ErrCode.FAILED)
    rv = _decode_ext(lerc_blob, 1, device=device)
    if not isinstance(rv, tuple):
        return rv
    _, np_arr, np_valid_mask, npma_no_data = rv
    npma_arr = convert2ma(np_arr, np_valid_mask, info.n_depth, info.n_bands, npma_no_data)
    return (0, npma_arr, info.n_depth, npma_no_data)


def convert2ma(np_arr, np_valid_mask, n_values_per_pixel, n_bands, npma_no_data):
    """Mirrors _lerc.py:752-794."""
    if npma_no_data is None and np_valid_mask is None:
        return np.ma.array(np_arr, mask=False)
    if np_valid_mask is not None:
        valid = np_valid_mask
        if n_values_per_pixel > 1:
            valid = np.repeat(valid[..., None], n_values_per_pixel, axis=-1)
        if n_bands > 1 and (np_valid_mask.ndim == 2):
            valid = np.stack([valid] * n_bands)
        npma_arr = np.ma.array(np_arr, mask=~valid)
    else:
        npma_arr = np.ma.array(np_arr, mask=False)
    if npma_no_data is not None:
        nd_mask = np.ma.getmaskarray(npma_no_data)
        if n_bands == 1:
            if not nd_mask[0]:
                npma_arr = np.ma.masked_equal(npma_arr, npma_no_data[0])
        else:
            for m in range(n_bands):
                if not nd_mask[m]:
                    npma_arr[m] = np.ma.masked_equal(npma_arr[m], npma_no_data[m])
    return npma_arr


# ---------------------------------------------------------------------------
# pythonic entry points
# ---------------------------------------------------------------------------

def compress(
    data: np.ndarray,
    max_z_error: float = 0.0,
    valid_mask: np.ndarray | None = None,
    no_data: np.ndarray | None = None,
    version: int = -1,
    *,
    device="cuda",
) -> bytes:
    """Encode an array of shape [nRows, nCols], [nBands, nRows, nCols] (depth 1)
    or [nBands, nRows, nCols, nDepth] into a LERC blob. Raises on error."""
    if data.ndim == 2:
        data4 = data[None, :, :, None]
    elif data.ndim == 3:
        data4 = data[:, :, :, None]
    elif data.ndim == 4:
        data4 = data
    else:
        raise ValueError("data must be 2D, 3D, or 4D")
    masks = None
    if valid_mask is not None:
        masks = valid_mask[None] if valid_mask.ndim == 2 else valid_mask
    uses = vals = None
    if no_data is not None:
        no_data = np.asarray(no_data, dtype=np.float64).reshape(-1)
        uses = np.ones(data4.shape[0], dtype=np.uint8)
        vals = np.broadcast_to(no_data, (data4.shape[0],)).copy()
    return encode_blob(np.ascontiguousarray(data4), masks, max_z_error,
                       version=version, uses_no_data=uses, no_data_values=vals, device=device)


def decompress(blob: bytes, squeeze: bool = True, *, device="cuda"):
    """Decode a LERC blob. Returns (data, valid_mask) with data
    [nBands, nRows, nCols, nDepth] (squeezed if squeeze=True)."""
    res = decode_blob(blob, device=device)
    data, masks = res.data, res.masks
    if squeeze:
        if data.shape[3] == 1:
            data = data[:, :, :, 0]
        if data.shape[0] == 1:
            data = data[0]
            masks = masks[0]
    return data, masks


def decode_to_dtype(lerc_blob, np_dtype, printInfo=False, *, device="cuda"):
    """lerc_decode with an explicit output data type (Lerc_c_api.h:299-332).
    Lerc2 blobs require the stored dtype (the C API fails otherwise);
    Lerc1 blobs convert from float with the reference's semantics --
    float targets cast, integer targets round half-up (Lerc.cpp:794-842).
    Returns the usual (result, np_arr, np_valid_mask) tuple."""
    np_dtype = np.dtype(np_dtype)
    try:
        info = get_lerc_info(lerc_blob)
    except ValueError:
        return int(ErrCode.FAILED)
    rv = decode(lerc_blob, printInfo, device=device)
    if not isinstance(rv, tuple) or rv[0] != 0:
        return rv
    _, np_arr, np_valid_mask = rv
    if not info.is_lerc1:
        if np_arr.dtype != np_dtype:
            return int(ErrCode.WRONG_PARAM)
        return rv
    mask = (np.ones(np_arr.shape[-2:], bool) if np_valid_mask is None
            else np.asarray(np_valid_mask, bool))
    if np_arr.ndim == 2:
        out = _l1.convert(np_arr, mask, np_dtype)
    else:  # [nBands, H, W]
        out = np.stack([
            _l1.convert(np_arr[b], mask if mask.ndim == 2 else mask[b], np_dtype)
            for b in range(np_arr.shape[0])
        ])
    return (0, out, np_valid_mask)
