"""The tile mosaic over a torch.distributed device mesh.

Port of ``lerc_tpu/parallel/sharding.py``: the raster becomes a [T, tileH,
tileW, D] tile stack (``split_into_tiles``), each tile one standard Lerc2
blob (a tile's bands back to back), and the container adds the grid, the
tile offsets, the global range and a record-offset index
(``MOSAIC_MAGIC`` 1-3, byte for byte JAX's).

Encode (``MosaicEncoder``): rank r of an N-rank mesh holds the contiguous
tiles JAX's ``P("tiles")`` gives device r once the stack is padded with
empty tiles to a multiple of N (:328-333). Its tiles go through the
tile-batched encode (``device_encode.encode_tiles_batched``: K1/K2 LUT
instances once per micro-block size, 8x8 then 16x16 with the gates of
:93-98; float64 through K1/K2 f64); the per-depth ranges meet in an
``all_reduce`` MIN/MAX, and sizes, micro-block sizes, ranges, record
indexes and payloads in ``all_gather``s -- the payload rows padded to the
all-reduced largest tile, as NCCL needs equal shapes. Every rank then lays
out the same container. Ranges stay in the native type (int64 on the
device for integers, float64 for double), never float32
(JAX's :111, :365).

Decode: ``decode_mosaic_device`` flattens the (tile, band) units of each
micro-block size into one record axis and decodes them in one K4 launch
(``device_decode.decode_tiles_fast(...)``); with N ranks each
rank decodes its whole units and the images are all-gathered, so every
rank returns the raster. Units leave K4 for the scanned decode (the tile's
band blobs through ``decode_band_device``, K6) for a named reason only:
float64 records, depth-diff records (K4 reports them apart from index
errors), no index entry (constant or empty units are filled on the host),
a layout K4 has no instance for (blocks other than 8 or 16, a tile not a
multiple of the block, codec parameters that differ from the first unit's),
or a mask that disagrees with the header's valid count. A record index that
disagrees with its stream raises ValueError, as JAX's does; nothing is
caught and retried elsewhere.

Collectives: NCCL on the card, gloo on the CPU. ``mesh=None`` is one rank
with no collectives. Entry points run on the card unless the caller passes
``device="cpu"`` or a gloo mesh, which run the kernels' plain versions.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..codec import fletcher32, rle
from ..codec import header as hdr
from ..codec.bitmask import bool_to_bits
from ..codec.device_codec import band_sections, decode_band_device
from ..codec.resident import resolve_device
from ..constants import DT_SIZE, DT_TO_NUMPY, NUMPY_TO_DT, DataType, ImageEncodeMode, dt_is_int
from ..ops import device_decode, device_encode

MOSAIC_MAGIC = b"LercTpuMosaic1"
MOSAIC_MAGIC2 = b"LercTpuMosaic2"  # adds the record-offset index section
MOSAIC_MAGIC3 = b"LercTpuMosaic3"  # adds multi-band tiles (nBands field)

_BIG = 2**62  # an int64 range sentinel beyond every integer dtype


def make_mesh(n_devices: int | None = None, axis: str = "tiles"):
    """A one-dimensional ``DeviceMesh`` over the ranks of the initialised
    default process group (one rank per GPU), its dimension named `axis`:
    "cuda" with the NCCL backend, "cpu" with gloo. n_devices, when given,
    must be the world size. ``torch.distributed.init_process_group`` must
    have run, with its address, world size and rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first "
                           "(init_method='tcp://localhost:<port>', world_size, rank)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis,))


class _Ranks:
    """This rank's place in a one-dimensional mesh and its collectives
    (none when mesh is None), on the rank's device."""

    def __init__(self, mesh, device):
        if mesh is None:
            self.group, self.size, self.rank = None, 1, 0
            self.device = resolve_device(device)
            return
        if mesh.ndim != 1:
            raise ValueError("the mosaic's mesh has one dimension")
        self.group, self.size, self.rank = mesh.get_group(0), mesh.size(), mesh.get_local_rank(0)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """all_gather along dim 0 (every rank's t has the same shape), as
        bytes so that every dtype travels on either backend."""
        if self.group is None:
            return t
        import torch.distributed as dist

        raw = t.contiguous().reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(parts, raw, group=self.group)
        return torch.cat(parts).view(t.dtype).reshape(self.size * t.shape[0], *t.shape[1:])

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """all_reduce MIN or MAX of a float32, float64 or int64 tensor."""
        if self.group is None:
            return t
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX,
                        group=self.group)
        return t


def split_into_tiles(data: np.ndarray, mask: np.ndarray | None, tile_h: int, tile_w: int):
    """[H, W, D] -> padded tile stack [T, tileH, tileW, D] + tile masks + grid."""
    h, w, d = data.shape
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    tiles = np.zeros((ty * tx, tile_h, tile_w, d), dtype=data.dtype)
    masks = np.zeros((ty * tx, tile_h, tile_w), dtype=bool)
    full_mask = np.ones((h, w), bool) if mask is None else mask.astype(bool)
    for i in range(ty):
        for j in range(tx):
            hs = min(tile_h, h - i * tile_h)
            ws = min(tile_w, w - j * tile_w)
            t = i * tx + j
            tiles[t, :hs, :ws] = data[i * tile_h : i * tile_h + hs, j * tile_w : j * tile_w + ws]
            masks[t, :hs, :ws] = full_mask[i * tile_h : i * tile_h + hs, j * tile_w : j * tile_w + ws]
    return tiles, masks, (ty, tx)


class MosaicEncoder:
    """Tile-grid encoder over a device mesh (or one rank, mesh=None, on
    `device`): a mosaic container of magic, grid geometry, per-tile
    offsets, then one standard Lerc2 blob per tile."""

    def __init__(self, mesh, tile_h: int, tile_w: int, dtype, n_depth: int = 1,
                 version: int = 6, try_16: bool = True, *, device="cuda"):
        self.mesh = mesh
        self._ranks = _Ranks(mesh, device)
        self.try_16 = try_16  # the 16x16 retrial at low bit rates
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dt = NUMPY_TO_DT[np.dtype(dtype)]
        self.d = n_depth
        self.version = version

    def encode(self, data: np.ndarray, mask: np.ndarray | None, max_z_error: float) -> bytes:
        """Encode [H, W, D] (single band) or [nBands, H, W, D]. mask may be
        None, [H, W] (shared by all bands), or [nBands, H, W] per band. A
        tile's blob is its bands' Lerc2 blobs back to back; a band whose
        tile mask equals the previous band's writes numBytesMask == 0
        (Lerc.cpp:130-176, 717-741)."""
        if data.ndim == 3:
            data = data[None]
        n_bands, h, w, d = data.shape
        if mask is None:
            band_masks = [None] * n_bands
        elif mask.ndim == 2:
            band_masks = [mask] * n_bands
        else:
            band_masks = [mask[b] for b in range(n_bands)]
        mze = self._adjust_mze(max_z_error)

        per_band = []
        prev_tile_masks = None
        gmn = gmx = None
        grid = None
        for b in range(n_bands):
            blobs, offs, starts, b_mn, b_mx, grid, tile_masks = self._encode_band_blobs(
                data[b], band_masks[b], mze, prev_tile_masks=prev_tile_masks,
                n_blobs_more=n_bands - 1 - b)
            per_band.append((blobs, offs, starts))
            prev_tile_masks = tile_masks
            gmn = b_mn if gmn is None else np.minimum(gmn, b_mn)
            gmx = b_mx if gmx is None else np.maximum(gmx, b_mx)
        ty, tx = grid

        # per tile: the bands' blobs back to back; the index rows in (tile,
        # band) order, stream offsets absolute in the tile blob
        tile_blobs, stream_offs, starts_rows = [], [], []
        for t in range(ty * tx):
            parts, base = [], 0
            for b in range(n_bands):
                blobs, offs, starts = per_band[b]
                stream_offs.append(base + offs[t] if offs[t] >= 0 else -1)
                starts_rows.append(starts[t])
                parts.append(blobs[t])
                base += len(blobs[t])
            tile_blobs.append(b"".join(parts))
        return self._assemble_container(tile_blobs, stream_offs, starts_rows, gmn, gmx, ty, tx,
                                        h, w, n_bands=n_bands)

    def encode_streamed(self, row_provider, h: int, w: int, max_z_error: float,
                        mask_provider=None) -> bytes:
        """Bounded-memory encode: row_provider(i) -> the i-th tile row band
        [bandH, W, D] (the last may be shorter), mask_provider(i) its mask;
        the same container as ``encode`` of the whole raster."""
        ty = -(-h // self.tile_h)
        mze = self._adjust_mze(max_z_error)
        blobs, stream_offs, starts_rows = [], [], []
        gmn = gmx = None
        tx = None
        for i in range(ty):
            hs = min(self.tile_h, h - i * self.tile_h)
            band = np.ascontiguousarray(row_provider(i))
            if band.shape[0] != hs or band.shape[1] != w:
                raise ValueError(f"band {i}: expected [{hs}, {w}, D]")
            bmask = mask_provider(i) if mask_provider is not None else None
            b_blobs, b_offs, b_starts, b_mn, b_mx, (bty, btx), _tm = self._encode_band_blobs(
                band, bmask, mze)
            tx = btx
            blobs += b_blobs
            stream_offs += b_offs
            starts_rows += b_starts
            gmn = b_mn if gmn is None else np.minimum(gmn, b_mn)
            gmx = b_mx if gmx is None else np.maximum(gmx, b_mx)
        return self._assemble_container(blobs, stream_offs, starts_rows, gmn, gmx, ty, tx, h, w)

    def _adjust_mze(self, max_z_error: float) -> float:
        mze = max_z_error
        if self.dt < DataType.FLOAT:
            mze = max(0.5, np.floor(mze))
        return mze

    def _encode_band_blobs(self, data: np.ndarray, mask: np.ndarray | None, mze: float,
                           prev_tile_masks: np.ndarray | None = None, n_blobs_more: int = 0):
        """Split, encode this rank's tiles, gather -> per-tile wrapped blobs.
        prev_tile_masks ([T, th, tw], the previous band's) sets the
        mask-reuse flag on tiles whose mask is unchanged. Returns (blobs,
        stream_offs, starts_rows, gmin, gmax, (ty, tx), tile_masks)."""
        tiles, masks, (ty, tx) = split_into_tiles(data, mask, self.tile_h, self.tile_w)
        ranks = self._ranks
        t_total = tiles.shape[0]
        t_pad = -(-t_total // ranks.size) * ranks.size
        if t_pad != t_total:  # pad with empty tiles to a multiple of the mesh
            tiles = np.concatenate([tiles, np.zeros((t_pad - t_total,) + tiles.shape[1:],
                                                    tiles.dtype)])
            masks = np.concatenate([masks, np.zeros((t_pad - t_total,) + masks.shape[1:], bool)])
        n_local = t_pad // ranks.size
        lo = ranks.rank * n_local
        sizes, mbs, zmins, zmaxs, rows, starts, gmin, gmax = self._encode_local(
            tiles[lo : lo + n_local], masks[lo : lo + n_local], mze)

        blobs, stream_offs, starts_rows = [], [], []
        for t in range(t_total):
            reuse = prev_tile_masks is not None and np.array_equal(masks[t], prev_tile_masks[t])
            blob, soff = self._wrap_tile(rows[t], int(sizes[t]), zmins[t], zmaxs[t], masks[t],
                                         mze, int(mbs[t]), reuse_mask=reuse,
                                         n_blobs_more=n_blobs_more)
            blobs.append(blob)
            stream_offs.append(soff)
            starts_rows.append(starts[t])
        return blobs, stream_offs, starts_rows, gmin, gmax, (ty, tx), masks[:t_total]

    def _encode_local(self, tiles: np.ndarray, masks: np.ndarray, mze: float):
        """This rank's tiles through the tile-batched encode, then the
        collectives. Returns host arrays over all ranks' tiles: (sizes [T],
        mbs [T], zmins [T, D], zmaxs [T, D] (float32, int64 or float64),
        payload rows [T, maxTotal] uint8, starts [T, nRec8] int32) and the
        global per-depth (gmin, gmax) as float64."""
        ranks, dev, dt, d = self._ranks, self._ranks.device, self.dt, self.d
        th, tw = self.tile_h, self.tile_w
        if dt == DataType.UINT:  # the integer instances take int32: the same bits
            tiles = tiles.view(np.int32)
        tiles_t = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev)
        masks_t = torch.from_numpy(np.ascontiguousarray(masks)).to(dev)
        n_local = tiles_t.shape[0]
        n_valid = masks_t.sum((1, 2))
        try_16 = self.try_16 and (th > 8 or tw > 8) and dt != DataType.DOUBLE
        size = DT_SIZE[dt]
        # tiles per launch: the batch's stream stays under 2^31 bytes
        per_tile = max(-(-th // mb) * -(-tw // mb) * d * (1 + mb * mb * size) for mb in (8, 16))
        chunk = max(1, (2**31 - 1) // per_tile)
        variants = [[] for _ in (8, 16)]
        for c0 in range(0, n_local, chunk):
            for k, mb in enumerate((8, 16) if try_16 else (8,)):
                variants[k].append(device_encode.encode_tiles_batched(
                    tiles_t[c0 : c0 + chunk], masks_t[c0 : c0 + chunk], mze, dt, self.version,
                    mb))

        def cat(k, i):
            return torch.cat([o[i] for o in variants[k]])

        t8, zmin, zmax = cat(0, 2).to(torch.int64), cat(0, 4), cat(0, 5)
        starts = cat(0, 3)
        totals, mbs = t8, torch.full_like(t8, 8)
        use16 = torch.zeros_like(t8, dtype=torch.bool)
        if try_16:  # the 16x16 retrial's gates (sharding.py:93-98)
            t16 = cat(1, 2).to(torch.int64)
            use16 = ((t8 * 16 < 3 * th * tw * d) & (t8 < 4 * size * d * n_valid)
                     & (t16 <= t8))
            totals = torch.where(use16, t16, t8)
            mbs = torch.where(use16, 16, 8)
            st16 = cat(1, 3)
            st16 = torch.cat([st16, st16.new_full((n_local, starts.shape[1] - st16.shape[1]), -1)],
                             1)
            starts = torch.where(use16[:, None], st16, starts)

        # ranges in the native type: float32 as it is, integers as int64
        # (uint32 in unsigned order), float64 as it is; a tile without a
        # valid value takes no part in the global range
        empty = n_valid == 0
        if dt_is_int(dt):
            zmin, zmax = zmin.to(torch.int64), zmax.to(torch.int64)
            big = _BIG
        else:
            big = float("inf")
        if dt == DataType.DOUBLE:  # (JAX's host f64 ranges: 0 for an empty tile)
            zmin = torch.where(empty[:, None], 0.0, zmin)
            zmax = torch.where(empty[:, None], 0.0, zmax)
        gmin = ranks.reduce(torch.where(empty[:, None], big, zmin).amin(0), "min")
        gmax = ranks.reduce(torch.where(empty[:, None], -big, zmax).amax(0), "max")

        # the payload rows, padded to the largest tile of every rank
        max_total = int(ranks.reduce(totals.max().reshape(1), "max")[0])
        tot_h, use_h = totals.cpu().numpy(), use16.cpu().numpy()
        rows = torch.zeros(n_local, max_total, dtype=torch.uint8, device=dev)
        for c, c0 in enumerate(range(0, n_local, chunk)):
            srcs = [(variants[k][c][0].view(torch.uint8), variants[k][c][1].cpu().numpy())
                    for k in range(len(variants)) if variants[k]]
            for i in range(c0, min(c0 + chunk, n_local)):
                src, bases = srcs[1 if use_h[i] else 0]
                base = int(bases[i - c0])
                rows[i, : tot_h[i]] = src[base : base + int(tot_h[i])]

        g = [ranks.gather(x).cpu().numpy() for x in (totals, mbs, zmin, zmax, rows, starts)]
        gmin, gmax = gmin.cpu().numpy(), gmax.cpu().numpy()
        if dt_is_int(dt):  # every tile empty: JAX's f32 of the int32 sentinels
            gmin = np.where(gmin == _BIG, 2.0**31, gmin)
            gmax = np.where(gmax == -_BIG, -2.0**31, gmax)
        elif dt == DataType.DOUBLE:
            gmin = np.where(np.isinf(gmin), 0.0, gmin)
            gmax = np.where(np.isinf(gmax), 0.0, gmax)
        return (*g, gmin.astype(np.float64), gmax.astype(np.float64))

    def _assemble_container(self, blobs, stream_offs, starts_rows, gmin, gmax, ty, tx, h, w,
                            n_bands: int = 1) -> bytes:
        t_total = ty * tx
        if n_bands == 1:
            index = struct.pack("<14s4i", MOSAIC_MAGIC2, ty, tx, h, w)
        else:
            index = struct.pack("<14s5i", MOSAIC_MAGIC3, ty, tx, h, w, n_bands)
        index += struct.pack("<2i", self.tile_h, self.tile_w)
        index += struct.pack(f"<{t_total}q",
                             *np.cumsum([0] + [len(b) for b in blobs[:-1]]).tolist())
        index += struct.pack("<2d", float(np.asarray(gmin).min()), float(np.asarray(gmax).max()))
        # the record-offset index: per (tile, band) the byte offset of the
        # band's tile stream within the tile blob (-1: none) and the record
        # starts relative to that stream
        n_rec = starts_rows[0].shape[0] if starts_rows else 0
        index += struct.pack("<2i", n_rec, 0)
        index += np.asarray(stream_offs, np.int32).tobytes()
        index += np.stack(starts_rows).astype(np.int32).tobytes()
        return index + b"".join(blobs)

    def _wrap_tile(self, stream, total, zmin_vec, zmax_vec, tile_mask, mze,
                   micro_block_size: int = 8, reuse_mask: bool = False, n_blobs_more: int = 0):
        """-> (blob bytes, stream byte offset within the blob or -1).
        reuse_mask writes numBytesMask == 0 for a masked tile; n_blobs_more
        is the v6 header's count of band blobs that follow."""
        num_valid = int(tile_mask.sum())
        head = hdr.HeaderInfo(
            version=self.version, n_rows=self.tile_h, n_cols=self.tile_w, n_depth=self.d,
            num_valid_pixel=num_valid, micro_block_size=micro_block_size,
            dt=self.dt, max_z_error=mze, n_blobs_more=n_blobs_more,
        )
        need_mask = 0 < num_valid < self.tile_h * self.tile_w and not reuse_mask
        if need_mask:  # masked tiles carry their mask inline (RLE'd bitmask)
            mask_rle = rle.compress(bool_to_bits(tile_mask))
            mask_section = struct.pack("<i", len(mask_rle)) + mask_rle
        else:
            mask_section = struct.pack("<i", 0)
        body = b""
        ranges = b""
        stream_off = -1
        np_dt = DT_TO_NUMPY[self.dt]
        if num_valid > 0:
            head.z_min = float(zmin_vec.min())
            head.z_max = float(zmax_vec.max())
            if head.z_min != head.z_max:
                if self.version >= 4:
                    ranges = zmin_vec.astype(np_dt).tobytes() + zmax_vec.astype(np_dt).tobytes()
                flags = b"\x00" + (
                    b"\x00" if head.try_huffman_int() or head.try_huffman_flt() else b"")
                stream_off = (hdr.header_size(self.version) + len(mask_section)
                              + len(ranges) + len(flags))
                body = flags + stream[:total].tobytes()
        head.blob_size = (hdr.header_size(self.version) + len(mask_section) + len(ranges)
                          + len(body))
        blob = bytearray(hdr.write_header(head))
        blob += mask_section
        blob += ranges
        blob += body
        if self.version >= 3:
            skip = hdr.checksum_skip(self.version)
            struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:])))
        return bytes(blob), stream_off


def read_mosaic(buf: bytes):
    """Parse a mosaic container -> (grid info, list of per-tile blob views).
    Handles v1 (no index), v2 (record-offset index) and v3 (multi-band
    tiles; stream_offs/starts in (tile, band) order)."""
    magic, ty, tx, h, w = struct.unpack_from("<14s4i", buf, 0)
    if magic not in (MOSAIC_MAGIC, MOSAIC_MAGIC2, MOSAIC_MAGIC3):
        raise ValueError("not a lerc_tpu mosaic")
    pos = 14 + 16
    n_bands = 1
    if magic == MOSAIC_MAGIC3:
        (n_bands,) = struct.unpack_from("<i", buf, pos)
        pos += 4
    tile_h, tile_w = struct.unpack_from("<2i", buf, pos)
    pos += 8
    t_total = ty * tx
    offsets = struct.unpack_from(f"<{t_total}q", buf, pos)
    pos += 8 * t_total
    gmin, gmax = struct.unpack_from("<2d", buf, pos)
    pos += 16
    info = {"grid": (ty, tx), "shape": (h, w), "tile": (tile_h, tile_w),
            "z_min": gmin, "z_max": gmax, "n_bands": n_bands,
            "stream_offs": None, "starts": None}
    if magic in (MOSAIC_MAGIC2, MOSAIC_MAGIC3):
        n_rec, _rsv = struct.unpack_from("<2i", buf, pos)
        pos += 8
        n_units = t_total * n_bands
        info["stream_offs"] = np.frombuffer(buf, np.int32, n_units, pos).copy()
        pos += 4 * n_units
        info["starts"] = np.frombuffer(buf, np.int32, n_units * n_rec, pos).reshape(
            n_units, n_rec).copy()
        pos += 4 * n_units * n_rec
    base = pos
    views = []
    for t in range(t_total):
        start = base + offsets[t]
        end = base + offsets[t + 1] if t + 1 < t_total else len(buf)
        views.append(memoryview(buf)[start:end])
    return info, views


def _tile_band_layouts(views, n_bands):
    """Per tile, the [(byte offset, HeaderInfo), ...] of its band blobs."""
    layouts = []
    for view in views:
        bands = []
        base = 0
        for _ in range(n_bands):
            hd, _ = hdr.read_header(view[base:])
            bands.append((base, hd))
            base += hd.blob_size
        layouts.append(bands)
    return layouts


def _unit_sections(views, layouts, units, n_bands):
    """{(t, b): BandSections} of each unit's band blob, the masks resolved
    through each tile's reuse chain (band 0 up to the unit's band)."""
    out = {}
    for t in sorted({t for t, _b in units}):
        prev = None
        for b in range(n_bands):
            base, hd = layouts[t][b]
            sec = band_sections(views[t][base : base + hd.blob_size], prev)
            prev = sec.mask
            out[(t, b)] = sec
    return out


def _zmax_arg(sec, hd) -> np.ndarray:
    """[D] clamp values of a unit for K4: float32, or int32 (uint32 as its
    bits) for integers."""
    z = sec.z_max_vec if sec.z_max_vec is not None else np.full(hd.n_depth, hd.z_max)
    if not dt_is_int(hd.dt):
        return np.asarray(z, np.float32)
    return (np.round(z).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _group_inputs(info, views, layouts, secs, units, mb: int):
    """K4's inputs for `units` (one micro-block size): their tile streams
    back to back at 512-byte bases (int32 u32 words), the absolute record
    starts (int32), the [nUnits, D] clamp values, and the units' masks
    stacked as [nUnits * tileH, tileW] bool, or None when all are valid."""
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    n_rec = (tile_h // mb) * (tile_w // mb) * layouts[units[0][0]][units[0][1]][1].n_depth
    parts, starts_abs, zmaxs, masks = [], [], [], []
    off = 0
    for t, b in units:
        base, hd = layouts[t][b]
        u = t * n_bands + b
        s = np.frombuffer(views[t][int(info["stream_offs"][u]) : base + hd.blob_size], np.uint8)
        pad = -(-max(s.size, 1) // 512) * 512
        sp = np.zeros(pad, np.uint8)
        sp[: s.size] = s
        parts.append(sp)
        starts_abs.append(info["starts"][u][:n_rec].astype(np.int64) + off)
        off += pad
        zmaxs.append(_zmax_arg(secs[(t, b)], hd))
        masks.append(secs[(t, b)].mask)
    if off >= 2**31:
        raise ValueError("a micro-block group of 2^31 stream bytes or more per rank")
    all_valid = all(m.all() for m in masks)
    return (np.concatenate(parts).view(np.int32), np.concatenate(starts_abs).astype(np.int32),
            np.stack(zmaxs), None if all_valid else np.concatenate(masks))


def _decode_tiles_device_batched(info, views, layouts, wanted, ranks: _Ranks):
    """Decode the `wanted` tiles' units through K4, one launch per
    micro-block group on each of the ranks. Returns {(tile, band): [tileH,
    tileW, D] numpy}; units that need the scanned decode are absent. Raises
    ValueError on a checksum or record-index mismatch."""
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    starts_all = info["starts"]
    stream_offs = info["stream_offs"]
    if starts_all is None or not wanted:
        return {}
    units = [(t, b) for t in wanted for b in range(n_bands)]
    secs = _unit_sections(views, layouts, units, n_bands)
    hd0 = layouts[units[0][0]][units[0][1]][1]
    dev_ok = []
    for t, b in units:
        base, hd = layouts[t][b]
        sec = secs[(t, b)]
        if not (stream_offs[t * n_bands + b] >= 0 and sec.kind == "tiling"
                and sec.mode in (None, ImageEncodeMode.TILING)
                # float64 records: K6 f64 through the scanned decode
                and hd.dt != DataType.DOUBLE
                and hd.micro_block_size in (8, 16)
                and tile_h % hd.micro_block_size == 0 and tile_w % hd.micro_block_size == 0
                and (hd.n_rows, hd.n_cols) == (tile_h, tile_w)
                # one launch needs the first unit's codec parameters
                and hd.dt == hd0.dt and hd.n_depth == hd0.n_depth
                and hd.version == hd0.version and hd.max_z_error == hd0.max_z_error
                # a reused mask must hold the header's valid count
                and int(sec.mask.sum()) == hd.num_valid_pixel):
            continue
        dev_ok.append((t, b))
    if not dev_ok:
        return {}
    # the scanned decode checks each blob's Fletcher32; K4 reads the index
    # alone, so the checksum is checked here (every rank checks every unit)
    for t, b in dev_ok:
        base, hd = layouts[t][b]
        skip = hdr.checksum_skip(hd.version)
        if fletcher32.fletcher32(views[t][base + skip : base + hd.blob_size]) != hd.checksum:
            raise ValueError(f"mosaic tile {t} band {b}: Lerc2 checksum mismatch")
    d = hd0.n_depth

    out: dict[tuple, np.ndarray] = {}
    for mb in (8, 16):
        group = [u for u in dev_ok if layouts[u[0]][u[1]][1].micro_block_size == mb]
        if not group:
            continue
        # whole units per rank: pad the group with copies of its last unit
        n_pad = -(-len(group) // ranks.size) * ranks.size
        n_local = n_pad // ranks.size
        padded = group + [group[-1]] * (n_pad - len(group))
        mine = padded[ranks.rank * n_local : (ranks.rank + 1) * n_local]
        stream_np, starts_np, zmax_np, masks_np = _group_inputs(info, views, layouts, secs,
                                                                mine, mb)
        dev = ranks.device
        stream = torch.from_numpy(stream_np).to(dev)
        starts = torch.from_numpy(starts_np).to(dev)
        zmax = torch.from_numpy(zmax_np).to(dev)
        valid = None if masks_np is None else device_encode.block_valid_words(
            torch.from_numpy(masks_np).to(dev), mb)
        hd = layouts[group[0][0]][group[0][1]][1]
        img, ok, _fits, diff = device_decode.decode_tiles_fast(
            stream, starts, hd.max_z_error, zmax, tile_h, tile_w, d, hd.dt, hd.version,
            mask=valid, mb=mb, n_tiles=n_local, enable_lut=True)
        flags = torch.stack([ok, diff], 1).to(torch.uint8)
        imgs_h = ranks.gather(img).cpu().numpy()  # one fetch per group
        flags_h = ranks.gather(flags).cpu().numpy()
        for i, u in enumerate(group):
            if not flags_h[i, 0]:
                raise ValueError("mosaic: record-offset index inconsistent with stream "
                                 f"(micro-block {mb} group, tile {u[0]} band {u[1]})")
            if not flags_h[i, 1]:  # depth-diff records: the scanned decode adds the previous slice
                out[u] = imgs_h[i]
    return out


def _decode_tile_blob(view, n_bands: int, device="cuda") -> np.ndarray:
    """The scanned decode of one tile -> [nBands, H, W, D]: its band blobs in
    turn through ``decode_band_device`` (each band's mask passed on for
    the reuse flag). Raises where the band decoder does (NotImplementedError
    for versions < 3 and blocks other than 8 or 16, the host codec's)."""
    dev = resolve_device(device)
    out, pos, prev = [], 0, None
    for _ in range(n_bands):
        res = decode_band_device(view[pos:], prev, device=dev)
        out.append(res.data)
        prev, pos = res.mask, pos + res.consumed
    return torch.stack(out).cpu().numpy()


def _const_unit_fill(view, layout, b, tile_h, tile_w):
    """Host fill of a unit with no tile stream: an empty band (zeros) and an
    all-valid constant band (z_min everywhere). None when the unit needs a
    real decode (masked constant tiles included)."""
    base, hd = layout[b]
    d = hd.n_depth
    np_dt = DT_TO_NUMPY[hd.dt]
    if hd.num_valid_pixel == 0:
        return np.zeros((tile_h, tile_w, d), np_dt)
    if hd.num_valid_pixel != tile_h * tile_w:
        return None
    if hd.z_min == hd.z_max:
        return np.full((tile_h, tile_w, d), np_dt(hd.z_min))
    if hd.version >= 4:
        sec = band_sections(view[base : base + hd.blob_size])
        zmn, zmx = sec.z_min_vec, sec.z_max_vec
        if zmn is not None and np.array_equal(zmn, zmx):
            vals = np.full(d, np_dt(hd.z_min)) if d == 1 else np.asarray(zmn).astype(np_dt)
            return np.broadcast_to(vals, (tile_h, tile_w, d)).copy()
    return None


def _place_tiles(tiles_wanted, decoded, views, layouts, info, device, emit):
    """Each wanted tile's units: K4's image, else the constant fill, else
    the tile's scanned decode; emit(t, b, img) places each."""
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    scanned: dict[int, np.ndarray] = {}
    for t in tiles_wanted:
        for b in range(n_bands):
            img = decoded.get((t, b))
            if img is None:
                img = _const_unit_fill(views[t], layouts[t], b, tile_h, tile_w)
            if img is None:
                if t not in scanned:
                    scanned[t] = _decode_tile_blob(views[t], n_bands, device)
                img = scanned[t][b]
            emit(t, b, img)


def decode_mosaic_device(buf: bytes, mesh=None, *, device="cuda") -> np.ndarray:
    """The mosaic decoded through K4 from the container's record index:
    the (tile, band) units of each micro-block size in one launch (per rank
    of `mesh`, whose ranks each decode their whole units; every rank
    returns the raster). [H, W, D], or [nBands, H, W, D] for several bands.
    A container without the index decodes as ``decode_mosaic``."""
    ranks = _Ranks(mesh, device)
    info, views = read_mosaic(buf)
    ty, tx = info["grid"]
    h, w = info["shape"]
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    if info["starts"] is None:
        return decode_mosaic(buf, device=ranks.device)
    layouts = _tile_band_layouts(views, n_bands)
    decoded = _decode_tiles_device_batched(info, views, layouts, list(range(ty * tx)), ranks)
    hd0 = layouts[0][0][1]
    out = np.zeros((n_bands, h, w, hd0.n_depth), dtype=DT_TO_NUMPY[hd0.dt])

    def emit(t, b, img):
        ti, tj = divmod(t, tx)
        hs, ws = min(tile_h, h - ti * tile_h), min(tile_w, w - tj * tile_w)
        out[b, ti * tile_h : ti * tile_h + hs, tj * tile_w : tj * tile_w + ws] = img[:hs, :ws]

    _place_tiles(range(ty * tx), decoded, views, layouts, info, ranks.device, emit)
    return out if n_bands > 1 else out[0]


def decode_mosaic_region(buf: bytes, row0: int, row1: int, col0: int, col1: int,
                         indexed: bool = True, *, device="cuda") -> np.ndarray:
    """Random access: decode only the tiles that meet the half-open window
    [row0:row1, col0:col1] and return the window, [rh, rw, D] or [nBands,
    rh, rw, D]. indexed=True (JAX's `device` flag; here `device` is the
    torch device, as everywhere in the port) decodes the indexed units
    through K4, False through the scanned decode of each tile."""
    info, views = read_mosaic(buf)
    ty, tx = info["grid"]
    h, w = info["shape"]
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    row0c, row1c = max(0, row0), min(h, row1)
    col0c, col1c = max(0, col0), min(w, col1)
    if row0c >= row1c or col0c >= col1c:
        raise ValueError("empty region")
    t_i0, t_i1 = row0c // tile_h, (row1c - 1) // tile_h
    t_j0, t_j1 = col0c // tile_w, (col1c - 1) // tile_w
    wanted = [ti * tx + tj for ti in range(t_i0, t_i1 + 1) for tj in range(t_j0, t_j1 + 1)]
    layouts = _tile_band_layouts(views, n_bands)
    decoded = {}
    if indexed and info["starts"] is not None:
        decoded = _decode_tiles_device_batched(info, views, layouts, wanted,
                                               _Ranks(None, device))
    hd0 = layouts[wanted[0]][0][1]
    out = np.zeros((n_bands, row1c - row0c, col1c - col0c, hd0.n_depth),
                   dtype=DT_TO_NUMPY[hd0.dt])

    def emit(t, b, img):  # tile-local <-> region coordinates
        ti, tj = divmod(t, tx)
        ys, xs = ti * tile_h, tj * tile_w
        ry0, ry1 = max(row0c, ys), min(row1c, ys + tile_h)
        rx0, rx1 = max(col0c, xs), min(col1c, xs + tile_w)
        out[b, ry0 - row0c : ry1 - row0c, rx0 - col0c : rx1 - col0c] = (
            img[ry0 - ys : ry1 - ys, rx0 - xs : rx1 - xs])

    _place_tiles(wanted, decoded, views, layouts, info, resolve_device(device), emit)
    return out if n_bands > 1 else out[0]


def decode_mosaic(buf: bytes, *, device="cuda") -> np.ndarray:
    """The whole raster, each tile through the scanned decode (its band
    blobs through ``decode_band_device``), without the record index."""
    info, views = read_mosaic(buf)
    ty, tx = info["grid"]
    h, w = info["shape"]
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    out = None
    for t, view in enumerate(views):
        data = _decode_tile_blob(view, n_bands, device)
        if out is None:
            out = np.zeros((n_bands, h, w, data.shape[3]), dtype=data.dtype)
        i, j = divmod(t, tx)
        hs = min(tile_h, h - i * tile_h)
        ws = min(tile_w, w - j * tile_w)
        out[:, i * tile_h : i * tile_h + hs, j * tile_w : j * tile_w + ws] = data[:, :hs, :ws]
    return out if n_bands > 1 else out[0]
