"""Encoder-side maxZError analyses of the band codec, as torch operations on
the band's device.

Port of ``lerc_tpu/codec/lerc2_encode.py::try_raise_max_z_error`` (:576-597)
and ``try_bit_plane_compression`` (:600-637), which the JAX band encoder runs
in host numpy. Here they run where the band lies, in float64 and int64:
numpy's arithmetic there is exact (one rounding per f64 operation, exact
integer bit counts) and torch's is the same, so the answers are equal and no
copy of the band goes to the host.

The rest of the host encoder (``BandEncoder``: the host tiling encode, the
Huffman and fpl candidates, noData handling) is still to port: ROADMAP
queue 1 item 12.
"""
from __future__ import annotations

import torch

from ..constants import DT_SIZE, DataType, dt_is_int

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
