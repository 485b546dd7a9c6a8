"""Device Fletcher32 of a resident Lerc2 blob (kernel K3 and its plain version).

Port of ``lerc_tpu/ops/device_scan.py::fletcher32_device_parts`` (:306).
The message is four pieces: ``pre`` (the header bytes after the checksum
field, even length), a STATIC middle given only by its partial sums
``static_ab = (A, B, n_bytes)`` (``codec.fletcher32.fletcher32_partials``),
``tail`` (any length, even start) and ``stream[:total]``. The stream is a
zero-past-`total` int32 tensor holding little-endian u32 words; ``total`` is
a 0-d int32 tensor, so nothing is read back to the host.

Both versions weigh every byte by itself (a byte at message position n adds
to word n >> 1 with weight 256 when n is even, else 1), which makes an odd
prefix need no funnel shift. Sum(w) and Sum(i*w) then give the closed form
s1 = 0xffff + A, s2 = 0xffff*(M+1) + M*A - B (mod 65535, 0 -> 65535).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build

_MOD = 65535


def fletcher32_parts(pre: torch.Tensor, static_ab: tuple[int, int, int],
                     tail: torch.Tensor, stream: torch.Tensor,
                     total: torch.Tensor) -> torch.Tensor:
    """Fletcher32 of pre || STATIC || tail || stream[:total] as a 0-d int32
    tensor holding the u32 checksum bits. K3 on CUDA tensors; the plain
    version on CPU tensors."""
    _check(pre, tail, stream, total, static_ab)
    if not build.on_cuda(pre, tail, stream, total):
        return fletcher32_parts_ref(pre, static_ab, tail, stream, total)
    lib = build.library("fletcher32")
    fn = lib.fletcher32_parts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a, b, n_static = static_ab
    with torch.cuda.device(stream.device):
        acc = torch.zeros(3, dtype=torch.int64, device=stream.device)
        out = torch.empty((), dtype=torch.int32, device=stream.device)
        err = fn(pre.data_ptr(), pre.numel(), tail.data_ptr(), tail.numel(),
                 a, b, n_static, stream.data_ptr(), stream.numel(), total.data_ptr(),
                 acc.data_ptr(), out.data_ptr(), build.launch_stream(stream))
        build.check(err, "fletcher32_parts")
    build.LAUNCHES["fletcher32_parts"] += 1
    return out


def fletcher32_parts_ref(pre: torch.Tensor, static_ab: tuple[int, int, int],
                         tail: torch.Tensor, stream: torch.Tensor,
                         total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (int64 arithmetic; torch's uint32 lacks
    shifts and reductions on the CPU)."""
    a_static, b_static, n_static = static_ab
    dev = stream.device
    n_pre, n_tail = pre.numel(), tail.numel()
    p_all = n_pre + n_static + n_tail
    total64 = total.reshape(()).to(torch.int64)

    def sums(byts, pos):
        v = byts.to(torch.int64) << torch.where((pos & 1) == 1, 0, 8)
        return v.sum(), (((pos >> 1) % _MOD) * v).sum()

    head_bytes = torch.cat([pre, tail]).to(dev)
    head_pos = torch.cat([torch.arange(n_pre, device=dev),
                          n_pre + n_static + torch.arange(n_tail, device=dev)])
    s1h, s2h = sums(head_bytes, head_pos)
    sb = stream.contiguous().view(torch.uint8)
    k = torch.arange(sb.numel(), device=dev, dtype=torch.int64)
    live = k < total64
    s1s, s2s = sums(torch.where(live, sb, 0), p_all + k)
    a = (s1h + s1s + a_static) % _MOD
    b = (s2h + s2s + b_static) % _MOD
    m = (p_all + total64 + 1) // 2
    wsum = ((m % _MOD) * a + _MOD - b) % _MOD
    r1 = (0xFFFF + a) % _MOD
    r2 = (0xFFFF * ((m + 1) % _MOD) + wsum) % _MOD
    r1 = torch.where(r1 == 0, _MOD, r1)
    r2 = torch.where(r2 == 0, _MOD, r2)
    return _as_i32((r2 << 16) | r1)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 bits held in int64 -> the same bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _check(pre, tail, stream, total, static_ab):
    if pre.dtype != torch.uint8 or tail.dtype != torch.uint8:
        raise TypeError("pre and tail must be uint8 tensors")
    if stream.dtype != torch.int32 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError("stream must be a contiguous 1-D int32 tensor of u32 words")
    if total.dtype != torch.int32 or total.numel() != 1:
        raise TypeError("total must be a one-element int32 tensor")
    if not pre.is_contiguous() or not tail.is_contiguous():
        raise ValueError("pre and tail must be contiguous")
    if pre.numel() % 2 or static_ab[2] % 2:
        raise ValueError("pre and the static segment must have even lengths")
