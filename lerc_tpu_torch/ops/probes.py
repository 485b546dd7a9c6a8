"""The Pallas probes of ``tools/profile_pallas.py`` on Hopper (Q1-Q3), with
the plain PyTorch version of each.

The repo's only ``pl.pallas_call`` kernels; they lie on no codec path. Each
probes a TPU capability the codec kernels needed: a dynamic row offset and a
lane roll on 128-lane rows.

- Q1 ``write_call`` (``_k_write`` :36): zero a [256, 128] int32 output, then
  for each of n offsets add the 2-row slab vals[2i : 2i+2] at rows
  offs[i] .. offs[i]+1 (int32 wrap).
- Q2 ``window_call`` (``_k_window`` :63): for each offset o, output rows
  2i, 2i+1 are stream rows (o >> 7), (o >> 7) + 1 rotated left by o & 127
  lanes: out[2i+r, l] = stream[(o >> 7) + r, (l + (o & 127)) & 127].
- Q3 ``asm_call`` (``_k_asm`` :103): each of the N / 512 programs zeroes the
  one shared [300, 128] output block and adds its 512 slabs, rotated right
  by o & 127 lanes, at row o >> 7 (u32 wrap). Only the last program's slabs
  reach the output; that is what the probe computes, and what is computed
  here (its own check, a sum of 2 * N * 128, cannot hold: ROADMAP queue 3).

The kernels are ``kernels/probes.cu``. A wrapper launches its kernel on CUDA
tensors and runs the plain version on CPU tensors, where the u32 arithmetic
is done in int64 and masked (torch's CPU uint32 has no arithmetic). Offsets
out of range raise ValueError before any launch: Pallas does not check, the
kernels here would write out of bounds.

``python -m lerc_tpu_torch.ops.probes`` runs the three at the probe's
shapes on the card, checks each against its plain version, and prints one
line a probe with its time and the card's name.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build

LANES = 128
PROGRAM = 512  # offsets of one Pallas program (the probes' grid step)
WRITE_ROWS = 256  # _k_write's output rows
ASM_ROWS = 300  # _k_asm's output block rows


def _i64(t: torch.Tensor) -> torch.Tensor:
    """u32 (or int32) words as their unsigned values in int64."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _low32(x: torch.Tensor, dtype=torch.uint32) -> torch.Tensor:
    """int64 values -> their low 32 bits, as int32 or viewed as uint32 (no
    uint32 arithmetic: torch's CPU uint32 has none)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32).view(dtype)


def _check_offsets(offs: torch.Tensor, n: int | None, lo: int, hi: int, what: str) -> None:
    if offs.dtype != torch.int32 or offs.dim() != 1 or not offs.is_contiguous():
        raise ValueError("offsets must be a contiguous 1-D int32 tensor")
    if n is not None and offs.numel() % n:
        raise ValueError(f"the offset count must be a multiple of {n} (one Pallas program)")
    if offs.numel() and (int(offs.min()) < lo or int(offs.max()) > hi):
        raise ValueError(f"offsets out of range: {what} must lie in [{lo}, {hi}]")


def _check_rows(t: torch.Tensor, rows: int, name: str) -> None:
    if tuple(t.shape) != (rows, LANES) or t.dtype not in (torch.int32, torch.uint32) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [{rows}, {LANES}] int32/uint32 tensor")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# Q1 _k_write
# ---------------------------------------------------------------------------

def write_call_ref(offs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of Q1: [256, 128] int32."""
    rows = (offs.to(torch.int64)[:, None] + torch.arange(2, device=offs.device)).reshape(-1)
    out = torch.zeros(WRITE_ROWS, LANES, dtype=torch.int64, device=offs.device)
    out.index_add_(0, rows, vals.to(torch.int64))
    return _low32(out, torch.int32)


def write_call(offs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Q1: zero [256, 128] int32, add the 2-row slab vals[2i : 2i+2] at rows
    offs[i], offs[i] + 1 for every i. offs [n] int32 in [0, 254]; vals
    [2n, 128] int32."""
    n = offs.numel()
    _check_rows(vals, 2 * n, "vals")
    _check_offsets(offs, None, 0, WRITE_ROWS - 2, "a slab's first row")
    if not build.on_cuda(offs, vals):
        return write_call_ref(offs, vals)
    out = torch.empty(WRITE_ROWS, LANES, dtype=torch.int32, device=vals.device)
    fn = build.library("probes").probe_write
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(vals.device):
        build.check(fn(_ptr(offs), n, _ptr(vals), WRITE_ROWS, _ptr(out), build.launch_stream(vals)),
                    "probe_write")
    build.LAUNCHES["probe_write"] += 1
    return out


# ---------------------------------------------------------------------------
# Q2 _k_window
# ---------------------------------------------------------------------------

def window_call_ref(offs: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    """Plain version of Q2: [2N, 128] uint32."""
    o = offs.to(torch.int64)
    rows = (o >> 7)[:, None, None] + torch.arange(2, device=o.device)[None, :, None]
    cols = ((o & (LANES - 1))[:, None, None] + torch.arange(LANES, device=o.device)) & (LANES - 1)
    return stream.view(torch.int32)[rows, cols].reshape(-1, LANES).view(torch.uint32)


def window_call(offs: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    """Q2: each offset's rotated 2-row window of stream [S, 128] uint32 ->
    [2N, 128] uint32. offs [N] int32, N a multiple of 512, (o >> 7) + 1 < S."""
    if stream.dim() != 2:
        raise ValueError("stream must be [S, 128]")
    _check_rows(stream, stream.shape[0], "stream")
    _check_offsets(offs, PROGRAM, 0, LANES * (stream.shape[0] - 1) - 1, "a window's first word")
    if not build.on_cuda(offs, stream):
        return window_call_ref(offs, stream)
    n = offs.numel()
    out = torch.empty(2 * n, LANES, dtype=torch.uint32, device=stream.device)
    fn = build.library("probes").probe_window
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(stream.device):
        build.check(fn(_ptr(offs), n, _ptr(stream), _ptr(out), build.launch_stream(stream)),
                    "probe_window")
    build.LAUNCHES["probe_window"] += 1
    return out


# ---------------------------------------------------------------------------
# Q3 _k_asm
# ---------------------------------------------------------------------------

def asm_call_ref(offs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of Q3: [300, 128] uint32, the last program's slabs."""
    o = offs[-PROGRAM:].to(torch.int64)
    first = offs.numel() - o.numel()
    v = _i64(vals)[2 * first :].reshape(-1, 2, LANES)
    cols = (torch.arange(LANES, device=o.device) - (o & (LANES - 1))[:, None]) & (LANES - 1)
    rolled = torch.gather(v, 2, cols[:, None, :].expand(-1, 2, -1))  # jnp.roll by +lane
    rows = ((o >> 7)[:, None] + torch.arange(2, device=o.device)).reshape(-1)
    out = torch.zeros(ASM_ROWS, LANES, dtype=torch.int64, device=o.device)
    out.index_add_(0, rows, rolled.reshape(-1, LANES))
    return _low32(out)


def asm_call(offs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Q3: [300, 128] uint32 = the last program's 512 slabs vals[2i : 2i+2]
    (uint32 [2N, 128]), each rotated right by o & 127 lanes and added at row
    o >> 7. offs [N] int32, N a multiple of 512, (o >> 7) + 2 <= 300."""
    n = offs.numel()
    _check_rows(vals, 2 * n, "vals")
    _check_offsets(offs, PROGRAM, 0, LANES * (ASM_ROWS - 1) - 1, "a slab's first word")
    if n == 0:
        raise ValueError("no offsets: Q3 has no last program")
    if not build.on_cuda(offs, vals):
        return asm_call_ref(offs, vals)
    out = torch.empty(ASM_ROWS, LANES, dtype=torch.uint32, device=vals.device)
    fn = build.library("probes").probe_asm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(vals.device):
        build.check(fn(_ptr(offs), n - PROGRAM, n, _ptr(vals), ASM_ROWS, _ptr(out),
                       build.launch_stream(vals)), "probe_asm")
    build.LAUNCHES["probe_asm"] += 1
    return out


# ---------------------------------------------------------------------------
# the probe path: tools/profile_pallas.py's shapes on the card
# ---------------------------------------------------------------------------

def probe_inputs(device) -> dict:
    """The probe's own inputs (profile_pallas.py :56-57, :96-97, :136-137)."""
    n = 65536
    return {
        "write": (torch.tensor(np.arange(512) % 250, dtype=torch.int32, device=device),
                  torch.ones(1024, LANES, dtype=torch.int32, device=device)),
        "window": (torch.tensor(np.random.default_rng(0).integers(0, 128 * 1000, n),
                                dtype=torch.int32, device=device),
                   torch.arange(1024 * LANES, dtype=torch.int32, device=device)
                   .view(torch.uint32).reshape(1024, LANES)),
        "asm": (torch.tensor(np.random.default_rng(1).integers(0, 290 * 128, n),
                             dtype=torch.int32, device=device),
                torch.ones(2 * n, LANES, dtype=torch.int32, device=device).view(torch.uint32)),
    }


CALLS = {"write": (write_call, write_call_ref), "window": (window_call, window_call_ref),
         "asm": (asm_call, asm_call_ref)}


def run_probes(inputs: dict) -> dict:
    """The probe path: Q1-Q3 on their inputs (``probe_inputs``)."""
    return {key: CALLS[key][0](*args) for key, args in inputs.items()}


def _event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the probes run on the card")
        return 1
    card = torch.device("cuda")
    name = torch.cuda.get_device_name(card)
    ok = True
    inputs = probe_inputs(card)
    for key, got in run_probes(inputs).items():
        kernel, plain = CALLS[key]
        args = inputs[key]
        want = plain(*(a.cpu() for a in args))
        same = torch.equal(_i64(got.cpu()), _i64(want))
        ok &= same
        print(f"{'OK  ' if same else 'FAIL'} {key:8s} {_event_ms(lambda: kernel(*args)):.4f} ms  "
              f"{tuple(got.shape)}  {name}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
