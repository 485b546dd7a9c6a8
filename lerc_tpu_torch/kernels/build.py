"""Build and load the hand-written Hopper kernels.

Each ``.cu`` source in this directory is compiled by ``nvcc`` into a shared
library with a plain C interface, on first use, into ``.torch_ext_build/``
at the root of the checkout (listed in ``.gitignore``). The libraries are
loaded with ``ctypes``; tensor pointers and the current CUDA stream pass as
integers. A source that includes no PyTorch header builds in seconds, where
``torch.utils.cpp_extension.load`` spends minutes compiling PyTorch's
headers. All sources compile in parallel, one ``nvcc`` each.

Flags: ``sm_90a`` (Hopper) and ``--fmad=false``, so that no multiply-add is
contracted behind the code's back -- the decode ScaleBack must round the
product and the sum separately, and the one fused multiply-add the encoder
needs is written out as ``__fmaf_rn``.

The band decoder's record scanner (``tile_scan.cpp``) and the Huffman
lengths-only scan (``huffman_scan.cpp``) run on the host: they build the
same way with the host compiler (``c++ -O3 -shared -fPIC``), each by itself
on first use (the CPU tests need no ``nvcc``) or beside the CUDA sources in
``build_all``.

A failed build raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / ".torch_ext_build"
SOURCES = ("encode", "fletcher32", "decode", "scan", "huffman", "fpl", "probes")
HOST_SOURCES = ("tile_scan", "huffman_scan")
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset (one per kernel launch,
# counted by its wrapper in lerc_tpu_torch.ops). Integer instances carry
# their dtype's suffix (constants.DT_SUFFIX), e.g. encode_blocks_i16.
INT_SUFFIXES = ("_i8", "_u8", "_i16", "_u16", "_i32", "_u32")
LAUNCHES = {"encode_blocks": 0, "write_records": 0,
            "fletcher32_parts": 0, "decode_records": 0,
            "encode_blocks_masked": 0, "write_records_masked": 0,
            "decode_records_masked": 0,
            "scan_records_sizes": 0, "scan_records_double": 0, "scan_records_describe": 0,
            "decode_scanned": 0}
LAUNCHES.update({f"{k}{m}{sfx}": 0 for sfx in INT_SUFFIXES
                 for k in ("encode_blocks", "write_records", "decode_records")
                 for m in ("", "_masked")})
LAUNCHES.update({f"decode_scanned{sfx}": 0 for sfx in INT_SUFFIXES})
# the band codec's instances: K1/K2 with the LUT candidate on 8x8 and 16x16
# blocks (float32, and int32 input for every integer dtype), K6 on 16x16
# blocks and with validity words (masks, edge blocks), and the host scanner
LAUNCHES.update({f"{k}{m}{t}": 0 for k in ("encode_blocks", "write_records")
                 for m in ("_lut", "_lut16") for t in ("", "_int")})
LAUNCHES.update({f"decode_scanned{mb}{m}{sfx}": 0 for mb in ("", "16")
                 for m in ("", "_masked") for sfx in ("",) + INT_SUFFIXES if mb or m})
LAUNCHES["tile_scan"] = 0
# the 8-bit Huffman path: H1 (all-valid, masked), H2 (group bits, pack), H3,
# H4 (direct, column 0 + rows, masked direct, masked delta), the host scan
LAUNCHES.update({k: 0 for k in (
    "huffman_symbols", "huffman_symbols_masked", "huffman_group_bits", "huffman_pack",
    "huffman_decode", "huffman_restore", "huffman_restore_col0", "huffman_restore_delta",
    "huffman_restore_masked", "huffman_restore_delta_masked", "huffman_scan")})
# lossless float32 (fpl): F1 sampled histograms, F2 planes, F2b PackBits
# sizes, F3 restore; F2b and F3 are one entry point each, of several
# kernel launches, counted once per call
LAUNCHES.update({k: 0 for k in (
    "fpl_sample_histograms", "fpl_finalize", "fpl_packbits_size", "fpl_restore")})
# float64: K1/K2 f64 (8x8, all-valid and masked), K6 f64 (8x8 and 16x16,
# all-valid and masked), and F1, F2 and F3 over u64 words (F2b is one kernel
# for 4 and 8 planes)
LAUNCHES.update({f"{k}{m}_f64": 0 for k in ("encode_blocks", "write_records")
                 for m in ("", "_masked")})
LAUNCHES.update({f"decode_scanned{mb}{m}_f64": 0 for mb in ("", "16") for m in ("", "_masked")})
LAUNCHES.update({f"{k}_f64": 0 for k in ("fpl_sample_histograms", "fpl_finalize", "fpl_restore")})

# the mosaic: K4 with LUT records on 8x8 and 16x16 blocks over n units
# (float32 and every integer dtype, all-valid and masked), and the
# tile-batched K1 instances (per-tile ranges: LUT on 8x8 and 16x16, float64)
LAUNCHES.update({f"decode_records_lut{mb}{m}{sfx}": 0 for mb in ("", "16")
                 for m in ("", "_masked") for sfx in ("",) + INT_SUFFIXES})
LAUNCHES.update({f"encode_tiles{m}": 0 for m in ("_lut", "_lut16", "_lut_int", "_lut16_int",
                                                  "_f64")})
# the Pallas probes of tools/profile_pallas.py (Q1-Q3, ops/probes.py)
LAUNCHES.update({k: 0 for k in ("probe_write", "probe_window", "probe_asm")})

_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    found = shutil.which("c++")
    if not found:
        raise RuntimeError("c++ not found: the host record scanner cannot be built")
    return found


def _source(name: str) -> Path:
    return SRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    if name in HOST_SOURCES:
        extra = " ".join(HOST_FLAGS).encode()
    else:
        headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
        extra = headers + " ".join(NVCC_FLAGS).encode()
    key = hashlib.sha256(src + extra).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=SOURCES + HOST_SOURCES) -> dict[str, str]:
    """Compile every source of `names` whose library is missing, all in
    parallel. Returns {source: compiler report} for the sources compiled by
    this call (ptxas: register and shared-memory use per kernel); raises
    RuntimeError with the compiler output on failure."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        flags = (_cxx(), *HOST_FLAGS) if name in HOST_SOURCES else (_nvcc(), *NVCC_FLAGS)
        cmd = [*flags, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {_source(name).name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, building it on first use (a
    CUDA source with all the others, the host scanner by itself)."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,) if name in HOST_SOURCES else SOURCES)
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every one lies on the CPU (run the plain version); raises on
    a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on CUDA or all on the CPU, got {sorted(kinds)}")


def launch_stream(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor t's device, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
