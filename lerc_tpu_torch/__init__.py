"""lerc_tpu_torch: the LERC codec's device-resident path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``lerc_tpu`` (JAX), which stays the reference. Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``, which
runs each kernel's plain PyTorch version.
"""
from .codec.resident import FusedResidentCodec, ResidentBlob, ResidentCodec

__all__ = ["FusedResidentCodec", "ResidentBlob", "ResidentCodec"]
