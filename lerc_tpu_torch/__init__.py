"""lerc_tpu_torch: the LERC codec's device-resident path and its band codec
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``lerc_tpu`` (JAX), which stays the reference. Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``, which
runs each kernel's plain PyTorch version.
"""
from .codec.device_codec import DecodedBand, decode_band_device, encode_band_device
from .codec.resident import FusedResidentCodec, ResidentBlob, ResidentCodec

__all__ = ["DecodedBand", "FusedResidentCodec", "ResidentBlob", "ResidentCodec",
           "decode_band_device", "encode_band_device"]
