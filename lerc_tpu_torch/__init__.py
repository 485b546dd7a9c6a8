"""lerc_tpu_torch: the LERC codec in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (H100).

A port of ``lerc_tpu`` (JAX), which stays the reference. The numpy-facing
API mirrors the reference ``lerc`` Python package (encode / encode_4D /
encode_ma, decode / decode_4D / decode_ma, getLercBlobInfo[_4D],
getLercDataRanges, compress / decompress); the device-resident codecs and
the band codec sit below it. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, which runs
each kernel's plain PyTorch version.
"""
from .api import (
    compress,
    computeCompressedSize,
    computeCompressedSize_4D,
    computeCompressedSizeForVersion,
    convert2ma,
    decode,
    decode_4D,
    decode_ma,
    decode_to_dtype,
    decodeToDouble,
    decodeToDouble_4D,
    decompress,
    encode,
    encode_4D,
    encode_ma,
    encodeForVersion,
    findDataRange,
    findDataRange_ma,
    findMaxZError,
    findMaxZError_4D,
    findMaxZError_ma,
    getLercBlobInfo,
    getLercBlobInfo_4D,
    getLercDataRanges,
    getLercDatatype,
    getLercShape,
)
from .codec.device_codec import DecodedBand, decode_band_device, encode_band_device
from .codec.encode_orchestrator import set_acceleration
from .codec.resident import FusedResidentCodec, ResidentBlob, ResidentCodec
from .constants import DataType, ErrCode
