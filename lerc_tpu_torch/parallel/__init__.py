"""Multi-GPU tile mosaic (``sharding``) over torch.distributed: the port of
``lerc_tpu/parallel``."""
from .sharding import (MosaicEncoder, decode_mosaic, decode_mosaic_device, decode_mosaic_region,
                       make_mesh, read_mosaic, split_into_tiles)

__all__ = ["MosaicEncoder", "decode_mosaic", "decode_mosaic_device", "decode_mosaic_region",
           "make_mesh", "read_mosaic", "split_into_tiles"]
