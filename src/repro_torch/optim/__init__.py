from .adamw import AdamWConfig, adamw_init, adamw_update
from .compress import compress_gradients_int8, decompress_gradients_int8

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_gradients_int8",
           "decompress_gradients_int8"]
