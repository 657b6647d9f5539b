"""The repo's own optimizer, ported to PyTorch."""
from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule, global_norm
from repro_torch.optim.compression import (compress_int8, compressed_psum,
                                           decompress_int8)

__all__ = ["AdamW", "AdamWConfig", "cosine_schedule", "global_norm",
           "compress_int8", "decompress_int8", "compressed_psum"]
