"""The repo's own optimizer, ported to PyTorch."""
from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule, global_norm

__all__ = ["AdamW", "AdamWConfig", "cosine_schedule", "global_norm"]
