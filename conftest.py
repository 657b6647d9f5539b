"""Loaded by every pytest worker before any test module."""
try:
    import torch
except ImportError:
    pass
else:
    # six xdist workers share the cores: one torch thread each, not one a core
    torch.set_num_threads(1)
