"""The repo's own AdamW (+ cosine schedule, global-norm clipping) in PyTorch.

A port of ``repro/optim/adamw.py``, not ``torch.optim.AdamW``: the
reference clips the global gradient norm, warms the learning rate up
linearly and then follows a cosine to ``min_lr_ratio``, uses b2 = 0.95, and
keeps m and v in float32 whatever the parameter dtype. It serves both the
PCC models (``step`` reads each parameter's ``.grad``) and the LM trainer
(``update`` takes the gradients as a list). Parameters, m and v are
updated in place under ``torch.no_grad``, with the reference's order of
operations and at most two float32 temporaries the size of one parameter
(a 708 M-element leaf of zamba2-2.7b would otherwise need five).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["AdamWConfig", "AdamW", "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to ``cfg.lr``, then cosine down to ``min_lr_ratio``."""
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return cfg.lr * (warm if step < cfg.warmup_steps else cos)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class AdamW:
    """State (fp32 m, v and the step count) for a fixed list of params."""

    def __init__(self, params: Sequence[torch.nn.Parameter], cfg: AdamWConfig,
                 m: Optional[Sequence[torch.Tensor]] = None,
                 v: Optional[Sequence[torch.Tensor]] = None, count: int = 0):
        """Zero m and v and count 0, unless a restored state is passed."""
        self.params: List[torch.nn.Parameter] = list(params)
        self.cfg = cfg
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)
                         for p in self.params]
        self.m = list(m) if m is not None else zeros()
        self.v = list(v) if v is not None else zeros()
        self.count = count

    def step(self) -> Dict[str, torch.Tensor]:
        """Apply one update from the params' ``.grad``; returns metrics."""
        return self.update([p.grad for p in self.params])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update from ``grads`` (one per param, any float
        dtype); returns {"grad_norm", "lr"}."""
        cfg = self.cfg
        self.count += 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = cosine_schedule(cfg, self.count)
        b1c = 1 - cfg.b1 ** self.count
        b2c = 1 - cfg.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g.float() if g.dtype != torch.float32 else g.clone()
            g.mul_(scale)                                 # clipped gradient
            t = g * (1 - cfg.b1)
            m.mul_(cfg.b1).add_(t)                        # b1 m + (1 - b1) g
            torch.mul(g, g, out=t)
            v.mul_(cfg.b2).add_(t.mul_(1 - cfg.b2))       # b2 v + (1 - b2) g^2
            torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
            step = torch.div(m, b1c, out=t).div_(g)       # m^ / (sqrt(v^) + eps)
            g.copy_(p).mul_(cfg.weight_decay)
            step.add_(g)                                  # + wd p
            g.copy_(p).sub_(step.mul_(lr))                # p - lr step
            p.copy_(g)
            del g, t, step
        return {"grad_norm": gnorm, "lr": lr}
