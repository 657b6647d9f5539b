"""The training loop: the reference's ``run_training`` on one card.

The port of ``repro.launch.train``: the same ``TrainLoopConfig``, the same
synthetic token stream (``repro_torch.data``), seeded weights drawn from a
``torch.Generator``, and the same returned dict. Checkpointing and
resuming come with the checkpoint slice, meshes with the multi-card
slice; asking for either raises ``NotImplementedError``.

CLI (runs on the card):
  python -m repro_torch.launch.train --arch zamba2-2.7b-smoke --steps 50
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "run_training", "main"]


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: str = ""
    log_every: int = 10
    seed: int = 0
    resume: bool = False
    opt: AdamWConfig = AdamWConfig(warmup_steps=20)


def run_training(cfg: ModelConfig, loop: TrainLoopConfig, mesh=None,
                 log_fn: Callable[[str], Any] = print,
                 device: Union[str, torch.device, None] = None
                 ) -> Dict[str, Any]:
    """Returns {'final_loss', 'steps_run', 'losses', 'resumed_from'}. On the
    card unless ``device="cpu"``. ``log_fn`` gets one line each
    ``log_every`` steps, after the step's loss has reached the host."""
    if mesh is not None:
        raise NotImplementedError("meshes come with the multi-card LM slice")
    if loop.ckpt_dir or loop.resume:
        raise NotImplementedError(
            "checkpointing and resuming come with the checkpoint slice "
            "(ckpt/checkpoint.py)")
    device = resolve_device(device)
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed)).start()
    generator = torch.Generator(device).manual_seed(loop.seed)
    state = init_train_state(cfg, generator, device, loop.opt)
    step_fn = make_train_step(cfg)

    losses = []
    t0 = time.time()
    final_step = 0
    try:
        for step in range(loop.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(pipe).items()}
            state, metrics = step_fn(state, batch)
            final_step = step + 1
            if (step + 1) % loop.log_every == 0 or step + 1 == loop.steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                rate = (step + 1) / max(time.time() - t0, 1e-9)
                log_fn(f"[train] step {step+1}/{loop.steps} "
                       f"loss {loss:.4f} ({rate:.2f} it/s)")
    finally:
        pipe.stop()

    return {"final_loss": losses[-1] if losses else float("nan"),
            "steps_run": final_step, "losses": losses, "resumed_from": 0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="", help="multi-card: not ported yet")
    args = ap.parse_args()
    if args.mesh:
        raise NotImplementedError("--mesh comes with the multi-card LM slice")
    out = run_training(get_config(args.arch), TrainLoopConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch))
    print(f"[train] done: {out['steps_run']} steps, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
