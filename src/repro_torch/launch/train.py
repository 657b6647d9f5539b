"""The training loop: the reference's crash-only ``run_training`` on one
card.

The port of ``repro.launch.train``: the same ``TrainLoopConfig``, the same
synthetic token stream (``repro_torch.data``), seeded weights drawn from a
``torch.Generator``, the same checkpoints (``repro_torch.ckpt``, files
either package restores) and the same returned dict. With ``ckpt_dir``
the state is saved every ``ckpt_every`` steps and once more at the end;
with ``resume`` the newest checkpoint is restored (its config hash
checked) and the token stream continues from its step. Meshes come with
the multi-card slice; asking for one raises ``NotImplementedError``.

One difference, a repair: the reference starts its token pipeline's
prefetch thread before seeking it, and the thread reads its first step
when it starts, so a resumed reference run is fed the batches from step
0 on (ROADMAP, reference baseline). Here the pipeline is sought before it
starts, so a resumed run sees the batches an uninterrupted run would.

CLI (runs on the card):
  python -m repro_torch.launch.train --arch zamba2-2.7b-smoke --steps 50
  python -m repro_torch.launch.train --arch zamba2-2.7b-smoke --steps 20 \
      --ckpt-dir /tmp/ck --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Union

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     state_from_leaves, state_leaves)

__all__ = ["TrainLoopConfig", "run_training", "main"]


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: str = ""
    ckpt_every: int = 50
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
    device = resolve_device(device)
    ckpt = CheckpointManager(loop.ckpt_dir) if loop.ckpt_dir else None
    chash = CheckpointManager.config_hash(cfg)
    generator = torch.Generator(device).manual_seed(loop.seed)
    state = init_train_state(cfg, generator, device, loop.opt)
    start_step = 0
    if ckpt is not None and loop.resume and ckpt.latest_step() is not None:
        leaves, start_step = ckpt.restore(state_leaves(state),
                                          expect_config_hash=chash)
        state = state_from_leaves(leaves, state)
        del leaves
        log_fn(f"[train] resumed from step {start_step}")
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))
    pipe.seek(start_step)
    pipe.start()
    step_fn = make_train_step(cfg)

    def save(step):
        # a step cut inside the optimizer's in-place update leaves the
        # state torn (its count ahead of its step): that one is not saved
        if state.opt.count == state.step:
            ckpt.save(step, state_leaves(state), config_hash=chash,
                      mesh_shape={})

    losses = []
    t0 = time.time()
    final_step = start_step
    try:
        for step in range(start_step, loop.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(pipe).items()}
            state, metrics = step_fn(state, batch)
            final_step = step + 1
            if (step + 1) % loop.log_every == 0 or step + 1 == loop.steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                rate = (step + 1 - start_step) / max(time.time() - t0, 1e-9)
                log_fn(f"[train] step {step+1}/{loop.steps} "
                       f"loss {loss:.4f} ({rate:.2f} it/s)")
            if ckpt is not None and (step + 1) % loop.ckpt_every == 0:
                save(step + 1)
    finally:
        pipe.stop()
        if ckpt is not None:
            if final_step % loop.ckpt_every != 0:
                save(final_step)
            ckpt.wait()

    return {"final_loss": losses[-1] if losses else float("nan"),
            "steps_run": final_step - start_step, "losses": losses,
            "resumed_from": start_step}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="", help="multi-card: not ported yet")
    args = ap.parse_args()
    if args.mesh:
        raise NotImplementedError("--mesh comes with the multi-card LM slice")
    out = run_training(get_config(args.arch), TrainLoopConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        resume=args.resume))
    print(f"[train] done: {out['steps_run']} steps, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
