"""The training loop: the reference's crash-only ``run_training`` on one
card.

The port of ``repro.launch.train``: the same ``TrainLoopConfig``, the same
synthetic token stream (``repro_torch.data``), seeded weights drawn from a
``torch.Generator``, the same checkpoints (``repro_torch.ckpt``, files
either package restores) and the same returned dict. With ``ckpt_dir``
the state is saved every ``ckpt_every`` steps and once more at the end;
with ``resume`` the newest checkpoint is restored (its config hash
checked) and the token stream continues from its step. With ``mesh`` (a
``DeviceMesh`` with axes ("data", "model")) the state is sharded onto it
(``train.steps.shard_state``), each batch too, and a resume restores the
checkpoint onto the mesh's placements (``state_shardings``), whatever
mesh saved it: an elastic restart onto a smaller mesh.

One difference, a repair: the reference starts its token pipeline's
prefetch thread before seeking it, and the thread reads its first step
when it starts, so a resumed reference run is fed the batches from step
0 on (ROADMAP, reference baseline). Here the pipeline is sought before it
starts, so a resumed run sees the batches an uninterrupted run would.

CLI (runs on the card):
  python -m repro_torch.launch.train --arch zamba2-2.7b-smoke --steps 50
  python -m repro_torch.launch.train --arch zamba2-2.7b-smoke --steps 20 \
      --ckpt-dir /tmp/ck --resume
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch zamba2-2.7b-smoke --mesh 2x2
``--mesh DxM`` builds the mesh over the process group that ``torchrun``
started (NCCL, one card a rank) and raises unless it has D*M ranks;
without ``torchrun``, over one rank (``--mesh 1x1``).
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
                                     shard_batch, shard_state,
                                     state_from_leaves, state_leaves,
                                     state_shardings)

__all__ = ["TrainLoopConfig", "run_training", "mesh_from_arg", "main"]


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
    ``log_every`` steps, after the step's loss has reached the host. With
    ``mesh``, ``device`` is this rank's card (or ``"cpu"`` for a gloo
    mesh) and every rank of the mesh calls it."""
    device = resolve_device(device)
    ckpt = CheckpointManager(loop.ckpt_dir) if loop.ckpt_dir else None
    chash = CheckpointManager.config_hash(cfg)
    generator = torch.Generator(device).manual_seed(loop.seed)
    state = init_train_state(cfg, generator, device, loop.opt)
    start_step = 0
    if ckpt is not None and loop.resume and ckpt.latest_step() is not None:
        shardings = (state_leaves(state_shardings(cfg, mesh))
                     if mesh is not None else None)
        leaves, start_step = ckpt.restore(state_leaves(state),
                                          shardings=shardings, mesh=mesh,
                                          expect_config_hash=chash)
        state = state_from_leaves(leaves, state)
        del leaves
        log_fn(f"[train] resumed from step {start_step}")
    elif mesh is not None:
        state = shard_state(state, cfg, mesh)
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))
    pipe.seek(start_step)
    pipe.start()
    step_fn = make_train_step(cfg, mesh)
    mesh_shape = ({} if mesh is None else
                  dict(zip(mesh.mesh_dim_names, map(int, mesh.mesh.shape))))

    def save(step):
        # a step cut inside the optimizer's in-place update leaves the
        # state torn (its count ahead of its step): that one is not saved
        if state.opt.count == state.step:
            ckpt.save(step, state_leaves(state), config_hash=chash,
                      mesh_shape=mesh_shape)

    losses = []
    t0 = time.time()
    final_step = start_step
    try:
        for step in range(start_step, loop.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(pipe).items()}
            if mesh is not None:
                batch = shard_batch(batch, cfg, mesh)
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


def mesh_from_arg(spec: str):
    """``"DxM"`` -> (a ("data", "model") mesh of D x M over the default
    process group, this rank's card). The group is ``torchrun``'s (NCCL,
    from its environment) or, without a launcher, one rank. Raises
    unless the group has D * M ranks."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_single_rank_group, make_smoke_mesh
    d, m = (int(x) for x in spec.split("x"))
    if not torch.cuda.is_available():
        raise RuntimeError("--mesh runs on the cards: torch.cuda is not "
                           "available")
    launched = "WORLD_SIZE" in os.environ
    world = (dist.get_world_size() if dist.is_initialized() else
             int(os.environ["WORLD_SIZE"]) if launched else 1)
    if world != d * m:
        raise RuntimeError(f"--mesh {spec} needs {d * m} ranks; the process "
                           f"group has {world}")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    if not dist.is_initialized():
        if launched:
            dist.init_process_group("nccl")
        else:
            init_single_rank_group("cuda")
    if dist.get_world_size() != d * m:
        raise RuntimeError(f"--mesh {spec} needs {d * m} ranks; the process "
                           f"group has {dist.get_world_size()}")
    return make_smoke_mesh((d, m)), torch.device("cuda", local)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="", help="e.g. 1x1 or 2x2 (data x model)")
    args = ap.parse_args()
    loop = TrainLoopConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        resume=args.resume)
    if args.mesh:
        mesh, device = mesh_from_arg(args.mesh)
        out = run_training(get_config(args.arch), loop, mesh, device=device)
    else:
        out = run_training(get_config(args.arch), loop)
    print(f"[train] done: {out['steps_run']} steps, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
