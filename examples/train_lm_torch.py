"""End-to-end run on the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on the synthetic token pipeline, with
checkpoint/restart (``repro_torch``; the twin of ``examples/train_lm.py``).

The config is a scaled-down member of the qwen2 family (same block
structure as the assigned archs); on CPU this runs at a few steps/min —
pass --steps/--seq-len/--global-batch to trade fidelity for time.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 300
      PYTHONPATH=src python examples/train_lm_torch.py --steps 400 --resume
      (add --device cpu to run on the host)
"""
import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import TrainLoopConfig, run_training
from repro_torch.optim.adamw import AdamWConfig

# ~100M params: 12 x (attn 4*512^2 + swiglu 3*512*2048) + 2 * 32000*512
REPRO_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    rope_theta=1e4,
    param_dtype="float32",
    compute_dtype="float32",
    remat_policy="none",
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="build/repro_100m_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    n_params = REPRO_100M.param_count()
    print(f"[example] repro-100m: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.global_batch} x {args.seq_len}")

    out = run_training(REPRO_100M, TrainLoopConfig(
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=10,
        resume=args.resume,
        opt=AdamWConfig(lr=6e-4, warmup_steps=50, total_steps=args.steps),
    ), device=args.device)
    print(f"[example] done: {out['steps_run']} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")
    if args.steps >= 100:          # too few steps to demand progress
        assert out["final_loss"] < out["losses"][0], "loss should decrease"


if __name__ == "__main__":
    main()
