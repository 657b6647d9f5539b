"""Elastic restart end-to-end on the PyTorch port: train on a mesh -> lose
a host -> resize -> resume (the twin of ``examples/elastic_restart.py``).

  1. train N steps on a ("data", "model") mesh with periodic async
     checkpoints (full host views, written by rank 0);
  2. a simulated host failure hits the ``ElasticController``, which
     proposes the largest healthy power-of-two data-parallel mesh (the
     model axis fixed);
  3. the loop restores the newest checkpoint, re-sharding each full host
     view onto the NEW mesh's placements (``restore(shardings=...)``,
     ``distribute_tensor``), seeks the deterministic data pipeline to the
     restored step and continues training;
  4. losses across the boundary continue from the restored state.

One process is one rank, so both meshes are 1x1 here, as on the
reference's one-device container; every code path (replanning, atomic
restore, re-sharding, skip-ahead) is the multi-card one. On several cards
run the same loop under ``torchrun`` with ``MeshPlan.build()``.

Run:  PYTHONPATH=src python examples/elastic_restart_torch.py
      (add --device cpu to run on the host, over gloo)
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.elastic import ElasticController, MeshPlan
from repro_torch.launch.mesh import init_single_rank_group, make_smoke_mesh
from repro_torch.launch.train import TrainLoopConfig, run_training


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_config("minitron-8b", smoke=True)
    init_single_rank_group(args.device)
    mesh = make_smoke_mesh((1, 1))
    ctl = ElasticController(MeshPlan(data=4, model=1), chips_per_host=1)
    print(f"[elastic] initial plan: {ctl.current.shape()} "
          f"({ctl.total_hosts} hosts); this process's mesh "
          f"{tuple(mesh.mesh.shape)} on {args.device}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = dict(ckpt_dir=ckpt_dir, ckpt_every=6, seq_len=64,
                    global_batch=4, log_every=6)
        out1 = run_training(cfg, TrainLoopConfig(steps=12, **loop), mesh,
                            device=args.device)
        print(f"[elastic] phase 1: {out1['steps_run']} steps, "
              f"loss {out1['final_loss']:.4f}")

        # host 2 dies mid-job
        new_plan = ctl.host_failed(2)
        st = ctl.status()
        print(f"[elastic] host 2 failed -> replan "
              f"{new_plan.shape() if new_plan else None}, "
              f"healthy {st['healthy_hosts']}/{st['total_hosts']}, "
              f"degraded={st['degraded']}")
        assert new_plan is not None and new_plan.data == 2

        # resume from the latest atomic checkpoint, re-sharded onto the
        # mesh; the deterministic pipeline seeks to the restored step
        out2 = run_training(cfg, TrainLoopConfig(steps=24, resume=True,
                                                 **loop), mesh,
                            device=args.device)
        print(f"[elastic] phase 2 (after resize): resumed from step "
              f"{out2['resumed_from']}, +{out2['steps_run']} steps, "
              f"loss {out2['final_loss']:.4f}")
        assert out2["resumed_from"] == 12
        assert out2["final_loss"] < out1["final_loss"] + 0.5

        # host comes back: controller restores the original plan
        restored = ctl.host_recovered(2)
        print(f"[elastic] host 2 recovered -> plan {restored.shape()}, "
              f"degraded={ctl.status()['degraded']}")
        assert ctl.current == ctl.initial
    print("[elastic] full failure/resize/recovery cycle OK")


if __name__ == "__main__":
    main()
