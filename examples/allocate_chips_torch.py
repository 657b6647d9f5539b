"""PCC-driven chip allocation from the port's dry-run records (the twin of
``examples/allocate_chips.py``).

For each (architecture x input shape) job, the dry run's roofline terms
(``repro_torch.launch.dryrun``: rank 0's traced step on a fake process
group, at the H100's data-sheet rates) become a step-time-vs-chips
performance characteristic curve; the paper's §2.1 policy picks the
optimal (not peak) chip count. The whole table is one batched call:
``allocate_chips_batch`` fits every record's curve in one vectorized
float64 pass and decides through the batched float64 allocation policy,
on the card unless ``--device cpu``.

Requires dry-run records (python -m repro_torch.launch.dryrun --arch ...
--shape ... --out DIR). Run:

  PYTHONPATH=src python examples/allocate_chips_torch.py --records DIR
"""
import argparse
import glob
import json
import os

from repro_torch.core.chip_allocator import allocate_chips_batch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--records", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--min-gain", type=float, default=0.005,
                    help="required relative step-time gain per chip-fraction")
    ap.add_argument("--max-chips", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    files = sorted(glob.glob(os.path.join(args.records,
                                          f"*_{args.mesh}.json")))
    if not files:
        raise SystemExit(f"no dry-run records under {args.records} (run "
                         "python -m repro_torch.launch.dryrun first)")

    recs = []
    for f in files:
        with open(f) as fh:
            rec = json.load(fh)
        if "error" in rec or "skipped" in rec:
            continue
        recs.append(rec)
    if not recs:
        raise SystemExit("no usable dry-run records")

    allocs = allocate_chips_batch(recs, min_gain=args.min_gain,
                                  max_chips=args.max_chips,
                                  device=args.device)

    print(f"{'arch':22s} {'shape':12s} {'chips*':>7s} {'PCC a':>8s} "
          f"{'step@opt':>10s} {'bound':>11s}")
    for rec, alloc in zip(recs, allocs):
        print(f"{rec['arch']:22s} {rec['shape']:12s} {alloc.chips:>7d} "
              f"{alloc.pcc_a:>8.3f} {alloc.predicted_step_s*1e3:>8.1f}ms "
              f"{alloc.dominant_at_choice:>11s}")
    print(f"[batched] {len(recs)} records decided in one policy call")


if __name__ == "__main__":
    main()
