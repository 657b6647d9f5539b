#!/usr/bin/env python3
"""Kernels K4 and K5 alone on one NVIDIA card: a quick check between full
``chip_smoke.py`` runs.

    python3 tools/probe_kernels.py           # from the repository root

Builds both kernels (printing ptxas's registers, shared memory and
spills), holds the bf16 instantiations against their plain versions at
the card tests' shapes (K4 within 2e-2, causal and full; K5 within 5e-2,
every (P, N)), checks that two runs of the same inputs are bitwise equal,
and times both at the LM shapes as ``chip_smoke.py`` does (L2 flushed;
K4 beside ``scaled_dot_product_attention``). Exits non-zero if a build,
a launch or a check fails.
"""
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

K4_SHAPES = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 256, 128),
             (2, 4, 4, 512, 32), (1, 32, 8, 512, 128), (2, 4, 2, 100, 16),
             (1, 2, 1, 1, 64), (1, 32, 32, 512, 80), (2, 4, 4, 100, 80),
             (1, 4, 2, 256, 80), (2, 4, 1, 1000, 128), (1, 4, 4, 2047, 80)]
K5_SHAPES = [(1, 128, 2, 32, 64, 64), (2, 256, 4, 64, 128, 128),
             (2, 512, 1, 16, 32, 128), (1, 256, 3, 64, 64, 256),
             (2, 64, 8, 16, 16, 32), (1, 48, 2, 16, 16, 128),
             (1, 512, 2, 64, 128, 256)] + [
    (2, 256, 3, P, N, 128) for P in (16, 32, 64) for N in (16, 32, 64, 128)]


def print_ptxas(name: str, log: str) -> None:
    """Registers and spills of each tensor-core instance (namespace
    ``tc``) from nvcc's ``-Xptxas -v`` output."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function '_ZN2tc" in line:
            info = [l.split(":", 1)[-1].strip() if "ptxas" in l else l.strip()
                    for l in lines[i + 1:i + 5]
                    if "spill" in l or "registers" in l]
            print(f"{name}: {line.split()[-3]}: " + "; ".join(info))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA card visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs = _build.build(["flash_attention", "ssd"])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        print_ptxas(name, path.with_suffix(".log").read_text())
    bad = 0
    for shape in K4_SHAPES:
        for causal in (True, False):
            q, k, v = cs.attn_inputs(shape, torch.bfloat16, sum(shape))
            got = ops.flash_attention(q, k, v, causal=causal)
            want = cs.attn_plain(q, k, v, causal)
            ok = torch.allclose(got.float(), want.float(), atol=2e-2,
                                rtol=2e-2)
            det = torch.equal(got, ops.flash_attention(q, k, v,
                                                       causal=causal))
            bad += not (ok and det)
            print(f"K4 {shape} {'causal' if causal else 'full'}: max |diff| "
                  f"{float((got.float() - want.float()).abs().max()):.4g} "
                  f"within 2e-2 {ok}, deterministic {det}", flush=True)
    for shape in K5_SHAPES:
        args = cs.ssd_inputs(shape, torch.bfloat16, sum(shape))
        got = ops.ssd_scan(*args, chunk=shape[5])
        want = cs.ssd_plain(args, shape[5])
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=5e-2, rtol=5e-2)
        det = torch.equal(got, ops.ssd_scan(*args, chunk=shape[5]))
        bad += not (ok and det)
        print(f"K5 {shape}: max |diff| "
              f"{float((got.float() - want.float()).abs().max()):.4g} "
              f"within 5e-2 {ok}, deterministic {det}", flush=True)
    if bad:
        print(f"probe_kernels: {bad} case(s) failed")
        return 1
    for shape in (cs.LM_ATTN_SHAPE, cs.ZAMBA2_ATTN_SHAPE):
        cs.k4_times(shape)
    for shape in (cs.ZAMBA2_SSD_SHAPE, cs.MAMBA2_SSD_SHAPE):
        args = cs.ssd_inputs(shape, torch.bfloat16, 7)
        ms = cs.kernel_ms(lambda: ops.ssd_scan(*args, chunk=shape[5]),
                          reps=10)
        bound, by = cs.ssd_bound_ms(shape, 2)
        print(f"K5 at {shape} bf16: {ms:.4f} ms (median of 10, L2 "
              f"flushed); bound {bound:.4f} ms ({by})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
