"""Serving example on the PyTorch port: batched greedy decoding through the
slot-based server (``repro_torch``; the twin of ``examples/serve_lm.py``).

Uses a small member of the granite family (the code path is identical for
every decoder-only arch; pick any with --arch <id>-smoke).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --requests 8 [--device cpu]

On the card (``--device cuda``, the default) ``--attention pallas`` runs
kernel K4 once a layer in every prefill.
"""
import argparse
import time

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Request, ServeConfig, Server
from repro_torch.models import model_api


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-34b-smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--attention", default="xla", choices=("xla", "tri",
                                                             "pallas"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch),
                              attention_impl=args.attention)
    params = model_api.init(cfg, torch.Generator(device).manual_seed(0),
                            device)
    # the reference's ServeConfig also takes max_len, which it reads nowhere
    server = Server(cfg, ServeConfig(batch_size=4, prompt_len=32), params,
                    device=device)

    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(1, cfg.vocab_size, size=rng.randint(4, 24))
                    .astype(np.int32), max_new_tokens=args.new_tokens)
            for i in range(args.requests)]

    t0 = time.time()
    out = server.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in out.values())
    print(f"[serve] {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s on {device})")
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]}")


if __name__ == "__main__":
    main()
