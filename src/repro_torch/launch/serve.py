"""LM server: batched prefill + greedy decode over a closed request set.

The port of ``repro.launch.serve``'s LM server (``Request``,
``ServeConfig``, ``Server``). A batch of ``batch_size`` slots is filled
from the queue, prompts are left-padded with token 0 to ``prompt_len``
(no padding mask, as in the reference) and prefilled together, then one
decode step advances every slot, ``max(max_new_tokens) - 1`` times, and
each request keeps its first ``max_new_tokens`` tokens. Greedy: argmax,
the first maximum on ties, in both frameworks.

On the card (``device="cuda"``, the default) a prefill with
``attention_impl="pallas"`` runs kernel K4 once per layer. The generated
tokens stay on the device until the batch ends: one copy to the host per
batch, not per step. The decode cache is as long as the prompt, a fault
kept from the reference (``models/lm.py``): its ``ServeConfig.max_len``
(a cache capacity read nowhere) and ``greedy`` flag, and
``Request.generated`` (written nowhere), are left out.
``AllocationFrontend`` comes with the serving-plane slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["ServeConfig", "Server", "Request"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 4
    prompt_len: int = 64               # fixed prefill shape (left-padded)


class Server:
    """Slot-based batched server over a single model replica on one
    device; ``params`` must already lie on it."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.serve = serve
        self.params = params
        self.device = resolve_device(device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    def _prefill_batch(self, prompts: np.ndarray):
        """prompts: (B, prompt_len) -> (next_token_logits, cache)."""
        return self._prefill(self.params, {
            "tokens": torch.from_numpy(prompts).to(self.device)})

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Serve a closed set of requests to completion. Returns
        {request_id: generated token ids}."""
        sc = self.serve
        queue = list(requests)
        out: Dict[int, List[int]] = {}

        while queue:
            batch = queue[:sc.batch_size]
            queue = queue[sc.batch_size:]
            prompts = np.zeros((sc.batch_size, sc.prompt_len), np.int32)
            for i, r in enumerate(batch):
                p = r.prompt[-sc.prompt_len:]
                prompts[i, -len(p):] = p      # left-pad

            logits, cache = self._prefill_batch(prompts)
            cur = torch.argmax(logits, -1).to(torch.int32)
            steps = [cur]
            for _ in range(max(max(r.max_new_tokens for r in batch) - 1, 0)):
                logits, cache = self._decode(
                    self.params, {"tokens": cur[:, None], "cache": cache})
                cur = torch.argmax(logits, -1).to(torch.int32)
                steps.append(cur)
            gen = torch.stack(steps, dim=1).cpu().numpy()

            for i, r in enumerate(batch):
                out[r.request_id] = [int(t) for t in gen[i, :r.max_new_tokens]]
        return out
