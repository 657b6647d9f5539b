"""granite-4.0-h's forward pass (HF ``GraniteMoeHybridForCausalLM``) in
plain PyTorch, float32, with TF32 off: the oracle of the LM cell and of
the port's CPU tests.

One unpadded sequence at a time, no kernels, no cache, no batching. Per
layer of ``layer_types``, with m the residual multiplier::

    h = x + m * mixer(rmsnorm(x, ln1))
    x = h + m * (moe(rmsnorm(h, ln2)) + shared(rmsnorm(h, ln2)))

the mixer being Mamba-2 or NoPE GQA attention. Embeddings are multiplied
by ``embedding_multiplier`` on the way in; ``final_norm``, the tied head
and a division by ``logits_scaling`` on the way out.

* Attention: q, k, v projections, no position embedding, scores q.k times
  ``attention_scale``, causal softmax, GQA (query head h reads kv head
  h // (Hq / Hkv)), the output projection.
* Mamba-2 (one group): ``in_proj`` -> (z, xBC, dt); xBC through the causal
  depthwise conv of width W with its bias, then SiLU -> (x, B, C);
  dt = softplus(dt + dt_bias), A = -exp(A_log); the scan in its quadratic
  (dual) form, y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
  with cs the cumulative sum of dt A (taken in float64); y + D x; then
  rmsnorm(y * silu(z)) times its weight; ``out_proj``.
* MoE: router logits x @ router, the top K, a softmax over those K; each
  expert's SwiGLU (``expert_wi`` (E, D, 2F): gate columns, then up) computed
  densely on the tokens routed to it and added with its gate; plus the
  shared SwiGLU expert on every token.

Departures from HF's equations (none changes a value but by rounding):

* ties among router logits go to the lower expert index (a stable sort);
  HF's ``torch.topk`` leaves their order unspecified;
* the gates stay float32 (HF casts them to the hidden type first);
* every intermediate is float32 (HF's hidden states are bf16); the scan's
  cumulative sum is float64, and the scan is the dual form, not HF's
  chunked one;
* HF clamps dt to ``time_step_limit``, (0, inf) in this config: no-op.

Weights are the program's tensors, by the names of its parameter tree
(``Weights``): the embedding (V, D) and ``final_norm``, and per layer the
norms, router (D, E), ``expert_wi``, ``expert_wo`` (E, F, D), ``shared_wi``
(D, 2Fs),
``shared_wo``; a Mamba-2 layer's ``in_proj`` (D, di + di + 2N + H),
``conv_w`` (W, di + 2N), ``conv_b``, ``A_log``, ``dt_bias``, ``D``,
``norm_w``, ``out_proj``; an attention layer's ``wq``, ``wk``, ``wv``,
``wo``. Every weight is (in, out): a product is ``x @ w``.

On the card the model may not fit twice in float32: ``forward_many`` runs
several sequences through one layer at a time, asking ``layer(i)`` for
that layer's weights (upcast to float32 when asked, dropped after).

``control`` computes every weight product with both operands rounded to
float8 e4m3 (each scaled so its largest magnitude is e4m3's largest):
the next precision below the bf16 the configuration states, which the
cell's ``logit_gap_mean`` must refuse.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

__all__ = ["Weights", "tree_weights", "forward", "forward_many",
           "position_gaps", "logit_gap", "fp8_matmul", "dims"]

E4M3_MAX = 448.0
HEAD_BLOCK = 16        # heads whose (S, S) scan weights are formed at once


class Weights:
    """``embed`` (V, D), ``final_norm`` (D,) and ``layer(i)``, the float32
    weights of layer i by name, with ``"kind"`` its ``layer_types``
    entry."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 layer: Callable[[int], Dict[str, torch.Tensor]]):
        self.embed = embed
        self.final_norm = final_norm
        self.layer = layer


def tree_weights(params: Dict, layer_types: Sequence[str],
                 device=None) -> Weights:
    """``Weights`` over the program's parameter tree: ``embed``,
    ``final_norm``, ``blocks`` (every layer's norms and MoE, stacked),
    ``mamba`` and ``attn`` (the mixers of each kind, stacked in layer
    order). A layer's weights are upcast to float32 (on ``device``, else
    where they lie) when asked for."""
    index, counts = [], {"mamba": 0, "attention": 0}
    for kind in layer_types:
        index.append(counts[kind])
        counts[kind] += 1

    def layer(i):
        kind = layer_types[i]
        mixer = params["mamba" if kind == "mamba" else "attn"]
        p = {k: v[i] for k, v in params["blocks"].items()}
        p.update({k: v[index[i]] for k, v in mixer.items()})
        p = {k: v.to(device=device, dtype=torch.float32)
             for k, v in p.items()}
        p["kind"] = kind
        return p

    return Weights(params["embed"], params["final_norm"], layer)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands rounded to float8 e4m3 under a scale each
    (their largest magnitude to e4m3's largest), accumulated in float32."""
    def q(t):
        s = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return q(x) @ q(w)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _swiglu(x, wi, wo, mm):
    g, u = mm(x, wi).chunk(2, dim=-1)
    return mm(F.silu(g) * u, wo)


def _attention(x, p, cfg, mm):
    S = x.shape[0]
    hd, nq, nkv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
    q = mm(x, p["wq"]).view(S, nq, hd).transpose(0, 1)
    k = mm(x, p["wk"]).view(S, nkv, hd).transpose(0, 1)
    v = mm(x, p["wv"]).view(S, nkv, hd).transpose(0, 1)
    k = k.repeat_interleave(nq // nkv, dim=0)
    v = v.repeat_interleave(nq // nkv, dim=0)
    s = (q @ k.transpose(1, 2)) * cfg["attention_scale"]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v                         # (Hq, S, hd)
    return mm(o.transpose(0, 1).reshape(S, nq * hd), p["wo"])


def _scan(x, dt, A, Bm, Cm):
    """y (S, H, P) of the SSD in its quadratic form, heads in blocks."""
    S, H, _ = x.shape
    cs = torch.cumsum(dt.double() * A.double(), dim=0)       # (S, H)
    cb = Cm @ Bm.T                                           # (S, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    for h0 in range(0, H, HEAD_BLOCK):
        c = cs[:, h0:h0 + HEAD_BLOCK].T                     # (h, S)
        d = (c[:, :, None] - c[:, None, :]).masked_fill(~causal, float("-inf"))
        w = torch.exp(d).float() * cb * dt[:, h0:h0 + HEAD_BLOCK].T[:, None]
        y[:, h0:h0 + HEAD_BLOCK] = torch.einsum(
            "hij,jhp->ihp", w, x[:, h0:h0 + HEAD_BLOCK])
    return y


def _mamba(x, p, cfg, mm):
    S = x.shape[0]
    d = cfg["d_model"]
    di, n, H, P = (cfg["ssm_expand"] * d, cfg["ssm_state"], cfg["ssm_heads"],
                   cfg["ssm_head_dim"])
    z, xbc, dt = mm(x, p["in_proj"]).split([di, di + 2 * n, H], dim=-1)
    W = p["conv_w"].shape[0]
    up = torch.cat([xbc.new_zeros(W - 1, xbc.shape[1]), xbc])
    conv = p["conv_b"] + sum(p["conv_w"][k] * up[k:k + S] for k in range(W))
    xs, Bm, Cm = F.silu(conv).split([di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.view(S, H, P)
    y = _scan(xh, dt, A, Bm, Cm) + xh * p["D"][:, None]
    y = _rms(y.reshape(S, di) * F.silu(z), p["norm_w"], cfg["norm_eps"])
    return mm(y, p["out_proj"])


def _moe(x, p, cfg, mm):
    K = cfg["experts_per_token"]
    logits = mm(x, p["router"])
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :K], dim=-1)
    idx = idx[:, :K]
    out = torch.zeros_like(x)
    for e in range(p["expert_wi"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            y = _swiglu(x[tok], p["expert_wi"][e], p["expert_wo"][e], mm)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out + _swiglu(x, p["shared_wi"], p["shared_wo"], mm)


def _layer(x, p, cfg, mm):
    m, eps = cfg["residual_multiplier"], cfg["norm_eps"]
    mixer = _mamba if p["kind"] == "mamba" else _attention
    x = x + m * mixer(_rms(x, p["ln1"], eps), p, cfg, mm)
    return x + m * _moe(_rms(x, p["ln2"], eps), p, cfg, mm)


def forward_many(seqs: Sequence[torch.Tensor], weights: Weights, cfg: Dict,
                 keep_last: Sequence[int], control: bool = False
                 ) -> List[torch.Tensor]:
    """Float32 logits (keep_last[s], V) of the last ``keep_last[s]``
    positions of each token sequence (S_s,), computed layer by layer over
    all sequences. ``cfg`` holds the widths by the port's names
    (``d_model``, ``head_dim``, ``num_heads``, ``num_kv_heads``,
    ``ssm_expand``, ``ssm_state``, ``ssm_heads``, ``ssm_head_dim``,
    ``experts_per_token``, ``attention_scale``, ``embedding_multiplier``,
    ``residual_multiplier``, ``logits_scaling``, ``norm_eps``,
    ``num_layers``)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = fp8_matmul if control else torch.matmul
    try:
        with torch.no_grad():
            emb = weights.embed.float()
            xs = [emb[s.long()] * cfg["embedding_multiplier"] for s in seqs]
            for i in range(cfg["num_layers"]):
                p = weights.layer(i)
                xs = [_layer(x, p, cfg, mm) for x in xs]
                del p
            out = []
            for x, n in zip(xs, keep_last):
                h = _rms(x[-n:], weights.final_norm.float(), cfg["norm_eps"])
                out.append(mm(h, emb.T) / cfg["logits_scaling"])
            return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def forward(tokens: torch.Tensor, weights: Weights, cfg: Dict,
            control: bool = False) -> torch.Tensor:
    """Float32 logits (S, V) of one token sequence (S,)."""
    return forward_many([tokens], weights, cfg, [len(tokens)], control)[0]


def position_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(n,) float32: at each of n positions, the root mean square of got -
    want over the vocabulary over the spread (standard deviation over the
    vocabulary) of ``want`` there, a relative error of the position's
    logits. (The widest single |got - want| of 100k logits is an extreme
    of the same errors, and spreads more from run to run.)"""
    want = want.float()
    diff = (got.float().to(want.device) - want).square().mean(dim=-1).sqrt()
    return diff / want.std(dim=-1).clamp(min=1e-30)


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest of ``position_gaps`` (0 over no position)."""
    return float(position_gaps(got, want).max()) if len(want) else 0.0


def dims(cfg) -> Dict:
    """The widths ``forward_many`` reads, from a dict of the port's
    ``ModelConfig`` fields (e.g. ``dataclasses.asdict``)."""
    d = cfg["d_model"]
    return {"d_model": d, "head_dim": cfg["head_dim"] or d // cfg["num_heads"],
            "num_heads": cfg["num_heads"],
            "num_kv_heads": cfg["num_kv_heads"],
            "ssm_expand": cfg["ssm_expand"], "ssm_state": cfg["ssm_state"],
            "ssm_heads": cfg["ssm_expand"] * d // cfg["ssm_head_dim"],
            "ssm_head_dim": cfg["ssm_head_dim"],
            "experts_per_token": cfg["experts_per_token"],
            "attention_scale": cfg["attention_scale"] or 1.0 / math.sqrt(
                cfg["head_dim"] or d // cfg["num_heads"]),
            "embedding_multiplier": cfg["embedding_multiplier"],
            "residual_multiplier": cfg["residual_multiplier"],
            "logits_scaling": cfg["logits_scaling"],
            "norm_eps": cfg["norm_eps"], "num_layers": cfg["num_layers"]}
