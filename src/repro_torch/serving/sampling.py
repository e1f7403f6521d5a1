"""Device-side batched sampling: one fused temperature/top-k/top-p draw for
a whole decode batch (or a batch of finished prefills), with no host sync.

Greedy rows (temperature <= 0) return `argmax(logits)` exactly. When the
caller knows every row is greedy (`all_greedy`, a host-side fact the engines
keep), the sort/softmax/draw machinery is skipped entirely.

Sampled rows filter like the reference (src/repro/serving/sampling.py):
scale by 1/temperature, keep the top-k logits (boundary ties kept), keep
ranks whose exclusive cumulative probability is < top_p, then draw as
`jax.vmap(jax.random.categorical)` does on the row keys
`jax.vmap(jax.random.fold_in)(keys, fold)`: the argmax of the masked
logits plus Gumbel noise from JAX's threefry bits (`prng.py`), computed on
the device. Every token is a pure function of (seed, context length), so a
stream does not depend on batch composition, admission order or
preemption, and it equals the reference's token for token wherever the top
two values of masked + noise lie further apart than `log`'s last-ulp
differences across backends.
"""
from __future__ import annotations

import torch

from repro_torch.serving.prng import fold_in, gumbel


def kept_mask(logits: torch.Tensor, temperature: torch.Tensor,
              top_k: torch.Tensor, top_p: torch.Tensor):
    """→ (scaled logits [n, V], keep mask [n, V]) of the top-k/top-p filter
    (top_k <= 0 and top_p >= 1 disable their filter)."""
    n, V = logits.shape
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranked = torch.gather(scaled, 1, order)
    k = torch.where(top_k > 0, top_k.clamp(1, V), torch.full_like(top_k, V))
    kth = torch.gather(ranked, 1, (k.long() - 1)[:, None])
    keep = scaled >= kth
    probs = torch.softmax(ranked, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    keep_ranked = excl < top_p[:, None]
    keep_p = torch.zeros_like(keep).scatter(1, order, keep_ranked)
    return scaled, keep & keep_p


def sample_tokens(logits, temperature, top_k, top_p, keys, fold, *,
                  all_greedy: bool):
    """logits [n, V]; temperature [n] f32; top_k [n] int (<= 0 disables);
    top_p [n] f32 (>= 1 disables); keys [n, 2] base keys; fold [n] context
    lengths at this sample point → token ids [n] int32, on the device.
    `all_greedy` (host-side: every row has temperature <= 0) short-circuits
    to the argmax."""
    greedy_tok = logits.float().argmax(dim=-1).to(torch.int32)
    if all_greedy:
        return greedy_tok
    scaled, keep = kept_mask(logits, temperature, top_k, top_p)
    masked = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    noise = gumbel(fold_in(keys, fold), logits.shape[1])
    sampled = (noise + masked).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
