"""Device-side batched sampling: one fused temperature/top-k/top-p draw for
a whole decode batch (or a batch of finished prefills), with no host sync.

Greedy rows (temperature <= 0) return `argmax(logits)` exactly. When the
caller knows every row is greedy (`all_greedy`, a host-side fact the engines
keep), the sort/softmax/draw machinery is skipped entirely.

Sampled rows filter like the reference (src/repro/serving/sampling.py):
scale by 1/temperature, keep the top-k logits (boundary ties kept), keep
ranks whose exclusive cumulative probability is < top_p, then draw from the
kept set. The draw is a Gumbel-max over uniforms from a counter-based hash
of (base key, context length, vocab index), computed on the device: every
token is a pure function of (seed, position), so a stream does not depend
on batch composition, admission order or preemption. The bits differ from
JAX's threefry; matching them is separate later work.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow (the constant is split into 16-bit halves)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche finalizer (xorshift-multiply, 'lowbias32')."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_noise(keys: torch.Tensor, fold: torch.Tensor, V: int
                  ) -> torch.Tensor:
    """[n, V] float32 uniforms in (0, 1): a pure function of each row's base
    key (keys [n, 2], uint32 values in int64) and fold [n] (the context
    length), and of the vocab index."""
    k0 = keys[:, 0].long() & _M32
    k1 = keys[:, 1].long() & _M32
    row = _mix32(_mix32(k0 ^ 0x9E3779B9) ^ k1)
    row = _mix32(row ^ (fold.long() & _M32))
    col = _mix32(torch.arange(V, device=keys.device, dtype=torch.long)
                 + 0x632BE5AB)
    h = _mix32(row[:, None] ^ col[None, :])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


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
    u = uniform_noise(keys, fold, logits.shape[1])
    gumbel = -torch.log(-torch.log(u))
    sampled = (masked + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
