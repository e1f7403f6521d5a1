"""Shared model primitives: norms, the gated FFN, rope, the training
loss."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rms_norm_over_model(x: torch.Tensor, scale: torch.Tensor, eps: float,
                        ctx, width: int) -> torch.Tensor:
    """`rms_norm` over a last dim that `ctx`'s `model` axis splits: x and
    scale hold this rank's columns, the sum of squares is summed over
    `model` and divided by the whole `width` (a rank-local RMS would
    normalise each rank's columns alone)."""
    x32 = x.float()
    ss = ctx.psum_model(x32.square().sum(dim=-1, keepdim=True))
    out = x32 * torch.rsqrt(ss / width + eps)
    return (out * scale.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x [B, S, ..., h]; positions: scalar, [S] or [B, S] absolute. Rotation
    in float32 over the two halves of the head dim (x1 = x[..., :h/2])."""
    h = x.shape[-1]
    freqs = rope_freqs(h, theta, device=x.device)             # [h/2]
    pos = torch.as_tensor(positions, device=x.device)
    if pos.ndim == 0:
        pos = pos[None]                                       # [1]
    ang = pos.float()[..., None] * freqs                      # [S|B,S, h/2]
    if ang.ndim == 2:
        ang = ang[None]                                       # [1, S, h/2]
    for _ in range(x.ndim - 3):                               # head dims
        ang = ang.unsqueeze(2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean token cross-entropy through a float32 logsumexp. logits
    [..., V]; labels [...] int; mask [...] (optional) weights the tokens,
    over a denominator of max(sum(mask), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
