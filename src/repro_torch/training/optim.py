"""AdamW of the port, the reference's formulas term for term
(src/repro/training/optim.py): b1 0.9, b2 0.95, a global-norm clip that
reports the pre-clip norm, bias correction from the step counter, weight
decay inside the update on every leaf, float32 arithmetic cast back to
each leaf's dtype. Not `torch.optim.AdamW`, whose order of operations
differs. The moments have `optimizer_dtype` (bfloat16 for the largest
architectures)."""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params, dtype="float32") -> dict:
    """{"m", "v": zeros of `dtype` in the structure of params, "step": 0-d
    int32}, on the parameters' device ("meta" parameters give meta
    moments: a restore template)."""
    dt = torch_dtype(dtype)
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, opt, params, *, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
    """One AdamW step, IN PLACE: the new values are written into the
    tensors of `params` and `opt` (the reference returns new trees; in place
    the card holds one copy of the state at full width). → (params, opt,
    the pre-clip global gradient norm, or 0 without a clip)."""
    step = opt["step"] + 1
    flat_g = tree_leaves(grads)
    if grad_clip:
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in flat_g))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        gnorm = torch.zeros((), device=step.device)
        scale = 1.0
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for g, m, v, p in zip(flat_g, tree_leaves(opt["m"]),
                          tree_leaves(opt["v"]), tree_leaves(params)):
        g32 = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        mh = m32 / bc1
        vh = v32 / bc2
        p32 = p.float()
        p.copy_(p32 - lr * (mh / (vh.sqrt() + eps) + weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)
    opt["step"].copy_(step)
    return params, opt, gnorm
