"""The train step of the port: loss and gradients through autograd,
microbatch accumulation, optional int8 gradient compression, AdamW (the
reference's src/repro/training/trainer.py).

`LM.train_loss` runs `stack_apply(mode="train")`: plain differentiable
PyTorch, no CUDA kernel (none has a backward). Gradients come back in each
parameter's dtype; microbatches (cfg.grad_accum) accumulate them in
float32 and average the loss. The int8 path quantizes each gradient leaf
with a max-abs scale before accumulation (all-reduce bytes at scale)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.lm import LM
from repro_torch.training.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclass
class TrainState:
    params: Any
    opt: Any
    step: int = 0


def _split_micro(batch: dict, accum: int) -> list:
    """[B, ...] leaves → `accum` microbatches of B / accum rows, in order."""
    return [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def quantize_int8(g: torch.Tensor) -> torch.Tensor:
    """Per-leaf int8 round trip: scale = max(max|g|, 1e-9) / 127 in g's
    dtype, q = clip(round-half-even(g / scale), -127, 127) → q · scale,
    float32."""
    scale = torch.clamp(g.abs().max(), min=1e-9) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def loss_and_grads(lm: LM, params, batch: dict, tables=None) -> tuple:
    """→ (the loss, detached, and its gradients: a list in `tree_leaves`
    order, each in its parameter's dtype). The parameters are taken as
    leaves of the autograd graph through detached aliases, so the tensors
    of `params` never require grad. A parameter the loss does not read (an
    audio model's token embedding) gets a zero gradient, as under
    jax.grad."""
    req = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm.train_loss(tree_unflatten(params, req), batch,
                            tables=tables)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(req, grads)]


def make_train_step(lm: LM, *, lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_compress_int8: bool = False):
    """→ train_step(params, opt, batch, tables=None) → (params, opt,
    {"loss", "grad_norm"}: 0-d tensors). The step updates params and opt
    IN PLACE and returns them (the reference returns new trees; in place
    the card holds one copy of the state)."""
    cfg = lm.cfg

    def train_step(params, opt, batch, tables=None):
        accum = cfg.grad_accum
        if accum > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            lsum = 0.0
            for mb in _split_micro(batch, accum):
                loss, grads = loss_and_grads(lm, params, mb, tables)
                if grad_compress_int8:
                    grads = [quantize_int8(g) for g in grads]
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                del grads
                lsum = lsum + loss
            grads = [a.div_(accum) for a in acc]
            loss = lsum / accum
        else:
            loss, grads = loss_and_grads(lm, params, batch, tables)
            if grad_compress_int8:
                grads = [quantize_int8(g) for g in grads]
        params, opt, gnorm = adamw_update(
            tree_unflatten(params, grads), opt, params, lr=lr,
            weight_decay=weight_decay)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_state(lm: LM, seed: int = 0) -> TrainState:
    """Fresh parameters and AdamW moments. One rank only: the optimizer
    state's specs over several ranks (the reference's `opt_specs`) are
    ROADMAP A16b."""
    if lm.ctx.world > 1:
        raise NotImplementedError(
            f"optimizer state over {lm.ctx.world} ranks (opt_specs, ROADMAP "
            f"A16b)")
    params = lm.init(seed)
    return TrainState(params, adamw_init(params, lm.cfg.optimizer_dtype), 0)
