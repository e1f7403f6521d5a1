"""The train step of the port: loss and gradients through autograd,
microbatch accumulation, optional int8 gradient compression, AdamW (the
reference's src/repro/training/trainer.py).

`LM.train_loss` runs `stack_apply(mode="train")`: plain differentiable
PyTorch, no CUDA kernel (none has a backward). Gradients come back in each
parameter's dtype; microbatches (cfg.grad_accum) accumulate them in
float32 and average the loss. The int8 path quantizes each gradient leaf
with a max-abs scale before accumulation (all-reduce bytes at scale).

Over `tp × ep` ranks (an `LM` built with a `RankCtx`) each rank holds its
part of the parameters and moments (`init_state`, or
`DevicePlacement.place_params`) and takes the global batch: each
microbatch of it (the reference's) is cut to the rank's rows over `data`
by `LM.train_loss`. Autograd gives each rank its share of every gradient
(distributed/ctx.py's convention); `reduce_grads` completes it where XLA
inserts the reductions for the reference — a sum over `data` for every
leaf replicated over it (not the expert slots, and not an FSDP slice,
whose gather's backward reduce-scattered it already), and over `model`
within the ranks that hold the same part of a leaf a sharded region reads
(`LM.grad_sync`). The int8 scale is the whole leaf's (a max over the
ranks that shard it), the clip norm the global one (`adamw_update`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.lm import LM
from repro_torch.training.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class TrainState:
    params: Any
    opt: Any
    step: int = 0


def _split_micro(batch: dict, accum: int) -> list:
    """[B, ...] leaves → `accum` microbatches of B / accum rows, in order."""
    return [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def quantize_int8(g: torch.Tensor, amax=None) -> torch.Tensor:
    """Per-leaf int8 round trip: scale = max(max|g|, 1e-9) / 127 in g's
    dtype, q = clip(round-half-even(g / scale), -127, 127) → q · scale,
    float32. `amax` (a 0-d tensor) replaces max|g|: the whole leaf's over
    ranks."""
    m = g.abs().max() if amax is None else amax.to(g.dtype)
    scale = torch.clamp(m, min=1e-9) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _sync_leaves(lm: LM, params) -> list:
    """`lm.grad_sync` in the `tree_leaves` order of `params`."""
    return tree_leaves(tree_map(lambda _p, s: s, params, lm.grad_sync))


def _reduce_flat(grads: list, idx: list, reduce, pad=None) -> None:
    """Reduce grads[i] for i in idx through one call of `reduce` per
    dtype on their flattened concatenation, written back in place. With
    `pad` (i → (groups, group)) each leaf travels in a zeroed [groups,
    n] block at row `group`: the sum over every rank is then, row by row,
    the sum over the ranks of one group."""
    by_dtype: dict = {}
    for i in idx:
        by_dtype.setdefault(grads[i].dtype, []).append(i)
    for ids in by_dtype.values():
        parts = []
        for i in ids:
            g = grads[i].reshape(-1)
            if pad is not None:
                n, k = pad[i]
                g = torch.zeros((n, g.numel()), dtype=g.dtype,
                                device=g.device).index_copy_(
                    0, torch.tensor([k], device=g.device), g[None])
            parts.append(g.reshape(-1))
        flat = reduce(torch.cat(parts))
        off = 0
        for i in ids:
            n = grads[i].numel() * (pad[i][0] if pad is not None else 1)
            seg = flat[off:off + n]
            if pad is not None:
                seg = seg.view(pad[i][0], -1)[pad[i][1]]
            grads[i].copy_(seg.view_as(grads[i]))
            off += n


@torch.no_grad()
def reduce_grads(lm: LM, params, grads: list) -> list:
    """This rank's share of each gradient (a list in `tree_leaves(params)`
    order) → its part of the global gradient, in place: a sum over
    `model` within each group of ranks holding the same part of a leaf a
    sharded region reads (one padded psum), then over `data` for every
    leaf replicated over it (one psum). The identity on one rank."""
    ctx = lm.ctx
    if ctx.world == 1:
        return grads
    sync = _sync_leaves(lm, params)
    grads = [g.contiguous() for g in grads]
    model = [i for i, s in enumerate(sync) if s.groups]
    if model:
        _reduce_flat(grads, model, ctx.psum_model,
                     {i: (sync[i].groups, sync[i].group) for i in model})
    data = [i for i, s in enumerate(sync) if s.over_data]
    if data:
        _reduce_flat(grads, data, ctx.psum_batch)
    return grads


def _local_grads(lm: LM, params, batch: dict, tables=None) -> tuple:
    """→ (the loss, detached, and this rank's share of its gradients: a
    list in `tree_leaves` order, each in its parameter's dtype). The
    parameters are taken as leaves of the autograd graph through detached
    aliases, so the tensors of `params` never require grad. A parameter
    the loss does not read (an audio model's token embedding) gets a zero
    gradient, as under jax.grad."""
    req = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm.train_loss(tree_unflatten(params, req), batch,
                            tables=tables)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(req, grads)]


def loss_and_grads(lm: LM, params, batch: dict, tables=None) -> tuple:
    """→ (the loss, detached, and its gradients: a list in `tree_leaves`
    order, each in its parameter's dtype — over ranks this rank's part of
    the global gradient, `reduce_grads`). `batch` is the global batch."""
    loss, grads = _local_grads(lm, params, batch, tables)
    return loss, reduce_grads(lm, params, grads)


@torch.no_grad()
def quantize_grads(lm: LM, grads: list) -> list:
    """`quantize_int8` on every leaf with the whole leaf's scale: over
    ranks each leaf's max|g| is max-reduced over `model` and `data` (one
    reduction each for all leaves; a leaf several ranks hold alike has
    the same max on each)."""
    if lm.ctx.world == 1:
        return [quantize_int8(g) for g in grads]
    amax = torch.stack([g.abs().max().float() for g in grads])
    amax = lm.ctx.pmax_batch(lm.ctx.pmax_model(amax))
    return [quantize_int8(g, a) for g, a in zip(grads, amax)]


def make_train_step(lm: LM, *, lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_compress_int8: bool = False):
    """→ train_step(params, opt, batch, tables=None) → (params, opt,
    {"loss", "grad_norm"}: 0-d tensors). The step updates params and opt
    IN PLACE and returns them (the reference returns new trees; in place
    the card holds one copy of the state). `batch` is the global batch,
    on every rank. Without int8 the microbatches' shares accumulate and
    are reduced once; with it each microbatch's gradient is reduced and
    then quantized, as the reference quantizes the global gradient."""
    cfg = lm.cfg

    def train_step(params, opt, batch, tables=None):
        accum = cfg.grad_accum
        if accum > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            lsum = 0.0
            for mb in _split_micro(batch, accum):
                if grad_compress_int8:
                    loss, grads = loss_and_grads(lm, params, mb, tables)
                    grads = quantize_grads(lm, grads)
                else:
                    loss, grads = _local_grads(lm, params, mb, tables)
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                del grads
                lsum = lsum + loss
            if not grad_compress_int8:
                acc = reduce_grads(lm, params, acc)
            grads = [a.div_(accum) for a in acc]
            loss = lsum / accum
        else:
            loss, grads = loss_and_grads(lm, params, batch, tables)
            if grad_compress_int8:
                grads = quantize_grads(lm, grads)
        owners = None
        if lm.ctx.world > 1:
            owners = [s.owner for s in _sync_leaves(lm, params)]
        params, opt, gnorm = adamw_update(
            tree_unflatten(params, grads), opt, params, lr=lr,
            weight_decay=weight_decay, ctx=lm.ctx, owners=owners)
        return params, opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_state(lm: LM, seed: int = 0) -> TrainState:
    """Fresh parameters and AdamW moments. Over ranks the seed's one-rank
    model (`one_rank().init(seed)`, on this LM's device) is carried into
    this rank's part by `DevicePlacement.place_params` (one seed is one
    model whatever the layout) and the moments are the rank's (zeros of
    its parts' shapes: the reference's `opt_specs`)."""
    params = lm.one_rank().init(seed)
    if lm.ctx.world > 1:
        from repro_torch.serving.placement import DevicePlacement
        params = DevicePlacement(lm.device, False, lm.ctx).place_params(
            params, lm)
    return TrainState(params, adamw_init(params, lm.cfg.optimizer_dtype), 0)
