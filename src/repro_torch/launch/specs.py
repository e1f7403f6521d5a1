"""Meta-tensor stand-ins for every (arch × shape) cell of the dry run: the
port's counterpart of the reference's src/repro/launch/specs.py, whose
ShapeDtypeStructs these are. A meta tensor has a shape and a dtype and no
storage, so a full-width step traces without memory.

Over several ranks the tensors are one rank's: the parameters cut by
`LM.param_cuts` (attention by whole heads, the FFN, expert widths and
vocabulary over `model`, expert slots over `data`) and the caches at the
rank's KV heads (`stack.head_layout`). A prefill or decode batch is whole
on every rank, as the port serves it: its Server holds every slot on
every rank, and an MoE layer splits its rows over `data` itself
(`stack.ffn_sublayer`). A train batch is the global one too, and the
train step runs on the rank's rows of it (`LM.batch_rows`, the
reference's `batch_part`: `ref_batch_part` says where it splits), so a
train cell prices a rank that holds its share."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed.ctx import RankCtx
from repro_torch.models import stack as stack_mod
from repro_torch.models.lm import LM


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    return True, ""


def ref_batch_part(ctx: RankCtx, B: int):
    """The axis the reference's `MeshCtx.batch_part` splits a batch of B
    over on this layout ("data" where B divides over ep > 1), or None."""
    return "data" if ctx.ep > 1 and B % ctx.ep == 0 else None


def param_specs(lm: LM) -> dict:
    """The rank's parameter tree as meta tensors: `LM.shapes()`, each leaf
    of `LM.param_defs` at its `LM.param_cuts` length on every cut dim."""
    return lm.shapes()


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: RankCtx) -> dict:
    """The rank's meta batch of a train or prefill cell: "tokens" [B, S]
    int32, or for audio "frames" [B, S, frontend_dim], or for a vlm
    "tokens" [B, S - P] and "patches" [B, P, frontend_dim] (bfloat16, as
    the reference's), and for train "labels" [B, S] int32."""
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = meta((B, S, cfg.frontend_dim), "bfloat16")
    elif cfg.family == "vlm":
        P = cfg.num_patches
        batch["tokens"] = meta((B, S - P), torch.int32)
        batch["patches"] = meta((B, P, cfg.frontend_dim), "bfloat16")
    else:
        batch["tokens"] = meta((B, S), torch.int32)
    if shape.kind == "train":
        batch["labels"] = meta((B, S), torch.int32)
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: RankCtx,
                 lm: LM) -> tuple:
    """(token [B, 1], positions [B, 1], cache): int32 meta tokens and write
    positions, and the slot-dense cache (`stack.alloc_cache`, on lm's
    device: meta in a dry run) at the rank's heads, holding seq_len - 1
    tokens; the step writes token seq_len - 1 and attends over the full
    window."""
    B, S = shape.global_batch, shape.seq_len
    cache = stack_mod.alloc_cache(cfg, lm.plan, B, S, device=lm.device,
                                  tp=ctx.tp)
    cache["pos"] = S - 1
    return meta((B, 1), torch.int32), meta((B, 1), torch.int32), cache
