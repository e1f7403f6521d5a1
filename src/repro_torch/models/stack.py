"""Layer stack of the port: dense attention + SwiGLU layers over paged KV.

The JAX stack scans over a periodized layer sequence; here the layers run
in a plain loop over a flat per-layer list (parameters are unstacked by
`bridge.params_from_numpy`). `StackPlan` keeps the period form only to name
the layers in the reference's order.

Params:  {"layers": [layer dict, ...], "embed", "final_norm"[, "head"]}
Caches:  {"layers": [entry | None, ...], "pos": int}
A full-attention entry is {"k","v": [N, K, bs, h] arenas,
"kmin","kmax","kmean": [N, K, h] float32} — the shared arena, updated in
place. This slice serves full-attention layers only; `check_supported`
raises NotImplementedError for everything a later slice brings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import rms_norm, swiglu


@dataclass(frozen=True)
class StackPlan:
    period: tuple
    n_rep: int
    rem: tuple

    @staticmethod
    def from_config(cfg: ModelConfig, pattern: Optional[list] = None
                    ) -> "StackPlan":
        if pattern is None:
            pattern = cfg.default_compression_pattern()
        specs = cfg.layer_specs(pattern)
        period, n_rep, rem = cfg.periodize(specs)
        return StackPlan(tuple(period), n_rep, tuple(rem))

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_rep + len(self.rem)

    def all_specs(self) -> list:
        return list(self.period) * self.n_rep + list(self.rem)


def cache_window(cfg: ModelConfig, spec: LayerSpec) -> tuple:
    """(sink, recent) for this layer's KV cache; (0, 0) → full cache."""
    if spec.kind != "attn":
        return (0, 0)
    if spec.compressed:
        return (cfg.omniattn.sink_tokens, cfg.omniattn.recent_tokens)
    if spec.window > 0:
        return (0, spec.window)
    return (0, 0)


def full_attn_layer(cfg: ModelConfig, spec: LayerSpec) -> bool:
    """True for attention layers whose KV grows with context (no ring) —
    exactly the layers whose KV lives in the pool-backed arenas."""
    return spec.kind == "attn" and cache_window(cfg, spec) == (0, 0)


def check_supported(cfg: ModelConfig, plan: StackPlan) -> None:
    """Raise NotImplementedError for a configuration this slice of the port
    does not serve (rather than silently serving something else)."""
    oa = cfg.omniattn
    if cfg.moe.n_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.family not in ("dense",) or cfg.encoder_only or not cfg.causal \
            or cfg.frontend_dim:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense decoders only)")
    if oa.topk_blocks > 0 or oa.topk_frac > 0:
        raise NotImplementedError("OmniAttn online top-k block selection "
                                  "(omniattn.topk_*) is not ported yet")
    for spec in plan.all_specs():
        if spec.kind != "attn":
            raise NotImplementedError("SSM (mamba) layers are not ported yet")
        if not full_attn_layer(cfg, spec):
            raise NotImplementedError(
                "ring layers (sliding window or sink+recent compressed) are "
                "not ported yet: pass a pattern of zeros")


# ----------------------------------------------------------------------
# Caches: the shared full-attention arenas and the engine-private side
def alloc_arena_kv(cfg: ModelConfig, plan: StackPlan, n_arena_blocks: int,
                   block_size: int, device, dtype=None) -> list:
    """One entry per layer: {"k","v": [N, K, bs, h], "kmin","kmax","kmean":
    [N, K, h] float32} for full-attention layers (`n_arena_blocks` includes
    the null block 0), None elsewhere."""
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    K, h = cfg.n_kv_heads, cfg.head_dim

    def one(spec):
        if not full_attn_layer(cfg, spec):
            return None
        shp = (n_arena_blocks, K, block_size, h)
        sshp = (n_arena_blocks, K, h)
        z = dict(device=device)
        return {"k": torch.zeros(shp, dtype=dtype, **z),
                "v": torch.zeros(shp, dtype=dtype, **z),
                "kmin": torch.zeros(sshp, dtype=torch.float32, **z),
                "kmax": torch.zeros(sshp, dtype=torch.float32, **z),
                "kmean": torch.zeros(sshp, dtype=torch.float32, **z)}
    return [one(s) for s in plan.all_specs()]


def _private(cfg: ModelConfig, plan: StackPlan) -> dict:
    # full-attention layers keep nothing private (their KV is the arena);
    # check_supported guarantees no other layer kind reaches here
    return {"layers": [None for _ in plan.all_specs()], "pos": 0}


def alloc_prefill_private_cache(cfg: ModelConfig, plan: StackPlan,
                                max_len: int) -> dict:
    """B=1 task cache without full-attention layers (their KV lives in the
    shared arena): the position and, for later slices, ring KV / SSM
    state."""
    return _private(cfg, plan)


def alloc_paged_private_cache(cfg: ModelConfig, plan: StackPlan,
                              n_slots: int, max_len: int,
                              block_size: int) -> dict:
    """Decode-engine private side of the paged cache; full-attention entries
    are None (shared arena)."""
    return _private(cfg, plan)


def merge_arena_cache(cfg: ModelConfig, plan: StackPlan, private: dict,
                      arena_kv: list) -> dict:
    """(private ∪ arena) → the full cache the layer loop reads."""
    layers = [arena_kv[i] if full_attn_layer(cfg, s) else private["layers"][i]
              for i, s in enumerate(plan.all_specs())]
    return {"layers": layers, "pos": private["pos"]}


def split_arena_cache(cfg: ModelConfig, plan: StackPlan, cache: dict
                      ) -> tuple:
    """Inverse of merge_arena_cache → (private, arena_kv)."""
    specs = plan.all_specs()
    private = {"layers": [None if full_attn_layer(cfg, s) else
                          cache["layers"][i] for i, s in enumerate(specs)],
               "pos": cache["pos"]}
    arena = [cache["layers"][i] if full_attn_layer(cfg, s) else None
             for i, s in enumerate(specs)]
    return private, arena


# ----------------------------------------------------------------------
# Layer application
def attn_sublayer(cfg: ModelConfig, p: dict, x, *, mode: str, positions,
                  cache: dict, true_len: Optional[int] = None,
                  block_tables=None, pos0: int = 0):
    """Attention of one full-attention layer over the paged arenas, in
    place. mode "prefill": a B=1 chunk at absolute positions pos0 + arange(S)
    (the first `true_len` rows real) — attend history + chunk through the
    paged-prefill kernel, then write the chunk's K/V into its blocks.
    mode "decode": one token per slot at positions [B, 1] — write its K/V,
    then attend the resident blocks through the paged-decode kernel."""
    B, S, _ = x.shape
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = torch_dtype(cfg.compute_dtype)
    hid = rms_norm(x, p["ln_attn"], cfg.rms_eps).to(cd)
    q = hid @ p["wq"]
    k = hid @ p["wk"]
    v = hid @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, h)
    k = k.reshape(B, S, K, h)
    v = v.reshape(B, S, K, h)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = attn_mod.apply_rope(q, positions, cfg.rope_theta)
    k = attn_mod.apply_rope(k, positions, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    bs = kc.shape[2]
    nb = block_tables.shape[1]
    if mode == "prefill":
        cl = S if true_len is None else int(true_len)
        out = kops.attention_paged_prefill_op(q, k, v, kc, vc, block_tables,
                                              pos0, cl)
        attn_mod.paged_prefill_write(kc, vc, k, v, block_tables, pos0, cl)
        # the chunk touched the blocks its real positions map to (padded
        # rows alias the null block, whose re-summary is harmless)
        ar = torch.arange(S, device=x.device)
        ppos = pos0 + ar
        wblk = torch.where(
            ar < cl,
            block_tables[0].long()[torch.clamp(ppos // bs, 0, nb - 1)],
            torch.zeros_like(ar))
        attn_mod.update_block_summaries(cache["kmin"], cache["kmax"],
                                        cache["kmean"], kc, wblk)
    elif mode == "decode":
        t = positions[:, 0].to(torch.int32)
        bidx = torch.arange(B, device=x.device)
        # past the table's logical capacity the write goes to the null block
        blk = torch.where(
            t < nb * bs,
            block_tables[bidx, torch.clamp(t // bs, max=nb - 1).long()],
            torch.zeros_like(t))
        off = t % bs
        lens = torch.clamp(t + 1, max=nb * bs)
        attn_mod.paged_cache_write(kc, vc, k[:, 0], v[:, 0], blk, off)
        attn_mod.update_block_summaries(cache["kmin"], cache["kmax"],
                                        cache["kmean"], kc, blk)
        out = kops.attention_paged_decode_op(q[:, 0], kc, vc, block_tables,
                                             lens)
    else:
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    y = out.reshape(B, S, H * h)
    return x + (y @ p["wo"]).to(x.dtype)


def ffn_sublayer(cfg: ModelConfig, p: dict, x):
    """Dense SwiGLU feed-forward with its pre-norm and residual."""
    if cfg.d_ff == 0:
        return x
    cd = torch_dtype(cfg.compute_dtype)
    hid = rms_norm(x, p["ln_mlp"], cfg.rms_eps).to(cd)
    return x + swiglu(hid, p["w1"], p["w3"], p["w2"]).to(x.dtype)


def stack_apply(cfg: ModelConfig, plan: StackPlan, layers: list, x, *,
                mode: str, positions, caches: dict, block_tables,
                true_len: Optional[int] = None, pos0: int = 0):
    """Run every layer in order; arena caches are updated in place."""
    for spec, p, c in zip(plan.all_specs(), layers, caches["layers"]):
        x = attn_sublayer(cfg, p, x, mode=mode, positions=positions,
                          cache=c, true_len=true_len,
                          block_tables=block_tables, pos0=pos0)
        x = ffn_sublayer(cfg, p, x)
    return x
