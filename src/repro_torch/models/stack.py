"""Layer stack of the port: attention + SwiGLU layers over paged or dense KV.

The JAX stack scans over a periodized layer sequence; here the layers run
in a plain loop over a flat per-layer list (parameters are unstacked by
`bridge.params_from_numpy`). `StackPlan` keeps the period form only to name
the layers in the reference's order.

Params:  {"layers": [layer dict, ...], "embed", "final_norm"[, "head"][,
          "frontend"]}
Caches:  {"layers": [entry | None, ...], "pos": int}
Attention layers are full (KV grows with the context) or ring layers
(OmniAttn sink+recent compression, or a sliding window: a fixed capacity
W). Entries, all updated in place:
  paged full layer   {"k","v": [N, K, bs, h] shared arenas,
                      "kmin","kmax","kmean": [N, K, h] float32}; with
                      QuantPlane "k","v" are int8 and the entry carries
                      the scale plane "kscale","vscale": [N, K, h] and
                      "ktok","vtok": [N, K, bs] float32
  paged ring layer   {"k","v": [n_slots·bpw, K, bs, h]}: slot b owns the
                      contiguous block run [b·bpw, (b+1)·bpw)
  dense layer        {"k","v": [B, W, K, h]}, W = sink+recent or max_len
Paged decode of full layers runs OmniAttn online top-k block selection when
cfg.omniattn sets a budget (`topk_block_budget`); mode "verify" is the
read-only speculative-verify forward, and `stack_verify_commit` lands its
accepted prefix. Quant is structural: an entry with "kscale" is int8, its
reads dequantize in the kernels' tiles and its writes quantize
(models/attention.py's QuantPlane section); ring layers never quantize.
Mamba-2 layers (`LayerSpec.kind == "mamba"`, the SSM and hybrid families)
carry a per-slot recurrent entry instead of KV, never in the arenas:
  mamba layer        {"state": [B, nh, head_dim, d_state] float32,
                      "conv_x": [B, cw-1, d_in], "conv_bc": [B, cw-1,
                      2·d_state]} (B = slots, or 1 for a prefill task)
Each layer's FFN is a dense SwiGLU or, on an MoE layer, the routed experts
over OmniPlacement slot tables (models/moe.py) plus the shared SwiGLU; a
stack without an FFN (d_ff 0, no MoE: mamba2) skips it.
`check_supported` raises NotImplementedError for what a later slice brings
(encoder, frontend and non-causal families).
Over `tp × ep` ranks (a `RankCtx`) `head_layout` decides each rank's
attention heads, for every config at any tp: K / tp KV heads under 'kv';
under 'wseq' (K % tp != 0, tp % K == 0) the rank's H / tp query heads and
the one KV head they read, whole; otherwise the sublayer replicated
(every head on every rank, no psum). Every cache above holds the rank's
KV heads — full arenas, paged ring runs, slot-dense rings, sliding
windows, prefill caches — and attention runs unchanged on them; online
top-k max-reduces its block scores over `model` before ranking
(`_select_blocks`). `mamba_layout` cuts a Mamba-2 mixer by its SSD heads
and their d_in channels (replicated where the heads do not divide): the
state and `conv_x` rows hold the rank's share, `conv_bc` stays whole,
`ssm_norm` reduces its sum of squares over `model`.
Under cfg.fsdp a rank over ep > 1 `data` ranks holds 1 / ep of each
leaf's otherwise replicated d_model dim (`FSDP_DIMS`, the reference's
`_fs`); `apply_layer` gathers the layer's cut leaves whole at its entry
(`gather_fsdp`, inside the layer's activation checkpoint: under remat the
backward gathers again instead of keeping whole weights), and the
gather's backward reduce-scatters their gradients (`RankCtx.gather_params`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed.ctx import RankCtx
from repro_torch.kernels import ops as kops
from repro_torch.kernels.block_topk import block_topk_select_scores
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import rms_norm, rms_norm_over_model, swiglu


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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# the dim of each leaf the reference's FSDP axis shards over `data` under
# cfg.fsdp (`_fs`, src/repro/models/stack.py:66-137, lm.py:34-41): its
# otherwise replicated big dim, d_model for every one of them
FSDP_DIMS = {"wq": 0, "wk": 0, "wv": 0, "wo": 1,
             "w_z": 0, "w_x": 0, "w_bc": 0, "w_dt": 0, "out_proj": 1,
             "w1": 0, "w3": 0, "w2": 1,
             "shared_w1": 0, "shared_w3": 0, "shared_w2": 1,
             "embed": 1, "head": 0}


def gather_fsdp(cfg: ModelConfig, p: dict, ctx: Optional[RankCtx],
                names=None) -> dict:
    """p with its FSDP leaves (of `names`, default all of FSDP_DIMS)
    gathered whole (`RankCtx.gather_params`, in FSDP_DIMS order on every
    rank) where their spec cuts them over `data`: cfg.fsdp on ep > 1
    ranks over which d_model divides (`lm.leaf_spec` sanitized by
    `RankCtx.part_if`, as `LM.param_specs` does). Elsewhere p as it is;
    under cfg.fsdp a leaf shorter than d_model there has lost its `data`
    group, and raises."""
    if not cfg.fsdp:
        return p
    names = FSDP_DIMS if names is None else names
    if ctx is None or ctx.ep == 1 or ctx.part_if("data", cfg.d_model) \
            is None:
        for k in names:
            v = p.get(k)
            if v is not None and v.shape[FSDP_DIMS[k]] != cfg.d_model:
                raise ValueError(f"{k} {tuple(v.shape)} is cut over data "
                                 f"but has no data group to gather it")
        return p
    out = dict(p)
    for k in names:
        if k in p:
            out[k] = ctx.gather_params(p[k], FSDP_DIMS[k])
    return out


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a family the port does not model
    (rather than silently running something else). Encoder-only and
    bidirectional stacks and the frontend families (vlm patches, audio
    frames) are modelled; serving them is refused by the `Server`
    (`serving.server.check_servable`)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port models "
            f"{FAMILIES}")


def topk_block_budget(oa, nb: int) -> Optional[int]:
    """Top-k block budget against a width-`nb` block table, or None when
    online sparsity is off (both budget knobs 0). Absolute `topk_blocks`
    wins over `topk_frac` (which resolves per slot against the resident
    block count — this figure is its ceiling, ceil(frac·nb)). Floored at the
    forced keeps and capped at nb; a budget == nb means the (bucketed) table
    already fits and selection is skipped: exact attention."""
    if oa.topk_blocks <= 0 and oa.topk_frac <= 0:
        return None
    k = oa.topk_blocks if oa.topk_blocks > 0 else \
        int(math.ceil(oa.topk_frac * nb))
    k = max(k, max(oa.topk_sink_blocks, 0) + max(oa.topk_recent_blocks, 1), 1)
    return min(k, nb)


def ring_block_count(sink: int, recent: int, block_size: int) -> int:
    """Blocks backing one slot's sink+recent ring (ceil, last may be
    partial)."""
    return -(-(sink + recent) // block_size)


# ----------------------------------------------------------------------
# Caches: the shared full-attention arenas and the engine-private side
@dataclass(frozen=True)
class HeadLayout:
    """One rank's share of an attention sublayer over `model`: query heads
    [q0, q0 + nq) and KV heads [k0, k0 + nk), and whether the sublayer is
    replicated (every rank holds and computes every head; its output is
    whole, so nothing is summed over `model`)."""
    kind: str                         # "kv", "wseq" or "replicated"
    q0: int
    nq: int
    k0: int
    nk: int

    @property
    def replicated(self) -> bool:
        return self.kind == "replicated"


def head_layout(cfg: ModelConfig, tp: int = 1, t: int = 0) -> HeadLayout:
    """The attention heads rank t of `tp` holds — the one place the
    rank-local attention layout is decided: the parameter cut
    (`LM.param_cuts`), every allocator below, the arena, the engines and
    the transfer metering read it.

    'kv' (K % tp == 0, the reference's decode strategy of that name):
      H / tp query heads over K / tp KV heads.
    'wseq' (K % tp != 0, H % tp == 0 and tp % K == 0: a rank's query
      heads lie in one GQA group): the rank's H / tp query heads and the
      one KV head t·K // tp they read, whole — the reference keeps its
      paged arenas whole under 'wseq' (`arena_kv_part`); here every cache
      holds that head.
    'replicated' (H % tp != 0, the reference's 'qseq', or a rank's query
      heads straddling two KV heads): every head on every rank."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    if K % tp == 0:                   # then H % tp == 0 as well
        nq, nk = H // tp, K // tp
        return HeadLayout("kv", t * nq, nq, t * nk, nk)
    if H % tp == 0 and tp % K == 0:
        nq = H // tp
        return HeadLayout("wseq", t * nq, nq, t * K // tp, 1)
    return HeadLayout("replicated", 0, H, 0, K)


@dataclass(frozen=True)
class MambaLayout:
    """One rank's share of a Mamba-2 mixer over `model`: SSD heads
    [h0, h0 + nh) and their d_in channels [c0, c0 + nc); replicated where
    the heads do not divide over `model` (every rank the whole mixer, no
    psum)."""
    h0: int
    nh: int
    c0: int
    nc: int
    replicated: bool


def mamba_layout(cfg: ModelConfig, tp: int = 1, t: int = 0) -> MambaLayout:
    """The reference's cut (src/repro/models/stack.py:90-109, 174-183):
    w_z, w_x, conv_x, ssm_norm and the state's channels by d_in; w_dt,
    dt_bias, A_log, D_skip by SSD heads; out_proj by rows (its product
    summed over `model`); w_bc and conv_bc whole."""
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    nh = d_in // ssm.head_dim if ssm.head_dim else 0
    if nh % tp:
        return MambaLayout(0, nh, 0, d_in, True)
    n = nh // tp
    return MambaLayout(t * n, n, t * n * ssm.head_dim, n * ssm.head_dim,
                       False)


def alloc_arena_kv(cfg: ModelConfig, plan: StackPlan, n_arena_blocks: int,
                   block_size: int, device, dtype=None,
                   quant: bool = False, tp: int = 1) -> list:
    """One entry per layer: {"k","v": [N, K, bs, h], "kmin","kmax","kmean":
    [N, K, h] float32} for full-attention layers (`n_arena_blocks` includes
    the null block 0), None elsewhere. With `quant` (QuantPlane) "k","v"
    are int8 and the entry adds the scale plane: "kscale","vscale" [N, K,
    h] per-channel seal scales and "ktok","vtok" [N, K, bs] per-token
    scales, float32. K is this rank's KV heads (`head_layout`) at `tp` >
    1."""
    dtype = torch.int8 if quant else torch_dtype(dtype or cfg.compute_dtype)
    K, h = head_layout(cfg, tp).nk, cfg.head_dim

    def one(spec):
        if not full_attn_layer(cfg, spec):
            return None
        shp = (n_arena_blocks, K, block_size, h)
        sshp = (n_arena_blocks, K, h)
        z = dict(dtype=torch.float32, device=device)
        e = {"k": torch.zeros(shp, dtype=dtype, device=device),
             "v": torch.zeros(shp, dtype=dtype, device=device),
             "kmin": torch.zeros(sshp, **z),
             "kmax": torch.zeros(sshp, **z),
             "kmean": torch.zeros(sshp, **z)}
        if quant:
            tshp = (n_arena_blocks, K, block_size)
            e.update(kscale=torch.zeros(sshp, **z),
                     vscale=torch.zeros(sshp, **z),
                     ktok=torch.zeros(tshp, **z), vtok=torch.zeros(tshp, **z))
        return e
    return [one(s) for s in plan.all_specs()]


def quant_kwargs(entry: dict) -> dict:
    """The kernels' scale-plane kwargs of an int8 arena entry ({} for a
    float entry)."""
    if "kscale" not in entry:
        return {}
    return dict(k_scale=entry["kscale"], k_tok=entry["ktok"],
                v_scale=entry["vscale"], v_tok=entry["vtok"])


def mamba_cache_shapes(cfg: ModelConfig, B: int, dtype=None,
                       tp: int = 1) -> dict:
    """{name: (shape, dtype)} of a mamba layer's entry for B sequences: the
    SSD state, always float32 (the reference's `cache_struct`), and the two
    convolutions' last cw-1 pre-convolution inputs in the compute dtype. At
    `tp` > 1 the state and `conv_x` hold the rank's heads and channels
    (`mamba_layout`); `conv_bc` is whole."""
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    ssm = cfg.ssm
    lay = mamba_layout(cfg, tp)
    cw1 = ssm.conv_width - 1
    return {"state": ((B, lay.nh, ssm.head_dim, ssm.d_state), torch.float32),
            "conv_x": ((B, cw1, lay.nc), dtype),
            "conv_bc": ((B, cw1, 2 * ssm.d_state), dtype)}


def _alloc_mamba(cfg: ModelConfig, B: int, device, dtype, tp: int) -> dict:
    return {n: torch.zeros(shp, dtype=dt, device=device)
            for n, (shp, dt) in mamba_cache_shapes(cfg, B, dtype, tp).items()}


def alloc_cache(cfg: ModelConfig, plan: StackPlan, B: int, max_len: int,
                device, dtype=None, tp: int = 1) -> dict:
    """Dense caches for B sequences: every attention layer gets {"k","v":
    [B, W, K, h]} zeros, W = sink + recent for ring layers and max_len for
    full ones, every mamba layer its B-row entry (the reference's
    `alloc_cache`); the rank's heads and channels at `tp` > 1
    (`head_layout`, `mamba_layout`)."""
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    K, h = head_layout(cfg, tp).nk, cfg.head_dim

    def one(spec):
        if spec.kind == "mamba":
            return _alloc_mamba(cfg, B, device, dtype, tp)
        sink, recent = cache_window(cfg, spec)
        W = (sink + recent) if (sink or recent) else max_len
        return {n: torch.zeros((B, W, K, h), dtype=dtype, device=device)
                for n in ("k", "v")}
    return {"layers": [one(s) for s in plan.all_specs()], "pos": 0}


def alloc_prefill_private_cache(cfg: ModelConfig, plan: StackPlan,
                                max_len: int, device, dtype=None,
                                tp: int = 1) -> dict:
    """B=1 task cache without full-attention layers (their KV lives in the
    shared arena): the position, dense [1, W, K, h] ring KV and the mamba
    layers' B=1 entries (the rank's share at `tp` > 1)."""
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    K, h = head_layout(cfg, tp).nk, cfg.head_dim

    def one(spec):
        if full_attn_layer(cfg, spec):
            return None
        if spec.kind == "mamba":
            return _alloc_mamba(cfg, 1, device, dtype, tp)
        W = sum(cache_window(cfg, spec))
        return {n: torch.zeros((1, W, K, h), dtype=dtype, device=device)
                for n in ("k", "v")}
    return {"layers": [one(s) for s in plan.all_specs()], "pos": 0}


def alloc_paged_private_cache(cfg: ModelConfig, plan: StackPlan,
                              n_slots: int, max_len: int, block_size: int,
                              device, dtype=None, tp: int = 1) -> dict:
    """Decode-engine private side of the paged cache: full-attention entries
    are None (shared arena); each ring layer gets [n_slots·bpw, K, bs, h]
    blocks, slot b statically owning blocks [b·bpw, (b+1)·bpw) (the
    reference's `layer_cache_shape_paged`); each mamba layer its per-slot
    entry, row b slot b's. The rank's share at `tp` > 1."""
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    K, h = head_layout(cfg, tp).nk, cfg.head_dim

    def one(spec):
        if full_attn_layer(cfg, spec):
            return None
        if spec.kind == "mamba":
            return _alloc_mamba(cfg, n_slots, device, dtype, tp)
        bpw = ring_block_count(*cache_window(cfg, spec), block_size)
        shp = (n_slots * bpw, K, block_size, h)
        return {n: torch.zeros(shp, dtype=dtype, device=device)
                for n in ("k", "v")}
    return {"layers": [one(s) for s in plan.all_specs()], "pos": 0}


def merge_arena_cache(cfg: ModelConfig, plan: StackPlan, private: dict,
                      arena_kv: list) -> dict:
    """(private ∪ arena) → the full cache the layer loop reads."""
    layers = [arena_kv[i] if full_attn_layer(cfg, s) else private["layers"][i]
              for i, s in enumerate(plan.all_specs())]
    return {"layers": layers, "pos": private["pos"]}


# ----------------------------------------------------------------------
# Layer application
def attn_sublayer(cfg: ModelConfig, spec: LayerSpec, p: dict, x, *,
                  mode: str, positions, cache: Optional[dict],
                  true_len: Optional[int] = None, block_tables=None,
                  pos0: int = 0, max_len: int = 0, token_mask=None,
                  ctx: Optional[RankCtx] = None):
    """Attention of one layer. → (x, new cache entry or None, sparsity aux
    or None).

    Tensor parallel over `ctx` (tp > 1): wq/wk/wv (and their biases) hold
    this rank's whole heads (`head_layout`: H / tp query heads over K / tp
    KV heads, or under 'wseq' over the one KV head they read), so every
    kernel runs on the rank-local heads unchanged — ring layers and
    sliding windows included, their caches at the rank's KV heads; wo
    holds the matching rows and its partial product is summed over
    `model`. A replicated sublayer holds every head and sums nothing.
    Online top-k is the one step that needs every head: its block scores
    are max-reduced over `model` before ranking (`_select_blocks`).

    mode "prefill", cache None: a whole B=1 prompt at positions arange(S)
      (the first `true_len` rows real) through the flash-prefill kernel; the
      new entry is the dense cache — ring layers compressed to sink+recent,
      full layers zero-padded to `max_len`.
    mode "prefill" with a cache: a chunk at positions pos0 + arange(S) (the
      first `true_len` rows real; pos0 and true_len ints or 0-d device
      tensors). A full-attention layer with block_tables attends the paged
      arenas (paged-prefill kernel), then writes the chunk's K/V into its
      blocks, in place; a ring layer, or any layer without block_tables,
      attends and writes its dense cache (`prefill_resume_attention`).
    mode "decode": one token per slot at positions [B, 1]. With
      block_tables the K/V are written into the arenas (full layers through
      the table, ring layers into the slot's own block run) and attended
      through the paged-decode kernel; without, into the dense caches,
      attended through the sink-decode kernel. In place either way. With
      cfg.omniattn.topk_* set, a paged full layer scores its resident blocks
      and compacts the selected ones into a table (one block-topk kernel
      launch), attends only those, and returns the aux [blocks_scored,
      blocks_attended, mass_sum, mass_n], weighted by `token_mask` [B].
    mode "verify": each slot's draft window, positions [B, S], read-only
      against the paged caches — full layers through the spec-verify
      kernel, ring layers through `spec_verify_ring_attention`; the new
      entry is the window's rope'd K/V, staged for `stack_verify_commit`.
    mode "train": whole sequences [B, S] at positions arange(S), no cache,
      through the plain differentiable `chunked_attention` (never a
      kernel: none has a backward); no entry. Over ranks B is this rank's
      rows and the heads its `head_layout`; the normed input enters the
      sharded heads through `ctx.enter_model`, so its gradient is summed
      over `model`. The gradients of what the ranks hold alike inside the
      sublayer (q_norm, k_norm; under 'wseq' the KV head wk / wv / bk /
      bv several ranks read) are each rank's share: the trainer sums
      them over the ranks that hold them (`LM.grad_sync`).
    mode "encode": the same whole sequences through the flash-prefill
      kernel (causal or bidirectional as cfg.causal says), no cache and no
      entry — an encoder's forward (`LM.prefill` of an encoder-only
      config, the reference's mode "train" under use_pallas). Inference
      only: the kernel refuses inputs that require grad."""
    B, S, _ = x.shape
    h = cfg.head_dim
    H, K = p["wq"].shape[1] // h, p["wk"].shape[1] // h      # local heads
    cd = torch_dtype(cfg.compute_dtype)
    sharded = ctx is not None and ctx.tp > 1 and \
        not head_layout(cfg, ctx.tp).replicated
    hid = rms_norm(x, p["ln_attn"], cfg.rms_eps).to(cd)
    if sharded:
        hid = ctx.enter_model(hid)          # "f": a no-op without grad
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
    sink, recent = cache_window(cfg, spec)
    ring = bool(sink or recent)
    # the mask of a whole sequence (train, whole-prompt prefill)
    window, use_sink = spec.window, 0
    if spec.compressed and cfg.prefill_sparse:
        window, use_sink = recent, sink
    new_cache = sp_aux = None
    if mode == "train":
        out = attn_mod.chunked_attention(q, k, v, causal=cfg.causal,
                                         window=window, sink=use_sink,
                                         fp32_scores=cfg.attn_fp32_scores)
    elif mode == "encode" or (mode == "prefill" and cache is None):
        out = kops.attention_prefill_op(q, k, v, causal=cfg.causal,
                                        window=window, sink=use_sink)
        if mode == "prefill" and ring:
            kc, vc = attn_mod.compress_prefill_kv(k, v, sink=sink,
                                                  recent=recent,
                                                  true_len=true_len)
            new_cache = {"k": kc, "v": vc}
        elif mode == "prefill":
            pad = (0, 0, 0, 0, 0, max_len - S)
            new_cache = {"k": torch.nn.functional.pad(k, pad),
                         "v": torch.nn.functional.pad(v, pad)}
    elif mode == "prefill" and (ring or block_tables is None):
        # a chunk over the layer's dense cache (a ring, or a full layer's
        # [1, max_len] cache): attend the resident tokens and the causal
        # chunk, then write the chunk in place
        mask_window = mask_sink = 0
        if spec.window > 0:
            mask_window = spec.window
        elif spec.compressed and cfg.prefill_sparse:
            mask_window, mask_sink = recent, sink
        out = attn_mod.prefill_resume_attention(
            q, k, v, cache["k"], cache["v"], positions,
            chunk_len=S if true_len is None else true_len, sink=sink,
            recent=recent, mask_window=mask_window, mask_sink=mask_sink)
    elif mode == "prefill":
        kc, vc = cache["k"], cache["v"]
        bs = kc.shape[2]
        nb = block_tables.shape[1]
        cl = S if true_len is None else true_len
        qkw = quant_kwargs(cache)
        out = kops.attention_paged_prefill_op(q, k, v, kc, vc, block_tables,
                                              pos0, cl, **qkw)
        if qkw:
            attn_mod.quant_paged_prefill_write(cache, k, v, block_tables,
                                               pos0, cl)
        else:
            attn_mod.paged_prefill_write(kc, vc, k, v, block_tables, pos0,
                                         cl)
        # the chunk touched the blocks its real positions map to (padded
        # rows alias the null block, whose re-summary is harmless)
        ar = torch.arange(S, device=x.device)
        ppos = pos0 + ar
        wblk = torch.where(
            ar < cl,
            block_tables[0].long()[torch.clamp(ppos // bs, 0, nb - 1)],
            torch.zeros_like(ar))
        attn_mod.update_block_summaries(cache["kmin"], cache["kmax"],
                                        cache["kmean"], kc, wblk,
                                        k_scale=qkw.get("k_scale"),
                                        k_tok=qkw.get("k_tok"))
    elif mode == "decode" and block_tables is not None:
        kc, vc = cache["k"], cache["v"]
        bs = kc.shape[2]
        t = positions[:, 0].to(torch.int32)
        bidx = torch.arange(B, device=x.device, dtype=torch.int32)
        qkw = quant_kwargs(cache)          # {} on ring layers
        if ring:
            # the slot's ring occupies its own contiguous block run
            W = sink + recent
            bpw = ring_block_count(sink, recent, bs)
            slot = attn_mod.ring_slot(t, sink, recent)
            blk = bidx * bpw + slot // bs
            tbl = bidx[:, None] * bpw + torch.arange(
                bpw, device=x.device, dtype=torch.int32)[None, :]
            lens = torch.clamp(t + 1, max=W)
            attn_mod.paged_cache_write(kc, vc, k[:, 0], v[:, 0], blk,
                                       slot % bs)
        else:
            # past the table's logical capacity the write goes to the null
            # block
            nb = block_tables.shape[1]
            blk = torch.where(
                t < nb * bs,
                block_tables[bidx.long(),
                             torch.clamp(t // bs, max=nb - 1).long()],
                torch.zeros_like(t))
            tbl = block_tables
            lens = torch.clamp(t + 1, max=nb * bs)
            if qkw:
                attn_mod.quant_paged_cache_write(cache, k[:, 0], v[:, 0],
                                                 blk, t % bs)
            else:
                attn_mod.paged_cache_write(kc, vc, k[:, 0], v[:, 0], blk,
                                           t % bs)
            # the appended token's block is re-summarised before scoring, so
            # the tail bound covers the new key
            attn_mod.update_block_summaries(cache["kmin"], cache["kmax"],
                                            cache["kmean"], kc, blk,
                                            k_scale=qkw.get("k_scale"),
                                            k_tok=qkw.get("k_tok"))
            tbl, lens, sp_aux = _select_blocks(cfg, q[:, 0], cache, tbl,
                                               lens, token_mask, ctx)
        out = kops.attention_paged_decode_op(q[:, 0], kc, vc, tbl, lens,
                                             **qkw)
    elif mode == "verify":
        # read-only: the window's K/V is staged, the accepted prefix is
        # committed afterwards (a rejected row never touches a block)
        pos2 = positions.to(torch.int32)                     # [B, S]
        if ring:
            # the slot's frozen ring run as a dense [B, W] view (slot b owns
            # blocks [b·bpw, (b+1)·bpw))
            bs = cache["k"].shape[2]
            bpw = ring_block_count(sink, recent, bs)
            W = sink + recent
            kr, vr = (cache[n].reshape(B, bpw, K, bs, h).transpose(2, 3)
                      .reshape(B, bpw * bs, K, h)[:, :W] for n in ("k", "v"))
            out = attn_mod.spec_verify_ring_attention(
                q, k, v, kr, vr, pos2, sink=sink, recent=recent)
        else:
            t = pos2[:, 0]
            out = kops.spec_verify_op(q, k, v, cache["k"], cache["v"],
                                      block_tables, t, torch.full_like(t, S),
                                      **quant_kwargs(cache))
        new_cache = {"k": k, "v": v}
    elif mode == "decode":
        t = positions[:, 0]
        kc, vc = attn_mod.cache_write(cache["k"], cache["v"], k[:, 0],
                                      v[:, 0], t, sink=sink, recent=recent)
        out = kops.attention_decode_op(q[:, 0], kc, vc, t + 1)
    else:
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    y = out.reshape(B, S, H * h) @ p["wo"]
    if sharded:
        y = ctx.psum_model(y)
    return x + y.to(x.dtype), new_cache, sp_aux


def _select_blocks(cfg: ModelConfig, q, cache: dict, tbl, lens, token_mask,
                   ctx: Optional[RankCtx] = None):
    """OmniAttn online top-k on one paged full layer's decode step. q
    [B, H, h] (this rank's heads); tbl [B, nb]; lens [B]. → (table, lens) to
    attend, and the aux [blocks_scored, blocks_attended, mass_sum, mass_n]
    (None when sparsity is off). A budget covering the whole (bucketed)
    table skips selection: exact attention, still reported so the stats
    stay comparable.

    A block's score is a max over every (kv head, query head). At tp > 1 a
    rank holds H / tp query heads (under 'wseq' beside the other ranks of
    its KV head), so the rank's scores are reduced over `model`
    (`pmax_model`) before ranking: every rank keeps the same blocks and
    the partial outputs its `wo` psum adds are over one block set. A max
    over ranks that repeat a KV head is unchanged by the repeat. NEG_INF
    past the residency survives the max (every rank shares lens). The
    stats follow from lens and the reduced selection, so they are the
    same on every rank; the mass, a mean over this rank's H / tp query
    heads (each query head on one rank), is averaged over `model`. A
    replicated sublayer holds every head: it reduces nothing."""
    oa = cfg.omniattn
    nb = tbl.shape[1]
    k_static = topk_block_budget(oa, nb)
    if k_static is None:
        return tbl, lens, None
    bs = cache["k"].shape[2]
    if k_static >= nb:
        act = _live(token_mask, q)
        n_res = torch.div(lens + bs - 1, bs, rounding_mode="floor")
        scored = (act * n_res).sum()
        mn = act.sum() if oa.topk_measure_mass else \
            torch.zeros((), dtype=torch.float32, device=q.device)
        return tbl, lens, torch.stack([scored, scored, mn, mn])
    sel_kw = dict(block_size=bs, k_static=k_static,
                  frac=0.0 if oa.topk_blocks > 0 else oa.topk_frac,
                  sink_blocks=max(oa.topk_sink_blocks, 0),
                  recent_blocks=max(oa.topk_recent_blocks, 1),
                  token_mask=token_mask)
    tp = 1 if ctx is None or head_layout(cfg, ctx.tp).replicated \
        else ctx.tp
    if tp == 1:
        # scores, ranking, compaction and the stats: one kernel launch on
        # the card
        _, tbl_s, lens_s, m, selected, aux = kops.block_topk_select_op(
            q, cache["kmin"], cache["kmax"], tbl, lens, **sel_kw)
    else:
        # the rank's scores, their max over `model`, then the ranking and
        # compaction on the reduced scores (one launch each on the card)
        scores = kops.block_topk_scores_op(q, cache["kmin"], cache["kmax"],
                                           tbl, lens, block_size=bs)
        scores = ctx.pmax_model(scores)
        tbl_s, lens_s, m, selected, aux = block_topk_select_scores(
            scores, tbl, lens, **sel_kw)
    if oa.topk_measure_mass:
        mass = attn_mod.selected_attention_mass(q, cache["k"], tbl, lens,
                                                selected,
                                                k_scale=cache.get("kscale"),
                                                k_tok=cache.get("ktok"))
        if tp > 1:
            mass = ctx.psum_model(mass) / tp
        act = _live(token_mask, q)
        aux = torch.stack([aux[0], aux[1], (act * mass).sum(), act.sum()])
    return tbl_s, lens_s, aux


def _live(token_mask, q):
    """The live-slot weights [B] float32 of a decode step (all ones without
    a mask)."""
    if token_mask is not None:
        return token_mask.float()
    return torch.ones(q.shape[0], dtype=torch.float32, device=q.device)


def mamba_sublayer(cfg: ModelConfig, p: dict, x, *, mode: str,
                   cache: Optional[dict], true_len=None,
                   ctx: Optional[RankCtx] = None):
    """The Mamba-2 SSD mixer of one layer with its pre-norm and residual.
    → (x, new entry or None).

    Tensor parallel over `ctx` (tp > 1, `mamba_layout`): p and the entry
    hold this rank's SSD heads and their d_in channels (w_bc, conv_bc
    whole), the scans run on them unchanged, `ssm_norm` — one RMSNorm over
    the whole d_in — sums its squares over `model`, and `out_proj`'s
    partial product is summed over `model`. A replicated mixer sums
    nothing. In training the normed input enters the sharded mixer
    through `ctx.enter_model` (its gradient summed over `model`) and
    w_bc / conv_bc, whole on every rank but feeding the rank's SSD heads,
    get each rank's share of their gradients (the trainer sums them:
    `LM.grad_sync`).

    mode "prefill", "train" or "encode", cache None: whole sequences from a
      zero state (a B=1 prompt, or a training batch); the new entry is
      returned. Mode "prefill" with a cache: a chunk continuing the
      entry's state and convolution rows, updated in place. With
      `true_len` (an int or a 0-d device tensor, read on the device) the
      rows past it are padding: their dt and x are zeroed, which leaves
      the state as it was (decay exp(0) = 1, update 0), and the new
      convolution rows are the last cw-1 real pre-convolution inputs,
      gathered from (old rows ‖ chunk) at true_len.
    mode "decode": one token per slot, the entry updated in place (the
      convolution rows shift through a new tensor).
    mode "verify" raises: a rejected draft would need the recurrent state
      from before the window back (SpecController refuses SSM stacks
      first)."""
    if mode == "verify":
        raise NotImplementedError(
            "speculative verify has no multi-token SSM rollback path")
    B, S, D = x.shape
    ssm = cfg.ssm
    d_in, nh = p["w_x"].shape[1], p["w_dt"].shape[1]       # this rank's
    sharded = ctx is not None and ctx.tp > 1 and \
        not mamba_layout(cfg, ctx.tp).replicated
    N, cw = ssm.d_state, ssm.conv_width
    cd = torch_dtype(cfg.compute_dtype)
    hid = rms_norm(x, p["ln_attn"], cfg.rms_eps).to(cd)
    if sharded:
        hid = ctx.enter_model(hid)          # "f": a no-op without grad
    z = hid @ p["w_z"]
    xin = hid @ p["w_x"]
    bc = hid @ p["w_bc"]
    dt_raw = (hid @ p["w_dt"]).float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))   # softplus
    A = -torch.exp(p["A_log"].float())

    cx = cache["conv_x"] if cache is not None else None
    cbc = cache["conv_bc"] if cache is not None else None
    xin_pre, bc_pre = xin, bc               # pre-convolution rows
    xin, new_cx = ssd_mod.causal_conv(xin, p["conv_x"], cx)
    bc, new_cbc = ssd_mod.causal_conv(bc, p["conv_bc"], cbc)
    xin = torch.nn.functional.silu(xin)
    bc = torch.nn.functional.silu(bc)
    if true_len is not None and mode != "decode":
        tl = torch.as_tensor(true_len, device=x.device)
        live = torch.arange(S, device=x.device) < tl
        dt = dt * live[None, :, None]
        xin = xin * live[None, :, None].to(xin.dtype)
        if cx is not None:
            pad_x = torch.cat([cx.to(xin_pre.dtype), xin_pre], dim=1)
            pad_bc = torch.cat([cbc.to(bc_pre.dtype), bc_pre], dim=1)
        else:
            pad_x = torch.nn.functional.pad(xin_pre, (0, 0, cw - 1, 0))
            pad_bc = torch.nn.functional.pad(bc_pre, (0, 0, cw - 1, 0))
        rows = tl.long() + torch.arange(cw - 1, device=x.device)
        new_cx = pad_x.index_select(1, rows)
        new_cbc = pad_bc.index_select(1, rows)
    Bm, Cm = bc[..., :N], bc[..., N:]

    xh = xin.reshape(B, S, nh, ssm.head_dim)
    if mode == "decode":
        y1, new_state = ssd_mod.ssd_decode_step(
            cache["state"], xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y1[:, None]
    else:
        init = cache["state"] if cache is not None else None
        y, new_state = ssd_mod.ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk,
                                           init)
    y = y + xh.to(y.dtype) * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_in) * torch.nn.functional.silu(z.to(y.dtype))
    if sharded:
        y = rms_norm_over_model(y, p["ssm_norm"], cfg.rms_eps, ctx,
                                ssm.expand * D)
        out = ctx.psum_model(y.to(cd) @ p["out_proj"]).to(x.dtype)
    else:
        y = rms_norm(y, p["ssm_norm"], cfg.rms_eps)
        out = (y.to(cd) @ p["out_proj"]).to(x.dtype)
    entry = {"state": new_state, "conv_x": new_cx, "conv_bc": new_cbc}
    if cache is None:
        return x + out, entry
    for name, t in entry.items():
        cache[name].copy_(t)
    return x + out, None


def ffn_sublayer(cfg: ModelConfig, spec: LayerSpec, p: dict, x, *,
                 tables: Optional[dict] = None, token_mask=None,
                 train: bool = False, ctx: Optional[RankCtx] = None):
    """Feed-forward with its pre-norm and residual: a dense SwiGLU, or on
    an MoE layer the routed experts (through the moe_gmm kernel, or plain
    products with `train`) plus the shared SwiGLU. → (x, expert counts
    [E] or None). token_mask [B] weights the counts of each row's S
    tokens. Over `ctx`: w1/w3 hold this rank's columns and w2 its rows
    where d_ff divides over `model` (then the product is summed over
    `model`); the MoE layer splits its batch rows over `data` where B
    divides over ep (the reference's batch_part). With `train` the rows
    are this rank's already (`LM.train_loss` cut them) and are routed as
    they are."""
    if not spec.use_moe and cfg.d_ff == 0:
        return x, None
    cd = torch_dtype(cfg.compute_dtype)
    hid = rms_norm(x, p["ln_mlp"], cfg.rms_eps).to(cd)
    if not spec.use_moe:
        split = ctx is not None and p["w1"].shape[1] != cfg.d_ff
        if split:
            hid = ctx.enter_model(hid)      # "f": a no-op without grad
        y = swiglu(hid, p["w1"], p["w3"], p["w2"])
        if split:
            y = ctx.psum_model(y)
        return x + y.to(x.dtype), None
    B, S, D = x.shape
    shared = None
    if cfg.moe.n_shared_experts:
        shared = (p["shared_w1"], p["shared_w3"], p["shared_w2"])
    tm = None if token_mask is None else token_mask.repeat_interleave(S)
    y, counts = moe_mod.moe_ffn(cfg, hid.reshape(B * S, D), p["router"],
                                p["moe_w1"], p["moe_w3"], p["moe_w2"],
                                tables, shared, token_mask=tm, train=train,
                                ctx=ctx, shard_tokens=not train
                                and ctx is not None and ctx.ep > 1
                                and B % ctx.ep == 0)
    return x + y.reshape(B, S, D).to(x.dtype), counts


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat_policy "dots": keep the matrix
    products' outputs, recompute everything else (the reference's
    `dots_saveable`)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p: dict, x, *, mode: str,
                positions, cache: Optional[dict], block_tables=None,
                true_len: Optional[int] = None, pos0: int = 0,
                max_len: int = 0, token_mask=None,
                tables: Optional[dict] = None, ctx: Optional[RankCtx] = None):
    """One layer: its mixer (attention or Mamba-2) and its FFN, its FSDP
    leaves gathered whole first (`gather_fsdp`). → (x, new entry,
    sparsity aux, expert counts)."""
    p = gather_fsdp(cfg, p, ctx)
    sp = None
    if spec.kind == "mamba":
        x, nc = mamba_sublayer(cfg, p, x, mode=mode, cache=cache,
                               true_len=true_len, ctx=ctx)
    else:
        x, nc, sp = attn_sublayer(
            cfg, spec, p, x, mode=mode, positions=positions, cache=cache,
            true_len=true_len, block_tables=block_tables, pos0=pos0,
            max_len=max_len, token_mask=token_mask, ctx=ctx)
    x, cnt = ffn_sublayer(cfg, spec, p, x, tables=tables,
                          token_mask=token_mask, train=mode == "train",
                          ctx=ctx)
    return x, nc, sp, cnt


def stack_apply(cfg: ModelConfig, plan: StackPlan, layers: list, x, *,
                mode: str, positions, caches: Optional[dict], block_tables,
                true_len: Optional[int] = None, pos0: int = 0,
                max_len: int = 0, token_mask=None,
                tables: Optional[dict] = None, ctx: Optional[RankCtx] = None):
    """Run every layer in order. Caches given are updated in place (read
    only in mode "verify"). `tables` are the MoE placement tables (every
    MoE layer reads the same). → (x, entries, sparsity, counts): entries
    are the new per-layer cache entries with caches None (whole-prompt
    prefill) or the staged window K/V per layer in mode "verify", else
    None; sparsity is the list of per-layer [4] online-sparsity vectors
    (empty when off); counts the list of per-MoE-layer expert counts [E]
    (empty without MoE layers).

    Mode "encode" runs whole sequences through the kernels, no cache.
    Mode "train" (whole sequences, no cache) is differentiable; with
    cfg.remat each layer is an activation checkpoint
    (`torch.utils.checkpoint`, non-reentrant): remat_policy "nothing"
    keeps only the layer's input and recomputes the rest in the backward,
    "dots" also keeps the matrix products' outputs. Over ranks the
    recomputation re-runs the layer's forward collectives (psums,
    all_to_alls) inside the backward, between the backward's own: every
    rank walks the same layers in the same order, so every group meets
    them in the same order. "dots" saves no collective's output (they are
    not matrix products), so none is saved and skipped on one rank while
    re-issued on another."""
    entries = [] if caches is None or mode == "verify" else None
    sparsity, counts = [], []
    remat = mode == "train" and cfg.remat
    if remat:
        from torch.utils.checkpoint import checkpoint
        ckpt_kw = {"dots": dict(context_fn=_dots_context)}.get(
            cfg.remat_policy, {})
    for i, (spec, p) in enumerate(zip(plan.all_specs(), layers)):
        kw = dict(mode=mode, positions=positions,
                  cache=None if caches is None else caches["layers"][i],
                  block_tables=block_tables, true_len=true_len, pos0=pos0,
                  max_len=max_len, token_mask=token_mask, tables=tables,
                  ctx=ctx)
        if remat:
            x, nc, sp, cnt = checkpoint(apply_layer, cfg, spec, p, x,
                                        use_reentrant=False, **ckpt_kw, **kw)
        else:
            x, nc, sp, cnt = apply_layer(cfg, spec, p, x, **kw)
        if entries is not None:
            entries.append(nc)
        if sp is not None:
            sparsity.append(sp)
        if cnt is not None:
            counts.append(cnt)
    return x, entries, sparsity, counts


def stack_verify_commit(cfg: ModelConfig, plan: StackPlan, caches: dict,
                        staged: list, positions, n_write, block_tables):
    """Land a verify window's accepted prefix in the paged caches, in place.

    staged: stack_apply(mode="verify")'s per-layer window K/V [B, S, K, h];
    positions [B] the window start (the pre-verify slot cursor); n_write [B]
    rows to land per slot — the consumed input tokens (current token +
    accepted drafts; 0 for idle slots); block_tables [B, nb]. Window row i
    of slot b lands at position positions[b] + i iff i < n_write[b].

    Full layers redirect rejected, idle and overflow rows to the null block
    and re-summarise every touched block, so no summary goes stale: a
    rollback is a write that never happened. Ring block runs have no null
    block: rejected rows write back their slot's current content. Window
    rows map to distinct ring slots because S <= recent (the controller caps
    the window)."""
    positions = positions.to(torch.int32)
    n_write = n_write.to(torch.int32)
    B = positions.shape[0]
    dev = positions.device
    S = staged[0]["k"].shape[1]
    pos2 = positions[:, None] + torch.arange(S, device=dev,
                                             dtype=torch.int32)[None]
    valid = torch.arange(S, device=dev, dtype=torch.int32)[None] \
        < n_write[:, None]
    bidx = torch.arange(B, device=dev, dtype=torch.int32)
    for spec, entry, stg in zip(plan.all_specs(), caches["layers"], staged):
        bs = entry["k"].shape[2]
        sink, recent = cache_window(cfg, spec)
        if sink or recent:
            bpw = ring_block_count(sink, recent, bs)
            slot = attn_mod.ring_slot(pos2, sink, recent)
            blk = bidx[:, None] * bpw + torch.div(slot, bs,
                                                  rounding_mode="floor")
            attn_mod.paged_cache_write_tokens_masked(
                entry["k"], entry["v"], stg["k"], stg["v"], blk, slot % bs,
                valid)
            continue
        nb = block_tables.shape[1]
        col = torch.clamp(torch.div(pos2, bs, rounding_mode="floor"),
                          max=nb - 1).long()
        blk = torch.where(valid & (pos2 < nb * bs),
                          block_tables[bidx.long()[:, None], col],
                          torch.zeros_like(pos2))
        if "kscale" in entry:
            # the staged window quantizes per token as it lands; rejected
            # rows go to the null block, for the scale plane too
            attn_mod.quant_paged_cache_write_tokens(entry, stg["k"],
                                                    stg["v"], blk, pos2 % bs)
        else:
            attn_mod.paged_cache_write_tokens(entry["k"], entry["v"],
                                              stg["k"], stg["v"], blk,
                                              pos2 % bs)
        attn_mod.update_block_summaries(entry["kmin"], entry["kmax"],
                                        entry["kmean"], entry["k"],
                                        blk.reshape(-1),
                                        k_scale=entry.get("kscale"),
                                        k_tok=entry.get("ktok"))
    return caches
