"""Model/run configuration dataclasses shared by every architecture.

A config fully describes one architecture from the assigned pool. The layer
stack is expressed as a *periodic* sequence of ``LayerSpec``s (period length ×
repeat count + remainder). The PyTorch stack runs the layers in a plain loop;
the period form is kept because parameters bridged from the stacked layout
(``[n_rep, ...]`` leaves) are unstacked along it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer position inside the period."""

    kind: str = "attn"          # 'attn' | 'mamba'
    window: int = 0             # attention window; 0 = full (causal or bidir)
    use_moe: bool = False       # MoE FFN instead of dense FFN
    compressed: bool = False    # OmniAttn layer-wise sink+recent compression


@dataclass(frozen=True)
class OmniAttnConfig:
    """Sink+recent KV compression (OmniAttn)."""

    sink_tokens: int = 128
    recent_tokens: int = 4096
    # default layer pattern period: compress `compress_per_period` of every
    # `pattern_period` layers. The GA search (core/omniattn) can override.
    pattern_period: int = 4
    compress_per_period: int = 3

    # --- online (dynamic) sparsity: query-aware top-k KV-block selection
    # for paged decode over full-attention layers. Per-block key summaries
    # (per-kv-head mean + min/max channel bounds) live next to the block
    # arenas; each decode step scores resident blocks with a Quest-style
    # upper bound and attends only a per-slot budget of them (sink + most
    # recent blocks always kept). Budget: `topk_blocks` absolute, or
    # `topk_frac` of each slot's RESIDENT block count (ceil); both 0 → off.
    # Selection degrades to exact attention when the budget covers every
    # resident block. `topk_measure_mass` additionally computes the exact
    # attention mass captured by the selected blocks (a full-score pass —
    # diagnostics/benchmarks only, not the production hot path).
    topk_blocks: int = 0
    topk_frac: float = 0.0
    topk_sink_blocks: int = 1
    topk_recent_blocks: int = 2
    topk_measure_mass: bool = False


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1            # MoE FFN on every k-th layer
    norm_topk_prob: bool = True
    capacity_factor: float = 2.0
    # OmniPlacement redundancy: extra slots per EP rank beyond ceil(E/R).
    redundant_slots: int = 1


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "unnamed"
    family: str = "dense"         # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    causal: bool = True           # False → encoder-only (hubert)

    # local:global window pattern (gemma3): `local_per_global` local layers
    # (sliding window `local_window`) followed by one global layer.
    local_per_global: int = 0
    local_window: int = 1024

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    omniattn: OmniAttnConfig = field(default_factory=OmniAttnConfig)

    # hybrid (jamba): one attention layer per `attn_period` layers, at offset
    # `attn_offset`; remaining layers are mamba.
    attn_period: int = 0
    attn_offset: int = 4

    # modality frontend stubs
    frontend_dim: int = 0         # >0 → inputs include precomputed embeddings
    num_patches: int = 0          # vlm: patch embeddings prepended to tokens
    encoder_only: bool = False

    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"   # AdamW m/v dtype (bf16 for ≥300B archs)

    # execution knobs (perf-tunable; see EXPERIMENTS.md §Perf)
    attn_q_chunk: int = 2048
    attn_kv_chunk: int = 1024
    attn_skip_masked_chunks: bool = False  # statically skip fully-masked
                                           # causal KV blocks (halves flops)
    attn_fp32_scores: bool = True          # False → bf16 score/prob traffic
    attn_qseq_out_constraint: bool = False # pin q-seq sharding on attn output
    prefill_sparse: bool = False           # OmniAttn sink+window prefill math
    moe_token_chunk: int = 8192   # chunked MoE dispatch to bound a2a buffers
    moe_dispatch_int8: bool = False        # quantize dispatch/combine a2a
    remat: bool = True            # activation checkpointing in train_step
    remat_policy: str = "nothing"          # nothing | dots
    grad_accum: int = 1           # microbatch accumulation steps in train_step
    fsdp: bool = False            # shard params/opt-state over data axis too
    use_pallas: bool = False      # Pallas kernels (TPU target; interpret on CPU)

    # ------------------------------------------------------------------
    def layer_specs(self, pattern: Optional[list[int]] = None) -> list[LayerSpec]:
        """Full per-layer spec list. ``pattern[l]=1`` → OmniAttn-compressed."""
        specs = []
        for l in range(self.n_layers):
            kind = "attn"
            if self.attn_period > 0:
                kind = "attn" if (l % self.attn_period) == self.attn_offset else "mamba"
            elif self.family == "ssm":
                kind = "mamba"
            window = 0
            if kind == "attn" and self.local_per_global > 0:
                # 5 local : 1 global → positions 0..4 local, 5 global (mod 6)
                period = self.local_per_global + 1
                if (l % period) != self.local_per_global:
                    window = self.local_window
            use_moe = (
                self.moe.n_experts > 0 and (l % self.moe.moe_every) == (self.moe.moe_every - 1)
            )
            compressed = bool(pattern[l]) if pattern is not None else False
            if kind != "attn":
                compressed = False
            specs.append(LayerSpec(kind=kind, window=window, use_moe=use_moe,
                                   compressed=compressed))
        return specs

    def default_compression_pattern(self) -> list[int]:
        """Paper-faithful periodic default: compress `compress_per_period` of
        every `pattern_period` attention layers (GA can refine)."""
        oa = self.omniattn
        pat = []
        specs = self.layer_specs()
        ai = 0
        for s in specs:
            # only full-context attention layers are candidates: local-window
            # layers already have bounded caches, mamba layers have none.
            if s.kind != "attn" or s.window > 0:
                pat.append(0)
                continue
            pat.append(1 if (ai % oa.pattern_period) < oa.compress_per_period else 0)
            ai += 1
        return pat

    # ------------------------------------------------------------------
    def periodize(self, specs: list[LayerSpec]) -> tuple[list[LayerSpec], int, list[LayerSpec]]:
        """Find (period_specs, n_repeats, remainder_specs) with the smallest
        period so the stack scans over repeats and unrolls one period."""
        L = len(specs)
        for p in range(1, L + 1):
            period = specs[:p]
            n_rep = L // p
            if all(specs[i] == period[i % p] for i in range(n_rep * p)):
                rem = specs[n_rep * p:]
                # only worthwhile if we actually repeat; degenerate case p=L
                if n_rep >= 1:
                    return period, n_rep, rem
        return specs, 1, []

    def n_params(self) -> int:
        """Parameter count (for 6ND model FLOPs and memory budgeting)."""
        D, hd = self.d_model, self.head_dim
        n = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        for s in self.layer_specs():
            if s.kind == "attn":
                n += D * hd * (self.n_heads + 2 * self.n_kv_heads)  # wq wk wv
                n += self.n_heads * hd * D                          # wo
                if self.qkv_bias:
                    n += hd * (self.n_heads + 2 * self.n_kv_heads)
            else:
                ssm = self.ssm
                d_in = ssm.expand * D
                n_h = d_in // ssm.head_dim
                n += D * (2 * d_in + 2 * ssm.d_state + n_h)  # in_proj(z,x) B C dt
                n += d_in * ssm.conv_width + n_h * 2          # conv, A, D
                n += d_in * D                                  # out_proj
            if s.use_moe:
                m = self.moe
                n += D * m.n_experts                           # router
                n += m.n_experts * 3 * D * m.d_ff_expert
                n += m.n_shared_experts * 3 * D * m.d_ff_expert
            else:
                n += 3 * D * self.d_ff
            n += 2 * D                                         # norms
        n += D                                                 # final norm
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k) for 6·N_active·D model FLOPs."""
        if self.moe.n_experts == 0:
            return self.n_params()
        m = self.moe
        total = self.n_params()
        specs = self.layer_specs()
        n_moe_layers = sum(1 for s in specs if s.use_moe)
        all_expert = n_moe_layers * m.n_experts * 3 * self.d_model * m.d_ff_expert
        active_expert = n_moe_layers * m.top_k * 3 * self.d_model * m.d_ff_expert
        return total - all_expert + active_expert

    def with_updates(self, **kw) -> "ModelConfig":
        nested = {}
        for key in ("moe", "ssm", "omniattn"):
            sub = {k[len(key) + 1:]: kw.pop(k) for k in list(kw)
                   if k.startswith(key + "_") and k[len(key) + 1:] in
                   {f.name for f in dataclasses.fields(getattr(self, key).__class__)}}
            if sub:
                nested[key] = replace(getattr(self, key), **sub)
        return replace(self, **kw, **nested)


# ----------------------------------------------------------------------
# Input shape sets (assigned): every LM arch gets all four; encoder-only
# archs skip decode shapes (handled in launch/dryrun.py).
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
