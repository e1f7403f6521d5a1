"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7), MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import (MoEConfig, ModelConfig, OmniAttnConfig,
                                      SSMConfig)

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=1e6,
    attn_period=8,       # one attention layer per 8 (1:7 attn:mamba)
    attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, moe_every=2,
                  capacity_factor=2.0, redundant_slots=1),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    # compress every attention layer (1/8 of the stack): keeps the 8-layer
    # hybrid pattern periodic; SSM layers carry long-range state anyway.
    omniattn=OmniAttnConfig(pattern_period=1, compress_per_period=1),
    fsdp=True,
    grad_accum=8,
    optimizer_dtype="bfloat16",
)
