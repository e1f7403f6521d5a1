"""qwen3-moe-235b-a22b — 128 routed experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, moe_every=1,
                  norm_topk_prob=True, redundant_slots=1),
    fsdp=True,
    grad_accum=8,
)
