"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared (fine-grained).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    grad_accum=2,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
                  moe_every=1, norm_topk_prob=False, redundant_slots=0),
    # 60 experts on a 16-way EP axis → ceil(60/16)=4 slots/rank, 4 redundant
    # slots absorbed by OmniPlacement replicas of the hottest experts.
)
