"""gemma3-4b — dense, GQA kv=4, 5:1 local:global, 128k ctx.
[hf:google/gemma-3-1b-pt scaled; unverified]"""
from repro_torch.configs.base import ModelConfig, OmniAttnConfig

CONFIG = ModelConfig(
    arch_id="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    qk_norm=True,
    rope_theta=1e6,
    local_per_global=5,
    local_window=1024,
    tie_embeddings=True,
    grad_accum=4,
    # compress every global layer (keeps the 6-layer pattern periodic; the GA
    # search can retain full globals at small scale — see DESIGN.md)
    omniattn=OmniAttnConfig(pattern_period=1, compress_per_period=1),
)
