"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).
[arXiv:2106.07447]

Encoder-only: no decode step. The conv feature extractor is a stub, as in
the reference: the model takes precomputed frame embeddings [B, S,
frontend_dim] (`LM.prefill(frames=...)`, `make_batch`), projected by the
`frontend` parameter. Attention is bidirectional (causal=False); the
objective is per-frame classification over the 504-unit codebook.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    frontend_dim=512,
    fsdp=True,
)
