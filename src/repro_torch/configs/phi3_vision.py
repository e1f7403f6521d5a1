"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The modality frontend is a stub, as in the reference: the model takes
precomputed patch embeddings [B, num_patches, frontend_dim], projects them
by the `frontend` parameter and puts them in front of the token embeddings
(prefix-LM style; `LM.prefill(patches=...)`, `make_batch`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    frontend_dim=1024,    # CLIP-L/14 hidden size
    num_patches=256,
)
