"""Architecture registry of the PyTorch port: ``get_config(arch_id)`` +
reduced smoke variants. All ten of the reference's architectures are
registered; asking for another raises NotImplementedError."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import (SHAPES, LayerSpec, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig)

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen3-32b": "qwen3_32b",
    "gemma3-4b": "gemma3_4b",
    "granite-34b": "granite_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mamba2-130m": "mamba2_130m",
    "phi-3-vision-4.2b": "phi3_vision",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to PyTorch yet; ported: "
            f"{ARCH_IDS}")
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: few layers (but ≥ one
    full period of the layer pattern), narrow width, small vocab."""
    cfg = get_config(arch_id)
    period = max(cfg.attn_period, cfg.local_per_global + 1, cfg.moe.moe_every, 1)
    n_layers = max(2 * period, 2)
    kw = dict(
        n_layers=n_layers,
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        attn_q_chunk=64,
        attn_kv_chunk=64,
        moe_token_chunk=256,
        fsdp=False,
        remat=False,
        grad_accum=1,
        optimizer_dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 1, head_dim=32)
    if cfg.moe.n_experts:
        kw["moe"] = replace(cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
                            d_ff_expert=64,
                            n_shared_experts=min(cfg.moe.n_shared_experts, 1))
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.frontend_dim:
        kw["frontend_dim"] = 64
    if cfg.num_patches:
        kw["num_patches"] = 8
    if cfg.local_per_global:
        kw["local_window"] = 32
    kw["omniattn"] = replace(cfg.omniattn, sink_tokens=4, recent_tokens=16)
    return replace(cfg, **kw)


__all__ = [
    "ARCH_IDS", "SHAPES", "LayerSpec", "ModelConfig", "MoEConfig", "SSMConfig",
    "ShapeConfig", "get_config", "reduced_config",
]
