"""QuantPlane controller: int8 paged KV arenas with their scale plane (the
port's counterpart of src/repro/serving/quant.py).

Full-attention arena blocks store int8 payloads: sealed blocks carry float32
per-block, per-channel scales (kscale/vscale [N, K, h], a nonzero row marks
the block sealed), the unsealed tail per-token scales (ktok/vtok [N, K, bs]).
The kernels dequantize in their tiles with q · where(scale != 0, scale,
tok); the writes are in `models/attention.py` (QuantPlane section).

This module owns the policy: it validates the knobs against the stack,
degrades to None (quant off) when no full-attention layer exists to
quantize, and holds the static residency figures the engines report. At run
time quant is structural — engines and layers branch on the presence of the
"kscale" leaf, never on this object.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models.stack import StackPlan, full_attn_layer, head_layout


@dataclass(frozen=True)
class QuantConfig:
    """Knobs for QuantPlane. bits: payload width; only 8 exists (the arena
    leaf is int8 and the dequant rule assumes the 127-step grid), any other
    value is refused."""
    bits: int = 8


@dataclass(frozen=True)
class QuantPlan:
    """Resolved quantized-arena geometry of one serving stack."""
    bits: int
    n_quant_layers: int         # full-attention layers whose arenas quantize
    payload_bytes_f32: int      # per (block, layer): k+v payload unquantized
    payload_bytes_int8: int     # per (block, layer): k+v payload in int8
    scale_bytes: int            # per (block, layer): the whole scale plane


class QuantController:
    """Per-server owner of the int8-arena policy and residency figures."""

    def __init__(self, plan: QuantPlan):
        self.plan = plan

    @staticmethod
    def from_model(cfg: ModelConfig, plan: StackPlan,
                   qcfg: Optional[QuantConfig], block_size: int, *,
                   paged_kv: bool = True,
                   tp: int = 1) -> Optional["QuantController"]:
        """→ a controller when `qcfg` asks for int8 arenas and the stack has
        a full-attention layer, else None (quant off). Raises ValueError for
        a width other than 8 bits and for quant over the slot-dense layout
        (the scale plane lives on arena blocks). The residency figures are
        one rank's: its arena blocks hold the KV heads
        `head_layout(cfg, tp)` gives it (K / tp under 'kv', the one head
        under 'wseq', every head when the sublayer is replicated), so at
        tp 1 they are the whole model's."""
        if qcfg is None:
            return None
        if qcfg.bits != 8:
            raise ValueError(f"QuantConfig.bits {qcfg.bits} unsupported "
                             "(int8 arenas only)")
        if not paged_kv:
            raise ValueError("QuantPlane requires paged KV arenas "
                             "(paged_kv=True); per-block scales are "
                             "meaningless in the dense slot layout")
        n_quant = sum(1 for s in plan.all_specs() if full_attn_layer(cfg, s))
        if n_quant == 0:
            return None                 # nothing to quantize: quant off
        K, h, bs = head_layout(cfg, tp).nk, cfg.head_dim, block_size
        it = torch_dtype(cfg.compute_dtype).itemsize
        return QuantController(QuantPlan(
            bits=8, n_quant_layers=n_quant,
            payload_bytes_f32=2 * K * bs * h * it,
            payload_bytes_int8=2 * K * bs * h,
            # kscale/vscale [K, h] + ktok/vtok [K, bs], all float32
            scale_bytes=2 * (K * h + K * bs) * 4))

    @staticmethod
    def stats_keys() -> dict:
        """The engine-stats keys this controller fills: static residency
        figures, bytes one arena block pins across the quantized layers,
        int8 (payload + scale plane) against the unquantized payload."""
        return {"quant_layers": 0, "quant_block_bytes": 0,
                "quant_block_bytes_f32": 0}

    def note(self, stats: dict) -> None:
        p = self.plan
        stats["quant_layers"] = p.n_quant_layers
        stats["quant_block_bytes"] = \
            (p.payload_bytes_int8 + p.scale_bytes) * p.n_quant_layers
        stats["quant_block_bytes_f32"] = p.payload_bytes_f32 * p.n_quant_layers

    def compression(self) -> float:
        """Unquantized payload bytes over int8 payload + scale plane, per
        full-attention block."""
        p = self.plan
        return p.payload_bytes_f32 / (p.payload_bytes_int8 + p.scale_bytes)
