"""Hardware + model cost models for the cluster simulator.

The simulator reproduces paper Tables 1-2 (Ascend 910C, DeepSeek-R1 INT8).
Constants marked CALIBRATED are fit so the baseline (w/o all) lands near the
paper's 404 QPM / 75 ms TPOT at 6P8-1D32, then held fixed across every other
configuration — the table trends are then *predictions* of the model, not fits.

A copy of the reference's src/repro/sim/hardware.py. These are the paper's
cluster's constants; nothing here describes the H100 the port runs on
(its peaks are in repro_torch.launch.cost).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AscendNodeModel:
    dies_per_node: int = 16           # 8 × 910C, 2 dies each
    die_flops: float = 176e12         # INT8-effective per die
    die_hbm_bw: float = 1.6e12        # bytes/s
    die_hbm_gb: float = 64.0
    interconnect_bw: float = 56e9     # inter-node, bytes/s (per die share)
    mfu_prefill: float = 0.26         # CALIBRATED achievable fraction
    mfu_decode: float = 0.18


@dataclass(frozen=True)
class DeepSeekR1Model:
    n_params: float = 671e9
    n_active: float = 37e9
    bytes_per_param: float = 1.0      # INT8
    n_layers: int = 61
    kv_bytes_per_token: float = 70e3  # MLA compressed KV (c_kv 512 + rope 64)
    moe_layers: int = 58
    n_experts: int = 256
    top_k: int = 8

    def prefill_time(self, n_tokens: int, node: AscendNodeModel,
                     tp_dies: int, moe_imbalance: float = 1.0) -> float:
        """Compute-bound prefill on one TP16 instance."""
        flops = 2.0 * self.n_active * n_tokens
        eff = node.die_flops * node.mfu_prefill * tp_dies
        return flops / eff * moe_imbalance

    # decode kernel efficiency knobs (CALIBRATED once at 6P8-1D32 baseline)
    attn_bw_eff: float = 0.08         # paged-KV gather achieves ~8% of HBM bw
    step_overhead_s: float = 0.004    # launch/sync/sampling per step

    def decode_step_time(self, batch_per_die: float, avg_ctx_eff: float,
                         node: AscendNodeModel, dp_dies: int,
                         moe_imbalance: float = 1.0) -> float:
        """One token for `batch_per_die` seqs on each die of a decode instance.

        t_attn: KV gather, bandwidth-bound at attn_bw_eff × HBM (OmniAttn caps
          avg_ctx_eff at the sink+recent window for compressed layers);
        t_ffn: max(expert compute, per-die expert weight read), scaled by the
          OmniPlacement imbalance ratio B (slowest device gates the step);
        t_comm: MoE all-to-all dispatch+combine over the interconnect.
        """
        kv_bytes = batch_per_die * avg_ctx_eff * self.kv_bytes_per_token
        t_attn = kv_bytes / (node.die_hbm_bw * self.attn_bw_eff)
        weight_bytes = self.n_params * self.bytes_per_param / dp_dies
        t_ffn = max(2.0 * self.n_active * batch_per_die /
                    (node.die_flops * node.mfu_decode),
                    weight_bytes / node.die_hbm_bw) * moe_imbalance
        a2a_bytes = batch_per_die * self.moe_layers * self.top_k * 7168 * 2 * 2
        t_comm = a2a_bytes / node.interconnect_bw
        return t_attn + t_ffn + t_comm + self.step_overhead_s

    def kv_hbm_capacity_seqs(self, node: AscendNodeModel, avg_ctx: float,
                             dp_dies: int, kv_ratio: float = 1.0,
                             weight_frac: float = 0.45) -> int:
        """Max resident sequences per die given HBM after weights."""
        free = node.die_hbm_gb * 1e9 * (1 - weight_frac)
        per_seq = avg_ctx * self.kv_bytes_per_token * kv_ratio
        return max(int(free / per_seq), 1)
