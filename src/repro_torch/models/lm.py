"""Top-level model of the port: embeddings, tied (or untied) head, and the
serving entry points: whole-prompt `prefill` into dense caches, chunked
`prefill_resume` over paged KV, `decode` over paged or dense KV (with
OmniAttn online top-k on paged full layers), and the speculative `verify` /
`verify_commit` pair over paged KV."""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import stack as stack_mod
from repro_torch.models.common import rms_norm


@dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    plan: stack_mod.StackPlan
    device: torch.device

    @staticmethod
    def build(cfg: ModelConfig, pattern: Optional[list] = None,
              device=None) -> "LM":
        """`device` None → cuda. Raises NotImplementedError for a
        configuration a later slice of the port brings."""
        plan = stack_mod.StackPlan.from_config(cfg, pattern)
        stack_mod.check_supported(cfg, plan)
        return LM(cfg, plan, resolve_device(device))

    # ------------------------------------------------------------------
    def param_defs(self) -> dict:
        """name → (shape, init) with init "normal:<std>", "zeros" or "ones",
        the shapes and scales of the reference's ParamDefs."""
        cfg = self.cfg
        D, H, K, h, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
        w = "normal:0.02"
        layer = {"ln_attn": ((D,), "ones"), "wq": ((D, H * h), w),
                 "wk": ((D, K * h), w), "wv": ((D, K * h), w),
                 "wo": ((H * h, D), w)}
        if cfg.qkv_bias:
            layer.update(bq=((H * h,), "zeros"), bk=((K * h,), "zeros"),
                         bv=((K * h,), "zeros"))
        if cfg.qk_norm:
            layer.update(q_norm=((h,), "ones"), k_norm=((h,), "ones"))
        if Fd > 0:
            layer.update(ln_mlp=((D,), "ones"), w1=((D, Fd), w),
                         w3=((D, Fd), w), w2=((Fd, D), w))
        d = {"layer": layer, "final_norm": ((D,), "ones"),
             "embed": ((cfg.vocab_size, D), f"normal:{D ** -0.5}")}
        if not cfg.tie_embeddings:
            d["head"] = ((D, cfg.vocab_size), w)
        return d

    def init(self, seed: int = 0) -> dict:
        """Fresh parameters on this LM's device from a seeded generator:
        weights normal(0, std) drawn in float32 and cast to param_dtype,
        biases zero, norm scales one."""
        dt = torch_dtype(self.cfg.param_dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))

        def make(shape, init):
            if init == "ones":
                return torch.ones(shape, dtype=dt, device=self.device)
            if init == "zeros":
                return torch.zeros(shape, dtype=dt, device=self.device)
            std = float(init.split(":")[1])
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=self.device)
            return (x * std).to(dt)

        defs = self.param_defs()
        params = {k: make(*v) for k, v in defs.items() if k != "layer"}
        params["layers"] = [{k: make(*v) for k, v in defs["layer"].items()}
                            for _ in range(self.plan.n_layers)]
        return params

    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(
            torch_dtype(self.cfg.compute_dtype))

    def _logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        cd = torch_dtype(cfg.compute_dtype)
        if cfg.tie_embeddings:
            return x.to(cd) @ params["embed"].t()
        return x.to(cd) @ params["head"]

    @torch.no_grad()
    def prefill(self, params, tokens, *, max_len: int, true_len=None):
        """Whole-prompt prefill: tokens [B, S] at positions arange(S), the
        first `true_len` rows real (a right-padded prompt; default S).
        Every layer attends through the flash-prefill kernel. → (dense cache
        {"layers": [{"k","v": [B, W, K, h]}], "pos": true_len} — ring layers
        compressed to sink+recent, full layers padded to max_len — and the
        logits of the last real token [B, V])."""
        B, S = tokens.shape
        tl = S if true_len is None else int(true_len)
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        x, layers, _ = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="prefill",
            positions=positions, caches=None, block_tables=None,
            true_len=true_len, max_len=max_len)
        return {"layers": layers, "pos": tl}, self._logits(params,
                                                           x[:, tl - 1])

    @cached_property
    def chunked_prefill_support(self) -> tuple:
        """(supported, max_chunk_tokens), as the reference decides it:
        chunked prefill is exact only when no attention layer's prefill mask
        needs keys its ring has dropped — compressed layers qualify only
        under cfg.prefill_sparse — and a ring bounds the chunk to its recent
        width. (The reference also refuses encoder and frontend families,
        which `check_supported` keeps out of the port.)"""
        cfg = self.cfg
        limit = 1 << 30
        for spec in self.plan.all_specs():
            if spec.kind != "attn":
                continue
            if spec.compressed and not cfg.prefill_sparse:
                return False, 0
            sink, recent = stack_mod.cache_window(cfg, spec)
            if sink or recent:
                limit = min(limit, recent)
        return True, limit

    @torch.no_grad()
    def prefill_resume(self, params, tokens, cache, *, chunk_len=None,
                       block_tables=None):
        """Continue a prefill: tokens [1, S] is the next chunk at absolute
        positions cache["pos"] + arange(S); chunk_len (an int) marks the real
        rows of a right-padded chunk. Full-attention cache entries are the
        shared arenas, reached through block_tables [1, nb]; the chunk's
        K/V is written into its blocks in place. → (cache with "pos"
        advanced, logits of the last real token [1, V]). Ring layers and
        dense caches raise NotImplementedError (not ported yet)."""
        if block_tables is None:
            raise NotImplementedError(
                "dense (non-paged) chunked prefill is not ported yet: pass "
                "block_tables")
        B, S = tokens.shape
        off = int(cache["pos"])
        cl = S if chunk_len is None else int(chunk_len)
        x = self._embed(params, tokens)
        positions = off + torch.arange(S, device=x.device)
        x, _, _ = stack_mod.stack_apply(self.cfg, self.plan, params["layers"],
                                        x, mode="prefill", positions=positions,
                                     caches=cache, block_tables=block_tables,
                                     true_len=cl, pos0=off)
        logits = self._logits(params, x[:, cl - 1])
        return dict(cache, pos=off + cl), logits

    @torch.no_grad()
    def decode(self, params, cache, token, positions, *, block_tables=None,
               token_mask=None):
        """One decode step. token [B, 1]; positions [B, 1] (device int
        tensors: each slot's write position). With block_tables [B, nb] the
        cache is paged (shared full-attention arenas + per-slot ring block
        runs); without, it is dense (`alloc_cache`). Each slot's K/V is
        written in place, then attended — with cfg.omniattn.topk_* set, on
        paged full layers only the query-selected top-k of the resident
        blocks. token_mask [B] (live rows) weights the online-sparsity
        stats. → (cache, logits [B, V], aux {"sparsity": [per-layer [4]
        vectors [blocks_scored, blocks_attended, mass_sum, mass_n]]})."""
        x = self._embed(params, token)
        x, _, sp = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="decode",
            positions=positions, caches=cache, block_tables=block_tables,
            token_mask=token_mask)
        return cache, self._logits(params, x[:, 0]), {"sparsity": sp}

    @torch.no_grad()
    def verify(self, params, cache, tokens, positions, *, block_tables):
        """Speculative multi-token verify: a read-only forward over each
        slot's draft window. tokens [B, S] = [current input token,
        draft_1..draft_{S-1}] per row; positions [B] each slot's next write
        position; paged caches through block_tables [B, nb]. No K/V is
        written: each attention layer stages its rope'd window K/V instead.
        → (logits [B, S, V], staged per-layer entries)."""
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos2 = positions.to(torch.int32)[:, None] + torch.arange(
            S, device=x.device, dtype=torch.int32)[None]
        x, staged, _ = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="verify",
            positions=pos2, caches=cache, block_tables=block_tables)
        return self._logits(params, x), staged

    def verify_commit(self, cache, staged, positions, n_write, block_tables):
        """Land the accepted prefix of a `verify` window — n_write [B] rows
        per slot — in the paged caches, in place; see
        stack.stack_verify_commit."""
        return stack_mod.stack_verify_commit(self.cfg, self.plan, cache,
                                             staged, positions, n_write,
                                             block_tables)
