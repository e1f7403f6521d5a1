"""Top-level model of the port: embeddings, the modality frontends (stubs:
audio frames or vlm patches projected by the `frontend` parameter), tied
(or untied) head, the training loss (`train_loss`, differentiable) and the
serving entry points:
whole-prompt `prefill` into dense caches, chunked `prefill_resume` and
`decode` over paged or dense KV (with OmniAttn online top-k on paged full
layers), and the speculative `verify` / `verify_commit` pair over paged
KV. Mamba-2 layers carry their per-sequence state through
the same entry points (verify refuses them). MoE layers route through the
OmniPlacement tables each entry point takes (`default_tables()` to start);
the per-layer expert counts come back in the aux. An encoder-only config
(hubert) has no cache: its `prefill` is the whole forward, per-frame
logits through the flash-prefill kernel.

Over several ranks (an `LM` built with a `RankCtx` of world > 1) the
parameters are this rank's shards, cut by `param_cuts`: the FFN and
expert widths and the vocabulary over `model` and expert slots over
`data` as the reference's ParamDef specs say (`param_specs`), attention
by whole heads (`stack.head_layout`) and a Mamba-2 mixer by its SSD heads
and their channels (`stack.mamba_layout`). The embedding is a masked
local lookup summed over `model`; the logits are gathered over `model`,
so sampling sees the full [n, V] row on every rank.
`DevicePlacement.transfer_params` carries one-rank parameters into that
layout."""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.ctx import RankCtx
from repro_torch.models import moe as moe_mod
from repro_torch.models import stack as stack_mod
from repro_torch.models.common import cross_entropy, rms_norm


def _device_int(x, device) -> torch.Tensor:
    """An int or a tensor → a 0-d int32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(x), dtype=torch.int32, device=device)


# The port's copy of the reference's ParamDef specs (src/repro/models/
# stack.py:74-139, lm.py:38-41): per leaf, the mesh axis each dim shards
# over. The reference's FSDP axis ("data" on the replicated big dim under
# cfg.fsdp) is not ported: serving keeps those dims whole.
LAYER_SPECS = {
    "ln_attn": (None,), "wq": (None, "model"), "wk": (None, "model"),
    "wv": (None, "model"), "wo": ("model", None), "bq": ("model",),
    "bk": ("model",), "bv": ("model",), "q_norm": (None,),
    "k_norm": (None,),
    "w_z": (None, "model"), "w_x": (None, "model"), "w_bc": (None, None),
    "w_dt": (None, "model"), "dt_bias": ("model",),
    "conv_x": (None, "model"), "conv_bc": (None, None),
    "A_log": ("model",), "D_skip": ("model",), "ssm_norm": ("model",),
    "out_proj": ("model", None),
    "ln_mlp": (None,), "w1": (None, "model"), "w3": (None, "model"),
    "w2": ("model", None), "router": (None, None),
    "moe_w1": ("data", None, None, "model"),
    "moe_w3": ("data", None, None, "model"),
    "moe_w2": ("data", None, "model", None),
    "shared_w1": (None, "model"), "shared_w3": (None, "model"),
    "shared_w2": ("model", None)}
TOP_SPECS = {"embed": ("model", None), "head": (None, "model"),
             "final_norm": (None,), "frontend": (None, None)}
SLOT_LEAVES = ("moe_w1", "moe_w3", "moe_w2")


@dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    plan: stack_mod.StackPlan
    device: torch.device
    ctx: RankCtx = RankCtx()

    @staticmethod
    def build(cfg: ModelConfig, pattern: Optional[list] = None,
              device=None, ctx: Optional[RankCtx] = None) -> "LM":
        """`device` None → cuda; `ctx` None → one rank. Raises
        NotImplementedError for a family the port does not model. Every
        modelled stack lays out over any `ctx`: attention by
        `stack.head_layout` ('kv', 'wseq' or replicated), Mamba-2 mixers by
        `stack.mamba_layout`, OmniAttn's ring, sliding-window and online
        top-k layers included."""
        plan = stack_mod.StackPlan.from_config(cfg, pattern)
        stack_mod.check_supported(cfg)
        ctx = ctx if ctx is not None else RankCtx.local()
        return LM(cfg, plan, resolve_device(device), ctx)

    def one_rank(self) -> "LM":
        """This model on one rank (the same config, plan and device)."""
        return replace(self, ctx=RankCtx.local())

    # ------------------------------------------------------------------
    def param_defs(self) -> dict:
        """{"layers": [per-layer {name: (shape, init, dtype)}], "embed",
        "final_norm"[, "head"][, "frontend"]: (shape, init, dtype)} with init
        "normal:<std>", "zeros" or "ones": the shapes, scales and dtypes of
        the reference's ParamDefs. A mamba layer carries the reference's
        `mamba_defs` (the SSD mixer) in place of attention. An MoE layer
        (`LayerSpec.use_moe`) carries the router (float32 whatever
        param_dtype is), its slot weights [1, s, ...] and the shared
        experts instead of the dense FFN. The shapes are the whole model's
        over `ctx.ep` slot ranks: slot weights [ep, s, ...] with s =
        `default_slot_count(cfg, ep)`; `param_specs` says how each leaf
        shards."""
        cfg = self.cfg
        D, H, K, h, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
        w, dt = "normal:0.02", cfg.param_dtype
        attn = {"ln_attn": ((D,), "ones", dt), "wq": ((D, H * h), w, dt),
                "wk": ((D, K * h), w, dt), "wv": ((D, K * h), w, dt),
                "wo": ((H * h, D), w, dt)}
        if cfg.qkv_bias:
            attn.update(bq=((H * h,), "zeros", dt), bk=((K * h,), "zeros", dt),
                        bv=((K * h,), "zeros", dt))
        if cfg.qk_norm:
            attn.update(q_norm=((h,), "ones", dt), k_norm=((h,), "ones", dt))
        dense = {}
        if Fd > 0:
            dense = {"ln_mlp": ((D,), "ones", dt), "w1": ((D, Fd), w, dt),
                     "w3": ((D, Fd), w, dt), "w2": ((Fd, D), w, dt)}
        moe = {}
        m = cfg.moe
        if m.n_experts:
            ep = self.ctx.ep
            s, Fe = moe_mod.default_slot_count(cfg, ep), m.d_ff_expert
            moe = {"ln_mlp": ((D,), "ones", dt),
                   "router": ((D, m.n_experts), w, "float32"),
                   "moe_w1": ((ep, s, D, Fe), w, dt),
                   "moe_w3": ((ep, s, D, Fe), w, dt),
                   "moe_w2": ((ep, s, Fe, D), w, dt)}
            if m.n_shared_experts:
                Fsh = m.n_shared_experts * Fe
                moe.update(shared_w1=((D, Fsh), w, dt),
                           shared_w3=((D, Fsh), w, dt),
                           shared_w2=((Fsh, D), w, dt))
        ssm = cfg.ssm
        d_in = ssm.expand * D
        nh = d_in // ssm.head_dim if ssm.head_dim else 0
        N, cw = ssm.d_state, ssm.conv_width
        mamba = {"ln_attn": ((D,), "ones", dt), "w_z": ((D, d_in), w, dt),
                 "w_x": ((D, d_in), w, dt), "w_bc": ((D, 2 * N), w, dt),
                 "w_dt": ((D, nh), w, dt), "dt_bias": ((nh,), "zeros", dt),
                 "conv_x": ((cw, d_in), w, dt),
                 "conv_bc": ((cw, 2 * N), w, dt),
                 "A_log": ((nh,), "ones", dt), "D_skip": ((nh,), "ones", dt),
                 "ssm_norm": ((d_in,), "ones", dt),
                 "out_proj": ((d_in, D), w, dt)}
        d = {"layers": [dict(mamba if sp.kind == "mamba" else attn,
                             **(moe if sp.use_moe else dense))
                        for sp in self.plan.all_specs()],
             "final_norm": ((D,), "ones", dt),
             "embed": ((cfg.vocab_size, D), f"normal:{D ** -0.5}", dt)}
        if not cfg.tie_embeddings:
            d["head"] = ((D, cfg.vocab_size), w, dt)
        if cfg.frontend_dim:
            d["frontend"] = ((cfg.frontend_dim, D), w, dt)
        return d

    def param_specs(self) -> dict:
        """{"layers": [per-layer {name: spec}], top-level name: spec}: each
        spec a tuple of mesh axes ("data", "model" or None) per dim, as
        the reference's sanitized ParamDef specs: a dim that does not
        divide over its axis stays whole (replicated). The reference cuts
        wk / wv by channels even where that splits a head; the port's cut
        is `param_cuts`."""
        defs = self.param_defs()

        def sane(spec, shape):
            return tuple(self.ctx.part_if(a, n) for a, n in zip(spec, shape))
        out = {k: sane(TOP_SPECS[k], v[0]) for k, v in defs.items()
               if k != "layers"}
        out["layers"] = [{k: sane(LAYER_SPECS[k], v[0])
                          for k, v in layer.items()}
                         for layer in defs["layers"]]
        return out

    def param_cuts(self) -> dict:
        """This rank's part of every leaf, in the tree of `param_specs`:
        per dim None (whole) or (start, length). Dims follow the specs at
        the rank's coordinate (an even split), but for the attention and
        Mamba-2 leaves, which are cut by whole heads: wq / bq columns and
        wo rows by the rank's query heads, wk / wv / bk / bv columns by its
        KV heads (`stack.head_layout`: under 'wseq' the one head several
        ranks share; a replicated sublayer whole), and the mixer by its
        SSD heads and their d_in channels (`stack.mamba_layout`)."""
        cfg, ctx = self.cfg, self.ctx
        h = cfg.head_dim
        hl = stack_mod.head_layout(cfg, ctx.tp, ctx.t)
        ml = stack_mod.mamba_layout(cfg, ctx.tp, ctx.t)
        qc, kc = (hl.q0 * h, hl.nq * h), (hl.k0 * h, hl.nk * h)
        ch, hd = (ml.c0, ml.nc), (ml.h0, ml.nh)
        by_head = {"wq": (None, qc), "bq": (qc,), "wo": (qc, None),
                   "wk": (None, kc), "wv": (None, kc), "bk": (kc,),
                   "bv": (kc,), "w_z": (None, ch), "w_x": (None, ch),
                   "conv_x": (None, ch), "ssm_norm": (ch,),
                   "out_proj": (ch, None), "w_dt": (None, hd),
                   "dt_bias": (hd,), "A_log": (hd,), "D_skip": (hd,)}

        def cut(name, spec, shape):
            out = by_head.get(name) or tuple(
                None if ctx.size(a) == 1 else
                (ctx.coord(a) * (n // ctx.size(a)), n // ctx.size(a))
                for a, n in zip(spec, shape))
            return tuple(None if c is None or c == (0, n) else c
                         for c, n in zip(out, shape))
        defs, specs = self.param_defs(), self.param_specs()
        out = {k: cut(k, specs[k], v[0]) for k, v in defs.items()
               if k != "layers"}
        out["layers"] = [{k: cut(k, sl[k], v[0]) for k, v in dl.items()}
                         for dl, sl in zip(defs["layers"], specs["layers"])]
        return out

    def init(self, seed: int = 0) -> dict:
        """Fresh parameters on this LM's device from a seeded generator:
        weights normal(0, std) drawn in float32 and cast to their dtype,
        biases zero, norm scales one. One rank only: over several ranks
        the seed's one-rank model (`one_rank().init(seed)`) is carried into
        each rank's part by `DevicePlacement.place_params`, so one seed is
        one model whatever the layout."""
        if self.ctx.world > 1:
            raise ValueError(
                f"init over {self.ctx.world} ranks: init one_rank() and "
                f"carry it with DevicePlacement.place_params")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))

        def make(shape, init, dtype):
            dt = torch_dtype(dtype)
            if init == "ones":
                return torch.ones(shape, dtype=dt, device=self.device)
            if init == "zeros":
                return torch.zeros(shape, dtype=dt, device=self.device)
            std = float(init.split(":")[1])
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=self.device)
            return x.mul_(std).to(dt)

        defs = self.param_defs()
        params = {k: make(*v) for k, v in defs.items() if k != "layers"}
        params["layers"] = [{k: make(*v) for k, v in layer.items()}
                            for layer in defs["layers"]]
        return params

    def shapes(self) -> dict:
        """The parameter tree as "meta" tensors — shapes and dtypes, no
        storage: a checkpoint restore's template. One rank only: a restore
        into a rank's shards is ROADMAP A16b."""
        if self.ctx.world > 1:
            raise NotImplementedError(
                f"a sharded checkpoint restore over {self.ctx.world} ranks "
                f"(ROADMAP A16b)")
        defs = self.param_defs()
        make = lambda shape, _init, dtype: torch.empty(
            shape, dtype=torch_dtype(dtype), device="meta")
        out = {k: make(*v) for k, v in defs.items() if k != "layers"}
        out["layers"] = [{k: make(*v) for k, v in layer.items()}
                         for layer in defs["layers"]]
        return out

    def default_tables(self) -> Optional[dict]:
        """The round-robin placement's tables over `ctx.ep` slot ranks on
        this LM's device (replicated on every rank), or None without MoE
        layers."""
        m = self.cfg.moe
        if m.n_experts == 0:
            return None
        ep = self.ctx.ep
        s = moe_mod.default_slot_count(self.cfg, ep)
        return moe_mod.tables_from_placement(
            moe_mod.round_robin_placement(m.n_experts, ep, s), s, self.device)

    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        cd = torch_dtype(self.cfg.compute_dtype)
        emb = params["embed"]
        v_loc = emb.shape[0]
        if v_loc == self.cfg.vocab_size:
            return emb[tokens.long()].to(cd)
        # this rank's vocabulary rows: a masked local lookup, summed over
        # `model` (one rank holds each token's row, the others add zeros)
        local = tokens.long() - self.ctx.t * v_loc
        hit = (local >= 0) & (local < v_loc)
        x = emb[local.clamp(0, v_loc - 1)] * hit[..., None].to(emb.dtype)
        return self.ctx.psum_model(x).to(cd)

    def _embed_inputs(self, params, batch: dict):
        """The stack's input rows [B, S', D] in the compute dtype (the
        reference's `_embed_inputs`): audio frames [B, S, frontend_dim] @
        frontend; for a vlm the patches [B, P, frontend_dim] @ frontend in
        front of the token embeddings (S' = P + S); else the token
        embeddings."""
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        if cfg.family == "audio":
            return (batch["frames"].to(cd) @ params["frontend"]).to(cd)
        if cfg.family == "vlm":
            patch = batch["patches"].to(cd) @ params["frontend"]
            return torch.cat([patch.to(cd),
                              self._embed(params, batch["tokens"])], dim=1)
        return self._embed(params, batch["tokens"])

    def _logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        cd = torch_dtype(cfg.compute_dtype)
        w = params["embed"].t() if cfg.tie_embeddings else params["head"]
        out = x.to(cd) @ w
        if w.shape[1] != cfg.vocab_size:
            out = self.ctx.all_gather_model(out, dim=-1)
        return out

    def train_loss(self, params, batch: dict, tables=None):
        """batch {"tokens" [B, S] | "frames" [B, S, frontend_dim] (audio) |
        "tokens" + "patches" [B, P, frontend_dim] (vlm), "labels" [B, S'][,
        "mask" [B, S']]} (S' the stack's rows: P + S for a vlm) → (mean
        token cross-entropy, aux {"moe_counts": [per-MoE-layer [E]]}): the
        whole sequences at positions arange(S') through `stack_apply(mode=
        "train")` — plain differentiable attention (bidirectional where
        cfg.causal is False) and expert products, no kernel, each layer an
        activation checkpoint under cfg.remat. MoE layers route through
        `tables` (default_tables()). One rank only: training over several
        ranks is ROADMAP A16b."""
        if self.ctx.world > 1:
            raise NotImplementedError(
                f"training over {self.ctx.world} ranks (ROADMAP A16b)")
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, _, counts = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="train",
            positions=positions, caches=None, block_tables=None,
            tables=tables, ctx=self.ctx)
        loss = cross_entropy(self._logits(params, x), batch["labels"],
                             batch.get("mask"))
        return loss, {"moe_counts": counts}

    @torch.no_grad()
    def prefill(self, params, tokens=None, *, max_len: int = 0,
                true_len=None, tables=None, patches=None, frames=None):
        """Whole-prompt prefill: the stack's rows at positions arange(S),
        the first `true_len` rows real (a right-padded prompt; default S).
        The frontend input is a keyword: `patches` [B, P, frontend_dim]
        for a vlm (its rows go in front of the tokens', so S = P + S_tok
        and `true_len` and the cache's "pos" count the patch rows),
        `frames` [B, S, frontend_dim] in place of `tokens` for audio.
        `true_len` is an int or a 0-d device tensor, read on the device (the
        last real row is gathered there), so a captured prefill bakes in no
        host value. Every layer attends through the flash-prefill kernel;
        MoE layers route through `tables` (default_tables()). → (dense
        cache {"layers": [{"k","v": [B, W, K, h]}], "pos": true_len} — ring
        layers compressed to sink+recent, full layers padded to max_len — the
        logits of the last real row [B, V], and aux {"moe_counts":
        [per-MoE-layer [E]]}).

        An encoder-only config (hubert) runs the whole forward instead
        (`stack_apply(mode="encode")`: the kernel, bidirectional where
        cfg.causal is False; max_len and true_len unused) and returns
        (None, per-frame logits [B, S, V], aux), as the reference does."""
        batch = {"tokens": tokens, "patches": patches, "frames": frames}
        x = self._embed_inputs(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)
        if self.cfg.encoder_only:
            x, _, _, counts = stack_mod.stack_apply(
                self.cfg, self.plan, params["layers"], x, mode="encode",
                positions=positions, caches=None, block_tables=None,
                tables=tables, ctx=self.ctx)
            return None, self._logits(params, x), {"moe_counts": counts}
        tl = S if true_len is None else true_len
        x, layers, _, counts = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="prefill",
            positions=positions, caches=None, block_tables=None,
            true_len=true_len, max_len=max_len, tables=tables, ctx=self.ctx)
        last = x.index_select(
            1, (_device_int(tl, x.device) - 1).long().reshape(1))[:, 0]
        return ({"layers": layers, "pos": tl}, self._logits(params, last),
                {"moe_counts": counts})

    @cached_property
    def chunked_prefill_support(self) -> tuple:
        """(supported, max_chunk_tokens), as the reference decides it:
        encoder-only configs and the frontend families (vlm, audio) have no
        chunked prefill; otherwise it is exact only when no attention
        layer's prefill mask needs keys its ring has dropped — compressed
        layers qualify only under cfg.prefill_sparse — and a ring bounds
        the chunk to its recent width."""
        cfg = self.cfg
        if cfg.encoder_only or cfg.family in ("vlm", "audio"):
            return False, 0
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
                       block_tables=None, tables=None):
        """Continue a prefill: tokens [1, S] is the next chunk at absolute
        positions cache["pos"] + arange(S); chunk_len marks the real rows of
        a right-padded chunk. cache["pos"] and chunk_len are ints or 0-d
        device tensors: every op reads them from the device, so a captured
        chunk bakes in no host value. With block_tables [1, nb] the
        full-attention entries are the shared arenas, and the chunk's K/V
        is written into its blocks in place; ring layers, and every layer
        of a dense B=1 cache (`alloc_cache(..., 1, max_len)`, block_tables
        None), attend and write their dense caches in place. MoE layers
        route through `tables`; padded rows are routed and take capacity,
        as in the reference. → (cache with "pos" advanced, logits of the
        last real token [1, V], aux {"moe_counts": [per-MoE-layer [E]]})."""
        B, S = tokens.shape
        dev = tokens.device
        off = cache["pos"]
        cl = S if chunk_len is None else chunk_len
        off_t, cl_t = _device_int(off, dev), _device_int(cl, dev)
        x = self._embed(params, tokens)
        positions = off_t + torch.arange(S, device=dev)
        x, _, _, counts = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="prefill",
            positions=positions, caches=cache, block_tables=block_tables,
            true_len=cl_t, pos0=off_t, tables=tables, ctx=self.ctx)
        last = x.index_select(1, (cl_t - 1).long().reshape(1))[:, 0]
        logits = self._logits(params, last)
        return dict(cache, pos=off + cl), logits, {"moe_counts": counts}

    @torch.no_grad()
    def decode(self, params, cache, token, positions, *, block_tables=None,
               token_mask=None, tables=None):
        """One decode step. token [B, 1]; positions [B, 1] (device int
        tensors: each slot's write position). With block_tables [B, nb] the
        cache is paged (shared full-attention arenas + per-slot ring block
        runs); without, it is dense (`alloc_cache`). Each slot's K/V is
        written in place, then attended — with cfg.omniattn.topk_* set, on
        paged full layers only the query-selected top-k of the resident
        blocks. MoE layers route through `tables`. token_mask [B] (live
        rows) weights the online-sparsity stats and the MoE counts. →
        (cache, logits [B, V], aux {"sparsity": [per-layer [4] vectors
        [blocks_scored, blocks_attended, mass_sum, mass_n]], "moe_counts":
        [per-MoE-layer [E]]})."""
        x = self._embed(params, token)
        x, _, sp, counts = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="decode",
            positions=positions, caches=cache, block_tables=block_tables,
            token_mask=token_mask, tables=tables, ctx=self.ctx)
        return cache, self._logits(params, x[:, 0]), {"sparsity": sp,
                                                      "moe_counts": counts}

    @torch.no_grad()
    def verify(self, params, cache, tokens, positions, *, block_tables,
               tables=None, token_mask=None):
        """Speculative multi-token verify: a read-only forward over each
        slot's draft window. tokens [B, S] = [current input token,
        draft_1..draft_{S-1}] per row; positions [B] each slot's next write
        position; paged caches through block_tables [B, nb]. No K/V is
        written: each attention layer stages its rope'd window K/V instead.
        token_mask [B] (live slots) weights the MoE counts of all S window
        rows. → (logits [B, S, V], staged per-layer entries, aux
        {"moe_counts": [per-MoE-layer [E]]})."""
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos2 = positions.to(torch.int32)[:, None] + torch.arange(
            S, device=x.device, dtype=torch.int32)[None]
        x, staged, _, counts = stack_mod.stack_apply(
            self.cfg, self.plan, params["layers"], x, mode="verify",
            positions=pos2, caches=cache, block_tables=block_tables,
            tables=tables, token_mask=token_mask, ctx=self.ctx)
        return self._logits(params, x), staged, {"moe_counts": counts}

    def verify_commit(self, cache, staged, positions, n_write, block_tables):
        """Land the accepted prefix of a `verify` window — n_write [B] rows
        per slot — in the paged caches, in place; see
        stack.stack_verify_commit."""
        return stack_mod.stack_verify_commit(self.cfg, self.plan, cache,
                                             staged, positions, n_write,
                                             block_tables)
