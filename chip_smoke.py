"""Chip smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. build the port's seven CUDA kernels from src/repro_torch/kernels/csrc,
     one nvcc per source, all at once;
  2. hold each kernel against its plain PyTorch version on the card, at the
     reference sweep shapes and at the full-width main-path shapes, in
     float32 and bfloat16, and time kernel, plain version and one library
     call on the same data (`library_ms`, a yardstick only: the port never
     calls it — `scaled_dot_product_attention` for the attention kernels,
     `torch.bmm` over every slot for moe_gmm; block_topk has none);
     block_topk's fused launch (`block_topk_select`: scores, ranking and
     the compacted table) exactly against `select_kv_blocks` on its own
     scores, over tables of 8 to 8,192 entries with tied scores, a
     poisoned null block and absolute, fractional, degrading and
     all-forced budgets, its C grid plan against `topk_cluster_plan`, and
     timed against the eager composition it replaced; and the
     int8 paths (QuantPlane) of paged_decode, paged_prefill and spec_verify
     over arenas written by the port's int8 write path, at the reference
     quant sweep shapes and the full-width shapes, timed against their plain
     versions and dequantize-then-SDPA; paged_decode (split-KV) also over
     phase 5's ring tables in float and int8 and over tables whose late
     splits hold no resident block, sink_decode (split-KV) also over splits
     past the occupancy, W off its 16-slot chunk and wrapped rings, with the
     slots past the occupancy poisoned, moe_gmm (a weight stream spread
     over the card) also with every slot empty, n_valid across row tiles, D
     and F off its tiles, NaN in what it must not read, and in reversed slot
     order bit for bit, flash_prefill (tensor cores) also with
     GQA rows off its tiles and window/sink edges inside a tile,
     paged_prefill and spec_verify (the paged-history tensor-core routine)
     also over long histories in float and int8 (topk-long's last chunk:
     off 3,840 over 288 entries; a verify at off ~4,000); and phase 13's
     shapes (`check_wide_kernels`): the six attention kernels at
     gemma3-4b's (K 4, G 2, h 256) and granite-34b's (K 1, G 48, h 128) in
     float32 and bfloat16, the int8 paths there, the decode routine's
     row-group edges (G 16/17/33 at h 128, 8/9/48 at h 256), block_topk's
     fused select exactly at both and at qwen3-moe's (K 4, G 16), and
     moe_gmm at qwen3-moe's 129 slots of 4,096 x 1,536 (top-8); and phase
     14's jamba shapes in bfloat16 (`check_jamba_kernels`): paged_decode
     and paged_prefill at (K 8, G 8, h 128), paged_decode also over the
     ring tables, flash_prefill over a 4,608-token prompt and sink_decode
     over the 4,224-slot ring, moe_gmm at 17 slots of 8,192 x 24,576
     (top-2) for a decode step and a 128-token chunk; and phase 16's head
     dims (`check_frontend_kernels`): flash_prefill, sink_decode and
     paged_decode (float and int8 pages) at h 80 and 96 in float32 and
     bfloat16 (causal, bidirectional, window + sink, GQA groups at the
     decode routine's row limit and past it; channels 64-79 held on their
     own at h 80), timed at phase 16's shapes; float32 bounds by
     operations are reckoned at the 3xTF32 rate (165 TF/s). It prints each
     library's most registers, its h = 256 instances' and any spill
     (ptxas -v);
  3. serve the bench's shared-prefix workload on full-width qwen2-1.5b
     (28 layers, float32, every layer full attention) through
     `Server.generate`, with the launch counters zeroed just before and
     read just after; check completion, greedy streams equal with prefix
     reuse on and off, pool invariants, one host fetch per decode step and
     kernel launches == chunks x 28 / steps x 28; then the device ms of one
     captured decode step of six slots followed by the fused draw, all
     greedy against one slot sampled, and of the draw alone both ways (the
     threefry Gumbel draw's cost, `draw_cost`);
  4. cross-check reduced-width servers on the card against the same servers
     on the CPU (plain versions): identical greedy streams, logits within
     2e-3 — all-full-attention chunked paged, the default OmniAttn pattern
     in both KV layouts, the mixed stack (window, compressed under
     prefill_sparse, full) chunked in both KV layouts (equal across them
     too), a full/window stack with online top-k (equal
     sparsity stats) and with speculative decoding (the ring commit), and
     int8 arenas alone, with speculation and with online top-k (summary and
     scale invariants on both devices); and the reduced configs of phase
     13's four decoders and phase 14's mamba2 and jamba chunked, qwen3-moe
     also with speculation and with online top-k (`cross_check_archs`);
     and the sampling draw (`cross_check_sampled`): the threefry bits and
     uniforms of 6 x 151,936 card against CPU bit for bit, then seeded
     sampled requests (temperature 0.8-1.5, top-k / top-p on and off) on
     the all-full stack chunked paged and the default pattern whole-prompt
     in both KV layouts, streams equal card vs CPU under phase 5's
     near-tie rule (the margin of masked logits + noise for a sampled
     token);
  5. serve full-width qwen2-1.5b under the default OmniAttn pattern
     (`pattern=None`: 21 layers sink 128 + recent 4096, 7 full) with
     whole-prompt prefill, once with paged KV (flash_prefill + paged_decode)
     and once slot-dense (flash_prefill + sink_decode): 4,400-token prompts
     that wrap the rings, an exact repeat, short and sampled requests; check
     launches == whole prefills x 28 / steps x 28, one host fetch per step,
     pool invariants and greedy streams equal across the two layouts; every
     whole prefill of the measured runs replays a "prefill.full" graph (one
     per prompt bucket, the warm-up met both) and first tokens replay
     "prefill.first"; each layout served again with capture=False on the
     same weights, every stream (the sampled one too) equal under the
     near-tie rule; host and wall ms of one whole 16- and 4,400-token
     prefill, captured against eager in turns; TTFT of the 16-token
     prompts; the graph pool's bytes;
  6. serve full-width qwen2-1.5b (28 full layers) with OmniAttn online top-k
     on six 3,968-token prompts: top-k off, topk_frac 0.25, the same with
     the attention mass measured, and a budget of the table width - 1 (the
     kernel runs, every block is kept); check block_topk launches == steps x
     28, streams of the last equal top-k off bit for bit, the attended share
     matches the budget, mass kept in (0, 1], one host fetch per step, pool
     and summary invariants;
  7. serve full-width qwen2-1.5b with SpecPlane speculative decoding (k=4)
     and without, on repeated-phrase prompts plus one sampled request;
     check streams equal across the two runs, spec_verify launches ==
     verify steps x 28, one host fetch per step, invariants;
  8. once the earlier phases' servers are freed, serve full-width
     qwen2-moe-a2.7b (24 MoE layers: 60 routed experts top-4 + 4 shared,
     float32, ~57 GB of weights) with phase 3's server knobs and traffic
     (16 new tokens each) and OmniPlacement's monitor every 4 decode
     rounds: (a) through `Server.generate`, checking completion, one host
     fetch per step, pool invariants, launches (moe_gmm == 3 x 24 x
     (chunks + steps)), >= 4 placement ticks whose drained counts each sum
     to top_k x 24 x the decode tokens since the last, and no rebalance at
     ep = 1; (b) the same traffic through add_request/step with a forced
     migration that reverses the slot order halfway through decode: every
     greedy stream equal to (a)'s bit for bit; (c) layer 0's moe_ffn on a
     real prefill chunk's hidden states against the dense oracle;
  9. serve full-width qwen2-1.5b on int8 arenas (`quant=QuantConfig()`):
     (a) phase 3's traffic with 24 new tokens and a sampled request through
     `Server.generate`, checking completion, one host fetch per step, pool,
     summary and scale invariants, int8 launches == chunks x 28 / steps x
     28 and the block-bytes reckoning (int8 13,568 / float32 35,840 per
     layer), with the float32 server's streams reported beside; (b) phase
     7's prompts without and with SpecConfig(k=4) (streams equal, int8
     spec_verify launches == verify steps x 28); (c) (a)'s traffic on a pool
     cut until a request is preempted (greedy streams equal (a)'s bit for
     bit through the int8 sidecar);
 10. serve phases 3 (prefix reuse on), 7 (speculation on) and 9 (a) again
     with `DevicePlacement.of(dev, capture=False)`: greedy streams equal
     the captured runs' bit for bit, the launch counts obey the same
     formulas, and the largest logits difference of one decode step (one
     verify window for phase 7) and of one prefill chunk, replayed from a
     captured graph against eager on the same inputs, is reported beside
     TPOT and host seconds per decode round both ways, and host ms and
     aten ops per prefill chunk both ways (the captured side on a new
     server with the same weights, knobs and warm-up);
 11. serve full-width qwen2-1.5b under pattern=None with prefill_sparse
     (21 compressed layers, sink 128 + recent 4096, and 7 full) on phase
     5's traffic, (a) chunked (chunks of 128) over paged KV, (b) chunked
     over dense KV (`paged_kv=False`) and (c) whole-prompt: completion,
     pool invariants, one host fetch per decode step, paged_prefill ==
     chunks x 7 in (a), "prefill.chunk" replayed in (a) and (b), greedy
     streams equal across (a), (b) and (c) (phase 5's near-tie rule), and
     the device time of one chunk's private-leaf copies;
 12. serve full-width qwen2-1.5b (28 full layers) with two prefill and two
     decode instances over one arena (the watchdog on, ten retries per
     request) under FaultPlane chaos: (a) phase 3's prompts with 24 new
     tokens and two sampled requests, (b) phase 7's prompts with
     SpecConfig(k=4), (c) (a) on int8 arenas; each first fault-free (its
     server steps set the horizon, about half), then under seeds (1, 2, 5)
     for (a) and (1, 2) for (b) and (c), each on a new warmed server:
     every request completes with stop or length, every stream (greedy and
     sampled) equals the fault-free run's, streamed deltas equal the
     outputs, each corruption is condemned as exactly its block, the pool's
     invariants and summaries hold with only prefix-store keys left and
     the quarantined blocks counted, one host fetch per decode step,
     paged_prefill == chunks x 28 and paged_decode == (steps - verifies) x
     28 over both engines of a kind, every engine's entries replayed, and
     (a)'s kinds kill_prefill, kill_decode, kv_corrupt and kv_lost each
     fired; (a)'s fault-free greedy streams equal phase 3's 1P/1D streams.
     It reports the summary scan's device time (float32, int8), the ms of
     each recover_corruption, walls fault-free / chaos, retries,
     quarantined blocks, swept handoffs and re-prefilled chunks;
 13. serve the reference's other four decoders at full width, one model's
     weights (seed 0) alive at a time (`serve_archs`): gemma3-4b at full
     width, 6 of its 34 layers (one whole period of its 5 local : 1
     global pattern: 5 window rings of 1,024, 1 full; h 256) on six
     1,536-2,048-token prompts with a shared 512-token prefix and two
     sampled requests, (a) chunked paged with prefix reuse on and off
     (greedy streams equal), online top-k at 0.25 on (a)'s model, (b)
     whole-prompt on the slot-dense layout, (c) speculation on and off on
     phase 7's prompts twice over, (d) int8 arenas plain and with
     speculation, (e) the default pattern paged and dense — every
     comparison equal up to phase 5's near-tie rule; qwen3-32b and
     granite-34b at 8 layers through phases 3 and 7 (phase 7's prompts
     twice over), granite also whole-prompt on the slot-dense layout and
     with online top-k at 0.5; qwen3-moe-235b-a22b at 5 layers through
     phases 7 (at a capacity that drops nothing; the serving capacity's
     differing streams reported), 6 and 8 — each run's launch counts
     (paged_prefill == chunks x full layers, paged_decode == steps x
     layers, ...) and its hot-loop replays asserted. The kernels line's
     `h256`, `g48` and `qwen3moe` records carry these shapes' phase 2
     times and phase 13 launches;
 14. serve the SSM and hybrid stacks (`serve_mamba2`, `serve_jamba`):
     mamba2-130m as published (24 Mamba-2 layers, float32, no kernel of
     the port: its launches stay 0) on (a) phase 3's traffic chunked
     paged, prefix reuse on and off (streams equal), captured and with
     capture=False (streams bit for bit; one decode step's and one
     chunk's logits replayed against eager: difference 0; their device
     time split into the SSD, the GEMMs and the rest), (b) topk-long's
     six 3,968-token prompts chunked paged against whole-prompt
     slot-dense (phase 5's near-tie rule), (c) speculation refused and
     int8 arenas degraded to float ((a)'s streams), (d) FaultPlane on
     phase 12's two prefill and two decode instances and phase 12's
     traffic (a), fault-free then seed 1 (`serve_ssm_chaos`): the chaos
     streams, greedy and sampled, equal the fault-free streams, every
     kv_corrupt skipped (no summary plane), injected and skipped per
     kind printed; then
     jamba-1.5-large-398b at full width in bfloat16, its first 5 layers
     (m, m+moe, m, m+moe, attn; ~50 GB), on (d) phase 3's traffic with
     phase 8's monitor knobs, reuse on and off (streams equal) and on
     int8 arenas: paged_prefill == chunks x 1, paged_decode == steps x
     1, moe_gmm == 3 x 2 x (chunks + steps), each drain == top_k x 2 x
     the decode tokens since the last; (e) the default pattern (its
     attention layer sink 128 + recent 4,096) on phase 5's traffic,
     whole-prompt, paged and slot-dense (flash_prefill, paged_decode over
     the ring runs, sink_decode; streams equal under phase 5's rule with
     a bfloat16 limit). The kernels line's `jamba` records carry phase
     2's bfloat16 times and phase 14's launches.
 15. train on the card (`train_phase`; no train step launches any of the
     seven kernels: the launch counters stay put): (a) qwen2-1.5b as
     published (bfloat16, float32 moments, remat) through
     `repro_torch.launch.train.main` at its defaults (batch 8, seq 128,
     lr 3e-4): a preemption drill (6 steps, a checkpoint every 4, exit 42
     after step 4), its relaunch from step 4 and an uninterrupted run —
     the resumed steps equal the uninterrupted ones (bit for bit, or
     within P15_RESUME_TOL), the loss falls; step ms, tokens/s, peak
     memory, checkpoint bytes, save and restore seconds; (b) the step-4
     checkpoint restored bit-equal to the saved parameters and served
     on phase 3's traffic (bfloat16) with streams equal to the in-memory
     parameters'; (c) mamba2-130m as published (batch 4, seq 256, 6
     steps): the loss falls, one step's loss equal with remat on and
     off; (d) qwen2-moe-a2.7b at its published widths and grad_accum 2,
     cut to P15_MOE_LAYERS layers, 3 steps: router and expert gradients
     nonzero; (e) one float32 step of reduced qwen2-1.5b, card against
     CPU within P15_CPU_TOL.
 16. run the frontend families at full width in float32 through `LM`
     (`frontend_phase`; the Server refuses them, as the reference's
     does): (a) phi-3-vision-4.2b as published (32 layers, h 96, every
     layer full attention): two prompts of 256 patch embeddings + 768
     tokens, each prefilled alone (flash_prefill == 32 a prefill), then
     decoded together for 16 greedy steps from position 1,024
     (sink_decode == 32 a step); the first step's logits equal one
     prefill of the patches + 769 tokens within 2e-3, and zero patches
     change the logits; (b) hubert-xlarge as published (48 layers, h 80,
     bidirectional): two 1,024-frame clips in one batch through
     `LM.prefill(frames=...)` → per-frame logits [2, 1,024, 504]
     (flash_prefill == 48 a forward), equal to the same forward through
     flash_prefill_plain on the card within 2e-3; (c) the reduced configs
     with h 80 / 96, card against CPU (logits 2e-3, a train step's loss
     and gradient norm within P15_CPU_TOL, no launch in it); (d)
     launch/train.py on hubert-xlarge in bfloat16, batch 2 x 512 frames,
     2 steps, no kernel launched. The kernels line's `h80` / `h96` records
     carry phase 2's times at these shapes and phase 16's launches
     (paged_decode's with launches 0 and "on_path": false).
 17. serve qwen2-moe-a2.7b at full width over (tp 2, ep 2) = four ranks,
     one process each (`dist_phase`; float32, P17_LAYERS of 24 layers,
     every attention layer full): with four cards visible over NCCL, one
     card a rank, the hot loops captured; with one card the four ranks
     share cuda:0 over gloo and every placement is built with
     capture=False (gloo collectives cannot be captured; NCCL refuses
     two ranks on one GPU). The one-rank port Server on the same card
     and seed-0 weights serves first; then each rank builds the seed's
     whole one-rank model in turn, cuts its shard with `transfer_params`
     and frees the rest. Every rank serves phase 3's mix (8 prompts, 16
     greedy tokens) (a) chunked and (b) whole-prompt, streams equal to
     the one-rank Server's on every rank, and (c) chunked with a forced
     migration of two slots between the EP ranks mid-decode (streams
     equal (a)'s; its seconds and the bytes moved between ranks); then
     QuantPlane and SpecPlane over the ranks: (d) int8 arenas on (a)'s
     traffic, (e) SpecConfig(k=4) on four of phase 7's drafting prompts
     and its sampled request, and (f) both, the
     speculating runs on both sides at a capacity factor that drops
     nothing (P17_SPEC_CF) — every rank's streams equal the one-rank
     Server's (int8 up to a near-tie below P17_INT8_TIE), the spec
     counters and quant figures equal on every rank, a rank's
     quant_block_bytes half the one rank's, rank 0's int8 / verify /
     moe_gmm launches made, the capacity cut's drops printed; (g)
     FaultPlane over the ranks: phase 12's two-prefill, two-decode
     server at P17_SPEC_CF, fault-free then seed 1 (`chaos_world`):
     every rank's fault-free streams equal the one-rank Server's
     fault-free streams, the chaos streams equal them on every rank, and
     every rank's plane fired the same faults; per rank the faults
     injected and skipped, the blocks quarantined, the host ms of each
     recover_corruption (its world reduction of the corruption mask
     included) and one `pmax_world` of the mask timed alone. It
     prints the transport and why, TTFT, TPOT, the all_to_all ms a MoE
     layer and the collectives' share of rank 0's decode round (timed
     alone at the step's shapes), each rank's peak memory. Phase 2 of
     this phase (`check_rank_local_kernels`) holds paged_decode,
     paged_prefill, flash_prefill, moe_gmm and spec_verify, and the int8
     paths of paged_decode, paged_prefill and spec_verify, to their plain
     versions at one rank's shapes; the kernels line's `tp2ep2` (and
     moe_gmm's `tp2ep2_verify`) records carry those times and rank 0's
     launches.
Every serving phase of 3, 5-9 and 11-14 serves under CUDA-graph capture, the
default on `cuda`: the decode step, the verify step, the prefill chunk, the
whole-prompt prefill and the first-token draw are hot-loop entries
(`DevicePlacement.hot_loop`), one graph per key replayed each step, chunk,
prompt or round, and the launch counts above advance by the replays. Each phase asserts that its decode entry (the verify entry with
speculation on, and in phases 3, 8, 9 and 11 the chunk entry) replayed in
its measured run and reports keys, eager calls, captures and replays per
entry and the bytes of the graph pool.
The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the per-kernel JSON record; the card's name and power limit
(nvidia-smi) come before that. Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
REPLACES = {"paged_decode": "src/repro/kernels/paged_decode.py:99",
            "paged_prefill": "src/repro/kernels/paged_prefill.py:131",
            "flash_prefill": "src/repro/kernels/flash_prefill.py:73",
            "sink_decode": "src/repro/kernels/sink_decode.py:63",
            "spec_verify": "src/repro/kernels/spec_verify.py:123",
            "block_topk": "src/repro/kernels/block_topk.py:73",
            "moe_gmm": "src/repro/kernels/moe_gmm.py:49"}
HBM_BYTES_S = 3.35e12                        # H100 SXM HBM3
# float32 products at float32 accuracy: the tensor cores' 3xTF32 split
# (three TF32 products per float32 product) at the dense TF32 peak of 495
# TF/s gives 165 TF/s, above the 67 TF/s of float32 outside tensor cores,
# so the least time of float32 work is reckoned at this rate
F32_3XTF32_FLOPS = 495e12 / 3
PEAK_FLOPS = {torch.float32: F32_3XTF32_FLOPS,
              torch.bfloat16: 989e12}        # bf16 tensor cores, dense
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
TOL_DENSE = {torch.float32: dict(rtol=2e-5, atol=2e-5),   # flash_prefill,
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}  # sink_decode
# main-path shapes of phases 2 and 5 (full-width qwen2-1.5b, pattern=None,
# max_len 4608): one whole 4608-token prompt; six decode slots over the
# 4224-slot ring (sink 128 + recent 4096) and the 4608-slot full cache
FLASH_MAIN_S = 4608
SINK_MAIN = ((4224, [1, 130, 2049, 4224, 4401, 4500]),
             (4608, [1, 130, 2049, 4224, 4401, 4608]))
# sink_decode's split-KV edges (B, W, G, h, t): splits past the occupancy,
# W off the 16-slot chunk, wrapped rings (t > W), a one-chunk cache
SINK_EDGES = ((6, 4224, 6, 128, [1] * 6), (4, 100, 1, 64, [1, 99, 100, 250]),
              (4, 4223, 6, 128, [1, 17, 4223, 9000]),
              (3, 4223, 1, 32, [4222, 16, 5000]), (2, 16, 6, 128, [1, 40]),
              (4, 4608, 6, 128, [4608, 4097, 2, 4609]))
P5_MAX_LEN, P5_LONG, P5_SHORT = 4608, 4400, 16
# phase 5's whole prefills timed captured against eager: reps of (a, b, b, a)
P5_TURNS = 4
# phase-5 paged decode over the ring block runs: six slots of 264 blocks
# (sink 128 + recent 4096 at bs 16), four wrapped long prompts, two short
RING_MAIN = (264, [4224, 4224, 4224, 4224, 20, 20])
# phases 6-7 (full-width qwen2-1.5b, 28 full layers): six 3,968-token
# prompts decoding 12 tokens over a 256-wide table; six 256-token
# repeated-phrase prompts verified in windows of k + 1 = 5
P6_PROMPT, P6_NEW, P6_MAX_LEN, P6_BLOCKS = 3968, 12, 4608, 2016
TOPK_MAIN = (256, [3968, 3970, 3972, 3975, 3978, 3980])
SPEC_MAIN = (32, [256, 262, 270, 281, 295, 304])
SPEC_LONG = (256, [3990, 3995, 4000, 4003, 4007, 4010])
# topk-long's last prefill chunk: 128 tokens over a 3,840-token history in a
# 288-entry table (max_len 4608 at bs 16)
PREFILL_LONG = (288, 3840)
P7_PHRASE, P7_REPEAT, P7_NEW, P7_K = 32, 8, 48, 4
# phase 8 (full-width qwen2-moe-a2.7b, 60 experts top-4, d_ff_expert 1408):
# moe_gmm's (capacity C, D, F, tokens) at decode (6 slots: capacity 8) for
# w1/w3 and for w2, and for a 128-token prefill chunk (capacity 24)
MOE_DECODE, MOE_DECODE_W2 = (8, 2048, 1408, 6), (8, 1408, 2048, 6)
MOE_PREFILL = (24, 2048, 1408, 128)
# moe_gmm's edges (S, C, D, F, n_valid): every slot empty, n_valid across
# 16- and 32-row tiles, D and F off every tile (plain loads) and off the
# tiles with 16-byte rows
MOE_EDGES = ((8, 24, 256, 192, (0,) * 8),
             (6, 24, 2048, 1408, (16, 17, 24, 0, 1, 15)),
             (5, 40, 50, 130, (16, 17, 24, 40, 0)),
             (4, 24, 48, 136, (17, 24, 0, 3)), (3, 70, 64, 64, (70, 33, 64)))
P8_NEW, P8_LAYERS = 16, 24
# phase 9 (QuantPlane, full-width qwen2-1.5b on int8 arenas): phase 3's
# traffic with 24 new tokens, so every stream crosses a block boundary in
# decode; (c) cuts the pool from 320 blocks to P9_PREEMPT_BLOCKS (and lower
# until a request is preempted)
P9_NEW, P9_PREEMPT_BLOCKS = 24, 96

def ptxas_report(build_log: str) -> dict:
    """ptxas's -v report of one library → {kernel: {"registers",
    "spill_bytes", "stack_bytes"}} (the build log of `build.build_all`;
    empty for a cached library)."""
    import re
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {"registers": 0, "spill_bytes": 0, "stack_bytes": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur]["stack_bytes"] = int(m.group(1))
            out[cur]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event device time of one call, L2 flushed before each launch
    (the serving path finds each layer's arena cold: 28 layers of KV exceed
    the 50 MB L2). Before each timed call the device is held busy by
    `torch.cuda._sleep` for twice the call's host enqueue time (measured in
    the warm-up) plus 0.5 ms, so the window between the two events holds
    the call's device work and not the host's Python and launch overhead."""

    def __init__(self, dev, reps=20, warmup=3):
        self.reps, self.warmup = reps, warmup
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        b.synchronize()
        self.cycles_per_ms = 1e6 / a.elapsed_time(b)

    def __call__(self, fn, reps=None) -> float:
        host_s = 0.0
        for _ in range(self.warmup):
            t = time.perf_counter()
            fn()
            host_s = max(host_s, time.perf_counter() - t)
            torch.cuda.synchronize()
        sleep = int(self.cycles_per_ms * (2e3 * host_s + 0.5))
        times = []
        for _ in range(reps or self.reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(sleep)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


# ---- phase 2: kernels against their plain versions -------------------
def decode_inputs(dev, dtype, B, K, G, h, bs, nb, N, lens, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, h), generator=g, device=dev).to(dtype)
    kp = torch.randn((N, K, bs, h), generator=g, device=dev).to(dtype)
    vp = torch.randn((N, K, bs, h), generator=g, device=dev).to(dtype)
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    tables = perm[:B * nb].reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def prefill_inputs(dev, dtype, B, K, S, G, h, bs, nb, N, off, cl, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, S * G, h), generator=g, device=dev).to(dtype)
    kn = torch.randn((B, K, S, h), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, K, S, h), generator=g, device=dev).to(dtype)
    kp = torch.randn((N, K, bs, h), generator=g, device=dev).to(dtype)
    vp = torch.randn((N, K, bs, h), generator=g, device=dev).to(dtype)
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    tables = perm[:B * nb].reshape(B, nb).to(torch.int32)
    off = torch.tensor(off, dtype=torch.int32, device=dev)
    cl = torch.tensor(cl, dtype=torch.int32, device=dev)
    return q, kn, vn, kp, vp, tables, off, cl


def block_bytes(kp):
    """Bytes one resident block moves per kv head, K and V together: the
    payload, plus on int8 arenas the block's float32 scale rows (h seal
    scales + bs token scales, each for K and V)."""
    bs, h = kp.shape[2], kp.shape[3]
    nbytes = 2 * bs * h * kp.element_size()
    if kp.dtype == torch.int8:
        nbytes += 2 * (h + bs) * 4
    return nbytes


def decode_bound(q, kp, tables, lens):
    B, K, G, h = q.shape
    bs, e = kp.shape[2], q.element_size()
    ln = lens.cpu().numpy().astype(np.int64)
    blocks = np.minimum(-(-ln // bs), tables.shape[1]).sum()
    nbytes = (2 * q.numel() * e + tables.numel() * 4 + lens.numel() * 4
              + int(blocks) * K * block_bytes(kp))
    flops = 4 * K * G * h * int(ln.sum())
    return bound(nbytes, flops, q.dtype)


def prefill_bound(q, kn, kp, tables, off, cl):
    B, K, SG, h = q.shape
    S = kn.shape[2]
    G = SG // S
    bs, e = kp.shape[2], q.element_size()
    o = off.cpu().numpy().astype(np.int64)
    c = cl.cpu().numpy().astype(np.int64)
    blocks = np.minimum(-(-o // bs), tables.shape[1]).sum()
    i = np.arange(S)
    visible = sum(int(G * (ob + np.minimum(i + 1, cb)).sum())
                  for ob, cb in zip(o, c))               # keys per row, summed
    nbytes = (2 * q.numel() * e + 2 * kn.numel() * e + tables.numel() * 4
              + 8 * B + int(blocks) * K * block_bytes(kp))
    flops = 4 * K * h * visible
    return bound(nbytes, flops, q.dtype)


def bound(nbytes, flops, dtype):
    t_mem = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops
            else "operations", nbytes, flops)


def sdpa_decode(q, kp, vp, tables, lens):
    """One scaled_dot_product_attention call on pre-gathered KV (gather and
    GQA head expansion happen outside the timed call)."""
    import torch.nn.functional as F
    B, K, G, h = q.shape
    nb, bs = tables.shape[1], kp.shape[2]
    tl = tables.long()
    k = kp[tl].permute(0, 2, 1, 3, 4).reshape(B, K, nb * bs, h)
    v = vp[tl].permute(0, 2, 1, 3, 4).reshape(B, K, nb * bs, h)
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    qh = q.reshape(B, K * G, 1, h)
    mask = (torch.arange(nb * bs, device=q.device)[None]
            < lens[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def sdpa_prefill(q, kn, vn, kp, vp, tables, off, cl):
    """The same for a prefill chunk: gathered history ++ chunk keys, with
    the resident/causal/real-row mask."""
    import torch.nn.functional as F
    B, K, SG, h = q.shape
    S = kn.shape[2]
    G = SG // S
    nb, bs = tables.shape[1], kp.shape[2]
    L = nb * bs
    tl = tables.long()
    k = torch.cat([kp[tl].permute(0, 2, 1, 3, 4).reshape(B, K, L, h), kn],
                  dim=2).repeat_interleave(G, dim=1)
    v = torch.cat([vp[tl].permute(0, 2, 1, 3, 4).reshape(B, K, L, h), vn],
                  dim=2).repeat_interleave(G, dim=1)
    qh = q.reshape(B, K, S, G, h).permute(0, 1, 3, 2, 4).reshape(
        B, K * G, S, h)
    dev = q.device
    o, c = off.long()[:, None, None], cl.long()[:, None, None]
    pos = o + torch.arange(S, device=dev)[None, :, None]      # [B, S, 1]
    th = torch.arange(L, device=dev)[None, None, :]
    tc = torch.arange(S, device=dev)[None, None, :]
    mask = torch.cat([(th < o).expand(B, S, L),
                      (tc < c) & (o + tc <= pos)], dim=2)[:, None]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def check_kernels(dev, timer, log):
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    rec = {"paged_decode": {}, "paged_prefill": {}}

    def cmp(name, got, want, dtype, rows=None):
        got, want = got.float(), want.float()
        if rows is not None:
            got, want = rows(got), rows(want)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **TOL[dtype], msg=name)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # the reference sweep shapes (tests/test_kernels.py) ...
        for bs, nb, G in ((8, 6, 1), (8, 6, 4), (16, 4, 1), (16, 4, 4),
                          (16, 1, 4)):
            a = decode_inputs(dev, dtype, 3, 2, G, 32, bs, nb, 24,
                              [1, max(nb * bs // 2 - 3, 1), nb * bs], 1)
            err = cmp("paged_decode sweep", paged_decode(*a),
                      paged_decode_plain(*a), dtype)
            log.append(f"paged_decode {dn} bs={bs} nb={nb} G={G} h=32 "
                       f"max_abs_err={err:.3g}")
        for bs, S, G, kw in ((8, 8, 1, {}), (16, 8, 4, {}), (8, 32, 4, {}),
                             (16, 8, 4, dict(window=24)),
                             (8, 8, 4, dict(window=24, sink=8))):
            a = prefill_inputs(dev, dtype, 2, 2, S, G, 32, bs, 5, 24,
                               [0, 5 * bs // 2 - 3], [S, max(S - 3, 1)], 2)
            cl = a[-1].cpu().tolist()

            def real(x, cl=cl, G=G):
                return torch.cat([x[b, :, :cl[b] * G].reshape(-1)
                                  for b in range(x.shape[0])])
            err = cmp("paged_prefill sweep", paged_prefill(*a, **kw),
                      paged_prefill_plain(*a, **kw), dtype, rows=real)
            log.append(f"paged_prefill {dn} bs={bs} S={S} G={G} {kw} h=32 "
                       f"max_abs_err={err:.3g}")
        # ... and the full-width main-path shapes: K=2, G=6, h=128, bs=16
        dec = decode_inputs(dev, dtype, 6, 2, 6, 128, 16, 32, 321,
                            [1, 17, 100, 255, 448, 512], 3)
        main_err = {}
        err = main_err["paged_decode"] = cmp(
            "paged_decode main", paged_decode(*dec),
            paged_decode_plain(*dec), dtype)
        log.append(f"paged_decode {dn} main B=6 K=2 G=6 h=128 bs=16 nb=32 "
                   f"max_abs_err={err:.3g}")
        pre = prefill_inputs(dev, dtype, 1, 2, 128, 6, 128, 16, 32, 321,
                             [384], [128], 4)
        pad = prefill_inputs(dev, dtype, 1, 2, 128, 6, 128, 16, 32, 321,
                             [200], [100], 5)
        err = main_err["paged_prefill"] = cmp(
            "paged_prefill main", paged_prefill(*pre),
            paged_prefill_plain(*pre), dtype)
        err2 = cmp("paged_prefill padded", paged_prefill(*pad),
                   paged_prefill_plain(*pad), dtype,
                   rows=lambda x: x[:, :, :100 * 6])
        if not torch.isfinite(paged_prefill(*pad)).all():
            raise AssertionError("padded prefill rows are not finite")
        log.append(f"paged_prefill {dn} main S=128 SG=768 off=384 cl=128 "
                   f"max_abs_err={err:.3g}; off=200 cl=100 "
                   f"max_abs_err={err2:.3g}")
        for name, kern, plain, args, bnd, lib in (
                ("paged_decode", paged_decode, paged_decode_plain, dec,
                 decode_bound(dec[0], dec[1], dec[3], dec[4]),
                 sdpa_decode(*dec)),
                ("paged_prefill", paged_prefill, paged_prefill_plain, pre,
                 prefill_bound(pre[0], pre[1], pre[3], pre[5], pre[6],
                               pre[7]), sdpa_prefill(*pre))):
            # the yardstick computes the same function
            B, K = args[0].shape[:2]
            h = args[0].shape[-1]
            lo = lib()
            if name == "paged_prefill":
                lo = lo.reshape(B, K, 6, -1, h).permute(0, 1, 3, 2, 4)
            lib_err = float((lo.reshape(-1).float()
                             - plain(*args).float().reshape(-1)).abs().max())
            log.append(f"{name} {dn} main: sdpa vs plain max_abs_err="
                       f"{lib_err:.3g}")
            rec[name][dn] = {
                "max_abs_err": main_err[name],
                "ms": timer(lambda: kern(*args)),
                "plain_ms": timer(lambda: plain(*args)),
                "library_ms": timer(lib),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "bytes": bnd[2], "flops": bnd[3]}
        # phase 8's attention shape (qwen2-moe-a2.7b: K=16, G=1, h=128)
        mdec = decode_inputs(dev, dtype, 6, 16, 1, 128, 16, 32, 321,
                             [1, 17, 100, 255, 448, 512], 12)
        mpre = prefill_inputs(dev, dtype, 1, 16, 128, 1, 128, 16, 32, 321,
                              [384], [128], 13)
        for name, kern, plain, args, bnd, lib in (
                ("paged_decode", paged_decode, paged_decode_plain, mdec,
                 decode_bound(mdec[0], mdec[1], mdec[3], mdec[4]),
                 sdpa_decode(*mdec)),
                ("paged_prefill", paged_prefill, paged_prefill_plain, mpre,
                 prefill_bound(mpre[0], mpre[1], mpre[3], mpre[5], mpre[6],
                               mpre[7]), sdpa_prefill(*mpre))):
            err = cmp(f"{name} moe shape", kern(*args), plain(*args), dtype)
            rec[name][f"{dn}_moe"] = {
                "max_abs_err": err, "ms": timer(lambda: kern(*args)),
                "plain_ms": timer(lambda: plain(*args)),
                "library_ms": timer(lib), "bound_ms": bnd[0],
                "bound_by": bnd[1], "bytes": bnd[2], "flops": bnd[3]}
            log.append(f"{name} {dn} moe shape K=16 G=1 h=128 "
                       f"max_abs_err={err:.3g}")
        # topk-long's last chunk, where paged_prefill's device seconds are
        nbl, offl = PREFILL_LONG
        lng = prefill_inputs(dev, dtype, 1, 2, 128, 6, 128, 16, nbl, nbl + 1,
                             [offl], [128], 15)
        err = cmp("paged_prefill long", paged_prefill(*lng),
                  paged_prefill_plain(*lng), dtype)
        log.append(f"paged_prefill {dn} long S=128 SG=768 off={offl} cl=128 "
                   f"nb={nbl} max_abs_err={err:.3g}")
        bnd = prefill_bound(lng[0], lng[1], lng[3], lng[5], lng[6], lng[7])
        rec["paged_prefill"][f"{dn}_long"] = {
            "max_abs_err": err, "ms": timer(lambda: paged_prefill(*lng)),
            "plain_ms": timer(lambda: paged_prefill_plain(*lng)),
            "library_ms": timer(sdpa_prefill(*lng)),
            "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2],
            "flops": bnd[3]}
        del lng
        # split-KV edges: splits past the residency, one-block rows, a
        # poisoned null block behind every non-resident table entry
        edge = list(decode_inputs(dev, dtype, 6, 2, 6, 128, 16, 200, 1201,
                                  [1, 16, 17, 3000, 3199, 5], 14))
        for b, n in enumerate([1, 16, 17, 3000, 3199, 5]):
            edge[3][b, -(-n // 16):] = 0
        edge[1][0] = edge[2][0] = 1e4
        err = cmp("paged_decode split edges", paged_decode(*edge),
                  paged_decode_plain(*edge), dtype)
        log.append(f"paged_decode {dn} split edges nb=200 lens 1..3199 "
                   f"max_abs_err={err:.3g}")
        # paged_decode over phase 5's ring block runs (264-block tables)
        nbr, lens_r = RING_MAIN
        ring = decode_inputs(dev, dtype, 6, 2, 6, 128, 16, nbr, 6 * nbr + 1,
                             lens_r, 6)
        err = cmp("paged_decode ring", paged_decode(*ring),
                  paged_decode_plain(*ring), dtype)
        log.append(f"paged_decode {dn} ring B=6 nb={nbr} lens={lens_r} "
                   f"max_abs_err={err:.3g}")
        bnd = decode_bound(ring[0], ring[1], ring[3], ring[4])
        rec["paged_decode"][f"{dn}_ring"] = {
            "max_abs_err": err, "ms": timer(lambda: paged_decode(*ring)),
            "plain_ms": timer(lambda: paged_decode_plain(*ring)),
            "library_ms": timer(sdpa_decode(*ring)),
            "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2],
            "flops": bnd[3]}
    return rec


def topk_inputs(dev, dtype, B, K, G, h, bs, nb, N, lens, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, h), generator=g, device=dev).to(dtype)
    kmin = torch.randn((N, K, h), generator=g, device=dev)
    kmax = kmin + torch.randn((N, K, h), generator=g, device=dev).relu()
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    tables = perm[:B * nb].reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kmin, kmax, tables, lens


def topk_bound(q, tables, lens, bs):
    """Bytes and operations of one block_topk call: q, the table, lens and
    the scores once, and the two float32 summary rows of every resident
    (block, kv head); 4 operations (2 products, max, add) per (resident
    block, kv head, query row, channel), in float32."""
    B, K, G, h = q.shape
    nb = tables.shape[1]
    ln = lens.cpu().numpy().astype(np.int64)
    blocks = int(np.minimum(-(-ln // bs), nb).sum())
    nbytes = (q.numel() * q.element_size() + tables.numel() * 4 + 4 * B
              + 4 * B * nb + 2 * blocks * K * h * 4)
    return bound(nbytes, 4 * blocks * K * G * h, torch.float32)


def topk_select_bound(q, tables, lens, bs, k_static):
    """block_topk_select: the scoring's bytes and operations (topk_bound)
    plus its outputs written once (the compacted table, lens, counts and
    the [B, nb] bool mask); the ranking is integer work and adds none."""
    B, nb = tables.shape
    nbytes, flops = topk_bound(q, tables, lens, bs)[2:]
    nbytes += 4 * B * k_static + 8 * B + B * nb
    return bound(nbytes, flops, torch.float32)


# block_topk_select's sweep (B, nb, lens): one-block and mid-block tails,
# tables from 8 entries up to the kernel's limit (8,192)
TOPK_SELECT_SWEEP = ((3, 8, [1, 60, 128]), (4, 33, [16, 17, 400, 528]),
                     (6, 256, TOPK_MAIN[1]), (3, 300, [4799, 100, 4800]),
                     (2, 1024, [16384, 9000]), (2, 4097, [65552, 30000]),
                     (2, 8192, [131072, 70001]))


def topk_select_inputs(dev, dtype, B, nb, lens, seed):
    """Phase 6's widths (K 2, G 6, h 128, bs 16) with ties made by copying
    summary rows across a third of each row's table entries and the null
    block poisoned (1e4) behind every non-resident entry."""
    a = list(topk_inputs(dev, dtype, B, 2, 6, 128, 16, nb, B * nb + 1, lens,
                         seed))
    kmin, kmax, tables = a[1], a[2], a[3]
    for b, n in enumerate(lens):
        res = min(-(-n // 16), nb)
        src, dst = tables[b, 0:res:3], tables[b, 1:res:3]
        k = min(len(src), len(dst))
        kmin[dst[:k].long()] = kmin[src[:k].long()]
        kmax[dst[:k].long()] = kmax[src[:k].long()]
        tables[b, res:] = 0
    kmin[0] = kmax[0] = 1e4
    return a


def check_topk_select(dev, timer, log, cmp_scores):
    """block_topk_select against `select_kv_blocks` run on the launch's own
    scores, exactly (tables, lens, counts, mask, and the step's stats over
    the live slots), and its scores against
    the plain version at the scores' tolerance, over TOPK_SELECT_SWEEP with
    absolute, fractional, degrading and all-forced budgets; the C plan
    against topk_cluster_plan for every width; phase 6's shape timed
    against the plain version and the eager composition it replaces."""
    from repro_torch.kernels import build
    from repro_torch.kernels.block_topk import (
        TOPK_NB_MAX, block_topk_scores, block_topk_scores_plain,
        block_topk_select, block_topk_select_plain, block_topk_select_scores,
        select_kv_blocks, topk_cluster_plan)
    lib = build.load("block_topk")
    c, per = ctypes.c_int(), ctypes.c_int()
    for nb in range(1, TOPK_NB_MAX + 1):
        if lib.block_topk_plan(nb, ctypes.byref(c), ctypes.byref(per)) or \
                (c.value, per.value) != topk_cluster_plan(nb):
            raise AssertionError(f"block_topk plan differs at nb={nb}")
    if lib.block_topk_plan(TOPK_NB_MAX + 1, ctypes.byref(c),
                           ctypes.byref(per)) != -1:
        raise AssertionError("block_topk plan takes a table past its limit")
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        worst, n_cases = 0.0, 0
        for B, nb, lens in TOPK_SELECT_SWEEP:
            a = topk_select_inputs(dev, dtype, B, nb, lens, 20 + nb)
            budgets = (dict(k_static=max(nb // 4, 3), frac=0.0),
                       dict(k_static=max(-(-nb // 4), 3), frac=0.25),
                       dict(k_static=nb, frac=0.0),             # degrade
                       dict(k_static=min(nb, 5), frac=0.0, sink_blocks=3,
                            recent_blocks=nb))                  # all forced
            live = torch.arange(B, device=dev) % 3 != 1
            for i, kw in enumerate(budgets):
                kw = dict(dict(sink_blocks=1, recent_blocks=2), **kw)
                mask = live if i % 2 else None
                got = block_topk_select(*a, block_size=16, token_mask=mask,
                                        **kw)
                want = (*select_kv_blocks(got[0], a[3], a[4], block_size=16,
                                          **kw), None)
                act = torch.ones(B, device=dev) if mask is None else \
                    mask.float()
                n_res = torch.div(a[4] + 15, 16, rounding_mode="floor")
                zero = torch.zeros((), device=dev)
                want = (*want[:4], torch.stack([
                    (act * n_res).sum(), (act * want[2]).sum(), zero, zero]))
                # the scores-given entry (tensor-parallel ranks rank the
                # max of their score passes) on the same scores
                given = block_topk_select_scores(got[0], a[3], a[4],
                                                 block_size=16,
                                                 token_mask=mask, **kw)
                for name, g, g2, w in zip(("tables", "lens", "m",
                                           "selected", "aux"), got[1:],
                                          given, want):
                    if g.dtype != w.dtype or not torch.equal(g, w):
                        raise AssertionError(
                            f"block_topk_select {dn} nb={nb} {kw}: {name} "
                            f"differ from select_kv_blocks")
                    if g2.dtype != w.dtype or not torch.equal(g2, w):
                        raise AssertionError(
                            f"block_topk_select_scores {dn} nb={nb} {kw}: "
                            f"{name} differ from select_kv_blocks")
                if kw["k_static"] >= nb and not (
                        torch.equal(got[1], a[3]) and torch.equal(got[2],
                                                                  a[4])):
                    raise AssertionError(f"block_topk_select nb={nb}: a "
                                         f"budget >= n_res changed the table")
                worst = max(worst, cmp_scores(
                    f"block_topk_select {dn} nb={nb}", got[0],
                    block_topk_scores_plain(*a, block_size=16), dtype))
                n_cases += 1
        log.append(f"block_topk_select {dn}: {len(TOPK_SELECT_SWEEP)} widths "
                   f"(nb {TOPK_SELECT_SWEEP[0][1]}.."
                   f"{TOPK_SELECT_SWEEP[-1][1]}) x 4 budgets (absolute, "
                   f"frac 0.25, "
                   f"degrade, all forced), ties and a poisoned null block: "
                   f"tables/lens/m/selected/aux of the fused launch and of "
                   f"the scores-given entry equal select_kv_blocks on the "
                   f"launch's scores; scores max_abs_err={worst:.3g}")
        # phase 6 (b)'s call: frac 0.25 over the 256-wide table
        ta = topk_select_inputs(dev, dtype, 6, TOPK_MAIN[0], TOPK_MAIN[1],
                                10)
        kw = dict(block_size=16, k_static=64, frac=0.25, sink_blocks=1,
                  recent_blocks=2)
        got = block_topk_select(*ta, **kw)
        plain = block_topk_select_plain(*ta, **kw)
        err = cmp_scores(f"block_topk_select {dn} main", got[0], plain[0],
                         dtype)
        sb = topk_select_bound(ta[0], ta[3], ta[4], 16, 64)

        def composition(ta=ta, kw=kw):
            sc = block_topk_scores(*ta, block_size=16)
            return select_kv_blocks(sc, ta[3], ta[4], **kw)
        rec[dn] = {
            "max_abs_err": err, "exact": True, "cases": n_cases,
            "ms": timer(lambda: block_topk_select(*ta, **kw)),
            "plain_ms": timer(lambda: block_topk_select_plain(*ta, **kw)),
            "composition_ms": timer(composition),
            "library_ms": None, "bound_ms": sb[0], "bound_by": sb[1],
            "bytes": sb[2], "flops": sb[3]}
    return rec


def check_sparse_kernels(dev, timer, log):
    """block_topk and spec_verify against their plain versions: the
    reference sweep shapes (tests/test_kernels.py:195-197, :226, :275-277,
    :299; h=32 where the reference takes 16, the kernels' smallest head
    width), then the full-width main-path shapes of phases 6 and 7 and a
    long-history verify, timed."""
    from repro_torch.kernels.block_topk import (block_topk_scores,
                                                block_topk_scores_plain)
    from repro_torch.kernels.spec_verify import (spec_verify,
                                                 spec_verify_plain)
    rec = {"block_topk": {}, "spec_verify": {}}

    def cmp_scores(name, got, want, dtype):
        neg = want == -1e30
        if not torch.equal(got[neg], want[neg]) or (got[~neg] == -1e30).any():
            raise AssertionError(f"{name}: NEG_INF entries differ")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite scores")
        torch.testing.assert_close(got, want, **TOL[dtype], msg=name)
        return float((got - want).abs().max())

    def cmp_rows(name, got, want, dtype, cl, G):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = 0.0
        for b, c in enumerate(cl.cpu().tolist()):
            a, w = got[b, :, :c * G].float(), want[b, :, :c * G].float()
            torch.testing.assert_close(a, w, **TOL[dtype], msg=name)
            err = max(err, float((a - w).abs().max()))
        return err

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        worst = {"block_topk": 0.0, "spec_verify": 0.0}
        for bs, nb in ((8, 4), (16, 3), (8, 8)):
            for G in (1, 3):
                a = topk_inputs(dev, dtype, 3, 2, G, 32, bs, nb, 30,
                                [1, nb * bs - bs // 2, nb * bs], 7)
                worst["block_topk"] = max(worst["block_topk"], cmp_scores(
                    "block_topk sweep", block_topk_scores(*a, block_size=bs),
                    block_topk_scores_plain(*a, block_size=bs), dtype))
        q = torch.ones((1, 1, 1, 32), device=dev, dtype=dtype)
        kmin = torch.zeros((6, 1, 32), device=dev)
        kmax = torch.ones((6, 1, 32), device=dev)
        kmin[0] = kmax[0] = 1e4                         # poisoned null block
        a = (q, kmin, kmax, torch.tensor([[3, 0, 0]], dtype=torch.int32,
                                         device=dev),
             torch.tensor([5], dtype=torch.int32, device=dev))
        got = block_topk_scores(*a, block_size=8)
        cmp_scores("block_topk non-resident", got,
                   block_topk_scores_plain(*a, block_size=8), dtype)
        assert float(got[0, 0]) == 32.0, got
        for bs, S in ((8, 4), (16, 5), (8, 2)):
            for G in (1, 4):
                a = prefill_inputs(dev, dtype, 3, 2, S, G, 32, bs, 4, 20,
                                   [0, bs + bs // 2 - 1, 4 * bs],
                                   [S, max(S - 2, 1), 1], 8)
                worst["spec_verify"] = max(worst["spec_verify"], cmp_rows(
                    "spec_verify sweep", spec_verify(*a),
                    spec_verify_plain(*a), dtype, a[-1], G))
        a = list(prefill_inputs(dev, dtype, 1, 1, 3, 2, 32, 8, 3, 6, [8],
                                [3], 9))
        a[3][0] = a[4][0] = 1e4                         # poisoned null block
        a[5] = torch.tensor([[3, 0, 0]], dtype=torch.int32, device=dev)
        cmp_rows("spec_verify null block", spec_verify(*a),
                 spec_verify_plain(*a), dtype, a[-1], 2)
        log.append(f"block_topk {dn} sweep (bs/nb 8/4 16/3 8/8 x G 1/3, "
                   f"h=32) + non-resident: max_abs_err="
                   f"{worst['block_topk']:.3g}, NEG_INF entries equal")
        log.append(f"spec_verify {dn} sweep (bs/S 8/4 16/5 8/2 x G 1/4, "
                   f"h=32) + null block: max_abs_err="
                   f"{worst['spec_verify']:.3g}")
        # phase 6's shape: six slots over a 256-wide table, ~249 resident
        nbt, lens_t = TOPK_MAIN
        ta = topk_inputs(dev, dtype, 6, 2, 6, 128, 16, nbt, P6_BLOCKS,
                         lens_t, 10)
        err = cmp_scores("block_topk main",
                         block_topk_scores(*ta, block_size=16),
                         block_topk_scores_plain(*ta, block_size=16), dtype)
        log.append(f"block_topk {dn} main B=6 K=2 G=6 h=128 bs=16 nb={nbt} "
                   f"lens={lens_t} max_abs_err={err:.3g}")
        tb = topk_bound(ta[0], ta[3], ta[4], 16)
        rec["block_topk"][dn] = {
            "max_abs_err": err,
            "ms": timer(lambda: block_topk_scores(*ta, block_size=16)),
            "plain_ms": timer(lambda: block_topk_scores_plain(
                *ta, block_size=16)),
            "library_ms": None, "bound_ms": tb[0], "bound_by": tb[1],
            "bytes": tb[2], "flops": tb[3]}
        # phase 7's shape (S = 5 window rows, off 256-304) and a long
        # history (off ~4,000)
        for key, (nbs, offs), N in (("", SPEC_MAIN, 321),
                                    ("_long", SPEC_LONG, P6_BLOCKS)):
            sa = prefill_inputs(dev, dtype, 6, 2, P7_K + 1, 6, 128, 16, nbs,
                                N, offs, [P7_K + 1] * 6, 11)
            err = cmp_rows(f"spec_verify main{key}", spec_verify(*sa),
                           spec_verify_plain(*sa), dtype, sa[-1], 6)
            log.append(f"spec_verify {dn} main{key} B=6 S={P7_K + 1} K=2 "
                       f"G=6 h=128 bs=16 nb={nbs} off={offs} "
                       f"max_abs_err={err:.3g}")
            sb = prefill_bound(sa[0], sa[1], sa[3], sa[5], sa[6], sa[7])
            lib = sdpa_prefill(*sa)
            lo = lib().reshape(6, 2, 6, P7_K + 1, 128).permute(0, 1, 3, 2, 4)
            lib_err = float((lo.reshape(-1).float() - spec_verify_plain(
                *sa).float().reshape(-1)).abs().max())
            rec["spec_verify"][dn + key] = {
                "max_abs_err": err, "ms": timer(lambda: spec_verify(*sa)),
                "plain_ms": timer(lambda: spec_verify_plain(*sa)),
                "library_ms": timer(lib), "library_vs_plain_err": lib_err,
                "bound_ms": sb[0], "bound_by": sb[1], "bytes": sb[2],
                "flops": sb[3]}
    for dn, r in check_topk_select(dev, timer, log, cmp_scores).items():
        rec["block_topk"][f"{dn}_select"] = r
    return rec


def int8_arena(dev, K, bs, h, N, tables, lens, seed):
    """int8 pages and their scale plane, written by the port's own write
    path (`quant_paged_prefill_write`): every block first holds a previous
    owner's sealed content, then each row of `tables` is rewritten from
    offset 0 with lens[b] tokens — each block it opens is unsealed on open,
    full blocks seal, the tail stays per-token. → (k_pages, v_pages,
    scale-plane kwargs)."""
    from repro_torch.models import attention as attn_mod
    g = torch.Generator(device=dev).manual_seed(seed)
    e = {n: torch.zeros((N, K, bs, h), dtype=torch.int8, device=dev)
         for n in ("k", "v")}
    for n in ("k", "v"):
        e[n + "scale"] = torch.zeros((N, K, h), device=dev)
        e[n + "tok"] = torch.zeros((N, K, bs), device=dev)

    def write(table, n_tok):          # 256-token chunks, as prefill writes
        for o in range(0, n_tok, 256):
            c = min(256, n_tok - o)
            x = torch.randn((1, c, K, h), generator=g, device=dev)
            y = torch.randn((1, c, K, h), generator=g, device=dev)
            attn_mod.quant_paged_prefill_write(e, x, y, table, o, c)
    write(torch.arange(1, N, dtype=torch.int32, device=dev)[None],
          (N - 1) * bs)
    for b, n_tok in enumerate(int(x) for x in lens):
        write(tables[b:b + 1], n_tok)
    sc = dict(k_scale=e["kscale"], k_tok=e["ktok"], v_scale=e["vscale"],
              v_tok=e["vtok"])
    return e["k"], e["v"], sc


def sdpa_decode_int8(q, kq, vq, tables, lens, sc):
    """The int8 decode yardstick, dequantize-then-SDPA: the tabled blocks
    gathered and dequantized, then one scaled_dot_product_attention call,
    both inside the timed call."""
    import torch.nn.functional as F
    from repro_torch.kernels._common import gather_kv
    B, K, G, h = q.shape
    nb, bs = tables.shape[1], kq.shape[2]
    qh = q.reshape(B, K * G, 1, h)
    mask = (torch.arange(nb * bs, device=q.device)[None]
            < lens[:, None].long())[:, None, None, :]

    def run():
        k = gather_kv(kq, tables, sc["k_scale"], sc["k_tok"]).to(q.dtype)
        v = gather_kv(vq, tables, sc["v_scale"], sc["v_tok"]).to(q.dtype)
        return F.scaled_dot_product_attention(
            qh, k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1),
            attn_mask=mask)
    return run


def sdpa_prefill_int8(q, kn, vn, kq, vq, tables, off, cl, sc):
    """The same for a prefill chunk or a verify window: dequantized history
    ++ the chunk's keys, with the resident/causal/real-row mask."""
    import torch.nn.functional as F
    from repro_torch.kernels._common import gather_kv
    B, K, SG, h = q.shape
    S = kn.shape[2]
    G = SG // S
    nb, bs = tables.shape[1], kq.shape[2]
    L = nb * bs
    qh = q.reshape(B, K, S, G, h).permute(0, 1, 3, 2, 4).reshape(
        B, K * G, S, h)
    dev = q.device
    o, c = off.long()[:, None, None], cl.long()[:, None, None]
    pos = o + torch.arange(S, device=dev)[None, :, None]      # [B, S, 1]
    th = torch.arange(L, device=dev)[None, None, :]
    tc = torch.arange(S, device=dev)[None, None, :]
    mask = torch.cat([(th < o).expand(B, S, L),
                      (tc < c) & (o + tc <= pos)], dim=2)[:, None]

    def run():
        k = torch.cat([gather_kv(kq, tables, sc["k_scale"], sc["k_tok"])
                       .to(q.dtype), kn], dim=2).repeat_interleave(G, dim=1)
        v = torch.cat([gather_kv(vq, tables, sc["v_scale"], sc["v_tok"])
                       .to(q.dtype), vn], dim=2).repeat_interleave(G, dim=1)
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)
    return run


def check_quant_kernels(dev, timer, log):
    """The int8 paths (QuantPlane) of paged_decode, paged_prefill and
    spec_verify against their plain versions, q in float32 and bfloat16,
    over arenas written by the port's int8 write path: the reference quant
    sweep shapes (tests/test_kernels.py:394-470: bs 8/16, G 1/4), then the
    full-width shapes — all-full decode (B=6, K=2, G=6, h=128, bs=16),
    phase 3's prefill chunk, phase 7's verify window and the MoE attention
    shape (K=16, G=1) — timed against the plain version and the
    dequantize-then-SDPA yardstick, with the bound of the int8 bytes."""
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    from repro_torch.kernels.spec_verify import (spec_verify,
                                                 spec_verify_plain)
    rec = {"paged_decode": {}, "paged_prefill": {}, "spec_verify": {}}

    def cmp(name, got, want, dtype, cl=None, G=1):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        if cl is not None:                       # real rows only
            got = torch.cat([got[b, :, :c * G].reshape(-1)
                             for b, c in enumerate(cl.cpu().tolist())])
            want = torch.cat([want[b, :, :c * G].reshape(-1)
                              for b, c in enumerate(cl.cpu().tolist())])
        torch.testing.assert_close(got, want, **TOL[dtype], msg=name)
        return float((got - want).abs().max())

    def time_one(key, name, kern, plain, args, sc, bnd, lib, err):
        rec[name][key] = {
            "max_abs_err": err, "ms": timer(lambda: kern(*args, **sc)),
            "plain_ms": timer(lambda: plain(*args, **sc)),
            "library_ms": timer(lib), "library": "dequant+sdpa",
            "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2],
            "flops": bnd[3]}

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        worst = {"paged_decode": 0.0, "paged_prefill": 0.0,
                 "spec_verify": 0.0}
        for bs, nb in ((8, 6), (16, 4)):
            for G in (1, 4):
                a = decode_inputs(dev, dtype, 3, 2, G, 32, bs, nb, 24,
                                  [1, max(nb * bs // 2 - 3, 1), nb * bs], 21)
                kq, vq, sc = int8_arena(dev, 2, bs, 32, 24, a[3], a[4], 22)
                args = (a[0], kq, vq, a[3], a[4])
                worst["paged_decode"] = max(worst["paged_decode"], cmp(
                    "paged_decode int8 sweep", paged_decode(*args, **sc),
                    paged_decode_plain(*args, **sc), dtype))
        for bs, S in ((8, 8), (16, 8)):
            for G in (1, 4):
                a = prefill_inputs(dev, dtype, 2, 2, S, G, 32, bs, 5, 24,
                                   [0, 5 * bs // 2 - 3], [S, max(S - 3, 1)],
                                   23)
                kq, vq, sc = int8_arena(dev, 2, bs, 32, 24, a[5], a[6], 24)
                args = (a[0], a[1], a[2], kq, vq, a[5], a[6], a[7])
                worst["paged_prefill"] = max(worst["paged_prefill"], cmp(
                    "paged_prefill int8 sweep", paged_prefill(*args, **sc),
                    paged_prefill_plain(*args, **sc), dtype, a[7], G))
        for bs, S in ((8, 4), (16, 5)):
            for G in (1, 4):
                a = prefill_inputs(dev, dtype, 3, 2, S, G, 32, bs, 4, 20,
                                   [0, bs + bs // 2 - 1, 4 * bs],
                                   [S, max(S - 2, 1), 1], 25)
                kq, vq, sc = int8_arena(dev, 2, bs, 32, 20, a[5], a[6], 26)
                args = (a[0], a[1], a[2], kq, vq, a[5], a[6], a[7])
                worst["spec_verify"] = max(worst["spec_verify"], cmp(
                    "spec_verify int8 sweep", spec_verify(*args, **sc),
                    spec_verify_plain(*args, **sc), dtype, a[7], G))
        log.append(f"int8 {dn} sweeps (bs 8/16 x G 1/4, h=32, arenas from "
                   f"the write path): max_abs_err paged_decode "
                   f"{worst['paged_decode']:.3g}, paged_prefill "
                   f"{worst['paged_prefill']:.3g}, spec_verify "
                   f"{worst['spec_verify']:.3g}")
        # full width: all-full decode, phase 3's chunk (and a padded one),
        # phase 7's verify window, the MoE attention shape
        for key, K, G in (("", 2, 6), ("_moe", 16, 1)):
            dec = decode_inputs(dev, dtype, 6, K, G, 128, 16, 32, 321,
                                [1, 17, 100, 255, 448, 512], 27)
            kq, vq, sc = int8_arena(dev, K, 16, 128, 321, dec[3], dec[4], 28)
            args = (dec[0], kq, vq, dec[3], dec[4])
            err = cmp(f"paged_decode int8 main{key}",
                      paged_decode(*args, **sc),
                      paged_decode_plain(*args, **sc), dtype)
            time_one(dn + key, "paged_decode", paged_decode,
                     paged_decode_plain, args, sc,
                     decode_bound(dec[0], kq, dec[3], dec[4]),
                     sdpa_decode_int8(*args, sc), err)
            pre = prefill_inputs(dev, dtype, 1, K, 128, G, 128, 16, 32, 321,
                                 [384], [128], 29)
            kq, vq, sc = int8_arena(dev, K, 16, 128, 321, pre[5], pre[6], 30)
            args = (pre[0], pre[1], pre[2], kq, vq, pre[5], pre[6], pre[7])
            err = cmp(f"paged_prefill int8 main{key}",
                      paged_prefill(*args, **sc),
                      paged_prefill_plain(*args, **sc), dtype)
            time_one(dn + key, "paged_prefill", paged_prefill,
                     paged_prefill_plain, args, sc,
                     prefill_bound(pre[0], pre[1], kq, pre[5], pre[6],
                                   pre[7]),
                     sdpa_prefill_int8(*args, sc), err)
            log.append(f"int8 {dn} main{key} (K={K}, G={G}, h=128, bs=16): "
                       f"paged_decode max_abs_err "
                       f"{rec['paged_decode'][dn + key]['max_abs_err']:.3g}, "
                       f"paged_prefill S=128 off=384 max_abs_err {err:.3g}")
        # paged_decode over phase 5's ring tables on int8 arenas
        nbr, lens_r = RING_MAIN
        ring = decode_inputs(dev, dtype, 6, 2, 6, 128, 16, nbr, 6 * nbr + 1,
                             lens_r, 35)
        kq, vq, sc = int8_arena(dev, 2, 16, 128, 6 * nbr + 1, ring[3],
                                ring[4], 36)
        args = (ring[0], kq, vq, ring[3], ring[4])
        err = cmp("paged_decode int8 ring", paged_decode(*args, **sc),
                  paged_decode_plain(*args, **sc), dtype)
        time_one(dn + "_ring", "paged_decode", paged_decode,
                 paged_decode_plain, args, sc,
                 decode_bound(ring[0], kq, ring[3], ring[4]),
                 sdpa_decode_int8(*args, sc), err)
        log.append(f"int8 {dn} ring B=6 nb={nbr} lens={lens_r}: "
                   f"paged_decode max_abs_err {err:.3g}")
        del ring, kq, vq, sc, args
        pad = prefill_inputs(dev, dtype, 1, 2, 128, 6, 128, 16, 32, 321,
                             [200], [100], 31)
        kq, vq, sc = int8_arena(dev, 2, 16, 128, 321, pad[5], pad[6], 32)
        args = (pad[0], pad[1], pad[2], kq, vq, pad[5], pad[6], pad[7])
        err = cmp("paged_prefill int8 padded", paged_prefill(*args, **sc),
                  paged_prefill_plain(*args, **sc), dtype, pad[7], 6)
        nbs, offs = SPEC_MAIN
        sa = prefill_inputs(dev, dtype, 6, 2, P7_K + 1, 6, 128, 16, nbs, 321,
                            offs, [P7_K + 1] * 6, 33)
        kq, vq, sc = int8_arena(dev, 2, 16, 128, 321, sa[5], sa[6], 34)
        args = (sa[0], sa[1], sa[2], kq, vq, sa[5], sa[6], sa[7])
        err2 = cmp("spec_verify int8 main", spec_verify(*args, **sc),
                   spec_verify_plain(*args, **sc), dtype, sa[7], 6)
        time_one(dn, "spec_verify", spec_verify, spec_verify_plain, args, sc,
                 prefill_bound(sa[0], sa[1], kq, sa[5], sa[6], sa[7]),
                 sdpa_prefill_int8(*args, sc), err2)
        log.append(f"int8 {dn}: paged_prefill off=200 cl=100 max_abs_err "
                   f"{err:.3g}; spec_verify B=6 S={P7_K + 1} off={offs} "
                   f"max_abs_err {err2:.3g}")
        # the long histories: topk-long's last chunk, a ~4,000-token verify
        nbl, offl = PREFILL_LONG
        lng = prefill_inputs(dev, dtype, 1, 2, 128, 6, 128, 16, nbl, nbl + 1,
                             [offl], [128], 37)
        kq, vq, sc = int8_arena(dev, 2, 16, 128, nbl + 1, lng[5], lng[6], 38)
        args = (lng[0], lng[1], lng[2], kq, vq, lng[5], lng[6], lng[7])
        err = cmp("paged_prefill int8 long", paged_prefill(*args, **sc),
                  paged_prefill_plain(*args, **sc), dtype)
        time_one(dn + "_long", "paged_prefill", paged_prefill,
                 paged_prefill_plain, args, sc,
                 prefill_bound(lng[0], lng[1], kq, lng[5], lng[6], lng[7]),
                 sdpa_prefill_int8(*args, sc), err)
        nbs, offs = SPEC_LONG
        sa = prefill_inputs(dev, dtype, 6, 2, P7_K + 1, 6, 128, 16, nbs,
                            6 * nbs + 1, offs, [P7_K + 1] * 6, 39)
        kq, vq, sc = int8_arena(dev, 2, 16, 128, 6 * nbs + 1, sa[5], sa[6],
                                40)
        args = (sa[0], sa[1], sa[2], kq, vq, sa[5], sa[6], sa[7])
        err2 = cmp("spec_verify int8 long", spec_verify(*args, **sc),
                   spec_verify_plain(*args, **sc), dtype, sa[7], 6)
        time_one(dn + "_long", "spec_verify", spec_verify, spec_verify_plain,
                 args, sc,
                 prefill_bound(sa[0], sa[1], kq, sa[5], sa[6], sa[7]),
                 sdpa_prefill_int8(*args, sc), err2)
        log.append(f"int8 {dn} long: paged_prefill off={offl} nb={nbl} "
                   f"max_abs_err {err:.3g}; spec_verify off={offs} nb={nbs} "
                   f"max_abs_err {err2:.3g}")
        del lng, sa, kq, vq, sc, args
    return rec


def flash_bound(q, k, causal, window, sink):
    """Bytes and flops of one flash_prefill call: q, k, v read once, the
    output written once; 4·h flops per visible (query row, key) pair."""
    N, SG, h = q.shape
    S = k.shape[1]
    G = SG // S
    e = q.element_size()
    p = np.arange(S)[:, None]
    t = np.arange(S)[None, :]
    ok = (t <= p) if causal else np.ones((S, S), bool)
    if window > 0:
        ok = ok & (((p - t) < window) | (t < sink))
    visible = N * G * int(ok.sum())
    nbytes = 2 * q.numel() * e + 2 * k.numel() * e
    return bound(nbytes, 4 * h * visible, q.dtype)


def sink_bound(q, kc, t):
    """Bytes and flops of one sink_decode call: the live slots min(t, W) of
    each (sequence, kv head) read once, q read and the output written."""
    B, K, G, h = q.shape
    W = kc.shape[2]
    e = q.element_size()
    live = int(np.minimum(t.cpu().numpy().astype(np.int64), W).sum())
    nbytes = 2 * q.numel() * e + 2 * live * K * h * e + 4 * B
    return bound(nbytes, 4 * K * G * h * live, q.dtype)


def sdpa_flash(q, k, v, causal, window, sink):
    """One scaled_dot_product_attention call on the same data, kv heads
    expanded to query heads outside the timed call."""
    import torch.nn.functional as F
    N, SG, h = q.shape
    S = k.shape[1]
    G = SG // S
    qh = q.reshape(N, S, G, h).permute(0, 2, 1, 3)              # [N, G, S, h]
    kh = k[:, None].expand(N, G, S, h).contiguous()
    vh = v[:, None].expand(N, G, S, h).contiguous()
    if window == 0:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=causal)
    p = torch.arange(S, device=q.device)[:, None]
    t = torch.arange(S, device=q.device)[None, :]
    mask = ((t <= p) if causal else torch.ones_like(p - t, dtype=torch.bool)) \
        & (((p - t) < window) | (t < sink))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def sdpa_sink(q, kc, vc, t):
    import torch.nn.functional as F
    B, K, G, h = q.shape
    W = kc.shape[2]
    qh = q.reshape(B, K * G, 1, h)
    kh = kc.repeat_interleave(G, dim=1)
    vh = vc.repeat_interleave(G, dim=1)
    mask = (torch.arange(W, device=q.device)[None] < t[:, None].long())
    mask = mask[:, None, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def check_dense_kernels(dev, timer, log):
    """flash_prefill and sink_decode against their plain versions: the
    reference sweep shapes (tests/test_kernels.py:20-66) plus h=128, then
    the full-width main-path shapes, timed."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
    rec = {"flash_prefill": {}, "sink_decode": {}}

    def rand(g, shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def cmp(name, got, want, dtype):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        torch.testing.assert_close(got, want, **TOL_DENSE[dtype], msg=name)
        return float((got - want).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        g = torch.Generator(device=dev).manual_seed(6)
        worst = {"flash_prefill": 0.0, "sink_decode": 0.0}
        for S in (64, 128, 256):
            for h in (32, 64, 128):
                for kw in (dict(causal=True), dict(causal=False),
                           dict(causal=True, window=32),
                           dict(causal=True, window=32, sink=8)):
                    q, k, v = (rand(g, (3, S, h), dtype) for _ in range(3))
                    err = cmp(f"flash_prefill sweep S={S} h={h} {kw}",
                              flash_prefill(q, k, v, **kw),
                              flash_prefill_plain(q, k, v, **kw), dtype)
                    worst["flash_prefill"] = max(worst["flash_prefill"], err)
        for W in (64, 128, 96):
            for G in (1, 4):
                for h in (32, 128):
                    q = rand(g, (2, 2, G, h), dtype)
                    kc, vc = (rand(g, (2, W, 2, h), dtype).transpose(1, 2)
                              for _ in range(2))
                    t = torch.tensor([W // 3, W], dtype=torch.int32,
                                     device=dev)
                    err = cmp(f"sink_decode sweep W={W} G={G} h={h}",
                              sink_decode(q, kc, vc, t),
                              sink_decode_plain(q, kc, vc, t), dtype)
                    worst["sink_decode"] = max(worst["sink_decode"], err)
        # GQA rows off the tiles: S and S·G not multiples of the key or
        # query tile, window edges and a sink inside a tile, bidirectional
        for S, G, h, kw in ((77, 5, 64, dict(causal=True)),
                            (300, 4, 128, dict(causal=True, window=40)),
                            (300, 4, 128, dict(causal=True, window=40,
                                               sink=24)),
                            (512, 6, 128, dict(causal=False)),
                            (333, 3, 32, dict(causal=False, window=100,
                                              sink=16))):
            q = rand(g, (2, S * G, h), dtype)
            k, v = (rand(g, (2, S, h), dtype) for _ in range(2))
            err = cmp(f"flash_prefill GQA S={S} G={G} h={h} {kw}",
                      flash_prefill(q, k, v, **kw),
                      flash_prefill_plain(q, k, v, **kw), dtype)
            worst["flash_prefill"] = max(worst["flash_prefill"], err)
        log.append(f"flash_prefill {dn} sweep (S 64/128/256 x h 32/64/128 x "
                   f"causal/bidir/window/sink; GQA S 77/300/512/333 with "
                   f"ragged tiles, window and sink edges inside tiles): "
                   f"max_abs_err={worst['flash_prefill']:.3g}")
        log.append(f"sink_decode {dn} sweep (W 64/128/96 x G 1/4 x h 32/128, "
                   f"model-layout views): max_abs_err="
                   f"{worst['sink_decode']:.3g}")
        # split-KV edges: splits past the occupancy (t = 1), W off the
        # 16-slot chunk, wrapped rings; slots past t hold 1e4 (never read)
        worst_e = 0.0
        for B, W, G, h, ts in SINK_EDGES:
            q = rand(g, (B, 2, G, h), dtype)
            kc, vc = (rand(g, (B, W, 2, h), dtype) for _ in range(2))
            for b, t_b in enumerate(ts):
                kc[b, t_b:] = vc[b, t_b:] = 1e4
            kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
            t = torch.tensor(ts, dtype=torch.int32, device=dev)
            worst_e = max(worst_e, cmp(f"sink_decode edge W={W} G={G} t={ts}",
                                       sink_decode(q, kc, vc, t),
                                       sink_decode_plain(q, kc, vc, t),
                                       dtype))
        log.append(f"sink_decode {dn} split edges (t = 1, W 100/4223/16/4608,"
                   f" G 1/6, t > W; slots past t poisoned): max_abs_err="
                   f"{worst_e:.3g}")
        # full width: one 4608-token prompt, 12 query heads over 2 kv heads
        q = rand(g, (2, FLASH_MAIN_S * 6, 128), dtype)
        k, v = (rand(g, (2, FLASH_MAIN_S, 128), dtype) for _ in range(2))
        fa = (q, k, v)
        err = cmp("flash_prefill main", flash_prefill(*fa),
                  flash_prefill_plain(*fa), dtype)
        log.append(f"flash_prefill {dn} main S={FLASH_MAIN_S} G=6 K=2 h=128 "
                   f"causal "
                   f"max_abs_err={err:.3g}")
        fb = flash_bound(q, k, True, 0, 0)
        lib = sdpa_flash(q, k, v, True, 0, 0)
        lib_err = float((lib().permute(0, 2, 1, 3).reshape(q.shape).float()
                         - flash_prefill_plain(*fa).float()).abs().max())
        rec["flash_prefill"][dn] = {
            "max_abs_err": err, "ms": timer(lambda: flash_prefill(*fa)),
            "plain_ms": timer(lambda: flash_prefill_plain(*fa), reps=5),
            "library_ms": timer(lib), "library_vs_plain_err": lib_err,
            "bound_ms": fb[0], "bound_by": fb[1], "bytes": fb[2],
            "flops": fb[3]}
        del q, k, v, fa
        # six decode slots over the ring (W=4224) and the full cache (4608)
        for W, ts in SINK_MAIN:
            q = rand(g, (6, 2, 6, 128), dtype)
            kc, vc = (rand(g, (6, W, 2, 128), dtype).transpose(1, 2)
                      for _ in range(2))
            t = torch.tensor(ts, dtype=torch.int32, device=dev)
            sa = (q, kc, vc, t)
            err = cmp(f"sink_decode main W={W}", sink_decode(*sa),
                      sink_decode_plain(*sa), dtype)
            log.append(f"sink_decode {dn} main B=6 K=2 G=6 h=128 W={W} "
                       f"t={ts} max_abs_err={err:.3g}")
            sb = sink_bound(q, kc, t)
            lib = sdpa_sink(*sa)
            lib_err = float((lib().reshape(q.shape).float()
                             - sink_decode_plain(*sa).float()).abs().max())
            rec["sink_decode"][f"{dn}_W{W}"] = {
                "max_abs_err": err, "ms": timer(lambda: sink_decode(*sa)),
                "plain_ms": timer(lambda: sink_decode_plain(*sa)),
                "library_ms": timer(lib), "library_vs_plain_err": lib_err,
                "bound_ms": sb[0], "bound_by": sb[1], "bytes": sb[2],
                "flops": sb[3]}
    return rec


def slot_rows(dev, S, C, n_tok, k, seed):
    """n_valid [S] int32 of n_tok tokens routed to k distinct slots each,
    cut at the capacity C."""
    rng = np.random.default_rng(seed)
    nv = np.zeros(S, np.int64)
    for _ in range(n_tok):
        nv[rng.choice(S, k, replace=False)] += 1
    return torch.tensor(np.minimum(nv, C), dtype=torch.int32, device=dev)


def moe_gmm_inputs(dev, dtype, S, C, D, F, n_tok, k, seed):
    """The slot buffer one MoE product of the main path sees: n_tok tokens
    routed to k distinct experts each over S slots, the capacity C cutting
    each slot's valid rows; rows past n_valid are zero, as dispatch leaves
    them. Weights at the model's init scale (std 0.02)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_valid = slot_rows(dev, S, C, n_tok, k, seed)
    rows = torch.arange(C, device=dev)[None, :, None] \
        < n_valid.long()[:, None, None]
    x = (torch.randn((S, C, D), generator=g, device=dev) * rows).to(dtype)
    w = (torch.randn((S, D, F), generator=g, device=dev) * 0.02).to(dtype)
    return x, w, n_valid


def moe_gmm_bound(x, w, n_valid):
    """Bytes and operations of one moe_gmm call: the weights of every slot
    with a valid row, the valid rows of x (the rows at or past n_valid are
    never read), the whole output (written, zeros included) and n_valid,
    once each; 2 operations per (valid row, D, F)."""
    S, C, D = x.shape
    F = w.shape[2]
    nv = n_valid.cpu().numpy().astype(np.int64)
    e = x.element_size()
    nbytes = (int((nv > 0).sum()) * D * F * e + int(nv.sum()) * D * e
              + S * C * F * e + 4 * S)
    return bound(nbytes, 2 * int(nv.sum()) * D * F, x.dtype)


def check_moe_kernels(dev, timer, log):
    """moe_gmm against its plain version: the reference sweep
    (tests/test_kernels.py:334-355) with the n_valid edges 0 and C, then
    the full-width shapes of phase 8 — decode (6 tokens x top-4 over 60
    slots, capacity 8) for w1/w3 and w2, and a 128-token prefill chunk
    (capacity 24) — timed beside the plain version, one torch.bmm over all
    slots (the library yardstick; the port never calls it) and the bound."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    rec = {"moe_gmm": {}}

    def cmp(name, x, w, nv, dtype):
        got = moe_gmm(x, w, nv)
        torch.cuda.synchronize()
        want = moe_gmm_plain(x, w, nv)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        for s_, n in enumerate(nv.cpu().tolist()):
            if got[s_, n:].any():
                raise AssertionError(f"{name}: rows past n_valid not zero")
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype],
                                   msg=name)
        return float((got.float() - want.float()).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        worst = 0.0
        for i, (S, C, D, F) in enumerate(((2, 32, 64, 48), (4, 64, 128, 96),
                                          (1, 16, 32, 32), (3, 40, 50, 130))):
            x, w, nv = moe_gmm_inputs(dev, dtype, S, C, D, F, C, 1, 20 + i)
            nv[0] = 0
            nv[-1] = C
            worst = max(worst, cmp("moe_gmm sweep", x, w, nv, dtype))
        log.append(f"moe_gmm {dn} sweep (reference shapes + C=40 D=50 "
                   f"F=130, n_valid 0 and C): max_abs_err={worst:.3g}")
        # edges: every slot empty, n_valid across 16- and 32-row tiles, D
        # and F off every tile (plain-load path) and off the tiles with
        # 16-byte rows; empty slots' weights and rows past n_valid are NaN
        # (never read)
        worst = 0.0
        for i, (S, C, D, F, nv_e) in enumerate(MOE_EDGES):
            x, w, nv = moe_gmm_inputs(dev, dtype, S, C, D, F, 0, 1, 40 + i)
            nv.copy_(torch.tensor(nv_e, dtype=torch.int32))
            live = torch.arange(C, device=dev)[None, :, None] \
                < nv.long()[:, None, None]
            x = torch.randn((S, C, D), device=dev, generator=torch.Generator(
                device=dev).manual_seed(50 + i)).to(dtype) * live
            want = moe_gmm_plain(x, w, nv)
            x = torch.where(live, x, torch.full_like(x, float("nan")))
            w[nv == 0] = float("nan")
            got = moe_gmm(x, w, nv)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"moe_gmm edge {S}x{C}x{D}x{F}: "
                                     f"non-finite output (a NaN was read)")
            for s_, n in enumerate(nv_e):
                if got[s_, n:].any():
                    raise AssertionError("moe_gmm edge: rows past n_valid "
                                         "not zero")
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype], msg="moe_gmm edge")
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        log.append(f"moe_gmm {dn} edges (all slots empty; n_valid 16/17/24/"
                   f"40/70; D x F 50 x 130 and 48 x 136): max_abs_err="
                   f"{worst:.3g}")
        for key, (C, D, F, n_tok) in (
                ("", MOE_DECODE), ("_w2", MOE_DECODE_W2),
                ("_prefill", MOE_PREFILL)):
            x, w, nv = moe_gmm_inputs(dev, dtype, 60, C, D, F, n_tok, 4,
                                      30 + len(key))
            err = cmp(f"moe_gmm main{key}", x, w, nv, dtype)
            # phase 8 (b)'s slot-reversal migration: bit for bit
            if not torch.equal(moe_gmm(x.flip(0), w.flip(0),
                                       nv.flip(0)).flip(0),
                               moe_gmm(x, w, nv)):
                raise AssertionError(f"moe_gmm main{key}: the output "
                                     f"depends on the slot order")
            mb = moe_gmm_bound(x, w, nv)
            log.append(f"moe_gmm {dn} main{key} x [60, {C}, {D}] w [60, {D},"
                       f" {F}], {int((nv > 0).sum())} live slots, "
                       f"{int(nv.sum())} rows: max_abs_err={err:.3g}; "
                       f"reversed slot order bit-identical")
            rec["moe_gmm"][dn + key] = {
                "max_abs_err": err, "ms": timer(lambda: moe_gmm(x, w, nv)),
                "plain_ms": timer(lambda: moe_gmm_plain(x, w, nv)),
                "library_ms": timer(lambda: torch.bmm(x, w)),
                "bound_ms": mb[0], "bound_by": mb[1], "bytes": mb[2],
                "flops": mb[3], "live_slots": int((nv > 0).sum()),
                "valid_rows": int(nv.sum())}
            del x, w
    return rec


# ---- phase 2, continued: the shapes of phase 13 ------------------------
# (K, G, h, table width, decode lens, chunk offset, whole-prompt length,
# dense cache widths): gemma3-4b's global layers over its 2,304-token
# context (K 4, G 2, h 256; 1,024-slot local rings) and granite-34b's MQA
# group over phase 3's 512-token context (K 1, G 48, h 128)
WIDE = {"h256": (4, 2, 256, 144, [1536, 1700, 1800, 1900, 2000, 2064], 1536,
                 2048, (1024, 2304)),
        "g48": (1, 48, 128, 32, [1, 17, 100, 255, 448, 512], 384, 448,
                (512,))}
# the decode routine's row-group boundaries (K, G, h): one group at its
# largest (16 rows at h 128, 8 at h 256), then two and three groups
WIDE_EDGES = ((1, 16, 128), (1, 17, 128), (1, 33, 128), (2, 8, 256),
              (2, 9, 256), (1, 48, 256))
# qwen3-moe-235b-a22b's expert products (capacity C, D, F, tokens) over its
# 129 slots, top-8: a decode step of 6 slots, a 128-token chunk
MOE3_SLOTS, MOE3_TOPK = 129, 8
MOE3_DECODE, MOE3_PREFILL = (8, 4096, 1536, 6), (16, 4096, 1536, 128)
# a capacity factor at which no slot drops an assignment of a verify
# window (30 rows x top-8 over 129 slots: capacity ceil(30·8·17/129) = 32)
MOE3_NODROP_CF = 17.0
# qwen3-moe's attention group for its top-k decode (K 4, G 16, h 128)
TOPK3 = (4, 16, 128)


def check_wide_kernels(dev, timer, log):
    """The six attention kernels at the shapes this slice adds, against
    their plain versions and timed beside the bound and the library call:
    (K 4, G 2, h 256) and (K 1, G 48, h 128) in float32 and bfloat16, the
    int8 paths of paged_decode, paged_prefill and spec_verify there, the
    decode routine's row-group edges (G 16/17/33 at h 128, 8/9/48 at h 256)
    in paged_decode and sink_decode, block_topk's fused select exactly
    against select_kv_blocks at both shapes and qwen3-moe's (K 4, G 16),
    and moe_gmm at qwen3-moe's expert shapes. → {kernel: {"<dtype>_<shape>":
    record}} and the int8 records the same way."""
    from repro_torch.kernels.block_topk import (block_topk_scores,
                                                block_topk_scores_plain,
                                                block_topk_select,
                                                select_kv_blocks)
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
    from repro_torch.kernels.spec_verify import (spec_verify,
                                                 spec_verify_plain)
    names = ("paged_decode", "paged_prefill", "flash_prefill", "sink_decode",
             "spec_verify", "block_topk", "moe_gmm")
    rec = {n: {} for n in names}
    rec_q = {n: {} for n in ("paged_decode", "paged_prefill", "spec_verify")}

    def cmp(name, got, want, dtype, tol=TOL, rows=None):
        got, want = got.float(), want.float()
        if rows is not None:
            got, want = rows(got), rows(want)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        torch.testing.assert_close(got, want, **tol[dtype], msg=name)
        return float((got - want).abs().max())

    def real_rows(cl, G):
        return lambda x: torch.cat([x[b, :, :c * G].reshape(-1) for b, c in
                                    enumerate(cl.cpu().tolist())])

    def timed(out, key, err, run, plain, lib, bnd, shape, plain_reps=None):
        out[key] = {"max_abs_err": err, "ms": timer(run),
                    "plain_ms": timer(plain, reps=plain_reps),
                    "library_ms": None if lib is None else timer(lib),
                    "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2],
                    "flops": bnd[3], "shape": shape}

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for sk, (K, G, h, nb, lens, off, Sf, Ws) in WIDE.items():
            key = f"{dn}_{sk}"
            shp = f"K={K} G={G} h={h}"
            # paged_decode: six slots over the shape's table
            dec = decode_inputs(dev, dtype, 6, K, G, h, 16, nb, 6 * nb + 1,
                                lens, 101)
            err = cmp(f"paged_decode {key}", paged_decode(*dec),
                      paged_decode_plain(*dec), dtype)
            timed(rec["paged_decode"], key, err, lambda: paged_decode(*dec),
                  lambda: paged_decode_plain(*dec), sdpa_decode(*dec),
                  decode_bound(dec[0], dec[1], dec[3], dec[4]),
                  f"{shp} B=6 nb={nb} lens={lens}")
            kq, vq, sc = int8_arena(dev, K, 16, h, 6 * nb + 1, dec[3], dec[4],
                                    102)
            qa = (dec[0], kq, vq, dec[3], dec[4])
            err = cmp(f"paged_decode int8 {key}", paged_decode(*qa, **sc),
                      paged_decode_plain(*qa, **sc), dtype)
            timed(rec_q["paged_decode"], key, err,
                  lambda: paged_decode(*qa, **sc),
                  lambda: paged_decode_plain(*qa, **sc),
                  sdpa_decode_int8(*qa, sc),
                  decode_bound(dec[0], kq, dec[3], dec[4]),
                  f"{shp} B=6 nb={nb} int8")
            log.append(f"paged_decode {dn} {sk} ({shp}, B=6, nb={nb}): "
                       f"max_abs_err "
                       f"{rec['paged_decode'][key]['max_abs_err']:.3g}, int8 "
                       f"{err:.3g}")
            del dec, kq, vq, sc, qa
            # paged_prefill: a 128-token chunk over `off` tokens of history
            pre = prefill_inputs(dev, dtype, 1, K, 128, G, h, 16, nb, nb + 1,
                                 [off], [128], 103)
            err = cmp(f"paged_prefill {key}", paged_prefill(*pre),
                      paged_prefill_plain(*pre), dtype)
            timed(rec["paged_prefill"], key, err,
                  lambda: paged_prefill(*pre),
                  lambda: paged_prefill_plain(*pre), sdpa_prefill(*pre),
                  prefill_bound(pre[0], pre[1], pre[3], pre[5], pre[6],
                                pre[7]), f"{shp} S=128 off={off} nb={nb}")
            kq, vq, sc = int8_arena(dev, K, 16, h, nb + 1, pre[5], pre[6],
                                    104)
            qa = (pre[0], pre[1], pre[2], kq, vq, pre[5], pre[6], pre[7])
            err2 = cmp(f"paged_prefill int8 {key}",
                       paged_prefill(*qa, **sc),
                       paged_prefill_plain(*qa, **sc), dtype)
            timed(rec_q["paged_prefill"], key, err2,
                  lambda: paged_prefill(*qa, **sc),
                  lambda: paged_prefill_plain(*qa, **sc),
                  sdpa_prefill_int8(*qa, sc),
                  prefill_bound(pre[0], pre[1], kq, pre[5], pre[6], pre[7]),
                  f"{shp} S=128 off={off} int8")
            pad = prefill_inputs(dev, dtype, 1, K, 128, G, h, 16, nb, nb + 1,
                                 [off // 2 + 5], [100], 105)
            err3 = cmp(f"paged_prefill padded {key}", paged_prefill(*pad),
                       paged_prefill_plain(*pad), dtype,
                       rows=real_rows(pad[7], G))
            log.append(f"paged_prefill {dn} {sk} ({shp}, S=128, S·G="
                       f"{128 * G}, off={off}): max_abs_err {err:.3g}, int8 "
                       f"{err2:.3g}, padded chunk (cl=100) {err3:.3g}")
            del pre, pad, kq, vq, sc, qa
            # spec_verify: six windows of k + 1 = 5 over per-slot histories
            offs = [max(x - 8, 0) for x in lens]
            sa = prefill_inputs(dev, dtype, 6, K, P7_K + 1, G, h, 16, nb,
                                6 * nb + 1, offs, [P7_K + 1, P7_K + 1, 3, 1,
                                                   P7_K + 1, 2], 106)
            rows = real_rows(sa[7], G)
            err = cmp(f"spec_verify {key}", spec_verify(*sa),
                      spec_verify_plain(*sa), dtype, rows=rows)
            timed(rec["spec_verify"], key, err, lambda: spec_verify(*sa),
                  lambda: spec_verify_plain(*sa), sdpa_prefill(*sa),
                  prefill_bound(sa[0], sa[1], sa[3], sa[5], sa[6], sa[7]),
                  f"{shp} B=6 S={P7_K + 1} nb={nb}")
            kq, vq, sc = int8_arena(dev, K, 16, h, 6 * nb + 1, sa[5], sa[6],
                                    107)
            qa = (sa[0], sa[1], sa[2], kq, vq, sa[5], sa[6], sa[7])
            err2 = cmp(f"spec_verify int8 {key}", spec_verify(*qa, **sc),
                       spec_verify_plain(*qa, **sc), dtype, rows=rows)
            timed(rec_q["spec_verify"], key, err2,
                  lambda: spec_verify(*qa, **sc),
                  lambda: spec_verify_plain(*qa, **sc),
                  sdpa_prefill_int8(*qa, sc),
                  prefill_bound(sa[0], sa[1], kq, sa[5], sa[6], sa[7]),
                  f"{shp} B=6 S={P7_K + 1} int8")
            log.append(f"spec_verify {dn} {sk} ({shp}, B=6, S={P7_K + 1}, "
                       f"S·G={(P7_K + 1) * G}, n_tok 5/5/3/1/5/2): "
                       f"max_abs_err {err:.3g}, int8 {err2:.3g}")
            del sa, kq, vq, sc, qa
            # flash_prefill: one whole prompt; h 256 under gemma3's local
            # window (1,024) and with a sink, G 48 causal
            g = torch.Generator(device=dev).manual_seed(108)
            q = torch.randn((K, Sf * G, h), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((K, Sf, h), generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            kws = ((dict(causal=True, window=Ws[0]),
                    dict(causal=True, window=Ws[0], sink=128))
                   if h == 256 else (dict(causal=True),))
            errs = []
            for i, kw in enumerate(kws):
                err = cmp(f"flash_prefill {key} {kw}",
                          flash_prefill(q, k, v, **kw),
                          flash_prefill_plain(q, k, v, **kw), dtype,
                          tol=TOL_DENSE)
                errs.append(err)
                if i == 0:
                    w_, s_ = kw.get("window", 0), kw.get("sink", 0)
                    timed(rec["flash_prefill"], key, err,
                          lambda: flash_prefill(q, k, v, **kw),
                          lambda: flash_prefill_plain(q, k, v, **kw),
                          sdpa_flash(q, k, v, True, w_, s_),
                          flash_bound(q, k, True, w_, s_),
                          f"{shp} S={Sf} {kw}", plain_reps=5)
            log.append(f"flash_prefill {dn} {sk} ({shp}, S={Sf}, "
                       f"{', '.join(str(kw) for kw in kws)}): max_abs_err "
                       f"{', '.join(f'{x:.3g}' for x in errs)}")
            del q, k, v
            # sink_decode: six slots over the dense caches (a wrapped ring)
            for W in Ws:
                g = torch.Generator(device=dev).manual_seed(109 + W)
                q = torch.randn((6, K, G, h), generator=g,
                                device=dev).to(dtype)
                kc, vc = (torch.randn((6, W, K, h), generator=g, device=dev)
                          .to(dtype).transpose(1, 2) for _ in range(2))
                t = torch.tensor([min(x + 1, W + 40) for x in lens],
                                 dtype=torch.int32, device=dev)
                sa = (q, kc, vc, t)
                err = cmp(f"sink_decode {key} W={W}", sink_decode(*sa),
                          sink_decode_plain(*sa), dtype, tol=TOL_DENSE)
                timed(rec["sink_decode"], f"{key}_W{W}", err,
                      lambda: sink_decode(*sa),
                      lambda: sink_decode_plain(*sa), sdpa_sink(*sa),
                      sink_bound(q, kc, t), f"{shp} B=6 W={W}")
                log.append(f"sink_decode {dn} {sk} ({shp}, B=6, W={W}, "
                           f"t={t.tolist()}): max_abs_err {err:.3g}")
            del sa, q, kc, vc
            # block_topk: scores, and the fused select exactly
            ta = topk_inputs(dev, dtype, 6, K, G, h, 16, nb, 6 * nb + 1,
                             lens, 110)
            err = cmp(f"block_topk {key}",
                      block_topk_scores(*ta, block_size=16),
                      block_topk_scores_plain(*ta, block_size=16), dtype)
            timed(rec["block_topk"], key, err,
                  lambda: block_topk_scores(*ta, block_size=16),
                  lambda: block_topk_scores_plain(*ta, block_size=16), None,
                  topk_bound(ta[0], ta[3], ta[4], 16),
                  f"{shp} B=6 nb={nb}")
            log.append(f"block_topk {dn} {sk} ({shp}, B=6, nb={nb}): scores "
                       f"max_abs_err {err:.3g}; "
                       + check_select_exact(ta, nb, dn))
            del ta
        # the decode routine's row-group edges, slots past lens poisoned
        worst = {"paged_decode": 0.0, "sink_decode": 0.0}
        for i, (K, G, h) in enumerate(WIDE_EDGES):
            lens = [1, 16, 17, 300, 511]
            dec = list(decode_inputs(dev, dtype, 5, K, G, h, 16, 32, 161,
                                     lens, 120 + i))
            for b, n in enumerate(lens):
                dec[3][b, -(-n // 16):] = 0
            dec[1][0] = dec[2][0] = 1e4
            err_pd = cmp(f"paged_decode edge K={K} G={G} h={h}",
                         paged_decode(*dec), paged_decode_plain(*dec), dtype)
            worst["paged_decode"] = max(worst["paged_decode"], err_pd)
            g = torch.Generator(device=dev).manual_seed(130 + i)
            q = torch.randn((5, K, G, h), generator=g, device=dev).to(dtype)
            kc, vc = (torch.randn((5, 300, K, h), generator=g, device=dev)
                      .to(dtype) for _ in range(2))
            ts = [1, 16, 17, 300, 420]
            for b, t_b in enumerate(ts):
                kc[b, t_b:] = vc[b, t_b:] = 1e4
            kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
            t = torch.tensor(ts, dtype=torch.int32, device=dev)
            err = cmp(f"sink_decode edge K={K} G={G} h={h}",
                      sink_decode(q, kc, vc, t),
                      sink_decode_plain(q, kc, vc, t), dtype, tol=TOL_DENSE)
            worst["sink_decode"] = max(worst["sink_decode"], err)
            if dtype == torch.float32:
                ek = f"float32_edge_K{K}_G{G}_h{h}"
                timed(rec["paged_decode"], ek, err_pd,
                      lambda: paged_decode(*dec),
                      lambda: paged_decode_plain(*dec), sdpa_decode(*dec),
                      decode_bound(dec[0], dec[1], dec[3], dec[4]),
                      f"K={K} G={G} h={h} B=5 nb=32 lens={lens}")
                timed(rec["sink_decode"], ek, err,
                      lambda: sink_decode(q, kc, vc, t),
                      lambda: sink_decode_plain(q, kc, vc, t),
                      sdpa_sink(q, kc, vc, t), sink_bound(q, kc, t),
                      f"K={K} G={G} h={h} B=5 W=300 t={ts}")
        log.append(f"paged_decode / sink_decode {dn} row-group edges (K, G, "
                   f"h) {WIDE_EDGES}, splits past lens, poisoned null block "
                   f"and slots: max_abs_err {worst['paged_decode']:.3g} / "
                   f"{worst['sink_decode']:.3g}")
        # qwen3-moe's top-k decode: the fused select at phase 13's budget
        K, G, h = TOPK3
        ta = topk_inputs(dev, dtype, 6, K, G, h, 16, 256, 6 * 256 + 1,
                         TOPK_MAIN[1], 111)
        log.append(f"block_topk {dn} qwen3-moe (K={K} G={G} h={h}, nb=256): "
                   + check_select_exact(ta, 256, dn))
        del ta
        # moe_gmm at qwen3-moe's expert shapes (129 slots, top-8)
        for mk, (C, D, F, n_tok) in (("qwen3moe_decode", MOE3_DECODE),
                                     ("qwen3moe_prefill", MOE3_PREFILL)):
            x, w, nv = moe_gmm_inputs(dev, dtype, MOE3_SLOTS, C, D, F, n_tok,
                                      MOE3_TOPK, 112)
            got = moe_gmm(x, w, nv)
            torch.cuda.synchronize()
            err = cmp(f"moe_gmm {mk}", got, moe_gmm_plain(x, w, nv), dtype)
            for s_, n in enumerate(nv.cpu().tolist()):
                if got[s_, n:].any():
                    raise AssertionError(f"moe_gmm {mk}: rows past n_valid "
                                         f"not zero")
            timed(rec["moe_gmm"], f"{dn}_{mk}", err,
                  lambda: moe_gmm(x, w, nv), lambda: moe_gmm_plain(x, w, nv),
                  lambda: torch.bmm(x, w), moe_gmm_bound(x, w, nv),
                  f"S={MOE3_SLOTS} C={C} D={D} F={F}, {int((nv > 0).sum())} "
                  f"live slots, {int(nv.sum())} rows")
            log.append(f"moe_gmm {dn} {mk} x [{MOE3_SLOTS}, {C}, {D}] w "
                       f"[{MOE3_SLOTS}, {D}, {F}], {int((nv > 0).sum())} live "
                       f"slots: max_abs_err {err:.3g}")
            del x, w, got
        torch.cuda.empty_cache()
    return rec, rec_q


# ---- phase 2, continued: jamba-1.5-large-398b's bfloat16 shapes ---------
# phase 14's served shapes: the attention group (K 8, G 8, h 128) over
# phase 3's 512-token context (decode lens, a chunk at offset 384), the
# default pattern's ring (sink 128 + recent 4,096) over phase 5's prompts
# (one 4,608-token whole prompt, six decode slots over W 4,224), and the
# expert product over 17 slots of 8,192 x 24,576, top-2 (a decode step of
# six slots: capacity 8; a 128-token chunk: capacity 32)
JAMBA_ATTN = (8, 8, 128, 32, [1, 17, 100, 255, 448, 512], 384)
JAMBA_SLOTS, JAMBA_TOPK = 17, 2
JAMBA_MOE = {"jamba_decode": (8, 8192, 24576, 6),
             "jamba_chunk": (32, 8192, 24576, 128)}


def check_jamba_kernels(dev, timer, log):
    """The five kernels jamba's served path launches, at its shapes in
    bfloat16 (its published dtype), against their plain versions and timed
    beside the library call and the bound. → {kernel: {"bfloat16_jamba..."
    : record}}."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
    dtype, key = torch.bfloat16, "bfloat16_jamba"
    rec = {n: {} for n in ("paged_decode", "paged_prefill", "flash_prefill",
                           "sink_decode", "moe_gmm")}

    def cmp(name, got, want, tol=TOL, rows=None):
        got, want = got.float(), want.float()
        if rows is not None:
            got, want = rows(got), rows(want)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        torch.testing.assert_close(got, want, **tol[dtype], msg=name)
        return float((got - want).abs().max())

    def timed(out, k, err, run, plain, lib, bnd, shape, plain_reps=None):
        out[k] = {"max_abs_err": err, "ms": timer(run),
                  "plain_ms": timer(plain, reps=plain_reps),
                  "library_ms": timer(lib), "bound_ms": bnd[0],
                  "bound_by": bnd[1], "bytes": bnd[2], "flops": bnd[3],
                  "shape": shape}

    K, G, h, nb, lens, off = JAMBA_ATTN
    shp = f"K={K} G={G} h={h}"
    dec = decode_inputs(dev, dtype, 6, K, G, h, 16, nb, 6 * nb + 1, lens, 201)
    err = cmp("paged_decode jamba", paged_decode(*dec),
              paged_decode_plain(*dec))
    timed(rec["paged_decode"], key, err, lambda: paged_decode(*dec),
          lambda: paged_decode_plain(*dec), sdpa_decode(*dec),
          decode_bound(dec[0], dec[1], dec[3], dec[4]),
          f"{shp} B=6 nb={nb} lens={lens}")
    # the default pattern's decode over the paged ring runs (phase 5's
    # ring tables)
    nbr, lens_r = RING_MAIN
    ring = decode_inputs(dev, dtype, 6, K, G, h, 16, nbr, 6 * nbr + 1,
                         lens_r, 202)
    err_r = cmp("paged_decode jamba ring", paged_decode(*ring),
                paged_decode_plain(*ring))
    timed(rec["paged_decode"], key + "_ring", err_r,
          lambda: paged_decode(*ring), lambda: paged_decode_plain(*ring),
          sdpa_decode(*ring), decode_bound(ring[0], ring[1], ring[3],
                                           ring[4]),
          f"{shp} B=6 nb={nbr} lens={lens_r}")
    log.append(f"paged_decode bfloat16 jamba ({shp}, B=6, nb={nb}): "
               f"max_abs_err {err:.3g}; over the ring runs (nb={nbr}) "
               f"{err_r:.3g}")
    del dec, ring
    pre = prefill_inputs(dev, dtype, 1, K, 128, G, h, 16, nb, nb + 1, [off],
                         [128], 203)
    err = cmp("paged_prefill jamba", paged_prefill(*pre),
              paged_prefill_plain(*pre))
    timed(rec["paged_prefill"], key, err, lambda: paged_prefill(*pre),
          lambda: paged_prefill_plain(*pre), sdpa_prefill(*pre),
          prefill_bound(pre[0], pre[1], pre[3], pre[5], pre[6], pre[7]),
          f"{shp} S=128 off={off} nb={nb}")
    log.append(f"paged_prefill bfloat16 jamba ({shp}, S=128, off={off}): "
               f"max_abs_err {err:.3g}")
    del pre
    g = torch.Generator(device=dev).manual_seed(204)
    q = torch.randn((K, FLASH_MAIN_S * G, h), generator=g,
                    device=dev).to(dtype)
    k, v = (torch.randn((K, FLASH_MAIN_S, h), generator=g, device=dev)
            .to(dtype) for _ in range(2))
    err = cmp("flash_prefill jamba", flash_prefill(q, k, v, causal=True),
              flash_prefill_plain(q, k, v, causal=True), tol=TOL_DENSE)
    timed(rec["flash_prefill"], key, err,
          lambda: flash_prefill(q, k, v, causal=True),
          lambda: flash_prefill_plain(q, k, v, causal=True),
          sdpa_flash(q, k, v, True, 0, 0), flash_bound(q, k, True, 0, 0),
          f"{shp} S={FLASH_MAIN_S} causal", plain_reps=3)
    log.append(f"flash_prefill bfloat16 jamba ({shp}, S={FLASH_MAIN_S}, "
               f"causal): max_abs_err {err:.3g}")
    del q, k, v
    W, ts = SINK_MAIN[0]
    q = torch.randn((6, K, G, h), generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn((6, W, K, h), generator=g, device=dev).to(dtype)
              .transpose(1, 2) for _ in range(2))
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    sa = (q, kc, vc, t)
    err = cmp("sink_decode jamba", sink_decode(*sa), sink_decode_plain(*sa),
              tol=TOL_DENSE)
    timed(rec["sink_decode"], key, err, lambda: sink_decode(*sa),
          lambda: sink_decode_plain(*sa), sdpa_sink(*sa),
          sink_bound(q, kc, t), f"{shp} B=6 W={W} t={ts}")
    log.append(f"sink_decode bfloat16 jamba ({shp}, B=6, W={W}, t={ts}): "
               f"max_abs_err {err:.3g}")
    del q, kc, vc, sa
    # the expert product: one weight stream of 17 x 8,192 x 24,576 (6.8 GB)
    # shared by the decode and the chunk shapes
    D, F = JAMBA_MOE["jamba_decode"][1:3]
    g = torch.Generator(device=dev).manual_seed(205)
    w = torch.empty((JAMBA_SLOTS, D, F), dtype=dtype, device=dev)
    for i in range(JAMBA_SLOTS):
        w[i] = (torch.randn((D, F), generator=g, device=dev) * 0.02).to(dtype)
    for mk, (C, D, F, n_tok) in JAMBA_MOE.items():
        nv = slot_rows(dev, JAMBA_SLOTS, C, n_tok, JAMBA_TOPK, 206)
        rows = torch.arange(C, device=dev)[None, :, None] \
            < nv.long()[:, None, None]
        x = (torch.randn((JAMBA_SLOTS, C, D), generator=g, device=dev)
             * rows).to(dtype)
        got = moe_gmm(x, w, nv)
        torch.cuda.synchronize()
        err = cmp(f"moe_gmm {mk}", got, moe_gmm_plain(x, w, nv))
        for s_, n in enumerate(nv.cpu().tolist()):
            if got[s_, n:].any():
                raise AssertionError(f"moe_gmm {mk}: rows past n_valid not "
                                     f"zero")
        timed(rec["moe_gmm"], f"bfloat16_{mk}", err,
              lambda: moe_gmm(x, w, nv), lambda: moe_gmm_plain(x, w, nv),
              lambda: torch.bmm(x, w), moe_gmm_bound(x, w, nv),
              f"S={JAMBA_SLOTS} C={C} D={D} F={F}, {int((nv > 0).sum())} "
              f"live slots, {int(nv.sum())} rows", plain_reps=5)
        log.append(f"moe_gmm bfloat16 {mk} x [{JAMBA_SLOTS}, {C}, {D}] w "
                   f"[{JAMBA_SLOTS}, {D}, {F}], {int((nv > 0).sum())} live "
                   f"slots: max_abs_err {err:.3g}")
        del x, got
    del w
    torch.cuda.empty_cache()
    return rec


# ---- phase 2, continued: the head dims of phase 16 (h 80, h 96) --------
# phase 16's shapes: phi-3-vision's whole-prompt prefill (one 1,024-row
# prompt: 32 heads, h 96, causal) and its B 2 decode over the dense caches
# (W 1,040: the 1,024 prompt rows and 16 steps; t the first and the last
# step's occupancy); hubert's encoder pass (two 1,024-frame clips in one
# batch: 2 x 16 heads, h 80, bidirectional); paged_decode at both head
# dims over 1,040-token tables (not on phase 16's path: the Server refuses
# both families)
P16_FLASH = {"h96": (32, 1024, 96, True), "h80": (32, 1024, 80, False)}
P16_SINK = (2, 32, 96, 1040, [1025, 1040])
P16_PAGED = {"h96": (32, 96), "h80": (16, 80)}
P16_PAGED_LENS = [1025, 1040]
# (N or K, G, h) of the correctness cases: G 1, a GQA group at a decode
# CTA's row limit (25 rows at h 80, 21 at 96) and one row past it
P16_EDGES = ((4, 1, 80), (4, 1, 96), (1, 25, 80), (1, 26, 80), (1, 21, 96),
             (1, 22, 96))


def check_frontend_kernels(dev, timer, log):
    """flash_prefill, sink_decode and paged_decode (float and int8 pages)
    at h 80 and 96, float32 and bfloat16, against their plain versions:
    edge cases, then phase 16's shapes timed beside the plain version, the
    library call and the bound. At h 80 a decode lane owns 3 channels, the
    last lanes masked: channels 64-79 are checked on their own. → ({kernel:
    {"<dtype>_h80" / "_h96": record}}, {"paged_decode": int8 records})."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
    rec = {n: {} for n in ("flash_prefill", "sink_decode", "paged_decode")}
    rec_q = {"paged_decode": {}}

    def cmp(name, got, want, dtype, tol):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        torch.testing.assert_close(got, want, **tol[dtype], msg=name)
        if got.shape[-1] == 80:
            tail = got[..., 64:80]
            torch.testing.assert_close(tail, want[..., 64:80], **tol[dtype],
                                       msg=f"{name} channels 64-79")
            if not float(tail.abs().amax()) > 0:
                raise AssertionError(f"{name}: channels 64-79 are zero")
        return float((got - want).abs().max())

    def timed(out, k, err, run, plain, lib, bnd, shape, plain_reps=None):
        out[k] = {"max_abs_err": err, "ms": timer(run),
                  "plain_ms": timer(plain, reps=plain_reps),
                  "library_ms": timer(lib), "bound_ms": bnd[0],
                  "bound_by": bnd[1], "bytes": bnd[2], "flops": bnd[3],
                  "shape": shape}

    def rand(g, shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        g = torch.Generator(device=dev).manual_seed(160)
        worst = dict.fromkeys(("flash", "sink", "paged", "int8"), 0.0)
        for N, G, h in P16_EDGES:
            for S, kw in ((333, dict(causal=False)), (300, dict(causal=True)),
                          (200, dict(causal=True, window=64, sink=8)),
                          (177, dict(causal=False, window=40, sink=16))):
                q = rand(g, (N, S * G, h), dtype)
                k, v = (rand(g, (N, S, h), dtype) for _ in range(2))
                worst["flash"] = max(worst["flash"], cmp(
                    f"flash_prefill h={h} G={G} S={S} {kw}",
                    flash_prefill(q, k, v, **kw),
                    flash_prefill_plain(q, k, v, **kw), dtype, TOL_DENSE))
            ts = [1, 17, 400, 1041, 1100]
            B, W = len(ts), 1041
            q = rand(g, (B, N, G, h), dtype)
            kc, vc = (rand(g, (B, W, N, h), dtype) for _ in range(2))
            for b, t_b in enumerate(ts):
                kc[b, t_b:] = vc[b, t_b:] = 1e4
            kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
            t = torch.tensor(ts, dtype=torch.int32, device=dev)
            worst["sink"] = max(worst["sink"], cmp(
                f"sink_decode h={h} G={G} t={ts}", sink_decode(q, kc, vc, t),
                sink_decode_plain(q, kc, vc, t), dtype, TOL_DENSE))
            lens, nb = [1, 17, 300, 1041], 66
            dec = decode_inputs(dev, dtype, len(lens), N, G, h, 16, nb,
                                len(lens) * nb + 1, lens, 161 + h + G)
            tables = dec[3]
            for b, n in enumerate(lens):
                tables[b, -(-n // 16):] = 0
            dec[1][0] = dec[2][0] = 1e4            # the poisoned null block
            worst["paged"] = max(worst["paged"], cmp(
                f"paged_decode h={h} G={G}", paged_decode(*dec),
                paged_decode_plain(*dec), dtype, TOL))
            kq, vq, sc = int8_arena(dev, N, 16, h, len(lens) * nb + 1,
                                    tables, lens, 162 + h + G)
            a8 = (dec[0], kq, vq, tables, dec[4])
            worst["int8"] = max(worst["int8"], cmp(
                f"paged_decode int8 h={h} G={G}", paged_decode(*a8, **sc),
                paged_decode_plain(*a8, **sc), dtype, TOL))
            del dec, a8, kq, vq, sc
        log.append(f"h 80 / 96 {dn} ((K, G, h) {list(P16_EDGES)}; channels "
                   f"64-79 held on their own at h 80): flash_prefill "
                   f"(causal, bidirectional, window + sink, ragged S) "
                   f"max_abs_err {worst['flash']:.3g}; sink_decode (t 1 .. "
                   f"> W 1,041, slots past t poisoned) {worst['sink']:.3g}; "
                   f"paged_decode (lens 1 .. 1,041, null block poisoned) "
                   f"{worst['paged']:.3g}, int8 pages {worst['int8']:.3g}")
        # phase 16's shapes, timed
        for sub, (N, S, h, causal) in P16_FLASH.items():
            q = rand(g, (N, S, h), dtype)
            k, v = (rand(g, (N, S, h), dtype) for _ in range(2))
            fa = (q, k, v)
            err = cmp(f"flash_prefill {sub} main", flash_prefill(
                *fa, causal=causal), flash_prefill_plain(*fa, causal=causal),
                dtype, TOL_DENSE)
            timed(rec["flash_prefill"], f"{dn}_{sub}", err,
                  lambda: flash_prefill(*fa, causal=causal),
                  lambda: flash_prefill_plain(*fa, causal=causal),
                  sdpa_flash(q, k, v, causal, 0, 0),
                  flash_bound(q, k, causal, 0, 0),
                  f"N={N} S={S} G=1 h={h} "
                  f"{'causal' if causal else 'bidirectional'}")
            del q, k, v, fa
        B, K, h, W, ts = P16_SINK
        q = rand(g, (B, K, 1, h), dtype)
        kc, vc = (rand(g, (B, W, K, h), dtype).transpose(1, 2)
                  for _ in range(2))
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        sa = (q, kc, vc, t)
        err = cmp("sink_decode h96 main", sink_decode(*sa),
                  sink_decode_plain(*sa), dtype, TOL_DENSE)
        timed(rec["sink_decode"], f"{dn}_h96", err, lambda: sink_decode(*sa),
              lambda: sink_decode_plain(*sa), sdpa_sink(*sa),
              sink_bound(q, kc, t), f"B={B} K={K} G=1 h={h} W={W} t={ts}")
        del q, kc, vc, sa
        nb = -(-W // 16)
        for sub, (K, h) in P16_PAGED.items():
            lens = P16_PAGED_LENS
            dec = decode_inputs(dev, dtype, 2, K, 1, h, 16, nb, 2 * nb + 1,
                                lens, 163 + h)
            shape = f"B=2 K={K} G=1 h={h} nb={nb} lens={lens}"
            err = cmp(f"paged_decode {sub} main", paged_decode(*dec),
                      paged_decode_plain(*dec), dtype, TOL)
            timed(rec["paged_decode"], f"{dn}_{sub}", err,
                  lambda: paged_decode(*dec), lambda: paged_decode_plain(*dec),
                  sdpa_decode(*dec), decode_bound(dec[0], dec[1], dec[3],
                                                  dec[4]), shape)
            kq, vq, sc = int8_arena(dev, K, 16, h, 2 * nb + 1, dec[3], lens,
                                    164 + h)
            a8 = (dec[0], kq, vq, dec[3], dec[4])
            err = cmp(f"paged_decode int8 {sub} main",
                      paged_decode(*a8, **sc), paged_decode_plain(*a8, **sc),
                      dtype, TOL)
            timed(rec_q["paged_decode"], f"{dn}_{sub}", err,
                  lambda: paged_decode(*a8, **sc),
                  lambda: paged_decode_plain(*a8, **sc),
                  sdpa_decode_int8(*a8, sc),
                  decode_bound(dec[0], kq, dec[3], dec[4]), shape)
            rec_q["paged_decode"][f"{dn}_{sub}"]["library"] = "dequant+sdpa"
            del dec, a8, kq, vq, sc
    torch.cuda.empty_cache()
    return rec, rec_q


def check_select_exact(ta, nb, dn) -> str:
    """block_topk_select at two budgets (absolute and frac 0.25) against
    select_kv_blocks on the launch's own scores, exactly. → a log phrase."""
    from repro_torch.kernels.block_topk import (block_topk_select,
                                                select_kv_blocks)
    for kw in (dict(k_static=max(nb // 4, 3), frac=0.0),
               dict(k_static=max(-(-nb // 4), 3), frac=0.25)):
        kw = dict(kw, sink_blocks=1, recent_blocks=2)
        got = block_topk_select(*ta, block_size=16, **kw)
        want = select_kv_blocks(got[0], ta[3], ta[4], block_size=16, **kw)
        for name, a, b in zip(("tables", "lens", "m", "selected"), got[1:5],
                              want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"block_topk_select {dn} nb={nb} {kw}: "
                                     f"{name} differ from select_kv_blocks")
    return "fused select equals select_kv_blocks on its scores (absolute " \
        "and frac 0.25 budgets)"


# ---- phase 3: full-width serving -------------------------------------
def workload(vocab, n=12, seed=7):
    """benchmarks/bench_serving.py::_workload: two of three prompts carry a
    384-token shared prefix + 64 distinct tokens, the rest 16 tokens;
    4 new tokens each."""
    rng = np.random.default_rng(seed)
    base = tuple(int(t) for t in rng.integers(0, vocab, 384))
    out = []
    for i in range(n):
        if i % 3 != 2:
            out.append(base + tuple(int(t) for t in
                                    rng.integers(0, vocab, 64)))
        else:
            out.append(tuple(int(t) for t in rng.integers(0, vocab, 16)))
    return out, base


def build_server(cfg, reuse, dev, params=None, spec=None, kv_blocks=320,
                 placement=None, **extra):
    """Phase 3's server; `extra` sets further ServerConfig knobs (the
    placement monitor of phase 8, `quant` of phase 9, phase 12's instance
    counts, watchdog and `oas`); `placement` a DevicePlacement (phase 10's
    capture=False), else the default on `dev` (capture on for cuda)."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    knobs = dict(n_prefill=1, n_decode=1,
                 oas=OASConfig(defer_window=0.0)) | extra
    scfg = ServerConfig(decode_slots=6, max_len=512, chunk_tokens=128,
                        prefill_tick_budget=512, prefix_reuse=reuse,
                        kv_blocks=kv_blocks, kv_block_size=16, spec=spec,
                        **knobs)
    return Server(cfg, scfg, pattern=[0] * cfg.n_layers, params=params,
                  seed=0, device=dev, placement=placement)


def hot_loops(srv) -> dict:
    """The server's hot-loop registry: per entry name its keys, eager calls,
    captures and replays."""
    return srv.placement.hot_loops.summary()


def check_hot_loops(srv, before, dev, entries=("decode.step",)) -> dict:
    """The hot-loop calls since `before` (a `hot_loops` snapshot), per
    entry name: keys met so far, eager calls, captures and replays (and
    each engine's replays), and the graph pool's bytes. Under capture every
    engine's entry of each name in `entries` must have replayed."""
    out = {}
    for name, a in hot_loops(srv).items():
        b = before.get(name, {"eager": 0, "captures": 0, "replays": 0,
                              "replays_each": []})
        prev = b["replays_each"] + [0] * (len(a["replays_each"])
                                          - len(b["replays_each"]))
        out[name] = {"keys": len(a["keys"])} | {
            k: a[k] - b[k] for k in ("eager", "captures", "replays")} | {
            "replays_each": [x - y for x, y in zip(a["replays_each"],
                                                   prev)]}
    if dev.type == "cuda" and srv.placement.capture:
        for name in entries:
            each = out.get(name, {}).get("replays_each", [])
            assert each and all(r > 0 for r in each), (name, out)
    out["pool_gb"] = srv.placement.graph_pool_bytes() / 1e9
    return out


# the entries a server with chunked prefill replays in a measured run
CHUNKED_ENTRIES = ("decode.step", "prefill.chunk")


def hot_loop_line(hl) -> str:
    return "; ".join(f"{n}: {v['keys']} keys, {v['eager']} eager, "
                     f"{v['captures']} captures, {v['replays']} replays"
                     + (f" {v['replays_each']}"
                        if len(v["replays_each"]) > 1 else "")
                     for n, v in hl.items() if n != "pool_gb") + \
        f"; graph pool {hl['pool_gb']:.3f} GB"


def reset_stats(srv):
    from repro_torch.core.proxy import MetricsAggregator
    srv.metrics = MetricsAggregator()
    for e in srv.prefills:
        e.store.clear()
        for k in e.stats:
            e.stats[k] = 0.0 if k == "busy_s" else 0
    for e in srv.decodes:
        for k in e.stats:
            e.stats[k] = 0.0 if k == "busy_s" else 0
        for k in ("sparsity", "spec", "moe_counts"):  # device-side windows
            if k in e.state:
                e.state[k].zero_()
        if srv.quant_ctl is not None:     # static residency figures
            srv.quant_ctl.note(e.stats)


def drive(srv, prompts, params):
    """The main path: Server.generate until every request finishes."""
    t0 = time.monotonic()
    outs = list(srv.generate(prompts, params, max_wall_s=900))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    srv.drain_decode_stats()        # sparsity / speculation windows
    by_rid = {}
    for o in outs:
        by_rid.setdefault(o.rid, []).extend(o.new_tokens)
    finished = [o.finish_reason for o in outs if o.finished]
    # add_request hands out rids in prompt order
    streams = [by_rid[r] for r in sorted(by_rid)]
    return streams, finished, srv.metrics.summary(wall), wall


def full_width_config():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b").with_updates(compute_dtype="float32",
                                                param_dtype="float32")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 1536, 12, 2, 128, 8960, 151936)
    return cfg


def serve(dev, log, cfg, weights=None, timer=None):
    """Phase 3 on `cfg` (full-width qwen2-1.5b in main(); phase 13 passes
    its decoders with their `weights`). With a `timer`, also the device ms
    of a captured step with a sampled slot against all-greedy
    (`draw_cost`)."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    n_layers = cfg.n_layers
    prompts, base = workload(cfg.vocab_size)
    rng = np.random.default_rng(11)
    prompts += [base + tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          64))
                for _ in range(2)]
    params = [SamplingParams(max_tokens=4)] * 12 + [
        SamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=900 + i,
                       max_tokens=4) for i in (12, 13)]
    t0 = time.monotonic()
    srv = build_server(cfg, True, dev, params=weights)
    torch.cuda.synchronize()
    log.append(f"server built (weights + arena) in "
               f"{time.monotonic() - t0:.1f} s")
    # warm-up: the same workload shape on other tokens (every chunk bucket,
    # decode batch and cuBLAS shape the measured run meets), outside the
    # counts and the metrics
    warm_prompts, _ = workload(cfg.vocab_size, seed=8)
    list(srv.generate(warm_prompts, SamplingParams(max_tokens=4)))
    reset_stats(srv)

    hl0 = hot_loops(srv)
    paged_prefill.launches = 0
    paged_decode.launches = 0
    streams, finished, summ, wall = drive(srv, prompts, params)
    n_pre, n_dec = paged_prefill.launches, paged_decode.launches
    hl = check_hot_loops(srv, hl0, dev, entries=CHUNKED_ENTRIES)

    ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
    assert len(finished) == len(prompts) and all(
        r == "length" for r in finished), finished
    assert len(streams) == len(prompts) and all(
        len(s) == 4 for s in streams), streams
    assert ds["host_fetches"] == ds["steps"] > 0, ds
    if dev.type == "cuda":
        assert n_pre == ps["chunks"] * n_layers > 0, (n_pre, ps["chunks"])
        assert n_dec == ds["steps"] * n_layers > 0, (n_dec, ds["steps"])
    assert ps["reused_tokens"] > 0 and ds["handoff_copy_bytes"] == 0
    srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)

    off = build_server(cfg, False, dev, params=srv.params)
    list(off.generate(warm_prompts, SamplingParams(max_tokens=4)))
    reset_stats(off)
    hl0 = hot_loops(off)
    streams_off, finished_off, summ_off, wall_off = drive(off, prompts,
                                                          params)
    hl_off = check_hot_loops(off, hl0, dev, entries=CHUNKED_ENTRIES)
    assert len(finished_off) == len(prompts)
    assert streams[:12] == streams_off[:12], \
        "greedy streams differ with prefix reuse on and off"
    off.kv_arena.pool.check_invariants(arena=off.kv_arena)
    sampled_equal = all(streams[r] == streams_off[r] for r in (12, 13))
    draw = None if timer is None else draw_cost(srv, dev, timer)
    return {"launches": {"paged_prefill": n_pre, "paged_decode": n_dec},
            "draw": draw,
            "prefill_chunks": ps["chunks"], "decode_steps": ds["steps"],
            "host_fetches": ds["host_fetches"],
            "reused_tokens": ps["reused_tokens"],
            "prefill_tokens": ps["tokens"],
            "reuse_on": {k: summ[k] for k in (
                "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")} | {"wall_s": wall},
            "reuse_off": {k: summ_off[k] for k in (
                "n_done", "ttft_mean", "tpot_mean_ms", "ott_tok_s",
                "ttt_tok_s")} | {"wall_s": wall_off},
            "sampled_streams_equal_on_off": sampled_equal,
            "host_s_per_round": ds["busy_s"] / ds["steps"],
            "hot_loops": hl, "hot_loops_reuse_off": hl_off,
            "streams": streams,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ---- phase 5: the default OmniAttn pattern, whole-prompt prefill ------
def default_pattern_workload(vocab, seed=21):
    """3 distinct 4,400-token prompts (past the 4,224-slot ring, which wraps
    during prefill), an exact repeat of the first right behind it (whole
    adoption from the prefix store), two 16-token prompts: 8 greedy tokens
    each; plus one seeded sampled 16-token request, the seventh for six
    slots, so one request waits for a slot."""
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(seed)

    def toks(n):
        return tuple(int(t) for t in rng.integers(0, vocab, n))
    longs = [toks(P5_LONG) for _ in range(3)]
    prompts = [longs[0], longs[0], longs[1], longs[2], toks(P5_SHORT),
               toks(P5_SHORT), toks(P5_SHORT)]
    params = [SamplingParams(max_tokens=8)] * 6 + [SamplingParams(
        temperature=0.9, top_k=64, top_p=0.95, seed=905, max_tokens=8)]
    return prompts, params


def build_default_server(cfg, paged, dev, params=None, placement=None):
    """Both layouts get the paged default's pool: every slot max_len plus
    one prompt of prefill headroom, (6 + 1) x 288 blocks. (The slot-dense
    engine's own default accounting pool, 4 x 16 GiB / bytes per slot, is
    276 blocks at this width: one 4,400-token request at a time.)
    `placement` a DevicePlacement (capture=False), else the default."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    scfg = ServerConfig(decode_slots=6, max_len=P5_MAX_LEN, kv_block_size=16,
                        prefix_reuse=True, prefix_cache_cap=4,
                        kv_blocks=(6 + 1) * -(-P5_MAX_LEN // 16),
                        paged_kv=paged, oas=OASConfig(defer_window=0.0))
    return Server(cfg, scfg, pattern=None, params=params, seed=0,
                  device=dev, placement=placement)


# the entries a whole-prompt server replays in a measured run
WHOLE_ENTRIES = ("decode.step", "prefill.full", "prefill.first")


def warm_whole(srv, warm) -> dict:
    """Phase 5's warm-up on other tokens, outside the counts and the
    metrics: a pass over a 4,400- and a 16-token prompt (each prefill
    bucket's and decode key's eager first call, cuBLAS shapes), the
    second call of each prefill bucket alone (under capture it captures
    the bucket's graph and replays it: → its wall ms), and a second pass
    (the decode keys' captures), so the measured run only replays."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving.prefill import PrefillTask
    for i in range(2):
        list(srv.generate([warm[0], warm[4]], SamplingParams(max_tokens=2)))
        reset_stats(srv)
        if i:
            break
        out = {}
        for k, prompt in (("long", warm[0]), ("short", warm[4])):
            torch.cuda.synchronize()
            t = time.perf_counter()
            srv.prefills[0]._run_full(PrefillTask(-1, tuple(prompt)))
            torch.cuda.synchronize()
            out[k] = (time.perf_counter() - t) * 1e3
    return out


def whole_prefill_turns(servers: dict, prompts: dict, reps: int) -> dict:
    """Host and wall ms of one whole prefill (`PrefillEngine._run_full`:
    the upload, the "prefill.full" replay or its eager launches, the
    clones) on each server, in turns (a, b, b, a per rep, so drift in the
    process is shared): host ms until the call returns, wall ms until the
    card is done too. → {server: {prompt name: {"host_ms", "wall_ms"}
    medians, "n"}}."""
    from repro_torch.serving.prefill import PrefillTask
    got = {n: {k: ([], []) for k in prompts} for n in servers}
    order = list(servers) + list(servers)[::-1]
    for _ in range(reps):
        for name in order:
            eng = servers[name].prefills[0]
            for k, prompt in prompts.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                eng._run_full(PrefillTask(-1, tuple(prompt)))
                host = time.perf_counter() - t
                torch.cuda.synchronize()
                got[name][k][0].append(host * 1e3)
                got[name][k][1].append((time.perf_counter() - t) * 1e3)
    return {n: {k: {"host_ms": float(np.median(h)),
                    "wall_ms": float(np.median(w)), "n": len(h)}
                for k, (h, w) in by.items()} for n, by in got.items()}


def top2_margin(srv, prompt, stream, i, sp=None):
    """Top-2 margin of what the draw maximised at stream position i,
    recomputed by a whole-prompt prefill of prompt + stream[:i]: the logits
    of a greedy request (`sp` None or temperature 0), the masked scaled
    logits + the threefry Gumbel noise of (seed, context length) of a
    seeded sampled one."""
    ctx = list(prompt) + list(stream[:i])
    S = min(1 << (len(ctx) - 1).bit_length(), srv.scfg.max_len)
    dev = srv.lm.device
    toks = torch.tensor([ctx + [0] * (S - len(ctx))], dtype=torch.int32,
                        device=dev)
    _, logits, _ = srv.lm.prefill(srv.params, toks,
                                  max_len=srv.scfg.max_len,
                                  true_len=len(ctx), tables=srv.tables)
    z = logits.float()
    if sp is not None and sp.temperature > 0:
        from repro_torch.core.proxy.params import device_row
        from repro_torch.serving.prng import fold_in, gumbel
        from repro_torch.serving.sampling import kept_mask
        assert sp.seed is not None, "a sampled request's margin needs a seed"
        t, k, p, key = device_row(sp)
        scaled, keep = kept_mask(
            z, torch.tensor([t], device=dev), torch.tensor([k], device=dev),
            torch.tensor([p], device=dev))
        noise = gumbel(fold_in(torch.from_numpy(key.astype(np.int64))[None]
                               .to(dev), torch.tensor([len(ctx)],
                                                      device=dev)),
                       z.shape[1])
        z = torch.where(keep, scaled, torch.full_like(scaled, -math.inf)) \
            + noise
    top = torch.topk(z[0], 2).values
    return float(top[0] - top[1])


def serve_default_pattern(dev, log, cfg):
    """Phase 5 on `cfg` (full-width qwen2-1.5b in main()): pattern=None, 21
    compressed layers (sink 128 + recent 4096) and 7 full ones, served twice
    — paged KV (flash_prefill + paged_decode) and slot-dense KV
    (flash_prefill + sink_decode) — with the counts zeroed just before each
    measured run and read just after. Every whole prefill of the measured
    runs replays a "prefill.full" graph (the warm-up met both buckets), and
    first tokens replay "prefill.first". Each layout is served again with
    capture=False on the same weights: every stream, the sampled one too,
    equal up to phase 5's near-tie rule; then host and wall ms of one whole
    prefill (16 and 4,400 tokens), captured and eager in turns."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    from repro_torch.kernels.sink_decode import sink_decode
    from repro_torch.models.stack import full_attn_layer
    from repro_torch.serving import DevicePlacement
    specs = None
    n_layers = cfg.n_layers
    prompts, params = default_pattern_workload(cfg.vocab_size)
    warm, _ = default_pattern_workload(cfg.vocab_size, seed=22)
    out, servers, weights = {}, {}, None
    for paged in (True, False):
        name = "paged" if paged else "dense"
        t0 = time.monotonic()
        srv = build_default_server(cfg, paged, dev, params=weights)
        weights = srv.params
        specs = srv.lm.plan.all_specs()
        torch.cuda.synchronize()
        log.append(f"{name}: server built in {time.monotonic() - t0:.1f} s")
        capture_ms = warm_whole(srv, warm)
        hl0 = hot_loops(srv)
        for kern in (flash_prefill, paged_decode, sink_decode,
                     paged_prefill):
            kern.launches = 0
        streams, finished, summ, wall = drive(srv, prompts, params)
        hl = check_hot_loops(srv, hl0, dev, entries=WHOLE_ENTRIES)
        launches = {"flash_prefill": flash_prefill.launches,
                    "paged_decode": paged_decode.launches,
                    "sink_decode": sink_decode.launches,
                    "paged_prefill": paged_prefill.launches}
        ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
        assert len(finished) == len(prompts) and all(
            r == "length" for r in finished), finished
        assert all(len(x) == 8 for x in streams), streams
        assert not srv.prefills[0].chunked
        assert ds["host_fetches"] == ds["steps"] > 0, ds
        assert ps["cache_hits"] == 1 and ps["prefills"] == len(prompts) - 1, \
            ps
        full = hl["prefill.full"]
        assert full["eager"] + full["replays"] == ps["prefills"], (hl, ps)
        assert hl["prefill.first"]["eager"] + hl["prefill.first"][
            "replays"] == ps["host_fetches"], (hl, ps)
        if dev.type == "cuda":          # the counts move only on the card
            # every whole prefill a replay: flash_prefill counted by them
            assert full["eager"] == 0, hl
            assert launches["flash_prefill"] == ps["prefills"] * n_layers \
                > 0, (launches, ps)
            dec = "paged_decode" if paged else "sink_decode"
            other = "sink_decode" if paged else "paged_decode"
            assert launches[dec] == ds["steps"] * n_layers > 0, \
                (launches, ds)
            assert launches[other] == 0 == launches["paged_prefill"], \
                launches
        srv.decodes[0].pool.check_invariants(arena=srv.kv_arena)
        recs = sorted(srv.metrics.done, key=lambda r: r.rid)
        # the same traffic eagerly (capture=False) on the same weights
        eag = build_default_server(
            cfg, paged, dev, params=weights,
            placement=DevicePlacement.of(dev, capture=False))
        eager_ms = warm_whole(eag, warm)
        e_hl0 = hot_loops(eag)
        e_streams, e_fin, e_summ, e_wall = drive(eag, prompts, params)
        e_hl = check_hot_loops(eag, e_hl0, dev)
        assert all(v["captures"] == v["replays"] == 0
                   for n, v in e_hl.items() if n != "pool_gb"), e_hl
        assert len(e_fin) == len(prompts), e_fin
        e_recs = sorted(eag.metrics.done, key=lambda r: r.rid)
        ties = []
        for r, (a, b) in enumerate(zip(streams, e_streams)):
            if a == b:
                continue
            i = next(j for j in range(len(a)) if a[j] != b[j])
            margin = top2_margin(srv, prompts[r], a, i, params[r])
            log.append(f"{name}: request {r} differs captured vs eager at "
                       f"token {i}, top-2 margin {margin:.3g}")
            if margin >= 1e-4:
                raise AssertionError(f"{name}: stream {r} differs captured "
                                     f"vs eager at token {i} (top-2 margin "
                                     f"{margin:.3g})")
            ties.append({"request": r, "token": i, "margin": margin})
        turns = whole_prefill_turns(
            {"captured": srv, "eager": eag},
            {"short": prompts[4], "long": prompts[2]}, reps=P5_TURNS)
        del eag
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = {"launches": launches, "whole_prefills": ps["prefills"],
                     "cache_hits": ps["cache_hits"],
                     "decode_steps": ds["steps"],
                     "host_fetches": ds["host_fetches"],
                     "host_s_per_round": ds["busy_s"] / ds["steps"],
                     "hot_loops": hl,
                     "preemptions": ds["preemptions"],
                     "metrics": {k: summ[k] for k in (
                         "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                         "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")}
                     | {"wall_s": wall},
                     "ttft_short_ms": [r.ttft() * 1e3 for r in recs[4:7]],
                     "second_call_ms": capture_ms,
                     "eager": {"metrics": {k: e_summ[k] for k in (
                         "ttft_mean", "tpot_mean_ms", "ttt_tok_s")}
                         | {"wall_s": e_wall},
                         "ttft_short_ms": [r.ttft() * 1e3
                                           for r in e_recs[4:7]],
                         "second_call_ms": eager_ms,
                         "streams_equal_captured": not ties,
                         "near_ties": ties},
                     "whole_prefill_ms": turns,
                     "streams": streams}
        servers[name] = srv
    # greedy streams (requests 0-5) identical across the two layouts, up to
    # a near-tie at the first differing step
    ties = []
    for r in range(6):
        a, b = out["paged"]["streams"][r], out["dense"]["streams"][r]
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        margin = top2_margin(servers["paged"], prompts[r], a, i)
        log.append(f"request {r}: layouts differ at token {i}, top-2 logit "
                   f"margin {margin:.3g}")
        if margin >= 1e-4:
            raise AssertionError(f"greedy streams of request {r} differ "
                                 f"across KV layouts at token {i} (top-2 "
                                 f"margin {margin:.3g})")
        ties.append({"request": r, "token": i, "margin": margin})
    n_comp = sum(s.compressed for s in specs)
    n_full = sum(full_attn_layer(cfg, s) for s in specs)
    return {"layouts": {k: {kk: vv for kk, vv in v.items()
                            if kk != "streams"} for k, v in out.items()},
            "compressed_layers": n_comp, "full_layers": n_full,
            "greedy_streams_identical": not ties, "near_ties": ties,
            "sampled_stream_equal": out["paged"]["streams"][6]
            == out["dense"]["streams"][6],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ---- phase 11: chunked prefill over ring layers and dense KV ----------
def build_ring_chunk_server(cfg, paged, chunked, dev, params=None):
    """Phase 11's server: full-width qwen2-1.5b under pattern=None with
    prefill_sparse (the 21 compressed layers attend sink + window in
    prefill too, so a chunk over their rings is exact), max_len 4608, chunks
    of 128 and phase 5's pool of (6 + 1) x 288 = 2016 blocks, in either KV
    layout; chunked=False is whole-prompt prefill of the same model."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    scfg = ServerConfig(decode_slots=6, max_len=P5_MAX_LEN, kv_block_size=16,
                        prefix_reuse=True, prefix_cache_cap=4,
                        kv_blocks=(6 + 1) * -(-P5_MAX_LEN // 16),
                        chunk_tokens=128, prefill_tick_budget=512,
                        paged_kv=paged, chunked_prefill=chunked,
                        oas=OASConfig(defer_window=0.0))
    return Server(cfg.with_updates(prefill_sparse=True), scfg, pattern=None,
                  params=params, seed=0, device=dev)


def serve_ring_chunks(dev, log, cfg, timer):
    """Phase 11 on `cfg` (full-width qwen2-1.5b in main()): phase 5's
    traffic (4,400-token prompts that wrap the 4,224-slot rings) served (a)
    chunked over paged KV, (b) chunked over dense KV and (c) whole-prompt,
    with the counts zeroed just before each measured run and read just
    after; then the device time of one chunk's private-leaf copies (the
    task's rings, and in (b) its full layers, into the static cache and
    back out)."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    from repro_torch.kernels.sink_decode import sink_decode
    from repro_torch.models.stack import full_attn_layer
    n_layers = cfg.n_layers
    prompts, params = default_pattern_workload(cfg.vocab_size)
    warm, _ = default_pattern_workload(cfg.vocab_size, seed=22)
    runs = {"paged": (True, True), "dense": (False, True),
            "whole_prompt": (True, False)}
    out, streams, weights, srv_a = {}, {}, None, None
    for name, (paged, chunked) in runs.items():
        t0 = time.monotonic()
        srv = build_ring_chunk_server(cfg, paged, chunked, dev,
                                      params=weights)
        weights = srv.params
        eng = srv.prefills[0]
        assert eng.chunked == chunked and eng.paged == (paged and chunked)
        n_full = sum(full_attn_layer(srv.lm.cfg, sp)
                     for sp in srv.lm.plan.all_specs())
        list(srv.generate([warm[0], warm[4]], SamplingParams(max_tokens=2)))
        reset_stats(srv)
        hl0 = hot_loops(srv)
        kerns = (flash_prefill, paged_decode, sink_decode, paged_prefill)
        for k in kerns:
            k.launches = 0
        st, finished, summ, wall = drive(srv, prompts, params)
        hl = check_hot_loops(srv, hl0, dev, entries=CHUNKED_ENTRIES
                             if chunked else ("decode.step",))
        ln = {k.__name__: k.launches for k in kerns}
        ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
        assert len(finished) == len(prompts) and all(
            r == "length" for r in finished), finished
        assert all(len(x) == 8 for x in st), st
        assert ds["host_fetches"] == ds["steps"] > 0, ds
        srv.decodes[0].pool.check_invariants(arena=srv.kv_arena)
        if dev.type == "cuda":          # the counts move only on the card
            dec, other = ("paged_decode", "sink_decode") if paged else \
                ("sink_decode", "paged_decode")
            assert ln[dec] == ds["steps"] * n_layers > 0, (ln, ds)
            assert ln[other] == 0, ln
            if chunked:
                assert ln["flash_prefill"] == 0, ln
                assert ln["paged_prefill"] == (ps["chunks"] * n_full
                                               if paged else 0), (ln, ps)
            else:
                assert ln["paged_prefill"] == 0, ln
                assert ln["flash_prefill"] == ps["prefills"] * n_layers \
                    > 0, (ln, ps)
        rec = {"launches": ln, "chunks": ps["chunks"],
               "whole_prefills": 0 if chunked else ps["prefills"],
               "cache_hits": ps["cache_hits"], "decode_steps": ds["steps"],
               "host_fetches": ds["host_fetches"],
               "prefill_host_s": ps["busy_s"],
               "host_s_per_round": ds["busy_s"] / ds["steps"],
               "hot_loops": hl,
               "metrics": {k: summ[k] for k in (
                   "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                   "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")}
               | {"wall_s": wall}}
        if chunked:
            rec["host_ms_per_chunk"] = ps["busy_s"] * 1e3 / ps["chunks"]
            task = eng._alloc_task_cache()
            rec["leaf_copy_ms"] = timer(lambda: (
                eng._swap(task, into_static=True),
                eng._swap(task, into_static=False)))
            rec["leaf_copy_bytes"] = 2 * sum(
                t.numel() * t.element_size() for e in task["layers"]
                if e is not None for t in e.values())
            del task
        log.append(f"({'abc'[len(out)]}) {name}: server built, warmed and "
                   f"served in {time.monotonic() - t0:.1f} s")
        out[name], streams[name] = rec, st
        if name == "paged":
            srv_a = srv
        del srv
        torch.cuda.empty_cache()
    # greedy streams (requests 0-5) equal across (a), (b) and (c), up to a
    # near-tie at the first differing step (phase 5's rule)
    ties = []
    for other in ("dense", "whole_prompt"):
        for r in range(6):
            a, b = streams["paged"][r], streams[other][r]
            if a == b:
                continue
            i = next(j for j in range(len(a)) if a[j] != b[j])
            margin = top2_margin(srv_a, prompts[r], a, i)
            log.append(f"request {r}: paged chunks and {other} differ at "
                       f"token {i}, top-2 logit margin {margin:.3g}")
            if margin >= 1e-4:
                raise AssertionError(
                    f"greedy stream {r}: chunked paged and {other} differ "
                    f"at token {i} (top-2 margin {margin:.3g})")
            ties.append({"request": r, "against": other, "token": i,
                         "margin": margin})
    del srv_a
    torch.cuda.empty_cache()
    return {"runs": out, "full_layers": n_full,
            "greedy_streams_identical": not ties, "near_ties": ties,
            "sampled_streams_equal": {o: streams["paged"][6] == streams[o][6]
                                      for o in ("dense", "whole_prompt")},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ---- phase 12: FaultPlane chaos, two prefill and two decode instances --
# fault seeds per traffic: (a) phase 3's prompts, (b) phase 7's with
# speculation, (c) (a) on int8 arenas
P12_SEEDS = {"a": (1, 2, 5), "b": (1, 2), "c": (1, 2)}
P12_NEW = 24
P12_KINDS = ("kill_prefill", "kill_decode", "kv_corrupt", "kv_lost")


def chaos_workload(vocab):
    """Phase 3's 14 requests (its 12 prompts and two sampled requests on the
    shared prefix) with P12_NEW new tokens each."""
    from repro_torch.core.proxy import SamplingParams
    prompts, base = workload(vocab)
    rng = np.random.default_rng(11)
    prompts += [base + tuple(int(t) for t in rng.integers(0, vocab, 64))
                for _ in range(2)]
    params = [SamplingParams(max_tokens=P12_NEW)] * 12 + [SamplingParams(
        temperature=0.9, top_k=64, top_p=0.95, seed=900 + i,
        max_tokens=P12_NEW) for i in (12, 13)]
    return prompts, params


def build_chaos_server(cfg, dev, params=None, **extra):
    """Phase 3's server with two prefill and two decode instances over one
    arena, the watchdog on and ten retries per request."""
    from repro_torch.core.proxy import OASConfig
    return build_server(cfg, True, dev, params=params, n_prefill=2,
                        n_decode=2, watchdog_steps=200,
                        oas=OASConfig(defer_window=0.0, max_retries=10),
                        **extra)


def chaos_run(srv, prompts, params, warm, dev, plane=None):
    """One measured run of phase 12 on a warmed server: the counts zeroed
    just before `drive` and read just after, `plane` attached after the
    warm-up (its steps count from there), each `recover_corruption` timed
    on the host with the device synchronised around it. Every assert of
    the phase that concerns one run is here."""
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    from repro_torch.kernels.spec_verify import spec_verify
    list(srv.generate(*warm))
    reset_stats(srv)
    srv.faults = plane
    recover, recover_s = srv.recover_corruption, []

    def timed(now=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = recover(now)
        torch.cuda.synchronize()
        recover_s.append(time.perf_counter() - t)
        return got
    srv.recover_corruption = timed
    hl0 = hot_loops(srv)
    kerns = (paged_prefill, paged_decode, spec_verify)
    for k in kerns:
        k.launches = 0
    step0 = srv._step_count
    streams, finished, summ, wall = drive(srv, prompts, params)
    launches = {k.__name__: k.launches for k in kerns}
    del srv.recover_corruption
    # the layers whose KV the arenas hold (every one of qwen2's, none of
    # mamba2's, whose runs launch no kernel)
    n_layers = sum(s_.kind == "attn" for s_ in srv.lm.plan.all_specs())
    spec = srv.scfg.spec is not None
    hl = check_hot_loops(srv, hl0, dev, entries=(
        "decode.verify" if spec else "decode.step", "prefill.chunk"))
    assert len(finished) == len(prompts) and all(
        r in ("stop", "length") for r in finished), finished
    done = {r.rid: list(r.output_tokens) for r in srv.metrics.done}
    outputs = [done[r] for r in sorted(done)]
    chunks = sum(e.stats["chunks"] for e in srv.prefills)
    steps = sum(e.stats["steps"] for e in srv.decodes)
    verifies = sum(e.stats.get("spec_verifies", 0) for e in srv.decodes)
    for e in srv.decodes:
        assert e.stats["host_fetches"] == e.stats["steps"], e.stats
    if dev.type == "cuda":
        assert launches["paged_prefill"] == chunks * n_layers and \
            chunks > 0, (launches, chunks)
        assert launches["paged_decode"] == (steps - verifies) * n_layers, \
            (launches, steps, verifies)
        assert launches["spec_verify"] == verifies * n_layers, \
            (launches, verifies)
    assert not spec or verifies > 0
    pool = srv.kv_arena.pool
    pool.check_invariants(arena=srv.kv_arena)
    assert len(pool.quarantined) == srv.metrics.blocks_quarantined
    left = [k for k in pool.per_request
            if not (isinstance(k, tuple) and k[0] == "store")]
    assert not left, f"pool keys left at quiescence: {left}"
    if plane is not None:
        assert sum(plane.injected.values()) > 0, "chaos injected nothing"
        for _, kind, target in plane.fired:
            if kind == "kv_corrupt":
                b, got = target
                assert got == (b,), f"corrupted block {b}, condemned {got}"
    return {"streams": streams, "outputs": outputs, "wall_s": wall,
            "server_steps": srv._step_count - step0, "chunks": chunks,
            "decode_steps": steps, "verify_steps": verifies,
            "launches": launches, "hot_loops": hl,
            "recover_s": recover_s,
            "retries": summ["n_retries"],
            "quarantined": summ["blocks_quarantined"],
            "handoffs_swept": srv.n_handoffs_swept,
            "injected": None if plane is None else dict(plane.injected),
            "skipped": None if plane is None else dict(plane.skipped),
            "fired": None if plane is None else [
                [st, k, t] for st, k, t in plane.fired],
            "metrics": {k: summ[k] for k in (
                "n_done", "ttft_mean", "tpot_mean_ms", "ott_tok_s")}}


def stream_diffs(srv, prompts, params, got, want) -> list:
    """Every request whose stream in `got` differs from `want`: its index,
    the first differing token, whether it samples, and (greedy) the top-2
    logit margin of `want`'s token there on `srv`'s model (phase 5's
    rule)."""
    out = []
    for r, (x, y) in enumerate(zip(got, want)):
        if x == y:
            continue
        i = next((j for j in range(min(len(x), len(y))) if x[j] != y[j]),
                 min(len(x), len(y)))
        sampled = params[r].temperature > 0
        margin = None if sampled or i >= len(y) else \
            top2_margin(srv, prompts[r], y, i)
        out.append({"request": r, "token": i, "sampled": sampled,
                    "margin": margin, "len": [len(x), len(y)]})
    return out


def serve_chaos(dev, log, cfg, timer, phase3_streams):
    """Phase 12 on `cfg` (full-width qwen2-1.5b, every layer full attention,
    in main()): FaultPlane chaos over two prefill and two decode instances
    sharing one arena. Each traffic first runs fault-free; its server-step
    count sets the horizon (about half of it), then each seed runs under
    FaultPlane(FaultConfig(seed, horizon)) on a new warmed server with the
    same weights. Every completed stream, greedy and sampled, must equal
    the fault-free run's. The summary scan's device time is taken on the
    float32 and int8 arenas."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving import FaultConfig, FaultPlane
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    vocab = cfg.vocab_size
    a_prompts, a_params = chaos_workload(vocab)
    a_warm = (workload(vocab, seed=8)[0], SamplingParams(max_tokens=4))
    b_prompts, b_params = spec_workload(vocab)
    b_warm = (spec_workload(vocab, seed=42)[0][:2],
              SamplingParams(max_tokens=8))
    traffic = {"a": (a_prompts, a_params, a_warm, {}),
               "b": (b_prompts, b_params, b_warm,
                     {"spec": SpecConfig(k=P7_K)}),
               "c": (a_prompts, a_params, a_warm,
                     {"quant": QuantConfig()})}
    out, weights, fired = {}, None, {k: 0 for k in P12_KINDS}
    for name, (prompts, params, warm, knobs) in traffic.items():
        t0 = time.monotonic()
        base = build_chaos_server(cfg, dev, params=weights, **knobs)
        weights = base.params
        ref = chaos_run(base, prompts, params, warm, dev)
        assert ref["streams"] == ref.pop("outputs")
        horizon = max(ref["server_steps"] // 2, 3)
        scan_ms = timer(base.kv_arena.corrupt_mask)
        assert not base.kv_arena.corrupt_mask().any()
        log.append(f"({name}) fault-free: {ref['server_steps']} server "
                   f"steps, {ref['chunks']} chunks, {ref['decode_steps']} "
                   f"decode steps; horizon {horizon}")
        if name == "a":
            # 2P/2D against phase 3's 1P/1D on the same prompts (4 tokens)
            assert [s[:4] for s in ref["streams"][:12]] == \
                phase3_streams[:12], "2P/2D greedy streams differ from " \
                "phase 3's 1P/1D streams"
            ref["sampled_equal_phase3"] = [s[:4] for s in
                                           ref["streams"][12:]] == \
                phase3_streams[12:14]
        runs = {}
        for seed in P12_SEEDS[name]:
            plane = FaultPlane(FaultConfig(seed=seed, horizon=horizon))
            srv = build_chaos_server(cfg, dev, params=weights, **knobs)
            run = chaos_run(srv, prompts, params, warm, dev, plane=plane)
            # streamed deltas against the outputs (nothing replayed or
            # lost), and both against the fault-free run
            diffs = {k: stream_diffs(base, prompts, params, run[k], w)
                     for k, w in (("streams", run["outputs"]),
                                  ("outputs", ref["streams"]))}
            if any(diffs.values()):
                log.append(f"({name}) seed {seed}: deltas vs outputs "
                           f"{diffs['streams']}; outputs vs the fault-free "
                           f"run {diffs['outputs']}; fired {plane.fired}")
                raise AssertionError(f"({name}) seed {seed}: streams differ "
                                     f"({diffs})")
            if name == "a":
                for k in P12_KINDS:
                    fired[k] += plane.injected[k]
            run["reprefilled_chunks"] = run["chunks"] - ref["chunks"]
            run.pop("streams")
            run.pop("outputs")
            runs[seed] = run
            log.append(
                f"({name}) seed {seed}: streams equal the fault-free run; "
                f"injected {run['injected']}, skipped "
                f"{ {k: v for k, v in run['skipped'].items() if v} }; "
                f"retries {run['retries']}, blocks quarantined "
                f"{run['quarantined']}, handoffs swept "
                f"{run['handoffs_swept']}, re-prefilled chunks "
                f"{run['reprefilled_chunks']}; wall {run['wall_s']:.3f} s "
                f"(fault-free {ref['wall_s']:.3f} s)")
            del srv
        ref.pop("streams")
        out[name] = {"fault_free": ref, "horizon": horizon,
                     "scan_ms": scan_ms, "runs": runs,
                     "seconds": time.monotonic() - t0}
        del base
        gc.collect()
        torch.cuda.empty_cache()
    assert all(fired.values()), f"(a) fired none of some kinds: {fired}"
    out["a_fired"] = fired
    return out


# ---- phase 4: reduced width, card against CPU ------------------------
def cross_check_reduced(dev, log):
    from repro_torch.configs import reduced_config
    from repro_torch.core.proxy import OASConfig, SamplingParams
    from repro_torch.models.lm import LM
    from repro_torch.models.stack import alloc_arena_kv
    from repro_torch.serving import DevicePlacement, Server, ServerConfig
    cfg = reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2,
        d_model=384, d_ff=768, n_heads=4, n_kv_heads=2, head_dim=64,
        vocab_size=2048)
    cpu_lm = LM.build(cfg, pattern=[0, 0], device="cpu")
    params = cpu_lm.init(seed=5)
    gpu_params = DevicePlacement.of(dev).place_params(params)
    # logits through both paths on one chunk + one decode step
    gpu_lm = LM.build(cfg, pattern=[0, 0], device=dev)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    row = np.arange(1, 9, dtype=np.int32)[None]
    worst = 0.0
    res = []
    for lm, p, d in ((cpu_lm, params, "cpu"), (gpu_lm, gpu_params, dev)):
        arena = alloc_arena_kv(cfg, lm.plan, 12, 16, d)
        cache = {"layers": arena, "pos": 0}
        tb = torch.from_numpy(row).to(d)
        cache, l1, _ = lm.prefill_resume(p, torch.from_numpy(toks).to(d),
                                         cache, chunk_len=37,
                                         block_tables=tb)
        seven = torch.tensor([[7]], dtype=torch.int32, device=d)
        _, l2, _ = lm.decode(p, cache, seven,
                             torch.tensor([[37]], dtype=torch.int32,
                                          device=d), block_tables=tb)
        res.append((l1.float().cpu(), l2.float().cpu()))
    for a, b in zip(res[0], res[1]):
        worst = max(worst, float((a - b).abs().max()))
        torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-3)
    scfg = ServerConfig(decode_slots=3, max_len=128, chunk_tokens=32,
                        prefill_tick_budget=64, kv_blocks=40,
                        kv_block_size=8, oas=OASConfig(defer_window=0.0))
    prompts, _ = workload(cfg.vocab_size, n=6, seed=9)
    prompts = [p[-60:] for p in prompts]
    out = []
    for d, p in (("cpu", params), (dev, gpu_params)):
        srv = Server(cfg, scfg, pattern=[0, 0], params=p, device=d)
        s = srv.run([(q, SamplingParams(max_tokens=5)) for q in prompts])
        assert s["n_done"] == len(prompts)
        out.append({r.rid: tuple(r.output_tokens) for r in srv.metrics.done})
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
        hl = check_hot_loops(srv, {}, torch.device(d))
    assert out[0] == out[1], "card and CPU greedy streams differ"
    log.append(f"reduced width: card vs CPU logits max_abs_err={worst:.3g}, "
               f"greedy streams identical ({len(prompts)} requests); on the "
               f"card {hot_loop_line(hl)}")

    # the default OmniAttn pattern (3 compressed layers of 4, sink 8 +
    # recent 24, so the 60-token prompts wrap the rings): whole-prompt
    # prefill + dense decode logits, then both KV layouts served
    rcfg = cfg.with_updates(n_layers=4, omniattn_sink_tokens=8,
                            omniattn_recent_tokens=24)
    cpu_lm = LM.build(rcfg, pattern=None, device="cpu")
    gpu_lm = LM.build(rcfg, pattern=None, device=dev)
    p4 = cpu_lm.init(seed=6)
    g4 = DevicePlacement.of(dev).place_params(p4)
    worst4, res = 0.0, []
    for lm, p, d in ((cpu_lm, p4, "cpu"), (gpu_lm, g4, dev)):
        cache, l1, _ = lm.prefill(p, torch.from_numpy(
            np.pad(toks, ((0, 0), (0, 24)))).to(d), max_len=128, true_len=40)
        seven = torch.tensor([[7]], dtype=torch.int32, device=d)
        _, l2, _ = lm.decode(p, cache, seven,
                             torch.tensor([[40]], dtype=torch.int32,
                                          device=d))
        res.append((l1.float().cpu(), l2.float().cpu()))
    for a, b in zip(res[0], res[1]):
        worst4 = max(worst4, float((a - b).abs().max()))
        torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-3)
    layouts = {}
    for paged in (True, False):
        scfg4 = ServerConfig(decode_slots=3, max_len=128, kv_block_size=8,
                             paged_kv=paged, oas=OASConfig(defer_window=0.0))
        got = []
        for d, p in (("cpu", p4), (dev, g4)):
            srv = Server(rcfg, scfg4, pattern=None, params=p, device=d)
            s = srv.run([(q, SamplingParams(max_tokens=5)) for q in prompts])
            assert s["n_done"] == len(prompts)
            assert not srv.prefills[0].chunked
            srv.decodes[0].pool.check_invariants(arena=srv.kv_arena)
            got.append({r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done})
        assert got[0] == got[1], \
            f"pattern=None paged_kv={paged}: card and CPU streams differ"
        layouts["paged" if paged else "dense"] = got[1]
    assert layouts["paged"] == layouts["dense"], \
        "pattern=None: paged and dense layouts differ on the card"
    log.append(f"reduced width, pattern=None: card vs CPU logits "
               f"max_abs_err={worst4:.3g}, greedy streams identical in both "
               f"KV layouts")

    # chunked prefill over ring layers and dense KV: the mixed stack of
    # tests/test_paged_prefill.py (window 16, compressed under
    # prefill_sparse, full; sink 8 + recent 24), chunks of 16, on the card
    # (each chunk a "prefill.chunk" replay) against the CPU
    mcfg = rcfg.with_updates(local_per_global=1, local_window=16,
                             prefill_sparse=True)
    mixed = {}
    for paged in (True, False):
        scfg4 = ServerConfig(decode_slots=3, max_len=128, kv_block_size=8,
                             paged_kv=paged, oas=OASConfig(defer_window=0.0))
        got = []
        for d, p in (("cpu", p4), (dev, g4)):
            srv = Server(mcfg, scfg4, pattern=[0, 0, 0, 1], params=p,
                         device=d)
            s = srv.run([(q, SamplingParams(max_tokens=5)) for q in prompts])
            assert s["n_done"] == len(prompts)
            assert srv.prefills[0].chunked and \
                srv.prefills[0].paged == paged
            srv.decodes[0].pool.check_invariants(arena=srv.kv_arena)
            got.append({r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done})
            hl = check_hot_loops(srv, {}, torch.device(d),
                                 entries=CHUNKED_ENTRIES)
        assert got[0] == got[1], \
            f"mixed stack chunked, paged_kv={paged}: card and CPU differ"
        mixed["paged" if paged else "dense"] = got[1]
        log.append(f"reduced mixed stack, chunked, paged_kv={paged}: greedy "
                   f"streams identical card vs CPU; on the card "
                   f"{hot_loop_line(hl)}")
    assert mixed["paged"] == mixed["dense"], \
        "mixed stack chunked: paged and dense layouts differ on the card"
    sampled = cross_check_sampled(dev, log, prompts, (cfg, params, gpu_params),
                                  (rcfg, p4, g4))
    return {"logits_max_abs_err": worst, "streams_identical": True,
            "sampled": sampled,
            "default_pattern_logits_max_abs_err": worst4,
            "default_pattern_streams_identical": True,
            "mixed_chunked_streams_identical": True,
            **cross_check_sparse_spec(dev, log, cfg),
            "quant": cross_check_quant(dev, log, cfg),
            "archs": cross_check_archs(dev, log)}


def sampled_params(n, max_tokens=6):
    """Seeded sampled requests over temperatures 0.8-1.5 with top-k and
    top-p on and off; every fourth request greedy."""
    from repro_torch.core.proxy import SamplingParams
    return [SamplingParams(max_tokens=max_tokens) if i % 4 == 3 else
            SamplingParams(temperature=(0.8, 1.0, 1.5)[i % 3],
                           top_k=(64, 0, 20)[i % 3],
                           top_p=(0.95, 0.9, 1.0)[i % 3], seed=900 + 7 * i,
                           max_tokens=max_tokens) for i in range(n)]


def cross_check_sampled(dev, log, prompts, full, default) -> dict:
    """Phase 4, continued: the draw on the card against the CPU. The
    threefry bits of `fold_in` + `random_bits32` at qwen2's vocabulary
    (151,936) and their uniforms, bit for bit; then seeded sampled requests
    (`sampled_params`) on the reduced servers, card against CPU: the
    all-full stack chunked over paged KV (`full` = (cfg, CPU weights, card
    weights)) and the default pattern whole-prompt in both KV layouts
    (`default`). Streams equal up to phase 5's near-tie rule: a stream may
    differ only where the CPU model's top-2 margin of what the draw
    maximised is under 1e-4 at the first differing token."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.core.proxy.params import seed_key
    from repro_torch.serving import Server, ServerConfig
    from repro_torch.serving import prng
    V = 151936
    keys = torch.from_numpy(np.stack([seed_key(s) for s in (
        0, 5, 905, 1 << 40, -7, 123456789)]).astype(np.int64))
    fold = torch.tensor([0, 1, 17, 4400, 151935, 2 ** 31 - 1],
                        dtype=torch.int32)
    want = prng.random_bits32(prng.fold_in(keys, fold), V)
    got = prng.random_bits32(prng.fold_in(keys.to(dev), fold.to(dev)), V)
    assert torch.equal(got.cpu(), want), "threefry bits differ card vs CPU"
    assert torch.equal(prng.uniform(got).cpu(), prng.uniform(want))
    g_card = prng.gumbel(prng.fold_in(keys.to(dev), fold.to(dev)), V).cpu()
    g_cpu = prng.gumbel(prng.fold_in(keys, fold), V)
    gumbel_diff = float((g_card - g_cpu).abs().max())
    log.append(f"the draw's threefry bits and uniforms over 6 x {V}: card "
               f"equal to CPU bit for bit; Gumbel noise max |card - CPU| "
               f"{gumbel_diff:.3g}")
    params = sampled_params(len(prompts))
    out = {"bits_equal": True, "gumbel_max_abs_diff": gumbel_diff}
    runs = (("all_full_chunked_paged", full, [0] * full[0].n_layers,
             dict(chunk_tokens=32, prefill_tick_budget=64, kv_blocks=40)),
            ("default_whole_paged", default, None, dict(paged_kv=True)),
            ("default_whole_dense", default, None, dict(paged_kv=False)))
    for name, (c, p_cpu, p_card), pattern, knobs in runs:
        scfg = ServerConfig(decode_slots=3, max_len=128, kv_block_size=8,
                            oas=OASConfig(defer_window=0.0), **knobs)
        got, servers = [], []
        for d, p in (("cpu", p_cpu), (dev, p_card)):
            srv = Server(c, scfg, pattern=pattern, params=p, device=d)
            s = srv.run(list(zip(prompts, params)))
            assert s["n_done"] == len(prompts)
            got.append([tuple(r.output_tokens) for r in
                        sorted(srv.metrics.done, key=lambda r: r.rid)])
            servers.append(srv)
        assert servers[1].prefills[0].chunked == (pattern is not None)
        ties = []
        for r, (a, b) in enumerate(zip(*got)):
            if a == b:
                continue
            i = next(j for j in range(len(a)) if a[j] != b[j])
            margin = top2_margin(servers[0], prompts[r], a, i, params[r])
            log.append(f"sampled {name}: request {r} differs card vs CPU at "
                       f"token {i}, top-2 margin {margin:.3g}")
            if margin >= 1e-4:
                raise AssertionError(f"sampled {name}: stream {r} differs "
                                     f"card vs CPU (top-2 margin "
                                     f"{margin:.3g})")
            ties.append({"request": r, "token": i, "margin": margin})
        hl = check_hot_loops(servers[1], {}, torch.device(dev))
        out[name] = {"streams_equal": not ties, "near_ties": ties}
        log.append(f"sampled {name}: {sum(sp.temperature > 0 for sp in params)}"
                   f" sampled + {sum(sp.temperature <= 0 for sp in params)} "
                   f"greedy streams card vs CPU equal: {not ties} (near-ties "
                   f"{ties}); on the card {hot_loop_line(hl)}")
    return out


def cross_check_archs(dev, log, archs=("qwen3-32b", "granite-34b",
                                        "gemma3-4b", "qwen3-moe-235b-a22b",
                                        "mamba2-130m",
                                        "jamba-1.5-large-398b")):
    """Phase 4, continued: the reduced configs of phase 13's four decoders
    (the reference's `reduced_config`: qwen3's qk_norm, granite's single kv
    head, gemma3's 12 layers with 32-token windows, qwen3-moe's norm_topk
    experts) and of phase 14's SSM stacks (mamba2's 2 Mamba-2 layers,
    jamba's 16 hybrid layers) served chunked on the card and on the CPU from
    the same weights: greedy streams identical; qwen3-moe also with
    speculation and with online top-k (the two compositions with MoE
    layers; speculation refuses SSM layers)."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.proxy import OASConfig, SamplingParams
    from repro_torch.models.lm import LM
    from repro_torch.serving import DevicePlacement, Server, ServerConfig
    from repro_torch.serving.spec import SpecConfig
    out = {}
    for arch in archs:
        cfg = reduced_config(arch).with_updates(compute_dtype="float32",
                                                param_dtype="float32")
        pattern = [0] * cfg.n_layers
        p = LM.build(cfg, pattern=pattern, device="cpu").init(seed=9)
        g = DevicePlacement.of(dev).place_params(p)
        prompts, _ = workload(cfg.vocab_size, n=6, seed=10)
        prompts = [q[-60:] for q in prompts]
        cases = [("plain", cfg, None)]
        if cfg.moe.n_experts and cfg.family == "moe":
            cases += [("spec", cfg, SpecConfig(k=2)),
                      ("topk", cfg.with_updates(omniattn_topk_frac=0.5),
                       None)]
        for name, c, spec in cases:
            scfg = ServerConfig(decode_slots=3, max_len=128, chunk_tokens=16,
                                prefill_tick_budget=32, kv_blocks=60,
                                kv_block_size=8, spec=spec,
                                oas=OASConfig(defer_window=0.0))
            got = []
            for d, w in (("cpu", p), (dev, g)):
                srv = Server(c, scfg, pattern=pattern, params=w, device=d)
                s = srv.run([(q, SamplingParams(max_tokens=6))
                             for q in prompts])
                assert s["n_done"] == len(prompts) and \
                    srv.prefills[0].chunked
                srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
                got.append({r.rid: tuple(r.output_tokens)
                            for r in srv.metrics.done})
                hl = check_hot_loops(
                    srv, {}, torch.device(d), entries=CHUNKED_ENTRIES
                    if spec is None else ("prefill.chunk",))
                if spec is not None:
                    assert srv.decodes[0].stats["spec_verifies"] > 0
            assert got[0] == got[1], \
                f"{arch} {name}: card and CPU greedy streams differ"
            out[f"{arch}_{name}"] = True
            log.append(f"reduced {arch} ({name}): greedy streams identical "
                       f"card vs CPU; on the card {hot_loop_line(hl)}")
    return out


def cross_check_sparse_spec(dev, log, cfg):
    """Phase 4, continued, on the reduced config `cfg` of phase 4: online
    top-k (block_topk + selection) logits through LM.decode, then a
    full/window stack (window 16, whole-prompt prefill) served with top-k
    below the resident count and with speculation (k=4: spec_verify on the
    full layers, ring verify + masked ring commit on the window layers) —
    card against CPU."""
    from repro_torch.core.proxy import OASConfig, SamplingParams
    from repro_torch.models.lm import LM
    from repro_torch.models.stack import alloc_arena_kv
    from repro_torch.serving import DevicePlacement, Server, ServerConfig
    from repro_torch.serving.spec import SpecConfig
    tcfg = cfg.with_updates(omniattn_topk_blocks=3,
                            omniattn_topk_measure_mass=True)
    cpu_lm = LM.build(tcfg, pattern=[0, 0], device="cpu")
    gpu_lm = LM.build(tcfg, pattern=[0, 0], device=dev)
    params = cpu_lm.init(seed=7)
    gparams = DevicePlacement.of(dev).place_params(params)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    row = np.arange(1, 13, dtype=np.int32)[None]     # 12 entries of bs 8
    res, worst = [], 0.0
    for lm, p, d in ((cpu_lm, params, "cpu"), (gpu_lm, gparams, dev)):
        cache = {"layers": alloc_arena_kv(tcfg, lm.plan, 16, 8, d), "pos": 0}
        tb = torch.from_numpy(row).to(d)
        cache, _, _ = lm.prefill_resume(p, torch.from_numpy(toks).to(d),
                                        cache, chunk_len=37,
                                        block_tables=tb)
        _, lg, aux = lm.decode(p, cache, torch.tensor([[7]], dtype=torch.int32,
                                                      device=d),
                               torch.tensor([[37]], dtype=torch.int32,
                                            device=d), block_tables=tb)
        res.append((lg.float().cpu(), torch.stack(aux["sparsity"]).cpu()))
    worst = float((res[0][0] - res[1][0]).abs().max())
    torch.testing.assert_close(res[1][0], res[0][0], rtol=2e-3, atol=2e-3)
    assert torch.equal(res[1][1][:, :2], res[0][1][:, :2]), res
    assert (res[0][1][:, 1] < res[0][1][:, 0]).all(), res   # 3 of 5 kept
    torch.testing.assert_close(res[1][1], res[0][1], rtol=1e-4, atol=1e-5)

    mcfg = cfg.with_updates(n_layers=4, local_per_global=1, local_window=16)
    pattern = [0] * 4
    p4 = LM.build(mcfg, pattern=pattern, device="cpu").init(seed=8)
    g4 = DevicePlacement.of(dev).place_params(p4)
    prompts, _ = workload(cfg.vocab_size, n=6, seed=10)
    prompts = [q[-60:] for q in prompts]
    base = dict(decode_slots=3, max_len=128, chunked_prefill=False,
                kv_blocks=60, kv_block_size=8,
                oas=OASConfig(defer_window=0.0))
    out = {}
    for name, c, extra in (
            ("topk", mcfg.with_updates(omniattn_topk_blocks=3,
                                       omniattn_topk_measure_mass=True), {}),
            ("spec", mcfg, dict(spec=SpecConfig(k=4))),
            ("spec_off", mcfg, {})):
        got = []
        for d, p in (("cpu", p4), (dev, g4)):
            srv = Server(c, ServerConfig(**base, **extra), pattern=pattern,
                         params=p, device=d)
            summ = srv.run([(q, SamplingParams(max_tokens=12))
                            for q in prompts])
            assert summ["n_done"] == len(prompts)
            ds = summ["decode_stats"][0]
            assert ds["host_fetches"] == ds["steps"] > 0, ds
            srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
            got.append(({r.rid: tuple(r.output_tokens)
                         for r in srv.metrics.done}, summ))
        (cs, csum), (gs, gsum) = got
        assert cs == gs, f"{name}: card and CPU streams differ"
        out[name] = (gs, gsum)
        if name == "topk":
            for k in ("blocks_scored", "blocks_attended"):
                assert gsum[k] == csum[k] > 0, (k, gsum[k], csum[k])
            assert gsum["blocks_attended"] < gsum["blocks_scored"]
            assert abs(gsum["attn_mass_kept"] - csum["attn_mass_kept"]) \
                < 1e-4, (gsum["attn_mass_kept"], csum["attn_mass_kept"])
        if name == "spec":
            for k in ("spec_drafted", "spec_accepted", "spec_verifies"):
                assert gsum[k] == csum[k], (k, gsum[k], csum[k])
            assert gsum["spec_verifies"] > 0
    assert out["spec"][0] == out["spec_off"][0], \
        "speculation changed the streams on the card"
    t, sp = out["topk"][1], out["spec"][1]
    log.append(f"reduced width, online top-k (3-block budget): card vs CPU "
               f"logits max_abs_err={worst:.3g}, aux equal; full/window "
               f"stack served: streams identical, blocks "
               f"{t['blocks_attended']}/{t['blocks_scored']}, mass kept "
               f"{t['attn_mass_kept']:.4f} on both")
    log.append(f"reduced width, speculation k=4 on the full/window stack: "
               f"streams identical on card and CPU and to spec off, "
               f"{sp['spec_accepted']}/{sp['spec_drafted']} drafts accepted "
               f"over {sp['spec_verifies']} verifies on both")
    return {"topk_logits_max_abs_err": worst,
            "topk_blocks": [t["blocks_attended"], t["blocks_scored"]],
            "topk_mass_kept": t["attn_mass_kept"],
            "spec": {k: sp[k] for k in ("spec_drafted", "spec_accepted",
                                        "spec_verifies")}}


def cross_check_quant(dev, log, cfg):
    """Phase 4, continued: QuantPlane on the reduced config `cfg` of phase
    4, card against CPU. Logits of a chunk and a decode step over int8
    arenas within 2e-3; then phase 4's server and traffic (12 new tokens, so
    every stream seals a block on the append path) with quant=QuantConfig()
    — alone, with SpecConfig(k=4), and with online top-k (3-block budget,
    mass measured) over the same int8 arenas: greedy streams identical
    across the devices and to quant alone, and the pool, summary and scale
    invariants green on both. The int8 bytes themselves are not compared
    across devices: one rounding difference in a GEMM can move a value
    across a rounding boundary."""
    from repro_torch.core.proxy import OASConfig, SamplingParams
    from repro_torch.models.lm import LM
    from repro_torch.models.stack import alloc_arena_kv
    from repro_torch.serving import DevicePlacement, Server, ServerConfig
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    cpu_lm = LM.build(cfg, pattern=[0, 0], device="cpu")
    gpu_lm = LM.build(cfg, pattern=[0, 0], device=dev)
    params = cpu_lm.init(seed=9)
    gparams = DevicePlacement.of(dev).place_params(params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    row = np.arange(1, 9, dtype=np.int32)[None]
    res = []
    for lm, p, d in ((cpu_lm, params, "cpu"), (gpu_lm, gparams, dev)):
        cache = {"layers": alloc_arena_kv(cfg, lm.plan, 12, 16, d,
                                          quant=True), "pos": 0}
        tb = torch.from_numpy(row).to(d)
        cache, l1, _ = lm.prefill_resume(p, torch.from_numpy(toks).to(d),
                                         cache, chunk_len=37,
                                         block_tables=tb)
        _, l2, _ = lm.decode(p, cache, torch.tensor([[7]], dtype=torch.int32,
                                                    device=d),
                             torch.tensor([[37]], dtype=torch.int32,
                                          device=d), block_tables=tb)
        res.append((l1.float().cpu(), l2.float().cpu()))
    worst = max(float((a - b).abs().max()) for a, b in zip(*res))
    for a, b in zip(res[0], res[1]):
        torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-3)
    prompts, _ = workload(cfg.vocab_size, n=6, seed=9)
    prompts = [q[-60:] for q in prompts]
    base = dict(decode_slots=3, max_len=128, chunk_tokens=32,
                prefill_tick_budget=64, kv_blocks=40, kv_block_size=8,
                oas=OASConfig(defer_window=0.0), quant=QuantConfig())
    topk = cfg.with_updates(omniattn_topk_blocks=3,
                            omniattn_topk_measure_mass=True)
    out = {}
    for name, c, extra in (("quant", cfg, {}),
                           ("quant_spec", cfg, dict(spec=SpecConfig(k=4))),
                           ("quant_topk", topk, {})):
        got = []
        for d, p in (("cpu", params), (dev, gparams)):
            srv = Server(c, ServerConfig(**base, **extra), pattern=[0, 0],
                         params=p, device=d)
            summ = srv.run([(q, SamplingParams(max_tokens=12))
                            for q in prompts])
            assert summ["n_done"] == len(prompts) and srv.kv_arena.quant
            ds = summ["decode_stats"][0]
            assert ds["host_fetches"] == ds["steps"] > 0, ds
            srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
            got.append(({r.rid: tuple(r.output_tokens)
                         for r in srv.metrics.done}, summ))
        (cs, csum), (gs, gsum) = got
        assert cs == gs, f"{name}: card and CPU streams differ"
        out[name] = (gs, gsum)
        if name == "quant_spec":
            for k in ("spec_drafted", "spec_accepted", "spec_verifies"):
                assert gsum[k] == csum[k], (k, gsum[k], csum[k])
            assert gsum["spec_verifies"] > 0
        if name == "quant_topk":
            for k in ("blocks_scored", "blocks_attended"):
                assert gsum[k] == csum[k] > 0, (k, gsum[k], csum[k])
            assert gsum["blocks_attended"] < gsum["blocks_scored"]
            assert abs(gsum["attn_mass_kept"] - csum["attn_mass_kept"]) \
                < 1e-4, (gsum["attn_mass_kept"], csum["attn_mass_kept"])
    assert out["quant_spec"][0] == out["quant"][0], \
        "speculation over int8 arenas changed the streams"
    sp, t = out["quant_spec"][1], out["quant_topk"][1]
    log.append(f"reduced width, int8 arenas: card vs CPU logits "
               f"max_abs_err={worst:.3g}; served alone, with speculation "
               f"k=4 ({sp['spec_accepted']}/{sp['spec_drafted']} drafts "
               f"accepted) and with online top-k (blocks "
               f"{t['blocks_attended']}/{t['blocks_scored']}, mass kept "
               f"{t['attn_mass_kept']:.4f}): streams identical on card and "
               f"CPU, summary and scale invariants hold on both")
    return {"logits_max_abs_err": worst,
            "spec": {k: sp[k] for k in ("spec_drafted", "spec_accepted",
                                        "spec_verifies")},
            "topk_blocks": [t["blocks_attended"], t["blocks_scored"]]}


# ---- phase 6: online top-k at full width ------------------------------
def topk_workload(vocab, seed=31):
    """Six distinct seeded 3,968-token prompts, 12 greedy tokens each."""
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(seed)
    prompts = [tuple(int(t) for t in rng.integers(0, vocab, P6_PROMPT))
               for _ in range(6)]
    return prompts, [SamplingParams(max_tokens=P6_NEW)] * 6


def build_topk_server(cfg, dev, params=None, placement=None, **topk):
    """Phase 3's knobs at max_len 4608 with a 2016-block pool; `topk` sets
    cfg.omniattn's budget (omniattn_topk_frac=..., ...); `placement` as
    in `build_server`."""
    return long_server(cfg.with_updates(**topk), dev, params,
                       placement=placement)


def long_server(cfg, dev, params, placement=None, **knobs):
    """topk-long's server (phase 3's knobs at max_len 4,608 with a
    2,016-block pool) with further ServerConfig knobs."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    scfg = ServerConfig(**(dict(
        decode_slots=6, max_len=P6_MAX_LEN, chunk_tokens=128,
        prefill_tick_budget=512, kv_blocks=P6_BLOCKS, kv_block_size=16,
        prefix_reuse=True, oas=OASConfig(defer_window=0.0)) | knobs))
    return Server(cfg, scfg, pattern=[0] * cfg.n_layers, params=params,
                  seed=0, device=dev, placement=placement)


def serve_topk(dev, log, cfg, weights=None):
    """Phase 6 on `cfg` (full-width qwen2-1.5b in main(); phase 13 passes
    qwen3-moe with its `weights`): four servers on the same weights,
    the counts zeroed just before each run and read just after."""
    from repro_torch.kernels.block_topk import block_topk_scores
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    from repro_torch.core.proxy import SamplingParams
    n_layers = cfg.n_layers
    prompts, params = topk_workload(cfg.vocab_size)
    # the decode table's width: the pow2 bucket (floor 8) of the resident
    # blocks, 249 throughout decode → 256
    width = 1 << (-(-(P6_PROMPT + P6_NEW) // 16) - 1).bit_length()
    frac = dict(omniattn_topk_frac=0.25, omniattn_topk_sink_blocks=1,
                omniattn_topk_recent_blocks=2)
    runs = (("a_off", {}, True), ("b_frac", frac, True),
            ("c_mass", dict(frac, omniattn_topk_measure_mass=True), False),
            ("d_width_minus_1", dict(omniattn_topk_blocks=width - 1), False))
    out, streams_of = {}, {}
    for name, topk, timed in runs:
        t0 = time.monotonic()
        srv = build_topk_server(cfg, dev, params=weights, **topk)
        weights = srv.params
        if timed:
            # warm-up outside the counts and the metrics: the chunk and
            # decode shapes the measured run meets
            warm = topk_workload(cfg.vocab_size, seed=32)[0][0][:200]
            list(srv.generate([warm], SamplingParams(max_tokens=3)))
            reset_stats(srv)
        hl0 = hot_loops(srv)
        for kern in (block_topk_scores, paged_decode, paged_prefill):
            kern.launches = 0
        streams, finished, summ, wall = drive(srv, prompts, params)
        hl = check_hot_loops(srv, hl0, dev)
        launches = {"block_topk": block_topk_scores.launches,
                    "paged_decode": paged_decode.launches,
                    "paged_prefill": paged_prefill.launches}
        ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
        assert len(finished) == 6 and all(r == "length" for r in finished)
        assert all(len(x) == P6_NEW for x in streams), streams
        assert ds["host_fetches"] == ds["steps"] > 0, ds
        steps = ds["steps"]
        if dev.type == "cuda":
            assert launches["paged_decode"] == steps * n_layers, launches
            assert launches["paged_prefill"] == ps["chunks"] * n_layers > 0
            want = 0 if name == "a_off" else steps * n_layers
            assert launches["block_topk"] == want, (name, launches, steps)
        if name != "a_off":
            ratio = summ["blocks_attended"] / summ["blocks_scored"]
            if name == "d_width_minus_1":
                assert summ["blocks_attended"] == summ["blocks_scored"] > 0
            else:
                # ceil(0.25 · n_res) of n_res >= 249 blocks per slot-step
                min_res = -(-(P6_PROMPT + 1) // 16)
                assert 0.25 <= ratio <= 0.25 + 1 / min_res, ratio
            if name == "c_mass":
                assert 0 < summ["attn_mass_kept"] <= 1 + 1e-6, summ
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
        streams_of[name] = streams
        out[name] = {"launches": launches, "decode_steps": steps,
                     "prefill_chunks": ps["chunks"],
                     "host_fetches": ds["host_fetches"],
                     "host_s_per_round": ds["busy_s"] / steps,
                     "hot_loops": hl,
                     "blocks_scored": summ.get("blocks_scored"),
                     "blocks_attended": summ.get("blocks_attended"),
                     "attn_mass_kept": summ.get("attn_mass_kept"),
                     "metrics": {k: summ[k] for k in (
                         "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                         "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")}
                     | {"wall_s": wall}}
        log.append(f"{name}: served in {time.monotonic() - t0:.1f} s "
                   f"(server built, warm-up, run, invariants)")
        del srv
        torch.cuda.empty_cache()
    assert streams_of["d_width_minus_1"] == streams_of["a_off"], \
        "a budget keeping every block changed the greedy streams"
    agree = sum(a == b for a, b in zip(streams_of["b_frac"],
                                       streams_of["a_off"]))
    return {"runs": out, "table_width": width,
            "streams_equal_full_budget": True,
            "frac_streams_equal_off": agree,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ---- phase 7: SpecPlane at full width --------------------------------
def spec_workload(vocab, seed=41, repeats=1):
    """Six greedy prompts, each a distinct seeded 32-token phrase repeated
    8 times (256 tokens), 48 new tokens; one seeded sampled request
    (temperature 0.8, a 64-token prompt, 16 tokens), the seventh for six
    slots. With `repeats` the six greedy requests come that many times
    before the sampled one: a later copy drafts from the suffix table its
    finished twin fed (phase 13's models do not repeat their own output,
    so prompt lookup alone drafts only at a request's first step)."""
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(seed)
    prompts = [tuple(int(t) for t in rng.integers(0, vocab, P7_PHRASE))
               * P7_REPEAT for _ in range(6)] * repeats
    prompts.append(tuple(int(t) for t in rng.integers(0, vocab, 64)))
    params = [SamplingParams(max_tokens=P7_NEW)] * (6 * repeats) + [
        SamplingParams(temperature=0.8, seed=907, max_tokens=16)]
    return prompts, params


def serve_spec(dev, log, cfg, weights=None, repeats=1, require_equal=True):
    """Phase 7 on `cfg` (full-width qwen2-1.5b in main(); phase 13 passes
    its decoders with their `weights`): phase 3's server with and
    without SpecConfig(k=4), on the same weights. MoE layers also route
    the verify window (moe_gmm's launches are counted). With
    `require_equal` False the streams that differ are reported, not
    refused."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.spec_verify import spec_verify
    from repro_torch.serving.spec import SpecConfig
    n_layers = cfg.n_layers
    prompts, params = spec_workload(cfg.vocab_size, repeats=repeats)
    n_greedy = 6 * repeats
    warm, _ = spec_workload(cfg.vocab_size, seed=42)
    from repro_torch.kernels.moe_gmm import moe_gmm
    out, streams_of, servers = {}, {}, {}
    for name, spec in (("spec_off", None), ("spec_on", SpecConfig(k=P7_K))):
        srv = build_server(cfg, True, dev, params=weights, spec=spec)
        weights = srv.params
        list(srv.generate(warm[:2], SamplingParams(max_tokens=8)))
        reset_stats(srv)
        hl0 = hot_loops(srv)
        spec_verify.launches = paged_decode.launches = moe_gmm.launches = 0
        streams, finished, summ, wall = drive(srv, prompts, params)
        launches = {"spec_verify": spec_verify.launches,
                    "paged_decode": paged_decode.launches,
                    "moe_gmm": moe_gmm.launches}
        hl = check_hot_loops(srv, hl0, dev, entries=(
            "decode.verify",) if spec is not None else ("decode.step",))
        ds = srv.decodes[0].stats
        assert len(finished) == n_greedy + 1 and all(
            r == "length" for r in finished)
        assert [len(x) for x in streams] == [P7_NEW] * n_greedy + [16], \
            streams
        assert ds["host_fetches"] == ds["steps"] > 0, ds
        verifies = ds.get("spec_verifies", 0)
        if dev.type == "cuda":
            assert launches["spec_verify"] == verifies * n_layers, \
                (launches, ds)
            assert launches["paged_decode"] == \
                (ds["steps"] - verifies) * n_layers, (launches, ds)
        if spec is not None:
            assert verifies > 0 and summ["spec_verifies"] == verifies
        n_moe = sum(sp.use_moe for sp in srv.lm.plan.all_specs())
        if dev.type == "cuda" and n_moe:
            # three expert products per MoE layer in every chunk, decode
            # step and verify step
            chunks = srv.prefills[0].stats["chunks"]
            assert launches["moe_gmm"] == 3 * n_moe * (chunks + ds["steps"]),\
                (launches, chunks, ds)
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
        streams_of[name] = streams
        servers[name] = srv
        out[name] = {"launches": launches, "decode_steps": ds["steps"],
                     "host_fetches": ds["host_fetches"],
                     "host_s_per_round": ds["busy_s"] / ds["steps"],
                     "hot_loops": hl, "streams": streams,
                     "spec": {k: summ[k] for k in (
                         "spec_drafted", "spec_accepted", "spec_verifies",
                         "draft_acceptance", "tokens_per_verify")},
                     "metrics": {k: summ[k] for k in (
                         "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                         "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")}
                     | {"wall_s": wall}}
    # every stream identical across the two runs, up to a near-tie at the
    # first differing greedy step (the verify forward runs its GEMMs over
    # 30 rows, the single-token step over 6)
    ties, differ = [], []
    for r, (a, b) in enumerate(zip(streams_of["spec_on"],
                                   streams_of["spec_off"])):
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        margin = top2_margin(servers["spec_off"], prompts[r], b, i) \
            if r < n_greedy else 0.0
        log.append(f"{cfg.arch_id}: request {r}: spec on/off differ at "
                   f"token {i}, top-2 logit margin {margin:.3g}")
        if r == n_greedy or margin >= 1e-4:
            if require_equal:
                raise AssertionError(f"stream {r} differs with speculation "
                                     f"on and off at token {i}")
            differ.append({"request": r, "token": i, "margin": margin})
            continue
        ties.append({"request": r, "token": i, "margin": margin})
    del servers
    torch.cuda.empty_cache()
    return {"runs": out, "streams_identical": not ties and not differ,
            "near_ties": ties, "differ": differ}

# ---- phase 9: QuantPlane at full width -------------------------------
def quant_workload(vocab, seed=7):
    """Phase 3's 12 prompts (two of three a 384-token shared prefix + 64
    tokens, the rest 16) with 24 new tokens each, plus one seeded sampled
    request on the shared prefix: 13 requests for 6 slots."""
    from repro_torch.core.proxy import SamplingParams
    prompts, base = workload(vocab, seed=seed)
    rng = np.random.default_rng(seed + 100)
    prompts.append(base + tuple(int(t) for t in rng.integers(0, vocab, 64)))
    params = [SamplingParams(max_tokens=P9_NEW)] * 12 + [SamplingParams(
        temperature=0.9, top_k=64, top_p=0.95, seed=909,
        max_tokens=P9_NEW)]
    return prompts, params


def quant_block_reckoning(cfg, bs=16):
    """Bytes one arena block pins per full-attention layer: (int8, f32),
    each with the float32 key summaries (kmin/kmax/kmean [K, h]); int8 adds
    the scale plane (kscale/vscale [K, h], ktok/vtok [K, bs])."""
    K, h = cfg.n_kv_heads, cfg.head_dim
    summaries = 3 * K * h * 4
    scales = 2 * (K * h + K * bs) * 4
    return 2 * K * bs * h + scales + summaries, 2 * K * bs * h * 4 + summaries


def serve_quant(dev, log, cfg):
    """Phase 9 on `cfg` (full-width qwen2-1.5b in main()): phase 3's server
    with quant=QuantConfig(), the counts zeroed just before each measured
    run and read just after. (a) `Server.generate` on phase 3's traffic
    with 24 new tokens and a sampled request; (b) phase 7's prompts without
    and with SpecConfig(k=4); (c) (a)'s traffic on a pool cut until a
    request is preempted. The float32 server's streams on (a)'s traffic
    are reported beside (a)'s, not gated."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    from repro_torch.kernels.spec_verify import spec_verify
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    n_layers = cfg.n_layers
    kerns = (paged_prefill, paged_decode, spec_verify)

    def zero():
        for k in kerns:
            k.launches = k.int8_launches = 0

    def counts():
        return {k.__name__: {"launches": k.launches,
                             "int8_launches": k.int8_launches}
                for k in kerns}

    def check_run(srv, streams, finished, n_new, n_req):
        ds = srv.decodes[0].stats
        assert len(finished) == n_req and all(
            r == "length" for r in finished), finished
        assert [len(x) for x in streams] == n_new, streams
        assert ds["host_fetches"] == ds["steps"] > 0, ds
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)

    prompts, params = quant_workload(cfg.vocab_size)
    warm, _ = workload(cfg.vocab_size, seed=8)
    t0 = time.monotonic()
    srv = build_server(cfg, True, dev, quant=QuantConfig())
    weights = srv.params
    list(srv.generate(warm, SamplingParams(max_tokens=4)))
    reset_stats(srv)
    hl0 = hot_loops(srv)
    zero()
    streams, finished, summ, wall = drive(srv, prompts, params)
    launches = counts()
    hl = check_hot_loops(srv, hl0, dev, entries=CHUNKED_ENTRIES)
    # copies: (b) reuses this server and resets its stats
    ps, ds = dict(srv.prefills[0].stats), dict(srv.decodes[0].stats)
    check_run(srv, streams, finished, [P9_NEW] * 13, 13)
    assert ps["reused_tokens"] > 0 and ds["handoff_copy_bytes"] == 0, ps
    if dev.type == "cuda":
        pp, pd = launches["paged_prefill"], launches["paged_decode"]
        assert pp["launches"] == pp["int8_launches"] \
            == ps["chunks"] * n_layers > 0, (launches, ps)
        assert pd["launches"] == pd["int8_launches"] \
            == ds["steps"] * n_layers > 0, (launches, ds)
    q_bytes, f_bytes = quant_block_reckoning(cfg)
    assert srv.kv_arena.block_nbytes == q_bytes * n_layers, \
        (srv.kv_arena.block_nbytes, q_bytes)
    assert ds["quant_layers"] == n_layers
    K, h = cfg.n_kv_heads, cfg.head_dim
    assert ds["quant_block_bytes"] == \
        (2 * K * 16 * h + 2 * (K * h + K * 16) * 4) * n_layers, ds
    assert ds["quant_block_bytes_f32"] == 2 * K * 16 * h * 4 * n_layers, ds
    sealed = int((srv.kv_arena.kv[0]["kscale"][1:] != 0).any(-1).any(-1)
                 .sum())
    log.append(f"(a) served in {time.monotonic() - t0:.1f} s; layer 0 holds "
               f"{sealed} sealed blocks at the end")

    # the float32 server on the same weights and traffic: report only
    f32 = build_server(cfg, True, dev, params=weights)
    list(f32.generate(warm, SamplingParams(max_tokens=4)))
    reset_stats(f32)
    hl0 = hot_loops(f32)
    f32_streams, _, f32_summ, f32_wall = drive(f32, prompts, params)
    hl_f32 = check_hot_loops(f32, hl0, dev, entries=CHUNKED_ENTRIES)
    ratio = srv.kv_arena.block_nbytes / f32.kv_arena.block_nbytes
    assert f32.kv_arena.block_nbytes == f_bytes * n_layers
    differ = []
    for r in range(12):
        a, b = streams[r], f32_streams[r]
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            differ.append({"request": r, "token": i, "f32_top2_margin":
                           top2_margin(f32, prompts[r], b, i)})
    log.append(f"(a) against the float32 server: {12 - len(differ)}/12 "
               f"greedy streams equal; differing: {differ}")
    del f32
    torch.cuda.empty_cache()

    # (b) speculation over int8 arenas, on phase 7's prompts
    sp_prompts, sp_params = spec_workload(cfg.vocab_size)
    sp_warm, _ = spec_workload(cfg.vocab_size, seed=42)
    spec_out, spec_streams = {}, {}
    servers = {"spec_off": srv}
    servers["spec_on"] = build_server(cfg, True, dev, params=weights,
                                      spec=SpecConfig(k=P7_K),
                                      quant=QuantConfig())
    for name, s2 in servers.items():
        list(s2.generate(sp_warm[:2], SamplingParams(max_tokens=8)))
        reset_stats(s2)
        hl0 = hot_loops(s2)
        zero()
        st, fin, sm, w = drive(s2, sp_prompts, sp_params)
        ln = counts()
        hl2 = check_hot_loops(s2, hl0, dev, entries=(
            "decode.verify" if name == "spec_on" else "decode.step",
            "prefill.chunk"))
        check_run(s2, st, fin, [P7_NEW] * 6 + [16], 7)
        d2 = s2.decodes[0].stats
        verifies = d2.get("spec_verifies", 0)
        if dev.type == "cuda":
            sv, pd = ln["spec_verify"], ln["paged_decode"]
            assert sv["launches"] == sv["int8_launches"] \
                == verifies * n_layers, (ln, d2)
            assert pd["launches"] == pd["int8_launches"] \
                == (d2["steps"] - verifies) * n_layers, (ln, d2)
        if name == "spec_on":
            assert verifies > 0
        spec_streams[name] = st
        spec_out[name] = {"launches": ln, "decode_steps": d2["steps"],
                          "verify_steps": verifies, "hot_loops": hl2,
                          "spec": {k: sm.get(k) for k in (
                              "spec_drafted", "spec_accepted",
                              "draft_acceptance", "tokens_per_verify")},
                          "metrics": {k: sm[k] for k in (
                              "n_done", "ttft_mean", "tpot_mean_ms",
                              "tpot_p99_ms", "ott_tok_s")}
                          | {"wall_s": w}}
    ties = []
    for r, (a, b) in enumerate(zip(spec_streams["spec_on"],
                                   spec_streams["spec_off"])):
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        margin = top2_margin(srv, sp_prompts[r], b, i) if r < 6 else 0.0
        log.append(f"(b) request {r}: spec on/off differ at token {i}, "
                   f"top-2 logit margin {margin:.3g}")
        if r == 6 or margin >= 1e-4:
            raise AssertionError(f"int8 stream {r} differs with speculation "
                                 f"on and off at token {i}")
        ties.append({"request": r, "token": i, "margin": margin})
    del servers["spec_on"]
    torch.cuda.empty_cache()

    # (c) forced preemption: the int8 sidecar makes the round trip exact
    kv_blocks, pre = P9_PREEMPT_BLOCKS, None
    while True:
        s3 = build_server(cfg, True, dev, params=weights, kv_blocks=kv_blocks,
                          quant=QuantConfig())
        reset_stats(s3)
        hl0 = hot_loops(s3)
        st3, fin3, sm3, w3 = drive(s3, prompts, params)
        d3 = s3.decodes[0].stats
        check_run(s3, st3, fin3, [P9_NEW] * 13, 13)
        if d3["preemptions"] >= 1:
            pre = {"kv_blocks": kv_blocks, "preemptions": d3["preemptions"],
                   "hot_loops": check_hot_loops(s3, hl0, dev,
                                                entries=CHUNKED_ENTRIES),
                   "defers": s3.prefills[0].stats["defers"],
                   "decode_steps": d3["steps"], "wall_s": w3}
            break
        del s3
        kv_blocks -= 8
        assert kv_blocks >= 40, "no preemption down to 40 blocks"
    assert st3[:12] == streams[:12], \
        "preempted int8 streams differ from the unpreempted ones"
    pre["sampled_stream_equal"] = st3[12] == streams[12]
    log.append(f"(c) kv_blocks={kv_blocks}: {d3['preemptions']} "
               f"preemptions, greedy streams equal (a)'s bit for bit; "
               f"sampled stream equal {pre['sampled_stream_equal']}")
    del s3, srv
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_chunks": ps["chunks"],
            "decode_steps": ds["steps"], "host_fetches": ds["host_fetches"],
            "host_s_per_round": ds["busy_s"] / ds["steps"],
            "hot_loops": hl, "hot_loops_f32": hl_f32, "streams": streams,
            "reused_tokens": ps["reused_tokens"],
            "block_nbytes": {"int8": q_bytes * n_layers,
                             "float32": f_bytes * n_layers, "ratio": ratio},
            "quant_stats": {k: ds[k] for k in (
                "quant_layers", "quant_block_bytes",
                "quant_block_bytes_f32")},
            "sealed_blocks_layer0": sealed,
            "metrics": {k: summ[k] for k in (
                "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")} | {"wall_s": wall},
            "f32_metrics": {k: f32_summ[k] for k in (
                "ttft_mean", "tpot_mean_ms", "ott_tok_s")}
            | {"wall_s": f32_wall},
            "vs_f32": {"equal": 12 - len(differ), "differ": differ},
            "spec": spec_out, "spec_near_ties": ties,
            "preemption": pre,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ---- phase 8: MoE with OmniPlacement ---------------------------------
def moe_full_config():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-moe-a2.7b").with_updates(
        param_dtype="float32", compute_dtype="float32")
    m = cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size, m.n_experts, m.top_k,
            m.n_shared_experts, m.d_ff_expert, m.capacity_factor) == \
        (24, 2048, 16, 16, 128, 151936, 60, 4, 4, 1408, 2.0)
    return cfg.with_updates(n_layers=P8_LAYERS)


def moe_workload(vocab, new=P8_NEW):
    """Phase 3's traffic: the shared-prefix workload plus two seeded
    sampled requests on the same prefix, `new` new tokens each."""
    from repro_torch.core.proxy import SamplingParams
    prompts, base = workload(vocab)
    rng = np.random.default_rng(11)
    prompts += [base + tuple(int(t) for t in rng.integers(0, vocab, 64))
                for _ in range(2)]
    params = [SamplingParams(max_tokens=new)] * 12 + [
        SamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=900 + i,
                       max_tokens=new) for i in (12, 13)]
    return prompts, params


def build_moe_server(cfg, dev, params=None):
    """Phase 3's server knobs with OmniPlacement's monitor every 4 decode
    rounds; warmed on other tokens (every chunk bucket and the decode
    batch), then its counts, store and device windows reset."""
    from repro_torch.core.proxy import SamplingParams
    srv = build_server(cfg, True, dev, params=params, enable_placement=True,
                       placement_interval=4)
    warm, _ = workload(cfg.vocab_size, seed=8)
    list(srv.generate(warm[:4], SamplingParams(max_tokens=2)))
    reset_stats(srv)
    return srv


def record_drains(srv) -> list:
    """Note (drained count sum, decode tokens so far) at every placement
    tick of the decode engine."""
    eng = srv.decodes[0]
    take, ticks = eng.take_moe_counts, []

    def rec():
        c = take()
        ticks.append((float(c.sum()), int(eng.stats["tokens"])))
        return c
    eng.take_moe_counts = rec
    return ticks


def reversed_slots_plan(srv):
    from repro_torch.core.placement.migration import MigrationPlan
    old = srv.tables["slot_expert"].cpu().numpy()
    new = old[:, ::-1].copy()
    return MigrationPlan(old, new, tuple(
        (0, i, int(new[0, i])) for i in range(new.shape[1])), new.shape[1])


def check_moe_layer(srv, cfg, prompt, log):
    """(c) One real 128-token prefill chunk's hidden states at layer 0's
    FFN: moe_ffn through the kernel against the dense oracle, with a
    capacity that drops nothing (all rows) and at the serving capacity
    (the rows none of whose assignments were dropped)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import stack as stack_mod
    from repro_torch.models.common import rms_norm
    p, tables, dev = srv.params["layers"][0], srv.tables, srv.lm.device
    S, k = 128, cfg.moe.top_k
    toks = torch.tensor([prompt[:S]], dtype=torch.int32, device=dev)
    x = srv.lm._embed(srv.params, toks)
    x, _, _ = stack_mod.attn_sublayer(
        cfg, srv.lm.plan.all_specs()[0], p, x, mode="prefill",
        positions=torch.arange(S, device=dev), cache=None, true_len=S,
        max_len=S)
    hid = rms_norm(x, p["ln_mlp"], cfg.rms_eps)[0]
    shared = (p["shared_w1"], p["shared_w3"], p["shared_w2"]) \
        if cfg.moe.n_shared_experts else None
    rs = tables["rep_slot"][:, 0].long()
    canon = [p[n][0][rs] for n in ("moe_w1", "moe_w3", "moe_w2")]
    want = moe_mod.moe_ffn_dense(cfg, hid, p["router"], *canon, shared)
    del canon
    out = {}
    for name, cf in (("no_drop", 16.0), ("serving", cfg.moe.capacity_factor)):
        c = cfg.with_updates(moe_capacity_factor=cf)
        got, counts = moe_mod.moe_ffn(c, hid, p["router"], p["moe_w1"],
                                      p["moe_w3"], p["moe_w2"], tables,
                                      shared)
        assert float(counts.sum()) == S * k
        # the assignments past capacity, recomputed on the host
        _, eidx, _ = moe_mod.router(c, hid, p["router"])
        slot = rs.cpu().numpy()[eidx.cpu().numpy()]
        cap = moe_mod._bucket_capacity(S, k, 1, rs.numel(), cf)
        seen, dropped = {}, np.zeros(S, bool)
        for t in range(S):
            for sl in slot[t]:
                seen[sl] = seen.get(sl, 0) + 1
                dropped[t] |= seen[sl] > cap
        keep = torch.from_numpy(~dropped).to(dev)
        if name == "no_drop":
            assert not dropped.any()
        torch.testing.assert_close(got[keep], want[keep],
                                   **TOL[torch.float32], msg=f"moe {name}")
        out[name] = {"capacity": cap, "tokens_with_drops": int(
            dropped.sum()), "max_abs_err": float(
            (got[keep] - want[keep]).abs().max())}
        log.append(f"(c) layer-0 moe_ffn vs dense oracle, {name} capacity "
                   f"{cap}: {int(dropped.sum())} of {S} tokens had a "
                   f"dropped assignment; max_abs_err over the rest "
                   f"{out[name]['max_abs_err']:.3g}")
    return out


def serve_moe(dev, log, cfg, weights=None):
    """Phase 8 on `cfg` (full-width qwen2-moe-a2.7b in main(); phase 13
    passes qwen3-moe with its `weights`, which (b)'s migration re-slots in
    place: run it last on them)."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    L, k = cfg.n_layers, cfg.moe.top_k
    prompts, params = moe_workload(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    srv = build_moe_server(cfg, dev, params=weights)
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in
                 [v for lay in srv.params["layers"] for v in lay.values()]
                 + [v for k_, v in srv.params.items() if k_ != "layers"])
    log.append(f"server built and warmed in {time.monotonic() - t0:.1f} s; "
               f"weights {wbytes / 1e9:.2f} GB")
    hist0 = len(srv.placement_sched.history)
    ticks = record_drains(srv)

    # (a) the main path through generate
    hl0 = hot_loops(srv)
    moe_gmm.launches = paged_prefill.launches = paged_decode.launches = 0
    streams, finished, summ, wall = drive(srv, prompts, params)
    hl = check_hot_loops(srv, hl0, dev, entries=CHUNKED_ENTRIES)
    launches = {"moe_gmm": moe_gmm.launches,
                "paged_prefill": paged_prefill.launches,
                "paged_decode": paged_decode.launches}
    ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
    assert len(finished) == len(prompts) and all(
        r == "length" for r in finished), finished
    assert [len(x) for x in streams] == [P8_NEW] * len(prompts), streams
    assert ds["host_fetches"] == ds["steps"] > 0, ds
    if dev.type == "cuda":
        assert launches["paged_prefill"] == ps["chunks"] * L > 0, launches
        assert launches["paged_decode"] == ds["steps"] * L > 0, launches
        assert launches["moe_gmm"] == 3 * L * (ps["chunks"] + ds["steps"]), \
            (launches, ps["chunks"], ds["steps"])
    srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
    hist = srv.placement_sched.history[hist0:]
    assert len(ticks) >= 4 and len(hist) == len(ticks), (ticks, hist)
    assert all(h["b"] == 1.0 and not h["rebalanced"] for h in hist), hist
    assert srv.n_migrations == 0
    prev = 0
    for total, tokens in ticks:
        assert total == k * L * (tokens - prev), (ticks, k, L)
        prev = tokens
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    weights, a_steps = srv.params, ds["steps"]
    res = {"launches": launches, "prefill_chunks": ps["chunks"],
           "decode_steps": a_steps, "host_fetches": ds["host_fetches"],
           "host_s_per_round": ds["busy_s"] / a_steps, "hot_loops": hl,
           "reused_tokens": ps["reused_tokens"],
           "prefill_tokens": ps["tokens"], "weights_gb": wbytes / 1e9,
           "placement_ticks": [{"assignments": t, "decode_tokens": n}
                               for t, n in ticks],
           "rebalances": srv.placement_sched.n_rebalances,
           "metrics": {k_: summ[k_] for k_ in (
               "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
               "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")} | {"wall_s": wall},
           "peak_mem_gb": peak_a}
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same weights and traffic through add_request/step, with the
    # slot order reversed halfway through decode
    srv = build_moe_server(cfg, dev, params=weights)
    hl0 = hot_loops(srv)
    for prompt, sp in zip(prompts, params):
        srv.add_request(prompt, sp)
    out, mig = {}, None
    t1 = time.monotonic()
    while srv.proxy.inflight and time.monotonic() - t1 < 900:
        for o in srv.step():
            out.setdefault(o.rid, []).extend(o.new_tokens)
        if mig is None and srv.decodes[0].stats["steps"] >= a_steps // 2:
            tm = time.monotonic()
            srv._apply_migration(reversed_slots_plan(srv))
            torch.cuda.synchronize()
            mig = {"at_step": srv.decodes[0].stats["steps"],
                   "seconds": time.monotonic() - tm}
    streams_b = [out[r] for r in sorted(out)]
    ds = srv.decodes[0].stats
    assert srv.n_migrations == 1 and mig is not None
    assert ds["host_fetches"] == ds["steps"] > 0
    assert streams_b[:12] == streams[:12], \
        "greedy streams changed across the forced migration"
    srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
    res["migration"] = mig | {
        "hot_loops": check_hot_loops(srv, hl0, dev,
                                     entries=CHUNKED_ENTRIES),
        "greedy_streams_identical": True,
        "sampled_streams_identical": streams_b[12:] == streams[12:],
        "slot_expert_reversed": bool(
            srv.tables["slot_expert"][0, 0] == cfg.moe.n_experts - 1)}

    # (c) one layer's moe_ffn on real hidden states against the oracle
    res["layer_check"] = check_moe_layer(srv, cfg, prompts[0], log)
    res["peak_mem_gb"] = max(peak_a, torch.cuda.max_memory_allocated() / 1e9)
    del srv, weights
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---- phase 13: the reference's other four decoders at full width -------
# depth cuts forced by 80 GB of float32 weights (PERF.md §4) and by the
# script's 1,200 s: qwen3-32b and granite-34b keep 8 layers,
# qwen3-moe-235b-a22b 5 (129 expert slots x 3 x 4,096 x 1,536 floats =
# 9.7 GB a layer); gemma3-4b keeps 6 of its 34, one whole period of its
# 5 local : 1 global pattern (5 window layers, 1 full), which pays for
# phase 14 (d) and phase 17 (g)
P13_DEPTH = {"gemma3-4b": 6, "qwen3-32b": 8, "granite-34b": 8,
             "qwen3-moe-235b-a22b": 5}
# gemma3-4b's published depth (the seconds the cut saves are reckoned
# against it)
G3_LAYERS_PUBLISHED = 34
# gemma3-4b's traffic: six prompts of 1,536-2,048 tokens, the 1st, 2nd, 4th
# and 5th on a shared 512-token prefix (four chunks), so the 1,024-token
# local windows wrap; two sampled requests on the prefix; 16 new tokens
# each, on a server at max_len 2,304
G3_LENS, G3_SAMPLED = (1536, 1664, 1792, 1920, 2048, 1600), (1700, 1850)
G3_PREFIX, G3_NEW, G3_MAX_LEN, G3_BLOCKS, G3_CHUNK = 512, 16, 2304, 1200, 128


def arch_config(arch):
    """A decoder of the port's registry at full width in float32, cut in
    depth where P13_DEPTH says."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_updates(compute_dtype="float32",
                                        param_dtype="float32")
    if arch in P13_DEPTH:
        cfg = cfg.with_updates(n_layers=P13_DEPTH[arch])
    return cfg


def init_weights(cfg, dev):
    """The seed-0 weights every Server(seed=0) of `cfg` would make, made
    once (→ params, GB)."""
    from repro_torch.models.lm import LM
    params = LM.build(cfg, pattern=[0] * cfg.n_layers, device=dev).init(0)
    gb = sum(t.numel() * t.element_size() for t in
             [v for lay in params["layers"] for v in lay.values()]
             + [v for k, v in params.items() if k != "layers"]) / 1e9
    return params, gb


def gemma3_workload(vocab, seed=61):
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(seed)
    base = tuple(int(t) for t in rng.integers(0, vocab, G3_PREFIX))

    def tail(n):
        return tuple(int(t) for t in rng.integers(0, vocab, n))
    prompts = [base + tail(n - G3_PREFIX) if i % 3 != 2 else tail(n)
               for i, n in enumerate(G3_LENS)]
    prompts += [base + tail(n - G3_PREFIX) for n in G3_SAMPLED]
    params = [SamplingParams(max_tokens=G3_NEW)] * 6 + [
        SamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=960 + i,
                       max_tokens=G3_NEW) for i in range(2)]
    return prompts, params


def build_g3_server(cfg, dev, params, pattern="full", **knobs):
    """gemma3-4b's server: phase 3's knobs at max_len 2,304 with a
    1,200-block pool; `pattern` "full" is [0] * n_layers (at 6 layers 5
    window layers, 1 full), None the default OmniAttn pattern."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    scfg = ServerConfig(**(dict(
        decode_slots=6, max_len=G3_MAX_LEN, chunk_tokens=G3_CHUNK,
        prefill_tick_budget=512, prefix_reuse=True, kv_blocks=G3_BLOCKS,
        kv_block_size=16, oas=OASConfig(defer_window=0.0)) | knobs))
    return Server(cfg, scfg, pattern=[0] * cfg.n_layers
                  if pattern == "full" else pattern, params=params, seed=0,
                  device=dev)


def served_run(srv, prompts, params, dev, entries, warm=None):
    """One measured run: (a warm-up on `warm` outside the counts), every
    launch counter set to 0 just before `Server.generate`, read just after;
    the run's hot-loop entries `entries` must have replayed. → record."""
    from repro_torch.kernels._common import add_launch_counts, launch_counts
    if warm is not None:
        list(srv.generate(*warm))
        reset_stats(srv)
    hl0 = hot_loops(srv)
    add_launch_counts(launch_counts(), -1)
    streams, finished, summ, wall = drive(srv, prompts, params)
    launches = {k.split(".")[0] + ("_int8" if "int8" in k else ""): v
                for k, v in launch_counts().items()}
    launches["block_topk"] = launches.pop("block_topk_scores")
    hl = check_hot_loops(srv, hl0, dev, entries=entries)
    ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
    assert len(finished) == len(prompts) and all(
        r == "length" for r in finished), finished
    assert [len(s) for s in streams] == [p.max_tokens for p in params]
    assert ds["host_fetches"] == ds["steps"] > 0, ds
    srv.decodes[0].pool.check_invariants(arena=srv.kv_arena)
    return {"streams": streams, "launches": launches,
            "chunks": ps["chunks"], "whole_prefills": ps["prefills"],
            "steps": ds["steps"], "verifies": ds.get("spec_verifies", 0),
            "reused_tokens": ps["reused_tokens"], "hot_loops": hl,
            "host_s_per_round": ds["busy_s"] / ds["steps"],
            "summary": {k: summ[k] for k in (
                "blocks_scored", "blocks_attended", "spec_drafted",
                "spec_accepted", "spec_verifies") if k in summ},
            "metrics": {k: summ[k] for k in (
                "n_done", "ttft_mean", "ttft_p99", "tpot_mean_ms",
                "tpot_p99_ms", "ott_tok_s", "ttt_tok_s")} | {"wall_s": wall}}


def near_tie_diffs(srv, prompts, params, got, want, what, log,
                   limit=1e-4):
    """Greedy streams `got` against `want` under phase 5's near-tie rule
    (`stream_diffs`): a greedy stream may differ only where `srv`'s model
    puts its top-2 logits within `limit` at the first differing token;
    sampled streams that differ are logged. → the near-ties."""
    ties = []
    for d in stream_diffs(srv, prompts, params, got, want):
        log.append(f"{what}: request {d['request']} differs at token "
                   f"{d['token']}, top-2 logit margin {d['margin']}")
        if d["sampled"]:
            continue
        if d["margin"] is None or d["margin"] >= limit:
            raise AssertionError(f"{what}: stream {d['request']} differs: "
                                 f"{d}")
        ties.append(d)
    return ties


def serve_gemma3(dev, log, cfg, params):
    """Phase 13 on full-width gemma3-4b at P13_DEPTH's 6 layers (h 256, 8
    query heads over 4 kv heads, 5 window layers + 1 full): (a) chunked
    paged prefill with prefix reuse on and off; top-k on (a)'s model; (b)
    whole-prompt prefill on the slot-dense layout; (c) speculation on and
    off; (d) int8 arenas, plain and with speculation; (e) the default
    OmniAttn pattern (the globals compressed to sink + recent), paged and
    dense."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    L = cfg.n_layers
    n_full = sum(sp.window == 0 for sp in cfg.layer_specs())
    prompts, sp = gemma3_workload(cfg.vocab_size)
    warm = ([p[:1900] for p in gemma3_workload(cfg.vocab_size, seed=62)[0]
             [:3]], SamplingParams(max_tokens=4))
    runs, ties = {}, {}

    def run(name, entries, warm_=None, **knobs):
        t0 = time.monotonic()
        srv = build_g3_server(cfg, dev, params, **knobs)
        r = runs[name] = served_run(srv, prompts if "spec" not in knobs
                                    else spec_prompts, sp if "spec" not in
                                    knobs else spec_params, dev, entries,
                                    warm=warm_)
        log.append(f"gemma3 {name}: {r['chunks']} chunks, "
                   f"{r['whole_prefills']} whole prefills, {r['steps']} "
                   f"steps ({r['verifies']} verifies); launches "
                   f"{ {k: v for k, v in r['launches'].items() if v} }; "
                   f"TTFT mean {r['metrics']['ttft_mean'] * 1e3:.1f} ms, "
                   f"TPOT mean {r['metrics']['tpot_mean_ms']:.2f} ms; "
                   f"{hot_loop_line(r['hot_loops'])} "
                   f"[{time.monotonic() - t0:.1f} s]")
        return srv, r

    spec_prompts, spec_params = spec_workload(cfg.vocab_size, repeats=2)
    # (a) the main path: chunked paged prefill, reuse on (warmed) and off
    srv, a = run("a_reuse_on", CHUNKED_ENTRIES, warm_=warm)
    ln = a["launches"]
    if dev.type == "cuda":
        # the full layers' chunks attend the arenas; every layer decodes
        # paged (the window layers over their slots' ring block runs)
        assert ln["paged_prefill"] == a["chunks"] * n_full > 0, ln
        assert ln["paged_decode"] == a["steps"] * L > 0, ln
    assert a["reused_tokens"] > 0
    del srv
    _, off = run("a_reuse_off", CHUNKED_ENTRIES, prefix_reuse=False)
    assert off["streams"][:6] == a["streams"][:6], \
        "gemma3: greedy streams differ with prefix reuse on and off"
    # online top-k on (a)'s model: the 5 full layers select a quarter of
    # their blocks (block_topk at K 4, G 2, h 256)
    tcfg = cfg.with_updates(omniattn_topk_frac=0.25)
    srv = build_g3_server(tcfg, dev, params)
    t = runs["a_topk"] = served_run(srv, prompts, sp, dev, CHUNKED_ENTRIES)
    if dev.type == "cuda":
        assert t["launches"]["block_topk"] == t["steps"] * n_full > 0
    same = sum(x == y for x, y in zip(t["streams"][:6], a["streams"][:6]))
    log.append(f"gemma3 a_topk (frac 0.25): blocks attended/scored "
               f"{t['summary']['blocks_attended']}/"
               f"{t['summary']['blocks_scored']}; greedy streams equal "
               f"top-k off {same}/6")
    del srv
    # (b) whole-prompt prefill, slot-dense KV
    srv, b = run("b_whole_dense", ("decode.step",), paged_kv=False,
                 chunked_prefill=False)
    if dev.type == "cuda":
        assert b["launches"]["flash_prefill"] == b["whole_prefills"] * L > 0
        assert b["launches"]["sink_decode"] == b["steps"] * L > 0
    ties["b"] = near_tie_diffs(srv, prompts, sp, b["streams"], a["streams"],
                               "gemma3 (b) vs (a)", log)
    del srv
    # (c) speculation on and off, spec-repeat's prompts
    srv, c_off = run("c_spec_off", ("decode.step",), spec=None)
    _, c_on = run("c_spec_on", ("decode.verify",), spec=SpecConfig(k=P7_K))
    if dev.type == "cuda":
        assert c_on["launches"]["spec_verify"] == c_on["verifies"] * n_full \
            > 0
    ties["c"] = near_tie_diffs(srv, spec_prompts, spec_params,
                               c_on["streams"], c_off["streams"],
                               "gemma3 (c) spec", log)
    del srv
    # (d) int8 arenas: (a)'s traffic, then speculation on and off
    srv, d = run("d_int8", CHUNKED_ENTRIES, quant=QuantConfig())
    if dev.type == "cuda":
        assert d["launches"]["paged_prefill_int8"] == d["chunks"] * n_full
        assert d["launches"]["paged_decode_int8"] == d["steps"] * n_full > 0
    agree = sum(x == y for x, y in zip(d["streams"][:6], a["streams"][:6]))
    log.append(f"gemma3 d_int8: greedy streams equal float32's {agree}/6")
    del srv
    srv, d_off = run("d_int8_spec_off", ("decode.step",), spec=None,
                     quant=QuantConfig())
    _, d_on = run("d_int8_spec_on", ("decode.verify",),
                  spec=SpecConfig(k=P7_K), quant=QuantConfig())
    if dev.type == "cuda":
        assert d_on["launches"]["spec_verify_int8"] == \
            d_on["verifies"] * n_full > 0
    ties["d"] = near_tie_diffs(srv, spec_prompts, spec_params,
                               d_on["streams"], d_off["streams"],
                               "gemma3 (d) int8 spec", log)
    del srv
    # (e) the default pattern: every layer a ring (29 windows, 5
    # compressed globals), whole-prompt prefill, paged and dense
    srv, e_p = run("e_default_paged", ("decode.step",), pattern=None)
    _, e_d = run("e_default_dense", ("decode.step",), pattern=None,
                 paged_kv=False)
    if dev.type == "cuda":
        for r, dec in ((e_p, "paged_decode"), (e_d, "sink_decode")):
            assert r["launches"]["flash_prefill"] == r["whole_prefills"] * L
            assert r["launches"][dec] == r["steps"] * L > 0
    ties["e"] = near_tie_diffs(srv, prompts, sp, e_d["streams"],
                               e_p["streams"], "gemma3 (e) dense vs paged",
                               log)
    del srv
    for r in runs.values():
        r.pop("streams")
    return {"runs": runs, "near_ties": ties, "full_layers": n_full,
            "int8_streams_equal_f32": agree}


def serve_dense_arch(dev, log, cfg, params, phase3_streams):
    """Phase 3's traffic on `cfg` through whole-prompt prefill and the
    slot-dense layout (flash_prefill and sink_decode), equal to phase 3's
    chunked paged streams up to the near-tie rule; then online top-k at
    half the table on the paged layout (block_topk)."""
    from repro_torch.core.proxy import SamplingParams
    L = cfg.n_layers
    prompts, base = workload(cfg.vocab_size)
    rng = np.random.default_rng(11)
    prompts += [base + tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          64))
                for _ in range(2)]
    sp = [SamplingParams(max_tokens=4)] * 12 + [
        SamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=900 + i,
                       max_tokens=4) for i in (12, 13)]
    srv = build_server(cfg, True, dev, params=params, paged_kv=False,
                       chunked_prefill=False)
    d = served_run(srv, prompts, sp, dev, ("decode.step",))
    if dev.type == "cuda":
        assert d["launches"]["flash_prefill"] == d["whole_prefills"] * L > 0
        assert d["launches"]["sink_decode"] == d["steps"] * L > 0
    ties = near_tie_diffs(srv, prompts, sp, d["streams"], phase3_streams,
                          f"{cfg.arch_id} dense whole-prompt vs chunked "
                          f"paged", log)
    del srv
    srv = build_server(cfg.with_updates(omniattn_topk_frac=0.5), True, dev,
                       params=params)
    t = served_run(srv, prompts, sp, dev, CHUNKED_ENTRIES)
    if dev.type == "cuda":
        assert t["launches"]["block_topk"] == t["steps"] * L > 0
    del srv
    d.pop("streams")
    t.pop("streams")
    log.append(f"{cfg.arch_id} dense whole-prompt: {d['whole_prefills']} "
               f"prefills, {d['steps']} steps, launches "
               f"{ {k: v for k, v in d['launches'].items() if v} }; top-k "
               f"0.5: blocks attended/scored "
               f"{t['summary']['blocks_attended']}/"
               f"{t['summary']['blocks_scored']}, launches "
               f"{ {k: v for k, v in t['launches'].items() if v} }")
    return {"dense": d, "topk": t, "near_ties": ties}


def serve_archs(dev, log, archs=("gemma3-4b", "qwen3-32b", "granite-34b",
                                 "qwen3-moe-235b-a22b")):
    """Phase 13: gemma3-4b at full width and depth; qwen3-32b, granite-34b
    and qwen3-moe-235b-a22b at full width and the depths of P13_DEPTH. One
    model's weights alive at a time, each made once from seed 0."""
    out = {}
    for arch in archs:
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        cfg = arch_config(arch)
        params, gb = init_weights(cfg, dev)
        rec = {"n_layers": cfg.n_layers, "weights_gb": gb}
        log.append(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
                   f"{cfg.n_heads}/{cfg.n_kv_heads} heads, h "
                   f"{cfg.head_dim}; weights {gb:.2f} GB")
        if arch == "gemma3-4b":
            rec.update(serve_gemma3(dev, log, cfg, params))
        elif arch == "qwen3-moe-235b-a22b":
            # a verify step routes 6 x 5 window rows at once and a decode
            # step 6: at the serving capacity (factor 2.0, 8 rows a slot)
            # a verify can drop an assignment a step does not. Equality is
            # held at a capacity that drops nothing; the serving capacity's
            # differences are reported
            nodrop = cfg.with_updates(moe_capacity_factor=MOE3_NODROP_CF)
            rec["spec"] = serve_spec(dev, log, nodrop, weights=params,
                                     repeats=2)
            rec["spec_serving_capacity"] = serve_spec(
                dev, log, cfg, weights=params, repeats=2,
                require_equal=False)
            rec["topk"] = serve_topk(dev, log, cfg, weights=params)
            rec["moe"] = serve_moe(dev, log, cfg, weights=params)
        else:
            rec["serve"] = serve(dev, log, cfg, weights=params)
            rec["spec"] = serve_spec(dev, log, cfg, weights=params,
                                     repeats=2)
            if arch == "granite-34b":
                rec.update(serve_dense_arch(dev, log, cfg, params,
                                            rec["serve"]["streams"]))
            rec["serve"].pop("streams")
        for key in ("spec", "spec_serving_capacity"):
            for r in rec.get(key, {}).get("runs", {}).values():
                r.pop("streams", None)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["seconds"] = time.monotonic() - t0
        out[arch] = rec
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---- phase 14: the SSM and hybrid stacks -------------------------------
# jamba-1.5-large-398b in bfloat16, cut to its first 5 layers (m, m+moe, m,
# m+moe, attn: ~50 GB of weights; one whole 8-layer period is ~95 GB)
P14_JAMBA_DEPTH = 5
# phase 14 (d)'s fault seed (mamba2-130m under FaultPlane chaos)
P14_CHAOS_SEED = 1
# phase 5's near-tie limit for bfloat16 logits: two of their steps at the
# top logit's magnitude of jamba's seed-0 weights
BF16_TIE = 2 ** -4


def mamba2_config():
    """mamba2-130m as published (24 Mamba-2 layers, d_model 768, 24 SSM heads
    of 64, d_state 128, vocab 50,280, tied) in float32."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m").with_updates(compute_dtype="float32",
                                                 param_dtype="float32")
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, s.d_state, s.head_dim,
            s.expand, s.conv_width) == (24, 768, 50280, 128, 64, 2, 4)
    return cfg


def jamba_config():
    """jamba-1.5-large-398b at full width in its published bfloat16, cut to
    P14_JAMBA_DEPTH layers."""
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b")
    m = cfg.moe
    assert (cfg.compute_dtype, cfg.param_dtype) == ("bfloat16", "bfloat16")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, m.n_experts, m.top_k, m.d_ff_expert,
            m.moe_every) == (8192, 64, 8, 128, 24576, 65536, 16, 2, 24576, 2)
    return cfg.with_updates(n_layers=P14_JAMBA_DEPTH)


def state_bytes_per_slot(cfg) -> int:
    """Bytes of one slot's Mamba-2 entries over the stack (state and
    convolution rows)."""
    from repro_torch.models.stack import StackPlan, mamba_cache_shapes
    one = sum(math.prod(shp) * dt.itemsize
              for shp, dt in mamba_cache_shapes(cfg, 1).values())
    return one * sum(1 for s in StackPlan.from_config(
        cfg, [0] * cfg.n_layers).all_specs() if s.kind == "mamba")


def ssm_captured_checks(srv, dev, timer):
    """mamba2's captured decode step (six slots) and 128-row chunk (100
    real rows at offset 192) against eager on the same inputs, from seeded
    random state and convolution rows that each call first restores (inside
    the graph), so every call reads the same state: the largest logits
    difference of each, the device time of a replay of each, and that time
    split into the SSD, the GEMMs (the five projections of every layer and
    the head) and the rest, each part at the call's shapes for every layer
    captured as a graph of its own and timed by a replay, as the step
    is."""
    from repro_torch.models import ssd as ssd_mod
    from repro_torch.models.common import rms_norm
    from repro_torch.models.stack import (alloc_paged_private_cache,
                                          alloc_prefill_private_cache)
    from repro_torch.serving import DevicePlacement
    lm, cfg, params = srv.lm, srv.lm.cfg, srv.params
    assert all(s.kind == "mamba" for s in lm.plan.all_specs())
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    V, D = cfg.vocab_size, cfg.d_model
    ssm = cfg.ssm
    d_in = ssm.expand * D
    nh, N = d_in // ssm.head_dim, ssm.d_state

    def randomized(cache):
        saved = []
        for e in cache["layers"]:
            for t in e.values():
                t.copy_(torch.randn(t.shape, generator=g, device=dev))
                saved.append((t, t.clone()))
        return saved

    place = DevicePlacement.of(dev)

    def graph_ms(part, name):
        """Device ms of one replay of `part` captured as a hot-loop entry
        (its results are discarded)."""
        done = torch.zeros(1, device=dev)

        def body(key, done):
            part()
            return done
        e = place.hot_loop(body, name=name)
        e((name,), (done,))
        e((name,), (done,))                   # capture, then one replay
        return timer(lambda: e((name,), (done,)))

    out = {}
    for what, B, S in (("step", 6, 1), ("chunk", 1, 128)):
        if what == "step":
            cache = alloc_paged_private_cache(cfg, lm.plan, B, 512, 16, dev)
        else:
            cache = alloc_prefill_private_cache(cfg, lm.plan, 512, dev)
            cache["pos"] = torch.tensor(192, dtype=torch.int32, device=dev)
        saved = randomized(cache)
        toks = torch.randint(0, V, (B, S), generator=g, device=dev,
                             dtype=torch.int32)
        pos = torch.tensor([200, 37, 101, 250, 5, 133][:B],
                           dtype=torch.int32, device=dev)[:, None]
        cl = torch.tensor(100, dtype=torch.int32, device=dev)
        res = torch.empty((B, V), dtype=torch.float32, device=dev)

        def call(key, res, cache=cache, saved=saved, toks=toks, pos=pos,
                 cl=cl, what=what):
            for t, t0 in saved:
                t.copy_(t0)
            if what == "step":
                logits = lm.decode(params, cache, toks, pos)[1]
            else:
                logits = lm.prefill_resume(params, toks, cache,
                                           chunk_len=cl)[1]
            return res.copy_(logits)

        entry = place.hot_loop(call, name=f"check.{what}")
        key = (what,)
        eager = entry(key, (res,)).clone()
        entry(key, (res,))                    # capture, then one replay
        torch.cuda.synchronize()
        assert dev.type != "cuda" or entry.replays[key] == 1
        diff = float((res - eager).abs().max())
        total = timer(lambda: entry(key, (res,)))
        # the parts at this call's shapes, for every layer
        hid = torch.randn((B, S, D), generator=g, device=dev)
        y = torch.randn((B, S, d_in), generator=g, device=dev)
        last = rms_norm(hid[:, -1], params["final_norm"])

        def gemms():
            for p in params["layers"]:
                for w in ("w_z", "w_x", "w_bc", "w_dt"):
                    hid @ p[w]
                y @ p["out_proj"]
            last @ params["embed"].t()
        xh = torch.randn((B, S, nh, ssm.head_dim), generator=g, device=dev)
        dt = torch.rand((B, S, nh), generator=g, device=dev) * 0.1
        As = [-torch.exp(p["A_log"].float()) for p in params["layers"]]
        Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev)
                  for _ in range(2))
        st = torch.randn((B, nh, ssm.head_dim, N), generator=g, device=dev)

        def ssds():
            for A in As:
                if what == "step":
                    ssd_mod.ssd_decode_step(st, xh[:, 0], dt[:, 0], A,
                                            Bm[:, 0], Cm[:, 0])
                else:
                    ssd_mod.ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk, st)
        gemm = graph_ms(gemms, f"check.{what}.gemm")
        ssd = graph_ms(ssds, f"check.{what}.ssd")
        out[what] = {"logits_max_abs_diff": diff, "ms": total,
                     "ssd_ms": ssd, "gemm_ms": gemm,
                     "rest_ms": total - ssd - gemm,
                     "ssd_share": ssd / total}
        del entry, cache, saved
    return out


def serve_mamba2(dev, log, timer):
    """Phase 14 on mamba2-130m at full width in float32: (a) phase 3's
    traffic chunked paged, prefix reuse on and off, captured and eager;
    (b) topk-long's six 3,968-token prompts chunked paged against
    whole-prompt slot-dense; (c) speculation refused, int8 arenas degraded
    to float; (d) FaultPlane chaos over two prefill and two decode
    instances (`serve_ssm_chaos`). No kernel of the port runs: its launches
    must stay 0."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving import DevicePlacement
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cfg = mamba2_config()
    params, gb = init_weights(cfg, dev)
    rec = {"weights_gb": gb, "state_bytes_per_slot": state_bytes_per_slot(
        cfg)}
    prompts, sp = moe_workload(cfg.vocab_size, new=4)
    warm = (workload(cfg.vocab_size, seed=8)[0], SamplingParams(max_tokens=4))

    def no_launch(r, what):
        if dev.type == "cuda":
            assert not any(r["launches"].values()), (what, r["launches"])

    # (a) reuse on and off, captured; then eager
    runs = {}
    for name, reuse in (("a_reuse_on", True), ("a_reuse_off", False)):
        srv = build_server(cfg, reuse, dev, params=params)
        r = served_run(srv, prompts, sp, dev, CHUNKED_ENTRIES, warm=warm)
        no_launch(r, name)
        assert (r["reused_tokens"] > 0) == reuse, r["reused_tokens"]
        assert srv.decodes[0].stats["handoff_copy_bytes"] == 0
        assert srv.kv_arena.block_nbytes == 0
        assert srv.kv_arena.find_corrupt_blocks() == []
        runs[name] = r
        if reuse:
            rec["captured"] = ssm_captured_checks(srv, dev, timer)
        del srv
    assert runs["a_reuse_on"]["streams"][:12] == \
        runs["a_reuse_off"]["streams"][:12], \
        "mamba2: greedy streams differ with prefix reuse on and off"
    srv = build_server(cfg, True, dev, params=params,
                       placement=DevicePlacement.of(dev, capture=False))
    e = served_run(srv, prompts, sp, dev, (), warm=warm)
    assert all(v["captures"] == v["replays"] == 0
               for n, v in e["hot_loops"].items() if n != "pool_gb")
    assert e["streams"] == runs["a_reuse_on"]["streams"], \
        "mamba2: streams differ between capture and eager"
    for what, c in rec["captured"].items():
        assert c["logits_max_abs_diff"] == 0.0, (what, c)
    runs["a_eager"] = e
    del srv
    # (c) speculation refused; int8 arenas degrade to float
    try:
        build_server(cfg, True, dev, params=params, spec=SpecConfig(k=P7_K))
        raise AssertionError("mamba2: speculation was not refused")
    except ValueError as err:
        rec["spec_refused"] = str(err)
    srv = build_server(cfg, True, dev, params=params, quant=QuantConfig())
    assert srv.quant_ctl is None and not srv.kv_arena.quant
    q = served_run(srv, prompts, sp, dev, CHUNKED_ENTRIES, warm=warm)
    no_launch(q, "c_quant")
    assert q["streams"] == runs["a_reuse_on"]["streams"], \
        "mamba2: int8 knob changed the streams"
    runs["c_quant_degraded"] = q
    del srv
    # (b) long prompts: chunked paged against whole-prompt slot-dense
    lprompts, lparams = topk_workload(cfg.vocab_size)
    lwarm = ([topk_workload(cfg.vocab_size, seed=32)[0][0][:200]],
             SamplingParams(max_tokens=3))
    srv = long_server(cfg, dev, params)
    b = served_run(srv, lprompts, lparams, dev, CHUNKED_ENTRIES, warm=lwarm)
    no_launch(b, "b_chunked_paged")
    del srv
    srv = long_server(cfg, dev, params, paged_kv=False,
                      chunked_prefill=False)
    d = served_run(srv, lprompts, lparams, dev, ("decode.step",), warm=lwarm)
    no_launch(d, "b_whole_dense")
    assert d["whole_prefills"] == len(lprompts) and d["chunks"] == 0
    rec["long_near_ties"] = near_tie_diffs(
        srv, lprompts, lparams, d["streams"], b["streams"],
        "mamba2 long: whole-prompt slot-dense vs chunked paged", log)
    runs["b_chunked_paged"], runs["b_whole_dense"] = b, d
    del srv
    rec["chaos"] = serve_ssm_chaos(dev, log, cfg, params)
    for r in runs.values():
        r.pop("streams")
    rec["runs"] = runs
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.monotonic() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def serve_ssm_chaos(dev, log, cfg, params) -> dict:
    """Phase 14 (d): FaultPlane on `cfg` (mamba2-130m as published) over
    phase 12's two prefill and two decode instances and phase 12's traffic
    (a): a fault-free run, then FaultPlane(FaultConfig(P14_CHAOS_SEED,
    horizon)) on a new warmed server, the horizon half the fault-free
    server steps (phase 12's rule). Every restart, handoff and preemption
    moves a slot's Mamba-2 state and convolution rows, and a restarted
    request re-prefills them; the chaos streams (greedy and sampled) must
    equal the fault-free streams. No arena entry carries a summary plane,
    so every kv_corrupt is skipped, as in the reference."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving import FaultConfig, FaultPlane
    t0 = time.monotonic()
    prompts, sp = chaos_workload(cfg.vocab_size)
    warm = (workload(cfg.vocab_size, seed=8)[0], SamplingParams(max_tokens=4))
    base = build_chaos_server(cfg, dev, params=params)
    ref = chaos_run(base, prompts, sp, warm, dev)
    assert ref["streams"] == ref.pop("outputs")
    horizon = max(ref["server_steps"] // 2, 3)
    plane = FaultPlane(FaultConfig(seed=P14_CHAOS_SEED, horizon=horizon))
    srv = build_chaos_server(cfg, dev, params=params)
    run = chaos_run(srv, prompts, sp, warm, dev, plane=plane)
    diffs = {k: stream_diffs(base, prompts, sp, run[k], w)
             for k, w in (("streams", run["outputs"]),
                          ("outputs", ref["streams"]))}
    del srv, base
    if any(diffs.values()):
        raise AssertionError(f"mamba2 (d) seed {P14_CHAOS_SEED}: streams "
                             f"differ ({diffs}); fired {plane.fired}")
    assert plane.injected["kv_corrupt"] == 0, plane.fired
    run["reprefilled_chunks"] = run["chunks"] - ref["chunks"]
    for r in (ref, run):
        r.pop("streams")
    run.pop("outputs")
    log.append(f"mamba2 (d) seed {P14_CHAOS_SEED}, horizon {horizon}: chaos "
               f"streams equal the fault-free streams ({len(prompts)} "
               f"requests, two sampled)")
    return {"fault_free": ref, "run": run, "horizon": horizon,
            "seconds": time.monotonic() - t0}


def serve_jamba(dev, log):
    """Phase 14 on jamba-1.5-large-398b at full width in bfloat16, 5 layers:
    (d) every attention layer full, phase 3's traffic (16 new tokens) with
    phase 8's monitor knobs, prefix reuse on and off and on int8 arenas;
    (e) the default pattern (the attention layer compressed to sink 128 +
    recent 4,096), phase 5's traffic whole-prompt over paged and slot-dense
    KV. Launches per layer kind and the drained expert counts asserted."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving.quant import QuantConfig
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cfg = jamba_config()
    params, gb = init_weights(cfg, dev)
    specs = cfg.layer_specs([0] * cfg.n_layers)
    n_attn = sum(1 for s in specs if s.kind == "attn")
    n_moe = sum(1 for s in specs if s.use_moe)
    k = cfg.moe.top_k
    rec = {"weights_gb": gb, "n_layers": cfg.n_layers,
           "layers": [s.kind + ("+moe" if s.use_moe else "") for s in specs],
           "state_bytes_per_slot": state_bytes_per_slot(cfg)}
    log.append(f"jamba: {cfg.n_layers} layers {rec['layers']}, weights "
               f"{gb:.2f} GB (bfloat16), Mamba-2 state "
               f"{rec['state_bytes_per_slot'] / 1e6:.1f} MB a slot")
    prompts, sp = moe_workload(cfg.vocab_size)
    runs = {}
    # (d) every attention layer full, chunked paged
    for name, reuse, knobs in (("d_reuse_on", True, {}),
                               ("d_reuse_off", False, {}),
                               ("d_int8", True, {"quant": QuantConfig()})):
        srv = build_server(cfg, reuse, dev, params=params,
                           enable_placement=True, placement_interval=4,
                           **knobs)
        warm, _ = workload(cfg.vocab_size, seed=8)
        list(srv.generate(warm[:4], SamplingParams(max_tokens=2)))
        reset_stats(srv)
        hist0 = len(srv.placement_sched.history)
        ticks = record_drains(srv)
        r = served_run(srv, prompts, sp, dev, CHUNKED_ENTRIES)
        ln = r["launches"]
        q8 = "_int8" if knobs else ""
        if dev.type == "cuda":
            assert ln["paged_prefill" + q8] == r["chunks"] * n_attn > 0, ln
            assert ln["paged_decode" + q8] == r["steps"] * n_attn > 0, ln
            assert ln["moe_gmm"] == 3 * n_moe * (r["chunks"] + r["steps"]), \
                (ln, r["chunks"], r["steps"])
        assert (r["reused_tokens"] > 0) == reuse
        hist = srv.placement_sched.history[hist0:]
        assert len(ticks) >= 4 and len(hist) == len(ticks), (ticks, hist)
        assert all(not h["rebalanced"] for h in hist), hist
        prev = 0
        for total, tokens in ticks:
            assert total == k * n_moe * (tokens - prev), (ticks, k, n_moe)
            prev = tokens
        r["placement_ticks"] = [{"assignments": t, "decode_tokens": n}
                                for t, n in ticks]
        if knobs:
            assert srv.kv_arena.quant
            srv.kv_arena.check_summaries()
        runs[name] = r
        del srv
        gc.collect()
    on = runs["d_reuse_on"]["streams"]
    assert on[:12] == runs["d_reuse_off"]["streams"][:12], \
        "jamba: greedy streams differ with prefix reuse on and off"
    rec["int8_streams_equal_float"] = sum(
        a == b for a, b in zip(runs["d_int8"]["streams"], on))
    # (e) the default pattern: whole-prompt prefill, paged and slot-dense
    dprompts, dparams = default_pattern_workload(cfg.vocab_size)
    rng = np.random.default_rng(22)
    dwarm = ([tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
              for n in (P5_LONG, P5_SHORT)], SamplingParams(max_tokens=2))
    for name, paged in (("e_default_paged", True), ("e_default_dense",
                                                    False)):
        srv = build_default_server(cfg, paged, dev, params=params)
        assert not srv.prefills[0].chunked
        r = served_run(srv, dprompts, dparams, dev, ("decode.step",),
                       warm=dwarm)
        ln = r["launches"]
        dec = "paged_decode" if paged else "sink_decode"
        if dev.type == "cuda":
            assert ln["flash_prefill"] == r["whole_prefills"] * n_attn > 0, ln
            assert ln[dec] == r["steps"] * n_attn > 0, ln
            assert ln["moe_gmm"] == 3 * n_moe * (r["whole_prefills"]
                                                 + r["steps"]), ln
        runs[name] = r
        if paged:
            paged_srv = srv
        else:
            # bfloat16 logits step by 2^-5 at the top logit's magnitude of
            # these weights (~7.5: head std 0.02 x sqrt(8192) at 4 sigma
            # over 65,536 rows): a near tie is a margin of two steps
            rec["default_near_ties"] = near_tie_diffs(
                paged_srv, dprompts, dparams, r["streams"],
                runs["e_default_paged"]["streams"],
                "jamba default pattern: slot-dense vs paged", log,
                limit=BF16_TIE)
            del paged_srv
        del srv
        gc.collect()
    for r in runs.values():
        r.pop("streams")
    rec["runs"] = runs
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.monotonic() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---- phase 15: training on the card ----------------------------------
# (a) the training launcher at its defaults (batch 8, seq 128, lr 3e-4) on
# qwen2-1.5b as published (bfloat16, float32 moments, remat on): a
# preemption drill of P15_STEPS steps with a checkpoint every P15_EVERY,
# preempted after step P15_PREEMPT, its relaunch, and an uninterrupted run
P15_STEPS, P15_EVERY, P15_PREEMPT = 6, 4, 4
# (c) mamba2-130m as published: batch, seq, steps (the reference example's)
P15_MAMBA = (4, 256, 6)
# (d) qwen2-moe-a2.7b at its published widths and grad_accum 2, cut to its
# first P15_MOE_LAYERS layers (bfloat16 parameters and gradients, float32
# accumulators and moments: ~47 GB), P15_MOE_STEPS steps at the launcher's
# batch and seq
P15_MOE_LAYERS, P15_MOE_STEPS = 4, 3
# the resumed steps against the uninterrupted run's where they are not bit
# for bit, and (e) card against CPU in float32 (PERF.md §6), relative
P15_RESUME_TOL = {"loss": 1e-3, "grad_norm": 1e-2}
P15_CPU_TOL = {"loss": 1e-5, "grad_norm": 1e-4}
P15_CKPT_DIR = ROOT / "chiprun_ckpt"
# the published fields phase 15 holds each architecture to
P15_PUBLISHED = {
    "qwen2-1.5b": dict(n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
                       head_dim=128, d_ff=8960, vocab_size=151936,
                       tie_embeddings=True, param_dtype="bfloat16",
                       compute_dtype="bfloat16", optimizer_dtype="float32",
                       remat=True, grad_accum=1),
    "mamba2-130m": {"n_layers": 24, "d_model": 768, "ssm.d_state": 128,
                    "vocab_size": 50280, "param_dtype": "bfloat16",
                    "remat": True},
    "qwen2-moe-a2.7b": {"n_layers": 24, "d_model": 2048, "n_heads": 16,
                        "d_ff": 1408, "vocab_size": 151936,
                        "moe.n_experts": 60, "moe.top_k": 4,
                        "moe.n_shared_experts": 4, "moe.d_ff_expert": 1408,
                        "grad_accum": 2, "param_dtype": "bfloat16",
                        "optimizer_dtype": "float32"}}


def train_config(arch):
    """`arch`'s registered config, held to its published fields."""
    import operator
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    got = {k: operator.attrgetter(k)(cfg) for k in P15_PUBLISHED[arch]}
    assert got == P15_PUBLISHED[arch], (arch, got)
    return cfg


class StepLog:
    """The `on_step` of `launch.train.main`: per step the loss, gradient
    norm and the device-synchronised ms since the previous step's record
    (the first step's includes the launcher's set-up); with `keep_at` a
    device copy of the parameters after that many steps."""

    def __init__(self, keep_at=None):
        self.steps, self.keep_at, self.kept = {}, keep_at, None
        self.t = time.monotonic()

    def __call__(self, step, params, opt, metrics):
        torch.cuda.synchronize()
        self.steps[step] = {"loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "ms": (time.monotonic() - self.t) * 1e3}
        if self.keep_at == step + 1:
            from repro_torch.tree import tree_map
            self.kept = tree_map(torch.clone, params)
        self.t = time.monotonic()

    def step_ms(self) -> float:
        """Median ms of the steps after the run's first."""
        return float(np.median([r["ms"] for s, r in sorted(
            self.steps.items())[1:]]))


def timed_checkpoints(times: dict):
    """Record the device-synchronised seconds of every
    `CheckpointManager.save` / `restore` under times["save_s"] /
    ["restore_s"]. → the undo."""
    from repro_torch.checkpoint.store import CheckpointManager as M
    orig = M.save, M.restore

    def wrap(fn, key):
        def timed(*a, **k):
            t = time.monotonic()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(time.monotonic() - t)
            return out
        return timed
    M.save, M.restore = wrap(orig[0], "save_s"), wrap(orig[1], "restore_s")

    def undo():
        M.save, M.restore = orig
    return undo


def step_breakdown(cfg, dev, reps=3) -> dict:
    """Where a train step's time goes, on `cfg` at the launcher's batch 8 x
    seq 128: the loss and its gradients (forward, the remat recompute and
    backward) and the AdamW update, each as the host's enqueue ms and the
    ms to the device's end (the median of `reps` after a warm-up). Host ms
    close to the total means the host paces the part."""
    from repro_torch.models.lm import LM
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optim import adamw_init, adamw_update
    from repro_torch.training.trainer import loss_and_grads
    from repro_torch.tree import tree_unflatten
    lm = LM.build(cfg, device=dev)
    params = lm.init(0)
    opt = adamw_init(params, cfg.optimizer_dtype)
    batch = make_batch(cfg, DataConfig(cfg.vocab_size, 128, 8), 0,
                       device=dev)
    rec = {k: [] for k in ("grad_host_ms", "grad_ms", "update_host_ms",
                           "update_ms")}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, grads = loss_and_grads(lm, params, batch)
        t1 = time.monotonic()
        torch.cuda.synchronize()
        t2 = time.monotonic()
        adamw_update(tree_unflatten(params, grads), opt, params)
        t3 = time.monotonic()
        torch.cuda.synchronize()
        t4 = time.monotonic()
        for k, v in (("grad_host_ms", t1 - t0), ("grad_ms", t2 - t0),
                     ("update_host_ms", t3 - t2), ("update_ms", t4 - t2)):
            rec[k].append(v * 1e3)
        del grads
    out = {k: float(np.median(v[1:])) for k, v in rec.items()}
    del params, opt, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bit_equal_or_close(a: dict, b: dict, tol: dict, what: str) -> bool:
    """Steps' loss and gradient norm: True when bit-equal, else held to
    `tol` (relative) and False."""
    same = all(a[k] == b[k] for k in tol)
    if not same:
        for k, r in tol.items():
            assert abs(a[k] - b[k]) <= r * abs(b[k]), (what, k, a[k], b[k])
    return same


def train_qwen2(dev, log):
    """Phase 15 (a) and (b): the preemption drill through the launcher, the
    committed checkpoint restored bit for bit and served."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.kernels._common import count_delta, launch_counts
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.tree import tree_items, tree_leaves
    cfg = train_config("qwen2-1.5b")
    n_params = sum(p.numel() for p in tree_leaves(
        LM.build(cfg, device=dev).shapes()))
    state_bytes = n_params * (2 + 4 + 4)
    if P15_CKPT_DIR.exists():
        shutil.rmtree(P15_CKPT_DIR)
    P15_CKPT_DIR.mkdir()
    free = shutil.disk_usage(P15_CKPT_DIR).free
    assert free > 1.3 * state_bytes, \
        f"{free / 1e9:.1f} GB free for a {state_bytes / 1e9:.1f} GB checkpoint"
    argv = ["--arch", "qwen2-1.5b", "--steps", str(P15_STEPS), "--device",
            str(dev), "--log-every", "1"]
    ck = ["--ckpt-dir", str(P15_CKPT_DIR), "--ckpt-every", str(P15_EVERY)]
    times, out = {}, {"n_params": n_params, "disk_free_gb": free / 1e9}
    undo = timed_checkpoints(times)
    c0 = launch_counts()
    try:
        pre = StepLog(keep_at=P15_PREEMPT)
        torch.cuda.reset_peak_memory_stats()
        try:
            train.main(argv + ck + ["--preempt-at", str(P15_PREEMPT)],
                       on_step=pre)
            raise AssertionError("the preemption drill ran to its end")
        except SystemExit as e:
            assert e.code == 42, e.code
        gc.collect()
        out["peak_mem_gb_drill"] = torch.cuda.max_memory_allocated() / 1e9
        step_dir = P15_CKPT_DIR / f"step_{P15_PREEMPT:08d}"
        assert sorted(p.name for p in P15_CKPT_DIR.iterdir()) == \
            [step_dir.name]
        out["ckpt_bytes"] = sum(f.stat().st_size
                                for f in step_dir.iterdir())
        res = StepLog()
        last = train.main(argv + ck, on_step=res)
        gc.collect()
        torch.cuda.empty_cache()
        whole = StepLog()
        torch.cuda.reset_peak_memory_stats()
        last_whole = train.main(argv, on_step=whole)
        gc.collect()
        torch.cuda.empty_cache()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        undo()
    out["launches_during_training"] = count_delta(c0, launch_counts())
    assert not out["launches_during_training"], out
    assert sorted(pre.steps) == list(range(P15_PREEMPT))
    assert sorted(res.steps) == list(range(P15_PREEMPT, P15_STEPS))
    assert sorted(whole.steps) == list(range(P15_STEPS))
    assert last == res.steps[P15_STEPS - 1]["loss"]
    assert last_whole == whole.steps[P15_STEPS - 1]["loss"]
    out["drill_equal_uninterrupted"] = all(
        bit_equal_or_close(pre.steps[s], whole.steps[s], P15_RESUME_TOL,
                           f"drill step {s}") for s in pre.steps)
    out["resume_bit_equal"] = all(
        bit_equal_or_close(res.steps[s], whole.steps[s], P15_RESUME_TOL,
                           f"resumed step {s}") for s in res.steps)
    losses = [whole.steps[s]["loss"] for s in range(P15_STEPS)]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    out["losses"] = losses
    out["grad_norms"] = [whole.steps[s]["grad_norm"]
                         for s in range(P15_STEPS)]
    out["resumed"] = [res.steps[s] for s in sorted(res.steps)]
    out["step_ms"] = whole.step_ms()
    out["first_step_ms"] = whole.steps[0]["ms"]
    out["tokens_per_s"] = 8 * 128 / (out["step_ms"] / 1e3)
    out["save_s"], out["restore_s"] = times["save_s"], times["restore_s"]

    # (b) the committed step restored onto the card, bit for bit against
    # the parameters the drill saved, and served from both
    saved = pre.kept
    assert not any(p.requires_grad for p in tree_leaves(saved))
    t = time.monotonic()
    got, step, _ = load_checkpoint(
        P15_CKPT_DIR, template={"params": LM.build(cfg, device=dev).shapes()},
        device=dev)
    torch.cuda.synchronize()
    out["restore_params_s"] = time.monotonic() - t
    assert step == P15_PREEMPT
    restored = got["params"]
    for (k, a), b in zip(tree_items(restored), tree_leaves(saved)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    del got
    shutil.rmtree(P15_CKPT_DIR)
    prompts, base = workload(cfg.vocab_size)
    rng = np.random.default_rng(11)
    prompts += [base + tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          64))
                for _ in range(2)]
    params = [SamplingParams(max_tokens=4)] * 12 + [
        SamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=900 + i,
                       max_tokens=4) for i in (12, 13)]
    served = {}
    for name, w in (("restored", restored), ("in_memory", saved)):
        srv = build_server(cfg, True, dev, params=w)
        c = launch_counts()
        streams, finished, summ, wall = drive(srv, prompts, params)
        n = count_delta(c, launch_counts())
        assert len(finished) == len(prompts) and all(
            len(s) == 4 for s in streams), finished
        if dev.type == "cuda":
            assert n.get("paged_prefill.launches", 0) > 0 and \
                n.get("paged_decode.launches", 0) > 0, n
        served[name] = {"streams": streams, "launches": n, "wall_s": wall,
                        "ttft_mean": summ["ttft_mean"],
                        "tpot_mean_ms": summ["tpot_mean_ms"]}
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    assert served["restored"]["streams"] == served["in_memory"]["streams"], \
        "streams from the restored checkpoint differ from the in-memory ones"
    out["served"] = {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
                     for k, v in served.items()}
    del restored, saved, pre
    gc.collect()
    torch.cuda.empty_cache()
    out["breakdown"] = step_breakdown(cfg, dev)
    # the least time of a step: 6 FLOPs a parameter a token, plus the
    # forward recomputed under remat, at the dense bfloat16 rate
    out["bound_ms"] = 8 * n_params * 8 * 128 / PEAK_FLOPS[torch.bfloat16] \
        * 1e3
    log.append(f"qwen2-1.5b: {n_params / 1e9:.3f} B parameters; drill "
               f"exited 42 after step {P15_PREEMPT}; checkpoint "
               f"{out['ckpt_bytes'] / 1e9:.2f} GB saved in "
               f"{out['save_s'][0]:.2f} s, restored in "
               f"{out['restore_s'][0]:.2f} s ({out['disk_free_gb']:.0f} GB "
               f"free)")
    return out


def train_mamba2(dev, log):
    """Phase 15 (c): mamba2-130m as published through the launcher, and one
    step's loss with remat on against remat off."""
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optim import adamw_init
    from repro_torch.training.trainer import make_train_step
    from repro_torch.tree import tree_map
    cfg = train_config("mamba2-130m")
    B, S, steps = P15_MAMBA
    rec = StepLog()
    torch.cuda.reset_peak_memory_stats()
    train.main(["--arch", "mamba2-130m", "--batch", str(B), "--seq", str(S),
                "--steps", str(steps), "--device", str(dev), "--log-every",
                str(steps)], on_step=rec)
    out = {"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    losses = [rec.steps[s]["loss"] for s in range(steps)]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], \
        losses
    out.update(losses=losses, step_ms=rec.step_ms(),
               tokens_per_s=B * S / (rec.step_ms() / 1e3))
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM.build(cfg, device=dev)
    params = lm.init(0)
    batch = make_batch(cfg, DataConfig(cfg.vocab_size, S, B), 0, device=dev)
    one = {}
    for remat in (True, False):
        lm_r = LM.build(cfg.with_updates(remat=remat), device=dev)
        p = tree_map(torch.clone, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        _, _, m = make_train_step(lm_r)(p, adamw_init(p, cfg.optimizer_dtype),
                                        batch)
        torch.cuda.synchronize()
        one[remat] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "ms": (time.monotonic() - t) * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del p, m
    assert one[True]["loss"] == one[False]["loss"], one
    out["remat_grad_norm_bit_equal"] = bit_equal_or_close(
        one[True], one[False], {"grad_norm": P15_RESUME_TOL["grad_norm"]},
        "mamba2 remat")
    out["remat_on"], out["remat_off"] = one[True], one[False]
    del params, batch, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_moe(dev, log):
    """Phase 15 (d): qwen2-moe-a2.7b at its published widths and grad_accum
    2, cut in depth; router, expert and shared-expert gradients nonzero (a
    nonzero first moment after a step), no moe_gmm launch."""
    from repro_torch.models.lm import LM
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optim import adamw_init
    from repro_torch.training.trainer import make_train_step
    from repro_torch.tree import tree_leaves
    full = train_config("qwen2-moe-a2.7b")
    cfg = full.with_updates(n_layers=P15_MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    lm = LM.build(cfg, device=dev)
    params = lm.init(0)
    opt = adamw_init(params, cfg.optimizer_dtype)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tables = lm.default_tables()
    step = make_train_step(lm)
    dcfg = DataConfig(cfg.vocab_size, 128, 8)
    recs = []
    for s in range(P15_MOE_STEPS):
        batch = make_batch(cfg, dcfg, s, device=dev)
        torch.cuda.synchronize()
        t = time.monotonic()
        params, opt, met = step(params, opt, batch, tables)
        torch.cuda.synchronize()
        recs.append({"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "ms": (time.monotonic() - t) * 1e3})
    assert all(math.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in recs), recs
    for i, layer in enumerate(opt["m"]["layers"]):
        for k in ("router", "moe_w1", "moe_w3", "moe_w2", "shared_w1",
                  "shared_w2"):
            assert float(layer[k].abs().max()) > 0, (i, k)
    out = {"n_layers": P15_MOE_LAYERS, "n_layers_published": full.n_layers,
           "n_params": n_params, "steps": recs,
           "step_ms": float(np.median([r["ms"] for r in recs[1:]])),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["tokens_per_s"] = 8 * 128 / (out["step_ms"] / 1e3)
    del params, opt, lm, tables
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(dev, log):
    """Phase 15 (e): one float32 train step of reduced qwen2-1.5b on the
    card and on the CPU from the same parameters and batch."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import LM
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optim import adamw_init
    from repro_torch.training.trainer import make_train_step
    from repro_torch.tree import tree_map
    cfg = reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", remat=True)
    base = LM.build(cfg, device="cpu").init(0)
    got = {}
    for d in ("cpu", dev):
        lm = LM.build(cfg, device=d)
        p = tree_map(lambda t: t.to(d, copy=True), base)
        batch = make_batch(cfg, DataConfig(cfg.vocab_size, 128, 8), 0,
                           device=d)
        _, _, met = make_train_step(lm)(p, adamw_init(p), batch)
        got[torch.device(d).type] = {"loss": float(met["loss"]),
                                     "grad_norm": float(met["grad_norm"])}
    for k, r in P15_CPU_TOL.items():
        assert abs(got["cuda"][k] - got["cpu"][k]) <= r * abs(got["cpu"][k]), \
            (k, got)
    return {"card": got["cuda"], "cpu": got["cpu"],
            "rel_diff": {k: abs(got["cuda"][k] - got["cpu"][k])
                         / abs(got["cpu"][k]) for k in P15_CPU_TOL}}


def train_phase(dev, log):
    """Phase 15: (a)-(e); no kernel launches during any train step."""
    from repro_torch.kernels._common import count_delta, launch_counts
    out = {"qwen2": train_qwen2(dev, log)}
    c0 = launch_counts()
    out["mamba2"] = train_mamba2(dev, log)
    out["moe"] = train_moe(dev, log)
    out["card_vs_cpu"] = train_card_vs_cpu(dev, log)
    out["launches_during_training_cde"] = count_delta(c0, launch_counts())
    assert not out["launches_during_training_cde"], out
    return out


# ---- phase 16: the frontend families at full width -----------------------
# (a) phi-3-vision-4.2b as published (32 layers, float32, seed-0 weights,
# every layer full attention, as the reference's tests/test_consistency.py
# runs it): two prompts of 256 patch embeddings + 768 tokens (1,024 rows),
# each prefilled alone (the whole-prompt prefill of one prompt), then both
# decoded together (B 2) for 16 greedy steps from position 1,024
P16_TOKENS, P16_NEW = 768, 16
# (b) hubert-xlarge as published (48 layers, float32): two clips of 1,024
# frames (~20 s of audio at 50 frames/s) in one batch through the encoder
P16_CLIPS, P16_FRAMES = 2, 1024
# (d) launch/train.py on hubert-xlarge, bfloat16 as registered: batch,
# frames, steps
P16_TRAIN = (2, 512, 2)
# float32 logits: prefill-then-decode against the longer prefill (the
# reference's test_consistency tolerance), the kernel forward against the
# plain forward on the card, and the card against the CPU (phase 4's)
P16_LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
# the published fields phase 16 holds each architecture to
P16_PUBLISHED = {
    "phi-3-vision-4.2b": dict(n_layers=32, d_model=3072, n_heads=32,
                              n_kv_heads=32, head_dim=96, d_ff=8192,
                              num_patches=256, frontend_dim=1024,
                              vocab_size=32064, causal=True),
    "hubert-xlarge": dict(n_layers=48, d_model=1280, n_heads=16,
                          n_kv_heads=16, head_dim=80, d_ff=5120,
                          frontend_dim=512, vocab_size=504, causal=False,
                          encoder_only=True)}


def zero_launch_counts():
    from repro_torch.kernels._common import add_launch_counts, launch_counts
    add_launch_counts(launch_counts(), -1)


def moved_counts() -> dict:
    from repro_torch.kernels._common import launch_counts
    return {k: v for k, v in launch_counts().items() if v}


def frontend_config(arch):
    """`arch` as published (held to P16_PUBLISHED), in float32."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    got = {k: getattr(cfg, k) for k in P16_PUBLISHED[arch]}
    assert got == P16_PUBLISHED[arch], (arch, got)
    return cfg.with_updates(compute_dtype="float32", param_dtype="float32")


def params_gb(params) -> float:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9


def run_vlm(dev, log):
    """Phase 16 (a): phi-3-vision-4.2b's whole-prompt prefills and a B 2
    greedy decode over their dense caches; prefill-then-decode against the
    longer prefill; zero patches change the logits."""
    from repro_torch.models.lm import LM
    cfg = frontend_config("phi-3-vision-4.2b")
    L, P = cfg.n_layers, cfg.num_patches
    S = P + P16_TOKENS
    max_len = S + P16_NEW
    torch.cuda.reset_peak_memory_stats()
    lm = LM.build(cfg, pattern=[0] * L, device=dev)
    params = lm.init(0)
    out = {"weights_gb": params_gb(params), "prefill_ms": [], "rows": S}
    g = torch.Generator(device=dev).manual_seed(16)
    patches = torch.randn((2, P, cfg.frontend_dim), generator=g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, P16_TOKENS), generator=g,
                         device=dev)
    caches, last = [], []
    for i in range(2):
        zero_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        c, lg, _ = lm.prefill(params, toks[i:i + 1],
                              patches=patches[i:i + 1], max_len=max_len)
        torch.cuda.synchronize()
        out["prefill_ms"].append((time.monotonic() - t) * 1e3)
        n = moved_counts()
        assert n == {"flash_prefill.launches": L}, n
        assert c["pos"] == S and torch.isfinite(lg).all()
        caches.append(c)
        last.append(lg)
    out["prefill_launches"] = L
    cache = {"layers": [{n: torch.cat([a[n], b[n]]) for n in ("k", "v")}
                        for a, b in zip(caches[0]["layers"],
                                        caches[1]["layers"])], "pos": S}
    del caches
    tok = torch.cat(last).argmax(-1, keepdim=True)
    first_tok, steps, stream = tok.clone(), [], [tok]
    for j in range(P16_NEW):
        pos = torch.full((2, 1), S + j, dtype=torch.long, device=dev)
        zero_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        cache, lg, _ = lm.decode(params, cache, tok, pos)
        torch.cuda.synchronize()
        steps.append((time.monotonic() - t) * 1e3)
        n = moved_counts()
        assert n == {"sink_decode.launches": L}, n
        assert torch.isfinite(lg).all()
        if j == 0:
            first = lg[0].clone()
        tok = lg.argmax(-1, keepdim=True)
        stream.append(tok)
    out.update(decode_ms=steps, decode_ms_median=float(np.median(steps[1:])),
               decode_launches_per_step=L,
               streams=torch.cat(stream, 1).cpu().tolist())
    del cache
    # the first step's logits against one prefill of the patches, the 768
    # tokens and the first greedy token
    _, longer, _ = lm.prefill(params, torch.cat([toks[:1], first_tok[:1]], 1),
                              patches=patches[:1], max_len=max_len)
    torch.testing.assert_close(first, longer[0], **P16_LOGIT_TOL,
                               msg="phi-3-vision: prefill-then-decode "
                                   "against the longer prefill")
    out["decode_vs_longer_prefill"] = float((first - longer[0]).abs().max())
    _, zero, _ = lm.prefill(params, toks[:1], patches=torch.zeros_like(
        patches[:1]), max_len=max_len)
    out["zero_patches_logit_change"] = float((zero - last[0]).abs().max())
    assert out["zero_patches_logit_change"] > 1e-3, out
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log.append(f"(a) phi-3-vision-4.2b: {out['weights_gb']:.2f} GB of "
               f"float32 weights; prefill-then-decode against the longer "
               f"prefill max |diff| {out['decode_vs_longer_prefill']:.3g} "
               f"(tolerance 2e-3); zero patches move the logits by "
               f"{out['zero_patches_logit_change']:.3g}")
    del params, lm, longer, zero, last, first
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_audio(dev, log):
    """Phase 16 (b): hubert-xlarge's encoder pass over two clips in one
    batch → per-frame logits; the kernel forward against the same forward
    through flash_prefill_plain on the card."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.models.lm import LM
    cfg = frontend_config("hubert-xlarge")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    lm = LM.build(cfg, device=dev)
    params = lm.init(0)
    out = {"weights_gb": params_gb(params), "ms": []}
    g = torch.Generator(device=dev).manual_seed(17)
    frames = torch.randn((P16_CLIPS, P16_FRAMES, cfg.frontend_dim),
                         generator=g, device=dev)
    for _ in range(2):
        zero_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        cache, logits, _ = lm.prefill(params, frames=frames)
        torch.cuda.synchronize()
        out["ms"].append((time.monotonic() - t) * 1e3)
        n = moved_counts()
        assert n == {"flash_prefill.launches": L}, n
    assert cache is None and logits.shape == (P16_CLIPS, P16_FRAMES,
                                              cfg.vocab_size)
    assert torch.isfinite(logits).all()
    out["launches"] = L
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    kernel_fn = kops.flash_prefill
    kops.flash_prefill = flash_prefill_plain
    try:
        zero_launch_counts()
        _, plain, _ = lm.prefill(params, frames=frames)
        assert not moved_counts()
    finally:
        kops.flash_prefill = kernel_fn
    torch.testing.assert_close(logits, plain, **P16_LOGIT_TOL,
                               msg="hubert: kernel forward against plain")
    out["kernel_vs_plain"] = float((logits - plain).abs().max())
    log.append(f"(b) hubert-xlarge: {out['weights_gb']:.2f} GB of float32 "
               f"weights; per-frame logits {list(logits.shape)}; the kernel "
               f"forward against the flash_prefill_plain forward on the "
               f"card max |diff| {out['kernel_vs_plain']:.3g} (tolerance "
               f"2e-3)")
    del params, lm, logits, plain, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frontend_card_vs_cpu(dev, log):
    """Phase 16 (c): the reduced configs with their real head dims (hubert
    80, phi-3-vision 96) on the same seeded weights, the card's kernels
    against the plain versions on the CPU: the vlm's prefill and one decode
    step, hubert's per-frame logits (2e-3), one float32 train step's loss
    and gradient norm of each (phase 15's 1e-5 / 1e-4 relative, no kernel
    launched)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import LM
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optim import adamw_init
    from repro_torch.training.trainer import make_train_step
    from repro_torch.tree import tree_map
    out = {}
    for arch, hd in (("phi-3-vision-4.2b", 96), ("hubert-xlarge", 80)):
        cfg = reduced_config(arch).with_updates(
            compute_dtype="float32", param_dtype="float32", head_dim=hd)
        pattern = [0] * cfg.n_layers
        base = LM.build(cfg, pattern=pattern, device="cpu").init(seed=9)
        rng = np.random.default_rng(hd)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 40)))
        pat = torch.from_numpy(rng.standard_normal(
            (1, cfg.num_patches, cfg.frontend_dim)).astype(np.float32))
        frames = torch.from_numpy(rng.standard_normal(
            (2, 64, cfg.frontend_dim)).astype(np.float32))
        got = []
        for d in ("cpu", dev):
            lm = LM.build(cfg, pattern=pattern, device=d)
            p = tree_map(lambda t: t.to(d, copy=True), base)
            zero_launch_counts()
            if cfg.family == "vlm":
                S = cfg.num_patches + toks.shape[1]
                cache, l1, _ = lm.prefill(p, toks.to(d), patches=pat.to(d),
                                          max_len=S + 4)
                _, l2, _ = lm.decode(p, cache, toks[:, :1].to(d),
                                     torch.full((1, 1), S, device=d))
                logits = (l1, l2)
                want = {"flash_prefill.launches": cfg.n_layers,
                        "sink_decode.launches": cfg.n_layers}
            else:
                _, l1, _ = lm.prefill(p, frames=frames.to(d))
                logits = (l1,)
                want = {"flash_prefill.launches": cfg.n_layers}
            n = moved_counts()
            assert n == (want if torch.device(d).type == "cuda" else {}), \
                (arch, d, n)
            batch = make_batch(cfg, DataConfig(cfg.vocab_size, 64, 2), 0,
                               device=d)
            zero_launch_counts()
            _, _, met = make_train_step(lm)(p, adamw_init(p), batch)
            assert not moved_counts()
            got.append({"logits": [x.float().cpu() for x in logits],
                        "loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"])})
        c, g_ = got
        err = 0.0
        for a, b in zip(c["logits"], g_["logits"]):
            torch.testing.assert_close(b, a, **P16_LOGIT_TOL,
                                       msg=f"{arch} h {hd}: card vs CPU")
            err = max(err, float((a - b).abs().max()))
        rel = {k: abs(g_[k] - c[k]) / abs(c[k]) for k in P15_CPU_TOL}
        for k, r in P15_CPU_TOL.items():
            assert rel[k] <= r, (arch, k, c, g_)
        out[arch] = {"head_dim": hd, "logits_max_abs_err": err,
                     "rel_diff": rel, "card": {k: g_[k] for k in rel},
                     "cpu": {k: c[k] for k in rel}}
        log.append(f"(c) reduced {arch} at h {hd}: logits card vs CPU max "
                   f"|diff| {err:.3g} (2e-3); a train step's loss / gradient "
                   f"norm relative {rel['loss']:.2e} / "
                   f"{rel['grad_norm']:.2e}, no kernel launched")
    return out


def train_audio(dev, log):
    """Phase 16 (d): launch/train.py on hubert-xlarge as published
    (bfloat16), batch 2 x 512 frames, 2 steps; no kernel launched."""
    from repro_torch.launch import train
    B, S, steps = P16_TRAIN
    rec = StepLog()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    train.main(["--arch", "hubert-xlarge", "--batch", str(B), "--seq",
                str(S), "--steps", str(steps), "--device", str(dev),
                "--log-every", "1"], on_step=rec)
    out = {"launches": moved_counts(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": [rec.steps[s]["loss"] for s in range(steps)],
           "first_step_ms": rec.steps[0]["ms"], "step_ms": rec.step_ms()}
    assert not out["launches"], out
    assert all(math.isfinite(x) for x in out["losses"]), out
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frontend_phase(dev, log):
    """Phase 16: (a)-(d)."""
    out = {"vlm": run_vlm(dev, log), "audio": run_audio(dev, log)}
    out["card_vs_cpu"] = frontend_card_vs_cpu(dev, log)
    out["train_audio"] = train_audio(dev, log)
    return out


# ---- phase 10: captured against eager ------------------------------
def random_arena(lm, n_blocks, bs, dev, quant, g):
    """Arenas of `n_blocks` blocks filled with seeded random K/V (int8
    pages with random per-token scales where `quant`), summaries
    computed."""
    from repro_torch.models.attention import update_block_summaries
    from repro_torch.models.stack import alloc_arena_kv
    layers = alloc_arena_kv(lm.cfg, lm.plan, n_blocks, bs, dev, quant=quant)
    every = torch.arange(n_blocks, device=dev)
    for e in layers:
        if e is None:
            continue
        for n in ("k", "v"):
            if quant:
                e[n].copy_(torch.randint(-127, 128, e[n].shape, generator=g,
                                         device=dev, dtype=torch.int8))
                e[n + "tok"].copy_(torch.rand(e[n + "tok"].shape,
                                              generator=g, device=dev) / 64)
            else:
                e[n].copy_(torch.randn(e[n].shape, generator=g, device=dev))
        update_block_summaries(e["kmin"], e["kmax"], e["kmean"], e["k"],
                               every, k_scale=e.get("kscale"),
                               k_tok=e.get("ktok"))
    return layers


def capture_logits_diff(srv, dev, verify=False):
    """Largest |difference| between the logits of one step of `srv`'s model
    (one decode step, or one verify window of k + 1 = 5 rows) replayed from
    a captured graph and run eagerly, on the same inputs: six slots over
    16-entry tables of seeded random K/V (int8 pages with their scale plane
    where `srv`'s arenas are int8), each at a mid-block position, so the
    step's own K/V write opens and seals no block and lands the same bytes
    every time."""
    from repro_torch.serving import DevicePlacement
    lm, B, nb, bs = srv.lm, 6, 16, 16
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    layers = random_arena(lm, B * nb + 1, bs, dev, srv.kv_arena.quant, g)
    cache = {"layers": layers, "pos": 0}
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32,
                          device=dev).reshape(B, nb)
    pos = torch.tensor([200, 37, 101, 250, 5, 133], dtype=torch.int32,
                       device=dev)           # offsets in block: 8, 5 or 10
    S = P7_K + 1 if verify else 1
    toks = torch.randint(0, lm.cfg.vocab_size, (B, S), generator=g,
                         device=dev, dtype=torch.int32)
    out = torch.empty((B, S, lm.cfg.vocab_size) if verify else
                      (B, lm.cfg.vocab_size), dtype=torch.float32,
                      device=dev)

    def step(key, out):
        if verify:
            logits = lm.verify(srv.params, cache, toks, pos,
                               block_tables=tables)[0]
        else:
            logits = lm.decode(srv.params, cache, toks, pos[:, None],
                               block_tables=tables, tables=srv.tables)[1]
        return out.copy_(logits)

    entry = DevicePlacement.of(dev).hot_loop(step, name="check.logits")
    eager = entry((nb, True), (out,)).clone()
    entry((nb, True), (out,))                 # capture, then one replay
    torch.cuda.synchronize()
    assert dev.type != "cuda" or entry.replays[(nb, True)] == 1
    return float((out - eager).abs().max())


def draw_cost(srv, dev, timer) -> dict:
    """Device ms of one captured decode step of `srv`'s model followed by
    the fused draw (`sample_tokens`) over its [6, V] logits, replayed from
    its graph: six slots over 16-entry tables of seeded random K/V at
    mid-block positions (as `capture_logits_diff`), all greedy (the draw
    skipped: argmax) against one slot sampled (temperature 0.9, top-k 64,
    top-p 0.95: the sort, softmax and cumulative sum of the filter and the
    threefry Gumbel noise); and the draw alone over the same logits, both
    ways. The difference is what a step with a sampled slot pays."""
    from repro_torch.serving import DevicePlacement
    from repro_torch.serving.sampling import sample_tokens
    lm, B, nb, bs = srv.lm, 6, 16, 16
    V = lm.cfg.vocab_size
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    layers = random_arena(lm, B * nb + 1, bs, dev, srv.kv_arena.quant, g)
    cache = {"layers": layers, "pos": 0}
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32,
                          device=dev).reshape(B, nb)
    pos = torch.tensor([200, 37, 101, 250, 5, 133], dtype=torch.int32,
                       device=dev)
    toks = torch.randint(0, V, (B, 1), generator=g, device=dev,
                         dtype=torch.int32)
    temp = torch.tensor([0.9] + [0.0] * (B - 1), device=dev)
    top_k = torch.tensor([64] + [0] * (B - 1), dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([0.95] + [1.0] * (B - 1), device=dev)
    keys = torch.stack([torch.arange(B, device=dev),
                        torch.arange(B, device=dev) + 900], dim=1)
    logits = torch.empty((B, V), dtype=torch.float32, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)

    def step(key, out):
        lg = lm.decode(srv.params, cache, toks, pos[:, None],
                       block_tables=tables, tables=srv.tables)[1]
        logits.copy_(lg)
        return out.copy_(sample_tokens(lg, temp, top_k, top_p, keys,
                                       pos + 1, all_greedy=key[1]))

    def draw(key, out):
        return out.copy_(sample_tokens(logits, temp, top_k, top_p, keys,
                                       pos + 1, all_greedy=key[1]))

    res = {}
    for name, fn in (("step", step), ("draw", draw)):
        entry = DevicePlacement.of(dev).hot_loop(fn, name=f"check.{name}")
        for greedy in (True, False):
            key = (nb, greedy)
            entry(key, (out,))
            entry(key, (out,))              # capture, then one replay
            res[f"{name}_ms_{'greedy' if greedy else 'sampled'}"] = \
                timer(lambda: entry(key, (out,)))
            assert dev.type != "cuda" or entry.replays[key] > 1
    res["draw_cost_ms"] = res["step_ms_sampled"] - res["step_ms_greedy"]
    return res


def chunk_logits_diff(srv, dev):
    """Largest |difference| between the logits of one prefill chunk of
    `srv`'s model replayed from a captured graph and run eagerly on the
    same inputs: 100 real rows of a 128-row chunk at offset 192 over a
    24-entry table of seeded random history (int8 with its scale plane
    where `srv`'s arenas are int8), the offset and length read from the
    device. The chunk starts on a block boundary, so its writes never
    touch the history it reads and land the same bytes every call."""
    from repro_torch.serving import DevicePlacement
    lm, nb, bs, S = srv.lm, 24, 16, 128
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    cache = {"layers": random_arena(lm, nb + 1, bs, dev, srv.kv_arena.quant,
                                    g),
             "pos": torch.tensor(192, dtype=torch.int32, device=dev)}
    tables = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
    cl = torch.tensor(100, dtype=torch.int32, device=dev)
    toks = torch.randint(0, lm.cfg.vocab_size, (1, S), generator=g,
                         device=dev, dtype=torch.int32)
    out = torch.empty((1, lm.cfg.vocab_size), dtype=torch.float32,
                      device=dev)

    def chunk(key, out):
        logits = lm.prefill_resume(srv.params, toks, cache, chunk_len=cl,
                                   block_tables=tables,
                                   tables=srv.tables)[1]
        return out.copy_(logits)

    entry = DevicePlacement.of(dev).hot_loop(chunk, name="check.chunk")
    eager = entry((S, "paged"), (out,)).clone()
    entry((S, "paged"), (out,))               # capture, then one replay
    torch.cuda.synchronize()
    assert dev.type != "cuda" or entry.replays[(S, "paged")] == 1
    return float((out - eager).abs().max())


def op_counter():
    """A TorchDispatchMode counting the aten ops dispatched inside it (a
    graph replay dispatches none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    return Count()


def count_chunk_ops(srv, prompts, params) -> dict:
    """aten ops each prefill chunk of `srv`'s first prefill engine
    dispatches from Python while it serves (prompts, params), counted
    around `PrefillEngine._run_chunk` (the upload, the private-leaf copies,
    the logits clone and anything the chunk runs eagerly) → {"chunks",
    "mean", "min", "max"}. Serve prompts the store has not seen, on keys
    the server has met (a capture inside would be counted)."""
    eng = srv.prefills[0]
    run, per = eng._run_chunk, []

    def counted(task, budget):
        mode = op_counter()
        with mode:
            ran = run(task, budget)
        if ran:
            per.append(mode.n)
        return ran
    eng._run_chunk = counted
    try:
        list(srv.generate(prompts, params))
        torch.cuda.synchronize()
    finally:
        del eng._run_chunk
    return {"chunks": len(per), "mean": sum(per) / max(len(per), 1),
            "min": min(per, default=0), "max": max(per, default=0)}


def serve_eager(dev, log, cfg, served, spec, quant):
    """Phase 10: phase 3 (prefix reuse on), phase 7 (speculation on) and
    phase 9 (a) served again with `capture=False` on the same seed-0
    weights and traffic. Greedy streams must equal the captured runs' bit
    for bit; the launch counts obey the same formulas; the largest logits
    difference of one captured step against eager is reported, and TPOT
    and host seconds per decode round both ways."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_prefill import paged_prefill
    from repro_torch.kernels.spec_verify import spec_verify
    from repro_torch.serving import DevicePlacement
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    n_layers = cfg.n_layers
    cases = []
    prompts, base = workload(cfg.vocab_size)
    rng = np.random.default_rng(11)
    prompts += [base + tuple(int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          64))
                for _ in range(2)]
    p3 = [SamplingParams(max_tokens=4)] * 12 + [
        SamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=900 + i,
                       max_tokens=4) for i in (12, 13)]
    warm3 = (workload(cfg.vocab_size, seed=8)[0], SamplingParams(
        max_tokens=4))
    cases.append(("phase3_all_full", {}, prompts, p3, warm3, 12, served,
                  False))
    sp_prompts, sp_params = spec_workload(cfg.vocab_size)
    sp_warm = (spec_workload(cfg.vocab_size, seed=42)[0][:2],
               SamplingParams(max_tokens=8))
    cases.append(("phase7_spec_on", {"spec": SpecConfig(k=P7_K)},
                  sp_prompts, sp_params, sp_warm, 6,
                  spec["runs"]["spec_on"], True))
    q_prompts, q_params = quant_workload(cfg.vocab_size)
    cases.append(("phase9a_int8", {"quant": QuantConfig()}, q_prompts,
                  q_params, warm3, 12, quant, False))
    out, weights = {}, None
    for name, knobs, prompts, params, warm, n_greedy, cap, verify in cases:
        srv = build_server(cfg, True, dev, params=weights,
                           placement=DevicePlacement.of(dev, capture=False),
                           **knobs)
        weights = srv.params
        list(srv.generate(warm[0], warm[1]))
        reset_stats(srv)
        hl0 = hot_loops(srv)
        for k in (paged_prefill, paged_decode, spec_verify):
            k.launches = k.int8_launches = 0
        streams, finished, summ, wall = drive(srv, prompts, params)
        ps, ds = srv.prefills[0].stats, srv.decodes[0].stats
        hl = check_hot_loops(srv, hl0, dev)
        assert all(v["captures"] == v["replays"] == 0
                   for n, v in hl.items() if n != "pool_gb"), hl
        assert len(finished) == len(prompts), finished
        assert ds["host_fetches"] == ds["steps"] > 0, ds
        verifies = ds.get("spec_verifies", 0)
        if dev.type == "cuda":          # the counts move only on the card
            assert paged_prefill.launches == ps["chunks"] * n_layers > 0
            assert paged_decode.launches == \
                (ds["steps"] - verifies) * n_layers
            assert spec_verify.launches == verifies * n_layers
            if "quant" in knobs:
                assert paged_decode.int8_launches == paged_decode.launches
        assert streams[:n_greedy] == cap["streams"][:n_greedy], \
            f"{name}: greedy streams differ between capture and eager"
        diff = capture_logits_diff(srv, dev, verify=verify)
        # the prefill chunk both ways: host ms per chunk over a measured
        # run, aten ops per chunk over fresh prompts shaped like the
        # warm-up's (no key met for the first time), and one chunk's
        # logits replayed against eager; the captured side on a new
        # server with this one's weights, knobs and warm-up
        fresh = ((spec_workload(cfg.vocab_size, seed=43)[0][:2] if verify
                  else workload(cfg.vocab_size, seed=13)[0]),
                 SamplingParams(max_tokens=2))
        chunk = {"logits_max_abs_diff": chunk_logits_diff(srv, dev),
                 "eager": {"host_ms_per_chunk": ps["busy_s"] * 1e3
                           / ps["chunks"], "chunks": ps["chunks"],
                           "aten_ops": count_chunk_ops(srv, *fresh)}}
        c_srv = build_server(cfg, True, dev, params=weights, **knobs)
        list(c_srv.generate(warm[0], warm[1]))
        reset_stats(c_srv)
        c_streams, _, _, _ = drive(c_srv, prompts, params)
        assert c_streams[:n_greedy] == streams[:n_greedy]
        cps = c_srv.prefills[0].stats
        chunk["captured"] = {"host_ms_per_chunk": cps["busy_s"] * 1e3
                             / cps["chunks"], "chunks": cps["chunks"],
                             "aten_ops": count_chunk_ops(c_srv, *fresh)}
        hl_c = hot_loops(c_srv)["prefill.chunk"]
        assert dev.type != "cuda" or hl_c["replays"] > 0, hl_c
        del c_srv
        cm = cap["metrics"] if "metrics" in cap else cap["reuse_on"]
        out[name] = {
            "greedy_streams_equal": True,
            "sampled_streams_equal": streams[n_greedy:]
            == cap["streams"][n_greedy:],
            "logits_max_abs_diff": diff,
            "captured": {"tpot_mean_ms": cm["tpot_mean_ms"],
                         "host_s_per_round": cap["host_s_per_round"],
                         "steps": cap["decode_steps"]},
            "eager": {"tpot_mean_ms": summ["tpot_mean_ms"],
                      "host_s_per_round": ds["busy_s"] / ds["steps"],
                      "steps": ds["steps"], "wall_s": wall},
            "chunk": chunk, "hot_loops": hl}
        log.append(f"{name}: served eagerly in {wall:.2f} s; "
                   f"{n_greedy} greedy streams equal the captured run's")
        del srv
        torch.cuda.empty_cache()
    return out


# ---- phase 17: qwen2-moe-a2.7b over (tp 2, ep 2) ranks ------------------
P17_TP, P17_EP = 2, 2
P17_LAYERS = 8          # of 24: one whole model and the four shards fit
P17_DTYPE = "float32"
P17_NEW = 16
P17_SEED = 0
P17_TIMEOUT_S = 240     # a collective waits this long before it fails
P17_WORLD_S = 600       # the world joins within this, or is killed
# (d)-(f): QuantPlane and SpecPlane over the ranks, run → (int8 arenas,
# speculation at k P7_K, the launches rank 0 must make)
P17_PLANES = {
    "d_quant": (True, False, ("paged_decode_int8", "paged_prefill_int8",
                              "moe_gmm")),
    "e_spec": (False, True, ("spec_verify", "moe_gmm")),
    "f_quant_spec": (True, True, ("spec_verify_int8", "paged_decode_int8",
                                  "paged_prefill_int8", "moe_gmm"))}
# the capacity factor of the speculating runs (e), (f), on both sides: one
# rank routes a verify window's 20 rows in one cut, a rank its 10 at a
# capacity reckoned from those 10, so at the serving factor the two drop
# different assignments (ROADMAP C5) and their streams may part; at 16 (>=
# E / top_k = 15) every bucket holds every row and nothing drops
P17_SPEC_CF = 16.0
# the speculating runs' greedy requests, of spec_workload's six
P17_SPEC_GREEDY = 4
# the warm-up before each of phase 17's runs, on the ranks and on one rank
# (warm_and_drive): one run of two prompts, as phases 18 and 19 warm (over
# gloo nothing is captured); a speculating run's two sides warm alike,
# since the warm-up's finished requests feed the suffix table and the
# radix tree that the drafts read
P17_WARM = dict(warm_prompts=2, warm_runs=1)
# the largest one-rank top-2 logit margin at which an int8 stream over the
# ranks may leave the one-rank Server's: an int8 rounding boundary crossed
# by a sum taken in another order (a rank's GEMMs over its heads)
P17_INT8_TIE = 1e-2
# (g): FaultPlane over the ranks on phase 12's two-prefill, two-decode
# server at P17_SPEC_CF (a restart changes which rows share a capacity cut:
# at a factor where nothing drops it cannot move a drop, C5), fault-free,
# then this seed with phase 12's horizon (half the fault-free server steps)
P17_CHAOS_SEED = 1
# (g)'s traffic, cut for the script's time limit (each gloo round of a
# two-prefill, two-decode server runs a prefill round and two decode
# steps): prompts of one chunk, P17_CHAOS_NEW new tokens each
P17_CHAOS_PROMPTS, P17_CHAOS_NEW = 8, 8


def dist_config():
    """qwen2-moe-a2.7b at full width (moe_full_config's checks) in
    float32, its first P17_LAYERS layers."""
    return moe_full_config().with_updates(n_layers=P17_LAYERS,
                                          param_dtype=P17_DTYPE,
                                          compute_dtype=P17_DTYPE)


def dist_server(cfg, chunked, dev=None, params=None, placement=None,
                quant=False, spec=False, chaos=False):
    """Phase 17's server: 4 slots, 512-token context, 128-token chunks,
    every attention layer full, the placement monitor off (phase 17 forces
    its migration); `quant` int8 arenas, `spec` SpecConfig(k=P7_K),
    `chaos` phase 12's two prefill and two decode instances, watchdog and
    ten retries."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    n_inst = 2 if chaos else 1
    scfg = ServerConfig(n_prefill=n_inst, n_decode=n_inst, decode_slots=4,
                        max_len=512, chunk_tokens=128,
                        prefill_tick_budget=512, kv_block_size=16,
                        chunked_prefill=chunked, enable_placement=False,
                        oas=OASConfig(defer_window=0.0, max_retries=10)
                        if chaos else OASConfig(defer_window=0.0),
                        watchdog_steps=200 if chaos else None,
                        quant=QuantConfig() if quant else None,
                        spec=SpecConfig(k=P7_K) if spec else None)
    return Server(cfg, scfg, pattern=[0] * cfg.n_layers, params=params,
                  seed=P17_SEED, device=dev, placement=placement)


def dist_workload(vocab):
    """Eight prompts of phase 3's mix (five on a 384-token prefix + 64, three
    of 16 tokens), P17_NEW greedy tokens each."""
    from repro_torch.core.proxy import SamplingParams
    prompts, _ = workload(vocab, n=8, seed=17)
    return prompts, SamplingParams(max_tokens=P17_NEW)


def warm_and_drive(srv, prompts, sp, warm_prompts=4, warm_runs=2):
    """Warm the server on other tokens (`warm_runs` runs of `warm_prompts`
    448- and 16-token prompts: every chunk bucket and the decode batch; a
    speculating server on phase 7's warm-up prompts, which draft; the
    first call of each hot-loop key is eager, the second captures), reset
    its stats, the launch counters and the capacity cut's drop tally, then
    drive the main path → (streams, metrics, launches, decode round ms,
    hot loops, the decode engine's speculation and quant stats, the
    assignments the capacity dropped)."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.models import moe as moe_mod
    eng = srv.decodes[0]
    if eng.spec_ctl is None:
        warm = workload(srv.cfg.vocab_size, n=6, seed=8)[0]
        wsp = SamplingParams(max_tokens=3)
    else:
        warm = spec_workload(srv.cfg.vocab_size, seed=42)[0][:2]
        wsp = SamplingParams(max_tokens=8)
    warm = warm[:warm_prompts]
    for _ in range(warm_runs):
        list(srv.generate(warm, wsp))
    reset_stats(srv)
    before = hot_loops(srv)
    zero_launch_counts()
    drops = moe_mod.drop_tally(srv.placement.device)
    drops.zero_()
    streams, finished, m, wall = drive(srv, prompts, sp)
    launches = {k.split(".")[0] + ("_int8" if "int8" in k else ""): v
                for k, v in moved_counts().items()}
    assert all(f == "length" for f in finished), finished
    entries = CHUNKED_ENTRIES if srv.prefills[0].chunked else WHOLE_ENTRIES
    if eng.spec_ctl is not None:
        entries = entries + ("decode.verify",)
    ds = eng.stats
    assert ds["host_fetches"] == ds["steps"] > 0, ds
    return {"streams": streams, "metrics": m, "wall_s": wall,
            "launches": launches,
            "decode_round_ms": 1e3 * ds["busy_s"] / max(ds["steps"], 1),
            "steps": ds["steps"],
            "hot_loops": check_hot_loops(srv, before, srv.placement.device,
                                         entries),
            "decode_stats": {k: ds[k] for k in (
                "spec_drafted", "spec_accepted", "spec_emitted",
                "spec_verifies", "quant_layers", "quant_block_bytes",
                "quant_block_bytes_f32") if k in ds},
            "drops": float(drops)}


def swapped_slots_plan(srv):
    """A forced migration between the two EP ranks: the first two slots of
    rank 0 and rank 1 trade experts."""
    from types import SimpleNamespace
    old = srv.tables["slot_expert"].cpu().numpy()
    new = old.copy()
    new[0, :2], new[1, :2] = old[1, :2], old[0, :2]
    return SimpleNamespace(new_slot_expert=new)


def timed_collective(fn, dev, reps=20) -> float:
    """Wall ms of one collective, every rank entering together."""
    import torch.distributed as dist
    fn()
    dist.barrier()
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return 1e3 * (time.perf_counter() - t) / reps


def collective_ms(ctx, cfg, dev) -> dict:
    """The collectives of one decode step of 4 slots at their shapes, timed
    alone: per MoE layer the attention psum, the dispatch and combine
    all_to_alls ([ep, s·Cb, D], Cb 8 with the batch split over `data`),
    the bucket counts' all_to_all, the MoE psum and the gather of y; per
    step the embedding psum and the logits' gather; and a 128-token
    chunk's dispatch all_to_all (Cb 24, rows replicated)."""
    from repro_torch.models import moe as moe_mod
    D, V = cfg.d_model, cfg.vocab_size
    s = moe_mod.default_slot_count(cfg, ctx.ep)
    k, cf = cfg.moe.top_k, cfg.moe.capacity_factor
    cb_dec = moe_mod._bucket_capacity(4 // ctx.ep, k, ctx.ep, s, cf)
    cb_pre = moe_mod._bucket_capacity(128, k, ctx.ep, s, cf)
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                     device=dev)
    buf, cnt = z(ctx.ep, s * cb_dec, D), z(ctx.ep, s, dt=torch.int32)
    pre, row, y = z(ctx.ep, s * cb_pre, D), z(4, 1, D), z(4 // ctx.ep, D)
    logits = z(4, V // ctx.tp)
    out = {
        "psum_attn": timed_collective(lambda: ctx.psum_model(row), dev),
        "a2a": timed_collective(lambda: ctx.all_to_all_data(buf), dev),
        "a2a_counts": timed_collective(lambda: ctx.all_to_all_data(cnt),
                                       dev),
        "psum_moe": timed_collective(lambda: ctx.psum_model(y), dev),
        "gather_y": timed_collective(lambda: ctx.all_gather_data(y), dev),
        "gather_logits": timed_collective(
            lambda: ctx.all_gather_model(logits), dev),
        "a2a_chunk": timed_collective(lambda: ctx.all_to_all_data(pre), dev),
        "a2a_bytes": buf.numel() * 4, "a2a_chunk_bytes": pre.numel() * 4}
    out["psum_embed"] = out["psum_attn"]          # the same [4, 1, D] rows
    out["a2a_per_moe_layer"] = 2 * out["a2a"] + out["a2a_counts"]
    out["per_layer"] = (out["psum_attn"] + out["a2a_per_moe_layer"]
                        + out["psum_moe"] + out["gather_y"])
    out["per_step"] = cfg.n_layers * out["per_layer"] + out["psum_embed"] \
        + out["gather_logits"]
    return out


def join_world(rank, world, backend, init, dev_type):
    """Join the phase's process group → (device, nccl): one card a rank
    over NCCL, cuda:0 (or the CPU in a rehearsal) for every rank over
    gloo."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.device import set_precision_policy
    set_precision_policy()
    nccl = backend == "nccl"
    dev = torch.device(dev_type, rank if nccl else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=P17_TIMEOUT_S))
    return dev, nccl


def shard_weights(pl, cfg, pattern, dev, world, rank, res):
    """This rank's shard of the seed's one-rank model: the whole model is
    built one rank at a time and carried over by transfer_params (its
    size and seconds go to `res`)."""
    import torch.distributed as dist

    from repro_torch.models.lm import LM
    one = LM.build(cfg, pattern=pattern, device=dev)
    lm = LM.build(cfg, pattern=pattern, device=dev, ctx=pl.ctx)
    t0 = time.monotonic()
    params = None
    for r in range(world):
        if r == rank:
            whole = one.init(P17_SEED)
            params = pl.transfer_params(one, whole, lm)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    res["shard_gb"] = params_gb(params)
    res["transfer_s"] = time.monotonic() - t0
    return params


def leave_world(res, out_file, nccl):
    """Write this rank's results and leave: a failed rank at once (its
    peers may wait in a collective), an NCCL rank without tearing its
    communicators down (that can block once graphs have captured them)."""
    import torch.distributed as dist
    out_file.parent.mkdir(exist_ok=True)
    out_file.write_text(json.dumps(res, default=float))
    if "error" in res or nccl:
        sys.stdout.flush()
        os._exit(1 if "error" in res else 0)
    gc.collect()
    dist.destroy_process_group()


def plane_config(cfg, run):
    """`cfg` at the capacity factor of a (d)-(f) run: P17_SPEC_CF where it
    speculates, the serving factor otherwise."""
    if P17_PLANES[run][1]:
        return cfg.with_updates(moe_capacity_factor=P17_SPEC_CF)
    return cfg


def plane_workload(run, vocab):
    """Phase 17's traffic of a (d)-(f) run: phase 17's prompts for int8
    arenas alone; for a speculating server phase 7's first P17_SPEC_GREEDY
    drafting prompts and its sampled request, which waits for a slot
    (cut from phase 7's seven requests for the script's time limit)."""
    if P17_PLANES[run][1]:
        prompts, params = spec_workload(vocab)
        keep = list(range(P17_SPEC_GREEDY)) + [len(prompts) - 1]
        return [prompts[i] for i in keep], [params[i] for i in keep]
    return dist_workload(vocab)


def serve_planes(srv, run, dev, **warm) -> dict:
    """One (d)-(f) run on `srv` (warm_and_drive, with `warm`'s warm-up
    knobs), with the peak memory it took."""
    torch.cuda.reset_peak_memory_stats(dev)
    rec = warm_and_drive(srv, *plane_workload(run, srv.cfg.vocab_size),
                         **warm)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return rec


def dist_chaos_server(cfg, dev=None, params=None, placement=None):
    """Phase 17 (g)'s server: phase 17's knobs at P17_SPEC_CF on two
    prefill and two decode instances with phase 12's watchdog and
    retries."""
    return dist_server(cfg.with_updates(moe_capacity_factor=P17_SPEC_CF),
                       True, dev=dev, params=params, placement=placement,
                       chaos=True)


def dist_chaos_traffic(vocab):
    """Phase 17 (g)'s traffic: P17_CHAOS_PROMPTS seeded prompts of 32-80
    tokens (one chunk each) x P17_CHAOS_NEW greedy tokens, and a warm-up
    of two other 24-token prompts x 3 tokens (the plane attaches after
    it)."""
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(32)

    def draw(n):
        return tuple(int(t) for t in rng.integers(0, vocab, n))
    prompts = [draw(int(rng.integers(32, 81)))
               for _ in range(P17_CHAOS_PROMPTS)]
    return prompts, SamplingParams(max_tokens=P17_CHAOS_NEW), (
        [draw(24) for _ in range(2)], SamplingParams(max_tokens=3))


def chaos_world(cfg, params, fresh, dev) -> dict:
    """Phase 17 (g) on this rank (every rank in lockstep): a fault-free run
    on a new warmed server, the time of one `pmax_world` of its [N+1]
    corruption mask alone, then FaultPlane(FaultConfig(P17_CHAOS_SEED,
    horizon)) on another (`chaos_run`: each `recover_corruption` timed on
    the host, the world reduction included)."""
    from repro_torch.serving import FaultConfig, FaultPlane
    prompts, sp, warm = dist_chaos_traffic(cfg.vocab_size)
    base = dist_chaos_server(cfg, params=params, placement=fresh())
    ff = chaos_run(base, prompts, sp, warm, dev)
    mask = base.kv_arena.corrupt_mask()
    pmax_ms = timed_collective(lambda: base.ctx.pmax_world(mask), dev)
    del base
    horizon = max(ff["server_steps"] // 2, 3)
    plane = FaultPlane(FaultConfig(seed=P17_CHAOS_SEED, horizon=horizon))
    srv = dist_chaos_server(cfg, params=params, placement=fresh())
    run = chaos_run(srv, prompts, sp, warm, dev, plane=plane)
    del srv
    return {"fault_free": ff, "chaos": run, "horizon": horizon,
            "pmax_world_ms": pmax_ms, "mask_len": int(mask.numel())}


def dist_rank(rank, world, backend, init, out_dir, dev_type="cuda"):
    """One rank of phase 17: join the group, build the rank's shard of the
    seed's one-rank model, serve (a) chunked, (b) whole-prompt, (c)
    chunked with a forced migration mid-decode, time the collectives,
    serve (d) int8 arenas, (e) speculation and (f) both, (g) FaultPlane
    chaos (`chaos_world`), and write the results to
    <out_dir>/p17_rank<r>.json. `dev_type` "cpu" rehearses the
    phase off the card (with the torch.cuda calls stubbed)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import DevicePlacement
    dev, nccl = join_world(rank, world, backend, init, dev_type)
    res = {"rank": rank}
    try:
        # the capacity cut's drops count from here on (before any capture)
        moe_mod.drop_tally(dev)
        # gloo collectives cannot be captured: capture=False, explicitly
        pl = DevicePlacement.build(P17_TP, P17_EP, dev, backend,
                                   capture=None if nccl else False,
                                   check_lockstep=True)
        cfg = dist_config()
        params = shard_weights(pl, cfg, [0] * cfg.n_layers, dev, world,
                               rank, res)
        prompts, sp = dist_workload(cfg.vocab_size)
        # one placement (hot-loop registry, graph pool) a server, on the
        # rank's context
        fresh = lambda: DevicePlacement(pl.device, pl.capture, pl.ctx)
        for name, chunked in (("a_chunked", True), ("b_whole", False)):
            srv = dist_server(cfg, chunked, params=params, placement=fresh())
            res[name] = warm_and_drive(srv, prompts, sp, **P17_WARM)
            del srv
        res["collectives_ms"] = collective_ms(pl.ctx, cfg, dev)
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        # (d)-(f): QuantPlane and SpecPlane on the rank's shard, each run's
        # peak memory its own
        for run, (quant, spec, _) in P17_PLANES.items():
            srv = dist_server(plane_config(cfg, run), True, params=params,
                              placement=fresh(), quant=quant, spec=spec)
            res[run] = serve_planes(srv, run, dev, **P17_WARM)
            del srv
        res["g_chaos"] = chaos_world(cfg, params, fresh, dev)
        # (c) add_request / step with a forced migration halfway through
        # the decode steps (it moves the parameters in place: last)
        srv = dist_server(cfg, True, params=params, placement=fresh())
        rids = [srv.add_request(p, sp) for p in prompts]
        got = {r: [] for r in rids}
        done, migrated = set(), None
        while len(done) < len(rids):
            for o in srv.step():
                got[o.rid].extend(o.new_tokens)
                if o.finished:
                    done.add(o.rid)
            if migrated is None and \
                    srv.decodes[0].stats["steps"] >= P17_NEW // 2:
                migrated = srv.decodes[0].stats["steps"]
                srv._apply_migration(swapped_slots_plan(srv))
        res["c_migrate"] = {"streams": [got[r] for r in rids],
                            "at_step": migrated,
                            "migration": dict(srv.migration_stats),
                            "slot_expert": srv.tables["slot_expert"]
                            .cpu().tolist()}
        del srv
    except BaseException as exc:
        res["error"] = f"{type(exc).__name__}: {exc}"
    leave_world(res, Path(out_dir) / f"p17_rank{rank}.json", nccl)


def check_rank_local_kernels(dev, timer, log, cfg):
    """The kernels of phases 17, 18 and 19 at one rank's shapes,
    each against its plain version, timed with its bound and library call
    → {kernel: {record name: record}}. Phase 17's four ("tp2ep2"):
    paged_decode and paged_prefill over K / tp = 8 KV heads (G 1, h 128,
    phase 17's 4 slots and 128-token chunks), flash_prefill over 8 heads
    of a 448-token prompt padded to 512, and moe_gmm over the rank's 30
    slots with ep·Cb rows each — 16 at a 4-slot decode step (w1/w3: [30,
    16, 2048] x [30, 2048, 704]), 48 at a 128-token chunk, and (d)-(f)'s
    QuantPlane and SpecPlane shapes: paged_decode and paged_prefill on
    int8 arenas of the rank's 8 KV heads, spec_verify over a 4-slot window
    of P7_K + 1 rows in float32 and int8 (each int8 path against
    dequantize-then-SDPA; returned under "int8"), and moe_gmm at a verify
    window's rows ("tp2ep2_verify": this rank's half of 4 x 5 rows, top-4).
    Phase 18's
    OmniAttn shapes: paged_decode over 264-block ring tables
    ("tp2ep2_ring"), flash_prefill over a 4,608-row bucket with sink 128 +
    window 4,096 ("tp2ep2_window"), sink_decode over the W 4,224 ring
    ("tp2ep2"), and block_topk's score pass over K 8 heads of an nb 288
    table ("tp2ep2") with the scores-given ranking of the max-reduced
    scores ("tp2ep2_select_scores", exact). Phase 19's (tp 4, ep 1) 'wseq'
    shapes ("tp4"): granite-34b's G 12 over one KV head — paged_decode over
    full tables and ring runs ("tp4_ring"), paged_prefill, sink_decode,
    flash_prefill — and qwen2-1.5b's G 3 ("tp4_qwen2": paged_decode,
    paged_prefill; on no served path)."""
    from repro_torch.kernels.block_topk import (
        block_topk_scores, block_topk_scores_plain, block_topk_select_scores,
        block_topk_select_scores_plain)
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.kernels.paged_prefill import (paged_prefill,
                                                   paged_prefill_plain)
    from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
    from repro_torch.kernels.spec_verify import (spec_verify,
                                                 spec_verify_plain)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import stack as tstack
    dt = torch.float32
    K, h = cfg.n_kv_heads // P17_TP, cfg.head_dim
    G = cfg.n_heads // cfg.n_kv_heads
    s = moe_mod.default_slot_count(cfg, P17_EP)
    Fe = cfg.moe.d_ff_expert // P17_TP
    k, cf = cfg.moe.top_k, cfg.moe.capacity_factor
    cb_dec = moe_mod._bucket_capacity(4 // P17_EP, k, P17_EP, s, cf)
    cb_pre = moe_mod._bucket_capacity(128, k, P17_EP, s, cf)
    rec = {}

    def one(name, kern, plain, args, bnd, lib, shape, tol=TOL[dt],
            sub="tp2ep2"):
        got, want = kern(*args).float(), plain(*args).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {sub}: non-finite kernel output")
        torch.testing.assert_close(got, want, **tol, msg=f"{name} {sub}")
        err = float((got - want).abs().max())
        log.append(f"{name} float32 {sub} {shape}: max_abs_err={err:.3g}")
        return {"max_abs_err": err, "ms": timer(lambda: kern(*args)),
                "plain_ms": timer(lambda: plain(*args)),
                "library_ms": timer(lib) if lib is not None else None,
                "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": bnd[2],
                "flops": bnd[3], "shape": shape}

    dec = decode_inputs(dev, dt, 4, K, G, h, 16, 32, 161,
                        [449, 452, 455, 458], 71)
    rec["paged_decode"] = one(
        "paged_decode", paged_decode, paged_decode_plain, dec,
        decode_bound(dec[0], dec[1], dec[3], dec[4]), sdpa_decode(*dec),
        f"B 4, K {K}, G {G}, h {h}, nb 32, lens 449-458")
    pre = prefill_inputs(dev, dt, 1, K, 128, G, h, 16, 32, 161, [256],
                         [128], 72)
    rec["paged_prefill"] = one(
        "paged_prefill", paged_prefill, paged_prefill_plain, pre,
        prefill_bound(pre[0], pre[1], pre[3], pre[5], pre[6], pre[7]),
        sdpa_prefill(*pre), f"K {K}, G {G}, S 128, off 256")
    g = torch.Generator(device=dev).manual_seed(73)
    q, kk, vv = (torch.randn((K * G, 512, h), generator=g, device=dev)
                 for _ in range(3))
    fl = lambda *a: flash_prefill(*a, causal=True)
    fp = lambda *a: flash_prefill_plain(*a, causal=True)
    rec["flash_prefill"] = one(
        "flash_prefill", fl, fp, (q, kk, vv),
        flash_bound(q, kk, True, 0, 0),
        sdpa_flash(q, kk, vv, True, 0, 0), f"N {K * G}, S 512, h {h}",
        tol=TOL_DENSE[dt])
    # decode: 4 slots' tokens x top-4 over 60 experts, about half of them on
    # this rank's 30 slots; chunk: 128 tokens x top-4, all arriving twice
    # (rows replicated over `data`)
    x, w, nv = moe_gmm_inputs(dev, dt, s, P17_EP * cb_dec, cfg.d_model, Fe,
                              8, 1, 74)
    rec["moe_gmm"] = one(
        "moe_gmm", moe_gmm, moe_gmm_plain, (x, w, nv),
        moe_gmm_bound(x, w, nv), lambda: torch.bmm(x, w),
        f"x [{s}, {P17_EP * cb_dec}, {cfg.d_model}] w [{s}, {cfg.d_model}, "
        f"{Fe}], {int(nv.sum())} rows")
    xc, wc, nc = moe_gmm_inputs(dev, dt, s, P17_EP * cb_pre, cfg.d_model, Fe,
                                P17_EP * 128, 2, 75)
    rec["moe_gmm"]["chunk"] = one(
        "moe_gmm", moe_gmm, moe_gmm_plain, (xc, wc, nc),
        moe_gmm_bound(xc, wc, nc), lambda: torch.bmm(xc, wc),
        f"x [{s}, {P17_EP * cb_pre}, {cfg.d_model}], {int(nc.sum())} rows")
    # phase 17 (e)-(f)'s verify window at their capacity factor: 4 slots x
    # (P7_K + 1) rows, this rank's half of them (the batch split over
    # `data`) routed top-4 over 60 experts, about half of the 80
    # assignments on this rank's 30 slots
    S_ver = P7_K + 1
    cb_ver = moe_mod._bucket_capacity(4 * S_ver // P17_EP, k, P17_EP, s,
                                      P17_SPEC_CF)
    xv, wv, nv_ = moe_gmm_inputs(dev, dt, s, P17_EP * cb_ver, cfg.d_model,
                                 Fe, 4 * S_ver * k // 2, 1, 79)
    rec["moe_gmm_verify"] = one(
        "moe_gmm verify", moe_gmm, moe_gmm_plain, (xv, wv, nv_),
        moe_gmm_bound(xv, wv, nv_), lambda: torch.bmm(xv, wv),
        f"x [{s}, {P17_EP * cb_ver}, {cfg.d_model}] w [{s}, {cfg.d_model}, "
        f"{Fe}], {int(nv_.sum())} rows")
    sv = prefill_inputs(dev, dt, 4, K, S_ver, G, h, 16, 32, 161,
                        [256, 262, 270, 281], [S_ver] * 4, 80)
    rec["spec_verify"] = one(
        "spec_verify", spec_verify, spec_verify_plain, sv,
        prefill_bound(sv[0], sv[1], sv[3], sv[5], sv[6], sv[7]),
        sdpa_prefill(*sv), f"B 4, K {K}, G {G}, S {S_ver}, off 256-281")
    # the int8 paths of (d)-(f), over arenas of the rank's K heads written
    # by the port's int8 write path, against dequantize-then-SDPA
    int8 = {}
    for name, kern, plain, lib, seed in (
            ("paged_decode", paged_decode, paged_decode_plain,
             sdpa_decode_int8, 84),
            ("paged_prefill", paged_prefill, paged_prefill_plain,
             sdpa_prefill_int8, 86),
            ("spec_verify", spec_verify, spec_verify_plain,
             sdpa_prefill_int8, 88)):
        a = {"paged_decode": dec, "paged_prefill": pre,
             "spec_verify": sv}[name]
        tb, ln = (a[3], a[4]) if name == "paged_decode" else (a[5], a[6])
        kq, vq, sc = int8_arena(dev, K, 16, h, 161, tb, ln, seed)
        args = (a[0], kq, vq, a[3], a[4]) if name == "paged_decode" else \
            (a[0], a[1], a[2], kq, vq, a[5], a[6], a[7])
        bnd = decode_bound(a[0], kq, a[3], a[4]) if name == "paged_decode" \
            else prefill_bound(a[0], a[1], kq, a[5], a[6], a[7])
        int8[name] = {"tp2ep2": one(
            f"{name} int8", lambda *x, f=kern: f(*x, **sc),
            lambda *x, f=plain: f(*x, **sc), args, bnd, lib(*args, sc),
            rec[name]["shape"] if name in rec else "")}
        int8[name]["tp2ep2"]["library"] = "dequant+sdpa"
        del kq, vq
    out = {name: {"tp2ep2": r} for name, r in rec.items()
           if name != "moe_gmm_verify"}
    out["moe_gmm"]["tp2ep2_verify"] = rec["moe_gmm_verify"]
    out["int8"] = int8
    # phase 18: the ring layers' decode over their 264-block runs (three
    # wrapped rings and a short one), a whole 4,416-4,480-token prompt's
    # bucket through the sink + window mask, the slot-dense ring
    sink, recent = cfg.omniattn.sink_tokens, cfg.omniattn.recent_tokens
    W = sink + recent
    nbr = -(-W // 16)
    ring = decode_inputs(dev, dt, 4, K, G, h, 16, nbr, 4 * nbr + 1,
                         [W, W, W, 130], 76)
    out["paged_decode"]["tp2ep2_ring"] = one(
        "paged_decode ring", paged_decode, paged_decode_plain, ring,
        decode_bound(ring[0], ring[1], ring[3], ring[4]), sdpa_decode(*ring),
        f"B 4, K {K}, G {G}, h {h}, nb {nbr}, lens {W} x 3, 130")
    del ring
    S = P18_MAX_LEN
    q, kk, vv = (torch.randn((K * G, S, h), generator=g, device=dev)
                 for _ in range(3))
    fw = lambda *a: flash_prefill(*a, causal=True, window=recent, sink=sink)
    fwp = lambda *a: flash_prefill_plain(*a, causal=True, window=recent,
                                         sink=sink)
    out["flash_prefill"]["tp2ep2_window"] = one(
        "flash_prefill sink+window", fw, fwp, (q, kk, vv),
        flash_bound(q, kk, True, recent, sink),
        sdpa_flash(q, kk, vv, True, recent, sink),
        f"N {K * G}, S {S}, h {h}, causal, sink {sink}, window {recent}",
        tol=TOL_DENSE[dt])
    del q, kk, vv
    ts = [W, P18_LONG + 1, P18_LONG + 33, 130]
    qs = torch.randn((4, K, G, h), generator=g, device=dev)
    kc, vc = (torch.randn((4, W, K, h), generator=g, device=dev)
              .transpose(1, 2) for _ in range(2))
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    out["sink_decode"] = {"tp2ep2": one(
        "sink_decode", sink_decode, sink_decode_plain, (qs, kc, vc, t),
        sink_bound(qs, kc, t), sdpa_sink(qs, kc, vc, t),
        f"B 4, K {K}, G {G}, h {h}, W {W}, t {ts}", tol=TOL_DENSE[dt])}
    del kc, vc
    # block_topk at tp 2: each rank's score pass over its 8 heads, the max
    # of the two ranks' scores, the ranking and compaction of that max
    nbt = -(-P18_MAX_LEN // 16)
    lens_t = [P18_LONG + 1, P18_LONG + 33, P18_LONG + 65, P18_LONG + 8]
    ta = topk_inputs(dev, dt, 4, K, G, h, 16, nbt, 4 * nbt + 1, lens_t, 77)
    sc = lambda *a: block_topk_scores(*a, block_size=16)
    scp = lambda *a: block_topk_scores_plain(*a, block_size=16)
    got, want = sc(*ta), scp(*ta)
    neg = want == -1e30
    if not torch.equal(got[neg], want[neg]) or (got[~neg] == -1e30).any():
        raise AssertionError("block_topk tp2ep2: NEG_INF entries differ")
    out["block_topk"] = {"tp2ep2": one(
        "block_topk", sc, scp, ta, topk_bound(ta[0], ta[3], ta[4], 16),
        None, f"B 4, K {K}, G {G}, h {h}, nb {nbt}, lens {lens_t}")}
    other = topk_inputs(dev, dt, 4, K, G, h, 16, nbt, 4 * nbt + 1, lens_t,
                        78)
    scores = torch.maximum(sc(*ta), sc(ta[0], other[1], other[2], *ta[3:]))
    k_static = -(-nbt // 4)
    kw = dict(block_size=16, k_static=k_static, frac=0.25, sink_blocks=1,
              recent_blocks=2, token_mask=torch.tensor(
                  [True, True, True, False], device=dev))
    sel = lambda: block_topk_select_scores(scores, ta[3], ta[4], **kw)
    selp = lambda: block_topk_select_scores_plain(scores, ta[3], ta[4], **kw)
    for name, a, b in zip(("tables", "lens", "m", "selected", "aux"), sel(),
                          selp()):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"block_topk_select_scores tp2ep2: {name} "
                                 f"differ from the plain version")
    log.append(f"block_topk_select_scores float32 tp2ep2 B 4, nb {nbt}, "
               f"frac 0.25 over the max of two ranks' scores: tables, lens, "
               f"counts, mask and stats equal the plain version")
    gb = topk_given_bound(ta[3], ta[4], 16, k_static)
    out["block_topk"]["tp2ep2_select_scores"] = {
        "max_abs_err": 0.0, "exact": True, "ms": timer(sel),
        "plain_ms": timer(selp), "library_ms": None, "bound_ms": gb[0],
        "bound_by": gb[1], "bytes": gb[2], "flops": gb[3],
        "shape": f"B 4, nb {nbt}, k_static {k_static}, frac 0.25"}
    del ta, other, scores
    # phase 19 ("tp4"): one rank of (tp 4, ep 1) under 'wseq' — granite's
    # 12 query heads over its one KV head (G 12) at phase 19's shapes:
    # decode over full tables (nb 32) and ring runs (nb 264, the rings
    # not yet wrapped at 449-458 tokens), a 128-token chunk at offset 256,
    # the slot-dense ring (W 4,224) and a 448-token prompt's 512 bucket;
    # and qwen2-1.5b's 3 query heads over KV head t // 2 (G 3), which no
    # phase serves at tp 4
    from repro_torch.configs import get_config
    for sub, arch in (("tp4", "granite-34b"), ("tp4_qwen2", "qwen2-1.5b")):
        c = get_config(arch)
        hl = tstack.head_layout(c, 4)
        Kt, Gt, ht = hl.nk, hl.nq // hl.nk, c.head_dim
        lens = [449, 452, 455, 458]
        dec = decode_inputs(dev, dt, 4, Kt, Gt, ht, 16, 32, 161, lens, 81)
        out["paged_decode"][sub] = one(
            "paged_decode", paged_decode, paged_decode_plain, dec,
            decode_bound(dec[0], dec[1], dec[3], dec[4]), sdpa_decode(*dec),
            f"{arch} rank: B 4, K {Kt}, G {Gt}, h {ht}, nb 32, lens "
            f"449-458", sub=sub)
        pre = prefill_inputs(dev, dt, 1, Kt, 128, Gt, ht, 16, 32, 161,
                             [256], [128], 82)
        out["paged_prefill"][sub] = one(
            "paged_prefill", paged_prefill, paged_prefill_plain, pre,
            prefill_bound(pre[0], pre[1], pre[3], pre[5], pre[6], pre[7]),
            sdpa_prefill(*pre), f"{arch} rank: K {Kt}, G {Gt}, S 128, "
            f"off 256", sub=sub)
        if sub != "tp4":
            continue
        nbr = -(-(c.omniattn.sink_tokens + c.omniattn.recent_tokens) // 16)
        ring = decode_inputs(dev, dt, 4, Kt, Gt, ht, 16, nbr, 4 * nbr + 1,
                             lens, 83)
        out["paged_decode"]["tp4_ring"] = one(
            "paged_decode ring", paged_decode, paged_decode_plain, ring,
            decode_bound(ring[0], ring[1], ring[3], ring[4]),
            sdpa_decode(*ring), f"{arch} rank: B 4, K {Kt}, G {Gt}, h {ht},"
            f" nb {nbr}, lens 449-458", sub="tp4_ring")
        del ring
        W = c.omniattn.sink_tokens + c.omniattn.recent_tokens
        qs = torch.randn((4, Kt, Gt, ht), generator=g, device=dev)
        kc, vc = (torch.randn((4, W, Kt, ht), generator=g, device=dev)
                  .transpose(1, 2) for _ in range(2))
        t = torch.tensor(lens, dtype=torch.int32, device=dev)
        out["sink_decode"]["tp4"] = one(
            "sink_decode", sink_decode, sink_decode_plain, (qs, kc, vc, t),
            sink_bound(qs, kc, t), sdpa_sink(qs, kc, vc, t),
            f"{arch} rank: B 4, K {Kt}, G {Gt}, h {ht}, W {W}, t {lens}",
            tol=TOL_DENSE[dt], sub="tp4")
        del kc, vc
        q, kk, vv = (torch.randn((Kt * Gt, 512, ht), generator=g,
                                 device=dev) for _ in range(3))
        out["flash_prefill"]["tp4"] = one(
            "flash_prefill", fl, fp, (q, kk, vv),
            flash_bound(q, kk, True, 0, 0),
            sdpa_flash(q, kk, vv, True, 0, 0),
            f"{arch} rank: N {Kt * Gt}, S 512, h {ht}", tol=TOL_DENSE[dt],
            sub="tp4")
        del q, kk, vv
    return out


def topk_given_bound(tables, lens, bs, k_static):
    """block_topk_select_scores: the scores and lens read once, the kept
    blocks' table entries read, the compacted table, lens, counts, mask and
    stats written once; the ranking is integer work and adds no
    operations."""
    B, nb = tables.shape
    nbytes = 4 * B * nb + 4 * B + 4 * B * k_static + 4 * B * k_static \
        + 8 * B + B * nb + 16
    return bound(nbytes, 0, torch.float32)


def first_diff(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None


def world_init() -> str:
    """A rendezvous address on a free local port."""
    import socket
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        return f"tcp://localhost:{s_.getsockname()[1]}"


def run_world(fn, world, backend, prefix, limit_s) -> tuple:
    """Spawn `world` ranks of fn(rank, world, backend, init, out_dir), each
    writing OUT_DIR/<prefix><rank>.json, and wait at most `limit_s` →
    (their results in rank order, the world's seconds). Raises if a rank
    failed, hung or did not report."""
    for f in OUT_DIR.glob(f"{prefix}*.json"):
        f.unlink()
    t0 = time.monotonic()
    procs = torch.multiprocessing.start_processes(
        fn, args=(world, backend, world_init(), str(OUT_DIR)), nprocs=world,
        join=False, start_method="spawn")
    failed = None
    try:
        while not procs.join(timeout=10):
            if time.monotonic() - t0 > limit_s:
                failed = f"the world did not finish in {limit_s} s"
                break
    except torch.multiprocessing.ProcessExitedException as exc:
        failed = str(exc)
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    seconds = time.monotonic() - t0
    files = [OUT_DIR / f"{prefix}{r}.json" for r in range(world)]
    ranks = [json.loads(f.read_text()) for f in files if f.exists()]
    errors = [f"rank {r['rank']}: {r['error']}" for r in ranks if "error" in r]
    if failed or errors or len(ranks) < world:
        raise AssertionError(f"{prefix}: {failed}; {errors}; "
                             f"{len(ranks)} of {world} ranks reported")
    return ranks, seconds


def check_rank_streams(phase, name, ranks, want, prompts, build):
    """Every rank's streams of run `name` equal `want` (the one-rank
    Server's), or raise naming the first differing token and the one-rank
    model's top-2 logit margin there (a fresh one-rank server from
    `build()`, the greedy context of `want`)."""
    for r in ranks:
        got = r[name]["streams"]
        for k, (a, b) in enumerate(zip(got, want)):
            if a == b:
                continue
            i = first_diff(a, b)
            i = min(len(a), len(b)) if i is None else i
            gc.collect()
            torch.cuda.empty_cache()
            srv = build()
            margin = top2_margin(srv, prompts[k], b, i)
            del srv
            raise AssertionError(
                f"{phase} {name}: rank {r['rank']} request {k} differs from "
                f"the one-rank Server at token {i} (one-rank top-2 logit "
                f"margin there {margin:.3g}): {a} vs {b}")


def dist_phase(dev, timer, log):
    """Phase 17: full-width qwen2-moe-a2.7b (P17_LAYERS layers, float32)
    served over (tp 2, ep 2) ranks, one process each: NCCL with one card a
    rank and the hot loops captured where four cards are visible, else the
    four ranks share cuda:0 over gloo with capture=False. (a) chunked, (b)
    whole-prompt, (c) a forced migration, then QuantPlane and SpecPlane:
    (d) int8 arenas, (e) SpecConfig(k=P7_K) on P17_SPEC_GREEDY of phase
    7's drafting prompts and its sampled request, (f) both
    (`check_plane_runs`), (g) FaultPlane chaos on two prefill and two
    decode instances (`chaos_world`, `check_chaos_world`). Its streams
    must equal the one-rank port
    Server's on the same card and seed-0 weights; the rank-local kernels
    are held to their plain versions. A failure here fails the run."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import Server  # noqa: F401  (the build check)
    cfg = dist_config()
    # the capacity cut's drops count from here on (before any capture)
    moe_mod.drop_tally(dev)
    world = P17_TP * P17_EP
    n_cards = torch.cuda.device_count()
    nccl = n_cards >= world
    backend = "nccl" if nccl else "gloo"
    out = {"backend": backend, "cards": n_cards, "layers": cfg.n_layers,
           "dtype": P17_DTYPE}
    out["why"] = (f"{n_cards} cards visible: NCCL, one card a rank, hot loops"
                  f" captured as CUDA graphs" if nccl else
                  f"{n_cards} card visible: the {world} ranks share cuda:0 "
                  f"over gloo (NCCL refuses two ranks on one GPU); gloo "
                  f"collectives cannot be captured, so every placement is "
                  f"built with capture=False")
    out["kernels"] = check_rank_local_kernels(dev, timer, log, cfg)
    out["kernels_int8"] = out["kernels"].pop("int8")
    torch.cuda.empty_cache()
    prompts, sp = dist_workload(cfg.vocab_size)
    # the one-rank port Server on the same card and seed-0 weights
    ref = {}
    srv = dist_server(cfg, True, dev=dev)
    out["one_rank_weights_gb"] = params_gb(srv.params)
    ref["a_chunked"] = warm_and_drive(srv, prompts, sp, **P17_WARM)
    srvb = dist_server(cfg, False, dev=dev, params=srv.params)
    ref["b_whole"] = warm_and_drive(srvb, prompts, sp, **P17_WARM)
    out["one_rank"] = {k: {x: v[x] for x in ("metrics", "launches",
                                             "decode_round_ms")}
                       for k, v in ref.items()}
    del srvb
    out["one_rank_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    # (d)-(f) on the same weights
    weights = srv.params
    del srv
    for run, (quant, spec, _) in P17_PLANES.items():
        srvp = dist_server(plane_config(cfg, run), True, dev=dev,
                           params=weights, quant=quant, spec=spec)
        ref[run] = serve_planes(srvp, run, dev, **P17_WARM)
        out["one_rank"][run] = {x: ref[run][x] for x in (
            "metrics", "launches", "decode_round_ms", "decode_stats",
            "drops", "peak_mem_gb", "steps")}
        del srvp
    # (g): the one-rank fault-free run at the same factor
    prompts_g, sp_g, warm_g = dist_chaos_traffic(cfg.vocab_size)
    srvg = dist_chaos_server(cfg, dev=dev, params=weights)
    ref["g_chaos"] = chaos_run(srvg, prompts_g, sp_g, warm_g, dev)
    out["one_rank"]["g_chaos"] = {x: ref["g_chaos"][x] for x in (
        "metrics", "server_steps", "chunks", "decode_steps", "wall_s")}
    del srvg, weights
    gc.collect()
    torch.cuda.empty_cache()
    # the world: rank = e · tp + t, one process each
    ranks, out["world_s"] = run_world(dist_rank, world, backend, "p17_rank",
                                      P17_WORLD_S)
    # every rank emits the same tokens, equal to the one-rank Server's
    for name, chunked in (("a_chunked", True), ("b_whole", False)):
        check_rank_streams("phase 17", name, ranks, ref[name]["streams"],
                           prompts, lambda c=chunked: dist_server(cfg, c,
                                                                  dev=dev))
    for r in ranks:
        if r["c_migrate"]["streams"] != ranks[0]["a_chunked"]["streams"]:
            raise AssertionError(f"phase 17 (c): rank {r['rank']}'s streams "
                                 f"changed across the forced migration")
        if r["c_migrate"]["migration"]["bytes"] <= 0:
            raise AssertionError("phase 17 (c): the migration moved nothing")
    r0 = ranks[0]
    for name in ("a_chunked", "b_whole"):
        ln = r0[name]["launches"]
        need = ("paged_decode", "moe_gmm") + (
            ("paged_prefill",) if name == "a_chunked" else ("flash_prefill",))
        for k in need:
            if ln.get(k, 0) <= 0:
                raise AssertionError(f"phase 17 {name}: no {k} launch")
    out["planes"] = check_plane_runs(ranks, ref, cfg, dev, log)
    out["chaos"] = check_chaos_world(ranks, ref["g_chaos"]["streams"])
    out["ranks"] = ranks
    cm = r0["collectives_ms"]
    out["collective_share"] = cm["per_step"] / r0["a_chunked"][
        "decode_round_ms"]
    log.append(f"transport: {backend} — {out['why']}")
    log.append(f"weights: one rank {out['one_rank_weights_gb']:.2f} GB; "
               f"shards " + ", ".join(f"{r['shard_gb']:.2f}" for r in ranks)
               + f" GB; built one rank at a time and carried over in "
               f"{r0['transfer_s']:.1f} s")
    return out


def check_chaos_world(ranks, want) -> dict:
    """Phase 17 (g): on every rank the fault-free streams equal the
    one-rank Server's fault-free streams `want`, the chaos run's streamed
    deltas equal its outputs and both equal the fault-free streams; every
    rank's plane fired the same faults at the same steps (its `fired`
    list), skipped the same, and every rank quarantined the same blocks.
    → per rank the figures phase 17 prints."""
    out = []
    g0 = ranks[0]["g_chaos"]
    for r in ranks:
        g = r["g_chaos"]
        ff, run = g["fault_free"], g["chaos"]
        for what, got, exp in (
                ("fault-free vs the one-rank Server", ff["streams"], want),
                ("chaos deltas vs outputs", run["streams"], run["outputs"]),
                ("chaos vs fault-free", run["outputs"], ff["streams"])):
            for k, (a, b) in enumerate(zip(got, exp)):
                if a != b:
                    raise AssertionError(
                        f"phase 17 (g) rank {r['rank']} {what}: request {k} "
                        f"differs at token {first_diff(a, b)}: {a} vs {b}")
            if len(got) != len(exp):
                raise AssertionError(f"phase 17 (g) rank {r['rank']} {what}:"
                                     f" {len(got)} vs {len(exp)} streams")
        for key in ("fired", "injected", "skipped", "quarantined",
                    "retries", "handoffs_swept"):
            if run[key] != g0["chaos"][key]:
                raise AssertionError(f"phase 17 (g): rank {r['rank']}'s "
                                     f"{key} {run[key]} differs from rank "
                                     f"0's {g0['chaos'][key]}")
        out.append({"rank": r["rank"], "injected": run["injected"],
                    "skipped": run["skipped"],
                    "quarantined": run["quarantined"],
                    "retries": run["retries"],
                    "handoffs_swept": run["handoffs_swept"],
                    "recover_ms": [1e3 * x for x in run["recover_s"]],
                    "pmax_world_ms": g["pmax_world_ms"],
                    "mask_len": g["mask_len"], "horizon": g["horizon"],
                    "server_steps": [ff["server_steps"],
                                     run["server_steps"]],
                    "walls": [ff["wall_s"], run["wall_s"]]})
    if sum(g0["chaos"]["injected"].values()) <= 0:
        raise AssertionError("phase 17 (g): the plane injected nothing")
    return {"ranks": out, "fired": g0["chaos"]["fired"]}


def check_plane_runs(ranks, ref, cfg, dev, log) -> dict:
    """Phase 17 (d)-(f) against the one-rank Server's runs `ref`: every
    rank's streams equal them — exactly in float32, an int8 stream up to a
    near-tie of one-rank top-2 margin below P17_INT8_TIE (a one-rank
    server is built only where a stream differs) —, the speculation
    counters are equal on every rank, each rank's int8 residency figures
    are its own (half the one-rank figure: 8 of 16 KV heads), the
    speculating runs drop nothing at P17_SPEC_CF on either side, and rank
    0 launched the run's kernels. → per run the near-ties and the figures
    printed."""
    out = {}
    for run, (quant, spec, need) in P17_PLANES.items():
        prompts, sp = plane_workload(run, cfg.vocab_size)
        want = ref[run]["streams"]
        pcfg = plane_config(cfg, run)
        if not quant:
            check_rank_streams("phase 17", run, ranks, want, prompts,
                               lambda s_=spec: dist_server(pcfg, True,
                                                           dev=dev,
                                                           spec=s_))
            ties = []
        else:
            ties = []
            for r in ranks:
                if r[run]["streams"] == want:
                    continue
                gc.collect()
                torch.cuda.empty_cache()
                srv = dist_server(pcfg, True, dev=dev, quant=True,
                                  spec=spec)
                ties += near_tie_diffs(srv, prompts, sp, r[run]["streams"],
                                       want, f"phase 17 {run} rank "
                                       f"{r['rank']}", log,
                                       limit=P17_INT8_TIE)
                del srv
        stats = [r[run]["decode_stats"] for r in ranks]
        if any(s_ != stats[0] for s_ in stats):
            raise AssertionError(f"phase 17 {run}: the decode stats differ "
                                 f"between ranks: {stats}")
        one = ref[run]["decode_stats"]
        if quant:
            for k in ("quant_block_bytes", "quant_block_bytes_f32"):
                if not 0 < 2 * stats[0][k] == one[k]:
                    raise AssertionError(f"phase 17 {run}: {k} {stats[0][k]}"
                                         f" is not half the one-rank {one[k]}")
        if spec and stats[0]["spec_verifies"] <= 0:
            raise AssertionError(f"phase 17 {run}: no verify step")
        ln = ranks[0][run]["launches"]
        for k in need:
            if ln.get(k, 0) <= 0:
                raise AssertionError(f"phase 17 {run}: rank 0 made no {k} "
                                     f"launch")
        drops = [r[run]["drops"] for r in ranks]
        if spec and (any(drops) or ref[run]["drops"]):
            raise AssertionError(f"phase 17 {run}: capacity factor "
                                 f"{P17_SPEC_CF} dropped assignments: ranks "
                                 f"{drops}, one rank {ref[run]['drops']}")
        out[run] = {"near_ties": ties, "decode_stats": stats[0],
                    "one_rank_decode_stats": one, "drops": drops,
                    "one_rank_drops": ref[run]["drops"],
                    "capacity_factor": pcfg.moe.capacity_factor}
    return out


# ---- phase 18: OmniAttn's default pattern over (tp 2, ep 2) ranks -------
P18_TP, P18_EP = 2, 2
# of 24: one period of the default pattern [1,1,1,0], for the script's
# time limit
P18_LAYERS = 4
P18_PREFIX, P18_TAILS = 4096, (320, 352, 384)   # prompts of 4,416-4,480
P18_LONG = P18_PREFIX + P18_TAILS[0]
P18_MAX_LEN = 4608
P18_NEW = 8
P18_CHUNK = 512
P18_BLOCKS = 1200       # 3 slots x 281 blocks of 16, plus the prefix store
P18_TOPK_FRAC = 0.25
P18_WORLD_S = 400       # the world joins within this, or is killed
# the cases: (chunked prefill, paged KV, online top-k)
P18_CASES = {"a_ring_paged": (True, True, False),
             "b_whole_dense": (False, False, False),
             "c_topk": (True, True, True)}


def omni_config(case):
    """Phase 17's model (qwen2-moe-a2.7b at full width, float32) cut to
    P18_LAYERS layers at its default pattern [1,1,1,0]: three rings of sink
    128 + recent 4,096 and one full layer. Chunked cases mask prefill
    chunks with the rings' sink + recent window (prefill_sparse); (c) sets
    online top-k at frac 0.25 on the full layers."""
    chunked, _, topk = P18_CASES[case]
    cfg = dist_config().with_updates(prefill_sparse=chunked,
                                     n_layers=P18_LAYERS)
    if topk:
        from dataclasses import replace
        cfg = cfg.with_updates(omniattn=replace(cfg.omniattn,
                                                topk_frac=P18_TOPK_FRAC))
    assert cfg.default_compression_pattern() == \
        [1, 1, 1, 0] * (P18_LAYERS // 4)
    return cfg


def omni_server(cfg, case, dev=None, params=None, placement=None):
    """Phase 18's server: 4 slots, 4,608-token context, 512-token chunks,
    the default pattern, the placement monitor off."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    chunked, paged, _ = P18_CASES[case]
    scfg = ServerConfig(n_prefill=1, n_decode=1, decode_slots=4,
                        max_len=P18_MAX_LEN, chunk_tokens=P18_CHUNK,
                        prefill_tick_budget=2 * P18_CHUNK, kv_block_size=16,
                        kv_blocks=P18_BLOCKS, chunked_prefill=chunked,
                        paged_kv=paged, enable_placement=False,
                        oas=OASConfig(defer_window=0.0))
    return Server(cfg, scfg, pattern=None, params=params, seed=P17_SEED,
                  device=dev, placement=placement)


def omni_workload(vocab):
    """Three prompts on one 4,096-token prefix with 320-384 tokens each
    after it (every ring of 4,224 wraps in prefill), P18_NEW greedy tokens
    each."""
    from repro_torch.core.proxy import SamplingParams
    rng = np.random.default_rng(18)
    base = tuple(int(t) for t in rng.integers(0, vocab, P18_PREFIX))
    prompts = [base + tuple(int(t) for t in rng.integers(0, vocab, n))
               for n in P18_TAILS]
    return prompts, SamplingParams(max_tokens=P18_NEW)


def omni_rank(rank, world, backend, init, out_dir, dev_type="cuda"):
    """One rank of phase 18: join the group, build the rank's shard of the
    seed's one-rank model, serve (a), (b), (c), time one `pmax_model` of a
    decode step's block scores, and write the results to
    <out_dir>/p18_rank<r>.json."""
    from repro_torch.serving import DevicePlacement
    dev, nccl = join_world(rank, world, backend, init, dev_type)
    res = {"rank": rank}
    try:
        pl = DevicePlacement.build(P18_TP, P18_EP, dev, backend,
                                   capture=None if nccl else False,
                                   check_lockstep=True)
        cfg = omni_config("a_ring_paged")
        params = shard_weights(pl, cfg, None, dev, world, rank, res)
        prompts, sp = omni_workload(cfg.vocab_size)
        for case in P18_CASES:
            srv = omni_server(omni_config(case), case, params=params,
                              placement=DevicePlacement(pl.device, pl.capture,
                                                        pl.ctx))
            res[case] = warm_and_drive(srv, prompts, sp, warm_prompts=2,
                                       warm_runs=1)
            del srv
            gc.collect()
        nbt = -(-P18_MAX_LEN // 16)
        scores = torch.zeros((4, nbt), device=dev)
        res["pmax_ms"] = timed_collective(lambda: pl.ctx.pmax_model(scores),
                                          dev)
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    except BaseException as exc:
        res["error"] = f"{type(exc).__name__}: {exc}"
    leave_world(res, Path(out_dir) / f"p18_rank{rank}.json", nccl)


P18_NEEDS = {"a_ring_paged": ("paged_decode", "paged_prefill", "moe_gmm"),
             "b_whole_dense": ("sink_decode", "flash_prefill", "moe_gmm"),
             "c_topk": ("block_topk_scores", "block_topk_select_scores",
                        "paged_decode", "paged_prefill", "moe_gmm")}


def omni_dist_phase(dev, timer, log):
    """Phase 18: phase 17's model, P18_LAYERS layers, at its DEFAULT
    pattern (sink 128 + recent 4,096 rings, a full layer in every four)
    over (tp 2, ep 2) ranks, on the
    transport phase 17 picks: (a) chunked prefill over paged ring runs,
    (b) whole prompts into the slot-dense layout (sink_decode), (c) (a)
    with online top-k at frac 0.25 on the full layers, whose block scores
    each rank max-reduces over `model` before ranking. Every rank's
    streams must equal the one-rank port Server's on the same card and
    seed-0 weights, and in (c) its blocks scored and attended too; each
    case launches its kernels. A failure here fails the run."""
    world = P18_TP * P18_EP
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= world else "gloo"
    out = {"backend": backend, "cards": n_cards}
    cfg = omni_config("a_ring_paged")
    prompts, sp = omni_workload(cfg.vocab_size)
    ref, params = {}, None
    for case in P18_CASES:
        srv = omni_server(omni_config(case), case, dev=dev, params=params)
        params = srv.params
        ref[case] = warm_and_drive(srv, prompts, sp)
        del srv
        gc.collect()
    out["one_rank"] = {k: {x: v[x] for x in ("metrics", "launches",
                                             "decode_round_ms", "steps")}
                       for k, v in ref.items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ranks, out["world_s"] = run_world(omni_rank, world, backend, "p18_rank",
                                      P18_WORLD_S)
    for case in P18_CASES:
        check_rank_streams("phase 18", case, ranks, ref[case]["streams"],
                           prompts, lambda c=case: omni_server(
                               omni_config(c), c, dev=dev))
    want = ref["c_topk"]["metrics"]
    for r in ranks:
        got = r["c_topk"]["metrics"]
        for k in ("blocks_scored", "blocks_attended"):
            if got[k] != want[k] or not got[k] > 0:
                raise AssertionError(f"phase 18 (c): rank {r['rank']} {k} "
                                     f"{got[k]} vs the one-rank Server's "
                                     f"{want[k]}")
        if not got["blocks_attended"] < got["blocks_scored"]:
            raise AssertionError("phase 18 (c): the budget did not bind")
        for case, need in P18_NEEDS.items():
            for k in need:
                if r[case]["launches"].get(k, 0) <= 0:
                    raise AssertionError(f"phase 18 {case}: rank "
                                         f"{r['rank']} launched no {k}")
    out["ranks"] = ranks
    log.append(f"transport: {backend}; rank 0's shard "
               f"{ranks[0]['shard_gb']:.2f} GB, carried over in "
               f"{ranks[0]['transfer_s']:.1f} s; pmax_model of [4, "
               f"{-(-P18_MAX_LEN // 16)}] scores {ranks[0]['pmax_ms']:.3f} ms")
    return out


# ---- phase 19: every layout over (tp 4, ep 1): granite-34b, mamba2 ------
P19_TP, P19_EP = 4, 1
P19_LAYERS = 8          # of granite's 88: the one-rank model and the four
                        # shards fit on one card together
P19_WORLD_S = 420       # the world joins within this, or is killed
# the runs: name → (arch, chunked prefill, paged KV)
P19_RUNS = {"a_granite_chunked": ("granite-34b", True, True),
            "a_granite_whole": ("granite-34b", False, False),
            "b_mamba2_chunked": ("mamba2-130m", True, True)}
P19_NEEDS = {"a_granite_chunked": ("paged_decode", "paged_prefill"),
             "a_granite_whole": ("sink_decode", "flash_prefill"),
             "b_mamba2_chunked": ()}


def layout_config(run):
    """Phase 19's model of `run`: granite-34b at full width (d 6,144, 48
    query heads over 1 KV head, h 128, d_ff 24,576, vocab 49,152) in
    float32, its first P19_LAYERS layers at the default pattern (three of
    four layers sink 128 + recent 4,096 rings; chunked runs mask their
    chunks with it, prefill_sparse), or mamba2-130m as published."""
    from repro_torch.configs import get_config
    arch, chunked, _ = P19_RUNS[run]
    if arch == "mamba2-130m":
        return mamba2_config()
    cfg = get_config(arch).with_updates(
        n_layers=P19_LAYERS, compute_dtype="float32", param_dtype="float32",
        prefill_sparse=chunked)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (6144, 48, 1, 128, 24576, 49152)
    assert cfg.default_compression_pattern() == [1, 1, 1, 0] * 2
    return cfg


def layout_server(run, dev=None, params=None, placement=None):
    """Phase 19's server: phase 17's (4 slots, 512-token context, 128-token
    chunks) at the config's default pattern; (a)'s whole-prompt run
    slot-dense."""
    from repro_torch.core.proxy import OASConfig
    from repro_torch.serving import Server, ServerConfig
    _, chunked, paged = P19_RUNS[run]
    scfg = ServerConfig(n_prefill=1, n_decode=1, decode_slots=4, max_len=512,
                        chunk_tokens=128, prefill_tick_budget=512,
                        kv_block_size=16, chunked_prefill=chunked,
                        paged_kv=paged, enable_placement=False,
                        oas=OASConfig(defer_window=0.0))
    return Server(layout_config(run), scfg, pattern=None, params=params,
                  seed=P17_SEED, device=dev, placement=placement)


def layout_collective_ms(ctx, cfg, dev) -> dict:
    """The collectives of one decode step of 4 slots at (tp 4, ep 1),
    timed alone: per layer the psums of the [4, 1, D] partial rows
    (attention's wo and the FFN's w2; a Mamba-2 layer's out_proj and its
    ssm_norm's [4, 1, 1] sums of squares), per step the embedding's psum
    and the logits' gather."""
    D, V = cfg.d_model, cfg.vocab_size
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    row, ss, logits = z(4, 1, D), z(4, 1, 1), z(4, V // ctx.tp)
    out = {"psum_row": timed_collective(lambda: ctx.psum_model(row), dev),
           "psum_ss": timed_collective(lambda: ctx.psum_model(ss), dev),
           "gather_logits": timed_collective(
               lambda: ctx.all_gather_model(logits), dev)}
    second = out["psum_ss"] if cfg.family == "ssm" else out["psum_row"]
    out["per_layer"] = out["psum_row"] + second
    out["per_step"] = cfg.n_layers * out["per_layer"] + out["psum_row"] \
        + out["gather_logits"]
    return out


def layout_rank(rank, world, backend, init, out_dir, dev_type="cuda"):
    """One rank of phase 19: join the group; per model, build the rank's
    shard of the seed's one-rank model (transfer_params), serve its runs,
    time a decode step's collectives; write <out_dir>/p19_rank<r>.json."""
    from repro_torch.serving import DevicePlacement
    dev, nccl = join_world(rank, world, backend, init, dev_type)
    res = {"rank": rank}
    try:
        pl = DevicePlacement.build(P19_TP, P19_EP, dev, backend,
                                   capture=None if nccl else False,
                                   check_lockstep=True)
        for arch in ("granite-34b", "mamba2-130m"):
            runs = [r for r, v in P19_RUNS.items() if v[0] == arch]
            cfg = layout_config(runs[0])
            res[arch] = {}
            params = shard_weights(pl, cfg, None, dev, world, rank,
                                   res[arch])
            prompts, sp = dist_workload(cfg.vocab_size)
            for run in runs:
                srv = layout_server(run, params=params,
                                    placement=DevicePlacement(
                                        pl.device, pl.capture, pl.ctx))
                res[run] = warm_and_drive(srv, prompts, sp, warm_prompts=2,
                                          warm_runs=1)
                del srv
                gc.collect()
            res[arch]["collectives_ms"] = layout_collective_ms(pl.ctx, cfg,
                                                               dev)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    except BaseException as exc:
        res["error"] = f"{type(exc).__name__}: {exc}"
    leave_world(res, Path(out_dir) / f"p19_rank{rank}.json", nccl)


def layout_dist_phase(dev, timer, log):
    """Phase 19: the layouts phases 17 and 18 did not reach, over (tp 4,
    ep 1) on the transport phase 17 picks: (a) granite-34b (P19_LAYERS
    layers at full width, float32, its default pattern), MQA, so 'wseq':
    each rank 12 query heads over the one KV head that every rank's caches
    hold whole — chunked over paged arenas and ring runs, and whole
    prompts into the slot-dense layout; (b) mamba2-130m as published, 6
    of its 24 SSD heads a rank, chunked. The one-rank port Server serves
    first on seed-0 weights; every rank's streams must equal its; each run
    launches its kernels. A failure here fails the run."""
    world = P19_TP * P19_EP
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= world else "gloo"
    out = {"backend": backend, "cards": n_cards, "one_rank": {}}
    ref, params, prompts = {}, None, {}
    for run, (arch, _, _) in P19_RUNS.items():
        if params is not None and params[0] != arch:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
        srv = layout_server(run, dev=dev,
                            params=None if params is None else params[1])
        params = (arch, srv.params)
        prompts[run], sp = dist_workload(srv.cfg.vocab_size)
        ref[run] = warm_and_drive(srv, prompts[run], sp, warm_prompts=2,
                                  warm_runs=1)
        out["one_rank"][run] = {x: ref[run][x] for x in (
            "metrics", "launches", "decode_round_ms", "steps")}
        out["one_rank"][run]["weights_gb"] = params_gb(srv.params)
        del srv
        gc.collect()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["one_rank_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    ranks, out["world_s"] = run_world(layout_rank, world, backend, "p19_rank",
                                      P19_WORLD_S)
    for run in P19_RUNS:
        check_rank_streams("phase 19", run, ranks, ref[run]["streams"],
                           prompts[run], lambda r=run: layout_server(
                               r, dev=dev))
    for r in ranks:
        for run, need in P19_NEEDS.items():
            for k in need:
                if r[run]["launches"].get(k, 0) <= 0:
                    raise AssertionError(f"phase 19 {run}: rank "
                                         f"{r['rank']} launched no {k}")
        if dev.type == "cuda" and any(r["b_mamba2_chunked"]["launches"]
                                      .values()):
            raise AssertionError("phase 19 (b): mamba2 launched a kernel")
    out["ranks"] = ranks
    r0 = ranks[0]
    out["collective_share"] = {
        run: r0[P19_RUNS[run][0]]["collectives_ms"]["per_step"]
        / r0[run]["decode_round_ms"] for run in P19_RUNS}
    log.append(f"transport: {backend}; rank 0's shards: granite "
               f"{r0['granite-34b']['shard_gb']:.2f} GB carried over in "
               f"{r0['granite-34b']['transfer_s']:.1f} s, mamba2 "
               f"{r0['mamba2-130m']['shard_gb']:.3f} GB")
    return out


# ----------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import set_precision_policy
    from repro_torch.kernels import build
    set_precision_policy()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0], "gpu": smi}
    log: list = []

    t0 = time.monotonic()
    builds = build.build_all()
    report["build_s"] = time.monotonic() - t0
    print(f"phase 1: kernels built in {report['build_s']:.1f} s "
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in builds.items()))
    report["ptxas"] = {name: ptxas_report(b["log"])
                       for name, b in builds.items()}
    for name, fns in report["ptxas"].items():
        if not fns:
            continue
        worst = max(fns.items(), key=lambda kv: kv[1]["registers"])
        spills = {f: v for f, v in fns.items()
                  if v["spill_bytes"] or v["stack_bytes"]}
        h256 = ", ".join(f"{v['registers']}" for f, v in fns.items()
                         if "Li256E" in f and "combine" not in f)
        print(f"  {name}: {len(fns)} kernels, most registers "
              f"{worst[1]['registers']}; h=256 instances: {h256 or '-'} "
              f"registers; spills/stack: "
              + (", ".join(f"{f} {v}" for f, v in spills.items())
                 if spills else "none"))

    timer = Timer(dev)
    kern = check_kernels(dev, timer, log)
    kern.update(check_dense_kernels(dev, timer, log))
    kern.update(check_sparse_kernels(dev, timer, log))
    kern.update(check_moe_kernels(dev, timer, log))
    kern_q = check_quant_kernels(dev, timer, log)
    # the shapes of phase 13: h 256, G 48, the row-group edges
    wide, wide_q = check_wide_kernels(dev, timer, log)
    for name, by in wide.items():
        kern[name].update(by)
    # the shapes of phase 14: jamba in bfloat16
    for name, by in check_jamba_kernels(dev, timer, log).items():
        kern[name].update(by)
    for name, by in wide_q.items():
        for r in by.values():
            r["library"] = "dequant+sdpa"
        kern_q[name].update(by)
    # the head dims of phase 16: h 80 (hubert) and 96 (phi-3-vision)
    fr, fr_q = check_frontend_kernels(dev, timer, log)
    for name, by in fr.items():
        kern[name].update(by)
    for name, by in fr_q.items():
        kern_q[name].update(by)
    print(f"phase 2: kernels agree with their plain versions on the card "
          f"[{time.monotonic() - t0:.1f} s since the start]")
    for line in log:
        print("  " + line)
    for path, recs in (("", kern), (" int8", kern_q)):
        for name, by in recs.items():
            for dn, r in by.items():
                lib = "no library call" if r["library_ms"] is None else \
                    f"{r['library_ms']:.4f} ms " + r.get("library", (
                        "torch.bmm" if name == "moe_gmm" else "sdpa"))
                comp = "" if "composition_ms" not in r else \
                    f", {r['composition_ms']:.4f} ms eager composition"
                where = f"({r['shape']})" if "shape" in r else "main shape"
                print(f"  {name}{path} {dn} {where}: {r['ms']:.4f} ms "
                      f"kernel, {r['plain_ms']:.4f} ms plain{comp}, {lib}, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                      f"[{smi}]")
    log.clear()
    torch.cuda.empty_cache()

    cfg = full_width_config()
    served = serve(dev, log, cfg, timer=timer)
    on = served["reuse_on"]
    print(f"phase 3: full-width qwen2-1.5b served through the CUDA kernels "
          f"[{time.monotonic() - t0:.1f} s]")
    for line in log:
        print("  " + line)
    print(f"  chunks {served['prefill_chunks']} x {cfg.n_layers} = "
          f"{served['launches']['paged_prefill']} paged_prefill launches; "
          f"steps {served['decode_steps']} x {cfg.n_layers} = "
          f"{served['launches']['paged_decode']} paged_decode launches; "
          f"host_fetches {served['host_fetches']}")
    print(f"  TTFT mean {on['ttft_mean'] * 1e3:.2f} ms p99 "
          f"{on['ttft_p99'] * 1e3:.2f} ms [{smi}]")
    print(f"  TPOT mean {on['tpot_mean_ms']:.2f} ms p99 "
          f"{on['tpot_p99_ms']:.2f} ms [{smi}]")
    print(f"  output {on['ott_tok_s']:.1f} tok/s, total {on['ttt_tok_s']:.1f}"
          f" tok/s over {on['wall_s']:.2f} s [{smi}]")
    off = served["reuse_off"]
    print(f"  prefix reuse off: TTFT mean {off['ttft_mean'] * 1e3:.2f} ms, "
          f"TPOT mean {off['tpot_mean_ms']:.2f} ms, {off['ttt_tok_s']:.1f} "
          f"tok/s; greedy streams identical [{smi}]")
    print(f"  hot loops (reuse on): {hot_loop_line(served['hot_loops'])}; "
          f"host {served['host_s_per_round'] * 1e3:.2f} ms per decode round")
    print(f"  hot loops (reuse off): "
          f"{hot_loop_line(served['hot_loops_reuse_off'])}")
    dc = served["draw"]
    print(f"  a captured decode step of six slots (16-entry tables): "
          f"{dc['step_ms_greedy']:.4f} ms all greedy, "
          f"{dc['step_ms_sampled']:.4f} ms with one sampled slot: the draw "
          f"costs {dc['draw_cost_ms']:.4f} ms a step; the draw alone "
          f"{dc['draw_ms_greedy']:.4f} ms greedy (argmax) vs "
          f"{dc['draw_ms_sampled']:.4f} ms sampled (filter + threefry "
          f"Gumbel over 6 x {cfg.vocab_size}); sampled streams equal with "
          f"reuse on and off: {served['sampled_streams_equal_on_off']} "
          f"[{smi}]")
    log.clear()

    report["reduced"] = cross_check_reduced(dev, log)
    print(f"phase 4: [{time.monotonic() - t0:.1f} s]")
    for line in log:
        print("  " + line)
    log.clear()

    omni = serve_default_pattern(dev, log, cfg)
    print(f"phase 5 [{time.monotonic() - t0:.1f} s]: full-width qwen2-1.5b, "
          f"pattern=None "
          f"({omni['compressed_layers']} compressed + {omni['full_layers']} "
          f"full layers), whole-prompt prefill")
    for line in log:
        print("  " + line)
    for name, r in omni["layouts"].items():
        m, ln = r["metrics"], r["launches"]
        dec = "paged_decode" if name == "paged" else "sink_decode"
        print(f"  {name} KV: {r['whole_prefills']} whole prefills x "
              f"{cfg.n_layers} = {ln['flash_prefill']} flash_prefill "
              f"launches; {r['decode_steps']} steps x {cfg.n_layers} = "
              f"{ln[dec]} {dec} launches; host_fetches {r['host_fetches']}; "
              f"cache hits {r['cache_hits']}")
        print(f"  {name} KV: TTFT mean {m['ttft_mean'] * 1e3:.2f} ms p99 "
              f"{m['ttft_p99'] * 1e3:.2f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms, "
              f"{m['ott_tok_s']:.1f} output tok/s, {m['ttt_tok_s']:.1f} total "
              f"tok/s over {m['wall_s']:.2f} s [{smi}]")
        print(f"  {name} KV: hot loops: {hot_loop_line(r['hot_loops'])}; "
              f"host {r['host_s_per_round'] * 1e3:.2f} ms per decode round")
        full = r["hot_loops"]["prefill.full"]
        print(f"  {name} KV: {full['replays']} of {r['whole_prefills']} "
              f"whole prefills replayed from \"prefill.full\" graphs "
              f"({full['captures']} captured in this run, {full['eager']} "
              f"eager); TTFT of the three 16-token prompts "
              + ", ".join(f"{x:.2f}" for x in r["ttft_short_ms"])
              + f" ms [{smi}]")
        e = r["eager"]
        print(f"  {name} KV, capture=False: every stream (the sampled one "
              f"too) equal to the captured run's: "
              f"{e['streams_equal_captured']} (near-ties {e['near_ties']}); "
              f"TTFT mean {e['metrics']['ttft_mean'] * 1e3:.2f} ms, of the "
              f"16-token prompts "
              + ", ".join(f"{x:.2f}" for x in e["ttft_short_ms"])
              + f" ms; TPOT mean {e['metrics']['tpot_mean_ms']:.2f} ms "
              f"[{smi}]")
        print(f"  {name} KV: a bucket's second whole prefill (the capture "
              f"and first replay) {r['second_call_ms']['long']:.1f} ms at "
              f"{P5_MAX_LEN}, {r['second_call_ms']['short']:.1f} ms at "
              f"{P5_SHORT}; eagerly {e['second_call_ms']['long']:.1f} / "
              f"{e['second_call_ms']['short']:.1f} ms [{smi}]")
        for k, lab in (("short", P5_SHORT), ("long", P5_LONG)):
            c, g = (r["whole_prefill_ms"][x][k] for x in ("captured",
                                                          "eager"))
            print(f"  {name} KV: one whole {lab}-token prefill, in turns "
                  f"(n {c['n']} each): host {c['host_ms']:.3f} ms captured "
                  f"vs {g['host_ms']:.3f} ms eager, wall {c['wall_ms']:.3f} "
                  f"ms vs {g['wall_ms']:.3f} ms [{smi}]")
    print(f"  greedy streams identical across layouts: "
          f"{omni['greedy_streams_identical']} "
          f"(near-ties {omni['near_ties']})")

    log.clear()

    topk = serve_topk(dev, log, cfg)
    print(f"phase 6 [{time.monotonic() - t0:.1f} s]: full-width qwen2-1.5b, "
          f"28 full layers, online top-k "
          f"over a {topk['table_width']}-wide table")
    for line in log:
        print("  " + line)
    for name, r in topk["runs"].items():
        m, ln = r["metrics"], r["launches"]
        sel = "" if not r["blocks_scored"] else (
            f"; blocks attended/scored {r['blocks_attended']}/"
            f"{r['blocks_scored']} = "
            f"{r['blocks_attended'] / r['blocks_scored']:.4f}")
        mass = "" if r["attn_mass_kept"] is None or \
            r["attn_mass_kept"] != r["attn_mass_kept"] else \
            f"; attn_mass_kept {r['attn_mass_kept']:.4f}"
        print(f"  {name}: {r['decode_steps']} steps x {cfg.n_layers} = "
              f"{ln['paged_decode']} paged_decode, {ln['block_topk']} "
              f"block_topk launches; host_fetches {r['host_fetches']}"
              f"{sel}{mass}")
        print(f"  {name}: TTFT mean {m['ttft_mean'] * 1e3:.2f} ms p99 "
              f"{m['ttft_p99'] * 1e3:.2f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms, "
              f"{m['ttt_tok_s']:.1f} total tok/s over {m['wall_s']:.2f} s "
              f"[{smi}]")
        print(f"  {name}: hot loops: {hot_loop_line(r['hot_loops'])}; host "
              f"{r['host_s_per_round'] * 1e3:.2f} ms per decode round")
    print(f"  greedy streams with a budget of width - 1 equal top-k off: "
          f"True; top-k 0.25 streams equal top-k off: "
          f"{topk['frac_streams_equal_off']}/6")
    log.clear()

    spec = serve_spec(dev, log, cfg)
    print(f"phase 7 [{time.monotonic() - t0:.1f} s]: full-width qwen2-1.5b, "
          f"SpecPlane speculation k=4")
    for line in log:
        print("  " + line)
    for name, r in spec["runs"].items():
        m, sp = r["metrics"], r["spec"]
        print(f"  {name}: {r['decode_steps']} steps, "
              f"{r['launches']['spec_verify']} spec_verify + "
              f"{r['launches']['paged_decode']} paged_decode launches, "
              f"host_fetches {r['host_fetches']}; drafts accepted "
              f"{sp['spec_accepted']}/{sp['spec_drafted']} "
              f"(acceptance {sp['draft_acceptance']:.4f}), tokens per "
              f"verify {sp['tokens_per_verify']:.3f}")
        print(f"  {name}: TTFT mean {m['ttft_mean'] * 1e3:.2f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms, "
              f"{m['ott_tok_s']:.1f} output tok/s over {m['wall_s']:.2f} s "
              f"[{smi}]")
        print(f"  {name}: hot loops: {hot_loop_line(r['hot_loops'])}; host "
              f"{r['host_s_per_round'] * 1e3:.2f} ms per decode round")
    print(f"  streams identical with speculation on and off: "
          f"{spec['streams_identical']} (near-ties {spec['near_ties']})")

    log.clear()

    # phase 8 runs once the earlier phases' servers and weights are gone
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = moe_full_config()
    moe = serve_moe(dev, log, mcfg)
    m, ln = moe["metrics"], moe["launches"]
    print(f"phase 8 [{time.monotonic() - t0:.1f} s]: full-width "
          f"qwen2-moe-a2.7b ({mcfg.n_layers} MoE layers, 60 experts top-4 "
          f"+ 4 shared, float32, {moe['weights_gb']:.2f} GB of weights), "
          f"OmniPlacement monitor every 4 decode rounds")
    for line in log:
        print("  " + line)
    print(f"  (a) chunks {moe['prefill_chunks']}, steps "
          f"{moe['decode_steps']}: {ln['moe_gmm']} moe_gmm = 3 x "
          f"{mcfg.n_layers} x (chunks + steps), {ln['paged_prefill']} "
          f"paged_prefill, {ln['paged_decode']} paged_decode launches; "
          f"host_fetches {moe['host_fetches']}; reused tokens "
          f"{moe['reused_tokens']}")
    print(f"  (a) {len(moe['placement_ticks'])} placement ticks, each drain "
          f"= top_k x {mcfg.n_layers} x decode tokens since the last: "
          + ", ".join(f"{t['assignments']:.0f}"
                      for t in moe["placement_ticks"])
          + f"; rebalances {moe['rebalances']} (ep = 1)")
    print(f"  (a) TTFT mean {m['ttft_mean'] * 1e3:.2f} ms p99 "
          f"{m['ttft_p99'] * 1e3:.2f} ms, TPOT mean {m['tpot_mean_ms']:.2f} "
          f"ms p99 {m['tpot_p99_ms']:.2f} ms, {m['ott_tok_s']:.1f} output "
          f"tok/s, {m['ttt_tok_s']:.1f} total tok/s over {m['wall_s']:.2f} "
          f"s; peak memory {moe['peak_mem_gb']:.2f} GB [{smi}]")
    mg = moe["migration"]
    print(f"  (b) slot order reversed at decode step {mg['at_step']} in "
          f"{mg['seconds']:.3f} s: greedy streams identical to (a) bit for "
          f"bit; sampled streams identical "
          f"{mg['sampled_streams_identical']} [{smi}]")
    print(f"  (a) hot loops: {hot_loop_line(moe['hot_loops'])}; host "
          f"{moe['host_s_per_round'] * 1e3:.2f} ms per decode round")
    print(f"  (b) hot loops: {hot_loop_line(mg['hot_loops'])}")

    log.clear()

    # phase 9 runs once phase 8's MoE weights are gone
    gc.collect()
    torch.cuda.empty_cache()
    quant = serve_quant(dev, log, cfg)
    qm, ql = quant["metrics"], quant["launches"]
    print(f"phase 9 [{time.monotonic() - t0:.1f} s]: full-width qwen2-1.5b "
          f"on int8 arenas (QuantPlane), 28 full layers")
    for line in log:
        print("  " + line)
    print(f"  (a) chunks {quant['prefill_chunks']} x {cfg.n_layers} = "
          f"{ql['paged_prefill']['int8_launches']} int8 paged_prefill "
          f"launches; steps {quant['decode_steps']} x {cfg.n_layers} = "
          f"{ql['paged_decode']['int8_launches']} int8 paged_decode "
          f"launches; host_fetches {quant['host_fetches']}; block bytes "
          f"{quant['block_nbytes']['int8']} / "
          f"{quant['block_nbytes']['float32']} = "
          f"{quant['block_nbytes']['ratio']:.4f}; quant_block_bytes "
          f"{quant['quant_stats']['quant_block_bytes']}")
    print(f"  (a) TTFT mean {qm['ttft_mean'] * 1e3:.2f} ms p99 "
          f"{qm['ttft_p99'] * 1e3:.2f} ms, TPOT mean {qm['tpot_mean_ms']:.2f}"
          f" ms p99 {qm['tpot_p99_ms']:.2f} ms, {qm['ott_tok_s']:.1f} output "
          f"tok/s over {qm['wall_s']:.2f} s; float32 server on the same "
          f"traffic: TTFT mean {quant['f32_metrics']['ttft_mean'] * 1e3:.2f}"
          f" ms, TPOT mean {quant['f32_metrics']['tpot_mean_ms']:.2f} ms "
          f"[{smi}]")
    for name, r in quant["spec"].items():
        m, sp = r["metrics"], r["spec"]
        print(f"  (b) {name}: {r['decode_steps']} steps, "
              f"{r['launches']['spec_verify']['int8_launches']} int8 "
              f"spec_verify + {r['launches']['paged_decode']['int8_launches']}"
              f" int8 paged_decode launches; drafts accepted "
              f"{sp['spec_accepted']}/{sp['spec_drafted']}; TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms [{smi}]")
    print(f"  (b) streams equal with speculation on and off (near-ties "
          f"{quant['spec_near_ties']}); (c) {quant['preemption']}")
    print(f"  (a) hot loops: {hot_loop_line(quant['hot_loops'])}; host "
          f"{quant['host_s_per_round'] * 1e3:.2f} ms per decode round; "
          f"float32 server: {hot_loop_line(quant['hot_loops_f32'])}")
    for name, r in quant["spec"].items():
        print(f"  (b) {name}: hot loops: {hot_loop_line(r['hot_loops'])}")
    log.clear()

    gc.collect()
    torch.cuda.empty_cache()
    eager = serve_eager(dev, log, cfg, served, spec, quant)
    print(f"phase 10 [{time.monotonic() - t0:.1f} s]: phases 3, 7 (spec "
          f"on) and 9 (a) again with capture=False")
    for line in log:
        print("  " + line)
    for name, r in eager.items():
        c, e = r["captured"], r["eager"]
        print(f"  {name}: greedy streams equal bit for bit, sampled "
              f"{r['sampled_streams_equal']}; one step's logits, captured "
              f"vs eager: max |diff| {r['logits_max_abs_diff']:.3g}; TPOT "
              f"mean {c['tpot_mean_ms']:.2f} ms captured / "
              f"{e['tpot_mean_ms']:.2f} ms eager; host "
              f"{c['host_s_per_round'] * 1e3:.2f} / "
              f"{e['host_s_per_round'] * 1e3:.2f} ms per decode round "
              f"({c['steps']} / {e['steps']} steps) [{smi}]")
        ch = r["chunk"]
        cc, ce = ch["captured"], ch["eager"]
        print(f"  {name}: prefill.chunk: one chunk's logits, captured vs "
              f"eager: max |diff| {ch['logits_max_abs_diff']:.3g}; host "
              f"{cc['host_ms_per_chunk']:.2f} / {ce['host_ms_per_chunk']:.2f}"
              f" ms per chunk in prefill rounds ({cc['chunks']} / "
              f"{ce['chunks']} chunks); aten ops per chunk "
              f"{cc['aten_ops']['mean']:.1f} / {ce['aten_ops']['mean']:.1f} "
              f"(captured / eager) [{smi}]")

    log.clear()

    gc.collect()
    torch.cuda.empty_cache()
    rings = serve_ring_chunks(dev, log, cfg, timer)
    print(f"phase 11 [{time.monotonic() - t0:.1f} s]: full-width qwen2-1.5b, "
          f"pattern=None with prefill_sparse ({rings['full_layers']} full "
          f"layers), chunks of 128 over the rings")
    for line in log:
        print("  " + line)
    for name, r in rings["runs"].items():
        m, ln = r["metrics"], r["launches"]
        work = (f"{r['chunks']} chunks: {ln['paged_prefill']} paged_prefill "
                f"launches" if r["chunks"] else
                f"{r['whole_prefills']} whole prefills: "
                f"{ln['flash_prefill']} flash_prefill launches")
        dec = "paged_decode" if ln["paged_decode"] else "sink_decode"
        print(f"  {name}: {work}; {r['decode_steps']} steps: {ln[dec]} "
              f"{dec} launches; host_fetches {r['host_fetches']}; cache hits "
              f"{r['cache_hits']}")
        print(f"  {name}: TTFT mean {m['ttft_mean'] * 1e3:.2f} ms p99 "
              f"{m['ttft_p99'] * 1e3:.2f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms, {m['ttt_tok_s']:.1f} total tok/s "
              f"over {m['wall_s']:.2f} s; host in prefill rounds "
              f"{r['prefill_host_s']:.3f} s [{smi}]")
        if r["chunks"]:
            print(f"  {name}: host {r['host_ms_per_chunk']:.2f} ms per chunk;"
                  f" private-leaf copies in and out "
                  f"{r['leaf_copy_bytes'] / 1e6:.1f} MB in "
                  f"{r['leaf_copy_ms']:.4f} ms device time [{smi}]")
        print(f"  {name}: hot loops: {hot_loop_line(r['hot_loops'])}")
    print(f"  greedy streams identical across paged chunks, dense chunks "
          f"and whole-prompt prefill: {rings['greedy_streams_identical']} "
          f"(near-ties {rings['near_ties']}); sampled stream equal "
          f"{rings['sampled_streams_equal']}")

    log.clear()

    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.monotonic()
    chaos = serve_chaos(dev, log, cfg, timer, served["streams"])
    print(f"phase 12 [{time.monotonic() - t0:.1f} s]: full-width qwen2-1.5b, "
          f"28 full layers, FaultPlane chaos over 2 prefill + 2 decode "
          f"instances in {time.monotonic() - t12:.1f} s")
    for line in log:
        print("  " + line)
    for name in ("a", "b", "c"):
        r, ff = chaos[name], chaos[name]["fault_free"]
        rec_ms = [x * 1e3 for run in r["runs"].values()
                  for x in run["recover_s"]]
        walls = ", ".join(f"{run['wall_s']:.3f}"
                          for run in r["runs"].values())
        print(f"  ({name}) summary scan {r['scan_ms']:.4f} ms device time "
              f"({'int8' if name == 'c' else 'float32'} arena, "
              f"{cfg.n_layers} layers x 321 blocks); recover_corruption "
              + (f"median {float(np.median(rec_ms)):.2f} ms, max "
                 f"{max(rec_ms):.2f} ms over {len(rec_ms)} calls"
                 if rec_ms else "not called")
              + f"; walls fault-free {ff['wall_s']:.3f} s / chaos {walls} s "
              f"[{smi}]")
        print(f"  ({name}) fault-free hot loops: "
              f"{hot_loop_line(ff['hot_loops'])} (phase 3, 1P/1D: "
              f"{served['hot_loops']['pool_gb']:.3f} GB)")
    print(f"  (a) kinds fired over seeds {P12_SEEDS['a']}: {chaos['a_fired']};"
          f" 2P/2D greedy streams equal phase 3's 1P/1D streams; sampled "
          f"{chaos['a']['fault_free']['sampled_equal_phase3']}")

    log.clear()

    gc.collect()
    torch.cuda.empty_cache()
    t13 = time.monotonic()
    archs = serve_archs(dev, log)
    g3_s = archs["gemma3-4b"]["seconds"] if "gemma3-4b" in archs else 0.0
    print(f"phase 13 [{time.monotonic() - t0:.1f} s]: the other four "
          f"decoders at full width in {time.monotonic() - t13:.1f} s "
          f"(gemma3-4b {P13_DEPTH['gemma3-4b']} of "
          f"{G3_LAYERS_PUBLISHED} layers; qwen3-32b, granite-34b "
          f"{P13_DEPTH['granite-34b']} layers, "
          f"qwen3-moe-235b-a22b {P13_DEPTH['qwen3-moe-235b-a22b']}); the "
          f"gemma3-4b cut saves about "
          f"{g3_s * (G3_LAYERS_PUBLISHED / P13_DEPTH['gemma3-4b'] - 1):.1f}"
          f" s (its {g3_s:.1f} s reckoned by depth to "
          f"{G3_LAYERS_PUBLISHED} layers, not measured)")
    for line in log:
        print("  " + line)
    for arch, rec in archs.items():
        parts = [f"{rec['weights_gb']:.2f} GB of weights, peak "
                 f"{rec['peak_mem_gb']:.2f} GB, {rec['seconds']:.1f} s"]
        if "runs" in rec:
            a = rec["runs"]["a_reuse_on"]
            parts.append(f"(a) TTFT mean {a['metrics']['ttft_mean'] * 1e3:.1f}"
                         f" ms, TPOT mean {a['metrics']['tpot_mean_ms']:.2f} "
                         f"ms, graph pool {a['hot_loops']['pool_gb']:.3f} GB;"
                         f" near-ties {rec['near_ties']}")
        if "serve" in rec:
            s = rec["serve"]
            parts.append(f"phase 3's traffic: {s['prefill_chunks']} chunks, "
                         f"{s['decode_steps']} steps, TTFT mean "
                         f"{s['reuse_on']['ttft_mean'] * 1e3:.1f} ms, TPOT "
                         f"mean {s['reuse_on']['tpot_mean_ms']:.2f} ms, "
                         f"reuse on/off streams equal")
        if "spec" in rec:
            on = rec["spec"]["runs"]["spec_on"]
            parts.append(f"spec on: {on['launches']['spec_verify']} "
                         f"spec_verify, {on['launches']['moe_gmm']} moe_gmm "
                         f"launches, decode.verify replays "
                         f"{on['hot_loops']['decode.verify']['replays']}, "
                         f"accepted {on['spec']['spec_accepted']}/"
                         f"{on['spec']['spec_drafted']}; streams equal spec "
                         f"off (near-ties {rec['spec']['near_ties']})"
                         + ("" if "spec_serving_capacity" not in rec else
                            f" at capacity factor {MOE3_NODROP_CF}; at the "
                            f"serving capacity "
                            f"{len(rec['spec_serving_capacity']['differ'])}"
                            f" streams differ: "
                            f"{rec['spec_serving_capacity']['differ']}"))
        if "topk" in rec and "runs" in rec["topk"]:
            b = rec["topk"]["runs"]["b_frac"]
            parts.append(f"top-k 0.25: blocks attended/scored "
                         f"{b['blocks_attended']}/{b['blocks_scored']}; a "
                         f"budget of width - 1 equals top-k off")
        if "moe" in rec:
            m = rec["moe"]
            parts.append(f"phase 8's knobs: TPOT mean "
                         f"{m['metrics']['tpot_mean_ms']:.2f} ms, TTFT mean "
                         f"{m['metrics']['ttft_mean'] * 1e3:.1f} ms, "
                         f"{m['launches']['moe_gmm']} "
                         f"moe_gmm launches, drains "
                         + ", ".join(f"{t['assignments']:.0f}"
                                     for t in m["placement_ticks"])
                         + f"; forced migration at step "
                         f"{m['migration']['at_step']}, greedy streams "
                         f"identical")
        print(f"  {arch}: " + "; ".join(parts) + f" [{smi}]")

    log.clear()

    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.monotonic()
    mamba2 = serve_mamba2(dev, log, timer)
    jamba = serve_jamba(dev, log)
    print(f"phase 14 [{time.monotonic() - t0:.1f} s]: the SSM and hybrid "
          f"stacks in {time.monotonic() - t14:.1f} s (mamba2-130m all 24 "
          f"layers, float32; jamba-1.5-large-398b 5 layers, bfloat16)")
    for line in log:
        print("  " + line)
    mr = mamba2["runs"]
    for name in ("a_reuse_on", "a_reuse_off", "a_eager", "c_quant_degraded",
                 "b_chunked_paged", "b_whole_dense"):
        r = mr[name]
        m = r["metrics"]
        print(f"  mamba2 {name}: {r['chunks']} chunks, {r['whole_prefills']}"
              f" whole prefills, {r['steps']} steps, no kernel launched; "
              f"TTFT mean {m['ttft_mean'] * 1e3:.2f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms; "
              f"hot loops: {hot_loop_line(r['hot_loops'])} [{smi}]")
    for what, c in mamba2["captured"].items():
        print(f"  mamba2 captured {what} vs eager: max |logits diff| "
              f"{c['logits_max_abs_diff']:.3g}; device {c['ms']:.4f} ms = "
              f"SSD {c['ssd_ms']:.4f} + GEMM {c['gemm_ms']:.4f} + rest "
              f"{c['rest_ms']:.4f} ms (SSD share {c['ssd_share']:.3f}) "
              f"[{smi}]")
    ch = mamba2["chaos"]
    for name, r in (("fault-free", ch["fault_free"]),
                    (f"seed {P14_CHAOS_SEED}", ch["run"])):
        m = r["metrics"]
        extra = "" if r["injected"] is None else (
            f"; injected {r['injected']}, skipped {r['skipped']}; retries "
            f"{r['retries']}, blocks quarantined {r['quarantined']}, "
            f"handoffs swept {r['handoffs_swept']}, re-prefilled chunks "
            f"{r['reprefilled_chunks']}")
        print(f"  mamba2 (d) chaos, 2 prefill + 2 decode, {name}: "
              f"{r['server_steps']} server steps, {r['chunks']} chunks, "
              f"{r['decode_steps']} decode steps, no kernel launched{extra};"
              f" wall {r['wall_s']:.3f} s, TTFT mean "
              f"{m['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms [{smi}]")
    print(f"  mamba2 (d): chaos streams equal the fault-free streams; horizon"
          f" {ch['horizon']}; {ch['seconds']:.1f} s [{smi}]")
    print(f"  mamba2: weights {mamba2['weights_gb']:.2f} GB, state "
          f"{mamba2['state_bytes_per_slot'] / 1e6:.2f} MB a slot, peak "
          f"{mamba2['peak_mem_gb']:.2f} GB, {mamba2['seconds']:.1f} s; "
          f"streams equal reuse on/off, captured/eager, quant knob; long "
          f"near-ties {len(mamba2['long_near_ties'])}; speculation refused: "
          f"{mamba2['spec_refused']!r} [{smi}]")
    jr = jamba["runs"]
    for name, r in jr.items():
        m, ln = r["metrics"], r["launches"]
        extra = "" if "placement_ticks" not in r else (
            "; drains " + ", ".join(f"{t['assignments']:.0f}"
                                    for t in r["placement_ticks"]))
        print(f"  jamba {name}: {r['chunks']} chunks, {r['whole_prefills']}"
              f" whole prefills, {r['steps']} steps; launches "
              f"{ {k: v for k, v in ln.items() if v} }{extra}; TTFT mean "
              f"{m['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms "
              f"[{smi}]")
    print(f"  jamba: weights {jamba['weights_gb']:.2f} GB, state "
          f"{jamba['state_bytes_per_slot'] / 1e6:.2f} MB a slot, peak "
          f"{jamba['peak_mem_gb']:.2f} GB, {jamba['seconds']:.1f} s; int8 "
          f"streams equal float {jamba['int8_streams_equal_float']}/14; "
          f"default pattern near-ties {len(jamba['default_near_ties'])} "
          f"[{smi}]")

    log.clear()

    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.monotonic()
    trained = train_phase(dev, log)
    print(f"phase 15 [{time.monotonic() - t0:.1f} s]: training on the card "
          f"in {time.monotonic() - t15:.1f} s (no kernel launched by a "
          f"train step)")
    for line in log:
        print("  " + line)
    q = trained["qwen2"]
    print(f"  (a) qwen2-1.5b, bfloat16, remat, batch 8 x seq 128: step "
          f"{q['step_ms']:.2f} ms (first {q['first_step_ms']:.0f} ms), "
          f"{q['tokens_per_s']:.0f} tokens/s, peak {q['peak_mem_gb']:.2f} GB"
          f" (drill with its save {q['peak_mem_gb_drill']:.2f} GB); losses "
          + ", ".join(f"{x:.4f}" for x in q["losses"])
          + f"; drill steps equal the uninterrupted run's: "
          f"{q['drill_equal_uninterrupted']}, resumed steps "
          f"{P15_PREEMPT}-{P15_STEPS - 1} bit-equal: "
          f"{q['resume_bit_equal']}; checkpoint {q['ckpt_bytes'] / 1e9:.2f}"
          f" GB, save {q['save_s'][0]:.2f} s, restore {q['restore_s'][0]:.2f}"
          f" s [{smi}]")
    b = q["breakdown"]
    print(f"  (a) a step's parts: loss + gradients {b['grad_ms']:.1f} ms "
          f"(host enqueue {b['grad_host_ms']:.1f}), AdamW "
          f"{b['update_ms']:.1f} ms (host {b['update_host_ms']:.1f}); the "
          f"bound of a step {q['bound_ms']:.2f} ms (8 x parameters x "
          f"tokens at the bfloat16 rate) [{smi}]")
    print(f"  (b) step {P15_PREEMPT} restored ({q['restore_params_s']:.2f} s,"
          f" parameters only) bit-equal to the saved parameters; greedy and "
          f"sampled streams from it equal the in-memory ones; "
          + "; ".join(f"{k}: TTFT mean {v['ttft_mean'] * 1e3:.1f} ms, TPOT "
                      f"mean {v['tpot_mean_ms']:.2f} ms, launches "
                      f"{v['launches']}" for k, v in q["served"].items())
          + f" [{smi}]")
    mm = trained["mamba2"]
    print(f"  (c) mamba2-130m, bfloat16, remat, batch {P15_MAMBA[0]} x seq "
          f"{P15_MAMBA[1]}: step {mm['step_ms']:.2f} ms, "
          f"{mm['tokens_per_s']:.0f} tokens/s, peak {mm['peak_mem_gb']:.2f} "
          f"GB; losses " + ", ".join(f"{x:.4f}" for x in mm["losses"])
          + f"; one step remat on / off: loss equal, gradient norm bit-equal "
          f"{mm['remat_grad_norm_bit_equal']}, {mm['remat_on']['ms']:.1f} / "
          f"{mm['remat_off']['ms']:.1f} ms, peak "
          f"{mm['remat_on']['peak_mem_gb']:.2f} / "
          f"{mm['remat_off']['peak_mem_gb']:.2f} GB [{smi}]")
    mo = trained["moe"]
    print(f"  (d) qwen2-moe-a2.7b, {mo['n_layers']} of "
          f"{mo['n_layers_published']} layers ({mo['n_params'] / 1e9:.2f} B "
          f"parameters), bfloat16, grad_accum 2, batch 8 x seq 128: step "
          f"{mo['step_ms']:.1f} ms, {mo['tokens_per_s']:.0f} tokens/s, peak "
          f"{mo['peak_mem_gb']:.2f} GB; losses "
          + ", ".join(f"{r['loss']:.4f}" for r in mo["steps"])
          + f"; router, expert and shared-expert gradients nonzero [{smi}]")
    cc = trained["card_vs_cpu"]
    print(f"  (e) reduced qwen2-1.5b float32, one step: loss card "
          f"{cc['card']['loss']:.6f} / CPU {cc['cpu']['loss']:.6f}, "
          f"gradient norm {cc['card']['grad_norm']:.6f} / "
          f"{cc['cpu']['grad_norm']:.6f} (relative "
          f"{cc['rel_diff']['loss']:.2e}, {cc['rel_diff']['grad_norm']:.2e})")
    log.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t16 = time.monotonic()
    fronts = frontend_phase(dev, log)
    print(f"phase 16 [{time.monotonic() - t0:.1f} s]: the frontend families "
          f"at full width in {time.monotonic() - t16:.1f} s")
    for line in log:
        print("  " + line)
    fv, fa, ft = fronts["vlm"], fronts["audio"], fronts["train_audio"]
    print(f"  (a) phi-3-vision-4.2b, float32, 32 layers: prefill of "
          f"{fv['rows']} rows (256 patches + {P16_TOKENS} tokens) "
          + " / ".join(f"{x:.1f}" for x in fv["prefill_ms"])
          + f" ms, {fv['prefill_launches']} flash_prefill launches each; "
          f"B 2 decode {fv['decode_ms_median']:.2f} ms a step (median of "
          f"steps 2-{P16_NEW}; first {fv['decode_ms'][0]:.2f} ms), "
          f"{fv['decode_launches_per_step']} sink_decode launches a step; "
          f"peak {fv['peak_mem_gb']:.2f} GB [{smi}]")
    print(f"  (b) hubert-xlarge, float32, 48 layers: {P16_CLIPS} clips x "
          f"{P16_FRAMES} frames in one batch, "
          + " / ".join(f"{x:.1f}" for x in fa["ms"])
          + f" ms a forward, {fa['launches']} flash_prefill launches each; "
          f"peak {fa['peak_mem_gb']:.2f} GB [{smi}]")
    print(f"  (d) launch/train.py hubert-xlarge, bfloat16, batch "
          f"{P16_TRAIN[0]} x {P16_TRAIN[1]} frames: step {ft['step_ms']:.1f}"
          f" ms (first {ft['first_step_ms']:.0f} ms), peak "
          f"{ft['peak_mem_gb']:.2f} GB, losses "
          + ", ".join(f"{x:.4f}" for x in ft["losses"])
          + f"; kernel launches {ft['launches'] or 'none'} [{smi}]")
    log.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t17 = time.monotonic()
    dist17 = dist_phase(dev, timer, log)
    r0 = dist17["ranks"][0]
    print(f"phase 17 [{time.monotonic() - t0:.1f} s]: full-width "
          f"qwen2-moe-a2.7b over (tp {P17_TP}, ep {P17_EP}), one process a "
          f"rank, {dist17['layers']} of 24 layers, {dist17['dtype']}, in "
          f"{time.monotonic() - t17:.1f} s (the world "
          f"{dist17['world_s']:.1f} s)")
    for line in log:
        print("  " + line)
    for name, what in (("a_chunked", "(a) chunked paged prefill"),
                       ("b_whole", "(b) whole-prompt prefill")):
        m, m1 = r0[name]["metrics"], dist17["one_rank"][name]["metrics"]
        ln = {k: v for k, v in r0[name]["launches"].items() if v}
        print(f"  {what}: 8 prompts x {P17_NEW} greedy tokens, streams of "
              f"all four ranks equal the one-rank Server's; rank 0 launches "
              f"{ln}; TTFT mean {m['ttft_mean'] * 1e3:.1f} ms p99 "
              f"{m['ttft_p99'] * 1e3:.1f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms, "
              f"decode round {r0[name]['decode_round_ms']:.2f} ms (one rank: "
              f"TTFT mean {m1['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m1['tpot_mean_ms']:.2f} ms, decode round "
              f"{dist17['one_rank'][name]['decode_round_ms']:.2f} ms) [{smi}]")
    cm = r0["collectives_ms"]
    print(f"  collectives ({dist17['backend']}), timed alone at a 4-slot "
          f"decode step's shapes on rank 0: all_to_all "
          f"{cm['a2a']:.3f} ms a call ({cm['a2a_bytes'] / 1e6:.2f} MB), "
          f"{cm['a2a_per_moe_layer']:.3f} ms a MoE layer (dispatch + "
          f"combine + counts); a 128-token chunk's all_to_all "
          f"{cm['a2a_chunk']:.3f} ms ({cm['a2a_chunk_bytes'] / 1e6:.2f} MB);"
          f" psum {cm['psum_attn']:.3f} ms, y gather {cm['gather_y']:.3f} "
          f"ms, logits gather {cm['gather_logits']:.3f} ms; "
          f"{cm['per_step']:.2f} ms a decode step = "
          f"{dist17['collective_share']:.3f} of rank 0's "
          f"{r0['a_chunked']['decode_round_ms']:.2f} ms decode round "
          f"[{smi}]")
    mig = r0["c_migrate"]
    print(f"  (c) forced migration at decode step {mig['at_step']} (slots "
          f"0-1 of ranks 0 and 1 trade experts): "
          f"{mig['migration']['seconds']:.3f} s, "
          f"{mig['migration']['bytes'] / 1e6:.1f} MB moved between ranks; "
          f"streams equal (a)'s on every rank [{smi}]")
    for run, what in (("d_quant", "(d) int8 arenas, chunked"),
                      ("e_spec", f"(e) SpecConfig(k={P7_K})"),
                      ("f_quant_spec", "(f) int8 arenas + speculation")):
        pr, r1 = dist17["planes"][run], dist17["one_rank"][run]
        m, m1 = r0[run]["metrics"], r1["metrics"]
        ln = {k: v for k, v in r0[run]["launches"].items() if v}
        ds, ds1 = pr["decode_stats"], pr["one_rank_decode_stats"]
        figs = []
        if "spec_verifies" in ds:
            figs.append("spec drafted/accepted/emitted/verifies " + "/".join(
                str(ds[k]) for k in ("spec_drafted", "spec_accepted",
                                     "spec_emitted", "spec_verifies"))
                + " on every rank (one rank " + "/".join(
                    str(ds1[k]) for k in ("spec_drafted", "spec_accepted",
                                          "spec_emitted", "spec_verifies"))
                + ")")
        if "quant_block_bytes" in ds:
            figs.append(f"quant_block_bytes {ds['quant_block_bytes']} / f32 "
                        f"{ds['quant_block_bytes_f32']} a rank (one rank "
                        f"{ds1['quant_block_bytes']} / "
                        f"{ds1['quant_block_bytes_f32']})")
        print(f"  {what}: streams of all four ranks equal the one-rank "
              f"Server's ({len(pr['near_ties'])} int8 near-ties below "
              f"{P17_INT8_TIE}); " + "; ".join(figs)
              + f"; at capacity factor {pr['capacity_factor']} the "
              f"capacity cut dropped {pr['drops']} assignments a rank (one "
              f"rank {pr['one_rank_drops']}); rank 0 launches {ln}; TTFT mean "
              f"{m['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms, decode round "
              f"{r0[run]['decode_round_ms']:.2f} ms, peak "
              f"{r0[run]['peak_mem_gb']:.2f} GB (one rank: TTFT mean "
              f"{m1['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m1['tpot_mean_ms']:.2f} ms, decode round "
              f"{r1['decode_round_ms']:.2f} ms, peak "
              f"{r1['peak_mem_gb']:.2f} GB) [{smi}]")
    ch, g1 = dist17["chaos"], dist17["one_rank"]["g_chaos"]
    print(f"  (g) FaultPlane over the ranks, 2 prefill + 2 decode at "
          f"capacity factor {P17_SPEC_CF}, seed {P17_CHAOS_SEED}, horizon "
          f"{ch['ranks'][0]['horizon']}: every rank's fault-free streams "
          f"equal the one-rank Server's ({g1['server_steps']} server steps, "
          f"wall {g1['wall_s']:.3f} s), the chaos streams equal the "
          f"fault-free streams on every rank, the planes fired the same "
          f"{len(ch['fired'])} faults on every rank: {ch['fired']} [{smi}]")
    for c in ch["ranks"]:
        print(f"  (g) rank {c['rank']}: injected "
              f"{ {k: v for k, v in c['injected'].items() if v} }, skipped "
              f"{ {k: v for k, v in c['skipped'].items() if v} }; blocks "
              f"quarantined {c['quarantined']}, retries {c['retries']}, "
              f"handoffs swept {c['handoffs_swept']}; recover_corruption "
              f"host ms (world reduction included) "
              + ", ".join(f"{x:.2f}" for x in c["recover_ms"])
              + f"; pmax_world of the [{c['mask_len']}] mask alone "
              f"{c['pmax_world_ms']:.3f} ms ({dist17['backend']}); server "
              f"steps fault-free / chaos {c['server_steps'][0]} / "
              f"{c['server_steps'][1]}, walls {c['walls'][0]:.3f} / "
              f"{c['walls'][1]:.3f} s [{smi}]")
    print(f"  peak memory per rank "
          + ", ".join(f"{r['peak_mem_gb']:.2f}" for r in dist17["ranks"])
          + f" GB (shards {r0['shard_gb']:.2f} GB each with the whole model"
          f" built one rank at a time); one-rank Server peak "
          f"{dist17['one_rank_peak_gb']:.2f} GB [{smi}]")
    log.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t18 = time.monotonic()
    dist18 = omni_dist_phase(dev, timer, log)
    q0 = dist18["ranks"][0]
    print(f"phase 18 [{time.monotonic() - t0:.1f} s]: full-width "
          f"qwen2-moe-a2.7b at its default pattern ({P18_LAYERS * 3 // 4} "
          f"rings of sink 128 + recent 4,096, {P18_LAYERS // 4} full, "
          f"{P18_LAYERS} of 24 layers, float32) over (tp "
          f"{P18_TP}, ep {P18_EP}), {dist18['backend']}, in "
          f"{time.monotonic() - t18:.1f} s (the world "
          f"{dist18['world_s']:.1f} s)")
    for line in log:
        print("  " + line)
    for case, what in (("a_ring_paged", "(a) chunked prefill, paged ring "
                        "runs"), ("b_whole_dense", "(b) whole prompts, "
                                  "slot-dense"),
                       ("c_topk", f"(c) (a) + top-k frac {P18_TOPK_FRAC}")):
        m, m1 = q0[case]["metrics"], dist18["one_rank"][case]["metrics"]
        ln = {k: v for k, v in q0[case]["launches"].items() if v}
        extra = (f"; blocks scored / attended {m['blocks_scored']} / "
                 f"{m['blocks_attended']} on every rank and one rank"
                 if case == "c_topk" else "")
        print(f"  {what}: {len(P18_TAILS)} prompts of "
              f"{P18_PREFIX + P18_TAILS[0]}-{P18_PREFIX + P18_TAILS[-1]} "
              f"tokens x {P18_NEW} greedy tokens, streams of all four ranks "
              f"equal the one-rank Server's{extra}; rank 0 launches {ln}; "
              f"TTFT mean {m['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms, decode round "
              f"{q0[case]['decode_round_ms']:.2f} ms (one rank: TTFT mean "
              f"{m1['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m1['tpot_mean_ms']:.2f} ms, decode round "
              f"{dist18['one_rank'][case]['decode_round_ms']:.2f} ms) "
              f"[{smi}]")
    print(f"  peak memory per rank "
          + ", ".join(f"{r['peak_mem_gb']:.2f}" for r in dist18["ranks"])
          + f" GB [{smi}]")
    log.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t19 = time.monotonic()
    dist19 = layout_dist_phase(dev, timer, log)
    l0 = dist19["ranks"][0]
    print(f"phase 19 [{time.monotonic() - t0:.1f} s]: over (tp {P19_TP}, ep "
          f"{P19_EP}), {dist19['backend']}: granite-34b at full width "
          f"({P19_LAYERS} of 88 layers, float32, default pattern; 'wseq': "
          f"12 query heads a rank over the one KV head) and mamba2-130m as "
          f"published (6 of 24 SSD heads a rank), in "
          f"{time.monotonic() - t19:.1f} s (the world "
          f"{dist19['world_s']:.1f} s)")
    for line in log:
        print("  " + line)
    for run, what in (("a_granite_chunked", "(a) granite, chunked prefill "
                       "over paged arenas and ring runs"),
                      ("a_granite_whole", "(a) granite, whole prompts, "
                       "slot-dense"),
                      ("b_mamba2_chunked", "(b) mamba2, chunked paged")):
        m, o = l0[run]["metrics"], dist19["one_rank"][run]
        m1 = o["metrics"]
        ln = {k: v for k, v in l0[run]["launches"].items() if v}
        cm = l0[P19_RUNS[run][0]]["collectives_ms"]
        print(f"  {what}: 8 prompts x {P17_NEW} greedy tokens, streams of "
              f"all four ranks equal the one-rank Server's; rank 0 launches "
              f"{ln}; TTFT mean {m['ttft_mean'] * 1e3:.1f} ms p99 "
              f"{m['ttft_p99'] * 1e3:.1f} ms, TPOT mean "
              f"{m['tpot_mean_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms, "
              f"decode round {l0[run]['decode_round_ms']:.2f} ms, "
              f"collectives {cm['per_step']:.2f} ms a step = "
              f"{dist19['collective_share'][run]:.3f} of it (one rank: "
              f"TTFT mean {m1['ttft_mean'] * 1e3:.1f} ms, TPOT mean "
              f"{m1['tpot_mean_ms']:.2f} ms, decode round "
              f"{o['decode_round_ms']:.2f} ms, weights "
              f"{o['weights_gb']:.2f} GB) [{smi}]")
    print(f"  peak memory per rank "
          + ", ".join(f"{r['peak_mem_gb']:.2f}" for r in dist19["ranks"])
          + f" GB (granite shards {l0['granite-34b']['shard_gb']:.2f} GB "
          f"each, the whole model built one rank at a time); one-rank "
          f"Server peak {dist19['one_rank_peak_gb']:.2f} GB [{smi}]")
    log.clear()
    gc.collect()
    torch.cuda.empty_cache()

    for rec in (served, spec["runs"]["spec_on"], spec["runs"]["spec_off"],
                quant):
        rec.pop("streams", None)
    report.update(kernels=kern, kernels_int8=kern_q, serve=served,
                  default_pattern=omni, topk=topk, spec=spec, moe=moe,
                  quant=quant, eager=eager, ring_chunks=rings, chaos=chaos,
                  archs=archs, mamba2=mamba2, jamba=jamba, train=trained,
                  frontends=fronts, dist=dist17, omni_dist=dist18,
                  layout_dist=dist19)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    lay = omni["layouts"]
    rows = (("paged_decode", "paged_decode", "float32",
             served["launches"]["paged_decode"]),
            ("paged_prefill", "paged_prefill", "float32",
             served["launches"]["paged_prefill"]),
            ("flash_prefill", "flash_prefill", "float32",
             lay["paged"]["launches"]["flash_prefill"]
             + lay["dense"]["launches"]["flash_prefill"]),
            ("sink_decode", "sink_decode", "float32_W4224",
             lay["dense"]["launches"]["sink_decode"]),
            ("spec_verify", "spec_verify", "float32",
             spec["runs"]["spec_on"]["launches"]["spec_verify"]),
            ("block_topk", "block_topk", "float32",
             sum(r["launches"]["block_topk"]
                 for r in topk["runs"].values())),
            ("moe_gmm", "moe_gmm", "float32", moe["launches"]["moe_gmm"]))
    # the int8 paths' launches come from phase 9: (a) for the prefill and
    # decode kernels, (b)'s speculative run for spec_verify
    int8_launches = {
        "paged_decode": quant["launches"]["paged_decode"]["int8_launches"],
        "paged_prefill": quant["launches"]["paged_prefill"]["int8_launches"],
        "spec_verify": quant["spec"]["spec_on"]["launches"]["spec_verify"][
            "int8_launches"]}
    g3, gr = archs["gemma3-4b"]["runs"], archs["granite-34b"]
    new_launches = {
        "paged_decode": {
            "h256": g3["a_reuse_on"]["launches"]["paged_decode"],
            "g48": gr["serve"]["launches"]["paged_decode"]},
        "paged_prefill": {
            "h256": g3["a_reuse_on"]["launches"]["paged_prefill"],
            "g48": gr["serve"]["launches"]["paged_prefill"]},
        "flash_prefill": {
            "h256": sum(g3[r]["launches"]["flash_prefill"] for r in (
                "b_whole_dense", "e_default_paged", "e_default_dense")),
            "g48": gr["dense"]["launches"]["flash_prefill"]},
        # gemma3's ring width (5 of 6 layers); the count is all widths'
        "sink_decode": {
            "h256": sum(g3[r]["launches"]["sink_decode"] for r in (
                "b_whole_dense", "e_default_dense")),
            "g48": gr["dense"]["launches"]["sink_decode"]},
        "spec_verify": {
            "h256": g3["c_spec_on"]["launches"]["spec_verify"],
            "g48": gr["spec"]["runs"]["spec_on"]["launches"]["spec_verify"]},
        "block_topk": {
            "h256": g3["a_topk"]["launches"]["block_topk"],
            "g48": gr["topk"]["launches"]["block_topk"]},
        "moe_gmm": {
            "qwen3moe": archs["qwen3-moe-235b-a22b"]["moe"]["launches"][
                "moe_gmm"]}}
    # phase 14's jamba shapes, with their launches there
    jd, je = jamba["runs"]["d_reuse_on"], jamba["runs"]
    new_launches["paged_decode"]["jamba"] = jd["launches"]["paged_decode"]
    new_launches["paged_decode"]["jamba_ring"] = \
        je["e_default_paged"]["launches"]["paged_decode"]
    new_launches["paged_prefill"]["jamba"] = jd["launches"]["paged_prefill"]
    new_launches["flash_prefill"]["jamba"] = sum(
        je[r]["launches"]["flash_prefill"] for r in ("e_default_paged",
                                                     "e_default_dense"))
    new_launches["sink_decode"]["jamba"] = \
        je["e_default_dense"]["launches"]["sink_decode"]
    new_launches["moe_gmm"]["jamba"] = jd["launches"]["moe_gmm"]
    new_launches["moe_gmm"]["jamba_chunk"] = jd["launches"]["moe_gmm"]
    # phase 16's shapes: phi-3-vision's two prefills and its 16 B 2 decode
    # steps, hubert's two timed forwards; paged_decode at h 80 / 96 is on no
    # path of phase 16 (the Server refuses both families)
    new_launches["flash_prefill"]["h96"] = 2 * fv["prefill_launches"]
    new_launches["flash_prefill"]["h80"] = len(fa["ms"]) * fa["launches"]
    new_launches["sink_decode"]["h96"] = \
        P16_NEW * fv["decode_launches_per_step"]
    new_launches["paged_decode"]["h96"] = 0
    new_launches["paged_decode"]["h80"] = 0
    # phase 17's and 18's rank-local shapes, with rank 0's launches there
    la, lb = r0["a_chunked"]["launches"], r0["b_whole"]["launches"]
    for name, subs in dist17["kernels"].items():
        for sub, rec in subs.items():
            kern[name][f"float32_{sub}"] = rec
    new_launches["paged_decode"]["tp2ep2"] = la["paged_decode"] \
        + lb["paged_decode"]
    new_launches["paged_prefill"]["tp2ep2"] = la["paged_prefill"]
    new_launches["flash_prefill"]["tp2ep2"] = lb["flash_prefill"]
    new_launches["moe_gmm"]["tp2ep2"] = la["moe_gmm"] + lb["moe_gmm"]
    # phase 17 (d)-(f): the int8 arenas and the verify window, rank 0's
    # launches there (moe_gmm: every launch of the speculating runs)
    for name, subs in dist17["kernels_int8"].items():
        for sub, rec in subs.items():
            kern_q[name][f"float32_{sub}"] = rec
    ld, le, lf = (r0[run]["launches"] for run in P17_PLANES)
    new_launches["spec_verify"]["tp2ep2"] = le["spec_verify"]
    new_launches["moe_gmm"]["tp2ep2_verify"] = le["moe_gmm"] \
        + lf["moe_gmm"]
    # phase 18: every paged_decode launch of (a) (3 of its 4 layers are
    # ring tables), (b)'s whole prompts (3 of 4 layers sink + window) and
    # sink_decode steps, (c)'s two block_topk entries
    qa, qb, qc = (q0[c]["launches"] for c in P18_CASES)
    new_launches["paged_decode"]["tp2ep2_ring"] = qa["paged_decode"]
    new_launches["flash_prefill"]["tp2ep2_window"] = qb["flash_prefill"]
    new_launches["sink_decode"]["tp2ep2"] = qb["sink_decode"]
    new_launches["block_topk"]["tp2ep2"] = qc["block_topk_scores"]
    new_launches["block_topk"]["tp2ep2_select_scores"] = \
        qc["block_topk_select_scores"]
    # phase 19: rank 0's launches of (a) chunked (paged_decode over 2 full
    # and 6 ring tables a step: both records count every launch) and (a)
    # whole-prompt slot-dense; qwen2-1.5b's tp4 shapes are on no path
    ga, gw = (l0[r]["launches"] for r in ("a_granite_chunked",
                                          "a_granite_whole"))
    new_launches["paged_decode"]["tp4"] = ga["paged_decode"]
    new_launches["paged_decode"]["tp4_ring"] = ga["paged_decode"]
    new_launches["paged_prefill"]["tp4"] = ga["paged_prefill"]
    new_launches["sink_decode"]["tp4"] = gw["sink_decode"]
    new_launches["flash_prefill"]["tp4"] = gw["flash_prefill"]
    new_launches["paged_decode"]["tp4_qwen2"] = 0
    new_launches["paged_prefill"]["tp4_qwen2"] = 0
    new_int8 = {
        "paged_decode": {"h256": g3["d_int8"]["launches"]["paged_decode_int8"],
                         "h96": 0, "h80": 0},
        "paged_prefill": {
            "h256": g3["d_int8"]["launches"]["paged_prefill_int8"]},
        "spec_verify": {
            "h256": g3["d_int8_spec_on"]["launches"]["spec_verify_int8"]}}
    new_int8["paged_decode"]["tp2ep2"] = ld["paged_decode_int8"] \
        + lf["paged_decode_int8"]
    new_int8["paged_prefill"]["tp2ep2"] = ld["paged_prefill_int8"] \
        + lf["paged_prefill_int8"]
    new_int8["spec_verify"]["tp2ep2"] = lf["spec_verify_int8"]
    line = {"kernels": []}
    for name, key, dn, launches in rows:
        r = kern[key][dn]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "float32"}
        if name in int8_launches:
            q8 = kern_q[name]["float32"]
            entry["int8"] = {k: q8[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library", "max_abs_err")} | {
                "launches": int8_launches[name]}
        if name == "block_topk":
            # what the main path launches: scores, ranking and compaction
            # in one launch (phase 6 counts its launches above), against
            # the eager composition it replaced
            entry["select"] = {k: kern[key]["float32_select"][k] for k in (
                "ms", "plain_ms", "composition_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "exact")}
        # the shapes where the device seconds are: phase 5's ring tables,
        # long histories (topk-long's last chunk, a ~4,000-token verify)
        extra = {"paged_decode": "ring", "paged_prefill": "long",
                 "spec_verify": "long"}.get(name)
        if extra:
            for rec, src in ((entry, kern[key][f"float32_{extra}"]),
                             (entry["int8"],
                              kern_q[key][f"float32_{extra}"])):
                rec[extra] = {k: src[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")}
        # this slice's shapes, with their launches in phase 13
        for sub, launches_ in new_launches.get(name, {}).items():
            src = kern[key][{"sink_decode": {"h256": "float32_h256_W1024",
                                             "g48": "float32_g48_W512"},
                             "moe_gmm": {"qwen3moe":
                                         "float32_qwen3moe_decode",
                                         "jamba": "bfloat16_jamba_decode",
                                         "jamba_chunk":
                                         "bfloat16_jamba_chunk"}}
                            .get(name, {}).get(sub, (
                                f"bfloat16_{sub}" if sub.startswith("jamba")
                                else f"float32_{sub}"))]
            entry[sub] = {k: src[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "shape")} | {"launches": launches_, "dtype": (
                    "bfloat16" if sub.startswith("jamba") else "float32")}
            if sub in ("h80", "h96"):
                entry[sub]["bfloat16"] = {k: kern[key][f"bfloat16_{sub}"][k]
                                          for k in ("ms", "plain_ms",
                                                    "bound_ms", "bound_by",
                                                    "library_ms",
                                                    "max_abs_err")}
                entry[sub]["on_path"] = launches_ > 0
            if sub == "tp4_qwen2":
                entry[sub]["on_path"] = False
        for sub, launches_ in new_int8.get(name, {}).items():
            src = kern_q[key][f"float32_{sub}"]
            entry["int8"][sub] = {k: src[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "shape")} | {"launches": launches_}
            if sub in ("h80", "h96"):
                entry["int8"][sub]["on_path"] = False
        line["kernels"].append(entry)
    for k in line["kernels"]:
        for rec in (k, k.get("int8")):
            if rec is None:
                continue
            subs = ("h256", "g48", "qwen3moe", "jamba", "jamba_ring",
                    "jamba_chunk", "h80", "h96", "tp2ep2", "tp2ep2_ring",
                    "tp2ep2_window", "tp2ep2_select_scores",
                    "tp2ep2_verify", "tp4", "tp4_ring", "tp4_qwen2")
            for sub in subs:
                if sub in rec and rec[sub]["launches"] <= 0 and \
                        rec[sub].get("on_path", True):
                    raise AssertionError(f"{k['name']} {sub}: no launch in "
                                         f"phase 13, 14, 16, 17, 18 or 19")
            for r in (rec, rec.get("ring"), rec.get("long"),
                      rec.get("select")) + tuple(rec.get(x) for x in subs):
                for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
                    if r is not None and not math.isfinite(r[key]):
                        raise AssertionError(f"{k['name']}: {key} is not "
                                             f"finite")
            if rec["launches"] <= 0:
                raise AssertionError(f"{k['name']}: no launch on the main "
                                     f"path")
    print(f"all phases done in {time.monotonic() - t0:.1f} s")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
