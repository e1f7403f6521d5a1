"""Whole-prompt flash attention with the fused sink+window mask.

`flash_prefill` launches the hand-written CUDA kernel `csrc/flash_prefill.cu`
(the port of the TPU kernel src/repro/kernels/flash_prefill.py) for tensors
on a CUDA device, and runs `flash_prefill_plain` — the same function in plain
PyTorch — for tensors on the CPU. `flash_prefill.launches` counts kernel
launches (nothing else adds to it).

Layout: q [N, S·G, h] with row r = token r // G of one GQA group (N =
sequences × kv heads), k/v [N, S, h]. With G = 1 it is the TPU kernel's
[BH, S, h]; the model-layout adapter is `ops.attention_prefill_op`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, WIDE_HEAD_DIMS,
                                         kernel_arg, meta_call,
                                         refuse_autograd)

NEG_INF = -1e30


def flash_prefill_plain(q, k, v, *, causal: bool = True, window: int = 0,
                        sink: int = 0):
    """q [N,S·G,h]; k/v [N,S,h] → [N,S·G,h] in q's dtype. One float32
    softmax over the whole masked score matrix: causal (key ≤ query token)
    or bidirectional, and with window > 0 only keys less than `window`
    tokens back — or among the first `sink` tokens — are visible."""
    N, SG, h = q.shape
    S = k.shape[1]
    G = SG // S
    dev = q.device
    s = torch.einsum("nrh,nth->nrt", q.float(), k.float()) * h ** -0.5
    p_row = (torch.arange(SG, device=dev) // G)[:, None]
    k_pos = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((SG, S), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_pos <= p_row)
    if window > 0:
        win = (p_row - k_pos) < window
        if sink > 0:
            win = win | (k_pos < sink)
        mask = mask & win
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nrt,nth->nrh", p, v.float()).to(q.dtype)


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  sink: int = 0):
    """q [N,S·G,h]; k/v [N,S,h] → o [N,S·G,h] in q's dtype (see
    `flash_prefill_plain` for the mask)."""
    if q.device.type == "meta":
        from repro_torch.launch.cost import flash_bound
        return meta_call("flash_prefill", torch.empty_like(q),
                         flash_bound(q, k, causal, window, sink), q.dtype)
    if q.device.type != "cuda":
        return flash_prefill_plain(q, k, v, causal=causal, window=window,
                                   sink=sink)
    refuse_autograd("flash_prefill", q, k, v)
    N, SG, h = q.shape
    S = k.shape[1]
    if k.shape != (N, S, h) or v.shape != k.shape or SG % S:
        raise ValueError(f"keys {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in WIDE_HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel takes float32/bfloat16 and "
                         f"h in {WIDE_HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    kc = kernel_arg(k, dev, q.dtype)
    vc = kernel_arg(v, dev, q.dtype)
    out = torch.empty_like(q)
    lib = build.load("flash_prefill")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_prefill_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            out.data_ptr(), N, S, SG // S, h, h ** -0.5, int(bool(causal)),
            int(window), int(sink), stream)
    build.check_launch("flash_prefill", rc)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
