"""Batched speculative-verify attention over physically paged history KV.

`spec_verify` launches the hand-written CUDA kernel `csrc/spec_verify.cu`
(the port of the TPU kernel src/repro/kernels/spec_verify.py) for tensors on
a CUDA device, and runs `spec_verify_plain` — the same function in plain
PyTorch — for tensors on the CPU. `spec_verify.launches` counts kernel
launches (nothing else adds to it), `spec_verify.int8_launches` those over
int8 history (QuantPlane: int8 pages with the scale plane, dequantized in
the tile; the window's own keys are never quantized).

Every slot presents a window of S = k + 1 tokens at absolute positions
off_b .. off_b + S - 1 and attends its resident history (tokens < off_b,
through its own table row) plus the window's own keys under the causal
mask. Read-only: no K/V is written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, HEAD_DIMS, kernel_arg,
                                         meta_call, per_row, refuse_autograd,
                                         scale_plane_args)
from repro_torch.kernels.paged_decode import _sm_count, prefill_splits
from repro_torch.kernels.paged_prefill import paged_prefill_plain

VERIFY_ROWS = 32          # query rows per CTA of the kernel (csrc SV_WARPS)


def spec_verify_plain(q, k_new, v_new, k_pages, v_pages, tables, off, n_tok,
                      **scales):
    """q [B,K,S·G,h] (row r = window token r//G); k_new/v_new [B,K,S,h];
    pages [N,K,bs,h]; tables [B,nb]; off [B] per-slot history length; n_tok
    [B] real window rows → [B,K,S·G,h]. The verify step is a batched causal
    chunked-prefill read with per-row offsets and no sparse window, so the
    plain version is the chunked-prefill one (as `ref.spec_verify_ref` is
    `ref.paged_prefill_ref`); `scales` is the scale plane of int8 pages
    (k_scale=, k_tok=, v_scale=, v_tok=)."""
    return paged_prefill_plain(q, k_new, v_new, k_pages, v_pages, tables,
                               off, n_tok, **scales)


def spec_verify(q, k_new, v_new, k_pages, v_pages, tables, off, n_tok, *,
                k_scale=None, k_tok=None, v_scale=None, v_tok=None):
    """q [B,K,S·G,h]; k_new/v_new [B,K,S,h]; arenas [N,K,bs,h]; tables
    [B,nb] physical block ids; off/n_tok scalars or [B] → o [B,K,S·G,h] in
    q's dtype. Rows of window tokens >= n_tok are padding: finite, but not
    meaningful. Int8 arenas pass their scale plane (k_scale/v_scale
    [N,K,h], k_tok/v_tok [N,K,bs] float32); k_new/v_new stay in q's
    dtype."""
    quant = k_scale is not None
    if q.device.type == "meta":
        from repro_torch.launch.cost import prefill_bound
        return meta_call("spec_verify", torch.empty_like(q),
                         prefill_bound(q, k_new, k_pages, tables, off, n_tok),
                         q.dtype)
    if q.device.type != "cuda":
        return spec_verify_plain(q, k_new, v_new, k_pages, v_pages, tables,
                                 off, n_tok, k_scale=k_scale, k_tok=k_tok,
                                 v_scale=v_scale, v_tok=v_tok)
    refuse_autograd("spec_verify", q, k_new, v_new, k_pages, v_pages)
    B, K, SG, h = q.shape
    S = k_new.shape[2]
    if k_new.shape != (B, K, S, h) or v_new.shape != k_new.shape \
            or SG % S:
        raise ValueError(f"window keys {tuple(k_new.shape)} do not match q "
                         f"{tuple(q.shape)}")
    G = SG // S
    N, Kp, bs, hp = k_pages.shape
    if (Kp, hp) != (K, h) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in HEAD_DIMS:
        raise ValueError(f"spec_verify kernel takes float32/bfloat16 and "
                         f"h in {HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    kn = kernel_arg(k_new, dev, q.dtype)
    vn = kernel_arg(v_new, dev, q.dtype)
    kv_dtype = torch.int8 if quant else q.dtype
    kp = kernel_arg(k_pages, dev, kv_dtype)
    vp = kernel_arg(v_pages, dev, kv_dtype)
    tbl = kernel_arg(tables, dev, torch.int32)
    offs = kernel_arg(per_row(off, B, dev), dev, torch.int32)
    nts = kernel_arg(per_row(n_tok, B, dev), dev, torch.int32)
    nb = tbl.shape[1]
    out = torch.empty_like(q)
    n_split, per = prefill_splits(B, K, -(-SG // VERIFY_ROWS), nb,
                                  _sm_count(dev.index))
    ws = None if n_split == 1 else torch.empty(
        B * K * n_split * SG * (h + 2), dtype=torch.float32, device=dev)
    ws_ptr = None if ws is None else ws.data_ptr()
    lib = build.load("spec_verify")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if quant:
            sp = scale_plane_args(kp, (k_scale, k_tok, v_scale, v_tok), dev)
            rc = lib.spec_verify_int8_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                *(t.data_ptr() for t in sp), tbl.data_ptr(),
                offs.data_ptr(), nts.data_ptr(), out.data_ptr(), ws_ptr, B,
                K, S, G, h, bs, nb, n_split, per, h ** -0.5, stream)
        else:
            rc = lib.spec_verify_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(),
                offs.data_ptr(), nts.data_ptr(), out.data_ptr(), ws_ptr, B,
                K, S, G, h, bs, nb, n_split, per, h ** -0.5, stream)
    build.check_launch("spec_verify", rc)
    spec_verify.launches += 1
    spec_verify.int8_launches += int(quant)
    return out


spec_verify.launches = 0
spec_verify.int8_launches = 0
